"""The port's analysis and export tools (`hanabi_sad_tpu_torch.tools.
action_matrix`, `convert_model`, `bench_train`, `models.torch_import.
to_torch_state_dict` and `train.evaluate(return_actions=True)`) against the
JAX package, on the CPU.

  * `compute_action_matrix` equals JAX's on the same random arrays, exactly;
  * `evaluate(..., return_actions=True)` of the flagship, 8 games on the
    decks JAX deals from its keys: the applied actions and done flags equal
    JAX's up to near ties of JAX's advantages (<= 1e-4), and so the action
    counts where no game parted;
  * `action_matrix.main` on a small checkpoint: rows sum to 1 or 0, files
    written;
  * `to_torch_state_dict` equals JAX's bit for bit on the same params;
  * `convert_model.main --pthw` on the same checkpoint as the JAX tool: the
    `.pthw` equal tensor for tensor, and the `.sparta` module's a, h0 and c0
    within 1e-5 of JAX's `r2d2_net.act` from a non-zero hidden;
  * `bench_train` at a small size on the CPU returns finite rates;
  * the CLIs, asked for no device, raise where there is no CUDA card."""

import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hanabi_sad_tpu.game import env as jenv
from hanabi_sad_tpu.game.config import GameConfig as JGameConfig
from hanabi_sad_tpu.models import r2d2_net as jnet
from hanabi_sad_tpu.models import torch_import as jtorch_import
from hanabi_sad_tpu.tools import action_matrix as jam
from hanabi_sad_tpu.tools import convert_model as jconvert
from hanabi_sad_tpu.tools import loaders as jloaders
from hanabi_sad_tpu.train import checkpoint as jckpt
from hanabi_sad_tpu.train import evaluate as jevaluate
from hanabi_sad_tpu_torch.models import torch_import
from hanabi_sad_tpu_torch.tools import action_matrix, bench_train, convert_model, loaders
from hanabi_sad_tpu_torch.train.evaluate import evaluate
from torch_parity import check_actions_up_to_near_ties, jax_net, near_tie_steps, np_net, torch_net

FLAGSHIP = str(Path(__file__).resolve().parents[1] / "docs/runs/sad_aux_r4_soup10.pkl")
TIE = 1e-4
SPARTA_TOL = 1e-5


def save_small_checkpoint(path, in_dim=838, hid=32, seed=0):
    """A params payload of a numpy-made net, written by the JAX package."""
    jckpt.save(path, jckpt.params_payload(jax_net(np_net(in_dim, hid, 21, 5, 2, seed))))


@pytest.mark.parametrize("seed", [0, 1])
def test_compute_action_matrix_equals_jax(seed):
    rng = np.random.RandomState(seed)
    actions = rng.randint(0, 21, (60, 40))
    valid = np.cumsum(rng.rand(60, 40) < 0.05, axis=0) == 0  # each game ends at its own step
    t_normed, t_counts = action_matrix.compute_action_matrix(actions, valid, 21)
    j_normed, j_counts = jam.compute_action_matrix(actions, valid, 21)
    np.testing.assert_array_equal(t_counts, j_counts)
    np.testing.assert_array_equal(t_normed, j_normed)
    assert action_matrix.render(t_normed[:20, :20]) == jam.render(j_normed[:20, :20])
    assert action_matrix.IDX2ACTION == jam.IDX2ACTION


def test_evaluate_return_actions_matches_jax():
    jpol, tpol = jloaders.load_native_checkpoint(FLAGSHIP), loaders.load_native_checkpoint(FLAGSHIP, device="cpu")
    N, seed, steps = 8, 5, 128
    jout = jevaluate.evaluate([jpol, jpol], N, seed, num_steps=steps, return_actions=True)
    jcfg = jenv.EnvConfig(game=JGameConfig(players=2), eps_list=(0.0,), max_len=-1, sad=True)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(seed), i))(jnp.arange(N))
    decks = torch.from_numpy(np.array(jax.vmap(lambda k: jenv.reset_state(jcfg, k).game.deck)(keys))).long()

    seen = []

    def recording_act(params, cfg, obs, hidden, generator):
        seen.append((obs["priv_s"][:, 0].numpy(), obs["legal_move"][:, 0].numpy()))
        return tpol.act_fn(params, cfg, obs, hidden, generator)

    rec = loaders.EvalPolicy(tpol.params, tpol.agent_cfg, recording_act, tpol.sad)
    tout = evaluate([rec, rec], N, seed, num_steps=steps, decks=decks, return_actions=True, device="cpu")
    assert len(tout) == 6 and tout[4].shape == tout[5].shape == (steps, N)
    assert tout[4].dtype.kind == "i" and tout[5].dtype == bool
    assert tout[2] == jout[2] and tout[3] == jout[3] and tout[0] == pytest.approx(jout[0])
    np.testing.assert_array_equal(tout[5], np.asarray(jout[5]))

    act = jax.jit(lambda x, h: jnet.act(jpol.params.online, jpol.agent_cfg.net, x, h))
    hid = [{"h0": jnp.zeros((N, 2, 512)), "c0": jnp.zeros((N, 2, 512))} for _ in range(2)]
    near = near_tie_steps(act, seen, hid, steps, TIE)
    num_near, parted = check_actions_up_to_near_ties(tout[4], np.asarray(jout[4]), np.asarray(jout[5]), near)
    print(f"near-tie steps: {num_near}; games parted: {parted}")
    if parted == 0:
        _, t_counts = action_matrix.compute_action_matrix(tout[4], ~tout[5], 21)
        _, j_counts = jam.compute_action_matrix(np.asarray(jout[4]), ~np.asarray(jout[5]), 21)
        np.testing.assert_array_equal(t_counts, j_counts)
        assert t_counts.sum() > 0


def test_action_matrix_main_on_a_small_checkpoint(tmp_path, capsys):
    path = str(tmp_path / "m.pkl")
    save_small_checkpoint(path)
    out = str(tmp_path / "mat.txt")
    normed, counts = action_matrix.main(["--weight", path, "--num_game", "8", "--out", out, "--device", "cpu"])
    assert counts.shape == (21, 21) and counts.sum() > 0
    rows = normed.sum(1)
    assert ((np.abs(rows - 1) < 1e-6) | (rows == 0)).all()
    assert os.path.exists(out) and np.array_equal(np.load(out + ".npy"), counts)
    text = capsys.readouterr().out
    assert "score: " in text and "D1" in text


def test_to_torch_state_dict_equals_jax_bit_for_bit():
    p = np_net(838, 48, 21, 5, 2, seed=3)
    want = jtorch_import.to_torch_state_dict(jax_net(p))
    got = torch_import.to_torch_state_dict(torch_net(p))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].is_contiguous() and got[k].device.type == "cpu"
        assert torch.equal(got[k], want[k]), k
    # and back: the collapsed bias sums the halves exactly
    back, _ = torch_import.from_torch_state_dict(got, device="cpu")
    assert torch.equal(back.lstm[1]["b"], torch.from_numpy(p["lstm"][1]["b"]))


def test_convert_model_matches_the_jax_tool(tmp_path):
    src = str(tmp_path / "src.pkl")
    save_small_checkpoint(src, in_dim=100, hid=16, seed=4)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jpath, tpath = str(tmp_path / "jax" / "m.pkl"), str(tmp_path / "port" / "m.pkl")
    shutil.copy(src, jpath)
    shutil.copy(src, tpath)
    jconvert.main(["--model", jpath, "--pthw"])
    out = convert_model.main(["--model", tpath, "--pthw", "--device", "cpu"])
    assert out == str(tmp_path / "port" / "m.sparta") and os.path.exists(out)
    want, got = torch.load(str(tmp_path / "jax" / "m.pthw")), torch.load(str(tmp_path / "port" / "m.pthw"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k

    net = torch.jit.load(out)
    jpol = jloaders.load_any(jpath)
    B = 4
    rng = np.random.RandomState(0)
    s = rng.randn(B, 100).astype(np.float32)
    h0, c0 = (0.5 * rng.randn(B, 2, 16)).astype(np.float32), (0.5 * rng.randn(B, 2, 16)).astype(np.float32)
    with torch.no_grad():
        res = net({"s": torch.from_numpy(s), "h0": torch.from_numpy(h0), "c0": torch.from_numpy(c0)})
    a, hid = jnet.act(jpol.params.online, jpol.agent_cfg.net, jnp.asarray(s),
                      {"h0": jnp.asarray(h0), "c0": jnp.asarray(c0)})
    assert np.abs(res["a"].numpy() - np.asarray(a)).max() <= SPARTA_TOL
    for k in ("h0", "c0"):
        assert res[k].shape == (B, 2, 16)
        assert np.abs(res[k].numpy() - np.asarray(hid[k])).max() <= SPARTA_TOL


def test_bench_train_on_the_cpu_returns_finite_rates(capsys):
    """Two timed chunks: each rate is over both chunks' summed time, and the
    env steps are both chunks' own."""
    rates = bench_train.main(["--device", "cpu", "--num_envs", "8", "--updates", "2", "--batchsize", "8",
                              "--replay_buffer_size", "256", "--reps", "2"])
    for k in ("chunk_ms", "env_steps_per_s", "padded_steps_per_s", "train_frames_per_s", "updates_per_s"):
        assert np.isfinite(rates[k]) and rates[k] > 0, k
    total = sum(rates["chunk_s"])
    assert len(rates["chunk_s"]) == 2
    assert rates["chunk_ms"] == pytest.approx(1000 * total / 2)
    assert rates["updates_per_s"] == pytest.approx(2 * 2 / total)
    assert rates["env_steps_per_s"] == pytest.approx(rates["env_steps"] / total)
    # each chunk takes at least one step in each of the 8 envs, and no more than the padded steps
    assert 2 * 8 <= rates["env_steps"] <= rates["padded_steps_per_s"] * total
    assert "steady chunk:" in capsys.readouterr().out


@pytest.mark.parametrize("flag", ["--rollout_unroll", "--net_seq_unroll"])
def test_bench_train_rejects_the_jax_scan_unroll_flags(flag, capsys):
    """The port's loops are eager: the JAX tool's XLA unroll factors are
    refused, not ignored."""
    with pytest.raises(SystemExit) as exc:
        bench_train.main(["--device", "cpu", flag, "4"])
    assert exc.value.code == 2
    assert flag in capsys.readouterr().err


@pytest.mark.parametrize("cli", ["action_matrix", "convert_model", "bench_train"])
def test_clis_without_a_device_raise_on_a_cpu_only_machine(cli):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    argv = {"action_matrix": ["--weight", FLAGSHIP, "--num_game", "2"], "convert_model": ["--model", FLAGSHIP],
            "bench_train": ["--num_envs", "2"]}[cli]
    with pytest.raises(RuntimeError, match="CUDA"):
        {"action_matrix": action_matrix, "convert_model": convert_model, "bench_train": bench_train}[cli].main(argv)
