"""Data-parallel training in the port (`hanabi_sad_tpu_torch.parallel`),
through torch.distributed with gloo on the CPU: ranks are worker processes
(`tests/torch_multihost_worker.py`, which imports only the port) that meet
through a file in the test's tmp_path, each with a timeout.

  * (a) 2 ranks against 1 rank, one collect and one train chunk of 2
    updates, at the JAX tests' tiny size (hid 32, max_len 12, num_envs 2 W,
    a batch of W per rank), in four modes: the same chunk stats (exactly:
    they are counts summed over the ranks), ring bytes and sampled index
    rows, and loss within rtol 2e-4 (`test_sharding.py:117`); the 2 ranks
    end with the same params;
  * (b) one 2-rank sgd_update against the JAX package's sgd_update with the
    state on a 2-device mesh, from the same params, replay and presampled
    batch, a duplicate index spanning the ranks: metrics 1e-5 relative,
    params 1e-7 absolute, replay weights 1e-5 absolute
    (`test_torch_learner.py`'s single-process tolerances);
  * (c) the flagship's eval on 2 ranks gives the 1-rank scores and actions;
  * (d) selfplay.train with multihost on 2 ranks runs two chunks and only
    rank 0 writes; a torchrun environment without multihost raises;
  * (e) in one process: shards of every random draw site equal the rows of
    the global draw, shard_rows and all_gather_rows round trips at one rank,
    and counts that do not divide by the ranks raise."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hanabi_sad_tpu.parallel import make_mesh as jax_mesh
from hanabi_sad_tpu.parallel import shard_train_state as jax_shard
from hanabi_sad_tpu.replay import bitpack as jbitpack
from hanabi_sad_tpu.replay import prioritized as jrep
from hanabi_sad_tpu.train import config as jconfig
from hanabi_sad_tpu.train import learner as jlearner
from hanabi_sad_tpu_torch import parallel
from hanabi_sad_tpu_torch.agent import r2d2_agent
from hanabi_sad_tpu_torch.game import env as tenv
from hanabi_sad_tpu_torch.game.config import GameConfig
from hanabi_sad_tpu_torch.game.state import shuffled_decks
from hanabi_sad_tpu_torch.parallel import Mesh, Shard
from hanabi_sad_tpu_torch.train import config as tconfig
from hanabi_sad_tpu_torch.train import learner as tlearner
from hanabi_sad_tpu_torch.train import selfplay

WORKER = Path(__file__).with_name("torch_multihost_worker.py")
FLAGSHIP = str(Path(__file__).resolve().parents[1] / "docs/runs/sad_aux_r4_soup10.pkl")
TIMEOUT_S = 240
W = 2
# The JAX tests' tiny_setup at W ranks; `batchsize` is before VDN's division
# by the 2 players, so every mode has a batch of W episodes a rank.
TINY = dict(num_envs=2 * W, num_update_per_chunk=2, burn_in_frames=8, max_len=12, rnn_hid_dim=32, num_eps=4,
            slots_per_env=2)
MODES = {
    "vdn_continuous": dict(method="vdn", batchsize=4 * W, replay_buffer_size=32 * W),
    "iql_continuous": dict(method="iql", batchsize=2 * W, replay_buffer_size=16 * W, shuffle_obs=True),
    "vdn_aligned": dict(method="vdn", batchsize=4 * W, replay_buffer_size=32 * W, rollout_mode="aligned"),
    "vdn_snapshot": dict(method="vdn", batchsize=4 * W, replay_buffer_size=32 * W, snapshot_sampling=True),
}
SMALL = dict(pred_weight=0.25, rnn_hid_dim=64, max_len=12, replay_buffer_size=128, batchsize=8, num_envs=4)


def run_ranks(tmp_path, mode, spec, worlds=(1, W)):
    """The worker's `mode` as one process per rank, for each world size, all
    started together; {world: [each rank's outputs]}."""
    tmp_path = tmp_path / f"{mode}_{'_'.join(map(str, worlds))}"
    tmp_path.mkdir()
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(json.dumps(spec))
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    try:
        for world in worlds:
            for rank in range(world):
                out = tmp_path / f"{mode}_w{world}_r{rank}.npz"
                cmd = [sys.executable, str(WORKER), mode, str(spec_path), str(out), "--rank", str(rank),
                       "--world", str(world), "--init", f"file://{tmp_path}/rendezvous_{mode}_{world}"]
                procs.append((world, out, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)))
        results = {}
        for world, out, proc in procs:
            log = proc.communicate(timeout=TIMEOUT_S)[0]
            assert proc.returncode == 0, log[-4000:]
            results.setdefault(world, []).append(dict(np.load(out)))
        return results
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def assert_ranks_agree(outs, keys):
    for k in keys:
        for other in outs[1:]:
            np.testing.assert_array_equal(outs[0][k], other[k], err_msg=k)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_two_ranks_reproduce_one_rank(tmp_path, mode):
    res = run_ranks(tmp_path, "chunk", {"config": dict(TINY, **MODES[mode]), "seed": 0})
    (one,), pair = res[1], res[W]
    params = sorted(k for k in one if k.startswith("param"))
    assert_ranks_agree(pair, [k for k in one if k.startswith("ring.")] + ["idx"] + params)
    two = pair[0]
    for k in one:
        if k.startswith(("collect.", "train.chunk", "train.dropped", "train.explore", "ring.")) or k in (
                "idx", "num_update"):
            np.testing.assert_array_equal(two[k], one[k], err_msg=k)
    assert one["idx"].shape == (2, 4 if mode.startswith("vdn") else 2 * W)
    assert int(one["ring.size"]) > 0 and int(one["num_update"]) == 2
    np.testing.assert_allclose(two["train.loss"], one["train.loss"], rtol=2e-4)
    np.testing.assert_allclose(two["updates"], one["updates"], rtol=2e-4)
    for k in params:
        np.testing.assert_allclose(two[k], one[k], rtol=0, atol=1e-6, err_msg=k)


def replay_inputs(cfg, M=20, seed=1):
    """Replay fields of M episodes, made with numpy (the port's learner test's
    fill_replays)."""
    rng = np.random.RandomState(seed)
    bits = (rng.rand(M, cfg.seq_len, cfg.num_player, cfg.bits_per_step) < 0.15).astype(np.float32)
    bits[..., cfg.obs_dim + cfg.num_actions - 1] = 1.0  # the no-op is always legal
    seq_len = rng.randint(2, cfg.seq_len + 1, (M,)).astype(np.float32)
    return {
        "packed": np.array(jbitpack.pack_bits(jnp.asarray(bits))),
        "action": rng.randint(0, cfg.num_actions, (M, cfg.seq_len, cfg.num_player)).astype(np.int64),
        "reward": rng.randn(M, cfg.seq_len).astype(np.float32),
        "bootstrap": (np.arange(cfg.seq_len)[None] < seq_len[:, None] - 3).astype(np.float32),
        "seq_len": seq_len,
        "priority": rng.uniform(0.1, 2.0, (M,)).astype(np.float32),
    }


def test_two_rank_sgd_update_matches_jax_on_a_two_device_mesh(tmp_path):
    if len(jax.devices()) < W:
        pytest.skip(f"needs {W} virtual devices")
    jsetup = jlearner.make_setup(jconfig.make_config("sad_2p", **SMALL))
    jstate = jlearner.init_train_state(jsetup, jax.random.PRNGKey(0))
    fields = replay_inputs(jsetup.replay)
    replay = jrep.add_packed(jstate.replay, jsetup.replay, *(jnp.asarray(fields[k]) for k in (
        "packed", "action", "reward", "bootstrap", "seq_len", "priority")))
    mesh = jax_mesh(jax.devices()[:W])
    jstate = jax_shard(jstate._replace(replay=replay), mesh)
    idx = np.asarray([3, 17, 3, 0], np.int32)  # the duplicate 3 lies on both ranks
    is_w = np.asarray([0.5, 1.0, 0.5, 0.25], np.float32)
    jopt = jlearner.make_optimizer(jsetup.train)
    with mesh:
        rows = jrep.gather_rows(jstate.replay, jnp.asarray(idx))
        jstate2, jm = jax.jit(lambda s, p: jlearner.sgd_update(jsetup, jopt, s, presampled=p))(
            jstate, (rows, jnp.asarray(is_w), jnp.asarray(idx)))

    inputs = dict(fields, idx=idx.astype(np.int64), is_weight=is_w)
    for net in ("online", "target"):
        for i, leaf in enumerate(jax.tree_util.tree_leaves(getattr(jstate.params, net))):
            inputs[f"{net}{i}"] = np.asarray(leaf)
    np.savez(tmp_path / "inputs.npz", **inputs)
    pair = run_ranks(tmp_path, "sgd", {"inputs": str(tmp_path / "inputs.npz"), "config": SMALL}, worlds=(W,))[W]
    assert_ranks_agree(pair, list(pair[0]))
    out = pair[0]
    assert {k.split(".", 1)[1] for k in out if k.startswith("metric.")} == set(jm)
    for k in jm:
        np.testing.assert_allclose(out[f"metric.{k}"], float(jm[k]), rtol=1e-5, err_msg=k)
    for net in ("online", "target"):
        for i, leaf in enumerate(jax.tree_util.tree_leaves(getattr(jstate2.params, net))):
            np.testing.assert_allclose(out[f"{net}{i}"], np.asarray(leaf), rtol=0, atol=1e-7, err_msg=f"{net}{i}")
    np.testing.assert_allclose(out["weight"], np.asarray(jstate2.replay.weight), rtol=0, atol=1e-5)


def test_two_rank_eval_gives_the_one_rank_scores(tmp_path):
    """shuffle_obs on, so the eval's hand shuffles are drawn over all games."""
    res = run_ranks(tmp_path, "eval", {"weight": FLAGSHIP, "num_game": 8, "seed": 1, "shuffle_obs": True})
    (one,), pair = res[1], res[W]
    assert_ranks_agree(pair, list(one))
    for k in one:
        np.testing.assert_array_equal(pair[0][k], one[k], err_msg=k)
    assert one["scores"].shape == (8,) and float(one["mean"]) > 10


def test_selfplay_multihost_trains_and_only_rank_0_writes(tmp_path):
    config = dict(pred_weight=0.25, num_envs=8, batchsize=8, burn_in_frames=16, replay_buffer_size=64,
                  epoch_len=4, num_update_per_chunk=2, num_epoch=3, num_eval_game=4, max_len=16, rnn_hid_dim=32,
                  num_update_between_sync=3, eval_max_steps=100, num_eps=4)
    dirs = {world: [str(tmp_path / f"w{world}_r{r}") for r in range(world)] for world in (1, W)}
    res = {}
    for world in (1, W):
        spec = {"config": config, "save_dirs": dirs[world]}
        res.update(run_ranks(tmp_path, "selfplay", spec, worlds=(world,)))
    (one,), pair = res[1], res[W]
    assert_ranks_agree(pair, list(one))
    assert int(pair[0]["num_update"]) == int(one["num_update"]) == 4
    assert float(pair[0]["eval_score"]) == float(one["eval_score"])
    np.testing.assert_allclose(pair[0]["loss"], one["loss"], rtol=2e-4)
    written = set(os.listdir(dirs[W][0]))
    assert {"train.log", "latest.pkl", "model0.pkl"} <= written
    assert "multihost: rank 0 of 2" in (Path(dirs[W][0]) / "train.log").read_text()
    assert not os.path.exists(dirs[W][1])


def test_torchrun_environment_without_multihost_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    cfg = tconfig.make_config("sad_2p", save_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="multihost"):
        selfplay.train(cfg, device="cpu")
    assert not os.listdir(tmp_path)


G = GameConfig(players=2)
ENV = tenv.EnvConfig(game=G, eps_list=(0.0, 0.5, 0.9), sad=True, shuffle_color=True, shuffle_obs=True)


def reset_rows(n, shard, gen):
    state, obs = tenv.reset(ENV, n, generator=gen, device="cpu", shard=shard)
    fields = (state.game.deck, state.player_eps, state.color_perm, obs["priv_s"])
    return torch.cat([x.reshape(n, -1).float() for x in fields], dim=1)


def explore_rows(n, shard, gen):
    return r2d2_agent._epsilon_greedy(torch.zeros(2 * n, dtype=torch.long), torch.ones(2 * n, 21),
                                      torch.full((2 * n,), 0.5), gen, shard)


# Each draw site as a function of (envs, shard, generator) -> a row per env.
DRAW_SITES = {
    "decks": lambda n, shard, gen: shuffled_decks(G, n, gen, "cpu", shard=shard),
    "perms": lambda n, shard, gen: tenv.sample_perms(G, n, gen, shard=shard),
    "reset_and_observe": reset_rows,
    "explore": explore_rows,
}


@pytest.mark.parametrize("site", sorted(DRAW_SITES))
def test_each_draw_site_gives_each_rank_its_rows_of_the_global_draw(site):
    """The one-rank draw over W n envs equals the W ranks' draws of n envs
    each, concatenated in rank order, from generators seeded alike."""
    draw, n = DRAW_SITES[site], 3
    whole = draw(W * n, parallel.SINGLE, torch.Generator().manual_seed(3))
    parts = [draw(n, Shard(r, W), torch.Generator().manual_seed(3)) for r in range(W)]
    assert torch.equal(torch.cat(parts), whole)


def test_shard_rows_and_all_gather_rows_round_trip_in_one_process():
    x = torch.arange(24, dtype=torch.float32).reshape(6, 4)
    pieces = [parallel.shard_rows(x, Mesh(rank=r, world=3)) for r in range(3)]
    assert all(p.shape == (2, 4) for p in pieces) and torch.equal(torch.cat(pieces), x)
    one = parallel.make_mesh("cpu")
    assert (one.rank, one.world) == (0, 1)
    tensors = [x, torch.ones(6, dtype=torch.bool)]
    assert all(a is b for a, b in zip(parallel.all_gather_rows(tensors, one), tensors))
    assert parallel.shard_rows(x, one) is x


def test_counts_that_do_not_divide_by_the_ranks_raise():
    mesh = Mesh(rank=0, world=3)
    with pytest.raises(ValueError, match="num_envs 4 does not divide by 3 ranks"):
        parallel.check_divisible(mesh, num_envs=4, batchsize=6)
    with pytest.raises(ValueError, match="batchsize 4 does not divide by 3 ranks"):
        parallel.check_divisible(mesh, num_envs=6, batchsize=4)
    setup = tlearner.make_setup(tconfig.make_config("sad_2p", **SMALL))  # 4 envs, a batch of 4
    state = tlearner.init_train_state(setup, 0, "cpu")
    with pytest.raises(ValueError, match="num_envs 4 does not divide by 3 ranks"):
        parallel.shard_train_state(state, mesh)
    assert parallel.shard_train_state(state, Mesh(rank=1, world=2)).actor.carry_len.shape == (2,)
    state, _ = tlearner.collect_only(setup, state)
    with pytest.raises(ValueError, match="batchsize 4 does not divide by 3 ranks"):
        tlearner.sgd_update(setup, tlearner.make_optimizer(setup.train), state._replace(mesh=mesh))
