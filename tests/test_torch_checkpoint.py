"""The port's checkpoints (`hanabi_sad_tpu_torch.train.checkpoint`), the
driver's saving and resume (`train.selfplay`) and its utilities
(`hanabi_sad_tpu_torch.utils`) against the JAX package's.

  * the flagship `train_state` payload (docs/runs/sad_aux_r1_latest.pkl)
    restores into the port: params, Adam moments (leaf by leaf, by name),
    counts, update counter and key words exactly (that it needs no JAX
    import: tests/test_torch_isolation.py);
  * one resumed sgd_update from that payload (full width, 4 episodes x 12
    steps) equals the JAX package's resumed one, at the tolerances of
    tests/test_torch_learner.py;
  * payloads the port writes load in the JAX package: a params payload gives
    JAX's forward bit for bit and scores in JAX's eval CLI; a train_state
    payload restores in JAX's `restore_train_state` with mu, nu and counts
    equal to the port's (not the fresh template's);
  * a port round trip is exact, generator states included;
  * TopkSaver and MultiCounter behave like the JAX ones;
  * selfplay writes train.log, the top-k payloads, latest.pkl and the
    forced 50-epoch snapshot, and resumes from latest.pkl."""

import dataclasses
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hanabi_sad_tpu.models import r2d2_net as jnet
from hanabi_sad_tpu.replay import prioritized as jrep
from hanabi_sad_tpu.tools import eval_model as jeval_model
from hanabi_sad_tpu.train import checkpoint as jckpt
from hanabi_sad_tpu.train import config as jconfig
from hanabi_sad_tpu.train import learner as jlearner
from hanabi_sad_tpu.utils import MultiCounter as JMultiCounter
from hanabi_sad_tpu.utils import TopkSaver as JTopkSaver
from hanabi_sad_tpu_torch.train import checkpoint as tckpt
from hanabi_sad_tpu_torch.train import config as tconfig
from hanabi_sad_tpu_torch.train import learner as tlearner
from hanabi_sad_tpu_torch.train import selfplay
from hanabi_sad_tpu_torch.utils import MultiCounter, TopkSaver
from test_torch_learner import fill_replays
from torch_parity import jax_net, np_net, torch_net

ROOT = Path(__file__).resolve().parents[1]
LATEST = str(ROOT / "docs/runs/sad_aux_r1_latest.pkl")
# The flagship run's optimizer (the payload's config), at a small replay,
# batch and episode length; the net keeps its full width.
RESUME = dict(pred_weight=0.25, lr_final=1e-5, lr_decay_updates=1100000, replay_buffer_size=128,
              batchsize=8, num_envs=4, max_len=12)


def leaf_names(net):
    """Names of the net's leaves in `param_leaves` order."""
    names = []
    for field, value in zip(net._fields, net):
        for i, d in enumerate(value if isinstance(value, list) else [value]):
            prefix = f"{field}.{i}" if isinstance(value, list) else field
            names.extend(f"{prefix}.{k}" for k in sorted(d))
    return names


def jax_leaf_names(tree):
    """JAX pytree paths of the same leaves, written the same way."""
    out = []
    for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = []
        for p in path:
            parts.append(str(getattr(p, "name", getattr(p, "idx", getattr(p, "key", p)))))
        out.append(".".join(parts))
    return out


def raw_payload(path):
    """The payload as the JAX package reads it (plain pickle)."""
    return jckpt.load(path)


def test_flagship_train_state_restores_into_the_port():
    payload = tckpt.load(LATEST)
    ref = raw_payload(LATEST)
    setup = tlearner.make_setup(tconfig.make_config("sad_2p", **RESUME))
    state = tckpt.restore_train_state(payload, tlearner.init_train_state(setup, 0, "cpu"))
    online = ref["params"].online
    adam = ref["opt_state"][1][0]
    names = leaf_names(state.params.online)
    assert names == jax_leaf_names(online)  # the two leaf orders agree name by name
    for name, t, j, m, jm, v, jv in zip(names, tlearner.param_leaves(state.params.online),
                                        jax.tree_util.tree_leaves(online), state.opt_state.mu,
                                        jax.tree_util.tree_leaves(adam.mu), state.opt_state.nu,
                                        jax.tree_util.tree_leaves(adam.nu)):
        np.testing.assert_array_equal(t.numpy(), j, err_msg=name)
        np.testing.assert_array_equal(m.numpy(), jm, err_msg=name)
        np.testing.assert_array_equal(v.numpy(), jv, err_msg=name)
        assert float(np.abs(jv).max()) > 0, name  # real moments, not a fresh template
    for t, j in zip(tlearner.param_leaves(state.params.target), jax.tree_util.tree_leaves(ref["params"].target)):
        np.testing.assert_array_equal(t.numpy(), j)
    assert state.num_update == 798560
    assert state.opt_state.count == int(adam.count) == 798560
    assert state.opt_state.lr_count == 798560
    # the port's generators are seeded from the key words (word 0 * 2**32 + word 1)
    assert state.env_gen.initial_seed() == (int(ref["env_key"][0]) << 32) | int(ref["env_key"][1])
    assert state.sample_gen.initial_seed() == (int(ref["sample_key"][0]) << 32) | int(ref["sample_key"][1])


def test_loaded_params_are_contiguous():
    """The flagship's fc_a and pred weights are stored in Fortran order; the
    port's tensors are C-contiguous all the same, as a restored state's are
    (a product over another layout rounds differently on the card)."""
    stored = raw_payload(str(ROOT / "docs/runs/sad_aux_r4_soup10.pkl"))["params"]
    assert not stored.fc_a["w"].flags["C_CONTIGUOUS"]
    net = tckpt.from_jax_params(tckpt.load(str(ROOT / "docs/runs/sad_aux_r4_soup10.pkl"))["params"], "cpu")
    assert all(t.is_contiguous() for t in tlearner.param_leaves(net))
    np.testing.assert_array_equal(net.fc_a["w"].numpy(), stored.fc_a["w"])


def test_one_resumed_sgd_update_matches_jax():
    """The flagship payload restored in both packages, the same replay and
    presampled batch: loss, grad_norm and the stats to 1e-5 relative, the
    new params to 1e-7 absolute (one Adam step, lr 2.4e-5 at this point of
    the schedule), the new moments to 1e-6 of each tensor's largest value
    (the grads agree to float32 rounding; mu keeps 0.1 and nu 0.001 of
    them)."""
    payload = tckpt.load(LATEST)
    jsetup = jlearner.make_setup(jconfig.make_config("sad_2p", **RESUME))
    tsetup = tlearner.make_setup(tconfig.make_config("sad_2p", **RESUME))
    jstate = jckpt.restore_train_state(raw_payload(LATEST), jlearner.init_train_state(jsetup, jax.random.PRNGKey(0)))
    tstate = tckpt.restore_train_state(payload, tlearner.init_train_state(tsetup, 0, "cpu"))
    jstate, tstate = fill_replays(jsetup, tsetup, jstate, tstate, M=12, seed=3)
    idx = np.asarray([2, 2, 9, 0], np.int32)
    is_w = np.asarray([1.0, 1.0, 0.5, 0.8], np.float32)
    j_rows = jrep.gather_rows(jstate.replay, jnp.asarray(idx))
    jopt = jlearner.make_optimizer(jsetup.train)
    jstate2, jm = jax.jit(lambda s, p: jlearner.sgd_update(jsetup, jopt, s, presampled=p))(
        jstate, (j_rows, jnp.asarray(is_w), jnp.asarray(idx)))
    tstate2, tm = tlearner.sgd_update(tsetup, tlearner.make_optimizer(tsetup.train), tstate,
                                      presampled=(torch.from_numpy(is_w), torch.from_numpy(idx).long()))
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    for t, j in zip(tlearner.param_leaves(tstate2.params.online), jax.tree_util.tree_leaves(jstate2.params.online)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=1e-7, rtol=0)
    adam = jstate2.opt_state[1][0]
    for t, j in zip(tstate2.opt_state.mu + tstate2.opt_state.nu,
                    jax.tree_util.tree_leaves(adam.mu) + jax.tree_util.tree_leaves(adam.nu)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, atol=1e-6 * float(np.abs(j).max()), rtol=0)
    assert tstate2.num_update == int(jstate2.num_update) == 798561
    assert tstate2.opt_state.count == int(adam.count)


def test_a_port_params_payload_gives_jax_forward_bit_for_bit_and_scores_in_jax(tmp_path):
    net = np_net(838, 32, 21, 5, 2, seed=4)
    path = str(tmp_path / "port.pkl")
    tckpt.save(path, tckpt.params_payload(torch_net(net), {"sad": True, "hand_size": 5}))
    loaded = raw_payload(path)
    assert type(loaded["params"]) is jnet.R2D2NetParams
    cfg = jnet.NetConfig(in_dim=838, hid_dim=32, out_dim=21, num_lstm_layer=2)
    rng = np.random.RandomState(5)
    priv_s = jnp.asarray((rng.rand(6, 3, 838) < 0.2).astype(np.float32))
    legal = jnp.ones((6, 3, 21), jnp.float32)
    action = jnp.asarray(rng.randint(0, 21, (6, 3)))
    ours = jnet.forward(jax.tree_util.tree_map(jnp.asarray, loaded["params"]), cfg, priv_s, legal, action)
    theirs = jnet.forward(jax_net(net), cfg, priv_s, legal, action)
    for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(theirs)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    jpath = str(tmp_path / "jax.pkl")
    jckpt.save(jpath, jckpt.params_payload(jax_net(net), {"sad": True, "hand_size": 5}))
    scores = [jeval_model.main(["--weight", p, "--num_game", "8"]) for p in (path, jpath)]
    assert scores[0] == scores[1]


def small_port_state(seed=0, **kw):
    setup = tlearner.make_setup(tconfig.make_config(
        "sad_2p", pred_weight=0.25, rnn_hid_dim=32, replay_buffer_size=64, num_envs=2, max_len=8, **kw))
    state = tlearner.init_train_state(setup, seed, "cpu")
    gen = torch.Generator().manual_seed(seed + 7)
    opt = state.opt_state._replace(
        mu=[torch.randn(m.shape, generator=gen) for m in state.opt_state.mu],
        nu=[torch.rand(v.shape, generator=gen) for v in state.opt_state.nu], count=7, lr_count=7)
    torch.rand(5, generator=state.env_gen)  # move the streams on
    torch.rand(3, generator=state.sample_gen)
    return setup, state._replace(opt_state=opt, num_update=7)


def test_a_port_train_state_payload_restores_in_jax(tmp_path):
    setup, state = small_port_state()
    path = str(tmp_path / "latest.pkl")
    tckpt.save(path, tckpt.train_state_payload(state, {"preset": "sad_2p"}))
    jsetup = jlearner.make_setup(jconfig.make_config(
        "sad_2p", pred_weight=0.25, rnn_hid_dim=32, replay_buffer_size=64, num_envs=2, max_len=8))
    fresh = jlearner.init_train_state(jsetup, jax.random.PRNGKey(3))
    jstate = jckpt.restore_train_state(raw_payload(path), fresh)
    adam, schedule = jstate.opt_state[1]
    assert leaf_names(state.params.online) == jax_leaf_names(jstate.params.online)
    pairs = [(state.opt_state.mu, adam.mu), (state.opt_state.nu, adam.nu),
             (tlearner.param_leaves(state.params.online), jstate.params.online),
             (tlearner.param_leaves(state.params.target), jstate.params.target)]
    for ours, theirs in pairs:
        for t, j in zip(ours, jax.tree_util.tree_leaves(theirs)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert int(adam.count) == int(schedule.count) == int(jstate.num_update) == 7
    # not the fresh template's zero moments
    assert any(float(jnp.abs(m).max()) > 0 for m in jax.tree_util.tree_leaves(adam.mu))
    key = lambda g: [(g.initial_seed() >> 32) & 0xFFFFFFFF, g.initial_seed() & 0xFFFFFFFF]
    assert np.asarray(jstate.env_key).tolist() == key(state.env_gen)
    assert np.asarray(jstate.sample_key).tolist() == key(state.sample_gen)


def test_a_port_round_trip_is_exact(tmp_path):
    setup, state = small_port_state(seed=2)
    path = str(tmp_path / "latest.pkl")
    tckpt.save(path, tckpt.train_state_payload(state, {}))
    back = tckpt.restore_train_state(tckpt.load(path), tlearner.init_train_state(setup, 9, "cpu"))
    for a, b in zip(tlearner.param_leaves(state.params.online) + tlearner.param_leaves(state.params.target)
                    + state.opt_state.mu + state.opt_state.nu,
                    tlearner.param_leaves(back.params.online) + tlearner.param_leaves(back.params.target)
                    + back.opt_state.mu + back.opt_state.nu):
        assert torch.equal(a, b)
    assert (back.num_update, back.opt_state.count, back.opt_state.lr_count) == (7, 7, 7)
    for a, b in ((state.env_gen, back.env_gen), (state.sample_gen, back.sample_gen)):
        assert torch.equal(a.get_state(), b.get_state())
        assert torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=b))


def test_restore_refuses_a_payload_without_adam_moments():
    setup, state = small_port_state()
    payload = tckpt.train_state_payload(state, {})
    payload["opt_state"] = (tckpt.EmptyState(), (tckpt.EmptyState(), tckpt.ScaleByScheduleState(count=7)))
    with pytest.raises(ValueError, match="ScaleByAdamState"):
        tckpt.restore_train_state(payload, state)
    with pytest.raises(ValueError, match="train_state"):
        tckpt.restore_train_state({"kind": "params"}, state)


@pytest.mark.parametrize("perfs", [[1.0, 3.0, 2.0, 5.0, 0.5, 4.0, 6.0, 2.5], [2.0, 2.0, 2.0, 1.0, 3.0, 3.0, 7.0]])
def test_topk_saver_behaves_like_jax(tmp_path, perfs):
    ours, theirs = TopkSaver(str(tmp_path / "port"), 3, write=tckpt.save), JTopkSaver(str(tmp_path / "jax"), 3)
    for i, perf in enumerate(perfs):
        payload = {"kind": "params", "params": np.full(3, i, np.float32)}
        force = f"model_epoch{i}" if i % 3 == 0 else None
        assert ours.save(payload, perf, force_save_name=force) == theirs.save(payload, perf, force_save_name=force)
        assert (ours.perfs, ours.worst_perf_idx) == (theirs.perfs, theirs.worst_perf_idx)
    files = lambda d: sorted(p.name for p in d.iterdir())
    assert files(tmp_path / "port") == files(tmp_path / "jax")
    for p in (tmp_path / "jax").iterdir():
        with open(p, "rb") as f:
            ref = pickle.load(f)
        np.testing.assert_array_equal(tckpt.load(str(tmp_path / "port" / p.name))["params"], ref["params"])


def test_multicounter_behaves_like_jax():
    ours, theirs = MultiCounter(), JMultiCounter()
    rows = [{"loss": 1.5, "grad_norm": 3.0}, {"loss": 0.5, "aux1": 0.25}, {"loss": 2.5, "grad_norm": 1.0}]
    for counter in (ours, theirs):
        for row in rows:
            counter.feed_dict(row)
    # the first line is the time since the last reset
    assert ours.summary(3).splitlines()[1:] == theirs.summary(3).splitlines()[1:]
    ours.reset(), theirs.reset()
    assert ours.summary(4).splitlines()[1:] == theirs.summary(4).splitlines()[1:] == []


def test_selfplay_saves_snapshots_and_resumes(tmp_path, capsys):
    """51 one-chunk epochs with evals only every 100: the eval gate still
    fires at epoch 0, at epoch 50 (the forced snapshot) and at the last."""
    small = dict(pred_weight=0.25, num_envs=4, batchsize=4, burn_in_frames=8, replay_buffer_size=32,
                 epoch_len=1, num_update_per_chunk=1, num_eval_game=2, max_len=6, rnn_hid_dim=8,
                 eval_max_steps=60, num_eps=2, eval_freq_epochs=100, save_dir=str(tmp_path / "run"))
    out = selfplay.train(tconfig.make_config("sad_2p", num_epoch=51, **small), device="cpu")
    run = tmp_path / "run"
    names = {p.name for p in run.iterdir()}
    assert {"train.log", "latest.pkl", "model0.pkl", "model_epoch50.pkl"} <= names
    log = (run / "train.log").read_text()
    assert log.count("eval score") == 2 and "epoch 50, eval score" in log and "Total Sample" in log
    latest = tckpt.load(str(run / "latest.pkl"))
    assert latest["kind"] == "train_state" and latest["num_update"] == out["num_update"] == 51
    resumed = selfplay.train(tconfig.make_config(
        "sad_2p", num_epoch=1, load_model=str(run / "latest.pkl"), **dict(small, save_dir=str(tmp_path / "again"))),
        device="cpu")
    assert "resumed at update 51" in capsys.readouterr().out
    assert resumed["num_update"] == 52


def test_a_bf16_port_payload_round_trips_both_ways(tmp_path):
    """A port train_state payload whose config says bfloat16: the port
    restores it exactly into a bfloat16 state, and the JAX package restores
    it into its own bfloat16 state (params and moments bit for bit, float32);
    a params payload with that config evaluates in the JAX package."""
    setup, state = small_port_state(seed=4, compute_dtype="bfloat16")
    config = dataclasses.asdict(setup.train)
    assert config["compute_dtype"] == "bfloat16"
    path = str(tmp_path / "latest.pkl")
    tckpt.save(path, tckpt.train_state_payload(state, config))
    payload = tckpt.load(path)
    tcfg = tconfig.TrainConfig(**payload["config"])
    back = tckpt.restore_train_state(payload, tlearner.init_train_state(tlearner.make_setup(tcfg), 9, "cpu"))
    ours = tlearner.param_leaves(state.params.online) + state.opt_state.mu + state.opt_state.nu
    for a, b in zip(ours, tlearner.param_leaves(back.params.online) + back.opt_state.mu + back.opt_state.nu):
        assert a.dtype == b.dtype == torch.float32 and torch.equal(a, b)

    jcfg = jconfig.TrainConfig(**raw_payload(path)["config"])
    assert jcfg.compute_dtype == "bfloat16"
    jstate = jckpt.restore_train_state(raw_payload(path), jlearner.init_train_state(
        jlearner.make_setup(jcfg), jax.random.PRNGKey(2)))
    adam = jstate.opt_state[1][0]
    theirs = (jax.tree_util.tree_leaves(jstate.params.online) + jax.tree_util.tree_leaves(adam.mu)
              + jax.tree_util.tree_leaves(adam.nu))
    for t, j in zip(ours, theirs):
        assert np.asarray(j).dtype == np.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))

    ppath = str(tmp_path / "model0.pkl")
    tckpt.save(ppath, tckpt.params_payload(state.params.online, config))
    mean, _, _ = jeval_model.main(["--weight", ppath, "--num_game", "4"])
    assert 0 <= mean <= 25


def test_a_jax_bf16_train_state_restores_into_a_bf16_port_state(tmp_path):
    """A train_state payload that the JAX package wrote after one bfloat16
    update: the port builds its bfloat16 setup from the payload's config,
    restores params and moments bit for bit, and takes a bfloat16 update."""
    small = dict(pred_weight=0.25, rnn_hid_dim=32, replay_buffer_size=64, num_envs=2, max_len=8, batchsize=4,
                 compute_dtype="bfloat16")
    jsetup = jlearner.make_setup(jconfig.make_config("sad_2p", **small))
    tsetup0 = tlearner.make_setup(tconfig.make_config("sad_2p", **small))
    jstate = jlearner.init_train_state(jsetup, jax.random.PRNGKey(5))
    jstate, _ = fill_replays(jsetup, tsetup0, jstate, tlearner.init_train_state(tsetup0, 0, "cpu"), M=10, seed=4)
    idx = jnp.asarray([1, 4], jnp.int32)
    jopt = jlearner.make_optimizer(jsetup.train)
    jstate, _ = jax.jit(lambda s, p: jlearner.sgd_update(jsetup, jopt, s, presampled=p))(
        jstate, (jrep.gather_rows(jstate.replay, idx), jnp.ones(2), idx))
    path = str(tmp_path / "jax_latest.pkl")
    jckpt.save(path, jckpt.train_state_payload(jstate, dataclasses.asdict(jsetup.train)))

    payload = tckpt.load(path)
    tcfg = tconfig.TrainConfig(**payload["config"])
    assert tcfg.compute_dtype == "bfloat16"
    tsetup = tlearner.make_setup(tcfg)
    assert tsetup.agent.net.cdtype == torch.bfloat16
    tstate = tckpt.restore_train_state(payload, tlearner.init_train_state(tsetup, 0, "cpu"))
    adam = jstate.opt_state[1][0]
    for t, j in zip(tlearner.param_leaves(tstate.params.online) + tstate.opt_state.mu + tstate.opt_state.nu,
                    jax.tree_util.tree_leaves(jstate.params.online) + jax.tree_util.tree_leaves(adam.mu)
                    + jax.tree_util.tree_leaves(adam.nu)):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert tstate.num_update == 1
    _, tstate = fill_replays(jsetup, tsetup, jstate, tstate, M=10, seed=4)
    tstate, metrics = tlearner.sgd_update(tsetup, tlearner.make_optimizer(tcfg), tstate)
    assert all(np.isfinite(float(v)) for v in metrics.values()) and tstate.num_update == 2
