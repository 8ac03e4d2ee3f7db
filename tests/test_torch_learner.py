"""The port's trainer (`hanabi_sad_tpu_torch.train`: config, optim, learner,
selfplay) against the JAX package's.

  * the config, presets and derived setup of `sad_2p` equal the JAX ones;
  * clip-by-global-norm + Adam with a linear lr schedule equals optax for 3
    steps, grads above and below the clip (1e-6 relative: the same float32
    arithmetic in another order);
  * one sgd_update from the same params, replay and presampled batch (hidden
    64, T = 12, 4 episodes x 2 players, pred_weight 0.25) equals the JAX
    one: loss and grad_norm to 1e-5 relative, the new params to 1e-7 abs
    (one Adam step of lr 6.25e-5), the new replay weights to 1e-5 abs;
  * selfplay.train runs two chunks on the CPU at a small width."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hanabi_sad_tpu.replay import bitpack as jbitpack
from hanabi_sad_tpu.replay import prioritized as jrep
from hanabi_sad_tpu.train import config as jconfig
from hanabi_sad_tpu.train import learner as jlearner
from hanabi_sad_tpu_torch.replay import prioritized as trep
from hanabi_sad_tpu_torch.train import config as tconfig
from hanabi_sad_tpu_torch.train import learner as tlearner
from hanabi_sad_tpu_torch.train import selfplay
from hanabi_sad_tpu_torch.train.checkpoint import from_jax_params
from hanabi_sad_tpu_torch.train.optim import ClipAdam, linear_schedule

SMALL = dict(pred_weight=0.25, rnn_hid_dim=64, max_len=12, replay_buffer_size=128, batchsize=8, num_envs=4)


def test_config_presets_and_eps_menu_match_jax():
    assert tconfig.PRESETS == jconfig.PRESETS
    for preset in ("sad_2p", "vdn_2p"):
        t, j = tconfig.make_config(preset, pred_weight=0.25), jconfig.make_config(preset, pred_weight=0.25)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert dataclasses.asdict(t.derived()) == dataclasses.asdict(j.derived())
    for args in ((0.1, 7.0, 80), (0.4, 7.0, 1), (0.1, 7.0, 3)):
        assert tconfig.generate_explore_eps(*args) == jconfig.generate_explore_eps(*args)


@pytest.mark.parametrize("overrides", [
    dict(compute_dtype="bfloat16"), dict(method="iql"), dict(method="iql", num_player=5),
    dict(profile_chunks=3), dict(method="iql", num_player=3, compute_dtype="bfloat16", profile_chunks=1),
    dict(shuffle_color=True), dict(shuffle_obs=True), dict(exact_priority_in_rollout=False),
    dict(continuous_exact_priority=False), dict(rollout_mode="aligned"), dict(stacked_td=True),
    dict(snapshot_sampling=True), dict(multihost=True),
])
def test_ported_features_construct_as_in_jax(overrides):
    """bfloat16 compute, IQL at 2-5 players, profile_chunks, Other-Play,
    shuffled observations, the two priority knobs, the aligned rollout,
    stacked_td, snapshot_sampling and multihost give the JAX package's config
    and derived setup; IQL divides nothing by num_player."""
    t, j = tconfig.make_config("sad_2p", **overrides), jconfig.make_config("sad_2p", **overrides)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.derived()) == dataclasses.asdict(j.derived())
    if t.method == "iql":
        assert t.derived() == t
    ts, js = tlearner.make_setup(t), jlearner.make_setup(j)
    assert ts.agent.stacked_td == js.agent.stacked_td == t.stacked_td


def test_parse_overrides_reads_each_field_as_its_type_in_both_packages():
    """The scripts' --set key=value flags: bools from 0/1/true/false, the
    rest cast to the field's type, which is JAX's field's type."""
    items = ["continuous_exact_priority=False", "shuffle_color=1", "compute_dtype=bfloat16",
             "gamma=0.999", "num_envs=1024", "adam_eps=1.5e-05"]
    got = tconfig.parse_overrides(items)
    assert got == dict(continuous_exact_priority=False, shuffle_color=True, compute_dtype="bfloat16",
                       gamma=0.999, num_envs=1024, adam_eps=1.5e-05)
    for key, value in got.items():
        assert type(value) is type(getattr(jconfig.TrainConfig(), key))
    t, j = tconfig.make_config("sad_aux_op_2p", **got), jconfig.make_config("sad_aux_op_2p", **got)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert tconfig.parse_overrides(None) == {}


def test_unknown_compute_dtype_raises():
    with pytest.raises(ValueError, match="compute_dtype"):
        tconfig.make_config("sad_2p", compute_dtype="float16")


def test_make_setup_sad_2p_matches_jax():
    t = tlearner.make_setup(tconfig.make_config("sad_2p", pred_weight=0.25))
    j = jlearner.make_setup(jconfig.make_config("sad_2p", pred_weight=0.25))
    assert dataclasses.asdict(t.train) == dataclasses.asdict(j.train)
    assert dataclasses.asdict(t.replay) == dataclasses.asdict(j.replay)
    assert t.replay.capacity == 65536 and t.train.batchsize == 64 and t.replay.bytes_per_step == 110
    for te, je in ((t.env, j.env), (t.eval_env, j.eval_env)):
        assert (te.eps_list, te.max_len, te.sad, te.feature_size) == (je.eps_list, je.max_len, je.sad, je.feature_size)
    for ta, ja in ((t.agent, j.agent), (t.eval_agent, j.eval_agent)):
        assert (ta.vdn, ta.multi_step, ta.gamma, ta.eta, ta.uniform_priority, ta.stacked_td) == (
            ja.vdn, ja.multi_step, ja.gamma, ja.eta, ja.uniform_priority, ja.stacked_td)
        tn, jn = dataclasses.asdict(ta.net), dataclasses.asdict(ja.net)
        jn.pop("seq_unroll")
        assert tn == jn
    assert (t.players_per_item, t.items_per_chunk) == (j.players_per_item, j.items_per_chunk)


def test_clip_adam_with_linear_schedule_matches_optax():
    rng = np.random.RandomState(0)
    params = [rng.randn(7, 5).astype(np.float32), rng.randn(5).astype(np.float32)]
    grads = [[s * rng.randn(*p.shape).astype(np.float32) for p in params] for s in (3.0, 0.1, 2.0)]
    schedule = optax.linear_schedule(1e-2, 1e-3, 2)
    opt = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(schedule, eps=1.5e-5))
    j_params = [jnp.asarray(p) for p in params]
    j_state = opt.init(j_params)
    ours = ClipAdam(lr=linear_schedule(1e-2, 1e-3, 2), max_norm=5.0, eps=1.5e-5)
    t_params = [torch.from_numpy(p.copy()) for p in params]
    t_state = ours.init(t_params)
    for step, g in enumerate(grads):
        updates, j_state = opt.update([jnp.asarray(x) for x in g], j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        t_state, norm = ours.step(t_params, [torch.from_numpy(x) for x in g], t_state)
        np.testing.assert_allclose(float(norm), float(optax.global_norm([jnp.asarray(x) for x in g])), rtol=1e-6)
        for t, j in zip(t_params, j_params):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7, err_msg=f"step {step}")
    assert t_state.count == 3
    adam_state = j_state[1][0]
    for t, j in zip(t_state.mu + t_state.nu, list(adam_state.mu) + list(adam_state.nu)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-9)


def fill_replays(jsetup, tsetup, jstate, tstate, M=20, seed=1):
    cfg = jsetup.replay
    rng = np.random.RandomState(seed)
    bits = (rng.rand(M, cfg.seq_len, cfg.num_player, cfg.bits_per_step) < 0.15).astype(np.float32)
    bits[..., cfg.obs_dim + cfg.num_actions - 1] = 1.0  # the no-op is always legal
    packed = np.array(jbitpack.pack_bits(jnp.asarray(bits)))
    action = rng.randint(0, cfg.num_actions, (M, cfg.seq_len, cfg.num_player)).astype(np.int32)
    reward = rng.randn(M, cfg.seq_len).astype(np.float32)
    seq_len = rng.randint(2, cfg.seq_len + 1, (M,)).astype(np.float32)
    bootstrap = (np.arange(cfg.seq_len)[None] < seq_len[:, None] - 3).astype(np.float32)
    prio = rng.uniform(0.1, 2.0, (M,)).astype(np.float32)
    args = (packed, action, reward, bootstrap, seq_len, prio)
    jrep_state = jrep.add_packed(jstate.replay, cfg, *map(jnp.asarray, args))
    trep_state = trep.add_packed(tstate.replay, tsetup.replay, *(torch.from_numpy(np.array(a)) for a in args))
    return jstate._replace(replay=jrep_state), tstate._replace(replay=trep_state)


def test_one_sgd_update_with_a_presampled_batch_matches_jax():
    jsetup = jlearner.make_setup(jconfig.make_config("sad_2p", **SMALL))
    tsetup = tlearner.make_setup(tconfig.make_config("sad_2p", **SMALL))
    jstate = jlearner.init_train_state(jsetup, jax.random.PRNGKey(0))
    tstate = tlearner.init_train_state(tsetup, 0, "cpu")
    np_params = jax.tree_util.tree_map(np.asarray, jstate.params)
    tstate = tstate._replace(params=type(tstate.params)(
        online=from_jax_params(np_params.online, "cpu"), target=from_jax_params(np_params.target, "cpu")))
    jstate, tstate = fill_replays(jsetup, tsetup, jstate, tstate)

    idx = np.asarray([3, 3, 17, 0], np.int32)  # a duplicate included
    is_w = np.asarray([0.5, 0.5, 1.0, 0.25], np.float32)
    j_rows = jrep.gather_rows(jstate.replay, jnp.asarray(idx))
    jopt = jlearner.make_optimizer(jsetup.train)
    j_update = jax.jit(lambda s, p: jlearner.sgd_update(jsetup, jopt, s, presampled=p))
    jstate2, jm = j_update(jstate, (j_rows, jnp.asarray(is_w), jnp.asarray(idx)))
    tstate2, tm = tlearner.sgd_update(
        tsetup, tlearner.make_optimizer(tsetup.train), tstate,
        presampled=(torch.from_numpy(is_w), torch.from_numpy(idx).long()),
    )
    assert tm.keys() == jm.keys()
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    j_leaves = jax.tree_util.tree_leaves(jstate2.params.online)
    t_leaves = tlearner.param_leaves(tstate2.params.online)
    for t, j in zip(t_leaves, j_leaves):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=1e-7, rtol=0)
    for t, j in zip(tlearner.param_leaves(tstate2.params.target), jax.tree_util.tree_leaves(jstate2.params.target)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))  # synced at update 0, before the step
    np.testing.assert_allclose(tstate2.replay.weight.numpy(), np.asarray(jstate2.replay.weight), atol=1e-5, rtol=0)
    assert tstate2.num_update == int(jstate2.num_update) == 1


def test_selfplay_train_runs_two_chunks_on_the_cpu(capsys, tmp_path):
    cfg = tconfig.make_config(
        "sad_2p", pred_weight=0.25, num_envs=8, batchsize=8, burn_in_frames=16, replay_buffer_size=64,
        epoch_len=4, num_update_per_chunk=2, num_epoch=3, num_eval_game=4, max_len=16, rnn_hid_dim=32,
        num_update_between_sync=3, eval_max_steps=100, num_eps=4, save_dir=str(tmp_path),
    )
    out = selfplay.train(cfg, max_chunks=2, device="cpu")
    log = capsys.readouterr().out
    assert out["num_update"] == 4 and out["epoch"] == 0
    assert all(np.isfinite(v) for v in out["metrics"].values())
    assert {"loss", "rl_loss", "aux1", "grad_norm", "chunk_score"} <= out["metrics"].keys()
    assert "warming up replay buffer" in log and "eval score" in log and "aux1" in log


def test_parse_args_takes_the_flag_line_of_the_flagship():
    cfg, device = selfplay.parse_args(
        ["--preset", "sad_2p", "--pred_weight", "0.25", "--num_envs", "1024", "--device", "cpu", "--sad", "1"])
    assert cfg == tconfig.make_config("sad_2p", pred_weight=0.25, num_envs=1024, sad=True)
    assert device == "cpu"
