"""The learner's two knobs in the port: `snapshot_sampling`
(`train.learner.train_chunk`) and `stacked_td` (`agent.r2d2_agent.td_error`).

  * Ports of the JAX package's TestSnapshotSampling
    (tests/test_train_smoke.py): at one update a chunk the snapshot path
    gives the sequential path's bits (params, replay weights, loss), in both
    rollout modes; at four it trains and its priority feedback lands.
  * The snapshot's rows are drawn before the first update: they equal the
    draws of the sampler on the priorities the collect left, from the
    sampler's stream as the chunk found it; the live priorities, which a
    draw inside the loop would read, give other IS weights.
  * The port of TestStackedTD (tests/test_agent.py): with stacked_td the
    port's td_error, loss, priorities and grads against the JAX package's
    stacked branch on the same numpy nets, err and lstm_o within 1e-5 abs,
    loss and priorities within 1e-5, grads within 1e-4 relative + 1e-5 abs
    (the JAX test's own tolerances). The port computes that branch's
    numbers with its two unstacked forwards, so the flag changes no code
    path there; a trainer built with it trains in float32 and bfloat16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hanabi_sad_tpu.agent import r2d2_agent as jagent
from hanabi_sad_tpu.models import r2d2_net as jnet
from hanabi_sad_tpu_torch.agent import r2d2_agent as tagent
from hanabi_sad_tpu_torch.models import r2d2_net as tnet
from hanabi_sad_tpu_torch.replay import prioritized as trep
from hanabi_sad_tpu_torch.train import config as tconfig
from hanabi_sad_tpu_torch.train import learner as tlearner
from hanabi_sad_tpu_torch.train.learner import param_leaves
from torch_parity import agent_params, batches, np_batch, np_net


def tiny_setup(**kw):
    """The JAX test's tiny_cfg (dev preset) at the port."""
    base = dict(num_envs=16, num_update_per_chunk=2, batchsize=8, burn_in_frames=32, replay_buffer_size=256,
                epoch_len=4, num_epoch=1, num_eval_game=8, max_len=24, rnn_hid_dim=32, num_update_between_sync=10,
                eval_max_steps=100, num_eps=4)
    return tlearner.make_setup(tconfig.make_config("dev", **dict(base, **kw)))


def collected(setup, seed=0):
    state = tlearner.init_train_state(setup, seed, "cpu")
    state, _ = tlearner.collect_only(setup, state)
    return state, tlearner.make_optimizer(setup.train)


@pytest.mark.parametrize("mode,extra", [("continuous", dict(slots_per_env=2)), ("aligned", {})])
def test_single_update_chunk_bit_identical(mode, extra):
    outs = []
    for snap in (False, True):
        setup = tiny_setup(num_update_per_chunk=1, snapshot_sampling=snap, rollout_mode=mode, **extra)
        state, optimizer = collected(setup)
        for _ in range(3):
            state, metrics = tlearner.train_chunk(setup, optimizer, state)
        outs.append((param_leaves(state.params.online), state.replay.weight, metrics["loss"]))
    for a, b in zip(outs[0][0], outs[1][0]):
        assert torch.equal(a, b)
    assert torch.equal(outs[0][1], outs[1][1])
    assert torch.equal(outs[0][2], outs[1][2])


def test_multi_update_chunk_trains():
    setup = tiny_setup(num_update_per_chunk=4, snapshot_sampling=True, rollout_mode="continuous", slots_per_env=2)
    state, optimizer = collected(setup)
    w_before = state.replay.weight.clone()
    online_before = [t.clone() for t in param_leaves(state.params.online)]
    state, metrics = tlearner.train_chunk(setup, optimizer, state)
    assert np.isfinite(float(metrics["loss"]))
    assert max(float((a - b.detach()).abs().max()) for a, b in zip(online_before, param_leaves(state.params.online))) > 0
    assert not torch.equal(w_before, state.replay.weight)


def test_snapshot_rows_come_from_the_priorities_before_the_first_update(monkeypatch):
    U = 4
    setup = tiny_setup(num_update_per_chunk=U, snapshot_sampling=True, rollout_mode="aligned")
    state, optimizer = collected(setup)
    state, _ = tlearner.train_chunk(setup, optimizer, state)  # weights no longer the collect's alone
    seen = []
    update = tlearner.sgd_update

    def recording(setup_, optimizer_, st, presampled=None):
        seen.append((st.replay.weight.clone(), presampled))
        return update(setup_, optimizer_, st, presampled=presampled)

    monkeypatch.setattr(tlearner, "sgd_update", recording)
    gen_before = state.sample_gen.get_state()
    collect = tlearner.collect_into_replay
    after_collect = []
    monkeypatch.setattr(tlearner, "collect_into_replay", lambda *a: after_collect.append(
        collect(*a)) or after_collect[-1])
    tlearner.train_chunk(setup, optimizer, state)
    assert len(seen) == U and all(drawn is not None for _, drawn in seen)
    replay_at = lambda weight: after_collect[0][0].replay._replace(weight=weight)
    gen = torch.Generator().manual_seed(0)
    gen.set_state(gen_before)
    uniforms = torch.stack([torch.rand((setup.train.batchsize,), generator=gen) for _ in range(U)])
    idx, is_w = trep.sample_indices(replay_at(seen[0][0]), setup.replay, setup.train.batchsize, uniforms=uniforms)
    for u, (_, (w_u, i_u)) in enumerate(seen):
        assert torch.equal(i_u, idx[u]) and torch.equal(w_u, is_w[u])
    # a draw inside the loop would have read the live priorities
    live = [trep.sample_indices(replay_at(weight), setup.replay, setup.train.batchsize, uniforms=uniforms[u])[1]
            for u, (weight, _) in enumerate(seen)]
    assert torch.equal(live[0], is_w[0])
    assert any(not torch.equal(live[u], is_w[u]) for u in range(1, U))


F, H, A, HAND = 40, 64, 21, 5
T, B, PI = 12, 4, 2


@pytest.fixture(scope="module")
def nets():
    """Both packages' params (a target apart from the online net) and a
    batch, from numpy."""
    jp, tp = agent_params(np_net(F, H, A, HAND, 2, seed=0), np_net(F, H, A, HAND, 2, seed=1))
    jb, tb = batches(np_batch(T, B, PI, F, A, HAND, seed=2))
    return jp, tp, jb, tb


def port_td(tp, cfg, tb, is_w):
    """err, lstm_o, the IS-weighted loss, priorities and the online grads."""
    leaves = param_leaves(tp.online)
    for t in leaves:
        t.requires_grad_(True)
    try:
        err, o = tagent.td_error(tp, cfg, tb)
        per_ep, prio, _ = tagent.loss(tp, cfg, tb, 0.25)
        total = (per_ep * is_w).mean()
        grads = torch.autograd.grad(total, leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    return [err.detach(), o.detach(), total.detach(), prio] + list(grads)


def test_stacked_matches_jax_stacked_branch(nets):
    jp, tp, jb, tb = nets
    jcfg = jagent.AgentConfig(net=jnet.NetConfig(in_dim=F, hid_dim=H, out_dim=A), stacked_td=True)
    tcfg = tagent.AgentConfig(net=tnet.NetConfig(in_dim=F, hid_dim=H, out_dim=A), stacked_td=True)
    is_w = np.linspace(0.3, 1.0, B).astype(np.float32)
    j_err, j_o = jax.jit(lambda p, b: jagent.td_error(p, jcfg, b))(jp, jb)

    def j_total(online):
        per_ep, prio, _ = jagent.loss(jagent.AgentParams(online=online, target=jp.target), jcfg, jb, 0.25)
        return (per_ep * is_w).mean(), prio

    (j_loss, j_prio), j_grads = jax.jit(jax.value_and_grad(j_total, has_aux=True))(jp.online)
    t_err, t_o, t_loss, t_prio, *t_grads = port_td(tp, tcfg, tb, torch.from_numpy(is_w))
    np.testing.assert_allclose(t_err.numpy(), np.asarray(j_err), atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_o.numpy(), np.asarray(j_o), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(t_prio.numpy(), np.asarray(j_prio), atol=1e-5, rtol=1e-5)
    for t, j in zip(t_grads, jax.tree_util.tree_leaves(j_grads)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=1e-5)
    assert float(jnp.abs(j_err).max()) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stacked_td_trains(dtype):
    setup = tiny_setup(stacked_td=True, compute_dtype=dtype, rollout_mode="aligned")
    assert setup.agent.stacked_td
    state, optimizer = collected(setup, seed=4)
    online_before = [t.clone() for t in param_leaves(state.params.online)]
    state, metrics = tlearner.train_chunk(setup, optimizer, state)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert max(float((a - b.detach()).abs().max()) for a, b in zip(online_before, param_leaves(state.params.online))) > 0
