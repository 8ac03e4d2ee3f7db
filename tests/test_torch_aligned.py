"""The port's aligned rollout mode (`hanabi_sad_tpu_torch.rollout.runner`'s
`run_episode_chunk`, `_n_step_process`, `chunk_to_episodes`,
`rollout_priority_inputs`, `episodes_to_batch`; `agent.r2d2_agent`'s
`compute_priority`; `train.learner.collect_chunk`) against the JAX package's,
at a small width (hidden 32, 8 envs, max_len 20).

  * One JAX RolloutOutput (eps 0.5, so explore steps are in it) goes through
    both packages' chunk processing, for VDN and for IQL at 2 and 3
    players: n-step returns, bootstrap, seq_len, the replay items, the
    priority inputs and the learner Batch are exactly equal.
  * run_episode_chunk on the JAX rollout's decks (and, once, its color
    permutations) at eps menu (0.0,): every record is equal up to each
    game's first differing action, which must be a near tie of the port's
    Q (top two legal values within 1e-4, float32 sums in another order may
    break it the other way; counted and printed, as
    tests/test_torch_eval.py counts them); qa within 1e-5.
  * compute_priority against JAX's within rtol 1e-5, and the port's
    compute_priority_from_rollout against its compute_priority within 1e-5
    (the JAX package's TestFastPriority).
  * collect_chunk on the JAX chunk's decks: equal stats, episodes and
    priorities within rtol 1e-5; with exploration, its explore ratio is the
    deviation rate over live frames.
  * Two aligned chunks of selfplay on the CPU, VDN and IQL, and a
    train_state round trip in aligned mode."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hanabi_sad_tpu.agent import r2d2_agent as jagent
from hanabi_sad_tpu.game import env as jenv
from hanabi_sad_tpu.game.config import GameConfig as JGameConfig
from hanabi_sad_tpu.models import r2d2_net as jnet
from hanabi_sad_tpu.rollout import runner as jrunner
from hanabi_sad_tpu.train import config as jconfig
from hanabi_sad_tpu.train import learner as jlearner
from hanabi_sad_tpu_torch.agent import r2d2_agent as tagent
from hanabi_sad_tpu_torch.game import env as tenv
from hanabi_sad_tpu_torch.game.config import GameConfig
from hanabi_sad_tpu_torch.models import r2d2_net as tnet
from hanabi_sad_tpu_torch.rollout import runner as trunner
from hanabi_sad_tpu_torch.train import checkpoint as tckpt
from hanabi_sad_tpu_torch.train import config as tconfig
from hanabi_sad_tpu_torch.train import learner as tlearner
from hanabi_sad_tpu_torch.train import selfplay
from hanabi_sad_tpu_torch.train.checkpoint import from_jax_params
from torch_parity import agent_params, np_net, to_torch_tree

N, HID, MAX_LEN = 8, 32, 20
TIE = 1e-4


@functools.lru_cache(maxsize=None)
def jax_chunk(players, vdn, sad=True, shuffle_color=False, eps=(0.5,), seed=1):
    """A JAX aligned chunk of N envs on random numpy nets, with its configs,
    both packages' params and the reset states its keys deal."""
    jenv_cfg = jenv.EnvConfig(game=JGameConfig(players=players), eps_list=eps, max_len=MAX_LEN, sad=sad,
                              shuffle_color=shuffle_color)
    F, A = jenv_cfg.feature_size, jenv_cfg.game.num_actions
    jagent_cfg = jagent.AgentConfig(net=jnet.NetConfig(in_dim=F, hid_dim=HID, out_dim=A), vdn=vdn, gamma=0.99)
    tenv_cfg = tenv.EnvConfig(game=GameConfig(players=players), eps_list=eps, max_len=MAX_LEN, sad=sad,
                              shuffle_color=shuffle_color)
    tagent_cfg = tagent.AgentConfig(net=tnet.NetConfig(in_dim=F, hid_dim=HID, out_dim=A), vdn=vdn, gamma=0.99)
    jparams, tparams = agent_params(np_net(F, HID, A, 5, 2, seed), np_net(F, HID, A, 5, 2, seed + 50))
    keys = jax.random.split(jax.random.PRNGKey(seed), N)
    run = jax.jit(functools.partial(jrunner.run_episode_chunk, agent_cfg=jagent_cfg, env_cfg=jenv_cfg,
                                    num_steps=MAX_LEN))
    out = run(jparams, keys=keys, act_key=jax.random.PRNGKey(seed + 1))
    states = jax.vmap(lambda k: jenv.reset_state(jenv_cfg, k))(keys)
    return (jenv_cfg, jagent_cfg, jparams), (tenv_cfg, tagent_cfg, tparams), out, states


def assert_tree_equal(t, j, what):
    for f in j._fields:
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), err_msg=f"{what} {f}")


@pytest.mark.parametrize("players,vdn", [(2, True), (2, False), (3, False)])
def test_chunk_processing_matches_jax(players, vdn):
    (_, jagent_cfg, _), (_, tagent_cfg, _), out, _ = jax_chunk(players, vdn)
    tout = to_torch_tree(out, trunner.RolloutOutput)
    assert bool(tout.done[-1].all()) and float((tout.action != tout.greedy_a).float().mean()) > 0

    for t, j in zip(trunner._n_step_process(tout.reward, tout.done, 3, 0.99),
                    jrunner._n_step_process(out.reward, out.done, 3, 0.99)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    jep, tep = jrunner.chunk_to_episodes(out, jagent_cfg), trunner.chunk_to_episodes(tout, tagent_cfg)
    M, Pi = (N, players) if vdn else (N * players, 1)
    assert tuple(tep.priv_s.shape[:3]) == (M, MAX_LEN, Pi)
    assert_tree_equal(tep, jep, "episodes")
    for t, j in zip(trunner.rollout_priority_inputs(tout, tagent_cfg), jrunner.rollout_priority_inputs(out, jagent_cfg)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert_tree_equal(trunner.episodes_to_batch(tep), jrunner.episodes_to_batch(jep), "batch")


@pytest.mark.parametrize("shuffle_color", [False, True])
def test_run_episode_chunk_on_jax_decks_matches_jax(shuffle_color):
    """Greedy (eps 0) chunks on the decks and permutations the JAX keys
    dealt; records equal up to each game's first differing action, which
    must be a near tie."""
    (_, _, _), (tenv_cfg, tagent_cfg, tparams), out, states = jax_chunk(
        2, True, shuffle_color=shuffle_color, eps=(0.0,), seed=3 if shuffle_color else 2)
    color_perm = torch.from_numpy(np.asarray(states.color_perm).astype(np.int64))
    if shuffle_color:
        assert not bool((color_perm == torch.arange(5)).all())
    tout = trunner.run_episode_chunk(
        tparams, tagent_cfg, tenv_cfg, N, MAX_LEN, generator=torch.Generator().manual_seed(0),
        decks=torch.from_numpy(np.asarray(states.game.deck).astype(np.int64)), color_perm=color_perm,
        device="cpu")
    jout = to_torch_tree(out, trunner.RolloutOutput)
    T, P = MAX_LEN, 2
    # The port's q along its own trajectory: a zero-h0 sequence forward
    # reproduces the rollout's hiddens.
    _, _, q, _ = tnet.forward(tparams.online, tagent_cfg.net, tout.priv_s.reshape(T, N * P, -1),
                              tout.legal_move.reshape(T, N * P, -1), tout.action.reshape(T, N * P))
    q = torch.where(tout.legal_move.reshape(T, N * P, -1) > 0, q, -torch.inf).reshape(T, N, P, -1)
    top2 = q.topk(2, dim=-1).values
    near_tie = torch.isfinite(top2[..., 1]) & (top2[..., 0] - top2[..., 1] < TIE)  # [T, N, P]
    parted = 0
    for i in range(N):
        differ = (tout.action[:, i] != jout.action[:, i]).any(-1)
        t_end = int(differ.nonzero()[0]) if bool(differ.any()) else T
        if t_end < T:
            parted += 1
            seat = (tout.action[t_end, i] != jout.action[t_end, i]).nonzero()[0]
            assert bool(near_tie[t_end, i, seat].all()), f"game {i} step {t_end}: not a near tie"
        for f in ("priv_s", "legal_move", "own_hand", "action", "greedy_a", "reward", "done"):
            assert torch.equal(getattr(tout, f)[:t_end, i], getattr(jout, f)[:t_end, i]), f"game {i} {f}"
        np.testing.assert_allclose(tout.qa[:t_end, i].numpy(), jout.qa[:t_end, i].numpy(), atol=1e-5, rtol=0)
        if t_end == T:
            assert int(tout.last_score[i]) == int(jout.last_score[i])
    print(f"games parted at a near tie: {parted} of {N}")
    assert parted < N


@pytest.mark.parametrize("vdn", [True, False])
def test_compute_priority_matches_jax_and_the_rollout_priority(vdn):
    (_, jagent_cfg, jparams), (tenv_cfg, tagent_cfg, tparams), out, _ = jax_chunk(2, vdn)
    jbatch = jrunner.episodes_to_batch(jrunner.chunk_to_episodes(out, jagent_cfg))
    tbatch = trunner.episodes_to_batch(trunner.chunk_to_episodes(to_torch_tree(out, trunner.RolloutOutput),
                                                                 tagent_cfg))
    np.testing.assert_allclose(tagent.compute_priority(tparams, tagent_cfg, tbatch).numpy(),
                               np.asarray(jagent.compute_priority(jparams, jagent_cfg, jbatch)), rtol=1e-5, atol=0)

    # The JAX package's TestFastPriority, on the port's own chunk.
    tout = trunner.run_episode_chunk(tparams, tagent_cfg, tenv_cfg, 6, MAX_LEN,
                                     generator=torch.Generator().manual_seed(4), device="cpu")
    batch = trunner.episodes_to_batch(trunner.chunk_to_episodes(tout, tagent_cfg))
    slow = tagent.compute_priority(tparams, tagent_cfg, batch)
    fast = tagent.compute_priority_from_rollout(tparams, tagent_cfg, batch,
                                                *trunner.rollout_priority_inputs(tout, tagent_cfg))
    np.testing.assert_allclose(fast.numpy(), slow.numpy(), rtol=1e-5, atol=1e-5)


SMALL = dict(pred_weight=0.25, rnn_hid_dim=HID, max_len=MAX_LEN, num_envs=N, replay_buffer_size=64, batchsize=8,
             rollout_mode="aligned")


def setups(**kw):
    overrides = dict(SMALL, **kw)
    return (jlearner.make_setup(jconfig.make_config("sad_2p", **overrides)),
            tlearner.make_setup(tconfig.make_config("sad_2p", **overrides)))


def test_collect_chunk_matches_jax_on_its_decks(monkeypatch):
    """act_base_eps 0: both collect greedily on the decks the JAX env key
    deals."""
    jsetup, tsetup = setups(act_base_eps=0.0)
    jstate = jlearner.init_train_state(jsetup, jax.random.PRNGKey(0))
    assert jstate.actor is None
    np_params = jax.tree_util.tree_map(np.asarray, jstate.params)
    tparams = tagent.AgentParams(online=from_jax_params(np_params.online, "cpu"),
                                 target=from_jax_params(np_params.target, "cpu"))
    env_key = jax.random.PRNGKey(5)
    jep, jprio, jstats, _ = jax.jit(functools.partial(jlearner.collect_chunk, jsetup))(jstate.params, env_key)
    _, k_envs, _ = jax.random.split(env_key, 3)
    decks = jax.vmap(lambda k: jenv.reset_state(jsetup.env, k).game.deck)(jax.random.split(k_envs, N))
    run = trunner.run_episode_chunk
    monkeypatch.setattr(trunner, "run_episode_chunk", functools.partial(
        run, decks=torch.from_numpy(np.asarray(decks).astype(np.int64))))
    tep, tprio, tstats = tlearner.collect_chunk(tsetup, tparams, torch.Generator().manual_seed(0))
    assert tstats.keys() == jstats.keys()
    for k in jstats:
        assert float(tstats[k]) == float(jstats[k]), k
    assert float(tstats["chunk_frames"]) > N
    assert_tree_equal(tep, jep, "episodes")
    np.testing.assert_allclose(tprio.numpy(), np.asarray(jprio), rtol=1e-5, atol=0)


def test_collect_chunk_explore_ratio_counts_live_frames(monkeypatch):
    _, tsetup = setups(act_base_eps=0.5, num_eps=1)
    state = tlearner.init_train_state(tsetup, 1, "cpu")
    assert state.actor is None
    seen = []
    run = trunner.run_episode_chunk
    monkeypatch.setattr(trunner, "run_episode_chunk", lambda *a, **k: seen.append(run(*a, **k)) or seen[-1])
    _, _, stats = tlearner.collect_chunk(tsetup, state.params, state.env_gen)
    out = seen[0]
    live = (torch.cumsum(out.done.long(), 0) - out.done.long()) == 0  # [T, N]
    assert not bool(live.all())  # some envs ended before max_len
    deviated = (out.action != out.greedy_a) & live[..., None]
    expect = float(deviated.sum()) / (float(live.sum()) * 2)
    assert float(stats["explore_ratio"]) == pytest.approx(expect, rel=1e-6) and expect > 0


def test_aligned_collect_adds_every_episode_with_its_priority():
    _, tsetup = setups()
    state = tlearner.init_train_state(tsetup, 2, "cpu")
    state, stats = tlearner.collect_only(tsetup, state)
    assert int(state.replay.size) == int(state.replay.num_add) == N
    assert bool((state.replay.weight[:N] > 0).all()) and bool((state.replay.weight[N:] == 0).all())
    assert float(state.replay.seq_len[:N].sum()) == float(stats["chunk_frames"])


@pytest.mark.parametrize("method", ["vdn", "iql"])
def test_selfplay_runs_two_aligned_chunks_on_the_cpu(method, capsys, tmp_path):
    kw = dict(pred_weight=0.25) if method == "vdn" else {}
    cfg = tconfig.make_config(
        "sad_2p", method=method, rollout_mode="aligned", num_envs=8, batchsize=8, burn_in_frames=16,
        replay_buffer_size=64, epoch_len=4, num_update_per_chunk=2, num_epoch=3, num_eval_game=4, max_len=16,
        rnn_hid_dim=32, num_update_between_sync=3, eval_max_steps=100, num_eps=4, save_dir=str(tmp_path), **kw)
    out = selfplay.train(cfg, max_chunks=2, device="cpu")
    log = capsys.readouterr().out
    assert out["num_update"] == 4 and out["epoch"] == 0
    assert all(np.isfinite(v) for v in out["metrics"].values())
    assert "dropped_episodes" not in out["metrics"] and out["metrics"]["chunk_len"] <= 16
    assert "warming up replay buffer" in log and "eval score" in log


def test_an_aligned_train_state_round_trips(tmp_path):
    _, tsetup = setups(num_update_per_chunk=2)
    optimizer = tlearner.make_optimizer(tsetup.train)
    state = tlearner.init_train_state(tsetup, 3, "cpu")
    state, _ = tlearner.collect_only(tsetup, state)
    state, _ = tlearner.train_chunk(tsetup, optimizer, state)
    path = str(tmp_path / "latest.pkl")
    tckpt.save(path, tckpt.train_state_payload(state, dataclasses.asdict(tsetup.train)))
    back = tckpt.restore_train_state(tckpt.load(path), tlearner.init_train_state(tsetup, 9, "cpu"))
    assert back.actor is None and back.num_update == state.num_update == 2
    back = back._replace(replay=state.replay._replace(weight=state.replay.weight.clone()))
    idx = torch.tensor([0, 3, 3, 5, 1, 7, 2, 4])
    drawn = (torch.linspace(0.5, 1.0, 8), idx)
    s_a, m_a = tlearner.sgd_update(tsetup, optimizer, state, presampled=drawn)
    s_b, m_b = tlearner.sgd_update(tsetup, optimizer, back, presampled=drawn)
    for k in m_a:
        assert torch.equal(m_a[k], m_b[k]), k
    for a, b in zip(tlearner.param_leaves(s_a.params.online) + s_a.opt_state.mu,
                    tlearner.param_leaves(s_b.params.online) + s_b.opt_state.mu):
        assert torch.equal(a, b)
    assert torch.equal(s_a.replay.weight, s_b.replay.weight)
    for a, b in ((s_a.env_gen, s_b.env_gen), (s_a.sample_gen, s_b.sample_gen)):
        assert torch.equal(a.get_state(), b.get_state())
