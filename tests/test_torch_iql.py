"""IQL in the port (`method="iql"`, one replay item per player) against the
JAX package, on the CPU.

  * `continuous.split_players` on random assembled episodes equals the JAX
    one exactly (a reshape: env-major, then player);
  * one IQL sgd_update from the same params, replay and presampled batch
    (2 and 3 players, hidden 64, T = 12, 4 episodes) equals the JAX one:
    loss and grad_norm within 1e-5 relative, the new params within 1e-7 abs
    (one Adam step), the new replay weights within 1e-5 abs, as the VDN test
    of tests/test_torch_learner.py holds them;
  * a collect chunk writes num_envs x players items per chunk, each at
    Pi = 1, and `selfplay.train` runs two IQL chunks on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hanabi_sad_tpu.replay import prioritized as jrep
from hanabi_sad_tpu.rollout import continuous as jcont
from hanabi_sad_tpu.train import config as jconfig
from hanabi_sad_tpu.train import learner as jlearner
from hanabi_sad_tpu_torch.rollout import continuous as tcont
from hanabi_sad_tpu_torch.train import config as tconfig
from hanabi_sad_tpu_torch.train import learner as tlearner
from hanabi_sad_tpu_torch.train import selfplay
from hanabi_sad_tpu_torch.train.checkpoint import from_jax_params
from test_torch_learner import fill_replays


def random_episodes(M, T, P, NB, seed):
    rng = np.random.RandomState(seed)
    return dict(
        packed=rng.randint(0, 256, (M, T, P, NB)).astype(np.uint8),
        action=rng.randint(0, 21, (M, T, P)).astype(np.int32),
        greedy=rng.randint(0, 21, (M, T, P)).astype(np.int32),
        qa=rng.randn(M, T, P).astype(np.float32),
        tqa=rng.randn(M, T, P).astype(np.float32),
        reward=rng.randn(M, T).astype(np.float32),
        seq_len=rng.randint(1, T + 1, (M,)).astype(np.float32),
        valid=rng.rand(M) < 0.7,
        dropped=np.int32(2), score_sum=np.float32(17.0), num_completed=np.int32(5),
    )


@pytest.mark.parametrize("P", [2, 3, 5])
def test_split_players_matches_jax(P):
    ep = random_episodes(6, 7, P, 9, seed=P)
    j = jcont.split_players(jcont.AssembledEpisodes(**{k: jnp.asarray(v) for k, v in ep.items()}))
    t = tcont.split_players(tcont.AssembledEpisodes(**{k: torch.as_tensor(np.array(v)) for k, v in ep.items()}))
    for f in t._fields:
        a, b = getattr(t, f).numpy(), np.asarray(getattr(j, f))
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert t.packed.shape == (6 * P, 7, 1, 9) and t.reward.shape == (6 * P, 7)


SMALL = dict(rnn_hid_dim=64, max_len=12, replay_buffer_size=128, batchsize=4, num_envs=4)


@pytest.mark.parametrize("players", [2, 3])
def test_one_iql_sgd_update_with_a_presampled_batch_matches_jax(players):
    jsetup = jlearner.make_setup(jconfig.make_config("iql_2p", num_player=players, **SMALL))
    tsetup = tlearner.make_setup(tconfig.make_config("iql_2p", num_player=players, **SMALL))
    assert not tsetup.agent.vdn and tsetup.replay.num_player == 1 and tsetup.train.batchsize == 4
    assert tsetup.items_per_chunk == jsetup.items_per_chunk == 4 * players
    jstate = jlearner.init_train_state(jsetup, jax.random.PRNGKey(1))
    tstate = tlearner.init_train_state(tsetup, 0, "cpu")
    np_params = jax.tree_util.tree_map(np.asarray, jstate.params)
    tstate = tstate._replace(params=type(tstate.params)(
        online=from_jax_params(np_params.online, "cpu"), target=from_jax_params(np_params.target, "cpu")))
    jstate, tstate = fill_replays(jsetup, tsetup, jstate, tstate, seed=players)

    idx = np.asarray([5, 5, 11, 2], np.int32)
    is_w = np.asarray([0.5, 0.5, 1.0, 0.25], np.float32)
    jopt = jlearner.make_optimizer(jsetup.train)
    jstate2, jm = jax.jit(lambda s, pre: jlearner.sgd_update(jsetup, jopt, s, presampled=pre))(
        jstate, (jrep.gather_rows(jstate.replay, jnp.asarray(idx)), jnp.asarray(is_w), jnp.asarray(idx)))
    tstate2, tm = tlearner.sgd_update(
        tsetup, tlearner.make_optimizer(tsetup.train), tstate,
        presampled=(torch.from_numpy(is_w), torch.from_numpy(idx).long()))
    assert tm.keys() == jm.keys() == {"loss", "grad_norm", "rl_loss"}
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    for t, j in zip(tlearner.param_leaves(tstate2.params.online), jax.tree_util.tree_leaves(jstate2.params.online)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=1e-7, rtol=0)
    np.testing.assert_allclose(tstate2.replay.weight.numpy(), np.asarray(jstate2.replay.weight), atol=1e-5, rtol=0)


def test_iql_collect_writes_one_item_per_player():
    """A 3-player IQL collect chunk: the replay's items are per player
    ([T, 1, bytes] each), num_envs x slots x 3 slots in all, of which the
    valid ones are written."""
    cfg = tconfig.make_config("iql_2p", num_player=3, num_envs=6, max_len=20, rnn_hid_dim=32,
                              replay_buffer_size=512, num_eps=4)
    setup = tlearner.make_setup(cfg)
    state = tlearner.init_train_state(setup, 0, "cpu")
    state, stats = tlearner.collect_only(setup, state)
    assert tuple(state.replay.packed.shape[1:]) == (20, 1, setup.replay.bytes_per_step)
    assert int(state.replay.size) > 0 and int(state.replay.size) % 3 == 0
    # every finished episode gives 3 items of one length; a chunk finishes >= 1 episode per env
    assert int(state.replay.size) >= 3 * 6
    assert float(stats["chunk_frames"]) == float(state.replay.seq_len[: int(state.replay.size)].sum())


@pytest.mark.parametrize("players", [2, 3])
def test_iql_selfplay_trains_two_chunks_on_the_cpu(players, tmp_path):
    cfg, device = selfplay.parse_args([
        "--preset", "iql_2p", "--num_player", str(players), "--device", "cpu", "--num_envs", "8",
        "--batchsize", "8", "--burn_in_frames", "16", "--replay_buffer_size", "64", "--epoch_len", "4",
        "--num_update_per_chunk", "2", "--num_epoch", "2", "--num_eval_game", "4", "--max_len", "16",
        "--rnn_hid_dim", "32", "--num_eps", "4", "--save_dir", str(tmp_path)])
    assert cfg.method == "iql" and not cfg.sad and cfg.num_player == players
    out = selfplay.train(cfg, max_chunks=2, device=device)
    assert out["num_update"] == 4 and all(np.isfinite(v) for v in out["metrics"].values())
    assert "aux1" not in out["metrics"]
