"""The port's game and env (`hanabi_sad_tpu_torch.game`) against the JAX env
and the native C++ oracle.

Both envs are dealt the same decks, made with numpy from a seed, and play
random-legal moves drawn by numpy from the JAX legal mask, 2 players with
SAD (and 3-5 players, with and without SAD, at the default hand sizes).
priv_s (838 at 2 players), legal_move (21), own_hand, reward, done and score
must be exactly equal at every step; so must the native engine's
observation, legal mask, own hand and SAD channel while a game is live."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hanabi_sad_tpu.game import config as jconfig
from hanabi_sad_tpu.game import env as jenv
from hanabi_sad_tpu.game import state as jstate_mod
from hanabi_sad_tpu.game.config import GameConfig as JGameConfig
from hanabi_sad_tpu.native import NativeGame, available
from hanabi_sad_tpu_torch.game import env as tenv
from hanabi_sad_tpu_torch.game import moves as tmoves
from hanabi_sad_tpu_torch.game.config import GameConfig, default_hand_size
from hanabi_sad_tpu_torch.game.state import (
    card_counts,
    full_deck,
    hand_sizes,
    new_game,
    score,
    shuffled_decks,
)

N = 8


def random_decks(seed, n=N):
    rng = np.random.RandomState(seed)
    deck = np.repeat(np.arange(25), np.tile([3, 2, 2, 2, 1], 5))
    return np.stack([rng.permutation(deck) for _ in range(n)]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def jax_env(max_len, players=2, sad=True):
    cfg = jenv.EnvConfig(game=JGameConfig(players=players, hand_size=default_hand_size(players)),
                         max_len=max_len, sad=sad)
    step = jax.jit(jax.vmap(lambda s, a: jenv.step(cfg, s, a)))
    observe = jax.jit(jax.vmap(lambda s: jenv.observe(cfg, s)))
    return cfg, step, observe


def jax_reset(cfg, observe, decks):
    keys = jax.random.split(jax.random.PRNGKey(0), decks.shape[0])
    state = jax.vmap(lambda k: jenv.reset_state(cfg, k))(keys)
    P, H = cfg.game.players, cfg.game.hand_size
    game = state.game._replace(
        deck=jnp.asarray(decks), hands=jnp.asarray(decks[:, : P * H].reshape(-1, P, H))
    )
    state = state._replace(game=game)
    return state, observe(state)


def assert_obs_equal(jobs, tobs, where):
    for k in ("priv_s", "legal_move", "own_hand", "eps"):
        np.testing.assert_array_equal(np.asarray(jobs[k]), tobs[k].numpy(), err_msg=f"{where} {k}")


@pytest.mark.parametrize("seed,max_len", [(0, -1), (1, -1), (2, 80), (3, 20)])
def test_random_playout_parity(seed, max_len):
    tobs = playout(seed, max_len, players=2, sad=True)
    assert tobs["priv_s"].shape == (N, 2, 838) and tobs["legal_move"].shape == (N, 2, 21)


@pytest.mark.parametrize("players,sad,seed,max_len", [
    (3, True, 10, -1), (3, False, 11, 40), (4, True, 12, -1), (4, False, 13, -1), (5, True, 14, 60),
    (5, False, 15, -1),
])
def test_random_playout_parity_at_3_to_5_players(players, sad, seed, max_len):
    """Whole games at 3-5 players, the default hand sizes (5, 4, 4), with and
    without SAD, against the JAX env and the native engine on the same decks:
    exactly equal at every step, as at 2 players."""
    tobs = playout(seed, max_len, players=players, sad=sad)
    cfg = GameConfig(players=players, hand_size=default_hand_size(players))
    assert tobs["priv_s"].shape == (N, players, cfg.feature_size(sad))
    assert tobs["legal_move"].shape == (N, players, cfg.num_actions)


def playout(seed, max_len, players, sad):
    """Random-legal play of N games on injected decks in the port, the JAX
    env and (if built) the native engine, compared at every step; returns
    the port's last observation."""
    P, hand = players, default_hand_size(players)
    decks = random_decks(seed)
    jcfg, jstep, jobserve = jax_env(max_len, P, sad)
    tcfg = tenv.EnvConfig(game=GameConfig(players=P, hand_size=hand), max_len=max_len, sad=sad)
    jstate, jobs = jax_reset(jcfg, jobserve, decks)
    tstate, tobs = tenv.reset(tcfg, N, decks=torch.from_numpy(decks), device="cpu")
    natives = [NativeGame(d, players=P, hand_size=hand) for d in decks] if available() else None
    assert_obs_equal(jobs, tobs, "reset")
    rng = np.random.RandomState(1000 + seed)

    for step_idx in range(200):
        if bool(np.asarray(jstate.done).all()):
            break
        legal = np.asarray(jobs["legal_move"])
        cur = np.asarray(jstate.game.cur_player)
        a = np.zeros((N, P), np.int32)
        g = np.zeros((N, P), np.int32)
        for i in range(N):
            choices = np.where(legal[i, cur[i]] > 0)[0]
            a[i] = rng.choice(choices)
            g[i] = rng.choice(choices)
        was_done = np.asarray(jstate.done)
        channels = None
        if natives is not None:
            channels = [
                [natives[i].greedy_channel(int(g[i, 0]), p) for p in range(P)]
                if not was_done[i] else None
                for i in range(N)
            ]

        jstate, jobs, jrew, jdone = jstep(jstate, {"a": jnp.asarray(a), "greedy_a": jnp.asarray(g)})
        tstate, tobs, trew, tdone = tenv.step(
            tcfg, tstate, {"a": torch.from_numpy(a).long(), "greedy_a": torch.from_numpy(g).long()}
        )
        where = f"seed {seed} step {step_idx}"
        assert_obs_equal(jobs, tobs, where)
        np.testing.assert_array_equal(np.asarray(jrew), trew.numpy(), err_msg=f"{where} reward")
        np.testing.assert_array_equal(np.asarray(jdone), tdone.numpy(), err_msg=f"{where} done")
        np.testing.assert_array_equal(
            np.asarray(jstate.last_score), tstate.last_score.numpy(), err_msg=f"{where} last_score"
        )
        np.testing.assert_array_equal(
            np.asarray(jax.vmap(jenv.score)(jstate.game)), score(tstate.game).numpy(),
            err_msg=f"{where} score",
        )

        if natives is None:
            continue
        for i in range(N):
            if was_done[i]:
                continue
            nreward = natives[i].step(int(a[i, 0]))
            if max_len <= 0 or step_idx + 1 < max_len:
                assert float(trew[i]) == nreward, f"{where} env {i} native reward"
            for p in range(P):
                obs = tobs["priv_s"][i, p].numpy()
                base = natives[i].obs_dim
                np.testing.assert_array_equal(obs[:base], natives[i].encode(p), err_msg=f"{where} native obs")
                if sad:
                    np.testing.assert_array_equal(obs[base:], channels[i][p], err_msg=f"{where} native sad")
                else:
                    assert obs.shape[0] == base
                np.testing.assert_array_equal(
                    tobs["legal_move"][i, p].numpy().astype(bool),
                    natives[i].legal_moves(p).astype(bool), err_msg=f"{where} native legal",
                )
                np.testing.assert_array_equal(
                    tobs["own_hand"][i, p].numpy(), natives[i].own_hand(p), err_msg=f"{where} native own_hand"
                )
            assert int(score(tstate.game)[i]) == natives[i].score
    assert bool(tstate.done.all()), "games did not end within 200 steps"
    return tobs


def test_uid_round_trip_and_legal_shape():
    cfg = GameConfig(players=2)
    uid = torch.arange(cfg.num_actions)
    np.testing.assert_array_equal(tmoves.encode_uid(cfg, tmoves.decode_uid(cfg, uid)).numpy(), uid.numpy())
    tstate, _ = tenv.reset(tenv.EnvConfig(sad=True), 3, decks=torch.from_numpy(random_decks(5, 3)), device="cpu")
    legal = tmoves.legal_moves_all(cfg, tstate.game)
    assert legal.shape == (3, 2, 21)
    # Player 1 is not to move: only the no-op is legal for it.
    assert legal[:, 1].sum().item() == 3 and legal[:, 1, cfg.no_op_uid].all()


def test_shuffled_decks_are_permutations_of_the_full_deck():
    cfg = GameConfig(players=2)
    decks = shuffled_decks(cfg, 16, torch.Generator().manual_seed(3))
    ref = np.sort(full_deck(cfg).numpy())
    for d in decks.numpy():
        np.testing.assert_array_equal(np.sort(d), ref)
    assert len({tuple(d) for d in decks.numpy()}) == 16


@pytest.mark.parametrize("players", [2, 3, 4, 5])
def test_config_and_state_helpers_match_jax(players):
    hand = default_hand_size(players)
    assert hand == jconfig.default_hand_size(players)
    cfg, jcfg = GameConfig(players=players, hand_size=hand), JGameConfig(players=players, hand_size=hand)
    for name in ("num_actions", "obs_dim", "max_moves", "hand_feature_size"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    assert cfg.feature_size(True) == jcfg.feature_size(True)
    np.testing.assert_array_equal(card_counts(cfg).numpy(), np.asarray(jstate_mod.card_counts(jcfg)))
    np.testing.assert_array_equal(full_deck(cfg).numpy(), np.asarray(jstate_mod.full_deck(jcfg)))
    game = new_game(cfg, 3, generator=torch.Generator().manual_seed(players), device="cpu")
    assert hand_sizes(game).tolist() == [[hand] * players] * 3
    assert score(game).tolist() == [0, 0, 0] and game.life.tolist() == [3, 3, 3]
