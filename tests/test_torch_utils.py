"""The port's `utils/` helpers (`hanabi_sad_tpu_torch.utils`: belief, asserts,
helper) against the JAX package's, on the same numpy-made inputs.

  * `get_v1` and `check_v1` within 1e-6 of JAX's (the same float32 ops in
    the same order; 1e-6 leaves room for another summation order);
  * `v0_from_state` on a batch of states of random-legal JAX games, carried
    over by `torch_parity.port_env_state`, equal to `jax.vmap` of JAX's,
    exactly (the values are small integers);
  * `check_trajectory`, every assert raising and passing, `set_all_seeds`
    giving JAX's helper's `random` and `np.random` draws, and
    `generate_log_uniform` equal."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hanabi_sad_tpu.game import env as jenv
from hanabi_sad_tpu.game.config import GameConfig as JGameConfig
from hanabi_sad_tpu.utils import belief as jbelief
from hanabi_sad_tpu.utils import helper as jhelper
from hanabi_sad_tpu_torch.game.config import GameConfig, default_hand_size
from hanabi_sad_tpu_torch.utils import asserts, belief, generate_log_uniform, set_all_seeds
from torch_parity import port_env_state

BELIEF_TOL = 1e-6


def np_beliefs(seed, B=3, S=10):
    rng = np.random.RandomState(seed)
    counts = np.tile(np.tile([3, 2, 2, 2, 1], 5)[None], (B, 1)).astype(np.float32)
    counts -= (rng.rand(B, 25) < 0.2) * (counts > 0)
    mask = (rng.rand(B, S, 25) > 0.5).astype(np.float32)
    mask[..., 0] = 1.0
    return (mask * counts[:, None, :] * rng.rand(B, S, 25)).astype(np.float32), counts


@pytest.mark.parametrize("seed,max_count,weight", [(0, 100, 0.1), (1, 7, 0.3)])
def test_get_v1_matches_jax(seed, max_count, weight):
    v0, counts = np_beliefs(seed)
    jv1 = np.asarray(jbelief.get_v1(jnp.asarray(v0), jnp.asarray(counts), max_count, weight))
    tv1 = belief.get_v1(torch.from_numpy(v0), torch.from_numpy(counts), max_count, weight).numpy()
    assert np.abs(tv1 - jv1).max() <= BELIEF_TOL
    np.testing.assert_allclose(tv1.sum(-1), 1.0, atol=1e-4)
    assert (tv1[v0 == 0] < 1e-6).all()


def test_check_v1_matches_jax():
    v0, counts = np_beliefs(2)
    tv0, tcounts = torch.from_numpy(v0), torch.from_numpy(counts)
    v1 = belief.get_v1(tv0, tcounts)
    off = v1 + 1e-3
    for candidate in (v1, off):
        assert belief.check_v1(tv0, candidate, tcounts) == jbelief.check_v1(
            jnp.asarray(v0), jnp.asarray(candidate.numpy()), jnp.asarray(counts))
    assert belief.check_v1(tv0, v1, tcounts) and not belief.check_v1(tv0, off, tcounts)


@pytest.mark.parametrize("players,seed", [(2, 0), (3, 1)])
def test_v0_from_state_matches_jax_vmap(players, seed):
    """States of 16 random-legal JAX games after 0, 9, 23 and 41 steps; V0 of
    every seat of every env, exactly."""
    N, P = 16, players
    jcfg = jenv.EnvConfig(game=JGameConfig(players=P, hand_size=default_hand_size(P)), eps_list=(0.0,),
                          max_len=-1, sad=False)
    tgame = GameConfig(players=P, hand_size=default_hand_size(P))
    reset = jax.jit(jax.vmap(lambda k: jenv.reset_state(jcfg, k)))
    step = jax.jit(jax.vmap(lambda s, a: jenv.step(jcfg, s, a)[0]))
    legal = jax.jit(jax.vmap(lambda s: jenv.observe(jcfg, s)["legal_move"]))
    v0 = jax.jit(jax.vmap(lambda g, p: jbelief.v0_from_state(jcfg.game, g, p)))
    rng = np.random.RandomState(seed)
    jstate = reset(jax.random.split(jax.random.PRNGKey(seed), N))
    checked = 0
    for t in range(42):
        if t in (0, 9, 23, 41):
            tstate = port_env_state(jstate)
            for seat in range(P):
                player = (np.asarray(jstate.game.cur_player) + seat) % P
                want = np.asarray(v0(jstate.game, jnp.asarray(player, jnp.int32)))
                got = belief.v0_from_state(tgame, tstate.game, torch.from_numpy(player).long())
                assert got.shape == (N, tgame.hand_size, 25) and got.dtype == torch.float32
                np.testing.assert_array_equal(got.numpy(), want, err_msg=f"step {t} seat {seat}")
                checked += 1
        lm = np.asarray(legal(jstate))
        a = np.array([[rng.choice(np.flatnonzero(lm[i, p])) for p in range(P)] for i in range(N)], np.int32)
        jstate = step(jstate, {"a": jnp.asarray(a), "greedy_a": jnp.asarray(a)})
    assert checked == 4 * P


def test_check_trajectory():
    term = torch.tensor([0, 0, 0, 1, 1, 1], dtype=torch.float32)
    assert belief.check_trajectory(torch.zeros(6, 4), term) == 3
    assert jbelief.check_trajectory(jnp.zeros((6, 4)), jnp.asarray(term.numpy())) == 3
    with pytest.raises(AssertionError, match="suffix"):
        belief.check_trajectory(torch.zeros(3, 2), torch.tensor([1.0, 0.0, 1.0]))
    with pytest.raises(AssertionError, match="no terminal"):
        belief.check_trajectory(torch.zeros(3, 2), torch.zeros(3))


@pytest.mark.parametrize("fn,good,bad", [
    (asserts.assert_eq, (3, 3), (3, 4)),
    (asserts.assert_neq, (3, 4), (3, 3)),
    (asserts.assert_lt, (1, 2), (2, 2)),
    (asserts.assert_lteq, (2, 2), (3, 2)),
])
def test_scalar_asserts(fn, good, bad):
    fn(*good)
    with pytest.raises(AssertionError, match="expected"):
        fn(*bad)


def test_tensor_assert():
    a = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    asserts.assert_tensor_eq(a, a + 1e-7)
    asserts.assert_tensor_eq(a, a.numpy())
    with pytest.raises(AssertionError, match="max diff"):
        asserts.assert_tensor_eq(a, a + 1e-3)
    with pytest.raises(AssertionError, match="size mismatch"):
        asserts.assert_tensor_eq(a, a.t())
    asserts.assert_tensor_eq(a, a + 1e-3, eps=1e-2)


def test_tree_assert_over_the_ports_trees():
    from hanabi_sad_tpu_torch.agent.r2d2_agent import Hidden

    tree = {"b": [torch.zeros(2), torch.ones(3)], "a": Hidden(h=torch.zeros(1), c=torch.ones(1)), "n": None}
    same = {"a": Hidden(h=torch.zeros(1), c=torch.ones(1) + 1e-8), "b": [torch.zeros(2), torch.ones(3)], "n": None}
    asserts.assert_tree_close(tree, same)
    leaves, _ = asserts.tree_flatten(tree)
    assert len(leaves) == 4 and torch.equal(leaves[0], torch.zeros(1))  # dict keys in sorted order
    with pytest.raises(AssertionError, match="structure"):
        asserts.assert_tree_close(tree, {**same, "b": [torch.zeros(2)]})
    with pytest.raises(AssertionError, match="structure"):
        asserts.assert_tree_close(tree, {**same, "a": (torch.zeros(1), torch.ones(1))})
    with pytest.raises(AssertionError, match="max diff"):
        asserts.assert_tree_close(tree, {**same, "b": [torch.zeros(2), torch.ones(3) * 2]})


def test_zero_grad_assert():
    w = torch.ones(3, requires_grad=True)
    grads = torch.autograd.grad((w * 0).sum(), [w])
    asserts.assert_zero_grad({"w": grads[0], "unreached": None})
    with pytest.raises(AssertionError, match="nonzero grad"):
        asserts.assert_zero_grad([torch.zeros(2), torch.tensor([0.0, 1e-30])])


def test_set_all_seeds_draws_as_the_jax_helper():
    draws = []
    for seeder in (jhelper.set_all_seeds, set_all_seeds):
        seeder(17)
        draws.append((random.random(), np.random.rand(3).tolist(), torch.rand(2).tolist()))
    assert draws[0] == draws[1]
    torch.manual_seed(17 + 2)
    assert torch.rand(2).tolist() == draws[1][2]


def test_generate_log_uniform_equal():
    assert generate_log_uniform(1e-4, 1e-2, 5) == jhelper.generate_log_uniform(1e-4, 1e-2, 5)
    vals = generate_log_uniform(0.5, 8.0, 5)
    np.testing.assert_allclose(vals, [0.5, 1.0, 2.0, 4.0, 8.0], rtol=1e-12)
