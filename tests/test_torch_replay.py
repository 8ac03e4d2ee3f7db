"""The port's replay (`hanabi_sad_tpu_torch.replay`, `ops.gather_unpack`)
against the JAX package's, on the same numpy-made inputs.

Small sizes: capacity 64, T = 12, Pi = 2, obs_dim 40 (76 bits, 10 bytes a
step). Bit packing, the gather + unpack (kernel B3's plain version), the
ring writes, the indices and the unpacked batches must be exactly equal;
IS weights agree to 1e-6 relative (float32 powers of the same numbers).
Kernel B3 itself runs only on a CUDA card (tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hanabi_sad_tpu.ops.experimental import pallas_replay
from hanabi_sad_tpu.replay import bitpack as jbitpack
from hanabi_sad_tpu.replay import prioritized as jrep
from hanabi_sad_tpu_torch.ops.gather_unpack import gather_unpack, gather_unpack_kernel, gather_unpack_plain
from hanabi_sad_tpu_torch.replay import bitpack as tbitpack
from hanabi_sad_tpu_torch.replay import prioritized as trep

CAP, T, PI = 64, 12, 2
JCFG = jrep.ReplayConfig(capacity=CAP, seq_len=T, num_player=PI, obs_dim=40, num_actions=21)
TCFG = trep.ReplayConfig(capacity=CAP, seq_len=T, num_player=PI, obs_dim=40, num_actions=21)


def episodes(M, seed):
    rng = np.random.RandomState(seed)
    bits = (rng.rand(M, T, PI, JCFG.bits_per_step) < 0.3).astype(np.float32)
    return {
        "packed": np.array(jbitpack.pack_bits(jnp.asarray(bits))),
        "action": rng.randint(0, 21, (M, T, PI)).astype(np.int32),
        "reward": rng.randn(M, T).astype(np.float32),
        "bootstrap": (rng.rand(M, T) < 0.8).astype(np.float32),
        "seq_len": rng.randint(1, T + 1, (M,)).astype(np.float32),
        "priority": rng.uniform(0.05, 2.0, (M,)).astype(np.float32),
        "valid": rng.rand(M) < 0.7,
    }


def add_both(jstate, tstate, ep, use_valid):
    args = [ep[k] for k in ("packed", "action", "reward", "bootstrap", "seq_len", "priority")]
    valid = ep["valid"] if use_valid else None
    jstate = jrep.add_packed(
        jstate, JCFG, *map(jnp.asarray, args), valid=None if valid is None else jnp.asarray(valid)
    )
    tstate = trep.add_packed(
        tstate, TCFG, *map(torch.from_numpy, args), valid=None if valid is None else torch.from_numpy(valid)
    )
    return jstate, tstate


def filled(seed=0):
    jstate, tstate = jrep.init_replay(JCFG), trep.init_replay(TCFG, "cpu")
    for i, M in enumerate((24, 30, 40)):  # the third add wraps the ring
        jstate, tstate = add_both(jstate, tstate, episodes(M, seed + i), use_valid=True)
    return jstate, tstate


@pytest.mark.parametrize("n_bits", [1, 8, 76, 874])
def test_bitpack_round_trip_matches_jax(n_bits):
    rng = np.random.RandomState(n_bits)
    bits = (rng.rand(3, 5, n_bits) < 0.5).astype(np.float32)
    t_packed = tbitpack.pack_bits(torch.from_numpy(bits))
    j_packed = jbitpack.pack_bits(jnp.asarray(bits))
    assert tbitpack.packed_size(n_bits) == jbitpack.packed_size(n_bits)
    np.testing.assert_array_equal(t_packed.numpy(), np.asarray(j_packed))
    np.testing.assert_array_equal(tbitpack.unpack_bits(t_packed, n_bits).numpy(), bits)


def test_gather_unpack_plain_matches_pallas_and_unpack():
    rng = np.random.RandomState(0)
    cap, nbits = 32, 880
    bits = (rng.rand(cap, 10, 2, nbits) > 0.5).astype(np.float32)
    packed = np.array(jbitpack.pack_bits(jnp.asarray(bits)))
    idx = np.asarray([3, 17, 3, 31, 0, 17], np.int32)  # duplicates included
    ref = np.asarray(pallas_replay.gather_unpack_pallas(jnp.asarray(packed), jnp.asarray(idx), interpret=True))
    out = gather_unpack(torch.from_numpy(packed), torch.from_numpy(idx).long())
    assert out.shape == (6, 10, 2, nbits) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jbitpack.unpack_bits(jnp.asarray(packed), nbits))[idx])
    with pytest.raises(ValueError, match="int64"):
        gather_unpack(torch.from_numpy(packed), torch.from_numpy(idx))


def test_gather_unpack_clamps_indices_and_cpu_launches_nothing():
    """Out-of-range indices read as in JAX: -3 counts from the end (episode
    2 of 5), 9 is clamped to 4."""
    packed = torch.from_numpy(np.random.RandomState(1).randint(0, 256, (5, 3, 1, 4)).astype(np.uint8))
    before = gather_unpack_kernel.launches
    out = gather_unpack(packed, torch.tensor([-3, 0, 4, 9]))
    ref = gather_unpack_plain(packed, torch.tensor([2, 0, 4, 4]))
    assert torch.equal(out, ref)
    assert gather_unpack_kernel.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        gather_unpack_kernel(packed, torch.tensor([0]))


OUT_OF_RANGE = [-CAP - 2, -CAP, -1, 0, CAP - 1, CAP, CAP + 3]


def test_gather_unpack_plain_indexes_like_jnp():
    """Indices beyond the buffer at both ends, and negative ones inside it,
    read the rows that jnp indexing of the same numpy buffer reads."""
    rng = np.random.RandomState(2)
    packed = rng.randint(0, 256, (CAP, 3, 2, 5)).astype(np.uint8)
    idx = np.asarray(OUT_OF_RANGE, np.int64)
    ref = np.asarray(jbitpack.unpack_bits(jnp.asarray(packed)[jnp.asarray(idx)], 40))
    out = gather_unpack_plain(torch.from_numpy(packed), torch.from_numpy(idx))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_gather_rows_indexes_like_jax():
    jstate, tstate = filled()
    idx = np.asarray(OUT_OF_RANGE, np.int32)
    jrows = jrep.gather_rows(jstate, jnp.asarray(idx))
    trows = trep.gather_rows(tstate, torch.from_numpy(idx).long())
    for f in jrows._fields:
        np.testing.assert_array_equal(getattr(trows, f).numpy(), np.asarray(getattr(jrows, f)), err_msg=f)


@pytest.mark.parametrize("use_valid", [False, True])
def test_add_packed_matches_jax(use_valid):
    jstate, tstate = jrep.init_replay(JCFG), trep.init_replay(TCFG, "cpu")
    for i, M in enumerate((24, 30, 40)):
        ep = episodes(M, 10 + i)
        jstate, tstate = add_both(jstate, tstate, ep, use_valid)
    for f in ("write_ptr", "size", "num_add"):
        assert int(getattr(tstate, f)) == int(getattr(jstate, f)), f
    np.testing.assert_allclose(tstate.weight.numpy(), np.asarray(jstate.weight), rtol=1e-6, atol=0)
    # Invalid items all land on one scratch slot (weight 0) in unspecified
    # order; every other slot is equal.
    real = np.asarray(jstate.weight) > 0
    for f in ("packed", "action", "reward", "bootstrap", "seq_len"):
        np.testing.assert_array_equal(getattr(tstate, f).numpy()[real], np.asarray(getattr(jstate, f))[real], f)


def test_sample_indices_with_jax_uniforms_match():
    jstate, tstate = filled()
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        j_idx, j_isw = jrep.sample_indices(jstate, JCFG, key, 16)
        u = np.array(jax.random.uniform(key, (16,)))
        t_idx, t_isw = trep.sample_indices(tstate, TCFG, 16, uniforms=torch.from_numpy(u))
        np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
        np.testing.assert_allclose(t_isw.numpy(), np.asarray(j_isw), rtol=1e-6, atol=0)
        assert float(tstate.weight[t_idx].min()) > 0  # never an empty or invalid slot


def test_sample_indices_from_a_generator_is_stratified():
    _, tstate = filled()
    gen = torch.Generator().manual_seed(0)
    idx, is_w = trep.sample_indices(tstate, TCFG, 8, generator=gen)
    assert idx.shape == (8,) and idx.dtype == torch.int64
    assert bool((idx[1:] >= idx[:-1]).all())  # one draw per increasing segment
    assert float(is_w.max()) == 1.0 and float(is_w.min()) > 0


def test_rows_to_batch_and_sample_match_jax():
    jstate, tstate = filled()
    idx = np.asarray([5, 5, 0, 63, 17, 40], np.int32)
    jbatch = jrep.rows_to_batch(JCFG, jrep.gather_rows(jstate, jnp.asarray(idx)))
    tbatch = trep.rows_to_batch(TCFG, trep.gather_rows(tstate, torch.from_numpy(idx).long()))
    key = jax.random.PRNGKey(7)
    js_batch, js_isw, js_idx = jrep.sample(jstate, JCFG, key, 6)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (6,))))
    ts_batch, ts_isw, ts_idx = trep.sample(tstate, TCFG, 6, uniforms=u)
    np.testing.assert_array_equal(ts_idx.numpy(), np.asarray(js_idx))
    np.testing.assert_allclose(ts_isw.numpy(), np.asarray(js_isw), rtol=1e-6, atol=0)
    for (tb, jb) in ((tbatch, jbatch), (ts_batch, js_batch)):
        for f in jb._fields:
            t, j = getattr(tb, f), np.asarray(getattr(jb, f))
            assert tuple(t.shape) == j.shape, f
            np.testing.assert_array_equal(t.numpy(), j, err_msg=f)


def test_update_priority_matches_jax():
    jstate, tstate = filled()
    idx = np.asarray([3, 3, 9, 50], np.int32)
    prio = np.asarray([0.5, 0.5, 1.7, 0.01], np.float32)
    jstate = jrep.update_priority(jstate, JCFG, jnp.asarray(idx), jnp.asarray(prio))
    tstate = trep.update_priority(tstate, TCFG, torch.from_numpy(idx).long(), torch.from_numpy(prio))
    np.testing.assert_allclose(tstate.weight.numpy(), np.asarray(jstate.weight), rtol=1e-6, atol=0)
