"""The port's replay (`hanabi_sad_tpu_torch.replay`, `ops.gather_unpack`,
`ops.sample_batch`)
against the JAX package's, on the same numpy-made inputs.

Small sizes: capacity 64, T = 12, Pi = 2, obs_dim 40 (76 bits, 10 bytes a
step). Bit packing, the gather + unpack (kernel B3's plain version), the
ring writes, the indices and the unpacked batches must be exactly equal;
IS weights agree to 1e-6 relative (float32 powers of the same numbers).
Kernel B3 itself runs only on a CUDA card (tests/test_torch_cuda.py); its
plain version is held against the JAX package in
tests/test_torch_sample_batch.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hanabi_sad_tpu.ops.experimental import pallas_replay
from hanabi_sad_tpu.replay import bitpack as jbitpack
from hanabi_sad_tpu.replay import prioritized as jrep
from hanabi_sad_tpu_torch.ops.gather_unpack import gather_unpack_plain
from hanabi_sad_tpu_torch.ops.sample_batch import sample_batch, sample_batch_kernel
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
    out = gather_unpack_plain(torch.from_numpy(packed), torch.from_numpy(idx).long())
    assert out.shape == (6, 10, 2, nbits) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jbitpack.unpack_bits(jnp.asarray(packed), nbits))[idx])
    with pytest.raises(ValueError, match="int64"):
        gather_unpack_plain(torch.from_numpy(packed), torch.from_numpy(idx))


def test_gather_unpack_clamps_indices_and_cpu_launches_nothing():
    """Out-of-range indices read as in JAX: -3 counts from the end (episode
    2 of 5), 9 is clamped to 4. B3 (`sample_batch`) on CPU tensors runs its
    plain version and launches nothing; its kernel refuses CPU tensors."""
    rng = np.random.RandomState(1)
    packed = torch.from_numpy(rng.randint(0, 256, (5, 3, 1, 4)).astype(np.uint8))
    out = gather_unpack_plain(packed, torch.tensor([-3, 0, 4, 9]))
    ref = gather_unpack_plain(packed, torch.tensor([2, 0, 4, 4]))
    assert torch.equal(out, ref)
    fields = (packed, torch.from_numpy(rng.randint(0, 21, (5, 3, 1))), torch.randn(5, 3), torch.rand(5, 3),
              torch.tensor([1.0, 2.0, 3.0, 3.0, 2.0]))
    sizes = dict(obs_dim=10, num_actions=5, hand_size=5)
    before = sample_batch_kernel.launches
    batch = sample_batch(*fields, torch.tensor([-3, 0, 4, 9]), **sizes)
    again = sample_batch(*fields, torch.tensor([2, 0, 4, 4]), **sizes)
    assert all(torch.equal(a, b) for a, b in zip(batch, again))
    assert sample_batch_kernel.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        sample_batch_kernel(*fields, torch.tensor([0]), **sizes)


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


def test_add_matches_jax():
    """Unpacked episodes through both packages' add: every ring field equal."""
    jstate, tstate = jrep.init_replay(JCFG), trep.init_replay(TCFG, "cpu")
    rng = np.random.RandomState(5)
    for M in (24, 30, 40):
        fields = {
            "priv_s": (rng.rand(M, T, PI, 40) < 0.3).astype(np.float32),
            "legal_move": (rng.rand(M, T, PI, 21) < 0.5).astype(np.float32),
            "own_hand": (rng.rand(M, T, PI, 15) < 0.3).astype(np.float32),
            "action": rng.randint(0, 21, (M, T, PI)).astype(np.int32),
            "reward": rng.randn(M, T).astype(np.float32),
            "bootstrap": (rng.rand(M, T) < 0.8).astype(np.float32),
            "seq_len": rng.randint(1, T + 1, (M,)).astype(np.float32),
        }
        prio = rng.uniform(0.05, 2.0, (M,)).astype(np.float32)
        jstate = jrep.add(jstate, JCFG, jrep.EpisodeBatch(**{k: jnp.asarray(v) for k, v in fields.items()}),
                          jnp.asarray(prio))
        tep = trep.EpisodeBatch(**{k: torch.from_numpy(v.astype(np.int64) if k == "action" else v)
                                   for k, v in fields.items()})
        tstate = trep.add(tstate, TCFG, tep, torch.from_numpy(prio))
    for f in jstate._fields:
        if f == "weight":
            np.testing.assert_allclose(tstate.weight.numpy(), np.asarray(jstate.weight), rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(getattr(tstate, f).numpy(), np.asarray(getattr(jstate, f)), err_msg=f)


def test_sample_indices_rows_with_jax_keys_match():
    """The [U, B] path: one prefix sum, each row its own stratified draw
    from its key's uniforms, IS weights normalised per row."""
    jstate, tstate = filled()
    keys = jax.random.split(jax.random.PRNGKey(11), 5)
    j_idx, j_isw = jrep.sample_indices(jstate, JCFG, keys, 16)
    u = np.stack([np.array(jax.random.uniform(k, (16,))) for k in keys])
    t_idx, t_isw = trep.sample_indices(tstate, TCFG, 16, uniforms=torch.from_numpy(u))
    assert t_idx.shape == t_isw.shape == (5, 16)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(t_isw.numpy(), np.asarray(j_isw), rtol=1e-6, atol=0)
    assert (t_isw.max(dim=1).values == 1.0).all() and len(set(t_isw.min(dim=1).values.tolist())) > 1
    # Each row is what a one-batch call draws; the CPU's vector powers over
    # [5, 16] and [16] elements may round the last bit apart.
    for row in range(5):
        r_idx, r_isw = trep.sample_indices(tstate, TCFG, 16, uniforms=torch.from_numpy(u[row]))
        assert torch.equal(r_idx, t_idx[row])
        np.testing.assert_allclose(r_isw.numpy(), t_isw[row].numpy(), rtol=1e-6, atol=0)


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


@pytest.mark.parametrize("case", ["edges", "all_dropped", "duplicates_with_dropped"])
def test_update_priority_indexes_like_jnp(case):
    """Queue C item 5: indices read as JAX's `weight.at[idx].set` reads them,
    against `jnp` at idx in {-cap-2, -cap, -1, 0, cap-1, cap, cap+3}: one in
    [-cap, -1] counts from the end, the write of one outside [-cap, cap) is
    dropped (no raise on the CPU). Within 1e-6 relative of JAX's weights
    (`pow` of another library, as in test_update_priority_matches_jax), and
    every slot that JAX leaves alone keeps the port's own bits."""
    idx = {"edges": [-CAP - 2, -CAP, -1, 0, CAP - 1, CAP, CAP + 3],
           "all_dropped": [CAP, -CAP - 1, CAP + 7],
           "duplicates_with_dropped": [4, CAP, 4, -CAP - 5, 9]}[case]
    idx = np.asarray(idx, np.int32)
    prio = np.random.RandomState(len(idx)).uniform(0.1, 2.0, idx.shape).astype(np.float32)
    if case == "duplicates_with_dropped":
        prio[2] = prio[0]  # duplicate rows of a batch carry the same priority
    jstate, tstate = filled()
    before = tstate.weight.clone()
    jstate = jrep.update_priority(jstate, JCFG, jnp.asarray(idx), jnp.asarray(prio))
    tstate = trep.update_priority(tstate, TCFG, torch.from_numpy(idx).long(), torch.from_numpy(prio))
    np.testing.assert_allclose(tstate.weight.numpy(), np.asarray(jstate.weight), rtol=1e-6, atol=0)
    assert tstate.weight.shape == (CAP,)
    written = {int(i) % CAP for i in idx if -CAP <= i < CAP}
    untouched = [j for j in range(CAP) if j not in written]
    assert torch.equal(tstate.weight[untouched], before[untouched])
    if case == "all_dropped":
        assert torch.equal(tstate.weight, before)
