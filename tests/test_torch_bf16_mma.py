"""The arithmetic that the bfloat16 tensor-core kernels rest on, on the CPU.

B2's bfloat16 backward kernel (`csrc/lstm_bf16.cu`) takes its product dG .
W_hh^T, dG float32 and W_hh bfloat16, on the tensor cores, which multiply
bfloat16 values: it splits each dG value into bfloat16 terms hi + mid + lo
(`ops/lstm_seq.py:split_bf16` is the split in PyTorch) and sums the terms'
products in float32. These tests pin the premises of that design on numpy-made
inputs: the split rounds as JAX's bfloat16 cast does; three terms give a
float32 value back exactly; their products summed in float32 lie no further
from float64 than the plain float32 product at the learner's K = 2048 on the
flagship checkpoint's W_hh (two terms are reported, not asserted); and k-step
sums rounded to nearest carry no bias where sums cut toward zero, as the
tensor core cuts them, do (why `csrc/lstm_mma.cuh:mma_bf16_rn` exists)."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hanabi_sad_tpu_torch.ops.lstm_seq import split_bf16
from hanabi_sad_tpu_torch.tools import loaders

FLAGSHIP = str(Path(__file__).resolve().parents[1] / "docs/runs/sad_aux_r4_soup10.pkl")
K, ROWS = 2048, 128  # the backward's product at the learner shape: [B, 4H] . [4H, H]


@pytest.fixture(scope="module")
def flagship_w_hh():
    """The flagship checkpoint's W_hh of both layers, rounded to bfloat16 as
    the bf16 route uses them, as float32 [H, 4H]."""
    lstm = loaders.load_any(FLAGSHIP, device="cpu").params.online.lstm
    return [p["w_hh"].bfloat16().float() for p in lstm]


def dg_like(seed, rows=ROWS, k=K):
    """float32 values spread over many binades, as dG's are."""
    rng = np.random.RandomState(seed)
    return torch.from_numpy((rng.randn(rows, k) * np.exp(rng.uniform(-8.0, 2.0, (rows, k)))).astype(np.float32))


@pytest.mark.parametrize("scale", [1e-30, 1e-6, 1.0, 1e6, 1e30])
def test_three_terms_give_float32_back_exactly(scale):
    x = torch.from_numpy((scale * np.random.RandomState(0).randn(4096)).astype(np.float32))
    terms = split_bf16(x, 3)
    assert all(t.dtype == torch.bfloat16 for t in terms)
    assert torch.equal(sum(t.double() for t in terms), x.double())
    # each remainder is exact: the terms shrink by at least 2^8
    for big, small in zip(terms, terms[1:]):
        nz = big != 0
        assert bool((small.float()[nz].abs() <= big.float()[nz].abs() * 2.0 ** -8).all())


def test_two_terms_hold_16_bits():
    x = dg_like(1)
    two = split_bf16(x, 2)
    rest = (x.double() - sum(t.double() for t in two)).abs()
    assert bool((rest <= x.double().abs() * 2.0 ** -16).all())
    assert float(rest.max()) > 0.0  # and not all 24


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_rounds_as_jax_casts(seed):
    """Each term is the nearest-even bfloat16 of what the terms before it
    left, as `jnp.asarray(x).astype(jnp.bfloat16)` rounds."""
    x = dg_like(seed, rows=16, k=256).numpy()
    rest = jnp.asarray(x)
    for term in split_bf16(torch.from_numpy(x), 3):
        jterm = rest.astype(jnp.bfloat16)
        assert np.array_equal(term.float().numpy(), np.asarray(jterm.astype(jnp.float32)))
        rest = rest - jterm.astype(jnp.float32)


def split_product(dg, w, terms):
    """dG . W_hh^T as the terms' products (exact in float32: 8 x 8 significant
    bits), each summed in float32, added smallest first."""
    parts = [t.float() @ w.t() for t in split_bf16(dg, terms)]
    out = parts[-1]
    for p in reversed(parts[:-1]):
        out = p + out
    return out


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("seed", [0, 1])
def test_three_term_product_no_further_from_float64_than_float32(flagship_w_hh, layer, seed):
    """At K = 2048 on the flagship's W_hh: the largest distance to float64 of
    the three terms' products summed in float32 is at most the plain float32
    product's. Two terms are printed beside it, not asserted (they hold 16 of
    the 24 bits and lie about 6-11x further)."""
    w = flagship_w_hh[layer]
    dg = dg_like(10 + seed)
    ref = dg.double() @ w.double().t()
    gap = lambda y: float((y.double() - ref).abs().max())
    plain, three, two = gap(dg @ w.t()), gap(split_product(dg, w, 3)), gap(split_product(dg, w, 2))
    print(f"layer {layer} seed {seed}: float32 {plain:.3e}, three terms {three:.3e} ({three / plain:.2f}x), "
          f"two terms {two:.3e} ({two / plain:.2f}x)")
    assert three <= plain


def rz_float32(x):
    """float64 -> float32 rounded toward zero (the tensor core's cut)."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0.0))
    return f


def test_k_step_sums_rounded_to_nearest_carry_no_bias(flagship_w_hh):
    """The hi terms' products, each k-step's 16 summed exactly and then cut
    to float32 toward zero, and added in float32, lie on average toward zero
    of the float64 product by a bias that a recurrence integrates; rounded to
    nearest instead (mma_bf16_rn), the mean signed error is at most a quarter
    of that."""
    w = flagship_w_hh[1].double().numpy()
    hi = split_bf16(dg_like(20), 1)[0].double().numpy()
    exact = hi @ w.T
    # [rows, k-steps, H]: each k-step's 16 products (exact), summed in float64
    steps = np.einsum("rsk,usk->rsu", hi.reshape(ROWS, K // 16, 16), w.reshape(-1, K // 16, 16))
    bias = {}
    for name, cut in (("toward_zero", rz_float32), ("nearest", lambda x: x.astype(np.float32))):
        acc = np.zeros(exact.shape, np.float32)
        for s in range(K // 16):
            acc = acc + cut(steps[:, s])
        bias[name] = float(np.mean((acc.astype(np.float64) - exact) * np.sign(exact)))
    print(bias)
    assert bias["toward_zero"] < 0.0
    assert abs(bias["nearest"]) <= 0.25 * abs(bias["toward_zero"])
