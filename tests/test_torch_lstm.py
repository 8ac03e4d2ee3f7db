"""The port's LSTM (`hanabi_sad_tpu_torch.models.lstm`, `ops.lstm_seq`)
against the JAX package's scan LSTM and its Pallas kernel in interpret mode.

Inputs are made with numpy from a seed: T=7, B=8 and 13, H=128, L=2, nonzero
h0/c0. Tolerance 1e-5 abs in float32: the same arithmetic, summed in another
order. Kernel B1 itself runs only on a CUDA card (tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hanabi_sad_tpu.models import lstm as jlstm
from hanabi_sad_tpu.ops.experimental import pallas_lstm
from hanabi_sad_tpu_torch.models import lstm as tlstm
from hanabi_sad_tpu_torch.ops import build
from hanabi_sad_tpu_torch.ops.lstm_seq import lstm_seq_kernel, lstm_seq_plain

TOL = 1e-5


def make(T, B, H=128, L=2, seed=0):
    rng = np.random.RandomState(seed)
    k = 1.0 / np.sqrt(H)
    params = [
        {
            "w_ih": rng.uniform(-k, k, (H, 4 * H)).astype(np.float32),
            "w_hh": rng.uniform(-k, k, (H, 4 * H)).astype(np.float32),
            "b": rng.uniform(-2 * k, 2 * k, (4 * H,)).astype(np.float32),
        }
        for _ in range(L)
    ]
    xs = rng.randn(T, B, H).astype(np.float32)
    h0 = (0.5 * rng.randn(L, B, H)).astype(np.float32)
    c0 = (0.5 * rng.randn(L, B, H)).astype(np.float32)
    return params, xs, h0, c0


def to_torch(params, *arrays):
    tp = [{k: torch.from_numpy(v) for k, v in p.items()} for p in params]
    return (tp,) + tuple(torch.from_numpy(a) for a in arrays)


def to_jax(params, *arrays):
    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    return (jp,) + tuple(jnp.asarray(a) for a in arrays)


def assert_close(torch_out, jax_out):
    (t_o, (t_h, t_c)), (j_o, (j_h, j_c)) = torch_out, jax_out
    for t, j in ((t_o, j_o), (t_h, j_h), (t_c, j_c)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL, rtol=0)


@pytest.mark.parametrize("B", [8, 13])
def test_lstm_seq_matches_jax_scan(B):
    params, xs, h0, c0 = make(7, B)
    tp, txs, th0, tc0 = to_torch(params, xs, h0, c0)
    jp, jxs, jh0, jc0 = to_jax(params, xs, h0, c0)
    assert_close(tlstm.lstm_seq(tp, txs, (th0, tc0)), jlstm.lstm_seq(jp, jxs, (jh0, jc0)))


@pytest.mark.parametrize("B", [8, 13])
def test_lstm_seq_matches_pallas_interpret(B):
    params, xs, h0, c0 = make(7, B, seed=1)
    tp, txs, th0, tc0 = to_torch(params, xs, h0, c0)
    jp, jxs, jh0, jc0 = to_jax(params, xs, h0, c0)
    ref = pallas_lstm.lstm_seq_pallas(jp, jxs, (jh0, jc0), block_b=B, interpret=True)
    assert_close(lstm_seq_plain(tp, txs, (th0, tc0)), ref)


@pytest.mark.parametrize("B", [8, 13])
def test_lstm_step_matches_jax(B):
    params, xs, h0, c0 = make(1, B, seed=2)
    tp, txs, th0, tc0 = to_torch(params, xs, h0, c0)
    jp, jxs, jh0, jc0 = to_jax(params, xs, h0, c0)
    t_out, t_hid = tlstm.lstm_step(tp, txs[0], (th0, tc0))
    j_out, j_hid = jlstm.lstm_step(jp, jxs[0], (jh0, jc0))
    assert_close((t_out, t_hid), (j_out, j_hid))


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    params, xs, h0, c0 = make(3, 5, H=32, seed=3)
    tp, txs, th0, tc0 = to_torch(params, xs, h0, c0)
    before = (lstm_seq_kernel.launches, lstm_seq_kernel.calls)
    out, (h, c) = tlstm.lstm_seq(tp, txs, (th0, tc0))
    ref, (rh, rc) = lstm_seq_plain(tp, txs, (th0, tc0))
    assert torch.equal(out, ref) and torch.equal(h, rh) and torch.equal(c, rc)
    assert (lstm_seq_kernel.launches, lstm_seq_kernel.calls) == before


def test_kernel_wrapper_refuses_cpu_tensors():
    params, xs, h0, c0 = make(1, 4, H=32, seed=4)
    tp, txs, th0, tc0 = to_torch(params, xs, h0, c0)
    with pytest.raises(ValueError, match="CUDA"):
        lstm_seq_kernel(tp, txs, (th0, tc0))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "NVCC_FALLBACK", str(tmp_path / "nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_init_lstm_shapes_and_range():
    params = tlstm.init_lstm(64, 32, 2, generator=torch.Generator().manual_seed(0), device="cpu")
    assert [tuple(p["w_ih"].shape) for p in params] == [(64, 128), (32, 128)]
    assert all(tuple(p["w_hh"].shape) == (32, 128) and tuple(p["b"].shape) == (128,) for p in params)
    k = 1 / np.sqrt(32)
    assert all(float(p["w_ih"].abs().max()) <= k and float(p["b"].abs().max()) <= 2 * k for p in params)

