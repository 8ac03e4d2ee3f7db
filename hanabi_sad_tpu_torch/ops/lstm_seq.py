"""Kernel B1: the multi-layer float32 LSTM over a sequence, with its plain
PyTorch version.

Counterpart of `hanabi_sad_tpu/ops/experimental/pallas_lstm.py:lstm_seq_pallas`
and of the scan in `hanabi_sad_tpu/models/lstm.py`. `lstm_seq` launches the
CUDA kernel of `csrc/lstm_seq.cu` for a CUDA tensor and runs `lstm_seq_plain`
for a CPU tensor; for a CUDA tensor it launches the kernel or raises, it never
falls back.

Layouts are the JAX package's: params is a list of per-layer
{"w_ih": [in, 4H], "w_hh": [H, 4H], "b": [4H]} (one collapsed bias, gate
order i, f, g, o); xs [T, B, in]; hidden (h, c) each [L, B, H].
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch

from hanabi_sad_tpu_torch.ops import build

LSTMParams = List[Dict[str, torch.Tensor]]
Hidden = Tuple[torch.Tensor, torch.Tensor]


def _cell(p: Dict[str, torch.Tensor], x: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
    """One LSTM cell step. x: [B, in], h/c: [B, H]."""
    gates = x @ p["w_ih"] + h @ p["w_hh"] + p["b"]
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def lstm_seq_plain(params: LSTMParams, xs: torch.Tensor, hidden: Hidden):
    """The plain version: a Python loop over time and layers of `_cell`.
    Returns (outs [T, B, H], (hT, cT) [L, B, H])."""
    h = list(hidden[0].unbind(0))
    c = list(hidden[1].unbind(0))
    outs = []
    for x in xs.unbind(0):
        for layer, p in enumerate(params):
            h[layer], c[layer] = _cell(p, x, h[layer], c[layer])
            x = h[layer]
        outs.append(x)
    return torch.stack(outs), (torch.stack(h), torch.stack(c))


class LstmSeqKernel:
    """Wrapper of the CUDA kernel. `launches` counts kernel launches (T * L
    per call), `calls` counts calls that launched it; both are plain integers
    that a caller may reset."""

    source = "lstm_seq.cu"

    def __init__(self):
        self.launches = 0
        self.calls = 0
        self._fn = None
        self.ptxas: List[str] = []

    def load(self):
        """Build (at first use) and bind the library."""
        if self._fn is None:
            lib, self.ptxas = build.build(self.source)
            fn = lib.lstm_cell_f32
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            lib.lstm_cell_h_multiple.restype = ctypes.c_int
            self._h_multiple = lib.lstm_cell_h_multiple()
            self._fn = fn
        return self._fn

    def __call__(self, params: LSTMParams, xs: torch.Tensor, hidden: Hidden):
        h0, c0 = hidden
        if xs.dim() != 3 or xs.shape[0] < 1 or xs.shape[1] < 1:
            raise ValueError(f"xs must be [T, B, H] with T, B >= 1, got {tuple(xs.shape)}")
        T, B, H = xs.shape
        L = len(params)
        tensors = [xs, h0, c0] + [p[k] for p in params for k in ("w_ih", "w_hh", "b")]
        for t in tensors:
            if not t.is_cuda:
                raise ValueError("lstm_seq kernel needs CUDA tensors")
            if t.dtype != torch.float32:
                raise ValueError(f"lstm_seq kernel takes float32 only, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError("lstm_seq kernel needs contiguous tensors")
            if t.device != xs.device:
                raise ValueError("lstm_seq kernel needs every tensor on one device")
        if h0.shape != (L, B, H) or c0.shape != (L, B, H):
            raise ValueError(f"hidden must be [{L}, {B}, {H}], got {tuple(h0.shape)}, {tuple(c0.shape)}")
        for p in params:
            if p["w_ih"].shape != (H, 4 * H):
                raise ValueError(f"lstm_seq kernel needs in_dim == hid_dim: w_ih {tuple(p['w_ih'].shape)}")
            if p["w_hh"].shape != (H, 4 * H) or p["b"].shape != (4 * H,):
                raise ValueError("w_hh must be [H, 4H] and b [4H]")
        fn = self.load()
        if H % self._h_multiple != 0:
            raise ValueError(f"lstm_seq kernel needs H % {self._h_multiple} == 0, got H={H}")

        with torch.cuda.device(xs.device):
            stream = torch.cuda.current_stream().cuda_stream
            outs = torch.empty((T, B, H), dtype=xs.dtype, device=xs.device)
            slots = min(T, 2)
            hbuf = torch.empty((slots, L, B, H), dtype=xs.dtype, device=xs.device)
            cbuf = torch.empty((slots, L, B, H), dtype=xs.dtype, device=xs.device)
            for t in range(T):
                cur, prev = t % 2, (t - 1) % 2
                for layer, p in enumerate(params):
                    x = xs[t] if layer == 0 else hbuf[cur, layer - 1]
                    h_prev = h0[layer] if t == 0 else hbuf[prev, layer]
                    c_prev = c0[layer] if t == 0 else cbuf[prev, layer]
                    y = outs[t].data_ptr() if layer == L - 1 else None
                    err = fn(
                        x.data_ptr(), h_prev.data_ptr(), c_prev.data_ptr(),
                        p["w_ih"].data_ptr(), p["w_hh"].data_ptr(), p["b"].data_ptr(),
                        hbuf[cur, layer].data_ptr(), cbuf[cur, layer].data_ptr(), y,
                        B, H, stream,
                    )
                    if err != 0:
                        raise RuntimeError(f"lstm_cell_f32 launch failed with CUDA error {err}")
                    self.launches += 1
            self.calls += 1
        last = (T - 1) % 2
        return outs, (hbuf[last], cbuf[last])


lstm_seq_kernel = LstmSeqKernel()


def lstm_seq(params: LSTMParams, xs: torch.Tensor, hidden: Hidden):
    """Sequence LSTM: the CUDA kernel for a CUDA tensor, the plain version for
    a CPU tensor. Returns (outs [T, B, H], (hT, cT) [L, B, H])."""
    if xs.is_cuda:
        return lstm_seq_kernel(params, xs, hidden)
    return lstm_seq_plain(params, xs, hidden)
