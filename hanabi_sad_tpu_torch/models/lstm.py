"""Multi-layer LSTM (counterpart of `hanabi_sad_tpu/models/lstm.py`).

Gate layout is torch-compatible (i, f, g, o order, separate input/hidden
weights, one collapsed bias). `lstm_seq` (and `lstm_step` through it) routes:

  * CUDA tensors, grad enabled and some input or weight requiring grad:
    kernel B2 (`ops/lstm_seq.py:lstm_seq_diff`), B1's forward keeping its
    gates, and the BPTT backward kernel;
  * other CUDA tensors: kernel B1;
  * CPU tensors: the plain `_cell` loop, differentiated by autograd.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from hanabi_sad_tpu_torch.device import resolve_device
from hanabi_sad_tpu_torch.ops import lstm_seq as lstm_seq_op
from hanabi_sad_tpu_torch.ops.lstm_seq import Hidden, LSTMParams, _cell  # noqa: F401  (_cell is this module's plain cell)


def init_lstm(
    in_dim: int,
    hid_dim: int,
    num_layers: int,
    *,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> LSTMParams:
    """torch.nn.LSTM default init: U(-k, k) with k = 1/sqrt(hid_dim) for every
    weight and bias; the two torch biases collapse into one, so b is the sum
    of two U(-k, k) draws. Drawn on the generator's device, stored on
    `device` (default `cuda`)."""
    k = 1.0 / math.sqrt(hid_dim)
    device = resolve_device(device)
    gen_device = generator.device if generator is not None else torch.device("cpu")

    def uniform(*shape):
        u = torch.rand(shape, generator=generator, device=gen_device)
        return (u * 2 * k - k).to(device)

    params = []
    for layer in range(num_layers):
        d_in = in_dim if layer == 0 else hid_dim
        params.append(
            {
                "w_ih": uniform(d_in, 4 * hid_dim),
                "w_hh": uniform(hid_dim, 4 * hid_dim),
                "b": uniform(4 * hid_dim) + uniform(4 * hid_dim),
            }
        )
    return params


def lstm_seq(params: LSTMParams, xs: torch.Tensor, hidden: Hidden) -> Tuple[torch.Tensor, Hidden]:
    """Full sequence. xs: [T, B, in], hidden ([L, B, H] x 2) -> (outputs
    [T, B, H], final hidden), routed as the module docstring says."""
    if xs.is_cuda and torch.is_grad_enabled():
        tensors = [xs, *hidden] + [t for p in params for t in p.values()]
        if any(t.requires_grad for t in tensors):
            return lstm_seq_op.lstm_seq_diff(params, xs, hidden)
    return lstm_seq_op.lstm_seq(params, xs, hidden)


def lstm_step(params: LSTMParams, x: torch.Tensor, hidden: Hidden) -> Tuple[torch.Tensor, Hidden]:
    """One time step through all layers. x: [B, in], hidden ([L, B, H] x 2).
    Returns (top-layer output [B, H], new hidden)."""
    outs, hidden = lstm_seq(params, x[None], hidden)
    return outs[0], hidden


def zero_hidden(num_layers: int, batch: int, hid_dim: int, dtype=torch.float32, device=None) -> Hidden:
    shape = (num_layers, batch, hid_dim)
    return (
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
    )
