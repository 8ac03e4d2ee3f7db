"""Multi-layer LSTM (counterpart of `hanabi_sad_tpu/models/lstm.py`).

Gate layout is torch-compatible (i, f, g, o order, separate input/hidden
weights, one collapsed bias). On a CUDA tensor `lstm_step` and `lstm_seq` go
through kernel B1 (`ops/lstm_seq.py`); on a CPU tensor they run the plain
`_cell` loop.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from hanabi_sad_tpu_torch.device import resolve_device
from hanabi_sad_tpu_torch.ops.lstm_seq import (  # noqa: F401  (_cell is this module's plain cell)
    Hidden,
    LSTMParams,
    _cell,
    lstm_seq,
)


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
