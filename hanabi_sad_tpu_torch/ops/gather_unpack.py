"""The plain PyTorch counterpart of the TPU kernel `hanabi_sad_tpu/ops/
experimental/pallas_replay.py:gather_unpack_pallas`, and the index rule of
the replay's gathers.

packed: [cap, T, Pi, NB] uint8; idx: [B] int64 ->
[B, T, Pi, NB * 8] float32 of 0/1, little-endian bits (bit k of byte j ->
feature 8j + k). Callers slice off the padding bits. Indices follow the
JAX gather (`jax_index`): an index in [-cap, -1] counts from the end, and
what still lies outside [0, cap) is clamped into it.

On the card the gather and unpack run inside kernel B3, which writes the
learner Batch directly (`ops/sample_batch.py`).
"""

from __future__ import annotations

import torch

from hanabi_sad_tpu_torch.replay.bitpack import unpack_bits


def check_idx(idx: torch.Tensor):
    if idx.dim() != 1 or idx.dtype != torch.int64:
        raise ValueError(f"idx must be [B] int64, got {tuple(idx.shape)} {idx.dtype}")


def jax_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """The row that JAX's `x[idx]` reads from an axis of length n: an index
    in [-n, -1] becomes n + idx, then everything is clamped into [0, n)."""
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def gather_unpack_plain(packed: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`unpack_bits(packed[jax_index(idx)])`."""
    check_idx(idx)
    idx = jax_index(idx, packed.shape[0])
    return unpack_bits(packed[idx], packed.shape[-1] * 8)
