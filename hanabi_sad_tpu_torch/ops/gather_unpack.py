"""Kernel B3: the replay's indexed episode gather fused with the bit unpack,
with its plain PyTorch version.

Counterpart of `hanabi_sad_tpu/ops/experimental/pallas_replay.py:
gather_unpack_pallas`. `gather_unpack` launches the CUDA kernel of
`csrc/gather_unpack.cu` for a CUDA tensor and runs `gather_unpack_plain` for a
CPU tensor; for a CUDA tensor it launches the kernel or raises, it never
falls back.

packed: [cap, T, Pi, NB] uint8; idx: [B] int64 ->
[B, T, Pi, NB * 8] float32 of 0/1, little-endian bits (bit k of byte j ->
feature 8j + k). Callers slice off the padding bits. Indices follow the
JAX gather (`jax_index`): an index in [-cap, -1] counts from the end, and
what still lies outside [0, cap) is clamped into it, by both versions.
"""

from __future__ import annotations

import ctypes

import torch

from hanabi_sad_tpu_torch.ops import build
from hanabi_sad_tpu_torch.replay.bitpack import unpack_bits


def _check_idx(idx: torch.Tensor):
    if idx.dim() != 1 or idx.dtype != torch.int64:
        raise ValueError(f"idx must be [B] int64, got {tuple(idx.shape)} {idx.dtype}")


def jax_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """The row that JAX's `x[idx]` reads from an axis of length n: an index
    in [-n, -1] becomes n + idx, then everything is clamped into [0, n)."""
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def gather_unpack_plain(packed: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain version: `unpack_bits(packed[jax_index(idx)])`."""
    _check_idx(idx)
    idx = jax_index(idx, packed.shape[0])
    return unpack_bits(packed[idx], packed.shape[-1] * 8)


class GatherUnpackKernel:
    """Wrapper of the CUDA kernel. `launches` counts kernel launches (one per
    call); a caller may reset it."""

    source = "gather_unpack.cu"

    def __init__(self):
        self.launches = 0
        self._fn = None
        self.ptxas = []

    def load(self):
        """Build (at first use) and bind the library."""
        if self._fn is None:
            lib, self.ptxas = build.build(self.source)
            fn = lib.gather_unpack_u8_f32
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, packed: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        if packed.dim() != 4 or packed.dtype != torch.uint8:
            raise ValueError(f"packed must be [cap, T, Pi, NB] uint8, got {tuple(packed.shape)} {packed.dtype}")
        _check_idx(idx)
        for name, t in (("packed", packed), ("idx", idx)):
            if not t.is_cuda:
                raise ValueError(f"gather_unpack kernel needs CUDA tensors; {name} is on {t.device}")
            if not t.is_contiguous():
                raise ValueError(f"gather_unpack kernel needs contiguous tensors; {name} is not")
        if idx.device != packed.device:
            raise ValueError("gather_unpack kernel needs packed and idx on one device")
        cap, T, Pi, NB = packed.shape
        B = idx.shape[0]
        if cap < 1 or T * Pi * NB < 1 or B < 1:
            raise ValueError(f"empty gather: packed {tuple(packed.shape)}, idx {tuple(idx.shape)}")
        fn = self.load()
        with torch.cuda.device(packed.device):
            out = torch.empty((B, T, Pi, NB * 8), dtype=torch.float32, device=packed.device)
            if out.data_ptr() % 16 != 0:
                raise RuntimeError("gather_unpack kernel needs a 16-byte aligned output")
            err = fn(
                packed.data_ptr(), idx.data_ptr(), out.data_ptr(),
                cap, T * Pi * NB, B, torch.cuda.current_stream().cuda_stream,
            )
            if err != 0:
                raise RuntimeError(f"gather_unpack_u8_f32 launch failed with CUDA error {err}")
            self.launches += 1
        return out


gather_unpack_kernel = GatherUnpackKernel()


def gather_unpack(packed: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather + unpack: the CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor."""
    if packed.is_cuda:
        return gather_unpack_kernel(packed, idx)
    return gather_unpack_plain(packed, idx)
