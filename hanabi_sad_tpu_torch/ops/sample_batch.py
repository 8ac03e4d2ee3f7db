"""Kernel B3: one pass from the replay's sampled indices to the learner's
time-major Batch, with its plain PyTorch version.

Counterpart of `hanabi_sad_tpu/ops/experimental/pallas_replay.py:
gather_unpack_pallas` together with what the JAX package's
`replay/prioritized.py:rows_to_batch` does with its output. `sample_batch`
launches the CUDA kernel of `csrc/sample_batch.cu` for CUDA tensors and runs
`sample_batch_plain` for CPU tensors; for a CUDA tensor it launches the kernel
or raises, it never falls back.

Inputs are the replay's fields, packed [cap, T, Pi, NB] uint8 (per player
priv_s | legal_move | own_hand bits, `replay/bitpack.py`), action [cap, T,
Pi] int64, reward and bootstrap [cap, T] float32, seq_len [cap] float32, and
idx [B] int64, read as JAX's `x[idx]` reads it (`gather_unpack.jax_index`).
The output is the learner Batch with every field contiguous and time-major:
priv_s [T, B, Pi, F], legal_move [T, B, Pi, A], own_hand [T, B, Pi, 3h]
(float32 0/1), action [T, B, Pi] int64, reward, bootstrap and terminal [T,
B] float32 (terminal = t >= seq_len - 1), seq_len [B]. So the learner's
reshapes of its fields (`r2d2_agent.td_error`, `loss`) are views.
"""

from __future__ import annotations

import ctypes
import math

import torch

from hanabi_sad_tpu_torch.agent.r2d2_agent import Batch
from hanabi_sad_tpu_torch.ops import build
from hanabi_sad_tpu_torch.ops.gather_unpack import check_idx, gather_unpack_plain, jax_index


def _check_fields(packed, action, reward, bootstrap, seq_len, idx, obs_dim, num_actions, hand_size):
    if packed.dim() != 4 or packed.dtype != torch.uint8:
        raise ValueError(f"packed must be [cap, T, Pi, NB] uint8, got {tuple(packed.shape)} {packed.dtype}")
    cap, T, Pi, NB = packed.shape
    check_idx(idx)
    expect = {"action": ((cap, T, Pi), torch.int64), "reward": ((cap, T), torch.float32),
              "bootstrap": ((cap, T), torch.float32), "seq_len": ((cap,), torch.float32)}
    for name, t in (("action", action), ("reward", reward), ("bootstrap", bootstrap), ("seq_len", seq_len)):
        shape, dtype = expect[name]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {list(shape)} {dtype}, got {tuple(t.shape)} {t.dtype}")
    if obs_dim + num_actions + 3 * hand_size > 8 * NB:
        raise ValueError(f"{obs_dim + num_actions + 3 * hand_size} bits do not fit {NB} bytes a step")


def sample_batch_plain(packed, action, reward, bootstrap, seq_len, idx, *, obs_dim, num_actions, hand_size) -> Batch:
    """The plain version: the JAX package's `rows_to_batch(cfg,
    gather_rows(state, idx))`, every field made contiguous."""
    _check_fields(packed, action, reward, bootstrap, seq_len, idx, obs_dim, num_actions, hand_size)
    F, A = obs_dim, num_actions
    T = packed.shape[1]
    bits = gather_unpack_plain(packed, idx)  # [B, T, Pi, NB * 8]
    rows = jax_index(idx, packed.shape[0])
    tm = lambda x: x.transpose(0, 1).contiguous()  # [B, T, ...] -> [T, B, ...]
    lens = seq_len[rows]
    t_idx = torch.arange(T, dtype=torch.float32, device=lens.device)[:, None]
    return Batch(
        priv_s=tm(bits[..., :F]),
        legal_move=tm(bits[..., F : F + A]),
        action=tm(action[rows]),
        own_hand=tm(bits[..., F + A : F + A + 3 * hand_size]),
        reward=tm(reward[rows]),
        terminal=(t_idx >= (lens[None, :] - 1)).float(),
        bootstrap=tm(bootstrap[rows]),
        seq_len=lens,
    )


class SampleBatchKernel:
    """Wrapper of the CUDA kernel. `launches` counts kernel launches (one per
    call); a caller may reset it."""

    source = "sample_batch.cu"

    def __init__(self):
        self.launches = 0
        self._fn = None
        self.ptxas = []

    def load(self):
        """Build (at first use) and bind the library."""
        if self._fn is None:
            lib, self.ptxas = build.build(self.source)
            fn = lib.sample_batch
            fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_longlong] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, packed, action, reward, bootstrap, seq_len, idx, *, obs_dim, num_actions, hand_size) -> Batch:
        _check_fields(packed, action, reward, bootstrap, seq_len, idx, obs_dim, num_actions, hand_size)
        inputs = {"packed": packed, "action": action, "reward": reward, "bootstrap": bootstrap,
                  "seq_len": seq_len, "idx": idx}
        for name, t in inputs.items():
            if not t.is_cuda:
                raise ValueError(f"sample_batch kernel needs CUDA tensors; {name} is on {t.device}")
            if not t.is_contiguous():
                raise ValueError(f"sample_batch kernel needs contiguous tensors; {name} is not")
            if t.device != packed.device:
                raise ValueError("sample_batch kernel needs every input on one device")
        cap, T, Pi, NB = packed.shape
        B = idx.shape[0]
        if cap < 1 or T < 1 or B < 1:
            raise ValueError(f"empty sample: packed {tuple(packed.shape)}, idx {tuple(idx.shape)}")
        F, A, H3 = obs_dim, num_actions, 3 * hand_size
        fn = self.load()
        if packed.get_device() != torch.cuda.current_device():
            raise ValueError(f"sample_batch kernel launches on the current device; packed is on {packed.device}")
        # One allocation for the float fields (the wrapper's host time is
        # mostly allocator calls), each field starting on a 16-byte boundary.
        shapes = [(T, B, Pi, F), (T, B, Pi, A), (T, B, Pi, H3), (T, B), (T, B), (T, B), (B,)]
        sizes = [math.prod(shape) for shape in shapes]
        starts = [0]
        for n in sizes[:-1]:
            starts.append(starts[-1] + -(-n // 4) * 4)
        flat = torch.empty(starts[-1] + sizes[-1], dtype=torch.float32, device=packed.device)
        fields = [flat[o : o + n].view(shape) for o, n, shape in zip(starts, sizes, shapes)]
        out = Batch(**dict(zip(("priv_s", "legal_move", "own_hand", "reward", "terminal", "bootstrap", "seq_len"),
                               fields)), action=torch.empty((T, B, Pi), dtype=torch.int64, device=packed.device))
        err = fn(
            packed.data_ptr(), action.data_ptr(), reward.data_ptr(), bootstrap.data_ptr(),
            seq_len.data_ptr(), idx.data_ptr(), out.priv_s.data_ptr(), out.legal_move.data_ptr(),
            out.own_hand.data_ptr(), out.action.data_ptr(), out.reward.data_ptr(),
            out.bootstrap.data_ptr(), out.terminal.data_ptr(), out.seq_len.data_ptr(),
            cap, T, B, Pi, NB, F, A, H3, torch.cuda.current_stream().cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"sample_batch launch failed with CUDA error {err}")
        self.launches += 1
        return out


sample_batch_kernel = SampleBatchKernel()


def sample_batch(packed, action, reward, bootstrap, seq_len, idx, *, obs_dim, num_actions, hand_size) -> Batch:
    """The learner Batch of the episodes at idx: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    fn = sample_batch_kernel if packed.is_cuda else sample_batch_plain
    return fn(packed, action, reward, bootstrap, seq_len, idx,
              obs_dim=obs_dim, num_actions=num_actions, hand_size=hand_size)
