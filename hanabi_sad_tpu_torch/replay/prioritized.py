"""Device-resident prioritized sequence replay (counterpart of
`hanabi_sad_tpu/replay/prioritized.py`).

The whole buffer is a set of tensors on the device. Writes scatter at a ring
cursor, the stratified proportional sampler is a cumsum + searchsorted, and
the sample's gather + bit unpack is kernel B3 (`ops/gather_unpack.py`).

Semantics are the JAX package's:
  * priorities are raised to alpha on add and update;
  * sampling is stratified proportional, one uniform draw per equal-weight
    segment;
  * importance weights (size * p / sum)^-beta, normalised by the batch max;
  * capacity eviction overwrites the oldest items (ring overwrite).

Unlike the JAX package, whose arrays are immutable, `add_packed` and
`update_priority` write the ring's tensors in place and return a
ReplayState that shares them; the state passed in is changed too.
Observations are stored bitpacked (`bitpack.py`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from hanabi_sad_tpu_torch.agent.r2d2_agent import Batch
from hanabi_sad_tpu_torch.ops import gather_unpack as gather_unpack_op
from hanabi_sad_tpu_torch.replay.bitpack import packed_size


@dataclasses.dataclass(frozen=True)
class ReplayConfig:
    capacity: int  # episodes
    seq_len: int  # T (max episode length, 80)
    num_player: int  # Pi: players per item (VDN = P, IQL = 1)
    obs_dim: int  # priv_s feature size
    num_actions: int
    hand_size: int = 5
    alpha: float = 0.9  # priority exponent (--priority_exponent)
    beta: float = 0.6  # IS exponent (--priority_weight)

    @property
    def bits_per_step(self) -> int:
        return self.obs_dim + self.num_actions + 3 * self.hand_size

    @property
    def bytes_per_step(self) -> int:
        return packed_size(self.bits_per_step)


class ReplayState(NamedTuple):
    packed: torch.Tensor  # [cap, T, Pi, bytes] uint8: priv_s | legal | own_hand
    action: torch.Tensor  # [cap, T, Pi] int64
    reward: torch.Tensor  # [cap, T] f32 (n-step discounted)
    bootstrap: torch.Tensor  # [cap, T] f32
    seq_len: torch.Tensor  # [cap] f32
    weight: torch.Tensor  # [cap] f32 = priority**alpha
    write_ptr: torch.Tensor  # int64 scalar, ring cursor
    size: torch.Tensor  # int64 scalar, valid items
    num_add: torch.Tensor  # int64 scalar, lifetime adds


def init_replay(cfg: ReplayConfig, device) -> ReplayState:
    cap, T, Pi = cfg.capacity, cfg.seq_len, cfg.num_player
    scalar = lambda: torch.zeros((), dtype=torch.long, device=device)
    return ReplayState(
        packed=torch.zeros((cap, T, Pi, cfg.bytes_per_step), dtype=torch.uint8, device=device),
        action=torch.zeros((cap, T, Pi), dtype=torch.long, device=device),
        reward=torch.zeros((cap, T), device=device),
        bootstrap=torch.zeros((cap, T), device=device),
        seq_len=torch.ones((cap,), device=device),
        weight=torch.zeros((cap,), device=device),
        write_ptr=scalar(),
        size=scalar(),
        num_add=scalar(),
    )


def add_packed(
    state: ReplayState,
    cfg: ReplayConfig,
    packed: torch.Tensor,  # [M, T, Pi, bytes] uint8 (priv|legal|own_hand bits)
    action: torch.Tensor,
    reward: torch.Tensor,
    bootstrap: torch.Tensor,
    seq_len: torch.Tensor,
    priority: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
) -> ReplayState:
    """Ring-write M bitpacked episodes with priority^alpha weights, in place.

    `valid` masks empty slots: valid items compact onto consecutive ring
    positions; all invalid items scatter onto the single position just past
    the last valid write, where they collide only with each other, carry
    weight 0 (never sampled), and are overwritten by the next call's first
    valid item. `valid=None` means all M are real."""
    M = seq_len.shape[0]
    device = state.weight.device
    ar = torch.arange(M, device=device)
    if valid is None:
        idx = (state.write_ptr + ar) % cfg.capacity
        advance = torch.full((), M, dtype=torch.long, device=device)
        w = priority.float().pow(cfg.alpha)
    else:
        valid = valid.bool()
        offsets = torch.cumsum(valid.long(), 0) - valid.long()
        advance = valid.long().sum()
        scratch = (state.write_ptr + advance) % cfg.capacity
        idx = torch.where(valid, (state.write_ptr + offsets) % cfg.capacity, scratch)
        w = torch.where(valid, priority.float().pow(cfg.alpha), torch.zeros_like(priority, dtype=torch.float32))
    state.packed[idx] = packed
    state.action[idx] = action.long()
    state.reward[idx] = reward.float()
    state.bootstrap[idx] = bootstrap.float()
    state.seq_len[idx] = seq_len.float().clamp(min=1.0)
    state.weight[idx] = w
    return state._replace(
        write_ptr=(state.write_ptr + advance) % cfg.capacity,
        size=torch.clamp(state.size + advance, max=cfg.capacity),
        num_add=state.num_add + advance,
    )


def sample_indices(
    state: ReplayState,
    cfg: ReplayConfig,
    batchsize: int,
    *,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stratified proportional draw of `batchsize` indices + IS weights from
    the current priority state. The uniforms in [0, 1) come from `uniforms`
    ([batchsize], injected by tests) or else from `generator`.

    Returns (idx [B] int64, is_weight [B] f32)."""
    device = state.weight.device
    valid = torch.arange(cfg.capacity, device=device) < state.size
    w = torch.where(valid, state.weight, torch.zeros_like(state.weight))
    cum = torch.cumsum(w, 0)
    total = cum[-1]
    seg = total / batchsize
    if uniforms is None:
        uniforms = torch.rand((batchsize,), generator=generator, device=device)
    targets = (torch.arange(batchsize, device=device) + uniforms.to(device)) * seg
    targets = torch.minimum(targets, total * (1 - 1e-6))
    idx = torch.searchsorted(cum, targets, right=True).clamp(max=cfg.capacity - 1)
    p = w[idx] / torch.clamp(total, min=1e-30)
    is_w = (state.size.float() * p).pow(-cfg.beta)
    is_w = is_w / torch.clamp(is_w.max(), min=1e-30)
    return idx, is_w


class ReplayRows(NamedTuple):
    """Raw (still bitpacked) replay rows for a set of sampled indices."""

    packed: torch.Tensor  # [B, T, Pi, bytes] uint8
    action: torch.Tensor  # [B, T, Pi] int64
    reward: torch.Tensor  # [B, T] f32
    bootstrap: torch.Tensor  # [B, T] f32
    seq_len: torch.Tensor  # [B] f32


def gather_rows(state: ReplayState, idx: torch.Tensor) -> ReplayRows:
    """The rows at idx, every field read as JAX's `x[idx]` reads it
    (`gather_unpack.jax_index`: negative indices count from the end, the rest
    is clamped)."""
    idx = gather_unpack_op.jax_index(idx, state.packed.shape[0])
    return ReplayRows(
        packed=state.packed[idx],
        action=state.action[idx],
        reward=state.reward[idx],
        bootstrap=state.bootstrap[idx],
        seq_len=state.seq_len[idx],
    )


def _to_batch(cfg: ReplayConfig, bits: torch.Tensor, action, reward, bootstrap, seq_len) -> Batch:
    """Split unpacked bits [B, T, Pi, >= n_bits] into fields and make the
    time-major learner Batch ([T, B, ...]) with the gathered rows' fields."""
    F, A, n_bits = cfg.obs_dim, cfg.num_actions, cfg.bits_per_step
    tm = lambda x: x.transpose(0, 1)  # [B, T, ...] -> [T, B, ...]
    t_idx = torch.arange(cfg.seq_len, dtype=torch.float32, device=seq_len.device)[:, None]
    return Batch(
        priv_s=tm(bits[..., :F]),
        legal_move=tm(bits[..., F : F + A]),
        action=tm(action),
        own_hand=tm(bits[..., F + A : n_bits]),
        reward=tm(reward),
        terminal=(t_idx >= (seq_len[None, :] - 1)).float(),
        bootstrap=tm(bootstrap),
        seq_len=seq_len,
    )


def rows_to_batch(cfg: ReplayConfig, rows: ReplayRows) -> Batch:
    """Unpack one batch of gathered rows ([B, T, ...]) into the time-major
    learner Batch ([T, B, ...]). The unpack goes through B3 with the identity
    index."""
    B = rows.packed.shape[0]
    ident = torch.arange(B, device=rows.packed.device)
    bits = gather_unpack_op.gather_unpack(rows.packed, ident)
    return _to_batch(cfg, bits, rows.action, rows.reward, rows.bootstrap, rows.seq_len)


def sample(
    state: ReplayState,
    cfg: ReplayConfig,
    batchsize: int,
    *,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> Tuple[Batch, torch.Tensor, torch.Tensor]:
    """Stratified proportional sample of `batchsize` episodes; the packed
    observations are gathered and unpacked in one pass by B3.

    Returns (Batch [T, B, Pi, ...], is_weight [B], indices [B]). The caller
    feeds the indices back through update_priority after the gradient step."""
    idx, is_w = sample_indices(state, cfg, batchsize, generator=generator, uniforms=uniforms)
    bits = gather_unpack_op.gather_unpack(state.packed, idx)
    batch = _to_batch(
        cfg, bits, state.action[idx], state.reward[idx], state.bootstrap[idx], state.seq_len[idx]
    )
    return batch, is_w, idx


def update_priority(
    state: ReplayState, cfg: ReplayConfig, idx: torch.Tensor, priority: torch.Tensor
) -> ReplayState:
    """Learner feedback, in place: weight[idx] = priority^alpha. Duplicate
    indices carry identical values (duplicate rows of a batch are identical
    inputs to a deterministic per-row computation), so the write order does
    not matter."""
    state.weight[idx] = priority.detach().float().pow(cfg.alpha)
    return state
