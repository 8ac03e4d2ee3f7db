"""Device-resident prioritized sequence replay (counterpart of
`hanabi_sad_tpu/replay/prioritized.py`).

The whole buffer is a set of tensors on the device. Writes scatter at a ring
cursor, the stratified proportional sampler is a cumsum + searchsorted, and
kernel B3 (`ops/sample_batch.py`) gathers the sampled episodes, unpacks their
bits and writes the learner Batch in one pass.

Semantics are the JAX package's:
  * priorities are raised to alpha on add and update;
  * sampling is stratified proportional, one uniform draw per equal-weight
    segment;
  * importance weights (size * p / sum)^-beta, normalised by each batch's
    max;
  * capacity eviction overwrites the oldest items (ring overwrite).

Unlike the JAX package, whose arrays are immutable, `add`, `add_packed` and
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
from hanabi_sad_tpu_torch.ops import sample_batch as sample_batch_op
from hanabi_sad_tpu_torch.replay.bitpack import pack_bits, packed_size


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


class EpisodeBatch(NamedTuple):
    """M new episodes to ingest (already n-step processed and padded)."""

    priv_s: torch.Tensor  # [M, T, Pi, F]
    legal_move: torch.Tensor  # [M, T, Pi, A]
    own_hand: torch.Tensor  # [M, T, Pi, 3*hand]
    action: torch.Tensor  # [M, T, Pi] int64
    reward: torch.Tensor  # [M, T]
    bootstrap: torch.Tensor  # [M, T]
    seq_len: torch.Tensor  # [M]


def add(state: ReplayState, cfg: ReplayConfig, ep: EpisodeBatch, priority: torch.Tensor) -> ReplayState:
    """Ring-write M unpacked episodes with priority^alpha weights, in place:
    their bits packed, then `add_packed`."""
    bits = torch.cat([ep.priv_s, ep.legal_move, ep.own_hand], dim=-1)
    return add_packed(state, cfg, pack_bits(bits), ep.action, ep.reward, ep.bootstrap, ep.seq_len, priority)


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


# Row length of `blocked_cumsum`'s two-level scan: at the flagship's 65,536
# slots, 16 rows.
SCAN_ROW = 4096


def blocked_cumsum(w: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a 1-D tensor that gives the same bits on every
    run, on every device. A 1-D `torch.cumsum` on the card goes through CUB's
    decoupled look-back scan, whose order of summation changes from run to
    run; this one is cut into rows of SCAN_ROW (at least 2, zero-padded),
    each row scanned along itself, the row totals scanned down the rows, and
    each row given the total of the rows before it. Both scans are PyTorch's
    fixed-order 2-D scans."""
    n = w.shape[0]
    rows = max(2, -(-n // SCAN_ROW))
    if rows * SCAN_ROW != n:
        w = torch.nn.functional.pad(w, (0, rows * SCAN_ROW - n))
    grid = w.view(rows, SCAN_ROW).cumsum(1)
    before = torch.nn.functional.pad(grid.cumsum(0)[:-1, -1], (1, 0))
    return (grid + before[:, None]).view(-1)[:n]


def sample_indices(
    state: ReplayState,
    cfg: ReplayConfig,
    batchsize: int,
    *,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stratified proportional draw of indices + IS weights from the current
    priority state, for one batch or for U at once.

    The uniforms in [0, 1) are `uniforms`, [B] or [U, B], or else one
    `rand((B,))` call of `generator`. All U batches share one prefix sum,
    the JAX package's priority-snapshot semantics; each row is its own
    stratified draw, and its IS weights are normalised by its own max.

    Returns (idx, is_weight), [B] int64 and f32, or [U, B] for [U, B]
    uniforms."""
    device = state.weight.device
    valid = torch.arange(cfg.capacity, device=device) < state.size
    w = torch.where(valid, state.weight, torch.zeros_like(state.weight))
    cum = blocked_cumsum(w)
    total = cum[-1]
    seg = total / batchsize
    if uniforms is None:
        uniforms = torch.rand((batchsize,), generator=generator, device=device)
    single = uniforms.dim() == 1
    u = uniforms.to(device).reshape(-1, batchsize)  # [U, B]
    targets = (torch.arange(batchsize, device=device) + u) * seg
    targets = torch.minimum(targets, total * (1 - 1e-6))
    idx = torch.searchsorted(cum, targets, right=True).clamp(max=cfg.capacity - 1)
    p = w[idx] / torch.clamp(total, min=1e-30)
    is_w = (state.size.float() * p).pow(-cfg.beta)
    is_w = is_w / torch.clamp(is_w.max(dim=-1, keepdim=True).values, min=1e-30)
    if single:
        return idx[0], is_w[0]
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


def _sample_batch(cfg: ReplayConfig, packed, action, reward, bootstrap, seq_len, idx) -> Batch:
    return sample_batch_op.sample_batch(
        packed, action, reward, bootstrap, seq_len, idx,
        obs_dim=cfg.obs_dim, num_actions=cfg.num_actions, hand_size=cfg.hand_size,
    )


def batch_at(state: ReplayState, cfg: ReplayConfig, idx: torch.Tensor) -> Batch:
    """The learner Batch ([T, B, ...]) of the ring's episodes at idx: B3
    gathers them from the ring and writes the Batch in one launch."""
    return _sample_batch(cfg, state.packed, state.action, state.reward, state.bootstrap, state.seq_len, idx)


def rows_to_batch(cfg: ReplayConfig, rows: ReplayRows) -> Batch:
    """Unpack one batch of gathered rows ([B, T, ...]) into the time-major
    learner Batch ([T, B, ...], every field contiguous): B3 over the rows
    with the identity index."""
    ident = torch.arange(rows.packed.shape[0], device=rows.packed.device)
    return _sample_batch(cfg, rows.packed, rows.action, rows.reward, rows.bootstrap, rows.seq_len, ident)


def sample(
    state: ReplayState,
    cfg: ReplayConfig,
    batchsize: int,
    *,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> Tuple[Batch, torch.Tensor, torch.Tensor]:
    """Stratified proportional sample of `batchsize` episodes; B3 gathers
    them from the ring and writes the learner Batch in one launch.

    Returns (Batch [T, B, Pi, ...], is_weight [B], indices [B]). The caller
    feeds the indices back through update_priority after the gradient step."""
    idx, is_w = sample_indices(state, cfg, batchsize, generator=generator, uniforms=uniforms)
    return batch_at(state, cfg, idx), is_w, idx


def update_priority(
    state: ReplayState, cfg: ReplayConfig, idx: torch.Tensor, priority: torch.Tensor
) -> ReplayState:
    """Learner feedback, in place: weight[idx] = priority^alpha. Duplicate
    indices carry identical values (duplicate rows of a batch are identical
    inputs to a deterministic per-row computation), so the write order does
    not matter.

    Indices read as the JAX package's `weight.at[idx].set` reads them: one in
    [-cap, -1] counts from the end, and the write of one outside [-cap, cap)
    is dropped. The writes go through a copy with one spare slot at the end,
    which takes the dropped ones, so that no index check waits on the card."""
    cap = state.weight.shape[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + cap, idx)
    idx = torch.where((idx >= 0) & (idx < cap), idx, cap)
    spare = torch.cat([state.weight, state.weight.new_zeros(1)])
    spare[idx] = priority.detach().float().pow(cfg.alpha)
    state.weight.copy_(spare[:cap])
    return state
