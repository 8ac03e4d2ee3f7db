"""Card-belief helpers (counterpart of `hanabi_sad_tpu/utils/belief.py`).

v0: the hint-consistent card distribution per slot, weighted by the
publicly remaining card counts. get_v1: the damped fixed-point refinement of
v0 that discounts the cards expected in the other slots (`max_count`
iterations of a loop, where JAX runs a lax.fori_loop). check_v1 recomputes
v1 and compares.
"""

from __future__ import annotations

import torch

from hanabi_sad_tpu_torch.game import state as gstate


def get_v1(
    v0_joined: torch.Tensor,
    card_counts: torch.Tensor,
    max_count: int = 100,
    weight: float = 0.1,
) -> torch.Tensor:
    """Iterated belief. v0_joined [batch, num_slots, num_cards]: per-slot
    unnormalized hint-consistent distributions; card_counts [batch,
    num_cards]: remaining copies. Each step subtracts the cards expected in
    the *other* slots from the counts, re-masks, damps by `weight` and
    renormalizes."""
    mask = (v0_joined > 0).to(v0_joined.dtype)
    v1 = v0_joined / (v0_joined.sum(-1, keepdim=True) + 1e-8)
    for _ in range(max_count):
        hand_cards = v1.sum(dim=1)  # [batch, num_cards]
        total = card_counts - hand_cards
        excluding_self = torch.clamp(total[:, None, :] + v1, min=0.0)
        v1_new = v1 * (1 - weight) + weight * (excluding_self * mask)
        v1 = v1_new / (v1_new.sum(-1, keepdim=True) + 1e-8)
    return v1


def check_v1(v0, v1, card_counts, atol: float = 1e-4) -> bool:
    """Does v1 match get_v1(v0) within atol?"""
    ref = get_v1(v0, card_counts)
    return bool((ref - v1).abs().max() <= atol)


def v0_from_state(cfg, state, player: torch.Tensor) -> torch.Tensor:
    """Public V0 belief of each env's `player` [N] over its own hand, from a
    batched GameState: per slot, the hint-consistent plausibility mask
    weighted by the publicly remaining card counts (full deck minus
    discards, fireworks piles and the other players' visible hands), zero
    for an empty slot. Returns [N, hand_size, num_cards], unnormalized; the
    JAX function under jax.vmap."""
    N = state.hands.shape[0]
    dev = state.hands.device
    rows = torch.arange(N, device=dev)
    counts = gstate.card_counts(cfg, dev).float()[None] - state.discards.reshape(N, -1).float()
    # fireworks piles: color c has its ranks 0 .. fireworks[c] - 1 played
    ranks = torch.arange(cfg.num_ranks, device=dev)
    counts = counts - (ranks[None, None, :] < state.fireworks[:, :, None]).float().reshape(N, -1)
    # the other players' visible hands
    others = torch.arange(cfg.players, device=dev)[None, :] != player[:, None]  # [N, P]
    hands = state.hands  # [N, P, H]
    onehot = (hands[..., None] == torch.arange(cfg.num_cards, device=dev)) & (hands[..., None] >= 0)
    visible = (onehot & others[:, :, None, None]).sum((1, 2)).float()
    counts = torch.clamp(counts - visible, min=0.0)

    plaus = (
        state.color_plausible[rows, player][:, :, :, None] & state.rank_plausible[rows, player][:, :, None, :]
    ).reshape(N, cfg.hand_size, -1)
    occupied = (hands[rows, player] >= 0)[:, :, None]
    return plaus.float() * counts[:, None, :] * occupied


def check_trajectory(priv_s: torch.Tensor, terminal: torch.Tensor) -> int:
    """Padding validation: the terminal flags [T] form a suffix; returns the
    index of the first terminal step. priv_s [T, ...] is not read."""
    t = torch.as_tensor(terminal).detach().cpu().bool()
    ends = torch.nonzero(t).flatten()
    assert ends.numel() > 0, "no terminal in trajectory"
    end = int(ends[0])
    assert bool(t[end:].all()), "terminal flags must be a suffix"
    return end
