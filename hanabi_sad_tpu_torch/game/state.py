"""Hanabi game state as a struct of batched tensors (counterpart of
`hanabi_sad_tpu/game/state.py`).

Every field carries a leading env axis N, where the JAX package vmapped over
single games. Integer fields are int64 so they index directly.

Card code convention: code = color * num_ranks + rank, in [0, 25); -1 = empty.
Hands are compact: occupied slots form a prefix, removal shifts left and a
drawn card is appended at the end (HLE hand semantics).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from hanabi_sad_tpu_torch.device import resolve_device
from hanabi_sad_tpu_torch.game.config import CARDS_PER_RANK, GameConfig

# Move-type enum, in HLE uid order; NONE means "no non-deal move yet".
DISCARD = 0
PLAY = 1
REVEAL_COLOR = 2
REVEAL_RANK = 3
NO_OP = 4
NONE = 5


class LastAction(NamedTuple):
    """Record of the most recent non-deal move, with the outcome fields the
    canonical encoder needs. Fields are [N] except reveal_mask [N, H]."""

    move_type: torch.Tensor
    player: torch.Tensor
    target: torch.Tensor  # hint target seat (reveal moves) else -1
    color: torch.Tensor  # hinted color (reveal-color) else -1
    rank: torch.Tensor  # hinted rank (reveal-rank) else -1
    reveal_mask: torch.Tensor  # [N, H] bool, slots touched by the hint
    position: torch.Tensor  # slot played/discarded else -1
    card: torch.Tensor  # card code played/discarded else -1
    scored: torch.Tensor  # bool, play succeeded
    info_add: torch.Tensor  # bool, successful 5 regained an info token


class GameState(NamedTuple):
    deck: torch.Tensor  # [N, deck_size] card codes in deal order
    deck_ptr: torch.Tensor  # [N] number of cards dealt so far
    hands: torch.Tensor  # [N, P, H] card code or -1
    color_plausible: torch.Tensor  # [N, P, H, C] bool
    rank_plausible: torch.Tensor  # [N, P, H, R] bool
    color_hinted: torch.Tensor  # [N, P, H, C] bool, direct positive color hint
    rank_hinted: torch.Tensor  # [N, P, H, R] bool
    fireworks: torch.Tensor  # [N, C] in [0, R]
    info: torch.Tensor  # [N] information tokens
    life: torch.Tensor  # [N] life tokens
    discards: torch.Tensor  # [N, C, R] count of discarded copies
    cur_player: torch.Tensor  # [N]
    turns_left: torch.Tensor  # [N] endgame countdown once the deck is empty
    last: LastAction
    terminal: torch.Tensor  # [N] bool


def full_deck(cfg: GameConfig, device=None) -> torch.Tensor:
    """The 50-card multiset as card codes, in (color, rank, copy) order."""
    cards = []
    for c in range(cfg.num_colors):
        for r in range(cfg.num_ranks):
            cards.extend([c * cfg.num_ranks + r] * CARDS_PER_RANK[r])
    return torch.tensor(cards, dtype=torch.long, device=device)


def card_counts(cfg: GameConfig, device=None) -> torch.Tensor:
    """[num_cards] copies of each card type in the deck."""
    counts = [CARDS_PER_RANK[r] for _ in range(cfg.num_colors) for r in range(cfg.num_ranks)]
    return torch.tensor(counts, dtype=torch.long, device=device)


def empty_last_action(cfg: GameConfig, n: int, device=None) -> LastAction:
    full = lambda v: torch.full((n,), v, dtype=torch.long, device=device)
    false = torch.zeros((n,), dtype=torch.bool, device=device)
    return LastAction(
        move_type=full(NONE),
        player=full(-1),
        target=full(-1),
        color=full(-1),
        rank=full(-1),
        reveal_mask=torch.zeros((n, cfg.hand_size), dtype=torch.bool, device=device),
        position=full(-1),
        card=full(-1),
        scored=false,
        info_add=false.clone(),
    )


def shuffled_decks(
    cfg: GameConfig, n: int, generator: Optional[torch.Generator] = None, device=None
) -> torch.Tensor:
    """[n, deck_size] independent uniform shuffles of the full deck, drawn as
    argsort(torch.rand(n, deck_size)) on the generator's device."""
    gen_device = generator.device if generator is not None else torch.device("cpu")
    keys = torch.rand(n, cfg.deck_size, generator=generator, device=gen_device)
    order = torch.argsort(keys, dim=1)
    return full_deck(cfg, gen_device)[order].to(device)


def new_game(
    cfg: GameConfig,
    n: int,
    *,
    deck: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> GameState:
    """Deal n fresh games, player 0 to move.

    deck: optional injected [n, deck_size] card codes in deal order; without
    it the decks are shuffled from `generator`. Deal order is HLE's:
    hand_size cards to player 0, then player 1, ...

    The games live on `device`, else on the injected deck's device; with
    neither, on `cuda` (raising where there is none)."""
    P, H = cfg.players, cfg.hand_size
    if deck is None:
        deck = shuffled_decks(cfg, n, generator, resolve_device(device))
    deck = torch.as_tensor(deck, dtype=torch.long, device=device)
    if deck.shape != (n, cfg.deck_size):
        raise ValueError(f"deck must be [{n}, {cfg.deck_size}], got {tuple(deck.shape)}")
    device = deck.device
    dealt = P * H
    full = lambda v: torch.full((n,), v, dtype=torch.long, device=device)
    ones = lambda d: torch.ones((n, P, H, d), dtype=torch.bool, device=device)
    zeros = lambda d: torch.zeros((n, P, H, d), dtype=torch.bool, device=device)
    return GameState(
        deck=deck,
        deck_ptr=full(dealt),
        hands=deck[:, :dealt].reshape(n, P, H).clone(),
        color_plausible=ones(cfg.num_colors),
        rank_plausible=ones(cfg.num_ranks),
        color_hinted=zeros(cfg.num_colors),
        rank_hinted=zeros(cfg.num_ranks),
        fireworks=torch.zeros((n, cfg.num_colors), dtype=torch.long, device=device),
        info=full(cfg.max_info_tokens),
        life=full(cfg.start_life),
        discards=torch.zeros((n, cfg.num_colors, cfg.num_ranks), dtype=torch.long, device=device),
        cur_player=full(0),
        turns_left=full(P),
        last=empty_last_action(cfg, n, device),
        terminal=torch.zeros((n,), dtype=torch.bool, device=device),
    )


def hand_sizes(state: GameState) -> torch.Tensor:
    """[N, P] number of cards in each hand."""
    return (state.hands >= 0).sum(dim=2)


def score(state: GameState) -> torch.Tensor:
    """[N] game score: sum of fireworks, zeroed on bomb-out (the SAD
    convention)."""
    raw = state.fireworks.sum(dim=1)
    return torch.where(state.life > 0, raw, torch.zeros_like(raw))
