"""Canonical observation encoder on a batch of games (counterpart of
`hanabi_sad_tpu/game/encoder.py`).

The exact bit layout of the hengyuan-hu HLE fork's
CanonicalObservationEncoder:

  per-player observation (2p / hand 5 -> 783):
    hands          players*(hand_size*25 + 1)   = 252   own hand zeroed
    board          (50 - P*H) + 25 + 8 + 3      = 76    deck/fireworks/info/life
    discards       50                                   per-(color,rank) thermometer
    last action    2P + 4 + 5 + 5 + 2H + 25 + 2 = 55
    card knowledge P*H*(25+5+5)                 = 350   V0 plausible + direct hints
  SAD appends one more last-action block for the partner's greedy action -> 838.

Only the identity color permutation is supported: Other-Play's color
shuffle, shuffled observations and hidden actions are not ported yet.
`observer` arguments are [N] seat tensors; every function returns float32
0/1 features with a leading env axis.
"""

from __future__ import annotations

import torch

from hanabi_sad_tpu_torch.game.config import CARDS_PER_RANK, GameConfig
from hanabi_sad_tpu_torch.game.engine import move_outcome
from hanabi_sad_tpu_torch.game.moves import Move
from hanabi_sad_tpu_torch.game.state import (
    DISCARD,
    PLAY,
    REVEAL_COLOR,
    REVEAL_RANK,
    GameState,
    LastAction,
)

F32 = torch.float32


def _card_onehot(cfg: GameConfig, card: torch.Tensor) -> torch.Tensor:
    """[..., num_cards] one-hot of card code; empty (-1) encodes as zeros."""
    return (card[..., None] == torch.arange(cfg.num_cards, device=card.device)).to(F32)


def _thermometer(value: torch.Tensor, length: int) -> torch.Tensor:
    """[N, length]: the first value[n] bits set."""
    return (torch.arange(length, device=value.device) < value[:, None]).to(F32)


def _relative_seats(cfg: GameConfig, observer: torch.Tensor) -> torch.Tensor:
    """[N, P] absolute seat of each relative slot, starting at the observer."""
    return (observer[:, None] + torch.arange(cfg.players, device=observer.device)) % cfg.players


def _by_seat(arr: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
    """arr [N, P, ...] re-indexed by rel [N, P]."""
    return arr[torch.arange(arr.shape[0], device=arr.device)[:, None], rel]


def encode_hands(cfg: GameConfig, state: GameState, observer: torch.Tensor) -> torch.Tensor:
    """Hands section. Players in relative order starting at the observer; the
    observer's own card block is zeroed. Trailing P bits flag hands holding
    fewer than hand_size cards."""
    n = state.hands.shape[0]
    hands = _by_seat(state.hands, _relative_seats(cfg, observer))  # [N, P, H]
    onehots = _card_onehot(cfg, hands)  # [N, P, H, 25]
    onehots[:, 0] = 0.0  # relative slot 0 is the observer
    short = ((hands >= 0).sum(dim=2) < cfg.hand_size).to(F32)  # [N, P]
    return torch.cat([onehots.reshape(n, -1), short], dim=1)


def encode_board(cfg: GameConfig, state: GameState) -> torch.Tensor:
    P, H, R = cfg.players, cfg.hand_size, cfg.num_ranks
    n = state.hands.shape[0]
    deck_bits = _thermometer(cfg.deck_size - state.deck_ptr, cfg.deck_size - P * H)
    # Fireworks: per color, one-hot of (height - 1); height 0 = zeros.
    fw = state.fireworks
    fw_bits = (torch.arange(R, device=fw.device) == (fw[..., None] - 1)).to(F32).reshape(n, -1)
    info_bits = _thermometer(state.info, cfg.max_info_tokens)
    life_bits = _thermometer(state.life, cfg.max_life_tokens)
    return torch.cat([deck_bits, fw_bits, info_bits, life_bits], dim=1)


def encode_discards(cfg: GameConfig, state: GameState) -> torch.Tensor:
    """Per color, per rank, a thermometer over that rank's copy count
    (3/2/2/2/1 bits)."""
    counts = state.discards  # [N, C, R]
    bits = [
        (torch.arange(copies, device=counts.device) < counts[:, :, r : r + 1]).to(F32)
        for r, copies in enumerate(CARDS_PER_RANK[: cfg.num_ranks])
    ]
    return torch.cat(bits, dim=2).reshape(counts.shape[0], -1)


def encode_last_action(cfg: GameConfig, last: LastAction, observer: torch.Tensor) -> torch.Tensor:
    """Last (non-deal) action section; zeros if no move has been made yet."""
    P, H, C, R = cfg.players, cfg.hand_size, cfg.num_colors, cfg.num_ranks
    dev = observer.device
    t = last.move_type
    valid = (t < 4)[:, None]  # NONE / NO_OP encode as zeros
    seats = torch.arange(P, device=dev)
    actor_bits = (seats == ((last.player - observer) % P)[:, None]) & valid

    # Move type one-hot in encoder order: play, discard, reveal-color, reveal-rank.
    type_bits = torch.stack(
        [t == PLAY, t == DISCARD, t == REVEAL_COLOR, t == REVEAL_RANK], dim=1
    )
    is_reveal = ((t == REVEAL_COLOR) | (t == REVEAL_RANK))[:, None]
    target_bits = (seats == ((last.target - observer) % P)[:, None]) & is_reveal
    color_bits = torch.arange(C, device=dev) == last.color[:, None]
    rank_bits = torch.arange(R, device=dev) == last.rank[:, None]
    reveal_bits = last.reveal_mask & is_reveal
    is_pd = ((t == PLAY) | (t == DISCARD))[:, None]
    pos_bits = (torch.arange(H, device=dev) == last.position[:, None]) & is_pd
    card = torch.where(is_pd[:, 0], last.card, torch.full_like(last.card, -1))
    bits = [actor_bits, type_bits, target_bits, color_bits, rank_bits, reveal_bits, pos_bits]
    return torch.cat(
        [b.to(F32) for b in bits]
        + [_card_onehot(cfg, card), last.scored[:, None].to(F32), last.info_add[:, None].to(F32)],
        dim=1,
    )


def encode_knowledge(cfg: GameConfig, state: GameState, observer: torch.Tensor) -> torch.Tensor:
    """Card-knowledge section: per relative player, per slot, 25 plausible bits
    (outer product of hint-derived color/rank plausibility), 5 direct
    color-hint bits, 5 direct rank-hint bits. Empty slots are all zero."""
    n = state.hands.shape[0]
    rel = _relative_seats(cfg, observer)
    occupied = (_by_seat(state.hands, rel) >= 0)[..., None]  # [N, P, H, 1]
    cp = _by_seat(state.color_plausible, rel)
    rp = _by_seat(state.rank_plausible, rel)
    ch = _by_seat(state.color_hinted, rel)
    rh = _by_seat(state.rank_hinted, rel)
    plausible = cp[..., :, None] & rp[..., None, :] & occupied[..., None]  # [N, P, H, C, R]
    per_slot = torch.cat(
        [plausible.flatten(-2), ch & occupied, rh & occupied], dim=-1
    )  # [N, P, H, 35]
    return per_slot.reshape(n, -1).to(F32)


def encode_observation(cfg: GameConfig, state: GameState, observer: torch.Tensor) -> torch.Tensor:
    """[N, obs_dim] full per-player canonical observation (783 for 2p),
    before SAD."""
    return torch.cat(
        [
            encode_hands(cfg, state, observer),
            encode_board(cfg, state),
            encode_discards(cfg, state),
            encode_last_action(cfg, state.last, observer),
            encode_knowledge(cfg, state, observer),
        ],
        dim=1,
    )


def encode_own_hand_trinary(cfg: GameConfig, state: GameState, player: torch.Tensor) -> torch.Tensor:
    """[N, 3*hand_size] aux-task target: per own card slot, one-hot over
    {playable now, useless (rank already played), neither}; empty slots all
    zero."""
    R = cfg.num_ranks
    n = state.hands.shape[0]
    hand = state.hands[torch.arange(n, device=player.device), player]  # [N, H]
    occ = hand >= 0
    color = torch.clamp(hand, min=0) // R
    rank = torch.clamp(hand, min=0) % R
    fw = state.fireworks.gather(1, color)
    playable = occ & (rank == fw)
    useless = occ & (rank < fw)
    neither = occ & ~playable & ~useless
    return torch.stack([playable, useless, neither], dim=-1).to(F32).reshape(n, -1)


def greedy_action_channel(
    cfg: GameConfig, state: GameState, greedy_move: Move, observer: torch.Tensor
) -> torch.Tensor:
    """The SAD channel: last-action encoding of the partner's greedy move as
    if it were applied to the pre-move state."""
    return encode_last_action(cfg, move_outcome(cfg, state, greedy_move), observer)
