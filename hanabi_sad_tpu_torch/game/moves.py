"""Move uid layout and legal-move computation (counterpart of
`hanabi_sad_tpu/game/moves.py`).

    [0, H)                      Discard(slot)
    [H, 2H)                     Play(slot)
    [2H, 2H + (P-1)*C)          RevealColor(target_offset=1+uid//C, color=uid%C)
    [.., 2H + (P-1)*(C+R))      RevealRank(target_offset, rank)
    max_moves                   no-op (only legal when nothing else is)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hanabi_sad_tpu_torch.game.config import GameConfig
from hanabi_sad_tpu_torch.game.state import (
    DISCARD,
    NO_OP,
    PLAY,
    REVEAL_COLOR,
    REVEAL_RANK,
    GameState,
)


class Move(NamedTuple):
    """Decomposed move; unused fields are arbitrary for a given type."""

    move_type: torch.Tensor
    position: torch.Tensor  # hand slot (play/discard)
    target_offset: torch.Tensor  # in [1, P) (reveal moves)
    color: torch.Tensor  # (reveal-color)
    rank: torch.Tensor  # (reveal-rank)


def decode_uid(cfg: GameConfig, uid: torch.Tensor) -> Move:
    """uid -> Move, elementwise. Integer // and % floor as in numpy."""
    H, C, R = cfg.hand_size, cfg.num_colors, cfg.num_ranks
    uid = uid.long()
    rc_base = 2 * H
    rr_base = 2 * H + (cfg.players - 1) * C
    move_type = torch.full_like(uid, NO_OP)
    move_type = torch.where(uid < cfg.max_moves, REVEAL_RANK, move_type)
    move_type = torch.where(uid < rr_base, REVEAL_COLOR, move_type)
    move_type = torch.where(uid < rc_base, PLAY, move_type)
    move_type = torch.where(uid < H, DISCARD, move_type)
    is_rc = move_type == REVEAL_COLOR
    rc_off = uid - rc_base
    rr_off = uid - rr_base
    return Move(
        move_type=move_type,
        position=torch.where(uid < H, uid, uid - H),
        target_offset=torch.where(is_rc, 1 + rc_off // C, 1 + rr_off // R),
        color=rc_off % C,
        rank=rr_off % R,
    )


def encode_uid(cfg: GameConfig, move: Move) -> torch.Tensor:
    """Move -> uid (inverse of decode_uid)."""
    H, C, R = cfg.hand_size, cfg.num_colors, cfg.num_ranks
    rc_base = 2 * H
    rr_base = 2 * H + (cfg.players - 1) * C
    t = move.move_type
    uid = torch.full_like(t, cfg.no_op_uid)
    uid = torch.where(t == REVEAL_RANK, rr_base + (move.target_offset - 1) * R + move.rank, uid)
    uid = torch.where(t == REVEAL_COLOR, rc_base + (move.target_offset - 1) * C + move.color, uid)
    uid = torch.where(t == PLAY, H + move.position, uid)
    uid = torch.where(t == DISCARD, move.position, uid)
    return uid


def legal_moves_current(cfg: GameConfig, state: GameState) -> torch.Tensor:
    """[N, num_actions] bool legal mask for the current player.

    HLE rules: discard needs an occupied slot and info < max; play needs an
    occupied slot; hints need info > 0 and a non-empty match in the target's
    hand. If nothing is legal, the no-op uid lights up."""
    P, C, R = cfg.players, cfg.num_colors, cfg.num_ranks
    n = state.hands.shape[0]
    dev = state.hands.device
    rows = torch.arange(n, device=dev)
    hand = state.hands[rows, state.cur_player]  # [N, H]
    occupied = hand >= 0
    discard_ok = occupied & (state.info < cfg.max_info_tokens)[:, None]
    play_ok = occupied

    offsets = torch.arange(1, P, device=dev)
    targets = (state.cur_player[:, None] + offsets) % P  # [N, P-1]
    target_hands = state.hands[rows[:, None], targets]  # [N, P-1, H]
    t_occ = target_hands >= 0
    minus1 = torch.full_like(target_hands, -1)
    t_colors = torch.where(t_occ, target_hands // R, minus1)
    t_ranks = torch.where(t_occ, target_hands % R, minus1)
    has_info = (state.info > 0)[:, None, None]
    color_present = (t_colors[..., None] == torch.arange(C, device=dev)).any(dim=2)
    rank_present = (t_ranks[..., None] == torch.arange(R, device=dev)).any(dim=2)
    rc_ok = (color_present & has_info).reshape(n, -1)
    rr_ok = (rank_present & has_info).reshape(n, -1)

    real = torch.cat([discard_ok, play_ok, rc_ok, rr_ok], dim=1)
    no_op = ~real.any(dim=1, keepdim=True)
    return torch.cat([real, no_op], dim=1)


def legal_moves_all(cfg: GameConfig, state: GameState) -> torch.Tensor:
    """[N, P, num_actions] legal mask per player: the current player gets the
    real mask, everyone else (and everyone in a terminal state) only the
    no-op."""
    P, A = cfg.players, cfg.num_actions
    dev = state.hands.device
    cur_mask = legal_moves_current(cfg, state)  # [N, A]
    noop_only = torch.zeros((A,), dtype=torch.bool, device=dev)
    noop_only[cfg.no_op_uid] = True
    is_cur = torch.arange(P, device=dev) == state.cur_player[:, None]  # [N, P]
    is_cur = is_cur & ~state.terminal[:, None]
    return torch.where(is_cur[..., None], cur_mask[:, None, :], noop_only)
