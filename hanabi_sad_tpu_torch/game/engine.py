"""Core Hanabi rules on a batch of games (counterpart of
`hanabi_sad_tpu/game/engine.py`).

  * play/discard remove a card (hand shifts left), then draw from the deck
    (appended at the end of the hand);
  * hints consume an info token and update the target's plausible/hinted
    knowledge masks;
  * once the deck is empty every player gets exactly one more move;
  * terminal when life <= 0, score == 25, or the countdown is exhausted.

Indexing by player, slot and color is plain tensor indexing over the env
axis; every function returns new tensors and never writes its inputs.
"""

from __future__ import annotations

import torch

from hanabi_sad_tpu_torch.game.config import GameConfig
from hanabi_sad_tpu_torch.game.moves import Move
from hanabi_sad_tpu_torch.game.state import (
    DISCARD,
    PLAY,
    REVEAL_COLOR,
    REVEAL_RANK,
    GameState,
    LastAction,
)


def _set_rows(arr: torch.Tensor, player: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """A copy of arr [N, P, ...] with arr[n, player[n]] = value[n]."""
    out = arr.clone()
    out[torch.arange(arr.shape[0], device=arr.device), player] = value
    return out


def _rows(arr: torch.Tensor, player: torch.Tensor) -> torch.Tensor:
    """arr[n, player[n]] for arr [N, P, ...]."""
    return arr[torch.arange(arr.shape[0], device=arr.device), player]


def _remove_and_draw(
    cfg: GameConfig, state: GameState, player: torch.Tensor, pos: torch.Tensor, do: torch.Tensor
):
    """Remove hands[n, player, pos], shift left, draw a card to the end if the
    deck has one. `do` [N] gates the whole operation (False for hint/no-op
    moves). Returns (hands, color_plausible, rank_plausible, color_hinted,
    rank_hinted, deck_ptr)."""
    H = cfg.hand_size
    idx = torch.arange(H, device=pos.device)
    # Source slot for each slot after removing `pos`; the last slot empties.
    src = torch.where(idx >= pos[:, None], torch.clamp(idx + 1, max=H - 1), idx)  # [N, H]
    shifted_valid = (idx < H - 1) | (idx < pos[:, None])

    hand = _rows(state.hands, player)  # [N, H]
    new_hand = torch.where(shifted_valid, hand.gather(1, src), torch.full_like(hand, -1))

    old_size = (hand >= 0).sum(dim=1)
    can_draw = state.deck_ptr < cfg.deck_size  # [N]
    draw_card = state.deck.gather(1, torch.clamp(state.deck_ptr, max=cfg.deck_size - 1)[:, None])
    at_slot = (idx == (old_size - 1)[:, None]) & can_draw[:, None]  # [N, H]
    new_hand = torch.where(at_slot, draw_card, new_hand)

    def shift_k(k_all, fresh):  # [N, P, H, D]: the player's rows, shifted, drawn slot reset
        k = _rows(k_all, player)
        k_src = k.gather(1, src[:, :, None].expand(-1, -1, k.shape[2]))
        k_new = k_src & shifted_valid[:, :, None]
        k_new = torch.where(at_slot[:, :, None], fresh, k_new)
        return _set_rows(k_all, player, torch.where(do[:, None, None], k_new, k))

    hands = _set_rows(state.hands, player, torch.where(do[:, None], new_hand, hand))
    deck_ptr = state.deck_ptr + (do & can_draw).long()
    return (
        hands,
        shift_k(state.color_plausible, True),
        shift_k(state.rank_plausible, True),
        shift_k(state.color_hinted, False),
        shift_k(state.rank_hinted, False),
        deck_ptr,
    )


def move_outcome(cfg: GameConfig, state: GameState, move: Move) -> LastAction:
    """The LastAction record that applying `move` to `state` would produce;
    a pure function of the pre-move state, used both for the real move and
    for the SAD greedy-action channel."""
    R = cfg.num_ranks
    player = state.cur_player
    target = (player + move.target_offset) % cfg.players
    t = move.move_type

    is_pd = (t == PLAY) | (t == DISCARD)
    pos = torch.clamp(move.position, 0, cfg.hand_size - 1)
    held = _rows(state.hands, player).gather(1, pos[:, None])[:, 0]
    card = torch.where(is_pd, held, torch.full_like(held, -1))
    ccolor = torch.clamp(card, min=0) // R
    crank = torch.clamp(card, min=0) % R

    scored = (t == PLAY) & (card >= 0) & (state.fireworks.gather(1, ccolor[:, None])[:, 0] == crank)
    info_add = scored & (crank == R - 1) & (state.info < cfg.max_info_tokens)

    t_hand = _rows(state.hands, target)
    t_occ = t_hand >= 0
    color_match = t_occ & (t_hand // R == move.color[:, None])
    rank_match = t_occ & (t_hand % R == move.rank[:, None])
    reveal_mask = (color_match & (t == REVEAL_COLOR)[:, None]) | (
        rank_match & (t == REVEAL_RANK)[:, None]
    )

    is_reveal = (t == REVEAL_COLOR) | (t == REVEAL_RANK)
    minus1 = torch.full_like(player, -1)
    return LastAction(
        move_type=t,
        player=player,
        target=torch.where(is_reveal, target, minus1),
        color=torch.where(t == REVEAL_COLOR, move.color, minus1),
        rank=torch.where(t == REVEAL_RANK, move.rank, minus1),
        reveal_mask=reveal_mask,
        position=torch.where(is_pd, pos, minus1),
        card=card,
        scored=scored,
        info_add=info_add,
    )


def freeze(frozen: torch.Tensor, old, new):
    """where(frozen, old, new) over every field of a NamedTuple (recursing
    into nested ones), broadcasting the [N] flag over trailing axes."""
    if isinstance(old, tuple):
        return type(old)(*(freeze(frozen, o, n) for o, n in zip(old, new)))
    flag = frozen.reshape(frozen.shape + (1,) * (old.dim() - 1))
    return torch.where(flag, old, new)


def apply_move(cfg: GameConfig, state: GameState, move: Move) -> GameState:
    """Apply a (legal) move for the current player. Terminal states pass
    through unchanged."""
    P, R = cfg.players, cfg.num_ranks
    player = state.cur_player
    last = move_outcome(cfg, state, move)
    t = move.move_type
    is_play = t == PLAY
    is_discard = t == DISCARD
    is_rc = t == REVEAL_COLOR
    is_rr = t == REVEAL_RANK
    rows = torch.arange(player.shape[0], device=player.device)

    # Endgame countdown: decremented once the deck is empty, before the move
    # applies (so exactly P moves happen after exhaustion).
    turns_left = state.turns_left - (state.deck_ptr >= cfg.deck_size).long()

    card = last.card
    ccolor = torch.clamp(card, min=0) // R
    crank = torch.clamp(card, min=0) % R
    scored = last.scored
    fireworks = state.fireworks.clone()
    fireworks[rows, ccolor] += scored.long()
    failed_play = is_play & (card >= 0) & ~scored
    life = state.life - failed_play.long()
    to_discard = (is_discard & (card >= 0)) | failed_play
    discards = state.discards.clone()
    discards[rows, ccolor, crank] += to_discard.long()
    info = state.info + is_discard.long() + last.info_add.long() - (is_rc | is_rr).long()
    info = torch.clamp(info, 0, cfg.max_info_tokens)

    hands, color_plausible, rank_plausible, color_hinted, rank_hinted, deck_ptr = (
        _remove_and_draw(
            cfg, state, player, torch.clamp(move.position, 0, cfg.hand_size - 1), is_play | is_discard
        )
    )

    # Hint knowledge on the target's hand: touched slots collapse to the
    # hinted value, untouched ones rule it out; only occupied slots change.
    target = (player + move.target_offset) % P
    t_hand = _rows(state.hands, target)
    t_occ = t_hand >= 0

    def hint(plausible, hinted, match, onehot, applies):
        p_t = _rows(plausible, target)
        h_t = _rows(hinted, target)
        p_new = torch.where(match[..., None], p_t & onehot, p_t & ~onehot)
        p_new = torch.where(t_occ[..., None], p_new, p_t)
        h_new = h_t | (match[..., None] & onehot)
        on = applies[:, None, None]
        return (
            _set_rows(plausible, target, torch.where(on, p_new, p_t)),
            _set_rows(hinted, target, torch.where(on, h_new, h_t)),
        )

    dev = player.device
    c_onehot = (torch.arange(cfg.num_colors, device=dev) == move.color[:, None])[:, None, :]
    r_onehot = (torch.arange(cfg.num_ranks, device=dev) == move.rank[:, None])[:, None, :]
    c_match = t_occ & (t_hand // R == move.color[:, None])
    r_match = t_occ & (t_hand % R == move.rank[:, None])
    color_plausible, color_hinted = hint(color_plausible, color_hinted, c_match, c_onehot, is_rc)
    rank_plausible, rank_hinted = hint(rank_plausible, rank_hinted, r_match, r_onehot, is_rr)

    raw = fireworks.sum(dim=1)
    new_score = torch.where(life > 0, raw, torch.zeros_like(raw))
    terminal = (life <= 0) | (new_score >= cfg.max_score) | (turns_left <= 0)

    new_state = GameState(
        deck=state.deck,
        deck_ptr=deck_ptr,
        hands=hands,
        color_plausible=color_plausible,
        rank_plausible=rank_plausible,
        color_hinted=color_hinted,
        rank_hinted=rank_hinted,
        fireworks=fireworks,
        info=info,
        life=life,
        discards=discards,
        cur_player=(player + 1) % P,
        turns_left=turns_left,
        last=last,
        terminal=terminal,
    )
    # A terminal state is frozen: applying a move to it changes nothing.
    return freeze(state.terminal, state, new_state)
