"""Batched Hanabi environment (counterpart of `hanabi_sad_tpu/game/env.py`).

Semantics matched to the JAX package:
  * actions are submitted for all players, only the current player's applies;
  * SAD mode records the outcome of the submitted greedy action on the
    pre-move state and encodes it as an extra last-action block in the next
    observation;
  * per-player epsilon is drawn uniformly from the eps menu at reset;
  * with max_len > 0, the episode is force-terminated after max_len steps and
    the reward forfeits all points;
  * stepping a done env is a frozen no-op with zero reward.

Randomness (decks, eps) comes from an explicit torch.Generator, or the decks
are injected. Not ported yet: Other-Play color shuffles, shuffled
observations, hidden actions and the auto-resetting step of the trainer.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from hanabi_sad_tpu_torch.device import resolve_device
from hanabi_sad_tpu_torch.game import encoder, moves
from hanabi_sad_tpu_torch.game.config import GameConfig
from hanabi_sad_tpu_torch.game.engine import apply_move, freeze, move_outcome
from hanabi_sad_tpu_torch.game.state import GameState, LastAction, empty_last_action, new_game, score


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    game: GameConfig = GameConfig()
    eps_list: Tuple[float, ...] = (0.0,)
    max_len: int = 80  # <= 0 means no forced termination
    sad: bool = False
    shuffle_color: bool = False
    shuffle_obs: bool = False
    hide_action: bool = False

    def __post_init__(self):
        for flag in ("shuffle_color", "shuffle_obs", "hide_action"):
            if getattr(self, flag):
                raise NotImplementedError(f"{flag} is not ported yet")

    @property
    def feature_size(self) -> int:
        return self.game.feature_size(self.sad)


class EnvState(NamedTuple):
    game: GameState
    num_step: torch.Tensor  # [N]
    done: torch.Tensor  # [N] bool: game terminal OR forced termination
    player_eps: torch.Tensor  # [N, P] f32
    sad_record: LastAction  # greedy-action outcome for the SAD channel
    last_score: torch.Tensor  # [N], score frozen at termination; -1 until then


Obs = Dict[str, torch.Tensor]


def observe(cfg: EnvConfig, state: EnvState) -> Obs:
    """Per-player observations, shapes [N, P, ...]."""
    g = cfg.game
    n = state.done.shape[0]
    dev = state.done.device
    seats = [torch.full((n,), p, dtype=torch.long, device=dev) for p in range(g.players)]
    priv = [encoder.encode_observation(g, state.game, s) for s in seats]
    if cfg.sad:
        priv = [
            torch.cat([o, encoder.encode_last_action(g, state.sad_record, s)], dim=1)
            for o, s in zip(priv, seats)
        ]
    own_hand = [encoder.encode_own_hand_trinary(g, state.game, s) for s in seats]
    return {
        "priv_s": torch.stack(priv, dim=1),
        "legal_move": moves.legal_moves_all(g, state.game).to(torch.float32),
        "eps": state.player_eps,
        "own_hand": torch.stack(own_hand, dim=1),
    }


def reset_state(
    cfg: EnvConfig,
    n: int,
    *,
    decks: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> EnvState:
    """n fresh envs; reset() without the observation encode. Device as in
    `new_game`."""
    g = cfg.game
    game = new_game(g, n, deck=decks, generator=generator, device=device)
    dev = game.deck.device
    gen_device = generator.device if generator is not None else torch.device("cpu")
    eps_idx = torch.randint(
        len(cfg.eps_list), (n, g.players), generator=generator, device=gen_device
    ).to(dev)
    eps_menu = torch.tensor(cfg.eps_list, dtype=torch.float32, device=dev)
    return EnvState(
        game=game,
        num_step=torch.zeros((n,), dtype=torch.long, device=dev),
        done=torch.zeros((n,), dtype=torch.bool, device=dev),
        player_eps=eps_menu[eps_idx],
        sad_record=empty_last_action(g, n, dev),
        last_score=torch.full((n,), -1, dtype=torch.long, device=dev),
    )


def reset(cfg: EnvConfig, n: int, **kwargs) -> Tuple[EnvState, Obs]:
    state = reset_state(cfg, n, **kwargs)
    return state, observe(cfg, state)


def step(cfg: EnvConfig, state: EnvState, action: Dict[str, torch.Tensor]):
    """One env step. action = {"a": [N, P], "greedy_a": [N, P]} (greedy_a only
    read in SAD mode). Returns (state, obs, reward, done)."""
    new_state, reward, done = step_state(cfg, state, action)
    return new_state, observe(cfg, new_state), reward, done


def step_state(cfg: EnvConfig, state: EnvState, action: Dict[str, torch.Tensor]):
    """step() without the observation encode."""
    g = cfg.game
    cur = state.game.cur_player[:, None]
    prev_score = score(state.game)

    move = moves.decode_uid(g, action["a"].gather(1, cur)[:, 0])
    if cfg.sad:
        gmove = moves.decode_uid(g, action["greedy_a"].gather(1, cur)[:, 0])
        # The record stays frozen while the env is done (padding steps).
        sad_record = freeze(state.done, state.sad_record, move_outcome(g, state.game, gmove))
    else:
        sad_record = state.sad_record

    new_game_state = apply_move(g, state.game, move)
    num_step = state.num_step + (~state.done).long()
    new_score = score(new_game_state)
    reward = (new_score - prev_score).to(torch.float32)
    # Forced termination forfeits all points, even if the game also ended
    # naturally on this exact step.
    forced = (num_step >= cfg.max_len) if cfg.max_len > 0 else torch.zeros_like(state.done)
    reward = torch.where(forced, -prev_score.to(torch.float32), reward)
    reward = torch.where(state.done, torch.zeros_like(reward), reward)
    done = state.done | new_game_state.terminal | forced
    last_score = torch.where(done & ~state.done, new_score, state.last_score)

    new_state = EnvState(
        game=new_game_state,
        num_step=num_step,
        done=done,
        player_eps=state.player_eps,
        sad_record=sad_record,
        last_score=last_score,
    )
    return new_state, reward, done


class HanabiEnv:
    """Batched facade over reset/step for N independent games on one device."""

    def __init__(self, cfg: EnvConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    @property
    def feature_size(self) -> int:
        return self.cfg.feature_size

    @property
    def num_actions(self) -> int:
        return self.cfg.game.num_actions

    def reset(
        self,
        n: int,
        *,
        decks: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        return reset(self.cfg, n, decks=decks, generator=generator, device=self.device)

    def step(self, state: EnvState, action: Dict[str, torch.Tensor]):
        return step(self.cfg, state, action)
