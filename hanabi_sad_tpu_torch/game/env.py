"""Batched Hanabi environment (counterpart of `hanabi_sad_tpu/game/env.py`).

Semantics matched to the JAX package:
  * actions are submitted for all players, only the current player's applies;
  * SAD mode records the outcome of the submitted greedy action on the
    pre-move state and encodes it as an extra last-action block in the next
    observation;
  * per-player epsilon is drawn uniformly from the eps menu at reset;
  * with max_len > 0, the episode is force-terminated after max_len steps and
    the reward forfeits all points;
  * stepping a done env is a frozen no-op with zero reward;
  * Other-Play (`shuffle_color`) draws a color permutation per seat at reset,
    one uniform seat keeping the identity: each observer sees every color
    feature and its legal hint colors relabelled by its own permutation, and
    a submitted hint color (the acting move's and, in SAD mode, the greedy
    move's) is mapped back through the current player's inverse. The SAD
    record keeps the true color; each observer relabels it when encoding;
  * `shuffle_obs` (2 players): every encode shows each observer the
    partner's occupied hand slots in a fresh uniform order (empty slots stay
    a suffix), in the hands, card-knowledge and last-action sections;
  * `hide_action` zeroes the last-action section (the SAD block stays).

Randomness (decks, eps, then permutations, each drawn only when its option is
on) comes from an explicit torch.Generator, or the decks, the permutations
and the hand shuffles (or, for the auto-resetting step, the whole fresh
state) are injected. With `shuffle_color` off the permutations are the
identity and nothing reads them. With a `shard` (`parallel/mesh.py`) the
envs are one rank's rows of a data-parallel run: every draw is made over all
ranks' envs and the rank keeps its rows, so each rank sees the rows of the
draw that one process stepping every env would make.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from hanabi_sad_tpu_torch.device import resolve_device
from hanabi_sad_tpu_torch.game import encoder, moves
from hanabi_sad_tpu_torch.game.config import GameConfig
from hanabi_sad_tpu_torch.game.engine import apply_move, freeze, move_outcome
from hanabi_sad_tpu_torch.game.state import (
    REVEAL_COLOR,
    GameState,
    LastAction,
    empty_last_action,
    new_game,
    score,
)
from hanabi_sad_tpu_torch.parallel.mesh import SINGLE, Shard


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
        if self.shuffle_obs and self.game.players != 2:
            # The reference's shuffle is "hacked for 2 players".
            raise ValueError("shuffle_obs requires 2 players")

    @property
    def feature_size(self) -> int:
        return self.game.feature_size(self.sad)


class EnvState(NamedTuple):
    game: GameState
    num_step: torch.Tensor  # [N]
    done: torch.Tensor  # [N] bool: game terminal OR forced termination
    player_eps: torch.Tensor  # [N, P] f32
    color_perm: torch.Tensor  # [N, P, C] int64; perm[c] = displayed color of true c
    sad_record: LastAction  # greedy-action outcome for the SAD channel
    last_score: torch.Tensor  # [N], score frozen at termination; -1 until then


Obs = Dict[str, torch.Tensor]


def _gen_device(generator: Optional[torch.Generator]) -> torch.device:
    return generator.device if generator is not None else torch.device("cpu")


def sample_perms(
    g: GameConfig, n: int, generator: Optional[torch.Generator] = None, device=None, shard: Shard = SINGLE
) -> torch.Tensor:
    """[n, P, C] Other-Play color permutations: one uniform seat per env
    keeps the identity, every other seat a uniform permutation (the JAX
    package's `_sample_perms`). Drawn from `generator`, stored on `device`
    (default: the generator's)."""
    P, C = g.players, g.num_colors
    gen_device = _gen_device(generator)
    keep = shard.take(torch.randint(P, (shard.total(n),), generator=generator, device=gen_device))
    perms = shard.take(torch.rand((shard.total(n), P, C), generator=generator, device=gen_device)).argsort(dim=-1)
    identity = torch.arange(C, device=gen_device).expand(n, P, C)
    seat = torch.arange(P, device=gen_device)[None, :, None]
    return torch.where(seat == keep[:, None, None], identity, perms).to(device or gen_device)


def identity_perms(g: GameConfig, n: int, device=None) -> torch.Tensor:
    return torch.arange(g.num_colors, device=device).expand(n, g.players, g.num_colors).contiguous()


def sample_hand_shuffles(
    g: GameConfig, state: GameState, generator: Optional[torch.Generator] = None, shard: Shard = SINGLE
) -> torch.Tensor:
    """[N, P, H]: for each observer a fresh uniform permutation of the
    partner's occupied slots, the empty slots kept as a suffix in order (a
    stable argsort of uniform scores, infinity on empty slots)."""
    n, P, H = state.hands.shape
    partner = state.hands[:, [(p + 1) % P for p in range(P)]]  # [N, P, H]
    scores = torch.rand((shard.total(n), P, H), generator=generator, device=_gen_device(generator))
    scores = shard.take(scores).to(partner.device)
    scores = torch.where(partner >= 0, scores, torch.inf)
    return scores.argsort(dim=-1, stable=True)


def observe(
    cfg: EnvConfig,
    state: EnvState,
    *,
    generator: Optional[torch.Generator] = None,
    hand_shuffle: Optional[torch.Tensor] = None,
    shard: Shard = SINGLE,
) -> Obs:
    """Per-player observations, shapes [N, P, ...]. With shuffle_obs the
    partner-hand shuffles ([N, P, H], one per observer) are `hand_shuffle`
    or else drawn from `generator`."""
    g = cfg.game
    n = state.done.shape[0]
    dev = state.done.device
    seats = [torch.full((n,), p, dtype=torch.long, device=dev) for p in range(g.players)]
    perms = [state.color_perm[:, p] if cfg.shuffle_color else None for p in range(g.players)]
    if cfg.shuffle_obs and hand_shuffle is None:
        hand_shuffle = sample_hand_shuffles(g, state.game, generator, shard)
    shuffles = [None if hand_shuffle is None else hand_shuffle[:, p] for p in range(g.players)]
    priv = [
        encoder.encode_observation(g, state.game, s, perm, shuf, hide_action=cfg.hide_action)
        for s, perm, shuf in zip(seats, perms, shuffles)
    ]
    if cfg.sad:
        priv = [
            torch.cat([o, encoder.encode_last_action(g, state.sad_record, s, perm, shuf)], dim=1)
            for o, s, perm, shuf in zip(priv, seats, perms, shuffles)
        ]
    legal = moves.legal_moves_all(g, state.game)
    if cfg.shuffle_color:
        legal = moves.permute_hint_colors(g, legal, state.color_perm)
    own_hand = [encoder.encode_own_hand_trinary(g, state.game, s) for s in seats]
    return {
        "priv_s": torch.stack(priv, dim=1),
        "legal_move": legal.to(torch.float32),
        "eps": state.player_eps,
        "own_hand": torch.stack(own_hand, dim=1),
    }


def reset_state(
    cfg: EnvConfig,
    n: int,
    *,
    decks: Optional[torch.Tensor] = None,
    color_perm: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
    shard: Shard = SINGLE,
) -> EnvState:
    """n fresh envs; reset() without the observation encode. Device as in
    `new_game`. The color permutations are `color_perm` ([n, P, C]), else
    drawn from `generator` after the decks and eps when shuffle_color is on,
    else the identity."""
    g = cfg.game
    game = new_game(g, n, deck=decks, generator=generator, device=device, shard=shard)
    dev = game.deck.device
    eps_idx = torch.randint(
        len(cfg.eps_list), (shard.total(n), g.players), generator=generator, device=_gen_device(generator)
    )
    eps_idx = shard.take(eps_idx).to(dev)
    eps_menu = torch.tensor(cfg.eps_list, dtype=torch.float32, device=dev)
    if color_perm is None:
        color_perm = sample_perms(g, n, generator, dev, shard) if cfg.shuffle_color else identity_perms(g, n, dev)
    return EnvState(
        game=game,
        num_step=torch.zeros((n,), dtype=torch.long, device=dev),
        done=torch.zeros((n,), dtype=torch.bool, device=dev),
        player_eps=eps_menu[eps_idx],
        color_perm=color_perm.to(dev).long(),
        sad_record=empty_last_action(g, n, dev),
        last_score=torch.full((n,), -1, dtype=torch.long, device=dev),
    )


def reset(cfg: EnvConfig, n: int, **kwargs) -> Tuple[EnvState, Obs]:
    """reset_state, then observe (shuffle_obs draws from the same generator)."""
    state = reset_state(cfg, n, **kwargs)
    return state, observe(cfg, state, generator=kwargs.get("generator"), shard=kwargs.get("shard", SINGLE))


def step(
    cfg: EnvConfig,
    state: EnvState,
    action: Dict[str, torch.Tensor],
    *,
    generator: Optional[torch.Generator] = None,
    hand_shuffle: Optional[torch.Tensor] = None,
    shard: Shard = SINGLE,
):
    """One env step. action = {"a": [N, P], "greedy_a": [N, P]} (greedy_a only
    read in SAD mode). Returns (state, obs, reward, done). `generator`,
    `hand_shuffle` and `shard` are observe()'s."""
    new_state, reward, done = step_state(cfg, state, action)
    obs = observe(cfg, new_state, generator=generator, hand_shuffle=hand_shuffle, shard=shard)
    return new_state, obs, reward, done


def _true_color(move: moves.Move, inv_perm: Optional[torch.Tensor]) -> moves.Move:
    """The move with a hinted color, as the mover saw it, mapped back to the
    true color through the mover's inverse permutation inv_perm [N, C]
    (None: colors are not permuted)."""
    if inv_perm is None:
        return move
    true = inv_perm.gather(1, move.color[:, None])[:, 0]
    return move._replace(color=torch.where(move.move_type == REVEAL_COLOR, true, move.color))


def step_state(cfg: EnvConfig, state: EnvState, action: Dict[str, torch.Tensor]):
    """step() without the observation encode."""
    g = cfg.game
    cur = state.game.cur_player[:, None]
    prev_score = score(state.game)
    inv_cur = None
    if cfg.shuffle_color:
        inv_cur = state.color_perm[torch.arange(cur.shape[0], device=cur.device), cur[:, 0]].argsort(dim=1)

    move = _true_color(moves.decode_uid(g, action["a"].gather(1, cur)[:, 0]), inv_cur)
    if cfg.sad:
        gmove = _true_color(moves.decode_uid(g, action["greedy_a"].gather(1, cur)[:, 0]), inv_cur)
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
        color_perm=state.color_perm,
        sad_record=sad_record,
        last_score=last_score,
    )
    return new_state, reward, done


def step_autoreset(
    cfg: EnvConfig,
    state: EnvState,
    action: Dict[str, torch.Tensor],
    *,
    generator: Optional[torch.Generator] = None,
    fresh: Optional[EnvState] = None,
    hand_shuffle: Optional[torch.Tensor] = None,
    shard: Shard = SINGLE,
):
    """step() with immediate auto-reset: an env whose episode this step ends
    is replaced by a freshly reset one (new deck, new eps, new permutations),
    so no frame idles.

    The fresh states come from `fresh` ([N] envs, injected by tests) or else
    from `reset_state` with `generator` (all N drawn, the done ones kept;
    with a shard, all ranks' envs). The observation is encoded once, from the
    selected state; with shuffle_obs its shuffles are `hand_shuffle` or drawn
    from `generator`.

    Returns (state, obs, reward, done, score): `done` flags that THIS step
    ended an episode (the returned state is already the next one) and
    `score` is the finished episode's final score (valid where done)."""
    stepped, reward, done = step_state(cfg, state, action)
    if fresh is None:
        fresh = reset_state(cfg, done.shape[0], generator=generator, device=done.device, shard=shard)
    new_state = _select(done, fresh, stepped)
    obs = observe(cfg, new_state, generator=generator, hand_shuffle=hand_shuffle, shard=shard)
    return new_state, obs, reward, done, stepped.last_score


def _select(flag: torch.Tensor, a, b):
    """where(flag, a, b) over every tensor of two like-shaped NamedTuples,
    flag [N] broadcast over each tensor's trailing axes."""
    if isinstance(a, tuple):
        return type(a)(*(_select(flag, x, y) for x, y in zip(a, b)))
    return torch.where(flag.reshape(flag.shape + (1,) * (a.dim() - 1)), a, b)


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
        color_perm: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        return reset(self.cfg, n, decks=decks, color_perm=color_perm, generator=generator, device=self.device)

    def step(self, state: EnvState, action: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None):
        return step(self.cfg, state, action, generator=generator)
