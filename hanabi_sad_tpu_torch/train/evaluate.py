"""Batched evaluation harness (counterpart of `hanabi_sad_tpu/train/evaluate.py`).

evaluate(policies, ...) plays num_game greedy games with one policy per seat
and returns (mean score, perfect rate, scores, num_perfect)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from hanabi_sad_tpu_torch.device import resolve_device
from hanabi_sad_tpu_torch.game.config import GameConfig
from hanabi_sad_tpu_torch.game.env import EnvConfig
from hanabi_sad_tpu_torch.game.state import shuffled_decks
from hanabi_sad_tpu_torch.rollout import runner


def evaluate(
    policies: Sequence,  # List[EvalPolicy], one per seat
    num_game: int,
    seed: int,
    bomb: int = 0,
    *,
    hand_size: int = 5,
    num_steps: int = 128,
    decks: Optional[torch.Tensor] = None,
    device=None,
):
    """decks: optional injected [num_game, 50] card codes; without them the
    decks are shuffled from a CPU torch.Generator seeded with `seed`, so a
    seed deals the same games on every device."""
    device = resolve_device(device)
    num_player = len(policies)
    sad = policies[0].sad
    if any(p.sad != sad for p in policies):
        raise ValueError("mixed sad/non-sad seats")
    env_cfg = EnvConfig(
        game=GameConfig(players=num_player, hand_size=hand_size, bomb=bomb),
        eps_list=(0.0,),
        max_len=-1,
        sad=sad,
    )
    if decks is None:
        generator = torch.Generator().manual_seed(seed)
        decks = shuffled_decks(env_cfg.game, num_game, generator)
    decks = decks.to(device)
    scores, done = runner.eval_rollout(
        [p.params for p in policies],
        [p.agent_cfg for p in policies],
        env_cfg,
        decks,
        num_steps=num_steps,
        act_fns=[p.act_fn for p in policies],
    )
    # Eval games have no forced-termination forfeit, so num_steps must cover
    # the longest game or the mean would count truncated games.
    if not bool(done.all()):
        raise RuntimeError("eval games did not finish; raise num_steps")
    scores = scores.cpu().numpy()
    num_perfect = int((scores == 25).sum())
    return float(scores.mean()), num_perfect / len(scores), scores.tolist(), num_perfect
