"""Batched evaluation harness (counterpart of `hanabi_sad_tpu/train/evaluate.py`).

evaluate(policies, ...) plays num_game greedy games with one policy per seat
and returns (mean score, perfect rate, scores, num_perfect), and with
return_actions also the applied actions and done flags. On W data-parallel
ranks (`mesh`) each rank plays its num_game / W of the same games and every
rank returns the results of all of them."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from hanabi_sad_tpu_torch.device import resolve_device
from hanabi_sad_tpu_torch.game.config import GameConfig
from hanabi_sad_tpu_torch.game.env import EnvConfig, sample_perms
from hanabi_sad_tpu_torch.game.state import shuffled_decks
from hanabi_sad_tpu_torch.parallel import mesh as mesh_mod
from hanabi_sad_tpu_torch.parallel.mesh import Mesh
from hanabi_sad_tpu_torch.rollout import runner

# The color permutations of an eval come from a CPU generator seeded with
# seed + PERM_SEED_TAG, never from the deck generator: the same seed deals the
# same decks with and without shuffle_color, so a relabelled eval pairs
# game by game with the plain one.
PERM_SEED_TAG = 0x0C0102


def evaluate(
    policies: Sequence,  # List[EvalPolicy], one per seat
    num_game: int,
    seed: int,
    bomb: int = 0,
    *,
    hand_size: int = 5,
    num_steps: int = 128,
    decks: Optional[torch.Tensor] = None,
    shuffle_color: bool = False,
    color_perm: Optional[torch.Tensor] = None,
    shuffle_obs: bool = False,
    return_actions: bool = False,
    device=None,
    mesh: Mesh = Mesh(),
):
    """decks: optional injected [num_game, 50] card codes; without them the
    decks are shuffled from a CPU torch.Generator seeded with `seed`, so a
    seed deals the same games on every device.

    shuffle_color: each seat observes the game through its own random color
    permutation (Other-Play's cross-play under relabelling; one seat keeps
    the identity), `color_perm` [num_game, P, C] if given, else drawn from a
    CPU generator seeded with seed + PERM_SEED_TAG. shuffle_obs: shuffled
    partner hands, as the trainer's eval of a shuffle_obs run sees them.

    return_actions: also return, as numpy arrays, the action applied at each
    step [num_steps, num_game] and whether the game was already done before
    it [num_steps, num_game], as the JAX function does.

    mesh: the ranks of a data-parallel run. The decks and permutations are
    the whole num_game's, as above, on every rank; rank r plays games
    [r num_game / W, (r + 1) num_game / W) (num_game must divide by W), its
    rollout's draws made over all games, and the ranks all-gather the
    results, so every rank returns what one process playing every game
    returns."""
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
        shuffle_color=shuffle_color,
        shuffle_obs=shuffle_obs,
    )
    if decks is None:
        generator = torch.Generator().manual_seed(seed)
        decks = shuffled_decks(env_cfg.game, num_game, generator)
    decks = decks.to(device)
    if shuffle_color and color_perm is None:
        color_perm = sample_perms(env_cfg.game, decks.shape[0], torch.Generator().manual_seed(seed + PERM_SEED_TAG))
    mesh_mod.check_divisible(mesh, num_game=decks.shape[0])
    shard = mesh.shard
    out = runner.eval_rollout(
        [p.params for p in policies],
        [p.agent_cfg for p in policies],
        env_cfg,
        shard.take(decks),
        num_steps=num_steps,
        act_fns=[p.act_fn for p in policies],
        color_perm=None if color_perm is None else shard.take(color_perm.to(device)),
        return_actions=return_actions,
        shard=shard,
    )
    if mesh.world > 1:
        # every game's results on every rank: a row per game, the time-major
        # fields transposed to rows and back
        rows = mesh_mod.all_gather_rows([out[0], out[1]] + [x.t() for x in out[2:]], mesh)
        out = tuple(rows[:2]) + tuple(x.t() for x in rows[2:])
    scores, done = out[:2]
    # Eval games have no forced-termination forfeit, so num_steps must cover
    # the longest game or the mean would count truncated games.
    if not bool(done.all()):
        raise RuntimeError("eval games did not finish; raise num_steps")
    scores = scores.cpu().numpy()
    num_perfect = int((scores == 25).sum())
    base = (float(scores.mean()), num_perfect / len(scores), scores.tolist(), num_perfect)
    if return_actions:
        return base + tuple(x.cpu().numpy() for x in out[2:])
    return base
