"""Greedy evaluation rollout (counterpart of
`hanabi_sad_tpu/rollout/runner.py:eval_rollout`).

A Python loop of `num_steps` steps where the JAX package used lax.scan.
The training rollouts come with the training slice.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from hanabi_sad_tpu_torch.agent import r2d2_agent
from hanabi_sad_tpu_torch.agent.r2d2_agent import AgentConfig, AgentParams
from hanabi_sad_tpu_torch.game import env as env_mod
from hanabi_sad_tpu_torch.game.env import EnvConfig


@torch.no_grad()
def eval_rollout(
    params_per_player: Sequence[AgentParams],
    agent_cfgs: Sequence[AgentConfig],
    env_cfg: EnvConfig,
    decks: torch.Tensor,
    num_steps: int = 128,
    act_fns: Optional[Sequence] = None,
    return_actions: bool = False,
):
    """Greedy evaluation of N games, one per deck of decks [N, deck_size]:
    eps = 0, no forced termination (pass env_cfg with max_len <= 0), and a
    done-latch until all games finish. Different params per seat make this
    the cross-play harness. Runs on the decks' device.

    act_fns optionally overrides the per-seat act function (signature of
    r2d2_agent.act).

    Returns (scores [N], done [N]); with return_actions also the applied
    action [T, N] and the done flag before each step [T, N]."""
    N = decks.shape[0]
    P = env_cfg.game.players
    if len(params_per_player) != P:
        raise ValueError(f"need {P} seats of params, got {len(params_per_player)}")
    if act_fns is None:
        act_fns = [r2d2_agent.act] * P
    device = decks.device

    env_state, obs = env_mod.reset(env_cfg, N, decks=decks)
    hiddens = [r2d2_agent.init_hidden(cfg, N, 1, device) for cfg in agent_cfgs]
    zero_eps = torch.zeros((N, 1), device=device)
    # eps == 0, so the generator's draws never decide an action.
    generator = torch.Generator(device=device).manual_seed(0)
    applied_steps, was_done_steps = [], []
    for _ in range(num_steps):
        actions, greedy = [], []
        for p in range(P):
            p_obs = {
                "priv_s": obs["priv_s"][:, p : p + 1],
                "legal_move": obs["legal_move"][:, p : p + 1],
                "eps": zero_eps,
            }
            reply, hiddens[p] = act_fns[p](
                params_per_player[p], agent_cfgs[p], p_obs, hiddens[p], generator
            )
            actions.append(reply["a"][:, 0])
            greedy.append(reply["greedy_a"][:, 0])
        action = {"a": torch.stack(actions, 1), "greedy_a": torch.stack(greedy, 1)}
        if return_actions:
            was_done_steps.append(env_state.done)
            applied_steps.append(action["a"].gather(1, env_state.game.cur_player[:, None])[:, 0])
        env_state, obs, _, _ = env_mod.step(env_cfg, env_state, action)

    if return_actions:
        return (
            env_state.last_score,
            env_state.done,
            torch.stack(applied_steps),
            torch.stack(was_done_steps),
        )
    return env_state.last_score, env_state.done
