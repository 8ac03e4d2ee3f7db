"""The aligned rollout of the trainer and the greedy evaluation rollout
(counterpart of `hanabi_sad_tpu/rollout/runner.py`).

Python loops of `num_steps` steps where the JAX package used lax.scan.

Aligned mode (`run_episode_chunk`): all N envs reset together and run
`num_steps` steps in lockstep. Training forces termination at max_len, so
with num_steps == max_len every env plays exactly one episode a chunk; an
env that ends early freezes and its tail becomes zero padding. Then
`chunk_to_episodes` computes n-step returns and bootstrap flags over the
whole chunk and, for IQL, splits each env's trajectory into one item per
player (env-major); VDN keeps the joint [P] item. The trainer's other
rollout, with auto-resetting envs, is `continuous.py`.

Evaluation (`eval_rollout`) runs greedy, with a done-latch and no forced
termination.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from hanabi_sad_tpu_torch.agent import r2d2_agent
from hanabi_sad_tpu_torch.agent.r2d2_agent import AgentConfig, AgentParams, Batch
from hanabi_sad_tpu_torch.game import env as env_mod
from hanabi_sad_tpu_torch.game.env import EnvConfig
from hanabi_sad_tpu_torch.parallel.mesh import SINGLE, Shard
from hanabi_sad_tpu_torch.replay.prioritized import EpisodeBatch


class RolloutOutput(NamedTuple):
    """Per-step records of one aligned chunk, time-major [T, N, ...]."""

    priv_s: torch.Tensor  # [T, N, P, F]
    legal_move: torch.Tensor  # [T, N, P, A]
    own_hand: torch.Tensor  # [T, N, P, 3*hand]
    action: torch.Tensor  # [T, N, P] int64
    greedy_a: torch.Tensor  # [T, N, P] int64
    qa: torch.Tensor  # [T, N, P] online dueling Q of the taken action
    reward: torch.Tensor  # [T, N] raw per-step reward
    done: torch.Tensor  # [T, N] done *after* this step
    last_score: torch.Tensor  # [N] final episode scores


@torch.no_grad()
def run_episode_chunk(
    params: AgentParams,
    agent_cfg: AgentConfig,
    env_cfg: EnvConfig,
    num_envs: int,
    num_steps: int,
    *,
    generator: Optional[torch.Generator] = None,
    decks: Optional[torch.Tensor] = None,
    color_perm: Optional[torch.Tensor] = None,
    device=None,
    shard: Shard = SINGLE,
) -> RolloutOutput:
    """Reset num_envs envs and roll num_steps steps of epsilon-greedy
    self-play with the online net (`act` with its Q: one B1 call a step on
    the card). For training num_steps == env_cfg.max_len, so the chunk
    covers exactly one full (padded) episode per env.

    The decks, eps and permutations (in `reset_state`'s order), the explore
    draws and, with shuffle_obs, the hand shuffles of every observe come from
    `generator`; decks [N, deck_size] and color_perm [N, P, C] may be
    injected. With a shard the num_envs envs are this rank's rows and every
    draw is made over all ranks' envs. Runs on `device` (default: the
    decks', else `cuda`)."""
    P = env_cfg.game.players
    env_state, obs = env_mod.reset(
        env_cfg, num_envs, decks=decks, color_perm=color_perm, generator=generator, device=device, shard=shard
    )
    hidden = r2d2_agent.init_hidden(agent_cfg, num_envs, P, env_state.done.device)
    recs = []
    for _ in range(num_steps):
        reply, hidden = r2d2_agent.act(params, agent_cfg, obs, hidden, generator, return_q=True, shard=shard)
        rec = (obs["priv_s"], obs["legal_move"], obs["own_hand"], reply["a"], reply["greedy_a"], reply["qa"])
        env_state, obs, reward, done = env_mod.step(
            env_cfg, env_state, {"a": reply["a"], "greedy_a": reply["greedy_a"]}, generator=generator, shard=shard
        )
        recs.append(rec + (reward, done))
    fields = [torch.stack(x) for x in zip(*recs)]
    return RolloutOutput(*fields, last_score=env_state.last_score)


def _n_step_process(
    reward: torch.Tensor, done: torch.Tensor, multi_step: int, gamma: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """From per-step rewards and done-after flags [T, N]: (n-step reward
    [T, N], bootstrap [T, N], seq_len [N] f32). reward_t = sum_{k<n}
    gamma^k r_{t+k} (rewards after the terminal are zero); bootstrap_t = 1
    iff no terminal lies inside [t, t + n)."""
    T, N = reward.shape
    n = multi_step
    was_done = torch.cat([torch.zeros((1, N), dtype=torch.bool, device=done.device), done[:-1]])
    valid = ~was_done  # step t belongs to the episode
    seq_len = valid.sum(0).float()

    r = reward * valid
    padded = torch.cat([r, r.new_zeros((n, N))])
    n_step_r = torch.zeros_like(r)
    for k in range(n):
        n_step_r = n_step_r + (gamma ** k) * padded[k : k + T]

    t_idx = torch.arange(T, dtype=torch.float32, device=reward.device)[:, None]
    bootstrap = (t_idx < seq_len[None, :] - n).float()
    return n_step_r, bootstrap, seq_len


def _valid_steps(seq_len: torch.Tensor, T: int) -> torch.Tensor:
    """[T, N] bool: step t lies inside the episode."""
    return torch.arange(T, dtype=torch.float32, device=seq_len.device)[:, None] < seq_len[None, :]


def chunk_to_episodes(out: RolloutOutput, agent_cfg: AgentConfig) -> EpisodeBatch:
    """A chunk as replay items [M, T, Pi, ...]: M = N and Pi = P (VDN), or
    M = N * P and Pi = 1 (IQL: one item per player, env-major, then player).
    Padding steps are zeroed."""
    T, N, P = out.action.shape
    n_step_r, bootstrap, seq_len = _n_step_process(out.reward, out.done, agent_cfg.multi_step, agent_cfg.gamma)
    valid = _valid_steps(seq_len, T)
    pad_mask = lambda x: x * valid.reshape((T, N) + (1,) * (x.dim() - 2)).to(x.dtype)

    priv_s = pad_mask(out.priv_s)
    legal = pad_mask(out.legal_move)
    own_hand = pad_mask(out.own_hand)
    action = out.action * valid[..., None].long()

    to_item_major = lambda x: x.transpose(0, 1)  # [T, N, ...] -> [N, T, ...]
    if agent_cfg.vdn:
        return EpisodeBatch(
            priv_s=to_item_major(priv_s),
            legal_move=to_item_major(legal),
            own_hand=to_item_major(own_hand),
            action=to_item_major(action),
            reward=to_item_major(n_step_r),
            bootstrap=to_item_major(bootstrap),
            seq_len=seq_len,
        )

    def split_players(x):  # [T, N, P, ...] -> [N * P, T, 1, ...]
        x = x.transpose(0, 1).transpose(1, 2)  # [N, P, T, ...]
        return x.reshape((N * P, T, 1) + tuple(x.shape[3:]))

    # shared per-env fields repeat per player, in split_players' item order
    rep = lambda x: to_item_major(x).repeat_interleave(P, dim=0)
    return EpisodeBatch(
        priv_s=split_players(priv_s),
        legal_move=split_players(legal),
        own_hand=split_players(own_hand),
        action=split_players(action),
        reward=rep(n_step_r),
        bootstrap=rep(bootstrap),
        seq_len=seq_len.repeat_interleave(P),
    )


def rollout_priority_inputs(out: RolloutOutput, agent_cfg: AgentConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(online_qa [T, M], greedy_a [T, M, Pi]) in chunk_to_episodes' item
    order, for compute_priority_from_rollout. Padding steps' Q is zero."""
    T, N, P = out.action.shape
    _, _, seq_len = _n_step_process(out.reward, out.done, agent_cfg.multi_step, agent_cfg.gamma)
    qa = out.qa * _valid_steps(seq_len, T)[..., None]
    if agent_cfg.vdn:
        return qa.sum(-1), out.greedy_a
    return qa.reshape(T, N * P), out.greedy_a.reshape(T, N * P, 1)


def episodes_to_batch(ep: EpisodeBatch) -> Batch:
    """An EpisodeBatch as a time-major learner Batch, for the initial
    priorities of fresh episodes."""
    T = ep.priv_s.shape[1]
    tm = lambda x: x.transpose(0, 1)
    t_idx = torch.arange(T, dtype=torch.float32, device=ep.seq_len.device)[:, None]
    return Batch(
        priv_s=tm(ep.priv_s),
        legal_move=tm(ep.legal_move),
        action=tm(ep.action),
        own_hand=tm(ep.own_hand),
        reward=tm(ep.reward),
        terminal=(t_idx >= ep.seq_len[None, :] - 1).float(),
        bootstrap=tm(ep.bootstrap),
        seq_len=ep.seq_len,
    )


@torch.no_grad()
def eval_rollout(
    params_per_player: Sequence[AgentParams],
    agent_cfgs: Sequence[AgentConfig],
    env_cfg: EnvConfig,
    decks: torch.Tensor,
    num_steps: int = 128,
    act_fns: Optional[Sequence] = None,
    return_actions: bool = False,
    color_perm: Optional[torch.Tensor] = None,
    shard: Shard = SINGLE,
):
    """Greedy evaluation of N games, one per deck of decks [N, deck_size]:
    eps = 0, no forced termination (pass env_cfg with max_len <= 0), and a
    done-latch until all games finish. Different params per seat make this
    the cross-play harness. Runs on the decks' device.

    act_fns optionally overrides the per-seat act function (signature of
    r2d2_agent.act; with a shard of more than one rank it is also given
    `shard=`). With a shard the N games are this rank's rows, and the eps,
    permutation, explore and hand-shuffle draws are made over all ranks'
    games. With env_cfg.shuffle_color each seat sees the game
    through its row of color_perm [N, P, C] (drawn from a generator seeded 0
    when not given); with env_cfg.shuffle_obs the hand shuffles come from
    that generator.

    Returns (scores [N], done [N]); with return_actions also the applied
    action [T, N] and the done flag before each step [T, N]."""
    N = decks.shape[0]
    P = env_cfg.game.players
    if len(params_per_player) != P:
        raise ValueError(f"need {P} seats of params, got {len(params_per_player)}")
    if act_fns is None:
        act_fns = [r2d2_agent.act] * P
    device = decks.device

    # eps == 0, so the generator's draws never decide an action.
    generator = torch.Generator(device=device).manual_seed(0)
    env_state, obs = env_mod.reset(env_cfg, N, decks=decks, color_perm=color_perm, generator=generator, shard=shard)
    sharded = {} if shard.world == 1 else {"shard": shard}
    hiddens = [r2d2_agent.init_hidden(cfg, N, 1, device) for cfg in agent_cfgs]
    zero_eps = torch.zeros((N, 1), device=device)
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
                params_per_player[p], agent_cfgs[p], p_obs, hiddens[p], generator, **sharded
            )
            actions.append(reply["a"][:, 0])
            greedy.append(reply["greedy_a"][:, 0])
        action = {"a": torch.stack(actions, 1), "greedy_a": torch.stack(greedy, 1)}
        if return_actions:
            was_done_steps.append(env_state.done)
            applied_steps.append(action["a"].gather(1, env_state.game.cur_player[:, None])[:, 0])
        env_state, obs, _, _ = env_mod.step(env_cfg, env_state, action, generator=generator, shard=shard)

    if return_actions:
        return (
            env_state.last_score,
            env_state.done,
            torch.stack(applied_steps),
            torch.stack(was_done_steps),
        )
    return env_state.last_score, env_state.done
