"""Continuous rollout: auto-resetting envs, no idle frames (counterpart of
`hanabi_sad_tpu/rollout/continuous.py`).

Envs reset the moment an episode ends, every step is a live frame, and
episodes are re-assembled from the step stream afterwards.

Per chunk of T steps (T = max_len):
  1. a Python loop of act_with_target (or plain act when the actor carries
     no target stream) -> step_autoreset; the per-step record is stored
     bitpacked; episode boundaries are the done flags;
  2. assemble: each env's stream is cut at its done positions; segment 0 is
     glued onto the env's carried partial episode from the previous chunk;
     the unfinished tail becomes the next carry. Completed episodes land in
     up to `slots_per_env` fixed slots per env (overflow episodes are dropped
     and counted);
  3. for IQL, each slot split into one item per player (split_players);
  4. n-step returns, bootstrap and initial priorities, then
     replay.add_packed with slot validity compaction. The priorities are the
     exact online-target ones from the rollout's own online and target Q
     streams (fused_exact_priorities), or from a separate target-net
     sequence forward over the assembled slots (exact_episode_priorities), or
     the online-online approximation (episode_priorities).

An episode takes at most max_len steps, so every chunk completes >= 1
episode per env and the carry never exceeds T-1 steps. Where the JAX package
selected stream steps with one-hot contractions (a TPU workaround), the port
indexes.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from hanabi_sad_tpu_torch.agent import r2d2_agent
from hanabi_sad_tpu_torch.agent.r2d2_agent import AgentConfig, AgentParams
from hanabi_sad_tpu_torch.game import env as env_mod
from hanabi_sad_tpu_torch.game.env import EnvConfig, EnvState
from hanabi_sad_tpu_torch.parallel.mesh import SINGLE, Shard
from hanabi_sad_tpu_torch.replay.bitpack import pack_bits, unpack_bits
from hanabi_sad_tpu_torch.replay.prioritized import ReplayConfig


class ActorState(NamedTuple):
    """Persistent actor-side state carried across chunks."""

    env_state: EnvState  # batched [N]
    obs: Dict[str, torch.Tensor]
    hidden: r2d2_agent.Hidden
    # carried partial episode per env (bitpacked steps)
    carry_packed: torch.Tensor  # [N, T, P, bytes] uint8
    carry_action: torch.Tensor  # [N, T, P] int64
    carry_greedy: torch.Tensor  # [N, T, P] int64
    carry_qa: torch.Tensor  # [N, T, P] f32
    carry_reward: torch.Tensor  # [N, T] f32
    carry_len: torch.Tensor  # [N] int64
    # Set when the rollout also advances the target net for the fused exact
    # priorities: the target hidden and the carried target-greedy Q stream.
    target_hidden: Optional[r2d2_agent.Hidden] = None
    carry_tqa: Optional[torch.Tensor] = None  # [N, T, P] f32


class StreamChunk(NamedTuple):
    """Per-step records of one continuous chunk, time-major [T, N, ...]."""

    packed: torch.Tensor  # [T, N, P, bytes] uint8
    action: torch.Tensor  # [T, N, P] int64
    greedy: torch.Tensor  # [T, N, P] int64
    qa: torch.Tensor  # [T, N, P] f32
    reward: torch.Tensor  # [T, N] f32
    done: torch.Tensor  # [T, N] bool
    score: torch.Tensor  # [T, N] int64 (episode score where done)
    tqa: Optional[torch.Tensor] = None  # [T, N, P] f32 target-greedy Q, or None


def init_actor_state(
    agent_cfg: AgentConfig,
    env_cfg: EnvConfig,
    rep_cfg: ReplayConfig,
    num_envs: int,
    *,
    generator: Optional[torch.Generator] = None,
    decks: Optional[torch.Tensor] = None,
    with_target_qa: bool = True,
    device=None,
) -> ActorState:
    """num_envs freshly reset envs (decks from `generator`, or injected),
    a zero online hidden and empty carries; with_target_qa adds the target
    net's zero hidden and Q carry (for fused_exact_priorities)."""
    N, P, T = num_envs, env_cfg.game.players, rep_cfg.seq_len
    env_state, obs = env_mod.reset(env_cfg, N, decks=decks, generator=generator, device=device)
    dev = env_state.done.device
    zeros = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device=dev)
    return ActorState(
        env_state=env_state,
        obs=obs,
        hidden=r2d2_agent.init_hidden(agent_cfg, N, P, dev),
        carry_packed=zeros(N, T, P, rep_cfg.bytes_per_step, dtype=torch.uint8),
        carry_action=zeros(N, T, P, dtype=torch.long),
        carry_greedy=zeros(N, T, P, dtype=torch.long),
        carry_qa=zeros(N, T, P),
        carry_reward=zeros(N, T),
        carry_len=zeros(N, dtype=torch.long),
        target_hidden=r2d2_agent.init_hidden(agent_cfg, N, P, dev) if with_target_qa else None,
        carry_tqa=zeros(N, T, P) if with_target_qa else None,
    )


@torch.no_grad()
def run_continuous_chunk(
    params: AgentParams,
    agent_cfg: AgentConfig,
    env_cfg: EnvConfig,
    actor: ActorState,
    num_steps: int,
    generator: Optional[torch.Generator] = None,
    shard: Shard = SINGLE,
) -> Tuple[ActorState, StreamChunk]:
    """Roll num_steps live steps from the persistent actor state. Explore
    draws, fresh decks, eps, permutations and hand shuffles come from
    `generator`, over all ranks' envs with a shard (the actor holds this
    rank's rows, `parallel/mesh.py`). An actor with a target hidden steps both nets
    (act_with_target) and records their Q streams; one without steps the
    online net alone (act with its Q) and records no tqa."""
    env_state, obs = actor.env_state, actor.obs
    hidden, t_hidden = actor.hidden, actor.target_hidden
    with_target = t_hidden is not None
    recs = []
    for _ in range(num_steps):
        if with_target:
            reply, hidden, t_hidden = r2d2_agent.act_with_target(
                params, agent_cfg, obs, hidden, t_hidden, generator, shard
            )
        else:
            reply, hidden = r2d2_agent.act(params, agent_cfg, obs, hidden, generator, return_q=True, shard=shard)
        bits = torch.cat([obs["priv_s"], obs["legal_move"], obs["own_hand"]], dim=-1)
        env_state, obs, reward, done, score = env_mod.step_autoreset(
            env_cfg, env_state, {"a": reply["a"], "greedy_a": reply["greedy_a"]},
            generator=generator, shard=shard,
        )
        hidden = r2d2_agent.reset_hidden_where(done, hidden)
        rec = (pack_bits(bits), reply["a"], reply["greedy_a"], reply["qa"], reward, done, score)
        if with_target:
            t_hidden = r2d2_agent.reset_hidden_where(done, t_hidden)
            rec = rec + (reply["tqa"],)
        recs.append(rec)
    stream = StreamChunk(*(torch.stack(x) for x in zip(*recs)))
    actor = actor._replace(env_state=env_state, obs=obs, hidden=hidden, target_hidden=t_hidden)
    return actor, stream


class AssembledEpisodes(NamedTuple):
    """Fixed [M] episode slots (M = N * slots_per_env), compaction-ready."""

    packed: torch.Tensor  # [M, T, P, bytes]
    action: torch.Tensor  # [M, T, P]
    greedy: torch.Tensor  # [M, T, P]
    qa: torch.Tensor  # [M, T, P]
    reward: torch.Tensor  # [M, T] raw per-step rewards
    seq_len: torch.Tensor  # [M] f32
    valid: torch.Tensor  # [M] bool
    dropped: torch.Tensor  # scalar int64: completed episodes beyond the slot cap
    score_sum: torch.Tensor  # scalar f32, sum of completed-episode scores
    num_completed: torch.Tensor  # scalar int64
    tqa: Optional[torch.Tensor] = None  # [M, T, P] target-greedy Q, or None


def _where(mask: torch.Tensor, a: torch.Tensor, b) -> torch.Tensor:
    """where(mask, a, b) with mask broadcast over a's trailing axes."""
    mask = mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim()))
    return torch.where(mask, a, b)


@torch.no_grad()
def assemble_episodes(
    actor: ActorState, stream: StreamChunk, slots_per_env: int
) -> Tuple[ActorState, AssembledEpisodes]:
    """Cut the stream at episode boundaries, glue segment 0 onto the carry,
    fill fixed episode slots, and roll the unfinished tail into the new carry."""
    T, N = stream.done.shape
    K = slots_per_env
    Tcap = actor.carry_packed.shape[1]  # == max episode length
    dev = stream.done.device

    done = stream.done  # [T, N]
    n_done = done.long().sum(0)  # [N]

    # position of the i-th done per env: sort (t if done else T)
    t_idx = torch.arange(T, device=dev)[:, None]
    done_pos = torch.sort(torch.where(done, t_idx, T), dim=0).values  # [T, N]
    # start of segment e (e in [0, K)): 0 for e=0 else done_pos[e-1]+1
    starts = torch.cat([torch.zeros((1, N), dtype=torch.long, device=dev), done_pos[: K - 1] + 1])
    ends = done_pos[:K]  # [K, N] inclusive; == T when the segment is incomplete
    k_idx = torch.arange(K, device=dev)[:, None]
    seg_complete = k_idx < n_done[None, :]  # [K, N]
    seg_len = torch.where(seg_complete, ends - starts + 1, 0)
    pre_len = torch.where(k_idx == 0, actor.carry_len[None, :], 0)  # [K, N]
    full_len = seg_len + torch.where(seg_complete, pre_len, 0)

    # slot (e, n) position j comes from carry[j] if j < pre, else from
    # stream[starts + j - pre]
    j_idx = torch.arange(Tcap, device=dev)[None, None, :]  # [1, 1, Tc]
    pre = pre_len[:, :, None]
    from_carry = j_idx < pre  # [K, N, Tc]
    src_t = torch.clamp(starts[:, :, None] + j_idx - pre, 0, T - 1)
    in_ep = (j_idx < full_len[:, :, None]) & seg_complete[:, :, None]
    env_ids = torch.arange(N, device=dev)[None, :, None]

    def gather(stream_arr, carry_arr):
        # stream_arr [T, N, ...], carry_arr [N, Tc, ...] -> [K, N, Tc, ...]
        s = stream_arr[src_t, env_ids]
        out = _where(from_carry, carry_arr[None].expand_as(s), s)
        return _where(in_ep, out, torch.zeros((), dtype=out.dtype, device=dev))

    # flatten slots env-major: slot id = n * K + e
    flat = lambda x: x.transpose(0, 1).reshape((N * K,) + tuple(x.shape[2:]))
    episodes = AssembledEpisodes(
        packed=flat(gather(stream.packed, actor.carry_packed)),
        action=flat(gather(stream.action, actor.carry_action)),
        greedy=flat(gather(stream.greedy, actor.carry_greedy)),
        qa=flat(gather(stream.qa, actor.carry_qa)),
        tqa=None if stream.tqa is None else flat(gather(stream.tqa, actor.carry_tqa)),
        reward=flat(gather(stream.reward, actor.carry_reward)),
        seq_len=flat(full_len).float(),
        valid=flat(seg_complete),
        dropped=torch.clamp(n_done - K, min=0).sum(),
        score_sum=torch.where(done, stream.score, 0).sum().float(),
        num_completed=n_done.sum(),
    )

    # ---- new carry: the unfinished tail (segment n_done) ----
    last_done = done_pos.gather(0, torch.clamp(n_done - 1, min=0)[None, :])[0]
    tail_start = torch.where(n_done > 0, last_done + 1, 0)  # [N]
    tail_len = T - tail_start
    jc = torch.arange(Tcap, device=dev)[None, :]  # [1, Tc]
    # if n_done == 0 the whole chunk extends the old carry
    old_pre = torch.where(n_done > 0, 0, actor.carry_len)[:, None]  # [N, 1]
    new_len = torch.clamp(old_pre[:, 0] + tail_len, max=Tcap)
    from_old = jc < old_pre  # [N, Tc]
    src_tail = torch.clamp(tail_start[:, None] + jc - old_pre, 0, T - 1)
    in_carry = jc < new_len[:, None]
    rows = torch.arange(N, device=dev)[:, None]

    def carry_gather(stream_arr, carry_arr):
        s = stream_arr[src_tail, rows]  # [N, Tc, ...]
        out = _where(from_old, carry_arr[:, :Tcap], s)
        return _where(in_carry, out, torch.zeros((), dtype=out.dtype, device=dev))

    actor = actor._replace(
        carry_packed=carry_gather(stream.packed, actor.carry_packed),
        carry_action=carry_gather(stream.action, actor.carry_action),
        carry_greedy=carry_gather(stream.greedy, actor.carry_greedy),
        carry_qa=carry_gather(stream.qa, actor.carry_qa),
        carry_tqa=None if stream.tqa is None else carry_gather(stream.tqa, actor.carry_tqa),
        carry_reward=carry_gather(stream.reward, actor.carry_reward),
        carry_len=new_len,
    )
    return actor, episodes


def split_players(ep: AssembledEpisodes) -> AssembledEpisodes:
    """IQL item topology: each slot becomes P independent per-player items,
    env-major, then player (the JAX package's `split_players`). Per-player
    fields become [M * P, T, 1, ...]; reward, seq_len and valid repeat."""
    M, T, P = ep.action.shape

    def per_player(x):  # [M, T, P, ...] -> [M * P, T, 1, ...]
        x = x.transpose(1, 2)  # [M, P, T, ...]
        return x.reshape((M * P, T, 1) + tuple(x.shape[3:]))

    rep = lambda x: x.repeat_interleave(P, dim=0)
    return ep._replace(
        packed=per_player(ep.packed), action=per_player(ep.action), greedy=per_player(ep.greedy),
        qa=per_player(ep.qa), tqa=None if ep.tqa is None else per_player(ep.tqa),
        reward=rep(ep.reward), seq_len=rep(ep.seq_len), valid=rep(ep.valid),
    )


def _per_slot(x: torch.Tensor, cfg: AgentConfig) -> torch.Tensor:
    """[M, T, P] per-player Q -> [M, T]: the VDN sum, or the one seat."""
    return x.sum(-1) if cfg.vdn else x[..., 0]


def fused_exact_priorities(
    episodes: AssembledEpisodes,
    agent_cfg: AgentConfig,
    n_step_r: torch.Tensor,
    bootstrap: torch.Tensor,
) -> torch.Tensor:
    """Exact online-target initial priorities [M] from the rollout's own
    target-Q stream (episodes.tqa, recorded by act_with_target): the
    quantity a separate full-sequence target forward would give, at no
    extra forward."""
    M, T = episodes.reward.shape
    if agent_cfg.uniform_priority:
        return torch.ones((M,), device=episodes.reward.device)
    n, gamma = agent_cfg.multi_step, agent_cfg.gamma
    seq_len = episodes.seq_len
    tqa = _per_slot(episodes.tqa, agent_cfg)
    tqa_next = torch.cat([tqa[:, n:], torch.zeros_like(tqa[:, :n])], dim=1)
    target = n_step_r + bootstrap * (gamma ** n) * tqa_next
    qa = _per_slot(episodes.qa, agent_cfg)
    return _aggregate(target - qa, seq_len, agent_cfg.eta)


def exact_episode_priorities(
    params: AgentParams,
    agent_cfg: AgentConfig,
    replay_cfg: ReplayConfig,
    episodes: AssembledEpisodes,
    n_step_r: torch.Tensor,
    bootstrap: torch.Tensor,
) -> torch.Tensor:
    """Exact online-target initial priorities [M] with a separate target-net
    zero-h0 full-sequence forward over every assembled slot, invalid ones
    included (add_packed drops their priorities), through
    r2d2_agent.compute_priority_from_rollout; the online side is the
    rollout's own Q values. The forward is one B1 call over [T, M * Pi] rows
    on the card."""
    M, T, Pi = episodes.action.shape
    F, A = replay_cfg.obs_dim, replay_cfg.num_actions
    bits = unpack_bits(episodes.packed, replay_cfg.bits_per_step)  # [M, T, Pi, bits]
    tm = lambda x: x.transpose(0, 1)  # [M, T, ...] -> [T, M, ...]
    seq_len = torch.clamp(episodes.seq_len, min=1.0)
    t_idx = torch.arange(T, dtype=torch.float32, device=seq_len.device)[:, None]
    batch = r2d2_agent.Batch(
        priv_s=tm(bits[..., :F]),
        legal_move=tm(bits[..., F : F + A]),
        action=tm(episodes.action),
        own_hand=tm(bits[..., F + A :]),
        reward=tm(n_step_r),
        terminal=(t_idx >= seq_len[None, :] - 1).float(),
        bootstrap=tm(bootstrap),
        seq_len=seq_len,
    )
    qa = tm(_per_slot(episodes.qa, agent_cfg))
    return r2d2_agent.compute_priority_from_rollout(params, agent_cfg, batch, qa, tm(episodes.greedy))


def _aggregate(err: torch.Tensor, seq_len: torch.Tensor, eta: float) -> torch.Tensor:
    """eta * max + (1 - eta) * mean of |err| [M, T] over each slot's valid
    steps."""
    T = err.shape[1]
    t_idx = torch.arange(T, dtype=torch.float32, device=err.device)[None, :]
    err = err.abs() * (t_idx < seq_len[:, None]).float()
    p_mean = err.sum(1) / torch.clamp(seq_len, min=1.0)
    return eta * err.max(1).values + (1 - eta) * p_mean


def episode_priorities(
    episodes: AssembledEpisodes, agent_cfg: AgentConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(n_step_reward [M, T], bootstrap [M, T], priority [M]) from the
    assembled slots; the priority is the online-online approximation from
    the rollout's own Q values (fused_exact_priorities replaces it)."""
    M, T = episodes.reward.shape
    n, gamma = agent_cfg.multi_step, agent_cfg.gamma
    seq_len = episodes.seq_len

    r = episodes.reward
    padded = torch.cat([r, torch.zeros((M, n), dtype=r.dtype, device=r.device)], dim=1)
    n_step_r = torch.zeros_like(r)
    for k in range(n):
        n_step_r = n_step_r + (gamma ** k) * padded[:, k : k + T]
    t_idx = torch.arange(T, dtype=torch.float32, device=r.device)[None, :]
    bootstrap = (t_idx < seq_len[:, None] - n).float()

    if agent_cfg.uniform_priority:
        return n_step_r, bootstrap, torch.ones((M,), device=r.device)
    qa = _per_slot(episodes.qa, agent_cfg)
    qa_next = torch.cat([qa[:, n:], torch.zeros_like(qa[:, :n])], dim=1)
    target = n_step_r + bootstrap * (gamma ** n) * qa_next
    return n_step_r, bootstrap, _aggregate(target - qa, seq_len, agent_cfg.eta)
