"""The learner (counterpart of `hanabi_sad_tpu/train/learner.py`).

One `train_chunk` call:
  1. collects one chunk into the replay, in the configured rollout mode:
     * continuous: `max_len` steps of epsilon-greedy self-play from the
       persistent actor state, the finished episodes assembled (for IQL,
       one item per player), their initial priorities computed and
       ring-written into the replay. The priorities are the exact
       online-target ones, from the rollout's own target Q stream
       (`exact_priority_in_rollout`) or from a target-net sequence forward
       over the slots (kernel B1), or, with `continuous_exact_priority` off,
       the online-online approximation from the rollout's online Q;
     * aligned: every env resets and plays one padded episode of `max_len`
       steps with the online net (`collect_chunk`); the initial priorities
       take the rollout's online Q and one target-net sequence forward over
       the episodes (B1);
  2. runs `num_update_per_chunk` gradient updates, each sampling the replay
     (kernel B3), applying the IS-weighted Huber TD + aux loss (the online
     forward through kernel B2, the target forward through B1), clipping the
     global grad norm, stepping Adam and writing the new priorities back.
     With `snapshot_sampling` all of the chunk's index rows and IS weights
     are drawn from the priorities as they stand before the first update;
  3. syncs the target net whenever the global update counter is a multiple
     of `num_update_between_sync`.

On W data-parallel ranks (`parallel/mesh.py`; the state's `mesh`, set by
`shard_train_state`) the same global program runs: each rank collects its
num_envs / W envs, the ranks all-gather the assembled episodes and their
priorities and every rank writes the same ring; each update, every rank
draws the same indices, runs its batchsize / W rows, and the gradients and
metrics are summed over the ranks before the optimizer step, the new
priorities all-gathered. The chunk stats are counts summed over the ranks,
so they equal the one-rank run's.

The online params, the optimizer state and the replay are updated in place.
Metrics stay on the device as 0-d tensors; the caller reads them once per
chunk.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from hanabi_sad_tpu_torch.agent import r2d2_agent
from hanabi_sad_tpu_torch.agent.r2d2_agent import AgentConfig, AgentParams
from hanabi_sad_tpu_torch.device import resolve_device
from hanabi_sad_tpu_torch.game.config import GameConfig
from hanabi_sad_tpu_torch.game.env import EnvConfig
from hanabi_sad_tpu_torch.models.r2d2_net import NetConfig, R2D2NetParams
from hanabi_sad_tpu_torch.parallel import mesh as mesh_mod
from hanabi_sad_tpu_torch.parallel.mesh import Mesh
from hanabi_sad_tpu_torch.replay import prioritized as replay_mod
from hanabi_sad_tpu_torch.replay.bitpack import pack_bits
from hanabi_sad_tpu_torch.replay.prioritized import ReplayConfig, ReplayState
from hanabi_sad_tpu_torch.rollout import continuous, runner
from hanabi_sad_tpu_torch.train.config import TrainConfig, generate_explore_eps
from hanabi_sad_tpu_torch.train.optim import AdamState, ClipAdam, linear_schedule


@dataclasses.dataclass(frozen=True)
class Setup:
    """All static configs derived from a TrainConfig."""

    train: TrainConfig
    env: EnvConfig
    eval_env: EnvConfig
    agent: AgentConfig
    eval_agent: AgentConfig  # vdn=False, float32 clone for evaluation
    replay: ReplayConfig

    @property
    def players_per_item(self) -> int:
        return self.train.num_player if self.train.vdn else 1

    @property
    def items_per_chunk(self) -> int:
        mult = 1 if self.train.vdn else self.train.num_player
        return self.train.num_envs * mult


def make_setup(cfg: TrainConfig) -> Setup:
    cfg = cfg.derived()
    game = GameConfig(players=cfg.num_player, hand_size=cfg.hand_size, bomb=cfg.train_bomb)
    eps_list = generate_explore_eps(cfg.act_base_eps, cfg.act_eps_alpha, cfg.num_eps)
    env = EnvConfig(
        game=game,
        eps_list=eps_list,
        max_len=cfg.max_len,
        sad=cfg.sad,
        shuffle_color=cfg.shuffle_color,
        shuffle_obs=cfg.shuffle_obs,
    )
    eval_env = EnvConfig(
        game=GameConfig(players=cfg.num_player, hand_size=cfg.hand_size, bomb=cfg.eval_bomb),
        eps_list=(0.0,),
        max_len=-1,
        sad=cfg.sad,
        shuffle_color=False,
        shuffle_obs=cfg.shuffle_obs,
    )
    net = NetConfig(
        in_dim=env.feature_size,
        hid_dim=cfg.rnn_hid_dim,
        out_dim=game.num_actions,
        num_lstm_layer=cfg.num_lstm_layer,
        hand_size=cfg.hand_size,
        num_fc_layer=cfg.num_fc_layer,
        skip_connect=cfg.skip_connect,
        compute_dtype=cfg.compute_dtype,
    )
    agent = AgentConfig(
        net=net, vdn=cfg.vdn, multi_step=cfg.multi_step, gamma=cfg.gamma, eta=cfg.eta, stacked_td=cfg.stacked_td
    )
    replay = ReplayConfig(
        capacity=cfg.replay_buffer_size,
        seq_len=cfg.max_len,
        num_player=cfg.num_player if cfg.vdn else 1,
        obs_dim=env.feature_size,
        num_actions=game.num_actions,
        hand_size=cfg.hand_size,
        alpha=cfg.priority_exponent,
        beta=cfg.priority_weight,
    )
    # The eval runs in float32 whatever the compute dtype (the JAX package's
    # eval_agent keeps the training net's; see ROADMAP.md, deviations).
    eval_net = dataclasses.replace(net, compute_dtype="float32")
    return Setup(
        train=cfg, env=env, eval_env=eval_env, agent=agent,
        eval_agent=dataclasses.replace(agent, vdn=False, net=eval_net), replay=replay,
    )


def make_optimizer(cfg: TrainConfig) -> ClipAdam:
    """Clip-then-Adam. With lr_final > 0 the lr decays linearly from cfg.lr
    to cfg.lr_final over cfg.lr_decay_updates updates (default: the whole
    run, counted in full chunks), then holds."""
    lr = lambda count: cfg.lr
    if cfg.lr_final > 0:
        updates_per_epoch = (cfg.epoch_len // cfg.num_update_per_chunk) * cfg.num_update_per_chunk
        steps = cfg.lr_decay_updates or cfg.num_epoch * max(updates_per_epoch, cfg.num_update_per_chunk)
        lr = linear_schedule(cfg.lr, cfg.lr_final, steps)
    return ClipAdam(lr=lr, max_norm=cfg.grad_clip, eps=cfg.adam_eps)


def param_leaves(params: R2D2NetParams) -> List[torch.Tensor]:
    """The net's tensors in the JAX package's leaf order (fields in order,
    dict keys sorted), the order of the optimizer state."""
    leaves = []
    for field in params:
        for d in field if isinstance(field, list) else [field]:
            leaves.extend(d[k] for k in sorted(d))
    return leaves


class TrainState(NamedTuple):
    params: AgentParams
    opt_state: AdamState
    replay: ReplayState
    num_update: int  # global gradient-step counter
    env_gen: torch.Generator  # decks, eps and explore draws of the rollout
    sample_gen: torch.Generator  # replay sampling
    actor: Optional[continuous.ActorState] = None  # continuous mode only
    mesh: Mesh = Mesh()  # the data-parallel ranks (world 1: one process)


def init_train_state(setup: Setup, seed: int, device=None) -> TrainState:
    """Fresh params (drawn on a CPU generator seeded with `seed`, so the same
    on every device), an empty replay and, in continuous mode, a freshly
    reset actor, on `device` (default `cuda`)."""
    device = resolve_device(device)
    params = r2d2_agent.init_agent(
        setup.agent, generator=torch.Generator().manual_seed(seed), device=device
    )
    env_gen = torch.Generator(device=device).manual_seed(seed + 1)
    sample_gen = torch.Generator(device=device).manual_seed(seed + 2)
    cfg = setup.train
    actor = None
    if cfg.rollout_mode == "continuous":
        actor = continuous.init_actor_state(
            setup.agent, setup.env, setup.replay, cfg.num_envs, generator=env_gen,
            with_target_qa=cfg.continuous_exact_priority and cfg.exact_priority_in_rollout, device=device,
        )
    return TrainState(
        params=params,
        opt_state=make_optimizer(setup.train).init(param_leaves(params.online)),
        replay=replay_mod.init_replay(setup.replay, device),
        num_update=0,
        env_gen=env_gen,
        sample_gen=sample_gen,
        actor=actor,
    )


def sgd_update(
    setup: Setup,
    optimizer: ClipAdam,
    state: TrainState,
    presampled: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One prioritized-replay gradient step.

    `presampled` is None (sample here, from the live priority state) or an
    (is_weight, idx) pair drawn by the caller; B3 reads the ring's episodes
    at idx either way. On W ranks every rank holds the same global idx and
    IS weights and runs its batchsize / W rows; the gradients and metrics
    are summed over the ranks (one `all_reduce_sum`), so every rank takes
    the same Adam step, and the rows' new priorities are all-gathered, so
    every rank writes all of them."""
    cfg = setup.train
    mesh = state.mesh
    params = state.params
    if state.num_update % cfg.num_update_between_sync == 0:
        params = r2d2_agent.sync_target(params)

    if presampled is None:
        idx, is_weight = replay_mod.sample_indices(
            state.replay, setup.replay, cfg.batchsize, generator=state.sample_gen
        )
    else:
        is_weight, idx = presampled
    mesh_mod.check_divisible(mesh, batchsize=cfg.batchsize)
    batch = replay_mod.batch_at(state.replay, setup.replay, mesh.shard.take(idx))

    leaves = param_leaves(params.online)
    for t in leaves:
        t.requires_grad_(True)
    per_ep_loss, priority, stats = r2d2_agent.loss(params, setup.agent, batch, cfg.pred_weight)
    loss_val = (per_ep_loss * mesh.shard.take(is_weight)).mean()
    grads = torch.autograd.grad(loss_val, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
    metrics = {"loss": loss_val.detach(), **stats}
    if mesh.world > 1:
        grads, metrics = _sum_over_ranks(grads, metrics, mesh)
    opt_state, grad_norm = optimizer.step(leaves, grads, state.opt_state)

    agg = r2d2_agent.aggregate_priority(priority, batch.seq_len, cfg.eta)
    (agg,) = mesh_mod.all_gather_rows([agg], mesh)
    replay = replay_mod.update_priority(state.replay, setup.replay, idx, agg)
    new_state = state._replace(
        params=params, opt_state=opt_state, replay=replay, num_update=state.num_update + 1
    )
    return new_state, {"loss": metrics.pop("loss"), "grad_norm": grad_norm, **metrics}


def _sum_over_ranks(grads: List[torch.Tensor], metrics: Dict[str, torch.Tensor], mesh: Mesh):
    """The global gradient and metrics from each rank's: the loss and the
    metrics are means over the rank's rows, so each is weighted 1 / W (the
    rows' share of the batch) and the gradients with it, then everything is
    summed over the ranks in one flat buffer."""
    keys = list(metrics)
    share = 1.0 / mesh.world
    flat = torch.cat([g.reshape(-1).float() for g in grads] + [metrics[k].reshape(1).float() for k in keys])
    flat = mesh_mod.all_reduce_sum(flat * share, mesh)
    out, start = [], 0
    for g in grads:
        out.append(flat[start : start + g.numel()].view_as(g).to(g.dtype))
        start += g.numel()
    return out, {k: flat[start + i] for i, k in enumerate(keys)}


def collect_chunk(
    setup: Setup, params: AgentParams, generator: torch.Generator, mesh: Mesh = Mesh()
) -> Tuple[replay_mod.EpisodeBatch, torch.Tensor, Dict[str, torch.Tensor]]:
    """One aligned chunk on the generator's device: every env resets and
    plays one padded episode, whose replay items and initial priorities it
    returns, with chunk stats (0-d device tensors). The explore ratio counts
    live frames only. On W ranks the episodes and priorities are this
    rank's num_envs / W envs', the stats the global ones."""
    cfg = setup.train
    num_envs = mesh_mod.local_rows(cfg.num_envs, mesh.world, "num_envs")
    out = runner.run_episode_chunk(
        params, setup.agent, setup.env, num_envs, cfg.max_len, generator=generator, device=generator.device,
        shard=mesh.shard,
    )
    episodes = runner.chunk_to_episodes(out, setup.agent)
    batch = runner.episodes_to_batch(episodes)
    online_qa, greedy_a = runner.rollout_priority_inputs(out, setup.agent)
    priority = r2d2_agent.compute_priority_from_rollout(params, setup.agent, batch, online_qa, greedy_a)
    prev_done = torch.cumsum(out.done.long(), 0) - out.done.long() > 0  # [T, N]
    live = (~prev_done)[..., None]  # [T, N, 1], over the players
    deviated = (out.action != out.greedy_a) & live
    sums = _counts_over_ranks({
        "score": out.last_score.float().sum(),
        "games": torch.tensor(float(num_envs), device=out.done.device),
        "frames": episodes.seq_len.sum(),
        "items": torch.tensor(float(episodes.seq_len.shape[0]), device=out.done.device),
        "deviated": deviated.sum().float(),
        "live": (live.sum() * out.action.shape[-1]).float(),
    }, mesh)
    stats = {
        "chunk_score": sums["score"] / sums["games"],
        "chunk_len": sums["frames"] / sums["items"],
        "chunk_frames": sums["frames"],
        "explore_ratio": sums["deviated"] / torch.clamp(sums["live"], min=1),
    }
    return episodes, priority, stats


def _counts_over_ranks(counts: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """A chunk's float32 counts summed over the ranks in one call. They are
    whole numbers, summed in float64 and exact, so a stat made of them
    equals the one-rank run's."""
    if mesh.world == 1:
        return counts
    keys = list(counts)
    flat = mesh_mod.all_reduce_sum(torch.stack([counts[k].double() for k in keys]), mesh)
    return {k: flat[i].float() for i, k in enumerate(keys)}


def _add_over_ranks(setup: Setup, state: TrainState, packed, action, reward, bootstrap, seq_len, priority,
                    valid=None) -> ReplayState:
    """Every rank's new episodes, concatenated in rank order (the one-rank
    run's env-major order), written into this rank's whole ring."""
    fields = [packed, action, reward, bootstrap, seq_len, priority] + ([] if valid is None else [valid])
    fields = mesh_mod.all_gather_rows(fields, state.mesh)
    return replay_mod.add_packed(state.replay, setup.replay, *fields[:6], valid=None if valid is None else fields[6])


def collect_into_replay(setup: Setup, state: TrainState) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One collection chunk in the configured rollout mode; returns the state
    with the new episodes in the replay, plus chunk stats (0-d device
    tensors)."""
    cfg = setup.train
    if cfg.rollout_mode == "aligned":
        ep, priority, chunk_stats = collect_chunk(setup, state.params, state.env_gen, state.mesh)
        packed = pack_bits(torch.cat([ep.priv_s, ep.legal_move, ep.own_hand], dim=-1))
        replay = _add_over_ranks(setup, state, packed, ep.action, ep.reward, ep.bootstrap, ep.seq_len, priority)
        return state._replace(replay=replay), chunk_stats

    actor, stream = continuous.run_continuous_chunk(
        state.params, setup.agent, setup.env, state.actor, cfg.max_len, generator=state.env_gen,
        shard=state.mesh.shard,
    )
    actor, episodes = continuous.assemble_episodes(actor, stream, cfg.slots_per_env)
    if not cfg.vdn:
        episodes = continuous.split_players(episodes)
    n_step_r, bootstrap, priority = continuous.episode_priorities(episodes, setup.agent)
    if cfg.continuous_exact_priority:
        if episodes.tqa is not None:
            priority = continuous.fused_exact_priorities(episodes, setup.agent, n_step_r, bootstrap)
        else:
            priority = continuous.exact_episode_priorities(
                state.params, setup.agent, setup.replay, episodes, n_step_r, bootstrap
            )
    replay = _add_over_ranks(setup, state, episodes.packed, episodes.action, n_step_r, bootstrap,
                             episodes.seq_len, priority, valid=episodes.valid)
    sums = _counts_over_ranks({
        "score": episodes.score_sum,
        "completed": episodes.num_completed.float(),
        "frames": torch.where(episodes.valid, episodes.seq_len, 0.0).sum(),
        "valid": episodes.valid.sum().float(),
        "dropped": episodes.dropped.float(),
        # every continuous-mode frame is live
        "deviated": (stream.action != stream.greedy).sum().float(),
        "acts": torch.tensor(float(stream.action.numel()), device=stream.action.device),
    }, state.mesh)
    chunk_stats = {
        "chunk_score": sums["score"] / torch.clamp(sums["completed"], min=1.0),
        "chunk_len": sums["frames"] / torch.clamp(sums["valid"], min=1),
        "chunk_frames": sums["frames"],
        "dropped_episodes": sums["dropped"],
        "explore_ratio": sums["deviated"] / sums["acts"],
    }
    return state._replace(replay=replay, actor=actor), chunk_stats


def train_updates(setup: Setup, optimizer: ClipAdam, state: TrainState):
    """num_update_per_chunk gradient updates. Returns (state, the updates'
    mean metrics).

    With snapshot_sampling every update's index row and IS weights are drawn
    before the first update, from the priorities as they stand (U successive
    draws of `sample_gen`, the sequential path's own), so no batch of the
    chunk sees the chunk's priority feedback, which still lands in the
    replay every update. The replay is written in place, so the draw has to
    come first: one taken inside the loop would read the live priorities.
    The ring's packed fields do not change during the updates, only its
    weights, so each update's B3 launch reads the ring at its row of indices
    (`batch_at`), as a sequential update does; at one update a chunk the two
    paths give the same bits."""
    cfg = setup.train
    U = cfg.num_update_per_chunk
    if cfg.snapshot_sampling:
        # U successive one-batch draws, as the sequential path makes them (a
        # single rand((U, B)) is another stream on the card)
        device = state.replay.weight.device
        uniforms = torch.stack(
            [torch.rand((cfg.batchsize,), generator=state.sample_gen, device=device) for _ in range(U)]
        )
        idx, is_w = replay_mod.sample_indices(state.replay, setup.replay, cfg.batchsize, uniforms=uniforms)
        presampled = [(is_w[u], idx[u]) for u in range(U)]
    else:
        presampled = [None] * U
    per_update = []
    for drawn in presampled:
        state, metrics = sgd_update(setup, optimizer, state, presampled=drawn)
        per_update.append(metrics)
    return state, {k: torch.stack([m[k] for m in per_update]).mean() for k in per_update[0]}


def train_chunk(setup: Setup, optimizer: ClipAdam, state: TrainState):
    """Collect one chunk, then num_update_per_chunk gradient updates
    (`train_updates`). Returns (state, metrics: the updates' means and the
    chunk stats)."""
    state, chunk_stats = collect_into_replay(setup, state)
    state, out = train_updates(setup, optimizer, state)
    out.update(chunk_stats)
    return state, out


def collect_only(setup: Setup, state: TrainState):
    """Warm-up step: collect + add, no gradient updates (the burn-in loop)."""
    return collect_into_replay(setup, state)
