"""R2D2 agent (counterpart of `hanabi_sad_tpu/agent/r2d2_agent.py`):
epsilon-greedy acting, the rollout's online + target step, n-step double-Q
TD error, Huber loss, auxiliary own-hand loss and priority aggregation.

Shape conventions are the JAX package's:
  acting    obs fields [N, P, ...] (N envs, P players), hidden [N, P, L, D];
  learning  sequence batches [T, B, Pi, ...], Pi = num_player for VDN.

The online and target nets are two separate sets of tensors; "sync target"
copies the online tensors into new target tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from hanabi_sad_tpu_torch.device import resolve_device
from hanabi_sad_tpu_torch.models import r2d2_net
from hanabi_sad_tpu_torch.models.r2d2_net import NetConfig, R2D2NetParams
from hanabi_sad_tpu_torch.parallel.mesh import SINGLE, Shard


@dataclasses.dataclass(frozen=True)
class AgentConfig:
    """The JAX AgentConfig, field for field (`stacked_td`: see `td_error`)."""

    net: NetConfig
    vdn: bool = True
    multi_step: int = 3
    gamma: float = 0.999
    eta: float = 0.9
    uniform_priority: bool = False
    stacked_td: bool = False


class AgentParams(NamedTuple):
    online: R2D2NetParams
    target: R2D2NetParams


def clone_params(params: R2D2NetParams) -> R2D2NetParams:
    """A copy of every tensor, detached and not requiring grad."""
    conv = lambda t: t.detach().clone()
    return R2D2NetParams(
        net=[{k: conv(v) for k, v in layer.items()} for layer in params.net],
        lstm=[{k: conv(v) for k, v in layer.items()} for layer in params.lstm],
        fc_v={k: conv(v) for k, v in params.fc_v.items()},
        fc_a={k: conv(v) for k, v in params.fc_a.items()},
        pred={k: conv(v) for k, v in params.pred.items()},
    )


def init_agent(
    cfg: AgentConfig, *, generator: Optional[torch.Generator] = None, device=None
) -> AgentParams:
    """Fresh online params from `generator` and a target that is a copy."""
    online = r2d2_net.init_r2d2_net(cfg.net, generator=generator, device=device)
    return AgentParams(online=online, target=clone_params(online))


def sync_target(params: AgentParams) -> AgentParams:
    """target <- online (a copy, so later in-place updates of the online
    tensors leave the target as it is)."""
    return AgentParams(online=params.online, target=clone_params(params.online))


class Hidden(NamedTuple):
    h: torch.Tensor  # [N, P, L, D]
    c: torch.Tensor


def init_hidden(cfg: AgentConfig, num_envs: int, players: int, device=None) -> Hidden:
    """Zero hidden state on `device` (default `cuda`)."""
    device = resolve_device(device)
    shape = (num_envs, players, cfg.net.num_lstm_layer, cfg.net.hid_dim)
    return Hidden(torch.zeros(shape, device=device), torch.zeros(shape, device=device))


def _epsilon_greedy(greedy, legal, eps, generator, shard: Shard = SINGLE):
    """With probability eps per row, a uniform draw over the legal moves (the
    argmax of uniform noise on the legal entries), else `greedy`. With a
    shard, both draws are made over all ranks' rows and the rank keeps its
    own."""
    rows = shard.total(legal.shape[0])
    noise = shard.take(torch.rand((rows,) + tuple(legal.shape[1:]), generator=generator, device=legal.device))
    random_action = torch.where(legal > 0, noise, -1.0).argmax(dim=-1)
    explore = shard.take(torch.rand((rows,), generator=generator, device=eps.device)) < eps
    return torch.where(explore, random_action, greedy)


def act(
    params: AgentParams,
    cfg: AgentConfig,
    obs: Dict[str, torch.Tensor],
    hidden: Hidden,
    generator: Optional[torch.Generator] = None,
    *,
    return_q: bool = False,
    shard: Shard = SINGLE,
) -> Tuple[Dict[str, torch.Tensor], Hidden]:
    """Batched epsilon-greedy act for all envs and players at once.

    obs: priv_s [N, P, F], legal_move [N, P, A], eps [N, P].
    Returns ({"a","greedy_a"} [N, P] int64, new hidden). The random arm
    samples uniformly over legal moves (the argmax of uniform noise on the
    legal entries), drawn from `generator` (over all ranks' envs with a
    shard). return_q adds reply["qa"], the online dueling Q of the submitted
    action [N, P]."""
    N, P = obs["priv_s"].shape[:2]
    L, D = cfg.net.num_lstm_layer, cfg.net.hid_dim
    priv_s = obs["priv_s"].reshape(N * P, -1)
    legal = obs["legal_move"].reshape(N * P, -1)
    eps = obs["eps"].reshape(N * P)
    hid = {"h0": hidden.h.reshape(N * P, L, D), "c0": hidden.c.reshape(N * P, L, D)}
    if return_q:
        adv, v, new_hid = r2d2_net.act_with_v(params.online, cfg.net, priv_s, hid)
    else:
        adv, new_hid = r2d2_net.act(params.online, cfg.net, priv_s, hid)
    # Greedy over legal entries of the advantage == greedy over the dueling Q.
    greedy = r2d2_net.masked_argmax(adv, legal)

    action = _epsilon_greedy(greedy, legal, eps, generator, shard)

    reply = {"a": action.reshape(N, P), "greedy_a": greedy.reshape(N, P)}
    if return_q:
        qa = r2d2_net.duel(v, adv, legal).gather(1, action[:, None])[:, 0]
        reply["qa"] = qa.reshape(N, P)
    new_hidden = Hidden(
        h=new_hid["h0"].reshape(N, P, L, D), c=new_hid["c0"].reshape(N, P, L, D)
    )
    return reply, new_hidden


def act_with_target(
    params: AgentParams,
    cfg: AgentConfig,
    obs: Dict[str, torch.Tensor],
    hidden: Hidden,
    target_hidden: Hidden,
    generator: Optional[torch.Generator] = None,
    shard: Shard = SINGLE,
) -> Tuple[Dict[str, torch.Tensor], Hidden, Hidden]:
    """Epsilon-greedy act that also advances the TARGET net beside the
    online net, for the fused exact priorities of the continuous rollout.

    Returns ({"a","greedy_a"} [N, P] int64, {"qa"} the online dueling Q of
    the submitted action, {"tqa"} the target dueling Q of the online-greedy
    action, both [N, P]; new hidden; new target hidden). The two nets run as
    two `act_with_v` calls, each one B1 call on the card. The JAX package's
    note on the one divergence from a full-sequence target forward (an
    episode that spans a target sync keeps its pre-sync target Q) holds
    here too."""
    N, P = obs["priv_s"].shape[:2]
    L, D = cfg.net.num_lstm_layer, cfg.net.hid_dim
    priv_s = obs["priv_s"].reshape(N * P, -1)
    legal = obs["legal_move"].reshape(N * P, -1)
    eps = obs["eps"].reshape(N * P)
    hid_dict = lambda h: {"h0": h.h.reshape(N * P, L, D), "c0": h.c.reshape(N * P, L, D)}
    hid_tuple = lambda d: Hidden(h=d["h0"].reshape(N, P, L, D), c=d["c0"].reshape(N, P, L, D))

    adv, v, new_hid = r2d2_net.act_with_v(params.online, cfg.net, priv_s, hid_dict(hidden))
    t_adv, t_v, new_t_hid = r2d2_net.act_with_v(params.target, cfg.net, priv_s, hid_dict(target_hidden))
    greedy = r2d2_net.masked_argmax(adv, legal)

    action = _epsilon_greedy(greedy, legal, eps, generator, shard)

    q = r2d2_net.duel(v, adv, legal)
    qa = q.gather(1, action[:, None])[:, 0]
    t_q = r2d2_net.duel(t_v, t_adv, legal).detach()
    tqa = t_q.gather(1, greedy[:, None])[:, 0]
    reply = {
        "a": action.reshape(N, P),
        "greedy_a": greedy.reshape(N, P),
        "qa": qa.reshape(N, P),
        "tqa": tqa.reshape(N, P),
    }
    return reply, hid_tuple(new_hid), hid_tuple(new_t_hid)


def reset_hidden_where(done: torch.Tensor, hidden: Hidden) -> Hidden:
    """Zero the hidden rows of envs that just reset."""
    mask = done[:, None, None, None]
    return Hidden(
        h=torch.where(mask, torch.zeros_like(hidden.h), hidden.h),
        c=torch.where(mask, torch.zeros_like(hidden.c), hidden.c),
    )


# --------------------------------------------------------------------------
# Learning
# --------------------------------------------------------------------------


class Batch(NamedTuple):
    """A replay sample: padded episode sequences.

    priv_s [T, B, Pi, F]; legal_move [T, B, Pi, A]; action [T, B, Pi] int64;
    own_hand [T, B, Pi, hand*3]; reward/terminal/bootstrap [T, B]; seq_len [B].
    Pi = num_player (VDN) or 1 (IQL)."""

    priv_s: torch.Tensor
    legal_move: torch.Tensor
    action: torch.Tensor
    own_hand: torch.Tensor
    reward: torch.Tensor
    terminal: torch.Tensor
    bootstrap: torch.Tensor
    seq_len: torch.Tensor


def td_error(params: AgentParams, cfg: AgentConfig, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked per-step n-step double-Q TD error over padded episodes.
    Returns (err [T, B], lstm_o [T, B, Pi, D]).

    The online forward is differentiable (B2 on the card when the online
    params require grad); the target forward runs without grad (B1, never
    B2's saving forward).

    cfg.stacked_td changes nothing here. The JAX package's stacked branch
    runs both nets' full-q forwards with zero actions as one scan over the
    params stacked [2, ...], then reads the online Q at the taken action,
    the greedy action as the argmax of (1 + q - q.min()) * legal, and the
    target Q at it: the numbers of the two forwards below, which read the
    same q the same way. The port keeps the two calls, as there is no B1/B2
    launch over two weight sets, and the JAX package measured its stacked
    scan slower at production shapes (its `train/config.py`, `stacked_td`)."""
    T, B, Pi = batch.priv_s.shape[:3]
    flat = lambda x: x.reshape((T, B * Pi) + tuple(x.shape[3:]))
    priv_s = flat(batch.priv_s)
    legal = flat(batch.legal_move)
    action = flat(batch.action)

    online_qa, greedy_a, _, lstm_o = r2d2_net.forward(params.online, cfg.net, priv_s, legal, action)
    with torch.no_grad():
        target_qa, _, _, _ = r2d2_net.forward(params.target, cfg.net, priv_s, legal, greedy_a)

    if cfg.vdn:
        online_qa = online_qa.reshape(T, B, Pi).sum(-1)
        target_qa = target_qa.reshape(T, B, Pi).sum(-1)
    else:
        online_qa = online_qa.reshape(T, B)
        target_qa = target_qa.reshape(T, B)
    lstm_o = lstm_o.reshape(T, B, Pi, -1)

    # n-step target via the time-roll trick: the target for step t bootstraps
    # from the target-net Q at t + multi_step; the stored reward is already
    # the discounted n-step sum and `bootstrap` kills the tail where the
    # episode ended inside the window.
    n = cfg.multi_step
    target_qa = torch.cat([target_qa[n:], torch.zeros_like(target_qa[:n])], dim=0)
    target = batch.reward + batch.bootstrap * (cfg.gamma ** n) * target_qa
    mask = (torch.arange(T, device=target.device)[:, None] < batch.seq_len[None, :]).to(target.dtype)
    err = (target.detach() - online_qa) * mask
    return err, lstm_o


def _huber(x: torch.Tensor) -> torch.Tensor:
    """smooth_l1_loss(err, 0) with beta = 1."""
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def loss(
    params: AgentParams, cfg: AgentConfig, batch: Batch, pred_weight: float
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Per-episode loss and per-step priorities.

    Returns (loss [B], priority [T, B] (no grad), stats dict of detached
    scalars)."""
    err, lstm_o = td_error(params, cfg, batch)
    rl_loss = _huber(err).sum(0)  # [B]
    priority = err.detach().abs()

    stats = {"rl_loss": (rl_loss / batch.seq_len).mean().detach()}
    total = rl_loss
    if pred_weight > 0:
        T, B, Pi = batch.own_hand.shape[:3]
        hand_size = cfg.net.hand_size
        if cfg.vdn:
            own_hand = batch.own_hand.reshape(T, B, Pi, hand_size, 3)
            lstm_in = lstm_o  # [T, B, Pi, D]
        else:
            own_hand = batch.own_hand.reshape(T, B, hand_size, 3)
            lstm_in = lstm_o.reshape(T, B, -1)
        slot_mask = own_hand.sum(-1)
        pred_loss, avg_xent = r2d2_net.pred_loss_1st(
            params.online, lstm_in, own_hand, slot_mask, batch.seq_len
        )
        stats["aux1"] = avg_xent.detach()
        total = rl_loss + pred_weight * pred_loss
    return total, priority, stats


def aggregate_priority(priority: torch.Tensor, seq_len: torch.Tensor, eta: float) -> torch.Tensor:
    """eta * max + (1 - eta) * mean over the valid steps of each episode
    (the mean divides by seq_len)."""
    T = priority.shape[0]
    mask = (torch.arange(T, device=priority.device)[:, None] < seq_len[None, :]).to(priority.dtype)
    p = priority * mask
    return eta * p.max(0).values + (1.0 - eta) * (p.sum(0) / seq_len)


@torch.no_grad()
def compute_priority_from_rollout(
    params: AgentParams,
    cfg: AgentConfig,
    batch: Batch,
    online_qa: torch.Tensor,
    greedy_a: torch.Tensor,
) -> torch.Tensor:
    """Initial priorities [B] from the rollout's own online Q values: only
    the target net runs, one zero-h0 full-sequence forward (B1 on the card,
    never B2's saving forward). online_qa: [T, B] already VDN-summed;
    greedy_a: [T, B, Pi] the rollout's greedy actions."""
    if cfg.uniform_priority:
        return torch.ones_like(batch.seq_len, dtype=torch.float32)
    T, B, Pi = batch.priv_s.shape[:3]
    flat = lambda x: x.reshape((T, B * Pi) + tuple(x.shape[3:]))
    target_qa, _, _, _ = r2d2_net.forward(
        params.target, cfg.net, flat(batch.priv_s), flat(batch.legal_move), flat(greedy_a)
    )
    target_qa = target_qa.reshape(T, B, Pi).sum(-1) if cfg.vdn else target_qa.reshape(T, B)
    n = cfg.multi_step
    target_qa = torch.cat([target_qa[n:], torch.zeros_like(target_qa[:n])], dim=0)
    target = batch.reward + batch.bootstrap * (cfg.gamma ** n) * target_qa
    mask = (torch.arange(T, device=target.device)[:, None] < batch.seq_len[None, :]).to(target.dtype)
    err = (target - online_qa) * mask
    return aggregate_priority(err.abs(), batch.seq_len, cfg.eta)


@torch.no_grad()
def compute_priority(params: AgentParams, cfg: AgentConfig, batch: Batch) -> torch.Tensor:
    """Initial priorities [B] of freshly collected episodes from both nets'
    zero-h0 sequence forwards (B1 on the card): |n-step TD error| per step,
    aggregated. For episodes aligned to t = 0 this is
    compute_priority_from_rollout's quantity, recomputed."""
    if cfg.uniform_priority:
        return torch.ones_like(batch.seq_len, dtype=torch.float32)
    err, _ = td_error(params, cfg, batch)
    return aggregate_priority(err.abs(), batch.seq_len, cfg.eta)
