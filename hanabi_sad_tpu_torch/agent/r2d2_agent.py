"""R2D2 agent, acting part (counterpart of `hanabi_sad_tpu/agent/r2d2_agent.py`).

Shape conventions are the JAX package's: obs fields [N, P, ...] (N envs,
P players), hidden [N, P, L, D]. The learning half (TD error, losses,
priorities) comes with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from hanabi_sad_tpu_torch.device import resolve_device
from hanabi_sad_tpu_torch.models import r2d2_net
from hanabi_sad_tpu_torch.models.r2d2_net import NetConfig, R2D2NetParams


@dataclasses.dataclass(frozen=True)
class AgentConfig:
    """The acting part of the JAX AgentConfig; the learning fields (vdn,
    multi_step, gamma, eta) come with the training slice."""

    net: NetConfig


class AgentParams(NamedTuple):
    online: R2D2NetParams
    target: R2D2NetParams


class Hidden(NamedTuple):
    h: torch.Tensor  # [N, P, L, D]
    c: torch.Tensor


def init_hidden(cfg: AgentConfig, num_envs: int, players: int, device=None) -> Hidden:
    """Zero hidden state on `device` (default `cuda`)."""
    device = resolve_device(device)
    shape = (num_envs, players, cfg.net.num_lstm_layer, cfg.net.hid_dim)
    return Hidden(torch.zeros(shape, device=device), torch.zeros(shape, device=device))


def act(
    params: AgentParams,
    cfg: AgentConfig,
    obs: Dict[str, torch.Tensor],
    hidden: Hidden,
    generator: Optional[torch.Generator] = None,
) -> Tuple[Dict[str, torch.Tensor], Hidden]:
    """Batched epsilon-greedy act for all envs and players at once.

    obs: priv_s [N, P, F], legal_move [N, P, A], eps [N, P].
    Returns ({"a","greedy_a"} [N, P] int64, new hidden). The random arm
    samples uniformly over legal moves (the argmax of uniform noise on the
    legal entries), drawn from `generator`."""
    N, P = obs["priv_s"].shape[:2]
    L, D = cfg.net.num_lstm_layer, cfg.net.hid_dim
    priv_s = obs["priv_s"].reshape(N * P, -1)
    legal = obs["legal_move"].reshape(N * P, -1)
    eps = obs["eps"].reshape(N * P)
    hid = {"h0": hidden.h.reshape(N * P, L, D), "c0": hidden.c.reshape(N * P, L, D)}
    adv, new_hid = r2d2_net.act(params.online, cfg.net, priv_s, hid)
    # Greedy over legal entries of the advantage == greedy over the dueling Q.
    greedy = r2d2_net.masked_argmax(adv, legal)

    noise = torch.rand(legal.shape, generator=generator, device=legal.device)
    random_action = torch.where(legal > 0, noise, -1.0).argmax(dim=-1)
    explore = torch.rand(eps.shape, generator=generator, device=eps.device) < eps
    action = torch.where(explore, random_action, greedy)

    reply = {"a": action.reshape(N, P), "greedy_a": greedy.reshape(N, P)}
    new_hidden = Hidden(
        h=new_hid["h0"].reshape(N, P, L, D), c=new_hid["c0"].reshape(N, P, L, D)
    )
    return reply, new_hidden
