"""Dueling recurrent Q-network (counterpart of
`hanabi_sad_tpu/models/r2d2_net.py`).

An MLP trunk, a multi-layer LSTM, dueling value / advantage heads with a
legal-move-masked advantage mean, and the auxiliary own-hand head. Params
are an R2D2NetParams of torch tensors in the JAX package's layout (Linear
`w` is [in, out]); every function is plain tensor code.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from hanabi_sad_tpu_torch.models import lstm as lstm_mod


@dataclasses.dataclass(frozen=True)
class NetConfig:
    in_dim: int
    hid_dim: int = 512
    out_dim: int = 21
    num_lstm_layer: int = 2
    hand_size: int = 5
    num_fc_layer: int = 1
    skip_connect: bool = False
    # Only float32 compute is ported; the eval path runs in float32.
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.compute_dtype == "bfloat16":
            raise NotImplementedError("bfloat16 compute is not ported yet")
        if self.compute_dtype != "float32":
            raise ValueError(f"compute_dtype must be 'float32', got {self.compute_dtype!r}")


class R2D2NetParams(NamedTuple):
    net: List[Dict[str, torch.Tensor]]  # trunk Linear layers {"w","b"}
    lstm: lstm_mod.LSTMParams
    fc_v: Dict[str, torch.Tensor]
    fc_a: Dict[str, torch.Tensor]
    pred: Dict[str, torch.Tensor]  # aux own-hand head: hid -> hand_size*3


def trunk(params: R2D2NetParams, x: torch.Tensor) -> torch.Tensor:
    for layer in params.net:
        x = torch.relu(x @ layer["w"] + layer["b"])
    return x


def _step(params: R2D2NetParams, cfg: NetConfig, priv_s: torch.Tensor, hid: Dict[str, torch.Tensor]):
    """Trunk + one LSTM step; hid is batch-first {"h0","c0": [B, L, D]}."""
    x = trunk(params, priv_s)
    hidden = (hid["h0"].transpose(0, 1).contiguous(), hid["c0"].transpose(0, 1).contiguous())
    o, (h, c) = lstm_mod.lstm_step(params.lstm, x, hidden)
    if cfg.skip_connect:
        o = o + x
    return o, {"h0": h.transpose(0, 1), "c0": c.transpose(0, 1)}


def act(
    params: R2D2NetParams, cfg: NetConfig, priv_s: torch.Tensor, hid: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-step advantage for acting. priv_s: [B, in_dim]; hid: {"h0","c0":
    [B, L, D]} batch-first. Returns (advantage [B, out_dim], new hid)."""
    o, new_hid = _step(params, cfg, priv_s, hid)
    return o @ params.fc_a["w"] + params.fc_a["b"], new_hid


def act_with_v(
    params: R2D2NetParams, cfg: NetConfig, priv_s: torch.Tensor, hid: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """act() that also returns the state value [B, 1]."""
    o, new_hid = _step(params, cfg, priv_s, hid)
    a = o @ params.fc_a["w"] + params.fc_a["b"]
    v = o @ params.fc_v["w"] + params.fc_v["b"]
    return a, v, new_hid


def duel(v: torch.Tensor, a: torch.Tensor, legal_move: torch.Tensor) -> torch.Tensor:
    """Dueling combine with the legal-masked advantage mean taken over *all*
    actions (the mean divides by num_actions, not the number legal)."""
    legal_a = a * legal_move
    return v + legal_a - legal_a.mean(dim=-1, keepdim=True)


def masked_argmax(values: torch.Tensor, legal_move: torch.Tensor) -> torch.Tensor:
    """argmax over legal entries of `values`, shifted positive by the min over
    the whole tensor (batch-wide, as the JAX package takes it) and masked."""
    return ((1 + values - values.min()) * legal_move).argmax(dim=-1)


def forward(
    params: R2D2NetParams,
    cfg: NetConfig,
    priv_s: torch.Tensor,
    legal_move: torch.Tensor,
    action: torch.Tensor,
    hid: Optional[Dict[str, torch.Tensor]] = None,
):
    """Sequence forward. priv_s: [T, B, in_dim]; legal_move: [T, B, A];
    action: [T, B]. hid None -> zeros; else {"h0","c0": [L, B, D]}.
    Returns (qa [T,B], greedy_action [T,B], q [T,B,A], lstm_o [T,B,D])."""
    B = priv_s.shape[1]
    x = trunk(params, priv_s)
    if hid is None:
        hidden = lstm_mod.zero_hidden(cfg.num_lstm_layer, B, cfg.hid_dim, x.dtype, x.device)
    else:
        hidden = (hid["h0"], hid["c0"])
    o, _ = lstm_mod.lstm_seq(params.lstm, x.contiguous(), hidden)
    if cfg.skip_connect:
        o = o + x
    a = o @ params.fc_a["w"] + params.fc_a["b"]
    v = o @ params.fc_v["w"] + params.fc_v["b"]
    q = duel(v, a, legal_move)
    qa = q.gather(-1, action.long()[..., None])[..., 0]
    return qa, masked_argmax(q, legal_move).detach(), q, o


def greedy_act(
    params: R2D2NetParams,
    cfg: NetConfig,
    priv_s: torch.Tensor,
    legal_move: torch.Tensor,
    hid: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Greedy action ids for acting."""
    adv, new_hid = act(params, cfg, priv_s, hid)
    return masked_argmax(adv, legal_move), new_hid
