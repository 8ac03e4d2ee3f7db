"""Dueling recurrent Q-network (counterpart of
`hanabi_sad_tpu/models/r2d2_net.py`).

An MLP trunk, a multi-layer LSTM, dueling value / advantage heads with a
legal-move-masked advantage mean, and the auxiliary own-hand head. Params
are an R2D2NetParams of torch tensors in the JAX package's layout (Linear
`w` is [in, out]); every function is plain tensor code. `forward` is
differentiable on the card too: its LSTM goes through kernel B2 when a
gradient is wanted (`models/lstm.py`).

`NetConfig.compute_dtype` is the JAX package's: the trunk and the LSTM run in
it (float32 or bfloat16), the heads, the losses and the params stay float32,
and the hidden that acting carries stays float32 (cast to the compute dtype
for the step and back after it).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from hanabi_sad_tpu_torch.device import resolve_device
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
    # Compute dtype of the trunk and the LSTM; params, heads and losses stay
    # float32. The eval path runs in float32.
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16', got {self.compute_dtype!r}")

    @property
    def cdtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32


class R2D2NetParams(NamedTuple):
    net: List[Dict[str, torch.Tensor]]  # trunk Linear layers {"w","b"}
    lstm: lstm_mod.LSTMParams
    fc_v: Dict[str, torch.Tensor]
    fc_a: Dict[str, torch.Tensor]
    pred: Dict[str, torch.Tensor]  # aux own-hand head: hid -> hand_size*3


def _init_linear(d_in: int, d_out: int, generator, device) -> Dict[str, torch.Tensor]:
    """torch.nn.Linear default init: U(-k, k), k = 1/sqrt(fan_in), drawn on
    the generator's device."""
    k = 1.0 / math.sqrt(d_in)
    gen_device = generator.device if generator is not None else torch.device("cpu")
    uniform = lambda *shape: (torch.rand(shape, generator=generator, device=gen_device) * 2 * k - k).to(device)
    return {"w": uniform(d_in, d_out), "b": uniform(d_out)}


def init_r2d2_net(
    cfg: NetConfig, *, generator: Optional[torch.Generator] = None, device=None
) -> R2D2NetParams:
    """Fresh params with torch's default init, drawn from `generator`, stored
    on `device` (default `cuda`). The draws differ from the JAX package's
    (threefry); the distribution is the same."""
    device = resolve_device(device)
    net = []
    d = cfg.in_dim
    for _ in range(cfg.num_fc_layer):
        net.append(_init_linear(d, cfg.hid_dim, generator, device))
        d = cfg.hid_dim
    return R2D2NetParams(
        net=net,
        lstm=lstm_mod.init_lstm(
            cfg.hid_dim, cfg.hid_dim, cfg.num_lstm_layer, generator=generator, device=device
        ),
        fc_v=_init_linear(cfg.hid_dim, 1, generator, device),
        fc_a=_init_linear(cfg.hid_dim, cfg.out_dim, generator, device),
        pred=_init_linear(cfg.hid_dim, cfg.hand_size * 3, generator, device),
    )


def trunk(params: R2D2NetParams, x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """relu(x @ w + b) per layer in `dtype`: the input and the weights are
    cast to it."""
    x = x.to(dtype)
    for layer in params.net:
        x = torch.relu(x @ layer["w"].to(dtype) + layer["b"].to(dtype))
    return x


def _step(params: R2D2NetParams, cfg: NetConfig, priv_s: torch.Tensor, hid: Dict[str, torch.Tensor]):
    """Trunk + one LSTM step in the compute dtype; hid is batch-first
    {"h0","c0": [B, L, D]} and keeps its dtype. Returns the float32 output."""
    x = trunk(params, priv_s, cfg.cdtype)
    hidden = (hid["h0"].transpose(0, 1).contiguous(), hid["c0"].transpose(0, 1).contiguous())
    o, (h, c) = lstm_mod.lstm_step(params.lstm, x, hidden)
    if cfg.skip_connect:
        o = o + x
    return o.float(), {"h0": h.transpose(0, 1), "c0": c.transpose(0, 1)}


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
    x = trunk(params, priv_s, cfg.cdtype)
    if hid is None:
        hidden = lstm_mod.zero_hidden(cfg.num_lstm_layer, B, cfg.hid_dim, x.dtype, x.device)
    else:
        hidden = (hid["h0"], hid["c0"])
    o, _ = lstm_mod.lstm_seq(params.lstm, x.contiguous(), hidden)
    if cfg.skip_connect:
        o = o + x
    o = o.float()
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


def pred_loss_1st(
    params: R2D2NetParams,
    lstm_o: torch.Tensor,
    target_p: torch.Tensor,
    hand_slot_mask: torch.Tensor,
    seq_len: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Aux own-hand cross-entropy.

    lstm_o: [T, B, (P,) D]; target_p: [T, B, (P,) hand, 3];
    hand_slot_mask: [T, B, (P,) hand] (sum of the trinary, 0 for empty slots).
    Returns (xent summed over time [B], avg_xent scalar)."""
    logit = (lstm_o @ params.pred["w"] + params.pred["b"]).reshape(target_p.shape)
    logq = torch.log_softmax(logit, dim=-1)
    plogq = (target_p * logq).sum(-1)
    xent = -(plogq * hand_slot_mask).sum(-1) / torch.clamp(hand_slot_mask.sum(-1), min=1e-6)
    if xent.dim() == 3:  # [T, B, P] (VDN) -> mean over players
        xent = xent.mean(-1)
    xent_t = xent.sum(0)  # [B]
    avg_xent = (xent_t / seq_len).mean()
    return xent_t, avg_xent
