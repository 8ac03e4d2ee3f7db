"""Public-LSTM network of the OBL model family (counterpart of
`hanabi_sad_tpu/models/public_lstm.py`).

The reference PublicLSTMNet: a private MLP branch (Linear + ReLU layers on
the 658-dim private features) multiplied elementwise with a public branch
(Linear + ReLU on the 533-dim public features, then a multi-layer LSTM),
then dueling heads. It loads released OBL checkpoints and plays them in the
SAD eval pipeline: the 838-dim SAD observation is sliced priv = s[:783][125:],
publ = priv[125:] (`sad_slice`).

Params are PublicLSTMParams of torch tensors in the JAX package's layout
(Linear `w` is [in, out]). The recurrence goes through `models/lstm.py`'s
module attributes (`lstm_mod.lstm_seq`, `lstm_mod.lstm_step`), so on the
card it runs on kernel B1 (B2 under autograd) and on the CPU on the plain
cell, and a caller that swaps `lstm_mod.lstm_seq` reaches this net too.
Everything runs in float32, as the JAX module does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from hanabi_sad_tpu_torch.agent.r2d2_agent import Hidden, _epsilon_greedy
from hanabi_sad_tpu_torch.device import resolve_device
from hanabi_sad_tpu_torch.models import lstm as lstm_mod
from hanabi_sad_tpu_torch.models import torch_import
from hanabi_sad_tpu_torch.models.r2d2_net import _init_linear, duel, masked_argmax


@dataclasses.dataclass(frozen=True)
class PublicNetConfig:
    """OBL's published widths by default."""

    priv_in_dim: int = 658
    publ_in_dim: int = 533
    hid_dim: int = 512
    out_dim: int = 21
    num_lstm_layer: int = 2
    hand_size: int = 5
    num_priv_layer: int = 3
    num_publ_layer: int = 1


class PublicLSTMParams(NamedTuple):
    priv_net: List[Dict[str, torch.Tensor]]
    publ_net: List[Dict[str, torch.Tensor]]
    lstm: lstm_mod.LSTMParams
    fc_v: Dict[str, torch.Tensor]
    fc_a: Dict[str, torch.Tensor]
    pred_1st: Dict[str, torch.Tensor]


def init_public_lstm(
    cfg: PublicNetConfig, *, generator: Optional[torch.Generator] = None, device=None
) -> PublicLSTMParams:
    """Fresh params with torch's default init, drawn from `generator`, stored
    on `device` (default `cuda`). The draws differ from the JAX package's
    (threefry); the distribution is the same."""
    device = resolve_device(device)
    priv_net, d = [], cfg.priv_in_dim
    for _ in range(cfg.num_priv_layer):
        priv_net.append(_init_linear(d, cfg.hid_dim, generator, device))
        d = cfg.hid_dim
    publ_net, d = [], cfg.publ_in_dim
    for _ in range(cfg.num_publ_layer):
        publ_net.append(_init_linear(d, cfg.hid_dim, generator, device))
        d = cfg.hid_dim
    return PublicLSTMParams(
        priv_net=priv_net,
        publ_net=publ_net,
        lstm=lstm_mod.init_lstm(cfg.hid_dim, cfg.hid_dim, cfg.num_lstm_layer, generator=generator, device=device),
        fc_v=_init_linear(cfg.hid_dim, 1, generator, device),
        fc_a=_init_linear(cfg.hid_dim, cfg.out_dim, generator, device),
        pred_1st=_init_linear(cfg.hid_dim, cfg.hand_size * 3, generator, device),
    )


def _mlp(layers, x: torch.Tensor) -> torch.Tensor:
    for layer in layers:
        x = torch.relu(x @ layer["w"] + layer["b"])
    return x


def sad_slice(priv_s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slice an 838-dim (or 783-dim) SAD observation into (priv 658, publ
    533), as the JAX function does: drop the greedy-action block, then the
    first 125 features, then the next 125. Views of priv_s."""
    base = priv_s[..., :783]
    priv = base[..., 125:]
    publ = priv[..., 125:]
    return priv, publ


def act(
    params: PublicLSTMParams,
    cfg: PublicNetConfig,
    priv_s: torch.Tensor,
    publ_s: torch.Tensor,
    hid: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-step advantage. priv_s / publ_s: [B, *]; hid batch-first
    {"h0","c0": [B, L, D]}. Returns (advantage [B, out_dim], new hid,
    batch-first)."""
    x = _mlp(params.publ_net, publ_s)
    hidden = (hid["h0"].transpose(0, 1).contiguous(), hid["c0"].transpose(0, 1).contiguous())
    publ_o, (h, c) = lstm_mod.lstm_step(params.lstm, x, hidden)
    o = _mlp(params.priv_net, priv_s) * publ_o
    a = o @ params.fc_a["w"] + params.fc_a["b"]
    return a, {"h0": h.transpose(0, 1), "c0": c.transpose(0, 1)}


def forward(
    params: PublicLSTMParams,
    cfg: PublicNetConfig,
    priv_s: torch.Tensor,
    publ_s: torch.Tensor,
    legal_move: torch.Tensor,
    action: torch.Tensor,
    hid: Optional[Dict[str, torch.Tensor]] = None,
):
    """Sequence forward, shapes as r2d2_net.forward: priv_s [T, B, priv],
    publ_s [T, B, publ], legal_move [T, B, A], action [T, B]; hid None ->
    zeros, else {"h0","c0": [L, B, D]}. Returns (qa [T, B], greedy_action
    [T, B], q [T, B, A], o [T, B, D])."""
    B = priv_s.shape[1]
    x = _mlp(params.publ_net, publ_s)
    if hid is None:
        hidden = lstm_mod.zero_hidden(cfg.num_lstm_layer, B, cfg.hid_dim, x.dtype, x.device)
    else:
        hidden = (hid["h0"], hid["c0"])
    publ_o, _ = lstm_mod.lstm_seq(params.lstm, x, hidden)
    o = _mlp(params.priv_net, priv_s) * publ_o
    a = o @ params.fc_a["w"] + params.fc_a["b"]
    v = o @ params.fc_v["w"] + params.fc_v["b"]
    q = duel(v, a, legal_move)
    qa = q.gather(-1, action.long()[..., None])[..., 0]
    return qa, masked_argmax(q, legal_move).detach(), q, o


def make_act_fn(cfg: PublicNetConfig):
    """An act function with r2d2_agent.act's signature (params, agent_cfg,
    obs, hidden, generator), so a PublicLSTM policy plays a seat in the SAD
    eval pipeline. Greedy is JAX's rule, (1 + adv - adv.min()) * legal then
    argmax, the min taken over the whole batch; with probability eps a row
    takes a uniform legal move instead, drawn from `generator` (eps is 0 in
    eval, so the draws never decide an action there)."""
    L, D = cfg.num_lstm_layer, cfg.hid_dim

    def obl_act(params, _agent_cfg, obs, hidden, generator=None):
        N, P = obs["priv_s"].shape[:2]
        priv_s, publ_s = sad_slice(obs["priv_s"].reshape(N * P, -1))
        legal = obs["legal_move"].reshape(N * P, -1)
        eps = obs["eps"].reshape(N * P)
        hid = {"h0": hidden.h.reshape(N * P, L, D), "c0": hidden.c.reshape(N * P, L, D)}
        adv, new_hid = act(params, cfg, priv_s, publ_s, hid)
        greedy = masked_argmax(adv, legal)
        action = _epsilon_greedy(greedy, legal, eps, generator)
        reply = {"a": action.reshape(N, P), "greedy_a": greedy.reshape(N, P)}
        return reply, Hidden(h=new_hid["h0"].reshape(N, P, L, D), c=new_hid["c0"].reshape(N, P, L, D))

    return obl_act


def from_torch_state_dict(state_dict, device=None) -> Tuple[PublicLSTMParams, PublicNetConfig]:
    """A released OBL state dict, with OBL_STRIP_KEYS dropped, -> (params on
    `device` (default `cuda`), cfg); the dims and layer counts come from the
    shapes and keys, the LSTM's two biases are summed into one."""
    device = resolve_device(device)
    sd = state_dict
    num_lstm = len([k for k in sd if k.startswith("lstm.weight_ih_l")])
    n_priv = len([k for k in sd if k.startswith("priv_net.") and k.endswith(".weight")])
    n_publ = len([k for k in sd if k.startswith("publ_net.") and k.endswith(".weight")])
    cfg = PublicNetConfig(
        priv_in_dim=sd["priv_net.0.weight"].shape[1],
        publ_in_dim=sd["publ_net.0.weight"].shape[1],
        hid_dim=sd["priv_net.0.weight"].shape[0],
        out_dim=sd["fc_a.weight"].shape[0],
        num_lstm_layer=num_lstm,
        num_priv_layer=n_priv,
        num_publ_layer=n_publ,
    )
    lin = lambda name: torch_import.linear_from(sd, name, device)
    # torch Sequential interleaves ReLU: the Linear layers sit at 0, 2, 4, ...
    params = PublicLSTMParams(
        priv_net=[lin(f"priv_net.{2 * i}") for i in range(n_priv)],
        publ_net=[lin(f"publ_net.{2 * i}") for i in range(n_publ)],
        lstm=torch_import.lstm_from(sd, num_lstm, device),
        fc_v=lin("fc_v"),
        fc_a=lin("fc_a"),
        pred_1st=lin("pred_1st"),
    )
    return params, cfg


def to_torch_state_dict(params: PublicLSTMParams) -> Dict[str, torch.Tensor]:
    """The params as a reference PublicLSTMNet state dict (without the heads
    of OBL_STRIP_KEYS), contiguous float32 CPU tensors; the LSTM bias goes to
    bias_ih and bias_hh as b / 2 each."""
    sd = {}
    for prefix, layers in (("priv_net", params.priv_net), ("publ_net", params.publ_net)):
        for i, layer in enumerate(layers):
            torch_import.linear_to(sd, f"{prefix}.{2 * i}", layer)
    torch_import.lstm_to(sd, params.lstm)
    for name in ("fc_v", "fc_a", "pred_1st"):
        torch_import.linear_to(sd, name, getattr(params, name))
    return sd


# The heads a released OBL checkpoint carries beyond PublicLSTMNet's.
OBL_STRIP_KEYS = (
    "core_ffn.1.weight", "core_ffn.1.bias", "core_ffn.3.weight", "core_ffn.3.bias",
    "pred_2nd.weight", "pred_2nd.bias", "pred_t.weight", "pred_t.bias",
)


def load_obl_pthw(path: str, device=None) -> Tuple[PublicLSTMParams, PublicNetConfig]:
    """A released OBL `.pthw` -> (params on `device` (default `cuda`), cfg),
    read on the CPU without unpickling anything but tensors, with
    OBL_STRIP_KEYS dropped."""
    sd = torch_import.load_state_dict(path)
    for k in OBL_STRIP_KEYS:
        sd.pop(k, None)
    return from_torch_state_dict(sd, device)
