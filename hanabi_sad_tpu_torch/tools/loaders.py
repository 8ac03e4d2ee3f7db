"""Model loaders for evaluation (counterpart of `hanabi_sad_tpu/tools/loaders.py`).

A loaded model is an EvalPolicy: params + an AgentConfig describing the net +
the act function used by the eval pipeline. Supports this framework's `.pkl`
params payloads, reference `.pthw` state dicts (SAD / OP release files), the
OP release's 12-model architecture grid and released OBL PublicLSTM
checkpoints (`load_obl_model`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable

from hanabi_sad_tpu_torch.agent import r2d2_agent
from hanabi_sad_tpu_torch.agent.r2d2_agent import AgentConfig, AgentParams
from hanabi_sad_tpu_torch.device import resolve_device
from hanabi_sad_tpu_torch.models import public_lstm, torch_import
from hanabi_sad_tpu_torch.models.r2d2_net import NetConfig
from hanabi_sad_tpu_torch.train import checkpoint as ckpt


@dataclasses.dataclass
class EvalPolicy:
    params: Any
    agent_cfg: AgentConfig
    act_fn: Callable
    sad: bool = True  # whether this model consumes the SAD channel


def _pthw_policy(net, net_cfg: NetConfig) -> EvalPolicy:
    return EvalPolicy(
        params=AgentParams(online=net, target=net),
        agent_cfg=AgentConfig(net=net_cfg),
        act_fn=r2d2_agent.act,
        sad=net_cfg.in_dim >= 838,
    )


def load_sad_model(weight_file: str, hand_size: int = 5, device=None) -> EvalPolicy:
    """Reference `.pthw` -> policy on `device`; dims inferred from the
    tensors."""
    return _pthw_policy(*torch_import.load_pthw(weight_file, hand_size=hand_size, device=device))


# model idx -> (num_fc_layer, skip_connect) of the OP release grid
OP_ARCH_GRID = {
    **{i: (1, False) for i in range(0, 3)},
    **{i: (1, True) for i in range(3, 6)},
    **{i: (2, False) for i in range(6, 9)},
    **{i: (2, True) for i in range(9, 12)},
}


def load_op_model(folder: str, method: str, idx: int, hand_size: int = 5, device=None) -> EvalPolicy:
    """The OP release's model `{folder}/{method}/M{idx}.pthw`, with its
    grid architecture (OP_ARCH_GRID)."""
    num_fc, skip = OP_ARCH_GRID[idx]
    weight_file = os.path.join(folder, method, f"M{idx}.pthw")
    if not os.path.exists(weight_file):
        raise FileNotFoundError(f"Cannot find weight at: {weight_file}")
    sd = torch_import.load_state_dict(weight_file)
    net_cfg = dataclasses.replace(
        torch_import.infer_net_config(sd, hand_size=hand_size), num_fc_layer=num_fc, skip_connect=skip
    )
    return _pthw_policy(*torch_import.from_torch_state_dict(sd, net_cfg, device))


def load_obl_model(path: str, device=None) -> EvalPolicy:
    """A released OBL PublicLSTM `.pthw` -> policy on `device`. It plays on
    the SAD observation (`public_lstm.sad_slice`); its NetConfig only
    carries the hidden state's shape for the eval pipeline."""
    net_params, net_cfg = public_lstm.load_obl_pthw(path, device)
    shim = NetConfig(
        in_dim=838,
        hid_dim=net_cfg.hid_dim,
        out_dim=net_cfg.out_dim,
        num_lstm_layer=net_cfg.num_lstm_layer,
        hand_size=net_cfg.hand_size,
    )
    base_act = public_lstm.make_act_fn(net_cfg)

    def act_fn(p, agent_cfg, obs, hidden, generator=None):
        return base_act(p.online, agent_cfg, obs, hidden, generator)

    return EvalPolicy(
        params=AgentParams(online=net_params, target=net_params),
        agent_cfg=AgentConfig(net=shim),
        act_fn=act_fn,
        sad=True,
    )


def load_native_checkpoint(path: str, hand_size: int = 5, device=None) -> EvalPolicy:
    """This framework's `.pkl` params payload -> policy on `device`.

    The NetConfig is rebuilt from the tensor shapes and the saved config,
    without compute_dtype, so eval runs in float32 as the JAX loader's does."""
    device = resolve_device(device)
    payload = ckpt.load(path)
    saved = payload["params"]
    saved_cfg = payload.get("config")
    if saved_cfg:
        hand_size = saved_cfg.get("hand_size", hand_size)
    net_np = saved.online if hasattr(saved, "online") else saved
    net = ckpt.from_jax_params(net_np, device)
    in_dim, hid_dim = net.net[0]["w"].shape
    net_cfg = NetConfig(
        in_dim=in_dim,
        hid_dim=hid_dim,
        out_dim=net.fc_a["w"].shape[1],
        num_lstm_layer=len(net.lstm),
        hand_size=hand_size,
        num_fc_layer=len(net.net),
        skip_connect=bool(saved_cfg.get("skip_connect", False)) if saved_cfg else False,
    )
    sad = saved_cfg["sad"] if saved_cfg and "sad" in saved_cfg else in_dim >= 838
    return EvalPolicy(
        params=AgentParams(online=net, target=net),
        agent_cfg=AgentConfig(net=net_cfg),
        act_fn=r2d2_agent.act,
        sad=sad,
    )


def load_any(path: str, hand_size: int = 5, device=None) -> EvalPolicy:
    if path.endswith(".pthw") or path.endswith(".pth"):
        return load_sad_model(path, hand_size, device)
    return load_native_checkpoint(path, hand_size, device)
