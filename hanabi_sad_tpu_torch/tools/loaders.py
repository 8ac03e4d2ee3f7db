"""Model loaders for evaluation (counterpart of `hanabi_sad_tpu/tools/loaders.py`).

A loaded model is an EvalPolicy: params + an AgentConfig describing the net +
the act function used by the eval pipeline. Only this framework's `.pkl`
params payloads are ported; reference `.pthw` files, the OP grid and OBL
models are not yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from hanabi_sad_tpu_torch.agent import r2d2_agent
from hanabi_sad_tpu_torch.agent.r2d2_agent import AgentConfig, AgentParams
from hanabi_sad_tpu_torch.device import resolve_device
from hanabi_sad_tpu_torch.models.r2d2_net import NetConfig
from hanabi_sad_tpu_torch.train import checkpoint as ckpt


@dataclasses.dataclass
class EvalPolicy:
    params: Any
    agent_cfg: AgentConfig
    act_fn: Callable
    sad: bool = True  # whether this model consumes the SAD channel


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
        raise NotImplementedError("loading reference .pthw files is not ported yet")
    return load_native_checkpoint(path, hand_size, device)
