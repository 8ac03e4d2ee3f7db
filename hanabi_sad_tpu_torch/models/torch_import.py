"""Load reference `.pthw` checkpoints (torch state dicts of the reference
`pyhanabi/r2d2.py` R2D2Net) into the port's R2D2NetParams (counterpart of
`hanabi_sad_tpu/models/torch_import.py`).

Mapping (state dict -> params):
  net.{2i}.weight [H, in]        -> net[i]["w"] = weight.T
  lstm.weight_ih_l{k} [4H, in]   -> lstm[k]["w_ih"] = weight.T  (gate order
  lstm.bias_ih_l{k} + bias_hh_l{k} -> lstm[k]["b"]               i,f,g,o)
  fc_v/fc_a/pred.weight          -> {"w": weight.T, "b": bias}

The reference keeps the LSTM's two biases apart; the port sums them, as the
JAX package does, and `to_torch_state_dict` splits the sum back into two
halves (b / 2 each, which is exact). NetConfig's dims come from the tensor
shapes, as the reference loaders take them. Every tensor is float32,
C-contiguous and owns its memory.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from hanabi_sad_tpu_torch.device import resolve_device
from hanabi_sad_tpu_torch.models.lstm import LSTMParams
from hanabi_sad_tpu_torch.models.r2d2_net import NetConfig, R2D2NetParams


def to_param(t: torch.Tensor, device) -> torch.Tensor:
    """A detached float32 copy of t on `device`, C-contiguous, owning its
    memory."""
    return t.detach().to(device=device, dtype=torch.float32).clone(memory_format=torch.contiguous_format)


def linear_from(state_dict: Dict[str, torch.Tensor], name: str, device) -> Dict[str, torch.Tensor]:
    """The Linear layer `name` of a state dict as {"w": weight.T, "b": bias}."""
    return {"w": to_param(state_dict[f"{name}.weight"].t(), device), "b": to_param(state_dict[f"{name}.bias"], device)}


def lstm_from(state_dict: Dict[str, torch.Tensor], num_layers: int, device) -> LSTMParams:
    """The state dict's `lstm` layers, their two biases summed into one."""
    return [
        {
            "w_ih": to_param(state_dict[f"lstm.weight_ih_l{k}"].t(), device),
            "w_hh": to_param(state_dict[f"lstm.weight_hh_l{k}"].t(), device),
            "b": to_param(state_dict[f"lstm.bias_ih_l{k}"] + state_dict[f"lstm.bias_hh_l{k}"], device),
        }
        for k in range(num_layers)
    ]


def linear_to(sd: Dict[str, torch.Tensor], name: str, layer: Dict[str, torch.Tensor]):
    """Writes layer {"w", "b"} into sd as the Linear layer `name`, on the CPU."""
    sd[f"{name}.weight"] = to_param(layer["w"].t(), "cpu")
    sd[f"{name}.bias"] = to_param(layer["b"], "cpu")


def lstm_to(sd: Dict[str, torch.Tensor], lstm: LSTMParams):
    """Writes the LSTM layers into sd, on the CPU; the collapsed bias goes to
    bias_ih and bias_hh as b / 2 each (exact)."""
    for k, layer in enumerate(lstm):
        sd[f"lstm.weight_ih_l{k}"] = to_param(layer["w_ih"].t(), "cpu")
        sd[f"lstm.weight_hh_l{k}"] = to_param(layer["w_hh"].t(), "cpu")
        half = to_param(layer["b"], "cpu") / 2
        sd[f"lstm.bias_ih_l{k}"] = half
        sd[f"lstm.bias_hh_l{k}"] = half.clone()


def infer_net_config(state_dict: Dict[str, torch.Tensor], hand_size: int = 5) -> NetConfig:
    """NetConfig from the shapes: in_dim and hid_dim from net.0.weight,
    out_dim from fc_a.weight, the layer counts from the keys."""
    w0 = state_dict["net.0.weight"]
    return NetConfig(
        in_dim=w0.shape[1],
        hid_dim=w0.shape[0],
        out_dim=state_dict["fc_a.weight"].shape[0],
        num_lstm_layer=len([k for k in state_dict if k.startswith("lstm.weight_ih_l")]),
        hand_size=hand_size,
        num_fc_layer=len([k for k in state_dict if k.startswith("net.") and k.endswith(".weight")]),
    )


def from_torch_state_dict(
    state_dict: Dict[str, torch.Tensor], cfg: Optional[NetConfig] = None, device=None
) -> Tuple[R2D2NetParams, NetConfig]:
    """(params on `device` (default `cuda`), cfg); cfg is inferred from the
    shapes when not given."""
    device = resolve_device(device)
    if cfg is None:
        cfg = infer_net_config(state_dict)
    lin = lambda name: linear_from(state_dict, name, device)
    # torch Sequential interleaves ReLU: the Linear layers sit at 0, 2, 4, ...
    net = [lin(f"net.{2 * i}") for i in range(cfg.num_fc_layer)]
    lstm = lstm_from(state_dict, cfg.num_lstm_layer, device)
    return R2D2NetParams(net=net, lstm=lstm, fc_v=lin("fc_v"), fc_a=lin("fc_a"), pred=lin("pred")), cfg


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A `.pthw` / `.pth` state dict, read on the CPU without unpickling
    anything but tensors."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_pthw(path: str, hand_size: int = 5, device=None) -> Tuple[R2D2NetParams, NetConfig]:
    """A reference weight file -> (params on `device`, cfg)."""
    sd = load_state_dict(path)
    return from_torch_state_dict(sd, infer_net_config(sd, hand_size=hand_size), device)


def to_torch_state_dict(params: R2D2NetParams) -> Dict[str, torch.Tensor]:
    """The params as a reference state dict (the inverse of
    from_torch_state_dict), every tensor a contiguous float32 CPU tensor;
    the collapsed LSTM bias goes to bias_ih and bias_hh as b / 2 each."""
    sd = {}
    for i, layer in enumerate(params.net):
        linear_to(sd, f"net.{2 * i}", layer)
    lstm_to(sd, params.lstm)
    for name in ("fc_v", "fc_a", "pred"):
        linear_to(sd, name, getattr(params, name))
    return sd
