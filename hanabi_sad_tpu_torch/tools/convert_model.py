"""Model export (counterpart of `hanabi_sad_tpu/tools/convert_model.py`).

Converts a checkpoint of this framework into:
  * a reference-compatible torch state dict (.pthw), loadable by the
    reference pyhanabi code and by the `.pthw` loaders of both packages;
  * a TorchScript single-forward module (.sparta) for the external SPARTA
    search code, whose interface is `nn.LSTM` (trunk -> LSTM -> fc_a,
    dict in, dict out, batch-first hidden). It is an export format, not a
    compute path of the port: on the card its LSTM is cuDNN's.

  python -m hanabi_sad_tpu_torch.tools.convert_model \
      --model docs/runs/sad_aux_r4_soup10.pkl --pthw

Both files are written next to --model. The checkpoint is loaded on the
CUDA card unless --device says otherwise (--device cpu).
"""

from __future__ import annotations

import argparse
from typing import Dict

import torch
import torch.nn as nn

from hanabi_sad_tpu_torch.device import resolve_device
from hanabi_sad_tpu_torch.models.torch_import import to_torch_state_dict
from hanabi_sad_tpu_torch.tools import loaders


def build_sparta_module(state_dict: Dict[str, torch.Tensor]) -> torch.jit.ScriptModule:
    """The single-forward TorchScript net over a reference state dict's
    trunk, LSTM and fc_a, on the CPU."""
    in_dim = state_dict["net.0.weight"].shape[1]
    hid_dim = state_dict["net.0.weight"].shape[0]
    out_dim = state_dict["fc_a.weight"].shape[0]
    num_lstm = len([k for k in state_dict if k.startswith("lstm.weight_ih_l")])

    class SearchNet(torch.jit.ScriptModule):
        def __init__(self):
            super().__init__()
            self.in_dim = in_dim
            self.net = nn.Sequential(nn.Linear(in_dim, hid_dim), nn.ReLU())
            self.lstm = nn.LSTM(hid_dim, hid_dim, num_layers=num_lstm)
            self.fc_v = nn.Linear(hid_dim, 1)
            self.fc_a = nn.Linear(hid_dim, out_dim)

        @torch.jit.script_method
        def forward(self, obs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
            h0 = obs["h0"].transpose(0, 1).contiguous()
            c0 = obs["c0"].transpose(0, 1).contiguous()
            s = obs["s"].unsqueeze(0)
            x = self.net(s)
            o, (h, c) = self.lstm(x, (h0, c0))
            a = self.fc_a(o).squeeze(0)
            return {
                "a": a,
                "h0": h.transpose(0, 1).contiguous(),
                "c0": c.transpose(0, 1).contiguous(),
            }

    net = SearchNet()
    own = net.state_dict()
    for k in own:
        if k in state_dict:
            own[k] = state_dict[k]
    net.load_state_dict(own)
    return net


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", required=True, type=str, help=".pkl checkpoint")
    parser.add_argument("--pthw", action="store_true", help="also write .pthw")
    parser.add_argument("--device", default=None, type=str, help="default: cuda")
    args = parser.parse_args(argv)

    policy = loaders.load_any(args.model, device=resolve_device(args.device))
    sd = to_torch_state_dict(policy.params.online)

    base = args.model.rsplit(".", 1)[0]
    if args.pthw:
        torch.save(sd, base + ".pthw")
        print("saved torch weights to:", base + ".pthw")

    save_path = base + ".sparta"
    print("saving model to:", save_path)
    torch.jit.save(build_sparta_module(sd), save_path)
    return save_path


if __name__ == "__main__":
    main()
