"""Loading the JAX package's checkpoints without JAX (counterpart of
`hanabi_sad_tpu/train/checkpoint.py:load`).

A `.pkl` payload is a pickled dict of numpy arrays whose params are the JAX
package's `R2D2NetParams` (or an `AgentParams` pair). Unpickling it plainly
would import that package, and through it jax, so `load` maps those two
classes onto the port's NamedTuples with the same fields. It maps
`numpy._core` onto `numpy.core` where numpy is older than 2.0, and refuses
every other class.
"""

from __future__ import annotations

import importlib.util
import pickle
from typing import Dict

import numpy as np
import torch

from hanabi_sad_tpu_torch.agent.r2d2_agent import AgentParams
from hanabi_sad_tpu_torch.models.r2d2_net import R2D2NetParams

_PORT_CLASSES = {
    ("hanabi_sad_tpu.models.r2d2_net", "R2D2NetParams"): R2D2NetParams,
    ("hanabi_sad_tpu.agent.r2d2_agent", "AgentParams"): AgentParams,
}


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) in _PORT_CLASSES:
            return _PORT_CLASSES[(module, name)]
        if module == "numpy" or module.startswith("numpy."):
            if module.startswith("numpy._core") and importlib.util.find_spec("numpy._core") is None:
                module = "numpy.core" + module[len("numpy._core"):]
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"checkpoint refers to {module}.{name}, which the port does not load "
            "(only params payloads are supported; train_state payloads carry "
            "optimizer classes and wait for the training slice)"
        )


def load(path: str) -> Dict:
    """The payload dict of a `.pkl` checkpoint, with numpy arrays as leaves."""
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def from_jax_params(np_params, device=None) -> R2D2NetParams:
    """Carry JAX-package net params (numpy arrays; Linear `w` [in, out]; one
    collapsed LSTM bias `b`) into the port: the same layout, as contiguous
    float32 tensors on `device`."""

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [conv(v) for v in tree]
        return torch.as_tensor(np.asarray(tree, dtype=np.float32), device=device).contiguous()

    return R2D2NetParams(*(conv(getattr(np_params, f)) for f in R2D2NetParams._fields))
