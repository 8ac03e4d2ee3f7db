"""Checkpoints in the JAX package's pickle format, read and written without
JAX (counterpart of `hanabi_sad_tpu/train/checkpoint.py`).

A `.pkl` payload is a pickled dict of numpy arrays:

  * `kind="params"`: the online net (or an online/target pair) as the JAX
    package's `R2D2NetParams` (`AgentParams`), and optionally the config;
  * `kind="train_state"`: params, the optax state of clip-then-Adam, the
    update counter and the PRNG keys `env_key` and `sample_key`; not the
    replay, whose distribution regenerates within one burn-in.

Unpickling such a payload plainly would import the JAX package and optax,
and through them jax. So `load` maps those classes onto stand-ins with the
same fields: `R2D2NetParams` and `AgentParams` onto the port's NamedTuples,
and optax's `EmptyState`, `ScaleByAdamState` and `ScaleByScheduleState`
onto the NamedTuples below. It maps `numpy._core` onto `numpy.core` where
numpy is older than 2.0, and refuses every other class. `save` writes the
same classes back under the JAX package's and optax's names, without
importing them, so the JAX package loads what the port writes.

The optimizer state maps onto `optim.AdamState`: optax's `mu` and `nu`
(pytrees of the online net) become lists in `learner.param_leaves` order,
`ScaleByAdamState.count` becomes `count` and the schedule's count becomes
`lr_count`, which `restore_train_state` sets from `num_update` as the JAX
`fix_schedule_count` does.

Random streams (a documented deviation): JAX's `env_key` and `sample_key`
cannot seed torch's Philox to the same streams. A port payload copies the
key words through unchanged and adds the states of the port's own
generators under `torch_generators`. Restoring a JAX payload, or a port
payload written on another device type, seeds the port's generators from the
key words (word 0 * 2**32 + word 1). So a resumed run draws other decks and
batches than the JAX package would, as every port run already does; a port
payload resumed on the device type that wrote it continues its streams
exactly.

A data-parallel run (`parallel/mesh.py`) holds the same state on every rank:
rank 0 alone writes its payloads (`train/selfplay.py`), and every rank loads
`--load_model`; the actor is in no payload, so each rank resumes from its
own freshly reset envs.
"""

from __future__ import annotations

import importlib.util
import pickle
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from hanabi_sad_tpu_torch.agent.r2d2_agent import AgentParams
from hanabi_sad_tpu_torch.models.r2d2_net import R2D2NetParams
from hanabi_sad_tpu_torch.train.learner import param_leaves
from hanabi_sad_tpu_torch.train.optim import AdamState


class EmptyState(NamedTuple):
    """optax's `EmptyState` (the state of clip_by_global_norm)."""


class ScaleByAdamState(NamedTuple):
    """optax's `ScaleByAdamState`."""

    count: Any
    mu: Any
    nu: Any


class ScaleByScheduleState(NamedTuple):
    """optax's `ScaleByScheduleState` (the lr schedule's step count)."""

    count: Any


# The classes a payload names, and the port's class for each.
_JAX_NAMES = {
    ("hanabi_sad_tpu.models.r2d2_net", "R2D2NetParams"): R2D2NetParams,
    ("hanabi_sad_tpu.agent.r2d2_agent", "AgentParams"): AgentParams,
    ("optax._src.base", "EmptyState"): EmptyState,
    ("optax._src.transform", "ScaleByAdamState"): ScaleByAdamState,
    ("optax._src.transform", "ScaleByScheduleState"): ScaleByScheduleState,
}
_PORT_TO_JAX = {cls: name for name, cls in _JAX_NAMES.items()}


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) in _JAX_NAMES:
            return _JAX_NAMES[(module, name)]
        if module == "numpy" or module.startswith("numpy."):
            if module.startswith("numpy._core") and importlib.util.find_spec("numpy._core") is None:
                module = "numpy.core" + module[len("numpy._core"):]
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"checkpoint refers to {module}.{name}, which the port does not load "
            "(it loads the params and train_state payloads of the JAX package and of the port)"
        )


class _Pickler(pickle._Pickler):
    """The pure-Python pickler, writing the port's stand-in classes under
    the JAX package's and optax's names without importing them."""

    def save_global(self, obj, name=None):
        if obj in _PORT_TO_JAX:
            module, qualname = _PORT_TO_JAX[obj]
            self.save(module)
            self.save(qualname)
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)
            return
        super().save_global(obj, name)


def load(path: str) -> Dict:
    """The payload dict of a `.pkl` checkpoint, with numpy arrays as leaves."""
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def save(path: str, payload: Dict) -> None:
    with open(path, "wb") as f:
        _Pickler(f, protocol=pickle.DEFAULT_PROTOCOL).dump(payload)


def from_jax_params(np_params, device=None) -> R2D2NetParams:
    """Carry JAX-package net params (numpy arrays; Linear `w` [in, out]; one
    collapsed LSTM bias `b`) into the port: the same layout, as contiguous
    float32 tensors on `device` that own their memory (the trainer updates
    params in place, so they must not alias the caller's arrays)."""

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [conv(v) for v in tree]
        # C order whatever the array's order: torch.tensor keeps a
        # Fortran-ordered array's strides, and a product over another
        # layout rounds differently on the card.
        return torch.tensor(np.ascontiguousarray(tree, dtype=np.float32), device=device)

    return R2D2NetParams(*(conv(getattr(np_params, f)) for f in R2D2NetParams._fields))


def to_numpy_params(params: R2D2NetParams) -> R2D2NetParams:
    """The port's net params as the JAX package keeps them: numpy arrays in
    the same NamedTuple, lists and dicts."""

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [conv(v) for v in tree]
        return tree.detach().cpu().numpy().copy()

    return R2D2NetParams(*(conv(getattr(params, f)) for f in R2D2NetParams._fields))


def _leaves_to_net(leaves, template: R2D2NetParams) -> R2D2NetParams:
    """Tensors in `param_leaves` order (fields in order, dict keys sorted)
    back into the net's structure, as numpy arrays."""
    it = iter(leaves)
    fields = []
    for field in template:
        dicts = field if isinstance(field, list) else [field]
        out = [{k: next(it).detach().cpu().numpy().copy() for k in sorted(d)} for d in dicts]
        fields.append(out if isinstance(field, list) else out[0])
    return R2D2NetParams(*fields)


def _net_leaves(np_net, device) -> list:
    return [t.contiguous() for t in param_leaves(from_jax_params(np_net, device))]


def params_payload(params, config_dict: Optional[Dict] = None) -> Dict:
    """Weights-only payload of an online net (`R2D2NetParams`) or an
    `AgentParams` pair, with the config when given."""
    if isinstance(params, AgentParams):
        saved = AgentParams(online=to_numpy_params(params.online), target=to_numpy_params(params.target))
    else:
        saved = to_numpy_params(params)
    out = {"kind": "params", "params": saved}
    if config_dict is not None:
        out["config"] = dict(config_dict)
    return out


def _key_words(seed: int) -> np.ndarray:
    return np.asarray([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], dtype=np.uint32)


def _seed_of(key) -> int:
    key = np.asarray(key, dtype=np.uint32).reshape(-1)
    return (int(key[0]) << 32) | int(key[1])


def train_state_payload(state, config_dict: Dict) -> Dict:
    """Full-resume payload of a `learner.TrainState`, in the JAX package's
    layout (opt_state = (EmptyState(), (ScaleByAdamState, ScaleByScheduleState)))
    plus the port's generator states. The replay is not saved."""
    opt = state.opt_state
    online = state.params.online
    count = lambda c: np.asarray(c, dtype=np.int32)
    return {
        "kind": "train_state",
        "config": dict(config_dict),
        "params": AgentParams(online=to_numpy_params(online), target=to_numpy_params(state.params.target)),
        "opt_state": (
            EmptyState(),
            (
                ScaleByAdamState(count=count(opt.count), mu=_leaves_to_net(opt.mu, online),
                                 nu=_leaves_to_net(opt.nu, online)),
                ScaleByScheduleState(count=count(opt.lr_count)),
            ),
        ),
        "num_update": int(state.num_update),
        "env_key": _key_words(state.env_gen.initial_seed()),
        "sample_key": _key_words(state.sample_gen.initial_seed()),
        "torch_generators": {
            "device_type": state.env_gen.device.type,
            "env": state.env_gen.get_state().numpy(),
            "sample": state.sample_gen.get_state().numpy(),
        },
    }


def _find(tree, cls):
    """The first instance of `cls` in a tree of tuples, lists and dicts."""
    if isinstance(tree, cls):
        return tree
    children = tree.values() if isinstance(tree, dict) else tree if isinstance(tree, (tuple, list)) else ()
    for child in children:
        found = _find(child, cls)
        if found is not None:
            return found
    return None


def _restore_generator(gen: torch.Generator, key, saved_state: Optional[np.ndarray]):
    if saved_state is not None:
        gen.set_state(torch.from_numpy(np.array(saved_state, dtype=np.uint8)))
    else:
        gen.manual_seed(_seed_of(key))


def restore_train_state(payload: Dict, state):
    """A `learner.TrainState` from a `train_state` payload (the JAX
    package's or the port's), onto a freshly initialised `state`, which
    supplies the device, the replay and the actor.

    Raises where the payload's optimizer state holds no `ScaleByAdamState`
    or its moments do not match the net; unlike the JAX package, it never
    keeps the fresh moments in their place."""
    if payload.get("kind") != "train_state":
        raise ValueError(f"not a train_state payload: kind={payload.get('kind')!r}")
    device = state.params.online.lstm[0]["w_hh"].device
    adam = _find(payload["opt_state"], ScaleByAdamState)
    if adam is None:
        raise ValueError("the payload's opt_state holds no ScaleByAdamState")
    params = load_params_into(payload, state.params)
    mu, nu = _net_leaves(adam.mu, device), _net_leaves(adam.nu, device)
    for name, moments in (("mu", mu), ("nu", nu)):
        shapes = [tuple(t.shape) for t in moments]
        if shapes != [tuple(t.shape) for t in param_leaves(params.online)]:
            raise ValueError(f"the payload's Adam {name} does not match the net's shapes")
    num_update = int(payload["num_update"])
    gens = payload.get("torch_generators") or {}
    same_device = gens.get("device_type") == state.env_gen.device.type
    _restore_generator(state.env_gen, payload["env_key"], gens.get("env") if same_device else None)
    _restore_generator(state.sample_gen, payload["sample_key"], gens.get("sample") if same_device else None)
    return state._replace(
        params=params,
        opt_state=AdamState(mu=mu, nu=nu, count=int(adam.count), lr_count=num_update),
        num_update=num_update,
    )


def load_params_into(payload: Dict, params_template: AgentParams) -> AgentParams:
    """A weights payload onto the device of an `AgentParams` template. A
    full online/target pair keeps its target; a bare online net (what
    TopkSaver payloads carry) initialises both, as the JAX package's
    `load_params_into` does."""
    device = params_template.online.lstm[0]["w_hh"].device
    saved = payload["params"]
    if isinstance(saved, AgentParams):
        return AgentParams(online=from_jax_params(saved.online, device), target=from_jax_params(saved.target, device))
    return AgentParams(online=from_jax_params(saved, device), target=from_jax_params(saved, device))
