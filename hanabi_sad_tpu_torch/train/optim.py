"""Clip-then-Adam (counterpart of `hanabi_sad_tpu/train/learner.py:
make_optimizer`), with optax's semantics written in plain torch:

  * clip by global norm: g * max_norm / norm when norm >= max_norm, computed
    as (g / norm) * max_norm as optax does; torch's clip_grad_norm_ divides
    by norm + 1e-6 instead, so it is not used;
  * Adam with bias correction and eps outside the square root:
    mu_hat / (sqrt(nu_hat) + eps);
  * the lr is a constant or a linear schedule, indexed by the schedule's
    own step count before its increment, as optax keeps it apart from
    Adam's.

The state is named as optax names it (`mu`, `nu`, `count`, and `lr_count`
for optax's `ScaleByScheduleState.count`), so a JAX `train_state` payload
maps onto it (`train/checkpoint.py`). Params are updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple

import torch


class AdamState(NamedTuple):
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    count: int  # updates taken so far (bias correction)
    lr_count: int  # the lr schedule's step count


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: init -> end over transition_steps, then held."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count: int) -> float:
        frac = 1 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every element squared (a 0-d tensor)."""
    return torch.sqrt(sum(t.square().sum() for t in tensors))


@dataclasses.dataclass(frozen=True)
class ClipAdam:
    """clip_by_global_norm(max_norm) followed by adam(lr, b1, b2, eps)."""

    lr: Callable[[int], float]
    max_norm: float
    eps: float
    b1: float = 0.9
    b2: float = 0.999

    def init(self, params: List[torch.Tensor]) -> AdamState:
        return AdamState(
            mu=[torch.zeros_like(p, memory_format=torch.contiguous_format) for p in params],
            nu=[torch.zeros_like(p, memory_format=torch.contiguous_format) for p in params],
            count=0,
            lr_count=0,
        )

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor], state: AdamState):
        """Clip `grads`, update `state` and `params` in place. Returns
        (new state, the global norm of the unclipped grads)."""
        norm = global_norm(grads)
        keep = norm < self.max_norm
        count = state.count + 1
        # 1 - decay**count in float32, as optax takes it.
        f32 = lambda x: torch.tensor(x, dtype=torch.float32)
        bc1, bc2 = float(1 - f32(self.b1) ** count), float(1 - f32(self.b2) ** count)
        step_size = -self.lr(state.lr_count)
        for p, g, m, v in zip(params, grads, state.mu, state.nu):
            g = torch.where(keep, g, (g / norm) * self.max_norm)
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g.square())
            update = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            p.add_(step_size * update)
        return AdamState(mu=state.mu, nu=state.nu, count=count, lr_count=state.lr_count + 1), norm
