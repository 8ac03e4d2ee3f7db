"""Ranks, row shards and collectives of data-parallel training (counterpart
of `hanabi_sad_tpu/parallel/mesh.py`).

The JAX package runs one SPMD program over a device mesh and lets XLA place
its collectives. The port runs one process per GPU over torch.distributed,
as torch does, where JAX shards inside one process, and places the
collectives itself. A run on W ranks computes what the one-rank run of the
same config computes; only floating-point sums may come out in another order:

  * envs: rank r steps envs [r N/W, (r + 1) N/W) of the N (`shard_train_state`
    keeps the actor's rows). Every random draw of the rollout is made over
    all N envs from a generator seeded the same on every rank, and the rank
    keeps its rows (`Shard`), as JAX's sharded threefry gives each device its
    slice of the global draw;
  * replay: every rank holds the whole ring and writes the same global arrays.
    Each rank assembles its envs' episodes and their initial priorities; the
    ranks concatenate them in rank order (`all_gather_rows`), which is the
    one-rank run's env-major slot order, so `add_packed`'s compaction puts
    every item where the one-rank run puts it. The JAX package shards the
    ring's storage over the mesh instead (its `shard_train_state`). That is
    a layout, not another result; it costs each rank the whole ring (the
    flagship's 65,536 items x 80 steps x 2 players x 110 bytes, about
    1.15 GB packed);
  * updates: every rank draws the same global indices and IS weights, runs
    its B/W rows through B3, the loss, B1 and B2, and the gradients (with the
    loss metrics) are summed in one `all_reduce_sum` before the optimizer
    step; the rows' new priorities are all-gathered and every rank writes all
    B of them;
  * params, Adam state and generators stay whole and identical on every rank.

At W = 1 (no process group) every helper here is the identity and the
trainer is the single-process one.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, List, NamedTuple, Optional, Sequence, Union

import torch
import torch.distributed as dist

from hanabi_sad_tpu_torch.device import rank_device


class Shard(NamedTuple):
    """This rank's rows of a leading axis split evenly over `world` ranks:
    rank r keeps rows [r n, (r + 1) n) of the W n. A random draw site makes
    its draw at the global row count (`total`) and keeps its rows (`take`)."""

    rank: int = 0
    world: int = 1

    def total(self, n: int) -> int:
        """The global row count of which this rank holds n."""
        return n * self.world

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global tensor."""
        if self.world == 1:
            return x
        n = local_rows(x.shape[0], self.world, "rows")
        return x[self.rank * n : (self.rank + 1) * n]


SINGLE = Shard()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of a data-parallel run, as seen from one rank."""

    rank: int = 0
    world: int = 1
    device: Optional[torch.device] = None
    group: Any = None  # the process group; None: the default one

    @property
    def shard(self) -> Shard:
        return Shard(self.rank, self.world)


def local_rows(n: int, world: int, what: str) -> int:
    """n // world, raising where `what`'s n does not divide by the ranks."""
    if n % world:
        raise ValueError(f"{what} {n} does not divide by {world} ranks")
    return n // world


def check_divisible(mesh: Mesh, **counts: int) -> None:
    """Raise unless every count (e.g. num_envs=1024, batchsize=64) divides by
    the ranks: a run must not drop to fewer ranks without saying so."""
    for what, n in counts.items():
        local_rows(n, mesh.world, what)


def make_mesh(device: Optional[Union[str, torch.device]] = None, group: Any = None) -> Mesh:
    """This process's rank and world in `group` (the default group), world 1
    when no process group is initialised. `device` is the rank's device
    (default: `rank_device()`)."""
    device = rank_device(device)
    if not dist.is_initialized():
        return Mesh(device=device)
    return Mesh(rank=dist.get_rank(group), world=dist.get_world_size(group), device=device, group=group)


def initialize_multihost(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Mesh:
    """Join the process group of a data-parallel run, one process per GPU,
    and return its Mesh.

    Explicit arguments win; else torchrun's environment: RANK, WORLD_SIZE,
    and MASTER_ADDR / MASTER_PORT through init_method "env://" (as the JAX
    one reads JAX_COORDINATOR_ADDRESS etc.). The device is `device`, else
    cuda:LOCAL_RANK (`rank_device`); CUDA ranks are bound to it. The backend
    defaults to nccl on a CUDA device and gloo on the CPU; two ranks on one
    card need gloo, since nccl refuses them. Torch needs no pre-import guard
    where JAX has one: nothing is initialised at import."""
    device = rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(
        backend,
        init_method=init_method or "env://",
        world_size=int(os.environ.get("WORLD_SIZE", "1")) if world_size is None else world_size,
        rank=int(os.environ.get("RANK", "0")) if rank is None else rank,
    )
    return make_mesh(device)


def shard_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A leading-env tensor's rows for this rank (counterpart of
    `data_sharding`), as a tensor of its own."""
    return mesh.shard.take(x).clone() if mesh.world > 1 else x


def _map_rows(tree, mesh: Mesh):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return shard_rows(tree, mesh)
    if isinstance(tree, dict):
        return {k: _map_rows(v, mesh) for k, v in tree.items()}
    return type(tree)(*(_map_rows(v, mesh) for v in tree))


def shard_train_state(state, mesh: Mesh):
    """A learner TrainState on `mesh`: the rank keeps its rows of the
    continuous actor (every leaf leads with the env axis, as the JAX
    `shard_train_state` shards it); params, Adam state, replay and generators
    stay whole. Every rank builds the same whole state first, from the same
    seed, then calls this."""
    if state.actor is not None:
        check_divisible(mesh, num_envs=state.actor.carry_len.shape[0])
    return state._replace(actor=_map_rows(state.actor, mesh), mesh=mesh)


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x summed over the ranks, in place, in one call; x is one flat buffer
    (pack several tensors into it first)."""
    if mesh.world > 1:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    return x


def all_gather_rows(tensors: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """Each tensor's rows from every rank, concatenated in rank order; every
    rank passes the same row count and shapes.

    One collective for all of them: each rank writes its rows' bytes into its
    slot of a zeroed [W, rows, bytes] uint8 buffer, and `all_reduce_sum`
    adds the buffers, so each byte is one rank's plus zeros. gloo lists only
    broadcast, all_reduce and barrier for CUDA tensors, so an all_reduce is
    what works for both backends on both device types."""
    tensors = list(tensors)
    if mesh.world == 1:
        return tensors
    n = tensors[0].shape[0]
    parts = [t.contiguous().view(torch.uint8).reshape(n, -1) for t in tensors]
    widths = [p.shape[1] for p in parts]
    buf = torch.zeros((mesh.world, n, sum(widths)), dtype=torch.uint8, device=parts[0].device)
    buf[mesh.rank] = torch.cat(parts, dim=1)
    flat = all_reduce_sum(buf, mesh).reshape(mesh.world * n, -1)
    out, start = [], 0
    for t, w in zip(tensors, widths):
        col = flat[:, start : start + w].contiguous().view(t.dtype)
        out.append(col.reshape((mesh.world * n,) + tuple(t.shape[1:])))
        start += w
    return out


def barrier(mesh: Mesh) -> None:
    """Wait for every rank (an all_reduce of one element, which both backends
    take on either device type)."""
    if mesh.world > 1:
        all_reduce_sum(torch.zeros(1, device=mesh.device), mesh)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
