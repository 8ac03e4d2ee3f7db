from hanabi_sad_tpu_torch.parallel.mesh import (
    SINGLE,
    Mesh,
    Shard,
    all_gather_rows,
    all_reduce_sum,
    barrier,
    check_divisible,
    initialize_multihost,
    make_mesh,
    shard_rows,
    shard_train_state,
)

__all__ = [
    "SINGLE",
    "Mesh",
    "Shard",
    "all_gather_rows",
    "all_reduce_sum",
    "barrier",
    "check_divisible",
    "initialize_multihost",
    "make_mesh",
    "shard_rows",
    "shard_train_state",
]
