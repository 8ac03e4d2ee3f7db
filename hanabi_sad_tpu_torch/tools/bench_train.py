"""Training-throughput microbenchmark (counterpart of
`hanabi_sad_tpu/tools/bench_train.py`).

Times the steady-state train chunk (rollout with the model in the loop,
replay, learner updates) and reports the actor and learner frame rates.

  python -m hanabi_sad_tpu_torch.tools.bench_train --compute_dtype bfloat16

Runs on the CUDA card unless --device says otherwise (--device cpu); on the
card each clock read follows a torch.cuda.synchronize(). The rates are over
all `--reps` timed chunks together: the env steps the chunks really took,
and their padded and train frames, over the chunks' summed time; the chunk
time printed is their mean. The JAX tool's --rollout_unroll and
--net_seq_unroll are XLA scan unroll factors: the port's loops are eager, so
it has no such flags.

`timed`, `warm_up` and `timed_chunks` are also what
scripts/torch_train_chunk_profile.py times its chunks with.
"""

from __future__ import annotations

import argparse
import time

import torch

from hanabi_sad_tpu_torch.device import resolve_device
from hanabi_sad_tpu_torch.train import learner
from hanabi_sad_tpu_torch.train.config import make_config


def timed(fn, device):
    """fn() and its wall time in seconds; on the card each clock read
    follows a torch.cuda.synchronize()."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def warm_up(setup, optimizer, state):
    """Fill the replay with one collected chunk, then run one train chunk."""
    state, _ = learner.collect_only(setup, state)
    return learner.train_chunk(setup, optimizer, state)


def timed_chunks(setup, optimizer, state, reps: int, device):
    """Run `reps` train chunks: (state, each chunk's seconds, the env steps
    all of them really took)."""
    times, env_steps = [], 0.0
    for _ in range(reps):
        (state, metrics), t = timed(lambda: learner.train_chunk(setup, optimizer, state), device)
        times.append(t)
        env_steps += float(metrics["chunk_frames"])
    return state, times, env_steps


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--preset", default="sad_2p")
    parser.add_argument("--num_envs", type=int, default=1024)
    parser.add_argument("--updates", type=int, default=16)
    parser.add_argument("--batchsize", type=int, default=128)
    parser.add_argument("--replay_buffer_size", type=int, default=2 ** 15)
    parser.add_argument("--compute_dtype", default="float32")
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--device", default=None, type=str, help="default: cuda")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    cfg = make_config(
        args.preset,
        num_envs=args.num_envs,
        num_update_per_chunk=args.updates,
        batchsize=args.batchsize,
        replay_buffer_size=args.replay_buffer_size,
        burn_in_frames=1,
        compute_dtype=args.compute_dtype,
    )
    setup = learner.make_setup(cfg)
    cfg = setup.train
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(
        f"device={device} ({name}) envs={cfg.num_envs} updates/chunk="
        f"{cfg.num_update_per_chunk} batch={cfg.batchsize} dtype={cfg.compute_dtype}"
    )

    state = learner.init_train_state(setup, 0, device)
    optimizer = learner.make_optimizer(cfg)

    (state, metrics), t_first = timed(lambda: warm_up(setup, optimizer, state), device)
    print(f"first collect + chunk: {t_first:.1f}s loss={float(metrics['loss']):.3f}")

    state, times, env_steps = timed_chunks(setup, optimizer, state, args.reps, device)
    total = sum(times)
    dt = total / len(times)
    padded_steps = len(times) * cfg.num_envs * cfg.max_len
    train_frames = len(times) * cfg.num_update_per_chunk * cfg.batchsize * cfg.max_len
    updates = len(times) * cfg.num_update_per_chunk

    rates = {
        "chunk_ms": dt * 1000,
        "env_steps_per_s": env_steps / total,
        "padded_steps_per_s": padded_steps / total,
        "train_frames_per_s": train_frames / total,
        "updates_per_s": updates / total,
        "env_steps": env_steps,
        "chunk_s": times,
    }
    print(
        f"steady chunk: {dt * 1000:.0f} ms | "
        f"{env_steps / total:,.0f} env-steps/s ({padded_steps / total:,.0f} padded) | "
        f"{train_frames / total:,.0f} train frames/s | "
        f"{updates / total:.1f} grad updates/s"
    )
    return rates


if __name__ == "__main__":
    main()
