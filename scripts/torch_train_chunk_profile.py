"""Where the time of one train chunk of the PyTorch port goes, on the card.

    python scripts/torch_train_chunk_profile.py [--chunks 2] [--preset P --weights W --set k=v ...]

Warm-starts the flagship SAD-AUX preset (`sad_2p`, `pred_weight 0.25`,
float32, 1024 envs, batch 64 episodes x 2 players, replay 65,536) from
docs/runs/sad_aux_r4_soup10.pkl, or `--preset` from `--weights` with `--set`
overrides (the Other-Play run: `--preset sad_aux_op_2p --weights
docs/runs/zoo/auxop_b_r5.pkl --set continuous_exact_priority=0 --set
compute_dtype=bfloat16`), collects one chunk, runs one train chunk to warm
up, then for each of `--chunks` train chunks prints one JSON line with the
host-clock time of its phases (each ended by torch.cuda.synchronize): the
collection (rollout, assemble, priorities, replay add) and the 16 updates;
then one chunk under torch.profiler: the device's busy time (the union of
kernel intervals) against the wall time, the kernels that take the most
device time, and the host ops that take the most host time and are called
the most. Needs a CUDA card.
"""

import argparse
import json
import subprocess

import torch

from hanabi_sad_tpu_torch.tools.bench_train import timed, warm_up
from hanabi_sad_tpu_torch.train import learner, selfplay
from hanabi_sad_tpu_torch.train.config import make_config, parse_overrides

FLAGSHIP = "docs/runs/sad_aux_r4_soup10.pkl"
DEV = torch.device("cuda")


def phases(setup, optimizer, state):
    """One train chunk as learner.train_chunk runs it, timed in two phases:
    collect_into_replay, then train_updates."""
    (state, _), t_collect = timed(lambda: learner.collect_into_replay(setup, state), DEV)
    (state, _), t_upd = timed(lambda: learner.train_updates(setup, optimizer, state), DEV)
    return state, {"collect_s": t_collect, "updates_s": t_upd, "chunk_s": t_collect + t_upd}


def busy_seconds(events):
    """Length of the union of the device kernels' intervals, in seconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy * 1e-6, len(spans)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", type=int, default=2)
    ap.add_argument("--preset", default="sad_2p")
    ap.add_argument("--weights", default=FLAGSHIP)
    ap.add_argument("--set", action="append", metavar="KEY=VALUE", help="override a TrainConfig field")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=30).stdout.strip()
    overrides = dict(pred_weight=0.25, burn_in_frames=2048, **parse_overrides(args.set))
    setup = learner.make_setup(make_config(args.preset, **overrides))
    print(json.dumps({"preset": args.preset, "weights": args.weights, "overrides": overrides}), flush=True)
    state = learner.init_train_state(setup, setup.train.seed, DEV)
    state = selfplay.load_model(args.weights, state)
    optimizer = learner.make_optimizer(setup.train)
    state, _ = warm_up(setup, optimizer, state)
    for i in range(args.chunks):
        state, t = phases(setup, optimizer, state)
        print(json.dumps({"chunk": i, **t, "card": card}), flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        (state, _), wall = timed(lambda: learner.train_chunk(setup, optimizer, state), DEV)
    busy, n_kernels = busy_seconds(prof.events())
    averages = prof.key_averages()
    top = sorted(averages, key=lambda a: a.self_device_time_total, reverse=True)[:12]
    host = [a for a in averages if a.key.startswith("aten::") or a.key.startswith("cuda")]
    row = lambda a: {"name": a.key[:60], "calls": a.count, "host_ms": a.self_cpu_time_total / 1e3}
    print(json.dumps({
        "profiled_chunk_wall_s": wall, "device_busy_s": busy, "device_idle_share": 1 - busy / wall,
        "device_kernels": n_kernels,
        "top_device": [{"name": a.key[:80], "calls": a.count, "device_ms": a.self_device_time_total / 1e3}
                       for a in top],
        "host_ops": sum(a.count for a in host),
        "top_host_time": [row(a) for a in sorted(host, key=lambda a: a.self_cpu_time_total, reverse=True)[:15]],
        "top_host_calls": [row(a) for a in sorted(host, key=lambda a: a.count, reverse=True)[:10]],
        "card": card,
    }), flush=True)


if __name__ == "__main__":
    main()
