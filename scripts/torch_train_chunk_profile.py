"""Where the time of one train chunk of the PyTorch port goes, on the card.

    python scripts/torch_train_chunk_profile.py [--chunks 2]

Warm-starts the flagship SAD-AUX preset (`sad_2p`, `pred_weight 0.25`,
float32, 1024 envs, batch 64 episodes x 2 players, replay 65,536) from
docs/runs/sad_aux_r4_soup10.pkl, collects one chunk, runs one train chunk to
warm up, then for each of `--chunks` train chunks prints one JSON line with
the host-clock time of its phases (each ended by torch.cuda.synchronize):
the collection (rollout, assemble, priorities, replay add) and the 16
updates; then one chunk under torch.profiler: the device's busy time (the
union of kernel intervals) against the wall time, and the kernels that take
the most device time. Needs a CUDA card.
"""

import argparse
import json
import subprocess
import time

import torch

from hanabi_sad_tpu_torch.train import learner, selfplay
from hanabi_sad_tpu_torch.train.config import make_config

FLAGSHIP = "docs/runs/sad_aux_r4_soup10.pkl"


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def phases(setup, optimizer, state):
    """One train chunk as learner.train_chunk runs it, timed in two phases:
    collect_into_replay, then the updates."""
    (state, _), t_collect = timed(lambda: learner.collect_into_replay(setup, state))

    def updates(s):
        for _ in range(setup.train.num_update_per_chunk):
            s, _ = learner.sgd_update(setup, optimizer, s)
        return s

    state, t_upd = timed(lambda: updates(state))
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=30).stdout.strip()
    dev = torch.device("cuda")
    setup = learner.make_setup(make_config("sad_2p", pred_weight=0.25, burn_in_frames=2048))
    state = learner.init_train_state(setup, setup.train.seed, dev)
    state = selfplay.load_model(FLAGSHIP, state)
    optimizer = learner.make_optimizer(setup.train)
    state, _ = learner.collect_only(setup, state)
    state, _ = learner.train_chunk(setup, optimizer, state)  # warm-up
    for i in range(args.chunks):
        state, t = phases(setup, optimizer, state)
        print(json.dumps({"chunk": i, **t, "card": card}), flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        (state, _), wall = timed(lambda: learner.train_chunk(setup, optimizer, state))
    busy, n_kernels = busy_seconds(prof.events())
    top = sorted(prof.key_averages(), key=lambda a: a.self_device_time_total, reverse=True)[:12]
    print(json.dumps({
        "profiled_chunk_wall_s": wall, "device_busy_s": busy, "device_idle_share": 1 - busy / wall,
        "device_kernels": n_kernels,
        "top_device": [{"name": a.key[:80], "calls": a.count, "device_ms": a.self_device_time_total / 1e3}
                       for a in top],
        "card": card,
    }), flush=True)


if __name__ == "__main__":
    main()
