"""Whether the PyTorch port's learner repeats its bits on the card: within
one process, and between two processes on one machine.

    python scripts/torch_update_determinism.py            # one process
    python scripts/torch_update_determinism.py --bisect [--trace_dir DIR]

Both modes warm-start the flagship SAD-AUX preset (`sad_2p`, `pred_weight
0.25`, float32, 1024 envs) from docs/runs/sad_aux_r4_soup10.pkl and collect
one chunk, as chip_smoke.py's train phase does.

Without arguments it presamples one batch and runs `learner.sgd_update`
three times from copies of that one state on that one batch: twice as it
is, and once under `torch.use_deterministic_algorithms(True,
warn_only=True)`, whose warnings name each op of the update that has no
deterministic CUDA implementation (the port's own kernels are not PyTorch
ops and are not named). It prints one JSON line: the loss and grad_norm of
each run, whether each updated parameter tensor of the two plain runs is
equal bit for bit, and the warnings.

With --bisect it runs itself twice as a child process (`--trace PATH`).
Each child runs the smoke's 3 train chunks update by update and records a
hash of every tensor an update reads or writes: after each collect the
replay's fields and the actor's hidden state; after each update the sampled
indices and IS weights, the priorities handed to `update_priority`, the
replay's weight vector, every online and target param and both Adam
moments. It also counts, per update, the duplicate rows of the sampled batch
and those among them whose priorities differ in their bits. The parent
prints one JSON line naming the first record and tensor where the two
children differ (null if none), with the duplicate counts. The traces go
to DIR (default: a temporary directory, removed afterwards). Needs a CUDA
card.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import warnings

import torch

from hanabi_sad_tpu_torch.agent.r2d2_agent import AgentParams, clone_params
from hanabi_sad_tpu_torch.replay import prioritized as replay_mod
from hanabi_sad_tpu_torch.train import learner, selfplay
from hanabi_sad_tpu_torch.train.config import make_config

FLAGSHIP = "docs/runs/sad_aux_r4_soup10.pkl"


def card_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=30).stdout.strip()


def warm_state(dev):
    """The smoke's train phase up to the end of its collect chunk."""
    setup = learner.make_setup(make_config("sad_2p", pred_weight=0.25, burn_in_frames=2048))
    state = learner.init_train_state(setup, setup.train.seed, dev)
    state = selfplay.load_model(FLAGSHIP, state)
    state, _ = learner.collect_only(setup, state)
    return setup, state


def digest(t: torch.Tensor) -> str:
    """A hash of the tensor's bits."""
    data = t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy()
    return hashlib.blake2b(data.tobytes(), digest_size=12).hexdigest()


def one_process():
    dev = torch.device("cuda")
    setup, state = warm_state(dev)
    optimizer = learner.make_optimizer(setup.train)
    idx, is_w = replay_mod.sample_indices(state.replay, setup.replay, setup.train.batchsize,
                                          generator=torch.Generator(device=dev).manual_seed(4))

    def update():
        opt = state.opt_state
        copy = state._replace(
            params=AgentParams(online=clone_params(state.params.online), target=clone_params(state.params.target)),
            opt_state=opt._replace(mu=[m.clone() for m in opt.mu], nu=[v.clone() for v in opt.nu]),
            replay=state.replay._replace(weight=state.replay.weight.clone()),
        )
        new, metrics = learner.sgd_update(setup, optimizer, copy, presampled=(is_w, idx))
        torch.cuda.synchronize()
        return learner.param_leaves(new.params.online), {k: float(metrics[k]) for k in ("loss", "grad_norm")}

    first, m1 = update()
    second, m2 = update()
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, m3 = update()
    torch.use_deterministic_algorithms(False)
    named = sorted({str(w.message).split("\n")[0][:200] for w in caught})
    print(json.dumps({
        "metrics": [m1, m2, m3],
        "params_equal": [bool(torch.equal(a, b)) for a, b in zip(first, second)],
        "params_max_abs_diff": max(float((a - b).abs().max()) for a, b in zip(first, second)),
        "nondeterministic_ops": named,
        "card": card_line(),
    }), flush=True)


def duplicate_rows(idx, priority):
    """(rows whose index occurs earlier in the batch, those among them whose
    priority differs in its bits from the first occurrence's)."""
    dups = differ = 0
    first = {}
    for i, (j, p) in enumerate(zip(idx.tolist(), priority.view(torch.int32).tolist())):
        if j in first:
            dups += 1
            differ += p != first[j]
        else:
            first[j] = p
    return dups, differ


def trace(path):
    """The smoke's 3 train chunks, one record per collect and per update."""
    dev = torch.device("cuda")
    setup, state = warm_state(dev)
    optimizer = learner.make_optimizer(setup.train)
    seen = {}
    sample, update_priority = replay_mod.sample, replay_mod.update_priority

    def recording_sample(*args, **kwargs):
        batch, is_w, idx = sample(*args, **kwargs)
        seen.update(idx=idx.clone(), is_w=is_w.clone())
        return batch, is_w, idx

    def recording_update_priority(st, cfg, idx, priority):
        seen.update(priority=priority.detach().clone())
        return update_priority(st, cfg, idx, priority)

    replay_mod.sample, replay_mod.update_priority = recording_sample, recording_update_priority
    records = []

    def collect_record(chunk, st):
        r = st.replay
        rec = {"chunk": chunk, "step": "collect"}
        for f in ("packed", "action", "reward", "bootstrap", "seq_len", "weight", "write_ptr", "size"):
            rec[f] = digest(getattr(r, f))
        rec["actor_hidden"] = digest(st.actor.hidden.h) + digest(st.actor.hidden.c)
        records.append(rec)

    collect_record("burn_in", state)
    for chunk in range(3):
        state, _ = learner.collect_into_replay(setup, state)
        collect_record(chunk, state)
        for u in range(setup.train.num_update_per_chunk):
            state, metrics = learner.sgd_update(setup, optimizer, state)
            torch.cuda.synchronize()
            dups, differ = duplicate_rows(seen["idx"], seen["priority"])
            rec = {"chunk": chunk, "step": u, "idx": digest(seen["idx"]), "is_w": digest(seen["is_w"]),
                   "priority": digest(seen["priority"]), "weight": digest(state.replay.weight),
                   "duplicate_rows": dups, "duplicate_rows_differing": differ,
                   "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"])}
            names = [f"online.{i}" for i in range(len(state.opt_state.mu))]
            for i, t in enumerate(learner.param_leaves(state.params.online)):
                rec[f"online.{i}"] = digest(t)
            for i, t in enumerate(learner.param_leaves(state.params.target)):
                rec[f"target.{i}"] = digest(t)
            for n, m, v in zip(names, state.opt_state.mu, state.opt_state.nu):
                rec[f"mu.{n}"], rec[f"nu.{n}"] = digest(m), digest(v)
            records.append(rec)
    with open(path, "w") as f:
        json.dump({"card": card_line(), "records": records}, f)


# The order in which a record's tensors are compared: what an update reads
# before what it writes.
ORDER = ("packed", "action", "reward", "bootstrap", "seq_len", "write_ptr", "size", "actor_hidden",
         "idx", "is_w", "priority", "weight")


def first_difference(a, b):
    for ra, rb in zip(a, b):
        keys = [k for k in ORDER if k in ra] + sorted(k for k in ra if k not in ORDER)
        for k in keys:
            if k in ("duplicate_rows", "duplicate_rows_differing"):
                continue
            if ra.get(k) != rb.get(k):
                return {"chunk": ra["chunk"], "step": ra["step"], "tensor": k,
                        "first": ra.get(k), "second": rb.get(k)}
    return None


def bisect(trace_dir):
    with tempfile.TemporaryDirectory() as tmp:
        out = trace_dir or tmp
        os.makedirs(out, exist_ok=True)
        runs = []
        for i in (1, 2):
            path = os.path.join(out, f"trace{i}.json")
            subprocess.run([sys.executable, __file__, "--trace", path], check=True, timeout=900)
            with open(path) as f:
                runs.append(json.load(f)["records"])
    updates = [[r for r in run if r["step"] != "collect"] for run in runs]
    print(json.dumps({
        "first_difference": first_difference(*runs),
        "records": len(runs[0]),
        "duplicate_rows": [sum(r["duplicate_rows"] for r in u) for u in updates],
        "duplicate_rows_differing": [sum(r["duplicate_rows_differing"] for r in u) for u in updates],
        "loss": [[r["loss"] for r in u][-3:] for u in updates],
        "grad_norm": [[r["grad_norm"] for r in u][-3:] for u in updates],
        "card": card_line(),
    }), flush=True)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--bisect", action="store_true")
    parser.add_argument("--trace", default=None, help="run the chunks and write their trace here")
    parser.add_argument("--trace_dir", default=None, help="with --bisect, keep the two traces here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.trace:
        trace(args.trace)
    elif args.bisect:
        bisect(args.trace_dir)
    else:
        one_process()


if __name__ == "__main__":
    main()
