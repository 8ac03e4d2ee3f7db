"""From-scratch learning curve of the port's flagship trainer, held against
the JAX package's from-scratch learning curves.

Trains `hanabi_sad_tpu_torch.train.selfplay` from random weights with the
flagship run's flags (`docs/runs/sad_aux_r1_train.log`'s printed config:
`sad_2p`, pred_weight 0.25, seed 31, initial priorities from the rollout's
online Q, lr 6.25e-5 -> 1e-5 over 1,100,000 updates), prints one JSON line
an epoch (eval, update count, the epoch's means of loss, rl_loss, aux1 and
grad_norm, and the JAX runs' band at that epoch) and a last verdict line on
the gates below. The JAX curves are parsed from the shipped logs at run
time; only their scores are used, never their speeds.

    # on the card: 12 epochs of the bf16 flagship (the shipped dtype)
    python scripts/torch_learning_curve.py --compute_dtype bfloat16 --num_epoch 12 \\
        --save_dir exps/curve_bf16
    # a later leg, from the last leg's latest.pkl (the replay refills
    # through burn-in, as a JAX resume does; legs count updates, 992 an epoch)
    python scripts/torch_learning_curve.py --compute_dtype bfloat16 --num_epoch 28 \\
        --resume exps/curve_bf16/latest.pkl --save_dir exps/curve_bf16_leg2
    # read a finished run (and the legs before it) without training
    python scripts/torch_learning_curve.py --report exps/curve_bf16_leg2
    # the float32 run's evals and loss means minus the bf16 run's, epoch by epoch
    python scripts/torch_learning_curve.py --drift exps/curve_f32 exps/curve_bf16

Any other flag goes to the trainer as it is (e.g. `--seed 32`, or `--device
cpu --num_envs 8 --rnn_hid_dim 32` for a small run on the CPU). `--plain`
runs B1, B2 and B3's plain PyTorch versions in place of the kernels, to
tell a kernel's fault from the trainer's. The run stops at
`--watchdog_s` seconds: it then prints the epochs it finished and a verdict
with "cut": true, and exits 124.

Gates (set from the four JAX logs before the port's first run):
  * the epoch-2 eval lies in EVAL_EPOCH2_BAND = [1.5, 4.0]: the four JAX
    runs score 2.09-2.95 at epoch 2, and every shipped from-scratch log
    0.63-1.09 at epoch 0;
  * aux1's epoch mean falls by at least AUX1_DROP = 0.04 from epoch 0 to
    epoch 2 (JAX: 0.068 and 0.106);
  * the mean eval over epochs 8-11 lies in EVAL_8_11_BAND = [2.2, 5.9], the
    four runs' 3.22-4.39 less 1.0 and plus 1.5;
  * every metric is finite.
A run of fewer epochs is held to the gates its epochs reach. The mean eval
over epochs 36-39 is reported beside the JAX runs' 8.95-11.90, no gate."""

from __future__ import annotations

import argparse
import ast
import json
import math
import os
import re
import sys
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# The JAX package's from-scratch runs of the flagship's algorithm (sad_2p,
# pred_weight 0.25, VDN, the continuous rollout, initial priorities from the
# online Q, 1024 envs, 62 chunks of 16 updates an epoch).
JAX_LOGS = {
    "sad_aux_r1": "docs/runs/sad_aux_r1_train.log",  # the flagship, bf16, seed 31
    "auxop_a": "docs/runs/zoo/auxop_a_train.log",  # float32, shuffle_color, 400-game evals
    "auxop_b": "docs/runs/zoo/auxop_b_train.log",  # bf16, shuffle_color
    "auxop_c": "docs/runs/zoo/auxop_c_train.log",  # bf16, shuffle_color
}
UPDATES_PER_EPOCH = 992  # the flagship's 62 chunks of 16 updates
# The flagship's flag line beyond --compute_dtype, --num_epoch and --save_dir.
FLAGSHIP_FLAGS = ("--preset", "sad_2p", "--pred_weight", "0.25", "--seed", "31", "--continuous_exact_priority", "0",
                  "--lr_final", "1e-5", "--lr_decay_updates", "1100000")
EVAL_EPOCH2_BAND = (1.5, 4.0)
AUX1_DROP = 0.04
EVAL_8_11 = range(8, 12)
EVAL_8_11_BAND = (2.2, 5.9)
EVAL_36_39 = range(36, 40)  # reported, no gate
ROW_KEYS = ("loss", "rl_loss", "aux1", "grad_norm", "chunk_score", "chunk_len")
POLL_S = 10.0  # how often a run's train.log is read for finished epochs

_METRIC = re.compile(r"^(\w+)\s*\[\s*\d+\]: avg:\s*(\S+),")
_EVAL = re.compile(r"^epoch (\d+), eval score: (\S+), perfect: (\S+),")
_TOTAL = re.compile(r"^Total Time: .*, (\d+)s$")


def flag_line(compute_dtype: str, num_epoch: int, save_dir: str, resume: str = "",
              extra: Sequence[str] = ()) -> List[str]:
    """The trainer's argv for the flagship from scratch (or, with `resume`,
    from a leg's latest.pkl)."""
    flags = [*FLAGSHIP_FLAGS, "--compute_dtype", compute_dtype, "--num_epoch", str(num_epoch), "--save_dir", save_dir]
    if resume:
        flags += ["--load_model", resume]
    return flags + list(extra)


def parse_train_log(path) -> Dict:
    """A train.log of either package: its printed config, the update it
    resumed at (0 from scratch) and one row an epoch with an eval: epoch,
    eval, perfect, the epoch means printed, and the run's seconds so far."""
    lines = Path(path).read_text().splitlines()
    end = next(i for i, line in enumerate(lines) if line.rstrip().endswith("}"))
    config = ast.literal_eval("\n".join(lines[: end + 1]))
    resumed, rows, cur = 0, [], {}
    for line in lines[end + 1:]:
        if line.startswith("resumed at update "):
            resumed = int(line.split()[-1])
        elif line.startswith("EPOCH: "):
            cur = {"epoch": int(line.split()[1])}
        elif m := _TOTAL.match(line):
            cur["wall_s"] = int(m.group(1))
        elif (m := _METRIC.match(line)) and m.group(1) in ROW_KEYS:
            cur[m.group(1)] = float(m.group(2))
        elif m := _EVAL.match(line):
            rows.append({**cur, "epoch": int(m.group(1)), "eval": float(m.group(2)), "perfect": float(m.group(3))})
    return {"config": config, "resumed_at": resumed, "rows": rows}


def updates_per_epoch(config: Dict) -> int:
    return (config["epoch_len"] // config["num_update_per_chunk"]) * config["num_update_per_chunk"]


def leg_logs(save_dir) -> List[Path]:
    """The run's train.log files, oldest leg first: a leg that loaded a
    latest.pkl follows the train.log beside it, or, for legs moved
    together, the one in the directory of that name beside its own."""
    logs, log = [], Path(save_dir) / "train.log"
    while log.exists() and log not in logs:
        logs.insert(0, log)
        prev = parse_train_log(log)["config"].get("load_model", "")
        if not prev or Path(prev).name != "latest.pkl":
            break
        moved = log.parent.parent / Path(prev).parent.name / "train.log"
        log = Path(prev).parent / "train.log"
        log = log if log.exists() else moved
    return logs


def curve(logs: Sequence) -> List[Dict]:
    """The epoch rows of a run's legs, placed by update count: a leg that
    resumed at update N starts at epoch N / updates_per_epoch."""
    by_epoch = {}
    for log in logs:
        run = parse_train_log(log)
        upe = updates_per_epoch(run["config"])
        for row in run["rows"]:
            updates = run["resumed_at"] + (row["epoch"] + 1) * upe
            by_epoch[updates // upe - 1] = {**row, "epoch": updates // upe - 1, "updates": updates,
                                            "leg_epoch": row["epoch"]}
    return [by_epoch[e] for e in sorted(by_epoch)]


def jax_curves(root=ROOT) -> Dict[str, Dict[int, Dict]]:
    """{log name: {epoch: row}} of the JAX package's from-scratch logs."""
    out = {}
    for name, rel in JAX_LOGS.items():
        run = parse_train_log(Path(root) / rel)
        assert updates_per_epoch(run["config"]) == UPDATES_PER_EPOCH and run["resumed_at"] == 0, rel
        out[name] = {r["epoch"]: r for r in run["rows"]}
    return out


def mean_eval(rows_by_epoch: Dict[int, Dict], epochs) -> Optional[float]:
    if not all(e in rows_by_epoch for e in epochs):
        return None
    return sum(rows_by_epoch[e]["eval"] for e in epochs) / len(epochs)


def jax_summary(curves: Dict[str, Dict[int, Dict]]) -> Dict[str, Dict]:
    """Each JAX log's evals at epochs 0 / 2 / 5 / 10, its mean evals over
    epochs 8-11 and 36-39, and its aux1 means at epochs 0 and 2."""
    return {name: {"eval": {e: by[e]["eval"] for e in (0, 2, 5, 10)},
                   "mean_eval_8_11": mean_eval(by, EVAL_8_11), "mean_eval_36_39": mean_eval(by, EVAL_36_39),
                   "aux1": {e: by[e].get("aux1") for e in (0, 2)}}
            for name, by in curves.items()}


def jax_band(curves: Dict[str, Dict[int, Dict]], epoch: int) -> Optional[Dict]:
    """The JAX runs' eval range at `epoch` (the same update count)."""
    evals = [by[epoch]["eval"] for by in curves.values() if epoch in by]
    return {"min": min(evals), "max": max(evals), "logs": len(evals)} if evals else None


def epoch_line(row: Dict, curves, upe: int) -> Dict:
    band = jax_band(curves, row["epoch"]) if upe == UPDATES_PER_EPOCH else None
    return {"epoch": row["epoch"], "updates": row["updates"], "eval": row["eval"],
            **{k: row.get(k) for k in ("loss", "rl_loss", "aux1", "grad_norm", "chunk_score", "wall_s")},
            "jax_band": band}


def verdict(rows: Sequence[Dict], want_epochs: int, curves=None) -> Dict:
    """The gates on a run's epoch rows. A gate whose epochs the run did not
    reach is None; the run passes when every gate that `want_epochs` epochs
    reach is True."""
    by = {r["epoch"]: r for r in rows}
    gates = {"eval_epoch2": None, "aux1_drop": None, "eval_mean_8_11": None}
    if 2 in by:
        gates["eval_epoch2"] = EVAL_EPOCH2_BAND[0] <= by[2]["eval"] <= EVAL_EPOCH2_BAND[1]
        if 0 in by:
            gates["aux1_drop"] = by[0]["aux1"] - by[2]["aux1"] >= AUX1_DROP
    mean_8_11 = mean_eval(by, EVAL_8_11)
    if mean_8_11 is not None:
        gates["eval_mean_8_11"] = EVAL_8_11_BAND[0] <= mean_8_11 <= EVAL_8_11_BAND[1]
    gates["finite"] = all(math.isfinite(v) for r in rows for v in r.values() if isinstance(v, float))
    need = ["finite"] + (["eval_epoch2", "aux1_drop"] if want_epochs >= 3 else []) + (
        ["eval_mean_8_11"] if want_epochs >= max(EVAL_8_11) + 1 else [])
    out = {"verdict": "pass" if rows and all(gates[g] is True for g in need) else "fail", "gates": gates,
           "epochs": len(rows), "want_epochs": want_epochs,
           "eval_epoch2": by[2]["eval"] if 2 in by else None,
           "aux1_drop": by[0]["aux1"] - by[2]["aux1"] if 0 in by and 2 in by else None,
           "mean_eval_8_11": mean_8_11, "mean_eval_36_39": mean_eval(by, EVAL_36_39),
           "bands": {"eval_epoch2": EVAL_EPOCH2_BAND, "aux1_drop_min": AUX1_DROP, "eval_mean_8_11": EVAL_8_11_BAND}}
    if curves is not None:
        out["jax"] = {k: [s[k] for s in jax_summary(curves).values()] for k in ("mean_eval_8_11", "mean_eval_36_39")}
    return out


def drift(a_rows: Sequence[Dict], b_rows: Sequence[Dict]) -> List[Dict]:
    """Epoch by epoch, run a's eval and epoch means minus run b's."""
    b_by = {r["epoch"]: r for r in b_rows}
    keys = ("eval", "loss", "rl_loss", "aux1", "grad_norm")
    return [{"epoch": r["epoch"], **{k: r[k] - b_by[r["epoch"]][k] for k in keys
                                     if r.get(k) is not None and b_by[r["epoch"]].get(k) is not None}}
            for r in a_rows if r["epoch"] in b_by]


class Reporter:
    """Prints each finished epoch of a run (its legs included) once, as one
    JSON line, to the stream it was given."""

    def __init__(self, save_dir, out, curves):
        self.save_dir, self.out, self.curves = save_dir, out, curves
        self.printed, self.lock = set(), threading.Lock()

    def poll(self) -> List[Dict]:
        with self.lock:
            logs = leg_logs(self.save_dir)
            if not logs:
                return []
            rows = curve(logs)
            upe = updates_per_epoch(parse_train_log(logs[-1])["config"])
            for row in rows:
                if row["epoch"] not in self.printed:
                    self.printed.add(row["epoch"])
                    self.out.write(json.dumps(epoch_line(row, self.curves, upe)) + "\n")
            self.out.flush()
            return rows

    def finish(self, want_epochs: int, **extra) -> Dict:
        rows = self.poll()
        out = {**verdict(rows, want_epochs, self.curves), **extra}
        with self.lock:
            self.out.write(json.dumps(out) + "\n")
            self.out.flush()
        return out


def want_epochs_of(save_dir) -> int:
    """The epochs a run's last leg asked to reach, counted from the first
    leg: its resume point plus its num_epoch."""
    run = parse_train_log(Path(save_dir) / "train.log")
    return run["resumed_at"] // updates_per_epoch(run["config"]) + run["config"]["num_epoch"]


def use_plain_versions() -> None:
    """B1, B2 and B3's plain PyTorch versions in place of the kernels, on
    any device (a diagnostic: the trainer's code path is unchanged, the
    plain LSTM differentiated by autograd)."""
    from hanabi_sad_tpu_torch.ops import lstm_seq as lstm_op
    from hanabi_sad_tpu_torch.ops import sample_batch as sample_op

    lstm_op.lstm_seq = lstm_op.lstm_seq_diff = lstm_op.lstm_seq_plain
    sample_op.sample_batch = sample_op.sample_batch_plain


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--compute_dtype", default="bfloat16", choices=("bfloat16", "float32"))
    parser.add_argument("--num_epoch", type=int, default=12)
    parser.add_argument("--save_dir", default="exps/learning_curve")
    parser.add_argument("--resume", default="", help="a leg's latest.pkl to continue from")
    parser.add_argument("--watchdog_s", type=float, default=3300.0)
    parser.add_argument("--plain", action="store_true", help="run the kernels' plain versions (use_plain_versions)")
    parser.add_argument("--report", default="", help="print a finished run's epoch lines and verdict; no training")
    parser.add_argument("--drift", nargs=2, default=None, metavar=("RUN_A", "RUN_B"),
                        help="run a's evals and epoch means minus run b's; no training")
    args, extra = parser.parse_known_args(argv)
    out = sys.stdout
    curves = jax_curves()
    if args.drift:
        a, b = (curve(leg_logs(d)) for d in args.drift)
        for line in drift(a, b):
            out.write(json.dumps(line) + "\n")
        return 0
    if args.report:
        result = Reporter(args.report, out, curves).finish(want_epochs_of(args.report))
        return 0 if result["verdict"] == "pass" else 1

    from hanabi_sad_tpu_torch.train import selfplay

    if args.plain:
        use_plain_versions()
    flags = flag_line(args.compute_dtype, args.num_epoch, args.save_dir, args.resume, extra)
    out.write(json.dumps({"flags": flags, "plain": args.plain, "jax": jax_summary(curves)}) + "\n")
    out.flush()
    reporter = Reporter(args.save_dir, out, curves)
    want = args.num_epoch + (want_epochs_of(Path(args.resume).parent) if args.resume else 0)
    done = threading.Event()

    def poll_loop():
        while not done.wait(POLL_S):
            reporter.poll()

    def cut():
        reporter.finish(want, cut=True, watchdog_s=args.watchdog_s)
        os._exit(124)

    watchdog = threading.Timer(args.watchdog_s, cut)
    watchdog.daemon = True
    watchdog.start()
    poller = threading.Thread(target=poll_loop, daemon=True)
    poller.start()
    try:
        selfplay.main(flags)
    finally:
        done.set()
        watchdog.cancel()
    result = reporter.finish(want, cut=False)
    return 0 if result["verdict"] == "pass" else 1


if __name__ == "__main__":
    sys.exit(main())
