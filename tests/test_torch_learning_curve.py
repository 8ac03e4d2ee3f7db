"""The from-scratch learning-curve script (`scripts/torch_learning_curve.py`)
on the CPU:

  * parsing the four shipped JAX logs gives their curves: the evals at
    epochs 0 / 2 / 5 / 10, the means over epochs 8-11 and 36-39 and aux1 at
    epochs 0 and 2 (to the logs' printed digits);
  * the gates hold every one of the four JAX runs;
  * the script's flag line builds a TrainConfig equal to
    `sad_aux_r1_train.log`'s printed dict (apart from save_dir, num_epoch,
    multihost and profile_chunks), in both packages;
  * synthetic train.logs inside and outside each band give the right
    verdict, and legs are placed by update count;
  * two one-chunk legs of the script at a tiny width on the CPU (the second
    resumed from the first's latest.pkl) print their epoch lines and a
    verdict; the watchdog cuts a run with exit 124 and a verdict; `--plain`
    gives the same epoch on the CPU."""

import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest

from hanabi_sad_tpu.train import config as jconfig
from hanabi_sad_tpu_torch.train import config as tconfig
from hanabi_sad_tpu_torch.train import selfplay

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
import torch_learning_curve as lc  # noqa: E402

# The four logs as printed, epochs 0 / 2 / 5 / 10, and aux1 at epochs 0 and 2.
EVALS = {
    "sad_aux_r1": (0.803, 2.091, 3.272, 4.209),
    "auxop_a": (0.765, 2.9475, 2.91, 2.9775),
    "auxop_b": (0.694, 2.799, 3.203, 4.331),
    "auxop_c": (0.880, 2.255, 3.259, 4.500),
}
MEAN_8_11 = {"sad_aux_r1": 4.060, "auxop_a": 3.223, "auxop_b": 4.184, "auxop_c": 4.386}
MEAN_36_39 = {"sad_aux_r1": 11.899, "auxop_a": 9.062, "auxop_b": 8.953, "auxop_c": 11.413}
AUX1 = {"sad_aux_r1": (0.7795, 0.7116), "auxop_a": (0.7972, 0.6907), "auxop_b": (0.7873, 0.6581),
        "auxop_c": (0.7756, 0.6800)}
NOT_COMPARED = {"save_dir", "num_epoch", "multihost", "profile_chunks"}
TINY = ["--device", "cpu", "--num_envs", "8", "--rnn_hid_dim", "32", "--max_len", "16", "--batchsize", "8",
        "--replay_buffer_size", "64", "--burn_in_frames", "16", "--epoch_len", "1", "--num_update_per_chunk", "1",
        "--num_eval_game", "4", "--eval_max_steps", "100", "--num_eps", "4"]


@pytest.fixture(scope="module")
def curves():
    return lc.jax_curves()


@pytest.mark.parametrize("name", sorted(lc.JAX_LOGS))
def test_jax_logs_parse_to_their_curves(curves, name):
    s = lc.jax_summary(curves)[name]
    assert tuple(s["eval"][e] for e in (0, 2, 5, 10)) == pytest.approx(EVALS[name], abs=1e-9)
    assert s["mean_eval_8_11"] == pytest.approx(MEAN_8_11[name], abs=5e-4)
    assert s["mean_eval_36_39"] == pytest.approx(MEAN_36_39[name], abs=5e-4)
    assert (s["aux1"][0], s["aux1"][2]) == pytest.approx(AUX1[name], abs=1e-9)
    assert all(r["epoch"] == e for e, r in curves[name].items())


def test_jax_band_at_epoch_2_spans_the_four_runs(curves):
    band = lc.jax_band(curves, 2)
    assert band == {"min": 2.091, "max": 2.9475, "logs": 4}
    assert lc.EVAL_EPOCH2_BAND[0] < band["min"] and band["max"] < lc.EVAL_EPOCH2_BAND[1]


@pytest.mark.parametrize("name", sorted(lc.JAX_LOGS))
def test_the_gates_hold_each_jax_run(curves, name):
    rows = [curves[name][e] for e in range(12)]
    result = lc.verdict(rows, 12)
    assert result["verdict"] == "pass", result
    assert all(result["gates"].values())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flag_line_builds_the_flagship_config(dtype):
    """The flag line gives sad_aux_r1_train.log's printed config, field for
    field (the port's fields the log predates keep their defaults)."""
    logged = lc.parse_train_log(ROOT / lc.JAX_LOGS["sad_aux_r1"])["config"]
    cfg, device = selfplay.parse_args(lc.flag_line(dtype, 12, "somewhere"))
    assert device is None
    got = dataclasses.asdict(cfg)
    for key, value in logged.items():
        if key not in NOT_COMPARED:
            assert got[key] == (dtype if key == "compute_dtype" else value), key
    defaults = dataclasses.asdict(tconfig.TrainConfig())
    assert {k: got[k] for k in got.keys() - logged.keys()} == {k: defaults[k] for k in got.keys() - logged.keys()}
    assert (cfg.num_epoch, cfg.save_dir) == (12, "somewhere")
    jcfg = jconfig.make_config("sad_2p", **{k: getattr(cfg, k) for k in (
        "pred_weight", "seed", "continuous_exact_priority", "lr_final", "lr_decay_updates", "compute_dtype",
        "num_epoch", "save_dir")})
    assert dataclasses.asdict(jcfg) == got
    resumed, _ = selfplay.parse_args(lc.flag_line(dtype, 28, "leg2", resume="leg1/latest.pkl", extra=["--seed", "5"]))
    assert (resumed.load_model, resumed.num_epoch, resumed.seed) == ("leg1/latest.pkl", 28, 5)


def write_log(path, evals, aux1, loss=None, resumed_at=0, load_model="", num_epoch=None):
    """A train.log as the trainer writes it: the flagship's printed config,
    then one block an epoch."""
    config = lc.parse_train_log(ROOT / lc.JAX_LOGS["sad_aux_r1"])["config"]
    config.update(load_model=load_model, num_epoch=num_epoch or len(evals))
    lines = ["{" + ",\n ".join(f"{k!r}: {v!r}" for k, v in sorted(config.items())) + "}", "Success, Done"]
    if resumed_at:
        lines.insert(1, f"resumed at update {resumed_at}")
    for e, (score, a) in enumerate(zip(evals, aux1)):
        lines += [f"beginning of epoch: {e}", f"EPOCH: {e}", f"Total Time: 0:00:{e:02d}, {e}s", f"[{e}] Time spent = 1 s",
                  f"aux1         [   62]: avg: {a:8.4f}, min: 0.0[   1], max: 1.0[   2]",
                  f"loss         [   62]: avg: {(loss or {}).get(e, 4.0):8.4f}, min: 0.0[   1], max: 1.0[   2]",
                  f"epoch {e}, eval score: {score:.4f}, perfect: 0.00, model saved: True", "=========="]
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text("\n".join(lines) + "\n")


GOOD_EVALS = [0.8, 1.1, 2.3, 2.6, 2.9, 3.2, 3.4, 3.6, 3.8, 3.9, 4.1, 4.3]
GOOD_AUX1 = [0.78, 0.73, 0.70] + [0.65] * 9


@pytest.mark.parametrize("case, change, failed", [
    ("inside every band", {}, None),
    ("epoch 2 below the band", {"evals": {2: 1.2}}, "eval_epoch2"),
    ("epoch 2 above the band", {"evals": {2: 4.3}}, "eval_epoch2"),
    ("aux1 does not fall", {"aux1": {2: 0.75}}, "aux1_drop"),
    ("epochs 8-11 below the band", {"evals": {8: 2.0, 9: 2.1, 10: 2.0, 11: 2.1}}, "eval_mean_8_11"),
    ("epochs 8-11 above the band", {"evals": {8: 6.0, 9: 6.2, 10: 6.1, 11: 6.3}}, "eval_mean_8_11"),
    ("a non-finite loss", {"loss": {5: float("nan")}}, "finite"),
])
def test_synthetic_logs_get_the_right_verdict(tmp_path, case, change, failed):
    evals, aux1 = list(GOOD_EVALS), list(GOOD_AUX1)
    for e, v in change.get("evals", {}).items():
        evals[e] = v
    for e, v in change.get("aux1", {}).items():
        aux1[e] = v
    write_log(tmp_path / "train.log", evals, aux1, loss=change.get("loss"))
    rows = lc.curve(lc.leg_logs(tmp_path))
    assert [r["epoch"] for r in rows] == list(range(12))
    assert [r["updates"] for r in rows] == [992 * (e + 1) for e in range(12)]
    result = lc.verdict(rows, lc.want_epochs_of(tmp_path))
    assert result["verdict"] == ("pass" if failed is None else "fail"), (case, result)
    assert [g for g, ok in result["gates"].items() if ok is False] == ([] if failed is None else [failed])


def test_a_short_or_cut_run_is_held_to_the_gates_it_reaches(tmp_path):
    write_log(tmp_path / "train.log", GOOD_EVALS[:3], GOOD_AUX1[:3])
    rows = lc.curve(lc.leg_logs(tmp_path))
    assert lc.verdict(rows, 3)["verdict"] == "pass"
    assert lc.verdict(rows, 3)["gates"]["eval_mean_8_11"] is None
    assert lc.verdict(rows, 12)["verdict"] == "fail"  # asked for 12 epochs, reached 3
    assert lc.verdict([], 0)["verdict"] == "fail"


def test_legs_are_placed_by_update_count(tmp_path):
    """Leg 2 resumed at update 3 x 992 restarts its epoch index at 0; its
    rows land at epochs 3.., and the report of leg 2 follows leg 1's log."""
    write_log(tmp_path / "leg1" / "train.log", GOOD_EVALS[:3], GOOD_AUX1[:3])
    write_log(tmp_path / "leg2" / "train.log", GOOD_EVALS[3:12], GOOD_AUX1[3:12], resumed_at=3 * 992,
              load_model=str(tmp_path / "leg1" / "latest.pkl"))
    logs = lc.leg_logs(tmp_path / "leg2")
    assert logs == [tmp_path / "leg1" / "train.log", tmp_path / "leg2" / "train.log"]
    rows = lc.curve(logs)
    assert [r["epoch"] for r in rows] == list(range(12))
    assert [r["leg_epoch"] for r in rows] == [0, 1, 2] + list(range(9))
    assert [r["eval"] for r in rows] == pytest.approx(GOOD_EVALS)
    assert lc.want_epochs_of(tmp_path / "leg2") == 12
    assert lc.verdict(rows, 12)["verdict"] == "pass"
    moved = tmp_path / "moved"
    for leg in ("leg1", "leg2"):
        (moved / leg).mkdir(parents=True)
        (moved / leg / "train.log").write_text((tmp_path / leg / "train.log").read_text())
        (tmp_path / leg / "train.log").unlink()
    assert lc.leg_logs(moved / "leg2") == [moved / "leg1" / "train.log", moved / "leg2" / "train.log"]


def test_drift_is_run_a_minus_run_b(tmp_path):
    write_log(tmp_path / "a" / "train.log", GOOD_EVALS[:3], GOOD_AUX1[:3])
    write_log(tmp_path / "b" / "train.log", [v + 0.5 for v in GOOD_EVALS[:3]], GOOD_AUX1[:3])
    out = lc.drift(lc.curve(lc.leg_logs(tmp_path / "a")), lc.curve(lc.leg_logs(tmp_path / "b")))
    assert [d["epoch"] for d in out] == [0, 1, 2]
    assert all(d["eval"] == pytest.approx(-0.5) and d["aux1"] == 0 and d["loss"] == 0 for d in out)


def run_script(args, timeout=120):
    proc = subprocess.run([sys.executable, str(ROOT / "scripts" / "torch_learning_curve.py"), *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)
    lines = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith('{"')]
    return proc, lines


def test_two_one_chunk_legs_on_the_cpu_print_their_epoch_lines(tmp_path):
    proc, lines = run_script(["--num_epoch", "1", "--save_dir", str(tmp_path / "leg0"), *TINY])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert lines[0]["flags"][:len(lc.FLAGSHIP_FLAGS)] == list(lc.FLAGSHIP_FLAGS)
    epochs = [line for line in lines if "epoch" in line and "verdict" not in line]
    assert [(e["epoch"], e["updates"]) for e in epochs] == [(0, 1)]
    assert math.isfinite(epochs[0]["loss"]) and math.isfinite(epochs[0]["aux1"]) and epochs[0]["jax_band"] is None
    assert lines[-1]["verdict"] == "pass" and lines[-1]["cut"] is False
    assert (tmp_path / "leg0" / "latest.pkl").exists()

    proc, lines = run_script(["--num_epoch", "1", "--resume", str(tmp_path / "leg0" / "latest.pkl"),
                              "--save_dir", str(tmp_path / "leg1"), *TINY])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "resumed at update 1" in proc.stdout and "warming up replay buffer" in proc.stdout
    epochs = [line for line in lines if "epoch" in line and "verdict" not in line]
    assert [(e["epoch"], e["updates"]) for e in epochs] == [(0, 1), (1, 2)]
    assert lines[-1]["verdict"] == "pass" and lines[-1]["epochs"] == lines[-1]["want_epochs"] == 2
    proc, lines = run_script(["--report", str(tmp_path / "leg1")])
    assert proc.returncode == 0 and [line.get("epoch") for line in lines[:-1]] == [0, 1]


def test_the_watchdog_cuts_a_run_with_a_verdict(tmp_path):
    proc, lines = run_script(["--num_epoch", "50", "--watchdog_s", "1", "--save_dir", str(tmp_path), *TINY])
    assert proc.returncode == 124
    assert lines[-1]["cut"] is True and lines[-1]["verdict"] == "fail" and lines[-1]["want_epochs"] == 50


def test_plain_versions_give_the_same_epoch_on_the_cpu(tmp_path):
    """--plain swaps B1, B2 and B3 for their plain versions; a CPU tensor
    runs those anyway, so the epoch line is the same."""
    lines = {}
    for flag in ([], ["--plain"]):
        proc, out = run_script(["--num_epoch", "1", "--save_dir", str(tmp_path / str(bool(flag))), *flag, *TINY])
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert out[0]["plain"] is bool(flag)
        lines[bool(flag)] = [{k: v for k, v in line.items() if k != "wall_s"} for line in out if "epoch" in line
                             and "verdict" not in line]
    assert lines[True] == lines[False] and len(lines[True]) == 1
