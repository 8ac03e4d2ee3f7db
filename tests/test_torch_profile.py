"""`profile_chunks` in the port's training loop (`train/selfplay.py`), the
counterpart of the JAX package's `jax.profiler` trace: chunks 2 .. 1 + N are
traced with torch.profiler into `<save_dir>/profile/trace.json`, written when
chunk 1 + N ends, or at the end of a run that stops before it."""

import json
import os

from hanabi_sad_tpu_torch.train import config as tconfig
from hanabi_sad_tpu_torch.train import selfplay

SMALL = dict(num_envs=8, batchsize=8, burn_in_frames=16, replay_buffer_size=64, epoch_len=4,
             num_update_per_chunk=2, num_epoch=3, num_eval_game=4, max_len=16, rnn_hid_dim=32, num_eps=4)


def run(tmp_path, capsys, profile_chunks, max_chunks):
    cfg = tconfig.make_config("sad_2p", pred_weight=0.25, save_dir=str(tmp_path), profile_chunks=profile_chunks,
                              **SMALL)
    out = selfplay.train(cfg, max_chunks=max_chunks, device="cpu")
    return out, capsys.readouterr().out


def read_trace(tmp_path):
    with open(os.path.join(tmp_path, "profile", "trace.json")) as f:
        return json.load(f)["traceEvents"]


def test_profile_chunks_traces_chunks_two_to_one_plus_n(tmp_path, capsys):
    out, log = run(tmp_path, capsys, profile_chunks=1, max_chunks=3)
    assert out["num_update"] == 6
    assert f"profiler trace written to {tmp_path}/profile\n" in log and "truncated" not in log
    events = read_trace(tmp_path)
    assert any("lstm" in e.get("name", "") or "aten::" in e.get("name", "") for e in events)


def test_profile_chunks_flushes_a_truncated_run(tmp_path, capsys):
    out, log = run(tmp_path, capsys, profile_chunks=5, max_chunks=3)
    assert out["num_update"] == 6
    assert f"profiler trace written to {tmp_path}/profile (truncated run)" in log
    assert len(read_trace(tmp_path)) > 0


def test_no_trace_without_profile_chunks(tmp_path, capsys):
    run(tmp_path, capsys, profile_chunks=0, max_chunks=2)
    assert not os.path.exists(os.path.join(tmp_path, "profile"))
