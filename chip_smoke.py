"""Smoke run of the PyTorch port (`hanabi_sad_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits nonzero):
  1. device   the card, its power limit, the torch and CUDA versions;
  2. build    nvcc builds kernel B1 (ops/csrc/lstm_seq.cu), with -Xptxas -v;
  3. check    B1 against its plain PyTorch version on the card, float32, at
              the eval shape, the learner shape and a ragged batch;
  4. timing   B1, its plain version and cuDNN's nn.LSTM at the eval shape;
  5. eval     greedy self-play of docs/runs/sad_aux_r4_soup10.pkl, 1000 games,
              through B1, then through the plain LSTM on the same decks;
  6. kernels  one {"kernels": [...]} line for every hand-written kernel.
The line before the last is the card's name and power limit as nvidia-smi
prints them; the last line is {"ok": true, "device": {...}}.

Without a CUDA card, or without the port beside it, it exits nonzero and
prints no result. It imports nothing of JAX or of the JAX package.
"""

import faulthandler

faulthandler.dump_traceback_later(900, exit=True)

import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

FLAGSHIP = "docs/runs/sad_aux_r4_soup10.pkl"
JAX_FLAGSHIP_MEAN = 24.05  # README.md, 5000 games of the JAX eval
MEAN_BAND = 0.25  # about 4-5 SEM of a 1000-game eval
KERNEL_TOL = 1e-4  # f32 sums in another order over K = 2H; state bounded by tanh
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def lstm_bound_ms(T, B, H, L):
    """Least time for one call: the larger of its float32 operations over the
    card's float32 rate and its bytes (inputs read once, outputs written
    once) over the memory rate. Returns (ms, "operations" or "bytes")."""
    flops = 2.0 * T * L * B * (2 * H) * (4 * H)
    words = T * B * H + 2 * L * B * H + L * (2 * H * 4 * H + 4 * H)  # xs, h0/c0, weights
    words += T * B * H + 2 * L * B * H  # outs, hT/cT
    t_ops, t_bytes = flops / H100_F32_FLOPS, 4.0 * words / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def cuda_ms(torch, fn, iters=50, warmup=5):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    t_all = time.time()
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device; this script runs only on the card")
    # float32 means float32: no TF32 in matmuls or in cuDNN.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from hanabi_sad_tpu_torch.game.config import GameConfig
    from hanabi_sad_tpu_torch.game.state import shuffled_decks
    from hanabi_sad_tpu_torch.models import lstm as lstm_mod
    from hanabi_sad_tpu_torch.ops.lstm_seq import lstm_seq_kernel, lstm_seq_plain
    from hanabi_sad_tpu_torch.tools import loaders
    from hanabi_sad_tpu_torch.train.evaluate import evaluate

    dev = torch.device("cuda")

    # 1. device
    t0 = time.time()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi_line, "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "seconds": round(time.time() - t0, 3)})

    # 2. build
    t0 = time.time()
    lstm_seq_kernel.load()
    emit({"phase": "build", "kernel": "lstm_seq", "seconds": round(time.time() - t0, 3),
          "ptxas": lstm_seq_kernel.ptxas})

    # 3. kernel against its plain version, on the flagship's LSTM weights
    t0 = time.time()
    policy = loaders.load_any(FLAGSHIP, device=dev)
    lstm_params = policy.params.online.lstm
    L, H = len(lstm_params), lstm_params[0]["w_hh"].shape[0]
    gen = torch.Generator().manual_seed(0)
    errors = {}
    with torch.no_grad():
        for case, (T, B) in {"eval": (1, 1000), "learner": (80, 128), "ragged": (1, 13)}.items():
            xs = torch.randn(T, B, H, generator=gen).to(dev)
            h0 = (0.5 * torch.randn(L, B, H, generator=gen)).to(dev)
            c0 = (0.5 * torch.randn(L, B, H, generator=gen)).to(dev)
            out_k, (h_k, c_k) = lstm_seq_kernel(lstm_params, xs, (h0, c0))
            out_p, (h_p, c_p) = lstm_seq_plain(lstm_params, xs, (h0, c0))
            torch.cuda.synchronize()
            err = max(float((a - b).abs().max()) for a, b in ((out_k, out_p), (h_k, h_p), (c_k, c_p)))
            errors[case] = err
            emit({"phase": "check", "case": case, "T": T, "B": B, "H": H, "L": L,
                  "max_abs_err": err, "tol": KERNEL_TOL})
            if not err <= KERNEL_TOL:
                fail(f"B1 disagrees with its plain version at {case}: {err} > {KERNEL_TOL}")
    emit({"phase": "check", "seconds": round(time.time() - t0, 3)})

    # 4. timing at the eval shape: one act call of one seat
    t0 = time.time()
    T, B = 1, 1000
    xs = torch.randn(T, B, H, generator=gen).to(dev)
    h0 = (0.5 * torch.randn(L, B, H, generator=gen)).to(dev)
    c0 = (0.5 * torch.randn(L, B, H, generator=gen)).to(dev)
    cudnn = torch.nn.LSTM(H, H, num_layers=L).to(dev)
    with torch.no_grad():
        for layer, p in enumerate(lstm_params):
            getattr(cudnn, f"weight_ih_l{layer}").copy_(p["w_ih"].t())
            getattr(cudnn, f"weight_hh_l{layer}").copy_(p["w_hh"].t())
            getattr(cudnn, f"bias_ih_l{layer}").copy_(p["b"])
            getattr(cudnn, f"bias_hh_l{layer}").zero_()
        lib_out, _ = cudnn(xs, (h0, c0))
        ref_out, _ = lstm_seq_plain(lstm_params, xs, (h0, c0))
        lib_err = float((lib_out - ref_out).abs().max())
        kernel_ms = cuda_ms(torch, lambda: lstm_seq_kernel(lstm_params, xs, (h0, c0)))
        plain_ms = cuda_ms(torch, lambda: lstm_seq_plain(lstm_params, xs, (h0, c0)))
        library_ms = cuda_ms(torch, lambda: cudnn(xs, (h0, c0)))
    bound_ms, bound_by = lstm_bound_ms(T, B, H, L)
    emit({"phase": "timing", "shape": {"T": T, "B": B, "H": H, "L": L}, "kernel_ms": kernel_ms,
          "plain_ms": plain_ms, "library_ms": library_ms, "library_max_abs_err": lib_err,
          "bound_ms": bound_ms, "bound_by": bound_by, "card": smi_line,
          "seconds": round(time.time() - t0, 3)})

    # 5. eval, the slice end to end: kernel path, then plain path on the same decks
    num_game, seed, num_steps = 1000, 1, 128
    decks = shuffled_decks(GameConfig(players=2), num_game, torch.Generator().manual_seed(seed))
    policies = [policy, policy]
    lstm_seq_kernel.launches = lstm_seq_kernel.calls = 0
    torch.cuda.synchronize()
    t0 = time.time()
    mean_k, perfect_k, scores_k, _ = evaluate(
        policies, num_game, seed, num_steps=num_steps, decks=decks, device=dev)
    wall_k = time.time() - t0
    launches, calls = lstm_seq_kernel.launches, lstm_seq_kernel.calls

    kernel_lstm_seq = lstm_mod.lstm_seq
    lstm_mod.lstm_seq = lstm_seq_plain  # the same eval with B1's call replaced by its plain version
    try:
        t0 = time.time()
        mean_p, perfect_p, scores_p, _ = evaluate(
            policies, num_game, seed, num_steps=num_steps, decks=decks, device=dev)
        wall_p = time.time() - t0
    finally:
        lstm_mod.lstm_seq = kernel_lstm_seq
    if lstm_seq_kernel.launches != launches:
        fail("the plain path launched B1")

    sk, sp = torch.tensor(scores_k, dtype=torch.float64), torch.tensor(scores_p, dtype=torch.float64)
    agree = float((sk == sp).double().mean())
    sem = float(sk.std(unbiased=False) / num_game ** 0.5)
    emit({"phase": "eval", "checkpoint": FLAGSHIP, "num_game": num_game, "seed": seed,
          "num_steps": num_steps, "kernel": {"mean": mean_k, "sem": sem, "perfect": perfect_k,
          "wall_s": wall_k}, "plain": {"mean": mean_p, "perfect": perfect_p, "wall_s": wall_p},
          "agree": agree, "b1_launches": launches, "b1_calls": calls,
          "jax_reference_mean": JAX_FLAGSHIP_MEAN})
    if launches == 0:
        fail("the eval did not launch B1")
    if agree < 0.99:
        fail(f"kernel and plain paths agree on only {agree:.4f} of games")
    if abs(mean_k - mean_p) > 0.05:
        fail(f"kernel mean {mean_k} and plain mean {mean_p} differ by more than 0.05")
    if abs(mean_k - JAX_FLAGSHIP_MEAN) > MEAN_BAND:
        fail(f"kernel mean {mean_k} outside {JAX_FLAGSHIP_MEAN} +/- {MEAN_BAND}")

    # 6. kernels
    emit({"kernels": [{
        "name": "lstm_seq", "route": "cuda", "source": "hanabi_sad_tpu_torch/ops/csrc/lstm_seq.cu",
        "replaces": "hanabi_sad_tpu/ops/experimental/pallas_lstm.py:166",
        "launches": launches, "max_abs_err": max(errors.values()), "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }]})
    print(f"# total seconds: {time.time() - t_all:.1f}", flush=True)
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
    faulthandler.cancel_dump_traceback_later()
