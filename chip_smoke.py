"""Smoke run of the PyTorch port (`hanabi_sad_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing JSON lines (any failure exits nonzero):
  1. device   the card, its power limit, the torch and CUDA versions;
  2. build    nvcc builds kernels B1 (ops/csrc/lstm_seq.cu), B2's backward
              (ops/csrc/lstm_bwd.cu) and B3 (ops/csrc/gather_unpack.cu) in
              parallel, with -Xptxas -v;
  3. check    on the flagship's LSTM weights: B1 against its plain version
              at the eval shape, the rollout shape and a ragged batch; at
              the learner shape [80, 128, 512] over 8 seeds, B1's and B2's
              outputs and each of B2's grads against float64, no further
              than twice the plain float32 version (autograd for the grads), B2's
              forward equal to B1's bit for bit and its grads within
              GRAD_REL_TOL of plain autograd; two calls of B1 and of B2 on the
              same inputs give the same bits; B3 against its plain version on
              random bytes and at indices out of range on both ends;
  4. timing   B1 at the eval, rollout and learner shapes, B2 forward + backward, B3,
              each beside its plain version, its library call (cuDNN
              nn.LSTM for B1 and B2, none for B3), its bound and its launches
              per call;
  5. eval     greedy self-play of docs/runs/sad_aux_r4_soup10.pkl, 1000 games,
              through B1, then through the plain LSTM on the same decks;
  6. train    the flagship SAD-AUX trainer (preset sad_2p, pred_weight 0.25,
              float32) at full width, warm-started from the same checkpoint:
              one collect-only chunk, B3 against its plain version on that
              real replay, 3 train chunks (one line each, with launch
              counts), then one sgd_update from one state and one batch
              through the kernels and through the plain versions;
  7. kernels  one {"kernels": [...]} line for B1, B2 and B3.
The line before the last is the card's name and power limit as nvidia-smi
prints them; the last line is {"ok": true, "device": {...}}.

Without a CUDA card, or without the port beside it, it exits nonzero and
prints no result. It imports nothing of JAX or of the JAX package.
"""

import faulthandler

faulthandler.dump_traceback_later(900, exit=True)

import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

FLAGSHIP = "docs/runs/sad_aux_r4_soup10.pkl"
JAX_FLAGSHIP_MEAN = 24.05  # README.md, 5000 games of the JAX eval
MEAN_BAND = 0.25  # about 4-5 SEM of a 1000-game eval
KERNEL_TOL = 1e-4  # f32 sums in another order over K = 2H; state bounded by tanh
# B1's shapes on the main path: eval (1000 games), rollout (1024 envs x 2
# seats, once per net), learner target forward; and a batch that is no
# multiple of the kernel's 32-row tile.
B1_CASES = {"eval": (1, 1000), "rollout": (1, 2048), "learner": (80, 128), "ragged": (1, 13)}
# At the learner shape the gap between two float32 versions is rounding
# amplified over 80 recurrent steps and depends on the input (it reached
# 1.7e-4 where the plain version itself lay 1.4e-4 from float64,
# scripts/torch_lstm_error_spread.py), so no absolute tolerance against the
# plain version holds. There B1 and B2 are held against float64 instead, on
# the inputs of scripts/torch_lstm_error_spread.py (seeds 0 .. F64_SEEDS - 1):
# the largest distance of B1's outputs (outs, hT, cT) to float64 over those
# inputs, and B2's, is at most F64_FACTOR times the plain float32 version's;
# for each of B2's grads, relative to its largest float64 value, the same
# against plain float32 autograd. The ratios of each output alone are
# reported: input by input they spread over 0.25x to 13x, both ways.
F64_SEEDS = 8
F64_FACTOR = 2.0
# B2's grads against plain float32 autograd, relative to the largest
# reference grad of each tensor.
GRAD_REL_TOL = 1e-3
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12
# Warm-start bands of the train phase, per train chunk. They are set wide
# around two references of the same preset and warm start:
#  * the JAX package on the CPU (scripts/jax_warmstart_reference.py, 1024
#    envs, seeds 9-11, the first 3 train chunks after one collect chunk):
#    loss 5.17-5.68, rl_loss 0.14-0.23, aux1 0.384-0.401, grad_norm 12-50,
#    chunk_score 23.26-23.81, chunk_len 67.8-68.3;
#  * docs/runs/sad_aux_r1_train.log, epochs 803-805 (bfloat16, steady
#    state): loss 5.4-6.0, rl_loss 0.19-0.20, aux1 0.39-0.42, grad_norm
#    8.5-17.6, chunk_score 23.25-23.66.
BANDS = {
    "loss": (3.5, 8.0),
    "rl_loss": (0.05, 0.5),
    "aux1": (0.3, 0.5),
    "grad_norm": (3.0, 150.0),
    "chunk_score": (22.5, 24.5),
    "chunk_len": (62.0, 74.0),
}
# Gap between one sgd_update through the kernels and through the plain
# versions from the same state and batch: float32 sums in another order.
SGD_REL_TOL = {"loss": 1e-4, "grad_norm": 1e-3, "priority": 1e-3}


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound(flops, nbytes):
    """Least time: the larger of operations over the float32 rate and bytes
    (inputs read once, outputs written once) over the memory rate. Returns
    (ms, "operations" or "bytes")."""
    t_ops, t_bytes = flops / H100_F32_FLOPS, nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def lstm_words(T, B, H, L):
    """float32 words of one forward: xs, h0/c0, weights in; outs, hT/cT out."""
    return 2 * T * B * H + 4 * L * B * H + L * (2 * H * 4 * H + 4 * H)


def lstm_flops(T, B, H, L):
    return 2.0 * T * L * B * (2 * H) * (4 * H)


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

    from hanabi_sad_tpu_torch.agent.r2d2_agent import AgentParams, clone_params
    from hanabi_sad_tpu_torch.game.config import GameConfig
    from hanabi_sad_tpu_torch.game.state import shuffled_decks
    from hanabi_sad_tpu_torch.models import lstm as lstm_mod
    from hanabi_sad_tpu_torch.ops import build
    from hanabi_sad_tpu_torch.ops import gather_unpack as gu
    from hanabi_sad_tpu_torch.ops.lstm_seq import (
        LstmSeqDiff, lstm_bwd_kernel, lstm_seq_diff, lstm_seq_kernel, lstm_seq_plain)
    from hanabi_sad_tpu_torch.replay import prioritized as replay_mod
    from hanabi_sad_tpu_torch.tools import loaders
    from hanabi_sad_tpu_torch.train import learner, selfplay
    from hanabi_sad_tpu_torch.train.config import make_config
    from hanabi_sad_tpu_torch.train.evaluate import evaluate
    from hanabi_sad_tpu_torch.train.optim import AdamState

    b3 = gu.gather_unpack_kernel
    dev = torch.device("cuda")

    def reset_counts():
        lstm_seq_kernel.reset()
        lstm_bwd_kernel.launches = b3.launches = LstmSeqDiff.calls = 0

    def counts():
        return {"b1": lstm_seq_kernel.launches, **{f"b1_{k}": v for k, v in lstm_seq_kernel.launches_by_kernel.items()},
                "b2": LstmSeqDiff.calls, "b2_bwd": lstm_bwd_kernel.launches, "b3": b3.launches}

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

    # 2. build: one nvcc per source, all started together
    t0 = time.time()
    built = build.build_many([lstm_seq_kernel.source, lstm_bwd_kernel.source, b3.source])
    for wrapper in (lstm_seq_kernel, lstm_bwd_kernel, b3):
        wrapper.load()
    for source, (_, ptxas) in built.items():
        emit({"phase": "build", "source": source, "ptxas": ptxas})
    emit({"phase": "build", "seconds": round(time.time() - t0, 3)})

    # 3. check, on the flagship's LSTM weights
    t0 = time.time()
    policy = loaders.load_any(FLAGSHIP, device=dev)
    lstm_params = policy.params.online.lstm
    L, H = len(lstm_params), lstm_params[0]["w_hh"].shape[0]
    gen = torch.Generator().manual_seed(0)
    randn = lambda *shape, scale=1.0: (scale * torch.randn(*shape, generator=gen)).to(dev)
    b1_errors, deterministic = {}, {}
    with torch.no_grad():
        for case, (T, B) in B1_CASES.items():
            if case == "learner":
                continue
            xs, h0, c0 = randn(T, B, H), randn(L, B, H, scale=0.5), randn(L, B, H, scale=0.5)
            out_k, (h_k, c_k) = lstm_seq_kernel(lstm_params, xs, (h0, c0))
            again = lstm_seq_kernel(lstm_params, xs, (h0, c0))
            out_p, (h_p, c_p) = lstm_seq_plain(lstm_params, xs, (h0, c0))
            torch.cuda.synchronize()
            err = max(float((a - b).abs().max()) for a, b in ((out_k, out_p), (h_k, h_p), (c_k, c_p)))
            b1_errors[case] = err
            deterministic[f"B1_{case}"] = all(
                torch.equal(a, b) for a, b in zip((out_k, h_k, c_k), (again[0], *again[1])))
            emit({"phase": "check", "kernel": "B1", "case": case, "T": T, "B": B, "H": H, "L": L,
                  "max_abs_err": err, "tol": KERNEL_TOL})
            if not err <= KERNEL_TOL:
                fail(f"B1 disagrees with its plain version at {case}: {err} > {KERNEL_TOL}")

    # B1 and B2 at the learner shape against float64, over F64_SEEDS inputs
    T, B = B1_CASES["learner"]
    names = ["xs", "h0", "c0"] + [f"{k}{l}" for l in range(L) for k in ("w_ih", "w_hh", "b")]
    outputs = ("outs", "hT", "cT")

    def leaves_of(params, *tensors, dtype=torch.float32):
        ps = [{k: v.detach().to(dtype).clone().requires_grad_(True) for k, v in p.items()} for p in params]
        ts = [t.detach().to(dtype).clone().requires_grad_(True) for t in tensors]
        return ps, ts, ts + [p[k] for p in ps for k in ("w_ih", "w_hh", "b")]

    def fwd_bwd(fn, ps, ts, leaves, cot):
        outs, (h_t, c_t) = fn(ps, ts[0], (ts[1], ts[2]))
        grads = torch.autograd.grad((outs, h_t, c_t), leaves, [g.to(ts[0].dtype) for g in cot])
        return [y.detach() for y in (outs, h_t, c_t)], grads

    def largest_gap(a, ref, rel=False):
        gap = float((a.double() - ref).abs().max())
        return gap / max(float(ref.abs().max()), 1e-30) if rel else gap

    worst = {"B1": {}, "B2": {}, "plain": {}, "B2_grad": {}, "plain_grad": {}}
    b2_grad_rel, b2_is_b1, grads_identical = {}, True, True
    for seed in range(F64_SEEDS):
        g = torch.Generator().manual_seed(seed)
        r = lambda *shape, scale=1.0: (scale * torch.randn(*shape, generator=g)).to(dev)
        xs, h0, c0 = r(T, B, H), r(L, B, H, scale=0.5), r(L, B, H, scale=0.5)
        cot = (r(T, B, H), r(L, B, H), r(L, B, H))
        with torch.no_grad():
            b1_out, (b1_h, b1_c) = lstm_seq_kernel(lstm_params, xs, (h0, c0))
        calls = LstmSeqDiff.calls
        ys_k, grads_k = fwd_bwd(lstm_seq_diff, *leaves_of(lstm_params, xs, h0, c0), cot)
        if LstmSeqDiff.calls != calls + 1:
            fail("B2 was not called")
        ys_p, grads_p = fwd_bwd(lstm_seq_plain, *leaves_of(lstm_params, xs, h0, c0), cot)
        ys_64, grads_64 = fwd_bwd(lstm_seq_plain, *leaves_of(lstm_params, xs, h0, c0, dtype=torch.float64), cot)
        if seed == 0:
            ys_k2, grads_k2 = fwd_bwd(lstm_seq_diff, *leaves_of(lstm_params, xs, h0, c0), cot)
            with torch.no_grad():
                b1_again = lstm_seq_kernel(lstm_params, xs, (h0, c0))
            deterministic["B1_learner"] = all(
                torch.equal(a, b) for a, b in zip((b1_out, b1_h, b1_c), (b1_again[0], *b1_again[1])))
            deterministic["B2_learner"] = all(torch.equal(a, b) for a, b in zip(ys_k + list(grads_k),
                                                                                  ys_k2 + list(grads_k2)))
        torch.cuda.synchronize()
        b2_is_b1 &= all(torch.equal(a, b) for a, b in zip(ys_k, (b1_out, b1_h, b1_c)))
        grads_identical &= all(torch.equal(a, b) for a, b in zip(grads_k, grads_p))
        for name, b1_y, k_y, p_y, ref in zip(outputs, (b1_out, b1_h, b1_c), ys_k, ys_p, ys_64):
            for who, y in (("B1", b1_y), ("B2", k_y), ("plain", p_y)):
                worst[who][name] = max(worst[who].get(name, 0.0), largest_gap(y, ref))
        for name, gk, gp, ref in zip(names, grads_k, grads_p, grads_64):
            worst["B2_grad"][name] = max(worst["B2_grad"].get(name, 0.0), largest_gap(gk, ref, rel=True))
            worst["plain_grad"][name] = max(worst["plain_grad"].get(name, 0.0), largest_gap(gp, ref, rel=True))
            b2_grad_rel[name] = max(b2_grad_rel.get(name, 0.0), largest_gap(gk, gp.double(), rel=True))
        del ys_k, grads_k, ys_p, grads_p, ys_64, grads_64
    b1_errors["learner"] = max(worst["B1"].values())
    ratio = lambda who, ref_who, n: worst[who][n] / max(worst[ref_who][n], 1e-30)
    per_output = {who: {n: ratio(who, "plain", n) for n in outputs} for who in ("B1", "B2")}
    f64_ratio = {who: max(worst[who].values()) / max(worst["plain"].values()) for who in ("B1", "B2")}
    f64_ratio.update({f"B2_grad.{n}": ratio("B2_grad", "plain_grad", n) for n in names})
    emit({"phase": "check", "kernel": "B1 and B2", "T": T, "B": B, "H": H, "L": L, "seeds": F64_SEEDS,
          "largest_gap_to_f64": worst, "ratio_to_plain": f64_ratio, "factor": F64_FACTOR,
          "ratio_to_plain_per_output": per_output,
          "b2_forward_equals_B1": b2_is_b1, "b2_grad_rel_err_to_plain": b2_grad_rel,
          "grad_rel_tol": GRAD_REL_TOL, "grads_identical_to_plain": grads_identical,
          "deterministic": deterministic})
    if not b2_is_b1:
        fail("B2's forward differs from B1 on the same inputs")
    bad = {k: v for k, v in f64_ratio.items() if not v <= F64_FACTOR}
    if bad:
        fail(f"further than {F64_FACTOR}x the plain float32 version from float64: {bad}")
    bad = {k: v for k, v in b2_grad_rel.items() if not v <= GRAD_REL_TOL}
    if bad:
        fail(f"B2 grads disagree with autograd of the plain version: {bad}")
    if not all(deterministic.values()):
        fail(f"two calls on the same inputs gave different bits: {deterministic}")
    b2_max_err = max(max(worst["B2"].values()), *b2_grad_rel.values())

    # B3 on random bytes, indices out of range clamped by both versions
    packed = torch.randint(0, 256, (50, 80, 2, 110), dtype=torch.uint8, generator=gen).to(dev)
    b3_errors = []

    def b3_check(case, packed, idx):
        out_k, out_p = b3(packed, idx), gu.gather_unpack_plain(packed, idx)
        torch.cuda.synchronize()
        b3_errors.append(float((out_k - out_p).abs().max()))
        same = torch.equal(out_k, out_p)
        emit({"phase": "check", "kernel": "B3", "case": case, "B": int(idx.numel()),
              "distinct": int(idx.unique().numel()), "equal": same})
        if not same:
            fail(f"B3 disagrees with its plain version on {case}")

    b3_check("random bytes, indices out of range", packed, torch.tensor([3, 49, 3, -2, 60, 0], device=dev))
    # indices beyond both ends and negative ones read as JAX reads them:
    # [-cap, -1] counts from the end, the rest is clamped
    cap = packed.shape[0]
    idx = torch.tensor([-cap - 2, -cap, -1, 0, cap - 1, cap, cap + 3], device=dev)
    rows = torch.tensor([0, 0, cap - 1, 0, cap - 1, cap - 1, cap - 1], device=dev)
    b3_check("indices out of range, as JAX reads them", packed, idx)
    if not torch.equal(b3(packed, idx), gu.gather_unpack_plain(packed, rows)):
        fail("B3 does not read the rows JAX reads at indices out of range")
    emit({"phase": "check", "seconds": round(time.time() - t0, 3)})

    # 4. timing
    t0 = time.time()
    cudnn = torch.nn.LSTM(H, H, num_layers=L).to(dev)
    with torch.no_grad():
        for layer, p in enumerate(lstm_params):
            getattr(cudnn, f"weight_ih_l{layer}").copy_(p["w_ih"].t())
            getattr(cudnn, f"weight_hh_l{layer}").copy_(p["w_hh"].t())
            getattr(cudnn, f"bias_ih_l{layer}").copy_(p["b"])
            getattr(cudnn, f"bias_hh_l{layer}").zero_()
    timing = {}
    for case in ("eval", "rollout", "learner"):
        T, B = B1_CASES[case]
        xs, h0, c0 = randn(T, B, H), randn(L, B, H, scale=0.5), randn(L, B, H, scale=0.5)
        with torch.no_grad():
            lib_err = float((cudnn(xs, (h0, c0))[0] - lstm_seq_plain(lstm_params, xs, (h0, c0))[0]).abs().max())
            reset_counts()
            lstm_seq_kernel(lstm_params, xs, (h0, c0))
            per_call = counts()
            ms = cuda_ms(torch, lambda: lstm_seq_kernel(lstm_params, xs, (h0, c0)))
            plain_ms = cuda_ms(torch, lambda: lstm_seq_plain(lstm_params, xs, (h0, c0)))
            library_ms = cuda_ms(torch, lambda: cudnn(xs, (h0, c0)))
        b_ms, b_by = bound(lstm_flops(T, B, H, L), 4.0 * lstm_words(T, B, H, L))
        timing[f"B1_{case}"] = {"T": T, "B": B, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                                "library_max_abs_err": lib_err, "bound_ms": b_ms, "bound_by": b_by,
                                "launches_per_call": {k: v for k, v in per_call.items() if k.startswith("b1")}}

    # B2 forward + backward at the learner shape; its least work is the
    # forward and the two products of the backward, 3x the forward's
    # operations.
    T, B = B1_CASES["learner"]
    cot = (randn(T, B, H), randn(L, B, H), randn(L, B, H))
    ps_k, ts_k, leaves_k = leaves_of(lstm_params, xs, h0, c0)
    cudnn_leaves = [t.detach().clone().requires_grad_(True) for t in (xs, h0, c0)]

    def cudnn_fwd_bwd():
        out, (h_t, c_t) = cudnn(cudnn_leaves[0], (cudnn_leaves[1], cudnn_leaves[2]))
        return torch.autograd.grad((out, h_t, c_t), cudnn_leaves + list(cudnn.parameters()), cot)

    reset_counts()
    fwd_bwd(lstm_seq_diff, ps_k, ts_k, leaves_k, cot)
    per_call = counts()
    ms = cuda_ms(torch, lambda: fwd_bwd(lstm_seq_diff, ps_k, ts_k, leaves_k, cot), iters=10, warmup=2)
    plain_ms = cuda_ms(torch, lambda: fwd_bwd(lstm_seq_plain, ps_k, ts_k, leaves_k, cot), iters=10, warmup=2)
    library_ms = cuda_ms(torch, cudnn_fwd_bwd, iters=10, warmup=2)
    words = 2 * lstm_words(T, B, H, L)  # the forward's inputs and outputs, and a grad of each
    b_ms, b_by = bound(3 * lstm_flops(T, B, H, L), 4.0 * words)
    timing["B2_learner"] = {"T": T, "B": B, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                            "bound_ms": b_ms, "bound_by": b_by,
                            "launches_per_call": {k: v for k, v in per_call.items() if k != "b3"}}

    # B3 at the flagship shape: 64 of 65,536 episodes of [80, 2, 110] bytes
    cap, Bs = 65536, 64
    packed = torch.randint(0, 256, (cap, 80, 2, 110), dtype=torch.uint8, device=dev)
    idx = torch.randint(0, cap, (Bs,), device=dev)
    ms = cuda_ms(torch, lambda: b3(packed, idx))
    plain_ms = cuda_ms(torch, lambda: gu.gather_unpack_plain(packed, idx))
    b_ms, b_by = bound(0.0, Bs * 8 + Bs * 80 * 2 * 110 + 4 * Bs * 80 * 2 * 880)
    timing["B3_flagship"] = {"B": Bs, "cap": cap, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                             "bound_ms": b_ms, "bound_by": b_by}
    del packed
    emit({"phase": "timing", "card": smi_line, **timing, "seconds": round(time.time() - t0, 3)})

    # 5. eval: kernel path, then plain path on the same decks
    num_game, seed, num_steps = 1000, 1, 128
    decks = shuffled_decks(GameConfig(players=2), num_game, torch.Generator().manual_seed(seed))
    policies = [policy, policy]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    mean_k, perfect_k, scores_k, _ = evaluate(
        policies, num_game, seed, num_steps=num_steps, decks=decks, device=dev)
    wall_k = time.time() - t0
    eval_counts = counts()

    kernel_lstm_seq = lstm_mod.lstm_seq
    lstm_mod.lstm_seq = lstm_seq_plain  # the same eval with B1's call replaced by its plain version
    try:
        t0 = time.time()
        mean_p, perfect_p, scores_p, _ = evaluate(
            policies, num_game, seed, num_steps=num_steps, decks=decks, device=dev)
        wall_p = time.time() - t0
    finally:
        lstm_mod.lstm_seq = kernel_lstm_seq
    if counts() != eval_counts:
        fail("the plain path launched a kernel")

    sk, sp = torch.tensor(scores_k, dtype=torch.float64), torch.tensor(scores_p, dtype=torch.float64)
    agree = float((sk == sp).double().mean())
    sem = float(sk.std(unbiased=False) / num_game ** 0.5)
    emit({"phase": "eval", "checkpoint": FLAGSHIP, "num_game": num_game, "seed": seed,
          "num_steps": num_steps, "kernel": {"mean": mean_k, "sem": sem, "perfect": perfect_k,
          "wall_s": wall_k}, "plain": {"mean": mean_p, "perfect": perfect_p, "wall_s": wall_p},
          "agree": agree, "launches": eval_counts, "jax_reference_mean": JAX_FLAGSHIP_MEAN})
    if eval_counts["b1"] == 0:
        fail("the eval did not launch B1")
    if agree < 0.99:
        fail(f"kernel and plain paths agree on only {agree:.4f} of games")
    if abs(mean_k - mean_p) > 0.05:
        fail(f"kernel mean {mean_k} and plain mean {mean_p} differ by more than 0.05")
    if abs(mean_k - JAX_FLAGSHIP_MEAN) > MEAN_BAND:
        fail(f"kernel mean {mean_k} outside {JAX_FLAGSHIP_MEAN} +/- {MEAN_BAND}")

    # 6. train: the flagship preset at full width, warm-started. burn_in is
    # cut to 1024 episodes (2048 / 2 players) so that one collect chunk of
    # 1024 envs fills it; everything else is the preset's.
    cfg = make_config("sad_2p", pred_weight=0.25, burn_in_frames=2048)
    setup = learner.make_setup(cfg)
    tcfg = setup.train
    state = learner.init_train_state(setup, tcfg.seed, dev)
    state = state._replace(params=selfplay.load_model(FLAGSHIP, dev))
    optimizer = learner.make_optimizer(tcfg)
    shape = {"num_envs": tcfg.num_envs, "batch_episodes": tcfg.batchsize, "T": tcfg.max_len,
             "hidden": tcfg.rnn_hid_dim, "replay_capacity": tcfg.replay_buffer_size,
             "updates_per_chunk": tcfg.num_update_per_chunk}
    T, U = tcfg.max_len, tcfg.num_update_per_chunk
    # act: 2 nets x L gates launches per step (T = 1); each update: the
    # target's forward and B2's forward, 2 L launches each (T > 1), and B2's
    # backward, L launches
    rollout = T * 2 * L
    expect_collect = {"b1": rollout, "b1_gates": rollout, "b1_recurrence": 0, "b2": 0, "b2_bwd": 0, "b3": 0}
    expect_train = {"b1": rollout + U * 4 * L, "b1_gates": rollout + U * 2 * L, "b1_recurrence": U * 2 * L,
                    "b2": U, "b2_bwd": U * L, "b3": U}

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    state, stats = learner.collect_only(setup, state)
    torch.cuda.synchronize()
    wall = time.time() - t0
    got = counts()
    row = {k: float(v) for k, v in stats.items()}
    emit({"phase": "train", "chunk": "collect", "shape": shape, "burn_in_episodes": tcfg.burn_in_frames,
          "replay_size": int(state.replay.size), **row, "wall_s": wall, "launches": got})
    if got != expect_collect:
        fail(f"collect chunk launches {got}, expected {expect_collect}")
    if int(state.replay.size) < tcfg.burn_in_frames:
        fail("one collect chunk did not fill the cut burn-in")

    # B3 on the real replay, flagship shape, with duplicate indices
    idx, _ = replay_mod.sample_indices(state.replay, setup.replay, tcfg.batchsize,
                                       generator=torch.Generator(device=dev).manual_seed(3))
    idx[32:40] = idx[0:8]
    b3_check("real replay after one collect chunk", state.replay.packed, idx)

    totals = dict.fromkeys(expect_train, 0)
    train_walls = []
    for chunk in range(3):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        state, metrics = learner.train_chunk(setup, optimizer, state)
        torch.cuda.synchronize()
        wall = time.time() - t0
        got = counts()
        row = {k: float(v) for k, v in metrics.items()}
        emit({"phase": "train", "chunk": chunk, **row, "wall_s": wall, "launches": got,
              "num_update": state.num_update, "card": smi_line})
        train_walls.append(wall)
        for k in totals:
            totals[k] += got[k]
        if got != expect_train:
            fail(f"train chunk {chunk} launches {got}, expected {expect_train}")
        if not all(math.isfinite(v) for v in row.values()):
            fail(f"non-finite metric in train chunk {chunk}: {row}")
        for k, (lo, hi) in BANDS.items():
            if not lo <= row[k] <= hi:
                fail(f"train chunk {chunk}: {k} = {row[k]} outside the warm-start band [{lo}, {hi}]")

    # One sgd_update from one state and one presampled batch, through the
    # kernels and through the plain versions.
    idx, is_w = replay_mod.sample_indices(state.replay, setup.replay, tcfg.batchsize,
                                          generator=torch.Generator(device=dev).manual_seed(4))
    rows = replay_mod.gather_rows(state.replay, idx)

    def copy_state():
        opt = state.opt_state
        return state._replace(
            params=AgentParams(online=clone_params(state.params.online), target=clone_params(state.params.target)),
            opt_state=AdamState(mu=[m.clone() for m in opt.mu], nu=[v.clone() for v in opt.nu], count=opt.count),
            replay=state.replay._replace(weight=state.replay.weight.clone()),
        )

    s_k, m_k = learner.sgd_update(setup, optimizer, copy_state(), presampled=(rows, is_w, idx))
    kernel_gather_unpack = gu.gather_unpack
    lstm_mod.lstm_seq, gu.gather_unpack = lstm_seq_plain, gu.gather_unpack_plain
    try:
        before = counts()
        s_p, m_p = learner.sgd_update(setup, optimizer, copy_state(), presampled=(rows, is_w, idx))
        if counts() != before:
            fail("the plain sgd_update launched a kernel")
    finally:
        lstm_mod.lstm_seq, gu.gather_unpack = kernel_lstm_seq, kernel_gather_unpack
    p_k, p_p = s_k.replay.weight[idx], s_p.replay.weight[idx]
    gaps = {
        "loss": abs(float(m_k["loss"]) - float(m_p["loss"])) / abs(float(m_p["loss"])),
        "grad_norm": abs(float(m_k["grad_norm"]) - float(m_p["grad_norm"])) / abs(float(m_p["grad_norm"])),
        "priority": float((p_k - p_p).abs().max()) / float(p_p.abs().max()),
    }
    emit({"phase": "train", "check": "sgd_update kernels vs plain", "loss": float(m_k["loss"]),
          "grad_norm": float(m_k["grad_norm"]), "rel_gap": gaps, "rel_tol": SGD_REL_TOL})
    bad = {k: v for k, v in gaps.items() if not v <= SGD_REL_TOL[k]}
    if bad:
        fail(f"sgd_update through the kernels differs from the plain versions: {bad}")

    # 7. kernels: launches are the 3 train chunks' (the eval's B1 count is on its line)
    b1, b2, b3t = timing["B1_learner"], timing["B2_learner"], timing["B3_flagship"]
    emit({"kernels": [
        {"name": "lstm_seq (B1)", "route": "cuda", "source": "hanabi_sad_tpu_torch/ops/csrc/lstm_seq.cu",
         "replaces": "hanabi_sad_tpu/ops/experimental/pallas_lstm.py:166",
         "launches": totals["b1"], "launches_by_kernel": {"gates": totals["b1_gates"],
                                                          "recurrence": totals["b1_recurrence"]},
         "max_abs_err": max(b1_errors.values()), "ms": b1["ms"],
         "plain_ms": b1["plain_ms"], "bound_ms": b1["bound_ms"], "bound_by": b1["bound_by"],
         "library_ms": b1["library_ms"], "shape": "T=80 B=128 H=512 L=2",
         "eval_shape": timing["B1_eval"], "eval_launches": eval_counts["b1"],
         "rollout_shape": timing["B1_rollout"]},
        {"name": "lstm_seq_diff (B2)", "route": "cuda", "source": "hanabi_sad_tpu_torch/ops/csrc/lstm_bwd.cu",
         "replaces": "hanabi_sad_tpu/ops/experimental/pallas_lstm.py:212",
         "launches": totals["b2_bwd"], "calls": totals["b2"], "max_abs_err": b2_max_err, "ms": b2["ms"],
         "plain_ms": b2["plain_ms"], "bound_ms": b2["bound_ms"], "bound_by": b2["bound_by"],
         "library_ms": b2["library_ms"], "shape": "T=80 B=128 H=512 L=2, forward + backward"},
        {"name": "gather_unpack (B3)", "route": "cuda",
         "source": "hanabi_sad_tpu_torch/ops/csrc/gather_unpack.cu",
         "replaces": "hanabi_sad_tpu/ops/experimental/pallas_replay.py:68",
         "launches": totals["b3"], "max_abs_err": max(b3_errors), "ms": b3t["ms"], "plain_ms": b3t["plain_ms"],
         "bound_ms": b3t["bound_ms"], "bound_by": b3t["bound_by"], "library_ms": None,
         "shape": "64 of 65,536 episodes x [80, 2, 110] bytes"},
    ], "train_chunk_wall_s": train_walls})
    print(f"# total seconds: {time.time() - t_all:.1f}", flush=True)
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
    faulthandler.cancel_dump_traceback_later()
