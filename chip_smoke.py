"""Smoke run of the PyTorch port (`hanabi_sad_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing JSON lines (any failure exits nonzero):
  1. device   the card, its power limit, the torch and CUDA versions;
  2. build    nvcc builds kernels B1 (ops/csrc/lstm_seq.cu), B2's backward
              (ops/csrc/lstm_bwd.cu), their bfloat16 routes
              (ops/csrc/lstm_bf16.cu) and B3 (ops/csrc/sample_batch.cu) in
              parallel, with -Xptxas -v; then cuobjdump -sass of the LSTM
              libraries: every bfloat16 kernel holds tensor-core
              instructions (HMMA or HGMMA), no float32 kernel does;
  3. check    on the flagship's LSTM weights: B1 against its plain version
              at the eval shape, the rollout shape and a ragged batch; at
              the learner shape [80, 128, 512] over 8 seeds, B1's and B2's
              outputs and each of B2's grads against float64, no further
              than twice the plain float32 version (autograd for the grads), B2's
              forward equal to B1's bit for bit and its grads within
              GRAD_REL_TOL of plain autograd; two calls of B1 and of B2 on the
              same inputs give the same bits, and a hash of B1's and B2's
              float32 outputs and grads on seed-fixed inputs (`f32_hash`,
              for comparing two trees); then B1 and B2's bfloat16 routes:
              at the rollout shapes of 2 and 3 players and a ragged batch
              against the plain bf16 version (BF16_STEP_ULPS), at the learner
              shape over 8 seeds by the BF16_RULES against float64, B2's
              forward equal to B1's, the same bits twice; B3 against its plain
              version, every field of the Batch bit for bit, on random replay
              fields and at indices out of range on both ends;
  4. timing   B1 at the eval, rollout and learner shapes, B2 forward + backward, B3,
              each beside its plain version, its library call (cuDNN
              nn.LSTM for B1 and B2, none for B3), its bound and its launches
              per call; B3 as device time under torch.profiler, with L2
              flushed before each call (its caller finds the replay cold)
              and without, and per call back to back with the host's
              launch time; B1 bf16 at the rollout shapes of 2 and 3 players
              and the learner shape, and B2 bf16, each beside its plain
              version, cuDNN in bf16, the float32 kernel and the bound at the
              tensor cores' bf16 rate; the persistent kernels' time per step
              (device time under torch.profiler / T) in float32 and bf16,
              forward and backward, and B2 bf16's device time split into its
              forward, its backward kernel and the rest (the batched cuBLAS
              products of the backward and their sums); then, on a line of
              its own, the bf16 routes' times in their first port, as
              constants (FIRST_PORT_BF16_MS);
  5. eval     greedy self-play of docs/runs/sad_aux_r4_soup10.pkl, 1000 games,
              through B1, then through the plain LSTM on the same decks;
  6. train    the flagship SAD-AUX trainer (preset sad_2p, pred_weight 0.25,
              float32) at full width, warm-started from the same checkpoint:
              one collect-only chunk, B3 against its plain version on that
              real replay with duplicate indices, 3 train chunks (one line
              each, with launch counts); then, on one presampled batch: one
              sgd_update through the kernels and through the plain versions;
              that the learner's reshapes of B3's fields are views; that
              duplicate rows give bit-identical priorities; and a train_state
              payload saved and restored into a fresh state, whose
              sgd_update gives the same bits as the saved state's;
     train_bf16  the same in compute_dtype bfloat16 (the shipped runs' dtype),
              warm-started: one collect-only chunk, 3 train chunks within
              BANDS beside the flagship log's bf16 epochs, one sgd_update
              through the kernels and the plain versions (SGD_REL_TOL_BF16);
     train_iql   preset iql_2p at full width from scratch: one collect-only
              chunk, B3 bit for bit on that replay at Pi = 1, 2 train chunks
              with finite metrics, one sgd_update kernels vs plain;
     eval_iql_3p docs/runs/iql_3p_r5_model4.pkl, 1000 games of 3 players,
              through B1 and the plain LSTM on the same decks, within
              IQL_3P_BAND of the JAX package's eval;
  7. kernels  one {"kernels": [...]} line for B1 and B2 in float32 and in
              bfloat16 (with whether their SASS uses the tensor cores, their
              per-step µs and B2's split), and B3; every number on it is
              measured by this run but the bound, which it computes.
The line before the last is the card's name and power limit as nvidia-smi
prints them; the last line is {"ok": true, "device": {...}}.

Without a CUDA card, or without the port beside it, it exits nonzero and
prints no result. It imports nothing of JAX or of the JAX package.
"""

import faulthandler

faulthandler.dump_traceback_later(900, exit=True)

import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

FLAGSHIP = "docs/runs/sad_aux_r4_soup10.pkl"
JAX_FLAGSHIP_MEAN = 24.05  # README.md, 5000 games of the JAX eval
MEAN_BAND = 0.25  # about 4-5 SEM of a 1000-game eval
# The 3-player IQL checkpoint: the JAX package's greedy eval of it on the
# CPU, 1000 games, seed 1 (python -m hanabi_sad_tpu.tools.eval_model --weight
# docs/runs/iql_3p_r5_model4.pkl --num_game 1000 --num_player 3), mean and
# SEM; the band is 4.7 SEM of a 1000-game eval, as MEAN_BAND is.
IQL_3P = "docs/runs/iql_3p_r5_model4.pkl"
JAX_IQL_3P_MEAN, JAX_IQL_3P_SEM = 14.593, 0.106665
IQL_3P_BAND = 0.5
# docs/runs/sad_aux_r1_train.log, epochs 803-805 (bfloat16, steady state),
# beside which the bf16 warm-start chunks are reported.
FLAGSHIP_LOG_BF16 = {"chunk_score": 23.48, "aux1": 0.40, "rl_loss": [0.19, 0.20], "grad_norm": 11.4, "loss": 5.7}
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
H100_BF16_FLOPS = 989e12  # bfloat16 on the tensor cores, dense, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12
# Bytes written over the card's L2 (50 MB) before each flushed timing call,
# by a kernel whose name no timed function's kernels carry.
FLUSH_BYTES = 64 * 2 ** 20
FLUSH_KERNEL = "bitwise_not"
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
# B1 and B2's bfloat16 routes. Shapes: the rollout's one-step calls at 2 and
# 3 players (1024 envs x 2 or 3 seats), a ragged batch, the learner's.
B1_BF16_CASES = {"rollout": (1, 2048), "rollout_3p": (1, 3072), "ragged": (1, 13), "learner": (80, 128)}
# At one step, B1 bf16 against the plain bf16 version, in bfloat16 ulps at
# the scale of each output (its largest value): one rounding of float32 sums
# taken in another order moves an output by at most one ulp.
BF16_STEP_ULPS = 1.0
# BF16_RULES, at the learner shape over F64_SEEDS inputs, each held to
# F64_FACTOR times the plain bf16 version's distance to float64:
#  (a) the outputs against the same function in float64 on the bf16-rounded
#      inputs and weights, without the roundings of h and c;
#  (b) every step's activations, h and c against a float64 step from the
#      step's own stored previous state (B1's saved trajectory; the plain
#      version's own);
#  (c) B2's backward kernel (dG, dh0, dc0 of each layer) against float64 BPTT
#      over B1's saved trajectory, beside the plain float32 recurrence over
#      the same tensors (the final grads are rounded to bf16 for bf16 inputs,
#      which would hide the kernel's own float32 sums).
# Grads against (a)'s reference are reported and not gated: over 80 steps on
# these weights a bf16 rounding that flips grows to O(1) (the grads of the
# rounded function lie 2.4x their largest value from the unrounded one's,
# scripts/torch_lstm_error_spread.py --dtype bfloat16), so that ratio swings
# between 0.2x and 5.6x from draw to draw whatever the kernel does.
BF16_RULES = ("outputs", "steps", "backward")
# A bf16 sgd_update through the kernels against the plain versions: the
# roundings of h and c flip where float32 sums differ in order, and a flip
# grows over the 80 steps, so the gap is bf16's, not float32's. Measured:
# 1.3e-5, 1.2e-4 and 2.2e-4 in the first full-width run (PERF.md).
SGD_REL_TOL_BF16 = {"loss": 1e-3, "grad_norm": 1e-2, "priority": 1e-2}
# B1 and B2 bf16's times in their first port, the float32 FMA tiles on
# converted values (ms, this script's phase timing, three runs on NVIDIA H100
# 80GB HBM3 at 700 W; PERF.md section 6). Constants, not measured by this
# run: they are printed on a line of their own, never on the kernels line.
FIRST_PORT_BF16_MS = {"B1_bf16_rollout": [0.4879, 0.4907, 0.4871], "B1_bf16_rollout_3p": [0.8438, 0.8387, 0.8495],
                      "B1_bf16_learner": [3.836, 3.824, 3.812], "B2_bf16_learner": [9.869, 9.811, 9.831]}
# Tensor-core instructions in SASS: mma.sync compiles to HMMA, wgmma to HGMMA.
TENSOR_CORE_SASS = ("HMMA", "HGMMA")
# The kernels (by a part of their names) behind each LSTM entry point.
LSTM_ENTRY_KERNELS = {"lstm_gates": "gates_kernel", "lstm_recurrence": "recurrence_kernel", "lstm_bwd": "bwd_kernel"}


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound(flops, nbytes, peak=H100_F32_FLOPS):
    """Least time: the larger of operations over the rate `peak` (float32 by
    default) and bytes (inputs read once, outputs written once) over the
    memory rate. Returns (ms, "operations" or "bytes")."""
    t_ops, t_bytes = flops / peak, nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def lstm_words(T, B, H, L):
    """float32 words of one forward: xs, h0/c0, weights in; outs, hT/cT out."""
    return 2 * T * B * H + 4 * L * B * H + L * (2 * H * 4 * H + 4 * H)


def lstm_flops(T, B, H, L):
    return 2.0 * T * L * B * (2 * H) * (4 * H)


def flat3(result):
    """(outs, (hT, cT)) -> [outs, hT, cT]."""
    return [result[0], *result[1]]


def bf16_ulp(x):
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 2.0 ** -126))) - 7)


def bwd_gaps(torch, kernel, plain, params, hidden, saved, cot):
    """For each layer from the top, the largest distance of the backward
    recurrence's dG, dh0 and dc0 (the kernel's and the plain float32
    version's) from float64 over the same saved trajectory, each relative to
    its largest float64 value; every layer gets the float64 reference's
    dout, in float32 for the two under test."""
    gaps = {}
    dout = cot[0].double()
    for layer in reversed(range(len(params))):
        p = params[layer]
        args32 = (dout.float().contiguous(), cot[1][layer].float().contiguous(), cot[2][layer].float().contiguous(),
                  saved.act[layer], saved.cseq[layer], hidden[1][layer], p["w_hh"])
        ref = plain(dout, cot[1][layer].double(), cot[2][layer].double(), saved.act[layer].double(),
                    saved.cseq[layer].double(), hidden[1][layer].double(), p["w_hh"].double())
        for who, got in (("B2", kernel(*args32)), ("plain", plain(*args32))):
            for part, a, r in zip(("dG", "dh0", "dc0"), got, ref):
                gaps[f"{part}{layer}.{who}"] = float((a.double() - r).abs().max() / r.abs().max())
        dout = ref[0] @ p["w_ih"].double().t()
    return gaps


def step_gaps(torch, params, xs, hidden, saved):
    """Largest distance, over layers and steps, of the stored activations,
    h and c of a saved trajectory from a float64 step taken from the stored
    previous h and c (the bfloat16-rounded weights and inputs in float64)."""
    gaps = {"act": 0.0, "h": 0.0, "c": 0.0}
    x = xs
    for layer, p in enumerate(params):
        p64 = {k: v.double() for k, v in p.items()}
        hseq, cseq = saved.hseq[layer], saved.cseq[layer]
        h_prev = torch.cat([hidden[0][layer][None], hseq[:-1]]).double()
        c_prev = torch.cat([hidden[1][layer][None].to(cseq.dtype), cseq[:-1]]).double()
        gates = x.double() @ p64["w_ih"] + h_prev @ p64["w_hh"] + p64["b"]
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        c = f * c_prev + i * g
        for name, stored, ref in (("act", saved.act[layer], torch.cat([i, f, g, o], dim=-1)),
                                  ("h", hseq, o * torch.tanh(c)), ("c", cseq, c)):
            gaps[name] = max(gaps[name], float((stored.double() - ref).abs().max()))
        x = hseq
    return gaps


def kernel_times(torch, fn, iters=10, warmup=2):
    """{kernel name: (device ms per call of fn, launches per call)} under
    torch.profiler."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = lambda row: getattr(row, "self_device_time_total", None) or getattr(row, "self_cuda_time_total", 0)
    return {row.key: (us(row) / iters / 1e3, row.count / iters) for row in prof.key_averages() if us(row) > 0}


def device_ms(torch, fn, flush=None, iters=20, warmup=3):
    """Per call of fn: the device time of the kernels it launches, summed
    from torch.profiler, so the host's time to launch them is left out (B3's
    wrapper takes longer on the host than its kernel on the card). With
    `flush`, L2 is overwritten before each call and the flush's own kernel
    is left out of the sum."""
    call = fn if flush is None else lambda: (flush(), fn())
    times = kernel_times(torch, call, iters=iters, warmup=warmup)
    return sum(ms for name, (ms, _) in times.items() if FLUSH_KERNEL not in name)


def batch_bytes(T, B, Pi, NB, F, A, H3):
    """Bytes B3 must move: the Batch written once (f32 bit fields, int64
    action, f32 reward, bootstrap, terminal and seq_len) and its inputs
    read once (the packed rows, the side fields' rows, the indices)."""
    writes = 4 * T * B * Pi * (F + A + H3) + 8 * T * B * Pi + 3 * 4 * T * B + 4 * B
    reads = T * B * Pi * NB + 8 * T * B * Pi + 2 * 4 * T * B + 4 * B + 8 * B
    return writes + reads


def sass_tensor_ops(path, cuobjdump):
    """{kernel (mangled name): its tensor-core instructions} in the SASS of
    the library at `path`."""
    out = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        fail(f"cuobjdump -sass {path} failed: {out.stderr.strip()}")
    counts, name = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = 0
        elif name is not None and any(op in line for op in TENSOR_CORE_SASS):
            counts[name] += 1
    return counts


def f32_hash(torch, dev):
    """A sha256 of B1's float32 outputs at the eval and learner shapes and of
    B2's float32 outputs and grads at the learner shape, on the flagship's
    LSTM weights and seed-fixed inputs: two trees whose float32 routes give
    the same bits give the same digest. It uses only entry points that the
    port has had since its float32 routes were redesigned, so a parent tree's
    package can be hashed by it too. Returns (digest, {part: its digest's
    first 16 hex digits})."""
    import hashlib

    from hanabi_sad_tpu_torch.ops.lstm_seq import lstm_seq_diff, lstm_seq_kernel
    from hanabi_sad_tpu_torch.tools import loaders

    torch.backends.cuda.matmul.allow_tf32 = False
    params = loaders.load_any(FLAGSHIP, device=dev).params.online.lstm
    L, H = len(params), params[0]["w_hh"].shape[0]
    g = torch.Generator().manual_seed(20)
    r = lambda *shape, scale=1.0: (scale * torch.randn(*shape, generator=g)).to(dev)
    parts = {}
    with torch.no_grad():
        for T, B in (B1_CASES["eval"], B1_CASES["learner"]):
            parts[f"B1_{T}x{B}"] = flat3(lstm_seq_kernel(params, r(T, B, H), (r(L, B, H, scale=0.5),
                                                                               r(L, B, H, scale=0.5))))
    T, B = B1_CASES["learner"]
    ps = [{k: v.clone().requires_grad_(True) for k, v in p.items()} for p in params]
    ts = [t.requires_grad_(True) for t in (r(T, B, H), r(L, B, H, scale=0.5), r(L, B, H, scale=0.5))]
    outs, (h_t, c_t) = lstm_seq_diff(ps, ts[0], (ts[1], ts[2]))
    leaves = ts + [p[k] for p in ps for k in ("w_ih", "w_hh", "b")]
    parts["B2_grads"] = list(torch.autograd.grad((outs, h_t, c_t), leaves, [r(T, B, H), r(L, B, H), r(L, B, H)]))
    parts["B2_outputs"] = [outs.detach(), h_t.detach(), c_t.detach()]
    whole, short = hashlib.sha256(), {}
    for name, tensors in parts.items():
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
        whole.update(h.digest())
        short[name] = h.hexdigest()[:16]
    return whole.hexdigest(), short


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

    from hanabi_sad_tpu_torch.agent import r2d2_agent
    from hanabi_sad_tpu_torch.agent.r2d2_agent import AgentParams, clone_params
    from hanabi_sad_tpu_torch.game.config import GameConfig
    from hanabi_sad_tpu_torch.game.state import shuffled_decks
    from hanabi_sad_tpu_torch.models import lstm as lstm_mod
    from hanabi_sad_tpu_torch.models import r2d2_net
    from hanabi_sad_tpu_torch.ops import build
    from hanabi_sad_tpu_torch.ops import sample_batch as sb
    from hanabi_sad_tpu_torch.ops.lstm_seq import (
        LstmSeqDiff, lstm_bwd_kernel, lstm_bwd_recurrence_plain, lstm_seq_diff, lstm_seq_kernel, lstm_seq_plain)
    from hanabi_sad_tpu_torch.replay import prioritized as replay_mod
    from hanabi_sad_tpu_torch.tools import loaders
    from hanabi_sad_tpu_torch.train import checkpoint as ckpt
    from hanabi_sad_tpu_torch.train import learner, selfplay
    from hanabi_sad_tpu_torch.train.config import make_config
    from hanabi_sad_tpu_torch.train.evaluate import evaluate

    b3 = sb.sample_batch_kernel
    dev = torch.device("cuda")

    def reset_counts():
        lstm_seq_kernel.reset()
        lstm_bwd_kernel.reset()
        b3.launches = LstmSeqDiff.calls = 0

    def counts():
        return {"b1": lstm_seq_kernel.launches, **{f"b1_{k}": v for k, v in lstm_seq_kernel.launches_by_kernel.items()},
                "b1_bf16": lstm_seq_kernel.launches_by_dtype["bf16"], "b2": LstmSeqDiff.calls,
                "b2_bwd": lstm_bwd_kernel.launches, "b2_bwd_bf16": lstm_bwd_kernel.launches_by_dtype["bf16"],
                "b3": b3.launches}

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
    lstm_sources = sorted({*lstm_seq_kernel.sources.values(), *lstm_bwd_kernel.sources.values()})
    built = build.build_many(lstm_sources + [b3.source])
    for wrapper in (lstm_seq_kernel, lstm_bwd_kernel, b3):
        wrapper.load()
    for source, (_, ptxas) in built.items():
        emit({"phase": "build", "source": source, "ptxas": ptxas})
    # The SASS of the LSTM libraries: every kernel of the bfloat16 library
    # uses the tensor cores, no kernel of a float32 library does.
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    if not os.access(cuobjdump, os.X_OK):
        fail(f"cuobjdump not found beside nvcc at {cuobjdump}; the SASS check cannot run")
    tensor_cores = {}
    for suffix in ("f32", "bf16"):
        sass = {}
        for source in {lstm_seq_kernel.sources[suffix], lstm_bwd_kernel.sources[suffix]}:
            sass.update(sass_tensor_ops(build.lib_path(source), cuobjdump))
        for entry, part in LSTM_ENTRY_KERNELS.items():
            uses = [count > 0 for name, count in sass.items() if part in name]
            if not uses:
                fail(f"no kernel of {entry}_{suffix} in the SASS")
            # bf16: every kernel of the entry point; float32: any of them
            tensor_cores[f"{entry}_{suffix}"] = all(uses) if suffix == "bf16" else any(uses)
        emit({"phase": "build", "sass_tensor_core_instructions": suffix, "kernels": sass})
    emit({"phase": "build", "tensor_cores": tensor_cores})
    bad = [k for k, v in tensor_cores.items() if v != k.endswith("_bf16")]
    if bad:
        fail(f"tensor cores where they should not be, or missing where they should be: {bad}")
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
    digest, parts = f32_hash(torch, dev)
    emit({"phase": "check", "f32_hash": digest, "parts": parts})

    # B1 and B2's bfloat16 routes. At the one-step shapes (rollout, 2 and 3
    # players, and a ragged batch) against the plain bf16 version within
    # BF16_STEP_ULPS; at the learner shape over F64_SEEDS inputs, against
    # float64 by the rules at BF16_RULES; two calls give the same bits.
    pb = [{k: v.bfloat16() for k, v in p.items()} for p in lstm_params]
    bf16_errors = {}
    with torch.no_grad():
        for case, (T, B) in B1_BF16_CASES.items():
            if case == "learner":
                continue
            xs, h0, c0 = (t.bfloat16() for t in (randn(T, B, H), randn(L, B, H, scale=0.5),
                                                    randn(L, B, H, scale=0.5)))
            ys_k = flat3(lstm_seq_kernel(pb, xs, (h0, c0)))
            again = flat3(lstm_seq_kernel(pb, xs, (h0, c0)))
            ys_p = flat3(lstm_seq_plain(pb, xs, (h0, c0)))
            torch.cuda.synchronize()
            ulps = max(float((a.float() - b.float()).abs().max()) / bf16_ulp(float(b.float().abs().max()))
                       for a, b in zip(ys_k, ys_p))
            bf16_errors[case] = max(float((a.float() - b.float()).abs().max()) for a, b in zip(ys_k, ys_p))
            deterministic[f"B1_bf16_{case}"] = all(torch.equal(a, b) for a, b in zip(ys_k, again))
            emit({"phase": "check", "kernel": "B1 bf16", "case": case, "T": T, "B": B, "H": H, "L": L,
                  "max_abs_err": bf16_errors[case], "ulps_at_scale": ulps, "tol_ulps": BF16_STEP_ULPS})
            if not ulps <= BF16_STEP_ULPS:
                fail(f"B1 bf16 disagrees with its plain version at {case}: {ulps} ulps > {BF16_STEP_ULPS}")

    T, B = B1_BF16_CASES["learner"]
    bworst = {}
    b2_is_b1_bf16 = True
    for seed in range(F64_SEEDS):
        g = torch.Generator().manual_seed(seed)
        r = lambda *shape, scale=1.0: (scale * torch.randn(*shape, generator=g)).to(dev).bfloat16()
        xs, h0, c0 = r(T, B, H), r(L, B, H, scale=0.5), r(L, B, H, scale=0.5)
        cot = (r(T, B, H), r(L, B, H), r(L, B, H))
        with torch.no_grad():
            b1_k = lstm_seq_kernel(pb, xs, (h0, c0), save=True)
            b1_p = lstm_seq_plain(pb, xs, (h0, c0), save=True)
        readings = {}
        # (a) outputs against float64 without the roundings of h and c
        ys_k, grads_k = fwd_bwd(lstm_seq_diff, *leaves_of(pb, xs, h0, c0, dtype=torch.bfloat16), cot)
        ys_p, grads_p = fwd_bwd(lstm_seq_plain, *leaves_of(pb, xs, h0, c0, dtype=torch.bfloat16), cot)
        ys_64, grads_64 = fwd_bwd(lstm_seq_plain, *leaves_of(pb, xs, h0, c0, dtype=torch.float64), cot)
        b2_is_b1_bf16 &= all(torch.equal(a, b) for a, b in zip(ys_k, flat3(b1_k[:2])))
        for who, ys in (("B1", flat3(b1_k[:2])), ("B2", ys_k), ("plain", ys_p)):
            readings[f"out.{who}"] = max(largest_gap(y, ref) for y, ref in zip(ys, ys_64))
        for n, gk, gp, ref in zip(names, grads_k, grads_p, grads_64):
            readings[f"grad_unrounded.{n}.B2"] = largest_gap(gk, ref, rel=True)
            readings[f"grad_unrounded.{n}.plain"] = largest_gap(gp, ref, rel=True)
        # (b) each step from its own stored previous state, against a float64 step
        for who, saved in (("B1", b1_k[2]), ("plain", b1_p[2])):
            for k, v in step_gaps(torch, pb, xs, (h0, c0), saved).items():
                readings[f"step.{k}.{who}"] = v
        # (c) B2's backward kernel (its bf16 entry point) over B1's saved
        # trajectory against float64 BPTT over the same tensors, beside the
        # plain float32 recurrence: dG, dh0 and dc0 of each layer, every layer
        # fed the float64 reference's dout
        for k, v in bwd_gaps(torch, lstm_bwd_kernel, lstm_bwd_recurrence_plain, pb, (h0, c0), b1_k[2],
                             cot).items():
            readings[f"bwd.{k}"] = v
        if seed == 0:
            with torch.no_grad():
                again = lstm_seq_kernel(pb, xs, (h0, c0))
            ys_k2, grads_k2 = fwd_bwd(lstm_seq_diff, *leaves_of(pb, xs, h0, c0, dtype=torch.bfloat16), cot)
            deterministic["B1_bf16_learner"] = all(torch.equal(a, b) for a, b in zip(flat3(b1_k[:2]), flat3(again)))
            deterministic["B2_bf16_learner"] = all(torch.equal(a, b) for a, b in zip(
                ys_k + list(grads_k), ys_k2 + list(grads_k2)))
        torch.cuda.synchronize()
        for k, v in readings.items():
            bworst[k] = max(bworst.get(k, 0.0), v)
        del b1_k, b1_p, ys_k, grads_k, ys_p, grads_p, ys_64, grads_64
    bf16_ratio = {"out.B1": bworst["out.B1"] / bworst["out.plain"],
                  "out.B2": bworst["out.B2"] / bworst["out.plain"]}
    for part in ("act", "h", "c"):
        bf16_ratio[f"step.{part}.B1"] = bworst[f"step.{part}.B1"] / max(bworst[f"step.{part}.plain"], 1e-30)
    for layer in range(L):
        for part in ("dG", "dh0", "dc0"):
            bf16_ratio[f"bwd.{part}{layer}.B2"] = (bworst[f"bwd.{part}{layer}.B2"]
                                                  / max(bworst[f"bwd.{part}{layer}.plain"], 1e-30))
    unrounded = {n: bworst[f"grad_unrounded.{n}.B2"] / max(bworst[f"grad_unrounded.{n}.plain"], 1e-30)
                 for n in names}
    emit({"phase": "check", "kernel": "B1 and B2 bf16", "T": T, "B": B, "H": H, "L": L, "seeds": F64_SEEDS,
          "largest_gap_to_f64": bworst, "ratio_to_plain": bf16_ratio, "factor": F64_FACTOR,
          "grad_ratio_to_plain_unrounded_reference_not_gated": unrounded,
          "b2_forward_equals_B1": b2_is_b1_bf16, "deterministic": deterministic})
    if not b2_is_b1_bf16:
        fail("B2's bf16 forward differs from B1's on the same inputs")
    bad = {k: v for k, v in bf16_ratio.items() if not v <= F64_FACTOR}
    if bad:
        fail(f"bf16: further than {F64_FACTOR}x the plain bf16 version from float64: {bad}")
    if not all(deterministic.values()):
        fail(f"two calls on the same inputs gave different bits: {deterministic}")
    bf16_errors["learner"] = bworst["out.B1"]
    b2_bf16_max_err = max(v for k, v in bworst.items() if k.startswith("bwd.") and k.endswith(".B2"))

    # B3 on random replay fields, indices out of range read as JAX reads them
    sizes = dict(obs_dim=838, num_actions=21, hand_size=5)

    def replay_fields(cap, seed):
        """Random replay fields of the flagship's episode shape, made on the card."""
        g = torch.Generator(device=dev).manual_seed(seed)
        return (torch.randint(0, 256, (cap, 80, 2, 110), dtype=torch.uint8, generator=g, device=dev),
                torch.randint(0, 21, (cap, 80, 2), generator=g, device=dev),
                torch.randn(cap, 80, generator=g, device=dev), torch.rand(cap, 80, generator=g, device=dev),
                torch.randint(1, 81, (cap,), generator=g, device=dev).float())

    b3_errors = []

    def b3_check(case, fields, idx, rows=None, shape=sizes):
        out_k = b3(*fields, idx, **shape)
        out_p = sb.sample_batch_plain(*fields, idx if rows is None else rows, **shape)
        torch.cuda.synchronize()
        b3_errors.append(max(float((a.double() - b.double()).abs().max()) for a, b in zip(out_k, out_p)))
        same = {f: bool(torch.equal(a, b)) for f, a, b in zip(out_k._fields, out_k, out_p)}
        contiguous = all(t.is_contiguous() for t in out_k)
        emit({"phase": "check", "kernel": "B3", "case": case, "B": int(idx.numel()),
              "Pi": int(fields[0].shape[2]), "distinct": int(idx.unique().numel()), "equal": same,
              "contiguous": contiguous})
        if not (all(same.values()) and contiguous):
            fail(f"B3 disagrees with its plain version on {case}: {same}, contiguous {contiguous}")

    fields = replay_fields(50, seed=0)
    b3_check("random replay, indices out of range", fields, torch.tensor([3, 49, 3, -2, 60, 0, 7], device=dev))
    # [-cap, -1] counts from the end, the rest is clamped
    cap = 50
    idx = torch.tensor([-cap - 2, -cap, -1, 0, cap - 1, cap, cap + 3], device=dev)
    rows = torch.tensor([0, 0, cap - 1, 0, cap - 1, cap - 1, cap - 1], device=dev)
    b3_check("indices out of range, as JAX reads them", fields, idx)
    b3_check("indices out of range, against the rows JAX reads", fields, idx, rows)
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

    # B1 and B2's bf16 routes: beside each, its plain bf16 version, cuDNN
    # nn.LSTM in bf16 (the library), the float32 kernel at the same shape,
    # and the bound at the tensor cores' bf16 rate with bf16 bytes (the least
    # time for the work, whatever implements it).
    cudnn_bf16 = torch.nn.LSTM(H, H, num_layers=L).to(dev, torch.bfloat16)
    with torch.no_grad():
        for name, t in cudnn.named_parameters():
            getattr(cudnn_bf16, name).copy_(t)
    cudnn_bf16.flatten_parameters()
    for case in ("rollout", "rollout_3p", "learner"):
        T, B = B1_BF16_CASES[case]
        xs, h0, c0 = randn(T, B, H), randn(L, B, H, scale=0.5), randn(L, B, H, scale=0.5)
        xb, hb, cb = xs.bfloat16(), h0.bfloat16(), c0.bfloat16()
        with torch.no_grad():
            lib_err = float((cudnn_bf16(xb, (hb, cb))[0].float() - lstm_seq_plain(pb, xb, (hb, cb))[0].float())
                            .abs().max())
            reset_counts()
            lstm_seq_kernel(pb, xb, (hb, cb))
            per_call = counts()
            ms = cuda_ms(torch, lambda: lstm_seq_kernel(pb, xb, (hb, cb)))
            f32_ms = cuda_ms(torch, lambda: lstm_seq_kernel(lstm_params, xs, (h0, c0)))
            plain_ms = cuda_ms(torch, lambda: lstm_seq_plain(pb, xb, (hb, cb)))
            library_ms = cuda_ms(torch, lambda: cudnn_bf16(xb, (hb, cb)))
        b_ms, b_by = bound(lstm_flops(T, B, H, L), 2.0 * lstm_words(T, B, H, L), peak=H100_BF16_FLOPS)
        timing[f"B1_bf16_{case}"] = {
            "T": T, "B": B, "ms": ms, "f32_kernel_ms": f32_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_max_abs_err": lib_err, "bound_ms": b_ms, "bound_by": b_by,
            "launches_per_call": {k: v for k, v in per_call.items() if k.startswith("b1")}}
    T, B = B1_BF16_CASES["learner"]
    xb = xs.bfloat16()
    cotb = [c.bfloat16() for c in cot]
    ps_b, ts_b, leaves_b = leaves_of(pb, xb, hb, cb, dtype=torch.bfloat16)
    cudnn_leaves_b = [t.detach().clone().requires_grad_(True) for t in (xb, hb, cb)]

    def cudnn_bf16_fwd_bwd():
        out, (h_t, c_t) = cudnn_bf16(cudnn_leaves_b[0], (cudnn_leaves_b[1], cudnn_leaves_b[2]))
        return torch.autograd.grad((out, h_t, c_t), cudnn_leaves_b + list(cudnn_bf16.parameters()), cotb)

    reset_counts()
    fwd_bwd(lstm_seq_diff, ps_b, ts_b, leaves_b, cotb)
    per_call = counts()
    ms = cuda_ms(torch, lambda: fwd_bwd(lstm_seq_diff, ps_b, ts_b, leaves_b, cotb), iters=10, warmup=2)
    plain_ms = cuda_ms(torch, lambda: fwd_bwd(lstm_seq_plain, ps_b, ts_b, leaves_b, cotb), iters=10, warmup=2)
    library_ms = cuda_ms(torch, cudnn_bf16_fwd_bwd, iters=10, warmup=2)
    b_ms, b_by = bound(3 * lstm_flops(T, B, H, L), 2.0 * 2 * lstm_words(T, B, H, L), peak=H100_BF16_FLOPS)
    timing["B2_bf16_learner"] = {"T": T, "B": B, "ms": ms, "f32_kernel_ms": timing["B2_learner"]["ms"],
                                 "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b_ms,
                                 "bound_by": b_by, "launches_per_call": {k: v for k, v in per_call.items()
                                                                         if k != "b3"}}

    # Device time by kernel under torch.profiler at the learner shape: the
    # persistent kernels' time per step (a launch's time / T; B2's backward
    # runs T + 1 products), and B2's device time split into its forward (B1's
    # kernels), its backward kernel and the rest: the batched cuBLAS products
    # of the backward (dW_ih, dW_hh, dX) and their sums and casts.
    def launch_ms(times, part):
        sel = [v for k, v in times.items() if part in k]
        return sum(ms for ms, _ in sel) / sum(n for _, n in sel)

    def split_ms(times):
        fwd = sum(ms for k, (ms, _) in times.items() if "gates_kernel" in k or "recurrence_kernel" in k)
        bwd = sum(ms for k, (ms, _) in times.items() if "bwd_kernel" in k)
        rest = sorted(((ms, k) for k, (ms, _) in times.items() if not any(
            p in k for p in ("gates_kernel", "recurrence_kernel", "bwd_kernel"))), reverse=True)
        return {"forward": fwd, "backward_kernel": bwd, "products_and_rest": sum(ms for ms, _ in rest),
                "products_gemm": sum(ms for ms, k in rest if "gemm" in k.lower()),
                "total": fwd + bwd + sum(ms for ms, _ in rest), "rest_top": [[k[:80], ms] for ms, k in rest[:6]]}

    with torch.no_grad():
        b1_f32_times = kernel_times(torch, lambda: lstm_seq_kernel(lstm_params, xs, (h0, c0)))
        b1_bf16_times = kernel_times(torch, lambda: lstm_seq_kernel(pb, xb, (hb, cb)))
    b2_f32_times = kernel_times(torch, lambda: fwd_bwd(lstm_seq_diff, ps_k, ts_k, leaves_k, cot))
    b2_bf16_times = kernel_times(torch, lambda: fwd_bwd(lstm_seq_diff, ps_b, ts_b, leaves_b, cotb))
    timing["persistent_step_us"] = {
        "B1_f32": 1e3 * launch_ms(b1_f32_times, "recurrence_kernel") / T,
        "B1_bf16": 1e3 * launch_ms(b1_bf16_times, "recurrence_kernel") / T,
        "B2_bwd_f32": 1e3 * launch_ms(b2_f32_times, "bwd_kernel") / T,
        "B2_bwd_bf16": 1e3 * launch_ms(b2_bf16_times, "bwd_kernel") / T}
    timing["B1_learner_device_ms"] = {"f32": sum(ms for ms, _ in b1_f32_times.values()),
                                      "bf16": sum(ms for ms, _ in b1_bf16_times.values()),
                                      "bf16_gates": sum(ms for k, (ms, _) in b1_bf16_times.items()
                                                        if "gates_kernel" in k)}
    timing["B2_split_ms"] = {"f32": split_ms(b2_f32_times), "bf16": split_ms(b2_bf16_times)}
    del ps_b, ts_b, leaves_b, cudnn_leaves_b

    # B3 at the flagship shape: 64 of 65,536 episodes of [80, 2, 110] bytes
    # into the Batch, with L2 flushed before each call and without
    cap, Bs = 65536, 64
    fields = replay_fields(cap, seed=1)
    idx = torch.randint(0, cap, (Bs,), device=dev)
    scratch = torch.zeros(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    flush = scratch.bitwise_not_
    b3_call = lambda: b3(*fields, idx, **sizes)
    plain_call = lambda: sb.sample_batch_plain(*fields, idx, **sizes)
    reset_counts()
    b3_call()
    per_call = counts()["b3"]
    ms = device_ms(torch, b3_call, flush)
    plain_ms = device_ms(torch, plain_call, flush)
    warm_ms = device_ms(torch, b3_call)
    warm_plain_ms = device_ms(torch, plain_call)
    call_ms = cuda_ms(torch, b3_call)  # back to back, the host's launch time included
    nbytes = batch_bytes(80, Bs, 2, 110, 838, 21, 15)
    b_ms, b_by = bound(0.0, nbytes)
    timing["B3_flagship"] = {"B": Bs, "cap": cap, "ms": ms, "plain_ms": plain_ms, "ms_unflushed": warm_ms,
                             "plain_ms_unflushed": warm_plain_ms, "call_ms": call_ms, "library_ms": None,
                             "bytes": nbytes,
                             "bound_ms": b_ms, "bound_by": b_by, "launches_per_call": per_call}
    del fields, scratch
    emit({"phase": "timing", "card": smi_line, **timing, "seconds": round(time.time() - t0, 3)})
    emit({"phase": "timing", "first_port_bf16_ms": FIRST_PORT_BF16_MS,
          "note": "constants: the bf16 route's times on the float32 FMA tiles, not measured by this run"})

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
    state = selfplay.load_model(FLAGSHIP, state)
    optimizer = learner.make_optimizer(tcfg)
    shape = {"num_envs": tcfg.num_envs, "batch_episodes": tcfg.batchsize, "T": tcfg.max_len,
             "hidden": tcfg.rnn_hid_dim, "replay_capacity": tcfg.replay_buffer_size,
             "updates_per_chunk": tcfg.num_update_per_chunk}
    T, U = tcfg.max_len, tcfg.num_update_per_chunk
    # act: 2 nets x L gates launches per step (T = 1); each update: the
    # target's forward and B2's forward, 2 L launches each (T > 1), and B2's
    # backward, L launches
    rollout = T * 2 * L
    expect_collect = {"b1": rollout, "b1_gates": rollout, "b1_recurrence": 0, "b1_bf16": 0, "b2": 0,
                      "b2_bwd": 0, "b2_bwd_bf16": 0, "b3": 0}
    expect_train = {"b1": rollout + U * 4 * L, "b1_gates": rollout + U * 2 * L, "b1_recurrence": U * 2 * L,
                    "b1_bf16": 0, "b2": U, "b2_bwd": U * L, "b2_bwd_bf16": 0, "b3": U}

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
    r = state.replay
    b3_check("real replay after one collect chunk, duplicate indices",
             (r.packed, r.action, r.reward, r.bootstrap, r.seq_len), idx)

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
    def copy_of(st):
        opt = st.opt_state
        return st._replace(
            params=AgentParams(online=clone_params(st.params.online), target=clone_params(st.params.target)),
            opt_state=opt._replace(mu=[m.clone() for m in opt.mu], nu=[v.clone() for v in opt.nu]),
            replay=st.replay._replace(weight=st.replay.weight.clone()),
        )

    def kernels_vs_plain(setup, optimizer, st, seed):
        """One sgd_update from copies of `st` on one presampled batch, through
        the kernels and through the plain versions; returns the batch, the
        kernel path's metrics and the relative gaps."""
        idx, is_w = replay_mod.sample_indices(st.replay, setup.replay, setup.train.batchsize,
                                              generator=torch.Generator(device=dev).manual_seed(seed))
        rows = replay_mod.gather_rows(st.replay, idx)
        s_k, m_k = learner.sgd_update(setup, optimizer, copy_of(st), presampled=(rows, is_w, idx))
        kernel_sample_batch = sb.sample_batch
        lstm_mod.lstm_seq, sb.sample_batch = lstm_seq_plain, sb.sample_batch_plain
        try:
            before = counts()
            s_p, m_p = learner.sgd_update(setup, optimizer, copy_of(st), presampled=(rows, is_w, idx))
            if counts() != before:
                fail("the plain sgd_update launched a kernel")
        finally:
            lstm_mod.lstm_seq, sb.sample_batch = kernel_lstm_seq, kernel_sample_batch
        p_k, p_p = s_k.replay.weight[idx], s_p.replay.weight[idx]
        gaps = {
            "loss": abs(float(m_k["loss"]) - float(m_p["loss"])) / abs(float(m_p["loss"])),
            "grad_norm": abs(float(m_k["grad_norm"]) - float(m_p["grad_norm"])) / abs(float(m_p["grad_norm"])),
            "priority": float((p_k - p_p).abs().max()) / float(p_p.abs().max()),
        }
        return (rows, is_w, idx), m_k, gaps

    (rows, is_w, idx), m_k, gaps = kernels_vs_plain(setup, optimizer, state, seed=4)
    copy_state = lambda: copy_of(state)
    emit({"phase": "train", "check": "sgd_update kernels vs plain", "loss": float(m_k["loss"]),
          "grad_norm": float(m_k["grad_norm"]), "rel_gap": gaps, "rel_tol": SGD_REL_TOL})
    bad = {k: v for k, v in gaps.items() if not v <= SGD_REL_TOL[k]}
    if bad:
        fail(f"sgd_update through the kernels differs from the plain versions: {bad}")

    # The learner's reshapes of B3's fields are views, and duplicate rows of
    # a batch give bit-identical priorities (update_priority writes them in
    # no fixed order); the batch repeats its rows 0-7 at rows 32-39.
    dup_idx = idx.clone()
    dup_idx[32:40] = dup_idx[0:8]
    batch = replay_mod.rows_to_batch(setup.replay, replay_mod.gather_rows(state.replay, dup_idx))
    seen = {}
    forward, pred_loss = r2d2_net.forward, r2d2_net.pred_loss_1st

    def recording_forward(params, net_cfg, priv_s, legal, action):
        seen.setdefault("priv_s", priv_s.data_ptr())
        seen.setdefault("legal_move", legal.data_ptr())
        return forward(params, net_cfg, priv_s, legal, action)

    def recording_pred_loss(params, lstm_o, own_hand, *args):
        seen["own_hand"] = own_hand.data_ptr()
        return pred_loss(params, lstm_o, own_hand, *args)

    r2d2_net.forward, r2d2_net.pred_loss_1st = recording_forward, recording_pred_loss
    try:
        with torch.no_grad():
            _, priority, _ = r2d2_agent.loss(state.params, setup.agent, batch, tcfg.pred_weight)
    finally:
        r2d2_net.forward, r2d2_net.pred_loss_1st = forward, pred_loss
    views = {k: seen.get(k) == getattr(batch, k).data_ptr() for k in ("priv_s", "legal_move", "own_hand")}
    agg = r2d2_agent.aggregate_priority(priority, batch.seq_len, setup.agent.eta).view(torch.int32).tolist()
    firsts, dups, differing = {}, 0, 0
    for j, p in zip(dup_idx.tolist(), agg):
        if j in firsts:
            dups += 1
            differing += p != firsts[j]
        firsts.setdefault(j, p)
    emit({"phase": "train", "check": "views and duplicate priorities", "views": views,
          "duplicate_rows": dups, "duplicate_rows_differing": differing})
    if not all(views.values()):
        fail(f"a reshape of B3's output was a copy: {views}")
    if differing:
        fail(f"{differing} of {dups} duplicate rows gave priorities that differ in their bits")

    # A train_state payload saved and restored into a fresh state: one
    # sgd_update from each on the same presampled batch gives the same bits.
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "latest.pkl")
        t0 = time.time()
        ckpt.save(path, ckpt.train_state_payload(state, {"preset": "sad_2p", "pred_weight": 0.25}))
        save_s, size = time.time() - t0, os.path.getsize(path)
        t0 = time.time()
        restored = ckpt.restore_train_state(ckpt.load(path), learner.init_train_state(setup, 0, dev))
        restore_s = time.time() - t0
    generators_equal = all(torch.equal(a.get_state(), b.get_state()) for a, b in
                           ((state.env_gen, restored.env_gen), (state.sample_gen, restored.sample_gen)))
    s_a, m_a = learner.sgd_update(setup, optimizer, copy_state(), presampled=(rows, is_w, idx))
    s_b, m_b = learner.sgd_update(setup, optimizer, restored, presampled=(rows, is_w, idx))
    pairs = {
        "metrics": [(m_a[k], m_b[k]) for k in m_a],
        "online": list(zip(learner.param_leaves(s_a.params.online), learner.param_leaves(s_b.params.online))),
        "target": list(zip(learner.param_leaves(s_a.params.target), learner.param_leaves(s_b.params.target))),
        "mu": list(zip(s_a.opt_state.mu, s_b.opt_state.mu)),
        "nu": list(zip(s_a.opt_state.nu, s_b.opt_state.nu)),
        "priority": [(s_a.replay.weight[idx], s_b.replay.weight[idx])],
    }
    same = {k: all(torch.equal(a, b) for a, b in v) for k, v in pairs.items()}
    same["counts"] = (s_a.opt_state.count, s_a.opt_state.lr_count, s_a.num_update) == (
        s_b.opt_state.count, s_b.opt_state.lr_count, s_b.num_update)
    same["generators"] = generators_equal
    emit({"phase": "train", "check": "save and restore", "bytes": size, "save_s": save_s,
          "restore_s": restore_s, "num_update": s_b.num_update, "same_bits": same})
    if not all(same.values()):
        fail(f"sgd_update after save and restore differs: {same}")
    del restored, s_a, s_b, state, rows
    torch.cuda.empty_cache()

    def collect_phase(label, setup, state, expect_collect):
        """One collect-only chunk that must fill the cut burn-in, with its
        launch counts."""
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        state, stats = learner.collect_only(setup, state)
        torch.cuda.synchronize()
        got = counts()
        emit({"phase": label, "chunk": "collect", "replay_size": int(state.replay.size),
              **{k: float(v) for k, v in stats.items()}, "wall_s": time.time() - t0, "launches": got})
        if got != expect_collect:
            fail(f"{label}: collect chunk launches {got}, expected {expect_collect}")
        if int(state.replay.size) < setup.train.burn_in_frames:
            fail(f"{label}: one collect chunk did not fill the cut burn-in")
        return state

    def train_phase(label, setup, state, optimizer, chunks, expect_train, bands):
        """`chunks` train chunks, each line with its launch counts; fails on
        other counts, a non-finite metric or a metric outside `bands`.
        Returns (state, the launches summed over the chunks, their wall
        seconds)."""
        sums, walls = dict.fromkeys(expect_train, 0), []
        for chunk in range(chunks):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            state, metrics = learner.train_chunk(setup, optimizer, state)
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
            got = counts()
            row = {k: float(v) for k, v in metrics.items()}
            emit({"phase": label, "chunk": chunk, **row, "wall_s": walls[-1], "launches": got,
                  "num_update": state.num_update, "card": smi_line})
            for k in sums:
                sums[k] += got[k]
            if got != expect_train:
                fail(f"{label}: train chunk {chunk} launches {got}, expected {expect_train}")
            if not all(math.isfinite(v) for v in row.values()):
                fail(f"{label}: non-finite metric in train chunk {chunk}: {row}")
            for k, (lo, hi) in bands.items():
                if not lo <= row[k] <= hi:
                    fail(f"{label}: train chunk {chunk}: {k} = {row[k]} outside the band [{lo}, {hi}]")
        return state, sums, walls

    # 6b. train bf16: the flagship run's configuration, compute_dtype
    # bfloat16, warm-started as in phase 6 with the same burn-in cut; 3 train
    # chunks held to BANDS (they span the log's bf16 epochs), beside the log.
    cfg = make_config("sad_2p", pred_weight=0.25, burn_in_frames=2048, compute_dtype="bfloat16")
    setup = learner.make_setup(cfg)
    state = selfplay.load_model(FLAGSHIP, learner.init_train_state(setup, setup.train.seed, dev))
    optimizer = learner.make_optimizer(setup.train)
    emit({"phase": "train_bf16", "config": {"preset": "sad_2p", "pred_weight": 0.25, "compute_dtype": "bfloat16",
                                            "burn_in_frames": 2048, **shape},
          "flagship_log_bf16": FLAGSHIP_LOG_BF16})
    state = collect_phase("train_bf16", setup, state, dict(expect_collect, b1_bf16=rollout))
    state, bf16_totals, bf16_walls = train_phase(
        "train_bf16", setup, state, optimizer, 3, dict(expect_train, b1_bf16=expect_train["b1"],
                                                       b2_bwd_bf16=U * L), BANDS)
    _, m_k, gaps = kernels_vs_plain(setup, optimizer, state, seed=5)
    emit({"phase": "train_bf16", "check": "sgd_update kernels vs plain", "loss": float(m_k["loss"]),
          "grad_norm": float(m_k["grad_norm"]), "rel_gap": gaps, "rel_tol": SGD_REL_TOL_BF16,
          "params_float32": all(t.dtype == torch.float32 for t in learner.param_leaves(state.params.online))})
    bad = {k: v for k, v in gaps.items() if not v <= SGD_REL_TOL_BF16[k]}
    if bad:
        fail(f"bf16 sgd_update through the kernels differs from the plain versions: {bad}")
    del state
    torch.cuda.empty_cache()

    # 6c. train iql: preset iql_2p at full width from scratch (1024 envs,
    # 128 items a batch, one item per player, so B3 at Pi = 1); burn-in cut
    # to 2048 items, which one collect chunk fills.
    cfg = make_config("iql_2p", burn_in_frames=2048)
    setup = learner.make_setup(cfg)
    state = learner.init_train_state(setup, setup.train.seed, dev)
    optimizer = learner.make_optimizer(setup.train)
    iql_shape = {"num_envs": setup.train.num_envs, "batch_items": setup.train.batchsize, "T": setup.train.max_len,
                 "hidden": setup.train.rnn_hid_dim, "replay_capacity": setup.train.replay_buffer_size,
                 "Pi": setup.replay.num_player, "obs_dim": setup.replay.obs_dim,
                 "bytes_per_step": setup.replay.bytes_per_step}
    emit({"phase": "train_iql", "config": {"preset": "iql_2p", "burn_in_frames": 2048, **iql_shape}})
    iql_sizes = dict(obs_dim=setup.replay.obs_dim, num_actions=setup.replay.num_actions,
                     hand_size=setup.replay.hand_size)
    state = collect_phase("train_iql", setup, state, expect_collect)
    idx, _ = replay_mod.sample_indices(state.replay, setup.replay, setup.train.batchsize,
                                       generator=torch.Generator(device=dev).manual_seed(7))
    idx[64:72] = idx[0:8]
    r = state.replay
    b3_check("IQL replay after one collect chunk, Pi = 1, duplicate indices",
             (r.packed, r.action, r.reward, r.bootstrap, r.seq_len), idx, shape=iql_sizes)
    state, iql_totals, iql_walls = train_phase("train_iql", setup, state, optimizer, 2, expect_train, {})
    _, m_k, gaps = kernels_vs_plain(setup, optimizer, state, seed=6)
    emit({"phase": "train_iql", "check": "sgd_update kernels vs plain", "loss": float(m_k["loss"]),
          "grad_norm": float(m_k["grad_norm"]), "rel_gap": gaps, "rel_tol": SGD_REL_TOL})
    bad = {k: v for k, v in gaps.items() if not v <= SGD_REL_TOL[k]}
    if bad:
        fail(f"IQL sgd_update through the kernels differs from the plain versions: {bad}")
    del state, r
    torch.cuda.empty_cache()

    # 6d. eval iql 3p: the 3-player IQL checkpoint, 1000 games, through B1
    # and through the plain LSTM on the same decks.
    policy3 = loaders.load_any(IQL_3P, device=dev)
    decks3 = shuffled_decks(GameConfig(players=3), num_game, torch.Generator().manual_seed(seed))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    mean3_k, perfect3_k, scores3_k, _ = evaluate([policy3] * 3, num_game, seed, num_steps=num_steps,
                                                 decks=decks3, device=dev)
    wall3_k = time.time() - t0
    eval3_counts = counts()
    lstm_mod.lstm_seq = lstm_seq_plain
    try:
        t0 = time.time()
        mean3_p, _, scores3_p, _ = evaluate([policy3] * 3, num_game, seed, num_steps=num_steps, decks=decks3,
                                            device=dev)
        wall3_p = time.time() - t0
    finally:
        lstm_mod.lstm_seq = kernel_lstm_seq
    if counts() != eval3_counts:
        fail("the plain 3-player eval launched a kernel")
    s3k = torch.tensor(scores3_k, dtype=torch.float64)
    agree3 = float((s3k == torch.tensor(scores3_p, dtype=torch.float64)).double().mean())
    sem3 = float(s3k.std(unbiased=False) / num_game ** 0.5)
    emit({"phase": "eval_iql_3p", "checkpoint": IQL_3P, "num_game": num_game, "seed": seed, "players": 3,
          "kernel": {"mean": mean3_k, "sem": sem3, "perfect": perfect3_k, "wall_s": wall3_k},
          "plain": {"mean": mean3_p, "wall_s": wall3_p}, "agree": agree3, "launches": eval3_counts,
          "jax_reference": {"mean": JAX_IQL_3P_MEAN, "sem": JAX_IQL_3P_SEM}, "band": IQL_3P_BAND})
    if eval3_counts["b1"] == 0:
        fail("the 3-player eval did not launch B1")
    if agree3 < 0.99:
        fail(f"3-player eval: kernel and plain paths agree on only {agree3:.4f} of games")
    if abs(mean3_k - JAX_IQL_3P_MEAN) > IQL_3P_BAND:
        fail(f"3-player eval: kernel mean {mean3_k} outside {JAX_IQL_3P_MEAN} +/- {IQL_3P_BAND}")

    # 7. kernels: launches are the 3 train chunks' of phase 6 (the eval's B1
    # count is on its line), and of phase 6b for the bf16 routes
    b1, b2, b3t = timing["B1_learner"], timing["B2_learner"], timing["B3_flagship"]
    b1b, b2b = timing["B1_bf16_learner"], timing["B2_bf16_learner"]
    emit({"kernels": [
        {"name": "lstm_seq (B1)", "route": "cuda", "source": "hanabi_sad_tpu_torch/ops/csrc/lstm_seq.cu",
         "replaces": "hanabi_sad_tpu/ops/experimental/pallas_lstm.py:166",
         "launches": totals["b1"], "launches_by_kernel": {"gates": totals["b1_gates"],
                                                          "recurrence": totals["b1_recurrence"]},
         "max_abs_err": max(b1_errors.values()), "ms": b1["ms"],
         "plain_ms": b1["plain_ms"], "bound_ms": b1["bound_ms"], "bound_by": b1["bound_by"],
         "library_ms": b1["library_ms"], "shape": "T=80 B=128 H=512 L=2",
         "tensor_cores": tensor_cores["lstm_gates_f32"] or tensor_cores["lstm_recurrence_f32"],
         "step_us": timing["persistent_step_us"]["B1_f32"],
         "eval_shape": timing["B1_eval"], "eval_launches": eval_counts["b1"],
         "rollout_shape": timing["B1_rollout"]},
        {"name": "lstm_seq_diff (B2)", "route": "cuda", "source": "hanabi_sad_tpu_torch/ops/csrc/lstm_bwd.cu",
         "replaces": "hanabi_sad_tpu/ops/experimental/pallas_lstm.py:212",
         "launches": totals["b2_bwd"], "calls": totals["b2"], "max_abs_err": b2_max_err, "ms": b2["ms"],
         "plain_ms": b2["plain_ms"], "bound_ms": b2["bound_ms"], "bound_by": b2["bound_by"],
         "library_ms": b2["library_ms"], "shape": "T=80 B=128 H=512 L=2, forward + backward",
         "tensor_cores": tensor_cores["lstm_bwd_f32"], "step_us": timing["persistent_step_us"]["B2_bwd_f32"],
         "split_ms": timing["B2_split_ms"]["f32"]},
        {"name": "sample_batch (B3)", "route": "cuda",
         "source": "hanabi_sad_tpu_torch/ops/csrc/sample_batch.cu",
         "replaces": "hanabi_sad_tpu/ops/experimental/pallas_replay.py:68",
         "launches": totals["b3"], "max_abs_err": max(b3_errors), "ms": b3t["ms"], "plain_ms": b3t["plain_ms"],
         "ms_unflushed": b3t["ms_unflushed"], "plain_ms_unflushed": b3t["plain_ms_unflushed"],
         "call_ms": b3t["call_ms"],
         "bound_ms": b3t["bound_ms"], "bound_by": b3t["bound_by"], "library_ms": None,
         "shape": "64 of 65,536 episodes x [80, 2, 110] bytes -> Batch [80, 64, 2, 838 + 21 + 15]",
         "iql_launches": iql_totals["b3"], "iql_shape": iql_shape},
        {"name": "lstm_seq bf16 (B1)", "route": "cuda", "source": "hanabi_sad_tpu_torch/ops/csrc/lstm_bf16.cu",
         "replaces": "hanabi_sad_tpu/ops/experimental/pallas_lstm.py:166",
         "launches": bf16_totals["b1_bf16"], "max_abs_err": max(v for k, v in bf16_errors.items() if k != "learner"),
         "learner_step_gap_to_f64": {k: bworst[f"step.{k}.B1"] for k in ("act", "h", "c")},
         "ms": b1b["ms"], "plain_ms": b1b["plain_ms"], "bound_ms": b1b["bound_ms"], "bound_by": b1b["bound_by"],
         "library_ms": b1b["library_ms"], "f32_kernel_ms": b1b["f32_kernel_ms"], "shape": "T=80 B=128 H=512 L=2",
         "tensor_cores": tensor_cores["lstm_gates_bf16"] and tensor_cores["lstm_recurrence_bf16"],
         "step_us": timing["persistent_step_us"]["B1_bf16"],
         "rollout_shape": timing["B1_bf16_rollout"], "rollout_3p_shape": timing["B1_bf16_rollout_3p"]},
        {"name": "lstm_seq_diff bf16 (B2)", "route": "cuda",
         "source": "hanabi_sad_tpu_torch/ops/csrc/lstm_bf16.cu",
         "replaces": "hanabi_sad_tpu/ops/experimental/pallas_lstm.py:212",
         "launches": bf16_totals["b2_bwd_bf16"], "calls": bf16_totals["b2"], "max_abs_err": b2_bf16_max_err,
         "ms": b2b["ms"], "plain_ms": b2b["plain_ms"], "bound_ms": b2b["bound_ms"], "bound_by": b2b["bound_by"],
         "library_ms": b2b["library_ms"], "f32_kernel_ms": b2b["f32_kernel_ms"],
         "shape": "T=80 B=128 H=512 L=2, forward + backward",
         "tensor_cores": tensor_cores["lstm_bwd_bf16"],
         "step_us": timing["persistent_step_us"]["B2_bwd_bf16"], "split_ms": timing["B2_split_ms"]["bf16"]},
    ], "train_chunk_wall_s": train_walls, "train_bf16_chunk_wall_s": bf16_walls,
        "train_iql_chunk_wall_s": iql_walls, "iql_launches": iql_totals, "eval_iql_3p_launches": eval3_counts})
    print(f"# total seconds: {time.time() - t_all:.1f}", flush=True)
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
    faulthandler.cancel_dump_traceback_later()
