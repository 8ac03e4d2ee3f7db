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
     train_op    Other-Play as the shipped OP runs trained it (preset
              sad_aux_op_2p, bfloat16, initial priorities from the rollout's
              online Q, so the collect steps one net), warm-started from
              docs/runs/zoo/auxop_b_r5.pkl at full width: one collect-only
              chunk, 3 train chunks within OP_BANDS, one sgd_update kernels
              vs plain (SGD_REL_TOL_BF16);
     priority    one float32 collect of the flagship trainer; the exact
              priorities of its episodes through one B1 call over [80,
              4096 x 2] rows against the fused ones (PRIORITY_RTOL); B1 at
              that shape against float64 (the float32 rule, BF16_RULES (a)
              and (b)) and timed beside its plain version, cuDNN and its
              bound, in float32 and bf16;
     crossplay   docs/runs/zoo/auxop_b_r5.pkl x auxop_c_r5.pkl, 1000 games a
              cell, within XP_SEMS SEMs of docs/runs/xp_op_r5d.txt; their
              relabel drops within OP_DROP_BAND; the flagship's relabel
              drop within RELABEL_SEMS paired SEMs of the JAX package's;
     train_aligned  the flagship trainer (float32) in rollout_mode aligned,
              warm-started: one collect chunk (1024 episodes, the online net
              alone a step, then the initial priorities' target forward
              through B1 at [80, 2048]), its priorities through the kernels
              against the plain versions (PRIORITY_RTOL); B1 at [80, 2048]
              against float64 (the float32 rule) and timed beside its plain
              version, cuDNN and its bound; 2 train chunks within
              ALIGNED_BANDS; one sgd_update kernels vs plain (SGD_REL_TOL);
     train_knobs  the bf16 flagship (continuous) with snapshot_sampling and
              stacked_td on, warm-started: one collect chunk, 2 train chunks
              within BANDS, each with its 16 B3 launches; from one cloned
              state, a chunk of one update with the snapshot on and off gives
              the same bits (params, replay weights, loss) (stacked_td runs
              the learner's two forwards as without it: the same numbers);
     obl         OBL's public-LSTM net at its published widths, random weights
              from a seeded CPU generator written as a released checkpoint and
              loaded through loaders.load_obl_model: 1000 games through B1
              and through the plain LSTM on the same decks, at least
              OBL_AGREE of them with the same action sequence; its sequence
              forward at [80, 128] (q and o, and its LSTM's outputs) no
              further from float64 than F64_FACTOR times the plain version
              over F64_SEEDS inputs;
     action_matrix  docs/runs/iql_2p_r1_model.pkl, 1000 games through
              tools/action_matrix.py, each entry of its well-filled rows
              within a band of the JAX package's CPU matrix
              (JAX_IQL_2P_COUNTS), P(R1 | P4) beside JAX's and BENCHMARKS.md's;
     convert     the flagship through tools/convert_model.py --pthw: the .pthw
              reloads to the checkpoint's params bit for bit; the .sparta
              module on the card within SPARTA_TOL of r2d2_net.act through B1
              (a, h0, c0) on every act of a 1000-game eval;
     bench_train  tools/bench_train.py at its defaults in bfloat16, 3 timed
              chunks: its line, finite rates, and launches of B1, B2 and B3;
     multigpu    data-parallel training (parallel/mesh.py) on 2 ranks sharing
              the card over gloo, each rank a process of this script
              (--multigpu_rank): the float32 flagship warm-started at 1024
              global envs, one collect and one train chunk of 16 updates,
              against 1 rank: equal chunk stats, the same ring bits and index
              rows, the first update within MULTIGPU_FIRST_RTOL and the
              chunk's means within MULTIGPU_CHUNK_RTOL; the 1000-game eval on
              2 ranks against 1 rank; 2 bf16 ranks, 2 chunks within BANDS;
              each rank's launches of B1, B2 and B3, the gradient
              all-reduce's ms and the walls; then B1 and B2 at a rank's
              learner shape B1_RANK against float64 and timed beside their
              plain versions, cuDNN and the bound, in float32 and bf16;
     multigpu_cli  torchrun --standalone --nproc_per_node 1 of the trainer
              with --multihost 1 (nccl) for one short epoch: exit 0, nccl,
              an eval line and latest.pkl;
     learn       the bf16 flagship from scratch through the trainer's entry
              point with scripts/torch_learning_curve.py's flag line at seed
              LEARN_SEED, 3 epochs (2976 updates) after a burn-in from an
              empty replay at the shipped 10,000 frames: that script's gates
              (the epoch-2 eval in [1.5, 4.0], aux1's epoch mean down by
              0.04 from epoch 0, finite metrics); the target params hold the
              bits of the sync at update 0 after the first chunk and after
              the chunk that ends at update 2496, and the chunk that holds
              update 2500 changes them to the online params of update 2500;
              every train chunk's launches of B1 bf16, B2 bf16 and B3, and
              each epoch's;
  7. kernels  one {"kernels": [...]} line for B1 and B2 in float32 and in
              bfloat16 (with whether their SASS uses the tensor cores, their
              per-step µs, B2's split and B1 at the exact-priority and the
              aligned-priority shapes, and at a rank's learner shape), and B3,
              with the launches of the later phases (per rank for multigpu,
              over the 3 epochs for learn);
              every number on it is measured by this run but the bound,
              which it computes.
The line before the last is the card's name and power limit as nvidia-smi
prints them; the last line is {"ok": true, "device": {...}}.

Without a CUDA card, or without the port beside it, it exits nonzero and
prints no result. It imports nothing of JAX or of the JAX package.
"""

import faulthandler

faulthandler.dump_traceback_later(900, exit=True)

import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
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
# Other-Play (phase train_op): the sad_aux_op_2p preset warm-started from
# OP_B with docs/runs/zoo/auxop_b_train.log's flags beyond the preset's
# (bfloat16 compute, initial priorities from the rollout's online Q); gamma
# 0.999, priority exponent 0.9 and weight 0.6, grad clip 5, Adam eps 1.5e-5
# and base eps 0.1 are the preset's own. OP_BANDS are set wide around:
#  * the JAX package on the CPU (scripts/jax_warmstart_reference.py --preset
#    sad_aux_op_2p --weights docs/runs/zoo/auxop_b_r5.pkl --set
#    continuous_exact_priority=False --set compute_dtype=bfloat16, 1024 envs,
#    seeds 9-11, the first 3 train chunks after one collect chunk): loss
#    6.45-7.12, rl_loss 0.17-0.28, aux1 0.438-0.456, grad_norm 15-64,
#    chunk_score 22.70-23.35, chunk_len 67.66-68.09;
#  * docs/runs/zoo/auxop_b_train.log, epochs 158-160 (the leg before the
#    checkpoint's): loss 10.87-10.99, rl_loss 0.22, aux1 0.549-0.552,
#    grad_norm 32.9-36.2, chunk_score 20.03-20.10, chunk_len 67.80-67.83.
OP_B, OP_C = "docs/runs/zoo/auxop_b_r5.pkl", "docs/runs/zoo/auxop_c_r5.pkl"
OP_FLAGS = {"compute_dtype": "bfloat16", "continuous_exact_priority": False}
OP_BANDS = {
    "loss": (4.0, 14.0),
    "rl_loss": (0.05, 0.6),
    "aux1": (0.3, 0.65),
    "grad_norm": (3.0, 200.0),
    "chunk_score": (19.0, 24.5),
    "chunk_len": (62.0, 74.0),
}
# Phase priority: the exact priorities' target forward, one B1 call over
# 4096 slots x 2 seats of 80 steps, against the fused ones over the same
# episodes (float32 sums in another order); B1 at that shape against float64
# (the float32 rule, and BF16_RULES (a) and (b)) over F64_SEEDS_WIDE inputs.
B1_PRIORITY = (80, 8192)
PRIORITY_RTOL = 1e-4
F64_SEEDS_WIDE = 2
# Phase crossplay, through tools/crossplay_matrix.py. docs/runs/xp_op_r5d.txt:
# the 2x2 of OP_B and OP_C, 1000 games a cell, cell (i, j) dealt from seed
# 1 + 2 i + j; each port cell lies within XP_SEMS of its own SEMs of it. The
# relabel table (seed 1 + 7777 + i, plain and relabelled self-play on the
# same decks): each OP model's drop
# within OP_DROP_BAND of 0 (the JAX package gave -0.01 and -0.07). The
# flagship (plain SAD-AUX, not OP) must drop: the JAX package's CPU run of
# `python -m hanabi_sad_tpu.tools.crossplay_matrix --weights
# docs/runs/sad_aux_r4_soup10.pkl --num_game 1000 --seed 1 --relabel` gave
# self-play 24.00, relabelled 23.01, drop 1.00; the port's drop lies within
# RELABEL_SEMS paired SEMs of it.
XP_OP_R5D = [[23.56, 22.15], [22.11, 23.72]]
XP_SEMS = 4.0
JAX_OP_RELABEL_DROPS = [-0.01, -0.07]
OP_DROP_BAND = 0.3
JAX_FLAGSHIP_RELABEL_DROP = 1.00
RELABEL_SEMS = 4.0
# Phase train_aligned: the aligned initial priorities' target forward, one
# B1 call over 1024 episodes x 2 seats of 80 steps, checked by the float32
# rule over F64_SEEDS_WIDE inputs. ALIGNED_BANDS are BANDS' widths around
# the JAX package on the CPU (scripts/jax_warmstart_reference.py --set
# rollout_mode=aligned, 1024 envs, seeds 9-11, the 2 train chunks after one
# collect chunk): loss 4.99-5.52, rl_loss 0.17-0.24, aux1 0.389-0.399,
# grad_norm 14.5-29.2, chunk_score 23.39-23.75, chunk_len 67.82-68.12; the
# collect chunks 23.54-23.74 and 67.90-67.98.
B1_ALIGNED = (80, 2048)
ALIGNED_BANDS = {
    "loss": (3.5, 8.0),
    "rl_loss": (0.05, 0.5),
    "aux1": (0.3, 0.5),
    "grad_norm": (3.0, 150.0),
    "chunk_score": (22.5, 24.5),
    "chunk_len": (62.0, 74.0),
}
# Phase obl: OBL's public-LSTM net at its published widths (658 / 533 / 512,
# 2 LSTM layers, 21 actions), random weights drawn from a CPU generator seeded
# OBL_SEED, saved as a released checkpoint (with OBL's extra heads) and loaded
# through loaders.load_obl_model; 1000 games through B1 and through the plain
# LSTM on the same decks, at least OBL_AGREE of them with the same action
# sequence (random weights score near 0, so equal scores alone would say
# little); its sequence forward at [80, 128] by the float32 rule over
# F64_SEEDS inputs.
OBL_SEED = 12
OBL_AGREE = 0.99
# Phase action_matrix: docs/runs/iql_2p_r1_model.pkl, 1000 games, seed 1,
# through tools/action_matrix.py. The reference is the JAX package's CPU run
# of the same (python -m hanabi_sad_tpu.tools.action_matrix --weight
# docs/runs/iql_2p_r1_model.pkl --num_game 1000 --seed 1 --out m.txt; score
# 18.265): its transition counts, row = previous action, column = next, in
# IDX2ACTION order (m.txt.npy, the 20 real actions). The decks differ, so
# the matrices are compared by distribution: in every row with at least
# AM_MIN_ROW transitions in both, each entry lies within AM_SIGMAS
# standard errors of a difference of two proportions (pooled p) plus
# AM_SLACK of JAX's. BENCHMARKS.md quotes P(R1 | P4) = 0.34 for this
# checkpoint; the JAX run gives 404 / 1170 = 0.3453.
IQL_2P = "docs/runs/iql_2p_r1_model.pkl"
JAX_IQL_2P_COUNTS = [
    [1023, 105, 404, 802, 172, 43, 8, 18, 2, 0, 9, 113, 21, 10, 111, 759, 1058, 712, 606, 611],
    [129, 95, 2, 185, 56, 3, 0, 0, 0, 0, 3, 11, 8, 3, 20, 74, 168, 88, 26, 15],
    [435, 2, 1069, 159, 66, 85, 3, 12, 1, 0, 10, 94, 20, 13, 74, 44, 101, 484, 719, 590],
    [504, 85, 156, 2306, 129, 133, 2, 1, 0, 0, 9, 336, 10, 48, 293, 677, 1031, 1111, 614, 639],
    [264, 78, 19, 253, 419, 11, 1, 7, 0, 0, 37, 26, 47, 20, 56, 93, 186, 175, 58, 22],
    [439, 44, 623, 400, 195, 104, 17, 21, 30, 36, 1, 12, 16, 0, 44, 339, 396, 477, 427, 410],
    [226, 54, 19, 110, 74, 22, 7, 9, 17, 12, 1, 5, 1, 0, 10, 278, 304, 315, 22, 61],
    [270, 24, 156, 310, 119, 34, 10, 12, 0, 13, 0, 4, 5, 0, 6, 65, 116, 130, 214, 98],
    [118, 29, 3, 59, 27, 32, 22, 2, 49, 57, 1, 1, 1, 1, 27, 404, 168, 144, 3, 22],
    [1213, 166, 841, 1497, 468, 191, 23, 85, 36, 60, 3, 102, 16, 1, 218, 903, 1456, 1469, 956, 1127],
    [4, 0, 7, 9, 27, 1, 2, 1, 0, 1, 1, 0, 2, 0, 6, 2, 1, 2, 0, 0],
    [143, 5, 90, 404, 15, 2, 1, 2, 0, 2, 0, 7, 1, 0, 10, 0, 11, 5, 14, 8],
    [33, 12, 10, 13, 44, 1, 4, 1, 0, 4, 5, 1, 15, 5, 4, 3, 3, 2, 2, 3],
    [6, 0, 14, 55, 11, 0, 0, 0, 0, 0, 0, 1, 2, 6, 9, 1, 1, 1, 3, 0],
    [149, 11, 82, 409, 74, 7, 3, 0, 1, 0, 2, 5, 2, 4, 62, 23, 26, 39, 32, 8],
    [103, 2, 16, 1, 16, 530, 673, 0, 650, 2916, 0, 1, 0, 0, 0, 387, 5, 0, 0, 1],
    [204, 50, 24, 3, 23, 815, 729, 0, 390, 2975, 0, 0, 0, 0, 1, 99, 48, 5, 2, 0],
    [645, 99, 34, 21, 114, 248, 7, 1263, 3, 2545, 0, 4, 1, 3, 2, 262, 176, 102, 6, 4],
    [145, 25, 72, 51, 34, 1259, 13, 88, 0, 2012, 0, 7, 6, 2, 8, 1, 17, 42, 32, 11],
    [549, 22, 344, 1055, 62, 649, 70, 167, 0, 340, 0, 2, 1, 0, 4, 23, 107, 133, 91, 71],
]
AM_MIN_ROW = 200
AM_SIGMAS = 5.0
AM_SLACK = 0.01
BENCHMARKS_R1_GIVEN_P4 = 0.34
# Phase convert: the flagship through tools/convert_model.py; the .sparta
# module (cuDNN's nn.LSTM, TF32 off) against r2d2_net.act through B1 on the
# observations and hidden states of a 1000-game eval, a, h0 and c0.
SPARTA_TOL = 1e-4
# Phase multigpu: the flagship trainer on W = 2 ranks sharing the card (one
# process each, gloo: nccl refuses two ranks on one device) against 1 rank,
# each run in processes of its own with a timeout. Gates of the float32 run:
# equal collect stats, the same bits in the ring's filled rows, the same 16
# index rows, the first update's loss and grad_norm within MULTIGPU_FIRST_RTOL
# (float32 sums of two halves against one), the chunk's update means within
# MULTIGPU_CHUNK_RTOL (the JAX package's own tolerance for the same check,
# tests/test_sharding.py:117); the 1000-game eval's scores equal, or else at
# least MULTIGPU_EVAL_AGREE of its games with the same actions. A rank's
# learner shape is B1_RANK.
MULTIGPU_WORLD = 2
MULTIGPU_RANK_TIMEOUT_S = 240
MULTIGPU_FIRST_RTOL = 1e-5
MULTIGPU_CHUNK_RTOL = 2e-4
MULTIGPU_EVAL_AGREE = 0.99
B1_RANK = (80, 64)
MULTIGPU_CLI_TIMEOUT_S = 240
# Phase learn: the bf16 flagship from scratch through the trainer's entry
# point with scripts/torch_learning_curve.py's flag line, LEARN_EPOCHS
# epochs of 992 updates, held to that script's gates (its epoch-2 eval, the
# fall of aux1 from epoch 0, finite metrics). The target params must hold
# the bits of the sync at update 0 after the first chunk and after the chunk
# that ends at update 2496, and the chunk that holds update 2500
# (num_update_between_sync) must change them to the online params of update
# 2500, which they keep to the end.
LEARN_EPOCHS = 3
# The phase's seed. The learning-curve script's seed 31 (the JAX flagship
# run's) draws other initial weights in the port (torch's generator, not
# threefry), and from them the port takes off 2-3 epochs later: its epoch-2
# eval is 0.911 in bf16, 0.970 in float32 and 1.456 through the plain
# versions, where seeds 32, 33 and 34 score 2.825, 2.170 and 2.188 (bf16;
# PERF.md section 6). The phase holds the path to the gates on seed 32, the
# first seed after 31.
LEARN_SEED = 32
LEARNING_CURVE = "scripts/torch_learning_curve.py"
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


def multigpu_rank(argv):
    """One rank of phase multigpu, in a process of its own (`python3
    chip_smoke.py --multigpu_rank R --world W --init file://... --out DIR
    --dtype float32|bfloat16 --chunks C --eval_games G`): the flagship
    trainer warm-started from FLAGSHIP at full width (1024 global envs) on
    cuda:0, W ranks over gloo; one collect chunk, C train chunks of 16
    updates, then G eval games of FLAGSHIP at seed 1 over the ranks. Writes
    DIR/rank{R}.json (chunk stats, hashes of the ring's filled rows, every
    update's sampled index row, loss and grad_norm, the chunk means, launches,
    walls, the gradient all-reduce's ms) and DIR/rank{R}.npz (the final
    params, the eval's scores and actions)."""
    import argparse
    import hashlib

    import numpy as np
    import torch

    parser = argparse.ArgumentParser()
    for flag, kind in (("--multigpu_rank", int), ("--world", int), ("--init", str), ("--out", str),
                       ("--dtype", str), ("--chunks", int), ("--eval_games", int)):
        parser.add_argument(flag, type=kind, required=True)
    args = parser.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from hanabi_sad_tpu_torch import parallel
    from hanabi_sad_tpu_torch.ops.lstm_seq import LstmSeqDiff, lstm_bwd_kernel, lstm_seq_kernel
    from hanabi_sad_tpu_torch.ops.sample_batch import sample_batch_kernel
    from hanabi_sad_tpu_torch.replay import prioritized as replay_mod
    from hanabi_sad_tpu_torch.tools import loaders
    from hanabi_sad_tpu_torch.train import learner, selfplay
    from hanabi_sad_tpu_torch.train.config import make_config
    from hanabi_sad_tpu_torch.train.evaluate import evaluate
    from hanabi_sad_tpu_torch.train.learner import param_leaves

    dev = torch.device("cuda", 0)
    if args.world > 1:
        mesh = parallel.initialize_multihost(backend="gloo", init_method=args.init, world_size=args.world,
                                             rank=args.multigpu_rank, device=dev)
    else:
        torch.cuda.set_device(dev)
        mesh = parallel.make_mesh(dev)

    def reset_counts():
        lstm_seq_kernel.reset()
        lstm_bwd_kernel.reset()
        sample_batch_kernel.launches = LstmSeqDiff.calls = 0

    def counts():
        return {"b1": lstm_seq_kernel.launches, "b1_bf16": lstm_seq_kernel.launches_by_dtype["bf16"],
                "b2": LstmSeqDiff.calls, "b2_bwd": lstm_bwd_kernel.launches, "b3": sample_batch_kernel.launches}

    cfg = make_config("sad_2p", pred_weight=0.25, burn_in_frames=2048, compute_dtype=args.dtype)
    setup = learner.make_setup(cfg)
    state = selfplay.load_model(FLAGSHIP, learner.init_train_state(setup, setup.train.seed, dev))
    state = parallel.shard_train_state(state, mesh)
    optimizer = learner.make_optimizer(setup.train)
    idx_rows, updates, reduce_ms = [], [], []
    update_priority, sgd_update, sum_over_ranks = replay_mod.update_priority, learner.sgd_update, \
        learner._sum_over_ranks

    def recording_update_priority(replay, rcfg, idx, priority):
        idx_rows.append(idx.tolist())
        return update_priority(replay, rcfg, idx, priority)

    def recording_sgd_update(*a, **k):
        new_state, metrics = sgd_update(*a, **k)
        updates.append({"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"])})
        return new_state, metrics

    def timed_sum_over_ranks(*a, **k):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = sum_over_ranks(*a, **k)
        torch.cuda.synchronize(dev)
        reduce_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    replay_mod.update_priority, learner.sgd_update = recording_update_priority, recording_sgd_update
    learner._sum_over_ranks = timed_sum_over_ranks
    out = {"rank": mesh.rank, "world": mesh.world, "dtype": args.dtype,
           "envs_per_rank": cfg.num_envs // mesh.world, "batch_per_rank": setup.train.batchsize // mesh.world}
    reset_counts()
    torch.cuda.synchronize(dev)
    t0 = time.time()
    state, stats = learner.collect_only(setup, state)
    torch.cuda.synchronize(dev)
    out.update(collect={k: float(v) for k, v in stats.items()}, collect_wall_s=time.time() - t0,
               collect_launches=counts())
    size = int(state.replay.size)
    out["ring"] = {"size": size, "packed_sha256": hashlib.sha256(state.replay.packed[:size].cpu().numpy()
                                                                 .tobytes()).hexdigest(),
                   "action_sha256": hashlib.sha256(state.replay.action[:size].cpu().numpy().tobytes()).hexdigest()}
    out["chunks"] = []
    for _ in range(args.chunks):
        reset_counts()
        torch.cuda.synchronize(dev)
        t0 = time.time()
        state, metrics = learner.train_chunk(setup, optimizer, state)
        torch.cuda.synchronize(dev)
        out["chunks"].append({"metrics": {k: float(v) for k, v in metrics.items()}, "wall_s": time.time() - t0,
                              "launches": counts()})
    replay_mod.update_priority, learner.sgd_update = update_priority, sgd_update
    learner._sum_over_ranks = sum_over_ranks
    out.update(idx_rows=idx_rows, updates=updates, reduce_ms=reduce_ms)
    arrays = {f"param{i}": t.detach().cpu().numpy() for i, t in enumerate(param_leaves(state.params.online))}
    del state
    if args.eval_games:
        policy = loaders.load_any(FLAGSHIP, device=dev)
        reset_counts()
        torch.cuda.synchronize(dev)
        t0 = time.time()
        mean, _, scores, _, actions, was_done = evaluate(
            [policy, policy], args.eval_games, 1, num_steps=128, return_actions=True, device=dev, mesh=mesh)
        out["eval"] = {"mean": mean, "wall_s": time.time() - t0, "launches": counts()}
        arrays.update(scores=np.asarray(scores), actions=actions, was_done=was_done)
    parallel.barrier(mesh)
    if args.world > 1:
        torch.distributed.destroy_process_group()
    np.savez(os.path.join(args.out, f"rank{mesh.rank}.npz"), **arrays)
    with open(os.path.join(args.out, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(out, f)


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
    import numpy as np
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
    from hanabi_sad_tpu_torch.models import public_lstm, r2d2_net
    from hanabi_sad_tpu_torch.ops import build
    from hanabi_sad_tpu_torch.ops import sample_batch as sb
    from hanabi_sad_tpu_torch.ops.lstm_seq import (
        LstmSeqDiff, lstm_bwd_kernel, lstm_bwd_recurrence_plain, lstm_seq_diff, lstm_seq_kernel, lstm_seq_plain)
    from hanabi_sad_tpu_torch.replay import prioritized as replay_mod
    from hanabi_sad_tpu_torch.rollout import continuous, runner
    from hanabi_sad_tpu_torch.tools import action_matrix, bench_train, convert_model, crossplay_matrix, loaders
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
        s_k, m_k = learner.sgd_update(setup, optimizer, copy_of(st), presampled=(is_w, idx))
        kernel_sample_batch = sb.sample_batch
        lstm_mod.lstm_seq, sb.sample_batch = lstm_seq_plain, sb.sample_batch_plain
        try:
            before = counts()
            s_p, m_p = learner.sgd_update(setup, optimizer, copy_of(st), presampled=(is_w, idx))
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
        return (is_w, idx), m_k, gaps

    (is_w, idx), m_k, gaps = kernels_vs_plain(setup, optimizer, state, seed=4)
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
    # The payload holds no replay, so the restored state is given a copy of
    # the saved state's ring to read the batch from.
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
    s_a, m_a = learner.sgd_update(setup, optimizer, copy_state(), presampled=(is_w, idx))
    s_b, m_b = learner.sgd_update(setup, optimizer, restored._replace(replay=copy_state().replay),
                                  presampled=(is_w, idx))
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
    del restored, s_a, s_b, state
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

    # 6e. train op: Other-Play as the shipped run trained it, warm-started
    # from OP_B at full width; burn-in cut to one collect chunk, 3 train
    # chunks in OP_BANDS, one sgd_update kernels vs plain. Without the
    # target stream the collect steps one net: T x L launches of B1 bf16.
    cfg = make_config("sad_aux_op_2p", burn_in_frames=2048, **OP_FLAGS)
    setup = learner.make_setup(cfg)
    state = selfplay.load_model(OP_B, learner.init_train_state(setup, setup.train.seed, dev))
    optimizer = learner.make_optimizer(setup.train)
    op_cfg = {k: getattr(setup.train, k) for k in (
        "shuffle_color", "sad", "pred_weight", "compute_dtype", "continuous_exact_priority", "gamma",
        "priority_exponent", "priority_weight", "grad_clip", "adam_eps", "act_base_eps", "burn_in_frames")}
    emit({"phase": "train_op", "checkpoint": OP_B, "config": {"preset": "sad_aux_op_2p", **op_cfg, **shape},
          "actor_target_stream": state.actor.target_hidden is not None, "bands": OP_BANDS})
    if state.actor.target_hidden is not None:
        fail("train_op: the actor carries a target stream with continuous_exact_priority off")
    op_collect = dict(expect_collect, b1=T * L, b1_gates=T * L, b1_bf16=T * L)
    op_train = dict(expect_train, b1=T * L + U * 4 * L, b1_gates=T * L + U * 2 * L, b1_bf16=T * L + U * 4 * L,
                    b2_bwd_bf16=U * L)
    state = collect_phase("train_op", setup, state, op_collect)
    state, op_totals, op_walls = train_phase("train_op", setup, state, optimizer, 3, op_train, OP_BANDS)
    _, m_k, gaps = kernels_vs_plain(setup, optimizer, state, seed=8)
    emit({"phase": "train_op", "check": "sgd_update kernels vs plain", "loss": float(m_k["loss"]),
          "grad_norm": float(m_k["grad_norm"]), "rel_gap": gaps, "rel_tol": SGD_REL_TOL_BF16,
          "launches_in_3_chunks": op_totals})
    bad = {k: v for k, v in gaps.items() if not v <= SGD_REL_TOL_BF16[k]}
    if bad:
        fail(f"OP sgd_update through the kernels differs from the plain versions: {bad}")
    del state
    torch.cuda.empty_cache()

    # 6f. priority: one float32 collect of the flagship trainer (its actor
    # records the target Q stream), then the exact priorities of the same
    # episodes through one B1 call over [80, 4096 x 2] rows, against the
    # fused ones; then B1 at that shape against float64, and timed.
    cfg = make_config("sad_2p", pred_weight=0.25, burn_in_frames=2048)
    setup = learner.make_setup(cfg)
    state = selfplay.load_model(FLAGSHIP, learner.init_train_state(setup, setup.train.seed, dev))
    actor, stream = continuous.run_continuous_chunk(state.params, setup.agent, setup.env, state.actor,
                                                    setup.train.max_len, generator=state.env_gen)
    actor, episodes = continuous.assemble_episodes(actor, stream, setup.train.slots_per_env)
    n_step_r, bootstrap, _ = continuous.episode_priorities(episodes, setup.agent)
    fused = continuous.fused_exact_priorities(episodes, setup.agent, n_step_r, bootstrap)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    exact = continuous.exact_episode_priorities(state.params, setup.agent, setup.replay, episodes, n_step_r,
                                                bootstrap)
    torch.cuda.synchronize()
    exact_wall = time.time() - t0
    prio_counts = counts()
    valid = episodes.valid
    f_v, e_v = fused[valid].double(), exact[valid].double()
    prio_rel = float(((f_v - e_v).abs() / e_v.abs().clamp(min=1e-6)).max())
    prio_ok = bool(((f_v - e_v).abs() <= PRIORITY_RTOL * e_v.abs() + 1e-6).all())
    expect_prio = dict.fromkeys(expect_collect, 0)
    expect_prio.update(b1=2 * L, b1_gates=L, b1_recurrence=L)
    emit({"phase": "priority", "slots": int(valid.numel()), "valid_slots": int(valid.sum()),
          "rows": int(valid.numel()) * setup.replay.num_player, "T": setup.train.max_len,
          "max_rel_gap_fused_vs_exact": prio_rel, "rtol": PRIORITY_RTOL, "agree": prio_ok,
          "exact_wall_s": exact_wall, "launches": prio_counts, "card": smi_line})
    if not prio_ok:
        fail(f"fused and exact priorities disagree: largest relative gap {prio_rel} > {PRIORITY_RTOL}")
    if prio_counts != expect_prio:
        fail(f"exact priorities launches {prio_counts}, expected {expect_prio}")
    del state, actor, stream, episodes, fused, exact, n_step_r, bootstrap
    torch.cuda.empty_cache()

    T, B = B1_PRIORITY
    pworst = {"B1": 0.0, "plain": 0.0}
    bworst_p = {}
    for seed in range(F64_SEEDS_WIDE):
        g = torch.Generator().manual_seed(seed)
        r = lambda *shape, scale=1.0: (scale * torch.randn(*shape, generator=g)).to(dev)
        xs, h0, c0 = r(T, B, H), r(L, B, H, scale=0.5), r(L, B, H, scale=0.5)
        with torch.no_grad():
            ref = flat3(lstm_seq_plain([{k: v.double() for k, v in p.items()} for p in lstm_params], xs.double(),
                                       (h0.double(), c0.double())))
            for who, ys in (("B1", flat3(lstm_seq_kernel(lstm_params, xs, (h0, c0)))),
                            ("plain", flat3(lstm_seq_plain(lstm_params, xs, (h0, c0))))):
                pworst[who] = max(pworst[who], max(largest_gap(y, r64) for y, r64 in zip(ys, ref)))
            del ref
            xb, hb, cb = xs.bfloat16(), h0.bfloat16(), c0.bfloat16()
            del xs
            # (a) outputs against float64 without the roundings of h and c
            ref = flat3(lstm_seq_plain([{k: v.double() for k, v in p.items()} for p in pb], xb.double(),
                                       (hb.double(), cb.double())))
            b1_k = lstm_seq_kernel(pb, xb, (hb, cb), save=True)
            for who, ys in (("B1", flat3(b1_k[:2])), ("plain", flat3(lstm_seq_plain(pb, xb, (hb, cb))))):
                bworst_p[f"out.{who}"] = max(bworst_p.get(f"out.{who}", 0.0),
                                             max(largest_gap(y, r64) for y, r64 in zip(ys, ref)))
            del ref
            # (b) each step from its own stored previous state, over row blocks
            b1_p = lstm_seq_plain(pb, xb, (hb, cb), save=True)
            rows = 1024
            for r0 in range(0, B, rows):
                sl = lambda saved: saved._replace(**{f: [t[:, r0:r0 + rows] for t in getattr(saved, f)]
                                                     for f in ("act", "hseq", "cseq")})
                hid = (hb[:, r0:r0 + rows], cb[:, r0:r0 + rows])
                for who, saved in (("B1", b1_k[2]), ("plain", b1_p[2])):
                    for k, v in step_gaps(torch, pb, xb[:, r0:r0 + rows], hid, sl(saved)).items():
                        bworst_p[f"step.{k}.{who}"] = max(bworst_p.get(f"step.{k}.{who}", 0.0), v)
            del b1_k, b1_p, xb
        torch.cuda.synchronize()
    p_ratio = {"f32.B1": pworst["B1"] / pworst["plain"], "bf16.out.B1": bworst_p["out.B1"] / bworst_p["out.plain"]}
    for part in ("act", "h", "c"):
        p_ratio[f"bf16.step.{part}.B1"] = bworst_p[f"step.{part}.B1"] / max(bworst_p[f"step.{part}.plain"], 1e-30)
    emit({"phase": "priority", "check": "B1 at the exact-priority shape", "T": T, "B": B, "H": H, "L": L,
          "seeds": F64_SEEDS_WIDE, "largest_gap_to_f64": {"f32": pworst, "bf16": bworst_p}, "ratio_to_plain": p_ratio,
          "factor": F64_FACTOR})
    bad = {k: v for k, v in p_ratio.items() if not v <= F64_FACTOR}
    if bad:
        fail(f"B1 at [{T}, {B}]: further than {F64_FACTOR}x the plain version from float64: {bad}")
    b1_errors["priority"] = pworst["B1"]
    xs, h0, c0 = randn(T, B, H), randn(L, B, H, scale=0.5), randn(L, B, H, scale=0.5)
    xb, hb, cb = xs.bfloat16(), h0.bfloat16(), c0.bfloat16()
    with torch.no_grad():
        for name, params_, args, peak, word in (
                ("B1_priority", lstm_params, (xs, (h0, c0)), H100_F32_FLOPS, 4.0),
                ("B1_bf16_priority", pb, (xb, (hb, cb)), H100_BF16_FLOPS, 2.0)):
            lib = cudnn if params_ is lstm_params else cudnn_bf16
            ms = cuda_ms(torch, lambda: lstm_seq_kernel(params_, *args), iters=5, warmup=1)
            plain_ms = cuda_ms(torch, lambda: lstm_seq_plain(params_, *args), iters=2, warmup=1)
            library_ms = cuda_ms(torch, lambda: lib(*args), iters=3, warmup=1)
            b_ms, b_by = bound(lstm_flops(T, B, H, L), word * lstm_words(T, B, H, L), peak=peak)
            # Device ms of each kernel per call, from the launches the
            # profiler saw (L of each a call), and how many it saw a call.
            parts = kernel_times(torch, lambda: lstm_seq_kernel(params_, *args), iters=2, warmup=1)
            split = {}
            for part in ("gates_kernel", "recurrence_kernel"):
                t, seen = (sum(v[i] for k, v in parts.items() if part in k) for i in (0, 1))
                split[part] = {"ms": t / seen * L if seen else None, "launches_seen_per_call": seen}
            timing[name] = {"T": T, "B": B, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                            "bound_ms": b_ms, "bound_by": b_by, "launches_per_call": 2 * L, "device_ms": split}
    emit({"phase": "priority", "timing": {k: timing[k] for k in ("B1_priority", "B1_bf16_priority")},
          "card": smi_line})
    del xs, h0, c0, xb, hb, cb
    torch.cuda.empty_cache()

    # 6g. crossplay: the OP 2x2 of docs/runs/xp_op_r5d.txt and the relabel
    # table through the port's cross-play tool, on the card; then the
    # flagship's relabel drop (not OP), which shows that the perms act.
    op_policies = [loaders.load_any(w, device=dev) for w in (OP_B, OP_C)]
    op_names = [w.rsplit("/", 1)[-1] for w in (OP_B, OP_C)]
    reset_counts()
    t0 = time.time()
    cells, _, cell_sems = crossplay_matrix.crossplay_matrix(op_policies, num_game, seed, device=dev)
    rseed = seed + crossplay_matrix.RELABEL_SEED_OFFSET
    op_plain, op_relabeled, op_drop_sems = crossplay_matrix.relabel_table(op_policies, num_game, rseed, device=dev)
    xp_wall = time.time() - t0
    xp_counts = counts()
    op_drops = op_plain - op_relabeled
    flag_plain, flag_relabeled, flag_drop_sems = crossplay_matrix.relabel_table([policy], num_game, rseed, device=dev)
    flag_drop = float(flag_plain[0] - flag_relabeled[0])
    xp_text = crossplay_matrix.render(cells, op_names) + "\n\n" + crossplay_matrix.render_relabel(
        op_plain, op_relabeled, op_names)
    for line in xp_text.splitlines():
        print(f"# {line}", flush=True)
    xp_ok = [[bool(abs(cells[i, j] - XP_OP_R5D[i][j]) <= XP_SEMS * cell_sems[i, j]) for j in range(2)]
             for i in range(2)]
    drop_ok = [bool(abs(d) <= OP_DROP_BAND) for d in op_drops]
    flag_ok = bool(abs(flag_drop - JAX_FLAGSHIP_RELABEL_DROP) <= RELABEL_SEMS * flag_drop_sems[0])
    emit({"phase": "crossplay", "checkpoints": [OP_B, OP_C], "num_game": num_game, "seed": seed,
          "cells": cells.tolist(), "sems": cell_sems.tolist(), "reference": XP_OP_R5D, "within_sems": xp_ok,
          "sems_allowed": XP_SEMS,
          "relabel": [{"plain": float(op_plain[i]), "relabeled": float(op_relabeled[i]), "drop": float(op_drops[i]),
                       "paired_sem": float(op_drop_sems[i])} for i in range(2)],
          "jax_relabel_drops": JAX_OP_RELABEL_DROPS, "drop_band": OP_DROP_BAND, "drops_ok": drop_ok,
          "flagship_relabel": {"plain": float(flag_plain[0]), "relabeled": float(flag_relabeled[0]),
                               "drop": flag_drop, "paired_sem": float(flag_drop_sems[0]),
                               "jax_drop": JAX_FLAGSHIP_RELABEL_DROP, "sems_allowed": RELABEL_SEMS, "ok": flag_ok},
          "wall_s": xp_wall, "launches": xp_counts, "card": smi_line})
    if xp_counts["b1"] == 0:
        fail("the cross-play evals did not launch B1")
    if not all(all(row) for row in xp_ok):
        fail(f"OP cross-play cells {cells.tolist()} outside {XP_SEMS} SEMs {cell_sems.tolist()} of {XP_OP_R5D}")
    if not all(drop_ok):
        fail(f"OP relabel drops {op_drops.tolist()} outside +/- {OP_DROP_BAND}")
    if not flag_ok:
        fail(f"flagship relabel drop {flag_drop} not within {RELABEL_SEMS} paired SEMs {flag_drop_sems[0]} "
             f"of the JAX package's {JAX_FLAGSHIP_RELABEL_DROP}")

    # 6h. train aligned: the flagship trainer (float32) in rollout_mode
    # aligned, warm-started, burn-in cut to one collect chunk of 1024
    # episodes. A collect steps the online net alone (T x L launches of B1 at
    # T = 1), then the initial priorities' target forward is one B1 call at
    # [80, 2048] (2 L launches).
    cfg = make_config("sad_2p", pred_weight=0.25, burn_in_frames=2048, rollout_mode="aligned")
    setup = learner.make_setup(cfg)
    state = selfplay.load_model(FLAGSHIP, learner.init_train_state(setup, setup.train.seed, dev))
    optimizer = learner.make_optimizer(setup.train)
    emit({"phase": "train_aligned", "config": {"preset": "sad_2p", "pred_weight": 0.25, "rollout_mode": "aligned",
                                               "burn_in_frames": 2048, **shape},
          "actor": state.actor is not None, "bands": ALIGNED_BANDS})
    if state.actor is not None:
        fail("train_aligned: an aligned train state carries a continuous actor")
    prio_launches = dict.fromkeys(expect_collect, 0)
    prio_launches.update(b1=2 * L, b1_gates=L, b1_recurrence=L)
    steps = setup.train.max_len
    aligned_collect = {k: v + prio_launches[k] for k, v in dict(expect_collect, b1=steps * L, b1_gates=steps * L).items()}
    aligned_train = {k: v - expect_collect[k] + aligned_collect[k] for k, v in expect_train.items()}
    chunks_seen = []
    run_chunk = runner.run_episode_chunk
    runner.run_episode_chunk = lambda *a, **k: chunks_seen.append(run_chunk(*a, **k)) or chunks_seen[-1]
    try:
        state = collect_phase("train_aligned", setup, state, aligned_collect)
    finally:
        runner.run_episode_chunk = run_chunk
    # The collected episodes' initial priorities, through B1 and through the
    # plain LSTM; the replay holds the kernels' priorities^alpha.
    out = chunks_seen.pop()
    episodes = runner.chunk_to_episodes(out, setup.agent)
    batch = runner.episodes_to_batch(episodes)
    online_qa, greedy_a = runner.rollout_priority_inputs(out, setup.agent)
    reset_counts()
    prio_k = r2d2_agent.compute_priority_from_rollout(state.params, setup.agent, batch, online_qa, greedy_a)
    aligned_prio_counts = counts()
    lstm_mod.lstm_seq = lstm_seq_plain
    try:
        prio_p = r2d2_agent.compute_priority_from_rollout(state.params, setup.agent, batch, online_qa, greedy_a)
    finally:
        lstm_mod.lstm_seq = kernel_lstm_seq
    if counts() != aligned_prio_counts:
        fail("train_aligned: the plain priorities launched a kernel")
    M = prio_k.shape[0]
    in_replay = bool(torch.equal(state.replay.weight[:M], prio_k.pow(setup.replay.alpha)))
    pk, pp = prio_k.double(), prio_p.double()
    aligned_rel = float(((pk - pp).abs() / pp.abs().clamp(min=1e-6)).max())
    aligned_ok = bool(((pk - pp).abs() <= PRIORITY_RTOL * pp.abs() + 1e-6).all())
    emit({"phase": "train_aligned", "check": "initial priorities kernels vs plain", "episodes": M,
          "rows": M * setup.replay.num_player, "T": setup.train.max_len, "max_rel_gap": aligned_rel,
          "rtol": PRIORITY_RTOL, "agree": aligned_ok, "replay_holds_them": in_replay,
          "launches": aligned_prio_counts})
    if not aligned_ok:
        fail(f"aligned priorities through the kernels differ from the plain versions: {aligned_rel}")
    if not in_replay:
        fail("the replay's weights are not the collect's priorities^alpha")
    if aligned_prio_counts != prio_launches:
        fail(f"aligned priorities launches {aligned_prio_counts}, expected {prio_launches}")
    del out, episodes, batch, online_qa, greedy_a
    torch.cuda.empty_cache()

    # B1 at [80, 2048] against float64 by the float32 rule, and timed
    T1, B1w = B1_ALIGNED
    aworst = {"B1": 0.0, "plain": 0.0}
    for seed in range(F64_SEEDS_WIDE):
        g = torch.Generator().manual_seed(seed)
        r = lambda *shape, scale=1.0: (scale * torch.randn(*shape, generator=g)).to(dev)
        xs, h0, c0 = r(T1, B1w, H), r(L, B1w, H, scale=0.5), r(L, B1w, H, scale=0.5)
        with torch.no_grad():
            ref = flat3(lstm_seq_plain([{k: v.double() for k, v in p.items()} for p in lstm_params], xs.double(),
                                       (h0.double(), c0.double())))
            for who, ys in (("B1", flat3(lstm_seq_kernel(lstm_params, xs, (h0, c0)))),
                            ("plain", flat3(lstm_seq_plain(lstm_params, xs, (h0, c0))))):
                aworst[who] = max(aworst[who], max(largest_gap(y, r64) for y, r64 in zip(ys, ref)))
            del ref
    a_ratio = aworst["B1"] / aworst["plain"]
    emit({"phase": "train_aligned", "check": "B1 at the aligned-priority shape", "T": T1, "B": B1w, "H": H, "L": L,
          "seeds": F64_SEEDS_WIDE, "largest_gap_to_f64": aworst, "ratio_to_plain": a_ratio, "factor": F64_FACTOR})
    if not a_ratio <= F64_FACTOR:
        fail(f"B1 at [{T1}, {B1w}]: further than {F64_FACTOR}x the plain version from float64: {a_ratio}")
    b1_errors["aligned_priority"] = aworst["B1"]
    with torch.no_grad():
        lib_err = float((cudnn(xs, (h0, c0))[0] - lstm_seq_plain(lstm_params, xs, (h0, c0))[0]).abs().max())
        ms = cuda_ms(torch, lambda: lstm_seq_kernel(lstm_params, xs, (h0, c0)), iters=10, warmup=2)
        plain_ms = cuda_ms(torch, lambda: lstm_seq_plain(lstm_params, xs, (h0, c0)), iters=5, warmup=1)
        library_ms = cuda_ms(torch, lambda: cudnn(xs, (h0, c0)), iters=10, warmup=2)
    b_ms, b_by = bound(lstm_flops(T1, B1w, H, L), 4.0 * lstm_words(T1, B1w, H, L))
    timing["B1_aligned_priority"] = {"T": T1, "B": B1w, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                                     "library_max_abs_err": lib_err, "bound_ms": b_ms, "bound_by": b_by,
                                     "launches_per_call": 2 * L}
    emit({"phase": "train_aligned", "timing": {"B1_aligned_priority": timing["B1_aligned_priority"]},
          "card": smi_line})
    del xs, h0, c0
    torch.cuda.empty_cache()

    state, aligned_totals, aligned_walls = train_phase("train_aligned", setup, state, optimizer, 2, aligned_train,
                                                       ALIGNED_BANDS)
    _, m_k, gaps = kernels_vs_plain(setup, optimizer, state, seed=9)
    emit({"phase": "train_aligned", "check": "sgd_update kernels vs plain", "loss": float(m_k["loss"]),
          "grad_norm": float(m_k["grad_norm"]), "rel_gap": gaps, "rel_tol": SGD_REL_TOL})
    bad = {k: v for k, v in gaps.items() if not v <= SGD_REL_TOL[k]}
    if bad:
        fail(f"aligned sgd_update through the kernels differs from the plain versions: {bad}")
    del state
    torch.cuda.empty_cache()

    # 6i. train knobs: the bf16 flagship (continuous) with snapshot_sampling
    # and stacked_td on, warm-started, burn-in cut to one collect chunk.
    knobs = {"compute_dtype": "bfloat16", "snapshot_sampling": True, "stacked_td": True}
    cfg = make_config("sad_2p", pred_weight=0.25, burn_in_frames=2048, **knobs)
    setup = learner.make_setup(cfg)
    state = selfplay.load_model(FLAGSHIP, learner.init_train_state(setup, setup.train.seed, dev))
    optimizer = learner.make_optimizer(setup.train)
    emit({"phase": "train_knobs", "config": {"preset": "sad_2p", "pred_weight": 0.25, "burn_in_frames": 2048,
                                             **knobs, **shape}, "bands": BANDS})
    bf16_train = dict(expect_train, b1_bf16=expect_train["b1"], b2_bwd_bf16=U * L)
    state = collect_phase("train_knobs", setup, state, dict(expect_collect, b1_bf16=rollout))
    state, knob_totals, knob_walls = train_phase("train_knobs", setup, state, optimizer, 2, bf16_train, BANDS)

    def full_copy(st):
        """copy_of(st) with every replay field and both generators copied."""
        gens = []
        for gen_ in (st.env_gen, st.sample_gen):
            gens.append(torch.Generator(device=dev))
            gens[-1].set_state(gen_.get_state())
        return copy_of(st)._replace(replay=replay_mod.ReplayState(*(t.clone() for t in st.replay)),
                                    env_gen=gens[0], sample_gen=gens[1])

    # From one cloned state, a chunk of one update with the snapshot on and off
    ones = []
    for snap in (True, False):
        one_setup = learner.make_setup(dataclasses.replace(cfg, num_update_per_chunk=1, snapshot_sampling=snap))
        s1, m1 = learner.train_chunk(one_setup, learner.make_optimizer(one_setup.train), full_copy(state))
        ones.append((learner.param_leaves(s1.params.online), s1.replay.weight, m1["loss"]))
        del s1
    same_chunk = {"params": all(torch.equal(a, b) for a, b in zip(ones[0][0], ones[1][0])),
                  "replay_weights": bool(torch.equal(ones[0][1], ones[1][1])),
                  "loss": bool(torch.equal(ones[0][2], ones[1][2]))}
    emit({"phase": "train_knobs", "check": "one-update chunk, snapshot on and off", "same_bits": same_chunk,
          "loss": float(ones[0][2])})
    del ones
    if not all(same_chunk.values()):
        fail(f"a one-update chunk differs with snapshot_sampling on and off: {same_chunk}")

    del state
    torch.cuda.empty_cache()

    # 6j. obl: OBL's public-LSTM net at its published widths, random weights
    # from a seeded CPU generator, written as a released checkpoint with
    # OBL's extra heads and loaded on the card through the loader; 1000 games
    # through B1 and through the plain LSTM on the decks of phase 5.
    obl_cfg = public_lstm.PublicNetConfig()
    obl_sd = public_lstm.to_torch_state_dict(public_lstm.init_public_lstm(
        obl_cfg, generator=torch.Generator().manual_seed(OBL_SEED), device="cpu"))
    g = torch.Generator().manual_seed(OBL_SEED + 1)
    obl_sd.update({k: torch.randn(8, generator=g) for k in public_lstm.OBL_STRIP_KEYS})
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "obl.pthw")
        torch.save(obl_sd, path)
        obl_policy = loaders.load_obl_model(path, device=dev)
    del obl_sd

    def obl_eval():
        torch.cuda.synchronize()
        t0 = time.time()
        out = evaluate([obl_policy] * 2, num_game, seed, num_steps=num_steps, decks=decks, return_actions=True,
                       device=dev)
        return out, time.time() - t0

    reset_counts()
    (mean_ok, _, scores_ok, _, acts_k, done_k), obl_wall_k = obl_eval()
    obl_counts = counts()
    lstm_mod.lstm_seq = lstm_seq_plain
    try:
        (mean_op, _, scores_op, _, acts_p, done_p), obl_wall_p = obl_eval()
    finally:
        lstm_mod.lstm_seq = kernel_lstm_seq
    if counts() != obl_counts:
        fail("obl: the plain eval launched a kernel")
    # a game's action sequence: its applied actions while it was live
    same_game = (np.where(done_k, -1, acts_k) == np.where(done_p, -1, acts_p)).all(0)
    obl_agree = float(same_game.mean())
    obl_steps = int((~done_k).sum())
    emit({"phase": "obl", "config": dataclasses.asdict(obl_cfg), "weights": f"random, seed {OBL_SEED}",
          "num_game": num_game, "seed": seed, "kernel": {"mean": mean_ok, "wall_s": obl_wall_k},
          "plain": {"mean": mean_op, "wall_s": obl_wall_p}, "live_steps": obl_steps,
          "same_action_sequence": obl_agree, "same_score": float(np.mean(np.equal(scores_ok, scores_op))),
          "launches": obl_counts, "card": smi_line})
    if obl_counts["b1"] == 0:
        fail("obl: the eval did not launch B1")
    if obl_agree < OBL_AGREE:
        fail(f"obl: kernel and plain paths play the same actions in only {obl_agree:.4f} of games")

    # OBL's sequence forward at the learner shape by the float32 rule, on its
    # outputs (q, o) and on its LSTM's (outs, hT, cT: the public branch at
    # OBL's inputs; at random weights o is small and its float32 rounding
    # outside the LSTM is the same in both float32 runs)
    T, B = B1_CASES["learner"]
    op32 = obl_policy.params.online
    op64 = public_lstm.PublicLSTMParams(*[
        [{k: v.double() for k, v in d.items()} for d in f] if isinstance(f, list) else {k: v.double() for k, v in f.items()}
        for f in op32])
    lstm_seen = {}

    def recording(fn, who):
        def run(params_, xs, hidden):
            out = fn(params_, xs, hidden)
            lstm_seen[who] = flat3(out)
            return out
        return run

    oworst = {f"{part}.{who}": 0.0 for part in ("out", "lstm") for who in ("B1", "plain")}
    reset_counts()
    with torch.no_grad():
        for s_ in range(F64_SEEDS):
            g = torch.Generator().manual_seed(OBL_SEED + 2 + s_)
            obs = (torch.rand(T, B, 838, generator=g) < 0.2).float().to(dev)
            legal = (torch.rand(T, B, 21, generator=g) < 0.5).float().to(dev)
            legal[..., 20] = 1.0
            act_ = torch.randint(0, 21, (T, B), generator=g).to(dev)
            got = {}
            try:
                for who, fn, p_, x_, lm_ in (("B1", kernel_lstm_seq, op32, obs, legal),
                                             ("plain", lstm_seq_plain, op32, obs, legal),
                                             ("f64", lstm_seq_plain, op64, obs.double(), legal.double())):
                    lstm_mod.lstm_seq = recording(fn, who)
                    got[who] = public_lstm.forward(p_, obl_cfg, *public_lstm.sad_slice(x_), lm_, act_)[2:]
            finally:
                lstm_mod.lstm_seq = kernel_lstm_seq
            for who in ("B1", "plain"):
                for part, ys, refs in (("out", got[who], got["f64"]), ("lstm", lstm_seen[who], lstm_seen["f64"])):
                    oworst[f"{part}.{who}"] = max(oworst[f"{part}.{who}"],
                                                  max(largest_gap(y, r64) for y, r64 in zip(ys, refs)))
    obl_fwd_counts = counts()
    o_ratio = {part: oworst[f"{part}.B1"] / oworst[f"{part}.plain"] for part in ("out", "lstm")}
    emit({"phase": "obl", "check": "forward at the learner shape against float64", "T": T, "B": B,
          "seeds": F64_SEEDS, "outputs": {"out": ["q", "o"], "lstm": ["outs", "hT", "cT"]},
          "largest_gap_to_f64": oworst, "ratio_to_plain": o_ratio, "factor": F64_FACTOR, "launches": obl_fwd_counts})
    if obl_fwd_counts["b1"] != F64_SEEDS * 2 * L:
        fail(f"obl: the forwards launched {obl_fwd_counts}, expected {2 * L} of B1 each")
    bad = {k: v for k, v in o_ratio.items() if not v <= F64_FACTOR}
    if bad:
        fail(f"obl: the forward through B1 lies further than {F64_FACTOR}x the plain version from float64: {bad}")
    del obl_policy, op32, op64, obs, legal, got, lstm_seen
    torch.cuda.empty_cache()

    # 6k. action_matrix: the 2-player IQL checkpoint through the tool, 1000
    # games, against the JAX package's CPU matrix by distribution.
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    am_normed, am_counts = action_matrix.main(["--weight", IQL_2P, "--num_game", str(num_game),
                                               "--seed", str(seed), "--device", "cuda"])
    am_wall = time.time() - t0
    am_launches = counts()
    jax_counts = np.array(JAX_IQL_2P_COUNTS, dtype=np.float64)
    port_counts = am_counts[:20, :20].astype(np.float64)
    n_port, n_jax = port_counts.sum(1), jax_counts.sum(1)
    rows = [i for i in range(20) if n_port[i] >= AM_MIN_ROW and n_jax[i] >= AM_MIN_ROW]
    am_worst, am_bad = 0.0, []
    for i in rows:
        p_port, p_jax = port_counts[i] / n_port[i], jax_counts[i] / n_jax[i]
        pooled = (port_counts[i] + jax_counts[i]) / (n_port[i] + n_jax[i])
        band = AM_SIGMAS * np.sqrt(pooled * (1 - pooled) * (1 / n_port[i] + 1 / n_jax[i])) + AM_SLACK
        excess = np.abs(p_port - p_jax) / band
        am_worst = max(am_worst, float(excess.max()))
        am_bad += [(action_matrix.IDX2ACTION[i], action_matrix.IDX2ACTION[j]) for j in np.where(excess > 1)[0]]
    p4, r1 = action_matrix.IDX2ACTION.index("P4"), action_matrix.IDX2ACTION.index("R1")
    emit({"phase": "action_matrix", "checkpoint": IQL_2P, "num_game": num_game, "seed": seed,
          "rows_compared": len(rows), "row_counts": {"port": n_port.astype(int).tolist(),
                                                    "jax": n_jax.astype(int).tolist()},
          "largest_gap_over_band": am_worst, "outside_band": am_bad,
          "p_r1_given_p4": {"port": float(am_normed[p4, r1]), "jax_cpu": float(jax_counts[p4, r1] / n_jax[p4]),
                            "benchmarks_md": BENCHMARKS_R1_GIVEN_P4, "n_port": int(n_port[p4])},
          "wall_s": am_wall, "launches": am_launches, "card": smi_line})
    if am_launches["b1"] == 0:
        fail("action_matrix: the eval did not launch B1")
    if len(rows) < 10:
        fail(f"action_matrix: only {len(rows)} rows with {AM_MIN_ROW} transitions in both")
    if am_bad:
        fail(f"action_matrix: entries outside the band of the JAX package's matrix: {am_bad}")

    # 6l. convert: the flagship through tools/convert_model.py; the .pthw
    # reloads to the .pkl's params bit for bit, and the .sparta module on the
    # card gives r2d2_net.act's a, h0 and c0 on a 1000-game eval's inputs.
    reset_counts()
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        model = os.path.join(tmp, "flagship.pkl")
        shutil.copy(FLAGSHIP, model)
        sparta_path = convert_model.main(["--model", model, "--pthw", "--device", "cuda"])
        pthw = loaders.load_sad_model(os.path.join(tmp, "flagship.pthw"), device=dev)
        sparta = torch.jit.load(sparta_path, map_location=dev)
        sparta_bytes = os.path.getsize(sparta_path)
    convert_s = time.time() - t0
    same_params = all(torch.equal(a, b) for a, b in zip(learner.param_leaves(pthw.params.online),
                                                         learner.param_leaves(policy.params.online)))
    del pthw
    sparta_gap = {"a": 0.0, "h0": 0.0, "c0": 0.0}
    Ln, D = policy.agent_cfg.net.num_lstm_layer, policy.agent_cfg.net.hid_dim

    def sparta_checked_act(params, cfg, obs, hidden, generator):
        n = obs["priv_s"].shape[0]
        s_ = obs["priv_s"].reshape(n, -1)
        hid = {"h0": hidden.h.reshape(n, Ln, D), "c0": hidden.c.reshape(n, Ln, D)}
        a, new = r2d2_net.act(params.online, cfg.net, s_, hid)
        res = sparta({"s": s_, "h0": hid["h0"], "c0": hid["c0"]})
        for k, want in (("a", a), ("h0", new["h0"]), ("c0", new["c0"])):
            sparta_gap[k] = max(sparta_gap[k], float((res[k] - want).abs().max()))
        return r2d2_agent.act(params, cfg, obs, hidden, generator)

    checked = loaders.EvalPolicy(policy.params, policy.agent_cfg, sparta_checked_act, policy.sad)
    torch.cuda.synchronize()
    t0 = time.time()
    mean_c = evaluate([checked, checked], num_game, seed, num_steps=num_steps, decks=decks, device=dev)[0]
    convert_wall = time.time() - t0
    convert_counts = counts()
    emit({"phase": "convert", "checkpoint": FLAGSHIP, "pthw_same_params": same_params, "sparta_bytes": sparta_bytes,
          "convert_s": convert_s, "num_game": num_game, "eval_mean": mean_c, "sparta_vs_b1_gap": sparta_gap,
          "tol": SPARTA_TOL, "wall_s": convert_wall, "launches": convert_counts, "card": smi_line})
    if not same_params:
        fail("convert: the .pthw does not reload to the checkpoint's params")
    if convert_counts["b1"] == 0:
        fail("convert: the check did not launch B1")
    if mean_c != mean_k:
        fail(f"convert: the checked eval's mean {mean_c} differs from phase 5's {mean_k}")
    if not max(sparta_gap.values()) <= SPARTA_TOL:
        fail(f"convert: the .sparta module lies {sparta_gap} from r2d2_net.act through B1")
    del sparta, checked

    # 6m. bench_train: the tool at its defaults in bfloat16, 3 timed chunks
    reset_counts()
    t0 = time.time()
    bench = bench_train.main(["--compute_dtype", "bfloat16", "--reps", "3"])
    bench_launches = counts()
    emit({"phase": "bench_train", "args": {"compute_dtype": "bfloat16", "reps": 3}, **bench,
          "wall_s": time.time() - t0, "launches": bench_launches, "card": smi_line})
    if not all(math.isfinite(v) and v > 0 for k, v in bench.items() if k != "chunk_s"):
        fail(f"bench_train: a rate is not finite and positive: {bench}")
    missing = [k for k in ("b1_bf16", "b2", "b2_bwd_bf16", "b3") if bench_launches[k] == 0]
    if missing:
        fail(f"bench_train launched none of {missing}")
    torch.cuda.empty_cache()

    # 6n. multigpu: the flagship trainer on 2 ranks sharing the card, each a
    # process of its own (multigpu_rank), against 1 rank; the 2-rank eval
    # against the 1-rank eval; 2 bf16 ranks within BANDS; then B1 and B2 at a
    # rank's learner shape.
    def run_ranks(label, world, dtype, chunks, eval_games):
        """The ranks of one run, started together; fails if one fails or
        outlives MULTIGPU_RANK_TIMEOUT_S. Returns (each rank's json, each
        rank's arrays, wall seconds)."""
        out = tempfile.mkdtemp(prefix=f"multigpu_{label}_")
        # the host's cores split between the ranks: oversubscribed OpenMP
        # threads slow every host op many times over
        env = dict(os.environ, OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 1) // world)))
        procs = []
        t0 = time.time()
        try:
            for rank in range(world):
                log = open(os.path.join(out, f"rank{rank}.log"), "w")
                cmd = [sys.executable, os.path.abspath(__file__), "--multigpu_rank", str(rank), "--world", str(world),
                       "--init", f"file://{out}/rendezvous", "--out", out, "--dtype", dtype,
                       "--chunks", str(chunks), "--eval_games", str(eval_games)]
                procs.append((subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env), log))
            for rank, (proc, log) in enumerate(procs):
                try:
                    proc.wait(timeout=max(1.0, MULTIGPU_RANK_TIMEOUT_S - (time.time() - t0)))
                except subprocess.TimeoutExpired:
                    fail(f"multigpu {label}: rank {rank} did not end within {MULTIGPU_RANK_TIMEOUT_S} s")
                if proc.returncode != 0:
                    log.flush()
                    with open(log.name) as f:
                        tail = f.read()[-3000:]
                    fail(f"multigpu {label}: rank {rank} exited {proc.returncode}:\n{tail}")
            results = []
            for rank in range(world):
                with open(os.path.join(out, f"rank{rank}.json")) as f:
                    results.append(json.load(f))
            arrays = [dict(np.load(os.path.join(out, f"rank{rank}.npz"))) for rank in range(world)]
            return results, arrays, time.time() - t0
        finally:
            for proc, log in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
            shutil.rmtree(out, ignore_errors=True)

    def ranks_identical(results, arrays):
        """Every rank of a run holds the same state: stats, ring, index rows,
        metrics and params."""
        same = all(r[k] == results[0][k] for r in results[1:] for k in ("collect", "ring", "idx_rows", "updates"))
        same &= all([c["metrics"] for c in r["chunks"]] == [c["metrics"] for c in results[0]["chunks"]]
                    for r in results[1:])
        same &= all(np.array_equal(a[k], arrays[0][k]) for a in arrays[1:] for k in arrays[0])
        return same

    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    W = MULTIGPU_WORLD
    one, one_arr, one_s = run_ranks("f32_w1", 1, "float32", 1, 1000)
    two, two_arr, two_s = run_ranks(f"f32_w{W}", W, "float32", 1, 1000)
    r1, r2 = one[0], two[0]
    m1, m2 = r1["chunks"][0]["metrics"], r2["chunks"][0]["metrics"]
    stat_keys = [k for k in m1 if k.startswith("chunk_") or k in ("dropped_episodes", "explore_ratio")]
    update_keys = [k for k in m1 if k not in stat_keys]
    params_gap = max(float(np.abs(two_arr[0][k] - one_arr[0][k]).max()) for k in one_arr[0] if k.startswith("param"))
    a1, a2 = one_arr[0], two_arr[0]
    live = ~(a1["was_done"] & a2["was_done"])
    same_games = ((a1["actions"] == a2["actions"]) | ~live).all(0) & (a1["was_done"] == a2["was_done"]).all(0)
    gates = {
        "ranks_identical": ranks_identical(two, two_arr),
        "collect_stats_equal": r1["collect"] == r2["collect"],
        "chunk_stats_equal": all(m1[k] == m2[k] for k in stat_keys),
        "ring_bits_equal": r1["ring"] == r2["ring"],
        "index_rows_equal": r1["idx_rows"] == r2["idx_rows"],
        "first_update": all(rel(r2["updates"][0][k], r1["updates"][0][k]) <= MULTIGPU_FIRST_RTOL
                            for k in ("loss", "grad_norm")),
        "chunk_means": all(rel(m2[k], m1[k]) <= MULTIGPU_CHUNK_RTOL for k in update_keys),
        "eval_scores_equal": bool(np.array_equal(a1["scores"], a2["scores"])),
        "same_launches_per_rank": all(r["chunks"][0]["launches"] == r1["chunks"][0]["launches"]
                                      and r["collect_launches"] == r1["collect_launches"] for r in two),
    }
    eval_agree = float(same_games.mean())
    per_rank_launches = [{"collect": r["collect_launches"], "train_chunk": r["chunks"][0]["launches"],
                          "eval": r["eval"]["launches"]} for r in two]
    reduce_ms = [float(np.mean(r["reduce_ms"])) for r in two]
    emit({"phase": "multigpu", "run": "float32", "world": W, "backend": "gloo", "device": "cuda:0 (shared)",
          "config": {"preset": "sad_2p", "pred_weight": 0.25, "burn_in_frames": 2048, **shape,
                     "envs_per_rank": r2["envs_per_rank"], "batch_per_rank": r2["batch_per_rank"]},
          "gates": gates, "collect": {"w1": r1["collect"], f"w{W}": r2["collect"]},
          "first_update": {"w1": r1["updates"][0], f"w{W}": r2["updates"][0],
                           "rel": {k: rel(r2["updates"][0][k], r1["updates"][0][k]) for k in ("loss", "grad_norm")}},
          "chunk_means_rel": {k: rel(m2[k], m1[k]) for k in update_keys}, "params_max_abs_gap": params_gap,
          "ring": r2["ring"], "eval": {"w1": r1["eval"], f"w{W}": [r["eval"] for r in two],
                                       "same_action_games": eval_agree, "phase5_mean": mean_k},
          "launches_per_rank": per_rank_launches, "launches_w1": {"collect": r1["collect_launches"],
                                                                  "train_chunk": r1["chunks"][0]["launches"]},
          "grad_all_reduce_ms_per_update": reduce_ms,
          "chunk_wall_s": {"w1": r1["chunks"][0]["wall_s"], f"w{W}": [r["chunks"][0]["wall_s"] for r in two]},
          "collect_wall_s": {"w1": r1["collect_wall_s"], f"w{W}": [r["collect_wall_s"] for r in two]},
          "run_wall_s": {"w1": one_s, f"w{W}": two_s}, "card": smi_line,
          "note": "two ranks share one card: the walls are not scaling"})
    bad = [k for k, v in gates.items() if not v and k != "eval_scores_equal"]
    if bad:
        fail(f"multigpu: {W} ranks differ from 1 rank: {bad}")
    if not gates["eval_scores_equal"] and eval_agree < MULTIGPU_EVAL_AGREE:
        fail(f"multigpu: the {W}-rank eval's scores differ and only {eval_agree} of games keep their actions")
    if any(v == 0 for r in per_rank_launches for k, v in r["train_chunk"].items() if k in ("b1", "b2", "b3")):
        fail(f"multigpu: a rank launched no B1, B2 or B3: {per_rank_launches}")

    bf, bf_arr, bf_s = run_ranks(f"bf16_w{W}", W, "bfloat16", 2, 0)
    bf_rows = [c["metrics"] for c in bf[0]["chunks"]]
    emit({"phase": "multigpu", "run": "bfloat16", "world": W, "chunks": bf_rows,
          "ranks_identical": ranks_identical(bf, bf_arr), "bands": BANDS,
          "launches_per_rank": [[c["launches"] for c in r["chunks"]] for r in bf],
          "grad_all_reduce_ms_per_update": [float(np.mean(r["reduce_ms"])) for r in bf],
          "chunk_wall_s": [[c["wall_s"] for c in r["chunks"]] for r in bf], "run_wall_s": bf_s, "card": smi_line})
    if not ranks_identical(bf, bf_arr):
        fail("multigpu bf16: the ranks hold different states")
    for chunk, row in enumerate(bf_rows):
        if not all(math.isfinite(v) for v in row.values()):
            fail(f"multigpu bf16: non-finite metric in chunk {chunk}: {row}")
        for k, (lo, hi) in BANDS.items():
            if not lo <= row[k] <= hi:
                fail(f"multigpu bf16: chunk {chunk}: {k} = {row[k]} outside the band [{lo}, {hi}]")
    if any(c["launches"][k] == 0 for r in bf for c in r["chunks"] for k in ("b1_bf16", "b2", "b3")):
        fail("multigpu bf16: a rank launched no B1 bf16, B2 or B3")
    multigpu_launches = {"float32": per_rank_launches,
                         "bfloat16": [[c["launches"] for c in r["chunks"]] for r in bf]}

    # B1 and B2 at a rank's learner shape, [80, 64, 512]: against float64 by
    # the float32 rule and BF16_RULES (a), over F64_SEEDS_WIDE inputs; timed
    # beside the plain versions, cuDNN and the bound
    T, B = B1_RANK
    rank_worst = {}
    for seed in range(F64_SEEDS_WIDE):
        g = torch.Generator().manual_seed(seed)
        r = lambda *shape, scale=1.0: (scale * torch.randn(*shape, generator=g)).to(dev)
        xs, h0, c0 = r(T, B, H), r(L, B, H, scale=0.5), r(L, B, H, scale=0.5)
        cot = (r(T, B, H), r(L, B, H), r(L, B, H))
        for dtype, params in ((torch.float32, lstm_params), (torch.bfloat16, pb)):
            tag = "f32" if dtype == torch.float32 else "bf16"
            ins = [t.to(dtype) for t in (xs, h0, c0)]  # bf16: the reference takes the rounded inputs
            with torch.no_grad():
                b1_y = flat3(lstm_seq_kernel(params, ins[0], (ins[1], ins[2])))
            ys_k, grads_k = fwd_bwd(lstm_seq_diff, *leaves_of(params, *ins, dtype=dtype), cot)
            ys_p, grads_p = fwd_bwd(lstm_seq_plain, *leaves_of(params, *ins, dtype=dtype), cot)
            ys_64, _ = fwd_bwd(lstm_seq_plain, *leaves_of(params, *ins, dtype=torch.float64), cot)
            torch.cuda.synchronize()
            for who, ys in (("B1", b1_y), ("B2", ys_k), ("plain", ys_p)):
                key = f"{tag}.{who}"
                rank_worst[key] = max(rank_worst.get(key, 0.0), max(largest_gap(y, ref) for y, ref in zip(ys, ys_64)))
            if dtype == torch.float32:
                rank_worst["f32.B2_grad_rel_to_plain"] = max(rank_worst.get("f32.B2_grad_rel_to_plain", 0.0), *(
                    largest_gap(gk, gp.double(), rel=True) for gk, gp in zip(grads_k, grads_p)))
            del ys_k, grads_k, ys_p, grads_p, ys_64
    rank_ratio = {f"{tag}.{who}": rank_worst[f"{tag}.{who}"] / max(rank_worst[f"{tag}.plain"], 1e-30)
                  for tag in ("f32", "bf16") for who in ("B1", "B2")}
    for dtype, params, lib, peak, nbytes in ((torch.float32, lstm_params, cudnn, H100_F32_FLOPS, 4.0),
                                             (torch.bfloat16, pb, cudnn_bf16, H100_BF16_FLOPS, 2.0)):
        tag = "" if dtype == torch.float32 else "_bf16"
        xs_r, h0_r, c0_r = (t.to(dtype) for t in (randn(T, B, H), randn(L, B, H, scale=0.5),
                                                   randn(L, B, H, scale=0.5)))
        cot_r = [t.to(dtype) for t in (randn(T, B, H), randn(L, B, H), randn(L, B, H))]
        with torch.no_grad():
            reset_counts()
            lstm_seq_kernel(params, xs_r, (h0_r, c0_r))
            per_call = counts()
            ms = cuda_ms(torch, lambda: lstm_seq_kernel(params, xs_r, (h0_r, c0_r)))
            plain_ms = cuda_ms(torch, lambda: lstm_seq_plain(params, xs_r, (h0_r, c0_r)))
            library_ms = cuda_ms(torch, lambda: lib(xs_r, (h0_r, c0_r)))
        b_ms, b_by = bound(lstm_flops(T, B, H, L), nbytes * lstm_words(T, B, H, L), peak=peak)
        timing[f"B1{tag}_rank"] = {"T": T, "B": B, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                                   "bound_ms": b_ms, "bound_by": b_by,
                                   "launches_per_call": {k: v for k, v in per_call.items() if k.startswith("b1")}}
        ps_r, ts_r, leaves_r = leaves_of(params, xs_r, h0_r, c0_r, dtype=dtype)
        lib_leaves = [t.detach().clone().requires_grad_(True) for t in (xs_r, h0_r, c0_r)]

        def lib_fwd_bwd():
            out, (h_t, c_t) = lib(lib_leaves[0], (lib_leaves[1], lib_leaves[2]))
            return torch.autograd.grad((out, h_t, c_t), lib_leaves + list(lib.parameters()), cot_r)

        reset_counts()
        fwd_bwd(lstm_seq_diff, ps_r, ts_r, leaves_r, cot_r)
        per_call = counts()
        ms = cuda_ms(torch, lambda: fwd_bwd(lstm_seq_diff, ps_r, ts_r, leaves_r, cot_r), iters=10, warmup=2)
        plain_ms = cuda_ms(torch, lambda: fwd_bwd(lstm_seq_plain, ps_r, ts_r, leaves_r, cot_r), iters=10, warmup=2)
        library_ms = cuda_ms(torch, lib_fwd_bwd, iters=10, warmup=2)
        b_ms, b_by = bound(3 * lstm_flops(T, B, H, L), nbytes * 2 * lstm_words(T, B, H, L), peak=peak)
        timing[f"B2{tag}_rank"] = {"T": T, "B": B, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                                   "bound_ms": b_ms, "bound_by": b_by,
                                   "launches_per_call": {k: v for k, v in per_call.items() if k != "b3"}}
        del ps_r, ts_r, leaves_r, lib_leaves
    emit({"phase": "multigpu", "check": "B1 and B2 at a rank's learner shape against float64", "T": T, "B": B,
          "H": H, "L": L, "seeds": F64_SEEDS_WIDE, "largest_gap_to_f64": rank_worst, "ratio_to_plain": rank_ratio,
          "factor": F64_FACTOR, "grad_rel_tol": GRAD_REL_TOL,
          "timing": {k: timing[k] for k in ("B1_rank", "B2_rank", "B1_bf16_rank", "B2_bf16_rank")},
          "card": smi_line})
    bad = {k: v for k, v in rank_ratio.items() if not v <= F64_FACTOR}
    if bad:
        fail(f"multigpu: at [{T}, {B}] further than {F64_FACTOR}x the plain version from float64: {bad}")
    if not rank_worst["f32.B2_grad_rel_to_plain"] <= GRAD_REL_TOL:
        fail(f"multigpu: B2 grads at [{T}, {B}] disagree with autograd of the plain version: {rank_worst}")

    # 6o. multigpu_cli: the real entry under torchrun at world 1, on nccl (the
    # default backend on the card), one short epoch warm-started from FLAGSHIP
    out = tempfile.mkdtemp(prefix="multigpu_cli_")
    cli = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
           "-m", "hanabi_sad_tpu_torch.train.selfplay", "--multihost", "1", "--preset", "sad_2p",
           "--pred_weight", "0.25", "--load_model", FLAGSHIP, "--burn_in_frames", "2048", "--num_epoch", "1",
           "--epoch_len", "16", "--num_eval_game", "200", "--save_dir", out]
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    t0 = time.time()
    try:
        run = subprocess.run(cli, capture_output=True, text=True, timeout=MULTIGPU_CLI_TIMEOUT_S, env=env)
    except subprocess.TimeoutExpired:
        fail(f"multigpu_cli: torchrun did not end within {MULTIGPU_CLI_TIMEOUT_S} s")
    log_path = os.path.join(out, "train.log")
    log = open(log_path).read() if os.path.exists(log_path) else ""
    cli_ok = {"exit_0": run.returncode == 0, "latest_pkl": os.path.exists(os.path.join(out, "latest.pkl")),
              "nccl": "multihost: rank 0 of 1, nccl" in log, "eval": "eval score" in log}
    emit({"phase": "multigpu_cli", "command": " ".join(cli[1:]), "checks": cli_ok, "wall_s": time.time() - t0,
          "eval_line": [line for line in log.splitlines() if "eval score" in line], "card": smi_line})
    shutil.rmtree(out, ignore_errors=True)
    if not all(cli_ok.values()):
        fail(f"multigpu_cli: {cli_ok}\n{run.stdout[-2000:]}\n{run.stderr[-3000:]}")
    torch.cuda.empty_cache()

    # 6p. learn: the bf16 flagship from scratch, LEARN_EPOCHS epochs through
    # the trainer's entry point with the learning-curve script's flag line,
    # its burn-in from an empty replay at the shipped 10,000 frames; each
    # train chunk's launches (the train_op chunk's: bf16, one net in the
    # collect), the target sync across update 2500, and the script's gates.
    spec = importlib.util.spec_from_file_location(
        "torch_learning_curve", os.path.join(os.path.dirname(os.path.abspath(__file__)), LEARNING_CURVE))
    curve = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(curve)
    out = tempfile.mkdtemp(prefix="learn_")
    flags = curve.flag_line("bfloat16", LEARN_EPOCHS, out, extra=["--seed", str(LEARN_SEED)])
    learn_cfg, _ = selfplay.parse_args(flags)
    sync_every = learn_cfg.num_update_between_sync
    jax_curves = curve.jax_curves()
    emit({"phase": "learn", "flags": flags, "sync_every": sync_every, "jax": curve.jax_summary(jax_curves)})
    real_chunk, real_update = learner.train_chunk, learner.sgd_update
    learn_u = learn_cfg.num_update_per_chunk
    per_epoch = learn_cfg.epoch_len // learn_u
    last_held = sync_every // learn_u * learn_u  # 2496: the last chunk end before the sync
    synced, chunk_rows = {}, []

    def learn_update(setup, optimizer, state, presampled=None):
        # the online params the sync at this update copies into the target
        if state.num_update % sync_every == 0:
            synced[state.num_update] = [t.detach().clone() for t in learner.param_leaves(state.params.online)]
        return real_update(setup, optimizer, state, presampled)

    def learn_chunk(setup, optimizer, state):
        first, before = state.num_update, counts()
        state, metrics = real_chunk(setup, optimizer, state)
        after, end = counts(), state.num_update
        row = {"first": first, "end": end, "launches": {k: after[k] - before[k] for k in after}}
        # The target's bits are read (a wait on the card) only where the
        # gates look: after the first chunk, the last chunk before the sync,
        # the chunk that holds it and the last chunk. Between two reads a
        # sync would copy online params that every update moves.
        if first == 0 or end == last_held or first <= sync_every < end or end == LEARN_EPOCHS * per_epoch * learn_u:
            target = learner.param_leaves(state.params.target)
            row["target_is_sync_0"] = all(map(torch.equal, target, synced[0]))
            row["target_is_sync_2500"] = sync_every in synced and all(map(torch.equal, target, synced[sync_every]))
        chunk_rows.append(row)
        return state, metrics

    reset_counts()
    learner.train_chunk, learner.sgd_update = learn_chunk, learn_update
    t0 = time.time()
    try:
        selfplay.main(flags)
    finally:
        learner.train_chunk, learner.sgd_update = real_chunk, real_update
    learn_s = time.time() - t0
    learn_counts = counts()
    del synced
    rows = curve.curve(curve.leg_logs(out))
    result = curve.verdict(rows, LEARN_EPOCHS, jax_curves)
    shutil.rmtree(out, ignore_errors=True)
    epoch_launches = [{k: sum(r["launches"][k] for r in chunk_rows[e * per_epoch:(e + 1) * per_epoch])
                       for k in learn_counts} for e in range(LEARN_EPOCHS)]
    for row, launches in zip(rows, epoch_launches):
        emit({"phase": "learn", **curve.epoch_line(row, jax_curves, per_epoch * learn_u),
              "train_chunk_launches": launches, "card": smi_line})
    # a chunk of updates first .. end - 1 syncs at update sync_every when
    # first <= sync_every < end
    read = [r for r in chunk_rows if "target_is_sync_0" in r]
    held = [r for r in read if r["end"] <= sync_every]
    crossing = [r for r in read if r["first"] <= sync_every < r["end"]]
    after_sync = [r for r in read if sync_every < r["first"]]
    learn_gates = {
        "script_verdict": result["verdict"] == "pass",
        "chunks": len(chunk_rows) == LEARN_EPOCHS * per_epoch,
        "target_held_through_2496": [r["end"] for r in held] == [learn_u, last_held] and all(
            r["target_is_sync_0"] for r in held),
        "target_changed_at_2500": len(crossing) == 1 and not crossing[0]["target_is_sync_0"] and crossing[0][
            "target_is_sync_2500"] and len(after_sync) == 1 and after_sync[0]["target_is_sync_2500"],
        "chunk_launches": all(r["launches"] == op_train for r in chunk_rows),
    }
    emit({"phase": "learn", **result, "learn_gates": learn_gates, "updates": rows[-1]["updates"] if rows else 0,
          "train_chunks": len(chunk_rows), "last_held_chunk": held[-1] if held else None,
          "sync_chunk": crossing[0] if crossing else None, "launches": learn_counts,
          "expected_chunk_launches": op_train, "wall_s": learn_s, "card": smi_line})
    if not all(learn_gates.values()):
        fail(f"learn: {learn_gates} {result}")
    torch.cuda.empty_cache()

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
         "rollout_shape": timing["B1_rollout"], "priority_shape": timing["B1_priority"],
         "priority_launches": prio_counts["b1"], "crossplay_launches": xp_counts["b1"],
         "aligned_priority_shape": timing["B1_aligned_priority"],
         "aligned_priority_launches": aligned_prio_counts["b1"], "train_aligned_launches": aligned_totals["b1"],
         "obl_launches": obl_counts["b1"], "obl_forward_launches": obl_fwd_counts["b1"],
         "action_matrix_launches": am_launches["b1"], "convert_launches": convert_counts["b1"],
         "rank_learner_shape": timing["B1_rank"],
         "multigpu_launches_per_rank": [r["collect"]["b1"] + r["train_chunk"]["b1"] + r["eval"]["b1"]
                                        for r in per_rank_launches],
         "learn_launches": learn_counts["b1"] - learn_counts["b1_bf16"]},
        {"name": "lstm_seq_diff (B2)", "route": "cuda", "source": "hanabi_sad_tpu_torch/ops/csrc/lstm_bwd.cu",
         "replaces": "hanabi_sad_tpu/ops/experimental/pallas_lstm.py:212",
         "launches": totals["b2_bwd"], "calls": totals["b2"], "max_abs_err": b2_max_err, "ms": b2["ms"],
         "plain_ms": b2["plain_ms"], "bound_ms": b2["bound_ms"], "bound_by": b2["bound_by"],
         "library_ms": b2["library_ms"], "shape": "T=80 B=128 H=512 L=2, forward + backward",
         "tensor_cores": tensor_cores["lstm_bwd_f32"], "step_us": timing["persistent_step_us"]["B2_bwd_f32"],
         "split_ms": timing["B2_split_ms"]["f32"], "train_aligned_launches": aligned_totals["b2_bwd"],
         "rank_learner_shape": timing["B2_rank"],
         "multigpu_launches_per_rank": [r["train_chunk"]["b2_bwd"] for r in per_rank_launches],
         "learn_launches": learn_counts["b2_bwd"] - learn_counts["b2_bwd_bf16"]},
        {"name": "sample_batch (B3)", "route": "cuda",
         "source": "hanabi_sad_tpu_torch/ops/csrc/sample_batch.cu",
         "replaces": "hanabi_sad_tpu/ops/experimental/pallas_replay.py:68",
         "launches": totals["b3"], "max_abs_err": max(b3_errors), "ms": b3t["ms"], "plain_ms": b3t["plain_ms"],
         "ms_unflushed": b3t["ms_unflushed"], "plain_ms_unflushed": b3t["plain_ms_unflushed"],
         "call_ms": b3t["call_ms"],
         "bound_ms": b3t["bound_ms"], "bound_by": b3t["bound_by"], "library_ms": None,
         "shape": "64 of 65,536 episodes x [80, 2, 110] bytes -> Batch [80, 64, 2, 838 + 21 + 15]",
         "iql_launches": iql_totals["b3"], "iql_shape": iql_shape, "train_op_launches": op_totals["b3"],
         "train_aligned_launches": aligned_totals["b3"], "train_knobs_launches": knob_totals["b3"],
         "bench_train_launches": bench_launches["b3"],
         "multigpu_launches_per_rank": [r["train_chunk"]["b3"] for r in per_rank_launches],
         "multigpu_bf16_launches_per_rank": [sum(c["b3"] for c in r) for r in multigpu_launches["bfloat16"]],
         "learn_launches": learn_counts["b3"]},
        {"name": "lstm_seq bf16 (B1)", "route": "cuda", "source": "hanabi_sad_tpu_torch/ops/csrc/lstm_bf16.cu",
         "replaces": "hanabi_sad_tpu/ops/experimental/pallas_lstm.py:166",
         "launches": bf16_totals["b1_bf16"], "max_abs_err": max(v for k, v in bf16_errors.items() if k != "learner"),
         "learner_step_gap_to_f64": {k: bworst[f"step.{k}.B1"] for k in ("act", "h", "c")},
         "ms": b1b["ms"], "plain_ms": b1b["plain_ms"], "bound_ms": b1b["bound_ms"], "bound_by": b1b["bound_by"],
         "library_ms": b1b["library_ms"], "f32_kernel_ms": b1b["f32_kernel_ms"], "shape": "T=80 B=128 H=512 L=2",
         "tensor_cores": tensor_cores["lstm_gates_bf16"] and tensor_cores["lstm_recurrence_bf16"],
         "step_us": timing["persistent_step_us"]["B1_bf16"],
         "rollout_shape": timing["B1_bf16_rollout"], "rollout_3p_shape": timing["B1_bf16_rollout_3p"],
         "priority_shape": timing["B1_bf16_priority"], "train_op_launches": op_totals["b1_bf16"],
         "train_knobs_launches": knob_totals["b1_bf16"], "bench_train_launches": bench_launches["b1_bf16"],
         "rank_learner_shape": timing["B1_bf16_rank"],
         "multigpu_launches_per_rank": [sum(c["b1_bf16"] for c in r) for r in multigpu_launches["bfloat16"]],
         "learn_launches": learn_counts["b1_bf16"]},
        {"name": "lstm_seq_diff bf16 (B2)", "route": "cuda",
         "source": "hanabi_sad_tpu_torch/ops/csrc/lstm_bf16.cu",
         "replaces": "hanabi_sad_tpu/ops/experimental/pallas_lstm.py:212",
         "launches": bf16_totals["b2_bwd_bf16"], "calls": bf16_totals["b2"], "max_abs_err": b2_bf16_max_err,
         "ms": b2b["ms"], "plain_ms": b2b["plain_ms"], "bound_ms": b2b["bound_ms"], "bound_by": b2b["bound_by"],
         "library_ms": b2b["library_ms"], "f32_kernel_ms": b2b["f32_kernel_ms"],
         "shape": "T=80 B=128 H=512 L=2, forward + backward",
         "tensor_cores": tensor_cores["lstm_bwd_bf16"],
         "step_us": timing["persistent_step_us"]["B2_bwd_bf16"], "split_ms": timing["B2_split_ms"]["bf16"],
         "train_op_launches": op_totals["b2_bwd_bf16"], "train_knobs_launches": knob_totals["b2_bwd_bf16"],
         "bench_train_launches": bench_launches["b2_bwd_bf16"], "bench_train_calls": bench_launches["b2"],
         "rank_learner_shape": timing["B2_bf16_rank"],
         "multigpu_launches_per_rank": [sum(c["b2_bwd"] for c in r) for r in multigpu_launches["bfloat16"]],
         "learn_launches": learn_counts["b2_bwd_bf16"], "learn_calls": learn_counts["b2"]},
    ], "train_chunk_wall_s": train_walls, "train_bf16_chunk_wall_s": bf16_walls,
        "train_iql_chunk_wall_s": iql_walls, "iql_launches": iql_totals, "eval_iql_3p_launches": eval3_counts,
        "train_op_chunk_wall_s": op_walls, "train_op_launches": op_totals, "priority_launches": prio_counts,
        "crossplay_launches": xp_counts, "train_aligned_chunk_wall_s": aligned_walls,
        "train_aligned_launches": aligned_totals, "aligned_priority_launches": aligned_prio_counts,
        "train_knobs_chunk_wall_s": knob_walls, "train_knobs_launches": knob_totals, "obl_launches": obl_counts,
        "obl_forward_launches": obl_fwd_counts, "action_matrix_launches": am_launches,
        "convert_launches": convert_counts, "bench_train_launches": bench_launches,
        "multigpu_launches_per_rank": multigpu_launches, "learn_launches": learn_counts,
        "learn_epoch_launches": epoch_launches, "learn_wall_s": learn_s})
    print(f"# total seconds: {time.time() - t_all:.1f}", flush=True)
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if "--multigpu_rank" in sys.argv:
        multigpu_rank(sys.argv[1:])
    else:
        main()
    faulthandler.cancel_dump_traceback_later()
