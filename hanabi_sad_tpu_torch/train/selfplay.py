"""Self-play training driver (counterpart of `hanabi_sad_tpu/train/selfplay.py`).

Flags -> config, optional warm start or resume, burn-in, an epoch loop of
train chunks with per-epoch telemetry, a greedy eval and checkpoints:

    python -m hanabi_sad_tpu_torch.train.selfplay --preset sad_2p --pred_weight 0.25 \\
        --save_dir exps/sad_aux --load_model docs/runs/sad_aux_r4_soup10.pkl

Runs on the CUDA card unless --device says otherwise (--device cpu).
Everything printed also goes to `<save_dir>/train.log`. `--load_model`
takes a `train_state` payload (resume: params, Adam state, update counter,
random streams; the replay refills through burn-in) or a params payload
(both nets). Each eval writes the top 5 params payloads by score
(`model0.pkl` .. `model4.pkl`) and `latest.pkl`, a `train_state` payload;
every 50 epochs also `model_epoch{N}.pkl`. Payloads are in the JAX package's
format (`train/checkpoint.py`), so either package loads them. With
`--profile_chunks N`, train chunks 2 .. 1 + N (chunk 1 builds the kernels)
are traced with torch.profiler into a Chrome trace,
`<save_dir>/profile/trace.json`, written when chunk 1 + N ends or, if the run
ends first, at its end. `--compute_dtype bfloat16` runs the trunk and the
LSTM in bfloat16 (B1 and B2's bfloat16 routes on the card); `--preset iql_2p`
(or `--method iql`) trains IQL, at 2-5 players with `--num_player`.
`--preset op_2p` and `--preset sad_aux_op_2p` train Other-Play (`dev` is IQL
+ SAD + Other-Play at a small size); the shipped OP runs also set
`--continuous_exact_priority 0` (initial priorities from the rollout's
online Q) and `--compute_dtype bfloat16`.

Data-parallel training, one process per GPU (torch needs that, where JAX
shards one process over its devices), under torchrun:

    python -m torch.distributed.run --standalone --nproc_per_node <cards> \
        -m hanabi_sad_tpu_torch.train.selfplay --multihost 1 --preset sad_2p ...

`--multihost 1` joins the process group (`parallel.initialize_multihost`,
nccl on the cards, gloo with `--device cpu`) and runs rank r on
cuda:LOCAL_RANK; an explicit `--device` wins. The W ranks compute what one
process computes (`parallel/mesh.py`); num_envs, the batch and
num_eval_game must divide by W. Rank 0 alone writes `train.log` and the
checkpoints; every rank loads `--load_model`. A torchrun launch of more
than one process without `--multihost 1` raises, rather than train
unrelated copies into one save_dir. Torch needs no pre-import guard where
the JAX trainer has one: nothing initialises a backend at import.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pprint
import sys
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from hanabi_sad_tpu_torch import parallel
from hanabi_sad_tpu_torch.agent import r2d2_agent
from hanabi_sad_tpu_torch.device import resolve_device
from hanabi_sad_tpu_torch.ops import build, lstm_seq, sample_batch
from hanabi_sad_tpu_torch.tools.loaders import EvalPolicy
from hanabi_sad_tpu_torch.train import checkpoint as ckpt
from hanabi_sad_tpu_torch.train import learner
from hanabi_sad_tpu_torch.train.config import PRESETS, TrainConfig, make_config
from hanabi_sad_tpu_torch.train.evaluate import evaluate
from hanabi_sad_tpu_torch.utils import Logger, MultiCounter, Stopwatch, Tachometer, TopkSaver, get_mem_usage

# Metrics averaged per epoch and printed, as the JAX driver prints them.
EPOCH_KEYS = ("loss", "grad_norm", "rl_loss", "aux1", "chunk_score", "chunk_len", "explore_ratio")
# Forced `model_epoch{N}` snapshots, and an eval, every this many epochs.
SNAPSHOT_EPOCHS = 50


def parse_args(argv=None):
    """Returns (TrainConfig, device or None)."""
    parser = argparse.ArgumentParser(description="train dqn on hanabi (PyTorch port)")
    parser.add_argument("--preset", type=str, default=None, choices=sorted(PRESETS))
    parser.add_argument("--device", type=str, default=None, help="default: cuda")
    defaults = TrainConfig()
    for f in dataclasses.fields(TrainConfig):
        if isinstance(getattr(defaults, f.name), bool):
            parser.add_argument(f"--{f.name}", type=int, default=None)
        else:
            parser.add_argument(f"--{f.name}", type=type(getattr(defaults, f.name)), default=None)
    args = parser.parse_args(argv)
    overrides = {
        f.name: getattr(args, f.name)
        for f in dataclasses.fields(TrainConfig)
        if getattr(args, f.name) is not None
    }
    for k, v in overrides.items():
        if isinstance(getattr(defaults, k), bool):
            overrides[k] = bool(v)
    return make_config(args.preset, **overrides), args.device


def load_model(path: str, state: learner.TrainState) -> learner.TrainState:
    """`state` with a checkpoint loaded into it: a `train_state` payload
    resumes (params, Adam state, update counter, random streams), a params
    payload replaces both nets (a bare net initialises online and target)."""
    payload = ckpt.load(path)
    if payload.get("kind") == "train_state":
        return ckpt.restore_train_state(payload, state)
    return state._replace(params=ckpt.load_params_into(payload, state.params))


def _start_trace(device: torch.device) -> torch.profiler.profile:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def _stop_trace(prof: torch.profiler.profile, device: torch.device, save_dir: str) -> str:
    """Ends the trace once the device has finished its work, and writes it;
    returns the trace's directory."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    out = os.path.join(save_dir, "profile")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, "trace.json"))
    return out


def _build_kernels(mesh: parallel.Mesh) -> None:
    """On a cold tree every rank would run nvcc on the same sources; rank 0
    builds them (one nvcc each, in parallel) while the others wait."""
    if mesh.rank == 0:
        sources = {*lstm_seq.lstm_seq_kernel.sources.values(), *lstm_seq.lstm_bwd_kernel.sources.values(),
                   sample_batch.sample_batch_kernel.source}
        build.build_many(sorted(sources))
    parallel.barrier(mesh)


def train(cfg: TrainConfig, *, max_chunks: int = 0, device=None) -> dict:
    """Run training on `device` (default `cuda`; with `multihost`,
    cuda:LOCAL_RANK), printing to stdout and, on rank 0, to
    `<save_dir>/train.log`. max_chunks > 0 stops after that many train
    chunks. Returns a summary of the final state: the last eval, the update
    count and the last chunk's metrics.

    With `multihost` it joins the process group from torchrun's environment
    unless the caller already has, and leaves the group it joined at the end."""
    joined = False
    if cfg.multihost:
        if not dist.is_initialized():
            parallel.initialize_multihost(device=device)
            joined = True
        mesh = parallel.make_mesh(device)
    else:
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            raise RuntimeError(
                f"WORLD_SIZE={os.environ['WORLD_SIZE']} without multihost: pass --multihost 1 to train one "
                "data-parallel run, rather than unrelated copies into one save_dir"
            )
        mesh = parallel.Mesh(device=resolve_device(device))
    stdout = sys.stdout
    if mesh.rank == 0:
        os.makedirs(cfg.save_dir, exist_ok=True)
        sys.stdout = Logger(os.path.join(cfg.save_dir, "train.log"))
    else:
        sys.stdout = open(os.devnull, "w")
    try:
        return _train(cfg, max_chunks, mesh)
    finally:
        sys.stdout.close()
        sys.stdout = stdout
        if joined:
            dist.destroy_process_group()


def _train(cfg: TrainConfig, max_chunks: int, mesh: parallel.Mesh) -> dict:
    device = mesh.device
    pprint.pprint(dataclasses.asdict(cfg))
    saver = TopkSaver(cfg.save_dir, 5, write=ckpt.save) if mesh.rank == 0 else None
    setup = learner.make_setup(cfg)
    cfg = setup.train  # post-derived (VDN divisors)
    parallel.check_divisible(mesh, num_envs=cfg.num_envs, batchsize=cfg.batchsize, num_eval_game=cfg.num_eval_game)
    if cfg.multihost:
        print(f"multihost: rank {mesh.rank} of {mesh.world}, {dist.get_backend(mesh.group)}; global num_envs "
              f"{cfg.num_envs}, batch {cfg.batchsize}, {cfg.num_envs // mesh.world} envs and "
              f"{cfg.batchsize // mesh.world} episodes a rank")
    if mesh.world > 1 and device.type == "cuda":
        _build_kernels(mesh)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(
        f"device: {device} ({name}); feature_size={setup.env.feature_size}, "
        f"actions={setup.env.game.num_actions}, replay items/chunk={setup.items_per_chunk}, "
        f"replay ratio={cfg.num_update_per_chunk * cfg.batchsize / setup.items_per_chunk:.2f}"
    )
    state = learner.init_train_state(setup, cfg.seed, device)
    if cfg.load_model:
        print("*****loading pretrained model*****")
        state = load_model(cfg.load_model, state)
        if state.num_update:
            print(f"resumed at update {state.num_update}")
        print("*****done*****")
    state = parallel.shard_train_state(state, mesh)
    optimizer = learner.make_optimizer(cfg)

    while int(state.replay.size) < cfg.burn_in_frames:
        state, stats = learner.collect_only(setup, state)
        print(
            f"warming up replay buffer: {int(state.replay.size)} "
            f"(chunk score {float(stats['chunk_score']):.2f})"
        )
    print("Success, Done")
    print("=======================")

    stat = MultiCounter()
    tachometer = Tachometer()
    stopwatch = Stopwatch(sync=torch.cuda.synchronize if device.type == "cuda" else None)
    num_act_total = 0
    chunks_per_epoch = max(1, cfg.epoch_len // cfg.num_update_per_chunk)
    count_factor = cfg.num_player if cfg.vdn else 1
    summary: Dict = {}
    total_chunks = 0
    trace = None
    for epoch in range(cfg.num_epoch):
        print(f"beginning of epoch: {epoch}")
        print(get_mem_usage())
        tachometer.start()
        stat.reset()
        stopwatch.reset()
        # Metrics stay on the device until the epoch ends: one read per
        # epoch, not one per chunk and metric.
        epoch_metrics = []
        for _ in range(chunks_per_epoch):
            # Trace steady-state chunks (chunk 1 builds the kernels) on request.
            if cfg.profile_chunks > 0 and total_chunks + 1 == 2 and mesh.rank == 0:
                trace = _start_trace(device)
            state, metrics = learner.train_chunk(setup, optimizer, state)
            epoch_metrics.append(metrics)
            total_chunks += 1
            if trace is not None and total_chunks >= 1 + cfg.profile_chunks:
                print(f"profiler trace written to {_stop_trace(trace, device, cfg.save_dir)}")
                trace = None
            if max_chunks and total_chunks >= max_chunks:
                break
        rows = [{k: float(v) for k, v in m.items()} for m in epoch_metrics]
        for row in rows:
            stat.feed_dict({k: v for k, v in row.items() if k in EPOCH_KEYS})
            num_act_total += int(row["chunk_frames"]) * cfg.num_player
        stopwatch.time("train chunk")

        print(f"EPOCH: {epoch}")
        print(tachometer.lap(num_act_total, int(state.replay.num_add),
                             len(rows) * cfg.num_update_per_chunk * cfg.batchsize, count_factor))
        print(stopwatch.summary())
        print(stat.summary(epoch))
        summary.update(num_update=state.num_update, metrics=rows[-1])

        last = bool(max_chunks and total_chunks >= max_chunks) or epoch == cfg.num_epoch - 1
        # The forced snapshot epochs join the eval gate, so that they fire
        # whatever eval_freq_epochs is.
        snapshot = epoch > 0 and epoch % SNAPSHOT_EPOCHS == 0
        if epoch % cfg.eval_freq_epochs == 0 or snapshot or last:
            eval_seed = (9917 + epoch * 999999) % 7777777
            policy = EvalPolicy(
                params=state.params, agent_cfg=setup.eval_agent, act_fn=r2d2_agent.act, sad=cfg.sad
            )
            score, perfect, _, _ = evaluate(
                [policy] * cfg.num_player, cfg.num_eval_game, eval_seed, cfg.eval_bomb,
                hand_size=cfg.hand_size, num_steps=cfg.eval_max_steps, shuffle_obs=cfg.shuffle_obs,
                device=device, mesh=mesh,
            )
            stopwatch.time("eval")
            model_saved = False
            # Every rank holds the same state; rank 0 alone writes it (the
            # JAX trainer's rule: concurrent writers would corrupt the pickles).
            if mesh.rank == 0:
                config_dict = dataclasses.asdict(cfg)
                model_saved = saver.save(
                    ckpt.params_payload(state.params.online, config_dict), score,
                    force_save_name=f"model_epoch{epoch}" if snapshot else None,
                )
                ckpt.save(os.path.join(cfg.save_dir, "latest.pkl"), ckpt.train_state_payload(state, config_dict))
            print(
                "epoch %d, eval score: %.4f, perfect: %.2f, model saved: %s"
                % (epoch, score, perfect * 100, model_saved)
            )
            summary.update(epoch=epoch, eval_score=score, perfect=perfect)
        print("==========")
        if last:
            break
    if trace is not None:
        # The run ended before chunk 1 + profile_chunks: write what was traced.
        print(f"profiler trace written to {_stop_trace(trace, device, cfg.save_dir)} (truncated run)")
    return summary


def main(argv: Optional[Sequence[str]] = None) -> dict:
    cfg, device = parse_args(argv)
    return train(cfg, device=device)


if __name__ == "__main__":
    main()
