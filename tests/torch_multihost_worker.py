"""Worker of tests/test_torch_multihost.py (not collected by pytest): one rank
of a data-parallel run of the PyTorch port over torch.distributed, gloo on the
CPU, or the one-rank run that the test holds the ranks against. It imports the
port only, never JAX or the JAX package.

    python tests/torch_multihost_worker.py <mode> <spec.json> <out.npz> \\
        --rank R --world W --init file://<path>

The ranks meet through the file of --init (no port, so test workers cannot
clash); --world 1 joins no process group. Modes:

  chunk     the `dev` preset with the spec's overrides: one collect chunk and
            one train chunk; writes the chunk stats, every update's metrics
            and sampled index row, the ring and the final params;
  sgd       one sgd_update from the params, replay and presampled batch of
            the spec's .npz; writes its metrics, params and replay weights;
  eval      evaluate() of the spec's checkpoint; writes the scores and the
            actions;
  selfplay  selfplay.train, with multihost at W > 1, for 2 chunks into the
            spec's save_dir (one per rank, so the test sees who wrote what).

Before its mode a rank of W > 1 checks that shard_rows and all_gather_rows
give back mixed-dtype tensors bit for bit.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from hanabi_sad_tpu_torch import parallel  # noqa: E402
from hanabi_sad_tpu_torch.replay import prioritized as replay_mod  # noqa: E402
from hanabi_sad_tpu_torch.tools import loaders  # noqa: E402
from hanabi_sad_tpu_torch.train import learner, selfplay  # noqa: E402
from hanabi_sad_tpu_torch.train.config import make_config  # noqa: E402
from hanabi_sad_tpu_torch.train.evaluate import evaluate  # noqa: E402
from hanabi_sad_tpu_torch.train.learner import param_leaves  # noqa: E402


def check_round_trip(mesh):
    g = torch.Generator().manual_seed(7)
    whole = [torch.randint(0, 256, (2 * mesh.world, 3, 5), generator=g, dtype=torch.uint8),
             torch.randint(-10 ** 12, 10 ** 12, (2 * mesh.world, 4), generator=g),
             torch.randn(2 * mesh.world, generator=g),
             torch.rand(2 * mesh.world, 2, generator=g) < 0.5]
    back = parallel.all_gather_rows([parallel.shard_rows(x, mesh) for x in whole], mesh)
    for x, y in zip(whole, back):
        if x.dtype != y.dtype or not torch.equal(x, y):
            raise AssertionError(f"all_gather_rows did not give back {x.dtype} {tuple(x.shape)}")


def run_chunk(spec, mesh):
    setup = learner.make_setup(make_config("dev", **spec["config"]))
    state = learner.init_train_state(setup, spec["seed"], "cpu")
    state = parallel.shard_train_state(state, mesh)
    optimizer = learner.make_optimizer(setup.train)
    rows, updates = [], []
    update_priority, sgd_update = replay_mod.update_priority, learner.sgd_update

    def recording_update_priority(replay, cfg, idx, priority):
        rows.append(idx.clone())
        return update_priority(replay, cfg, idx, priority)

    def recording_sgd_update(*args, **kwargs):
        new_state, metrics = sgd_update(*args, **kwargs)
        updates.append([float(metrics["loss"]), float(metrics["grad_norm"])])
        return new_state, metrics

    replay_mod.update_priority, learner.sgd_update = recording_update_priority, recording_sgd_update
    try:
        state, collect_stats = learner.collect_only(setup, state)
        state, metrics = learner.train_chunk(setup, optimizer, state)
    finally:
        replay_mod.update_priority, learner.sgd_update = update_priority, sgd_update
    out = {f"collect.{k}": float(v) for k, v in collect_stats.items()}
    out.update({f"train.{k}": float(v) for k, v in metrics.items()})
    out.update(idx=torch.stack(rows).numpy(), updates=np.asarray(updates), num_update=state.num_update)
    for field in ("packed", "action", "reward", "bootstrap", "seq_len", "weight", "size", "write_ptr"):
        out[f"ring.{field}"] = getattr(state.replay, field).numpy()
    for i, t in enumerate(param_leaves(state.params.online)):
        out[f"param{i}"] = t.detach().numpy()
    return out


def run_sgd(spec, mesh):
    data = np.load(spec["inputs"])
    setup = learner.make_setup(make_config("sad_2p", **spec["config"]))
    state = learner.init_train_state(setup, 0, "cpu")
    with torch.no_grad():
        for net in ("online", "target"):
            for i, t in enumerate(param_leaves(getattr(state.params, net))):
                t.copy_(torch.from_numpy(data[f"{net}{i}"]))
    fields = ("packed", "action", "reward", "bootstrap", "seq_len", "priority")
    replay = replay_mod.add_packed(state.replay, setup.replay, *(torch.from_numpy(data[f]) for f in fields))
    state = parallel.shard_train_state(state._replace(replay=replay), mesh)
    presampled = (torch.from_numpy(data["is_weight"]), torch.from_numpy(data["idx"]).long())
    state, metrics = learner.sgd_update(setup, learner.make_optimizer(setup.train), state, presampled=presampled)
    out = {f"metric.{k}": float(v) for k, v in metrics.items()}
    out["weight"] = state.replay.weight.numpy()
    for net in ("online", "target"):
        for i, t in enumerate(param_leaves(getattr(state.params, net))):
            out[f"{net}{i}"] = t.detach().numpy()
    return out


def run_eval(spec, mesh):
    policy = loaders.load_any(spec["weight"], device="cpu")
    mean, perfect, scores, _, actions, was_done = evaluate(
        [policy] * 2, spec["num_game"], spec["seed"], shuffle_obs=spec["shuffle_obs"], num_steps=100,
        return_actions=True, device="cpu", mesh=mesh)
    return {"mean": mean, "scores": np.asarray(scores), "actions": actions, "was_done": was_done}


def run_selfplay(spec, mesh):
    cfg = make_config("sad_2p", multihost=mesh.world > 1, save_dir=spec["save_dirs"][mesh.rank], **spec["config"])
    summary = selfplay.train(cfg, max_chunks=2, device="cpu")
    return {"num_update": summary["num_update"], "eval_score": summary["eval_score"],
            "loss": summary["metrics"]["loss"]}


MODES = {"chunk": run_chunk, "sgd": run_sgd, "eval": run_eval, "selfplay": run_selfplay}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("mode", choices=sorted(MODES))
    parser.add_argument("spec")
    parser.add_argument("out")
    parser.add_argument("--rank", type=int, default=0)
    parser.add_argument("--world", type=int, default=1)
    parser.add_argument("--init", default=None)
    args = parser.parse_args()
    torch.set_num_threads(1)
    with open(args.spec) as f:
        spec = json.load(f)
    if args.world > 1:
        mesh = parallel.initialize_multihost(
            backend="gloo", init_method=args.init, world_size=args.world, rank=args.rank, device="cpu")
        check_round_trip(mesh)
    else:
        mesh = parallel.make_mesh("cpu")
    out = MODES[args.mode](spec, mesh)
    if args.world > 1:
        parallel.barrier(mesh)
        torch.distributed.destroy_process_group()
    np.savez(args.out, **out)
    print(f"rank {args.rank} of {args.world}: done")


if __name__ == "__main__":
    main()
