"""What one replay sample costs on the card, from the sampled indices to the
learner-ready fields, for the tree on PYTHONPATH: kernel B3 plus whatever
the learner then copies.

    PYTHONPATH=. python scripts/torch_sample_batch_ab.py --tree change
    PYTHONPATH=<other checkout> python scripts/torch_sample_batch_ab.py --tree parent

Fills a replay of the flagship's shape (`sad_2p`: 65,536 episodes of [80
steps, 2 players, 110 bytes], 64 episodes a sample) with random fields on
the card, and for two calls counts, under torch.profiler, the device
kernels one call launches and sums their device time, with the L2 cache
overwritten (64 MB) before each call:

  * `sample_indices` alone (cumsum + searchsorted + IS weights);
  * `sample` followed by the reshapes `r2d2_agent.td_error` and `loss`
    apply to its fields (priv_s, legal_move and action to [T, B * Pi, ...],
    own_hand to [T, B, Pi, hand, 3]); a reshape of a field that is not
    contiguous is a copy.

Their difference is what the gather, the unpack and the copies cost. Prints
one JSON line, with the card's name and power limit. Use the same seed in
every tree: the replay's contents and indices are drawn on the card from
it. Needs a CUDA card.
"""

import argparse
import json
import subprocess

import torch

from hanabi_sad_tpu_torch.replay import prioritized as replay_mod
from hanabi_sad_tpu_torch.train import learner
from hanabi_sad_tpu_torch.train.config import make_config

FLUSH_BYTES = 64 * 2 ** 20
FLUSH_KERNEL = "bitwise_not"  # the flush's kernel; no timed call launches one


def kernels_per_call(fn, flush, iters=10):
    """(device kernels and copies per call, their device ms per call), each
    call after an L2 flush whose own kernel is left out."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush()
            fn()
        torch.cuda.synchronize()
    device_us = lambda r: getattr(r, "self_device_time_total", None) or getattr(r, "self_cuda_time_total", 0)
    rows = [r for r in prof.key_averages() if device_us(r) > 0 and FLUSH_KERNEL not in r.key]
    return sum(r.count for r in rows) / iters, sum(device_us(r) for r in rows) / iters / 1e3


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", required=True, help="a label for the tree on PYTHONPATH")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    setup = learner.make_setup(make_config("sad_2p", pred_weight=0.25))
    cfg, B = setup.replay, setup.train.batchsize
    g = torch.Generator(device=dev).manual_seed(args.seed)
    state = replay_mod.init_replay(cfg, dev)
    cap, T, Pi, NB = state.packed.shape
    state.packed.copy_(torch.randint(0, 256, state.packed.shape, dtype=torch.uint8, generator=g, device=dev))
    state.action.copy_(torch.randint(0, cfg.num_actions, state.action.shape, generator=g, device=dev))
    state.reward.copy_(torch.randn(state.reward.shape, generator=g, device=dev))
    state.bootstrap.copy_(torch.rand(state.bootstrap.shape, generator=g, device=dev))
    state.seq_len.copy_(torch.randint(1, T + 1, state.seq_len.shape, generator=g, device=dev).float())
    state.weight.copy_(torch.rand(state.weight.shape, generator=g, device=dev) + 0.1)
    state = state._replace(size=torch.tensor(cap, device=dev))
    F, hand = cfg.obs_dim, cfg.hand_size
    scratch = torch.zeros(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    sample_gen = torch.Generator(device=dev)

    def indices():
        sample_gen.manual_seed(args.seed + 1)
        return replay_mod.sample_indices(state, cfg, B, generator=sample_gen)

    def sample_to_learner():
        sample_gen.manual_seed(args.seed + 1)
        batch, _, _ = replay_mod.sample(state, cfg, B, generator=sample_gen)
        flat = lambda x: x.reshape((T, B * Pi) + tuple(x.shape[3:]))
        return (flat(batch.priv_s), flat(batch.legal_move), flat(batch.action),
                batch.own_hand.reshape(T, B, Pi, hand, 3), batch.reward, batch.bootstrap, batch.terminal)

    out = sample_to_learner()
    idx_kernels, idx_device_ms = kernels_per_call(indices, scratch.bitwise_not_)
    kernels, device_ms = kernels_per_call(sample_to_learner, scratch.bitwise_not_)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=30).stdout.strip()
    print(json.dumps({
        "tree": args.tree, "card": card, "B": B, "cap": cap, "T": T, "Pi": Pi, "F": F,
        "sample_indices_kernels": idx_kernels, "sample_to_learner_kernels": kernels,
        "sample_indices_device_ms": idx_device_ms, "sample_to_learner_device_ms": device_ms,
        "gather_unpack_and_copies_device_ms": device_ms - idx_device_ms,
        "checksum": float(out[0].sum() + out[1].sum() + out[3].sum()) + float(out[2].sum()),
    }), flush=True)


if __name__ == "__main__":
    main()
