"""Pretrained-model evaluation CLI (counterpart of
`hanabi_sad_tpu/tools/eval_model.py`).

  python -m hanabi_sad_tpu_torch.tools.eval_model \
      --weight docs/runs/sad_aux_r4_soup10.pkl --num_game 1000

Runs on the CUDA card unless --device says otherwise (--device cpu).
"""

from __future__ import annotations

import argparse

import numpy as np

from hanabi_sad_tpu_torch.device import resolve_device
from hanabi_sad_tpu_torch.tools import loaders
from hanabi_sad_tpu_torch.train.evaluate import evaluate


def evaluate_agents(policies, num_game, seed, bomb, num_run=1, device=None):
    scores = []
    perfect = 0
    for i in range(num_run):
        _, _, score, p = evaluate(policies, num_game, num_game * i + seed, bomb, device=device)
        scores.extend(score)
        perfect += p
    mean = float(np.mean(scores))
    sem = float(np.std(scores) / np.sqrt(len(scores)))
    perfect_rate = perfect / (num_game * num_run)
    print("score: %f +/- %f" % (mean, sem), "; perfect: ", perfect_rate)
    return mean, sem, perfect_rate


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--weight", required=True, type=str)
    parser.add_argument("--weight2", default=None, type=str, help="cross-play seat 2")
    parser.add_argument("--num_game", default=5000, type=int)
    parser.add_argument("--num_run", default=1, type=int)
    parser.add_argument("--seed", default=1, type=int)
    parser.add_argument("--bomb", default=0, type=int)
    parser.add_argument("--num_player", default=2, type=int)
    parser.add_argument("--hand_size", default=5, type=int)
    parser.add_argument("--device", default=None, type=str, help="default: cuda")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    p1 = loaders.load_any(args.weight, args.hand_size, device)
    p2 = loaders.load_any(args.weight2 or args.weight, args.hand_size, device)
    policies = [p1] + [p2] * (args.num_player - 1)
    return evaluate_agents(
        policies, args.num_game, args.seed, args.bomb, num_run=args.num_run, device=device
    )


if __name__ == "__main__":
    main()
