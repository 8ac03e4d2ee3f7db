"""Pretrained-model evaluation CLI (counterpart of
`hanabi_sad_tpu/tools/eval_model.py`).

  python -m hanabi_sad_tpu_torch.tools.eval_model \
      --weight docs/runs/sad_aux_r4_soup10.pkl --num_game 1000

  # cross-play of two models of the OP paper's release grid
  python -m hanabi_sad_tpu_torch.tools.eval_model --paper op --root models/op \
      --method sad-aux-op --idx1 1 --idx2 3

  # a released OBL model in self-play
  python -m hanabi_sad_tpu_torch.tools.eval_model --paper obl --obl_path models/obl/obl.pthw

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
    parser.add_argument("--paper", default="sad", type=str, choices=("sad", "op", "obl"))
    parser.add_argument("--weight", default=None, type=str)
    parser.add_argument("--weight2", default=None, type=str, help="cross-play seat 2")
    parser.add_argument("--num_game", default=5000, type=int)
    parser.add_argument("--num_run", default=1, type=int)
    parser.add_argument("--seed", default=1, type=int)
    parser.add_argument("--bomb", default=0, type=int)
    parser.add_argument("--num_player", default=2, type=int)
    parser.add_argument("--hand_size", default=5, type=int)
    # the OP paper's release grid
    parser.add_argument("--root", default="models/op", type=str)
    parser.add_argument("--method", default="sad-aux-op", type=str)
    parser.add_argument("--idx1", default=1, type=int)
    parser.add_argument("--idx2", default=1, type=int)
    # a released OBL model
    parser.add_argument("--obl_path", default=None, type=str)
    parser.add_argument("--device", default=None, type=str, help="default: cuda")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    if args.paper == "sad":
        if not args.weight:
            parser.error("--weight is required with --paper sad")
        p1 = loaders.load_any(args.weight, args.hand_size, device)
        p2 = loaders.load_any(args.weight2 or args.weight, args.hand_size, device)
        policies = [p1] + [p2] * (args.num_player - 1)
    elif args.paper == "op":
        policies = [
            loaders.load_op_model(args.root, args.method, idx, args.hand_size, device)
            for idx in (args.idx1, args.idx2)
        ]
    else:
        if not args.obl_path:
            parser.error("--obl_path is required with --paper obl")
        policies = [loaders.load_obl_model(args.obl_path, device)] * 2
    return evaluate_agents(
        policies, args.num_game, args.seed, args.bomb, num_run=args.num_run, device=device
    )


if __name__ == "__main__":
    main()
