"""Policy-convention analysis (counterpart of
`hanabi_sad_tpu/tools/action_matrix.py`): P(next action | previous action)
over greedy self-play games, the 20x20 matrix that shows the conventions a
trained policy adopts.

  python -m hanabi_sad_tpu_torch.tools.action_matrix \
      --weight docs/runs/iql_2p_r1_model.pkl --num_game 1000 --out matrix.txt

Runs on the CUDA card unless --device says otherwise (--device cpu).
"""

from __future__ import annotations

import argparse

import numpy as np

from hanabi_sad_tpu_torch.device import resolve_device
from hanabi_sad_tpu_torch.tools import loaders
from hanabi_sad_tpu_torch.train.evaluate import evaluate

IDX2ACTION = [  # the 2-player action uids' labels: discard, play, color and rank hints by slot or value
    "D1", "D2", "D3", "D4", "D5",
    "P1", "P2", "P3", "P4", "P5",
    "C1", "C2", "C3", "C4", "C5",
    "R1", "R2", "R3", "R4", "R5",
]


def compute_action_matrix(actions: np.ndarray, valid: np.ndarray, num_actions: int):
    """actions: [T, N] applied uid per step; valid: [T, N] step belongs to a
    live game. Counts transitions (a_t -> a_{t+1}) over consecutive turns.
    Returns (counts normalized per row, counts)."""
    counts = np.zeros((num_actions, num_actions), np.int64)
    T, N = actions.shape
    for n in range(N):
        a = actions[np.where(valid[:, n])[0], n]
        np.add.at(counts, (a[:-1], a[1:]), 1)
    denom = counts.sum(1, keepdims=True)
    normed = counts / np.maximum(denom, 1)
    return normed, counts


def render(normed: np.ndarray, labels=IDX2ACTION) -> str:
    k = len(labels)
    lines = ["     " + " ".join(f"{l:>5}" for l in labels)]
    for i in range(k):
        row = " ".join(f"{normed[i, j]:5.2f}" for j in range(k))
        lines.append(f"{labels[i]:>4} {row}")
    return "\n".join(lines)


def plot_heatmap(normed: np.ndarray, path: str, labels=IDX2ACTION):
    """Matplotlib heatmap of P(next action | prev action), headless (Agg);
    prints a line and skips where matplotlib is not installed."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping heatmap")
        return
    k = len(labels)
    fig, ax = plt.subplots(figsize=(10, 8))
    im = ax.imshow(normed[:k, :k], cmap="viridis", vmin=0.0)
    ax.set_xticks(range(k))
    ax.set_yticks(range(k))
    ax.set_xticklabels(labels, rotation=90, fontsize=8)
    ax.set_yticklabels(labels, fontsize=8)
    ax.set_xlabel("next action")
    ax.set_ylabel("previous action")
    fig.colorbar(im, ax=ax, fraction=0.046, pad=0.04)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    print("heatmap saved to", path)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--weight", required=True, type=str)
    parser.add_argument("--num_game", default=1000, type=int)
    parser.add_argument("--seed", default=1, type=int)
    parser.add_argument("--num_player", default=2, type=int)
    parser.add_argument("--out", default=None, type=str, help="write matrix text/npy")
    parser.add_argument("--device", default=None, type=str, help="default: cuda")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    policy = loaders.load_any(args.weight, device=device)
    mean, perfect, _, _, actions, was_done = evaluate(
        [policy] * args.num_player, args.num_game, args.seed, return_actions=True, device=device
    )
    print(f"score: {mean:.4f}, perfect: {100 * perfect:.2f}%")
    num_real = len(IDX2ACTION)
    normed, counts = compute_action_matrix(actions, ~was_done, num_real + 1)
    text = render(normed[:num_real, :num_real])
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        np.save(args.out + ".npy", counts)
        plot_heatmap(normed, args.out + ".png")
        print("saved to", args.out)
    return normed, counts


if __name__ == "__main__":
    main()
