"""Top-k checkpoint saver (counterpart of `hanabi_sad_tpu/utils/saver.py`).

Keeps the k best checkpoints by eval score in fixed slots model0.pkl ..
model{k-1}.pkl, plus forced saves (model_epochN). A payload is written by
the `write(path, payload)` the caller gives, as the trainer gives
`train/checkpoint.py:save`, which writes the JAX package's pickle format."""

from __future__ import annotations

import os
from typing import Any, Callable, Optional


class TopkSaver:
    def __init__(
        self, save_dir: str, topk: int = 5, suffix: str = "pkl", *, write: Callable[[str, Any], None]
    ):
        self.save_dir = save_dir
        self.write = write
        self.topk = topk
        self.suffix = suffix
        self.worst_perf_idx = 0
        self.perfs = [-float("inf")] * topk
        os.makedirs(save_dir, exist_ok=True)

    def save(self, payload: Any, perf: float, *, force_save_name: Optional[str] = None) -> bool:
        """Write `payload` under `force_save_name` if given, and into the
        slot of the worst kept score if `perf` beats it. Returns whether it
        took a slot."""
        if force_save_name is not None:
            self.write(os.path.join(self.save_dir, f"{force_save_name}.{self.suffix}"), payload)

        if perf <= self.perfs[self.worst_perf_idx]:
            return False

        self.write(os.path.join(self.save_dir, f"model{self.worst_perf_idx}.{self.suffix}"), payload)
        self.perfs[self.worst_perf_idx] = perf
        self.worst_perf_idx = self.perfs.index(min(self.perfs))
        return True
