"""Phase wall-clock profiler (counterpart of
`hanabi_sad_tpu/utils/stopwatch.py`).

The device runs behind the host, so a phase ends where the device has
finished it: `time` first calls `sync` (`torch.cuda.synchronize` for a run
on the card, nothing on the CPU)."""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Optional


class Stopwatch:
    def __init__(self, sync: Optional[Callable[[], None]] = None):
        self.sync = sync
        self.times = defaultdict(list)
        self.reset()

    def reset(self):
        if self.sync is not None:
            self.sync()
        self.last_time = time.time()
        self.times.clear()

    def time(self, key: str):
        if self.sync is not None:
            self.sync()
        now = time.time()
        self.times[key].append(1000 * (now - self.last_time))
        self.last_time = now

    def summary(self) -> str:
        total = sum(sum(v) for v in self.times.values())
        if total == 0:
            return "Stopwatch: no samples"
        lines = [f"Time spent = {total / 1000:.2f} s"]
        for k, v in self.times.items():
            t = sum(v)
            lines.append(f"\t{k}: {t / len(v):.1f} ms/call, {100 * t / total:.1f}%")
        return "\n".join(lines)
