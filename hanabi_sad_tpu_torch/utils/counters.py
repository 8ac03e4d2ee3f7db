"""Per-epoch scalar statistics (counterpart of
`hanabi_sad_tpu/utils/counters.py`)."""

from __future__ import annotations

import time
from collections import defaultdict
from datetime import timedelta


class ValueStats:
    def __init__(self, name: str = ""):
        self.name = name
        self.reset()

    def feed(self, v: float):
        v = float(v)
        self.summation += v
        self.counter += 1
        if v > self.max_value:
            self.max_value = v
            self.max_idx = self.counter
        if v < self.min_value:
            self.min_value = v
            self.min_idx = self.counter

    def mean(self) -> float:
        return self.summation / self.counter if self.counter else 0.0

    def summary(self, info: str = "") -> str:
        info = info or self.name
        if self.counter == 0:
            return f"{info}: N/A"
        return (
            f"{info}[{self.counter:5d}]: avg: {self.mean():8.4f}, "
            f"min: {self.min_value:8.4f}[{self.min_idx:4d}], "
            f"max: {self.max_value:8.4f}[{self.max_idx:4d}]"
        )

    def reset(self):
        self.counter = 0
        self.summation = 0.0
        self.max_value = -float("inf")
        self.min_value = float("inf")
        self.max_idx = None
        self.min_idx = None


class MultiCounter:
    def __init__(self):
        self.stats = defaultdict(ValueStats)
        self.max_key_len = 0
        self.last_time = time.time()

    def __getitem__(self, key: str) -> ValueStats:
        self.max_key_len = max(self.max_key_len, len(key))
        return self.stats[key]

    def feed_dict(self, d):
        for k, v in d.items():
            self[k].feed(float(v))

    def reset(self):
        for v in self.stats.values():
            v.reset()
        self.last_time = time.time()

    def time_elapsed(self) -> float:
        return time.time() - self.last_time

    def summary(self, global_counter) -> str:
        lines = [f"[{global_counter}] Time spent = {self.time_elapsed():.2f} s"]
        for k in sorted(self.stats.keys()):
            v = self.stats[k]
            if v.counter:
                lines.append(v.summary(info=str(k).ljust(self.max_key_len)))
        return "\n".join(lines)


def sec2str(seconds: float) -> str:
    return str(timedelta(seconds=int(seconds)))


def num2str(n: float) -> str:
    if n < 1e3:
        return str(int(n))
    for div, suffix in [(1e9, "B"), (1e6, "M"), (1e3, "K")]:
        if n >= div:
            return f"{n / div:.2f}{suffix}"
    return str(n)
