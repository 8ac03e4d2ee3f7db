"""Throughput meter (counterpart of `hanabi_sad_tpu/utils/tachometer.py`):
train / act / buffer-add rates per epoch."""

from __future__ import annotations

import time

from hanabi_sad_tpu_torch.utils.counters import num2str, sec2str


class Tachometer:
    def __init__(self):
        self.num_act = 0
        self.num_buffer = 0
        self.num_train = 0
        self.t = None
        self.total_time = 0.0

    def start(self):
        self.t = time.time()

    def lap(self, num_act: int, num_buffer: int, num_train: int, factor: int = 1) -> str:
        """num_act: cumulative env player-steps; num_buffer: cumulative replay
        adds; num_train: train frames this epoch; factor: player-count factor
        for VDN accounting."""
        t = time.time() - self.t
        self.total_time += t
        act_rate = factor * (num_act - self.num_act) / t
        buffer_rate = factor * (num_buffer - self.num_buffer) / t
        train_rate = factor * num_train / t
        lines = ["Speed: train: %.1f, act: %.1f, buffer_add: %.1f" % (train_rate, act_rate, buffer_rate)]
        self.num_act = num_act
        self.num_buffer = num_buffer
        self.num_train += num_train
        lines.append("Total Time: %s, %ds" % (sec2str(self.total_time), self.total_time))
        lines.append("Total Sample: train: %s, act: %s" % (num2str(self.num_train), num2str(self.num_act)))
        return "\n".join(lines)
