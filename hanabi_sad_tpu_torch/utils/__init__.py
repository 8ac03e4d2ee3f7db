"""The training driver's utilities (counterpart of `hanabi_sad_tpu/utils`):
stdout tee, top-k checkpoint saver, per-epoch counters, phase stopwatch,
throughput meter and memory telemetry."""

from hanabi_sad_tpu_torch.utils.counters import MultiCounter, ValueStats
from hanabi_sad_tpu_torch.utils.helper import get_mem_usage
from hanabi_sad_tpu_torch.utils.logger import Logger
from hanabi_sad_tpu_torch.utils.saver import TopkSaver
from hanabi_sad_tpu_torch.utils.stopwatch import Stopwatch
from hanabi_sad_tpu_torch.utils.tachometer import Tachometer

__all__ = ["Logger", "TopkSaver", "MultiCounter", "ValueStats", "Stopwatch", "Tachometer", "get_mem_usage"]
