"""The training driver's utilities (counterpart of `hanabi_sad_tpu/utils`):
stdout tee, top-k checkpoint saver, per-epoch counters, phase stopwatch,
throughput meter, seeding, memory telemetry, card beliefs and asserts."""

from hanabi_sad_tpu_torch.utils import asserts, belief
from hanabi_sad_tpu_torch.utils.counters import MultiCounter, ValueStats
from hanabi_sad_tpu_torch.utils.helper import generate_log_uniform, get_mem_usage, set_all_seeds
from hanabi_sad_tpu_torch.utils.logger import Logger
from hanabi_sad_tpu_torch.utils.saver import TopkSaver
from hanabi_sad_tpu_torch.utils.stopwatch import Stopwatch
from hanabi_sad_tpu_torch.utils.tachometer import Tachometer

__all__ = [
    "Logger",
    "TopkSaver",
    "MultiCounter",
    "ValueStats",
    "Stopwatch",
    "Tachometer",
    "set_all_seeds",
    "generate_log_uniform",
    "get_mem_usage",
    "belief",
    "asserts",
]
