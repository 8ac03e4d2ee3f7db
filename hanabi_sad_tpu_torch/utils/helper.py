"""Memory telemetry (counterpart of `hanabi_sad_tpu/utils/helper.py:
get_mem_usage`)."""

from __future__ import annotations

import os

import torch


def get_mem_usage() -> str:
    """The process's resident memory and, once the card is in use, the
    memory PyTorch holds on it (allocated now and at its peak)."""
    rss = "rss: unknown"
    try:
        with open(f"/proc/{os.getpid()}/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    rss = f"rss: {int(line.split()[1]) / 1024:.1f} MB"
                    break
    except OSError:
        pass
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        mb = 1024 * 1024
        rss += (f", cuda allocated: {torch.cuda.memory_allocated() / mb:.1f} MB"
                f" (peak {torch.cuda.max_memory_allocated() / mb:.1f} MB)")
    return rss
