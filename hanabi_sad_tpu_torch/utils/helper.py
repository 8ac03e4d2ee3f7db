"""Misc helpers (counterpart of `hanabi_sad_tpu/utils/helper.py`): seeding,
a sweep helper and memory telemetry.

The JAX package's `enable_compilation_cache` is not ported: it turns on
JAX's persistent compilation cache, and the port compiles nothing through
JAX (its CUDA kernels are built once into `ops/_build/`)."""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def set_all_seeds(seed: int):
    """Seed every host-side generator with the JAX helper's offsets: python's
    `random` with seed, numpy's global generator with seed + 1 and torch's
    default generators with seed + 2 (`torch.manual_seed` seeds the CUDA
    devices' too). The port's own runs draw from explicit torch.Generator
    objects seeded from their configs, which this leaves as they are."""
    random.seed(seed)
    np.random.seed(seed + 1)
    torch.manual_seed(seed + 2)


def generate_log_uniform(min_val: float, max_val: float, n: int):
    """n values spaced evenly in log between min_val and max_val."""
    uni = np.linspace(np.log(min_val), np.log(max_val), n)
    return np.exp(uni).tolist()


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
