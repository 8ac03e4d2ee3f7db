"""Builds the port's CUDA sources with nvcc into plain C shared libraries,
loaded with ctypes.

A library is built at first use into `ops/_build/` (git-ignored), named after
a hash of its source and the flags. It is written under a temporary name and
moved into place with os.replace, so a build that is cut off leaves neither
a half-written library nor a lock behind.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
NVCC_TIMEOUT_S = 300
# Where nvcc is looked for after PATH and $CUDA_HOME/bin.
NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"


def find_nvcc() -> str:
    """nvcc on PATH, else $CUDA_HOME/bin/nvcc, else the toolkit's default
    install path; raises if none exists."""
    candidates = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append(NVCC_FALLBACK)
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found on PATH, at $CUDA_HOME/bin/nvcc or " + NVCC_FALLBACK)


def build(source: str) -> Tuple[ctypes.CDLL, List[str]]:
    """Compile csrc/<source> (if not built yet) and load it.

    Returns (library, the -Xptxas -v lines of this build; empty if the
    library was already built)."""
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{src.stem}_{digest}.so"
    ptxas: List[str] = []
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=f".{src.stem}_", suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                capture_output=True,
                text=True,
                timeout=NVCC_TIMEOUT_S,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        ptxas = [l for l in (proc.stdout + proc.stderr).splitlines() if "ptxas" in l]
    return ctypes.CDLL(str(lib_path)), ptxas
