"""Builds the port's CUDA sources with nvcc into plain C shared libraries,
loaded with ctypes. Several sources build in parallel, one nvcc each.

A library is built at first use into `ops/_build/` (git-ignored), named after
a hash of its source, the shared headers and the flags. It is written under
a temporary name and moved into place with os.replace, so a build that is
cut off leaves neither a half-written library nor a lock behind.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Tuple

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


def lib_path(source: str) -> Path:
    """The library's path, named after a hash of the source, the headers of
    csrc/ (any source may include them) and the flags."""
    src = CSRC / source
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def build_many(sources: List[str]) -> Dict[str, Tuple[ctypes.CDLL, List[str]]]:
    """Compile every csrc/<source> not built yet, one nvcc each, all started
    together, and load them.

    Returns {source: (library, the -Xptxas -v lines of this build; empty if
    the library was already built)}; raises if any nvcc fails."""
    jobs = {}
    try:
        for source in sources:
            path = lib_path(source)
            if path.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(prefix=f".{path.stem}_", suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)],
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
            )
            jobs[source] = (proc, tmp, path)
        ptxas = {}
        for source, (proc, tmp, path) in jobs.items():
            out, err = proc.communicate(timeout=NVCC_TIMEOUT_S)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {CSRC / source}:\n{err}")
            os.replace(tmp, path)
            ptxas[source] = [l for l in (out + err).splitlines() if "ptxas" in l]
    finally:
        for proc, tmp, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return {s: (ctypes.CDLL(str(lib_path(s))), ptxas.get(s, [])) for s in sources}


def build(source: str) -> Tuple[ctypes.CDLL, List[str]]:
    """Compile csrc/<source> (if not built yet) and load it.

    Returns (library, the -Xptxas -v lines of this build; empty if the
    library was already built)."""
    return build_many([source])[source]
