"""Guards of the port's independence from JAX and of its device rules.

  * no file of `hanabi_sad_tpu_torch/`, nor `chip_smoke.py`, imports jax,
    optax or the JAX package;
  * importing the whole port and loading the flagship checkpoint leaves jax
    and `hanabi_sad_tpu` out of sys.modules;
  * `chip_smoke.py` fails, and prints no result, without a CUDA card and
    without the port beside it;
  * an entry point asked for no device raises where there is no CUDA card."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from hanabi_sad_tpu_torch.game.env import EnvConfig, HanabiEnv
from hanabi_sad_tpu_torch.tools import eval_model, loaders

ROOT = Path(__file__).resolve().parents[1]
FLAGSHIP = "docs/runs/sad_aux_r4_soup10.pkl"
FORBIDDEN = {"jax", "jaxlib", "optax", "hanabi_sad_tpu"}


def port_files():
    return sorted((ROOT / "hanabi_sad_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_port_file_imports_jax_or_the_jax_package():
    files = port_files()
    assert len(files) > 10
    offenders = [
        (str(f.relative_to(ROOT)), m)
        for f in files
        for m in imported_modules(f)
        if m.split(".")[0] in FORBIDDEN
    ]
    assert offenders == []


def test_port_and_checkpoint_load_need_no_jax():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import hanabi_sad_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from hanabi_sad_tpu_torch.train import checkpoint\n"
        f"payload = checkpoint.load({FLAGSHIP!r})\n"
        "assert payload['kind'] == 'params'\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "    if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'hanabi_sad_tpu'))))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True, text=True, timeout=60
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True, timeout=60
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_entry_points_without_a_device_raise_on_a_cpu_only_machine():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        HanabiEnv(EnvConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        loaders.load_any(str(ROOT / FLAGSHIP))
    with pytest.raises(RuntimeError, match="CUDA"):
        eval_model.main(["--weight", str(ROOT / FLAGSHIP), "--num_game", "2"])
