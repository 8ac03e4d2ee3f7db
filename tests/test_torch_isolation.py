"""Guards of the port's independence from JAX and of its device rules.

  * no file of `hanabi_sad_tpu_torch/`, nor `chip_smoke.py`, nor the
    data-parallel tests' rank worker, nor a `scripts/torch_*.py` tool,
    imports jax, optax or the JAX package;
  * importing the whole port and loading the flagship checkpoint leaves jax
    and `hanabi_sad_tpu` out of sys.modules, and so do restoring the JAX
    package's train_state payload and writing one;
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
LATEST = "docs/runs/sad_aux_r1_latest.pkl"
FORBIDDEN = {"jax", "jaxlib", "optax", "hanabi_sad_tpu"}


def port_files():
    return sorted((ROOT / "hanabi_sad_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "torch_multihost_worker.py"] + sorted(
        (ROOT / "scripts").glob("torch_*.py"))


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


@pytest.mark.parametrize("module", [
    "hanabi_sad_tpu_torch/ops/sample_batch.py", "hanabi_sad_tpu_torch/train/checkpoint.py",
    "hanabi_sad_tpu_torch/train/selfplay.py", "hanabi_sad_tpu_torch/utils/saver.py",
    "hanabi_sad_tpu_torch/utils/helper.py", "scripts/torch_sample_batch_ab.py",
])
def test_slice_4_modules_import_no_jax(module):
    path = ROOT / module
    assert path in port_files() or module.startswith("scripts/")
    assert [m for m in imported_modules(path) if m.split(".")[0] in FORBIDDEN] == []


@pytest.mark.parametrize("module", [
    "hanabi_sad_tpu_torch/models/torch_import.py", "hanabi_sad_tpu_torch/tools/crossplay_matrix.py",
    "hanabi_sad_tpu_torch/tools/loaders.py", "hanabi_sad_tpu_torch/tools/eval_model.py",
    "hanabi_sad_tpu_torch/game/env.py", "hanabi_sad_tpu_torch/game/encoder.py",
    "hanabi_sad_tpu_torch/rollout/continuous.py", "scripts/jax_warmstart_reference.py",
])
def test_slice_7_modules_import_no_jax(module):
    """The Other-Play slice's modules import no JAX; the JAX reference
    script is the one file here that must (it runs the JAX package)."""
    path = ROOT / module
    bad = [m for m in imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    if module.startswith("scripts/"):
        assert path not in port_files() and "jax" in bad
    else:
        assert path in port_files() and bad == []


@pytest.mark.parametrize("module", [
    "hanabi_sad_tpu_torch/models/public_lstm.py", "hanabi_sad_tpu_torch/tools/action_matrix.py",
    "hanabi_sad_tpu_torch/tools/convert_model.py", "hanabi_sad_tpu_torch/tools/bench_train.py",
    "hanabi_sad_tpu_torch/utils/belief.py", "hanabi_sad_tpu_torch/utils/asserts.py",
])
def test_slice_9_modules_import_no_jax(module):
    """OBL's net, the analysis and export tools and the last utils keep
    their own copies of what they need from the JAX package."""
    path = ROOT / module
    assert path in port_files()
    assert [m for m in imported_modules(path) if m.split(".")[0] in FORBIDDEN] == []


def test_pthw_loading_and_crossplay_need_no_jax(tmp_path):
    """A reference state dict saved with torch.save loads through
    load_any into a policy, and the cross-play tool imports, with neither jax
    nor the JAX package imported."""
    code = (
        "import json, sys, torch\n"
        "H, F, A = 8, 838, 21\n"
        "sd = {'net.0.weight': torch.zeros(H, F), 'net.0.bias': torch.zeros(H)}\n"
        "for k in range(2):\n"
        "    sd.update({f'lstm.weight_ih_l{k}': torch.zeros(4 * H, H), f'lstm.weight_hh_l{k}': torch.zeros(4 * H, H),\n"
        "               f'lstm.bias_ih_l{k}': torch.ones(4 * H), f'lstm.bias_hh_l{k}': torch.ones(4 * H)})\n"
        "for name, d in (('fc_v', 1), ('fc_a', A), ('pred', 15)):\n"
        "    sd.update({f'{name}.weight': torch.zeros(d, H), f'{name}.bias': torch.zeros(d)})\n"
        f"torch.save(sd, {str(tmp_path / 'm.pthw')!r})\n"
        "from hanabi_sad_tpu_torch.tools import crossplay_matrix, loaders\n"
        f"pol = loaders.load_any({str(tmp_path / 'm.pthw')!r}, device='cpu')\n"
        "print(json.dumps([float(pol.params.online.lstm[1]['b'][0]), sorted(m for m in sys.modules\n"
        "    if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'hanabi_sad_tpu'))]))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == [2.0, []]


def test_train_state_payloads_load_and_save_without_jax(tmp_path):
    """The JAX package's flagship train_state payload (optax classes
    inside) restores into the port, and the port writes one back, with
    neither jax, optax nor the JAX package imported."""
    code = (
        "import json, sys\n"
        "from hanabi_sad_tpu_torch.train import checkpoint, learner, config\n"
        f"payload = checkpoint.load({str(ROOT / LATEST)!r})\n"
        "setup = learner.make_setup(config.make_config('sad_2p', pred_weight=0.25, replay_buffer_size=64,"
        " num_envs=2, max_len=8))\n"
        "state = checkpoint.restore_train_state(payload, learner.init_train_state(setup, 0, 'cpu'))\n"
        f"checkpoint.save({str(tmp_path / 'again.pkl')!r}, checkpoint.train_state_payload(state, {{}}))\n"
        "print(json.dumps([state.num_update, sorted(m for m in sys.modules\n"
        "    if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'hanabi_sad_tpu'))]))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == [798560, []]


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


@pytest.mark.parametrize("module", ["scripts/torch_learning_curve.py", "scripts/torch_train_chunk_profile.py"])
def test_slice_11_scripts_are_port_files_and_import_no_jax(module):
    """The learning-curve script (it reads the JAX runs' logs as text) and
    the other torch scripts are held to the port's rule."""
    path = ROOT / module
    assert path in port_files()
    assert [m for m in imported_modules(path) if m.split(".")[0] in FORBIDDEN] == []
