"""The PyTorch port stands alone: it imports neither JAX nor anything of
the reference package ``repro``, and it never runs on the CPU unasked."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.config import get_config
from repro_torch.launch import serve
from repro_torch.models import Model
from repro_torch.platform import Platform, PlatformSpec
from repro_torch.platform import compute as pc
from repro_torch.serving import ServingEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def test_import_loads_no_jax_and_no_reference_module():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.platform, repro_torch.kernels.ops\n"
        "import repro_torch.data, repro_torch.core\n"
        "import repro_torch.config, repro_torch.configs.rwkv6_7b\n"
        "import repro_torch.models, repro_torch.models.convert\n"
        "import repro_torch.serving, repro_torch.launch.serve\n"
        "import repro_torch.kernels.rwkv6_scan\n"
        "import repro_torch.kernels.subsample_gather\n"
        "import repro_torch.kernels.rglru_scan\n"
        "import repro_torch.kernels.flash_attention\n"
        "import repro_torch.kernels.subsample_grid\n"
        "import repro_torch.core.subsample\n"
        "import repro_torch.models.rglru\n"
        "import repro_torch.configs.recurrentgemma_2b\n"
        "import repro_torch.core.datastore, repro_torch.core.tiny_task\n"
        "import repro_torch.platform.faults, repro_torch.checkpoint\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "bad = [m for m in sys.modules if m == 'repro' "
        "or m.startswith('repro.')]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(PORT.parent)})
    assert proc.returncode == 0, proc.stderr


def test_no_source_file_imports_jax_or_the_reference():
    pattern = re.compile(r"^\s*(import jax|from jax|from repro\.|"
                         r"import repro\.|import repro$|from repro import)",
                         re.MULTILINE)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders


def test_default_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Platform(PlatformSpec())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pc.BlockArena(device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(get_config("rwkv6-7b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(Model(serve.reduced_variant(get_config("rwkv6-7b"))),
                      params=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "rwkv6-7b", "--reduced"])
