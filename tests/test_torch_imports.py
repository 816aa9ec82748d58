"""The port stands alone: no JAX, no module of the JAX package, and no quiet
fall-back to the CPU when CUDA is missing."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        mods.append(".".join(parts))
    return mods


def test_importing_every_port_module_loads_neither_jax_nor_repro():
    mods = _port_modules()
    assert "repro_torch.kernels.ops" in mods and "repro_torch.pipeline.wsi" in mods
    for new in ("repro_torch.kernels.flash_attention", "repro_torch.kernels.ssd_scan",
                "repro_torch.models.config", "repro_torch.models.spec",
                "repro_torch.models.layers", "repro_torch.models.transformer",
                "repro_torch.models.registry", "repro_torch.configs.registry",
                "repro_torch.configs.hymba_1_5b", "repro_torch.serve.step",
                "repro_torch.launch.serve", "repro_torch.convert"):
        assert new in mods, new
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_source_of_the_port_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "scripts" / "profile_lm_torch.py",
        ROOT / "examples" / "serve_lm_torch.py",
    ]
    offenders = {
        str(f.relative_to(ROOT)): sorted(set(_imported_roots(f)) & {"jax", "jaxlib", "repro"})
        for f in files
    }
    assert {f: r for f, r in offenders.items() if r} == {}


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.configs.wsi import WSIConfig
    from repro_torch.pipeline import (
        analyze_tile,
        compute_features,
        extract_object_rois,
        segment_tile,
    )

    rgb = np.full((3, 16, 16), 0.9, np.float32)
    cfg = WSIConfig()
    with pytest.raises(RuntimeError, match="CUDA"):
        analyze_tile(rgb, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        segment_tile(rgb, cfg, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        extract_object_rois(np.full((4, 4), -1, np.int32), np.zeros((4, 4), np.float32), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        compute_features(np.zeros((1, 8, 8), np.float32), cfg)


def test_lm_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import HybridLM
    from repro_torch.serve import generate

    cfg = get_config("hymba-1.5b").scaled_down()
    with pytest.raises(RuntimeError, match="CUDA"):
        HybridLM(cfg)
    model = HybridLM(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        generate(model, cfg, np.zeros((1, 4), np.int32), max_new=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_main(["--arch", "hymba-1.5b", "--smoke", "--requests", "1"])


def _run_smoke(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                          text=True, timeout=60, env=env)


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
