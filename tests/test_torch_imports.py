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


# the region store, the runtime and the RT half of the WSI pipeline
RUNTIME_SLICE = (
    "repro_torch.core.bbox", "repro_torch.core.hilbert", "repro_torch.core.pacing",
    "repro_torch.core.regions", "repro_torch.storage.membership",
    "repro_torch.storage.placement", "repro_torch.storage.disk", "repro_torch.storage.tiers",
    "repro_torch.storage.dms", "repro_torch.storage.codec", "repro_torch.runtime.dag",
    "repro_torch.runtime.scheduler", "repro_torch.runtime.manager",
    "repro_torch.runtime.prefetch", "repro_torch.pipeline.wsi",
)
# the decoder-only families: their configs (the models' modules are listed below)
FAMILIES_SLICE = tuple(f"repro_torch.configs.{m}" for m in (
    "qwen3_0_6b", "gemma_2b", "granite_20b", "internvl2_1b", "nemotron_4_340b",
    "deepseek_v2_lite_16b", "qwen3_moe_235b_a22b", "mamba2_2_7b", "seamless_m4t_large_v2"))
# the encoder-decoder family and the training path
TRAINING_SLICE = (
    "repro_torch.models.encdec", "repro_torch.storage.checkpoint", "repro_torch.train",
    "repro_torch.train.optim", "repro_torch.train.step", "repro_torch.data",
    "repro_torch.data.tokens", "repro_torch.data.loader", "repro_torch.launch.train",
)
# the multi-device machinery: meshes, cells, the dry run and its analysis,
# gradient compression
MESH_SLICE = (
    "repro_torch.launch.mesh", "repro_torch.launch.cells", "repro_torch.launch.dryrun",
    "repro_torch.analysis", "repro_torch.analysis.roofline", "repro_torch.analysis.cost",
    "repro_torch.train.compression",
)
# the near-data chains and the serving tier, with the storage modules it needs
SERVING_SLICE = (
    "repro_torch.kernels.chains", "repro_torch.serve.fair", "repro_torch.serve.rcache",
    "repro_torch.serve.gateway", "repro_torch.serve.compute", "repro_torch.storage.shm",
    "repro_torch.storage.net", "repro_torch.storage.stcache", "repro_torch.storage.autotune",
)


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
                "repro_torch.launch.serve", "repro_torch.convert", *RUNTIME_SLICE,
                *SERVING_SLICE, *FAMILIES_SLICE, *TRAINING_SLICE, *MESH_SLICE):
        assert new in mods, new
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.')\n"
        "             or m == 'ml_dtypes' or m.startswith('ml_dtypes.'))\n"
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
        ROOT / "scripts" / "profile_train_torch.py", ROOT / "scripts" / "probe_gloo_cuda.py",
        ROOT / "scripts" / "sharded_cards.py",
        ROOT / "examples" / "serve_lm_torch.py", ROOT / "examples" / "wsi_pipeline_torch.py",
        ROOT / "examples" / "quickstart_torch.py", ROOT / "examples" / "serve_regions_torch.py",
        ROOT / "examples" / "train_lm_torch.py",
    ]
    offenders = {
        str(f.relative_to(ROOT)): sorted(set(_imported_roots(f)) & {"jax", "jaxlib", "repro"})
        for f in files
    }
    assert {f: r for f, r in offenders.items() if r} == {}


def test_the_dry_run_cli_imports_neither_jax_nor_repro():
    """``python -m repro_torch.launch.dryrun --list`` in a fresh interpreter:
    the cell table, and no JAX, no module of the JAX package and no
    ``ml_dtypes`` among its imports; nor does it start a process group."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['dryrun', '--list']\n"
        "runpy.run_module('repro_torch.launch.dryrun', run_name='__main__')\n"
        "import torch.distributed as dist\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro', 'ml_dtypes'))\n"
        "print('BAD', bad, 'PG', dist.is_initialized())\n"
        "sys.exit(1 if bad or dist.is_initialized() else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "qwen3-0.6b" in proc.stdout and "long_500k" in proc.stdout
    assert "BAD [] PG False" in proc.stdout


def test_relint_is_clean_on_the_port():
    """The port carries copies of the locking code of the region store and
    the runtime; the concurrency lint checks them as it checks ``repro``."""
    proc = subprocess.run([sys.executable, "-m", "tools.relint", "src/repro_torch"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


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


def test_encdec_and_training_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.configs import get_config
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import EncDec
    from repro_torch.train import AdamW, init_state

    with pytest.raises(RuntimeError, match="CUDA"):
        EncDec(get_config("seamless-m4t-large-v2").scaled_down())
    with pytest.raises(RuntimeError, match="CUDA"):
        init_state(get_config("qwen3-0.6b").scaled_down(), AdamW())
    with pytest.raises(RuntimeError, match="CUDA"):
        train_main(["--smoke", "--steps", "1", "--ckpt-dir", str(tmp_path)])


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


def test_the_storage_server_imports_neither_jax_nor_repro():
    """``python -m repro_torch.storage.net`` is what ``ServerProcess``
    spawns: its imports, in a fresh interpreter, hold no JAX, no module of
    the JAX package and no ``ml_dtypes``."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['net', '--help']\n"
        "try:\n"
        "    runpy.run_module('repro_torch.storage.net', run_name='__main__')\n"
        "except SystemExit:\n"
        "    pass\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro', 'ml_dtypes'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "repro_torch.storage.net" in proc.stdout  # the server's own usage line


def test_serving_tier_raises_without_cuda():
    """The gateway, its compute engine and its prefetcher run on the card
    unless given ``device="cpu"``; none of them falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.core import BoundingBox
    from repro_torch.kernels.chains import resolve_chain
    from repro_torch.pipeline import make_wsi_storage
    from repro_torch.serve import ComputeEngine, GatewayConfig, RegionGateway, WindowPrefetcher
    from repro_torch.serve.gateway import GatewayStats
    from repro_torch.serve.rcache import GenerationTracker, ResponseCache
    from repro_torch.storage import DistributedMemoryStorage

    store = DistributedMemoryStorage(BoundingBox((0, 0), (8, 8)), (8, 8), 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        RegionGateway(store)
    with pytest.raises(RuntimeError, match="CUDA"):
        ComputeEngine(store, GatewayConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        WindowPrefetcher(store, ResponseCache(1 << 20), GenerationTracker(store),
                         GatewayStats())
    with pytest.raises(RuntimeError, match="CUDA"):
        make_wsi_storage(8, 8, serve=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_chain("deconv")(np.ones((3, 8, 8), np.float32))
    with pytest.raises(ValueError, match="compute_impl"):
        GatewayConfig(compute_impl="xla")
    gw = RegionGateway(store, device="cpu", config=GatewayConfig(prefetch=True))
    assert gw.device.type == "cpu" and gw.engine.device.type == "cpu"
    gw.close()
