"""What a run loads: no module whose whole top-level name is ``jax``,
``jaxlib``, ``flax`` or ``repro`` (the JAX package; ``repro_torch`` begins
with its name and is the system under test), nothing read from
``benchmarks/``, and a reference that loads nothing of the program. A run
without a card fails and prints no result."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

PROBE = r"""
import importlib, json, sys
sys.path[:0] = [{src!r}, {root!r}]
for name in {modules!r}:
    importlib.import_module(name)
for path in {files!r}:
    spec = importlib.util.spec_from_file_location("probe_" + str(abs(hash(path))), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
out = {{}}
for name, mod in list(sys.modules.items()):
    f = getattr(mod, "__file__", None) or ""
    out[name] = f
print(json.dumps(out))
"""


def loaded(modules: list[str], files: list[str] = ()) -> dict:
    code = PROBE.format(src=str(ROOT / "src"), root=str(ROOT), modules=modules, files=list(files))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def forbidden(mods: dict) -> list[str]:
    return sorted({n for n in mods if n.split(".")[0] in ("jax", "jaxlib", "flax", "repro")})


def from_benchmarks(mods: dict) -> list[str]:
    bench = str(ROOT / "benchmarks") + os.sep
    return sorted(n for n, f in mods.items() if f.startswith(bench))


def test_the_forms_readers_and_counts_load_no_jax_and_nothing_of_benchmarks():
    forms = [f"rtbench.forms.{p.stem}" for p in (ROOT / "rtbench/forms").glob("*.py")
             if p.stem != "__init__"]
    files = [str(p) for d in ("metrics", "counts") for p in (ROOT / "rtbench" / d).glob("*.py")]
    mods = loaded(["rtbench.harness", "rtbench.trace", "rtbench.control",
                   "repro_torch.pipeline", "repro_torch.serve", "repro_torch.runtime",
                   "repro_torch.storage", *forms], files)
    assert "repro_torch" in mods  # the system under test is there
    assert forbidden(mods) == []
    assert from_benchmarks(mods) == []


def test_the_reference_loads_nothing_of_the_program():
    mods = loaded(["rtbench.reference", "rtbench.compare", "rtbench.tiles"])
    assert [n for n in mods if n.split(".")[0] == "repro_torch"] == []
    assert forbidden(mods) == [] and from_benchmarks(mods) == []
    src = (ROOT / "rtbench/reference.py").read_text()
    assert "repro" not in src.replace("reproduce", "")


def run_cli(cwd: Path, **env) -> subprocess.CompletedProcess:
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"}, **env}
    return subprocess.run([sys.executable, "rtbench/run.py", "--workload", "plain-4k", "--seed",
                           str(2**31 + 77), "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, cwd=str(cwd), env=env)


def test_a_run_without_a_card_fails_and_prints_no_result():
    out = run_cli(ROOT, CUDA_VISIBLE_DEVICES="")
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_a_checkout_of_only_the_benchmark_fails_and_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "rtbench", tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_cli(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
