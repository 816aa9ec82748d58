"""Registers, spills and shared memory of every kernel the port builds.

Compiles each source under ``src/repro_torch/kernels/csrc/`` (or under the
directory given with ``--csrc``) with the build's own ``nvcc`` flags plus
``-Xptxas -v``, one ``nvcc`` a source, all started together, and prints one
JSON line a kernel instance: its demangled name, registers a thread, spill
stores and loads in bytes, stack frame and static shared memory. Needs
``nvcc``, so it runs on the machine with the card:

    python3 scripts/ptxas_usage.py [--csrc DIR] [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402

ENTRY = re.compile(r"Compiling entry function '([^']+)'")
USED = re.compile(r"Used (\d+) registers")
SMEM = re.compile(r"(\d+) bytes smem")
FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")


def demangle(names: list[str]) -> list[str]:
    tool = shutil.which("c++filt") or shutil.which("cu++filt")
    if tool is None:
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    lines = out.stdout.splitlines()
    return lines if out.returncode == 0 and len(lines) == len(names) else names


def parse(source: str, log: str) -> list[dict]:
    """One record a kernel entry of ``log``, ptxas's verbose output."""
    recs: list[dict] = []
    for line in log.splitlines():
        if m := ENTRY.search(line):
            recs.append({"source": source, "kernel": m.group(1), "registers": None,
                         "spill_stores": 0, "spill_loads": 0, "stack_frame": 0, "smem": 0})
        elif recs and (m := FRAME.search(line)):
            recs[-1].update(stack_frame=int(m.group(1)), spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        elif recs and (m := USED.search(line)):
            recs[-1]["registers"] = int(m.group(1))
            if s := SMEM.search(line):
                recs[-1]["smem"] = int(s.group(1))
    for rec, name in zip(recs, demangle([r["kernel"] for r in recs])):
        rec["kernel"] = name
    return recs


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", type=Path, default=_build.CSRC)
    ap.add_argument("--out", type=Path, default=None, help="also write the records here")
    args = ap.parse_args(argv)
    nvcc = _build._nvcc()
    sources = sorted(args.csrc.glob("*.cu"))
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
                                   "-o", str(Path(tmp) / f"{src.stem}.o")],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src in sources]
        logs = [proc.communicate()[0] for proc in procs]
    recs = []
    for src, proc, log in zip(sources, procs, logs):
        if proc.returncode != 0:
            print(f"{src.name}: nvcc failed\n{log}", file=sys.stderr)
            return 1
        recs.extend(parse(src.name, log))
    lines = [json.dumps(r) for r in recs]
    print("\n".join(lines))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
