"""The control of the comparison that decides ``correct``: the plain
reference computed in the precision below the configuration's (bfloat16
for float32) and put in the program's place, on a cell's own inputs and
sizes. It must come out as not correct.

    python3 rtbench/control.py --workload <cell> --seeds <n> [<n> ...]

prints one JSON line a seed: the numbers the control reads, each beside its
limit, and whether the limits fail it. The benchmark's runs never run it.
"""
from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path.pop(0)
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

LOWER = {"float32": "bfloat16"}  # the precision below the configuration's


def readings(workload: str, seed: int, device, root=None) -> dict:
    """One seed's control readings and the cell's verdict on them."""
    import importlib
    from pathlib import Path

    import torch

    from rtbench import compare, harness

    cell = harness.load_cell(workload, Path(root) if root else harness.ROOT)
    config, traffic = cell["config_data"], cell["traffic_data"]
    dtype = getattr(torch, LOWER[config["precision"]])
    form_mod = importlib.import_module(f"rtbench.forms.{traffic['form']}")
    form = form_mod.Form(harness.Ctx(workload, config, traffic, seed, torch.device(device)))
    form.make_inputs()
    numbers = form.control(torch.device(device), dtype)
    limits = {k: v for k, v in config["limits"].items() if k != "failed_share"}
    correct, checks = compare.judge(numbers, limits)
    return {"workload": workload, "seed": seed, "dtype": str(dtype), "correct": correct,
            "checks": checks}


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
