"""Multi-pod dry run: trace every (arch x shape) cell on the production
meshes and emit roofline artifacts (``repro.launch.dryrun``).

The reference lowers and compiles each cell for 256 or 512 host devices
that an ``XLA_FLAGS`` line makes at import. Here ``main()`` makes a
``"fake"`` process group of 256 or 512 ranks in this one process
(``launch.mesh.fake_world``), and each cell's step runs once as rank 0 on
meta-device DTensors (``launch.cells.trace_cell``), with the cost counter
(``analysis/cost.py``) in place of the HLO analyzer. Importing this module
starts no process group.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --shape train_4k --mesh multi --attn-impl chunked
  PYTHONPATH=src python -m repro_torch.launch.dryrun --list

Artifacts: artifacts/dryrun/<arch>__<shape>__<mesh>.json with the
reference's keys. What differs:
  * ``lower_s`` is the trace's seconds; ``compile_s`` is 0.0 (nothing is
    compiled: the ops run eagerly on meta tensors);
  * ``memory_analysis`` holds the argument and output bytes of rank 0's
    local shards. It has no temp size: an eager trace on meta tensors
    allocates nothing, so there is no buffer assignment to read a peak
    from (nor aliasing or generated code);
  * ``xla_cost_analysis`` holds the counter's totals (there is no XLA),
    ``hlo`` the counter's ``as_dict()`` and ``hlo_bytes_len`` 0 (there is
    no HLO text);
  * the roofline terms are on one H100 SXM a rank (``analysis.roofline``):
    predictions of a bound, not measurements.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from collections import Counter

import torch
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_leaves

from repro_torch.analysis.roofline import compute_terms, model_flops
from repro_torch.configs import SHAPES, all_cells, cell_supported, get_config
from repro_torch.convert import reference_leaves
from repro_torch.models import registry as model_registry
from repro_torch.models.spec import seq_parallel_rules


def _local_bytes(tree) -> int:
    """Bytes of rank 0's local shards of every tensor in a tree (a module
    counts its parameters)."""
    total = 0
    for leaf in tree_leaves(tree, is_leaf=lambda x: isinstance(x, torch.nn.Module)):
        if isinstance(leaf, torch.nn.Module):
            total += _local_bytes([t for v in reference_leaves(leaf).values()
                                   for t in (v if isinstance(v, list) else [v])])
        elif isinstance(leaf, torch.Tensor):
            t = leaf.to_local() if isinstance(leaf, DTensor) else leaf
            total += t.numel() * t.element_size()
    return total


@contextlib.contextmanager
def sequential_collectives():
    """Count, while the block runs, the DTensor redistributions that run as
    several sequential collectives, one a mesh axis: the events behind
    DTensor's "N sequential all_reduce operations" warning, which it prints
    once per (mesh, axes). Yields a ``Counter`` keyed by collective, number
    of collectives, the axes' names and DTensor's reason, e.g. ``all_reduce
    x2 (pod, data) no_flattened_mesh``; None on a torch whose redistribute
    has no such merge (it then issues one collective a mesh axis, and says
    nothing)."""
    from torch.distributed.tensor import _redistribute

    warn = getattr(_redistribute, "_warn_flatten_optimization_not_possible", None)
    if warn is None:
        yield None
        return
    counts: Counter = Counter()

    def counting(device_mesh, mesh_dims, src_placements, dst_placements, num_ops,
                 comm_type, reason):
        names = ", ".join(device_mesh.mesh_dim_names[d] for d in mesh_dims)
        counts[f"{comm_type} x{num_ops} ({names}) {reason}"] += 1
        return warn(device_mesh, mesh_dims, src_placements, dst_placements, num_ops,
                    comm_type, reason)

    _redistribute._warn_flatten_optimization_not_possible = counting
    try:
        yield counts
    finally:
        _redistribute._warn_flatten_optimization_not_possible = warn


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    outdir: str,
    *,
    zero1: bool = False,
    skip_hlo: bool = False,
    cfg_overrides: dict | None = None,
    seq_shard_cache: bool = False,
    seq_parallel: bool = False,
    tag: str = "",
) -> dict:
    """Trace one cell on the production mesh (a fake world of its size is
    made here) and write its artifact; returns the record."""
    from repro_torch.launch.cells import build_cell, trace_cell
    from repro_torch.launch.mesh import fake_world, make_production_mesh

    mesh_name = "multi" if multi_pod else "single"
    record: dict = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "zero1": zero1,
        "status": "ok",
        "tag": tag,
        "cfg_overrides": {k: str(v) for k, v in (cfg_overrides or {}).items()},
        "seq_shard_cache": seq_shard_cache,
        "seq_parallel": seq_parallel,
    }
    t0 = time.time()
    try:
        fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod)
        chips = mesh.size()
        cell = build_cell(
            arch, shape_name, mesh, zero1=zero1, cfg_overrides=cfg_overrides,
            seq_shard_cache=seq_shard_cache,
            rules=seq_parallel_rules() if seq_parallel else None,
        )
        record["chips"] = int(chips)
        record["mesh_shape"] = {k: int(v) for k, v in zip(mesh.mesh_dim_names,
                                                           mesh.mesh.shape)}
        record["kind"] = cell.meta["kind"]
        record["tokens_per_step"] = int(cell.meta["tokens"])

        out, cost, trace_s = trace_cell(cell, mesh, count=not skip_hlo)
        record["lower_s"] = round(trace_s, 2)
        record["compile_s"] = 0.0
        record["memory_analysis"] = {"argument_size_in_bytes": _local_bytes(cell.args),
                                     "output_size_in_bytes": _local_bytes(out)}
        del out
        if cost is not None:
            record["xla_cost_analysis"] = {"flops": cost.flops, "bytes_accessed": cost.bytes}
            record["hlo_bytes_len"] = 0
            record["hlo_analysis_s"] = 0.0
            record["hlo"] = cost.as_dict()
            cfg = cell.cfg
            n_active = model_registry.count_active_params(cfg)
            training = cell.meta["kind"] == "train"
            mf = model_flops(n_active, cell.meta["tokens"], training=training)
            terms = compute_terms(
                flops_per_chip=cost.flops,
                bytes_per_chip=cost.bytes,
                collective_bytes_per_chip=cost.collective_bytes,
                chips=chips,
                model_flops_total=mf,
            )
            record["roofline"] = terms.as_dict()
            record["n_params"] = model_registry.count_params(cfg)
            record["n_active_params"] = n_active
    except Exception as e:  # noqa: BLE001  (recorded in the artifact, counted by main)
        record["status"] = "error"
        record["error"] = repr(e)
        record["traceback"] = traceback.format_exc()[-4000:]
    record["total_s"] = round(time.time() - t0, 2)

    os.makedirs(outdir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = os.path.join(outdir, f"{arch}__{shape_name}__{mesh_name}{suffix}.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=2)
    status = record["status"]
    extra = ""
    if status == "ok" and "roofline" in record:
        r = record["roofline"]
        extra = (
            f" compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s "
            f"coll={r['collective_s']:.4f}s bottleneck={r['bottleneck']}"
        )
    print(f"[{status}] {arch} x {shape_name} x {mesh_name}{suffix} "
          f"({record['total_s']}s){extra}", flush=True)
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true",
                    help="run every supported cell (of --arch and --shape where given)")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--skip-hlo", action="store_true", help="trace without the cost counter")
    ap.add_argument("--tag", default="")
    ap.add_argument("--attn-impl", default=None, choices=["torch", "chunked"])
    ap.add_argument("--remat", default=None, choices=["none", "dots", "full"])
    ap.add_argument("--moe-groups", type=int, default=None)
    ap.add_argument("--seq-shard-cache", action="store_true")
    ap.add_argument("--ssm-chunk", type=int, default=None)
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--seq-parallel", action="store_true",
                    help="Megatron-style sequence-parallel residual activations")
    args = ap.parse_args(argv)

    overrides: dict = {}
    if args.attn_impl:
        overrides["attn_impl"] = args.attn_impl
    if args.remat:
        overrides["remat"] = args.remat
    if args.moe_groups:
        overrides["moe_groups"] = args.moe_groups
    if args.ssm_chunk:
        overrides["ssm_chunk"] = args.ssm_chunk
    if args.capacity_factor:
        overrides["capacity_factor"] = args.capacity_factor

    if args.list:
        for arch, shape, ok, why in all_cells():
            print(f"{arch:24s} {shape:12s} {'RUN' if ok else 'SKIP: ' + why}")
        return

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    if args.all:
        cells = [(a, s) for a, s, ok, _ in all_cells()
                 if ok and args.arch in (None, a) and args.shape in (None, s)]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all/--list")
        ok, why = cell_supported(get_config(args.arch), args.shape)
        if not ok:
            print(f"SKIP {args.arch} x {args.shape}: {why}")
            return
        cells = [(args.arch, args.shape)]

    failures = 0
    for arch, shape in cells:
        for mp in meshes:
            rec = run_cell(
                arch, shape, mp, args.out, zero1=args.zero1,
                skip_hlo=args.skip_hlo, tag=args.tag,
                cfg_overrides=overrides or None,
                seq_shard_cache=args.seq_shard_cache,
                seq_parallel=args.seq_parallel,
            )
            failures += rec["status"] != "ok"
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")


if __name__ == "__main__":
    main()
