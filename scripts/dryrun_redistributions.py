"""The dry run (``repro_torch.launch.dryrun``, same arguments), with each
cell's record also counting the DTensor redistributions that run as several
sequential collectives over mesh axes DTensor could not flatten into one
group: the events behind its "N sequential all_reduce operations" warning,
which DTensor prints only once per (mesh, axes). Each count is keyed by
collective, number of collectives and the axes' names, e.g.
``all_reduce x3 (pod, data, model)``; the record keeps them under
``sequential_collectives`` and the line printed for the cell shows them.

    PYTHONPATH=src python scripts/dryrun_redistributions.py --all --shape train_4k --mesh multi
"""
import json
import os
import sys
from collections import Counter

import torch.distributed.tensor._redistribute as _redistribute

from repro_torch.launch import dryrun

_counts: Counter = Counter()
_warn = _redistribute._warn_flatten_optimization_not_possible


def _counting_warn(device_mesh, mesh_dims, src_placements, dst_placements, num_ops,
                   comm_type, reason):
    names = ", ".join(device_mesh.mesh_dim_names[d] for d in mesh_dims)
    _counts[f"{comm_type} x{num_ops} ({names})"] += 1
    return _warn(device_mesh, mesh_dims, src_placements, dst_placements, num_ops,
                 comm_type, reason)


_run_cell = dryrun.run_cell


def _counting_run_cell(arch, shape_name, multi_pod, outdir, **kw):
    _counts.clear()
    rec = _run_cell(arch, shape_name, multi_pod, outdir, **kw)
    rec["sequential_collectives"] = dict(_counts)
    suffix = f"__{kw['tag']}" if kw.get("tag") else ""
    path = os.path.join(outdir, f"{arch}__{shape_name}__{rec['mesh']}{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=2)
    print(f"  sequential collectives: {json.dumps(rec['sequential_collectives'])}", flush=True)
    return rec


_redistribute._warn_flatten_optimization_not_possible = _counting_warn
dryrun.run_cell = _counting_run_cell

if __name__ == "__main__":
    dryrun.main(sys.argv[1:])
