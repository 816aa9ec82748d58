"""The dry run (``repro_torch.launch.dryrun``, same arguments), with each
cell's record also counting the DTensor redistributions that run as several
sequential collectives over mesh axes DTensor could not flatten into one
group: the events behind its "N sequential all_reduce operations" warning,
which DTensor prints only once per (mesh, axes). Each count is keyed by
collective, number of collectives, the axes' names and DTensor's reason,
e.g. ``all_reduce x3 (pod, data, model) no_flattened_mesh``
(``dryrun.sequential_collectives``); the record keeps them under
``sequential_collectives`` (null on a torch whose redistribute merges
nothing and so names nothing) and the line printed for the cell shows
them. ``launch.mesh`` registers flattened submeshes for the meshes' axis
runs, so on a torch whose redistribute merges over them the reason
``no_flattened_mesh`` should not occur.

    PYTHONPATH=src python scripts/dryrun_redistributions.py --all --shape train_4k --mesh multi
"""
import json
import os
import sys

from repro_torch.launch import dryrun

_run_cell = dryrun.run_cell


def _counting_run_cell(arch, shape_name, multi_pod, outdir, **kw):
    with dryrun.sequential_collectives() as counts:
        rec = _run_cell(arch, shape_name, multi_pod, outdir, **kw)
    rec["sequential_collectives"] = None if counts is None else dict(counts)
    suffix = f"__{kw['tag']}" if kw.get("tag") else ""
    path = os.path.join(outdir, f"{arch}__{shape_name}__{rec['mesh']}{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=2)
    print(f"  sequential collectives: {json.dumps(rec['sequential_collectives'])}", flush=True)
    return rec


dryrun.run_cell = _counting_run_cell

if __name__ == "__main__":
    dryrun.main(sys.argv[1:])
