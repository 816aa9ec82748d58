"""Which collectives ``gloo`` carries for CUDA tensors, each tried in a fresh
pair of processes on one card (a crash ends only its own pair): the c10d
calls, the functional collectives that DTensor issues, and two DTensor
redistributions. Prints one ``GLOO_CUDA <collective> <elements> ok|FAILS``
line each.

    python scripts/probe_gloo_cuda.py        # needs a CUDA card
"""
import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

PROBES = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
          "reduce_scatter_tensor", "all_to_all_single", "funcol_all_reduce",
          "funcol_all_gather_tensor", "dtensor_full_tensor", "dtensor_reduce_scatter")


def probe(rank: int, store: str, name: str, n: int) -> None:
    import torch.distributed._functional_collectives as fc
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Partial, Shard

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=2)
    x = torch.full((n,), float(rank + 1), device="cuda")
    world = dist.group.WORLD
    if name == "all_reduce":
        dist.all_reduce(x)
    elif name == "broadcast":
        dist.broadcast(x, 0)
    elif name == "all_gather":
        dist.all_gather([torch.empty_like(x) for _ in range(2)], x)
    elif name == "all_gather_into_tensor":
        dist.all_gather_into_tensor(torch.empty(2 * n, device="cuda"), x)
    elif name == "reduce_scatter_tensor":
        dist.reduce_scatter_tensor(torch.empty(n // 2, device="cuda"), x)
    elif name == "all_to_all_single":
        dist.all_to_all_single(torch.empty_like(x), x)
    elif name == "funcol_all_reduce":
        fc.wait_tensor(fc.all_reduce(x, "sum", world))
    elif name == "funcol_all_gather_tensor":
        fc.wait_tensor(fc.all_gather_tensor(x, 0, world))
    else:
        mesh = DeviceMesh("cuda", torch.arange(2), mesh_dim_names=("data",))
        if name == "dtensor_full_tensor":
            DTensor.from_local(x, mesh, [Shard(0)], run_check=False).full_tensor()
        else:  # a partial sum to shards: a reduce-scatter
            DTensor.from_local(x, mesh, [Partial()], run_check=False).redistribute(
                mesh, [Shard(0)]).to_local()
    torch.cuda.synchronize()
    dist.destroy_process_group()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_gloo_cuda: needs a CUDA card")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    for name in PROBES:
        for n in (4, 151936):
            with tempfile.TemporaryDirectory() as tmp:
                try:
                    mp.spawn(probe, args=(os.path.join(tmp, "store"), name, n), nprocs=2,
                             join=True)
                    print("GLOO_CUDA", name, n, "ok", flush=True)
                except Exception as e:  # noqa: BLE001  (the result of the probe)
                    print("GLOO_CUDA", name, n, "FAILS:", type(e).__name__,
                          str(e).splitlines()[-1][:160], flush=True)


if __name__ == "__main__":
    main()
