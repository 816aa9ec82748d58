"""Run a function in several ``gloo`` processes on the CPU, for the port's
sharded tests: ``spawn(fn, world, *args)`` starts ``world`` processes,
each with its default process group (a file store under a temporary
directory; no network), calls ``fn(rank, *args)`` in each and returns what
rank 0's call returned. A failure in any rank fails the call."""
import os
import pickle
import sys
import tempfile
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def _worker(rank: int, world: int, store: str, out: str, fn, args) -> None:
    if SRC not in sys.path:
        sys.path.insert(0, SRC)
    # one intra-op thread a rank, at a lower priority: the ranks' sizes are
    # tiny, and a world of busy ranks would starve the other test workers'
    # timing-sensitive threads
    torch.set_num_threads(1)
    os.nice(10)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        result = fn(rank, *args)
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(result, f)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args):
    with tempfile.TemporaryDirectory(prefix="torch_dist_") as tmp:
        out = os.path.join(tmp, "result.pkl")
        mp.spawn(_worker, args=(world, os.path.join(tmp, "store"), out, fn, args),
                 nprocs=world, join=True)
        with open(out, "rb") as f:
            return pickle.load(f)
