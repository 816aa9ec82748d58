"""The sharded paths on several cards over NCCL, against one rank: a
(data=2, model=2) mesh of four processes, one card each.

qwen3-0.6b at full width, 2 layers, float32: a prefill of 2 x 512 tokens
and 8 greedy tokens (each rank's attention on the kernel, on its half of
the heads; the logits gathered whole), one ZeRO-1 AdamW step (the
gradients all-reduced, the updated parameters all-gathered), and the state
saved one chunk a shard and restored on a (1, 4) mesh, each held against
the same work on one card (rank 0's, with no mesh). Then qwen3 with 2 KV
heads on (1, 4), where each rank projects V for its query heads' one KV
head (prefill logits and greedy tokens against one card); the ZeRO-1 step
on a (pod, data, model) = (2, 2, 1) mesh, whose gradients and gathers run
over the flattened (pod, data) group; and three saves of a tree sharded
over the four ranks at keep=2, after which every rank must list the last
two steps and refuse the first. Prints one JSON line.

    python scripts/sharded_cards.py                 # four cards (NCCL)
    python scripts/sharded_cards.py --device cpu    # a rehearsal: four gloo
                                                    # processes, scaled down
"""
import argparse
import copy
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import Replicate, Shard

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, MESH, OTHER = 4, (2, 2), (1, 4)
POD_MESH = dict(pod=2, data=2, model=1)  # ZeRO-1 over the flattened (pod, data) group
BATCH, SEQ, NEW, LAYERS = 2, 512, 8, 2


def rank_main(rank: int, device: str, store: str, ckdir: str, out: str) -> None:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build, shard_params
    from repro_torch.models.spec import activation_sharding, distribute, full
    from repro_torch.serve import generate, make_cache, make_prefill_step
    from repro_torch.serve.step import cache_shardings, shard_tree
    from repro_torch.storage import CheckpointManager, DiskStorage
    from repro_torch.storage.checkpoint import _leaf_paths, _to_host
    from repro_torch.train import AdamW, init_state, make_train_step, shard_state

    cuda = device == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD)
    try:
        cfg = get_config("qwen3-0.6b")
        cfg = (cfg if cuda else cfg.scaled_down(vocab=512)).replace(
            num_layers=LAYERS, param_dtype=torch.float32, compute_dtype=torch.float32)
        seq = SEQ if cuda else 32
        prompt = np.random.default_rng(3).integers(0, cfg.vocab, (BATCH, seq)).astype(np.int32)
        mesh = make_host_mesh(*MESH, device=dev.type)

        def sync():
            if cuda:
                torch.cuda.synchronize(dev)

        def flat(state) -> dict:
            leaves = {}
            for name, leaf in _leaf_paths(state):
                leaf = ([full(t) for t in leaf] if isinstance(leaf, list)
                        else full(leaf) if isinstance(leaf, torch.Tensor) else leaf)
                leaves[name] = _to_host(torch.stack(leaf) if isinstance(leaf, list) else leaf)[0]
            return leaves

        res: dict = {"rank": rank}
        with torch.no_grad():  # serving: one card, then the mesh
            model = build(cfg, device=dev, seed=0)
            batch = {"tokens": torch.as_tensor(prompt, device=dev)}
            want, _ = make_prefill_step(cfg)(model, batch, make_cache(cfg, BATCH, seq, device=dev))
            want_tok = generate(model, cfg, prompt, max_new=NEW, device=dev)
            sharded = shard_params(copy.deepcopy(model), mesh)
            del model
            with activation_sharding(mesh):
                cache = make_cache(cfg, BATCH, seq, device=dev)
                cache = shard_tree(cache, mesh, cache_shardings(cfg, cache, mesh))
                fa_mod.launches = 0
                sync()
                t0 = time.perf_counter()
                got, _ = make_prefill_step(cfg)(sharded, batch, cache)
                got = full(got)
                sync()
                res["prefill_s"] = time.perf_counter() - t0
                res["prefill_launches"] = fa_mod.launches
                tok = generate(sharded, cfg, prompt, max_new=NEW, device=dev)
            res["local_heads"] = [sharded.layers[0].attn.wq.to_local().shape[1],
                                  sharded.layers[0].attn.wk.to_local().shape[1]]
            res["logits_max_abs_err"] = (got - want).abs().max().item()
            res["tokens_equal"] = bool(torch.equal(tok, want_tok))
            del sharded, cache, got, want

            # 2 KV heads on a model axis of 4: V projected by rank
            kcfg = cfg.replace(num_kv_heads=2)
            model = build(kcfg, device=dev, seed=0)
            want, _ = make_prefill_step(kcfg)(model, batch,
                                              make_cache(kcfg, BATCH, seq, device=dev))
            want_tok = generate(model, kcfg, prompt, max_new=NEW, device=dev)
            other = make_host_mesh(*OTHER, device=dev.type)
            sharded = shard_params(model, other)
            with activation_sharding(other):
                cache = make_cache(kcfg, BATCH, seq, device=dev)
                cache = shard_tree(cache, other, cache_shardings(kcfg, cache, other))
                got = full(make_prefill_step(kcfg)(sharded, batch, cache)[0])
                tok = generate(sharded, kcfg, prompt, max_new=NEW, device=dev)
            res["v_by_rank"] = {"logits_max_abs_err": (got - want).abs().max().item(),
                                "tokens_equal": bool(torch.equal(tok, want_tok))}
            del model, sharded, cache, got, want

        tcfg, optim = cfg.replace(attn_impl="torch"), AdamW()
        data = {k: torch.from_numpy(v).to(dev)
                for k, v in SyntheticTokens(cfg.vocab, seq, BATCH * 2, seed=0).batch_at(0).items()}
        step = make_train_step(tcfg, optim)
        one, m1 = step(init_state(tcfg, optim, seed=0, device=dev), data)
        state = shard_state(init_state(tcfg, optim, seed=0, device=dev), tcfg, mesh, optim,
                            zero1=True)
        sync()
        t0 = time.perf_counter()
        with activation_sharding(mesh):
            state, m2 = step(state, data)
        sync()
        res["step_s"] = time.perf_counter() - t0
        res["loss_abs_err"] = abs(float(m2["loss"]) - float(m1["loss"]))
        res["grad_norm_rel_err"] = abs(float(m2["grad_norm"]) / float(m1["grad_norm"]) - 1)
        want_leaves, got_leaves = flat(one), flat(state)
        res["leaves_max_abs_err"] = max(
            float(np.abs(got_leaves[n].astype(np.float64) - want_leaves[n]).max())
            for n in want_leaves)

        CheckpointManager(DiskStorage(ckdir)).save(1, state)
        other = make_host_mesh(*OTHER, device=dev.type)
        target = shard_state(init_state(tcfg, optim, seed=9, device=dev), tcfg, other, optim,
                             zero1=True)
        back = flat(CheckpointManager(DiskStorage(ckdir)).restore(target))
        res["restore_differs"] = sorted(n for n in got_leaves
                                        if not np.array_equal(got_leaves[n], back[n]))
        del state, back

        pod_mesh = make_host_mesh(**POD_MESH, device=dev.type)
        state = shard_state(init_state(tcfg, optim, seed=0, device=dev), tcfg, pod_mesh, optim,
                            zero1=True)
        with activation_sharding(pod_mesh):
            state, m3 = step(state, data)
        got_leaves = flat(state)
        res["pod_data_zero1"] = {
            "flattened": sorted(pod_mesh._flatten_mapping),
            "loss_abs_err": abs(float(m3["loss"]) - float(m1["loss"])),
            "grad_norm_rel_err": abs(float(m3["grad_norm"]) / float(m1["grad_norm"]) - 1),
            "leaves_max_abs_err": max(
                float(np.abs(got_leaves[n].astype(np.float64) - want_leaves[n]).max())
                for n in want_leaves)}
        del state

        ck = CheckpointManager(DiskStorage(ckdir + "_keep2"), keep=2)
        for s in (1, 2, 3):
            ck.save(s, {"w": distribute(torch.arange(64.0, device=dev).reshape(16, 4) * s,
                                        pod_mesh, (Shard(0), Shard(0), Replicate())),
                        "step": torch.tensor(s)})
        try:
            ck.restore({"step": torch.empty((), dtype=torch.int64, device="meta")}, 1)
            refused = False
        except FileNotFoundError:
            refused = True
        seen = [None] * WORLD
        dist.all_gather_object(seen, {"steps": ck.steps(), "refused": refused})
        res["keep2"] = seen
        if rank == 0:
            with open(out, "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    if args.device == "cuda" and torch.cuda.device_count() < WORLD:
        raise SystemExit(f"sharded_cards: needs {WORLD} CUDA cards, "
                         f"found {torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory(prefix="sharded_cards_") as tmp:
        out = os.path.join(tmp, "rank0.json")
        t0 = time.perf_counter()
        mp.spawn(rank_main, args=(args.device, os.path.join(tmp, "store"),
                                  os.path.join(tmp, "ckpt"), out), nprocs=WORLD, join=True)
        res = json.load(open(out))
    res["wall_s"] = time.perf_counter() - t0
    res["device"] = args.device
    if args.device == "cuda":
        res["torch"] = torch.__version__
        res["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    print(json.dumps(res))


if __name__ == "__main__":
    main()
