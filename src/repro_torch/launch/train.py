"""End-to-end training (``repro.launch.train``).

Wires the substrates together as the reference does: synthetic data ->
region-template loader (DMS staging + device prefetch) -> train step
(AdamW, cosine schedule with 10 warmup steps) -> async region-template
checkpoints (DISK engine, I/O groups of 2) with restore and a final save.

As the reference, it runs on a one-rank mesh (``make_host_mesh(data=1,
model=1)``, a process group of one rank: ``nccl`` on the card, ``gloo`` on
the CPU) under ``activation_sharding``; on that mesh every sharding is the
identity, so the tensors stay plain. The model trains on the plain
versions of the kernels: ``attn_impl="torch"`` is set on the config, as the
reference trains on its plain ``"xla"`` attention, and no kernel here has
a backward yet.

On the CPU, reduced:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --smoke --device cpu
On the card (the default device) at full width and depth:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
      --steps 20 --batch 2 --seq 2048 --ckpt-every 10
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import BoundingBox
from repro_torch.data import RegionTemplateLoader, SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.spec import activation_sharding
from repro_torch.storage import CheckpointManager, DiskStorage, DistributedMemoryStorage
from repro_torch.train import AdamW, AdamWConfig, cosine_lr, init_state, make_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=20,
                    help="steps between async saves; 0: no checkpoint, not even the final save")
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.scaled_down(vocab=args.vocab)
    cfg = cfg.replace(attn_impl="torch")
    dev = resolve_device(args.device)
    mesh = make_host_mesh(data=1, model=1, device=dev)
    with activation_sharding(mesh):
        return _train(args, cfg, dev)


def _train(args, cfg, dev) -> dict:
    """The run itself, inside the one-rank mesh's ``activation_sharding``."""
    print(f"[train] arch={cfg.name} family={cfg.family} layers={cfg.num_layers} "
          f"d={cfg.d_model} vocab={cfg.vocab} device={dev}")
    print("[train] attn_impl='torch': the reference trains on its plain 'xla' attention, "
          "and no kernel here has a backward yet")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    optim = AdamW(AdamWConfig(lr=args.lr))
    sched = lambda s: cosine_lr(s, base=args.lr, warmup=10, total=args.steps)  # noqa: E731
    step_fn = make_train_step(cfg, optim, lr_schedule=sched)

    # --- data: synthetic stream staged through DMS data regions ---
    source = SyntheticTokens(cfg.vocab, args.seq, args.batch, seed=args.seed,
                             num_steps=args.steps + 1)
    dms = DistributedMemoryStorage(
        BoundingBox((0, 0), (args.batch, args.seq)),
        (args.batch, args.seq),
        num_servers=2,
        name="DATA_DMS",
    )
    loader = RegionTemplateLoader(source, dms, device=dev)

    # --- checkpointing through the DISK engine ---
    os.makedirs(args.ckpt_dir, exist_ok=True)
    store = DiskStorage(args.ckpt_dir, transport="aggregated", io_group_size=2,
                        queue_threshold=8)
    ckpt = CheckpointManager(store, keep=2)

    state = init_state(cfg, optim, seed=args.seed, device=dev)
    start_step = 0
    if args.restore and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        start_step = int(state["step"])
        print(f"[train] restored checkpoint at step {start_step}")

    losses, step_ms, saves = [], [], []
    t0 = time.perf_counter()
    for i, batch in enumerate(loader):
        step = start_step + i
        if step >= args.steps:
            break
        ts = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])  # waits for the step
        step_ms.append(1e3 * (time.perf_counter() - ts))
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            toks = args.batch * args.seq
            dt = (time.perf_counter() - t0) / max(len(losses), 1)
            print(f"  step {step:5d} loss {loss:7.4f} lr {float(metrics.get('lr', 0)):.2e} "
                  f"{toks/dt:8.0f} tok/s")
        if args.ckpt_every and step > 0 and step % args.ckpt_every == 0:
            ckpt.save(step, state, blocking=False)
            saves.append(step)
    ckpt.wait()
    async_save = dict(ckpt.last_save) if saves else None
    if args.ckpt_every:
        ckpt.save(start_step + len(losses), state)
    loader.close()
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({len(losses)} steps, {wall_s:.1f}s); median step "
          f"{float(np.median(step_ms)):.1f} ms; peak memory "
          f"{'not measured on the CPU' if peak is None else f'{peak} bytes'}")
    return {"losses": losses, "state": state, "ckpt": ckpt, "step_ms": step_ms,
            "tokens_per_step": args.batch * args.seq, "async_save": async_save,
            "start_step": start_step, "peak_bytes": peak, "device": str(dev)}


if __name__ == "__main__":
    main()
