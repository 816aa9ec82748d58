"""Batched serving launcher: prefill + decode over a request queue, greedy
or sampled at ``--temperature`` (one ``torch.Generator`` seeded with
``--seed``), on a one-rank mesh under ``activation_sharding`` as the
reference runs it (every sharding the identity there).

Any architecture of ``repro_torch.configs``: the decoder-only ones, and the
encoder-decoder ``seamless-m4t-large-v2``, whose encoder reads 64 stub
frames a request (as the reference's launch.serve draws them). On the card (the
default device) at full width:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --requests 2 --batch 2 --prompt-len 2048 --max-new 32
On the CPU, reduced:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b --smoke --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build
from repro_torch.models.spec import activation_sharding
from repro_torch.serve import generate


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.scaled_down(vocab=512)
    dev = resolve_device(args.device)
    print(f"[serve] arch={cfg.name} family={cfg.family} device={dev}")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = build(cfg, device=dev, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    sampler = (torch.Generator(device=dev).manual_seed(args.seed) if args.temperature > 0
               else None)
    mesh = make_host_mesh(data=1, model=1, device=dev)

    done = 0
    outputs, prefill_s, decode_s, decode_tokens = [], [], 0.0, 0
    while done < args.requests:
        bs = min(args.batch, args.requests - done)
        prompts = rng.integers(0, cfg.vocab, (bs, args.prompt_len)).astype(np.int32)
        frames = prefix = None  # the stubs' embeddings, drawn as the reference draws them
        if cfg.family == "encdec":
            frames = rng.standard_normal((bs, 64, cfg.d_model)).astype(np.float32) * 0.1
        if cfg.frontend:
            prefix = (rng.standard_normal((bs, cfg.frontend_len, cfg.d_model)).astype(np.float32)
                      * 0.1)
        stats: dict = {}
        with activation_sharding(mesh):
            out = generate(params, cfg, prompts, max_new=args.max_new,
                           temperature=args.temperature, generator=sampler, prefix=prefix,
                           frames=frames, device=dev, stats=stats)
        outputs.append(out.cpu().numpy())
        prefill_s.append(stats["prefill_s"])
        decode_s += stats["decode_s"]
        decode_tokens += bs * args.max_new
        done += bs
    prefill_ms = [1e3 * t for t in prefill_s]
    prefill_tokens = done * args.prompt_len
    print(f"[serve] prefill: {len(prefill_ms)} batches, {prefill_tokens} prompt tokens, "
          f"ms per batch {[round(t, 3) for t in prefill_ms]} "
          f"({prefill_tokens / sum(prefill_s):.1f} tok/s)")
    print(f"[serve] decode: {decode_tokens} new tokens in {decode_s:.3f}s "
          f"({decode_tokens / decode_s:.1f} tok/s)")
    # the most the device held at once, weights included (not measured on the CPU)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    print(f"[serve] peak memory: {'not measured on the CPU' if peak is None else f'{peak} bytes'}")
    return {
        "outputs": outputs,
        "prefill_ms": prefill_ms,
        "prefill_tok_per_s": prefill_tokens / sum(prefill_s),
        "decode_tok_per_s": decode_tokens / decode_s,
        "tok_per_s": decode_tokens / (sum(prefill_s) + decode_s),
        "peak_bytes": peak,
        "device": str(dev),
    }


if __name__ == "__main__":
    main()
