#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card (written for an H100).

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each fatal on failure:
  1. check that CUDA is present; print the card's name and power limit;
  2. build the six kernels from ``src/repro_torch/kernels/csrc`` with nvcc;
  3. hold each WSI kernel against its plain PyTorch version on the card, on
     the WSI path's data and shapes (a 3x4096x4096 slide, 512 ROIs of 64x64;
     GLCM also at 256 bins), and time both with CUDA events; the
     reconstruction is held bit for bit against the plain version after
     checking that the plain version converged, and is also timed on its
     worst case, a 1-pixel serpentine corridor; CCL's three phases and
     GLCM's launch are also timed on the device alone (events queued behind
     a device sleep), CCL also on its worst cases, a serpentine through
     every tile and a full mask, each checked against its closed form;
     GLCM at 256 bins takes the packed route (16-bit counters), timed
     beside the device-memory route it replaced, on the same input;
  4. run the WSI path, ``analyze_tile`` at 4096^2 with the default config,
     with every launch counter set to 0 just before and read just after, and
     check it stage by stage against the same call with ``impl="torch"``;
  4b. run the WSI path in its region-template form (``SegmentationStage`` ->
     ``FeatureStage`` under ``SysEnv``, data through the DMS): one partition
     at 4096^2, holding its labels bit for bit and its features against
     ``analyze_tile``'s and its launch counts against one ``analyze_tile``'s,
     timed against ``analyze_tile`` from host numpy in to host results out
     (the paper's Fig. 11 overhead); then 16 partitions of 1024^2 over 3
     workers on tiered stores, each held bit for bit against ``analyze_tile``
     on its crop; then ``DevicePipeline`` mapping color deconvolution over 16
     tiles with windows 1 and 2, held bit for bit against direct calls;
  4c. run the WSI path in its near-data form: every standard kernel chain
     (and GLCM at 256 bins) through ``RegionGateway.compute`` over tiered
     stores whose DMS tier lives on spawned server processes behind the
     shared-memory transport, at 4096^2; each held bit for bit against the
     same chain run locally, stage by stage against the plain versions, and
     its launch counts against its stages; 16 overlapping ROIs from 4
     client threads must coalesce into fewer window fetches; every repeat
     must be a derived-cache hit that launches nothing; GLCM at B = 1
     (the chains' one window) is timed at 32 and 256 bins (the packed
     route, beside the device-memory one);
  5. hold the LM path's two kernels (flash attention, SSD scan) against
     their plain versions at Hymba-1.5B's prefill shapes, in bfloat16 and
     float32, and time them beside the plain versions and a library call;
     the SSD scan's three phases are also timed one by one;
  6. run the LM path, ``launch.serve.main`` serving hymba-1.5b at full width
     and depth in bfloat16 (random weights from a seed), with every launch
     counter set to 0 just before and read just after, and check that every
     attention and SSD call took its tensor-core instance;
  7. check the LM path end to end in float32: prefill logits on the kernels
     against the plain versions, and greedy tokens over 8 decode steps;
  7b. the other LM families: hold the two LM kernels against their plain
     versions at the new shapes (attention at D = 128, 256 and 192, the SSD
     scan at N = 128), then serve qwen3-0.6b, gemma-2b, mamba2-2.7b and
     deepseek-v2-lite-16b through ``launch.serve.main`` at full width and
     depth in bf16 (one batch of 2 prompts of 2048 tokens, 32 new tokens),
     one model at a time, with the counters set to 0 just before each and
     read just after, checking each model's kernel launches; score with
     deepseek-v2-lite-16b's ``forward`` (MLA on the tensor-core kernel at
     D = 192, in bf16; float32 stays on the CUDA-core instance); then
     hold six models end to end in float32 at full width, 2 layers deep,
     kernels against plain versions; print the meta-device parameter counts
     of the two models too large for one card;
  8. the encoder-decoder family: hold attention against its plain version
     at seamless-m4t-large-v2's encoder shape (not causal) and its decoder
     prefill's (causal), time both beside SDPA, serve seamless at full width
     and depth in bf16 through ``serve.generate`` (2048 frames, 2 x 2048
     prompt tokens, 32 new tokens) with the counters set to 0 just before and
     read just after (48 tensor-core launches, 24 not causal), time its
     encoder, and hold it end to end in float32 at full width, 2 + 2 layers;
  9. training: ``launch.train.main`` for qwen3-0.6b at full width and depth
     in bf16, 20 steps of 2 x 2048 tokens with an async checkpoint at step
     10 and a final save (the loss must fall; no kernel may launch: training
     runs the plain attention), the saved state restored leaf for leaf bit
     for bit, a ``--restore`` run to step 30, and one float32 train step at
     full width, 2 layers, on the card against the CPU;
  9b. the reference's chunked route (``attn_impl="chunked"``: online-softmax
     attention over key chunks and the chunked SSD scan, plain torch): the
     prefill of qwen3-0.6b (and of mamba2-2.7b) at full width and depth in
     bf16, 2 x 2048 tokens, on the kernel, chunked (and plain) routes, every
     layer's attention (SSD scan) call on the kernel route held against the
     chunked route on the same inputs, qwen3's logits and decisive greedy
     tokens held against the kernel route's, each route's prefill time and
     peak memory; then qwen3-0.6b trained at phase 9's size, 10 steps a
     block from the same seed on the plain and the chunked routes in turns,
     their losses at steps 0 and 9 held together, the loss falling, and no
     kernel launched (counters set to 0 just before, read just after);
  10. the multi-device machinery: (a) ``launch.serve.main`` and
     ``launch.train.main`` for qwen3-0.6b at full width and depth on their
     one-rank mesh (a process group of one rank, ``nccl``; every sharding
     the identity) at phase 7b's and phase 9's seeds and sizes (training 10
     steps, no checkpoint), their tokens held equal to phase 7b's and their
     losses at steps 0 and 9 to phase 9's, and ``generate`` and a train
     step timed with and without the mesh, in turns; (b) two processes on
     the one card over ``gloo`` (NCCL takes one rank a device): qwen3-0.6b
     at full width, 2 layers, float32, a prefill on a (data=1, model=2)
     mesh, each rank launching the attention kernel on its 8 of 16 query
     heads, its logits' shard against the one-rank prefill's, and one train
     step on a (data=2, model=1) mesh against the one-rank step (all-reduces
     only: gloo's all-gather of CUDA tensors crashes, so ZeRO-1 is left to
     the CPU tests), with the launch counters set to 0 just before each and
     read just after; (c) the dry
     run, on the host alone: qwen3-0.6b x train_4k on the (16, 16) mesh and
     deepseek-v2-lite-16b x decode_32k on the (2, 16, 16) one, each
     roofline's three terms on the H100 spec (predictions, not
     measurements) and the seconds each took;
  11. print the per-kernel JSON lines, the ``kernels`` line and, last, the
     ``{"ok": true, "device": ...}`` line.
It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from functools import partial

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM data sheet: HBM3 rate, float32 rate outside the tensor cores, and
# the dense bf16 tensor-core rate (the least time the card could take for the
# LM kernels' bf16 matrix work; their float32 work is held to the float32
# rate, as TF32 would not keep float32's tolerance).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TC_OPS_PER_S = 989e12

SLIDE = dict(tiles_y=8, tiles_x=8, tile=512, seed=0)  # 3 x 4096 x 4096
DECONV_TOL = 2e-5  # log10f vs the plain log10, as tests/test_kernels.py allows
FEATURE_TOL = 1e-4  # feature reductions, as tests/test_wsi_pipeline.py allows
GLCM_WIDE_BINS = 256  # the chains' largest bin count (repro/kernels/chains.py:213)
CORRIDOR = (1023, 3000)  # the reconstruction's worst case: a front crossing ~24,000 tile edges

# The LM path: hymba-1.5b served at full width and depth, two batches of two
# 2048-token prompts, 32 new tokens each.
LM_ARGV = ["--arch", "hymba-1.5b", "--requests", "4", "--batch", "2",
           "--prompt-len", "2048", "--max-new", "32"]
LM_PREFILLS = 2  # batches in LM_ARGV: each prefill runs every layer once
# Kernel tolerances (rtol = atol) by dtype. float32 3e-4 and the SSD's bf16
# 3e-2 are tests/test_kernels.py's. bf16 attention is held tighter, at about
# an ulp of bf16 near 1: outputs at the path's shapes are only some 0.05 in
# size, but the first rows see few keys and reach |y| in [1, 2). The
# tensor-core instance rounds P to bf16 before P V, as SDPA does; on an H100
# both are 7.81e-3 from the plain version there (one bf16 ulp, inside
# atol + rtol*|y|), where the float32-P CUDA-core instance was 1.95e-3.
ATTN_TOLS = {"bf16": 8e-3, "f32": 3e-4}
SSD_TOLS = {"bf16": 3e-2, "f32": 3e-4}
# End to end in float32: prefill logits of the kernel path against the plain
# path. The kernels sum in another order (online softmax; the chunked SSD
# against the step-by-step recurrence), and 32 layers carry the difference.
E2E_LOGIT_TOL = 1e-3
E2E_DECODE_STEPS = 8
PHASE_SLEEP_CYCLES = 2_000_000  # about 1 ms of device time ahead of a timed call
# Phase 7b, the other decoder-only families: each served at full width and
# depth in bf16 through launch.serve.main, one batch of two 2048-token prompts
# and 32 greedy new tokens; the prefill's expected launches of each kernel
# (gemma's embedding scale promotes its residual stream to float32, as the
# reference's does, so its attention runs the CUDA-core instance in float32;
# the absorbed MLA path of deepseek's prefill and decode calls no kernel)
FAMILY_ARGV = ["--requests", "2", "--batch", "2", "--prompt-len", "2048", "--max-new", "32"]
FAMILY_SERVED = {
    "qwen3-0.6b": {"flash_attention": ("tensor_core", 28), "ssd_scan": ("tensor_core", 0)},
    "gemma-2b": {"flash_attention": ("cuda_core", 18), "ssd_scan": ("tensor_core", 0)},
    "mamba2-2.7b": {"flash_attention": ("tensor_core", 0), "ssd_scan": ("tensor_core", 64)},
    "deepseek-v2-lite-16b": {"flash_attention": ("tensor_core", 0),
                             "ssd_scan": ("tensor_core", 0)},
}
# float32 end to end at full width, cut to 2 layers deep (deepseek: its dense
# first layer and one MoE layer); what each exercises
FAMILY_E2E_LAYERS = 2
FAMILY_E2E = {"qwen3-0.6b": "attention D = 128", "gemma-2b": "attention D = 256",
              "mamba2-2.7b": "SSD N = 128", "deepseek-v2-lite-16b": "MLA forward, D = 192",
              "granite-20b": "layer norm, gelu, 48:1 MQA",
              "internvl2-1b": "the 256-slot patch prefix"}
FAMILY_META_ONLY = ("nemotron-4-340b", "qwen3-moe-235b-a22b")  # beyond one card's 80 GB
# the kernels line's family rows: each the measurement in its path's dtype
# (deepseek's MLA in bf16 on the tensor cores, and in float32 on the CUDA
# cores, as its float32 forward runs it)
FAMILY_ROWS = {"flash_attention:qwen3": "flash_attention:bf16:qwen3",
               "flash_attention:gemma": "flash_attention:f32:gemma",
               "flash_attention:mla": "flash_attention:bf16:mla",
               "flash_attention:mla_f32": "flash_attention:f32:mla",
               "ssd_scan:mamba2": "ssd_scan:bf16:mamba2"}
# Phase 8, the encoder-decoder family: seamless-m4t-large-v2 served at full
# width and depth in bf16 through serve.generate, one batch of two
# 2048-token prompts behind 2048 encoder frames (x 0.1, as the reference's
# launch.serve scales them) and 32 greedy new tokens; a prefill launches the
# tensor-core attention once an encoder layer (not causal) and once a decoder
# layer (causal); the float32 check cuts both stacks to 2 layers
SEAMLESS = dict(arch="seamless-m4t-large-v2", batch=2, prompt_len=2048, enc_len=2048,
                max_new=32)
SEAMLESS_E2E_LAYERS = 2
ENCDEC_ROWS = {"flash_attention:seamless_enc": "flash_attention:bf16:seamless_enc",
               "flash_attention:seamless_dec": "flash_attention:bf16:seamless_dec"}
# Phase 9, training: launch.train.main for qwen3-0.6b at full width and depth
# in bf16 (20 steps of 2 x 2048 tokens, an async checkpoint at step 10 and a
# final save), then a restored run that continues to step 30; the float32
# check: one train step at full width, 2 layers, 2 x 512 tokens, on the card
# against the CPU (the embedding gradient's atomics sum in no fixed order).
# The learning rate: launch.train's default 3e-3 (sized for --smoke) raises the
# full model's loss within 20 steps, 1e-3 lowers it the most of 3e-3, 1e-3,
# 3e-4 and 1e-4 (scripts/profile_train_torch.py)
TRAIN_ARGV = ["--arch", "qwen3-0.6b", "--steps", "20", "--batch", "2", "--seq", "2048",
              "--ckpt-every", "10", "--log-every", "5", "--lr", "1e-3"]
TRAIN_RESTORED_STEPS = 30
TRAIN_E2E = dict(layers=2, batch=2, seq=512)
TRAIN_LOSS_TOL, TRAIN_NORM_RTOL = 1e-4, 1e-3
# Phase 9b, the reference's chunked route (attn_impl="chunked": online-softmax
# attention over key chunks of 4 x block_k = 512 keys and the chunked SSD
# scan, plain torch in float32, no kernel). (a) qwen3-0.6b's prefill at full
# width and depth in bf16 at phase 7b's size (2 x 2048) on the kernel route,
# the chunked route and the plain one: every layer's attention held, chunked
# against the kernel on the path's own inputs, at the bf16 attention
# tolerance; then in float32 at full depth, the chunked route's prefill
# logits within E2E_LOGIT_TOL of the kernel route's and its decisive greedy
# tokens equal (float32_end_to_end). The bf16 logits are reported, not held:
# after 28 bf16 layers any two routes differ by a few bf16 ulps (0.0234 on
# an H100, the chunked route against the plain one as against the kernel).
# (b) mamba2-2.7b's prefill alike: every layer's SSD y and final state at
# the SSD's bf16 tolerance, then float32 end to end at full depth (its bf16
# logits, 64 layers deep, differ by about 1 on an H100). (c) qwen3-0.6b
# trained at phase 9's size, dtype, learning rate and seed through
# make_train_step, CHUNKED_TRAIN_STEPS steps a block from a fresh state, the
# blocks in turns (plain, chunked, chunked, plain): the losses at steps 0 and
# 9 within MESH_LOSS_TOL of each other, the loss falling, no kernel launch.
CHUNKED_PREFILL_REPS = 5
CHUNKED_TRAIN_STEPS = 10
CHUNKED_TRAIN_ORDER = ("torch", "chunked", "chunked", "torch")
CCL_WORST = (4095, 4096)  # CCL's worst cases: a serpentine and a full mask through every tile
# Phase 4c, the near-data chains: the gateways' stores on 4 DMS servers in 2
# processes behind the shm transport; a derived-cache budget that holds a
# 4096^2 int32 label array (67 MB; the default 64 MB drops it); 16 ROIs of
# 1024^2 at stride 768 from 4 client threads
NEAR_DATA_SERVERS = 4
NEAR_DATA_SERVER_PROCESSES = 2
NEAR_DATA_CACHE_BYTES = 512 << 20
NEAR_DATA_ROI, NEAR_DATA_ROI_STRIDE, NEAR_DATA_ROI_GRID, NEAR_DATA_CLIENTS = 1024, 768, 4, 4
# the launches each stage makes ("phases": CCL's three a call)
NEAR_DATA_STAGE_COUNTS = {
    "deconv": {"color_deconv": 1}, "threshold": {}, "fill": {"morph_recon:calls": 1},
    "ccl": {"ccl": 1, "ccl:kernel_launches": "phases"}, "count": {}, "glcm": {"glcm": 1},
}
# features from bit-equal counts; the relative tolerance the chains' features
# are held to
CHAIN_FEATURE_RTOL = 1e-5
FIXED_POINT_ITERS = 100_000  # the plain reconstruction and CCL, run to their fixed points
NEAR_DATA_PLAIN_BAND_ROWS = 64  # the plain GLCM band by band: 0.5 GB of one-hot at 256 bins
GLCM_B1_BINS = (32, GLCM_WIDE_BINS)
# Phase 10, the multi-device machinery. (a) The one-rank mesh of the
# launchers: qwen3-0.6b served as phase 7b serves it and trained as phase 9
# trains it, for 10 steps with no checkpoint (the warmup's 10 steps, whose
# learning rates do not depend on the run's length); the losses at steps 0
# and 9 within MESH_LOSS_TOL of phase 9's (the same seed on the same card;
# the backward's atomics need not repeat bit for bit). Then generate and a
# train step timed three times plain and three times on the mesh, in turns
# (plain, mesh, mesh, plain, plain, mesh): the mesh's cost, the difference
# of the medians, is held to the spread of the repeats (the larger range).
MESH_ARCH = "qwen3-0.6b"
MESH_TRAIN_STEPS = 10
MESH_LOSS_TOL = 1e-3
# (b) Two ranks on the one card (gloo carries CUDA tensors; NCCL takes one
# rank a device): qwen3-0.6b at full width, 2 layers, float32, a prefill of
# 2 x 512 tokens on (data=1, model=2), each rank's shard of the
# vocab-sharded logits against the same slice of the one-rank prefill's, and
# one train step of 2 x 512 on (data=2, model=1) against the one-rank step;
# the attention kernel launches once a layer on each rank. gloo's all-gather
# of CUDA tensors (all_gather_into_tensor) ends the process with SIGSEGV
# (torch 2.11, CUDA 12.8), so the card runs only what all-reduces carry:
# the logits are compared shard by shard, not gathered, and the step runs
# without ZeRO-1, whose update gathers the parameters (it runs in four gloo
# processes on the CPU, tests/test_torch_sharded.py). Then the two ranks save
# a tree sharded over them at MESH2_CKPT_STEPS with keep=MESH2_CKPT_KEEP:
# each rank must list the last two steps, refuse the first and restore the
# last bit for bit (retention after the manifest is re-read on every rank)
MESH2 = dict(layers=2, batch=2, seq=512)
MESH2_LOGIT_TOL, MESH2_LOSS_TOL, MESH2_NORM_RTOL = 1e-4, 1e-5, 1e-4
MESH2_CKPT_STEPS, MESH2_CKPT_KEEP = (1, 2, 3), 2
# (c) The dry run's cells: (arch, shape, multi-pod); each also prints the
# redistributions DTensor ran as one collective a mesh axis
# (dryrun.sequential_collectives, null where this torch merges none)
DRYRUN_CELLS = (("qwen3-0.6b", "train_4k", False), ("deepseek-v2-lite-16b", "decode_32k", True))
# what the earlier phases served and trained, for phase 10(a)
EARLIER: dict = {}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    import torch

    # -- 1. device -------------------------------------------------------------
    if not torch.cuda.is_available():
        fail("CUDA is not available; this script runs only on a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full float32
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"device: {kind} (count {torch.cuda.device_count()})")
    print(f"nvidia-smi: {smi}", flush=True)

    from repro_torch.configs.wsi import WSIConfig
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import ccl as ccl_mod
    from repro_torch.kernels import color_deconv as cd_mod
    from repro_torch.kernels import glcm as glcm_mod
    from repro_torch.kernels import morph_recon as mr_mod
    from repro_torch.pipeline import (
        analyze_tile, compute_features, extract_object_rois, make_slide, segment_mask,
        segment_tile,
    )

    modules = {"color_deconv": cd_mod, "morph_recon": mr_mod, "ccl": ccl_mod, "glcm": glcm_mod}
    dev = torch.device("cuda")

    # -- 2. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    _build.lib()
    print(f"build: {len(_build.sources())} sources -> {_build.BUILD_DIR / _build.LIB_NAME} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)

    def sync() -> None:
        torch.cuda.synchronize()

    def time_ms(fn, reps: int, warmup: int = 1) -> float:
        for _ in range(warmup):
            fn()
        sync()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    def bound(nbytes: int, nops: int) -> tuple[float, str]:
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S
        return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")

    # -- 3. each kernel against its plain version, main-path data ---------------
    t0 = time.perf_counter()
    rgb_np, _ = make_slide(SLIDE["tiles_y"], SLIDE["tiles_x"], SLIDE["tile"], seed=SLIDE["seed"])
    print(f"setup: make_slide{tuple(rgb_np.shape)} in {time.perf_counter() - t0:.1f} s", flush=True)
    cfg = WSIConfig()
    rgb = torch.from_numpy(rgb_np).to(dev)
    minv = torch.from_numpy(ref.stain_inverse()).to(dev)
    _, h, w = rgb.shape
    hw = h * w
    rec: dict[str, dict] = {}

    # color deconvolution
    k_st = ops.color_deconv(rgb, minv, impl="cuda")
    p_st = ops.color_deconv(rgb, minv, impl="torch")
    err = (k_st - p_st).abs().max().item()
    if not torch.allclose(k_st, p_st, rtol=DECONV_TOL, atol=DECONV_TOL):
        fail(f"color_deconv disagrees with its plain version: max |err| {err}")
    od = -torch.log10(torch.clamp(rgb, 1e-6, 1.0))
    rec["color_deconv"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: ops.color_deconv(rgb, minv, impl="cuda"), 20),
        plain_ms=time_ms(lambda: ops.color_deconv(rgb, minv, impl="torch"), 10),
        library_ms=time_ms(lambda: torch.einsum("chw,cs->shw", od, minv), 10),
        bound=bound(2 * rgb.numel() * 4 + 36, 24 * hw),
    )
    del od

    # threshold (plain torch, as in segment_tile) on the plain hematoxylin
    hema = p_st[0]
    lo, hi = ref.percentile(hema, (5.0, 99.5))
    hema_n = torch.clamp((hema - lo) / torch.clamp(hi - lo, min=1e-6), 0.0, 1.0)
    raw = (hema_n > cfg.seg_threshold).to(torch.float32)

    def exact(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
        if a.shape != b.shape or not torch.equal(a, b):
            n_bad = int((a != b).sum()) if a.shape == b.shape else -1
            fail(f"{name} disagrees with its plain version ({n_bad} elements differ)")

    def reset_recon_counts() -> None:
        mr_mod.launches = mr_mod.rounds = mr_mod.tile_visits = 0

    def recon_stats() -> dict:
        """The counts of the one reconstruction call since the last reset."""
        return dict(launches_per_call=mr_mod.launches, rounds_per_call=mr_mod.rounds,
                    tile_visits=mr_mod.tile_visits)

    def recon_bound(stats: dict) -> tuple[float, str]:
        # marker + mask in, the result out; a tile visit does at least one
        # local round of 4 passes, 2 min/max a pixel each
        return bound(3 * hw * 4, 8 * mr_mod.TILE**2 * stats["tile_visits"])

    def converged(name: str, p: torch.Tensor, mask_: torch.Tensor) -> None:
        if not torch.equal(ref.morph_recon_sweep_ref(p, mask_), p):
            fail(f"the plain {name} did not converge within its max_iters; the comparison is void")

    # fill holes (reconstruction kernel on the complement)
    reset_recon_counts()
    k_fill = ops.fill_holes(raw, impl="cuda")
    fill_stats = recon_stats()
    seed, inv = ref.fill_holes_seed(raw)
    p_rec = ref.morph_recon_ref(seed, inv)
    converged("fill_holes reconstruction", p_rec, inv)
    p_fill = 1.0 - p_rec
    exact("fill_holes", k_fill, p_fill)
    del seed, inv, p_rec
    part: dict[str, dict] = {}  # the two reconstruction calls of the main path
    part["fill_holes"] = dict(
        max_abs_err=0.0, **fill_stats,
        ms=time_ms(lambda: ops.fill_holes(raw, impl="cuda"), 10),
        plain_ms=time_ms(lambda: ops.fill_holes(raw, impl="torch"), 2, warmup=0),
        library_ms=None,
        bound=recon_bound(fill_stats),
    )

    # reconstruction opening
    filled = p_fill
    marker = torch.minimum(
        filled,
        torch.roll(filled, 1, -1) * torch.roll(filled, -1, -1)
        * torch.roll(filled, 1, -2) * torch.roll(filled, -1, -2),
    )
    reset_recon_counts()
    k_open = ops.morph_recon(marker, filled, impl="cuda")
    open_stats = recon_stats()
    p_open = ops.morph_recon(marker, filled, impl="torch")
    converged("reconstruction opening", p_open, filled)
    exact("morph_recon", k_open, p_open)
    part["opening"] = dict(
        max_abs_err=0.0, **open_stats,
        ms=time_ms(lambda: ops.morph_recon(marker, filled, impl="cuda"), 10),
        plain_ms=time_ms(lambda: ops.morph_recon(marker, filled, impl="torch"), 2, warmup=0),
        library_ms=None,
        bound=recon_bound(open_stats),
    )
    rec["morph_recon"] = dict(  # per tile: fill-holes + opening
        max_abs_err=0.0,
        ms=part["fill_holes"]["ms"] + part["opening"]["ms"],
        plain_ms=part["fill_holes"]["plain_ms"] + part["opening"]["plain_ms"],
        library_ms=None,
        bound=bound(2 * 3 * hw * 4, 8 * mr_mod.TILE**2
                    * (fill_stats["tile_visits"] + open_stats["tile_visits"])),
    )

    # the reconstruction's worst case: a front that walks a 1-pixel corridor
    # through the whole image; seeded at its start, it fills the corridor
    corridor = torch.as_tensor(serpentine(*CORRIDOR), dtype=torch.float32, device=dev)
    seed = torch.zeros_like(corridor)
    seed[0, 0] = 1.0
    reset_recon_counts()
    exact("morph_recon on the corridor", ops.morph_recon(seed, corridor, impl="cuda"), corridor)
    corridor_rec = dict(
        kernel="morph_recon:corridor", shape=CORRIDOR, max_abs_err=0.0, **recon_stats(),
        kernel_ms=time_ms(lambda: ops.morph_recon(seed, corridor, impl="cuda"), 3),
    )
    del corridor, seed

    # connected components
    mask = (p_open > 0.5).to(torch.int32)
    k_lab = ops.connected_components(mask, impl="cuda")
    p_lab = ops.connected_components(mask, impl="torch")
    exact("ccl", k_lab, p_lab)
    mask_b = mask != 0
    at_fixed_point = torch.where(mask_b, p_lab, torch.full_like(p_lab, torch.iinfo(torch.int32).max))
    if not torch.equal(ref.ccl_sweep_ref(at_fixed_point, mask_b), at_fixed_point):
        fail("the plain ccl did not converge within its max_iters; the comparison is void")
    n_objects = int(torch.unique(p_lab[mask_b]).numel())
    before = ccl_mod.kernel_launches
    ops.connected_components(mask, impl="cuda")
    ccl_per_call = ccl_mod.kernel_launches - before
    rec["ccl"] = dict(
        max_abs_err=0.0, kernel_launches_per_call=ccl_per_call,
        ms=time_ms(lambda: ops.connected_components(mask, impl="cuda"), 10),
        phase_ms=device_ms(torch, lambda ev: ccl_mod.ccl_cuda(mask, events=ev),
                           ccl_mod.PHASES, 10),
        plain_ms=time_ms(lambda: ops.connected_components(mask, impl="torch"), 2, warmup=0),
        library_ms=None,
        bound=bound(2 * hw * 4, 4 * hw),
    )
    # CCL's worst cases, labels known in closed form: a serpentine that
    # crosses every tile (one component, its first pixel 0) and a full mask
    # (every border union and every compression on the one root 0)
    ccl_worst = []
    for case, m_np in (("snake", serpentine(*CCL_WORST)), ("full", np.ones(CCL_WORST, bool))):
        m_w = torch.as_tensor(m_np.astype(np.int32), device=dev)
        want = torch.where(m_w != 0, torch.zeros_like(m_w), torch.full_like(m_w, -1))
        exact(f"ccl on the {case} mask", ops.connected_components(m_w, impl="cuda"), want)
        ccl_worst.append(dict(
            kernel=f"ccl:{case}", shape=CCL_WORST, max_abs_err=0.0,
            kernel_ms=time_ms(lambda: ops.connected_components(m_w, impl="cuda"), 5),
            phase_ms=device_ms(torch, lambda ev: ccl_mod.ccl_cuda(m_w, events=ev),
                               ccl_mod.PHASES, 5),
            bound_ms=bound(2 * m_w.numel() * 4, 4 * m_w.numel())[0],
        ))
        del m_w, want

    # GLCM + histogram on the main path's ROI batch
    rois, _ = extract_object_rois(p_lab, hema_n, cfg, device=dev)
    bins = ref.quantize_ref(rois, cfg.num_bins)
    nb = cfg.num_bins
    k_g, k_h = ops.glcm_histogram(bins, nb, impl="cuda")
    p_g, p_h = ops.glcm_histogram(bins, nb, impl="torch")
    exact("glcm", k_g, p_g)
    exact("glcm histogram", k_h, p_h)
    b = bins.shape[0]
    pair_idx = (
        torch.arange(b, device=dev)[:, None, None] * nb * nb
        + bins[:, :, :-1].long() * nb + bins[:, :, 1:].long()
    ).reshape(-1)
    rec["glcm"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: ops.glcm_histogram(bins, nb, impl="cuda"), 20),
        phase_ms=device_ms(torch, lambda ev: glcm_mod.glcm_cuda(bins, nb, events=ev), (), 20),
        plain_ms=time_ms(lambda: ops.glcm_histogram(bins, nb, impl="torch"), 10),
        library_ms=time_ms(lambda: torch.bincount(pair_idx, minlength=b * nb * nb), 10),
        bound=bound(bins.numel() * 4 + (k_g.numel() + k_h.numel()) * 4, 3 * bins.numel()),
    )
    del pair_idx
    # the packed route (241 <= NB <= 340), on the same ROIs at 256 bins
    wide = ref.quantize_ref(rois, GLCM_WIDE_BINS)
    wide_route = glcm_mod.route(GLCM_WIDE_BINS, wide.shape[-1])
    before = glcm_mod.route_launches["packed"]
    wide_g, wide_h = ops.glcm_histogram(wide, GLCM_WIDE_BINS, impl="cuda")
    if wide_route != "packed" or glcm_mod.route_launches["packed"] != before + 1:
        fail(f"glcm at {GLCM_WIDE_BINS} bins on {tuple(wide.shape)} took the {wide_route} "
             f"route, not the packed one")
    wp_g, wp_h = ops.glcm_histogram(wide, GLCM_WIDE_BINS, impl="torch")
    exact(f"glcm at {GLCM_WIDE_BINS} bins", wide_g, wp_g)
    exact(f"glcm histogram at {GLCM_WIDE_BINS} bins", wide_h, wp_h)
    wide_idx = (
        torch.arange(b, device=dev)[:, None, None] * GLCM_WIDE_BINS**2
        + wide[:, :, :-1].long() * GLCM_WIDE_BINS + wide[:, :, 1:].long()
    ).reshape(-1)
    glcm_wide = dict(
        kernel=f"glcm:nb{GLCM_WIDE_BINS}", shape=list(wide.shape), route=wide_route,
        max_abs_err=0.0,
        kernel_ms=time_ms(lambda: ops.glcm_histogram(wide, GLCM_WIDE_BINS, impl="cuda"), 20),
        device_ms=device_ms(torch, lambda ev: glcm_mod.glcm_cuda(
            wide, GLCM_WIDE_BINS, events=ev), (), 20)["device"],
        global_device_ms=glcm_global_device_ms(torch, wide, GLCM_WIDE_BINS, (wp_g, wp_h), 20),
        plain_ms=time_ms(lambda: ops.glcm_histogram(wide, GLCM_WIDE_BINS, impl="torch"), 10),
        library_ms=time_ms(
            lambda: torch.bincount(wide_idx, minlength=b * GLCM_WIDE_BINS**2), 10),
        bound_ms=bound(wide.numel() * 4 + (wide_g.numel() + wide_h.numel()) * 4,
                       3 * wide.numel())[0],
    )
    del wide, wide_g, wide_h, wp_g, wp_h, wide_idx
    print(f"checks: {n_objects} objects in the slide, ROI batch {tuple(bins.shape)}, "
          f"fill_holes {fill_stats}, reconstruction {open_stats}, corridor {CORRIDOR} "
          f"{corridor_rec['rounds_per_call']} rounds", flush=True)

    # -- 4. the main path --------------------------------------------------------
    for mod in modules.values():
        mod.launches = 0
    reset_recon_counts()
    ccl_mod.kernel_launches = 0
    sync()
    t0 = time.perf_counter()
    out = analyze_tile(rgb, cfg)
    sync()
    wall_s = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in modules.items()}
    launches["ccl:kernel_launches"] = ccl_mod.kernel_launches
    print(f"main path: analyze_tile {tuple(rgb.shape)} in {wall_s:.3f} s, launches {launches}, "
          f"reconstruction rounds {mr_mod.rounds}, tile visits {mr_mod.tile_visits}")
    for name, n in launches.items():
        if n == 0:
            fail(f"the main path never launched the {name} kernel")
    if launches["ccl:kernel_launches"] != len(ccl_mod.PHASES) * launches["ccl"]:
        fail(f"the main path's {launches['ccl']} ccl calls made "
             f"{launches['ccl:kernel_launches']} kernel launches, not {len(ccl_mod.PHASES)} each")

    feats = out["features"]
    k = min(n_objects, cfg.max_objects_per_tile)
    if tuple(feats.shape) != (k, 9) or not bool(torch.isfinite(feats).all()):
        fail(f"features: shape {tuple(feats.shape)} (want ({k}, 9)) or non-finite values")
    if tuple(out["rois"].shape) != (k, cfg.nucleus_roi, cfg.nucleus_roi):
        fail(f"rois: shape {tuple(out['rois'].shape)}")

    # the same call, plain versions on the card, then stage by stage
    sync()
    t0 = time.perf_counter()
    plain = analyze_tile(rgb, cfg, impl="torch")
    sync()
    plain_wall_s = time.perf_counter() - t0
    hema_err = (out["hematoxylin"] - plain["hematoxylin"]).abs().max().item()
    if hema_err > FEATURE_TOL:
        fail(f"hematoxylin differs from the plain path by {hema_err}")
    p_hema = plain["hematoxylin"]
    flips = (out["hematoxylin"] > cfg.seg_threshold) != (p_hema > cfg.seg_threshold)
    n_flips = int(flips.sum())
    if n_flips and (p_hema[flips] - cfg.seg_threshold).abs().max().item() > FEATURE_TOL:
        fail("a thresholded pixel differs away from the threshold's knife edge")
    p_raw = (p_hema > cfg.seg_threshold).to(torch.float32)
    staged = segment_mask(p_raw)
    exact("labels from the plain thresholded mask", staged["labels"], plain["labels"])
    staged_feats = compute_features(plain["rois"], cfg)
    feat_err = (staged_feats - plain["features"]).abs().max().item()
    if not torch.allclose(staged_feats, plain["features"], rtol=FEATURE_TOL, atol=FEATURE_TOL):
        fail(f"features from the plain ROIs differ by {feat_err}")
    labels_equal = torch.equal(out["labels"], plain["labels"])
    e2e_feat_err = (
        (feats - plain["features"]).abs().max().item()
        if feats.shape == plain["features"].shape else None
    )
    print(f"plain path: analyze_tile(impl='torch') in {plain_wall_s:.3f} s; "
          f"hematoxylin max |err| {hema_err:.3g}, {n_flips} threshold flips, "
          f"end-to-end labels equal: {labels_equal}, features max |err| end to end "
          f"{e2e_feat_err}, from the same ROIs {feat_err:.3g}")

    # stage wall times of the kernel path (entry points called one by one)
    stage = {}
    sync()
    t0 = time.perf_counter()
    seg = segment_tile(rgb, cfg)
    sync()
    stage["segment_tile"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rois2, _ = extract_object_rois(seg["labels"], seg["hematoxylin"], cfg)
    sync()
    stage["extract_object_rois"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    compute_features(rois2, cfg)
    sync()
    stage["compute_features"] = time.perf_counter() - t0
    print("stages (s): " + json.dumps(stage))
    print(f"objects: {n_objects} in the slide, {k} analysed; features {tuple(feats.shape)}")

    # -- 4b. the RT path -----------------------------------------------------------
    rt_phases(torch, dev, sync, rgb_np, cfg, out, launches)

    # -- 4c. the near-data chains behind the gateways -----------------------------
    hema_np = near_data_phases(torch, dev, sync, rgb_np)
    glcm_b1 = glcm_b1_records(torch, dev, time_ms, bound, hema_np)
    del hema_np

    # -- 5.-7. the LM path -----------------------------------------------------
    del rgb, minv, k_st, p_st, out, plain, seg
    lm_rec, lm_launches = lm_phases(torch, dev, time_ms, sync, modules)
    for name, r in lm_rec.items():
        kernel, dname, *variant = name.split(":")
        print(json.dumps({"kernel": name, "launches": lm_launches[":".join([kernel, *variant])],
                          **{k: v for k, v in r.items() if k != "bound"},
                          "bound_ms": r["bound"][0]}))

    # -- 7b. the other LM families ---------------------------------------------
    fam_rec, fam_launches = lm_families_phases(torch, dev, time_ms, sync)
    for name, r in fam_rec.items():
        print(json.dumps({"kernel": name, **{k: v for k, v in r.items() if k != "bound"},
                          "bound_ms": r["bound"][0]}))

    # -- 8. the encoder-decoder family -----------------------------------------
    enc_rec, enc_launches = encdec_phases(torch, dev, time_ms, sync)
    for name, r in enc_rec.items():
        print(json.dumps({"kernel": name, **{k: v for k, v in r.items() if k != "bound"},
                          "bound_ms": r["bound"][0]}))

    # -- 9. training ---------------------------------------------------------------
    train_phases(torch, dev, sync)

    # -- 9b. the chunked route ------------------------------------------------------
    chunked_phases(torch, dev, time_ms, sync)

    # -- 10. the multi-device machinery ----------------------------------------------
    mesh_phases(torch, dev, sync)

    # -- 11. report --------------------------------------------------------------
    sources = {
        "color_deconv": ("color_deconv.cu", "src/repro/kernels/color_deconv.py:30"),
        "morph_recon": ("morph_recon.cu", "src/repro/kernels/morph_recon.py:50"),
        "ccl": ("ccl.cu", "src/repro/kernels/ccl.py:51"),
        "glcm": ("glcm.cu", "src/repro/kernels/glcm.py:40"),
        "flash_attention:swa": ("flash_attention.cu", "src/repro/kernels/flash_attention.py:104"),
        "flash_attention:global": ("flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:104"),
        "ssd_scan": ("ssd_scan.cu", "src/repro/kernels/ssd_scan.py:88"),
        # the new shapes of the families' paths (phase 7b)
        "flash_attention:qwen3": ("flash_attention.cu",
                                  "src/repro/kernels/flash_attention.py:104"),
        "flash_attention:gemma": ("flash_attention.cu",
                                  "src/repro/kernels/flash_attention.py:104"),
        "flash_attention:mla": ("flash_attention.cu", "src/repro/kernels/flash_attention.py:104"),
        "flash_attention:mla_f32": ("flash_attention.cu",
                                    "src/repro/kernels/flash_attention.py:104"),
        "ssd_scan:mamba2": ("ssd_scan.cu", "src/repro/kernels/ssd_scan.py:88"),
        # the encoder-decoder's path (phase 8): its encoder, not causal, and
        # its decoder's prefill
        "flash_attention:seamless_enc": ("flash_attention.cu",
                                         "src/repro/kernels/flash_attention.py:104"),
        "flash_attention:seamless_dec": ("flash_attention.cu",
                                         "src/repro/kernels/flash_attention.py:104"),
    }
    for name, r in [*rec.items(), *((f"morph_recon:{sub}", v) for sub, v in part.items())]:
        line = {"kernel": name, "launches": launches[name.split(":")[0]],
                "max_abs_err": r["max_abs_err"], "kernel_ms": r["ms"],
                "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
                "bound_ms": r["bound"][0]}
        line.update({k: r[k] for k in ("launches_per_call", "rounds_per_call", "tile_visits",
                                       "kernel_launches_per_call", "phase_ms")
                     if k in r})
        print(json.dumps(line))
    print(json.dumps(corridor_rec))
    for worst in ccl_worst:
        print(json.dumps(worst))
    print(json.dumps(glcm_wide))
    for r in glcm_b1:
        print(json.dumps(r))
    # the LM kernels' entries are their bf16 (the path's dtype) measurements;
    # attention has one entry for the SWA layers' calls and one for the global
    rec.update({name: lm_rec[f"{kernel}:bf16{variant}"] for name, kernel, variant in (
        ("flash_attention:swa", "flash_attention", ":swa"),
        ("flash_attention:global", "flash_attention", ":global"),
        ("ssd_scan", "ssd_scan", ""))})
    # the families' rows are their paths' dtypes: bf16, gemma's promoted float32
    rec.update({name: fam_rec[FAMILY_ROWS[name]] for name in FAMILY_ROWS})
    rec.update({name: enc_rec[ENCDEC_ROWS[name]] for name in ENCDEC_ROWS})
    launches.update(lm_launches)
    launches.update(fam_launches)
    launches.update(enc_launches)
    kernels = []
    for name, (src, replaces) in sources.items():
        r = rec[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}", "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"],
        })
        if name in FAMILY_ROWS or name in ENCDEC_ROWS:  # the instance and the path
            kernels[-1]["instance"] = r["instance"]
            kernels[-1]["path"] = launches[f"{name}:path"]
        elif name.startswith("flash_attention"):
            kernels[-1]["instance_launches"] = launches["flash_attention:instances"][
                name.split(":")[1]]
        if name == "ssd_scan":
            kernels[-1]["instance_launches"] = launches["ssd_scan:instances"]
            kernels[-1]["kernel_launches"] = launches["ssd_scan:kernel_launches"]
        if name == "ccl":
            kernels[-1]["kernel_launches"] = launches["ccl:kernel_launches"]
        if "phase_ms" in r:  # the device's time of a call, apart from the host's, by phase
            kernels[-1]["device_ms"] = r["phase_ms"]["device"]
            kernels[-1]["phase_ms"] = r["phase_ms"]
    print(f"chip_smoke: {time.perf_counter() - T_START:.1f} s from the start")
    print(f"nvidia-smi: {nvidia_smi()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


def rt_phases(torch, dev, sync, rgb_np: np.ndarray, cfg, kernel_out: dict,
              tile_launches: dict) -> None:
    """Phase 4b: the WSI path in its region-template form, then
    ``DevicePipeline``, on ``dev``. ``kernel_out`` is ``analyze_tile``'s
    result there and ``tile_launches`` its launch counts (phase 4). The
    tiled run and the pipeline cut the slide into 4x4 partitions."""
    import shutil
    import tempfile

    from repro_torch.core import BoundingBox, Intent, RegionTemplate
    from repro_torch.kernels import ccl as ccl_mod
    from repro_torch.kernels import color_deconv as cd_mod
    from repro_torch.kernels import glcm as glcm_mod
    from repro_torch.kernels import morph_recon as mr_mod
    from repro_torch.kernels import ops, ref
    from repro_torch.pipeline import FeatureStage, SegmentationStage, analyze_tile
    from repro_torch.pipeline import make_wsi_storage
    from repro_torch.runtime import DevicePipeline, SysEnv

    _, h, w = rgb_np.shape
    dom3 = BoundingBox((0, 0, 0), (3, h, w))
    dom2 = BoundingBox((0, 0), (h, w))

    def rt_run(reg, part: int, num_workers: int) -> dict:
        """One run of Segmentation -> Features over ``part``-sized
        partitions: a fresh template, the RGB put into DMS3 before the
        clock, the clock from ``startup_execution`` to the labels and
        features on the host."""
        rt = RegionTemplate("Patient")
        rgb_region = rt.new_region("RGB", dom3, np.float32, input_storage="DMS3", lazy=True)
        reg.get("DMS3").put(rgb_region.key, dom3, rgb_np)
        env = SysEnv(num_workers=num_workers, cpus_per_worker=2, accels_per_worker=1,
                     registry=reg)
        pairs = []
        for part2 in dom2.tiles((part, part)):
            part3 = BoundingBox((0,) + part2.lo, (3,) + part2.hi)
            seg = SegmentationStage(cfg, device=dev)
            seg.add_region_template(rt, "RGB", part3, Intent.INPUT, read_storage="DMS3")
            seg.add_region_template(rt, "Mask", part2, Intent.OUTPUT, storage="DMS2")
            seg.add_region_template(rt, "Hema", part2, Intent.OUTPUT, storage="DMS2")
            feat = FeatureStage(cfg, device=dev)
            feat.add_region_template(rt, "Mask", part2, Intent.INPUT, read_storage="DMS2")
            feat.add_region_template(rt, "Hema", part2, Intent.INPUT, read_storage="DMS2")
            feat.add_dependency(seg)
            env.execute_component(seg)
            env.execute_component(feat)
            pairs.append((part2, seg, feat))
        sync()
        t0 = time.perf_counter()
        env.startup_execution()
        labels = reg.get("DMS2").get(pairs[0][1].templates["Patient"].get("Mask").key, dom2)
        feats = [f.templates["Patient"].get("Features").data["features"] for _, _, f in pairs]
        wall = time.perf_counter() - t0
        env.finalize_system()
        task_s: dict[str, float] = {}  # the WRM's seconds a task name, all workers
        for worker in env.workers:
            for name, prof in worker.wrm.profile.items():
                task_s[name] = task_s.get(name, 0.0) + prof["cpu_s"] + prof["accel_s"]
        seg_rt = pairs[0][1].templates["Patient"]
        keys = {"RGB": rgb_region.key, "Mask": seg_rt.get("Mask").key,
                "Hema": seg_rt.get("Hema").key}
        return {"wall_s": wall, "labels": labels, "features": feats, "task_s": task_s,
                "keys": keys, "parts": [p for p, _, _ in pairs]}

    def reset_counts() -> None:
        for mod in (cd_mod, mr_mod, ccl_mod, glcm_mod):
            mod.launches = 0
        mr_mod.calls = mr_mod.rounds = mr_mod.tile_visits = 0
        ccl_mod.kernel_launches = 0

    def counts() -> dict:
        return {"color_deconv": cd_mod.launches, "morph_recon": mr_mod.launches,
                "morph_recon:calls": mr_mod.calls, "ccl": ccl_mod.launches,
                "ccl:kernel_launches": ccl_mod.kernel_launches, "glcm": glcm_mod.launches}

    # one analyze_tile's counts (phase 4 read them without the calls counter)
    reset_counts()
    analyze_tile(rgb_np, cfg, device=dev)
    sync()
    tile_counts = counts()
    if any(tile_counts[k] != tile_launches[k] for k in ("color_deconv", "ccl", "glcm")):
        fail(f"analyze_tile's launch counts moved between two calls: {tile_counts} "
             f"against {tile_launches}")

    # -- one partition at the paper's size ------------------------------------------
    reg = make_wsi_storage(h, w, mode="dms")
    want_labels = kernel_out["labels"].cpu().numpy()
    want_feats = kernel_out["features"].cpu().numpy()
    rt_walls, rt_counts = [], []
    for rep in range(4):  # one warm run, then three timed
        reset_counts()
        got = rt_run(reg, max(h, w), 1)
        rt_counts.append(counts())
        if not np.array_equal(got["labels"], want_labels):
            n_bad = int((got["labels"] != want_labels).sum())
            fail(f"RT labels read back from DMS2 differ from analyze_tile's at {n_bad} pixels")
        feats = got["features"][0]
        if feats.shape != want_feats.shape:
            fail(f"RT features {feats.shape}, analyze_tile's {want_feats.shape}")
        feat_err = float(np.abs(feats - want_feats).max()) if feats.size else 0.0
        if not np.allclose(feats, want_feats, rtol=FEATURE_TOL, atol=FEATURE_TOL):
            fail(f"RT features differ from analyze_tile's by {feat_err}")
        if rep:
            rt_walls.append(got["wall_s"])
    feats_equal = bool(np.array_equal(feats, want_feats))

    def host_s(fn, reps: int = 3) -> float:
        """Median host-clock seconds of ``fn`` (ending in a synchronise)."""
        times = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            times.append(time.perf_counter() - t0)
        return float(np.median(times))

    # the RT path's data movement, one piece at a time: the stores' reads and
    # writes (host copies) and the copies between host and card
    dms2, keys = reg.get("DMS2"), got["keys"]
    hema_np = dms2.get(keys["Hema"], dom2)
    moves = {
        "dms3_get_rgb": host_s(lambda: reg.get("DMS3").get(keys["RGB"], dom3)),
        "dms2_get_mask": host_s(lambda: dms2.get(keys["Mask"], dom2)),
        "dms2_get_hema": host_s(lambda: dms2.get(keys["Hema"], dom2)),
        "dms2_put_hema": host_s(lambda: dms2.put(keys["Hema"], dom2, hema_np)),
        "upload_rgb": host_s(lambda: torch.as_tensor(rgb_np, device=dev)),
        "upload_hema": host_s(lambda: torch.as_tensor(hema_np, device=dev)),
        "download_labels": host_s(lambda: kernel_out["labels"].cpu().numpy()),
    }
    for c in rt_counts:
        for k in ("color_deconv", "morph_recon:calls", "ccl", "ccl:kernel_launches", "glcm"):
            if c[k] != tile_counts[k]:
                fail(f"the RT path launched {k} {c[k]} times, analyze_tile {tile_counts[k]}")
        if c["morph_recon"] == 0:
            fail("the RT path never launched the morph_recon kernel")
    for name in ("DMS3", "DMS2"):
        reg.get(name).close()
    del reg

    plain_walls = []
    for rep in range(4):  # the same work: host numpy RGB in, host labels and features out
        sync()
        t0 = time.perf_counter()
        res = analyze_tile(rgb_np, cfg, device=dev)
        labels, feats = res["labels"].cpu().numpy(), res["features"].cpu().numpy()
        wall = time.perf_counter() - t0
        if rep:
            plain_walls.append(wall)
        if not np.array_equal(labels, want_labels):
            fail("analyze_tile's labels moved between two calls")
        del res
    rt_med, plain_med = float(np.median(rt_walls)), float(np.median(plain_walls))
    print(json.dumps({
        "rt": "one partition", "shape": list(rgb_np.shape), "rt_s": rt_walls,
        "plain_s": plain_walls, "rt_median_s": rt_med, "plain_median_s": plain_med,
        "overhead_pct": 100.0 * (rt_med - plain_med) / plain_med,
        "labels_equal": True, "features_equal": feats_equal, "features_max_abs_err": feat_err,
        "launches": rt_counts[-1], "analyze_tile_launches": tile_counts,
        "wrm_task_s": got["task_s"], "data_movement_s": moves,
    }), flush=True)

    # -- 16 partitions of 1024^2 over 3 workers, tiered stores ------------------------
    part = h // 4
    root = tempfile.mkdtemp(prefix="rt_tiers_")
    try:
        reg = make_wsi_storage(h, w, mode="tiered", tile=part, root=root)
        got = rt_run(reg, part, 3)
        mem_hit = {}
        for name in ("DMS3", "DMS2"):
            store = reg.get(name)
            store.drain()
            mem_hit[name] = store.tier_stats()["MEM"].hit_rate
            store.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    n_objects = 0
    for p, feats in zip(got["parts"], got["features"]):
        (y0, x0), (y1, x1) = p.lo, p.hi
        res = analyze_tile(rgb_np[:, y0:y1, x0:x1], cfg, device=dev)
        if not np.array_equal(got["labels"][y0:y1, x0:x1], res["labels"].cpu().numpy()):
            fail(f"RT labels of partition {p} differ from analyze_tile on its crop")
        if feats.shape != tuple(res["features"].shape) or not np.allclose(
                feats, res["features"].cpu().numpy(), rtol=FEATURE_TOL, atol=FEATURE_TOL):
            fail(f"RT features of partition {p} differ from analyze_tile on its crop")
        n_objects += len(feats)
    print(json.dumps({"rt": "tiled", "partitions": len(got["parts"]), "workers": 3,
                      "wall_s": got["wall_s"], "objects": n_objects,
                      "mem_hit_rate": mem_hit}), flush=True)

    # -- DevicePipeline: color deconvolution over 16 tiles ------------------------------
    minv = torch.from_numpy(ref.stain_inverse()).to(dev)
    tiles = [np.ascontiguousarray(rgb_np[:, y:y + part, x:x + part])
             for y in range(0, h, part) for x in range(0, w, part)]
    direct = [ops.color_deconv(torch.from_numpy(t).to(dev), minv).cpu().numpy() for t in tiles]
    # Timed as a stream is consumed: each result dropped before the next, so
    # its pinned buffer goes back to PyTorch's cache for the next download.
    # Keeping all 16 (as a list does) makes every download pin fresh memory,
    # timed once for comparison ("window2_kept").
    pipe_walls = {}
    for window, keep in ((1, False), (2, False), (2, True)):
        pipe = DevicePipeline(lambda t: ops.color_deconv(t, minv), window=window, device=dev)
        for i, out in enumerate(pipe.map(tiles)):  # the check; also warms buffers, streams
            if not np.array_equal(out, direct[i]):
                fail(f"DevicePipeline(window={window}) tile {i} differs from a direct call")
        pipe.stats = dict.fromkeys(pipe.stats, 0)
        kept = []
        sync()
        t0 = time.perf_counter()
        for out in pipe.map(tiles):
            if keep:
                kept.append(out)
        pipe_walls[f"window{window}" + ("_kept" if keep else "")] = time.perf_counter() - t0
        del kept
        if pipe.stats != {"uploaded": 16, "computed": 16, "downloaded": 16}:
            fail(f"DevicePipeline(window={window}) stats {pipe.stats}")
    # the host's share of a tile: pinning it, and a pinned buffer for its
    # result from PyTorch's cache
    tile_host_s = {
        "pin_tile": host_s(lambda: torch.from_numpy(tiles[0]).pin_memory()),
        "alloc_pinned_result": host_s(
            lambda: torch.empty(tiles[0].shape, dtype=torch.float32, pin_memory=True)),
    } if dev.type == "cuda" else {}
    print(json.dumps({"device_pipeline": "color_deconv", "tiles": len(tiles),
                      "tile_shape": list(tiles[0].shape), "wall_s": pipe_walls,
                      "host_s_a_tile": tile_host_s}), flush=True)


def near_data_phases(torch, dev, sync, rgb_np: np.ndarray) -> np.ndarray:
    """Phase 4c: the WSI path's third form, the near-data kernel chains
    served by ``RegionGateway``s over tiered stores whose DMS tier sits on
    spawned server processes behind the shared-memory transport. Every
    standard chain runs cold over the whole partition, is held bit for bit
    against the same chain run locally on ``store.get`` of the same ROI and
    stage by stage against the plain versions, and must move the launch
    counters as its stages say; 16 overlapping ROIs from 4 client threads
    must coalesce into fewer window fetches; every repeat must be a derived-
    cache hit that launches nothing. Returns the hematoxylin plane that the
    rank-2 chains read."""
    import shutil
    import tempfile
    import threading

    from repro_torch.core import BoundingBox, ElementType, RegionKey
    from repro_torch.kernels import ccl as ccl_mod
    from repro_torch.kernels import color_deconv as cd_mod
    from repro_torch.kernels import glcm as glcm_mod
    from repro_torch.kernels import morph_recon as mr_mod
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.chains import STANDARD_CHAINS, resolve_chain
    from repro_torch.pipeline import make_wsi_storage
    from repro_torch.serve import GatewayConfig
    from repro_torch.serve import compute as compute_mod

    _, h, w = rgb_np.shape
    dom3 = BoundingBox((0, 0, 0), (3, h, w))
    dom2 = BoundingBox((0, 0), (h, w))
    rgb_key = RegionKey("Patient", "RGB", ElementType.FLOAT32, 0)
    hema_key = RegionKey("Patient", "Hema", ElementType.FLOAT32, 0)

    def reset_counts() -> None:
        for mod in (cd_mod, mr_mod, ccl_mod, glcm_mod):
            mod.launches = 0
        mr_mod.calls = mr_mod.rounds = mr_mod.tile_visits = 0
        ccl_mod.kernel_launches = 0

    def counts() -> dict:
        return {"color_deconv": cd_mod.launches, "morph_recon:calls": mr_mod.calls,
                "morph_recon": mr_mod.launches, "ccl": ccl_mod.launches,
                "ccl:kernel_launches": ccl_mod.kernel_launches, "glcm": glcm_mod.launches}

    def expected_counts(chain, n: int = 1) -> dict:
        """What ``n`` runs of ``chain`` launch, by its stages; the
        reconstruction's launches (its rounds) are checked apart."""
        want = dict.fromkeys(counts(), 0)
        for stage in chain.stages:
            for k, v in NEAR_DATA_STAGE_COUNTS[stage.name].items():
                want[k] += n * (len(ccl_mod.PHASES) if v == "phases" else v)
        return want

    def check_counts(what: str, got: dict, want: dict) -> None:
        recon = got.pop("morph_recon")
        if got != {k: v for k, v in want.items() if k != "morph_recon"}:
            fail(f"{what} launched {got}, its stages say {want}")
        if (recon > 0) != (want["morph_recon:calls"] > 0):
            fail(f"{what} made {recon} reconstruction launches in "
                 f"{want['morph_recon:calls']} calls")
        got["morph_recon"] = recon

    # the plain versions on the card, stage by stage, each on the kernel
    # path's own input to that stage; the reconstruction and CCL run to their
    # fixed points (checked), GLCM's counts band by band (a whole 4096^2
    # window's one-hot matrices at 256 bins would take 34 GB)
    def plain_glcm(bins: torch.Tensor, nb: int) -> tuple[torch.Tensor, torch.Tensor]:
        g, hh = ref.glcm_bands_ref(bins, nb, NEAR_DATA_PLAIN_BAND_ROWS)
        return g.sum(dim=-3), hh.sum(dim=-2)

    def plain_stage(stage, x, params):
        if stage.name == "fill":
            seed, inv = ref.fill_holes_seed(x.to(torch.float32))
            rec = ref.morph_recon_ref(seed, inv, max_iters=FIXED_POINT_ITERS)
            if not torch.equal(ref.morph_recon_sweep_ref(rec, inv), rec):
                fail("the plain fill-holes did not reach its fixed point")
            return ((1.0 - rec) > 0.5).to(torch.uint8)
        if stage.name == "ccl":
            m = (x != 0).to(torch.int32)
            lab = ops.connected_components(m, impl="torch", max_iters=FIXED_POINT_ITERS)
            mb = m != 0
            fixed = torch.where(mb, lab, torch.full_like(lab, torch.iinfo(torch.int32).max))
            if not torch.equal(ref.ccl_sweep_ref(fixed, mb), fixed):
                fail("the plain ccl did not reach its fixed point")
            return lab
        if stage.name == "glcm":
            nb = params["num_bins"]
            g, hh = plain_glcm(ref.quantize_ref(x.to(torch.float32), nb)[None], nb)
            return torch.cat([ref.glcm_features_ref(g), ref.histogram_features_ref(hh)], -1)[0]
        return stage.fn(x, params, "torch")

    def stage_tol(stage, params) -> dict | None:
        """allclose tolerances of a stage's output, None for bit-exact."""
        if stage.name == "deconv":
            return dict(rtol=DECONV_TOL, atol=DECONV_TOL)
        if stage.name == "glcm":
            return dict(rtol=CHAIN_FEATURE_RTOL, atol=0.0)
        return None

    plain_checked: dict[tuple, float] = {}

    def check_plain(chain, source: str, x: torch.Tensor, local: np.ndarray) -> dict:
        """Holds each device stage of ``chain`` against its plain version on
        the same input (the kernel path's output of the stage before), and
        the composed result against ``local``; returns each stage's max
        |err|. Stages already checked on the same input are skipped."""
        params = chain.params_dict
        errs = {}
        prefix = source
        for stage in chain.stages:
            if stage.host:
                x = stage.fn(x.cpu().numpy(), params, "auto")
                break
            prefix += f"|{stage.name}:{sorted((k, params[k]) for k in stage.params)}"
            y = stage.fn(x, params, "auto")
            if prefix not in plain_checked:
                p = plain_stage(stage, x, params)
                tol = stage_tol(stage, params)
                if y.shape != p.shape or y.dtype != p.dtype:
                    fail(f"{chain.name}: stage {stage.name} gives {tuple(y.shape)} {y.dtype}, "
                         f"its plain version {tuple(p.shape)} {p.dtype}")
                if tol is None and not torch.equal(y, p):
                    fail(f"{chain.name}: stage {stage.name} differs from its plain version at "
                         f"{int((y != p).sum())} elements")
                err = (y.double() - p.double()).abs().max().item() if y.numel() else 0.0
                if tol is not None and not torch.allclose(y, p, **tol):
                    fail(f"{chain.name}: stage {stage.name} differs from its plain version "
                         f"by {err}")
                if stage.name == "glcm":  # and the counts behind the features, exactly
                    nb = params["num_bins"]
                    bins = ref.quantize_ref(x.to(torch.float32), nb)[None].contiguous()
                    which = glcm_mod.route(nb, bins.shape[-1])
                    before = glcm_mod.route_launches[which]
                    kg, kh = ops.glcm_histogram(bins, nb)
                    if which != ("shared" if nb <= 240 else "packed") or (
                            glcm_mod.route_launches[which] != before + 1):
                        fail(f"{chain.name}: GLCM at {nb} bins took the {which} route")
                    pg, ph = plain_glcm(bins, nb)
                    if not (torch.equal(kg, pg) and torch.equal(kh, ph)):
                        fail(f"{chain.name}: GLCM counts at B = 1, {nb} bins, differ from "
                             f"the plain version's")
                plain_checked[prefix] = err
            errs[stage.name] = plain_checked[prefix]
            x = y
        composed = x if isinstance(x, np.ndarray) else x.cpu().numpy()
        if composed.dtype != local.dtype or not np.array_equal(composed, local):
            fail(f"{chain.name}: the stages one by one differ from the local chain")
        return errs

    pipelines: list = []

    class RecordedPipeline(compute_mod.DevicePipeline):
        """The engine's pipeline, kept for its stats."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            pipelines.append(self)

    root = tempfile.mkdtemp(prefix="near_data_")
    reg = None
    pipeline_class = compute_mod.DevicePipeline
    compute_mod.DevicePipeline = RecordedPipeline
    try:
        t0 = time.perf_counter()
        reg = make_wsi_storage(h, w, mode="tiered", transport="shm", root=root,
                               server_processes=NEAR_DATA_SERVER_PROCESSES,
                               num_servers=NEAR_DATA_SERVERS,
                               serve=GatewayConfig(compute_cache_bytes=NEAR_DATA_CACHE_BYTES),
                               compute=True, device=dev)
        setup_s = time.perf_counter() - t0
        gw3, gw2 = reg.get("DMS3"), reg.get("DMS2")
        t0 = time.perf_counter()
        gw3.put(rgb_key, dom3, rgb_np)
        hema_np = resolve_chain("deconv")(rgb_np, device=dev)  # the hematoxylin plane
        gw2.put(hema_key, dom2, hema_np)
        put_s = time.perf_counter() - t0
        sources = {"rgb": (gw3, rgb_key, dom3), "hema": (gw2, hema_key, dom2)}
        print(f"near-data: {reg.server_group.num_servers} DMS servers in "
              f"{len(reg.server_group.procs)} processes (shm), gateways up in {setup_s:.1f} s, "
              f"RGB {rgb_np.shape} and hematoxylin {hema_np.shape} put in {put_s:.1f} s",
              flush=True)

        requests = [(name, None) for name in STANDARD_CHAINS]
        requests.append(("glcm", {"num_bins": GLCM_WIDE_BINS}))

        def source_of(chain) -> str:
            return "rgb" if 3 in chain.in_ranks else "hema"

        # -- each chain cold, over the whole partition ----------------------------
        rows, cold_out = [], {}
        for name, params in requests:
            chain = resolve_chain(name, params)
            src = source_of(chain)
            gw, key, roi = sources[src]
            stats0 = gw.engine.chain_stats.as_dict().get(chain.name, {})
            reset_counts()
            sync()
            t0 = time.perf_counter()
            out = gw.compute(key, roi, name, params)
            cold_s = time.perf_counter() - t0
            got_counts = counts()
            check_counts(f"the cold {chain.name} {params or ''}", got_counts,
                         expected_counts(chain))
            raw = gw.store.get(key, roi)
            sync()
            t0 = time.perf_counter()
            local = chain(raw, impl="auto", device=dev)
            local_s = time.perf_counter() - t0
            if out.dtype != local.dtype or not np.array_equal(out, local):
                fail(f"gateway compute({chain.name}) differs from the local chain on the "
                     f"same ROI")
            stage_err = check_plain(chain, src, torch.as_tensor(raw, device=dev), local)
            row = gw.engine.chain_stats.as_dict()[chain.name]
            cold_out[(name, chain.digest())] = out
            rows.append(dict(
                chain=chain.name, params=params or {}, source=src, shape=list(out.shape),
                cold_ms=cold_s * 1e3, local_ms=local_s * 1e3, launches=got_counts,
                raw_bytes=row["raw_bytes"] - stats0.get("raw_bytes", 0),
                derived_bytes=row["derived_bytes"] - stats0.get("derived_bytes", 0),
                plain_max_abs_err=stage_err,
            ))
            del raw, local

        # -- 16 overlapping 1024^2 ROIs from 4 client threads, coalesced ----------
        name = "deconv|threshold|ccl"
        chain = resolve_chain(name)
        side, stride = NEAR_DATA_ROI, NEAR_DATA_ROI_STRIDE
        starts = [i * stride for i in range(NEAR_DATA_ROI_GRID)]
        rois = [BoundingBox((0, y, x), (3, y + side, x + side)) for y in starts for x in starts]
        tickets: list = [None] * len(rois)
        errors: list = []

        def client(i: int) -> None:
            try:
                for j in range(i, len(rois), NEAR_DATA_CLIENTS):
                    tickets[j] = gw3.submit_compute(rgb_key, rois[j], name)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        before = gw3.stats.as_dict()
        gw3.pause()  # the burst queues, so that one drain coalesces it
        threads = [threading.Thread(target=client, args=(i,)) for i in range(NEAR_DATA_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        if errors or any(t is None for t in tickets):
            fail(f"coalesced batch: submission failed: {errors}")
        reset_counts()
        pipelines.clear()
        sync()
        t0 = time.perf_counter()
        gw3.resume()
        outs = [t.result(300) for t in tickets]
        batch_s = time.perf_counter() - t0
        batch_counts = counts()
        after = gw3.stats.as_dict()
        windows = after["compute_windows"] - before["compute_windows"]
        check_counts("the coalesced batch", batch_counts, expected_counts(chain, len(rois)))
        if windows >= len(rois):
            fail(f"{len(rois)} overlapping ROIs took {windows} window fetches")
        for roi, out in zip(rois, outs):
            want = chain(gw3.store.get(rgb_key, roi), device=dev)
            if out.dtype != want.dtype or not np.array_equal(out, want):
                fail(f"coalesced compute of {roi} differs from the local chain")
        pipe_stats = {k: sum(p.stats[k] for p in pipelines) for k in ("uploaded", "computed",
                                                                        "downloaded")}
        batch = dict(
            near_data="coalesced", chain=name, rois=len(rois), roi_shape=[3, side, side],
            stride=stride, clients=NEAR_DATA_CLIENTS, window_fetches=windows,
            coalesced=after["compute_coalesced"] - before["compute_coalesced"],
            wall_ms=batch_s * 1e3, launches=batch_counts, device_pipelines=len(pipelines),
            device_pipeline_stats=pipe_stats,
            raw_fetch_bytes=after["raw_fetch_bytes"] - before["raw_fetch_bytes"],
        )
        del outs

        # -- every chain again: a derived-cache hit that launches nothing ---------
        for row, (name, params) in zip(rows, requests):
            chain = resolve_chain(name, params)
            gw, key, roi = sources[source_of(chain)]
            hits0 = gw.stats.compute_cache_hits
            reset_counts()
            t0 = time.perf_counter()
            out = gw.compute(key, roi, name, params)
            row["warm_ms"] = (time.perf_counter() - t0) * 1e3
            if any(counts().values()):
                fail(f"the cached {chain.name} launched {counts()}")
            if gw.stats.compute_cache_hits != hits0 + 1:
                fail(f"the repeated {chain.name} was no derived-cache hit")
            if not np.array_equal(out, cold_out[(name, chain.digest())]):
                fail(f"the cached {chain.name} differs from its cold result")

        stats = {n: g.storage_stats() for n, g in (("DMS3", gw3), ("DMS2", gw2))}
        for n, st in stats.items():
            if st["gateway"]["compute_failed"]:
                fail(f"{n}'s gateway counted {st['gateway']['compute_failed']} failed computes")
        for row in rows:
            print(json.dumps({"near_data": "chain", **row}))
        print(json.dumps(batch))
        transports = {n: {d: e.get("transport") for d, e in st.get("dms", {}).items()}
                      for n, st in stats.items()}
        print(json.dumps({
            "near_data": "stores", "tiers": {n: st.get("tiers") for n, st in stats.items()},
            "transports": transports,
            "gateway": {n: {k: st["gateway"][k] for k in (
                "compute_requests", "compute_served", "compute_failed", "compute_cache_hits",
                "compute_windows", "compute_coalesced", "raw_fetch_bytes",
                "derived_reply_bytes")} for n, st in stats.items()},
            "derived_cache": {n: st["gateway"]["compute"]["cache"] for n, st in stats.items()},
        }, default=str), flush=True)
    finally:
        compute_mod.DevicePipeline = pipeline_class
        if reg is not None:
            for n in ("DMS3", "DMS2"):
                reg.get(n).close()
            group = getattr(reg, "server_group", None)
            if group is not None:
                group.close()
        shutil.rmtree(root, ignore_errors=True)

    if dev.type != "cuda":
        return hema_np
    # -- the cost of pinning a reply afresh, against PyTorch's pinned cache -----
    nbytes = h * w * 4  # one 4096^2 int32 label array
    held = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    t0 = time.perf_counter()
    fresh = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)  # the cache has none free
    fresh_ms = (time.perf_counter() - t0) * 1e3
    del fresh
    t0 = time.perf_counter()
    cached = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    cached_ms = (time.perf_counter() - t0) * 1e3
    del cached, held
    print(json.dumps({"near_data": "pinned_reply", "bytes": nbytes, "pin_fresh_ms": fresh_ms,
                      "pin_from_cache_ms": cached_ms}), flush=True)
    return hema_np


def glcm_b1_records(torch, dev, time_ms, bound, hema_np: np.ndarray) -> list[dict]:
    """GLCM at B = 1, the chains' one window (4096^2 of the hematoxylin
    plane), at 32 and 256 bins: the kernel's call and device times against
    its bound, the plain version (band by band) and ``bincount``; at 32 bins
    also the device time of one block for the whole window."""
    from repro_torch.kernels import glcm as glcm_mod
    from repro_torch.kernels import ops, ref

    h, w = hema_np.shape

    def plain_glcm(bins, nb):
        g, hh = ref.glcm_bands_ref(bins, nb, NEAR_DATA_PLAIN_BAND_ROWS)
        return g.sum(dim=-3), hh.sum(dim=-2)

    hema = torch.as_tensor(hema_np, device=dev)
    glcm_b1 = []
    pick_rows = {"shared": glcm_mod.band_rows, "packed": glcm_mod.packed_rows}
    for nb in GLCM_B1_BINS:
        bins = ref.quantize_ref(hema, nb)[None].contiguous()
        which = glcm_mod.route(nb, w)
        if which != ("shared" if nb <= 240 else "packed"):
            fail(f"glcm at B = 1, {nb} bins, takes the {which} route")
        idx = (bins[:, :, :-1].long() * nb + bins[:, :, 1:].long()).reshape(-1)
        rec = dict(
            kernel=f"glcm:b1:nb{nb}", shape=list(bins.shape), route=which, max_abs_err=0.0,
            rows=pick_rows[which](1, h, w, glcm_mod._num_sms(dev)),
            kernel_ms=time_ms(lambda: ops.glcm_histogram(bins, nb, impl="cuda"), 20),
            device_ms=device_ms(torch, lambda ev: glcm_mod.glcm_cuda(bins, nb, events=ev),
                                (), 20)["device"],
            plain_ms=time_ms(lambda: plain_glcm(bins, nb), 1, warmup=0),
            library_ms=time_ms(lambda: torch.bincount(idx, minlength=nb * nb), 10),
            bound_ms=bound(bins.numel() * 4 + (nb * nb + nb) * 4, 3 * bins.numel())[0],
        )
        if which == "shared":  # one block counts the whole window
            rec["one_block_device_ms"] = device_ms(
                torch, lambda ev: glcm_mod.glcm_cuda(bins, nb, rows=h, events=ev), (), 5)["device"]
        else:  # the route it replaced, counts held to the packed route's
            rec["global_device_ms"] = glcm_global_device_ms(
                torch, bins, nb, glcm_mod.glcm_cuda(bins, nb), 5)
        glcm_b1.append(rec)
        del bins, idx
    return glcm_b1


def glcm_global_device_ms(torch, bins, nb: int, want: tuple, reps: int) -> float:
    """Device time of GLCM's device-memory route (``rt_glcm_global``: float32
    atomics straight into device memory, the route of NB > 340 and, before
    the packed kernel, of NB > 240) on ``bins``, called through the kernel
    library for the comparison, so no launch counter moves; its counts must
    equal ``want`` (glcm, hist) bit for bit."""
    from repro_torch.kernels import _build

    b, h, w = bins.shape
    g = torch.empty((b, nb, nb), dtype=torch.float32, device=bins.device)
    hist = torch.empty((b, nb), dtype=torch.float32, device=bins.device)

    def call(events: list) -> None:
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events.extend(marks)
        marks[0].record()
        code = _build.lib().rt_glcm_global(bins.data_ptr(), g.data_ptr(), hist.data_ptr(),
                                           b, h, w, nb, _build.stream(bins))
        marks[1].record()
        _build.check(code, "glcm (device-memory route)")

    ms = device_ms(torch, call, (), reps)["device"]
    if not (torch.equal(g, want[0]) and torch.equal(hist, want[1])):
        fail(f"glcm's device-memory route at {nb} bins differs from the packed route")
    return ms


def serpentine(h: int, w: int) -> np.ndarray:
    """A 1-pixel corridor along every even row, turning at alternate ends."""
    m = np.zeros((h, w), bool)
    m[::2, :] = True
    for r in range(1, h, 2):
        m[r, -1 if (r // 2) % 2 == 0 else 0] = True
    return m


def lm_bound(nbytes: int, nops: int, dtype) -> tuple[float, str]:
    """The least time for the work: bytes at the HBM rate against operations
    at the peak rate of their type (bf16 on the tensor cores; float32 outside
    them, as TF32 would not hold float32's tolerance)."""
    import torch

    rate = TC_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / rate
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def device_ms(torch, call, phases, reps: int) -> dict[str, float]:
    """Median CUDA-event times of a kernel wrapper's phases over ``reps``
    calls, after one warm-up call. ``call(events)`` runs the wrapper once,
    passing it ``events``, a list that receives one event before its first
    phase and one after each of ``phases``. Each call is queued behind a
    device sleep, so the host has enqueued every launch before the first
    runs and the events time the device, not the host. Returns each phase's
    time and, as ``"device"``, the whole call's."""
    call([])
    times = {name: [] for name in (*phases, "device")}
    for _ in range(reps):
        events: list = []
        torch.cuda._sleep(PHASE_SLEEP_CYCLES)
        call(events)
        events[-1].synchronize()
        for name, e0, e1 in zip(phases, events, events[1:]):
            times[name].append(e0.elapsed_time(e1))
        times["device"].append(events[0].elapsed_time(events[-1]))
    return {name: float(np.median(v)) for name, v in times.items()}


def lm_phases(torch, dev, time_ms, sync, wsi_modules) -> tuple[dict, dict]:
    """Phases 5-7; returns (per-variant kernel records, LM path launches)."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd_mod
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import LM

    def flag(name: str) -> int:
        return int(LM_ARGV[LM_ARGV.index(name) + 1])

    cfg = get_config("hymba-1.5b")
    b, t, max_new = flag("--batch"), flag("--prompt-len"), flag("--max-new")
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    h, p, n, g = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_groups
    rec: dict[str, dict] = {}

    # -- 5. the LM kernels against their plain versions, the path's shapes --------
    gen = torch.Generator(device=dev).manual_seed(0)
    qpos = torch.arange(t, device=dev)[:, None]
    kpos = torch.arange(t, device=dev)[None, :]
    for dname in ATTN_TOLS:
        dtype = torch.bfloat16 if dname == "bf16" else torch.float32
        esize = torch.empty((), dtype=dtype).element_size()
        q = torch.randn((b, hq, t, d), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, hkv, t, d), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, hkv, t, d), generator=gen, device=dev).to(dtype)
        for lname, window in (("swa", cfg.window), ("global", None)):
            got = ops.attention(q, k, v, window=window, impl="cuda")
            want = ops.attention(q, k, v, window=window, impl="torch")
            sync()
            err = (got.float() - want.float()).abs().max().item()
            tol = ATTN_TOLS[dname]
            if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
                fail(f"flash_attention ({dname}, {lname}) disagrees with its plain version: "
                     f"max |err| {err}")
            if window is None:
                lib = partial(F.scaled_dot_product_attention, q, k, v, is_causal=True,
                              enable_gqa=True)
            else:
                mask = (kpos <= qpos) & (qpos - kpos < window)
                lib = partial(F.scaled_dot_product_attention, q, k, v, attn_mask=mask,
                              enable_gqa=True)
            lib_err = (lib().float() - want.float()).abs().max().item()
            pairs = sum(min(i + 1, window or t) for i in range(t))  # live (query, key) pairs
            rec[f"flash_attention:{dname}:{lname}"] = dict(
                instance=fa_mod.instance(dtype, d), max_abs_err=err, library_max_abs_err=lib_err,
                ms=time_ms(partial(ops.attention, q, k, v, window=window, impl="cuda"), 10),
                plain_ms=time_ms(partial(ops.attention, q, k, v, window=window, impl="torch"), 5),
                library_ms=time_ms(lib, 10),
                bound=lm_bound((2 * q.numel() + k.numel() + v.numel()) * esize,
                               4 * d * pairs * b * hq, dtype),
            )
        del q, k, v, got, want

        x = torch.randn((b, t, h, p), generator=gen, device=dev).to(dtype)
        dt = torch.rand((b, t, h), generator=gen, device=dev) * 0.1
        a = -torch.exp(torch.randn((h,), generator=gen, device=dev))
        bm = torch.randn((b, t, g, n), generator=gen, device=dev).to(dtype)
        cm = torch.randn((b, t, g, n), generator=gen, device=dev).to(dtype)
        dsk = torch.randn((h,), generator=gen, device=dev)
        before = ssd_mod.kernel_launches
        y, hf = ops.ssd_scan(x, dt, a, bm, cm, dsk, impl="cuda", chunk=cfg.ssm_chunk)
        per_call = ssd_mod.kernel_launches - before
        yr, hr = ops.ssd_scan(x, dt, a, bm, cm, dsk, impl="torch")
        sync()
        err = max((y.float() - yr.float()).abs().max().item(), (hf - hr).abs().max().item())
        tol = SSD_TOLS[dname]
        if not (torch.allclose(y.float(), yr.float(), rtol=tol, atol=tol)
                and torch.allclose(hf, hr, rtol=3e-4, atol=3e-4)):
            fail(f"ssd_scan ({dname}) disagrees with its plain version: max |err| {err}")
        phase_ms = device_ms(torch, lambda ev: ssd_mod.ssd_scan_cuda(
            x, dt, a, bm, cm, dsk, chunk=cfg.ssm_chunk, events=ev), ssd_mod.PHASES, 10)
        rec[f"ssd_scan:{dname}"] = dict(
            instance=ssd_mod.instance(dtype, n, p), kernel_launches=per_call,
            phase_ms=phase_ms, max_abs_err=err,
            ms=time_ms(partial(ops.ssd_scan, x, dt, a, bm, cm, dsk, impl="cuda",
                               chunk=cfg.ssm_chunk), 10),
            plain_ms=time_ms(partial(ops.ssd_scan, x, dt, a, bm, cm, dsk, impl="torch"), 2,
                             warmup=0),
            library_ms=None,
            # x in, y out, dt, B, C, a, D in, the final state out; the
            # recurrence's 6 flops per state element per step
            bound=lm_bound(2 * x.numel() * esize + dt.numel() * 4
                           + 2 * bm.numel() * esize + 2 * h * 4 + hf.numel() * 4,
                           6 * b * t * h * n * p, dtype),
        )
        del x, dt, a, bm, cm, dsk, y, hf, yr, hr
    torch.cuda.empty_cache()
    print("LM kernel checks: flash_attention and ssd_scan agree with their plain versions "
          f"at q {(b, hq, t, d)}, k/v {(b, hkv, t, d)}, x {(b, t, h, p)}", flush=True)

    # -- 6. the LM path: serve hymba-1.5b at full width and depth, bf16 -----------
    def reset_attention_counts() -> None:
        fa_mod.launches = fa_mod.swa_launches = 0
        fa_mod.instance_launches.update(dict.fromkeys(fa_mod.INSTANCES, 0))

    def reset_ssd_counts() -> None:
        ssd_mod.launches = ssd_mod.kernel_launches = 0
        ssd_mod.instance_launches.update(dict.fromkeys(ssd_mod.INSTANCES, 0))

    for mod in wsi_modules.values():
        mod.launches = 0
    reset_attention_counts()
    reset_ssd_counts()
    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    served = serve_main(LM_ARGV)
    sync()
    wall_s = time.perf_counter() - t0
    lm_launches = {"flash_attention:swa": fa_mod.swa_launches,
                   "flash_attention:global": fa_mod.launches - fa_mod.swa_launches,
                   "ssd_scan": ssd_mod.launches}
    path_instance = fa_mod.instance(cfg.compute_dtype, d)
    ssd_instance = ssd_mod.instance(cfg.compute_dtype, n, p)
    n_glob = cfg.num_global_layers
    expected = {"flash_attention:swa": (cfg.num_layers - n_glob) * LM_PREFILLS,
                "flash_attention:global": n_glob * LM_PREFILLS,
                "ssd_scan": cfg.num_layers * LM_PREFILLS}
    peak = torch.cuda.max_memory_allocated()
    print(f"LM path: serve_main {' '.join(LM_ARGV)} in {wall_s:.3f} s, launches "
          f"{lm_launches} (expected {expected}), prefill ms per "
          f"batch {served['prefill_ms']}, prefill {served['prefill_tok_per_s']:.1f} tok/s, "
          f"decode {served['decode_tok_per_s']:.2f} tok/s, "
          f"max_memory_allocated {peak} bytes", flush=True)
    for name, count in lm_launches.items():
        if count != expected[name]:
            fail(f"the LM path launched {name} {count} times, not {expected[name]} "
                 f"(a launch per layer per prefill)")
    if fa_mod.instance_launches[path_instance] != fa_mod.launches:
        fail(f"the bf16 LM path launched attention instances {fa_mod.instance_launches}, "
             f"not only {path_instance}")
    if (ssd_instance != "tensor_core"
            or ssd_mod.instance_launches[ssd_instance] != ssd_mod.launches
            or ssd_mod.kernel_launches != len(ssd_mod.PHASES) * ssd_mod.launches):
        fail(f"the bf16 LM path ran SSD instances {ssd_mod.instance_launches} in "
             f"{ssd_mod.kernel_launches} kernel launches, not the tensor-core one in "
             f"{len(ssd_mod.PHASES)} launches a call")
    lm_launches["ssd_scan:instances"] = dict(ssd_mod.instance_launches)
    lm_launches["ssd_scan:kernel_launches"] = ssd_mod.kernel_launches
    # one instance took every call, so the per-layer-kind split is exact
    lm_launches["flash_attention:instances"] = {
        kind: {**dict.fromkeys(fa_mod.INSTANCES, 0),
               path_instance: lm_launches[f"flash_attention:{kind}"]}
        for kind in ("swa", "global")}
    print(f"LM path attention instances: {fa_mod.instance_launches}, SSD instances "
          f"{ssd_mod.instance_launches} in {ssd_mod.kernel_launches} kernel launches",
          flush=True)
    for toks in served["outputs"]:
        if toks.shape != (b, t + max_new) or toks.min() < 0 or toks.max() >= cfg.vocab:
            fail(f"served tokens: shape {toks.shape} or ids outside [0, {cfg.vocab})")

    # -- 7. the LM path end to end in float32: kernels against plain versions ----
    cfg32 = cfg.replace(param_dtype=torch.float32, compute_dtype=torch.float32)
    model = LM(cfg32, device=dev, seed=0)
    prompt = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, (b, t)),
                             dtype=torch.int32, device=dev)
    reset_attention_counts()
    reset_ssd_counts()
    want = {"tensor_core": 0, "cuda_core": cfg.num_layers}
    steps, logit_err = float32_end_to_end(torch, sync, model, cfg32, prompt, None, "hymba-1.5b")
    if fa_mod.instance_launches != want:
        fail(f"the float32 prefill launched attention instances {fa_mod.instance_launches}, "
             f"not the CUDA-core kernel once a layer")
    if ssd_mod.instance_launches != want:
        fail(f"the float32 prefill ran SSD instances {ssd_mod.instance_launches}, "
             f"not the CUDA-core scan once a layer")
    del model, steps
    torch.cuda.empty_cache()
    return rec, lm_launches


def float32_end_to_end(torch, sync, model, cfg32, prompt, prefix, label: str, frames=None,
                       other: str = "torch"):
    """Prefill ``prompt`` (behind ``prefix``, if any; after an encoder pass
    over ``frames``, for an encoder-decoder) on the kernels
    (``cfg32``) and on the plain versions (``attn_impl=other``: "torch", or
    "chunked", the reference's chunked route), then
    E2E_DECODE_STEPS decode steps fed the plain path's greedy tokens (teacher
    forcing); fails unless the prefill logits agree within E2E_LOGIT_TOL and
    every decisive greedy token (top-two margin above it) is the same.
    Only the kernels' prefill launches kernels, so the counters read after
    this call hold its launches. Returns (the last-position logits of each
    step by path, the prefill logits' max |err|)."""
    from repro_torch.serve import make_cache, make_decode_step, make_prefill_step

    b, t = prompt.shape
    offset = 0 if prefix is None else prefix.shape[1]
    max_len = t + offset + E2E_DECODE_STEPS + 1
    batch = {"tokens": prompt} if prefix is None else {"tokens": prompt, "prefix": prefix}
    enc_len = 64 if frames is None else frames.shape[1]
    if frames is not None:
        batch["frames"] = frames
    plain = "plain" if other == "torch" else other
    paths = (("kernels", cfg32), (plain, cfg32.replace(attn_impl=other)))
    steps, caches = {}, {}
    with torch.no_grad():
        for name, c in paths:
            sync()
            t0 = time.perf_counter()
            logits, caches[name] = make_prefill_step(c)(
                model, batch, make_cache(c, b, max_len, enc_len=enc_len, device=prompt.device))
            sync()
            steps[name] = [logits[:, -1]]
            print(f"{label} float32 prefill ({name}) in {time.perf_counter() - t0:.3f} s",
                  flush=True)
        logit_err = (steps["kernels"][0] - steps[plain][0]).abs().max().item()
        if not torch.allclose(steps["kernels"][0], steps[plain][0],
                              rtol=E2E_LOGIT_TOL, atol=E2E_LOGIT_TOL):
            fail(f"{label} float32 prefill logits: kernels against {plain} max |err| "
                 f"{logit_err}")
        tok = torch.argmax(steps[plain][0], dim=-1)[:, None].to(torch.int32)
        for i in range(E2E_DECODE_STEPS):
            for name, c in paths:
                logits, caches[name] = make_decode_step(c)(model, tok, caches[name],
                                                           t + offset + i)
                steps[name].append(logits[:, -1])
            tok = torch.argmax(steps[plain][-1], dim=-1)[:, None].to(torch.int32)
    checked = differ = 0
    for lk, lp in zip(steps["kernels"], steps[plain]):
        top2 = torch.topk(lp, 2, dim=-1).values
        decisive = (top2[:, 0] - top2[:, 1]) > E2E_LOGIT_TOL
        same = torch.argmax(lk, dim=-1) == torch.argmax(lp, dim=-1)
        checked += int(decisive.sum())
        differ += int((decisive & ~same).sum())
    decode_err = max((lk - lp).abs().max().item()
                     for lk, lp in zip(steps["kernels"], steps[plain]))
    print(f"{label} float32 end to end: prefill logits max |err| {logit_err:.3g} "
          f"(tolerance {E2E_LOGIT_TOL}), decode logits max |err| {decode_err:.3g}; greedy "
          f"tokens over 1 + {E2E_DECODE_STEPS} steps: {checked} decisive, {differ} differ",
          flush=True)
    if differ:
        fail(f"{label}: {differ} greedy tokens differ where the top-two margin exceeds "
             f"{E2E_LOGIT_TOL}")
    del caches
    return steps, logit_err


def lm_families_phases(torch, dev, time_ms, sync) -> tuple[dict, dict]:
    """Phase 7b; returns (kernel records at the families' shapes, by
    ``kernel:dtype:model``; each family row's launches and the path that
    made them)."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd_mod
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import LM, registry
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    def flag(name: str) -> int:
        return int(FAMILY_ARGV[FAMILY_ARGV.index(name) + 1])

    b, t, max_new = flag("--batch"), flag("--prompt-len"), flag("--max-new")
    rec: dict[str, dict] = {}
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}

    def reset_counts() -> None:
        fa_mod.launches = fa_mod.swa_launches = 0
        fa_mod.instance_launches.update(dict.fromkeys(fa_mod.INSTANCES, 0))
        ssd_mod.launches = ssd_mod.kernel_launches = 0
        ssd_mod.instance_launches.update(dict.fromkeys(ssd_mod.INSTANCES, 0))

    def counts() -> dict:
        return {"flash_attention": dict(fa_mod.instance_launches),
                "ssd_scan": dict(ssd_mod.instance_launches),
                "ssd_scan:kernel_launches": ssd_mod.kernel_launches}

    # -- the two LM kernels at the families' new shapes -------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    attn = {}
    for arch, name in (("qwen3-0.6b", "qwen3"), ("gemma-2b", "gemma"),
                       ("deepseek-v2-lite-16b", "mla")):
        c = get_config(arch)
        d = c.qk_nope_dim + c.qk_rope_dim if c.attn_kind == "mla" else c.resolved_head_dim
        attn[name] = (c.num_heads, c.num_kv_heads, d)
    pairs = t * (t + 1) // 2  # live (query, key) pairs a head under the causal mask
    for name, (hq, hkv, d) in attn.items():
        for dname, dtype in dtypes.items():
            esize = torch.empty((), dtype=dtype).element_size()
            q = torch.randn((b, hq, t, d), generator=gen, device=dev).to(dtype)
            k = torch.randn((b, hkv, t, d), generator=gen, device=dev).to(dtype)
            v = torch.randn((b, hkv, t, d), generator=gen, device=dev).to(dtype)
            got = ops.attention(q, k, v, impl="cuda")
            want = ops.attention(q, k, v, impl="torch")
            sync()
            err = (got.float() - want.float()).abs().max().item()
            tol = ATTN_TOLS[dname]
            if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
                fail(f"flash_attention ({dname}, {name}, D = {d}) disagrees with its plain "
                     f"version: max |err| {err}")
            lib = partial(F.scaled_dot_product_attention, q, k, v, is_causal=True,
                          enable_gqa=True)
            lib_err = (lib().float() - want.float()).abs().max().item()
            rec[f"flash_attention:{dname}:{name}"] = dict(
                shape={"q": [b, hq, t, d], "kv": [b, hkv, t, d]},
                instance=fa_mod.instance(dtype, d), max_abs_err=err,
                library_max_abs_err=lib_err,
                ms=time_ms(partial(ops.attention, q, k, v, impl="cuda"), 10),
                plain_ms=time_ms(partial(ops.attention, q, k, v, impl="torch"), 3),
                library_ms=time_ms(lib, 10),
                bound=lm_bound((2 * q.numel() + k.numel() + v.numel()) * esize,
                               4 * d * pairs * b * hq, dtype),
            )
            del q, k, v, got, want
    mamba = get_config("mamba2-2.7b")
    h, p, n, g = mamba.ssm_heads, mamba.ssm_headdim, mamba.ssm_state, mamba.ssm_groups
    for dname, dtype in dtypes.items():
        esize = torch.empty((), dtype=dtype).element_size()
        x = torch.randn((b, t, h, p), generator=gen, device=dev).to(dtype)
        dt = torch.rand((b, t, h), generator=gen, device=dev) * 0.1
        a = -torch.exp(torch.randn((h,), generator=gen, device=dev))
        bm = torch.randn((b, t, g, n), generator=gen, device=dev).to(dtype)
        cm = torch.randn((b, t, g, n), generator=gen, device=dev).to(dtype)
        dsk = torch.randn((h,), generator=gen, device=dev)
        args = (x, dt, a, bm, cm, dsk)
        before = ssd_mod.kernel_launches
        y, hf = ops.ssd_scan(*args, impl="cuda", chunk=mamba.ssm_chunk)
        per_call = ssd_mod.kernel_launches - before
        yr, hr = ops.ssd_scan(*args, impl="torch")
        sync()
        err = max((y.float() - yr.float()).abs().max().item(), (hf - hr).abs().max().item())
        tol = SSD_TOLS[dname]
        if not (torch.allclose(y.float(), yr.float(), rtol=tol, atol=tol)
                and torch.allclose(hf, hr, rtol=3e-4, atol=3e-4)):
            fail(f"ssd_scan ({dname}, mamba2, N = {n}) disagrees with its plain version: "
                 f"max |err| {err}")
        rec[f"ssd_scan:{dname}:mamba2"] = dict(
            shape={"x": [b, t, h, p], "bc": [b, t, g, n]},
            instance=ssd_mod.instance(dtype, n, p), kernel_launches=per_call,
            phase_ms=device_ms(torch, lambda ev: ssd_mod.ssd_scan_cuda(
                *args, chunk=mamba.ssm_chunk, events=ev), ssd_mod.PHASES, 10),
            max_abs_err=err,
            ms=time_ms(partial(ops.ssd_scan, *args, impl="cuda", chunk=mamba.ssm_chunk), 10),
            plain_ms=time_ms(partial(ops.ssd_scan, *args, impl="torch"), 2, warmup=0),
            library_ms=None,
            bound=lm_bound(2 * x.numel() * esize + dt.numel() * 4
                           + 2 * bm.numel() * esize + 2 * h * 4 + hf.numel() * 4,
                           6 * b * t * h * n * p, dtype),
        )
        del x, dt, a, bm, cm, dsk, args, y, hf, yr, hr
    torch.cuda.empty_cache()
    print(f"LM family kernel checks: flash_attention at D = "
          f"{sorted({d for _, _, d in attn.values()})} and ssd_scan at N = {n} agree with "
          f"their plain versions in bf16 and float32", flush=True)

    # -- serve each family at full width and depth, bf16 ------------------------
    # gemma's embedding scale promotes the residual stream to float32
    gemma = get_config("gemma-2b")
    probe = {"tok": torch.zeros((1, gemma.d_model), dtype=torch.bfloat16, device=dev)}
    promoted = L.embed_tokens(probe, torch.zeros((1, 1), dtype=torch.int32, device=dev), gemma)
    if promoted.dtype != torch.float32:
        fail(f"gemma-2b's scaled embeddings are {promoted.dtype}, not float32 as the reference's")
    launches: dict = {}
    for arch, expect in FAMILY_SERVED.items():
        cfg = get_config(arch)
        argv = ["--arch", arch, *FAMILY_ARGV]
        reset_counts()
        sync()
        t0 = time.perf_counter()
        served = serve_main(argv)
        sync()
        wall_s = time.perf_counter() - t0
        got = counts()
        print(json.dumps({"lm_family": arch, "argv": " ".join(argv), "wall_s": wall_s,
                          "params": registry.count_params(cfg),
                          "prefill_ms": served["prefill_ms"],
                          "prefill_tok_per_s": served["prefill_tok_per_s"],
                          "decode_tok_per_s": served["decode_tok_per_s"],
                          "peak_bytes": served["peak_bytes"], "launches": got,
                          "nvidia_smi": nvidia_smi()}), flush=True)
        for kernel, (inst, want) in expect.items():
            total = sum(got[kernel].values())
            if total != want or got[kernel][inst] != want:
                fail(f"{arch}: the served path launched {kernel} instances {got[kernel]}, "
                     f"not {inst} {want} times (a launch per layer per prefill)")
        if got["ssd_scan:kernel_launches"] != len(ssd_mod.PHASES) * sum(got["ssd_scan"].values()):
            fail(f"{arch}: {got['ssd_scan:kernel_launches']} SSD kernel launches, not "
                 f"{len(ssd_mod.PHASES)} a call")
        for toks in served["outputs"]:
            if toks.shape != (b, t + max_new) or toks.min() < 0 or toks.max() >= cfg.vocab:
                fail(f"{arch} served tokens: shape {toks.shape} or ids outside [0, {cfg.vocab})")
        launches[arch] = got
        if arch == MESH_ARCH:  # phase 10(a) holds its mesh-of-one run to this one
            EARLIER["serve"] = {k: served[k] for k in ("outputs", "prefill_ms",
                                                       "decode_tok_per_s")}
        del served
        torch.cuda.empty_cache()

    # deepseek scores through LM.forward: MLA expands its keys and values and
    # attends on the tensor-core kernel at D = 192, a launch a layer
    ds = get_config("deepseek-v2-lite-16b")
    model = LM(ds, device=dev, seed=0)
    prompt = torch.as_tensor(np.random.default_rng(2).integers(0, ds.vocab, (b, t)),
                             dtype=torch.int32, device=dev)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = model(prompt)
    sync()
    score_s = time.perf_counter() - t0
    got = launches[f"{ds.name}:forward"] = counts()
    d192 = ds.qk_nope_dim + ds.qk_rope_dim
    print(json.dumps({"lm_family": ds.name, "path": "LM.forward (scoring)", "shape": [b, t],
                      "wall_s": score_s, "peak_bytes": torch.cuda.max_memory_allocated(),
                      "launches": got, "nvidia_smi": nvidia_smi()}), flush=True)
    if got["flash_attention"] != {"tensor_core": ds.num_layers, "cuda_core": 0}:
        fail(f"deepseek scoring launched attention instances {got['flash_attention']}, not "
             f"the tensor-core kernel at D = {d192} once a layer")
    if tuple(logits.shape) != (b, t, ds.vocab) or not bool(torch.isfinite(logits).all()):
        fail(f"deepseek scoring logits: shape {tuple(logits.shape)} or non-finite values")
    del model, logits
    torch.cuda.empty_cache()

    # -- float32 end to end at full width, cut to FAMILY_E2E_LAYERS deep --------
    for arch, what in FAMILY_E2E.items():
        cfg32 = get_config(arch).replace(num_layers=FAMILY_E2E_LAYERS,
                                         param_dtype=torch.float32,
                                         compute_dtype=torch.float32)
        label = f"{arch} ({FAMILY_E2E_LAYERS} of {get_config(arch).num_layers} layers; {what})"
        model = LM(cfg32, device=dev, seed=0)
        rng = np.random.default_rng(1)
        prompt = torch.as_tensor(rng.integers(0, cfg32.vocab, (b, t)), dtype=torch.int32,
                                 device=dev)
        prefix = None
        if cfg32.frontend:
            prefix = torch.as_tensor(rng.standard_normal(
                (b, cfg32.frontend_len, cfg32.d_model)).astype(np.float32) * 0.1, device=dev)
        if cfg32.attn_kind == "mla":  # scoring: the one MLA path on the kernel
            reset_counts()
            with torch.no_grad():
                fk = T.forward(model, prompt, cfg32)[0]
                fwd = launches[f"{arch}:forward_f32"] = counts()
                fp = T.forward(model, prompt, cfg32.replace(attn_impl="torch"))[0]
            ferr = (fk - fp).abs().max().item()
            print(f"{label}: forward logits max |err| {ferr:.3g} (tolerance {E2E_LOGIT_TOL}), "
                  f"attention {fwd['flash_attention']}", flush=True)
            if fwd["flash_attention"] != {"tensor_core": 0, "cuda_core": FAMILY_E2E_LAYERS}:
                fail(f"{arch} float32 forward launched attention {fwd['flash_attention']}")
            if not torch.allclose(fk, fp, rtol=E2E_LOGIT_TOL, atol=E2E_LOGIT_TOL):
                fail(f"{arch} float32 forward logits: kernels against plain max |err| {ferr}")
            del fk, fp
        reset_counts()
        steps, _ = float32_end_to_end(torch, sync, model, cfg32, prompt, prefix, label)
        got = counts()
        want_attn = 0 if cfg32.family == "ssm" or cfg32.attn_kind == "mla" else FAMILY_E2E_LAYERS
        want_ssd = FAMILY_E2E_LAYERS if cfg32.family == "ssm" else 0
        if (got["flash_attention"] != {"tensor_core": 0, "cuda_core": want_attn}
                or got["ssd_scan"] != {"tensor_core": 0, "cuda_core": want_ssd}):
            fail(f"{arch} float32 prefill launched {got}, not the CUDA-core instances "
                 f"({want_attn} attention, {want_ssd} SSD)")
        del model, steps, prompt, prefix
        torch.cuda.empty_cache()

    for arch in FAMILY_META_ONLY:  # beyond one card: counted on the meta device
        cfg = get_config(arch)
        total = sum(prm.numel() for prm in LM(cfg, device="meta").parameters())
        if total != registry.count_params(cfg):
            fail(f"{arch}: the meta-device model holds {total} parameters, the spec "
                 f"{registry.count_params(cfg)}")
        print(json.dumps({"lm_family": arch, "params": total,
                          "active_params": registry.count_active_params(cfg),
                          "bf16_bytes": 2 * total, "served": False}), flush=True)

    # each family row's launches on its path, and the path
    rows = {}
    for row, (kernel, run, path) in {
            "flash_attention:qwen3": ("flash_attention", "qwen3-0.6b",
                                      "launch.serve.main --arch qwen3-0.6b"),
            "flash_attention:gemma": ("flash_attention", "gemma-2b",
                                      "launch.serve.main --arch gemma-2b"),
            "flash_attention:mla": ("flash_attention", f"{ds.name}:forward",
                                    f"LM.forward, {ds.name}, bf16, full depth"),
            "flash_attention:mla_f32": ("flash_attention", f"{ds.name}:forward_f32",
                                        f"forward, {ds.name}, float32, "
                                        f"{FAMILY_E2E_LAYERS} layers"),
            "ssd_scan:mamba2": ("ssd_scan", "mamba2-2.7b",
                                "launch.serve.main --arch mamba2-2.7b")}.items():
        rows[row] = sum(launches[run][kernel].values())
        rows[f"{row}:path"] = path
    return rec, rows


def encdec_phases(torch, dev, time_ms, sync) -> tuple[dict, dict]:
    """Phase 8; returns (kernel records at seamless's shapes, by
    ``kernel:dtype:path``; each row's launches and the path that made them)."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ops
    from repro_torch.models import EncDec, registry
    from repro_torch.models import encdec as E
    from repro_torch.serve import generate

    cfg = get_config(SEAMLESS["arch"])
    b, t, s_enc, max_new = (SEAMLESS[k] for k in ("batch", "prompt_len", "enc_len", "max_new"))
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    rec: dict[str, dict] = {}

    def reset_counts() -> None:
        fa_mod.launches = fa_mod.swa_launches = fa_mod.noncausal_launches = 0
        fa_mod.instance_launches.update(dict.fromkeys(fa_mod.INSTANCES, 0))

    # -- the encoder's and the decoder prefill's attention, served shapes -------
    gen = torch.Generator(device=dev).manual_seed(8)
    dtype, esize = torch.bfloat16, 2
    for name, causal, tq in (("seamless_enc", False, s_enc), ("seamless_dec", True, t)):
        q, k, v = (torch.randn((b, h, tq, d), generator=gen, device=dev).to(dtype)
                   for h in (hq, hkv, hkv))
        got = ops.attention(q, k, v, causal=causal, impl="cuda")
        want = ops.attention(q, k, v, causal=causal, impl="torch")
        sync()
        err = (got.float() - want.float()).abs().max().item()
        tol = ATTN_TOLS["bf16"]
        if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
            fail(f"flash_attention (bf16, {name}, causal={causal}) disagrees with its plain "
                 f"version: max |err| {err}")
        lib = partial(F.scaled_dot_product_attention, q, k, v, is_causal=causal)
        lib_err = (lib().float() - want.float()).abs().max().item()
        pairs = tq * (tq + 1) // 2 if causal else tq * tq  # live (query, key) pairs a head
        rec[f"flash_attention:bf16:{name}"] = dict(
            shape={"q": [b, hq, tq, d], "kv": [b, hkv, tq, d]}, causal=causal,
            instance=fa_mod.instance(dtype, d), max_abs_err=err, library_max_abs_err=lib_err,
            ms=time_ms(partial(ops.attention, q, k, v, causal=causal, impl="cuda"), 10),
            plain_ms=time_ms(partial(ops.attention, q, k, v, causal=causal, impl="torch"), 3),
            library_ms=time_ms(lib, 10),
            bound=lm_bound((2 * q.numel() + k.numel() + v.numel()) * esize,
                           4 * d * pairs * b * hq, dtype),
        )
        del q, k, v, got, want
    torch.cuda.empty_cache()
    print(f"encdec kernel checks: flash_attention at ({b}, {hq}, {s_enc}, {d}) bf16, not "
          f"causal and causal, agrees with its plain version", flush=True)

    # -- serve seamless at full width and depth, bf16 ----------------------------
    torch.cuda.reset_peak_memory_stats()
    model = EncDec(cfg, device=dev, seed=0)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)
    frames = rng.standard_normal((b, s_enc, cfg.d_model)).astype(np.float32) * 0.1
    reset_counts()
    stats: dict = {}
    sync()
    t0 = time.perf_counter()
    toks = generate(model, cfg, prompt, max_new=max_new, frames=frames, device=dev, stats=stats)
    sync()
    wall_s = time.perf_counter() - t0
    got = {"flash_attention": dict(fa_mod.instance_launches),
           "not_causal": fa_mod.noncausal_launches}
    want_inst = {"tensor_core": cfg.enc_layers + cfg.num_layers, "cuda_core": 0}
    print(json.dumps({"lm_family": cfg.name, "path": "serve.generate",
                      "shape": {"prompt": [b, t], "frames": [b, s_enc, cfg.d_model],
                                "max_new": max_new},
                      "wall_s": wall_s, "params": registry.count_params(cfg),
                      "prefill_ms": 1e3 * stats["prefill_s"],
                      "prefill_tok_per_s": b * t / stats["prefill_s"],
                      "decode_tok_per_s": b * max_new / stats["decode_s"],
                      "peak_bytes": torch.cuda.max_memory_allocated(), "launches": got,
                      "nvidia_smi": nvidia_smi()}), flush=True)
    if got["flash_attention"] != want_inst or got["not_causal"] != cfg.enc_layers:
        fail(f"seamless: the served path launched attention {got}, not {want_inst} with "
             f"{cfg.enc_layers} not causal (a launch per layer per prefill)")
    if tuple(toks.shape) != (b, t + max_new) or toks.min() < 0 or toks.max() >= cfg.vocab:
        fail(f"seamless served tokens: shape {tuple(toks.shape)} or ids outside "
             f"[0, {cfg.vocab})")

    # -- the encoder alone, on the served shape ------------------------------------
    frames_t = torch.as_tensor(frames, device=dev)
    with torch.no_grad():
        enc = E.encode(model, frames_t, cfg)
        if tuple(enc.shape) != (b, s_enc, cfg.d_model) or not bool(torch.isfinite(enc).all()):
            fail(f"seamless encoder states: shape {tuple(enc.shape)} or non-finite values")
        encoder_ms = time_ms(partial(E.encode, model, frames_t, cfg), 5)
    print(json.dumps({"lm_family": cfg.name, "encoder_ms": encoder_ms,
                      "frames": [b, s_enc, cfg.d_model], "nvidia_smi": nvidia_smi()}), flush=True)
    del model, frames_t, enc, toks
    torch.cuda.empty_cache()

    # -- float32 end to end at full width, 2 + 2 layers ----------------------------
    n = SEAMLESS_E2E_LAYERS
    cfg32 = cfg.replace(num_layers=n, enc_layers=n, param_dtype=torch.float32,
                        compute_dtype=torch.float32)
    model = EncDec(cfg32, device=dev, seed=0)
    rng = np.random.default_rng(1)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (b, t)), dtype=torch.int32, device=dev)
    frames32 = torch.as_tensor(rng.standard_normal((b, s_enc, cfg.d_model)).astype(np.float32)
                               * 0.1, device=dev)
    reset_counts()
    label = f"{cfg.name} ({n} + {n} of {cfg.enc_layers} + {cfg.num_layers} layers)"
    steps, _ = float32_end_to_end(torch, sync, model, cfg32, prompt, None, label, frames=frames32)
    if (fa_mod.instance_launches != {"tensor_core": 0, "cuda_core": 2 * n}
            or fa_mod.noncausal_launches != n):
        fail(f"seamless float32 prefill launched attention {fa_mod.instance_launches} "
             f"({fa_mod.noncausal_launches} not causal), not the CUDA-core kernel "
             f"{2 * n} times, {n} not causal")
    del model, steps, prompt, frames32
    torch.cuda.empty_cache()
    path = f"serve.generate, {cfg.name}, frames ({b}, {s_enc}, {cfg.d_model})"
    rows = {"flash_attention:seamless_enc": got["not_causal"],
            "flash_attention:seamless_enc:path": f"{path} (encoder)",
            "flash_attention:seamless_dec": (sum(got["flash_attention"].values())
                                             - got["not_causal"]),
            "flash_attention:seamless_dec:path": f"{path} (decoder prefill)"}
    return rec, rows


def train_phases(torch, dev, sync) -> None:
    """Phase 9: train qwen3-0.6b at full width and depth through
    ``launch.train.main``, restore its checkpoint, and hold one float32 train
    step at full width, 2 layers deep, against the CPU."""
    import copy
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.convert import LayerStack, reference_leaves
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ssd_scan as ssd_mod
    from repro_torch.launch.train import main as train_main
    from repro_torch.storage import CheckpointManager, DiskStorage
    from repro_torch.storage.checkpoint import _leaf_paths
    from repro_torch.train import AdamW, init_state, make_train_step

    def flag(name: str) -> int:
        return int(TRAIN_ARGV[TRAIN_ARGV.index(name) + 1])

    cfg = get_config(TRAIN_ARGV[TRAIN_ARGV.index("--arch") + 1])
    steps, bsz, seq = flag("--steps"), flag("--batch"), flag("--seq")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckdir:
        argv = [*TRAIN_ARGV, "--ckpt-dir", ckdir]
        fa_mod.launches = ssd_mod.launches = 0
        torch.cuda.reset_peak_memory_stats()
        sync()
        t0 = time.perf_counter()
        run = train_main(argv)
        sync()
        wall_s = time.perf_counter() - t0
        launched = {"flash_attention": fa_mod.launches, "ssd_scan": ssd_mod.launches}
        losses, step_ms = run["losses"], run["step_ms"]
        median_ms = float(np.median(step_ms[1:steps]))  # steps 2-20
        save = run["async_save"]
        print(json.dumps({
            "train": cfg.name, "argv": " ".join(TRAIN_ARGV), "wall_s": wall_s,
            "params": sum(p.numel() for p in run["state"]["params"].parameters()),
            "median_step_ms": median_ms, "tokens_per_s": run["tokens_per_step"] / median_ms * 1e3,
            "peak_bytes": run["peak_bytes"],
            "loss": {"0": losses[0], "10": losses[10], str(steps - 1): losses[steps - 1]},
            "step_ms": step_ms, "async_save": save, "kernel_launches": launched,
            "nvidia_smi": nvidia_smi()}), flush=True)
        if len(losses) != steps or not all(np.isfinite(losses)):
            fail(f"training: {len(losses)} losses, not {steps}, or non-finite ones")
        if not losses[steps - 1] < losses[0]:
            fail(f"training: the loss did not fall ({losses[0]}, {losses[10]}, "
                 f"{losses[steps - 1]} at steps 0, 10, {steps - 1})")
        if any(launched.values()):
            fail(f"training launched kernels {launched}; it runs the plain versions "
                 f"(no kernel has a backward)")
        if save is None or save["step"] != 10 or save["bytes"] <= 0:
            fail(f"training: the async save at step 10 is missing: {save}")
        EARLIER["train"] = {"losses": losses, "median_step_ms": median_ms}

        # the saved state, restored into a fresh one, equals the trained one bit for bit
        ck = CheckpointManager(DiskStorage(ckdir), keep=2)
        if ck.latest_step() != steps:
            fail(f"training: the final save is at step {ck.latest_step()}, not {steps}")
        trained = run["state"]
        restored = ck.restore(init_state(cfg.replace(attn_impl="torch"), AdamW(), seed=1,
                                         device=dev))
        want, have = dict(_leaf_paths(trained)), dict(_leaf_paths(restored))
        if set(want) != set(have):
            fail(f"restore: leaves {sorted(set(want) ^ set(have))} differ")
        n_bytes = 0
        for name, leaf in want.items():
            pairs = (zip(leaf, have[name]) if isinstance(leaf, LayerStack)
                     else [(leaf, have[name])])
            for a, b_ in pairs:
                if a.dtype != b_.dtype or not torch.equal(a.detach(), b_.detach().to(a.device)):
                    fail(f"restore: leaf {name} is not bit for bit the saved one")
                n_bytes += a.numel() * a.element_size()
        print(f"training restore: {len(want)} leaves, {n_bytes} bytes, bit for bit the saved "
              f"state at step {int(restored['step'])}", flush=True)
        del run, trained, restored, want, have
        torch.cuda.empty_cache()

        sync()
        t0 = time.perf_counter()
        again = train_main([*argv[:argv.index("--steps") + 1], str(TRAIN_RESTORED_STEPS),
                            *argv[argv.index("--steps") + 2:], "--restore"])
        sync()
        print(json.dumps({"train": cfg.name, "restored_from": again["start_step"],
                          "steps": len(again["losses"]), "first_loss": again["losses"][0],
                          "last_loss": again["losses"][-1],
                          "wall_s": time.perf_counter() - t0}), flush=True)
        if again["start_step"] != steps or len(again["losses"]) != TRAIN_RESTORED_STEPS - steps:
            fail(f"the restored run started at {again['start_step']} and ran "
                 f"{len(again['losses'])} steps")
        if not np.isfinite(again["losses"]).all():
            fail(f"the restored run's losses are not finite: {again['losses']}")
        del again
        torch.cuda.empty_cache()

    # one float32 train step at full width, 2 layers: the card against the CPU
    cfg32 = cfg.replace(num_layers=TRAIN_E2E["layers"], param_dtype=torch.float32,
                        compute_dtype=torch.float32, attn_impl="torch")
    optim = AdamW()
    cpu = init_state(cfg32, optim, seed=0, device="cpu")
    model = copy.deepcopy(cpu["params"]).to(dev)
    card = {"params": model, "opt": optim.init(reference_leaves(model)),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}
    batch = SyntheticTokens(cfg.vocab, TRAIN_E2E["seq"], TRAIN_E2E["batch"], seed=0).batch_at(0)
    step = make_train_step(cfg32, optim)
    _, m_cpu = step(cpu, {k: torch.from_numpy(v) for k, v in batch.items()})
    _, m_card = step(card, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
    loss_err = abs(float(m_card["loss"]) - float(m_cpu["loss"]))
    norm_rel = abs(float(m_card["grad_norm"]) / float(m_cpu["grad_norm"]) - 1.0)
    print(json.dumps({"train_f32": cfg.name, "layers": TRAIN_E2E["layers"],
                      "tokens": [TRAIN_E2E["batch"], TRAIN_E2E["seq"]],
                      "loss_card": float(m_card["loss"]), "loss_cpu": float(m_cpu["loss"]),
                      "loss_abs_err": loss_err, "grad_norm_card": float(m_card["grad_norm"]),
                      "grad_norm_cpu": float(m_cpu["grad_norm"]), "grad_norm_rel_err": norm_rel}),
          flush=True)
    if loss_err > TRAIN_LOSS_TOL or norm_rel > TRAIN_NORM_RTOL:
        fail(f"the float32 train step on the card: loss off the CPU's by {loss_err} "
             f"(tolerance {TRAIN_LOSS_TOL}), grad_norm by {norm_rel} relative "
             f"(tolerance {TRAIN_NORM_RTOL})")
    del cpu, card, model
    torch.cuda.empty_cache()



def chunked_phases(torch, dev, time_ms, sync) -> None:
    """Phase 9b: the chunked route in qwen3-0.6b's and mamba2-2.7b's prefill
    and in qwen3-0.6b's training, against the kernel and plain routes (see
    the constants); one JSON line a part, tagged ``"chunked"``."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd_mod
    from repro_torch.models import LM
    from repro_torch.serve import make_cache, make_prefill_step
    from repro_torch.train import AdamW, AdamWConfig, cosine_lr, init_state, make_train_step

    def flag(argv: list, name: str) -> int:
        return int(argv[argv.index(name) + 1])

    def reset_counts() -> None:
        fa_mod.launches = fa_mod.swa_launches = 0
        fa_mod.instance_launches.update(dict.fromkeys(fa_mod.INSTANCES, 0))
        ssd_mod.launches = ssd_mod.kernel_launches = 0
        ssd_mod.instance_launches.update(dict.fromkeys(ssd_mod.INSTANCES, 0))

    def counts() -> dict:
        return {"flash_attention": fa_mod.launches, "ssd_scan": ssd_mod.launches}

    b, t = flag(FAMILY_ARGV, "--batch"), flag(FAMILY_ARGV, "--prompt-len")
    impls = {"kernels": "auto", "chunked": "chunked", "plain": "torch"}

    def prefill_routes(arch: str, op: str, tol: float, routes: tuple) -> None:
        """Prefill ``arch`` in bf16 on each of ``routes``: each route's
        launches, peak and prefill time; every call of ``ops.<op>`` on the
        kernel route held against the chunked route on the same inputs; the
        chunked route's logits and greedy tokens against the other routes'
        reported. Then the chunked route held end to end in float32."""
        cfg = get_config(arch)
        model = LM(cfg, device=dev, seed=0)
        prompt = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab, (b, t)),
                                 dtype=torch.int32, device=dev)
        batch = {"tokens": prompt}
        cfgs = {r: cfg.replace(attn_impl=impls[r]) for r in routes}
        caches = {r: make_cache(cfgs[r], b, t + 1, device=dev) for r in routes}
        steps = {r: make_prefill_step(cfgs[r]) for r in routes}
        # every layer's call on the kernel route, against the chunked route
        orig, held = getattr(ops, op), []

        def holding(*args, **kw):  # one entry a call: (max |err|, within tol)
            out = orig(*args, **kw)
            alt = orig(*args, **{**kw, "impl": "chunked"})
            pairs = list(zip(out, alt)) if op == "ssd_scan" else [(out, alt)]  # y, state
            held.append((max((g.float() - w.float()).abs().max().item() for g, w in pairs),
                         all(torch.allclose(g.float(), w.float(), rtol=tol, atol=tol)
                             for g, w in pairs)))
            return out

        setattr(ops, op, holding)
        try:
            with torch.no_grad():
                steps["kernels"](model, batch, caches["kernels"])
        finally:
            setattr(ops, op, orig)
        sync()
        logits, launches, peak, ms = {}, {}, {}, {}
        with torch.no_grad():
            for r in routes:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                resident = torch.cuda.memory_allocated()
                reset_counts()
                sync()
                logits[r] = steps[r](model, batch, caches[r])[0][:, -1].float()
                sync()
                launches[r], peak[r] = counts(), torch.cuda.max_memory_allocated()
                peak[r] = {"peak_bytes": peak[r], "above_resident_bytes": peak[r] - resident}
                ms[r] = time_ms(lambda r=r: steps[r](model, batch, caches[r]),
                                CHUNKED_PREFILL_REPS, warmup=0)
        err = {f"chunked_vs_{r}": (logits["chunked"] - logits[r]).abs().max().item()
               for r in routes if r != "chunked"}
        top2 = torch.topk(logits["kernels"], 2, dim=-1).values
        decisive = (top2[:, 0] - top2[:, 1]) > tol
        same = torch.argmax(logits["chunked"], -1) == torch.argmax(logits["kernels"], -1)
        differ = int((decisive & ~same).sum())
        print(json.dumps({
            "chunked": f"{arch} prefill", "shape": [b, t], "dtype": str(cfg.compute_dtype),
            "prefill_ms": ms, "memory": peak, "launches": launches,
            f"{op}_calls_held": len(held), f"{op}_max_abs_err": max(e for e, _ in held),
            "tolerance": tol, "logits_max_abs_err": err,
            "greedy_decisive": int(decisive.sum()), "greedy_differ": differ,
            "nvidia_smi": nvidia_smi()}), flush=True)
        kernel = "flash_attention" if op == "attention" else "ssd_scan"
        if len(held) != cfg.num_layers or not all(ok for _, ok in held):
            fail(f"phase 9b: {arch}'s {op} on the kernel route against the chunked route "
                 f"over {len(held)} calls (not {cfg.num_layers}): max |err| "
                 f"{max(e for e, _ in held)} (tolerance {tol})")
        if launches["kernels"][kernel] != cfg.num_layers or any(
                launches[r][k] for r in routes if r != "kernels" for k in launches[r]):
            fail(f"phase 9b: {arch}'s prefill launched {launches}: {kernel} once a layer on "
                 f"the kernel route only")
        if not bool(torch.isfinite(logits["chunked"]).all()) or logits["chunked"].shape != (
                b, cfg.vocab):
            fail(f"phase 9b: {arch}'s chunked prefill logits: shape "
                 f"{tuple(logits['chunked'].shape)} or non-finite values")
        del model, caches, logits
        torch.cuda.empty_cache()
        # end to end in float32 at full depth: the chunked route's prefill
        # logits and decisive greedy tokens against the kernel route's
        cfg32 = cfg.replace(param_dtype=torch.float32, compute_dtype=torch.float32)
        model = LM(cfg32, device=dev, seed=0)
        reset_counts()
        _, f32_err = float32_end_to_end(torch, sync, model, cfg32, prompt, None,
                                        f"phase 9b: {arch}, full depth", other="chunked")
        got, want = counts(), {"flash_attention": 0, "ssd_scan": 0, kernel: cfg.num_layers}
        print(json.dumps({"chunked": f"{arch} float32 end to end", "shape": [b, t],
                          "logits_max_abs_err": f32_err, "tolerance": E2E_LOGIT_TOL,
                          "launches": got}), flush=True)
        if got != want:
            fail(f"phase 9b: {arch}'s float32 prefills launched {got}, not {want} (once a "
                 f"layer on the kernel route only)")
        del model
        torch.cuda.empty_cache()

    # -- (a) attention: qwen3-0.6b; (b) the SSD scan: mamba2-2.7b -----------------------
    # (the plain SSD scan steps 2048 positions in Python a layer: left out)
    prefill_routes(MESH_ARCH, "attention", ATTN_TOLS["bf16"], ("kernels", "chunked", "plain"))
    prefill_routes("mamba2-2.7b", "ssd_scan", SSD_TOLS["bf16"], ("kernels", "chunked"))

    # -- (c) training on the plain and the chunked routes, in turns ----------------------
    cfg = get_config(TRAIN_ARGV[TRAIN_ARGV.index("--arch") + 1])
    bsz, seq = flag(TRAIN_ARGV, "--batch"), flag(TRAIN_ARGV, "--seq")
    lr = float(TRAIN_ARGV[TRAIN_ARGV.index("--lr") + 1])
    total = flag(TRAIN_ARGV, "--steps")  # phase 9's schedule: the same warmup steps
    optim = AdamW(AdamWConfig(lr=lr))
    sched = lambda s: cosine_lr(s, base=lr, warmup=10, total=total)  # noqa: E731
    source = SyntheticTokens(cfg.vocab, seq, bsz, seed=0, num_steps=CHUNKED_TRAIN_STEPS)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in source.batch_at(i).items()}
               for i in range(CHUNKED_TRAIN_STEPS)]
    blocks = []
    reset_counts()
    for impl in CHUNKED_TRAIN_ORDER:
        c = cfg.replace(attn_impl=impl)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = init_state(c, optim, seed=0, device=dev)
        step_fn = make_train_step(c, optim, lr_schedule=sched)
        losses, step_ms = [], []
        for i in range(CHUNKED_TRAIN_STEPS):
            sync()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batches[i])
            losses.append(float(metrics["loss"]))  # waits for the step
            step_ms.append(1e3 * (time.perf_counter() - t0))
        blocks.append({"attn_impl": impl, "losses": losses, "step_ms": step_ms,
                       "median_step_ms": float(np.median(step_ms[1:])),
                       "peak_bytes": torch.cuda.max_memory_allocated()})
        del state, step_fn, metrics
    launched = counts()
    torch.cuda.empty_cache()
    by = {impl: [blk for blk in blocks if blk["attn_impl"] == impl]
          for impl in ("torch", "chunked")}
    last = CHUNKED_TRAIN_STEPS - 1
    errs = {str(i): max(abs(x["losses"][i] - y["losses"][i])
                        for x in by["chunked"] for y in by["torch"]) for i in (0, last)}
    print(json.dumps({
        "chunked": f"{cfg.name} train", "tokens": [bsz, seq], "lr": lr,
        "order": list(CHUNKED_TRAIN_ORDER),
        "median_step_ms": {k: [blk["median_step_ms"] for blk in v] for k, v in by.items()},
        "peak_bytes": {k: [blk["peak_bytes"] for blk in v] for k, v in by.items()},
        "loss": {k: [{str(i): blk["losses"][i] for i in (0, last)} for blk in v]
                 for k, v in by.items()},
        "loss_abs_err": errs, "tolerance": MESH_LOSS_TOL, "kernel_launches": launched,
        "step_ms": {k: [blk["step_ms"] for blk in v] for k, v in by.items()},
        "nvidia_smi": nvidia_smi()}), flush=True)
    for blk in blocks:
        if not all(np.isfinite(blk["losses"])) or not blk["losses"][last] < blk["losses"][0]:
            fail(f"phase 9b: training on {blk['attn_impl']}: the loss did not fall or is not "
                 f"finite: {blk['losses']}")
    if max(errs.values()) > MESH_LOSS_TOL:
        fail(f"phase 9b: the chunked route's losses off the plain route's by {errs} "
             f"(tolerance {MESH_LOSS_TOL})")
    if any(launched.values()):
        fail(f"phase 9b: training launched kernels {launched}; both routes are plain torch")


def mesh_phases(torch, dev, sync) -> None:
    """Phase 10: the launchers on their one-rank mesh against phases 7b and 9,
    two ranks on the one card, and two dry-run cells (see the constants)."""
    import tempfile
    from contextlib import nullcontext

    import torch.multiprocessing as mp

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.dryrun import run_cell, sequential_collectives
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import build
    from repro_torch.models.spec import activation_sharding
    from repro_torch.serve import generate
    from repro_torch.train import AdamW, AdamWConfig, init_state, make_train_step

    # -- (a) the launchers' one-rank mesh ------------------------------------------------
    argv = ["--arch", MESH_ARCH, *FAMILY_ARGV]
    sync()
    t0 = time.perf_counter()
    served = serve_main(argv)
    sync()
    wall_s = time.perf_counter() - t0
    same = all(np.array_equal(a, b) for a, b in zip(served["outputs"],
                                                    EARLIER["serve"]["outputs"]))
    print(json.dumps({"mesh_of_one": "serve", "argv": " ".join(argv), "wall_s": wall_s,
                      "prefill_ms": served["prefill_ms"],
                      "decode_tok_per_s": served["decode_tok_per_s"],
                      "phase_7b": {k: EARLIER["serve"][k] for k in ("prefill_ms",
                                                                    "decode_tok_per_s")},
                      "tokens_equal_7b": same}), flush=True)
    if not same:
        fail("phase 10(a): the mesh of one served other tokens than phase 7b")
    del served
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as ckdir:
        steps_at = TRAIN_ARGV.index("--steps") + 1
        argv = [*TRAIN_ARGV[:steps_at], str(MESH_TRAIN_STEPS), *TRAIN_ARGV[steps_at + 1:],
                "--ckpt-dir", ckdir]
        argv[argv.index("--ckpt-every") + 1] = "0"
        sync()
        t0 = time.perf_counter()
        run = train_main(argv)
        sync()
        wall_s = time.perf_counter() - t0
    losses, earlier = run["losses"], EARLIER["train"]
    last = MESH_TRAIN_STEPS - 1
    errs = {str(i): abs(losses[i] - earlier["losses"][i]) for i in (0, last)}
    median_ms = float(np.median(run["step_ms"][1:]))
    print(json.dumps({"mesh_of_one": "train", "argv": " ".join(argv[:-2]), "wall_s": wall_s,
                      "loss": {str(i): losses[i] for i in (0, last)},
                      "phase_9_loss": {str(i): earlier["losses"][i] for i in (0, last)},
                      "loss_abs_err": errs, "median_step_ms": median_ms,
                      "phase_9_median_step_ms": earlier["median_step_ms"]}), flush=True)
    if len(losses) != MESH_TRAIN_STEPS or max(errs.values()) > MESH_LOSS_TOL:
        fail(f"phase 10(a): the mesh of one trained {len(losses)} steps, losses off phase 9's "
             f"by {errs} (tolerance {MESH_LOSS_TOL})")
    del run
    torch.cuda.empty_cache()

    # the mesh's own cost: the same work plain and on the mesh, in turns
    cfg = get_config(MESH_ARCH)
    mesh = make_host_mesh(1, 1, device=dev)
    model = build(cfg, device=dev, seed=0)
    prompt = np.random.default_rng(4).integers(0, cfg.vocab, (2, 2048)).astype(np.int32)
    tcfg = cfg.replace(attn_impl="torch")
    optim = AdamW(AdamWConfig(lr=1e-3))
    state = init_state(tcfg, optim, seed=0, device=dev)
    step = make_train_step(tcfg, optim)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in SyntheticTokens(cfg.vocab, 2048, 2, seed=0).batch_at(0).items()}
    step(state, batch)  # the first calls' one-time costs
    generate(model, cfg, prompt, max_new=32, device=dev)
    times: dict = {"serve": {"plain": [], "mesh": []}, "train": {"plain": [], "mesh": []}}
    for kind in ("plain", "mesh", "mesh", "plain", "plain", "mesh"):
        with activation_sharding(mesh) if kind == "mesh" else nullcontext():
            stats: dict = {}
            generate(model, cfg, prompt, max_new=32, device=dev, stats=stats)
            times["serve"][kind].append(stats["prefill_s"] + stats["decode_s"])
            sync()
            t0 = time.perf_counter()
            _, metrics = step(state, batch)
            float(metrics["loss"])
            times["train"][kind].append(time.perf_counter() - t0)
    for what, t in times.items():
        cost = float(np.median(t["mesh"]) - np.median(t["plain"]))
        spread = max(max(t["plain"]) - min(t["plain"]), max(t["mesh"]) - min(t["mesh"]))
        print(json.dumps({"mesh_of_one_cost": what, "plain_s": t["plain"], "mesh_s": t["mesh"],
                          "mesh_minus_plain_s": cost, "repeat_spread_s": spread}), flush=True)
        if cost > spread:
            fail(f"phase 10(a): the mesh of one slows {what} by {cost:.4f} s, more than its "
                 f"repeats differ ({spread:.4f} s)")
    del model, state, batch
    torch.cuda.empty_cache()

    # -- (b) two ranks on the one card ------------------------------------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_2ranks_") as tmp:
        sync()
        t0 = time.perf_counter()
        mp.spawn(_two_ranks, args=(os.path.join(tmp, "store"), tmp), nprocs=2, join=True)
        wall_s = time.perf_counter() - t0
        ranks = [json.load(open(os.path.join(tmp, f"rank{r}.json"))) for r in range(2)]
    print(json.dumps({"two_ranks": ranks, "wall_s": wall_s}), flush=True)
    cfg = get_config(MESH_ARCH)
    for r, res in enumerate(ranks):
        p = res["prefill"]
        if p["launches"] != MESH2["layers"] or p["local_heads"] != [
                cfg.num_heads // 2, cfg.num_kv_heads // 2]:
            fail(f"phase 10(b) rank {r}: {p['launches']} attention launches on heads "
                 f"{p['local_heads']}, not {MESH2['layers']} on half of each")
        if p["max_abs_err"] > MESH2_LOGIT_TOL:
            fail(f"phase 10(b) rank {r}: the (1, 2) prefill's logits off the one-rank "
                 f"prefill's by {p['max_abs_err']} (tolerance {MESH2_LOGIT_TOL})")
        t = res["train"]
        if t["loss_abs_err"] > MESH2_LOSS_TOL or t["grad_norm_rel_err"] > MESH2_NORM_RTOL:
            fail(f"phase 10(b) rank {r}: the (2, 1) ZeRO-1 step's loss off by "
                 f"{t['loss_abs_err']}, grad_norm by {t['grad_norm_rel_err']} relative")
        c = res["checkpoint"]
        kept = list(MESH2_CKPT_STEPS[-MESH2_CKPT_KEEP:])
        if c["steps"] != kept or not c["refused_first"] or not c["last_equal"]:
            fail(f"phase 10(b) rank {r}: {len(MESH2_CKPT_STEPS)} saves at "
                 f"keep={MESH2_CKPT_KEEP} left steps {c['steps']} (want {kept}), step "
                 f"{MESH2_CKPT_STEPS[0]} refused: {c['refused_first']}, the last restored "
                 f"equal: {c['last_equal']}")

    # -- (c) the dry run, on the host --------------------------------------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as out:
        for arch, shape, multi in DRYRUN_CELLS:
            with sequential_collectives() as sequential:
                rec = run_cell(arch, shape, multi, out)
            if rec["status"] != "ok":
                fail(f"phase 10(c): the dry run of {arch} x {shape}: {rec.get('error')}")
            r = rec["roofline"]
            print(json.dumps({"dryrun": f"{arch} x {shape} x {rec['mesh']}",
                              "chips": rec["chips"], "wall_s": rec["total_s"],
                              "trace_s": rec["lower_s"],
                              "predicted_on": "H100 SXM spec (analysis/roofline.py)",
                              "compute_s": r["compute_s"], "memory_s": r["memory_s"],
                              "collective_s": r["collective_s"], "bottleneck": r["bottleneck"],
                              "flops_per_rank": rec["hlo"]["flops"],
                              "bytes_per_rank": rec["hlo"]["bytes"],
                              "collective_bytes_per_rank": rec["hlo"]["collective_bytes"],
                              "collectives": rec["hlo"]["collective_counts"],
                              "sequential_collectives": (None if sequential is None
                                                         else dict(sequential)),
                              "torch": torch.__version__,
                              "memory_analysis": rec["memory_analysis"]}), flush=True)


def _two_ranks(rank: int, store: str, outdir: str) -> None:
    """One rank of phase 10(b), in its own process on the card; writes its
    results to ``outdir/rank<r>.json``."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import copy

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.analysis.cost import CostCounter
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build, shard_params
    from repro_torch.models.spec import activation_sharding, distribute, local_box
    from repro_torch.serve import make_cache, make_prefill_step
    from repro_torch.serve.step import cache_shardings, shard_tree
    from repro_torch.storage import CheckpointManager, DiskStorage
    from repro_torch.train import AdamW, init_state, make_train_step, shard_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=2)
    dev = torch.device("cuda")
    try:
        cfg = get_config(MESH_ARCH).replace(num_layers=MESH2["layers"],
                                            param_dtype=torch.float32,
                                            compute_dtype=torch.float32)
        b, s = MESH2["batch"], MESH2["seq"]
        prompt = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab, (b, s)),
                                 dtype=torch.int32, device=dev)
        out: dict = {"rank": rank}
        with torch.no_grad():
            model = build(cfg, device=dev, seed=0)
            want, _ = make_prefill_step(cfg)(model, {"tokens": prompt},
                                             make_cache(cfg, b, s, device=dev))
            mesh = make_host_mesh(1, 2, device=dev)
            sharded = shard_params(copy.deepcopy(model), mesh)
            del model
            with activation_sharding(mesh):
                cache = make_cache(cfg, b, s, device=dev)
                cache = shard_tree(cache, mesh, cache_shardings(cfg, cache, mesh))
                fa_mod.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with CostCounter() as counter:
                    got, _ = make_prefill_step(cfg)(sharded, {"tokens": prompt}, cache)
                torch.cuda.synchronize()
                launches = fa_mod.launches
            attn = sharded.layers[0].attn
            box = local_box(tuple(got.shape), mesh, got.placements)
            out["prefill"] = {
                "launches": launches, "seconds": time.perf_counter() - t0,
                "local_heads": [attn.wq.to_local().shape[1], attn.wk.to_local().shape[1]],
                "logits_shard": [[s.start, s.stop] for s in box],
                "max_abs_err": (got.to_local() - want[box]).abs().max().item(),
                "collectives": dict(counter.cost.collective_counts),
                "collective_bytes": counter.cost.collective_bytes}
            del sharded, cache, got, want

        tcfg = cfg.replace(attn_impl="torch")
        optim = AdamW()
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in SyntheticTokens(cfg.vocab, s, b, seed=0).batch_at(0).items()}
        step = make_train_step(tcfg, optim)
        _, m1 = step(init_state(tcfg, optim, seed=0, device=dev), batch)
        mesh = make_host_mesh(2, 1, device=dev)
        state = shard_state(init_state(tcfg, optim, seed=0, device=dev), tcfg, mesh, optim)
        fa_mod.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with activation_sharding(mesh), CostCounter() as counter:
            _, m2 = step(state, batch)
        loss2, norm2 = float(m2["loss"]), float(m2["grad_norm"])
        out["train"] = {
            "seconds": time.perf_counter() - t0, "loss": loss2, "loss_one_rank": float(m1["loss"]),
            "loss_abs_err": abs(loss2 - float(m1["loss"])),
            "grad_norm_rel_err": abs(norm2 / float(m1["grad_norm"]) - 1.0),
            "launches": fa_mod.launches,
            "collectives": dict(counter.cost.collective_counts),
            "collective_bytes": counter.cost.collective_bytes}
        del state, batch

        def tree(n: int) -> dict:
            return {"w": distribute(torch.arange(64.0, device=dev).reshape(16, 4) * n, mesh,
                                    (Shard(0), Replicate())),
                    "step": torch.tensor(n, device=dev)}

        ck = CheckpointManager(DiskStorage(os.path.join(outdir, "ckpt")), keep=MESH2_CKPT_KEEP)
        for step_no in MESH2_CKPT_STEPS:
            ck.save(step_no, tree(step_no))
        target = {"w": torch.empty((16, 4), device="meta"),
                  "step": torch.empty((), dtype=torch.int64, device="meta")}
        try:
            ck.restore(target, MESH2_CKPT_STEPS[0])
            refused = False
        except FileNotFoundError:
            refused = True
        last = MESH2_CKPT_STEPS[-1]
        back = ck.restore(target, last)
        out["checkpoint"] = {
            "steps": ck.steps(), "refused_first": refused,
            "last_equal": bool(torch.equal(back["w"], torch.arange(64.0).reshape(16, 4) * last)
                               and int(back["step"]) == last)}
        with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
