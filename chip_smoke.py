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
  4. run the WSI path, ``analyze_tile`` at 4096^2 with the default config,
     with every launch counter set to 0 just before and read just after, and
     check it stage by stage against the same call with ``impl="torch"``;
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
  8. print the per-kernel JSON lines, the ``kernels`` line and, last, the
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
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM data sheet: HBM3 rate, float32 rate outside the tensor cores, and
# the dense bf16 tensor-core rate (the least time the card could take for the
# LM kernels' matrix work, whatever dtype they run in).
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
CCL_WORST = (4095, 4096)  # CCL's worst cases: a serpentine and a full mask through every tile


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
    # the device-memory variant (NB > 240), on the same ROIs at 256 bins
    wide = ref.quantize_ref(rois, GLCM_WIDE_BINS)
    wide_g, wide_h = ops.glcm_histogram(wide, GLCM_WIDE_BINS, impl="cuda")
    wp_g, wp_h = ops.glcm_histogram(wide, GLCM_WIDE_BINS, impl="torch")
    exact(f"glcm at {GLCM_WIDE_BINS} bins", wide_g, wp_g)
    exact(f"glcm histogram at {GLCM_WIDE_BINS} bins", wide_h, wp_h)
    wide_idx = (
        torch.arange(b, device=dev)[:, None, None] * GLCM_WIDE_BINS**2
        + wide[:, :, :-1].long() * GLCM_WIDE_BINS + wide[:, :, 1:].long()
    ).reshape(-1)
    glcm_wide = dict(
        kernel=f"glcm:nb{GLCM_WIDE_BINS}", max_abs_err=0.0,
        kernel_ms=time_ms(lambda: ops.glcm_histogram(wide, GLCM_WIDE_BINS, impl="cuda"), 20),
        device_ms=device_ms(torch, lambda ev: glcm_mod.glcm_cuda(
            wide, GLCM_WIDE_BINS, events=ev), (), 20)["device"],
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

    # -- 5.-7. the LM path -----------------------------------------------------
    del rgb, minv, k_st, p_st, out, plain, seg
    lm_rec, lm_launches = lm_phases(torch, dev, time_ms, sync, modules)
    for name, r in lm_rec.items():
        kernel, dname, *variant = name.split(":")
        print(json.dumps({"kernel": name, "launches": lm_launches[":".join([kernel, *variant])],
                          **{k: v for k, v in r.items() if k != "bound"},
                          "bound_ms": r["bound"][0]}))

    # -- 8. report ---------------------------------------------------------------
    sources = {
        "color_deconv": ("color_deconv.cu", "src/repro/kernels/color_deconv.py:30"),
        "morph_recon": ("morph_recon.cu", "src/repro/kernels/morph_recon.py:50"),
        "ccl": ("ccl.cu", "src/repro/kernels/ccl.py:51"),
        "glcm": ("glcm.cu", "src/repro/kernels/glcm.py:40"),
        "flash_attention:swa": ("flash_attention.cu", "src/repro/kernels/flash_attention.py:104"),
        "flash_attention:global": ("flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:104"),
        "ssd_scan": ("ssd_scan.cu", "src/repro/kernels/ssd_scan.py:88"),
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
    # the LM kernels' entries are their bf16 (the path's dtype) measurements;
    # attention has one entry for the SWA layers' calls and one for the global
    rec.update({name: lm_rec[f"{kernel}:bf16{variant}"] for name, kernel, variant in (
        ("flash_attention:swa", "flash_attention", ":swa"),
        ("flash_attention:global", "flash_attention", ":global"),
        ("ssd_scan", "ssd_scan", ""))})
    launches.update(lm_launches)
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
        if name.startswith("flash_attention"):
            kernels[-1]["instance_launches"] = launches["flash_attention:instances"][
                name.split(":")[1]]
        if name == "ssd_scan":
            kernels[-1]["instance_launches"] = launches["ssd_scan:instances"]
            kernels[-1]["kernel_launches"] = launches["ssd_scan:kernel_launches"]
        if name == "ccl":
            kernels[-1]["kernel_launches"] = launches["ccl:kernel_launches"]
        if "phase_ms" in r:  # the device's time of a call, apart from the host's
            kernels[-1]["device_ms"] = r["phase_ms"]["device"]
    print(f"nvidia-smi: {nvidia_smi()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


def serpentine(h: int, w: int) -> np.ndarray:
    """A 1-pixel corridor along every even row, turning at alternate ends."""
    m = np.zeros((h, w), bool)
    m[::2, :] = True
    for r in range(1, h, 2):
        m[r, -1 if (r // 2) % 2 == 0 else 0] = True
    return m


def lm_bound(nbytes: int, nops: int) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / TC_OPS_PER_S
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
    from repro_torch.models import HybridLM
    from repro_torch.serve import make_cache, make_decode_step, make_prefill_step

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
                               4 * d * pairs * b * hq),
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
                           6 * b * t * h * n * p),
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
    plain32 = cfg32.replace(attn_impl="torch")
    model = HybridLM(cfg32, device=dev, seed=0)
    prompt = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, (b, t)),
                             dtype=torch.int32, device=dev)
    steps = {}
    caches = {}
    reset_attention_counts()
    reset_ssd_counts()
    with torch.no_grad():
        for name, c in (("kernels", cfg32), ("plain", plain32)):
            sync()
            t0 = time.perf_counter()
            logits, caches[name] = make_prefill_step(c)(
                model, {"tokens": prompt}, make_cache(c, b, t + E2E_DECODE_STEPS + 1, device=dev))
            sync()
            steps[name] = [logits[:, -1]]
            print(f"float32 prefill ({name}) in {time.perf_counter() - t0:.3f} s", flush=True)
        if fa_mod.instance_launches != {"tensor_core": 0, "cuda_core": cfg.num_layers}:
            fail(f"the float32 prefill launched attention instances {fa_mod.instance_launches}, "
                 f"not the CUDA-core kernel once a layer")
        if ssd_mod.instance_launches != {"tensor_core": 0, "cuda_core": cfg.num_layers}:
            fail(f"the float32 prefill ran SSD instances {ssd_mod.instance_launches}, "
                 f"not the CUDA-core scan once a layer")
        logit_err = (steps["kernels"][0] - steps["plain"][0]).abs().max().item()
        if not torch.allclose(steps["kernels"][0], steps["plain"][0],
                              rtol=E2E_LOGIT_TOL, atol=E2E_LOGIT_TOL):
            fail(f"float32 prefill logits: kernels against plain max |err| {logit_err}")
        # decode both on the plain path's greedy tokens (teacher forcing)
        tok = torch.argmax(steps["plain"][0], dim=-1)[:, None].to(torch.int32)
        for i in range(E2E_DECODE_STEPS):
            for name, c in (("kernels", cfg32), ("plain", plain32)):
                logits, caches[name] = make_decode_step(c)(model, tok, caches[name], t + i)
                steps[name].append(logits[:, -1])
            tok = torch.argmax(steps["plain"][-1], dim=-1)[:, None].to(torch.int32)
    checked = differ = 0
    for lk, lp in zip(steps["kernels"], steps["plain"]):
        top2 = torch.topk(lp, 2, dim=-1).values
        decisive = (top2[:, 0] - top2[:, 1]) > E2E_LOGIT_TOL
        same = torch.argmax(lk, dim=-1) == torch.argmax(lp, dim=-1)
        checked += int(decisive.sum())
        differ += int((decisive & ~same).sum())
    decode_err = max((lk - lp).abs().max().item()
                     for lk, lp in zip(steps["kernels"], steps["plain"]))
    print(f"LM float32 end to end: prefill logits max |err| {logit_err:.3g} "
          f"(tolerance {E2E_LOGIT_TOL}), decode logits max |err| {decode_err:.3g}; greedy "
          f"tokens over 1 + {E2E_DECODE_STEPS} steps: {checked} decisive, {differ} differ",
          flush=True)
    if differ:
        fail(f"{differ} greedy tokens differ where the top-two margin exceeds {E2E_LOGIT_TOL}")
    del model, caches, steps
    torch.cuda.empty_cache()
    return rec, lm_launches


if __name__ == "__main__":
    main()
