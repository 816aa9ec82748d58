#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card (written for an H100).

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each fatal on failure:
  1. check that CUDA is present; print the card's name and power limit;
  2. build the four kernels from ``src/repro_torch/kernels/csrc`` with nvcc;
  3. hold each kernel against its plain PyTorch version on the card, on the
     main path's data and shapes (a 3x4096x4096 slide, 512 ROIs of 64x64),
     and time both with CUDA events;
  4. run the main path, ``analyze_tile`` at 4096^2 with the default config,
     with every launch counter set to 0 just before and read just after, and
     check it stage by stage against the same call with ``impl="torch"``;
  5. print the per-kernel JSON lines, the ``kernels`` line and, last, the
     ``{"ok": true, "device": ...}`` line.
It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM data sheet: HBM3 rate and float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

SLIDE = dict(tiles_y=8, tiles_x=8, tile=512, seed=0)  # 3 x 4096 x 4096
DECONV_TOL = 2e-5  # log10f vs the plain log10, as tests/test_kernels.py allows
FEATURE_TOL = 1e-4  # feature reductions, as tests/test_wsi_pipeline.py allows


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

    # fill holes (reconstruction kernel on the complement)
    mr_mod.launches = 0
    k_fill = ops.fill_holes(raw, impl="cuda")
    fill_sweeps = mr_mod.launches
    p_fill = ops.fill_holes(raw, impl="torch")
    exact("fill_holes", k_fill, p_fill)
    part: dict[str, dict] = {}  # the two reconstruction calls of the main path
    part["fill_holes"] = dict(
        max_abs_err=0.0, sweeps=fill_sweeps,
        ms=time_ms(lambda: ops.fill_holes(raw, impl="cuda"), 10),
        plain_ms=time_ms(lambda: ops.fill_holes(raw, impl="torch"), 2, warmup=0),
        library_ms=None,
        bound=bound(3 * hw * 4, fill_sweeps * 8 * hw),
    )

    # reconstruction opening
    filled = p_fill
    marker = torch.minimum(
        filled,
        torch.roll(filled, 1, -1) * torch.roll(filled, -1, -1)
        * torch.roll(filled, 1, -2) * torch.roll(filled, -1, -2),
    )
    mr_mod.launches = 0
    k_open = ops.morph_recon(marker, filled, impl="cuda")
    recon_sweeps = mr_mod.launches
    p_open = ops.morph_recon(marker, filled, impl="torch")
    exact("morph_recon", k_open, p_open)
    part["opening"] = dict(
        max_abs_err=0.0, sweeps=recon_sweeps,
        ms=time_ms(lambda: ops.morph_recon(marker, filled, impl="cuda"), 10),
        plain_ms=time_ms(lambda: ops.morph_recon(marker, filled, impl="torch"), 2, warmup=0),
        library_ms=None,
        bound=bound(3 * hw * 4, recon_sweeps * 8 * hw),
    )
    rec["morph_recon"] = dict(  # per tile: fill-holes + opening
        max_abs_err=0.0,
        ms=part["fill_holes"]["ms"] + part["opening"]["ms"],
        plain_ms=part["fill_holes"]["plain_ms"] + part["opening"]["plain_ms"],
        library_ms=None,
        bound=bound(2 * 3 * hw * 4, (fill_sweeps + recon_sweeps) * 8 * hw),
    )

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
    rec["ccl"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: ops.connected_components(mask, impl="cuda"), 10),
        plain_ms=time_ms(lambda: ops.connected_components(mask, impl="torch"), 2, warmup=0),
        library_ms=None,
        bound=bound(2 * hw * 4, 4 * hw),
    )

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
        plain_ms=time_ms(lambda: ops.glcm_histogram(bins, nb, impl="torch"), 10),
        library_ms=time_ms(lambda: torch.bincount(pair_idx, minlength=b * nb * nb), 10),
        bound=bound(bins.numel() * 4 + (k_g.numel() + k_h.numel()) * 4, 3 * bins.numel()),
    )
    del pair_idx
    print(f"checks: {n_objects} objects in the slide, ROI batch {tuple(bins.shape)}, "
          f"fill_holes {fill_sweeps} sweeps, reconstruction {recon_sweeps} sweeps", flush=True)

    # -- 4. the main path --------------------------------------------------------
    for mod in modules.values():
        mod.launches = 0
    sync()
    t0 = time.perf_counter()
    out = analyze_tile(rgb, cfg)
    sync()
    wall_s = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in modules.items()}
    print(f"main path: analyze_tile {tuple(rgb.shape)} in {wall_s:.3f} s, launches {launches}")
    for name, n in launches.items():
        if n == 0:
            fail(f"the main path never launched the {name} kernel")

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

    # -- 5. report ---------------------------------------------------------------
    sources = {
        "color_deconv": ("color_deconv.cu", "src/repro/kernels/color_deconv.py:30"),
        "morph_recon": ("morph_recon.cu", "src/repro/kernels/morph_recon.py:50"),
        "ccl": ("ccl.cu", "src/repro/kernels/ccl.py:51"),
        "glcm": ("glcm.cu", "src/repro/kernels/glcm.py:40"),
    }
    for name, r in [*rec.items(), *((f"morph_recon:{sub}", v) for sub, v in part.items())]:
        line = {"kernel": name, "launches": launches[name.split(":")[0]],
                "max_abs_err": r["max_abs_err"], "kernel_ms": r["ms"],
                "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
                "bound_ms": r["bound"][0]}
        if "sweeps" in r:
            line["sweeps_per_call"] = r["sweeps"]
        print(json.dumps(line))
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
    print(f"nvidia-smi: {nvidia_smi()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
