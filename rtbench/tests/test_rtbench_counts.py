"""The yardstick's arithmetic and inputs: the work-based bounds of the tile's
ops, the tile generator, and the reference against the program on the CPU
(and, marked ``cuda``, on the card)."""
from __future__ import annotations

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from rtbench import compare, reference, tiles  # noqa: E402
from rtbench.trace import Tracer, load_counts, op_kernels, summarize  # noqa: E402

PEAKS = json.loads((ROOT / "rtbench/peaks.json").read_text())
WSI = json.loads((ROOT / "rtbench/configs/wsi-paper-4k.json").read_text())["wsi"]


@pytest.fixture
def card():
    """The CUDA device; skips where this process has none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def bound_ms(op: str, *args) -> float:
    return Tracer(PEAKS).bound_s(*load_counts()[op](args, {})) * 1e3


def test_the_ops_bounds_at_4096_equal_the_kernel_table():
    """PERF.md's kernel table: color_deconv 0.1202 ms, morph_recon 0.1202 ms a
    tile (two calls), ccl 0.0401 ms, glcm at 512 x 64^2 0.00315 ms."""
    f32 = torch.empty((3, 4096, 4096), device="meta")
    plane = torch.empty((4096, 4096), device="meta")
    labels = torch.empty((4096, 4096), dtype=torch.int32, device="meta")
    bins = torch.empty((512, 64, 64), dtype=torch.int32, device="meta")
    assert round(bound_ms("color_deconv", f32), 4) == 0.1202
    recon = bound_ms("fill_holes", plane) + bound_ms("morph_recon", plane, plane)
    assert round(recon, 4) == 0.1202
    assert round(bound_ms("connected_components", labels), 4) == 0.0401
    assert round(bound_ms("texture_features", bins, 32), 5) == 0.00315


def components(rgb: np.ndarray) -> int:
    labels = reference.analyze(rgb, WSI, "cpu")["labels"]
    return int(np.unique(labels[labels >= 0]).size)


def test_the_tile_generator_is_deterministic_and_as_dense_as_make_slide():
    from repro_torch.pipeline.synth import make_slide

    seed = tiles.tile_seed(2**31 + 5, 0)
    a = tiles.make_tile(seed, 1024, "cpu")
    b = tiles.make_tile(seed, 1024, "cpu")
    assert a.shape == (3, 1024, 1024) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert not torch.equal(a, tiles.make_tile(tiles.tile_seed(2**31 + 5, 1), 1024, "cpu"))
    ours = components(a.numpy())
    theirs = components(make_slide(2, 2, 512, seed=3)[0])
    assert abs(ours - theirs) <= 0.25 * theirs, (ours, theirs)


def test_the_reference_agrees_with_analyze_tile_on_the_cpu():
    from repro_torch.configs.wsi import WSIConfig
    from repro_torch.pipeline import analyze_tile

    rgb = tiles.make_tile(tiles.tile_seed(11, 0), 512, "cpu").numpy()
    cfg = dict(WSI, tile=512)
    out = analyze_tile(rgb, WSIConfig(**cfg), device="cpu")
    got = {k: out[k].numpy() for k in ("labels", "boxes", "features")}
    want = reference.analyze(rgb, cfg, "cpu")
    numbers = compare.tile_numbers(got, want)
    assert numbers["mask_px_share"] == 0 and numbers["objects_off_share"] == 0
    assert numbers["boxes_off_share"] == 0 and numbers["feat_err_max"] < 1e-5
    assert len(want["boxes"]) > 20


def event(name, start, end, device="CPU", cid=0):
    from torch.autograd import DeviceType

    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=getattr(DeviceType, device), id=cid)


def test_an_op_counts_only_the_kernels_it_launched():
    """Inside the device range of an ``op.fill_holes`` span: a torch kernel
    whose launch lies in the op's host span counts, and so does a kernel
    linked to no launch that bears the op's kernel name; a copy, a kernel
    launched from another op's span and another op's named kernel do not."""
    events = [
        event("rtbench.window", 0, 1000),
        event("rtbench.op.fill_holes", 100, 200),
        event("rtbench.op.morph_recon", 300, 400),
        event("cudaLaunchKernel", 110, 112, cid=1),
        event("cudaLaunchKernel", 350, 352, cid=4),
        event("rtbench.op.fill_holes", 500, 600, "CUDA"),
        event("void at::native::vectorized_elementwise_kernel<4>(int)", 500, 510, "CUDA", 1),
        event("(anonymous namespace)::recon_round(float*, int)", 520, 560, "CUDA", 2),
        event("Memcpy HtoD (Pageable -> Device)", 565, 580, "CUDA", 3),
        event("void at::native::reduce_kernel<512>(int)", 585, 595, "CUDA", 4),
        event("(anonymous namespace)::ccl_local(int*)", 590, 598, "CUDA", 5),
    ]
    kernels_of = {op: tuple(ks) for op, ks in op_kernels().items()}
    assert kernels_of["fill_holes"] == ("recon_round",)
    got = summarize(events, kernels_of)
    assert got["op_device_s"]["fill_holes"] == pytest.approx(50e-6)
    assert got["stats"]["op_kernels_by_launch"] == 1
    assert got["stats"]["op_kernels_by_name"] == 1
    assert got["stats"]["op_kernels_left_out"] == 2
    assert got["copy_s"]["HtoD"] == pytest.approx(15e-6)
    assert got["busy_s"] == pytest.approx((10 + 40 + 15 + 13) * 1e-6)


@pytest.mark.cuda
def test_on_the_card_the_generator_repeats_and_the_kernels_agree_with_the_reference(card):
    from repro_torch.configs.wsi import WSIConfig
    from repro_torch.pipeline import analyze_tile

    seed = tiles.tile_seed(2**31 + 9, 0)
    a = tiles.make_tile(seed, 4096, card)
    assert torch.equal(a, tiles.make_tile(seed, 4096, card))
    rgb = a.cpu().numpy()
    out = analyze_tile(rgb, WSIConfig(**WSI), device=card)
    got = {k: out[k].cpu().numpy() for k in ("labels", "boxes", "features")}
    n = compare.tile_numbers(got, reference.analyze(rgb, WSI, card))
    limits = json.loads((ROOT / "rtbench/configs/wsi-paper-4k.json").read_text())["limits"]
    assert all(n[k] <= limits[k] for k in n), n
