"""Device time of GLCM's packed route (256 bins) on one 4096^2 window against
the height of its row bands: the hematoxylin plane of ``chip_smoke.py``'s
slide and uniformly random bins, every band height's counts held equal to
the wrapper's own choice (``glcm.packed_rows``). Prints the card's name and
power limit, then one JSON line a case: the non-zero pair counters of
sampled 15-row bands and the median device ms at each band height.

    PYTHONPATH=src python scripts/probe_glcm_bands.py        # needs a CUDA card
"""
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import chip_smoke  # noqa: E402  (device_ms, SLIDE)
from repro_torch.kernels import glcm, ops, ref  # noqa: E402
from repro_torch.pipeline import make_slide  # noqa: E402

NB = 256
ROWS = (1, 2, 4, 8, 11, 12, 15)  # 15: the most that fit 65,535 pixels at 4096 wide


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda")
    s = chip_smoke.SLIDE
    rgb_np, _ = make_slide(s["tiles_y"], s["tiles_x"], s["tile"], seed=s["seed"])
    rgb = torch.from_numpy(rgb_np).to(dev)
    hema = ops.color_deconv(rgb, torch.from_numpy(ref.stain_inverse()).to(dev))[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = {"hematoxylin": ref.quantize_ref(hema, NB)[None].contiguous(),
             "uniform": torch.randint(0, NB, (1, *hema.shape), generator=gen,
                                      dtype=torch.int32, device=dev)}
    for name, bins in cases.items():
        _, h, w = bins.shape
        pairs = bins[0, :, :-1].long() * NB + bins[0, :, 1:].long()
        out = {"case": name, "shape": list(bins.shape), "num_bins": NB,
               "auto_rows": glcm.packed_rows(1, h, w, glcm._num_sms(dev)),
               "nonzero_pairs_per_15_row_band": [
                   int(torch.bincount(pairs[r:r + 15].reshape(-1), minlength=NB * NB)
                       .count_nonzero()) for r in range(0, h, 600)]}
        want = glcm.glcm_cuda(bins, NB)
        for rows in ROWS:
            g, hist = glcm.glcm_cuda(bins, NB, rows=rows)
            if not (torch.equal(g, want[0]) and torch.equal(hist, want[1])):
                sys.exit(f"{name}: bands of {rows} rows count otherwise")
            out[f"rows_{rows}_device_ms"] = chip_smoke.device_ms(
                torch, lambda ev: glcm.glcm_cuda(bins, NB, rows=rows, events=ev), (), 20)["device"]
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
