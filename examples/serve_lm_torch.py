"""Batched serving example on the PyTorch/CUDA port: prefill + greedy decode
over a request stream for any ported decoder-only architecture (``--arch``),
reduced.

  PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
  PYTHONPATH=src python examples/serve_lm_torch.py          # on the CUDA card
"""
import argparse

from repro_torch.launch.serve import main as serve_main


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args()
    argv = [
        "--arch", args.arch, "--smoke",
        "--requests", str(args.requests),
        "--batch", "2",
        "--prompt-len", "16",
        "--max-new", str(args.max_new),
    ]
    out = serve_main(argv + (["--device", args.device] if args.device else []))
    print(f"throughput: {out['tok_per_s']:.1f} new tokens/s "
          f"(reduced {args.arch} on {out['device']})")


if __name__ == "__main__":
    main()
