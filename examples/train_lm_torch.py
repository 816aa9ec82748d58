"""End-to-end run of the port: train a small qwen3-family model for a few
hundred steps with the full substrate — RT data loader (DMS staging +
device prefetch), async region-template checkpoints, cosine LR (the
counterpart of examples/train_lm.py).

  PYTHONPATH=src python examples/train_lm_torch.py --device cpu             # ~200 steps
  PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 50  # quicker
  PYTHONPATH=src python examples/train_lm_torch.py                          # on the card
"""
import argparse
import sys

from repro_torch.launch.train import main as train_main


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args()

    argv = [
        "--arch", "qwen3-0.6b", "--smoke",
        "--steps", str(args.steps),
        "--batch", str(args.batch),
        "--seq", str(args.seq),
        "--lr", "3e-3",
        "--ckpt-every", "50",
        "--ckpt-dir", "artifacts/train_lm_torch_ckpt",
        "--log-every", "20",
    ]
    if args.device:
        argv += ["--device", args.device]
    losses = train_main(argv)["losses"]
    drop = losses[0] - losses[-1]
    print(f"\nfinal: {losses[0]:.3f} -> {losses[-1]:.3f} (drop {drop:.3f})")
    if drop <= 0:
        sys.exit("loss did not improve")


if __name__ == "__main__":
    main()
