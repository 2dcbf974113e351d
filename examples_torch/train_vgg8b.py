"""End-to-end example on the PyTorch port: train a (reduced) VGG8B with
NITRO-D for a few hundred steps, with checkpoint/restart, straggler
monitoring and integer-numerics telemetry — the full production train
loop on the paper's flagship architecture (the port of
``examples/train_vgg8b.py``).

    PYTHONPATH=src python examples_torch/train_vgg8b.py [--steps 300] [--scale 0.25]
    PYTHONPATH=src python examples_torch/train_vgg8b.py --device cpu --steps 20 --scale 0.0625

``--scale 1.0`` builds the paper's exact VGG8B (128..512 filters); the
default 0.25 fits a few hundred steps on the CPU in minutes.  Restarting
the script resumes from the checkpoint — kill it mid-run to see
recovery.  Every 50th step additionally records per-layer bit-occupancy /
saturation telemetry to ``metrics.jsonl`` next to the checkpoints
(``--telemetry-every 0`` to disable) — the training trajectory is
bitwise identical either way.  ``--device`` defaults to the card.
"""

import argparse
import os
import tempfile

from repro_torch.device import DEFAULT_DEVICE
from repro_torch.launch.train import train_nitro


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "nitro_vgg8b_ckpt"))
    ap.add_argument("--telemetry-every", type=int, default=50)
    ap.add_argument("--device", default=DEFAULT_DEVICE, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    result = train_nitro(
        "vgg8b", steps=args.steps, batch=args.batch,
        ckpt_dir=args.ckpt_dir, dataset="tiles32", scale=args.scale,
        telemetry_every=args.telemetry_every, device=args.device,
    )
    if "scaled_loss" in result:
        print(f"final scaled loss {result['scaled_loss']:.4f} "
              f"(per-sample RSS in one-hot units)")
    return result


if __name__ == "__main__":
    main()
