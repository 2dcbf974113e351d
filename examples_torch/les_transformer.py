"""Beyond the paper, on the PyTorch port: NITRO-D's learning algorithm (LES
local-loss groups) applied to a transformer LM, beside plain backprop (the
port of ``examples/les_transformer.py``).

Gradients are confined to each layer group (a ``detach`` at each group's
end), as in the paper's integer local-loss blocks: no backward dependency
crosses a group.

    PYTHONPATH=src python examples_torch/les_transformer.py                # on the card
    PYTHONPATH=src python examples_torch/les_transformer.py --device cpu   # plain PyTorch
"""

import argparse
from dataclasses import replace

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import prng
from repro_torch.data.loader import synthetic_lm_generator
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.train import trainer


def run(cfg, label, steps, batch, seq, device):
    gen = synthetic_lm_generator(cfg.vocab_size, seq, batch)
    step_fn = trainer.build_train_step(cfg)
    state = trainer.init_state(prng.PRNGKey(0), cfg, device=device)
    first = last = None
    for it in range(steps):
        b = gen(it)
        state, m = step_fn(state, {k: torch.from_numpy(v).to(device) for k, v in b.items()})
        if first is None:
            first = float(m["ce"])
        last = float(m["ce"])
        if it % 20 == 0:
            print(f"  [{label}] step {it:3d} ce={last:.4f}")
    print(f"  [{label}] ce {first:.4f} → {last:.4f}")
    return first, last


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default=DEFAULT_DEVICE, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    base = replace(get_smoke_config("llama3.2-1b"), num_layers=4)

    print("BP baseline (end-to-end backprop):")
    bp = run(base, "bp", args.steps, args.batch, args.seq, device)

    print("LES mode (2 local-loss groups, gradients confined per group):")
    les = run(replace(base, les_groups=2), "les", args.steps, args.batch, args.seq, device)

    print("Both modes train; LES removes the cross-group backward chain.")
    return {"bp": bp, "les": les}


if __name__ == "__main__":
    main()
