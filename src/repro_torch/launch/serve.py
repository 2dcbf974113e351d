"""LM serving launcher: batched generation through the Engine (port of
``repro.launch.serve``; the same flags and lines, and ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --batch 4 --max-new 16                  # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.device import DEFAULT_DEVICE, resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=DEFAULT_DEVICE, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_smoke_config
    from repro_torch.core import prng
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import Engine, Request

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    params = T.init_params(prng.PRNGKey(args.seed), cfg, device=device)
    engine = Engine(cfg, params, max_seq=args.max_seq, device=device)

    rng = np.random.default_rng(args.seed)
    requests = [
        Request(
            prompt=rng.integers(0, cfg.vocab_size, args.prompt_len).tolist(),
            max_new_tokens=args.max_new,
        )
        for _ in range(args.batch)
    ]
    out = engine.generate(requests)
    for i, r in enumerate(out):
        print(f"request {i}: {len(r.generated)} tokens → {r.generated}")


if __name__ == "__main__":
    main()
