"""Serve a small LM with batched requests: prefill + greedy decode through
the port's KV / recurrent caches (counterpart of ``examples/serve_lm.py``).

    PYTHONPATH=src python examples_torch/serve_lm.py [--arch llama3.2-1b]   # on the card
    PYTHONPATH=src python examples_torch/serve_lm.py --device cpu
"""

import argparse

from repro_torch.configs import get_smoke_config
from repro_torch.core import prng
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import transformer as T
from repro_torch.serving.engine import Engine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default=DEFAULT_DEVICE, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    params = T.init_params(prng.PRNGKey(0), cfg, device=device)
    engine = Engine(cfg, params, max_seq=128, device=device)

    rng_prompts = [
        [1, 5, 9, 13], [2, 4, 8], [3, 3, 3, 3, 3], [7, 11],
    ][: args.batch]
    requests = [Request(prompt=p, max_new_tokens=12) for p in rng_prompts]
    out = engine.generate(requests)
    for i, r in enumerate(out):
        print(f"request {i}: prompt={r.prompt} → generated={r.generated}")
    assert all(len(r.generated) == 12 for r in out)
    print("served", len(out), "requests to completion")


if __name__ == "__main__":
    main()
