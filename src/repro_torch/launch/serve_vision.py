"""Vision serving launcher: freeze (or load) → compile_plan → VisionEngine.

    # serve full-width VGG8B from a seeded random init on the card:
    PYTHONPATH=src python -m repro_torch.launch.serve_vision --scale 1 --batch 32

    # serve a model exported by the JAX package's save_frozen:
    PYTHONPATH=src python -m repro_torch.launch.serve_vision --model-dir DIR

    # the plain PyTorch path on the CPU:
    PYTHONPATH=src python -m repro_torch.launch.serve_vision --device cpu --scale 0.0625

Requests are ``np.random.default_rng(seed).integers(-127, 128, shape)``
images, exactly as the JAX launcher draws them, so both serve the same
requests for the same ``--seed``.  Only the static scheduler is ported;
the JAX launcher's continuous FleetEngine, --train-steps, splits, SLOs,
autotuning and metrics endpoints are not.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_paper_config
from repro_torch.core import model as M
from repro_torch.core import prng
from repro_torch.infer import compile_plan, freeze, load_frozen
from repro_torch.serving import VisionEngine, latency_summary_ms, snapshot_delta


def _random_frozen(arch: str, scale: float, seed: int):
    """Seeded random-init weights (``PRNGKey(seed)``, the JAX launcher's
    init), frozen."""
    cfg = get_paper_config(arch, scale=scale)
    return freeze(M.init_params(prng.PRNGKey(seed), cfg, device="cpu"), cfg)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve_vision")
    ap.add_argument("--arch", default="vgg8b")
    ap.add_argument("--scale", type=float, default=0.125)
    ap.add_argument("--model-dir", default=None, metavar="PATH",
                    help="serve a frozen model written by save_frozen "
                         "(default: seeded random init of --arch/--scale)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "cuda", "reference"])
    ap.add_argument("--operand-dtype", default="auto",
                    choices=["auto", "int8", "int32"],
                    help="auto = int8 operands wherever the int8 fit is "
                         "provable (bitwise-identical), int32 = always "
                         "lift, int8 = force (error if no step qualifies)")
    ap.add_argument("--scheduler", default="static",
                    choices=["static", "continuous"],
                    help="static = VisionEngine (continuous: not ported yet)")
    ap.add_argument("--batch", type=int, default=32,
                    help="engine batch size")
    ap.add_argument("--max-wait-ms", type=float, default=3.0)
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> dict:
    """Serve ``--requests`` images and print the summary.

    Returns the run for programmatic callers: ``fm``, ``plan``,
    ``images``, ``results`` (one ``VisionResult`` per image, in order),
    ``wall_s``, ``latency_ms``, ``snapshot`` (timed work only) and
    ``batches_total`` (warm-up included).
    """
    args = _parser().parse_args(argv)
    if args.scheduler == "continuous":
        raise SystemExit("--scheduler continuous is not ported yet; use static")
    if args.model_dir:
        fm = load_frozen(args.model_dir)
        print(f"[load] {fm.name} <- {args.model_dir}")
    else:
        fm = _random_frozen(args.arch, args.scale, args.seed)
    plan = compile_plan(fm, device=args.device, backend=args.backend,
                        operand_dtype=args.operand_dtype)
    print(f"[plan] device={plan.device} backend={plan.backend} model={plan.name}")
    for row in plan.summary():
        hbm = row["hbm_bytes_per_out_elem"]
        per_sample = row["hbm_per_sample_bytes"]
        print(f"  {row['kind']:<7} w={row['weight_shape']} "
              f"({row['weight_dtype']}) sf={row['sf']} "
              f"act={row['activation_dtype']} "
              f"operands={row['operand_dtype']} pool={row['pool']} "
              f"hbm/elem {hbm['unfused']}B→{hbm['fused']}B "
              f"hbm/sample {per_sample['materialise']}B→"
              f"{per_sample['stream']}B "
              f"({row['stream_saving_ratio']}x stream saving)")

    rng = np.random.default_rng(args.seed)
    images = [rng.integers(-127, 128, fm.input_shape).astype(np.int32)
              for _ in range(args.requests)]
    with VisionEngine(plan, batch_size=args.batch,
                      max_wait_ms=args.max_wait_ms) as engine:
        engine.classify(images[:1])  # warm-up (first kernel use) off the clock
        pre = engine.stats.snapshot()
        t0 = time.perf_counter()
        futs = [engine.submit(img) for img in images]
        results = [f.result() for f in futs]
        wall = time.perf_counter() - t0
        post = engine.stats.snapshot()
    snapshot = snapshot_delta(pre, post)
    pct = latency_summary_ms(r.latency_s for r in results)
    print(f"[serve] scheduler=static {len(results)} requests in "
          f"{wall:.3f}s ({len(results) / wall:.1f} req/s)")
    print(f"[serve] latency ms p50={pct['p50']:.1f} p90={pct['p90']:.1f} "
          f"p99={pct['p99']:.1f}")
    print(f"[serve] {snapshot['batches']} batches, "
          f"avg fill {snapshot['avg_batch_fill']:.2f}")
    return {
        "fm": fm, "plan": plan, "images": images, "results": results,
        "wall_s": wall, "latency_ms": pct, "snapshot": snapshot,
        "batches_total": post["batches"],
    }


if __name__ == "__main__":
    main()
