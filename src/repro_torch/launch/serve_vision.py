"""Vision serving launcher: freeze → registry → fleet engine (port of
``repro.launch.serve_vision``).

    # serve full-width VGG8B from a seeded random init on the card:
    PYTHONPATH=src python -m repro_torch.launch.serve_vision --scale 1 --batch 32

    # train briefly, export, then serve:
    PYTHONPATH=src python -m repro_torch.launch.serve_vision \
        --scale 0.125 --train-steps 50 --export-dir /tmp/nitro_frozen

    # A/B-serve two checkpoints (either package's save_frozen), 90/10:
    PYTHONPATH=src python -m repro_torch.launch.serve_vision \
        --model-dir a=/ckpts/prod --model-dir b=/ckpts/candidate \
        --split a=0.9,b=0.1 --requests 500

    # load a whole fleet from a FLEET.json directory, with a 50 ms SLO:
    PYTHONPATH=src python -m repro_torch.launch.serve_vision \
        --fleet-dir /ckpts/fleet --requests 500 --slo 50

    # the plain PyTorch path on the CPU:
    PYTHONPATH=src python -m repro_torch.launch.serve_vision --device cpu \
        --scale 0.0625 --train-steps 2 --train-batch 16

    # with a live /metrics endpoint (ephemeral port) and a span trace:
    PYTHONPATH=src python -m repro_torch.launch.serve_vision --device cpu \
        --scale 0.0625 --metrics-port 0 --trace-out /tmp/serve_trace.jsonl

    # tune every loaded plan at this --batch before serving (on the CPU
    # the plain stream conv's band height; a second run with the same
    # cache measures nothing):
    PYTHONPATH=src python -m repro_torch.launch.serve_vision --device cpu \
        --scale 0.0625 --autotune --autotune-cache /tmp/tile_cache.json

Every ``--model-dir`` is ``NAME=PATH`` (bare ``PATH`` gets the model id
``default``).  Requests route through the continuous-batching
``FleetEngine``; ``--scheduler static`` runs the single-model
``VisionEngine`` (exactly one model) for A/B-ing the schedulers.  With
``--train-steps 0`` the model is the seeded random init.  Requests are
``np.random.default_rng(seed).integers(-127, 128, shape)`` images with
ids ``req-<i>``, exactly as the JAX launcher draws and names them, so
both packages serve the same requests on the same arms for the same
arguments.  ``--metrics-port`` serves the run's ``MetricRegistry`` at
``/metrics`` (the CLI scrapes its own endpoint at the end and prints the
headline samples); ``--trace-out`` writes the fleet's batch-lifecycle
spans as JSONL.  ``--autotune`` tunes every loaded plan's problems at
``--batch`` (``autotune.tune_plan``) into ``--autotune-cache`` (default:
``tile_cache.json`` in the working directory) before the engines warm
up, bitwise the untuned run; with ``--metrics-port`` the tile lookups and
each plan step's int8-operand choice (``kernel_int8_path_active``) are on
``/metrics``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device


def _train_and_freeze(arch: str, scale: float, steps: int, batch: int,
                      seed: int, *, device=DEFAULT_DEVICE,
                      backend: str = "auto"):
    """The JAX launcher's train-and-freeze: ``PRNGKey(seed)`` init on the
    ``tiles32`` set, ``steps`` LES steps (batches shuffled with
    ``seed=it``, dropout key ``PRNGKey(it)``), frozen.  Returns
    ``(FrozenModel, dataset)``, bitwise the JAX launcher's."""
    from repro_torch.configs import get_paper_config
    from repro_torch.core import les, prng
    from repro_torch.data import synthetic
    from repro_torch.infer import freeze

    device = resolve_device(device)
    ds = synthetic.make_image_dataset("tiles32", n_train=2048, n_test=256,
                                      seed=seed)
    cfg = get_paper_config(arch, scale=scale, input_shape=ds.input_shape)
    state = les.create_train_state(prng.PRNGKey(seed), cfg, device=device)
    it = 0
    while it < steps:
        for x, y in synthetic.batches(ds.x_train, ds.y_train, batch, seed=it):
            if it >= steps:
                break
            state, metrics = les.train_step(
                state, cfg, torch.from_numpy(x).to(device),
                torch.from_numpy(y).to(device), prng.PRNGKey(it),
                backend=backend,
            )
            if it % 20 == 0:
                print(f"[train] step {it:4d} loss={int(metrics.loss)}")
            it += 1
    return freeze(state, cfg), ds


def _parse_model_dir(spec: str) -> tuple[str, str]:
    """``NAME=PATH`` → (name, path); bare ``PATH`` → ("default", path)."""
    name, sep, path = spec.partition("=")
    if not sep:
        return "default", spec
    if not name or not path:
        raise SystemExit(f"bad --model-dir {spec!r} (want NAME=PATH)")
    return name, path


def _build_registry(args, metrics=None):
    """Resolve --fleet-dir / --model-dir / train-and-freeze into a registry;
    returns ``(registry, splits of the fleet manifest)``."""
    from repro_torch.infer import load_fleet_manifest, save_frozen
    from repro_torch.serving import ModelRegistry

    if args.export_dir and (args.fleet_dir or args.model_dir):
        raise SystemExit("--export-dir only applies to the train-and-freeze "
                         "path (no --model-dir / --fleet-dir)")
    if args.fleet_dir and args.model_dir:
        raise SystemExit("--fleet-dir and --model-dir are mutually "
                         "exclusive — add extra models to FLEET.json")
    registry = ModelRegistry(device=args.device, backend=args.backend,
                             operand_dtype=args.operand_dtype, metrics=metrics)
    if args.fleet_dir:
        # read FLEET.json once: the printed paths, the splits and the
        # loaded models all come from the same manifest version
        manifest = load_fleet_manifest(args.fleet_dir)
        for mid, path in sorted(manifest["models"].items()):
            registry.load(mid, path)
            print(f"[load] {mid} <- {path}")
        return registry, manifest.get("splits", {})

    if args.model_dir:
        for spec in args.model_dir:
            mid, path = _parse_model_dir(spec)
            entry = registry.load(mid, path)
            print(f"[load] {mid} ({entry.plan.name}) <- {path}")
    else:
        fm, _ = _train_and_freeze(args.arch, args.scale, args.train_steps,
                                  args.train_batch, args.seed,
                                  device=args.device, backend=args.backend)
        if args.export_dir:
            path = save_frozen(args.export_dir, fm)
            print(f"[export] frozen model -> {path} "
                  f"({fm.num_bytes()} weight bytes)")
        registry.register("default", fm)
    return registry, {}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve_vision")
    ap.add_argument("--arch", default="vgg8b")
    ap.add_argument("--scale", type=float, default=0.125)
    ap.add_argument("--train-steps", type=int, default=0)
    ap.add_argument("--train-batch", type=int, default=64)
    ap.add_argument("--model-dir", action="append", default=None,
                    metavar="NAME=PATH",
                    help="serve a frozen model under NAME (repeatable; "
                         "bare PATH serves as 'default')")
    ap.add_argument("--fleet-dir", default=None,
                    help="serve every model in a FLEET.json directory")
    ap.add_argument("--export-dir", default=None,
                    help="also save the trained frozen model here")
    ap.add_argument("--split", default=None, metavar="a=0.9,b=0.1",
                    help="route traffic through a weighted A/B split "
                         "over the loaded model ids")
    ap.add_argument("--route", default=None,
                    help="routing target: a model id or a split alias "
                         "(needed when a fleet defines several aliases)")
    ap.add_argument("--device", default=DEFAULT_DEVICE, help="cuda (default) or cpu")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "cuda", "reference"])
    ap.add_argument("--operand-dtype", default="auto",
                    choices=["auto", "int8", "int32"],
                    help="auto = int8 operands wherever the int8 fit is "
                         "provable (bitwise-identical), int32 = always "
                         "lift, int8 = force (error if no step qualifies)")
    ap.add_argument("--autotune", action="store_true",
                    help="tune the kernels' run-time knobs for every loaded "
                         "plan at this --batch before serving (bitwise "
                         "result-invariant)")
    ap.add_argument("--autotune-cache", default=None,
                    help="tile-cache JSON path (default: tile_cache.json "
                         "in the cwd)")
    ap.add_argument("--scheduler", default="continuous",
                    choices=["continuous", "static"],
                    help="continuous = FleetEngine (double-buffered); "
                         "static = single-model VisionEngine baseline")
    ap.add_argument("--batch", type=int, default=32,
                    help="engine batch size")
    ap.add_argument("--max-wait-ms", type=float, default=3.0,
                    help="static scheduler only")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--slo", type=float, default=None, metavar="MS",
                    help="serving deadline in ms, applied to every loaded "
                         "model (per-model violation attribution; "
                         "continuous scheduler only)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="expose the serving metrics as Prometheus text "
                         "at /metrics on this port (0 = pick an ephemeral "
                         "port and print it)")
    ap.add_argument("--trace-out", default=None,
                    help="write the engine's batch-lifecycle span trace "
                         "(JSONL) here")
    return ap


def _route_target(args, registry, router) -> str:
    """The routing target: explicit --route, else the CLI --split alias,
    else the unambiguous option (the sole alias / the sole model) — never
    a guess among several configured aliases."""
    for alias in router.aliases:  # fail at startup, not mid-traffic
        missing = sorted(mid for mid, _ in router.arms(alias)
                         if mid not in registry)
        if missing:
            raise SystemExit(
                f"split {alias!r} routes to unknown models {missing}; "
                f"loaded: {registry.ids()}")
    if args.route:
        if args.route not in registry and args.route not in router.aliases:
            raise SystemExit(
                f"--route {args.route!r} is neither a model id "
                f"{registry.ids()} nor a split alias {router.aliases}")
        return args.route
    if args.split:
        return "split"
    if len(router.aliases) == 1:
        return router.aliases[0]
    if router.aliases:
        raise SystemExit(
            f"fleet defines several split aliases {router.aliases}; "
            f"pick one with --route")
    if len(registry.ids()) == 1:
        return registry.ids()[0]
    raise SystemExit("several models loaded but no --split/--route "
                     "to route by")


def main(argv=None) -> dict:
    """Serve ``--requests`` images and print the summary.

    Returns the run for programmatic callers: ``registry``, ``router``,
    ``target``, ``request_ids``, ``plan`` (the first model's), ``images``,
    ``results`` (one ``VisionResult`` per request, in order), ``wall_s``,
    ``latency_ms``, ``snapshot`` (timed work only: ``fleet``, ``models``
    and, continuous, ``slo``), ``batches_total`` (warm-up included),
    ``metrics`` (the ``MetricRegistry``, or None without
    ``--metrics-port``) and ``tracer`` (or None without ``--trace-out``).
    """
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)  # no CUDA: raise before any work

    metrics = server = None
    if args.metrics_port is not None:
        from repro_torch.obs import MetricRegistry, start_metrics_server
        metrics = MetricRegistry()
        server = start_metrics_server(metrics, port=args.metrics_port)
        print(f"[metrics] Prometheus text at {server.url}")
    try:
        return _serve(args, device, metrics, server)
    finally:
        if server is not None:
            server.close()


def _serve(args, device, metrics, server) -> dict:
    """``main`` after the metrics server is up (``main`` closes it)."""
    from repro_torch.serving import (
        FleetEngine,
        Router,
        Slo,
        VisionEngine,
        fleet_snapshot_delta,
        latency_summary_ms,
        parse_split,
        snapshot_delta,
    )

    tracer = None
    if args.trace_out:
        from repro_torch.obs import Tracer
        tracer = Tracer()

    if args.autotune and metrics is not None:
        # before the registry compiles the plans, so that each step's
        # int8-operand choice lands on the gauge (the JAX launcher attaches
        # the metrics after compiling, and its gauge stays empty)
        from repro_torch.kernels import autotune as at
        at.set_metrics(metrics)
    registry, manifest_splits = _build_registry(args, metrics=metrics)
    if args.autotune:
        # tune before the engines' warm-up: the dispatchers look the
        # winners up from their first launch
        from repro_torch.kernels import autotune as at
        cache = at.TileCache(args.autotune_cache or at.CACHE_FILENAME, device=device)
        tuned = 0
        for mid in registry.ids():
            tuned += len(at.tune_plan(registry.get(mid).plan, args.batch, cache=cache))
        at.configure(cache)
        print(f"[autotune] {tuned} problems tuned/cached -> {cache.path}")
    if args.slo is not None:
        # one objective for the whole fleet: the launcher serves a single
        # workload, so every arm is scored against the same deadline
        slo = Slo(deadline_ms=args.slo)
        for mid in registry.ids():
            registry.set_slo(mid, slo)
        print(f"[slo] deadline {slo.deadline_ms:.1f} ms on {registry.ids()}")
    if metrics is not None:
        from repro_torch.obs import register_build_info
        register_build_info(metrics, backend=device.type)

    splits = dict(manifest_splits)
    if args.split:
        splits["split"] = parse_split(args.split)
    router = Router(splits)
    target = _route_target(args, registry, router)

    first = registry.get(registry.ids()[0])
    print(f"[plan] device={first.plan.device} backend={first.plan.backend} "
          f"models={registry.ids()} route={target!r}")
    for row in first.plan.summary():
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

    # each request's image is shaped for the arm it will land on
    rng = np.random.default_rng(args.seed)

    def make_image(mid):
        return rng.integers(-127, 128,
                            registry.get(mid).input_shape).astype(np.int32)

    request_ids = [f"req-{i}" for i in range(args.requests)]
    images = [make_image(router.resolve(target, rid)) for rid in request_ids]

    if args.scheduler == "static":
        if len(registry.ids()) != 1 or args.split:
            raise SystemExit("--scheduler static serves exactly one model")
        if args.slo is not None:
            raise SystemExit("--slo requires --scheduler continuous "
                             "(SLO attribution lives in the fleet engine)")
        with VisionEngine(first.plan, batch_size=args.batch,
                          max_wait_ms=args.max_wait_ms,
                          metrics=metrics) as engine:
            engine.classify(images[:1])  # warm-up (first kernel use) off the clock
            pre = engine.stats.snapshot()
            t0 = time.perf_counter()
            futs = [engine.submit(img) for img in images]
            results = [f.result() for f in futs]
            wall = time.perf_counter() - t0
            post = engine.stats.snapshot()
        snapshot = {"fleet": snapshot_delta(pre, post), "models": {}}
        batches_total = post["batches"]
    else:
        with FleetEngine(registry, batch_size=args.batch,
                         router=router, tracer=tracer) as engine:
            for mid in registry.ids():  # warm-up off the clock
                engine.classify([make_image(mid)], model=mid)
            pre = engine.snapshot()
            t0 = time.perf_counter()
            futs = [engine.submit(img, model=target, request_id=rid)
                    for rid, img in zip(request_ids, images)]
            results = [f.result() for f in futs]
            wall = time.perf_counter() - t0
            post = engine.snapshot()
        # report only the timed work: the cumulative snapshot would fold
        # the warm-up batches into the counters
        snapshot = fleet_snapshot_delta(pre, post)
        for mid, mstats in snapshot["models"].items():
            mstats["version"] = post["models"][mid]["version"]
        snapshot["slo"] = {}
        for mid, c in post["slo"].items():
            p = pre["slo"].get(mid, {"requests": 0, "violations": 0})
            reqs = c["requests"] - p["requests"]
            viol = c["violations"] - p["violations"]
            snapshot["slo"][mid] = {
                "requests": reqs, "violations": viol,
                "violation_frac": viol / reqs if reqs else 0.0,
            }
        batches_total = post["fleet"]["batches"]

    pct = latency_summary_ms(r.latency_s for r in results)
    fleet = snapshot["fleet"]
    print(f"[serve] scheduler={args.scheduler} {len(results)} requests in "
          f"{wall:.3f}s ({len(results) / wall:.1f} req/s)")
    print(f"[serve] latency ms p50={pct['p50']:.1f} p90={pct['p90']:.1f} "
          f"p99={pct['p99']:.1f}")
    print(f"[serve] {fleet['batches']} batches, "
          f"avg fill {fleet['avg_batch_fill']:.2f}")
    for mid, mstats in snapshot["models"].items():
        print(f"[serve]   {mid}: {json.dumps(mstats, sort_keys=True)}")
    for mid, sstats in snapshot.get("slo", {}).items():
        print(f"[slo]   {mid}: {sstats['violations']}/{sstats['requests']} "
              f"past deadline ({100 * sstats['violation_frac']:.1f}%)")

    if tracer is not None:
        n_spans = tracer.export_jsonl(args.trace_out)
        print(f"[trace] {n_spans} spans -> {args.trace_out}")
    if server is not None:
        # scrape our own endpoint: proves the full HTTP path end-to-end
        # and shows the headline counters in the run's output
        from urllib.request import urlopen
        text = urlopen(server.url, timeout=5).read().decode()
        samples = [ln for ln in text.splitlines()
                   if ln and not ln.startswith("#")]
        print(f"[metrics] scraped {server.url}: {len(samples)} samples")
        headline = ("serve_requests_total", "serve_queue_depth",
                    "serve_batch_fill_count", "serve_model_version",
                    "serve_model_swaps_total", "serve_slo_violations_total",
                    "repro_build_info")
        for ln in samples:
            if ln.startswith(headline):
                print(f"[metrics]   {ln}")
    return {
        "registry": registry, "router": router, "target": target,
        "request_ids": request_ids, "plan": first.plan, "images": images,
        "results": results, "wall_s": wall, "latency_ms": pct,
        "snapshot": snapshot, "batches_total": batches_total,
        "metrics": metrics, "tracer": tracer,
    }


if __name__ == "__main__":
    main()
