"""Training launcher (port of ``repro.launch.train``).  Two trainers
behind one CLI: ``--arch <paper arch>`` (mlp1–mlp4 on the flattened
images, VGG8B / VGG11B), integer-only NITRO-D LES training; and
``--arch <LM arch>`` (llama3.2-1b, qwen3-32b, …), the LM trainer
(``train_lm``: AdamW, or LES groups with ``--les-groups``).

    # four steps of full-width VGG8B at batch 64 on the card, then evaluate:
    PYTHONPATH=src python -m repro_torch.launch.train --arch vgg8b --steps 4

    # full-width mlp4 (3072→3000×3→10) on the card:
    PYTHONPATH=src python -m repro_torch.launch.train --arch mlp4 --steps 4

    # the plain PyTorch path on the CPU at a small width, with checkpoints
    # (a second run with the same --ckpt-dir resumes from LATEST):
    PYTHONPATH=src python -m repro_torch.launch.train --arch vgg8b \
        --steps 20 --scale 0.0625 --device cpu --ckpt-dir /tmp/ckpt

    # with the observability stack: telemetry every 2nd step, health
    # alerts, a live /metrics endpoint and a span trace:
    PYTHONPATH=src python -m repro_torch.launch.train --arch vgg8b \
        --steps 20 --scale 0.0625 --device cpu --telemetry-every 2 \
        --telemetry-out /tmp/obs/metrics.jsonl --alerts-out /tmp/obs/alerts.jsonl \
        --metrics-port 0 --trace-out /tmp/obs/trace.jsonl

    # data parallel: 2 ranks, the batch split over them, a ring all-reduce
    # (on one card both ranks share it over gloo; on the CPU: --device cpu):
    PYTHONPATH=src python -m repro_torch.launch.train --arch vgg8b \
        --steps 4 --num-devices 2 --dp-reduce ring

    # tune the step's kernel problems for this arch and batch first (on
    # the CPU the plain stream conv's band height; the cache goes beside
    # the checkpoints; a second run measures nothing):
    PYTHONPATH=src python -m repro_torch.launch.train --arch vgg8b \
        --steps 4 --batch 8 --scale 0.0625 --device cpu --autotune --ckpt-dir /tmp/ckpt

The data, the init and the dropout key of step ``it`` are those of the
JAX launcher, so both give the same trajectory and the same test accuracy
for the same arguments.  ``--ckpt-dir`` saves every 200 steps and at the
end in the JAX package's checkpoint format and resumes from its newest
checkpoint, with the JAX launcher's semantics: after a resume from step
S the keys are ``PRNGKey(S + it)`` while the batches are shuffled with
``seed=it`` from ``it = 0``, and ``steps`` counts this call's steps.
``--fuse-opt`` takes the ``fuse_opt`` step (IntegerSGD in the grad_W
kernels' flush), bitwise the split step.  ``--telemetry-every N`` runs
every N-th step with ``telemetry=True`` (the split path, bitwise the same
trajectory), appends its rows to ``metrics.jsonl`` (byte for byte the JAX
launcher's) and feeds the health monitor.  ``--num-devices N`` spawns N
ranks (``parallel.dp.spawn``) that split each batch and all-reduce the
int32 gradients exactly (``--dp-reduce`` psum, ring or compress), so the
trajectory is the single-device one bit for bit; the ``[dp]`` line names
the backend and each rank's card.  Every rank builds the same data and
restores from ``--ckpt-dir``; rank 0 alone prints, checkpoints, writes
telemetry, alerts and the trace, serves ``/metrics``, evaluates and
returns the result.  ``--autotune`` tunes every kernel problem of the
step for this arch and batch before the first step (``autotune.tune_training``:
the plain stream conv's band height on the CPU; the CUDA kernels have no
run-time knob, so on the card it tunes nothing and only counts lookups) into ``--autotune-cache`` (default:
``tile_cache.json`` beside the checkpoints), bitwise the untuned run.

The LM trainer trains the arch's smoke config, as the JAX launcher does,
on Zipf token batches of ``--batch`` × ``--seq``; ``--les-groups N``
splits the stack into N local-loss groups (at least 4 layers);
``--ckpt-dir`` saves at the end and resumes, in the JAX format.
``train_lm(arch, cfg=...)`` trains another config of the arch (the
published one, the NITRO int8 MLP path)::

    # the smoke llama on the CPU, 40 steps, LES with 2 groups:
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --steps 40 --batch 8 --seq 64 --les-groups 2 --device cpu

    # llama3.2-1b at full width on the card (1.236 B parameters), in Python:
    from repro_torch.configs import get_config
    train_lm("llama3.2-1b", cfg=get_config("llama3.2-1b"), steps=4, batch=4, seq=512)
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch

from repro_torch.configs import ARCHS as LM_ARCHS
from repro_torch.configs import PAPER_ARCHS, get_paper_config, get_smoke_config
from repro_torch.core import les, prng
from repro_torch.data import synthetic
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.obs import health as H
from repro_torch.obs.metrics import (MetricRegistry, register_build_info,
                                     start_metrics_server)
from repro_torch.obs.trace import NULL_TRACER, Tracer, use
from repro_torch.parallel import dp
from repro_torch.parallel.tree import tree_map
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault_tolerance import (PreemptionGuard, StepTimer,
                                               StragglerDetector)

ARCHS = PAPER_ARCHS
CKPT_EVERY = 200


def train_nitro(arch: str, *, steps: int, batch: int = 64,
                dataset: str = "tiles32", scale: float = 1.0, seed: int = 0,
                device=DEFAULT_DEVICE, backend: str = "auto",
                fuse_opt: bool = False, ckpt_dir: str | None = None,
                telemetry_every: int = 0, telemetry_out: str | None = None,
                trace_out: str | None = None, metrics_port: int | None = None,
                alerts_out: str | None = None, num_devices: int = 1,
                dp_reduce: str = "psum", autotune: bool = False,
                autotune_cache: str | None = None) -> dict:
    """Integer-only NITRO-D training, then test accuracy.

    ``telemetry_every=N`` runs every N-th step with ``telemetry=True``
    (bitwise the same trajectory; under ``fuse_opt`` a sampled step takes
    the split path) and appends its per-layer records to
    ``telemetry_out`` (default: ``metrics.jsonl`` beside the
    checkpoints).  Each sampled step feeds the health monitor
    (``obs.health.default_rules``): alerts print inline and, with
    ``alerts_out``, append as JSONL.  ``trace_out`` writes a span trace of
    the run (``train.step`` / ``train.checkpoint`` / ``train.eval``); the
    tracer is installed as the active one (``obs.trace.use``), so each
    ``train.step`` holds the step's own spans (``step.*``, ``blocks.*``,
    ``dispatch.*``, ``kernel.*`` on the card, ``parallel.*`` under DP).
    ``metrics_port`` (0 = ephemeral) serves the run's registry
    (``train_step_seconds``, ``train_straggler_events_total``, the health
    gauges, ``repro_build_info``) at ``/metrics``, ``/metrics.json`` and
    ``/healthz``.  Step times are host to host: no observability path
    synchronises the card on an unsampled step.

    Returns ``test_accuracy``, ``steps``, ``scaled_loss``,
    ``straggler_events`` and ``health`` (the keys of the JAX trainer's
    result) plus ``state`` (the final ``TrainState``), ``step_metrics``
    (one ``StepMetrics`` per step), ``start_step`` (the step resumed
    from, 0 without a checkpoint) and ``train_s`` (host seconds of the
    step loop, ending in a device synchronise).

    ``num_devices > 1`` runs the same training on that many ranks
    (``parallel.dp``, the reducer ``dp_reduce``): bitwise the
    single-device trajectory, rank 0's result returned (its tensors on
    the host).

    ``autotune=True`` tunes every kernel problem of this (arch, batch)
    before the first step (``kernels.autotune.tune_training`` on this
    device and backend) into ``autotune_cache`` (default:
    ``tile_cache.json`` beside the checkpoints), configures it for the
    dispatchers and counts their lookups on the run's registry; a tile
    choice never changes a result.  Under ``num_devices > 1`` rank 0 tunes
    at the global batch, as the JAX launcher does, and every rank
    configures the file after a barrier; the ranks look their shard-sized
    problems up, which that tuning does not cover (JAX's shard-shaped
    lookups miss the same way).
    """
    if arch not in ARCHS:
        raise ValueError(f"arch {arch!r} is not ported; one of {ARCHS}")
    if dp_reduce not in dp.REDUCERS:
        raise ValueError(f"unknown dp_reduce {dp_reduce!r}; one of {dp.REDUCERS}")
    kw = dict(steps=steps, batch=batch, dataset=dataset, scale=scale, seed=seed,
              backend=backend, fuse_opt=fuse_opt, ckpt_dir=ckpt_dir,
              telemetry_every=telemetry_every, telemetry_out=telemetry_out,
              trace_out=trace_out, metrics_port=metrics_port, alerts_out=alerts_out,
              dp_reduce=dp_reduce, autotune=autotune, autotune_cache=autotune_cache)
    if num_devices == 1:
        return _train(arch, axis=None, device=resolve_device(device), **kw)
    if batch % num_devices:
        raise ValueError(f"--batch {batch} must divide evenly over "
                         f"--num-devices {num_devices}")
    comm, devices = dp.rank_devices(num_devices, device)
    print(f"[dp] {num_devices} ranks, reduce={dp_reduce}, {dp.describe(comm, devices)} "
          f"(bitwise ≡ single-device)")
    return dp.spawn(_train_rank, num_devices, device=device, args=(arch, kw))[0]


def _train_rank(axis, device, arch: str, kw: dict) -> dict | None:
    """One rank of a data-parallel run: rank 0's result with its tensors
    on the host, ``None`` elsewhere."""
    out = _train(arch, axis=axis, device=device, **kw)
    if out is None:
        return None
    out["state"] = tree_map(torch.Tensor.cpu, out["state"])
    out["step_metrics"] = tree_map(torch.Tensor.cpu, out["step_metrics"])
    return out


def _quiet(*args, **kwargs) -> None:
    """``print`` on every rank but 0."""


def _train(arch: str, *, axis, device: torch.device, steps: int, batch: int,
           dataset: str, scale: float, seed: int, backend: str, fuse_opt: bool,
           ckpt_dir: str | None, telemetry_every: int, telemetry_out: str | None,
           trace_out: str | None, metrics_port: int | None,
           alerts_out: str | None, dp_reduce: str, autotune: bool,
           autotune_cache: str | None) -> dict | None:
    """``train_nitro`` on one device (``axis=None``) or as one rank of a
    data-parallel run (``None`` on every rank but 0)."""
    lead = axis is None or axis.rank == 0
    say = print if lead else _quiet
    ds = synthetic.make_image_dataset(dataset, n_train=4096, n_test=512, seed=seed)
    cfg = get_paper_config(arch, scale=scale,
                           input_shape=ds.input_shape if arch.startswith("vgg") else None)
    if arch.startswith("mlp"):
        ds = synthetic.flatten_for_mlp(ds)
        if cfg.input_shape != ds.input_shape:
            cfg = dataclasses.replace(cfg, input_shape=ds.input_shape)
    state = les.create_train_state(prng.PRNGKey(seed), cfg, device=device)
    start_step = 0
    checkpointer = ckpt.AsyncCheckpointer(ckpt_dir) if ckpt_dir and lead else None
    if ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        state, start_step = ckpt.restore(ckpt_dir, state)
        say(f"[restore] resumed from step {start_step}")

    if autotune:
        from repro_torch.kernels import autotune as at
        cache_path = autotune_cache or os.path.join(ckpt_dir or ".", at.CACHE_FILENAME)
        tuned = {}
        if lead:
            tuned = at.tune_training(cfg, batch, cache=at.TileCache(cache_path, device=device),
                                     backend=backend, device=device)
        if axis is not None:  # the file is whole before any rank reads it
            torch.distributed.barrier(group=axis.group)
        cache = at.configure(cache_path, device=device)
        say(f"[autotune] {len(tuned)} problems tuned/cached -> {cache.path}")

    if axis is None:
        def step_fn(state, x, y, key, telemetry):
            return les.train_step(state, cfg, x, y, key, backend=backend,
                                  fuse_opt=fuse_opt, telemetry=telemetry)
    else:
        dp_steps = {t: dp.make_dp_train_step(cfg, axis, dp_reduce=dp_reduce,
                                             fuse_opt=fuse_opt, backend=backend,
                                             telemetry=t)
                    for t in (False, True)}

        def step_fn(state, x, y, key, telemetry):
            return dp_steps[telemetry](state, x, y, key)

    if telemetry_every > 0:
        from repro_torch.obs import telemetry as T
        if telemetry_out is None:
            telemetry_out = os.path.join(ckpt_dir or ".", "metrics.jsonl")
        say(f"[telemetry] every {telemetry_every} steps -> {telemetry_out}")
    tracer = Tracer() if trace_out and lead else NULL_TRACER
    guard = PreemptionGuard(install=False)
    straggler = StragglerDetector()

    # host-side run metrics + health rules: they read only what the step
    # returned, so the trajectory is untouched
    registry = MetricRegistry()
    register_build_info(registry, backend=device.type)
    if autotune:  # count the dispatchers' tile lookups (hits vs fallbacks)
        at.set_metrics(registry)
    step_seconds = registry.histogram(
        "train_step_seconds", "wall time per training step")
    straggler_events = registry.counter(
        "train_straggler_events_total",
        "steps slower than the straggler EWMA threshold")
    sinks = [H.print_sink]
    if alerts_out and lead:
        sinks.append(H.jsonl_sink(alerts_out))
        print(f"[health] alerts -> {alerts_out}")
    monitor = H.HealthMonitor(registry=registry, sinks=sinks)
    server = None
    if metrics_port is not None and lead:
        server = start_metrics_server(registry, port=metrics_port)
        print(f"[metrics] serving {server.url} (+ /metrics.json /healthz)")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    try:
        with use(tracer):
            it = 0
            metrics = None
            step_metrics = []
            sync()
            t0 = time.perf_counter()
            timer = StepTimer()
            while it < steps:
                for x, y in synthetic.batches(ds.x_train, ds.y_train, batch, seed=it):
                    if it >= steps or guard.requested:
                        break
                    sampled = telemetry_every > 0 and it % telemetry_every == 0
                    with tracer.span("train.step", step=start_step + it,
                                     telemetry=sampled):
                        result = step_fn(state, torch.from_numpy(x).to(device),
                                         torch.from_numpy(y).to(device),
                                         prng.PRNGKey(start_step + it), sampled)
                        if sampled:
                            state, metrics, telem = result
                            if lead:
                                records = T.to_records(telem, cfg=cfg,
                                                       step=start_step + it)
                                T.append_jsonl(telemetry_out, records)
                                monitor.observe_records(records)
                        else:
                            state, metrics = result
                    dt = timer.lap()
                    step_seconds.observe(dt)
                    if straggler.record(dt):
                        straggler_events.inc()
                        say(f"[straggler] step {it}: {dt:.3f}s vs ewma "
                            f"{straggler.ewma:.3f}s")
                    step_metrics.append(metrics)
                    if it % 50 == 0:
                        say(f"step {it:5d}  loss={int(metrics.loss)}  "
                            f"scaled={metrics.scaled_loss(batch):.4f}  "
                            f"correct={int(metrics.correct)}/{batch}")
                    if checkpointer and it > 0 and it % CKPT_EVERY == 0:
                        with tracer.span("train.checkpoint", step=start_step + it):
                            checkpointer.save(start_step + it, state)
                    it += 1
                if guard.requested:
                    break
            sync()
            train_s = time.perf_counter() - t0
            if checkpointer:
                with tracer.span("train.checkpoint", step=start_step + it,
                                 final=True):
                    checkpointer.save(start_step + it, state)
                    checkpointer.wait()

            if not lead:
                return None
            correct = 0
            with tracer.span("train.eval"):
                for i in range(0, len(ds.x_test) - batch + 1, batch):
                    correct += int(les.eval_step(
                        state, cfg,
                        torch.from_numpy(ds.x_test[i:i + batch]).to(device),
                        torch.from_numpy(ds.y_test[i:i + batch]).to(device)))
            n_eval = (len(ds.x_test) // batch) * batch
            acc = correct / max(n_eval, 1)
            if trace_out:
                n_spans = tracer.export_jsonl(trace_out)
                print(f"[trace] {n_spans} spans -> {trace_out}")
            if monitor.alerts:
                counts = monitor.summary()["by_severity"]
                print(f"[health] {len(monitor.alerts)} alert(s) fired "
                      f"({', '.join(f'{k}={v}' for k, v in counts.items() if v)}); "
                      f"{len(monitor.active_alerts())} still active")
    finally:
        if server is not None:
            server.close()
    print(f"[done] test accuracy {acc:.4f} over {n_eval} samples")
    out = {"test_accuracy": acc, "steps": it,
           "straggler_events": straggler.incidents,
           "health": monitor.summary(), "state": state,
           "step_metrics": step_metrics, "start_step": start_step,
           "train_s": train_s}
    if metrics is not None:
        out["scaled_loss"] = metrics.scaled_loss(batch)
    return out


def train_lm(arch: str, *, steps: int, batch: int, seq: int, scale: float = 1.0,
             ckpt_dir: str | None = None, les_groups: int = 0, seed: int = 0,
             device=DEFAULT_DEVICE, cfg=None) -> dict:
    """LM training, the JAX launcher's ``train_lm``: ``cfg``, by default the
    arch's smoke config (``scale`` is ignored, as there), Zipf batches from
    ``synthetic_lm_generator(seed)``, AdamW, a checkpoint at the end and a
    resume from the newest one.  Prints every 20th step and ``[done]``;
    returns the losses, each step's metrics and host seconds (to the loss's
    arrival on the host) and the final state."""
    from repro_torch.data.loader import ShardedLoader, synthetic_lm_generator
    from repro_torch.train import trainer

    device = resolve_device(device)
    cfg = get_smoke_config(arch) if cfg is None else cfg
    if les_groups:
        cfg = dataclasses.replace(cfg, les_groups=les_groups,
                                  num_layers=max(cfg.num_layers, 4))
    gen = synthetic_lm_generator(cfg.vocab_size, seq, batch, seed=seed)
    loader = ShardedLoader(gen, global_batch=batch, process_index=0, process_count=1)
    step_fn = trainer.build_train_step(cfg)
    state = trainer.init_state(prng.PRNGKey(seed), cfg, device=device)

    start = 0
    if ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        state, start = ckpt.restore(ckpt_dir, state)
        print(f"[restore] resumed from step {start}")

    losses, step_metrics, step_s = [], [], []
    try:
        for it in range(steps):
            b = next(loader)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, {k: torch.from_numpy(v).to(device)
                                             for k, v in b.items()})
            losses.append(float(metrics["loss"]))  # waits for the step
            step_s.append(time.perf_counter() - t0)
            step_metrics.append(metrics)
            if it % 20 == 0:
                print(f"step {it:4d}  loss={losses[-1]:.4f}  "
                      f"gnorm={float(metrics['grad_norm']):.3f}")
    finally:
        loader.close()
    if ckpt_dir:
        ckpt.save(ckpt_dir, start + steps, state)
    print(f"[done] loss {losses[0]:.4f} → {losses[-1]:.4f}")
    return {"first_loss": losses[0], "last_loss": losses[-1], "losses": losses,
            "step_metrics": step_metrics, "step_s": step_s, "state": state,
            "config": cfg, "start_step": start}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True, choices=(*PAPER_ARCHS, *sorted(LM_ARCHS)))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seq", type=int, default=128, help="LM archs: sequence length")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--dataset", default="tiles32", choices=("tiles32", "digits28"))
    ap.add_argument("--les-groups", type=int, default=0,
                    help="LM archs: LES local-loss groups (0 = backprop)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=DEFAULT_DEVICE, help="cuda (default) or cpu")
    ap.add_argument("--backend", default="auto", choices=("auto", "cuda", "reference"),
                    help="auto = the CUDA kernels on the card, the plain "
                         "versions on the CPU; reference = the plain versions")
    ap.add_argument("--fuse-opt", action="store_true",
                    help="apply IntegerSGD in the grad_W kernels' flush "
                         "(bitwise the split step)")
    ap.add_argument("--ckpt-dir",
                    help="save checkpoints here (every 200 steps and at the "
                         "end) and resume from its newest one")
    ap.add_argument("--telemetry-every", type=int, default=0,
                    help="sample integer-numerics telemetry every N steps "
                         "(0 = off) into --telemetry-out")
    ap.add_argument("--telemetry-out",
                    help="telemetry JSONL path (default: metrics.jsonl "
                         "next to the checkpoints)")
    ap.add_argument("--trace-out",
                    help="write a span trace of the run (JSONL)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve /metrics, /metrics.json and /healthz on "
                         "this port (0 = ephemeral)")
    ap.add_argument("--alerts-out",
                    help="append health alerts as JSONL (they always "
                         "print inline)")
    ap.add_argument("--num-devices", type=int, default=1,
                    help="data-parallel ranks, one process each (the "
                         "trajectory is bitwise the same at any value)")
    ap.add_argument("--dp-reduce", default="psum", choices=dp.REDUCERS,
                    help="gradient all-reduce: the backend's, a ring of "
                         "point-to-point sends, or int8 limb planes (all exact)")
    ap.add_argument("--autotune", action="store_true",
                    help="tune the kernels' run-time knobs for this arch and "
                         "batch before training (bitwise the same run)")
    ap.add_argument("--autotune-cache",
                    help="tile-cache JSON path (default: tile_cache.json "
                         "next to the checkpoints)")
    return ap


def main(argv=None) -> dict:
    """Parse ``argv`` (default: the command line), train, return the result."""
    args = _parser().parse_args(argv)
    if args.arch in LM_ARCHS:
        return train_lm(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
                        scale=args.scale, ckpt_dir=args.ckpt_dir,
                        les_groups=args.les_groups, seed=args.seed, device=args.device)
    return train_nitro(args.arch, steps=args.steps, batch=args.batch,
                       dataset=args.dataset, scale=args.scale, seed=args.seed,
                       device=args.device, backend=args.backend,
                       fuse_opt=args.fuse_opt, ckpt_dir=args.ckpt_dir,
                       telemetry_every=args.telemetry_every,
                       telemetry_out=args.telemetry_out,
                       trace_out=args.trace_out,
                       metrics_port=args.metrics_port,
                       alerts_out=args.alerts_out,
                       num_devices=args.num_devices, dp_reduce=args.dp_reduce,
                       autotune=args.autotune, autotune_cache=args.autotune_cache)


if __name__ == "__main__":
    main()
