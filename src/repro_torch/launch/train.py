"""NITRO-D training launcher (port of ``repro.launch.train``, the paper
archs): integer-only LES training of the MLPs (mlp1–mlp4, on the
flattened images) and the CNNs (VGG8B / VGG11B).

    # four steps of full-width VGG8B at batch 64 on the card, then evaluate:
    PYTHONPATH=src python -m repro_torch.launch.train --arch vgg8b --steps 4

    # full-width mlp4 (3072→3000×3→10) on the card:
    PYTHONPATH=src python -m repro_torch.launch.train --arch mlp4 --steps 4

    # the plain PyTorch path on the CPU at a small width, with checkpoints
    # (a second run with the same --ckpt-dir resumes from LATEST):
    PYTHONPATH=src python -m repro_torch.launch.train --arch vgg8b \
        --steps 20 --scale 0.0625 --device cpu --ckpt-dir /tmp/ckpt

The data, the init and the dropout key of step ``it`` are those of the
JAX launcher, so both give the same trajectory and the same test accuracy
for the same arguments.  ``--ckpt-dir`` saves every 200 steps and at the
end in the JAX package's checkpoint format and resumes from its newest
checkpoint, with the JAX launcher's semantics: after a resume from step
S the keys are ``PRNGKey(S + it)`` while the batches are shuffled with
``seed=it`` from ``it = 0``, and ``steps`` counts this call's steps.
``--fuse-opt`` takes the ``fuse_opt`` step (IntegerSGD in the grad_W
kernels' flush), bitwise the split step.  Not ported yet: data
parallelism, telemetry and health alerts, autotuning, the LM trainer.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_paper_config
from repro_torch.core import les, prng
from repro_torch.data import synthetic
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.train import checkpoint as ckpt

ARCHS = ("mlp1", "mlp2", "mlp3", "mlp4", "vgg8b", "vgg11b")
CKPT_EVERY = 200


def train_nitro(arch: str, *, steps: int, batch: int = 64,
                dataset: str = "tiles32", scale: float = 1.0, seed: int = 0,
                device=DEFAULT_DEVICE, backend: str = "auto",
                fuse_opt: bool = False, ckpt_dir: str | None = None) -> dict:
    """Integer-only NITRO-D training, then test accuracy.

    Returns ``test_accuracy``, ``steps`` and ``scaled_loss`` (the keys of
    the JAX trainer's result) plus ``state`` (the final ``TrainState``),
    ``step_metrics`` (one ``StepMetrics`` per step), ``start_step`` (the
    step resumed from, 0 without a checkpoint) and ``train_s`` (host
    seconds of the step loop, ending in a device synchronise).
    """
    if arch not in ARCHS:
        raise ValueError(f"arch {arch!r} is not ported; one of {ARCHS}")
    device = resolve_device(device)
    ds = synthetic.make_image_dataset(dataset, n_train=4096, n_test=512, seed=seed)
    cfg = get_paper_config(arch, scale=scale,
                           input_shape=ds.input_shape if arch.startswith("vgg") else None)
    if arch.startswith("mlp"):
        ds = synthetic.flatten_for_mlp(ds)
        if cfg.input_shape != ds.input_shape:
            cfg = dataclasses.replace(cfg, input_shape=ds.input_shape)
    state = les.create_train_state(prng.PRNGKey(seed), cfg, device=device)
    start_step = 0
    checkpointer = ckpt.AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    if ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        state, start_step = ckpt.restore(ckpt_dir, state)
        print(f"[restore] resumed from step {start_step}")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    it = 0
    metrics = None
    step_metrics = []
    sync()
    t0 = time.perf_counter()
    while it < steps:
        for x, y in synthetic.batches(ds.x_train, ds.y_train, batch, seed=it):
            if it >= steps:
                break
            state, metrics = les.train_step(
                state, cfg, torch.from_numpy(x).to(device),
                torch.from_numpy(y).to(device), prng.PRNGKey(start_step + it),
                backend=backend, fuse_opt=fuse_opt,
            )
            step_metrics.append(metrics)
            if it % 50 == 0:
                print(f"step {it:5d}  loss={int(metrics.loss)}  "
                      f"scaled={metrics.scaled_loss(batch):.4f}  "
                      f"correct={int(metrics.correct)}/{batch}")
            if checkpointer and it > 0 and it % CKPT_EVERY == 0:
                checkpointer.save(start_step + it, state)
            it += 1
    sync()
    train_s = time.perf_counter() - t0
    if checkpointer:
        checkpointer.save(start_step + it, state)
        checkpointer.wait()

    correct = 0
    for i in range(0, len(ds.x_test) - batch + 1, batch):
        correct += int(les.eval_step(
            state, cfg, torch.from_numpy(ds.x_test[i:i + batch]).to(device),
            torch.from_numpy(ds.y_test[i:i + batch]).to(device)))
    n_eval = (len(ds.x_test) // batch) * batch
    acc = correct / max(n_eval, 1)
    print(f"[done] test accuracy {acc:.4f} over {n_eval} samples")
    out = {"test_accuracy": acc, "steps": it, "state": state,
           "step_metrics": step_metrics, "start_step": start_step,
           "train_s": train_s}
    if metrics is not None:
        out["scaled_loss"] = metrics.scaled_loss(batch)
    return out


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True, choices=ARCHS)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--dataset", default="tiles32", choices=("tiles32", "digits28"))
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
    return ap


def main(argv=None) -> dict:
    """Parse ``argv`` (default: the command line), train, return the result."""
    args = _parser().parse_args(argv)
    return train_nitro(args.arch, steps=args.steps, batch=args.batch,
                       dataset=args.dataset, scale=args.scale, seed=args.seed,
                       device=args.device, backend=args.backend,
                       fuse_opt=args.fuse_opt, ckpt_dir=args.ckpt_dir)


if __name__ == "__main__":
    main()
