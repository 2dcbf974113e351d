"""Ranks of the port's data-parallel parity suite (``tests/test_torch_dp.py``).

    PYTHONPATH=src python tests/_torch_dp_world.py --ranks 4 --out /tmp/w4.npz

Starts ``--ranks`` gloo ranks on the CPU through the port's own launcher
(``repro_torch.parallel.dp.spawn``).  Every rank runs every cell and
returns its results as numpy arrays; the script saves them in one ``.npz``
under ``r{rank}/{cell}/{name}``.  The cells:

  * ``tiny-{reducer}``: the conv + linear net with dropout on both blocks
    (``tiny_dp_cfg`` of ``tests/test_data_parallel.py``), global batch 8,
    3 steps, keys ``PRNGKey(100 + i)``; ``tiny-psum-fuse_opt`` at 2 ranks;
    ``tiny-telemetry`` (psum, telemetry every step) at 4 ranks;
  * ``vgg8b-{reducer}``: VGG8B at scale 0.0625, input (16, 16, 3), 2 steps;
  * ``ring``: ``ring_reduce_scatter`` / ``ring_all_gather`` /
    ``ring_all_reduce`` (7 rows, not a multiple of the ranks) beside
    ``all_reduce``, on per-rank seeded int32 data;
  * ``wrap``: INT32_MAX on rank 0 and 1 on rank 1 through every reducer;
  * ``ef``: the EF ``compressed_psum`` on per-rank seeded float32 gradients;
  * ``cli-resume`` (2 ranks only, after the cells): the train CLI with
    ``--num-devices 2`` twice on one ``--ckpt-dir``, the second call
    resuming from the first's checkpoint.

The test process holds each cell against the JAX package's single-device
``les.train_step`` (and the collectives against numpy and JAX's ``vmap``).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REDUCERS = ("psum", "ring", "compress")


def batch_of(cfg, batch: int):
    """The JAX worker's data: ``default_rng(0)``, images then labels."""
    rng = np.random.default_rng(0)
    x = rng.integers(-128, 128, (batch, *cfg.input_shape)).astype(np.int32)
    y = rng.integers(0, cfg.num_classes, (batch,)).astype(np.int32)
    return x, y


def tiny_cfg():
    from repro_torch.core.blocks import BlockSpec
    from repro_torch.core.model import NitroConfig

    return NitroConfig(
        blocks=(BlockSpec(kind="conv", out_features=16, pool=True, d_lr=256, dropout=0.1),
                BlockSpec(kind="linear", out_features=64, dropout=0.1)),
        input_shape=(8, 8, 3), num_classes=10, gamma_inv=512)


def rank_data(rank: int, shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed + rank).integers(
        -(2 ** 20), 2 ** 20, shape).astype(np.int32)


def _run(axis, cfg, steps: int, batch: int, **kw) -> dict:
    import torch
    from repro_torch.core import les, prng
    from repro_torch.parallel import dp, tree

    x, y = (torch.from_numpy(a) for a in batch_of(cfg, batch))
    state = les.create_train_state(prng.PRNGKey(0), cfg, device="cpu")
    step = dp.make_dp_train_step(cfg, axis, **kw)
    out = {}
    for i in range(steps):
        res = step(state, x, y, prng.PRNGKey(100 + i))
        state, metrics = res[0], res[1]
        for f, v in metrics._asdict().items():
            out[f"step{i}/{f}"] = v.numpy()
        if kw.get("telemetry"):
            telem = res[2]
            for f, v in telem.pop("dp").items():
                out[f"step{i}/dp_{f}"] = v.numpy()
            for j, leaf in enumerate(tree.leaves(telem)):
                out[f"step{i}/telem_{j:03d}"] = leaf.numpy()
    for j, leaf in enumerate(tree.leaves(state)):
        out[f"state_{j:03d}"] = leaf.numpy()
    return out


def world(axis, device) -> dict:
    """Every cell on this rank: ``{cell/name: array}``."""
    import torch
    from repro_torch.configs import get_paper_config
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import compress

    torch.set_num_threads(1)  # the ranks share the test worker's cores
    n, r = axis.size, axis.rank
    cells = {}
    tiny = tiny_cfg()
    vgg = get_paper_config("vgg8b", scale=0.0625, input_shape=(16, 16, 3))
    for reducer in REDUCERS:
        cells[f"tiny-{reducer}"] = _run(axis, tiny, 3, 8, dp_reduce=reducer)
        cells[f"vgg8b-{reducer}"] = _run(axis, vgg, 2, 8, dp_reduce=reducer)
    if n == 2:
        cells["tiny-psum-fuse_opt"] = _run(axis, tiny, 3, 8, dp_reduce="psum", fuse_opt=True)
    if n == 4:
        cells["tiny-telemetry"] = _run(axis, tiny, 3, 8, dp_reduce="psum", telemetry=True)

    x = torch.from_numpy(rank_data(r, (3 * n, 5), seed=10))
    odd = torch.from_numpy(rank_data(r, (7, 3), seed=20))
    chunk = C.ring_reduce_scatter(x, axis)
    cells["ring"] = {
        "reduce_scatter": chunk.numpy(),
        "all_gather": C.ring_all_gather(chunk, axis).numpy(),
        "all_reduce_ring": C.ring_all_reduce(odd, axis).numpy(),
        "all_reduce": C.all_reduce(odd, axis).numpy(),
        "x_untouched": x.numpy(),
    }
    edge = torch.tensor([2 ** 31 - 1 if r == 0 else 1 if r == 1 else 0, -5], dtype=torch.int32)
    cells["wrap"] = {
        "psum": compress.exact_integer_psum(edge, axis).numpy(),
        "ring": C.ring_all_reduce(edge, axis).numpy(),
        "compress": compress.nitro_compressed_psum(edge, axis).numpy(),
        "compress2": compress.nitro_compressed_psum(edge.clamp(-1000, 1000), axis,
                                                    num_limbs=2).numpy(),
    }
    g = {"a": torch.from_numpy(np.random.default_rng(30 + r).standard_normal((6, 5))
                               .astype(np.float32)),
         "b": torch.from_numpy(np.random.default_rng(40 + r).standard_normal(9)
                               .astype(np.float32) * 1e-3)}
    ef = compress.ef_init(g)
    red, ef = compress.compressed_psum(g, ef, axis)
    cells["ef"] = {"sum_a": red["a"].numpy(), "sum_b": red["b"].numpy(),
                   "res_a": ef.residual["a"].numpy(), "res_b": ef.residual["b"].numpy()}
    return {f"{cell}/{k}": v for cell, vals in cells.items() for k, v in vals.items()}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    from repro_torch.parallel import dp

    results = dp.spawn(world, args.ranks, device="cpu")
    out = {f"r{r}/{k}": v for r, res in enumerate(results) for k, v in res.items()}
    if args.ranks == 2:
        out.update(resumed_cli(os.path.dirname(os.path.abspath(args.out))))
    np.savez(args.out, **out)


def resumed_cli(root: str) -> dict:
    """The train CLI on 2 ranks twice with one ``--ckpt-dir`` (VGG8B 0.0625,
    2 steps at batch 8 a call): each call's start step, and the second
    call's final state and step metrics."""
    from repro_torch.launch import train
    from repro_torch.parallel import tree

    argv = ["--arch", "vgg8b", "--scale", "0.0625", "--steps", "2", "--batch", "8",
            "--device", "cpu", "--num-devices", "2", "--ckpt-dir", f"{root}/dp_ckpt"]
    first, second = (train.main(argv) for _ in range(2))
    out = {"cli-resume/start_steps": np.array([first["start_step"], second["start_step"]])}
    for j, leaf in enumerate(tree.leaves((second["state"], second["step_metrics"]))):
        out[f"cli-resume/leaf_{j:03d}"] = leaf.numpy()
    return out


if __name__ == "__main__":
    main()
