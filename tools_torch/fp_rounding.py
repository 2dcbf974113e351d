#!/usr/bin/env python3
"""How far float32 rounding alone moves the FP baselines: the yardstick
behind the tolerances of ``chip_smoke.py``'s phase 10a.

    python3 tools_torch/fp_rounding.py     # from the root of a checkout, one CUDA card

For phase 10a's cells (FP BP and FP LES on full-width VGG8B, FP BP on
full-width mlp4; ``init_fp_params(PRNGKey(0))``, phase 5's and 5e's
batches and keys):
  * step 1's loss and gradient in float32 on the card and on the CPU, each
    against the same step in float64 on the card (every tensor float64),
    and against each other;
  * 4 steps in float32 on the card and on the CPU: each later step's loss,
    and the final params (and Adam's moments) of one against the other.
A deviation is max |a − b| / max |b| of a tensor, with the RMS
‖a − b‖ / ‖b‖ beside it; each line gives the largest over the tensors.

``float64_math`` is the same yardstick for the LM models, which compute
in float32 and bf16 as JAX's do: the LM parity tests
(``tests/_torch_lm.py``) and ``chip_smoke.py``'s phase 11 run a step once
more under it and take their tolerances from the distance.
"""

from __future__ import annotations

import contextlib
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def float64_math():
    """Every float32, bf16 and fp16 dtype that an aten op inside is asked
    for (a cast, ``.float()``, a factory, a constant from ``torch.tensor``)
    becomes float64, in the forward, the backward and a remat's recompute
    alike: the same program as the float32 one with its rounding taken
    away.  The LM parity checks (``tests/_torch_lm.py``, ``chip_smoke.py``
    phase 11) measure from it how far float32 and bf16 rounding alone
    moves a result, and take their tolerances from that."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    low = (torch.float32, torch.bfloat16, torch.float16)

    def wide(v):
        return torch.float64 if isinstance(v, torch.dtype) and v in low else v

    class Float64(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*map(wide, args), **{k: wide(v) for k, v in (kwargs or {}).items()})
            if func is torch.ops.aten.lift_fresh.default and out.dtype in low:
                out = out.to(torch.float64)
            return out

    with Float64():
        yield


@contextlib.contextmanager
def float64(fp):
    """The FP baselines computing in float64 (their float dtype swapped)."""
    import torch

    saved, fp.F32 = fp.F32, torch.float64
    try:
        yield
    finally:
        fp.F32 = saved


def worst(pairs) -> str:
    """The largest deviation (and RMS) over (got, want) tensor pairs; a
    pair whose ``want`` is all zero is skipped."""
    from chip_smoke import _dev

    devs = [_dev(a, b) for a, b in pairs if b.abs().max() > 0]
    return f"{max(d[0] for d in devs):.3e} (RMS {max(d[1] for d in devs):.3e})"


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as smoke
    from repro_torch.core import fp_baselines as fp
    from repro_torch.parallel.tree import leaves, tree_map

    if not torch.cuda.is_available():
        smoke.die("CUDA is not available: this tool measures on a CUDA card")
    card = smoke.toolchain(torch)
    cfg, steps = smoke.cli_batches()
    mlp_cfg, mlp_steps = smoke.mlp_batches()
    for tag, kind, c, st in (("VGG8B", "bp", cfg, steps), ("VGG8B", "les", cfg, steps),
                             ("mlp4", "bp", mlp_cfg, mlp_steps)):
        init, gpu, _, _ = smoke.fp_trajectory(kind, c, st, "cuda")
        _, cpu, _, _ = smoke.fp_trajectory(
            kind, c, [(x.cpu(), y.cpu(), k) for x, y, k in st], "cpu")
        x, y, key = st[0]
        loss_fn = fp.loss_bp if kind == "bp" else fp.loss_les
        step1 = {}
        for dev in ("cuda", "cpu"):
            p = tree_map(lambda t: t.to(dev), init)
            step1[dev] = fp.value_and_grad(loss_fn, p, c, smoke.fp_input(x.to(dev)),
                                           y.to(dev), key)
        with float64(fp):
            step1["cuda64"] = fp.value_and_grad(loss_fn, tree_map(torch.Tensor.double, init),
                                                c, x.double() / 64.0, y, key)
        what = f"[fp-rounding] {card} | {tag} FP {kind.upper()}"
        for a, b in (("cuda", "cuda64"), ("cpu", "cuda64"), ("cuda", "cpu")):
            (la, ga), (lb, gb) = step1[a], step1[b]
            rel = abs(float(la) - float(lb)) / abs(float(lb))
            print(f"{what} step 1, {a} float32 vs {b.replace('64', '')} "
                  f"{'float64' if b.endswith('64') else 'float32'}: loss {rel:.3e}, gradient "
                  f"{worst(zip(leaves(ga), leaves(gb)))}")
        losses = [abs(float(g[2]) - float(q[2])) / abs(float(q[2])) for g, q in zip(gpu, cpu)]
        (p, o, _), (cp, co, _) = gpu[-1], cpu[-1]
        finals = f"params {worst(zip(leaves(p), leaves(cp)))}"
        if kind == "bp":
            moments = zip(leaves(o.mu) + leaves(o.nu), leaves(co.mu) + leaves(co.nu))
            finals += f", moments {worst(moments)}"
        print(f"{what} {len(gpu)} steps, card vs CPU in float32: losses "
              + ", ".join(f"{v:.3e}" for v in losses) + f"; final {finals}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
