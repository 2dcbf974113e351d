"""Quickstart on the PyTorch port: native integer-only training of a small
CNN (NITRO-D), the port of ``examples/quickstart.py``.

    PYTHONPATH=src python examples_torch/quickstart.py                # on the card
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu   # plain PyTorch

Demonstrates the paper's core claims live:
  1. the train step's tensor operations are integer-only: one
     ``train_step`` runs under a ``TorchDispatchMode`` that counts the
     floating-point tensors among the inputs and outputs of every aten
     operation, and the count, 0, is asserted on the CPU and on the card.
     On the card the hand-written kernels (``numerics.int_matmul``'s
     integer GEMM among them) launch through ``ctypes``, which the
     dispatcher does not see; each key of the audit says whether the
     operation ran inside ``numerics._matmul_f64_exact``, the float64 limb
     GEMM that is now only the plain version of that product;
  2. accuracy climbs well above chance with integer arithmetic only;
  3. trained weights stay within int16 (paper §E.3).
"""

import argparse
import sys
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.core import les, model, numerics, prng
from repro_torch.core.blocks import BlockSpec
from repro_torch.core.model import NitroConfig
from repro_torch.data import synthetic
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.parallel.tree import leaves

_LIMB_GEMM = numerics._matmul_f64_exact.__code__


def _in_limb_gemm() -> bool:
    """Whether ``numerics._matmul_f64_exact`` is on the Python stack."""
    f = sys._getframe()
    while f is not None:
        if f.f_code is _LIMB_GEMM:
            return True
        f = f.f_back
    return False


class FloatAudit(TorchDispatchMode):
    """Counts the floating-point tensors among the inputs and outputs of
    each aten operation run inside it.  ``ops`` maps (operation, whether
    it ran inside the float64 limb GEMM) to its floating-point tensors,
    so a failed assertion names where the floats came from."""

    def __init__(self):
        super().__init__()
        self.n_float = 0
        self.ops: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        n = sum(1 for t in tree_leaves((args, kwargs, out))
                if isinstance(t, torch.Tensor) and t.is_floating_point())
        if n:
            self.n_float += n
            self.ops[(str(func), _in_limb_gemm())] += n
        return out


def audit_train_step(state, cfg, x, labels, key) -> FloatAudit:
    """One ``les.train_step`` under a ``FloatAudit``."""
    with FloatAudit() as audit:
        les.train_step(state, cfg, x, labels, key)
    return audit


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=DEFAULT_DEVICE, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    ds = synthetic.make_image_dataset("tiles32", n_train=2048, n_test=512)
    cfg = NitroConfig(
        blocks=(
            BlockSpec("conv", 32, pool=True, d_lr=512),
            BlockSpec("conv", 64, pool=True, d_lr=512),
            BlockSpec("linear", 128),
        ),
        input_shape=ds.input_shape,
        num_classes=ds.num_classes,
        gamma_inv=512, eta_fw=25000, eta_lr=5000,
        name="quickstart-cnn",
    )
    state = les.create_train_state(prng.PRNGKey(0), cfg, device=device)
    print(f"model: {model.count_params(state.params):,} integer parameters")

    def dev(a):
        return torch.from_numpy(a).to(device)

    # 1. the step's tensor operations are integer-only
    audit = audit_train_step(state, cfg, dev(ds.x_train[:8]), dev(ds.y_train[:8]),
                             prng.PRNGKey(0))
    print(f"float tensors in the train step's aten operations on {device}: "
          f"{audit.n_float} (expected 0)")
    assert audit.n_float == 0, dict(audit.ops)

    # 2. train
    k = 0
    for epoch in range(6):
        correct = total = 0
        for x, y in synthetic.batches(ds.x_train, ds.y_train, 64, seed=epoch):
            state, m = les.train_step(state, cfg, dev(x), dev(y), prng.PRNGKey(k))
            k += 1
            correct += int(m.correct)
            total += 64
        test_c = 0
        for i in range(0, 512, 64):
            test_c += int(les.eval_step(state, cfg, dev(ds.x_test[i:i + 64]),
                                        dev(ds.y_test[i:i + 64])))
        print(f"epoch {epoch}: train {correct / total:.3f}  test {test_c / 512:.3f}")

    # 3. weight range (paper §E.3: int16 suffices)
    mx = max(int(p.abs().max()) for p in leaves(state.params))
    print(f"max |weight| after training: {mx}  (int16 bound: 32767)")
    assert mx < 2 ** 15


if __name__ == "__main__":
    main()
