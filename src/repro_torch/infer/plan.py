"""Compile a FrozenModel into a fused integer execution plan (port of
``repro.infer.plan``).

Each conv step runs the streaming ``stream_conv`` kernel (implicit im2col,
2×2 pool fused into the epilogue); each linear/output step runs
``nitro_matmul``.  Inter-layer activations are narrowed to int8 wherever
the NITRO-ReLU range fits (α_inv ≥ 2), and a step multiplies int8
operands wherever both its incoming activation and its weight are int8 —
the same per-step decisions as the JAX plan, so ``summary()`` rows match.

Backends: ``'cuda'`` (the kernels), ``'reference'`` (the plain PyTorch
versions, on any device), ``'auto'`` (``cuda`` on a CUDA device,
``reference`` on the CPU).  Every backend and conv mode is bit-exact with
``model.frozen_forward`` on the same weights.

With an autotune cache configured (``kernels.autotune.configure``) each
step's dispatcher looks its problem up under the JAX plan's key
(``plan_shapes``: the frozen weight's dtype, although int32-operand steps
hold it lifted); each step's int8-operand choice is recorded on the
``kernel_int8_path_active`` gauge when the autotuner's metrics are
attached.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.activations import relu_fits_int8
from repro_torch.core.numerics import INT_DTYPE
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.infer.export import FrozenModel
from repro_torch.kernels.autotune import state as autotune_state
from repro_torch.kernels.autotune.cache import dtype_name
from repro_torch.kernels.nitro_conv import ops as conv_ops
from repro_torch.kernels.nitro_matmul import ops as nitro_ops
from repro_torch.obs import trace

_DTYPES = {"int8": torch.int8, "int32": torch.int32}


class StepMeta(NamedTuple):
    """Static description of one fused plan step."""

    kind: str           # 'conv' | 'linear' | 'output'
    sf: int
    alpha_inv: int
    apply_relu: bool
    pool: bool
    kernel_size: int    # conv only (0 otherwise)
    out_dtype: str      # 'int8' | 'int32' — inter-layer activation dtype
    conv_mode: str = "" # conv only: 'stream' | 'materialise'
    fused_pool: bool = False  # pool folded into the conv kernel epilogue
    operand_dtype: str = "int32"  # multiply operands: 'int8' | 'int32'


class ExecutionPlan:
    """A FrozenModel lowered to fused kernel calls on one device."""

    def __init__(
        self,
        fm: FrozenModel,
        *,
        device=DEFAULT_DEVICE,
        backend: str = "auto",
        conv_mode: str = "stream",
        operand_dtype: str = "auto",
    ):
        """``operand_dtype`` selects the operand path per step:

        * ``'auto'``  — int8 wherever it is provably exact: the incoming
          activation is int8-narrowed and the frozen weight is int8;
        * ``'int32'`` — every step lifts to int32;
        * ``'int8'``  — as ``auto``, but raises if no step qualifies.
        """
        if operand_dtype not in nitro_ops.OPERAND_DTYPES:
            raise ValueError(
                f"unknown operand_dtype {operand_dtype!r}; "
                f"one of {nitro_ops.OPERAND_DTYPES}"
            )
        self.device = resolve_device(device)
        self.backend = nitro_ops.resolve_backend(backend, self.device)
        self.conv_mode = conv_ops.resolve_conv_mode(conv_mode)
        self.input_shape = fm.input_shape
        self.num_classes = fm.num_classes
        self.name = fm.name
        self.frozen_weights = [layer.w for layer in fm.layers]
        metas, weights = [], []
        act_dtype = "int32"  # logits() casts the network input to int32
        for i, layer in enumerate(fm.layers):
            out_dtype = (
                "int8"
                if layer.apply_relu and relu_fits_int8(layer.alpha_inv)
                else "int32"
            )
            is_conv = layer.kind == "conv"
            int8_ok = act_dtype == "int8" and layer.w.dtype == torch.int8
            step_od = "int8" if int8_ok and operand_dtype != "int32" else "int32"
            autotune_state.note_int8_path(f"{fm.name}/{i}", step_od == "int8")
            metas.append(StepMeta(
                kind=layer.kind, sf=layer.sf, alpha_inv=layer.alpha_inv,
                apply_relu=layer.apply_relu, pool=layer.pool,
                kernel_size=layer.w.shape[0] if is_conv else 0,
                out_dtype=out_dtype,
                conv_mode=self.conv_mode if is_conv else "",
                fused_pool=bool(
                    is_conv and layer.pool and self.conv_mode == "stream"
                ),
                operand_dtype=step_od,
            ))
            # lift once here, not on every call, for int32-operand steps
            wt = layer.w if step_od == "int8" else layer.w.to(INT_DTYPE)
            weights.append(wt.to(self.device).contiguous())
            act_dtype = out_dtype
        if operand_dtype == "int8" and not any(
            m.operand_dtype == "int8" for m in metas
        ):
            raise ValueError(
                "operand_dtype='int8': no step is int8-eligible (needs an "
                "int8-narrowed incoming activation AND an int8 weight); "
                "use 'auto' or the int32 escape hatch"
            )
        self.metas = tuple(metas)
        self.weights = weights

    @trace.spanned("plan.logits")
    @torch.inference_mode()
    def logits(self, x) -> torch.Tensor:
        """(N, *input_shape) integer batch → (N, num_classes) int32 logits,
        on the plan's device.  The batch moves to the device once."""
        tracer = trace.active()
        a = torch.as_tensor(x).to(device=self.device, dtype=INT_DTYPE)
        for i, (w, frozen, meta) in enumerate(
                zip(self.weights, self.frozen_weights, self.metas)):
            with tracer.span("plan.layer", layer=i, kind=meta.kind):
                out_dtype = _DTYPES[meta.out_dtype]
                if meta.kind == "conv":
                    a = conv_ops.fused_conv(
                        a, w, sf=meta.sf, alpha_inv=meta.alpha_inv,
                        apply_relu=meta.apply_relu, pool=meta.pool,
                        out_dtype=out_dtype, backend=self.backend,
                        conv_mode=meta.conv_mode, operand_dtype=meta.operand_dtype,
                        key_w_dtype=frozen.dtype,
                    )
                else:  # 'linear' | 'output' — flatten anything spatial entering
                    if a.ndim > 2:
                        a = a.reshape(a.shape[0], -1)
                    a = nitro_ops.fused_matmul(
                        a, w, sf=meta.sf, alpha_inv=meta.alpha_inv,
                        apply_relu=meta.apply_relu, out_dtype=out_dtype,
                        backend=self.backend, operand_dtype=meta.operand_dtype,
                        key_w_dtype=frozen.dtype,
                    )
        return a

    def predict(self, x) -> torch.Tensor:
        """Predicted labels, int32 (as the JAX plan's argmax returns)."""
        return self.logits(x).argmax(dim=-1).to(INT_DTYPE)

    def summary(self) -> list[dict]:
        """Per-step introspection with per-sample device-memory traffic
        estimates for both conv routes — the same rows as the JAX plan's.

          * ``materialise`` — read the input, write and read back the
            (H·W, K²·C) im2col patch matrix, write the full activation,
            and for pooled layers round-trip it through a separate pool;
          * ``stream``      — read the input once, write the (pooled)
            activation.
        """
        rows = []
        shape = tuple(int(d) for d in self.input_shape)
        in_itemsize = 4  # logits() casts the network input to int32
        for w, meta in zip(self.frozen_weights, self.metas):
            out_itemsize = _DTYPES[meta.out_dtype].itemsize
            if meta.kind == "conv":
                h, w_sp, c = shape
                k, f = meta.kernel_size, int(w.shape[-1])
                in_bytes = h * w_sp * c * in_itemsize
                patch_bytes = in_bytes * k * k
                full_out = h * w_sp * f * out_itemsize
                out_shape = (h // 2, w_sp // 2, f) if meta.pool else (h, w_sp, f)
                final_out = out_shape[0] * out_shape[1] * f * out_itemsize
                materialise = in_bytes + 2 * patch_bytes + full_out
                if meta.pool:
                    materialise += full_out + final_out
                stream = in_bytes + final_out  # pool fused ⇒ one write
                shape = out_shape
            else:
                feat = 1
                for d in shape:
                    feat *= d
                in_bytes = feat * in_itemsize
                out_bytes = int(w.shape[-1]) * out_itemsize
                materialise = stream = in_bytes + out_bytes
                shape = (int(w.shape[-1]),)
            rows.append({
                "kind": meta.kind,
                "weight_shape": tuple(int(d) for d in w.shape),
                "weight_dtype": dtype_name(w.dtype),
                "sf": meta.sf,
                "activation_dtype": meta.out_dtype,
                "operand_dtype": meta.operand_dtype,
                "pool": meta.pool,
                "conv_mode": meta.conv_mode or None,
                "fused_pool": meta.fused_pool,
                # per output element: unfused writes z(int32) + z*(int32) +
                # act(int32); fused writes only the narrowed activation
                "hbm_bytes_per_out_elem": {
                    "unfused": 12,
                    "fused": out_itemsize,
                },
                "hbm_per_sample_bytes": {
                    "materialise": int(materialise),
                    "stream": int(stream),
                },
                "stream_saving_ratio": round(materialise / stream, 2),
            })
            in_itemsize = out_itemsize
        return rows


def compile_plan(
    fm: FrozenModel,
    *,
    device=DEFAULT_DEVICE,
    backend: str = "auto",
    conv_mode: str = "stream",
    operand_dtype: str = "auto",
) -> ExecutionPlan:
    """FrozenModel → ExecutionPlan on ``device`` (CUDA unless told otherwise)."""
    return ExecutionPlan(
        fm, device=device, backend=backend, conv_mode=conv_mode,
        operand_dtype=operand_dtype,
    )
