"""The NITRO-D learning algorithm (port of ``repro.core.les``, paper §3.3)
— integer-only LES training.

One training step:

  1. forward through every block's forward layers and the output layers;
  2. output layers: ∇L_o = ŷ − y → IntegerSGD update (γ_inv^lr, η_inv^lr);
  3. per block: learning layers on a_l → ŷ_l; ∇L_l = ŷ_l − y →
     learning-layer update; δ_l^fw from the learning-layer backward →
     forward-layer update (γ_inv^fw = γ_inv^lr·AF, η_inv^fw).

No gradient crosses a block boundary, and every value is an integer.
Ported: the split step (``compute_gradients`` → ``apply_gradients``), the
``fuse_opt`` step and ``telemetry=True`` (the integer readout of
``obs.telemetry``, on the split path).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import blocks as B
from repro_torch.core import model as M
from repro_torch.core import optimizer as opt
from repro_torch.core.losses import ONE_HOT_VALUE, one_hot_int, rss_grad, rss_loss
from repro_torch.core.numerics import INT_DTYPE, argmax_first
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.obs import trace


class TrainState(NamedTuple):
    params: dict
    opt_lr: opt.IntegerSGDState   # learning + output layers
    opt_fw: opt.IntegerSGDState   # forward layers (γ amplified by AF)
    step: torch.Tensor            # int32 scalar


def create_train_state(key: torch.Tensor, cfg: M.NitroConfig, *,
                       device=DEFAULT_DEVICE) -> TrainState:
    device = resolve_device(device)
    params = M.init_params(key, cfg, device=device)
    af = opt.amplification_factor(cfg.num_classes)
    return TrainState(
        params=params,
        opt_lr=opt.init_state(cfg.gamma_inv, cfg.eta_lr, device=device),
        opt_fw=opt.init_state(cfg.gamma_inv * af, cfg.eta_fw, device=device),
        step=torch.zeros((), dtype=INT_DTYPE, device=device),
    )


class StepGrads(NamedTuple):
    """Raw integer gradients of one step, shaped like the params:
    ``blocks`` a tuple of ``{"fw": ..., "lr": ...}``, ``output`` a dict."""

    blocks: tuple
    output: dict


class StepAux(NamedTuple):
    """Non-gradient byproducts of ``compute_gradients`` that the
    telemetry readout consumes: each block's forward cache (``z_star``,
    ``act``, ...)."""

    fw_caches: tuple


class StepMetrics(NamedTuple):
    loss: torch.Tensor          # integer RSS of the output layers (int32)
    correct: torch.Tensor       # correct top-1 predictions in the batch (int32)
    local_losses: torch.Tensor  # per-block integer RSS (L,) int32

    def scaled_loss(self, batch_size: int) -> float:
        """Display-only per-sample loss in one-hot units: loss / (B·32²),
        computed on the host from the integer metric."""
        return float(self.loss) / (float(batch_size) * ONE_HOT_VALUE ** 2)


def _correct(y_hat: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (argmax_first(y_hat) == labels).sum().to(INT_DTYPE)


def compute_gradients(
    state: TrainState,
    cfg: M.NitroConfig,
    x,
    labels: torch.Tensor,
    key: torch.Tensor,
    *,
    fused: bool = True,
    fuse_bwd: bool = True,
    backend: str = "auto",
    conv_mode: str = "stream",
    dp_axis=None,
    dp_shards: int = 1,
) -> tuple[StepGrads, StepMetrics, StepAux]:
    """Forward + backward over a batch: raw gradients, no update; with
    the forward caches the telemetry readout needs.

    The gradients and metrics are sums over the batch this call saw, so
    summing them over batch shards (exact int32 addition) gives the
    whole batch's bit for bit: ``parallel.dp`` all-reduces them between
    this call and ``apply_gradients``.  ``dp_axis``/``dp_shards`` (the
    rank's ``DataAxis`` and its size) reach only dropout, which draws the
    global-batch mask and keeps this rank's rows.
    """
    params = state.params
    labels = labels.to(params["output"]["w"].device)
    y = one_hot_int(labels, cfg.num_classes)

    tracer = trace.active()
    with tracer.span("step.forward"):
        y_hat, acts, fw_caches, out_cache = M.forward(
            params, cfg, x, train=True, key=key, fused=fused, backend=backend,
            conv_mode=conv_mode, dp_axis=dp_axis, dp_shards=dp_shards,
        )

    with tracer.span("step.output"):
        grad_o = rss_grad(y_hat, y)
        out_grads = B.output_backward(params["output"], out_cache, grad_o)

    block_grads = []
    local_losses = []
    for i, (spec, p, a_l, fw_cache) in enumerate(
            zip(cfg.blocks, params["blocks"], acts, fw_caches)):
        with tracer.span("step.block", block=i):
            with tracer.span("blocks.learning", block=i):
                y_hat_l, lr_cache = B.learning_layers(p, spec, a_l)
                grad_l = B.local_gradient(y_hat_l, y)
                local_losses.append(rss_loss(y_hat_l, y))
                delta_fw, lr_grads = B.learning_layers_backward(p, spec, lr_cache, grad_l)
            with tracer.span("blocks.fw_update", block=i):
                fw_grads = B.forward_layers_backward(
                    p, spec, fw_cache, delta_fw,
                    conv_mode=conv_mode, backend=backend, fuse_bwd=fuse_bwd,
                )
        block_grads.append({"fw": fw_grads, "lr": lr_grads})

    grads = StepGrads(blocks=tuple(block_grads), output=out_grads)
    metrics = StepMetrics(
        loss=rss_loss(y_hat, y),
        correct=_correct(y_hat, labels),
        local_losses=torch.stack(local_losses),
    )
    return grads, metrics, StepAux(fw_caches=tuple(fw_caches))


@trace.spanned("step.apply")
def apply_gradients(state: TrainState, grads: StepGrads, *,
                    fuse_opt: bool = False, backend: str = "auto") -> TrainState:
    """IntegerSGD update of every parameter group from raw gradients.

    ``fuse_opt=True`` runs the update through the fused IntegerSGD kernel
    (``kernels.integer_sgd.apply_groups_fused``: every group's W and g
    read once and W′ written once, in one launch for all of them) instead
    of the tensor ops of ``optimizer.apply_tree`` — bitwise the same.
    ``backend`` is only read with ``fuse_opt``.
    """
    pairs = list(zip(state.params["blocks"], grads.blocks))
    if fuse_opt:
        # lazy: core imports no kernel package at module scope
        from repro_torch.kernels.integer_sgd.ops import apply_groups_fused

        groups = [grp for p, g in pairs for grp in ((p["fw"], g["fw"], state.opt_fw),
                                                    (p["lr"], g["lr"], state.opt_lr))]
        groups.append((state.params["output"], grads.output, state.opt_lr))
        new = apply_groups_fused(groups, backend=backend)
        new_blocks = [{"fw": fw, "lr": lr} for fw, lr in zip(new[:-1:2], new[1:-1:2])]
        new_output = new[-1]
    else:
        new_blocks = [
            {"fw": opt.apply_tree(p["fw"], g["fw"], state.opt_fw),
             "lr": opt.apply_tree(p["lr"], g["lr"], state.opt_lr)}
            for p, g in pairs
        ]
        new_output = opt.apply_tree(state.params["output"], grads.output, state.opt_lr)
    new_params = {"blocks": new_blocks, "output": new_output}
    return state._replace(params=new_params, step=state.step + 1)


def _fused_opt_step(
    state: TrainState,
    cfg: M.NitroConfig,
    x,
    labels: torch.Tensor,
    key: torch.Tensor,
    *,
    fused: bool,
    fuse_bwd: bool,
    backend: str,
    conv_mode: str,
) -> tuple[TrainState, StepMetrics]:
    """The step behind ``train_step(fuse_opt=True)``.

    Each block's forward-layer weight gradient is consumed inside the
    grad_W kernel whose flush applies IntegerSGD
    (``blocks.forward_layers_update``), so no forward-layer grad_W is
    written.  The learning and output layers keep ``optimizer.apply_tree``:
    their gradients are small (d_lr × classes) and their backward has no
    kernel flush.  Bitwise the split step: floor division of an exact
    int32 sum is exact.
    """
    params = state.params
    labels = labels.to(params["output"]["w"].device)
    y = one_hot_int(labels, cfg.num_classes)

    tracer = trace.active()
    with tracer.span("step.forward"):
        y_hat, acts, fw_caches, out_cache = M.forward(
            params, cfg, x, train=True, key=key, fused=fused, backend=backend,
            conv_mode=conv_mode,
        )

    with tracer.span("step.output"):
        grad_o = rss_grad(y_hat, y)
        out_grads = B.output_backward(params["output"], out_cache, grad_o)
        new_output = opt.apply_tree(params["output"], out_grads, state.opt_lr)

    new_blocks = []
    local_losses = []
    for i, (spec, p, a_l, fw_cache) in enumerate(
            zip(cfg.blocks, params["blocks"], acts, fw_caches)):
        with tracer.span("step.block", block=i):
            with tracer.span("blocks.learning", block=i):
                y_hat_l, lr_cache = B.learning_layers(p, spec, a_l)
                grad_l = B.local_gradient(y_hat_l, y)
                local_losses.append(rss_loss(y_hat_l, y))
                delta_fw, lr_grads = B.learning_layers_backward(p, spec, lr_cache, grad_l)
                new_lr = opt.apply_tree(p["lr"], lr_grads, state.opt_lr)
            with tracer.span("blocks.fw_update", block=i):
                new_fw = B.forward_layers_update(
                    p, spec, fw_cache, delta_fw, state.opt_fw,
                    conv_mode=conv_mode, backend=backend, fuse_bwd=fuse_bwd,
                )
        new_blocks.append({"fw": new_fw, "lr": new_lr})

    metrics = StepMetrics(
        loss=rss_loss(y_hat, y),
        correct=_correct(y_hat, labels),
        local_losses=torch.stack(local_losses),
    )
    new_params = {"blocks": new_blocks, "output": new_output}
    return state._replace(params=new_params, step=state.step + 1), metrics


def train_step(
    state: TrainState,
    cfg: M.NitroConfig,
    x,
    labels: torch.Tensor,
    key: torch.Tensor,
    *,
    fused: bool = True,
    fuse_bwd: bool = True,
    fuse_opt: bool = False,
    backend: str = "auto",
    conv_mode: str = "stream",
    telemetry: bool = False,
):
    """One integer-only NITRO-D step: ``compute_gradients`` then
    ``apply_gradients``.

    On CUDA tensors the default path runs ``stream_conv_fwd`` and
    ``nitro_matmul_fwd`` forward and ``stream_conv_grad_w`` and
    ``nitro_matmul_grad_w`` backward; ``backend="reference"`` runs their
    plain versions, ``fused=False`` / ``fuse_bwd=False`` the unfused
    compositions — all bitwise the same.

    ``fuse_opt=True`` takes ``_fused_opt_step``: the forward layers'
    IntegerSGD runs in the flush of ``stream_conv_grad_w_opt`` and
    ``nitro_matmul_grad_w_opt``, so their grad_W is never written —
    bitwise the split step.

    ``telemetry=True`` returns ``(state, metrics, telem)``, ``telem``
    being the int32 telemetry pytree of ``obs.telemetry`` (per-layer
    bit occupancy and saturation, dead units, the pre-step optimiser
    scalars).  It reads the materialised forward-layer grad_W, so it
    takes the split path even under ``fuse_opt`` (as the JAX step does):
    the kernels #3/#8 in place of #4/#9, the same trajectory bitwise.
    With ``telemetry=False`` the step launches what it did before.
    """
    with trace.active().span("step.train", fuse_opt=fuse_opt):
        if fuse_opt and not telemetry:
            return _fused_opt_step(
                state, cfg, x, labels, key, fused=fused, fuse_bwd=fuse_bwd,
                backend=backend, conv_mode=conv_mode,
            )
        grads, metrics, aux = compute_gradients(
            state, cfg, x, labels, key,
            fused=fused, fuse_bwd=fuse_bwd, backend=backend, conv_mode=conv_mode,
        )
        new_state = apply_gradients(state, grads)
        if telemetry:
            # lazy: obs is an optional read-only layer over the core
            from repro_torch.obs import telemetry as T

            telem = T.collect_train_telemetry(
                cfg, new_state.params, aux.fw_caches,
                [g["fw"] for g in grads.blocks], grads.output,
                state.opt_lr, state.opt_fw,
            )
            return new_state, metrics, telem
        return new_state, metrics


def eval_step(state: TrainState, cfg: M.NitroConfig, x,
              labels: torch.Tensor) -> torch.Tensor:
    """Correct predictions (int32) over a batch, on the unfused forward."""
    y_hat = M.frozen_forward(state.params, cfg, x)
    return _correct(y_hat, labels.to(y_hat.device))


def reduce_lr_on_plateau(state: TrainState, plateau) -> TrainState:
    """Apply the ÷3 schedule to both optimiser groups (γ_inv ×3)."""
    return state._replace(
        opt_lr=opt.step_lr_schedule(state.opt_lr, plateau),
        opt_fw=opt.step_lr_schedule(state.opt_fw, plateau),
    )
