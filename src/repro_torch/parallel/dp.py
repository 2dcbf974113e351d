"""Data-parallel NITRO-D training, bitwise the single-device step at any
rank count (port of ``repro.parallel.dp``).

NITRO-D's gradients are batch sums of int32 contributions and int32
addition is associative, so splitting the batch over ranks, reducing the
ranks' gradients with any exact integer all-reduce and applying
IntegerSGD once reproduces the single-device ``les.train_step`` bit for
bit.  The JAX package runs the step inside a ``shard_map`` over a
``data`` mesh axis; the port is SPMD over processes, one rank each, on
``torch.distributed``: every rank holds the whole state, builds the same
global batch, keeps its rows (the ``"batch"`` rule of
``sharding.train_rules``: dim 0 over ``data``) and runs ``dp_train_step``.

Three interchangeable reducers (``dp_reduce=``), all the exact int32 sum:

  * ``"psum"``     — the backend's all-reduce (``compress.exact_integer_psum``)
  * ``"ring"``     — ``collectives.ring_all_reduce`` over point-to-point sends
  * ``"compress"`` — ``compress.nitro_compressed_psum``: four int32 limb
                     planes on the wire (4× psum's bytes, as in JAX)

``reduce_gradients`` concatenates the step's gradients into one int32
buffer and reduces it with one collective (integers: the result is the
same as one collective a tensor).  The only sampled operation of the
step, IntegerDropout, draws the global-batch mask from the shared key and
keeps this rank's rows (``core.layers.dropout_forward``).

``spawn`` starts the ranks: ``torch.multiprocessing`` with the ``spawn``
start method, meeting on 127.0.0.1 at a free port.  Rank r runs on
``cuda:(r mod device_count)`` or on the CPU; the backend is NCCL when
every rank has a card of its own and gloo when ranks share a card or run
on the CPU (NCCL refuses two ranks on one card).  Under gloo the ring
stages CUDA tensors through the host (gloo's sends take host tensors
only; its all-reduce takes CUDA tensors, ``collectives``).
"""

from __future__ import annotations

import pickle
import queue
import socket
import traceback
from datetime import timedelta
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core import les
from repro_torch.core.numerics import INT_DTYPE
from repro_torch.device import resolve_device
from repro_torch.obs import trace
from repro_torch.parallel import collectives, compress, sharding, tree

DP_AXIS = "data"

#: Valid ``dp_reduce=`` values, in (default-first) order.
REDUCERS = ("psum", "ring", "compress")


class DataAxis(NamedTuple):
    """This process's place on the ``data`` axis: the JAX package's mesh
    axis name, the process group (``None``: the default group), this
    rank, the number of ranks, and the backend (``None`` without a
    group)."""

    name: str
    group: Any
    rank: int
    size: int
    backend: str | None


def data_mesh(num_devices: int | None = None) -> DataAxis:
    """The ``data`` axis over the ranks of the default process group
    (one rank, the process itself, when no group is initialised).

    Raises with the launch recipe when the group has another number of
    ranks than asked: ranks are processes, started before this call.
    """
    if dist.is_available() and dist.is_initialized():
        world, rank, backend = dist.get_world_size(), dist.get_rank(), dist.get_backend()
    else:
        world, rank, backend = 1, 0, None
    n = world if num_devices is None else num_devices
    if n != world:
        raise ValueError(
            f"data_mesh: asked for {n} ranks but this process group has {world}. "
            f"Start {n} ranks first: python -m repro_torch.launch.train "
            f"--num-devices {n}, or parallel.dp.spawn(fn, {n}), each rank calling "
            f"data_mesh({n}).")
    return DataAxis(DP_AXIS, None, rank, n, backend)


def shard_batch(x: torch.Tensor, axis: DataAxis) -> torch.Tensor:
    """This rank's rows of a global batch, by the ``"batch"`` rule of
    ``sharding.train_rules`` (dim 0 over ``data``): rows
    ``[rank·B/N, (rank+1)·B/N)``."""
    with sharding.use_rules(axis, sharding.train_rules()):
        (batch_axes,) = sharding.resolve(("batch",))
    if axis.name not in batch_axes:  # the rules do not split the batch here
        return x
    n = axis.size
    if x.shape[0] % n:
        raise ValueError(
            f"dp_train_step: batch {x.shape[0]} not divisible by the "
            f"{axis.name} axis ({n} ranks)")
    b = x.shape[0] // n
    return x[axis.rank * b:(axis.rank + 1) * b]


def _check_reducer(method: str) -> None:
    if method not in REDUCERS:
        raise ValueError(
            f"unknown dp_reduce method {method!r}; expected one of {REDUCERS}")


def reduce_gradients(grads, axis: DataAxis, method: str = "psum"):
    """All-reduce an integer gradient tree over ``axis``.

    Every method computes the exact int32 sum over ranks; they differ
    only in schedule and wire format, never in the result.  The leaves go
    into one int32 buffer and one collective.
    """
    _check_reducer(method)
    with trace.active().span("parallel.reduce_gradients", method=method):
        parts = tree.leaves(grads)
        flat = torch.cat([g.reshape(-1) for g in parts])
        if method == "psum":
            flat = compress.exact_integer_psum(flat, axis)
        elif method == "ring":
            flat = collectives.ring_all_reduce(flat, axis)
        else:
            flat = compress.nitro_compressed_psum(flat, axis)
        chunks = torch.split(flat, [g.numel() for g in parts])
        return tree.unflatten(grads, [c.view(g.shape) for c, g in zip(chunks, parts)])


def _reduce_metrics(metrics: les.StepMetrics, axis: DataAxis) -> les.StepMetrics:
    """Sum the step's int32 metrics over the ranks, in one collective."""
    with trace.active().span("parallel.reduce_metrics"):
        flat = collectives.all_reduce(torch.cat([m.reshape(-1) for m in metrics]), axis)
        loss, correct, local = torch.split(flat, [1, 1, metrics.local_losses.numel()])
    return les.StepMetrics(loss=loss.reshape(()), correct=correct.reshape(()),
                           local_losses=local)


def _grads_fit_int16(grads, axis: DataAxis) -> torch.Tensor:
    """1 iff every rank-local gradient element fits 2 int8 limbs (int16).

    The exactness precondition of ``dp_reduce="compress"`` at
    ``num_limbs=2``, read on the pre-reduce gradients (what would go on
    the wire) and all-reduced with MIN so every rank holds the verdict.
    """
    local = torch.stack([compress.fits_limbs(g, 2).to(INT_DTYPE)
                         for g in tree.leaves(grads)]).min()
    return collectives.all_reduce(local, axis, "min")


def _dp_telemetry(cfg, new_state, aux, grads, state, axis: DataAxis) -> dict:
    """Telemetry under data parallelism, bitwise the single-device readout.

    Weights, reduced gradients and optimiser scalars are replicated, so
    their summaries are already global.  ``z_star``/``act`` hold this
    rank's rows only: their histograms, saturation and dead counts sum
    over the ranks and ``max_abs`` takes the max — the single-device
    reductions, reassociated (one SUM and one MAX collective).
    """
    from repro_torch.obs import telemetry as T

    telem = T.collect_train_telemetry(
        cfg, new_state.params, aux.fw_caches,
        [g["fw"] for g in grads.blocks], grads.output,
        state.opt_lr, state.opt_fw,
    )
    sums, maxes = [], []
    for bt in telem["blocks"]:
        for k in ("z_star", "act"):
            tt = bt[k]
            sums += [tt.bit_hist, tt.sat_int8.reshape(1), tt.sat_int32.reshape(1)]
            maxes.append(tt.max_abs.reshape(1))
        sums.append(bt["dead"].reshape(1))
    summed = collectives.all_reduce(torch.cat(sums), axis, "sum")
    maxed = collectives.all_reduce(torch.cat(maxes), axis, "max")
    s_it = iter(torch.split(summed, [t.numel() for t in sums]))
    m_it = iter(maxed)
    for bt in telem["blocks"]:
        for k in ("z_star", "act"):
            bt[k] = type(bt[k])(bit_hist=next(s_it), sat_int8=next(s_it).reshape(()),
                                sat_int32=next(s_it).reshape(()), max_abs=next(m_it))
        bt["dead"] = next(s_it).reshape(())
    return telem


def dp_train_step(
    state: les.TrainState,
    cfg,
    x_local: torch.Tensor,
    labels_local: torch.Tensor,
    key: torch.Tensor,
    *,
    axis: DataAxis,
    dp_reduce: str = "psum",
    fused: bool = True,
    fuse_bwd: bool = True,
    fuse_opt: bool = False,
    backend: str = "auto",
    conv_mode: str = "stream",
    telemetry: bool = False,
):
    """One data-parallel NITRO-D step on this rank's rows of the batch.

    Same returns as ``les.train_step``.  The rank computes its gradients
    (dropout on the global-batch mask), the int32 gradients and metrics
    all-reduce exactly, and every rank applies the same IntegerSGD update,
    so every rank's new state is the single-device step's on the whole
    batch, bit for bit.

    ``fuse_opt=True`` applies the update with the fused IntegerSGD kernel
    (``les.apply_gradients(fuse_opt=True)``: one ``integer_sgd_update``
    launch for the step's tensors); the grad_W kernels' flush epilogue
    cannot serve here because the all-reduce needs the materialised
    gradient.  ``telemetry=True`` returns ``(state, metrics, telem)`` with
    ``telem["dp"]`` = the shard count and the pre-reduce ``grad_fits_int16``.
    """
    _check_reducer(dp_reduce)
    n = axis.size
    with trace.active().span("step.train", fuse_opt=fuse_opt):
        grads, metrics, aux = les.compute_gradients(
            state, cfg, x_local, labels_local, key,
            fused=fused, fuse_bwd=fuse_bwd, backend=backend, conv_mode=conv_mode,
            dp_axis=axis, dp_shards=n,
        )
        if telemetry:
            # pre-reduce: the rank-local widths are what go on the wire
            fits16 = _grads_fit_int16(grads, axis)
        grads = reduce_gradients(grads, axis, dp_reduce)
        metrics = _reduce_metrics(metrics, axis)
        new_state = les.apply_gradients(state, grads, fuse_opt=fuse_opt, backend=backend)
    if telemetry:
        telem = _dp_telemetry(cfg, new_state, aux, grads, state, axis)
        # topology-scoped: the `_dp` row, not part of the trajectory
        telem["dp"] = {
            "grad_fits_int16": fits16,
            "shards": torch.tensor(n, dtype=INT_DTYPE, device=fits16.device),
        }
        return new_state, metrics, telem
    return new_state, metrics


def make_dp_train_step(cfg, axis: DataAxis, *, dp_reduce: str = "psum",
                       fused: bool = True, fuse_bwd: bool = True,
                       fuse_opt: bool = False, backend: str = "auto",
                       conv_mode: str = "stream", telemetry: bool = False):
    """``step(state, x, labels, key)`` on the **global** batch: this rank's
    rows (``shard_batch``) through ``dp_train_step`` — the DP analogue of
    ``partial(les.train_step, cfg=cfg)``."""
    _check_reducer(dp_reduce)

    def step(state, x, labels, key):
        return dp_train_step(
            state, cfg, shard_batch(x, axis), shard_batch(labels, axis), key,
            axis=axis, dp_reduce=dp_reduce, fused=fused, fuse_bwd=fuse_bwd,
            fuse_opt=fuse_opt, backend=backend, conv_mode=conv_mode,
            telemetry=telemetry,
        )

    return step


# ---------------------------------------------------------------------------
# Starting the ranks
# ---------------------------------------------------------------------------


def rank_devices(num_devices: int, device="cuda", *,
                 cards: int | None = None) -> tuple[str, list[torch.device]]:
    """(backend, each rank's device): rank r on ``cuda:(r mod count)``
    over the first ``cards`` cards (default: every card), with NCCL when
    every rank has a card of its own and gloo when ranks share a card or
    run on the CPU."""
    dev = resolve_device(device)
    if num_devices < 1:
        raise ValueError(f"num_devices must be >= 1, got {num_devices}")
    if dev.type == "cpu":
        return "gloo", [torch.device("cpu")] * num_devices
    count = torch.cuda.device_count() if cards is None else cards
    devices = [torch.device("cuda", r % count) for r in range(num_devices)]
    return ("nccl" if count >= num_devices else "gloo"), devices


def describe(backend: str, devices: list[torch.device]) -> str:
    """``backend gloo, rank→device 0→cuda:0 1→cuda:0``."""
    return f"backend {backend}, rank→device " + " ".join(
        f"{r}→{d}" for r, d in enumerate(devices))


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, n: int, backend: str, device: str, port: int,
               args: tuple, results) -> None:
    """One rank: join the group, run ``fn(axis, device, *args)``, report
    its pickled return value (or the traceback) on ``results``."""
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:  # n ranks share the host's cores
            torch.set_num_threads(max(1, torch.get_num_threads() // n))
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=n, rank=rank, timeout=timedelta(minutes=10))
        try:
            out = fn(data_mesh(n), dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn, num_devices: int, *, device="cuda", cards: int | None = None,
          args: tuple = ()) -> list:
    """Run ``fn(axis, device, *args)`` on ``num_devices`` ranks placed by
    ``rank_devices`` (``cards``: over how many cards); returns each rank's
    return value, in rank order.

    ``fn`` must be importable by name (the ranks are spawned, not forked)
    and return something picklable, tensors on the host.  The CUDA kernel
    libraries are built here, once, before the ranks start.  A rank that
    raises or dies fails the call with its traceback, and the other ranks
    are terminated.
    """
    backend, devices = rank_devices(num_devices, device, cards=cards)
    if devices[0].type == "cuda":
        from repro_torch.kernels import cuda_lib
        cuda_lib.build_all()
    port = _free_port()
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, num_devices, backend,
                                                  str(devices[r]), port, args, results))
             for r in range(num_devices)]
    for p in procs:
        p.start()
    out: dict[int, Any] = {}
    try:
        while len(out) < num_devices:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                for r, p in enumerate(procs):
                    if r not in out and p.exitcode not in (None, 0):
                        raise RuntimeError(
                            f"rank {r} of {num_devices} died (exit code {p.exitcode})")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {num_devices} failed:\n{payload}")
            out[rank] = pickle.loads(payload)
    finally:
        for p in procs:
            if len(out) < num_devices and p.is_alive():
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(num_devices)]
