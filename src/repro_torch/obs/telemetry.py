"""Integer-numerics telemetry for NITRO-D (port of ``repro.obs.telemetry``).

NITRO-D's claim is that training stays inside integer bounds; this module
makes those bounds observable.  Every reduction here is closed over ℤ and
is a pure readout of tensors the training step already computes, so a
telemetry-enabled ``les.train_step`` gives a **bitwise-identical**
``TrainState`` trajectory to a telemetry-off one.

Per tensor (weights, gradients, pre-activations, activations):

  * **bit-occupancy histogram** — counts of ``ceil(log2(|x|+1))``, the
    minimal magnitude bit-width of each element, buckets ``0..32``
    (bucket 32 only for INT32_MIN).  Torch has no count-leading-zeros, so
    ``bit_width`` counts the powers of two 2⁰..2³⁰ at or below the
    magnitude with one ``torch.bucketize`` (an integer binary search per
    element) — integer comparisons only, never a float log;
  * **saturation counts** vs the int8 activation bound (``|x| > 127`` ⇔
    ≥ 8 bits) and the int32 headroom watermark (≥ 31 bits ⇔ ``|x| ≥ 2³⁰``);
  * **max |x|**.

Per block also the **NITRO-ReLU dead-unit count** and the optimiser
scalars.  Every leaf is an int32 tensor on the step's device, as the JAX
package's are int32 arrays.

The histogram is one ``torch.bincount`` (the JAX package scans 33
equality counts; on the card that would be 33 launches a tensor), cast to
int32, and a tensor's whole summary takes about 15 device launches.  On
CUDA ``bincount`` reads its input's maximum on the host, so a sampled
step synchronises once per tensor; an unsampled step runs none of this.

Host side, ``to_records`` brings one step's telemetry to the host in a
single copy (every leaf concatenated, then one ``.cpu()``) and flattens it
into the JSON rows of ``metrics.jsonl``, byte for byte the JAX package's;
``append_jsonl`` streams them to the file.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import torch

from repro_torch.core.numerics import ACT_MAX, ACT_MIN, INT_DTYPE

# Buckets 0..32: bit-width of any int32 value (32 only for INT32_MIN).
NUM_BIT_BUCKETS = 33
# |x| > 127 needs ≥ 8 magnitude bits — outside the int8 activation range.
INT8_SAT_BITS = 8
# ≥ 31 bits ⇔ |x| ≥ 2³⁰: one doubling away from int32 overflow.
INT32_SAT_BITS = 31

_INFO = torch.iinfo(INT_DTYPE)


class TensorTelemetry(NamedTuple):
    """Integer summary of one tensor (all fields int32 tensors)."""

    bit_hist: torch.Tensor   # (NUM_BIT_BUCKETS,) bit-occupancy counts
    sat_int8: torch.Tensor   # scalar: # elements with |x| > 127
    sat_int32: torch.Tensor  # scalar: # elements with |x| >= 2**30
    max_abs: torch.Tensor    # scalar: max |x| (INT32_MAX if INT32_MIN present)


def _bits_of(is_min: torch.Tensor, mag: torch.Tensor) -> torch.Tensor:
    """Bit widths from an int32 magnitude: the number of powers of two
    2⁰..2³⁰ at or below ``mag`` (one integer binary search an element),
    and 32 where the value was INT32_MIN."""
    n = _INFO.bits - 1
    powers = torch.ones(n, dtype=INT_DTYPE, device=mag.device) << torch.arange(
        n, dtype=INT_DTYPE, device=mag.device)
    bits = torch.bucketize(mag, powers, out_int32=True, right=True)
    return torch.where(is_min, _INFO.bits, bits)


def _magnitude(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(v == INT32_MIN, |v|)`` with INT32_MIN's magnitude INT32_MAX
    (``abs`` of it wraps)."""
    is_min = v == _INFO.min
    return is_min, torch.where(is_min, _INFO.max, v.abs())


def bit_width(x: torch.Tensor) -> torch.Tensor:
    """Elementwise ``ceil(log2(|x|+1))`` == ``|x|.bit_length()``, in ℤ
    (INT32_MIN is 32 bits)."""
    return _bits_of(*_magnitude(x.to(INT_DTYPE)))


def _bit_histogram(bits: torch.Tensor) -> torch.Tensor:
    """``hist[k] = #{i : bits_i == k}`` for k = 0..NUM_BIT_BUCKETS-1, int32."""
    return torch.bincount(bits, minlength=NUM_BIT_BUCKETS).to(INT_DTYPE)


def bit_occupancy(x: torch.Tensor) -> torch.Tensor:
    """Bit-occupancy histogram: (NUM_BIT_BUCKETS,) int32 counts."""
    return _bit_histogram(bit_width(x).reshape(-1))


def tensor_telemetry(x: torch.Tensor) -> TensorTelemetry:
    """All integer summaries of one tensor; saturation counts fall out of
    the histogram tail (bits ≥ 8 ⇔ |x| > 127, bits ≥ 31 ⇔ |x| ≥ 2³⁰)."""
    is_min, mag = _magnitude(x.to(INT_DTYPE).reshape(-1))
    hist = _bit_histogram(_bits_of(is_min, mag))
    return TensorTelemetry(
        bit_hist=hist,
        sat_int8=hist[INT8_SAT_BITS:].sum().to(INT_DTYPE),
        sat_int32=hist[INT32_SAT_BITS:].sum().to(INT_DTYPE),
        max_abs=mag.max(),
    )


def relu_dead_count(z_star: torch.Tensor) -> torch.Tensor:
    """# pre-activations in NITRO-ReLU's saturated (zero-derivative)
    segments — the units this step's block-local gradient cannot move."""
    return ((z_star < ACT_MIN) | (z_star > ACT_MAX)).sum().to(INT_DTYPE)


def collect_train_telemetry(
    cfg, new_params: dict, fw_caches, fw_grads: list,
    out_grads: dict, opt_lr, opt_fw,
) -> dict:
    """One training step's telemetry pytree (every leaf an int32 tensor).

    Reads the *post-update* weights, the raw forward-layer weight
    gradients (before the ``γ_inv`` floor-division — the widest integers
    of the step) and the cached pre-ReLU ``z_star`` and activations.
    Called by ``les.train_step(telemetry=True)`` after the update; it
    writes nothing the step reads.
    """
    blocks = []
    for p, cache, grads in zip(new_params["blocks"], fw_caches, fw_grads):
        z_star = cache["z_star"]
        blocks.append({
            "weight": tensor_telemetry(p["fw"]["w"]),
            "grad": tensor_telemetry(grads["w"]),
            "z_star": tensor_telemetry(z_star),
            "act": tensor_telemetry(cache["act"]),
            "dead": relu_dead_count(z_star),
        })
    return {
        "blocks": blocks,
        "output": {
            "weight": tensor_telemetry(new_params["output"]["w"]),
            "grad": tensor_telemetry(out_grads["w"]),
        },
        "opt": {
            "gamma_inv_lr": opt_lr.gamma_inv,
            "eta_inv_lr": opt_lr.eta_inv,
            "gamma_inv_fw": opt_fw.gamma_inv,
            "eta_inv_fw": opt_fw.eta_inv,
        },
    }


# ---------------------------------------------------------------------------
# Host-side flattening (floats allowed from here on)
# ---------------------------------------------------------------------------


def _leaves(telem: dict) -> list[torch.Tensor]:
    """Every leaf in the order ``to_records`` reads them back."""
    out = []
    for bt in telem["blocks"]:
        for key in ("weight", "grad", "z_star", "act"):
            out.extend(bt[key])
        out.append(bt["dead"])
    for key in ("weight", "grad"):
        out.extend(telem["output"][key])
    out.extend(telem["opt"].values())
    out.extend(telem.get("dp", {}).values())
    return out


def _host_ints(telem: dict):
    """An iterator over every leaf's values as Python ints, from one
    device-to-host copy."""
    flat = torch.cat([t.reshape(-1).to(INT_DTYPE) for t in _leaves(telem)])
    return iter(flat.cpu().tolist())


def _tensor_record(vals) -> dict:
    hist = [next(vals) for _ in range(NUM_BIT_BUCKETS)]
    sat_int8, sat_int32, max_abs = next(vals), next(vals), next(vals)
    total = sum(hist)
    occupied = [b for b, c in enumerate(hist) if c]
    return {
        "bit_hist": hist,
        "total": total,
        "msb": occupied[-1] if occupied else 0,
        "max_abs": max_abs,
        "sat_int8": sat_int8,
        "sat_int32": sat_int32,
        "sat_int8_frac": sat_int8 / total if total else 0.0,
        "sat_int32_frac": sat_int32 / total if total else 0.0,
    }


def to_records(telem: dict, *, cfg, step: int) -> list[dict]:
    """Flatten one step's telemetry pytree into JSON-ready row dicts.

    One row per block (weights/grads/pre-activations/activations + dead
    fraction + the static ``alpha_inv``), one for the output layers and
    one ``_opt`` row with the optimiser scalars, as the JAX package's;
    data-parallel steps (``parallel.dp``) add a ``_dp`` row (the shard
    count and the 2-limb fit of the shard-local gradients).
    """
    vals = _host_ints(telem)
    records = []
    for i, spec in enumerate(cfg.blocks):
        tensors = {key: _tensor_record(vals)
                   for key in ("weight", "grad", "z_star", "act")}
        dead = next(vals)
        z = tensors["z_star"]
        records.append({
            "step": int(step),
            "layer": f"block{i}",
            "kind": spec.kind,
            "alpha_inv": int(spec.alpha_inv),
            **tensors,
            "dead": dead,
            "dead_frac": dead / z["total"] if z["total"] else 0.0,
        })
    records.append({
        "step": int(step),
        "layer": "output",
        "kind": "linear",
        "weight": _tensor_record(vals),
        "grad": _tensor_record(vals),
    })
    records.append({
        "step": int(step),
        "layer": "_opt",
        **{k: next(vals) for k in telem["opt"]},
    })
    if "dp" in telem:
        records.append({
            "step": int(step),
            "layer": "_dp",
            **{k: next(vals) for k in telem["dp"]},
        })
    return records


def append_jsonl(path: str, records: list[dict]) -> None:
    """Append one JSON line per record (the ``metrics.jsonl`` format),
    creating the parent directory if needed (the default path sits next
    to checkpoints that may not exist yet at the first sampled step)."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "a") as f:
        for rec in records:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
