"""Multi-pod dry run (port of ``repro.launch.dryrun``).

For every (architecture × input-shape × mesh) cell, on the ``meta``
device (shapes and dtypes, nothing allocated, nothing launched: the
counterpart of JAX's 512 fake host devices, which needs no card):

    state / params, batch, cache = abstract inputs (launch/shapes.py)
    with OpAnalyzer() as an:       # launch/op_analysis.py
        step(state, batch)         # the port's own eager step, traced once

then each chip's share from the placements (``parallel.sharding``) on the
logical mesh (``launch/mesh.py``).  Results are written as one JSON per
cell.  Per chip:

  * memory: the state (params + AdamW moments) or serving params, the
    batch and the cache are exact, from ``local_shape`` of their
    placements; of the trace's live storages over time, those that hold
    the step's gradients (``core.cost_hook.gradients``) or its outputs (new
    weights and moments, the cache, the logits) are scaled the same way,
    by storage and not by shape, and every other one (activations,
    temporaries) is divided by the batch and sequence shards;
    ``fits_hbm`` holds the peak against the card's memory;
  * compute and HBM bytes: the trace's global counts divided evenly over
    the chips (an assumption: every chip runs the same shard of the work);
  * collectives: analytic, from the placements (``"collectives":
    "analytic"``): a train step all-gathers each parameter leaf sharded
    over the batch's axes and reduce-scatters its gradient (gathered −
    local bytes each), all-reduces the gradient of a leaf replicated over
    them; each layer whose weights shard over ``model`` all-reduces its
    local activation twice in the forward (and twice more in a train
    step's backward), at 2× ring wire cost; each on NVLink inside a node
    of 8 cards, on the inter-node link across nodes.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k \\
        [--multi-pod] [--causal-mode triangle] [--out results/...json]
    python -m repro_torch.launch.dryrun --sweep [--multi-pod] \\
        --out-dir results/dryrun_torch
"""

from __future__ import annotations

import argparse
import dataclasses
from collections import defaultdict
import json
import math
import os
import subprocess
import sys
import time
import traceback

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.core import prng
from repro_torch.device import dry_run
from repro_torch.launch import shapes as S
from repro_torch.launch.mesh import group_link, make_production_mesh, mesh_num_chips
from repro_torch.launch.op_analysis import HBM_PER_CHIP, PEAK_BF16, OpAnalyzer, roofline_terms
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as shr
from repro_torch.parallel.sharding import NamedSharding, entry_axes, serve_rules, train_rules
from repro_torch.parallel.tree import leaves, tree_map
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer

GIB = 2 ** 30


def make_rules(cfg, *, mode: str, multi_pod: bool, batch: int) -> dict:
    base = train_rules(multi_pod) if mode == "train" else serve_rules(multi_pod)
    if cfg.dp_only and mode == "train":
        base["batch"] = ("pod", "data") if multi_pod else ("data", "model")
        base["p_fsdp"] = ("data", "model")
        base["seq_sp"] = None      # model axis is consumed by the batch
        base["expert_cap"] = None
    rules = trainer.resolved_rules(cfg, base)
    if batch == 1:
        rules["batch"] = None  # long_500k: single request, nothing to shard
    return rules


def serving_params(cfg):
    """Meta params for serving cells: float32 master weights cast to bf16
    at serving load (JAX's convention: halves weight HBM)."""
    with dry_run():
        p = T.init_params(prng.PRNGKey(0), cfg, device="meta")
    return tree_map(lambda t: torch.empty_like(t, dtype=torch.bfloat16)
                    if t.dtype == torch.float32 else t, p)


def _shards(mesh, entry) -> int:
    return math.prod(mesh.axis_size(a) for a in entry_axes(entry) if a in mesh.axis_names)


def _local_bytes(t: torch.Tensor, sharding) -> int:
    return math.prod(sharding.shard_shape(t.shape)) * t.element_size()


def _pairs(tree, shardings):
    """(leaf, its NamedSharding) over a tree and its placement tree."""
    if isinstance(shardings, NamedSharding):
        return [(t, shardings) for t in leaves(tree)]
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _pairs(tree[k], shardings[k])]
    return [p for t, s in zip(tree, shardings) for p in _pairs(t, s)]


@dataclasses.dataclass
class StepTrace:
    """One traced step: its costs and memory timeline, each input leaf and
    each parameter leaf beside its placement."""

    analyzer: OpAnalyzer
    inputs: list           # (tensor, NamedSharding) of every input leaf
    params: list           # (tensor, NamedSharding) of the parameter leaves
    scales: dict           # timeline id → local / global, for placed storages
    act_scale: float       # 1 / (batch shards × sequence shards)
    trace_s: float

    @property
    def costs(self):
        return self.analyzer.costs

    def input_bytes(self) -> float:
        """One chip's share of the inputs."""
        return float(sum(_local_bytes(t, s) for t, s in self.inputs))

    def peak_bytes(self) -> float:
        """One chip's peak: its inputs plus the trace's scaled live peak."""
        scales, act = self.scales, self.act_scale
        return self.input_bytes() + self.analyzer.peak(scale=lambda sid: scales.get(sid, act))


def _scales(an: OpAnalyzer, placed, act: float) -> dict:
    """Timeline id → one chip's share of each storage that holds placed
    leaves.  ``placed``: (timeline id or None, the leaf's global bytes, its
    local bytes).  What of a storage no leaf covers counts as an
    activation; leaves that share their bytes (an output written over a
    gradient) count once."""
    held = defaultdict(lambda: [0, 0])
    for sid, whole, local in placed:
        if sid is not None:
            held[sid][0] += whole
            held[sid][1] += local
    out = {}
    for sid, (whole, local) in held.items():
        nb = an.size(sid)
        out[sid] = (local * min(1.0, nb / whole) + max(nb - whole, 0) * act) / nb \
            if nb and whole else act
    return out


def _placed(an: OpAnalyzer, pairs) -> list:
    """``_scales``' entries for (live tensor, NamedSharding) pairs."""
    return [(an.sid_of(t), t.numel() * t.element_size(), _local_bytes(t, s)) for t, s in pairs]


def _shardings(tree) -> list:
    """The ``NamedSharding`` leaves of a placement tree."""
    if isinstance(tree, NamedSharding):
        return [tree]
    values = tree.values() if isinstance(tree, dict) else tree
    return [s for v in values for s in _shardings(v)]


def trace_step(cfg, kind: str, batch: int, seq: int, mesh, rules: dict, *,
               causal_mode: str = "masked", params=None) -> StepTrace:
    """Trace one ``kind`` step ("train", "prefill" or "decode") of ``cfg``
    at ``batch`` × ``seq`` (for decode, the cache's length) on ``meta``,
    with the placements ``rules`` give on ``mesh``.  Serving steps take
    ``params`` (default: ``serving_params(cfg)``)."""
    rep = shr.NamedSharding(mesh, ())
    p_shard = trainer.param_shardings(cfg, mesh, rules)
    act = 1.0 / (_shards(mesh, rules.get("batch")) *
                 (_shards(mesh, rules.get("seq_sp")) if kind == "train" else 1))
    t0 = time.monotonic()
    with dry_run():
        if kind == "train":
            state = trainer.abstract_state(prng.PRNGKey(0), cfg)
            specs = S.train_batch_specs(cfg, batch, seq)
            shapes = {k: tuple(v.shape) for k, v in specs.items()}
            s_shard = (p_shard, opt.AdamWState(mu=p_shard, nu=p_shard, count=rep), rep)
            inputs = _pairs(state, s_shard) + _pairs(
                specs, trainer.batch_spec(cfg, mesh, rules, shapes=shapes))
            p_pairs = _pairs(state[0], p_shard)
            fn = trainer.build_train_step(cfg, causal_mode=causal_mode)
            with OpAnalyzer() as an:
                out = fn(state, specs)[0]
            placed = _placed(an, _pairs(out, s_shard)) + [
                (sid, t.numel() * t.element_size(), _local_bytes(t, s))
                for sid, (t, s) in zip(an.gradients, p_pairs)]
        else:
            params = serving_params(cfg) if params is None else params
            cache = S.abstract_cache(cfg, batch, seq)
            if kind == "prefill":
                specs = S.prefill_batch_specs(cfg, batch, seq)
                fn = trainer.build_prefill(cfg, mesh, rules,
                                           shapes={k: tuple(v.shape) for k, v in specs.items()})
                args = (params, specs, cache)
            else:
                enc = S.enc_out_specs(cfg, batch)
                fn = trainer.build_decode_step(cfg, mesh, rules, has_enc=enc is not None)
                args = (params, S.decode_token_specs(batch), cache) + \
                    ((enc,) if enc is not None else ())
            inputs = [p for a, s in zip(args, fn.in_shardings) for p in _pairs(a, s)]
            p_pairs = _pairs(params, p_shard)
            with OpAnalyzer() as an:
                out = fn(*args)
            placed = _placed(an, [p for o, s in zip(out, fn.out_shardings)
                                  for p in _pairs(o, s)])
    del out
    trace = StepTrace(an, inputs, p_pairs, _scales(an, placed, act), act,
                      time.monotonic() - t0)
    _collectives(trace, cfg, kind, batch, seq, mesh, rules)
    return trace


def _collectives(trace: StepTrace, cfg, kind: str, batch: int, seq: int, mesh,
                 rules: dict) -> None:
    """The analytic collective terms (module docstring), per chip."""
    an = trace.analyzer
    b_axes = tuple(a for a in entry_axes(rules.get("batch")) if a in mesh.axis_names)
    if kind == "train":
        for t, s in trace.params:
            spec_axes = {a for e in s.spec for a in entry_axes(e)}
            fsdp = tuple(a for a in b_axes if a in spec_axes)
            rest = tuple(a for a in b_axes if a not in spec_axes)
            local = _local_bytes(t, s)
            if fsdp:
                wire = local * (_shards(mesh, fsdp) - 1)
                an.add_collective("all-gather", wire, group_link(mesh, fsdp))
                an.add_collective("reduce-scatter", wire, group_link(mesh, fsdp))
            if rest:
                an.add_collective("all-reduce", 2.0 * local, group_link(mesh, rest))
    if "model" not in mesh.axis_names:
        return
    rows = batch // _shards(mesh, b_axes)
    width = cfg.d_model * torch.empty((), dtype=cfg.dtype).element_size()
    per_layer = 4 if kind == "train" else 2
    layers = [(k, seq if kind != "decode" else 1)
              for k in list(cfg.scan_unit) * cfg.scan_repeats + list(cfg.tail)]
    if cfg.encoder_layers and kind != "decode":
        layers += [("enc_attn", cfg.encoder_seq)] * cfg.encoder_layers
    for k, tokens in layers:
        specs = _shardings(shr.tree_shardings(mesh, rules, T.layer_logical_axes(cfg, k)))
        if any("model" in entry_axes(e) for s in specs for e in s.spec):
            an.add_collective("all-reduce", per_layer * 2.0 * rows * tokens * width,
                              group_link(mesh, "model"), count=per_layer)


def trace_cell(arch: str, shape_name: str, *, multi_pod: bool,
               causal_mode: str = "masked", cfg_overrides: dict | None = None,
               rule_patch: dict | None = None):
    """Build + trace one cell (JAX's ``lower_cell``); returns (StepTrace,
    info dict), or (None, info) for a cell that does not apply.

    ``cfg_overrides``: dataclass field replacements (int8_matmul /
    les_groups / remat …).  ``rule_patch``: logical-axis rule replacements
    applied after the arch's own overrides.
    """
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    cell = S.cell(cfg, shape_name)
    if not cell.applicable:
        return None, {"arch": arch, "shape": shape_name, "skipped": True,
                      "reason": cell.skip_reason}
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = make_rules(cfg, mode="train" if cell.kind == "train" else "serve",
                       multi_pod=multi_pod, batch=cell.batch)
    if rule_patch:
        rules.update(rule_patch)
    trace = trace_step(cfg, cell.kind, cell.batch, cell.seq, mesh, rules,
                       causal_mode=causal_mode)
    info = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "kind": cell.kind, "seq": cell.seq, "batch": cell.batch,
        "chips": mesh_num_chips(mesh), "mesh": dict(zip(mesh.axis_names, mesh.shape)),
        "causal_mode": causal_mode, "trace_s": round(trace.trace_s, 1),
        "skipped": False,
    }
    return trace, info


def analyze_cell(trace: StepTrace, info: dict) -> dict:
    """Per-chip memory, the op counts and the roofline terms of a cell."""
    cfg, chips = get_config(info["arch"]), info["chips"]
    costs = trace.costs
    peak = trace.peak_bytes()
    inputs = trace.input_bytes()
    memory = {
        "inputs_gib": inputs / GIB,
        "params_gib": sum(_local_bytes(t, s) for t, s in trace.params) / GIB,
        "trace_peak_gib": (peak - inputs) / GIB,
        "live_gib": peak / GIB,
        "hbm_gib": HBM_PER_CHIP / GIB,
        "fits_hbm": bool(peak < HBM_PER_CHIP),
        "note": "inputs (state or params, batch, cache) exact from their placements; "
                "of the trace's live storages, the gradients and the step's outputs "
                "scaled by their placements, every other one divided by the batch and "
                "sequence shards",
    }
    terms = roofline_terms(costs, chips)
    n_active = cfg.active_param_count()
    tokens = info["batch"] * (info["seq"] if info["kind"] != "decode" else 1)
    model_flops = (6 if info["kind"] == "train" else 2) * n_active * tokens
    counted = costs.total_flops
    terms["model_flops"] = model_flops
    terms["model_over_counted_flops"] = model_flops / counted if counted else 0.0
    terms["roofline_bound_s"] = max(terms["compute_s"], terms["memory_s"],
                                    terms["collective_s"])
    useful_s = model_flops / chips / PEAK_BF16
    terms["roofline_fraction"] = (useful_s / terms["roofline_bound_s"]
                                  if terms["roofline_bound_s"] else 0.0)
    return {**info, "memory": memory, "roofline": terms,
            "ops": costs.ops, "transfers": costs.transfers,
            "assumptions": "FLOPs and HBM bytes are the step's global counts divided "
                           "evenly over the chips; collectives analytic from the "
                           "placements; rates of one H100 SXM5 at 700 W"}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             causal_mode: str = "masked", out: str | None = None,
             cfg_overrides: dict | None = None, rule_patch: dict | None = None) -> dict:
    trace, info = trace_cell(arch, shape_name, multi_pod=multi_pod, causal_mode=causal_mode,
                             cfg_overrides=cfg_overrides, rule_patch=rule_patch)
    if cfg_overrides:
        info["cfg_overrides"] = {k: str(v) for k, v in cfg_overrides.items()}
    if rule_patch:
        info["rule_patch"] = {k: str(v) for k, v in rule_patch.items()}
    result = info if trace is None else analyze_cell(trace, info)
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result, indent=1, default=str))
    return result


def sweep(out_dir: str, *, multi_pod: bool, archs=None, shapes=None,
          causal_mode: str = "masked", timeout: int = 3600):
    """Subprocess-per-cell sweep (isolation: one crash ≠ dead sweep)."""
    archs = archs or list_archs()
    shapes = shapes or list(S.SHAPES)
    results = []
    for arch in archs:
        for shape_name in shapes:
            tag = f"{arch}_{shape_name}_{'pod2' if multi_pod else 'pod1'}"
            out = os.path.join(out_dir, tag + ".json")
            if os.path.exists(out):
                print(f"[skip] {tag} (exists)")
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                   "--shape", shape_name, "--out", out, "--causal-mode", causal_mode]
            if multi_pod:
                cmd.append("--multi-pod")
            print(f"[run ] {tag}")
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
                if proc.returncode != 0:
                    print(f"[FAIL] {tag}:\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
                    results.append({"cell": tag, "ok": False})
                else:
                    results.append({"cell": tag, "ok": True})
            except subprocess.TimeoutExpired:
                print(f"[TIME] {tag}")
                results.append({"cell": tag, "ok": False, "timeout": True})
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--causal-mode", default="masked", choices=["masked", "triangle"])
    ap.add_argument("--out")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out-dir", default="results/dryrun_torch")
    ap.add_argument("--int8", action="store_true", help="NITRO int8 numerics on LM matmuls")
    ap.add_argument("--les-groups", type=int, default=0)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--cast-once", action="store_true",
                    help="cast fp32 params to bf16 once per step")
    ap.add_argument("--moe-shard", action="store_true",
                    help="not in the port: eager torch places no dispatch buffers")
    ap.add_argument("--rule", action="append", default=[],
                    help="logical=mesh rule patch, e.g. --rule mlp=None")
    args = ap.parse_args()

    if args.sweep:
        sweep(args.out_dir, multi_pod=args.multi_pod, causal_mode=args.causal_mode)
        return
    overrides = {}
    if args.int8:
        overrides["int8_matmul"] = True
    if args.les_groups:
        overrides["les_groups"] = args.les_groups
    if args.no_remat:
        overrides["remat"] = False
    if args.cast_once:
        overrides["cast_params_once"] = True
    if args.moe_shard:
        ap.error("--moe-shard: eager torch places no MoE dispatch buffers (JAX pins them "
                 "with a sharding constraint), so the trace would not change")
    patch = {}
    for r in args.rule:
        k, v = r.split("=", 1)
        patch[k] = None if v == "None" else tuple(v.split(",")) if "," in v else v
    try:
        run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                 causal_mode=args.causal_mode, out=args.out,
                 cfg_overrides=overrides or None, rule_patch=patch or None)
    except Exception:
        traceback.print_exc()
        sys.exit(1)


if __name__ == "__main__":
    main()
