#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # from the root of a checkout, one CUDA card

Phases, each fatal on failure:
  1. device and toolchain (nvidia-smi name/power limit, nvcc, torch, triton);
  2. build every CUDA kernel library from the checkout's sources, one nvcc
     each, in parallel, timed;
  3. hold each kernel against its plain PyTorch version on the card,
     bitwise (tolerance 0: every value is an integer): the serving kernels
     at every VGG8B step shape at batch 32, the training and update
     kernels at every VGG8B training shape at batch 64 (the update kernels
     at several optimiser states), the input-gradient kernels at every
     VGG8B training shape and mlp4's linear shapes (3d), and all at ragged
     shapes; the conv grad_W kernels (int8 tensor cores over exact digits)
     also on every digit path at every VGG8B conv shape and the ragged
     ones — δ needing one and two digits, full-range int32 x and δ with
     INT32_MIN/MAX — with and without z*, the update twice per case with
     its workspace and arrival counters left zero and
     nitro_matmul_grad_w_opt, which shares them, bitwise after; the
     forward conv kernels (int8 tensor cores over exact digits of x and w)
     on every digit path — x and w each of one to four digits, 16 variants,
     INT32_MIN/MAX planted at four — at every VGG8B serving (#6) and
     training (#7) conv shape and the ragged ones, and #7 on int8 x and w;
  3d. the input-gradient kernels (int8 tensor cores over exact digits of
     the masked δ and of w) at every VGG8B training shape, mlp4's linear
     shapes and ragged ones (C = 3, F % 16 != 0, odd batches), at α_inv 10
     and on full-range int32 operands at α_inv 1, and on every digit path
     — masked δ and w of one to four digits, 16 variants — each call
     twice, the arrival counters left zero; #6 at sf=1 (the route without
     z*) at every VGG8B conv;
  3c. the update kernels under each optimiser state of ``opt_states``: #4
     and #9 at every VGG8B training shape and ragged ones (#9 on every
     digit path, twice each); #11 on each VGG8B weight tensor alone and on
     whole trees in one call — VGG8B's 15 tensors under the forward and
     the learning layers' states (one launch), mlp4's 7 (one launch), 150
     ragged tensors (three launches: 64 a table), aligned tensors beside
     ``base[1:]`` views, all on full-range int32 W and g;
  3e. each forward conv and matmul kernel, each linear grad_W kernel and
     each input-gradient kernel called once per main-path shape, and the
     VGG8B fused apply (#11, one launch), under
     ``torch.cuda.set_sync_debug_mode("error")`` (no host sync in its
     wrapper: the digit counts are decided on the card, γ_inv and η_inv
     read there), then held against its plain version;
  3f. the matmul kernels (split-K over exact digits on the int8 tensor
     cores) on every digit path — x and w of one to four digits, 16
     variants — at every main-path shape (the served linear and output
     layer, VGG8B's training linear, mlp4's layers) and ragged ones (M of 1
     to 1,000, K deep enough for three splits), each case twice; #1 also on
     int8 operands, aligned and not; #2 on w with one 64×64 tile of four
     digits; the arrival counters must be left zero;
  3g. the linear grad_W kernels (a shallow GEMM over exact digits on the
     int8 tensor cores) on every digit path — x and masked δ of one to four
     digits, 16 variants — at every main-path shape (VGG8B's linear, mlp4's
     layers) and ragged ones (batches of 1, 3 and 16,385; M and N off the
     tile), each case twice, nitro_matmul_grad_w_opt under two optimiser
     states;
  4. the serving path: ``repro_torch.launch.serve_vision.main`` serves
     full-width VGG8B (seeded init → freeze → compile_plan → VisionEngine,
     ``--scheduler static``) with the launch counts reset just before and
     read just after; every request's logits must equal the
     ``backend='reference'`` plan's, and each batch must launch
     stream_conv 6× and nitro_matmul 2×;
  4b. the fleet path: two full-width VGG8B arms (``PRNGKey(0)``, ``(1)``)
     through ``save_frozen`` and a 90/10 ``FLEET.json``, 256 requests
     through ``serve_vision.main --fleet-dir`` (the continuous
     ``FleetEngine``, the default scheduler) with a 50 ms SLO, counted
     (stream_conv 6× and nitro_matmul 2× per batch, nothing else); every
     answer equals the reference plan of the arm the router names, the
     per-model ``[serve]``/``[slo]`` lines print and the SLO counts all
     256; the fleet's staging and dispatch (page-locked slot, non-blocking
     copy, ``plan.logits``) under ``set_sync_debug_mode("error")``; a hot
     swap of arm b to ``PRNGKey(2)`` under four client threads: every
     answer is b's old or new reference logits, version 1 after, and a
     request after ``swap`` returns gets the new plan;
  5. the training path: ``repro_torch.launch.train.main`` takes 4 steps of
     full-width VGG8B at batch 64, counts reset just before and read just
     after; each step must launch stream_conv_fwd 6×, nitro_matmul_fwd 1×,
     stream_conv_grad_w 6× and nitro_matmul_grad_w 1×, and the final
     TrainState and every step's metrics must equal, bitwise, those of the
     same run with ``--backend reference`` on the card;
  5b. the ``fuse_opt`` path: the same CLI run with ``--fuse-opt``, counted
     the same way; each step must launch stream_conv_fwd 6×,
     nitro_matmul_fwd 1×, stream_conv_grad_w_opt 6× and
     nitro_matmul_grad_w_opt 1× (and no split grad_W kernel), and its
     final TrainState, every step's metrics and the test accuracy must
     equal the split run's bitwise;
  5c. the fused apply: the CLI's 4 batches and keys through
     ``compute_gradients`` then ``apply_gradients(fuse_opt=True)``,
     counted; each step must launch integer_sgd_update once (one launch
     for all 15 weight tensors) and the state must equal the split run's
     bitwise;
     (phases 5, 5b and 5c launch no grad_x kernel: the LES step discards
     grad_x, as the compiled JAX step does);
  5d. the grad_x path: full-width VGG8B's forward with caches on the CLI's
     first batch, each block's δ_fw as the LES step forms it, then every
     block's ``layers.conv_backward`` / ``linear_backward`` with z* and
     ``conv_update`` / ``linear_update``, counted: stream_conv_grad_x 12×
     and nitro_matmul_grad_x 2× per pass (one in each block's backward and
     one in its update) beside the grad_W (or grad_W_opt) kernels; every
     grad_x and weight must equal the same calls with
     ``backend='reference'``, and the weight gradients
     ``compute_gradients``' for the same batch and key;
  5e. the MLP path: ``launch.train.main`` takes 4 steps of full-width mlp4
     (3072→3000×3→10) at batch 64, counted (nitro_matmul_fwd 3× and
     nitro_matmul_grad_w 3× per step), equal to ``--backend reference``;
  5g. the same with ``--fuse-opt``, counted (nitro_matmul_fwd 3× and
     nitro_matmul_grad_w_opt 3× per step), equal to 5e's reference run;
  5f. resume: two CLI calls of 2 VGG8B steps with one ``--ckpt-dir``, the
     second resuming from step 2, equal to the same two calls with
     ``--backend reference``; a save → restore of the card's TrainState
     is bitwise;
  6. observability at full width: (6a) ``train_nitro`` with telemetry
     every 2nd step, a trace, alerts and a metrics server on port 0, counted
     (phase 5's launches, step for step) and bitwise phase 5's run; the
     same call on the plain versions writes a byte-identical
     ``metrics.jsonl`` (rows for steps 0 and 2: one per block, ``output``,
     ``_opt``); 4 ``train.step`` spans and a ``train.eval``; ``/metrics``
     scraped over HTTP (``train_step_seconds_count 4``, ``repro_build_info``
     with ``backend="cuda"``) and ``/healthz`` ``ok``; (6b) the same with
     ``fuse_opt``: steps 0 and 2 launch #3/#8 and no ``_opt`` kernel, steps
     1 and 3 #4/#9 and no plain grad_W, the state bitwise phase 5b's; (6c)
     tracer and metrics server without telemetry: every step launches phase
     5's kernels; (6d) 256 requests 90/10 over phase 4b's two arms through
     ``FleetEngine(metrics=, tracer=)``: every answer equals its arm's
     reference plan, ``serve_requests_total`` 256 for ``_fleet`` and the
     arms' sum, the queues drained, the four spans once a batch with
     ``model=``; the fleet's staging and dispatch with metrics and tracer
     under ``set_sync_debug_mode("error")``;
  7. data parallelism at full width: (7a) ``parallel.dp.spawn`` starts 2
     ranks that share the card over gloo (asserted and printed); each trains
     full-width VGG8B 4 steps from phase 5's seed, batches and keys (global
     batch 64, 32 rows a rank) with ``psum``, ``ring`` and ``compress`` on the
     split path and ``psum`` under ``fuse_opt``: every rank's final
     TrainState and every step's metrics must equal phase 5's run bitwise
     (phase 5b's under ``fuse_opt``), and each rank step must launch
     stream_conv_fwd 6×, nitro_matmul_fwd 1×, stream_conv_grad_w 6× and
     nitro_matmul_grad_w 1× (+ integer_sgd_update 1× under ``fuse_opt``, on
     the all-reduced gradient; never #4/#9), counted in the rank; INT32_MAX
     + 1 must wrap to INT32_MIN through every reducer; (7b) the train CLI
     with ``--num-devices 2 --dp-reduce ring --telemetry-every 2``: rank 0's
     ``metrics.jsonl`` must be phase 6a's byte for byte plus the ``_dp``
     rows (shards 2) and its state and accuracy phase 5's; (7c) 7a over
     NCCL, one card a rank, where the host has two cards (else one line
     says it did not run); ``[dp]``: each reducer's host-to-host ms per
     step in turns beside the single-device step timed the same way,
     ``reduce_gradients`` alone, rank 0's device ms per step
     (``torch.profiler``) and the bytes all-reduced per step;
  8. the autotuner at full width: (8a) every problem of the served VGG8B
     batch of 32, the VGG8B step at batch 64 and mlp4's step has no knob
     on the card (``autotune.tune`` returns ``(None, {})``, nothing
     measured); the served plan's lookups in a configured cache run under
     ``set_sync_debug_mode("error")``, each key counted once as a miss,
     logits unchanged; (8b) ``train_nitro(autotune=True)`` from phase 5's
     seed tunes nothing, then trains bitwise phase 5's run on phase 5's
     kernels step for step; a second run with the cache measures nothing
     and its ``/metrics`` counts each key the step looks up once, as a
     miss; (8c) the serve CLI with ``--autotune``: logits bitwise phase
     4's, one ``kernel_int8_path_active`` sample per plan step, each of the
     plan's keys a miss;
  9. time each kernel per step shape with CUDA events beside its bound and
     its plain version (#1–#5 by their device time, with the
     ``torch._int_mm`` yardstick at their int8 GEMM shapes; #3, #4 and #5
     at mlp4's shapes too; #10's device time split into its GEMM and
     pre-passes beside #6 at sf=1; #11 per fused apply over VGG8B's 15
     and mlp4's 7 tensors), the serving batch latency, the split and
     ``fuse_opt`` training steps host to host in turns, and the mlp4 step;
     ``[e2e-fleet]``: 512 requests at once to one full-width VGG8B, the
     static ``VisionEngine`` against the continuous ``FleetEngine`` in
     turns A B B A (req/s, p50/p99, batches, fill), each once more under
     the profiler for the device busy share of the timed window, and the
     4b split run's per-model stats; ``[fleet-spans]``: the same workload
     on the continuous fleet with metrics and the tracer, each batch phase's
     p50 / mean / total ms beside the wall time, the submit loop and (under
     the profiler) the device busy share; ``[obs-serve]``: its req/s with
     and without ``metrics=`` + ``tracer=`` in turns; ``[obs-train]``: the
     VGG8B step host to host with observability off, tracer + metrics,
     telemetry every step and telemetry under ``fuse_opt``, in turns, and a
     sampled step's extra device launches and device time;
 10. the FP baselines at full width beside NITRO-D (no kernel of this
     repo: cuDNN and cuBLAS, under ``fp_baselines.full_fp32``, no TF32):
     (10a, ``[fp-parity]``) FP BP (Adam, lr 1e-3) and FP LES (SGD, lr
     2e-2) on full-width VGG8B and FP BP on full-width mlp4 (p_l = 0.1),
     4 steps each from ``init_fp_params(PRNGKey(0))`` on phase 5's and
     phase 5e's batches (tiles32 ÷ 64.0) and keys, held against the same
     steps on the port's CPU path: init bitwise, every dropout mask drawn
     on the card bitwise the CPU's, every block's forward under IEEE
     float32 settings (restored after), step 1's loss and gradient within
     ``FP_STEP1_LOSS_TOL`` / ``FP_STEP1_GRAD_TOL``, later losses and the
     final params (and Adam's moments) within ``FP_LOSS_TOL`` / ``FP_FINAL_TOL`` /
     ``FP_FINAL_RMS``; (10b, ``[fp-mem]``) at VGG8B and mlp4, batch 64:
     NITRO-D split, NITRO-D ``fuse_opt``, FP LES and FP BP, each one's
     persistent state (params + optimiser state) and the peak bytes of one
     step above what was allocated before it, and the reduction
     1 − NITRO-D / FP BP beside the paper's 76.14% (its abstract's figure,
     not measured here); (10c, ``[fp-step]``) FP BP, FP LES and the
     NITRO-D split step at VGG8B batch 64 host to host in turns, with
     each one's device time and busy share from ``torch.profiler``.
 11. an integer-only card step and the LM training path: (11a) the
     hand-written integer GEMM ``int_matmul`` (``numerics.int_matmul`` on
     the card; three routes: T one CUDA-core launch for thin products, W
     wgmma + TMA for int8 at scale, D the digit GEMM) bitwise
     ``int_matmul_ref`` (float64 limb GEMMs) twice at the materialise conv
     shapes, the LM's int8 MLP products at full width (2,048 tokens ×
     2,048 × 8,192 and back) with b N-major and K-major, route W ragged
     (2,047 × 2,064 × 8,200), at K = 48 and at M = 16, K = 131,072 of
     (−128)·(−128) (2³¹, wraps), a VGG8B step's thin products on the
     views it passes, ragged M/N/K, contractions of 40,000 and 70,001 (split), full-range int32
     with INT32_MIN/MAX and an empty K, each on the route the rule
     (``plan``) gives, checked by the per-route launch counters; one VGG8B
     and one mlp4 train step on the card, every int_matmul call of it
     recorded and held bitwise, counted (all on route T), and the same
     step under ``examples_torch/quickstart.py``'s float audit, which
     must count 0; phase 5's split run must launch int_matmul 4 times
     the VGG8B step's count; ``[int-matmul-step]`` its device time,
     device launches and back-to-back time over a VGG8B step's calls
     beside the limb GEMMs', ``[time]`` at the LM int8 shapes: route W
     beside ``torch._int_mm`` on the same K-major operands, the N-major
     b's transpose pass, route D's split; (11b, ``[lm-parity]``) every LM
     arch's smoke config 3 AdamW steps on the card against the port's CPU
     path at its own dtype and in float32 with 2 LES groups (whisper
     without), bf16 GEMMs with full-precision reductions, within ε, the
     CPU path's rounding level from a float64 run
     (``tools_torch/fp_rounding.py``'s ``float64_math``): gradient leaves
     3 ε, losses ε, AdamW's mu 3 ε and nu 6 ε after each step, params
     2.01 · Σ lr; (11c, ``[lm-step]``) llama3.2-1b's published config
     (1.236 B params, 16 layers) through the LM trainer
     (``train_lm(arch, cfg=get_config(arch))``) at batch 4 × seq 512, 4
     steps: finite losses, step 1's within 1% of the same loss in float64
     on the card (its offset from ln V printed); ms a step host to host,
     a profiled step's device busy share, peak memory; then 2 steps with
     ``int8_matmul=True``, every int_matmul call recorded and counted,
     which must be some, all on route W; ``[int-matmul-lm]`` one such
     step's calls: int_matmul, the limb GEMMs and ``torch._int_mm``,
     device time;
 12. LM serving (``models/lm.py`` ``prefill`` / ``decode_step``, the KV and
     recurrent caches, ``serving.Engine``): (12a, ``[lm-serve-parity]``)
     every LM arch's smoke config, 2 × 12 prompt tokens and 6 decode steps
     teacher-forced with the CPU run's tokens, through the Engine (the
     eight token archs) or ``prefill`` / ``decode_step`` (qwen2-vl,
     whisper), on the card against the port's CPU path: each step's logits
     and the final cache, leaf by leaf (dtypes, shapes and ``t`` equal),
     within 2 ε, ε the CPU path's distance from its own float64 run;
     (12b, ``[lm-serve]``) llama3.2-1b's published config (fp32 master
     weights from ``init_params(PRNGKey(0))``, not cut) served by
     ``Engine(max_seq=1024)``: 8 requests of 512 prompt tokens drawn as
     ``launch/serve.py`` draws them (seed 0), 64 new tokens each; the
     prefill and the first 4 decode steps' logits within 5% (relative to
     the largest |logit|) of the same steps in float64 on the card, the
     greedy tokens equal float64's wherever its top-2 margin exceeds twice
     that; the prefill ms host to host, the decode ms a token (p50, p90),
     tokens/s, one profiled decode step (device time, launches, busy
     share, time by kernel family), the step's float32 → bf16 weight casts
     replayed alone, peak memory; (12c) the same with
     ``int8_matmul=True`` and 16 new tokens: the prefill's and one decode
     step's int_matmul calls recorded (48 each, 3 a layer, on route W as
     ``plan`` gives at M = 4,096 and M = 8) and held bitwise
     ``int_matmul_ref``, the Engine's run counted (48 a step);
     ``[int-matmul-decode]`` one decode step's 48 calls: device time and
     launches against the bound by operations and by bytes, the limb
     GEMMs, ``torch._int_mm`` on the same operands (it refuses M = 8: the
     line says so), ``quantize_weight_int8``'s device time over the
     step's 48 weights;
 13. the dry run checked on the card (``launch/dryrun.py``,
     ``launch/op_analysis.py``, ``parallel/pipeline.py``): (13a,
     ``[dry-train]``) llama3.2-1b's published config at phase 11c's cell
     (batch 4 × seq 512, AdamW, remat) traced once on ``meta`` under the
     op analyzer at the one-chip mesh (1, 1), then the same step run on
     the card under the same analyzer: the op counts, the FLOPs by dtype
     and the bytes equal (exact; on a mismatch the ops that differ are
     printed), the dry run's per-chip peak within DRY_PEAK_TOL of
     ``torch.cuda.max_memory_allocated`` over a plain step; the compute,
     memory and roofline bounds beside the measured ms a step, the
     model-FLOP share of the card's dense bf16 peak; then the same with
     ``int8_matmul=True``: the same exact checks, and the analyzer's int8
     products equal (shapes included) the int_matmul calls recorded on
     the card (kernel #12); (13b, ``[dry-decode]``) phase 12b's decode
     step (8 requests, a cache of 1,024 after a 512-token prefill) through
     ``trainer.build_decode_step``, the same exact checks, the bytes bound
     as a share of the step's profiled device time; (13c, ``[pipeline]``)
     ``pipeline_apply`` over mlp4's two 3000 → 3000 served layers as two
     stages (``fused_matmul``, kernel #1), 4 microbatches of a batch of 32,
     counted (8 nitro_matmul launches), bitwise the served plan's
     activations there; (13d, ``[dry-cell]``) llama3.2-1b ``train_4k`` and
     qwen3-32b ``decode_32k`` on the 256-chip mesh, traced on the host: each
     cell's summary and trace seconds.

Prints a ``{"kernels": [...]}`` line, in which ``ms``, ``plain_ms`` and
``bound_ms`` are one serving batch's (or one training step's) launches of
the kernel summed over its step shapes and ``launches`` is its path's
count; then, last, ``{"ok": true, "device": {...}}``.  ``ms`` is CUDA-event
time over back-to-back launches, except for nitro_matmul, nitro_matmul_fwd,
nitro_matmul_grad_w, nitro_matmul_grad_w_opt, nitro_matmul_grad_x,
integer_sgd_update and int_matmul, whose launches are shorter than their wrappers' host
path: there it is the device time ``torch.profiler`` reports (for #1–#5
every device operation of the call: the memset, the pre-passes and the
GEMM, where there are; the back-to-back time is printed beside it).  The
grad_x kernels' ``ms`` is one pass of VGG8B's shapes (one call each) and
their ``launches`` phase 5d's (a backward and an update per block);
integer_sgd_update's is one fused apply over VGG8B's 15 weight tensors
(one launch) and its ``launches`` phase 5c's.  Exits non-zero,
without that line, when CUDA is absent or the script is not inside a
checkout.

Bound: the larger of ops / 1,979 TOP/s (the H100's dense int8 peak) and
bytes / 3.35 TB/s (its memory rate), counting each input read once and
each output written once.  No single PyTorch call computes the integer
conv/matmul with the NITRO scale, ReLU or ReLU derivative, so
``library_ms`` is null.  int_matmul's row is phase 5's VGG8B training
path: its ``launches`` are the split run's (4 steps and the CLI's
evaluation, 8 batches), its ``ms``, ``plain_ms`` and
``bound_ms`` one step's 23 int32 products (``timed_on`` says so), and
its ``library_ms`` null, since no PyTorch call multiplies int32 matrices
on the card.  Beside them, ``launches_per_step`` gives each path's count
a step (VGG8B, mlp4, the llama3.2-1b int8 run; phase 12's int8 prefill
of 8 × 512 tokens and its decode step of 8), ``routes_per_step`` the
same by route, ``lm_int8`` the LM int8 training path's own launches and
its ``ms``, ``plain_ms``, ``bound_ms`` and ``library_ms``
(``torch._int_mm`` on the same int8 operands) over one step's calls, and
``lm_int8_decode`` the same fields for phase 12c's serving run (its
launches) over one decode step's calls (``library_ms`` null where
``torch._int_mm`` refuses M = 8).
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_OPS = 1979e12   # int8 dense ops/s, H100 SXM data sheet
PEAK_BYTES = 3.35e12  # device memory bytes/s, H100 SXM data sheet
BATCH = 32
REQUESTS = 64
FLEET_REQUESTS = 256
FLEET_E2E = 512
TRAIN_BATCH = 64
TRAIN_STEPS = 4

KERNELS = {
    "nitro_matmul": {
        "source": "src/repro_torch/kernels/nitro_matmul/csrc/nitro_matmul.cu",
        "replaces": "src/repro/kernels/nitro_matmul/nitro_matmul.py:235",
    },
    "stream_conv": {
        "source": "src/repro_torch/kernels/nitro_conv/csrc/stream_conv.cu",
        "replaces": "src/repro/kernels/nitro_conv/nitro_conv.py:324",
    },
    "nitro_matmul_fwd": {
        "source": "src/repro_torch/kernels/nitro_matmul/csrc/nitro_matmul.cu",
        "replaces": "src/repro/kernels/nitro_matmul/nitro_matmul.py:294",
    },
    "nitro_matmul_grad_w": {
        "source": "src/repro_torch/kernels/nitro_matmul/csrc/nitro_matmul_grad_w.cu",
        "replaces": "src/repro/kernels/nitro_matmul/nitro_matmul.py:391",
    },
    "stream_conv_fwd": {
        "source": "src/repro_torch/kernels/nitro_conv/csrc/stream_conv_fwd.cu",
        "replaces": "src/repro/kernels/nitro_conv/nitro_conv.py:403",
    },
    "stream_conv_grad_w": {
        "source": "src/repro_torch/kernels/nitro_conv/csrc/stream_conv_grad_w.cu",
        "replaces": "src/repro/kernels/nitro_conv/nitro_conv.py:460",
    },
    "nitro_matmul_grad_w_opt": {
        "source": "src/repro_torch/kernels/nitro_matmul/csrc/nitro_matmul_grad_w_opt.cu",
        "replaces": "src/repro/kernels/nitro_matmul/nitro_matmul.py:478",
    },
    "stream_conv_grad_w_opt": {
        "source": "src/repro_torch/kernels/nitro_conv/csrc/stream_conv_grad_w_opt.cu",
        "replaces": "src/repro/kernels/nitro_conv/nitro_conv.py:534",
    },
    "integer_sgd_update": {
        "source": "src/repro_torch/kernels/integer_sgd/csrc/integer_sgd.cu",
        "replaces": "src/repro/kernels/integer_sgd/integer_sgd.py:61",
    },
    "nitro_matmul_grad_x": {
        "source": "src/repro_torch/kernels/nitro_matmul/csrc/nitro_matmul_grad_x.cu",
        "replaces": "src/repro/kernels/nitro_matmul/nitro_matmul.py:547",
    },
    "stream_conv_grad_x": {
        "source": "src/repro_torch/kernels/nitro_conv/csrc/stream_conv_grad_x.cu",
        "replaces": "src/repro/kernels/nitro_conv/nitro_conv.py:611",
    },
}
TRAIN_KERNELS = ("stream_conv_fwd", "nitro_matmul_fwd", "stream_conv_grad_w",
                 "nitro_matmul_grad_w")
#: launches of each kernel per VGG8B step (6 convs, 1 linear) on the split
#: path, the fuse_opt path and the fused apply
PER_STEP = {"stream_conv_fwd": 6, "nitro_matmul_fwd": 1,
            "stream_conv_grad_w": 6, "nitro_matmul_grad_w": 1}
PER_STEP_FUSE_OPT = {"stream_conv_fwd": 6, "nitro_matmul_fwd": 1,
                     "stream_conv_grad_w_opt": 6, "nitro_matmul_grad_w_opt": 1}
PER_STEP_FUSED_APPLY = {**PER_STEP, "integer_sgd_update": 1}
#: launches of one grad_x pass over VGG8B's blocks (backward, then update)
PER_GRAD_X_PASS = {"stream_conv_grad_x": 12, "nitro_matmul_grad_x": 2,
                   "stream_conv_grad_w": 6, "nitro_matmul_grad_w": 1,
                   "stream_conv_grad_w_opt": 6, "nitro_matmul_grad_w_opt": 1}
#: launches per mlp4 step (three linear blocks)
PER_STEP_MLP = {"nitro_matmul_fwd": 3, "nitro_matmul_grad_w": 3}
PER_STEP_MLP_FUSE_OPT = {"nitro_matmul_fwd": 3, "nitro_matmul_grad_w_opt": 3}
#: mlp4's forward-layer shapes at batch 64: (kind, x shape, w shape)
MLP4_SHAPES = [("linear", (TRAIN_BATCH, 3072), (3072, 3000)),
               ("linear", (TRAIN_BATCH, 3000), (3000, 3000))]
#: parity cases held bitwise, by kernel
PARITY_CASES: Counter = Counter()
#: dynamic shared memory of the digit GEMMs: SMEM in digit_gemm.cuh
#: (grad_W) and in conv_digits.cuh (the forward convs), RING in
#: nitro_matmul.cu (the matmuls); Cfg::SMEM in wgmma_s8.cuh (int_matmul's
#: route W)
DIGIT_GEMM_SMEM = {"digit_gemm_kernel": 184320, "conv_digit_gemm_kernel": 217088,
                   "matmul_digit_kernelILb0": 102400, "matmul_digit_kernelILb1": 102400,
                   "grad_w_digit_kernelILb0": 61440, "grad_w_digit_kernelILb1": 98304,
                   "grad_x_digit_kernelILb0": 163840, "grad_x_digit_kernelILb1": 163840,
                   "gemm_s8_kernelILi256ELb0": 197632, "gemm_s8_kernelILi128ELb1": 197632}
#: kernels whose ptxas lines the build phase prints: mangled name fragment
#: (the first that matches an entry, in this order) → what the line says
PTXAS_KERNELS = {
    "conv_digit_gemm_kernel": "conv_digit_gemm_kernel",
    "matmul_digit_kernelILb0": "matmul_digit_kernel<int8 only>",
    "matmul_digit_kernelILb1": "matmul_digit_kernel<16 variants>",
    "grad_w_digit_kernelILb0": "grad_w_digit_kernel<grad_W>",
    "grad_w_digit_kernelILb1": "grad_w_digit_kernel<W' (fuse_opt)>",
    "grad_x_digit_kernelILb0": "grad_x_digit_kernel<4-byte copies of w>",
    "grad_x_digit_kernelILb1": "grad_x_digit_kernel<16-byte copies of w>",
    "digit_gemm_kernel": "digit_gemm_kernel",
    "x_digits_kernelILb0": "x_digits_kernel",
    "x_digits_kernelILb1": "x_digits_kernel<masked>",
    "patch_digits_kernelILb0Ea": "patch_digits_kernel<int8>",
    "patch_digits_kernelILb0Ei": "patch_digits_kernel<int32>",
    "patch_digits_kernelILb1Ei": "patch_digits_kernel<masked>",
    "row_digits_kernelILb0Ea": "row_digits_kernel<int8>",
    "row_digits_kernelILb0Ei": "row_digits_kernel<int32>",
    "row_digits_kernelILb1Ei": "row_digits_kernel<masked>",
    "w_rot_digits_kernel": "w_rot_digits_kernel",
    "integer_sgd_many_kernel": "integer_sgd_many_kernel",
    "gemm_s8_kernelILi256ELb0": "gemm_s8_kernel<128x256> (int_matmul route W)",
    "gemm_s8_kernelILi128ELb1": "gemm_s8_kernel<128x128, folds> (int_matmul route W)",
    "thin_kernelIiiE": "thin_kernel<int32, int32> (int_matmul route T)",
    "transpose_s8_kernel": "transpose_s8_kernel (int_matmul route W's pass)",
}
I32 = (-(2 ** 31), 2 ** 31)
#: bounds of x and w whose values need one to four base-256 digits (the
#: last with INT32_MIN/MAX planted)
DIGIT_LIMS = {1: 100, 2: 20000, 3: 2 ** 20, 4: 2 ** 31 - 1}



def die(msg: str) -> None:
    print(f"[smoke] FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True,
                          timeout=120).stdout.strip()


def toolchain(torch) -> str:
    """Phase 1: print the card and the toolchain; returns the card line."""
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    print(card)
    from repro_torch.kernels import cuda_lib

    nvcc = run([cuda_lib.nvcc_path(), "--version"]).splitlines()
    try:
        from importlib.metadata import version
        triton = version("triton")
    except Exception:  # absent or unreadable metadata: report, not fatal
        triton = "absent"
    print(f"[env] {' / '.join(nvcc[-2:])} | torch {torch.__version__} (CUDA "
          f"{torch.version.cuda}) | triton {triton} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return card


def build() -> None:
    """Phase 2: compile every kernel library, one nvcc each, in parallel."""
    from repro_torch.kernels import cuda_lib

    t0 = time.perf_counter()
    logs = cuda_lib.build_all()
    print(f"[build] {sorted(logs) or 'cached'} in {time.perf_counter() - t0:.1f}s")
    for name, log in sorted(logs.items()):  # one line per library
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores", log)]
        if regs:
            print(f"[ptxas] {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} "
                  f"registers, spill stores up to {max(spills, default=0)} B")
        for entry in log.split("Compiling entry function")[1:]:
            kernel = next((k for k in PTXAS_KERNELS if k in entry.split("\n")[0]), None)
            if kernel is None:
                continue  # the digit GEMMs and the forward convs' own pre-passes
            r = re.search(r"Used (\d+) registers", entry)
            sp = re.search(r"(\d+) bytes spill stores", entry)
            sm = re.search(r"(\d+) bytes smem", entry)
            dyn = DIGIT_GEMM_SMEM.get(kernel, 0)
            kernel = PTXAS_KERNELS[kernel]
            print(f"[ptxas] {name}: {kernel} {r and r.group(1)} registers, "
                  f"{sm.group(1) if sm else 0} B static smem + {dyn} B dynamic, "
                  f"spill stores {sp and sp.group(1)} B")


def run_step(meta, a, w, backend: str):
    """One plan step through the dispatcher with an explicit backend."""
    import torch
    from repro_torch.kernels.nitro_conv.ops import fused_conv
    from repro_torch.kernels.nitro_matmul.ops import fused_matmul

    out_dtype = torch.int8 if meta.out_dtype == "int8" else torch.int32
    kw = dict(sf=meta.sf, alpha_inv=meta.alpha_inv, apply_relu=meta.apply_relu,
              out_dtype=out_dtype, backend=backend,
              operand_dtype=meta.operand_dtype)
    if meta.kind == "conv":
        return fused_conv(a, w, pool=meta.pool, conv_mode=meta.conv_mode, **kw)
    return fused_matmul(a, w, **kw)


def step_inputs(plan, x):
    """(meta, input, weight) of every plan step on batch ``x`` (plain path)."""
    import torch

    a = torch.as_tensor(x).to(device=plan.device, dtype=torch.int32)
    steps = []
    for w, meta in zip(plan.weights, plan.metas):
        if meta.kind != "conv" and a.ndim > 2:
            a = a.reshape(a.shape[0], -1)
        steps.append((meta, a, w))
        a = run_step(meta, a, w, "reference")
    return steps


def compare(name: str, got, want, errs: dict) -> None:
    import torch

    if got.dtype != want.dtype or got.shape != want.shape:
        die(f"{name}: {got.dtype}{tuple(got.shape)} vs plain "
            f"{want.dtype}{tuple(want.shape)}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) if got.numel() else 0
    kernel = name.split()[0]
    errs[kernel] = max(errs.get(kernel, 0), err)
    if err != 0:
        bad = (got != want).nonzero()[0].tolist()
        die(f"{name}: kernel != plain (max |err| {err}), first at {bad}")
    PARITY_CASES[kernel] += 1
    print(f"[parity] {name}: bitwise equal")


def parity(steps, errs: dict) -> None:
    """Phase 3: each kernel vs its plain version on the card, bitwise."""
    import torch
    from repro_torch.kernels.nitro_conv.nitro_conv import stream_conv
    from repro_torch.kernels.nitro_conv.ref import stream_conv_ref
    from repro_torch.kernels.nitro_matmul.nitro_matmul import nitro_matmul
    from repro_torch.kernels.nitro_matmul.ref import nitro_matmul_ref

    g = torch.Generator().manual_seed(1)
    dev = "cuda"

    def ints(shape, lo, hi, dtype):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int64).to(dtype).to(dev)

    # each step shape twice: on the main path's own activations, and on
    # uniform [-127, 127] inputs of the same shape and dtype
    for i, (meta, a, w) in enumerate(steps, 1):
        kernel = "stream_conv" if meta.kind == "conv" else "nitro_matmul"
        for tag, inp in (("path", a), ("uniform", ints(a.shape, -127, 128, a.dtype))):
            got = run_step(meta, inp, w, "cuda")
            want = run_step(meta, inp, w, "reference")
            torch.cuda.synchronize()
            compare(f"{kernel} step {i} {tag} {tuple(a.shape)}x{tuple(w.shape)} "
                    f"operands={meta.operand_dtype}", got, want, errs)

    i32 = (-(2 ** 31), 2 ** 31)
    mm_cases = [  # (M, K, N, operand range, dtype, sf, alpha_inv, relu, out)
        (5, 7, 3, (-127, 128), torch.int8, 256 * 7, 10, True, torch.int8),
        (33, 300, 70, (-127, 128), torch.int8, 256 * 300, 2, True, torch.int32),
        (33, 300, 70, (-127, 128), torch.int8, 3 << 2, 10, True, torch.int32),
        (40, 64, 130, (-127, 128), torch.int8, 1, 3, True, torch.int32),
        (33, 2048, 10, i32, torch.int32, 27 << 8, 1, False, torch.int32),
        (64, 300, 70, i32, torch.int32, 6912, 10, True, torch.int8),
        (32, 1152, 256, (-127, 128), torch.int16, 9 << 15, 10, True, torch.int8),
    ]
    for m, k, n, rng, dt, sf, ai, relu, out in mm_cases:
        x, w = ints((m, k), *rng, dt), ints((k, n), *rng, dt)
        od = "int8" if dt == torch.int8 else "int32"
        kw = dict(sf=sf, alpha_inv=ai, apply_relu=relu, out_dtype=out, operand_dtype=od)
        got = nitro_matmul(x, w, **kw)
        want = nitro_matmul_ref(x, w, **kw)
        torch.cuda.synchronize()
        compare(f"nitro_matmul ragged ({m},{k},{n}) {dt} relu={relu} -> {out}",
                got, want, errs)

    conv_cases = [  # (N, H, W, C, F, K, pool, dtype, bh, out, sf)
        (3, 7, 9, 5, 40, 3, True, torch.int8, 8, torch.int8, 6),
        (2, 6, 10, 4, 20, 3, False, torch.int8, 4, torch.int32, 5),
        (2, 9, 7, 6, 33, 5, False, torch.int32, 8, torch.int32, 256 * 150),
        (2, 11, 13, 3, 16, 3, True, torch.int32, 2, torch.int8, 256 * 27),
        (4, 5, 5, 7, 10, 3, False, torch.int8, 3, torch.int8, 256 * 63),
        (2, 16, 100, 400, 40, 3, True, torch.int8, 8, torch.int8, 256 * 3600),
        (1, 12, 90, 150, 36, 3, False, torch.int8, 8, torch.int32, 3 << 10),
        (BATCH, 32, 32, 128, 256, 3, True, torch.int32, 8, torch.int8, 9 << 15),
        (BATCH, 8, 8, 512, 512, 3, True, torch.int32, 8, torch.int8, 9 << 17),
    ]
    for n, h, wd, c, f, k, pool, dt, bh, out, sf in conv_cases:
        x, w = ints((n, h, wd, c), -127, 128, dt), ints((k, k, c, f), -127, 128, dt)
        od = "int8" if dt == torch.int8 else "int32"
        kw = dict(sf=sf, alpha_inv=10, apply_relu=True, pool=pool,
                  out_dtype=out, operand_dtype=od)
        got = stream_conv(x, w, bh=bh, **kw)
        want = stream_conv_ref(x, w, bh=bh, **kw)
        torch.cuda.synchronize()
        compare(f"stream_conv ragged ({n},{h},{wd},{c})*K{k}->{f} {dt} "
                f"pool={pool} bh={bh}", got, want, errs)

    # every digit path (x and w of one to four digits) at every VGG8B
    # serving conv shape and the ragged ones; the ReLU and out dtype vary
    # with the path
    cases = [("step", tuple(a.shape), tuple(w.shape), meta.sf, meta.pool)
             for meta, a, w in steps if meta.kind == "conv"]
    cases += [("ragged", (n, h, wd, c), (k, k, c, f), sf, pool)
              for n, h, wd, c, f, k, pool, _, _, _, sf in conv_cases]
    for tag, xs, ws, sf, pool in cases:
        for i, (x, w) in enumerate(fwd_digit_operands(xs, ws, g)):
            relu = i % 2 == 0
            kw = dict(sf=sf, pool=pool, apply_relu=relu,
                      out_dtype=torch.int8 if relu else torch.int32)
            got, want = stream_conv(x, w, **kw), stream_conv_ref(x, w, **kw)
            torch.cuda.synchronize()
            compare(f"stream_conv {tag} x{xs} w{ws} pool={pool} relu={relu} "
                    f"({fwd_digits_run(x, w)})", got, want, errs)


def fwd_digit_operands(xs, ws, g):
    """(x, w) int32 pairs on the card whose values need each of one to four
    digits (16 pairs: every variant of the forward conv digit GEMM)."""
    import torch

    def ints(shape, nd):
        lim = DIGIT_LIMS[nd]
        t = torch.randint(-lim, lim, shape, generator=g, dtype=torch.int64).to(
            torch.int32).cuda()
        if nd == 4:
            t.view(-1)[:2] = torch.tensor([I32[0], I32[1] - 1], dtype=torch.int32)
        return t

    return [(ints(xs, nx), ints(ws, nw)) for nx in DIGIT_LIMS for nw in DIGIT_LIMS]


def fwd_digits_run(x, w) -> str:
    """The digit products the forward conv kernels run on x and w (their
    pre-passes' rule, read here on the host for the report)."""
    import torch
    from repro_torch.kernels.nitro_conv.ref import digits_needed

    nx = 1 if x.dtype == torch.int8 else digits_needed(x)
    nw = 1 if w.dtype == torch.int8 else digits_needed(w)
    pairs = sum(1 for i in range(nx) for j in range(nw) if i + j < 4)
    return f"x {nx} digits, w {nw} digits: {pairs} products"


def main_path(fm):
    """Phase 4: the port's serving CLI at full width with the static
    scheduler, counted; ``fm`` is the same seeded init frozen by the
    smoke, the reference plan's weights."""
    import torch
    from repro_torch.infer import compile_plan
    from repro_torch.kernels.nitro_conv.nitro_conv import stream_conv
    from repro_torch.kernels.nitro_matmul.nitro_matmul import nitro_matmul
    from repro_torch.launch import serve_vision

    stream_conv.launches.reset()
    nitro_matmul.launches.reset()
    res = serve_vision.main([
        "--arch", "vgg8b", "--scale", "1", "--batch", str(BATCH),
        "--requests", str(REQUESTS), "--seed", "0", "--device", "cuda",
        "--scheduler", "static",
    ])
    launches = {"stream_conv": stream_conv.launches.value,
                "nitro_matmul": nitro_matmul.launches.value}
    batches = res["batches_total"]
    print(f"[main] {batches} batches, launches {launches}")
    if launches != {"stream_conv": 6 * batches, "nitro_matmul": 2 * batches}:
        die(f"expected 6 stream_conv + 2 nitro_matmul per batch over {batches} "
            f"batches, got {launches}")
    served = res["plan"].frozen_weights
    if not all(torch.equal(a, layer.w) for a, layer in zip(served, fm.layers)):
        die("the CLI's PRNGKey(0) init differs from the smoke's")
    ref_plan = compile_plan(fm, device="cuda", backend="reference")
    check_served(ref_plan, res["images"], res["results"], "[main]")
    return res, launches


def check_served(ref_plan, images, results, what: str) -> None:
    """Every result's logits (int32, shape (10,)) and label equal the
    reference plan's on the same images, in batches of BATCH."""
    import numpy as np

    if len(results) != len(images):
        die(f"{what} {len(results)} results for {len(images)} requests")
    for s in range(0, len(images), BATCH):
        want = ref_plan.logits(np.stack(images[s:s + BATCH])).cpu().numpy()
        for j, r in enumerate(results[s:s + BATCH]):
            got = r.logits
            if got.dtype != np.int32 or got.shape != (10,) or not np.array_equal(got, want[j]):
                die(f"{what} request {s + j}: logits {got} != reference {want[j]}")
            if r.label != int(np.argmax(want[j])):
                die(f"{what} request {s + j}: label {r.label} != reference")
    print(f"{what} {len(results)} requests: logits equal the reference plan's")


def frozen_init(seed: int):
    """Full-width VGG8B from ``PRNGKey(seed)`` (initialised on the card),
    frozen."""
    from repro_torch.configs import get_paper_config
    from repro_torch.core import model as M
    from repro_torch.core import prng
    from repro_torch.infer import freeze

    cfg = get_paper_config("vgg8b", scale=1.0)
    return freeze(M.init_params(prng.PRNGKey(seed), cfg, device="cuda"), cfg)


def fleet_path(fm_a, root: str):
    """Phase 4b: two full-width VGG8B arms (``PRNGKey(0)``, ``PRNGKey(1)``)
    written with ``save_frozen`` and a 90/10 ``FLEET.json``, served by the
    CLI's default continuous scheduler with a 50 ms SLO, counted; every
    answer equals the reference plan of the arm the router names."""
    import contextlib
    import io

    from repro_torch.infer import compile_plan, save_fleet_manifest, save_frozen
    from repro_torch.launch import serve_vision
    from repro_torch.serving import VisionResult

    fm_b = frozen_init(1)
    save_frozen(f"{root}/a", fm_a)
    save_frozen(f"{root}/b", fm_b)
    save_fleet_manifest(root, {"a": "a", "b": "b"},
                        splits={"split": {"a": 0.9, "b": 0.1}})
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res, launches = counted(lambda: serve_vision.main([
            "--fleet-dir", root, "--batch", str(BATCH), "--requests", str(FLEET_REQUESTS),
            "--slo", "50", "--device", "cuda"]))
    print(out.getvalue(), end="")
    batches = res["batches_total"]
    want = {k: 0 for k in launches}
    want.update(stream_conv=6 * batches, nitro_matmul=2 * batches)
    print(f"[fleet] {batches} batches (warm-up included), launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    if launches != want:
        die(f"fleet: expected 6 stream_conv + 2 nitro_matmul per batch over {batches} "
            f"batches and nothing else, got {launches}")
    results = res["results"]
    if len(results) != FLEET_REQUESTS or not all(isinstance(r, VisionResult)
                                                 for r in results):
        die(f"fleet: {len(results)} results for {FLEET_REQUESTS} requests")
    arms = [res["router"].resolve(res["target"], rid) for rid in res["request_ids"]]
    refs = {"a": fm_a, "b": fm_b}
    for arm in ("a", "b"):
        idx = [i for i, a in enumerate(arms) if a == arm]
        if not idx:
            die(f"fleet: the 90/10 split sent no request to arm {arm}")
        check_served(compile_plan(refs[arm], device="cuda", backend="reference"),
                     [res["images"][i] for i in idx], [results[i] for i in idx],
                     f"[fleet] arm {arm}:")
    text = out.getvalue()
    for arm in ("a", "b"):
        if f"[serve]   {arm}: " not in text or f"[slo]   {arm}: " not in text:
            die(f"fleet: no [serve]/[slo] line for arm {arm}")
    slo_requests = sum(v["requests"] for v in res["snapshot"]["slo"].values())
    if slo_requests != FLEET_REQUESTS:
        die(f"fleet: SLO attribution counted {slo_requests} of {FLEET_REQUESTS} requests")
    per_arm = {m: s["requests"] for m, s in res["snapshot"]["models"].items()}
    if per_arm != {"a": arms.count("a"), "b": arms.count("b")}:
        die(f"fleet: per-model requests {per_arm} != the router's split")
    return res, fm_b


def hot_swap_path(res, fm_b) -> None:
    """Phase 4b, hot swap under load: client threads submit to arm b while
    ``registry.swap("b", PRNGKey(2))`` runs; every answer equals arm b's
    old or new reference logits, ``version`` is 1 after, and a request
    submitted after the swap returns is answered by the new plan."""
    import threading

    import numpy as np
    from repro_torch.infer import compile_plan
    from repro_torch.serving import FleetEngine

    registry = res["registry"]
    fm_new = frozen_init(2)
    rng = np.random.default_rng(7)
    imgs = [rng.integers(-127, 128, fm_b.input_shape).astype(np.int32)
            for _ in range(2 * BATCH)]
    old = compile_plan(fm_b, device="cuda", backend="reference").logits(
        np.stack(imgs)).cpu().numpy()
    new = compile_plan(fm_new, device="cuda", backend="reference").logits(
        np.stack(imgs)).cpu().numpy()
    clients, per_client = 4, 3 * BATCH
    answers = [[] for _ in range(clients)]
    errors = []
    under_load = threading.Event()  # set once the clients have 2 batches' answers

    def client(w):
        try:
            for k in range(per_client):
                i = (w * per_client + k) % len(imgs)
                answers[w].append((i, engine.submit(imgs[i], model="b").result(
                    timeout=60).logits))
                if sum(map(len, answers)) >= 2 * BATCH:
                    under_load.set()
        except Exception as e:  # reported below: any failure is fatal
            errors.append(repr(e))
            under_load.set()

    with FleetEngine(registry, batch_size=BATCH) as engine:
        engine.classify(imgs[:1], model="b")
        threads = [threading.Thread(target=client, args=(w,)) for w in range(clients)]
        for t in threads:
            t.start()
        if not under_load.wait(120):
            die("hot swap: the clients got no answers")
        entry = registry.swap("b", fm_new)
        after = engine.submit(imgs[0], model="b").result(timeout=60).logits
        for t in threads:
            t.join(120)
    if errors or any(t.is_alive() for t in threads):
        die(f"hot swap: clients failed or hung: {errors}")
    n_old = n_new = 0
    for w in range(clients):
        if len(answers[w]) != per_client:
            die(f"hot swap: client {w} got {len(answers[w])} of {per_client} answers")
        for i, logits in answers[w]:
            if np.array_equal(logits, old[i]):
                n_old += 1
            elif np.array_equal(logits, new[i]):
                n_new += 1
            else:
                die(f"hot swap: image {i} answered neither by arm b's old nor new plan")
    if not (n_old and n_new):
        die(f"hot swap: {n_old} old and {n_new} new answers: the swap did not land "
            f"under load")
    if entry.version != 1 or registry.get("b").version != 1:
        die(f"hot swap: version {entry.version} after one swap")
    if not np.array_equal(after, new[0]):
        die("hot swap: a request submitted after swap() returned was not "
            "answered by the new plan")
    print(f"[swap] {clients} clients x {per_client} requests to arm b across "
          f"registry.swap: {n_old} answered by the old plan, {n_new} by the new, "
          f"none torn; version 1; a request after swap() returned got the new plan")


def fleet_no_sync(registry, images, what: str = "", **engine_kw) -> None:
    """Phase 4b (and 6d, with ``metrics=`` and ``tracer=`` in
    ``engine_kw``): the fleet's staging and dispatch (page-locked slot,
    non-blocking copy, ``plan.logits``, the spans and metrics around them)
    on this thread under ``torch.cuda.set_sync_debug_mode("error")``, with
    no worker batch in flight, then held against the reference plan."""
    import time
    from concurrent.futures import Future

    import numpy as np
    import torch
    from repro_torch.serving import FleetEngine
    from repro_torch.serving.vision import Request

    imgs = images[:BATCH]
    with FleetEngine(registry, batch_size=BATCH, **engine_kw) as engine:
        engine.classify(imgs[:2], model="a")  # the slots exist, the worker idles
        items = [Request(np.asarray(im, np.int32), Future(), time.perf_counter())
                 for im in imgs]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            assembled = engine._assemble("a", items)
            inflight = engine._dispatch(assembled) if assembled else None
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if inflight is None:
            die(f"fleet dispatch synchronised with the host or failed: "
                f"{items[0].future.exception()}")
        got = inflight[2].cpu().numpy()
    want = registry.get("a").plan.logits(np.stack(imgs)).cpu().numpy()
    if got.dtype != np.int32 or not np.array_equal(got, want):
        die("fleet dispatch under sync debug mode: logits differ from the plan's")
    print(f"[no-sync] fleet staging + dispatch of a batch of {BATCH} (page-locked "
          f"slot, non-blocking copy, plan.logits){what} ran under "
          f"torch.cuda.set_sync_debug_mode('error') without a host sync; logits equal")


def fleet_end_to_end(res, fm_a, card: str) -> None:
    """``[e2e-fleet]``: one model (arm a), FLEET_E2E requests submitted at
    once, the static VisionEngine against the continuous FleetEngine in
    turns A B B A, then each once more under ``torch.profiler`` for the
    device busy share of the timed window (device time of every kernel,
    memset and copy over the host clock).  Also the split run's
    per-model stats."""
    import contextlib

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import (FleetEngine, ModelRegistry, VisionEngine,
                                     latency_summary_ms, snapshot_delta)

    reg = ModelRegistry(device="cuda")
    plan = reg.register("a", fm_a).plan
    rng = np.random.default_rng(11)
    imgs = [rng.integers(-127, 128, plan.input_shape).astype(np.int32)
            for _ in range(FLEET_E2E)]
    want = plan.logits(np.stack(imgs[:BATCH])).cpu().numpy()

    def serve(kind, traced=False):
        engine = (VisionEngine(plan, batch_size=BATCH, max_wait_ms=3.0) if kind == "static"
                  else FleetEngine(reg, batch_size=BATCH))
        kw = {} if kind == "static" else {"model": "a"}
        with engine:
            engine.classify(imgs[:1], **kw)
            pre = engine.stats.snapshot()
            torch.cuda.synchronize()
            with (profile(activities=[ProfilerActivity.CUDA]) if traced
                  else contextlib.nullcontext()) as prof:
                t0 = time.perf_counter()
                futs = [engine.submit(im, **kw) for im in imgs]
                submitted = time.perf_counter() - t0
                results = [f.result(timeout=120) for f in futs]
                wall = time.perf_counter() - t0
            snap = snapshot_delta(pre, engine.stats.snapshot())
        if not all(np.array_equal(r.logits, want[i]) for i, r in enumerate(results[:BATCH])):
            die(f"[e2e-fleet] {kind}: logits differ from the plan's")
        busy = None
        if traced:
            busy = 0.0
            for e in prof.key_averages():
                us = getattr(e, "self_device_time_total", None)
                busy += (e.self_cuda_time_total if us is None else us) / 1e3
        return wall, latency_summary_ms(r.latency_s for r in results), snap, busy, submitted

    def line(what, wall, pct, snap, submitted):
        return (f"[e2e-fleet] {card} | {what}: {FLEET_E2E} requests at once, full-width "
                f"VGG8B, batch {BATCH}: {FLEET_E2E / wall:.1f} req/s ({wall * 1e3:.3f} ms, "
                f"the submit loop, backpressure included, {submitted * 1e3:.3f} ms of it), latency ms p50 "
                f"{pct['p50']:.3f} p99 {pct['p99']:.3f}, {snap['batches']} batches, fill "
                f"{snap['avg_batch_fill']:.3f}")

    for turn, kind in enumerate(("static", "continuous", "continuous", "static"), 1):
        wall, pct, snap, _, submitted = serve(kind)
        print(line(f"turn {turn} {kind}", wall, pct, snap, submitted))
    for kind in ("static", "continuous"):
        wall, pct, snap, busy, submitted = serve(kind, traced=True)
        print(line(f"{kind} under the profiler", wall, pct, snap, submitted)
              + f", device busy {busy:.3f} ms ({100 * busy / (wall * 1e3):.1f}%), "
              f"{busy / snap['batches']:.4f} ms device per batch")
    # the worker releases the GIL at every launch and copy, and the submit
    # loop holds it in between: a probe of how much of the window is the
    # interpreter's switch interval (5 ms by default), not the engines
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        for turn, kind in enumerate(("static", "continuous", "continuous", "static"), 1):
            wall, pct, snap, _, submitted = serve(kind)
            print(line(f"probe, switch interval 0.1 ms (default {interval * 1e3:g} ms), "
                       f"turn {turn} {kind}", wall, pct, snap, submitted))
    finally:
        sys.setswitchinterval(interval)
    for mid, m in res["snapshot"]["models"].items():
        slo = res["snapshot"]["slo"].get(mid, {})
        print(f"[e2e-fleet] {card} | split run arm {mid}: {m['requests']} requests, "
              f"{m['batches']} batches, fill {m['avg_batch_fill']:.3f}, SLO 50 ms "
              f"violations {slo.get('violations')}/{slo.get('requests')}")
    pct = res["latency_ms"]
    print(f"[e2e-fleet] {card} | split run: {FLEET_REQUESTS} requests in "
          f"{res['wall_s'] * 1e3:.3f} ms ({FLEET_REQUESTS / res['wall_s']:.1f} req/s), "
          f"latency ms p50 {pct['p50']:.3f} p99 {pct['p99']:.3f}, "
          f"{res['snapshot']['fleet']['batches']} batches, fill "
          f"{res['snapshot']['fleet']['avg_batch_fill']:.3f}")


def launch_counters() -> dict:
    """Each kernel wrapper's launch counter, by kernel name."""
    from repro_torch.kernels.integer_sgd import integer_sgd_update
    from repro_torch.kernels.nitro_conv.nitro_conv import (
        stream_conv, stream_conv_fwd, stream_conv_grad_w, stream_conv_grad_w_opt,
        stream_conv_grad_x)
    from repro_torch.kernels.nitro_matmul.nitro_matmul import (
        nitro_matmul, nitro_matmul_fwd, nitro_matmul_grad_w,
        nitro_matmul_grad_w_opt, nitro_matmul_grad_x)

    fns = (nitro_matmul, stream_conv, nitro_matmul_fwd, nitro_matmul_grad_w,
           stream_conv_fwd, stream_conv_grad_w, nitro_matmul_grad_w_opt,
           stream_conv_grad_w_opt, integer_sgd_update, nitro_matmul_grad_x,
           stream_conv_grad_x)
    return {f.__name__: f.launches for f in fns}


def counted(fn):
    """``(fn(), launches)``: every counter set to 0 just before the call
    and read just after."""
    counters = launch_counters()
    for c in counters.values():
        c.reset()
    out = fn()
    return out, {k: c.value for k, c in counters.items()}


def train_shapes(cfg, batch: int):
    """(kind, x shape, w shape, sf, alpha_inv) of every forward layer of a
    training step at ``batch``."""
    from repro_torch.core.scaling import conv_scale_factor, linear_scale_factor

    shapes, (h, w, c) = [], cfg.input_shape
    for spec in cfg.blocks:
        k, f = spec.kernel_size, spec.out_features
        if spec.kind == "conv":
            shapes.append(("conv", (batch, h, w, c), (k, k, c, f),
                           conv_scale_factor(k, c), spec.alpha_inv))
            c = f
            if spec.pool:
                h, w = h // 2, w // 2
        else:
            m = h * w * c
            shapes.append(("linear", (batch, m), (m, f), linear_scale_factor(m),
                           spec.alpha_inv))
    return shapes


RAGGED_TRAIN = [  # (kind, x shape, w shape, sf, alpha_inv)
    ("conv", (3, 7, 9, 5), (3, 3, 5, 40), 256 * 45, 10),
    ("conv", (2, 9, 7, 6), (5, 5, 6, 33), 256 * 150, 2),
    ("conv", (2, 11, 13, 3), (3, 3, 3, 16), 256 * 27, 1),
    ("conv", (1, 12, 90, 150), (3, 3, 150, 36), 3 << 10, 10),
    ("conv", (5, 33, 31, 3), (3, 3, 3, 70), 27, 10),
    ("linear", (5, 7), (7, 3), 256 * 7, 10),
    ("linear", (33, 300), (300, 70), 256 * 300, 2),
    ("linear", (1000, 20), (20, 10), 3 << 4, 1),
]


def train_operands(xs, ws, g):
    """Inputs of one training shape on the card: x in the activation range,
    weights wide enough that z* spans every NITRO-ReLU segment, and a
    gradient δ of both signs with a z* that hits every segment."""
    import torch

    def ints(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int64).to(
            torch.int32).to("cuda")

    out_shape = (*xs[:-1], ws[-1])
    return (ints(xs, -127, 128), ints(ws, -(2 ** 15), 2 ** 15),
            ints(out_shape, -(2 ** 20), 2 ** 20), ints(out_shape, -300, 301))


def digit_operands(xs, ws, g):
    """(tag, x, δ, z*) sets that drive each digit path of the conv grad_W
    kernels beside ``train_operands``' (int8-range x, δ of ±2²⁰: three
    digits): δ needing one and two digits, and full-range int32 x and δ
    with INT32_MIN/MAX planted (x wide: the ten products i + j ≤ 3)."""
    import torch

    out_shape = (*xs[:-1], ws[-1])

    def ints(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int64).to(
            torch.int32).to("cuda")

    x8, z = ints(xs, -127, 128), ints(out_shape, -300, 301)
    xw, dw = ints(xs, *I32), ints(out_shape, *I32)
    xw.view(-1)[:2] = torch.tensor([I32[0], I32[1] - 1], dtype=torch.int32, device="cuda")
    dw.view(-1)[:4] = torch.tensor([I32[0], I32[1] - 1] * 2, dtype=torch.int32, device="cuda")
    return [("delta 1 digit", x8, ints(out_shape, -100, 101), z),
            ("delta 2 digits", x8, ints(out_shape, -20000, 20001), z),
            ("full-range x and delta", xw, dw, z)]


def digits_run(x, delta, z, alpha_inv) -> str:
    """The digit products the conv grad_W kernels run on these operands
    (their pre-passes' rule, read here on the host for the report)."""
    from repro_torch.core.activations import nitro_relu_backward
    from repro_torch.kernels.nitro_conv.ref import digits_needed, x_fits_s8

    d = delta if z is None else nitro_relu_backward(z, delta, alpha_inv)
    nd, wide = digits_needed(d), not x_fits_s8(x)
    pairs = sum(1 for i in range(4 if wide else 1) for j in range(nd) if i + j < 4)
    return f"x {'4 digits' if wide else '1 digit'}, delta {nd} digits: {pairs} products"


def train_calls(kind, x, w, delta, z, sf, alpha_inv, backend):
    """(fwd, grad_w, grad_w without z*) of one training shape through the
    dispatchers with an explicit backend; no z*-free call for linear."""
    from repro_torch.kernels.nitro_conv.ops import conv_grad_w, fused_conv_fwd
    from repro_torch.kernels.nitro_matmul.ops import fused_matmul_fwd, grad_w_matmul

    if kind == "conv":
        k = w.shape[0]
        return (
            lambda: fused_conv_fwd(x, w, sf=sf, alpha_inv=alpha_inv, backend=backend),
            lambda: conv_grad_w(x, delta, kernel_size=k, z_star=z,
                                alpha_inv=alpha_inv, backend=backend),
            lambda: conv_grad_w(x, delta, kernel_size=k, backend=backend),
        )
    return (
        lambda: fused_matmul_fwd(x, w, sf=sf, alpha_inv=alpha_inv, backend=backend),
        lambda: grad_w_matmul(x, delta, z, alpha_inv=alpha_inv, backend=backend),
        None,
    )


def _pair(name, kernel_fn, plain_fn, errs):
    import torch

    got, want = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for i, (a, b) in enumerate(zip(got, want)):
        compare(f"{name} out{i}", a, b, errs)


def train_parity(shapes, errs: dict) -> None:
    """Phase 3b: the training kernels vs their plain versions, bitwise, at
    every VGG8B training shape (α_inv 10 and 1; conv grad_W with and
    without z*) and at ragged shapes."""
    import torch
    from repro_torch.kernels.nitro_conv.ops import conv_grad_w

    names = {"conv": ("stream_conv_fwd", "stream_conv_grad_w"),
             "linear": ("nitro_matmul_fwd", "nitro_matmul_grad_w")}
    g = torch.Generator().manual_seed(2)
    cases = [(f"step {i}", *sh) for i, sh in enumerate(shapes, 1)]
    cases += [(f"step {i} alpha_inv=1", kind, xs, ws, sf, 1)
              for i, (kind, xs, ws, sf, _) in enumerate(shapes, 1)]
    cases += [("ragged", *sh) for sh in RAGGED_TRAIN]
    for tag, kind, xs, ws, sf, ai in cases:
        x, w, delta, z = train_operands(xs, ws, g)
        cuda = train_calls(kind, x, w, delta, z, sf, ai, "cuda")
        plain = train_calls(kind, x, w, delta, z, sf, ai, "reference")
        fwd, gw = names[kind]
        what = f"{tag} x{xs} w{ws} alpha_inv={ai}"
        _pair(f"{fwd} {what}", cuda[0], plain[0], errs)
        _pair(f"{gw} {what} z*", cuda[1], plain[1], errs)
        if cuda[2] is not None:
            _pair(f"{gw} {what} no z*", cuda[2], plain[2], errs)
    for tag, kind, xs, ws, _, ai in cases:  # every digit path of #8
        if kind != "conv" or ai == 1:
            continue
        for what, x, delta, z in digit_operands(xs, ws, g):
            for zz, zt in ((z, "z*"), (None, "no z*")):
                call = [lambda b=b, x=x, d=delta, zz=zz: conv_grad_w(
                    x, d, kernel_size=ws[0], z_star=zz, alpha_inv=ai, backend=b)
                    for b in ("cuda", "reference")]
                _pair(f"stream_conv_grad_w {tag} x{xs} w{ws} {what} {zt} "
                      f"({digits_run(x, delta, zz, ai)})", *call, errs)
    from repro_torch.kernels.nitro_conv.ops import fused_conv_fwd
    for tag, kind, xs, ws, sf, ai in cases:  # every digit path of #7, and int8 x and w
        if kind != "conv" or tag.endswith("alpha_inv=1"):
            continue
        pairs = fwd_digit_operands(xs, ws, g)
        pairs.append(tuple(torch.randint(-128, 128, sh, generator=g).to(torch.int8).cuda()
                           for sh in (xs, ws)))
        for x, w in pairs:
            call = [lambda b=b, x=x, w=w: fused_conv_fwd(x, w, sf=sf, alpha_inv=ai, backend=b)
                    for b in ("cuda", "reference")]
            _pair(f"stream_conv_fwd {tag} x{xs} w{ws} {x.dtype}/{w.dtype} "
                  f"({fwd_digits_run(x, w)})", *call, errs)
    wide = (-(2 ** 31), 2 ** 31)  # int32 wrap in the grad_W accumulators
    x = torch.randint(*wide, (300, 40), generator=g).to(torch.int32).cuda()
    d = torch.randint(*wide, (300, 30), generator=g).to(torch.int32).cuda()
    z = torch.randint(-200, 200, (300, 30), generator=g).to(torch.int32).cuda()
    from repro_torch.kernels.nitro_matmul.ops import grad_w_matmul
    _pair("nitro_matmul_grad_w wide int32 (300,40)x(300,30)",
          lambda: grad_w_matmul(x, d, z, backend="cuda"),
          lambda: grad_w_matmul(x, d, z, backend="reference"), errs)


def opt_states(cfg):
    """(γ_inv, η_inv, α_inv) held in the update kernels' parity: the
    forward layers' state of a VGG8B run, the same after two plateaus
    (γ_inv ×9), γ_inv = 1 without decay, and the learning layers'."""
    af = 64 * cfg.num_classes
    return [(cfg.gamma_inv * af, cfg.eta_fw, 10), (cfg.gamma_inv * af * 9, cfg.eta_fw, 1),
            (1, 0, 1), (cfg.gamma_inv, cfg.eta_lr, 2)]


def opt_call(kind, x, w, delta, z, state, alpha_inv, backend):
    """One weight update (#4 or #9) through its dispatcher."""
    from repro_torch.kernels.nitro_conv.ops import conv_grad_w_opt
    from repro_torch.kernels.nitro_matmul.ops import grad_w_opt_matmul

    if kind == "conv":
        return lambda: conv_grad_w_opt(
            x, delta, w, state.gamma_inv, state.eta_inv, kernel_size=w.shape[0],
            z_star=z, alpha_inv=alpha_inv, backend=backend)
    return lambda: grad_w_opt_matmul(
        x, delta, z, w, state.gamma_inv, state.eta_inv, alpha_inv=alpha_inv,
        backend=backend)


def opt_parity(shapes, cfg, params, errs: dict) -> None:
    """Phase 3c: the update kernels vs their plain versions, bitwise: #4
    and #9 at every VGG8B training shape under each optimiser state of
    ``opt_states``, at ragged shapes, with a contraction deep enough to
    split and with full-range int32 operands; #11 on every VGG8B weight
    tensor (the seeded init) and on ragged and misaligned tensors."""
    import torch
    from repro_torch.core import optimizer as opt
    from repro_torch.kernels.integer_sgd.ops import apply_tree_fused

    g = torch.Generator().manual_seed(5)
    states = [(opt.init_state(gm, et, device="cuda"), ai) for gm, et, ai in opt_states(cfg)]
    names = {"conv": "stream_conv_grad_w_opt", "linear": "nitro_matmul_grad_w_opt"}
    cases = [(f"step {i}", kind, xs, ws) for i, (kind, xs, ws, _, _) in enumerate(shapes, 1)]
    cases += [("ragged", kind, xs, ws) for kind, xs, ws, _, _ in RAGGED_TRAIN]
    cases += [("deep", "linear", (4096, 300), (300, 70))]
    for tag, kind, xs, ws in cases:
        x, w, delta, z = train_operands(xs, ws, g)
        for state, ai in states:
            what = (f"{names[kind]} {tag} x{xs} w{ws} gamma_inv={int(state.gamma_inv)} "
                    f"eta_inv={int(state.eta_inv)} alpha_inv={ai}")
            _pair(what, opt_call(kind, x, w, delta, z, state, ai, "cuda"),
                  opt_call(kind, x, w, delta, z, state, ai, "reference"), errs)
    # #9 on every digit path, each call twice: the workspace and the
    # arrival counters (shared with #4) must come back zero, and #4 must
    # stay bitwise after #9's calls
    from repro_torch.kernels import cuda_lib
    for tag, kind, xs, ws in cases:
        if kind != "conv":
            continue
        _, w, _, _ = train_operands(xs, ws, g)
        for what, x, delta, z in digit_operands(xs, ws, g):
            for state, ai in (states[0], states[2]):
                for rep in (1, 2):
                    _pair(f"stream_conv_grad_w_opt {tag} x{xs} w{ws} {what} "
                          f"gamma_inv={int(state.gamma_inv)} alpha_inv={ai} call {rep} "
                          f"({digits_run(x, delta, z, ai)})",
                          opt_call(kind, x, w, delta, z, state, ai, "cuda"),
                          opt_call(kind, x, w, delta, z, state, ai, "reference"), errs)
        ws_sum, arrivals = cuda_lib.split_workspace(
            w.device, ws[0] * ws[1] * ws[2], ws[3], cuda_lib.DIGIT_TILE)
        if bool(ws_sum.any()) or bool(arrivals.any()):
            die(f"stream_conv_grad_w_opt {tag}: workspace or arrival counters "
                f"not left zero")
    x, w, delta, z = train_operands((4096, 300), (300, 70), g)
    for state, ai in states:
        _pair(f"nitro_matmul_grad_w_opt deep x(4096, 300) after stream_conv_grad_w_opt "
              f"calls gamma_inv={int(state.gamma_inv)} alpha_inv={ai}",
              opt_call("linear", x, w, delta, z, state, ai, "cuda"),
              opt_call("linear", x, w, delta, z, state, ai, "reference"), errs)
    print("[parity] stream_conv_grad_w_opt left its workspace and arrival counters "
          "zero after every digit path, twice each")
    wide = (-(2 ** 31), 2 ** 31)  # int32 wrap in the accumulator and the update
    for kind, xs, ws in (("linear", (300, 40), (40, 30)), ("linear", (2000, 40), (40, 30)),
                         ("conv", (2, 9, 7, 6), (3, 3, 6, 33))):
        x = torch.randint(*wide, xs, generator=g).to(torch.int32).cuda()
        w = torch.randint(*wide, ws, generator=g).to(torch.int32).cuda()
        out = (*xs[:-1], ws[-1])
        d = torch.randint(*wide, out, generator=g).to(torch.int32).cuda()
        z = torch.randint(-200, 200, out, generator=g).to(torch.int32).cuda()
        state, ai = states[2]
        _pair(f"{names[kind]} wide int32 x{xs} w{ws} gamma_inv=1",
              opt_call(kind, x, w, d, z, state, ai, "cuda"),
              opt_call(kind, x, w, d, z, state, ai, "reference"), errs)
    leaves = [b[k]["w"] for b in params["blocks"] for k in ("fw", "lr")]
    leaves.append(params["output"]["w"])
    trees = [({"w": w.cuda()}, f"VGG8B weight {tuple(w.shape)}") for w in leaves]
    for n in (1, 7, 129, 1_000_003):
        trees.append(({"w": torch.randint(*wide, (n,), generator=g).to(torch.int32).cuda()},
                      f"ragged ({n},) full range"))
    base = torch.randint(-9000, 9000, (1001,), generator=g).to(torch.int32).cuda()
    trees.append(({"w": base[1:]}, "misaligned (1000,) view"))
    for tree, what in trees:
        grads = {"w": torch.randint(*wide, tree["w"].shape, generator=g)
                 .to(torch.int32).cuda()}
        for state, _ in states:
            _pair(f"integer_sgd_update {what} gamma_inv={int(state.gamma_inv)} "
                  f"eta_inv={int(state.eta_inv)}",
                  lambda: apply_tree_fused(tree, grads, state, backend="cuda")["w"],
                  lambda: apply_tree_fused(tree, grads, state, backend="reference")["w"],
                  errs)
    sgd_tree_parity(params, states, g, errs)


def full_range(shape, g):
    """Full-range int32 on the card, INT32_MIN and INT32_MAX among them."""
    import torch

    t = torch.randint(*I32, shape, generator=g).to(torch.int32)
    t.view(-1)[:2] = torch.tensor([I32[0], I32[1] - 1], dtype=torch.int32)[:t.numel()]
    return t.cuda()


def sgd_groups(p, fw_state, lr_state, grad):
    """The fused apply's ``(params, grads, state)`` groups of the tree
    ``p`` on the card: each block's fw under ``fw_state``, its lr and the
    output layer under ``lr_state``; ``grad(shape)`` makes each gradient."""
    groups = [({"w": b[k]["w"].cuda()}, {"w": grad(b[k]["w"].shape)}, s)
              for b in p["blocks"] for k, s in (("fw", fw_state), ("lr", lr_state))]
    w = p["output"]["w"]
    groups.append(({"w": w.cuda()}, {"w": grad(w.shape)}, lr_state))
    return groups


def sgd_trees(params, g):
    """(what, weight shapes, which of two states each, expected launches)
    of the whole-tree #11 cases: VGG8B's (``params``) and mlp4's
    fused-apply trees (each block's fw under the first state, its lr and
    the output layer under the second), and 150 ragged tensors."""
    import torch
    from repro_torch.configs import get_paper_config
    from repro_torch.core import model as M
    from repro_torch.core import prng

    mlp4 = M.init_params(prng.PRNGKey(0), get_paper_config("mlp4", scale=1.0), device="cuda")
    out = []
    for arch, p in (("vgg8b", params), ("mlp4", mlp4)):
        shapes = [b[k]["w"].shape for b in p["blocks"] for k in ("fw", "lr")]
        shapes.append(p["output"]["w"].shape)
        which = [i % 2 for i in range(len(shapes) - 1)] + [1]
        out.append((f"{arch} tree", shapes, which, 1))
    sizes = [int(n) for n in torch.randint(1, 20_000, (150,), generator=g)]
    out.append(("150 ragged tensors", [(n,) for n in sizes], [i % 2 for i in range(150)], 3))
    return out


def sgd_tree_parity(params, states, g, errs: dict) -> None:
    """Phase 3c, #11 on whole trees: one ``apply_groups_fused`` call over
    every tensor of a tree ≡ the plain version, bitwise, under each
    optimiser state of ``opt_states`` (beside the next one), on full-range
    int32 W and g, with the launches each call must take; and a list that
    mixes aligned tensors with ``base[1:]`` views (the 4-byte path)."""
    import torch
    from repro_torch.kernels.integer_sgd import integer_sgd_update
    from repro_torch.kernels.integer_sgd.ops import apply_groups_fused

    def check(what, ws, gs, ss, launches):
        groups = [({"w": w}, {"w": gr}, s) for w, gr, s in zip(ws, gs, ss)]
        integer_sgd_update.launches.reset()
        got = [d["w"] for d in apply_groups_fused(groups, backend="cuda")]
        n = integer_sgd_update.launches.value
        want = [d["w"] for d in apply_groups_fused(groups, backend="reference")]
        torch.cuda.synchronize()
        if n != launches:
            die(f"integer_sgd_update {what}: {n} launches, expected {launches}")
        for a, b in zip(got, want):
            if a.dtype != b.dtype or a.shape != b.shape:
                die(f"integer_sgd_update {what}: {a.dtype}{tuple(a.shape)} vs plain "
                    f"{b.dtype}{tuple(b.shape)}")
        compare(f"integer_sgd_update {what} ({len(ws)} tensors, {launches} launch"
                f"{'es' if launches > 1 else ''})", torch.cat([a.flatten() for a in got]),
                torch.cat([b.flatten() for b in want]), errs)

    trees = sgd_trees(params, g)
    for i, (state, _) in enumerate(states):
        pair = (state, states[(i + 1) % len(states)][0])
        tag = "/".join(f"{int(s.gamma_inv)},{int(s.eta_inv)}" for s in pair)
        for what, shapes, which, launches in trees:
            ws = [full_range(sh, g) for sh in shapes]
            gs = [full_range(sh, g) for sh in shapes]
            check(f"{what} states {tag}", ws, gs, [pair[k] for k in which], launches)
        bases = [(full_range((n + 1,), g), full_range((n + 1,), g))
                 for n in (1, 3, 4, 5, 1001, 4096, 4097, 70_000, 300_001)]
        ws = [b[1:] if j % 2 else b[:-1] for j, (b, _) in enumerate(bases)]
        gs = [b[1:] if j % 3 else b[:-1] for j, (_, b) in enumerate(bases)]
        check(f"aligned beside base[1:] views states {tag}", ws, gs,
              [pair[j % 2] for j in range(len(ws))], 1)


RAGGED_GRAD_X = [  # (kind, x shape, w shape): C = 3, odd batches, F % 64 != 0
    ("conv", (3, 7, 9, 5), (3, 3, 5, 40)),
    ("conv", (2, 9, 7, 6), (5, 5, 6, 33)),
    ("conv", (5, 33, 31, 3), (3, 3, 3, 70)),
    ("conv", (1, 12, 90, 150), (3, 3, 150, 36)),
    ("linear", (5, 7), (7, 3)),
    ("linear", (33, 300), (300, 70)),
    ("linear", (1000, 20), (20, 10)),
]


def grad_x_call(kind, w, delta, z, alpha_inv, backend):
    """One input gradient (#5 or #10; #6 at sf=1 without z*) through its
    dispatcher."""
    from repro_torch.kernels.nitro_conv.ops import conv_grad_x
    from repro_torch.kernels.nitro_matmul.ops import grad_x_matmul

    if kind == "conv":
        return lambda: conv_grad_x(delta, w, z_star=z, alpha_inv=alpha_inv,
                                   backend=backend)
    return lambda: grad_x_matmul(delta, z, w, alpha_inv=alpha_inv, backend=backend)


def grad_x_digit_operands(kind, xs, ws, nd, nw, g):
    """(w, δ, z*) of one input-gradient shape whose masked δ needs ``nd``
    digits and w ``nw`` (their ranges' largest values planted first,
    INT32_MIN/MAX at four), z* over every NITRO-ReLU segment but 0 where
    the extremes sit, so the mask keeps them; drawn on the card from the
    CUDA generator ``g`` (VGG8B's δ have up to 16.8 M values)."""
    import torch

    def ints(shape, n):
        lim = DIGIT_LIMS[n]
        t = torch.randint(-lim, lim, shape, generator=g, device="cuda", dtype=torch.int64)
        t = t.to(torch.int32)
        if n == 4 and t.numel() >= 2:
            t.view(-1)[:2] = torch.tensor([I32[0], I32[1] - 1], dtype=torch.int32,
                                          device="cuda")
        elif t.numel():
            t.view(-1)[0] = lim - 1
        return t

    d_shape = (*xs[:-1], ws[-1])  # δ (N,H,W,F), or (B, N) against w (M, N)
    z = torch.randint(-300, 301, d_shape, generator=g, device="cuda").to(torch.int32)
    z.view(-1)[:2] = 0
    return ints(ws, nw), ints(d_shape, nd), z


def grad_x_digits_run(w, delta, z, alpha_inv) -> str:
    """The digit products #10 and #5 run at most on these operands (their
    pre-passes' rule, read here on the host for the report; #5's warps
    run fewer where their own w needs fewer digits)."""
    from repro_torch.kernels.digit_planes import digits_needed
    from repro_torch.kernels.nitro_matmul.ref import masked_delta

    nd, nw = digits_needed(masked_delta(delta, z, alpha_inv)), digits_needed(w)
    pairs = sum(1 for i in range(nd) for j in range(nw) if i + j < 4)
    return f"masked delta {nd} digits, w {nw} digits: {pairs} products"


def grad_x_parity(shapes, errs: dict) -> None:
    """Phase 3d: the input-gradient kernels vs their plain versions,
    bitwise: #10 and #5 at every VGG8B training shape, #5 at mlp4's
    linear shapes, and both at ragged shapes, at α_inv 10 (δ of ±2²⁰) and
    α_inv 1 (full-range int32 δ and w: the sums wrap); every digit path —
    masked δ and w of one to four digits, 16 variants, INT32_MIN/MAX
    planted at four — at each of those shapes, each kernel call twice
    (the same bits: a slot or arrival counter left wrong would show);
    then the arrival counters must be zero; and #6 at sf=1 without ReLU —
    the conv grad_x route without z* — at every VGG8B conv."""
    import torch
    from repro_torch.kernels import cuda_lib

    g = torch.Generator().manual_seed(7)
    gc = torch.Generator(device="cuda").manual_seed(7)
    wide = (-(2 ** 31), 2 ** 31)
    names = {"conv": "stream_conv_grad_x", "linear": "nitro_matmul_grad_x"}
    cases = [(f"step {i}", kind, xs, ws) for i, (kind, xs, ws, _, _) in enumerate(shapes, 1)]
    cases += [("mlp4", *sh) for sh in MLP4_SHAPES]
    cases += [("ragged", *sh) for sh in RAGGED_GRAD_X]
    for tag, kind, xs, ws in cases:
        _, w, delta, z = train_operands(xs, ws, g)
        full = [torch.randint(*wide, t.shape, generator=g).to(torch.int32).cuda()
                for t in (w, delta)]
        for (wt, dt), ai, rng in (((w, delta), 10, "delta +-2^20"),
                                  (full, 1, "full-range int32")):
            _pair(f"{names[kind]} {tag} x{xs} w{ws} alpha_inv={ai} {rng}",
                  grad_x_call(kind, wt, dt, z, ai, "cuda"),
                  grad_x_call(kind, wt, dt, z, ai, "reference"), errs)
        if kind == "conv" and tag.startswith("step"):
            _pair(f"stream_conv sf=1 grad_x without z* {tag} x{xs} w{ws}",
                  grad_x_call(kind, full[0], full[1], None, 1, "cuda"),
                  grad_x_call(kind, full[0], full[1], None, 1, "reference"), errs)
        for nd, nw in [(nd, nw) for nd in DIGIT_LIMS for nw in DIGIT_LIMS]:
            wt, dt, zt = grad_x_digit_operands(kind, xs, ws, nd, nw, gc)
            what = f"{tag} x{xs} w{ws} ({grad_x_digits_run(wt, dt, zt, 10)})"
            want = grad_x_call(kind, wt, dt, zt, 10, "reference")()
            for rep in (1, 2):
                got = grad_x_call(kind, wt, dt, zt, 10, "cuda")()
                torch.cuda.synchronize()
                compare(f"{names[kind]} {what} call {rep}", got, want, errs)
    _, arrivals = cuda_lib.split_workspace(torch.device("cuda", torch.cuda.current_device()),
                                           1000, 3072)
    if bool(arrivals.any()):
        die("nitro_matmul_grad_x left an arrival counter non-zero")
    print("[parity] stream_conv_grad_x / nitro_matmul_grad_x: every digit path at every "
          "main-path and ragged shape, twice each; arrival counters left zero")


def no_sync_phase(steps, shapes, cfg, params, errs: dict) -> None:
    """Phase 3e: each forward conv and matmul kernel, each linear grad_W
    kernel and each input-gradient kernel called once at each main-path
    shape (#6 and #1 at the serving steps' inputs, #7 and #2 at int32
    training operands, #2, #3 and #4 at VGG8B's linear and mlp4's shapes,
    #4 with the optimiser state's tensors, #10 at VGG8B's convs and #5 at
    its linear and mlp4's shapes), and #11 as the VGG8B fused apply (its 15
    tensors under the forward and learning layers' states), with
    ``torch.cuda.set_sync_debug_mode("error")``: its wrapper must not
    synchronise with the host (the digit counts are read on the card).
    The outputs are then held against the plain versions."""
    import torch
    from repro_torch.core import optimizer as opt
    from repro_torch.core.scaling import linear_scale_factor
    from repro_torch.kernels.nitro_matmul.nitro_matmul import (
        nitro_matmul_grad_w, nitro_matmul_grad_w_opt)
    from repro_torch.kernels.nitro_matmul.ref import (
        nitro_matmul_grad_w_opt_ref, nitro_matmul_grad_w_ref)
    from repro_torch.kernels.nitro_conv.nitro_conv import stream_conv, stream_conv_fwd
    from repro_torch.kernels.nitro_conv.ref import stream_conv_fwd_ref, stream_conv_ref
    from repro_torch.kernels.nitro_matmul.nitro_matmul import nitro_matmul, nitro_matmul_fwd
    from repro_torch.kernels.nitro_matmul.ref import nitro_matmul_fwd_ref, nitro_matmul_ref
    from repro_torch.kernels.nitro_conv.nitro_conv import stream_conv_grad_x
    from repro_torch.kernels.nitro_conv.ref import stream_conv_grad_x_ref
    from repro_torch.kernels.nitro_matmul.nitro_matmul import nitro_matmul_grad_x
    from repro_torch.kernels.nitro_matmul.ref import nitro_matmul_grad_x_ref

    g = torch.Generator().manual_seed(9)
    calls = []
    for meta, x, w in steps:
        if meta.kind == "conv":
            kw = dict(sf=meta.sf, alpha_inv=meta.alpha_inv, apply_relu=meta.apply_relu,
                      pool=meta.pool, operand_dtype=meta.operand_dtype,
                      out_dtype=torch.int8 if meta.out_dtype == "int8" else torch.int32)
            calls.append((f"stream_conv x{tuple(x.shape)} {x.dtype}",
                          lambda x=x, w=w, kw=kw: stream_conv(x, w, **kw),
                          lambda x=x, w=w, kw=kw: stream_conv_ref(x, w, **kw)))
        else:  # the served linears: #1 on int8 operands
            kw = dict(sf=meta.sf, alpha_inv=meta.alpha_inv, apply_relu=meta.apply_relu,
                      operand_dtype=meta.operand_dtype,
                      out_dtype=torch.int8 if meta.out_dtype == "int8" else torch.int32)
            xm, wm = (x.to(torch.int8), w.to(torch.int8)) if meta.operand_dtype == "int8" \
                else (x, w)
            calls.append((f"nitro_matmul x{tuple(x.shape)} {xm.dtype}",
                          lambda x=xm, w=wm, kw=kw: nitro_matmul(x, w, **kw),
                          lambda x=xm, w=wm, kw=kw: nitro_matmul_ref(x, w, **kw)))
    linears = [(xs, ws, sf, ai) for kind, xs, ws, sf, ai in shapes if kind == "linear"]
    linears += [(xs, ws, linear_scale_factor(xs[1]), 10) for _, xs, ws in MLP4_SHAPES]
    for kind, xs, ws, sf, ai in shapes:
        if kind == "conv":
            x, w, _, _ = train_operands(xs, ws, g)
            calls.append((f"stream_conv_fwd x{xs} int32",
                          lambda x=x, w=w, sf=sf, ai=ai: stream_conv_fwd(x, w, sf=sf, alpha_inv=ai),
                          lambda x=x, w=w, sf=sf, ai=ai: stream_conv_fwd_ref(x, w, sf=sf,
                                                                              alpha_inv=ai)))
    for xs, ws, sf, ai in linears:  # #2 at VGG8B's linear and mlp4's layers
        x, w, _, _ = train_operands(xs, ws, g)
        calls.append((f"nitro_matmul_fwd x{xs} int32",
                      lambda x=x, w=w, sf=sf, ai=ai: nitro_matmul_fwd(x, w, sf=sf, alpha_inv=ai),
                      lambda x=x, w=w, sf=sf, ai=ai: nitro_matmul_fwd_ref(x, w, sf=sf,
                                                                           alpha_inv=ai)))
    state = opt.init_state(327680, 25000, device="cuda")
    for b, m, n in GRAD_W_SHAPES:  # #3 and #4 at the main path's digits
        x, delta, z = grad_w_operands(b, m, n, 1, 2, g)
        w = torch.randint(-(2 ** 15), 2 ** 15, (m, n), generator=g).to(torch.int32).cuda()
        calls.append((f"nitro_matmul_grad_w x({b}, {m}) delta({b}, {n})",
                      lambda x=x, d=delta, z=z: nitro_matmul_grad_w(x, d, z),
                      lambda x=x, d=delta, z=z: nitro_matmul_grad_w_ref(x, d, z)))
        calls.append((f"nitro_matmul_grad_w_opt x({b}, {m}) delta({b}, {n})",
                      lambda x=x, d=delta, z=z, w=w: nitro_matmul_grad_w_opt(
                          x, d, z, w, state.gamma_inv, state.eta_inv),
                      lambda x=x, d=delta, z=z, w=w: nitro_matmul_grad_w_opt_ref(
                          x, d, z, w, state.gamma_inv, state.eta_inv)))
    for xs, ws, _, ai in linears:  # #5 at VGG8B's linear and mlp4's layers
        _, w, delta, z = train_operands(xs, ws, g)
        calls.append((f"nitro_matmul_grad_x delta{tuple(delta.shape)} w{ws}",
                      lambda w=w, d=delta, z=z, ai=ai: nitro_matmul_grad_x(d, z, w, alpha_inv=ai),
                      lambda w=w, d=delta, z=z, ai=ai: nitro_matmul_grad_x_ref(d, z, w,
                                                                               alpha_inv=ai)))
    for kind, xs, ws, _, ai in shapes:  # #10 at VGG8B's convs
        if kind == "conv":
            _, w, delta, z = train_operands(xs, ws, g)
            calls.append((f"stream_conv_grad_x delta{tuple(delta.shape)} w{ws}",
                          lambda w=w, d=delta, z=z, ai=ai: stream_conv_grad_x(d, z, w,
                                                                              alpha_inv=ai),
                          lambda w=w, d=delta, z=z, ai=ai: stream_conv_grad_x_ref(
                              d, w, z_star=z, alpha_inv=ai)))
    from repro_torch.kernels.integer_sgd.ops import apply_groups_fused

    (fw, eta_fw, _), _, _, (lr, eta_lr, _) = opt_states(cfg)
    sgd = {"fw": opt.init_state(fw, eta_fw, device="cuda"),
           "lr": opt.init_state(lr, eta_lr, device="cuda")}
    groups = sgd_groups(params, sgd["fw"], sgd["lr"], lambda shape: full_range(shape, g))
    calls.append(("integer_sgd_update VGG8B fused apply of 15 tensors",
                  lambda: tuple(d["w"] for d in apply_groups_fused(groups, backend="cuda")),
                  lambda: tuple(d["w"] for d in apply_groups_fused(groups,
                                                                   backend="reference"))))
    torch.cuda.synchronize()
    outs = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for what, kernel_fn, _ in calls:
            outs.append(kernel_fn())
    except RuntimeError as e:
        die(f"{what}: the wrapper synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for (what, _, plain_fn), got in zip(calls, outs):
        _pair(f"{what} (called under sync debug mode 'error')", lambda got=got: got,
              plain_fn, errs)
    print(f"[no-sync] {len(calls)} calls of stream_conv / stream_conv_fwd / nitro_matmul / "
          f"nitro_matmul_fwd / nitro_matmul_grad_w / nitro_matmul_grad_w_opt / "
          f"nitro_matmul_grad_x / stream_conv_grad_x / integer_sgd_update ran under "
          f"torch.cuda.set_sync_debug_mode('error') without a host sync")


#: the matmul kernels' main-path shapes (M, K, N): the served linear and
#: output layer (int8 operands, batch 32), VGG8B's training linear and
#: mlp4's two layer shapes (int32 operands, batch 64)
MATMUL_SHAPES = [((BATCH, 2048, 1024), "int8"), ((BATCH, 1024, 10), "int8"),
                 ((TRAIN_BATCH, 2048, 1024), "int32"), ((TRAIN_BATCH, 3072, 3000), "int32"),
                 ((TRAIN_BATCH, 3000, 3000), "int32")]
#: ragged matmul shapes: M ∈ {1, 3, 33, 65, 1000}, K not a multiple of 16
#: or deep enough for three splits of at most 16,384, N = 10 and ragged
RAGGED_MATMUL = [(1, 7, 10), (3, 100, 10), (33, 300, 70), (65, 130, 67), (1000, 20, 10),
                 (3, 40000, 10), (33, 2050, 130)]


def matmul_digits_run(x, w) -> str:
    """The digit products the matmul kernels run on x and w (their
    pre-passes' rule, read here on the host for the report)."""
    return fwd_digits_run(x, w)


def matmul_digit_parity(errs: dict) -> None:
    """Phase 3f: #1 and #2 (split-K over exact digits) vs their plain
    versions, bitwise, on every digit path — x and w of one to four digits,
    16 variants, INT32_MIN/MAX planted at four — at every main-path shape
    and the ragged ones, each case called twice (a slot, map or arrival
    counter left wrong would show on the second call); #1 on int8 operands
    at every shape, also with an int8 x whose rows are not 16-byte aligned
    (the x pre-pass) and with a K that is not a multiple of 16; #2 on w
    with one 64×64 tile of four digits among one-digit tiles (the tile
    map's zero-filled planes); then the arrival counters must be zero."""
    import torch
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.nitro_matmul.nitro_matmul import nitro_matmul, nitro_matmul_fwd
    from repro_torch.kernels.nitro_matmul.ref import nitro_matmul_fwd_ref, nitro_matmul_ref

    g = torch.Generator().manual_seed(10)

    def ints(shape, nd):
        lim = DIGIT_LIMS[nd]
        t = torch.randint(-lim, lim, shape, generator=g, dtype=torch.int64).to(torch.int32)
        if nd == 4 and t.numel() >= 2:
            t.view(-1)[:2] = torch.tensor([I32[0], I32[1] - 1], dtype=torch.int32)
        return t.cuda()

    def int8s(shape):
        return torch.randint(-128, 128, shape, generator=g).to(torch.int8).cuda()

    cases = [("step", sh) for sh, _ in MATMUL_SHAPES] + [("ragged", sh) for sh in RAGGED_MATMUL]
    for tag, (m, k, n) in cases:
        sf = 3 << 9
        for nx, nw in [(nx, nw) for nx in DIGIT_LIMS for nw in DIGIT_LIMS]:
            x, w = ints((m, k), nx), ints((k, n), nw)
            relu = (nx + nw) % 2 == 0  # the ReLU and the out dtype vary with the path
            kw = dict(sf=sf, apply_relu=relu, out_dtype=torch.int8 if relu else torch.int32)
            what = f"{tag} ({m},{k},{n}) ({matmul_digits_run(x, w)})"
            for rep in (1, 2):
                _pair(f"nitro_matmul_fwd {what} call {rep}",
                      lambda: nitro_matmul_fwd(x, w, sf=sf), lambda: nitro_matmul_fwd_ref(x, w, sf=sf),
                      errs)
                _pair(f"nitro_matmul int32 operands {what} relu={relu} call {rep}",
                      lambda: nitro_matmul(x, w, **kw), lambda: nitro_matmul_ref(x, w, **kw), errs)
        x8, w8 = int8s((m, k)), int8s((k, n))
        for relu, out in ((True, torch.int8), (False, torch.int32)):
            kw = dict(sf=sf, apply_relu=relu, out_dtype=out, operand_dtype="int8")
            for rep in (1, 2):
                _pair(f"nitro_matmul int8 operands {tag} ({m},{k},{n}) relu={relu} call {rep}",
                      lambda: nitro_matmul(x8, w8, **kw), lambda: nitro_matmul_ref(x8, w8, **kw),
                      errs)
        buf = int8s((m * k + 1,))
        xo = buf[1:].view(m, k)  # rows 1 byte off 16-byte alignment
        kw = dict(sf=sf, out_dtype=torch.int8, operand_dtype="int8")
        _pair(f"nitro_matmul int8 operands {tag} ({m},{k},{n}) x misaligned",
              lambda: nitro_matmul(xo, w8, **kw), lambda: nitro_matmul_ref(xo, w8, **kw), errs)
        x = torch.randint(-127, 128, (m, k), generator=g).to(torch.int32).cuda()
        w = torch.randint(-4, 5, (k, n), generator=g).to(torch.int32).cuda()
        w[k // 2, n // 2] = I32[0]
        for rep in (1, 2):
            _pair(f"nitro_matmul_fwd {tag} ({m},{k},{n}) one tile of w with 4 digits call {rep}",
                  lambda: nitro_matmul_fwd(x, w, sf=sf), lambda: nitro_matmul_fwd_ref(x, w, sf=sf),
                  errs)
    _, arrivals = cuda_lib.split_workspace(torch.device("cuda", torch.cuda.current_device()),
                                           1000, 3000)
    if bool(arrivals.any()):
        die("nitro_matmul / nitro_matmul_fwd left an arrival counter non-zero")
    print("[parity] nitro_matmul / nitro_matmul_fwd: every digit path at every main-path "
          "and ragged shape, twice each; arrival counters left zero")


#: (B, M, N) of the linear grad_W kernels: the main path's (VGG8B's linear,
#: mlp4's two layer shapes) and ragged ones (batches of 1 and 3, shorter
#: than one MMA step, and of 16,385: 257 chunks; M and N off the 128 × 64
#: tile)
GRAD_W_SHAPES = [(TRAIN_BATCH, 2048, 1024), (TRAIN_BATCH, 3072, 3000),
                 (TRAIN_BATCH, 3000, 3000)]
RAGGED_GRAD_W = [(1, 63, 65), (3, 129, 1), (33, 65, 129), (16385, 65, 63), (5, 7, 3),
                 (1000, 20, 10)]


def grad_w_operands(b, m, n, nx, nd, g):
    """x (B, M) of ``nx`` digits, δ and z* (B, N) whose masked δ needs
    ``nd`` digits: the ranges' largest values planted first (INT32_MIN/MAX
    at four), z* over every NITRO-ReLU segment but 0 where they sit, so
    the mask keeps them."""
    import torch

    def ints(shape, nd):
        lim = DIGIT_LIMS[nd]
        t = torch.randint(-lim, lim, shape, generator=g, dtype=torch.int64).to(torch.int32)
        if nd == 4 and t.numel() >= 2:
            t.view(-1)[:2] = torch.tensor([I32[0], I32[1] - 1], dtype=torch.int32)
        elif t.numel():
            t.view(-1)[0] = lim - 1
        return t.cuda()

    z = torch.randint(-300, 301, (b, n), generator=g).to(torch.int32)
    z.view(-1)[:2] = 0
    return ints((b, m), nx), ints((b, n), nd), z.cuda()


def grad_w_digits_run(x, delta, z, alpha_inv) -> str:
    """The digit products the linear grad_W kernels run at most on these
    operands (a tile whose own values need fewer runs fewer; the rule of
    their block-wide counts, read here on the host for the report)."""
    from repro_torch.kernels.digit_planes import digits_needed
    from repro_torch.kernels.nitro_matmul.ref import masked_delta

    nx, nd = digits_needed(x), digits_needed(masked_delta(delta, z, alpha_inv))
    pairs = sum(1 for i in range(nx) for j in range(nd) if i + j < 4)
    return f"x {nx} digits, masked delta {nd} digits: {pairs} products"


def grad_w_digit_parity(errs: dict) -> None:
    """Phase 3g: #3 and #4 (a shallow GEMM over exact digits on the int8
    tensor cores) vs their plain versions, bitwise, on every digit path —
    x and masked δ of one to four digits, 16 variants, INT32_MIN/MAX
    planted at four — at every main-path shape and the ragged ones, each
    case twice (the same bits); #4 under two optimiser states (the
    forward layers' of a VGG8B run, and γ_inv = 1 without decay) with W
    of the full int32 range; then α_inv 1 and 2."""
    import torch
    from repro_torch.core import optimizer as opt
    from repro_torch.kernels.nitro_matmul.nitro_matmul import (
        nitro_matmul_grad_w, nitro_matmul_grad_w_opt)
    from repro_torch.kernels.nitro_matmul.ref import (
        nitro_matmul_grad_w_opt_ref, nitro_matmul_grad_w_ref)

    g = torch.Generator().manual_seed(11)
    states = [opt.init_state(327680, 25000, device="cuda"), opt.init_state(1, 0, device="cuda")]
    cases = [("step", sh) for sh in GRAD_W_SHAPES] + [("ragged", sh) for sh in RAGGED_GRAD_W]
    for tag, (b, m, n) in cases:
        w = torch.randint(*I32, (m, n), generator=g, dtype=torch.int64).to(torch.int32).cuda()
        for nx, nd in [(nx, nd) for nx in DIGIT_LIMS for nd in DIGIT_LIMS]:
            x, delta, z = grad_w_operands(b, m, n, nx, nd, g)
            state = states[(nx + nd) % 2]
            what = f"{tag} ({b},{m})->{n} ({grad_w_digits_run(x, delta, z, 10)})"
            for rep in (1, 2):
                _pair(f"nitro_matmul_grad_w {what} call {rep}",
                      lambda: nitro_matmul_grad_w(x, delta, z, alpha_inv=10),
                      lambda: nitro_matmul_grad_w_ref(x, delta, z, alpha_inv=10), errs)
                _pair(f"nitro_matmul_grad_w_opt {what} gamma_inv={int(state.gamma_inv)} "
                      f"eta_inv={int(state.eta_inv)} call {rep}",
                      lambda: nitro_matmul_grad_w_opt(x, delta, z, w, state.gamma_inv,
                                                      state.eta_inv, alpha_inv=10),
                      lambda: nitro_matmul_grad_w_opt_ref(x, delta, z, w, state.gamma_inv,
                                                          state.eta_inv, alpha_inv=10), errs)
        x, delta, z = grad_w_operands(b, m, n, 4, 4, g)
        for ai in (1, 2):
            _pair(f"nitro_matmul_grad_w {tag} ({b},{m})->{n} full range alpha_inv={ai}",
                  lambda: nitro_matmul_grad_w(x, delta, z, alpha_inv=ai),
                  lambda: nitro_matmul_grad_w_ref(x, delta, z, alpha_inv=ai), errs)
    print("[parity] nitro_matmul_grad_w / nitro_matmul_grad_w_opt: every digit path at every "
          "main-path and ragged shape, twice each")


def _trees(state, metrics):
    """Every tensor of a TrainState and its step metrics, named."""
    out = {"step": state.step}
    for i, b in enumerate(state.params["blocks"]):
        out[f"blocks.{i}.fw"] = b["fw"]["w"]
        out[f"blocks.{i}.lr"] = b["lr"]["w"]
    out["output"] = state.params["output"]["w"]
    for grp in ("opt_lr", "opt_fw"):
        for f, v in getattr(state, grp)._asdict().items():
            out[f"{grp}.{f}"] = v
    for i, m in enumerate(metrics):
        for f, v in m._asdict().items():
            out[f"step{i}.{f}"] = v
    return out


TRAIN_ARGV = ["--arch", "vgg8b", "--steps", str(TRAIN_STEPS),
              "--batch", str(TRAIN_BATCH), "--seed", "0"]


def same_run(got_state, got_metrics, want_state, want_metrics, what: str) -> int:
    """Die unless two runs' TrainStates and step metrics are bitwise equal;
    returns the number of tensors compared."""
    import torch

    got, exp = _trees(got_state, got_metrics), _trees(want_state, want_metrics)
    if got.keys() != exp.keys():
        die(f"{what}: state trees differ: {sorted(got)} vs {sorted(exp)}")
    for name in got:
        a, b = got[name], exp[name]
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            die(f"{what}: {name} differs")
    return len(got)


def expect_launches(launches: dict, per_step: dict, steps: int, what: str) -> None:
    want = {k: per_step.get(k, 0) * steps for k in launches}
    if steps != TRAIN_STEPS or launches != want:
        die(f"{what}: expected {want} over {TRAIN_STEPS} steps, got {launches} "
            f"over {steps}")


def train_path():
    """Phase 5: the port's train CLI at full width, counted, held against
    the same run on the plain versions."""
    from repro_torch.launch import train

    int_counter = int_matmul_counter()
    int_counter.reset()
    res, launches = counted(lambda: train.main(TRAIN_ARGV))
    n_int = int_counter.value
    print(f"[train] {res['steps']} steps, launches {launches}, int_matmul {n_int} "
          f"({n_int / res['steps']:g} a step)")
    expect_launches(launches, PER_STEP, res["steps"], "split run")
    if n_int == 0:
        die("split run: no int_matmul launch (the learning and output layers' products)")
    launches["int_matmul"] = n_int
    ref = train.main(TRAIN_ARGV + ["--backend", "reference"])
    n = same_run(res["state"], res["step_metrics"], ref["state"], ref["step_metrics"],
                 "cuda run vs reference run")
    if res["test_accuracy"] != ref["test_accuracy"]:
        die(f"test accuracy {res['test_accuracy']} != reference {ref['test_accuracy']}")
    print(f"[train] final state, {n} tensors incl. every step's metrics, "
          f"equals the reference backend's bitwise; test accuracy "
          f"{res['test_accuracy']:.4f}, scaled loss {res['scaled_loss']:.4f}")
    return res, ref, launches


def fuse_opt_path(split):
    """Phase 5b: the train CLI with --fuse-opt, counted, held against the
    split run of phase 5 (same seed and data)."""
    from repro_torch.launch import train

    res, launches = counted(lambda: train.main(TRAIN_ARGV + ["--fuse-opt"]))
    print(f"[train-fuse-opt] {res['steps']} steps, launches {launches}")
    expect_launches(launches, PER_STEP_FUSE_OPT, res["steps"], "fuse_opt run")
    n = same_run(res["state"], res["step_metrics"], split["state"], split["step_metrics"],
                 "fuse_opt run vs split run")
    if res["test_accuracy"] != split["test_accuracy"]:
        die(f"fuse_opt test accuracy {res['test_accuracy']} != split "
            f"{split['test_accuracy']}")
    print(f"[train-fuse-opt] final state, {n} tensors incl. every step's metrics, "
          f"and the test accuracy {res['test_accuracy']:.4f} equal the split run's "
          f"bitwise")
    return res, launches


def cli_batches():
    """The config and the (x, y, key) of each step of the phase 5 CLI run:
    its dataset, its first epoch's batches and ``PRNGKey(step)``."""
    import itertools

    import torch
    from repro_torch.configs import get_paper_config
    from repro_torch.core import prng
    from repro_torch.data import synthetic

    ds = synthetic.make_image_dataset("tiles32", n_train=4096, n_test=512, seed=0)
    cfg = get_paper_config("vgg8b", scale=1.0, input_shape=ds.input_shape)
    pairs = itertools.islice(synthetic.batches(ds.x_train, ds.y_train, TRAIN_BATCH, seed=0),
                             TRAIN_STEPS)
    return cfg, [(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda(), prng.PRNGKey(it))
                 for it, (x, y) in enumerate(pairs)]


def fused_apply_path(split):
    """Phase 5c: compute_gradients then apply_gradients(fuse_opt=True) on
    the CLI run's batches and keys, counted, held against the split run."""
    from repro_torch.core import les, prng

    cfg, steps = cli_batches()

    def run():
        state, metrics = les.create_train_state(prng.PRNGKey(0), cfg, device="cuda"), []
        for x, y, key in steps:
            grads, m, _ = les.compute_gradients(state, cfg, x, y, key)
            state = les.apply_gradients(state, grads, fuse_opt=True)
            metrics.append(m)
        return state, metrics

    (state, metrics), launches = counted(run)
    print(f"[train-fused-apply] {len(metrics)} steps, launches {launches}")
    expect_launches(launches, PER_STEP_FUSED_APPLY, len(metrics), "fused apply")
    n = same_run(state, metrics, split["state"], split["step_metrics"],
                 "fused apply vs split run")
    print(f"[train-fused-apply] final state, {n} tensors incl. every step's "
          f"metrics, equals the split run's bitwise")
    return launches


def _same(what: str, got, want) -> None:
    import torch

    if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(got, want):
        die(f"{what} differs")


def grad_x_path():
    """Phase 5d: the grad_x path at full width, counted, held against the
    same calls on the plain versions and against compute_gradients."""
    from repro_torch.core import blocks as B
    from repro_torch.core import layers, les, prng
    from repro_torch.core import model as M
    from repro_torch.core.losses import one_hot_int

    cfg, steps = cli_batches()
    x, y, key = steps[0]
    state = les.create_train_state(prng.PRNGKey(0), cfg, device="cuda")
    params = state.params
    _, acts, caches, _ = M.forward(params, cfg, x, train=True, key=key)
    y1 = one_hot_int(y, cfg.num_classes)
    deltas = []
    for spec, p, a_l, cache in zip(cfg.blocks, params["blocks"], acts, caches):
        y_hat_l, lr_cache = B.learning_layers(p, spec, a_l)
        delta_fw, _ = B.learning_layers_backward(p, spec, lr_cache,
                                                 B.local_gradient(y_hat_l, y1))
        deltas.append(B.forward_layers_delta(cache, delta_fw))

    def passes(backend):
        out = []
        for spec, p, cache, g in zip(cfg.blocks, params["blocks"], caches, deltas):
            kw = dict(z_star=cache["z_star"], alpha_inv=spec.alpha_inv, backend=backend)
            if spec.kind == "conv":
                gx, gw = layers.conv_backward(p["fw"], cache["conv"], g, **kw)
                ux, new = layers.conv_update(p["fw"], cache["conv"], g, state.opt_fw, **kw)
            else:
                gx, gw = layers.linear_backward(p["fw"], cache["linear"], g, **kw)
                ux, new = layers.linear_update(p["fw"], cache["linear"], g,
                                               state.opt_fw, **kw)
            out.append((gx, gw["w"], ux, new["w"]))
        return out

    got, launches = counted(lambda: passes("cuda"))
    print(f"[grad-x] {len(cfg.blocks)} blocks, backward + update, launches {launches}")
    want = {k: PER_GRAD_X_PASS.get(k, 0) for k in launches}
    if launches != want:
        die(f"grad_x path: expected {want}, got {launches}")
    ref = passes("reference")
    grads, _, _ = les.compute_gradients(state, cfg, x, y, key)
    for i, (g4, r4, gb) in enumerate(zip(got, ref, grads.blocks)):
        for what, a, b in zip(("grad_x", "grad_W", "update grad_x", "W'"), g4, r4):
            _same(f"grad_x path block {i} {what} vs reference", a, b)
        _same(f"grad_x path block {i} grad_W vs compute_gradients", g4[1], gb["fw"]["w"])
        _same(f"grad_x path block {i} grad_x of backward vs update", g4[0], g4[2])
    shapes = [tuple(g4[0].shape) for g4 in got]
    print(f"[grad-x] every grad_x {shapes}, grad_W and W' equals the reference "
          f"backend's bitwise; grad_W equals compute_gradients'")
    return launches


MLP_ARGV = ["--arch", "mlp4", "--dataset", "tiles32", "--steps", str(TRAIN_STEPS),
            "--batch", str(TRAIN_BATCH), "--seed", "0"]


def mlp_path():
    """Phase 5e: the train CLI on full-width mlp4, counted, held against the
    same run on the plain versions."""
    from repro_torch.launch import train

    res, launches = counted(lambda: train.main(MLP_ARGV))
    print(f"[train-mlp4] {res['steps']} steps, launches {launches}")
    expect_launches(launches, PER_STEP_MLP, res["steps"], "mlp4 run")
    ref = train.main(MLP_ARGV + ["--backend", "reference"])
    n = same_run(res["state"], res["step_metrics"], ref["state"], ref["step_metrics"],
                 "mlp4 cuda run vs reference run")
    if res["test_accuracy"] != ref["test_accuracy"]:
        die(f"mlp4 test accuracy {res['test_accuracy']} != reference "
            f"{ref['test_accuracy']}")
    print(f"[train-mlp4] final state, {n} tensors incl. every step's metrics, equals "
          f"the reference backend's bitwise; test accuracy {res['test_accuracy']:.4f}")
    return res, ref


def mlp_fuse_opt_path(mlp_ref):
    """Phase 5g: the train CLI on full-width mlp4 with --fuse-opt, counted
    (3 nitro_matmul_grad_w_opt launches a step, no split grad_W), held
    against the split run on the plain versions of phase 5e (fuse_opt ≡
    split bitwise: the floor of an exact int32 sum is exact)."""
    from repro_torch.launch import train

    res, launches = counted(lambda: train.main(MLP_ARGV + ["--fuse-opt"]))
    print(f"[train-mlp4-fuse-opt] {res['steps']} steps, launches {launches}")
    expect_launches(launches, PER_STEP_MLP_FUSE_OPT, res["steps"], "mlp4 fuse_opt run")
    n = same_run(res["state"], res["step_metrics"], mlp_ref["state"], mlp_ref["step_metrics"],
                 "mlp4 fuse_opt cuda run vs reference run")
    if res["test_accuracy"] != mlp_ref["test_accuracy"]:
        die(f"mlp4 fuse_opt test accuracy {res['test_accuracy']} != reference "
            f"{mlp_ref['test_accuracy']}")
    print(f"[train-mlp4-fuse-opt] final state, {n} tensors incl. every step's metrics, and "
          f"the test accuracy equal the reference backend's bitwise")


def resume_path():
    """Phase 5f: two CLI calls of 2 VGG8B steps sharing a --ckpt-dir, the
    second resuming, on the kernels and on the plain versions; and a
    save → restore round trip of the card's TrainState."""
    import tempfile

    from repro_torch.launch import train
    from repro_torch.train import checkpoint as ckpt

    argv = ["--arch", "vgg8b", "--steps", "2", "--batch", str(TRAIN_BATCH), "--seed", "0"]
    with tempfile.TemporaryDirectory(prefix="nitro_ckpt_") as d:
        runs = {}
        for backend in ("cuda", "reference"):
            call = argv + ["--backend", backend, "--ckpt-dir", f"{d}/{backend}"]
            first = train.main(call)
            second = train.main(call)
            if first["start_step"] != 0 or second["start_step"] != 2 or \
                    int(second["state"].step) != 4:
                die(f"{backend} resume: start steps {first['start_step']}, "
                    f"{second['start_step']}, final step {int(second['state'].step)}")
            runs[backend] = second
        n = same_run(runs["cuda"]["state"], runs["cuda"]["step_metrics"],
                     runs["reference"]["state"], runs["reference"]["step_metrics"],
                     "resumed cuda run vs resumed reference run")
        state = runs["cuda"]["state"]
        ckpt.save(f"{d}/round_trip", 4, state)
        back, step = ckpt.restore(f"{d}/round_trip", state)
        flat, flat_back = ckpt.flatten_with_paths(state), ckpt.flatten_with_paths(back)
        for (p, a), (q, b) in zip(flat, flat_back, strict=True):
            if p != q or a.device != b.device:
                die(f"round trip: {p} on {a.device} came back as {q} on {b.device}")
            _same(f"round trip {p}", b, a)
    print(f"[resume] second call resumed from step 2; final state after 4 steps, "
          f"{n} tensors incl. the resumed steps' metrics, equals the reference "
          f"backend's bitwise; save -> restore of the card's TrainState ({len(flat)} "
          f"leaves, step {step}) is bitwise")


# ---------------------------------------------------------------------------
# Phase 6: observability at full width
# ---------------------------------------------------------------------------

OBS_TRAIN_KW = dict(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seed=0, device="cuda")


def counted_steps(fn):
    """``(fn(), launches, per_step)``: ``counted``'s totals and, for every
    ``les.train_step`` call inside ``fn``, its telemetry flag and the
    launches it made."""
    from repro_torch.core import les

    counters = launch_counters()
    real = les.train_step
    per_step = []

    def step(*args, **kw):
        before = {k: c.value for k, c in counters.items()}
        out = real(*args, **kw)
        per_step.append((bool(kw.get("telemetry")),
                         {k: c.value - before[k] for k, c in counters.items()
                          if c.value != before[k]}))
        return out

    les.train_step = step
    try:
        out, launches = counted(fn)
    finally:
        les.train_step = real
    return out, launches, per_step


def expect_step_launches(per_step, want, what: str) -> None:
    """Die unless step i launched ``want(i)`` (nonzero entries) and was
    sampled as ``want`` says."""
    for i, (sampled, got) in enumerate(per_step):
        exp_sampled, exp = want(i)
        if sampled != exp_sampled or got != exp:
            die(f"{what}: step {i} (telemetry={sampled}) launched {got}, expected "
                f"{exp} with telemetry={exp_sampled}")


class scrape_at_close:
    """While active, a ``MetricsServer`` answers one ``/metrics`` and one
    ``/healthz`` request over HTTP just before it closes; the bodies land
    in ``seen``."""

    def __init__(self, seen: dict):
        self.seen = seen

    def __enter__(self):
        from urllib.request import urlopen

        from repro_torch.obs.metrics import MetricsServer

        self.real = real = MetricsServer.close
        seen = self.seen

        def close(server):
            base = f"http://{server.host}:{server.port}"
            with urlopen(server.url, timeout=30) as r:
                seen["metrics"] = r.read().decode()
            with urlopen(f"{base}/healthz", timeout=30) as r:
                seen["healthz"] = r.read().decode()
            real(server)

        MetricsServer.close = close
        return self

    def __exit__(self, *exc):
        from repro_torch.obs.metrics import MetricsServer

        MetricsServer.close = self.real


def obs_train_path(split, fuse, root: str) -> bytes:
    """Phases 6a-6c: the train CLI's observability at full width.
    6a: telemetry every 2nd step, a trace, alerts and a metrics server on
    the kernels, bitwise phase 5's run, its ``metrics.jsonl`` byte for byte
    the plain versions'; 6b: the same under ``fuse_opt`` (sampled steps on
    #3/#8, the others on #4/#9), bitwise phase 5b's; 6c: tracer and
    metrics without telemetry launch phase 5's kernels, step for step.
    Returns 6a's ``metrics.jsonl``."""
    import json

    from repro_torch.configs import get_paper_config
    from repro_torch.launch import train

    n_blocks = len(get_paper_config("vgg8b").blocks)
    seen = {}
    with scrape_at_close(seen):
        res, launches, per_step = counted_steps(lambda: train.train_nitro(
            "vgg8b", telemetry_every=2, telemetry_out=f"{root}/cuda.jsonl",
            trace_out=f"{root}/trace.jsonl", metrics_port=0,
            alerts_out=f"{root}/alerts.jsonl", **OBS_TRAIN_KW))
    expect_launches(launches, PER_STEP, res["steps"], "telemetry run")
    expect_step_launches(per_step, lambda i: (i % 2 == 0, PER_STEP), "telemetry run")
    n = same_run(res["state"], res["step_metrics"], split["state"], split["step_metrics"],
                 "telemetry run vs phase 5's run")
    ref = train.train_nitro("vgg8b", backend="reference", telemetry_every=2,
                            telemetry_out=f"{root}/reference.jsonl", **OBS_TRAIN_KW)
    data = Path(f"{root}/cuda.jsonl").read_bytes()
    if data != Path(f"{root}/reference.jsonl").read_bytes():
        die("telemetry: the kernels' metrics.jsonl differs from the plain versions'")
    rows = [json.loads(ln) for ln in data.decode().splitlines()]
    layers = [f"block{i}" for i in range(n_blocks)] + ["output", "_opt"]
    if [(r["step"], r["layer"]) for r in rows] != [(s, lay) for s in (0, 2) for lay in layers]:
        die(f"telemetry rows: {[(r['step'], r['layer']) for r in rows]}")
    spans = [json.loads(ln) for ln in Path(f"{root}/trace.jsonl").read_text().splitlines()]
    names = [s["name"] for s in spans]
    if names.count("train.step") != TRAIN_STEPS or "train.eval" not in names:
        die(f"trace: spans {names}")
    metrics = seen.get("metrics", "")
    for line in (f"train_step_seconds_count {TRAIN_STEPS}",
                 'repro_build_info{version="0.8.0",backend="cuda"} 1'):
        if line not in metrics.splitlines():
            die(f"/metrics has no line {line!r}")
    if seen.get("healthz") != "ok\n":
        die(f"/healthz answered {seen.get('healthz')!r}")
    print(f"[obs-6a] telemetry every 2nd step: launches {launches} (phase 5's), final "
          f"state, {n} tensors incl. every step's metrics, equals phase 5's bitwise; "
          f"metrics.jsonl ({len(rows)} rows, steps 0 and 2) byte for byte the plain "
          f"versions'; trace {len(spans)} spans ({TRAIN_STEPS} train.step + train.eval); "
          f"/metrics train_step_seconds_count {TRAIN_STEPS} and repro_build_info "
          f"backend=cuda over HTTP, /healthz ok; {res['health']['alerts_fired']} alerts")

    res, launches, per_step = counted_steps(lambda: train.train_nitro(
        "vgg8b", fuse_opt=True, telemetry_every=2, telemetry_out=f"{root}/fuse.jsonl",
        **OBS_TRAIN_KW))
    expect_step_launches(
        per_step, lambda i: (True, PER_STEP) if i % 2 == 0 else (False, PER_STEP_FUSE_OPT),
        "fuse_opt telemetry run")
    n = same_run(res["state"], res["step_metrics"], fuse["state"], fuse["step_metrics"],
                 "fuse_opt telemetry run vs phase 5b's run")
    if Path(f"{root}/fuse.jsonl").read_bytes() != data:
        die("telemetry: the fuse_opt run's metrics.jsonl differs from the split run's")
    print(f"[obs-6b] --fuse-opt with telemetry every 2nd step: steps 0 and 2 launch "
          f"#3/#8 and no _opt kernel, steps 1 and 3 #4/#9 and no plain grad_W "
          f"(launches {launches}); final state, {n} tensors, equals phase 5b's bitwise; "
          f"metrics.jsonl equals the split run's")

    res, launches, per_step = counted_steps(lambda: train.train_nitro(
        "vgg8b", trace_out=f"{root}/trace0.jsonl", metrics_port=0, **OBS_TRAIN_KW))
    expect_launches(launches, PER_STEP, res["steps"], "traced run without telemetry")
    expect_step_launches(per_step, lambda i: (False, PER_STEP), "traced run")
    same_run(res["state"], res["step_metrics"], split["state"], split["step_metrics"],
             "traced run vs phase 5's run")
    print(f"[obs-6c] tracer + metrics server, no telemetry: every step launches phase "
          f"5's kernels ({PER_STEP}); final state equals phase 5's bitwise")
    return data


def obs_fleet_path(fm_a, fm_b) -> tuple:
    """Phase 6d: the two VGG8B arms of phase 4b behind a 90/10 split,
    FLEET_REQUESTS requests through ``FleetEngine(metrics=, tracer=)``: every
    answer equals its arm's reference plan, the counters add up, the queues
    drain and every batch has its four spans.  Returns the registry, the
    images, the MetricRegistry and the tracer, for the sync check."""
    from collections import Counter as Count

    import numpy as np
    from repro_torch.infer import compile_plan
    from repro_torch.obs import MetricRegistry, Tracer
    from repro_torch.serving import FleetEngine, ModelRegistry, Router

    reg = MetricRegistry()
    registry = ModelRegistry(device="cuda", metrics=reg)
    registry.register("a", fm_a)
    registry.register("b", fm_b)
    router = Router({"split": {"a": 0.9, "b": 0.1}})
    tracer = Tracer()
    rng = np.random.default_rng(13)
    ids = [f"req-{i}" for i in range(FLEET_REQUESTS)]
    imgs = [rng.integers(-127, 128, fm_a.input_shape).astype(np.int32) for _ in ids]
    with FleetEngine(registry, batch_size=BATCH, router=router, metrics=reg,
                     tracer=tracer) as engine:
        futs = [engine.submit(im, model="split", request_id=rid)
                for rid, im in zip(ids, imgs)]
        results = [f.result(timeout=120) for f in futs]
    arms = [router.resolve("split", rid) for rid in ids]
    for arm, fm in (("a", fm_a), ("b", fm_b)):
        idx = [i for i, a in enumerate(arms) if a == arm]
        check_served(compile_plan(fm, device="cuda", backend="reference"),
                     [imgs[i] for i in idx], [results[i] for i in idx],
                     f"[obs-6d] arm {arm}:")
    snap = reg.json_snapshot()

    def by_model(name, key="value"):
        return {s["labels"]["model"]: s[key] for s in snap[name]["samples"]}

    reqs, batches = by_model("serve_requests_total"), by_model("serve_batches_total")
    if reqs.get("_fleet") != FLEET_REQUESTS or reqs.get("a", 0) + reqs.get("b", 0) \
            != FLEET_REQUESTS or reqs.get("a") != arms.count("a"):
        die(f"[obs-6d] serve_requests_total {reqs}, router {Count(arms)}")
    if by_model("serve_queue_depth") != {"a": 0, "b": 0}:
        die(f"[obs-6d] queues not drained: {by_model('serve_queue_depth')}")
    spans = tracer.snapshot()
    names = Count(s.name for s in spans)
    phases = ("fleet.assemble", "fleet.dispatch", "fleet.fetch", "fleet.deliver")
    if set(names) != set(phases) or any(names[p] != batches["_fleet"] for p in phases) \
            or any(s.attrs.get("model") not in ("a", "b") for s in spans) \
            or sum(s.attrs["n"] for s in spans if s.name == "fleet.assemble") \
            != FLEET_REQUESTS:
        die(f"[obs-6d] spans {dict(names)} for {batches['_fleet']} batches")
    fill = snap["serve_batch_fill"]["samples"][0]
    print(f"[obs-6d] {FLEET_REQUESTS} requests through FleetEngine(metrics=, tracer=), "
          f"90/10 over two full-width VGG8B arms: every answer equals its arm's "
          f"reference plan; serve_requests_total {reqs}, batches {batches}, fill "
          f"histogram count {fill['count']}, queues drained; {len(spans)} spans, the "
          f"four phases once a batch, model= set")
    return registry, imgs, reg, tracer


def serve_window(reg, imgs, traced: bool, **engine_kw):
    """One continuous-fleet window: ``len(imgs)`` requests submitted at once
    to model ``a``, after a warm-up; returns (wall s, seconds of the
    submit loop, device busy ms or None, batches in the window, the
    engine's tracer spans of the window)."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import FleetEngine, snapshot_delta

    tracer = engine_kw.get("tracer")
    with FleetEngine(reg, batch_size=BATCH, **engine_kw) as engine:
        engine.classify(imgs[:1], model="a")
        pre = engine.stats.snapshot()
        if tracer is not None:
            tracer.clear()
        torch.cuda.synchronize()
        with (profile(activities=[ProfilerActivity.CUDA]) if traced
              else contextlib.nullcontext()) as prof:
            t0 = time.perf_counter()
            futs = [engine.submit(im, model="a") for im in imgs]
            submitted = time.perf_counter() - t0
            for f in futs:
                f.result(timeout=120)
            wall = time.perf_counter() - t0
        batches = snapshot_delta(pre, engine.stats.snapshot())["batches"]
    busy = None
    if traced:
        busy = 0.0
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            busy += (e.self_cuda_time_total if us is None else us) / 1e3
    return wall, submitted, busy, batches, (tracer.snapshot() if tracer is not None else [])


def fleet_spans(fm_a, card: str) -> None:
    """``[fleet-spans]``: the ``[e2e-fleet]`` workload (FLEET_E2E requests at
    once, one full-width VGG8B, the continuous fleet) with metrics and the
    tracer on: each batch phase's p50 and mean ms a batch and its total,
    beside the wall time and, under the profiler, the device busy share.
    ``fleet.dispatch`` closes when the launches are queued; ``fleet.fetch``
    holds the wait for the card."""
    import numpy as np
    from repro_torch.obs import MetricRegistry, Tracer
    from repro_torch.serving import ModelRegistry
    from repro_torch.serving.stats import percentile

    reg = ModelRegistry(device="cuda")
    reg.register("a", fm_a)
    rng = np.random.default_rng(11)
    imgs = [rng.integers(-127, 128, fm_a.input_shape).astype(np.int32)
            for _ in range(FLEET_E2E)]
    phases = ("fleet.assemble", "fleet.dispatch", "fleet.fetch", "fleet.deliver")
    interval = sys.getswitchinterval()
    for traced, switch in ((False, interval), (True, interval), (False, interval),
                           (False, 1e-4)):
        tracer = Tracer()
        sys.setswitchinterval(switch)
        try:
            wall, submitted, busy, batches, spans = serve_window(
                reg, imgs, traced, metrics=MetricRegistry(), tracer=tracer)
        finally:
            sys.setswitchinterval(interval)
        parts, worker = [], 0.0
        for p in phases:
            ms = sorted(s.duration_ns / 1e6 for s in spans if s.name == p)
            worker += sum(ms)
            parts.append(f"{p.split('.')[1]} p50 {percentile(ms, 0.5):.4f} mean "
                         f"{sum(ms) / max(len(ms), 1):.4f} total {sum(ms):.3f}")
        what = ("under the profiler" if traced else "untraced") + (
            f", switch interval {switch * 1e3:g} ms" if switch != interval else "")
        busy_s = (f", device busy {busy:.3f} ms ({100 * busy / (wall * 1e3):.1f}%)"
                  if traced else "")
        print(f"[fleet-spans] {card} | {what}: {FLEET_E2E} requests at once, full-width "
              f"VGG8B, batch {BATCH}, {batches} batches in {wall * 1e3:.3f} ms "
              f"({FLEET_E2E / wall:.1f} req/s){busy_s}, the submit loop (backpressure "
              f"included) {submitted * 1e3:.3f} ms of it | ms a batch: " + "; ".join(parts)
              + f" | the worker's four phases {worker:.3f} ms of the window, "
              f"{wall * 1e3 - worker:.3f} ms outside them (waiting for work, the lock)")


def obs_serve(fm_a, card: str) -> None:
    """``[obs-serve]``: the ``[e2e-fleet]`` workload on the continuous
    fleet without ``metrics=`` and ``tracer=``, with each alone and with
    both, in turns A B C D D C B A, twice."""
    import numpy as np
    from repro_torch.obs import MetricRegistry, Tracer
    from repro_torch.serving import ModelRegistry

    reg = ModelRegistry(device="cuda")
    reg.register("a", fm_a)
    rng = np.random.default_rng(12)
    imgs = [rng.integers(-127, 128, fm_a.input_shape).astype(np.int32)
            for _ in range(FLEET_E2E)]
    arms = {"off": lambda: {}, "metrics=": lambda: {"metrics": MetricRegistry()},
            "tracer=": lambda: {"tracer": Tracer()},
            "both": lambda: {"metrics": MetricRegistry(), "tracer": Tracer()}}
    rates = {k: [] for k in arms}
    for arm in 2 * (list(arms) + list(arms)[::-1]):
        wall, _, _, _, _ = serve_window(reg, imgs, False, **arms[arm]())
        rates[arm].append(FLEET_E2E / wall)
    print(f"[obs-serve] {card} | {FLEET_E2E} requests at once, full-width VGG8B, batch "
          f"{BATCH}, continuous fleet, req/s in turns A B C D D C B A, twice: " + "; ".join(
              f"{k} " + " / ".join(f"{r:.1f}" for r in v) for k, v in rates.items()))


def obs_train(res, cfg, card: str) -> None:
    """``[obs-train]``: full-width VGG8B at batch 64, host-to-host ms per
    step for four arms in turns A B C D D C B A: observability off; the
    CLI's tracer span + step histogram + straggler detector; telemetry every
    step (readout, records, JSONL, health rules); the same under
    ``fuse_opt``.  Then a sampled step's extra device launches and device
    time, from the profiler."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch.core import les, prng
    from repro_torch.obs import health as H
    from repro_torch.obs import telemetry as T
    from repro_torch.obs.metrics import MetricRegistry
    from repro_torch.obs.trace import Tracer
    from repro_torch.train.fault_tolerance import StepTimer, StragglerDetector

    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.integers(-127, 128, (TRAIN_BATCH, *cfg.input_shape))
                         .astype(np.int32)).cuda()
    y = torch.from_numpy(rng.integers(0, 10, TRAIN_BATCH).astype(np.int32)).cuda()
    key, state = prng.PRNGKey(TRAIN_STEPS), res["state"]
    tracer, registry, timer, straggler = Tracer(), MetricRegistry(), StepTimer(), StragglerDetector()
    seconds = registry.histogram("train_step_seconds", "wall time per training step")
    monitor = H.HealthMonitor(registry=registry)
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/metrics.jsonl"

        def traced():
            with tracer.span("train.step", step=0, telemetry=False):
                out = les.train_step(state, cfg, x, y, key)
            dt = timer.lap()
            seconds.observe(dt)
            straggler.record(dt)
            return out

        def sampled(fuse_opt):
            def step():
                with tracer.span("train.step", step=0, telemetry=True):
                    out = les.train_step(state, cfg, x, y, key, telemetry=True,
                                         fuse_opt=fuse_opt)
                    records = T.to_records(out[2], cfg=cfg, step=0)
                    T.append_jsonl(path, records)
                    monitor.observe_records(records)
                dt = timer.lap()
                seconds.observe(dt)
                straggler.record(dt)
                return out
            return step

        arms = {"off": lambda: les.train_step(state, cfg, x, y, key),
                "tracer+metrics": traced, "telemetry": sampled(False),
                "telemetry fuse_opt": sampled(True)}
        order = list(arms)
        ms = {k: [] for k in arms}
        for name in order + order[::-1]:
            ms[name].append(time_cuda(arms[name], iters=10, warmup=1))
        prof, top = {}, {}
        for name in ("off", "telemetry"):
            wall, kernels = device_profile(arms[name], 3)
            prof[name] = (sum(v for v, _ in kernels.values()) / 3,
                          sum(n for _, n in kernels.values()) // 3)
            top[name] = kernels
    extra = sorted(((ms - top["off"].get(k, (0.0, 0))[0], n - top["off"].get(k, (0.0, 0))[1], k)
                    for k, (ms, n) in top["telemetry"].items()), reverse=True)[:8]
    print(f"[obs-train] {card} | VGG8B full width, batch {TRAIN_BATCH}, host to host ms "
          f"per step, turns A B C D D C B A (10 steps a turn): " + "; ".join(
              f"{k} {v[0]:.3f} / {v[1]:.3f}" for k, v in ms.items())
          + f" | device per step: off {prof['off'][0]:.3f} ms over {prof['off'][1]} "
          f"launches, telemetry {prof['telemetry'][0]:.3f} ms over "
          f"{prof['telemetry'][1]} launches: a sampled step adds "
          f"{prof['telemetry'][1] - prof['off'][1]} device launches and "
          f"{prof['telemetry'][0] - prof['off'][0]:.3f} ms of device time; the most of it: "
          + "; ".join(f"{k[:56]} {ms / 3:.3f} ms x{n // 3}" for ms, n, k in extra))


# ---------------------------------------------------------------------------
# Phase 7: data parallelism at full width
# ---------------------------------------------------------------------------

DP_RANKS = 2
#: the arms of 7a and 7c: (reducer, fuse_opt), in the order they run
DP_ARMS = (("psum", False), ("ring", False), ("compress", False), ("psum", True))
#: steps a timed turn of 7a
DP_TIMED = 10


def _timed_steps(step, state, batches, iters: int) -> float:
    """Host-to-host ms per step over ``iters`` steps on ``batches`` in
    turn, ending in a synchronise."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        x, y, key = batches[i % len(batches)]
        state = step(state, x, y, key)[0]
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def dp_rank(axis, device) -> dict:
    """One rank of phases 7a / 7c (spawned; every rank runs every line in
    the same order, since each step holds collectives).

    Each arm of ``DP_ARMS`` trains full-width VGG8B 4 steps from
    ``PRNGKey(0)`` on phase 5's batches and keys (global batch 64, this
    rank's 32 rows), the launch counters set to 0 before the arm and read
    after it and after every step; the int32 wrap of every reducer; then
    the timings: host-to-host ms per step of each reducer in turns A B C C
    B A, ``reduce_gradients`` alone, and rank 0's device time per step
    under ``torch.profiler``.  Returns tensors on the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import les, prng
    from repro_torch.parallel import collectives, compress, dp, tree

    cfg, batches = cli_batches()
    counters = launch_counters()
    out = {"rank": axis.rank, "ranks": axis.size, "backend": axis.backend, "arms": {}}
    for reducer, fuse in DP_ARMS:
        step = dp.make_dp_train_step(cfg, axis, dp_reduce=reducer, fuse_opt=fuse)
        state = les.create_train_state(prng.PRNGKey(0), cfg, device=device)
        for c in counters.values():
            c.reset()
        metrics, per_step = [], []
        for x, y, key in batches:
            before = {k: c.value for k, c in counters.items()}
            state, m = step(state, x, y, key)
            per_step.append({k: c.value - before[k] for k, c in counters.items()
                             if c.value != before[k]})
            metrics.append(m)
        total = {k: c.value for k, c in counters.items() if c.value}
        out["arms"][(reducer, fuse)] = {"trees": tree.tree_map(torch.Tensor.cpu,
                                                               _trees(state, metrics)),
                                        "per_step": per_step, "launches": total}

    top = 2 ** 31 - 1 if axis.rank == 0 else 1 if axis.rank == 1 else 0
    edge = torch.tensor([top, -5], dtype=torch.int32, device=device)
    out["wrap"] = {"psum": compress.exact_integer_psum(edge, axis).cpu(),
                   "ring": collectives.ring_all_reduce(edge, axis).cpu(),
                   "compress": compress.nitro_compressed_psum(edge, axis).cpu()}

    steps = {r: dp.make_dp_train_step(cfg, axis, dp_reduce=r) for r in dp.REDUCERS}
    state = les.create_train_state(prng.PRNGKey(0), cfg, device=device)
    for r in dp.REDUCERS:  # warm every path once
        state = steps[r](state, *batches[0])[0]
    ms = {r: [] for r in dp.REDUCERS}
    for r in dp.REDUCERS + dp.REDUCERS[::-1]:
        ms[r].append(_timed_steps(steps[r], state, batches, DP_TIMED))
    out["step_ms"] = ms

    x, y, key = batches[0]
    grads, _, _ = les.compute_gradients(state, cfg, dp.shard_batch(x, axis),
                                        dp.shard_batch(y, axis), key,
                                        dp_axis=axis, dp_shards=axis.size)
    out["grad_elems"] = sum(g.numel() for g in tree.leaves(grads))
    reduce_ms = {r: [] for r in dp.REDUCERS}
    for r in dp.REDUCERS + dp.REDUCERS[::-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DP_TIMED):
            dp.reduce_gradients(grads, axis, r)
        torch.cuda.synchronize()
        reduce_ms[r].append((time.perf_counter() - t0) * 1e3 / DP_TIMED)
    out["reduce_ms"] = reduce_ms

    # rank 0's device time per psum step: 3 steps under the profiler (the
    # other ranks run the same 3 steps unprofiled)
    calls = 3
    torch.cuda.synchronize()
    if axis.rank == 0:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(calls):
                state = steps["psum"](state, *batches[i])[0]
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        busy = sum(getattr(e, "self_device_time_total", 0) or 0
                   for e in prof.key_averages()) / 1e3
        out["profile"] = {"wall_ms": wall / calls, "device_ms": busy / calls}
    else:
        for i in range(calls):
            state = steps["psum"](state, *batches[i])[0]
        torch.cuda.synchronize()
    return out


def dp_check(results, split, fuse, what: str) -> dict:
    """Die unless every rank of every arm equals phase 5's run (phase 5b's
    under ``fuse_opt``) bitwise and launched, per step, phase 5's kernels
    (+1 ``integer_sgd_update`` under ``fuse_opt``, never #4/#9), and every
    reducer wrapped INT32_MAX + 1 to INT32_MIN.  Returns rank 0's result."""
    import torch
    from repro_torch.parallel.tree import tree_map

    want = {fused: tree_map(torch.Tensor.cpu, _trees(run["state"], run["step_metrics"]))
            for fused, run in ((False, split), (True, fuse))}
    for res in results:
        r = res["rank"]
        for (reducer, fused), arm in res["arms"].items():
            tag = f"{what} rank {r} {reducer}{' fuse_opt' if fused else ''}"
            exp = PER_STEP_FUSED_APPLY if fused else PER_STEP
            if len(arm["per_step"]) != TRAIN_STEPS or any(s != exp for s in arm["per_step"]):
                die(f"{tag}: per-step launches {arm['per_step']}, expected {exp}")
            if arm["launches"] != {k: v * TRAIN_STEPS for k, v in exp.items()}:
                die(f"{tag}: launches {arm['launches']}")
            got, ref = arm["trees"], want[fused]
            if got.keys() != ref.keys():
                die(f"{tag}: state trees differ: {sorted(got)} vs {sorted(ref)}")
            for name in ref:
                a, b = got[name], ref[name]
                if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
                    die(f"{tag}: {name} differs from phase 5{'b' if fused else ''}'s run")
        for reducer, v in res["wrap"].items():
            if v.tolist() != [-(2 ** 31), -5 * len(results)]:
                die(f"{what} rank {r}: {reducer} gave {v.tolist()} for INT32_MAX + 1")
    return results[0]


def dp_path(split, fuse, obs_jsonl: bytes, card: str) -> None:
    """Phase 7: (7a) 2 ranks spawned on one card over gloo, every arm
    bitwise phase 5's / 5b's run, counted per rank step; (7b) the train
    CLI with --num-devices 2 --dp-reduce ring --telemetry-every 2: rank 0's
    metrics.jsonl phase 6a's plus the ``_dp`` rows, its accuracy phase 5's;
    (7c) the same as 7a over NCCL, one card a rank, where the host has
    two; then the ``[dp]`` timing lines."""
    import json
    import tempfile

    import torch
    from repro_torch.launch import train
    from repro_torch.parallel import dp
    from repro_torch.parallel.tree import tree_map

    comm, devices = dp.rank_devices(DP_RANKS, "cuda", cards=1)
    if comm != "gloo":
        die(f"7a: {DP_RANKS} ranks on one card must meet over gloo, not {comm}")
    print(f"[dp-7a] {DP_RANKS} ranks, {dp.describe(comm, devices)}")
    results = dp.spawn(dp_rank, DP_RANKS, device="cuda", cards=1)
    res0 = dp_check(results, split, fuse, "7a")
    if any(r["backend"] != "gloo" for r in results):
        die(f"7a: backends {[r['backend'] for r in results]}")
    print(f"[dp-7a] every rank, every arm (psum, ring, compress; psum fuse_opt): final "
          f"state and every step's metrics equal phase 5's (5b's under fuse_opt) bitwise; "
          f"each rank step launched {PER_STEP} (+ integer_sgd_update 1 under fuse_opt, "
          f"no #4/#9); INT32_MAX + 1 wraps to INT32_MIN through every reducer")

    with tempfile.TemporaryDirectory() as d:
        res = train.main(TRAIN_ARGV + ["--num-devices", str(DP_RANKS), "--dp-reduce", "ring",
                                       "--telemetry-every", "2",
                                       "--telemetry-out", f"{d}/dp.jsonl"])
        lines = Path(f"{d}/dp.jsonl").read_bytes().splitlines(keepends=True)
    dp_rows = [json.loads(ln) for ln in lines if b'"_dp"' in ln]
    rest = b"".join(ln for ln in lines if b'"_dp"' not in ln)
    if rest != obs_jsonl:
        die("7b: rank 0's metrics.jsonl differs from phase 6a's (the _dp rows aside)")
    if [(r["step"], r["shards"]) for r in dp_rows] != [(0, DP_RANKS), (2, DP_RANKS)]:
        die(f"7b: _dp rows {dp_rows}")
    if res["test_accuracy"] != split["test_accuracy"]:
        die(f"7b: test accuracy {res['test_accuracy']} != phase 5's {split['test_accuracy']}")
    same_run(res["state"], res["step_metrics"],
             *(tree_map(torch.Tensor.cpu, split[k]) for k in ("state", "step_metrics")),
             "7b vs phase 5's run")
    print(f"[dp-7b] train CLI --num-devices {DP_RANKS} --dp-reduce ring --telemetry-every 2: "
          f"rank 0's metrics.jsonl is phase 6a's byte for byte plus {len(dp_rows)} _dp rows "
          f"{dp_rows}; final state and test accuracy {res['test_accuracy']:.4f} equal phase 5's")

    if torch.cuda.device_count() >= DP_RANKS:
        dp_nccl_path(split, fuse, card)
    else:
        print(f"[dp-7c] not run: the NCCL arm needs {DP_RANKS} cards, this host has "
              f"{torch.cuda.device_count()}")
    dp_timing(res0, "7a gloo, one card", split, card)


def dp_nccl_path(split, fuse, card: str, ranks: int = DP_RANKS) -> None:
    """Phase 7c: 7a's ranks over NCCL, one card a rank, held to the same
    checks, then its ``[dp]`` line."""
    from repro_torch.parallel import dp

    comm, devices = dp.rank_devices(ranks, "cuda")
    if comm != "nccl":
        die(f"7c: {ranks} ranks on {ranks} cards must meet over NCCL, not {comm}")
    print(f"[dp-7c] {ranks} ranks, {dp.describe(comm, devices)}")
    results = dp.spawn(dp_rank, ranks, device="cuda")
    dp_check(results, split, fuse, f"7c, {ranks} ranks")
    print(f"[dp-7c] {ranks} ranks over NCCL, one card a rank: every arm bitwise phase 5's "
          f"(5b's under fuse_opt), phase 5's launches per rank step, int32 wrap as XLA's")
    dp_timing(results[0], f"7c NCCL, {ranks} cards", split, card)


def dp_timing(res0: dict, what: str, split, card: str) -> None:
    """The ``[dp]`` line: each reducer's host-to-host ms per step (rank 0,
    turns A B C C B A) beside the single-device step timed the same way in
    this process, ``reduce_gradients`` alone, rank 0's device ms per step,
    and the bytes all-reduced per step."""
    from repro_torch.core import les

    cfg, batches = cli_batches()

    def step(s, x, y, k):
        return les.train_step(s, cfg, x, y, k)

    state = split["state"]
    step(state, *batches[0])
    single = [_timed_steps(step, state, batches, DP_TIMED) for _ in range(2)]
    nbytes = res0["grad_elems"] * 4
    wire = {"psum": nbytes, "ring": nbytes, "compress": 4 * nbytes}
    prof = res0["profile"]
    device = (f"{prof['device_ms']:.3f}" if prof["device_ms"] else
              "not measured (the profiler saw no device event)")
    print(f"[dp] {card} | {what}, VGG8B full width, global batch {TRAIN_BATCH} "
          f"({TRAIN_BATCH // res0['ranks']} a rank), host to host ms per step (rank 0, turns "
          f"A B C C B A, {DP_TIMED} steps a turn): " + "; ".join(
              f"{r} {v[0]:.3f} / {v[1]:.3f}" for r, v in res0["step_ms"].items())
          + f" | single device, batch {TRAIN_BATCH}, same loop: {single[0]:.3f} / "
          f"{single[1]:.3f} | reduce_gradients alone ms: " + "; ".join(
              f"{r} {v[0]:.3f} / {v[1]:.3f}" for r, v in res0["reduce_ms"].items())
          + f" | rank 0 device ms per psum step {device} over "
          f"{prof['wall_ms']:.3f} host to host | bytes all-reduced "
          f"per step: " + "; ".join(f"{r} {b / 1e6:.1f} MB" for r, b in wire.items())
          + f" ({res0['grad_elems']} int32 gradients)")


# ---------------------------------------------------------------------------
# Phase 8: the autotuner on the card
# ---------------------------------------------------------------------------

def tile_lookups(snap) -> list:
    """[hits, misses] from a ``MetricRegistry.json_snapshot()`` (a counter
    never incremented has no sample)."""
    return [sum(s["value"] for s in snap[f"kernel_tile_cache_{k}_total"]["samples"])
            for k in ("hits", "misses")]


def autotune_problems(plan):
    """(where, problem) of every problem the autotuner lists for the
    served VGG8B batch of 32, the VGG8B training step at batch 64 and
    mlp4's at batch 64; ``plan`` is the served VGG8B plan."""
    from repro_torch.configs import get_paper_config
    from repro_torch.kernels import autotune as at

    found = [("served VGG8B", p) for p in at.plan_shapes(plan, BATCH)]
    found += [("VGG8B step", p) for p in at.training_shapes(get_paper_config("vgg8b"),
                                                            TRAIN_BATCH)]
    found += [("mlp4 step", p) for p in at.training_shapes(get_paper_config("mlp4"),
                                                           TRAIN_BATCH)]
    return found


def autotune_untunable(plan, images, root: str) -> None:
    """Phase 8a: on the card every problem has no knob (the kernels' tiles
    are compiled in, their split-K counts planned at launch), so ``tune``
    returns ``(None, {})`` for each without measuring; then the served
    plan's dispatchers look every step up in a configured (empty) cache
    under ``set_sync_debug_mode("error")``: the lookups add no host sync,
    each key is counted once as a miss, and the logits stay the plan's
    (``images``: phase 4's requests)."""
    import numpy as np
    import torch
    from repro_torch.kernels import autotune as at
    from repro_torch.obs.metrics import MetricRegistry

    found = autotune_problems(plan)
    for where, p in found:
        out = at.tune(p["op"], p["shape"], dtype=p["dtype"], backend="cuda",
                      conv_mode=p["conv_mode"], fuse_bwd=p["fuse_bwd"], device="cuda")
        if out != (None, {}):
            die(f"8a: {where} {p['op']} {p['shape']} tuned on the card: {out}")
    buf = torch.zeros(1 << 20, dtype=torch.int32, device="cuda")
    paired = at.time_paired({"add": lambda: buf.add_(1), "mul": lambda: buf.mul_(3)},
                            iters=3, device="cuda")  # the tuner's harness in CUDA events
    if not all(0 < us < 1e6 for us in paired.values()):
        die(f"8a: time_paired on the card gave {paired} us")
    images = torch.from_numpy(np.stack(images[:BATCH])).to(plan.device, torch.int32)
    want = plan.logits(images)
    reg = MetricRegistry()
    at.set_metrics(reg)
    at.configure(at.TileCache(f"{root}/plan_cache.json", device="cuda"))
    try:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = [plan.logits(images) for _ in range(2)]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        snap = reg.json_snapshot()
    finally:
        at.configure(None)
        at.set_metrics(None)
    if any(not torch.equal(g, want) for g in got):
        die("8a: the plan's logits moved with a cache configured")
    keys = {at.cache_key(p["op"], p["shape"], p["dtype"], "cuda", p["conv_mode"], p["fuse_bwd"])
            for p in at.plan_shapes(plan, BATCH)}
    counts = tile_lookups(snap)
    if counts != [0, len(keys)]:
        die(f"8a: the plan's lookups counted {counts}, not [0, {len(keys)}]")
    print(f"[autotune] 8a: {len(found)} problems (served VGG8B, VGG8B and mlp4 steps) "
          f"have no knob on the card, nothing measured; the plan's lookups in a "
          f"configured cache ran under sync debug mode \"error\", {len(keys)} keys "
          f"counted once each as misses, logits unchanged; time_paired in CUDA events "
          f"{ {k: round(v, 2) for k, v in paired.items()} } us")


def autotune_train_path(split, root: str) -> None:
    """Phase 8b: ``train_nitro(autotune=True)`` from phase 5's seed: it
    finds nothing to tune on the card, then trains bitwise phase 5's run on
    phase 5's kernels, step for step; a second run with that cache
    measures nothing, and its ``/metrics`` counts every key the step looks
    up once, as a miss."""
    import re

    from repro_torch.kernels import autotune as at
    from repro_torch.kernels.autotune import search, state
    from repro_torch.launch import train

    cache = f"{root}/tile_cache.json"
    res, _, per_step = counted_steps(lambda: train.train_nitro(
        "vgg8b", autotune=True, autotune_cache=cache, **OBS_TRAIN_KW))
    expect_step_launches(per_step, lambda i: (False, PER_STEP), "autotuned run")
    n = same_run(res["state"], res["step_metrics"], split["state"], split["step_metrics"],
                 "autotuned run vs phase 5's run")
    tuned = at.TileCache(cache).keys()
    if tuned:
        die(f"8b: {len(tuned)} keys tuned on the card, where nothing has a knob")
    at.configure(None)
    at.set_metrics(None)
    calls, real = [], search.tune

    def spy(*args, **kw):
        calls.append(real(*args, **kw))
        return calls[-1]

    search.tune = spy
    seen = {}
    try:
        with scrape_at_close(seen):
            again, _, per_step = counted_steps(lambda: train.train_nitro(
                "vgg8b", autotune=True, autotune_cache=cache, metrics_port=0,
                **OBS_TRAIN_KW))
    finally:
        search.tune = real
    if not calls or any(out != (None, {}) for out in calls):
        die("8b: the second run with the same cache measured")
    expect_step_launches(per_step, lambda i: (False, PER_STEP), "second autotuned run")
    same_run(again["state"], again["step_metrics"], split["state"], split["step_metrics"],
             "second autotuned run vs phase 5's run")
    looked = [k for k in state._memo if isinstance(k, str)]
    counts = {m: int(float(found.group(1))) if found else 0
              for m in ("hits", "misses")
              for found in [re.search(rf"^kernel_tile_cache_{m}_total (\S+)$",
                                      seen["metrics"], re.M)]}
    if not looked or counts != {"hits": 0, "misses": len(looked)}:
        die(f"8b: /metrics counts {counts} for {len(looked)} keys looked up")
    at.configure(None)
    at.set_metrics(None)
    print(f"[autotune] 8b: train_nitro(autotune=True) tuned nothing, then 4 steps bitwise "
          f"phase 5's run ({n} tensors) on phase 5's kernels step for step; the second "
          f"run measured nothing, /metrics {counts}: each of the {len(looked)} keys the "
          f"step looks up counted once")


def autotune_serve_path(phase4, root: str) -> None:
    """Phase 8c: the serve CLI with ``--autotune`` (and a metrics port):
    every request's logits bitwise phase 4's, one ``kernel_int8_path_active``
    sample per plan step (the plan's int8-operand choices), nothing tuned
    and each of the plan's keys counted once, as a miss."""
    import numpy as np
    from repro_torch.kernels import autotune as at
    from repro_torch.launch import serve_vision

    res = serve_vision.main([
        "--arch", "vgg8b", "--scale", "1", "--batch", str(BATCH),
        "--requests", str(REQUESTS), "--seed", "0", "--device", "cuda",
        "--scheduler", "static", "--autotune", "--autotune-cache",
        f"{root}/serve_cache.json", "--metrics-port", "0"])
    for i, (a, b) in enumerate(zip(res["results"], phase4["results"], strict=True)):
        if a.logits.dtype != b.logits.dtype or not np.array_equal(a.logits, b.logits):
            die(f"8c: request {i}'s logits differ from phase 4's")
    snap = res["metrics"].json_snapshot()
    plan = res["plan"]
    gauge = {s["labels"]["layer"]: s["value"]
             for s in snap["kernel_int8_path_active"]["samples"]}
    want = {f"{plan.name}/{i}": int(m.operand_dtype == "int8") for i, m in enumerate(plan.metas)}
    if gauge != want:
        die(f"8c: kernel_int8_path_active {gauge} != the plan's {want}")
    keys = {at.cache_key(p["op"], p["shape"], p["dtype"], "cuda", p["conv_mode"], p["fuse_bwd"])
            for p in at.plan_shapes(plan, BATCH)}
    counts = tile_lookups(snap)
    n_tuned = len(at.TileCache(f"{root}/serve_cache.json").keys())
    if n_tuned or counts != [0, len(keys)]:
        die(f"8c: {n_tuned} tuned keys, lookups counted {counts} for {len(keys)} keys")
    at.configure(None)
    at.set_metrics(None)
    print(f"[autotune] 8c: serve CLI --autotune, {len(res['results'])} requests: logits "
          f"bitwise phase 4's; int8-path gauge {gauge}; nothing tuned, the plan's "
          f"{len(keys)} keys each counted once as a miss")


def time_cuda(fn, iters: int, warmup: int) -> float:
    """Mean milliseconds per call over ``iters`` calls, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, calls: int, tries: int = 3):
    """Run ``fn`` ``calls`` times under ``torch.profiler`` (CUDA activity);
    returns (host-to-host ms over the calls, {kernel name: (device ms in
    all, launches)}).  A session now and then comes back with no device
    event at all; it is run again, up to ``tries`` sessions."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        kernels = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            if us > 0:
                kernels[e.key] = (us / 1e3, e.count)
        if kernels:
            break
    return wall, kernels


def device_ms(fn, kernel: str, calls: int, tries: int = 3) -> float:
    """Mean device time (ms) of one launch of ``kernel`` by ``fn``, from
    the profiler: for a kernel shorter than its wrapper's host path, where
    back-to-back CUDA events time the host.  A session that misses some of
    the launches is run again, up to ``tries`` sessions."""
    for _ in range(tries):
        _, kernels = device_profile(fn, calls)
        hits = [(ms, n) for name, (ms, n) in kernels.items() if kernel in name]
        if hits and sum(n for _, n in hits) == calls:
            return sum(ms for ms, _ in hits) / calls
    die(f"profiler saw {hits} launches of {kernel}, expected {calls}")


def add_time(per_kernel: dict, kernel: str, ms: float, plain_ms: float,
             ops: float, nbytes: float) -> tuple[float, str]:
    """Add one launch's times to ``per_kernel``; returns its bound (ms) and
    what bounds it."""
    ops_ms, bytes_ms = ops / PEAK_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    k = per_kernel.setdefault(kernel, {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                                       "ops_ms": 0.0, "bytes_ms": 0.0})
    k["ms"] += ms
    k["plain_ms"] += plain_ms
    k["bound_ms"] += max(ops_ms, bytes_ms)
    k["ops_ms"] += ops_ms
    k["bytes_ms"] += bytes_ms
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def work(meta, a, w, out_elems: int, out_itemsize: int):
    """(ops, bytes) of one launch: 2 ops per MAC, every operand read once
    and the output written once, in the dtypes the launch moves."""
    wi = 1 if meta.operand_dtype == "int8" else 4
    if meta.kind == "conv":
        n, h, wd, c = a.shape
        k, f = w.shape[0], w.shape[-1]
        macs = n * h * wd * k * k * c * f
    else:
        macs = a.shape[0] * a.shape[1] * w.shape[1]
    nbytes = a.numel() * a.element_size() + w.numel() * wi + out_elems * out_itemsize
    return 2 * macs, nbytes


def timing(steps, card: str) -> dict:
    """Phase 9: per-step kernel / plain / bound times of the serving
    kernels, with the forward conv's digit products and device time; #1's
    ``ms`` is its device time per call (its launches are shorter than the
    wrapper's host path), the back-to-back time beside it."""
    import torch

    per_kernel: dict[str, dict] = {}
    for i, (meta, a, w) in enumerate(steps, 1):
        kernel = "stream_conv" if meta.kind == "conv" else "nitro_matmul"
        out = run_step(meta, a, w, "cuda")
        ms = time_cuda(lambda: run_step(meta, a, w, "cuda"), iters=50, warmup=5)
        plain = time_cuda(lambda: run_step(meta, a, w, "reference"), iters=5, warmup=1)
        ops, nbytes = work(meta, a, w, out.numel(), out.element_size())
        x = a.to(torch.int8) if meta.operand_dtype == "int8" else a
        how = ""
        if kernel == "stream_conv":
            how = (f" ({fwd_digits_run(x, w)}; "
                   f"{conv_device_split(lambda: run_step(meta, a, w, 'cuda'))})")
        else:
            events, (ms, gemm) = ms, matmul_device(lambda: run_step(meta, a, w, "cuda"))
            how = (f" (device, profiler: GEMM {gemm:.4f}, pre-passes and memset "
                   f"{ms - gemm:.4f}; {matmul_digits_run(x, w)}; back to back through the "
                   f"wrapper {events:.4f} ms)")
        bound, by = add_time(per_kernel, kernel, ms, plain, ops, nbytes)
        print(f"[time] {card} | step {i} {kernel} in{tuple(a.shape)} "
              f"w{tuple(w.shape)} operands={meta.operand_dtype} | kernel "
              f"{ms:.4f} ms{how} | plain {plain:.4f} ms | bound {bound:.5f} ms "
              f"({by}: {ops / 1e9:.3f} Gop, {nbytes / 1e6:.3f} MB) | "
              f"{100 * bound / ms:.2f}% of bound | library none")
        if kernel == "stream_conv":
            fwd_int_mm_yardstick(tuple(a.shape), tuple(w.shape), card, f"step {i}")
        else:
            matmul_int_mm_yardstick(tuple(a.shape), tuple(w.shape), card, f"step {i}")
    return per_kernel


def matmul_device(fn, calls: int = 20, tries: int = 3,
                  kernel: str = "matmul_digit_kernel") -> tuple[float, float]:
    """``(device ms of one matmul kernel call, its digit GEMM's ms)`` from
    the profiler — every device operation of the call (the memset, the
    pre-passes, the GEMM) — from a session that saw every GEMM launch."""
    for _ in range(tries):
        _, kernels = device_profile(fn, calls)
        hits = [(ms, n) for k, (ms, n) in kernels.items() if kernel in k]
        if sum(n for _, n in hits) == calls:
            return (sum(ms for ms, _ in kernels.values()) / calls,
                    sum(ms for ms, _ in hits) / calls)
    die(f"profiler saw {hits} launches of {kernel}, expected {calls}")


def matmul_int_mm_yardstick(xs, ws, card: str, tag: str, what: str = "of the matmul") -> None:
    """A yardstick the port never calls: ``torch._int_mm`` at a matmul's
    int8 GEMM shape x (M, K) · w (K, N) (one digit product), M raised to 17
    and N to a multiple of 8 where ``_int_mm`` requires it (the output
    layer's N = 10 → 16)."""
    import torch

    m, k, n = max(xs[0], 17), xs[1], -(-ws[1] // 8) * 8
    try:
        a = torch.randint(-128, 128, (m, k), dtype=torch.int8, device="cuda")
        b = torch.randint(-128, 128, (n, k), dtype=torch.int8, device="cuda").t()
        ms = time_cuda(lambda: torch._int_mm(a, b), iters=50, warmup=5)
        _, kernels = device_profile(lambda: torch._int_mm(a, b), 20)
        dev = sum(v for v, _ in kernels.values()) / 20
        print(f"[yardstick] {card} | {tag} torch._int_mm ({m}x{k}) . ({k}x{n}) int8 -> int32, "
              f"one digit product {what}: device {dev:.4f} ms, back to back {ms:.4f} ms")
    except RuntimeError as e:  # a yardstick only: report, not fatal
        print(f"[yardstick] {card} | {tag} torch._int_mm: not measured ({e})")


def conv_device_split(fn, calls: int = 10, tries: int = 3) -> str:
    """Device time of one forward conv call from the profiler, split into
    the digit GEMM and the rest (the pre-passes and the memset), from a
    session that saw every GEMM launch."""
    for _ in range(tries):
        _, kernels = device_profile(fn, calls)
        hits = [(ms, n) for k, (ms, n) in kernels.items() if "conv_digit_gemm" in k]
        if sum(n for _, n in hits) == calls:
            gemm = sum(ms for ms, _ in hits) / calls
            total = sum(ms for ms, _ in kernels.values()) / calls
            return f"device {total:.4f} ms: GEMM {gemm:.4f}, pre-passes {total - gemm:.4f}"
    die(f"profiler saw {hits} launches of conv_digit_gemm, expected {calls}")


def fwd_int_mm_yardstick(xs, ws, card: str, tag: str) -> None:
    """A yardstick the port never calls: ``torch._int_mm`` at a forward
    conv's int8 GEMM shape, (N·H·W × K²C) · (K²C × F), K²C rounded up to a
    multiple of 8 as ``_int_mm`` requires (conv 1: 27 → 32)."""
    import torch

    n, h, w, c = xs
    p, m, f = n * h * w, -(-ws[0] * ws[1] * c // 8) * 8, ws[-1]
    try:
        a = torch.randint(-128, 128, (p, m), dtype=torch.int8, device="cuda")
        b = torch.randint(-128, 128, (f, m), dtype=torch.int8, device="cuda").t()
        ms = time_cuda(lambda: torch._int_mm(a, b), iters=20, warmup=3)
        print(f"[yardstick] {card} | {tag} torch._int_mm ({p}x{m}) . ({m}x{f}) int8 -> "
              f"int32, one digit product of the forward conv: {ms:.4f} ms")
    except RuntimeError as e:  # a yardstick only: report, not fatal
        print(f"[yardstick] {card} | {tag} torch._int_mm: not measured ({e})")


def train_work(kind, kernel, xs, ws):
    """(ops, bytes) of one training launch, int32 operands: 2 ops per MAC,
    each operand read once, each output written once."""
    if kind == "conv":
        n, h, w, c = xs
        k, f = ws[0], ws[-1]
        macs, x_el, out_el, w_el = n * h * w * k * k * c * f, n * h * w * c, n * h * w * f, k * k * c * f
    else:
        (b, m), f = xs, ws[-1]
        macs, x_el, out_el, w_el = b * m * f, b * m, b * f, m * f
    if kernel.endswith("_fwd"):
        nbytes = 4 * (x_el + w_el + 2 * out_el)   # x, w in; a, z* out
    elif kernel.endswith("_opt"):
        nbytes = 4 * (x_el + 2 * out_el + 2 * w_el)  # x, δ, z*, W in; W′ out
    else:
        nbytes = 4 * (x_el + 2 * out_el + w_el)   # x, δ, z* in; grad_W out
    return 2 * macs, nbytes


def main_path_conv_operands() -> list:
    """(x, w) of each conv of the phase 5 CLI run's first step: the
    preprocessed first batch through the seeded init's forward."""
    from repro_torch.core import les, prng
    from repro_torch.core import model as M

    cfg, steps = cli_batches()
    x, _, key = steps[0]
    params = les.create_train_state(prng.PRNGKey(0), cfg, device="cuda").params
    _, _, caches, _ = M.forward(params, cfg, x, train=True, key=key)
    return [(cache["conv"].x, p["fw"]["w"])
            for spec, p, cache in zip(cfg.blocks, params["blocks"], caches)
            if spec.kind == "conv"]


def train_timing(shapes, card: str, per_kernel: dict) -> None:
    """Phase 9b: per-shape kernel / plain / bound times of the training
    kernels (one step = one launch at each shape).  #7 runs on the main
    path's own operands (the CLI's first batch and the seeded init, whose
    digits decide its products), and beside them on w of ±2^15."""
    import torch
    from repro_torch.core.scaling import linear_scale_factor
    from repro_torch.kernels.nitro_matmul.ops import fused_matmul_fwd

    g = torch.Generator().manual_seed(3)
    convs = iter(main_path_conv_operands())
    for i, (kind, xs, ws, sf, ai) in enumerate(shapes, 1):
        x, w, delta, z = train_operands(xs, ws, g)
        cuda = train_calls(kind, x, w, delta, z, sf, ai, "cuda")
        plain = train_calls(kind, x, w, delta, z, sf, ai, "reference")
        names = (("stream_conv_fwd", "stream_conv_grad_w") if kind == "conv"
                 else ("nitro_matmul_fwd", "nitro_matmul_grad_w"))
        if kind == "conv":
            wide = time_cuda(cuda[0], iters=20, warmup=3)
            print(f"[time] {card} | train step {i} stream_conv_fwd on w +-2^15 "
                  f"({fwd_digits_run(x, w)}) | kernel {wide:.4f} ms")
            xm, wm = next(convs)
            cuda = (train_calls(kind, xm, wm, delta, z, sf, ai, "cuda")[0], *cuda[1:])
            plain = (train_calls(kind, xm, wm, delta, z, sf, ai, "reference")[0], *plain[1:])
        if kind == "linear":  # #2 at the init's range (±4: one product), beside ±2^15
            wide = time_cuda(cuda[0], iters=20, warmup=3)
            print(f"[time] {card} | train step {i} nitro_matmul_fwd on w +-2^15 "
                  f"({matmul_digits_run(x, w)}) | kernel {wide:.4f} ms back to back")
            wm = torch.randint(-4, 5, ws, generator=g).to(torch.int32).cuda()
            cuda = (train_calls(kind, x, wm, delta, z, sf, ai, "cuda")[0], *cuda[1:])
            plain = (train_calls(kind, x, wm, delta, z, sf, ai, "reference")[0], *plain[1:])
        for kernel, fn, pfn in zip(names, cuda[:2], plain[:2]):
            if kernel == "nitro_matmul_grad_w":
                continue  # linear_grad_w_timing
            ms = time_cuda(fn, iters=20, warmup=3)
            plain_ms = time_cuda(pfn, iters=3, warmup=1)
            ops, nbytes = train_work(kind, kernel, xs, ws)
            dev = ""
            if kernel == "nitro_matmul_fwd":  # shorter than its wrapper's host path
                events, (ms, gemm) = ms, matmul_device(fn)
                dev = (f" (device, profiler: GEMM {gemm:.4f}, pre-passes and memset "
                       f"{ms - gemm:.4f}; {matmul_digits_run(x, wm)}; back to back through "
                       f"the wrapper {events:.4f} ms)")
            bound, by = add_time(per_kernel, kernel, ms, plain_ms, ops, nbytes)
            if kernel == "stream_conv_grad_w":
                dev = f" ({digits_run(x, delta, z, ai)}; delta +-2^20)"
            if kernel == "stream_conv_fwd":
                dev = (f" (main path's x and w: {fwd_digits_run(xm, wm)}; "
                       f"{conv_device_split(fn)})")
            print(f"[time] {card} | train step {i} {kernel} x{xs} w{ws} int32 | "
                  f"kernel {ms:.4f} ms{dev} | plain {plain_ms:.4f} ms | bound "
                  f"{bound:.5f} ms ({by}: {ops / 1e9:.3f} Gop, {nbytes / 1e6:.3f} MB) "
                  f"| {100 * bound / ms:.2f}% of bound | library none")
        if cuda[2] is not None:  # #8 on a pre-masked δ (the fuse_bwd=False path)
            ms = time_cuda(cuda[2], iters=20, warmup=3)
            print(f"[time] {card} | train step {i} stream_conv_grad_w without z* "
                  f"(no mask on load) | kernel {ms:.4f} ms")
            int_mm_yardstick(xs, ws, card, i)
            fwd_int_mm_yardstick(xs, ws, card, f"train step {i}")
        else:
            matmul_int_mm_yardstick(xs, ws, card, f"train step {i}")
    for xs, ws in [sh[1:] for sh in MLP4_SHAPES]:  # #2 at mlp4's layers
        x, _, _, _ = train_operands(xs, ws, g)
        wm = torch.randint(-4, 5, ws, generator=g).to(torch.int32).cuda()
        sf = linear_scale_factor(xs[1])
        fn = lambda x=x, w=wm, sf=sf: fused_matmul_fwd(x, w, sf=sf, backend="cuda")  # noqa: E731
        events = time_cuda(fn, iters=20, warmup=3)
        ms, gemm = matmul_device(fn)
        plain_ms = time_cuda(lambda: fused_matmul_fwd(x, wm, sf=sf, backend="reference"),
                             iters=3, warmup=1)
        ops, nbytes = train_work("linear", "nitro_matmul_fwd", xs, ws)
        bound = max(ops / PEAK_OPS, nbytes / PEAK_BYTES) * 1e3
        by = "operations" if ops / PEAK_OPS >= nbytes / PEAK_BYTES else "bytes"
        print(f"[time] {card} | mlp4 nitro_matmul_fwd x{xs} w{ws} int32 | kernel {ms:.4f} ms "
              f"(device, profiler: GEMM {gemm:.4f}, pre-passes and memset {ms - gemm:.4f}; "
              f"{matmul_digits_run(x, wm)}; back to back through the wrapper {events:.4f} ms) | "
              f"plain {plain_ms:.4f} ms | bound {bound:.5f} ms ({by}: {ops / 1e9:.3f} Gop, "
              f"{nbytes / 1e6:.3f} MB) | {100 * bound / ms:.2f}% of bound | library none")
        matmul_int_mm_yardstick(xs, ws, card, "mlp4")


def int_mm_yardstick(xs, ws, card: str, i: int) -> None:
    """A yardstick the port never calls: ``torch._int_mm`` at the int8
    GEMM shape of one digit product of conv grad_W, (K²C × N·H·W) ·
    (N·H·W × F)."""
    import torch

    n, h, w, c = xs
    m, p, f = ws[0] * ws[1] * c, n * h * w, ws[-1]
    try:
        a = torch.randint(-128, 128, (m, p), dtype=torch.int8, device="cuda")
        b = torch.randint(-128, 128, (f, p), dtype=torch.int8, device="cuda").t()
        ms = time_cuda(lambda: torch._int_mm(a, b), iters=20, warmup=3)
        print(f"[yardstick] {card} | train step {i} torch._int_mm ({m}x{p}) . ({p}x{f}) "
              f"int8 -> int32, one digit product: {ms:.4f} ms")
    except RuntimeError as e:  # a yardstick only: report, not fatal
        print(f"[yardstick] {card} | train step {i} torch._int_mm: not measured ({e})")


def opt_timing(shapes, cfg, params, card: str, per_kernel: dict) -> None:
    """Phase 9c: per-shape kernel / plain / bound times of the update
    kernels — #9 at each conv layer of a step (the forward layers'
    optimiser state; #4 in ``linear_grad_w_timing``), #11 per fused apply
    over VGG8B's 15 weight tensors (the kernels line's row) and mlp4's 7,
    each block's fw under the forward layers' state and the rest under the
    learning layers'."""
    import torch
    from repro_torch.configs import get_paper_config
    from repro_torch.core import model as M
    from repro_torch.core import optimizer as opt
    from repro_torch.core import prng
    from repro_torch.kernels.integer_sgd.ops import apply_groups_fused

    g = torch.Generator().manual_seed(6)
    gamma, eta, _ = opt_states(cfg)[0]
    state = opt.init_state(gamma, eta, device="cuda")
    for i, (kind, xs, ws, _, ai) in enumerate(shapes, 1):
        if kind == "linear":
            continue  # linear_grad_w_timing
        x, w, delta, z = train_operands(xs, ws, g)
        kernel = "stream_conv_grad_w_opt"
        ms = time_cuda(opt_call(kind, x, w, delta, z, state, ai, "cuda"), iters=20, warmup=3)
        plain_ms = time_cuda(opt_call(kind, x, w, delta, z, state, ai, "reference"),
                             iters=3, warmup=1)
        how = f" ({digits_run(x, delta, z, ai)}; delta +-2^20)"
        ops, nbytes = train_work(kind, kernel, xs, ws)
        bound, by = add_time(per_kernel, kernel, ms, plain_ms, ops, nbytes)
        print(f"[time] {card} | train step {i} {kernel} x{xs} w{ws} int32 | kernel "
              f"{ms:.4f} ms{how} | plain {plain_ms:.4f} ms | bound {bound:.5f} ms ({by}: "
              f"{ops / 1e9:.3f} Gop, {nbytes / 1e6:.3f} MB) | {100 * bound / ms:.2f}% "
              f"of bound | library none")
    lr_state = opt.init_state(*opt_states(cfg)[3][:2], device="cuda")
    mlp4 = M.init_params(prng.PRNGKey(0), get_paper_config("mlp4", scale=1.0), device="cuda")
    for arch, p in (("VGG8B", params), ("mlp4", mlp4)):
        groups = sgd_groups(p, state, lr_state, lambda shape: torch.randint(
            -(2 ** 24), 2 ** 24, shape, generator=g).to(torch.int32).cuda())
        call = lambda: apply_groups_fused(groups, backend="cuda")  # noqa: E731
        ms = device_ms(call, "integer_sgd", 50)
        per_call = time_cuda(call, iters=50, warmup=5)
        plain_ms = time_cuda(lambda: apply_groups_fused(groups, backend="reference"),
                             iters=10, warmup=2)
        # W and g read, W′ written; 2 floor divides + 2 adds per weight
        n = sum(grp[0]["w"].numel() for grp in groups)
        ops, nbytes = 4 * n, 12 * n
        if arch == "VGG8B":  # the kernels line's row
            bound, by = add_time(per_kernel, "integer_sgd_update", ms, plain_ms, ops, nbytes)
        else:
            bound, by = nbytes / PEAK_BYTES * 1e3, "bytes"
        print(f"[time] {card} | integer_sgd_update {arch} fused apply, {len(groups)} tensors "
              f"({n:,} weights) int32, one launch | kernel {ms:.4f} ms (device, profiler; "
              f"back to back through the wrapper {per_call:.4f} ms per call) | plain "
              f"{plain_ms:.4f} ms | bound {bound:.5f} ms ({by}: {nbytes / 1e6:.3f} MB) | "
              f"{100 * bound / ms:.2f}% of bound | library none")
        # what a stream of the same bytes reaches here: torch.add reads two
        # int32 tensors and writes one, 12 bytes a weight, over one flat tensor
        flat_w = torch.cat([grp[0]["w"].flatten() for grp in groups])
        flat_g = torch.cat([grp[1]["w"].flatten() for grp in groups])
        _, kernels = device_profile(lambda: torch.add(flat_w, flat_g), 50)
        add_ms = sum(v for v, _ in kernels.values()) / 50
        print(f"[yardstick] {card} | {arch} fused apply's bytes as one torch.add of two flat "
              f"int32 tensors of {n:,}: " + (f"{add_ms:.4f} ms device, {nbytes / add_ms / 1e6:.1f} "
                                             f"GB/s" if add_ms else "not measured"))


def linear_grad_w_timing(card: str, per_kernel: dict) -> None:
    """Phase 9e: #3 and #4 at VGG8B's linear (the kernels line's step
    figure) and at mlp4's two layer shapes, on operands of the main path's
    digits (x in the NITRO-ReLU range: one digit; masked δ of two): the
    device time of every device operation of one call from the profiler
    (a launch is shorter than its wrapper's host path), back to back
    beside it, the bound, the plain version, and ``torch._int_mm`` at the
    same output as a yardstick."""
    import torch
    from repro_torch.core import optimizer as opt
    from repro_torch.kernels.nitro_matmul.nitro_matmul import (
        nitro_matmul_grad_w, nitro_matmul_grad_w_opt)
    from repro_torch.kernels.nitro_matmul.ref import (
        nitro_matmul_grad_w_opt_ref, nitro_matmul_grad_w_ref)

    g = torch.Generator().manual_seed(12)
    state = opt.init_state(327680, 25000, device="cuda")
    for tag, (b, m, n) in zip(("train step 7", "mlp4", "mlp4"), GRAD_W_SHAPES):
        x, delta, z = grad_w_operands(b, m, n, 1, 2, g)
        w = torch.randint(-(2 ** 15), 2 ** 15, (m, n), generator=g).to(torch.int32).cuda()
        calls = (("nitro_matmul_grad_w", lambda: nitro_matmul_grad_w(x, delta, z),
                  lambda: nitro_matmul_grad_w_ref(x, delta, z)),
                 ("nitro_matmul_grad_w_opt",
                  lambda: nitro_matmul_grad_w_opt(x, delta, z, w, state.gamma_inv, state.eta_inv),
                  lambda: nitro_matmul_grad_w_opt_ref(x, delta, z, w, state.gamma_inv,
                                                      state.eta_inv)))
        for kernel, fn, pfn in calls:
            events = time_cuda(fn, iters=20, warmup=3)
            ms, gemm = matmul_device(fn, kernel="grad_w_digit_kernel")
            plain_ms = time_cuda(pfn, iters=3, warmup=1)
            ops, nbytes = train_work("linear", kernel, (b, m), (m, n))
            if tag.startswith("train"):
                bound, by = add_time(per_kernel, kernel, ms, plain_ms, ops, nbytes)
            else:
                bound = max(ops / PEAK_OPS, nbytes / PEAK_BYTES) * 1e3
                by = "operations" if ops / PEAK_OPS >= nbytes / PEAK_BYTES else "bytes"
            print(f"[time] {card} | {tag} {kernel} x({b}, {m}) delta({b}, {n}) int32 | kernel "
                  f"{ms:.4f} ms (device, profiler: every device operation of the call, "
                  f"grad_w_digit_kernel {gemm:.4f}; {grad_w_digits_run(x, delta, z, 10)}; back "
                  f"to back through the wrapper {events:.4f} ms) | plain {plain_ms:.4f} ms | "
                  f"bound {bound:.5f} ms ({by}: {ops / 1e9:.3f} Gop, {nbytes / 1e6:.3f} MB) | "
                  f"{100 * bound / ms:.2f}% of bound | library none")
        grad_w_int_mm_yardstick(b, m, n, card, tag)


def grad_w_int_mm_yardstick(b, m, n, card: str, tag: str) -> None:
    """A yardstick the port never calls: ``torch._int_mm`` for (M × B) ·
    (B × N) int8 → int32, one digit product of the linear grad_W writing
    the same output; where cuBLASLt refuses the shape, its transpose
    ((N × B) · (B × M), the same bytes) and then M and N rounded up to
    multiples of 64 are tried (the line says which ran)."""
    import torch

    errors = []
    for rows, cols in ((m, n), (n, m), (-(-m // 64) * 64, -(-n // 64) * 64)):
        try:
            a = torch.randint(-128, 128, (rows, b), dtype=torch.int8, device="cuda")
            bt = torch.randint(-128, 128, (cols, b), dtype=torch.int8, device="cuda").t()
            ms = time_cuda(lambda: torch._int_mm(a, bt), iters=50, warmup=5)
            _, kernels = device_profile(lambda: torch._int_mm(a, bt), 20)
        except RuntimeError as e:  # a yardstick only: report, not fatal
            errors.append(str(e).splitlines()[0])
            continue
        dev = sum(v for v, _ in kernels.values()) / 20
        print(f"[yardstick] {card} | {tag} torch._int_mm ({rows}x{b}) . ({b}x{cols}) int8 -> "
              f"int32, one digit product of the linear grad_W: device {dev:.4f} ms, back to "
              f"back {ms:.4f} ms")
        return
    print(f"[yardstick] {card} | {tag} torch._int_mm: not measured ({'; '.join(errors)})")


def grad_x_timing(shapes, card: str, per_kernel: dict) -> None:
    """Phase 9d: per-shape kernel / plain / bound times of the input-
    gradient kernels at a VGG8B step's shapes (summed into the kernels
    line), at mlp4's linear shapes, with their digit products: #10 back to
    back (CUDA events) with its device time split into the GEMM and the
    pre-passes (profiler), and #6 at sf=1 (the grad_x route without z*)
    beside it as its yardstick; #5 by the device time of every device
    operation of one call (the memset, the masked δ pre-pass, the GEMM;
    its launches are shorter than the wrapper's host path), with
    ``torch._int_mm`` at its int8 GEMM shape beside it."""
    import torch

    g = torch.Generator().manual_seed(8)
    cases = [(f"train step {i}", kind, xs, ws, ai, True)
             for i, (kind, xs, ws, _, ai) in enumerate(shapes, 1)]
    cases += [("mlp4", kind, xs, ws, 10, False) for kind, xs, ws in MLP4_SHAPES]
    for tag, kind, xs, ws, ai, in_step in cases:
        _, w, delta, z = train_operands(xs, ws, g)
        kernel = "stream_conv_grad_x" if kind == "conv" else "nitro_matmul_grad_x"
        fn = grad_x_call(kind, w, delta, z, ai, "cuda")
        ms = time_cuda(fn, iters=20, warmup=3)
        plain_ms = time_cuda(grad_x_call(kind, w, delta, z, ai, "reference"),
                             iters=3, warmup=1)
        how = f"{grad_x_digits_run(w, delta, z, ai)}; "
        if kind == "linear":  # short beside its wrapper's host path
            events, (ms, gemm) = ms, matmul_device(fn, kernel="grad_x_digit_kernel")
            how = (f" (device, profiler: GEMM {gemm:.4f}, pre-pass and memset "
                   f"{ms - gemm:.4f}; {how}back to back through the wrapper {events:.4f} ms)")
        else:
            how = f" ({how}{conv_device_split(fn)})"
        ops, nbytes = train_work(kind, kernel, xs, ws)
        ops_ms, bytes_ms = ops / PEAK_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
        if in_step:
            bound, by = add_time(per_kernel, kernel, ms, plain_ms, ops, nbytes)
        else:
            bound = max(ops_ms, bytes_ms)
            by = "operations" if ops_ms >= bytes_ms else "bytes"
        print(f"[time] {card} | {tag} {kernel} delta{(*xs[:-1], ws[-1])} w{ws} int32 | "
              f"kernel {ms:.4f} ms{how} | plain {plain_ms:.4f} ms | bound {bound:.5f} ms "
              f"({by}: {ops / 1e9:.3f} Gop, {nbytes / 1e6:.3f} MB) | "
              f"{100 * bound / ms:.2f}% of bound | library none")
        if kind == "conv":
            sf1 = grad_x_call(kind, w, delta, None, ai, "cuda")
            print(f"[time] {card} | {tag} stream_conv sf=1 (grad_x without z*, δ "
                  f"pre-masked) | kernel {time_cuda(sf1, iters=20, warmup=3):.4f} ms "
                  f"({conv_device_split(sf1)})")
        else:
            matmul_int_mm_yardstick((xs[0], ws[1]), (ws[1], ws[0]), card, tag,
                                    "of the linear grad_x")


def train_end_to_end(res, ref, fuse, cfg, card: str) -> None:
    """Host-to-host time of one training step on the final state: the
    split step, the fuse_opt step and the fused apply on the kernels and
    the split step on the plain versions, in turns."""
    import numpy as np
    import torch
    from repro_torch.core import les, prng

    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.integers(-127, 128, (TRAIN_BATCH, *cfg.input_shape))
                         .astype(np.int32)).cuda()
    y = torch.from_numpy(rng.integers(0, 10, TRAIN_BATCH).astype(np.int32)).cuda()
    key = prng.PRNGKey(TRAIN_STEPS)
    state = res["state"]

    def fused_apply():
        grads, _, _ = les.compute_gradients(state, cfg, x, y, key)
        return les.apply_gradients(state, grads, fuse_opt=True)

    steps = {
        "split": lambda: les.train_step(state, cfg, x, y, key),
        "fuse_opt": lambda: les.train_step(state, cfg, x, y, key, fuse_opt=True),
        "fused_apply": fused_apply,
        "reference": lambda: les.train_step(state, cfg, x, y, key, backend="reference"),
    }
    order = ["split", "fuse_opt", "fused_apply", "reference"]
    ms = {}
    for name in order + order[::-1] + order:  # in turns: ABCD DCBA ABCD
        t = time_cuda(steps[name], iters=10, warmup=1)
        ms[name] = min(ms.get(name, t), t)
    print(f"[e2e-train] {card} | VGG8B full width, batch {TRAIN_BATCH}, host to "
          f"host: {ms['split']:.3f} ms per training step "
          f"({TRAIN_BATCH / ms['split'] * 1e3:.1f} img/s) on the kernels, "
          f"{ms['reference']:.3f} ms ({TRAIN_BATCH / ms['reference'] * 1e3:.1f} img/s) "
          f"on the plain versions (best of three turns of 10) | CLI step loop incl. "
          f"first steps: cuda {res['train_s'] / res['steps'] * 1e3:.3f} ms/step, "
          f"reference {ref['train_s'] / ref['steps'] * 1e3:.3f} ms/step")
    for name in ("split", "fuse_opt"):
        wall, kernels = device_profile(steps[name], 3)
        busy = sum(ms for ms, _ in kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:6]
        print(f"[profile] {card} | {name} step, 3 steps: {wall / 3:.3f} ms host to host, "
              f"device busy {busy / 3:.3f} ms per step ({100 * busy / wall:.1f}%), idle "
              f"{100 - 100 * busy / wall:.1f}% | top: " + "; ".join(
                  f"{k[:48]} {ms / 3:.3f} ms x{n // 3}" for k, (ms, n) in top))
    print(f"[e2e-train-fuse-opt] {card} | VGG8B full width, batch {TRAIN_BATCH}, host "
          f"to host: fuse_opt step {ms['fuse_opt']:.3f} ms "
          f"({TRAIN_BATCH / ms['fuse_opt'] * 1e3:.1f} img/s), split step "
          f"{ms['split']:.3f} ms ({TRAIN_BATCH / ms['split'] * 1e3:.1f} img/s), "
          f"compute_gradients + fused apply {ms['fused_apply']:.3f} ms "
          f"({TRAIN_BATCH / ms['fused_apply'] * 1e3:.1f} img/s) (same call, best of "
          f"three turns of 10) | CLI step loop incl. first steps: fuse_opt "
          f"{fuse['train_s'] / fuse['steps'] * 1e3:.3f} ms/step")


def mlp_end_to_end(res, ref, card: str) -> None:
    """Host-to-host time of one full-width mlp4 step at batch 64, on the
    kernels and on the plain versions, in turns."""
    import numpy as np
    import torch
    from repro_torch.configs import get_paper_config
    from repro_torch.core import les, prng

    cfg = get_paper_config("mlp4", scale=1.0)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(-127, 128, (TRAIN_BATCH, *cfg.input_shape))
                         .astype(np.int32)).cuda()
    y = torch.from_numpy(rng.integers(0, 10, TRAIN_BATCH).astype(np.int32)).cuda()
    key, state = prng.PRNGKey(TRAIN_STEPS), res["state"]
    steps = {b: (lambda b=b: les.train_step(state, cfg, x, y, key, backend=b))
             for b in ("cuda", "reference")}
    ms = {}
    for name in ("cuda", "reference", "reference", "cuda"):
        t = time_cuda(steps[name], iters=10, warmup=1)
        ms[name] = min(ms.get(name, t), t)
    wall, kernels = device_profile(steps["cuda"], 3)
    busy = sum(v for v, _ in kernels.values())
    launches = sum(n for _, n in kernels.values()) // 3
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:6]
    print(f"[e2e-train-mlp4] {card} | mlp4 full width (3072-3000x3-10), batch "
          f"{TRAIN_BATCH}, host to host: {ms['cuda']:.3f} ms per training step "
          f"({TRAIN_BATCH / ms['cuda'] * 1e3:.1f} img/s) on the kernels, "
          f"{ms['reference']:.3f} ms on the plain versions (best of two turns of 10); "
          f"device busy {busy / 3:.3f} ms per step ({100 * busy / wall:.1f}%) over "
          f"{launches} device launches per step | CLI step loop incl. first steps: "
          f"cuda {res['train_s'] / res['steps'] * 1e3:.3f} ms/step, reference "
          f"{ref['train_s'] / ref['steps'] * 1e3:.3f} ms/step | top: " + "; ".join(
              f"{k[:48]} {v / 3:.3f} ms x{n // 3}" for k, (v, n) in top))


def end_to_end(res, card: str) -> None:
    """Batch latency of the plan alone (host → logits on the host)."""
    import numpy as np

    plan = res["plan"]
    batch = np.stack(res["images"][:BATCH])
    ms = time_cuda(lambda: plan.logits(batch).cpu(), iters=20, warmup=3)
    snap = res["snapshot"]
    print(f"[e2e] {card} | plan batch of {BATCH}: {ms:.3f} ms "
          f"({BATCH / ms * 1e3:.1f} img/s) | engine: {len(res['results'])} "
          f"requests in {res['wall_s']:.3f} s ({len(res['results']) / res['wall_s']:.1f} "
          f"req/s), {snap['fleet']['batches']} batches, fill "
          f"{snap['fleet']['avg_batch_fill']:.2f}, "
          f"latency ms p50 {res['latency_ms']['p50']:.2f} p99 {res['latency_ms']['p99']:.2f}")


# ---------------------------------------------------------------------------
# Phase 10: the FP baselines at full width, beside NITRO-D
# ---------------------------------------------------------------------------

FP_LR = {"bp": 1e-3, "les": 2e-2}  # benchmarks/table2_cnn.py's rates: Adam, SGD
#: card vs CPU, each max |card − CPU| / max |CPU| of a tensor, set from
#: ``tools_torch/fp_rounding.py`` (how far float32 rounding alone moves these
#: cells).  Step 1 starts from one init on one batch, so the two differ only
#: in rounding order (cuDNN's sums against the CPU's): its loss is held
#: tight.  A float32 gradient of this net is discontinuous at rounding-level
#: ties (a max pool's argmax, the leaky ReLU's slope at 0), so at VGG8B's
#: first FP BP step the card's and the CPU's float32 gradients each lie
#: several 1e-3 of max |g| from float64, and from each other; it is read as
#: FP LES's first update p1 − p0 = −lr·g and FP BP's first moments
#: (mu = 0.1·g, nu = 0.001·g²).  Later steps carry those ties on, and Adam
#: moves every weight by about ±lr whatever |g| is, so after 4 FP BP steps a
#: weight can part by a tenth of its tensor's max while the RMS stays near
#: 0.5%; the later losses, FP LES's params and every RMS stay close.
FP_STEP1_LOSS_TOL = 1e-5
FP_STEP1_GRAD_TOL = 5e-2
FP_LOSS_TOL = {"bp": 2e-2, "les": 1e-4}   # every later step's loss
FP_FINAL_TOL = {"bp": 0.5, "les": 1e-2}   # the final params (and Adam's moments)
FP_FINAL_RMS = 5e-2   # FP BP's final params and moments: ‖card − CPU‖ / ‖CPU‖
PAPER_MEM_REDUCTION = 76.14  # %, the paper's abstract ("up to"); not measured here


def mlp_batches():
    """The config and the (x, y, key) of each step of the phase 5e CLI run:
    full-width mlp4 on the flattened tiles32, its first epoch's batches and
    ``PRNGKey(step)``."""
    import itertools

    import torch
    from repro_torch.configs import get_paper_config
    from repro_torch.core import prng
    from repro_torch.data import synthetic

    ds = synthetic.flatten_for_mlp(
        synthetic.make_image_dataset("tiles32", n_train=4096, n_test=512, seed=0))
    cfg = get_paper_config("mlp4", scale=1.0)
    if cfg.input_shape != ds.input_shape:
        die(f"mlp4 input {cfg.input_shape} != the flattened tiles32 {ds.input_shape}")
    pairs = itertools.islice(synthetic.batches(ds.x_train, ds.y_train, TRAIN_BATCH, seed=0),
                             TRAIN_STEPS)
    return cfg, [(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda(), prng.PRNGKey(it))
                 for it, (x, y) in enumerate(pairs)]


def tf32_flags() -> tuple:
    """cuDNN conv's and cuBLAS matmul's float32 precision settings."""
    import torch

    return (torch.backends.cudnn.conv.fp32_precision,
            torch.backends.cuda.matmul.fp32_precision)


def fp_input(x):
    """tiles32's int32 pixels as the FP baselines take them: float32 ÷ 64.0
    (``benchmarks/table2_cnn.py``)."""
    import torch

    return x.to(torch.float32) / 64.0


def fp_trajectory(kind: str, cfg, steps, device: str):
    """FP BP (``kind`` "bp", Adam) or FP LES ("les", SGD) from
    ``init_fp_params(PRNGKey(0))`` over ``steps``' (x, y, key) on
    ``device``: (init params, [(params, Adam state or None, loss)] after
    each step, every dropout mask drawn, the float32 settings each block's
    forward ran under)."""
    from repro_torch.core import fp_baselines as fp
    from repro_torch.core import prng

    masks, seen = [], []
    real_bernoulli, real_block = prng.bernoulli, fp._block_forward

    def bernoulli(key, p, shape, *, device="cpu"):
        masks.append(real_bernoulli(key, p, shape, device=device))
        return masks[-1]

    def block(*args, **kwargs):
        seen.append(tf32_flags())
        return real_block(*args, **kwargs)

    params = init = fp.init_fp_params(prng.PRNGKey(0), cfg, device=device)
    opt = fp.adam_init(params) if kind == "bp" else None
    out = []
    prng.bernoulli, fp._block_forward = bernoulli, block
    try:
        for x, y, key in steps:
            x, y = fp_input(x.to(device)), y.to(device)
            if kind == "bp":
                params, opt, loss = fp.train_step_bp(params, opt, cfg, x, y, key,
                                                     lr=FP_LR["bp"])
            else:
                params, loss = fp.train_step_les(params, cfg, x, y, key, lr=FP_LR["les"])
            out.append((params, opt, loss))
    finally:
        prng.bernoulli, fp._block_forward = real_bernoulli, real_block
    return init, out, masks, seen


def _dev(got, want) -> tuple[float, float]:
    """(max |got − want| / max |want|, ‖got − want‖ / ‖want‖) in float64."""
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    d = got - want
    return (float(d.abs().max() / want.abs().max().clamp_min(1e-30)),
            float(d.norm() / want.norm().clamp_min(1e-30)))


def fp_parity(tag: str, kind: str, cfg, steps, card_name: str) -> None:
    """Phase 10a for one cell: the card's run held against the CPU's on the
    same steps; dies past a tolerance, else prints the largest deviations
    seen."""
    import torch
    from repro_torch.parallel.tree import leaves

    before = tf32_flags()
    init, card, masks, seen = fp_trajectory(kind, cfg, steps, "cuda")
    if tf32_flags() != before:
        die(f"10a {tag}: the FP calls left the float32 settings at {tf32_flags()}, "
            f"were {before}")
    if set(seen) != {("ieee", "ieee")}:
        die(f"10a {tag}: a block ran under the float32 settings {set(seen)} (TF32 on)")
    t0 = time.perf_counter()
    cinit, cpu, cmasks, _ = fp_trajectory(kind, cfg, [(x.cpu(), y.cpu(), k)
                                                     for x, y, k in steps], "cpu")
    cpu_s = time.perf_counter() - t0
    for a, b in zip(leaves(init), leaves(cinit)):
        if not torch.equal(a.cpu(), b):
            die(f"10a {tag}: init_fp_params on the card differs from the CPU's")
    if len(masks) != len(cmasks) or (any(b.dropout > 0 for b in cfg.blocks) and not cmasks):
        die(f"10a {tag}: {len(masks)} dropout masks on the card, {len(cmasks)} on the CPU")
    for i, (m, c) in enumerate(zip(masks, cmasks)):
        if m.device.type != "cuda" or not torch.equal(m.cpu(), c):
            die(f"10a {tag}: dropout mask {i} on the card differs from the CPU's")
    worst = {"loss1": 0.0, "grad1": 0.0, "loss": 0.0, "final": 0.0, "final_rms": 0.0}
    for i, ((_, _, loss), (_, _, closs)) in enumerate(zip(card, cpu)):
        rel = abs(float(loss) - float(closs)) / max(abs(float(closs)), 1e-30)
        key, tol = ("loss1", FP_STEP1_LOSS_TOL) if i == 0 else ("loss", FP_LOSS_TOL[kind])
        worst[key] = max(worst[key], rel)
        if not rel <= tol:
            die(f"10a {tag}: step {i} loss {float(loss)} vs CPU {float(closs)} "
                f"(rel {rel:.3e} > {tol})")
    p1, o1, _ = card[0]
    cp1, co1, _ = cpu[0]
    if kind == "bp":
        grads = list(zip(leaves(o1.mu) + leaves(o1.nu), leaves(co1.mu) + leaves(co1.nu)))
    else:
        grads = [(a - b, c - d) for a, b, c, d in
                 zip(leaves(p1), leaves(init), leaves(cp1), leaves(cinit))]
    for a, b in grads:
        if b.abs().max() > 0:
            worst["grad1"] = max(worst["grad1"], _dev(a, b)[0])
    if not worst["grad1"] <= FP_STEP1_GRAD_TOL:
        die(f"10a {tag}: step 1's gradient deviates {worst['grad1']:.3e} > "
            f"{FP_STEP1_GRAD_TOL}")
    (pn, on, _), (cpn, con, _) = card[-1], cpu[-1]
    finals = list(zip(leaves(pn), leaves(cpn)))
    if kind == "bp":
        finals += list(zip(leaves(on.mu) + leaves(on.nu), leaves(con.mu) + leaves(con.nu)))
        if int(on.count) != int(con.count) or on.count.dtype != con.count.dtype:
            die(f"10a {tag}: Adam counts {on.count} vs {con.count}")
    for a, b in finals:
        if b.abs().max() == 0:
            if a.abs().max() != 0:
                die(f"10a {tag}: a tensor zero on the CPU is not on the card")
            continue
        mx, rms = _dev(a, b)
        worst["final"], worst["final_rms"] = max(worst["final"], mx), max(worst["final_rms"], rms)
    if not worst["final"] <= FP_FINAL_TOL[kind] or \
            (kind == "bp" and not worst["final_rms"] <= FP_FINAL_RMS):
        die(f"10a {tag}: after {len(cpu)} steps the state deviates {worst['final']:.3e} "
            f"(RMS {worst['final_rms']:.3e}) > {FP_FINAL_TOL[kind]}")
    what = "Adam" if kind == "bp" else "SGD"
    print(f"[fp-parity] {card_name} | {tag}: FP {kind.upper()} ({what}, lr {FP_LR[kind]}) "
          f"{len(card)} steps on the card, held against the CPU's ({cpu_s:.1f} s there): init "
          f"bitwise, {len(cmasks)} dropout masks bitwise, {len(seen)} block forwards under "
          f"float32 settings {sorted(set(map(str, seen)))}; max deviation: step 1 loss "
          f"{worst['loss1']:.3e} (tol {FP_STEP1_LOSS_TOL}), gradient {worst['grad1']:.3e} "
          f"(tol {FP_STEP1_GRAD_TOL}), later "
          f"losses {worst['loss']:.3e} (tol {FP_LOSS_TOL[kind]}), final "
          f"{'params and moments' if kind == 'bp' else 'params'} {worst['final']:.3e} "
          f"(tol {FP_FINAL_TOL[kind]}), RMS {worst['final_rms']:.3e}"
          + (f" (tol {FP_FINAL_RMS})" if kind == "bp" else ""))


def tree_bytes(tree) -> int:
    """Bytes of every tensor in ``tree``."""
    from repro_torch.parallel.tree import leaves

    return sum(t.numel() * t.element_size() for t in leaves(tree))


def step_peak(step) -> int:
    """Peak bytes allocated on the card during one ``step()`` above those
    allocated just before it, after one warm-up call."""
    import torch

    step()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    del out
    return peak


def fp_arms(cfg, batch) -> dict:
    """name → (persistent state, one step on ``batch``) of NITRO-D split,
    NITRO-D ``fuse_opt``, FP LES and FP BP from ``PRNGKey(0)``, on the card.
    The state is the params and the optimiser state (IntegerSGD's scalars;
    Adam's two moments and count; SGD keeps none)."""
    from repro_torch.core import fp_baselines as fp
    from repro_torch.core import les, prng

    x, y, key = batch
    xf = fp_input(x)
    state = les.create_train_state(prng.PRNGKey(0), cfg, device="cuda")
    params = fp.init_fp_params(prng.PRNGKey(0), cfg, device="cuda")
    opt = fp.adam_init(params)
    return {
        "NITRO-D split": (state, lambda: les.train_step(state, cfg, x, y, key)),
        "NITRO-D fuse_opt": (state, lambda: les.train_step(state, cfg, x, y, key,
                                                           fuse_opt=True)),
        "FP LES": (params, lambda: fp.train_step_les(params, cfg, xf, y, key,
                                                     lr=FP_LR["les"])),
        "FP BP": ((params, opt), lambda: fp.train_step_bp(params, opt, cfg, xf, y, key,
                                                          lr=FP_LR["bp"])),
    }


def fp_memory(tag: str, cfg, batch, card: str) -> None:
    """Phase 10b, ``[fp-mem]``: each arm's persistent state and the peak of
    one step above what was allocated before it; the reduction against FP
    BP beside the paper's figure."""
    mem = {name: (tree_bytes(state), step_peak(step))
           for name, (state, step) in fp_arms(cfg, batch).items()}
    bp_state, bp_peak = mem["FP BP"]

    def red(name, i=None):
        s, p = mem[name]
        mine, theirs = (s + p, bp_state + bp_peak) if i is None else (mem[name][i],
                                                                     mem["FP BP"][i])
        return 100 * (1 - mine / theirs)

    parts = " | ".join(f"{k}: state {s / 1e6:.2f} MB + step peak {p / 1e6:.2f} MB = "
                       f"{(s + p) / 1e6:.2f} MB" for k, (s, p) in mem.items())
    print(f"[fp-mem] {card} | {tag} full width, batch {TRAIN_BATCH}; device bytes "
          f"allocated: state (params + optimiser state) and the peak of one step above "
          f"what was allocated before it (torch.cuda.max_memory_allocated, after a "
          f"warm-up step) | {parts} | reduction 1 - NITRO-D / FP BP: split "
          f"{red('NITRO-D split'):.2f}%, fuse_opt {red('NITRO-D fuse_opt'):.2f}% (state "
          f"alone {red('NITRO-D split', 0):.2f}%, step peak alone split "
          f"{red('NITRO-D split', 1):.2f}%, fuse_opt {red('NITRO-D fuse_opt', 1):.2f}%) | "
          f"the paper's figure, from its abstract, not measured here: up to "
          f"{PAPER_MEM_REDUCTION}%")


def host_ms(fn, iters: int) -> float:
    """Host milliseconds per call over ``iters`` calls ending in a
    synchronise, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def fp_step_times(cfg, batch, card: str) -> None:
    """Phase 10c, ``[fp-step]``: FP BP, FP LES and the NITRO-D split step at
    VGG8B batch 64, host to host in turns A B C C B A, then each one's
    device time and busy share under the profiler."""
    arms = fp_arms(cfg, batch)
    order = ["FP BP", "FP LES", "NITRO-D split"]
    ms = {}
    for name in order + order[::-1]:
        t = host_ms(arms[name][1], iters=5)
        ms[name] = min(ms.get(name, t), t)
    parts = []
    for name in order:
        wall, kernels = device_profile(arms[name][1], 3)
        busy = sum(v for v, _ in kernels.values()) / 3
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:3]
        parts.append(f"{name} {ms[name]:.3f} ms ({TRAIN_BATCH / ms[name] * 1e3:.1f} img/s), "
                     f"device {busy:.3f} ms ({100 * busy / (wall / 3):.1f}% busy; top: "
                     + "; ".join(f"{k[:40]} {v / 3:.3f} ms x{n // 3}" for k, (v, n) in top)
                     + ")")
    print(f"[fp-step] {card} | VGG8B full width, batch {TRAIN_BATCH}, ms per step host to "
          f"host (best of two turns of 5, in turns A B C C B A), device ms per step and busy "
          f"share from torch.profiler (3 steps) | " + " | ".join(parts))


def fp_phase(card: str) -> None:
    """Phase 10: the FP baselines at full width beside NITRO-D."""
    t0 = time.perf_counter()
    cfg, steps = cli_batches()
    mlp_cfg, mlp_steps = mlp_batches()
    fp_parity("VGG8B", "bp", cfg, steps, card)
    fp_parity("VGG8B", "les", cfg, steps, card)
    fp_parity("mlp4", "bp", mlp_cfg, mlp_steps, card)
    fp_memory("VGG8B", cfg, steps[0], card)
    fp_memory("mlp4", mlp_cfg, mlp_steps[0], card)
    fp_step_times(cfg, steps[0], card)
    print(f"[fp] phase 10 took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 11: an integer-only card step (int_matmul) and the LM training path
# ---------------------------------------------------------------------------

INT_MATMUL = {
    "source": "src/repro_torch/kernels/int_matmul/csrc/int_matmul.cu",
    "replaces": "src/repro/core/numerics.py:35",
}
#: the train CLI's evaluation at the end of phase 5's run: its 512 test
#: images (n_test, as ``cli_batches``) in batches of TRAIN_BATCH
CLI_EVAL_BATCHES = 512 // TRAIN_BATCH
#: the LM's NITRO int8 MLP products at llama3.2-1b's full width, batch 4 ×
#: seq 512: x (tokens, d_model) · w_in (d_model, d_ff), and back down
LM_INT8_SHAPES = [(2048, 2048, 8192), (2048, 8192, 2048)]
#: the learning and output layers' fan-ins of a VGG8B step (grad_x or not)
VGG8B_FAN_INS = [(1024, False), (3200, True), (4096, True), (4096, True), (2048, True),
                 (2048, True), (2048, True), (1024, True)]
#: routes a step's int_matmul calls take: every VGG8B and mlp4 training
#: call on T (one launch), every llama3.2-1b int8 product on W
STEP_ROUTES = {"VGG8B": "T", "mlp4": "T", "llama3.2-1b int8": "W"}


def int_matmul_counter():
    from repro_torch.kernels.int_matmul.int_matmul import int_matmul_cuda

    return int_matmul_cuda.launches


def device_parts(fn, calls: int, parts: dict, tries: int = 3) -> dict:
    """Device ms per call of ``fn`` by part, from the profiler: ``parts``
    maps a label to a substring of its kernels' names (a memset's is
    "Memset"); the device operations no label names go to "other", and
    "total" sums them all.  From a profiler session that saw device time."""
    for _ in range(tries):
        _, kernels = device_profile(fn, calls)
        if kernels:
            break
    out = {label: 0.0 for label in parts}
    out["other"] = 0.0
    for name, (ms, _) in kernels.items():
        label = next((p for p, key in parts.items() if key in name), "other")
        out[label] += ms / calls
    out["total"] = sum(ms for ms, _ in kernels.values()) / calls
    return out


def record_int_matmul(fn):
    """``(fn(), calls, routes)``: every ``int_matmul`` kernel call inside
    ``fn`` with copies of its operands (strides kept), ``fn``'s launches of
    it and of each route (the counters set to 0 just before and read just
    after); the recorded calls must match the launches, and the routes
    the rule's choice for each call."""
    from repro_torch.kernels.int_matmul import int_matmul as mod

    real, calls = mod.int_matmul_cuda, []

    def rec(a, b):
        calls.append((a.clone(), b.clone()))
        return real(a, b)

    rec.launches, rec.routes = real.launches, real.routes
    real.launches.reset()
    for counter in real.routes.values():
        counter.reset()
    mod.int_matmul_cuda = rec
    try:
        out = fn()
    finally:
        mod.int_matmul_cuda = real
    if len(calls) != real.launches.value:
        die(f"int_matmul: {len(calls)} calls recorded, {real.launches.value} launches counted")
    routes = {r: c.value for r, c in real.routes.items() if c.value}
    want = Counter(route_of(a, b) for a, b in calls)
    if routes != dict(want):
        die(f"int_matmul: routes launched {routes}, the rule's {dict(want)}")
    return out, calls, routes


def route_of(a, b) -> str:
    """The route ``plan`` gives ``a @ b`` ("WT", route W after the
    transpose pass, counts as "W")."""
    from repro_torch.kernels.int_matmul import plan

    r = plan(tuple(a.shape), a.dtype, a.stride(), a.data_ptr(),
             tuple(b.shape), b.dtype, b.stride(), b.data_ptr())
    return "W" if r == "WT" else r


def routed(a, b) -> tuple:
    """``(int_matmul_cuda(a, b), the route it launched)``; dies unless that
    is the rule's."""
    from repro_torch.kernels.int_matmul import int_matmul_cuda

    before = {r: c.value for r, c in int_matmul_cuda.routes.items()}
    out = int_matmul_cuda(a, b)
    took = [r for r, c in int_matmul_cuda.routes.items() if c.value != before[r]]
    want = [route_of(a, b)] if out.numel() and a.shape[1] else []  # empty: no launch
    if took != want:
        die(f"int_matmul {tuple(a.shape)} x {tuple(b.shape)}: launched {took}, the rule says "
            f"{want}")
    return out, (took or ["none"])[0]


def int_matmul_cases(g):
    """(label, a, b) on the card: the materialise conv shapes, the LM int8
    products at full width with b N-major and K-major, route W ragged, at
    K = 48 and at M = 16, K = 131,072 whose sum is 2³¹ and wraps, a VGG8B
    step's thin products on the views it passes, ragged M/N/K, a
    contraction deeper than 16,384 (it splits) and full-range int32
    operands that wrap."""
    import torch

    def ints(shape, lo, hi, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int64).to(dtype).cuda()

    cases = []
    # materialise convs at VGG8B's first two shapes, batch 8: forward patches
    # · w, grad_W patchesᵀ · δ (wide), grad_x δ-patches · rot(w)
    for (h, c, f) in ((32, 3, 128), (32, 128, 256)):
        p = 8 * h * h
        cases.append((f"materialise fwd ({p}x{9 * c})x({9 * c}x{f})",
                      ints((p, 9 * c), -127, 128), ints((9 * c, f), -64, 65)))
        cases.append((f"materialise grad_W ({9 * c}x{p})x({p}x{f})",
                      ints((9 * c, p), -127, 128), ints((p, f), -2 ** 20, 2 ** 20)))
        cases.append((f"materialise grad_x ({p}x{9 * f})x({9 * f}x{c})",
                      ints((p, 9 * f), -2 ** 20, 2 ** 20), ints((9 * f, c), -64, 65)))
    for m, k, n in LM_INT8_SHAPES:
        a = ints((m, k), -127, 128, torch.int8)
        cases.append((f"LM int8 ({m}x{k})x({k}x{n}) b N-major", a,
                      ints((k, n), -127, 128, torch.int8)))
        cases.append((f"LM int8 ({m}x{k})x({k}x{n}) b K-major", a,
                      ints((n, k), -127, 128, torch.int8).t()))
    cases.append(("ragged route W (2047x2064)x(2064x8200) b K-major",
                  ints((2047, 2064), -128, 128, torch.int8),
                  ints((8200, 2064), -128, 128, torch.int8).t()))
    cases.append(("route W, K of one partial stage (4096x48)x(48x4096) b K-major",
                  ints((4096, 48), -128, 128, torch.int8),
                  ints((4096, 48), -128, 128, torch.int8).t()))
    cases.append(("route W, M of 16 (16x2048)x(2048x2048) b K-major",
                  ints((16, 2048), -128, 128, torch.int8),
                  ints((2048, 2048), -128, 128, torch.int8).t()))
    cases.append(("wrap K=131072 (128x131072)x(131072x144), every term (-128)(-128)",
                  torch.full((128, 131072), -128, dtype=torch.int8, device="cuda"),
                  torch.full((144, 131072), -128, dtype=torch.int8, device="cuda").t()))
    # a VGG8B step's thin products as the step passes them: forward x·W,
    # grad_x δ·Wᵀ and grad_W xᵀ·δ on the transposed views, δ wide
    for k in sorted({k for k, _ in VGG8B_FAN_INS}):
        x, w, delta = ints((TRAIN_BATCH, k), -127, 128), ints((k, 10), -9, 10), \
            ints((TRAIN_BATCH, 10), -2 ** 22, 2 ** 22)
        cases.append((f"VGG8B forward ({TRAIN_BATCH}x{k})x({k}x10)", x, w))
        cases.append((f"VGG8B grad_x ({TRAIN_BATCH}x10)x(10x{k}) w.T", delta, w.T))
        cases.append((f"VGG8B grad_W ({k}x{TRAIN_BATCH})x({TRAIN_BATCH}x10) x.T", x.T, delta))
    cases.append(("ragged int8 (37x1000)x(1000x23)", ints((37, 1000), -128, 128, torch.int8),
                  ints((1000, 23), -128, 128, torch.int8)))
    cases.append(("ragged int8 x int32 (5x77)x(77x130)", ints((5, 77), -128, 128, torch.int8),
                  ints((77, 130), -2 ** 31, 2 ** 31)))
    cases.append(("deep K=40000 (64x40000)x(40000x10)", ints((64, 40000), -127, 128),
                  ints((40000, 10), -2 ** 24, 2 ** 24)))
    cases.append(("deep K=70001 int8 (3x70001)x(70001x17)",
                  ints((3, 70001), -128, 128, torch.int8), ints((70001, 17), -128, 128, torch.int8)))
    full_a, full_b = ints((17, 300), -2 ** 31, 2 ** 31), ints((300, 33), -2 ** 31, 2 ** 31)
    full_a[0, :] = -2 ** 31
    full_b[:, 0] = -2 ** 31
    full_a[1, :] = 2 ** 31 - 1
    full_b[:, 1] = 2 ** 31 - 1
    cases.append(("full range int32 with INT32_MIN/MAX (17x300)x(300x33)", full_a, full_b))
    cases.append(("empty K (4x0)x(0x5)", ints((4, 0), 0, 1), ints((0, 5), 0, 1)))
    return cases


def int_matmul_step(what: str, batches_fn, errs: dict) -> tuple:
    """One training step on the card through the port's entry point: its
    int_matmul calls recorded and counted, each held bitwise against
    ``int_matmul_ref`` on its inputs, and the same step under the
    quickstart's float audit, which must count 0; then one ``eval_step``
    (the train CLI's evaluation, a batch) likewise recorded and held.
    Returns (the step's launches, its calls, the eval batch's launches, the
    step's launches by route)."""
    import importlib.util

    from repro_torch.core import les, prng
    from repro_torch.core.numerics import int_matmul_ref
    from repro_torch.kernels.int_matmul import int_matmul_cuda

    cfg, steps = batches_fn()
    x, y, key = steps[0]
    state = les.create_train_state(prng.PRNGKey(0), cfg, device="cuda")
    _, calls, routes = record_int_matmul(lambda: les.train_step(state, cfg, x, y, key))
    if not calls:
        die(f"11a: a {what} step launched no int_matmul")
    if routes != {STEP_ROUTES[what]: len(calls)}:
        die(f"11a: a {what} step's {len(calls)} int_matmul calls took routes {routes}")
    for i, (a, b) in enumerate(calls):
        compare(f"int_matmul {what} step call {i} {a.dtype}{tuple(a.shape)} x "
                f"{b.dtype}{tuple(b.shape)}", int_matmul_cuda(a, b), int_matmul_ref(a, b), errs)
    spec = importlib.util.spec_from_file_location(
        "examples_torch_quickstart", ROOT / "examples_torch" / "quickstart.py")
    quickstart = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(quickstart)
    audit = quickstart.audit_train_step(state, cfg, x, y, key)
    if audit.n_float != 0:
        die(f"11a: the quickstart audit counts {audit.n_float} float tensors in a {what} "
            f"card train step: {dict(audit.ops)}")
    _, eval_calls, eval_routes = record_int_matmul(lambda: les.eval_step(state, cfg, x, y))
    for i, (a, b) in enumerate(eval_calls):
        compare(f"int_matmul {what} eval batch call {i} {a.dtype}{tuple(a.shape)} x "
                f"{b.dtype}{tuple(b.shape)}", int_matmul_cuda(a, b), int_matmul_ref(a, b), errs)
    print(f"[int-matmul] {what} step on the card: {len(calls)} int_matmul launches "
          f"({', '.join(sorted({f'{tuple(a.shape)}x{tuple(b.shape)}' for a, b in calls}))}), "
          f"routes {routes}, each bitwise int_matmul_ref; the quickstart audit counts 0 "
          f"float tensors; an eval batch {len(eval_calls)} launches, routes {eval_routes}, "
          f"bitwise")
    return len(calls), calls, len(eval_calls), routes


def int_matmul_phase(errs: dict) -> dict:
    """Phase 11a: int_matmul bitwise ``int_matmul_ref`` (the float64 limb
    GEMMs) at every listed shape and case, twice each; one VGG8B and one
    mlp4 card step with no float tensor, their int_matmul calls counted."""
    import torch

    from repro_torch.core.numerics import int_matmul_ref

    g = torch.Generator().manual_seed(11)
    taken = []
    for label, a, b in int_matmul_cases(g):
        want = int_matmul_ref(a, b)
        for rep in (1, 2):
            got, route = routed(a, b)
            compare(f"int_matmul {label} #{rep}", got, want, errs)
        taken.append(f"{label}: {route}")
    print(f"[int-matmul] {len(taken)} cases, each bitwise twice on the route the rule "
          f"gives: {'; '.join(taken)}")
    vgg, vgg_calls, vgg_eval, vgg_routes = int_matmul_step("VGG8B", cli_batches, errs)
    mlp, _, _, mlp_routes = int_matmul_step("mlp4", mlp_batches, errs)
    return {"vgg8b": vgg, "mlp4": mlp, "vgg_calls": vgg_calls, "vgg8b_eval": vgg_eval,
            "routes": {"vgg8b": vgg_routes, "mlp4": mlp_routes}}


def int_matmul_timing(vgg_calls, card: str) -> dict:
    """int_matmul's row of the kernels line: one VGG8B training step's calls
    (11a's recorded operands, int32, the views the step passes: route T)
    replayed, the kernel's device time and device launches (the profiler:
    its launches are shorter than the wrapper's host path; the
    back-to-back time printed beside it) against the float64 limb GEMMs,
    and the bound of the same products.  No PyTorch call multiplies int32
    matrices on the card (``torch._int_mm`` takes int8), so
    ``library_ms`` is null here; the LM's int8 products have it.  Then
    ``[time]`` at the two LM int8 shapes: route W on a K-major b beside
    ``torch._int_mm`` on the same operands, the bound and its share; the
    N-major b's transpose pass on its own line; route D's split (the
    parent's digit GEMM, unchanged) at the same shape."""
    import torch

    from repro_torch.core.numerics import int_matmul_ref
    from repro_torch.kernels.int_matmul import int_matmul_cuda, run_route
    from repro_torch.kernels.int_matmul.int_matmul import transpose_int8

    def replay(fn):
        return lambda: [fn(a, b) for a, b in vgg_calls]

    _, kern = device_profile(replay(int_matmul_cuda), 10)
    _, limb = device_profile(replay(int_matmul_ref), 10)
    dev, dev_limb = sum(v for v, _ in kern.values()) / 10, sum(v for v, _ in limb.values()) / 10
    dev_launches = sum(n for _, n in kern.values()) / 10
    b2b = time_cuda(replay(int_matmul_cuda), iters=20, warmup=3)
    ops = sum(2 * a.shape[0] * a.shape[1] * b.shape[1] for a, b in vgg_calls)
    nbytes = sum(a.numel() * a.element_size() + b.numel() * b.element_size()
                 + 4 * a.shape[0] * b.shape[1] for a, b in vgg_calls)
    ops_ms, bytes_ms = ops / PEAK_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    print(f"[int-matmul-step] {card} | one VGG8B step's {len(vgg_calls)} int_matmul calls "
          f"({', '.join(sorted({str(a.dtype).replace('torch.', '') for a, _ in vgg_calls}))} "
          f"operands, routes {dict(Counter(route_of(a, b) for a, b in vgg_calls))}, route T "
          f"launching once a call): device {dev:.4f} ms, {dev_launches:g} device launches a "
          f"replay in the profiler's record (int_matmul kernel; back to back {b2b:.4f} ms) "
          f"against {dev_limb:.4f} ms (the float64 limb GEMMs) | bound "
          f"{max(ops_ms, bytes_ms):.5f} ms ({'operations' if ops_ms >= bytes_ms else 'bytes'})")
    g = torch.Generator().manual_seed(12)
    stream = torch.cuda.current_stream().cuda_stream
    parts = {"memset": "Memset", "b's planes": "delta_digits_kernel",
             "a's planes": "row_digits_kernel", "GEMM": "matmul_digit_kernel"}
    for m, k, n in LM_INT8_SHAPES:
        a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8).cuda()
        b_n = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8).cuda()
        b = b_n.t().contiguous().t()  # the same values K-major, as the LM's weight lies
        if route_of(a, b) != "W" or not torch.equal(int_matmul_cuda(a, b), torch._int_mm(a, b)):
            die(f"int_matmul ({m}x{k})x({k}x{n}): not route W, or not torch._int_mm's product")
        ms = time_cuda(lambda: int_matmul_cuda(a, b), iters=20, warmup=3)
        w_dev = device_parts(lambda: int_matmul_cuda(a, b), 20, {"W": "gemm_s8_kernel"})
        plain = time_cuda(lambda: int_matmul_ref(a, b), iters=3, warmup=1)
        lib = time_cuda(lambda: torch._int_mm(a, b), iters=20, warmup=3)
        o_ms, b_ms = 2 * m * k * n / PEAK_OPS * 1e3, (m * k + k * n + 4 * m * n) / PEAK_BYTES * 1e3
        bound = max(o_ms, b_ms)
        print(f"[time] {card} | int_matmul LM int8 ({m}x{k})x({k}x{n}) route W, b K-major | "
              f"kernel {ms:.4f} ms (device {w_dev['total']:.4f}, one launch) | plain "
              f"{plain:.4f} ms | bound {bound:.5f} ms ({'operations' if o_ms >= b_ms else 'bytes'})"
              f" | {100 * bound / ms:.2f}% of bound | library torch._int_mm {lib:.4f} ms, "
              f"same operands")
        tr = time_cuda(lambda: transpose_int8(b_n, stream), iters=20, warmup=3)
        wt = time_cuda(lambda: int_matmul_cuda(a, b_n), iters=20, warmup=3)
        print(f"[time] {card} | int_matmul LM int8 ({m}x{k})x({k}x{n}) route W, b N-major | "
              f"transpose pass {tr:.4f} ms ({k * n / 1e6:.1f} MB each way) | the call with it "
              f"{wt:.4f} ms")
        d = device_parts(lambda: run_route("D", a, b_n), 10, parts)
        print(f"[time] {card} | int_matmul LM int8 ({m}x{k})x({k}x{n}) route D (the parent's "
              f"digit GEMM), device | " + " | ".join(f"{p} {v:.4f} ms" for p, v in d.items()))
    return {"ms": dev, "plain_ms": dev_limb, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "library_ms": None,
            "device_launches_per_step": dev_launches, "back_to_back_ms": b2b,
            "timed_on": f"one VGG8B training step's {len(vgg_calls)} calls (batch "
                        f"{TRAIN_BATCH}), device time"}


def lm_int8_timing(calls, card: str) -> dict:
    """The LM int8 path's numbers for int_matmul's row: one llama3.2-1b
    int8_matmul step's calls (11c's recorded int8 operands) replayed, the
    kernel's, the float64 limb GEMMs' and ``torch._int_mm``'s device time
    over them, and their bound."""
    import torch

    from repro_torch.core.numerics import int_matmul_ref
    from repro_torch.kernels.int_matmul import int_matmul_cuda

    if any(a.dtype != torch.int8 or b.dtype != torch.int8 for a, b in calls):
        die("11c: an int8_matmul product with operands that are not int8")
    # the recorded b keeps the weight's K-major strides: the replay takes
    # route W, and _int_mm (which wants b column-major) reads it as it is
    if {route_of(a, b) for a, b in calls} != {"W"}:
        die("11c: a replayed int8 product does not take route W")
    cols = [(a, b.t().contiguous().t()) for a, b in calls]

    def total(fn, pairs, n):
        _, kernels = device_profile(lambda: [fn(a, b) for a, b in pairs], n)
        return sum(v for v, _ in kernels.values()) / n

    ms, plain, lib = (total(int_matmul_cuda, calls, 3), total(int_matmul_ref, calls, 1),
                      total(torch._int_mm, cols, 3))
    ops = sum(2 * a.shape[0] * a.shape[1] * b.shape[1] for a, b in calls)
    nbytes = sum(a.numel() + b.numel() + 4 * a.shape[0] * b.shape[1] for a, b in calls)
    ops_ms, bytes_ms = ops / PEAK_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    shapes = sorted({f"{tuple(a.shape)}x{tuple(b.shape)}" for a, b in calls})
    print(f"[int-matmul-lm] {card} | one llama3.2-1b int8_matmul step's {len(calls)} "
          f"int_matmul calls ({', '.join(shapes)}), all on route W: device {ms:.4f} ms "
          f"(int_matmul kernel) | plain {plain:.4f} ms (float64 limb GEMMs) | library torch._int_mm "
          f"{lib:.4f} ms | bound {max(ops_ms, bytes_ms):.5f} ms "
          f"({'operations' if ops_ms >= bytes_ms else 'bytes'}, "
          f"{100 * max(ops_ms, bytes_ms) / ms:.2f}% of bound)")
    return {"ms": ms, "plain_ms": plain, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "library_ms": lib,
            "timed_on": f"one llama3.2-1b int8_matmul step's {len(calls)} calls (batch "
                        f"{LM_FULL['batch']} x seq {LM_FULL['seq']}), device time"}


#: LM parity on the card (11b): the steps a case runs, and the variants of
#: each arch's smoke config (own dtype; float32 with 2 LES groups, whisper
#: without them: its decoder takes none)
LM_STEPS = 3
#: AdamW moves a coordinate at most about lr a step (|m̂/√v̂| ≤ 1.001 for
#: t ≤ 3 at β = (0.9, 0.95)), so two runs whose gradients differ by
#: rounding part by at most 2.01 · Σ lr
LM_ADAM_PART = 2.01
#: AdamW's moments after each step, in rounding levels ε: the gradient's
#: 3, mu being linear in the gradients; nu quadratic, twice that
LM_MU_LEVELS, LM_NU_LEVELS = 3.0, 6.0
#: llama3.2-1b at full width (11c): batch × seq, steps, the int8 run's steps
LM_FULL = {"batch": 4, "seq": 512, "steps": 4, "int8_steps": 2}
#: step 1's loss against the same loss in float64 on the card (the same
#: init and batch, every op in float64: tools_torch/fp_rounding.py's
#: float64_math): bf16 moves a mean cross-entropy by far less than 1%
#: (11b's smoke losses lie within 5e-5 of the CPU's)
LM_LOSS_TOL = 1e-2


def lm_batch(cfg, device, b: int = 2, s: int = 16, seed: int = 0) -> dict:
    """A seeded batch for a smoke config (tests/_torch_lm.py's)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.embeds_input:
        out["embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    if cfg.encoder_layers:
        out["enc_embeds"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def _rel(a, b) -> float:
    d = (a.double().cpu() - b.double().cpu()).abs().max()
    m = b.double().abs().max().cpu()
    return float(d / m) if m > 0 else float(d)


def lm_case(arch: str, f32: bool, les: int) -> str:
    """One 11b case: the port's smoke step on the card against its CPU path
    from the same init and batch.  ε is the CPU path's rounding level (its
    first gradient against the same with params, batch and every op in
    float64, every leaf); the card's gradient leaves lie within 3 ε, each
    step's loss within ε (relative), its grad norm within 3 ε, AdamW's mu
    within 3 ε and nu within 6 ε after each step (each leaf, relative to
    its largest value), every param within 2.01 · Σ lr."""
    import dataclasses

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.core import prng
    from repro_torch.parallel.tree import leaves, tree_map
    from repro_torch.train import trainer
    from tools_torch.fp_rounding import float64_math

    cfg = get_smoke_config(arch)
    if f32:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    if les:
        cfg = dataclasses.replace(cfg, les_groups=les, num_layers=max(cfg.num_layers, 4))
    cpu = trainer.init_state(prng.PRNGKey(0), cfg, device="cpu")
    gpu = tree_map(lambda t: t.cuda(), cpu)
    bc, bg = lm_batch(cfg, "cpu"), lm_batch(cfg, "cuda")
    _, gc = trainer.value_and_grad(cpu[0], cfg, bc)
    _, gg = trainer.value_and_grad(gpu[0], cfg, bg)
    b64 = {k: (v.double() if v.is_floating_point() else v) for k, v in bc.items()}
    with float64_math():
        _, g64 = trainer.value_and_grad(tree_map(torch.Tensor.double, cpu[0]),
                                        dataclasses.replace(cfg, dtype=torch.float64), b64)
    eps = max(_rel(a, b) for a, b in zip(leaves(gc), leaves(g64)))
    gdev = max(_rel(a, b) for a, b in zip(leaves(gg), leaves(gc)))
    tag = f"{arch} {'f32' if f32 else str(cfg.dtype).replace('torch.', '')}" + \
        (f" les={les}" if les else "")
    if not gdev <= 3 * eps:
        die(f"11b {tag}: card gradient {gdev:.3e} from the CPU's, past 3 ε = {3 * eps:.3e}")
    lrs, ldev, mdev = [], 0.0, {"mu": 0.0, "nu": 0.0}
    for i in range(LM_STEPS):
        cpu, mc = trainer.train_step(cpu, cfg, bc)
        gpu, mg = trainer.train_step(gpu, cfg, bg)
        lc, lg = float(mc["loss"]), float(mg["loss"])
        ldev = max(ldev, abs(lg - lc) / max(abs(lc), 1.0))
        if not abs(lg - lc) <= eps * max(abs(lc), 1.0):
            die(f"11b {tag}: loss {lg} on the card vs {lc} on the CPU, past ε = {eps:.3e}")
        gn_c, gn_g = float(mc["grad_norm"]), float(mg["grad_norm"])
        if not abs(gn_g - gn_c) <= 3 * eps * gn_c:
            die(f"11b {tag}: grad norm {gn_g} vs {gn_c}, past 3 ε")
        for name, levels in (("mu", LM_MU_LEVELS), ("nu", LM_NU_LEVELS)):
            d = max(_rel(a, b) for a, b in zip(leaves(getattr(gpu[1], name)),
                                               leaves(getattr(cpu[1], name))))
            mdev[name] = max(mdev[name], d)
            if not d <= levels * eps:
                die(f"11b {tag}: AdamW {name} after step {i + 1} {d:.3e} from the CPU's, "
                    f"past {levels:g} ε = {levels * eps:.3e}")
        lrs.append(float(mc["lr"]))
    bound = LM_ADAM_PART * sum(lrs)
    pdev = max(float((a.cpu().double() - b.double()).abs().max())
               for a, b in zip(leaves(gpu[0]), leaves(cpu[0])))
    if not pdev <= bound:
        die(f"11b {tag}: params {pdev:.3e} from the CPU's after {LM_STEPS} steps, past "
            f"{bound:.3e}")
    return (f"{tag}: ε {eps:.2e}, card grads {gdev:.2e} (≤ 3 ε), losses {ldev:.2e} (≤ ε), "
            f"mu {mdev['mu']:.2e} (≤ 3 ε), nu {mdev['nu']:.2e} (≤ 6 ε), params {pdev:.2e} "
            f"(≤ {bound:.2e})")


def lm_parity() -> float:
    """Phase 11b: every arch's smoke config, LM_STEPS steps on the card
    against the port's CPU path, at its own dtype and in float32 with LES
    groups; bf16 GEMMs with full-precision reductions, as the CPU's."""
    import torch

    from repro_torch.configs import list_archs

    saved = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t0 = time.perf_counter()
    try:
        for arch in list_archs():
            for f32, les in ((False, 0), (True, 0 if arch == "whisper-large-v3" else 2)):
                print(f"[lm-parity] {lm_case(arch, f32, les)}")
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = saved
    return time.perf_counter() - t0


def lm_full_width(card: str) -> dict:
    """Phase 11c: llama3.2-1b's published config through the port's LM
    trainer (``train_lm(arch, cfg=get_config(arch))``) on the card,
    LM_FULL's batch × seq and steps: finite losses, step 1's within
    LM_LOSS_TOL of the same loss in float64 on the card (same init and
    batch); ms per step host to host, a step's device busy share, peak
    memory.  Then the int8 MLP path (``int8_matmul=True``): its run's
    int_matmul calls recorded and counted (the counter set to 0 just
    before and read just after), which must be some.  Returns the int8
    run's launches and one step's calls."""
    import dataclasses
    import math

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.data.loader import synthetic_lm_generator
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.models import transformer as T
    from repro_torch.parallel.tree import tree_map
    from repro_torch.train import trainer
    from tools_torch.fp_rounding import float64_math

    arch, cfg = "llama3.2-1b", get_config("llama3.2-1b")
    n_params = cfg.param_count()
    run = dict(batch=LM_FULL["batch"], seq=LM_FULL["seq"])
    # the float64 loss of train_lm's init and first batch (seed 0)
    params = tree_map(torch.Tensor.double, T.init_params(prng.PRNGKey(0), cfg, device="cuda"))
    first = synthetic_lm_generator(cfg.vocab_size, LM_FULL["seq"], LM_FULL["batch"])(0)
    with torch.no_grad(), float64_math():
        loss64, _ = lm.train_loss(params, dataclasses.replace(cfg, dtype=torch.float64),
                                  {k: torch.from_numpy(v).cuda() for k, v in first.items()})
    loss64 = float(loss64)
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = train.train_lm(arch, cfg=cfg, steps=LM_FULL["steps"], **run)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = res["losses"]
    if not all(math.isfinite(v) for v in losses):
        die(f"11c: non-finite loss {losses}")
    ln_v = math.log(cfg.vocab_size)
    if abs(losses[0] - loss64) > LM_LOSS_TOL * loss64:
        die(f"11c: step 1's loss {losses[0]:.4f} is not within {LM_LOSS_TOL:.0%} of the "
            f"float64 loss {loss64:.4f}")
    state = res["state"]
    step_fn = trainer.build_train_step(cfg)
    batch = lm_batch(cfg, "cuda", LM_FULL["batch"], LM_FULL["seq"], seed=5)
    box = [state]

    def one():
        box[0], m = step_fn(box[0], batch)
        float(m["loss"])

    wall, kernels = device_profile(one, 1)
    busy = sum(v for v, _ in kernels.values()) / wall
    ms = sorted(1e3 * t for t in res["step_s"][1:])
    print(f"[lm-step] {card} | llama3.2-1b full_config ({n_params / 1e9:.3f} B params, "
          f"{cfg.num_layers} layers, d_model {cfg.d_model}, vocab {cfg.vocab_size}), batch "
          f"{LM_FULL['batch']} x seq {LM_FULL['seq']}, AdamW, remat: losses "
          f"{[round(v, 4) for v in losses]} (step 1 in float64 {loss64:.4f}; ln V = "
          f"{ln_v:.4f}, +{losses[0] - ln_v:.3f}: tied embeddings give a token's own logit "
          f"about √d_model at init) | host to host "
          f"{res['step_s'][0] * 1e3:.1f} ms step 1, then {ms} ms | one step profiled: "
          f"{wall:.1f} ms, device busy {100 * busy:.1f}% | peak memory {peak:.2f} GiB")
    del res, state, box
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    steps8 = LM_FULL["int8_steps"]
    res8, calls, routes = record_int_matmul(lambda: train.train_lm(
        arch, cfg=dataclasses.replace(cfg, int8_matmul=True), steps=steps8, **run))
    n8 = len(calls)
    if n8 == 0 or n8 % steps8 or not all(math.isfinite(v) for v in res8["losses"]):
        die(f"11c int8: {n8} int_matmul launches over {steps8} steps, losses {res8['losses']}")
    if routes != {STEP_ROUTES["llama3.2-1b int8"]: n8}:
        die(f"11c int8: the {n8} int_matmul calls took routes {routes}")
    print(f"[lm-step] {card} | llama3.2-1b full_config int8_matmul=True, "
          f"{steps8} steps: losses {[round(v, 4) for v in res8['losses']]}, "
          f"{n8} int_matmul launches ({n8 // steps8} a step: 3 MLP products a "
          f"layer forward, and those the remat backward recomputes; routes {routes}: "
          f"the int8 weight lies K-major), host to host "
          f"{[round(1e3 * t, 1) for t in res8['step_s']]} ms ({time.perf_counter() - t0:.1f} s)")
    del res8
    step_calls = calls[-(n8 // steps8):]
    del calls
    torch.cuda.empty_cache()
    return {"launches": n8, "per_step": n8 // steps8, "calls": step_calls,
            "routes_per_step": {r: v // steps8 for r, v in routes.items()}}


def lm_phase(card: str, errs: dict, train_int: int) -> dict:
    """Phase 11: the integer card step (11a) and the LM training path (11b,
    11c); returns int_matmul's row of the kernels line.  Its ``launches``
    are phase 5's (the VGG8B split run, ``train_int``), which must be
    TRAIN_STEPS times 11a's VGG8B step plus CLI_EVAL_BATCHES times its
    eval batch; its times are one such step's calls; the LM int8 path's
    own count and times, and each path's launches per step, ride beside
    them."""
    t0 = time.perf_counter()
    res = int_matmul_phase(errs)
    want = TRAIN_STEPS * res["vgg8b"] + CLI_EVAL_BATCHES * res["vgg8b_eval"]
    if train_int != want:
        die(f"phase 5's split run launched int_matmul {train_int} times, not {TRAIN_STEPS} x "
            f"11a's VGG8B step ({res['vgg8b']}) + {CLI_EVAL_BATCHES} x its eval batch "
            f"({res['vgg8b_eval']})")
    row = int_matmul_timing(res["vgg_calls"], card)
    t_b = lm_parity()
    lm8 = lm_full_width(card)
    row["lm_int8"] = {"launches": lm8["launches"], **lm_int8_timing(lm8["calls"], card)}
    row["launches"] = train_int
    row["launches_per_step"] = {"vgg8b": res["vgg8b"], "vgg8b eval batch": res["vgg8b_eval"],
                                "mlp4": res["mlp4"],
                                "llama3.2-1b int8_matmul": lm8["per_step"]}
    row["routes_per_step"] = {**res["routes"], "llama3.2-1b int8_matmul": lm8["routes_per_step"]}
    print(f"[phase-11] int_matmul launches per step: VGG8B {res['vgg8b']} (phase 5's run, "
          f"{TRAIN_STEPS} steps and {CLI_EVAL_BATCHES} eval batches of {res['vgg8b_eval']}: "
          f"{train_int}), mlp4 {res['mlp4']}, llama3.2-1b int8_matmul "
          f"{lm8['per_step']} ({lm8['launches']} over {LM_FULL['int8_steps']} steps); by "
          f"route a step {row['routes_per_step']}; 11b {t_b:.1f} s; phase 11 "
          f"{time.perf_counter() - t0:.1f} s")
    return row


# ---------------------------------------------------------------------------
# Phase 12: LM serving on the card (prefill, decode_step, the Engine)
# ---------------------------------------------------------------------------

#: 12a: each smoke config prefills a batch × prompt, then decodes ``steps``
#: tokens, into caches of ``max_seq`` positions (h2o-danube's and mixtral's
#: windows of 16 wrap their rings at t = 16)
SERVE_PARITY = {"batch": 2, "prompt": 12, "steps": 6, "max_seq": 32}
#: card and CPU each lie within about ε of the float64 result, so the two
#: within 2 ε; a bf16 cache leaf that the two round to neighbouring bf16
#: numbers lies one unit apart, 2 ε where the float64 run places ε at half
#: a unit (tests/_torch_lm_serve.py's SERVE_LEVELS, the port against JAX)
SERVE_LEVELS = 2.0
#: the two archs JAX's Engine cannot serve (its prefill reads stub inputs
#: that the Engine does not pass): served through prefill / decode_step
EMBED_ARCHS = ("qwen2-vl-72b", "whisper-large-v3")
#: 12b / 12c: llama3.2-1b's published config served at full width: requests
#: × prompt (drawn as the serve launcher draws them, seed 0), new tokens,
#: cache length, the int8 run's new tokens, the decode steps held against
#: float64 after the prefill
LM_SERVE = {"requests": 8, "prompt": 512, "max_new": 64, "max_seq": 1024,
            "int8_max_new": 16, "checked_steps": 4}
#: the bf16 logits against the same prefill and decode steps in float64 on
#: the card, relative to the largest |logit|: bf16 rounding moves the
#: logits of a 2-layer smoke config by 0.4–1.8% of their largest value
#: (SERVE_PARITY's ε, the CPU's float64 runs) and of a 16-layer llama at
#: smoke width by 1.2–1.9%; 16 layers at full width, within 5%
LM_SERVE_TOL = 5e-2


class serve_recorder:
    """Inside: every ``lm.prefill`` and ``lm.decode_step`` call (the
    Engine's too) records its logits (the first ``keep``) and the latest
    cache; with ``tokens``, decode step i is fed ``tokens[i]`` in place of
    the caller's (teacher forcing), and every step's tokens are kept."""

    def __init__(self, tokens=None, keep: int | None = None):
        self.tokens, self.keep = tokens, keep
        self.logits, self.fed, self.cache = [], [], None

    def _keep(self, logits, cache):
        if self.keep is None or len(self.logits) < self.keep:
            self.logits.append(logits)
        self.cache = cache
        return logits, cache

    def __enter__(self):
        from repro_torch.models import lm

        self.real = lm.prefill, lm.decode_step
        real_prefill, real_decode = self.real

        def prefill(*a, **kw):
            return self._keep(*real_prefill(*a, **kw))

        def decode(params, cfg, tokens, cache, enc_out=None):
            if self.tokens is not None:
                tokens = self.tokens[len(self.fed)].to(tokens.device)
            self.fed.append(tokens)
            return self._keep(*real_decode(params, cfg, tokens, cache, enc_out))

        lm.prefill, lm.decode_step = prefill, decode
        return self

    def __exit__(self, *exc):
        from repro_torch.models import lm

        lm.prefill, lm.decode_step = self.real
        return False


def serve_run(arch: str, cfg, params, batch: dict, device: str, tokens=None,
              f64: bool = False) -> serve_recorder:
    """One 12a run: SERVE_PARITY's prefill and decode steps through the
    Engine (the token archs) or ``prefill`` / ``decode_step`` (EMBED_ARCHS),
    recorded; ``tokens`` teacher-forces the decode steps; ``f64`` runs it
    under ``float64_math`` with params, inputs and cfg.dtype in float64."""
    import contextlib
    import dataclasses

    import torch

    from repro_torch.models import lm
    from repro_torch.models import transformer as T
    from repro_torch.parallel.tree import tree_map
    from repro_torch.serving import Engine, Request
    from tools_torch.fp_rounding import float64_math

    n, steps = SERVE_PARITY["batch"], SERVE_PARITY["steps"]
    tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    if f64:
        cfg = dataclasses.replace(cfg, dtype=torch.float64)
        params = tree_map(torch.Tensor.double, params)
        tb = {k: v.double() if v.is_floating_point() else v for k, v in tb.items()}
    ctx = float64_math() if f64 else contextlib.nullcontext()
    with torch.no_grad(), ctx, serve_recorder(tokens) as rec:
        if arch in EMBED_ARCHS:
            cache = T.init_cache(cfg, n, SERVE_PARITY["max_seq"], device=device)
            logits, cache = lm.prefill(params, cfg, tb, cache)
            enc_out = lm.run_encoder(params, cfg, tb["enc_embeds"]) if cfg.encoder_layers \
                else None
            for _ in range(steps):
                tok = torch.argmax(logits, -1).to(torch.int32)
                logits, cache = lm.decode_step(params, cfg, tok, cache, enc_out)
        else:
            Engine(cfg, params, max_seq=SERVE_PARITY["max_seq"], device=device).generate(
                [Request(prompt=row.tolist(), max_new_tokens=steps + 1)
                 for row in batch["tokens"]])
    if len(rec.logits) != steps + 1 or len(rec.fed) != steps:
        die(f"12a {arch}: {len(rec.logits)} logits, {len(rec.fed)} decode steps recorded")
    return rec


def serve_case(arch: str) -> str:
    """One 12a case: the smoke config on the card against the port's CPU
    path, teacher-forced with the CPU run's tokens.  ε is the CPU path's
    distance from its own float64 run (the largest over each step's logits
    and the final cache's float leaves); the card's logits at every step and
    its final cache lie within SERVE_LEVELS · ε, leaf by leaf, with the
    CPU's shapes and dtypes and the same ``t``."""
    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.core import prng
    from repro_torch.models import transformer as T
    from repro_torch.parallel.tree import leaves, tree_map

    cfg = get_smoke_config(arch)
    params = T.init_params(prng.PRNGKey(0), cfg, device="cpu")
    rng = np.random.default_rng(0)
    n, s = SERVE_PARITY["batch"], SERVE_PARITY["prompt"]
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (n, s)).astype(np.int32)}
    if cfg.embeds_input:
        batch["embeds"] = rng.standard_normal((n, s, cfg.d_model)).astype(np.float32)
    if cfg.encoder_layers:
        batch["enc_embeds"] = rng.standard_normal((n, cfg.encoder_seq,
                                                   cfg.d_model)).astype(np.float32)
    cpu = serve_run(arch, cfg, params, batch, "cpu")
    fed = [t.cpu() for t in cpu.fed]
    cpu64 = serve_run(arch, cfg, params, batch, "cpu", tokens=fed, f64=True)
    gpu = serve_run(arch, cfg, tree_map(lambda t: t.cuda(), params), batch, "cuda",
                    tokens=fed)

    def floats(cache):
        return [c for c in leaves(cache) if c.is_floating_point()]

    eps = max(_rel(a, b) for a, b in zip(cpu.logits + floats(cpu.cache),
                                          cpu64.logits + floats(cpu64.cache)))
    ldev = max(_rel(a, b) for a, b in zip(gpu.logits, cpu.logits))
    got, want = leaves(gpu.cache), leaves(cpu.cache)
    if [(c.dtype, c.shape) for c in got] != [(c.dtype, c.shape) for c in want]:
        die(f"12a {arch}: the card's cache leaves differ in dtype or shape from the CPU's")
    if not int(gpu.cache["t"]) == int(cpu.cache["t"]) == s + SERVE_PARITY["steps"]:
        die(f"12a {arch}: t {int(gpu.cache['t'])} on the card, {int(cpu.cache['t'])} on the CPU")
    cdev = max(_rel(a, b) for a, b in zip(floats(gpu.cache), floats(cpu.cache)))
    tag = f"{arch} {str(cfg.dtype).replace('torch.', '')}"
    if not max(ldev, cdev) <= SERVE_LEVELS * eps:
        die(f"12a {tag}: card logits {ldev:.3e}, cache {cdev:.3e} from the CPU's, past "
            f"{SERVE_LEVELS:g} ε = {SERVE_LEVELS * eps:.3e}")
    how = "prefill / decode_step" if arch in EMBED_ARCHS else "Engine"
    return (f"{tag} ({how}, {n} x {s} prompt, {SERVE_PARITY['steps']} decode steps): ε "
            f"{eps:.2e}, card logits {ldev:.2e}, cache {cdev:.2e} (≤ {SERVE_LEVELS:g} ε)")


def serve_parity() -> float:
    """Phase 12a: every arch's smoke config served on the card against the
    port's CPU path; bf16 GEMMs with full-precision reductions, as the
    CPU's."""
    import torch

    from repro_torch.configs import list_archs

    saved = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t0 = time.perf_counter()
    try:
        for arch in list_archs():
            print(f"[lm-serve-parity] {serve_case(arch)}")
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = saved
    return time.perf_counter() - t0


def serve_prompts(cfg) -> list:
    """LM_SERVE's prompts, drawn as ``launch/serve.py`` draws them (seed 0)."""
    import numpy as np

    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, LM_SERVE["prompt"]).tolist()
            for _ in range(LM_SERVE["requests"])]


def serve_times(engine) -> str:
    """The last ``generate``'s figures: the prefill host to host (to its
    tokens on the host), the decode ms a token (p50, p90) and tokens/s."""
    import numpy as np

    pre, dec = 1e3 * engine.step_s[0], 1e3 * np.asarray(engine.step_s[1:])
    n = LM_SERVE["requests"]
    total = n * len(engine.step_s) / sum(engine.step_s)
    return (f"prefill {pre:.2f} ms host to host, decode {np.percentile(dec, 50):.3f} ms a "
            f"token p50, {np.percentile(dec, 90):.3f} p90 ({len(dec)} steps of {n} tokens: "
            f"{n * len(dec) / dec.sum() * 1e3:.1f} tokens/s), {total:.1f} generated tokens/s "
            f"with the prefill")


def profile_decode(params, cfg, cache, tokens) -> dict:
    """One ``lm.decode_step`` on ``cache`` (as the Engine runs it: then its
    tokens to the host) under the profiler: host-to-host ms, device ms,
    device launches, busy share, and the device time by kernel family (its
    name up to the template arguments), the largest six."""
    import torch

    from repro_torch.models import lm

    box = [cache]

    def one():
        logits, box[0] = lm.decode_step(params, cfg, tokens, box[0])
        torch.argmax(logits, -1).tolist()

    wall, kernels = device_profile(one, 1)
    fams = Counter()
    for name, (ms, _) in kernels.items():
        fams[name.split("<")[0].split("(")[0].removeprefix("void ")[-48:]] += ms
    dev_ms = sum(v for v, _ in kernels.values())
    return {"wall": wall, "ms": dev_ms, "launches": sum(c for _, c in kernels.values()),
            "busy": dev_ms / wall,
            "top": "; ".join(f"{k} {v:.3f}" for k, v in fams.most_common(6))}


def weight_casts(params, cfg) -> list:
    """The float32 weights a decode step casts to bf16: the embedding table
    twice (the lookup and the tied unembedding) and each layer's wq, wk, wv,
    wo and MLP weights."""
    from repro_torch.models import lm

    ws = [params["embed"], params["embed"]]
    for i in range(cfg.scan_repeats):
        p = lm._unit(params["scan"], i)["u0"]
        ws += [p["wq"], p["wk"], p["wv"], p["wo"], *(p["mlp"][k] for k in sorted(p["mlp"]))]
    return ws


def lm_serve_full(card: str) -> dict:
    """Phase 12b, ``[lm-serve]``: llama3.2-1b's published config served by
    the Engine on the card (LM_SERVE: 8 requests of 512 tokens, 64 new
    tokens each, a cache of 1,024): the prefill and the first
    ``checked_steps`` decode steps' logits within LM_SERVE_TOL of the same
    prefill and steps (teacher-forced with the run's tokens) in float64 on
    the card, and the greedy tokens equal float64's wherever its top-2
    margin exceeds 2 · LM_SERVE_TOL · max |logit|; the serving figures, one
    profiled decode step (device time, launches, busy share), the step's
    float32 → bf16 weight casts replayed alone, peak memory.  Returns the
    params and the prompts for 12c."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.models import lm
    from repro_torch.models import transformer as T
    from repro_torch.parallel.tree import tree_map
    from repro_torch.serving import Engine, Request
    from tools_torch.fp_rounding import float64_math

    cfg = get_config("llama3.2-1b")
    params = T.init_params(prng.PRNGKey(0), cfg, device="cuda")
    prompts = serve_prompts(cfg)
    n, steps = LM_SERVE["requests"], LM_SERVE["checked_steps"]
    engine = Engine(cfg, params, max_seq=LM_SERVE["max_seq"], device="cuda")
    engine.generate([Request(prompt=p, max_new_tokens=2) for p in prompts])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with serve_recorder(keep=steps + 1) as rec:
        out = engine.generate([Request(prompt=p, max_new_tokens=LM_SERVE["max_new"])
                               for p in prompts])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if [len(r.generated) for r in out] != [LM_SERVE["max_new"]] * n:
        die(f"12b: generated {[len(r.generated) for r in out]} tokens")
    if not all(bool(torch.isfinite(lg).all()) for lg in rec.logits):
        die("12b: non-finite logits")
    times = serve_times(engine)

    prof = profile_decode(params, cfg, rec.cache, rec.fed[-1])
    ws = weight_casts(params, cfg)
    # device-bound launches back to back: CUDA events time the device
    cast_ms = time_cuda(lambda: [w.to(torch.bfloat16) for w in ws], iters=5, warmup=1)
    cast_gb = sum(w.numel() * 6 for w in ws) / 1e9
    p50 = 1e3 * sorted(engine.step_s[1:])[len(engine.step_s[1:]) // 2]
    del rec.cache, engine
    torch.cuda.empty_cache()

    cfg64 = dataclasses.replace(cfg, dtype=torch.float64)
    toks = torch.tensor(prompts, dtype=torch.int32, device="cuda")
    with torch.no_grad(), float64_math():
        p64 = tree_map(torch.Tensor.double, params)
        logits, c64 = lm.prefill(p64, cfg64, {"tokens": toks},
                                 T.init_cache(cfg64, n, LM_SERVE["max_seq"], device="cuda"))
        outs64 = [logits]
        for tok in rec.fed[:steps]:
            logits, c64 = lm.decode_step(p64, cfg64, tok, c64)
            outs64.append(logits)
    del p64, c64
    torch.cuda.empty_cache()
    devs, ties = [], 0
    for i, (lb, l64) in enumerate(zip(rec.logits, outs64)):
        d = _rel(lb, l64)
        devs.append(d)
        if not d <= LM_SERVE_TOL:
            die(f"12b: step {i}'s logits {d:.3e} from float64's, past {LM_SERVE_TOL:g}")
        top = torch.topk(l64.double(), 2, dim=-1).values
        sure = (top[:, 0] - top[:, 1]) > 2 * LM_SERVE_TOL * l64.abs().max()
        got = torch.tensor([r.generated[i] for r in out], device="cuda")
        want = torch.argmax(l64, -1)
        if bool((sure & (got != want)).any()):
            die(f"12b: step {i}'s greedy tokens {got.tolist()} differ from float64's "
                f"{want.tolist()} past the margin")
        ties += int((~sure).sum())
    ffn = sum(r.generated[0] == p[-1] for r, p in zip(out, prompts))
    print(f"[lm-serve] {card} | llama3.2-1b full_config ({cfg.param_count() / 1e9:.3f} B params,"
          f" fp32 master weights, bf16 compute), Engine(max_seq={LM_SERVE['max_seq']}), "
          f"{n} requests x {LM_SERVE['prompt']} prompt tokens, {LM_SERVE['max_new']} new "
          f"tokens each: {times} | one decode step profiled: {prof['wall']:.2f} ms host to "
          f"host, device {prof['ms']:.3f} ms over {prof['launches']} device launches, busy "
          f"{100 * prof['busy']:.1f}% ({100 * prof['ms'] / p50:.1f}% of the unprofiled p50); "
          f"by kernel family (ms) {prof['top']} | its float32 -> bf16 weight casts replayed "
          f"alone {cast_ms:.3f} ms (CUDA events, back to back; {cast_gb:.2f} GB moved, "
          f"{cast_gb / cast_ms:.2f} TB/s) | peak memory {peak:.2f} GiB")
    print(f"[lm-serve] {card} | float64 check: the prefill and {steps} decode steps' logits "
          f"{', '.join(f'{d:.2e}' for d in devs)} from float64 (≤ {LM_SERVE_TOL:g}), greedy "
          f"tokens equal float64's wherever its top-2 margin exceeds {2 * LM_SERVE_TOL:g} "
          f"max |logit| ({ties} of {n * (steps + 1)} within it); {ffn} of {n} first tokens "
          f"repeat the prompt's last (tied embeddings at init)")
    return {"params": params, "prompts": prompts}


def lm_serve_int8(card: str, params, prompts, errs: dict) -> dict:
    """Phase 12c: the same served model with ``int8_matmul=True``: every
    int_matmul call of the prefill and of one decode step recorded (the
    counters set to 0 just before, read just after) and held bitwise
    against ``int_matmul_ref``: 3 a layer, 48 each, on the route ``plan``
    gives (W at M = 8 too); the Engine's run of ``int8_max_new`` tokens
    counted (48 a step); ``[int-matmul-decode]`` one decode step's calls
    replayed: device time and launches against their bound, the float64
    limb GEMMs, ``torch._int_mm`` on the same operands where it takes them,
    and ``quantize_weight_int8``'s device time over the step's weights."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.numerics import int_matmul_ref
    from repro_torch.kernels.int_matmul import int_matmul as int_matmul_mod
    from repro_torch.models import lm
    from repro_torch.models import transformer as T
    from repro_torch.models.common import quantize_weight_int8
    from repro_torch.serving import Engine, Request

    cfg = dataclasses.replace(get_config("llama3.2-1b"), int8_matmul=True)
    n, per_step = LM_SERVE["requests"], 3 * cfg.num_layers
    int_matmul_cuda = int_matmul_mod.int_matmul_cuda
    toks = torch.tensor(prompts, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        cache = T.init_cache(cfg, n, LM_SERVE["max_seq"], device="cuda")
        (logits, cache), pre_calls, pre_routes = record_int_matmul(
            lambda: lm.prefill(params, cfg, {"tokens": toks}, cache))
        tok = torch.argmax(logits, -1).to(torch.int32)
        _, dec_calls, dec_routes = record_int_matmul(
            lambda: lm.decode_step(params, cfg, tok, cache))
    prof = profile_decode(params, cfg, cache, tok)
    del cache
    for what, calls, routes in (("prefill", pre_calls, pre_routes),
                                ("decode step", dec_calls, dec_routes)):
        if len(calls) != per_step or routes != {"W": per_step}:
            die(f"12c: the int8 {what} launched int_matmul {len(calls)} times on routes "
                f"{routes}, not {per_step} on W")
        for i, (a, b) in enumerate(calls):
            compare(f"int_matmul llama3.2-1b int8 {what} call {i} {tuple(a.shape)} x "
                    f"{tuple(b.shape)}", int_matmul_cuda(a, b), int_matmul_ref(a, b), errs)
    del pre_calls
    torch.cuda.empty_cache()

    engine = Engine(cfg, params, max_seq=LM_SERVE["max_seq"], device="cuda")
    engine.generate([Request(prompt=p, max_new_tokens=2) for p in prompts])  # warm-up
    counters = [int_matmul_cuda.launches, *int_matmul_cuda.routes.values()]
    for c in counters:
        c.reset()
    out = engine.generate([Request(prompt=p, max_new_tokens=LM_SERVE["int8_max_new"])
                           for p in prompts])
    total = int_matmul_cuda.launches.value
    routes = {r: c.value for r, c in int_matmul_cuda.routes.items() if c.value}
    if total != per_step * LM_SERVE["int8_max_new"] or routes != {"W": total} or \
            [len(r.generated) for r in out] != [LM_SERVE["int8_max_new"]] * n:
        die(f"12c: the Engine's int8 run launched int_matmul {total} times ({routes})")
    times = serve_times(engine)
    del engine
    torch.cuda.empty_cache()

    def replay(fn, pairs):
        return lambda: [fn(a, b) for a, b in pairs]

    _, kern = device_profile(replay(int_matmul_cuda, dec_calls), 3)
    ms = sum(v for v, _ in kern.values()) / 3
    dev_launches = sum(c for _, c in kern.values()) / 3
    _, limb = device_profile(replay(int_matmul_ref, dec_calls), 1)
    plain = sum(v for v, _ in limb.values())
    cols = [(a, b.t().contiguous().t()) for a, b in dec_calls]
    try:
        _, lib_k = device_profile(replay(torch._int_mm, cols), 3)
        lib, lib_txt = sum(v for v, _ in lib_k.values()) / 3, None
    except RuntimeError as e:  # the library's refusal of M = 8, reported
        lib, lib_txt = None, str(e).splitlines()[0]
    ws = [b for _, b in dec_calls]
    mlp = [w for i in range(cfg.scan_repeats)
           for w in (lm._unit(params["scan"], i)["u0"]["mlp"][k] for k in ("wi", "wg", "wo"))]
    quant = time_cuda(lambda: [quantize_weight_int8(w) for w in mlp], iters=3, warmup=1)
    ops = sum(2 * a.shape[0] * a.shape[1] * b.shape[1] for a, b in dec_calls)
    nbytes = sum(a.numel() + b.numel() + 4 * a.shape[0] * b.shape[1] for a, b in dec_calls)
    ops_ms, bytes_ms = ops / PEAK_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    bound = max(ops_ms, bytes_ms)
    shapes = sorted({f"{tuple(a.shape)}x{tuple(b.shape)}" for a, b in dec_calls})
    lib_line = f"{lib:.4f} ms" if lib is not None else f"refuses M = {n} ({lib_txt})"
    print(f"[lm-serve] {card} | llama3.2-1b full_config int8_matmul=True, Engine, {n} x "
          f"{LM_SERVE['prompt']} prompts, {LM_SERVE['int8_max_new']} new tokens: {times} | one "
          f"decode step profiled: {prof['wall']:.2f} ms host to host, device {prof['ms']:.3f} ms "
          f"over {prof['launches']} device launches, busy {100 * prof['busy']:.1f}%; by kernel "
          f"family (ms) {prof['top']} | int_matmul: the prefill's {per_step} calls and one "
          f"decode step's {per_step} bitwise int_matmul_ref, all on route W; the run {total} "
          f"launches ({per_step} a step)")
    print(f"[int-matmul-decode] {card} | one llama3.2-1b int8 decode step's {len(dec_calls)} "
          f"int_matmul calls ({', '.join(shapes)}; route W, {n} of its 128-row tile's rows "
          f"hold data): device {ms:.4f} ms over {dev_launches:g} device launches | bound "
          f"{bound:.5f} ms ({'operations' if ops_ms >= bytes_ms else 'bytes'}; operations "
          f"{ops_ms:.5f}, bytes {bytes_ms:.5f}: b's {sum(w.numel() for w in ws) / 1e6:.1f} MB "
          f"read), {100 * bound / ms:.2f}% of it | plain {plain:.4f} ms (float64 limb GEMMs) "
          f"| library torch._int_mm {lib_line} | quantize_weight_int8 over the step's "
          f"{len(mlp)} weights {quant:.4f} ms (CUDA events, back to back)")
    return {"per_step": per_step, "routes": {"W": per_step},
            "decode": {"launches": total, "ms": ms, "plain_ms": plain, "bound_ms": bound,
                       "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                       "library_ms": lib,
                       "timed_on": f"one llama3.2-1b int8_matmul decode step's {len(dec_calls)} "
                                   f"calls ({n} requests), device time"}}


def serve_phase(card: str, errs: dict, int_row: dict) -> None:
    """Phase 12: LM serving (12a parity, 12b llama3.2-1b at full width, 12c
    its int8 path); adds the int8 serving counts to int_matmul's row."""
    import torch

    t0 = time.perf_counter()
    t_a = serve_parity()
    full = lm_serve_full(card)
    res = lm_serve_int8(card, full["params"], full["prompts"], errs)
    del full
    torch.cuda.empty_cache()
    prefill = f"llama3.2-1b int8 prefill ({LM_SERVE['requests']} x {LM_SERVE['prompt']})"
    decode = f"llama3.2-1b int8 decode step ({LM_SERVE['requests']})"
    int_row["launches_per_step"].update({prefill: res["per_step"], decode: res["per_step"]})
    int_row["routes_per_step"].update({prefill: res["routes"], decode: res["routes"]})
    int_row["lm_int8_decode"] = res["decode"]
    print(f"[phase-12] 12a {t_a:.1f} s; phase 12 {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 13: the dry run checked on the card
# ---------------------------------------------------------------------------

#: the dry run's per-chip peak at the one-chip mesh against the card's
#: ``max_memory_allocated`` over the same step: within 20%
DRY_PEAK_TOL = 0.2
#: 13c: mlp4's served batch, split into microbatches for two stages
PIPE_BATCH, PIPE_MICRO = 32, 4
#: 13d: the production cells traced on the host
DRY_CELLS = [("llama3.2-1b", "train_4k"), ("qwen3-32b", "decode_32k")]


def same_costs(what: str, got, want) -> None:
    """The card's op counts, FLOPs by dtype and bytes ≡ the meta trace's;
    else the ops that differ, and die."""
    if got.summary() == want.summary():
        return
    extra, missing = got.by_op - want.by_op, want.by_op - got.by_op
    die(f"{what}: the card counted {got.summary()}, the meta trace {want.summary()}; "
        f"ops only on the card {dict(extra)}, only on meta {dict(missing)}")


def dry_train(card: str) -> None:
    """Phase 13a, ``[dry-train]``: the LM train step, bf16 and int8."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.launch import dryrun
    from repro_torch.launch import op_analysis as oa
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train import trainer

    cfg = get_config("llama3.2-1b")
    b, s = LM_FULL["batch"], LM_FULL["seq"]
    mesh = make_test_mesh()
    rules = dryrun.make_rules(cfg, mode="train", multi_pod=False, batch=b)
    trace = dryrun.trace_step(cfg, "train", b, s, mesh, rules)
    trace8 = dryrun.trace_step(dataclasses.replace(cfg, int8_matmul=True), "train", b, s,
                               mesh, rules)
    predicted = trace.peak_bytes()

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    state = trainer.init_state(prng.PRNGKey(0), cfg, device="cuda")
    batch = lm_batch(cfg, "cuda", b, s, seed=5)
    step = trainer.build_train_step(cfg)
    box = [state]
    del state

    def one():
        box[0], m = step(box[0], batch)
        float(m["loss"])

    one()  # warm-up: lazy initialisation
    torch.cuda.synchronize()
    inputs = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    one()
    measured = torch.cuda.max_memory_allocated() - before + inputs
    ms = host_ms(one, 3)
    with oa.OpAnalyzer() as an:
        box[0], _ = step(box[0], batch)
    torch.cuda.synchronize()
    same_costs("13a llama3.2-1b train step", an.costs, trace.costs)
    off = abs(predicted - measured) / measured
    if not off <= DRY_PEAK_TOL:
        die(f"13a: the dry run's peak {predicted / 2 ** 30:.3f} GiB is {100 * off:.1f}% from "
            f"the card's {measured / 2 ** 30:.3f} GiB (> {100 * DRY_PEAK_TOL:.0f}%)")
    terms = oa.roofline_terms(trace.costs, 1)
    bound_ms = 1e3 * max(terms["compute_s"], terms["memory_s"])
    model = 6 * cfg.active_param_count() * b * s
    fl = {k: f"{v:.4e}" for k, v in sorted(trace.costs.flops.items())}
    print(f"[dry-train] {card} | llama3.2-1b full_config, batch {b} x seq {s}, AdamW, remat, "
          f"mesh (1, 1): meta trace {trace.trace_s:.2f} s; the card's step under the analyzer "
          f"≡ the meta trace: {trace.costs.ops} ops, FLOPs {fl}, {trace.costs.hbm_bytes:.6e} "
          f"bytes (exact) | peak: dry run {predicted / 2 ** 30:.3f} GiB (inputs "
          f"{trace.input_bytes() / 2 ** 30:.3f} + trace {trace.analyzer.peak() / 2 ** 30:.3f}; "
          f"the card's analyzer timeline {an.peak('cuda') / 2 ** 30:.3f}), card "
          f"max_memory_allocated {measured / 2 ** 30:.3f} GiB, {100 * off:.2f}% apart "
          f"(≤ {100 * DRY_PEAK_TOL:.0f}%) | bounds: compute {1e3 * terms['compute_s']:.2f} ms, "
          f"memory {1e3 * terms['memory_s']:.2f} ms, roofline {bound_ms:.2f} ms "
          f"({terms['dominant']}) against {ms:.2f} ms a step host to host "
          f"({100 * bound_ms / ms:.1f}%) | model FLOPs 6·N·T {model:.4e} "
          f"({model / trace.costs.total_flops:.3f} of the counted): "
          f"{100 * model / (ms / 1e3) / oa.PEAK_BF16:.2f}% of the dense bf16 peak "
          f"({oa.PEAK_BF16 / 1e12:.0f} TFLOP/s)")

    cfg8 = dataclasses.replace(cfg, int8_matmul=True)
    step8 = trainer.build_train_step(cfg8)

    def run8():
        with oa.OpAnalyzer() as an8:
            box[0], m = step8(box[0], batch)
        float(m["loss"])
        return an8

    an8, calls, routes = record_int_matmul(run8)
    same_costs("13a llama3.2-1b int8 train step", an8.costs, trace8.costs)
    shapes = [(tuple(a.shape), tuple(w.shape)) for a, w in calls]
    for what, prods in (("card", an8.costs.products), ("meta", trace8.costs.products)):
        if [(p[1], p[2]) for p in prods] != shapes or {p[3] for p in prods} != {"int8"}:
            die(f"13a int8: the {what} analyzer's products {prods[:3]}... ({len(prods)}) are "
                f"not the {len(calls)} int_matmul calls recorded {shapes[:3]}...")
    terms8 = oa.roofline_terms(trace8.costs, 1)
    print(f"[dry-train] {card} | llama3.2-1b int8_matmul=True, same cell: the card ≡ the meta "
          f"trace ({trace8.costs.ops} ops, {trace8.costs.hbm_bytes:.6e} bytes, FLOPs "
          f"{ {k: f'{v:.4e}' for k, v in sorted(trace8.costs.flops.items())} }); the analyzer's "
          f"{len(trace8.costs.products)} int8 products ≡ the {len(calls)} int_matmul calls "
          f"recorded on the card (shapes {sorted(set(shapes))}, routes {routes}) | bounds: "
          f"compute {1e3 * terms8['compute_s']:.2f} ms, memory {1e3 * terms8['memory_s']:.2f} ms")
    del box, batch, calls
    gc.collect()
    torch.cuda.empty_cache()


def dry_decode(card: str) -> None:
    """Phase 13b, ``[dry-decode]``: phase 12b's decode step."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.device import dry_run
    from repro_torch.launch import dryrun
    from repro_torch.launch import op_analysis as oa
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import lm
    from repro_torch.models import transformer as T
    from repro_torch.train import trainer

    cfg = get_config("llama3.2-1b")
    n, max_seq = LM_SERVE["requests"], LM_SERVE["max_seq"]
    mesh = make_test_mesh()
    rules = dryrun.make_rules(cfg, mode="serve", multi_pod=False, batch=n)
    with dry_run():  # the Engine's float32 master weights
        meta_params = T.init_params(prng.PRNGKey(0), cfg, device="meta")
    trace = dryrun.trace_step(cfg, "decode", n, max_seq, mesh, rules, params=meta_params)

    params = T.init_params(prng.PRNGKey(0), cfg, device="cuda")
    toks = torch.tensor(serve_prompts(cfg), dtype=torch.int32, device="cuda")
    with torch.no_grad():
        logits, cache = lm.prefill(params, cfg, {"tokens": toks},
                                   T.init_cache(cfg, n, max_seq, device="cuda"))
    tok = torch.argmax(logits, -1).to(torch.int32)
    step = trainer.build_decode_step(cfg, mesh, rules)
    torch.cuda.synchronize()
    with oa.OpAnalyzer() as an:
        step(params, tok, cache)
    torch.cuda.synchronize()
    same_costs("13b llama3.2-1b decode step", an.costs, trace.costs)
    box = [cache]

    def one():
        _, box[0] = step(params, tok, box[0])

    wall, kernels = device_profile(one, 1)
    dev_ms = sum(v for v, _ in kernels.values())
    terms = oa.roofline_terms(trace.costs, 1)
    print(f"[dry-decode] {card} | llama3.2-1b full_config decode step, {n} requests, cache "
          f"{max_seq} (fp32 master weights), mesh (1, 1): meta trace {trace.trace_s:.2f} s; the "
          f"card ≡ the meta trace: {trace.costs.ops} ops, FLOPs "
          f"{ {k: f'{v:.4e}' for k, v in sorted(trace.costs.flops.items())} }, "
          f"{trace.costs.hbm_bytes:.6e} bytes (exact) | bounds: memory "
          f"{1e3 * terms['memory_s']:.3f} ms, compute {1e3 * terms['compute_s']:.3f} ms; the "
          f"step's device time {dev_ms:.3f} ms ({wall:.2f} ms host to host): the bytes bound is "
          f"{100 * 1e3 * terms['memory_s'] / dev_ms:.1f}% of it | dry-run peak "
          f"{trace.peak_bytes() / 2 ** 30:.3f} GiB")
    dup, pre = duplicate_qkv(cfg, mesh, rules, meta_params)
    print(f"[dry-prefill] {card} | llama3.2-1b full_config prefill, {n} x {LM_SERVE['prompt']} "
          f"tokens, traced on meta: {pre.ops} ops, "
          f"{ {k: f'{v:.4e}' for k, v in sorted(pre.flops.items())} } FLOPs, "
          f"{pre.hbm_bytes:.4e} bytes; of it the K/V cache fill's second Q/K/V projection "
          f"(models/lm.py _fill_kv_cache; XLA's CSE merges JAX's): {dup.ops} ops, "
          f"{ {k: f'{v:.4e}' for k, v in sorted(dup.flops.items())} } FLOPs "
          f"({100 * dup.total_flops / pre.total_flops:.2f}%), {dup.hbm_bytes:.4e} bytes "
          f"({100 * dup.hbm_bytes / pre.hbm_bytes:.2f}%)")
    del box, cache, params
    gc.collect()
    torch.cuda.empty_cache()


def duplicate_qkv(cfg, mesh, rules, params):
    """(the second Q/K/V projection's costs, the prefill's): phase 12b's
    prefill traced on meta, each ``_fill_kv_cache``'s projection counted
    apart by an analyzer of its own (nested analyzers both count)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import op_analysis as oa
    from repro_torch.models import lm
    from repro_torch.models import transformer as T

    proj, fill, inner = T._project_qkv, lm._fill_kv_cache, oa.OpAnalyzer()

    def probe(*a, **k):
        with inner:
            return proj(*a, **k)

    def probed_fill(*a, **k):
        T._project_qkv = probe
        try:
            return fill(*a, **k)
        finally:
            T._project_qkv = proj

    lm._fill_kv_cache = probed_fill
    try:
        pre = dryrun.trace_step(cfg, "prefill", LM_SERVE["requests"], LM_SERVE["prompt"], mesh,
                                rules, params=params)
    finally:
        lm._fill_kv_cache = fill
    return inner.costs, pre.costs


def dry_pipeline(card: str) -> None:
    """Phase 13c, ``[pipeline]``: mlp4's two 3000 → 3000 served layers as
    two pipeline stages over microbatches, ≡ the served plan."""
    import numpy as np
    import torch

    from repro_torch.configs import get_paper_config
    from repro_torch.core import model as M
    from repro_torch.core import prng
    from repro_torch.infer import compile_plan, freeze
    from repro_torch.kernels.nitro_matmul import ops as nitro_ops
    from repro_torch.parallel.pipeline import bubble_fraction, pipeline_apply

    cfg = get_paper_config("mlp4", scale=1.0)
    plan = compile_plan(freeze(M.init_params(prng.PRNGKey(0), cfg, device="cuda"), cfg),
                        device="cuda")
    x = np.random.default_rng(0).integers(-127, 128, (PIPE_BATCH, *cfg.input_shape))

    def layer(i, a):
        m = plan.metas[i]
        return nitro_ops.fused_matmul(
            a, plan.weights[i], sf=m.sf, alpha_inv=m.alpha_inv, apply_relu=m.apply_relu,
            out_dtype=torch.int8 if m.out_dtype == "int8" else torch.int32,
            backend=plan.backend, operand_dtype=m.operand_dtype,
            key_w_dtype=plan.frozen_weights[i].dtype)

    with torch.inference_mode():
        acts = [torch.as_tensor(x).to(device="cuda", dtype=torch.int32).reshape(PIPE_BATCH, -1)]
        for i in range(len(plan.metas)):
            acts.append(layer(i, acts[-1]))
        if not torch.equal(acts[-1], plan.logits(x)):
            die("13c: the layers called one by one differ from the plan's logits")
        mid = [i for i, w in enumerate(plan.weights) if tuple(w.shape) == (3000, 3000)]
        if len(mid) != 2:
            die(f"13c: mlp4's 3000 -> 3000 layers are {mid}")
        out, launches = counted(lambda: pipeline_apply(
            lambda st, m: layer(mid[st], m), acts[mid[0]], num_stages=2, num_micro=PIPE_MICRO))
    if not torch.equal(out, acts[mid[1] + 1]):
        die("13c: the pipeline's output differs from the served plan's activations")
    if {k: v for k, v in launches.items() if v} != {"nitro_matmul": 2 * PIPE_MICRO}:
        die(f"13c: the pipeline launched {launches}, not {2 * PIPE_MICRO} nitro_matmul")
    print(f"[pipeline] {card} | mlp4 (full width) served layers {mid} (3000 -> 3000) as 2 "
          f"stages, {PIPE_MICRO} microbatches of {PIPE_BATCH // PIPE_MICRO}: "
          f"{2 * PIPE_MICRO} nitro_matmul launches, bitwise the plan's activations "
          f"({tuple(out.shape)} {out.dtype}); GPipe bubble at 2 stages "
          f"{bubble_fraction(2, PIPE_MICRO):.3f}")


def dry_cells(card: str) -> None:
    """Phase 13d, ``[dry-cell]``: production cells traced on the host."""
    from repro_torch.launch import dryrun

    for arch, shape in DRY_CELLS:
        trace, info = dryrun.trace_cell(arch, shape, multi_pod=False)
        r = dryrun.analyze_cell(trace, info)
        roof = r["roofline"]
        summary = {k: r[k] for k in ("arch", "shape", "kind", "batch", "seq", "chips",
                                     "trace_s", "ops")}
        summary["memory"] = {k: v for k, v in r["memory"].items() if k != "note"}
        summary["roofline"] = {k: roof[k] for k in (
            "compute_s", "memory_s", "collective_s", "dominant", "flops_by_dtype",
            "hbm_bytes", "collective_counts", "collective_link_bytes", "collectives",
            "model_flops", "model_over_counted_flops", "roofline_fraction")}
        print(f"[dry-cell] {card} | {json.dumps(summary)}")


def dry_phase(card: str) -> None:
    """Phase 13: the dry run checked on the card (13a-13d)."""
    t0 = time.perf_counter()
    dry_train(card)
    t_a = time.perf_counter() - t0
    dry_decode(card)
    dry_pipeline(card)
    t_c = time.perf_counter() - t0
    dry_cells(card)
    print(f"[phase-13] 13a {t_a:.1f} s; 13a-13c {t_c:.1f} s; phase 13 "
          f"{time.perf_counter() - t0:.1f} s")


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        die("src/repro_torch not found beside chip_smoke.py: run it from the "
            "root of a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        die(f"CUDA is not available (torch {torch.__version__}); this smoke "
            f"test runs only on a CUDA card")
    card = toolchain(torch)
    build()

    from repro_torch.configs import get_paper_config
    from repro_torch.core import model as M
    from repro_torch.core import prng
    from repro_torch.infer import compile_plan, freeze

    import numpy as np

    cfg = get_paper_config("vgg8b", scale=1.0)
    params = M.init_params(prng.PRNGKey(0), cfg, device="cpu")
    fm = freeze(params, cfg)
    plan = compile_plan(fm, device="cuda")
    x = np.random.default_rng(0).integers(-127, 128, (BATCH, *cfg.input_shape)).astype(np.int32)
    steps = step_inputs(plan, x)

    errs: dict[str, int] = {}
    parity(steps, errs)
    shapes = train_shapes(cfg, TRAIN_BATCH)
    train_parity(shapes, errs)
    opt_parity(shapes, cfg, params, errs)
    grad_x_parity(shapes, errs)
    matmul_digit_parity(errs)
    grad_w_digit_parity(errs)
    no_sync_phase(steps, shapes, cfg, params, errs)
    res, launches = main_path(fm)
    import tempfile

    with tempfile.TemporaryDirectory() as root:
        fleet_res, fm_b = fleet_path(fm, root)
    fleet_no_sync(fleet_res["registry"], fleet_res["images"])
    hot_swap_path(fleet_res, fm_b)
    train_res, train_ref, train_launches = train_path()
    launches.update({k: train_launches[k] for k in TRAIN_KERNELS})
    train_int = train_launches["int_matmul"]
    fuse_res, fuse_launches = fuse_opt_path(train_res)
    launches.update({k: fuse_launches[k] for k in
                     ("stream_conv_grad_w_opt", "nitro_matmul_grad_w_opt")})
    launches["integer_sgd_update"] = fused_apply_path(train_res)["integer_sgd_update"]
    gx_launches = grad_x_path()
    launches.update({k: gx_launches[k] for k in ("stream_conv_grad_x", "nitro_matmul_grad_x")})
    mlp_res, mlp_ref = mlp_path()
    mlp_fuse_opt_path(mlp_ref)
    resume_path()
    with tempfile.TemporaryDirectory() as root:
        obs_jsonl = obs_train_path(train_res, fuse_res, root)
    obs_registry, obs_imgs, obs_metrics, obs_tracer = obs_fleet_path(fm, fm_b)
    n_spans = len(obs_tracer.snapshot())
    fleet_no_sync(obs_registry, obs_imgs, ", with metrics= and tracer= on the engine",
                  metrics=obs_metrics, tracer=obs_tracer)
    if len(obs_tracer.snapshot()) <= n_spans:
        die("[obs-6d] the sync check recorded no span")
    dp_path(train_res, fuse_res, obs_jsonl, card)
    with tempfile.TemporaryDirectory() as root:
        autotune_untunable(plan, res["images"], root)
        autotune_train_path(train_res, root)
        autotune_serve_path(res, root)
    per_kernel = timing(steps, card)
    train_timing(shapes, card, per_kernel)
    opt_timing(shapes, cfg, params, card, per_kernel)
    linear_grad_w_timing(card, per_kernel)
    grad_x_timing(shapes, card, per_kernel)
    end_to_end(res, card)
    fleet_end_to_end(fleet_res, fm, card)
    train_end_to_end(train_res, train_ref, fuse_res, cfg, card)
    mlp_end_to_end(mlp_res, mlp_ref, card)
    fleet_spans(fm, card)
    obs_serve(fm, card)
    obs_train(train_res, cfg, card)
    fp_phase(card)
    int_row = lm_phase(card, errs, train_int)
    serve_phase(card, errs, int_row)
    dry_phase(card)

    print(f"[parity] {sum(PARITY_CASES.values())} cases bitwise equal: "
          f"{dict(PARITY_CASES)}")
    rows = []
    for name, meta in KERNELS.items():
        k = per_kernel[name]
        rows.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[name],
            "max_abs_err": errs[name], "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"],
            "bound_by": "operations" if k["ops_ms"] >= k["bytes_ms"] else "bytes",
            "library_ms": None,
        })
    rows.append({"name": "int_matmul", "route": "cuda", "source": INT_MATMUL["source"],
                 "replaces": INT_MATMUL["replaces"], "max_abs_err": errs["int_matmul"],
                 **int_row})
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
