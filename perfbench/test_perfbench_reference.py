"""The frozen plain reference against the port's plain path on the CPU, at a
small width: the LES step (split and ``fuse_opt``) and the served plan,
bit for bit; and the control (float32 products) coming out not correct."""

from __future__ import annotations

import pytest
import torch

from perfbench import compare, context, control, harness
from perfbench.reference import nitro as ref
from perfbench.reference import threefry

SCALE = 0.0625
BATCH = 6


def _cfg(name):
    return harness.load_json(harness.BENCH_DIR / "configs" / f"{name}.json")


def _inputs(config, seed, weights="init"):
    gen = torch.Generator().manual_seed(seed)
    params = harness.seeded_params(config, gen, "cpu", SCALE, weights)
    x, y = harness.seeded_images(3 * BATCH, config["input_shape"], config["num_classes"],
                                 gen, "cpu")
    return params, x, y


def test_threefry_matches_the_ports_draws():
    from repro_torch.core import prng

    key = torch.tensor([0x12345678, 0x9ABCDEF0], dtype=torch.int64)
    assert torch.equal(threefry.split(key, 7), prng.split(key, 7))
    assert torch.equal(threefry.bits(key, (5, 9), "cpu"), prng.bits(key, (5, 9)))


@pytest.mark.parametrize("fuse_opt", [True, False])
@pytest.mark.parametrize("name", ["vgg8b", "vgg11b"])
def test_training_step_equals_the_ports_plain_step(name, fuse_opt):
    from repro_torch.core import les
    from repro_torch.core import optimizer as opt

    config = _cfg(name)
    params, x, y = _inputs(config, 11)
    cfg = harness.program_config(config, BATCH, SCALE)
    net = harness.reference_net(config, BATCH, SCALE)
    af = opt.amplification_factor(cfg.num_classes)
    state = les.TrainState(params=harness.tree_to(params, "cpu"),
                           opt_lr=opt.init_state(cfg.gamma_inv, cfg.eta_lr),
                           opt_fw=opt.init_state(cfg.gamma_inv * af, cfg.eta_fw),
                           step=torch.zeros((), dtype=torch.int32))
    ref_params = params
    for t in range(3):
        rows = slice(t * BATCH, (t + 1) * BATCH)
        key = harness.step_key(2 ** 33 + 5, t)
        state, m = les.train_step(state, cfg, x[rows], y[rows], key, backend="reference",
                                  fuse_opt=fuse_opt)
        out = ref.train_step(net, ref_params, x[rows], y[rows], key)
        ref_params = out.params
        assert compare.unequal([m.loss, m.correct, m.local_losses],
                               [out.loss, out.correct, out.local_losses]) == 0
        assert compare.unequal(state.params, ref_params) == 0


def test_served_logits_equal_the_ports_plan():
    from repro_torch.infer.export import freeze
    from repro_torch.infer.plan import compile_plan

    config = _cfg("vgg8b")
    params, x, _ = _inputs(config, 12, "served")
    cfg = harness.program_config(config, BATCH, SCALE)
    plan = compile_plan(freeze(params, cfg), device="cpu", backend="reference")
    net = harness.reference_net(config, BATCH, SCALE)
    fw = [b["fw"]["w"] for b in params["blocks"]]
    got = plan.logits(x.to(torch.int32))
    want = ref.logits(net, fw, params["output"]["w"], x)
    assert torch.equal(got, want)
    assert len(set(want.argmax(-1).tolist())) > 1  # the served weights carry the input


#: Weights of 21 bits: the products' sums pass 2^24 at the CPU's width, as
#: the full cells' sums do at theirs (where the chip runs read the control).
WIDE = 1 << 20


def _ctx(name, seed, monkeypatch, **traffic):
    monkeypatch.setitem(harness.BOUNDS, "wide", lambda fan_in: WIDE)
    return context.Context.for_cell(harness.resolve(name), seed=seed, seconds=0.0, trace=False,
                                    device=torch.device("cpu"), t_start=0.0, scale=SCALE,
                                    traffic=dict(traffic, weights="wide"))


def test_control_comes_out_not_correct(monkeypatch):
    """The reference in float32 in the program's place fails the serving
    cell's numbers, as do the planted faults."""
    ctx = _ctx("vgg8b.infer.b256", 21, monkeypatch, batch=8, dataset_images=16, sample_every=1)
    out = control.serving(ctx)
    assert not harness.correct(out["control"])
    assert not harness.correct(out["half_batch"])
    assert not harness.correct(out["answer_altered"])


def test_training_control_comes_out_not_correct(monkeypatch):
    """The training numbers separate the float32 control and the half batch."""
    ctx = _ctx("vgg8b.train.b512", 22, monkeypatch, batch=8, dataset_images=24)
    out = control.training(ctx, (("half_batch", 0.5),))
    assert not harness.correct(out["control"])
    assert not harness.correct(out["half_batch"])
