"""The yardstick's counts, from shapes, against the multiply-adds worked out
by hand from the paper's Table 5."""

from __future__ import annotations

import pytest

from perfbench import context, harness, work


def _layers(name):
    cfg = harness.load_json(harness.BENCH_DIR / "configs" / f"{name}.json")
    return cfg, work.layers(harness.blocks(cfg), cfg["input_shape"], cfg["num_classes"])


def test_vgg8b_forward_macs():
    # conv 3→128, 128→256 at 32×32; 256→256, 256→512 at 16×16; 512→512 at
    # 8×8 and 4×4; linear 2048→1024; output 1024→10
    hand = (1024 * 27 * 128 + 1024 * 1152 * 256 + 256 * 2304 * 256 + 256 * 2304 * 512
            + 64 * 4608 * 512 + 16 * 4608 * 512 + 2048 * 1024 + 1024 * 10)
    assert hand == 949_364_736
    assert work.forward_macs(_layers("vgg8b")[1]) == hand


def test_vgg11b_forward_macs():
    hand = (1024 * 27 * 128 + 2 * 1024 * 1152 * 128 + 1024 * 1152 * 256 + 256 * 2304 * 256
            + 256 * 2304 * 512 + 64 * 4608 * 512 * 2 + 16 * 4608 * 512 + 2048 * 1024 + 1024 * 10)
    assert hand == 1_402_349_568
    assert work.forward_macs(_layers("vgg11b")[1]) == hand


def test_training_ops_count_every_product_once():
    cfg, layers = _layers("vgg8b")
    lr = 3200 + 4096 + 4096 + 2048 + 2048 + 2048 + 1024  # learning-layer widths
    assert [l.lr_features for l in layers[:-1]] == [3200, 4096, 4096, 2048, 2048, 2048, 1024]
    assert work.train_ops(layers, 10) == 2 * 2 * 949_364_736 + 2 * 3 * lr * 10
    assert work.infer_ops(layers) == 2 * 949_364_736


@pytest.mark.parametrize("name,convs", [("vgg8b", 6), ("vgg11b", 9)])
def test_entry_launch_counts(name, convs):
    cfg, layers = _layers(name)
    train = work.train_entry_work(layers, 512)
    assert len(train["stream_conv_fwd"]) == len(train["stream_conv_grad_w_opt"]) == convs
    assert len(train["nitro_matmul_fwd"]) == 1
    infer = work.infer_entry_work(layers, 256, [2] * len(layers))
    assert len(infer["stream_conv"]) == convs and len(infer["nitro_matmul"]) == 2
    ops = sum(o for o, _ in train["stream_conv_fwd"]) + sum(o for o, _ in train["nitro_matmul_fwd"])
    assert ops == 2 * 512 * (work.forward_macs(layers) - layers[-1].h * layers[-1].c * layers[-1].f)


def test_conv_bytes_at_the_functions_dtypes():
    cfg, layers = _layers("vgg8b")
    (ops, nbytes) = work.train_entry_work(layers, 2)["stream_conv_fwd"][0]
    x, w, y = 2 * 32 * 32 * 3, 27 * 128, 2 * 32 * 32 * 128
    assert ops == 2 * 2 * 1024 * 27 * 128
    assert nbytes == 4 * (x + w + 2 * y)
    serve = context.cell_work(cfg, harness.resolve("vgg8b.infer.b256").traffic | {"batch": 2})
    (_, nb_serve) = serve["entries"]["stream_conv"][1]
    x8, w2, y_pooled = 2 * 32 * 32 * 128, 9 * 128 * 256, 2 * 16 * 16 * 256
    assert nb_serve == x8 + 2 * w2 + y_pooled  # the served weights are stored int16
    assert harness.stored_bytes(harness.served_bound(3 * 3 * 128)) == 2
    assert harness.stored_bytes(harness.kaiming_bound(3 * 3 * 128)) == 1


def test_bound_is_the_larger_of_the_two():
    assert work.bound_s(work.PEAK_OPS, 0) == 1.0
    assert work.bound_s(0, work.PEAK_BYTES * 2) == 2.0


def test_dp_work_is_a_ranks_share():
    cell = harness.resolve("vgg8b.train-dp4.b2048")
    per_rank = context.cell_work(cell.config, cell.traffic)["entries"]["stream_conv_fwd"]
    one = context.cell_work(cell.config, dict(cell.traffic, batch=512, ranks=1))
    assert per_rank == one["entries"]["stream_conv_fwd"]
