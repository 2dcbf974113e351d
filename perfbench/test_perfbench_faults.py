"""A run with the timed path broken underneath comes out not ``correct``:
each driver on the CPU at a small width, the card's look skipped, with each
fault the cell can have planted in the program (``perfbench.faults``); a
sound run beside them comes out ``correct``.  A data-parallel rank that
loads the JAX package makes the run end with no result."""

from __future__ import annotations

import time

import pytest
import torch

from perfbench import context, faults, harness

SMALL = {"batch": 8, "dataset_images": 40, "sample_every": 2}
CASES = [
    ("vgg8b.train.b512", None, True),
    ("vgg8b.train.b512", "state_unchanged", False),
    ("vgg8b.train.b512", "half_batch", False),
    ("vgg11b.train.b512", None, True),
    ("vgg8b.train.b64", "state_unchanged", False),
    ("vgg8b.train.b64", "half_batch", False),
    ("vgg8b.infer.b256", None, True),
    ("vgg8b.infer.b256", "answer_altered", False),
    ("vgg8b.infer.b256", "half_batch", False),
]


def _ctx(cell, **traffic):
    return context.Context.for_cell(cell, seed=2 ** 31 + 7, seconds=0.3, trace=False,
                                    device=torch.device("cpu"), t_start=time.perf_counter(),
                                    scale=0.0625, traffic=dict(SMALL, **traffic))


def _run(cell_name, fault, **traffic):
    """A one-card run with ``fault`` planted in this process, or a
    data-parallel run with it planted in every rank."""
    cell = harness.resolve(cell_name)
    drv = harness.driver(cell.traffic["kind"])
    if cell.traffic["kind"] == "dp_train":
        return drv.run(_ctx(cell, **traffic), fault)
    with faults.planted(fault):
        return drv.run(_ctx(cell, **traffic))


@pytest.mark.parametrize("cell,fault,sound", CASES)
def test_fault_comes_out_not_correct(cell, fault, sound):
    out = _run(cell, fault)
    assert harness.correct(out.checks) is sound, out.checks
    assert out.attempted > 0


@pytest.mark.parametrize("fault,sound", [(None, True), ("no_exchange", False),
                                         ("state_unchanged", False), ("half_batch", False)])
def test_data_parallel_fault_comes_out_not_correct(fault, sound):
    out = _run("vgg8b.train-dp4.b2048", fault, ranks=2)
    assert harness.correct(out.checks) is sound, out.checks
    assert out.loaded == ()


def test_rank_that_loads_the_jax_package_gives_no_result(capsys):
    cell = harness.resolve("vgg8b.train-dp4.b2048")
    out = _run(cell.name, "jax_package_loaded", ranks=2)
    assert out.loaded == ("repro",)
    capsys.readouterr()
    assert harness.finish(cell, out, False) == 3
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "repro" in captured.err
