"""The control, the reference one precision step below what the
configuration states put in the program's place, reads far above the
program at a size a test run holds (the chip runs of ``benchmark/control.py``
read it at the cells' own sizes).  On the CPU TF32 does not exist, so the
Mimi control is read on the card only.  The exact tier's int8 control and
``logit_gap_mean`` separate only at CSM-1B's widths: the tiny model's bf16
program reads as far from the reference as its int8 weights do."""

import time

import pytest

from benchmark import spec
from benchmark.drivers import serve, train
from benchmark.tests.tiny import tiny_cell


@pytest.mark.parametrize("workload", ["int4-serve-audio", "bf16-exact-stream",
                                      "int4-serve-prefix"])
def test_serving_control_reads_above_the_program(workload):
    cell = tiny_cell(workload)
    tier = cell["config"]["tier"]
    res = serve.run(cell, 31, 2.0, False, time.perf_counter(), device="cpu", control=True)
    prog = dict((n, v) for n, v, _, _ in res.checks)
    ctrl = {c: dict((n, v) for n, v, _, _ in checks)
            for c, checks in res.control_checks.items()}
    assert set(ctrl) == set(spec.family(cell["config"]).reference.controls(tier))
    assert prog["checked_requests"] >= 1 and prog["checked_sampled"] >= 1
    lim = cell["config"]["limits"]
    assert ctrl["fp8" if tier == "exact" else "lower"]["logit_gap"] > 3 * prog["logit_gap"]
    assert prog["logit_gap"] < lim["logit_gap"] and prog["topk_gap"] < lim["topk_gap"]
    # Sampling without the top-k filter draws far outside the reference's top k.
    assert ctrl["no_topk"]["topk_gap"] > 3 * max(prog["topk_gap"], 1e-3)
    if cell["traffic"].get("prefixes"):
        # Served from the right prefix: nearer the reference behind it than behind another.
        assert prog["prefix_gap_share"] < cell["traffic"]["limits"]["prefix_gap_share"]


def test_training_control_reads_above_the_program():
    cell = tiny_cell("bf16-train-s2048")
    res = train.run(cell, 32, 0.0, False, time.perf_counter(), device="cpu", control=True)
    prog = dict((n, v) for n, v, _, _ in res.checks)
    ctrl = dict((n, v) for n, v, _, _ in res.control_checks["fp8"])
    assert max(ctrl[n] / prog[n] for n in prog) > 3
    assert all(v < cell["config"]["limits"][n] for n, v in prog.items())
