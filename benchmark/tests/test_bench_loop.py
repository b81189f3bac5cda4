"""The run's pieces on the CPU at ``CSMConfig.tiny()``: every cell's loop,
its records, its metrics and its check, through ``run.py``'s main path.
The tiny model runs the kernels' plain versions, so its readings sit far
below the full-size limits; no number here is a device metric."""

import pytest

from benchmark import spec
from benchmark.tests.harness import run_tiny


@pytest.mark.parametrize("workload,trace", [("int4-serve-audio", 0), ("int4-serve-audio", 1),
                                            ("int4-batch32-codes", 0), ("bf16-exact-stream", 1),
                                            ("bf16-train-s2048", 0), ("bf16-train-s2048", 1)])
def test_a_run_prints_its_metrics_and_is_correct(monkeypatch, capsys, workload, trace):
    out = run_tiny(monkeypatch, capsys, workload, trace=trace)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device"] + \
        (["breakdown"] if trace else []) + ["checks"]
    assert out["correct"] is True, {n: c for n, c in out["checks"].items()
                                     if not (c["value"] >= c["limit"] if c["must_be"] == ">="
                                             else c["value"] <= c["limit"])}
    assert out["attempted"] > 0 and out["failed"] == 0
    bench = spec.load_benchmark()
    section = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in spec.cell_metrics(bench, workload, section)}
    got = set(out["metrics"])
    assert got <= want
    if not trace:
        assert got == want
    else:
        # No card: no kernel rooflines, but the host spans and the shares.
        assert {m for m in want if "roofline" not in m} <= got
        assert out["device"]["window_s"] > 0
    for v in out["checks"].values():
        assert v["value"] <= v["limit"] if v["must_be"] == "<=" else v["value"] >= v["limit"]
