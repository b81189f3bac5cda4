"""The run's pieces on the CPU at each cell's CPU twin (its family's
``tiny``): every cell of ``BENCHMARK.json``, traced and not, its loop, its
records, its metrics and its check, through ``run.py``'s main path.  The
tiny model runs the kernels' plain versions, so its readings sit far below
the full-size limits; no number here is a device metric."""

import numpy as np
import pytest

from benchmark import spec
from benchmark.tests.harness import run_tiny


@pytest.mark.parametrize("workload,trace", [(w["name"], trace)
                                            for w in spec.load_benchmark()["workloads"]
                                            for trace in (0, 1)])
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
    if spec.cell(bench, workload)["traffic"].get("prefixes"):
        assert out["checks"]["prefix_admits"]["value"] == 1.0


def test_the_same_sessions_sent_whole():
    """``"prefix_cache": false``: each turn is submitted as prefix plus
    continuation, no prefix is registered, and the run is judged on the same
    whole contexts; its FLOPs count every prefill whole."""
    import time

    from benchmark.drivers import serve
    from benchmark.tests.tiny import tiny_cell

    cached = tiny_cell("int4-serve-prefix")
    whole = tiny_cell("int4-serve-prefix")
    whole["traffic"]["prefix_cache"] = False
    s = serve.setup(whole, 5, 2.0, False, "cpu")
    assert s.pids == [] and {r.prefix for r in s.reqs} == {None}
    c = serve.setup(cached, 5, 2.0, False, "cpu")
    for r, q in zip(s.reqs, c.reqs):
        assert np.array_equal(r.ids, np.concatenate([c.prefixes[q.prefix][0], q.ids]))
    res = serve.run(whole, 5, 2.0, False, time.perf_counter(), device="cpu")
    checks = {n: (v, lim, op) for n, v, lim, op in res.checks}
    assert "prefix_admits" not in checks and "prefix_gap_share" not in checks
    assert all(v <= lim if op == "<=" else v >= lim for v, lim, op in checks.values())
