"""Driving ``benchmark/run.py``'s main path on the CPU at a tiny size: the
look for a card is skipped, the cell's sizes are its family's CPU twin and
small traffic (``tiny.py``), the driver runs on the CPU, and the printed
result line is returned.  Any cell of ``BENCHMARK.json`` runs so, with no
entry here."""

import json

from benchmark import run as run_mod
from benchmark import spec
from benchmark.tests.tiny import tiny_cell


def run_tiny(monkeypatch, capsys, workload: str, seed: int = 2 ** 31 + 11, seconds: float = 5.0,
             trace: int = 0, limits: dict = None, bench: dict = None, root: str = None,
             **driver_kw) -> dict:
    bench = spec.load_benchmark() if bench is None else bench
    cell = tiny_cell(workload, bench, root)
    if limits:
        cell["config"]["limits"].update(limits)
    monkeypatch.setattr(spec, "load_benchmark", lambda *a, **k: bench)
    monkeypatch.setattr(spec, "cell", lambda b, name, *a: cell)
    monkeypatch.setattr(run_mod, "card", lambda chips: "cpu (test)")
    monkeypatch.setattr(run_mod, "power_limit_w", lambda: None)
    drv = spec.driver(cell["traffic"]["kind"])
    orig = drv.run
    monkeypatch.setattr(drv, "run", lambda *a, **k: orig(*a, device="cpu", **driver_kw, **k))
    run_mod.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                  "--trace", str(trace)])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])
