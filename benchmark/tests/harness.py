"""Driving ``benchmark/run.py``'s main path on the CPU at a tiny size: the
look for a card is skipped, the cell's sizes are the tiny ones, the driver
runs on the CPU, and the printed result line is returned."""

import json

from benchmark import run as run_mod
from benchmark import spec
from benchmark.tests.tiny import tiny_cell

TINY = {"int4-serve-audio": ("serve-audio", "int4", {}),
        "int4-batch32-codes": ("batch32-codes", "int4", {}),
        "bf16-exact-stream": ("single-stream", "exact", {}),
        "bf16-train-s2048": ("train-s2048", "exact", {})}


def run_tiny(monkeypatch, capsys, workload: str, seed: int = 2 ** 31 + 11, seconds: float = 5.0,
             trace: int = 0, limits: dict = None, **driver_kw) -> dict:
    traffic, tier, over = TINY[workload]
    cell = dict(tiny_cell(traffic, tier, **over), name=workload)
    if limits:
        cell["config"]["limits"].update(limits)
    monkeypatch.setattr(spec, "cell", lambda bench, name: cell)
    monkeypatch.setattr(run_mod, "card", lambda chips: "cpu (test)")
    monkeypatch.setattr(run_mod, "power_limit_w", lambda: None)
    drv = spec.driver(cell["traffic"]["kind"])
    orig = drv.run
    monkeypatch.setattr(drv, "run", lambda *a, **k: orig(*a, device="cpu", **driver_kw, **k))
    run_mod.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                  "--trace", str(trace)])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])
