"""Run one cell of the port's benchmark on the CUDA card and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number that decided ``correct``
beside its limit, also printed as the last lines of standard error.  Without
a CUDA card, with fewer cards than the cell asks for, or with JAX or the JAX
package loaded, it prints no result and exits non-zero.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# Every build and kernel cache inside the checkout, at fixed paths.
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "benchmark", "out", "torch_ext"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "benchmark", "out", "triton"))
os.environ.setdefault("USE_FLAX", "0")


def fail(msg: str, code: int) -> None:
    print(msg, file=sys.stderr, flush=True)
    sys.exit(code)


def power_limit_w():
    """The card's power limit, stated beside every number."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              "-i", "0"], capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def card(chips: int) -> str:
    """The card's name; exits without a result when there is no CUDA card or
    fewer cards than the cell asks for."""
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA card: the benchmark runs on the card only", 2)
    if torch.cuda.device_count() < chips:
        fail(f"the cell needs {chips} cards; {torch.cuda.device_count()} found", 2)
    return torch.cuda.get_device_name(0)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark import spec

    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)

    name = card(cell["chips"])
    res = spec.driver(cell["traffic"]["kind"]).run(cell, args.seed, args.seconds,
                                                   bool(args.trace), STARTED)

    found = spec.forbidden_loaded(sys.modules)
    if found:
        fail(f"modules of JAX or the JAX package are loaded: {found}", 3)

    section = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in spec.cell_metrics(bench, cell["name"], section):
        value = spec.reader(m["name"])(res)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": name, "count": cell["chips"],
              "memory_peak_bytes": int(res.peak), "power_limit_w": power_limit_w()}
    ok = [v >= lim if op == ">=" else v <= lim for _, v, lim, op in res.checks]
    out = {"correct": bool(ok) and all(ok), "attempted": res.attempted, "failed": res.failed,
           "metrics": metrics, "device": device}
    if args.trace and res.trace is not None:
        device["busy_s"] = res.trace["busy_s"]
        device["window_s"] = res.trace["window_s"]
        out["breakdown"] = res.trace["breakdown"]
    out["checks"] = {name: {"value": v, "limit": lim, "must_be": op}
                     for name, v, lim, op in res.checks}
    for (name, v, lim, op), good in zip(res.checks, ok):
        print(f"check {name} = {v!r} (limit {op} {lim!r}) {'ok' if good else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
