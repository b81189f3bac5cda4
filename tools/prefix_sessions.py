"""Serve the prefix mix (``benchmark/traffic/serve-prefix.json``: sessions on
registered two-speaker prefixes, a Mimi stream a slot) on any configuration
of the benchmark, through the serve driver and its check, and print the
check's numbers and the run's end-to-end metrics as one JSON line per seed.
A reading, not a cell:

    python3 tools/prefix_sessions.py --config csm-granite-4.0-h-micro \\
        --seeds 1,2 [--seconds 20]
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    args = p.parse_args(argv)

    from benchmark import spec
    from benchmark.drivers import serve

    bench = spec.load_benchmark()
    conf = {c["name"]: c for c in bench["configs"]}[args.config]
    with open(os.path.join(spec.ROOT, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(spec.HERE, "traffic", "serve-prefix.json")) as f:
        traffic = json.load(f)
    cell = {"name": f"{args.config}.serve-prefix", "chips": 1, "config_name": args.config,
            "traffic_name": "serve-prefix", "config": config, "traffic": traffic}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = serve.run(cell, seed, args.seconds, False, t0)
        metrics = {m: spec.reader(m)(res) for m in ("ttfa_p90_ms", "frame_gap_p95_ms", "setup_s")}
        print(json.dumps({"seed": seed, "checks": {n: [v, lim, op] for n, v, lim, op in res.checks},
                          "metrics": metrics, "requests": res.attempted,
                          "memory_peak_bytes": int(res.peak)}), flush=True)


if __name__ == "__main__":
    main()
