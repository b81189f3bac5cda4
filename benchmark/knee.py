"""The knee of a serving cell's mix offered open loop: the highest arrival
rate the server sustains without a growing backlog, found once by a sweep on
the card.  One set-up, then a window at each rate (the cell's traffic sent
open loop at that rate, at even or Poisson gaps); between windows every
request left is cancelled.

    python3 benchmark/knee.py --workload int4-serve-audio --rates 1.0,1.5,2.0 --seconds 40 \
        [--arrivals even|poisson]

For each rate it prints the requests due and finished, the backlog (requests
waiting for a slot) at half time and at the end, and the tails.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=40.0)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--arrivals", choices=("even", "poisson"), default="even")
    args = p.parse_args(argv)

    import torch

    from benchmark import spec
    from benchmark import trace as tr
    from benchmark import traffic as gen
    from benchmark.drivers import serve

    cell = spec.cell(spec.load_benchmark(), args.workload)
    s = serve.setup(cell, args.seed, args.seconds, False, torch.device("cuda"))
    for rate in (float(r) for r in args.rates.split(",")):
        t = dict(s.t, loop="open", arrivals=args.arrivals, rate_per_s=rate)
        reqs = gen.requests(t, s.cfg, args.seed, args.seconds)
        win = serve.Window(s.server, reqs, t, tr.Clock(), s.pids, s.prefix_len)
        half = {}

        def at(elapsed, win=win, half=half):
            if "queued" not in half and elapsed >= args.seconds / 2:
                half["queued"] = s.server.stats()["queued"]

        win.on_call = at
        win.run(args.seconds)
        rec = serve.record(win, s.fam, s.cfg, t, tr.Clock(), 0.0)
        line = {"rate_per_s": rate, "due": sum(r["due"] <= rec.window_s for r in rec.requests),
                "finished": sum(r["finished"] for r in rec.requests),
                "queued_half": half.get("queued"), "queued_end": s.server.stats()["queued"],
                "frames_per_s": rec.frames / rec.window_s}
        for name in ("ttfa_p90_ms", "frame_gap_p95_ms"):
            line[name] = spec.reader(name)(rec)
        print(json.dumps(line), flush=True)
        for r in win.records:
            if r.finished is None:
                s.server.cancel(r.rid)
        s.server.run_until_idle()


if __name__ == "__main__":
    main()
