"""The readings that a cell's limits are set from, on the card, at the cell's
own size: for each seed the program's numbers and each control's (the
reference one precision step below what the configuration states, put in
the program's place, and for serving the drivers' other controls), and for
a training cell the numbers of a step that leaves out half of its batch (the
mean taken over the rest).  The
benchmark's own runs never run this.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--seconds 10]

Prints one JSON line per seed and writes them all to
``benchmark/out/control_<cell>.jsonl``.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def half_batch(step_fn, state, batch):
    """A faulty step: half of the microbatches left out, the mean taken over
    the rest."""
    keep = batch["input_ids"].shape[0] // 2
    return step_fn(state, None, {k: v[:keep] for k, v in batch.items()})


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)

    import torch

    from benchmark import spec

    if not torch.cuda.is_available():
        sys.exit("no CUDA card")
    cell = spec.cell(spec.load_benchmark(), args.workload)
    kind = cell["traffic"]["kind"]
    drv = spec.driver(kind)
    os.makedirs(os.path.join(spec.HERE, "out"), exist_ok=True)
    path = os.path.join(spec.HERE, "out", f"control_{args.workload}.jsonl")
    with open(path, "w") as f:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            seconds = 0.0 if kind == "train" else args.seconds
            res = drv.run(cell, seed, seconds, False, t0, control=True)
            line = {"seed": seed, "program": {n: v for n, v, _, _ in res.checks},
                    "control": {c: {n: v for n, v, _, _ in checks}
                                for c, checks in res.control_checks.items()}}
            if kind == "train":
                dev = torch.device("cuda")
                step, state, got = drv.program(cell, seed, dev, fault=half_batch)
                del step, state
                torch.cuda.empty_cache()
                line["half_batch"] = drv.compare(got, res.reference)
            line["seconds"] = time.perf_counter() - t0
            print(json.dumps(line), flush=True)
            f.write(json.dumps(line) + "\n")
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
