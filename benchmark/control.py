"""The readings that a cell's limits are set from, on the card, at the cell's
own size: for each seed the program's numbers and each control's (the
reference one precision step below what the configuration states, put in
the program's place, and for serving the drivers' other controls), and for
a training cell the numbers of a step that leaves out half of its batch (the
mean taken over the rest).  ``--fault`` runs the program with a serving
fault planted underneath instead (``FAULTS``), ``--set`` changes traffic
keys (``--set prefix_cache=false``: the same conversations sent whole), and
``--trace 1`` also reads the cell's per-layer metrics.  The benchmark's own
runs never run this.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--seconds 10] \\
        [--fault swapped_prefix|zeroed_prefix] [--set key=json ...] [--trace 0|1]

Prints one JSON line per seed and writes them all to
``benchmark/out/control_<cell>[_<fault>].jsonl``.
"""

import argparse
import json
import os
import sys
import time
from contextlib import contextmanager, nullcontext

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def half_batch(step_fn, state, batch):
    """A faulty step: half of the microbatches left out, the mean taken over
    the rest."""
    keep = batch["input_ids"].shape[0] // 2
    return step_fn(state, None, {k: v[:keep] for k, v in batch.items()})


@contextmanager
def swapped_prefix():
    """A server that admits each continuation on the next registered
    prefix, not its own (a prefix cache that hands out the wrong speaker)."""
    from csm_tpu_torch.serving import CSMServer

    real = CSMServer.submit

    def submit(self, *a, prefix_id=None, **k):
        if prefix_id is not None:
            ids = list(self._prefixes)
            prefix_id = ids[(ids.index(prefix_id) + 1) % len(ids)]
        return real(self, *a, prefix_id=prefix_id, **k)

    CSMServer.submit = submit
    try:
        yield
    finally:
        CSMServer.submit = real


@contextmanager
def zeroed_prefix():
    """A server whose registered prefixes' cached keys and values are zero
    (a prefix cache lost or never written)."""
    from csm_tpu_torch.serving import CSMServer

    real = CSMServer.register_prefix

    def register(self, *a, **k):
        pid = real(self, *a, **k)
        cache, _ = self._prefixes[pid]
        cache.k.zero_()
        cache.v.zero_()
        return pid

    CSMServer.register_prefix = register
    try:
        yield
    finally:
        CSMServer.register_prefix = real


FAULTS = {"swapped_prefix": swapped_prefix, "zeroed_prefix": zeroed_prefix}


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--fault", choices=sorted(FAULTS))
    p.add_argument("--set", action="append", default=[], metavar="KEY=JSON")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark import spec

    if not torch.cuda.is_available():
        sys.exit("no CUDA card")
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    for kv in args.set:
        key, value = kv.split("=", 1)
        cell["traffic"][key] = json.loads(value)
    kind = cell["traffic"]["kind"]
    drv = spec.driver(kind)
    plain = not args.fault and not args.set
    section = "per_layer" if args.trace else "end_to_end"
    os.makedirs(os.path.join(spec.HERE, "out"), exist_ok=True)
    tag = "".join(f"_{x}" for x in [args.fault] + [kv.split("=")[0] for kv in args.set] if x)
    path = os.path.join(spec.HERE, "out", f"control_{args.workload}{tag}.jsonl")
    with open(path, "w") as f:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            seconds = 0.0 if kind == "train" else args.seconds
            with FAULTS[args.fault]() if args.fault else nullcontext():
                res = drv.run(cell, seed, seconds, bool(args.trace), t0, control=plain)
            line = {"seed": seed, "fault": args.fault, "set": args.set,
                    "program": {n: v for n, v, _, _ in res.checks},
                    "control": {c: {n: v for n, v, _, _ in checks}
                                for c, checks in getattr(res, "control_checks", {}).items()}}
            if kind != "train":
                line["metrics"] = {m["name"]: spec.reader(m["name"])(res)
                                   for m in spec.cell_metrics(bench, args.workload, section)}
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
