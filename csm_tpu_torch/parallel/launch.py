"""Run a function on spawned ranks of a fresh process group: the launcher of
the parallel tests and of ``chip_smoke.py`` (counterpart of the JAX
package's ``scripts/check_multihost_cpu.py``).

    results = launch(fn, 2, arg, timeout=120.0)

Each rank is a process started with the ``spawn`` method (never ``fork``
after CUDA is initialised), joins a group through a ``file://`` rendezvous
in a temporary directory (parallel pytest workers never race for a TCP
port), runs ``fn(*args)`` and sends its result back with tensors turned
into numpy arrays.  A rank's exception, or a run past ``timeout`` seconds,
kills every rank and raises here.  ``fn`` must be importable by the ranks
(a module-level function).
"""

from __future__ import annotations

import os
import queue as queue_mod
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def to_numpy(x: Any) -> Any:
    """Tensors (anywhere in dicts, lists, tuples) as numpy arrays; bf16 as
    fp32."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_numpy(v) for v in x)
    return x


# gloo's own limit on a collective: a hung peer fails the survivors' calls.
COLLECTIVE_TIMEOUT_S = 60.0


def _rank_main(rank: int, world: int, init_file: str, num_threads: int, fn: Callable,
               args: tuple, results) -> None:
    torch.set_num_threads(num_threads)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                world_size=world,
                                timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        # Every rank's pairs are connected before ``fn`` runs, and none is torn
        # down before every rank is done with them: a rank whose ``fn`` runs no
        # collective could otherwise close its pairs while a peer still
        # connects ("Connection closed by peer").
        dist.barrier()
        value = to_numpy(fn(*args))
        dist.barrier()
        results.put((rank, True, value))
    except BaseException:  # noqa: BLE001 (sent to the parent, which raises)
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, world_size: int, *args, timeout: float = 120.0,
           num_threads: int = 1) -> List[Any]:
    """Run ``fn(*args)`` on ``world_size`` spawned ranks of a gloo group
    (they may share one card); returns each rank's result in rank order.
    Raises ``RuntimeError`` if a rank raises, exits without a result or the
    run outlasts ``timeout`` seconds; the ranks are then killed."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="csm_launch_") as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world_size, init_file, num_threads, fn, args, results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        got, errors = {}, []
        try:
            while len(got) + len(errors) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    errors.append(f"timed out after {timeout:.0f} s with ranks "
                                  f"{sorted(set(range(world_size)) - set(got))} unfinished")
                    break
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if not p.is_alive() and r not in got and p.exitcode not in (0, None)]
                    if dead:
                        errors.append(f"ranks {dead} exited without a result (exit codes "
                                      f"{[procs[r].exitcode for r in dead]})")
                        break
                    continue
                if ok:
                    got[rank] = value
                else:
                    errors.append(f"rank {rank} raised:\n{value}")
                    break
        finally:
            for p in procs:
                p.join(timeout=max(0.0, min(10.0, deadline - time.monotonic())) if not errors
                       else 0.0)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    if errors:
        raise RuntimeError("launch failed: " + "\n".join(errors))
    return [got[r] for r in range(world_size)]

