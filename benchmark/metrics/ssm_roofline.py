"""The mixer step kernel's share of its roofline (%): its launches in the
traced sub-window, counted in the device trace under the kernel's exact
name, ``ssm_step_kernel`` (graph replays included), each at its step's batch
``B`` (the program's ``csm.gen.backbone`` spans) through the cell's model
family's ``ssm_work``, summed as bounds over the kernel's device time there.
The cell is the one ``run.py`` (or ``control.py``) was given by
``--workload``.  A model whose family has no ``ssm_work``, or a run whose
trace holds no such kernel (its plain version on a CPU), reads nothing."""

import argparse
import re
import sys

from benchmark import spec, yardstick
from csm_tpu_torch.utils import profiling

KERNEL = "ssm_step_kernel"
_NAME = re.compile(r"^(?:void )?\(anonymous namespace\)::(\w+)[<(]")


def kernel_time(trace: dict):
    """``(launches, device seconds)`` of the kernel in a traced run's device
    trace (``trace["kernels"]``: ``{exact name: (launches, seconds)}``)."""
    n, s = 0, 0.0
    for name, (k, sec) in trace["kernels"].items():
        m = _NAME.match(name)
        if m and m.group(1) == KERNEL:
            n, s = n + k, s + sec
    return n, s


def session(run):
    """The program's spans of the traced sub-window, or None without the
    recorder."""
    return run.trace and getattr(profiling, "last_session", lambda: None)()


def backbone_steps(run) -> list:
    """The traced sub-window's backbone frame steps (``csm.gen.backbone``
    spans, each with its batch ``B``), or []."""
    sess = session(run)
    return sess.named("csm.gen.backbone") if sess else []


def cell_family():
    """``(family module, config)`` of the cell named by ``--workload`` on the
    command line, or None."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--workload")
    name = p.parse_known_args(sys.argv[1:])[0].workload
    if not name:
        return None
    cell = spec.cell(spec.load_benchmark(), name)
    fam = spec.family(cell["config"])
    return fam, fam.config(cell["config"]["model"])


def read(run):
    steps = backbone_steps(run)
    if not steps:
        return None
    n, device_s = kernel_time(run.trace)
    found = cell_family() if n and device_s else None
    if not found or not hasattr(found[0], "ssm_work"):
        return None
    fam, cfg = found
    per_step = sum(yardstick.bound_s(*fam.ssm_work(cfg, s.attrs["B"])) for s in steps)
    return 100.0 * n * per_step / len(steps) / device_s
