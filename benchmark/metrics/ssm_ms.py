"""The device milliseconds a backbone frame step spends in the mixer step
kernel: its device time in the traced sub-window, under its exact name
``ssm_step_kernel`` in the device trace (graph replays included), over the
backbone steps there (the program's ``csm.gen.backbone`` spans): the mean
a step, since the trace keeps each kernel's total.  Where the trace holds
no such kernel (the plain version on a CPU) the ``csm.ssm.launch`` spans'
own times stand in.  A model without mixers reads nothing."""

from benchmark.metrics.ssm_roofline import backbone_steps, kernel_time, session


def read(run):
    steps = backbone_steps(run)
    if not steps:
        return None
    _, seconds = kernel_time(run.trace)
    if not seconds:
        seconds = sum(s.device_ms or 0.0 for s in session(run).named("csm.ssm.launch")) / 1e3
    return 1e3 * seconds / len(steps) if seconds else None
