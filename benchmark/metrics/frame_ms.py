"""The median host milliseconds of the program's ``csm.serve.frame`` span
in the traced sub-window: one frame for every slot through its host read,
without the step's codec feeds and admissions."""

import statistics

from csm_tpu_torch.utils import profiling


def read(run):
    sess = run.trace and getattr(profiling, "last_session", lambda: None)()
    d = [s.host_ms for s in sess.named("csm.serve.frame") if s.end_ns] if sess else []
    return statistics.median(d) if d else None
