"""The median device-timeline milliseconds of one micro-batch's backward
(``csm.train.backward``, between two timing events on the stream) in the
traced training step."""

import statistics

from csm_tpu_torch.utils import profiling


def read(run):
    sess = run.trace and getattr(profiling, "last_session", lambda: None)()
    d = [s.device_ms for s in sess.named("csm.train.backward") if s.end_ns] if sess else []
    d = [ms for ms in d if ms is not None]
    return statistics.median(d) if d else None
