"""The median device-timeline milliseconds of one optimizer update
(``csm.train.update``: the gradients' scale, clipping and AdamW, between
two timing events on the stream) in the traced training step."""

import statistics

from csm_tpu_torch.utils import profiling


def read(run):
    sess = run.trace and getattr(profiling, "last_session", lambda: None)()
    d = [s.device_ms for s in sess.named("csm.train.update") if s.end_ns] if sess else []
    d = [ms for ms in d if ms is not None]
    return statistics.median(d) if d else None
