"""The median device-timeline milliseconds of an admission's prefill (the
``csm.gen.prefill`` spans inside ``csm.serve.admit``: the backbone over the
bucket-padded prompt, between two timing events on the stream).  The traced
sub-window's admissions; where it holds none, the run's other traced ones
(set-up traces one admission)."""

import statistics

from csm_tpu_torch.utils import profiling


def _prefills(sess) -> list:
    return [s.device_ms for s in sess.named("csm.gen.prefill")
            if s.end_ns and s.within("csm.serve.admit")]


def read(run):
    if not run.trace or not hasattr(profiling, "last_session"):
        return None
    sessions = profiling.sessions()
    d = _prefills(sessions[-1]) if sessions else []
    if not d:
        d = [ms for sess in sessions for ms in _prefills(sess)]
    d = [ms for ms in d if ms is not None]
    return statistics.median(d) if d else None
