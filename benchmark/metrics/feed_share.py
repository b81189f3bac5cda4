"""The codec's share (%) of the serving steps in the traced sub-window: the
host milliseconds of the ``csm.codec.feed`` spans inside a
``csm.serve.step`` over those of the steps."""

from csm_tpu_torch.utils import profiling


def read(run):
    sess = run.trace and getattr(profiling, "last_session", lambda: None)()
    if not sess:
        return None
    steps = sum(s.host_ms for s in sess.named("csm.serve.step") if s.end_ns)
    feeds = [s.host_ms for s in sess.named("csm.codec.feed")
             if s.end_ns and s.within("csm.serve.step")]
    return 100.0 * sum(feeds) / steps if feeds and steps else None
