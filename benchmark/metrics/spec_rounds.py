"""Speculative rounds a frame in the traced sub-window: the
``csm.spec.round`` spans (one draft of every codebook by the fused kernel
and its plain verify) over the ``csm.gen.codebooks`` spans (one a frame, at
most 31 rounds each at CSM-1B's 32 codebooks)."""

from csm_tpu_torch.utils import profiling


def read(run):
    sess = run.trace and getattr(profiling, "last_session", lambda: None)()
    frames = len(sess.named("csm.gen.codebooks")) if sess else 0
    return len(sess.named("csm.spec.round")) / frames if frames else None
