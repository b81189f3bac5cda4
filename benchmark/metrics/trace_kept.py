"""The share (%) of the backbone-step and codebook kernels' launches that
the traced sub-window recorded which its device trace holds: the K1 / K1q
and K2 kernels under their exact names over the program's ``csm.bb.launch``
and ``csm.k2.launch`` spans.  Under 95 % the trace lost device records, and
the rooflines and idle share read from it overstate.  A run that launched
none of them (the kernels' plain versions on a CPU) lost none: 100."""

from csm_tpu_torch.utils import profiling


def read(run):
    t = run.trace
    sess = t and getattr(profiling, "last_session", lambda: None)()
    if not sess:
        return None
    launched = len(sess.named("csm.bb.launch")) + len(sess.named("csm.k2.launch"))
    traced = sum(t["groups"].get(g, [0, 0.0])[0] for g in ("bb", "k2"))
    if not launched:
        return None if traced else 100.0
    return 100.0 * traced / launched
