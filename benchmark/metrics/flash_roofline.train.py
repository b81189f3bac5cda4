"""The flash kernels' share of their roofline (%): K3 with its
log-sum-exp, K5a and K5b in the traced step, their launches' summed bounds
(the family's ``flash_train_work``) over their summed device time."""


def read(run):
    t = run.trace
    if not t or not t["bounds_s"].get("flash"):
        return None
    secs = sum(t["groups"].get(g, [0, 0.0])[1]
               for g in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
    return 100.0 * t["bounds_s"]["flash"] / secs if secs else None
