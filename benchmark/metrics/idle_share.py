"""The device's idle share (%) of the traced calls' wall time: the
benchmark's calls into the program (not the waits for arrivals) less the
union of device activity inside them."""


def read(run):
    t = run.trace
    if not t or not t["span_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["span_s"])
