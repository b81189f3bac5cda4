"""Time to first audio, 90th percentile (ms), over every request due in the
window: from its due time to the return of the call that put its first 80 ms
chunk on the host; a request still without audio when the window closes
counts at the window's end, so a stall cannot drop out of the tail.  In a
closed loop a request is due when its client sends it."""

import numpy as np


def read(run):
    waits = [(r["times"][0] if r["times"] else run.window_s) - r["due"]
             for r in run.requests if r["due"] <= run.window_s]
    return float(np.percentile(waits, 90)) * 1e3 if waits else None
