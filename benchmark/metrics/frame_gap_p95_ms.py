"""The gap between a stream's consecutive audio chunks, 95th percentile
(ms), pooled over every stream and every gap in the window (real time is 80
ms a chunk).  A stream still live when the window closes adds its open gap,
from its last chunk to the close, so a stall cannot drop out of the tail."""

import numpy as np


def read(run):
    gaps = []
    for r in run.requests:
        t = r["times"]
        gaps += [b - a for a, b in zip(t, t[1:])]
        if t and not r["finished"]:
            gaps.append(run.window_s - t[-1])
    return float(np.percentile(gaps, 95)) * 1e3 if gaps else None
