"""The median host milliseconds of one ``CSMServer.step()`` in the window
(one frame for every slot, its host read, its codec feeds; the few steps
that also admit a request sit above the median)."""

import statistics


def read(run):
    d = run.spans.get("call.step")
    return statistics.median(d) * 1e3 if d else None
