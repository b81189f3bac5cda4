"""The median host milliseconds of one admission (``CSMServer``'s batch-1
prefill, first frame, slot scatter and first codec feed), traced run."""

import statistics


def read(run):
    d = run.spans.get("admit")
    return statistics.median(d) * 1e3 if d else None
