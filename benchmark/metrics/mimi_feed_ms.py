"""The median host milliseconds of one slot's streaming Mimi decoder feed
(one frame of codes to 80 ms of PCM, ending in its host read), traced run."""

import statistics


def read(run):
    d = run.spans.get("feed")
    return statistics.median(d) * 1e3 if d else None
