"""The window's milliseconds over the training sequences completed in it
(the optimizer updates inside, each ending in a host read of its loss)."""


def read(run):
    return run.window_s / run.sequences * 1e3 if run.sequences else None
