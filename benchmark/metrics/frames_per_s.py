"""Audio frames emitted in the window, those of unfinished requests
included, over the window's seconds."""


def read(run):
    return run.frames / run.window_s
