"""Process start to the first timed event: weights, bundles, warm-up and,
in a checkout's first run, the kernels' builds."""


def read(run):
    return run.setup_s
