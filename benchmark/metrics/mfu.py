"""Model FLOPs utilization (%): the model FLOPs of the window's work,
counted from shapes by ``benchmark/yardstick.py``, over the wall time of the
benchmark's calls into the program and the card's 989 TFLOP/s (bf16 dense,
NVIDIA data sheet, at its full power limit)."""

from benchmark import yardstick


def read(run):
    if not run.span_total_s:
        return None
    return 100.0 * run.flops / run.span_total_s / yardstick.PEAK_FLOPS["bfloat16"]
