"""The benchmark's own tests (``python -m pytest benchmark/tests``): CPU
tests at tiny sizes, and tests marked ``gpu`` that need the card and skip
without one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    import torch

    # Tiny CPU runs are timed windows: one thread a worker keeps several
    # workers from starving each other.
    torch.set_num_threads(1)
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips without one")
