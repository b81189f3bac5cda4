"""Trainer reporting (counterpart of ``csm_tpu/train/reporting.py``): the
reference inherits TensorBoard via HF ``Trainer.log`` (``train.py:316-324``);
here the same two-loss split flows through an explicit reporter.

``make_reporter("tensorboard", logdir)`` returns a writer that emits
TensorBoard event files (scalars ``train/loss``, ``train/backbone_loss``,
``train/decoder_loss``, ``eval/loss``, ...); ``"none"`` is a no-op.
"""

from __future__ import annotations

from typing import Dict


class _NullReporter:
    def log(self, step: int, metrics: Dict[str, float]) -> None:
        pass

    def close(self) -> None:
        pass


class _TensorBoardReporter:
    def __init__(self, logdir: str):
        # Imported here so that "none" runs never need the tensorboard package.
        from torch.utils.tensorboard import SummaryWriter

        self._w = SummaryWriter(log_dir=logdir)

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        for k, v in metrics.items():
            if k in ("step", "time"):
                continue
            tag = k if "/" in k else (
                f"eval/{k[len('eval_'):]}" if k.startswith("eval_")
                else f"train/{k}"
            )
            self._w.add_scalar(tag, float(v), global_step=step)

    def close(self) -> None:
        self._w.flush()
        self._w.close()


def make_reporter(report_to: str, logdir: str):
    """Build a metrics reporter.  ``report_to``: "none" or "tensorboard"."""
    if report_to in ("none", "", None):
        return _NullReporter()
    if report_to == "tensorboard":
        return _TensorBoardReporter(logdir)
    raise ValueError(
        f"report_to must be 'none' or 'tensorboard', got {report_to!r}"
    )
