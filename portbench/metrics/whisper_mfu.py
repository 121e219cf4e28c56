"""whisper_mfu (whole step): ``mfu`` in the Whisper cell, read by the ``mfu``
reader itself, which lists only the cell it was accepted with. Each clip
counts one 30 s window's FLOPs (``portbench/families/whisper.py``)."""

from pathlib import Path

from portbench.harness import metric_reader


def read(ctx):
    return metric_reader("mfu", Path(__file__).resolve().parent).read(ctx)
