"""wavlm_mfu (whole step): ``mfu`` in the WavLM cell, read by the ``mfu``
reader itself, which lists only the cell it was accepted with."""

from pathlib import Path

from portbench.harness import metric_reader


def read(ctx):
    return metric_reader("mfu", Path(__file__).resolve().parent).read(ctx)
