"""mfu (whole step): the model FLOPs the window's clips need, each at its
own valid length (portbench/flops.py), over the window's wall time x cards
x the card's published dense peak for the configuration's precision
(portbench/roofline.py: 495 TFLOP/s TF32 for float32, 989 bf16)."""

from portbench.roofline import PEAK_FLOPS


def read(ctx):
    r = ctx.record
    if not r.calls or r.window_s <= 0:
        return None
    flops = sum(c["flops"] for c in r.calls)
    return flops / (r.window_s * r.chips * PEAK_FLOPS[r.precision])
