"""step_gap_share (device): the device seconds between one step's end and
the next step's start, over the window, rank 0: the program's counter
``pipeline.device_gap_s``, from CUDA events on the step's stream just before
each step's copy to the card and just after its merge, read at the pass's
final fetch. The card waiting for the host to enqueue the next step; at
most ``device_idle_share``, whose rest is idle inside steps. Nothing on the
CPU, or where the program records no such counter
(``fadtk_tpu_torch.runner.profiling``)."""


def read(ctx):
    from fadtk_tpu_torch.runner import profiling

    snapshot = getattr(profiling, "snapshot", None)
    if snapshot is None or ctx.record.window_s <= 0:
        return None
    gap = snapshot()["counters"].get("pipeline.device_gap_s")
    if gap is None:
        return None
    return gap / ctx.record.window_s
