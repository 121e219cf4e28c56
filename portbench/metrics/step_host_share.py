"""step_host_share (host loop: runner/device_pipeline.py's loop): the host
seconds the loop spends inside the model step, from the call until it
returns (the total of the program's span ``pipeline.step``), over the
window, rank 0. Near 0 when the step only enqueues device work; large when
the host waits on the device inside it. Nothing where the program records
no such span (``fadtk_tpu_torch.runner.profiling``)."""


def read(ctx):
    from fadtk_tpu_torch.runner import profiling

    snapshot = getattr(profiling, "snapshot", None)
    if snapshot is None or ctx.record.window_s <= 0:
        return None
    step = snapshot()["seconds"].get("pipeline.step")
    if step is None:
        return None
    return step / ctx.record.window_s
