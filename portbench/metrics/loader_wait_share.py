"""loader_wait_share (host loop: runner/device_pipeline.py and
runner/convert.py's ClipLoader): host-clock seconds the pipeline's loop
waits inside ``ClipLoader.iter_clips`` for its next clip, over the window.
The span ``loader_wait`` is recorded by the harness's wrapper of the loader."""


def read(ctx):
    wait = ctx.record.span_total("loader_wait")
    if not wait or ctx.record.window_s <= 0:
        return None
    return wait / ctx.record.window_s
