"""embed_audio_s_per_s: audio-seconds of every dataset call completed in
the window over the window's wall time, from the start of the first call to
the end of the last (host clock). Across all cards of the job: each call's
dataset counts once."""


def read(ctx):
    if not ctx.record.calls or ctx.record.window_s <= 0:
        return None
    return sum(c["audio_s"] for c in ctx.record.calls) / ctx.record.window_s
