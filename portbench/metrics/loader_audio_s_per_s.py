"""loader_audio_s_per_s (host loop: runner/convert.py's ClipLoader): the
audio-seconds the loader yields over the host seconds it takes to produce
them, rank 0: the program's counter ``loader.audio_s`` (each clip's samples
over the model's rate) over the total of its span ``loader.window`` (from
handing a window of files to the decode threads to holding its clips). The
loader's rate while it works, to set beside the card's. Nothing where the
program records no such span (``fadtk_tpu_torch.runner.profiling``)."""


def read(ctx):
    from fadtk_tpu_torch.runner import profiling

    snapshot = getattr(profiling, "snapshot", None)
    if snapshot is None:
        return None
    s = snapshot()
    audio = s["counters"].get("loader.audio_s")
    busy = s["seconds"].get("loader.window")
    if not audio or not busy:
        return None
    return audio / busy
