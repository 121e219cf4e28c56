"""gated_bias_gib_per_audio_s (model step: models/speech/encoder.py's WavLM
gated bias): the GiB of dense (B, H, T, T) gated bias the program builds
a second of audio embedded, rank 0: its counter ``model.gated_bias_bytes``
(each bias's bytes, from its shape) over 2^30 and the audio-seconds of the
window's calls. Nothing where the program records no such counter
(``fadtk_tpu_torch.runner.profiling``)."""


def read(ctx):
    from fadtk_tpu_torch.runner import profiling

    snapshot = getattr(profiling, "snapshot", None)
    audio_s = sum(c["audio_s"] for c in ctx.record.calls)
    if snapshot is None or not audio_s:
        return None
    built = snapshot()["counters"].get("model.gated_bias_bytes")
    if not built:
        return None
    return built / 2**30 / audio_s
