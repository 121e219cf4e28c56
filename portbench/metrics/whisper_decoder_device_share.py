"""whisper_decoder_device_share (model step: models/whisper_impl.py's
decoder): device time of the kernels launched inside the decoder's layers,
32 of them, each a causal self-attention, an attention onto the 1500
encoder states (its k and v projections of those states included) and a
feed-forward, over all device kernel time of the window, from the
profiler's trace.

Under ``--trace 1`` the range ``portbench.decoder`` wraps the bodies of
the decoder's stages, ``_decoder_attention``, ``_cross_attention`` and
``_decoder_feed_forward``, where the program defines them; a program
without them reads nothing. Not ``whisper_decode``: the program opens its
spans ``fadtk.model.*`` inside it, around those bodies, and a kernel
belongs to the innermost range it was launched in, so a range around the
whole decoder would hold no kernel. Left out: the two tokens' embedding
and the final LayerNorm, a few small kernels a forward."""

MODULE = "fadtk_tpu_torch.models.whisper_impl"
BODIES = ("_decoder_attention", "_cross_attention", "_decoder_feed_forward")


def _targets() -> list[str]:
    import importlib

    mod = importlib.import_module(MODULE)
    return [f"{MODULE}:{b}" for b in BODIES if hasattr(mod, b)]


RANGES = {"decoder": _targets()}


def read(ctx):
    tr = ctx.record.trace
    if not tr or not tr.get("kernel_s") or not tr["ranges"].get("decoder"):
        return None
    return tr["ranges"]["decoder"] / tr["kernel_s"]
