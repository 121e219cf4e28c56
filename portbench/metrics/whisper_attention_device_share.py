"""whisper_attention_device_share (model step: models/whisper_impl.py's
encoder self-attention): device time of the kernels launched inside the
encoder's attention core, q k^T, the softmax over the dense (B, H, 1500,
1500) float32 logits and p v, over all device kernel time of the window,
from the profiler's trace.

Under ``--trace 1`` the range ``portbench.encoder_attention`` wraps
``_encoder_attention_core``, where the program defines it; a program
without it reads nothing. Only the core: the decoder's attention goes
through ``_attention_core`` under its own name, and the program's span
``fadtk.model.attention`` opens outside the core, so the core's kernels
belong to this range (a kernel belongs to the innermost range it was
launched in)."""

MODULE = "fadtk_tpu_torch.models.whisper_impl"
BODIES = ("_encoder_attention_core",)


def _targets() -> list[str]:
    import importlib

    mod = importlib.import_module(MODULE)
    return [f"{MODULE}:{b}" for b in BODIES if hasattr(mod, b)]


RANGES = {"encoder_attention": _targets()}


def read(ctx):
    tr = ctx.record.trace
    if not tr or not tr.get("kernel_s") or not tr["ranges"].get("encoder_attention"):
        return None
    return tr["ranges"]["encoder_attention"] / tr["kernel_s"]
