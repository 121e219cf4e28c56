"""gated_bias_device_share (model step: models/speech/encoder.py's WavLM
gated bias): device time of the kernels launched inside
``wavlm_gated_bias`` over all device kernel time of the window, from the
profiler's trace. Its ops: the gate's projection, sum, sigmoid and
products on (B, T, H), then on the float32 path the dense (B, H, T, T)
bias, gate times the relative-position table plus the key mask.

Under ``--trace 1`` the range ``portbench.gated_bias`` wraps the body of
``wavlm_gated_bias``, ``_wavlm_gate_and_bias``, where the program defines
it; a program without it reads nothing. Not the function itself: it opens
the program's own range ``fadtk.model.gated_bias`` around its body, and the
profiler gives each kernel to the innermost range it was launched in, so a
range around the function would hold no kernel on the device's side."""

TARGET = "fadtk_tpu_torch.models.speech.encoder:_wavlm_gate_and_bias"


def _targets() -> list[str]:
    from fadtk_tpu_torch.models.speech import encoder

    return [TARGET] if hasattr(encoder, TARGET.split(":")[1]) else []


RANGES = {"gated_bias": _targets()}


def read(ctx):
    tr = ctx.record.trace
    if not tr or not tr.get("kernel_s") or not tr["ranges"].get("gated_bias"):
        return None
    return tr["ranges"]["gated_bias"] / tr["kernel_s"]
