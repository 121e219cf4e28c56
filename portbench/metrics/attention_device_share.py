"""attention_device_share (model step: models/speech/encoder.py attention):
device time of the kernels launched inside the attention functions over all
device kernel time of the window, from the profiler's trace.

The functions below are wrapped in the range ``portbench.attention`` under
``--trace 1``: the plain float32 attention ``_attention_core`` (its ops:
aten::mul for the scale, aten::bmm for q k^T and p v, aten::add for the key
bias, aten::_softmax, and the copies of the head transposes) and the port's
flash kernels K1/K1b (``flash_attention_packed``) and K2
(``flash_attention``) where attention is routed to them."""

RANGES = {"attention": [
    "fadtk_tpu_torch.models.speech.encoder:_attention_core",
    "fadtk_tpu_torch.ops.flash_attention:flash_attention_packed",
    "fadtk_tpu_torch.ops.flash_attention:flash_attention",
]}


def read(ctx):
    tr = ctx.record.trace
    if not tr or not tr.get("kernel_s") or not tr["ranges"].get("attention"):
        return None
    return tr["ranges"]["attention"] / tr["kernel_s"]
