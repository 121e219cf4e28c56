"""Multi-device evaluation, ported from ``fadtk_tpu.parallel``: the (dp, tp)
process mesh (``mesh``) and its multi-node initialisation (``multihost``), the
tensor-parallel speech shards and step with its sharded statistics (``tp``),
the tensor-parallel Whisper shards and step (``whisper_tp``) and the chunked /
whole-clip data-parallel pipeline of the other families (``dp``)."""
