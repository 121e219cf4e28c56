"""Multi-device evaluation, ported from ``fadtk_tpu.parallel``: the (dp, tp)
process mesh (``mesh``), the tensor-parallel speech step with its sharded
statistics (``tp``) and the chunked / whole-clip data-parallel pipeline of
the other families (``dp``). ``whisper_tp`` and ``multihost`` are not ported
yet."""
