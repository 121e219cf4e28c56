"""Multi-device evaluation: the (dp, tp) process mesh (``mesh``) and the
tensor-parallel speech step with its sharded statistics (``tp``), ported from
``fadtk_tpu.parallel``. The generic chunked / whole-clip data-parallel
pipeline (``dp``), ``whisper_tp`` and ``multihost`` are not ported yet."""
