"""Module-path parity with ``fadtk.fad_batch`` (reference fadtk/fad_batch.py).

The reference's one public name is ``cache_embedding_files`` (fad_batch.py:25);
its process pool becomes decode threads ahead of batched device inference
here (``runner/batch.py``), with the same signature and cache side effects.
"""

from .runner.batch import cache_embedding_files
from .utils import log

__all__ = ["cache_embedding_files", "log"]
