"""`python -m fadtk_tpu_torch.embeds` — precompute embeddings for several
models over several directories.

Port of ``fadtk_tpu/cli/embeds.py`` (reference fadtk/embeds.py:5-27):
``-m MODELS... -d DIRS...``, optional ``-w`` / ``-s`` and ``--bf16``. The
per-layer variants of one backbone (e.g. MERT-v1-95M-1..12) are grouped and
served from a single forward per file
(``runner/batch.py::cache_embedding_files_multi``).
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

from ..models.registry import get_all_models
from ..runner.batch import cache_embedding_files_multi


def main() -> None:
    models = {m.name: m for m in get_all_models()}

    ap = ArgumentParser(prog="python -m fadtk_tpu_torch.embeds")
    ap.add_argument("-m", "--models", type=str, choices=list(models.keys()),
                    nargs="+", required=True)
    ap.add_argument("-d", "--dirs", type=str, nargs="+", required=True)
    ap.add_argument("-w", "--workers", type=int, default=8)
    ap.add_argument("-s", "--sox-path", type=str, default="/usr/bin/sox",
                    help="(accepted for reference compatibility; unused)")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 throughput mode: embeddings cache under "
                         "'<model>-bf16' (see python -m fadtk_tpu_torch --bf16)")
    args = ap.parse_args()

    if args.bf16:
        os.environ["FADTK_TPU_BF16"] = "1"

    selected = [models[name] for name in args.models]
    for d in args.dirs:
        cache_embedding_files_multi(selected, d, workers=args.workers)


if __name__ == "__main__":
    main()
