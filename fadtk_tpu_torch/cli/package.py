"""`python -m fadtk_tpu_torch.package` — package a directory's statistics for
many models into one ``.npz`` baseline file.

Port of ``fadtk_tpu/cli/package.py`` (reference fadtk/package.py:7-42):
embeds the directory with every registered model (or the ``--models``
given), computes each model's (mu, cov) and saves them keyed
``{model}.mu`` / ``{model}.cov``, the format of the shipped fma_pop.npz
(looked up as in fadtk/fad.py:263-266). An output name that is not
``.npz`` asks for confirmation, as the reference does.
"""

from __future__ import annotations

from argparse import ArgumentParser
from pathlib import Path

import numpy as np

from ..models.registry import get_all_models
from ..runner.batch import cache_embedding_files_multi
from ..runner.fad import FrechetAudioDistance
from ..utils import log


def main() -> None:
    ap = ArgumentParser(prog="python -m fadtk_tpu_torch.package")
    ap.add_argument("directory", type=str)
    ap.add_argument("out", type=str)
    ap.add_argument("-w", "--workers", type=int, default=8)
    ap.add_argument("-s", "--sox-path", type=str, default="/usr/bin/sox",
                    help="(accepted for reference compatibility; unused)")
    ap.add_argument("--models", type=str, nargs="*", default=None,
                    help="restrict to these model names (default: all)")
    args = ap.parse_args()

    out = Path(args.out)
    if out.suffix != ".npz":
        print("The output file you specified is not a npz file, are you sure? (y/N)")
        if input().lower() != "y":
            raise SystemExit(1)

    models = get_all_models()
    if args.models:
        wanted = set(args.models)
        models = [m for m in models if m.name in wanted]
        missing = wanted - {m.name for m in models}
        if missing:
            raise SystemExit(f"Unknown models: {sorted(missing)}")

    # 1. Embeddings (the per-layer variants of a backbone share a forward).
    cache_embedding_files_multi(models, args.directory, workers=args.workers)

    # 2. Statistics of every model.
    data = {}
    for model in models:
        mu, cov = FrechetAudioDistance(model, load_model=False).load_stats(args.directory)
        data[f"{model.name}.mu"] = mu
        data[f"{model.name}.cov"] = cov

    # 3. Save.
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **data)
    log.info(f"Packaged statistics for {len(models)} models into {out}")


if __name__ == "__main__":
    main()
