"""`python -m fadtk_tpu_torch.test` — golden-score regression harness.

Port of ``fadtk_tpu/cli/test_harness.py`` (reference fadtk/test/__main__.py):

- reads a golden CSV with columns ``song_id, dataset, FAD_{model}_fma_pop``;
- for each registered model with golden data (MERT limited to layers
  1/4/8/default, reference :27-29): caches the sample clips' embeddings,
  writes per-song FAD against the baseline through ``score_individual`` and
  appends the whole-set FAD as the row '/samples/all' (:55-61), in
  fad_scores/{model}.csv (skipped when present, :32-34);
- verification: mad% = max_abs_diff / mean * 100 per model, PASS iff below
  the threshold (5, :93); writes comparison.csv; exits 2 if a model fails
  (:104) and 1 on an embedding or scoring error (:42-53).

The sample clips and the golden CSV ship with the reference; point
``--samples`` / ``--golden`` (or ``FADTK_REF_TEST``) at its fadtk/test
directory. Models without converted weights are reported as SKIPPED.
"""

from __future__ import annotations

import os
import traceback
from argparse import ArgumentParser
from pathlib import Path

import numpy as np

from ..models.registry import get_all_models
from ..runner.fad import FrechetAudioDistance
from ..utils import dataset_files, log
from ..weights.store import MissingWeightsError


def _read_golden(path: Path) -> tuple[list[str], dict[str, dict[str, float]]]:
    """-> (model names with golden data, {model: {song_id: score}})."""
    import csv

    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    data = {
        c.split("_", 1)[1].removesuffix("_fma_pop"): {r["song_id"]: float(r[c]) for r in rows}
        for c in rows[0].keys() if c.startswith("FAD_")
    }
    return list(data), data


def main() -> None:
    ap = ArgumentParser(prog="python -m fadtk_tpu_torch.test")
    default_ref = os.environ.get("FADTK_REF_TEST", "fadtk/test")
    ap.add_argument("--samples", type=str, default=f"{default_ref}/samples")
    ap.add_argument("--golden", type=str, default=f"{default_ref}/samples_FAD_scores.csv")
    ap.add_argument("--baseline", type=str, default="fma_pop",
                    help="baseline stats source (shipped npz name / npz path / dir)")
    ap.add_argument("--out-dir", type=str, default="fad_scores")
    ap.add_argument("--threshold", type=float, default=5.0, help="mad%% pass gate")
    ap.add_argument("--models", type=str, nargs="*", default=None)
    args = ap.parse_args()

    samples = Path(args.samples)
    golden_path = Path(args.golden)
    if not samples.is_dir() or not golden_path.is_file():
        log.error(f"Test fixtures not found (samples={samples}, golden={golden_path}). "
                  "Point --samples/--golden (or FADTK_REF_TEST) at the reference's "
                  "fadtk/test data.")
        raise SystemExit(1)

    reference_models, golden = _read_golden(golden_path)
    print("Models with reference data:", reference_models)

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    skipped: list[str] = []

    for model in get_all_models():
        if args.models and model.name not in args.models:
            continue
        if model.name.replace("-", "_") not in reference_models:
            continue
        # Runtime bound, as the reference: MERT layers 1/4/8/default only.
        if model.name.startswith("MERT") and model.name[-1] not in ["1", "4", "8", "M"]:
            continue

        csv = out_dir / f"{model.name}.csv"
        if csv.is_file():
            continue

        log.info(f"Computing FAD score for {model.name}")
        try:
            fad = FrechetAudioDistance(model, audio_load_worker=1, load_model=True)
        except MissingWeightsError as e:
            log.warning(f"SKIP {model.name}: {e}")
            skipped.append(model.name)
            continue

        try:
            for f in dataset_files(samples):
                fad.cache_embedding_file(f)
        except Exception as e:
            traceback.print_exc()
            log.error(f"Error when caching embedding files for {model.name}: {e}")
            raise SystemExit(1)

        try:
            fad.score_individual(args.baseline, samples, csv)
        except Exception as e:
            traceback.print_exc()
            log.error(f"Error when computing FAD score for {model.name}: {e}")
            raise SystemExit(1)

        all_score = fad.score(args.baseline, samples)
        content = csv.read_text()
        sep = "" if (not content or content.endswith("\n")) else "\n"
        with open(csv, "a") as f:
            f.write(f"{sep}/samples/all,{all_score}\n")

    # Verification (reference :63-98).
    table = []
    for f in sorted(out_dir.glob("*.csv")):
        model_name = f.stem.replace("-", "_")
        test = golden.get(model_name)
        if test is None:
            continue
        computed: dict[str, float] = {}
        for line in f.read_text().strip().split("\n"):
            path_str, score = line.split(",")
            song = "/".join(path_str.replace("\\", "/").split("/")[-2:]).split(".")[0]
            computed[song] = float(score)
        got = np.array(list(computed.values()))
        want = np.array([test[k] for k in computed])

        max_abs_diff = float(np.abs(got - want).max())
        mean = float(np.mean(got))
        madp = max_abs_diff / mean * 100
        table.append(dict(model=model_name, mse=float(((got - want) ** 2).mean()),
                          max_abs_diff=max_abs_diff, mean=mean, **{"mad%": madp},
                          passed=madp < args.threshold))

    if table:
        lines = [",".join(table[0])] + [",".join(str(v) for v in row.values()) for row in table]
        print("\n".join(lines))
        Path("comparison.csv").write_text("\n".join(lines) + "\n")

    if skipped:
        log.warning(f"Skipped (no converted weights): {skipped}")

    if table and not all(r["passed"] for r in table):
        log.error("Some models failed the test")
        raise SystemExit(2)


if __name__ == "__main__":
    main()
