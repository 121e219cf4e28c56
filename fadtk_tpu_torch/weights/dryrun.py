"""``convert_cli --dry-run``: validate converter <-> checkpoint key coverage
without real weights.

The port of ``fadtk_tpu/weights/dryrun.py``. The converters for the non-HF
checkpoints (laion_clap .pt, msclap .pth, dac .pth, cdpam .pth, torchvggish
.pth) were written against the published state-dict schemas; key-name drift
would only surface as a KeyError on the user's machine. The dry-run closes
that loop without weights:

1. On any machine with the checkpoint: ``python -m
   fadtk_tpu_torch.weights.convert_cli --dump-schema ck.pth ck.json`` writes
   the {key: shape} inventory (a few KB of text).
2. Anywhere: ``python -m fadtk_tpu_torch.weights.convert_cli <model>
   --dry-run ck.json`` fabricates zero tensors of those shapes, runs the REAL
   converter over a recording mapping, and fails if (a) the converter asks
   for a key the checkpoint doesn't have, (b) any key in the model-relevant
   subtree goes unconsumed (silent weight drop), or (c) the converted tree,
   carried into a ``state_dict`` by ``store.params_from_jax``, disagrees
   key for key or shape for shape with the port's own module for the model.

The reference modules are built on the ``meta`` device: shapes only, no
weights drawn and no card needed, and ``FADTK_TPU_RANDOM_WEIGHTS`` is left
as the caller set it. Recorded schemas under ``weights/schemas.py`` pin the
converters in the tests.
"""

from __future__ import annotations

import json
from typing import Callable

import numpy as np

from ..utils import log


class FakeTensor:
    """A shape-only tensor stand-in that records when its VALUE is consumed.

    Converters may copy/re-key the state dict freely (``dict(sd)``,
    comprehensions) — reference shuffling does not count as consumption; only
    materializing the value (torch-style .detach() chain or numpy coercion)
    marks the key as used. Structure peeking (.shape/.ndim) is free, so
    shape-driven converters (cdpam) can discover geometry without marking
    everything consumed.
    """

    def __init__(self, key: str, shape: tuple, accessed: set):
        self.key = key
        self.shape = tuple(int(s) for s in shape)
        self._accessed = accessed

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def detach(self):
        self._accessed.add(self.key)
        return self

    def cpu(self):
        return self

    def numpy(self) -> np.ndarray:
        self._accessed.add(self.key)
        return np.zeros(self.shape, np.float32)

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        self._accessed.add(self.key)
        return np.zeros(self.shape, dtype or np.float32)


def recording_state_dict(shapes: dict[str, tuple]) -> tuple[dict, set]:
    accessed: set[str] = set()
    return {k: FakeTensor(k, v, accessed) for k, v in shapes.items()}, accessed


def load_schema(path) -> dict[str, tuple]:
    """Read a {key: shape} json (the --dump-schema format)."""
    with open(path) as f:
        raw = json.load(f)
    out = {}
    for k, v in raw.items():
        out[k] = tuple(v["shape"] if isinstance(v, dict) else v)
    return out


def dump_schema(checkpoint: str, out_path: str) -> None:
    """Dump a torch checkpoint's {key: shape} inventory to json."""
    import torch

    ck = torch.load(checkpoint, map_location="cpu", weights_only=False)
    sd = ck
    if isinstance(ck, dict):
        for wrap in ("state_dict", "state", "model"):
            if wrap in ck and isinstance(ck[wrap], dict):
                sd = ck[wrap]
                break
    shapes = {
        k: list(v.shape) for k, v in sd.items() if hasattr(v, "shape")
    }
    with open(out_path, "w") as f:
        json.dump(shapes, f, indent=0, sort_keys=True)
    log.info(f"Wrote {len(shapes)} key shapes to {out_path}")


def _state_shapes(params, conv_layout: str) -> dict[str, tuple]:
    from .store import params_from_jax

    return {k: tuple(v.shape) for k, v in params_from_jax(params, conv_layout).items()}


def dry_run_convert(
    name: str,
    schema: dict[str, tuple],
    convert: Callable[[dict], dict],
    relevant: Callable[[str], bool],
    reference: Callable[[dict], "torch.nn.Module"] | None = None,
    conv_layout: str = "HIO",
) -> dict:
    """Run ``convert`` over fabricated tensors; raise on coverage gaps.

    relevant(key) -> True for keys belonging to the subtree this model is
    supposed to consume (e.g. 'encoder.*' for DAC — the same checkpoint also
    carries decoder/quantizer weights that are legitimately unused).
    reference(params) -> the port's module the converted tree must load into
    (its ``state_dict`` keys and shapes), given the converted tree for
    converters that infer their geometry; ``conv_layout`` is the family's,
    as its ``load_model`` passes it to ``params_from_jax``.
    """
    rec, accessed = recording_state_dict(schema)
    try:
        params = convert(rec)
    except KeyError as e:
        raise ValueError(
            f"{name}: converter requested a key absent from the checkpoint "
            f"schema: {e}. Key drift — update the converter."
        ) from e

    # Non-learnable torch buffers that carry no weight information — either
    # bookkeeping or deterministic index tables the forward recomputes.
    ignorable = (
        "num_batches_tracked",
        "relative_position_index",
        "position_ids",
        "attn_mask",
    )
    unconsumed = [
        k for k in schema
        if relevant(k) and k not in accessed and not k.endswith(ignorable)
    ]
    if unconsumed:
        raise ValueError(
            f"{name}: {len(unconsumed)} relevant checkpoint keys were never "
            f"read — silent weight drop. First 20: {sorted(unconsumed)[:20]}"
        )

    irrelevant = [k for k in schema if not relevant(k)]
    log.info(
        f"{name}: dry-run OK — consumed {len(accessed)}/{len(schema)} keys "
        f"({len(irrelevant)} outside the model subtree, e.g. text tower/decoder)"
    )

    if reference is not None:
        import torch

        with torch.device("meta"):
            module = reference(params)
        got = _state_shapes(params, conv_layout)
        want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
        mismatches = [(k, got.get(k), want[k]) for k in want if got.get(k) != want[k]]
        extra = [k for k in got if k not in want]
        if mismatches or extra:
            raise ValueError(
                f"{name}: converted tree disagrees with the model's module: "
                f"mismatched={mismatches[:10]} extra={extra[:10]}"
            )
        log.info(f"{name}: converted tree matches the model's module ({len(want)} tensors)")
    return params


def _htsat_relevant(k: str) -> bool:
    k = k.removeprefix("module.")
    return (
        k.startswith(("audio_branch.", "audio_projection.", "audio_model."))
        and "spectrogram_extractor" not in k
        and "logmel_extractor" not in k
        # token-semantic classifier head: CLAP taps latent_output before it
        # (laion_clap get_audio_embedding), legitimately unconverted like
        # DAC's decoder subtree.
        and ".tscam_conv." not in k
        and not k.startswith("audio_branch.head.")
    )


def _msclap_relevant(k: str) -> bool:
    k = k.removeprefix("module.")
    return (
        k.startswith("audio_encoder.")
        and "spectrogram" not in k
        and "logmel_extractor" not in k
        and ".tscam_conv." not in k
        and ".htsat.head." not in k  # see the laion note above
    )


def dry_run_model(name: str, schema_path: str) -> None:
    """Entry used by ``convert_cli <model> --dry-run <sd.json>``."""
    from dataclasses import replace

    from ..models.registry import get_model

    schema = load_schema(schema_path)
    model = get_model(name)

    if name == "dac-44kHz":
        from ..models.dac_impl import DACEncoder
        from .dac import convert_dac_encoder

        dry_run_convert(
            name,
            schema,
            lambda sd: convert_dac_encoder(sd, model.cfg),
            relevant=lambda k: k.startswith("encoder."),
            reference=lambda _: DACEncoder(model.cfg),
            conv_layout="OIH",
        )
    elif name.startswith("clap-laion"):
        from ..models.htsat import HTSAT
        from .clap import convert_clap_audio

        dry_run_convert(
            name,
            schema,
            lambda sd: convert_clap_audio(sd, model.cfg),
            relevant=_htsat_relevant,
            reference=lambda _: HTSAT(model.cfg, head="laion", projection_dim=512),
        )
    elif name == "clap-2023":
        from ..models.htsat import HTSAT
        from .clap import convert_msclap_audio

        dry_run_convert(
            name,
            schema,
            lambda sd: convert_msclap_audio(sd, model.cfg),
            relevant=_msclap_relevant,
            reference=lambda _: HTSAT(model.cfg, head="msclap", projection_dim=1024),
        )
    elif name.startswith("cdpam"):
        from ..models.cdpam_impl import CdpamEncoder
        from .cdpam import convert_cdpam

        def reference(params):
            # The converter infers the geometry; the module follows it, as
            # load_model applies the stored __config__.
            convs = params["convs"]
            return CdpamEncoder(replace(
                model.cfg,
                channels=tuple(int(c["kernel"].shape[2]) for c in convs),
                kernel_size=int(convs[0]["kernel"].shape[0]),
                emb_dim=int(params["acoustic"]["kernel"].shape[1]),
            ))

        dry_run_convert(
            name,
            schema,
            lambda sd: convert_cdpam(sd)[0],
            relevant=lambda k: k.startswith("base_encoder."),
            reference=reference,
        )
    elif name == "vggish":
        from ..models.vggish import VGGish
        from .vggish import convert_vggish

        dry_run_convert(
            name,
            schema,
            convert_vggish,
            relevant=lambda k: True,
            reference=lambda _: VGGish(),
        )
    else:
        raise SystemExit(
            f"--dry-run supports the non-HF converters (dac-44kHz, clap-laion-*, "
            f"clap-2023, cdpam-*, vggish); {name} converts from local HF trees which are "
            "themselves the schema."
        )
