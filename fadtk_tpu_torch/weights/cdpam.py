"""Checkpoint -> parameter tree conversion for the CDPAM base_encoder.

The port of ``fadtk_tpu/weights/cdpam.py``, line for line: the tree is the JAX
package's, saved as the same flat ``.npz`` (``store.save_params``), so one
conversion serves both packages.

The upstream checkpoint is the cdpam pip package's ``scratch_loss_*.pth``
(pranaymanocha/PerceptualAudio), saved as ``{'state': state_dict}`` of the
FINnet module whose ``base_encoder`` submodule the reference invokes
(fadtk/model_loader.py:443). The reference uses ONLY base_encoder; the
contrastive projection / classifier heads of FINnet are dropped here.

Because no checkpoint is available offline, the converter is deliberately
schema-driven rather than hard-coded:

- conv / batch-norm layers are discovered by numeric index from any key
  pattern ``<stack>.<i>.<param>`` whose tensor looks like a Conv1d weight
  (3-D) or a BatchNorm1d running-stat set;
- the layer geometry (channel widths, kernel size, head dims) is INFERRED
  from the discovered shapes and returned as config metadata (stored as
  ``__config__`` in the .npz), so the runtime adapts to whatever the real
  checkpoint contains;
- acoustic/content heads are matched by name substring first, falling back
  to declaration order with a loud warning;
- every base_encoder key must be consumed or explicitly ignored — leftover
  keys raise, so silent key drift is impossible (the `convert_cli
  --dry-run` contract).
"""

from __future__ import annotations

import re

import numpy as np

from ..utils import log

# Keys that carry no inference-time information.
_IGNORED = ("num_batches_tracked",)


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def extract_base_encoder(state_dict) -> dict:
    """Unwrap {'state': sd} / {'state_dict': sd} / {'model': sd} and keep the
    base_encoder.* subtree (prefix-stripped)."""
    sd = state_dict
    if isinstance(sd, dict):
        for wrap in ("state", "state_dict", "model"):
            inner = sd.get(wrap)
            if isinstance(inner, dict) and any(
                hasattr(v, "shape") or isinstance(v, np.ndarray)
                for v in inner.values()
            ):
                sd = inner
                break
    base = {k[len("base_encoder."):]: v for k, v in sd.items()
            if k.startswith("base_encoder.")}
    return base if base else dict(sd)


def convert_cdpam(state_dict) -> tuple[dict, dict]:
    """Returns (params pytree, inferred config kwargs for CdpamConfig)."""
    sd = {k: _np(v) for k, v in extract_base_encoder(state_dict).items()
          if not k.endswith(_IGNORED)}
    consumed = set()

    # --- discover indexed conv stacks: <name>.<i>.weight with 3-D tensors ---
    conv_w: dict[int, str] = {}
    for k, v in sd.items():
        m = re.fullmatch(r"(.+?)\.(\d+)\.weight", k)
        if m and v.ndim == 3:
            conv_w[int(m.group(2))] = k
    if not conv_w:
        raise ValueError(
            "No Conv1d layers found: expected '<stack>.<i>.weight' 3-D tensors "
            f"in the base_encoder subtree; keys present: {sorted(sd)[:10]}..."
        )

    convs, norm_groups = [], []
    for i in sorted(conv_w):
        wkey = conv_w[i]
        stack = wkey.rsplit(".", 2)[0]
        w = sd[wkey]  # torch Conv1d: (out, in, k)
        bkey = f"{stack}.{i}.bias"
        convs.append(
            {
                "kernel": w.transpose(2, 1, 0),  # -> (k, in, out) for WIO
                "bias": sd[bkey] if bkey in sd else np.zeros(w.shape[0], np.float32),
            }
        )
        consumed.add(wkey)
        if bkey in sd:
            consumed.add(bkey)

        # matching batch-norm: same index in any other stack with 1-D params
        # of this conv's out-width and running stats present.
        group = None
        for k2, v2 in sd.items():
            m2 = re.fullmatch(r"(.+?)\.(%d)\.running_mean" % i, k2)
            if m2 and v2.shape == (w.shape[0],):
                nstack = m2.group(1)
                group = {
                    "scale": sd.get(f"{nstack}.{i}.weight",
                                    np.ones(w.shape[0], np.float32)),
                    "bias": sd.get(f"{nstack}.{i}.bias",
                                   np.zeros(w.shape[0], np.float32)),
                    "mean": sd[f"{nstack}.{i}.running_mean"],
                    "var": sd[f"{nstack}.{i}.running_var"],
                }
                for suffix in ("weight", "bias", "running_mean", "running_var"):
                    consumed.add(f"{nstack}.{i}.{suffix}")
                break
        if group is None:
            log.warning(
                f"cdpam: conv layer {i} has no matching BatchNorm running "
                "stats; converting as identity normalization."
            )
            group = {
                "scale": np.ones(w.shape[0], np.float32),
                "bias": np.zeros(w.shape[0], np.float32),
                "mean": np.zeros(w.shape[0], np.float32),
                "var": np.ones(w.shape[0], np.float32),
            }
        norm_groups.append(group)

    # --- heads: remaining 2-D weights -------------------------------------
    c_last = convs[-1]["kernel"].shape[2]
    head_keys = [
        k for k, v in sd.items()
        if k not in consumed and k.endswith(".weight") and v.ndim == 2
        and v.shape[1] == c_last
    ]
    if len(head_keys) < 2:
        raise ValueError(
            f"Expected >= 2 linear heads of input width {c_last}; "
            f"found {head_keys}. Unconsumed keys: "
            f"{sorted(set(sd) - consumed)[:20]}"
        )

    def pick(substrings):
        for k in head_keys:
            if any(s in k.lower() for s in substrings):
                return k
        return None

    ak, ck = pick(("acoust",)), pick(("content", "sem"))
    if ak is None or ck is None:
        head_keys.sort()
        ak, ck = head_keys[0], head_keys[1]
        log.warning(
            "cdpam: head names carry no acoustic/content hint; assigning by "
            f"sorted order acoustic={ak!r} content={ck!r}. VERIFY against the "
            "upstream module definition before trusting scores."
        )

    def head(wkey):
        w = sd[wkey]
        bkey = wkey[: -len(".weight")] + ".bias"
        consumed.add(wkey)
        if bkey in sd:
            consumed.add(bkey)
        return {
            "kernel": w.T,  # torch Linear (out, in) -> (in, out)
            "bias": sd.get(bkey, np.zeros(w.shape[0], np.float32)),
        }

    params = {
        "convs": convs,
        "norms": norm_groups,
        "acoustic": head(ak),
        "content": head(ck),
    }

    leftovers = sorted(set(sd) - consumed)
    if leftovers:
        raise ValueError(
            "cdpam converter did not consume every base_encoder key - refusing "
            f"to silently drop weights. Leftover keys: {leftovers}"
        )

    cfg_kwargs = dict(
        channels=tuple(int(c["kernel"].shape[2]) for c in convs),
        kernel_size=int(convs[0]["kernel"].shape[0]),
        emb_dim=int(params["acoustic"]["kernel"].shape[1]),
    )
    return params, cfg_kwargs
