"""Checkpoint key/shape manifests: the release artifacts' exact layout.

Counterpart of ``tools/ckpt_manifest.py``, kept as the port's own copy
(the port imports nothing of ``tools``).  A manifest records the key ->
shape/dtype layout of one released checkpoint, so that

* the port's loaders are tested against manifest-shaped synthetic state
  dicts (``tests/test_torch_ckpt_manifests.py``): a real-weight run can
  only fail on values, never on structure;
* :mod:`avlmaps_torch.tools.port_checkpoints` diffs a real checkpoint
  against its manifest before porting and reports drift (missing,
  unexpected or mis-shaped keys) instead of a loader's ``KeyError``.

Spec strings, one a key: ``"f32[1024,3,16,16]"`` is a dtype tag and a
bracketed shape; ``"?i64[]"`` marks a key optional (present in some
builds of the artifact, e.g. BatchNorm ``num_batches_tracked``).  The
manifests are data, read in place from the repository's
``tools/ckpt_manifests/*.json``; ``record_manifest`` pins one from a real
file.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np

MANIFEST_DIR = Path(__file__).resolve().parents[2] / "tools" / "ckpt_manifests"

_DTYPES = {"f32": np.float32, "f16": np.float16, "i64": np.int64,
           "i32": np.int32, "u8": np.uint8, "bool": np.bool_}
_TAGS = {v: k for k, v in _DTYPES.items()}
_SPEC_RE = re.compile(r"^(\?)?([a-z0-9]+)\[([0-9,]*)\]$")


def spec_of(shape, dtype, optional: bool = False) -> str:
    body = ",".join(str(int(d)) for d in shape)
    return ("?" if optional else "") + f"{_TAGS[np.dtype(dtype).type]}[{body}]"


def parse_spec(spec: str) -> Tuple[Tuple[int, ...], Any, bool]:
    """``'?f32[2,3]'`` -> ``((2, 3), np.float32, True)``."""
    m = _SPEC_RE.match(spec)
    if not m:
        raise ValueError(f"bad manifest spec: {spec!r}")
    opt, tag, body = m.groups()
    shape = tuple(int(d) for d in body.split(",")) if body else ()
    return shape, _DTYPES[tag], bool(opt)


def load_manifest(name_or_path) -> Dict[str, Any]:
    """A manifest by name (``"superpoint_v1"``, from :data:`MANIFEST_DIR`)
    or by path."""
    p = Path(name_or_path)
    if not p.suffix:
        p = MANIFEST_DIR / f"{p.name}.json"
    return json.loads(p.read_text())


def save_manifest(manifest: Dict[str, Any], path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(manifest, indent=1, sort_keys=False) + "\n")


def _shape(v) -> Tuple[int, ...]:
    return tuple(int(d) for d in (v.shape if hasattr(v, "shape")
                                  else np.shape(v)))


def diff_state_dict(sd: Dict[str, Any],
                    manifest: Dict[str, Any]) -> Dict[str, list]:
    """A loaded state dict against a manifest: ``{"missing": [key...],
    "unexpected": [key...], "mismatched": [(key, got, want)...]}``, all
    empty when the artifact keeps the contract.  dtypes are not compared
    (fp16 and fp32 releases of one artifact both port)."""
    keys = manifest["keys"]
    missing, mismatched = [], []
    for k, spec in keys.items():
        shape, _, optional = parse_spec(spec)
        if k not in sd:
            if not optional:
                missing.append(k)
            continue
        got = _shape(sd[k])
        if got != shape:
            mismatched.append((k, got, shape))
    unexpected = sorted(set(map(str, sd)) - set(keys))
    return {"missing": missing, "unexpected": unexpected,
            "mismatched": mismatched}


def synthesize_state_dict(manifest: Dict[str, Any], seed: int = 0,
                          include_optional: bool = True,
                          scale: float = 0.05) -> Dict[str, np.ndarray]:
    """A random numpy state dict shaped exactly as the manifest says,
    drawn as ``tools/ckpt_manifest.py`` draws it (the same seed gives the
    same arrays).  Small values keep BatchNorm folds and norms sane;
    variances are positive."""
    rng = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}
    for k, spec in manifest["keys"].items():
        shape, dtype, optional = parse_spec(spec)
        if optional and not include_optional:
            continue
        if np.issubdtype(dtype, np.floating):
            val = rng.normal(size=shape).astype(dtype) * dtype(scale)
            if k.endswith("running_var") or ".bn" in k and k.endswith("var"):
                val = np.abs(val) + dtype(0.5)
        else:
            val = np.zeros(shape, dtype)
        sd[k] = val
    return sd


def assemble_netvlad_mat(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """The nested matconvnet ``net`` struct from a flat manifest-shaped
    state dict (keys ``layers.<idx>_<name>.weights.<j>`` and
    ``meta.normalization.averageImage``), for ``scipy.io.savemat``: the
    NetVLAD loader's real input path without the 400 MB release file."""
    layers: Dict[int, Dict[str, Any]] = {}
    avg = None
    for k, v in sd.items():
        if k == "meta.normalization.averageImage":
            avg = v
            continue
        head, _, j = k.split(".", 1)[1].rsplit(".", 2)
        idx, name = head.split("_", 1)
        entry = layers.setdefault(int(idx), {"name": name, "weights": {}})
        entry["weights"][int(j)] = v
    layer_arr = np.empty(len(layers), dtype=object)
    for i, idx in enumerate(sorted(layers)):
        w = layers[idx]["weights"]
        weights = np.empty(len(w), dtype=object)
        for j in sorted(w):
            weights[j] = w[j]
        layer_arr[i] = {"name": layers[idx]["name"], "weights": weights}
    net: Dict[str, Any] = {"layers": layer_arr}
    if avg is not None:
        net["meta"] = {"normalization": {"averageImage": avg}}
    return {"net": net}


def record_manifest(sd: Dict[str, Any], artifact: str, source: str,
                    container: str) -> Dict[str, Any]:
    """Pin a manifest from a real loaded state dict (it supersedes the
    derived enumeration; ``port_checkpoints --record-manifests``)."""
    keys = {}
    for k, v in sd.items():
        arr = v.detach().cpu().numpy() if hasattr(v, "detach") else \
            np.asarray(v)
        dt = arr.dtype.type
        if dt not in _TAGS:
            dt = np.int64 if np.issubdtype(arr.dtype, np.integer) \
                else np.float32
        keys[str(k)] = spec_of(arr.shape, dt)
    return {"artifact": artifact, "source": source, "container": container,
            "derived_from": "recorded from a real downloaded file",
            "keys": keys}


def format_diff(diff: Dict[str, list], limit: int = 8) -> str:
    parts = []
    for kind in ("missing", "unexpected"):
        if diff[kind]:
            more = (f" (+{len(diff[kind]) - limit} more)"
                    if len(diff[kind]) > limit else "")
            parts.append(f"{kind}: {', '.join(diff[kind][:limit])}{more}")
    if diff["mismatched"]:
        shown = "; ".join(f"{k}: got {g} want {w}"
                          for k, g, w in diff["mismatched"][:limit])
        parts.append(f"mismatched: {shown}")
    return "\n  ".join(parts) if parts else "OK (matches manifest)"
