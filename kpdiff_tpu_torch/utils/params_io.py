"""Load the JAX package's parameter archives into the port's modules.

Two key styles name the same leaves:
  * `jax.tree_util.keystr` paths, as in `artifacts/*_trained_params.npz`:
    `['dynamics']['conv0']['edge_ll']['edge_lin2_w']`;
  * '/'-joined paths under `params/`, as in `tests/golden/*.npz`:
    `params/conv0/edge_ll/edge_lin2_w`.
A nested tree of the same names ({'dynamics': {'conv0': {...}}}, as
`utils/torch_import.py` returns) loads too. All map to the port's dotted
parameter names (`dynamics.conv0.edge_ll.
edge_lin2_w`). The port's modules name their parameters after the flax
leaves and keep flax's (in, out) weight layout, so a leaf copies over
unchanged. Loading raises on any missing, extra or mis-shaped leaf.
`save_keystr_npz` writes the first style, which the JAX package's
`load_params_npz` reads.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Mapping

import numpy as np
import torch

_KEYSTR_PART = re.compile(r"\['([^']*)'\]")


def keystr_to_name(key: str) -> str:
    parts = _KEYSTR_PART.findall(key)
    if not parts or "".join(f"['{p}']" for p in parts) != key:
        raise ValueError(f"not a keystr path: {key!r}")
    return ".".join(parts)


def name_to_keystr(name: str) -> str:
    return "".join(f"['{p}']" for p in name.split("."))


def save_keystr_npz(flat: Mapping[str, np.ndarray], path: str | Path) -> None:
    """{dotted name: array} -> compressed npz keyed by keystr paths."""
    np.savez_compressed(path, **{name_to_keystr(n): np.asarray(v) for n, v in flat.items()})


def read_keystr_npz(path: str | Path) -> Dict[str, np.ndarray]:
    """{dotted name: array} from a keystr-keyed npz (artifacts/*.npz)."""
    with np.load(path) as z:
        return {keystr_to_name(k): z[k] for k in z.files}


def read_golden_params(npz: Mapping[str, np.ndarray], prefix: str = "") -> Dict[str, np.ndarray]:
    """{dotted name: array} from the `params/a/b/c` leaves of a golden case;
    `prefix` ('dynamics', 'encoder') is prepended to every name."""
    out = {}
    for k in npz.keys():
        if k.startswith("params/"):
            name = k[len("params/"):].replace("/", ".")
            out[f"{prefix}.{name}" if prefix else name] = np.asarray(npz[k])
    return out


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """{dotted name: leaf} of a nested mapping (leaves are arrays)."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, name))
        else:
            out[name] = v
    return out


def load_params(module: torch.nn.Module, flat: Mapping) -> None:
    """Copy every leaf of `flat` ({dotted name: array}, or a nested tree of
    those names) into `module`'s parameters of the same name.

    Raises KeyError on a missing or extra leaf, ValueError on a shape
    mismatch; nothing is copied unless every leaf matches."""
    flat = flatten_tree(flat)
    params = dict(module.named_parameters())
    missing = sorted(set(params) - set(flat))
    extra = sorted(set(flat) - set(params))
    if missing or extra:
        raise KeyError(f"parameter mismatch: missing {missing[:8]} ({len(missing)}), "
                       f"extra {extra[:8]} ({len(extra)})")
    for name, p in params.items():
        if tuple(flat[name].shape) != tuple(p.shape):
            raise ValueError(f"{name}: stored {tuple(flat[name].shape)} != module {tuple(p.shape)}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(torch.from_numpy(np.array(flat[name], np.float32)))


def export_flat(module: torch.nn.Module) -> Dict[str, np.ndarray]:
    """{dotted name: numpy array} of `module`'s parameters."""
    return {n: p.detach().cpu().numpy() for n, p in module.named_parameters()}
