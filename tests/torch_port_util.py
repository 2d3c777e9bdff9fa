"""Shared helpers of the tests that hold kpdiff_tpu_torch against kpdiff_tpu:
parameters cross from a JAX init tree to the port as numpy arrays keyed by
dotted paths, inputs come from numpy seeds."""
from __future__ import annotations

import jax
import numpy as np
import torch

from kpdiff_tpu_torch.utils.params_io import load_params


def jax_flat(params, prefix: str = "") -> dict:
    """{dotted path: numpy array} of a JAX param tree (a 'params' level dropped)."""
    if isinstance(params, dict) and set(params) == {"params"}:
        params = params["params"]
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        name = ".".join(str(getattr(p, "key", p)) for p in path)
        out[f"{prefix}.{name}" if prefix else name] = np.asarray(leaf, np.float32)
    return out


def load_from_jax(module: torch.nn.Module, params, prefix: str = "") -> torch.nn.Module:
    load_params(module, jax_flat(params, prefix))
    return module


def t(a, dtype=None):
    """numpy / JAX array -> CPU tensor."""
    x = torch.from_numpy(np.array(a))
    return x if dtype is None else x.to(dtype)


def assert_close(got, want, rtol, atol, msg=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol, atol=atol, err_msg=msg)


def assert_rel_max(got, want, tol, msg=""):
    """max|got - want| <= tol * max|want| (the bf16 comparisons)."""
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    scale = max(np.abs(want).max(), 1e-30)
    assert err <= tol * scale, f"{msg}: max abs err {err:.3e} > {tol} * {scale:.3e}"
