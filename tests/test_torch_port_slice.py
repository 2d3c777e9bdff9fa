"""The port's slice end to end against kpdiff_tpu on the CPU: encode ->
compact_kk -> sample on a reduced egnn_40kp config with the same injected
noise in both packages (full chain, strided grid, eta=0, frames, a
neighbor-list kk), in bf16 against the JAX sampler's Pallas path, and on
the trained flagship weights.

Tolerances: f32 rtol 1e-4, atol 1e-4; bf16: max abs error at most 2e-2 of
the output's max abs value; trained flagship: at most 1e-4 of it.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kpdiff_tpu.config import load_config as jload, model_from_config as jmodel
from kpdiff_tpu.models.complex import synthetic_batch as jsyn
from kpdiff_tpu_torch.config import model_from_config as tmodel
from kpdiff_tpu_torch.models.complex import synthetic_batch as tsyn
from kpdiff_tpu_torch.utils.params_io import export_flat, load_params, read_keystr_npz
from torch_port_util import assert_close, assert_rel_max

ROOT = Path(__file__).resolve().parents[1]
SYN = dict(batch=3, n_rec_pad=40, n_lig_pad=12, n_kp=6, kp_feat_dim=12, n_ip_pad=8, min_rec=30, min_lig=6)


def reduced_config(dtype="float32", T=8):
    cfg = jload(ROOT / "configs/egnn_40kp.yml")
    cfg["dynamics"].update(n_layers=2, hidden_nf=16, compute_dtype=dtype)
    cfg["rec_encoder"].update(n_convs=2, hidden_n_node_feat=16, out_n_node_feat=12, compute_dtype=dtype)
    cfg["graph"]["n_keypoints"] = 6
    cfg["diffusion"]["n_timesteps"] = T
    return cfg


def _models(cfg, pallas=False):
    """JAX and port models with the same weights: the port's seeded init,
    carried into a JAX param tree by name."""
    if pallas:
        cfg = {**cfg, "dynamics": {**cfg["dynamics"], "use_pallas_sampling": True}}
    tm = tmodel(cfg, device="cpu")
    return jmodel(cfg), jax_params(export_flat(tm)), tm


def jax_params(flat):
    """{dotted name: array} -> nested dict of jnp arrays (the flax param tree)."""
    params = {}
    for name, v in flat.items():
        node = params
        *parents, leaf = name.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(v)
    return params


def _noise(seed, steps, B=3, N=12, F=10):
    rng = np.random.default_rng(seed)
    return dict(init_x=rng.normal(size=(B, N, 3)), init_h=rng.normal(size=(B, N, F)),
                steps_x=rng.normal(size=(steps, B, N, 3)), steps_h=rng.normal(size=(steps, B, N, F)))


def _cmp(got, want, dtype, keys=("lig_x", "lig_h")):
    for k in keys:
        if dtype == "float32":
            assert_close(got[k], want[k], rtol=1e-4, atol=1e-4, msg=k)
        else:
            assert_rel_max(got[k], want[k], 2e-2, msg=k)


@pytest.fixture(scope="module")
def f32_slice():
    jm, params, tm = _models(reduced_config())
    jenc, jkk = jm.encode(params, jsyn(0, **SYN))
    tenc, tkk = tm.encode(tsyn(0, **SYN))
    return jm, params, tm, jenc, jkk, tenc, tkk


def test_encode_and_kk_edges(f32_slice):
    jm, params, tm, jenc, jkk, tenc, tkk = f32_slice
    assert_close(tenc.kp_x, jenc.kp_x, rtol=1e-4, atol=1e-5)
    assert_close(tenc.kp_h, jenc.kp_h, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(tkk.numpy(), np.asarray(jkk))


@pytest.mark.parametrize("align", [8, 1])
def test_compact_kk(f32_slice, align):
    """Dense stays dense when the cap reaches K; a small align gives the
    same edge set as a capped neighbor list."""
    jm, params, tm, jenc, jkk, tenc, tkk = f32_slice
    jc = jm.compact_kk(jenc, jkk, align=align)
    tc = tm.compact_kk(tenc, tkk, align=align)
    assert isinstance(tc, tuple) == isinstance(jc, tuple)
    if not isinstance(tc, tuple):
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        return
    assert tc[0].shape == jc[0].shape
    edges = lambda idx, v: {(b, d, int(idx[b, d, j])) for b, d, j in zip(*np.nonzero(np.asarray(v)))}
    assert edges(tc[0].numpy(), tc[1].numpy()) == edges(np.asarray(jc[0]), np.asarray(jc[1]))
    dense = {(b, d, s) for b, s, d in zip(*np.nonzero(np.asarray(jkk)))}
    assert edges(tc[0].numpy(), tc[1].numpy()) == dense


@pytest.mark.parametrize("mode", ["full", "strided", "ddim_eta0", "frames", "nbr_kk"])
def test_sample_matches_jax(f32_slice, mode):
    jm, params, tm, jenc, jkk, tenc, tkk = f32_slice
    kw, steps = {}, 8
    if mode == "strided":
        kw, steps = dict(sample_steps=4), 4
    elif mode == "ddim_eta0":
        kw, steps = dict(sample_steps=4, eta=0.0), 4
    elif mode == "frames":
        kw = dict(return_every=3)
    if mode == "nbr_kk":
        jkk, tkk = jm.compact_kk(jenc, jkk, align=1), tm.compact_kk(tenc, tkk, align=1)
        assert isinstance(tkk, tuple)
    noise = _noise(1, steps)
    want = jm.sample(params, jax.random.key(0), jenc, jkk, noise={k: jnp.asarray(v, jnp.float32)
                                                                   for k, v in noise.items()}, **kw)
    got = tm.sample(tenc, tkk, noise=noise, **kw)
    _cmp(got, want, "float32", ("lig_x", "lig_h", "kp_x") + (("frames_x", "frames_h") if mode == "frames" else ()))
    np.testing.assert_array_equal(got["lig_mask"].numpy(), np.asarray(want["lig_mask"]))


def test_sample_bf16_matches_jax_pallas():
    """bf16 pair MLPs; the JAX side samples through its Pallas kernel
    (use_pallas_sampling, interpret mode), the port through the plain
    version of its CUDA kernel."""
    jm, params, tm = _models(reduced_config("bfloat16", T=2), pallas=True)
    jenc, jkk = jm.encode(params, jsyn(0, **SYN))
    tenc, tkk = tm.encode(tsyn(0, **SYN))
    noise = _noise(2, 2)
    want = jm.sample(params, jax.random.key(0), jenc, jkk, noise={k: jnp.asarray(v, jnp.float32)
                                                                   for k, v in noise.items()})
    got = tm.sample(tenc, tkk, noise=noise)
    _cmp(got, want, "bfloat16")


def test_trained_flagship_matches_jax():
    """Trained egnn_40kp weights at full width and depth (compute dtype set
    to f32 for a tight check), bucket 16, one strided step on injected
    noise; max abs error at most 1e-4 of the output's max abs value."""
    cfg = jload(ROOT / "configs/egnn_40kp.yml")
    cfg["dynamics"]["compute_dtype"] = cfg["rec_encoder"]["compute_dtype"] = "float32"
    syn = dict(batch=1, n_rec_pad=384, n_lig_pad=16, n_kp=40, kp_feat_dim=128, n_ip_pad=64, min_rec=260, min_lig=14)
    flat = read_keystr_npz(ROOT / "artifacts/egnn_40kp_trained_params.npz")
    jm, params = jmodel(cfg), jax_params(flat)
    tm = tmodel(cfg, device="cpu")
    load_params(tm, flat)
    jenc, jkk = jm.encode(params, jsyn(0, **syn))
    tenc, tkk = tm.encode(tsyn(0, **syn))
    assert_close(tenc.kp_x, jenc.kp_x, rtol=1e-4, atol=1e-4)
    jkk, tkk = jm.compact_kk(jenc, jkk), tm.compact_kk(tenc, tkk)
    assert isinstance(tkk, tuple) == isinstance(jkk, tuple)
    noise = _noise(4, 1, B=1, N=16)
    want = jm.sample(params, jax.random.key(0), jenc, jkk, sample_steps=1,
                     noise={k: jnp.asarray(v, jnp.float32) for k, v in noise.items()})
    got = tm.sample(tenc, tkk, sample_steps=1, noise=noise)
    for k in ("lig_x", "lig_h"):  # width 257, six layers: f32 sums of ~20-sized values
        assert_rel_max(got[k], want[k], 1e-4, msg=k)
