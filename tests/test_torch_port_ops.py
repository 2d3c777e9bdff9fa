"""kpdiff_tpu_torch ops against kpdiff_tpu: noise schedule tables and
transition algebra, masked geometry, and neighbor structures compared as
edge sets under their masks (torch.topk and lax.top_k may order ties
differently). f32 tolerances: rtol 1e-6 / atol 1e-6 unless stated."""
import jax.numpy as jnp
import numpy as np
import pytest

from kpdiff_tpu.ops import geometry as jgeo, neighbors as jnb, schedule as jsch
from kpdiff_tpu_torch.ops import geometry as tgeo, neighbors as tnb, schedule as tsch
from torch_port_util import assert_close, t


@pytest.mark.parametrize("name,T,prec", [("polynomial_2", 1000, 1e-5), ("polynomial_3", 50, 1e-4),
                                          ("cosine", 100, 1e-4)])
def test_schedule_tables_and_transitions(name, T, prec):
    js = jsch.NoiseSchedule.create(name, T, prec)
    ts = tsch.NoiseSchedule.create(name, T, prec)
    np.testing.assert_array_equal(ts.gamma_table, js.gamma_table)
    tt = np.linspace(0, 1, 9).astype(np.float32)
    np.testing.assert_array_equal(ts.gamma(t(tt)).numpy(), np.asarray(js.gamma(jnp.asarray(tt))))
    g_t = np.asarray(js.gamma(jnp.asarray(tt[1:])))
    g_s = np.asarray(js.gamma(jnp.asarray(tt[:-1])))
    for a, b in zip(tsch.sigma_and_alpha_t_given_s(t(g_t), t(g_s)),
                    jsch.sigma_and_alpha_t_given_s(jnp.asarray(g_t), jnp.asarray(g_s))):
        assert_close(a, b, rtol=1e-6, atol=1e-7)
    assert_close(tsch.sigma_from_gamma(t(g_t)), jsch.sigma_from_gamma(jnp.asarray(g_t)), 1e-6, 1e-7)
    assert_close(tsch.alpha_from_gamma(t(g_t)), jsch.alpha_from_gamma(jnp.asarray(g_t)), 1e-6, 1e-7)


def test_geometry():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 7, 3)).astype(np.float32)
    m = rng.random((3, 7)) < 0.6
    m[2] = False  # an empty row averages to 0
    assert_close(tgeo.masked_com(t(x), t(m)), jgeo.masked_com(jnp.asarray(x), jnp.asarray(m)), 1e-6, 1e-6)
    assert_close(tgeo.masked_mean(t(x), t(m), dim=1, keepdim=True),
                 jgeo.masked_mean(jnp.asarray(x), jnp.asarray(m), axis=1, keepdims=True), 1e-6, 1e-6)
    assert_close(tgeo.norm_no_nan(t(x)), jgeo.norm_no_nan(jnp.asarray(x)), 1e-6, 1e-6)


def _points(seed, b=3, ns=14, nd=9):
    rng = np.random.default_rng(seed)
    xs = (rng.normal(size=(b, ns, 3)) * 3).astype(np.float32)
    xd = (rng.normal(size=(b, nd, 3)) * 3).astype(np.float32)
    ms = rng.random((b, ns)) < 0.8
    md = rng.random((b, nd)) < 0.8
    return xs, ms, xd, md


def _edge_set(idx, valid):
    idx, valid = np.asarray(idx), np.asarray(valid)
    return {(b, d, int(idx[b, d, j])) for b, d, j in zip(*np.nonzero(valid))}


@pytest.mark.parametrize("exclude_self", [False, True])
def test_dense_radius_adjacency(exclude_self):
    xs, ms, _, _ = _points(1)
    got = tnb.dense_radius_adjacency(t(xs), t(ms), t(xs), t(ms), 4.0, exclude_self=exclude_self)
    want = jnb.dense_radius_adjacency(jnp.asarray(xs), jnp.asarray(ms), jnp.asarray(xs), jnp.asarray(ms), 4.0,
                                      exclude_self=exclude_self)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert_close(tnb.masked_pair_dist2(t(xs), t(ms), t(xs), t(ms)),
                 jnb.masked_pair_dist2(jnp.asarray(xs), jnp.asarray(ms), jnp.asarray(xs), jnp.asarray(ms)),
                 1e-6, 1e-5)


@pytest.mark.parametrize("k", [3, 20])
def test_knn_indices_edge_sets(k):
    xs, ms, xd, md = _points(2)
    ti, tdist, tv = tnb.knn_indices(t(xs), t(ms), t(xd), t(md), k)
    ji, jdist, jv = jnb.knn_indices(*map(jnp.asarray, (xs, ms, xd, md)), k)
    assert _edge_set(ti, tv) == _edge_set(ji, jv)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert_close(tdist * tv, np.asarray(jdist) * np.asarray(jv), 1e-6, 1e-5)


@pytest.mark.parametrize("cap,exclude_self", [(4, True), (32, True), (6, False)])
def test_radius_neighbor_list_edge_sets(cap, exclude_self):
    xs, ms, _, _ = _points(3, ns=20)
    ti, tv = tnb.radius_neighbor_list(t(xs), t(ms), t(xs), t(ms), 3.5, cap, exclude_self=exclude_self)
    ji, jv = jnb.radius_neighbor_list(*map(jnp.asarray, (xs, ms, xs, ms)), 3.5, cap, exclude_self=exclude_self)
    assert _edge_set(ti, tv) == _edge_set(ji, jv)
