"""kpdiff_tpu_torch EGNN edge modules against kpdiff_tpu on the CPU.

EGNNEdge's dense form in the port runs the plain version of the CUDA edge
kernel here (a CPU tensor); it is held against the JAX module with
use_pallas=True (the Pallas kernel in interpret mode, as
tests/test_pallas_egnn.py runs it) and with use_pallas=False (the XLA path).
Tolerances: f32 rtol 1e-4, atol 1e-5. bf16: max abs error at most 2e-2 of
the output's max abs value, because the two frameworks round bf16
intermediates at different places and sum in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kpdiff_tpu.models import egnn as jegnn
from kpdiff_tpu_torch.models import egnn as tegnn
from kpdiff_tpu_torch.ops.cuda import egnn_edge
from kpdiff_tpu_torch.ops.neighbors import dense_knn_adjacency, knn_indices
from torch_port_util import assert_close, assert_rel_max, jax_flat, load_from_jax, t

F32 = dict(rtol=1e-4, atol=1e-5)
BF16_REL = 2e-2


def _dense_inputs(seed=0, B=3, Ns=12, Nd=10, F=32):
    rng = np.random.default_rng(seed)
    h_src = rng.normal(size=(B, Ns, F)).astype(np.float32)
    h_dst = rng.normal(size=(B, Nd, F)).astype(np.float32)
    x_src = (rng.normal(size=(B, Ns, 3)) * 3).astype(np.float32)
    x_dst = (rng.normal(size=(B, Nd, 3)) * 3).astype(np.float32)
    adj = rng.random((B, Ns, Nd)) < 0.4
    return h_src, h_dst, x_src, x_dst, adj


def _check(got, want, dtype, msg):
    for g, w, part in zip(got, want, ("agg_h", "agg_x")):
        if dtype == "float32":
            assert_close(g, w, msg=f"{msg} {part}", **F32)
        else:
            assert_rel_max(g, w, BF16_REL, msg=f"{msg} {part}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_dense_kernel_path_matches_jax(dtype, use_pallas):
    """The kernel's plain version against the Pallas kernel (interpret) and the XLA path."""
    inputs = _dense_inputs()
    F = inputs[0].shape[-1]
    kw = dict(hidden_size=F, use_tanh=True, coords_range=10.0, coord_hidden_layers=2, dtype=dtype)
    jmod = jegnn.EGNNEdgeDense(**kw, use_pallas=use_pallas)
    jin = [jnp.asarray(a) for a in inputs]
    params = jmod.init(jax.random.key(0), *jin)
    want = jmod.apply(params, *jin)
    tmod = load_from_jax(tegnn.EGNNEdge(F, F, torch.Generator().manual_seed(0), use_tanh=True,
                                        coords_range=10.0, dtype=dtype), params)
    before = egnn_edge.launches
    with torch.no_grad():
        got = tmod(*[t(a) for a in inputs])
    assert egnn_edge.launches == before  # CPU tensors: the plain version, no launch
    _check(got, want, dtype, f"pallas={use_pallas}")


def test_kernel_wrapper_rejects_unsupported_dtype():
    args = [torch.zeros(1)] * 16
    with pytest.raises(TypeError):
        egnn_edge.egnn_edge_dense(*args, use_tanh=True, coords_range=10.0, compute_dtype=torch.float16)


def test_kernel_wrapper_takes_only_padded_weights():
    """W2 comes packed by `pack_w2` in the compute dtype (its main block
    zero padded to the kernel's tile, as the module hands it over); a raw
    (H, H) W2 or one packed in another dtype is refused."""
    rng = np.random.default_rng(3)
    b, n, h = 2, 5, 20
    a = [t(rng.normal(size=(b, n, h)).astype(np.float32)) for _ in range(4)]
    v = [t(rng.normal(size=h).astype(np.float32)) for _ in range(6)]
    w2e, w2c = (t(rng.normal(size=(h, h)).astype(np.float32) / 5) for _ in range(2))
    x = t(rng.normal(size=(b, n, 3)).astype(np.float32))
    adj = t(rng.random((b, n, n)) < 0.5)
    atb = torch.zeros(1)
    kw = dict(use_tanh=True, coords_range=10.0, compute_dtype=torch.float32)

    def call(we, wc):
        return egnn_edge.egnn_edge_dense(*a, v[0], v[1], we, v[2], v[3], atb, wc, v[4], v[5], x, x, adj, **kw)

    agg_h, agg_x = call(egnn_edge.pack_w2(w2e, torch.float32), egnn_edge.pack_w2(w2c, torch.float32))
    assert agg_h.shape == (b, n, h) and agg_x.shape == (b, n, 3)
    with pytest.raises(ValueError):
        call(w2e, egnn_edge.pack_w2(w2c, torch.float32))
    with pytest.raises(TypeError):
        call(egnn_edge.pack_w2(w2e, torch.bfloat16), egnn_edge.pack_w2(w2c, torch.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("anchor_is_src", [True, False])
def test_knn_pairs_matches_jax(anchor_is_src, dtype):
    rng = np.random.default_rng(2)
    B, K, N, k, F = 2, 6, 9, 3, 24
    h_a = rng.normal(size=(B, K, F)).astype(np.float32)
    h_o = rng.normal(size=(B, N, F)).astype(np.float32)
    x_a = (rng.normal(size=(B, K, 3)) * 2).astype(np.float32)
    x_o = (rng.normal(size=(B, N, 3)) * 2).astype(np.float32)
    idx = np.stack([np.stack([rng.choice(N, k, replace=False) for _ in range(K)]) for _ in range(B)]).astype(np.int32)
    valid = rng.random((B, K, k)) < 0.8
    jmod = jegnn.EGNNEdgeKNNPairs(hidden_size=F, anchor_is_src=anchor_is_src, use_tanh=True, dtype=dtype)
    jin = [jnp.asarray(a) for a in (h_a, h_o, x_a, x_o, idx, valid)]
    params = jmod.init(jax.random.key(2), *jin)
    want = jmod.apply(params, *jin)
    tmod = load_from_jax(tegnn.EGNNEdge(F, F, torch.Generator(), use_tanh=True, dtype=dtype), params)
    with torch.no_grad():
        got = tmod.pairs(t(h_a), t(h_o), t(x_a), t(x_o), t(idx, torch.int64), t(valid), anchor_is_src=anchor_is_src)
    _check(got, want, dtype, f"anchor_is_src={anchor_is_src}")


def _kl_case(case, B=2, K=8, N=9, F=24, seed=9):
    """Keypoint and ligand inputs of the kNN kl / lk edges with their masks."""
    rng = np.random.default_rng(seed)
    h_kp, h_lig = (t(rng.normal(size=(B, n, F)).astype(np.float32)) for n in (K, N))
    x_kp, x_lig = (t((rng.normal(size=(B, n, 3)) * 2).astype(np.float32)) for n in (K, N))
    kp_mask, lig_mask = torch.ones(B, K, dtype=torch.bool), torch.ones(B, N, dtype=torch.bool)
    if case in ("kp_masked", "kp_shard"):
        kp_mask[0, 5:] = False
        kp_mask[1, :2] = False
    if case == "few_ligand_atoms":
        lig_mask[0, 2:] = False  # 2 valid atoms, kl_k 3
        lig_mask[1, 4:] = False
    return h_kp, h_lig, x_kp, x_lig, kp_mask, lig_mask


@pytest.mark.parametrize("case", ["all_valid", "kp_masked", "few_ligand_atoms", "kp_shard"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("anchor_is_src", [True, False], ids=["kl", "lk"])
def test_knn_mask_route_matches_the_pair_list(anchor_is_src, dtype, case):
    """The kNN edge set as a dense mask through the kernel's entry
    (`kernel`: its plain version on the CPU) against
    EGNNEdge.pairs over the pair list on the same parameters: f32 within
    1e-5; bf16 against the pair list in f32 within 2e-2 of scale (the two
    bf16 routes round at different places, each about 1% from f32 here, so
    their distance can reach twice that). kp_shard: each half of the
    keypoint rows builds its own mask, as a kp-sharded rank does; the
    halves' kl messages into the ligand are summed, their lk rows joined."""
    k, F = 3, 24
    h_kp, h_lig, x_kp, x_lig, kp_mask, lig_mask = _kl_case(case, F=F)
    mod, ref = (tegnn.EGNNEdge(F, F, torch.Generator().manual_seed(11), use_tanh=True, dtype=d)
                for d in (dtype, "float32"))
    rows = [slice(0, 4), slice(4, 8)] if case == "kp_shard" else [slice(None)]
    with torch.no_grad():
        idx, _, valid = knn_indices(x_lig, lig_mask, x_kp, kp_mask, k)
        want = ref.pairs(h_kp, h_lig, x_kp, x_lig, idx, valid & kp_mask[:, :, None], anchor_is_src=anchor_is_src)
        parts = []
        for r in rows:
            adj = dense_knn_adjacency(x_kp[:, r], kp_mask[:, r], x_lig, lig_mask, k, per="src")
            parts.append(mod.kernel(h_kp[:, r], h_lig, x_kp[:, r], x_lig, adj) if anchor_is_src
                         else mod.kernel(h_lig, h_kp[:, r], x_lig, x_kp[:, r], adj.transpose(1, 2)))
    got = [sum(p[i] for p in parts) if anchor_is_src else torch.cat([p[i] for p in parts], dim=1)
           for i in range(2)]
    for g, w, part in zip(got, want, ("agg_h", "agg_x")):
        if dtype == "float32":
            assert_close(g, w, rtol=1e-5, atol=1e-5, msg=f"{case} {part}")
        else:
            assert_rel_max(g, w, BF16_REL, msg=f"{case} {part}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("coord_layers,edge_feat,compute_coord", [(2, False, True), (1, True, True),
                                                                  (1, True, False)])
def test_nbr_list_matches_jax(coord_layers, edge_feat, compute_coord, dtype):
    rng = np.random.default_rng(4)
    B, N, K, F = 2, 11, 4, 16
    h = rng.normal(size=(B, N, F)).astype(np.float32)
    x = (rng.normal(size=(B, N, 3)) * 2).astype(np.float32)
    idx = rng.integers(0, N, size=(B, N, K)).astype(np.int32)
    valid = rng.random((B, N, K)) < 0.7
    ef = (rng.random((B, N, K, 1)) < 0.5).astype(np.float32) if edge_feat else None
    jmod = jegnn.EGNNEdgeNbrList(hidden_size=F, use_tanh=True, coord_hidden_layers=coord_layers,
                                 compute_coord=compute_coord, edge_feat_size=1 if edge_feat else 0, dtype=dtype)
    jin = [jnp.asarray(a) for a in (h, h, x, x, idx, valid)]
    jef = None if ef is None else jnp.asarray(ef)
    params = jmod.init(jax.random.key(3), *jin, jef)
    want = jmod.apply(params, *jin, jef)
    tmod = load_from_jax(tegnn.EGNNEdge(F, F, torch.Generator(), use_tanh=True,
                                        coord_hidden_layers=coord_layers, compute_coord=compute_coord,
                                        edge_feat_size=1 if edge_feat else 0, dtype=dtype), params)
    with torch.no_grad():
        got = tmod.nbr(t(h), t(h), t(x), t(x), t(idx, torch.int64), t(valid), None if ef is None else t(ef))
    _check(got, want, dtype, f"layers={coord_layers} ef={edge_feat}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", [True, False])
def test_node_update_matches_jax(norm, dtype):
    rng = np.random.default_rng(6)
    h = rng.normal(size=(2, 5, 17)).astype(np.float32)
    agg = rng.normal(size=(2, 5, 17)).astype(np.float32)
    jmod = jegnn.NodeUpdate(hidden_size=17, out_size=17, norm=norm, dtype=dtype)
    params = jmod.init(jax.random.key(4), jnp.asarray(h), jnp.asarray(agg))
    want = jmod.apply(params, jnp.asarray(h), jnp.asarray(agg))
    tmod = load_from_jax(tegnn.NodeUpdate(17, 17, 17, torch.Generator(), norm=norm, dtype=dtype), params)
    with torch.no_grad():
        got = tmod(t(h), t(agg))
    if dtype == "float32":
        assert_close(got, want, **F32)
    else:
        assert_rel_max(got, want, BF16_REL)


def _grad_setup(dtype, seed=5):
    """The JAX module (XLA path) and the port's module on one set of seeded
    numpy parameters, the inputs, and the weights of a scalar of the outputs."""
    inputs = _dense_inputs(seed=seed)
    F = inputs[0].shape[-1]
    jmod = jegnn.EGNNEdgeDense(hidden_size=F, use_tanh=True, coords_range=10.0, coord_hidden_layers=2,
                               dtype=dtype, use_pallas=False)
    jin = [jnp.asarray(a) for a in inputs]
    shapes = jmod.init(jax.random.key(0), *jin)
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.uniform(-1, 1, size=p.shape).astype(np.float32) / np.sqrt(p.shape[0])), shapes)
    tmod = load_from_jax(tegnn.EGNNEdge(F, F, torch.Generator(), use_tanh=True, coords_range=10.0,
                                        dtype=dtype), params)
    b, _, nd = inputs[4].shape
    r_h = rng.normal(size=(b, nd, F)).astype(np.float32)
    r_x = rng.normal(size=(b, nd, 3)).astype(np.float32)
    return jmod, params, tmod, inputs, r_h, r_x


def _port_grads(tmod, inputs, r_h, r_x):
    h_src, h_dst = (t(a).requires_grad_() for a in inputs[:2])
    agg_h, agg_x = tmod(h_src, h_dst, t(inputs[2]), t(inputs[3]), t(inputs[4]))
    (torch.sum(agg_h * t(r_h)) + torch.sum(agg_x * t(r_x))).backward()
    return {n: p.grad for n, p in tmod.named_parameters()}, (h_src.grad, h_dst.grad)


def test_dense_parameter_gradients_match_jax():
    """Backward through EGNNEdge's dense form reaches all 15 parameters and both node
    inputs and matches jax.grad of the JAX module's XLA path (f32)."""
    jmod, params, tmod, inputs, r_h, r_x = _grad_setup("float32")

    def scalar(p, h_src, h_dst):
        agg_h, agg_x = jmod.apply(p, h_src, h_dst, *[jnp.asarray(a) for a in inputs[2:]])
        return jnp.sum(agg_h * r_h) + jnp.sum(agg_x * r_x)

    gp, gs, gd = jax.grad(scalar, argnums=(0, 1, 2))(params, jnp.asarray(inputs[0]), jnp.asarray(inputs[1]))
    want = jax_flat(gp)
    got, (g_src, g_dst) = _port_grads(tmod, inputs, r_h, r_x)
    assert len(got) == 15 and set(got) == set(want)
    for name, g in got.items():
        assert g is not None, name
        assert_close(g.reshape(want[name].shape), want[name], msg=name, **F32)
    assert_close(g_src, gs, msg="h_src", **F32)
    assert_close(g_dst, gd, msg="h_dst", **F32)


def test_dense_parameter_gradients_bf16_finite_nonzero():
    _, _, tmod, inputs, r_h, r_x = _grad_setup("bfloat16")
    got, inputs_grad = _port_grads(tmod, inputs, r_h, r_x)
    assert len(got) == 15
    for name, g in list(got.items()) + list(zip(("h_src", "h_dst"), inputs_grad)):
        assert g is not None and torch.isfinite(g).all() and g.abs().max() > 0, name


def test_dense_no_grad_goes_through_the_kernel_entry(monkeypatch):
    """Under no_grad (sampling, encoding) the module calls egnn_edge_dense,
    the kernel's entry; with grad recording it does not."""
    _, _, tmod, inputs, _, _ = _grad_setup("bfloat16")
    calls = []

    def counting(*a, **kw):
        calls.append(1)
        return egnn_edge.egnn_edge_dense(*a, **kw)

    monkeypatch.setattr(tegnn, "egnn_edge_dense", counting)
    with torch.no_grad():
        tmod(*[t(a) for a in inputs])
    assert len(calls) == 1
    tmod(*[t(a) for a in inputs])
    assert len(calls) == 1
