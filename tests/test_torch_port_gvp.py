"""kpdiff_tpu_torch's GVP family against kpdiff_tpu on the CPU: rbf_embed, each
GVP module (GVP, GVPChain, GVPLayerNorm, _SplitLinear, GVPFactorizedFirst,
FactorizedGVPChain, the edge messages on dense grids, neighbor lists and kNN
pair lists), the GVP dynamics on dense, neighbor-list and block kk, the GVP
encoder under both attention semantics, and GVP dropout by its statistics.

The JAX side runs its default flat vector layout (..., 3V); the port's
(..., V, 3) tensors cross as numpy. Weights are the port's seeded init
carried into a JAX param tree. f32 at rtol 1e-4 / atol 1e-5, bf16 at 2e-2
of the output's scale."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kpdiff_tpu.models import dynamics_gvp as jdyn, encoder_gvp as jenc, gvp as jgvp
from kpdiff_tpu.ops.geometry import rbf_embed as j_rbf
from kpdiff_tpu_torch.models import gvp as tgvp
from kpdiff_tpu_torch.models.complex import synthetic_batch
from kpdiff_tpu_torch.models.dynamics_gvp import GVPDynamics, GVPMultiEdgeConv
from kpdiff_tpu_torch.models.encoder_gvp import GVPReceptorEncoder
from kpdiff_tpu_torch.ops.edge_sets import Blocks
from kpdiff_tpu_torch.ops.geometry import rbf_embed
from kpdiff_tpu_torch.ops.neighbors import dense_radius_adjacency, knn_indices, radius_neighbor_list
from kpdiff_tpu_torch.ops.spatial import block_radius_adjacency, spatial_sort_permutation
from kpdiff_tpu_torch.utils.params_io import export_flat
from torch_port_util import assert_close, assert_rel_max, jax_complex, jax_tree, t

RTOL, ATOL = 1e-4, 1e-5
S, V = 12, 4


def _rng(seed):
    return np.random.default_rng(seed)


def _params(mod):
    return {"params": jax_tree(export_flat(mod))}


def _flat(v):
    """(..., V, 3) torch -> (..., 3V) jnp (the JAX package's flat layout)."""
    a = v.detach().numpy()
    return jnp.asarray(a.reshape(*a.shape[:-2], a.shape[-2] * 3))


def _unflat(v):
    a = np.asarray(v, np.float32)
    return a.reshape(*a.shape[:-1], a.shape[-1] // 3, 3)


def _check(got, want, dtype, msg):
    if dtype == "float32":
        assert_close(got, want, RTOL, ATOL, msg)
    else:
        assert_rel_max(got, want, 2e-2, msg)


def test_rbf_embed_matches_jax():
    d = _rng(0).uniform(0, 20, size=(3, 7)).astype(np.float32)
    assert_close(rbf_embed(t(d), 0.0, 15.0, 16), j_rbf(jnp.asarray(d), 0.0, 15.0, 16), RTOL, ATOL)


GVP_CASES = {
    "f32": dict(),
    "f32_ungated_identity": dict(vector_gating=False, vectors_activation="identity", feats_activation="identity"),
    "f32_hidden": dict(hidden_vectors=7),
    "bf16": dict(dtype="bfloat16"),
}


@pytest.mark.parametrize("case", GVP_CASES)
def test_gvp_matches_jax(case):
    kw = GVP_CASES[case]
    rng = _rng(1)
    feats = t(rng.normal(size=(2, 5, 9)).astype(np.float32))
    vec = t(rng.normal(size=(2, 5, 3, 3)).astype(np.float32))
    mod = tgvp.GVP(3, 4, 9, 6, torch.Generator().manual_seed(0), **kw)
    fo, vo = mod(feats, vec)
    jf, jv = jgvp.GVP(3, 4, 9, 6, vec_layout="flat", **kw).apply(_params(mod), (jnp.asarray(feats.numpy()),
                                                                                  _flat(vec)))
    dtype = kw.get("dtype", "float32")
    _check(fo, jf, dtype, "feats")
    _check(vo, _unflat(jv), dtype, "vectors")


def test_gvp_chain_and_layer_norm_match_jax():
    rng = _rng(2)
    feats = t(rng.normal(size=(3, 7, S)).astype(np.float32))
    vec = t(rng.normal(size=(3, 7, V, 3)).astype(np.float32))
    specs = tgvp._update_specs(S, V, 2)
    chain = tgvp.GVPChain(specs, torch.Generator().manual_seed(1))
    jf, jv = jgvp.GVPChain(specs, vec_layout="flat").apply(_params(chain), (jnp.asarray(feats.numpy()), _flat(vec)))
    fo, vo = chain(feats, vec)
    assert_close(fo, jf, RTOL, ATOL, "chain feats")
    assert_close(vo, _unflat(jv), RTOL, ATOL, "chain vectors")
    ln = tgvp.GVPLayerNorm(S)
    with torch.no_grad():
        ln.LayerNorm_0.scale.uniform_(0.5, 1.5)
        ln.LayerNorm_0.bias.uniform_(-0.5, 0.5)
    vec[0, 0] = 0.0  # an all-zero node: the 1e-8 clamp
    fo, vo = ln(feats, vec)
    jf, jv = jgvp.GVPLayerNorm(vec_layout="flat").apply(_params(ln), jnp.asarray(feats.numpy()), _flat(vec))
    assert_close(fo, jf, RTOL, ATOL, "layer norm feats")
    assert_close(vo, _unflat(jv), RTOL, ATOL, "layer norm vectors")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_factorized_first_and_split_linear_match_jax(dtype):
    """Per-node pieces broadcast against per-pair pieces, as the message
    chains use them; also _SplitLinear alone."""
    rng = _rng(3)
    h_src = t(rng.normal(size=(2, 5, 1, S)).astype(np.float32))
    rbf = t(rng.normal(size=(2, 5, 6, 16)).astype(np.float32))
    x_unit = t(rng.normal(size=(2, 5, 6, 1, 3)).astype(np.float32))
    v_src = t(rng.normal(size=(2, 5, 1, V, 3)).astype(np.float32))
    specs = tgvp._message_specs(S, V, 2, 16, 1)
    chain = tgvp.FactorizedGVPChain(specs, torch.Generator().manual_seed(2), dtype=dtype)
    fo, vo = chain([h_src, rbf], [x_unit, v_src])
    jpieces_v = [_flat(x_unit), _flat(v_src)]
    jf, jv = jgvp.FactorizedGVPChain(specs, dtype=dtype).apply(
        _params(chain), [jnp.asarray(h_src.numpy()), jnp.asarray(rbf.numpy())], jpieces_v)
    _check(fo, jf, dtype, "factorized chain feats")
    _check(vo, _unflat(jv), dtype, "factorized chain vectors")
    # the first GVP alone equals a GVP on the materialised concatenation
    first = chain.gvp0
    full = tgvp.GVP(**specs[0], gen=torch.Generator(), dtype=dtype)
    full.load_state_dict(first.state_dict())
    cat_s = torch.cat([h_src.expand(2, 5, 6, S), rbf], dim=-1)
    cat_v = torch.cat([x_unit, v_src.expand(2, 5, 6, V, 3)], dim=-2)
    for a, b in zip(first([h_src, rbf], [x_unit, v_src]), full(cat_s, cat_v)):
        _check(a, b.detach().float().numpy(), dtype, "factorized vs concatenated")
    lin = tgvp._SplitLinear(S + 16, 5, torch.Generator().manual_seed(3), dtype=dtype)
    want = jgvp._SplitLinear(5, S + 16, dtype=dtype).apply(_params(lin), [jnp.asarray(h_src.numpy()),
                                                                          jnp.asarray(rbf.numpy())])
    _check(lin([h_src, rbf]), want, dtype, "split linear")


def _graph(seed, b=2, ns=9, nd=7):
    rng = _rng(seed)
    x_src = t(rng.normal(size=(b, ns, 3)).astype(np.float32) * 3)
    x_dst = t(rng.normal(size=(b, nd, 3)).astype(np.float32) * 3)
    m_src = t(rng.random((b, ns)) < 0.85)
    m_dst = t(rng.random((b, nd)) < 0.85)
    h_src = t(rng.normal(size=(b, ns, S)).astype(np.float32))
    h_dst = t(rng.normal(size=(b, nd, S)).astype(np.float32))
    v_src = t(rng.normal(size=(b, ns, V, 3)).astype(np.float32))
    v_dst = t(rng.normal(size=(b, nd, V, 3)).astype(np.float32))
    return x_src, x_dst, m_src, m_dst, h_src, h_dst, v_src, v_dst


MESSAGE_CASES = {
    "sum": dict(),
    "mean": dict(agg="mean"),
    "dst_feats_edge_feat": dict(use_dst_feats=True, edge_feat_size=1),
    "bf16": dict(dtype="bfloat16"),
}


def _message_mods(kw, seed=4, **extra):
    mod = tgvp.GVPEdgeMessages(S, V, torch.Generator().manual_seed(seed), n_message_gvps=2, rbf_dmax=8.0, **kw)
    return mod, dict(scalar_size=S, vector_size=V, n_message_gvps=2, rbf_dmax=8.0, vec_layout="flat", **kw, **extra)


@pytest.mark.parametrize("case", MESSAGE_CASES)
def test_edge_messages_dense_and_nbr_match_jax(case):
    kw = MESSAGE_CASES[case]
    dtype = kw.get("dtype", "float32")
    x_src, x_dst, m_src, m_dst, h_src, h_dst, v_src, v_dst = _graph(5)
    mod, jkw = _message_mods(kw)
    p = _params(mod)
    adj = dense_radius_adjacency(x_src, m_src, x_dst, m_dst, 4.0)
    ef = t(_rng(6).normal(size=(*adj.shape, 1)).astype(np.float32)) if kw.get("edge_feat_size") else None
    j = lambda a: jnp.asarray(a.numpy())  # noqa: E731
    s, v = mod.dense(h_src, v_src, x_src, h_dst, v_dst, x_dst, adj, ef)
    js, jv = jgvp.GVPEdgeMessagesDense(**jkw).apply(p, j(h_src), _flat(v_src), j(x_src), j(h_dst), _flat(v_dst),
                                                    j(x_dst), j(adj), None if ef is None else j(ef))
    _check(s, js, dtype, "dense scalars")
    _check(v, _unflat(jv), dtype, "dense vectors")

    idx, valid = radius_neighbor_list(x_src, m_src, x_dst, m_dst, 4.0, 5)
    ef = t(_rng(7).normal(size=(*idx.shape, 1)).astype(np.float32)) if kw.get("edge_feat_size") else None
    s, v = mod.nbr(h_src, v_src, x_src, h_dst, v_dst, x_dst, idx, valid, ef)
    js, jv = jgvp.GVPEdgeMessagesNbr(**jkw).apply(p, j(h_src), _flat(v_src), j(x_src), j(h_dst), _flat(v_dst),
                                                  j(x_dst), j(idx), j(valid), None if ef is None else j(ef))
    _check(s, js, dtype, "nbr scalars")
    _check(v, _unflat(jv), dtype, "nbr vectors")


@pytest.mark.parametrize("anchor_is_src", [True, False], ids=["kl", "lk"])
@pytest.mark.parametrize("agg", ["sum", "mean"])
def test_edge_messages_pairs_match_jax(anchor_is_src, agg):
    x_kp, x_lig, m_kp, m_lig, h_kp, h_lig, v_kp, v_lig = _graph(8, ns=6, nd=11)
    idx, _, valid = knn_indices(x_lig, m_lig, x_kp, m_kp, 3)
    valid = valid & m_kp[:, :, None]
    mod, jkw = _message_mods(dict(agg=agg), anchor_is_src=anchor_is_src)
    s, v = mod.pairs(h_kp, v_kp, x_kp, h_lig, v_lig, x_lig, idx, valid, anchor_is_src=anchor_is_src)
    j = lambda a: jnp.asarray(a.numpy())  # noqa: E731
    js, jv = jgvp.GVPEdgeMessagesKNNPairs(**jkw).apply(_params(mod), j(h_kp), _flat(v_kp), j(x_kp), j(h_lig),
                                                       _flat(v_lig), j(x_lig), j(idx), j(valid))
    assert_close(s, js, RTOL, ATOL, "pair scalars")
    assert_close(v, _unflat(jv), RTOL, ATOL, "pair vectors")


DYN_CASES = {
    "dense_mean": dict(kk="dense", message_norm="mean"),
    "dense_mn10": dict(kk="dense", message_norm=10.0),
    "nbr_mn0": dict(kk="nbr", message_norm=0),
    "block_mean": dict(kk="block", message_norm="mean"),
    "dense_mean_bf16": dict(kk="dense", message_norm="mean", compute_dtype="bfloat16"),
    "block_mn10_bf16": dict(kk="block", message_norm=10.0, compute_dtype="bfloat16"),
}


def _dyn_inputs(seed, b=2, nl=10, k=32):
    cpx = synthetic_batch(seed, batch=b, n_rec_pad=k, n_lig_pad=nl, n_rec_feat=5, n_lig_feat=6, min_rec=20)
    perm = spatial_sort_permutation(cpx.rec_x, cpx.rec_mask)
    kp_x = torch.take_along_dim(cpx.rec_x, perm[..., None], dim=1)
    kp_mask = torch.take_along_dim(cpx.rec_mask, perm, dim=1)
    kp_h = t(_rng(seed).normal(size=(b, k, 5)).astype(np.float32))
    kp_v = t(_rng(seed + 1).normal(size=(b, k, V, 3)).astype(np.float32))
    return cpx.lig_x, cpx.lig_h, cpx.lig_mask, kp_x, kp_h, kp_mask, kp_v


@pytest.mark.parametrize("case", DYN_CASES)
def test_gvp_dynamics_matches_jax(case):
    kw = dict(DYN_CASES[case])
    layout = kw.pop("kk")
    lig_x, lig_h, lig_mask, kp_x, kp_h, kp_mask, kp_v = _dyn_inputs(9)
    if layout == "dense":
        kk = dense_radius_adjacency(kp_x, kp_mask, kp_x, kp_mask, 3.5, exclude_self=True)
        jkk = jnp.asarray(kk.numpy())
    elif layout == "nbr":
        kk = radius_neighbor_list(kp_x, kp_mask, kp_x, kp_mask, 3.5, 8, exclude_self=True)
        jkk = tuple(jnp.asarray(a.numpy()) for a in kk)
    else:
        kk = Blocks(block_radius_adjacency(kp_x, kp_mask, 3.5, 8))  # 4 windows of 8
        jkk = {"block": jnp.asarray(kk.adj.numpy())}
    dims = dict(vector_size=V, n_convs=3, n_hidden_scalars=S, update_kp=True, ll_k=0, kl_k=3, n_message_gvps=2,
                n_update_gvps=1, n_noise_gvps=2, ll_cutoff=5.0, **kw)
    dyn = GVPDynamics(6, 5, torch.Generator().manual_seed(10), **dims)
    tt = torch.full((2,), 0.4)
    with torch.no_grad():
        eps_h, eps_x = dyn(lig_x, lig_h, lig_mask, kp_x, kp_h, kp_mask, tt, kk, kp_v)
    j = lambda a: jnp.asarray(a.numpy())  # noqa: E731
    jh, jx = jax.jit(lambda p: jdyn.GVPDynamics(6, 5, **dims).apply(
        p, j(lig_x), j(lig_h), j(lig_mask), j(kp_x), j(kp_h), j(kp_mask), j(tt), jkk, j(kp_v)))(_params(dyn))
    dtype = kw.get("compute_dtype", "float32")
    _check(eps_h, jh, dtype, "eps_h")
    _check(eps_x, jx, dtype, "eps_x")


def test_gvp_conv_last_layer_drops_kp_edges():
    dyn = GVPDynamics(6, 5, torch.Generator(), vector_size=V, n_convs=3, n_hidden_scalars=S, update_kp=True, kl_k=3)
    names = [{n.split(".")[0] for n, _ in getattr(dyn, f"conv{i}").named_parameters()} for i in range(3)]
    assert names[0] == names[1] == {"message_ll", "message_kl", "message_lk", "message_kk", "msg_norm_kp",
                                    "msg_norm_lig", "update_kp", "update_lig", "upd_norm_kp", "upd_norm_lig"}
    assert names[2] == {"message_ll", "message_kl", "msg_norm_lig", "update_lig", "upd_norm_lig"}


ENC_CASES = {
    "intent_mn10": dict(message_norm=10.0),
    "executed_mean": dict(message_norm="mean", attn_semantics="executed"),
    "mn0_sameres_kprad": dict(message_norm=0, use_sameres_feat=True, k_closest=0, kp_rad=4.0),
}


@pytest.mark.parametrize("case", ENC_CASES)
def test_gvp_encoder_matches_jax(case):
    kw = dict(in_scalar_size=10, n_keypoints=5, out_scalar_size=S, vector_size=V, n_rr_convs=2, n_rk_convs=2,
              n_message_gvps=2, n_update_gvps=1, k_closest=3, graph_cutoffs={"rr": 3.5, "rk": 100.0})
    kw.update(ENC_CASES[case])
    cpx = synthetic_batch(11, batch=2, n_rec_pad=40, n_lig_pad=8, n_kp=5, kp_feat_dim=S, kp_vec_dim=V, min_rec=30)
    enc = GVPReceptorEncoder(torch.Generator().manual_seed(12), **kw)
    with torch.no_grad():
        out = enc(cpx)
    jout = jax.jit(lambda p, c: jenc.GVPReceptorEncoder(**kw).apply(p, c))(_params(enc), jax_complex(cpx, 5, S, V))
    for k in ("kp_x", "kp_h", "kp_v"):
        assert_close(getattr(out, k), getattr(jout, k), RTOL, ATOL, k)


def test_gvp_dropout_statistics():
    """Scalars kept with probability 1 - rate and scaled by 1 / (1 - rate);
    a vector channel's three components are kept or dropped together; the
    same generator state gives the same masks."""
    rate = 0.2
    feats = torch.ones((64, 128, 32))
    vec = torch.ones((64, 128, 16, 3))
    fo, vo = tgvp.gvp_dropout(torch.Generator().manual_seed(0), feats, vec, rate)
    kept_s = (fo != 0).float().mean().item()
    kept_v = (vo[..., 0] != 0).float().mean().item()
    n_s, n_v = feats.numel(), vo[..., 0].numel()
    for kept, n in ((kept_s, n_s), (kept_v, n_v)):  # within 5 binomial standard deviations
        assert abs(kept - (1 - rate)) < 5 * np.sqrt(rate * (1 - rate) / n), kept
    assert torch.allclose(fo[fo != 0], torch.full((), 1 / (1 - rate)))
    zero = vo == 0
    assert torch.equal(zero.all(-1), zero.any(-1))  # whole channels
    again, _ = tgvp.gvp_dropout(torch.Generator().manual_seed(0), feats, vec, rate)
    assert torch.equal(fo, again)
    assert tgvp.gvp_dropout(None, feats, vec, 0.0) == (feats, vec)


def test_gvp_dropout_in_conv_is_remat_safe():
    """A conv with dropout: the masks are drawn before the conv, so a
    checkpointed conv's gradients equal the plain conv's for the same draw."""
    lig_x, lig_h, lig_mask, kp_x, kp_h, kp_mask, kp_v = _dyn_inputs(13)
    kk = dense_radius_adjacency(kp_x, kp_mask, kp_x, kp_mask, 3.5, exclude_self=True)
    grads = []
    for remat in (False, True):
        dyn = GVPDynamics(6, 5, torch.Generator().manual_seed(14), vector_size=V, n_convs=2, n_hidden_scalars=S,
                          update_kp=True, kl_k=3, dropout=0.3, remat=remat)
        eps_h, eps_x = dyn(lig_x, lig_h, lig_mask, kp_x, kp_h, kp_mask, torch.full((2,), 0.4), kk, kp_v,
                           dropout=True, generator=torch.Generator().manual_seed(15))
        (eps_h.square().sum() + eps_x.square().sum()).backward()
        grads.append({n: p.grad.clone() for n, p in dyn.named_parameters() if p.grad is not None})
    assert grads[0].keys() == grads[1].keys() and len(grads[0]) > 20
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=1e-5, atol=1e-6, msg=n)
    with torch.no_grad():
        base = dyn(lig_x, lig_h, lig_mask, kp_x, kp_h, kp_mask, torch.full((2,), 0.4), kk, kp_v)
        dropped = dyn(lig_x, lig_h, lig_mask, kp_x, kp_h, kp_mask, torch.full((2,), 0.4), kk, kp_v, dropout=True,
                      generator=torch.Generator().manual_seed(15))
    assert not torch.equal(base[0], dropped[0])


def test_multi_edge_conv_without_dropout_draws_nothing():
    conv = GVPMultiEdgeConv(GVPDynamics.KP_EDGES, S, V, torch.Generator())
    assert conv.dropout_masks({}, None) is None
