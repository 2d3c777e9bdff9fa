"""The edge sets of kpdiff_tpu_torch/ops/edge_sets.py on the CPU: each named
type keeps its type through the graph runner's tree helpers, `edge_count`
and `layout_name` read every form, EGNNEdge and GVPEdgeMessages dispatch on
the type and refuse a plain tuple or dict, and the EGNN models' parameter
names, which trained archives and the benchmark match leaves by, stay as
written here. No JAX."""
from __future__ import annotations

import copy
from pathlib import Path

import pytest
import torch

from kpdiff_tpu_torch.config import load_config, model_from_config
from kpdiff_tpu_torch.models.chain_graph import clone_tree, copy_tree, tree_signature
from kpdiff_tpu_torch.models.egnn import EGNNEdge
from kpdiff_tpu_torch.models.gvp import GVPEdgeMessages
from kpdiff_tpu_torch.ops.edge_sets import (Blocks, KernelList, NbrList, PairList, as_kk, edge_count, layout_name,
                                            transpose)
from kpdiff_tpu_torch.ops.spatial import block_windows
from kpdiff_tpu_torch.parallel.mesh import Mesh, shard_batch
from kpdiff_tpu_torch.serve import _to_device

ROOT = Path(__file__).resolve().parents[1]
B, N, F = 2, 8, 6


def _forms():
    """One edge set of each form over B graphs of N nodes, and its edges per graph by hand."""
    g = torch.Generator().manual_seed(0)
    dense = torch.rand(B, N, N, generator=g) < 0.5
    idx = torch.randint(0, N, (B, N, 3), generator=g)
    valid = torch.rand(B, N, 3, generator=g) < 0.6
    blocks = torch.rand(B, 2, 12, 4, generator=g) < 0.3
    return {"dense": (dense, dense.sum((1, 2))), "nbr": (NbrList(idx, valid), valid.sum((1, 2))),
            "pairs": (PairList(idx, valid), valid.sum((1, 2))), "block": (Blocks(blocks), blocks.sum((1, 2, 3))),
            "kernel_list": (KernelList(idx.to(torch.int32), valid), valid.sum((1, 2)))}


@pytest.mark.parametrize("form", ["nbr", "pairs", "block"])
def test_named_types_survive_the_tree_helpers(form):
    """clone_tree, copy_tree, tree_signature and serve's _to_device (and
    shard_batch for kk's forms) keep a NamedTuple edge set's type and
    fields; its signature is not a plain tuple's. A PairList is built in
    the dynamics' forward and is never a chain input: it has no signature."""
    e, _ = _forms()[form]
    tree = {"kk": e, "t": torch.zeros(B)}
    got = clone_tree(tree)
    assert type(got["kk"]) is type(e) and got["kk"]._fields == e._fields
    assert all(torch.equal(a, b) if torch.is_tensor(a) else a == b for a, b in zip(got["kk"], e))
    assert got["kk"][0] is not e[0]
    zero = clone_tree(tree)
    for t in zero["kk"]:
        if torch.is_tensor(t):
            t.zero_()
    copy_tree(zero, tree)
    assert all(torch.equal(a, b) for a, b in zip(zero["kk"], e) if torch.is_tensor(a))
    if form == "pairs":
        with pytest.raises(TypeError, match="chain input of type bool"):
            tree_signature(tree)
    else:
        assert tree_signature(tree) == tree_signature(got)
        assert tree_signature(e) != tree_signature(tuple(e))
    assert type(_to_device(e, "cpu")) is type(e)
    if form != "pairs":  # the forms kk takes also go through the data axis's batch split
        mesh = Mesh(("data",), (2,), (1,), (None,), torch.device("cpu"))
        assert type(shard_batch(e, mesh)) is type(e) and torch.equal(shard_batch(e, mesh)[0], e[0][1:])


@pytest.mark.parametrize("form", ["dense", "nbr", "pairs", "block", "kernel_list"])
def test_edge_count_and_layout_name(form):
    """edge_count: edges per graph, the valid slots of a list; layout_name:
    the serve.chunks_kk_<layout> names, nbr with its cap (a KernelList is
    the neighbor list it carries)."""
    e, want = _forms()[form]
    assert torch.equal(edge_count(e), want)
    assert layout_name(e) == {"dense": "dense", "nbr": "nbr3", "pairs": "pairs3", "block": "block",
                              "kernel_list": "nbr3"}[form]


@pytest.mark.parametrize("form", ["dense", "nbr", "block"])
def test_as_kk_takes_compact_kks_pair_as_a_list(form):
    """compact_kk may return a plain (idx, valid) 2-tuple: as_kk, where its
    result enters sampling, makes it the NbrList it stands for; the forms kk
    takes otherwise pass as they are, and the dispatch still refuses a plain
    tuple or dict."""
    e, _ = _forms()[form]
    assert as_kk(e) is e
    if form == "nbr":
        got = as_kk(tuple(e))
        assert type(got) is NbrList and all(a is b for a, b in zip(got, e))
    plain = {"block": e.adj} if form == "block" else (e,) if form == "dense" else tuple(e) + (e.idx,)
    assert as_kk(plain) is plain
    with pytest.raises(TypeError, match="edge set"):
        layout_name(plain)


def _egnn():
    return EGNNEdge(F, F, torch.Generator().manual_seed(1), use_tanh=True)


def _gvp():
    return GVPEdgeMessages(F, 2, torch.Generator().manual_seed(1), n_message_gvps=2)


def _egnn_call(mod, edges):
    g = torch.Generator().manual_seed(2)
    h, x = torch.randn(B, N, F, generator=g), torch.randn(B, N, 3, generator=g)
    return mod(h, h, x, x, edges)


def _gvp_call(mod, edges):
    g = torch.Generator().manual_seed(2)
    h, v = torch.randn(B, N, F, generator=g), torch.randn(B, N, 2, 3, generator=g)
    x = torch.randn(B, N, 3, generator=g)
    return mod(h, v, x, h, v, x, edges)


@pytest.mark.parametrize("module", ["egnn", "gvp"])
@pytest.mark.parametrize("structure", ["tuple", "dict"])
def test_dispatch_refuses_plain_structures(module, structure):
    """A list rebuilt as a plain tuple, or the old {'block': adj} dict, fails
    loudly at the dispatch instead of reaching a dense branch."""
    e, _ = _forms()["nbr" if structure == "tuple" else "block"]
    plain = tuple(e) if structure == "tuple" else {"block": e.adj}
    mod, call = (_egnn(), _egnn_call) if module == "egnn" else (_gvp(), _gvp_call)
    with torch.no_grad(), pytest.raises(TypeError, match="edge set"):
        call(mod, plain)
    with pytest.raises(TypeError):
        edge_count(plain)


@pytest.mark.parametrize("module", ["egnn", "gvp"])
@pytest.mark.parametrize("form", ["nbr", "pairs_kl", "pairs_lk", "block"])
def test_dispatch_runs_the_named_form(module, form):
    """forward on each named type equals its form called by hand: a NbrList
    the list form, a PairList the pairs form with the anchor on its side
    (`transpose` moves it to the destinations), a Blocks the dense form on
    its windows."""
    mod = _egnn() if module == "egnn" else _gvp()
    e, _ = _forms()["block" if form == "block" else "nbr" if form == "nbr" else "pairs"]
    if form == "pairs_lk":
        e = transpose(e)
        assert e.anchor_is_src is False
    g = torch.Generator().manual_seed(3)
    h, x, v, h2, x2, v2 = (torch.randn(B, N, *tail, generator=g) for tail in ((F,), (3,), (2, 3)) * 2)
    if form == "block":
        tile = e.adj.shape[-1]
        n = e.adj.shape[1] * tile
        h, x, v = h[:, :n], x[:, :n], v[:, :n]
        hw, xw, vw = (block_windows(a, tile).reshape(B * 2, 3 * tile, *a.shape[2:]) for a in (h, x, v))
        ht, xt, vt = (a.reshape(B * 2, tile, *a.shape[2:]) for a in (h, x, v))
        adj = e.adj.reshape(B * 2, 3 * tile, tile)
        with torch.no_grad():
            if module == "egnn":
                got, want = mod(h, h, x, x, e), mod.dense(hw, ht, xw, xt, adj)
            else:
                got, want = mod(h, v, x, h, v, x, e), mod.dense(hw, vw, xw, ht, vt, xt, adj)
        want = tuple(w.reshape(B, n, *w.shape[2:]) for w in want)
    else:
        with torch.no_grad():
            if module == "egnn":
                got = mod(h, h2, x, x2, e)
                want = (mod.nbr(h, h2, x, x2, *e) if form == "nbr" else
                        mod.pairs(h, h2, x, x2, e.idx, e.valid, anchor_is_src=True) if form == "pairs_kl" else
                        mod.pairs(h2, h, x2, x, e.idx, e.valid, anchor_is_src=False))
            else:
                got = mod(h, v, x, h2, v2, x2, e)
                want = (mod.nbr(h, v, x, h2, v2, x2, *e) if form == "nbr" else
                        mod.pairs(h, v, x, h2, v2, x2, e.idx, e.valid, anchor_is_src=True) if form == "pairs_kl"
                        else mod.pairs(h2, v2, x2, h, v, x, e.idx, e.valid, anchor_is_src=False))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_kernel_list_runs_the_list_mode(monkeypatch):
    """EGNNEdge runs a KernelList (the dynamics' kernel route) in its
    `nbr_kernel` form, whatever the device and autograd say, and a NbrList
    of the same tensors in its `nbr` form: the form follows the type alone."""
    mod = _egnn()
    e, _ = _forms()["kernel_list"]
    calls = []
    monkeypatch.setattr(mod, "nbr_kernel", lambda *a: calls.append("list") or "list")
    monkeypatch.setattr(mod, "nbr", lambda *a: calls.append("nbr") or "nbr")
    assert _egnn_call(mod, e) == "list"
    assert _egnn_call(mod, NbrList(*e)) == "nbr"
    assert calls == ["list", "nbr"]


# named_parameters() of configs/<name>.yml at 2 layers of width 16 (6 keypoints
# and one rr conv of width 16 for the learned encoder), as the models have
# always named them: archives are matched leaf by leaf on these names.
NAMES = {
    "egnn_40kp": """
    encoder.rec_conv0.edge_rr.edge_w_src encoder.rec_conv0.edge_rr.edge_w_dst encoder.rec_conv0.edge_rr.edge_w_dij
    encoder.rec_conv0.edge_rr.edge_b encoder.rec_conv0.edge_rr.edge_lin2_w encoder.rec_conv0.edge_rr.edge_lin2_b
    encoder.rec_conv0.edge_rr.attn_w encoder.rec_conv0.edge_rr.attn_b encoder.rec_conv0.edge_rr.coord_w_src
    encoder.rec_conv0.edge_rr.coord_w_dst encoder.rec_conv0.edge_rr.coord_w_dij encoder.rec_conv0.edge_rr.coord_b
    encoder.rec_conv0.edge_rr.coord_out_w encoder.rec_conv0.node_mlp.lin0.kernel
    encoder.rec_conv0.node_mlp.lin0.bias encoder.rec_conv0.node_mlp.lin1.kernel
    encoder.rec_conv0.node_mlp.lin1.bias encoder.rec_conv0.LayerNorm_0.scale encoder.rec_conv0.LayerNorm_0.bias
    encoder.keypoint_embedding.kernel encoder.keypoint_embedding.bias encoder.rk_fc_src.kernel
    encoder.rk_fc_dst.kernel encoder.kp_feature_mlp.kernel encoder.kp_feature_mlp.bias
    encoder.kp_feature_norm.scale encoder.kp_feature_norm.bias dynamics.lig_encoder.lin0.kernel
    dynamics.lig_encoder.lin0.bias dynamics.lig_encoder.lin1.kernel dynamics.lig_encoder.lin1.bias
    dynamics.conv0.edge_ll.edge_w_src dynamics.conv0.edge_ll.edge_w_dst dynamics.conv0.edge_ll.edge_w_dij
    dynamics.conv0.edge_ll.edge_b dynamics.conv0.edge_ll.edge_lin2_w dynamics.conv0.edge_ll.edge_lin2_b
    dynamics.conv0.edge_ll.attn_w dynamics.conv0.edge_ll.attn_b dynamics.conv0.edge_ll.coord_w_src
    dynamics.conv0.edge_ll.coord_w_dst dynamics.conv0.edge_ll.coord_w_dij dynamics.conv0.edge_ll.coord_b
    dynamics.conv0.edge_ll.coord_lin2_w dynamics.conv0.edge_ll.coord_lin2_b dynamics.conv0.edge_ll.coord_out_w
    dynamics.conv0.edge_kl.edge_w_src dynamics.conv0.edge_kl.edge_w_dst dynamics.conv0.edge_kl.edge_w_dij
    dynamics.conv0.edge_kl.edge_b dynamics.conv0.edge_kl.edge_lin2_w dynamics.conv0.edge_kl.edge_lin2_b
    dynamics.conv0.edge_kl.attn_w dynamics.conv0.edge_kl.attn_b dynamics.conv0.edge_kl.coord_w_src
    dynamics.conv0.edge_kl.coord_w_dst dynamics.conv0.edge_kl.coord_w_dij dynamics.conv0.edge_kl.coord_b
    dynamics.conv0.edge_kl.coord_lin2_w dynamics.conv0.edge_kl.coord_lin2_b dynamics.conv0.edge_kl.coord_out_w
    dynamics.conv0.edge_lk.edge_w_src dynamics.conv0.edge_lk.edge_w_dst dynamics.conv0.edge_lk.edge_w_dij
    dynamics.conv0.edge_lk.edge_b dynamics.conv0.edge_lk.edge_lin2_w dynamics.conv0.edge_lk.edge_lin2_b
    dynamics.conv0.edge_lk.attn_w dynamics.conv0.edge_lk.attn_b dynamics.conv0.edge_lk.coord_w_src
    dynamics.conv0.edge_lk.coord_w_dst dynamics.conv0.edge_lk.coord_w_dij dynamics.conv0.edge_lk.coord_b
    dynamics.conv0.edge_lk.coord_lin2_w dynamics.conv0.edge_lk.coord_lin2_b dynamics.conv0.edge_lk.coord_out_w
    dynamics.conv0.edge_kk.edge_w_src dynamics.conv0.edge_kk.edge_w_dst dynamics.conv0.edge_kk.edge_w_dij
    dynamics.conv0.edge_kk.edge_b dynamics.conv0.edge_kk.edge_lin2_w dynamics.conv0.edge_kk.edge_lin2_b
    dynamics.conv0.edge_kk.attn_w dynamics.conv0.edge_kk.attn_b dynamics.conv0.edge_kk.coord_w_src
    dynamics.conv0.edge_kk.coord_w_dst dynamics.conv0.edge_kk.coord_w_dij dynamics.conv0.edge_kk.coord_b
    dynamics.conv0.edge_kk.coord_lin2_w dynamics.conv0.edge_kk.coord_lin2_b dynamics.conv0.edge_kk.coord_out_w
    dynamics.conv0.update_lig.node_mlp.lin0.kernel dynamics.conv0.update_lig.node_mlp.lin0.bias
    dynamics.conv0.update_lig.node_mlp.lin1.kernel dynamics.conv0.update_lig.node_mlp.lin1.bias
    dynamics.conv0.update_lig.LayerNorm_0.scale dynamics.conv0.update_lig.LayerNorm_0.bias
    dynamics.conv0.update_kp.node_mlp.lin0.kernel dynamics.conv0.update_kp.node_mlp.lin0.bias
    dynamics.conv0.update_kp.node_mlp.lin1.kernel dynamics.conv0.update_kp.node_mlp.lin1.bias
    dynamics.conv0.update_kp.LayerNorm_0.scale dynamics.conv0.update_kp.LayerNorm_0.bias
    dynamics.conv1.edge_ll.edge_w_src dynamics.conv1.edge_ll.edge_w_dst dynamics.conv1.edge_ll.edge_w_dij
    dynamics.conv1.edge_ll.edge_b dynamics.conv1.edge_ll.edge_lin2_w dynamics.conv1.edge_ll.edge_lin2_b
    dynamics.conv1.edge_ll.attn_w dynamics.conv1.edge_ll.attn_b dynamics.conv1.edge_ll.coord_w_src
    dynamics.conv1.edge_ll.coord_w_dst dynamics.conv1.edge_ll.coord_w_dij dynamics.conv1.edge_ll.coord_b
    dynamics.conv1.edge_ll.coord_lin2_w dynamics.conv1.edge_ll.coord_lin2_b dynamics.conv1.edge_ll.coord_out_w
    dynamics.conv1.edge_kl.edge_w_src dynamics.conv1.edge_kl.edge_w_dst dynamics.conv1.edge_kl.edge_w_dij
    dynamics.conv1.edge_kl.edge_b dynamics.conv1.edge_kl.edge_lin2_w dynamics.conv1.edge_kl.edge_lin2_b
    dynamics.conv1.edge_kl.attn_w dynamics.conv1.edge_kl.attn_b dynamics.conv1.edge_kl.coord_w_src
    dynamics.conv1.edge_kl.coord_w_dst dynamics.conv1.edge_kl.coord_w_dij dynamics.conv1.edge_kl.coord_b
    dynamics.conv1.edge_kl.coord_lin2_w dynamics.conv1.edge_kl.coord_lin2_b dynamics.conv1.edge_kl.coord_out_w
    dynamics.conv1.edge_lk.edge_w_src dynamics.conv1.edge_lk.edge_w_dst dynamics.conv1.edge_lk.edge_w_dij
    dynamics.conv1.edge_lk.edge_b dynamics.conv1.edge_lk.edge_lin2_w dynamics.conv1.edge_lk.edge_lin2_b
    dynamics.conv1.edge_lk.attn_w dynamics.conv1.edge_lk.attn_b dynamics.conv1.edge_lk.coord_w_src
    dynamics.conv1.edge_lk.coord_w_dst dynamics.conv1.edge_lk.coord_w_dij dynamics.conv1.edge_lk.coord_b
    dynamics.conv1.edge_lk.coord_lin2_w dynamics.conv1.edge_lk.coord_lin2_b dynamics.conv1.edge_lk.coord_out_w
    dynamics.conv1.edge_kk.edge_w_src dynamics.conv1.edge_kk.edge_w_dst dynamics.conv1.edge_kk.edge_w_dij
    dynamics.conv1.edge_kk.edge_b dynamics.conv1.edge_kk.edge_lin2_w dynamics.conv1.edge_kk.edge_lin2_b
    dynamics.conv1.edge_kk.attn_w dynamics.conv1.edge_kk.attn_b dynamics.conv1.edge_kk.coord_w_src
    dynamics.conv1.edge_kk.coord_w_dst dynamics.conv1.edge_kk.coord_w_dij dynamics.conv1.edge_kk.coord_b
    dynamics.conv1.edge_kk.coord_lin2_w dynamics.conv1.edge_kk.coord_lin2_b dynamics.conv1.edge_kk.coord_out_w
    dynamics.conv1.update_lig.node_mlp.lin0.kernel dynamics.conv1.update_lig.node_mlp.lin0.bias
    dynamics.conv1.update_lig.node_mlp.lin1.kernel dynamics.conv1.update_lig.node_mlp.lin1.bias
    dynamics.conv1.update_lig.LayerNorm_0.scale dynamics.conv1.update_lig.LayerNorm_0.bias
    dynamics.conv1.update_kp.node_mlp.lin0.kernel dynamics.conv1.update_kp.node_mlp.lin0.bias
    dynamics.conv1.update_kp.node_mlp.lin1.kernel dynamics.conv1.update_kp.node_mlp.lin1.bias
    dynamics.conv1.update_kp.LayerNorm_0.scale dynamics.conv1.update_kp.LayerNorm_0.bias
    dynamics.lig_decoder.lin0.kernel dynamics.lig_decoder.lin0.bias dynamics.lig_decoder.lin1.kernel
    dynamics.lig_decoder.lin1.bias
""".split(),
    "egnn_all_atom": """
    dynamics.lig_encoder.lin0.kernel dynamics.lig_encoder.lin0.bias dynamics.lig_encoder.lin1.kernel
    dynamics.lig_encoder.lin1.bias dynamics.kp_encoder.lin0.kernel dynamics.kp_encoder.lin0.bias
    dynamics.kp_encoder.lin1.kernel dynamics.kp_encoder.lin1.bias dynamics.conv0.edge_ll.edge_w_src
    dynamics.conv0.edge_ll.edge_w_dst dynamics.conv0.edge_ll.edge_w_dij dynamics.conv0.edge_ll.edge_b
    dynamics.conv0.edge_ll.edge_lin2_w dynamics.conv0.edge_ll.edge_lin2_b dynamics.conv0.edge_ll.attn_w
    dynamics.conv0.edge_ll.attn_b dynamics.conv0.edge_ll.coord_w_src dynamics.conv0.edge_ll.coord_w_dst
    dynamics.conv0.edge_ll.coord_w_dij dynamics.conv0.edge_ll.coord_b dynamics.conv0.edge_ll.coord_lin2_w
    dynamics.conv0.edge_ll.coord_lin2_b dynamics.conv0.edge_ll.coord_out_w dynamics.conv0.edge_kl.edge_w_src
    dynamics.conv0.edge_kl.edge_w_dst dynamics.conv0.edge_kl.edge_w_dij dynamics.conv0.edge_kl.edge_b
    dynamics.conv0.edge_kl.edge_lin2_w dynamics.conv0.edge_kl.edge_lin2_b dynamics.conv0.edge_kl.attn_w
    dynamics.conv0.edge_kl.attn_b dynamics.conv0.edge_kl.coord_w_src dynamics.conv0.edge_kl.coord_w_dst
    dynamics.conv0.edge_kl.coord_w_dij dynamics.conv0.edge_kl.coord_b dynamics.conv0.edge_kl.coord_lin2_w
    dynamics.conv0.edge_kl.coord_lin2_b dynamics.conv0.edge_kl.coord_out_w dynamics.conv0.edge_lk.edge_w_src
    dynamics.conv0.edge_lk.edge_w_dst dynamics.conv0.edge_lk.edge_w_dij dynamics.conv0.edge_lk.edge_b
    dynamics.conv0.edge_lk.edge_lin2_w dynamics.conv0.edge_lk.edge_lin2_b dynamics.conv0.edge_lk.attn_w
    dynamics.conv0.edge_lk.attn_b dynamics.conv0.edge_lk.coord_w_src dynamics.conv0.edge_lk.coord_w_dst
    dynamics.conv0.edge_lk.coord_w_dij dynamics.conv0.edge_lk.coord_b dynamics.conv0.edge_lk.coord_lin2_w
    dynamics.conv0.edge_lk.coord_lin2_b dynamics.conv0.edge_lk.coord_out_w dynamics.conv0.edge_kk.edge_w_src
    dynamics.conv0.edge_kk.edge_w_dst dynamics.conv0.edge_kk.edge_w_dij dynamics.conv0.edge_kk.edge_b
    dynamics.conv0.edge_kk.edge_lin2_w dynamics.conv0.edge_kk.edge_lin2_b dynamics.conv0.edge_kk.attn_w
    dynamics.conv0.edge_kk.attn_b dynamics.conv0.edge_kk.coord_w_src dynamics.conv0.edge_kk.coord_w_dst
    dynamics.conv0.edge_kk.coord_w_dij dynamics.conv0.edge_kk.coord_b dynamics.conv0.edge_kk.coord_lin2_w
    dynamics.conv0.edge_kk.coord_lin2_b dynamics.conv0.edge_kk.coord_out_w
    dynamics.conv0.update_lig.node_mlp.lin0.kernel dynamics.conv0.update_lig.node_mlp.lin0.bias
    dynamics.conv0.update_lig.node_mlp.lin1.kernel dynamics.conv0.update_lig.node_mlp.lin1.bias
    dynamics.conv0.update_lig.LayerNorm_0.scale dynamics.conv0.update_lig.LayerNorm_0.bias
    dynamics.conv0.update_kp.node_mlp.lin0.kernel dynamics.conv0.update_kp.node_mlp.lin0.bias
    dynamics.conv0.update_kp.node_mlp.lin1.kernel dynamics.conv0.update_kp.node_mlp.lin1.bias
    dynamics.conv0.update_kp.LayerNorm_0.scale dynamics.conv0.update_kp.LayerNorm_0.bias
    dynamics.conv1.edge_ll.edge_w_src dynamics.conv1.edge_ll.edge_w_dst dynamics.conv1.edge_ll.edge_w_dij
    dynamics.conv1.edge_ll.edge_b dynamics.conv1.edge_ll.edge_lin2_w dynamics.conv1.edge_ll.edge_lin2_b
    dynamics.conv1.edge_ll.attn_w dynamics.conv1.edge_ll.attn_b dynamics.conv1.edge_ll.coord_w_src
    dynamics.conv1.edge_ll.coord_w_dst dynamics.conv1.edge_ll.coord_w_dij dynamics.conv1.edge_ll.coord_b
    dynamics.conv1.edge_ll.coord_lin2_w dynamics.conv1.edge_ll.coord_lin2_b dynamics.conv1.edge_ll.coord_out_w
    dynamics.conv1.edge_kl.edge_w_src dynamics.conv1.edge_kl.edge_w_dst dynamics.conv1.edge_kl.edge_w_dij
    dynamics.conv1.edge_kl.edge_b dynamics.conv1.edge_kl.edge_lin2_w dynamics.conv1.edge_kl.edge_lin2_b
    dynamics.conv1.edge_kl.attn_w dynamics.conv1.edge_kl.attn_b dynamics.conv1.edge_kl.coord_w_src
    dynamics.conv1.edge_kl.coord_w_dst dynamics.conv1.edge_kl.coord_w_dij dynamics.conv1.edge_kl.coord_b
    dynamics.conv1.edge_kl.coord_lin2_w dynamics.conv1.edge_kl.coord_lin2_b dynamics.conv1.edge_kl.coord_out_w
    dynamics.conv1.edge_lk.edge_w_src dynamics.conv1.edge_lk.edge_w_dst dynamics.conv1.edge_lk.edge_w_dij
    dynamics.conv1.edge_lk.edge_b dynamics.conv1.edge_lk.edge_lin2_w dynamics.conv1.edge_lk.edge_lin2_b
    dynamics.conv1.edge_lk.attn_w dynamics.conv1.edge_lk.attn_b dynamics.conv1.edge_lk.coord_w_src
    dynamics.conv1.edge_lk.coord_w_dst dynamics.conv1.edge_lk.coord_w_dij dynamics.conv1.edge_lk.coord_b
    dynamics.conv1.edge_lk.coord_lin2_w dynamics.conv1.edge_lk.coord_lin2_b dynamics.conv1.edge_lk.coord_out_w
    dynamics.conv1.edge_kk.edge_w_src dynamics.conv1.edge_kk.edge_w_dst dynamics.conv1.edge_kk.edge_w_dij
    dynamics.conv1.edge_kk.edge_b dynamics.conv1.edge_kk.edge_lin2_w dynamics.conv1.edge_kk.edge_lin2_b
    dynamics.conv1.edge_kk.attn_w dynamics.conv1.edge_kk.attn_b dynamics.conv1.edge_kk.coord_w_src
    dynamics.conv1.edge_kk.coord_w_dst dynamics.conv1.edge_kk.coord_w_dij dynamics.conv1.edge_kk.coord_b
    dynamics.conv1.edge_kk.coord_lin2_w dynamics.conv1.edge_kk.coord_lin2_b dynamics.conv1.edge_kk.coord_out_w
    dynamics.conv1.update_lig.node_mlp.lin0.kernel dynamics.conv1.update_lig.node_mlp.lin0.bias
    dynamics.conv1.update_lig.node_mlp.lin1.kernel dynamics.conv1.update_lig.node_mlp.lin1.bias
    dynamics.conv1.update_lig.LayerNorm_0.scale dynamics.conv1.update_lig.LayerNorm_0.bias
    dynamics.conv1.update_kp.node_mlp.lin0.kernel dynamics.conv1.update_kp.node_mlp.lin0.bias
    dynamics.conv1.update_kp.node_mlp.lin1.kernel dynamics.conv1.update_kp.node_mlp.lin1.bias
    dynamics.conv1.update_kp.LayerNorm_0.scale dynamics.conv1.update_kp.LayerNorm_0.bias
    dynamics.lig_decoder.lin0.kernel dynamics.lig_decoder.lin0.bias dynamics.lig_decoder.lin1.kernel
    dynamics.lig_decoder.lin1.bias
""".split(),
}


@pytest.mark.parametrize("name", ["egnn_40kp", "egnn_all_atom"])
def test_parameter_names_are_unchanged(name):
    """The same names in the same order, with no parameter shared under a
    second name."""
    cfg = copy.deepcopy(load_config(ROOT / "configs" / f"{name}.yml"))
    cfg["padding"]["n_rec"] = 64
    cfg["dynamics"].update(n_layers=2, hidden_nf=16)
    if cfg["diffusion"]["rec_encoder_type"] == "learned":
        cfg["graph"]["n_keypoints"] = 6
        cfg["rec_encoder"].update(n_convs=1, hidden_n_node_feat=16, out_n_node_feat=16)
    model = model_from_config(cfg, device="cpu", seed=0)
    assert [n for n, _ in model.named_parameters()] == NAMES[name]
    assert len(model.state_dict()) == len(NAMES[name])
