"""The edge kernel's list mode (kpdiff_tpu_torch/ops/cuda/egnn_edge.py::
egnn_edge_list, csrc/egnn_edge.cu's LIST instantiation) and its route.

On the CPU: the list entry's plain version (the list's mask through
egnn_edge_dense's plain version) against EGNNEdge's `nbr` form over the same
list and against `egnn_edge_dense_plain` on `NbrList.adjacency`, on lists
with invalid slots mid-list (their indices naming real sources), a
destination with no valid slot, a ragged batch, at cap 24 and 5; the
operands the entry refuses; the dynamics' route on a faked kernel device,
where a neighbor-list kk reaches the list mode with no mask built; the
chain graphs' count of list-mode launches. The case marked `card` runs the
kernel at the all-atom cell's shapes and skips without a card. This file
imports no JAX, so that it runs on the card as it is: `python3 -m pytest
--noconftest -m card tests/test_torch_port_edge_list.py`.
"""
from __future__ import annotations

import types

import pytest
import torch

from kpdiff_tpu_torch.models.chain_graph import ChainGraph
from kpdiff_tpu_torch.models.egnn import EGNNEdge
from kpdiff_tpu_torch.ops.cuda import egnn_edge
from kpdiff_tpu_torch.ops.edge_sets import NbrList
from test_torch_port_kk_route import (BF16_REL, N_LAYERS, KKCalls, _all_atom_list, _dynamics_call, card,  # noqa: F401
                                      cell_pockets, fake_kernel_device, rel_max)

F32_REL = 1e-5
H = 17  # a hidden width of 16 plus the timestep channel


def _list_case(cap: int, idx_dtype: torch.dtype, seed: int):
    """Two graphs of 40 sources and 33 destinations, the second ragged (31
    real sources, 27 real destinations): each destination's cap slots name
    distinct sources, about 60% of them valid in any position; destination
    (0, 3) has no valid slot; the second graph's padded destinations none."""
    g = torch.Generator().manual_seed(seed)
    b, ns, nd, real_ns, real_nd = 2, 40, 33, (40, 31), (33, 27)
    idx = torch.zeros(b, nd, cap, dtype=torch.int64)
    for i in range(b):
        for d in range(nd):
            idx[i, d] = torch.randperm(real_ns[i], generator=g)[:cap]
    valid = torch.rand(b, nd, cap, generator=g) < 0.6
    valid[0, 3] = False
    valid[1, real_nd[1]:] = False
    h_src = torch.randn(b, ns, H, generator=g)
    h_dst = torch.randn(b, nd, H, generator=g)
    x_src = torch.randn(b, ns, 3, generator=g) * 3
    x_dst = torch.randn(b, nd, 3, generator=g) * 3
    return h_src, h_dst, x_src, x_dst, NbrList(idx.to(idx_dtype), valid)


@pytest.mark.parametrize("dtype,tol", [("float32", F32_REL), ("bfloat16", BF16_REL)], ids=["f32", "bf16"])
@pytest.mark.parametrize("cap,idx_dtype", [(24, torch.int64), (5, torch.int32)], ids=["cap24", "cap5"])
def test_list_entry_plain_version(cap, idx_dtype, dtype, tol):
    """EGNNEdge's list form on CPU tensors (egnn_edge_list's plain version):
    bitwise egnn_edge_dense_plain on the list's mask, within 1e-5 of scale
    (f32) or 2e-2 (bf16) of the `nbr` form over the list, zero sums where a
    destination has no valid slot, and no kernel launch counted."""
    hs, hd, xs, xd, nbr = _list_case(cap, idx_dtype, seed=cap)
    mod = EGNNEdge(H, H, torch.Generator().manual_seed(1), use_tanh=True, dtype=dtype)
    before = (egnn_edge.launches, egnn_edge.list_launches)
    with torch.no_grad():
        got = mod.nbr_kernel(hs, hd, xs, xd, nbr)
        mask = nbr.adjacency(hs.shape[1])
        dense = egnn_edge.egnn_edge_dense_plain(*mod._kernel_operands(hs, hd, xs, xd), mask, use_tanh=True,
                                                coords_range=mod.coords_range, compute_dtype=mod.cd)
        want = mod.nbr(hs, hd, xs, xd, nbr.idx.long(), nbr.valid)
    assert (egnn_edge.launches, egnn_edge.list_launches) == before
    assert int(mask.sum()) == int(nbr.valid.sum()) > 0
    for g_, d_, w_, part in zip(got, dense, want, ("agg_h", "agg_x")):
        assert g_.dtype == torch.float32 and torch.isfinite(g_).all()
        assert torch.equal(g_, d_), part
        err = rel_max(g_, w_)
        assert err <= tol, f"{part}: {err:.3e} of scale"
        assert not g_[0, 3].any() and not g_[1, 27:].any(), f"{part}: sums without a valid slot"


@pytest.mark.parametrize("case,exc", [("cap0", ValueError), ("idx_float", TypeError), ("idx_shape", ValueError),
                                      ("valid_dtype", TypeError)])
def test_list_entry_refuses_what_the_kernel_does_not_take(case, exc):
    """egnn_edge_list checks the list before any work: cap >= 1, an integer
    index of the destinations' shape, a bool `valid` of the index's shape."""
    hs, hd, xs, xd, (idx, valid) = _list_case(5, torch.int32, seed=0)
    mod = EGNNEdge(H, H, torch.Generator().manual_seed(1), dtype="float32")
    if case == "cap0":
        idx, valid = idx[..., :0], valid[..., :0]
    elif case == "idx_float":
        idx = idx.float()
    elif case == "idx_shape":
        idx = idx[:, 1:]
    elif case == "valid_dtype":
        valid = valid.to(torch.uint8)
    with pytest.raises(exc), torch.no_grad():
        egnn_edge.egnn_edge_list(*mod._kernel_operands(hs, hd, xs, xd), idx, valid, use_tanh=False,
                                 coords_range=10.0, compute_dtype=torch.float32)


def test_kernel_route_reads_the_list(monkeypatch):
    """egnn_all_atom's dynamics under no_grad on a faked kernel device (the
    kernel launch stubbed): compact_kk's neighbor list reaches every conv
    layer's edge_kk as the list form, the list goes to the kernel as int32
    (cast once a call: every layer gets the same tensor), no (B, K, K) mask
    is built (`NbrList.adjacency` is never called), and the launches count
    n_layers in the list mode of 4 n_layers in all."""
    model, enc, kk = _all_atom_list(dtype="bfloat16")
    fake_kernel_device(monkeypatch)
    monkeypatch.setattr(egnn_edge, "kernel_device", lambda device: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    for name in ("launches", "captured", "list_launches", "list_captured"):
        monkeypatch.setattr(egnn_edge, name, 0)
    modes, lists = [], []  # the lists kept alive: one tensor, not one equal copy a layer

    def launch(clocks, args, edges, lda, use_tanh, coords_range, compute_dtype):
        modes.append("list" if len(edges) == 2 else "dense")
        if len(edges) == 2:
            assert edges[0].dtype == torch.int32 and edges[0].shape == kk.idx.shape
            lists.append(edges[0])
        b, nd = args[1].shape[:2]
        return torch.zeros(b, nd, args[0].shape[-1]), torch.zeros(b, nd, 3)

    def no_mask(self, n_src):
        raise AssertionError("a (B, K, K) mask was built on the kernel route")

    monkeypatch.setattr(egnn_edge, "_launch", launch)
    monkeypatch.setattr(NbrList, "adjacency", no_mask)
    calls = KKCalls(model)
    _dynamics_call(model, enc, kk)
    assert calls.only("list", N_LAYERS), calls.calls
    assert modes.count("list") == N_LAYERS and len(modes) == 4 * N_LAYERS
    assert all(t is lists[0] for t in lists)
    assert (egnn_edge.launches, egnn_edge.list_launches, egnn_edge.captured) == (4 * N_LAYERS, N_LAYERS, 0)


def test_graph_replays_count_list_launches(monkeypatch):
    """A chain graph adds the list-mode launches it captured to
    egnn_edge.list_launches at each replay, beside all its launches."""
    monkeypatch.setattr(egnn_edge, "launches", 0)
    monkeypatch.setattr(egnn_edge, "list_launches", 0)
    entry = ChainGraph(key=(), static={}, graph=types.SimpleNamespace(replay=lambda: None), launches=24,
                       list_launches=6)
    for _ in range(3):
        entry.replay()
    assert (egnn_edge.launches, egnn_edge.list_launches, entry.replays) == (72, 18, 3)


@pytest.mark.card
def test_list_mode_against_mask_mode_on_the_card(card):  # noqa: F811
    """The all-atom cell's shapes (B=32, K=384, molgen pockets' rr list at
    cap 24, width 257, bf16): the list mode on the list sorted to ascending
    sources bitwise equal to the mask mode on its mask (the same tiles in the
    same order); on the list nearest first (the sums in another order) within
    2e-2 of scale of it."""
    h = 257
    x, mask, adj, kk = cell_pockets(card, seed=7)
    b, k = mask.shape
    g = torch.Generator(device=card).manual_seed(5)
    hs = torch.randn(b, k, h, generator=g, device=card) * mask[..., None]
    mod = EGNNEdge(h, h, torch.Generator().manual_seed(6), use_tanh=True, dtype="bfloat16").to(card)
    order = torch.where(kk.valid, kk.idx, k).argsort(dim=-1)
    ascending = NbrList(kk.idx.gather(-1, order), kk.valid.gather(-1, order))
    assert torch.equal(ascending.adjacency(k), adj)
    with torch.no_grad():
        want = mod.kernel(hs, hs, x, x, adj)
        got = mod.nbr_kernel(hs, hs, x, x, ascending)
        near = mod.nbr_kernel(hs, hs, x, x, kk)
    torch.cuda.synchronize()
    for g_, n_, w_, part in zip(got, near, want, ("agg_h", "agg_x")):
        assert torch.equal(g_, w_), f"{part}: the list mode on ascending sources differs from the mask mode"
        err = rel_max(n_, w_)
        assert err <= BF16_REL, f"{part}: {err:.3e} of scale"
