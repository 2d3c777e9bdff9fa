"""The GVP kl direction as a destination-major list (ops/edge_sets.py::
dst_major) and its route through the message kernel's entry.

The keypoint-anchored kNN pairs (B, K, k), inverted into each ligand atom's
list of keypoint senders (B, Nl, K), hold exactly the pairs' edges: masked
keypoints, ligand atoms with no sender and a batch row with no pairs
included. `gvp_message_list_plain` over that list agrees with
GVPEdgeMessages.pairs(anchor_is_src=True) (sum and mean; f32 within 1e-5 and
bf16 within 2e-2 of the output's scale). With the card faked
(`dynamics_gvp.kernel_device`) GVPDynamics hands kl on as a KernelList in
every conv, with update_kp or without, counts n_convs a call on
dynamics.gvp_kl_route_kernel, and dispatches no scatter_add, index_add or
accumulating index_put under no_grad.

On the card (marked `card`): python3 -m pytest --noconftest -m card
tests/test_torch_port_gvp_kl_list.py
"""
from __future__ import annotations

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import kpdiff_tpu_torch.models.dynamics_gvp as dynamics_gvp
from kpdiff_tpu_torch.models.dynamics_gvp import GVPDynamics
from kpdiff_tpu_torch.models.gvp import GVPEdgeMessages
from kpdiff_tpu_torch.ops.cuda import gvp_message
from kpdiff_tpu_torch.ops.edge_sets import KernelList, NbrList, PairList, dst_major, edge_count, transpose
from kpdiff_tpu_torch.ops.neighbors import knn_indices
from kpdiff_tpu_torch.utils import profiling

S, V = gvp_message.S_WIDTH, gvp_message.V_WIDTH
F32_REL = 1e-5
BF16_REL = 2e-2
ACCUMULATING = ("scatter_add", "scatter_add_", "index_add", "index_add_", "scatter_reduce", "scatter_reduce_")


@pytest.fixture
def tracer(monkeypatch):
    """A fresh tracer behind the module's functions."""
    tr = profiling.Tracer()
    monkeypatch.setattr(profiling, "TRACER", tr)
    return tr


def _rel(got, ref):
    return max(float((g - r).abs().max() / r.abs().max().clamp_min(1e-30)) for g, r in zip(got, ref))


def _nodes(gen, b, n, device="cpu"):
    return (torch.randn(b, n, S, generator=gen).to(device), (0.5 * torch.randn(b, n, V, 3, generator=gen)).to(device),
            (3.0 * torch.randn(b, n, 3, generator=gen)).to(device))


def _kl_pairs(gen, b, k, nl, kl_k, device="cpu"):
    """Each keypoint's kl_k nearest ligand atoms as the dynamics makes them:
    the last keypoints of row 0 and the last ligand atoms of row 1 masked
    out, the ligand atoms far from a cluster of keypoints (so some receive
    nothing), and the last batch row without a valid keypoint."""
    x_l = 2.0 * torch.randn(b, nl, 3, generator=gen)
    x_k = 2.0 * torch.randn(b, k, 3, generator=gen) + 6.0
    lig_mask = torch.ones(b, nl, dtype=torch.bool)
    lig_mask[1, nl - 3:] = False
    kp_mask = torch.ones(b, k, dtype=torch.bool)
    kp_mask[0, k // 2:] = False
    kp_mask[-1] = False
    idx, _, valid = knn_indices(x_l, lig_mask, x_k, kp_mask, kl_k)
    return PairList(idx.to(device), (valid & kp_mask[:, :, None]).to(device)), x_l.to(device), x_k.to(device)


def _edges(idx, valid, kp_major):
    """The set of valid (b, keypoint, ligand atom) edges of a list."""
    b, n, c = idx.shape
    rows = torch.arange(b)[:, None, None].expand(b, n, c)
    own = torch.arange(n)[None, :, None].expand(b, n, c)
    sel = valid.cpu()
    trip = zip(rows[sel].tolist(), own[sel].tolist(), idx.cpu()[sel].tolist())
    return {(r, o, i) if kp_major else (r, i, o) for r, o, i in trip}


@pytest.mark.parametrize("b, k, nl, kl_k", [(3, 14, 9, 5), (2, 40, 16, 7), (4, 24, 12, 3)])
def test_dst_major_holds_exactly_the_pairs_edges(b, k, nl, kl_k):
    pairs, _, _ = _kl_pairs(torch.Generator().manual_seed(k), b, k, nl, kl_k)
    inv = dst_major(pairs, nl)
    assert isinstance(inv, NbrList) and inv.idx.shape == (b, nl, k) and inv.valid.shape == (b, nl, k)
    assert torch.equal(inv.idx, torch.arange(k).expand(b, nl, k))  # every keypoint a slot, in keypoint order
    want = _edges(pairs.idx, pairs.valid, kp_major=True)
    assert _edges(inv.idx, inv.valid, kp_major=False) == want and want
    assert torch.equal(edge_count(inv), edge_count(pairs))  # message_norm 0 reads it
    assert not inv.valid[-1].any()  # the batch row without pairs
    assert not inv.valid.any(dim=2).all()  # a ligand atom with no sender
    assert not inv.valid[0, :, k // 2:].any()  # masked keypoints send nothing
    lk = dst_major(transpose(pairs), nl)  # keypoints receiving: the pairs' own list
    assert lk.idx is pairs.idx and lk.valid is pairs.valid


def test_dst_major_takes_only_pairs():
    with pytest.raises(TypeError, match="PairList"):
        dst_major(torch.ones(1, 2, 2, dtype=torch.bool), 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("agg", ["sum", "mean"])
def test_plain_list_matches_kl_pairs(dtype, agg):
    """kl: each keypoint sends to its kNN ligand atoms (pairs with
    anchor_is_src), summed onto the ligand atoms by scatter-add, is the list
    with the keypoints as sources."""
    gen = torch.Generator().manual_seed(8)
    b, k, nl = 3, 20, 10
    pairs, x_l, x_k = _kl_pairs(gen, b, k, nl, 7)
    h_k, v_k, _ = _nodes(gen, b, k)
    h_l, v_l, _ = _nodes(gen, b, nl)
    m = GVPEdgeMessages(S, V, torch.Generator().manual_seed(2), agg=agg, dtype=dtype)
    inv = KernelList.of(dst_major(pairs, nl))
    layers, node_w, _ = m._kernel_weights()
    with torch.no_grad():
        got = gvp_message.gvp_message_list_plain(
            gvp_message.node_rows(h_k, v_k, node_w), x_k, x_l, layers, inv.idx, inv.valid, mean=agg == "mean",
            rbf_dmax=m.rbf_dmax, compute_dtype=m.message.gvp0.cd)
        ref = m.pairs(h_k, v_k, x_k, h_l, v_l, x_l, pairs.idx, pairs.valid, anchor_is_src=True)
        routed = m(h_k, v_k, x_k, h_l, v_l, x_l, inv)
    assert _rel(got, ref) <= (F32_REL if dtype == "float32" else BF16_REL)
    assert all(torch.equal(a, c) for a, c in zip(got, routed))
    assert all(float(t[-1].abs().max()) == 0.0 for t in got)  # the batch row without pairs


def _dynamics_call(update_kp, seed=0):
    """GVPDynamics at S 256, V 16, three convs, kl_k 5, bf16, on two graphs
    (with update_kp: mean messages and a kk neighbor list; without: sums
    over 10, no kk)."""
    gen = torch.Generator().manual_seed(seed)
    dyn = GVPDynamics(10, 10, gen, vector_size=V, n_convs=3, n_hidden_scalars=S,
                      message_norm="mean" if update_kp else 10.0, update_kp=update_kp, kl_k=5,
                      compute_dtype="bfloat16")
    b, nl, k, cap = 2, 8, 12, 5
    g = torch.Generator().manual_seed(seed + 1)
    lig_mask = torch.ones(b, nl, dtype=torch.bool)
    lig_mask[1, 6:] = False
    kp_mask = torch.ones(b, k, dtype=torch.bool)
    kp_mask[1, 9:] = False
    args = (2.0 * torch.randn(b, nl, 3, generator=g), torch.randn(b, nl, 10, generator=g), lig_mask,
            2.0 * torch.randn(b, k, 3, generator=g), torch.randn(b, k, 10, generator=g), kp_mask,
            torch.rand(b, generator=g))
    kw = dict(kp_v=0.3 * torch.randn(b, k, V, 3, generator=g))
    if update_kp:
        idx = torch.stack([torch.randperm(k, generator=g)[:cap] for _ in range(b * k)]).reshape(b, k, cap)
        valid = torch.rand(b, k, cap, generator=g) < 0.6
        valid &= kp_mask[:, :, None] & torch.gather(kp_mask, 1, idx.reshape(b, -1)).reshape(b, k, cap)
        kw["kk_edges"] = NbrList(idx, valid)
    return dyn, args, kw


@pytest.mark.parametrize("update_kp", [True, False])
def test_faked_card_routes_kl_through_the_kernel_entry(tracer, monkeypatch, update_kp):
    """kl takes the route in every conv whether or not the keypoints update,
    as each ligand atom's keypoint list (B, Nl, K) in int32; the result is
    the plain route's within BF16_REL; the counters count n_convs a call."""
    dyn, args, kw = _dynamics_call(update_kp)
    nl, k = args[0].shape[1], args[3].shape[1]
    with torch.no_grad():
        ref = dyn(*args, **kw)
        monkeypatch.setattr(dynamics_gvp, "kernel_device", lambda device: True)
        calls = []
        real = GVPEdgeMessages.nbr_kernel

        def counted(self, *a, **kwargs):
            calls.append(a[-1])
            return real(self, *a, **kwargs)

        monkeypatch.setattr(GVPEdgeMessages, "nbr_kernel", counted)
        got = dyn(*args, **kw)
    c = tracer.snapshot()["counters"]
    assert c.get("dynamics.gvp_kl_route_pairs") == 3 and c.get("dynamics.gvp_kl_route_kernel") == 3
    kl = [e for e in calls if tuple(e.idx.shape) == (2, nl, k)]
    assert len(kl) == 3 and len(calls) == (3 + 2 + 2 if update_kp else 3)  # with update_kp: lk and kk in 2 convs
    assert all(isinstance(e, KernelList) and e.idx.dtype == torch.int32 and e.idx.is_contiguous() for e in calls)
    assert all(e is kl[0] for e in kl)  # one list a call, shared by every conv
    assert _rel(got, ref) <= BF16_REL


class AccumulatingOps(TorchDispatchMode):
    """The names of the ops dispatched inside that sum into a tensor by index."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name in ACCUMULATING:
            self.seen.append(name)
        elif name in ("index_put", "index_put_", "_index_put_impl_"):
            accumulate = kwargs.get("accumulate", args[3] if len(args) > 3 else False)
            if accumulate:
                self.seen.append(f"{name}(accumulate=True)")
        return func(*args, **kwargs)


@pytest.mark.parametrize("update_kp", [True, False])
def test_faked_card_route_adds_nothing_by_index(monkeypatch, update_kp):
    """The GVP-sampling half of the determinism audit: on the kernel's route a
    dynamics call under no_grad sums no message by index (whose order on the
    card varies from run to run); the plain route does, in its kl pairs."""
    dyn, args, kw = _dynamics_call(update_kp)
    with torch.no_grad():
        dyn(*args, **kw)  # the modules' weight caches
        with AccumulatingOps() as plain:
            dyn(*args, **kw)
        monkeypatch.setattr(dynamics_gvp, "kernel_device", lambda device: True)
        dyn(*args, **kw)
        with AccumulatingOps() as routed:
            dyn(*args, **kw)
    assert "scatter_add_" in plain.seen or "scatter_add" in plain.seen
    assert routed.seen == []


def test_audit_sees_accumulating_index_put():
    """The audit's own check: index_put_ with accumulate and index_add_ show."""
    x = torch.zeros(4)
    with AccumulatingOps() as log:
        x.index_put_((torch.tensor([1, 1]),), torch.ones(2), accumulate=True)
        x.index_add_(0, torch.tensor([0]), torch.ones(1))
        x.index_put_((torch.tensor([2]),), torch.ones(1))
    assert len(log.seen) == 2 and "index_add_" in log.seen


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the GVP message kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("agg", ["sum", "mean"])
def test_kernel_matches_kl_pairs_on_the_card(cuda_device, agg):
    """The kernel on the inverted list (B=4, Nl=48, K=384: most slots
    padding) against the plain kl pairs in bf16, and two launches bitwise."""
    gen = torch.Generator().manual_seed(11)
    b, k, nl = 4, 384, 48
    pairs, x_l, x_k = _kl_pairs(gen, b, k, nl, 7, cuda_device)
    h_k, v_k, _ = _nodes(gen, b, k, cuda_device)
    h_l, v_l, _ = _nodes(gen, b, nl, cuda_device)
    m = GVPEdgeMessages(S, V, torch.Generator().manual_seed(3), agg=agg, dtype="bfloat16").to(cuda_device)
    inv = KernelList.of(dst_major(pairs, nl))
    with torch.no_grad():
        before = gvp_message.launches
        got = m(h_k, v_k, x_k, h_l, v_l, x_l, inv)
        again = m(h_k, v_k, x_k, h_l, v_l, x_l, inv)
        ref = m.pairs(h_k, v_k, x_k, h_l, v_l, x_l, pairs.idx, pairs.valid, anchor_is_src=True)
    torch.cuda.synchronize()
    assert gvp_message.launches == before + 2
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    assert _rel(got, ref) <= BF16_REL
