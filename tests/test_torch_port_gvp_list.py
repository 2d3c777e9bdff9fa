"""The GVP message kernel's function over destination-major lists
(kpdiff_tpu_torch/ops/cuda/gvp_message.py) and its route in the GVP dynamics.

`gvp_message_list_plain`, the kernel's CPU version (node projection, then the
chain on every slot, then the masked sum or mean), against
GVPEdgeMessages.nbr and GVPEdgeMessages.pairs(anchor_is_src=False) (the lk
pairs): sum and mean, caps 7, 24 and 40, rows without a valid slot and a
batch row without any, f32 within 1e-5 and bf16 within 2e-2 of the output's
scale. The kernel's weight images round-trip. On CPU tensors GVPDynamics
takes the plain route (the list and pairs counters count, the kernel's stay
0); with the card faked (`dynamics_gvp.kernel_device`) it hands the kk list
and both directions of the kNN pairs on as KernelLists, which run the plain
version here, and agrees bitwise with the plain route. The chain is the dynamics' (S 256, V 16, three GVPs) at a few
nodes.

On the card (marked `card`): python3 -m pytest --noconftest -m card
tests/test_torch_port_gvp_list.py
"""
from __future__ import annotations

import pytest
import torch

import kpdiff_tpu_torch.models.dynamics_gvp as dynamics_gvp
from kpdiff_tpu_torch.models.dynamics_gvp import GVPDynamics
from kpdiff_tpu_torch.models.gvp import GVPEdgeMessages
from kpdiff_tpu_torch.ops.cuda import gvp_message
from kpdiff_tpu_torch.ops.edge_sets import KernelList, NbrList
from kpdiff_tpu_torch.utils import profiling

S, V = gvp_message.S_WIDTH, gvp_message.V_WIDTH
F32_REL = 1e-5
BF16_REL = 2e-2


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


def _list(gen, b, nd, ns, cap, device="cpu"):
    """A list with distinct sources a row, about half its slots valid, a row
    without a valid slot and a batch row without any."""
    idx = torch.stack([torch.randperm(ns, generator=gen)[:cap] for _ in range(b * nd)]).reshape(b, nd, cap)
    valid = torch.rand(b, nd, cap, generator=gen) < 0.5
    valid[0, 1] = False
    valid[-1] = False
    return idx.to(device), valid.to(device)


def _module(agg, dtype, seed=0, device="cpu"):
    return GVPEdgeMessages(S, V, torch.Generator().manual_seed(seed), agg=agg, dtype=dtype).to(device)


def _plain(m, h, v, x_s, x_d, idx, valid):
    layers, node_w, _ = m._kernel_weights()
    return gvp_message.gvp_message_list_plain(
        gvp_message.node_rows(h, v, node_w), x_s, x_d, layers, idx, valid, mean=m.agg == "mean",
        rbf_dmax=m.rbf_dmax, compute_dtype=m.message.gvp0.cd)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("agg", ["sum", "mean"])
@pytest.mark.parametrize("cap", [7, 24, 40])
def test_plain_list_matches_nbr(dtype, agg, cap):
    gen = torch.Generator().manual_seed(cap)
    b, ns, nd = 2, 48, 9
    h, v, x_s = _nodes(gen, b, ns)
    x_d = 3.0 * torch.randn(b, nd, 3, generator=gen)
    idx, valid = _list(gen, b, nd, ns, cap)
    m = _module(agg, dtype)
    with torch.no_grad():
        got = _plain(m, h, v, x_s, x_d, idx, valid)
        ref = m.nbr(h, v, x_s, h[:, :nd], v[:, :nd], x_d, idx, valid)
    assert _rel(got, ref) <= (F32_REL if dtype == "float32" else BF16_REL)
    assert all(float(t[-1].abs().max()) == 0.0 for t in got)  # a batch row without edges sums to zero


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("agg", ["sum", "mean"])
def test_plain_list_matches_lk_pairs(dtype, agg):
    """lk: each keypoint's kNN ligand atoms send to it (pairs with
    anchor_is_src False) is the list with the ligand as sources."""
    gen = torch.Generator().manual_seed(5)
    b, n_lig, k = 3, 12, 10
    h_l, v_l, x_l = _nodes(gen, b, n_lig)
    h_k, v_k, x_k = _nodes(gen, b, k)
    idx, valid = _list(gen, b, k, n_lig, 7)
    m = _module(agg, dtype, seed=1)
    with torch.no_grad():
        got = _plain(m, h_l, v_l, x_l, x_k, idx, valid)
        ref = m.pairs(h_k, v_k, x_k, h_l, v_l, x_l, idx, valid, anchor_is_src=False)
        routed = m(h_l, v_l, x_l, h_k, v_k, x_k, KernelList(idx.to(torch.int32), valid))
    assert _rel(got, ref) <= (F32_REL if dtype == "float32" else BF16_REL)
    assert all(torch.equal(a, c) for a, c in zip(got, routed))


def test_frag_pack_round_trips():
    gen = torch.Generator().manual_seed(2)
    for k, n in ((17, 16), (16, 256), (256, 16), (32, 256)):
        w = torch.randn(k, n, generator=gen)
        words = gvp_message.frag_pack(w)
        assert words.dtype == torch.int32 and words.numel() == -(-k // 16) * 16 * n // 2
        assert torch.equal(gvp_message.frag_unpack(words, k, n), w.to(torch.bfloat16).float())


def test_b128_pack_round_trips_and_swizzles():
    w = torch.randn(S, S, generator=torch.Generator().manual_seed(3))
    img = gvp_message.b128_pack(w)
    assert torch.equal(gvp_message.b128_unpack(img), w.to(torch.bfloat16).float())
    # piece (N half 1, K-block 2), row n = 5 of the half: logical chunk c of its 64 K sits at chunk c ^ 5
    piece = img[(4 + 2) * 64 * 128:(4 + 3) * 64 * 128].reshape(128, 8, 8)
    for c in range(8):
        assert torch.equal(piece[5, c ^ 5], w[2 * 64 + 8 * c:2 * 64 + 8 * c + 8, 128 + 5].to(torch.bfloat16))


def test_pack_weights_round_trip():
    m = _module("mean", "bfloat16", seed=4)
    layers, _, _ = m._kernel_weights()
    pack = gvp_message.pack_weights(layers, m.rbf_dmax)
    out = gvp_message.unpack_weights(pack)
    l0, l1, l2 = layers

    def r(t):
        return t.to(torch.bfloat16).float()

    assert torch.equal(out["wu0"][:17], r(l0.wu)) and not out["wu0"][17:].any()
    assert torch.equal(out["kr0"], r(l0.k[S:S + 16]))
    assert torch.equal(out["kn0"][:17], r(l0.k[S + 16:])) and not out["kn0"][17:].any()
    assert torch.equal(out["g0"], r(l0.g))
    for i, layer in ((1, l1), (2, l2)):
        assert torch.equal(out[f"wh{i}"], r(layer.wh)) and torch.equal(out[f"wu{i}"], r(layer.wu))
        assert torch.equal(out[f"kn{i}"], r(layer.k[S:])) and torch.equal(out[f"g{i}"], r(layer.g))
        assert torch.equal(out[f"big{i}"], r(layer.k[:S]))
    assert torch.equal(out["b"], torch.stack([r(x.b) for x in layers]))
    assert torch.equal(out["gb"], torch.stack([r(x.gb) for x in layers]))
    assert torch.equal(out["wh0"][:17], r(l0.wh[0])) and not out["wh0"][17:].any()
    assert torch.equal(out["mu"], torch.linspace(0.0, m.rbf_dmax, 16))
    assert pack.sigma == m.rbf_dmax / 16


def test_node_rows_hold_the_first_gvps_node_pieces():
    gen = torch.Generator().manual_seed(6)
    h, v, _ = _nodes(gen, 2, 5)
    m = _module("sum", "bfloat16", seed=7)
    layers, node_w, _ = m._kernel_weights()
    rows = gvp_message.node_rows(h, v, node_w)
    bf = torch.bfloat16
    assert rows.shape == (2, 5, gvp_message.NODE_WIDTH) and rows.dtype == bf
    assert torch.equal(rows[..., :S], h.to(bf) @ layers[0].k[:S].to(bf))
    q = torch.einsum("...vc,vh->...hc", v.to(bf), layers[0].wh[1:].to(bf))  # (2, 5, 17, 3)
    got = rows[..., S:].reshape(2, 5, 3, gvp_message.Q_WIDTH)
    assert torch.allclose(got[..., :17].transpose(-1, -2).float(), q.float(), rtol=1e-2, atol=1e-2)
    assert not got[..., 17:].any()


def test_kernel_configuration():
    assert _module("mean", "bfloat16").kernel_ok
    assert not _module("mean", "float32").kernel_ok
    gen = torch.Generator().manual_seed(0)
    assert not GVPEdgeMessages(32, 4, gen, dtype="bfloat16").kernel_ok
    assert not GVPEdgeMessages(S, V, gen, edge_feat_size=8, dtype="bfloat16").kernel_ok


def _dynamics_call(dtype="bfloat16", seed=0):
    """GVPDynamics in the all-atom configuration (update_kp, kl_k 7, mean) at
    S 256, V 16, two convs, on two graphs with a kk neighbor list."""
    gen = torch.Generator().manual_seed(seed)
    dyn = GVPDynamics(10, 10, gen, vector_size=V, n_convs=2, n_hidden_scalars=S, message_norm="mean", update_kp=True,
                      kl_k=7, compute_dtype=dtype)
    b, nl, k, cap = 2, 9, 14, 6
    lig_mask = torch.ones(b, nl, dtype=torch.bool)
    lig_mask[1, 6:] = False
    kp_mask = torch.ones(b, k, dtype=torch.bool)
    kp_mask[1, 10:] = False
    g = torch.Generator().manual_seed(seed + 1)
    idx, valid = _list(g, b, k, k, cap)
    valid &= kp_mask[:, :, None] & torch.gather(kp_mask, 1, idx.reshape(b, -1)).reshape(b, k, cap)
    args = (2.0 * torch.randn(b, nl, 3, generator=g), torch.randn(b, nl, 10, generator=g), lig_mask,
            2.0 * torch.randn(b, k, 3, generator=g), torch.randn(b, k, 10, generator=g), kp_mask,
            torch.rand(b, generator=g))
    kw = dict(kk_edges=NbrList(idx, valid), kp_v=0.3 * torch.randn(b, k, V, 3, generator=g))
    return dyn, args, kw


def test_cpu_takes_the_plain_route(tracer):
    dyn, args, kw = _dynamics_call()
    before = gvp_message.launches, gvp_message.captured
    with torch.no_grad():
        dyn(*args, **kw)
    c = tracer.snapshot()["counters"]
    assert c.get("dynamics.gvp_kk_route_list") == 1 and c.get("dynamics.gvp_lk_route_pairs") == 1
    assert c.get("dynamics.gvp_kl_route_pairs") == 2  # every conv has kl
    assert c.get("dynamics.gvp_kk_route_kernel", 0) == 0 and c.get("dynamics.gvp_lk_route_kernel", 0) == 0
    assert c.get("dynamics.gvp_kl_route_kernel", 0) == 0
    assert (gvp_message.launches, gvp_message.captured) == before
    assert c["gvp_message.launches"] == before[0]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_faked_card_routes_kk_and_lk_through_the_kernel_entry(tracer, monkeypatch, dtype):
    """With the card faked the route hands kl, lk and kk on as KernelLists
    (in bf16 only: an f32 chain is not the kernel's), and the result is the
    plain route's (the entry runs the plain version on CPU tensors), bitwise:
    on the CPU the plain route's kl scatter-add and the list's sum both add
    a ligand atom's messages in keypoint order."""
    dyn, args, kw = _dynamics_call(dtype)
    with torch.no_grad():
        ref = dyn(*args, **kw)
        monkeypatch.setattr(dynamics_gvp, "kernel_device", lambda device: True)
        calls = []
        real = GVPEdgeMessages.nbr_kernel

        def counted(self, *a, **k):
            calls.append(a[-1])
            return real(self, *a, **k)

        monkeypatch.setattr(GVPEdgeMessages, "nbr_kernel", counted)
        got = dyn(*args, **kw)
        with torch.enable_grad():  # autograd recording: the plain route
            dyn(*args, **kw)
    c = tracer.snapshot()["counters"]
    routed = dtype == "bfloat16"
    assert c.get("dynamics.gvp_kk_route_kernel", 0) == (1 if routed else 0)
    assert c.get("dynamics.gvp_lk_route_kernel", 0) == (1 if routed else 0)
    assert c.get("dynamics.gvp_kl_route_kernel", 0) == (2 if routed else 0)
    assert c.get("dynamics.gvp_kk_route_list") == (2 if routed else 3)
    assert c.get("dynamics.gvp_kl_route_pairs") == (4 if routed else 6)
    assert len(calls) == (4 if routed else 0)  # kl in both convs, conv0's lk and kk; conv1 (the last) has neither
    assert all(isinstance(e, KernelList) and e.idx.dtype == torch.int32 for e in calls)
    assert all(torch.equal(a, r) for a, r in zip(got, ref))


def test_kp_sharded_calls_keep_the_plain_route(monkeypatch):
    dyn, args, _ = _dynamics_call()
    monkeypatch.setattr(dynamics_gvp, "kernel_device", lambda device: True)
    with torch.no_grad():
        assert dyn.on_kernel(None, *args)
        assert not dyn.on_kernel(object(), *args)
    assert not dyn.on_kernel(None, *args)  # autograd records


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the GVP message kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("agg", ["sum", "mean"])
@pytest.mark.parametrize("cap", [7, 24, 100])
def test_kernel_matches_nbr_on_the_card(cuda_device, agg, cap):
    gen = torch.Generator().manual_seed(cap)
    b, ns, nd = 4, 120, 90
    h, v, x_s = _nodes(gen, b, ns, cuda_device)
    x_d = (3.0 * torch.randn(b, nd, 3, generator=gen)).to(cuda_device)
    idx, valid = _list(gen, b, nd, ns, cap, cuda_device)
    m = _module(agg, "bfloat16", device=cuda_device)
    edges = KernelList(idx.to(torch.int32).contiguous(), valid)
    with torch.no_grad():
        before = gvp_message.launches
        got = m(h, v, x_s, h[:, :nd], v[:, :nd], x_d, edges)
        again = m(h, v, x_s, h[:, :nd], v[:, :nd], x_d, edges)
        ref = m.nbr(h, v, x_s, h[:, :nd], v[:, :nd], x_d, idx, valid)
    torch.cuda.synchronize()
    assert gvp_message.launches == before + 2
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    assert _rel(got, ref) <= BF16_REL
