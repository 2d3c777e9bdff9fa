"""The route of the EGNN dynamics' kNN keypoint-ligand edges
(kpdiff_tpu_torch/models/dynamics_egnn.py): a dense (B, K, Nl) mask through
the edge kernel's entry where the kernel runs and nothing records autograd,
the pair list elsewhere, read from the tracer's counters
dynamics.kl_route_kernel and dynamics.kl_route_pairs; and the mask's edge
set and count against the pair list's.

The CPU cases make the dynamics see a kernel device by patching its
`kernel_device`; `egnn_edge_dense` then runs its plain version. The cases
marked `card` run the kernel at the flagship's shapes and skip without a
card. This file imports no JAX, so that it runs on the card as it is:
`python3 -m pytest --noconftest -m card tests/test_torch_port_kl_route.py`.
"""
from __future__ import annotations

import pytest
import torch

from kpdiff_tpu_torch.models import dynamics_egnn, egnn as tegnn
from kpdiff_tpu_torch.models.dynamics_egnn import EGNNDynamics
from kpdiff_tpu_torch.models.egnn import EGNNEdge
from kpdiff_tpu_torch.ops.cuda import egnn_edge
from kpdiff_tpu_torch.ops.neighbors import dense_knn_adjacency, knn_indices
from kpdiff_tpu_torch.utils import profiling

BF16_REL = 2e-2
ROUTES = ("dynamics.kl_route_kernel", "dynamics.kl_route_pairs")


@pytest.fixture
def tracer(monkeypatch):
    """A fresh tracer behind the module's functions."""
    tr = profiling.Tracer()
    monkeypatch.setattr(profiling, "TRACER", tr)
    return tr


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA edge kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture
def edge_calls(monkeypatch):
    """The calls of the edge kernel's entry, counted (the plain version on the CPU counts no launch)."""
    calls = []

    def counting(*a, **kw):
        calls.append(tuple(a[0].shape[:2]) + (a[1].shape[1],))
        return egnn_edge.egnn_edge_dense(*a, **kw)

    monkeypatch.setattr(tegnn, "egnn_edge_dense", counting)
    return calls


def rel_max(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-30))


def _dynamics(n_layers=2, device="cpu", dtype="float32"):
    gen = torch.Generator().manual_seed(7)
    return EGNNDynamics(10, 12, gen, n_layers=n_layers, hidden_nf=15, use_tanh=True, message_norm=0.0,
                        update_kp_feat=True, norm=True, kl_k=3, compute_dtype=dtype).to(device)


def _inputs(device="cpu", b=2, nl=7, k=6):
    g = torch.Generator().manual_seed(8)
    lig_mask = torch.ones(b, nl, dtype=torch.bool)
    lig_mask[1, 5:] = False
    kp_mask = torch.ones(b, k, dtype=torch.bool)
    kp_mask[0, 4:] = False
    kk = torch.rand(b, k, k, generator=g) < 0.5
    args = (torch.randn(b, nl, 3, generator=g) * 2, torch.randn(b, nl, 10, generator=g), lig_mask,
            torch.randn(b, k, 3, generator=g) * 2, torch.randn(b, k, 12, generator=g), kp_mask,
            torch.rand(b, generator=g), kk & kp_mask[:, :, None] & kp_mask[:, None, :])
    return tuple(a.to(device) for a in args)


def _counters(tracer):
    return {name: tracer.snapshot()["counters"].get(name, 0) for name in ROUTES}


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "autograd"])
def test_cpu_keeps_the_pair_list(tracer, edge_calls, grad):
    """On CPU tensors the kNN edges stay a pair list, recorded or not: the
    kernel's entry sees ll and kk only (and nothing while autograd records)."""
    dyn, args = _dynamics(), _inputs()
    with torch.set_grad_enabled(grad):
        dyn(*args)
    assert _counters(tracer) == {"dynamics.kl_route_kernel": 0, "dynamics.kl_route_pairs": 2 * 2}
    assert len(edge_calls) == (0 if grad else 2 * 2)


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "autograd"])
def test_the_kernel_route_where_the_kernel_runs(tracer, edge_calls, monkeypatch, grad):
    """Where the kernel runs (patched in here) and nothing records autograd,
    kl and lk go through the kernel's entry as a dense mask, two calls a
    layer beside ll and kk, with the pair list's outputs; under autograd the
    pair list stays."""
    dyn, args = _dynamics(), _inputs()
    with torch.no_grad():
        want = dyn(*args)  # the pair list
    before = _counters(tracer)
    edge_calls.clear()
    monkeypatch.setattr(dynamics_egnn, "kernel_device", lambda device: True)
    with torch.set_grad_enabled(grad):
        got = dyn(*args)
    added = {name: n - before[name] for name, n in _counters(tracer).items()}
    if grad:
        assert added == {"dynamics.kl_route_kernel": 0, "dynamics.kl_route_pairs": 2 * 2}
        assert edge_calls == []
        return
    assert added == {"dynamics.kl_route_kernel": 2 * 2, "dynamics.kl_route_pairs": 0}
    b, nl, k = 2, 7, 6
    assert edge_calls == [(b, nl, nl), (b, k, nl), (b, nl, k), (b, k, k)] * 2  # ll, kl, lk, kk a layer
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=1e-5, atol=1e-5)


def _kl_points(case):
    """Keypoints, ligand atoms and their masks."""
    g = torch.Generator().manual_seed(6)
    kp, lig = torch.randn(3, 8, 3, generator=g) * 3, torch.randn(3, 11, 3, generator=g) * 3
    kp_mask, lig_mask = torch.ones(3, 8, dtype=torch.bool), torch.ones(3, 11, dtype=torch.bool)
    if case == "kp_masked":
        kp_mask[0, 6:] = False
        kp_mask[2, :3] = False
    if case == "few_ligand_atoms":
        lig_mask[1, 3:] = False  # 3 valid atoms, k 5
        lig_mask[2, 7:] = False
    return kp, kp_mask, lig, lig_mask


@pytest.mark.parametrize("case", ["all_valid", "kp_masked", "few_ligand_atoms"])
def test_knn_mask_per_src_marks_the_pair_list(case):
    """dense_knn_adjacency(kp, lig, k, per='src') marks exactly the pairs of
    knn_indices(lig, kp, k) scattered into (B, K, Nl), with the keypoint
    mask applied: the dynamics' two forms of the kl edges."""
    kp, kp_mask, lig, lig_mask = _kl_points(case)
    adj = dense_knn_adjacency(kp, kp_mask, lig, lig_mask, 5, per="src")
    idx, _, valid = knn_indices(lig, lig_mask, kp, kp_mask, 5)
    valid = valid & kp_mask[:, :, None]
    want = torch.zeros(adj.shape, dtype=torch.int64).scatter_add_(-1, idx, valid.long())
    assert int(want.max()) <= 1
    assert torch.equal(adj, want.bool())


@pytest.mark.parametrize("case", ["all_valid", "kp_masked", "few_ligand_atoms"])
def test_knn_mask_counts_the_pair_list_edges(case):
    """The mask's edge count per complex equals the pair list's valid count,
    so the message_norm 0 normaliser z of the dynamics does not change."""
    kp, kp_mask, lig, lig_mask = _kl_points(case)
    adj = dense_knn_adjacency(kp, kp_mask, lig, lig_mask, 5, per="src")
    _, _, valid = knn_indices(lig, lig_mask, kp, kp_mask, 5)
    e_pairs = torch.sum(valid & kp_mask[:, :, None], dim=(1, 2))
    assert torch.equal(torch.sum(adj, dim=(1, 2)), e_pairs)
    assert int(e_pairs.sum()) > 0


def _pair_module(dtype, h, seed=3, device="cpu"):
    return EGNNEdge(h, h, torch.Generator().manual_seed(seed), use_tanh=True, dtype=dtype).to(device)


@pytest.mark.card
@pytest.mark.parametrize("n_lig", [16, 32, 48])
def test_flagship_shapes_on_the_card(card, n_lig):
    """The kernel route at the flagship's shapes (B=128, K=40, kl_k 5, width
    257, bf16) against the pair list in f32 on the same parameters, kl and
    lk, within 2e-2 of scale; two launches on the same inputs bitwise equal."""
    b, k, h = 128, 40, 257
    g = torch.Generator(device=card).manual_seed(n_lig)
    h_kp, h_lig = (torch.randn(b, n, h, generator=g, device=card) for n in (k, n_lig))
    x_kp, x_lig = (torch.randn(b, n, 3, generator=g, device=card) * 3 for n in (k, n_lig))
    kp_mask = torch.ones(b, k, dtype=torch.bool, device=card)
    lig_mask = torch.arange(n_lig, device=card)[None, :] < torch.randint(
        n_lig // 2, n_lig + 1, (b, 1), generator=g, device=card)
    idx, _, valid = knn_indices(x_lig, lig_mask, x_kp, kp_mask, 5)
    adj = dense_knn_adjacency(x_kp, kp_mask, x_lig, lig_mask, 5, per="src")
    for anchor_is_src in (True, False):
        mod = _pair_module("bfloat16", h, device=card)
        ref = _pair_module("float32", h, device=card)
        with torch.no_grad():
            want = ref.pairs(h_kp, h_lig, x_kp, x_lig, idx, valid, anchor_is_src=anchor_is_src)
            dense = ((h_kp, h_lig, x_kp, x_lig, adj) if anchor_is_src
                     else (h_lig, h_kp, x_lig, x_kp, adj.transpose(1, 2).contiguous()))
            before = egnn_edge.launches
            got, again = mod.kernel(*dense), mod.kernel(*dense)
        torch.cuda.synchronize()
        assert egnn_edge.launches == before + 2
        for g_, a_, w_, part in zip(got, again, want, ("agg_h", "agg_x")):
            assert torch.equal(g_, a_), f"anchor_is_src={anchor_is_src} {part}: two launches differ"
            err = rel_max(g_, w_)
            assert err <= BF16_REL, f"anchor_is_src={anchor_is_src} {part}: {err:.3e} of scale"


@pytest.mark.card
def test_sampling_counters_on_the_card(tracer, card):
    """A no_grad call on the card takes the kernel route; a recorded one the pairs."""
    dyn, args = _dynamics(device=card, dtype="bfloat16"), _inputs(card)
    with torch.no_grad():
        dyn(*args)
    assert _counters(tracer) == {"dynamics.kl_route_kernel": 2 * 2, "dynamics.kl_route_pairs": 0}
    dyn(*args)
    assert _counters(tracer) == {"dynamics.kl_route_kernel": 2 * 2, "dynamics.kl_route_pairs": 2 * 2}
