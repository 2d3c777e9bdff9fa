"""The route of the EGNN dynamics' kk edges and the serving layer's count of
a kk neighbor list (kpdiff_tpu_torch/models/dynamics_egnn.py, serve.py):
which form of its kk module each conv layer calls (edge_kk's `nbr` form
over the neighbor list, its `nbr_kernel` form, the kernel's list mode over
the same list, or its `dense` form over the block layout's windows or a
dense grid), the serving counter serve.chunks_kk_<layout>,
and serve.kk_nbr_slots and serve.kk_nbr_edges, which count, for each chunk
whose kk is a neighbor list, the slots the list computes and the valid
edges among them, each times the chain's steps.

Where the edge kernel runs and nothing records autograd, the dynamics
hands a neighbor-list kk to edge_kk as a `KernelList`, which runs its
`nbr_kernel` form (`egnn_edge_list`); elsewhere as a `NbrList`, run by
`nbr`. The
cases here check the list's mask (`NbrList.adjacency`, which the list
entry's plain version runs) against the rr radius graph and the list's
edge count, one dynamics call on either route, and the counters
dynamics.kk_route_kernel / dynamics.kk_route_list. The CPU cases make the
dynamics see a kernel device by patching its `kernel_device`;
`egnn_edge_dense` and `egnn_edge_list` then run their plain versions. The
case marked `card` runs the kernel at the all-atom cell's shapes and skips
without a card.

`egnn_all_atom` (a fixed encoder: the pocket atoms are the keypoints, kk
the rr radius graph in the block layout, which compact_kk turns into a
neighbor list) and the flagship `egnn_40kp` (a learned encoder and a dense
kk) at a tiny width on the CPU. This file imports no JAX, so that it runs
on the card as it is: `python3 -m pytest --noconftest -m card
tests/test_torch_port_kk_route.py`.
"""
from __future__ import annotations

import copy
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from kpdiff_tpu_torch.config import PaddingConfig, dump_yaml, load_config, model_from_config, resolve_feature_sizes
from kpdiff_tpu_torch.data.padding import pad_item, to_complex
from kpdiff_tpu_torch.models import dynamics_egnn
from kpdiff_tpu_torch.models.egnn import EGNNEdge
from kpdiff_tpu_torch.ops.cuda import egnn_edge
from kpdiff_tpu_torch.ops.edge_sets import Blocks, KernelList, NbrList
from kpdiff_tpu_torch.ops.neighbors import dense_radius_adjacency, radius_neighbor_list
from kpdiff_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
ROUTES = ("dense", "nbr", "block", "list")
COUNTERS = ("dynamics.kk_route_kernel", "dynamics.kk_route_list")
N_LAYERS = 2
N_REC = 64
RR = 3.5
BF16_REL = 2e-2


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


def _config(name: str, dtype: str = "float32"):
    """configs/<name>.yml at width 16, two layers, 64 receptor slots (6 keypoints for a learned encoder)."""
    cfg = copy.deepcopy(load_config(ROOT / "configs" / f"{name}.yml"))
    cfg["padding"]["n_rec"] = N_REC
    cfg["dynamics"].update(n_layers=N_LAYERS, hidden_nf=16, compute_dtype=dtype)
    if cfg["diffusion"]["rec_encoder_type"] == "learned":
        cfg["graph"]["n_keypoints"] = 6
        cfg["rec_encoder"].update(n_convs=1, hidden_n_node_feat=16, out_n_node_feat=16, compute_dtype="float32")
    return cfg


def _pocket(seed: int = 0, n_rec: int = 40, n_lig: int = 9):
    """A pocket of `n_rec` atoms on a jittered 1.8 Å grid (degrees at 3.5 Å
    like a protein's) with no pair within 1e-3 Å of the rr cutoff, and an
    empty ligand of `n_lig` atoms."""
    rng = np.random.default_rng(seed)
    axis = np.arange(4) * 1.8
    grid = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), -1).reshape(-1, 3)
    while True:
        pos = (grid[rng.choice(len(grid), n_rec, replace=False)] + rng.uniform(-0.5, 0.5, (n_rec, 3))).astype(
            np.float32)
        d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
        if not np.any(np.abs(d - 3.5) < 1e-3):
            break
    feat = np.zeros((n_rec, 10), np.float32)
    feat[np.arange(n_rec), rng.integers(0, 4, n_rec)] = 1.0
    return dict(rec_pos=pos, rec_feat=feat, rec_res_idx=np.arange(n_rec, dtype=np.int32),
                interface_points=np.zeros((0, 3), np.float32), n_lig=n_lig, dist=d)


def _complex(cfg, pocket, b: int = 2):
    pad = dataclasses.replace(PaddingConfig.from_config(cfg), n_lig=16)
    n = pocket["n_lig"]
    item = dict(lig_pos=np.zeros((n, 3), np.float32), lig_feat=np.zeros((n, 10), np.float32),
                **{k: pocket[k] for k in ("rec_pos", "rec_feat", "rec_res_idx", "interface_points")})
    items = [pad_item(item, pad, n_lig_feat_out=10)] * b
    return to_complex(items, pad, resolve_feature_sizes(cfg)[2], None, device="cpu")


class KKCalls:
    """Calls of the forms of every conv layer's edge_kk by route: `nbr` is
    the neighbor list, `list` the kernel's list mode over it (`nbr_kernel`);
    `dense` takes the block layout's windows (3 * tile sources to tile
    destinations) or a dense square grid."""

    def __init__(self, model):
        self.calls = dict.fromkeys(ROUTES, 0)
        for name, mod in model.dynamics.named_modules():
            if name.rsplit(".", 1)[-1] == "edge_kk":
                mod.nbr = self._counted(mod.nbr, lambda adj: "nbr")
                mod.nbr_kernel = self._counted(mod.nbr_kernel, lambda adj: "list")
                mod.dense = self._counted(mod.dense, lambda adj: "dense" if adj.shape[-2] == adj.shape[-1]
                                          else "block")

    def _counted(self, form, route):
        def call(*args, **kw):
            self.calls[route(args[4])] += 1
            return form(*args, **kw)
        return call

    def only(self, route, n):
        return self.calls == {r: n if r == route else 0 for r in ROUTES}


def _one_call(model, cpx, kk):
    """One dynamics call on the encoded complex with the kk structure `kk`."""
    b = cpx.batch_size
    with torch.no_grad():
        model._apply_dynamics(model.dynamics, cpx.lig_x, cpx.lig_h, cpx.lig_mask, cpx.kp_x, cpx.kp_h, cpx.kp_mask,
                              torch.full((b,), 0.5), kk)


@pytest.mark.parametrize("compact", [True, False], ids=["after_compact_kk", "block_layout"])
def test_all_atom_kk_route(compact):
    """egnn_all_atom: the encoder's block layout reaches the conv layers as
    blocks; after compact_kk, as a neighbor list (cap below the 64 slots)."""
    cfg = _config("egnn_all_atom")
    model = model_from_config(cfg, device="cpu", seed=0).eval()
    calls = KKCalls(model)
    with torch.no_grad():
        enc, kk = model.encode(_complex(cfg, _pocket()))
        assert isinstance(kk, Blocks)
        if compact:
            kk = model.compact_kk(enc, kk)
            assert isinstance(kk, NbrList) and kk.idx.shape[-1] < N_REC
    _one_call(model, enc, kk)
    assert calls.only("nbr" if compact else "block", N_LAYERS), calls.calls


def test_flagship_kk_route_is_dense():
    """egnn_40kp: a learned encoder's kk stays dense through compact_kk (6
    keypoints, all within the 8 Å kk cutoff)."""
    cfg = _config("egnn_40kp")
    model = model_from_config(cfg, device="cpu", seed=0).eval()
    with torch.no_grad():
        enc, kk = model.encode(_complex(cfg, _pocket()))
        kk = model.compact_kk(enc, kk)
    assert torch.is_tensor(kk)
    calls = KKCalls(model)
    _one_call(model, enc, kk)
    assert calls.only("dense", N_LAYERS), calls.calls


def _sampler(tmp_path, name: str, batch_size: int, steps: int):
    from kpdiff_tpu_torch.serve import KeypointSampler

    path = tmp_path / f"{name}.yml"
    path.write_text(dump_yaml(_config(name)))
    return KeypointSampler.from_params(path, None, batch_size=batch_size, device="cpu", seed=3, sample_steps=steps,
                                       lig_buckets=[16, 48])


def _request(sampler, pocket, n_mols: int):
    return sampler.sample_for_arrays(
        rec_pos=pocket["rec_pos"], rec_feat=pocket["rec_feat"], rec_res_idx=pocket["rec_res_idx"],
        interface_points=pocket["interface_points"], init_com=pocket["rec_pos"].mean(0), n_mols=n_mols,
        ligand_size=pocket["n_lig"])


def test_kk_nbr_counters_by_hand(tracer, tmp_path):
    """One request of one ligand (one chunk of 2 rows, the second a repeat)
    and a 3-step chain: slots = rows x 64 keypoint slots x cap x steps, cap
    the pocket's largest rr degree rounded up to 8; edges = rows x the
    pocket's directed rr pairs x steps; one kk module call per layer and step."""
    pocket = _pocket(seed=1)
    d = pocket["dist"]
    adj = (d < 3.5) & ~np.eye(len(d), dtype=bool)
    deg = int(adj.sum(1).max())
    cap = max(-(-deg // 8) * 8, 8)
    sampler = _sampler(tmp_path, "egnn_all_atom", batch_size=2, steps=3)
    calls = KKCalls(sampler.model)
    _request(sampler, pocket, n_mols=1)
    c = tracer.snapshot()["counters"]
    assert sampler.last_request["chunks"][0]["kk"] == f"nbr{cap}" and c[f"serve.chunks_kk_nbr{cap}"] == 1
    assert c["serve.kk_nbr_slots"] == 2 * N_REC * cap * 3
    assert c["serve.kk_nbr_edges"] == 2 * int(adj.sum()) * 3
    assert calls.only("nbr", N_LAYERS * 3), calls.calls


def test_dense_kk_counts_no_list(tracer, tmp_path):
    """The flagship's dense kk: no neighbor-list counters, the dense route per layer and step."""
    sampler = _sampler(tmp_path, "egnn_40kp", batch_size=2, steps=3)
    calls = KKCalls(sampler.model)
    _request(sampler, _pocket(seed=2), n_mols=2)
    c = tracer.snapshot()["counters"]
    assert sampler.last_request["chunks"][0]["kk"] == "dense" and c["serve.chunks_kk_dense"] == 1
    assert "serve.kk_nbr_slots" not in c and "serve.kk_nbr_edges" not in c
    assert calls.only("dense", N_LAYERS * 3), calls.calls


def rel_max(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-30))


def _all_atom_list(seeds=(0, 4), n_recs=(40, 27), dtype: str = "float32"):
    """An egnn_all_atom model and one batch of its pockets (one per seed, each
    of its n_rec atoms in 64 slots, the rest padded keypoints), encoded, with
    compact_kk's neighbor list."""
    cfg = _config("egnn_all_atom", dtype)
    model = model_from_config(cfg, device="cpu", seed=0).eval()
    pad = dataclasses.replace(PaddingConfig.from_config(cfg), n_lig=16)
    items = []
    for seed, n_rec in zip(seeds, n_recs):
        p = _pocket(seed, n_rec=n_rec)
        rng = np.random.default_rng(seed + 100)
        lig = (p["rec_pos"].mean(0) + rng.normal(size=(9, 3)) * 2).astype(np.float32)
        item = dict(lig_pos=lig, lig_feat=np.eye(10, dtype=np.float32)[rng.integers(0, 10, 9)],
                    **{k: p[k] for k in ("rec_pos", "rec_feat", "rec_res_idx", "interface_points")})
        items.append(pad_item(item, pad, n_lig_feat_out=10))
    cpx = to_complex(items, pad, resolve_feature_sizes(cfg)[2], None, device="cpu")
    with torch.no_grad():
        enc, kk = model.encode(cpx)
        kk = model.compact_kk(enc, kk)
    assert isinstance(kk, NbrList) and kk.idx.shape[-1] < N_REC
    return model, enc, kk


def _alias_a_padded_slot(idx, valid):
    """The list with one slot that is not valid pointing at a real neighbour
    of its own row (a scatter that wrote `valid` would clear that edge)."""
    idx = idx.clone()
    row = torch.nonzero(valid.any(-1) & ~valid.all(-1))[0]
    slots = valid[row[0], row[1]]
    first_valid, first_pad = int(torch.nonzero(slots)[0]), int(torch.nonzero(~slots)[-1])
    idx[row[0], row[1], first_pad] = idx[row[0], row[1], first_valid]
    return idx


@pytest.mark.parametrize("alias", [False, True], ids=["as_built", "padded_slot_aliases_a_neighbour"])
def test_list_mask_is_the_radius_graph(alias):
    """compact_kk's neighbor list scattered into (B, K, K) is the rr radius
    graph without self edges, padded keypoints included (no edge to or from
    them); a slot that is not valid adds and clears nothing, even where its
    index names a real neighbour of its row."""
    model, enc, (idx, valid) = _all_atom_list()
    if alias:
        idx = _alias_a_padded_slot(idx, valid)
    mask = NbrList(idx, valid).adjacency(N_REC)
    want = dense_radius_adjacency(enc.kp_x, enc.kp_mask, enc.kp_x, enc.kp_mask, RR, exclude_self=True)
    assert not bool(enc.kp_mask.all())
    assert mask.shape == want.shape == (2, N_REC, N_REC) and mask.is_contiguous()
    assert torch.equal(mask, want)
    assert int(want.sum()) > 0


def test_list_mask_counts_the_list_edges():
    """Each destination's edge count in the mask (summed over its sources)
    equals the list's valid slots of that row: message_norm's kk count, read
    from `valid`, is the mask's count too."""
    _, _, (idx, valid) = _all_atom_list(seeds=(1, 2, 3), n_recs=(40, 33, 12))
    mask = NbrList(idx, valid).adjacency(N_REC)
    assert torch.equal(torch.sum(mask, dim=1), torch.sum(valid, dim=-1))
    assert torch.equal(torch.sum(mask, dim=(1, 2)), torch.sum(valid, dim=(1, 2)))


def _dynamics_call(model, enc, kk, grad: bool = False):
    b = enc.batch_size
    with torch.set_grad_enabled(grad):
        return model._apply_dynamics(model.dynamics, enc.lig_x, enc.lig_h, enc.lig_mask, enc.kp_x, enc.kp_h,
                                     enc.kp_mask, torch.full((b,), 0.5), kk)


def fake_kernel_device(monkeypatch):
    """The dynamics sees a kernel device on CPU tensors: it alone decides the
    route, and EGNNEdge follows the form it hands in."""
    monkeypatch.setattr(dynamics_egnn, "kernel_device", lambda device: True)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", BF16_REL)], ids=["f32", "bf16"])
def test_mask_route_matches_the_list_route(monkeypatch, dtype, tol):
    """One EGNNDynamics call (update_kp_feat, compact_kk's list) on the
    kernel's route (kernel device patched in: edge_kk's list form, the list
    entry's plain version) against the same call on the list route (nbr),
    within 1e-4 of scale in f32 and 2e-2 in bf16."""
    model, enc, kk = _all_atom_list(dtype=dtype)
    calls = KKCalls(model)
    want = _dynamics_call(model, enc, kk)
    assert calls.only("nbr", N_LAYERS), calls.calls
    fake_kernel_device(monkeypatch)
    calls = KKCalls(model)
    got = _dynamics_call(model, enc, kk)
    assert calls.only("list", N_LAYERS), calls.calls
    for g_, w_, part in zip(got, want, ("eps_h", "eps_x")):
        assert torch.isfinite(g_).all()
        err = rel_max(g_, w_)
        assert err <= tol, f"{part}: {err:.3e} of scale"


def _counters(tracer):
    return {name: tracer.snapshot()["counters"].get(name, 0) for name in COUNTERS}


@pytest.mark.parametrize("case", ["kernel_no_grad", "kernel_autograd", "cpu", "dense_kk"])
def test_kk_route_counters(tracer, monkeypatch, case):
    """dynamics.kk_route_kernel / kk_route_list count n_layers a call of a
    neighbor-list kk by route: the kernel's where the kernel runs and nothing
    records autograd, the list's under autograd or on the CPU; a dense kk
    counts on neither."""
    model, enc, kk = _all_atom_list()
    if case.startswith("kernel"):
        fake_kernel_device(monkeypatch)
    if case == "dense_kk":
        kk = dense_radius_adjacency(enc.kp_x, enc.kp_mask, enc.kp_x, enc.kp_mask, RR, exclude_self=True)
    _dynamics_call(model, enc, kk, grad=case == "kernel_autograd")
    want = {"kernel_no_grad": (N_LAYERS, 0), "kernel_autograd": (0, N_LAYERS), "cpu": (0, N_LAYERS),
            "dense_kk": (0, 0)}[case]
    assert _counters(tracer) == dict(zip(COUNTERS, want))


def cell_pockets(card, seed: int = 20231122):
    """The all-atom cell's shapes on the card: B=32 molgen pockets of
    K=384 slots (13-32 residues of four atoms), their positions, mask and
    rr radius graph as a neighbor list at cap 24, nearest first."""
    from portbench.traffic.molgen import complex_of_size

    b, k, cap = 32, 384, 24
    rng = np.random.default_rng(seed)
    x = torch.zeros(b, k, 3)
    mask = torch.zeros(b, k, dtype=torch.bool)
    for i in range(b):
        pos = complex_of_size(rng, int(rng.integers(13, 33)), ["C", "N", "O", "S"], 4)["rec_pos"]
        x[i, :len(pos)], mask[i, :len(pos)] = torch.from_numpy(pos), True
    x, mask = x.to(card), mask.to(card)
    adj = dense_radius_adjacency(x, mask, x, mask, RR, exclude_self=True)
    assert int(adj.sum(1).max()) <= cap
    idx, valid = radius_neighbor_list(x, mask, x, mask, RR, cap, exclude_self=True)
    assert torch.equal(NbrList(idx, valid).adjacency(k), adj)
    return x, mask, adj, NbrList(idx, valid)


@pytest.mark.card
def test_all_atom_shapes_on_the_card(card):
    """The kernel route at the all-atom cell's shapes (B=32, K=384, the rr
    list of molgen pockets at cap 24, width 257, bf16): edge_kk over the
    list, handed in as the dynamics' kernel route hands it (a KernelList),
    through the kernel's list mode against its `nbr` form over the list
    in f32 on the same parameters, within 2e-2 of scale; two launches on the
    same inputs bitwise equal, each counted as a list-mode launch."""
    h = 257
    x, mask, _, kk = cell_pockets(card)
    b, k = mask.shape
    g = torch.Generator(device=card).manual_seed(3)
    hs = torch.randn(b, k, h, generator=g, device=card) * mask[..., None]
    mod = EGNNEdge(h, h, torch.Generator().manual_seed(4), use_tanh=True, dtype="bfloat16").to(card)
    ref = EGNNEdge(h, h, torch.Generator(), use_tanh=True, dtype="float32").to(card)
    ref.load_state_dict(mod.state_dict())
    with torch.no_grad():
        want = ref.nbr(hs, hs, x, x, kk.idx, kk.valid)
        before, list_before = egnn_edge.launches, egnn_edge.list_launches
        on_route = KernelList(kk.idx.to(torch.int32), kk.valid)  # as the dynamics hands it on the kernel's route
        got, again = mod(hs, hs, x, x, on_route), mod(hs, hs, x, x, on_route)
    torch.cuda.synchronize()
    assert egnn_edge.launches == before + 2 and egnn_edge.list_launches == list_before + 2
    for g_, a_, w_, part in zip(got, again, want, ("agg_h", "agg_x")):
        assert torch.equal(g_, a_), f"{part}: two launches differ"
        err = rel_max(g_, w_)
        assert err <= BF16_REL, f"{part}: {err:.3e} of scale"
