"""The route of the EGNN dynamics' kk edges and the serving layer's count of
a kk neighbor list (kpdiff_tpu_torch/models/dynamics_egnn.py, serve.py):
which kk module each conv layer calls (the neighbor-list module kk_nbr, or
edge_kk over the block layout's windows or over a dense grid), the
serving counter serve.chunks_kk_<layout>, and serve.kk_nbr_slots and
serve.kk_nbr_edges, which count, for each chunk whose kk is a neighbor
list, the slots the list computes and the valid edges among them, each
times the chain's steps.

`egnn_all_atom` (a fixed encoder: the pocket atoms are the keypoints, kk
the rr radius graph in the block layout, which compact_kk turns into a
neighbor list) and the flagship `egnn_40kp` (a learned encoder and a dense
kk) at a tiny width on the CPU. This file imports no JAX.
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
from kpdiff_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
ROUTES = ("dense", "nbr", "block")
N_LAYERS = 2
N_REC = 64


@pytest.fixture
def tracer(monkeypatch):
    """A fresh tracer behind the module's functions."""
    tr = profiling.Tracer()
    monkeypatch.setattr(profiling, "TRACER", tr)
    return tr


def _config(name: str):
    """configs/<name>.yml at width 16, two layers, 64 receptor slots (6 keypoints for a learned encoder)."""
    cfg = copy.deepcopy(load_config(ROOT / "configs" / f"{name}.yml"))
    cfg["padding"]["n_rec"] = N_REC
    cfg["dynamics"].update(n_layers=N_LAYERS, hidden_nf=16, compute_dtype="float32")
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
    """Calls of every conv layer's kk modules by route, from forward hooks:
    kk_nbr is the neighbor list; edge_kk takes the block layout's windows
    (3 * tile sources to tile destinations) or a dense square grid."""

    def __init__(self, model):
        self.calls = dict.fromkeys(ROUTES, 0)
        for name, mod in model.dynamics.named_modules():
            if name.rsplit(".", 1)[-1] == "kk_nbr":
                mod.register_forward_hook(self._hook("nbr"))
            elif name.rsplit(".", 1)[-1] == "edge_kk":
                mod.register_forward_hook(lambda m, args, out: self._count(
                    "dense" if args[-1].shape[-2] == args[-1].shape[-1] else "block"))

    def _hook(self, route):
        return lambda m, args, out: self._count(route)

    def _count(self, route):
        self.calls[route] += 1

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
        assert isinstance(kk, dict)
        if compact:
            kk = model.compact_kk(enc, kk)
            assert isinstance(kk, tuple) and kk[0].shape[-1] < N_REC
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
