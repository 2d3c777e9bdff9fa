"""gvp_all_atom, the paper's all-atom GVP baseline, on the port's sampling
path against the benchmark's plain reference
(portbench/reference/model_fixed_gvp.py), and the serving layer's count of
keypoint slots (kpdiff_tpu_torch/serve.py).

A fixed encoder makes every pocket atom a keypoint (a zero kp_v of
vector_size channels), and compact_kk turns the block layout of the kk
edges into the exact rr radius graph as a neighbor list, which
GVPEdgeMessages.nbr averages over (message_norm 'mean'). The reference
takes the same keypoints with kk as the dense rr radius graph, aggregated
in destination blocks. Both run on the program's seeded initialisation
with its matrices doubled: at width 16 the initialisation barely lets the
keypoints reach the ligand (see GAIN).

Serving counts, for every chunk, its keypoint slots (rows run x keypoint
slots x chain steps, serve.kp_slot_steps) and the valid keypoints among
them (the chunk's kp_mask summed on the device, x chain steps,
serve.kp_atom_steps); a learned encoder fills every slot.

The configuration is configs/gvp_all_atom.yml at 16 scalars, 4 vectors and
two convs, 64 receptor slots, on the CPU.
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
from kpdiff_tpu_torch.ops.edge_sets import NbrList
from kpdiff_tpu_torch.ops.neighbors import dense_radius_adjacency
from kpdiff_tpu_torch.utils import profiling
from portbench.reference.model_fixed_gvp import FixedGVPRefModel

ROOT = Path(__file__).resolve().parents[1]
N_REC = 64
RR = 3.5
# At width 16 the initialisation's keypoint features barely reach the ligand
# (every kk edge dropped moves eps by 5e-5 to 4e-4 of its size); with its
# matrices doubled, by 4-5%, so that the comparisons below see the kk.
GAIN = 2.0
F32_REL = 1e-5  # float32 against float32: 2.8e-7 to 1e-6 of scale on these batches
# bfloat16 GVP chains against float32: 8 significant bits, rounded at the
# inputs and weights of every GVP through two convs and the four-GVP noise
# head, read 6.6e-3 to 2.2e-2 of scale over three batches at two t each (the
# EGNN families' 2e-2 does not hold); a kk mean taken as a sum moves the
# float32 reference 5.8e-2 to 2.2e-1, so bfloat16 alone cannot tell it
# apart and the float32 case checks that instead.
BF16_REL = 3e-2


@pytest.fixture
def tracer(monkeypatch):
    """A fresh tracer behind the module's functions."""
    tr = profiling.Tracer()
    monkeypatch.setattr(profiling, "TRACER", tr)
    return tr


def _config(name: str = "gvp_all_atom", dtype: str = "float32"):
    """configs/<name>.yml at 16 scalars, 4 vectors, two convs, 64 receptor slots."""
    cfg = copy.deepcopy(load_config(ROOT / "configs" / f"{name}.yml"))
    cfg["padding"]["n_rec"] = N_REC
    if "dynamics_gvp" in cfg:
        cfg["dynamics_gvp"].update(n_convs=2, n_hidden_scalars=16, vector_size=4, compute_dtype=dtype, dropout=0.0,
                                   kk_block_size=32)
        cfg["rec_encoder_gvp"].update(vector_size=4, dropout=0.0)
    else:
        cfg["graph"]["n_keypoints"] = 6
        cfg["dynamics"].update(n_layers=2, hidden_nf=16, compute_dtype=dtype)
        cfg["rec_encoder"].update(n_convs=1, hidden_n_node_feat=16, out_n_node_feat=16, compute_dtype="float32")
    return cfg


def _pocket(seed: int, n_rec: int):
    """`n_rec` atoms on a jittered 1.8 Å grid (degrees at 3.5 Å like a
    protein's), no pair within 1e-3 Å of the rr cutoff, element one-hots."""
    rng = np.random.default_rng(seed)
    axis = np.arange(4) * 1.8
    grid = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), -1).reshape(-1, 3)
    while True:
        pos = (grid[rng.choice(len(grid), n_rec, replace=False)] + rng.uniform(-0.5, 0.5, (n_rec, 3))).astype(
            np.float32)
        d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
        if not np.any(np.abs(d - RR) < 1e-3):
            break
    feat = np.zeros((n_rec, 10), np.float32)
    feat[np.arange(n_rec), rng.integers(0, 4, n_rec)] = 1.0
    return dict(rec_pos=pos, rec_feat=feat, rec_res_idx=np.arange(n_rec, dtype=np.int32),
                interface_points=np.zeros((0, 3), np.float32))


def _models(dtype: str):
    """The program at `dtype` and the float32 reference on the same weights
    (the program's seeded initialisation, matrices times GAIN)."""
    cfg = _config(dtype=dtype)
    program = model_from_config(cfg, device="cpu", seed=0).eval()
    with torch.no_grad():
        for name, p in program.named_parameters():
            if name.endswith(("kernel", "Wh", "Wu")):
                p.mul_(GAIN)
    ref = FixedGVPRefModel(cfg).load({n: p.detach().numpy() for n, p in program.named_parameters()}).eval()
    return cfg, program, ref


def _encoded(cfg, program, seeds=(0, 4), n_recs=(40, 27)):
    """A batch of the pockets (one per seed, n_rec atoms each in 64 slots)
    with a 9-atom ligand placed about each, encoded, and compact_kk's list."""
    pad = dataclasses.replace(PaddingConfig.from_config(cfg), n_lig=16)
    items = []
    for seed, n_rec in zip(seeds, n_recs):
        p = _pocket(seed, n_rec)
        rng = np.random.default_rng(seed + 100)
        lig = (p["rec_pos"].mean(0) + rng.normal(size=(9, 3)) * 2).astype(np.float32)
        items.append(pad_item(dict(lig_pos=lig, lig_feat=np.eye(10, dtype=np.float32)[rng.integers(0, 10, 9)], **p),
                              pad, n_lig_feat_out=10))
    cpx = to_complex(items, pad, resolve_feature_sizes(cfg)[2], program.kp_vec_dim, device="cpu")
    with torch.no_grad():
        enc, kk = program.encode(cpx)
        kk = program.compact_kk(enc, kk)
    assert isinstance(kk, NbrList) and kk.idx.shape[-1] < N_REC
    assert enc.kp_v.shape == (2, N_REC, 4, 3) and not bool(enc.kp_v.any())
    return enc, kk


def _rr(enc):
    return dense_radius_adjacency(enc.kp_x, enc.kp_mask, enc.kp_x, enc.kp_mask, RR, exclude_self=True)


def rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("dtype,tol", [("float32", F32_REL), ("bfloat16", BF16_REL)], ids=["f32", "bf16"])
def test_dynamics_match_the_reference(dtype, tol):
    """One GVPDynamics call on compact_kk's neighbor list (kk messages
    averaged over each keypoint's valid neighbours) against the reference's
    on the dense rr graph, within `tol` of scale; the reference with the kk
    mean taken as a sum reads more than a thousand times F32_REL away."""
    cfg, program, ref = _models(dtype)
    enc, kk = _encoded(cfg, program)
    assert torch.equal(kk.adjacency(N_REC), _rr(enc))
    t = torch.tensor([0.3, 0.7])
    args = (enc.lig_x, enc.lig_h, enc.lig_mask, enc.kp_x, enc.kp_h, enc.kp_mask, t)
    with torch.no_grad():
        got = program._apply_dynamics(program._sampling_dynamics(), *args, kk, enc.kp_v)
        want = ref.dynamics(*args, _rr(enc), None)
        ref.dynamics.conv0.message_kk.agg = "sum"
        summed = ref.dynamics(*args, _rr(enc), None)
    for g_, w_, s_, part in zip(got, want, summed, ("eps_h", "eps_x")):
        assert torch.isfinite(g_).all()
        assert rel(g_, w_) <= tol, f"{part}: {rel(g_, w_):.3e} of scale"
        assert rel(s_, w_) > 1000 * F32_REL, f"{part}: the kk sum reads {rel(s_, w_):.3e} of scale"


@pytest.mark.parametrize("dtype,tol", [("float32", F32_REL), ("bfloat16", BF16_REL)], ids=["f32", "bf16"])
def test_reverse_step_matches_the_reference(dtype, tol):
    """One reverse step of the program's chain (start_chain with injected
    noise, reverse_step in place) against the reference's reverse_step from
    the same state and noise: the new ligand within `tol` of the size of the
    reference's move by the dynamics, and so the keypoints, which follow
    the ligand's centre."""
    cfg, program, ref = _models(dtype)
    enc, kk = _encoded(cfg, program)
    g = torch.Generator().manual_seed(7)
    b, n, f = enc.lig_h.shape
    k = 5
    noise = dict(init_x=torch.randn(b, n, 3, generator=g), init_h=torch.randn(b, n, f, generator=g),
                 steps_x=torch.randn(k, b, n, 3, generator=g), steps_h=torch.randn(k, b, n, f, generator=g))
    st, n_steps, _ = program.start_chain(enc, kk, sample_steps=k, noise=noise)
    assert n_steps == k
    before = {key: st[key].clone() for key in ("lig_x", "lig_h", "kp_x")}
    grid = program.chain_grid(k)
    program.reverse_step(program._sampling_dynamics(), st, eta=1.0)
    static = dict(lig_mask=enc.lig_mask, kp_h=enc.kp_h, kp_mask=enc.kp_mask, kp_v=None, kk=_rr(enc))
    new, moved = ref.reverse_step(before, static, int(grid[0]), int(grid[1]), noise["steps_x"][0],
                                  noise["steps_h"][0])
    scale = moved.abs().max()
    for key in ("lig_x", "lig_h", "kp_x"):
        gap = float((st[key] - new[key]).abs().max() / scale)
        assert gap <= tol, f"{key}: {gap:.3e} of the move"


def _sampler(tmp_path, name: str):
    from kpdiff_tpu_torch.serve import KeypointSampler

    path = tmp_path / f"{name}.yml"
    path.write_text(dump_yaml(_config(name)))
    return KeypointSampler.from_params(path, None, batch_size=2, device="cpu", seed=3, sample_steps=3,
                                       lig_buckets=[16, 48])


def _request(sampler, pocket, n_mols: int = 1):
    return sampler.sample_for_arrays(n_mols=n_mols, ligand_size=9, init_com=pocket["rec_pos"].mean(0), **pocket)


def test_kp_counters_by_hand(tracer, tmp_path):
    """Two requests of one ligand each (one chunk of 2 rows, the second a
    repeat) and a 3-step chain: slots = 2 rows x 64 keypoint slots x 3
    steps a chunk; valid keypoints = 2 rows x the pocket's atoms x 3 steps."""
    sampler = _sampler(tmp_path, "gvp_all_atom")
    for seed, n_rec in ((1, 40), (2, 23)):
        _request(sampler, _pocket(seed, n_rec))
    c = tracer.snapshot()["counters"]
    assert c["serve.kp_slot_steps"] == 2 * (2 * N_REC * 3)
    assert c["serve.kp_atom_steps"] == 2 * (40 + 23) * 3
    assert c["serve.rows_run"] == 4


def test_learned_encoder_fills_every_keypoint_slot(tracer, tmp_path):
    """egnn_40kp (a learned encoder, 6 keypoints): valid keypoints equal the
    slots, 100% slot use."""
    sampler = _sampler(tmp_path, "egnn_40kp")
    _request(sampler, _pocket(3, 40), n_mols=3)
    c = tracer.snapshot()["counters"]
    assert c["serve.kp_slot_steps"] == c["serve.kp_atom_steps"] == 2 * (2 * 6 * 3)
