"""The port against the torch-free goldens, read with
tests/parity_jax.py::unflatten_case and held to the tolerances each case
carries (as assert_case reads them for the JAX runner), and the port's
serving API on the CPU.

The chain_loss cases run the training loss on the injected (t, eps), as
parity_jax.run_case runs them. All 18 cases of tests/golden/ run: the EGNN
and GVP dynamics and encoders, and the chains with learned and fixed
encoders."""
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from kpdiff_tpu.config import load_config as jload
from kpdiff_tpu_torch.analysis.molecule_builder import BuiltMolecule
from kpdiff_tpu_torch.config import model_from_config as tmodel
from kpdiff_tpu_torch.models.complex import make_complex, synthetic_batch as tsyn
from kpdiff_tpu_torch.models.diffusion import DiffusionConfig, KeypointDiffusion, dynamics_from_config
from kpdiff_tpu_torch.ops.cuda import egnn_edge
from kpdiff_tpu_torch.ops.neighbors import dense_radius_adjacency
from kpdiff_tpu_torch.serve import KeypointSampler
from kpdiff_tpu_torch.utils.params_io import export_flat, load_params, read_golden_params
from parity_jax import unflatten_case
from torch_port_util import assert_close, t

ROOT = Path(__file__).resolve().parents[1]


def test_serving_api(tmp_path):
    """from_params on a reduced egnn_40kp config and a keystr npz archive:
    six molecules of 11 atoms sampled on the CPU (no kernel launch), the
    ones that build come back as BuiltMolecules; ligand_size='random'
    needs the size histogram in dataset.location, which this config's
    location lacks."""
    cfg = jload(ROOT / "configs/egnn_40kp.yml")
    cfg["dynamics"].update(n_layers=2, hidden_nf=16)
    cfg["rec_encoder"].update(n_convs=2, hidden_n_node_feat=16, out_n_node_feat=12)
    cfg["graph"]["n_keypoints"] = 6
    cfg["diffusion"]["n_timesteps"] = 8
    cfg_path = tmp_path / "reduced.yml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    npz = tmp_path / "params.npz"
    flat = export_flat(tmodel(cfg, device="cpu", seed=9))
    np.savez(npz, **{"".join(f"['{p}']" for p in k.split(".")): v for k, v in flat.items()})
    sampler = KeypointSampler.from_params(cfg_path, npz, batch_size=4, device="cpu", seed=3)
    assert sampler.lig_buckets == [8, 16, 24, 32, 40, 48]
    pocket = tsyn(5, batch=1, n_rec_pad=40, n_lig_pad=12, n_kp=6, kp_feat_dim=12, min_rec=35)
    n_rec = int(pocket.rec_mask.sum())
    before = egnn_edge.launches
    mols = sampler.sample_for_arrays(pocket.rec_x[0, :n_rec].numpy(), pocket.rec_h[0, :n_rec].numpy(),
                                     pocket.rec_res_idx[0, :n_rec].numpy(), init_com=np.zeros(3, np.float32),
                                     n_mols=6, ligand_size=11)
    assert egnn_edge.launches == before
    assert sampler.last_request["chunks"] == [dict(batch=4, bucket=16, kk="dense", sizes=[11] * 4),
                                              dict(batch=2, bucket=16, kk="dense", sizes=[11] * 2)]
    assert len(mols) <= 6
    for m in mols:
        assert isinstance(m, BuiltMolecule) and 1 <= m.n_atoms <= 11 and np.isfinite(m.coords).all()
        assert len(m.elements) == m.n_atoms and set(m.elements) <= set(cfg["dataset"]["lig_elements"])
    with pytest.raises(FileNotFoundError, match="train_n_node_joint_dist.pkl"):
        sampler.sample_for_arrays(pocket.rec_x[0].numpy(), pocket.rec_h[0].numpy(), ligand_size="random")


GOLDENS = ["egnn_dynamics_mn0", "egnn_dynamics_mn1", "egnn_encoder", "refexec_chain_learned_egnn",
           "refexec_chain_two_pockets_egnn", "refexec_chain_frames_egnn", "refexec_egnn_dynamics_mn0_executed",
           "refexec_egnn_encoder_executed", "refexec_chain_loss_egnn", "refexec_chain_loss_hinge_ip_egnn",
           "refexec_chain_fixed_egnn", "refexec_chain_loss_fake_atoms_egnn", "gvp_dynamics_mean", "gvp_dynamics_mn10",
           "gvp_encoder", "refexec_gvp_dynamics_mn10", "refexec_gvp_encoder_executed", "refexec_chain_learned_gvp"]


def test_goldens_cover_the_directory():
    assert sorted(GOLDENS) == sorted(p.stem for p in (ROOT / "tests/golden").glob("*.npz"))


def _chain_complex(meta, inputs, cfg):
    """The chain cases' complex (parity_jax._chain_complex): ligand arrays
    default to zeros, interface points where the case has them."""
    lig_mask = inputs["lig_mask"].astype(bool)
    b, n_pad = lig_mask.shape
    return make_complex(inputs["rec_x"], inputs["rec_h"], inputs["rec_mask"].astype(bool),
                        inputs.get("lig_x", np.zeros((b, n_pad, 3), np.float32)),
                        inputs.get("lig_h", np.zeros((b, n_pad, cfg.atom_nf), np.float32)),
                        lig_mask, n_kp=meta["n_kp"], kp_feat_dim=meta["kp_feat_dim"],
                        kp_vec_dim=meta.get("kp_vec_dim"), ip_x=inputs.get("ip_x"),
                        ip_mask=inputs["ip_mask"].astype(bool) if "ip_mask" in inputs else None)


@pytest.mark.parametrize("name", GOLDENS)
def test_golden_case(name):
    with np.load(ROOT / "tests/golden" / f"{name}.npz") as z:
        kind, meta, _, inputs, expected = unflatten_case(z)
        flat = read_golden_params(z)
    cfg = DiffusionConfig(**meta["config"])
    if kind in ("egnn_dynamics", "gvp_dynamics"):
        dyn = dynamics_from_config(cfg, torch.Generator())
        load_params(dyn, flat)
        lig_x, lig_h, kp_x, kp_h = (t(inputs[k])[None] for k in ("lig_x", "lig_h", "kp_x", "kp_h"))
        lig_mask = torch.ones(lig_x.shape[:2], dtype=torch.bool)
        kp_mask = torch.ones(kp_x.shape[:2], dtype=torch.bool)
        kk = dense_radius_adjacency(kp_x, kp_mask, kp_x, kp_mask, meta["kk_cut"], exclude_self=True)
        extra = (t(inputs["kp_v"])[None],) if kind == "gvp_dynamics" else ()
        with torch.no_grad():
            eps_h, eps_x = dyn(lig_x, lig_h, lig_mask, kp_x, kp_h, kp_mask, torch.full((1,), meta["t_val"]), kk,
                               *extra)
        got = {"eps_h": eps_h[0], "eps_x": eps_x[0]}
    elif kind in ("egnn_encoder", "gvp_encoder"):
        model = KeypointDiffusion(cfg)
        load_params(model.encoder, flat)
        x0 = inputs["rec_x"]
        n = x0.shape[0]
        cpx = tsyn(0, batch=1, n_rec_pad=n, n_lig_pad=6, n_rec_feat=inputs["rec_h"].shape[1], n_lig_feat=5,
                   n_kp=meta["n_kp"], kp_feat_dim=meta["kp_feat_dim"], kp_vec_dim=meta.get("kp_vec_dim"),
                   min_rec=n, min_lig=6)
        cpx = cpx.replace(rec_x=t(x0)[None], rec_h=t(inputs["rec_h"])[None])
        if "rec_res_idx" in inputs:
            cpx = cpx.replace(rec_res_idx=t(inputs["rec_res_idx"].astype(np.int32))[None])
        enc, _ = model.encode(cpx)
        got = {"kp_x": enc.kp_x[0], "kp_h": enc.kp_h[0]}
        if enc.kp_v is not None:
            got["kp_v"] = enc.kp_v[0]
    elif kind == "chain_loss":
        model = KeypointDiffusion(cfg)
        load_params(model, flat)
        got = model.loss(_chain_complex(meta, inputs, cfg),
                         t_eps_override=(inputs["t_ints"].astype(np.int64), inputs["eps_x"], inputs["eps_h"]))
    else:
        assert kind == "chain_sample"
        model = KeypointDiffusion(cfg)
        load_params(model, flat)
        with torch.no_grad():
            enc, kk = model.encode(_chain_complex(meta, inputs, cfg))
            got = model.sample(enc, kk, init_com=inputs.get("init_com"), return_every=meta.get("return_every", 0),
                               noise={k: inputs[k] for k in ("init_x", "init_h", "steps_x", "steps_h")})
    for k, v in expected.items():
        assert_close(got[k], v, rtol=meta.get("rtol", 5e-4), atol=meta.get("atol", 1e-4), msg=f"{name}:{k}")
