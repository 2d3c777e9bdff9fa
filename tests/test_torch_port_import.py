"""Reference-checkpoint import through kpdiff_tpu_torch/utils/torch_import.py.

State_dicts come from the independent torch modules of
tests/test_torch_parity*.py (seeded), whose key paths mirror the upstream
module tree. Each goes through kpdiff_tpu's converter and the port's: the
trees are equal leaf by leaf, and the port's modules loaded from them give
the torch modules' own outputs. Then the whole-model import for both
architectures, as tests/test_whole_model_import.py does, with the port's
encode and a 3-step chain on injected noise against kpdiff_tpu's (f32, rtol
1e-4 / atol 1e-5; against the torch modules the parity tests' 2e-4 / 2e-5
and 5e-4 / 5e-5 and 1e-4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_torch_parity as tp
import tests.test_torch_parity_encoder as tpe
import tests.test_torch_parity_gvp as tpg
import tests.test_torch_parity_gvp_encoder as tpge
from kpdiff_tpu.models.diffusion import DiffusionConfig as JConfig, KeypointDiffusion as JModel
from kpdiff_tpu.utils import torch_import as jimport
from kpdiff_tpu_torch.models.complex import synthetic_batch
from kpdiff_tpu_torch.models.diffusion import DiffusionConfig, KeypointDiffusion
from kpdiff_tpu_torch.utils import torch_import as timport
from kpdiff_tpu_torch.utils.params_io import flatten_tree, load_params
from torch_port_util import assert_close, jax_complex

RTOL, ATOL = 1e-4, 1e-5


def _sd(module, prefix=""):
    return {f"{prefix}{k}": v.detach().numpy() for k, v in module.state_dict().items()}


def _assert_same_tree(got, want):
    got, want = flatten_tree(got), flatten_tree(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert isinstance(got[k], np.ndarray), k
        assert got[k].dtype == np.asarray(want[k]).dtype and np.array_equal(got[k], want[k]), k


def _port_model(cfg_kw):
    return KeypointDiffusion(DiffusionConfig(**cfg_kw))


# ---- each converter, against kpdiff_tpu's and against the torch modules' outputs

def _egnn_dyn_cfg(message_norm):
    return dict(atom_nf=tp.ATOM_NF, rec_nf=tp.REC_NF, n_timesteps=10, rec_encoder_type="fixed",
                graph_cutoffs={"rr": tp.KK_CUT, "kk": tp.KK_CUT, "kl": 8, "ll": tp.LL_CUT, "rk": 100},
                dynamics=dict(n_layers=tp.N_LAYERS, hidden_nf=tp.HID, use_tanh=True, message_norm=message_norm,
                              update_kp_feat=True, norm=True, ll_k=0, kl_k=tp.KL_K))


def _gvp_dyn_cfg(message_norm):
    return dict(atom_nf=tpg.ATOM_NF, rec_nf=tpg.KP_NF, n_timesteps=10, architecture="gvp",
                rec_encoder_type="fixed",
                graph_cutoffs={"rr": tpg.KK_CUT, "kk": tpg.KK_CUT, "kl": 8, "ll": tpg.LL_CUT, "rk": 100},
                rec_encoder=dict(vector_size=tpg.V),
                dynamics=dict(vector_size=tpg.V, n_convs=tpg.N_CONVS, n_hidden_scalars=tpg.S, update_kp=True,
                              message_norm=message_norm, ll_k=0, kl_k=tpg.KL_K, n_message_gvps=tpg.N_MSG,
                              n_update_gvps=tpg.N_UPD, n_noise_gvps=tpg.N_NOISE))


def _dyn_inputs(seed, atom_nf, kp_nf, kp_v_dim=None):
    rng = np.random.default_rng(seed)
    nl, nk = 7, 5
    out = dict(lig_x=rng.normal(size=(nl, 3)) * 2, lig_h=rng.normal(size=(nl, atom_nf)),
               kp_x=rng.normal(size=(nk, 3)) * 3, kp_h=rng.normal(size=(nk, kp_nf)))
    if kp_v_dim:
        out["kp_v"] = rng.normal(size=(nk, kp_v_dim, 3))
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in out.items()}


def _port_dynamics(model, a, t_val, cut):
    from kpdiff_tpu_torch.ops.neighbors import dense_radius_adjacency

    nl, nk = a["lig_x"].shape[0], a["kp_x"].shape[0]
    lm, km = torch.ones((1, nl), dtype=torch.bool), torch.ones((1, nk), dtype=torch.bool)
    kk = dense_radius_adjacency(a["kp_x"][None], km, a["kp_x"][None], km, cut, exclude_self=True)
    kp_v = a["kp_v"][None] if "kp_v" in a else None
    with torch.no_grad():
        eps_h, eps_x = model._apply_dynamics(model.dynamics, a["lig_x"][None], a["lig_h"][None], lm, a["kp_x"][None],
                                             a["kp_h"][None], km, torch.full((1,), t_val), kk, kp_v)
    return eps_h[0], eps_x[0]


@pytest.mark.parametrize("message_norm", [1.0, 0])
def test_egnn_dynamics_converter(message_norm):
    torch.manual_seed(0)
    a = _dyn_inputs(0, tp.ATOM_NF, tp.REC_NF)
    ref = tp.TorchRefDynamics(message_norm=message_norm)
    with torch.no_grad():
        want = ref(a["lig_x"], a["lig_h"], a["kp_x"], a["kp_h"], 0.35, tp.build_edges(a["lig_x"], a["kp_x"]))
    sd = _sd(ref)
    kw = dict(n_layers=tp.N_LAYERS, update_kp_feat=True, rec_nf=tp.REC_NF, hidden_nf=tp.HID)
    tree = timport.convert_egnn_dynamics_state_dict(sd, **kw)
    _assert_same_tree(tree, jimport.convert_egnn_dynamics_state_dict(sd, **kw))
    model = _port_model(_egnn_dyn_cfg(message_norm))
    load_params(model.dynamics, tree)
    for g, w, k in zip(_port_dynamics(model, a, 0.35, tp.KK_CUT), want, ("eps_h", "eps_x")):
        assert_close(g, w, 2e-4, 2e-5, k)


@pytest.mark.parametrize("message_norm", ["mean", 10.0])
def test_gvp_dynamics_converter(message_norm):
    torch.manual_seed(3)
    a = _dyn_inputs(3, tpg.ATOM_NF, tpg.KP_NF, tpg.V)
    ref = tpg.TorchRefGVPDynamics(message_norm=message_norm)
    with torch.no_grad():
        want = ref(a["lig_x"], a["lig_h"], a["kp_x"], a["kp_h"], a["kp_v"], 0.6,
                   tpg.build_edges(a["lig_x"], a["kp_x"]))
    sd = _sd(ref)
    kw = dict(n_convs=tpg.N_CONVS, update_kp=True, n_message_gvps=tpg.N_MSG, n_update_gvps=tpg.N_UPD,
              n_noise_gvps=tpg.N_NOISE)
    tree = timport.convert_gvp_dynamics_state_dict(sd, **kw)
    _assert_same_tree(tree, jimport.convert_gvp_dynamics_state_dict(sd, **kw))
    model = _port_model(_gvp_dyn_cfg(message_norm))
    load_params(model.dynamics, tree)
    for g, w, k in zip(_port_dynamics(model, a, 0.6, tpg.KK_CUT), want, ("eps_h", "eps_x")):
        assert_close(g, w, 5e-4, 5e-5, k)


def _encode_one(model, x0, h0, n_kp, kp_feat_dim, res_idx=None, kp_vec_dim=None):
    n = x0.shape[0]
    cpx = synthetic_batch(0, batch=1, n_rec_pad=n, n_lig_pad=6, n_rec_feat=h0.shape[1], n_lig_feat=5, n_kp=n_kp,
                          kp_feat_dim=kp_feat_dim, kp_vec_dim=kp_vec_dim, min_rec=n, min_lig=6, device="cpu")
    cpx = cpx.replace(rec_x=x0[None], rec_h=h0[None],
                      **({} if res_idx is None else {"rec_res_idx": res_idx[None].to(cpx.rec_res_idx.dtype)}))
    with torch.no_grad():
        enc, _ = model.encode(cpx)
    return enc


def test_egnn_encoder_converter():
    torch.manual_seed(1)
    rng = np.random.default_rng(1)
    n = 14
    x0 = torch.tensor(rng.normal(size=(n, 3)) * 2.5, dtype=torch.float32)
    h0 = torch.tensor(rng.normal(size=(n, tpe.IN_F)), dtype=torch.float32)
    res_idx = torch.tensor(rng.integers(0, 4, size=n))
    ref = tpe.TorchRefEncoder()
    with torch.no_grad():
        kp_pos, kp_feat = ref(x0, h0, res_idx)
    sd = _sd(ref)
    kw = dict(n_convs=tpe.N_CONVS, hidden=tpe.HID, out_feat=tpe.HID, in_feat=tpe.IN_F, use_sameres_feat=True,
              fix_pos=False, norm=True)
    tree = timport.convert_egnn_encoder_state_dict(sd, **kw)
    _assert_same_tree(tree, jimport.convert_egnn_encoder_state_dict(sd, **kw))
    model = _port_model(dict(
        atom_nf=5, rec_nf=tpe.HID, n_timesteps=10, rec_encoder_type="learned",
        graph_cutoffs={"rr": tpe.RR_CUT, "rk": 100, "kk": 8, "kl": 8, "ll": 5},
        dynamics=dict(n_layers=1, hidden_nf=8, kl_k=2),
        rec_encoder=dict(n_keypoints=tpe.N_KP, in_n_node_feat=tpe.IN_F, hidden_n_node_feat=tpe.HID,
                         out_n_node_feat=tpe.HID, n_convs=tpe.N_CONVS, use_tanh=True, message_norm=0,
                         k_closest=tpe.K_CLOSEST, kp_rad=0.0, norm=True, fix_pos=False, use_sameres_feat=True)))
    load_params(model.encoder, tree)
    enc = _encode_one(model, x0, h0, tpe.N_KP, tpe.HID, res_idx=res_idx)
    assert_close(enc.kp_x[0], kp_pos, 5e-4, 5e-5, "kp_x")
    assert_close(enc.kp_h[0], kp_feat, 5e-4, 5e-5, "kp_h")


def test_gvp_encoder_converter():
    torch.manual_seed(5)
    rng = np.random.default_rng(5)
    n = 12
    x0 = torch.tensor(rng.normal(size=(n, 3)) * 2.5, dtype=torch.float32)
    h0 = torch.tensor(rng.normal(size=(n, tpge.IN_F)), dtype=torch.float32)
    ref = tpge.TorchRefGVPEncoder()
    with torch.no_grad():
        kp_pos, kp_h, kp_v = ref(x0, h0)
    sd = _sd(ref)
    args = (tpge.N_RR, tpge.N_RK, tpge.N_MSG, tpge.N_UPD)
    tree = timport.convert_gvp_encoder_state_dict(sd, *args)
    _assert_same_tree(tree, jimport.convert_gvp_encoder_state_dict(sd, *args))
    model = _port_model(dict(
        atom_nf=5, rec_nf=tpge.S, n_timesteps=10, architecture="gvp", rec_encoder_type="learned",
        graph_cutoffs={"rr": tpge.RR_CUT, "rk": tpge.RK_RBF_DMAX, "kk": 8, "kl": 8, "ll": 5},
        dynamics=dict(vector_size=tpge.V, n_convs=1, n_hidden_scalars=8, kl_k=2, n_message_gvps=1,
                      n_update_gvps=1, n_noise_gvps=2),
        rec_encoder=dict(in_scalar_size=tpge.IN_F, n_keypoints=tpge.N_KP, out_scalar_size=tpge.S,
                         vector_size=tpge.V, n_rr_convs=tpge.N_RR, n_rk_convs=tpge.N_RK, message_norm=10.0,
                         k_closest=tpge.K_CLOSEST, kp_rad=0, n_message_gvps=tpge.N_MSG,
                         n_update_gvps=tpge.N_UPD, dropout=0.0)))
    load_params(model.encoder, tree)
    enc = _encode_one(model, x0, h0, tpge.N_KP, tpge.S, kp_vec_dim=tpge.V)
    assert_close(enc.kp_x[0], kp_pos, 5e-4, 5e-5, "kp_x")
    assert_close(enc.kp_h[0], kp_h, 5e-4, 1e-4, "kp_h")
    assert_close(enc.kp_v[0], kp_v, 5e-4, 1e-4, "kp_v")


# ---- the whole model: convert_reference_checkpoint, then encode and sample against kpdiff_tpu

def _whole_egnn():
    old = tp.REC_NF
    try:
        tp.REC_NF = tpe.HID  # the encoder's output width feeds the dynamics' keypoint input
        dyn = tp.TorchRefDynamics()
    finally:
        tp.REC_NF = old
    cfg = dict(atom_nf=tp.ATOM_NF, rec_nf=tpe.HID, n_timesteps=10, rec_encoder_type="learned",
               graph_cutoffs={"rr": tpe.RR_CUT, "rk": 100, "kk": 8, "kl": 8, "ll": 5},
               dynamics=dict(n_layers=tp.N_LAYERS, hidden_nf=tp.HID, kl_k=tp.KL_K, update_kp_feat=True,
                             message_norm=1, use_tanh=True, norm=True),
               rec_encoder=dict(n_keypoints=tpe.N_KP, in_n_node_feat=tpe.IN_F, hidden_n_node_feat=tpe.HID,
                                out_n_node_feat=tpe.HID, n_convs=tpe.N_CONVS, use_tanh=True, message_norm=0,
                                k_closest=tpe.K_CLOSEST, kp_rad=0.0, norm=True, fix_pos=False,
                                use_sameres_feat=True))
    return dyn, tpe.TorchRefEncoder(), cfg, dict(n_rec=14, n_kp=tpe.N_KP, rec_feat=tpe.IN_F, kp_dim=tpe.HID,
                                                 kp_vec=None)


def _whole_gvp():
    old = tpg.KP_NF, tpg.V
    try:
        tpg.KP_NF, tpg.V = tpge.S, tpge.V  # encoder scalars and vectors feed the dynamics
        dyn = tpg.TorchRefGVPDynamics(update_kp=True)
    finally:
        tpg.KP_NF, tpg.V = old
    cfg = dict(atom_nf=tpg.ATOM_NF, rec_nf=tpge.S, n_timesteps=10, architecture="gvp", rec_encoder_type="learned",
               graph_cutoffs={"rr": tpge.RR_CUT, "rk": tpge.RK_RBF_DMAX, "kk": tpg.KK_CUT, "kl": 8,
                              "ll": tpg.LL_CUT},
               dynamics=dict(vector_size=tpge.V, n_convs=tpg.N_CONVS, n_hidden_scalars=tpg.S, update_kp=True,
                             message_norm=10.0, ll_k=0, kl_k=tpg.KL_K, n_message_gvps=tpg.N_MSG,
                             n_update_gvps=tpg.N_UPD, n_noise_gvps=tpg.N_NOISE),
               rec_encoder=dict(in_scalar_size=tpge.IN_F, n_keypoints=tpge.N_KP, out_scalar_size=tpge.S,
                                vector_size=tpge.V, n_rr_convs=tpge.N_RR, n_rk_convs=tpge.N_RK, message_norm=10.0,
                                k_closest=tpge.K_CLOSEST, kp_rad=0, n_message_gvps=tpge.N_MSG,
                                n_update_gvps=tpge.N_UPD, dropout=0.0))
    return dyn, tpge.TorchRefGVPEncoder(), cfg, dict(n_rec=12, n_kp=tpge.N_KP, rec_feat=tpge.IN_F, kp_dim=tpge.S,
                                                     kp_vec=tpge.V)


@pytest.mark.parametrize("arch", ["egnn", "gvp"])
def test_whole_model_import_matches_jax(arch):
    torch.manual_seed(0)
    ref_dyn, ref_enc, cfg, dims = (_whole_egnn if arch == "egnn" else _whole_gvp)()
    sd = {**_sd(ref_dyn, "dynamics."), **_sd(ref_enc, "rec_encoder.")}
    tm, jm = _port_model(cfg), JModel(JConfig(**cfg))
    tree = timport.convert_reference_checkpoint(sd, tm)
    _assert_same_tree(tree, jimport.convert_reference_checkpoint(sd, jm))
    load_params(tm, tree)  # every leaf of the port's model, no more, no less

    cpx = synthetic_batch(0, batch=2, n_rec_pad=dims["n_rec"], n_lig_pad=6, n_rec_feat=dims["rec_feat"],
                          n_lig_feat=cfg["atom_nf"], n_kp=dims["n_kp"], kp_feat_dim=dims["kp_dim"],
                          kp_vec_dim=dims["kp_vec"], min_rec=10, min_lig=4, device="cpu")
    jcpx = jax_complex(cpx, dims["n_kp"], dims["kp_dim"], dims["kp_vec"])
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    rng = np.random.default_rng(7)
    b, n, f = cpx.lig_h.shape
    K = 3
    noise = {k: rng.normal(size=s).astype(np.float32) for k, s in
             (("init_x", (b, n, 3)), ("init_h", (b, n, f)), ("steps_x", (K, b, n, 3)), ("steps_h", (K, b, n, f)))}
    with torch.no_grad():
        enc, kk = tm.encode(cpx)
        out = tm.sample(enc, kk, sample_steps=K, noise=noise)
    jenc, jkk = jm.encode(jparams, jcpx)
    jout = jm.sample(jparams, jax.random.key(1), jenc, jkk, sample_steps=K,
                     noise={k: jnp.asarray(v) for k, v in noise.items()})
    assert_close(enc.kp_x, jenc.kp_x, RTOL, ATOL, "kp_x")
    assert_close(enc.kp_h, jenc.kp_h, RTOL, ATOL, "kp_h")
    for k in ("lig_x", "lig_h"):
        assert torch.isfinite(out[k]).all()
        assert_close(out[k], jout[k], RTOL, ATOL, k)
