"""kpdiff_tpu_torch dynamics, encoder and padding against kpdiff_tpu on the CPU.

In the port's dynamics every dense edge type goes
through the plain version of the CUDA edge kernel here. Tolerances: f32
rtol 1e-4, atol 1e-5 (1e-4 on eps_x, whose magnitude is ~10); bf16: max abs
error at most 2e-2 of the output's max abs value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kpdiff_tpu.config import PaddingConfig as JPad
from kpdiff_tpu.data.dataset import pad_item as jpad_item
from kpdiff_tpu.models.complex import synthetic_batch as jsyn
from kpdiff_tpu.models.dynamics_egnn import EGNNDynamics as JDyn
from kpdiff_tpu.models.encoder_egnn import EGNNReceptorEncoder as JEnc
from kpdiff_tpu.ops.neighbors import dense_radius_adjacency as jadj, radius_neighbor_list as jnbr
from kpdiff_tpu_torch.config import PaddingConfig as TPad
from kpdiff_tpu_torch.data.padding import pad_item as tpad_item
from kpdiff_tpu_torch.models.complex import synthetic_batch as tsyn
from kpdiff_tpu_torch.models.dynamics_egnn import EGNNDynamics as TDyn
from kpdiff_tpu_torch.models.encoder_egnn import EGNNReceptorEncoder as TEnc
from kpdiff_tpu_torch.ops.edge_sets import NbrList
from torch_port_util import assert_close, assert_rel_max, load_from_jax, t

BF16_REL = 2e-2


def _dyn_inputs(seed=0, B=2, Nl=9, K=6, atom_nf=6, rec_nf=10):
    rng = np.random.default_rng(seed)
    lig_x = (rng.normal(size=(B, Nl, 3)) * 2).astype(np.float32)
    lig_h = rng.normal(size=(B, Nl, atom_nf)).astype(np.float32)
    lig_mask = np.arange(Nl)[None] < np.array([[Nl], [Nl - 3]])
    kp_x = (rng.normal(size=(B, K, 3)) * 3).astype(np.float32)
    kp_h = rng.normal(size=(B, K, rec_nf)).astype(np.float32)
    kp_mask = np.ones((B, K), bool)
    tt = np.array([0.3, 0.8], np.float32)
    return lig_x, lig_h, lig_mask, kp_x, kp_h, kp_mask, tt


@pytest.mark.parametrize("kk_layout,dtype,message_norm,z_sem,pallas", [
    ("dense", "float32", 0, "intent", False), ("nbr", "float32", 0, "intent", False),
    ("dense", "float32", 0, "executed", False), ("nbr", "float32", 1.0, "intent", False),
    ("nbr", "bfloat16", 0, "intent", True)])
def test_dynamics_matches_jax(kk_layout, dtype, message_norm, z_sem, pallas):
    ins = _dyn_inputs()
    kw = dict(atom_nf=6, rec_nf=10, n_layers=2, hidden_nf=16, use_tanh=True, message_norm=message_norm,
              update_kp_feat=True, norm=True, kl_k=3, ll_cutoff=5.0, compute_dtype=dtype,
              z_semantics=z_sem)
    jin = [jnp.asarray(a) for a in ins]
    kp_x, kp_mask = jin[3], jin[5]
    if kk_layout == "dense":
        jkk = jadj(kp_x, kp_mask, kp_x, kp_mask, 4.0, exclude_self=True)
        tkk = t(jkk)
    else:
        idx, valid = jnbr(kp_x, kp_mask, kp_x, kp_mask, 4.0, 4, exclude_self=True)
        jkk = (idx, valid)
        tkk = NbrList(t(idx, torch.int64), t(valid))
    jmod = JDyn(**kw, kl_cutoff=8.0, use_pallas=pallas)
    params = jmod.init(jax.random.key(0), *jin, jkk)
    want = jmod.apply(params, *jin, jkk)
    tmod = load_from_jax(TDyn(gen=torch.Generator(), **kw), params)
    with torch.no_grad():
        got = tmod(*[t(a) for a in ins], tkk)
    for g, w, name in zip(got, want, ("eps_h", "eps_x")):
        if dtype == "float32":
            assert_close(g, w, rtol=1e-4, atol=1e-4 if name == "eps_x" else 1e-5, msg=name)
        else:
            assert_rel_max(g, w, BF16_REL, msg=name)


@pytest.mark.parametrize("dtype,attn,k_closest", [("float32", "intent", 3), ("float32", "executed", 0),
                                                  ("bfloat16", "intent", 3)])
def test_encoder_matches_jax(dtype, attn, k_closest):
    kw = dict(n_keypoints=5, in_n_node_feat=10, hidden_n_node_feat=16, out_n_node_feat=12, n_convs=2,
              use_tanh=True, message_norm=0, k_closest=k_closest, kp_rad=0.0 if k_closest else 4.0, norm=True,
              use_sameres_feat=True, graph_cutoffs={"rr": 3.5, "kk": 8.0}, compute_dtype=dtype,
              attn_semantics=attn)
    syn = dict(batch=2, n_rec_pad=40, n_lig_pad=8, n_kp=5, kp_feat_dim=12, min_rec=30)
    jcpx = jsyn(3, **syn)
    tcpx = tsyn(3, **syn)
    jmod = JEnc(**kw)
    params = jmod.init(jax.random.key(1), jcpx)
    want = jmod.apply(params, jcpx)
    tmod = load_from_jax(TEnc(torch.Generator(), **kw), params)
    with torch.no_grad():
        got = tmod(tcpx)
    for name in ("kp_x", "kp_h"):
        if dtype == "float32":
            assert_close(getattr(got, name), getattr(want, name), rtol=1e-4, atol=1e-5, msg=name)
        else:
            assert_rel_max(getattr(got, name), getattr(want, name), BF16_REL, msg=name)
    assert got.kp_mask.all()


@pytest.mark.parametrize("fake", [0.0, 0.3])
def test_pad_item_matches_jax(fake):
    rng = np.random.default_rng(7)
    item = dict(lig_pos=rng.normal(size=(11, 3)).astype(np.float32),
                lig_feat=np.eye(10, dtype=np.float32)[rng.integers(0, 10, 11)],
                rec_pos=rng.normal(size=(30, 3)).astype(np.float32),
                rec_feat=np.eye(10, dtype=np.float32)[rng.integers(0, 10, 30)],
                rec_res_idx=np.sort(rng.integers(0, 8, 30)).astype(np.int32),
                interface_points=rng.normal(size=(4, 3)).astype(np.float32))
    kw = dict(n_rec=40, n_lig=16, n_kp=5, n_ip=8)
    want = jpad_item(item, JPad(**kw), fake, np.random.default_rng(1) if fake else None, n_lig_feat_out=11)
    got = tpad_item(item, TPad(**kw), fake, np.random.default_rng(1) if fake else None, n_lig_feat_out=11)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tpad_item(item, TPad(n_rec=20, n_lig=16, n_kp=5, n_ip=8)) is None
