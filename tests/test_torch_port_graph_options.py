"""The reference's other graph options through kpdiff_tpu_torch against
kpdiff_tpu on the CPU: kNN ligand edges (`ll_k > 0`), dense radius
keypoint-ligand edges (`kl_k == 0`, kl and its transpose lk as dense grids),
EGNNEdge's dense form in the encoder's configuration, and the learned encoders with
`rr_layout: block`. Inputs come from numpy seeds and molgen; the weights are
the port's seeded init carried into a JAX param tree; f32 at rtol 1e-4 /
atol 1e-5."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kpdiff_tpu.config import load_config as jload
from torch_port_util import assert_close, family_setup, jax_flat, reduce_family

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-5


def _config(name, dynamics=None, encoder=None):
    """configs/<name>.yml reduced (torch_port_util.reduce_family) with its
    dynamics and learned-encoder sections updated."""
    cfg = reduce_family(jload(ROOT / f"configs/{name}.yml"))
    gvp = "dynamics_gvp" in cfg
    cfg["dynamics_gvp" if gvp else "dynamics"].update(dynamics or {})
    cfg["rec_encoder_gvp" if gvp else "rec_encoder"].update(encoder or {})
    return cfg


# ---- dense_knn_adjacency (kpdiff_tpu/ops/neighbors.py:73-110)

@pytest.mark.parametrize("per", ["dst", "src"])
@pytest.mark.parametrize("exclude_self", [False, True], ids=["with_self", "no_self"])
def test_dense_knn_adjacency_matches_jax(per, exclude_self):
    """Edge sets on tie-free inputs (continuous random coordinates); rows
    with fewer valid partners than k mark only the valid ones."""
    from kpdiff_tpu.ops.neighbors import dense_knn_adjacency as jknn
    from kpdiff_tpu_torch.ops.neighbors import dense_knn_adjacency

    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 12, 3)).astype(np.float32) * 3
    mask = rng.random((3, 12)) < 0.75
    mask[2, 3:] = False  # three valid nodes: fewer than k
    for k in (1, 4, 20):
        got = dense_knn_adjacency(torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(x),
                                  torch.from_numpy(mask), k, per=per, exclude_self=exclude_self)
        want = np.asarray(jknn(jnp.asarray(x), jnp.asarray(mask), jnp.asarray(x), jnp.asarray(mask), k,
                               per=per, exclude_self=exclude_self))
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"k={k}")
    with pytest.raises(ValueError):
        dense_knn_adjacency(torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(x),
                            torch.from_numpy(mask), 2, per="both")


# ---- the dynamics with ll_k > 0 and kl_k == 0

EGNN_NORMS = {"mn1": dict(message_norm=1.0), "mn0_intent": dict(message_norm=0.0, z_semantics="intent"),
              "mn0_executed": dict(message_norm=0.0, z_semantics="executed")}
GVP_NORMS = {"mn10": dict(message_norm=10.0), "mn0": dict(message_norm=0.0)}
OPTIONS = {"ll_knn": dict(ll_k=4), "kl_radius": dict(kl_k=0)}
DYN_CASES = ([("egnn_40kp", o, n) for o in OPTIONS for n in EGNN_NORMS]
             + [("gvp_40kp", o, n) for o in OPTIONS for n in GVP_NORMS])


@pytest.mark.parametrize("name,option,norm", DYN_CASES, ids=["-".join(c) for c in DYN_CASES])
def test_dynamics_graph_options_match_jax(name, option, norm):
    """One dynamics call on the encoded batch, same params and t in both
    packages; the kl/lk grids carry edges at the kl cutoff."""
    norms = EGNN_NORMS if name.startswith("egnn") else GVP_NORMS
    cfg = _config(name, dynamics=dict(OPTIONS[option], **norms[norm]))
    jm, jp, tm, tb, jb = family_setup(cfg)
    t = np.random.default_rng(4).random(tb.lig_x.shape[0]).astype(np.float32)
    with torch.no_grad():
        enc, kk = tm.encode(tb)
        got = tm._apply_dynamics(tm.dynamics, tb.lig_x, tb.lig_h, tb.lig_mask, enc.kp_x, enc.kp_h, enc.kp_mask,
                                 torch.from_numpy(t), kk, enc.kp_v)
    jenc, jkk = jax.jit(jm.encode)(jp, jb)
    want = jax.jit(lambda p, e, kk_, t_: jm._apply_dynamics(p, jb.lig_x, jb.lig_h, jb.lig_mask, e.kp_x, e.kp_h,
                                                             e.kp_mask, t_, kk_, e.kp_v))(jp, jenc, jkk, jnp.asarray(t))
    if option == "kl_radius":
        from kpdiff_tpu_torch.ops.neighbors import dense_radius_adjacency

        kl = dense_radius_adjacency(enc.kp_x, enc.kp_mask, tb.lig_x, tb.lig_mask, cfg["graph"]["graph_cutoffs"]["kl"])
        assert 0 < int(kl.sum()) < kl.numel()
    for g, w, k in zip(got, want, ("eps_h", "eps_x")):
        assert torch.isfinite(g).all()
        assert_close(g, w, RTOL, ATOL, f"{name} {option} {norm}: {k}")


@pytest.mark.parametrize("name", ["egnn_40kp", "gvp_40kp"])
def test_kl_radius_chain_and_loss_match_jax(name):
    """A 3-step strided chain on injected noise and the loss on injected
    (t, eps) with kl_k: 0 (and ll_k: 4 for GVP), f32, reduced."""
    extra = {} if name.startswith("egnn") else dict(ll_k=4)
    jm, jp, tm, tb, jb = family_setup(_config(name, dynamics=dict(kl_k=0, **extra)))
    rng = np.random.default_rng(5)
    b, n, f = tb.lig_h.shape
    K = 3
    noise = {k: rng.normal(size=s).astype(np.float32) for k, s in
             (("init_x", (b, n, 3)), ("init_h", (b, n, f)), ("steps_x", (K, b, n, 3)), ("steps_h", (K, b, n, f)))}
    with torch.no_grad():
        enc, kk = tm.encode(tb)
        out = tm.sample(enc, kk, sample_steps=K, noise=noise)
    jenc, jkk = jax.jit(jm.encode)(jp, jb)
    jout = jm.sample(jp, jax.random.key(0), jenc, jkk, sample_steps=K,
                     noise={k: jnp.asarray(v) for k, v in noise.items()})
    for k in ("lig_x", "lig_h"):
        assert torch.isfinite(out[k]).all()
        assert_close(out[k], jout[k], RTOL, ATOL, f"{name}: {k}")
    t_eps = (rng.integers(0, 1000, b), rng.normal(size=(b, n, 3)).astype(np.float32),
             rng.normal(size=(b, n, f)).astype(np.float32))
    got = tm.loss(tb, t_eps_override=t_eps)
    want = jax.jit(lambda p, c, te: jm.loss(p, jax.random.key(1), c, t_eps_override=te))(
        jp, jb, (jnp.asarray(t_eps[0].astype(np.int32)), jnp.asarray(t_eps[1]), jnp.asarray(t_eps[2])))
    assert set(got) == set(want)
    for k in want:
        assert_close(got[k], want[k], RTOL, ATOL, f"{name}: loss {k}")


def test_kl_radius_names_load_either_layout():
    """edge_kl / edge_lk are one EGNNEdge with the same parameter names
    under both kl layouts, so one archive loads under either."""
    from kpdiff_tpu_torch.config import model_from_config
    from kpdiff_tpu_torch.models.egnn import EGNNEdge
    from kpdiff_tpu_torch.utils.params_io import export_flat, load_params

    knn = model_from_config(_config("egnn_40kp"), device="cpu")
    radius = model_from_config(_config("egnn_40kp", dynamics=dict(kl_k=0)), device="cpu", seed=1)
    assert isinstance(knn.dynamics.conv0.edge_kl, EGNNEdge)
    assert isinstance(radius.dynamics.conv0.edge_lk, EGNNEdge)
    load_params(radius, export_flat(knn))
    for (n, a), (_, b) in zip(knn.named_parameters(), radius.named_parameters()):
        assert torch.equal(a, b), n


# ---- EGNNEdge's dense form in the encoder's configuration (kpdiff_tpu/models/egnn.py:131-136, 178-184)

@pytest.mark.parametrize("compute_coord", [True, False], ids=["coords", "fix_pos"])
def test_edge_dense_encoder_variant_matches_jax(compute_coord):
    """Edge features, one coord hidden layer, compute_coord False (fix_pos):
    the plain path, on the flax module's parameters."""
    from kpdiff_tpu.models.egnn import EGNNEdgeDense as JDense
    from kpdiff_tpu_torch.models.egnn import EGNNEdge
    from kpdiff_tpu_torch.utils.params_io import load_params

    rng = np.random.default_rng(6)
    b, ns, nd, f, h = 2, 9, 7, 5, 8
    hs, hd = (rng.normal(size=(b, n, f)).astype(np.float32) for n in (ns, nd))
    xs, xd = (rng.normal(size=(b, n, 3)).astype(np.float32) * 2 for n in (ns, nd))
    adj = rng.random((b, ns, nd)) < 0.6
    ef = (rng.random((b, ns, nd, 1)) < 0.5).astype(np.float32)
    jmod = JDense(hidden_size=h, use_tanh=True, coords_range=10.0, coord_hidden_layers=1,
                  compute_coord=compute_coord, edge_feat_size=1)
    args = [jnp.asarray(a) for a in (hs, hd, xs, xd, adj, ef)]
    params = jmod.init(jax.random.key(0), *args)
    want = jmod.apply(params, *args)
    mod = EGNNEdge(f, h, torch.Generator().manual_seed(0), use_tanh=True, coord_hidden_layers=1,
                   compute_coord=compute_coord, edge_feat_size=1)
    assert not mod.kernel_ok
    load_params(mod, jax_flat(params))
    got = mod(*(torch.from_numpy(np.asarray(a)) for a in (hs, hd, xs, xd, adj, ef)))
    for g, w, k in zip(got, want, ("agg_h", "agg_x")):
        assert_close(g, w, RTOL, ATOL, k)
    if not compute_coord:
        assert not got[1].any()


# ---- the learned encoders with rr_layout: block

@pytest.mark.parametrize("name", ["egnn_40kp", "gvp_40kp"])
def test_block_rr_encoder_matches_jax(name):
    """rr over Morton-sorted banded windows (tiles of 16 over 48 pocket
    atoms) with the same-residue edge feature; keypoints and their features
    against kpdiff_tpu's."""
    cfg = _config(name, encoder=dict(rr_layout="block", rr_block_size=16, use_sameres_feat=True))
    jm, jp, tm, tb, jb = family_setup(cfg)
    with torch.no_grad():
        enc, _ = tm.encode(tb)
    jenc, _ = jax.jit(jm.encode)(jp, jb)
    for k in ("kp_x", "kp_h") + (("kp_v",) if name.startswith("gvp") else ()):
        assert torch.isfinite(getattr(enc, k)).all()
        assert_close(getattr(enc, k), getattr(jenc, k), RTOL, ATOL, f"{name}: {k}")
    if name.startswith("egnn"):
        from kpdiff_tpu_torch.models.egnn import EGNNEdge

        assert isinstance(tm.encoder.rec_conv0.edge_rr, EGNNEdge)
    else:
        assert tm.encoder.rr_layout == "block"
