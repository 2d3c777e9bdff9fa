"""Keypoint-sharded sampling of kpdiff_tpu_torch (parallel/kp_shard.py) on
gloo ranks, against the port's unsharded run and kpdiff_tpu's sample.

`pad_kp` is held against the JAX package's on the same arrays (exact). The
sharded sample runs on 2 and 4 CPU ranks (one spawn for each, every case
inside it) for dense kk (egnn_40kp, K = 40), the fixed encoder's neighbor
list (egnn_ca, padding.n_rec 64; also on the kernel's route, the dynamics
made to see a kernel device: each rank's (B, K/n, cap) list of the
gathered rows through edge_kk's list form, the list entry's plain
version, every layer of it counted), dense radius kl/lk (kl_k 0) and GVP
(10 keypoints: padded to 12 on 4 ranks), at 2 layers and narrow widths,
f32, on injected noise; each must equal both references within
tests/test_kp_sharding.py::_assert_close's rel 2e-4 of the scale + 1e-3.

This module imports only torch and the port at its top: the spawned ranks
import it to find their function."""
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

from kpdiff_tpu_torch.config import PaddingConfig, load_config, model_from_config, resolve_feature_sizes
from kpdiff_tpu_torch.models import dynamics_egnn
from kpdiff_tpu_torch.models.egnn import EGNNEdge
from kpdiff_tpu_torch.models.complex import synthetic_batch
from kpdiff_tpu_torch.ops.edge_sets import Blocks, NbrList
from kpdiff_tpu_torch.parallel import distributed as pdist
from kpdiff_tpu_torch.parallel.kp_shard import pad_kp, shard_encoded
from kpdiff_tpu_torch.parallel.mesh import make_mesh
from kpdiff_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
SAMPLE_STEPS = 4
CASES = {
    "dense_kk": ("egnn_40kp", {}),
    "nbr_kk": ("egnn_ca", {}),
    "nbr_kk_mask": ("egnn_ca", {}),
    "kl_k0": ("egnn_40kp", {"dynamics": {"kl_k": 0}}),
    "gvp": ("gvp_40kp", {"graph": {"n_keypoints": 10}}),
}
N_RANKS = (2, 4)
KERNEL_ROUTE = ("nbr_kk_mask",)


def case_config(name, over):
    """configs/<name>.yml at 2 layers and narrow widths, dropout 0, f32, 64 pocket atoms."""
    cfg = load_config(ROOT / f"configs/{name}.yml")
    cfg["padding"].update(n_rec=64, n_lig=16, n_ip=16)
    if "dynamics" in cfg:
        cfg["dynamics"].update(n_layers=2, hidden_nf=16, compute_dtype="float32")
        cfg["rec_encoder"].update(n_convs=2, hidden_n_node_feat=16, out_n_node_feat=12, compute_dtype="float32")
    if "dynamics_gvp" in cfg:
        cfg["dynamics_gvp"].update(n_convs=2, n_hidden_scalars=12, vector_size=4, n_message_gvps=2,
                                   n_update_gvps=1, n_noise_gvps=2, dropout=0.0, compute_dtype="float32")
        cfg["rec_encoder_gvp"].update(out_scalar_size=10, vector_size=4, n_rr_convs=2, n_rk_convs=2,
                                      n_message_gvps=2, n_update_gvps=1, dropout=0.0, compute_dtype="float32")
    for sec, kv in over.items():
        cfg[sec].update(kv)
    return cfg


def case_inputs(cfg, seed=0):
    """The port model (seeded), a synthetic batch of 2, its encoding and compacted kk, and noise."""
    tm = model_from_config(cfg, device="cpu", seed=1)
    pad = PaddingConfig.from_config(cfg)
    n_rec_feat, n_lig_feat, _ = resolve_feature_sizes(cfg)
    cpx = synthetic_batch(seed, batch=2, n_rec_pad=pad.n_rec, n_lig_pad=16, n_rec_feat=n_rec_feat,
                          n_lig_feat=n_lig_feat, n_kp=pad.n_kp, kp_feat_dim=tm.cfg.rec_nf, kp_vec_dim=tm.kp_vec_dim,
                          n_ip_pad=pad.n_ip, min_rec=48, min_lig=10)
    with torch.no_grad():
        enc, kk = tm.encode(cpx)
        kk = tm.compact_kk(enc, kk)
    rng = np.random.default_rng(seed + 5)
    b, n, f = cpx.lig_h.shape
    noise = {k: rng.normal(size=s).astype(np.float32) for k, s in
             (("init_x", (b, n, 3)), ("init_h", (b, n, f)), ("steps_x", (SAMPLE_STEPS, b, n, 3)),
              ("steps_h", (SAMPLE_STEPS, b, n, f)))}
    return tm, cpx, enc, kk, noise


def _rank_sample(rank, cases, out_dir):
    n = pdist.world_size()
    mesh = make_mesh(n, ("model",), device="cpu")
    real_device, real_list_form = dynamics_egnn.kernel_device, EGNNEdge.nbr_kernel
    list_calls = []

    def list_form(mod, h_src, h_dst, x_src, x_dst, edges):  # the list mode's form, its sources counted
        list_calls.append(int(h_src.shape[1]))
        return real_list_form(mod, h_src, h_dst, x_src, x_dst, edges)

    EGNNEdge.nbr_kernel = list_form
    for case, (cfg, enc, kk, noise) in cases.items():
        tm = model_from_config(cfg, device="cpu", seed=1)
        enc_s, kk_s, shard = shard_encoded(enc, kk, mesh, axis="model")
        assert enc_s.kp_x.shape[1] == -(-enc.kp_x.shape[1] // n)
        profiling.TRACER = profiling.Tracer()
        list_calls.clear()
        if case in KERNEL_ROUTE:
            dynamics_egnn.kernel_device = lambda device: True
        try:
            out = tm.sample(enc_s, kk_s, sample_steps=SAMPLE_STEPS, noise=noise, kp_shard=shard)
        finally:
            dynamics_egnn.kernel_device = real_device
        routed = profiling.snapshot()["counters"].get("dynamics.kk_route_kernel", 0)
        if rank == 0:
            np.savez(Path(out_dir) / f"{case}_{n}.npz", kk_route_kernel=routed, list_calls=len(list_calls),
                     list_sources=sorted(set(list_calls)), **{k: out[k].numpy() for k in ("lig_x", "lig_h", "kp_x")})
    EGNNEdge.nbr_kernel = real_list_form


def _assert_close(got, want, rel=2e-4, msg=""):
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err < rel * scale + 1e-3, f"{msg}: max abs err {err:.3e}, scale {scale:.3e}"


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Per case: the port's unsharded and JAX's outputs, and the sharded run's on 2 and 4 ranks."""
    import jax
    import jax.numpy as jnp

    from kpdiff_tpu.config import model_from_config as jmodel
    from kpdiff_tpu_torch.utils.params_io import export_flat
    from torch_port_util import jax_complex, jax_tree

    tmp = tmp_path_factory.mktemp("kp_shard")
    want, args = {}, {}
    for case, (name, over) in CASES.items():
        cfg = case_config(name, over)
        tm, cpx, enc, kk, noise = case_inputs(cfg)
        out = tm.sample(enc, kk, sample_steps=SAMPLE_STEPS, noise=noise)
        jm, jp = jmodel(cfg), jax_tree(export_flat(tm))
        jb = jax_complex(cpx, PaddingConfig.from_config(cfg).n_kp, tm.cfg.rec_nf, tm.kp_vec_dim)
        jenc, jkk = jax.jit(jm.encode)(jp, jb)
        jkk = jm.compact_kk(jenc, jkk)
        jout = jm.sample(jp, jax.random.key(0), jenc, jkk, sample_steps=SAMPLE_STEPS,
                         noise={k: jnp.asarray(v) for k, v in noise.items()})
        want[case] = dict(port={k: out[k].numpy() for k in ("lig_x", "lig_h", "kp_x")},
                          jax={k: np.asarray(jout[k]) for k in ("lig_x", "lig_h")}, kk=kk)
        args[case] = (cfg, enc, kk, noise)
    for n in N_RANKS:
        pdist.spawn(_rank_sample, n, args=(args, str(tmp)), device="cpu", threads=1,
                    timeout=timedelta(seconds=60), join_timeout=240)
    got = {(case, n): dict(np.load(tmp / f"{case}_{n}.npz")) for case in CASES for n in N_RANKS}
    return want, got


@pytest.mark.parametrize("n", N_RANKS)
@pytest.mark.parametrize("case", list(CASES))
def test_kp_sharded_sample_matches_unsharded_and_jax(sharded, case, n):
    want, got = sharded
    w, g = want[case], got[(case, n)]
    if case.startswith("nbr_kk"):
        assert isinstance(w["kk"], tuple), "expected a capped neighbor list at rr=3.5"
    elif case != "gvp":
        assert torch.is_tensor(w["kk"]) and w["kk"].shape[1] == 40
    assert (int(g["kk_route_kernel"]) > 0) == (case in KERNEL_ROUTE)
    # the kernel route reaches edge_kk's list mode once a layer, over every keypoint as a source
    assert int(g["list_calls"]) == int(g["kk_route_kernel"])
    if case in KERNEL_ROUTE:
        assert list(g["list_sources"]) == [w["port"]["kp_x"].shape[1] + (-w["port"]["kp_x"].shape[1]) % n]
    for k in ("lig_x", "lig_h"):
        assert np.isfinite(g[k]).all()
        _assert_close(g[k], w["port"][k], msg=f"{case} n={n} {k} vs the port unsharded")
        _assert_close(g[k], w["jax"][k], msg=f"{case} n={n} {k} vs kpdiff_tpu")
    K = w["port"]["kp_x"].shape[1]
    _assert_close(g["kp_x"][:, :K], w["port"]["kp_x"], msg=f"{case} n={n} kp_x")
    assert not g["kp_x"][:, K:].any()  # padded rows come back masked


def _jax_enc(B=2, K=20, C=6, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        rec_x=rng.normal(size=(B, 4, 3)).astype(np.float32), rec_h=rng.normal(size=(B, 4, 5)).astype(np.float32),
        rec_mask=np.ones((B, 4), bool), rec_res_idx=np.zeros((B, 4), np.int32),
        lig_x=rng.normal(size=(B, 8, 3)).astype(np.float32), lig_h=rng.normal(size=(B, 8, 5)).astype(np.float32),
        lig_mask=np.ones((B, 8), bool), kp_x=rng.normal(size=(B, K, 3)).astype(np.float32),
        kp_h=rng.normal(size=(B, K, 7)).astype(np.float32), kp_mask=rng.random((B, K)) < 0.8,
        kp_v=rng.normal(size=(B, K, 4, 3)).astype(np.float32),
        ip_x=np.zeros((B, 2, 3), np.float32), ip_mask=np.zeros((B, 2), bool),
    ), (rng.random((B, K, K)) < 0.3, (rng.integers(0, K, (B, K, C)).astype(np.int32), rng.random((B, K, C)) < 0.7))


@pytest.mark.parametrize("layout", ["dense", "nbr"])
def test_pad_kp_matches_jax(layout):
    """K = 20 padded for 8 ranks: 24 rows, exactly the JAX package's arrays."""
    import jax.numpy as jnp

    from kpdiff_tpu.models.complex import PaddedComplex as JComplex
    from kpdiff_tpu.parallel.kp_shard import pad_kp as jpad_kp
    from kpdiff_tpu_torch.models.complex import PaddedComplex

    fields, (dense, nbr) = _jax_enc()
    kk = dense if layout == "dense" else nbr
    j_enc, j_kk = jpad_kp(JComplex(**{k: jnp.asarray(v) for k, v in fields.items()}),
                          jnp.asarray(kk) if layout == "dense" else tuple(jnp.asarray(a) for a in kk), 8)
    t_kk = torch.from_numpy(kk) if layout == "dense" else NbrList(*(torch.from_numpy(a) for a in kk))
    t_enc, t_kk = pad_kp(PaddedComplex(**{k: torch.from_numpy(v) for k, v in fields.items()}), t_kk, 8)
    assert t_enc.kp_x.shape[1] == 24 and not t_enc.kp_mask[:, 20:].any()
    for k in ("kp_x", "kp_h", "kp_mask", "kp_v"):
        np.testing.assert_array_equal(getattr(t_enc, k).numpy(), np.asarray(getattr(j_enc, k)))
    for a, b in zip(t_kk if layout == "nbr" else (t_kk,), j_kk if layout == "nbr" else (j_kk,)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_block_layout_rejected_with_hint():
    """The block kk layout is refused with the compact_kk hint, by pad_kp and shard_encoded."""
    from kpdiff_tpu_torch.models.complex import PaddedComplex
    from kpdiff_tpu_torch.parallel.mesh import Mesh

    fields, _ = _jax_enc()
    enc = PaddedComplex(**{k: torch.from_numpy(v) for k, v in fields.items()})
    block = Blocks(torch.zeros((2, 2, 30, 10), dtype=torch.bool))
    with pytest.raises(ValueError, match="compact_kk"):
        pad_kp(enc, block, 8)
    mesh = Mesh(("model",), (2,), (0,), (None,), torch.device("cpu"))
    with pytest.raises(ValueError, match="compact_kk"):
        shard_encoded(enc, block, mesh)
