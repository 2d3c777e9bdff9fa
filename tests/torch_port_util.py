"""Shared helpers of the tests that hold kpdiff_tpu_torch against kpdiff_tpu:
parameters cross from a JAX init tree to the port as numpy arrays keyed by
dotted paths, inputs come from numpy seeds."""
from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from kpdiff_tpu.config import load_config as jload, model_from_config as jmodel
from kpdiff_tpu_torch.config import PaddingConfig, model_from_config as tmodel, resolve_feature_sizes
from kpdiff_tpu_torch.data.dataset import PaddedLoader
from kpdiff_tpu_torch.data.molgen import molgen_splits_for_config
from kpdiff_tpu_torch.utils.params_io import export_flat, load_params

ROOT = Path(__file__).resolve().parents[1]


def jax_flat(params, prefix: str = "") -> dict:
    """{dotted path: numpy array} of a JAX param tree (a 'params' level dropped)."""
    if isinstance(params, dict) and set(params) == {"params"}:
        params = params["params"]
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        name = ".".join(str(getattr(p, "key", p)) for p in path)
        out[f"{prefix}.{name}" if prefix else name] = np.asarray(leaf, np.float32)
    return out


def jax_tree(flat: dict) -> dict:
    """{dotted path: array} -> nested dict of jnp arrays (the flax param tree)."""
    params = {}
    for name, v in flat.items():
        node = params
        *parents, leaf = name.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(v)
    return params


def jax_complex(cpx, n_kp: int, kp_feat_dim: int, kp_vec_dim=None):
    """A port PaddedComplex's padded inputs as a kpdiff_tpu PaddedComplex."""
    from kpdiff_tpu.models.complex import make_complex

    a = {f: getattr(cpx, f).detach().cpu().numpy() for f in
         ("rec_x", "rec_h", "rec_mask", "rec_res_idx", "lig_x", "lig_h", "lig_mask", "ip_x", "ip_mask")}
    return make_complex(a["rec_x"], a["rec_h"], a["rec_mask"], a["lig_x"], a["lig_h"], a["lig_mask"],
                        n_kp=n_kp, kp_feat_dim=kp_feat_dim, kp_vec_dim=kp_vec_dim, rec_res_idx=a["rec_res_idx"],
                        ip_x=a["ip_x"], ip_mask=a["ip_mask"])


def load_from_jax(module: torch.nn.Module, params, prefix: str = "") -> torch.nn.Module:
    load_params(module, jax_flat(params, prefix))
    return module


def t(a, dtype=None):
    """numpy / JAX array -> CPU tensor."""
    x = torch.from_numpy(np.array(a))
    return x if dtype is None else x.to(dtype)


def same(a, b) -> bool:
    """Equality that also demands equal types (1 != 1.0 != True here)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


def assert_close(got, want, rtol, atol, msg=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol, atol=atol, err_msg=msg)


def assert_rel_max(got, want, tol, msg=""):
    """max|got - want| <= tol * max|want| (the bf16 comparisons)."""
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    scale = max(np.abs(want).max(), 1e-30)
    assert err <= tol * scale, f"{msg}: max abs err {err:.3e} > {tol} * {scale:.3e}"


# ---- a reduced egnn_40kp training setup shared by the loss and trainer tests

def reduced_config(dtype="float32", **dataset):
    cfg = jload(ROOT / "configs/egnn_40kp.yml")
    cfg["dynamics"].update(n_layers=2, hidden_nf=16, compute_dtype=dtype)
    cfg["rec_encoder"].update(n_convs=2, hidden_n_node_feat=16, out_n_node_feat=12, compute_dtype=dtype)
    cfg["graph"]["n_keypoints"] = 6
    cfg["padding"].update(n_rec=48, n_lig=16, n_ip=16)
    cfg["dataset"].update(dataset)
    return cfg


CASES = {
    "flagship": {},  # sinkhorn OT on the interface points
    "hinge_exact_rec": dict(diffusion=dict(rl_dist_threshold=2.0),
                            rec_encoder_loss=dict(method="exact", use_interface_points=False)),
    "fake_intent": dict(dataset=dict(max_fake_atom_frac=0.3)),
    "fake_executed": dict(dataset=dict(max_fake_atom_frac=0.3),
                          diffusion=dict(fake_atom_loss_semantics="executed")),
}


def case_setup(case, dtype="float32", seed=0):
    """A reduced egnn_40kp config with one of CASES' changes, the same weights
    in both packages (the port's seeded init carried into a JAX param tree),
    a molgen batch of 4 through the port's loader and injected (t, eps):
    (JAX model, JAX params, port model, port batch, JAX batch, (t, eps_x, eps_h))."""
    over = CASES[case]
    cfg = reduced_config(dtype, **over.get("dataset", {}))
    for section in ("diffusion", "rec_encoder_loss"):
        cfg[section].update(over.get(section, {}))
    pad = PaddingConfig.from_config(cfg)
    train_ds, _ = molgen_splits_for_config(cfg, pad, resolve_feature_sizes(cfg)[0], 12, seed)
    loader = PaddedLoader(train_ds, pad, 4, pad.n_kp, 12, max_fake_atom_frac=cfg["dataset"]["max_fake_atom_frac"],
                          seed=seed, drop_last=True)
    batch = next(loader.epoch())
    tm = tmodel(cfg, device="cpu", seed=seed + 1)
    jm = jmodel(cfg)
    rng = np.random.default_rng(seed + 2)
    b, n, f = batch.lig_h.shape
    t_eps = (rng.integers(0, cfg["diffusion"]["n_timesteps"], b), rng.normal(size=(b, n, 3)).astype(np.float32),
             rng.normal(size=(b, n, f)).astype(np.float32))
    return jm, jax_tree(export_flat(tm)), tm, batch, jax_complex(batch, pad.n_kp, 12), t_eps


def jax_t_eps(t_eps):
    return (jnp.asarray(t_eps[0].astype(np.int32)), jnp.asarray(t_eps[1]), jnp.asarray(t_eps[2]))


# ---- every model family of configs/, at reduced depth and width

def reduce_family(cfg, dtype="float32", n_rec=48, block=16):
    """`cfg` (a configs/*.yml dict) cut to a few layers and narrow widths,
    dropout 0 and compute dtype `dtype`, at n_rec pocket atoms, 16 ligand
    atoms and 6 learned keypoints; block kk layouts get tiles of `block`
    (three windows at n_rec 48)."""
    cfg["padding"].update(n_rec=n_rec, n_lig=16, n_ip=16)
    cfg["graph"]["n_keypoints"] = 6
    if "dynamics" in cfg:
        cfg["dynamics"].update(n_layers=2, hidden_nf=16, compute_dtype=dtype)
        cfg["rec_encoder"].update(n_convs=2, hidden_n_node_feat=16, out_n_node_feat=12, compute_dtype=dtype)
    if "dynamics_gvp" in cfg:
        cfg["dynamics_gvp"].update(n_convs=2, n_hidden_scalars=12, vector_size=4, n_message_gvps=2,
                                   n_update_gvps=1, n_noise_gvps=2, dropout=0.0, compute_dtype=dtype)
        cfg["rec_encoder_gvp"].update(out_scalar_size=10, vector_size=4, n_rr_convs=2, n_rk_convs=2,
                                      n_message_gvps=2, n_update_gvps=1, dropout=0.0, compute_dtype=dtype)
    for section in ("dynamics", "dynamics_gvp"):
        if cfg.get(section, {}).get("kk_layout") == "block":
            cfg[section]["kk_block_size"] = block
    return cfg


def family_setup(cfg, seed=0, batch=4):
    """The same weights in both packages (the port's seeded init carried into
    a JAX param tree) and a molgen batch through the port's loader:
    (JAX model, JAX params, port model, port batch, JAX batch)."""
    pad = PaddingConfig.from_config(cfg)
    train_ds, _ = molgen_splits_for_config(cfg, pad, resolve_feature_sizes(cfg)[0], 3 * batch, seed)
    tm = tmodel(cfg, device="cpu", seed=seed + 1)
    loader = PaddedLoader(train_ds, pad, batch, pad.n_kp, tm.cfg.rec_nf, seed=seed, drop_last=True,
                          kp_vec_dim=tm.kp_vec_dim)
    tb = next(loader.epoch())
    return (jmodel(cfg), jax_tree(export_flat(tm)), tm, tb,
            jax_complex(tb, pad.n_kp, tm.cfg.rec_nf, tm.kp_vec_dim))


def edge_set(kk):
    """{(b, dst, src)} of a dense adjacency (B, Ns, Nd) or a neighbor list (idx, valid)."""
    if isinstance(kk, tuple):
        idx, valid = (np.asarray(a) for a in kk)
        return {(b, d, int(idx[b, d, k])) for b, d, k in zip(*np.nonzero(valid))}
    return {(b, d, s) for b, s, d in zip(*np.nonzero(np.asarray(kk)))}
