"""Every model family of configs/ through kpdiff_tpu_torch against kpdiff_tpu
on the CPU: the spatial sort and block layout, the fixed encoder and its kk
edges (the rr cutoff), EGNN dynamics on block kk, a reduced chain and loss
of each config, the trained archives, and the serving API on a fixed and a
GVP family. Inputs come from numpy seeds and molgen; the weights are the
port's seeded init carried into a JAX param tree; f32 at rtol 1e-4 /
atol 1e-5, bf16 at 2e-2 of the output's scale."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kpdiff_tpu.config import load_config as jload
from kpdiff_tpu_torch.config import load_config as tload, model_from_config as tmodel
from kpdiff_tpu_torch.ops.edge_sets import Blocks
from torch_port_util import assert_close, assert_rel_max, edge_set, family_setup, reduce_family

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted(p.stem for p in (ROOT / "configs").glob("*.yml"))
RTOL, ATOL = 1e-4, 1e-5


def _jnp(x):
    return jnp.asarray(x.detach().cpu().numpy())


@pytest.mark.parametrize("name", CONFIGS)
def test_config_chain_and_loss_match_jax(name):
    """A 3-step strided chain on injected noise (encode, kk, sample) and the
    loss on injected (t, eps), f32, dropout 0, reduced depth and width."""
    cfg = reduce_family(jload(ROOT / f"configs/{name}.yml"))
    jm, jp, tm, tb, jb = family_setup(cfg)
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
    if isinstance(kk, Blocks):
        np.testing.assert_array_equal(kk.adj.numpy(), np.asarray(jkk["block"]))
    else:
        assert edge_set(kk) == edge_set(jkk)
    assert_close(enc.kp_x, jenc.kp_x, RTOL, ATOL, f"{name}: kp_x")
    assert_close(enc.kp_h, jenc.kp_h, RTOL, ATOL, f"{name}: kp_h")
    for k in ("lig_x", "lig_h"):
        assert torch.isfinite(out[k]).all()
        assert_close(out[k], jout[k], RTOL, ATOL, f"{name}: {k}")

    t_eps = (rng.integers(0, cfg["diffusion"]["n_timesteps"], b), rng.normal(size=(b, n, 3)).astype(np.float32),
             rng.normal(size=(b, n, f)).astype(np.float32))
    got = tm.loss(tb, t_eps_override=t_eps)
    want = jax.jit(lambda p, c, te: jm.loss(p, jax.random.key(1), c, t_eps_override=te))(
        jp, jb, (jnp.asarray(t_eps[0].astype(np.int32)), jnp.asarray(t_eps[1]), jnp.asarray(t_eps[2])))
    assert set(got) == set(want)
    for k in want:
        assert_close(got[k], want[k], RTOL, ATOL, f"{name}: loss {k}")


# ---- spatial sort and block windows (kpdiff_tpu/ops/spatial.py)

def _points(seed, b=3, n=48, quantize=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, 3)).astype(np.float32) * 4
    if quantize:  # coarse grid: many points share a Morton code, so the sort must be stable
        x = np.round(x / 3.0).astype(np.float32) * 3.0
    mask = rng.random((b, n)) < 0.8
    return x, mask


@pytest.mark.parametrize("quantize", [False, True], ids=["distinct", "tied"])
def test_morton_sort_matches_jax(quantize):
    from kpdiff_tpu.ops import spatial as js
    from kpdiff_tpu_torch.ops import spatial as ts

    x, mask = _points(0, quantize=quantize)
    code = ts.morton_code(torch.from_numpy(x), torch.from_numpy(mask))
    assert code.dtype == torch.int32
    np.testing.assert_array_equal(code.numpy(), np.asarray(js.morton_code(jnp.asarray(x), jnp.asarray(mask))))
    assert int(code[~torch.from_numpy(mask)].min()) == 2 ** 30
    perm = ts.spatial_sort_permutation(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(js.spatial_sort_permutation(jnp.asarray(x),
                                                                                        jnp.asarray(mask))))


def test_choose_tile_and_block_windows_match_jax():
    from kpdiff_tpu.ops import spatial as js
    from kpdiff_tpu_torch.ops import spatial as ts

    for n, tile in ((384, 64), (48, 64), (100, 64), (128, 64), (48, 16)):
        assert ts.choose_tile(n, tile) == js.choose_tile(n, tile)
    arr = np.random.default_rng(1).normal(size=(2, 48, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(ts.block_windows(torch.from_numpy(arr), 16).numpy(),
                                  np.asarray(js.block_windows(jnp.asarray(arr), 16)))
    with pytest.raises(ValueError):
        ts.block_windows(torch.from_numpy(arr), 20)


# ---- the fixed encoder and its kk edges

def _reduced(name, **over):
    cfg = reduce_family(jload(ROOT / f"configs/{name}.yml"))
    for section, values in over.items():
        cfg[section].update(values)
    return cfg


@pytest.mark.parametrize("name", ["egnn_ca", "egnn_all_atom", "gvp_ca", "gvp_all_atom"])
def test_fixed_encode_matches_jax(name):
    """Keypoints are the pocket atoms, Morton-sorted for block kk, with a
    zero kp_v for GVP."""
    jm, jp, tm, tb, jb = family_setup(_reduced(name))
    enc, _ = tm.encode(tb)
    jenc, _ = jm.encode(jp, jb)
    for k in ("kp_x", "kp_h", "kp_mask"):
        np.testing.assert_array_equal(getattr(enc, k).numpy(), np.asarray(getattr(jenc, k)), err_msg=k)
    assert (enc.kp_v is None) == (jenc.kp_v is None) == (not name.startswith("gvp"))
    if enc.kp_v is not None:
        assert enc.kp_v.shape == jenc.kp_v.shape and not enc.kp_v.any()
    if "all_atom" in name:
        assert not torch.equal(enc.kp_x, tb.rec_x)  # sorted
    else:
        assert torch.equal(enc.kp_x, tb.rec_x)


@pytest.mark.parametrize("layout", ["dense", "nbr"])
def test_fixed_kk_edges_match_jax(layout):
    from kpdiff_tpu.models.encoder_fixed import fixed_kk_edges as j_fixed_kk
    from kpdiff_tpu_torch.models.encoder_fixed import fixed_kk_edges

    jm, jp, tm, tb, jb = family_setup(_reduced("egnn_ca"))
    enc, _ = tm.encode(tb)
    jenc, _ = jm.encode(jp, jb)
    got = fixed_kk_edges(enc, 3.5, layout=layout, max_neighbors=12)
    want = j_fixed_kk(jenc, 3.5, layout=layout, max_neighbors=12)
    assert edge_set(got) == edge_set(want) and len(edge_set(got)) > 20


@pytest.mark.parametrize("name", ["egnn_ca", "gvp_ca"])
def test_fixed_encoder_kk_uses_rr_cutoff(name):
    """With a fixed encoder, kk is the rr radius graph (rr 3.5 here, kk 8):
    _kk_edges and compact_kk give JAX's edge sets, and those differ from the
    kk-cutoff graph."""
    from kpdiff_tpu_torch.ops.neighbors import dense_radius_adjacency

    cfg = _reduced(name)
    assert cfg["graph"]["graph_cutoffs"]["rr"] != cfg["graph"]["graph_cutoffs"]["kk"]
    jm, jp, tm, tb, jb = family_setup(cfg)
    enc, kk = tm.encode(tb)
    jenc, jkk = jm.encode(jp, jb)
    assert edge_set(kk) == edge_set(jkk)
    wrong = dense_radius_adjacency(enc.kp_x, enc.kp_mask, enc.kp_x, enc.kp_mask, 8.0, exclude_self=True)
    assert edge_set(kk) < edge_set(wrong)
    compact = tm.compact_kk(enc, kk)
    assert isinstance(compact, tuple) and edge_set(compact) == edge_set(jm.compact_kk(jenc, jkk)) == edge_set(kk)


@pytest.mark.parametrize("name", ["egnn_all_atom", "gvp_all_atom"])
def test_block_kk_edges_match_jax(name):
    """The banded block adjacency equals JAX's, excludes each destination's
    own window row (tile + j), and compact_kk rebuilds the exact rr radius
    graph from it."""
    from kpdiff_tpu_torch.ops.neighbors import dense_radius_adjacency

    jm, jp, tm, tb, jb = family_setup(_reduced(name))
    enc, kk = tm.encode(tb)
    jenc, jkk = jm.encode(jp, jb)
    adj = kk.adj
    assert adj.shape == (4, 3, 48, 16)
    np.testing.assert_array_equal(adj.numpy(), np.asarray(jkk["block"]))
    j = torch.arange(16)
    assert not adj[:, :, j + 16, j].any()
    compact = tm.compact_kk(enc, kk)
    exact = dense_radius_adjacency(enc.kp_x, enc.kp_mask, enc.kp_x, enc.kp_mask, 3.5, exclude_self=True)
    assert edge_set(compact) == edge_set(exact) == edge_set(jm.compact_kk(jenc, jkk))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_egnn_dynamics_block_kk_matches_jax(dtype):
    """EGNN dynamics on block kk windows (the dense edge module on
    (B * nt, 3 * tile, tile) grids) against JAX's block branch."""
    cfg = _reduced("egnn_all_atom")
    cfg["dynamics"]["compute_dtype"] = dtype
    jm, jp, tm, tb, jb = family_setup(cfg)
    with torch.no_grad():
        enc, kk = tm.encode(tb)
        tt = torch.full((4,), 0.3)
        eps_h, eps_x = tm.dynamics(tb.lig_x, tb.lig_h, tb.lig_mask, enc.kp_x, enc.kp_h, enc.kp_mask, tt, kk)
    jenc, jkk = jm.encode(jp, jb)
    jh, jx = jax.jit(lambda p: jm._apply_dynamics(p, jb.lig_x, jb.lig_h, jb.lig_mask, jenc.kp_x, jenc.kp_h,
                                                  jenc.kp_mask, jnp.full((4,), 0.3), jkk))(jp)
    if dtype == "float32":
        assert_close(eps_h, jh, RTOL, ATOL, "eps_h")
        assert_close(eps_x, jx, RTOL, ATOL, "eps_x")
    else:
        assert_rel_max(eps_h, jh, 2e-2, "eps_h")
        assert_rel_max(eps_x, jx, 2e-2, "eps_x")


# ---- the trained archives

ARCHIVES = sorted(p.name[:-len("_trained_params.npz")] for p in (ROOT / "artifacts").glob("*_trained_params.npz"))


@pytest.mark.parametrize("name", ARCHIVES)
def test_trained_archive_loads(name):
    """Every leaf of artifacts/<name>_trained_params.npz loads (none missing,
    extra or mis-shaped); for gvp_40kp and egnn_all_atom one full-width f32
    dynamics call at batch 1 matches JAX on the trained weights."""
    from kpdiff_tpu_torch.utils.params_io import load_params, read_keystr_npz

    assert len(ARCHIVES) == 8
    cfg = tload(ROOT / f"configs/{name}.yml")
    flat = read_keystr_npz(ROOT / "artifacts" / f"{name}_trained_params.npz")
    tm = tmodel(cfg, device="cpu")
    load_params(tm, flat)
    assert set(flat) == {n for n, _ in tm.named_parameters()}
    if name not in ("gvp_40kp", "egnn_all_atom"):
        return
    from torch_port_util import jax_tree

    jcfg = jload(ROOT / f"configs/{name}.yml")
    for section in ("dynamics", "dynamics_gvp"):
        if section in jcfg:
            jcfg[section]["compute_dtype"] = "float32"
    jcfg["padding"]["n_rec"] = 128  # full width; a 128-atom pocket keeps the CPU call short (two block tiles)
    tm = tmodel(jcfg, device="cpu")
    load_params(tm, flat)
    jm, jp, _, tb, jb = family_setup(jcfg, batch=1)
    jp = jax_tree(flat)
    with torch.no_grad():
        enc, kk = tm.encode(tb)
        tt = torch.full((1,), 0.37)
        eps_h, eps_x = tm._apply_dynamics(tm.dynamics, tb.lig_x, tb.lig_h, tb.lig_mask, enc.kp_x, enc.kp_h,
                                          enc.kp_mask, tt, kk, enc.kp_v)
    jenc, jkk = jax.jit(jm.encode)(jp, jb)
    jh, jx = jax.jit(lambda p: jm._apply_dynamics(p, jb.lig_x, jb.lig_h, jb.lig_mask, jenc.kp_x, jenc.kp_h,
                                                  jenc.kp_mask, jnp.full((1,), 0.37), jkk, jenc.kp_v))(jp)
    assert_close(eps_h, jh, RTOL, ATOL, f"{name}: eps_h")
    assert_close(eps_x, jx, RTOL, ATOL, f"{name}: eps_x")


# ---- serving on the CPU

@pytest.mark.parametrize("name", ["gvp_40kp", "egnn_ca"])
def test_sampler_from_params_on_cpu(name, tmp_path):
    """KeypointSampler.from_params on a reduced config and a keystr npz
    answers on the CPU: molecules of the asked size, no kernel launch; a
    fixed encoder's kk is the compacted rr graph."""
    import yaml

    from kpdiff_tpu_torch.models.complex import synthetic_complex_np
    from kpdiff_tpu_torch.ops.cuda import egnn_edge
    from kpdiff_tpu_torch.serve import KeypointSampler
    from kpdiff_tpu_torch.utils.params_io import export_flat, save_keystr_npz

    cfg = _reduced(name)
    cfg["diffusion"]["n_timesteps"] = 8
    cfg_path = tmp_path / "reduced.yml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    npz = tmp_path / "params.npz"
    save_keystr_npz(export_flat(tmodel(cfg, device="cpu", seed=4)), npz)
    sampler = KeypointSampler.from_params(cfg_path, npz, batch_size=4, device="cpu", seed=3)
    n_feat = 20 if name.endswith("_ca") else 10
    pocket = synthetic_complex_np(np.random.default_rng(6), 40, 10, 40, 10, n_feat, 10)
    before = egnn_edge.launches
    mols = sampler.sample_for_arrays(pocket["rec_x"], pocket["rec_h"], pocket["rec_res_idx"],
                                     init_com=pocket["lig_x"].mean(0), n_mols=6, ligand_size=9)
    assert egnn_edge.launches == before
    chunks = sampler.last_request["chunks"]
    assert [c["sizes"] for c in chunks] == [[9] * 4, [9] * 2]
    assert all(c["kk"] == ("dense" if name == "gvp_40kp" else c["kk"]) for c in chunks)
    if name == "egnn_ca":
        assert chunks[0]["kk"].startswith("nbr")
    for m in mols:
        assert 1 <= m.n_atoms <= 9 and np.isfinite(m.coords).all()


def test_byop_ca_only_pocket(tmp_path):
    """A *_ca config's pocket from a receptor PDB: one Cα node per pocket
    residue, the 20 residue one-hots, no interface points; the all-atom
    config's pocket has the same residues. The Cα pocket equals the one
    kpdiff_tpu's processing CLI (process_bindingmoad, ca_only) cuts from the
    same receptor with the ligand as HETATM records."""
    from chip_smoke import write_synthetic_complex
    from kpdiff_tpu.cli.process_bindingmoad import process_ligand_and_pocket as jax_pocket
    from kpdiff_tpu.data.pdb import parse_pdb
    from kpdiff_tpu.data.pocket import make_element_map
    from kpdiff_tpu_torch.cli.byop import process_ligand_and_pocket
    from kpdiff_tpu_torch.constants import aa_to_idx
    from kpdiff_tpu_torch.data.pdb import format_pdb_line
    from kpdiff_tpu_torch.data.sdf import SdfMol, parse_sdf, write_sdf

    ca_cfg, aa_cfg = tload(ROOT / "configs/egnn_ca.yml"), tload(ROOT / "configs/egnn_40kp.yml")
    pdb, sdf = write_synthetic_complex(np.random.default_rng(3), tmp_path, aa_cfg["dataset"]["lig_elements"])
    # the ligand at the PDB's precision, in the SDF and as HETATM records of a complex PDB
    lig = parse_sdf(sdf)[0]
    lig = SdfMol(lig.title, lig.elements, np.round(lig.coords, 3), lig.bonds)
    write_sdf([lig], sdf)
    rec_lines = [ln for ln in pdb.read_text().splitlines() if ln.startswith("ATOM")]
    het = [format_pdb_line(len(rec_lines) + i + 1, f"{el}{i + 1}", "LIG", "B", 1, *x, el, hetero=True)
           for i, (el, x) in enumerate(zip(lig.elements, lig.coords))]
    complex_pdb = tmp_path / "complex.pdb"
    complex_pdb.write_text("\n".join(rec_lines + het) + "\nEND\n")
    ds = ca_cfg["dataset"]
    want = jax_pocket(parse_pdb(complex_pdb, remove_hydrogen=True), "LIG", "B", 1,
                      make_element_map(ds["rec_elements"]), make_element_map(ds["lig_elements"]),
                      pocket_cutoff=ds["pocket_cutoff"], ca_only=True)
    ca = process_ligand_and_pocket(str(pdb), str(sdf), ca_cfg)
    full = process_ligand_and_pocket(str(pdb), str(sdf), aa_cfg)
    n_res = len(np.unique(full["rec_res_idx"]))
    assert ca["rec_feat"].shape == (n_res, 20) and ca["rec_pos"].shape == (n_res, 3)
    assert (ca["rec_feat"].argmax(1) == aa_to_idx["E"]).all() and (ca["rec_feat"].sum(1) == 1).all()
    assert ca["interface_points"].shape == (0, 3) and full["interface_points"].shape[0] > 0
    assert set(ca["rec_atoms"].name) == {"CA"}
    np.testing.assert_array_equal(ca["rec_pos"], ca["rec_atoms"].coords.astype(np.float32))
    np.testing.assert_array_equal(ca["rec_res_idx"], np.arange(n_res))
    for key in ("rec_pos", "rec_feat", "rec_res_idx", "interface_points"):
        assert ca[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(ca[key], want[key], err_msg=key)
