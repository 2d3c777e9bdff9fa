"""The port's host chemistry against kpdiff_tpu on the same molecules: bond
perception, fragments, build_molecule (every largest_frag/sanitize
combination), validity and canonical keys equal; the first-party
properties and evaluate_samples equal within 1e-12; the numpy pocket
minimization equal and its files byte-identical; size histograms and
draws for one seed exactly equal. Molecules: molgen's trees, the same
jittered, clouds, rings and two-fragment pairs, from numpy seeds. The
rdkit branches run only where rdkit is installed."""
import dataclasses

import numpy as np
import pytest

from kpdiff_tpu.analysis import chem_props as jchem, metrics as jmet, molecule_builder as jmb
from kpdiff_tpu.analysis import pocket_minimization as jmin, sa_score as jsa
from kpdiff_tpu.data.molgen import molecular_synthetic_dataset as jmolgen
from kpdiff_tpu.models import size_dist as jsize
from kpdiff_tpu_torch.analysis import chem_props as tchem, metrics as tmet, molecule_builder as tmb
from kpdiff_tpu_torch.analysis import pocket_minimization as tmin, sa_score as tsa
from kpdiff_tpu_torch.data.molgen import molecular_synthetic_dataset as tmolgen, random_molecule
from kpdiff_tpu_torch.models import size_dist as tsize

ELEMENTS = ["C", "N", "O", "S", "P", "F", "Cl", "Br", "I", "B"]


def _clouds(seed=0, n_tree=12):
    """(coords, elements) of molgen trees, jittered trees, random clouds, a
    six-ring with substituents and two trees far apart."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_tree):
        x, types = random_molecule(rng, int(rng.integers(6, 28)), ELEMENTS)
        els = [ELEMENTS[t] for t in types]
        out.append((x, els))
        out.append(((x + rng.normal(scale=0.35, size=x.shape)).astype(np.float32), els))
    for _ in range(4):
        n = int(rng.integers(3, 16))
        out.append(((rng.normal(size=(n, 3)) * 1.6).astype(np.float32),
                    [ELEMENTS[j] for j in rng.integers(0, 10, n)]))
    ang = np.arange(6) * np.pi / 3
    ring = np.stack([1.39 * np.cos(ang), 1.39 * np.sin(ang), np.zeros(6)], 1)
    subs = ring[[0, 3]] * (1 + 1.43 / 1.39)
    out.append((np.concatenate([ring, subs]).astype(np.float32), ["C"] * 5 + ["N", "O", "Cl"]))
    (a, ea), (b, eb) = out[0], out[2]
    out.append((np.concatenate([a, b + 30.0]).astype(np.float32), ea + eb))
    out.append((np.zeros((1, 3), np.float32), ["C"]))
    return out


def _same_mol(got, want):
    assert (got is None) == (want is None)
    if want is None:
        return
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    assert g.keys() == w.keys()
    for k in w:
        if isinstance(w[k], np.ndarray):
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
        else:
            assert g[k] == w[k], k


def _jmol(m):
    return None if m is None else jmb.BuiltMolecule(list(m.elements), m.coords, list(m.bonds), m.largest_frag_frac)


def test_bonds_fragments_and_valence_match_jax():
    for coords, els in _clouds():
        bonds = tmb.perceive_bonds(coords, els)
        assert bonds == jmb.perceive_bonds(coords, els)
        assert tmb.fragments(len(els), bonds) == jmb.fragments(len(els), bonds)
        assert [tmb.max_valence(e) for e in els] == [jmb.max_valence(e) for e in els]
    assert tmb.perceive_bonds(np.zeros((0, 3)), []) == []
    assert tmb.COVALENT_RADII == jmb.COVALENT_RADII and tmb.HAVE_RDKIT == jmb.HAVE_RDKIT


@pytest.mark.parametrize("largest_frag", [True, False])
@pytest.mark.parametrize("sanitize", [True, False])
def test_build_molecule_matches_jax(largest_frag, sanitize):
    n_none = 0
    for coords, els in _clouds(seed=1):
        got = tmb.build_molecule(coords, els, largest_frag=largest_frag, sanitize=sanitize)
        want = jmb.build_molecule(coords, els, largest_frag=largest_frag, sanitize=sanitize)
        _same_mol(got, want)
        n_none += got is None
        if got is not None:
            assert tmb.is_valid(got) == jmb.is_valid(_jmol(got))
            assert tmb.canonical_key(got) == jmb.canonical_key(_jmol(got))
            np.testing.assert_array_equal(got.degree(), _jmol(got).degree())
            assert dataclasses.asdict(got.to_sdf_mol("t")).keys() == dataclasses.asdict(
                _jmol(got).to_sdf_mol("t")).keys()
    assert tmb.build_molecule(np.zeros((0, 3)), []) is None
    if sanitize and not largest_frag:
        assert 0 < n_none < len(_clouds(seed=1))  # isolated atoms fail validity; both outcomes exercised


def _props_equal(got, want, tol=1e-12):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], float):
            assert abs(got[k] - want[k]) <= tol * max(1.0, abs(want[k])), (k, got[k], want[k])
        else:
            assert got[k] == want[k], k


def test_first_party_properties_match_jax():
    mols = [m for m in (tmb.build_molecule(c, e) for c, e in _clouds(seed=2)) if m is not None]
    assert len(mols) > 10
    _props_equal(tchem.first_party_properties(mols), jchem.first_party_properties([_jmol(m) for m in mols]))
    _props_equal(tmet.molecule_properties(mols), jmet.molecule_properties([_jmol(m) for m in mols]))
    assert tchem.first_party_properties([]) == jchem.first_party_properties([])


@pytest.mark.parametrize("with_train", [False, True])
def test_evaluate_samples_matches_jax(with_train):
    clouds = _clouds(seed=3)
    pos, els = [c for c, _ in clouds], [e for _, e in clouds]
    kw = {}
    if with_train:
        keys = {tmb.canonical_key(m) for m in (tmb.build_molecule(c, e) for c, e in clouds[:6]) if m is not None}
        counts = np.random.default_rng(0).integers(1, 50, len(ELEMENTS)).astype(float)
        kw = dict(train_keys=keys, train_type_counts=counts, element_list=ELEMENTS)
    got, want = tmet.evaluate_samples(pos, els, **kw), jmet.evaluate_samples(pos, els, **kw)
    _props_equal(got, want)
    assert ("novelty" in got) == with_train and ("atom_type_kl" in got) == with_train
    raw = [m for m in (tmb.build_molecule(c, e, largest_frag=False, sanitize=False) for c, e in clouds)]
    counts = tmet.atom_type_counts(raw, ELEMENTS)
    np.testing.assert_array_equal(counts, jmet.atom_type_counts([_jmol(m) for m in raw], ELEMENTS))
    q = np.arange(1, 11, dtype=float)
    assert tmet.atom_type_kl(counts, q) == jmet.atom_type_kl(counts, q)
    assert tmet.atom_valency_validity(raw) == jmet.atom_valency_validity([_jmol(m) for m in raw])


def test_pocket_minimization_matches_jax(tmp_path):
    mols = [m for m in (tmb.build_molecule(c, e) for c, e in _clouds(seed=4, n_tree=3)) if m is not None][:4]
    pocket = (np.random.default_rng(5).normal(size=(30, 3)) * 4).astype(np.float32)
    got, rmsd = tmin.minimize_ligand_in_pocket(mols[0], pocket, n_iters=30)
    want, jrmsd = jmin.minimize_ligand_in_pocket(_jmol(mols[0]), pocket, n_iters=30)
    _same_mol(got, want)
    assert rmsd == jrmsd and rmsd > 0
    assert tmin.rmsd(got.coords, mols[0].coords) == jmin.rmsd(want.coords, mols[0].coords)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    r_t = tmin.minimize_and_write(pocket, mols, tmp_path / "t", n_iters=20)
    r_j = jmin.minimize_and_write(pocket, [_jmol(m) for m in mols], tmp_path / "j", n_iters=20)
    assert r_t == r_j and len(r_t) == len(mols)
    for f in ("pocket_minimized_ligands.sdf", "pocket_min_rmsds.csv"):
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes()
    lo_t, _ = tmin.pocket_minimization(np.zeros((0, 3), np.float32), mols, n_iters=10)
    lo_j, _ = jmin.pocket_minimization(np.zeros((0, 3), np.float32), [_jmol(m) for m in mols], n_iters=10)
    for g, w in zip(lo_t, lo_j):
        _same_mol(g, w)


def test_size_distribution_matches_jax(tmp_path):
    """Histograms built from molgen's sizes, and the draws for one seed,
    exactly equal; a missing histogram raises FileNotFoundError naming it
    (the JAX package raises ValueError)."""
    kw = dict(lig_elements=ELEMENTS, n_rec_feat=10, lig_range=(8, 32), rec_range=(40, 120))
    ds, jds = tmolgen(40, seed=7, **kw), jmolgen(40, seed=7, **kw)
    rec, lig = np.diff(ds.rec_segments), np.diff(ds.lig_segments)
    np.testing.assert_array_equal(rec, np.diff(jds.rec_segments))
    got, want = tsize.build_joint_histogram(rec, lig), jsize.build_joint_histogram(rec, lig)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    path = tsize.save_dataset_histogram(ds, tmp_path)
    jsize.save_joint_histogram(tmp_path / "j.pkl", *want)
    assert path.read_bytes() == (tmp_path / "j.pkl").read_bytes()
    td, jd = tsize.LigandSizeDistribution(tmp_path), jsize.LigandSizeDistribution(tmp_path)
    np.testing.assert_array_equal(td.joint, jd.joint)
    pockets = np.array([30, 40, 77, 120, 500])  # out-of-range sizes clamp in both
    a = td.sample(pockets, 50, np.random.default_rng(11))
    b = jd.sample(pockets, 50, np.random.default_rng(11))
    np.testing.assert_array_equal(a, b)
    assert a.min() >= lig.min() and a.max() <= lig.max()
    with pytest.raises(FileNotFoundError, match="train_n_node_joint_dist.pkl"):
        tsize.LigandSizeDistribution(tmp_path / "absent")
    with pytest.raises(ValueError):
        jsize.LigandSizeDistribution(tmp_path / "absent")


def test_sa_score_without_rdkit_is_none():
    if tsa.HAVE_RDKIT:
        pytest.skip("rdkit is installed: the rdkit branch is compared below")
    assert tsa.calculate_sa_score(object()) is None and jsa.calculate_sa_score(object()) is None
    assert tmb.to_rdkit(tmb.build_molecule(*_clouds()[0])) is None


def test_rdkit_branch_matches_jax():
    pytest.importorskip("rdkit")
    mols = [m for m in (tmb.build_molecule(c, e) for c, e in _clouds(seed=6)) if m is not None]
    _props_equal(tmet.molecule_properties(mols), jmet.molecule_properties([_jmol(m) for m in mols]))
    for m in mols:
        assert tsa.calculate_sa_score(tmb.to_rdkit(m)) == jsa.calculate_sa_score(jmb.to_rdkit(_jmol(m)))
