"""The port's host front end against kpdiff_tpu on the same files: PDB,
mmCIF and SDF parsing (every field equal), the writers (byte-identical
text), pocket extraction and byop's process_ligand_and_pocket (arrays
equal), from a seeded synthetic receptor and ligand and its mmCIF
rendering."""
import dataclasses

import numpy as np
import pytest

from kpdiff_tpu.cli import byop as jbyop
from kpdiff_tpu.data import mmcif as jmmcif, pdb as jpdb, pocket as jpocket, sdf as jsdf
from kpdiff_tpu_torch import constants as tconst
from kpdiff_tpu_torch.cli import byop as tbyop
from kpdiff_tpu_torch.data import mmcif as tmmcif, pdb as tpdb, pocket as tpocket, sdf as tsdf
from kpdiff_tpu import constants as jconst
from test_cli import TINY_CONFIG, _write_synthetic_complex_pdb_sdf
from test_mmcif import _synthetic_structure, _write_mmcif


def assert_same_fields(got, want):
    """Dataclasses (or dicts) equal field by field; arrays exactly, with dtype."""
    g = dataclasses.asdict(got) if dataclasses.is_dataclass(got) else got
    w = dataclasses.asdict(want) if dataclasses.is_dataclass(want) else want
    assert g.keys() == w.keys()
    for k in w:
        if isinstance(w[k], np.ndarray):
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        elif dataclasses.is_dataclass(w[k]):
            assert_same_fields(g[k], w[k])
        else:
            assert g[k] == w[k], k


def _structure_files(tmp_path, seed=0):
    rows = _synthetic_structure(n_res=8, seed=seed)
    lines = [tpdb.format_pdb_line(i + 1, name, rn, ch, rs, *xyz, el, hetero=grp == "HETATM")
             for i, (grp, name, el, rn, ch, rs, xyz) in enumerate(rows)]
    want = [jpdb.format_pdb_line(i + 1, name, rn, ch, rs, *xyz, el, hetero=grp == "HETATM")
            for i, (grp, name, el, rn, ch, rs, xyz) in enumerate(rows)]
    assert lines == want
    pdb = tmp_path / "s.pdb"
    pdb.write_text("\n".join(lines) + "\nEND\n")
    cif = tmp_path / "s.cif"
    _write_mmcif(rows, cif)
    return pdb, cif


def test_constants_equal():
    assert tconst.allowed_bonds == jconst.allowed_bonds
    assert tconst.protein_letters_3to1 == jconst.protein_letters_3to1 and tconst.aa_to_idx == jconst.aa_to_idx


@pytest.mark.parametrize("remove_hydrogen", [False, True])
@pytest.mark.parametrize("remove_water", [False, True])
def test_parse_pdb_and_mmcif_match_jax(tmp_path, remove_hydrogen, remove_water):
    pdb, cif = _structure_files(tmp_path)
    kw = dict(remove_hydrogen=remove_hydrogen, remove_water=remove_water)
    assert_same_fields(tpdb.parse_pdb(pdb, **kw), jpdb.parse_pdb(pdb, **kw))
    assert_same_fields(tmmcif.parse_mmcif(cif, **kw), jmmcif.parse_mmcif(cif, **kw))
    for path in (pdb, cif):
        assert_same_fields(tmmcif.parse_structure(path, **kw), jmmcif.parse_structure(path, **kw))


@pytest.mark.parametrize("renumber", [False, True])
def test_pdb_writers_byte_identical(tmp_path, renumber):
    pdb, _ = _structure_files(tmp_path, seed=3)
    atoms = tpdb.parse_pdb(pdb)
    sel = np.arange(len(atoms)) % 3 != 1
    tpdb.write_pdb(atoms.select(sel), tmp_path / "t.pdb", renumber=renumber)
    jpdb.write_pdb(jpdb.parse_pdb(pdb).select(sel), tmp_path / "j.pdb", renumber=renumber)
    assert (tmp_path / "t.pdb").read_bytes() == (tmp_path / "j.pdb").read_bytes()
    coords = np.random.default_rng(1).normal(size=(7, 3)).astype(np.float32) * 5
    els = ["C", "N", "O", "S", "Cl", "C", "F"]
    assert tpdb.write_xyz(coords, els, tmp_path / "t.xyz") == jpdb.write_xyz(coords, els, tmp_path / "j.xyz")
    assert (tmp_path / "t.xyz").read_bytes() == (tmp_path / "j.xyz").read_bytes()


def test_write_mmcif_parses_back_as_the_pdb(tmp_path):
    """The port's mmCIF writer (which the JAX package lacks): the rendered
    file parses, in both packages, to the PDB's atom table."""
    pdb, _ = _structure_files(tmp_path, seed=5)
    atoms = tpdb.parse_pdb(pdb, remove_water=False)
    tmmcif.write_mmcif(atoms, tmp_path / "w.cif")
    for parse in (tmmcif.parse_mmcif, jmmcif.parse_mmcif):
        back = parse(tmp_path / "w.cif", remove_water=False)
        for f in ("name", "element", "resname", "chain"):
            assert getattr(back, f) == getattr(atoms, f), f
        for f in ("resseq", "res_index", "coords", "is_hetero"):
            np.testing.assert_array_equal(getattr(back, f), getattr(atoms, f), err_msg=f)


def _sdf_mols(seed=0, n=3):
    rng = np.random.default_rng(seed)
    mols = []
    for i in range(n):
        k = int(rng.integers(3, 12))
        els = [["C", "N", "O", "H", "Cl", "S"][j] for j in rng.integers(0, 6, k)]
        bonds = [(j, j + 1, int(rng.integers(1, 3))) for j in range(k - 1)]
        mols.append(tsdf.SdfMol(title=f"m{i}", elements=els,
                                coords=(rng.normal(size=(k, 3)) * 20).astype(np.float32), bonds=bonds))
    return mols


def test_sdf_write_and_parse_match_jax(tmp_path):
    mols = _sdf_mols()
    jmols = [jsdf.SdfMol(m.title, m.elements, m.coords, m.bonds) for m in mols]
    tsdf.write_sdf(mols, tmp_path / "t.sdf")
    jsdf.write_sdf(jmols, tmp_path / "j.sdf")
    tsdf.write_sdf(mols[:1], tmp_path / "t.sdf", append=True)
    jsdf.write_sdf(jmols[:1], tmp_path / "j.sdf", append=True)
    assert (tmp_path / "t.sdf").read_bytes() == (tmp_path / "j.sdf").read_bytes()
    assert [tsdf.mol_block(m) for m in mols] == [jsdf.mol_block(m) for m in jmols]
    got, want = tsdf.parse_sdf(tmp_path / "t.sdf"), jsdf.parse_sdf(tmp_path / "t.sdf")
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert_same_fields(g, w)
        assert_same_fields(g.without_hydrogens(), w.without_hydrogens())


def test_featurizers_and_interface_points_match_jax():
    rng = np.random.default_rng(4)
    els = TINY_CONFIG["dataset"]["rec_elements"]
    assert tpocket.make_element_map(els) == jpocket.make_element_map(els)
    emap = tpocket.make_element_map(els)
    atoms = ["C", "N", "Zn", "O", "Se", "Cl"]
    for g, w in zip(tpocket.featurize_atoms(atoms, emap), jpocket.featurize_atoms(atoms, emap)):
        np.testing.assert_array_equal(g, w)
    lig = rng.normal(size=(9, 3)) * 2
    rec = rng.normal(size=(60, 3)) * 5
    np.testing.assert_array_equal(tpocket.get_interface_points(lig, rec), jpocket.get_interface_points(lig, rec))


def test_get_pocket_atoms_matches_jax(tmp_path):
    pdb, sdf = _write_synthetic_complex_pdb_sdf(tmp_path)
    atoms = tpdb.parse_pdb(pdb)
    lig = tsdf.parse_sdf(sdf)[0]
    emap = tpocket.make_element_map(TINY_CONFIG["dataset"]["rec_elements"])
    for cutoff in (4.0, 8.0):
        args = (atoms.coords, atoms.element, atoms.res_index, lig.coords)
        kw = dict(box_padding=8, pocket_cutoff=cutoff, element_map=emap)
        for g, w in zip(tpocket.get_pocket_atoms(*args, **kw), jpocket.get_pocket_atoms(*args, **kw)):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(tpocket.Unparsable):
        tpocket.get_pocket_atoms(atoms.coords, atoms.element, atoms.res_index, lig.coords + 500.0,
                                 box_padding=8, pocket_cutoff=8, element_map=emap)


@pytest.mark.parametrize("fmt", ["pdb", "mmcif"])
def test_process_ligand_and_pocket_matches_jax(tmp_path, fmt):
    pdb, sdf = _write_synthetic_complex_pdb_sdf(tmp_path)
    receptor = pdb
    if fmt == "mmcif":
        receptor = tmp_path / "prot.cif"
        tmmcif.write_mmcif(tpdb.parse_pdb(pdb), receptor)
    got = tbyop.process_ligand_and_pocket(str(receptor), str(sdf), TINY_CONFIG)
    want = jbyop.process_ligand_and_pocket(str(receptor), str(sdf), TINY_CONFIG)
    assert_same_fields(got, want)
    assert 0 < got["rec_pos"].shape[0] <= 48 and got["interface_points"].shape[0] > 0
