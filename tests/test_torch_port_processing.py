"""Offline processing in kpdiff_tpu_torch against kpdiff_tpu on the same
synthetic raw files: process_bindingmoad (all-atom and ca_only) and
process_crossdocked (split pickles, type counts, size histogram, molecule
keys), process_pdbbind / PDBbindDataset, write_pocket_file and
gen_commands; then raw -> process -> train -> sample (--ligand_size random)
-> metrics through the port's CLIs on the CPU at a tiny config, and
the tracer on the CPU."""
import copy
import pickle
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from kpdiff_tpu_torch.data.pdb import format_pdb_line
from kpdiff_tpu_torch.data.sdf import SdfMol, write_sdf

RESIDUES = (("N", "N"), ("CA", "C"), ("C", "C"), ("O", "O"), ("CB", "C"), ("OG", "O"))


def _ligand(rng, center, n):
    pos = center + np.cumsum(rng.normal(scale=0.15, size=(n, 3)) + np.array([1.4, 0.1, 0.0]), axis=0)
    pos -= pos.mean(0) - center
    elements = ["N" if j % 5 == 2 else "O" if j % 7 == 4 else "C" for j in range(n)]
    return pos, elements


def _protein_lines(rng, center, n_res, resnames=("SER", "ALA", "GLY", "THR")):
    lines = []
    for res in range(n_res):
        d = rng.normal(size=3)
        base = center + d / np.linalg.norm(d) * rng.uniform(4.5, 8.0)
        resname = resnames[res % len(resnames)]
        for name, el in RESIDUES:
            x, y, z = base + rng.normal(scale=0.6, size=3)
            lines.append(format_pdb_line(len(lines) + 1, name, resname, "A", res + 1, x, y, z, el))
    return lines


def write_moad_raw(root, n=6, seed=7):
    """BindingMOAD layout: {id}.bio1 assemblies (a protein shell around a
    HETATM ligand LIG A 201, plus a water) and moad_{train,val,test}.txt."""
    rng = np.random.default_rng(seed)
    data, splits = root / "moad", root / "splits"
    data.mkdir()
    splits.mkdir()
    ids = [f"{i + 1}abc" for i in range(n)]
    center = np.array([10.0, 10.0, 10.0])
    for pid in ids:
        lines = _protein_lines(rng, center, int(rng.integers(8, 12)))
        pos, els = _ligand(rng, center, int(rng.integers(8, 13)))
        for j, ((x, y, z), el) in enumerate(zip(pos, els)):
            lines.append(format_pdb_line(len(lines) + 1, f"{el}{j}", "LIG", "A", 201, x, y, z, el, hetero=True))
        x, y, z = center + rng.normal(scale=3.0, size=3)
        lines.append(format_pdb_line(len(lines) + 1, "O", "HOH", "A", 300, x, y, z, "O", hetero=True))
        (data / f"{pid}.bio1").write_text("\n".join(lines) + "\nEND\n")
    (splits / "moad_train.txt").write_text("".join(f"{p}_LIG:A:201\n" for p in ids[:-2]))
    (splits / "moad_val.txt").write_text(f"{ids[-2]}_LIG:A:201\n")
    (splits / "moad_test.txt").write_text(f"{ids[-1]}_LIG:A:201\nmissing_LIG:A:201\n")
    return data, splits


def write_complex_pdb_sdf(d, rng, n_lig=10, center=(5.0, 5.0, 5.0)):
    """A protein PDB around a ligand SDF (with hydrogens to strip) in `d`."""
    center = np.asarray(center)
    pdb, sdf = d / "prot.pdb", d / "lig.sdf"
    pdb.write_text("\n".join(_protein_lines(rng, center, 9)) + "\nEND\n")
    pos, els = _ligand(rng, center, n_lig)
    pos = np.concatenate([pos, pos[:1] + [0.0, 1.0, 0.0]])
    write_sdf([SdfMol("lig", els + ["H"], pos.astype(np.float32), [(i, i + 1, 1) for i in range(n_lig)])], sdf)
    return pdb, sdf


def _read_pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _assert_same(got, want, where):
    assert type(got) is type(want) or (np.isscalar(got) and np.isscalar(want)), (where, type(got), type(want))
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got, want), where
    else:
        assert got == want, where


def _assert_same_outputs(got_dir, want_dir):
    names = sorted(p.name for p in want_dir.iterdir())
    assert sorted(p.name for p in got_dir.iterdir()) == names
    for name in names:
        got, want = _read_pickle(got_dir / name), _read_pickle(want_dir / name)
        _assert_same(got, want, name)
        if isinstance(got, dict):  # split pickles hold numpy, never torch tensors
            assert not any(torch.is_tensor(v) for v in got.values()), name


@pytest.mark.parametrize("ca_only", [False, True], ids=["all_atom", "ca_only"])
def test_process_bindingmoad_matches_jax(tmp_path, ca_only):
    from kpdiff_tpu.cli.process_bindingmoad import main as jmain
    from kpdiff_tpu_torch.cli.process_bindingmoad import main as tmain
    from kpdiff_tpu_torch.data.dataset import ComplexDataset

    data, splits = write_moad_raw(tmp_path)
    argv = ["--data_dir", str(data), "--split_dir", str(splits), "--min_ligand_atoms", "5"]
    argv += ["--ca_only"] if ca_only else []
    jmain(argv + ["--out", str(tmp_path / "jax")])
    tmain(argv + ["--out", str(tmp_path / "port")])
    _assert_same_outputs(tmp_path / "port", tmp_path / "jax")
    names = {p.name for p in (tmp_path / "port").iterdir()}
    assert {"train.pkl", "val.pkl", "test.pkl", "train_n_node_joint_dist.pkl", "train_type_counts.pkl",
            "train_smiles.pkl"} <= names
    ds = ComplexDataset.from_pickle(tmp_path / "port" / "train.pkl")
    assert len(ds) == 4 and ds.rec_feat.shape[1] == (20 if ca_only else 10)
    assert len(ComplexDataset.from_pickle(tmp_path / "port" / "test.pkl")) == 1  # the missing entry is skipped


def test_process_crossdocked_matches_jax(tmp_path):
    from kpdiff_tpu.cli.process_crossdocked import main as jmain
    from kpdiff_tpu_torch.cli.process_crossdocked import main as tmain

    rng = np.random.default_rng(0)
    data = tmp_path / "cd"
    pairs = []
    for i in range(3):
        d = data / f"p{i}"
        d.mkdir(parents=True)
        pdb, sdf = write_complex_pdb_sdf(d, rng, n_lig=9 + i)
        pairs.append((str(pdb.relative_to(data)), str(sdf.relative_to(data))))
    index = {"train": pairs[:2], "test": pairs[2:] + [("p9/prot.pdb", "p9/lig.sdf")]}
    with open(tmp_path / "index.pkl", "wb") as f:
        pickle.dump(index, f)
    argv = ["--data_dir", str(data), "--index_file", str(tmp_path / "index.pkl"), "--min_ligand_atoms", "5"]
    jmain(argv + ["--out", str(tmp_path / "jax")])
    tmain(argv + ["--out", str(tmp_path / "port")])
    _assert_same_outputs(tmp_path / "port", tmp_path / "jax")
    assert len(_read_pickle(tmp_path / "port" / "test.pkl")["lig_files"]) == 1


def test_process_pdbbind_and_dataset_match_jax(tmp_path):
    from kpdiff_tpu.data.pdbbind import PDBbindDataset as JSet, process_pdbbind as jprocess
    from kpdiff_tpu_torch.config import PaddingConfig
    from kpdiff_tpu_torch.data.dataset import PaddedLoader
    from kpdiff_tpu_torch.data.pdbbind import PDBbindDataset, process_pdbbind

    rng = np.random.default_rng(2)
    raw = tmp_path / "raw"
    ids = []
    for i in range(3):
        pid = f"1ab{i}"
        (raw / pid).mkdir(parents=True)
        pdb, sdf = write_complex_pdb_sdf(raw / pid, rng, n_lig=8 + i, center=(20.0, 20.0, 20.0))
        shutil.move(pdb, raw / pid / f"{pid}_protein_nowater.pdb")
        shutil.move(sdf, raw / pid / f"{pid}_ligand.sdf")
        ids.append(pid)
    (raw / "9bad").mkdir()
    (raw / "9bad" / "9bad_protein_nowater.pdb").write_text("garbage\n")
    (tmp_path / "index.txt").write_text("\n".join(ids + ["9bad"]) + "\n")
    elements = ["C", "N", "O", "S"]
    want_ids = jprocess(tmp_path / "index.txt", raw, tmp_path / "jax", elements, elements)
    got_ids = process_pdbbind(tmp_path / "index.txt", raw, tmp_path / "port", elements, elements)
    assert got_ids == want_ids == ids
    ds, jds = PDBbindDataset(tmp_path / "port"), JSet(tmp_path / "jax")
    assert len(ds) == len(jds) == 3 and ds.pdb_ids == jds.pdb_ids
    np.testing.assert_array_equal(ds.lig_feat, jds.lig_feat)
    for i in range(3):
        _assert_same(ds.get(i), jds.get(i), f"item {i}")
        assert Path(ds.get_files(i)[0]).relative_to(tmp_path / "port") == \
            Path(jds.get_files(i)[0]).relative_to(tmp_path / "jax")
    pad = PaddingConfig(n_rec=64, n_lig=16, n_kp=4, n_ip=16)
    batches = list(PaddedLoader(ds, pad, 3, 4, 8).epoch())
    assert len(batches) == 1 and int(batches[0].lig_mask.sum(1).min()) > 0


def test_write_pocket_file_matches_jax(tmp_path):
    from kpdiff_tpu.data.pocketfile import write_pocket_file as jwrite
    from kpdiff_tpu_torch.data.pdb import parse_pdb
    from kpdiff_tpu_torch.data.pocketfile import write_pocket_file
    from kpdiff_tpu_torch.data.sdf import parse_sdf

    pdb, sdf = write_complex_pdb_sdf(tmp_path, np.random.default_rng(4))
    lig = parse_sdf(sdf)[0].coords
    for cutoff in (4.0, 8.0):
        got = write_pocket_file(pdb, lig, tmp_path / f"port_{cutoff}.pdb", cutoff=cutoff)
        jwrite(pdb, lig, tmp_path / f"jax_{cutoff}.pdb", cutoff=cutoff)
        assert (tmp_path / f"port_{cutoff}.pdb").read_text() == (tmp_path / f"jax_{cutoff}.pdb").read_text()
        assert 0 < len(got) == len(parse_pdb(tmp_path / f"port_{cutoff}.pdb"))


def test_gen_commands_match_jax(tmp_path):
    from kpdiff_tpu.cli.gen_commands import main as jmain
    from kpdiff_tpu_torch.cli.gen_commands import main as tmain

    sampled = tmp_path / "sampled"
    for i in range(3):
        (sampled / f"pocket_{i}").mkdir(parents=True)
        (sampled / f"pocket_{i}" / "raw_ligands.sdf").write_text("")
        (sampled / f"pocket_{i}" / "pocket.pdb").write_text("")
    (sampled / "pocket_1" / "minimized.sdf").write_text("")
    cases = (["sample", "--model_dir", "runs/x", "--n_pockets", "3", "--samples_per_pocket", "8"],
             ["docking", "--sampled_mols_dir", str(sampled)],
             ["minimize", "--sampled_mols_dir", str(sampled)])
    for argv in cases:
        jmain(argv + ["--out", str(tmp_path / "jax.txt")])
        tmain(argv + ["--out", str(tmp_path / "port.txt")])
        got, want = (tmp_path / "port.txt").read_text(), (tmp_path / "jax.txt").read_text()
        assert got == want.replace("python -m kpdiff_tpu.cli.", "python -m kpdiff_tpu_torch.cli."), argv[0]
        assert got.strip() and "kpdiff_tpu." not in got


def test_raw_to_metrics_pipeline(tmp_path):
    """raw assemblies -> process_bindingmoad -> train CLI from
    dataset.location -> sample CLI (--ligand_size random, from the
    histogram just written) -> compute_metrics, all through the port on the
    CPU at a tiny config (the fast counterpart of tests/test_cli.py::
    test_raw_to_metrics_full_pipeline)."""
    from tests.test_cli import TINY_CONFIG
    from kpdiff_tpu_torch.cli import compute_metrics, sample, train
    from kpdiff_tpu_torch.cli.process_bindingmoad import main as process
    from kpdiff_tpu_torch.config import dump_yaml

    data, splits = write_moad_raw(tmp_path)
    processed = tmp_path / "processed"
    process(["--data_dir", str(data), "--split_dir", str(splits), "--out", str(processed),
             "--min_ligand_atoms", "5"])
    cfg = copy.deepcopy(TINY_CONFIG)
    cfg["experiment"] = {"name": "e2e", "results_dir": str(tmp_path / "runs")}
    cfg["dataset"]["location"] = str(processed)
    cfg["training"].update(epochs=2, batch_size=2, sample_interval=0)
    (tmp_path / "e2e.yml").write_text(dump_yaml(cfg))
    with pytest.raises(ValueError, match="no batch"):  # pockets of 48-72 atoms: one fits n_rec 48
        train.main(["--config", str(tmp_path / "e2e.yml"), "--device", "cpu", "--seed", "1"])
    cfg["padding"] = dict(cfg["padding"], n_rec=96)
    (tmp_path / "e2e.yml").write_text(dump_yaml(cfg))
    run_dir, state = train.main(["--config", str(tmp_path / "e2e.yml"), "--device", "cpu", "--seed", "1"])
    rows = _read_pickle(Path(run_dir) / "train_metrics.pkl")
    assert state.step == 4 and np.isfinite(rows[-1]["l2"])

    out = tmp_path / "sampled"
    sample.main(["--model_dir", str(run_dir), "--split", "test", "--samples_per_pocket", "4",
                 "--max_batch_size", "4", "--max_tries", "2", "--ligand_size", "random", "--out", str(out),
                 "--device", "cpu"])
    for name in ("raw_ligands.sdf", "pocket.pdb", "keypoints.xyz", "sample_time.txt"):
        assert (out / "pocket_0" / name).exists(), name
    res = compute_metrics.main(["--sampled_mols_dir", str(out)])
    assert "validity" in res["overall"] and (out / "metrics.pkl").exists()


def test_phase_timer_on_cpu(tmp_path):
    """The tracer's host spans (utils/profiling.py) on the CPU and its one
    exporter: span totals always, their kpdiff.* ranges in the Chrome trace
    that device_trace writes."""
    import json

    from kpdiff_tpu_torch.utils import profiling

    before = profiling.snapshot()["spans"].get("test.host", {"n": 0, "ns": 0})
    for _ in range(3):
        with profiling.span("test.host"):
            sum(range(1000))
    after = profiling.snapshot()["spans"]["test.host"]
    assert after["n"] == before["n"] + 3 and after["ns"] > before["ns"]
    with profiling.device_trace(str(tmp_path / "trace"), cuda=False):
        with profiling.span("test.traced"):
            torch.ones(8) @ torch.ones(8)
    traces = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert "kpdiff.test.traced" in names and "kpdiff.test.host" not in names
