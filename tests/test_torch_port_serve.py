"""The port's serving front ends on the CPU against kpdiff_tpu: the complex
the sampler builds for a request (field by field against the JAX
cli/sample.py::_to_complex), its ligand-size draws (exactly equal), the
served samples with the same injected noise (f32, 1e-4 of the largest
value) and their bonds; the sample, byop (PDB and mmCIF), compute_metrics
and pocket_minimization CLIs; the HTTP server's endpoints over a socket on
127.0.0.1; the in-training analyzer and `export_params --best`.

The run directory is the port's own: the tiny config of test_cli.py written
with the port's YAML writer and checkpoints/step_0.pt of a seeded model;
its dataset.location holds a size histogram built from molgen's training
sizes and a two-pocket test split."""
import copy
import dataclasses
import json
import pickle
import threading
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kpdiff_tpu.analysis import molecule_builder as jmb
from kpdiff_tpu.cli import compute_metrics as jcm, pocket_minimization as jpm
from kpdiff_tpu.cli.sample import _to_complex as j_to_complex
from kpdiff_tpu.config import model_from_config as jmodel
from kpdiff_tpu.data.dataset import pad_item as jpad_item
from kpdiff_tpu.data.pdb import write_pdb as jwrite_pdb
from kpdiff_tpu.cli.byop import process_ligand_and_pocket as jprocess
from kpdiff_tpu.models.size_dist import LigandSizeDistribution as JSizes
from kpdiff_tpu_torch.analysis.analyzer import ModelAnalyzer
from kpdiff_tpu_torch.analysis.molecule_builder import BuiltMolecule
from kpdiff_tpu_torch.cli import byop as tbyop, compute_metrics as tcm, export_params as texport, import_params
from kpdiff_tpu_torch.cli import pocket_minimization as tpm, sample as tsample, serve_http, train as ttrain
from kpdiff_tpu_torch.config import (PaddingConfig, dump_yaml, load_config, model_from_config as tmodel,
                                     resolve_feature_sizes)
from kpdiff_tpu_torch.data.mmcif import write_mmcif
from kpdiff_tpu_torch.data.molgen import molgen_splits_for_config, type_counts
from kpdiff_tpu_torch.data.pdb import parse_pdb
from kpdiff_tpu_torch.data.sdf import parse_sdf
from kpdiff_tpu_torch.models import egnn as tegnn
from kpdiff_tpu_torch.models.complex import synthetic_complex_np
from kpdiff_tpu_torch.models.size_dist import save_dataset_histogram
from kpdiff_tpu_torch.serve import KeypointSampler
from kpdiff_tpu_torch.training.trainer import MetricsLog, checkpoint_steps
from kpdiff_tpu_torch.utils.params_io import export_flat, save_keystr_npz
from test_cli import TINY_CONFIG, _write_synthetic_complex_pdb_sdf
from torch_port_util import assert_rel_max, jax_complex, jax_tree

ROOT = Path(__file__).resolve().parents[1]
COMPLEX_FIELDS = ("rec_x", "rec_h", "rec_mask", "rec_res_idx", "lig_x", "lig_h", "lig_mask", "ip_x", "ip_mask",
                  "kp_x", "kp_h", "kp_mask")


def tiny_config(tmp: Path) -> dict:
    cfg = copy.deepcopy(TINY_CONFIG)
    cfg["experiment"] = {"name": "tiny", "results_dir": str(tmp / "runs")}
    cfg["dataset"]["location"] = str(tmp / "data")
    cfg["dynamics"].update(n_layers=2, update_kp_feat=True)  # kk edges run, as in the flagship
    return cfg


def make_run_dir(tmp: Path, cfg: dict, seed: int = 5) -> Path:
    """A run dir through cli/import_params.py: config.yml (the port's
    writer) and checkpoints/step_0.pt of a seeded model's keystr npz."""
    (tmp / "cfg.yml").write_text(dump_yaml(cfg))
    save_keystr_npz(export_flat(tmodel(cfg, device="cpu", seed=seed)), tmp / "seeded.npz")
    return import_params.main([str(tmp / "cfg.yml"), str(tmp / "seeded.npz"), str(tmp / "run")])


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("port_run")
    cfg = tiny_config(tmp)
    data = Path(cfg["dataset"]["location"])
    data.mkdir()
    pad = PaddingConfig.from_config(cfg)
    train_ds, test_ds = molgen_splits_for_config(cfg, pad, resolve_feature_sizes(cfg)[0], 32, seed=0)
    save_dataset_histogram(train_ds, data)
    test_ds.subset([0, 1]).to_pickle(data / "test.pkl")
    return cfg, make_run_dir(tmp, cfg), train_ds, test_ds


def _pocket(seed=0, n_rec=40):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n_rec, 3)).astype(np.float32) * 3,
            np.eye(10, dtype=np.float32)[rng.integers(0, 10, n_rec)],
            np.repeat(np.arange(n_rec // 4), 4).astype(np.int32),
            rng.normal(size=(5, 3)).astype(np.float32))


def _spy_runs(sampler, monkeypatch):
    """Record (complex, init_com, outputs) of every chunk the sampler runs."""
    runs, real = [], sampler._run

    def spy(cpx, init_com):
        out, *rest = real(cpx, init_com)
        runs.append((cpx, init_com, out))
        return (out, *rest)

    monkeypatch.setattr(sampler, "_run", spy)
    return runs


def test_run_dir_sampler_loads_the_checkpoint(port_run, monkeypatch):
    """Both checkpoint selections load the seeded weights; with
    kp_shard_devices=2 the sampler starts its worker rank (gloo) and a
    request's samples equal the one-rank sampler's on the same seed."""
    cfg, run, _, _ = port_run
    want = export_flat(tmodel(cfg, device="cpu", seed=5))
    for step in (None, 0):
        sampler = KeypointSampler(run, checkpoint_step=step, batch_size=4, device="cpu", seed=99)
        got = export_flat(sampler.model)
        assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in want)
        assert sampler.lig_buckets == [8, 16] and not sampler.model.training and sampler.model_dir == run
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rec_pos, rec_feat, res, ips = _pocket(2)
    outs = []
    for n in (0, 2):
        sampler = KeypointSampler(run, batch_size=4, device="cpu", seed=3, sample_steps=2, kp_shard_devices=n)
        try:
            assert sampler.rank == 0 and export_flat(sampler.model).keys() == want.keys()
            runs = _spy_runs(sampler, monkeypatch)
            sampler.sample_for_arrays(rec_pos, rec_feat, res, ips, n_mols=3, ligand_size=7)
            outs.append(runs[0][2])
        finally:
            sampler.close()
    assert not torch.distributed.is_initialized()  # the sampler released the group it made
    scale = float(outs[0]["lig_x"].abs().max())
    assert float((outs[1]["lig_x"] - outs[0]["lig_x"]).abs().max()) <= 2e-4 * scale + 1e-3


def test_positional_jax_style_call(port_run, monkeypatch):
    """(rec_pos, rec_feat, rec_res_idx, interface_points, init_com,
    ref_n_atoms, n_mols, ligand_size) positionally, as the JAX sampler takes
    them: the interface points land in the complex's ip_x and init_com in
    the sampler's init_com; 'ref' takes ref_n_atoms. The chunk of 3 is
    repeat-padded to batch_size 4, as the JAX sampler pads it."""
    _, run, _, _ = port_run
    sampler = KeypointSampler(run, batch_size=4, device="cpu", seed=1, sample_steps=2)
    runs = _spy_runs(sampler, monkeypatch)
    rec_pos, rec_feat, res, ips = _pocket(1)
    com = np.array([1.5, -2.0, 0.25], np.float32)
    mols = sampler.sample_for_arrays(rec_pos, rec_feat, res, ips, com, 7, 3, "ref")
    assert len(runs) == 1
    cpx, init_com, _ = runs[0]
    np.testing.assert_array_equal(cpx.ip_x[:, :5].numpy(), np.broadcast_to(ips, (4, 5, 3)))
    assert cpx.ip_mask.sum(1).tolist() == [5, 5, 5, 5]
    np.testing.assert_array_equal(init_com.numpy(), np.broadcast_to(com, (4, 3)))
    assert cpx.lig_mask.sum(1).tolist() == [7, 7, 7, 7] and cpx.lig_x.shape[1] == 8
    assert sampler.last_request["chunks"] == [dict(batch=3, bucket=8, kk="dense", sizes=[7, 7, 7])]
    assert all(isinstance(m, BuiltMolecule) for m in mols)
    with pytest.raises(ValueError, match="ref_n_atoms"):
        sampler.sample_for_arrays(rec_pos, rec_feat, ligand_size="ref")


def test_request_complex_and_sizes_match_jax(port_run, monkeypatch):
    """ligand_size='random': the sizes are the JAX sampler's draws for the
    same seed, sorted in descending order; each chunk's complex equals the
    JAX _to_complex of the JAX pad_item items at the same bucket, repeat
    padded to batch_size as the JAX sampler pads them."""
    cfg, run, _, _ = port_run
    sampler = KeypointSampler(run, batch_size=4, device="cpu", seed=7, sample_steps=2)
    runs = _spy_runs(sampler, monkeypatch)
    rec_pos, rec_feat, res, ips = _pocket(2, n_rec=44)
    sampler.sample_for_arrays(rec_pos, rec_feat, res, ips, n_mols=10, ligand_size="random")
    want = JSizes(cfg["dataset"]["location"]).sample(np.array([44]), 10, np.random.default_rng(7))[0]
    want = np.sort(np.clip(want, 2, 16))[::-1]
    chunks = sampler.last_request["chunks"]
    assert [s for c in chunks for s in c["sizes"]] == want.tolist()
    assert [c["batch"] for c in chunks] == [4, 4, 2] and len(runs) == 3

    pad = PaddingConfig.from_config(cfg)
    jm = jmodel(cfg)
    for (cpx, init_com, _), c in zip(runs, chunks):
        assert init_com is None
        pad_b = dataclasses.replace(pad, n_lig=c["bucket"])
        items = [jpad_item(dict(lig_pos=np.zeros((n, 3), np.float32), lig_feat=np.zeros((n, 10), np.float32),
                                rec_pos=rec_pos, rec_feat=rec_feat, rec_res_idx=res, interface_points=ips),
                           pad_b, n_lig_feat_out=10) for n in c["sizes"]]
        items += [items[-1]] * (4 - len(items))  # the JAX sampler's repeat-padding to batch_size
        jcpx = j_to_complex(items, pad_b, jm, None)
        for f in COMPLEX_FIELDS:
            got, exp = getattr(cpx, f).numpy(), np.asarray(getattr(jcpx, f))
            assert got.shape == exp.shape and got.dtype == exp.dtype, f
            np.testing.assert_array_equal(got, exp, err_msg=f)


def test_injected_noise_samples_and_bonds_match_jax(port_run, tmp_path, monkeypatch):
    """The trained flagship (full width and depth, f32) served by the port's
    sampler with injected noise, against the JAX model's encode ->
    compact_kk -> sample on the complex the sampler built, with the same
    noise: outputs within 1e-4 of their largest value, the same molecules
    built from them, with the same bonds. Mixed sizes from the run's
    histogram share one chunk."""
    cfg = load_config(ROOT / "configs/egnn_40kp.yml")
    cfg["dynamics"]["compute_dtype"] = cfg["rec_encoder"]["compute_dtype"] = "float32"
    cfg["dataset"]["location"] = port_run[0]["dataset"]["location"]
    (tmp_path / "flagship.yml").write_text(dump_yaml(cfg))
    K = 10
    sampler = KeypointSampler.from_params(tmp_path / "flagship.yml", ROOT / "artifacts/egnn_40kp_trained_params.npz",
                                          batch_size=3, device="cpu", seed=3, sample_steps=K)
    runs = _spy_runs(sampler, monkeypatch)
    noises, real_sample = [], sampler.model.sample

    def noisy(enc, kk, **kw):
        b, n, f = enc.lig_h.shape
        rng = np.random.default_rng(100 + len(noises))
        shapes = dict(init_x=(b, n, 3), init_h=(b, n, f), steps_x=(K, b, n, 3), steps_h=(K, b, n, f))
        noise = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        noises.append(noise)
        return real_sample(enc, kk, noise=noise, **kw)

    monkeypatch.setattr(sampler.model, "sample", noisy)
    pocket = synthetic_complex_np(np.random.default_rng(4), 260, 16, 260, 16, 10, 10)
    com = pocket["lig_x"].mean(0)
    mols = sampler.sample_for_arrays(pocket["rec_x"], pocket["rec_h"], pocket["rec_res_idx"], None, com, None, 3,
                                     "random")

    jm, params = jmodel(cfg), jax_tree(export_flat(sampler.model))
    elements = cfg["dataset"]["lig_elements"]
    want_mols = []
    for (cpx, init_com, out), noise in zip(runs, noises):
        jenc, jkk = jm.encode(params, jax_complex(cpx, cpx.kp_x.shape[1], cpx.kp_h.shape[2]))
        jkk = jm.compact_kk(jenc, jkk)
        jout = jm.sample(params, jax.random.key(0), jenc, jkk, init_com=jnp.asarray(init_com.numpy()),
                         sample_steps=K, noise={k: jnp.asarray(v) for k, v in noise.items()})
        for k in ("lig_x", "lig_h"):
            assert_rel_max(out[k], np.asarray(jout[k]), 1e-4, msg=k)
        np.testing.assert_array_equal(out["lig_mask"].numpy(), np.asarray(jout["lig_mask"]))
        lx, lh, lm = (np.asarray(jout[k]) for k in ("lig_x", "lig_h", "lig_mask"))
        for b in range(lx.shape[0]):
            els = [elements[j] for j in lh[b][lm[b]][:, :10].argmax(1)]
            want_mols.append(jmb.build_molecule(lx[b][lm[b]], els))
    want_mols = [m for m in want_mols if m is not None]
    assert len(runs) == 1 and len(set(sampler.last_request["chunks"][0]["sizes"])) > 1
    assert len(mols) == len(want_mols) and sum(len(m.bonds) for m in mols) > 0
    for g, w in zip(mols, want_mols):
        assert g.elements == w.elements and g.bonds == w.bonds and g.largest_frag_frac == w.largest_frag_frac
        np.testing.assert_allclose(g.coords, w.coords, rtol=0, atol=1e-4 * max(1.0, float(np.abs(w.coords).max())))


def test_sample_for_pocket_and_kernel_entry_under_grad(port_run, tmp_path, monkeypatch):
    """sample_for_pocket on a PDB and its mmCIF rendering: the same pocket,
    molecules that build, per-part timings; every dense edge of every step
    calls the kernel entry even from a grad-enabled caller."""
    _, run, _, _ = port_run
    pdb, sdf = _write_synthetic_complex_pdb_sdf(tmp_path)
    write_mmcif(parse_pdb(pdb), tmp_path / "prot.cif")
    calls = []
    real = tegnn.egnn_edge_dense
    monkeypatch.setattr(tegnn, "egnn_edge_dense", lambda *a, **kw: calls.append(a[0].shape[1]) or real(*a, **kw))
    for receptor in (pdb, tmp_path / "prot.cif"):
        sampler = KeypointSampler(run, batch_size=4, device="cpu", seed=0, sample_steps=3)
        calls.clear()
        with torch.enable_grad():
            mols = sampler.sample_for_pocket(receptor, sdf, n_mols=4, ligand_size="ref")
        req = sampler.last_request
        assert 0 < req["pocket_atoms"] <= 48 and req["chunks"][0]["sizes"] == [9] * 4
        assert req["chunks"][0]["kk"] == "dense" and calls.count(16) == 2 * 3 and len(calls) == 2 * 2 * 3
        assert {"parse_pocket_s", "front_end_s", "sample_s", "copy_s", "build_s"} <= set(req)
        assert all(np.isfinite(m.coords).all() and m.n_atoms <= 9 for m in mols)


def _sample_cli(run, out, *extra):
    tsample.main(["--model_dir", str(run), "--out", str(out), "--dataset_size", "2", "--samples_per_pocket", "4",
                  "--max_batch_size", "4", "--max_tries", "2", "--sample_steps", "4", "--device", "cpu", *extra])


def test_sample_cli_layout_and_offline_metrics(port_run, tmp_path):
    """--ligand_size random with --visualize and both minimizations: the
    reference layout per pocket, SDFs the port reads back, sample_time.pkl
    with the JAX keys; compute_metrics and pocket_minimization equal the JAX
    CLIs' on the same directory."""
    _, run, _, _ = port_run
    out = tmp_path / "sampled"
    _sample_cli(run, out, "--ligand_size", "random", "--use_ref_lig_com", "--visualize", "--frames_every", "1",
                "--pocket_minimization", "--ligand_only_minimization")
    for i in range(2):
        pdir = out / f"pocket_{i}"
        for f in ("raw_ligands.sdf", "pocket.pdb", "keypoints.xyz", "sample_time.txt", "sample_time.pkl",
                  "pocket_minimized_ligands.sdf", "pocket_min_rmsds.csv", "minimized_ligands.sdf"):
            assert (pdir / f).exists(), f
        with open(pdir / "sample_time.pkl", "rb") as f:
            st = pickle.load(f)
        assert set(st) == {"time", "n_valid", "n_tries", "batch"} and st["batch"] == 4
        mols = parse_sdf(pdir / "raw_ligands.sdf")
        assert len(mols) == st["n_valid"] <= 4 and 1 <= st["n_tries"] <= 2
        assert len(parse_pdb(pdir / "pocket.pdb")) > 0
        for traj in sorted((pdir / "trajectories").glob("*.sdf")) if mols else []:
            assert len(parse_sdf(traj)) == 4  # frames at steps 0..3
    got = tcm.main(["--sampled_mols_dir", str(out), "--out", str(tmp_path / "t.pkl")])
    want = jcm.main(["--sampled_mols_dir", str(out), "--out", str(tmp_path / "j.pkl")])
    assert got.keys() == want.keys() and got["per_pocket"].keys() == want["per_pocket"].keys()
    assert json.dumps(got, sort_keys=True, default=str) == json.dumps(want, sort_keys=True, default=str)
    if parse_sdf(out / "pocket_0" / "raw_ligands.sdf"):
        tpm.main(["--pocket_dir", str(out / "pocket_0"), "--n_iters", "5"])
        t_min = (out / "pocket_0" / "minimized.sdf").read_bytes()
        jpm.main(["--pocket_dir", str(out / "pocket_0"), "--n_iters", "5"])
        assert (out / "pocket_0" / "minimized.sdf").read_bytes() == t_min


def test_clis_refuse_what_is_not_ported(port_run, tmp_path, monkeypatch):
    """The CLIs' multi-device flags on 2 gloo ranks: the sample CLI split over
    the keypoints (its molecules equal the one-rank run's), byop and serve_http
    with --kp_shard_devices 2 (the sampler's worker rank samples in lockstep)."""
    _, run, _, _ = port_run
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    for out, extra in (("one", []), ("two", ["--n_devices", "2", "--shard_mode", "kp"])):
        _sample_cli(run, tmp_path / out, "--max_tries", "1", *extra)
    for i in (0, 1):
        a, b = (parse_sdf(tmp_path / d / f"pocket_{i}" / "raw_ligands.sdf") for d in ("one", "two"))
        assert [m.elements for m in a] == [m.elements for m in b]
        for ma, mb in zip(a, b):
            assert np.abs(ma.coords - mb.coords).max() <= 2e-4 * np.abs(ma.coords).max() + 1e-3
    pdb, sdf = _write_synthetic_complex_pdb_sdf(tmp_path)
    mols = tbyop.main(["--model_dir", str(run), "--receptor_file", str(pdb), "--ligand_file", str(sdf),
                       "--out", str(tmp_path / "byop"), "--n_mols", "3", "--ligand_size", "ref", "--sample_steps",
                       "2", "--kp_shard_devices", "2", "--device", "cpu"])
    assert [m.elements for m in parse_sdf(tmp_path / "byop" / "raw_ligands.sdf")] == [m.elements for m in mols]

    servers, make = [], serve_http.make_server
    monkeypatch.setattr(serve_http, "make_server", lambda *a, **kw: servers.append(make(*a, **kw)) or servers[-1])
    thread = threading.Thread(target=serve_http.main, daemon=True, args=(
        ["--model_dir", str(run), "--port", "0", "--batch_size", "4", "--sample_steps", "2",
         "--kp_shard_devices", "2", "--device", "cpu"],))
    thread.start()
    for _ in range(600):
        if servers or not thread.is_alive():
            break
        thread.join(0.2)
    assert servers, "serve_http did not start"
    try:
        rec_pos, rec_feat, _, _ = _pocket(4, n_rec=30)
        status, out = _post(f"http://127.0.0.1:{servers[0].server_address[1]}", "/sample",
                            {"rec_pos": rec_pos.tolist(), "rec_feat": rec_feat.tolist(), "n_mols": 3,
                             "ligand_size": 6})
        assert status == 200 and out["n"] == len(out["molecules"]) <= 3
    finally:
        servers[0].shutdown()
        thread.join(120)
    assert not thread.is_alive() and not torch.distributed.is_initialized()


@pytest.mark.parametrize("fmt", ["pdb", "mmcif"])
def test_byop_cli(port_run, tmp_path, fmt):
    """byop on a PDB receptor and on its mmCIF rendering: pocket.pdb
    byte-identical to the JAX package's for the same files, the SDF read
    back, keypoints.xyz, the minimization outputs."""
    cfg, run, _, _ = port_run
    pdb, sdf = _write_synthetic_complex_pdb_sdf(tmp_path)
    receptor = pdb
    if fmt == "mmcif":
        receptor = tmp_path / "prot.cif"
        write_mmcif(parse_pdb(pdb), receptor)
    out = tmp_path / "byop"
    mols = tbyop.main(["--model_dir", str(run), "--receptor_file", str(receptor), "--ligand_file", str(sdf),
                       "--out", str(out), "--n_mols", "5", "--max_batch_size", "4", "--ligand_size", "ref",
                       "--sample_steps", "3", "--pocket_minimization", "--device", "cpu"])
    assert [m.elements for m in parse_sdf(out / "raw_ligands.sdf")] == [m.elements for m in mols]
    jwrite_pdb(jprocess(str(receptor), str(sdf), cfg)["rec_atoms"], tmp_path / "j_pocket.pdb")
    assert (out / "pocket.pdb").read_bytes() == (tmp_path / "j_pocket.pdb").read_bytes()
    assert len((out / "keypoints.xyz").read_text().splitlines()) == 2 + cfg["graph"]["n_keypoints"]
    assert (out / "pocket_minimized_ligands.sdf").exists() and (out / "pocket_min_rmsds.csv").exists()


def test_byop_refuses_a_pocket_beyond_capacity(port_run, tmp_path):
    cfg, _, _, _ = port_run
    small = copy.deepcopy(cfg)
    small["padding"]["n_rec"] = 20
    (tmp_path / "small").mkdir()
    run = make_run_dir(tmp_path / "small", small)
    pdb, sdf = _write_synthetic_complex_pdb_sdf(tmp_path)
    with pytest.raises(SystemExit, match="padding capacity"):
        tbyop.main(["--model_dir", str(run), "--receptor_file", str(pdb), "--ligand_file", str(sdf),
                    "--out", str(tmp_path / "o"), "--ligand_size", "ref", "--device", "cpu"])


def _post(base, path, obj):
    req = urllib.request.Request(base + path, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def test_serve_http_endpoints(port_run, tmp_path):
    _, run, _, _ = port_run
    sampler = KeypointSampler(run, batch_size=4, device="cpu", seed=0, sample_steps=3)
    server = serve_http.make_server(sampler, port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            health = json.loads(r.read())
        assert health == {"status": "ok", "model_dir": str(run), "lig_buckets": [8, 16], "batch_size": 4}
        rec_pos, rec_feat, _, _ = _pocket(4, n_rec=30)
        status, out = _post(base, "/sample", {"rec_pos": rec_pos.tolist(), "rec_feat": rec_feat.tolist(),
                                              "n_mols": 3, "ligand_size": "random"})
        assert status == 200 and out["n"] == len(out["molecules"]) and out["sdf"].count("$$$$") == out["n"]
        pdb, sdf = _write_synthetic_complex_pdb_sdf(tmp_path)
        status, out = _post(base, "/sample_files", {"receptor_pdb": pdb.read_text(),
                                                    "ref_ligand_sdf": sdf.read_text(), "n_mols": 4,
                                                    "ligand_size": "ref"})
        assert status == 200 and out["n"] == len(out["molecules"])
        assert sampler.last_request["chunks"][0]["sizes"] == [9] * 4
        for m in out["molecules"]:
            assert len(m["coords"]) == len(m["elements"]) and np.isfinite(np.asarray(m["coords"])).all()
        for path, body, code in (("/sample", {"rec_pos": [[0, 0]], "rec_feat": [[1]]}, 400),
                                 ("/sample", {"rec_feat": [[1]]}, 400),
                                 ("/sample", {"rec_pos": [[0, 0, 0]], "rec_feat": [[1] * 10], "ligand_size": "ref"},
                                  400),
                                 ("/sample_files", {"receptor_pdb": ""}, 400), ("/nope", {}, 404)):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(base, path, body)
            assert e.value.code == code, path
    finally:
        server.shutdown()
        server.server_close()


def test_analyzer_keeps_the_mode_and_takes_the_kernel_entry(port_run, monkeypatch):
    """sample_and_analyze from a grad-enabled training loop: every dense
    edge calls the kernel entry (no_grad), fixed-shape chunks, the model's
    mode restored, and the JAX analyzer's metric keys."""
    cfg, run, train_ds, test_ds = port_run
    model = tmodel(cfg, device="cpu", seed=2)
    model.train()
    pad = PaddingConfig.from_config(cfg)
    calls = []
    real = tegnn.egnn_edge_dense
    monkeypatch.setattr(tegnn, "egnn_edge_dense", lambda *a, **kw: calls.append(a[0].shape[0]) or real(*a, **kw))
    an = ModelAnalyzer(model, test_ds, pad, cfg["dataset"]["lig_elements"], n_receptors=2, n_replicates=3,
                       train_type_counts=type_counts(train_ds), seed=1, diff_batch_size=4)
    with torch.enable_grad():
        m = an.sample_and_analyze(torch.Generator().manual_seed(0))
    assert model.training
    T, n_layers = cfg["diffusion"]["n_timesteps"], cfg["dynamics"]["n_layers"]
    assert len(calls) == 2 * n_layers * T * 2 and set(calls) == {4}  # 6 molecules in two launches of 4
    assert m["n_sampled"] == 6 and {"validity", "connectivity", "atom_type_kl", "sample_time", "sec_per_mol",
                                    "uniqueness", "atom_validity", "avg_frag_frac"} <= set(m)


def test_train_cli_analyzer_rows_and_export_best(port_run, tmp_path):
    """The config's own sample_interval: the analyzer fires at epoch ~0
    (mol_* rows in test_metrics.pkl) and export_params --best picks a
    checkpoint from them."""
    cfg, _, _, _ = port_run
    cfg = copy.deepcopy(cfg)
    cfg["experiment"]["results_dir"] = str(tmp_path / "runs")
    cfg["training"].update(sample_interval=0.5, save_interval=0.5)
    (tmp_path / "cfg.yml").write_text(dump_yaml(cfg))
    run_dir, state = ttrain.main(["--config", str(tmp_path / "cfg.yml"), "--synthetic_mol", "16", "--epochs", "1",
                                  "--device", "cpu", "--seed", "3"])
    rows = MetricsLog(run_dir / "test_metrics.pkl").rows
    mol = [r for r in rows if "mol_connectivity" in r]
    assert [r["mol_epoch"] for r in mol] == [0.0, 0.5]
    assert mol[0]["mol_n_sampled"] == 4 and mol[0]["mol_props_backend"] in ("first_party", "rdkit", None)
    steps = checkpoint_steps(run_dir / "checkpoints")
    assert len(steps) == 2 and texport.best_step(run_dir) in steps
    texport.main([str(run_dir), str(tmp_path / "best.npz"), "--best"])
    assert (tmp_path / "best.npz").exists()
