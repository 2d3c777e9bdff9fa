"""The parallel layer of kpdiff_tpu_torch (parallel/) on gloo ranks.

- Training: one global batch with injected (t, eps) on 2 data-parallel
  ranks and on a 2 x 2 ('data', 'model') mesh against one process: every
  parameter's gradient within rel 1e-5 of its largest value, and the loss
  and the parameter checksum after one step within rel 1e-5
  (tests/test_multihost.py's bound), for the reduced flagship, for
  gvp_ca (fixed encoder, 'mean' messages), and for the flagship with
  grad_accum 2 on ligands of uneven sizes (each rank's micro-batch i is
  its share of the global micro-batch i). Parameters built from another
  seed on rank 1 are replaced by rank 0's (`replicate_params`).
- The sample CLI on 2 ranks in both shard modes: every sampled row equals
  the one-process row.
- process_local_batch_slice, make_mesh's refusals, `--n_devices 0`, the
  dry run on 2 ranks, and the SA fragment table the port ships.

Ranks are spawned processes (`parallel.distributed.spawn`: a `file://`
rendezvous, 60 s group timeout, a join limit, one thread each). This
module imports only torch and the port at its top: the ranks import it."""
import os
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest

from kpdiff_tpu_torch.config import PaddingConfig, load_config, model_from_config, resolve_feature_sizes
from kpdiff_tpu_torch.data.dataset import PaddedLoader
from kpdiff_tpu_torch.data.molgen import molgen_splits_for_config
from kpdiff_tpu_torch.parallel import distributed as pdist
from kpdiff_tpu_torch.parallel.mesh import make_mesh, params_checksum, replicate_params, shard_batch
from kpdiff_tpu_torch.training.trainer import TrainConfig, init_train_state, loss_and_grads, make_train_step

ROOT = Path(__file__).resolve().parents[1]
SPAWN = dict(device="cpu", threads=1, timeout=timedelta(seconds=60), join_timeout=240)
W_REC = 0.1


def train_config(name):
    cfg = load_config(ROOT / f"configs/{name}.yml")
    cfg["padding"].update(n_rec=48, n_lig=16, n_ip=16)
    cfg["graph"]["n_keypoints"] = 6
    if "dynamics" in cfg:
        cfg["dynamics"].update(n_layers=2, hidden_nf=16, compute_dtype="float32")
        cfg["rec_encoder"].update(n_convs=2, hidden_n_node_feat=16, out_n_node_feat=12, compute_dtype="float32")
    else:
        cfg["dynamics_gvp"].update(n_convs=2, n_hidden_scalars=12, vector_size=4, n_message_gvps=2,
                                   n_update_gvps=1, n_noise_gvps=2, dropout=0.0, compute_dtype="float32")
        cfg["rec_encoder_gvp"].update(vector_size=4)
    return cfg


# case: (config, grad_accum)
TRAIN_CASES = {"flagship": (train_config("egnn_40kp"), 1), "gvp_ca": (train_config("gvp_ca"), 1),
               "flagship_accum2": (train_config("egnn_40kp"), 2)}
MESHES = {"dp2": (("data",), (2,)), "dp2xmp2": (("data", "model"), (2, 2))}


def train_inputs(cfg, seed=0):
    """A molgen batch of 4 through the port's loader and injected (t, eps_x, eps_h)."""
    pad = PaddingConfig.from_config(cfg)
    tm = model_from_config(cfg, device="cpu", seed=1)
    train_ds, _ = molgen_splits_for_config(cfg, pad, resolve_feature_sizes(cfg)[0], 12, seed)
    batch = next(PaddedLoader(train_ds, pad, 4, pad.n_kp, tm.cfg.rec_nf, seed=seed, drop_last=True,
                              kp_vec_dim=tm.kp_vec_dim).epoch())
    rng = np.random.default_rng(seed + 2)
    b, n, f = batch.lig_h.shape
    t_eps = (rng.integers(0, cfg["diffusion"]["n_timesteps"], b), rng.normal(size=(b, n, 3)).astype(np.float32),
             rng.normal(size=(b, n, f)).astype(np.float32))
    return batch, t_eps


def one_step(cfg, accum, batch, t_eps, mesh=None, kp_axis=None, seed=1):
    """(gradients by name, step metrics, checksum after the step) of one train step."""
    model = model_from_config(cfg, device="cpu", seed=seed)
    if mesh is not None:
        replicate_params(model, mesh)
        batch, t_eps = shard_batch(batch, mesh, micro_batches=accum), shard_batch(t_eps, mesh, micro_batches=accum)
    tcfg = TrainConfig(grad_accum=accum)
    state = init_train_state(model, tcfg)
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    loss_and_grads(model, tcfg, batch, W_REC, params, t_eps=t_eps, mesh=mesh, kp_axis=kp_axis)
    grads = {n: p.grad.clone().numpy() for n, p in model.named_parameters()}
    metrics = make_train_step(tcfg, 10, mesh=mesh, kp_axis=kp_axis)(state, batch, t_eps=t_eps)
    return grads, metrics, params_checksum(model)


def _rank_train(rank, out_dir):
    import torch.distributed as dist

    assert pdist.process_local_batch_slice(8) == slice(4 * rank, 4 * rank + 4) or pdist.world_size() != 2
    for mesh_name, (axes, sizes) in MESHES.items():
        if int(np.prod(sizes)) != pdist.world_size():
            continue
        mesh = make_mesh(pdist.world_size(), axes, sizes, device="cpu")
        for case, (cfg, accum) in TRAIN_CASES.items():
            batch, t_eps = train_inputs(cfg)
            grads, metrics, checksum = one_step(cfg, accum, batch, t_eps, mesh,
                                                "model" if "model" in axes else None, seed=1 + 6 * rank)
            sums = [None] * pdist.world_size()
            dist.all_gather_object(sums, checksum)
            assert len(set(sums)) == 1, f"replicas diverged: {sums}"
            if rank == 0:
                np.savez(Path(out_dir) / f"{case}_{mesh_name}.npz", checksum=checksum, l2=metrics["l2"],
                         total=metrics["total"], **{f"grad/{k}": v for k, v in grads.items()})


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_train")
    want = {case: one_step(cfg, accum, *train_inputs(cfg)) for case, (cfg, accum) in TRAIN_CASES.items()}
    for sizes in {int(np.prod(s)) for _, s in MESHES.values()}:
        pdist.spawn(_rank_train, sizes, args=(str(tmp),), **SPAWN)
    got = {(case, m): dict(np.load(tmp / f"{case}_{m}.npz")) for case in TRAIN_CASES for m in MESHES}
    return want, got


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_parallel_train_step_matches_one_process(trained, case, mesh_name):
    want, got = trained
    cfg, accum = TRAIN_CASES[case]
    if accum > 1:  # ligands of uneven sizes: another grouping of rows would give other gradients
        assert len(set(train_inputs(cfg)[0].lig_mask.sum(1).tolist())) > 1
    grads, metrics, checksum = want[case]
    g = got[(case, mesh_name)]
    for name, w in grads.items():
        err = np.abs(g[f"grad/{name}"] - w).max()
        assert err <= 1e-5 * max(np.abs(w).max(), 1e-12), f"{name}: gradient max abs err {err:.3e}"
    for k in ("l2", "total"):
        assert abs(float(g[k]) - metrics[k]) <= 1e-5 * abs(metrics[k]), k
    assert abs(float(g["checksum"]) - checksum) <= 1e-5 * abs(checksum)


# ---- the sample CLI on 2 ranks

@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A port run dir of the tiny serving config (test_torch_port_serve.py's), with a test split."""
    from test_torch_port_serve import make_run_dir, tiny_config

    tmp = tmp_path_factory.mktemp("parallel_run")
    cfg = tiny_config(tmp)
    data = Path(cfg["dataset"]["location"])
    data.mkdir()
    pad = PaddingConfig.from_config(cfg)
    _, test_ds = molgen_splits_for_config(cfg, pad, resolve_feature_sizes(cfg)[0], 16, seed=0)
    test_ds.subset([0]).to_pickle(data / "test.pkl")
    return make_run_dir(tmp, cfg)


SAMPLE_ARGV = ["--dataset_size", "1", "--samples_per_pocket", "4", "--max_batch_size", "4", "--sample_steps", "3",
               "--max_tries", "1", "--device", "cpu"]
RAW = ("lig_x", "lig_h", "lig_mask")


def _record_samples(monkeypatch=None):
    """Keep every KeypointDiffusion.sample call's (lig_x, lig_h, lig_mask), as
    numpy, in the returned list: the rows this rank sampled."""
    from kpdiff_tpu_torch.models.diffusion import KeypointDiffusion

    rows, sample = [], KeypointDiffusion.sample

    def recording(self, *a, **kw):
        out = sample(self, *a, **kw)
        rows.append({k: out[k].cpu().numpy() for k in RAW})
        return out

    (monkeypatch.setattr if monkeypatch else setattr)(KeypointDiffusion, "sample", recording)
    return rows


def _rank_sample_cli(rank, argv, out_dir):
    """One rank of the sample CLI; its sampled rows go to rank_<rank>.npz."""
    from kpdiff_tpu_torch.cli import sample

    rows = _record_samples()
    sample._sample(sample.parse_args(argv))
    np.savez(Path(out_dir) / f"rank_{rank}.npz", **{k: np.stack([r[k] for r in rows]) for k in RAW})


@pytest.mark.parametrize("mode", ["data", "kp"])
def test_sample_cli_two_ranks_rows_match_one(run_dir, tmp_path, monkeypatch, mode):
    """The sample CLI's ranks (data: each its half of the batch; kp: each the
    whole batch) against the one-process CLI: every row of every try."""
    from kpdiff_tpu_torch.cli import sample

    rows = _record_samples(monkeypatch)
    sample._sample(sample.parse_args(["--model_dir", str(run_dir), "--out", str(tmp_path / "one"), *SAMPLE_ARGV]))
    want = {k: np.stack([r[k] for r in rows]) for k in RAW}
    argv = ["--model_dir", str(run_dir), "--out", str(tmp_path / "two"), *SAMPLE_ARGV,
            "--n_devices", "2", "--shard_mode", mode]
    pdist.spawn(_rank_sample_cli, 2, args=(argv, str(tmp_path)), **SPAWN)
    ranks = [dict(np.load(tmp_path / f"rank_{r}.npz")) for r in (0, 1)]
    if mode == "data":
        got = {k: np.concatenate([ranks[0][k], ranks[1][k]], axis=1) for k in RAW}
    else:
        got = ranks[0]
        for k in RAW:
            np.testing.assert_array_equal(ranks[1][k], got[k])
    assert got["lig_x"].shape == want["lig_x"].shape and want["lig_x"].shape[:2] == (1, 4)
    np.testing.assert_array_equal(got["lig_mask"], want["lig_mask"])
    for k in ("lig_x", "lig_h"):
        for b in range(4):
            err = np.abs(got[k][0, b] - want[k][0, b]).max()
            assert err <= 2e-4 * np.abs(want[k]).max() + 1e-5, f"{mode} row {b} {k}: {err:.3e}"
    assert (tmp_path / "two" / "pocket_0" / "raw_ligands.sdf").exists()


# ---- meshes, batch slices, device counts, the dry run

def test_process_local_batch_slice_and_mesh_refusals():
    assert not pdist.in_group() and pdist.process_local_batch_slice(8) == slice(0, 8)
    mesh = make_mesh(1, device="cpu")
    assert (mesh.shape, mesh.coords, mesh.groups, mesh.world) == ((1,), (0,), (None,), None)
    with pytest.raises(ValueError, match="only .* device"):
        make_mesh(pdist.visible_devices("cpu") + 1, device="cpu")
    with pytest.raises(ValueError, match="process group has 1 rank"):
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="do not multiply"):
        make_mesh(1, ("data", "model"), (2, 2), device="cpu")


def test_n_devices_zero_is_every_visible_device():
    assert pdist.resolve_n_devices(0, "cpu") == os.cpu_count()
    assert pdist.resolve_n_devices(3, "cpu") == 3
    with pytest.raises(ValueError, match="visible"):
        pdist.resolve_n_devices(os.cpu_count() + 1, "cpu")


def test_dryrun_multichip_two_ranks(capfd, monkeypatch):
    from kpdiff_tpu_torch.dryrun import dryrun_multichip

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    dryrun_multichip(2, device="cpu")
    out = capfd.readouterr().out
    assert "dryrun_multichip(2) ok: l2=" in out and "dp1xmp2: train_l2=" in out


def test_sa_fragment_table_matches_the_jax_package():
    """The port ships kpdiff_tpu's fpscores.pkl.gz: the two tables are equal."""
    from kpdiff_tpu.analysis.sa_score import load_fragment_scores as jload_scores
    from kpdiff_tpu_torch.analysis.sa_score import load_fragment_scores

    got, want = load_fragment_scores(), jload_scores()
    assert got is not None and len(got) == len(want) == 705292
    assert got == want
