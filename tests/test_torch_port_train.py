"""The port's trainer and training CLI on the CPU.

Against kpdiff_tpu: the schedules over a grid of epochs, and a 4-step
trajectory of the port's train step against
`kpdiff_tpu.training.trainer.make_train_step(..., with_t_eps=True)` from the
same weights, batches and injected (t, eps) on a reduced egnn_40kp config
(the slice's acceptance test): per-step losses and the final change of every
parameter leaf, f32 rtol 1e-4 / atol 1e-5. The exported npz of a CLI run
loads into the JAX package and gives the same loss there (same tolerance).

The port alone: grad_accum against the mean of the micro-batch gradients,
the skip of a non-finite step, a checkpoint round trip, remat, the train
CLI's run directory and its refusals, the YAML writer, and sampling on the
kernel's entry once encode is differentiable.
"""
import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import kpdiff_tpu_torch.models.egnn as tegnn
from kpdiff_tpu.training import scheduler as jsched, trainer as jtrainer
from kpdiff_tpu.utils.params_io import load_params_npz
from kpdiff_tpu_torch import config as tcfg
from kpdiff_tpu_torch.cli import export_params as texport, train as tcli
from kpdiff_tpu_torch.config import PaddingConfig, model_from_config as tmodel
from kpdiff_tpu_torch.data.dataset import PaddedLoader
from kpdiff_tpu_torch.data.molgen import molgen_splits_for_config
from kpdiff_tpu_torch.serve import KeypointSampler
from kpdiff_tpu_torch.training import scheduler as tsched, trainer as ttrainer
from kpdiff_tpu_torch.utils.params_io import export_flat, load_params, read_keystr_npz
from torch_port_util import (ROOT, assert_close, jax_complex, jax_flat, jax_t_eps, jax_tree, jmodel,
                             reduced_config, same)

F32 = dict(rtol=1e-4, atol=1e-5)
LR, WD, CLIP, W_REC = 1e-4, 1e-12, 1.5, 0.1


# ---------------------------------------------------------------- schedules

SCHEDULES = {
    "flagship_warmup": dict(warmup_length=1.0),
    "cosine_restarts": dict(warmup_length=0.5, restart_interval=2.0, restart_type="cosine"),
    "linear_restarts": dict(restart_interval=1.5, restart_type="linear"),
    "sigmoid_weight": dict(warmup_length=0.25, rec_enc_weight_decay_midpoint=3.0, rec_enc_weight_decay_scale=0.25),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_jax(name):
    kw = dict(base_lr=LR, rec_enc_loss_weight=W_REC, **SCHEDULES[name])
    tc, jc = tsched.SchedulerConfig(**kw), jsched.SchedulerConfig(**kw)
    epochs = np.concatenate([np.linspace(0.0, 10.0, 161), [0.25, 0.5, 1.0, 1.5, 2.5, 3.0, 4.5]])
    for e in epochs:
        e = float(np.float32(e))
        np.testing.assert_allclose(tsched.learning_rate(tc, e), float(jsched.learning_rate(jc, e)), rtol=1e-6,
                                   err_msg=f"lr at epoch {e}")
        np.testing.assert_allclose(tsched.rec_encoder_weight(tc, e), float(jsched.rec_encoder_weight(jc, e)),
                                   rtol=1e-6, err_msg=f"rec weight at epoch {e}")
    for prev, cur in zip(epochs[:-1], epochs[1:]):
        assert tsched.is_restart_boundary(tc, prev, cur) == jsched.is_restart_boundary(jc, prev, cur)


# ------------------------------------------------------- the train step

def _train_setup(n_batches=2, seed=0, batch_size=4, **dyn):
    """Reduced f32 egnn_40kp, port model with seeded weights, molgen batches
    of `batch_size` and injected (t, eps) per batch."""
    cfg = reduced_config()
    cfg["dynamics"].update(dyn)
    pad = PaddingConfig.from_config(cfg)
    ds, _ = molgen_splits_for_config(cfg, pad, 10, 8 * batch_size, seed)
    loader = PaddedLoader(ds, pad, batch_size, pad.n_kp, 12, seed=seed, drop_last=True, lig_buckets=[16])
    batches = list(loader.epoch())[:n_batches]
    rng = np.random.default_rng(seed + 5)
    t_eps = [(rng.integers(0, 1000, batch_size), rng.normal(size=(batch_size, 16, 3)).astype(np.float32),
              rng.normal(size=(batch_size, 16, 10)).astype(np.float32)) for _ in batches]
    return cfg, tmodel(cfg, device="cpu", seed=seed + 1), batches, t_eps


def _train_config(**kw):
    sched = dict(base_lr=LR, warmup_length=1.0, rec_enc_loss_weight=W_REC)
    sched.update(kw.pop("scheduler", {}))
    return dict(learning_rate=LR, weight_decay=WD, clip_grad=True, clip_value=CLIP, rec_encoder_loss_weight=W_REC,
                **kw), sched


def test_train_trajectory_matches_jax():
    """Four steps with a one-epoch warm-up over two iterations per epoch (lr
    0, 5e-5, 1e-4, 1e-4), two batches in turn."""
    cfg, tm, batches, t_eps = _train_setup()
    kw, sched = _train_config()
    init = {k: v.copy() for k, v in export_flat(tm).items()}  # export_flat's arrays share the parameters' memory
    params0 = jax_tree({k: v.copy() for k, v in init.items()})  # the JAX step donates its state
    jm = jmodel(cfg)
    jcfg = jtrainer.TrainConfig(scheduler=jsched.SchedulerConfig(**sched), **kw)
    jopt = jtrainer.make_optimizer(jcfg)
    jstate = jtrainer.TrainState(params=params0, opt_state=jopt.init(params0), step=jnp.zeros((), jnp.int32))
    jstep = jtrainer.make_train_step(jm, jcfg, jopt, iters_per_epoch=2, with_t_eps=True)
    jbatches = [jax_complex(b, 6, 12) for b in batches]

    tconf = ttrainer.TrainConfig(scheduler=tsched.SchedulerConfig(**sched), **kw)
    state = ttrainer.init_train_state(tm, tconf)
    step = ttrainer.make_train_step(tconf, iters_per_epoch=2)
    lrs = []
    for s in range(4):
        i = s % 2
        jstate, jm_metrics = jstep(jstate, jax.random.key(0), (jbatches[i], jax_t_eps(t_eps[i])))
        metrics = step(state, batches[i], t_eps=t_eps[i])
        for k in ("l2", "pos", "feat", "rec_encoder", "total"):
            assert_close(metrics[k], float(jm_metrics[k]), msg=f"step {s} {k}", **F32)
        for k in ("lr", "rec_enc_weight", "skipped_nonfinite"):
            np.testing.assert_allclose(metrics[k], float(jm_metrics[k]), rtol=1e-6, err_msg=f"step {s} {k}")
        lrs.append(metrics["lr"])
    assert lrs == pytest.approx([0.0, 5e-5, 1e-4, 1e-4])
    assert state.step == 4 == int(jstate.step)

    want, got = jax_flat(jstate.params), export_flat(tm)
    assert set(got) == set(want)
    for name in want:
        assert_close(got[name] - init[name], want[name] - init[name], msg=name, **F32)
    moved = {n for n in want if np.any(want[n] != init[n])}
    assert moved == {n for n in got if np.any(got[n] != init[n])}
    assert len(moved) > 0.75 * len(want)


def _snapshot(state):
    return ({n: p.detach().clone() for n, p in state.model.named_parameters()},
            copy.deepcopy(state.optimizer.state_dict()))


def _same_state(a, b):
    (pa, oa), (pb, ob) = a, b
    assert all(torch.equal(pa[n], pb[n]) for n in pa)
    assert oa["state"].keys() == ob["state"].keys()
    for k in oa["state"]:
        for name, v in oa["state"][k].items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(ob["state"][k][name])), (k, name)


def test_grad_accum_is_the_mean_of_micro_gradients():
    """grad_accum=2 on a batch of 4: the update of the mean of the two
    micro-batches' gradients (clipped, then Adam), the mean of their losses."""
    cfg, tm, batches, t_eps = _train_setup(n_batches=1)
    kw, sched = _train_config(grad_accum=2, scheduler=dict(warmup_length=0.0))
    tconf = ttrainer.TrainConfig(scheduler=tsched.SchedulerConfig(**sched), **kw)
    ref_model = copy.deepcopy(tm)
    state = ttrainer.init_train_state(tm, tconf)
    metrics = ttrainer.make_train_step(tconf, iters_per_epoch=2)(state, batches[0], t_eps=t_eps[0])

    grads = {n: torch.zeros_like(p) for n, p in ref_model.named_parameters()}
    micro = []
    for half in (slice(0, 2), slice(2, 4)):
        mb = batches[0].replace(**{f: getattr(batches[0], f)[half] for f in (
            "rec_x", "rec_h", "rec_mask", "rec_res_idx", "lig_x", "lig_h", "lig_mask", "kp_x", "kp_h", "kp_mask",
            "ip_x", "ip_mask")})
        losses = ref_model.loss(mb, t_eps_override=tuple(a[half] for a in t_eps[0]))
        total = losses["l2"] + W_REC * losses["rec_encoder"]
        g = torch.autograd.grad(total, list(ref_model.parameters()), allow_unused=True)
        for (n, _), gi in zip(ref_model.named_parameters(), g):
            if gi is not None:
                grads[n] += gi
        micro.append({k: float(v) for k, v in losses.items()} | {"total": float(total)})
    opt = ttrainer.make_optimizer(ref_model, tconf)
    for n, p in ref_model.named_parameters():
        p.grad = grads[n] * 0.5
    torch.nn.utils.clip_grad_value_(list(ref_model.parameters()), CLIP)
    opt.step()
    for k in ("l2", "pos", "feat", "rec_encoder", "total"):
        np.testing.assert_allclose(metrics[k], (micro[0][k] + micro[1][k]) / 2, rtol=1e-6, err_msg=k)
    for (n, p), (_, q) in zip(tm.named_parameters(), ref_model.named_parameters()):
        assert_close(p, q.detach(), rtol=1e-6, atol=1e-9, msg=n)
    with pytest.raises(ValueError, match="grad_accum"):
        ttrainer.make_train_step(ttrainer.TrainConfig(grad_accum=3), 2)(state, batches[0], t_eps=t_eps[0])


def test_nonfinite_step_is_skipped_and_keeps_adam_state():
    cfg, tm, batches, t_eps = _train_setup(n_batches=1)
    kw, sched = _train_config(scheduler=dict(warmup_length=0.0))
    tconf = ttrainer.TrainConfig(scheduler=tsched.SchedulerConfig(**sched), **kw)
    state = ttrainer.init_train_state(tm, tconf)
    step = ttrainer.make_train_step(tconf, iters_per_epoch=2)
    assert step(state, batches[0], t_eps=t_eps[0])["skipped_nonfinite"] == 0.0
    before = _snapshot(state)
    bad = batches[0].replace(lig_h=batches[0].lig_h.clone())
    bad.lig_h[0, 0, 0] = float("inf")
    metrics = step(state, bad, t_eps=t_eps[0])
    assert metrics["skipped_nonfinite"] == 1.0 and not np.isfinite(metrics["total"])
    _same_state(before, _snapshot(state))
    assert state.step == 2
    assert all(p.grad is None for p in tm.parameters())
    metrics = step(state, batches[0], t_eps=t_eps[0])
    assert metrics["skipped_nonfinite"] == 0.0
    assert any(not torch.equal(before[0][n], p) for n, p in tm.named_parameters())
    assert state.optimizer.state_dict()["state"][0]["step"] == 2


def test_checkpoint_round_trip(tmp_path):
    """Parameters, Adam state and step come back; one more step from the
    restored state equals one more step without the round trip."""
    cfg, tm, batches, t_eps = _train_setup()
    kw, sched = _train_config()
    tconf = ttrainer.TrainConfig(scheduler=tsched.SchedulerConfig(**sched), **kw)
    step = ttrainer.make_train_step(tconf, iters_per_epoch=2)
    state = ttrainer.init_train_state(tm, tconf)
    for s in range(2):
        step(state, batches[s], t_eps=t_eps[s])
    path = ttrainer.save_checkpoint(tmp_path / "checkpoints", state)
    assert path.name == "step_2.pt" and ttrainer.checkpoint_steps(tmp_path / "checkpoints") == [2]
    restored = ttrainer.init_train_state(tmodel(cfg, device="cpu", seed=99), tconf)
    ttrainer.load_checkpoint(tmp_path / "checkpoints", restored)
    assert restored.step == 2
    _same_state(_snapshot(state), _snapshot(restored))
    m_a = step(state, batches[0], t_eps=t_eps[0])
    m_b = step(restored, batches[0], t_eps=t_eps[0])
    assert m_a == m_b
    _same_state(_snapshot(state), _snapshot(restored))


def test_remat_gives_exactly_the_same_loss_and_gradients():
    _, tm, batches, t_eps = _train_setup(n_batches=1)
    cfg_r, tm_r, _, _ = _train_setup(n_batches=1, remat=True)
    assert tm_r.dynamics.remat and not tm.dynamics.remat
    load_params(tm_r, export_flat(tm))
    out = []
    for model in (tm, tm_r):
        losses = model.loss(batches[0], t_eps_override=t_eps[0])
        (losses["l2"] + W_REC * losses["rec_encoder"]).backward()
        out.append((losses, {n: p.grad for n, p in model.named_parameters()}))
    (la, ga), (lb, gb) = out
    assert all(torch.equal(la[k], lb[k]) for k in la)
    assert all((ga[n] is None and gb[n] is None) or torch.equal(ga[n], gb[n]) for n in ga)


# ------------------------------------------------------------ the CLI

def test_dump_yaml_round_trips():
    docs = [tcfg.load_config(p) for p in sorted((ROOT / "configs").glob("*.yml"))]
    docs.append({"a": 1e-12, "b": [1, 2.5, "x y", "it's", None, True, "true", "1.0", "", {"k": [1, {"z": 3}]}],
                 "c": {}, "d": [], "e": 1e20, "f": -0.0, "g": "a:b", "h": "#x", "i": "-1", "j": "2001-01-01",
                 "k": "0x1F", "m": [[1, 2], [3], [[4]]], "n": float("inf"), "o": 800.0})
    for doc in docs:
        text = tcfg.dump_yaml(doc)
        assert same(tcfg.parse_yaml(text), doc)
        assert same(yaml.safe_load(text), doc)


def _cli_config(tmp, **training):
    cfg = reduced_config()
    cfg["experiment"]["results_dir"] = str(tmp / "runs")
    cfg["training"].update({"batch_size": 4, "sample_interval": 0, "save_interval": 1, **training})
    path = tmp / "reduced.yml"
    path.write_text(yaml.safe_dump(cfg))
    return path


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    cfg_path = _cli_config(tmp)
    run_dir, state = tcli.main(["--config", str(cfg_path), "--synthetic_mol", "16", "--epochs", "1",
                                "--device", "cpu", "--seed", "3"])
    return cfg_path, Path(run_dir), state


def test_train_cli_writes_run_dir(cli_run):
    """Four steps (16 complexes, batch 4, one epoch), a test pass and a final
    checkpoint; config.yml reads back equal by both readers."""
    cfg_path, run_dir, state = cli_run
    want = yaml.safe_load(cfg_path.read_text())
    want["training"]["epochs"] = 1.0
    written = (run_dir / "config.yml").read_text()
    assert same(tcfg.parse_yaml(written), want) and same(yaml.safe_load(written), want)
    assert state.step == 4
    assert ttrainer.checkpoint_steps(run_dir / "checkpoints")[-1] == 4
    train_rows = ttrainer.MetricsLog(run_dir / "train_metrics.pkl").rows
    test_rows = ttrainer.MetricsLog(run_dir / "test_metrics.pkl").rows
    assert train_rows and all(np.isfinite(r["l2"]) and r["skipped_nonfinite"] == 0.0 for r in train_rows)
    assert test_rows[-1]["epoch"] == 1.0 and np.isfinite(test_rows[-1]["test_l2"])
    assert {"test_l2", "test_pos", "test_feat", "test_rec_encoder"} <= set(test_rows[-1])


def test_exported_params_load_in_jax_and_the_sampler(cli_run, tmp_path):
    """export_params' npz: the JAX package loads it against its own
    template and computes the port's loss on it; the port's sampler serves
    from it."""
    cfg_path, run_dir, _ = cli_run
    npz = tmp_path / "params.npz"
    assert texport.export(run_dir, npz) == 4
    cfg = tcfg.load_config(run_dir / "config.yml")
    _, tm, batches, t_eps = _train_setup(n_batches=1, seed=4)
    load_params(tm, read_keystr_npz(npz))
    jm = jmodel(cfg)
    jb = jax_complex(batches[0], 6, 12)
    params = load_params_npz(npz, jax.eval_shape(jm.init, jax.random.key(0), jb))
    want = jax.jit(jm.loss)(params, jax.random.key(0), jb, t_eps_override=jax_t_eps(t_eps[0]))
    with torch.no_grad():
        got = tm.loss(batches[0], t_eps_override=t_eps[0])
    for k in want:
        assert_close(got[k], want[k], msg=k, **F32)

    sampler = KeypointSampler.from_params(run_dir / "config.yml", npz, batch_size=4, device="cpu", seed=0,
                                          sample_steps=3)
    rng = np.random.default_rng(0)
    mols = sampler.sample_for_arrays(rng.normal(size=(40, 3)).astype(np.float32) * 4,
                                     np.eye(10, dtype=np.float32)[rng.integers(0, 10, 40)], n_mols=3, ligand_size=9)
    assert sampler.last_request["chunks"][0]["sizes"] == [9, 9, 9]
    assert len(mols) <= 3 and all(np.isfinite(m.coords).all() and 1 <= m.n_atoms <= 9 for m in mols)


@pytest.mark.parametrize("argv,refusal", [
    (["--n_devices", "2", "--epochs", "1"], None),
    (["--n_devices", "2", "--mp_devices", "3"], (SystemExit, "must divide the device count 2")),
    (["--n_devices", "2", "--mp_devices", "2", "--set", "graph.n_keypoints=5"],
     (ValueError, "n_keypoints 5 must be divisible")),
    (["--n_devices", "100000"], (ValueError, "visible")),
], ids=["two_ranks", "mp_not_dividing", "k_not_dividing", "too_many_devices"])
def test_train_cli_refuses_what_is_not_ported(tmp_path, monkeypatch, argv, refusal):
    """--n_devices 2 trains on 2 gloo ranks and writes one run dir (rank 0's
    checkpoints and logs); what the JAX CLI refuses is refused before a run
    dir is made: --mp_devices not dividing --n_devices
    (kpdiff_tpu/cli/train.py:207-209), a keypoint count the model axis does
    not divide, more devices than are visible."""
    cfg_path = _cli_config(tmp_path)
    argv = ["--config", str(cfg_path), "--synthetic_mol", "8", "--device", "cpu"] + argv
    if refusal is not None:
        with pytest.raises(refusal[0], match=refusal[1]):
            tcli.main(argv)
        assert not (tmp_path / "runs").exists()
        return
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    run_dir, state = tcli.main(argv)
    assert state is None and [p.name for p in (tmp_path / "runs").iterdir()] == [run_dir.name]
    assert ttrainer.checkpoint_steps(run_dir / "checkpoints")
    rows = ttrainer.MetricsLog(run_dir / "train_metrics.pkl").rows
    assert rows and all(np.isfinite(r["l2"]) and r["skipped_nonfinite"] == 0.0 for r in rows)
    assert np.isfinite(ttrainer.MetricsLog(run_dir / "test_metrics.pkl").rows[-1]["test_l2"])


def test_sampling_takes_the_kernel_entry_with_a_differentiable_encoder(tmp_path, monkeypatch):
    """encode records autograd now; the sampler still runs encode, compact_kk
    and sample under no_grad, so every dense edge (ll and dense kk, each
    layer, each step) calls egnn_edge_dense, even from a grad-enabled caller."""
    cfg_path = _cli_config(tmp_path)
    sampler = KeypointSampler.from_params(cfg_path, None, batch_size=4, device="cpu", seed=1, sample_steps=3)
    calls = []
    real = tegnn.egnn_edge_dense

    def counting(*a, **kw):
        calls.append(a[0].shape[1])
        return real(*a, **kw)

    monkeypatch.setattr(tegnn, "egnn_edge_dense", counting)
    rng = np.random.default_rng(1)
    with torch.enable_grad():
        mols = sampler.sample_for_arrays(rng.normal(size=(40, 3)).astype(np.float32) * 3,
                                         np.eye(10, dtype=np.float32)[rng.integers(0, 10, 40)], n_mols=4,
                                         ligand_size=10)
    assert len(mols) <= 4 and sampler.last_request["chunks"][0]["sizes"] == [10] * 4
    n_layers, k = 2, 6
    assert len(calls) in (n_layers * 3, 2 * n_layers * 3)  # ll, plus kk while it stays dense
    assert calls.count(k) in (0, n_layers * 3) and len(calls) - calls.count(k) == n_layers * 3
