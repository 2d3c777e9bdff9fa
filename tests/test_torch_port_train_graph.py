"""The port's optimizer step and held-out loss as replays of captured graphs, on the CPU.

kpdiff_tpu jits its whole optimizer step and its held-out loss; the port
captures `trainer.train_step_body` and `train_graph.loss_vector` into CUDA
graphs (training/train_graph.py). A CUDA graph cannot run here, so the tests
drive the runner with a host stand-in of the capture: a replay calls the
step on the same static buffers, as a graph replays its kernels on them,
and (`graph_like`) leaves the version counters of the parameters where they
were, as a replay does, so that the trainer's own version bump is what the
caches see.

  (i) trajectory: four steps with injected (t, eps) over two alternating
      ligand buckets, grad_accum 1 and 2: replayed equal eager bitwise, and
      both match kpdiff_tpu's make_train_step(..., with_t_eps=True) within
      test_train_trajectory_matches_jax's tolerance (f32 rtol 1e-4 / atol
      1e-5 on the losses and on every parameter's change);
  (ii) a non-finite step inside a replayed run is skipped: parameters,
      exp_avg, exp_avg_sq and Adam's count keep their values, as JAX's
      keep_finite keeps them;
  (iii) a capture audit: two steps' ATen ops (forward, backward, clip,
      Adam, select) are equal with their host arguments and hold no host
      synchronisation, for the flagship, egnn_ca, gvp_40kp with dropout and
      egnn_all_atom with remat and grad_accum 2;
  (iv) the cache: a capture per bucket and replays after; dropped by
      load_checkpoint and optimizer.load_state_dict; cuda_graph=True
      refused under a mesh, with exact OT and on CPU tensors;
  (v) after replayed steps the caches keyed on parameter versions (the
      sampler's bf16 copy, the edge kernel's packed weights, the chain
      graphs) rebuild: the analyzer's sample and the packs equal those of a
      fresh model loaded with the same parameters;
  (vi) the held-out loss graph equals eager evaluate and kpdiff_tpu's
      jitted model.loss on the same draws;
  (vii) a checkpoint written by the eager trainer of torch.optim.Adam loads
      and training goes on through graphs.
"""
import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kpdiff_tpu_torch.models.diffusion as tdiffusion
from kpdiff_tpu.config import load_config as jload
from kpdiff_tpu.training import scheduler as jsched, trainer as jtrainer
from kpdiff_tpu_torch.analysis.analyzer import ModelAnalyzer
from kpdiff_tpu_torch.cli.train import evaluate
from kpdiff_tpu_torch.config import PaddingConfig, model_from_config as tmodel, resolve_feature_sizes
from kpdiff_tpu_torch.data.dataset import PaddedLoader
from kpdiff_tpu_torch.data.molgen import molgen_splits_for_config, type_counts
from kpdiff_tpu_torch.models.chain_graph import ChainGraphs, host_capture
from kpdiff_tpu_torch.models.egnn import EGNNEdge
from kpdiff_tpu_torch.training import scheduler as tsched, trainer as ttrainer
from kpdiff_tpu_torch.training.train_graph import TrainGraphs, heldout_loss
from kpdiff_tpu_torch.utils.params_io import export_flat, load_params
from test_torch_port_chain import HOST_OPS, OpLog
from torch_port_util import (ROOT, assert_close, case_setup, jax_complex, jax_flat, jax_t_eps, jax_tree, jmodel,
                             reduce_family, reduced_config)

F32 = dict(rtol=1e-4, atol=1e-5)
LR, WD, CLIP, W_REC = 1e-4, 1e-12, 1.5, 0.1
BUCKETS = [12, 16]


def graph_like(model):
    """The capture stand-in of these tests: each replay calls the step on
    the same static buffers and then sets the version counters of the
    model's parameters back, as a CUDA graph's replay leaves them."""
    params = tuple(model.parameters())

    def capture(step, static, generator, pool, stream):
        def replay():
            with torch.autograd._unsafe_preserve_version_counter(params):
                step(static)
        return types.SimpleNamespace(replay=replay)

    return capture


def _graphs(model) -> TrainGraphs:
    model.train_graphs = TrainGraphs(capture=graph_like(model))
    return model.train_graphs


def _train_config(**kw):
    sched = dict(base_lr=LR, warmup_length=1.0, rec_enc_loss_weight=W_REC)
    sched.update(kw.pop("scheduler", {}))
    kw = dict(learning_rate=LR, weight_decay=WD, clip_grad=True, clip_value=CLIP, rec_encoder_loss_weight=W_REC, **kw)
    return ttrainer.TrainConfig(scheduler=tsched.SchedulerConfig(**sched), **kw), kw, sched


def _setup(cfg=None, n_batches=4, seed=0, buckets=BUCKETS):
    """Port model with seeded weights, molgen batches of 4 alternating over
    `buckets`, injected (t, eps) for each."""
    cfg = cfg or reduced_config()
    pad = PaddingConfig.from_config(cfg)
    ds, _ = molgen_splits_for_config(cfg, pad, resolve_feature_sizes(cfg)[0], 32, seed)
    tm = tmodel(cfg, device="cpu", seed=seed + 1)
    loader = PaddedLoader(ds, pad, 4, pad.n_kp, tm.cfg.rec_nf, seed=seed, drop_last=True, lig_buckets=buckets,
                          kp_vec_dim=tm.kp_vec_dim)
    batches = list(loader.epoch())[:n_batches]
    rng = np.random.default_rng(seed + 5)
    t_eps = [(rng.integers(0, cfg["diffusion"]["n_timesteps"], 4),
              rng.normal(size=tuple(b.lig_x.shape)).astype(np.float32),
              rng.normal(size=tuple(b.lig_h.shape)).astype(np.float32)) for b in batches]
    return cfg, tm, batches, t_eps


def _state(state):
    """Parameters, exp_avg, exp_avg_sq and Adam's counts, cloned."""
    opt = state.optimizer.state_dict()["state"]
    return ({n: p.detach().clone() for n, p in state.model.named_parameters()},
            {k: {n: v.clone() for n, v in s.items()} for k, s in opt.items()})


def _assert_same_state(a, b):
    (pa, oa), (pb, ob) = a, b
    assert all(torch.equal(pa[n], pb[n]) for n in pa)
    assert oa.keys() == ob.keys()
    for k in oa:
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(oa[k][name], ob[k][name]), (k, name)


# ---- (i) the trajectory: replayed, eager and JAX

@pytest.mark.parametrize("accum", [1, 2])
def test_replayed_steps_equal_eager_and_jax(accum):
    cfg = reduced_config()
    cfg["dynamics"]["n_layers"] = cfg["rec_encoder"]["n_convs"] = 1  # four JAX compiles: keep them small
    cfg, tm, batches, t_eps = _setup(cfg)
    assert [int(b.lig_x.shape[1]) for b in batches] == [12, 16, 12, 16]
    tconf, kw, sched = _train_config(grad_accum=accum)
    init = {k: v.copy() for k, v in export_flat(tm).items()}
    params0 = jax_tree({k: v.copy() for k, v in init.items()})
    jm = jmodel(cfg)
    jcfg = jtrainer.TrainConfig(scheduler=jsched.SchedulerConfig(**sched), **kw)
    jopt = jtrainer.make_optimizer(jcfg)
    jstate = jtrainer.TrainState(params=params0, opt_state=jopt.init(params0), step=jnp.zeros((), jnp.int32))
    jstep = jtrainer.make_train_step(jm, jcfg, jopt, iters_per_epoch=2, with_t_eps=True)

    runs = {}
    for graph in (False, True):
        model = copy.deepcopy(tm)
        graphs = _graphs(model)
        state = ttrainer.init_train_state(model, tconf)
        step = ttrainer.make_train_step(tconf, iters_per_epoch=2, cuda_graph=graph)
        runs[graph] = [step(state, b, t_eps=te) for b, te in zip(batches, t_eps)], export_flat(model), state
        assert len(graphs.captures) == (2 if graph else 0)
        # the first bucket: an eager warm-up step, the capture, a replay; the second: capture, two replays
        assert [e.replays for e in graphs._entries.values()] == ([1, 2] if graph else [])
    (eager, eager_p, _), (replayed, got, state) = runs[False], runs[True]
    assert replayed == eager  # every metric, bitwise
    assert all(np.array_equal(got[n], eager_p[n]) for n in got)
    assert [m["lr"] for m in replayed] == pytest.approx([0.0, 5e-5, 1e-4, 1e-4])
    assert state.step == 4 and float(state.optimizer.state_dict()["state"][0]["step"]) == 4

    for s, (b, te) in enumerate(zip(batches, t_eps)):
        jstate, jm_metrics = jstep(jstate, jax.random.key(0), (jax_complex(b, 6, 12), jax_t_eps(te)))
        for k in ("l2", "pos", "feat", "rec_encoder", "total"):
            assert_close(replayed[s][k], float(jm_metrics[k]), msg=f"step {s} {k}", **F32)
        for k in ("lr", "rec_enc_weight", "skipped_nonfinite"):
            np.testing.assert_allclose(replayed[s][k], float(jm_metrics[k]), rtol=1e-6, err_msg=f"step {s} {k}")
    want = jax_flat(jstate.params)
    assert set(got) == set(want)
    for name in want:
        assert_close(got[name] - init[name], want[name] - init[name], msg=name, **F32)
    moved = {n for n in want if np.any(want[n] != init[n])}
    # one layer: the keypoints' updates do not reach the ligand, so their parameters keep their values
    assert moved == {n for n in got if np.any(got[n] != init[n])} and len(moved) > 0.6 * len(want)


# ---- (ii) a non-finite step among replays

def test_nonfinite_replay_keeps_params_and_adam_state():
    _, tm, batches, t_eps = _setup(buckets=[16])
    tconf, _, _ = _train_config(scheduler=dict(warmup_length=0.0))
    graphs = _graphs(tm)
    state = ttrainer.init_train_state(tm, tconf)
    step = ttrainer.make_train_step(tconf, iters_per_epoch=2, cuda_graph=True)
    for i in range(2):  # the warm-up step, then a replay
        assert step(state, batches[i], t_eps=t_eps[i])["skipped_nonfinite"] == 0.0
    before = _state(state)
    bad = batches[0].replace(lig_h=batches[0].lig_h.clone())
    bad.lig_h[0, 0, 0] = float("inf")
    metrics = step(state, bad, t_eps=t_eps[0])
    assert metrics["skipped_nonfinite"] == 1.0 and not np.isfinite(metrics["total"])
    _assert_same_state(before, _state(state))
    assert state.step == 3 and float(state.optimizer.state_dict()["state"][0]["step"]) == 2
    assert len(graphs.captures) == 1 and graphs.last.replays == 2
    assert step(state, batches[2], t_eps=t_eps[2])["skipped_nonfinite"] == 0.0
    assert float(state.optimizer.state_dict()["state"][0]["step"]) == 3
    assert all(not torch.equal(before[0][n], p) for n, p in tm.named_parameters() if n.endswith("lig_enc.bias"))


# ---- (iii) the capture audit

def _audit_setup(name):
    if name == "flagship":
        cfg = reduced_config()
    else:
        cfg = reduce_family(jload(ROOT / f"configs/{name}.yml"))
        if name == "gvp_40kp":
            cfg["dynamics_gvp"]["dropout"] = cfg["rec_encoder_gvp"]["dropout"] = 0.1
    cfg, tm, batches, _ = _setup(cfg, n_batches=1, buckets=[16])
    return cfg, tm, batches[0]


@pytest.mark.parametrize("name", ["flagship", "egnn_ca", "gvp_40kp", "egnn_all_atom"])
def test_train_step_capture_audit(name):
    cfg, tm, batch = _audit_setup(name)
    accum = 2 if name == "egnn_all_atom" else 1
    if name == "egnn_all_atom":
        assert tm.dynamics.remat and tm.cfg.dynamics["kk_layout"] == "block"
    if name == "gvp_40kp":
        assert tm.dynamics.conv0.dropout > 0
    tconf, _, _ = _train_config(grad_accum=accum)
    opt = ttrainer.make_optimizer(tm, tconf)
    opt.prepare()
    gen = torch.Generator().manual_seed(0)
    lr, w_rec = torch.full((), 1e-4), torch.full((), W_REC)
    ttrainer.train_step_body(tm, tconf, opt, batch, None, gen, lr, w_rec)  # the warm-up step
    logs = []
    for _ in range(2):
        with OpLog() as log:
            vec, _ = ttrainer.train_step_body(tm, tconf, opt, batch, None, gen, lr, w_rec)
        logs.append(log.ops)
        assert bool(vec[0]) and torch.isfinite(vec).all()
    names = {op[0] for op in logs[0]}
    assert {"randint", "randn", "lerp", "where", "clamp_"} <= names
    if name == "gvp_40kp":
        assert "rand" in names  # the dropout masks
    assert not names & HOST_OPS, sorted(names & HOST_OPS)
    assert logs[0] == logs[1]  # no host value changes from one step to the next
    assert all(p.grad is None for p in tm.parameters())


# ---- (iv) the cache

def test_train_graph_cache(tmp_path):
    _, tm, batches, t_eps = _setup(n_batches=4)
    tconf, _, _ = _train_config()
    graphs = _graphs(tm)
    state = ttrainer.init_train_state(tm, tconf)
    step = ttrainer.make_train_step(tconf, iters_per_epoch=2, cuda_graph=True)
    for b, te in zip(batches, t_eps):
        step(state, b, t_eps=te)
    assert len(graphs) == 2 and len(graphs.captures) == 2  # one per bucket
    assert sorted(c["inputs"]["in.batch.lig_x"] for c in graphs.captures) == [(4, 12, 3), (4, 16, 3)]
    step(state, batches[0])  # drawn (t, eps): another input signature
    assert len(graphs) == 3
    accum2, _, _ = _train_config(grad_accum=2)
    ttrainer.make_train_step(accum2, 2, cuda_graph=True)(state, batches[0], t_eps=t_eps[0])
    assert len(graphs) == 4 and len(graphs.captures) == 4

    state.optimizer.load_state_dict(state.optimizer.state_dict())  # new state buffers: every graph is stale
    step(state, batches[1], t_eps=t_eps[1])
    assert len(graphs) == 1 and len(graphs.captures) == 5
    ttrainer.save_checkpoint(tmp_path / "checkpoints", state)
    ttrainer.load_checkpoint(tmp_path / "checkpoints", state)
    assert len(graphs) == 0
    step(state, batches[1], t_eps=t_eps[1])
    assert len(graphs) == 1 and len(graphs.captures) == 6

    with pytest.raises(ValueError, match="mesh"):
        ttrainer.make_train_step(tconf, 2, mesh=object(), cuda_graph=True)
    tm.train_graphs = TrainGraphs()  # the CUDA runner
    with pytest.raises(ValueError, match="CUDA tensors"):
        step(state, batches[0], t_eps=t_eps[0])
    assert ttrainer.make_train_step(tconf, 2)(state, batches[0], t_eps=t_eps[0])["skipped_nonfinite"] == 0.0
    assert len(tm.train_graphs) == 0  # eager on the CPU by default

    _, _, em, eb, _, ete = case_setup("hinge_exact_rec")
    estate = ttrainer.init_train_state(em, tconf)
    with pytest.raises(ValueError, match="exact"):
        ttrainer.make_train_step(tconf, 2, cuda_graph=True)(estate, eb, t_eps=ete)
    with pytest.raises(ValueError, match="exact"):
        heldout_loss(em, eb, t_eps=ete, cuda_graph=True)
    assert np.isfinite(ttrainer.make_train_step(tconf, 2)(estate, eb, t_eps=ete)["total"])


# ---- (v) the caches keyed on parameter versions see replayed steps

def test_caches_see_replayed_updates(monkeypatch):
    cfg = reduced_config("bfloat16")
    cfg["diffusion"]["n_timesteps"] = 12
    cfg, tm, batches, t_eps = _setup(cfg, n_batches=3, buckets=[16])
    pad = PaddingConfig.from_config(cfg)
    test_ds, _ = molgen_splits_for_config(cfg, pad, resolve_feature_sizes(cfg)[0], 8, 9)
    tconf, _, _ = _train_config(scheduler=dict(warmup_length=0.0))
    _graphs(tm)
    state = ttrainer.init_train_state(tm, tconf)
    step = ttrainer.make_train_step(tconf, iters_per_epoch=2, cuda_graph=True)
    samples = []
    real_sample = tdiffusion.KeypointDiffusion.sample

    def recording(model, *a, **kw):  # the analyzer's chain through the graph runner, as on a card
        out = real_sample(model, *a, **kw, cuda_graph=True)
        samples.append(out)
        return out

    monkeypatch.setattr(tdiffusion.KeypointDiffusion, "sample", recording)

    def analyze(model):
        model.chain_graphs = getattr(model, "_test_chain", None) or ChainGraphs(capture=host_capture)
        model._test_chain = model.chain_graphs
        analyzer = ModelAnalyzer(model, test_ds, pad, lig_elements=cfg["dataset"]["lig_elements"], n_receptors=2,
                                 n_replicates=2, train_type_counts=type_counts(test_ds), seed=3)
        del samples[:]
        analyzer.sample_and_analyze(torch.Generator().manual_seed(4))
        (out,) = samples
        return out

    step(state, batches[0], t_eps=t_eps[0])  # the warm-up step (eager), then the capture
    stale = analyze(tm)  # builds the bf16 copy, the packs and a chain graph at these weights
    old_key = tm._params_key()
    for i in (1, 2):  # replays only
        step(state, batches[i], t_eps=t_eps[i])
    assert tm.train_graphs.last.replays == 2
    assert tm._params_key() != old_key  # the trainer moved the versions the replays left
    got = analyze(tm)
    fresh = tmodel(cfg, device="cpu", seed=77)
    load_params(fresh, export_flat(tm))
    want = analyze(fresh)
    for k in ("lig_x", "lig_h", "lig_mask"):
        assert torch.equal(got[k], want[k]), k
    assert not torch.equal(got["lig_x"], stale["lig_x"])  # the replayed steps changed the sample
    assert len(tm.chain_graphs.captures) == 2  # recaptured at the new weights
    packs = [m for m in tm.modules() if isinstance(m, EGNNEdge) and m.kernel_ok]
    fresh_packs = [m for m in fresh.modules() if isinstance(m, EGNNEdge) and m.kernel_ok]
    assert len(packs) == len(fresh_packs) > 0
    for a, b in zip(packs, fresh_packs):
        wa, wb = a._kernel_weights(), b._kernel_weights()
        for k in wa:  # tensors, or PackedW2 tuples of tensors
            ta, tb = (wa[k],) if torch.is_tensor(wa[k]) else wa[k], (wb[k],) if torch.is_tensor(wb[k]) else wb[k]
            assert len(ta) == len(tb) and all(torch.equal(x, y) if torch.is_tensor(x) else x == y
                                              for x, y in zip(ta, tb)), k


# ---- (vi) the held-out loss

def test_heldout_loss_graph_matches_eager_and_jax():
    cfg, tm, batches, t_eps = _setup(n_batches=4)
    tm.loss_graphs = TrainGraphs(capture=host_capture)
    jm = jmodel(cfg)
    params = jax_tree(export_flat(tm))
    jloss = jax.jit(jm.loss)
    for b, te in zip(batches, t_eps):
        got = heldout_loss(tm, b, t_eps=te, cuda_graph=True)
        assert got == heldout_loss(tm, b, t_eps=te, cuda_graph=False)
        want = jloss(params, jax.random.key(0), jax_complex(b, 6, 12), t_eps_override=jax_t_eps(te))
        assert set(got) == set(want)
        for k in want:
            assert_close(got[k], float(want[k]), msg=k, **F32)
    graphs = tm.loss_graphs
    assert len(graphs.captures) == 2 and [e.replays for e in graphs._entries.values()] == [1, 2]

    loader = types.SimpleNamespace(epoch=lambda: iter(batches))
    replayed = evaluate(tm, loader, "cpu", torch.Generator().manual_seed(5), cuda_graph=True)
    eager = evaluate(tm, loader, "cpu", torch.Generator().manual_seed(5), cuda_graph=False)
    assert replayed == eager and {"test_l2", "test_rec_encoder"} <= set(replayed)
    assert len(graphs.captures) == 4  # the generator's draws: other inputs than injected (t, eps)
    with torch.no_grad():
        next(tm.parameters()).add_(0.0)  # a new version: the loss graphs read caches built from the weights
    evaluate(tm, loader, "cpu", torch.Generator().manual_seed(5), cuda_graph=True)
    assert len(graphs.captures) == 6 and len(graphs) == 2


# ---- (vii) a checkpoint of torch.optim.Adam

def test_eager_adam_checkpoint_continues_through_graphs(tmp_path):
    cfg, tm, batches, t_eps = _setup(n_batches=4)
    tconf, _, _ = _train_config(scheduler=dict(warmup_length=0.0))
    opt = torch.optim.Adam(tm.parameters(), lr=LR, betas=ttrainer.ADAM_BETAS, eps=ttrainer.ADAM_EPS,
                           weight_decay=WD)
    for b, te in zip(batches[:2], t_eps[:2]):  # the eager trainer's step of torch.optim.Adam
        tm.zero_grad(set_to_none=True)
        losses = tm.loss(b, t_eps_override=te)
        (losses["l2"] + W_REC * losses["rec_encoder"]).backward()
        for p in tm.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        torch.nn.utils.clip_grad_value_(list(tm.parameters()), CLIP)
        opt.step()
    (tmp_path / "checkpoints").mkdir()
    torch.save({"params": {n: p.detach().cpu() for n, p in tm.named_parameters()}, "optimizer": opt.state_dict(),
                "step": 2}, tmp_path / "checkpoints" / "step_2.pt")
    saved = opt.state_dict()["state"]

    runs = {}
    for graph in (False, True):
        model = tmodel(cfg, device="cpu", seed=99)
        _graphs(model)
        state = ttrainer.load_checkpoint(tmp_path / "checkpoints", ttrainer.init_train_state(model, tconf))
        assert state.step == 2
        loaded = state.optimizer.state_dict()["state"]
        for k in saved:
            for name in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(loaded[k][name].float(), saved[k][name].float()), (k, name)
        step = ttrainer.make_train_step(tconf, iters_per_epoch=2, cuda_graph=graph)
        runs[graph] = [step(state, b, t_eps=te) for b, te in zip(batches[2:], t_eps[2:])], _state(state)
        assert float(state.optimizer.state_dict()["state"][0]["step"]) == 4
    assert runs[True][0] == runs[False][0]
    _assert_same_state(runs[True][1], runs[False][1])
    assert any(not torch.equal(runs[True][1][0][n], p) for n, p in tm.named_parameters())
