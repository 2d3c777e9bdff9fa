"""The port's tracer (kpdiff_tpu_torch/utils/profiling.py) on the CPU: span
totals, self time and records, profiler ranges, counters and the snapshot,
the device timers' marks (their slot sequence under a recording stand-in
for an armed CUDA capture) and the serving layer's counters."""
from __future__ import annotations

import contextlib
import itertools
from pathlib import Path

import numpy as np
import pytest
import torch

from kpdiff_tpu_torch.config import PaddingConfig, dump_yaml, load_config, model_from_config, resolve_feature_sizes
from kpdiff_tpu_torch.models.complex import synthetic_batch
from kpdiff_tpu_torch.ops.cuda import egnn_edge
from kpdiff_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def tracer(monkeypatch):
    """A fresh tracer behind the module's functions, on a clock that moves
    10 ns a reading."""
    tr = profiling.Tracer()
    monkeypatch.setattr(profiling, "TRACER", tr)
    ticks = itertools.count(0, 10)
    monkeypatch.setattr(profiling.time, "perf_counter_ns", lambda: next(ticks))
    return tr


def test_span_totals_nesting_and_self_time(tracer):
    with profiling.span("outer", request=True) as outer:
        with profiling.span("inner") as inner:
            pass
        with profiling.span("inner"):
            pass
        late = profiling.span("late").__enter__()
        late.stop(total_as="late.kept_out")
    snap = profiling.snapshot()["spans"]
    assert inner.ns == 10 and snap["inner"] == {"n": 2, "ns": 20, "self_ns": 20}
    assert snap["outer"]["ns"] == outer.ns == 70 and snap["outer"]["self_ns"] == 70 - 30
    assert "late" not in snap and snap["late.kept_out"]["n"] == 1
    assert inner.request == outer.request == 1 and profiling.span("next", request=True).__enter__().request == 2
    assert tracer.records() == []  # totals only while tracing is off


def test_records_and_ranges_while_a_profiler_records(tracer):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.tracing()
        with profiling.span("serve.request", request=True):
            with profiling.span("serve.decode"):
                torch.ones(4).sum()
    with profiling.span("after"):
        pass
    names = [r[0] for r in tracer.records()]
    assert names == ["serve.decode", "serve.request"]
    decode = tracer.records()[0]
    assert decode[3] == "serve.request" and decode[4] == tracer.records()[1][4] and decode[2] > decode[1]
    ranges = {e.name: e for e in prof.events() if e.name.startswith(profiling.PREFIX)}
    assert set(ranges) == {"kpdiff.serve.request", "kpdiff.serve.decode"}
    # operator-scope ranges: no mirror on the device's timeline
    assert not any(getattr(e, "is_user_annotation", False) for e in ranges.values())
    profiling.enable()
    try:
        with profiling.span("enabled"):
            pass
    finally:
        profiling.enable(False)
    assert tracer.records()[-1][0] == "enabled"


def _recording_stamp(log):
    names = {i: n for i, n in enumerate(profiling.SLOTS)}

    def stamp(buf, slot, stream):
        log.append("begin" if slot == profiling.BEGIN else names[slot])
        buf[1 + (slot >= 0) + max(slot, 0)] += 1  # stands in for the kernel: counts, per replay and slot
    return stamp


def test_snapshot_reads_the_timers_and_the_existing_counters(tracer, monkeypatch):
    from kpdiff_tpu_torch.models.chain_graph import ChainGraphs, host_capture

    monkeypatch.setattr(egnn_edge, "launches", 7)
    monkeypatch.setattr(egnn_edge, "captured", 3)
    monkeypatch.setattr(egnn_edge, "list_launches", 2)
    runner = ChainGraphs(capture=host_capture)
    state = {"lig_x": torch.zeros(2, 3), "lig_h": torch.zeros(2, 1), "kp_x": torch.zeros(2, 3)}
    runner.run(state, lambda s: s["lig_x"].add_(1.0), 4, key=(), params_key=None)
    profiling.count("serve.rows_run", 5)
    log = []
    with profiling.armed("chain", "cpu", stamp=_recording_stamp(log)) as armed:
        armed.begin()
        profiling.device_mark("ll")
        armed.end()
        armed.timers.kernels = 40
    snap = profiling.snapshot()
    counters, chain = snap["counters"], snap["timers"]["chain"]
    assert counters["egnn_edge.launches"] == 7 and counters["egnn_edge.captured"] == 3
    assert counters["egnn_edge.list_launches"] == 2
    assert counters["chain.live_replays"] == 3 and counters["chain.captures_recorded"] == 1
    assert counters["serve.rows_run"] == 5 and snap["spans"]["chain.replays"]["n"] == 1
    assert snap["spans"]["chain.capture"]["n"] == 1  # host_capture: not armed, no timers
    assert log == ["begin", "rest", "ll"] and chain["graphs"] == 1 and chain["replays"] == 1
    assert chain["slots_ns"]["rest"] == 1 and chain["slots_ns"]["ll"] == 1 and chain["kernels_x_replays"] == 40
    assert armed.timers.stamps == 3


def test_device_mark_outside_a_capture_is_a_no_op(tracer):
    x = torch.ones(3, requires_grad=True)
    y = torch.zeros(2)
    out = profiling.device_mark("ll", x, y)
    assert out[0] is x and out[1] is y and profiling.device_mark("kk") == ()
    assert profiling.snapshot()["timers"] == {}


def _reduced(name, **dyn):
    cfg = load_config(ROOT / "configs" / f"{name}.yml")
    cfg["padding"].update(n_rec=48, n_lig=16, n_ip=16)
    cfg["graph"]["n_keypoints"] = 6
    if "dynamics" in cfg:
        cfg["dynamics"].update(n_layers=2, hidden_nf=16, compute_dtype="float32", **dyn)
        cfg["rec_encoder"].update(n_convs=2, hidden_n_node_feat=16, out_n_node_feat=12, compute_dtype="float32")
    else:
        cfg["dynamics_gvp"].update(n_convs=3, n_hidden_scalars=12, vector_size=4, n_message_gvps=2,
                                   n_update_gvps=1, n_noise_gvps=2, dropout=0.0, compute_dtype="float32")
        cfg["rec_encoder_gvp"].update(out_scalar_size=10, vector_size=4, n_rr_convs=2, n_rk_convs=2,
                                      n_message_gvps=2, n_update_gvps=1, dropout=0.0, compute_dtype="float32")
    return cfg


def _batch(cfg, model, batch=2):
    pad = PaddingConfig.from_config(cfg)
    n_rec_feat, n_lig_feat, _ = resolve_feature_sizes(cfg)
    return synthetic_batch(0, batch=batch, n_rec_pad=pad.n_rec, n_lig_pad=pad.n_lig, n_rec_feat=n_rec_feat,
                           n_lig_feat=n_lig_feat, n_kp=pad.n_kp, kp_feat_dim=model.cfg.rec_nf,
                           kp_vec_dim=model.kp_vec_dim, n_ip_pad=pad.n_ip, min_rec=24, min_lig=8)


# one conv layer of either family with kl, lk and kk: the four segments
LAYER = ["rest", "ll", "kl", "kk"]


@pytest.mark.parametrize("name,expected", [
    ("egnn_40kp", ["begin"] + LAYER * 2 + ["rest"]),
    # GVP: lk continues kl's slot; the last conv has no lk or kk edges
    ("gvp_40kp", ["begin"] + LAYER * 2 + ["rest", "ll", "kl"] + ["rest"]),
], ids=["egnn", "gvp"])
def test_reverse_step_slot_sequence(tracer, name, expected):
    cfg = _reduced(name)
    model = model_from_config(cfg, device="cpu", seed=0).eval()
    with torch.no_grad():
        enc, kk = model.encode(_batch(cfg, model))
        st, _, _ = model.start_chain(enc, model.compact_kk(enc, kk), sample_steps=5)
        log = []
        with profiling.armed("chain", "cpu", stamp=_recording_stamp(log)) as armed:
            armed.begin()
            model.reverse_step(model._sampling_dynamics(), st, 1.0, torch.Generator().manual_seed(0))
            armed.end()
    assert log == expected
    assert int(armed.timers.buf[1]) == 1 and int(armed.timers.buf[2:].sum()) == len(expected) - 1


def test_train_step_slot_sequence_credits_each_backward_to_its_segment(tracer):
    from kpdiff_tpu_torch.cli.train import train_config_from
    from kpdiff_tpu_torch.training import trainer

    cfg = _reduced("egnn_40kp")
    model = model_from_config(cfg, device="cpu", seed=0)
    model.train()
    tcfg = train_config_from(cfg)
    state = trainer.init_train_state(model, tcfg)
    state.optimizer.prepare()
    batch = _batch(cfg, model)
    log = []
    with profiling.armed("train", "cpu", stamp=_recording_stamp(log)) as armed:
        armed.begin()
        trainer.train_step_body(model, tcfg, state.optimizer, batch, None, torch.Generator().manual_seed(0),
                                torch.full((), 1e-4), torch.full((), 0.1))
        armed.end()
    forward = ["begin", "rest", "encoder", "ot"] + LAYER * 2
    # backward mirrors the forward: each mark's identity closes the segment the forward opened there
    backward = ["rest", "kk", "kl", "ll"] * 2 + ["rest", "ot"]
    assert log == forward + backward + ["encoder", "rest", "optimizer"]


def test_marks_add_no_computing_op_to_a_train_step(tracer):
    """Armed, a train step issues the same computing ops as unarmed: the
    marks' identities add views only (no backward through outputs that
    reach no loss, such as the last layer's keypoint sums)."""
    import collections

    from torch.utils._python_dispatch import TorchDispatchMode

    from kpdiff_tpu_torch.cli.train import train_config_from
    from kpdiff_tpu_torch.training import trainer

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[str(func)] += 1
            return func(*args, **(kwargs or {}))

    cfg = _reduced("egnn_40kp")
    model = model_from_config(cfg, device="cpu", seed=0)
    model.train()
    tcfg = train_config_from(cfg)
    state = trainer.init_train_state(model, tcfg)
    state.optimizer.prepare()
    batch = _batch(cfg, model)
    counts = []
    for arm in (False, True):
        ops = Ops()
        with contextlib.ExitStack() as stack:
            if arm:
                stack.enter_context(profiling.armed("train", "cpu", stamp=lambda buf, slot, stream: None))
            with ops:
                trainer.train_step_body(model, tcfg, state.optimizer, batch, None, torch.Generator().manual_seed(0),
                                        torch.full((), 1e-4), torch.full((), 0.1))
        counts.append(ops.ops)
    extra = counts[1] - counts[0]
    assert extra and set(extra) <= {"aten.view.default", "aten.detach.default"}, extra
    assert not counts[0] - counts[1] - collections.Counter({"aten.lift_fresh.default": 1})


def test_serve_counts_slot_use_on_a_repeat_padded_chunk(tracer, tmp_path):
    from kpdiff_tpu_torch.serve import KeypointSampler

    cfg = _reduced("egnn_40kp")
    (tmp_path / "cfg.yml").write_text(dump_yaml(cfg))
    sampler = KeypointSampler.from_params(tmp_path / "cfg.yml", None, batch_size=4, device="cpu", seed=0,
                                          sample_steps=3)
    rng = np.random.default_rng(0)
    n_rec_feat = len(cfg["dataset"]["rec_elements"])
    rec_pos = rng.normal(size=(30, 3)).astype(np.float32) * 3
    rec_feat = np.eye(n_rec_feat, dtype=np.float32)[rng.integers(0, n_rec_feat, 30)]
    sampler.sample_for_arrays(rec_pos, rec_feat, init_com=rec_pos.mean(0), n_mols=3, ligand_size=7)
    snap = profiling.snapshot()
    c, spans = snap["counters"], snap["spans"]
    bucket = sampler.last_request["chunks"][0]["bucket"]
    assert sampler.last_request["chunks"][0]["batch"] == 3 and bucket == 8
    assert c["serve.rows_asked"] == 3 and c["serve.rows_run"] == 4
    assert c["serve.lig_atom_steps"] == 3 * 7 * 3 and c["serve.slot_atom_steps"] == 4 * bucket * 3
    layout = sampler.last_request["chunks"][0]["kk"]
    assert c[f"serve.chunks_kk_{layout}"] == 1 and c["serve.ligands_decoded"] == 3
    for name in ("serve.request", "serve.front_end", "serve.encode", "serve.compact_kk", "serve.chain",
                 "serve.readback", "serve.decode", "serve.build"):
        assert spans[name]["n"] >= 1, name
    assert spans["serve.front_end"]["n"] == 2  # the request's sizes, then the chunk's collation
    assert sampler.last_request["front_end_s"] == pytest.approx(spans["serve.front_end"]["ns"] * 1e-9)
    assert sampler.last_request["copy_s"] == pytest.approx(spans["serve.decode"]["ns"] * 1e-9)
