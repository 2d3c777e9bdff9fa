"""The fixed-encoder kind (traffic/generate_fixed.py) and its reference
(reference/model_fixed.py, encoder_fixed.py) against the program, on the
CPU at a tiny width on seeded random weights: the keypoints as a set, kk
from compact_kk's neighbor list against the rr radius graph (a pair inside
the band too), the chain's steps and decode in float32, planted faults and
the fp8 control reading not correct; the cells of the kind against its
readings (test_portbench_files.py's table of limits knows the kinds
`generate` and `train` alone), and on the card (marked `card`) the control
failing the cell at its own size."""
from __future__ import annotations

import copy
import dataclasses
import time

import numpy as np
import pytest
import torch

from portbench import compare, faults, flops, flops_fixed, harness
from portbench.tests.util import BENCH, write_archive

KIND = "generate_fixed"
WORKLOAD = "egnn_all_atom.generate"
RR = 3.5
# the tiny cell's check sizes and limits are the all-atom cell's: the
# encoder, kk and decode exact, step_gap as set on the card (PERF.md)
CELL = harness.read_json(harness.BENCH_DIR / "workloads" / f"{WORKLOAD}.json")
KK_SLOT_USE = next(m for m in harness.read_json(BENCH)["per_layer"] if m["name"] == "kk_slot_use.aa")
READINGS = {"enc_x_rms_A", "enc_h_gap", "kk_mismatch", "step_gap", "decode_mismatch"}


def tiny_fixed_model(dtype: str = "float32"):
    """egnn_all_atom at width 16, two layers, 96 receptor slots."""
    model = copy.deepcopy(harness.read_json(harness.BENCH_DIR / "configs" / "egnn_all_atom.json")["model"])
    model["padding"]["n_rec"] = 96
    model["dynamics"].update(n_layers=2, hidden_nf=16, compute_dtype=dtype, kk_block_size=32)
    return model


def tiny_fixed_spec(tmp_path, dtype: str = "float32", seed: int = 123, trace: bool = False,
                    seconds: float = 0.0) -> harness.Spec:
    """A CPU cell of the generate_fixed kind on eval_ref_k250's pocket pool:
    4 rows, 8 steps, pockets of 48-96 atoms."""
    model = tiny_fixed_model(dtype)
    traffic = dict(harness.read_json(harness.BENCH_DIR / "traffic" / "eval_ref_k250.json"), kind=KIND,
                   n_mols=4, batch_size=4, sample_steps=8, rec_atoms=[48, 96], pockets=4)
    config = dict(harness.read_json(harness.BENCH_DIR / "configs" / "egnn_all_atom.json"), model=model)
    bench = harness.read_json(BENCH)
    return harness.Spec(
        workload="tiny_egnn_all_atom.generate", seed=seed, seconds=seconds, trace=trace, chips=1,
        config_name=f"tiny_egnn_all_atom_{dtype}", config=config, traffic_name="tiny_eval_aa", traffic=traffic,
        cell=copy.deepcopy(CELL),
        end_to_end=[m for m in bench["end_to_end"] if m["name"] in ("ligands_per_s", "setup_s")],
        per_layer=[KK_SLOT_USE], t_process=time.perf_counter(), device="cpu",
        archive=write_archive(model, tmp_path / "params.npz"))


def kind():
    return harness.kind_module(KIND)


def _pocket(spec, index: int = 0):
    from portbench.traffic import generate

    return generate.make_pockets(spec.traffic, spec.model_config)[index]


def _program_encode(spec, pocket, rows: int = 2):
    """The program's model, its keypoints and compact_kk's kk of `pocket` in `rows` rows."""
    from kpdiff_tpu_torch.config import PaddingConfig, model_from_config
    from kpdiff_tpu_torch.data.padding import to_complex

    from portbench.reference.model import pad_pocket
    from portbench.reference.model_fixed import fixed_padding

    model_cfg = spec.model_config
    program = model_from_config(model_cfg, device="cpu", seed=0).eval()
    item = pad_pocket(pocket["rec_pos"], pocket["rec_feat"], pocket["rec_res_idx"], pocket["interface_points"],
                      pocket["n_lig"], 10, fixed_padding(model_cfg), pocket["bucket"])
    pad = dataclasses.replace(PaddingConfig.from_config(model_cfg), n_lig=pocket["bucket"])
    cpx = to_complex([item] * rows, pad, 10, None, device="cpu")
    with torch.no_grad():
        enc, kk = program.encode(cpx)
        kk = program.compact_kk(enc, kk)
    return item, enc, kk


def test_reference_agrees_with_the_port(tmp_path):
    """A whole run in float32: keypoints exact as a set, kk exact, every
    checked step within 1e-4 of the reference's move, decode exact; the kk
    the chain ran was compact_kk's neighbor list."""
    out, recs, steps = kind().execute(tiny_fixed_spec(tmp_path, seconds=0.5))
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 4, out["checks"]
    c = out["checks"]
    for name in ("enc_x_rms_A", "enc_h_gap", "kk_mismatch", "decode_mismatch"):
        assert c[name]["value"] == 0, (name, c[name])
    assert c["step_gap"]["value"] < 1e-4, c["step_gap"]
    assert all(r.request["chunks"][0]["kk"].startswith("nbr") for r in recs)


def test_keypoints_match_the_reference_as_a_set(tmp_path):
    """The program's Morton-ordered keypoints are the reference's pocket
    atoms in another order: equal as sets, not row by row; a keypoint
    moved or dropped reads as such."""
    from portbench.reference.model_fixed import load_fixed_reference
    from portbench.traffic.generate_fixed import ENC_MISSING, encoder_gaps

    spec = tiny_fixed_spec(tmp_path)
    pocket = _pocket(spec)
    item, enc, _ = _program_encode(spec, pocket)
    ref = load_fixed_reference(spec.model_config, None, "cpu").encode([item], "cpu")
    assert not torch.equal(enc.kp_x[0], ref.kp_x[0])  # the program reorders them
    assert encoder_gaps(enc.kp_x, enc.kp_h, enc.kp_mask, ref) == (0.0, 0.0)
    moved = enc.kp_x.clone()
    moved[1, 0, 0] += 0.5
    assert encoder_gaps(moved, enc.kp_h, enc.kp_mask, ref)[0] > 0
    dropped = enc.kp_mask.clone()
    dropped[0, 0] = False
    assert encoder_gaps(enc.kp_x, enc.kp_h, dropped, ref) == ENC_MISSING


def test_kk_list_against_the_rr_graph_with_a_pair_in_the_band(tmp_path):
    """compact_kk's list against the reference's rr radius graph: 0 apart;
    a pair placed 5e-5 Å inside the cutoff (in the band) may fall either
    way and still reads 0; an edge dropped elsewhere reads 1."""
    from portbench.reference.encoder_fixed import rr_adjacency
    from portbench.traffic.generate_fixed import kk_mismatch

    spec = tiny_fixed_spec(tmp_path)
    pocket = dict(_pocket(spec))
    pos = pocket["rec_pos"].copy()
    pos[1] = pos[0] + np.array([RR - 5e-5, 0.0, 0.0], np.float32)
    pocket["rec_pos"] = pos
    _, enc, (idx, valid) = _program_encode(spec, pocket)
    kp_x, kp_mask = enc.kp_x, enc.kp_mask
    d = torch.cdist(kp_x.double(), kp_x.double())
    in_band = (torch.abs(d - RR) < compare.KK_BAND_A) & kp_mask[:, :, None] & kp_mask[:, None, :]
    assert int(in_band.sum()) >= 2  # the planted pair, both directions, in each row
    adj = rr_adjacency(kp_x, kp_mask, RR)
    assert kk_mismatch((idx, valid), adj, kp_x, RR) == 0

    dst = torch.arange(kp_x.shape[1])[None, :, None].expand_as(idx)
    band_slot = valid & in_band[torch.arange(idx.shape[0])[:, None, None], idx, dst]
    flipped = valid & ~band_slot
    assert int(band_slot.sum()) > 0
    assert kk_mismatch((idx, flipped), adj, kp_x, RR) == 0
    other = torch.nonzero(flipped)[0]
    flipped[tuple(other)] = False
    assert kk_mismatch((idx, flipped), adj, kp_x, RR) == 1


def kk_edge_dropped(monkeypatch):
    """compact_kk's list loses the first valid edge of each chunk."""
    from kpdiff_tpu_torch.models.diffusion import KeypointDiffusion

    compact = KeypointDiffusion.compact_kk

    def dropped(self, cpx, kk, *a, **k):
        idx, valid = compact(self, cpx, kk, *a, **k)
        valid = valid.clone()
        valid[tuple(torch.nonzero(valid)[0])] = False
        return idx, valid

    monkeypatch.setattr(KeypointDiffusion, "compact_kk", dropped)


FAULTS = dict(faults.GENERATE, kk_edge_dropped=kk_edge_dropped)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_faults_make_correct_false(tmp_path, monkeypatch, fault):
    spec = tiny_fixed_spec(tmp_path)
    FAULTS[fault](monkeypatch)
    out = kind().run(spec)
    assert not out["correct"], out["checks"]


def test_control_reads_above_the_program_on_the_cpu(tmp_path):
    """bfloat16 sites: the control (fp8 there) reads the steps well above the
    program; the encoder, which has no weights, reads 0 on both."""
    from portbench.traffic.generate_fixed import readings

    spec = tiny_fixed_spec(tmp_path, dtype="bfloat16", seconds=0.5)
    out, recs, steps = kind().execute(spec)
    program = {k: c["value"] for k, c in out["checks"].items()}
    control = readings(spec, recs, steps, control=True)
    assert control["enc_x_rms_A"] == control["enc_h_gap"] == 0 == program["enc_x_rms_A"]
    assert control["step_gap"] > 3 * program["step_gap"] > 0, (control, program)


def test_traced_run_reads_the_layers_it_can_on_the_cpu(tmp_path):
    out = kind().run(tiny_fixed_spec(tmp_path, trace=True, seconds=0.3))
    assert out["correct"]
    assert set(out["metrics"]) == {"kk_slot_use.aa"}
    assert 0 < out["metrics"]["kk_slot_use.aa"]["value"] <= 100


def test_the_yardstick_is_put_back(tmp_path):
    readings, step_flops = compare.generate_readings, flops.step_flops
    kind().run(tiny_fixed_spec(tmp_path))
    assert compare.generate_readings is readings and flops.step_flops is step_flops


def test_fixed_count_holds_the_one_hot_keypoint_encoder():
    """The keypoint encoder maps the 10-wide element one-hot through 20 to
    256 on every keypoint; the rest is flops.egnn_step_flops'."""
    model = harness.read_json(harness.BENCH_DIR / "configs" / "egnn_all_atom.json")["model"]
    counts = dict(n_lig=32 * 20, n_kp=32 * 300, ll_pairs=32 * 20 * 6, kl_pairs=32 * 300 * 5, kk_pairs=32 * 300 * 6)
    no_encoder = flops.egnn_step_flops(model, **counts)  # out_n_node_feat 256 == hidden_nf: no encoder counted
    assert flops_fixed.step_flops(model, **counts) - no_encoder == 32 * 300 * 2 * (10 * 20 + 20 * 256)


def _fixed_cells():
    bench = harness.read_json(BENCH)
    return [w["name"] for w in bench["workloads"]
            if harness.read_json(harness.BENCH_DIR / "traffic" / f"{w['traffic']}.json")["kind"] == KIND]


def test_the_all_atom_cell_runs_this_kind():
    assert _fixed_cells() == [WORKLOAD]


@pytest.mark.parametrize("workload", _fixed_cells())
def test_fixed_cells_find_their_files(workload):
    """What test_portbench_files.py checks of a cell, for this kind: its
    limits name every reading and the exact ones are 0; the configuration
    has a fixed encoder; the traffic keeps eval_ref_k250's pocket pool, one
    chunk a pocket at the configuration's sampling batch; its metrics
    include kk_slot_use.aa."""
    spec = harness.load_spec(workload, 1, 1.0, False)
    assert kind().run and set(spec.cell["limits"]) == READINGS
    assert all(spec.cell["limits"][k] == 0 for k in ("kk_mismatch", "decode_mismatch"))
    model = spec.model_config
    assert model["diffusion"]["rec_encoder_type"] == "fixed"
    pool = harness.read_json(harness.BENCH_DIR / "traffic" / "eval_ref_k250.json")
    for key in ("pool_seed", "pockets", "rec_atoms", "buckets", "bucket_weights", "ligand_atoms",
                "sample_steps", "eta", "ligand_size"):
        assert spec.traffic[key] == pool[key], key
    assert spec.traffic["n_mols"] == spec.traffic["batch_size"] == model["sampling_config"]["diff_batch_size"]
    assert "kk_slot_use.aa" in {m["name"] for m in spec.per_layer}
    assert "ligands_per_s" in {m["name"] for m in spec.end_to_end}


@pytest.mark.card
def test_control_fails_the_all_atom_cell_on_the_card():
    """At the cell's own size: the program reads correct and the control
    (fp8 at the bfloat16 sites) does not, on three seeds."""
    from portbench.traffic.generate_fixed import readings

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    harness.set_cache_env()
    for seed in (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303):
        spec = harness.load_spec(WORKLOAD, seed, 3.0, False)
        spec.t_process = time.perf_counter()
        out, recs, steps = kind().execute(spec)
        assert out["correct"], out["checks"]
        control = readings(spec, recs, steps, control=True)
        judged = compare.judge(control, {k: spec.cell["limits"][k] for k in control})
        assert not all(c["value"] <= c["limit"] for c in judged.values()), control
        del recs
        torch.cuda.empty_cache()
