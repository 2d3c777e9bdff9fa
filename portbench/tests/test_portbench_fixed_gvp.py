"""The fixed-encoder GVP kind (traffic/generate_fixed_gvp.py) and its
reference (reference/model_fixed_gvp.py) against the program, on the CPU at
a tiny width on seeded random weights (the program's initialisation with its
matrices doubled, `tiny_archive`): a whole run in float32, the kk
messages aggregated in destination blocks against the whole grid, planted
faults (a kk edge dropped, the kk mean taken as a sum, and faults.py's)
and the fp8 control reading not correct; the operation count on the
one-hot keypoint width; the cells of the kind against its readings
(test_portbench_files.py's table of limits knows the kinds `generate` and
`train` alone), and on the card (marked `card`) the control failing the
cell at its own size."""
from __future__ import annotations

import copy
import time

import numpy as np
import pytest
import torch

from portbench import compare, faults, flops, flops_fixed_gvp, harness
from portbench.reference import model_fixed
from portbench.tests.test_portbench_fixed import kk_edge_dropped
from portbench.tests.util import BENCH, write_archive

KIND = "generate_fixed_gvp"
WORKLOAD = "gvp_all_atom.generate"
CELL = harness.read_json(harness.BENCH_DIR / "workloads" / f"{WORKLOAD}.json")
# The tiny cell's check sizes and exact limits are the GVP all-atom cell's.
# In float32 the program and the reference differ by rounding alone (step_gap
# below 3e-6 here), so there step_gap's limit is the 1e-4 that
# test_reference_agrees_with_the_port asks for; the card's limit (PERF.md)
# is set for bfloat16 and holds the bfloat16 tiny cell.
F32_STEP_GAP = 1e-4
# At width 16 the program's initialisation barely lets the keypoints reach
# the ligand (every kk edge dropped moves eps by 5e-5 to 4e-4 of its size, a
# kk mean taken as a sum reads a step_gap of 9e-5); with its matrices
# doubled, by 4-5%, and the bfloat16 control reads 12 times the program.
GAIN = 2.0
SLOT_USE = [m for m in harness.read_json(BENCH)["per_layer"] if m["name"] in ("kk_slot_use.aa", "kp_slot_use.aa")]
READINGS = {"enc_x_rms_A", "enc_h_gap", "kk_mismatch", "step_gap", "decode_mismatch"}


def tiny_fixed_gvp_model(dtype: str = "float32"):
    """gvp_all_atom at 16 scalars and 4 vectors, two convs, 96 receptor slots
    (the keypoint vectors' width, rec_encoder_gvp.vector_size, follows)."""
    model = copy.deepcopy(harness.read_json(harness.BENCH_DIR / "configs" / "gvp_all_atom.json")["model"])
    model["padding"]["n_rec"] = 96
    model["dynamics_gvp"].update(n_convs=2, n_hidden_scalars=16, vector_size=4, compute_dtype=dtype,
                                 kk_block_size=32, dropout=0.0)
    model["rec_encoder_gvp"]["vector_size"] = 4
    return model


def tiny_fixed_gvp_spec(tmp_path, dtype: str = "float32", seed: int = 123, trace: bool = False,
                        seconds: float = 0.0) -> harness.Spec:
    """A CPU cell of the generate_fixed_gvp kind on eval_ref_k250's pocket
    pool: 4 rows, 8 steps, pockets of 48-96 atoms."""
    model = tiny_fixed_gvp_model(dtype)
    traffic = dict(harness.read_json(harness.BENCH_DIR / "traffic" / "eval_ref_k250.json"), kind=KIND,
                   n_mols=4, batch_size=4, sample_steps=8, rec_atoms=[48, 96], pockets=4)
    config = dict(harness.read_json(harness.BENCH_DIR / "configs" / "gvp_all_atom.json"), model=model)
    cell = copy.deepcopy(CELL)
    if dtype == "float32":
        cell["limits"]["step_gap"] = F32_STEP_GAP
    bench = harness.read_json(BENCH)
    return harness.Spec(
        workload="tiny_gvp_all_atom.generate", seed=seed, seconds=seconds, trace=trace, chips=1,
        config_name=f"tiny_gvp_all_atom_{dtype}", config=config, traffic_name="tiny_eval_aa_gvp", traffic=traffic,
        cell=cell, end_to_end=[m for m in bench["end_to_end"] if m["name"] in ("ligands_per_s", "setup_s")],
        per_layer=SLOT_USE, t_process=time.perf_counter(), device="cpu", archive=tiny_archive(model, tmp_path))


def tiny_archive(model, tmp_path):
    """The program's initialisation (util.write_archive) with every matrix
    (`kernel`, and the GVPs' `Wh` and `Wu`) times GAIN."""
    path = write_archive(model, tmp_path / "params.npz")
    with np.load(path) as z:
        arrays = {k: z[k] * GAIN if k.endswith(("['kernel']", "['Wh']", "['Wu']")) else z[k] for k in z.files}
    np.savez(path, **arrays)
    return path


def kind():
    return harness.kind_module(KIND)


def test_reference_agrees_with_the_port(tmp_path):
    """A whole run in float32: keypoints exact as a set, kk exact, every
    checked step within 1e-4 of the reference's move, decode exact; the kk
    the chain ran was compact_kk's neighbor list."""
    out, recs, steps = kind().execute(tiny_fixed_gvp_spec(tmp_path, seconds=0.5))
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 4, out["checks"]
    c = out["checks"]
    for name in ("enc_x_rms_A", "enc_h_gap", "kk_mismatch", "decode_mismatch"):
        assert c[name]["value"] == 0, (name, c[name])
    assert c["step_gap"]["value"] < F32_STEP_GAP, c["step_gap"]
    assert all(r.request["chunks"][0]["kk"].startswith("nbr") for r in recs)


def test_destination_blocks_give_the_whole_grid():
    """The reference's kk messages aggregated over blocks of DST_BLOCK
    destinations equal GVPEdgeMessages.dense over the whole grid, the mean's
    counts included (80 destinations: two whole blocks and a part)."""
    from portbench.reference.gvp import GVPEdgeMessages
    from portbench.reference.model_fixed_gvp import DST_BLOCK, GVPDestinationBlocks

    b, k, s, v = 2, 80, 8, 3
    assert k > 2 * DST_BLOCK and k % DST_BLOCK
    g = torch.Generator().manual_seed(5)
    whole = GVPEdgeMessages(s, v, torch.Generator().manual_seed(6), agg="mean")
    blocks = GVPEdgeMessages(s, v, torch.Generator().manual_seed(6), agg="mean")
    blocks.__class__ = GVPDestinationBlocks
    x = torch.randn(b, k, 3, generator=g) * 3
    h, vec = torch.randn(b, k, s, generator=g), torch.randn(b, k, v, 3, generator=g)
    adj = (torch.cdist(x, x) < 3.5) & ~torch.eye(k, dtype=torch.bool)
    adj[:, :, 5] = False  # a destination with no source: the mean's clamped count
    with torch.no_grad():
        want = whole.dense(h, vec, x, h, vec, x, adj)
        got = blocks.dense(h, vec, x, h, vec, x, adj)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=1e-6, atol=1e-6)


def test_each_fixed_reference_takes_its_own_architecture():
    """model_fixed.py refuses a GVP configuration and model_fixed_gvp.py an EGNN one."""
    from portbench.reference.model_fixed_gvp import FixedGVPRefModel

    with pytest.raises(ValueError):
        model_fixed.FixedRefModel(tiny_fixed_gvp_model())
    egnn = harness.read_json(harness.BENCH_DIR / "configs" / "egnn_all_atom.json")["model"]
    with pytest.raises(ValueError):
        FixedGVPRefModel(egnn)


def kk_mean_as_sum(monkeypatch):
    """The kk neighbor list's messages summed, not averaged (GVPEdgeMessages.nbr
    runs the kk alone on this path)."""
    from kpdiff_tpu_torch.models.gvp import GVPEdgeMessages

    nbr = GVPEdgeMessages.nbr

    def summed(self, *args, **kwargs):
        agg, self.agg = self.agg, "sum"
        try:
            return nbr(self, *args, **kwargs)
        finally:
            self.agg = agg

    monkeypatch.setattr(GVPEdgeMessages, "nbr", summed)


FAULTS = dict(faults.GENERATE, kk_edge_dropped=kk_edge_dropped, kk_mean_as_sum=kk_mean_as_sum)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_faults_make_correct_false(tmp_path, monkeypatch, fault):
    spec = tiny_fixed_gvp_spec(tmp_path)
    FAULTS[fault](monkeypatch)
    out = kind().run(spec)
    assert not out["correct"], out["checks"]


def test_control_reads_above_the_program_on_the_cpu(tmp_path):
    """bfloat16 sites: the control (fp8 there) reads the steps well above
    the program, and the program is correct under the card's limit; the
    encoder, which has no weights, reads 0 on both."""
    spec = tiny_fixed_gvp_spec(tmp_path, dtype="bfloat16", seconds=0.5)
    out, recs, steps = kind().execute(spec)
    assert out["correct"], out["checks"]
    program = {k: c["value"] for k, c in out["checks"].items()}
    control = kind().readings(spec, recs, steps, control=True)
    assert control["enc_x_rms_A"] == control["enc_h_gap"] == 0 == program["enc_x_rms_A"]
    assert control["step_gap"] > 3 * program["step_gap"] > 0, (control, program)


def test_traced_run_reads_the_slot_shares_on_the_cpu(tmp_path):
    out = kind().run(tiny_fixed_gvp_spec(tmp_path, trace=True, seconds=0.3))
    assert out["correct"]
    assert set(out["metrics"]) == {"kk_slot_use.aa", "kp_slot_use.aa"}
    for m in out["metrics"].values():
        assert 0 < m["value"] <= 100


def test_the_yardstick_is_put_back(tmp_path):
    saved = compare.generate_readings, flops.step_flops, model_fixed.load_fixed_reference
    kind().run(tiny_fixed_gvp_spec(tmp_path))
    assert (compare.generate_readings, flops.step_flops, model_fixed.load_fixed_reference) == saved


def test_count_holds_the_one_hot_keypoint_encoder():
    """The keypoint encoder maps the 10-wide element one-hot and t (11, as
    the archive's dynamics.kp_enc.kernel) to 256 on every keypoint, not a
    learned encoder's 128 scalars; the rest is flops.gvp_step_flops'."""
    from portbench.reference.model import read_archive

    config = harness.read_json(harness.BENCH_DIR / "configs" / "gvp_all_atom.json")
    model = config["model"]
    counts = dict(n_lig=32 * 20, n_kp=32 * 300, ll_pairs=32 * 20 * 6, kl_pairs=32 * 300 * 7, kk_pairs=32 * 300 * 6)
    learned = flops.gvp_step_flops(model, **counts)  # reads rec_encoder_gvp.out_scalar_size, 128
    assert flops_fixed_gvp.step_flops(model, **counts) - learned == 32 * 300 * 2 * (11 - 129) * 256
    assert read_archive(harness.ROOT / config["weights"])["dynamics.kp_enc.kernel"].shape == (11, 256)


def _fixed_gvp_cells():
    bench = harness.read_json(BENCH)
    return [w["name"] for w in bench["workloads"]
            if harness.read_json(harness.BENCH_DIR / "traffic" / f"{w['traffic']}.json")["kind"] == KIND]


def test_the_gvp_all_atom_cell_runs_this_kind():
    assert _fixed_gvp_cells() == [WORKLOAD]


@pytest.mark.parametrize("workload", _fixed_gvp_cells())
def test_fixed_gvp_cells_find_their_files(workload):
    """What test_portbench_files.py checks of a cell, for this kind: its
    limits name every reading and the exact ones are 0; the configuration
    is GVP with a fixed encoder; the traffic is the EGNN all-atom cell's
    but for its kind, one chunk a pocket at the configuration's sampling
    batch; its metrics include both slot shares."""
    spec = harness.load_spec(workload, 1, 1.0, False)
    assert kind().run and set(spec.cell["limits"]) == READINGS
    assert all(spec.cell["limits"][k] == 0 for k in ("enc_x_rms_A", "enc_h_gap", "kk_mismatch", "decode_mismatch"))
    model = spec.model_config
    assert model["diffusion"]["rec_encoder_type"] == "fixed" and model["diffusion"]["architecture"] == "gvp"
    egnn = harness.read_json(harness.BENCH_DIR / "traffic" / "eval_aa_b32_k250.json")
    skip = {"kind", "why", "batch_size_why"}
    assert {k: v for k, v in spec.traffic.items() if k not in skip} == {k: v for k, v in egnn.items() if k not in skip}
    assert spec.traffic["n_mols"] == spec.traffic["batch_size"] == model["sampling_config"]["diff_batch_size"]
    assert {"kk_slot_use.aa", "kp_slot_use.aa", "gen_mfu"} <= {m["name"] for m in spec.per_layer}
    assert "edge_kernel_roofline.gen" not in {m["name"] for m in spec.per_layer}
    assert "ligands_per_s" in {m["name"] for m in spec.end_to_end}


@pytest.mark.card
def test_control_fails_the_gvp_all_atom_cell_on_the_card():
    """At the cell's own size: the program reads correct and the control
    (fp8 at the bfloat16 sites) does not, on three seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    harness.set_cache_env()
    for seed in (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303):
        spec = harness.load_spec(WORKLOAD, seed, 3.0, False)
        spec.t_process = time.perf_counter()
        out, recs, steps = kind().execute(spec)
        assert out["correct"], out["checks"]
        control = kind().readings(spec, recs, steps, control=True)
        judged = compare.judge(control, {k: spec.cell["limits"][k] for k in control})
        assert not all(c["value"] <= c["limit"] for c in judged.values()), control
        del recs
        torch.cuda.empty_cache()
