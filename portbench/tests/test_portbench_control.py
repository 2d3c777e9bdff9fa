"""The control (the reference in fp8 at the configuration's bfloat16 sites)
comes out as not correct where the program does, at a size a test run holds
on the CPU, and at the cell's own size on the card (marked `card`)."""
import pytest

from portbench import compare, harness
from portbench.tests.util import tiny_spec, tiny_train_spec


def _judge(readings, limits):
    return all(c["value"] <= c["limit"] for c in compare.judge(readings, limits).values())


@pytest.mark.parametrize("arch", ["egnn", "gvp"])
def test_control_reads_above_the_program_on_the_cpu(tmp_path, arch):
    spec = tiny_spec(tmp_path, arch, dtype="bfloat16", seconds=0.5)
    out, recs, steps = harness.kind_module("generate").execute(spec)
    program = {k: c["value"] for k, c in out["checks"].items()}
    control = compare.generate_readings(spec, recs, steps, control=True)
    ratios = {k: control[k] / max(program[k], 1e-30) for k in control}
    assert all(r > 1 for r in ratios.values()) and max(ratios.values()) > 3, ratios


def test_train_control_reads_above_the_program_on_the_cpu(tmp_path):
    spec = tiny_train_spec(tmp_path, dtype="bfloat16")
    out, record, _ = harness.kind_module("train").execute(spec)
    program = {k: c["value"] for k, c in out["checks"].items()}
    control = compare.train_readings(spec, record, control=True)
    assert control["grad_gap"] > 3 * program["grad_gap"]


@pytest.mark.card
@pytest.mark.parametrize("workload", ["egnn40kp.generate", "gvp40kp.generate", "egnn40kp.train"])
def test_control_fails_the_cell_on_the_card(workload):
    import time

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    harness.set_cache_env()
    for seed in (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303):
        spec = harness.load_spec(workload, seed, 3.0, False)
        spec.t_process = time.perf_counter()
        out, recs, steps = harness.kind_module(spec.traffic["kind"]).execute(spec)
        assert out["correct"], out["checks"]
        control = (compare.train_readings(spec, recs, control=True) if spec.traffic["kind"] == "train"
                   else compare.generate_readings(spec, recs, steps, control=True))
        limits = {k: spec.cell["limits"][k] for k in control}
        assert not _judge(control, limits), control
