"""The reference agrees with the port at a tiny size on the CPU, and the
comparison sees each fault a generate cell can have planted under a whole
run of the harness (the look for a card skipped: the CPU stand-ins)."""
import pytest

from portbench import faults, harness
from portbench.tests.util import tiny_spec, tiny_train_spec


def run(spec):
    return harness.kind_module("generate").run(spec)


@pytest.mark.parametrize("arch", ["egnn", "gvp"])
def test_reference_agrees_with_the_port(tmp_path, arch):
    out = run(tiny_spec(tmp_path, arch, seconds=0.5))
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 4
    c = out["checks"]
    assert c["kk_mismatch"]["value"] == 0 and c["decode_mismatch"]["value"] == 0
    for name in ("enc_x_rms_A", "enc_h_gap", "step_gap"):
        assert c[name]["value"] < 1e-4, (name, c[name])


def test_traced_run_reads_the_layers_it_can_on_the_cpu(tmp_path):
    out = run(tiny_spec(tmp_path, "egnn", trace=True, seconds=0.5))
    assert out["correct"]
    assert {"serve_host_ms.gen", "encode_ms.gen", "chain_step_ms.gen"} <= set(out["metrics"])
    assert "gen_mfu" not in out["metrics"]  # no peak for the CPU


@pytest.mark.parametrize("fault", sorted(faults.GENERATE))
@pytest.mark.parametrize("arch", ["egnn", "gvp"])
def test_faults_make_correct_false(tmp_path, monkeypatch, fault, arch):
    spec = tiny_spec(tmp_path, arch, seconds=0.0)
    faults.GENERATE[fault](monkeypatch)
    out = run(spec)
    assert not out["correct"], out["checks"]


def test_train_reference_agrees_with_the_port(tmp_path):
    out = harness.kind_module("train").run(tiny_train_spec(tmp_path, seconds=0.5))
    assert out["correct"] and out["attempted"] >= 1
    c = out["checks"]
    assert c["loss_gap"]["value"] < 1e-5 and c["grad_gap"]["value"] < 1e-4 and c["update_gap"]["value"] < 1e-3, c


def test_train_traced_run_reads_its_data_layer(tmp_path):
    out = harness.kind_module("train").run(tiny_train_spec(tmp_path, trace=True, seconds=0.3))
    assert out["correct"] and "data_wait_ms.train" in out["metrics"]


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_train_faults_make_correct_false(tmp_path, monkeypatch, fault):
    spec = tiny_train_spec(tmp_path)
    faults.TRAIN[fault](monkeypatch)
    out = harness.kind_module("train").run(spec)
    assert not out["correct"], out["checks"]


def test_a_step_that_keeps_its_state_reads_one(tmp_path, monkeypatch):
    from kpdiff_tpu_torch.training.trainer import Adam

    monkeypatch.setattr(Adam, "update", lambda self, lr, finite: None)
    out = harness.kind_module("train").run(tiny_train_spec(tmp_path))
    assert out["checks"]["update_gap"]["value"] == pytest.approx(1.0, abs=0.05) and not out["correct"]
