"""The yardstick's counters against hand-worked shapes and PERF.md's bound."""
import pytest

from portbench import flops

H100 = {"bf16_flops_per_s": 989e12, "f32_flops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12}


def test_peaks_table_names_the_h100():
    assert flops.peaks("NVIDIA H100 80GB HBM3") == H100
    assert flops.peaks("cpu") is None


def test_kk40_bound_matches_perf_md():
    # PERF.md's kernel table: flagship kk40 at B=128, every pair but the self pairs active: 0.0533 ms
    t = flops.edge_kernel_bound_s(128, 40, 40, 257, 128 * 40 * 39, H100)
    assert t * 1e3 == pytest.approx(0.0533, abs=5e-5)


def test_bound_is_the_larger_of_bytes_and_operations():
    ops = 10 * 2 * 2 * 8 * 8 / H100["bf16_flops_per_s"]
    t = flops.edge_kernel_bound_s(1, 4, 4, 8, 10, H100)
    assert t >= ops
    # no active pairs: the bytes alone
    rows = 2 * 1 * 8 * 8 * 2
    weights = 2 * 8 * 8 * 2 + 9 * 8 * 4
    coords = 8 * 3 * 4 + 16
    out = 4 * 11 * 4
    assert flops.edge_kernel_bound_s(1, 4, 4, 8, 0, H100) == pytest.approx(
        (rows + weights + coords + out) / H100["hbm_bytes_per_s"])


def test_egnn_pair_and_node_counts_by_hand():
    h = 3
    assert flops.egnn_pair_flops(h) == 2 * 2 * 9 + 6 + 6 + 12
    assert flops.egnn_node_first_flops(2, 3) == 24


def test_gvp_by_hand():
    # Wh (2 -> 2 channels, 3 components), Wu (2 -> 1), scalars [1 + 2] -> 4, gates 4 -> 1
    assert flops.gvp_flops(2, 1, 1, 4) == 2 * 3 * 2 * 2 + 2 * 3 * 2 * 1 + 2 * 3 * 4 + 2 * 4 * 1


def _model(arch):
    from portbench import harness

    name = "egnn_40kp" if arch == "egnn" else "gvp_40kp"
    return harness.read_json(harness.BENCH_DIR / "configs" / f"{name}.json")["model"]


@pytest.mark.parametrize("arch", ["egnn", "gvp"])
def test_step_flops_grow_with_pairs(arch):
    model = _model(arch)
    base = dict(n_lig=128 * 20, n_kp=128 * 40, ll_pairs=0, kl_pairs=128 * 40 * 5, kk_pairs=0)
    f0 = flops.step_flops(model, **base)
    f1 = flops.step_flops(model, **dict(base, ll_pairs=1000))
    f2 = flops.step_flops(model, **dict(base, kk_pairs=1000))
    assert 0 < f0 < f1 and f0 < f2


def test_egnn_step_holds_its_dense_edges():
    # 6 layers x (ll32 + kk40, every pair but the self pairs) x the two H x H second layers at B=128
    model = _model("egnn")
    pairs = 128 * (32 * 31 + 40 * 39)
    dense = 6 * pairs * 2 * 2 * 257 ** 2
    assert dense == pytest.approx(517.8e9, rel=1e-3)
    f = flops.step_flops(model, n_lig=128 * 32, n_kp=128 * 40, ll_pairs=128 * 32 * 31, kl_pairs=128 * 40 * 5,
                         kk_pairs=128 * 40 * 39)
    assert f > dense
