"""The traffic is the same for the same seed, and the bucket order follows the weights."""
import numpy as np
import pytest

from portbench import harness
from portbench.traffic import generate

TRAFFIC = harness.read_json(harness.BENCH_DIR / "traffic" / "eval_ref_k250.json")
MODEL = harness.read_json(harness.BENCH_DIR / "configs" / "egnn_40kp.json")["model"]


def small(**kw):
    return dict(TRAFFIC, **{"pockets": 6, **kw})


def test_every_run_the_same_pockets():
    a = generate.make_pockets(small(), MODEL)
    b = generate.make_pockets(small(), MODEL)
    for p, q in zip(a, b):
        for k in ("rec_pos", "rec_feat", "interface_points", "lig_pos"):
            np.testing.assert_array_equal(p[k], q[k])


def test_pool_seed_draws_the_pockets_not_their_sizes():
    a = generate.make_pockets(small(), MODEL)
    b = generate.make_pockets(small(pool_seed=7), MODEL)
    assert [(p["bucket"], p["n_lig"]) for p in a] == [(p["bucket"], p["n_lig"]) for p in b]
    assert any(p["rec_pos"].shape != q["rec_pos"].shape or not np.array_equal(p["rec_pos"], q["rec_pos"])
               for p, q in zip(a, b))


def test_sizes_follow_their_bucket_lists():
    lo = {16: MODEL["dataset"]["min_ligand_atoms"], 32: 17, 48: 33}
    taken = {}
    for p in generate.make_pockets(small(pockets=24), MODEL):
        sizes = TRAFFIC["ligand_atoms"][str(p["bucket"])]
        k = taken.setdefault(p["bucket"], 0)
        assert p["n_lig"] == sizes[k % len(sizes)] and len(p["lig_pos"]) == p["n_lig"]
        taken[p["bucket"]] = k + 1
        assert lo[p["bucket"]] <= p["n_lig"] <= p["bucket"]
        assert TRAFFIC["rec_atoms"][0] <= len(p["rec_pos"]) <= TRAFFIC["rec_atoms"][1]
        np.testing.assert_allclose(p["init_com"], p["lig_pos"].mean(0))


@pytest.mark.parametrize("n", [20, 100, 1000])
def test_bucket_order_follows_the_weights(n):
    w = TRAFFIC["bucket_weights"]
    order = generate.bucket_order(w, n)
    for i, wi in enumerate(w):
        assert abs(order.count(i) - n * wi / sum(w)) <= 1.0


def test_bucket_order_is_fixed_and_mixed_early():
    order = generate.bucket_order(TRAFFIC["bucket_weights"], 24)
    assert order == generate.bucket_order(TRAFFIC["bucket_weights"], 24)
    assert set(order[:3]) == {0, 1}
    assert 2 in order


def test_checked_steps_hold_the_ends():
    steps = generate.check_steps(250, 7, 4)
    assert steps[0] == 0 and steps[-1] == 249 and len(steps) == 4
    assert steps == generate.check_steps(250, 7, 4)
