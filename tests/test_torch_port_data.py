"""The port's training data against kpdiff_tpu on the CPU: molgen and the
synthetic generator give the same arrays for the same seed, the padded
loader the same batches in the same order (buckets, fake atoms, drops and
repeat-padded partial batches included), the bucket choice the same
buckets; the pickle reader and the prefetcher. Everything here is numpy on
both sides, so the comparisons are exact."""
import pickle

import numpy as np
import pytest
import torch

from kpdiff_tpu.config import PaddingConfig as JPad
from kpdiff_tpu.data import dataset as jds, molgen as jmolgen
from kpdiff_tpu_torch.config import PaddingConfig as TPad
from kpdiff_tpu_torch.data import dataset as tds, molgen as tmolgen
from kpdiff_tpu_torch.data.prefetch import Prefetcher, prefetch

ELEMENTS = ["C", "N", "O", "S", "P", "F", "Cl", "Br", "I", "B"]
ARRAYS = ("lig_pos", "lig_feat", "rec_pos", "rec_feat", "rec_res_idx", "interface_points", "rec_segments",
          "lig_segments", "ip_segments")
BATCH_FIELDS = ("rec_x", "rec_h", "rec_mask", "rec_res_idx", "lig_x", "lig_h", "lig_mask", "ip_x", "ip_mask",
                "kp_x", "kp_h", "kp_mask")


def _same_dataset(a, b):
    for k in ARRAYS:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), k


def _config(ca_only=False, n_rec=96, n_lig=24):
    return {"dataset": {"lig_elements": ELEMENTS, "ca_only": ca_only},
            "padding": {"n_rec": n_rec, "n_lig": n_lig, "n_ip": 16}, "graph": {"n_keypoints": 6}}


def test_molecule_generator_matches_jax():
    np.testing.assert_array_equal(tmolgen.element_probs(ELEMENTS), jmolgen.element_probs(ELEMENTS))
    for seed, n in ((0, 5), (1, 17), (2, 32)):
        tx, tt = tmolgen.random_molecule(np.random.default_rng(seed), n, ELEMENTS)
        jx, jt = jmolgen.random_molecule(np.random.default_rng(seed), n, ELEMENTS)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(tt, jt)


@pytest.mark.parametrize("ca_only", [False, True])
def test_molgen_splits_match_jax(ca_only):
    cfg = _config(ca_only)
    n_rec_feat = 20 if ca_only else 10
    t_train, t_test = tmolgen.molgen_splits_for_config(cfg, TPad.from_config(cfg), n_rec_feat, 24, 5)
    j_train, j_test = jmolgen.molgen_splits_for_config(cfg, JPad.from_config(cfg), n_rec_feat, 24, 5)
    _same_dataset(t_train, j_train)
    _same_dataset(t_test, j_test)
    np.testing.assert_array_equal(tmolgen.type_counts(t_train), jmolgen.type_counts(j_train))


def test_synthetic_dataset_matches_jax():
    _same_dataset(tds.synthetic_dataset(10, seed=3, rec_range=(20, 60), lig_range=(6, 20)),
                  jds.synthetic_dataset(10, seed=3, rec_range=(20, 60), lig_range=(6, 20)))


@pytest.mark.parametrize("n_lig_pad", [16, 24, 32])
def test_lig_buckets_match_jax(n_lig_pad):
    sizes = np.random.default_rng(n_lig_pad).integers(5, n_lig_pad + 8, size=200)
    assert tds.derive_lig_buckets(sizes, n_lig_pad) == jds.derive_lig_buckets(sizes, n_lig_pad)
    cfg = _config(n_lig=n_lig_pad)
    ds = tmolgen.molgen_splits_for_config(cfg, TPad.from_config(cfg), 10, 32, 0)[0]
    for buckets in ("auto", [8, n_lig_pad], None):
        cfg["padding"]["lig_buckets"] = buckets
        assert tds.resolve_lig_buckets(cfg, ds, n_lig_pad) == jds.resolve_lig_buckets(cfg, ds, n_lig_pad)
    cfg["padding"]["lig_buckets"] = [8, n_lig_pad - 1]
    with pytest.raises(ValueError):
        tds.resolve_lig_buckets(cfg, ds, n_lig_pad)


@pytest.mark.parametrize("drop_last,fake,buckets", [(True, 0.0, [16, 24]), (False, 0.0, [16, 24]),
                                                    (False, 0.3, [16, 24]), (True, 0.0, None)])
def test_padded_loader_batches_match_jax(drop_last, fake, buckets):
    """Two epochs: same batches, same order, same buckets and fake atoms, the
    same complexes dropped (ligands that no bucket fits, fake atoms beyond
    the capacity); the port yields host tensors."""
    cfg = _config(n_lig=24)
    ds = tmolgen.molgen_splits_for_config(cfg, TPad.from_config(cfg), 10, 40, 1)[0]
    pad = dict(n_rec=96, n_lig=24, n_kp=6, n_ip=16)
    kw = dict(batch_size=6, n_kp=6, kp_feat_dim=12, max_fake_atom_frac=fake, seed=4, drop_last=drop_last,
              lig_buckets=buckets)
    tl = tds.PaddedLoader(ds, TPad(**pad), **kw)
    jl = jds.PaddedLoader(ds, JPad(**pad), **kw)
    n_batches = 0
    for _ in range(2):
        tb, jb = list(tl.epoch()), list(jl.epoch())
        assert len(tb) == len(jb) > 0
        for t, j in zip(tb, jb):
            for f in BATCH_FIELDS:
                x = getattr(t, f)
                assert x.device.type == "cpu"
                np.testing.assert_array_equal(x.numpy(), np.asarray(getattr(j, f)), err_msg=f)
            n_batches += 1
    assert tl.n_dropped == jl.n_dropped
    if not drop_last:
        assert any(not t.lig_mask.any(dim=1).all() for t in tb), "no repeat-padded rows"
    if fake:
        assert tl.n_lig_feat == 11 and any((t.lig_h[..., -1] > 0).any() for t in tb)


def test_loader_rejects_mismatched_buckets():
    ds = tds.synthetic_dataset(4, seed=0)
    with pytest.raises(ValueError):
        tds.PaddedLoader(ds, TPad(n_rec=96, n_lig=24), 2, 6, 12, lig_buckets=[8, 16])


def test_complex_dataset_from_pickle(tmp_path):
    """A processed split with torch tensors in it (as the processing CLIs
    write it) reads back as the same numpy arrays in both packages."""
    src = tds.synthetic_dataset(5, seed=2)
    data = {k: torch.from_numpy(getattr(src, k)) for k in ARRAYS}
    data.update(rec_files=[f"r{i}.pdb" for i in range(5)], lig_files=[f"l{i}.sdf" for i in range(5)])
    path = tmp_path / "split.pkl"
    path.write_bytes(pickle.dumps(data))
    got, want = tds.ComplexDataset.from_pickle(path), jds.ComplexDataset.from_pickle(path)
    _same_dataset(got, want)
    assert len(got) == 5 and got.get_files(3) == ("r3.pdb", "l3.sdf")
    for k, v in got.get(2).items():
        np.testing.assert_array_equal(v, want.get(2)[k])
    np.testing.assert_array_equal(tds.lig_sizes(got), jds.lig_sizes(want))


def test_prefetcher_keeps_order_and_raises_producer_errors():
    assert list(prefetch(iter(range(50)), depth=3)) == list(range(50))

    def failing():
        yield 1
        raise ValueError("producer failed")

    it = iter(Prefetcher(failing(), depth=2))
    assert next(it) == 1
    with pytest.raises(ValueError, match="producer failed"):
        next(it)
