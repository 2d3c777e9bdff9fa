"""Ligand size distribution: #ligand atoms conditioned on #pocket atoms
(kpdiff_tpu/models/size_dist.py; a missing histogram raises
FileNotFoundError, where the JAX package raises ValueError).

Reads the reference's train_n_node_joint_dist.pkl artifact (a gaussian-
smoothed joint histogram with rec/lig size bounds — reference
models/n_nodes_dist.py:6-60 and process_bindingmoad.py:217-270) and
samples ligand sizes with numpy on host.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np


class LigandSizeDistribution:
    def __init__(self, processed_dataset_dir: str | Path):
        f = Path(processed_dataset_dir) / "train_n_node_joint_dist.pkl"
        if not f.exists():
            raise FileNotFoundError(f"joint distribution file {f} does not exist; build it with "
                                    "build_joint_histogram + save_joint_histogram")
        with open(f, "rb") as fh:
            joint_histogram, rec_bounds, lig_bounds = pickle.load(fh)
        self.joint = np.asarray(joint_histogram, np.float64)
        self.rec_bounds = (int(rec_bounds[0]), int(rec_bounds[1]))
        self.lig_bounds = (int(lig_bounds[0]), int(lig_bounds[1]))

    def sample(self, n_nodes_rec: np.ndarray, n_replicates: int, rng: np.random.Generator = None) -> np.ndarray:
        """(R,) pocket sizes -> (R, n_replicates) ligand sizes. Out-of-range
        pocket sizes are clamped with a warning (n_nodes_dist.py:44-56)."""
        rng = rng or np.random.default_rng()
        n_nodes_rec = np.asarray(n_nodes_rec, int).copy()
        lo, hi = self.rec_bounds
        clamped = np.clip(n_nodes_rec, lo, hi)
        for orig, new in zip(n_nodes_rec, clamped):
            if orig != new:
                print(f"WARNING: receptor size {orig} outside training range {self.rec_bounds}; using {new}")
        rows = self.joint[clamped - lo]
        rows = rows / rows.sum(axis=1, keepdims=True)
        out = np.empty((len(rows), n_replicates), int)
        for i, p in enumerate(rows):
            out[i] = rng.choice(len(p), size=n_replicates, p=p) + self.lig_bounds[0]
        return out


def build_joint_histogram(rec_sizes, lig_sizes, sigma: float = 1.0):
    """Build the smoothed joint histogram artifact from raw size pairs
    (reference process_bindingmoad.py:217-270 get_n_nodes_dist)."""
    from scipy.ndimage import gaussian_filter

    rec_sizes = np.asarray(rec_sizes, int)
    lig_sizes = np.asarray(lig_sizes, int)
    rec_bounds = (rec_sizes.min(), rec_sizes.max())
    lig_bounds = (lig_sizes.min(), lig_sizes.max())
    hist = np.zeros((rec_bounds[1] - rec_bounds[0] + 1, lig_bounds[1] - lig_bounds[0] + 1))
    for r, l in zip(rec_sizes, lig_sizes):
        hist[r - rec_bounds[0], l - lig_bounds[0]] += 1
    hist = gaussian_filter(hist, sigma=sigma)
    return hist, rec_bounds, lig_bounds


def save_joint_histogram(path: str | Path, hist, rec_bounds, lig_bounds):
    with open(path, "wb") as f:
        pickle.dump((hist, rec_bounds, lig_bounds), f)


def save_dataset_histogram(dataset, out_dir: str | Path, sigma: float = 1.0) -> Path:
    """train_n_node_joint_dist.pkl of a split (pocket atoms, ligand atoms per
    complex, from its segment pointers) in `out_dir`, where
    LigandSizeDistribution(out_dir) reads it."""
    rec = np.diff(dataset.rec_segments)
    lig = np.diff(dataset.lig_segments)
    path = Path(out_dir) / "train_n_node_joint_dist.pkl"
    save_joint_histogram(path, *build_joint_histogram(rec, lig, sigma=sigma))
    return path
