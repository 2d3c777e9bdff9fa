"""Pocket extraction, featurization, and interface points (host numpy;
kpdiff_tpu/data/pocket.py).

Numpy re-implementation of the reference's data_processing/pdbbind_processing.py
featurization surface:
  * residue-level pocket extraction with bounding-box prefilter (:85-149)
  * one-hot element featurizers with an 'other' overflow class (:152-213)
  * interface points: lig-rec pair midpoints < threshold, greedily thinned
    to a minimum separation (:295-325)
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np


class Unparsable(Exception):
    pass


class InterfacePointException(Exception):
    def __init__(self, original_exception: Exception, *args):
        super().__init__(*args)
        self.original_exception = original_exception


def make_element_map(elements: List[str]) -> Dict[str, int]:
    m = {el: i for i, el in enumerate(elements)}
    m["other"] = len(elements)
    return m


def onehot_encode_elements(atom_elements: Iterable[str], element_map: Dict[str, int]) -> np.ndarray:
    idxs = np.fromiter(
        (element_map.get(el, element_map["other"]) for el in atom_elements), int
    )
    out = np.zeros((idxs.size, len(element_map)))
    out[np.arange(idxs.size), idxs] = 1
    return out


def featurize_atoms(elements: Iterable[str], element_map: Dict[str, int]) -> Tuple[np.ndarray, np.ndarray]:
    """One-hot features (other column dropped) + mask of 'other' atoms
    (reference rec_atom_featurizer/lig_atom_featurizer :152-198)."""
    onehot = onehot_encode_elements(elements, element_map)
    other_mask = onehot[:, -1] == 1
    return onehot[:, :-1], other_mask


def get_pocket_atoms(
    rec_coords: np.ndarray,  # (R, 3) all receptor atoms (non-water, opt. non-H)
    rec_elements: List[str],
    rec_res_index: np.ndarray,  # (R,) residue index per atom
    lig_coords: np.ndarray,  # (L, 3)
    box_padding: float,
    pocket_cutoff: float,
    element_map: Dict[str, int],
    interface_distance_threshold: float = 5.0,
    interface_exclusion_threshold: float = 2.0,
):
    """Residue-level pocket extraction (reference :85-149).

    Returns (pocket_coords, pocket_features, byres_pocket_mask, interface_points).
    """
    rec_feats, other_mask = featurize_atoms(rec_elements, element_map)
    rec_coords = rec_coords[~other_mask]
    rec_res_index = rec_res_index[~other_mask]
    rec_feats = rec_feats[~other_mask]

    lower = lig_coords.min(0) - box_padding
    upper = lig_coords.max(0) + box_padding
    in_box = ((rec_coords >= lower) & (rec_coords <= upper)).all(axis=1)

    box_coords = rec_coords[in_box]
    box_res = rec_res_index[in_box]
    if box_coords.shape[0] == 0:
        raise Unparsable("no receptor atoms near the ligand bounding box")

    d = np.linalg.norm(box_coords[:, None] - lig_coords[None], axis=-1)
    min_d = d.min(axis=1)
    pocket_res = np.unique(box_res[min_d < pocket_cutoff])
    byres_mask = np.isin(rec_res_index, pocket_res)

    pocket_coords = rec_coords[byres_mask]
    pocket_feats = rec_feats[byres_mask]
    if pocket_coords.shape[0] == 0:
        raise Unparsable("empty pocket")

    try:
        interface_points = get_interface_points(
            lig_coords, box_coords, dist_mat=d.T,
            distance_threshold=interface_distance_threshold,
            exclusion_threshold=interface_exclusion_threshold,
        )
    except Exception as e:  # mirror the reference's exception taxonomy (:140-147)
        raise InterfacePointException(e)

    return pocket_coords, pocket_feats, byres_mask, interface_points


def get_interface_points(
    lig_coords: np.ndarray,
    rec_coords: np.ndarray,
    dist_mat: np.ndarray = None,
    distance_threshold: float = 5.0,
    exclusion_threshold: float = 2.0,
) -> np.ndarray:
    """Greedy thinning of lig-rec midpoints (reference :295-325)."""
    if dist_mat is None:
        dist_mat = np.linalg.norm(lig_coords[:, None] - rec_coords[None], axis=-1)
    assert dist_mat.shape[0] == lig_coords.shape[0]
    li, ri = np.where(dist_mat < distance_threshold)
    if li.size == 0:
        raise ValueError("no interface contacts under the distance threshold")
    pts = (lig_coords[li] + rec_coords[ri]) / 2

    selected = [0]
    for i in range(1, pts.shape[0]):
        d = np.linalg.norm(pts[selected] - pts[i][None], axis=-1)
        if np.all(d >= exclusion_threshold):
            selected.append(i)
    return pts[selected]
