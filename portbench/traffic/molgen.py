"""Molecule-like ligands in pockets at protein density: a frozen copy of the
generator in kpdiff_tpu_torch/data/molgen.py (tree molecules with drug-like
element frequencies and bond lengths at covalent-radii sums; a pocket shell
on a jittered grid hugging the ligand), draw for draw, for all-atom pockets.
`complex_of_size` is the body of its `molecular_synthetic_dataset` loop with
the ligand size given instead of drawn.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

# Cordero covalent radii (Å)
COVALENT_RADII: Dict[str, float] = {
    "H": 0.31, "B": 0.84, "C": 0.76, "N": 0.71, "O": 0.66, "F": 0.57,
    "Si": 1.11, "P": 1.07, "S": 1.05, "Cl": 1.02, "As": 1.19, "Se": 1.20,
    "Br": 1.20, "I": 1.39, "Al": 1.21, "Hg": 1.32, "Bi": 1.48,
}

# Heavy-atom degree limits for tree growth: hydrogens are implicit (the
# reference strips them, process_bindingmoad.py remove_hydrogen), so heavy
# degree is below full valence for most elements.
_HEAVY_DEGREE = {
    "C": 4, "N": 3, "O": 2, "S": 2, "P": 4, "F": 1, "Cl": 1, "Br": 1,
    "I": 1, "B": 3,
}

# Drug-like heavy-atom element frequencies (order-independent; renormalized
# over whatever subset the config's lig_elements names).
_ELEMENT_FREQ = {
    "C": 0.712, "N": 0.118, "O": 0.131, "S": 0.016, "P": 0.004,
    "F": 0.009, "Cl": 0.007, "Br": 0.002, "I": 0.0005, "B": 0.0005,
}


def element_probs(element_list: Sequence[str]) -> np.ndarray:
    p = np.array([_ELEMENT_FREQ.get(e, 0.001) for e in element_list], float)
    return p / p.sum()


def random_molecule(
    rng: np.random.Generator,
    n_atoms: int,
    element_list: Sequence[str],
    n_dir_candidates: int = 48,
) -> Tuple[np.ndarray, np.ndarray]:
    """Grow a random tree molecule; returns (coords (n,3) f32, type_idx (n,) i32).

    Placement guarantees every non-bonded pair is separated by more than its
    covalent-bond detection threshold (r_i + r_j + 0.45 + margin), so
    perceive_bonds recovers exactly the constructed tree: the generated
    distribution sits at validity = connectivity = 1.0.
    """
    probs = element_probs(element_list)
    deg_cap = np.array([_HEAVY_DEGREE.get(e, 3) for e in element_list])
    radii = np.array([COVALENT_RADII.get(e, 0.76) for e in element_list])

    # first atom: force a chain-capable element (C if present)
    first = element_list.index("C") if "C" in element_list else int(np.argmax(deg_cap))
    types = [first]
    coords = [np.zeros(3)]
    degree = [0]

    while len(types) < n_atoms:
        # parent: any atom with spare heavy valence, biased toward the frontier
        spare = [i for i in range(len(types)) if degree[i] < deg_cap[types[i]]]
        if not spare:
            break  # fully saturated (possible only for tiny all-terminal draws)
        parent = int(rng.choice(spare[-8:] if rng.random() < 0.7 else spare))

        t_new = int(rng.choice(len(element_list), p=probs))
        if len(types) < n_atoms - 1 and deg_cap[t_new] < 2 and rng.random() < 0.5:
            # keep enough chain capacity: re-draw half the terminal picks
            t_new = first
        bond_len = radii[types[parent]] + radii[t_new] + rng.normal(0.0, 0.02)

        pos_parent = coords[parent]
        others = np.array([c for i, c in enumerate(coords) if i != parent]) if len(coords) > 1 else None
        placed = False
        for _ in range(4):  # candidate rounds
            dirs = rng.normal(size=(n_dir_candidates, 3))
            dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
            cand = pos_parent + dirs * bond_len
            if others is None:
                pick = cand[0]
                placed = True
                break
            d = np.linalg.norm(cand[:, None] - others[None], axis=-1)  # (K, n-1)
            thresh = radii[t_new] + np.array([radii[t] for i, t in enumerate(types) if i != parent]) + 0.55
            ok = (d > thresh[None]).all(axis=1)
            if ok.any():
                # among clash-free candidates prefer the most open placement
                score = np.where(ok, d.min(axis=1), -np.inf)
                pick = cand[int(np.argmax(score))]
                placed = True
                break
        if not placed:
            degree[parent] = deg_cap[types[parent]]  # crowded site: retire it
            continue
        coords.append(pick)
        types.append(t_new)
        degree.append(1)
        degree[parent] += 1

    x = np.asarray(coords, np.float32)
    x -= x.mean(0, keepdims=True)
    return x, np.asarray(types, np.int32)


def complex_of_size(rng: np.random.Generator, n_lig: int, lig_elements: Sequence[str], n_rec_feat: int,
                    rec_range: Tuple[int, int] = (192, 384), min_sep: float = 1.8) -> Dict[str, np.ndarray]:
    """One ligand of (up to) n_lig atoms in its pocket: lig_pos, lig_feat
    (one-hot), rec_pos, rec_feat (C/N/O/S one-hot), rec_res_idx, interface_points."""
    rec_probs = element_probs([e for e in ("C", "N", "O", "S")])  # protein heavy atoms
    x, t = random_molecule(rng, n_lig, lig_elements)
    n_lig = len(t)
    h = np.zeros((n_lig, len(lig_elements)), np.float32)
    h[np.arange(n_lig), t] = 1.0

    # pocket shell: jittered grid at protein density, band hugging the ligand
    r_lig = float(np.linalg.norm(x, axis=1).max()) if n_lig else 0.0
    lo_r, hi_r = r_lig + 1.5, r_lig + 7.0
    n_rec = int(rng.integers(rec_range[0], rec_range[1] + 1))
    axis = np.arange(-hi_r, hi_r, min_sep)
    gx, gy, gz = np.meshgrid(axis, axis, axis, indexing="ij")
    centers = np.stack([gx, gy, gz], -1).reshape(-1, 3)
    rnorm = np.linalg.norm(centers, axis=1)
    centers = centers[(rnorm > lo_r) & (rnorm < hi_r)]
    take = rng.choice(len(centers), size=min(n_rec, len(centers)), replace=False)
    rx = (centers[take] + rng.uniform(-0.3, 0.3, (len(take), 3)) * min_sep).astype(np.float32)
    n_rec = len(rx)
    rh = np.zeros((n_rec, n_rec_feat), np.float32)
    ridx = rng.choice(4, size=n_rec, p=rec_probs)
    rh[np.arange(n_rec), np.minimum(ridx, n_rec_feat - 1)] = 1.0

    n_ip = max(n_lig // 2, 2)
    li = rng.integers(0, n_lig, size=n_ip)
    d = np.linalg.norm(rx[None] - x[li][:, None], axis=-1)
    ri = d.argmin(1)
    ip = ((x[li] + rx[ri]) / 2).astype(np.float32)
    res_idx = np.sort(rng.integers(0, max(n_rec // 4, 1), size=n_rec)).astype(np.int32)
    return dict(lig_pos=x, lig_feat=h, rec_pos=rx, rec_feat=rh, rec_res_idx=res_idx, interface_points=ip)
