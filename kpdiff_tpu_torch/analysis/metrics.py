"""Molecule-quality metrics (kpdiff_tpu/analysis/metrics.py; reference
analysis/metrics.py:36-333).

First-party metrics (always available): atom-type KL divergence, atom
valency validity, largest-fragment fraction, validity, connectivity,
uniqueness, novelty — and, since round 4, the full property surface (QED,
SA, logP, Lipinski, Tanimoto diversity — reference MoleculeProperties
:239-333) via the first-party calculators in analysis/chem_props.py when
rdkit is absent. With rdkit importable the rdkit implementations are
preferred (exact reference semantics); `props_backend` records which ran.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from kpdiff_tpu_torch.analysis.molecule_builder import (
    HAVE_RDKIT,
    BuiltMolecule,
    build_molecule,
    canonical_key,
    fragments,
    max_valence,
    to_rdkit,
)


def atom_type_counts(mols: Sequence[BuiltMolecule], element_list: List[str]) -> np.ndarray:
    idx = {e: i for i, e in enumerate(element_list)}
    counts = np.zeros(len(element_list))
    for m in mols:
        for e in m.elements:
            if e in idx:
                counts[idx[e]] += 1
    return counts


def atom_type_kl(gen_counts: np.ndarray, train_counts: np.ndarray, eps: float = 1e-10) -> float:
    """KL(gen || train) over atom-type distributions (reference
    LigandTypeDistribution, metrics.py:211-236)."""
    p = gen_counts / max(gen_counts.sum(), 1)
    q = np.asarray(train_counts, float)
    q = q / max(q.sum(), 1)
    return float(np.sum(p * (np.log(p + eps) - np.log(q + eps))))


def atom_valency_validity(mols: Sequence[BuiltMolecule]) -> float:
    """Fraction of atoms whose bond count is within the allowed_bonds table
    (reference metrics.py:156-206)."""
    ok, total = 0, 0
    for m in mols:
        deg = m.degree()
        for i, e in enumerate(m.elements):
            total += 1
            if deg[i] <= max_valence(e):
                ok += 1
    return ok / max(total, 1)


def evaluate_samples(
    positions: List[np.ndarray],
    element_lists: List[List[str]],
    train_keys: Optional[set] = None,
    train_type_counts: Optional[np.ndarray] = None,
    element_list: Optional[List[str]] = None,
) -> Dict[str, object]:
    """ModelAnalyzer.sample_and_analyze-equivalent metric block
    (reference metrics.py:36-206), over already-sampled atom clouds."""
    n = len(positions)
    raw = [build_molecule(p, e, largest_frag=False, sanitize=False) for p, e in zip(positions, element_lists)]
    raw = [m for m in raw if m is not None]

    frag_fracs = []
    connected = 0
    for m in raw:
        frags = fragments(m.n_atoms, m.bonds)
        frac = len(frags[0]) / m.n_atoms if frags else 0.0
        frag_fracs.append(frac)
        if frac >= 0.5:
            connected += 1

    built = [build_molecule(p, e, largest_frag=True, sanitize=True) for p, e in zip(positions, element_lists)]
    valid = [m for m in built if m is not None]

    keys = [canonical_key(m) for m in valid]
    unique = len(set(keys))

    out: Dict[str, object] = {
        "n_sampled": n,
        "validity": len(valid) / max(n, 1),
        "connectivity": connected / max(len(raw), 1),
        "avg_frag_frac": float(np.mean(frag_fracs)) if frag_fracs else 0.0,
        "atom_validity": atom_valency_validity(raw),
        "uniqueness": unique / max(len(valid), 1),
    }
    if train_keys is not None:
        novel = sum(1 for k in set(keys) if k not in train_keys)
        out["novelty"] = novel / max(unique, 1)
    if train_type_counts is not None and element_list is not None:
        gen_counts = atom_type_counts(raw, element_list)
        out["atom_type_kl"] = atom_type_kl(gen_counts, train_type_counts)
    props = molecule_properties(valid)
    out.update(props)
    return out


def molecule_properties(mols: Sequence[BuiltMolecule]) -> Dict[str, Optional[float]]:
    """QED / SA / logP / Lipinski / pairwise Tanimoto diversity
    (reference MoleculeProperties.evaluate, metrics.py:239-333).

    With rdkit importable the rdkit implementations run (exact reference
    semantics); otherwise the first-party calculators in
    analysis/chem_props.py provide the full quality surface (published
    QED/Wildman-Crippen/Ertl algorithms on the first-party bond graph —
    see that module's docstring for the documented deviations). The
    `props_backend` key records which path produced the numbers."""
    if not mols:
        return {"qed": None, "sa": None, "logp": None, "lipinski": None, "diversity": None,
                "props_backend": None}
    if not HAVE_RDKIT:
        from kpdiff_tpu_torch.analysis.chem_props import first_party_properties

        out = first_party_properties(mols)
        out["props_backend"] = "first_party"
        return out
    from rdkit.Chem import Crippen, Descriptors, QED  # type: ignore
    from rdkit import Chem, DataStructs  # type: ignore
    from rdkit.Chem import AllChem  # type: ignore

    from kpdiff_tpu_torch.analysis.sa_score import calculate_sa_score

    qeds, sas, logps, lips, fps = [], [], [], [], []
    for m in mols:
        r = to_rdkit(m)
        if r is None:
            continue
        try:
            Chem.SanitizeMol(r)
        except Exception:
            continue
        qeds.append(QED.qed(r))
        sa = calculate_sa_score(r)
        if sa is not None:
            sas.append(round((10 - sa) / 9, 2))  # reference normalization (metrics.py:300-308)
        logps.append(Crippen.MolLogP(r))
        rule_1 = Descriptors.ExactMolWt(r) < 500
        rule_2 = Chem.Lipinski.NumHDonors(r) <= 5
        rule_3 = Chem.Lipinski.NumHAcceptors(r) <= 10
        rule_4 = -2 <= Crippen.MolLogP(r) <= 5
        rule_5 = Chem.rdMolDescriptors.CalcNumRotatableBonds(r) <= 10
        lips.append(sum([rule_1, rule_2, rule_3, rule_4, rule_5]))
        fps.append(AllChem.GetMorganFingerprintAsBitVect(r, 2, nBits=2048))

    div = None
    if len(fps) > 1:
        sims = []
        for i in range(len(fps)):
            for j in range(i + 1, len(fps)):
                sims.append(DataStructs.TanimotoSimilarity(fps[i], fps[j]))
        div = 1 - float(np.mean(sims))

    def _mean(x):
        return float(np.mean(x)) if x else None

    return {"qed": _mean(qeds), "sa": _mean(sas), "logp": _mean(logps), "lipinski": _mean(lips),
            "diversity": div, "props_backend": "rdkit"}
