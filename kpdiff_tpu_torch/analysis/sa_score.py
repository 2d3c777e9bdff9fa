"""Synthetic accessibility score (kpdiff_tpu/analysis/sa_score.py; Ertl &
Schuffenhauer, J. Cheminf. 1:8, 2009, with the RDKit-contrib v1.1
modifications).

The reference vendors RDKit-contrib's sascorer + its fpscores fragment
table (analysis/SA_Score/sascorer.py + fpscores.pkl.gz). Here the full
published algorithm — fragment score from the fpscores table + complexity
penalties + the fingerprint-density correction — is implemented first-
party; the fragment table (public RDKit-contrib data — every rdkit
install ships it under RDContribDir/SA_Score) is located from the rdkit
contrib dir or the candidate paths below; drop a copy into
analysis/data/ to pin a specific table.

RDKit is still required for the fragment term: the fpscores table is keyed
by RDKit's Morgan-fingerprint bit hashes, which are internal to RDKit's
hashing and cannot be reproduced (or validated) without it. Without rdkit
calculate_sa_score returns None; with rdkit but no locatable fpscores
table, a fragment-free approximation runs (documented deviation; those
values are NOT comparable to the paper's scale).
"""
from __future__ import annotations

import gzip
import math
import os
import pickle
from typing import Optional

try:
    from rdkit import Chem  # type: ignore

    HAVE_RDKIT = True
except ImportError:
    HAVE_RDKIT = False

_fscores = None  # bitId -> fragment score
FPSCORES_CANDIDATES = (
    os.path.join(os.path.dirname(__file__), "data", "fpscores.pkl.gz"),
)


def load_fragment_scores(path: Optional[str] = None) -> Optional[dict]:
    """Load the public fpscores fragment table (list of [score, *bitIds])
    into a bitId -> score dict. Searches FPSCORES_CANDIDATES plus the
    rdkit contrib dir; returns None when no table is found.

    An explicit `path` bypasses (and refreshes) the module cache; only
    default lookups are cached, and a failed explicit path does not poison
    the cache."""
    global _fscores
    if path is None and _fscores is not None:
        return _fscores or None

    candidates = [path] if path else list(FPSCORES_CANDIDATES)
    if not path and HAVE_RDKIT:
        try:
            from rdkit.Chem import RDConfig  # type: ignore

            candidates.append(os.path.join(RDConfig.RDContribDir, "SA_Score", "fpscores.pkl.gz"))
        except Exception:
            pass
    for cand in candidates:
        if cand and os.path.exists(cand):
            with gzip.open(cand) as f:
                data = pickle.load(f)
            table = {}
            for row in data:
                for bit in row[1:]:
                    table[bit] = float(row[0])
            _fscores = table
            return table
    if path is None:
        _fscores = False
    return None


def calculate_sa_score(mol) -> Optional[float]:
    """SA score in [1, 10] (lower = easier to synthesize)."""
    if not HAVE_RDKIT:
        return None
    table = load_fragment_scores()
    if table is not None:
        try:
            return _full_sa(mol, table)
        except Exception:
            return None
    return _approx_sa(mol)


def _complexity_terms(mol):
    """(score2 complexity penalty, nAtoms) — shared by full and approx."""
    from rdkit.Chem import rdMolDescriptors  # type: ignore

    n_atoms = mol.GetNumAtoms()
    ri = mol.GetRingInfo()
    n_chiral = len(Chem.FindMolChiralCenters(mol, includeUnassigned=True))
    n_spiro = rdMolDescriptors.CalcNumSpiroAtoms(mol)
    n_bridge = rdMolDescriptors.CalcNumBridgeheadAtoms(mol)
    n_macro = sum(1 for r in ri.AtomRings() if len(r) > 8)

    size_penalty = n_atoms**1.005 - n_atoms
    stereo_penalty = math.log10(n_chiral + 1)
    spiro_penalty = math.log10(n_spiro + 1)
    bridge_penalty = math.log10(n_bridge + 1)
    # the contrib scorer's macrocycle form (log10(2) for any, not per-ring)
    macro_penalty = math.log10(2) if n_macro > 0 else 0.0
    score2 = -(size_penalty + stereo_penalty + spiro_penalty + bridge_penalty + macro_penalty)
    return score2, n_atoms


def _full_sa(mol, table: dict) -> float:
    """Published algorithm: mean fragment score (-4 for unknown fragments)
    + complexity penalties + fingerprint-density symmetry correction, mapped
    to [1, 10] with the 8+ smoothing (sascorer.py:56-113 behavior)."""
    from rdkit.Chem import rdMolDescriptors  # type: ignore

    fp = rdMolDescriptors.GetMorganFingerprint(mol, 2)
    counts = fp.GetNonzeroElements()
    nf = sum(counts.values())
    score1 = sum(table.get(bit, -4.0) * v for bit, v in counts.items()) / max(nf, 1)

    score2, n_atoms = _complexity_terms(mol)

    score3 = 0.0
    if n_atoms > len(counts):
        score3 = math.log(float(n_atoms) / len(counts)) * 0.5

    raw = score1 + score2 + score3
    lo, hi = -4.0, 2.5
    sa = 11.0 - (raw - lo + 1.0) / (hi - lo) * 9.0
    if sa > 8.0:
        sa = 8.0 + math.log(sa + 1.0 - 9.0)
    return float(min(max(sa, 1.0), 10.0))


def _approx_sa(mol) -> Optional[float]:
    """Fragment-free fallback when no fpscores table can be located: only
    the complexity terms, rescaled with score1=0. NOT comparable to the
    published scale (the fragment term dominates)."""
    try:
        score2, _ = _complexity_terms(mol)
        raw = score2
        lo, hi = -4.0, 2.5
        sa = 11.0 - (raw - lo + 1.0) / (hi - lo) * 9.0
        if sa > 8.0:
            sa = 8.0 + math.log(sa + 1.0 - 9.0)
        return float(min(max(sa, 1.0), 10.0))
    except Exception:
        return None
