"""First-party molecular property calculators (kpdiff_tpu/analysis/chem_props.py): QED, Wildman-Crippen logP,
Lipinski rule-of-five, TPSA, rotatable bonds, Morgan-style fingerprints and
Tanimoto diversity — computable WITHOUT rdkit.

The reference computes these through rdkit (analysis/metrics.py:239-333:
QED.qed, Crippen.MolLogP, Lipinski counts, GetMorganFingerprintAsBitVect +
TanimotoSimilarity). This environment has no rdkit, and the generated
molecules the analyzer sees are heavy-atom clouds with first-party
single-bond perception (molecule_builder.perceive_bonds) — so the
implementations here operate on that graph representation directly:

  * implicit hydrogens from default valences (aromatic atoms donate one
    valence to the ring pi system; 5-ring pi-donor heteroatom excepted);
  * aromaticity perceived GEOMETRICALLY: 5/6-rings of sp2-compatible
    C/N/O/S atoms that are planar in the sampled 3D coordinates (the
    geometry is real — these are 3D generative samples);
  * QED: Bickerton et al., Nature Chemistry 4:90 (2012) — the 8
    desirability functions with the published ADS parameter table and
    mean weights;
  * logP: Wildman & Crippen, JCICS 39:868 (1999) atom-contribution method,
    reduced to the atom types reachable on an order-less graph (carbonyls
    etc. are not perceivable without bond orders). Anchor values verified
    against known MolLogP outputs: ethanol -0.0014, benzene 1.6866,
    phenol 1.3922, aniline 1.2688 reproduce exactly;
  * TPSA: Ertl, Rohde & Selzer, J. Med. Chem. 43:3714 (2000) N/O
    contributions (the rdkit default also excludes S/P);
  * structural alerts: the subset of the Brenk/QED alert list expressible
    without bond orders (peroxide, hydrazine, disulfide, het-halogen,
    3-membered heterocycles, phosphorus) — a documented under-count;
  * fingerprints: ECFP-style circular environments (radius 2, folded to
    2048 bits) with a stable blake2 hash. The bit positions differ from
    rdkit's Morgan bits, but Tanimoto similarity between two molecules is
    computed in the SAME fingerprint space, so the diversity statistic is
    comparable in distribution.

With rdkit importable, metrics.molecule_properties still prefers the rdkit
path; equivalence of these first-party values against rdkit on perceivable
(single-bond) molecules is asserted by the rdkit-gated tests in
tests/test_chem_props.py (on the JAX package's copy, which this one equals).
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

import numpy as np

from kpdiff_tpu_torch.analysis.molecule_builder import BuiltMolecule

# ---------------------------------------------------------------------------
# element data

ATOMIC_WEIGHTS: Dict[str, float] = {
    "H": 1.008, "B": 10.811, "C": 12.011, "N": 14.007, "O": 15.999,
    "F": 18.998, "Si": 28.086, "P": 30.974, "S": 32.06, "Cl": 35.453,
    "As": 74.922, "Se": 78.971, "Br": 79.904, "I": 126.904,
}

# default valences for implicit-H completion (organic subset)
DEFAULT_VALENCE: Dict[str, int] = {
    "H": 1, "B": 3, "C": 4, "N": 3, "O": 2, "F": 1, "Si": 4, "P": 3,
    "S": 2, "Cl": 1, "As": 3, "Se": 2, "Br": 1, "I": 1,
}

HALOGENS = {"F", "Cl", "Br", "I"}
HETERO = {"N", "O", "P", "S", "F", "Cl", "Br", "I", "Se", "As", "B", "Si"}


# ---------------------------------------------------------------------------
# graph perception layer


class MolFeatures:
    """Derived graph/geometry features of a BuiltMolecule: neighbor lists,
    rings (simple cycles up to size 8, SSSR-pruned), geometric aromaticity,
    implicit hydrogen counts."""

    #: max out-of-plane deviation (Å) for a ring to count as planar/aromatic.
    #: Generated geometry is noisy; rdkit-built test fixtures are exact.
    PLANARITY_TOL = 0.22

    def __init__(self, mol: BuiltMolecule):
        self.mol = mol
        n = mol.n_atoms
        self.elements = mol.elements
        self.nbrs: List[List[int]] = [[] for _ in range(n)]
        for a, b, _ in mol.bonds:
            self.nbrs[a].append(b)
            self.nbrs[b].append(a)
        self.degree = np.array([len(x) for x in self.nbrs], int)
        self.rings = self._sssr()
        self.ring_bonds: Set[FrozenSet[int]] = set()
        self.ring_atoms: Set[int] = set()
        for r in self.rings:
            self.ring_atoms.update(r)
            for i in range(len(r)):
                self.ring_bonds.add(frozenset((r[i], r[(i + 1) % len(r)])))
        self.aromatic_rings = [r for r in self.rings if self._is_aromatic_ring(r)]
        self.aromatic: Set[int] = set()
        for r in self.aromatic_rings:
            self.aromatic.update(r)
        self.implicit_h = self._implicit_h()

    # -- rings ------------------------------------------------------------
    def _sssr(self, max_size: Optional[int] = None) -> List[List[int]]:
        """Smallest-set-of-smallest-rings approximation: for every bond take
        the shortest alternative path (BFS), keep smallest rings covering the
        cycle space (circuit rank = |E| - |V| + components). No size cap by
        default — macrocycles must be perceived or the macrocycle structural
        alert, the SA macro penalty and ring-bond rotatable exclusion all
        silently miss them (round-4 review finding)."""
        mol = self.mol
        n = mol.n_atoms
        cycles: Dict[FrozenSet[int], List[int]] = {}
        # BFS shortest alternative path for each bond -> smallest ring through it
        for a, b, _ in mol.bonds:
            path = self._shortest_path(a, b, exclude_bond=(a, b),
                                       max_len=(max_size - 1) if max_size else n)
            if path is not None:
                key = frozenset(path)
                if key not in cycles or len(path) < len(cycles[key]):
                    cycles[key] = path
        rings = sorted(cycles.values(), key=len)
        # circuit rank bound
        comps = self._n_components()
        rank = len(mol.bonds) - n + comps
        kept: List[List[int]] = []
        covered: Set[FrozenSet[int]] = set()
        for r in rings:
            edges = {frozenset((r[i], r[(i + 1) % len(r)])) for i in range(len(r))}
            if not edges <= covered:
                kept.append(r)
                covered |= edges
            if len(kept) >= rank:
                break
        return kept

    def _shortest_path(self, src: int, dst: int, exclude_bond: Tuple[int, int],
                       max_len: int) -> Optional[List[int]]:
        """Shortest src→dst path avoiding the (src,dst) bond itself; returns
        the ring atom list [src, ..., dst] or None."""
        from collections import deque

        ex = frozenset(exclude_bond)
        prev = {src: -1}
        q = deque([(src, 0)])
        while q:
            u, d = q.popleft()
            if d >= max_len:
                continue
            for v in self.nbrs[u]:
                if frozenset((u, v)) == ex or v in prev:
                    continue
                prev[v] = u
                if v == dst:
                    path = [v]
                    while path[-1] != src:
                        path.append(prev[path[-1]])
                    return path
                q.append((v, d + 1))
        return None

    def _n_components(self) -> int:
        n = self.mol.n_atoms
        seen: Set[int] = set()
        comps = 0
        for s in range(n):
            if s in seen:
                continue
            comps += 1
            stack = [s]
            while stack:
                u = stack.pop()
                if u in seen:
                    continue
                seen.add(u)
                stack.extend(self.nbrs[u])
        return comps

    # -- aromaticity -------------------------------------------------------
    def _is_aromatic_ring(self, ring: List[int]) -> bool:
        if len(ring) not in (5, 6):
            return False
        for i in ring:
            e = self.elements[i]
            if e not in ("C", "N", "O", "S"):
                return False
            # sp3-saturated atoms (4 heavy neighbors on C, 2 on O/S with a
            # non-ring neighbor) can't be aromatic
            if e == "C" and self.degree[i] > 3:
                return False
            if e in ("O", "S") and self.degree[i] > 2:
                return False
        coords = self.mol.coords[ring]
        center = coords.mean(0)
        x = coords - center
        # best-fit plane normal = smallest singular vector
        _, _, vt = np.linalg.svd(x, full_matrices=False)
        dev = np.abs(x @ vt[-1])
        return bool(dev.max() < self.PLANARITY_TOL)

    # -- implicit hydrogens --------------------------------------------------
    def _implicit_h(self) -> np.ndarray:
        n = self.mol.n_atoms
        h = np.zeros(n, int)
        # per 5-ring, pick the pi-lone-pair donor heteroatom (keeps its full
        # sigma valence): prefer O, then S, then the lowest-index N
        donors: Set[int] = set()
        for r in self.aromatic_rings:
            if len(r) != 5:
                continue
            het = [i for i in r if self.elements[i] != "C"]
            if not het:
                continue
            o = [i for i in het if self.elements[i] == "O"]
            s = [i for i in het if self.elements[i] == "S"]
            donors.add(o[0] if o else (s[0] if s else min(het)))
        for i in range(n):
            val = DEFAULT_VALENCE.get(self.elements[i], 4)
            used = int(self.degree[i])
            if i in self.aromatic and i not in donors:
                used += 1  # one valence in the ring pi system
            h[i] = max(val - used, 0)
        return h

    # -- convenience -------------------------------------------------------
    def is_aromatic(self, i: int) -> bool:
        return i in self.aromatic

    def aromatic_neighbor_count(self, i: int) -> int:
        return sum(1 for j in self.nbrs[i] if j in self.aromatic)


# ---------------------------------------------------------------------------
# scalar descriptors


def mol_weight(f: MolFeatures) -> float:
    w = sum(ATOMIC_WEIGHTS.get(e, 0.0) for e in f.elements)
    w += float(f.implicit_h.sum()) * ATOMIC_WEIGHTS["H"]
    return w


def num_hbd(f: MolFeatures) -> int:
    """Lipinski HBD: N/O atoms carrying at least one H."""
    return sum(1 for i, e in enumerate(f.elements)
               if e in ("N", "O") and f.implicit_h[i] > 0)


def num_hba_lipinski(f: MolFeatures) -> int:
    """Lipinski HBA: raw N+O count (Lipinski's original definition; the
    reference uses Chem.Lipinski.NumHAcceptors which is close on
    carbonyl-free molecules)."""
    return sum(1 for e in f.elements if e in ("N", "O"))


def num_hba_qed(f: MolFeatures) -> int:
    """QED HBA: N/O acceptors — excludes pyrrole-type aromatic N-H and
    amide-style N (not perceivable here), includes pyridine n, ethers,
    hydroxyls, amines."""
    c = 0
    for i, e in enumerate(f.elements):
        if e == "O":
            c += 1
        elif e == "N":
            if f.is_aromatic(i) and f.implicit_h[i] > 0:
                continue  # pyrrole NH: donor, not acceptor
            c += 1
    return c


def tpsa(f: MolFeatures) -> float:
    """Ertl 2000 topological polar surface area, N/O contributions for the
    environments reachable on an order-less graph."""
    out = 0.0
    for i, e in enumerate(f.elements):
        h = int(f.implicit_h[i])
        d = int(f.degree[i])
        if e == "N":
            if f.is_aromatic(i):
                if d >= 3:
                    out += 4.93        # [n](:*)(:*)-*
                elif h >= 1:
                    out += 15.79       # [nH]
                else:
                    out += 12.89       # [n](:*):*
            else:
                in3 = any(len(r) == 3 and i in r for r in f.rings)
                if h == 0:
                    out += 3.01 if in3 else 3.24
                elif h == 1:
                    out += 21.94 if in3 else 12.03
                else:
                    out += 26.02
        elif e == "O":
            if f.is_aromatic(i):
                out += 13.14           # [o]
            elif h >= 1:
                out += 20.23           # [OH]
            else:
                in3 = any(len(r) == 3 and i in r for r in f.rings)
                out += 12.53 if in3 else 9.23
    return out


def num_rotatable_bonds(f: MolFeatures) -> int:
    """Non-ring single bonds between two non-terminal heavy atoms (rdkit's
    non-strict pattern minus the triple-bond exclusion — no triple bonds
    exist on this graph)."""
    c = 0
    for a, b, _ in f.mol.bonds:
        if frozenset((a, b)) in f.ring_bonds:
            continue
        if f.degree[a] >= 2 and f.degree[b] >= 2:
            c += 1
    return c


def num_aromatic_rings(f: MolFeatures) -> int:
    return len(f.aromatic_rings)


def structural_alerts(f: MolFeatures) -> int:
    """Count of matched structural alerts — the Brenk/QED alert subset
    expressible without bond orders (documented under-count vs rdkit's
    full SMARTS list)."""
    n_alerts = 0
    el = f.elements
    # bond-pattern alerts
    seen_oo = seen_nn = seen_ss = seen_hethal = False
    for a, b, _ in f.mol.bonds:
        ea, eb = el[a], el[b]
        pair = {ea, eb}
        if pair == {"O"}:
            seen_oo = True          # peroxide
        elif pair == {"N"}:
            seen_nn = True          # hydrazine-like N-N
        elif pair == {"S"}:
            seen_ss = True          # disulfide
        elif (ea in HALOGENS and eb != "C") or (eb in HALOGENS and ea != "C"):
            seen_hethal = True      # halogen on heteroatom
    n_alerts += seen_oo + seen_nn + seen_ss + seen_hethal
    # three-membered heterocycle (oxirane / aziridine / thiirane)
    if any(len(r) == 3 and any(el[i] in ("N", "O", "S") for i in r) for r in f.rings):
        n_alerts += 1
    # phosphorus (Brenk "Phosphor")
    if any(e == "P" for e in el):
        n_alerts += 1
    # macrocycle (> 8-ring; QED alert list "macrocycle")
    if any(len(r) > 8 for r in f.rings):
        n_alerts += 1
    return n_alerts


# ---------------------------------------------------------------------------
# Wildman-Crippen logP (reduced typing; anchors verified in the docstring)

_CRIPPEN = {
    "C1": 0.1441, "C2": 0.0, "C3": -0.2035, "C4": -0.2051,
    "C8": 0.08452, "C10": -0.0516,
    "C14": 0.0, "C15": 0.2450, "C16": 0.1980, "C17": 0.0,
    "C18": 0.1581, "C19": 0.2955, "C21": 0.1360, "C22": 0.4619,
    "C23": 0.5437, "C24": 0.1893, "CS": 0.08129,
    "N1": -1.0190, "N2": -0.7096, "N3": -1.0270, "N4": -0.5188,
    "N7": -0.3187, "N8": -0.4458, "N11": -0.3239, "N12": -1.1190,
    "NS": -0.4806,
    "O1": 0.1552, "O2": -0.2893, "O3": -0.0684, "O4": -0.4195,
    "OS": -0.1188,
    "F": 0.4202, "Cl": 0.6895, "Br": 0.8456, "I": 0.8857,
    "P": 0.8612, "S1": 0.6482, "S3": 0.6237,
    "H1": 0.1230, "H2": -0.2677, "H3": 0.2142, "HS": 0.1125,
    "X": -0.0025,  # unmatched-element fallback
}


def _carbon_type(f: MolFeatures, i: int) -> str:
    el = f.elements
    nb = f.nbrs[i]
    if f.is_aromatic(i):
        # aromatic carbon, typed by the substituent
        subst = [j for j in nb if not (f.is_aromatic(j) and frozenset((i, j)) in f.ring_bonds)]
        if not subst:
            if f.aromatic_neighbor_count(i) >= 3:
                return "C19"  # bridgehead
            return "C18"      # [cH]
        e = el[subst[0]]
        if e == "C":
            return "C21"
        if e == "N":
            return "C22"
        if e == "O":
            return "C23"
        if e == "S":
            return "C24"
        return {"F": "C14", "Cl": "C15", "Br": "C16", "I": "C17"}.get(e, "CS")
    # aliphatic carbon
    has_het = any(el[j] in HETERO for j in nb)
    has_arom = any(f.is_aromatic(j) for j in nb)
    h = int(f.implicit_h[i])
    if has_het:
        return "C3" if h >= 2 else "C4"
    if has_arom:
        return "C8" if h >= 3 else "C10"
    return "C1" if h >= 2 else "C2"


def _nitrogen_type(f: MolFeatures, i: int) -> str:
    if f.is_aromatic(i):
        return "N12" if f.implicit_h[i] > 0 else "N11"
    h = int(f.implicit_h[i])
    arom_attach = any(f.is_aromatic(j) for j in f.nbrs[i])
    if h >= 2:
        return "N3" if arom_attach else "N1"
    if h == 1:
        return "N4" if arom_attach else "N2"
    return "N8" if arom_attach else "N7"


def _oxygen_type(f: MolFeatures, i: int) -> str:
    if f.is_aromatic(i):
        return "O1"
    if f.implicit_h[i] > 0:
        return "O2"
    if any(f.is_aromatic(j) for j in f.nbrs[i]):
        return "O4"
    return "O3"


def crippen_logp(f: MolFeatures) -> float:
    total = 0.0
    for i, e in enumerate(f.elements):
        h = int(f.implicit_h[i])
        if e == "C":
            total += _CRIPPEN[_carbon_type(f, i)]
            total += h * _CRIPPEN["H1"]
        elif e == "N":
            total += _CRIPPEN[_nitrogen_type(f, i)]
            total += h * _CRIPPEN["H3"]
        elif e == "O":
            total += _CRIPPEN[_oxygen_type(f, i)]
            total += h * _CRIPPEN["H2"]
        elif e == "S":
            total += _CRIPPEN["S3" if f.is_aromatic(i) else "S1"]
            total += h * _CRIPPEN["HS"]
        elif e in _CRIPPEN:
            total += _CRIPPEN[e]
            total += h * _CRIPPEN["HS"]
        else:
            total += _CRIPPEN["X"]
            total += h * _CRIPPEN["HS"]
    return total


# ---------------------------------------------------------------------------
# QED (Bickerton 2012, published ADS parameters + mean weights)

_ADS = {
    #         a            b            c            d             e            f           dmax
    "MW":     (2.817065973, 392.5754953, 290.7489764, 2.419764353, 49.22325677, 65.37051707, 104.9805561),
    "ALOGP":  (3.172690585, 137.8624751, 2.534937431, 4.581497897, 0.822739154, 0.576295591, 131.3186604),
    "HBA":    (2.948620388, 160.4605972, 3.615294657, 4.435986202, 0.290141953, 1.300669958, 148.7763046),
    "HBD":    (1.618662227, 1010.051101, 0.985094388, 0.000000001, 0.713820843, 0.920922555, 258.1632616),
    "PSA":    (1.876861559, 125.2232657, 62.90773554, 87.83366614, 12.01999824, 28.51324732, 104.5686167),
    "ROTB":   (0.010000000, 272.4121427, 2.558379970, 1.565547684, 1.271567166, 2.758063707, 105.4420403),
    "AROM":   (3.217788970, 957.7374108, 2.274627939, 0.000000001, 1.317690384, 0.375760881, 312.3372610),
    "ALERTS": (0.010000000, 1199.094025, -0.09002883, 0.000000001, 0.185904477, 0.875193782, 417.7253140),
}
_QED_WEIGHTS = {
    "MW": 0.66, "ALOGP": 0.46, "HBA": 0.05, "HBD": 0.61,
    "PSA": 0.06, "ROTB": 0.65, "AROM": 0.48, "ALERTS": 0.95,
}


def _ads(x: float, p: Tuple[float, ...]) -> float:
    a, b, c, d, e, fpar, dmax = p
    t1 = 1.0 + math.exp(-(x - c + d / 2.0) / e)
    t2 = 1.0 + math.exp(-(x - c - d / 2.0) / fpar)
    return (a + b / t1 * (1.0 - 1.0 / t2)) / dmax


def qed_properties(f: MolFeatures) -> Dict[str, float]:
    return {
        "MW": mol_weight(f),
        "ALOGP": crippen_logp(f),
        "HBA": float(num_hba_qed(f)),
        "HBD": float(num_hbd(f)),
        "PSA": tpsa(f),
        "ROTB": float(num_rotatable_bonds(f)),
        "AROM": float(num_aromatic_rings(f)),
        "ALERTS": float(structural_alerts(f)),
    }


def qed(f: MolFeatures) -> float:
    props = qed_properties(f)
    num = 0.0
    den = 0.0
    for k, w in _QED_WEIGHTS.items():
        d = max(_ads(props[k], _ADS[k]), 0.003)  # rdkit clamp
        num += w * math.log(d)
        den += w
    return math.exp(num / den)


# ---------------------------------------------------------------------------
# Lipinski rule-of-five (reference metrics.py:309-319 rule set)


def lipinski(f: MolFeatures) -> int:
    lp = crippen_logp(f)
    rules = [
        mol_weight(f) < 500,
        num_hbd(f) <= 5,
        num_hba_lipinski(f) <= 10,
        -2 <= lp <= 5,
        num_rotatable_bonds(f) <= 10,
    ]
    return int(sum(rules))


# ---------------------------------------------------------------------------
# circular fingerprints + Tanimoto diversity


def _stable_hash(obj) -> int:
    digest = hashlib.blake2b(repr(obj).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "big")


def morgan_fingerprint(f: MolFeatures, radius: int = 2, n_bits: int = 2048) -> np.ndarray:
    """ECFP-style circular fingerprint folded to n_bits (reference uses
    GetMorganFingerprintAsBitVect(mol, 2, 2048), metrics.py:320-325; bit
    positions differ, the similarity space is analogous)."""
    n = f.mol.n_atoms
    ids = [_stable_hash((f.elements[i], int(f.degree[i]), int(f.implicit_h[i]),
                         f.is_aromatic(i), i in f.ring_atoms)) for i in range(n)]
    bits: Set[int] = set(h % n_bits for h in ids)
    cur = ids
    for _ in range(radius):
        nxt = []
        for i in range(n):
            env = tuple(sorted(cur[j] for j in f.nbrs[i]))
            h = _stable_hash((cur[i], env))
            nxt.append(h)
            bits.add(h % n_bits)
        cur = nxt
    fp = np.zeros(n_bits, bool)
    fp[list(bits)] = True
    return fp


def tanimoto(fp_a: np.ndarray, fp_b: np.ndarray) -> float:
    inter = np.logical_and(fp_a, fp_b).sum()
    union = np.logical_or(fp_a, fp_b).sum()
    return float(inter) / max(float(union), 1.0)


def tanimoto_diversity(fps: Sequence[np.ndarray]) -> Optional[float]:
    """1 - mean pairwise Tanimoto (reference metrics.py:326-333)."""
    if len(fps) < 2:
        return None
    sims = [tanimoto(fps[i], fps[j])
            for i in range(len(fps)) for j in range(i + 1, len(fps))]
    return 1.0 - float(np.mean(sims))


# ---------------------------------------------------------------------------
# first-party SA score (fragment-free; see analysis/sa_score.py docstring)


def first_party_sa(f: MolFeatures) -> float:
    """Ertl-Schuffenhauer complexity terms on the first-party graph with the
    fragment term at its neutral value (0). NOT on the published absolute
    scale (the fragment term is rdkit-Morgan-keyed and irreproducible
    without rdkit) but monotone in molecular complexity, mapped through the
    same [1,10] normalization (sa_score._approx_sa semantics)."""
    n_atoms = f.mol.n_atoms
    size_penalty = n_atoms ** 1.005 - n_atoms
    macro_penalty = math.log10(2) if any(len(r) > 8 for r in f.rings) else 0.0
    # spiro: atom in >= 2 rings sharing only that atom; bridgehead: atom in
    # >= 2 rings sharing >= 2 atoms with ring-degree 3
    ring_member: Dict[int, int] = {}
    for r in f.rings:
        for i in r:
            ring_member[i] = ring_member.get(i, 0) + 1
    n_multi = sum(1 for v in ring_member.values() if v >= 2)
    fused_penalty = math.log10(n_multi + 1) * 0.5
    score2 = -(size_penalty + macro_penalty + fused_penalty)
    raw = score2
    lo, hi = -4.0, 2.5
    sa = 11.0 - (raw - lo + 1.0) / (hi - lo) * 9.0
    if sa > 8.0:
        sa = 8.0 + math.log(sa + 1.0 - 9.0)
    return float(min(max(sa, 1.0), 10.0))


# ---------------------------------------------------------------------------
# batch entry point used by metrics.molecule_properties


def first_party_properties(mols: Sequence[BuiltMolecule]) -> Dict[str, Optional[float]]:
    """QED / SA / logP / Lipinski / Tanimoto diversity over built molecules,
    rdkit-free (the reference's MoleculeProperties.evaluate surface,
    analysis/metrics.py:239-333)."""
    if not mols:
        return {"qed": None, "sa": None, "logp": None, "lipinski": None, "diversity": None}
    qeds, sas, logps, lips, fps = [], [], [], [], []
    for m in mols:
        try:
            f = MolFeatures(m)
        except Exception:
            continue
        qeds.append(qed(f))
        sas.append(round((10 - first_party_sa(f)) / 9, 2))  # reference normalization
        logps.append(crippen_logp(f))
        lips.append(lipinski(f))
        fps.append(morgan_fingerprint(f))

    def _mean(x):
        return float(np.mean(x)) if x else None

    return {
        "qed": _mean(qeds),
        "sa": _mean(sas),
        "logp": _mean(logps),
        "lipinski": _mean(lips),
        "diversity": tanimoto_diversity(fps),
    }
