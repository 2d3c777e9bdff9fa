"""Minimal first-party SDF (MDL molfile V2000) reader/writer
(kpdiff_tpu/data/sdf.py; the port's copy writes byte-identical text).

Replaces rdkit SDMolSupplier for the ligand-parsing inference path
(reference pdbbind_processing.py:45-83) and SDF writing of sampled
molecules (reference test.py:218-285 via rdkit SDWriter).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class SdfMol:
    title: str
    elements: List[str]
    coords: np.ndarray  # (N, 3)
    bonds: List[Tuple[int, int, int]]  # (a, b, order), 0-based

    @property
    def n_atoms(self) -> int:
        return len(self.elements)

    def without_hydrogens(self) -> "SdfMol":
        keep = [i for i, e in enumerate(self.elements) if e not in ("H", "D")]
        remap = {old: new for new, old in enumerate(keep)}
        bonds = [
            (remap[a], remap[b], o)
            for a, b, o in self.bonds
            if a in remap and b in remap
        ]
        return SdfMol(
            title=self.title,
            elements=[self.elements[i] for i in keep],
            coords=self.coords[keep],
            bonds=bonds,
        )


def parse_sdf(path: str | Path) -> List[SdfMol]:
    with open(path) as f:
        text = f.read()
    mols = []
    for block in text.split("$$$$"):
        block = block.strip("\n")
        if not block.strip():
            continue
        lines = block.split("\n")
        if len(lines) < 4:
            continue
        title = lines[0].strip()
        counts = lines[3]
        try:
            n_atoms = int(counts[0:3])
            n_bonds = int(counts[3:6])
        except ValueError:
            continue
        elements, coords = [], []
        for i in range(4, 4 + n_atoms):
            ln = lines[i]
            coords.append((float(ln[0:10]), float(ln[10:20]), float(ln[20:30])))
            elements.append(ln[31:34].strip())
        bonds = []
        for i in range(4 + n_atoms, 4 + n_atoms + n_bonds):
            ln = lines[i]
            a = int(ln[0:3]) - 1
            b = int(ln[3:6]) - 1
            order = int(ln[6:9])
            bonds.append((a, b, order))
        mols.append(SdfMol(title=title, elements=elements, coords=np.asarray(coords, np.float32), bonds=bonds))
    return mols


def write_sdf(mols: List[SdfMol], path: str | Path, append: bool = False):
    mode = "a" if append else "w"
    with open(path, mode) as f:
        for mol in mols:
            f.write(mol_block(mol))
            f.write("$$$$\n")


def mol_block(mol: SdfMol) -> str:
    lines = [mol.title, "  kpdiffTPU", "", f"{mol.n_atoms:3d}{len(mol.bonds):3d}  0  0  0  0  0  0  0  0999 V2000"]
    for el, (x, y, z) in zip(mol.elements, mol.coords):
        lines.append(f"{x:10.4f}{y:10.4f}{z:10.4f} {el:<3s} 0  0  0  0  0  0  0  0  0  0  0  0")
    for a, b, o in mol.bonds:
        lines.append(f"{a + 1:3d}{b + 1:3d}{o:3d}  0")
    lines.append("M  END")
    return "\n".join(lines) + "\n"
