"""Minimal first-party PDB parser/writer (pure python, fixed-column format;
kpdiff_tpu/data/pdb.py).

Replaces the reference's prody/BioPython usage for the inference paths
(reference pdbbind_processing.py:17-42 parse, make_bindingmoad_pocketfile.py
writer). Handles ATOM/HETATM records, altloc filtering (keeps '' or 'A'),
water/hydrogen exclusion, and element inference from atom names.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional

import numpy as np

WATER_RESNAMES = {"HOH", "WAT", "DOD", "TIP", "TIP3", "TIP4", "SOL"}


@dataclasses.dataclass
class PdbAtoms:
    """Column-oriented atom table."""

    name: List[str]
    element: List[str]
    resname: List[str]
    chain: List[str]
    resseq: np.ndarray  # (N,) int author residue numbers
    res_index: np.ndarray  # (N,) int 0-based unique-residue index
    coords: np.ndarray  # (N, 3) float32
    is_hetero: np.ndarray  # (N,) bool
    record_lines: List[str]  # original lines, for faithful re-writing

    def __len__(self):
        return len(self.name)

    def select(self, mask: np.ndarray) -> "PdbAtoms":
        idx = np.where(mask)[0]
        return PdbAtoms(
            name=[self.name[i] for i in idx],
            element=[self.element[i] for i in idx],
            resname=[self.resname[i] for i in idx],
            chain=[self.chain[i] for i in idx],
            resseq=self.resseq[idx],
            res_index=self.res_index[idx],
            coords=self.coords[idx],
            is_hetero=self.is_hetero[idx],
            record_lines=[self.record_lines[i] for i in idx],
        )


def _element_from_columns(line: str, name: str) -> str:
    el = line[76:78].strip() if len(line) >= 78 else ""
    if el:
        return el.capitalize()
    # infer from atom name (PDB v2 files without element columns)
    nm = name.strip()
    while nm and nm[0].isdigit():
        nm = nm[1:]
    if len(nm) >= 2 and nm[:2].capitalize() in _TWO_LETTER:
        return nm[:2].capitalize()
    return nm[:1].upper() if nm else "X"


_TWO_LETTER = {"Cl", "Br", "Fe", "Zn", "Mg", "Mn", "Ca", "Na", "Cu", "Ni", "Co", "Se", "Hg", "Cd", "As", "Si", "Al"}


def parse_pdb(path: str | Path, remove_hydrogen: bool = False, remove_water: bool = True) -> PdbAtoms:
    name, element, resname, chain = [], [], [], []
    resseq, coords, het, lines = [], [], [], []
    res_index = []
    res_key_to_idx = {}
    with open(path) as f:
        for line in f:
            rec = line[:6]
            if rec not in ("ATOM  ", "HETATM"):
                if rec.startswith("ENDMDL"):
                    break  # first model only (prody default)
                continue
            altloc = line[16]
            if altloc not in (" ", "A"):
                continue
            rn = line[17:20].strip()
            if remove_water and rn in WATER_RESNAMES:
                continue
            nm = line[12:16]
            el = _element_from_columns(line, nm)
            if remove_hydrogen and el in ("H", "D"):
                continue
            try:
                xyz = (float(line[30:38]), float(line[38:46]), float(line[46:54]))
            except ValueError:
                continue
            ch = line[21]
            rs = line[22:26].strip()
            rs_int = int(rs) if rs.lstrip("-").isdigit() else 0
            key = (ch, rs_int, line[26], rn)
            if key not in res_key_to_idx:
                res_key_to_idx[key] = len(res_key_to_idx)
            name.append(nm.strip())
            element.append(el)
            resname.append(rn)
            chain.append(ch)
            resseq.append(rs_int)
            res_index.append(res_key_to_idx[key])
            coords.append(xyz)
            het.append(rec == "HETATM")
            lines.append(line.rstrip("\n"))
    return PdbAtoms(
        name=name,
        element=element,
        resname=resname,
        chain=chain,
        resseq=np.asarray(resseq, np.int32),
        res_index=np.asarray(res_index, np.int32),
        coords=np.asarray(coords, np.float32).reshape(-1, 3),
        is_hetero=np.asarray(het, bool),
        record_lines=lines,
    )


def write_pdb(atoms: PdbAtoms, path: str | Path, renumber: bool = False):
    """Write atoms back out, preserving original records where available."""
    with open(path, "w") as f:
        for i, line in enumerate(atoms.record_lines):
            if renumber:
                line = line[:6] + f"{i + 1:5d}" + line[11:]
            f.write(line + "\n")
        f.write("END\n")


def format_pdb_line(
    serial: int,
    name: str,
    resname: str,
    chain: str,
    resseq: int,
    x: float,
    y: float,
    z: float,
    element: str,
    hetero: bool = False,
) -> str:
    """One correctly-columned ATOM/HETATM record."""
    rec = "HETATM" if hetero else "ATOM  "
    # atom name convention: 1-letter elements start at column 14
    nm = f" {name:<3s}" if len(name) < 4 and len(element) == 1 else f"{name:<4s}"
    return (
        f"{rec}{serial:5d} {nm}{' '}{resname:<3s} {chain}{resseq:4d}    "
        f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00          {element:>2s}"
    )


def write_xyz(coords: np.ndarray, elements: List[str], path: Optional[str | Path] = None) -> str:
    """xyz text (reference utils.write_xyz_file:11-21)."""
    out = f"{len(coords)}\n\n"
    for el, (x, y, z) in zip(elements, coords):
        out += f"{el} {x:.3f} {y:.3f} {z:.3f}\n"
    if path is not None:
        with open(path, "w") as f:
            f.write(out)
    return out
