"""Minimal first-party mmCIF (PDBx) parser for receptor input
(kpdiff_tpu/data/mmcif.py, plus `write_mmcif`).

The reference's BYOP pipeline accepts `.pdb` and `.mmcif` receptors
(reference byop.py:13,107-110 routes mmCIF through BioPython's
MMCIFParser). This module parses the `_atom_site` category of a
PDBx/mmCIF file into the same `PdbAtoms` column table `data/pdb.py`
produces, so every downstream consumer (pocket extraction, featurization,
pocket.pdb writing) is format-agnostic.

Scope: the `loop_`-form `_atom_site` table (how every structure file in
the wild stores coordinates), quoted values, comments, first model only,
altloc '.'/'A' filtering, water/hydrogen exclusion — the same filtering
rules as parse_pdb. Synthesized PDB record lines keep write_pdb working
on mmCIF-sourced atoms.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from kpdiff_tpu_torch.data.pdb import WATER_RESNAMES, PdbAtoms, format_pdb_line


def _tokenize_cif_line(line: str) -> List[str]:
    """Whitespace-split honoring single/double quotes (PDBx syntax)."""
    out: List[str] = []
    i, n = 0, len(line)
    while i < n:
        c = line[i]
        if c.isspace():
            i += 1
            continue
        if c == "#":
            break
        if c in "'\"":
            j = i + 1
            # a closing quote must be followed by whitespace/EOL (CIF rule)
            while j < n:
                if line[j] == c and (j + 1 >= n or line[j + 1].isspace()):
                    break
                j += 1
            out.append(line[i + 1 : j])
            i = j + 1
        else:
            j = i
            while j < n and not line[j].isspace():
                j += 1
            out.append(line[i:j])
            i = j
    return out


def _first(row: Dict[str, str], *keys: str, default: str = "") -> str:
    for k in keys:
        v = row.get(k)
        if v not in (None, ".", "?"):
            return v
    return default


def parse_mmcif(path: str | Path, remove_hydrogen: bool = False,
                remove_water: bool = True) -> PdbAtoms:
    """Parse the _atom_site loop of an mmCIF file into a PdbAtoms table
    (reference byop.py:107-110 equivalent input path)."""
    tags: List[str] = []
    rows: List[List[str]] = []
    in_loop = False
    collecting = False
    pending: List[str] = []
    with open(path) as f:
        for raw in f:
            line = raw.rstrip("\n")
            s = line.strip()
            if not collecting:
                if s == "loop_":
                    in_loop = True
                    tags = []
                    continue
                if in_loop and s.startswith("_atom_site."):
                    tags.append(s.split()[0])
                    continue
                if in_loop and tags:
                    if s.startswith("_"):
                        # a different category piggybacked on this loop
                        if not s.startswith("_atom_site."):
                            in_loop = False
                            tags = []
                        continue
                    collecting = True  # first data row reached
                elif s.startswith("_") or not s:
                    in_loop = in_loop and not s.startswith("data_")
                    continue
                else:
                    continue
            if collecting:
                if s.startswith(("loop_", "_", "#", "data_")) and not pending:
                    break  # atom_site table finished
                toks = pending + _tokenize_cif_line(line)
                pending = []
                if not toks:
                    continue
                if len(toks) < len(tags):
                    pending = toks  # row wrapped across lines
                    continue
                rows.append(toks[: len(tags)])

    if not tags or not rows:
        raise ValueError(f"no _atom_site loop found in {path}")

    name, element, resname, chain = [], [], [], []
    resseq, coords, het, lines = [], [], [], []
    res_index: List[int] = []
    res_key_to_idx: Dict[tuple, int] = {}
    first_model: Optional[str] = None

    # suffix -> column index once, one dict per row in the hot loop
    suffixes = [t.split(".", 1)[1] for t in tags]
    for r in rows:
        row = {s: (r[i] if i < len(r) else None) for i, s in enumerate(suffixes)}
        model = _first(row, "pdbx_PDB_model_num", default="1")
        if first_model is None:
            first_model = model
        elif model != first_model:
            break  # first model only (parse_pdb ENDMDL behavior)
        group = _first(row, "group_PDB", default="ATOM")
        alt = _first(row, "label_alt_id", default="")
        if alt not in ("", "A"):
            continue
        rn = _first(row, "auth_comp_id", "label_comp_id")
        if remove_water and rn in WATER_RESNAMES:
            continue
        el = _first(row, "type_symbol").capitalize()
        nm = _first(row, "auth_atom_id", "label_atom_id")
        if not el:
            from kpdiff_tpu_torch.data.pdb import _element_from_columns

            el = _element_from_columns("", f" {nm:<3s}")
        if remove_hydrogen and el in ("H", "D"):
            continue
        try:
            xyz = (
                float(_first(row, "Cartn_x")),
                float(_first(row, "Cartn_y")),
                float(_first(row, "Cartn_z")),
            )
        except ValueError:
            continue
        # residue keying uses the FULL chain string — mmCIF auth_asym_id can
        # be multi-character ('A' vs 'AA' are distinct chains in large
        # assemblies) and truncating before keying would merge their
        # residues; only the emitted PDB line truncates to the 1-char column
        ch_full = _first(row, "auth_asym_id", "label_asym_id", default="A")
        ch = ch_full[:1]
        rs = _first(row, "auth_seq_id", "label_seq_id", default="0")
        rs_int = int(rs) if rs.lstrip("-").isdigit() else 0
        ins = _first(row, "pdbx_PDB_ins_code", default=" ")
        key = (ch_full, rs_int, ins, rn)
        if key not in res_key_to_idx:
            res_key_to_idx[key] = len(res_key_to_idx)
        name.append(nm)
        element.append(el)
        resname.append(rn[:3])
        chain.append(ch)
        resseq.append(rs_int)
        res_index.append(res_key_to_idx[key])
        coords.append(xyz)
        het.append(group == "HETATM")
        lines.append(
            format_pdb_line(len(name), nm[:4], rn[:3], ch, rs_int % 10000,
                            *xyz, el, hetero=group == "HETATM")
        )

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


def parse_structure(path: str | Path, remove_hydrogen: bool = False,
                    remove_water: bool = True) -> PdbAtoms:
    """Format-dispatching receptor parser: .pdb via parse_pdb, .cif/.mmcif
    via parse_mmcif (the reference's byop.py:107-110 dual input)."""
    from kpdiff_tpu_torch.data.pdb import parse_pdb

    suffix = Path(path).suffix.lower()
    if suffix in (".cif", ".mmcif"):
        return parse_mmcif(path, remove_hydrogen=remove_hydrogen, remove_water=remove_water)
    return parse_pdb(path, remove_hydrogen=remove_hydrogen, remove_water=remove_water)


_ATOM_SITE_TAGS = ("group_PDB", "id", "type_symbol", "label_atom_id", "label_alt_id", "label_comp_id",
                   "label_asym_id", "label_seq_id", "pdbx_PDB_ins_code", "Cartn_x", "Cartn_y", "Cartn_z",
                   "occupancy", "B_iso_or_equiv", "auth_seq_id", "auth_comp_id", "auth_asym_id", "auth_atom_id",
                   "pdbx_PDB_model_num")


def _cif_token(v: str) -> str:
    if not v or v.isspace():
        return "."
    if "'" in v:
        return f'"{v}"'
    if " " in v or v[0] in "_#$;\"[]":
        return f"'{v}'"
    return v


def write_mmcif(atoms: PdbAtoms, path: str | Path, data_name: str = "structure") -> None:
    """Write a PdbAtoms table as an mmCIF file: one `_atom_site` loop holding
    the columns parse_mmcif reads, one model, coordinates to 0.001 Å (the
    PDB format's precision), so parse_mmcif gives back the same table."""
    lines = [f"data_{data_name}", "#", "loop_"] + [f"_atom_site.{t}" for t in _ATOM_SITE_TAGS]
    for i in range(len(atoms)):
        nm, rn, ch = (_cif_token(atoms.name[i]), _cif_token(atoms.resname[i]), _cif_token(atoms.chain[i]))
        rs = int(atoms.resseq[i])
        x, y, z = (float(v) for v in atoms.coords[i])
        group = "HETATM" if atoms.is_hetero[i] else "ATOM"
        lines.append(f"{group} {i + 1} {_cif_token(atoms.element[i])} {nm} . {rn} {ch} {rs} ? "
                     f"{x:.3f} {y:.3f} {z:.3f} 1.00 0.00 {rs} {rn} {ch} {nm} 1")
    Path(path).write_text("\n".join(lines) + "\n#\n")
