"""Chemistry constants (kpdiff_tpu/constants.py; reference constants.py,
originally from DiffSBDD)."""

allowed_bonds = {
    "H": 1, "C": 4, "N": 3, "O": 2, "F": 1, "B": 3, "Al": 3,
    "Si": 4, "P": [3, 5],
    "S": 4, "Cl": 1, "As": 3, "Br": 1, "I": 1, "Hg": [1, 2],
    "Bi": [3, 5],
}

aa_encoding = ["A", "C", "D", "E", "F", "G", "H", "I", "K", "L", "M", "N", "P", "Q", "R", "S", "T", "V", "W", "Y"]
aa_to_idx = {aa: i for i, aa in enumerate(aa_encoding)}
idx_to_aa = {i: aa for aa, i in aa_to_idx.items()}

# 3-letter -> 1-letter residue codes (BioPython protein_letters_3to1 subset
# used by the reference's ca_only featurization, process_bindingmoad.py:168-171)
protein_letters_3to1 = {
    "ALA": "A", "CYS": "C", "ASP": "D", "GLU": "E", "PHE": "F", "GLY": "G",
    "HIS": "H", "ILE": "I", "LYS": "K", "LEU": "L", "MET": "M", "ASN": "N",
    "PRO": "P", "GLN": "Q", "ARG": "R", "SER": "S", "THR": "T", "VAL": "V",
    "TRP": "W", "TYR": "Y",
}
