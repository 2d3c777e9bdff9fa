"""Padded in-memory dataset and loader (kpdiff_tpu/data/dataset.py).

`ComplexDataset` holds a processed split as concatenated arrays with segment
pointers (the pickles of the processing CLIs: lig_pos, lig_feat, rec_pos,
rec_feat, interface_points, rec_res_idx, *_segments, rec_files,
lig_files). `PaddedLoader` pads each complex to the smallest ligand bucket
that fits (`pad_item`, fake atoms included) and yields PaddedComplex
batches of host tensors in the JAX loader's order: for the same seed, the
same batches. The trainer moves them to its device.
"""
from __future__ import annotations

import dataclasses
import itertools
import pickle
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from kpdiff_tpu_torch.config import PaddingConfig
from kpdiff_tpu_torch.data.padding import pad_item
from kpdiff_tpu_torch.models.complex import PaddedComplex, make_complex


def _to_numpy(x):
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class ComplexDataset:
    """Per-complex access to a processed split (ragged, host-side)."""

    def __init__(self, lig_pos: np.ndarray, lig_feat: np.ndarray, rec_pos: np.ndarray, rec_feat: np.ndarray,
                 rec_res_idx: np.ndarray, interface_points: np.ndarray, rec_segments: np.ndarray,
                 lig_segments: np.ndarray, ip_segments: np.ndarray, rec_files: Optional[List[str]] = None,
                 lig_files: Optional[List[str]] = None):
        self.lig_pos = lig_pos
        self.lig_feat = lig_feat
        self.rec_pos = rec_pos
        self.rec_feat = rec_feat
        self.rec_res_idx = rec_res_idx
        self.interface_points = interface_points
        self.rec_segments = rec_segments.astype(np.int64)
        self.lig_segments = lig_segments.astype(np.int64)
        self.ip_segments = ip_segments.astype(np.int64)
        self.rec_files = rec_files
        self.lig_files = lig_files

    @staticmethod
    def from_pickle(path: str | Path) -> "ComplexDataset":
        """A processed split pickle; torch tensors in it become numpy arrays.
        Unpickling runs code: read only pickles this project wrote."""
        with open(path, "rb") as f:
            data = pickle.load(f)
        return ComplexDataset(
            lig_pos=_to_numpy(data["lig_pos"]).astype(np.float32),
            lig_feat=_to_numpy(data["lig_feat"]).astype(np.float32),
            rec_pos=_to_numpy(data["rec_pos"]).astype(np.float32),
            rec_feat=_to_numpy(data["rec_feat"]).astype(np.float32),
            rec_res_idx=_to_numpy(data["rec_res_idx"]).astype(np.int32),
            interface_points=_to_numpy(data["interface_points"]).astype(np.float32),
            rec_segments=_to_numpy(data["rec_segments"]),
            lig_segments=_to_numpy(data["lig_segments"]),
            ip_segments=_to_numpy(data["ip_segments"]),
            rec_files=data.get("rec_files"),
            lig_files=data.get("lig_files"),
        )

    def to_pickle(self, path: str | Path) -> None:
        """Write the split as numpy arrays under the processed pickles' keys
        (what `from_pickle` and the sample CLI's `{split}.pkl` read)."""
        data = {k: getattr(self, k) for k in ("lig_pos", "lig_feat", "rec_pos", "rec_feat", "rec_res_idx",
                                              "interface_points", "rec_segments", "lig_segments", "ip_segments")}
        data.update(rec_files=self.rec_files, lig_files=self.lig_files)
        with open(path, "wb") as f:
            pickle.dump(data, f)

    def subset(self, idxs) -> "ComplexDataset":
        """The complexes at `idxs`, in that order, as a new split."""
        items = [self.get(int(i)) for i in idxs]
        seg = lambda k: np.concatenate([[0], np.cumsum([it[k].shape[0] for it in items])])
        cat = lambda k: np.concatenate([it[k] for it in items])
        files = lambda f: [f[int(i)] for i in idxs] if f else None
        return ComplexDataset(cat("lig_pos"), cat("lig_feat"), cat("rec_pos"), cat("rec_feat"), cat("rec_res_idx"),
                              cat("interface_points"), seg("rec_pos"), seg("lig_pos"), seg("interface_points"),
                              files(self.rec_files), files(self.lig_files))

    def __len__(self) -> int:
        return len(self.lig_segments) - 1

    def get(self, i: int) -> Dict[str, np.ndarray]:
        ls, le = self.lig_segments[i: i + 2]
        rs, re = self.rec_segments[i: i + 2]
        ps, pe = self.ip_segments[i: i + 2]
        return dict(
            lig_pos=self.lig_pos[ls:le], lig_feat=self.lig_feat[ls:le],
            rec_pos=self.rec_pos[rs:re], rec_feat=self.rec_feat[rs:re], rec_res_idx=self.rec_res_idx[rs:re],
            interface_points=self.interface_points[ps:pe],
        )

    def get_files(self, i: int) -> Tuple[Optional[str], Optional[str]]:
        rf = self.rec_files[i] if self.rec_files else None
        lf = self.lig_files[i] if self.lig_files else None
        return rf, lf


def lig_sizes(ds: ComplexDataset) -> np.ndarray:
    """Per-complex ligand atom counts (from the segment pointers)."""
    return np.diff(ds.lig_segments)


def derive_lig_buckets(sizes, n_lig_pad: int, max_buckets: int = 3, align: int = 8) -> List[int]:
    """At most max_buckets ascending ligand padding buckets (multiples of
    `align`, the largest n_lig_pad) that minimise the expected dense ll
    pair-grid cost E[bucket(n)^2] over the observed sizes; brute force over
    the few candidates."""
    sizes = np.asarray(sizes)
    sizes = sizes[(sizes > 0) & (sizes <= n_lig_pad)]
    if sizes.size == 0 or max_buckets <= 1:
        return [n_lig_pad]
    cands = [b for b in range(align, n_lig_pad, align) if b >= sizes.min()]
    best, best_cost = [n_lig_pad], float(n_lig_pad) ** 2
    for k in range(1, max_buckets):
        for combo in itertools.combinations(cands, k):
            buckets = sorted(combo) + [n_lig_pad]
            bs = np.asarray(buckets)
            cost = float(np.mean(bs[np.searchsorted(bs, sizes)] ** 2))
            if cost < best_cost - 1e-9:
                best, best_cost = buckets, cost
    return best


def resolve_lig_buckets(config, ds, n_lig_pad: int) -> Optional[List[int]]:
    """padding.lig_buckets for the CLIs: 'auto' derives them from the split's
    size histogram; an explicit list must end at the padding capacity.
    Returns a sorted list ending in n_lig_pad, or None (no bucketing)."""
    buckets = config.get("padding", {}).get("lig_buckets")
    if buckets == "auto":
        buckets = derive_lig_buckets(lig_sizes(ds), n_lig_pad) if hasattr(ds, "lig_segments") else [n_lig_pad]
        print(f"ligand buckets (auto from size histogram): {buckets}", flush=True)
    elif buckets:
        buckets = sorted(int(b) for b in buckets)
        if buckets[-1] != n_lig_pad:
            raise ValueError(f"largest lig bucket {buckets[-1]} must equal padding.n_lig {n_lig_pad}")
    return buckets or None


class PaddedLoader:
    """Shuffled epoch iterator of PaddedComplex batches (host tensors).

    Complexes beyond the padding capacity are dropped and counted in
    `n_dropped`. Each complex goes to the smallest ligand bucket that fits;
    a bucket's batch is yielded when it is full, and without drop_last the
    partial batches are repeat-padded with empty-mask rows at the end."""

    def __init__(self, dataset: ComplexDataset, pad: PaddingConfig, batch_size: int, n_kp: int,
                 kp_feat_dim: int, max_fake_atom_frac: float = 0.0, seed: int = 0, drop_last: bool = False,
                 lig_buckets: Optional[List[int]] = None, kp_vec_dim: Optional[int] = None):
        self.ds = dataset
        self.pad = pad
        self.batch_size = batch_size
        self.n_kp = n_kp
        self.kp_feat_dim = kp_feat_dim
        self.kp_vec_dim = kp_vec_dim
        self.max_fake_atom_frac = max_fake_atom_frac
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last
        self.lig_buckets = sorted(lig_buckets) if lig_buckets else None
        if self.lig_buckets and self.lig_buckets[-1] != pad.n_lig:
            raise ValueError("largest lig bucket must equal pad.n_lig")
        self.n_dropped = 0
        self.n_lig_feat = dataset.lig_feat.shape[1] + (1 if max_fake_atom_frac > 0 else 0)

    def _bucket_pad(self, n_lig: int) -> Optional[PaddingConfig]:
        if not self.lig_buckets:
            return self.pad
        for b in self.lig_buckets:
            if n_lig <= b:
                return dataclasses.replace(self.pad, n_lig=b)
        return None

    def epoch(self) -> Iterator[PaddedComplex]:
        order = self.rng.permutation(len(self.ds))
        bufs: Dict[int, List[Dict[str, np.ndarray]]] = {}
        for i in order:
            item = self.ds.get(int(i))
            pad = self._bucket_pad(item["lig_pos"].shape[0])
            if pad is None:
                self.n_dropped += 1
                continue
            padded = pad_item(item, pad, self.max_fake_atom_frac, self.rng, self.n_lig_feat)
            if padded is None:
                self.n_dropped += 1
                continue
            buf = bufs.setdefault(pad.n_lig, [])
            buf.append(padded)
            if len(buf) == self.batch_size:
                yield self._collate(buf)
                bufs[pad.n_lig] = []
        for buf in bufs.values():
            if buf and not self.drop_last:
                while len(buf) < self.batch_size:
                    buf.append({k: np.zeros_like(v) if k.endswith("mask") else v for k, v in buf[-1].items()})
                yield self._collate(buf)

    def _collate(self, items: List[Dict[str, np.ndarray]]) -> PaddedComplex:
        st = {k: np.stack([it[k] for it in items]) for k in items[0]}
        return make_complex(st["rec_x"], st["rec_h"], st["rec_mask"], st["lig_x"], st["lig_h"], st["lig_mask"],
                            n_kp=self.n_kp, kp_feat_dim=self.kp_feat_dim, kp_vec_dim=self.kp_vec_dim,
                            rec_res_idx=st["rec_res_idx"],
                            ip_x=st["ip_x"], ip_mask=st["ip_mask"])


def synthetic_dataset(n_complexes: int, seed: int = 0, n_rec_feat: int = 10, n_lig_feat: int = 10,
                      rec_range=(24, 96), lig_range=(8, 24)) -> ComplexDataset:
    """A ComplexDataset of synthetic pocket/ligand pairs (the generator of
    models/complex.py, same draws as the JAX package's)."""
    from kpdiff_tpu_torch.models.complex import synthetic_complex_np

    rng = np.random.default_rng(seed)
    lig_pos, lig_feat, rec_pos, rec_feat, res_idx, ips = [], [], [], [], [], []
    rec_seg, lig_seg, ip_seg = [0], [0], [0]
    for _ in range(n_complexes):
        n_rec = int(rng.integers(*rec_range))
        n_lig = int(rng.integers(*lig_range))
        item = synthetic_complex_np(rng, n_rec, n_lig, n_rec, n_lig, n_rec_feat, n_lig_feat,
                                    n_ip_pad=max(n_lig // 2, 2))
        lig_pos.append(item["lig_x"])
        lig_feat.append(item["lig_h"])
        rec_pos.append(item["rec_x"])
        rec_feat.append(item["rec_h"])
        res_idx.append(item["rec_res_idx"])
        n_ip = int(item["ip_mask"].sum())
        ips.append(item["ip_x"][:n_ip])
        rec_seg.append(rec_seg[-1] + n_rec)
        lig_seg.append(lig_seg[-1] + n_lig)
        ip_seg.append(ip_seg[-1] + n_ip)
    return ComplexDataset(
        lig_pos=np.concatenate(lig_pos), lig_feat=np.concatenate(lig_feat), rec_pos=np.concatenate(rec_pos),
        rec_feat=np.concatenate(rec_feat), rec_res_idx=np.concatenate(res_idx),
        interface_points=np.concatenate(ips), rec_segments=np.array(rec_seg), lig_segments=np.array(lig_seg),
        ip_segments=np.array(ip_seg),
    )
