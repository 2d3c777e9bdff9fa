"""In-training molecule-quality analyzer (kpdiff_tpu/analysis/analyzer.py;
reference ModelAnalyzer, analysis/metrics.py:36-206): every sample_interval
epochs, sample a few test pockets and report validity, connectivity,
uniqueness, atom-type KL and timing.

Sampling runs under torch.no_grad(), so the dense edges take the CUDA
kernel even when called from the training loop, and the model is left in
the mode it was found in.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch


class ModelAnalyzer:
    def __init__(self, model, dataset, pad, lig_elements: List[str], n_receptors: int = 4, n_replicates: int = 8,
                 train_type_counts: Optional[np.ndarray] = None, train_keys: Optional[set] = None, seed: int = 0,
                 diff_batch_size: int = 0):
        self.model = model
        self.ds = dataset
        self.pad = pad
        self.lig_elements = lig_elements
        self.n_receptors = n_receptors
        self.n_replicates = n_replicates
        self.train_type_counts = train_type_counts
        self.train_keys = train_keys
        self.rng = np.random.default_rng(seed)
        # molecules per sampler launch (reference sampling_config.diff_batch_size);
        # 0 = one launch for all n_receptors * n_replicates molecules
        self.diff_batch_size = int(diff_batch_size)

    def sample_and_analyze(self, generator: Optional[torch.Generator] = None) -> Dict[str, object]:
        from kpdiff_tpu_torch.analysis.metrics import evaluate_samples
        from kpdiff_tpu_torch.data.padding import pad_item, to_complex
        from kpdiff_tpu_torch.serve import decode_ligands

        t0 = time.time()
        idxs = self.rng.choice(len(self.ds), size=min(self.n_receptors, len(self.ds)), replace=False)
        items = []
        for i in idxs:
            it = pad_item(self.ds.get(int(i)), self.pad, n_lig_feat_out=self.model.cfg.atom_nf)
            if it is not None:
                items.extend([it] * self.n_replicates)
        if not items:
            return {"analyzer_error": "no pockets fit the padding capacity"}

        n_items = len(items)
        # every launch has diff_batch_size rows, the last one repeat-padded
        # (as the JAX analyzer keeps one executable); repeats are dropped below
        cs = self.diff_batch_size if self.diff_batch_size > 0 else n_items
        while len(items) % cs:
            items.append(items[0])
        device = next(self.model.parameters()).device
        was_training = self.model.training
        self.model.eval()
        ligands = []
        try:
            with torch.no_grad():
                for start in range(0, len(items), cs):
                    cpx = to_complex(items[start:start + cs], self.pad, self.model.cfg.rec_nf, self.model.kp_vec_dim,
                                     device=device)
                    enc, kk = self.model.encode(cpx)
                    out = self.model.sample(enc, kk, init_com=None, generator=generator)
                    n_keep = min(cs, n_items - start)
                    ligands.extend(decode_ligands({k: v[:n_keep] for k, v in out.items()}, self.lig_elements))
        finally:
            self.model.train(was_training)

        metrics = evaluate_samples([c for c, _ in ligands], [e for _, e in ligands], train_keys=self.train_keys,
                                   train_type_counts=self.train_type_counts, element_list=self.lig_elements)
        dt = time.time() - t0
        metrics["sample_time"] = dt
        # per molecule LAUNCHED, repeat-padding included: the padded rows take device time too
        metrics["sec_per_mol"] = dt / max(len(items), 1)
        return metrics
