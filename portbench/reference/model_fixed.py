"""The plain float32 reference of a fixed-encoder EGNN configuration (the
paper's all-atom baseline, `egnn_all_atom`): the pocket atoms as keypoints
(encoder_fixed.py), the kk radius graph at the rr cutoff, and the EGNN
dynamics, schedule, reverse step and finish of model.py's RefModel, whose
methods this model inherits.

What differs from the learned-encoder reference:
  * padding: the keypoint capacity is the receptor's, `padding.n_rec`
    (`graph.n_keypoints` is not read);
  * feature sizes: the keypoints carry the receptor's element one-hot,
    `len(dataset.rec_elements)` wide, so the dynamics' keypoint encoder
    maps that width to hidden_nf (a learned encoder's output width is not
    read);
  * kk is the dense radius graph (B, K, K) of the keypoints at
    `graph_cutoffs['rr']`, not at `['kk']`;
  * the kk messages are summed over blocks of DST_BLOCK destinations, one
    block at a time: a destination's sums are over its own sources alone,
    so the blocks give the whole grid's result, and 32 x 384 x 384 pairs at
    width 257 in float32 (about 5 GB a pair tensor) fit beside the others.

Departures from upstream (Dunni3/keypoint-diffusion), besides model.py's:
  * `dynamics.kk_layout: block` (with `kk_block_size`) is this repository's
    training-only layout; sampling, upstream's and the program's, uses the
    exact radius graph, and so does this reference: the layout is not read;
  * `dynamics.remat` is a training option: not read;
  * the configuration states bfloat16 pair MLPs (this repository's choice,
    upstream runs float32): the reference computes them in float32, the
    control (`control=True`) in fp8 at those sites (precision.py).

Keypoints come in the pocket's atom order. The program orders them along a
Morton curve under the block layout; a set has no order, so the comparison
matches the two as sets (traffic/generate_fixed.py). The model imports
nothing of the program.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from portbench.reference import precision
from portbench.reference.complex import PaddedComplex, make_complex
from portbench.reference.egnn import EGNNEdgeDense
from portbench.reference.encoder_fixed import fixed_encode, rr_adjacency
from portbench.reference.model import Padding, RefModel, _nothing
from portbench.reference.schedule import NoiseSchedule

DST_BLOCK = 32  # kk destinations summed at a time


class DestinationBlocks(EGNNEdgeDense):
    """EGNNEdgeDense whose messages are summed over blocks of DST_BLOCK
    destinations, one block at a time (the same sums)."""

    def forward(self, h_src, h_dst, x_src, x_dst, adj, edge_feat=None):
        parts = [self._generic(h_src, h_dst[:, i:i + DST_BLOCK], x_src, x_dst[:, i:i + DST_BLOCK],
                               adj[:, :, i:i + DST_BLOCK], edge_feat)
                 for i in range(0, h_dst.shape[1], DST_BLOCK)]
        return torch.cat([p[0] for p in parts], dim=1), torch.cat([p[1] for p in parts], dim=1)


def fixed_padding(config: Dict[str, Any]) -> Padding:
    """The padded capacities of a fixed-encoder configuration: keypoints as many as receptor atoms."""
    pad = Padding.from_config(config)
    return dataclasses.replace(pad, n_kp=pad.n_rec)


class FixedRefModel(RefModel):
    """The EGNN dynamics of a fixed-encoder configuration, parameters named
    as the archives name them (`dynamics.*`; the encoder has none)."""

    def __init__(self, config: Dict[str, Any], control: bool = False):
        nn.Module.__init__(self)
        from portbench.reference.dynamics_egnn import EGNNDynamics

        diff, ds = config["diffusion"], config["dataset"]
        if diff.get("rec_encoder_type", "learned") != "fixed" or diff.get("architecture", "egnn") != "egnn":
            raise ValueError("this reference covers EGNN configurations with a fixed encoder")
        if ds.get("max_fake_atom_frac", 0.0) > 0 or ds.get("ca_only", False):
            raise ValueError("this reference covers all-atom pockets without fake atoms")
        self.config = config
        self.control = control
        self.gvp = False
        self.kp_vec_dim = None
        self.n_lig_feat = len(ds["lig_elements"])
        self.cutoffs = dict(config["graph"]["graph_cutoffs"])
        self.n_kp = fixed_padding(config).n_kp
        self.T = diff.get("n_timesteps", 1000)
        self.schedule = NoiseSchedule.create(diff.get("noise_schedule", "polynomial_2"), self.T,
                                             diff.get("precision", 1e-4))
        self.lig_norm = diff.get("lig_feat_norm_constant", 1)
        gen = torch.Generator().manual_seed(0)  # overwritten by the archive
        d = config["dynamics"]
        with precision.control_sites() if control else _nothing():
            self.dynamics = EGNNDynamics(
                atom_nf=self.n_lig_feat, rec_nf=len(ds["rec_elements"]), gen=gen, n_layers=d.get("n_layers", 6),
                hidden_nf=d.get("hidden_nf", 256), use_tanh=d.get("use_tanh", False),
                message_norm=d.get("message_norm", 1), update_kp_feat=d.get("update_kp_feat", False),
                norm=d.get("norm", False), ll_k=d.get("ll_k", 0), kl_k=d.get("kl_k", 0),
                ll_cutoff=self.cutoffs.get("ll", 9.0), kl_cutoff=self.cutoffs.get("kl", 8.0),
                compute_dtype=d.get("compute_dtype", "float32"), z_semantics=d.get("z_semantics", "intent"))
        for i in range(self.dynamics.n_layers):
            conv = getattr(self.dynamics, f"conv{i}")
            if hasattr(conv, "edge_kk"):
                conv.edge_kk.__class__ = DestinationBlocks

    @torch.no_grad()
    def encode(self, items: List[Dict[str, np.ndarray]], device,
               kp_pos: Optional[torch.Tensor] = None) -> PaddedComplex:
        """Padded items -> complex whose keypoints are the pocket atoms (no
        weights, so `kp_pos` has nothing to place and is refused)."""
        if kp_pos is not None:
            raise ValueError("a fixed encoder's keypoints are the pocket atoms")
        st = {k: np.stack([it[k] for it in items]) for k in items[0]}
        cpx = make_complex(st["rec_x"], st["rec_h"], st["rec_mask"], st["lig_x"], st["lig_h"], st["lig_mask"],
                           n_kp=self.n_kp, kp_feat_dim=1, rec_res_idx=st["rec_res_idx"], ip_x=st["ip_x"],
                           ip_mask=st["ip_mask"], device=device)
        return fixed_encode(cpx)

    def kk_adjacency(self, kp_x: torch.Tensor, kp_mask: torch.Tensor) -> torch.Tensor:
        """The dense kk radius graph (B, K, K) at the rr cutoff."""
        return rr_adjacency(kp_x, kp_mask, self.cutoffs["rr"])


def load_fixed_reference(config: Dict[str, Any], archive: Optional[Dict[str, np.ndarray]], device,
                         control: bool = False, seed: int = 0) -> FixedRefModel:
    """The reference (or the control) on `device`, weights from `archive`
    ({name: array}); None draws them from `seed` (the tests' tiny models)."""
    model = FixedRefModel(config, control=control)
    if archive is None:
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    else:
        model.load(archive)
    return model.to(device).eval()
