"""The plain float32 reference of a fixed-encoder GVP configuration (the
paper's all-atom GVP baseline, `gvp_all_atom`): the pocket atoms as
keypoints (encoder_fixed.py), the kk radius graph at the rr cutoff, and the
GVP dynamics (dynamics_gvp.py), schedule, reverse step and finish of
model.py's RefModel, through model_fixed.py's FixedRefModel, whose encode
and kk edges this model inherits.

What differs from the learned-encoder reference:
  * padding: the keypoint capacity is the receptor's, `padding.n_rec`
    (`graph.n_keypoints` is not read);
  * feature sizes: the keypoint scalars are the receptor's element one-hot,
    `len(dataset.rec_elements)` wide, so the dynamics' keypoint encoder
    maps that width (plus t) to n_hidden_scalars (`rec_encoder_gvp` is not
    read); the keypoint vectors are zeros, (B, K, vector_size, 3), which
    GVPDynamics makes where it is handed no `kp_v`;
  * kk is the dense radius graph (B, K, K) of the keypoints at
    `graph_cutoffs['rr']`, not at `['kk']`;
  * the kk messages are aggregated over blocks of DST_BLOCK destinations,
    one block at a time: a destination's sum and count (message_norm
    'mean') are over its own sources alone, so the blocks give the whole
    grid's result, and 32 x 384 x 384 GVP messages in float32 fit.

Departures from upstream (Dunni3/keypoint-diffusion), besides model.py's:
  * `dynamics_gvp.kk_layout: block` (with `kk_block_size`) is this
    repository's training-only layout; sampling, upstream's and the
    program's, uses the exact radius graph, and so does this reference:
    the layout is not read;
  * `dynamics_gvp.remat` and `dropout` are training options: not read;
  * the configuration states bfloat16 GVP chains (this repository's choice,
    upstream runs float32): the reference computes them in float32, the
    control (`control=True`) in fp8 at those sites (precision.py).

Keypoints come in the pocket's atom order; the program orders them along a
Morton curve under the block layout, and the comparison matches the two as
sets (traffic/generate_fixed.py). The model imports nothing of the program.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from portbench.reference import precision
from portbench.reference.gvp import GVPEdgeMessages
from portbench.reference.model import _nothing
from portbench.reference.model_fixed import FixedRefModel, fixed_padding
from portbench.reference.schedule import NoiseSchedule

DST_BLOCK = 32  # kk destinations aggregated at a time


class GVPDestinationBlocks(GVPEdgeMessages):
    """GVPEdgeMessages whose dense form aggregates over blocks of DST_BLOCK
    destinations, one block at a time (the same sums and means)."""

    def dense(self, h_src, v_src, x_src, h_dst, v_dst, x_dst, adj, edge_feat=None, reduce=None):
        if reduce is not None:
            raise ValueError("the destination blocks run on one device")
        parts = [GVPEdgeMessages.dense(self, h_src, v_src, x_src, h_dst[:, i:i + DST_BLOCK],
                                       v_dst[:, i:i + DST_BLOCK], x_dst[:, i:i + DST_BLOCK],
                                       adj[:, :, i:i + DST_BLOCK], edge_feat)
                 for i in range(0, h_dst.shape[1], DST_BLOCK)]
        return torch.cat([p[0] for p in parts], dim=1), torch.cat([p[1] for p in parts], dim=1)


class FixedGVPRefModel(FixedRefModel):
    """The GVP dynamics of a fixed-encoder configuration, parameters named
    as the archives name them (`dynamics.*`; the encoder has none)."""

    def __init__(self, config: Dict[str, Any], control: bool = False):
        nn.Module.__init__(self)
        from portbench.reference.dynamics_gvp import GVPDynamics

        diff, ds = config["diffusion"], config["dataset"]
        if diff.get("rec_encoder_type", "learned") != "fixed" or diff.get("architecture", "egnn") != "gvp":
            raise ValueError("this reference covers GVP configurations with a fixed encoder")
        if ds.get("max_fake_atom_frac", 0.0) > 0 or ds.get("ca_only", False):
            raise ValueError("this reference covers all-atom pockets without fake atoms")
        self.config = config
        self.control = control
        self.gvp = True
        d = config["dynamics_gvp"]
        self.kp_vec_dim = d.get("vector_size", 16)
        self.n_lig_feat = len(ds["lig_elements"])
        self.cutoffs = dict(config["graph"]["graph_cutoffs"])
        self.n_kp = fixed_padding(config).n_kp
        self.T = diff.get("n_timesteps", 1000)
        self.schedule = NoiseSchedule.create(diff.get("noise_schedule", "polynomial_2"), self.T,
                                             diff.get("precision", 1e-4))
        self.lig_norm = diff.get("lig_feat_norm_constant", 1)
        gen = torch.Generator().manual_seed(0)  # overwritten by the archive
        with precision.control_sites() if control else _nothing():
            self.dynamics = GVPDynamics(
                n_lig_scalars=self.n_lig_feat, n_kp_scalars=len(ds["rec_elements"]), gen=gen,
                ll_cutoff=self.cutoffs.get("ll", 9.0), kl_cutoff=self.cutoffs.get("kl", 8.0),
                **{k: v for k, v in d.items() if k not in ("no_cg", "n_keypoints", "remat", "dropout")})
        for i in range(self.dynamics.n_convs):
            conv = getattr(self.dynamics, f"conv{i}")
            if hasattr(conv, "message_kk"):
                conv.message_kk.__class__ = GVPDestinationBlocks


def load_fixed_gvp_reference(config: Dict[str, Any], archive: Optional[Dict[str, np.ndarray]], device,
                             control: bool = False, seed: int = 0) -> FixedGVPRefModel:
    """The reference (or the control) on `device`, weights from `archive`
    ({name: array}); None draws them from `seed` (the tests' tiny models)."""
    model = FixedGVPRefModel(config, control=control)
    if archive is None:
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    else:
        model.load(archive)
    return model.to(device).eval()
