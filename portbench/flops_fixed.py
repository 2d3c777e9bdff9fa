"""Model operations of a reverse step of an EGNN configuration with a fixed
receptor encoder, counted as flops.py counts them: the keypoints carry the
receptor's element one-hot, so the dynamics' keypoint encoder maps
len(dataset.rec_elements) channels to hidden_nf (flops.egnn_step_flops would
read a learned encoder's output width, which a fixed encoder has not)."""
from __future__ import annotations

from typing import Dict

from portbench import flops


def step_flops(model: Dict, **counts) -> int:
    """flops.egnn_step_flops with the keypoint encoder on the one-hot width;
    `counts` as there (kk_pairs: the valid edges of the kk neighbor list)."""
    one_hot = len(model["dataset"]["rec_elements"])
    return flops.egnn_step_flops(dict(model, rec_encoder=dict(model["rec_encoder"], out_n_node_feat=one_hot)),
                                 **counts)
