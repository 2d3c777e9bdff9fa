"""Model operations of a reverse step of a GVP configuration with a fixed
receptor encoder, counted as flops.py counts them: the keypoint scalars are
the receptor's element one-hot, so the dynamics' keypoint encoder maps
len(dataset.rec_elements) + 1 channels to n_hidden_scalars
(flops.gvp_step_flops would read a learned GVP encoder's output width,
rec_encoder_gvp.out_scalar_size, which a fixed encoder has not)."""
from __future__ import annotations

from typing import Dict

from portbench import flops


def step_flops(model: Dict, **counts) -> int:
    """flops.gvp_step_flops with the keypoint encoder on the one-hot width;
    `counts` as there (kk_pairs: the valid edges of the kk neighbor list)."""
    one_hot = len(model["dataset"]["rec_elements"])
    return flops.gvp_step_flops(dict(model, rec_encoder_gvp=dict(model["rec_encoder_gvp"], out_scalar_size=one_hot)),
                                **counts)
