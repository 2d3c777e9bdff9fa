"""The yardstick's arithmetic: model operations of a reverse step counted
from shapes on the active pairs and nodes, the dense EGNN edge kernel's
least time (bytes and operations), and the chip's peaks (peaks.json).

Operations are the matrix products' multiply-adds times two, counted once
for the algorithm: a first layer factorised into per-node products
(W [h_src, h_dst, d] = W_s h_src + W_d h_dst + w d) counts its per-node
products once per node. Pairs are those an edge set's mask makes active;
nodes those the masks keep.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

ELEMENTWISE_OPS = 16  # CUDA-core f32 ops per pair element of the edge kernel's two chains (silu, sums, gate)


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    """Published peaks of the card named `device_name`, or None for a card the table lacks."""
    table = json.loads((Path(__file__).parent / "peaks.json").read_text())
    for key, row in table.items():
        if not key.startswith("_") and key in device_name:
            return row
    return None


def row_stride(h: int) -> int:
    """The kernel's a_* row stride: h rounded up to a multiple of 8 elements."""
    return (h + 7) // 8 * 8


def edge_kernel_bound_s(batch: int, n_src: int, n_dst: int, h: int, pairs: int, peak: Dict[str, float]) -> float:
    """Least time of one dense EGNN edge launch (bfloat16, both chains): the
    larger of the bytes (every input read once, every output written once)
    over HBM bandwidth and the operations (the two H x H second layers on
    the active pairs on the tensor cores, the elementwise work on the CUDA
    cores, two units that run at once, so the larger of the two)."""
    matmul = pairs * 2 * 2 * h * h
    elementwise = pairs * 2 * h * ELEMENTWISE_OPS
    rows = 2 * batch * (n_src + n_dst) * row_stride(h) * 2  # a_e*, a_c* rows of both chains, bf16
    weights = 2 * (h * h * 2) + 9 * h * 4  # two packed second layers, the f32 vectors
    coords = batch * (n_src + n_dst) * 3 * 4 + batch * n_src * n_dst  # positions, adjacency
    out = batch * n_dst * (h + 3) * 4
    t_ops = max(matmul / peak["bf16_flops_per_s"], elementwise / peak["f32_flops_per_s"])
    t_bytes = (rows + weights + coords + out) / peak["hbm_bytes_per_s"]
    return max(t_ops, t_bytes)


# ------------------------------------------------------------------ EGNN


def egnn_pair_flops(h: int) -> int:
    """Per active pair of an EGNN edge set: both chains' second layers (H x H),
    the gate and the coordinate output (H x 1), the distance rows (1 x H)."""
    return 2 * (2 * h * h) + 2 * h + 2 * h + 2 * (2 * h)


def egnn_node_first_flops(h_in: int, h: int) -> int:
    """Per node and side of an edge set: both chains' first-layer products."""
    return 2 * (2 * h_in * h)


def egnn_step_flops(model: Dict, n_lig: int, n_kp: int, ll_pairs: int, kl_pairs: int, kk_pairs: int) -> int:
    """Model operations of one EGNN dynamics call over a batch with n_lig
    ligand atoms and n_kp keypoints in all (masked), and the active pairs of
    each edge set summed over the batch (kl_pairs counts kl; lk has as many)."""
    d = model["dynamics"]
    hidden = d.get("hidden_nf", 256)
    h = hidden + 1  # the t-channel
    atom_nf = len(model["dataset"]["lig_elements"])
    rec_nf = model["rec_encoder"]["out_n_node_feat"]
    total = n_lig * 2 * (atom_nf * 64 + 64 * hidden)  # ligand encoder
    if rec_nf != hidden:
        total += n_kp * 2 * (rec_nf * 2 * rec_nf + 2 * rec_nf * hidden)  # keypoint encoder
    update_kp = d.get("update_kp_feat", False)
    per_layer = (ll_pairs + kl_pairs) * egnn_pair_flops(h)
    per_layer += egnn_node_first_flops(h, h) * (2 * n_lig + n_kp + n_lig)  # ll both sides, kl both sides
    per_layer += n_lig * 2 * (2 * h * h + h * h)  # ligand node update (2H -> H -> H)
    if update_kp:
        per_layer += (kl_pairs + kk_pairs) * egnn_pair_flops(h)
        per_layer += egnn_node_first_flops(h, h) * (n_lig + n_kp + 2 * n_kp)  # lk, kk both sides
        per_layer += n_kp * 2 * (2 * h * h + h * h)  # keypoint node update
    total += d.get("n_layers", 6) * per_layer
    total += n_lig * 2 * (hidden * 2 * atom_nf + 2 * atom_nf * atom_nf)  # decoder
    return int(total)


# ------------------------------------------------------------------- GVP


def gvp_flops(v_in: int, v_out: int, f_in: int, f_out: int, dim_h: Optional[int] = None, gating: bool = True) -> int:
    """One geometric vector perceptron on one element: Wh and Wu on the three
    components, the scalar output layer over [scalars, |Vh|], the gates."""
    dim_h = dim_h or max(v_in, v_out)
    flops = 2 * 3 * v_in * dim_h + 2 * 3 * dim_h * v_out + 2 * (f_in + dim_h) * f_out
    return flops + (2 * f_out * v_out if gating else 0)


def gvp_message_flops(s: int, v: int, n_gvps: int, rbf: int = 16):
    """(per pair, per source node) operations of one edge type's message chain:
    the first GVP's per-node pieces (source scalars and vectors) once per
    node, its per-pair pieces (the rbf and the unit offset) per pair."""
    dim_h = v + 1
    first_pair = 2 * 3 * 1 * dim_h + 2 * 3 * dim_h * v + 2 * (rbf + dim_h) * s + 2 * s * v
    first_node = 2 * 3 * v * dim_h + 2 * s * s
    rest = (n_gvps - 1) * gvp_flops(v, v, s, s)
    return first_pair + rest, first_node


def gvp_step_flops(model: Dict, n_lig: int, n_kp: int, ll_pairs: int, kl_pairs: int, kk_pairs: int) -> int:
    """Model operations of one GVP dynamics call, counted as egnn_step_flops."""
    d = model["dynamics_gvp"]
    s, v = d.get("n_hidden_scalars", 128), d.get("vector_size", 16)
    atom_nf = len(model["dataset"]["lig_elements"])
    rec_nf = model["rec_encoder_gvp"]["out_scalar_size"]
    pair, node = gvp_message_flops(s, v, d.get("n_message_gvps", 3))
    update = d.get("n_update_gvps", 2) * gvp_flops(v, v, s, s)
    n_convs = d.get("n_convs", 4)
    total = n_lig * 2 * (atom_nf + 1) * s + n_kp * 2 * (rec_nf + 1) * s  # scalar encoders
    for i in range(n_convs):
        kp_edges = d.get("update_kp", False) and i != n_convs - 1
        total += (ll_pairs + kl_pairs) * pair + (n_lig + n_kp) * node + n_lig * update
        if kp_edges:
            total += (kl_pairs + kk_pairs) * pair + (n_lig + n_kp) * node + n_kp * update
    n_noise = d.get("n_noise_gvps", 3)
    total += n_lig * ((n_noise - 1) * gvp_flops(v, v, s, s) + gvp_flops(v, 1, s, 64, gating=True) + 2 * 64 * atom_nf)
    return int(total)


def step_flops(model: Dict, **counts) -> int:
    """The configuration's reverse-step operations (EGNN or GVP dynamics)."""
    arch = model["diffusion"].get("architecture", "egnn")
    return (gvp_step_flops if arch == "gvp" else egnn_step_flops)(model, **counts)
