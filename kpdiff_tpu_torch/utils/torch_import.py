"""Reference-checkpoint import: the upstream PyTorch state_dict -> the
flax-named parameter tree that `utils/params_io.load_params` loads into
the port's modules (a copy of kpdiff_tpu/utils/torch_import.py).

The upstream repository ships torch state_dicts keyed by its own module
paths (models/dynamics.py, models/receptor_encoder.py,
models/receptor_encoder_gvp.py, models/dynamics_gvp.py). Its first
edge/coord Linear takes concat(h_src, h_dst, dij); the port factorises it
into per-node projections, so that weight (H, 2F+1+E) is split column-wise
into w_src / w_dst / w_dij. torch Linear weights are (out, in), the port
keeps flax's (in, out): they are transposed.

Covered: EGNN dynamics (all edge types, node updates, layer norms,
encoders and decoders), the learned EGNN receptor encoder, GVP dynamics and
the learned GVP receptor encoder; fixed-encoder models have no encoder
parameters. `convert_reference_checkpoint(sd, model)` assembles a complete
tree from a full state_dict for the port's KeypointDiffusion:

    sd = {k: v.numpy() for k, v in torch.load("model.pt", map_location="cpu").items()}
    model = model_from_config(config)  # with the overrides below
    load_params(model, convert_reference_checkpoint(sd, model))

Parity notes for imported checkpoints (both found by executing the
upstream modules; PARITY.md deviations 10-11):
  * EGNN dynamics: set `dynamics.z_semantics: executed` — the upstream's
    message_norm=0 normalisation is a lost write in its executed DGL code,
    so shipped EGNN checkpoints were trained WITHOUT z-normalisation in
    the dynamics.
  * Learned encoders (EGNN and GVP): set
    `rec_encoder.attn_semantics: executed` — the upstream's keypoint
    attention never exponentiates the edge numerators, so shipped
    learned-encoder checkpoints position keypoints with raw-dot / sum-exp
    weights, not a softmax.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def _t(w):
    return np.asarray(w).T.copy()


def convert_egnn_dynamics_state_dict(
    sd: Dict[str, np.ndarray],
    n_layers: int,
    update_kp_feat: bool,
    rec_nf: int,
    hidden_nf: int,
) -> Dict:
    """Upstream LigRecDynamics state_dict -> params['dynamics'] tree."""
    F = hidden_nf + 1  # feature width inside the EGNN (t channel appended)
    out: Dict = {}

    def mlp(prefix_ref, idxs=(0, 2)):
        return {
            f"lin{i}": {"kernel": _t(sd[f"{prefix_ref}.{j}.weight"]), "bias": np.asarray(sd[f"{prefix_ref}.{j}.bias"])}
            for i, j in enumerate(idxs)
        }

    out["lig_encoder"] = mlp("lig_encoder")
    out["lig_decoder"] = mlp("lig_decoder")
    if rec_nf != hidden_nf:
        out["kp_encoder"] = mlp("rec_encoder")

    etypes = ["ll", "kl", "lk", "kk"] if update_kp_feat else ["ll", "kl"]
    ntypes = ["lig", "kp"] if update_kp_feat else ["lig"]

    for i in range(n_layers):
        layer: Dict = {}
        base = f"egnn.conv_layers.{i}"
        for et in etypes:
            e: Dict = {}
            w1 = np.asarray(sd[f"{base}.edge_mlp.{et}.0.weight"])  # (H, 2F+1)
            e["edge_w_src"] = _t(w1[:, :F])
            e["edge_w_dst"] = _t(w1[:, F : 2 * F])
            e["edge_w_dij"] = _t(w1[:, 2 * F :])
            e["edge_b"] = np.asarray(sd[f"{base}.edge_mlp.{et}.0.bias"])
            e["edge_lin2_w"] = _t(sd[f"{base}.edge_mlp.{et}.2.weight"])
            e["edge_lin2_b"] = np.asarray(sd[f"{base}.edge_mlp.{et}.2.bias"])
            e["attn_w"] = _t(sd[f"{base}.soft_attention.{et}.0.weight"])
            e["attn_b"] = np.asarray(sd[f"{base}.soft_attention.{et}.0.bias"])
            c1 = np.asarray(sd[f"{base}.coord_mlp.{et}.0.weight"])
            e["coord_w_src"] = _t(c1[:, :F])
            e["coord_w_dst"] = _t(c1[:, F : 2 * F])
            e["coord_w_dij"] = _t(c1[:, 2 * F :])
            e["coord_b"] = np.asarray(sd[f"{base}.coord_mlp.{et}.0.bias"])
            e["coord_lin2_w"] = _t(sd[f"{base}.coord_mlp.{et}.2.weight"])
            e["coord_lin2_b"] = np.asarray(sd[f"{base}.coord_mlp.{et}.2.bias"])
            e["coord_out_w"] = _t(sd[f"{base}.coord_mlp.{et}.4.weight"])
            layer[f"edge_{et}"] = e
        for nt in ntypes:
            upd: Dict = {"node_mlp": mlp(f"{base}.node_mlp.{nt}")}
            ln_w = sd.get(f"{base}.layer_norm.{nt}.weight")
            if ln_w is not None:
                upd["LayerNorm_0"] = {
                    "scale": np.asarray(ln_w),
                    "bias": np.asarray(sd[f"{base}.layer_norm.{nt}.bias"]),
                }
            layer[f"update_{nt}"] = upd
        out[f"conv{i}"] = layer
    return out


def convert_egnn_encoder_state_dict(
    sd: Dict[str, np.ndarray],
    n_convs: int,
    hidden: int,
    out_feat: int,
    in_feat: int,
    use_sameres_feat: bool,
    fix_pos: bool,
    norm: bool,
) -> Dict:
    """Reference ReceptorEncoder state_dict -> params['encoder'] tree
    (receptor_encoder.py:381-555 module structure)."""
    E = 1 if use_sameres_feat else 0
    out: Dict = {}

    for i in range(n_convs):
        base = f"rec_convs.{i}"
        F = in_feat if i == 0 else hidden
        conv: Dict = {}
        e: Dict = {}
        w1 = np.asarray(sd[f"{base}.edge_mlp.0.weight"])  # (H, 2F+1+E)
        e["edge_w_src"] = _t(w1[:, :F])
        e["edge_w_dst"] = _t(w1[:, F : 2 * F])
        e["edge_w_dij"] = _t(w1[:, 2 * F :])
        e["edge_b"] = np.asarray(sd[f"{base}.edge_mlp.0.bias"])
        e["edge_lin2_w"] = _t(sd[f"{base}.edge_mlp.2.weight"])
        e["edge_lin2_b"] = np.asarray(sd[f"{base}.edge_mlp.2.bias"])
        e["attn_w"] = _t(sd[f"{base}.soft_attention.0.weight"])
        e["attn_b"] = np.asarray(sd[f"{base}.soft_attention.0.bias"])
        if not fix_pos:
            c1 = np.asarray(sd[f"{base}.coord_mlp.0.weight"])
            e["coord_w_src"] = _t(c1[:, :F])
            e["coord_w_dst"] = _t(c1[:, F : 2 * F])
            e["coord_w_dij"] = _t(c1[:, 2 * F :])
            e["coord_b"] = np.asarray(sd[f"{base}.coord_mlp.0.bias"])
            e["coord_out_w"] = _t(sd[f"{base}.coord_mlp.2.weight"])
        conv["edge_rr"] = e
        conv["node_mlp"] = {
            f"lin{j}": {"kernel": _t(sd[f"{base}.node_mlp.{k}.weight"]),
                        "bias": np.asarray(sd[f"{base}.node_mlp.{k}.bias"])}
            for j, k in enumerate((0, 2))
        }
        if norm:
            conv["LayerNorm_0"] = {
                "scale": np.asarray(sd[f"{base}.layer_norm.weight"]),
                "bias": np.asarray(sd[f"{base}.layer_norm.bias"]),
            }
        out[f"rec_conv{i}"] = conv

    out["keypoint_embedding"] = {
        "kernel": _t(sd["keypoint_embedding.0.weight"]),
        "bias": np.asarray(sd["keypoint_embedding.0.bias"]),
    }
    out["rk_fc_src"] = {"kernel": _t(sd["rec_kp_conv.fc_src.weight"])}
    out["rk_fc_dst"] = {"kernel": _t(sd["rec_kp_conv.fc_dst.weight"])}
    out["kp_feature_mlp"] = {
        "kernel": _t(sd["rec_kp_conv.kp_feature_mlp.0.weight"]),
        "bias": np.asarray(sd["rec_kp_conv.kp_feature_mlp.0.bias"]),
    }
    if norm:
        out["kp_feature_norm"] = {
            "scale": np.asarray(sd["rec_kp_conv.layer_norm.weight"]),
            "bias": np.asarray(sd["rec_kp_conv.layer_norm.bias"]),
        }
    return out


def _gvp_params(sd: Dict[str, np.ndarray], prefix: str) -> Dict:
    """One reference GVP module (gvp.py:43-87: Wh/Wu plain Parameters in
    (in, out) orientation; to_feats_out + scalar_to_vector_gates are torch
    Linears, transposed)."""
    return {
        "Wh": np.asarray(sd[f"{prefix}.Wh"]),
        "Wu": np.asarray(sd[f"{prefix}.Wu"]),
        "to_feats_out": {
            "kernel": _t(sd[f"{prefix}.to_feats_out.0.weight"]),
            "bias": np.asarray(sd[f"{prefix}.to_feats_out.0.bias"]),
        },
        "scalar_to_vector_gates": {
            "kernel": _t(sd[f"{prefix}.scalar_to_vector_gates.weight"]),
            "bias": np.asarray(sd[f"{prefix}.scalar_to_vector_gates.bias"]),
        },
    }


def _feat_norm(sd, prefix):
    return {"LayerNorm_0": {"scale": np.asarray(sd[f"{prefix}.feat_norm.weight"]),
                            "bias": np.asarray(sd[f"{prefix}.feat_norm.bias"])}}


def convert_gvp_dynamics_state_dict(
    sd: Dict[str, np.ndarray],
    n_convs: int,
    update_kp: bool,
    n_message_gvps: int,
    n_update_gvps: int,
    n_noise_gvps: int,
) -> Dict:
    """Reference LigRecDynamicsGVP state_dict -> params['dynamics'] tree
    (module structure: dynamics_gvp.py:104-147; conv layers under
    noise_predictor.conv_layers, final block under
    noise_predictor.noise_predictor)."""
    out: Dict = {}
    out["lig_enc"] = {"kernel": _t(sd["lig_encoder.0.weight"]), "bias": np.asarray(sd["lig_encoder.0.bias"])}
    out["LayerNorm_0"] = {"scale": np.asarray(sd["lig_encoder.2.weight"]), "bias": np.asarray(sd["lig_encoder.2.bias"])}
    out["kp_enc"] = {"kernel": _t(sd["kp_encoder.0.weight"]), "bias": np.asarray(sd["kp_encoder.0.bias"])}
    out["LayerNorm_1"] = {"scale": np.asarray(sd["kp_encoder.2.weight"]), "bias": np.asarray(sd["kp_encoder.2.bias"])}

    no_kp = [("lig", "ll", "lig"), ("kp", "kl", "lig")]
    with_kp = no_kp + [("lig", "lk", "kp"), ("kp", "kk", "kp")]
    for i in range(n_convs):
        etypes = with_kp if (update_kp and i != n_convs - 1) else no_kp
        base = f"noise_predictor.conv_layers.{i}"
        conv: Dict = {}
        for src, ename, dst in etypes:
            key = f"{src}_{ename}_{dst}"
            conv[f"message_{ename}"] = {"message": {
                f"gvp{j}": _gvp_params(sd, f"{base}.edge_message_fns.{key}.{j}")
                for j in range(n_message_gvps)
            }}
        for nt in sorted({e[2] for e in etypes}):
            conv[f"update_{nt}"] = {f"gvp{j}": _gvp_params(sd, f"{base}.node_update_fns.{nt}.{j}")
                                    for j in range(n_update_gvps)}
            conv[f"msg_norm_{nt}"] = _feat_norm(sd, f"{base}.message_layer_norms.{nt}")
            conv[f"upd_norm_{nt}"] = _feat_norm(sd, f"{base}.update_layer_norms.{nt}")
        out[f"conv{i}"] = conv

    npb = {f"gvp{j}": _gvp_params(sd, f"noise_predictor.noise_predictor.gvps.{j}") for j in range(n_noise_gvps)}
    npb["to_scalar_output"] = {
        "kernel": _t(sd["noise_predictor.noise_predictor.to_scalar_output.weight"]),
        "bias": np.asarray(sd["noise_predictor.noise_predictor.to_scalar_output.bias"]),
    }
    out["noise_predictor"] = npb
    return out


def convert_gvp_encoder_state_dict(
    sd: Dict[str, np.ndarray],
    n_rr_convs: int,
    n_rk_convs: int,
    n_message_gvps: int,
    n_update_gvps: int,
) -> Dict:
    """Reference ReceptorEncoderGVP state_dict -> params['encoder'] tree
    (receptor_encoder_gvp.py:97-211 module structure)."""
    out: Dict = {}
    out["scalar_embed"] = {
        f"lin{i}": {"kernel": _t(sd[f"scalar_embed.{j}.weight"]), "bias": np.asarray(sd[f"scalar_embed.{j}.bias"])}
        for i, j in enumerate((0, 2))
    }
    out["scalar_norm"] = {"scale": np.asarray(sd["scalar_norm.weight"]), "bias": np.asarray(sd["scalar_norm.bias"])}

    def conv(prefix):
        c: Dict = {}
        c["edge"] = {"message": {f"gvp{j}": _gvp_params(sd, f"{prefix}.edge_message.{j}")
                                 for j in range(n_message_gvps)}}
        c["update"] = {f"gvp{j}": _gvp_params(sd, f"{prefix}.node_update.{j}") for j in range(n_update_gvps)}
        c["message_norm"] = _feat_norm(sd, f"{prefix}.message_layer_norm")
        c["update_norm"] = _feat_norm(sd, f"{prefix}.update_layer_norm")
        return c

    for i in range(n_rr_convs):
        out[f"rr_conv{i}"] = conv(f"rr_conv_layers.{i}")
    for i in range(n_rk_convs):
        out[f"rk_conv{i}"] = conv(f"rk_conv_layers.{i}")

    ki = "keypoint_initializer"
    out["keypoint_embedding"] = {
        "kernel": _t(sd[f"{ki}.keypoint_embedding.0.weight"]),
        "bias": np.asarray(sd[f"{ki}.keypoint_embedding.0.bias"]),
    }
    out["keypoint_embedding_norm"] = {
        "scale": np.asarray(sd[f"{ki}.keypoint_embedding.2.weight"]),
        "bias": np.asarray(sd[f"{ki}.keypoint_embedding.2.bias"]),
    }
    out["src_net"] = {"kernel": _t(sd[f"{ki}.src_net.weight"])}
    out["dst_net"] = {"kernel": _t(sd[f"{ki}.dst_net.weight"])}
    return out


def convert_reference_checkpoint(sd: Dict[str, np.ndarray], model) -> Dict:
    """Full state_dict (keys 'dynamics.*', 'rec_encoder.*') -> params.

    `model` is the port's KeypointDiffusion (for config introspection);
    returns {'dynamics': ..., 'encoder': ...} ('encoder' for learned
    encoders only), the tree `utils/params_io.load_params` takes.
    """
    cfg = model.cfg
    dyn_sd = {k[len("dynamics."):]: v for k, v in sd.items() if k.startswith("dynamics.")}
    if cfg.architecture == "egnn":
        params = {
            "dynamics": convert_egnn_dynamics_state_dict(
                dyn_sd,
                n_layers=cfg.dynamics.get("n_layers", 6),
                update_kp_feat=cfg.dynamics.get("update_kp_feat", False),
                rec_nf=cfg.rec_nf,
                hidden_nf=cfg.dynamics.get("hidden_nf", 256),
            )
        }
    else:
        params = {
            "dynamics": convert_gvp_dynamics_state_dict(
                dyn_sd,
                n_convs=cfg.dynamics.get("n_convs", 6),
                update_kp=cfg.dynamics.get("update_kp", False),
                n_message_gvps=cfg.dynamics.get("n_message_gvps", 3),
                n_update_gvps=cfg.dynamics.get("n_update_gvps", 2),
                n_noise_gvps=cfg.dynamics.get("n_noise_gvps", 3),
            )
        }
    if cfg.rec_encoder_type == "learned":
        enc_sd = {k[len("rec_encoder."):]: v for k, v in sd.items() if k.startswith("rec_encoder.")}
        enc = cfg.rec_encoder
        if cfg.architecture == "gvp":
            params["encoder"] = convert_gvp_encoder_state_dict(
                enc_sd,
                n_rr_convs=enc.get("n_rr_convs", 3),
                n_rk_convs=enc.get("n_rk_convs", 2),
                n_message_gvps=enc.get("n_message_gvps", 1),
                n_update_gvps=enc.get("n_update_gvps", 1),
            )
        else:
            params["encoder"] = convert_egnn_encoder_state_dict(
                enc_sd,
                n_convs=enc.get("n_convs", 6),
                hidden=enc.get("hidden_n_node_feat", 256),
                out_feat=enc.get("out_n_node_feat", 256),
                in_feat=enc.get("in_n_node_feat", 10),
                use_sameres_feat=enc.get("use_sameres_feat", False),
                fix_pos=enc.get("fix_pos", False),
                norm=enc.get("norm", False),
            )
    return params
