"""The plain float32 reference of the sampled path: the model from a
configuration dict, its weights read from the same archive the program
reads, padding and collation, the encoder, the kk edges, one reverse step
on given noise, and the chain's finish and decode.

Everything here is a frozen copy of the port's plain modules (see the other
files of this folder) with no kernel dispatch, or written out from the
program's documented algebra (`reverse_step`, `finish`). It imports nothing
of the program: what the program derived (padded arrays, encoded keypoints,
kk edges, schedule tables, packed weights) is worked out again here.
`RefModel(config, control=True)` builds the control: the same model with
every bfloat16 site of the configuration in fp8 (precision.py).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from portbench.reference import precision
from portbench.reference.complex import PaddedComplex, make_complex
from portbench.reference.geometry import masked_com
from portbench.reference.neighbors import dense_radius_adjacency
from portbench.reference.schedule import NoiseSchedule, alpha_from_gamma, sigma_and_alpha_t_given_s, sigma_from_gamma


@dataclasses.dataclass(frozen=True)
class Padding:
    """Static capacities of the padded complex (learned encoders)."""

    n_rec: int
    n_lig: int
    n_kp: int
    n_ip: int

    @staticmethod
    def from_config(config: Dict[str, Any]) -> "Padding":
        pad = config.get("padding", {})
        return Padding(n_rec=pad.get("n_rec", 384), n_lig=pad.get("n_lig", 64),
                       n_kp=config.get("graph", {}).get("n_keypoints", 20), n_ip=pad.get("n_ip", 64))


def feature_sizes(config: Dict[str, Any]):
    """(n_rec_feat, n_lig_feat, n_kp_feat) of a learned-encoder configuration without fake atoms."""
    ds = config["dataset"]
    if config["diffusion"].get("rec_encoder_type", "learned") != "learned":
        raise ValueError("the reference covers learned encoders")
    if ds.get("max_fake_atom_frac", 0.0) > 0:
        raise ValueError("the reference covers configurations without fake atoms")
    arch = config["diffusion"].get("architecture", "egnn")
    n_kp = (config["rec_encoder"]["out_n_node_feat"] if arch == "egnn"
            else config["rec_encoder_gvp"]["out_scalar_size"])
    return len(ds["rec_elements"]), len(ds["lig_elements"]), n_kp


def pad_pocket(rec_pos, rec_feat, rec_res_idx, interface_points, n_lig: int, n_lig_feat: int,
               pad: Padding, bucket: int) -> Dict[str, np.ndarray]:
    """One pocket and an empty ligand of n_lig atoms as padded arrays (ligand
    capacity `bucket`)."""
    n_rec, n_ip = rec_pos.shape[0], interface_points.shape[0]
    if n_rec > pad.n_rec or n_ip > pad.n_ip or n_lig > bucket:
        raise ValueError("pocket or ligand beyond the padding capacities")

    def padded(a, n, feat=None):
        out = np.zeros((n, feat if feat is not None else a.shape[1]), np.float32)
        out[: a.shape[0], : a.shape[1]] = a
        return out

    return dict(
        lig_x=np.zeros((bucket, 3), np.float32), lig_h=np.zeros((bucket, n_lig_feat), np.float32),
        lig_mask=np.arange(bucket) < n_lig,
        rec_x=padded(rec_pos.astype(np.float32), pad.n_rec), rec_h=padded(rec_feat.astype(np.float32), pad.n_rec),
        rec_mask=np.arange(pad.n_rec) < n_rec,
        rec_res_idx=np.pad(rec_res_idx.astype(np.int32), (0, pad.n_rec - n_rec)),
        ip_x=padded(interface_points.astype(np.float32), pad.n_ip), ip_mask=np.arange(pad.n_ip) < n_ip)


_KEYSTR_PART = re.compile(r"\['([^']*)'\]")


def read_archive(path) -> Dict[str, np.ndarray]:
    """{dotted parameter name: array} of a keystr-keyed npz archive."""
    with np.load(path) as z:
        return {".".join(_KEYSTR_PART.findall(k)): z[k] for k in z.files}


class RefModel(nn.Module):
    """Encoder and dynamics of a learned-encoder configuration, parameters
    named as the archives name them (`encoder.*`, `dynamics.*`)."""

    def __init__(self, config: Dict[str, Any], control: bool = False):
        super().__init__()
        from portbench.reference.dynamics_egnn import EGNNDynamics
        from portbench.reference.dynamics_gvp import GVPDynamics
        from portbench.reference.encoder_egnn import EGNNReceptorEncoder
        from portbench.reference.encoder_gvp import GVPReceptorEncoder

        self.config = config
        self.control = control
        diff = config["diffusion"]
        self.gvp = diff.get("architecture", "egnn") == "gvp"
        n_rec_feat, self.n_lig_feat, n_kp_feat = feature_sizes(config)
        graph = config["graph"]
        self.cutoffs = dict(graph["graph_cutoffs"])
        self.n_kp = graph.get("n_keypoints", 20)
        self.T = diff.get("n_timesteps", 1000)
        self.schedule = NoiseSchedule.create(diff.get("noise_schedule", "polynomial_2"), self.T,
                                             diff.get("precision", 1e-4))
        self.lig_norm = diff.get("lig_feat_norm_constant", 1)
        gen = torch.Generator().manual_seed(0)  # overwritten by the archive
        ctx = precision.control_sites() if control else _nothing()
        with ctx:
            if self.gvp:
                enc = dict(config["rec_encoder_gvp"], in_scalar_size=n_rec_feat, n_keypoints=self.n_kp)
                dyn = dict(config["dynamics_gvp"])
                self.encoder = GVPReceptorEncoder(gen, graph_cutoffs=self.cutoffs, **enc)
                self.dynamics = GVPDynamics(
                    n_lig_scalars=self.n_lig_feat, n_kp_scalars=n_kp_feat, gen=gen,
                    ll_cutoff=self.cutoffs.get("ll", 9.0), kl_cutoff=self.cutoffs.get("kl", 8.0),
                    **{k: v for k, v in dyn.items() if k not in ("no_cg", "n_keypoints")})
            else:
                enc = dict(config["rec_encoder"], in_n_node_feat=n_rec_feat, n_keypoints=self.n_kp)
                d = config["dynamics"]
                self.encoder = EGNNReceptorEncoder(gen, graph_cutoffs=self.cutoffs, **enc)
                self.dynamics = EGNNDynamics(
                    atom_nf=self.n_lig_feat, rec_nf=n_kp_feat, gen=gen, n_layers=d.get("n_layers", 6),
                    hidden_nf=d.get("hidden_nf", 256), use_tanh=d.get("use_tanh", False),
                    message_norm=d.get("message_norm", 1), update_kp_feat=d.get("update_kp_feat", False),
                    norm=d.get("norm", False), ll_k=d.get("ll_k", 0), kl_k=d.get("kl_k", 0),
                    ll_cutoff=self.cutoffs.get("ll", 9.0), kl_cutoff=self.cutoffs.get("kl", 8.0),
                    compute_dtype=d.get("compute_dtype", "float32"), z_semantics=d.get("z_semantics", "intent"))
        self.kp_vec_dim = config["rec_encoder_gvp"].get("vector_size", 16) if self.gvp else None
        dyn_cfg = config["dynamics_gvp" if self.gvp else "dynamics"]
        if dyn_cfg.get("kk_layout", "dense") != "dense":
            raise ValueError("the reference builds the dense kk layout")

    def load(self, flat: Dict[str, np.ndarray]):
        params = dict(self.named_parameters())
        if set(params) != set(flat):
            raise KeyError(f"archive and reference differ: {sorted(set(params) ^ set(flat))[:6]}")
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(torch.from_numpy(np.array(flat[name], np.float32)))
        return self

    def _mode(self):
        return precision.FP8Sites() if self.control else _nothing()

    # ---------------------------------------------------------------- encode

    @torch.no_grad()
    def encode(self, items: List[Dict[str, np.ndarray]], device, kp_pos: Optional[torch.Tensor] = None) -> PaddedComplex:
        """Padded items -> complex with the encoder's keypoints (kp_x, kp_h,
        kp_v); with `kp_pos` (B, K, 3) the keypoint features at those positions."""
        st = {k: np.stack([it[k] for it in items]) for k in items[0]}
        cpx = make_complex(st["rec_x"], st["rec_h"], st["rec_mask"], st["lig_x"], st["lig_h"], st["lig_mask"],
                           n_kp=self.n_kp, kp_feat_dim=1, kp_vec_dim=self.kp_vec_dim,
                           rec_res_idx=st["rec_res_idx"], ip_x=st["ip_x"], ip_mask=st["ip_mask"], device=device)
        with self._mode():
            return self.encoder(cpx, kp_pos_given=kp_pos)

    def kk_adjacency(self, kp_x: torch.Tensor, kp_mask: torch.Tensor) -> torch.Tensor:
        """The dense kk radius graph (B, K, K) of keypoints."""
        return dense_radius_adjacency(kp_x, kp_mask, kp_x, kp_mask, self.cutoffs["kk"], exclude_self=True)

    # ------------------------------------------------------------------ chain

    def grid(self, sample_steps: int) -> np.ndarray:
        """The descending timestep grid of a chain of `sample_steps` steps (0: all T)."""
        T = self.T
        if sample_steps and sample_steps < T:
            return np.unique(np.round(np.linspace(0, T, sample_steps + 1)).astype(np.int32))[::-1].copy()
        return np.arange(T, -1, -1)

    @torch.no_grad()
    def reverse_step(self, state: Dict[str, torch.Tensor], static: Dict[str, Any], t_int: int, s_int: int,
                     n_x: torch.Tensor, n_h: torch.Tensor, eta: float = 1.0):
        """One step of p(z_s | z_t) from `state` (lig_x, lig_h, kp_x) with the
        noise (n_x, n_h); static: lig_mask, kp_h, kp_mask, kp_v, kk. Returns
        (new state, the dynamics' share of the move (B, N, 3 + F))."""
        f32 = torch.float32
        lig_x, lig_h, kp_x = state["lig_x"], state["lig_h"], state["kp_x"]
        b = lig_x.shape[0]
        lig_mask = static["lig_mask"]
        lm = lig_mask[..., None].to(f32)
        km = static["kp_mask"][..., None].to(f32)
        dev = lig_x.device
        t = torch.full((b,), t_int / self.T, dtype=f32, device=dev)
        s = torch.full((b,), s_int / self.T, dtype=f32, device=dev)
        gamma_t, gamma_s = self.schedule.gamma(t), self.schedule.gamma(s)
        sigma2_ts, sigma_ts, alpha_ts = sigma_and_alpha_t_given_s(gamma_t, gamma_s)
        sigma_s, sigma_t = sigma_from_gamma(gamma_s), sigma_from_gamma(gamma_t)
        with self._mode():
            if self.gvp:
                eps_h, eps_x = self.dynamics(lig_x, lig_h, lig_mask, kp_x, static["kp_h"], static["kp_mask"], t,
                                             static["kk"], static["kp_v"])
            else:
                eps_h, eps_x = self.dynamics(lig_x, lig_h, lig_mask, kp_x, static["kp_h"], static["kp_mask"], t,
                                             static["kk"])
        eps_h, eps_x = eps_h.float(), eps_x.float()
        if eta == 1.0:
            var_term = (sigma2_ts / alpha_ts / sigma_t)[:, None, None]
            a_ts = alpha_ts[:, None, None]
            mu_x, mu_h = lig_x / a_ts - var_term * eps_x, lig_h / a_ts - var_term * eps_h
            dyn_x, dyn_h = var_term * eps_x, var_term * eps_h
            sigma = (sigma_ts * sigma_s / sigma_t)[:, None, None]
        else:
            alpha_s = alpha_from_gamma(gamma_s)[:, None, None]
            alpha_t = alpha_from_gamma(gamma_t)[:, None, None]
            sig_t, sig_s = sigma_t[:, None, None], sigma_s[:, None, None]
            sigma = eta * (sigma_ts * sigma_s / sigma_t)[:, None, None]
            dir_coef = torch.sqrt(torch.clamp(sig_s ** 2 - sigma ** 2, min=0.0))
            coef = dir_coef - alpha_s * sig_t / alpha_t
            mu_x = alpha_s * lig_x / alpha_t + coef * eps_x
            mu_h = alpha_s * lig_h / alpha_t + coef * eps_h
            dyn_x, dyn_h = coef * eps_x, coef * eps_h
        new_x = (mu_x + sigma * n_x) * lm
        new_h = (mu_h + sigma * n_h) * lm
        com = masked_com(new_x, lig_mask)
        out = dict(lig_x=(new_x - com[:, None]) * lm, lig_h=new_h, kp_x=(kp_x - com[:, None]) * km)
        return out, torch.cat([dyn_x, dyn_h], dim=-1) * lm

    def finish(self, state: Dict[str, torch.Tensor], lig_mask: torch.Tensor, kp_mask: torch.Tensor,
               init_kp_com: torch.Tensor):
        """The chain's outputs in the input frame: (lig_x, lig_h)."""
        lm = lig_mask[..., None].to(torch.float32)
        final_com = masked_com(state["kp_x"], kp_mask)
        lig_x = (state["lig_x"] - final_com[:, None] + init_kp_com[:, None]) * lm
        return lig_x, state["lig_h"] * self.lig_norm


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def load_reference(config: Dict[str, Any], archive: Optional[Dict[str, np.ndarray]], device,
                   control: bool = False, seed: int = 0) -> RefModel:
    """The reference (or the control) on `device`, weights from `archive`
    ({name: array}); None draws them from `seed` (the tests' tiny models)."""
    model = RefModel(config, control=control)
    if archive is None:
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    else:
        model.load(archive)
    return model.to(device).eval()
