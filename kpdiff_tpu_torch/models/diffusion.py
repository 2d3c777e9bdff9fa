"""KeypointDiffusion: training loss and sampling (kpdiff_tpu/models/diffusion.py).

The reverse-diffusion chain (the JAX package's jitted lax.scan) is
`start_chain`, K calls of `reverse_step` (a function of device tensors that
updates the chain in place) and `finish_chain`. On CUDA `sample` replays a
captured CUDA graph of the step K times (models/chain_graph.py), cached per
shape as the JAX serving API caches its executables; on the CPU, with
`cuda_graph=False` or under kp_shard it calls the step eagerly. Encode, the
kk edge structure, compact_kk, the training loss (noise l2, the receptor
encoder's OT loss and the optional receptor-ligand hinge) and the
p(z_s | z_t) update follow the JAX package step for step.

`encode` is differentiable, so that the loss trains the encoder. Which
path the dense edges take follows from autograd: while it records (the
training loss), `EGNNEdge` runs the kernel's plain version on its
parameters, as the JAX package trains through XLA; under `torch.no_grad()`
(sampling, serving, the held-out loss) every dense edge type goes through
the CUDA edge kernel, as the JAX package's sampler does with
`dynamics.use_pallas_sampling`. Callers that sample run encode, compact_kk
and sample under `torch.no_grad()`.

Every model family of `configs/` builds here: the EGNN or GVP dynamics
(`architecture`), a learned encoder or the fixed one (`rec_encoder_type`:
the keypoints are the pocket atoms and kk is the rr radius graph, so the
fixed families read graph_cutoffs['rr'] wherever the learned ones read
['kk']), and kk dense, as a neighbor list or in the banded block layout
(`dynamics.kk_layout`). GVP models carry keypoint vectors (`kp_v`) from the
encoder to the dynamics and apply their configured dropout in the training
loss, with masks drawn from the loss's torch.Generator.

`sample`, `loss` and `_apply_dynamics` take `kp_shard`, a
parallel/kp_shard.py::ShardContext (None: one device, unchanged). Sampling
is given this rank's part of an encoded complex (`shard_encoded`); the
loss encodes its batch rows unsharded on every rank of the 'model' axis
(so the OT loss sees every keypoint) and splits the keypoints after. The
ligand is replicated over the 'model' axis, and its noise identical there;
on the 'data' axis noise is drawn for the global batch and each rank takes
its rows.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from kpdiff_tpu_torch.losses.hinge import masked_hinge_loss
from kpdiff_tpu_torch.losses.ot import ot_loss
from kpdiff_tpu_torch.models.chain_graph import STATE, ChainGraphs
from kpdiff_tpu_torch.models.complex import PaddedComplex
from kpdiff_tpu_torch.models.dynamics_egnn import EGNNDynamics
from kpdiff_tpu_torch.models.dynamics_gvp import GVPDynamics
from kpdiff_tpu_torch.models.encoder_fixed import fixed_encode, fixed_kk_edges
from kpdiff_tpu_torch.models.nn import compute_dtype
from kpdiff_tpu_torch.ops.edge_sets import Blocks, as_kk, list_cap
from kpdiff_tpu_torch.ops.geometry import masked_com
from kpdiff_tpu_torch.ops.neighbors import dense_radius_adjacency, radius_neighbor_list
from kpdiff_tpu_torch.ops.spatial import block_radius_adjacency, choose_tile
from kpdiff_tpu_torch.ops.schedule import (
    NoiseSchedule,
    alpha_from_gamma,
    sigma_and_alpha_t_given_s,
    sigma_from_gamma,
)
from kpdiff_tpu_torch.utils.profiling import device_mark


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    atom_nf: int
    rec_nf: int
    n_timesteps: int = 1000
    precision: float = 1e-4
    noise_schedule: str = "polynomial_2"
    lig_feat_norm_constant: float = 1.0
    rl_dist_threshold: float = 0.0
    use_fake_atoms: bool = False
    fake_atom_loss_semantics: str = "intent"
    architecture: str = "egnn"
    rec_encoder_type: str = "fixed"
    graph_cutoffs: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"rr": 3.5, "rk": 100.0, "kk": 8.0, "kl": 8.0, "ll": 9.0})
    dynamics: Dict[str, Any] = dataclasses.field(default_factory=dict)
    rec_encoder: Dict[str, Any] = dataclasses.field(default_factory=dict)
    rec_encoder_loss: Dict[str, Any] = dataclasses.field(default_factory=dict)


def dynamics_from_config(cfg: DiffusionConfig, gen: torch.Generator):
    """EGNNDynamics or GVPDynamics with the options kpdiff_tpu's KeypointDiffusion reads."""
    dyn = dict(cfg.dynamics)
    if cfg.architecture == "gvp":
        return GVPDynamics(
            n_lig_scalars=cfg.atom_nf, n_kp_scalars=cfg.rec_nf, gen=gen,
            ll_cutoff=cfg.graph_cutoffs.get("ll", 9.0), kl_cutoff=cfg.graph_cutoffs.get("kl", 8.0),
            **{k: v for k, v in dyn.items() if k not in ("no_cg", "n_keypoints")})
    if cfg.architecture != "egnn":
        raise ValueError(cfg.architecture)
    return EGNNDynamics(
        atom_nf=cfg.atom_nf, rec_nf=cfg.rec_nf, gen=gen,
        n_layers=dyn.get("n_layers", 6), hidden_nf=dyn.get("hidden_nf", 256),
        use_tanh=dyn.get("use_tanh", False), message_norm=dyn.get("message_norm", 1),
        update_kp_feat=dyn.get("update_kp_feat", False), norm=dyn.get("norm", False),
        ll_k=dyn.get("ll_k", 0), kl_k=dyn.get("kl_k", 0),
        ll_cutoff=cfg.graph_cutoffs.get("ll", 9.0), kl_cutoff=cfg.graph_cutoffs.get("kl", 8.0),
        compute_dtype=dyn.get("compute_dtype", "float32"), z_semantics=dyn.get("z_semantics", "intent"),
        remat=dyn.get("remat", False),
    )


class KeypointDiffusion(nn.Module):
    """Keypoint diffusion: encode, compact_kk, sample, loss.

    Parameters are named as the JAX package's param tree
    (`encoder.*`, `dynamics.*`; a fixed encoder has none), so
    `utils/params_io.py` loads its archives."""

    def __init__(self, cfg: DiffusionConfig, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.schedule = NoiseSchedule.create(cfg.noise_schedule, cfg.n_timesteps, cfg.precision)
        gen = torch.Generator().manual_seed(seed)
        self.fixed = cfg.rec_encoder_type == "fixed"
        self.gvp = cfg.architecture == "gvp"
        enc = {k: v for k, v in cfg.rec_encoder.items() if k != "no_cg"}
        if cfg.rec_encoder_type == "learned" and not self.gvp:
            from kpdiff_tpu_torch.models.encoder_egnn import EGNNReceptorEncoder

            self.encoder = EGNNReceptorEncoder(gen, graph_cutoffs=cfg.graph_cutoffs, **enc)
        elif cfg.rec_encoder_type == "learned":
            from kpdiff_tpu_torch.models.encoder_gvp import GVPReceptorEncoder

            self.encoder = GVPReceptorEncoder(gen, graph_cutoffs=cfg.graph_cutoffs, **enc)
        elif self.fixed:
            self.encoder = None
        else:
            raise ValueError(cfg.rec_encoder_type)
        self.dynamics = dynamics_from_config(cfg, gen)
        self.cd = compute_dtype(cfg.dynamics.get("compute_dtype", "float32"))
        self._precast = None
        self.rec_loss_kwargs = dict(cfg.rec_encoder_loss)
        if self.fixed:
            self.rec_loss_kwargs["loss_type"] = "none"
        self.rec_loss_type = self.rec_loss_kwargs.get("loss_type", "none")
        self.rec_loss_use_ip = self.rec_loss_kwargs.get("use_interface_points", False)

    @property
    def kp_vec_dim(self):
        """Keypoint vector channels of a GVP model (the collation's kp_v); None for EGNN."""
        return self.cfg.rec_encoder.get("vector_size", 16) if self.gvp else None

    def _kk_cutoff(self) -> float:
        return self.cfg.graph_cutoffs["rr" if self.fixed else "kk"]

    # ---------------------------------------------------------------- encode

    def encode(self, cpx: PaddedComplex, dropout: bool = False, generator: Optional[torch.Generator] = None):
        """Encoder pass -> (complex with kp_* filled, kk edge structure).
        Differentiable; sampling callers run it under torch.no_grad().
        dropout=True (the training loss) applies a learned GVP encoder's
        dropout with masks drawn from `generator`."""
        if self.fixed:
            cpx = fixed_encode(cpx, n_vec_feats=self.cfg.rec_encoder.get("vector_size") if self.gvp else None,
                               sort_spatial=self.cfg.dynamics.get("kk_layout", "dense") == "block")
        elif self.gvp:
            cpx = self.encoder(cpx, dropout=dropout and self.cfg.rec_encoder.get("dropout", 0) > 0,
                               generator=generator)
        else:
            cpx = self.encoder(cpx)
        return cpx, self._kk_edges(cpx)

    def _kk_edges(self, cpx: PaddedComplex):
        """kk edges within the kk cutoff (rr for a fixed encoder): a dense
        (B, K, K) adjacency, a `NbrList` of at most 100 (layout 'nbr'), or
        the banded block layout `Blocks` (B, nt, 3 * tile, tile) over the
        spatially sorted keypoints (layout 'block')."""
        layout = self.cfg.dynamics.get("kk_layout", "dense")
        r = self._kk_cutoff()
        if layout == "block":
            tile = choose_tile(cpx.kp_x.shape[1], int(self.cfg.dynamics.get("kk_block_size", 64)))
            return Blocks(block_radius_adjacency(cpx.kp_x, cpx.kp_mask, r, tile))
        if self.fixed:
            return fixed_kk_edges(cpx, r, layout=layout)
        if layout == "dense":
            return dense_radius_adjacency(cpx.kp_x, cpx.kp_mask, cpx.kp_x, cpx.kp_mask, r, exclude_self=True)
        return radius_neighbor_list(cpx.kp_x, cpx.kp_mask, cpx.kp_x, cpx.kp_mask, r, 100, exclude_self=True)

    @torch.no_grad()
    def compact_kk(self, cpx: PaddedComplex, kk, align: int = 8, min_cap: int = 0):
        """Exact capped neighbor-list kk for sampling: the same edge set in a
        smaller layout when the max degree rounded up to `align` is below K;
        a dense adjacency unchanged otherwise. A block layout always becomes
        the exact radius graph's neighbor list (the block layout only covers
        the edges within its windows). `min_cap` pins a grow-only cap.
        The list is what serving counts (serve.kk_nbr_slots / _edges); the
        EGNN dynamics run it through the edge kernel's list mode where the
        kernel is taken, in plain PyTorch elsewhere (models/egnn.py)."""
        if list_cap(kk):
            return kk
        r = self._kk_cutoff()
        is_block = isinstance(kk, Blocks)
        adj = (dense_radius_adjacency(cpx.kp_x, cpx.kp_mask, cpx.kp_x, cpx.kp_mask, r, exclude_self=True)
               if is_block else kk)
        K = adj.shape[-1]
        deg = int(torch.max(torch.sum(adj, dim=-1)).item())
        cap = min(K, max(((deg + align - 1) // align) * align, align, min_cap))
        if cap >= K and not is_block:
            return kk
        return radius_neighbor_list(cpx.kp_x, cpx.kp_mask, cpx.kp_x, cpx.kp_mask, r, cap, exclude_self=True)

    def _apply_dynamics(self, dyn, lig_x, lig_h, lig_mask, kp_x, kp_h, kp_mask, t, kk, kp_v=None,
                        dropout: bool = False, generator: Optional[torch.Generator] = None, kp_shard=None):
        if self.gvp:
            return dyn(lig_x, lig_h, lig_mask, kp_x, kp_h, kp_mask, t, kk, kp_v, dropout=dropout,
                       generator=generator, kp_shard=kp_shard)
        return dyn(lig_x, lig_h, lig_mask, kp_x, kp_h, kp_mask, t, kk, kp_shard=kp_shard)

    def kp_row_parameters(self):
        """Parameters whose gradients a kp-sharded rank computes from its own
        keypoint rows only (summed over the 'model' group by the trainer)."""
        seen, out = set(), []
        for mod in self.dynamics.kp_row_modules():
            for p in mod.parameters():
                if id(p) not in seen:
                    seen.add(id(p))
                    out.append(p)
        return out

    # ------------------------------------------------------------------ loss

    def loss(self, cpx: PaddedComplex,
             t_eps_override: Optional[Tuple[Any, Any, Any]] = None,
             generator: Optional[torch.Generator] = None, kp_shard=None) -> Dict[str, torch.Tensor]:
        """Training losses (kpdiff_tpu/models/diffusion.py:281-399): l2, pos,
        feat, rec_encoder and, with rl_dist_threshold > 0, rl_hinge.

        `t_eps_override` = (t_int (B,), eps_x (B,N,3), eps_h (B,N,F)) replaces
        the draws of the timestep and the noise (the seam the tests use);
        otherwise they come from `generator` (a torch.Generator on the
        complex's device). GVP models with dropout in their config draw its
        masks from `generator` too, as the JAX loss samples dropout on every
        call (None: torch's default generator of the device).

        kp_shard (a ShardContext, kp_shard.py::kp_constraint): `cpx` holds
        this rank's batch rows (and so does `t_eps_override`); the keypoints
        are split over the 'model' axis after the encoder, and every loss is
        this rank's part of the global batch's loss times the 'data' axis
        size, so that their mean over the ranks is the global loss."""
        cfg = self.cfg
        b = cpx.batch_size
        dev = cpx.device
        f32 = torch.float32

        sh = kp_shard
        den = (lambda c: torch.clamp(c, min=1.0)) if sh is None else sh.mean_den
        cpx = cpx.replace(lig_h=cpx.lig_h / cfg.lig_feat_norm_constant)
        device_mark("encoder")  # the device timers' segments (utils/profiling.py): encoder, ot, then the dynamics'
        cpx, kk = self.encode(cpx, dropout=True, generator=generator)
        losses: Dict[str, torch.Tensor] = {"rec_encoder": self._rec_encoder_loss(cpx, sh)}

        lm = cpx.lig_mask[..., None].to(cpx.lig_x.dtype)
        km = cpx.kp_mask[..., None].to(cpx.kp_x.dtype)
        init_kp_com = masked_com(cpx.kp_x, cpx.kp_mask) if cfg.rl_dist_threshold > 0 else None

        com = masked_com(cpx.lig_x, cpx.lig_mask)
        lig_x = (cpx.lig_x - com[:, None]) * lm
        kp_x = (cpx.kp_x - com[:, None]) * km

        if t_eps_override is not None:
            t_int, eps_x, eps_h = device_t_eps(t_eps_override, dev)
            eps_x = eps_x.to(f32) * lm
            eps_h = eps_h.to(f32) * lm
        elif sh is None:
            t_int = torch.randint(0, cfg.n_timesteps, (b,), generator=generator, device=dev)
            eps_x = torch.randn(cpx.lig_x.shape, generator=generator, device=dev, dtype=f32) * lm
            eps_h = torch.randn(cpx.lig_h.shape, generator=generator, device=dev, dtype=f32) * lm
        else:  # drawn for the global batch, this rank's rows taken
            t_int = sh.local_batch(torch.randint(0, cfg.n_timesteps, sh.draw_shape((b,)), generator=generator,
                                                 device=dev))
            eps_x = sh.local_batch(torch.randn(sh.draw_shape(cpx.lig_x.shape), generator=generator, device=dev,
                                               dtype=f32)) * lm
            eps_h = sh.local_batch(torch.randn(sh.draw_shape(cpx.lig_h.shape), generator=generator, device=dev,
                                               dtype=f32)) * lm
        t = t_int.to(f32) / cfg.n_timesteps

        gamma_t = self.schedule.gamma(t)
        alpha_t = alpha_from_gamma(gamma_t)[:, None, None]
        sigma_t = sigma_from_gamma(gamma_t)[:, None, None]
        z_x = (alpha_t * lig_x + sigma_t * eps_x) * lm
        z_h = (alpha_t * cpx.lig_h + sigma_t * eps_h) * lm

        com2 = masked_com(z_x, cpx.lig_mask)
        z_x = (z_x - com2[:, None]) * lm
        kp_x = (kp_x - com2[:, None]) * km

        drop = self.gvp and self.cfg.dynamics.get("dropout", 0) > 0
        kp_in = cpx.replace(kp_x=kp_x)
        if sh is not None:  # this rank's keypoint rows; the hinge below reads them all
            kp_in, kk = sh.split(kp_in, kk)
        eps_h_pred, eps_x_pred = self._apply_dynamics(self.dynamics, z_x, z_h, cpx.lig_mask, kp_in.kp_x, kp_in.kp_h,
                                                      kp_in.kp_mask, t, kk, kp_in.kp_v, dropout=drop,
                                                      generator=generator, kp_shard=sh)

        # torch.where (selection), not mask multiplication: repeat-padded batch
        # rows have empty masks, the dynamics may give NaN there (0/0), and
        # NaN * 0 would poison the sums
        lig_sel = cpx.lig_mask[..., None]
        if cfg.use_fake_atoms:
            if cfg.fake_atom_loss_semantics == "executed":
                # the reference reads the noised features' last channel
                real = (cpx.lig_mask & (z_h[..., -1] != 0))[..., None]
            else:
                real = (cpx.lig_mask & (cpx.lig_h[..., -1] <= 0))[..., None]
            x_loss = torch.sum(torch.square(torch.where(real, eps_x - eps_x_pred, 0.0)))
            n_x = den(torch.sum(real.to(z_x.dtype)) * 3.0)
        else:
            x_loss = torch.sum(torch.square(torch.where(lig_sel, eps_x - eps_x_pred, 0.0)))
            n_x = den(torch.sum(lm) * 3.0)
        h_loss = torch.sum(torch.square(torch.where(lig_sel, eps_h - eps_h_pred, 0.0)))
        n_h = den(torch.sum(lm) * cpx.lig_h.shape[-1])

        losses["l2"] = (x_loss + h_loss) / (n_x + n_h)
        losses["pos"] = x_loss / n_x
        losses["feat"] = h_loss / n_h
        if cfg.rl_dist_threshold > 0:
            hinge = self._rl_hinge(cpx, z_x, eps_x_pred, gamma_t, kp_x, init_kp_com)
            losses["rl_hinge"] = hinge if sh is None else hinge * sh.data_size  # a sum over the batch
        return losses

    def _rec_encoder_loss(self, cpx: PaddedComplex, kp_shard=None) -> torch.Tensor:
        if self.rec_loss_type == "none":
            return torch.zeros((), dtype=cpx.rec_x.dtype, device=cpx.device)
        pts, pts_mask = (cpx.ip_x, cpx.ip_mask) if self.rec_loss_use_ip else (cpx.rec_x, cpx.rec_mask)
        kp_x, = device_mark("ot", cpx.kp_x)
        loss = ot_loss(kp_x, cpx.kp_mask, pts, pts_mask, **_ot_kwargs(self.rec_loss_kwargs),
                       den=None if kp_shard is None else kp_shard.mean_den)
        return device_mark("rest", loss)[0]

    def _rl_hinge(self, cpx, z_x, eps_x_pred, gamma_t, kp_x, init_kp_com):
        """Receptor-ligand clash hinge on the one-shot denoised ligand, moved
        back to the initial frame."""
        alpha_t = alpha_from_gamma(gamma_t)[:, None, None]
        sigma_t = sigma_from_gamma(gamma_t)[:, None, None]
        lig_denoised = (z_x - sigma_t * eps_x_pred) / alpha_t
        kp_com = masked_com(kp_x, cpx.kp_mask)
        lig_world = lig_denoised - kp_com[:, None] + init_kp_com[:, None]
        return masked_hinge_loss(lig_world, cpx.lig_mask, cpx.rec_x, cpx.rec_mask, self.cfg.rl_dist_threshold)

    # ---------------------------------------------------------------- sample

    def _sampling_dynamics(self):
        """The EGNN dynamics with pair-MLP weights cast to the compute dtype
        once (kpdiff_tpu's precast_pair_params): edge modules and node MLPs;
        the LayerNorms stay f32. Every use site casts to that dtype anyway.
        GVP dynamics sample as they are, as in the JAX package. The copy is
        keyed on the parameters' buffers and versions, as the captured
        graphs are (`_params_key`): a graph never reads a rebuilt copy."""
        if self.cd == torch.float32 or self.gvp:
            return self.dynamics
        key = tuple((p.data_ptr(), p._version) for p in self.dynamics.parameters())
        if self._precast is None or self._precast[0] != key:
            dyn = copy.deepcopy(self.dynamics)
            for i in range(dyn.n_layers):
                for name, mod in getattr(dyn, f"conv{i}").named_children():
                    if name.startswith("edge_"):
                        mod.to(self.cd)
                    elif name.startswith("update_"):
                        mod.node_mlp.to(self.cd)
            self._precast = (key, dyn)
        return self._precast[1]

    def _params_key(self):
        return tuple((p.data_ptr(), p._version) for p in self.parameters())

    @property
    def chain_graphs(self) -> ChainGraphs:
        """The captured reverse steps of this model (models/chain_graph.py)."""
        if "_chain_graphs" not in self.__dict__:
            self.__dict__["_chain_graphs"] = ChainGraphs()
        return self.__dict__["_chain_graphs"]

    @chain_graphs.setter
    def chain_graphs(self, graphs: ChainGraphs):
        self.__dict__["_chain_graphs"] = graphs

    @property
    def train_graphs(self):
        """The captured optimizer steps of this model (training/train_graph.py)."""
        if "_train_graphs" not in self.__dict__:
            from kpdiff_tpu_torch.training.train_graph import TrainGraphs

            self.__dict__["_train_graphs"] = TrainGraphs(name="train")
        return self.__dict__["_train_graphs"]

    @train_graphs.setter
    def train_graphs(self, graphs):
        self.__dict__["_train_graphs"] = graphs

    @property
    def loss_graphs(self):
        """The captured held-out losses of this model (training/train_graph.py::heldout_loss)."""
        if "_loss_graphs" not in self.__dict__:
            from kpdiff_tpu_torch.training.train_graph import TrainGraphs

            self.__dict__["_loss_graphs"] = TrainGraphs(name="loss")
        return self.__dict__["_loss_graphs"]

    @loss_graphs.setter
    def loss_graphs(self, graphs):
        self.__dict__["_loss_graphs"] = graphs

    @torch.no_grad()
    def sample(self, cpx: PaddedComplex, kk_edges, init_com: Optional[torch.Tensor] = None,
               return_every: int = 0, sample_steps: int = 0, eta: float = 1.0,
               noise: Optional[Dict[str, Any]] = None, generator: Optional[torch.Generator] = None,
               kp_shard=None, cuda_graph: Optional[bool] = None):
        """Reverse diffusion from encoded receptors.

        `sample_steps` K < T runs the strided grid; `eta` is the DDIM noise
        scale (1.0 keeps the ancestral step verbatim); `noise` replaces every
        draw (keys init_x, init_h, steps_x (K,B,N,3), steps_h (K,B,N,F));
        otherwise noise comes from `generator` (a torch.Generator on the
        complex's device). Returns lig_x, lig_h, kp_x, lig_mask and, with
        `return_every`, frames_x / frames_h.

        cuda_graph: None (the default) replays a captured CUDA graph of the
        reverse step (`reverse_step`, `chain_graphs`) on CUDA when no
        kp_shard is given, and runs eager on the CPU; False runs the step
        eagerly, launch by launch (what per-launch checks and profiles by
        module need); True asks for the graph and raises on CPU tensors or
        with a kp_shard. A sharded chain runs eager: its steps carry
        hand-written collectives, not yet captured. There is no fallback: a
        failure to capture or replay raises. Graph and eager run the same
        step function on the same inputs.

        kp_shard: the ShardContext of `shard_encoded` (or `data_shard`), whose
        complex and kk hold this rank's rows. Every rank of the 'model' axis
        needs a generator in the same state; `noise` may hold the global
        batch (each rank takes its rows) or this rank's rows. kp_x comes
        back with every (padded) keypoint."""
        if cuda_graph is None:
            cuda_graph = cpx.device.type == "cuda" and kp_shard is None
        elif cuda_graph and kp_shard is not None:
            raise ValueError("cuda_graph=True: a kp-sharded chain runs eager (its steps carry collectives)")
        dyn = self._sampling_dynamics()
        st, n_steps, init_kp_com = self.start_chain(cpx, kk_edges, init_com, sample_steps, noise, generator,
                                                    kp_shard)
        frames = []

        def keep_frame(i, state):
            if return_every and i % return_every == 0:
                frames.append(tuple(state[k].clone() for k in STATE))

        if cuda_graph:
            state = self.chain_graphs.run(
                st, lambda s: self.reverse_step(dyn, s, eta, generator), n_steps, key=(float(eta), str(self.cd)),
                params_key=self._params_key(), generator=generator if noise is None else None,
                after_step=keep_frame)
            st.update(state)
        else:
            for i in range(n_steps):
                self.reverse_step(dyn, st, eta, generator, kp_shard)
                keep_frame(i, st)
        return self.finish_chain(st, init_kp_com, frames, kp_shard)

    @torch.no_grad()
    def start_chain(self, cpx: PaddedComplex, kk_edges, init_com=None, sample_steps: int = 0,
                    noise: Optional[Dict[str, Any]] = None, generator: Optional[torch.Generator] = None,
                    kp_shard=None):
        """The reverse chain before its first step: (st, K, init_kp_com).

        st holds device tensors only: the state (lig_x, lig_h, kp_x), what
        the step reads (lig_mask, lm, km, kp_h, kp_mask, kp_v, kk), the
        schedule tables t, gamma_t, gamma_s (T = n_timesteps rows, the K
        steps' values first, so that one graph serves every K), the step
        index (1,) int64 at 0, and with `noise` the injected steps_x,
        steps_h. The initial draws come from `generator` here."""
        cfg = self.cfg
        dev = cpx.device
        f32 = torch.float32
        lm = cpx.lig_mask[..., None].to(f32)
        km = cpx.kp_mask[..., None].to(f32)
        sh = kp_shard

        def tensor(a, batch_dim=0):
            a = torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a, device=dev).to(f32)
            return a if sh is None else sh.local_batch(a, batch_dim)

        init_kp_com = self._kp_com(cpx.kp_x, cpx.kp_mask, sh)
        if init_com is None:
            any_rec = torch.any(cpx.rec_mask, dim=1, keepdim=True)
            init_com = torch.where(any_rec, masked_com(cpx.rec_x, cpx.rec_mask), init_kp_com)
        else:
            init_com = tensor(init_com)
        kp_x = (cpx.kp_x - init_com[:, None]) * km

        if noise is not None:
            lig_x = tensor(noise["init_x"]) * lm
            lig_h = tensor(noise["init_h"]) * lm
        else:
            lig_x = self._randn(cpx.lig_x.shape, generator, dev, sh) * lm
            lig_h = self._randn(cpx.lig_h.shape, generator, dev, sh) * lm
        com = masked_com(lig_x, cpx.lig_mask)
        lig_x = (lig_x - com[:, None]) * lm
        kp_x = (kp_x - com[:, None]) * km

        T = cfg.n_timesteps
        grid = self.chain_grid(sample_steps)
        k = len(grid) - 1
        t_int, s_int = np.zeros(T, np.float32), np.zeros(T, np.float32)
        t_int[:k], s_int[:k] = grid[:-1], grid[1:]
        t_tab = torch.as_tensor(t_int, device=dev) / T
        st = dict(lig_x=lig_x, lig_h=lig_h, kp_x=kp_x, lig_mask=cpx.lig_mask, lm=lm, km=km, kp_h=cpx.kp_h,
                  kp_mask=cpx.kp_mask, kp_v=cpx.kp_v, kk=as_kk(kk_edges), t=t_tab, gamma_t=self.schedule.gamma(t_tab),
                  gamma_s=self.schedule.gamma(torch.as_tensor(s_int, device=dev) / T),
                  index=torch.zeros(1, dtype=torch.int64, device=dev))
        if noise is not None:
            st["steps_x"], st["steps_h"] = tensor(noise["steps_x"], 1), tensor(noise["steps_h"], 1)
        return st, k, init_kp_com

    def chain_grid(self, sample_steps: int = 0) -> np.ndarray:
        """The chain's timesteps from T down to 0: the strided grid of
        `sample_steps` K < T steps, or every step; a chain of K steps runs
        len(grid) - 1 reverse steps."""
        T = self.cfg.n_timesteps
        if sample_steps and sample_steps < T:
            return np.unique(np.round(np.linspace(0, T, sample_steps + 1)).astype(np.int32))[::-1].copy()
        return np.arange(T, -1, -1)

    @torch.no_grad()
    def reverse_step(self, dyn, st: Dict[str, Any], eta: float = 1.0, generator: Optional[torch.Generator] = None,
                     kp_shard=None):
        """One step of p(z_s | z_t) on the chain `st` (`start_chain`) in place:
        reads its t and s through st["index"], updates lig_x, lig_h and kp_x
        and advances the index. Device tensors only, no host values that
        change from step to step, no synchronisation: the eager loop and the
        captured graph run this one function."""
        f32 = torch.float32
        i = st["index"]
        lig_x, lig_h, kp_x, lm, km = st["lig_x"], st["lig_h"], st["kp_x"], st["lm"], st["km"]
        rows = i.expand(lig_x.shape[0])
        t_arr = st["t"].index_select(0, rows)
        gamma_t = st["gamma_t"].index_select(0, rows)
        gamma_s = st["gamma_s"].index_select(0, rows)
        sigma2_ts, sigma_ts, alpha_ts = sigma_and_alpha_t_given_s(gamma_t, gamma_s)
        sigma_s = sigma_from_gamma(gamma_s)
        sigma_t = sigma_from_gamma(gamma_t)

        eps_h, eps_x = self._apply_dynamics(dyn, lig_x, lig_h, st["lig_mask"], kp_x, st["kp_h"], st["kp_mask"],
                                            t_arr, st["kk"], st["kp_v"], kp_shard=kp_shard)

        if eta == 1.0:
            # reference ancestral step, kept verbatim
            var_term = (sigma2_ts / alpha_ts / sigma_t)[:, None, None]
            a_ts = alpha_ts[:, None, None]
            mu_x = lig_x / a_ts - var_term * eps_x
            mu_h = lig_h / a_ts - var_term * eps_h
            sigma = (sigma_ts * sigma_s / sigma_t)[:, None, None]
        else:
            alpha_s = alpha_from_gamma(gamma_s)[:, None, None]
            alpha_t = alpha_from_gamma(gamma_t)[:, None, None]
            sig_t = sigma_t[:, None, None]
            sig_s = sigma_s[:, None, None]
            sig_n = eta * (sigma_ts * sigma_s / sigma_t)[:, None, None]
            dir_coef = torch.sqrt(torch.clamp(sig_s ** 2 - sig_n ** 2, min=0.0))
            mu_x = alpha_s * (lig_x - sig_t * eps_x) / alpha_t + dir_coef * eps_x
            mu_h = alpha_s * (lig_h - sig_t * eps_h) / alpha_t + dir_coef * eps_h
            sigma = sig_n

        if "steps_x" in st:
            n_x, n_h = st["steps_x"].index_select(0, i)[0], st["steps_h"].index_select(0, i)[0]
        else:
            n_x = self._randn(lig_x.shape, generator, lig_x.device, kp_shard)
            n_h = self._randn(lig_h.shape, generator, lig_x.device, kp_shard)
        new_x = (mu_x + sigma * n_x) * lm
        new_h = (mu_h + sigma * n_h) * lm

        com = masked_com(new_x, st["lig_mask"])
        lig_x.copy_((new_x - com[:, None]) * lm)
        lig_h.copy_(new_h)
        kp_x.copy_((kp_x - com[:, None]) * km)
        i.add_(1)

    def finish_chain(self, st: Dict[str, Any], init_kp_com: torch.Tensor, frames=(), kp_shard=None):
        """The chain's outputs from its final state: back to the input frame,
        features unnormalised, fake atoms masked, frames (F x (lig_x, lig_h,
        kp_x) states) in the input frame."""
        cfg = self.cfg
        sh = kp_shard
        lm, km, lig_mask, kp_mask = st["lm"], st["km"], st["lig_mask"], st["kp_mask"]
        final_com = self._kp_com(st["kp_x"], kp_mask, sh)
        lig_x = (st["lig_x"] - final_com[:, None] + init_kp_com[:, None]) * lm
        kp_x = (st["kp_x"] - final_com[:, None] + init_kp_com[:, None]) * km
        if sh is not None:
            kp_x = sh.gather(kp_x)
        lig_h = st["lig_h"] * cfg.lig_feat_norm_constant

        out = {"lig_x": lig_x, "lig_h": lig_h, "kp_x": kp_x, "lig_mask": lig_mask}
        if cfg.use_fake_atoms:
            out["lig_mask"] = remove_fake_atoms(lig_h, lig_mask)
        if frames:
            f_x = torch.stack([f[0] for f in frames])
            f_h = torch.stack([f[1] for f in frames])
            f_kp_com = torch.stack([self._kp_com(f[2], kp_mask, sh) for f in frames])  # (F, B, 3)
            out["frames_x"] = (f_x - f_kp_com[:, :, None] + init_kp_com[None, :, None]) * lm[None]
            out["frames_h"] = f_h * cfg.lig_feat_norm_constant
        return out

    @staticmethod
    def _kp_com(kp_x, kp_mask, kp_shard=None):
        return masked_com(kp_x, kp_mask) if kp_shard is None else kp_shard.masked_com(kp_x, kp_mask)

    @staticmethod
    def _randn(shape, generator, dev, kp_shard=None):
        """Standard normal draws in f32; with kp_shard drawn for the global
        batch and this rank's rows taken."""
        if kp_shard is None:
            return torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        return kp_shard.local_batch(torch.randn(kp_shard.draw_shape(shape), generator=generator, device=dev,
                                                dtype=torch.float32))


def device_t_eps(t_eps, device):
    """Injected (t_int, eps_x, eps_h), arrays or tensors, as tensors on `device` (None stays None)."""
    if t_eps is None:
        return None
    return tuple(torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a, device=device) for a in t_eps)


def _ot_kwargs(loss_cfg: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in loss_cfg.items() if k in ("method", "sinkhorn_eps", "sinkhorn_iters")}


def remove_fake_atoms(lig_h: torch.Tensor, lig_mask: torch.Tensor) -> torch.Tensor:
    """Mask out atoms whose argmax feature is the fake-atom class (last channel)."""
    fake = torch.argmax(lig_h, dim=-1) == (lig_h.shape[-1] - 1)
    return lig_mask & ~fake
