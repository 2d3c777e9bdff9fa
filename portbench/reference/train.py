"""The plain float32 reference of the train step: the batches of the loader
worked out again from the raw complexes (a frozen copy of the port's
PaddedLoader epoch with drop_last), the training loss (noise l2 plus the
receptor encoder's Sinkhorn OT loss, a frozen copy of the port's
losses/ot.py), its gradients by autograd, the value clip, coupled weight
decay and Adam, at the learning rate and OT weight of the schedule (a
frozen copy of the port's training/scheduler.py). The timestep and noise of
each step are given (the benchmark draws them and hands the same to the
program)."""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench.reference.complex import PaddedComplex, make_complex
from portbench.reference.geometry import masked_com
from portbench.reference.model import Padding, RefModel
from portbench.reference.schedule import alpha_from_gamma, sigma_from_gamma

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
_NEG = -1e30


# ------------------------------------------------------------------ data


def pad_complex(c: Dict[str, np.ndarray], pad: Padding, bucket: int) -> Dict[str, np.ndarray]:
    n_lig, n_rec, n_ip = len(c["lig_pos"]), len(c["rec_pos"]), len(c["interface_points"])

    def padded(a, n):
        out = np.zeros((n, a.shape[1]), np.float32)
        out[: a.shape[0]] = a
        return out

    return dict(lig_x=padded(c["lig_pos"], bucket), lig_h=padded(c["lig_feat"], bucket),
                lig_mask=np.arange(bucket) < n_lig, rec_x=padded(c["rec_pos"], pad.n_rec),
                rec_h=padded(c["rec_feat"], pad.n_rec), rec_mask=np.arange(pad.n_rec) < n_rec,
                rec_res_idx=np.pad(c["rec_res_idx"], (0, pad.n_rec - n_rec)).astype(np.int32),
                ip_x=padded(c["interface_points"], pad.n_ip), ip_mask=np.arange(pad.n_ip) < n_ip)


def epoch_batches(complexes: Sequence[Dict[str, np.ndarray]], rng: np.random.Generator, pad: Padding,
                  buckets: List[int], batch_size: int) -> Iterator[List[Dict[str, np.ndarray]]]:
    """One shuffled epoch of full batches, each complex in the smallest ligand
    bucket that fits, a batch yielded when its bucket fills."""
    bufs: Dict[int, list] = {}
    for i in rng.permutation(len(complexes)):
        c = complexes[int(i)]
        n = len(c["lig_pos"])
        bucket = next((b for b in buckets if n <= b), None)
        if bucket is None or len(c["rec_pos"]) > pad.n_rec or len(c["interface_points"]) > pad.n_ip:
            continue
        buf = bufs.setdefault(bucket, [])
        buf.append(pad_complex(c, pad, bucket))
        if len(buf) == batch_size:
            yield buf
            bufs[bucket] = []


def collate(items, model: RefModel, device) -> PaddedComplex:
    st = {k: np.stack([it[k] for it in items]) for k in items[0]}
    return make_complex(st["rec_x"], st["rec_h"], st["rec_mask"], st["lig_x"], st["lig_h"], st["lig_mask"],
                        n_kp=model.n_kp, kp_feat_dim=1, kp_vec_dim=model.kp_vec_dim, rec_res_idx=st["rec_res_idx"],
                        ip_x=st["ip_x"], ip_mask=st["ip_mask"], device=device)


# ------------------------------------------------------------------ loss


def sinkhorn_plan(cost, col_mask, row_mask, eps: float = 0.05, iters: int = 100):
    b, k, p = cost.shape
    n_rows = torch.clamp(torch.sum(row_mask, dim=1), min=1).to(cost.dtype)
    n_cols = torch.clamp(torch.sum(col_mask, dim=1), min=1).to(cost.dtype)
    log_a = torch.where(row_mask, -torch.log(n_rows)[:, None], _NEG)
    log_b = torch.where(col_mask, -torch.log(n_cols)[:, None], _NEG)
    valid = col_mask[:, None, :] & row_mask[:, :, None]
    scale = torch.clamp(torch.amax(torch.where(valid, cost, 0.0), dim=(1, 2)), min=1e-8)
    log_k = torch.where(valid, -cost / (eps * scale[:, None, None]), _NEG)
    f = torch.zeros((b, k), dtype=cost.dtype, device=cost.device)
    g = torch.zeros((b, p), dtype=cost.dtype, device=cost.device)
    for _ in range(iters):
        f = torch.where(row_mask, log_a - torch.logsumexp(log_k + g[:, None, :], dim=2), _NEG)
        g = torch.where(col_mask, log_b - torch.logsumexp(log_k + f[:, :, None], dim=1), _NEG)
    return torch.exp(torch.clamp(log_k + f[:, :, None] + g[:, None, :], min=_NEG))


def ot_loss(kp_x, kp_mask, pts, pts_mask, sinkhorn_eps: float = 0.05, sinkhorn_iters: int = 100):
    cost = torch.sum(torch.square(kp_x[:, :, None, :] - pts[:, None, :, :]), dim=-1)
    with torch.no_grad():
        plan = sinkhorn_plan(cost, pts_mask, kp_mask, sinkhorn_eps, sinkhorn_iters)
    per_graph = torch.sum(plan * cost, dim=(1, 2))
    valid = (torch.sum(pts_mask, dim=1) > 0) & (torch.sum(kp_mask, dim=1) > 0)
    per_graph = torch.where(valid, per_graph, 0.0)
    return torch.sum(per_graph) / torch.clamp(torch.sum(valid), min=1)


def loss(model: RefModel, cpx: PaddedComplex, t_int, eps_x, eps_h) -> Dict[str, torch.Tensor]:
    """l2 and rec_encoder of the training loss (learned encoder, no fake atoms, no hinge)."""
    f32 = torch.float32
    cfg = model.config
    cpx = cpx.replace(lig_h=cpx.lig_h / model.lig_norm)
    with model._mode():
        cpx = model.encoder(cpx)
    kk = model.kk_adjacency(cpx.kp_x, cpx.kp_mask)
    rl = cfg["rec_encoder_loss"]
    pts, pts_mask = (cpx.ip_x, cpx.ip_mask) if rl.get("use_interface_points", False) else (cpx.rec_x, cpx.rec_mask)
    rec = ot_loss(cpx.kp_x, cpx.kp_mask, pts, pts_mask, rl.get("sinkhorn_eps", 0.05), rl.get("sinkhorn_iters", 100))
    lm = cpx.lig_mask[..., None].to(f32)
    km = cpx.kp_mask[..., None].to(f32)
    com = masked_com(cpx.lig_x, cpx.lig_mask)
    lig_x = (cpx.lig_x - com[:, None]) * lm
    kp_x = (cpx.kp_x - com[:, None]) * km
    eps_x, eps_h = eps_x.to(f32) * lm, eps_h.to(f32) * lm
    t = t_int.to(f32) / model.T
    gamma_t = model.schedule.gamma(t)
    alpha_t = alpha_from_gamma(gamma_t)[:, None, None]
    sigma_t = sigma_from_gamma(gamma_t)[:, None, None]
    z_x = (alpha_t * lig_x + sigma_t * eps_x) * lm
    z_h = (alpha_t * cpx.lig_h + sigma_t * eps_h) * lm
    com2 = masked_com(z_x, cpx.lig_mask)
    z_x = (z_x - com2[:, None]) * lm
    kp_x = (kp_x - com2[:, None]) * km
    with model._mode():
        if model.gvp:
            eps_h_pred, eps_x_pred = model.dynamics(z_x, z_h, cpx.lig_mask, kp_x, cpx.kp_h, cpx.kp_mask, t, kk,
                                                    cpx.kp_v)
        else:
            eps_h_pred, eps_x_pred = model.dynamics(z_x, z_h, cpx.lig_mask, kp_x, cpx.kp_h, cpx.kp_mask, t, kk)
    sel = cpx.lig_mask[..., None]
    x_loss = torch.sum(torch.square(torch.where(sel, eps_x - eps_x_pred.float(), 0.0)))
    h_loss = torch.sum(torch.square(torch.where(sel, eps_h - eps_h_pred.float(), 0.0)))
    n_x = torch.clamp(torch.sum(lm) * 3.0, min=1.0)
    n_h = torch.clamp(torch.sum(lm) * cpx.lig_h.shape[-1], min=1.0)
    return {"l2": (x_loss + h_loss) / (n_x + n_h), "rec_encoder": rec}


# -------------------------------------------------------------- schedule


def learning_rate(tr: Dict[str, Any], epoch_exact: float) -> float:
    f = np.float32
    sched = tr.get("scheduler", {})
    base = f(tr.get("learning_rate", 1e-4))
    warmup = sched.get("warmup_length", 0)
    restart = sched.get("restart_interval", 0)
    e = f(epoch_exact)
    warm = base * e / f(max(warmup, 1e-9))
    if restart > 0:
        into = np.fmod(e - f(warmup), f(restart))
        if into < 0:
            into = into + f(restart)
        if sched.get("restart_type", "cosine") == "linear":
            after = base * (f(1.0) - into / f(restart))
        else:
            after = f(0.5) * base * (f(1.0) + np.cos(into * f(math.pi) / f(restart)))
    else:
        after = base
    return float(warm) if warmup > 0 and e <= f(warmup) else float(after)


def rec_encoder_weight(tr: Dict[str, Any], epoch_exact: float) -> float:
    f = np.float32
    sched = tr.get("scheduler", {})
    w = f(tr.get("rec_encoder_loss_weight", 0.1))
    mid = sched.get("rec_enc_weight_decay_midpoint", 0)
    if mid == 0:
        return float(w)
    coeff = f(1.0) - f(1.0) / (f(1.0) + np.exp(-(f(epoch_exact) - f(mid)) * f(sched.get("rec_enc_weight_decay_scale", 1))))
    return float(coeff * w)


# ------------------------------------------------------------------ step


class Trainer:
    """The reference's optimizer steps on its own parameters (per leaf)."""

    def __init__(self, model: RefModel, iters_per_epoch: int):
        self.model = model
        self.tr = model.config["training"]
        self.ipe = iters_per_epoch
        self.step_count = 0
        self.params = dict(model.named_parameters())
        self.m = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.first_grad: Optional[Dict[str, torch.Tensor]] = None

    def step(self, cpx: PaddedComplex, t_eps: Tuple[torch.Tensor, ...]) -> Dict[str, float]:
        epoch_exact = float(np.float32(self.step_count) / np.float32(self.ipe))
        w_rec, lr = rec_encoder_weight(self.tr, epoch_exact), learning_rate(self.tr, epoch_exact)
        for p in self.params.values():
            p.grad = None
        losses = loss(self.model, cpx, *t_eps)
        total = losses["l2"] + w_rec * losses["rec_encoder"]
        total.backward()
        clip = self.tr.get("clip_value", 1.5) if self.tr.get("clip_grad", True) else None
        wd = self.tr.get("weight_decay", 1e-12)
        b1, b2 = ADAM_BETAS
        t = self.step_count + 1
        grads = {}
        with torch.no_grad():
            for n, p in self.params.items():
                g = torch.zeros_like(p) if p.grad is None else p.grad.clone()
                if clip is not None:
                    g = torch.clamp(g, -clip, clip)
                g = g + wd * p
                grads[n] = g
                self.m[n] = self.m[n] * b1 + (1 - b1) * g
                self.v[n] = self.v[n] * b2 + (1 - b2) * g * g
                denom = torch.sqrt(self.v[n]) / math.sqrt(1 - b2 ** t) + ADAM_EPS
                p -= (lr / (1 - b1 ** t)) * self.m[n] / denom
        if self.first_grad is None:
            self.first_grad = grads
        self.step_count += 1
        return {"total": float(total.detach()), "l2": float(losses["l2"].detach()),
                "rec_encoder": float(losses["rec_encoder"].detach())}
