"""Optimal-transport receptor-encoder loss (kpdiff_tpu/losses/ot.py).

Per graph the cost is the squared distance between keypoints and targets
(pocket atoms or interface points) under uniform marginals; the transport
plan is a constant for autodiff, and the loss is sum(plan * cost) averaged
over the graphs that have both keypoints and targets. Two plans:
  * 'sinkhorn': entropy-regularised, log domain, on the tensors' device;
  * 'exact': the C++ network simplex (native/emd.py) on the host, graph by
    graph.
"""
from __future__ import annotations

import numpy as np
import torch

_NEG = -1e30


def _pair_cost(kp_x: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Squared euclidean cost (B, K, P)."""
    return torch.sum(torch.square(kp_x[:, :, None, :] - pts[:, None, :, :]), dim=-1)


@torch.no_grad()
def sinkhorn_plan(cost: torch.Tensor, col_mask: torch.Tensor, row_mask: torch.Tensor | None = None,
                  eps: float = 0.05, iters: int = 100) -> torch.Tensor:
    """Log-domain Sinkhorn with uniform marginals over the valid rows and
    columns; the cost is scaled per graph by its largest valid entry."""
    b, k, p = cost.shape
    if row_mask is None:
        row_mask = torch.ones((b, k), dtype=torch.bool, device=cost.device)
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


def exact_plan(cost: torch.Tensor, col_mask: torch.Tensor, row_mask: torch.Tensor) -> torch.Tensor:
    """Exact plans (B, K, P) f32 on the cost's device, solved on the host;
    graphs without valid rows or columns get a zero plan."""
    from kpdiff_tpu_torch.native.emd import exact_emd_plan

    c = cost.detach().cpu().numpy()
    rm, cm = row_mask.cpu().numpy(), col_mask.cpu().numpy()
    b, k, p = c.shape
    out = np.zeros((b, k, p), np.float32)
    for i in range(b):
        if rm[i].any() and cm[i].any():
            sel = np.ix_(rm[i], cm[i])
            out[i][sel] = exact_emd_plan(c[i][sel].astype(np.float64))
    return torch.from_numpy(out).to(cost.device)


def ot_loss(kp_x: torch.Tensor, kp_mask: torch.Tensor, pts: torch.Tensor, pts_mask: torch.Tensor,
            method: str = "sinkhorn", sinkhorn_eps: float = 0.05, sinkhorn_iters: int = 100,
            den=None) -> torch.Tensor:
    """Batched OT loss, mean over the graphs with keypoints and targets.
    `den(count)` replaces the clamped count of such graphs (a data-parallel
    rank's share of the global count: ShardContext.mean_den)."""
    cost = _pair_cost(kp_x, pts)
    if method == "sinkhorn":
        plan = sinkhorn_plan(cost, pts_mask, kp_mask, eps=sinkhorn_eps, iters=sinkhorn_iters)
    elif method == "exact":
        plan = exact_plan(cost, pts_mask, kp_mask)
    else:
        raise ValueError(method)
    per_graph = torch.sum(plan.detach() * cost, dim=(1, 2))
    # repeat-padded batch rows have empty masks: they are left out of the mean
    valid = (torch.sum(pts_mask, dim=1) > 0) & (torch.sum(kp_mask, dim=1) > 0)
    per_graph = torch.where(valid, per_graph, 0.0)
    n = torch.sum(valid)
    return torch.sum(per_graph) / (torch.clamp(n, min=1) if den is None else den(n))
