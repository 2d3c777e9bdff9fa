"""The port's training losses against kpdiff_tpu on the CPU: the hinge
losses, the Sinkhorn and exact OT plans and losses, KeypointDiffusion.loss
on a reduced egnn_40kp config with the same weights, batch and injected
(t, eps) in both packages, and the gradients of the total loss over every
parameter leaf against jax.grad.

Tolerances: f32 rtol 1e-4, atol 1e-5. bf16: max abs error at most 2e-2 of
the output's (or gradient leaf's) max abs value.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kpdiff_tpu.losses import hinge as jhinge, ot as jot
from kpdiff_tpu_torch.losses import hinge as thinge, ot as tot
from kpdiff_tpu_torch.native import emd
from torch_port_util import CASES, assert_close, case_setup, jax_flat, jax_t_eps, t

F32 = dict(rtol=1e-4, atol=1e-5)
BF16_REL = 2e-2
W_REC = 0.1


def _points(seed, B=3, K=6, P=14):
    rng = np.random.default_rng(seed)
    kp = rng.normal(size=(B, K, 3)).astype(np.float32)
    pts = (rng.normal(size=(B, P, 3)) * 2).astype(np.float32)
    kmask = np.ones((B, K), bool)
    kmask[1, 4:] = False
    pmask = np.ones((B, P), bool)
    pmask[0, 9:] = False
    pmask[2] = False  # an empty graph: a repeat-padded batch row
    return kp, kmask, pts, pmask


# ----------------------------------------------------------------- hinge

@pytest.mark.parametrize("threshold", [2.0, 4.0])
def test_masked_hinge_loss_matches_jax(threshold):
    kp, kmask, pts, pmask = _points(0)
    want = jhinge.masked_hinge_loss(jnp.asarray(kp), jnp.asarray(kmask), jnp.asarray(pts), jnp.asarray(pmask),
                                    threshold)
    got = thinge.masked_hinge_loss(t(kp), t(kmask), t(pts), t(pmask), threshold)
    assert float(want) > 0
    assert_close(got, want, **F32)


@pytest.mark.parametrize("threshold", [2.0, 4.0])
def test_masked_self_hinge_loss_matches_jax(threshold):
    _, _, pts, pmask = _points(1)
    want = jhinge.masked_self_hinge_loss(jnp.asarray(pts), jnp.asarray(pmask), threshold)
    got = thinge.masked_self_hinge_loss(t(pts), t(pmask), threshold)
    assert float(want) > 0
    assert_close(got, want, **F32)


# -------------------------------------------------------------------- OT

def test_sinkhorn_plan_and_marginals_match_jax():
    kp, kmask, pts, pmask = _points(2)
    cost = jot._pair_cost(jnp.asarray(kp), jnp.asarray(pts))
    tcost = tot._pair_cost(t(kp), t(pts))
    assert_close(tcost, cost, **F32)
    want = jot.sinkhorn_plan(cost, jnp.asarray(pmask), jnp.asarray(kmask), eps=0.05, iters=100)
    got = tot.sinkhorn_plan(tcost, t(pmask), t(kmask), eps=0.05, iters=100)
    assert_close(got, want, **F32)
    plan = got.numpy()
    for b in range(2):  # graphs with keypoints and targets: uniform marginals
        nr, nc = kmask[b].sum(), pmask[b].sum()
        np.testing.assert_allclose(plan[b].sum(1)[kmask[b]], 1.0 / nr, rtol=1e-3)
        np.testing.assert_allclose(plan[b].sum(0)[pmask[b]], 1.0 / nc, rtol=1e-3)
        assert plan[b][~kmask[b]].max(initial=0.0) == 0.0 and plan[b][:, ~pmask[b]].max(initial=0.0) == 0.0


def test_exact_plan_matches_linprog_and_jax():
    """The C++ network simplex against scipy's LP (its plain version) and the
    JAX package's exact plan: equal transport costs (degenerate problems may
    have several optimal plans)."""
    kp, kmask, pts, pmask = _points(3)
    cost = tot._pair_cost(t(kp), t(pts))
    got = tot.exact_plan(cost, t(pmask), t(kmask)).numpy()
    want = np.asarray(jot.exact_plan(jnp.asarray(cost.numpy()), jnp.asarray(pmask), jnp.asarray(kmask)))
    c = cost.numpy().astype(np.float64)
    for b in range(3):
        if not pmask[b].any():
            assert not got[b].any()
            continue
        sub = np.ix_(kmask[b], pmask[b])
        lp = emd.linprog_plan(c[b][sub])
        np.testing.assert_allclose((got[b][sub] * c[b][sub]).sum(), (lp * c[b][sub]).sum(), rtol=1e-6)
        np.testing.assert_allclose((got[b] * c[b]).sum(), (want[b] * c[b]).sum(), rtol=1e-6)
        np.testing.assert_allclose(got[b][sub].sum(0), 1.0 / pmask[b].sum(), atol=1e-6)


def test_emd_build_raises_without_compiler(monkeypatch, tmp_path):
    """No fallback: a failed build raises instead of switching solvers."""
    monkeypatch.setattr(emd, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises((RuntimeError, OSError)):
        emd.build()


@pytest.mark.parametrize("method", ["sinkhorn", "exact"])
def test_ot_loss_and_gradient_match_jax(method):
    """Loss and d loss / d keypoints: the plan is a constant, so the gradient
    flows through the cost only, in both packages."""
    kp, kmask, pts, pmask = _points(4)
    args = (jnp.asarray(kmask), jnp.asarray(pts), jnp.asarray(pmask))
    want, want_g = jax.value_and_grad(lambda x: jot.ot_loss(x, *args, method=method))(jnp.asarray(kp))
    x = t(kp).requires_grad_()
    got = tot.ot_loss(x, t(kmask), t(pts), t(pmask), method=method)
    got.backward()
    assert_close(got, want, **F32)
    assert_close(x.grad, want_g, **F32)
    # through the cost only: the gradient of sum(plan * cost) with the plan held fixed
    cost = tot._pair_cost(t(kp), t(pts))
    plan = (tot.sinkhorn_plan(cost, t(pmask), t(kmask)) if method == "sinkhorn"
            else tot.exact_plan(cost, t(pmask), t(kmask)))
    x2 = t(kp).requires_grad_()
    # the mean over the two graphs with targets; the third is empty and left out
    (torch.sum(plan[:2] * tot._pair_cost(x2, t(pts))[:2]) / 2).backward()
    assert_close(x.grad, x2.grad, **F32)


# ------------------------------------------------------- KeypointDiffusion.loss

@functools.lru_cache(maxsize=None)
def _jax_side(case, dtype):
    """jax.value_and_grad of the total loss l2 + 0.1 rec_encoder (+ rl_hinge)
    on the case's batch: (losses, {leaf: gradient}) as numpy."""
    jm, params, _, _, jbatch, t_eps = case_setup(case, dtype)

    def total(p):
        losses = jm.loss(p, jax.random.key(0), jbatch, t_eps_override=jax_t_eps(t_eps))
        out = losses["l2"] + W_REC * losses["rec_encoder"]
        return (out + losses["rl_hinge"] if "rl_hinge" in losses else out), losses

    (_, losses), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(params)
    return {k: np.asarray(v) for k, v in losses.items()}, jax_flat(grads)


def _port_side(case, dtype):
    """The port's losses and parameter gradients on the same inputs."""
    _, _, tm, batch, _, t_eps = case_setup(case, dtype)
    losses = tm.loss(batch, t_eps_override=t_eps)
    out = losses["l2"] + W_REC * losses["rec_encoder"]
    (out + losses["rl_hinge"] if "rl_hinge" in losses else out).backward()
    return losses, {n: p.grad for n, p in tm.named_parameters()}


@pytest.mark.parametrize("case", list(CASES))
def test_loss_matches_jax(case):
    jm, params, _, batch, jbatch, t_eps = case_setup(case)
    if case in ("flagship", "hinge_exact_rec"):  # their gradient tests need jax.value_and_grad anyway
        want = _jax_side(case, "float32")[0]
    else:
        want = jax.jit(jm.loss)(params, jax.random.key(0), jbatch, t_eps_override=jax_t_eps(t_eps))
    got = _port_side(case, "float32")[0]
    assert set(got) == set(want)
    if case.startswith("fake"):
        assert (batch.lig_h[..., -1] > 0).any(), "the batch has no fake atoms"
    if case == "hinge_exact_rec":
        assert float(want["rl_hinge"]) > 0
    for k in want:
        assert_close(got[k], want[k], msg=k, **F32)


@pytest.mark.parametrize("case", ["flagship", "hinge_exact_rec"])
def test_loss_gradients_match_jax_grad(case):
    """Every parameter leaf, f32. A leaf the loss does not reach (the last
    layer's keypoint updates, the encoder's unused rk_fc_dst) has a zero
    gradient in JAX and none in the port."""
    want = _jax_side(case, "float32")[1]
    got = _port_side(case, "float32")[1]
    assert set(got) == set(want)
    for name, w in want.items():
        if got[name] is None:
            assert not np.any(w), name
        else:
            assert_close(got[name].reshape(w.shape), w, msg=name, **F32)


def _flat(grads, names):
    return np.concatenate([np.asarray(grads[n].float() if torch.is_tensor(grads[n]) else grads[n],
                                      np.float32).ravel() for n in names])


def test_loss_gradients_bf16_match_jax_grad():
    """bf16 pair MLPs: the port's gradient against the f32 gradient of the
    same weights and batch (jax.grad), max abs error over all leaves at most
    2e-2 of the gradient's max abs value, and no further from it than the
    JAX package's own bf16 gradient is (that one rounds its sums in bf16)."""
    want_f32 = _jax_side("flagship", "float32")[1]
    want_bf16 = _jax_side("flagship", "bfloat16")[1]
    got = _port_side("flagship", "bfloat16")[1]
    names = [n for n in sorted(want_f32) if got[n] is not None]
    assert all(not np.any(want_f32[n]) for n in want_f32 if got[n] is None)
    ref = _flat(want_f32, names)
    err_port = np.abs(_flat(got, names) - ref).max()
    err_jax = np.abs(_flat(want_bf16, names) - ref).max()
    scale = np.abs(ref).max()
    assert err_port <= BF16_REL * scale, f"port bf16 gradient: max abs err {err_port:.3e} > {BF16_REL} * {scale:.3e}"
    assert err_port <= err_jax, f"port bf16 gradient err {err_port:.3e} > the JAX package's bf16 err {err_jax:.3e}"
