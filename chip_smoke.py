"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py [--params NPZ] [--out record.json]

Phases, each timed on its own line; any failure raises (non-zero exit):
  1. device: CUDA must be present; prints the card's name and power limit;
  2. build: nvcc compiles kpdiff_tpu_torch/csrc/egnn_edge.cu into
     kpdiff_tpu_torch/_build/ (loaded with ctypes);
  3. kernel: the dense EGNN edge kernel against its plain PyTorch version
     on seeded random inputs at the flagship shapes (B=128, H=257, Ns=Nd in
     16/32/48 for ll and 40 for kk) and with many sources (B=16, Nd=48,
     Ns=192 and 384, as block kk windows and large dense kk give it), bf16
     and f32, with times;
  4. slice: configs/egnn_40kp.yml at full width and depth, batch 128, ligand
     buckets 16/32/48: encode -> compact_kk -> 250-step strided sampling
     through the kernel, launch counts checked; then the kernel held against
     its plain version on the inputs the main path gave it, and on every
     launch of a 10-step chain with injected noise; the chain's free-running
     distance to the plain chain is reported beside that of two plain chains
     whose initial noise differs by one ulp;
  5. serving: KeypointSampler answers three requests;
  6. train: flagship training from the trained weights on molgen data (256
     complexes, full padding): one batch of 4 through loss and backward on
     the card and on the CPU, f32 (gated) and bf16 (loss gated, gradients
     reported), TF32 off; 20 optimizer steps at batch 64 through the port's
     trainer (the dense edges take the kernel's plain version under
     autograd), with device and host ms/step and peak memory; the held-out
     loss under no_grad through the kernel (12 launches per batch) against
     the same pass through the plain version; a checkpoint, its npz export
     and one sampling request served from it.
Weights: the trained flagship, artifacts/egnn_40kp_trained_params.npz
(--params names another keystr npz archive); the run fails without them.
The last three lines are the kernel summary JSON, the card's name and power
limit, and the device JSON.
"""
from __future__ import annotations

import argparse
import copy
import json
import statistics
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

import kpdiff_tpu_torch.models.egnn as egnn_mod
from kpdiff_tpu_torch.cli.export_params import export as export_params
from kpdiff_tpu_torch.cli.train import evaluate, train_config_from
from kpdiff_tpu_torch.config import PaddingConfig, load_config, model_from_config, resolve_feature_sizes
from kpdiff_tpu_torch.data.dataset import PaddedLoader, resolve_lig_buckets
from kpdiff_tpu_torch.data.molgen import molgen_splits_for_config
from kpdiff_tpu_torch.models.complex import synthetic_batch, synthetic_complex_np
from kpdiff_tpu_torch.ops.cuda import egnn_edge
from kpdiff_tpu_torch.serve import KeypointSampler
from kpdiff_tpu_torch.training import trainer
from kpdiff_tpu_torch.utils.params_io import load_params, read_keystr_npz

CONFIG = "configs/egnn_40kp.yml"
BUCKET_WEIGHTS = {16: 0.4585, 32: 0.4903, 48: 0.0511}  # bench.py's ligand-size mixture
STEPS = 250
BATCH = 128
PARAMS = "artifacts/egnn_40kp_trained_params.npz"
H100_BF16_FLOPS = 989e12  # dense tensor-core bf16 peak, H100 SXM data sheet
H100_F32_FLOPS = 67e12    # f32 outside the tensor cores, same data sheet
H100_BYTES = 3.35e12      # HBM3 bandwidth
ELEMENTWISE_OPS = 16  # CUDA-core f32 ops per element, pair and chain: first-layer sum and
#                      silu, lin2 bias and silu, the row product with attw or wout
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # relative max-abs error vs the plain version
TRAIN_COMPLEXES = 256  # molgen training split: auto buckets [24, 32, 48], 3 full batches of 64 per epoch
TRAIN_STEPS = 20
TIMED_FROM = 5  # steps 5..19 enter the median ms/step
GRAD_TOL_F32 = 1e-3  # card vs CPU: max abs error of each gradient leaf over that leaf's max abs value
LOSS_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # card vs CPU and kernel vs plain, relative, per loss term


def phase(name, t0):
    print(f"phase {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def cuda_ms(fn, warmup=3, iters=20):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(got, ref):
    return max(float((g - r).abs().max() / r.abs().max().clamp_min(1e-30)) for g, r in zip(got, ref))


def abs_err(got, ref):
    return max(float((g - r).abs().max()) for g, r in zip(got, ref))


def bound(args, cd):
    """Least time for the kernel's work on these inputs: the larger of the
    operations and the bytes (every input read once, every output written
    once). Operations, for the active pairs: in bf16 the two H x H second
    layers on the tensor cores and the elementwise work on the CUDA cores,
    two units that can run at once, so the larger of their times; in f32
    both on the CUDA cores, so their sum."""
    a_es, a_ed = args[0], args[1]
    adj = args[15]
    b, ns, h = a_es.shape
    nd = a_ed.shape[1]
    pairs = int(adj.sum())
    matmul = pairs * 2 * 2 * h * h
    elementwise = pairs * 2 * h * ELEMENTWISE_OPS
    n_bytes = sum(t.numel() * t.element_size() for t in args if torch.is_tensor(t))
    n_bytes += b * nd * (h + 3) * 4
    if cd == torch.bfloat16:
        t_ops = max(matmul / H100_BF16_FLOPS, elementwise / H100_F32_FLOPS)
    else:
        t_ops = (matmul + elementwise) / H100_F32_FLOPS
    t_bytes = n_bytes / H100_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), pairs


def library_ms(args, cd):
    """Yardstick: torch.matmul of the two (B*Ns*Nd, H) x (H, H) second-layer
    products over all pairs, which the port never calls."""
    a_es, a_ed = args[0], args[1]
    b, ns, h = a_es.shape
    p = b * ns * a_ed.shape[1]
    x = torch.randn((p, h), device=a_es.device, dtype=cd)
    w = torch.randn((h, h), device=a_es.device, dtype=cd)
    return cuda_ms(lambda: (torch.matmul(x, w), torch.matmul(x, w)))


def measure(args, cd, label, iters=20):
    kw = dict(use_tanh=True, coords_range=10.0, compute_dtype=cd)
    got = egnn_edge.egnn_edge_dense(*args, **kw)
    ref = egnn_edge.egnn_edge_dense_plain(*args, **kw)
    torch.cuda.synchronize()
    for t in got:
        if not torch.isfinite(t).all():
            raise RuntimeError(f"{label}: kernel output not finite")
    rel, ab = rel_err(got, ref), abs_err(got, ref)
    if rel > TOL[cd]:
        raise RuntimeError(f"{label} {cd}: kernel vs plain relative error {rel:.3e} > {TOL[cd]:.0e}")
    k_ms = cuda_ms(lambda: egnn_edge.egnn_edge_dense(*args, **kw), iters=iters)
    p_ms = cuda_ms(lambda: egnn_edge.egnn_edge_dense_plain(*args, **kw), warmup=1, iters=3)
    b_ms, b_by, pairs = bound(args, cd)
    lib = library_ms(args, cd) if cd == torch.bfloat16 else None
    row = dict(shape=label, dtype=str(cd).replace("torch.", ""), pairs=pairs, max_rel_err=rel,
               max_abs_err=ab, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib)
    print(f"kernel {label} {row['dtype']}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
          f"library_ms={lib if lib is None else round(lib, 4)} bound_ms={b_ms:.4f} ({b_by}) "
          f"pairs={pairs} max_rel_err={rel:.3e} max_abs_err={ab:.3e}", flush=True)
    return row


def random_args(rng, b, ns, nd, h, dev):
    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, device=dev).to(dtype).contiguous()

    bw = 1.0 / np.sqrt(h)
    return (
        t(rng.normal(size=(b, ns, h)).astype(np.float32)), t(rng.normal(size=(b, nd, h)).astype(np.float32)),
        t(rng.normal(size=(b, ns, h)).astype(np.float32)), t(rng.normal(size=(b, nd, h)).astype(np.float32)),
        t(rng.normal(size=h).astype(np.float32)), t(rng.normal(size=h).astype(np.float32)),
        t(rng.uniform(-bw, bw, size=(h, h)).astype(np.float32)), t(rng.uniform(-bw, bw, size=h).astype(np.float32)),
        t(rng.uniform(-bw, bw, size=h).astype(np.float32)), t(rng.uniform(-bw, bw, size=1).astype(np.float32)),
        t(rng.uniform(-bw, bw, size=(h, h)).astype(np.float32)), t(rng.uniform(-bw, bw, size=h).astype(np.float32)),
        t(rng.uniform(-bw, bw, size=h).astype(np.float32) * 0.01),
        t(rng.normal(size=(b, ns, 3)).astype(np.float32) * 3), t(rng.normal(size=(b, nd, 3)).astype(np.float32) * 3),
        t(rng.random((b, ns, nd)) < 0.5, torch.bool),
    )


def with_dtype(args, cd):
    """The module passes W2 in the compute dtype; everything else stays f32."""
    out = list(args)
    out[6] = egnn_edge.pad_weight(args[6], cd)
    out[10] = egnn_edge.pad_weight(args[10], cd)
    return tuple(out)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _loss_and_grads(model, batch, t_eps):
    """Loss terms (floats) and {leaf: gradient on the CPU or None} of l2 + w_rec * rec_encoder."""
    model.zero_grad(set_to_none=True)
    losses = model.loss(batch, t_eps_override=t_eps)
    (losses["l2"] + 0.1 * losses["rec_encoder"]).backward()
    grads = {n: None if p.grad is None else p.grad.detach().float().cpu() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return {k: float(v) for k, v in losses.items()}, grads


def card_vs_cpu(cfg, flat, batch, t_eps, dev, dtype_name):
    """One loss and backward on the card and on the CPU, same weights, batch
    and (t, eps). Returns the worst relative loss-term error and per-leaf
    gradient errors (max abs error over the leaf's max abs value)."""
    cfg = copy.deepcopy(cfg)
    cfg["dynamics"]["compute_dtype"] = cfg["rec_encoder"]["compute_dtype"] = dtype_name
    out = []
    for device in (dev, torch.device("cpu")):
        model = model_from_config(cfg, device=device)
        load_params(model, flat)
        out.append(_loss_and_grads(model, batch.to(device), t_eps))
        del model
    (l_card, g_card), (l_cpu, g_cpu) = out
    loss_err = {k: _rel(l_card[k], l_cpu[k]) for k in l_cpu}
    leaf_err, worst_abs, scale_all = {}, 0.0, 0.0
    for name, g in g_cpu.items():
        if (g is None) != (g_card[name] is None):
            raise RuntimeError(f"{dtype_name}: gradient of {name} is None on one side only")
        if g is None:
            continue
        err = float((g_card[name] - g).abs().max())
        scale = float(g.abs().max())
        leaf_err[name] = err / max(scale, 1e-30)
        worst_abs, scale_all = max(worst_abs, err), max(scale_all, scale)
    return loss_err, leaf_err, worst_abs / max(scale_all, 1e-30), l_card


def train_phase(params_path, seed, dev):
    """Phase 6; returns the phase's record and the kernel launches on its paths."""
    cfg = load_config(CONFIG)
    cfg["training"]["sample_interval"] = 0
    pad = PaddingConfig.from_config(cfg)
    n_rec_feat = resolve_feature_sizes(cfg)[0]
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 is on: the f32 card-vs-CPU gate needs full f32 products")

    t1 = time.perf_counter()
    train_ds, test_ds = molgen_splits_for_config(cfg, pad, n_rec_feat, TRAIN_COMPLEXES, seed)
    buckets = resolve_lig_buckets(cfg, train_ds, pad.n_lig)
    data_s = time.perf_counter() - t1
    sizes = np.diff(train_ds.lig_segments)
    per_bucket = {b: int(((sizes <= b) & (sizes > lo)).sum()) for lo, b in zip([0] + buckets[:-1], buckets)}
    print(f"train data: molgen {len(train_ds)} train / {len(test_ds)} test complexes in {data_s:.3f} s; "
          f"buckets {buckets} with {per_bucket} training complexes", flush=True)
    flat = read_keystr_npz(params_path)
    tcfg = train_config_from(cfg)
    batch_size = tcfg.batch_size
    iters_per_epoch = max(len(train_ds) // batch_size, 1)

    def loader(ds, s, drop_last=True, bs=batch_size):
        return PaddedLoader(ds, pad, bs, pad.n_kp, 128, seed=s, drop_last=drop_last, lig_buckets=buckets)

    # ---- card against CPU, one batch of 4 with a fixed (t, eps)
    small = next(loader(train_ds, seed, bs=4).epoch())
    rng = np.random.default_rng(seed + 3)
    b, n, f = small.lig_h.shape
    t_eps = (rng.integers(0, cfg["diffusion"]["n_timesteps"], b), rng.normal(size=(b, n, 3)).astype(np.float32),
             rng.normal(size=(b, n, f)).astype(np.float32))
    compare = {}
    for dtype_name, cd in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        loss_err, leaf_err, grad_rel_all, losses = card_vs_cpu(cfg, flat, small, t_eps, dev, dtype_name)
        worst_leaf = max(leaf_err, key=leaf_err.get)
        compare[dtype_name] = dict(loss_rel_err=loss_err, grad_leaf_rel_err_max=leaf_err[worst_leaf],
                                   grad_leaf_worst=worst_leaf, grad_rel_err_all_leaves=grad_rel_all,
                                   grad_leaves=len(leaf_err), losses_card=losses)
        print(f"train card vs CPU {dtype_name} (batch 4, bucket {n}): loss rel err "
              + ", ".join(f"{k} {v:.3e}" for k, v in sorted(loss_err.items()))
              + f" (gate {LOSS_TOL[cd]:.0e}); gradients over {len(leaf_err)} leaves: worst leaf {worst_leaf} "
              f"{leaf_err[worst_leaf]:.3e} of its max abs"
              + (f" (gate {GRAD_TOL_F32:.0e})" if cd == torch.float32 else " (reported)")
              + f", all leaves {grad_rel_all:.3e} of the largest", flush=True)
        if max(loss_err.values()) > LOSS_TOL[cd]:
            raise RuntimeError(f"card vs CPU {dtype_name}: loss terms differ {loss_err}")
        if cd == torch.float32 and leaf_err[worst_leaf] > GRAD_TOL_F32:
            bad = {k: v for k, v in leaf_err.items() if v > GRAD_TOL_F32}
            raise RuntimeError(f"card vs CPU f32: gradient leaves beyond {GRAD_TOL_F32}: {bad}")

    # ---- 20 optimizer steps at batch 64 from the trained weights
    model = model_from_config(cfg, device=dev, seed=seed)
    load_params(model, flat)
    train_loader = loader(train_ds, seed)
    batches = []
    while len(batches) < TRAIN_STEPS:
        batches.extend(train_loader.epoch())
    batches = batches[:TRAIN_STEPS]
    state = trainer.init_train_state(model, tcfg)
    step_fn = trainer.make_train_step(tcfg, iters_per_epoch)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    egnn_edge.launches = 0
    rows, dev_ms, host_ms = [], [], []
    moved_after = None
    for i, batch in enumerate(batches):
        batch = batch.to(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        start.record()
        m = step_fn(state, batch, generator=gen)
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - h0) * 1e3)
        dev_ms.append(start.elapsed_time(end))
        rows.append(dict(step=i, bucket=int(batch.lig_x.shape[1]), **m))
        if moved_after is None and any(not torch.equal(p0[k], v) for k, v in model.named_parameters()):
            moved_after = i
    train_launches = egnn_edge.launches
    peak = torch.cuda.max_memory_allocated()
    for r in rows:
        if not all(np.isfinite(r[k]) for k in ("l2", "pos", "feat", "rec_encoder", "total")):
            raise RuntimeError(f"train step {r['step']}: non-finite loss {r}")
        if r["skipped_nonfinite"] != 0.0:
            raise RuntimeError(f"train step {r['step']} skipped a non-finite update")
    if rows[0]["lr"] != 0.0 or moved_after != 1:
        raise RuntimeError(f"warm-up: lr {rows[0]['lr']} at step 0; parameters first moved after step {moved_after}")
    if train_launches != 0:
        raise RuntimeError(f"training launched the forward-only kernel {train_launches} times")
    med_dev = statistics.median(dev_ms[TIMED_FROM:])
    med_host = statistics.median(host_ms[TIMED_FROM:])
    by_bucket = {bk: statistics.median([d for d, r in zip(dev_ms[TIMED_FROM:], rows[TIMED_FROM:]) if r["bucket"] == bk])
                 for bk in sorted({r["bucket"] for r in rows[TIMED_FROM:]})}
    print(f"train {TRAIN_STEPS} steps at batch {batch_size}: median {med_dev:.3f} ms/step on CUDA events, "
          f"{med_host:.3f} ms/step on the host clock (steps {TIMED_FROM}-{TRAIN_STEPS - 1}); by bucket "
          + ", ".join(f"{k}: {v:.3f} ms" for k, v in by_bucket.items())
          + f"; first step {dev_ms[0]:.3f} ms; peak memory {peak / 2**30:.3f} GiB "
          f"(torch.cuda.max_memory_allocated); kernel launches in training {train_launches}", flush=True)
    print("train trajectory (step bucket lr l2 rec_encoder): " + "; ".join(
        f"{r['step']} {r['bucket']} {r['lr']:.2e} {r['l2']:.4f} {r['rec_encoder']:.3f}" for r in rows), flush=True)

    # ---- held-out loss under no_grad: kernel, then the plain version on the same batches and draws
    eval_batches = list(loader(test_ds, seed + 7, drop_last=False).epoch())
    fixed = types.SimpleNamespace(epoch=lambda: iter(eval_batches))
    real = egnn_mod.egnn_edge_dense
    egnn_edge.launches = 0
    ev_kernel = evaluate(model, fixed, dev, torch.Generator(device=dev).manual_seed(seed + 9))
    torch.cuda.synchronize()
    eval_launches = egnn_edge.launches
    egnn_mod.egnn_edge_dense = egnn_edge.egnn_edge_dense_plain
    try:
        ev_plain = evaluate(model, fixed, dev, torch.Generator(device=dev).manual_seed(seed + 9))
    finally:
        egnn_mod.egnn_edge_dense = real
    n_layers = cfg["dynamics"]["n_layers"]
    want = 2 * n_layers * len(eval_batches)
    eval_err = {k: _rel(ev_kernel[k], ev_plain[k]) for k in ev_plain}
    print(f"train eval: {len(eval_batches)} held-out batches (buckets "
          f"{[int(b_.lig_x.shape[1]) for b_ in eval_batches]}), {eval_launches} kernel launches "
          f"({2 * n_layers} per batch); kernel vs plain loss rel err "
          + ", ".join(f"{k} {v:.3e}" for k, v in sorted(eval_err.items())) + f" (gate {LOSS_TOL[torch.bfloat16]:.0e}); "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(ev_kernel.items())), flush=True)
    if eval_launches != want:
        raise RuntimeError(f"held-out loss: {eval_launches} kernel launches, expected {want}")
    if max(eval_err.values()) > LOSS_TOL[torch.bfloat16] or not all(np.isfinite(v) for v in ev_kernel.values()):
        raise RuntimeError(f"held-out loss, kernel vs plain: {eval_err}")

    # ---- checkpoint, npz export, one request served from it
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = trainer.save_checkpoint(Path(tmp) / "checkpoints", state)
        npz = Path(tmp) / "params.npz"
        export_params(tmp, npz)
        del model, state
        sampler = KeypointSampler.from_params(CONFIG, npz, batch_size=64, device="cuda", seed=seed,
                                              sample_steps=STEPS)
        pocket = synthetic_complex_np(np.random.default_rng(seed + 4), 260, 20, 260, 20, 10, 10)
        egnn_edge.launches = 0
        mols = sampler.sample_for_arrays(pocket["rec_x"], pocket["rec_h"], pocket["rec_res_idx"],
                                         init_com=pocket["lig_x"].mean(0), n_mols=8, ligand_size=20)
        torch.cuda.synchronize()
        serve_launches = egnn_edge.launches
    if len(mols) != 8 or not all(np.isfinite(c).all() and c.shape == (20, 3) for c, _ in mols) or serve_launches <= 0:
        raise RuntimeError(f"serving from the exported npz: {len(mols)} molecules, {serve_launches} kernel launches")
    print(f"train export: checkpoint {ckpt.name}, npz served 8 molecules of 20 atoms with {serve_launches} "
          f"kernel launches", flush=True)
    record = dict(data_s=data_s, buckets=buckets, train_complexes_per_bucket=per_bucket, card_vs_cpu=compare,
                  steps=rows, step_ms_device=dev_ms, step_ms_host=host_ms, median_ms_device=med_dev,
                  median_ms_host=med_host, median_ms_device_by_bucket=by_bucket, peak_memory_bytes=peak,
                  eval_kernel=ev_kernel, eval_plain=ev_plain, eval_rel_err=eval_err, eval_batches=len(eval_batches),
                  eval_launches=eval_launches, serve_launches=serve_launches)
    return record, dict(train_steps=train_launches, train_eval=eval_launches, train_serve=serve_launches)


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--params", default=PARAMS, help=f"keystr npz of trained weights (default: {PARAMS})")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the run's full record as JSON to this path")
    args = ap.parse_args()
    t_all = time.perf_counter()

    # ---- 1. device
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run needs a CUDA card",
              file=sys.stderr)
        sys.exit(2)
    if not Path(args.params).is_file():
        print(f"chip_smoke: trained weights {args.params} not found", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed ({smi.returncode}): {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} | {card} | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    phase("device", t0)

    # ---- 2. build
    t0 = time.perf_counter()
    lib = egnn_edge.build(verbose=True)
    print(f"built {lib}", flush=True)
    phase("build", t0)

    # ---- 3. kernel against its plain version at the flagship shapes
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    h = 257
    shape_rows = []
    for label, b, ns, nd in (("ll16", BATCH, 16, 16), ("ll32", BATCH, 32, 32), ("ll48", BATCH, 48, 48),
                             ("kk40", BATCH, 40, 40), ("ns192_nd48", 16, 192, 48), ("ns384_nd48", 16, 384, 48)):
        base = random_args(rng, b, ns, nd, h, dev)
        for cd in (torch.bfloat16, torch.float32):
            shape_rows.append(measure(with_dtype(base, cd), cd, f"random_{label}", iters=20 if cd == torch.bfloat16 else 3))
        del base
    phase("kernel", t0)

    # ---- 4. the slice: egnn_40kp sampling at batch 128 through the kernel
    t0 = time.perf_counter()
    cfg = load_config(CONFIG)
    model = model_from_config(cfg, device="cuda", seed=args.seed)
    load_params(model, read_keystr_npz(args.params))
    weights = f"trained {args.params}"
    model.eval()
    pad = PaddingConfig.from_config(cfg)
    n_layers = cfg["dynamics"]["n_layers"]
    print(f"slice: {CONFIG} weights={weights} layers={n_layers} hidden={cfg['dynamics']['hidden_nf']}+1 "
          f"compute_dtype={cfg['dynamics']['compute_dtype']}", flush=True)

    # record the kernel's inputs at each shape the main path gives it
    captured = {}
    real_wrapper = egnn_mod.egnn_edge_dense

    def recording_wrapper(*a, **kw):
        key = ("kk" if a[0].shape[1] == pad.n_kp else "ll") + str(a[0].shape[1])
        if key not in captured:
            captured[key] = (tuple(t.clone() if torch.is_tensor(t) else t for t in a), kw["compute_dtype"])
        return real_wrapper(*a, **kw)

    per_bucket, slice_rows, encoded = {}, {}, {}
    egnn_mod.egnn_edge_dense = recording_wrapper
    try:
        for n_lig in BUCKET_WEIGHTS:
            cpx = synthetic_batch(0, batch=BATCH, n_rec_pad=pad.n_rec, n_lig_pad=n_lig, n_rec_feat=10,
                                  n_lig_feat=10, n_kp=pad.n_kp, kp_feat_dim=model.cfg.rec_nf, n_ip_pad=pad.n_ip,
                                  min_rec=260, min_lig=min(18, n_lig - 2), device=dev)
            with torch.no_grad():
                enc, kk = model.encode(cpx)
                kk = model.compact_kk(enc, kk)
            layout = f"nbr_cap{int(kk[0].shape[-1])}" if isinstance(kk, tuple) else "dense"
            encoded[n_lig] = (enc, kk)
            gen = torch.Generator(device=dev).manual_seed(args.seed + n_lig)
            model.sample(enc, kk, sample_steps=2, generator=gen)  # warm-up (cuBLAS, allocator)
            torch.cuda.synchronize()
            egnn_edge.launches = 0
            t1 = time.perf_counter()
            out = model.sample(enc, kk, sample_steps=STEPS, generator=gen)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t1
            launches = egnn_edge.launches
            want = (2 if layout == "dense" else 1) * n_layers * STEPS
            for k, shape in (("lig_x", (BATCH, n_lig, 3)), ("lig_h", (BATCH, n_lig, 10))):
                if tuple(out[k].shape) != shape or not torch.isfinite(out[k]).all():
                    raise RuntimeError(f"bucket {n_lig}: {k} has shape {tuple(out[k].shape)} or is not finite")
            if launches != want:
                raise RuntimeError(f"bucket {n_lig}: {launches} kernel launches, expected {want} (kk {layout})")
            per_bucket[n_lig] = dt / BATCH
            slice_rows[n_lig] = dict(s_per_ligand=dt / BATCH, chain_s=dt, kk=layout, launches=launches)
            print(f"slice bucket {n_lig}: {dt / BATCH:.6f} s/ligand ({dt:.3f} s for {BATCH} ligands, "
                  f"K={STEPS}) kk={layout} launches={launches}", flush=True)
    finally:
        egnn_mod.egnn_edge_dense = real_wrapper
    main_launches = sum(r["launches"] for r in slice_rows.values())
    mixture = sum(w * per_bucket[n] for n, w in BUCKET_WEIGHTS.items()) / sum(BUCKET_WEIGHTS.values())
    print(f"slice mixture {BUCKET_WEIGHTS}: {mixture:.6f} s/ligand at K={STEPS}, batch {BATCH}", flush=True)

    main_rows = {}
    for key, (a, cd) in sorted(captured.items()):
        main_rows[key] = measure(a, cd, f"main_{key}")
    del captured

    # A 10-step chain through the kernel; every launch is also computed by the
    # plain version on the same inputs (the gate). Then the same chain through
    # the plain version from the same noise, free-running: its distance to the
    # kernel's chain is reported, not gated, because radius/kNN edges rebuilt
    # every step turn rounding-level differences into different graphs. The
    # witness for that: a second plain chain whose initial coordinates are
    # moved by one ulp, and its distance to the first plain chain.
    n_lig = 32
    enc, kk = encoded[n_lig]
    nrng = np.random.default_rng(args.seed + 1)
    K10 = 10
    noise = dict(init_x=nrng.normal(size=(BATCH, n_lig, 3)), init_h=nrng.normal(size=(BATCH, n_lig, 10)),
                 steps_x=nrng.normal(size=(K10, BATCH, n_lig, 3)), steps_h=nrng.normal(size=(K10, BATCH, n_lig, 10)))
    noise = {k: v.astype(np.float32) for k, v in noise.items()}
    step_errs = []

    def checking_wrapper(*a, **kw):
        got = real_wrapper(*a, **kw)
        step_errs.append(rel_err(got, egnn_edge.egnn_edge_dense_plain(*a, **kw)))
        return got

    def plain_wrapper(*a, **kw):
        return egnn_edge.egnn_edge_dense_plain(*a, **kw)

    egnn_mod.egnn_edge_dense = checking_wrapper
    try:
        out_k = model.sample(enc, kk, sample_steps=K10, noise=noise)
        egnn_mod.egnn_edge_dense = plain_wrapper
        out_p = model.sample(enc, kk, sample_steps=K10, noise=noise)
        nudged = dict(noise, init_x=np.nextafter(noise["init_x"], np.float32(np.inf)))
        out_pu = model.sample(enc, kk, sample_steps=K10, noise=nudged)
    finally:
        egnn_mod.egnn_edge_dense = real_wrapper
    torch.cuda.synchronize()
    chain_step_err = max(step_errs)
    chain_free = rel_err([out_k["lig_x"], out_k["lig_h"]], [out_p["lig_x"], out_p["lig_h"]])
    chain_ulp = rel_err([out_pu["lig_x"], out_pu["lig_h"]], [out_p["lig_x"], out_p["lig_h"]])
    print(f"slice 10-step chain (bucket {n_lig}): {len(step_errs)} launches, each against the plain version "
          f"on its inputs: max_rel_err={chain_step_err:.3e} (tolerance {TOL[torch.bfloat16]:.0e}); "
          f"free-running plain chain vs kernel chain: max_rel_diff={chain_free:.3e} (reported); "
          f"plain chain vs plain chain from init_x one ulp away: max_rel_diff={chain_ulp:.3e} (reported)",
          flush=True)
    if not chain_step_err <= TOL[torch.bfloat16]:
        raise RuntimeError(f"a launch in the 10-step chain differs from the plain version: {chain_step_err:.3e}")
    if len(step_errs) != 2 * n_layers * K10 and len(step_errs) != n_layers * K10:
        raise RuntimeError(f"the 10-step chain made {len(step_errs)} kernel calls")
    del encoded
    phase("slice", t0)

    # ---- 5. serving: three requests
    t0 = time.perf_counter()
    del model, enc, kk, out_k, out_p, out_pu
    sampler = KeypointSampler.from_params(CONFIG, args.params, batch_size=64, device="cuda", seed=args.seed,
                                          sample_steps=STEPS)
    srng = np.random.default_rng(args.seed + 2)
    serve_rows = []
    for n_rec, n_mols, size in ((150, 8, 14), (260, 32, 22), (380, 64, 30)):
        pocket = synthetic_complex_np(srng, n_rec, size, n_rec, size, 10, 10)
        t1 = time.perf_counter()
        mols = sampler.sample_for_arrays(pocket["rec_x"], pocket["rec_h"], pocket["rec_res_idx"],
                                         init_com=pocket["lig_x"].mean(0), n_mols=n_mols, ligand_size=size)
        dt = time.perf_counter() - t1
        if len(mols) != n_mols or not all(np.isfinite(c).all() and c.shape == (size, 3) for c, _ in mols):
            raise RuntimeError(f"serving request ({n_rec} pocket atoms, {n_mols} mols) returned bad molecules")
        serve_rows.append(dict(pocket_atoms=n_rec, n_mols=n_mols, ligand_size=size, latency_s=dt))
        print(f"serve request: pocket {n_rec} atoms, {n_mols} mols of {size} atoms: {dt:.3f} s", flush=True)
    del sampler
    phase("serve", t0)

    # ---- 6. train: flagship training steps, held-out loss, export -> serve
    t0 = time.perf_counter()
    train_record, train_paths = train_phase(args.params, args.seed, dev)
    phase("train", t0)

    total = time.perf_counter() - t_all
    print(f"total wall: {total:.3f} s", flush=True)
    head = main_rows.get("ll48") or next(iter(main_rows.values()))
    kernels = {"kernels": [{
        "name": "egnn_edge_dense", "route": "cuda", "source": "kpdiff_tpu_torch/csrc/egnn_edge.cu",
        "replaces": "kpdiff_tpu/ops/pallas/egnn_edge.py:174", "launches": main_launches,
        "shape": head["shape"], "max_abs_err": head["max_abs_err"], "max_rel_err_bf16": head["max_rel_err"],
        "ms": head["ms"], "kernel_ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "launches_by_path": dict(sample=main_launches, **train_paths),
        "shapes": list(main_rows.values()) + shape_rows,
    }]}
    record = dict(card=card, device=torch.cuda.get_device_name(0), weights=weights, slice=slice_rows,
                  mixture_s_per_ligand=mixture, chain_step_max_rel_err=chain_step_err,
                  chain_free_max_rel_diff=chain_free, chain_one_ulp_max_rel_diff=chain_ulp, serve=serve_rows,
                  train=train_record, total_wall_s=total, **kernels)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
