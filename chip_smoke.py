"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py [--params NPZ] [--out record.json]

Phases, each timed on its own line; any failure raises (non-zero exit):
  1. device: CUDA must be present; prints the card's name and power limit;
  2. build: nvcc compiles kpdiff_tpu_torch/csrc/egnn_edge.cu into
     kpdiff_tpu_torch/_build/ (loaded with ctypes);
  3. kernel: first the kernel's tensor-core product alone (one 64-row tile
     of wgmma m64n256k16 through the packed W2, egnn_edge.wgmma_probe)
     against torch.matmul of the same bf16 operands; then the dense EGNN
     edge kernel (v5) against its plain PyTorch version on seeded random
     inputs at the flagship shapes (B=128, H=257, Ns=Nd in 16/32/48 for ll
     and 40 for kk), with many sources (B=16, Nd=48, Ns=192 and 384), at
     the other families' shapes (width 256 at kk40 and ll32, K=20, kk
     128 x 128 at B=32, block windows of 192 sources to 64 destinations over
     B*6 rows) and at a data-parallel rank's ll32 (B=8), bf16 and f32, with
     times. Every measured row is launched twice on the same inputs and the
     two outputs must be bitwise equal;
  3b. gvp_message: nvcc compiles kpdiff_tpu_torch/csrc/gvp_message.cu; the
     GVP message kernel against GVPEdgeMessages.nbr and .pairs (bf16, the
     same module's plain chain) on a tiny list with empty rows, the all-atom
     cell's kk (32 molgen pockets of 384 slots, cap 24, mean), its lk and kl
     and gvp_40kp's lk and kl (each keypoint's 7 nearest ligand atoms; kl as
     each ligand atom's list of keypoint senders, cap K; B=32, K=384, mean;
     B=128, K=40, sum): within 2e-2 of scale, two launches bitwise equal,
     device ms beside the node projection's, the kl list build's, the plain
     path's and the bound;
  4. slice: configs/egnn_40kp.yml at full width and depth, batch 128, ligand
     buckets 16/32/48: encode -> compact_kk -> 250-step strided sampling
     through the kernel, replayed from the reverse step's captured CUDA
     graph (the samplers' default on CUDA), launch counts checked; then the
     kernel held against its plain version on the inputs the main path gave
     it, and on every launch of a 10-step eager chain (cuda_graph=False)
     with injected noise; the chain's free-running
     distance to the plain chain is reported beside that of two plain chains
     whose initial noise differs by one ulp;
  5. serving: a port run directory made from the trained weights
     (config.yml, checkpoints/step_0.pt, and in its dataset.location the
     size histogram of molgen's 4096-complex training split and a
     two-pocket held-out split); KeypointSampler on it answers
     sample_for_arrays with an int size, with 'ref' and with 'random' (two
     chunks, two buckets), and sample_for_pocket on a synthetic receptor
     PDB and reference SDF written here (pocket of 260-384 atoms, ligand of
     24); batch 64, K=250, every chunk repeat-padded to 64 rows (checked
     row by row); each request's latency split by part; then the 'ref'
     request with eager steps and again through its cached graph;
  6. train: flagship training from the trained weights on molgen data (256
     complexes, full padding): one batch of 4 through loss and backward on
     the card and on the CPU, f32 (gated) and bf16 (loss gated, gradients
     reported), TF32 off; 20 optimizer steps at batch 64 through the port's
     trainer on its default path, replays of the step's captured CUDA graphs
     (the dense edges take the kernel's plain version under autograd), with
     device and host ms/step and peak memory; the held-out loss under
     no_grad through the kernel (replays of the loss's captured graphs, 24
     launches per batch) against the same pass through the plain version,
     eagerly; a checkpoint, its npz export and one sampling request served
     from it;
  7. front ends: cli.byop on the receptor PDB and on its mmCIF rendering,
     cli.sample on the two held-out pockets (--visualize), one POST
     /sample_files to cli.serve_http on 127.0.0.1, and cli.train with the
     config's own sample_interval (the analyzer fires once, full chain)
     followed by export_params --best; output layouts, SDFs read back;
  8. quality: benchmarks/strided_quality.py's protocol at K=250, eta 1 on
     the trained weights (8 held-out molgen receptors x 12 replicates, 3
     launches pooled, 288 molecules), gated on validity >= 0.95,
     connectivity >= 0.72 and atom_type_kl <= 0.03, printed beside the
     K=250 row of STRIDED_QUALITY.json;
  9. families: every other config of configs/ at full width and depth,
     seeded weights, batch 32 (family_phase): encode -> compact_kk -> a K=50
     chain; for egnn_ca and egnn_all_atom a 5-step chain on the encoder's own
     kk (dense 128 x 128, blocks) with every launch against the plain
     version; loss and gradients on the card against the CPU (f32, dropout
     0); 5 optimizer steps with the config's dropout, remat and grad_accum
     through the trainer's captured graphs, ms/step and peak memory; the kernel against its plain version on each
     new shape's first launch (a neighbor-list kk's in the list mode, on the
     list's mask), and the list mode at the all-atom cell's kk (B=32 molgen
     pockets of 384 slots, cap 24); then phase 8's protocol on the trained GVP
     artifacts/gvp_40kp_trained_params.npz, gated on validity >= 0.95,
     connectivity >= 0.82 and atom_type_kl <= 0.03, beside
     STRIDED_QUALITY_GVP.json's K=250 row.
 10. reference user: synthetic BindingMOAD assemblies and split files ->
     cli.process_bindingmoad -> cli.train on the processed splits at the
     flagship's full width (3 steps at batch 4) -> cli.sample --ligand_size
     random (the histogram just written; K=50) -> cli.compute_metrics, and
     cli.process_crossdocked on three pairs; both trained archives turned
     into the upstream state_dict layout (to_reference_state_dict), through
     torch.save / torch.load and the port's convert_reference_checkpoint,
     every leaf equal bitwise; the trained flagship with the upstream's graph
     options set in memory, batch 32, bucket 32, K=50, beside the config's
     own kl_k 5 kNN mask (24 launches a step): kl_k 0 under both
     z_semantics (24 a step, every launch of a 3-step chain against the
     plain version, the radius kl 40 -> 32 and lk 32 -> 40 grids timed) and
     ll_k 16 (24 a step); the
     learned EGNN and GVP encoders with rr_layout nbr and block, timed at
     batch 32.
 11. parallel: the parallel layer (kpdiff_tpu_torch/parallel/) at world size
     1 through NCCL (initialize_multihost on a file:// store): 5 steps of the
     flagship at full width, batch 64, on phase 6's batches with injected
     (t, eps) through the dp x mp trainer (a ('data', 'model') mesh of
     (1, 1): every collective of the keypoint split and the gradient
     reductions runs) against the plain trainer, deterministic kernels,
     losses and parameter checksum within rel 1e-5 in f32 and within rel
     1e-3 with the config's bf16 pair MLPs (the two trainers add some
     gradients in another order, and Adam turns bf16 rounding into 1e-4),
     ms per step of both; the trained flagship's kp-sharded sample
     (shard_encoded, batch 32, bucket 32, K=50) held against the unsharded
     chain step by step on the unsharded chain's states (bf16 tolerance),
     launches per step equal; the kernel at every
     per-rank shape a 2- or 4-rank run gives it (dense kk 40 -> 40/n, kl
     40/n -> 32 and lk 32 -> 40/n with kl_k 0, kk 20 -> 20/n, kk 24 -> 3 of
     K=20 padded for 8, ll32 and kk40 at B/n), bf16 and f32, against the
     plain version; and kpdiff_tpu_torch.dryrun.dryrun_multichip(1).
 12. graphs: the reverse chain as a captured CUDA graph of one step against
     eager steps, on the trained flagship at batch 128, buckets 16/32/48,
     K=250: seconds per ligand of each path, the capture's seconds and graph
     pool bytes, each graph step against the eager step on the same state
     and generator state at steps 0, 1, 125 and 249 (bitwise expected; gated
     at 2e-2 of the state's scale in bf16, 1e-5 in f32), a captured graph's
     draws against eager draws (bitwise), two successive requests (they
     differ; neither output aliases the graph's buffers), then under
     torch.profiler 10 steps of each path (wall and device ms a step, busy
     share) with the edge kernel's rows counted (24 a step, equal to the
     launches captured times the replays); the trained gvp_40kp at bucket
     48 the same way (K=50); and the profiled launches of graph chains on
     the other layouts (egnn_ca on compact_kk's list, its mask 24 a step;
     the flagship with kl_k 0, 24 a step).
 13. train graphs: the optimizer step and the held-out loss as captured
     CUDA graphs against eager, on the trained flagship at batch 64 with
     phase 6's first 10 batches (two ligand buckets alternating) and
     injected (t, eps): 10 steps through graphs against 10 eager steps from
     the same state, in f32 and with the config's bf16 pair MLPs, losses
     and parameter checksum within rel 1e-5 / 1e-3 (phase 11's bounds for two
     trainers; bitwise expected), ms a step on CUDA events and on the host
     clock for both (steps after each bucket's first), each capture's
     seconds, the train graphs' pool bytes and the peak memory with a third
     bucket (48) captured, 4 steps of each path under torch.profiler (wall
     and device ms a step, busy share, kernels a step); the held-out loss
     graphs on phase 6's held-out batches (24 edge-kernel launches a batch:
     captured x replays plus the first batch's eager warm-up) against the plain version
     eagerly; and the caches keyed on parameter versions after replayed
     steps: the analyzer's chain (encode -> sample on the graph path, K=10,
     injected noise) step by step against a fresh model loaded with the
     trained weights (bf16 tolerance), the bf16 sampling copy and the
     kernel's packed weights bitwise, the chain graph recaptured once.
Every row of the kernel table carries `device_ms`, the kernel's device time
per launch with the launches queued behind a spin kernel, beside `ms` (CUDA
events around back-to-back calls of the Python wrapper, which the host may
pace on small grids); `library_ms` and `library_device_ms` time the yardstick
on the same two clocks, so that each compares with its own; the rows at
B <= 32 also carry `profiler_ms`, read from
torch.profiler's kernel rows at the end of the run, since the profiler slows
every launch that follows it.
Every sampling path is held to its kernel launch count (ChainLog): for EGNN,
n_layers launches per reverse step for ll, as many again for kl and, with
update_kp_feat, for lk (the kNN mask, or the radius grid with kl_k 0) and for
kk (dense, in blocks, or the mask of compact_kk's neighbor list): 24 an
EGNN step; and GVP message kernel launches (gvp_launches_per_step): n_convs a
step for the kl pairs, with update_kp n_convs - 1 each for the lk pairs and a
kk neighbor list (16 an all-atom GVP step, 11 a gvp_40kp step). Sampling replays a
captured CUDA graph of the reverse step by default: the first chain of a
shape runs its first step eagerly (its launches counted as they are made)
and captures the step (the wrapper counts the calls it records in
egnn_edge.captured, not in launches); every replay adds the captured count.
Per-launch checks run on eager chains (cuda_graph=False).
Weights: the trained flagship, artifacts/egnn_40kp_trained_params.npz
(--params names another keystr npz archive), and the trained gvp_40kp; the
run fails without them.
The last three lines are the kernel summary JSON, the card's name and power
limit, and the device JSON.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.request
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import kpdiff_tpu_torch.models.egnn as egnn_mod
from kpdiff_tpu_torch.analysis.analyzer import ModelAnalyzer
from kpdiff_tpu_torch.analysis.metrics import evaluate_samples
from kpdiff_tpu_torch.analysis.molecule_builder import perceive_bonds
from kpdiff_tpu_torch.cli import byop as byop_cli, sample as sample_cli, serve_http, train as train_cli
from kpdiff_tpu_torch.cli.byop import process_ligand_and_pocket
from kpdiff_tpu_torch.cli.export_params import best_step, export as export_params
from kpdiff_tpu_torch.cli.import_params import make_run_dir as make_run_dir_from_params
from kpdiff_tpu_torch.cli.train import evaluate, train_config_from
from kpdiff_tpu_torch.config import PaddingConfig, dump_yaml, load_config, model_from_config, resolve_feature_sizes
from kpdiff_tpu_torch.data.dataset import PaddedLoader, resolve_lig_buckets
from kpdiff_tpu_torch.data.mmcif import write_mmcif
from kpdiff_tpu_torch.data.molgen import molgen_splits_for_config, random_molecule, type_counts
from kpdiff_tpu_torch.data.padding import pad_item, to_complex
from kpdiff_tpu_torch.data.pdb import format_pdb_line, parse_pdb
from kpdiff_tpu_torch.data.sdf import SdfMol, parse_sdf, write_sdf
from kpdiff_tpu_torch.models.complex import synthetic_batch, synthetic_complex_np
from kpdiff_tpu_torch.models.chain_graph import STATE, clone_tree, copy_tree
from kpdiff_tpu_torch.models.diffusion import KeypointDiffusion
from kpdiff_tpu_torch.models.size_dist import LigandSizeDistribution, save_dataset_histogram
from kpdiff_tpu_torch.ops.cuda import egnn_edge, gvp_message
from kpdiff_tpu_torch.ops.edge_sets import (KernelList, NbrList, PairList, dst_major, edge_count, layout_name, list_cap,
                                            transpose)
from kpdiff_tpu_torch.ops.neighbors import dense_radius_adjacency, knn_indices, radius_neighbor_list
from kpdiff_tpu_torch.ops.spatial import block_radius_adjacency, choose_tile, spatial_sort_permutation
from kpdiff_tpu_torch.parallel import distributed as pdist
from kpdiff_tpu_torch.parallel.kp_shard import shard_encoded
from kpdiff_tpu_torch.parallel.mesh import make_mesh, params_checksum
from kpdiff_tpu_torch.serve import KeypointSampler, decode_ligands
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
# the product alone: both sides sum exact bf16 products in f32, in other orders (about 1e-6); a wrong
# descriptor, swizzle or fragment layout gives errors of order 1
PRODUCT_TOL = 1e-4
SPIN_CYCLES = 20_000_000  # about 10 ms of SM clocks: longer than the host takes to queue a measurement's launches
# (kernel row, its entry, inputs, keywords, launches) of the grids at B <= 32, read by the profiler last
PROFILE_LATER = []
TRAIN_COMPLEXES = 256  # molgen training split: auto buckets [24, 32, 48], 3 full batches of 64 per epoch
TRAIN_STEPS = 20
TIMED_FROM = 5  # steps 5..19 enter the median ms/step
GRAD_TOL_F32 = 1e-3  # card vs CPU: max abs error of each gradient leaf over that leaf's max abs value
LOSS_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # card vs CPU and kernel vs plain, relative, per loss term
SERVE_BATCH = 64
DEVICE = "cuda"  # of phases 5, 7 and 8 (the functions below also run on "cpu" at a reduced size)
QUALITY_SPLIT, QUALITY_SEED = 4096, 42  # benchmarks/strided_quality.py: --dataset_size 4096, splits seeded 43 - 1
QUALITY_RECEPTORS, QUALITY_REPLICATES, QUALITY_LAUNCHES, QUALITY_K = 8, 12, 3, 250
QUALITY_GATES = dict(validity=(">=", 0.95), connectivity=(">=", 0.72), atom_type_kl=("<=", 0.03))
RECORD_KEYS = ("n_sampled", "validity", "connectivity", "avg_frag_frac", "atom_validity", "uniqueness", "atom_type_kl",
               "qed", "sa", "logp", "lipinski", "diversity", "props_backend")
FAMILIES = ("egnn_20kp", "egnn_40kp_fast", "egnn_ca", "egnn_all_atom", "gvp_20kp", "gvp_40kp", "gvp_ca",
            "gvp_all_atom", "dev_config")  # phase 9: every config of configs/ besides the flagship
FAMILY_BATCH, FAMILY_K, FAMILY_TRAIN_STEPS, FAMILY_OWN_KK_STEPS = 32, 50, 5, 5
OWN_KK = ("egnn_ca", "egnn_all_atom")  # fixed-encoder EGNN families whose own kk (dense 128 x 128, blocks) feeds the kernel
AA_CELL_KK = (32, 384, 24, 3.5, 257)  # the all-atom cell's kk in the list mode: B, K, cap, rr radius (A), width
# the GVP message kernel's work (models/gvp.py's chain at S 256, V 16): multiply-adds an edge (GVP0's x_unit map,
# Wu0, rbf and |Vh| rows, gates; GVP1 and GVP2's Wh, Wu, [f, |Vh|] rows and gates) and a source node (P and Q)
GVP_EDGE_FLOPS = 2 * (17 * 3 + 17 * 16 * 3 + 16 * 256 + 17 * 256 + 256 * 16
                      + 2 * (2 * 16 * 16 * 3 + 272 * 256 + 256 * 16))
GVP_NODE_FLOPS = 2 * (256 * 256 + 16 * 17 * 3)
GVP_PARAMS = "artifacts/gvp_40kp_trained_params.npz"
GVP_QUALITY_GATES = dict(validity=(">=", 0.95), connectivity=(">=", 0.82), atom_type_kl=("<=", 0.03))
# phase 10: synthetic BindingMOAD splits, train CLI steps and sampling; the upstream graph options' chains
RAW_SPLITS = {"train": 5, "val": 1, "test": 2}
RAW_BATCH, RAW_TRAIN_STEPS, RAW_SAMPLES, RAW_K = 4, 3, 8, 50
REF_BATCH, REF_BUCKET, REF_K, REF_CHECK_STEPS, ENCODER_REPEATS = 32, 32, 50, 3, 3
EXECUTED = dict(dynamics=dict(z_semantics="executed"), rec_encoder=dict(attn_semantics="executed"))
# phase 11: the parallel layer at world size 1 (NCCL)
PAR_STEPS, PAR_BATCH, PAR_BUCKET, PAR_K = 5, 32, 32, 50
# (a)'s gates on the losses and the checksum, by compute dtype: f32 as tests/test_multihost.py; bf16 at about
# six times the readings of sound runs on the H100 (1.146e-4 and 1.5e-4: Adam turns the other summation order's
# bf16 rounding into parameter differences)
PAR_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
# phase 12: graph against eager; a graph step against the eager step on one state, relative to the state's scale
# (bitwise expected); two replays of gvp_40kp's graph step on one state and generator state must agree bitwise
GRAPH_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
GRAPH_PROFILE_STEPS, GVP_GRAPH_K = 10, 50
# phase 13: graph against eager training steps on phase 6's batches; phase 11's bounds for two trainers
GRAPH_TRAIN_STEPS, GRAPH_TRAIN_PROFILED, GRAPH_TRAIN_CHAIN_K = 10, 4, 10
GRAPH_TRAIN_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
RESIDUE = (("N", "N"), ("CA", "C"), ("C", "C"), ("O", "O"), ("CB", "C"), ("CG", "C"), ("CD", "C"), ("OE1", "O"))


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
    once; a list's idx and valid in place of the mask). Operations, for
    the active pairs: in bf16 the two H x H second
    layers on the tensor cores and the elementwise work on the CUDA cores,
    two units that can run at once, so the larger of their times; in f32
    both on the CUDA cores, so their sum."""
    a_es, a_ed = args[0], args[1]
    b, ns, h = a_es.shape
    nd = a_ed.shape[1]
    pairs = int(args[-1].sum())  # the mask's set positions, or a list's valid slots
    matmul = pairs * 2 * 2 * h * h
    elementwise = pairs * 2 * h * ELEMENTWISE_OPS
    n_bytes = sum(t.numel() * t.element_size() for a in args
                  for t in (a if isinstance(a, egnn_edge.PackedW2) else (a,)) if torch.is_tensor(t))
    n_bytes += b * nd * (h + 3) * 4
    if cd == torch.bfloat16:
        t_ops = max(matmul / H100_BF16_FLOPS, elementwise / H100_F32_FLOPS)
    else:
        t_ops = (matmul + elementwise) / H100_F32_FLOPS
    t_bytes = n_bytes / H100_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), pairs


def library_ms(args, cd, iters=20):
    """Yardstick: torch.matmul of the two (B*Ns*Nd, H) x (H, H) second-layer
    products over all pairs, which the port never calls. (ms, device_ms) on
    the kernel's two clocks: CUDA events around back-to-back calls as the
    host makes them (cuda_ms), and the calls queued behind a spin kernel
    (queued_ms)."""
    a_es, a_ed = args[0], args[1]
    b, ns, h = a_es.shape
    p = b * ns * a_ed.shape[1]
    x = torch.randn((p, h), device=a_es.device, dtype=cd)
    w = torch.randn((h, h), device=a_es.device, dtype=cd)

    def call():
        return torch.matmul(x, w), torch.matmul(x, w)

    return cuda_ms(call, iters=iters), queued_ms(call, iters)


def measure(args, cd, label, iters=20):
    """One kernel row: two launches bitwise equal, within TOL of the plain
    version, and the kernel's times beside its bound. `args` are
    egnn_edge_dense's (the mask mode) or egnn_edge_list's (idx, valid in
    place of the mask: the list mode, held against the plain version on the
    list's mask)."""
    kw = dict(use_tanh=True, coords_range=10.0, compute_dtype=cd)
    listed = len(args) == 17
    run = egnn_edge.egnn_edge_list if listed else egnn_edge.egnn_edge_dense
    dense_args = (*args[:15], NbrList(*args[15:]).adjacency(args[0].shape[1])) if listed else args
    got = run(*args, **kw)
    again = run(*args, **kw)
    ref = egnn_edge.egnn_edge_dense_plain(*dense_args, **kw)
    torch.cuda.synchronize()
    for t in got:
        if not torch.isfinite(t).all():
            raise RuntimeError(f"{label}: kernel output not finite")
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        raise RuntimeError(f"{label} {cd}: two launches on the same inputs differ (the sums are deterministic)")
    rel, ab = rel_err(got, ref), abs_err(got, ref)
    if rel > TOL[cd]:
        raise RuntimeError(f"{label} {cd}: kernel vs plain relative error {rel:.3e} > {TOL[cd]:.0e}")
    k_ms = cuda_ms(lambda: run(*args, **kw), iters=iters)
    d_ms = queued_ms(lambda: run(*args, **kw), iters)
    p_ms = cuda_ms(lambda: egnn_edge.egnn_edge_dense_plain(*dense_args, **kw), warmup=1, iters=3)
    del dense_args, ref
    b_ms, b_by, pairs = bound(args, cd)
    lib, lib_d = library_ms(args, cd, iters) if cd == torch.bfloat16 else (None, None)
    row = dict(shape=label, mode="list" if listed else "mask", dtype=str(cd).replace("torch.", ""), pairs=pairs,
               max_rel_err=rel, max_abs_err=ab, bitwise_repeat=True, ms=k_ms, device_ms=d_ms, profiler_ms=None,
               plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib, library_device_ms=lib_d)
    if args[0].shape[0] <= FAMILY_BATCH:  # small grids: torch.profiler's reading too, after every timed phase
        PROFILE_LATER.append((row, run, args, kw, iters))
    print(f"kernel {label} {row['mode']} {row['dtype']}: kernel_ms={k_ms:.4f} device_ms={d_ms:.4f} "
          f"plain_ms={p_ms:.4f} library_ms={lib if lib is None else round(lib, 4)} "
          f"library_device_ms={lib_d if lib_d is None else round(lib_d, 4)} bound_ms={b_ms:.4f} ({b_by}) "
          f"pairs={pairs} max_rel_err={rel:.3e} max_abs_err={ab:.3e}", flush=True)
    return row


def gvp_message_cases(seed, dev):
    """(label, agg, edges, h_src, v_src, x_src, x_dst) of the GVP message
    kernel's check, `edges` the edge set the plain path takes (a NbrList, or
    the kNN PairList, whose destination-major list the kernel takes): a tiny
    list with empty rows; the all-atom cell's kk (molgen pockets in K slots,
    their radius graph at cap 24, AA_CELL_KK); the all-atom cell's and
    gvp_40kp's lk and kl (each keypoint's 7 nearest ligand atoms, molgen
    ligands beside the pockets); node features seeded."""
    from portbench.traffic.molgen import complex_of_size

    rng = np.random.default_rng(seed + 29)
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def feats(b, n):
        return (torch.randn(b, n, 256, generator=gen).to(dev),
                (0.5 * torch.randn(b, n, 16, 3, generator=gen)).to(dev))

    def pockets(b, k, nl):
        xk, mk = torch.zeros(b, k, 3), torch.zeros(b, k, dtype=torch.bool)
        xl, ml = torch.zeros(b, nl, 3), torch.zeros(b, nl, dtype=torch.bool)
        for i in range(b):
            c = complex_of_size(rng, int(rng.integers(13, nl + 1)), ["C", "N", "O", "S"], 4)
            pos = c["rec_pos"][:k]
            xk[i, :len(pos)], mk[i, :len(pos)] = torch.from_numpy(pos), True
            lig = c["lig_pos"]
            xl[i, :len(lig)], ml[i, :len(lig)] = torch.from_numpy(lig), True
        return xk.to(dev), mk.to(dev), xl.to(dev), ml.to(dev)

    cases = []
    b, ns, nd, cap = 2, 11, 9, 7
    idx = torch.randint(0, ns, (b, nd, cap), generator=gen)
    valid = torch.rand(b, nd, cap, generator=gen) < 0.5
    valid[0, 2], valid[1] = False, False  # an empty row, and an empty batch row
    x_s, x_d = 3 * torch.randn(b, ns, 3, generator=gen), 3 * torch.randn(b, nd, 3, generator=gen)
    for agg in ("sum", "mean"):
        cases.append((f"tiny_b2_cap7_{agg}", agg, NbrList(idx.to(dev), valid.to(dev)), *feats(b, ns), x_s.to(dev),
                      x_d.to(dev)))
    b, k, cap, rr, _ = AA_CELL_KK
    xk, mk, xl, ml = pockets(b, k, 32)
    cases.append((f"aa_kk_b{b}_k{k}_cap{cap}", "mean", radius_neighbor_list(xk, mk, xk, mk, rr, cap, exclude_self=True),
                  *feats(b, k), xk, xk))
    kl_idx, _, kl_valid = knn_indices(xl, ml, xk, mk, 7)
    kl = PairList(kl_idx, kl_valid & mk[:, :, None])
    cases.append((f"aa_lk_b{b}_k{k}_cap7", "mean", transpose(kl), *feats(b, 32), xl, xk))
    cases.append((f"aa_kl_b{b}_nl32_cap{k}", "mean", kl, *feats(b, k), xk, xl))
    xk, mk, xl, ml = pockets(BATCH, 40, 32)
    kl_idx, _, kl_valid = knn_indices(xl, ml, xk, mk, 7)
    kl = PairList(kl_idx, kl_valid & mk[:, :, None])
    cases.append((f"gvp40kp_lk_b{BATCH}_k40_cap7", "sum", transpose(kl), *feats(BATCH, 32), xl, xk))
    cases.append((f"gvp40kp_kl_b{BATCH}_nl32_cap40", "sum", kl, *feats(BATCH, 40), xk, xl))
    return cases


def gvp_message_phase(seed, dev, iters=20):
    """The GVP message kernel (ops/cuda/gvp_message.py) against the plain
    path it replaces, the same module's chain in bf16 (GVPEdgeMessages.nbr
    for a list, .pairs for the kNN pairs, lk or kl), on gvp_message_cases:
    within TOL of the plain output's scale, two launches bitwise equal, and
    the kernel's device ms (queued behind a spin kernel) beside the node
    projection's, the kl list build's (`dst_major`, the dynamics' once a
    call), the plain path's and the bound (the chain's FLOPs on the valid
    edges and the projection's on the source nodes, at the bf16 tensor-core
    peak). Returns the rows."""
    from kpdiff_tpu_torch.models.gvp import GVPEdgeMessages

    print(f"built {gvp_message.build(verbose=True)}", flush=True)
    rows, failures = [], []
    for label, agg, plain_edges, h, v, x_s, x_d in gvp_message_cases(seed, dev):
        m = GVPEdgeMessages(256, 16, torch.Generator().manual_seed(seed), agg=agg, dtype="bfloat16").to(dev)
        nd = x_d.shape[1]
        to_list = ((lambda: KernelList.of(dst_major(plain_edges, nd))) if isinstance(plain_edges, PairList)
                   else (lambda: KernelList.of(plain_edges)))
        edges = to_list()
        with torch.no_grad():
            layers, node_w, pack = m._kernel_weights()
            a_src = gvp_message.node_rows(h, v, node_w)

            def kernel():
                return gvp_message.gvp_message_list(a_src, x_s, x_d, layers, edges.idx, edges.valid,
                                                    mean=agg == "mean", rbf_dmax=m.rbf_dmax, pack=pack)

            # destination features: the chain does not read them
            h_d, v_d = h.new_zeros(h.shape[0], nd, h.shape[2]), v.new_zeros(v.shape[0], nd, *v.shape[2:])

            def plain():
                return m(h, v, x_s, h_d, v_d, x_d, plain_edges)

            got, again = kernel(), kernel()
            ref = plain()
            torch.cuda.synchronize()
            finite = all(bool(torch.isfinite(t).all()) for t in got)
            bitwise = all(torch.equal(a, c) for a, c in zip(got, again))
            rel = rel_err(got, ref)
            k_ms = queued_ms(kernel, iters)
            n_ms = queued_ms(lambda: gvp_message.node_rows(h, v, node_w), iters)
            list_ms = queued_ms(to_list, iters) if isinstance(plain_edges, PairList) else None
            route_ms = queued_ms(lambda: m(h, v, x_s, h_d, v_d, x_d, edges), iters)
            p_ms = queued_ms(plain, 3)
        edges_n = int(edges.valid.sum())
        if edges_n != int(edge_count(plain_edges).sum()):
            failures.append(f"{label}: {edges_n} edges in the list, {int(edge_count(plain_edges).sum())} in the pairs")
        flops = edges_n * GVP_EDGE_FLOPS + h.shape[0] * h.shape[1] * GVP_NODE_FLOPS
        b_ms = flops / H100_BF16_FLOPS * 1e3
        kind = "nbr" if isinstance(plain_edges, NbrList) else "pairs_kl" if plain_edges.anchor_is_src else "pairs_lk"
        row = dict(shape=label, agg=agg, plain=kind, edges=edges_n, slots=int(edges.valid.numel()),
                   max_rel_err=rel, bitwise_repeat=bitwise, finite=finite, kernel_device_ms=k_ms,
                   node_rows_device_ms=n_ms, list_build_device_ms=list_ms, route_device_ms=route_ms,
                   plain_device_ms=p_ms, bound_ms=b_ms)
        rows.append(row)
        print(f"gvp_message {label} ({agg}, against {row['plain']}): edges={edges_n}/{row['slots']} "
              f"max_rel_err={rel:.3e} bitwise_repeat={bitwise} kernel_device_ms={k_ms:.4f} "
              f"node_rows_device_ms={n_ms:.4f} list_build_device_ms={list_ms and round(list_ms, 4)} "
              f"route_device_ms={route_ms:.4f} plain_device_ms={p_ms:.4f} bound_ms={b_ms:.4f}", flush=True)
        if not (finite and bitwise and rel <= TOL[torch.bfloat16]):
            failures.append(label)
    if failures:
        raise RuntimeError(f"gvp_message: {failures} not finite, not bitwise repeatable or beyond "
                           f"{TOL[torch.bfloat16]:.0e} of the plain path")
    return rows


def cell_list_args(seed, dev):
    """egnn_edge_list's operands at the all-atom cell's kk (AA_CELL_KK): B
    molgen pockets in K slots, their radius graph as a list at cap, nearest
    first, as tests/test_torch_port_kk_route.py::cell_pockets builds it; the
    pockets' positions on both sides, the other operands seeded, bf16."""
    from portbench.traffic.molgen import complex_of_size

    b, k, cap, rr, h = AA_CELL_KK
    rng = np.random.default_rng(seed)
    x = torch.zeros(b, k, 3)
    mask = torch.zeros(b, k, dtype=torch.bool)
    for i in range(b):
        pos = complex_of_size(rng, int(rng.integers(13, 33)), ["C", "N", "O", "S"], 4)["rec_pos"]
        x[i, :len(pos)], mask[i, :len(pos)] = torch.from_numpy(pos), True
    x, mask = x.to(dev), mask.to(dev)
    idx, valid = radius_neighbor_list(x, mask, x, mask, rr, cap, exclude_self=True)
    if not torch.equal(NbrList(idx, valid).adjacency(k), dense_radius_adjacency(x, mask, x, mask, rr,
                                                                                  exclude_self=True)):
        raise RuntimeError(f"cell kk: a pocket atom has more than {cap} neighbours within {rr} A")
    a = with_dtype(random_args(rng, b, k, k, h, dev)[:15], torch.bfloat16)
    return (*a[:13], x, x, idx.to(torch.int32), valid)


def product_check(seed):
    """The kernel's tensor-core product alone (egnn_edge.wgmma_probe: one 64-row tile, the kernel's
    descriptors, fragments and channel order) against the same bf16 operands multiplied in f32 by
    torch.matmul (an oracle here, never on the path). Returns the max abs error over the max abs value."""
    rng = np.random.default_rng(seed + 11)
    w = torch.tensor(rng.normal(size=(257, 257)).astype(np.float32) / 16, device="cuda")
    packed = egnn_edge.pack_w2(w, torch.bfloat16)
    a = torch.tensor(rng.normal(size=(64, 256)).astype(np.float32), device="cuda").to(torch.bfloat16)
    got = egnn_edge.wgmma_probe(a, packed.main)
    ref = a.float() @ egnn_edge.unpack_w2(packed)[:256, :256]
    torch.cuda.synchronize()
    err = float((got - ref).abs().max() / ref.abs().max())
    print(f"product alone (wgmma m64n256k16 x 16 k-steps, one tile): max_rel_err={err:.3e} "
          f"(tolerance {PRODUCT_TOL:.0e})", flush=True)
    if not err <= PRODUCT_TOL:
        raise RuntimeError(f"the kernel's product alone differs from torch.matmul: {err:.3e}")
    return err


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def queued_ms(fn, iters):
    """Device ms per call of `fn`'s launches, back to back: a spin kernel
    holds the stream while the host queues them, so no host time enters the
    CUDA events (cuda_ms times the wrapper's calls as the host makes them)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiler_ms(fn, iters, tries=3):
    """Device ms per launch of the edge kernel in `fn`, from torch.profiler's
    kernel rows. A run that profiled each row as it went ran its later
    phases 40-70% slower, and some profiles recorded no kernel row, so
    main() reads it after every timed phase, profiling again when that happens."""
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and "egnn_edge" in e.key]
        n = sum(e.count for e in rows)
        if n:
            return sum(_device_us(e) for e in rows) * 1e-3 / n  # per launch it recorded (it may drop a few)
    return None


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
    """The module passes a_* rows and W2 (packed by pack_w2) in the compute dtype; everything else stays f32."""
    out = [egnn_edge.aligned_rows(a, cd) if i < 4 else a for i, a in enumerate(args)]
    out[6] = egnn_edge.pack_w2(args[6], cd)
    out[10] = egnn_edge.pack_w2(args[10], cd)
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
    for section in ("dynamics", "rec_encoder", "dynamics_gvp", "rec_encoder_gvp"):
        if section in cfg:
            cfg[section]["compute_dtype"] = dtype_name
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
    try:  # eagerly: the cached loss graph would replay the kernel
        ev_plain = evaluate(model, fixed, dev, torch.Generator(device=dev).manual_seed(seed + 9), cuda_graph=False)
    finally:
        egnn_mod.egnn_edge_dense = real
    per_batch = launches_per_step(model)
    want = per_batch * len(eval_batches)
    eval_err = {k: _rel(ev_kernel[k], ev_plain[k]) for k in ev_plain}
    print(f"train eval: {len(eval_batches)} held-out batches (buckets "
          f"{[int(b_.lig_x.shape[1]) for b_ in eval_batches]}), {eval_launches} kernel launches "
          f"({per_batch} per batch); kernel vs plain loss rel err "
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
        with ChainLog() as log:
            mols = sampler.sample_for_arrays(pocket["rec_x"], pocket["rec_h"], pocket["rec_res_idx"],
                                             init_com=pocket["lig_x"].mean(0), n_mols=8, ligand_size=20)
        serve_launches = log.check("train export -> serve")["launches"]
    if sampler.last_request["chunks"][0]["sizes"] != [20] * 8:
        raise RuntimeError(f"serving from the exported npz: chunks {sampler.last_request['chunks']}")
    check_molecules("serving from the exported npz", mols, 20, need_bonds=False)
    print(f"train export: checkpoint {ckpt.name}, npz served 8 molecules of 20 atoms ({len(mols)} built) with "
          f"{serve_launches} kernel launches", flush=True)
    record = dict(data_s=data_s, buckets=buckets, train_complexes_per_bucket=per_bucket, card_vs_cpu=compare,
                  steps=rows, step_ms_device=dev_ms, step_ms_host=host_ms, median_ms_device=med_dev,
                  median_ms_host=med_host, median_ms_device_by_bucket=by_bucket, peak_memory_bytes=peak,
                  eval_kernel=ev_kernel, eval_plain=ev_plain, eval_rel_err=eval_err, eval_batches=len(eval_batches),
                  eval_launches=eval_launches, serve_launches=serve_launches)
    return (record, dict(train_steps=train_launches, train_eval=eval_launches, train_serve=serve_launches),
            (batches[:PAR_STEPS], iters_per_epoch), (batches[:GRAPH_TRAIN_STEPS], eval_batches, iters_per_epoch))


def sync():
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def launches_per_step(model) -> int:
    """Edge-kernel launches of one reverse step (or held-out loss) under
    no_grad on the card: n_layers for ll, as many again for kl (the kNN
    mask, or the radius grid with kl_k 0) and, with update_kp_feat, for lk
    and for kk (dense, in blocks, or a neighbor list in the list mode); none for GVP,
    whose kNN pairs and kk lists take the GVP message kernel (gvp_launches_per_step)."""
    if model.gvp:
        return 0
    dyn = model.dynamics
    return dyn.n_layers * (2 + 2 * int(dyn.update_kp_feat))


def gvp_launches_per_step(model, kk, kp_shard=None) -> int:
    """GVP message kernel launches of one reverse step under no_grad on the
    card, unsharded, when every message chain is in the kernel's
    configuration (bf16, S 256, V 16): with kl_k > 0 one in every conv for
    the kl pairs; with update_kp, in each conv but the last, one for the lk
    pairs (kl_k > 0) and one for a kk neighbor list; none for EGNN, a dense or
    block kk, or kl_k 0's dense grids."""
    if not model.gvp or kp_shard is not None:
        return 0
    dyn = model.dynamics
    convs = [getattr(dyn, f"conv{i}") for i in range(dyn.n_convs)]
    if not all(getattr(c, f"message_{e}").kernel_ok for c in convs for e in ("kl", "lk", "kk")
               if hasattr(c, f"message_{e}")):
        return 0
    kl = int(dyn.kl_k > 0)
    return dyn.n_convs * kl + int(dyn.update_kp) * (dyn.n_convs - 1) * (kl + int(list_cap(kk) > 0))


class ChainLog:
    """Counts the kernel launches a path must make: every reverse chain it
    samples (KeypointDiffusion.sample) adds launches_per_step edge-kernel
    launches and gvp_launches_per_step GVP message launches a step. Counts
    launches and chains from zero when entered."""

    def __enter__(self):
        self.chains, self.real = [], KeypointDiffusion.sample
        log, real = self.chains, self.real

        def logged(model, cpx, kk, *a, **kw):
            steps = kw.get("sample_steps") or 0
            n = steps if 0 < steps < model.cfg.n_timesteps else model.cfg.n_timesteps
            log.append(dict(steps=n, kk=layout_name(kk), per_step=launches_per_step(model),
                            gvp_per_step=gvp_launches_per_step(model, kk, kw.get("kp_shard")),
                            batch=int(cpx.lig_x.shape[0]), bucket=int(cpx.lig_x.shape[1])))
            return real(model, cpx, kk, *a, **kw)

        KeypointDiffusion.sample = logged
        sync()
        egnn_edge.launches = 0
        gvp_message.launches = 0
        return self

    def __exit__(self, *exc):
        sync()
        KeypointDiffusion.sample = self.real
        self.launches, self.gvp_launches = egnn_edge.launches, gvp_message.launches
        self.steps = sum(c["steps"] for c in self.chains)
        self.want = sum(c["steps"] * c["per_step"] for c in self.chains)
        self.gvp_want = sum(c["steps"] * c["gvp_per_step"] for c in self.chains)
        self.layouts = sorted({c["kk"] for c in self.chains})

    def check(self, label):
        per_step = self.launches / max(self.steps, 1)
        gvp_per_step = self.gvp_launches / max(self.steps, 1)
        print(f"  {label}: {len(self.chains)} chains, {self.steps} reverse steps, kk {self.layouts}, "
              f"{self.launches} kernel launches ({per_step:g} a step; expected {self.want}), "
              f"{self.gvp_launches} gvp_message launches ({gvp_per_step:g} a step; expected {self.gvp_want})",
              flush=True)
        if not self.chains or self.launches != self.want or self.gvp_launches != self.gvp_want:
            raise RuntimeError(f"{label}: {self.launches} kernel and {self.gvp_launches} gvp_message launches over "
                               f"{self.chains}, expected {self.want} and {self.gvp_want}")
        return dict(launches=self.launches, steps=self.steps, chains=len(self.chains), kk=self.layouts,
                    launches_per_step=per_step, gvp_launches=self.gvp_launches, gvp_launches_per_step=gvp_per_step)


def synthetic_complex_lines(rng, lig_elements, n_lig=24, n_res=60, min_dist=3.5, extent=12.0):
    """PDB ATOM lines of n_res eight-atom residues placed around a molgen
    ligand of n_lig atoms (no receptor atom within min_dist of it; residue
    centres within `extent` of a ligand atom), the ligand's coordinates and
    its elements. At pocket_cutoff 8 its pocket holds 260-384 atoms."""
    lig, types = random_molecule(rng, n_lig, lig_elements)
    lig = (lig + 30.0).astype(np.float32)
    centers = []
    while len(centers) < n_res:
        d = rng.normal(size=3)
        c = lig[rng.integers(len(lig))] + d / np.linalg.norm(d) * rng.uniform(min_dist + 1.5, extent)
        if np.linalg.norm(lig - c, axis=1).min() < min_dist + 1.5:
            continue
        if centers and np.linalg.norm(np.asarray(centers) - c, axis=1).min() < 4.2:
            continue
        centers.append(c)
    lines = []
    for r, c in enumerate(centers):
        for name, el in RESIDUE:
            x = c + rng.normal(scale=1.1, size=3)
            while np.linalg.norm(lig - x, axis=1).min() < min_dist:
                x = c + rng.normal(scale=1.1, size=3)
            lines.append(format_pdb_line(len(lines) + 1, name, "GLU", "A", r + 1, *x, el))
    return lines, lig, [lig_elements[t] for t in types]


def write_synthetic_complex(rng, out_dir, lig_elements, **kw):
    """synthetic_complex_lines as receptor.pdb and the ligand as
    ref_ligand.sdf (with its perceived bonds) in out_dir."""
    lines, lig, els = synthetic_complex_lines(rng, lig_elements, **kw)
    pdb, sdf = Path(out_dir) / "receptor.pdb", Path(out_dir) / "ref_ligand.sdf"
    pdb.write_text("\n".join(lines) + "\nEND\n")
    write_sdf([SdfMol("ref_ligand", els, lig, perceive_bonds(lig, els))], sdf)
    return pdb, sdf


def make_run_dir(root, params_path, train_ds, test_ds):
    """A port run directory from a keystr npz: config.yml (the port's YAML
    writer), checkpoints/step_0.pt, and a dataset.location holding the
    size histogram of `train_ds` and the first two pockets of `test_ds` as
    test.pkl."""
    cfg = load_config(CONFIG)
    data = Path(root) / "data"
    data.mkdir(parents=True)
    cfg["dataset"]["location"] = str(data)
    save_dataset_histogram(train_ds, data)
    test_ds.subset([0, 1]).to_pickle(data / "test.pkl")
    return make_run_dir_from_params(cfg, params_path, Path(root) / "run"), cfg


def check_molecules(label, mols, n_lig_max, need_bonds=True):
    if need_bonds and not any(m.bonds for m in mols):
        raise RuntimeError(f"{label}: {len(mols)} molecules, none with a bond")
    for m in mols:
        if not np.isfinite(m.coords).all() or m.coords.shape != (m.n_atoms, 3) or not 1 <= m.n_atoms <= n_lig_max:
            raise RuntimeError(f"{label}: a molecule of {m.n_atoms} atoms, coordinates {m.coords.shape}")


def serve_phase(run, cfg, pdb, sdf, seed, tmp):
    """Phase 5. Returns the sampler, its record and its kernel launches by path."""
    sampler = KeypointSampler(run, batch_size=SERVE_BATCH, seed=seed, sample_steps=STEPS, device=DEVICE)
    data = process_ligand_and_pocket(str(pdb), str(sdf), cfg)
    n_ref = int(data["lig_pos"].shape[0])
    outs = []
    real_run = sampler._run

    def checked_run(cpx, init_com):  # every chunk: finite coordinates, one ligand of each drawn size
        out, *rest = real_run(cpx, init_com)
        outs.append((out["lig_mask"].sum(1).tolist(), bool(torch.isfinite(out["lig_x"]).all())))
        return (out, *rest)

    sampler._run = checked_run
    rows, paths = {}, {}
    arrays = dict(rec_pos=data["rec_pos"], rec_feat=data["rec_feat"], rec_res_idx=data["rec_res_idx"],
                  interface_points=data["interface_points"], init_com=data["lig_pos"].mean(0), ref_n_atoms=n_ref)
    # graphs by default (the first request of each bucket and kk cap captures one); then serve_ref again with
    # the sampler asked for eager steps, and once more through its cached graph, for the latency of each
    requests = (("serve_int", dict(n_mols=SERVE_BATCH, ligand_size=20)),
                ("serve_ref", dict(n_mols=SERVE_BATCH, ligand_size="ref")),
                ("serve_random", dict(n_mols=SERVE_BATCH + SERVE_BATCH // 2, ligand_size="random")),
                ("serve_pocket", dict(n_mols=SERVE_BATCH, ligand_size="ref")),
                ("serve_ref_eager", dict(n_mols=SERVE_BATCH, ligand_size="ref")),
                ("serve_ref_graph", dict(n_mols=SERVE_BATCH, ligand_size="ref")))
    graphs = sampler.model.chain_graphs if DEVICE == "cuda" else None
    model = sampler.model

    def eager_sample(*a, **kw):  # the class's sample (ChainLog's while it logs), asked for eager steps
        return type(model).sample(model, *a, **kw, cuda_graph=False)

    for label, kw in requests:
        outs.clear()
        if label.endswith("_eager"):
            model.sample = eager_sample
        else:
            model.__dict__.pop("sample", None)
        n_captures = len(graphs.captures) if graphs is not None else 0
        with ChainLog() as log:
            t0 = time.perf_counter()
            if label == "serve_pocket":
                mols = sampler.sample_for_pocket(pdb, sdf, **kw)
            else:
                mols = sampler.sample_for_arrays(**arrays, **kw)
            latency = time.perf_counter() - t0
        t1 = time.perf_counter()
        write_sdf([m.to_sdf_mol(title=f"{label}_{j}") for j, m in enumerate(mols)], Path(tmp) / f"{label}.sdf")
        write_s = time.perf_counter() - t1
        req = sampler.last_request
        sizes = [s for c in req["chunks"] for s in c["sizes"]]
        want = {"serve_int": [20] * kw["n_mols"]}.get(label, [n_ref] * kw["n_mols"])
        if label == "serve_random":
            if len(sizes) != kw["n_mols"] or len({c["bucket"] for c in req["chunks"]}) < 2:
                raise RuntimeError(f"{label}: sizes {sizes} in chunks {req['chunks']}: not two buckets")
        elif sizes != want:
            raise RuntimeError(f"{label}: drew sizes {sizes}, expected {want}")
        for (got_sizes, finite), c in zip(outs, req["chunks"]):  # chunks repeat-padded to SERVE_BATCH rows
            n = len(c["sizes"])
            if (not finite or len(got_sizes) != SERVE_BATCH or sorted(got_sizes[:n]) != sorted(c["sizes"])
                    or got_sizes[n:] != [c["sizes"][-1]] * (SERVE_BATCH - n)):
                raise RuntimeError(f"{label}: chunk of sizes {c['sizes']} came out with sizes {got_sizes}, "
                                   f"finite={finite}")
        check_molecules(label, mols, max(sizes))
        paths[label] = log.check(label)
        parts = {k: req[k] for k in ("parse_pocket_s", "front_end_s", "sample_s", "copy_s", "build_s") if k in req}
        new_captures = graphs.captures[n_captures:] if graphs is not None else []
        rows[label] = dict(latency_s=latency, write_sdf_s=write_s, n_mols=kw["n_mols"], n_built=len(mols),
                           n_bonded=sum(bool(m.bonds) for m in mols), chunks=req["chunks"], **parts,
                           cuda_graph=not label.endswith("_eager"),
                           captures=[dict(capture_s=c["capture_s"], pool_bytes=c["pool_bytes"]) for c in new_captures],
                           **({"pocket_atoms": req["pocket_atoms"]} if "pocket_atoms" in req else {}))
        print(f"serve {label}: {latency:.3f} s for {kw['n_mols']} molecules ("
              + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()) + f", write_sdf_s {write_s:.4f}); "
              f"{len(mols)} built, {rows[label]['n_bonded']} with bonds; buckets "
              f"{[c['bucket'] for c in req['chunks']]}; "
              + ("eager steps" if label.endswith("_eager") else
                 f"graph replays, {len(new_captures)} captures ({sum(c['capture_s'] for c in new_captures):.3f} s)"),
              flush=True)
    sampler._run = real_run
    model.__dict__.pop("sample", None)
    return sampler, dict(requests=rows, pocket_atoms=int(data["rec_pos"].shape[0]), ref_atoms=n_ref,
                         interface_points=int(data["interface_points"].shape[0])), paths


def frontends_phase(run, cfg, sampler, pdb, sdf, seed, tmp):
    """Phase 7: the byop, sample, serve_http and train CLIs on the card."""
    tmp = Path(tmp)
    rows, paths = {}, {}
    cif = tmp / "receptor.cif"
    write_mmcif(parse_pdb(pdb), cif)
    for label, receptor in (("byop_pdb", pdb), ("byop_mmcif", cif)):
        out = tmp / label
        with ChainLog() as log:
            t0 = time.perf_counter()
            mols = byop_cli.main(["--model_dir", str(run), "--receptor_file", str(receptor), "--ligand_file",
                                  str(sdf), "--out", str(out), "--n_mols", str(SERVE_BATCH), "--sample_steps",
                                  str(STEPS), "--ligand_size", "ref", "--seed", str(seed), "--device", DEVICE])
            dt = time.perf_counter() - t0
        back = parse_sdf(out / "raw_ligands.sdf")
        n_kp = len((out / "keypoints.xyz").read_text().splitlines()) - 2
        if len(back) != len(mols) or not (out / "pocket.pdb").is_file() or n_kp != cfg["graph"]["n_keypoints"]:
            raise RuntimeError(f"{label}: {len(back)} of {len(mols)} molecules read back, {n_kp} keypoints")
        check_molecules(label, mols, cfg["padding"]["n_lig"])
        paths[label] = log.check(label)
        rows[label] = dict(s=dt, n_built=len(mols), pocket_atoms=len(parse_pdb(out / "pocket.pdb")))
        print(f"front end {label}: {dt:.3f} s, {len(mols)} molecules, pocket.pdb {rows[label]['pocket_atoms']} "
              f"atoms", flush=True)

    out = tmp / "sampled"
    with ChainLog() as log:
        t0 = time.perf_counter()
        sample_cli.main(["--model_dir", str(run), "--out", str(out), "--dataset_size", "2", "--samples_per_pocket",
                         "32", "--max_batch_size", str(SERVE_BATCH), "--sample_steps", str(STEPS), "--max_tries", "2",
                         "--visualize", "--seed", str(seed), "--device", DEVICE])
        dt = time.perf_counter() - t0
    tries = 0
    for i in range(2):
        pdir = out / f"pocket_{i}"
        with open(pdir / "sample_time.pkl", "rb") as f:
            st = pickle.load(f)
        back = parse_sdf(pdir / "raw_ligands.sdf")
        trajs = sorted((pdir / "trajectories").glob("*.sdf"))
        if (set(st) != {"time", "n_valid", "n_tries", "batch"} or len(back) != st["n_valid"] or not back
                or not all((pdir / f).is_file() for f in ("pocket.pdb", "keypoints.xyz", "sample_time.txt"))
                or len(trajs) != min(len(back), 10) or not all(parse_sdf(p) for p in trajs)):
            raise RuntimeError(f"sample CLI pocket_{i}: layout or SDFs wrong ({st}, {len(back)} read back, "
                               f"{len(trajs)} trajectories)")
        tries += st["n_tries"]
        rows[f"sample_cli_pocket_{i}"] = st
    paths["sample_cli"] = log.check("sample_cli")
    if len(log.chains) != tries:
        raise RuntimeError(f"sample CLI: {len(log.chains)} chains for {tries} tries")
    print(f"front end sample_cli: {dt:.3f} s, " + "; ".join(
        f"pocket_{i} {rows[f'sample_cli_pocket_{i}']['n_valid']} valid in {rows[f'sample_cli_pocket_{i}']['n_tries']} "
        "tries" for i in range(2)), flush=True)

    server = serve_http.make_server(sampler, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        body = json.dumps({"receptor_pdb": Path(pdb).read_text(), "ref_ligand_sdf": Path(sdf).read_text(),
                           "n_mols": 16, "ligand_size": "ref"}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{server.server_address[1]}/sample_files", data=body,
                                     headers={"Content-Type": "application/json"}, method="POST")
        with ChainLog() as log:
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=300) as r:
                status, payload = r.status, json.loads(r.read())
            dt = time.perf_counter() - t0
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    (tmp / "http.sdf").write_text(payload.get("sdf", ""))
    if status != 200 or payload["n"] < 1 or len(parse_sdf(tmp / "http.sdf")) != payload["n"]:
        raise RuntimeError(f"POST /sample_files: status {status}, {payload.get('n')} molecules")
    paths["serve_http"] = log.check("serve_http")
    rows["serve_http"] = dict(s=dt, n=payload["n"])
    print(f"front end serve_http: POST /sample_files {dt:.3f} s, {payload['n']} molecules", flush=True)

    # the train CLI with the config's own sample_interval: the analyzer fires at epoch ~0
    cfg_path = tmp / "train.yml"
    train_cfg = load_config(CONFIG)
    train_cfg["experiment"]["results_dir"] = str(tmp / "runs")
    cfg_path.write_text(dump_yaml(train_cfg))
    analyzer_logs = []
    real_analyze = ModelAnalyzer.sample_and_analyze

    def logged_analyze(self, *a, **kw):
        n_captures = len(self.model.chain_graphs.captures)
        with ChainLog() as alog:
            t0 = time.perf_counter()
            m = real_analyze(self, *a, **kw)
            alog.seconds = time.perf_counter() - t0
        alog.captures = self.model.chain_graphs.captures[n_captures:]  # recaptured: the weights changed
        analyzer_logs.append(alog)
        return m

    ModelAnalyzer.sample_and_analyze = logged_analyze
    try:
        t0 = time.perf_counter()
        run_dir, state = train_cli.main(["--config", str(cfg_path), "--device", DEVICE, "--synthetic_mol",
                                         str(TRAIN_COMPLEXES), "--epochs", "1", "--seed", str(seed)])
        dt = time.perf_counter() - t0
    finally:
        ModelAnalyzer.sample_and_analyze = real_analyze
    test_rows = trainer.MetricsLog(run_dir / "test_metrics.pkl").rows
    mol_rows = [r for r in test_rows if "mol_connectivity" in r]
    if train_cfg["training"]["sample_interval"] <= 0 or len(analyzer_logs) != 1 or len(mol_rows) != 1:
        raise RuntimeError(f"train CLI: analyzer ran {len(analyzer_logs)} times, {len(mol_rows)} mol_* rows")
    paths["train_cli_analyzer"] = analyzer_logs[0].check("train_cli_analyzer")
    step = best_step(run_dir)
    export_params(run_dir, tmp / "best.npz", step)
    load_params(model_from_config(load_config(run_dir / "config.yml"), device="cpu"), read_keystr_npz(tmp / "best.npz"))
    a_caps = analyzer_logs[0].captures
    if DEVICE == "cuda" and len(a_caps) != 1:
        raise RuntimeError(f"train CLI analyzer: {len(a_caps)} graph captures, expected 1")
    rows["train_cli"] = dict(s=dt, steps=state.step, analyzer_s=analyzer_logs[0].seconds, best_step=step,
                             analyzer_capture_s=[c["capture_s"] for c in a_caps],
                             analyzer_pool_bytes=[c["pool_bytes"] for c in a_caps],
                             mol_row={k: v for k, v in mol_rows[0].items() if not isinstance(v, str)})
    print(f"front end train CLI: {state.step} steps and the analyzer in {dt:.3f} s (analyzer "
          f"{analyzer_logs[0].seconds:.3f} s, its graph captured in {sum(c['capture_s'] for c in a_caps):.3f} s, "
          f"mol_connectivity {mol_rows[0]['mol_connectivity']:.4f}, "
          f"mol_validity {mol_rows[0]['mol_validity']:.4f}); export_params --best -> step {step}", flush=True)
    return rows, paths


def _without_dropout(name):
    """configs/<name>.yml with GVP dropout off (the card-against-CPU comparison draws no masks)."""
    cfg = load_config(f"configs/{name}.yml")
    for section in ("dynamics_gvp", "rec_encoder_gvp"):
        if section in cfg:
            cfg[section]["dropout"] = 0.0
    return cfg


def family_phase(name, seed, dev, data_cache, kernel_rows):
    """Phase 9 for one config at full width and depth, seeded weights:
    encode -> compact_kk -> a K=FAMILY_K chain at batch FAMILY_BATCH under
    no_grad (launches by layout); for OWN_KK a chain on the encoder's own kk
    with every launch held against the plain version; loss and gradients on
    the card against the CPU (f32, dropout 0); FAMILY_TRAIN_STEPS optimizer
    steps at batch FAMILY_BATCH with the config's dropout, remat and
    grad_accum. Appends the kernel's first launch at each new shape to
    `kernel_rows` (inputs, dtype). Returns the record and each path's
    ChainLog.check record."""
    t_fam = time.perf_counter()
    cfg = load_config(f"configs/{name}.yml")
    pad = PaddingConfig.from_config(cfg)
    n_rec_feat, n_lig_feat, _ = resolve_feature_sizes(cfg)
    model = model_from_config(cfg, device=dev, seed=seed)
    model.eval()
    rec = dict(arch=model.cfg.architecture, encoder=model.cfg.rec_encoder_type,
               kk_layout=model.cfg.dynamics.get("kk_layout", "dense"), n_rec=pad.n_rec, n_kp=pad.n_kp,
               n_lig=pad.n_lig, params=sum(p.numel() for p in model.parameters()))
    paths = {}
    cpx = synthetic_batch(seed, batch=FAMILY_BATCH, n_rec_pad=pad.n_rec, n_lig_pad=pad.n_lig, n_rec_feat=n_rec_feat,
                          n_lig_feat=n_lig_feat, n_kp=pad.n_kp, kp_feat_dim=model.cfg.rec_nf,
                          kp_vec_dim=model.kp_vec_dim, n_ip_pad=pad.n_ip, min_rec=min(260, 3 * pad.n_rec // 4),
                          min_lig=min(18, pad.n_lig - 2), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    seen = {}
    real_wrapper, real_list = egnn_mod.egnn_edge_dense, egnn_mod.egnn_edge_list

    def recording(*a, **kw):  # the first launch at each (B, Ns, Nd, H) of this family's paths
        key = (int(a[0].shape[0]), int(a[0].shape[1]), int(a[1].shape[1]), int(a[0].shape[2]))
        if key not in seen:
            seen[key] = (egnn_edge.snapshot_args(a), kw["compute_dtype"])
        return real_wrapper(*a, **kw)

    def recording_list(*a, **kw):  # the list mode's first launch at each (B, Ns, Nd, H, cap)
        key = (int(a[0].shape[0]), int(a[0].shape[1]), int(a[1].shape[1]), int(a[0].shape[2]), int(a[15].shape[2]))
        if key not in seen:
            seen[key] = (egnn_edge.snapshot_args(a), kw["compute_dtype"])
        return real_list(*a, **kw)

    # ---- sampling: encode -> compact_kk -> K steps
    egnn_mod.egnn_edge_dense, egnn_mod.egnn_edge_list = recording, recording_list
    try:
        with torch.no_grad():
            enc, own_kk = model.encode(cpx)
            kk = model.compact_kk(enc, own_kk)
            model.sample(enc, kk, sample_steps=2, generator=gen)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        with ChainLog() as log, torch.no_grad():
            t0 = time.perf_counter()
            out = model.sample(enc, kk, sample_steps=FAMILY_K, generator=gen)
            torch.cuda.synchronize()
            chain_s = time.perf_counter() - t0
    finally:
        egnn_mod.egnn_edge_dense, egnn_mod.egnn_edge_list = real_wrapper, real_list
    for k, shape in (("lig_x", (FAMILY_BATCH, pad.n_lig, 3)), ("lig_h", (FAMILY_BATCH, pad.n_lig, n_lig_feat))):
        if tuple(out[k].shape) != shape or not torch.isfinite(out[k]).all():
            raise RuntimeError(f"{name}: {k} has shape {tuple(out[k].shape)} or is not finite")
    paths[f"family_{name}"] = log.check(f"{name} sample (kk {layout_name(own_kk)} -> {layout_name(kk)})")
    if model.gvp and dev.type == "cuda" and not paths[f"family_{name}"]["gvp_launches"]:
        # every GVP config is in the message kernel's configuration
        raise RuntimeError(f"{name}: the GVP message kernel never ran on its kNN pairs or kk list")
    rec.update(sample=dict(kk_encoder=layout_name(own_kk), kk_sample=layout_name(kk), chain_s=chain_s,
                           ms_per_step=chain_s / FAMILY_K * 1e3, s_per_ligand=chain_s / FAMILY_BATCH,
                           peak_memory_bytes=torch.cuda.max_memory_allocated(), **paths[f"family_{name}"]))

    # ---- the encoder's own kk (dense 128 x 128, blocks): every launch against the plain version
    if name in OWN_KK:
        errs = []

        def checking(*a, **kw):
            got = recording(*a, **kw)
            errs.append(rel_err(got, egnn_edge.egnn_edge_dense_plain(*a, **kw)))
            return got

        egnn_mod.egnn_edge_dense = checking
        try:
            with ChainLog() as log, torch.no_grad():
                model.sample(enc, own_kk, sample_steps=FAMILY_OWN_KK_STEPS, generator=gen, cuda_graph=False)
        finally:
            egnn_mod.egnn_edge_dense = real_wrapper
        paths[f"family_{name}_own_kk"] = log.check(f"{name} own kk {layout_name(own_kk)}")
        worst = max(errs)
        print(f"  {name}: {len(errs)} launches on its own kk, each against the plain version: max_rel_err "
              f"{worst:.3e} (tolerance {TOL[torch.bfloat16]:.0e})", flush=True)
        if not worst <= TOL[torch.bfloat16] or len(errs) != paths[f"family_{name}_own_kk"]["launches"]:
            raise RuntimeError(f"{name}: own-kk launches differ from the plain version ({worst:.3e})")
        rec["own_kk"] = dict(max_rel_err=worst, **paths[f"family_{name}_own_kk"])
    del enc, own_kk, kk, out, cpx
    kernel_rows.extend((name, key, a, cd) for key, (a, cd) in seen.items())

    # ---- training data (molgen, shared by configs with the same pocket and ligand shapes)
    dkey = (pad.n_rec, pad.n_lig, bool(cfg["dataset"].get("ca_only", False)), n_rec_feat)
    if dkey not in data_cache:
        data_cache[dkey] = molgen_splits_for_config(cfg, pad, n_rec_feat, FAMILY_TRAIN_STEPS * FAMILY_BATCH, seed)[0]
    train_ds = data_cache[dkey]
    buckets = resolve_lig_buckets(cfg, train_ds, pad.n_lig)

    def loader(bs, s):
        return PaddedLoader(train_ds, pad, bs, pad.n_kp, model.cfg.rec_nf, seed=s, drop_last=True,
                            lig_buckets=buckets, kp_vec_dim=model.kp_vec_dim)

    # ---- loss and gradients, card against CPU (f32, dropout 0), batch of 1 (the all-atom CPU pass takes seconds)
    small = next(loader(1, seed).epoch())
    rng = np.random.default_rng(seed + 3)
    b, n, f = small.lig_h.shape
    t_eps = (rng.integers(0, cfg["diffusion"]["n_timesteps"], b), rng.normal(size=(b, n, 3)).astype(np.float32),
             rng.normal(size=(b, n, f)).astype(np.float32))
    flat = {k: v.detach().cpu().numpy() for k, v in model.named_parameters()}
    t0 = time.perf_counter()
    loss_err, leaf_err, grad_rel_all, losses = card_vs_cpu(_without_dropout(name), flat, small, t_eps,
                                                           dev, "float32")
    worst_leaf = max(leaf_err, key=leaf_err.get)
    print(f"  {name} card vs CPU f32 (batch 1, bucket {n}, dropout 0): loss rel err "
          + ", ".join(f"{k} {v:.3e}" for k, v in sorted(loss_err.items()))
          + f" (gate {LOSS_TOL[torch.float32]:.0e}); worst of {len(leaf_err)} gradient leaves {worst_leaf} "
          f"{leaf_err[worst_leaf]:.3e} (gate {GRAD_TOL_F32:.0e}); {time.perf_counter() - t0:.3f} s", flush=True)
    if max(loss_err.values()) > LOSS_TOL[torch.float32] or leaf_err[worst_leaf] > GRAD_TOL_F32:
        raise RuntimeError(f"{name} card vs CPU f32: losses {loss_err}, worst leaf {worst_leaf} "
                           f"{leaf_err[worst_leaf]:.3e}")
    rec["card_vs_cpu"] = dict(loss_rel_err=loss_err, grad_leaf_rel_err_max=leaf_err[worst_leaf],
                              grad_leaf_worst=worst_leaf, grad_leaves=len(leaf_err), losses_card=losses)

    # ---- optimizer steps at FAMILY_BATCH with the config's dropout, remat and grad_accum
    tcfg = dataclasses.replace(train_config_from(cfg), batch_size=FAMILY_BATCH)
    train_loader = loader(FAMILY_BATCH, seed)
    batches = []
    while len(batches) < FAMILY_TRAIN_STEPS:
        batches.extend(train_loader.epoch())
    state = trainer.init_train_state(model, tcfg)
    step_fn = trainer.make_train_step(tcfg, max(len(train_ds) // FAMILY_BATCH, 1))
    tgen = torch.Generator(device=dev).manual_seed(seed + 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    egnn_edge.launches = 0
    rows, ms = [], []
    for batch in batches[:FAMILY_TRAIN_STEPS]:
        batch = batch.to(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        m = step_fn(state, batch, generator=tgen)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        rows.append(dict(bucket=int(batch.lig_x.shape[1]), **m))
    train_launches = egnn_edge.launches
    peak = torch.cuda.max_memory_allocated()
    bad = [r for r in rows if r["skipped_nonfinite"] or not all(np.isfinite(r[k]) for k in ("l2", "total"))]
    if bad or train_launches:
        raise RuntimeError(f"{name} training: non-finite or skipped steps {bad}; {train_launches} kernel launches")
    med = statistics.median(ms[1:])
    print(f"  {name} train {FAMILY_TRAIN_STEPS} steps at batch {FAMILY_BATCH} (grad_accum {tcfg.grad_accum}, "
          f"remat {model.cfg.dynamics.get('remat', False)}, dropout {model.cfg.dynamics.get('dropout', 0)}): "
          f"median {med:.3f} ms/step on CUDA events (steps 1-{FAMILY_TRAIN_STEPS - 1}; first {ms[0]:.3f}); peak "
          f"memory {peak / 2**30:.3f} GiB; l2 " + ", ".join(f"{r['l2']:.4f}" for r in rows), flush=True)
    rec["train"] = dict(ms_per_step=ms, median_ms=med, peak_memory_bytes=peak, grad_accum=tcfg.grad_accum,
                        steps=rows, buckets=buckets)
    rec["seconds"] = time.perf_counter() - t_fam
    print(f"family {name}: {rec['arch']} {rec['encoder']} encoder, kk {rec['sample']['kk_encoder']} -> "
          f"{rec['sample']['kk_sample']}, {rec['params']:,} parameters; K={FAMILY_K} chain at batch {FAMILY_BATCH} "
          f"{chain_s:.3f} s ({rec['sample']['ms_per_step']:.3f} ms/step, {rec['sample']['launches']} launches); "
          f"phase {rec['seconds']:.3f} s", flush=True)
    del model, state
    torch.cuda.empty_cache()
    return rec, paths


def quality_phase(model, cfg, train_ds, test_ds, seed, record_file="STRIDED_QUALITY.json", gates=QUALITY_GATES):
    """benchmarks/strided_quality.py's protocol on the port at K=QUALITY_K
    (phase 8; phase 9 for GVP), beside `record_file`'s K=QUALITY_K row."""
    pad = PaddingConfig.from_config(cfg)
    lig_elements = cfg["dataset"]["lig_elements"]
    idxs = np.random.default_rng(50).choice(len(test_ds), size=QUALITY_RECEPTORS, replace=False)
    items = []
    for i in idxs:
        it = pad_item(test_ds.get(int(i)), pad, n_lig_feat_out=model.cfg.atom_nf)
        if it is not None:
            items.extend([it] * QUALITY_REPLICATES)
    cpx = to_complex(items, pad, model.cfg.rec_nf, model.kp_vec_dim, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 250)
    ligands = []
    with ChainLog() as log, torch.no_grad():
        t0 = time.perf_counter()
        enc, kk = model.encode(cpx)
        kk = model.compact_kk(enc, kk)
        for _ in range(QUALITY_LAUNCHES):
            ligands.extend(decode_ligands(model.sample(enc, kk, sample_steps=QUALITY_K, eta=1.0, generator=gen),
                                          lig_elements))
        sample_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    metrics = evaluate_samples([c for c, _ in ligands], [e for _, e in ligands],
                               train_type_counts=type_counts(train_ds), element_list=lig_elements)
    metrics_s = time.perf_counter() - t0
    record = next(r for r in json.loads(Path(record_file).read_text())["rows"] if r["K"] == QUALITY_K)
    print(f"quality {model.cfg.architecture} K={QUALITY_K} eta=1, {len(ligands)} molecules ({len(items)} x "
          f"{QUALITY_LAUNCHES} launches; sampling {sample_s:.3f} s, metrics {metrics_s:.3f} s); port | "
          f"{record_file} K={QUALITY_K}:", flush=True)
    for k in RECORD_KEYS:
        ci = f" +- {record[k + '_ci95']}" if k + "_ci95" in record else ""
        print(f"  {k}: {metrics.get(k)} | {record.get(k)}{ci}", flush=True)
    path = log.check("quality")
    failed = {k: metrics.get(k) for k, (op, lim) in gates.items()
              if metrics.get(k) is None or not (metrics[k] >= lim if op == ">=" else metrics[k] <= lim)}
    if len(ligands) != QUALITY_RECEPTORS * QUALITY_REPLICATES * QUALITY_LAUNCHES or failed:
        raise RuntimeError(f"quality: {len(ligands)} molecules; gates {gates} failed by {failed}")
    return dict(port=metrics, record={k: record.get(k) for k in RECORD_KEYS}, gates=gates,
                n_molecules=len(ligands), sample_s=sample_s, metrics_s=metrics_s), path


# ---- phase 10: the reference user's path

def load_pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def write_moad_raw(rng, root, lig_elements, counts=RAW_SPLITS):
    """BindingMOAD layout under root: {id}.bio1 assemblies (synthetic_complex_lines
    with the ligand as HETATM LIG A 201) and moad_{split}.txt split files of
    counts[split] entries each."""
    data, splits = Path(root) / "moad", Path(root) / "splits"
    data.mkdir(parents=True)
    splits.mkdir()
    k = 0
    for split, n in counts.items():
        entries = []
        for _ in range(n):
            k += 1
            pid = f"{k}syn"
            lines, lig, els = synthetic_complex_lines(rng, lig_elements, n_lig=int(rng.integers(18, 27)))
            for j, (p, el) in enumerate(zip(lig, els)):
                lines.append(format_pdb_line(len(lines) + 1, f"{el}{j}"[:4], "LIG", "A", 201, *p, el, hetero=True))
            (data / f"{pid}.bio1").write_text("\n".join(lines) + "\nEND\n")
            entries.append(f"{pid}_LIG:A:201\n")
        (splits / f"moad_{split}.txt").write_text("".join(entries))
    return data, splits


def raw_data_phase(cfg, seed, tmp):
    """Phase 10 (a): synthetic BindingMOAD assemblies -> the port's
    process_bindingmoad -> its train CLI (RAW_TRAIN_STEPS steps) -> its sample
    CLI with --ligand_size random -> compute_metrics; then process_crossdocked
    on a few pocket/ligand pairs. Returns the record and launches by path."""
    from kpdiff_tpu_torch.cli import compute_metrics, process_bindingmoad, process_crossdocked

    tmp = Path(tmp)
    rng = np.random.default_rng(seed + 10)
    lig_elements = cfg["dataset"]["lig_elements"]
    t0 = time.perf_counter()
    data, splits = write_moad_raw(rng, tmp / "raw", lig_elements)
    processed = tmp / "processed"
    process_bindingmoad.main(["--data_dir", str(data), "--split_dir", str(splits), "--out", str(processed)])
    process_s = time.perf_counter() - t0
    _, rec_bounds, lig_bounds = load_pickle(processed / "train_n_node_joint_dist.pkl")
    n_split = {s: len(load_pickle(processed / f"{s}.pkl")["lig_files"]) for s in RAW_SPLITS}
    tensors = [k for k, v in load_pickle(processed / "train.pkl").items() if torch.is_tensor(v)]
    if n_split != RAW_SPLITS or tensors:
        raise RuntimeError(f"process_bindingmoad: complexes per split {n_split}, expected {RAW_SPLITS}; "
                           f"torch tensors in train.pkl: {tensors}")

    cfg = copy.deepcopy(cfg)
    cfg["dataset"]["location"] = str(processed)
    cfg["experiment"] = dict(cfg["experiment"], name="raw", results_dir=str(tmp / "runs"))
    cfg["training"].update(batch_size=RAW_BATCH, sample_interval=0)
    (tmp / "raw.yml").write_text(dump_yaml(cfg))
    sync()
    egnn_edge.launches = 0
    t0 = time.perf_counter()
    run_dir, state = train_cli.main(["--config", str(tmp / "raw.yml"), "--device", DEVICE, "--seed", str(seed),
                                     "--epochs", str(RAW_TRAIN_STEPS)])
    sync()
    train_s, train_launches = time.perf_counter() - t0, egnn_edge.launches
    rows = trainer.MetricsLog(Path(run_dir) / "train_metrics.pkl").rows
    if state.step != RAW_TRAIN_STEPS or not all(np.isfinite(r["l2"]) for r in rows):
        raise RuntimeError(f"train CLI on the processed splits: step {state.step}, rows {rows}")

    out = tmp / "sampled"
    draws, real_draw = [], LigandSizeDistribution.sample

    def recorded_draw(dist, *a, **kw):  # the sizes --ligand_size random draws from the histogram
        sizes = real_draw(dist, *a, **kw)
        draws.extend(int(n) for n in np.ravel(sizes))
        return sizes

    LigandSizeDistribution.sample = recorded_draw
    try:
        with ChainLog() as log:
            t0 = time.perf_counter()
            sample_cli.main(["--model_dir", str(run_dir), "--split", "test", "--samples_per_pocket",
                             str(RAW_SAMPLES), "--max_batch_size", str(RAW_SAMPLES), "--max_tries", "1",
                             "--ligand_size", "random", "--sample_steps", str(RAW_K), "--out", str(out),
                             "--device", DEVICE, "--seed", str(seed)])
            sample_s = time.perf_counter() - t0
    finally:
        LigandSizeDistribution.sample = real_draw
    sample_path = log.check("raw data: sample CLI --ligand_size random")
    if len(draws) != RAW_SPLITS["test"] * RAW_SAMPLES or not all(lig_bounds[0] <= n <= lig_bounds[1] for n in draws):
        raise RuntimeError(f"sample CLI: ligand sizes {draws}, expected {RAW_SAMPLES} a pocket within {lig_bounds}")
    n_mols = 0
    for i in range(RAW_SPLITS["test"]):
        pdir = out / f"pocket_{i}"
        missing = [f for f in ("raw_ligands.sdf", "pocket.pdb", "keypoints.xyz", "sample_time.txt", "sample_time.pkl")
                   if not (pdir / f).exists()]
        mols = parse_sdf(pdir / "raw_ligands.sdf") if not missing else []
        if missing or not mols or not all(1 <= m.n_atoms <= lig_bounds[1] for m in mols):
            raise RuntimeError(f"sample CLI: {pdir} misses {missing} or holds molecules of "
                               f"{[m.n_atoms for m in mols]} atoms (largest fragments; histogram {lig_bounds})")
        n_mols += len(mols)
    res = compute_metrics.main(["--sampled_mols_dir", str(out)])
    if not (out / "metrics.pkl").exists() or "validity" not in res["overall"]:
        raise RuntimeError(f"compute_metrics: {res}")

    # CrossDocked: pocket PDB / ligand SDF pairs named by an index pickle
    cd = tmp / "crossdocked"
    pairs = []
    for i in range(3):
        (cd / f"p{i}").mkdir(parents=True)
        pdb, sdf = write_synthetic_complex(rng, cd / f"p{i}", lig_elements, n_lig=20 + i)
        pairs.append((str(pdb.relative_to(cd)), str(sdf.relative_to(cd))))
    with open(tmp / "index.pkl", "wb") as f:
        pickle.dump({"train": pairs[:2], "test": pairs[2:]}, f)
    process_crossdocked.main(["--data_dir", str(cd), "--index_file", str(tmp / "index.pkl"),
                              "--out", str(tmp / "cd_processed")])
    cd_counts = {s: len(load_pickle(tmp / "cd_processed" / f"{s}.pkl")["lig_files"]) for s in ("train", "test")}
    if cd_counts != {"train": 2, "test": 1} or not (tmp / "cd_processed" / "train_n_node_joint_dist.pkl").exists():
        raise RuntimeError(f"process_crossdocked: {cd_counts}")
    print(f"raw data: process_bindingmoad {n_split} in {process_s:.3f} s (histogram rec "
          f"{tuple(int(v) for v in rec_bounds)}, lig {tuple(int(v) for v in lig_bounds)}); train CLI {state.step} steps at batch {RAW_BATCH} in {train_s:.3f} s ({train_launches} "
          f"kernel launches: held-out passes under no_grad); sample CLI {n_mols} molecules in {sample_s:.3f} s, "
          f"validity {res['overall']['validity']:.3f}; process_crossdocked {cd_counts}", flush=True)
    record = dict(splits=n_split, process_s=process_s, rec_bounds=[int(v) for v in rec_bounds],
                  lig_bounds=[int(v) for v in lig_bounds], train_s=train_s, train_steps=state.step,
                  train_l2=[r["l2"] for r in rows], sample_s=sample_s, n_mols=n_mols, metrics=res["overall"],
                  crossdocked=cd_counts, **{f"sample_{k}": v for k, v in sample_path.items()})
    return record, dict(raw_train_cli=train_launches, raw_sample_cli=sample_path["launches"])


def to_reference_state_dict(flat, model):
    """The upstream state_dict layout of a port parameter set ({dotted name:
    array}): the inverse of utils/torch_import.py's key map (first layers
    re-joined as concat(W_src, W_dst, W_dij), torch (out, in) weights)."""
    cfg = model.cfg
    sd = {}

    def put(key, name, t=False):
        v = np.asarray(flat[name])
        sd[key] = np.ascontiguousarray(v.T) if t else v

    def mlp(ref, ours, n=2):
        for i, j in zip(range(n), (0, 2)):
            put(f"{ref}.{j}.weight", f"{ours}.lin{i}.kernel", True)
            put(f"{ref}.{j}.bias", f"{ours}.lin{i}.bias")

    def first_layer(ref, ours, chain):
        sd[f"{ref}.0.weight"] = np.ascontiguousarray(np.concatenate(
            [flat[f"{ours}.{chain}_w_{p}"] for p in ("src", "dst", "dij")], axis=0).T)
        put(f"{ref}.0.bias", f"{ours}.{chain}_b")

    def ln(ref, ours):
        put(f"{ref}.weight", f"{ours}.scale")
        put(f"{ref}.bias", f"{ours}.bias")

    def gvp(ref, ours):
        put(f"{ref}.Wh", f"{ours}.Wh")
        put(f"{ref}.Wu", f"{ours}.Wu")
        put(f"{ref}.to_feats_out.0.weight", f"{ours}.to_feats_out.kernel", True)
        put(f"{ref}.to_feats_out.0.bias", f"{ours}.to_feats_out.bias")
        put(f"{ref}.scalar_to_vector_gates.weight", f"{ours}.scalar_to_vector_gates.kernel", True)
        put(f"{ref}.scalar_to_vector_gates.bias", f"{ours}.scalar_to_vector_gates.bias")

    dyn = cfg.dynamics
    if cfg.architecture == "egnn":
        mlp("dynamics.lig_encoder", "dynamics.lig_encoder")
        mlp("dynamics.lig_decoder", "dynamics.lig_decoder")
        if model.dynamics.kp_encoder is not None:
            mlp("dynamics.rec_encoder", "dynamics.kp_encoder")
        upd = dyn.get("update_kp_feat", False)
        for i in range(dyn.get("n_layers", 6)):
            ref, ours = f"dynamics.egnn.conv_layers.{i}", f"dynamics.conv{i}"
            for et in ("ll", "kl", "lk", "kk") if upd else ("ll", "kl"):
                e = f"{ours}.edge_{et}"
                first_layer(f"{ref}.edge_mlp.{et}", e, "edge")
                put(f"{ref}.edge_mlp.{et}.2.weight", f"{e}.edge_lin2_w", True)
                put(f"{ref}.edge_mlp.{et}.2.bias", f"{e}.edge_lin2_b")
                put(f"{ref}.soft_attention.{et}.0.weight", f"{e}.attn_w", True)
                put(f"{ref}.soft_attention.{et}.0.bias", f"{e}.attn_b")
                first_layer(f"{ref}.coord_mlp.{et}", e, "coord")
                put(f"{ref}.coord_mlp.{et}.2.weight", f"{e}.coord_lin2_w", True)
                put(f"{ref}.coord_mlp.{et}.2.bias", f"{e}.coord_lin2_b")
                put(f"{ref}.coord_mlp.{et}.4.weight", f"{e}.coord_out_w", True)
            for nt in ("lig", "kp") if upd else ("lig",):
                mlp(f"{ref}.node_mlp.{nt}", f"{ours}.update_{nt}.node_mlp")
                if f"{ours}.update_{nt}.LayerNorm_0.scale" in flat:
                    ln(f"{ref}.layer_norm.{nt}", f"{ours}.update_{nt}.LayerNorm_0")
    else:
        for side, i in (("lig", 0), ("kp", 1)):
            put(f"dynamics.{side}_encoder.0.weight", f"dynamics.{side}_enc.kernel", True)
            put(f"dynamics.{side}_encoder.0.bias", f"dynamics.{side}_enc.bias")
            ln(f"dynamics.{side}_encoder.2", f"dynamics.LayerNorm_{i}")
        n_convs = dyn.get("n_convs", 6)
        for i in range(n_convs):
            ref, ours = f"dynamics.noise_predictor.conv_layers.{i}", f"dynamics.conv{i}"
            conv = getattr(model.dynamics, f"conv{i}")
            for src, ename, dst in conv.etypes:
                for j in range(dyn.get("n_message_gvps", 3)):
                    gvp(f"{ref}.edge_message_fns.{src}_{ename}_{dst}.{j}", f"{ours}.message_{ename}.message.gvp{j}")
            for nt in conv.dst_ntypes:
                for j in range(dyn.get("n_update_gvps", 2)):
                    gvp(f"{ref}.node_update_fns.{nt}.{j}", f"{ours}.update_{nt}.gvp{j}")
                ln(f"{ref}.message_layer_norms.{nt}.feat_norm", f"{ours}.msg_norm_{nt}.LayerNorm_0")
                ln(f"{ref}.update_layer_norms.{nt}.feat_norm", f"{ours}.upd_norm_{nt}.LayerNorm_0")
        for j in range(dyn.get("n_noise_gvps", 3)):
            gvp(f"dynamics.noise_predictor.noise_predictor.gvps.{j}", f"dynamics.noise_predictor.gvp{j}")
        put("dynamics.noise_predictor.noise_predictor.to_scalar_output.weight",
            "dynamics.noise_predictor.to_scalar_output.kernel", True)
        put("dynamics.noise_predictor.noise_predictor.to_scalar_output.bias",
            "dynamics.noise_predictor.to_scalar_output.bias")
    if cfg.rec_encoder_type != "learned":
        return sd
    enc = cfg.rec_encoder
    if cfg.architecture == "egnn":
        for i in range(enc.get("n_convs", 6)):
            ref, e = f"rec_encoder.rec_convs.{i}", f"encoder.rec_conv{i}.edge_rr"
            first_layer(f"{ref}.edge_mlp", e, "edge")
            put(f"{ref}.edge_mlp.2.weight", f"{e}.edge_lin2_w", True)
            put(f"{ref}.edge_mlp.2.bias", f"{e}.edge_lin2_b")
            put(f"{ref}.soft_attention.0.weight", f"{e}.attn_w", True)
            put(f"{ref}.soft_attention.0.bias", f"{e}.attn_b")
            if not enc.get("fix_pos", False):
                first_layer(f"{ref}.coord_mlp", e, "coord")
                put(f"{ref}.coord_mlp.2.weight", f"{e}.coord_out_w", True)
            mlp(f"{ref}.node_mlp", f"encoder.rec_conv{i}.node_mlp")
            if enc.get("norm", False):
                ln(f"{ref}.layer_norm", f"encoder.rec_conv{i}.LayerNorm_0")
        put("rec_encoder.keypoint_embedding.0.weight", "encoder.keypoint_embedding.kernel", True)
        put("rec_encoder.keypoint_embedding.0.bias", "encoder.keypoint_embedding.bias")
        put("rec_encoder.rec_kp_conv.fc_src.weight", "encoder.rk_fc_src.kernel", True)
        put("rec_encoder.rec_kp_conv.fc_dst.weight", "encoder.rk_fc_dst.kernel", True)
        put("rec_encoder.rec_kp_conv.kp_feature_mlp.0.weight", "encoder.kp_feature_mlp.kernel", True)
        put("rec_encoder.rec_kp_conv.kp_feature_mlp.0.bias", "encoder.kp_feature_mlp.bias")
        if enc.get("norm", False):
            ln("rec_encoder.rec_kp_conv.layer_norm", "encoder.kp_feature_norm")
        return sd
    mlp("rec_encoder.scalar_embed", "encoder.scalar_embed")
    ln("rec_encoder.scalar_norm", "encoder.scalar_norm")
    for kind, n in (("rr", enc.get("n_rr_convs", 3)), ("rk", enc.get("n_rk_convs", 2))):
        for i in range(n):
            ref, ours = f"rec_encoder.{kind}_conv_layers.{i}", f"encoder.{kind}_conv{i}"
            for j in range(enc.get("n_message_gvps", 1)):
                gvp(f"{ref}.edge_message.{j}", f"{ours}.edge.message.gvp{j}")
            for j in range(enc.get("n_update_gvps", 1)):
                gvp(f"{ref}.node_update.{j}", f"{ours}.update.gvp{j}")
            ln(f"{ref}.message_layer_norm.feat_norm", f"{ours}.message_norm.LayerNorm_0")
            ln(f"{ref}.update_layer_norm.feat_norm", f"{ours}.update_norm.LayerNorm_0")
    ki = "rec_encoder.keypoint_initializer"
    put(f"{ki}.keypoint_embedding.0.weight", "encoder.keypoint_embedding.kernel", True)
    put(f"{ki}.keypoint_embedding.0.bias", "encoder.keypoint_embedding.bias")
    ln(f"{ki}.keypoint_embedding.2", "encoder.keypoint_embedding_norm")
    put(f"{ki}.src_net.weight", "encoder.src_net.kernel", True)
    put(f"{ki}.dst_net.weight", "encoder.dst_net.kernel", True)
    return sd


def checkpoint_phase(cfg, params_path, tmp, overrides):
    """Phase 10 (b): a trained archive in the upstream state_dict layout,
    written with torch.save and read back with torch.load, through the port's
    convert_reference_checkpoint into a model built with the executed-
    semantics overrides: every leaf equal bitwise, none missing or extra."""
    from kpdiff_tpu_torch.utils.params_io import flatten_tree
    from kpdiff_tpu_torch.utils.torch_import import convert_reference_checkpoint

    flat = read_keystr_npz(params_path)
    cfg = copy.deepcopy(cfg)
    for section, values in overrides.items():
        cfg[section].update(values)
    model = model_from_config(cfg, device="cpu")
    sd = to_reference_state_dict(flat, model)
    path = Path(tmp) / "model.pt"
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)
    loaded = {k: v.numpy() for k, v in torch.load(path, map_location="cpu").items()}
    tree = convert_reference_checkpoint(loaded, model)
    got = flatten_tree(tree)
    bad = sorted(set(got) ^ set(flat)) + [k for k in flat if k in got and not (
        got[k].dtype == flat[k].dtype and got[k].shape == flat[k].shape and np.array_equal(got[k], flat[k]))]
    if bad:
        raise RuntimeError(f"{params_path}: reference-layout round trip differs at {bad[:8]} ({len(bad)})")
    load_params(model, tree)
    for name, p in model.named_parameters():
        if not np.array_equal(p.detach().numpy(), flat[name]):
            raise RuntimeError(f"{params_path}: {name} changed on load")
    n = sum(v.size for v in flat.values())
    print(f"checkpoint {params_path}: {len(sd)} upstream keys -> {len(flat)} leaves ({n:,} values), every leaf "
          f"equal bitwise through torch.save/torch.load and convert_reference_checkpoint ({path.stat().st_size:,} "
          f"bytes)", flush=True)
    return dict(upstream_keys=len(sd), leaves=len(flat), values=int(n))


def graph_option_phase(cfg, flat, seed, dev, label, overrides, check_steps, kernel_rows):
    """Phase 10 (c): the trained flagship with the upstream's graph options
    (`overrides` of its dynamics section, set in memory), batch REF_BATCH,
    ligand bucket REF_BUCKET, encode -> compact_kk -> a REF_K chain under
    ChainLog; with check_steps a chain of that many steps with every launch
    against the plain version. Appends the first launch at each (B, Ns, Nd,
    H) to kernel_rows. Returns the record and the chain's path."""
    cfg = copy.deepcopy(cfg)
    cfg["dynamics"].update(overrides)
    pad = PaddingConfig.from_config(cfg)
    model = model_from_config(cfg, device=dev, seed=seed)
    load_params(model, flat)
    model.eval()
    cpx = synthetic_batch(seed, batch=REF_BATCH, n_rec_pad=pad.n_rec, n_lig_pad=REF_BUCKET, n_rec_feat=10,
                          n_lig_feat=10, n_kp=pad.n_kp, kp_feat_dim=model.cfg.rec_nf, n_ip_pad=pad.n_ip,
                          min_rec=min(260, pad.n_rec), min_lig=min(18, REF_BUCKET - 2), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    seen, errs = {}, []
    real_wrapper = egnn_mod.egnn_edge_dense

    def recording(*a, **kw):
        key = (int(a[0].shape[0]), int(a[0].shape[1]), int(a[1].shape[1]), int(a[0].shape[2]))
        if key not in seen:
            seen[key] = (egnn_edge.snapshot_args(a), kw["compute_dtype"])
        return real_wrapper(*a, **kw)

    def checking(*a, **kw):
        got = recording(*a, **kw)
        errs.append(rel_err(got, egnn_edge.egnn_edge_dense_plain(*a, **kw)))
        return got

    egnn_mod.egnn_edge_dense = recording
    try:
        with torch.no_grad():
            enc, kk = model.encode(cpx)
            kk = model.compact_kk(enc, kk)
            model.sample(enc, kk, sample_steps=2, generator=gen)  # warm-up
        with ChainLog() as log, torch.no_grad():
            t0 = time.perf_counter()
            out = model.sample(enc, kk, sample_steps=REF_K, generator=gen)
            sync()
            chain_s = time.perf_counter() - t0
        if check_steps:
            egnn_mod.egnn_edge_dense = checking
            with ChainLog() as check_log, torch.no_grad():
                model.sample(enc, kk, sample_steps=check_steps, generator=gen, cuda_graph=False)
    finally:
        egnn_mod.egnn_edge_dense = real_wrapper
    for k, shape in (("lig_x", (REF_BATCH, REF_BUCKET, 3)), ("lig_h", (REF_BATCH, REF_BUCKET, 10))):
        if tuple(out[k].shape) != shape or not torch.isfinite(out[k]).all():
            raise RuntimeError(f"{label}: {k} has shape {tuple(out[k].shape)} or is not finite")
    path = log.check(f"{label} (kk {layout_name(kk)})")
    rec = dict(overrides=overrides, chain_s=chain_s, ms_per_step=chain_s / REF_K * 1e3, **path)
    if check_steps:
        check = check_log.check(f"{label}, {check_steps}-step chain against the plain version")
        worst = max(errs)
        print(f"  {label}: {len(errs)} launches each against the plain version: max_rel_err {worst:.3e} "
              f"(tolerance {TOL[torch.bfloat16]:.0e})", flush=True)
        if not worst <= TOL[torch.bfloat16] or len(errs) != check["launches"]:
            raise RuntimeError(f"{label}: launches differ from the plain version ({worst:.3e}, {len(errs)} checked)")
        rec["checked"] = dict(max_rel_err=worst, **check)
    print(f"  {label}: K={REF_K} chain at batch {REF_BATCH}, bucket {REF_BUCKET}: {chain_s:.3f} s "
          f"({rec['ms_per_step']:.3f} ms/step), {path['launches_per_step']:g} launches a step", flush=True)
    kernel_rows.extend((label, key, a, cd) for key, (a, cd) in seen.items())
    del model, enc, kk, out
    return rec, path


def block_rr_recall(x, mask, cutoff, tile):
    """Share of the rr radius graph's edges that the banded block windows
    over the Morton-sorted points hold."""
    perm = spatial_sort_permutation(x, mask)
    xs, ms = torch.take_along_dim(x, perm[..., None], dim=1), torch.take_along_dim(mask, perm, dim=1)
    block = int(block_radius_adjacency(xs, ms, cutoff, tile).sum())
    exact = int(dense_radius_adjacency(x, mask, x, mask, cutoff, exclude_self=True).sum())
    return block / max(exact, 1)


def encoder_times(cfgs, seed, dev):
    """Phase 10 (c): each learned encoder with rr_layout nbr and block at
    batch REF_BATCH under no_grad, median ms of ENCODER_REPEATS calls on CUDA
    events after a warm-up; no kernel launches (the encoders never take it).
    cfgs: {name: (config, keystr npz)}."""
    rows = {}
    for name, (cfg0, params) in cfgs.items():
        section = "rec_encoder_gvp" if "rec_encoder_gvp" in cfg0 else "rec_encoder"
        pad = PaddingConfig.from_config(cfg0)
        kp = {}
        for layout in ("nbr", "block"):
            cfg = copy.deepcopy(cfg0)
            cfg[section]["rr_layout"] = layout
            model = model_from_config(cfg, device=dev, seed=seed)
            load_params(model, read_keystr_npz(params))
            model.eval()
            n_rec_feat = resolve_feature_sizes(cfg)[0]
            cpx = synthetic_batch(seed, batch=REF_BATCH, n_rec_pad=pad.n_rec, n_lig_pad=REF_BUCKET,
                                  n_rec_feat=n_rec_feat, n_lig_feat=10, n_kp=pad.n_kp, kp_feat_dim=model.cfg.rec_nf,
                                  kp_vec_dim=model.kp_vec_dim, n_ip_pad=pad.n_ip, min_rec=min(260, pad.n_rec),
                                  min_lig=min(18, REF_BUCKET - 2), device=dev)
            sync()
            egnn_edge.launches = 0
            ms = []
            with torch.no_grad():
                enc, _ = model.encode(cpx)  # warm-up
                for _ in range(ENCODER_REPEATS):
                    if DEVICE == "cuda":
                        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                        start.record()
                        enc, _ = model.encode(cpx)
                        end.record()
                        torch.cuda.synchronize()
                        ms.append(start.elapsed_time(end))
                    else:
                        t0 = time.perf_counter()
                        enc, _ = model.encode(cpx)
                        ms.append((time.perf_counter() - t0) * 1e3)
            sync()
            if egnn_edge.launches or not (torch.isfinite(enc.kp_x).all() and torch.isfinite(enc.kp_h).all()):
                raise RuntimeError(f"{name} encoder {layout}: {egnn_edge.launches} launches or non-finite keypoints")
            kp[layout], cpx_x, cpx_mask = enc.kp_x, cpx.rec_x, cpx.rec_mask
            rows[f"{name}_{layout}"] = dict(median_ms=statistics.median(ms), ms=ms, batch=REF_BATCH, n_rec=pad.n_rec)
            del model, enc, cpx
        shift = float((kp["block"] - kp["nbr"]).norm(dim=-1).max())
        recall = block_rr_recall(cpx_x, cpx_mask, cfg["graph"]["graph_cutoffs"]["rr"],
                                 choose_tile(pad.n_rec, cfg[section].get("rr_block_size", 64)))
        rows[f"{name}_block"].update(max_kp_shift_vs_nbr=shift, rr_edge_recall=recall)
        print(f"  encoder {name} at batch {REF_BATCH}, n_rec {pad.n_rec}: nbr {rows[f'{name}_nbr']['median_ms']:.3f} "
              f"ms, block {rows[f'{name}_block']['median_ms']:.3f} ms (median of {ENCODER_REPEATS}, "
              f"{'CUDA events' if DEVICE == 'cuda' else 'host clock'}); the block windows hold {recall:.4f} of the "
              f"rr radius edges; block keypoints at most {shift:.3f} from nbr's (reported)", flush=True)
    return rows


# ---- phase 11: the parallel layer at world size 1

def _timed_steps(step_fn, state, batches, t_eps, dev):
    """Metrics and device ms (CUDA events) of one train step per batch."""
    rows, ms = [], []
    for batch, te in zip(batches, t_eps):
        batch = batch.to(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        rows.append(step_fn(state, batch, t_eps=te))
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return rows, ms


def parallel_train(params_path, seed, dev, batches, iters_per_epoch):
    """(a) PAR_STEPS flagship steps through the dp x mp trainer on a (1, 1)
    mesh against the plain trainer, same weights, batches and (t, eps), with
    deterministic kernels (the scatter-adds of the kNN pairs and of the
    gathers' backward), in f32 and with the config's bf16 pair MLPs, each
    gated at its PAR_TOL and timed. The parallel path adds the keypoint
    edges' and the gathered sources' gradients in another order than the
    plain one, and Adam turns that rounding into parameter differences: in
    bf16 they show at 1e-4, in f32 they stay far under 1e-5."""
    flat = read_keystr_npz(params_path)
    rng = np.random.default_rng(seed + 21)
    n_t = load_config(CONFIG)["diffusion"]["n_timesteps"]
    t_eps = [(rng.integers(0, n_t, b.batch_size), rng.normal(size=tuple(b.lig_x.shape)).astype(np.float32),
              rng.normal(size=tuple(b.lig_h.shape)).astype(np.float32)) for b in batches]
    mesh = make_mesh(1, ("data", "model"), (1, 1), device=dev.type)
    rec = {}
    # torch's deterministic mode asks for a fixed cuBLAS workspace; one stream is deterministic with the one
    # this process already has, so the variable is set for the check only, and only here
    cublas_cfg = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        for dtype_name in ("float32", "bfloat16"):
            cfg = load_config(CONFIG)
            for section in ("dynamics", "rec_encoder"):
                cfg[section]["compute_dtype"] = dtype_name
            tcfg = train_config_from(cfg)
            out = {}
            for label, kw in (("plain", dict(cuda_graph=False)), ("parallel", dict(mesh=mesh, kp_axis="model"))):
                model = model_from_config(cfg, device=dev, seed=seed)
                load_params(model, flat)
                state = trainer.init_train_state(model, tcfg)
                rows, ms = _timed_steps(trainer.make_train_step(tcfg, iters_per_epoch, **kw), state, batches,
                                        t_eps, dev)
                out[label] = dict(losses=[r["total"] for r in rows], ms=ms, checksum=params_checksum(model),
                                  skipped=sum(r["skipped_nonfinite"] for r in rows))
                del model, state
            p, q = out["plain"], out["parallel"]
            loss_errs = [_rel(a, b) for a, b in zip(q["losses"], p["losses"])]
            sum_err = _rel(q["checksum"], p["checksum"])
            rec[dtype_name] = dict(plain=p, parallel=q, loss_rel_err=loss_errs, checksum_rel_err=sum_err,
                                   median_ms_plain=statistics.median(p["ms"][1:]),
                                   median_ms_parallel=statistics.median(q["ms"][1:]))
            tol = PAR_TOL[dtype_name]
            print(f"parallel train {dtype_name}: {len(batches)} flagship steps at batch {batches[0].batch_size} "
                  f"(buckets {[int(b.lig_x.shape[1]) for b in batches]}), the dp x mp trainer on a (1, 1) "
                  f"{torch.distributed.get_backend()} mesh vs the plain trainer: loss rel err by step "
                  f"{[f'{e:.2e}' for e in loss_errs]}, checksum rel err {sum_err:.3e} "
                  + f"(gate {tol:.0e})"
                  + f"; ms/step on CUDA events parallel {[round(m, 3) for m in q['ms']]} plain "
                  f"{[round(m, 3) for m in p['ms']]}", flush=True)
            if p["skipped"] or q["skipped"] or max(loss_errs) > tol or sum_err > tol:
                raise RuntimeError(f"parallel trainer vs plain ({dtype_name}): loss {max(loss_errs):.3e}, "
                                   f"checksum {sum_err:.3e}, skipped {p['skipped']} / {q['skipped']}")
    finally:
        torch.use_deterministic_algorithms(False)
        if cublas_cfg is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = cublas_cfg
    return rec


def parallel_sample(params_path, seed, dev):
    """(b) The trained flagship's kp-sharded sample (shard_encoded on a
    1-rank 'model' mesh) against the unsharded chain: its dynamics on every
    state of the unsharded chain (bf16 tolerance), then both chains free,
    timed, launch counts equal."""
    cfg = load_config(CONFIG)
    model = model_from_config(cfg, device=dev, seed=seed)
    load_params(model, read_keystr_npz(params_path))
    model.eval()
    pad = PaddingConfig.from_config(cfg)
    cpx = synthetic_batch(seed + 5, batch=PAR_BATCH, n_rec_pad=pad.n_rec, n_lig_pad=PAR_BUCKET, n_rec_feat=10,
                          n_lig_feat=10, n_kp=pad.n_kp, kp_feat_dim=model.cfg.rec_nf, n_ip_pad=pad.n_ip,
                          min_rec=260, min_lig=PAR_BUCKET - 8, device=dev)
    mesh = make_mesh(1, ("model",), device=dev.type)
    with torch.no_grad():
        enc, kk = model.encode(cpx)
        kk = model.compact_kk(enc, kk)
        enc_s, kk_s, shard = shard_encoded(enc, kk, mesh, axis="model")
    states, real = [], model._apply_dynamics

    def recording(dyn, *a, **kw):
        out = real(dyn, *a, **kw)
        if kw.get("kp_shard") is None:  # the step updates its state in place after the call: keep copies
            states.append((dyn, clone_tree(a), out))
        return out

    runs = {}
    model._apply_dynamics = recording
    try:
        for label, (e, k, sh) in (("unsharded", (enc, kk, None)), ("sharded", (enc_s, kk_s, shard))):
            gen = torch.Generator(device=dev).manual_seed(seed + 6)
            model.sample(e, k, sample_steps=2, generator=gen, kp_shard=sh, cuda_graph=False)  # warm-up
            states.clear()
            torch.cuda.synchronize()
            egnn_edge.launches = 0
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = model.sample(e, k, sample_steps=PAR_K, generator=gen.manual_seed(seed + 7), kp_shard=sh,
                               cuda_graph=False)
            end.record()
            torch.cuda.synchronize()
            runs[label] = dict(launches=egnn_edge.launches, ms_per_step=start.elapsed_time(end) / PAR_K, out=out,
                               states=list(states))
            for key in ("lig_x", "lig_h"):
                if not torch.isfinite(out[key]).all():
                    raise RuntimeError(f"parallel sample {label}: {key} not finite")
    finally:
        model._apply_dynamics = real
    # the sharded dynamics on each state of the unsharded chain (recorded in the unsharded run), beside the
    # unsharded dynamics run again on it (the kNN pairs' scatter-adds are not deterministic on the card)
    egnn_edge.launches = 0
    step_errs, replay_errs = [], []
    with torch.no_grad():
        lo, hi = shard.bounds(enc_s.kp_x.shape[1] * shard.size)
        for dyn, a, want in runs["unsharded"]["states"]:
            lig_x, lig_h, lig_mask, kp_x = a[:4]
            got = real(dyn, lig_x, lig_h, lig_mask, kp_x[:, lo:hi], enc_s.kp_h, enc_s.kp_mask, a[6], kk_s, enc_s.kp_v,
                       kp_shard=shard)
            step_errs.append(rel_err(got, want))
            replay_errs.append(rel_err(real(dyn, *a), want))
    checked_launches = egnn_edge.launches
    worst, replay = max(step_errs), max(replay_errs)
    u, sh_run = runs["unsharded"], runs["sharded"]
    free = rel_err([sh_run["out"]["lig_x"]], [u["out"]["lig_x"]])
    print(f"parallel sample: kp-sharded trained flagship, batch {PAR_BATCH}, bucket {PAR_BUCKET}, K={PAR_K}, "
          f"kk {layout_name(kk)}: launches sharded {sh_run['launches']} unsharded {u['launches']}; ms/step on CUDA events "
          f"sharded {sh_run['ms_per_step']:.3f} unsharded {u['ms_per_step']:.3f}; sharded dynamics on the "
          f"unsharded chain's {len(step_errs)} states: max_rel_err {worst:.3e} (tolerance {TOL[torch.bfloat16]:.0e}; "
          f"the unsharded dynamics again on them: {replay:.3e}); free chains' lig_x max_rel_diff {free:.3e} "
          f"(reported)", flush=True)
    if sh_run["launches"] != u["launches"] or u["launches"] != launches_per_step(model) * PAR_K:
        raise RuntimeError(f"parallel sample: launches sharded {sh_run['launches']}, unsharded {u['launches']}")
    if len(step_errs) != PAR_K or not worst <= TOL[torch.bfloat16]:
        raise RuntimeError(f"parallel sample: {len(step_errs)} states, max_rel_err {worst:.3e}")
    return dict(kk=layout_name(kk), launches=sh_run["launches"], launches_unsharded=u["launches"],
                ms_per_step=sh_run["ms_per_step"], ms_per_step_unsharded=u["ms_per_step"],
                step_max_rel_err=worst, replay_max_rel_err=replay, free_max_rel_diff=free,
                checked_launches=checked_launches)


def per_rank_shapes(seed, dev):
    """(c) The edge kernel at the shapes a 2- or 4-rank run gives it, bf16 and f32."""
    rng = np.random.default_rng(seed + 8)
    shapes = []
    for n in (2, 4):
        shapes += [(f"kp{n}_kk40", PAR_BATCH, 40, 40 // n), (f"kp{n}_kl", PAR_BATCH, 40 // n, PAR_BUCKET),
                   (f"kp{n}_lk", PAR_BATCH, PAR_BUCKET, 40 // n), (f"kp{n}_kk20", PAR_BATCH, 20, 20 // n),
                   (f"dp{n}_ll32", PAR_BATCH // n, 32, 32), (f"dp{n}_kk40", PAR_BATCH // n, 40, 40)]
    shapes.append(("kp8_kk24_padded", PAR_BATCH, 24, 3))
    rows = []
    for label, b, ns, nd in shapes:
        base = random_args(rng, b, ns, nd, 257, dev)
        for cd in (torch.bfloat16, torch.float32):
            rows.append(measure(with_dtype(base, cd), cd, f"parallel_{label}", iters=20))
    return rows


def parallel_phase(params_path, seed, dev, batches, iters_per_epoch, tmp):
    """Phase 11 in a world-size-1 NCCL group; returns (record, launches by path, kernel rows)."""
    from kpdiff_tpu_torch.dryrun import dryrun_multichip

    pdist.initialize_multihost("file://" + str(Path(tmp) / "store"), 1, 0, device=dev.type)
    try:
        if torch.distributed.get_backend() != pdist.backend_for(dev):
            raise RuntimeError(f"phase 11 group backend {torch.distributed.get_backend()}, expected "
                               f"{pdist.backend_for(dev)}")
        train = parallel_train(params_path, seed, dev, batches, iters_per_epoch)
        sample = parallel_sample(params_path, seed, dev)
        rows = per_rank_shapes(seed, dev) if dev.type == "cuda" else []
        egnn_edge.launches = 0
        line = dryrun_multichip(1, device=dev.type)
        torch.cuda.synchronize()
        dry_launches = egnn_edge.launches
        if not line or "dryrun_multichip(1) ok" not in line or (dev.type == "cuda" and not dry_launches):
            raise RuntimeError(f"dryrun_multichip(1): {line!r}, {dry_launches} kernel launches")
    finally:
        torch.distributed.destroy_process_group()
    record = dict(train=train, sample=sample, dryrun=line, dryrun_launches=dry_launches)
    paths = dict(parallel_kp_sample=sample["launches"], parallel_kp_checked=sample["checked_launches"],
                 parallel_dryrun=dry_launches)
    return record, paths, rows


# ---- phase 12: the reverse chain as a captured CUDA graph of one step

def profiled(fn):
    """fn() under torch.profiler: (wall s, device s summed over kernel rows,
    kernels, edge-kernel launches). Kernels replayed from a CUDA graph have
    their rows as launched ones do."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and _device_us(e) > 0
            and not getattr(e, "is_user_annotation", False)]
    return (wall, sum(_device_us(e) for e in rows) * 1e-6, sum(e.count for e in rows),
            sum(e.count for e in rows if "egnn_edge" in e.key))


def timed_chain(fn):
    """Host seconds of fn() to its last kernel, and the CUDA events' ms around it."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, start.elapsed_time(end), out


def graph_step_check(model, enc, kk, gen, steps, check_at):
    """Each step at `check_at` of a `steps` chain: the cached graph's replay
    against the eager reverse_step on the same state, with the generator in
    the same state for both (so the draws are the same). The chain goes on
    from the eager state. Returns (max abs diff over the scale, bitwise)."""
    model.sample(enc, kk, sample_steps=2, generator=gen)  # the graph of this key (cached: two replays)
    entry = model.chain_graphs.last
    st, n, _ = model.start_chain(enc, kk, sample_steps=steps, generator=gen)
    dyn = model._sampling_dynamics()
    worst, bitwise = 0.0, True
    for j in range(n):
        if j not in check_at:
            model.reverse_step(dyn, st, 1.0, gen)
            continue
        g0 = gen.get_state()
        ref = clone_tree(st)
        model.reverse_step(dyn, ref, 1.0, gen)
        gen.set_state(g0)
        copy_tree(entry.static, st)
        entry.replay()
        torch.cuda.synchronize()
        for k in STATE:
            got, want = entry.static[k], ref[k]
            bitwise &= bool(torch.equal(got, want))
            worst = max(worst, float((got - want).abs().max() / want.abs().max().clamp_min(1e-30)))
        st = ref
    return worst, bitwise


def graph_repeat_check(model, enc, kk, gen, at=1):
    """Two replays of the cached graph step on the chain's state after `at`
    eager steps, with the generator in the same state for both: the STATE
    keys whose results differ (none where every op of the step sums in a
    fixed order)."""
    model.sample(enc, kk, sample_steps=2, generator=gen)  # the graph of this key (cached)
    entry = model.chain_graphs.last
    st, _, _ = model.start_chain(enc, kk, sample_steps=GVP_GRAPH_K, generator=gen)
    dyn = model._sampling_dynamics()
    for _ in range(at):
        model.reverse_step(dyn, st, 1.0, gen)
    g0 = gen.get_state()
    outs = []
    for _ in range(2):
        gen.set_state(g0)
        copy_tree(entry.static, st)
        entry.replay()
        torch.cuda.synchronize()
        outs.append({k: entry.static[k].clone() for k in STATE})
    return sorted(k for k in STATE if not torch.equal(outs[0][k], outs[1][k]))


def draws_check(dev, shapes, replays=3):
    """A captured graph of torch.randn draws from a registered generator,
    replayed, against eager draws from the same generator state: bitwise."""
    gen = torch.Generator(device=dev).manual_seed(1234)
    g0 = gen.get_state()
    eager = [[torch.randn(sh, generator=gen, device=dev) for sh in shapes] for _ in range(replays)]
    gen.set_state(g0)
    static = [torch.empty(sh, device=dev) for sh in shapes]
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    with torch.cuda.graph(graph, stream=torch.cuda.Stream(device=dev)):
        for t, sh in zip(static, shapes):
            t.copy_(torch.randn(sh, generator=gen, device=dev))
    got = []
    for _ in range(replays):
        graph.replay()
        got.append([t.clone() for t in static])
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for g, e in zip(got, eager) for a, b in zip(g, e))


def graph_chain_record(model, enc, kk, gen, label, steps, batch, check_at, tol):
    """Graph against eager for one (model, batch, bucket): the K=steps chain
    on each path (host s and CUDA-event ms), the capture's seconds and pool
    bytes, and the step-by-step check. Profiles are read later
    (graph_profiles): the profiler slows what follows it."""
    graphs = model.chain_graphs
    n_caps = len(graphs.captures)
    model.sample(enc, kk, sample_steps=2, generator=gen)  # warm-up step, capture, one replay
    if len(graphs.captures) != n_caps + 1:
        raise RuntimeError(f"{label}: {len(graphs.captures) - n_caps} captures for one new shape")
    cap = graphs.captures[-1]
    torch.cuda.synchronize()
    egnn_edge.launches = 0
    g_s, g_ms, out = timed_chain(lambda: model.sample(enc, kk, sample_steps=steps, generator=gen))
    g_launches = egnn_edge.launches
    e_s, e_ms, out_e = timed_chain(lambda: model.sample(enc, kk, sample_steps=steps, generator=gen,
                                                        cuda_graph=False))
    e_launches = egnn_edge.launches - g_launches
    for o in (out, out_e):
        if not all(torch.isfinite(o[k]).all() for k in ("lig_x", "lig_h")):
            raise RuntimeError(f"{label}: a chain's output is not finite")
    per_step = launches_per_step(model)
    if g_launches != e_launches or g_launches != per_step * steps or graphs.last.launches != per_step:
        raise RuntimeError(f"{label}: launches graph {g_launches}, eager {e_launches}, captured "
                           f"{graphs.last.launches} a replay; expected {per_step} a step")
    worst, bitwise = graph_step_check(model, enc, kk, gen, steps, check_at)
    print(f"graph {label}: K={steps} at batch {batch}: graph {g_s:.3f} s ({g_ms / steps:.3f} ms/step on CUDA "
          f"events, {g_s / batch:.6f} s/ligand), eager {e_s:.3f} s ({e_ms / steps:.3f} ms/step, "
          f"{e_s / batch:.6f} s/ligand): {e_s / g_s:.2f}x; capture {cap['capture_s']:.3f} s, graph pool "
          f"{cap['pool_bytes']} bytes (+{cap['pool_growth']}); {g_launches} launches ({per_step} a step, "
          f"{graphs.last.launches} captured a replay); graph step vs eager step on the chain's states "
          f"{sorted(check_at)}: max diff {worst:.3e} of scale (gate {tol:.0e}), bitwise {bitwise}", flush=True)
    if not worst <= tol:
        raise RuntimeError(f"{label}: a graph step differs from the eager step by {worst:.3e} of scale")
    return dict(batch=batch, steps=steps, graph_s=g_s, graph_ms_per_step=g_ms / steps, graph_s_per_ligand=g_s / batch,
                eager_s=e_s, eager_ms_per_step=e_ms / steps, eager_s_per_ligand=e_s / batch, speedup=e_s / g_s,
                capture_s=cap["capture_s"], pool_bytes=cap["pool_bytes"], pool_growth=cap["pool_growth"],
                launches=g_launches, launches_per_step=per_step, step_max_diff=worst, step_bitwise=bitwise,
                kk=layout_name(kk))


def graph_profiles(model, enc, kk, gen, label, rec, steps=GRAPH_PROFILE_STEPS):
    """Wall and device ms/step and busy share of `steps` graph replays and
    `steps` eager steps under torch.profiler; the graph's edge-kernel
    launches from the profiler's kernel rows against the captured count
    times the replays."""
    model.sample(enc, kk, sample_steps=2, generator=gen)  # cached graph
    entry = model.chain_graphs.last
    r0 = entry.replays
    out = {}
    for mode, graph in (("graph", None), ("eager", False)):
        wall, device, kernels, edge = profiled(
            lambda: model.sample(enc, kk, sample_steps=steps, generator=gen, cuda_graph=graph))
        out[mode] = dict(wall_ms_per_step=wall / steps * 1e3, device_ms_per_step=device / steps * 1e3,
                         busy=device / wall, kernels_per_step=kernels / steps, edge_launches=edge)
    replays = entry.replays - r0
    want = launches_per_step(model) * steps
    g, e = out["graph"], out["eager"]
    print(f"graph {label} profile, {steps} steps: graph wall {g['wall_ms_per_step']:.3f} / device "
          f"{g['device_ms_per_step']:.3f} ms/step, busy {g['busy']:.3f}, {g['kernels_per_step']:.0f} kernels/step; "
          f"eager wall {e['wall_ms_per_step']:.3f} / device {e['device_ms_per_step']:.3f} ms/step, busy "
          f"{e['busy']:.3f}, {e['kernels_per_step']:.0f} kernels/step; edge-kernel rows graph {g['edge_launches']} "
          f"eager {e['edge_launches']} (expected {want}; captured {entry.launches} x {replays} replays)", flush=True)
    if g["edge_launches"] != want or e["edge_launches"] != want or entry.launches * replays != want:
        raise RuntimeError(f"{label}: profiler-counted edge launches graph {g['edge_launches']}, eager "
                           f"{e['edge_launches']}, captured {entry.launches} x {replays}; expected {want}")
    rec["profile"] = out


def graph_phase(params_path, seed, dev):
    """Phase 12: the trained flagship at batch BATCH, buckets of
    BUCKET_WEIGHTS, K=STEPS, graph against eager; draws; successive
    requests; the trained gvp_40kp; profiled launch counts by layout."""
    rec = {"draws_equal": draws_check(dev, [(BATCH, 48, 3), (BATCH, 48, 10)])}
    print(f"graph draws: a captured graph's torch.randn from a registered generator equals eager draws from the "
          f"same state: {rec['draws_equal']}", flush=True)
    if not rec["draws_equal"]:
        raise RuntimeError("graph draws differ from eager draws")
    cfg = load_config(CONFIG)
    pad = PaddingConfig.from_config(cfg)
    model = model_from_config(cfg, device=dev, seed=seed)
    load_params(model, read_keystr_npz(params_path))
    model.eval()
    runs, chains = {}, {}
    for n_lig in BUCKET_WEIGHTS:
        cpx = synthetic_batch(0, batch=BATCH, n_rec_pad=pad.n_rec, n_lig_pad=n_lig, n_rec_feat=10, n_lig_feat=10,
                              n_kp=pad.n_kp, kp_feat_dim=model.cfg.rec_nf, n_ip_pad=pad.n_ip, min_rec=260,
                              min_lig=min(18, n_lig - 2), device=dev)
        with torch.no_grad():
            enc, kk = model.encode(cpx)
            kk = model.compact_kk(enc, kk)
        gen = torch.Generator(device=dev).manual_seed(seed + 40 + n_lig)
        chains[n_lig] = (enc, kk, gen)
        runs[n_lig] = graph_chain_record(model, enc, kk, gen, f"flagship bucket {n_lig}", STEPS, BATCH,
                                         (0, 1, STEPS // 2, STEPS - 1), GRAPH_TOL[model.cd])
    rec["flagship"] = runs
    rec["s_per_ligand_mixture"] = {
        mode: sum(w * runs[n][f"{mode}_s_per_ligand"] for n, w in BUCKET_WEIGHTS.items()) / sum(BUCKET_WEIGHTS.values())
        for mode in ("graph", "eager")}

    # two successive requests through one graph: different samples, neither aliased to the graph's buffers
    enc, kk, gen = chains[32]
    first = model.sample(enc, kk, sample_steps=10, generator=gen)
    kept = {k: v.clone() for k, v in first.items()}
    second = model.sample(enc, kk, sample_steps=10, generator=gen)
    static = model.chain_graphs.last.static
    ptrs = {static[k].data_ptr() for k in STATE}
    differ = not torch.equal(first["lig_x"], second["lig_x"])
    unaliased = (all(torch.equal(first[k], kept[k]) for k in kept)
                 and not any(o[k].data_ptr() in ptrs for o in (first, second) for k in STATE))
    rec["successive"] = dict(differ=differ, unaliased=unaliased)
    print(f"graph successive requests (bucket 32, K=10): outputs differ {differ}; neither aliased to the graph's "
          f"buffers and the first unchanged by the second {unaliased}", flush=True)
    if not (differ and unaliased):
        raise RuntimeError(f"graph successive requests: differ {differ}, unaliased {unaliased}")

    # the trained gvp_40kp at batch BATCH, bucket 48
    gcfg = load_config("configs/gvp_40kp.yml")
    gpad = PaddingConfig.from_config(gcfg)
    gvp = model_from_config(gcfg, device=dev, seed=seed)
    load_params(gvp, read_keystr_npz(GVP_PARAMS))
    gvp.eval()
    cpx = synthetic_batch(0, batch=BATCH, n_rec_pad=gpad.n_rec, n_lig_pad=48, n_rec_feat=resolve_feature_sizes(gcfg)[0],
                          n_lig_feat=10, n_kp=gpad.n_kp, kp_feat_dim=gvp.cfg.rec_nf, kp_vec_dim=gvp.kp_vec_dim,
                          n_ip_pad=gpad.n_ip, min_rec=min(260, gpad.n_rec), min_lig=30, device=dev)
    with torch.no_grad():
        genc, gkk = gvp.encode(cpx)
        gkk = gvp.compact_kk(genc, gkk)
    ggen = torch.Generator(device=dev).manual_seed(seed + 90)
    rec["gvp_40kp"] = graph_chain_record(gvp, genc, gkk, ggen, "gvp_40kp bucket 48", GVP_GRAPH_K, BATCH,
                                         (0, 1, GVP_GRAPH_K - 1), GRAPH_TOL[gvp.cd])
    # its kl and lk sum in the message kernel's fixed order: two seeded graph steps agree bitwise
    differ = graph_repeat_check(gvp, genc, gkk, ggen)
    rec["gvp_40kp"]["repeat_differs"] = differ
    print(f"graph gvp_40kp bucket 48: two replays of the step on one state and generator state bitwise equal "
          f"{not differ} (differing: {differ})", flush=True)
    if differ:
        raise RuntimeError(f"gvp_40kp: two seeded graph steps differ in {differ}")

    # graph chains of the other edge layouts: egnn_ca on compact_kk's list (its mask, 24 launches a
    # step, seeded weights), the flagship with kl_k 0 (24 a step)
    layouts = {}
    ca_cfg = load_config("configs/egnn_ca.yml")
    ca_pad = PaddingConfig.from_config(ca_cfg)
    ca = model_from_config(ca_cfg, device=dev, seed=seed)
    ca.eval()
    cpx = synthetic_batch(seed, batch=FAMILY_BATCH, n_rec_pad=ca_pad.n_rec, n_lig_pad=ca_pad.n_lig,
                          n_rec_feat=resolve_feature_sizes(ca_cfg)[0], n_lig_feat=resolve_feature_sizes(ca_cfg)[1],
                          n_kp=ca_pad.n_kp, kp_feat_dim=ca.cfg.rec_nf, n_ip_pad=ca_pad.n_ip,
                          min_rec=min(260, 3 * ca_pad.n_rec // 4), min_lig=min(18, ca_pad.n_lig - 2), device=dev)
    with torch.no_grad():
        ca_enc, ca_kk = ca.encode(cpx)
        ca_kk = ca.compact_kk(ca_enc, ca_kk)
    kl0_cfg = copy.deepcopy(cfg)
    kl0_cfg["dynamics"]["kl_k"] = 0
    kl0 = model_from_config(kl0_cfg, device=dev, seed=seed)
    load_params(kl0, read_keystr_npz(params_path))
    kl0.eval()
    enc32, kk32, _ = chains[32]
    layout_runs = (("egnn_ca_" + layout_name(ca_kk), ca, ca_enc, ca_kk), ("flagship_kl_k0", kl0, enc32, kk32),
                   ("flagship_dense", model, enc32, kk32), ("gvp_40kp", gvp, genc, gkk))

    # every profile last: torch.profiler slows what follows it
    for n_lig in BUCKET_WEIGHTS:
        enc, kk, gen = chains[n_lig]
        graph_profiles(model, enc, kk, gen, f"flagship bucket {n_lig}", runs[n_lig])
    graph_profiles(gvp, genc, gkk, ggen, "gvp_40kp bucket 48", rec["gvp_40kp"])
    for label, m, e, k in layout_runs:
        g = torch.Generator(device=dev).manual_seed(seed + 7)
        m.sample(e, k, sample_steps=2, generator=g)  # capture
        entry = m.chain_graphs.last
        r0 = entry.replays
        _, _, _, edge = profiled(lambda: m.sample(e, k, sample_steps=5, generator=g))
        want = launches_per_step(m) * 5
        layouts[label] = dict(kk=layout_name(k), profiled_edge_launches=edge, expected=want,
                              captured=entry.launches, replays=entry.replays - r0)
        print(f"graph layout {label} (kk {layout_name(k)}): 5 replays, {edge} edge-kernel rows in the profile, "
              f"expected {want} ({entry.launches} captured x {entry.replays - r0} replays)", flush=True)
        if edge != want or entry.launches * (entry.replays - r0) != want:
            raise RuntimeError(f"graph layout {label}: {edge} profiled edge launches, expected {want}")
    rec["layouts"] = layouts
    del model, gvp, ca, kl0, chains
    torch.cuda.empty_cache()
    return rec


# ---- phase 13: the optimizer step and the held-out loss as captured CUDA graphs

def _pad_ligands(batch, t_eps, n_lig):
    """`batch` and its (t, eps) with the ligand axis padded to n_lig (zeros, masked out): a third bucket's shape."""
    extra = n_lig - batch.lig_x.shape[1]
    pad3 = lambda x: torch.nn.functional.pad(x, (0, 0, 0, extra))  # noqa: E731
    padded = batch.replace(lig_x=pad3(batch.lig_x), lig_h=pad3(batch.lig_h),
                           lig_mask=torch.nn.functional.pad(batch.lig_mask, (0, extra)))
    return padded, (t_eps[0],) + tuple(np.pad(a, ((0, 0), (0, extra), (0, 0))) for a in t_eps[1:])


def _train_run(cfg, flat, dev, seed, batches, t_eps, iters_per_epoch, graph, before=None):
    """len(batches) optimizer steps with injected (t, eps) of a model loaded
    with `flat`, through captured graphs (graph=True) or eagerly:
    (model, state, step_fn, metrics rows, CUDA-event ms, host ms)."""
    model = model_from_config(cfg, device=dev, seed=seed)
    load_params(model, flat)
    if before is not None:
        before(model)
    tcfg = train_config_from(cfg)
    state = trainer.init_train_state(model, tcfg)
    step_fn = trainer.make_train_step(tcfg, iters_per_epoch, cuda_graph=graph)
    rows, ms, host = [], [], []
    for b, te in zip(batches, t_eps):
        b = b.to(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        start.record()
        rows.append(step_fn(state, b, t_eps=te))
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - h0) * 1e3)
        ms.append(start.elapsed_time(end))
    return model, state, step_fn, rows, ms, host


def _edge_packs(module):
    """The packed kernel weights of every kernel-path EGNNEdge under `module`, as lists of tensors."""
    out = []
    for m in module.modules():
        if isinstance(m, egnn_mod.EGNNEdge) and m.kernel_ok:
            out.append([t for v in m._kernel_weights().values()
                        for t in ((v,) if torch.is_tensor(v) else v) if torch.is_tensor(t)])
    return out


def train_graph_phase(params_path, seed, dev, batches, eval_batches, iters_per_epoch):
    """Phase 13: the trained flagship at batch 64 on phase 6's batches (two
    ligand buckets alternating) with injected (t, eps): graph against eager
    steps from the same state (f32 and bf16, losses and checksum within
    GRAPH_TRAIN_TOL), ms a step on both clocks, a profile of each path, the
    captures' seconds, pool bytes and peak memory with a third bucket
    captured, the held-out loss graph (launches captured x replays, against
    the plain version), and the caches keyed on parameter versions after
    replayed steps against a fresh model loaded with the trained weights."""
    flat = read_keystr_npz(params_path)
    rng = np.random.default_rng(seed + 31)
    n_t = load_config(CONFIG)["diffusion"]["n_timesteps"]
    t_eps = [(rng.integers(0, n_t, b.batch_size), rng.normal(size=tuple(b.lig_x.shape)).astype(np.float32),
              rng.normal(size=tuple(b.lig_h.shape)).astype(np.float32)) for b in batches]
    buckets = [int(b.lig_x.shape[1]) for b in batches]
    first = {buckets.index(k) for k in set(buckets)}  # each bucket's first step: the warm-up and the capture
    timed = [i for i in range(len(batches)) if i not in first]
    rec = dict(buckets=buckets, timed_steps=timed)

    # the analyzer's chain on the sampling path, built before training (bf16 copy, packed weights, chain graph)
    cfg = load_config(CONFIG)
    pad = PaddingConfig.from_config(cfg)
    cpx = synthetic_batch(0, batch=FAMILY_BATCH, n_rec_pad=pad.n_rec, n_lig_pad=32, n_rec_feat=10, n_lig_feat=10,
                          n_kp=pad.n_kp, kp_feat_dim=128, n_ip_pad=pad.n_ip, min_rec=260, min_lig=18, device=dev)
    nrng = np.random.default_rng(seed + 33)
    noise = {k: nrng.normal(size=s).astype(np.float32) for k, s in (
        ("init_x", (FAMILY_BATCH, 32, 3)), ("init_h", (FAMILY_BATCH, 32, 10)),
        ("steps_x", (GRAPH_TRAIN_CHAIN_K, FAMILY_BATCH, 32, 3)),
        ("steps_h", (GRAPH_TRAIN_CHAIN_K, FAMILY_BATCH, 32, 10)))}

    def analyzer_chain(model):
        """encode -> sample as the analyzer calls them (the graph path), with injected noise and every frame."""
        with torch.no_grad():
            enc, kk = model.encode(cpx)
            return model.sample(enc, kk, sample_steps=GRAPH_TRAIN_CHAIN_K, noise=noise, return_every=1)

    for dtype_name in ("float32", "bfloat16"):
        dcfg = copy.deepcopy(cfg)
        for section in ("dynamics", "rec_encoder"):
            dcfg[section]["compute_dtype"] = dtype_name
        bf16 = dtype_name == "bfloat16"
        torch.cuda.reset_peak_memory_stats()
        eager = _train_run(dcfg, flat, dev, seed, batches, t_eps, iters_per_epoch, False)
        eager_peak = torch.cuda.max_memory_allocated()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        graph = _train_run(dcfg, flat, dev, seed, batches, t_eps, iters_per_epoch, True,
                           before=analyzer_chain if bf16 else None)
        (gm, gstate, gstep, grows, gms, ghost), (em, estate, estep, erows, ems, ehost) = graph, eager
        graphs = gm.train_graphs
        loss_err = [_rel(g["total"], e["total"]) for g, e in zip(grows, erows)]
        sum_g, sum_e = params_checksum(gm), params_checksum(em)
        sum_err = _rel(sum_g, sum_e)
        bitwise = all(g == e for g, e in zip(grows, erows)) and all(
            torch.equal(p, q) for p, q in zip(gm.parameters(), em.parameters()))
        r = dict(losses_graph=[x["total"] for x in grows], losses_eager=[x["total"] for x in erows],
                 loss_rel_err=loss_err, checksum_rel_err=sum_err, bitwise=bitwise, captures=len(graphs.captures),
                 ms_graph=gms, ms_eager=ems, host_ms_graph=ghost, host_ms_eager=ehost,
                 median_ms_graph=statistics.median(gms[i] for i in timed),
                 median_ms_eager=statistics.median(ems[i] for i in timed),
                 median_host_ms_graph=statistics.median(ghost[i] for i in timed),
                 median_host_ms_eager=statistics.median(ehost[i] for i in timed),
                 first_step_ms_graph={buckets[i]: gms[i] for i in sorted(first)}, eager_peak_memory_bytes=eager_peak)
        tol = GRAPH_TRAIN_TOL[dtype_name]
        print(f"train graph {dtype_name}: {len(batches)} flagship steps at batch {batches[0].batch_size} (buckets "
              f"{buckets}) through captured graphs vs eager from the same state: loss rel err by step "
              f"{[f'{e:.2e}' for e in loss_err]}, checksum rel err {sum_err:.3e} (gate {tol:.0e}), bitwise {bitwise}; "
              f"{len(graphs.captures)} captures; median over steps {timed}: graph {r['median_ms_graph']:.3f} ms/step "
              f"on CUDA events ({r['median_host_ms_graph']:.3f} on the host clock), eager {r['median_ms_eager']:.3f} "
              f"({r['median_host_ms_eager']:.3f}): {r['median_ms_eager'] / r['median_ms_graph']:.2f}x; first step "
              f"of each bucket through the graph (warm-up and capture) {r['first_step_ms_graph']} ms", flush=True)
        if max(loss_err) > tol or sum_err > tol or any(x["skipped_nonfinite"] for x in grows + erows):
            raise RuntimeError(f"train graph vs eager ({dtype_name}): losses {loss_err}, checksum {sum_err:.3e}")
        if len(graphs.captures) != len(first) or not all(np.isfinite(x["total"]) for x in grows):
            raise RuntimeError(f"train graph ({dtype_name}): {len(graphs.captures)} captures for buckets {buckets}")
        rec[dtype_name] = r
        if not bf16:
            del gm, gstate, em, estate, graph, eager
            torch.cuda.empty_cache()
            continue

        # a third bucket: its capture, the pool's bytes and the peak with three buckets captured
        b48, te48 = _pad_ligands(batches[0], t_eps[0], 48)
        gstep(gstate, b48.to(dev), t_eps=te48)
        torch.cuda.synchronize()
        caps = graphs.captures
        r.update(capture_s=[c["capture_s"] for c in caps], pool_bytes=graphs.pool_bytes(),
                 peak_memory_bytes=torch.cuda.max_memory_allocated(),
                 captured_buckets=[c["inputs"]["in.batch.lig_x"][1] for c in caps])
        print(f"train graph memory: captures of buckets {r['captured_buckets']} in "
              f"{[round(c, 3) for c in r['capture_s']]} s; graph pool {r['pool_bytes']} bytes; peak memory "
              f"{r['peak_memory_bytes']} bytes with three buckets captured (eager run's peak {eager_peak} bytes; "
              f"torch.cuda.max_memory_allocated)", flush=True)
        if len(caps) != 3:
            raise RuntimeError(f"train graph: {len(caps)} captures after a third bucket")

        # under torch.profiler: GRAPH_TRAIN_PROFILED steps of each path on buckets already captured
        prof_idx = timed[:GRAPH_TRAIN_PROFILED]
        prof = {}
        for mode, (st, fn) in (("graph", (gstate, gstep)), ("eager", (estate, estep))):
            dev_batches = [(batches[i].to(dev), t_eps[i]) for i in prof_idx]
            wall, device, kernels, _ = profiled(lambda: [fn(st, b, t_eps=te) for b, te in dev_batches])
            n = len(prof_idx)
            prof[mode] = dict(wall_ms_per_step=wall / n * 1e3, device_ms_per_step=device / n * 1e3,
                              busy=device / wall, kernels_per_step=kernels / n)
        r["profile"] = prof
        print("train graph profile, " + "; ".join(
            f"{m}: wall {v['wall_ms_per_step']:.3f} / device {v['device_ms_per_step']:.3f} ms/step, busy "
            f"{v['busy']:.3f}, {v['kernels_per_step']:.0f} kernels/step" for m, v in prof.items())
              + f" ({len(prof_idx)} steps each)", flush=True)

        # the held-out loss graph on the trained weights: launches captured x replays, against the plain version
        fixed = types.SimpleNamespace(epoch=lambda: iter(eval_batches))
        egnn_edge.launches = 0
        ev_graph = evaluate(gm, fixed, dev, torch.Generator(device=dev).manual_seed(seed + 9))
        torch.cuda.synchronize()
        ev_launches = egnn_edge.launches
        entries = list(gm.loss_graphs._entries.values())
        real = egnn_mod.egnn_edge_dense
        egnn_mod.egnn_edge_dense = egnn_edge.egnn_edge_dense_plain
        try:
            ev_plain = evaluate(gm, fixed, dev, torch.Generator(device=dev).manual_seed(seed + 9), cuda_graph=False)
        finally:
            egnn_mod.egnn_edge_dense = real
        per_batch = launches_per_step(gm)
        ev_err = {k: _rel(ev_graph[k], ev_plain[k]) for k in ev_plain}
        replays = sum(e.replays for e in entries)
        r["eval"] = dict(batches=len(eval_batches), launches=ev_launches, graphs=len(entries),
                         captured_per_replay=[e.launches for e in entries], replays=replays, rel_err=ev_err,
                         graph=ev_graph, plain=ev_plain,
                         capture_s=[c["capture_s"] for c in gm.loss_graphs.captures],
                         pool_bytes=gm.loss_graphs.pool_bytes())
        print(f"train graph held-out loss: {len(eval_batches)} batches through {len(entries)} loss graphs, "
              f"{ev_launches} edge-kernel launches ({[e.launches for e in entries]} captured x {replays} replays, "
              f"plus the first batch's eager warm-up); against the plain version: rel err "
              + ", ".join(f"{k} {v:.3e}" for k, v in sorted(ev_err.items()))
              + f" (gate {LOSS_TOL[torch.bfloat16]:.0e})", flush=True)
        if (ev_launches != per_batch * len(eval_batches) or any(e.launches != per_batch for e in entries)
                or replays != len(eval_batches) - 1):
            raise RuntimeError(f"held-out loss graph: {ev_launches} launches, {[e.launches for e in entries]} "
                               f"captured, {replays} replays over {len(eval_batches)} batches")
        if max(ev_err.values()) > LOSS_TOL[torch.bfloat16]:
            raise RuntimeError(f"held-out loss graph vs plain: {ev_err}")

        # the caches keyed on parameter versions after replayed steps: the analyzer's chain graph, step by step
        # on the fresh model's states, against the fresh model's eager steps (free-running bf16 chains on
        # trained weights are chaotic: their distance is reported)
        n_chain_caps = len(gm.chain_graphs.captures)
        got = analyzer_chain(gm)
        entry = gm.chain_graphs.last
        fresh = model_from_config(dcfg, device=dev, seed=seed + 1)
        load_params(fresh, {k: v.detach().cpu().numpy() for k, v in gm.named_parameters()})
        want = analyzer_chain(fresh)
        free_err = max(float((got[k] - want[k]).abs().max() / want[k].abs().max().clamp_min(1e-30))
                       for k in ("frames_x", "frames_h"))
        with torch.no_grad():
            enc, kk = fresh.encode(cpx)
            st, n_steps, _ = fresh.start_chain(enc, kk, sample_steps=GRAPH_TRAIN_CHAIN_K, noise=noise)
            fdyn = fresh._sampling_dynamics()
            frame_err = []
            for _ in range(n_steps):
                ref = clone_tree(st)
                fresh.reverse_step(fdyn, ref, 1.0)
                copy_tree(entry.static, st)
                entry.replay()
                torch.cuda.synchronize()
                frame_err.append(max(float((entry.static[k] - ref[k]).abs().max() / ref[k].abs().max().clamp_min(1e-30))
                                     for k in STATE))
                st = ref
        precast_equal = all(torch.equal(a, b) for a, b in zip(gm._sampling_dynamics().state_dict().values(),
                                                                fresh._sampling_dynamics().state_dict().values()))
        packs_equal = all(torch.equal(a, b) for ga, fa in ((gm._sampling_dynamics(), fresh._sampling_dynamics()),
                                                           (gm.dynamics, fresh.dynamics))
                          for pa, pb in zip(_edge_packs(ga), _edge_packs(fa)) for a, b in zip(pa, pb))
        change = max(float((p.detach().cpu() - torch.from_numpy(flat[n])).abs().max())
                     for n, p in gm.named_parameters())
        recaptured = len(gm.chain_graphs.captures) - n_chain_caps
        r["versions"] = dict(step_rel_err=frame_err, free_running_rel_diff=free_err, precast_equal=precast_equal,
                             packs_equal=packs_equal, chain_recaptures=recaptured, max_param_change=change)
        print(f"train graph caches after {len(batches)} graph steps (largest parameter change {change:.3e}): the "
              f"analyzer's chain graph (K={GRAPH_TRAIN_CHAIN_K}, batch {FAMILY_BATCH}) step by step against a fresh "
              f"model loaded with the trained weights, on its states: max {max(frame_err):.3e} of scale (gate "
              f"{GRAPH_TOL[torch.bfloat16]:.0e}); free-running chains {free_err:.3e} apart (reported); bf16 "
              f"sampling copy equal {precast_equal}; edge-kernel packed weights equal {packs_equal}; chain graph "
              f"recaptured {recaptured} time(s)", flush=True)
        if not (max(frame_err) <= GRAPH_TOL[torch.bfloat16] and precast_equal and packs_equal and recaptured == 1):
            raise RuntimeError(f"caches after graph steps: frames {max(frame_err):.3e}, precast {precast_equal}, "
                               f"packs {packs_equal}, chain recaptures {recaptured}")
        del gm, gstate, em, estate, fresh, graph, eager
        torch.cuda.empty_cache()
    return rec


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
    for weights_file in (args.params, GVP_PARAMS):
        if not Path(weights_file).is_file():
            print(f"chip_smoke: trained weights {weights_file} not found", file=sys.stderr)
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
    product_err = product_check(args.seed)
    rng = np.random.default_rng(args.seed)
    shape_rows = []
    # the flagship's shapes, many sources, and the other families' (width 256 of egnn_40kp_fast, K=20 of
    # egnn_20kp, egnn_ca's 128 x 128 kk, egnn_all_atom's block windows: 3 x 64 sources to 64 per tile, B * 6 rows),
    # and ll32 at B=8, a data-parallel rank's share of phase 11's batch
    for label, b, ns, nd, h in (("ll16", BATCH, 16, 16, 257), ("ll32", BATCH, 32, 32, 257),
                                ("ll48", BATCH, 48, 48, 257), ("kk40", BATCH, 40, 40, 257),
                                ("ns192_nd48", 16, 192, 48, 257), ("ns384_nd48", 16, 384, 48, 257),
                                ("kk40_h256", BATCH, 40, 40, 256), ("ll32_h256", BATCH, 32, 32, 256),
                                ("ll32_b8", 8, 32, 32, 257),
                                ("kk20", BATCH, 20, 20, 257), ("kk128", FAMILY_BATCH, 128, 128, 257),
                                ("block192x64", FAMILY_BATCH * 6, 192, 64, 257)):
        base = random_args(rng, b, ns, nd, h, dev)
        for cd in (torch.bfloat16, torch.float32):
            shape_rows.append(measure(with_dtype(base, cd), cd, f"random_{label}", iters=20 if cd == torch.bfloat16 else 3))
        del base
    phase("kernel", t0)

    # ---- 3b. the GVP message kernel against GVPEdgeMessages.nbr
    t0 = time.perf_counter()
    gvp_rows = gvp_message_phase(args.seed, dev)
    phase("gvp_message", t0)

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
        ns, nd = a[0].shape[1], a[1].shape[1]
        kind = "kk" if ns == nd == pad.n_kp else "kl" if ns == pad.n_kp else "lk" if nd == pad.n_kp else "ll"
        key = kind + (str(ns) if ns == nd else f"{ns}to{nd}")
        if key not in captured:
            captured[key] = (egnn_edge.snapshot_args(a), kw["compute_dtype"])
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
            layout = layout_name(kk)
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
            want = launches_per_step(model) * STEPS
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
        out_k = model.sample(enc, kk, sample_steps=K10, noise=noise, cuda_graph=False)
        egnn_mod.egnn_edge_dense = plain_wrapper
        out_p = model.sample(enc, kk, sample_steps=K10, noise=noise, cuda_graph=False)
        nudged = dict(noise, init_x=np.nextafter(noise["init_x"], np.float32(np.inf)))
        out_pu = model.sample(enc, kk, sample_steps=K10, noise=nudged, cuda_graph=False)
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
    if len(step_errs) != launches_per_step(model) * K10:
        raise RuntimeError(f"the 10-step chain made {len(step_errs)} kernel calls")
    del encoded
    phase("slice", t0)

    # ---- 5. serving: a run directory from the trained weights; four requests
    t0 = time.perf_counter()
    del model, enc, kk, out_k, out_p, out_pu
    tmp_root = tempfile.TemporaryDirectory()
    tmp = Path(tmp_root.name)
    t1 = time.perf_counter()
    q_train, q_test = molgen_splits_for_config(cfg, pad, resolve_feature_sizes(cfg)[0], QUALITY_SPLIT, QUALITY_SEED)
    run, run_cfg = make_run_dir(tmp, args.params, q_train, q_test)
    pdb, sdf = write_synthetic_complex(np.random.default_rng(args.seed + 2), tmp, cfg["dataset"]["lig_elements"])
    print(f"serve setup: molgen splits {len(q_train)} / {len(q_test)} (seed {QUALITY_SEED}), run dir, receptor "
          f"and ligand in {time.perf_counter() - t1:.3f} s", flush=True)
    sampler, serve_record, serve_paths = serve_phase(run, run_cfg, pdb, sdf, args.seed, tmp)
    if not 260 <= serve_record["pocket_atoms"] <= pad.n_rec:
        raise RuntimeError(f"synthetic receptor: pocket of {serve_record['pocket_atoms']} atoms")
    phase("serve", t0)

    # ---- 6. train: flagship training steps, held-out loss, export -> serve
    t0 = time.perf_counter()
    train_record, train_paths, par_batches, graph_train_inputs = train_phase(args.params, args.seed, dev)
    phase("train", t0)

    # ---- 7. front ends: byop (PDB, mmCIF), sample CLI, HTTP server, train CLI with the analyzer
    t0 = time.perf_counter()
    front_record, front_paths = frontends_phase(run, run_cfg, sampler, pdb, sdf, args.seed, tmp)
    phase("frontends", t0)

    # ---- 8. quality on held-out molgen pockets against STRIDED_QUALITY.json
    t0 = time.perf_counter()
    quality_record, quality_path = quality_phase(sampler.model, run_cfg, q_train, q_test, args.seed)
    del sampler
    tmp_root.cleanup()
    phase("quality", t0)

    # ---- 9. families: every other config at full width and depth; GVP quality on the trained gvp_40kp
    t0 = time.perf_counter()
    family_records, family_paths, data_cache, new_inputs = {}, {}, {}, []
    for name in FAMILIES:
        family_records[name], launches = family_phase(name, args.seed, dev, data_cache, new_inputs)
        family_paths.update(launches)
    del data_cache
    family_rows = [measure(a, cd, f"main_{name}_b{k[0]}_ns{k[1]}_nd{k[2]}_h{k[3]}"
                           + "".join(f"_cap{c}" for c in k[4:]))  # a list-mode launch's key ends in its cap
                   for name, k, a, cd in new_inputs]
    del new_inputs
    b, k, cap = AA_CELL_KK[:3]
    family_rows.append(measure(cell_list_args(args.seed, dev), torch.bfloat16, f"aa_cell_kk_b{b}_k{k}_cap{cap}"))
    torch.cuda.empty_cache()
    gvp_cfg = load_config("configs/gvp_40kp.yml")
    gvp_model = model_from_config(gvp_cfg, device=dev, seed=args.seed)
    load_params(gvp_model, read_keystr_npz(GVP_PARAMS))
    gvp_model.eval()
    gvp_quality, gvp_quality_path = quality_phase(gvp_model, gvp_cfg, q_train, q_test, args.seed,
                                                  record_file="STRIDED_QUALITY_GVP.json", gates=GVP_QUALITY_GATES)
    family_paths["quality_gvp"] = gvp_quality_path
    del gvp_model
    phase("families", t0)

    # ---- 10. the reference user: raw data -> process -> train -> sample; upstream checkpoints; graph options
    t0 = time.perf_counter()
    ref_cfg = load_config(CONFIG)
    with tempfile.TemporaryDirectory() as ref_tmp:
        raw_record, ref_paths = raw_data_phase(ref_cfg, args.seed, ref_tmp)
        checkpoints = {args.params: checkpoint_phase(ref_cfg, args.params, ref_tmp, EXECUTED),
                       GVP_PARAMS: checkpoint_phase(gvp_cfg, GVP_PARAMS, ref_tmp,
                                                    dict(rec_encoder_gvp=dict(attn_semantics="executed")))}
    flat = read_keystr_npz(args.params)
    options, option_inputs = {}, []
    for label, over, check, per_step in (
            ("default_knn_pairs", {}, 0, 24),  # the config's own kl_k 5 kNN mask and radius ll: the baseline
            ("kl_radius_intent", dict(kl_k=0, z_semantics="intent"), REF_CHECK_STEPS, 24),
            ("kl_radius_executed", dict(kl_k=0, z_semantics="executed"), REF_CHECK_STEPS, 24),
            ("ll_knn16", dict(ll_k=16), 0, 24)):
        options[label], path = graph_option_phase(ref_cfg, flat, args.seed, dev, label, over, check, option_inputs)
        if path["launches_per_step"] != per_step:
            raise RuntimeError(f"{label}: {path['launches_per_step']} launches a step, expected {per_step}")
        ref_paths[f"ref_{label}"] = path["launches"]
        if check:
            ref_paths[f"ref_{label}_checked"] = options[label]["checked"]["launches"]
    del flat
    option_rows = [measure(a, cd, f"ref_{label}_b{k[0]}_ns{k[1]}_nd{k[2]}_h{k[3]}")
                   for label, k, a, cd in option_inputs if label in ("kl_radius_intent", "ll_knn16")]
    del option_inputs
    encoder_rows = encoder_times({"egnn_40kp": (ref_cfg, args.params), "gvp_40kp": (gvp_cfg, GVP_PARAMS)},
                                 args.seed, dev)
    torch.cuda.empty_cache()
    phase("reference_user", t0)

    # ---- 11. the parallel layer at world size 1 through NCCL
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as par_tmp:
        par_record, par_paths, par_rows = parallel_phase(args.params, args.seed, dev, *par_batches, par_tmp)
    del par_batches
    torch.cuda.empty_cache()
    phase("parallel", t0)

    # ---- 12. the reverse chain as a captured CUDA graph, against eager steps
    t0 = time.perf_counter()
    graph_record = graph_phase(args.params, args.seed, dev)
    graph_paths = {f"graph_flagship_{n}": r["launches"] for n, r in graph_record["flagship"].items()}
    graph_paths.update({f"graph_profiled_{k}": v["profiled_edge_launches"] for k, v in graph_record["layouts"].items()})
    phase("graphs", t0)

    # ---- 13. the optimizer step and the held-out loss as captured CUDA graphs, against eager steps
    t0 = time.perf_counter()
    train_graph_record = train_graph_phase(args.params, args.seed, dev, *graph_train_inputs)
    del graph_train_inputs
    graph_paths["train_graph_eval"] = train_graph_record["bfloat16"]["eval"]["launches"]
    phase("train_graphs", t0)

    # ---- torch.profiler's device time of the small grids, after every timed phase (it slows what follows it)
    t0 = time.perf_counter()
    for row, run, a, kw, iters in PROFILE_LATER:
        row["profiler_ms"] = profiler_ms(lambda: run(*a, **kw), iters)
        print(f"kernel {row['shape']} {row['dtype']}: profiler_ms={row['profiler_ms']} device_ms={row['device_ms']:.4f} "
              f"kernel_ms={row['ms']:.4f}", flush=True)
    read = sum(r["profiler_ms"] is not None for r, *_ in PROFILE_LATER)
    PROFILE_LATER.clear()
    phase(f"profiler ({read} small-grid rows read)", t0)

    total = time.perf_counter() - t_all
    print(f"total wall: {total:.3f} s", flush=True)
    head = main_rows.get("ll48") or next(iter(main_rows.values()))
    kernels = {"kernels": [{
        "name": "egnn_edge_dense", "route": "cuda", "source": "kpdiff_tpu_torch/csrc/egnn_edge.cu",
        "replaces": "kpdiff_tpu/ops/pallas/egnn_edge.py:174", "launches": main_launches, "kernel": "v5",
        "product_alone_max_rel_err": product_err,
        "shape": head["shape"], "max_abs_err": head["max_abs_err"], "max_rel_err_bf16": head["max_rel_err"],
        "ms": head["ms"], "kernel_ms": head["ms"], "device_ms": head["device_ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "library_device_ms": head["library_device_ms"],
        "launches_by_path": dict(sample=main_launches, **{k: v["launches"] for k, v in serve_paths.items()},
                                 **train_paths, **{k: v["launches"] for k, v in front_paths.items()},
                                 quality=quality_path["launches"],
                                 **{k: v["launches"] for k, v in family_paths.items()}, **ref_paths, **par_paths,
                                 **graph_paths),
        "shapes": list(main_rows.values()) + family_rows + option_rows + par_rows + shape_rows,
    }, {
        "name": "gvp_message_list", "route": "cuda", "source": "kpdiff_tpu_torch/csrc/gvp_message.cu",
        "replaces": "none", "reference": "kpdiff_tpu_torch/models/gvp.py::GVPEdgeMessages",
        "launches": sum(v["gvp_launches"] for v in family_paths.values()),
        "launches_by_path": {k: v["gvp_launches"] for k, v in family_paths.items() if v["gvp_launches"]},
        "shapes": gvp_rows,
    }]}
    record = dict(card=card, device=torch.cuda.get_device_name(0), weights=weights, slice=slice_rows,
                  mixture_s_per_ligand=mixture, chain_step_max_rel_err=chain_step_err,
                  chain_free_max_rel_diff=chain_free, chain_one_ulp_max_rel_diff=chain_ulp, serve=serve_record,
                  train=train_record, frontends=front_record, quality=quality_record,
                  paths={**serve_paths, **front_paths, "quality": quality_path}, families=family_records,
                  quality_gvp=gvp_quality, reference_user=dict(raw=raw_record, checkpoints=checkpoints,
                                                                graph_options=options, encoders=encoder_rows),
                  parallel=par_record, graphs=graph_record, train_graphs=train_graph_record, total_wall_s=total,
                  **kernels)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
