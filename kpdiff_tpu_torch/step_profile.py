"""Where the port's reverse-diffusion and training steps spend their time on the card.

    python3 -m kpdiff_tpu_torch.step_profile [--config YML] [--buckets 16 32 48] [--params NPZ] [--own_kk]
                                             [--batch N] [--out FILE]
    python3 -m kpdiff_tpu_torch.step_profile --train [--graph] [--config YML] [--params NPZ] [--out FILE]

Builds --config (default configs/egnn_40kp.yml; any family of configs/) at
full width and depth (seeded random weights unless --params names a keystr
npz), encodes a synthetic batch of --batch pockets (default 128) per ligand bucket, compacts kk as
the samplers do (--own_kk keeps the encoder's dense or block kk), and runs
10 strided sampling steps under torch.profiler, eagerly (cuda_graph=False:
the step's kernels launched one by one, as the per-launch listing below
needs), then 10 replays of the step's captured CUDA graph (the samplers'
default path, models/chain_graph.py).
Prints, per bucket and path, the wall time per step, the device time per
step summed over kernels, their ratio (the device's busy share) and, for
the eager steps, the kernels that take the most device time; for the graph,
its capture's seconds, pool bytes and kernel nodes, and the step's device
time by edge set from the tracer's timers inside the graph
(utils/profiling.py: ll, kl and lk, kk, the rest), beside the replays'
device time on CUDA events. For an EGNN config, then, for each shape of the
edge kernel on that bucket's path, one launch of the kernel's profiling
build (-DEGNN_EDGE_PHASE_CLOCKS) on the inputs the path gave it: the share
of the warps' SM clocks spent in each in-kernel phase, for each chain's
consumer and helper warps (mask mode shapes; the eager steps' listing
shows the list mode's launches too, as "<shape> list"). --out also writes
the tables to a file.

--train profiles training of --config instead (the flagship by default): molgen's 256-complex split at
full padding, the config's batch size, the port's train step, eagerly
(cuda_graph=False: launch by launch); 3 warm-up steps, then 6 steps under
torch.profiler (wall and device ms per step, busy share, top kernels).
--graph adds the same 6 steps replayed from the step's captured CUDA
graphs (the trainer's default path, training/train_graph.py), after 3
steps that capture them: the same table, each capture's seconds, pool bytes
and kernel nodes, the two paths side by side, and the graph step's device
time by segment from the tracer's timers (encoder, ll, kl, kk, the OT loss,
the optimizer, the rest; each segment's backward in its own slot) beside
the replays' device time on CUDA events.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import kpdiff_tpu_torch.models.egnn as egnn_mod
from kpdiff_tpu_torch.config import PaddingConfig, load_config, model_from_config, resolve_feature_sizes
from kpdiff_tpu_torch.models.complex import synthetic_batch
from kpdiff_tpu_torch.ops.cuda import egnn_edge
from kpdiff_tpu_torch.ops.edge_sets import layout_name
from kpdiff_tpu_torch.utils.params_io import load_params, read_keystr_npz
from kpdiff_tpu_torch.utils.profiling import SLOTS

CONFIG = "configs/egnn_40kp.yml"
BATCH = 128
STEPS = 10
TOP = 15  # kernels listed per bucket


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _kernel_table(prof, steps, wall):
    """Device time per step summed over kernel rows, busy share, kernels per
    step and the top kernels. A user annotation's row on the device (the
    optimizer's step) repeats its kernels' time and is left out."""
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and _device_us(e) > 0
              and not getattr(e, "is_user_annotation", False)]
    device_s = sum(_device_us(e) for e in events) * 1e-6
    events.sort(key=_device_us, reverse=True)
    lines = [f"wall {wall / steps * 1e3:.3f} ms/step (profiled), device {device_s / steps * 1e3:.3f} ms/step, "
             f"busy share {device_s / wall:.3f}, {sum(e.count for e in events) / steps:.0f} kernels/step"]
    for e in events[:TOP]:
        us = _device_us(e)
        lines.append(f"  {us / steps / 1e3:9.4f} ms/step {us * 1e-6 / device_s * 100:6.2f}%  "
                     f"{e.count // steps:5d}/step  {e.key[:90]}")
    return lines


def timer_split(graphs, run) -> str:
    """One line: the device ms a replay of each slot that the tracer's
    timers of `graphs` (ChainGraph entries) saw while `run()` replayed them,
    their sum, and the replays' device time on CUDA events around `run`."""
    before = [g.timers.read() for g in graphs]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    after = [g.timers.read() for g in graphs]
    replays = sum(a["replays"] - b["replays"] for a, b in zip(after, before))
    if not replays:
        return "device timers: no replay"
    ms = {k: sum(a["slots_ns"][k] - b["slots_ns"][k] for a, b in zip(after, before)) / replays * 1e-6 for k in SLOTS}
    total = sum(ms.values())
    events_ms = start.elapsed_time(end) / replays
    return ("device timers (ms/replay): " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items() if v)
            + f"; sum {total:.3f} against {events_ms:.3f} on CUDA events around the replays "
            f"({(total / events_ms - 1) * 100:+.2f}%, {replays} replays, host gaps between replays included)")


def train_profile(args):
    """Training steps of --config on the card: profiler tables, and with --graph the timers' split."""
    from kpdiff_tpu_torch.cli.train import train_config_from
    from kpdiff_tpu_torch.data.dataset import PaddedLoader, resolve_lig_buckets
    from kpdiff_tpu_torch.data.molgen import molgen_splits_for_config
    from kpdiff_tpu_torch.training import trainer

    cfg = load_config(args.config)
    cfg["training"]["sample_interval"] = 0
    model = model_from_config(cfg, device="cuda")
    if args.params:
        load_params(model, read_keystr_npz(args.params))
    dev = next(model.parameters()).device
    pad = PaddingConfig.from_config(cfg)
    train_ds, _ = molgen_splits_for_config(cfg, pad, resolve_feature_sizes(cfg)[0], 256, 0)
    buckets = resolve_lig_buckets(cfg, train_ds, pad.n_lig)
    tcfg = train_config_from(cfg)
    loader = PaddedLoader(train_ds, pad, tcfg.batch_size, pad.n_kp, model.cfg.rec_nf, seed=0, drop_last=True,
                          lig_buckets=buckets, kp_vec_dim=model.kp_vec_dim)
    batches = [b.to(dev) for _ in range(3) for b in loader.epoch()]  # 9 batches, buckets 24 and 32
    state = trainer.init_train_state(model, tcfg)
    step_fn = trainer.make_train_step(tcfg, len(train_ds) // tcfg.batch_size, cuda_graph=False)
    gen = torch.Generator(device=dev).manual_seed(0)
    report = [f"{torch.cuda.get_device_name(0)}; {args.config} training; weights {args.params or 'random seed 0'}; "
              f"batch {tcfg.batch_size}; buckets of the profiled steps {[int(b.lig_x.shape[1]) for b in batches[3:]]}"]
    paths = {"eager": step_fn}
    if args.graph:
        paths["graph"] = trainer.make_train_step(tcfg, len(train_ds) // tcfg.batch_size, cuda_graph=True)
    summary = {}
    for label, fn in paths.items():
        for b in batches[:3]:  # warm-up; for the graph, the captures of the buckets
            fn(state, b, generator=gen)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for b in batches[3:]:
                fn(state, b, generator=gen)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        table = _kernel_table(prof, len(batches) - 3, wall)
        summary[label] = table[0]
        report += [f"{label} steps:"] + table
    if args.graph:
        report += [f"graph capture of bucket {c['inputs']['in.batch.lig_x'][1]}: {c['capture_s']:.3f} s, graph pool "
                   f"{c['pool_bytes']} bytes, {c['kernels_per_replay']} kernel nodes"
                   for c in model.train_graphs.captures]
        report += [f"{label}: {line}" for label, line in summary.items()]
        graph_fn = paths["graph"]

        def graph_steps():
            for b in batches[3:]:
                graph_fn(state, b, generator=gen)

        report.append("graph steps, " + timer_split(list(model.train_graphs._entries.values()), graph_steps))
    report.append(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB (torch.cuda.max_memory_allocated)")
    print("\n".join(report), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(report) + "\n")


def _edge_key(role, a):
    """The edge set with the kernel's (Ns x Nd) shape and the EGNNEdge module running (`role`)."""
    return f"{role['now']}{a[0].shape[1]}x{a[1].shape[1]}"


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default=CONFIG, help=f"model config (default {CONFIG})")
    ap.add_argument("--params", default=None)
    ap.add_argument("--buckets", type=int, nargs="+", default=[16, 32, 48])
    ap.add_argument("--batch", type=int, default=BATCH, help=f"pockets a sampling batch (default {BATCH})")
    ap.add_argument("--own_kk", action="store_true",
                    help="sample on the encoder's own kk (dense or blocks) instead of compact_kk's neighbor list")
    ap.add_argument("--train", action="store_true", help="profile training steps of --config instead of sampling")
    ap.add_argument("--graph", action="store_true",
                    help="with --train: also profile the steps replayed from their captured CUDA graphs")
    ap.add_argument("--out", default=None, help="also write the report to this path")
    args = ap.parse_args()
    if args.train:
        return train_profile(args)

    cfg = load_config(args.config)
    model = model_from_config(cfg, device="cuda")
    if args.params:
        load_params(model, read_keystr_npz(args.params))
    model.eval()
    pad = PaddingConfig.from_config(cfg)
    dev = next(model.parameters()).device
    n_rec_feat, n_lig_feat, _ = resolve_feature_sizes(cfg)
    report = [f"{torch.cuda.get_device_name(0)}; {args.config}; weights "
              f"{args.params or 'random seed 0'}; batch {args.batch}; {STEPS} steps"]
    role = {}  # which edge module (edge_ll, edge_kl, edge_lk, edge_kk) is running
    for name, mod in model.named_modules():
        if isinstance(mod, egnn_mod.EGNNEdge):
            mod.register_forward_pre_hook(lambda m, a, r=name.rsplit(".", 1)[-1][-2:]: role.update(now=r))
    for n_lig in args.buckets:
        cpx = synthetic_batch(0, batch=args.batch, n_rec_pad=pad.n_rec, n_lig_pad=n_lig, n_rec_feat=n_rec_feat,
                              n_lig_feat=n_lig_feat, n_kp=pad.n_kp, kp_feat_dim=model.cfg.rec_nf,
                              kp_vec_dim=model.kp_vec_dim, n_ip_pad=pad.n_ip, min_rec=min(260, 3 * pad.n_rec // 4),
                              min_lig=min(18, n_lig - 2), device=dev)
        with torch.no_grad():
            enc, kk = model.encode(cpx)
            if not args.own_kk:
                kk = model.compact_kk(enc, kk)
        gen = torch.Generator(device=dev).manual_seed(0)
        captured = {}  # the edge kernel's inputs, first launch at each shape

        def recording(*a, **kw):
            captured.setdefault(_edge_key(role, a), (egnn_edge.snapshot_args(a), kw))
            return real(*a, **kw)

        real = egnn_mod.egnn_edge_dense
        egnn_mod.egnn_edge_dense = recording
        try:
            model.sample(enc, kk, sample_steps=2, generator=gen, cuda_graph=False)  # warm-up
        finally:
            egnn_mod.egnn_edge_dense = real
        torch.cuda.synchronize()
        chain = []  # (shape key, adj or the list's valid) of every edge-kernel launch in the profiled steps

        def listing(*a, **kw):
            chain.append((_edge_key(role, a), a[15]))
            return real(*a, **kw)

        def listing_list(*a, **kw):  # the list mode (a neighbor-list kk)
            chain.append((_edge_key(role, a) + " list", a[16]))
            return real_list(*a, **kw)

        real_list = egnn_mod.egnn_edge_list
        egnn_mod.egnn_edge_dense, egnn_mod.egnn_edge_list = listing, listing_list
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                model.sample(enc, kk, sample_steps=STEPS, generator=gen, cuda_graph=False)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            egnn_mod.egnn_edge_dense, egnn_mod.egnn_edge_list = real, real_list
        # kernel rows only: an operator's row repeats the time of the kernels it launched
        table = _kernel_table(prof, STEPS, wall)
        lines = [f"bucket {n_lig}: kk={layout_name(kk)} eager steps: {table[0]}"] + table[1:]
        model.sample(enc, kk, sample_steps=2, generator=gen)  # the step's graph: warm-up step and capture
        cap = model.chain_graphs.captures[-1]
        entry = model.chain_graphs.last
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as gprof:
            t0 = time.perf_counter()
            model.sample(enc, kk, sample_steps=STEPS, generator=gen)
            torch.cuda.synchronize()
            gwall = time.perf_counter() - t0
        lines.append(f"  CUDA graph replays: {_kernel_table(gprof, STEPS, gwall)[0]}; capture "
                     f"{cap['capture_s']:.3f} s, graph pool {cap['pool_bytes']} bytes, "
                     f"{cap['launches_per_replay']} edge-kernel launches and {cap['kernels_per_replay']} kernel "
                     f"nodes a replay")
        lines.append("  " + timer_split([entry], lambda: model.sample(enc, kk, sample_steps=STEPS, generator=gen)))
        # the edge kernel launch by launch: profiled device time beside active pairs
        kern = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                       and "egnn_edge_" in e.name), key=lambda e: e.time_range.start)
        if len(kern) == len(chain):
            for key in sorted({k for k, _ in chain}):
                rows = [(_device_us(e), int(adj.sum())) for e, (k, adj) in zip(kern, chain) if k == key]
                lines.append(f"  edge kernel {key}: {len(rows)} launches in {STEPS} steps, mean "
                             f"{sum(r[0] for r in rows) / len(rows) / 1e3:.4f} ms/launch (profiled), mean "
                             f"{sum(r[1] for r in rows) / len(rows):.0f} active pairs, first "
                             f"{rows[0][0] / 1e3:.4f} ms at {rows[0][1]} pairs, last {rows[-1][0] / 1e3:.4f} ms "
                             f"at {rows[-1][1]} pairs")
        elif chain:
            lines.append(f"  edge kernel: {len(kern)} kernel events for {len(chain)} launches (not matched)")
        for key, (a, kw) in sorted(captured.items()):
            for warps, clocks in egnn_edge.phase_clocks(*a, **kw).items():
                total = sum(clocks.values())
                lines.append(f"  edge kernel phase clocks {key}, {warps} warps ({int(a[15].sum())} active pairs): "
                             + ", ".join(f"{name} {v / max(total, 1) * 100:.1f}%" for name, v in clocks.items())
                             + f"; total {total} warp-clocks")
        print("\n".join(lines), flush=True)
        report.extend(lines)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(report) + "\n")


if __name__ == "__main__":
    main()
