"""Training CLI of the port (kpdiff_tpu/cli/train.py).

    python -m kpdiff_tpu_torch.cli.train --config configs/egnn_40kp.yml --synthetic_mol 256
    python -m kpdiff_tpu_torch.cli.train --resume runs/<run_dir>

Trains on one CUDA card by default and raises without one (`--device cpu`
runs the plain PyTorch path on the CPU). On the card each optimizer step
and each held-out loss replays a captured CUDA graph, one per ligand
bucket (training/train_graph.py); under `--n_devices` and with
`rec_encoder_loss.method: exact` the step runs eagerly. A run directory
holds config.yml, train_metrics.pkl, test_metrics.pkl and
checkpoints/step_N.pt (parameters, optimizer state and step);
`cli/export_params.py` turns a checkpoint into the keystr npz that both
packages load. Metrics go to the pickle logs and
stdout only. Every `training.sample_interval` epochs, from epoch ~0 on, the
molecule analyzer (analysis/analyzer.py) samples a few held-out pockets and
appends its `mol_*` row to test_metrics.pkl (`export_params --best` reads
them).

`--n_devices N` trains data parallel on N devices, one rank each
(0 = every visible device); `--mp_devices M` (dividing N, and dividing the
keypoint count) splits the keypoints over M of them, a ('data', 'model')
mesh of (N/M, M) (training/trainer.py). Outside a process group the CLI
starts its N ranks itself; under torchrun it uses the group. Every rank
loads the same global batches and takes its rows; rank 0 makes the run
directory, writes the checkpoints and the metrics logs, and runs the
held-out loss and the analyzer.
"""
from __future__ import annotations

import argparse
import ast
import contextlib
import time
import uuid
from pathlib import Path


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--resume", type=str, default=None, help="run dir to resume from")
    p.add_argument("--synthetic", type=int, default=0, help="train on N synthetic complexes")
    p.add_argument("--synthetic_mol", type=int, default=0,
                   help="train on N molecule-like synthetic complexes (data/molgen.py)")
    p.add_argument("--epochs", type=float, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--learning_rate", type=float, default=None)
    p.add_argument("--dataset_size", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default; raises without CUDA) or cpu")
    p.add_argument("--n_devices", type=int, default=1, help="devices (ranks); 0 = every visible device")
    p.add_argument("--mp_devices", type=int, default=1,
                   help="devices that split the keypoints (dp x mp); must divide --n_devices")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace of steps 10-15 (the program's kpdiff.* spans "
                        "beside the device's kernels) to this dir")
    p.add_argument("--set", action="append", default=[], metavar="SECTION.KEY=VALUE",
                   help="override any nested config key, e.g. --set dynamics.n_layers=4")
    return p.parse_args(argv)


def apply_overrides(config, overrides):
    for ov in overrides:
        path, _, raw = ov.partition("=")
        keys = path.strip().split(".")
        node = config
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        node[keys[-1]] = value
    return config


def main(argv=None):
    """-> (run_dir, TrainState); (run_dir, None) when it started the ranks itself."""
    args = parse_args(argv)

    from kpdiff_tpu_torch.config import PaddingConfig, dump_yaml, load_config
    from kpdiff_tpu_torch.device import resolve_device
    from kpdiff_tpu_torch.parallel import distributed as pdist

    dev = resolve_device(args.device)
    pdist.join_launcher_group(args.device)
    n = pdist.world_size() if pdist.in_group() else pdist.resolve_n_devices(args.n_devices, dev)
    if args.mp_devices < 1 or n % args.mp_devices:
        raise SystemExit(f"--mp_devices {args.mp_devices} must divide the device count {n}")
    if args.resume:
        run_dir = Path(args.resume)
        config = apply_overrides(load_config(run_dir / "config.yml"), args.set)
    else:
        config = apply_overrides(load_config(args.config), args.set)
        name = config.get("experiment", {}).get("name", "run")
        results_dir = Path(config.get("experiment", {}).get("results_dir", "runs/"))
        run_dir = results_dir / f"{name}_{time.strftime('%Y%m%d_%H%M%S')}_{uuid.uuid4().hex[:4]}"

    tr = config.setdefault("training", {})
    if args.epochs is not None:
        tr["epochs"] = args.epochs
    if args.batch_size is not None:
        tr["batch_size"] = args.batch_size
    if args.learning_rate is not None:
        tr["learning_rate"] = args.learning_rate
    if args.dataset_size is not None:
        config.setdefault("dataset", {})["dataset_size"] = args.dataset_size
    n_kp = PaddingConfig.from_config(config).n_kp
    if n_kp % args.mp_devices:
        raise ValueError(f"n_keypoints {n_kp} must be divisible by the 'model' mesh axis size {args.mp_devices} "
                         "for kp-sharded training")
    dp = n // args.mp_devices
    if tr.get("batch_size", 32) % dp:
        raise ValueError(f"batch_size {tr.get('batch_size', 32)} must divide over the {dp} data-parallel ranks")

    if pdist.rank() == 0 and not args.resume:
        run_dir.mkdir(parents=True, exist_ok=True)
        (run_dir / "config.yml").write_text(dump_yaml(config))
    if n > 1 and not pdist.in_group():
        pdist.spawn(_rank_main, n, args=(args, config, str(run_dir)), device=args.device)
        return run_dir, None
    if pdist.in_group():  # every rank takes rank 0's run directory
        import torch
        import torch.distributed as dist

        box = [str(run_dir)]
        dist.broadcast_object_list(box, src=0, device=torch.device("cuda", torch.cuda.current_device())
                                   if dev.type == "cuda" else None)
        run_dir = Path(box[0])
    return _train(args, config, run_dir)


def _rank_main(rank, args, config, run_dir):
    _train(args, config, Path(run_dir))


def _train(args, config, run_dir):
    import torch

    from kpdiff_tpu_torch.config import PaddingConfig, model_from_config, resolve_feature_sizes
    from kpdiff_tpu_torch.data.dataset import ComplexDataset, PaddedLoader, resolve_lig_buckets, synthetic_dataset
    from kpdiff_tpu_torch.data.prefetch import prefetch
    from kpdiff_tpu_torch.parallel import distributed as pdist
    from kpdiff_tpu_torch.parallel.mesh import make_mesh, replicate_params, shard_batch
    from kpdiff_tpu_torch.training.scheduler import is_restart_boundary
    from kpdiff_tpu_torch.utils import profiling
    from kpdiff_tpu_torch.training.trainer import (MetricsLog, checkpoint_steps, init_train_state, load_checkpoint,
                                                   make_train_step, save_checkpoint)

    tr = config["training"]
    mesh = None
    if pdist.in_group():
        n, mp = pdist.world_size(), args.mp_devices
        mesh = make_mesh(n, ("data", "model"), (n // mp, mp), device=args.device)
    writer = pdist.rank() == 0
    dev = mesh.device if mesh else torch.device(args.device)

    model = model_from_config(config, device=dev, seed=args.seed)
    if mesh is not None:
        replicate_params(model, mesh)
    pad = PaddingConfig.from_config(config)
    n_rec_feat, _, _ = resolve_feature_sizes(config)

    # ---- dataset
    ds_cfg = config["dataset"]
    if args.synthetic_mol:
        from kpdiff_tpu_torch.data.molgen import molgen_splits_for_config

        train_ds, test_ds = molgen_splits_for_config(config, pad, n_rec_feat, args.synthetic_mol, args.seed)
    elif args.synthetic:
        rec_range = (min(24, pad.n_rec // 2), pad.n_rec)
        lig_range = (min(8, max(pad.n_lig // 2, 2)), pad.n_lig)
        kw = dict(n_rec_feat=n_rec_feat, n_lig_feat=len(ds_cfg["lig_elements"]), rec_range=rec_range,
                  lig_range=lig_range)
        train_ds = synthetic_dataset(args.synthetic, seed=args.seed, **kw)
        test_ds = synthetic_dataset(max(args.synthetic // 4, 4), seed=args.seed + 1, **kw)
    else:
        loc = Path(ds_cfg["location"])
        train_ds = ComplexDataset.from_pickle(loc / "train.pkl")
        test_ds = ComplexDataset.from_pickle(loc / "val.pkl")

    lig_buckets = resolve_lig_buckets(config, train_ds, pad.n_lig)
    batch_size = tr.get("batch_size", 32)

    def loader(ds, seed, drop_last=True):
        return PaddedLoader(ds, pad, batch_size=batch_size, n_kp=pad.n_kp, kp_feat_dim=model.cfg.rec_nf,
                            max_fake_atom_frac=ds_cfg.get("max_fake_atom_frac", 0.0), seed=seed,
                            drop_last=drop_last, lig_buckets=lig_buckets, kp_vec_dim=model.kp_vec_dim)

    train_loader = loader(train_ds, args.seed)
    test_loader = loader(test_ds, args.seed + 7, drop_last=False)
    iters_per_epoch = max(len(train_ds) // batch_size, 1)

    tcfg = train_config_from(config)
    state = init_train_state(model, tcfg)
    if args.resume:
        load_checkpoint(run_dir / "checkpoints", state)
        print(f"resumed from step {state.step}", flush=True)
    step_fn = make_train_step(tcfg, iters_per_epoch, mesh=mesh,
                              kp_axis="model" if mesh is not None and args.mp_devices > 1 else None)
    generator = torch.Generator(device=dev).manual_seed(args.seed + 1)

    train_log = MetricsLog(run_dir / "train_metrics.pkl") if writer else None
    test_log = MetricsLog(run_dir / "test_metrics.pkl") if writer else None
    ckpt_dir = run_dir / "checkpoints"
    if ((config.get("wandb") or {}).get("init_kwargs") or {}).get("mode", "disabled") != "disabled":
        print("wandb is not used by the port; metrics go to the pickle logs only", flush=True)

    # in-training molecule-quality analyzer (reference ModelAnalyzer, train.py:555-572), with the
    # training split's atom-type histogram for its KL metric
    from kpdiff_tpu_torch.analysis.analyzer import ModelAnalyzer
    from kpdiff_tpu_torch.data.molgen import type_counts

    samp_cfg = config.get("sampling_config", {})
    analyzer = ModelAnalyzer(
        model, test_ds, pad, lig_elements=ds_cfg["lig_elements"],
        n_receptors=min(samp_cfg.get("n_receptors", 2), 8), n_replicates=min(samp_cfg.get("n_replicates", 4), 12),
        train_type_counts=type_counts(train_ds), seed=args.seed + 11,
        diff_batch_size=samp_cfg.get("diff_batch_size", 0))
    sample_interval = tr.get("sample_interval", 0)
    # fire once at epoch ~0, so that the run records the untrained baseline
    last_sample_marker = -sample_interval if sample_interval else 0.0

    test_interval = tr.get("test_interval", 1)
    save_interval = tr.get("save_interval", 1)
    metrics_interval = tr.get("train_metrics_interval", 0.1)
    last_test_marker = last_save_marker = last_metrics_marker = 0.0
    prev_epoch = 0.0
    nonfinite_streak = 0
    dropped_warned = False
    trace = contextlib.ExitStack()  # --profile_dir: utils/profiling.py::device_trace over steps 10-15

    n_params = sum(p.numel() for p in model.parameters())
    if writer:
        print(f"run dir: {run_dir}; params: {n_params:,}; device: {dev}; devices: {pdist.world_size()} "
              f"(model axis {args.mp_devices}); iters/epoch: {iters_per_epoch}", flush=True)

    epochs = tr.get("epochs", 3)
    t0 = time.time()
    done = False
    while not done:
        n_batches = 0
        for n_batches, batch in enumerate(prefetch(train_loader.epoch(), depth=2), start=1):
            epoch_exact = state.step / iters_per_epoch
            if epoch_exact >= epochs:
                done = True
                break
            if args.profile_dir and writer and state.step == 10:
                trace.enter_context(profiling.device_trace(args.profile_dir, cuda=dev.type == "cuda"))
            if args.profile_dir and writer and state.step == 15:
                trace.close()
                print(f"profiler trace written to {args.profile_dir}", flush=True)

            # this rank's rows of each micro-batch
            batch = batch if mesh is None else shard_batch(batch, mesh, micro_batches=tcfg.grad_accum)
            metrics = step_fn(state, batch.to(dev, non_blocking=True), generator=generator)

            # a skipped non-finite step is logged; a streak of them halts the
            # run without saving, to resume from the newest good checkpoint
            if metrics["skipped_nonfinite"] > 0:
                nonfinite_streak += 1
                print(f"  WARNING: non-finite loss/grad at step {state.step}; "
                      f"update skipped (streak {nonfinite_streak})", flush=True)
            else:
                nonfinite_streak = 0
            if nonfinite_streak >= 10:
                steps = checkpoint_steps(ckpt_dir) if ckpt_dir.exists() else []
                last_good = f"step_{steps[-1]}.pt" if steps else "none"
                raise RuntimeError(f"10 consecutive non-finite losses ending at step {state.step}; "
                                   f"state NOT saved; resume from {ckpt_dir}/{last_good}")
            if not writer:
                continue

            if epoch_exact - last_metrics_marker >= metrics_interval:
                last_metrics_marker = epoch_exact
                row = dict(metrics, epoch=epoch_exact)
                train_log.append(**row)
                print(f"epoch {epoch_exact:7.2f} step {state.step:6d} l2 {row['l2']:.4f} pos {row['pos']:.4f} "
                      f"feat {row['feat']:.4f} rec {row['rec_encoder']:.4f} lr {row['lr']:.2e} "
                      f"({time.time() - t0:.0f}s)", flush=True)

            if epoch_exact - last_test_marker >= test_interval:
                last_test_marker = epoch_exact
                test_row = evaluate(model, test_loader, dev, generator, test_epochs=tr.get("test_epochs", 1))
                test_row["epoch"] = epoch_exact
                test_log.append(**test_row)
                print(f"  test: {test_row}", flush=True)

            if sample_interval and epoch_exact - last_sample_marker >= sample_interval:
                last_sample_marker = epoch_exact
                mol_metrics = analyzer.sample_and_analyze(generator)
                mol_metrics["epoch"] = epoch_exact
                test_log.append(**{f"mol_{k}": v for k, v in mol_metrics.items()})
                print(f"  molecules: {mol_metrics}", flush=True)

            if epoch_exact - last_save_marker >= save_interval:
                last_save_marker = epoch_exact
                save_checkpoint(ckpt_dir, state)
            if is_restart_boundary(tcfg.scheduler, prev_epoch, epoch_exact):
                save_checkpoint(ckpt_dir, state)
            prev_epoch = epoch_exact

        # complexes beyond the padding capacity are data loss: say so
        if writer and train_loader.n_dropped and not dropped_warned:
            dropped_warned = True
            print(f"  WARNING: {train_loader.n_dropped}/{len(train_ds)} training complexes exceed padding "
                  f"capacity (n_lig={pad.n_lig}, n_rec={pad.n_rec}, n_ip={pad.n_ip}) and were dropped", flush=True)
        if not done and n_batches == 0:  # an epoch without a batch would loop forever
            raise ValueError(f"the training split gives no batch of {batch_size}: {len(train_ds)} complexes, "
                             f"{train_loader.n_dropped} beyond the padding capacity")
    trace.close()

    if not writer:
        return run_dir, state
    final_epoch = state.step / iters_per_epoch
    test_row = evaluate(model, test_loader, dev, generator, test_epochs=tr.get("test_epochs", 1))
    test_row["epoch"] = final_epoch
    test_log.append(**test_row)
    print(f"  final test: {test_row}", flush=True)
    path = save_checkpoint(ckpt_dir, state)
    print(f"done at step {state.step}; final checkpoint saved to {path}", flush=True)
    return run_dir, state


def train_config_from(config):
    """TrainConfig from a config's training section (the JAX CLI's defaults)."""
    from kpdiff_tpu_torch.training.scheduler import SchedulerConfig
    from kpdiff_tpu_torch.training.trainer import TrainConfig

    tr = config.get("training", {})
    sched = tr.get("scheduler", {})
    return TrainConfig(
        learning_rate=tr.get("learning_rate", 1e-4),
        weight_decay=tr.get("weight_decay", 1e-12),
        clip_grad=tr.get("clip_grad", True),
        clip_value=tr.get("clip_value", 1.5),
        batch_size=tr.get("batch_size", 32),
        epochs=tr.get("epochs", 3),
        rec_encoder_loss_weight=tr.get("rec_encoder_loss_weight", 0.1),
        rl_hinge_loss_weight=tr.get("rl_hinge_loss_weight", 0.0),
        grad_accum=int(tr.get("grad_accum", 1) or 1),
        scheduler=SchedulerConfig(
            base_lr=tr.get("learning_rate", 1e-4),
            warmup_length=sched.get("warmup_length", 0),
            restart_interval=sched.get("restart_interval", 0),
            restart_type=sched.get("restart_type", "cosine"),
            rec_enc_loss_weight=tr.get("rec_encoder_loss_weight", 0.1),
            rec_enc_weight_decay_midpoint=sched.get("rec_enc_weight_decay_midpoint", 0),
            rec_enc_weight_decay_scale=sched.get("rec_enc_weight_decay_scale", 1),
        ),
    )


def evaluate(model, test_loader, device, generator=None, test_epochs=1, cuda_graph=None):
    """Held-out loss over `test_epochs` passes of the test split, under
    no_grad (training/train_graph.py::heldout_loss): on a card each batch
    replays a captured graph of the loss, cached per bucket (cuda_graph
    False: eagerly), and the dense edges go through the CUDA kernel."""
    from kpdiff_tpu_torch.training.train_graph import heldout_loss

    sums, n = {}, 0
    for _ in range(max(int(test_epochs), 1)):
        for batch in test_loader.epoch():
            for key, v in heldout_loss(model, batch.to(device), generator, cuda_graph=cuda_graph).items():
                sums[key] = sums.get(key, 0.0) + v
            n += 1
    return {f"test_{k}": v / max(n, 1) for k, v in sums.items()}


if __name__ == "__main__":
    main()
