"""Multi-device dry run of the port (__graft_entry__.py::dryrun_multichip).

    python -m kpdiff_tpu_torch.dryrun 4 [--device cpu]

With the tiny flagship (configs/egnn_40kp.yml at 2 layers, width 32, 8
keypoints, 20 timesteps) on n ranks: one data-parallel train step, a
data-parallel sample, one dp x mp train step (mp = gcd(n, 8), halved when
that leaves no data axis on 4 or more devices) and a keypoint-sharded
sample over that mesh. Rank 0 prints `dryrun_multichip(n) ok: ...`.
Outside a process group it starts its n ranks (parallel/distributed.py::
spawn); inside one of n ranks it runs on it.
"""
from __future__ import annotations

import argparse
import math
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def tiny_flagship(device="cpu", seed: int = 0):
    """(config, model) of the flagship cut as kpdiff_tpu's _flagship(tiny=True)."""
    from kpdiff_tpu_torch.config import load_config, model_from_config

    cfg = load_config(ROOT / "configs" / "egnn_40kp.yml")
    cfg["padding"] = {"n_rec": 32, "n_lig": 12, "n_ip": 8}
    cfg["graph"]["n_keypoints"] = 8  # divisible by the dry run's model axis
    cfg["dynamics"].update(n_layers=2, hidden_nf=32)
    cfg["rec_encoder"].update(n_convs=2, hidden_n_node_feat=32, out_n_node_feat=32)
    cfg["diffusion"]["n_timesteps"] = 20
    return cfg, model_from_config(cfg, device=device, seed=seed)


def _run(n_devices: int, device: str) -> str:
    import torch

    from kpdiff_tpu_torch.models.complex import synthetic_batch
    from kpdiff_tpu_torch.parallel import distributed as pdist
    from kpdiff_tpu_torch.parallel.kp_shard import data_shard, shard_encoded
    from kpdiff_tpu_torch.parallel.mesh import make_mesh, replicate_params, shard_batch
    from kpdiff_tpu_torch.training.scheduler import SchedulerConfig
    from kpdiff_tpu_torch.training.trainer import TrainConfig, init_train_state, make_train_step

    mesh = make_mesh(n_devices, device=device)
    _, model = tiny_flagship(mesh.device)
    replicate_params(model, mesh)
    batch = 2 * n_devices
    cpx = synthetic_batch(1, batch=batch, n_rec_pad=32, n_lig_pad=12, n_rec_feat=10, n_lig_feat=10, n_kp=8,
                          kp_feat_dim=model.cfg.rec_nf, n_ip_pad=8, min_rec=16, min_lig=8, device=mesh.device)
    tcfg = TrainConfig(scheduler=SchedulerConfig(base_lr=1e-4, warmup_length=1.0))
    state = init_train_state(model, tcfg)
    gen = torch.Generator(device=mesh.device)

    # data parallel: the batch over every rank
    metrics = make_train_step(tcfg, iters_per_epoch=10, mesh=mesh)(state, shard_batch(cpx, mesh),
                                                                   generator=gen.manual_seed(1))
    with torch.no_grad():
        enc, kk = model.encode(shard_batch(cpx, mesh))
        lig_x = model.sample(enc, kk, generator=gen.manual_seed(2), kp_shard=data_shard(mesh, batch))["lig_x"]

    # dp x mp: the batch on 'data', the keypoints on 'model'
    mp = math.gcd(n_devices, 8)
    if mp == n_devices and n_devices >= 4:
        mp //= 2  # keep a real data axis when there are enough devices
    dp = n_devices // mp
    mesh2 = make_mesh(n_devices, ("data", "model"), (dp, mp), device=device)
    metrics_mp = make_train_step(tcfg, iters_per_epoch=10, mesh=mesh2, kp_axis="model")(
        state, shard_batch(cpx, mesh2), generator=gen.manual_seed(4))
    with torch.no_grad():
        enc, kk = model.encode(cpx)
        enc_s, kk_s, shard = shard_encoded(enc, kk, mesh2, axis="model", batch_axis="data")
        lig_mp = model.sample(enc_s, kk_s, generator=gen.manual_seed(3), kp_shard=shard)["lig_x"]
    for name, x in (("sample", lig_x), ("kp-sharded sample", lig_mp)):
        if not torch.isfinite(x).all():
            raise RuntimeError(f"dryrun_multichip: non-finite {name}")
    line = (f"dryrun_multichip({n_devices}) ok: l2={metrics['l2']:.4f} rec_encoder={metrics['rec_encoder']:.4f} "
            f"sampled={tuple(lig_x.shape)} per rank dp{dp}xmp{mp}: train_l2={metrics_mp['l2']:.4f} "
            f"kp_sharded_sample={tuple(lig_mp.shape)}")
    if pdist.rank() == 0:
        print(line, flush=True)
    return line


def _rank_main(rank: int, n_devices: int, device: str):
    _run(n_devices, device)


def dryrun_multichip(n_devices: int, device: str = "cuda"):
    """One data-parallel train step and sample, one dp x mp train step and a
    kp-sharded sample of the tiny flagship on `n_devices` ranks. Returns the
    printed line when run inside the group (None when it started the ranks)."""
    from kpdiff_tpu_torch.parallel import distributed as pdist

    if pdist.join_launcher_group(device):
        return _run(n_devices, device)
    pdist.spawn(_rank_main, n_devices, args=(n_devices, device), device=device)
    return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)


if __name__ == "__main__":
    main()
