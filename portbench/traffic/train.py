"""The `train` kind: optimizer steps of `make_train_step` over
`PaddedLoader.epoch()` through `prefetch`, as the train CLI drives them.

Data (traffic/<mix>.json): `complexes` molecule-like ligands in their
pockets from the frozen molgen copy (ligand sizes drawn in `lig_atoms`,
pockets in `rec_atoms`), made from the traffic's `data_seed`: one dataset
for every run, as a training run has; the port's PaddedLoader (drop_last,
the buckets `resolve_lig_buckets` gives, shuffled from the run's seed) and
`prefetch`. Every step passes the timestep and noise through the step's
seam (`t_eps`), drawn by the benchmark on the device from the run's seed,
so that the reference takes the same draws.

Set-up builds the model from the trained weights, the optimizer state and
the step, and drives it through the whole first epoch (every bucket the
data yields, so every shape's graph is captured): its first three steps are
the ones the reference follows (their losses, the Adam state after the
first, the parameters after the third). The window then goes on with the
same step object and feed. Afterwards the profiled steps (--trace 1), the
peak memory, and the comparison (compare.train_readings).
"""
from __future__ import annotations

import gc
import sys
import time
from typing import Any, Dict, List

import numpy as np

from portbench import compare, flops, harness, trace
from portbench.traffic.molgen import complex_of_size

SEED_MOD = 2 ** 63


def make_complexes(traffic: Dict[str, Any], model: Dict[str, Any]) -> List[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(traffic["data_seed"])
    lig_elements = model["dataset"]["lig_elements"]
    n_rec_feat = len(model["dataset"]["rec_elements"])
    lo, hi = traffic["lig_atoms"]
    return [complex_of_size(rng, int(rng.integers(lo, hi + 1)), lig_elements, n_rec_feat, tuple(traffic["rec_atoms"]))
            for _ in range(traffic["complexes"])]


def dataset(complexes):
    """The complexes as the port's ComplexDataset (concatenated arrays and segments)."""
    from kpdiff_tpu_torch.data.dataset import ComplexDataset

    def seg(key):
        return np.concatenate([[0], np.cumsum([len(c[key]) for c in complexes])])

    return ComplexDataset(
        lig_pos=np.concatenate([c["lig_pos"] for c in complexes]),
        lig_feat=np.concatenate([c["lig_feat"] for c in complexes]),
        rec_pos=np.concatenate([c["rec_pos"] for c in complexes]),
        rec_feat=np.concatenate([c["rec_feat"] for c in complexes]),
        rec_res_idx=np.concatenate([c["rec_res_idx"] for c in complexes]),
        interface_points=np.concatenate([c["interface_points"] for c in complexes]),
        rec_segments=seg("rec_pos"), lig_segments=seg("lig_pos"), ip_segments=seg("interface_points"))


class Feed:
    """Batches of successive epochs through prefetch; the host seconds the
    loop waited for each."""

    def __init__(self, loader, depth: int, spans: trace.Spans):
        from kpdiff_tpu_torch.data.prefetch import prefetch

        self._prefetch, self.loader, self.depth, self.spans = prefetch, loader, depth, spans
        self.epoch = 0
        self._it = None
        self.wait_s = 0.0

    def next(self):
        self.spans.begin("data_wait")
        t0 = time.perf_counter()
        while True:
            if self._it is None:
                self._it = self._prefetch(self.loader.epoch(), depth=self.depth)
                self.epoch += 1
            batch = next(self._it, None)
            if batch is not None:
                break
            self._it = None
        self.wait_s += time.perf_counter() - t0
        self.spans.end("data_wait")
        return self.epoch, batch


def _t_eps(gen, batch, n_timesteps: int, device):
    """The step's timestep and noise, drawn on the device from the benchmark's generator."""
    import torch

    b, n = batch.lig_x.shape[:2]
    f = batch.lig_h.shape[-1]
    return (torch.randint(0, n_timesteps, (b,), generator=gen, device=device),
            torch.randn((b, n, 3), generator=gen, device=device),
            torch.randn((b, n, f), generator=gen, device=device))


def execute(spec: harness.Spec):
    """(the result's fields, what the comparison reads, None)."""
    import torch

    from kpdiff_tpu_torch.cli.train import train_config_from
    from kpdiff_tpu_torch.config import PaddingConfig, model_from_config
    from kpdiff_tpu_torch.data.dataset import PaddedLoader, resolve_lig_buckets
    from kpdiff_tpu_torch.training.trainer import init_train_state, make_train_step
    from kpdiff_tpu_torch.utils.params_io import load_params, read_keystr_npz

    cuda = spec.device == "cuda"
    dev = torch.device(spec.device)
    traffic, cfg = spec.traffic, spec.model_config
    complexes = make_complexes(traffic, cfg)
    ds = dataset(complexes)
    model = model_from_config(cfg, device=spec.device, seed=spec.seed % SEED_MOD)
    load_params(model, read_keystr_npz(spec.archive))
    model.train()
    pad = PaddingConfig.from_config(cfg)
    buckets = resolve_lig_buckets(cfg, ds, pad.n_lig)
    batch_size = cfg["training"]["batch_size"]
    loader = PaddedLoader(ds, pad, batch_size=batch_size, n_kp=pad.n_kp, kp_feat_dim=model.cfg.rec_nf,
                          seed=spec.seed % SEED_MOD, drop_last=True, lig_buckets=buckets, kp_vec_dim=model.kp_vec_dim)
    ipe = max(len(ds) // batch_size, 1)
    tcfg = train_config_from(cfg)
    state = init_train_state(model, tcfg)
    step_fn = make_train_step(tcfg, ipe)
    gen = torch.Generator(device=dev).manual_seed(spec.seed % SEED_MOD)
    step_gen = torch.Generator(device=dev).manual_seed((spec.seed + 1) % SEED_MOD)
    spans = trace.Spans()
    feed = Feed(loader, traffic["prefetch_depth"], spans)
    n_ref = traffic["reference_steps"]
    T = cfg["diffusion"].get("n_timesteps", 1000)

    def one_step(batch):
        t_eps = _t_eps(gen, batch, T, dev)
        spans.begin("step")
        metrics = step_fn(state, batch.to(dev, non_blocking=True), generator=step_gen, t_eps=t_eps)
        spans.end("step")
        return metrics, t_eps

    # set-up: the first epoch, whole; its first steps recorded for the reference
    seen: Dict[int, Dict[str, Any]] = {}
    ref_steps = []
    first_moments = final_params = None
    params = dict(model.named_parameters())
    while True:
        epoch, batch = feed.next()
        if epoch > 1 and len(ref_steps) >= n_ref:
            pending = batch
            break
        metrics, t_eps = one_step(batch)
        seen.setdefault(int(batch.lig_x.shape[1]), {})
        if len(ref_steps) < n_ref:
            ref_steps.append(dict(t_eps=tuple(t.clone() for t in t_eps), metrics=metrics,
                                  lig_mask=batch.lig_mask.clone()))
            if len(ref_steps) == 1:
                opt_state = state.optimizer.state
                first_moments = {n: opt_state[p]["exp_avg"].detach().clone() for n, p in params.items()}
            if len(ref_steps) == n_ref:
                final_params = {n: p.detach().clone() for n, p in params.items()}
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - spec.t_process
    phases = {"setup": setup_s}

    # the window
    feed.wait_s = 0.0
    n_steps = 0
    t0 = time.perf_counter()
    batch = pending
    while True:
        metrics, _ = one_step(batch)
        n_steps += 1
        if time.perf_counter() - t0 >= spec.seconds:
            break
        _, batch = feed.next()
    t1 = time.perf_counter()
    phases["window"] = t1 - t0
    wait_s = feed.wait_s
    metrics_out = {"train_ms_per_step": {"value": 1e3 * (t1 - t0) / n_steps, "unit": "ms/step"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    device_name = torch.cuda.get_device_name(0) if cuda else "cpu"
    device = {"platform": "gpu" if cuda else "cpu", "kind": device_name, "count": 1,
              "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if cuda else 0}
    breakdown = None
    if spec.trace:
        k = traffic["profiled_steps"]
        shapes = []

        def steps():
            spans.begin("steps")
            for _ in range(k):
                _, b = feed.next()
                one_step(b)
                shapes.append(b)
            spans.end("steps")

        prof = trace.profile(steps, spans, spec.device)
        profiled = trace.reduce_profile(prof, "steps")
        del prof
        ctx = dict(workload=spec.workload, model=cfg, peak=flops.peaks(device_name) if cuda else None,
                   steps=n_steps, window_s=t1 - t0, data_wait_s=wait_s, profile=profiled, profiled_steps=k,
                   forward_flops=[_forward_flops(cfg, b, model) for b in shapes])
        metrics_out = harness.read_per_layer(spec, ctx)
        if profiled is not None:
            device.update(busy_s=profiled["busy_s"], window_s=profiled["window_s"])
            breakdown = {"device_ops": profiled["device_ops"], "idle_gaps": profiled["idle_gaps"]}
    phases["trace"] = time.perf_counter() - t1

    del state, step_fn, model, params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t2 = time.perf_counter()
    record = dict(complexes=complexes, buckets=buckets, batch_size=batch_size, iters_per_epoch=ipe,
                  loader_seed=spec.seed % SEED_MOD, steps=ref_steps, first_moments=first_moments,
                  final_params=final_params)
    readings = compare.train_readings(spec, record)
    phases["compare"] = time.perf_counter() - t2
    print("portbench: " + ", ".join(f"{k_} {v:.3f} s" for k_, v in phases.items())
          + f"; {n_steps} steps, buckets {sorted(seen)}", file=sys.stderr)
    checks = compare.judge(readings, spec.cell["limits"])
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return (dict(correct=correct, attempted=n_steps, failed=0, metrics=metrics_out, device=device,
                 checks=checks, breakdown=breakdown), record, None)


def run(spec: harness.Spec) -> Dict[str, Any]:
    return execute(spec)[0]


def _forward_flops(model_cfg, batch, model) -> int:
    """Model operations of the dynamics' forward on a batch, its ligand
    edges counted on the clean positions (the noised ones are the step's own)."""
    import torch

    from portbench.reference.neighbors import dense_radius_adjacency

    lig_x, lig_mask = batch.lig_x, batch.lig_mask
    b, k = lig_x.shape[0], model_cfg["graph"]["n_keypoints"]
    ll = dense_radius_adjacency(lig_x, lig_mask, lig_x, lig_mask, model_cfg["graph"]["graph_cutoffs"]["ll"],
                                exclude_self=True)
    n_lig = int(lig_mask.sum())
    kl_k = model_cfg["dynamics"].get("kl_k", 0)
    per_row = lig_mask.sum(dim=1).clamp(max=kl_k)
    return flops.step_flops(model_cfg, n_lig=n_lig, n_kp=b * k, ll_pairs=int(ll.sum()),
                            kl_pairs=int(per_row.sum()) * k, kk_pairs=0)
