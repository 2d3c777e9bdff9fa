"""The `generate` kind: pockets sampled one after another through
`KeypointSampler.sample_for_arrays`, as the evaluation CLI samples them.

Traffic (traffic/<mix>.json): `pockets` pockets from the frozen molgen copy,
each with its reference ligand; the pockets' buckets follow a fixed smooth
weighted round-robin order of `bucket_weights`, the k-th pocket of a bucket
has the k-th reference size of that bucket's list in `ligand_atoms`, and
the pockets are drawn from the traffic's own `pool_seed`: every run samples
the same pockets in the same order. The work follows the pockets (the edge
kernel's active pairs follow the sizes; `compact_kk` turns a pocket's kk
into a neighbor list or keeps it dense by its keypoints' geometry), so
pockets drawn from the run's seed changed it; the run's seed draws the
chain's noise and what the comparison checks. A pocket asks for `n_mols`
ligands at the reference size (`ligand_size` "ref"), its centre of mass as
`init_com`.

Set-up builds the sampler (`KeypointSampler.from_params`), then warms every
shape the window uses: each pocket once with a one-step chain (so the
grow-only kk cap reaches the sequence's largest), then one one-step chain
per bucket at that cap (the graph every later chain of the bucket replays;
one graph serves every chain length). The window starts pockets, one at a
time, until `--seconds` have passed, and counts every pocket that began in
it. Afterwards the profiled pocket (--trace 1), the device's peak memory,
and the comparison with the reference (compare.py).

The benchmark's wrappers on the sampler's model (encode, compact_kk,
sample, the chain runner) and on `serve.decode_ligands` time the spans and
keep what the comparison judges: the encoder's keypoints, the kk edges, the
sampling generator's state at the chain's start, the chain's state after
the steps checked, and the decoded ligands.
"""
from __future__ import annotations

import gc
import sys
import time
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

from portbench import compare, flops, harness, trace
from portbench.traffic.molgen import complex_of_size

SEED_MOD = 2 ** 63


def bucket_order(weights: List[float], n: int) -> List[int]:
    """Indices of `n` picks by smooth weighted round-robin: every prefix
    follows the weights as closely as whole picks can."""
    current = [0.0] * len(weights)
    total = sum(weights)
    out = []
    for _ in range(n):
        current = [c + w for c, w in zip(current, weights)]
        i = max(range(len(weights)), key=lambda j: current[j])
        current[i] -= total
        out.append(i)
    return out


def make_pockets(traffic: Dict[str, Any], model: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The cell's pocket sequence (the same for every run)."""
    rng = np.random.default_rng(traffic["pool_seed"])
    buckets = traffic["buckets"]
    lig_elements = model["dataset"]["lig_elements"]
    n_rec_feat = len(model["dataset"]["rec_elements"])
    out, taken = [], {}
    for i in bucket_order(traffic["bucket_weights"], traffic["pockets"]):
        sizes = traffic["ligand_atoms"][str(buckets[i])]
        n = sizes[taken.get(i, 0) % len(sizes)]
        taken[i] = taken.get(i, 0) + 1
        for _ in range(1000):  # a tree that saturates early comes out smaller: draw again
            c = complex_of_size(rng, n, lig_elements, n_rec_feat, tuple(traffic["rec_atoms"]))
            if len(c["lig_pos"]) == n:
                break
        else:
            raise RuntimeError(f"no molecule of {n} atoms in 1000 draws")
        hi = buckets[i]
        c.update(n_lig=len(c["lig_pos"]), bucket=hi, init_com=c["lig_pos"].mean(0))
        out.append(c)
    return out


def check_steps(n_steps: int, seed: int, n: int) -> List[int]:
    """The chain steps whose outputs are compared: the first, the last and
    n - 2 drawn from the seed between them."""
    rng = np.random.default_rng((seed + 1) % SEED_MOD)
    inner = rng.choice(np.arange(1, n_steps - 1), size=max(n - 2, 0), replace=False) if n_steps > 2 else []
    return sorted({0, n_steps - 1, *(int(i) for i in inner)})


class Clock:
    """A point on the device's timeline (CUDA events) or the host clock (CPU)."""

    def __init__(self, cuda: bool):
        import torch

        self.cuda = cuda
        if cuda:
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record()
        else:
            self.t = time.perf_counter()

    def ms_until(self, other: "Clock") -> float:
        return self.event.elapsed_time(other.event) if self.cuda else (other.t - self.t) * 1e3


class Record:
    """What one pocket's run left for the metrics and the comparison."""

    def __init__(self, index: int, pocket: Dict[str, Any]):
        self.index, self.pocket = index, pocket
        self.enc = self.kk = self.gen_state = self.decoded = None
        self.states: Dict[int, Dict[str, Any]] = {}
        self.lig_x_steps: List[Any] = []
        self.clocks: Dict[str, Clock] = {}
        self.steps = 0
        self.wall_s = 0.0
        self.request: Dict[str, Any] = {}


class Recorder:
    """The benchmark's wrappers on one sampler (see the module docstring)."""

    def __init__(self, sampler, keep_steps, spans: trace.Spans, cuda: bool):
        import kpdiff_tpu_torch.serve as serve_mod
        from kpdiff_tpu_torch.models.chain_graph import STATE

        self.rec = None
        self.keep_steps = set(keep_steps)
        self.every_step = False
        self.spans = spans
        model = sampler.model
        enc0, kk0, sample0, decode0 = model.encode, model.compact_kk, model.sample, serve_mod.decode_ligands
        runner = model.chain_graphs
        run0 = runner.run
        self._undo = [(model, "encode", None), (model, "compact_kk", None), (model, "sample", None),
                      (runner, "run", None), (serve_mod, "decode_ligands", decode0)]

        def encode(cpx, *a, **k):
            r = self.rec
            if r is not None:
                spans.begin("encode")
                r.clocks["encode0"] = Clock(cuda)
            out = enc0(cpx, *a, **k)
            if r is not None:
                c = out[0]
                r.enc = {k_: (None if getattr(c, k_) is None else getattr(c, k_).clone())
                         for k_ in ("kp_x", "kp_h", "kp_v", "kp_mask", "lig_mask")}
            return out

        def compact_kk(cpx, kk, *a, **k):
            out = kk0(cpx, kk, *a, **k)
            r = self.rec
            if r is not None:
                r.kk = tuple(t.clone() for t in out) if isinstance(out, tuple) else out.clone()
                r.clocks["encode1"] = Clock(cuda)
                spans.end("encode")
            return out

        def sample(*a, **k):
            r = self.rec
            if r is not None:
                spans.begin("chain")
                r.clocks["chain0"] = Clock(cuda)
            if not cuda:
                k["cuda_graph"] = True  # the CPU rehearsal drives the graph runner with its host stand-in
            out = sample0(*a, **k)
            if r is not None:
                r.clocks["chain1"] = Clock(cuda)
                spans.end("chain")
            return out

        def run(inputs, step, n_steps, *, key, params_key, generator=None, after_step=None):
            r = self.rec
            if r is None:
                return run0(inputs, step, n_steps, key=key, params_key=params_key, generator=generator,
                            after_step=after_step)
            r.steps = n_steps
            r.gen_state = None if generator is None else generator.get_state()
            r.states[-1] = {k_: inputs[k_].clone() for k_ in STATE}
            if self.every_step:
                r.lig_x_steps = [inputs["lig_x"].clone()]

            def hook(i, static):
                if after_step is not None:
                    after_step(i, static)
                if i in self.keep_steps or i == n_steps - 1:
                    r.states[i] = {k_: static[k_].clone() for k_ in STATE}
                if self.every_step and i < n_steps - 1:
                    r.lig_x_steps.append(static["lig_x"].clone())

            return run0(inputs, step, n_steps, key=key, params_key=params_key, generator=generator, after_step=hook)

        def decode(out, lig_elements):
            spans.begin("decode")
            ligands = decode0(out, lig_elements)
            spans.end("decode")
            spans.begin("build")
            if self.rec is not None:
                self.rec.decoded = ligands
            return ligands

        model.encode, model.compact_kk, model.sample, runner.run = encode, compact_kk, sample, run
        serve_mod.decode_ligands = decode

    def close(self):
        for obj, name, value in self._undo:
            if value is None:
                obj.__dict__.pop(name, None)
            else:
                setattr(obj, name, value)


def _call(sampler, p, n_mols: int, ligand_size):
    return sampler.sample_for_arrays(
        rec_pos=p["rec_pos"], rec_feat=p["rec_feat"], rec_res_idx=p["rec_res_idx"],
        interface_points=p["interface_points"], init_com=p["init_com"], ref_n_atoms=p["n_lig"],
        n_mols=n_mols, ligand_size=ligand_size)


def _pocket(sampler, recorder: Recorder, index: int, p, traffic, record: bool) -> Record:
    rec = Record(index, p)
    recorder.rec = rec if record else None
    recorder.spans.begin("pocket")
    t0 = time.perf_counter()
    _call(sampler, p, traffic["n_mols"], traffic["ligand_size"])
    rec.wall_s = time.perf_counter() - t0
    recorder.spans.end("build")
    recorder.spans.end("pocket")
    recorder.rec = None
    rec.request = dict(sampler.last_request)
    return rec


def program_config_file(spec: harness.Spec) -> Path:
    """The configuration as the program reads it (its YAML subset), at a fixed
    path inside the checkout."""
    from kpdiff_tpu_torch.config import dump_yaml

    path = harness.CACHE_DIR / "configs" / f"{spec.config_name}.yml"
    path.parent.mkdir(parents=True, exist_ok=True)
    text = dump_yaml(spec.model_config)
    if not path.exists() or path.read_text() != text:
        path.write_text(text)
    return path


def _edge_counts(model: Dict[str, Any], rec: Record, lig_x, bucket: int, n_lig: int):
    """Active pairs of one dynamics call: ll on `lig_x`, kl (and lk) pairs, kk."""
    import torch

    from portbench.reference.neighbors import dense_radius_adjacency

    arch_gvp = model["diffusion"]["architecture"] == "gvp"
    dyn = model["dynamics_gvp" if arch_gvp else "dynamics"]
    b = lig_x.shape[0]
    mask = (torch.arange(bucket, device=lig_x.device) < n_lig)[None].expand(b, bucket)
    ll = dense_radius_adjacency(lig_x, mask, lig_x, mask, model["graph"]["graph_cutoffs"]["ll"], exclude_self=True)
    n_kp = int(rec.enc["kp_mask"].sum())
    kl = n_kp * min(dyn.get("kl_k", 0), n_lig)
    kk = rec.kk[1] if isinstance(rec.kk, tuple) else rec.kk
    return dict(n_lig=b * n_lig, n_kp=n_kp, ll_pairs=int(ll.sum()), kl_pairs=kl, kk_pairs=int(kk.sum()))


def _layer_context(spec, recs: List[Record], profiled, traced_rec, cuda: bool, device_name: str):
    """What the per-layer readers read: pockets' spans and parts, model
    operations, the profile."""
    model = spec.model_config
    peak = flops.peaks(device_name) if cuda else None
    pockets = []
    for r in recs:
        req = r.request
        row = dict(wall_s=r.wall_s, host_s=req["front_end_s"] + req["copy_s"] + req["build_s"],
                   encode_ms=r.clocks["encode0"].ms_until(r.clocks["encode1"]),
                   chain_ms=r.clocks["chain0"].ms_until(r.clocks["chain1"]), steps=r.steps,
                   bucket=r.pocket["bucket"], kk=req["chunks"][0]["kk"])
        if r.lig_x_steps:
            row["model_flops"] = sum(
                flops.step_flops(model, **_edge_counts(model, r, x, r.pocket["bucket"], r.pocket["n_lig"]))
                for x in r.lig_x_steps)
        pockets.append(row)
    ctx = dict(workload=spec.workload, model=model, pockets=pockets, peak=peak, profile=None)
    if profiled is not None and traced_rec is not None:
        prof = dict(profiled)
        if peak is not None and model["diffusion"]["architecture"] == "egnn":
            h = model["dynamics"].get("hidden_nf", 256) + 1
            n_layers = model["dynamics"].get("n_layers", 6)
            dense_kk = traced_rec.request["chunks"][0]["kk"] == "dense"
            bound = 0.0
            b, k = traced_rec.enc["kp_x"].shape[:2]
            bucket = traced_rec.pocket["bucket"]
            for x in traced_rec.lig_x_steps:
                c = _edge_counts(model, traced_rec, x, bucket, traced_rec.pocket["n_lig"])
                per = flops.edge_kernel_bound_s(b, bucket, bucket, h, c["ll_pairs"], peak)
                if dense_kk:
                    per += flops.edge_kernel_bound_s(b, k, k, h, c["kk_pairs"], peak)
                bound += n_layers * per
            prof["edge_bound_s"] = bound
        ctx["profile"] = prof
    return ctx


def run(spec: harness.Spec) -> Dict[str, Any]:
    """One run of the cell: the result line's fields."""
    return execute(spec)[0]


def execute(spec: harness.Spec):
    """(the result's fields, the records of the pockets compared, the steps compared)."""
    import torch

    from kpdiff_tpu_torch.serve import KeypointSampler

    cuda = spec.device == "cuda"
    traffic, model_cfg = spec.traffic, spec.model_config
    pockets = make_pockets(traffic, model_cfg)
    sampler = KeypointSampler.from_params(
        program_config_file(spec), spec.archive, batch_size=traffic["batch_size"], device=spec.device,
        seed=spec.seed % SEED_MOD, sample_steps=traffic["sample_steps"], eta=traffic["eta"],
        lig_buckets=traffic["buckets"])
    if not cuda:
        from kpdiff_tpu_torch.models.chain_graph import ChainGraphs, host_capture

        sampler.model.chain_graphs = ChainGraphs(capture=host_capture)
    n_steps = len(compare.grid(model_cfg, traffic["sample_steps"])) - 1
    keep = check_steps(n_steps, spec.seed, spec.cell["check"]["steps"])
    spans = trace.Spans()
    recorder = Recorder(sampler, [s for c in keep for s in (c - 1, c) if s >= 0], spans, cuda)

    # set-up: every shape the window uses
    sampler.sample_steps = 1
    for i, p in enumerate(pockets):
        _pocket(sampler, recorder, i, p, dict(traffic, n_mols=1), record=False)
    seen = set()
    for i, p in enumerate(pockets):
        if p["bucket"] not in seen:
            seen.add(p["bucket"])
            _pocket(sampler, recorder, i, p, dict(traffic, n_mols=1), record=False)
    sampler.sample_steps = traffic["sample_steps"]
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - spec.t_process
    phases = {"setup": setup_s}

    # the window
    recorder.every_step = spec.trace
    recs: List[Record] = []
    t0 = time.perf_counter()
    while not recs or time.perf_counter() - t0 < spec.seconds:
        i = len(recs)
        recs.append(_pocket(sampler, recorder, i, pockets[i % len(pockets)], traffic, record=True))
    t1 = time.perf_counter()
    phases["window"] = t1 - t0
    attempted = traffic["n_mols"] * len(recs)
    decoded = sum(len(r.decoded or ()) for r in recs)
    metrics = {"ligands_per_s": {"value": decoded / (t1 - t0), "unit": "ligands/s"},
               "setup_s": {"value": setup_s, "unit": "s"}}

    profiled = traced = None
    if spec.trace:
        recorder.every_step = True
        box = {}

        def traced_pocket():
            box["rec"] = _pocket(sampler, recorder, len(recs), pockets[0], traffic, record=True)

        prof = trace.profile(traced_pocket, spans, spec.device)
        traced = box["rec"]
        profiled = trace.reduce_profile(prof, "pocket")
        del prof
    device_name = torch.cuda.get_device_name(0) if cuda else "cpu"
    device = {"platform": "gpu" if cuda else "cpu", "kind": device_name, "count": 1,
              "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if cuda else 0}
    breakdown = None
    if spec.trace:
        ctx = _layer_context(spec, recs, profiled, traced, cuda, device_name)
        metrics = harness.read_per_layer(spec, ctx)
        if profiled is not None:
            device.update(busy_s=profiled["busy_s"], window_s=profiled["window_s"])
            breakdown = {"device_ops": profiled["device_ops"], "idle_gaps": profiled["idle_gaps"]}
    recorder.close()
    phases["trace"] = time.perf_counter() - t1

    # the program's state freed, then the comparison
    del sampler
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checked = [recs[i] for i in compare.choose_pockets(recs, spec.seed, spec.cell["check"]["pockets"])]
    t2 = time.perf_counter()
    readings = compare.generate_readings(spec, checked, keep)
    phases["compare"] = time.perf_counter() - t2
    print("portbench: " + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items())
          + f"; {len(recs)} pockets, kk {sorted({r.request['chunks'][0]['kk'] for r in recs})}", file=sys.stderr)
    checks = compare.judge(readings, spec.cell["limits"])
    failed = attempted - decoded
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    return (dict(correct=correct, attempted=attempted, failed=failed, metrics=metrics, device=device,
                 checks=checks, breakdown=breakdown), checked, keep)
