"""The comparison that decides `correct`: what the timed path produced,
judged against the plain float32 reference (reference/), and the same
judgement of the control (the reference in fp8 at the configuration's
bfloat16 sites, reference/precision.py).

Free-running chains cannot be compared: bfloat16 chains on trained weights
are chaotic, and the port's kNN scatter-adds are not deterministic on the
card. So the reference follows the program step by step from the program's
own state, and the start and the end of the path are checked by themselves.
For the pockets checked (`choose_pockets`), the readings are:

  enc_x_rms_A      the encoder's keypoint positions against the reference
                   encoder's on the same pocket: the root mean square of the
                   distances over keypoints and rows, in Å (the largest
                   distance swings with one keypoint's attention);
  enc_h_gap        their features (GVP: and vectors) against the reference
                   encoder's features at the program's keypoint positions
                   (a keypoint's k_closest atoms follow its position, so
                   features at the reference's own positions would swing
                   with which atoms are closest): the largest difference
                   over the reference's largest magnitude;
  kk_mismatch      kk edges the program used that differ from the kk radius
                   graph of its own keypoints (pairs within 1e-4 Å of the
                   cutoff left out): exact, limit 0;
  step_gap         each checked step from the program's state before it,
                   with the program's noise drawn again from its generator's
                   state: the largest, over rows, of the distance between the
                   program's and the reference's next state (positions and
                   features of the ligand) over the size of the reference's
                   own move by the dynamics;
  decode_mismatch  ligands the sampler returned that differ from the
                   reference's finish and decode of the chain's last state
                   (rows missing, an element, or a position off by more than
                   1e-3 Å): exact, limit 0.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

KK_BAND_A = 1e-4  # pairs this close to the kk cutoff may fall either way in f32
DECODE_TOL_A = 1e-3  # positions are the same f32 arithmetic on both sides


def grid(model: Dict[str, Any], sample_steps: int) -> np.ndarray:
    """The descending timestep grid of a chain (as the reference builds it)."""
    T = model["diffusion"].get("n_timesteps", 1000)
    if sample_steps and sample_steps < T:
        return np.unique(np.round(np.linspace(0, T, sample_steps + 1)).astype(np.int32))[::-1].copy()
    return np.arange(T, -1, -1)


def choose_pockets(recs, seed: int, n: int) -> List[int]:
    """The pockets compared: the first with the largest bucket (the longest
    chain) and n - 1 others drawn from the seed."""
    longest = max(range(len(recs)), key=lambda i: (recs[i].pocket["bucket"], -i))
    rest = [i for i in range(len(recs)) if i != longest]
    rng = np.random.default_rng((seed + 2) % 2 ** 63)
    extra = rng.choice(rest, size=min(n - 1, len(rest)), replace=False).tolist() if rest and n > 1 else []
    return sorted([longest, *extra])


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Each reading beside its limit (a reading without a limit is an error)."""
    missing = sorted(set(readings) - set(limits))
    if missing:
        raise KeyError(f"no limit for {missing}")
    return {k: {"value": float(readings[k]), "limit": float(limits[k])} for k in readings}


def _dense_kk(kk, k: int):
    """The program's kk as a dense (B, K_src, K_dst) adjacency."""
    import torch

    if not isinstance(kk, tuple):
        return kk.bool()
    idx, valid = kk  # destination-major (B, K_dst, cap) source indices
    b = idx.shape[0]
    adj = torch.zeros((b, k, k), dtype=torch.bool, device=idx.device)
    dst = torch.arange(k, device=idx.device)[None, :, None].expand_as(idx)
    bi = torch.arange(b, device=idx.device)[:, None, None].expand_as(idx)
    adj[bi[valid], idx[valid], dst[valid]] = True
    return adj


def _row_gap(a, b, scale):
    """max over rows of |a - b| / |scale|, norms over each row's atoms and channels."""
    import torch

    num = torch.sqrt(torch.sum(torch.square((a - b).double()), dim=(1, 2)))
    den = torch.clamp(torch.sqrt(torch.sum(torch.square(scale.double()), dim=(1, 2))), min=1e-12)
    return float(torch.max(num / den))


def _noise(rec, shapes, steps, device):
    """The program's draws of the chain steps `steps`, drawn again from its
    generator's state at the chain's start (each step draws x, then h)."""
    import torch

    gen = torch.Generator(device=device)
    gen.set_state(rec.gen_state)
    out = {}
    for i in range(max(steps) + 1):
        n_x = torch.randn(shapes[0], generator=gen, device=device, dtype=torch.float32)
        n_h = torch.randn(shapes[1], generator=gen, device=device, dtype=torch.float32)
        if i in steps:
            out[i] = (n_x, n_h)
    return out


def generate_readings(spec, recs, steps: List[int], control: bool = False) -> Dict[str, float]:
    """The program's readings over the records `recs` at the chain steps
    `steps`; control=True gives the control's readings on the same inputs
    instead (encoder and steps)."""
    import torch

    from portbench.reference import precision
    from portbench.reference.geometry import masked_com
    from portbench.reference.model import Padding, load_reference, pad_pocket, read_archive

    dev = torch.device(spec.device)
    model = spec.model_config
    precision.reference_matmul_precision()
    archive = read_archive(spec.archive)
    ref = load_reference(model, archive, dev)
    ctl = load_reference(model, archive, dev, control=True) if control else None
    pad = Padding.from_config(model)
    lig_elements = model["dataset"]["lig_elements"]
    g = grid(model, spec.traffic["sample_steps"])
    out = dict(enc_x_rms_A=0.0, enc_h_gap=0.0, step_gap=0.0)
    if not control:
        out.update(kk_mismatch=0, decode_mismatch=0)
    for rec in recs:
        p = rec.pocket
        item = pad_pocket(p["rec_pos"], p["rec_feat"], p["rec_res_idx"], p["interface_points"], p["n_lig"],
                          len(lig_elements), pad, p["bucket"])
        enc_ref = ref.encode([item], dev)
        kp_x = ctl.encode([item], dev).kp_x if control else rec.enc["kp_x"]
        dist2 = torch.sum(torch.square(kp_x.float() - enc_ref.kp_x), dim=-1)
        out["enc_x_rms_A"] = max(out["enc_x_rms_A"], float(torch.sqrt(torch.mean(dist2))))
        # the features at the program's keypoint positions: a keypoint's k_closest atoms follow its position
        at = rec.enc["kp_x"].float()
        items = [item] * at.shape[0]
        feats_ref = ref.encode(items, dev, kp_pos=at)
        feats = ctl.encode(items, dev, kp_pos=at) if control else None
        kp_h = feats.kp_h if control else rec.enc["kp_h"]
        kp_v = feats.kp_v if control else rec.enc["kp_v"]
        h_gap = float(torch.max(torch.abs(kp_h.float() - feats_ref.kp_h)) / torch.max(torch.abs(feats_ref.kp_h)))
        if kp_v is not None:
            h_gap = max(h_gap, float(torch.max(torch.abs(kp_v.float() - feats_ref.kp_v))
                                     / torch.max(torch.abs(feats_ref.kp_v))))
        out["enc_h_gap"] = max(out["enc_h_gap"], h_gap)
        del feats_ref, feats

        # the chain runs on the program's keypoints; the reference works out their kk edges again
        kp_x, kp_mask = rec.enc["kp_x"].float(), rec.enc["kp_mask"]
        adj_ref = ref.kk_adjacency(kp_x, kp_mask)
        if not control:
            d = torch.cdist(kp_x.double(), kp_x.double())
            band = torch.abs(d - model["graph"]["graph_cutoffs"]["kk"]) < KK_BAND_A
            out["kk_mismatch"] += int(((_dense_kk(rec.kk, kp_x.shape[1]) != adj_ref) & ~band).sum())

        b, bucket, n_lig = kp_x.shape[0], p["bucket"], p["n_lig"]
        lig_mask = (torch.arange(bucket, device=dev) < n_lig)[None].expand(b, bucket)
        static = dict(lig_mask=lig_mask, kp_h=rec.enc["kp_h"].float(), kp_mask=kp_mask,
                      kp_v=None if rec.enc["kp_v"] is None else rec.enc["kp_v"].float(), kk=adj_ref)
        start = rec.states[-1]
        noise = _noise(rec, (tuple(start["lig_x"].shape), tuple(start["lig_h"].shape)), steps, dev)
        for c in steps:
            before = rec.states[c - 1] if c > 0 else start
            state = {k: v.float() for k, v in before.items()}
            new_ref, moved = ref.reverse_step(state, static, int(g[c]), int(g[c + 1]), *noise[c],
                                              eta=spec.traffic["eta"])
            if control:
                new_cmp, _ = ctl.reverse_step(state, static, int(g[c]), int(g[c + 1]), *noise[c],
                                              eta=spec.traffic["eta"])
            else:
                new_cmp = rec.states[c]
            a = torch.cat([new_cmp["lig_x"].float(), new_cmp["lig_h"].float()], dim=-1)
            r = torch.cat([new_ref["lig_x"], new_ref["lig_h"]], dim=-1)
            out["step_gap"] = max(out["step_gap"], _row_gap(a, r, moved))

        if not control:
            last = {k: v.float() for k, v in rec.states[rec.steps - 1].items()}
            init_kp_com = masked_com(kp_x, kp_mask)
            lig_x, lig_h = ref.finish(last, lig_mask, kp_mask, init_kp_com)
            n_mols = spec.traffic["n_mols"]
            decoded = rec.decoded or []
            mismatch = max(n_mols - len(decoded), 0)
            lig_x, lig_h = lig_x.cpu().numpy(), lig_h.cpu().numpy()
            for row, (coords, elements) in enumerate(decoded[:n_mols]):
                ref_x = lig_x[row, :n_lig]
                ref_el = [lig_elements[j] for j in lig_h[row, :n_lig, :len(lig_elements)].argmax(1)]
                if (coords.shape != ref_x.shape or list(elements) != ref_el
                        or float(np.max(np.abs(coords - ref_x))) > DECODE_TOL_A):
                    mismatch += 1
            out["decode_mismatch"] += mismatch
        del enc_ref
    return out


# ------------------------------------------------------------------ train
#
# For a train cell the reference follows the program's first three
# optimizer steps from the same weights, on the batches it works out again
# from the raw complexes and the loader's seed, with the same (t, eps):
#
#   loss_gap    each step's loss (l2 + w_rec * rec_encoder) against the
#               reference's: the largest relative difference;
#   grad_gap    the first step's gradient as the optimizer got it (clipped,
#               plus the coupled decay), worked out from Adam's first moment
#               after one step: per leaf, the difference of the two norms
#               over the larger of the reference's norm of that leaf and of
#               the median leaf; the median over the leaves (the worst leaf
#               is a small one, a gate's or a bias's, whose gradient is a
#               sum over every pair that cancels to a few percent of its
#               terms, and reads 0.15-1.05 in bf16 and as much in fp8);
#   update_gap  the parameters' change over the three steps, as grad_gap.
# Leaves whose reference gradient is under a thousandth of the median
# leaf's are left out of grad_gap and update_gap: they move by round-off.

def _leaf_gaps(prog: Dict[str, Any], ref: Dict[str, Any], keep) -> Dict[str, tuple]:
    """{leaf: (gap, program norm, reference norm)} as the readings define the gap."""
    import torch

    norms_ref = {n: float(torch.linalg.vector_norm(ref[n].double())) for n in keep}
    median = float(np.median(list(norms_ref.values())))
    out = {}
    for n in keep:
        norm = float(torch.linalg.vector_norm(prog[n].double()))
        out[n] = (abs(norm - norms_ref[n]) / max(norms_ref[n], median, 1e-30), norm, norms_ref[n])
    return out


def _worst(gaps: Dict[str, tuple]) -> float:
    return max(g[0] for g in gaps.values())


def _median(gaps: Dict[str, tuple]) -> float:
    return float(np.median([g[0] for g in gaps.values()]))


def train_readings(spec, record: Dict[str, Any], control: bool = False,
                   detail: Optional[Dict[str, Any]] = None) -> Dict[str, float]:
    """The program's readings (control=True: the control's, against the same
    reference) over the recorded first steps of a train run; `detail`, if
    given, gets every step's losses and the leaves that read worst."""
    import torch

    from portbench.reference import precision
    from portbench.reference.model import Padding, load_reference, read_archive
    from portbench.reference.train import ADAM_BETAS, Trainer, collate, epoch_batches

    dev = torch.device(spec.device)
    model_cfg = spec.model_config
    precision.reference_matmul_precision()
    archive = read_archive(spec.archive)
    pad = Padding.from_config(model_cfg)

    def follow(ctl: bool):
        ref = load_reference(model_cfg, archive, dev, control=ctl)
        for p in ref.parameters():
            p.requires_grad_(True)
        trainer = Trainer(ref, record["iters_per_epoch"])
        rng = np.random.default_rng(record["loader_seed"])
        batches = epoch_batches(record["complexes"], rng, pad, record["buckets"], record["batch_size"])
        losses = []
        for step in record["steps"]:
            items = next(batches, None)
            if items is None:
                batches = epoch_batches(record["complexes"], rng, pad, record["buckets"], record["batch_size"])
                items = next(batches)
            losses.append(trainer.step(collate(items, ref, dev), step["t_eps"])["total"])
        return ref, trainer, losses

    ref, trainer, ref_losses = follow(False)
    p0 = {n: torch.from_numpy(np.array(a, np.float32)).to(dev) for n, a in archive.items()}
    ref_delta = {n: p.detach() - p0[n] for n, p in ref.named_parameters()}
    g_ref = trainer.first_grad
    gnorm = {n: float(torch.linalg.vector_norm(g.double())) for n, g in g_ref.items()}
    median = float(np.median(list(gnorm.values())))
    keep = [n for n, v in gnorm.items() if v >= 1e-3 * median]
    if control:
        ctl, ctl_trainer, cmp_losses = follow(True)
        cmp_grad = ctl_trainer.first_grad
        cmp_delta = {n: p.detach() - p0[n] for n, p in ctl.named_parameters()}
    else:
        cmp_losses = [s["metrics"]["total"] for s in record["steps"]]
        cmp_grad = {n: m / (1.0 - ADAM_BETAS[0]) for n, m in record["first_moments"].items()}
        cmp_delta = {n: p - p0[n] for n, p in record["final_params"].items()}
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(cmp_losses, ref_losses))
    grad, update = _leaf_gaps(cmp_grad, g_ref, keep), _leaf_gaps(cmp_delta, ref_delta, keep)
    if detail is not None:
        detail.update(losses=cmp_losses, ref_losses=ref_losses, leaves=len(gnorm), kept=len(keep),
                      grad_worst=_worst(grad), update_worst=_worst(update),
                      grad=sorted(((n, *g) for n, g in grad.items()), key=lambda r: -r[1])[:6],
                      update=sorted(((n, *g) for n, g in update.items()), key=lambda r: -r[1])[:6])
    return dict(loss_gap=loss_gap, grad_gap=_median(grad), update_gap=_median(update))
