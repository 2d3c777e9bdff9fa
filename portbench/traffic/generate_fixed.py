"""The `generate_fixed` kind: the `generate` kind (traffic/generate.py, whose
pockets, set-up, window, recorder and per-layer context it runs as they
are) on an EGNN configuration with a fixed receptor encoder, whose
keypoints are the pocket atoms (`egnn_all_atom`, configs/egnn_all_atom.json).

The cell egnn_all_atom.generate runs it (traffic/eval_aa_b32_k250.json).
It is a kind of its own because compare.generate_readings,
reference/model.py and flops.py cover learned encoders alone. Once
generate.execute takes the readings and the operation count as arguments,
this module's `readings` and flops_fixed.step_flops go there and
`yardstick()` goes away. tests/test_portbench_files.py's table of limits
by kind knows `generate` and `train` alone; tests/test_portbench_fixed.py
checks this kind's cells against its readings instead.

Traffic (traffic/<mix>.json): the `generate` kind's parameters, with
`kind: generate_fixed`. The pockets are drawn as there; each chunk's
keypoint capacity is the receptor's padding, and `compact_kk` turns the
block layout of the kk edges into the exact rr radius graph as a
destination-major neighbor list.

Limits are set as for the other cells, with calibrate.py run under this
kind's yardstick:

    python3 -m portbench.traffic.generate_fixed --workload egnn_all_atom.generate --seeds <n> ... --control 3

What this kind changes, while its run lasts (`yardstick()`):
  * the comparison that decides `correct` is `readings` below, against the
    fixed-encoder reference (reference/model_fixed.py), in place of
    compare.generate_readings, whose reference covers learned encoders;
  * model operations are flops_fixed.step_flops (the keypoint encoder on
    the receptor's one-hot width), in place of flops.step_flops.

The readings are compare.py's, with these differences:
  enc_x_rms_A, enc_h_gap  the program's keypoints of every row against the
                          reference's pocket atoms matched as sets (both
                          sorted by position, then features): the program
                          orders them along a Morton curve, the reference
                          keeps the pocket's order; exact up to that order;
  kk_mismatch             the kk edges against the radius graph of the
                          program's keypoints at the rr cutoff, the pairs
                          within compare.KK_BAND_A of rr left out.
step_gap and decode_mismatch are compare.py's, on the reference's dense
kk at rr (summed in destination blocks). `readings(..., control=True)`
gives the control's readings (fp8 at the bfloat16 sites) on the same
inputs. The encoder has no weights, so its readings are 0 on both sides
and its limits 0.
"""
from __future__ import annotations

import contextlib
import sys
from typing import Any, Dict, List

import numpy as np

from portbench import compare, flops, flops_fixed, harness
from portbench.traffic import generate

ENC_MISSING = (1e3, 1.0)  # the encoder readings where the keypoint sets differ in size


def _as_set(x, h, mask) -> np.ndarray:
    """A row's valid keypoints as rows [position, features] in lexicographic order."""
    rows = np.concatenate([x, h], axis=1)[mask]
    return rows[np.lexsort(rows.T[::-1])]


def encoder_gaps(kp_x, kp_h, kp_mask, ref) -> tuple:
    """(root mean square distance in Å, largest feature difference over the
    reference's largest magnitude) of every row's keypoints against the
    reference's first row, the two matched as sets."""
    want = _as_set(ref.kp_x[0].cpu().numpy(), ref.kp_h[0].cpu().numpy(), ref.kp_mask[0].cpu().numpy())
    scale = max(float(np.abs(want[:, 3:]).max()), 1e-30)
    x, h, m = kp_x.float().cpu().numpy(), kp_h.float().cpu().numpy(), kp_mask.cpu().numpy()
    d2, h_gap = [], 0.0
    for b in range(x.shape[0]):
        got = _as_set(x[b], h[b], m[b])
        if got.shape != want.shape:
            return ENC_MISSING
        d2.append(np.sum(np.square(got[:, :3] - want[:, :3]), axis=1))
        h_gap = max(h_gap, float(np.abs(got[:, 3:] - want[:, 3:]).max()) / scale)
    return float(np.sqrt(np.mean(np.concatenate(d2)))), h_gap


def kk_mismatch(kk, adj_ref, kp_x, rr: float) -> int:
    """kk edges the program used that differ from `adj_ref`, the radius graph
    of its keypoints `kp_x` at `rr`, pairs within KK_BAND_A of rr left out."""
    import torch

    d = torch.cdist(kp_x.double(), kp_x.double())
    band = torch.abs(d - rr) < compare.KK_BAND_A
    return int(((compare._dense_kk(kk, kp_x.shape[1]) != adj_ref) & ~band).sum())


def readings(spec, recs, steps: List[int], control: bool = False) -> Dict[str, float]:
    """The program's readings over the records `recs` at the chain steps
    `steps` (the module docstring); control=True gives the control's
    readings on the same inputs instead (encoder and steps)."""
    import torch

    from portbench.reference import precision
    from portbench.reference.geometry import masked_com
    from portbench.reference.model import pad_pocket, read_archive
    from portbench.reference.model_fixed import fixed_padding, load_fixed_reference

    dev = torch.device(spec.device)
    model = spec.model_config
    precision.reference_matmul_precision()
    archive = read_archive(spec.archive)
    ref = load_fixed_reference(model, archive, dev)
    ctl = load_fixed_reference(model, archive, dev, control=True) if control else None
    pad = fixed_padding(model)
    lig_elements = model["dataset"]["lig_elements"]
    rr = model["graph"]["graph_cutoffs"]["rr"]
    g = compare.grid(model, spec.traffic["sample_steps"])
    out: Dict[str, Any] = dict(enc_x_rms_A=0.0, enc_h_gap=0.0, step_gap=0.0)
    if not control:
        out.update(kk_mismatch=0, decode_mismatch=0)
    for rec in recs:
        p = rec.pocket
        item = pad_pocket(p["rec_pos"], p["rec_feat"], p["rec_res_idx"], p["interface_points"], p["n_lig"],
                          len(lig_elements), pad, p["bucket"])
        enc_ref = ref.encode([item], dev)
        enc = ctl.encode([item], dev) if control else None
        x_rms, h_gap = encoder_gaps(*((enc.kp_x, enc.kp_h, enc.kp_mask) if control
                                     else (rec.enc["kp_x"], rec.enc["kp_h"], rec.enc["kp_mask"])), enc_ref)
        out["enc_x_rms_A"] = max(out["enc_x_rms_A"], x_rms)
        out["enc_h_gap"] = max(out["enc_h_gap"], h_gap)

        # the chain runs on the program's keypoints; the reference works out their kk edges again
        kp_x, kp_mask = rec.enc["kp_x"].float(), rec.enc["kp_mask"]
        adj_ref = ref.kk_adjacency(kp_x, kp_mask)
        if not control:
            out["kk_mismatch"] += kk_mismatch(rec.kk, adj_ref, kp_x, rr)

        b, bucket, n_lig = kp_x.shape[0], p["bucket"], p["n_lig"]
        lig_mask = (torch.arange(bucket, device=dev) < n_lig)[None].expand(b, bucket)
        static = dict(lig_mask=lig_mask, kp_h=rec.enc["kp_h"].float(), kp_mask=kp_mask, kp_v=None, kk=adj_ref)
        start = rec.states[-1]
        noise = compare._noise(rec, (tuple(start["lig_x"].shape), tuple(start["lig_h"].shape)), steps, dev)
        for c in steps:
            before = rec.states[c - 1] if c > 0 else start
            state = {k: v.float() for k, v in before.items()}
            args = (state, static, int(g[c]), int(g[c + 1]), *noise[c])
            new_ref, moved = ref.reverse_step(*args, eta=spec.traffic["eta"])
            new_cmp = ctl.reverse_step(*args, eta=spec.traffic["eta"])[0] if control else rec.states[c]
            a = torch.cat([new_cmp["lig_x"].float(), new_cmp["lig_h"].float()], dim=-1)
            r = torch.cat([new_ref["lig_x"], new_ref["lig_h"]], dim=-1)
            out["step_gap"] = max(out["step_gap"], compare._row_gap(a, r, moved))

        if not control:
            last = {k: v.float() for k, v in rec.states[rec.steps - 1].items()}
            lig_x, lig_h = ref.finish(last, lig_mask, kp_mask, masked_com(kp_x, kp_mask))
            n_mols = spec.traffic["n_mols"]
            decoded = rec.decoded or []
            mismatch = max(n_mols - len(decoded), 0)
            lig_x, lig_h = lig_x.cpu().numpy(), lig_h.cpu().numpy()
            for row, (coords, elements) in enumerate(decoded[:n_mols]):
                ref_x = lig_x[row, :n_lig]
                ref_el = [lig_elements[j] for j in lig_h[row, :n_lig, :len(lig_elements)].argmax(1)]
                if (coords.shape != ref_x.shape or list(elements) != ref_el
                        or float(np.max(np.abs(coords - ref_x))) > compare.DECODE_TOL_A):
                    mismatch += 1
            out["decode_mismatch"] += mismatch
        del enc_ref, adj_ref
    return out


@contextlib.contextmanager
def yardstick():
    """compare.generate_readings and flops.step_flops as this kind's while
    the block runs (generate.py and calibrate.py look them up there)."""
    saved = compare.generate_readings, flops.step_flops
    compare.generate_readings, flops.step_flops = readings, flops_fixed.step_flops
    try:
        yield
    finally:
        compare.generate_readings, flops.step_flops = saved


def run(spec: harness.Spec) -> Dict[str, Any]:
    """One run of the cell: the result line's fields."""
    return execute(spec)[0]


def execute(spec: harness.Spec):
    """(the result's fields, the records of the pockets compared, the steps compared), as generate.execute."""
    with yardstick():
        return generate.execute(spec)


if __name__ == "__main__":
    from portbench import calibrate

    with yardstick():
        sys.exit(calibrate.main())
