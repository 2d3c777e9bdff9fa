"""The `generate_fixed_gvp` kind: the `generate_fixed` kind
(traffic/generate_fixed.py, itself the `generate` kind with the fixed
encoder's readings) on a GVP configuration with a fixed receptor encoder,
whose keypoints are the pocket atoms (`gvp_all_atom`,
configs/gvp_all_atom.json).

The cell gvp_all_atom.generate runs it (traffic/eval_aa_gvp_b32_k250.json).
It is a kind of its own because reference/model_fixed.py and
flops_fixed.py cover EGNN dynamics alone. Once generate.execute takes the
readings, the reference and the operation count as arguments, this module
and flops_fixed_gvp.step_flops go there with generate_fixed's, and
`yardstick()` goes away. tests/test_portbench_files.py's table of limits by
kind knows `generate` and `train` alone; tests/test_portbench_fixed_gvp.py
checks this kind's cells against its readings instead.

Traffic (traffic/<mix>.json): the `generate` kind's parameters, with
`kind: generate_fixed_gvp`. Pockets, keypoints and kk are generate_fixed's:
each chunk's keypoint capacity is the receptor's padding, and `compact_kk`
turns the block layout of the kk edges into the exact rr radius graph as a
destination-major neighbor list.

Limits are set as for the other cells, with calibrate.py run under this
kind's yardstick:

    python3 -m portbench.traffic.generate_fixed_gvp --workload gvp_all_atom.generate --seeds <n> ... --control 3

What this kind changes, while its run lasts (`yardstick()`): everything
generate_fixed's yardstick changes, and besides
  * the reference that generate_fixed.readings loads is
    reference/model_fixed_gvp.py's (the GVP dynamics, kk aggregated in
    destination blocks, zero keypoint vectors), in place of model_fixed.py's;
  * model operations are flops_fixed_gvp.step_flops (the keypoint encoder
    on the receptor's one-hot width), in place of flops_fixed.step_flops.
The readings are generate_fixed.readings as they are; the encoder has no
weights, so its readings are 0 on both sides and its limits 0.
"""
from __future__ import annotations

import contextlib
import sys
from typing import Any, Dict

from portbench import flops, flops_fixed_gvp, harness
from portbench.reference import model_fixed, model_fixed_gvp
from portbench.traffic import generate, generate_fixed


@contextlib.contextmanager
def yardstick():
    """generate_fixed's yardstick, with model_fixed.load_fixed_reference and
    flops.step_flops as this kind's while the block runs (generate_fixed.readings,
    generate.py and calibrate.py look them up there)."""
    with generate_fixed.yardstick():
        saved = model_fixed.load_fixed_reference, flops.step_flops
        model_fixed.load_fixed_reference = model_fixed_gvp.load_fixed_gvp_reference
        flops.step_flops = flops_fixed_gvp.step_flops
        try:
            yield
        finally:
            model_fixed.load_fixed_reference, flops.step_flops = saved


def run(spec: harness.Spec) -> Dict[str, Any]:
    """One run of the cell: the result line's fields."""
    return execute(spec)[0]


def execute(spec: harness.Spec):
    """(the result's fields, the records of the pockets compared, the steps compared), as generate.execute."""
    with yardstick():
        return generate.execute(spec)


def readings(spec, recs, steps, control: bool = False) -> Dict[str, float]:
    """generate_fixed.readings against this kind's reference (the control's
    with control=True)."""
    with yardstick():
        return generate_fixed.readings(spec, recs, steps, control=control)


if __name__ == "__main__":
    from portbench import calibrate

    with yardstick():
        sys.exit(calibrate.main())
