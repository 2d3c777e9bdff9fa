"""Export a run's checkpoint parameters to a flat npz archive
(kpdiff_tpu/cli/export_params.py).

    python -m kpdiff_tpu_torch.cli.export_params RUN_DIR OUT.npz [--step N | --best [METRIC]]

The archive is keyed by the JAX package's `jax.tree_util.keystr` paths
(`['dynamics']['conv0']['edge_ll']['edge_lin2_w']`), so the port's
`KeypointSampler.from_params` and the JAX package's `load_params_npz` both
read it. `--best [metric]` picks the checkpoint nearest the run's best
analyzer epoch in test_metrics.pkl (`mol_*` rows; 'combined' scores
connectivity + frag_frac) instead of the newest one.
"""
from __future__ import annotations

import argparse
import pickle
from pathlib import Path

from kpdiff_tpu_torch.training.trainer import checkpoint_steps, read_checkpoint
from kpdiff_tpu_torch.utils.params_io import save_keystr_npz


def latest_step(ckpt_dir: Path) -> int:
    steps = checkpoint_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    return steps[-1]


def best_step(run_dir: str | Path, metric: str = "connectivity") -> int:
    """Checkpoint step nearest the run's best analyzer epoch for `metric`."""
    run_dir = Path(run_dir)
    steps = checkpoint_steps(run_dir / "checkpoints")
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {run_dir / 'checkpoints'}")
    with open(run_dir / "test_metrics.pkl", "rb") as f:
        rows = pickle.load(f)

    def score(r):
        if metric == "combined":
            if "mol_connectivity" not in r:
                return None
            return float(r["mol_connectivity"]) + float(r.get("mol_avg_frag_frac", 0.0))
        v = r.get(f"mol_{metric}")
        return None if v is None else float(v)

    cand = [(score(r), float(r["mol_epoch"])) for r in rows
            if r.get("mol_epoch") is not None and score(r) is not None]
    if not cand:
        raise ValueError(f"no analyzer rows with mol_{metric} in {run_dir}/test_metrics.pkl")
    best_score, best_epoch = max(cand)
    final_epoch = max((float(r["epoch"]) for r in rows if "epoch" in r), default=0.0)
    if final_epoch <= 0:
        # without epoch-keyed test rows the iterations per epoch are unknown
        print(f"best {metric}={best_score:.4f} at analyzer epoch {best_epoch:g}, but no epoch-keyed test "
              "rows to map epochs to steps; exporting the LATEST checkpoint instead")
        return max(steps)
    ipe = max(steps) / final_epoch  # iterations per epoch, inferred
    chosen = min(steps, key=lambda s: abs(s / ipe - best_epoch))
    print(f"best {metric}={best_score:.4f} at analyzer epoch {best_epoch:g} "
          f"-> checkpoint step {chosen} (epoch ~{chosen / ipe:.1f})")
    return chosen


def export(run_dir: str | Path, out: str | Path, step: int | None = None) -> int:
    ckpt_dir = Path(run_dir) / "checkpoints"
    step = latest_step(ckpt_dir) if step is None else step
    params = read_checkpoint(ckpt_dir, step)["params"]
    save_keystr_npz({n: v.numpy() for n, v in params.items()}, out)
    n = sum(int(v.numel()) for v in params.values())
    print(f"exported step {step}: {n:,} params -> {out}")
    return step


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("run_dir")
    p.add_argument("out")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--best", nargs="?", const="connectivity", default=None, metavar="METRIC",
                   help="pick the checkpoint nearest the run's best analyzer epoch for METRIC "
                        "(default 'connectivity'; 'combined' = connectivity + frag_frac)")
    a = p.parse_args(argv)
    if a.best is not None and a.step is not None:
        raise SystemExit("--best and --step are mutually exclusive")
    step = best_step(a.run_dir, a.best) if a.best is not None else a.step
    export(a.run_dir, a.out, step)


if __name__ == "__main__":
    main()
