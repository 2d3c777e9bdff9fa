"""What every cell shares: the cache directories, BENCHMARK.json and the
files it names, the card's identity, the per-layer metric readers, the
check for JAX in the process, and the result line.

Everything a configuration, a traffic mix, a cell or a per-layer metric
needs sits in files of its own, found by name:
  configs/<config>.json     the configuration as run, its source and weights
  traffic/<traffic>.json    a traffic mix: parameters, and the `kind` that runs it
  traffic/<kind>.py         the generator and window of that kind (`run(spec)`)
  workloads/<cell>.json     the cell's correctness limits and check sizes
  metrics/<metric>.py       a per-layer metric's reader (`read(ctx)`)
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CACHE_DIR = ROOT / ".portbench_cache"
BANNED = ("jax", "jaxlib", "flax", "optax", "kpdiff_tpu")


def set_cache_env() -> None:
    """Every build and kernel cache in fixed directories inside the checkout
    (before torch is imported); no library may load JAX by itself."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        os.environ[var] = str(CACHE_DIR / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def banned_modules() -> List[str]:
    """Modules of JAX, its libraries or the JAX package loaded in this
    process, compared by whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def read_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Spec:
    """One run of one cell, as the command line and the files name it."""
    workload: str
    seed: int
    seconds: float
    trace: bool
    chips: int
    config_name: str
    config: Dict[str, Any]  # configs/<config>.json
    traffic_name: str
    traffic: Dict[str, Any]  # traffic/<traffic>.json
    cell: Dict[str, Any]  # workloads/<cell>.json
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    t_process: float = 0.0  # time.perf_counter() at process start
    device: str = "cuda"
    archive: Optional[Path] = None  # the weights both the program and the reference read

    @property
    def model_config(self) -> Dict[str, Any]:
        return self.config["model"]


def _applies(metric: Dict[str, Any], workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_spec(workload: str, seed: int, seconds: float, trace: bool, bench_path: Path = ROOT / "BENCHMARK.json") -> Spec:
    """The cell `workload` of BENCHMARK.json with its files."""
    bench = read_json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(ROOT / configs[w["config"]]["file"])
    traffic = read_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    cell = read_json(BENCH_DIR / "workloads" / f"{workload}.json")
    archive = config.get("weights")
    return Spec(workload=workload, seed=seed, seconds=seconds, trace=trace, chips=int(w["chips"]),
                config_name=w["config"], config=config, traffic_name=w["traffic"], traffic=traffic, cell=cell,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
                archive=None if archive is None else ROOT / archive)


def kind_module(kind: str):
    """traffic/<kind>.py, the code that runs every traffic mix of that kind."""
    return _load_file(BENCH_DIR / "traffic" / f"{kind}.py", f"portbench_kind_{kind}")


def metric_reader(name: str):
    """metrics/<name>.py, whose `read(ctx)` returns the metric's value or None."""
    return _load_file(BENCH_DIR / "metrics" / f"{name}.py", "portbench_metric_" + re.sub(r"\W", "_", name))


def _load_file(path: Path, module_name: str):
    if module_name in sys.modules:
        return sys.modules[module_name]
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = mod
    spec.loader.exec_module(mod)
    return mod


def read_per_layer(spec: Spec, ctx: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Every per-layer metric of the cell that its reader finds something to read for."""
    out = {}
    for m in spec.per_layer:
        value = metric_reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=index,name,power.limit,clocks.max.sm",
                               "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return proc.stdout.strip() or proc.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def format_checks(checks: Dict[str, Dict[str, float]]) -> List[str]:
    return [f"check {name}: {c['value']!r} (limit {c['limit']!r})" for name, c in checks.items()]


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict[str, Any], device: Dict[str, Any],
                checks: Dict[str, Dict[str, float]], breakdown: Optional[Dict[str, Any]] = None) -> str:
    """The last line of standard output; the numbers compared come last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed), "metrics": metrics,
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
