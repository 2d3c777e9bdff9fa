"""Small cells for the CPU: the real configurations cut to a few narrow
layers, random weights written to an archive that the program and the
reference both read, and a short pocket sequence."""
from __future__ import annotations

import copy
import time
from pathlib import Path

import numpy as np

from portbench import harness

BENCH = harness.ROOT / "BENCHMARK.json"


def tiny_model(arch: str = "egnn", dtype: str = "float32"):
    name = "egnn_40kp" if arch == "egnn" else "gvp_40kp"
    model = copy.deepcopy(harness.read_json(harness.BENCH_DIR / "configs" / f"{name}.json")["model"])
    model["padding"]["n_rec"] = 96
    model["graph"]["n_keypoints"] = 6
    if arch == "egnn":
        model["dynamics"].update(n_layers=2, hidden_nf=16, compute_dtype=dtype)
        model["rec_encoder"].update(n_convs=1, hidden_n_node_feat=16, out_n_node_feat=16, compute_dtype=dtype)
    else:
        model["dynamics_gvp"].update(n_convs=2, n_hidden_scalars=16, vector_size=4, compute_dtype=dtype,
                                     dropout=0.0)
        model["rec_encoder_gvp"].update(n_rr_convs=1, n_rk_convs=1, out_scalar_size=16, vector_size=4,
                                        dropout=0.0, compute_dtype=dtype)
    return name, model


def write_archive(model_cfg, path: Path, seed: int = 0) -> Path:
    """The program's own initialisation from `seed`, as a keystr npz."""
    from kpdiff_tpu_torch.config import model_from_config

    model = model_from_config(model_cfg, device="cpu", seed=seed)
    np.savez(path, **{"".join(f"['{p}']" for p in n.split(".")): v.detach().numpy()
                      for n, v in model.named_parameters()})
    return path


def tiny_spec(tmp_path: Path, arch: str = "egnn", dtype: str = "float32", seed: int = 123, trace: bool = False,
              seconds: float = 0.0) -> harness.Spec:
    """A CPU cell of the generate kind: 4 rows, 8 steps, pockets of 48-96 atoms."""
    name, model = tiny_model(arch, dtype)
    traffic = dict(harness.read_json(harness.BENCH_DIR / "traffic" / "eval_ref_k250.json"),
                   n_mols=4, batch_size=4, sample_steps=8, rec_atoms=[48, 96], pockets=4)
    workload = "egnn40kp.generate" if arch == "egnn" else "gvp40kp.generate"
    spec = harness.load_spec(workload, seed, seconds, trace, BENCH)
    spec.config = dict(spec.config, model=model)
    spec.config_name = f"tiny_{name}_{dtype}"
    spec.traffic = traffic
    spec.device = "cpu"
    spec.archive = write_archive(model, tmp_path / "params.npz")
    spec.t_process = time.perf_counter()
    return spec


def tiny_train_spec(tmp_path: Path, dtype: str = "float32", seed: int = 321, trace: bool = False,
                    seconds: float = 0.0) -> harness.Spec:
    """A CPU cell of the train kind: batch 4 over 24 complexes, pockets of 48-96 atoms."""
    _, model = tiny_model("egnn", dtype)
    model["training"]["batch_size"] = 4
    traffic = dict(harness.read_json(harness.BENCH_DIR / "traffic" / "train_b64.json"),
                   complexes=24, rec_atoms=[48, 96], profiled_steps=2)
    spec = harness.load_spec("egnn40kp.train", seed, seconds, trace, BENCH)
    spec.config = dict(spec.config, model=model)
    spec.config_name = f"tiny_train_{dtype}"
    spec.traffic = traffic
    spec.device = "cpu"
    spec.archive = write_archive(model, tmp_path / "params.npz")
    spec.t_process = time.perf_counter()
    return spec
