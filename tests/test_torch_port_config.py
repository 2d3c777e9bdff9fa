"""kpdiff_tpu_torch: config reader, parameter loading and the package's guards
(no JAX, flax, PyYAML or kpdiff_tpu imports; entry points refuse to fall
back to the CPU)."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from kpdiff_tpu import config as jcfg
from kpdiff_tpu_torch import config as tcfg
from kpdiff_tpu_torch.device import resolve_device
from kpdiff_tpu_torch.utils.params_io import (
    keystr_to_name, load_params, read_golden_params, read_keystr_npz)
from torch_port_util import same

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "configs").glob("*.yml"))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "kpdiff_tpu")


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_yaml_reader_matches_pyyaml(path):
    assert same(tcfg.load_config(path), yaml.safe_load(path.read_text()))


def test_yaml_reader_scalars():
    doc = "a: 1.0e-5\nb: 1e-5\nc: [x, 'y z', 3]\nd: {k: true, m: ~}\ne:\n  - 1\n  - -2.5 # c\n"
    assert same(tcfg.parse_yaml(doc), yaml.safe_load(doc))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_padding_and_feature_sizes_match(path):
    cfg = tcfg.load_config(path)
    assert tcfg.PaddingConfig.from_config(cfg).__dict__ == jcfg.PaddingConfig.from_config(cfg).__dict__
    assert tcfg.resolve_feature_sizes(cfg) == jcfg.resolve_feature_sizes(cfg)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_no_jax_flax_yaml_or_kpdiff_tpu():
    files = sorted((ROOT / "kpdiff_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    bad = [(f.name, m) for f in files for m in _imports(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the check is for machines without it")
    cfg = tcfg.load_config(ROOT / "configs/egnn_40kp.yml")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        tcfg.model_from_config(cfg)
    from kpdiff_tpu_torch.serve import KeypointSampler

    with pytest.raises(RuntimeError, match="CUDA"):
        KeypointSampler.from_params(ROOT / "configs/egnn_40kp.yml", None)
    from kpdiff_tpu_torch.cli.train import main as train_main

    with pytest.raises(RuntimeError, match="CUDA"):
        train_main(["--config", str(ROOT / "configs/egnn_40kp.yml"), "--synthetic_mol", "8"])
    # the run-directory constructor and the serving CLIs check the device before they read the run
    run = ROOT / "runs" / "absent_run"
    with pytest.raises(RuntimeError, match="CUDA"):
        KeypointSampler(run)
    from kpdiff_tpu_torch.cli import byop, sample, serve_http

    for main, argv in ((byop.main, ["--receptor_file", "r.pdb", "--ligand_file", "l.sdf"]), (sample.main, []),
                       (serve_http.main, [])):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--model_dir", str(run)] + argv)
    assert resolve_device("cpu").type == "cpu"


def test_keystr_names():
    assert keystr_to_name("['dynamics']['conv0']['edge_ll']['edge_lin2_w']") == "dynamics.conv0.edge_ll.edge_lin2_w"
    with pytest.raises(ValueError):
        keystr_to_name("dynamics/conv0")


def test_trained_flagship_archive_loads():
    """All 528 leaves (13.2 M parameters) of the trained flagship fill the
    port's model exactly; a missing, extra or mis-shaped leaf raises."""
    cfg = tcfg.load_config(ROOT / "configs/egnn_40kp.yml")
    model = tcfg.model_from_config(cfg, device="cpu")
    flat = read_keystr_npz(ROOT / "artifacts/egnn_40kp_trained_params.npz")
    assert len(flat) == 528
    load_params(model, flat)
    n = sum(p.numel() for p in model.parameters())
    assert 13.0e6 < n < 13.4e6
    name = "dynamics.conv3.edge_kk.edge_lin2_w"
    np.testing.assert_array_equal(dict(model.named_parameters())[name].detach().numpy(), flat[name])
    with pytest.raises(KeyError):
        load_params(model, {k: v for k, v in flat.items() if k != name})
    with pytest.raises(KeyError):
        load_params(model, {**flat, "dynamics.extra": np.zeros(1, np.float32)})
    with pytest.raises(ValueError):
        load_params(model, {**flat, name: flat[name][:-1]})


def test_golden_param_keys():
    with np.load(ROOT / "tests/golden/egnn_dynamics_mn0.npz") as z:
        flat = read_golden_params(z, prefix="dynamics")
    assert "dynamics.conv0.edge_kk.attn_b" in flat
    assert all(k.startswith("dynamics.") for k in flat)
