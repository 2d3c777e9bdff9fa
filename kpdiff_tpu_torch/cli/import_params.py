"""Make a port run directory from a keystr npz archive (the inverse of
cli/export_params.py).

    python -m kpdiff_tpu_torch.cli.import_params CONFIG PARAMS.npz RUN_DIR \
        [--set dataset.location=data/my_processed/]

Writes RUN_DIR/config.yml (the port's YAML writer, with the overrides) and
RUN_DIR/checkpoints/step_0.pt holding the archive's parameters, which
`KeypointSampler(RUN_DIR)` and the byop, sample and serve_http CLIs load.
The archive may come from either package (`artifacts/*_trained_params.npz`,
`cli/export_params.py`); every leaf must match the config's model.
"""
from __future__ import annotations

import argparse
from pathlib import Path


def make_run_dir(config: dict | str | Path, params_npz: str | Path, run_dir: str | Path) -> Path:
    from kpdiff_tpu_torch.cli.train import train_config_from
    from kpdiff_tpu_torch.config import dump_yaml, load_config, model_from_config
    from kpdiff_tpu_torch.training.trainer import init_train_state, save_checkpoint
    from kpdiff_tpu_torch.utils.params_io import load_params, read_keystr_npz

    cfg = config if isinstance(config, dict) else load_config(config)
    model = model_from_config(cfg, device="cpu")
    load_params(model, read_keystr_npz(params_npz))
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True)
    (run_dir / "config.yml").write_text(dump_yaml(cfg))
    save_checkpoint(run_dir / "checkpoints", init_train_state(model, train_config_from(cfg)))
    return run_dir


def main(argv=None):
    from kpdiff_tpu_torch.cli.train import apply_overrides
    from kpdiff_tpu_torch.config import load_config

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("config")
    p.add_argument("params_npz")
    p.add_argument("run_dir")
    p.add_argument("--set", action="append", default=[], metavar="SECTION.KEY=VALUE",
                   help="override any nested config key, e.g. --set dataset.location=data/x/")
    a = p.parse_args(argv)
    run_dir = make_run_dir(apply_overrides(load_config(a.config), a.set), a.params_npz, a.run_dir)
    print(f"run dir {run_dir}: config.yml and checkpoints/step_0.pt from {a.params_npz}")
    return run_dir


if __name__ == "__main__":
    main()
