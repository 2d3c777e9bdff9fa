"""Cluster command-file generators naming the port's CLIs
(kpdiff_tpu/cli/gen_commands.py; the upstream gen_test_commands.py,
gen_docking_cmds.py and gen_pocket_min_cmds.py for SLURM-array scale-out).
One script with subcommands; fixes the upstream's undefined `{minimize_cmd}`
(gen_docking_cmds.py:47-48) by emitting the minimization flag.

    python -m kpdiff_tpu_torch.cli.gen_commands sample --model_dir ... --n_pockets 100 --out cmds.txt
    python -m kpdiff_tpu_torch.cli.gen_commands docking --sampled_mols_dir ... --out docking_cmds.txt
    python -m kpdiff_tpu_torch.cli.gen_commands minimize --sampled_mols_dir ... --out min_cmds.txt
"""
from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("sample")
    s.add_argument("--model_dir", required=True)
    s.add_argument("--n_pockets", type=int, required=True)
    s.add_argument("--out_dir", default="sampled_mols")
    s.add_argument("--samples_per_pocket", type=int, default=100)
    s.add_argument("--out", default="test_commands.txt")

    d = sub.add_parser("docking")
    d.add_argument("--sampled_mols_dir", required=True)
    d.add_argument("--gnina", default="gnina")
    d.add_argument("--minimize", action="store_true", default=True)
    d.add_argument("--out", default="docking_cmds.txt")

    m = sub.add_parser("minimize")
    m.add_argument("--sampled_mols_dir", required=True)
    m.add_argument("--out", default="pocket_min_cmds.txt")

    args = p.parse_args(argv)

    lines = []
    if args.cmd == "sample":
        for i in range(args.n_pockets):
            lines.append(
                f"python -m kpdiff_tpu_torch.cli.sample --model_dir {args.model_dir} "
                f"--dataset_idx {i} --samples_per_pocket {args.samples_per_pocket} "
                f"--out {args.out_dir}"
            )
    elif args.cmd == "docking":
        root = Path(args.sampled_mols_dir)
        for pocket in sorted(root.glob("pocket_*")):
            sdf = pocket / "raw_ligands.sdf"
            rec = pocket / "pocket.pdb"
            if not sdf.exists():
                continue
            minimize_flag = "--minimize" if args.minimize else ""
            lines.append(
                f"{args.gnina} -r {rec} -l {sdf} --autobox_ligand {sdf} {minimize_flag} "
                f"-o {pocket / 'docked.sdf'} > {pocket / 'gnina.log'}"
            )
    elif args.cmd == "minimize":
        root = Path(args.sampled_mols_dir)
        for pocket in sorted(root.glob("pocket_*")):
            if (pocket / "min_running").exists() or (pocket / "minimized.sdf").exists():
                continue  # lockfile skip (reference gen_pocket_min_cmds.py:49-52)
            lines.append(
                f"python -m kpdiff_tpu_torch.cli.pocket_minimization --pocket_dir {pocket}"
            )

    Path(args.out).write_text("\n".join(lines) + "\n")
    print(f"wrote {len(lines)} commands to {args.out}")


if __name__ == "__main__":
    main()
