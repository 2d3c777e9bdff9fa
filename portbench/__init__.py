"""The benchmark of kpdiff_tpu_torch on NVIDIA GPUs: one cell of
BENCHMARK.json per run (`python3 -m portbench.run --workload <cell> ...`).
See README.md."""
