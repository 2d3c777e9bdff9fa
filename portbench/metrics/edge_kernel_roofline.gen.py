"""Share of its roofline of the dense EGNN edge work, %: the least time of
every dense edge launch of the profiled pocket (ll on each step's ligand
radius graph, and kk where the chunk's kk stayed dense; six layers;
flops.edge_kernel_bound_s) over the device seconds of the kernels that do
that work in its trace. The kernels are named by the regular expressions in
the files of edge_kernel_roofline.gen.kernels/ (one per line), so a later
kernel for the same work adds a file. None where no kernel matched."""
from pathlib import Path


def patterns():
    folder = Path(__file__).with_suffix(".kernels")
    return [line.strip() for f in sorted(folder.glob("*.txt")) for line in f.read_text().splitlines()
            if line.strip() and not line.startswith("#")]


def read(ctx):
    import importlib.util

    prof = ctx["profile"]
    if prof is None or "edge_bound_s" not in prof:
        return None
    spec = importlib.util.spec_from_file_location("portbench_trace", Path(__file__).parents[1] / "trace.py")
    trace = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(trace)
    seconds = trace.matched_seconds(prof["kernels"], patterns())
    return 100.0 * prof["edge_bound_s"] / seconds if seconds > 0 else None
