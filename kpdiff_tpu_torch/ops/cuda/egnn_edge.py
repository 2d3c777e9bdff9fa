"""Dense EGNN edge messages and aggregation: CUDA kernel, wrapper and plain version.

Replaces the TPU kernel `kpdiff_tpu/ops/pallas/egnn_edge.py::
fused_dense_edge_split` (body `_kernel`, `pl.pallas_call` at line 174). The
CUDA source is `kpdiff_tpu_torch/csrc/egnn_edge.cu` (kernel v4); its header
comment says what bounds the kernel (tensor-core FLOPs of the two H x H
second layers per pair) and how it keeps every per-pair tensor out of device
memory. Its shared memory does not grow with Ns or Nd: only the width is
limited.

`egnn_edge_dense` is the entry: on CUDA tensors it launches the kernel (built
with nvcc at first use into `kpdiff_tpu_torch/_build/`, loaded with ctypes)
or raises; on CPU tensors it runs `egnn_edge_dense_plain`, the same function
in plain PyTorch with the same rounding places. There is no fallback from
the kernel to the plain version. `launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import threading
from pathlib import Path

import torch
import torch.nn.functional as F

launches = 0  # kernel launches made by egnn_edge_dense (CUDA tensors only)

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "egnn_edge.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
# the in-kernel phases of the profiling build, in the order of csrc's `enum Phase`
PHASES = ("setup", "w2_copy", "layer1", "product", "epilogue", "aggregation", "barrier")
MAX_SOURCES = 0xFFFF  # the kernel packs a source index into 16 bits
_libs = {}  # phase_clocks (bool) -> loaded library
_lock = threading.Lock()


def padded_width(h: int) -> int:
    """Width the kernel pads H to: a multiple of the 16-wide tensor-core tile."""
    return (h + 15) // 16 * 16


def pad_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(H, H) second-layer weight -> zero-padded contiguous (HP, HP) in `dtype`."""
    h = w.shape[0]
    hp = padded_width(h)
    out = torch.zeros((hp, hp), dtype=dtype, device=w.device)
    out[:h, :h] = w.to(dtype)
    return out


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    from shutil import which

    found = which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernel builds on a machine with the CUDA toolkit")
    return found


def build(verbose: bool = False, phase_clocks: bool = False) -> Path:
    """Compile csrc/egnn_edge.cu for sm_90a into _build/ unless it is current.

    phase_clocks=True builds the profiling library (-DEGNN_EDGE_PHASE_CLOCKS),
    a second file beside the production one. Returns the shared library's
    path; raises with nvcc's output on failure."""
    name = "libegnn_edge_clocks.so" if phase_clocks else "libegnn_edge.so"
    lib = BUILD_DIR / name
    if lib.exists() and lib.stat().st_mtime >= SOURCE.stat().st_mtime:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{name}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(SOURCE)]
    if phase_clocks:
        cmd.insert(1, "-DEGNN_EDGE_PHASE_CLOCKS")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    if verbose:
        print(proc.stderr.strip())
    os.replace(tmp, lib)
    return lib


def _load(phase_clocks: bool = False):
    with _lock:
        if phase_clocks not in _libs:
            lib = ctypes.CDLL(str(build(phase_clocks=phase_clocks)))
            vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.egnn_edge_dense_launch.argtypes = [vp] * 18 + [i, i, i, i, i, i, f, i, vp]
            lib.egnn_edge_dense_launch.restype = i
            lib.egnn_edge_dense_smem_bytes.argtypes = [i, i]
            lib.egnn_edge_dense_smem_bytes.restype = ctypes.c_size_t
            lib.egnn_edge_dense_max_hp.argtypes = []
            lib.egnn_edge_dense_max_hp.restype = i
            lib.egnn_edge_error_string.argtypes = [i]
            lib.egnn_edge_error_string.restype = ctypes.c_char_p
            if phase_clocks:
                lib.egnn_edge_phase_clocks_read.argtypes = [vp]
                if lib.egnn_edge_phase_clocks_count() != len(PHASES):
                    raise RuntimeError("the profiling build's phases differ from PHASES")
            _libs[phase_clocks] = lib
    return _libs[phase_clocks]


@functools.lru_cache(maxsize=None)
def _width_check(phase_clocks: bool, device_index: int, hp: int, bf16: bool):
    """Raise unless the kernel takes padded width hp: the library's width
    limit, and its shared memory (which does not depend on Ns or Nd) against
    the card's opt-in limit. Cached per (library, device, width, mode): it
    queries the device."""
    lib = _load(phase_clocks)
    if hp > lib.egnn_edge_dense_max_hp():
        raise ValueError(f"padded width {hp} exceeds the kernel's limit {lib.egnn_edge_dense_max_hp()}")
    smem = lib.egnn_edge_dense_smem_bytes(hp, int(bf16))
    limit = getattr(torch.cuda.get_device_properties(device_index), "shared_memory_per_block_optin", None)
    if limit is not None and smem > limit:
        raise ValueError(f"HP={hp} needs {smem} bytes of shared memory, the card offers {limit}")


def egnn_edge_dense_plain(a_es, a_ed, a_cs, a_cd, w_edij, w_cdij, w2e, b2e, attw, atb,
                          w2c, b2c, wout, x_s, x_d, adj, *, use_tanh: bool, coords_range: float,
                          compute_dtype: torch.dtype):
    """The kernel's function in plain PyTorch, rounding where `_kernel` rounds:
    pre-activation and silu in the compute dtype, the lin2 product in f32 then
    bias and a cast to the compute dtype, gate and output reductions as
    compute-dtype products summed in f32. Returns (agg_h (B,Nd,H), agg_x (B,Nd,3))."""
    cd, f32 = compute_dtype, torch.float32
    h = a_es.shape[-1]
    adjf = adj.to(f32)
    diff = torch.where(adj[..., None], x_s[:, :, None, :] - x_d[:, None, :, :], 0.0) + 1e-30
    dij = torch.sqrt(torch.sum(diff * diff, dim=-1))  # (B, Ns, Nd)

    def chain(a_s, a_d, w_dij, w2, b2):
        pre = (a_s.to(cd)[:, :, None, :] + a_d.to(cd)[:, None, :, :]) + dij.to(cd)[..., None] * w_dij.to(cd)
        m1 = F.silu(pre)
        m2 = (m1.to(f32) @ w2[:h, :h].to(f32) + b2.to(f32)).to(cd)
        return F.silu(m2)

    m = chain(a_es, a_ed, w_edij, w2e, b2e)
    gate = torch.sigmoid(torch.sum((m * attw.to(cd)).to(f32), dim=-1) + atb.to(f32)) * adjf
    agg_h = torch.einsum("bsd,bsdh->bdh", gate, m.to(f32))
    c = chain(a_cs, a_cd, w_cdij, w2c, b2c)
    scalar = torch.sum((c * wout.to(cd)).to(f32), dim=-1)
    if use_tanh:
        scalar = torch.tanh(scalar) * coords_range
    scalar = scalar * adjf / (dij + 1.0)
    agg_x = torch.einsum("bsd,bsdc->bdc", scalar, diff)
    return agg_h, agg_x


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def egnn_edge_dense(a_es, a_ed, a_cs, a_cd, w_edij, w_cdij, w2e, b2e, attw, atb,
                    w2c, b2c, wout, x_s, x_d, adj, *, use_tanh: bool, coords_range: float,
                    compute_dtype: torch.dtype = torch.bfloat16):
    """Aggregated dense EGNN edge messages: (agg_h (B,Nd,H) f32, agg_x (B,Nd,3) f32).

    a_es/a_cs (B,Ns,H) and a_ed/a_cd (B,Nd,H): first-layer per-node
    projections of the edge and coordinate chains, the first-layer bias
    folded into the destination side. w_edij/w_cdij (H): the distance rows
    of the first layers. w2e/w2c: second-layer weights zero-padded to
    (HP,HP) in the compute dtype (`pad_weight`). b2e/b2c, attw and wout (H);
    atb (1). x_s (B,Ns,3), x_d (B,Nd,3); adj (B,Ns,Nd) bool.
    """
    global launches
    args = (a_es, a_ed, a_cs, a_cd, w_edij, w_cdij, w2e, b2e, attw, atb, w2c, b2c, wout, x_s, x_d, adj)
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute_dtype {compute_dtype} is not supported (float32, bfloat16)")
    if a_es.device.type == "cpu":
        hp = padded_width(a_es.shape[-1])
        for name, t in (("w2e", w2e), ("w2c", w2c)):
            _check(name, t, (hp, hp), compute_dtype, a_es.device)
        return egnn_edge_dense_plain(*args, use_tanh=use_tanh, coords_range=coords_range,
                                     compute_dtype=compute_dtype)
    if a_es.device.type != "cuda":
        raise ValueError(f"egnn_edge_dense runs on CUDA or CPU tensors, got {a_es.device}")
    out = _launch(False, args, use_tanh, coords_range, compute_dtype)
    launches += 1
    return out


def phase_clocks(*args, use_tanh: bool, coords_range: float, compute_dtype: torch.dtype) -> dict:
    """One launch of the profiling build on CUDA tensors (egnn_edge_dense's
    arguments): {phase: SM clocks summed over the launch's warps}. Not counted
    in `launches`; the production library is not involved."""
    lib = _load(phase_clocks=True)
    err = lib.egnn_edge_phase_clocks_reset()
    if err == 0:
        _launch(True, args, use_tanh, coords_range, compute_dtype)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * len(PHASES))()
        err = lib.egnn_edge_phase_clocks_read(ctypes.addressof(buf))
    if err != 0:
        raise RuntimeError(f"phase clocks: {lib.egnn_edge_error_string(err).decode()} ({err})")
    return dict(zip(PHASES, (int(v) for v in buf)))


def _launch(clocks: bool, args, use_tanh, coords_range, compute_dtype):
    (a_es, a_ed, a_cs, a_cd, w_edij, w_cdij, w2e, b2e, attw, atb, w2c, b2c, wout, x_s, x_d, adj) = args
    dev = a_es.device
    b, ns, h = a_es.shape
    nd = a_ed.shape[1]
    hp = padded_width(h)
    bf16 = compute_dtype == torch.bfloat16
    f32 = torch.float32
    for name, t, shape in (("a_es", a_es, (b, ns, h)), ("a_ed", a_ed, (b, nd, h)),
                           ("a_cs", a_cs, (b, ns, h)), ("a_cd", a_cd, (b, nd, h)),
                           ("w_edij", w_edij, (h,)), ("w_cdij", w_cdij, (h,)),
                           ("b2e", b2e, (h,)), ("attw", attw, (h,)), ("atb", atb, (1,)),
                           ("b2c", b2c, (h,)), ("wout", wout, (h,)),
                           ("x_s", x_s, (b, ns, 3)), ("x_d", x_d, (b, nd, 3))):
        _check(name, t, shape, f32, dev)
    for name, t in (("w2e", w2e), ("w2c", w2c)):
        _check(name, t, (hp, hp), compute_dtype, dev)
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: not 16-byte aligned")
    _check("adj", adj, (b, ns, nd), torch.bool, dev)
    if ns > MAX_SOURCES:
        raise ValueError(f"Ns={ns} exceeds the kernel's limit {MAX_SOURCES} (16-bit source index)")
    lib = _load(clocks)
    _width_check(clocks, dev.index if dev.index is not None else torch.cuda.current_device(), hp, bf16)

    agg_h = torch.empty((b, nd, h), dtype=f32, device=dev)
    agg_x = torch.empty((b, nd, 3), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [t.data_ptr() for t in (a_es, a_ed, a_cs, a_cd, w_edij, w_cdij, w2e, b2e, attw, atb,
                                       w2c, b2c, wout, x_s, x_d, adj.view(torch.uint8), agg_h, agg_x)]
        err = lib.egnn_edge_dense_launch(*ptrs, b, ns, nd, h, hp, int(bool(use_tanh)),
                                         float(coords_range), int(bf16), stream)
    if err != 0:
        raise RuntimeError(f"egnn_edge_dense kernel launch failed: "
                           f"{lib.egnn_edge_error_string(err).decode()} ({err})")
    return agg_h, agg_x
