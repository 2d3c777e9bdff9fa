"""Dense EGNN edge messages and aggregation: CUDA kernel, wrapper and plain version.

Replaces the TPU kernel `kpdiff_tpu/ops/pallas/egnn_edge.py::
fused_dense_edge_split` (body `_kernel`, `pl.pallas_call` at line 174). The
CUDA source is `kpdiff_tpu_torch/csrc/egnn_edge.cu` (kernel v5); its header
comment says what bounds the kernel (tensor-core FLOPs of the two second
layers' main blocks per pair) and how it keeps every per-pair tensor out of
device memory. As the TPU kernel does, it splits the width H = Hm + 1 into a
main block of Hm channels, run on the tensor cores, and the last
(timestep) channel, run on the CUDA cores in f32. Its shared memory does
not grow with Ns or Nd: only the width is limited.

Operand formats: each second layer comes packed once by `pack_w2` (the main
block as the image the kernel's wgmma descriptor reads, the t-channel row,
column and corner as f32), and the per-node projections a_* come in the
compute dtype (the reference rounds them first) as rows at a stride of a
multiple of 8 elements (`row_stride`; the module's matrix products write them
so, `aligned_rows` copies other tensors into it).

`egnn_edge_dense` is the entry for a dense (B, Ns, Nd) mask: on CUDA
tensors it launches the kernel (built with nvcc at first use into
`kpdiff_tpu_torch/_build/`, loaded with ctypes) or raises; on CPU tensors
it runs `egnn_edge_dense_plain`, the same function in plain PyTorch with
the same rounding places. There is no fallback from the kernel to the plain
version. `egnn_edge_list` is the entry for a destination-major neighbor
list (idx, valid) (B, Nd, cap): in bf16 on CUDA tensors the kernel's list
mode, which fills its tiles from the list's slots where the mask mode scans
all Ns sources of each destination; elsewhere the list's mask through
`egnn_edge_dense`. `launches` counts kernel launches of both entries,
`list_launches` those of the list mode; `captured` and `list_captured`
count the calls recorded into a CUDA graph while a stream captures (they
launch nothing then): the graph runner (`models/chain_graph.py`) adds a
graph's captured counts to `launches` and `list_launches` at every replay.
The same library holds the tracer's device timer (`device_stamp`,
utils/profiling.py) and the node count of a graph under capture
(`capture_kernel_nodes`).
"""
from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple

import torch
import torch.nn.functional as F

from kpdiff_tpu_torch.ops.edge_sets import NbrList

launches = 0  # kernel launches (CUDA tensors only), replays of captured ones included
captured = 0  # calls recorded into a CUDA graph (no launch at the call; each replay launches them)
list_launches = 0  # of `launches`, those of the list mode (egnn_edge_list)
list_captured = 0  # of `captured`, those of the list mode

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "egnn_edge.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
# the in-kernel phases of the profiling build, in the order of csrc's `enum Phase`
PHASES = ("setup", "w2_load", "layer1", "product", "epilogue", "aggregation", "barrier")
MAX_SOURCES = 0xFFFF  # the f32 mode's pair list packs a source into 16 bits
MAX_WIDTH = 288  # H; the main block (H - 1 channels) fits the card's shared memory up to 287
_libs = {}  # phase_clocks (bool) -> loaded library
_lock = threading.Lock()


def main_dims(h: int) -> tuple[int, int]:
    """(KP, NP) of the packed main block for width h: K and N of the
    tensor-core product, the main block's Hm = h - 1 channels zero padded.
    One m64n256k16 pass for Hm <= 256; two N halves of 144 with K padded to
    a multiple of 64 for Hm up to 287."""
    hm = h - 1
    if hm < 1 or h > MAX_WIDTH:
        raise ValueError(f"width {h} is outside the kernel's range 2 .. {MAX_WIDTH}")
    return (256, 256) if hm <= 256 else (320, 288)


def row_stride(h: int) -> int:
    """Row stride (elements) of the a_* operands: h rounded up to a multiple
    of 8, so that rows, and the second chain's rows in the module's shared
    buffer, start 16-byte aligned."""
    return (h + 7) // 8 * 8


def aligned_rows(x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A (B, N, H) copy of x (in dtype, default x's) laid out as the kernel
    reads a_*: a view of a zero-padded (B, N, row_stride(H)) tensor."""
    b, n, h = x.shape
    out = torch.zeros((b, n, row_stride(h)), dtype=dtype or x.dtype, device=x.device)
    out[..., :h] = x
    return out[..., :h]


class PackedW2(NamedTuple):
    """A second layer W2 (H x H, (in, out)) in the kernel's operand format.

    main: (NP * KP,) in the compute dtype, W2[:Hm, :Hm] zero padded to
    (KP, NP) as the wgmma B operand's shared-memory image: K-blocks of 64
    channels, within each the NP output channels as rows of 64 K elements,
    16-byte chunks of 8 swizzled by row % 8 (the 128-byte swizzle), and the
    channels of every 16-wide k-step in the order the kernel's A fragments
    hold them (logical slot 8 hi + 2 q + lo holds channel 4 q + 2 hi + lo).
    tail: (NP + KP + 4,) f32: W2[Hm, :Hm] (the t-channel's row, zero padded
    to NP), W2[:Hm, Hm] (its column, padded to KP), W2[Hm, Hm], 0, 0, 0.
    """
    main: torch.Tensor
    tail: torch.Tensor
    h: int


def _k_order(kp: int) -> torch.Tensor:
    """Channel held by each logical K slot of the packed image."""
    j = torch.arange(kp)
    r = j % 16
    return j - r + 4 * ((r % 8) // 2) + 2 * (r // 8) + r % 2


def _swizzle(np_: int) -> torch.Tensor:
    """(NP, 8): physical 16-byte chunk of each logical chunk of a row."""
    return torch.arange(8)[None, :] ^ (torch.arange(np_) % 8)[:, None]


def pack_w2(w: torch.Tensor, dtype: torch.dtype) -> PackedW2:
    """(H, H) second-layer weight -> PackedW2 with the main block in dtype."""
    h = w.shape[0]
    if tuple(w.shape) != (h, h):
        raise ValueError(f"W2 of shape {tuple(w.shape)} is not square")
    kp, np_ = main_dims(h)
    hm = h - 1
    w = w.detach()
    dense = torch.zeros((kp, np_), dtype=dtype, device=w.device)  # [channel k, n]
    dense[:hm, :hm] = w[:hm, :hm].to(dtype)
    logical = dense[_k_order(kp).to(w.device)]  # [slot, n]
    chunks = logical.reshape(kp // 64, 8, 8, np_).permute(0, 3, 1, 2)  # [K-block, n, chunk, element]
    img = torch.empty_like(chunks)
    img[:, torch.arange(np_)[:, None], _swizzle(np_)] = chunks
    tail = torch.zeros(np_ + kp + 4, dtype=torch.float32, device=w.device)
    tail[:hm] = w[hm, :hm].float()
    tail[np_:np_ + hm] = w[:hm, hm].float()
    tail[np_ + kp] = w[hm, hm].float()
    return PackedW2(img.reshape(-1).contiguous(), tail, h)


def unpack_w2(pw: PackedW2) -> torch.Tensor:
    """PackedW2 -> the (H, H) f32 weight it holds (the main block as rounded
    to its dtype): the inverse of pack_w2."""
    h = pw.h
    kp, np_ = main_dims(h)
    hm = h - 1
    img = pw.main.reshape(kp // 64, np_, 8, 8)
    chunks = img[:, torch.arange(np_)[:, None], _swizzle(np_)]  # [K-block, n, chunk, element]
    logical = chunks.permute(0, 2, 3, 1).reshape(kp, np_)
    dense = torch.empty_like(logical)
    dense[_k_order(kp).to(logical.device)] = logical
    w = torch.empty((h, h), dtype=torch.float32, device=pw.main.device)
    w[:hm, :hm] = dense[:hm, :hm].float()
    w[hm, :hm] = pw.tail[:hm]
    w[:hm, hm] = pw.tail[np_:np_ + hm]
    w[hm, hm] = pw.tail[np_ + kp]
    return w


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
            lib.egnn_edge_dense_launch.argtypes = [vp] * 20 + [i, i, i, i, i, i, f, i, vp]
            lib.egnn_edge_dense_launch.restype = i
            lib.egnn_edge_list_launch.argtypes = [vp] * 21 + [i, i, i, i, i, i, i, f, vp]
            lib.egnn_edge_list_launch.restype = i
            lib.egnn_edge_dense_smem_bytes.argtypes = [i, i]
            lib.egnn_edge_dense_smem_bytes.restype = ctypes.c_size_t
            lib.egnn_edge_dense_max_h.argtypes = []
            lib.egnn_edge_dense_max_h.restype = i
            lib.egnn_edge_dense_main_kp.argtypes = [i]
            lib.egnn_edge_dense_main_kp.restype = i
            lib.egnn_edge_dense_main_np.argtypes = [i]
            lib.egnn_edge_dense_main_np.restype = i
            lib.egnn_edge_wgmma_probe.argtypes = [vp, vp, vp, vp]
            lib.egnn_edge_wgmma_probe.restype = i
            lib.kpdiff_device_stamp.argtypes = [vp, i, vp]
            lib.kpdiff_device_stamp.restype = i
            lib.kpdiff_capture_kernel_nodes.argtypes = [vp, ctypes.POINTER(ctypes.c_longlong),
                                                        ctypes.POINTER(ctypes.c_longlong)]
            lib.kpdiff_capture_kernel_nodes.restype = i
            lib.egnn_edge_error_string.argtypes = [i]
            lib.egnn_edge_error_string.restype = ctypes.c_char_p
            if lib.egnn_edge_dense_max_h() != MAX_WIDTH or any(
                    (lib.egnn_edge_dense_main_kp(h), lib.egnn_edge_dense_main_np(h)) != main_dims(h)
                    for h in (2, 257, 258, MAX_WIDTH)):
                raise RuntimeError("the library's widths differ from main_dims / MAX_WIDTH")
            if phase_clocks:
                lib.egnn_edge_phase_clocks_read.argtypes = [vp]
                if lib.egnn_edge_phase_clocks_count() != len(PHASES):
                    raise RuntimeError("the profiling build's phases differ from PHASES")
            _libs[phase_clocks] = lib
    return _libs[phase_clocks]


@functools.lru_cache(maxsize=None)
def _width_check(phase_clocks: bool, device_index: int, h: int, bf16: bool):
    """Raise unless the kernel takes width h: its shared memory (which does
    not depend on Ns or Nd) against the card's opt-in limit. Cached per
    (library, device, width, mode): it queries the device."""
    lib = _load(phase_clocks)
    smem = lib.egnn_edge_dense_smem_bytes(h, int(bf16))
    limit = getattr(torch.cuda.get_device_properties(device_index), "shared_memory_per_block_optin", None)
    if limit is not None and smem > limit:
        raise ValueError(f"H={h} needs {smem} bytes of shared memory, the card offers {limit}")


def silu_cd(x: torch.Tensor) -> torch.Tensor:
    """silu as the kernel computes it in x's dtype: in bf16 as the TPU kernel's
    `_silu`, x * (tanh(x / 2) / 2 + 1 / 2) rounded after each operation (the
    kernel's bf16x2 arithmetic); in f32 x * sigmoid(x) (the f32 mode's exact form)."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * (0.5 * torch.tanh(0.5 * x) + 0.5)


def egnn_edge_dense_plain(a_es, a_ed, a_cs, a_cd, w_edij, w_cdij, w2e, b2e, attw, atb,
                          w2c, b2c, wout, x_s, x_d, adj, *, use_tanh: bool, coords_range: float,
                          compute_dtype: torch.dtype):
    """The kernel's function in plain PyTorch, rounding where `_kernel` rounds,
    with the width split into the main block (H - 1 channels) and the last
    channel: a_* rounded to the compute dtype, pre-activations and the
    first layer's and the main block's silu (`silu_cd`) in the compute dtype;
    the main product of compute-dtype operands in f32, then the last
    channel's row term (f32) and the bias, then a cast to the compute dtype;
    the last channel's column as compute-dtype products summed in f32, its
    silu, the gate and every reduction in f32. w2e / w2c: (H, H) weights or
    PackedW2. Returns (agg_h (B,Nd,H), agg_x (B,Nd,3))."""
    cd, f32 = compute_dtype, torch.float32
    hm = a_es.shape[-1] - 1
    adjf = adj.to(f32)
    diff = torch.where(adj[..., None], x_s[:, :, None, :] - x_d[:, None, :, :], 0.0) + 1e-30
    dij = torch.sqrt(torch.sum(diff * diff, dim=-1))  # (B, Ns, Nd)

    def chain(a_s, a_d, w_dij, w2, b2):
        """Returns (m2 (B,Ns,Nd,Hm) compute dtype, e2 (B,Ns,Nd) f32), both after silu."""
        w2 = unpack_w2(w2) if isinstance(w2, PackedW2) else w2
        pre = (a_s.to(cd)[:, :, None, :] + a_d.to(cd)[:, None, :, :]) + dij.to(cd)[..., None] * w_dij.to(cd)
        m1 = silu_cd(pre)
        m1m, e1 = m1[..., :hm], m1[..., hm].to(f32)
        m2 = (m1m.to(f32) @ w2[:hm, :hm].to(cd).to(f32) + e1[..., None] * w2[hm, :hm].to(f32)
              + b2[:hm].to(f32)).to(cd)
        e2 = (torch.sum((m1m * w2[:hm, hm].to(cd)).to(f32), dim=-1) + e1 * w2[hm, hm].to(f32)
              + b2[hm].to(f32))
        return silu_cd(m2), F.silu(e2)

    m, e = chain(a_es, a_ed, w_edij, w2e, b2e)
    gate = torch.sigmoid(torch.sum((m * attw[:hm].to(cd)).to(f32), dim=-1) + e * attw[hm].to(f32)
                         + atb.to(f32)) * adjf
    agg_h = torch.cat([torch.einsum("bsd,bsdh->bdh", gate, m.to(f32)),
                       torch.einsum("bsd,bsd->bd", gate, e)[..., None]], dim=-1)
    c, ce = chain(a_cs, a_cd, w_cdij, w2c, b2c)
    scalar = torch.sum((c * wout[:hm].to(cd)).to(f32), dim=-1) + ce * wout[hm].to(f32)
    if use_tanh:
        scalar = torch.tanh(scalar) * coords_range
    scalar = scalar * adjf / (dij + 1.0)
    agg_x = torch.einsum("bsd,bsdc->bdc", scalar, diff)
    return agg_h, agg_x


def kernel_device(device: torch.device) -> bool:
    """Whether `egnn_edge_dense` launches the kernel on tensors of `device`
    (CUDA) rather than running the plain version (CPU)."""
    return device.type == "cuda"


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _check_rows(name, t, shape, dtype, device):
    """a_*: (B, N, H) rows in the compute dtype at a stride of a multiple of 4 elements, 16-byte aligned."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    b, n, h = shape
    lda = t.stride(1) if n > 1 else t.stride(0) if b > 1 else row_stride(h)
    if (t.stride(2) != 1 or lda % 4 or lda < h or (b > 1 and n > 0 and t.stride(0) != n * lda)
            or t.data_ptr() % 16):
        raise ValueError(f"{name}: rows of stride {t.stride()} are not in the kernel's layout "
                         f"(a row stride that is a multiple of 4 elements, 16-byte aligned: aligned_rows)")
    return lda


def _check_w2(name, w, h, dtype, device):
    if not isinstance(w, PackedW2):
        raise ValueError(f"{name}: the kernel takes W2 packed by pack_w2, got {type(w).__name__}")
    if w.h != h:
        raise ValueError(f"{name}: packed for width {w.h}, the inputs have {h}")
    kp, np_ = main_dims(h)
    _check(f"{name}.main", w.main, (kp * np_,), dtype, device)
    _check(f"{name}.tail", w.tail, (np_ + kp + 4,), torch.float32, device)
    if w.main.data_ptr() % 16:
        raise ValueError(f"{name}.main: not 16-byte aligned")


def egnn_edge_dense(a_es, a_ed, a_cs, a_cd, w_edij, w_cdij, w2e, b2e, attw, atb,
                    w2c, b2c, wout, x_s, x_d, adj, *, use_tanh: bool, coords_range: float,
                    compute_dtype: torch.dtype = torch.bfloat16):
    """Aggregated dense EGNN edge messages: (agg_h (B,Nd,H) f32, agg_x (B,Nd,3) f32).

    a_es/a_cs (B,Ns,H) and a_ed/a_cd (B,Nd,H): first-layer per-node
    projections of the edge and coordinate chains, the first-layer bias
    folded into the destination side, rows in the compute dtype at a stride
    of a multiple of 4 elements (`aligned_rows`; one stride for all four).
    w_edij/w_cdij (H): the distance rows of the
    first layers. w2e/w2c: second-layer weights packed in the compute dtype
    (`pack_w2`). b2e/b2c, attw and wout (H); atb (1). x_s (B,Ns,3),
    x_d (B,Nd,3); adj (B,Ns,Nd) bool.
    """
    args = (a_es, a_ed, a_cs, a_cd, w_edij, w_cdij, w2e, b2e, attw, atb, w2c, b2c, wout, x_s, x_d)
    lda = _check_operands(args, compute_dtype)
    _check_adj(adj, args)
    if not kernel_device(a_es.device):
        return egnn_edge_dense_plain(*args, adj, use_tanh=use_tanh, coords_range=coords_range,
                                     compute_dtype=compute_dtype)
    out = _launch(False, args, (adj,), lda, use_tanh, coords_range, compute_dtype)
    _count(list_mode=False)
    return out


def egnn_edge_list(a_es, a_ed, a_cs, a_cd, w_edij, w_cdij, w2e, b2e, attw, atb,
                   w2c, b2c, wout, x_s, x_d, idx, valid, *, use_tanh: bool, coords_range: float,
                   compute_dtype: torch.dtype = torch.bfloat16):
    """egnn_edge_dense over a destination-major neighbor list in place of
    the mask: source idx[b, d, j] to destination d wherever valid[b, d, j],
    idx (B, Nd, cap) int32 or int64 (cap >= 1), valid (B, Nd, cap) bool; the
    other operands as egnn_edge_dense's. A destination's valid slots name
    distinct sources (as compact_kk's lists do).

    In bf16 on CUDA tensors it launches the kernel's list mode on idx as
    int32; its sums take a destination's rows in slot order (bitwise the
    mask mode's where the valid slots name ascending sources). Elsewhere it
    runs egnn_edge_dense on the list's mask (`NbrList.adjacency`): the plain
    version on CPU tensors, and in f32 on CUDA tensors the f32 mode (the
    check of the algorithm, which has no list mode)."""
    args = (a_es, a_ed, a_cs, a_cd, w_edij, w_cdij, w2e, b2e, attw, atb, w2c, b2c, wout, x_s, x_d)
    lda = _check_operands(args, compute_dtype)
    _check_list(idx, valid, args)
    if not kernel_device(a_es.device) or compute_dtype == torch.float32:
        return egnn_edge_dense(*args, NbrList(idx, valid).adjacency(a_es.shape[1]), use_tanh=use_tanh,
                               coords_range=coords_range, compute_dtype=compute_dtype)
    out = _launch(False, args, (idx.to(torch.int32).contiguous(), valid), lda, use_tanh, coords_range,
                  compute_dtype)
    _count(list_mode=True)
    return out


def _count(list_mode: bool):
    """Counts a kernel launch, or a call recorded while the current stream captures."""
    global launches, captured, list_launches, list_captured
    if torch.cuda.is_current_stream_capturing():
        captured += 1
        list_captured += list_mode
    else:
        launches += 1
        list_launches += list_mode


def phase_clocks(*args, use_tanh: bool, coords_range: float, compute_dtype: torch.dtype) -> dict:
    """One launch of the profiling build on CUDA tensors (egnn_edge_dense's
    arguments): {role: {phase: clocks}}, the SM clocks of each chain's
    consumer warps ("edge", "coordinate") and helper warps ("edge helper",
    "coordinate helper") summed over the launch. Not counted in `launches`;
    the production library is not involved."""
    lib = _load(phase_clocks=True)
    lda = _check_operands(args[:15], compute_dtype)
    _check_adj(args[15], args[:15])
    err = lib.egnn_edge_phase_clocks_reset()
    if err == 0:
        _launch(True, args[:15], args[15:], lda, use_tanh, coords_range, compute_dtype)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (4 * len(PHASES)))()
        err = lib.egnn_edge_phase_clocks_read(ctypes.addressof(buf))
    if err != 0:
        raise RuntimeError(f"phase clocks: {lib.egnn_edge_error_string(err).decode()} ({err})")
    n = len(PHASES)
    return {chain: dict(zip(PHASES, (int(v) for v in buf[i * n:(i + 1) * n])))
            for i, chain in enumerate(("edge", "coordinate", "edge helper", "coordinate helper"))}


def _check_operands(args, compute_dtype) -> int:
    """Shapes, types and layouts of the node and weight operands (both
    entries' first 15) and the compute dtype; returns the a_* row stride."""
    (a_es, a_ed, a_cs, a_cd, w_edij, w_cdij, w2e, b2e, attw, atb, w2c, b2c, wout, x_s, x_d) = args
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute_dtype {compute_dtype} is not supported (float32, bfloat16)")
    if a_es.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the edge kernel runs on CUDA or CPU tensors, got {a_es.device}")
    dev = a_es.device
    b, ns, h = a_es.shape
    nd = a_ed.shape[1]
    main_dims(h)
    ldas = {_check_rows(name, t, shape, compute_dtype, dev)
            for name, t, shape in (("a_es", a_es, (b, ns, h)), ("a_ed", a_ed, (b, nd, h)),
                                   ("a_cs", a_cs, (b, ns, h)), ("a_cd", a_cd, (b, nd, h)))}
    if len(ldas) != 1:
        raise ValueError(f"a_* rows at different strides {sorted(ldas)}")
    for name, t, shape in (("w_edij", w_edij, (h,)), ("w_cdij", w_cdij, (h,)),
                           ("b2e", b2e, (h,)), ("attw", attw, (h,)), ("atb", atb, (1,)),
                           ("b2c", b2c, (h,)), ("wout", wout, (h,)),
                           ("x_s", x_s, (b, ns, 3)), ("x_d", x_d, (b, nd, 3))):
        _check(name, t, shape, torch.float32, dev)
    _check_w2("w2e", w2e, h, compute_dtype, dev)
    _check_w2("w2c", w2c, h, compute_dtype, dev)
    if ns > MAX_SOURCES:
        raise ValueError(f"Ns={ns} exceeds the kernel's limit {MAX_SOURCES} (16-bit source index)")
    return ldas.pop()


def _check_adj(adj, args):
    """The mask (B, Ns, Nd) bool of the operands `args`."""
    _check("adj", adj, (args[0].shape[0], args[0].shape[1], args[1].shape[1]), torch.bool, args[0].device)


def _check_list(idx, valid, args):
    """The neighbor list idx, valid (B, Nd, cap), cap >= 1, of the operands `args`."""
    b, nd = args[1].shape[:2]
    if idx.dim() != 3 or tuple(idx.shape[:2]) != (b, nd) or idx.shape[2] < 1:
        raise ValueError(f"idx: shape {tuple(idx.shape)}, expected ({b}, {nd}, cap >= 1)")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx: dtype {idx.dtype}, expected int32 or int64")
    if idx.device != args[0].device:
        raise ValueError(f"idx: on {idx.device}, expected {args[0].device}")
    _check("valid", valid, idx.shape, torch.bool, args[0].device)


def _launch(clocks: bool, args, edges, lda, use_tanh, coords_range, compute_dtype):
    """One launch on the 15 operands `args` and the edges: (adj,) in the mask
    mode, (idx int32, valid) in the list mode (bf16)."""
    (a_es, a_ed, a_cs, a_cd, w_edij, w_cdij, w2e, b2e, attw, atb, w2c, b2c, wout, x_s, x_d) = args
    dev = a_es.device
    b, ns, h = a_es.shape
    nd = a_ed.shape[1]
    bf16 = compute_dtype == torch.bfloat16
    lib = _load(clocks)
    _width_check(clocks, dev.index if dev.index is not None else torch.cuda.current_device(), h, bf16)

    agg_h = torch.empty((b, nd, h), dtype=torch.float32, device=dev)
    agg_x = torch.empty((b, nd, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [t.data_ptr() for t in (a_es, a_ed, a_cs, a_cd, w_edij, w_cdij, w2e.main, w2e.tail, b2e, attw, atb,
                                       w2c.main, w2c.tail, b2c, wout, x_s, x_d, *edges, agg_h, agg_x)]
        if len(edges) == 1:
            entry = "egnn_edge_dense"
            err = lib.egnn_edge_dense_launch(*ptrs, b, ns, nd, h, lda, int(bool(use_tanh)),
                                             float(coords_range), int(bf16), stream)
        else:
            entry = "egnn_edge_list"
            err = lib.egnn_edge_list_launch(*ptrs, b, ns, nd, int(edges[0].shape[2]), h, lda,
                                            int(bool(use_tanh)), float(coords_range), stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: {lib.egnn_edge_error_string(err).decode()} ({err})")
    return agg_h, agg_x


def wgmma_probe(a: torch.Tensor, main: torch.Tensor) -> torch.Tensor:
    """The kernel's tensor-core product alone on one tile, for the card's
    check: a (64, 256) bf16 @ the main block of a PackedW2 (width <= 257,
    bf16) -> (64, 256) f32, through the kernel's descriptors, fragments and
    channel order. Compare with a.float() @ unpack_w2(...)[:256, :256]."""
    _check("a", a, (64, 256), torch.bfloat16, a.device)
    _check("main", main, (256 * 256,), torch.bfloat16, a.device)
    lib = _load()
    out = torch.empty((64, 256), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = lib.egnn_edge_wgmma_probe(a.data_ptr(), main.data_ptr(), out.data_ptr(),
                                        torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wgmma probe launch failed: {lib.egnn_edge_error_string(err).decode()} ({err})")
    return out


def device_stamp(buf: torch.Tensor, slot: int, stream: int):
    """Queue the tracer's stamp kernel on `stream` (a CUDA stream handle):
    `buf` is a GraphTimers buffer (int64 [previous stamp, replays, ns per
    slot] on the card), `slot` the slot credited (< 0: the replay's first
    stamp). See utils/profiling.py."""
    if buf.dtype != torch.int64 or buf.device.type != "cuda" or not buf.is_contiguous():
        raise ValueError("a stamp buffer is a contiguous int64 CUDA tensor")
    lib = _load()
    with torch.cuda.device(buf.device):
        err = lib.kpdiff_device_stamp(buf.data_ptr(), int(slot), stream)
    if err != 0:
        raise RuntimeError(f"device stamp launch failed: {lib.egnn_edge_error_string(err).decode()} ({err})")


def capture_kernel_nodes(stream: int) -> tuple[int, int]:
    """(kernel nodes, all nodes) of the graph that `stream` is capturing,
    read from the graph itself (cudaGraphGetNodes)."""
    lib = _load()
    kernels, nodes = ctypes.c_longlong(), ctypes.c_longlong()
    err = lib.kpdiff_capture_kernel_nodes(stream, ctypes.byref(kernels), ctypes.byref(nodes))
    if err != 0:
        raise RuntimeError(f"graph node count failed: {lib.egnn_edge_error_string(err).decode()} ({err})")
    return kernels.value, nodes.value


def snapshot_args(args) -> tuple:
    """A copy of egnn_edge_dense's positional arguments that keeps the
    kernel's layouts: a_* rows through `aligned_rows` (a plain clone of a
    row view is contiguous), packed weights as they are (the module's cache
    is rebuilt, not modified, when a parameter changes)."""
    return tuple(aligned_rows(x) if i < 4 else x.clone() if torch.is_tensor(x) else x for i, x in enumerate(args))
