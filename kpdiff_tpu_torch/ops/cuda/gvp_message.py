"""GVP edge messages over a destination-major list: CUDA kernel, wrapper and plain version.

Replaces no TPU kernel: the JAX package runs its GVP messages as XLA
operations, and `kpdiff_tpu_torch/models/gvp.py::GVPEdgeMessages.nbr` is the
reference of the kernel. The CUDA source is `kpdiff_tpu_torch/csrc/
gvp_message.cu`; its header comment says what bounds the kernel and how it
keeps every per-edge tensor on the SM.

The kernel computes one edge type's three-GVP message chain (scalars
S_WIDTH, vector channels V_WIDTH, bf16, no edge or destination features) on
the valid slots of a destination-major list (idx, valid) (B, Nd, cap), and
the per-destination sum or mean over them in f32. Its operands:

- the node rows `a_src` (B, Ns, NODE_WIDTH) in the compute dtype: GVP0's
  per-node pieces, P = h_src @ to_feats_out[:S] and Q = v_src @ Wh[1:] (the
  vector channels as [component][Q_WIDTH], zero past Wh's columns), in one
  product per call (`node_rows`, with `node_matrix`);
- the chain's weights `layers` (a `GVPLayer` per GVP, f32, flax layouts) and
  their kernel images (`pack_weights`): the smaller matrices in mma fragment
  order (`frag_pack`), the biases as f32 values of bf16, and the two
  256 x 256 blocks of GVP1's and GVP2's `to_feats_out` as the 128-byte
  swizzled pieces the wgmma descriptor reads (`b128_pack`).

`gvp_message_list` is the entry: on CUDA tensors (bf16) it launches the
kernel (built with nvcc at first use into `kpdiff_tpu_torch/_build/`, named
by a digest of the source, loaded with ctypes) or raises; on CPU tensors it
runs `gvp_message_list_plain`, the same function in plain PyTorch with the
reference's rounding places (node projection, then the chain on every slot,
then the masked sum or mean). `launches` counts kernel launches; `captured`
the calls recorded into a CUDA graph while a stream captures (the graph
runner, `models/chain_graph.py`, adds a graph's captured count to
`launches` at every replay).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from kpdiff_tpu_torch.ops.cuda.egnn_edge import _nvcc, kernel_device
from kpdiff_tpu_torch.ops.geometry import norm_no_nan, rbf_embed
from kpdiff_tpu_torch.ops.neighbors import gather_rows

launches = 0  # kernel launches (CUDA tensors only), replays of captured ones included
captured = 0  # calls recorded into a CUDA graph (no launch at the call; each replay launches them)

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "gvp_message.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
S_WIDTH, V_WIDTH, RBF_DIM, N_GVPS = 256, 16, 16, 3  # the kernel's chain
Q_WIDTH = 32  # channels a component of Q holds in the node rows (V_WIDTH + 1 used)
NODE_WIDTH = S_WIDTH + 3 * Q_WIDTH
# the fragment-order matrices of `pack_weights`, in the kernel's order: (name, K, N)
FRAG_MATRICES = (("wu0", 2 * V_WIDTH, V_WIDTH), ("kr0", RBF_DIM, S_WIDTH), ("kn0", 2 * V_WIDTH, S_WIDTH),
                 ("g0", S_WIDTH, V_WIDTH)) + tuple(
    (f"{m}{i}", k, n) for i in (1, 2)
    for m, k, n in (("wh", V_WIDTH, V_WIDTH), ("wu", V_WIDTH, V_WIDTH), ("kn", V_WIDTH, S_WIDTH),
                    ("g", S_WIDTH, V_WIDTH)))
VEC_FLOATS = 3 * S_WIDTH + 3 * V_WIDTH + 32 + RBF_DIM
_libs = {}
_lock = threading.Lock()


class GVPLayer(NamedTuple):
    """One GVP of a message chain in flax layouts: Wh (V_in, H), Wu (H, V),
    to_feats_out's kernel (F_in + H, S) and bias (S), the gates' kernel (S, V)
    and bias (V)."""
    wh: torch.Tensor
    wu: torch.Tensor
    k: torch.Tensor
    b: torch.Tensor
    g: torch.Tensor
    gb: torch.Tensor


class GVPMessagePack(NamedTuple):
    """`pack_weights`' kernel images of a chain: frags (int32 words, the
    FRAG_MATRICES in fragment order, bf16 pairs), vecs (VEC_FLOATS f32: the
    three biases and gate biases rounded to bf16, Wh0[0] rounded and padded to
    32, the rbf centres), big (bf16, GVP1's then GVP2's to_feats_out[:S] as
    b128_pack images) and sigma (the rbf width)."""
    frags: torch.Tensor
    vecs: torch.Tensor
    big: torch.Tensor
    sigma: float


def _frag_index(kp: int, np_: int, device):
    """(rows, cols) of each bf16 element of a (kp, np_) matrix in fragment order:
    [k-step][N-tile][lane][word][half]; word 0 holds k 2q, 2q + 1 and word 1
    k 2q + 8, 2q + 9 of column g (g = lane // 4, q = lane % 4)."""
    kt, nt, lane, e, h = torch.meshgrid(*(torch.arange(n, device=device) for n in (kp // 16, np_ // 8, 32, 2, 2)),
                                        indexing="ij")
    return 16 * kt + 2 * (lane % 4) + 8 * e + h, 8 * nt + lane // 4


def frag_pack(w: torch.Tensor) -> torch.Tensor:
    """(K, N) matrix -> int32 words of its bf16 mma B fragments (m16n8k16),
    K zero padded to a multiple of 16 and N to a multiple of 8."""
    k, n = w.shape
    kp, np_ = -(-k // 16) * 16, -(-n // 8) * 8
    dense = torch.zeros((kp, np_), dtype=torch.bfloat16, device=w.device)
    dense[:k, :n] = w.detach()
    rows, cols = _frag_index(kp, np_, w.device)
    return dense[rows, cols].contiguous().view(torch.int32).reshape(-1)


def frag_unpack(words: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """frag_pack's words -> the (K, N) f32 matrix (as rounded to bf16)."""
    kp, np_ = -(-k // 16) * 16, -(-n // 8) * 8
    rows, cols = _frag_index(kp, np_, words.device)
    dense = torch.zeros((kp, np_), dtype=torch.bfloat16, device=words.device)
    dense[rows, cols] = words.contiguous().view(torch.bfloat16).reshape(rows.shape)
    return dense[:k, :n].float()


def _b128_offsets(device) -> torch.Tensor:
    """(S, S): offset of element (k, n) in the pieces of a b128_pack image."""
    k = torch.arange(S_WIDTH, device=device)[:, None]
    n = torch.arange(S_WIDTH, device=device)[None, :]
    nl, kk = n % 128, k % 64
    return (((n // 128) * 4 + k // 64) * 128 + nl) * 64 + ((kk // 8) ^ (nl % 8)) * 8 + kk % 8


def b128_pack(w: torch.Tensor) -> torch.Tensor:
    """(S, S) matrix (in, out) -> its bf16 image as the kernel's weight ring
    reads it: 8 pieces of 64 K x 128 N, (N half, K-block) in order, each the
    128 N rows of 64 K elements with the 16-byte chunks of a row swizzled by
    row % 8 (the 128-byte swizzle of a K-major wgmma operand)."""
    if tuple(w.shape) != (S_WIDTH, S_WIDTH):
        raise ValueError(f"a {S_WIDTH} x {S_WIDTH} block, got {tuple(w.shape)}")
    img = torch.empty(S_WIDTH * S_WIDTH, dtype=torch.bfloat16, device=w.device)
    img[_b128_offsets(w.device).reshape(-1)] = w.detach().to(torch.bfloat16).reshape(-1)
    return img


def b128_unpack(img: torch.Tensor) -> torch.Tensor:
    """b128_pack's image -> the (S, S) f32 matrix (as rounded to bf16)."""
    return img[_b128_offsets(img.device)].float()


def rbf_centres(rbf_dmax: float, device) -> torch.Tensor:
    return torch.linspace(0.0, rbf_dmax, RBF_DIM, dtype=torch.float32, device=device)


def _bf16_values(t: torch.Tensor) -> torch.Tensor:
    return t.detach().reshape(-1).to(torch.bfloat16).float()


def pack_weights(layers: Sequence[GVPLayer], rbf_dmax: float) -> GVPMessagePack:
    """The kernel's images of a chain's weights (GVPMessagePack)."""
    l0, l1, l2 = layers
    s = S_WIDTH
    mats = dict(wu0=l0.wu, kr0=l0.k[s:s + RBF_DIM], kn0=l0.k[s + RBF_DIM:], g0=l0.g)
    for i, layer in ((1, l1), (2, l2)):
        mats.update({f"wh{i}": layer.wh, f"wu{i}": layer.wu, f"kn{i}": layer.k[s:], f"g{i}": layer.g})
    for name, k, n in FRAG_MATRICES:
        if mats[name].shape[0] > k or mats[name].shape[1] != n:
            raise ValueError(f"{name}: shape {tuple(mats[name].shape)} outside the kernel's ({k}, {n})")
    frags = torch.cat([frag_pack(mats[name]) for name, _, _ in FRAG_MATRICES])
    dev = l0.b.device
    wh0 = torch.zeros(32, dtype=torch.float32, device=dev)
    wh0[:l0.wh.shape[1]] = _bf16_values(l0.wh[0])
    vecs = torch.cat([_bf16_values(l.b) for l in layers] + [_bf16_values(l.gb) for l in layers]
                     + [wh0, rbf_centres(rbf_dmax, dev)])
    big = torch.cat([b128_pack(l1.k[:s]), b128_pack(l2.k[:s])])
    return GVPMessagePack(frags, vecs.contiguous(), big, float(rbf_dmax) / RBF_DIM)


def unpack_weights(pack: GVPMessagePack) -> dict:
    """pack_weights' images -> {name: f32 matrix} of the FRAG_MATRICES, with
    'big1' and 'big2' (the 256 x 256 blocks) and the vectors by part."""
    out, off = {}, 0
    for name, k, n in FRAG_MATRICES:
        words = (k // 16) * (n // 8) * 64
        out[name] = frag_unpack(pack.frags[off:off + words], k, n)
        off += words
    half = S_WIDTH * S_WIDTH
    out["big1"], out["big2"] = b128_unpack(pack.big[:half]), b128_unpack(pack.big[half:])
    v, s, n = pack.vecs, S_WIDTH, V_WIDTH
    out.update(b=v[:3 * s].reshape(3, s), gb=v[3 * s:3 * s + 3 * n].reshape(3, n),
               wh0=v[3 * s + 3 * n:3 * s + 3 * n + 32], mu=v[3 * s + 3 * n + 32:])
    return out


def node_matrix(layers: Sequence[GVPLayer], dtype: torch.dtype) -> torch.Tensor:
    """(S + 3 V, NODE_WIDTH) in dtype: [h_src, v_src flattened as (V, 3)] @ it
    gives P = h_src @ to_feats_out[:S] in columns :S and Q = v_src @ Wh[1:] as
    [component][Q_WIDTH] after them (zero past Wh's columns)."""
    l0 = layers[0]
    s, (v, nh) = l0.k.shape[1], l0.wh[1:].shape
    w = torch.zeros((s + 3 * v, s + 3 * Q_WIDTH), dtype=torch.float32, device=l0.k.device)
    w[:s, :s] = l0.k[:s].detach()
    blk = torch.zeros((v, 3, 3, Q_WIDTH), dtype=torch.float32, device=w.device)  # [v, c_in, c_out, ch]
    for c in range(3):
        blk[:, c, c, :nh] = l0.wh[1:].detach()
    w[s:, s:] = blk.reshape(3 * v, 3 * Q_WIDTH)
    return w.to(dtype)


def node_rows(h_src: torch.Tensor, v_src: torch.Tensor, node_w: torch.Tensor) -> torch.Tensor:
    """GVP0's per-node pieces (B, Ns, S + 3 Q_WIDTH) in node_w's dtype: one
    product of [h_src, v_src] (rounded to that dtype) by `node_matrix`."""
    cd = node_w.dtype
    x = torch.cat([h_src.to(cd), v_src.to(cd).flatten(-2)], dim=-1)
    return x @ node_w


def gvp_message_list_plain(a_src, x_src, x_dst, layers: Sequence[GVPLayer], idx, valid, *, mean: bool,
                           rbf_dmax: float, compute_dtype: torch.dtype):
    """The kernel's function in plain PyTorch, rounding where the reference
    (`GVPEdgeMessages.nbr`) rounds: the node rows gathered, the chain in the
    compute dtype on every slot (offsets of slots that are not valid zeroed),
    then the masked sum over the slots in f32, divided by the valid count
    (clamped at 1) for the mean. -> (B, Nd, S), (B, Nd, V, 3) f32."""
    cd = compute_dtype
    l0 = layers[0]
    s, nh = l0.k.shape[1], l0.wh.shape[1]
    b, ns = a_src.shape[:2]
    nq = (a_src.shape[-1] - s) // 3
    idx = idx.long()

    def lin(x, w):
        return x.to(cd) @ w.to(cd)

    def vlin(v, w):
        return torch.einsum("...vc,vh->...hc", v.to(cd), w.to(cd))

    def cnorm(v):
        return torch.sqrt(torch.clamp(torch.sum(torch.square(v.float()), dim=-1), min=1e-8)).to(cd)

    def gated(f, vu, layer):
        return torch.sigmoid(lin(f, layer.g) + layer.gb.to(cd))[..., None] * vu

    p = gather_rows(a_src[..., :s], idx)
    q = gather_rows(a_src[..., s:].reshape(b, ns, 3, nq)[..., :nh].transpose(-1, -2), idx)
    diff = torch.where(valid[..., None], gather_rows(x_src, idx) - x_dst[:, :, None, :], 0.0)
    dij = norm_no_nan(diff, keepdim=True) + 1e-8
    rbf = rbf_embed(dij[..., 0], 0.0, rbf_dmax, RBF_DIM)
    vh = vlin((diff / dij)[..., None, :], l0.wh[:1]) + q
    f = F.silu(p + lin(rbf, l0.k[s:s + RBF_DIM]) + lin(cnorm(vh), l0.k[s + RBF_DIM:]) + l0.b.to(cd))
    v = gated(f, vlin(vh, l0.wu), l0)
    for layer in layers[1:]:
        vh = vlin(v, layer.wh)
        f = F.silu(lin(torch.cat([f, cnorm(vh)], dim=-1), layer.k) + layer.b.to(cd))
        v = gated(f, vlin(vh, layer.wu), layer)
    vf = valid[..., None].to(f.dtype)
    agg_s = torch.sum((f * vf).float(), dim=2)
    agg_v = torch.sum((v * vf[..., None]).float(), dim=2)
    if mean:
        cnt = torch.clamp(torch.sum(vf.float(), dim=2), min=1.0)
        agg_s, agg_v = agg_s / cnt, agg_v / cnt[..., None]
    return agg_s, agg_v


def gvp_message_list(a_src, x_src, x_dst, layers: Sequence[GVPLayer], idx, valid, *, mean: bool, rbf_dmax: float,
                     compute_dtype: torch.dtype = torch.bfloat16, pack: GVPMessagePack | None = None):
    """Aggregated GVP messages over a destination-major list:
    (agg_s (B, Nd, S) f32, agg_v (B, Nd, V, 3) f32).

    a_src (B, Ns, NODE_WIDTH): `node_rows` in the compute dtype; x_src
    (B, Ns, 3), x_dst (B, Nd, 3) f32; layers: the chain's GVPLayers; idx
    (B, Nd, cap) int32 or int64 source indices, valid (B, Nd, cap) bool;
    mean: divide each destination's sums by its valid slots (clamped at 1).
    On CUDA tensors the kernel (bf16 only; `pack`, pack_weights' images, is
    made from `layers` when not given); on CPU tensors the plain version."""
    b, nd = x_dst.shape[:2]
    if idx.dim() != 3 or tuple(idx.shape[:2]) != (b, nd) or idx.shape[2] < 1:
        raise ValueError(f"idx: shape {tuple(idx.shape)}, expected ({b}, {nd}, cap >= 1)")
    if tuple(valid.shape) != tuple(idx.shape) or valid.dtype != torch.bool:
        raise ValueError(f"valid: {valid.dtype} {tuple(valid.shape)}, expected bool {tuple(idx.shape)}")
    if not kernel_device(a_src.device):
        return gvp_message_list_plain(a_src, x_src, x_dst, layers, idx, valid, mean=mean, rbf_dmax=rbf_dmax,
                                      compute_dtype=compute_dtype)
    if compute_dtype != torch.bfloat16:
        raise TypeError(f"the GVP message kernel computes in bfloat16, not {compute_dtype}")
    pack = pack_weights(layers, rbf_dmax) if pack is None else pack
    dev = a_src.device
    ns = a_src.shape[1]
    for name, t, shape, dtype in (("a_src", a_src, (b, ns, NODE_WIDTH), torch.bfloat16),
                                  ("x_src", x_src, (b, ns, 3), torch.float32),
                                  ("x_dst", x_dst, (b, nd, 3), torch.float32),
                                  ("frags", pack.frags, (sum(k * n // 2 for _, k, n in FRAG_MATRICES),), torch.int32),
                                  ("vecs", pack.vecs, (VEC_FLOATS,), torch.float32),
                                  ("big", pack.big, (2 * S_WIDTH * S_WIDTH,), torch.bfloat16)):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}, expected a contiguous "
                             f"{dtype} {shape} on {dev}")
    if idx.device != dev or valid.device != dev:
        raise ValueError(f"idx, valid: on {idx.device}, {valid.device}, expected {dev}")
    idx32 = idx.to(torch.int32).contiguous()
    valid = valid.contiguous()
    lib = _load()
    _smem_check(dev.index if dev.index is not None else torch.cuda.current_device())
    out_s = torch.empty((b, nd, S_WIDTH), dtype=torch.float32, device=dev)
    out_v = torch.empty((b, nd, V_WIDTH, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.gvp_message_launch(*(t.data_ptr() for t in (a_src, x_src, x_dst, idx32, valid, pack.frags,
                                                              pack.vecs, pack.big, out_s, out_v)),
                                     b, ns, nd, int(idx.shape[2]), int(bool(mean)), float(pack.sigma),
                                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gvp_message kernel launch failed: {lib.gvp_message_error_string(err).decode()} ({err})")
    _count()
    return out_s, out_v


def _count():
    """Counts a kernel launch, or a call recorded while the current stream captures."""
    global launches, captured
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1


def library_path() -> Path:
    """The shared library of the current source: named by a digest of its content."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libgvp_message_{digest}.so"


def build(verbose: bool = False) -> Path:
    """Compile csrc/gvp_message.cu for sm_90a into _build/ unless the library
    of this source is there. Returns its path; raises with nvcc's output on
    failure; verbose prints ptxas' registers and spills."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{lib.name}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler",
           "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    if verbose:
        print(proc.stderr.strip())
    os.replace(tmp, lib)
    return lib


def _load():
    with _lock:
        if not _libs:
            lib = ctypes.CDLL(str(build()))
            vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.gvp_message_launch.argtypes = [vp] * 10 + [i] * 5 + [f, vp]
            lib.gvp_message_launch.restype = i
            lib.gvp_message_smem_bytes.restype = ctypes.c_size_t
            lib.gvp_message_error_string.argtypes = [i]
            lib.gvp_message_error_string.restype = ctypes.c_char_p
            if (lib.gvp_message_frag_words() != sum(k * n // 2 for _, k, n in FRAG_MATRICES)
                    or lib.gvp_message_vec_floats() != VEC_FLOATS or lib.gvp_message_node_width() != NODE_WIDTH):
                raise RuntimeError("the library's operand sizes differ from FRAG_MATRICES / VEC_FLOATS / NODE_WIDTH")
            _libs[0] = lib
    return _libs[0]


@functools.lru_cache(maxsize=None)
def _smem_check(device_index: int):
    """Raise unless the card offers the kernel's shared memory (cached per device)."""
    smem = _load().gvp_message_smem_bytes()
    limit = getattr(torch.cuda.get_device_properties(device_index), "shared_memory_per_block_optin", None)
    if limit is not None and smem > limit:
        raise ValueError(f"the GVP message kernel needs {smem} bytes of shared memory, the card offers {limit}")
