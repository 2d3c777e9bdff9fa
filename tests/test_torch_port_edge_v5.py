"""The operands and the plain version of the dense EGNN edge kernel v5, on the CPU.

Kernel v5 (kpdiff_tpu_torch/csrc/egnn_edge.cu) splits the width as the TPU
kernel does (kpdiff_tpu/ops/pallas/egnn_edge.py::fused_dense_edge_split):
a main block of H - 1 channels, whose second layer it reads as an image
packed once on the host (`pack_w2`), and the last channel. Here:
  * the packing round-trips bitwise, and its image puts each weight where
    the kernel's index formula (csrc `main_index`) looks for it;
  * the kernel's plain version, through the wrapper on CPU tensors (packed
    weights, rows in the kernel's layout), is held against the Pallas
    kernel in interpret mode (as tests/test_pallas_egnn.py runs it), at the
    two shipped widths. Tolerances as tests/test_torch_port_egnn.py: f32
    rtol 1e-4, atol 1e-5; bf16 max abs error at most 2e-2 of the output's
    max abs value (the frameworks round silu and sum in different orders);
  * the wrapper refuses widths, dtypes and operand formats the kernel does
    not take, with the exception types it always raised.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kpdiff_tpu.ops.pallas.egnn_edge import fused_dense_edge_split
from kpdiff_tpu_torch.ops.cuda import egnn_edge
from torch_port_util import assert_close, assert_rel_max, t

F32 = dict(rtol=1e-4, atol=1e-5)
BF16_REL = 2e-2
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _main_index(k, n, np_):
    """csrc/egnn_edge.cu::main_index, written out again."""
    r = k & 15
    j = (k & ~15) | (((r >> 1) & 1) << 3) | ((r >> 2) << 1) | (r & 1)
    kb, c, e = j >> 6, (j >> 3) & 7, j & 7
    return (kb * np_ + n) * 64 + ((c ^ (n & 7)) << 3) + e


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [64, 256, 257, 288])
def test_pack_w2_round_trips_bitwise(h, dtype):
    cd = DTYPES[dtype]
    rng = np.random.default_rng(h)
    w = t(rng.normal(size=(h, h)).astype(np.float32))
    packed = egnn_edge.pack_w2(w, cd)
    kp, np_ = egnn_edge.main_dims(h)
    hm = h - 1
    assert packed.main.dtype == cd and packed.main.shape == (kp * np_,) and packed.main.is_contiguous()
    assert packed.tail.dtype == torch.float32 and packed.tail.shape == (np_ + kp + 4,)
    want = w.clone()
    want[:hm, :hm] = w[:hm, :hm].to(cd).float()  # the main block holds the compute dtype's values
    assert torch.equal(egnn_edge.unpack_w2(packed), want)
    # the t-channel's row, column and corner in f32, zero padded
    assert torch.equal(packed.tail[:hm], w[hm, :hm]) and not packed.tail[hm:np_].any()
    assert torch.equal(packed.tail[np_:np_ + hm], w[:hm, hm]) and not packed.tail[np_ + hm:np_ + kp].any()
    assert packed.tail[np_ + kp] == w[hm, hm] and not packed.tail[np_ + kp + 1:].any()
    # every main weight sits where the kernel looks for it; the padding is zero
    k, n = np.meshgrid(np.arange(hm), np.arange(hm), indexing="ij")
    idx = torch.from_numpy(_main_index(k, n, np_).astype(np.int64))
    assert torch.equal(packed.main[idx].float(), want[:hm, :hm])
    rest = torch.ones(kp * np_, dtype=torch.bool)
    rest[idx.reshape(-1)] = False
    assert not packed.main[rest].any()


def _inputs(b, ns, nd, h, seed):
    rng = np.random.default_rng(seed)
    bw = 1.0 / np.sqrt(h)

    def u(*shape, scale=bw):
        return rng.uniform(-scale, scale, size=shape).astype(np.float32)

    return dict(
        a_es=rng.normal(size=(b, ns, h)).astype(np.float32), a_ed=rng.normal(size=(b, nd, h)).astype(np.float32),
        a_cs=rng.normal(size=(b, ns, h)).astype(np.float32), a_cd=rng.normal(size=(b, nd, h)).astype(np.float32),
        w_edij=rng.normal(size=h).astype(np.float32), w_cdij=rng.normal(size=h).astype(np.float32),
        w2e=u(h, h), b2e=u(h), attw=u(h), atb=u(1), w2c=u(h, h), b2c=u(h), wout=u(h, scale=bw * 0.1),
        x_s=(rng.normal(size=(b, ns, 3)) * 3).astype(np.float32),
        x_d=(rng.normal(size=(b, nd, 3)) * 3).astype(np.float32),
        adj=rng.random((b, ns, nd)) < 0.5)


def _pallas(x, cd):
    """fused_dense_edge_split in interpret mode on the inputs' split operands."""
    j = {k: jnp.asarray(v) for k, v in x.items()}
    split = [part for name in ("a_es", "a_ed", "a_cs", "a_cd") for part in (j[name][..., :-1], j[name][..., -1:])]
    agg_h, agg_x = fused_dense_edge_split(
        *split, j["w_edij"][None], j["w_cdij"][None], j["w2e"], j["b2e"], j["attw"][:, None], j["atb"],
        j["w2c"], j["b2c"], j["wout"][:, None], j["x_s"], j["x_d"], j["adj"], use_tanh=True, coords_range=10.0,
        compute_dtype=jnp.dtype(cd), interpret=True)
    return np.asarray(agg_h), np.asarray(agg_x)


def _port_args(x, cd):
    """egnn_edge_dense's arguments as the module hands them over: a_* rows in the
    kernel's layout, second layers packed in the compute dtype."""
    a = {k: t(v) for k, v in x.items()}
    rows = [egnn_edge.aligned_rows(a[k], cd) for k in ("a_es", "a_ed", "a_cs", "a_cd")]
    return (*rows, a["w_edij"], a["w_cdij"], egnn_edge.pack_w2(a["w2e"], cd), a["b2e"], a["attw"], a["atb"],
            egnn_edge.pack_w2(a["w2c"], cd), a["b2c"], a["wout"], a["x_s"], a["x_d"], a["adj"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ns,nd", [(8, 8), (8, 13), (13, 8), (13, 13)])
@pytest.mark.parametrize("h", [257, 256])
def test_plain_version_matches_pallas_split(h, ns, nd, dtype):
    cd = DTYPES[dtype]
    x = _inputs(2, ns, nd, h, seed=h + 10 * ns + nd)
    want = _pallas(x, dtype)
    args = _port_args(x, cd)
    kw = dict(use_tanh=True, coords_range=10.0, compute_dtype=cd)
    before = egnn_edge.launches
    got = egnn_edge.egnn_edge_dense(*args, **kw)
    assert egnn_edge.launches == before  # CPU tensors: the plain version, no launch
    for g, w_, part in zip(got, want, ("agg_h", "agg_x")):
        assert g.shape == w_.shape and g.dtype == torch.float32
        if dtype == "float32":
            assert_close(g, w_, msg=part, **F32)
        else:
            assert_rel_max(g, w_, BF16_REL, msg=part)
    # the training path hands the plain version the raw (H, H) weights: the same function, bitwise
    raw = list(args)
    raw[6], raw[10] = t(x["w2e"]), t(x["w2c"])
    for g, r in zip(got, egnn_edge.egnn_edge_dense_plain(*raw, **kw)):
        assert torch.equal(g, r)


def _refusal_case(case):
    x = _inputs(2, 5, 4, 20, seed=7)
    cd = torch.float32
    args = list(_port_args(x, cd))
    kw = dict(use_tanh=True, coords_range=10.0, compute_dtype=cd)
    if case == "width":  # wider than the kernel's shared memory holds
        wide = (2, 5, egnn_edge.MAX_WIDTH + 1)
        args[0], args[2] = (egnn_edge.aligned_rows(torch.ones(wide)) for _ in range(2))
    elif case == "compute_dtype":
        kw["compute_dtype"] = torch.float16
    elif case == "a_dtype":
        args[0] = args[0].double()
    elif case == "rows_layout":  # contiguous rows of an odd width: not 16-byte aligned
        y = _inputs(2, 5, 4, 21, seed=9)
        args = list(_port_args(y, cd))
        args[0] = args[0].contiguous()
    elif case == "raw_w2":
        args[6] = t(x["w2e"])
    elif case == "w2_dtype":
        args[10] = egnn_edge.pack_w2(t(x["w2c"]), torch.bfloat16)
    elif case == "w2_width":
        args[6] = egnn_edge.pack_w2(t(np.ones((24, 24), np.float32)), cd)
    return args, kw


@pytest.mark.parametrize("case,exc", [("width", ValueError), ("compute_dtype", TypeError), ("a_dtype", TypeError),
                                      ("rows_layout", ValueError), ("raw_w2", ValueError),
                                      ("w2_dtype", TypeError), ("w2_width", ValueError)])
def test_wrapper_refuses_what_the_kernel_does_not_take(case, exc):
    args, kw = _refusal_case(case)
    with pytest.raises(exc):
        egnn_edge.egnn_edge_dense(*args, **kw)
    if case == "width":
        with pytest.raises(ValueError):
            egnn_edge.pack_w2(torch.zeros(egnn_edge.MAX_WIDTH + 1, egnn_edge.MAX_WIDTH + 1), torch.float32)
