"""The port's reverse chain as replays of one captured step, on the CPU.

kpdiff_tpu runs the chain as one jitted lax.scan; the port captures one
`KeypointDiffusion.reverse_step` into a CUDA graph and replays it K times
(models/chain_graph.py). A CUDA graph cannot run here, so the tests drive
the graph runner with its host stand-in (`host_capture`): the step is built
once, its static buffers are filled once per run, and every "replay" calls
the step on the same buffers, as a graph replays its kernels on them.

  (a) replay semantics: the runner's chain equals the eager loop bitwise
      (injected noise and generator draws) and kpdiff_tpu's sample with the
      same injected noise at the slice tolerances (f32 rtol 1e-4 / atol
      1e-4; bf16 against the JAX Pallas path in interpret mode, 2e-2 of the
      output's scale): full, strided, eta=0, frames (not aliased), fake
      atoms, a neighbor-list kk;
  (b) a capture audit: one step's ATen ops, recorded with a
      TorchDispatchMode after a warm-up step for the flagship, egnn_ca on compact_kk's list
      (on the list route, and on the kernel's route as its dense mask, with
      the dynamics made to see a kernel device), gvp_40kp, kl_k 0 and ll_k
      16, hold no host synchronisation, no
      data-dependent shape and no tensor built from host data, and two
      successive steps issue the same ops with the same host arguments (a
      graph freezes every host value of the step it captured);
  (c) graph-cache keys: a parameter update, a bucket, a kk cap, eta and
      the generator each give a new graph; the cache stays bounded;
  (d) KeypointSampler's chunks: repeat-padded to batch_size, field by field
      the complexes kpdiff_tpu's sampler builds for the same request.
"""
import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from kpdiff_tpu.config import PaddingConfig as JPaddingConfig, load_config as jload, model_from_config as jmodel
from kpdiff_tpu.models.complex import synthetic_batch as jsyn
from kpdiff_tpu.serve import KeypointSampler as JKeypointSampler
from kpdiff_tpu_torch.config import PaddingConfig, dump_yaml, model_from_config as tmodel, resolve_feature_sizes
from kpdiff_tpu_torch.cli import import_params
from kpdiff_tpu_torch.data.molgen import molgen_splits_for_config
from kpdiff_tpu_torch.models import dynamics_egnn
from kpdiff_tpu_torch.models.chain_graph import ChainGraphs, host_capture
from kpdiff_tpu_torch.models.egnn import EGNNEdge
from kpdiff_tpu_torch.models.complex import synthetic_batch as tsyn
from kpdiff_tpu_torch.models.size_dist import save_dataset_histogram
from kpdiff_tpu_torch.ops.neighbors import radius_neighbor_list
from kpdiff_tpu_torch.parallel.kp_shard import ShardContext
from kpdiff_tpu_torch.serve import KeypointSampler, decode_ligands
from kpdiff_tpu_torch.utils.params_io import export_flat, save_keystr_npz
from test_cli import TINY_CONFIG
from test_torch_port_slice import _models, reduced_config
from torch_port_util import assert_close, assert_rel_max, family_setup, reduce_family

ROOT = Path(__file__).resolve().parents[1]
SYN = dict(batch=3, n_rec_pad=40, n_lig_pad=12, n_kp=6, kp_feat_dim=12, n_ip_pad=8, min_rec=30, min_lig=6)
OUT_KEYS = ("lig_x", "lig_h", "kp_x", "lig_mask")
MODES = {"full": ({}, 8), "strided": (dict(sample_steps=4), 4), "ddim_eta0": (dict(sample_steps=4, eta=0.0), 4),
         "frames": (dict(return_every=3), 8), "fake_atoms": ({}, 8), "nbr_kk": (dict(sample_steps=4), 4)}


def _noise(seed, steps, f, b=3, n=12):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(np.float32) for k, s in
            (("init_x", (b, n, 3)), ("init_h", (b, n, f)), ("steps_x", (steps, b, n, 3)),
             ("steps_h", (steps, b, n, f)))}


def _host_graphs(model, **kw) -> ChainGraphs:
    model.chain_graphs = ChainGraphs(capture=host_capture, **kw)
    return model.chain_graphs


def _equal(a, b, keys):
    for k in keys:
        assert torch.equal(a[k], b[k]), k


_SETUPS = {}


def _setup(fake_atoms: bool):
    """(JAX model, params, port model, JAX enc, kk, port enc, kk) of the
    slice's reduced f32 egnn_40kp (with fake atoms: max_fake_atom_frac 0.3,
    one more ligand feature)."""
    if fake_atoms not in _SETUPS:
        cfg = reduced_config()
        if fake_atoms:
            cfg["dataset"]["max_fake_atom_frac"] = 0.3
        jm, params, tm = _models(cfg)
        syn = dict(SYN, n_lig_feat=tm.cfg.atom_nf)
        jenc, jkk = jm.encode(params, jsyn(0, **syn))
        with torch.no_grad():
            tenc, tkk = tm.encode(tsyn(0, **syn))
        _SETUPS[fake_atoms] = (jm, params, tm, jenc, jkk, tenc, tkk)
    return _SETUPS[fake_atoms]


# ---- (a) replay semantics

@pytest.mark.parametrize("mode", list(MODES))
def test_replays_equal_eager_and_jax(mode):
    jm, params, tm, jenc, jkk, tenc, tkk = _setup(mode == "fake_atoms")
    kw, steps = MODES[mode]
    if mode == "nbr_kk":
        jkk, tkk = jm.compact_kk(jenc, jkk, align=1), tm.compact_kk(tenc, tkk, align=1)
        assert isinstance(tkk, tuple)
    keys = OUT_KEYS + (("frames_x", "frames_h") if mode == "frames" else ())
    noise = _noise(1, steps, tm.cfg.atom_nf)
    graphs = _host_graphs(tm)
    eager = tm.sample(tenc, tkk, noise=noise, cuda_graph=False, **kw)
    replayed = tm.sample(tenc, tkk, noise=noise, cuda_graph=True, **kw)
    again = tm.sample(tenc, tkk, noise=noise, cuda_graph=True, **kw)  # a cache hit: replays only
    _equal(replayed, eager, keys)
    _equal(again, eager, keys)
    assert len(graphs.captures) == 1 and graphs.last.replays == 2 * steps - 1
    want = jm.sample(params, jax.random.key(0), jenc, jkk, noise={k: jnp.asarray(v) for k, v in noise.items()},
                     **kw)
    for k in keys[:3] + keys[4:]:
        assert_close(replayed[k], want[k], rtol=1e-4, atol=1e-4, msg=k)
    np.testing.assert_array_equal(replayed["lig_mask"].numpy(), np.asarray(want["lig_mask"]))
    if mode == "frames":  # frames are clones of the state, not views of the static buffers
        f = replayed["frames_x"]
        assert f.shape[0] == 3 and not torch.equal(f[0], f[1]) and not torch.equal(f[1], f[2])
    if mode == "fake_atoms":
        assert tm.cfg.use_fake_atoms
    # draws: the same generator state gives the same chain
    gen = torch.Generator().manual_seed(11)
    eager = tm.sample(tenc, tkk, generator=gen, cuda_graph=False, **kw)
    replayed = tm.sample(tenc, tkk, generator=gen.manual_seed(11), cuda_graph=True, **kw)
    _equal(replayed, eager, keys)


def test_replays_bf16_match_jax_pallas():
    """bf16 pair MLPs: the runner's chain equals the eager loop bitwise, and
    the JAX sampler's Pallas path (interpret mode) within 2e-2 of scale."""
    jm, params, tm = _models(reduced_config("bfloat16", T=2), pallas=True)
    jenc, jkk = jm.encode(params, jsyn(0, **SYN))
    with torch.no_grad():
        tenc, tkk = tm.encode(tsyn(0, **SYN))
    noise = _noise(2, 2, 10)
    _host_graphs(tm)
    eager = tm.sample(tenc, tkk, noise=noise, cuda_graph=False)
    replayed = tm.sample(tenc, tkk, noise=noise, cuda_graph=True)
    _equal(replayed, eager, OUT_KEYS)
    want = jm.sample(params, jax.random.key(0), jenc, jkk, noise={k: jnp.asarray(v) for k, v in noise.items()})
    for k in ("lig_x", "lig_h"):
        assert_rel_max(replayed[k], want[k], 2e-2, msg=k)


def test_graph_mode_choice():
    """cuda_graph=None is eager on the CPU; True raises on CPU tensors and
    with a kp_shard; False and None give the same chain."""
    _, _, tm, _, _, tenc, tkk = _setup(False)
    tm.chain_graphs = ChainGraphs()
    noise = _noise(3, 2, 10)
    auto = tm.sample(tenc, tkk, noise=noise, sample_steps=2)
    _equal(auto, tm.sample(tenc, tkk, noise=noise, sample_steps=2, cuda_graph=False), OUT_KEYS)
    assert len(tm.chain_graphs) == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        tm.sample(tenc, tkk, noise=noise, sample_steps=2, cuda_graph=True)
    with pytest.raises(ValueError, match="kp-sharded"):
        tm.sample(tenc, tkk, noise=noise, sample_steps=2, cuda_graph=True,
                  kp_shard=ShardContext.__new__(ShardContext))


# ---- (b) the capture audit

HOST_OPS = {"_local_scalar_dense", "item", "is_nonzero", "equal", "nonzero", "masked_select", "unique",
            "_unique", "_unique2", "unique_dim", "unique_consecutive", "lift_fresh", "lift_fresh_copy"}


def _host_args(x):
    """The host-side part of an op's arguments: tensors as shape and type only."""
    if torch.is_tensor(x):
        return ("tensor", tuple(x.shape), str(x.dtype))
    if isinstance(x, (list, tuple)):
        return tuple(_host_args(y) for y in x)
    if isinstance(x, dict):
        return tuple((k, _host_args(v)) for k, v in sorted(x.items()))
    if isinstance(x, torch.Generator):  # the dispatcher wraps it anew at every op: compare its seed
        return ("generator", x.initial_seed())
    return x


class OpLog(TorchDispatchMode):
    """Every ATen op dispatched inside, with its host-side arguments."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops.append((func.overloadpacket.__name__, str(func), _host_args(args), _host_args(kwargs)))
        return func(*args, **kwargs)


def _audit_model(name):
    """(port model, encoded complex, kk) of a step configuration of the audit."""
    if name in ("flagship", "kl_k0", "ll_k16"):
        cfg = reduced_config()
        cfg["dynamics"].update({"flagship": {}, "kl_k0": dict(kl_k=0), "ll_k16": dict(ll_k=16)}[name])
        tm = tmodel(cfg, device="cpu")
        cpx = tsyn(0, **SYN)
    else:
        cfg = reduce_family(jload(ROOT / f"configs/{name.split(':')[0]}.yml"))
        _, _, tm, cpx, _ = family_setup(cfg)
    with torch.no_grad():
        enc, kk = tm.encode(cpx)
        kk = tm.compact_kk(enc, kk)
    if name.startswith("egnn_ca"):
        assert isinstance(kk, tuple)  # compact_kk's neighbor list
    return tm, enc, kk


@pytest.mark.parametrize("name", ["flagship", "egnn_ca:compact_kk", "gvp_40kp", "kl_k0", "ll_k16",
                                  "egnn_ca:compact_kk:kernel_route"])
def test_step_capture_audit(name, monkeypatch):
    list_calls = []
    if name.endswith(":kernel_route"):  # the kk list in the list mode's form and the kNN masks, as on the card
        monkeypatch.setattr(dynamics_egnn, "kernel_device", lambda device: True)
        real_list_form = EGNNEdge.nbr_kernel
        monkeypatch.setattr(EGNNEdge, "nbr_kernel", lambda *a: list_calls.append(1) or real_list_form(*a))
    tm, enc, kk = _audit_model(name)
    gen = torch.Generator().manual_seed(0)
    st, k, _ = tm.start_chain(enc, kk, sample_steps=4, generator=gen)
    dyn = tm._sampling_dynamics()
    logs = []
    with torch.no_grad():
        tm.reverse_step(dyn, st, 1.0, gen)  # the warm-up step: it fills the modules' weight caches
        for _ in range(2):
            with OpLog() as log:
                tm.reverse_step(dyn, st, 1.0, gen)
            logs.append(log.ops)
    names = {op[0] for op in logs[0]}
    assert len(logs[0]) > 50 and "randn" in names and "index_select" in names
    assert not names & HOST_OPS, sorted(names & HOST_OPS)
    assert logs[0] == logs[1]  # no host value changes from one step to the next
    assert int(st["index"]) == 3
    # the kernel route runs edge_kk's list form in every layer of the three steps, and no other case does
    assert len(list_calls) == (3 * tm.dynamics.n_layers if name.endswith(":kernel_route") else 0)


def test_audit_sees_host_syncs():
    """The audit's own check: .item(), nonzero and torch.tensor show."""
    x = torch.arange(4.0)
    with OpLog() as log:
        float(x.sum().item())
        torch.nonzero(x)
        torch.tensor([1.0, 2.0])
    assert {"_local_scalar_dense", "nonzero", "lift_fresh"} <= {op[0] for op in log.ops}


# ---- (c) graph-cache keys

def test_graph_cache_keys():
    _, _, tm, _, _, tenc, tkk = _setup(False)
    graphs = _host_graphs(tm)
    gen = torch.Generator().manual_seed(0)

    def run(enc=tenc, kk=tkk, **kw):
        return tm.sample(enc, kk, sample_steps=2, generator=kw.pop("gen", gen), cuda_graph=True, **kw)

    run()
    run()
    assert len(graphs) == 1 and len(graphs.captures) == 1
    with torch.no_grad():
        enc16, kk16 = tm.encode(tsyn(0, **dict(SYN, n_lig_pad=16)))
    run(enc16, kk16)  # another ligand bucket
    nbr4, nbr5 = (radius_neighbor_list(tenc.kp_x, tenc.kp_mask, tenc.kp_x, tenc.kp_mask, 8.0, cap,
                                       exclude_self=True) for cap in (4, 5))
    run(kk=nbr4)  # kk as a neighbor list
    run(kk=nbr5)  # another kk cap
    run(eta=0.0)
    run(gen=torch.Generator().manual_seed(0))
    tm.sample(tenc, tkk, sample_steps=2, noise=_noise(0, 2, 10), cuda_graph=True)  # injected noise
    assert len(graphs) == 7 and len(graphs.captures) == 7
    run()
    assert len(graphs.captures) == 7  # still cached
    with torch.no_grad():  # a parameter update: every graph reads the old weights
        next(tm.dynamics.parameters()).add_(0.0)
    run()
    assert len(graphs) == 1 and len(graphs.captures) == 8

    graphs = _host_graphs(tm, max_graphs=2)
    for enc, kk in ((tenc, tkk), (enc16, kk16), (tenc, nbr4)):
        run(enc, kk)
    assert len(graphs) == 2 and len(graphs.captures) == 3
    run()  # evicted first: captured again
    assert len(graphs) == 2 and len(graphs.captures) == 4


# ---- (d) KeypointSampler's chunks against the JAX sampler's repeat padding

@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("chain_run")
    cfg = copy.deepcopy(TINY_CONFIG)
    cfg["experiment"] = {"name": "tiny", "results_dir": str(tmp / "runs")}
    cfg["dataset"]["location"] = str(tmp / "data")
    cfg["dynamics"].update(n_layers=2, update_kp_feat=True)
    (tmp / "data").mkdir()
    pad = PaddingConfig.from_config(cfg)
    train_ds, _ = molgen_splits_for_config(cfg, pad, resolve_feature_sizes(cfg)[0], 32, seed=0)
    save_dataset_histogram(train_ds, tmp / "data")
    (tmp / "cfg.yml").write_text(dump_yaml(cfg))
    save_keystr_npz(export_flat(tmodel(cfg, device="cpu", seed=5)), tmp / "seeded.npz")
    return cfg, import_params.main([str(tmp / "cfg.yml"), str(tmp / "seeded.npz"), str(tmp / "run")])


@pytest.mark.parametrize("ligand_size", ["random", 7])
def test_sampler_chunks_repeat_padded_as_jax(tiny_run, monkeypatch, ligand_size):
    cfg, run = tiny_run
    rng = np.random.default_rng(2)
    n_rec = 44
    rec_pos = rng.normal(size=(n_rec, 3)).astype(np.float32) * 3
    rec_feat = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n_rec)]
    res = np.repeat(np.arange(n_rec // 4), 4).astype(np.int32)
    ips = rng.normal(size=(5, 3)).astype(np.float32)
    com = np.array([1.0, -0.5, 2.0], np.float32)
    n_mols = 10

    sampler = KeypointSampler(run, batch_size=4, device="cpu", seed=7, sample_steps=2)
    runs, real = [], sampler._run

    def spy(cpx, init_com):
        out, *rest = real(cpx, init_com)
        runs.append((cpx, init_com, out))
        return (out, *rest)

    monkeypatch.setattr(sampler, "_run", spy)
    decoded = []

    def counting_decode(out, elements):
        decoded.append(int(out["lig_x"].shape[0]))
        return decode_ligands(out, elements)

    monkeypatch.setattr("kpdiff_tpu_torch.serve.decode_ligands", counting_decode)
    sampler.sample_for_arrays(rec_pos, rec_feat, res, ips, com, None, n_mols, ligand_size)
    chunks = sampler.last_request["chunks"]
    assert [c["batch"] for c in chunks] == [4, 4, 2] and decoded == [4, 4, 2]

    # the JAX sampler's own sample_for_arrays, its compiled run replaced by a recorder
    jruns = []
    js = JKeypointSampler.__new__(JKeypointSampler)
    js.config, js.pad, js.n_lig_feat = cfg, JPaddingConfig.from_config(cfg), sampler.n_lig_feat
    js.lig_elements, js.batch_size, js.lig_buckets = sampler.lig_elements, 4, sampler.lig_buckets
    js.model, js.kp_vec_dim, js.params = jmodel(cfg), None, None
    js._np_rng, js._rng = np.random.default_rng(7), jax.random.key(0)

    def jrun(params, key, cpx, init_com):
        jruns.append((cpx, init_com))
        b, n = cpx.lig_x.shape[:2]
        return dict(lig_x=np.zeros((b, n, 3)), lig_h=np.zeros((b, n, 10)), lig_mask=np.zeros((b, n), bool))

    js._run = jrun
    js.sample_for_arrays(rec_pos, rec_feat, res, ips, com, None, n_mols, ligand_size)
    assert len(runs) == len(jruns) == 3
    for (cpx, init_com, out), (jcpx, jcom) in zip(runs, jruns):
        assert cpx.batch_size == 4 and out["lig_x"].shape[0] == 4
        for f in ("rec_x", "rec_h", "rec_mask", "rec_res_idx", "lig_x", "lig_h", "lig_mask", "ip_x", "ip_mask",
                  "kp_x", "kp_h", "kp_mask"):
            got, want = getattr(cpx, f).numpy(), np.asarray(getattr(jcpx, f))
            assert got.shape == want.shape and got.dtype == want.dtype, f
            np.testing.assert_array_equal(got, want, err_msg=f)
        np.testing.assert_array_equal(init_com.numpy(), np.asarray(jcom))
    last = runs[-1][0]
    assert torch.equal(last.lig_mask[2], last.lig_mask[1]) and torch.equal(last.lig_mask[3], last.lig_mask[1])
