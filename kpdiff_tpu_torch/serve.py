"""Programmatic sampling API of the port (kpdiff_tpu/serve.py): load a trained
run once, sample many pockets.

    from kpdiff_tpu_torch.serve import KeypointSampler
    s = KeypointSampler("runs/egnn_40kp_.../", batch_size=64)   # config.yml + checkpoints/step_N.pt
    mols = s.sample_for_pocket("prot.pdb", "ref_ligand.sdf", n_mols=100)
    # -> list of BuiltMolecule (positions, elements, perceived bonds)
    s = KeypointSampler.from_params("configs/egnn_40kp.yml", "artifacts/egnn_40kp_trained_params.npz")

Each request's ligand sizes ("random" from the run's size histogram, "ref"
from the reference ligand, or an int) are sorted in descending order and
sampled in chunks of at most `batch_size`; each chunk is padded to the
smallest ligand bucket that fits its largest ligand and repeat-padded to
`batch_size` rows (its last molecule again), as the JAX sampler pads it,
so that one captured CUDA graph of the reverse step per (bucket, kk cap)
serves every request (models/chain_graph.py; the JAX sampler reuses one
compiled executable the same way). Each chunk is encoded once, its static
kk edges compacted with a grow-only cap, and sampled under no_grad (so
every dense edge takes the CUDA kernel); the padded rows are dropped before
decoding. Bond perception runs on the way out and molecules that fail to
build are dropped.

Tracing (utils/profiling.py): a request is the span serve.request, and its
parts the spans serve.front_end, serve.sample (serve.encode,
serve.compact_kk and serve.chain), serve.readback (the wait for the
device), serve.decode and serve.build; `last_request`'s seconds are those spans' durations. Counters
(serve.*): rows asked and run (repeat-padding), real ligand atom-steps and
slot atom-steps (rows x bucket x chain steps), chunks by kk layout, kk cap
grows, a kk neighbor list's slots (rows x keypoints x cap x chain steps) and
its valid edges among them (x chain steps; summed on the device and read
after the readback's sync, so a dense kk adds no sync), keypoint slots
(rows x keypoint slots x chain steps) and the valid keypoints among them
(the chunk's kp_mask summed on the device, read after the same sync, x
chain steps), ligands decoded and built.

`kp_shard_devices=n > 1` splits every chunk's keypoints over n devices, one
rank each (parallel/kp_shard.py): rank 0 holds the requests and the front
end, encodes each chunk and broadcasts the encoded complex; the other ranks
are workers that sample it in lockstep (`worker_loop`) until rank 0's
`close()`. Outside a process group the sampler starts its n - 1 workers
itself and joins them as rank 0; inside one (torchrun) every rank builds
the sampler and the ranks other than 0 call `worker_loop()`.
"""
from __future__ import annotations

import dataclasses
import shutil
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from kpdiff_tpu_torch.analysis.molecule_builder import BuiltMolecule, build_molecule
from kpdiff_tpu_torch.config import PaddingConfig, load_config, model_from_config, resolve_feature_sizes
from kpdiff_tpu_torch.data.padding import pad_item, to_complex
from kpdiff_tpu_torch.device import resolve_device
from kpdiff_tpu_torch.ops.edge_sets import as_kk, layout_name, list_cap
from kpdiff_tpu_torch.utils import profiling, remake
from kpdiff_tpu_torch.utils.params_io import load_params, read_keystr_npz


def decode_ligands(out, lig_elements: List[str]):
    """Sampler outputs -> [(coords (n, 3), element symbols)] of the rows with
    atoms, on the host."""
    lig_x, lig_h, lig_mask = (out[k].cpu().numpy() for k in ("lig_x", "lig_h", "lig_mask"))
    ligands = []
    for b in range(lig_x.shape[0]):
        m = lig_mask[b]
        if m.sum() == 0:
            continue
        feats = lig_h[b][m][:, : len(lig_elements)]
        ligands.append((lig_x[b][m], [lig_elements[j] for j in feats.argmax(1)]))
    return ligands


def load_run_model(model_dir: str | Path, checkpoint_step: Optional[int] = None, device: str = "cuda",
                   seed: int = 0):
    """(config, model in eval mode) of a port run directory: config.yml and
    checkpoints/step_N.pt (the newest without `checkpoint_step`)."""
    from kpdiff_tpu_torch.training.trainer import read_checkpoint

    dev = resolve_device(device)
    model_dir = Path(model_dir)
    config = load_config(model_dir / "config.yml")
    model = model_from_config(config, device=dev, seed=seed)
    ckpt = read_checkpoint(model_dir / "checkpoints", checkpoint_step)
    load_params(model, {n: v.numpy() for n, v in ckpt["params"].items()})
    model.eval()
    return config, model


class KeypointSampler:
    def __init__(self, model_dir: str | Path, checkpoint_step: Optional[int] = None, batch_size: int = 64,
                 seed: int = 0, sample_steps: int = 0, eta: float = 1.0, lig_buckets: Optional[List[int]] = None,
                 kp_shard_devices: int = 0, device: str = "cuda"):
        """A port run directory (what `cli/train.py` writes). sample_steps:
        strided sampling with K < n_timesteps steps, 0 = the full chain; eta:
        DDIM noise scale, 1.0 = the ancestral chain; lig_buckets: ascending
        ligand padding buckets ending at padding.n_lig (None: the config's
        explicit list, else multiples of 8); kp_shard_devices: n > 1 splits
        the keypoints over n devices (rank 0 front end, worker ranks: see the
        module docstring; `close()` releases them). Raises when CUDA is
        missing unless device='cpu'."""
        kw = dict(model_dir=model_dir, checkpoint_step=checkpoint_step, batch_size=batch_size, seed=seed,
                  sample_steps=sample_steps, eta=eta, lig_buckets=lig_buckets, device=device)
        mesh = self._join(kp_shard_devices, device, kw)
        try:
            config, model = load_run_model(model_dir, checkpoint_step, device=mesh.device if mesh else device,
                                           seed=seed)
        except BaseException:
            self._leave()
            raise
        self._setup(config, model, Path(model_dir), batch_size, seed, sample_steps, eta, lig_buckets, mesh)

    @classmethod
    def from_params(cls, config_path: str | Path, params_npz: Optional[str | Path], batch_size: int = 64,
                    device: str = "cuda", seed: int = 0, sample_steps: int = 0, eta: float = 1.0,
                    lig_buckets: Optional[List[int]] = None, kp_shard_devices: int = 0) -> "KeypointSampler":
        """Model from `config_path` with weights from a keystr npz (the JAX
        package's export format); `params_npz=None` keeps the weights
        initialised from `seed`; kp_shard_devices as in the constructor.
        Raises when CUDA is missing unless device='cpu'."""
        self = cls.__new__(cls)
        kw = dict(config_path=config_path, params_npz=params_npz, batch_size=batch_size, device=device, seed=seed,
                  sample_steps=sample_steps, eta=eta, lig_buckets=lig_buckets)
        mesh = self._join(kp_shard_devices, device, kw)
        try:
            config = load_config(config_path)
            model = model_from_config(config, device=mesh.device if mesh else device, seed=seed)
            if params_npz is not None:
                load_params(model, read_keystr_npz(params_npz))
        except BaseException:
            self._leave()
            raise
        model.eval()
        self._setup(config, model, Path(config_path).parent, batch_size, seed, sample_steps, eta, lig_buckets, mesh)
        return self

    # ------------------------------------------------------- keypoint sharding

    def _join(self, n: int, device: str, ctor_kwargs: dict):
        """The 'model' mesh of kp_shard_devices=n > 1 (None for one device).
        Outside a process group, start the n - 1 workers and join them as rank 0."""
        from kpdiff_tpu_torch.parallel import distributed as pdist
        from kpdiff_tpu_torch.parallel.mesh import make_mesh

        self._workers, self._store, self._closed = [], None, False
        if n <= 1:
            return None
        if not pdist.join_launcher_group(device):
            self._workers, self._store = _start_workers(n, device, ctor_kwargs)
        try:
            return make_mesh(n, ("model",), device=device)
        except BaseException:
            self._leave()  # a group this sampler made must not outlive it
            raise

    @property
    def rank(self) -> int:
        """This process's rank on the sampler's mesh (0: the front end)."""
        return 0 if self._mesh is None else self._mesh.index("model")

    def _bcast(self, obj=None):
        """Rank 0's object on every rank (tensors travel on the CPU)."""
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self._mesh.world,
                                   device=self.device if self.device.type == "cuda" else None)
        return box[0]

    def worker_loop(self):
        """A worker rank: sample each chunk rank 0 broadcasts, until it closes."""
        while True:
            msg = self._bcast()
            if msg is None:
                break
            enc, kk, init_com = _to_device(msg, self.device)
            self._sample_sharded(enc, kk, init_com)
        self._leave()

    def close(self):
        """Rank 0: release the workers (and the group the sampler made)."""
        if self._mesh is None or self._closed or self.rank != 0:
            return
        self._bcast(None)
        self._leave()

    def _leave(self):
        self._closed = True
        for p in self._workers:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
        if self._store is not None:  # the group this sampler made
            if dist.is_initialized():
                dist.destroy_process_group()
            shutil.rmtree(self._store, ignore_errors=True)
            self._store = None

    def _sample_sharded(self, enc, kk, init_com):
        from kpdiff_tpu_torch.parallel.kp_shard import shard_encoded

        enc, kk, shard = shard_encoded(enc, kk, self._mesh, axis="model")
        return self.model.sample(enc, kk, init_com=init_com, sample_steps=self.sample_steps, eta=self.eta,
                                 generator=self._gen, kp_shard=shard)

    def _setup(self, config, model, model_dir, batch_size, seed, sample_steps, eta, lig_buckets, mesh=None):
        self._mesh = mesh
        self.config = config
        self.model = model
        self.model_dir = model_dir
        self.device = next(model.parameters()).device
        self.pad = PaddingConfig.from_config(config)
        self.n_rec_feat, self.n_lig_feat, _ = resolve_feature_sizes(config)
        self.lig_elements = config["dataset"]["lig_elements"]
        self.batch_size = batch_size
        self.sample_steps, self.eta = sample_steps, eta
        if lig_buckets is None:
            cfg_buckets = config.get("padding", {}).get("lig_buckets")
            if isinstance(cfg_buckets, (list, tuple)) and cfg_buckets:
                lig_buckets = sorted(int(b) for b in cfg_buckets)
            else:  # 'auto'/absent: no size histogram at serving time -> multiples of 8
                lig_buckets = list(range(8, self.pad.n_lig + 1, 8))
                if not lig_buckets or lig_buckets[-1] != self.pad.n_lig:
                    lig_buckets.append(self.pad.n_lig)
        if lig_buckets[-1] != self.pad.n_lig:
            raise ValueError(f"largest lig bucket {lig_buckets[-1]} must equal padding.n_lig {self.pad.n_lig}")
        self.lig_buckets = lig_buckets
        self._kk_cap = 0  # grow-only kk neighbor-list cap
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._np_rng = np.random.default_rng(seed)
        self._size_dist = None
        self.last_request = {}  # host and device seconds of the newest request, by part
        self.last_keypoints = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def _run(self, cpx, init_com):
        """Encode, compact kk and sample under no_grad, so that every dense
        edge takes the CUDA kernel. Returns the outputs, the kk layout,
        for a kk neighbor list (its slots, its valid edges summed on the
        device), else None, and (the keypoint slots, the valid keypoints
        summed on the device)."""
        with profiling.span("serve.encode"):
            enc, kk = self.model.encode(cpx)
        self.last_keypoints = (enc.kp_x[0], enc.kp_mask[0])  # the pocket's keypoints, for keypoints.xyz
        with profiling.span("serve.compact_kk"):
            kk = as_kk(self.model.compact_kk(enc, kk, min_cap=self._kk_cap))
        cap = list_cap(kk)
        if cap > self._kk_cap:
            profiling.count("serve.kk_cap_grows")
            self._kk_cap = cap
        with profiling.span("serve.chain"):
            if self._mesh is None:
                out = self.model.sample(enc, kk, init_com=init_com, sample_steps=self.sample_steps, eta=self.eta,
                                        generator=self._gen)
            else:
                self._bcast(_to_device((enc, kk, init_com), "cpu"))
                out = self._sample_sharded(enc, kk, init_com)
        kp = (enc.kp_mask.numel(), torch.sum(enc.kp_mask))
        return out, layout_name(kk), (kk.valid.numel(), torch.sum(kk.valid)) if cap else None, kp

    # ------------------------------------------------------------------ API

    def sample_for_pocket(self, receptor_file: str | Path, ref_ligand_file: str | Path, n_mols: int = 32,
                          ligand_size: str | int = "random") -> List[BuiltMolecule]:
        """Receptor PDB/mmCIF + reference-ligand SDF -> valid molecules (the
        BYOP pipeline)."""
        from kpdiff_tpu_torch.cli.byop import process_ligand_and_pocket

        t0 = time.perf_counter()
        data = process_ligand_and_pocket(str(receptor_file), str(ref_ligand_file), self.config)
        parse_s = time.perf_counter() - t0
        mols = self.sample_for_arrays(
            rec_pos=data["rec_pos"], rec_feat=data["rec_feat"], rec_res_idx=data["rec_res_idx"],
            interface_points=data["interface_points"], init_com=data["lig_pos"].mean(0),
            ref_n_atoms=data["lig_pos"].shape[0], n_mols=n_mols, ligand_size=ligand_size)
        self.last_request["parse_pocket_s"] = parse_s
        self.last_request["pocket_atoms"] = int(data["rec_pos"].shape[0])
        return mols

    def _sizes(self, n_rec: int, n_mols: int, ligand_size, ref_n_atoms) -> np.ndarray:
        if ligand_size == "random":
            from kpdiff_tpu_torch.models.size_dist import LigandSizeDistribution

            if self._size_dist is None:
                self._size_dist = LigandSizeDistribution(Path(self.config["dataset"]["location"]))
            sizes = self._size_dist.sample(np.array([n_rec]), n_mols, self._np_rng)[0]
        elif ligand_size == "ref":
            if ref_n_atoms is None:
                raise ValueError("ligand_size='ref' needs ref_n_atoms")
            sizes = np.full(n_mols, int(ref_n_atoms))
        else:
            sizes = np.full(n_mols, int(ligand_size))
        return np.clip(sizes, 2, self.pad.n_lig)

    def sample_for_arrays(self, rec_pos: np.ndarray, rec_feat: np.ndarray, rec_res_idx: Optional[np.ndarray] = None,
                          interface_points: Optional[np.ndarray] = None, init_com: Optional[np.ndarray] = None,
                          ref_n_atoms: Optional[int] = None, n_mols: int = 32,
                          ligand_size: str | int = "random") -> List[BuiltMolecule]:
        """Sample `n_mols` ligands for one featurized pocket; returns the
        molecules that build (bonds perceived, largest fragment, valence
        checked)."""
        with profiling.span("serve.request", request=True):
            with profiling.span("serve.front_end") as front:
                n_rec = rec_pos.shape[0]
                if rec_res_idx is None:
                    rec_res_idx = np.zeros(n_rec, np.int32)
                if interface_points is None:
                    interface_points = np.zeros((0, 3), np.float32)
                # larger ligands first, so that each chunk's bucket is as tight as possible
                sizes = np.sort(self._sizes(n_rec, n_mols, ligand_size, ref_n_atoms))[::-1]
            stats = dict(front_end_s=front.seconds, sample_s=0.0, copy_s=0.0, build_s=0.0, chunks=[],
                         sample_steps=self.sample_steps)
            chain_steps = len(self.model.chain_grid(self.sample_steps)) - 1

            mols: List[BuiltMolecule] = []
            done = 0
            while done < n_mols:
                with profiling.span("serve.front_end") as front:
                    bs = min(self.batch_size, n_mols - done)
                    chunk = sizes[done: done + bs]
                    bucket = next(b for b in self.lig_buckets if int(chunk.max()) <= b)
                    pad_b = dataclasses.replace(self.pad, n_lig=bucket)
                    items = []
                    for n in chunk:
                        item = dict(
                            lig_pos=np.zeros((int(n), 3), np.float32),
                            lig_feat=np.zeros((int(n), len(self.lig_elements)), np.float32),
                            rec_pos=rec_pos.astype(np.float32), rec_feat=rec_feat.astype(np.float32),
                            rec_res_idx=rec_res_idx.astype(np.int32),
                            interface_points=interface_points.astype(np.float32),
                        )
                        padded = pad_item(item, pad_b, n_lig_feat_out=self.n_lig_feat)
                        if padded is None:
                            raise ValueError(f"pocket ({n_rec} atoms) exceeds padding capacity {self.pad.n_rec}")
                        items.append(padded)
                    items += [items[-1]] * (self.batch_size - bs)  # repeat-padded: one graph per (bucket, kk cap)
                    cpx = to_complex(items, pad_b, self.model.cfg.rec_nf, self.model.kp_vec_dim, device=self.device)
                    com = None
                    if init_com is not None:
                        com = torch.as_tensor(np.broadcast_to(np.asarray(init_com, np.float32),
                                                              (self.batch_size, 3)).copy(), device=self.device)
                with profiling.span("serve.sample") as sample:  # encode, compact_kk and chain
                    out, layout, kk_list, kp = self._run(cpx, com)
                with profiling.span("serve.readback") as readback:
                    self._sync()
                with profiling.span("serve.decode") as decode:
                    ligands = decode_ligands({k: v[:bs] for k, v in out.items()}, self.lig_elements)
                with profiling.span("serve.build") as build:
                    for coords, elements in ligands:
                        mol = build_molecule(coords, elements)
                        if mol is not None:
                            mols.append(mol)
                stats["front_end_s"] += front.seconds
                stats["sample_s"] += sample.seconds + readback.seconds
                stats["copy_s"] += decode.seconds
                stats["build_s"] += build.seconds
                stats["chunks"].append(dict(batch=bs, bucket=bucket, kk=layout, sizes=[int(s) for s in chunk]))
                for name, n in (("rows_asked", bs), ("rows_run", self.batch_size), (f"chunks_kk_{layout}", 1),
                                ("lig_atom_steps", int(chunk.sum()) * chain_steps),
                                ("slot_atom_steps", self.batch_size * bucket * chain_steps),
                                ("ligands_decoded", len(ligands))):
                    profiling.count(f"serve.{name}", n)
                if kk_list is not None:  # read after the readback's sync
                    profiling.count("serve.kk_nbr_slots", kk_list[0] * chain_steps)
                    profiling.count("serve.kk_nbr_edges", int(kk_list[1]) * chain_steps)
                profiling.count("serve.kp_slot_steps", kp[0] * chain_steps)
                profiling.count("serve.kp_atom_steps", int(kp[1]) * chain_steps)
                done += bs
            profiling.count("serve.ligands_built", len(mols))
            self.last_request = stats
            return mols


def _to_device(obj, device):
    """Tensors of a (nested) tuple or PaddedComplex moved to `device`."""
    from kpdiff_tpu_torch.models.complex import PaddedComplex

    if isinstance(obj, PaddedComplex):
        return obj.to(device)
    if isinstance(obj, (tuple, list)):
        return remake(obj, [_to_device(o, device) for o in obj])
    return obj.to(device) if torch.is_tensor(obj) else obj


def _sampler_worker(rank: int, ctor_kwargs: dict):
    """A worker rank of a sampler that started its own group: build it, sample until rank 0 closes."""
    sampler = (KeypointSampler.from_params(**ctor_kwargs) if "config_path" in ctor_kwargs
               else KeypointSampler(**ctor_kwargs))
    sampler.worker_loop()


def _start_workers(n: int, device: str, ctor_kwargs: dict):
    """Start ranks 1..n-1 of a new group as sampler workers and join it as rank 0;
    returns the processes and the rendezvous directory."""
    import os
    import tempfile

    import torch.multiprocessing as mp

    from kpdiff_tpu_torch.parallel.distributed import DEFAULT_TIMEOUT, _rank_main, _set_cuda_device, backend_for

    store = tempfile.mkdtemp(prefix="kpdiff_serve_")
    init = "file://" + os.path.join(store, "store")
    ctx = mp.get_context("spawn")
    kw = dict(ctor_kwargs, kp_shard_devices=n)
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, _sampler_worker, n, init, device, DEFAULT_TIMEOUT, None, (kw,)))
             for r in range(1, n)]
    for p in procs:
        p.start()
    if torch.device(device).type == "cuda":
        _set_cuda_device(0)
    dist.init_process_group(backend_for(device), init_method=init, world_size=n, rank=0, timeout=DEFAULT_TIMEOUT)
    return procs, store
