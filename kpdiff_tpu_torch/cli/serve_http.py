"""HTTP serving front for the resident sampler (kpdiff_tpu/cli/serve_http.py;
stdlib-only REST).

The reference's inference entry points are one-shot CLI scripts that reload
the checkpoint on every invocation (test.py / byop.py). This module puts a
threaded JSON/SDF HTTP API in front of the port's `serve.KeypointSampler`,
which keeps the model resident on one CUDA card (with `--kp_shard_devices N`,
on N: rank 0 serves, the sampler's worker ranks sample in lockstep).

Endpoints:
  GET  /health        -> {"status", "model_dir", "lig_buckets", "batch_size"}
  POST /sample        -> pocket arrays in, molecules out:
        {"rec_pos": [[x,y,z], ...], "rec_feat": [[...], ...],
         "rec_res_idx": [...]?, "interface_points": [[x,y,z], ...]?,
         "init_com": [x,y,z]?, "n_mols": 8?, "ligand_size": "random"|int?}
  POST /sample_files  -> raw structure files as text:
        {"receptor_pdb": "<PDB text>", "ref_ligand_sdf": "<SDF text>",
         "n_mols": 8?, "ligand_size": "random"|"ref"|int?}

POST responses: {"n": int, "molecules": [{"elements": [...],
"coords": [[x,y,z], ...], "bonds": [[i, j, order], ...]}, ...],
"sdf": "<concatenated V2000 mol blocks>"}; errors -> 4xx/5xx with
{"error": "..."}.

Handler threads share one lock around every device call (requests queue),
and set the sampler's CUDA device inside it. Usage:

    python -m kpdiff_tpu_torch.cli.serve_http --model_dir runs/<run>/ --port 8777
"""
from __future__ import annotations

import argparse
import json
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path


def _mols_payload(mols):
    from kpdiff_tpu_torch.data.sdf import mol_block

    out = []
    sdf = []
    for j, m in enumerate(mols):
        out.append({
            "elements": list(m.elements),
            "coords": [[float(v) for v in row] for row in m.coords],
            "bonds": [[int(a), int(b), int(o)] for a, b, o in m.bonds],
        })
        sdf.append(mol_block(m.to_sdf_mol(title=f"sample_{j}")) + "$$$$\n")
    return {"n": len(out), "molecules": out, "sdf": "".join(sdf)}


def make_server(sampler, host: str = "127.0.0.1", port: int = 8777) -> ThreadingHTTPServer:
    """Build (but do not start) the HTTP server around a KeypointSampler.
    port=0 binds an ephemeral port (server.server_address[1] tells which) —
    the seam tests use."""
    import numpy as np
    import torch

    lock = threading.Lock()

    def on_device(fn, *a, **kw):
        with lock:
            if sampler.device.type == "cuda":
                torch.cuda.set_device(sampler.device)
            return fn(*a, **kw)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet; stdout is the service log
            pass

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/health":
                return self._json(404, {"error": f"unknown path {self.path}"})
            self._json(200, {
                "status": "ok",
                "model_dir": str(sampler.model_dir),
                "lig_buckets": sampler.lig_buckets,
                "batch_size": sampler.batch_size,
            })

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError) as e:
                return self._json(400, {"error": f"bad JSON body: {e}"})
            try:
                if self.path == "/sample":
                    kwargs = dict(
                        rec_pos=np.asarray(req["rec_pos"], np.float32),
                        rec_feat=np.asarray(req["rec_feat"], np.float32),
                        n_mols=int(req.get("n_mols", 8)),
                        ligand_size=req.get("ligand_size", "random"),
                    )
                    if kwargs["rec_pos"].ndim != 2 or kwargs["rec_pos"].shape[1] != 3:
                        return self._json(400, {"error": "rec_pos must be (N, 3)"})
                    if "rec_res_idx" in req:
                        kwargs["rec_res_idx"] = np.asarray(req["rec_res_idx"], np.int32)
                    if "interface_points" in req:
                        kwargs["interface_points"] = np.asarray(
                            req["interface_points"], np.float32).reshape(-1, 3)
                    if "init_com" in req:
                        kwargs["init_com"] = np.asarray(req["init_com"], np.float32)
                    if kwargs["ligand_size"] == "ref":
                        return self._json(400, {"error":
                                                "ligand_size='ref' needs /sample_files"})
                    mols = on_device(sampler.sample_for_arrays, **kwargs)
                elif self.path == "/sample_files":
                    if "receptor_pdb" not in req or "ref_ligand_sdf" not in req:
                        return self._json(400, {"error":
                                                "need receptor_pdb and ref_ligand_sdf"})
                    with tempfile.TemporaryDirectory() as td:
                        pdb = Path(td) / "receptor.pdb"
                        sdf = Path(td) / "ref_ligand.sdf"
                        pdb.write_text(req["receptor_pdb"])
                        sdf.write_text(req["ref_ligand_sdf"])
                        mols = on_device(sampler.sample_for_pocket, pdb, sdf, n_mols=int(req.get("n_mols", 8)),
                                         ligand_size=req.get("ligand_size", "random"))
                else:
                    return self._json(404, {"error": f"unknown path {self.path}"})
            except KeyError as e:
                return self._json(400, {"error": f"missing field {e}"})
            except ValueError as e:
                return self._json(400, {"error": str(e)})
            except Exception as e:  # device/model failure — report, keep serving
                return self._json(500, {"error": f"{type(e).__name__}: {e}"})
            self._json(200, _mols_payload(mols))

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model_dir", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8777)
    ap.add_argument("--checkpoint_step", type=int, default=None)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--sample_steps", type=int, default=0,
                    help="strided sampling with K < n_timesteps ancestral steps; 0 = the full chain")
    ap.add_argument("--kp_shard_devices", type=int, default=0,
                    help="split the keypoints over this many devices (latency mode, parallel/kp_shard.py)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)

    from kpdiff_tpu_torch.serve import KeypointSampler

    sampler = KeypointSampler(
        args.model_dir, checkpoint_step=args.checkpoint_step,
        batch_size=args.batch_size, seed=args.seed,
        sample_steps=args.sample_steps, kp_shard_devices=args.kp_shard_devices, device=args.device,
    )
    if sampler.rank:  # a worker rank under torchrun: sample rank 0's chunks
        sampler.worker_loop()
        return
    server = make_server(sampler, args.host, args.port)
    print(f"serving {args.model_dir} on http://{args.host}:{server.server_address[1]}",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        server.server_close()
        sampler.close()


if __name__ == "__main__":
    main()
