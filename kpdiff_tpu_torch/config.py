"""Config system: the repo's YAML configs in, typed configs and models out.

Mirrors `kpdiff_tpu/config.py` (PaddingConfig, load_config,
resolve_feature_sizes, model_from_config). The port carries its own reader
for the YAML subset that `configs/*.yml` use, so it needs no PyYAML: nested
block maps, block and flow sequences, flow maps, plain and quoted scalars,
and comments. Scalars resolve as PyYAML's safe loader resolves them (YAML
1.1 rules: `1.0e-5` is a float, `1e-5` without a dot stays a string).
`dump_yaml` writes a config back in that subset (the train CLI's
config.yml), so that this reader and PyYAML both read it back equal.
"""
from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Any, Dict, List, Tuple

N_AA_TYPES = 20  # one-hot residue types for ca_only pockets


@dataclasses.dataclass(frozen=True)
class PaddingConfig:
    """Static capacities for the padded complex (kpdiff_tpu/config.py:27-49)."""

    n_rec: int = 384
    n_lig: int = 64
    n_kp: int = 20  # keypoint capacity; == n_rec for fixed encoders
    n_ip: int = 64  # interface points

    @staticmethod
    def from_config(config: Dict[str, Any]) -> "PaddingConfig":
        pad = dict(config.get("padding", {}))
        n_kp = config.get("graph", {}).get("n_keypoints", 20)
        rec_encoder_type = config.get("diffusion", {}).get("rec_encoder_type", "learned")
        n_rec = pad.get("n_rec", 384)
        if rec_encoder_type == "fixed":
            n_kp = n_rec
        return PaddingConfig(
            n_rec=n_rec,
            n_lig=pad.get("n_lig", 64),
            n_kp=pad.get("n_kp", n_kp),
            n_ip=pad.get("n_ip", 64),
        )


# ---------------------------------------------------------------------------
# YAML subset reader
# ---------------------------------------------------------------------------

_BOOL = {
    "yes": True, "Yes": True, "YES": True, "no": False, "No": False, "NO": False,
    "true": True, "True": True, "TRUE": True, "false": False, "False": False, "FALSE": False,
    "on": True, "On": True, "ON": True, "off": False, "Off": False, "OFF": False,
}
_NULL = {"~", "null", "Null", "NULL", ""}
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?\.(?:inf|Inf|INF)"
    r"|\.(?:nan|NaN|NAN))$")


def _scalar(tok: str) -> Any:
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "'\"":
        body = tok[1:-1]
        return body.replace("''", "'") if tok[0] == "'" else bytes(body, "utf-8").decode("unicode_escape")
    if tok in _NULL:
        return None
    if tok in _BOOL:
        return _BOOL[tok]
    if _INT.match(tok):
        return int(tok.replace("_", ""))
    if _FLOAT.match(tok):
        low = tok.lower()
        if low.endswith(".inf"):
            return float("-inf") if low.startswith("-") else float("inf")
        if low.endswith(".nan"):
            return float("nan")
        return float(tok.replace("_", ""))
    return tok


def _strip_comment(line: str) -> str:
    """Drop a trailing `# comment` that is outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _split_flow(body: str) -> List[str]:
    """Split a flow collection body on top-level commas."""
    parts, depth, quote, cur = [], 0, None, []
    for ch in body:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
            continue
        cur.append(ch)
    if "".join(cur).strip():
        parts.append("".join(cur))
    return [p.strip() for p in parts]


def _split_key(text: str) -> Tuple[str, str] | None:
    """`key: value` -> (key, value) when `text` is a mapping entry."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            return None
        elif ch == ":" and (i + 1 == len(text) or text[i + 1] in " \t"):
            return text[:i].strip(), text[i + 1:].strip()
    return None


def _value(tok: str) -> Any:
    tok = tok.strip()
    if tok.startswith("[") and tok.endswith("]"):
        return [_value(p) for p in _split_flow(tok[1:-1])]
    if tok.startswith("{") and tok.endswith("}"):
        out = {}
        for p in _split_flow(tok[1:-1]):
            kv = _split_key(p)
            if kv is None:
                raise ValueError(f"bad flow mapping entry: {p!r}")
            out[_scalar(kv[0])] = _value(kv[1])
        return out
    return _scalar(tok)


def _parse_block(lines: List[Tuple[int, str]], pos: int, indent: int):
    """Parse the block (map or sequence) whose entries sit at `indent`."""
    if lines[pos][1].startswith("- ") or lines[pos][1] == "-":
        out_list: List[Any] = []
        while pos < len(lines) and lines[pos][0] == indent and lines[pos][1].startswith("-"):
            item = lines[pos][1][1:].strip()
            pos += 1
            if item:
                out_list.append(_value(item))
            elif pos < len(lines) and lines[pos][0] > indent:
                val, pos = _parse_block(lines, pos, lines[pos][0])
                out_list.append(val)
            else:
                out_list.append(None)
        return out_list, pos
    out: Dict[Any, Any] = {}
    while pos < len(lines) and lines[pos][0] == indent:
        kv = _split_key(lines[pos][1])
        if kv is None:
            raise ValueError(f"expected 'key: value', got {lines[pos][1]!r}")
        key, rest = kv
        pos += 1
        if rest:
            out[_scalar(key)] = _value(rest)
        elif pos < len(lines) and (lines[pos][0] > indent
                                   or (lines[pos][0] == indent and lines[pos][1].startswith("- "))):
            out[_scalar(key)], pos = _parse_block(lines, pos, lines[pos][0])
        else:
            out[_scalar(key)] = None
    return out, pos


def parse_yaml(text: str) -> Any:
    """Parse the YAML subset used by `configs/*.yml`."""
    lines = []
    for raw in text.splitlines():
        if raw.strip() in ("---", "..."):
            continue
        line = _strip_comment(raw.replace("\t", "    "))
        if line.strip():
            lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    if not lines:
        return None
    out, pos = _parse_block(lines, 0, lines[0][0])
    if pos != len(lines):
        raise ValueError(f"unparsed YAML from line {lines[pos][1]!r}")
    return out


_PLAIN = re.compile(r"^[A-Za-z_/][A-Za-z0-9_./-]*$")


def _dump_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        mant, _, exp = r.partition("e")
        if "." not in mant:
            mant += ".0"
        if exp and exp[0] not in "+-":
            exp = "+" + exp
        return mant + ("e" + exp if exp else "")
    if isinstance(v, str):
        if "\n" in v or "\r" in v:
            raise ValueError(f"multi-line string {v!r} is outside the YAML subset")
        if _PLAIN.match(v) and _scalar(v) == v:
            return v
        return "'" + v.replace("'", "''") + "'"
    raise TypeError(f"cannot write {type(v).__name__} {v!r} as YAML")


def _inline(v: Any) -> bool:
    """Whether `v` fits on its key's or its dash's line: a scalar, an empty
    container or a list of scalars (written as a flow sequence)."""
    if isinstance(v, dict):
        return not v
    if isinstance(v, (list, tuple)):
        return not any(isinstance(x, (dict, list, tuple)) for x in v)
    return True


def _dump_inline(v: Any) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_dump_scalar(x) for x in v) + "]"
    return _dump_scalar(v)


def _dump_lines(obj: Any, indent: int) -> List[str]:
    """Block lines of a non-inline dict or list."""
    pad = " " * indent
    out = []
    if isinstance(obj, dict):
        for k, v in obj.items():
            if _inline(v):
                out.append(f"{pad}{_dump_scalar(k)}: {_dump_inline(v)}")
            else:
                out.append(f"{pad}{_dump_scalar(k)}:")
                out.extend(_dump_lines(v, indent + 2))
        return out
    for x in obj:
        if _inline(x):
            out.append(f"{pad}- {_dump_inline(x)}")
        else:
            out.append(pad + "-")
            out.extend(_dump_lines(x, indent + 2))
    return out


def dump_yaml(obj: Any) -> str:
    """`obj` (dicts, lists and scalars) as YAML in the subset `parse_yaml` reads."""
    if _inline(obj):
        return _dump_inline(obj) + "\n"
    return "\n".join(_dump_lines(obj, 0)) + "\n"


def load_config(path: str | Path) -> Dict[str, Any]:
    return parse_yaml(Path(path).read_text())


def resolve_feature_sizes(config: Dict[str, Any]):
    """(n_rec_feat, n_lig_feat, n_kp_feat) as kpdiff_tpu/config.py:57-80."""
    ds = config["dataset"]
    diffusion = config.get("diffusion", {})
    architecture = diffusion.get("architecture", "egnn")
    rec_encoder_type = diffusion.get("rec_encoder_type", "learned")
    use_fake_atoms = ds.get("max_fake_atom_frac", 0.0) > 0

    n_rec_feat = N_AA_TYPES if ds.get("ca_only", False) else len(ds["rec_elements"])
    n_lig_feat = len(ds["lig_elements"]) + (1 if use_fake_atoms else 0)

    if rec_encoder_type == "learned":
        if architecture == "egnn":
            n_kp_feat = config["rec_encoder"]["out_n_node_feat"]
        else:
            n_kp_feat = config["rec_encoder_gvp"]["out_scalar_size"]
    else:
        n_kp_feat = n_rec_feat
    return n_rec_feat, n_lig_feat, n_kp_feat


def diffusion_config_from(config: Dict[str, Any]):
    """The DiffusionConfig that kpdiff_tpu/config.py::model_from_config builds."""
    from kpdiff_tpu_torch.models.diffusion import DiffusionConfig

    diffusion = dict(config.get("diffusion", {}))
    architecture = diffusion.pop("architecture", "egnn")
    rec_encoder_type = diffusion.pop("rec_encoder_type", "learned")
    n_rec_feat, n_lig_feat, n_kp_feat = resolve_feature_sizes(config)
    graph = config.get("graph", {})
    n_keypoints = graph.get("n_keypoints", 20)
    if architecture == "egnn":
        dynamics_cfg = dict(config.get("dynamics", {}))
        rec_enc_cfg = dict(config.get("rec_encoder", {}))
        rec_enc_cfg["in_n_node_feat"] = n_rec_feat
        rec_enc_cfg["n_keypoints"] = n_keypoints
    else:
        dynamics_cfg = dict(config.get("dynamics_gvp", {}))
        rec_enc_cfg = dict(config.get("rec_encoder_gvp", {}))
        rec_enc_cfg["in_scalar_size"] = n_rec_feat
        rec_enc_cfg["n_keypoints"] = n_keypoints
        if rec_encoder_type == "fixed":
            # a fixed GVP encoder's zero kp_v takes the dynamics' vector size
            rec_enc_cfg.setdefault("vector_size", dynamics_cfg.get("vector_size", 16))
    return DiffusionConfig(
        atom_nf=n_lig_feat,
        rec_nf=n_kp_feat,
        n_timesteps=diffusion.get("n_timesteps", 1000),
        precision=diffusion.get("precision", 1e-4),
        noise_schedule=diffusion.get("noise_schedule", "polynomial_2"),
        lig_feat_norm_constant=diffusion.get("lig_feat_norm_constant", 1),
        rl_dist_threshold=diffusion.get("rl_dist_threshold", 0),
        use_fake_atoms=config["dataset"].get("max_fake_atom_frac", 0.0) > 0,
        fake_atom_loss_semantics=diffusion.get("fake_atom_loss_semantics", "intent"),
        architecture=architecture,
        rec_encoder_type=rec_encoder_type,
        graph_cutoffs=dict(graph.get("graph_cutoffs", {})),
        dynamics=dynamics_cfg,
        rec_encoder=rec_enc_cfg,
        rec_encoder_loss=dict(config.get("rec_encoder_loss", {})),
    )


def model_from_config(config: Dict[str, Any], device: str = "cuda", seed: int = 0):
    """KeypointDiffusion on `device` with weights initialised from `seed`.

    Raises when `device` is CUDA and CUDA is missing (pass device='cpu')."""
    from kpdiff_tpu_torch.device import resolve_device
    from kpdiff_tpu_torch.models.diffusion import KeypointDiffusion

    dev = resolve_device(device)
    return KeypointDiffusion(diffusion_config_from(config), seed=seed).to(dev)
