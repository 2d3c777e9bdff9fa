"""Spatial ordering for the block-dense kk layout (kpdiff_tpu/ops/spatial.py).

Pocket atoms sorted along a Morton (Z-order) curve put radius-graph
neighbours near the diagonal in index space, so a banded block-dense layout
(each tile of `tile` destinations against the 3 * tile sources of the
previous, own and next tiles) covers most true edges with static slices.
The codes use int32 bit operations, padded points get 2**30 and sort last,
and the sort is stable, as jnp.argsort is, so that tied codes keep their
index order in both packages.
"""
from __future__ import annotations

import torch


def _spread_bits_10(v: torch.Tensor) -> torch.Tensor:
    """Insert two zero bits between each of the low 10 bits (Morton spreading)."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x30000FF
    v = (v | (v << 8)) & 0x300F00F
    v = (v | (v << 4)) & 0x30C30C3
    v = (v | (v << 2)) & 0x9249249
    return v


def morton_code(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes (int32) of (B, N, 3) points; masked points get 2**30."""
    inf = torch.full((), float("inf"), dtype=x.dtype, device=x.device)
    m = mask[..., None]
    lo = torch.amin(torch.where(m, x, inf), dim=1, keepdim=True)
    hi = torch.amax(torch.where(m, x, -inf), dim=1, keepdim=True)
    span = torch.clamp(hi - lo, min=1e-6)
    q = torch.clamp((x - lo) / span * 1023.0, 0, 1023).to(torch.int32)
    code = _spread_bits_10(q[..., 0]) | (_spread_bits_10(q[..., 1]) << 1) | (_spread_bits_10(q[..., 2]) << 2)
    return torch.where(mask, code, torch.full_like(code, 2 ** 30))


def spatial_sort_permutation(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, N) permutation sorting the points along the Morton curve (stable)."""
    return torch.argsort(morton_code(x, mask), dim=1, stable=True)


def choose_tile(n: int, tile: int) -> int:
    """The tile clamped to the node capacity; one tile spanning everything
    (exact) when it does not divide the capacity."""
    tile = min(tile, n)
    return tile if n % tile == 0 else n


def block_windows(arr: torch.Tensor, tile: int) -> torch.Tensor:
    """(B, N, ...) -> (B, nt, 3 * tile, ...): for each tile of `tile` rows, the
    rows of the previous, own and next tiles (zeros beyond the ends)."""
    b, n = arr.shape[:2]
    if n % tile:
        raise ValueError(f"N={n} must be a multiple of tile={tile}")
    nt = n // tile
    tiles = arr.reshape(b, nt, tile, *arr.shape[2:])
    zero = torch.zeros_like(tiles[:, :1])
    tp = torch.cat([zero, tiles, zero], dim=1)
    return torch.cat([tp[:, :-2], tp[:, 1:-1], tp[:, 2:]], dim=2)


def block_radius_adjacency(x: torch.Tensor, mask: torch.Tensor, radius: float, tile: int) -> torch.Tensor:
    """The banded block-dense radius graph over spatially sorted points:
    (B, nt, 3 * tile, tile) bool, source window row against destination,
    within `radius`, both valid, self excluded (destination j of a tile sits
    at window row tile + j); kpdiff_tpu/models/diffusion.py:185-207."""
    xw = block_windows(x, tile)
    mw = block_windows(mask, tile)
    b, nt, w = mw.shape
    xt = x.reshape(b, nt, tile, 3)
    mt = mask.reshape(b, nt, tile)
    d2 = torch.sum(torch.square(xw[:, :, :, None, :] - xt[:, :, None, :, :]), dim=-1)
    valid = mw[:, :, :, None] & mt[:, :, None, :]
    # window row tile + j is destination j itself
    eye = torch.arange(w, device=x.device)[:, None] == torch.arange(tile, device=x.device)[None, :] + tile
    return (d2 < float(radius) ** 2) & valid & ~eye[None, None]


def block_same_residue(res: torch.Tensor, tile: int) -> torch.Tensor:
    """The same-residue edge feature on the block windows: (B, nt, 3 * tile,
    tile, 1) float32, 1 where a window row and its destination share a
    residue index (kpdiff_tpu/models/encoder_egnn.py:187-191)."""
    rw, rt = block_windows(res, tile), res.reshape(res.shape[0], -1, tile)
    return (rw[:, :, :, None] == rt[:, :, None, :]).float()[..., None]
