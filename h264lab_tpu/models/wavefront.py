"""Wavefront scan plan: the batched replacement for the reference's
sequential macroblock raster loop (`encode_slice`, `src/h264-lab.h:6409-6461`).

H.264 intra prediction and reconstruction have left/top data dependencies,
so MBs on the same anti-diagonal are independent and processed as one
batched step; the frame scan is a `lax.scan` over diagonals. The carry is
exactly the data the C encoder keeps in its row buffers (`top_line`
`src/h264-lab.h:745`, nnz/mv rows `:6222-6228`): reconstructed bottom
rows / right columns per MB.

`slope=1` (d = r + c) suffices for 16x16/chroma/inter prediction;
`slope=2` (d = 2r + c) additionally satisfies the top-right dependency of
intra 4x4 prediction.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np


@dataclasses.dataclass(frozen=True)
class WavePlan:
    mb_width: int
    mb_height: int
    slope: int
    # (n_steps, kmax) flat MB indices, -1 padded
    steps: np.ndarray
    kmax: int

    @property
    def n_mb(self):
        return self.mb_width * self.mb_height


@functools.lru_cache(maxsize=32)
def make_plan(mb_width: int, mb_height: int, slope: int = 1) -> WavePlan:
    diags: dict[int, list[int]] = {}
    for r in range(mb_height):
        for c in range(mb_width):
            d = slope * r + c
            diags.setdefault(d, []).append(r * mb_width + c)
    n_steps = max(diags) + 1
    kmax = max(len(v) for v in diags.values())
    steps = np.full((n_steps, kmax), -1, dtype=np.int32)
    for d, idxs in diags.items():
        steps[d, :len(idxs)] = idxs
    return WavePlan(mb_width, mb_height, slope, steps, kmax)


def mb_tiles(plane: np.ndarray, tile: int) -> np.ndarray:
    """Split a (H, W) plane into (n_tiles, tile, tile) raster-ordered tiles."""
    h, w = plane.shape
    assert h % tile == 0 and w % tile == 0
    return (plane.reshape(h // tile, tile, w // tile, tile)
            .transpose(0, 2, 1, 3)
            .reshape(-1, tile, tile))


def tiles_to_plane(tiles: np.ndarray, mb_height: int, mb_width: int) -> np.ndarray:
    """Inverse of mb_tiles."""
    t = tiles.shape[-1]
    return (tiles.reshape(mb_height, mb_width, t, t)
            .transpose(0, 2, 1, 3)
            .reshape(mb_height * t, mb_width * t))


def pad_plane(plane: np.ndarray, target_h: int, target_w: int) -> np.ndarray:
    """Edge-replicate a plane to the padded MB-aligned size (the analog of
    the reference's cropped-MB edge extension `pix_copy_cropped_mb`
    `src/h264-lab.h:3536-3561`)."""
    h, w = plane.shape
    return np.pad(plane, ((0, target_h - h), (0, target_w - w)), mode="edge")
