"""Intra prediction, batched over macroblocks.

Reference equivalents: `h264e_intra_predict_16x16` (`src/h264-lab.h:1677-1714`),
`h264e_intra_predict_chroma` (`:1716-1781`). Batched: predictions for all
candidate modes are computed for a whole wavefront of MBs at once from edge
buffers (the carry state of the frame scan), and mode selection is a masked
SAD argmin instead of branchy heuristics.

Mode numbering follows the spec syntax:
- luma 16x16: 0=V, 1=H, 2=DC  (plane mode intentionally unsupported,
  matching the reference's tool set)
- chroma 8x8 syntax order: 0=DC, 1=H, 2=V
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

I16_V, I16_H, I16_DC = 0, 1, 2
CHROMA_DC, CHROMA_H, CHROMA_V = 0, 1, 2


def predict_16x16(top: jnp.ndarray, left: jnp.ndarray,
                  avail_top: jnp.ndarray, avail_left: jnp.ndarray):
    """All three 16x16 luma predictions.

    Args:
      top: (k, 16) uint8 — bottom row of the MB above.
      left: (k, 16) uint8 — right column of the MB to the left.
      avail_*: (k,) bool.

    Returns (k, 3, 16, 16) uint8 predictions ordered [V, H, DC] and a
    (k, 3) bool validity mask.
    """
    top = top.astype(jnp.int32)
    left = left.astype(jnp.int32)
    k = top.shape[0]

    pred_v = jnp.broadcast_to(top[:, None, :], (k, 16, 16))
    pred_h = jnp.broadcast_to(left[:, :, None], (k, 16, 16))

    sum_t = jnp.sum(top, axis=1)
    sum_l = jnp.sum(left, axis=1)
    both = (sum_t + sum_l + 16) >> 5
    t_only = (sum_t + 8) >> 4
    l_only = (sum_l + 8) >> 4
    dc = jnp.where(avail_top & avail_left, both,
                   jnp.where(avail_top, t_only,
                             jnp.where(avail_left, l_only, 128)))
    pred_dc = jnp.broadcast_to(dc[:, None, None], (k, 16, 16))

    preds = jnp.stack([pred_v, pred_h, pred_dc], axis=1)
    valid = jnp.stack([avail_top, avail_left,
                       jnp.ones_like(avail_top)], axis=1)
    return preds.astype(jnp.uint8), valid


def predict_chroma(top: jnp.ndarray, left: jnp.ndarray,
                   avail_top: jnp.ndarray, avail_left: jnp.ndarray):
    """All three chroma 8x8 predictions for one plane.

    Args:
      top/left: (k, 8) uint8 edges; avail_*: (k,) bool.
    Returns (k, 3, 8, 8) uint8 ordered [DC, H, V] and (k, 3) validity.
    """
    top = top.astype(jnp.int32)
    left = left.astype(jnp.int32)
    k = top.shape[0]

    pred_v = jnp.broadcast_to(top[:, None, :], (k, 8, 8))
    pred_h = jnp.broadcast_to(left[:, :, None], (k, 8, 8))

    # per-quadrant DC (spec 8.3.4.1)
    st0 = jnp.sum(top[:, 0:4], axis=1)
    st1 = jnp.sum(top[:, 4:8], axis=1)
    sl0 = jnp.sum(left[:, 0:4], axis=1)
    sl1 = jnp.sum(left[:, 4:8], axis=1)

    def quad_dc(sum_t, sum_l, prefer):
        # prefer: "both" quadrants use (t+l+4)>>3 when both available;
        # corner quadrants fall back per spec
        both = (sum_t + sum_l + 4) >> 3
        t_only = (sum_t + 2) >> 2
        l_only = (sum_l + 2) >> 2
        if prefer == "both":
            return jnp.where(avail_top & avail_left, both,
                             jnp.where(avail_top, t_only,
                                       jnp.where(avail_left, l_only, 128)))
        if prefer == "top":
            return jnp.where(avail_top, t_only,
                             jnp.where(avail_left, l_only, 128))
        return jnp.where(avail_left, l_only,
                         jnp.where(avail_top, t_only, 128))

    q00 = quad_dc(st0, sl0, "both")
    q01 = quad_dc(st1, sl0, "top")     # top-right quad: top[4:8] else left[0:4]
    q10 = quad_dc(st0, sl1, "left")    # bottom-left quad: left[4:8] else top[0:4]
    q11 = quad_dc(st1, sl1, "both")
    # assemble (k, 8, 8)
    top_half = jnp.concatenate([
        jnp.broadcast_to(q00[:, None, None], (k, 4, 4)),
        jnp.broadcast_to(q01[:, None, None], (k, 4, 4))], axis=2)
    bot_half = jnp.concatenate([
        jnp.broadcast_to(q10[:, None, None], (k, 4, 4)),
        jnp.broadcast_to(q11[:, None, None], (k, 4, 4))], axis=2)
    pred_dc = jnp.concatenate([top_half, bot_half], axis=1)

    preds = jnp.stack([pred_dc, pred_h, pred_v], axis=1)
    valid = jnp.stack([jnp.ones_like(avail_top), avail_left, avail_top],
                      axis=1)
    return preds.astype(jnp.uint8), valid


def sad(a: jnp.ndarray, b: jnp.ndarray, axes=(-2, -1)) -> jnp.ndarray:
    """Sum of absolute differences over trailing axes."""
    return jnp.sum(jnp.abs(a.astype(jnp.int32) - b.astype(jnp.int32)),
                   axis=axes)


def select_mode(src: jnp.ndarray, preds: jnp.ndarray, valid: jnp.ndarray,
                penalty: jnp.ndarray | None = None):
    """Masked SAD argmin mode selection.

    src (k, h, w); preds (k, m, h, w); valid (k, m); penalty (m,) optional
    extra cost per mode. Returns (mode (k,), best_pred (k, h, w), cost (k,)).
    """
    costs = sad(src[:, None], preds)
    if penalty is not None:
        costs = costs + penalty[None, :]
    costs = jnp.where(valid, costs, jnp.int32(1 << 30))
    mode = jnp.argmin(costs, axis=1).astype(jnp.int32)
    best = jnp.take_along_axis(
        preds, mode[:, None, None, None], axis=1)[:, 0]
    return mode, best, jnp.min(costs, axis=1)
