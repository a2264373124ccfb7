"""In-loop deblocking filter (spec 8.7), batched over macroblocks.

Reference equivalents: edge kernels `deblock_luma_v/h`, `deblock_chroma_*`
(`src/h264-lab.h:1191-1545`) and the per-MB strength derivation
`df_strength`/`mb_deblock` (`:5535-5716`).

Batched shape: deblocking runs *inside* the encode wavefront with a
one-diagonal lag (see models/mbscan.py) — MB (r,c)'s vertical edges need
the horizontally-adjacent MB fully filtered, which the diagonal ordering
provides. Each call here filters a whole diagonal's MBs at once on
(k, rows, cols) pixel strips; the four edges of an MB are statically
unrolled (they overlap by up to 3 samples, so they are sequential within
the MB, exactly as in the spec).

All samples int32 in, uint8 semantics maintained by clipping.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from h264lab_tpu.ops import tables

_ALPHA = jnp.asarray(tables.ALPHA_TABLE)
_BETA = jnp.asarray(tables.BETA_TABLE)
_TC0 = jnp.asarray(tables.TC0_TABLE)       # [indexA][bS-1]


def thresholds(qp_avg):
    """(alpha, beta) for an edge given the average QP (offsets 0).
    `qp_avg` may be a scalar or a per-lane array."""
    idx = jnp.clip(qp_avg, 0, 51)
    return _ALPHA[idx], _BETA[idx]


def tc0_for(qp_avg, bs):
    idx = jnp.clip(qp_avg, 0, 51)
    if jnp.ndim(idx) and jnp.ndim(bs) > jnp.ndim(idx):
        idx = idx.reshape(idx.shape + (1,) * (jnp.ndim(bs) - jnp.ndim(idx)))
    return _TC0[idx, jnp.clip(bs - 1, 0, 2)]


def _edge_shape(x, ref_ndim):
    """Broadcast a per-lane (k,) threshold against (k, ...) samples."""
    if jnp.ndim(x) == 0:
        return x
    return x.reshape(x.shape + (1,) * (ref_ndim - 1))


def mb_edge_bs(intra_p, intra_q, nnz_p, nnz_q, mv_py, mv_px, mv_qy, mv_qx,
               is_mb_edge: bool):
    """Boundary strength for one edge position (vectorized over anything).

    nnz_*: nonzero-coefficient flags (bool/int) of the adjacent 4x4 blocks;
    mv in quarter-pel. Single reference picture assumed (no ref check).
    """
    either_intra = intra_p | intra_q
    bs_intra = 4 if is_mb_edge else 3
    coeff = (nnz_p > 0) | (nnz_q > 0)
    mv_far = (jnp.abs(mv_py - mv_qy) >= 4) | (jnp.abs(mv_px - mv_qx) >= 4)
    return jnp.where(either_intra, bs_intra,
                     jnp.where(coeff, 2, jnp.where(mv_far, 1, 0)))


def _filter_luma_cols(strip, x, bs_rows, alpha, beta, tc0_rows):
    """Filter one vertical luma edge at column x (last axis) of
    (..., 16, W) strips.

    bs_rows/tc0_rows: (..., 16) per-row strength / tc0 (already expanded
    from per-4-row groups). alpha/beta: scalars.
    """
    p3 = strip[..., x - 4]
    p2 = strip[..., x - 3]
    p1 = strip[..., x - 2]
    p0 = strip[..., x - 1]
    q0 = strip[..., x]
    q1 = strip[..., x + 1]
    q2 = strip[..., x + 2]
    q3 = strip[..., x + 3]

    filt = ((bs_rows > 0) & (jnp.abs(p0 - q0) < alpha)
            & (jnp.abs(p1 - p0) < beta) & (jnp.abs(q1 - q0) < beta))
    ap = jnp.abs(p2 - p0) < beta
    aq = jnp.abs(q2 - q0) < beta

    # ---- normal filter (bS 1..3) ----
    tc = tc0_rows + ap.astype(jnp.int32) + aq.astype(jnp.int32)
    delta = jnp.clip((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    np0 = jnp.clip(p0 + delta, 0, 255)
    nq0 = jnp.clip(q0 - delta, 0, 255)
    dp1 = jnp.clip((p2 + ((p0 + q0 + 1) >> 1) - 2 * p1) >> 1,
                   -tc0_rows, tc0_rows)
    np1 = jnp.where(ap, p1 + dp1, p1)
    dq1 = jnp.clip((q2 + ((p0 + q0 + 1) >> 1) - 2 * q1) >> 1,
                   -tc0_rows, tc0_rows)
    nq1 = jnp.where(aq, q1 + dq1, q1)

    # ---- strong filter (bS 4) ----
    strong_ok = jnp.abs(p0 - q0) < ((alpha >> 2) + 2)
    sp0a = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3
    sp1a = (p2 + p1 + p0 + q0 + 2) >> 2
    sp2a = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3
    sp0b = (2 * p1 + p0 + q1 + 2) >> 2
    sq0a = (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3
    sq1a = (q2 + q1 + q0 + p0 + 2) >> 2
    sq2a = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3
    sq0b = (2 * q1 + q0 + p1 + 2) >> 2
    use_p_strong = strong_ok & ap
    use_q_strong = strong_ok & aq
    s_p0 = jnp.where(use_p_strong, sp0a, sp0b)
    s_p1 = jnp.where(use_p_strong, sp1a, p1)
    s_p2 = jnp.where(use_p_strong, sp2a, p2)
    s_q0 = jnp.where(use_q_strong, sq0a, sq0b)
    s_q1 = jnp.where(use_q_strong, sq1a, q1)
    s_q2 = jnp.where(use_q_strong, sq2a, q2)

    is4 = bs_rows == 4
    f_p0 = jnp.where(filt, jnp.where(is4, s_p0, np0), p0)
    f_p1 = jnp.where(filt & ~is4, np1, jnp.where(filt & is4, s_p1, p1))
    f_p2 = jnp.where(filt & is4, s_p2, p2)
    f_q0 = jnp.where(filt, jnp.where(is4, s_q0, nq0), q0)
    f_q1 = jnp.where(filt & ~is4, nq1, jnp.where(filt & is4, s_q1, q1))
    f_q2 = jnp.where(filt & is4, s_q2, q2)

    strip = strip.at[..., x - 3].set(f_p2)
    strip = strip.at[..., x - 2].set(f_p1)
    strip = strip.at[..., x - 1].set(f_p0)
    strip = strip.at[..., x].set(f_q0)
    strip = strip.at[..., x + 1].set(f_q1)
    strip = strip.at[..., x + 2].set(f_q2)
    return strip


def _filter_chroma_cols(strip, x, bs_rows, alpha, beta, tc0_rows):
    """Filter one vertical chroma edge at column x (last axis) of
    (..., 8, W) strips."""
    p1 = strip[..., x - 2]
    p0 = strip[..., x - 1]
    q0 = strip[..., x]
    q1 = strip[..., x + 1]
    filt = ((bs_rows > 0) & (jnp.abs(p0 - q0) < alpha)
            & (jnp.abs(p1 - p0) < beta) & (jnp.abs(q1 - q0) < beta))
    tc = tc0_rows + 1
    delta = jnp.clip((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    np0 = jnp.clip(p0 + delta, 0, 255)
    nq0 = jnp.clip(q0 - delta, 0, 255)
    s_p0 = (2 * p1 + p0 + q1 + 2) >> 2
    s_q0 = (2 * q1 + q0 + p1 + 2) >> 2
    is4 = bs_rows == 4
    f_p0 = jnp.where(filt, jnp.where(is4, s_p0, np0), p0)
    f_q0 = jnp.where(filt, jnp.where(is4, s_q0, nq0), q0)
    strip = strip.at[..., x - 1].set(f_p0)
    strip = strip.at[..., x].set(f_q0)
    return strip


def expand_groups(bs_groups, reps: int):
    """(k, 4) per-4x4-group values -> (k, 4*reps) per-row values."""
    return jnp.repeat(bs_groups, reps, axis=1)


def filter_luma_v(strip, bs_edges, qp, edge_x0: int = 16):
    """Vertical edges of one MB batch. strip (k, 16, W): the current MB's
    leftmost column sits at `edge_x0` (columns edge_x0-4..edge_x0-1 come
    from the left neighbour). bs_edges (k, 4, 4): per edge e
    (x = edge_x0 + 4e), per 4-row group. `qp` is a scalar, or (k, 4)
    per-lane-per-edge (mb_qp_delta: edge 0 uses the two MBs' average QP,
    spec 8.7.2.1). Returns filtered strip."""
    per_edge = jnp.ndim(qp) == 2
    for e in range(4):
        qpe = qp[:, e] if per_edge else qp
        alpha, beta = thresholds(qpe)
        bs = expand_groups(bs_edges[:, e], 4)
        tc0 = tc0_for(qpe, bs)
        strip = _filter_luma_cols(strip, edge_x0 + 4 * e, bs,
                                  _edge_shape(alpha, 2),
                                  _edge_shape(beta, 2), tc0)
    return strip


def filter_luma_h(strip, bs_edges, qp, edge_y0: int = 16):
    """Horizontal edges: strip (k, H, 16) with the current MB's top row at
    `edge_y0`. Filter via transpose reuse."""
    stripT = jnp.swapaxes(strip, 1, 2)
    stripT = filter_luma_v(stripT, bs_edges, qp, edge_x0=edge_y0)
    return jnp.swapaxes(stripT, 1, 2)


def filter_chroma_v(strip, bs_edges, qpc, edge_x0: int = 8):
    """Chroma vertical edges: strip (..., 8, W) with the current MB's
    leftmost chroma column at `edge_x0` (the two columns before it come
    from the left neighbour). Two edges (x = edge_x0, edge_x0+4) using
    luma edge groups 0 and 2; bs rows expanded from 4 luma row-groups to
    8 chroma rows (2 each). Leading axes broadcast, so (k, 2, 8, W)
    filters u and v in one call. `qpc` scalar or (k, 2) per lane per
    chroma edge (MB edge, internal edge)."""
    per_edge = jnp.ndim(qpc) == 2
    extra = strip.ndim - 3
    for ci, e in enumerate((0, 2)):
        qpe = qpc[:, ci] if per_edge else qpc
        alpha, beta = thresholds(qpe)
        bs = expand_groups(bs_edges[:, e], 2)
        bs = bs.reshape(bs.shape[:1] + (1,) * extra + bs.shape[1:])
        tc0 = tc0_for(qpe, bs)
        strip = _filter_chroma_cols(strip, edge_x0 + 4 * ci, bs,
                                    _edge_shape(alpha, strip.ndim - 1),
                                    _edge_shape(beta, strip.ndim - 1), tc0)
    return strip


def filter_chroma_h(strip, bs_edges, qpc, edge_y0: int = 8):
    stripT = jnp.swapaxes(strip, -1, -2)
    stripT = filter_chroma_v(stripT, bs_edges, qpc, edge_x0=edge_y0)
    return jnp.swapaxes(stripT, -1, -2)
