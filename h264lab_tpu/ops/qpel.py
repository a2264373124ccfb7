"""Sub-pel interpolation (spec 8.4.2.2): half-pel 6-tap planes computed
once per reference frame, quarter-pel by averaging, chroma 1/8-pel
bilinear.

Batched: where the reference interpolates one 16x16 block at a time per
qpel position (`h264e_qpel_interpolate_luma`, `src/h264-lab.h:2079-2131`),
we precompute the three half-pel planes (b: horizontal, h: vertical,
j: center) for the whole padded reference frame as fused XLA stencils, and
motion compensation becomes pure gathers + pairwise averages. This is the
classic decoder-style decomposition and turns ME refinement into
data-parallel lookups.

All planes carry a GUARD-pixel replicated border so ME/MC can read
out-of-frame (the reference's guard ring, `src/h264-lab.h:6235-6247`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

GUARD = 64  # luma guard ring in pixels: covers the coarse +-32 MV range
            # (reference MV_RANGE=32 + MV_GUARD, `src/h264-lab.h:3221-3222`)
            # plus the +-3 refine, 6-tap support, the ME window margin
            # (window origins must stay >= 0: dynamic_slice clamps) and
            # the previous-frame-MV candidate reach (me.MAX_CAND_FP =
            # GUARD - WIN_M - 3 = 52 full-pel)


def pad_guard(plane: jnp.ndarray, guard: int = GUARD) -> jnp.ndarray:
    """Edge-replicate pad by `guard` on every side."""
    return jnp.pad(plane, ((guard, guard), (guard, guard)), mode="edge")


def _filt6_h(x: jnp.ndarray) -> jnp.ndarray:
    """Horizontal 6-tap [1,-5,20,20,-5,1] raw sums (unclipped int32).
    out[y, x] is the half-pel between x+2 and x+3 of the padded input."""
    x = x.astype(jnp.int32)
    return (x[:, 0:-5] - 5 * x[:, 1:-4] + 20 * x[:, 2:-3]
            + 20 * x[:, 3:-2] - 5 * x[:, 4:-1] + x[:, 5:])


def _filt6_v(x: jnp.ndarray) -> jnp.ndarray:
    x = x.astype(jnp.int32)
    return (x[0:-5, :] - 5 * x[1:-4, :] + 20 * x[2:-3, :]
            + 20 * x[3:-2, :] - 5 * x[4:-1, :] + x[5:, :])


def half_pel_planes(ref_padded: jnp.ndarray):
    """Compute clipped half-pel planes for a guard-padded reference.

    Returns (b, h, j) uint8 planes, same shape as ref_padded (minus the
    6-tap support: callers must keep MVs within GUARD-5 of the border).
    b[y,x] = half-pel right of (y,x); h[y,x] = half-pel below (y,x);
    j[y,x] = center half-pel below-right of (y,x).
    """
    p = ref_padded.astype(jnp.int32)
    H, W = p.shape
    # horizontal: pad 2 left, 3 right so output aligns with x
    ph = jnp.pad(p, ((0, 0), (2, 3)), mode="edge")
    b_raw = _filt6_h(ph)                       # (H, W)
    b = jnp.clip((b_raw + 16) >> 5, 0, 255).astype(jnp.uint8)
    pv = jnp.pad(p, ((2, 3), (0, 0)), mode="edge")
    h_raw = _filt6_v(pv)                       # (H, W)
    h = jnp.clip((h_raw + 16) >> 5, 0, 255).astype(jnp.uint8)
    # center: horizontal filter of raw vertical sums (spec: unclipped
    # intermediates, final (x+512)>>10)
    h_raw_pad = jnp.pad(h_raw, ((0, 0), (2, 3)), mode="edge")
    j_raw = (h_raw_pad[:, 0:-5] - 5 * h_raw_pad[:, 1:-4]
             + 20 * h_raw_pad[:, 2:-3] + 20 * h_raw_pad[:, 3:-2]
             - 5 * h_raw_pad[:, 4:-1] + h_raw_pad[:, 5:])
    j = jnp.clip((j_raw + 512) >> 10, 0, 255).astype(jnp.uint8)
    return b, h, j


def gather_blocks(plane: jnp.ndarray, ys: jnp.ndarray, xs: jnp.ndarray,
                  bh: int, bw: int) -> jnp.ndarray:
    """Gather (k, bh, bw) blocks whose top-left corners are (ys, xs)."""
    dy = jnp.arange(bh)
    dx = jnp.arange(bw)
    yy = ys[:, None, None] + dy[None, :, None]
    xx = xs[:, None, None] + dx[None, None, :]
    return plane[yy, xx]


def mc_luma(full: jnp.ndarray, b: jnp.ndarray, h: jnp.ndarray,
            j: jnp.ndarray, mv_y: jnp.ndarray, mv_x: jnp.ndarray,
            base_y: jnp.ndarray, base_x: jnp.ndarray,
            bh: int = 16, bw: int = 16) -> jnp.ndarray:
    """Motion-compensated luma prediction for quarter-pel MVs.

    full/b/h/j: guard-padded planes. mv in quarter-pel units; base_*:
    full-pel block positions within the padded plane. Implements the spec
    8.4.2.2.1 quarter-sample interpolation via averages of the G/b/h/j
    grids. Returns (k, bh, bw) uint8.
    """
    iy = base_y + (mv_y >> 2)
    ix = base_x + (mv_x >> 2)
    fy = mv_y & 3
    fx = mv_x & 3

    def gat(plane, oy, ox):
        return gather_blocks(plane, iy + oy, ix + ox, bh, bw).astype(jnp.int32)

    # the four half-grid samples around the fractional position
    G = gat(full, 0, 0)
    G1 = gat(full, 0, 1)   # G shifted right
    G2 = gat(full, 1, 0)   # G shifted down
    B = gat(b, 0, 0)
    H_ = gat(h, 0, 0)
    B2 = gat(b, 1, 0)      # b shifted down
    H1 = gat(h, 0, 1)      # h shifted right
    J = gat(j, 0, 0)

    def avg(p, q):
        return (p + q + 1) >> 1

    # spec Figure 8-4 quarter positions (fx, fy):
    # row fy=0:  G      a=avg(G,b)   b      c=avg(b,G1)
    # row fy=1:  d=avg(G,h) e=avg(b,h)  f=avg(b,j)  g=avg(b,h1)
    # row fy=2:  h      i=avg(h,j)   j      k=avg(j,h1)
    # row fy=3:  n=avg(h,G2) p=avg(h,b2) q=avg(j,b2) r=avg(b2,h1)
    c00, c10, c20, c30 = G, avg(G, B), B, avg(B, G1)
    c01 = avg(G, H_)
    c02 = H_
    c03 = avg(H_, G2)
    c11 = avg(B, H_)
    c21 = avg(B, J)
    c31 = avg(B, H1)
    c12 = avg(H_, J)
    c22 = J
    c32 = avg(J, H1)
    c13 = avg(H_, B2)
    c23 = avg(J, B2)
    c33 = avg(H1, B2)

    rows = [
        [c00, c10, c20, c30],
        [c01, c11, c21, c31],
        [c02, c12, c22, c32],
        [c03, c13, c23, c33],
    ]
    # select by (fy, fx) per block
    stacked = jnp.stack([jnp.stack(r, axis=0) for r in rows], axis=0)
    # stacked: (4 fy, 4 fx, k, bh, bw)
    sel = stacked[fy, fx, jnp.arange(fy.shape[0])]
    return sel.astype(jnp.uint8)


def mc_chroma(plane: jnp.ndarray, mv_y: jnp.ndarray, mv_x: jnp.ndarray,
              base_y: jnp.ndarray, base_x: jnp.ndarray,
              bh: int = 8, bw: int = 8) -> jnp.ndarray:
    """Chroma MC with 1/8-pel bilinear (spec 8.4.2.2.2). mv in luma
    quarter-pel units (chroma eighth-pel = same number)."""
    iy = base_y + (mv_y >> 3)
    ix = base_x + (mv_x >> 3)
    fy = (mv_y & 7)[:, None, None]
    fx = (mv_x & 7)[:, None, None]
    A = gather_blocks(plane, iy, ix, bh, bw).astype(jnp.int32)
    B = gather_blocks(plane, iy, ix + 1, bh, bw).astype(jnp.int32)
    C = gather_blocks(plane, iy + 1, ix, bh, bw).astype(jnp.int32)
    D = gather_blocks(plane, iy + 1, ix + 1, bh, bw).astype(jnp.int32)
    out = ((8 - fx) * (8 - fy) * A + fx * (8 - fy) * B
           + (8 - fx) * fy * C + fx * fy * D + 32) >> 6
    return out.astype(jnp.uint8)


def mc_chroma_uniform(u_pad, v_pad, cb_y, cb_x, full_my, full_mx,
                      mv_y, mv_x):
    """Uniform-MV (16x16) chroma MC for both planes from one window
    slice per MB: a (2, 10, 10) stacked-plane window around the full-pel
    ME winner, re-centred on the final quarter-pel MV with 2-way
    shift-selects, then the spec 8.4.2.2.2 eighth-pel bilinear with
    dynamic weights.

    cb_*: chroma block bases in padded coords; full_my/full_mx: final
    full-pel winner (the sub-pel sweep stays within +-0.75 px of it);
    mv in luma quarter-pel. Returns (pred_u, pred_v) each (k, 8, 8)
    uint8."""
    uv = jnp.stack([u_pad, v_pad])
    CW = 10
    oy = cb_y + (full_my >> 1) - 1
    ox = cb_x + (full_mx >> 1) - 1
    f = jax.vmap(lambda y, x: jax.lax.dynamic_slice(uv, (0, y, x),
                                                    (2, CW, CW)))
    win = f(oy, ox).astype(jnp.int32)            # (k, 2, 10, 10)

    # integer re-centring: chroma px offset of the final MV vs the
    # window origin; mv within full winner +-0.75 px makes this 0 or 1
    ry = (mv_y >> 3) - ((full_my >> 1) - 1)      # in [0, 1]
    rx = (mv_x >> 3) - ((full_mx >> 1) - 1)

    def shift(x, sel, axis):
        out = None
        for s in range(0, 2):
            idx = [slice(None)] * x.ndim
            idx[axis] = slice(s, s + 9)
            sl = x[tuple(idx)]
            m = (sel == s).reshape((-1,) + (1,) * (x.ndim - 1))
            out = jnp.where(m, sl, out) if out is not None else \
                jnp.where(m, sl, jnp.zeros_like(sl))
        return out

    w9 = shift(shift(win, ry, 2), rx, 3)         # (k, 2, 9, 9)
    fy = (mv_y & 7)[:, None, None, None]
    fx = (mv_x & 7)[:, None, None, None]
    A = w9[:, :, 0:8, 0:8]
    B = w9[:, :, 0:8, 1:9]
    C = w9[:, :, 1:9, 0:8]
    D = w9[:, :, 1:9, 1:9]
    out = ((8 - fx) * (8 - fy) * A + fx * (8 - fy) * B
           + (8 - fx) * fy * C + fx * fy * D + 32) >> 6
    out = out.astype(jnp.uint8)
    return out[:, 0], out[:, 1]


def mc_luma_grid(full, b, h, j, mv4_y, mv4_x, mb_base_y, mb_base_x):
    """Per-4x4-block luma MC: mv4_* (k, 4, 4) quarter-pel MVs (constant
    within each partition), mb_base_*: (k,) MB top-left in padded coords.
    Equivalent to partition MC since interpolation is pointwise.
    Returns (k, 16, 16) uint8."""
    k = mv4_y.shape[0]
    oy = jnp.arange(4, dtype=jnp.int32) * 4
    by = jnp.broadcast_to(mb_base_y[:, None, None] + oy[None, :, None],
                          (k, 4, 4)).reshape(-1)
    bx = jnp.broadcast_to(mb_base_x[:, None, None] + oy[None, None, :],
                          (k, 4, 4)).reshape(-1)
    my = mv4_y.reshape(-1)
    mx = mv4_x.reshape(-1)
    blocks = mc_luma(full, b, h, j, my, mx, by, bx, 4, 4)
    return (blocks.reshape(k, 4, 4, 4, 4)
            .transpose(0, 1, 3, 2, 4).reshape(k, 16, 16))


def mc_chroma_grid(plane, mv4_y, mv4_x, cb_base_y, cb_base_x):
    """Per-4x4-luma-block chroma MC (2x2 chroma pixels per block).
    Returns (k, 8, 8) uint8."""
    k = mv4_y.shape[0]
    oy = jnp.arange(4, dtype=jnp.int32) * 2
    by = jnp.broadcast_to(cb_base_y[:, None, None] + oy[None, :, None],
                          (k, 4, 4)).reshape(-1)
    bx = jnp.broadcast_to(cb_base_x[:, None, None] + oy[None, None, :],
                          (k, 4, 4)).reshape(-1)
    my = mv4_y.reshape(-1)
    mx = mv4_x.reshape(-1)
    blocks = mc_chroma(plane, my, mx, by, bx, 2, 2)
    return (blocks.reshape(k, 4, 4, 2, 2)
            .transpose(0, 1, 3, 2, 4).reshape(k, 8, 8))
