"""Motion estimation, batched over macroblocks — hierarchical dense search.

Batched re-design of the reference's candidate + small-diamond descent
(`me_search_diamond`, `src/h264-lab.h:4973-5176`): branchy sequential
descent maps poorly onto a vector machine, so ME here is a regular
3-stage funnel evaluated for every MB of the frame at once:

1. coarse: gather-free dense full search on the 4x-downsampled pyramid,
   +-8 coarse px = +-32 full px (the reference's MV_RANGE=32,
   `src/h264-lab.h:3222`), 289 shifted-plane SAD maps — dense work;
2. full-pel refine: one (34, 34) window per MB around the coarse winner
   (vmapped dynamic_slice — the only data-dependent memory access in the
   whole search), then a dense +-3 sweep of static window slices;
3. sub-pel: the window is re-centred on the full-pel winner with
   shift-select chains (the +-3 offset makes a 7-way `where` of static
   slices — no gathers), half-pel b/h/j values are computed *from the
   aligned window* with the 6-tap filters, and the full +-0.75-px
   quarter-sample neighbourhood is evaluated with statically-known
   fractional phases.

Costs are SAD + lambda_me * mv-bits against a *spatial predictor*
derived in parallel from the coarse stage: because stage 1 is dense over
the whole frame, the median of the left/top/top-right coarse winners
(the 8.4.1.3 predictor shape) is available for every MB simultaneously —
so the refine/sub-pel/partition costs track the actually-coded MVDs
instead of a (0,0) predictor (reference candidate costing
`src/h264-lab.h:5370-5412`, `:4952`), with no wavefront dependency. The
same predictor drives the early-skip bias: a sub-pel position equal to
the predictor with SAD under the skip threshold gets a bits bonus
(reference early skip `src/h264-lab.h:5306-5350`); the authoritative
skip decision (cbp==0 and mv==exact skip predictor, chroma included)
stays in the post-scan symbolization. Exact median-predictor MVDs are
likewise applied post-scan.

The aligned windows also drive partition ME (16x8/8x16/8x8) with purely
static slicing, and the winning predictions double as the motion-
compensated luma, so the inter luma path performs no further
interpolation or MC gathers. The search avoids elementwise gathers
throughout, using dense shifted-slice sweeps and masked selects instead.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from h264lab_tpu.ops import qpel
from h264lab_tpu.ops.tuning import (SKIP_BIAS_BITS, SKIP_THR_BASE,
                                    SKIP_THR_QP)

COARSE_R4 = 8        # coarse search radius in 4x-downsampled pixels (=32)
REFINE_R = 3         # full-pel refinement radius around the coarse winner
WIN_M = 9            # window margin each side of the coarse winner
WIN_S = 16 + 2 * WIN_M          # = 34: sliced window side
ALN_S = 27           # aligned window side: winner-5 .. winner+21
SUB = 22             # aligned qpel plane side: winner-3 .. winner+18


def mv_bits(v: jnp.ndarray) -> jnp.ndarray:
    """Exp-Golomb bit count of se(v) (mv component in quarter-pel)."""
    code = jnp.where(v > 0, 2 * v - 1, -2 * v) + 1
    nb = 32 - jax.lax.clz(jnp.maximum(code, 1).astype(jnp.int32))
    return 2 * nb - 1


# int(max(sqrt(0.85 * 2 ** ((qp - 12) / 3)), 1)) for qp = 0..51: the
# truncated sqrt of the JM mode lambda, tabulated so that no float sits
# on the decision path (tests/test_backend_digest.py pins it against the
# formula).
LAMBDA_ME = np.array(
    [1] * 19 + [2, 2, 2, 2, 3, 3, 4, 4, 5, 5, 6, 7, 8, 9, 10, 11, 13, 14,
                16, 18, 20, 23, 26, 29, 33, 37, 41, 46, 52, 59, 66, 74, 83],
    np.int32)


def lambda_me(qp: jnp.ndarray) -> jnp.ndarray:
    """sqrt of the JM mode lambda, in int (>=1)."""
    return jnp.take(jnp.asarray(LAMBDA_ME), jnp.asarray(qp, jnp.int32),
                    mode="clip")


def downsample4(plane: jnp.ndarray) -> jnp.ndarray:
    """4x box downsample (uint8 -> uint8) for the coarse stage."""
    h, w = plane.shape
    x = plane[:h - h % 4, :w - w % 4].astype(jnp.int32)
    x = x.reshape(h // 4, 4, w // 4, 4).sum(axis=(1, 3))
    return ((x + 8) >> 4).astype(jnp.uint8)


def coarse_search_4x(cur4, ref4_pad, lam, mb_height: int, mb_width: int,
                     row_offset, mvp_y, mvp_x, radius: int = COARSE_R4):
    """Dense full search on the 4x pyramid. cur4: (mbh*4, mbw*4) band
    plane; ref4_pad: full-frame 4x plane with GUARD//4 guard. Returns
    per-MB coarse-pixel (dy4, dx4), each (nmb,) int32."""
    g4 = qpel.GUARD // 4
    H4 = mb_height * 4
    W4 = mb_width * 4
    cur = cur4.astype(jnp.int32)
    side = 2 * radius + 1
    mvp_y2 = mvp_y.reshape(mb_height, mb_width)
    mvp_x2 = mvp_x.reshape(mb_height, mb_width)
    dx_all = jnp.arange(-radius, radius + 1, dtype=jnp.int32)
    dx_bits = lam * mv_bits(dx_all[:, None, None] * 16
                            - mvp_x2[None])            # (side, mbh, mbw)

    def body(i, st):
        """One dy row: all `side` dx shifts evaluated as a batch (the dx
        axis becomes a leading tensor dim, so the loop is `side` rather
        than `side**2` iterations — the sweep is bandwidth-bound)."""
        best_cost, best_dy, best_dx = st
        dy = i - radius
        row = jax.lax.dynamic_slice(
            ref4_pad, (g4 + row_offset * 4 + dy, g4 - radius),
            (H4, W4 + 2 * radius)).astype(jnp.int32)
        subs = jnp.stack([row[:, s:s + W4] for s in range(side)])
        sad = (jnp.abs(cur[None] - subs)
               .reshape(side, mb_height, 4, mb_width, 4).sum(axis=(2, 4)))
        cost = sad * 16 + lam * mv_bits(dy * 16 - mvp_y2)[None] + dx_bits
        k = jnp.argmin(cost.reshape(side, -1), axis=0)
        cmin = jnp.min(cost, axis=0)
        upd = cmin < best_cost
        return (jnp.where(upd, cmin, best_cost),
                jnp.where(upd, dy, best_dy),
                jnp.where(upd, k.reshape(mb_height, mb_width) - radius,
                          best_dx))

    shape = (mb_height, mb_width)
    init = (jnp.full(shape, 1 << 30, jnp.int32),
            jnp.zeros(shape, jnp.int32), jnp.zeros(shape, jnp.int32))
    _, dy, dx = jax.lax.fori_loop(0, side, body, init)
    return dy.reshape(-1), dx.reshape(-1)


def _slice_windows(plane, oy, ox, sh: int, sw: int):
    """Per-MB (sh, sw) windows via vmapped dynamic_slice. Offsets must be
    in-range: dynamic_slice clamps out-of-range starts, which would
    silently misalign windows."""
    f = jax.vmap(lambda y, x: jax.lax.dynamic_slice(plane, (y, x), (sh, sw)))
    return f(oy, ox)


def _tiled_windows(ref_pad, mb_height: int, mb_width: int, row_offset,
                   m: int = WIN_M):
    """(nmb, 16+2m, 16+2m) zero-MV search windows — one per MB tile —
    built from NINE static strided reshapes of the reference plane plus
    one contiguous dynamic_slice (band offset). The zero-MV candidate's
    windows need no gather at all, only plain copies. Requires
    GUARD >= m + 16."""
    g = qpel.GUARD
    H16, W16 = 16 * mb_height, 16 * mb_width
    region = jax.lax.dynamic_slice(
        ref_pad, (16 * jnp.asarray(row_offset, jnp.int32) + g - 16, 0),
        (H16 + 32, W16 + 2 * g))

    def tiles_at(a, b):
        sub = region[a:a + H16, g - 16 + b:g - 16 + b + W16]
        return (sub.reshape(mb_height, 16, mb_width, 16)
                .transpose(0, 2, 1, 3))

    rows = []
    for a in (0, 16, 32):
        rows.append(jnp.concatenate([tiles_at(a, b) for b in (0, 16, 32)],
                                    axis=3))
    w3 = jnp.concatenate(rows, axis=2)          # (mbh, mbw, 48, 48)
    return w3.reshape(-1, 48, 48)[:, 16 - m:32 + m, 16 - m:32 + m]


def _shift_select(x, sel, lo: int, hi: int, base: int, size: int, axis: int):
    """out[k] = x[k] sliced at (base + sel[k]) of length `size` along
    `axis`, for sel in [lo, hi] — a (hi-lo+1)-way masked select of static
    slices (the gather-free dynamic window re-centring primitive)."""
    out = None
    for s in range(lo, hi + 1):
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(base + s, base + s + size)
        sl = x[tuple(idx)]
        m = (sel == s).reshape((-1,) + (1,) * (x.ndim - 1))
        out = jnp.where(m, sl, out) if out is not None else \
            jnp.where(m, sl, jnp.zeros_like(sl))
    return out


def _median3(a, b, c):
    return jnp.maximum(jnp.minimum(jnp.maximum(a, b), c),
                       jnp.minimum(a, b))


def spatial_predictor(dy, dx, mb_height: int, mb_width: int):
    """Quarter-pel MV predictor per MB from the dense coarse field:
    median of the left/top/top-right neighbours' coarse winners (the
    8.4.1.3 neighbour shape; top-right falls back to top-left on the last
    column, row 0 uses the left neighbour alone). dy/dx: (nmb,) coarse
    (4x) px. Returns (mvp_y, mvp_x) in quarter-pel, (nmb,) int32."""
    qy = (dy * 16).reshape(mb_height, mb_width)
    qx = (dx * 16).reshape(mb_height, mb_width)

    def shifts(q):
        a = jnp.pad(q, ((0, 0), (1, 0)))[:, :-1]          # left
        b = jnp.pad(q, ((1, 0), (0, 0)))[:-1, :]          # top
        c = jnp.pad(q, ((1, 0), (0, 1)))[:-1, 1:]         # top-right
        d = jnp.pad(q, ((1, 1), (1, 0)))[:-2, :-1]        # top-left
        c = c.at[:, -1].set(d[:, -1])                     # TR -> TL fallback
        med = _median3(a, b, c)
        return med.at[0, :].set(a[0, :])                  # row 0: left only
    my = shifts(qy)
    mx = shifts(qx)
    return my.reshape(-1), mx.reshape(-1)


def _hpel_from_window(win):
    """6-tap half-pel values computed from aligned (k, 27, 27) int32
    full-pel windows (spec 8.4.2.2.1; reference kernels
    `src/h264-lab.h:1964-2131`). With the winner at coord 5, returns the
    (F, B, H, J) qpel planes aligned on coord i == full-pel (i + 2):
      F (k,22,22) full-pel;    B (k,22,22) half-pel right of F[i]
      H (k,22,22) half-pel below;  J (k,22,22) centre half-pel
    """
    def f6_h(x):
        return (x[..., :, 0:-5] - 5 * x[..., :, 1:-4] + 20 * x[..., :, 2:-3]
                + 20 * x[..., :, 3:-2] - 5 * x[..., :, 4:-1] + x[..., :, 5:])

    def f6_v(x):
        return (x[..., 0:-5, :] - 5 * x[..., 1:-4, :] + 20 * x[..., 2:-3, :]
                + 20 * x[..., 3:-2, :] - 5 * x[..., 4:-1, :] + x[..., 5:, :])

    F = win[:, 2:24, 2:24]
    b_arr = jnp.clip((f6_h(win) + 16) >> 5, 0, 255)      # (k, 27, 22)
    B = b_arr[:, 2:24, :]
    h_raw = f6_v(win)                                     # (k, 22, 27)
    H_ = jnp.clip((h_raw + 16) >> 5, 0, 255)[:, :, 2:24]
    J = jnp.clip((f6_h(h_raw) + 512) >> 10, 0, 255)       # (k, 22, 22)
    return F, B, H_, J


def pred_from_windows(wins, dyq: int, dxq: int, center: int,
                      oy0: int = 0, ox0: int = 0, bh: int = 16, bw: int = 16):
    """Quarter-pel prediction for a statically-known offset (dyq, dxq) in
    quarter-pel around full-pel window position `center` (+ block offset
    (oy0, ox0)). wins = (F, B, H, J) sub-windows in common coordinates
    (aligned so index i of every plane is full-pel coord i). No runtime
    phase selection: the phase is static (cf. spec Figure 8-4)."""
    wf, wb, wh, wj = wins
    oy = center + oy0 + (dyq >> 2)
    ox = center + ox0 + (dxq >> 2)
    fy = dyq & 3
    fx = dxq & 3

    def S(w, ey=0, ex=0):
        return w[:, oy + ey:oy + ey + bh, ox + ex:ox + ex + bw]

    def avg(p, q):
        return (p + q + 1) >> 1

    table = {
        (0, 0): lambda: S(wf),
        (1, 0): lambda: avg(S(wf), S(wb)),
        (2, 0): lambda: S(wb),
        (3, 0): lambda: avg(S(wb), S(wf, 0, 1)),
        (0, 1): lambda: avg(S(wf), S(wh)),
        (1, 1): lambda: avg(S(wb), S(wh)),
        (2, 1): lambda: avg(S(wb), S(wj)),
        (3, 1): lambda: avg(S(wb), S(wh, 0, 1)),
        (0, 2): lambda: S(wh),
        (1, 2): lambda: avg(S(wh), S(wj)),
        (2, 2): lambda: S(wj),
        (3, 2): lambda: avg(S(wj), S(wh, 0, 1)),
        (0, 3): lambda: avg(S(wh), S(wf, 1, 0)),
        (1, 3): lambda: avg(S(wh), S(wb, 1, 0)),
        (2, 3): lambda: avg(S(wj), S(wb, 1, 0)),
        (3, 3): lambda: avg(S(wh, 0, 1), S(wb, 1, 0)),
    }
    return table[(fx, fy)]()


def _phase_planes(wins):
    """All 16 quarter-pel phase planes from the (F, B, H, J) half-pel
    planes, stacked as (k, 4, 4, S, S) with stack[fy, fx][y, x] = the
    quarter-pel sample at (4y + fy, 4x + fx) relative to the planes'
    common full-pel origin (spec Figure 8-4 averaging rules).

    This makes a dense qpel sweep loop-able: position (dyq, dxq) is one
    dynamic_slice at (dyq & 3, dxq & 3, base + (dyq >> 2), ...), so the
    49-position sweep compiles as ONE `fori_loop` body instead of 49
    unrolled blocks — XLA compile time on the hot encode path was gated
    by exactly this kind of unrolling (round-4 postmortem)."""
    wf, wb, wh, wj = wins
    k, sy, sx = wf.shape
    pad = lambda w: jnp.pad(w, ((0, 0), (0, 1), (0, 1)), mode="edge")
    f, b, h, j = pad(wf), pad(wb), pad(wh), pad(wj)

    def avg(p, q):
        return (p + q + 1) >> 1

    def S(w, ey=0, ex=0):
        return w[:, ey:ey + sy, ex:ex + sx]

    # stacked with (fy, fx) as LEADING axes — dynamic_slice with traced
    # starts in leading dims keeps the per-MB (k) and pixel dims intact,
    # which lowers to a cheap offset select instead of a strided
    # mid-dimension slice
    rows = []
    for fy in range(4):
        row = []
        for fx in range(4):
            # same table as pred_from_windows, full-plane form
            tab = {
                (0, 0): lambda: S(f),
                (1, 0): lambda: avg(S(f), S(b)),
                (2, 0): lambda: S(b),
                (3, 0): lambda: avg(S(b), S(f, 0, 1)),
                (0, 1): lambda: avg(S(f), S(h)),
                (1, 1): lambda: avg(S(b), S(h)),
                (2, 1): lambda: avg(S(b), S(j)),
                (3, 1): lambda: avg(S(b), S(h, 0, 1)),
                (0, 2): lambda: S(h),
                (1, 2): lambda: avg(S(h), S(j)),
                (2, 2): lambda: S(j),
                (3, 2): lambda: avg(S(j), S(h, 0, 1)),
                (0, 3): lambda: avg(S(h), S(f, 1, 0)),
                (1, 3): lambda: avg(S(h), S(b, 1, 0)),
                (2, 3): lambda: avg(S(j), S(b, 1, 0)),
                (3, 3): lambda: avg(S(h, 0, 1), S(b, 1, 0)),
            }
            row.append(tab[(fx, fy)]())
        rows.append(jnp.stack(row, axis=0))
    # uint8 storage: all phase samples are clipped pixel values; the
    # stack is the largest ME intermediate (G*nmb*16*S^2), so byte
    # storage quarters its HBM footprint and traffic
    return jnp.stack(rows, axis=0).astype(jnp.uint8)   # (fy, fx, k, S, S)


def _sweep_fullpel(cur_i, win, base_y: int, base_x: int, radius: int,
                   cost_fn):
    """Dense (2r+1)^2 full-pel SAD sweep over per-MB windows as a
    `fori_loop`: win (k, S, S) int32, block at (base_y+dy, base_x+dx).
    cost_fn(sad, dy, dx) -> cost. Returns (cost, dy, dx) best per MB."""
    k = cur_i.shape[0]
    bh, bw = cur_i.shape[1], cur_i.shape[2]
    side = 2 * radius + 1

    def body(i, st):
        best, bdy, bdx = st
        dy = i // side - radius
        dx = i % side - radius
        blk = jax.lax.dynamic_slice(
            win, (0, base_y + dy, base_x + dx), (k, bh, bw))
        sad = jnp.sum(jnp.abs(cur_i - blk), axis=(1, 2))
        cost = cost_fn(sad, dy, dx)
        upd = cost < best
        return (jnp.where(upd, cost, best),
                jnp.where(upd, dy, bdy), jnp.where(upd, dx, bdx))

    init = (jnp.full((k,), 1 << 30, jnp.int32),
            jnp.zeros((k,), jnp.int32), jnp.zeros((k,), jnp.int32))
    return jax.lax.fori_loop(0, side * side, body, init)


def _sweep_qpel(cur_i, phases, center: int, cost_fn, radius: int = 3):
    """Dense (2r+1)^2 quarter-pel sweep over the phase-plane stack as a
    `fori_loop`. phases: (4, 4, k, S, S) [fy, fx leading — see
    _phase_planes]; the full-pel winner sits at plane coord `center`.
    cost_fn(sad, dyq, dxq) -> cost. Returns (cost, dyq, dxq, pred)."""
    k = phases.shape[2]
    bh, bw = cur_i.shape[1], cur_i.shape[2]
    side = 2 * radius + 1

    def body(i, st):
        best, byq, bxq, bpred = st
        dyq = i // side - radius
        dxq = i % side - radius
        pred = jax.lax.dynamic_slice(
            phases, (dyq & 3, dxq & 3, 0,
                     center + (dyq >> 2), center + (dxq >> 2)),
            (1, 1, k, bh, bw))[0, 0].astype(jnp.int32)
        sad = jnp.sum(jnp.abs(cur_i - pred), axis=(1, 2))
        cost = cost_fn(sad, dyq, dxq)
        upd = cost < best
        return (jnp.where(upd, cost, best),
                jnp.where(upd, dyq, byq), jnp.where(upd, dxq, bxq),
                jnp.where(upd[:, None, None], pred, bpred))

    init = (jnp.full((k,), 1 << 30, jnp.int32),
            jnp.zeros((k,), jnp.int32), jnp.zeros((k,), jnp.int32),
            jnp.zeros((k, bh, bw), jnp.int32))
    return jax.lax.fori_loop(0, side * side, body, init)


MAX_CAND_FP = qpel.GUARD - WIN_M - 3   # full-pel candidate-centre clip


def motion_search_dense(cur_plane, cur_tiles, ref_pad, ref4_pad,
                        base_y, base_x, qp,
                        mb_height: int, mb_width: int, row_offset,
                        enable_subpel: bool = True,
                        mvp_y=None, mvp_x=None,
                        prev_my=None, prev_mx=None):
    """Hierarchical gather-free ME (see module docstring).

    `prev_my`/`prev_mx` (optional, (nmb,) full-pel int32): the previous
    frame's co-located MV field — a third candidate centre that both
    extends reach beyond the coarse stage's +-32 px (tracking motion
    accumulates across frames, the dense analog of the reference's
    candidate harvest `src/h264-lab.h:5370-5412`) and de-aliases
    periodic content.

    Returns (mv_y_q, mv_x_q, cost, pred, aux) with pred (nmb, 16, 16)
    uint8 (the final MC luma) and aux = dict(wins, full_my/mx, cy4/cx4)
    for partition-search and chroma-MC reuse.
    """
    lam = lambda_me(qp)
    nmb = mb_height * mb_width
    if mvp_y is None:
        mvp_y = jnp.zeros((nmb,), jnp.int32)
    if mvp_x is None:
        mvp_x = jnp.zeros((nmb,), jnp.int32)

    cur4 = downsample4(cur_plane)
    cy4, cx4 = coarse_search_4x(cur4, ref4_pad, lam, mb_height, mb_width,
                                row_offset, mvp_y, mvp_x)

    # spatial predictor from the dense coarse field: every later stage
    # costs MV bits against it (see module docstring)
    mvp_y, mvp_x = spatial_predictor(cy4, cx4, mb_height, mb_width)

    cur_i = cur_tiles.astype(jnp.int32)

    # ---- candidate full-pel centres: coarse winner, zero MV, previous
    # frame's MV. The coarse winner alone is unreliable on periodic
    # content (the 4x pyramid aliases: a chessboard matches itself at
    # multiples of its cell period); the zero-MV and previous-MV
    # candidates restore the local minimum the reference's
    # descent-from-predictor reaches (`src/h264-lab.h:5263-5277`).
    #
    # Like the reference (`:5388-5412`), the BEST candidate is selected
    # first — full-resolution 16x16 SAD + lambda*mv-bits per centre —
    # and only the winner's window is refined. Gather-callsite economy
    # is the design rule: a vmapped per-MB dynamic_slice pays a
    # per-index overhead whatever the slice size, so the centre SADs
    # come from static slices of the same
    # windows (zero-MV windows are static tiling — no gather at all)
    # and the whole search performs exactly two gathers.
    def centre_cost(win_i, cy, cx):
        blk = win_i[:, WIN_M:WIN_M + 16, WIN_M:WIN_M + 16]
        return (jnp.sum(jnp.abs(cur_i - blk), axis=(1, 2))
                + lam * (mv_bits(cy * 4 - mvp_y)
                         + mv_bits(cx * 4 - mvp_x)))

    win_z = _tiled_windows(ref_pad, mb_height, mb_width,
                           row_offset).astype(jnp.int32)
    zero = jnp.zeros((nmb,), jnp.int32)
    best_ccost = centre_cost(win_z, zero, zero)
    cm_y = jnp.zeros((nmb,), jnp.int32)
    cm_x = jnp.zeros((nmb,), jnp.int32)
    win = win_z
    cands = [(4 * cy4, 4 * cx4)]
    if prev_my is not None:
        cands.append((jnp.clip(prev_my, -MAX_CAND_FP, MAX_CAND_FP),
                      jnp.clip(prev_mx, -MAX_CAND_FP, MAX_CAND_FP)))
    for cy, cx in cands:
        win_c = _slice_windows(ref_pad, base_y + cy - WIN_M,
                               base_x + cx - WIN_M,
                               WIN_S, WIN_S).astype(jnp.int32)
        cost = centre_cost(win_c, cy, cx)
        upd = cost < best_ccost
        best_ccost = jnp.where(upd, cost, best_ccost)
        cm_y = jnp.where(upd, cy, cm_y)
        cm_x = jnp.where(upd, cx, cm_x)
        win = jnp.where(upd[:, None, None], win_c, win)

    def refine_cost(sad, dy, dx):
        return sad + lam * (mv_bits((cm_y + dy) * 4 - mvp_y)
                            + mv_bits((cm_x + dx) * 4 - mvp_x))

    best_cost, best_dy, best_dx = _sweep_fullpel(
        cur_i, win, WIN_M, WIN_M, REFINE_R, refine_cost)
    full_my = cm_y + best_dy
    full_mx = cm_x + best_dx

    # re-centre the window on the refined winner: A[p] = win[winner-5+p]
    A = _shift_select(win, best_dy, -REFINE_R, REFINE_R,
                      WIN_M - 5, ALN_S, axis=1)
    A = _shift_select(A, best_dx, -REFINE_R, REFINE_R,
                      WIN_M - 5, ALN_S, axis=2)

    # materialize the refine stage: the candidate sweeps above are long
    # select chains that XLA's fusion otherwise *duplicates into every
    # consumer* (measured: a 12-MB P frame exploded to ~560k scalarized
    # HLO instructions and ~2 min of CPU time without these cuts)
    best_cost, full_my, full_mx, A = jax.lax.optimization_barrier(
        (best_cost, full_my, full_mx, A))

    aux = dict(cy4=cy4, cx4=cx4, full_my=full_my, full_mx=full_mx,
               wins=None, mvp_y=mvp_y, mvp_x=mvp_x)

    if not enable_subpel:
        pred = A[:, 5:21, 5:21]
        return (full_my * 4, full_mx * 4, best_cost,
                pred.astype(jnp.uint8), aux)

    # ---- sub-pel: hpel from the aligned window, dense +-0.75 sweep ----
    wins = _hpel_from_window(A)
    aux["wins"] = wins

    skip_thr = SKIP_THR_BASE + qp.astype(jnp.int32) * SKIP_THR_QP

    def qpel_cost(sad, dyq, dxq):
        mvy = full_my * 4 + dyq
        mvx = full_mx * 4 + dxq
        cost = sad + lam * (mv_bits(mvy - mvp_y) + mv_bits(mvx - mvp_x))
        # early-skip bias: the position that would extend a skip run
        # (mv == predictor) gets a bits bonus when its SAD clears the
        # skip threshold (ops/tuning.py; ref `src/h264-lab.h:5306`)
        at_pred = (mvy == mvp_y) & (mvx == mvp_x) & (sad < skip_thr)
        return jnp.where(at_pred, cost - lam * SKIP_BIAS_BITS, cost)

    best_cost, dyq, dxq, best_pred = _sweep_qpel(
        cur_i, _phase_planes(wins), 3, qpel_cost)
    best_yq = full_my * 4 + dyq
    best_xq = full_mx * 4 + dxq
    best_yq, best_xq, best_cost, best_pred = jax.lax.optimization_barrier(
        (best_yq, best_xq, best_cost, best_pred))
    return best_yq, best_xq, best_cost, best_pred.astype(jnp.uint8), aux


# ---------------------------------------------------------------------------
# Partition motion search (16x8 / 8x16 / 8x8) from the shared windows
# ---------------------------------------------------------------------------

def _search_geometry(cur_tiles, wins, lam, offsets, bh: int, bw: int,
                     full_my, full_mx, mvp_y, mvp_x):
    """Search all blocks of one partition geometry: per-block dense +-2
    full-pel sweep (static slices of the aligned windows), shift-select
    re-centring, then one batched +-0.75 qpel sweep over every block.
    Returns (cost, mv_y_q, mv_x_q, pred), leading dim (n_blocks, k)."""
    k = cur_tiles.shape[0]
    nb = len(offsets)
    subs = [[], [], [], []]
    curs = []
    blk_my = []
    blk_mx = []
    for oy0, ox0 in offsets:
        cur_i = cur_tiles[:, oy0:oy0 + bh, ox0:ox0 + bw].astype(jnp.int32)
        curs.append(cur_i)

        # stage A: full-pel +-2 around the 16x16 winner
        def part_cost(sad, dy, dx):
            return sad + lam * (mv_bits((full_my + dy) * 4 - mvp_y)
                                + mv_bits((full_mx + dx) * 4 - mvp_x))

        best, bdy, bdx = _sweep_fullpel(cur_i, wins[0], 3 + oy0, 3 + ox0,
                                        2, part_cost)
        blk_my.append(full_my + bdy)
        blk_mx.append(full_mx + bdx)
        # re-centre (bh+2, bw+2) block windows on the block winner
        for i, w in enumerate(wins):
            t = _shift_select(w, bdy, -2, 2, 3 + oy0 - 1, bh + 2, axis=1)
            t = _shift_select(t, bdx, -2, 2, 3 + ox0 - 1, bw + 2, axis=2)
            subs[i].append(t)

    cur_b = jnp.concatenate(curs)
    sub = tuple(jnp.concatenate(s) for s in subs)
    bmy = jnp.concatenate(blk_my)
    bmx = jnp.concatenate(blk_mx)
    mvpy = jnp.concatenate([mvp_y] * nb)
    mvpx = jnp.concatenate([mvp_x] * nb)

    def qcost(sad, dyq, dxq):
        return sad + lam * (mv_bits(bmy * 4 + dyq - mvpy)
                            + mv_bits(bmx * 4 + dxq - mvpx))

    best_cost, dyq, dxq, best_pred = _sweep_qpel(
        cur_b, _phase_planes(sub), 1, qcost)
    best_yq = bmy * 4 + dyq
    best_xq = bmx * 4 + dxq
    best_yq, best_xq, best_cost, best_pred = jax.lax.optimization_barrier(
        (best_yq, best_xq, best_cost, best_pred))
    return (best_cost.reshape(nb, k), best_yq.reshape(nb, k),
            best_xq.reshape(nb, k), best_pred.reshape(nb, k, bh, bw))


def partition_search(cur_tiles, aux, qp, mvp_y=None, mvp_x=None):
    """Motion search for all sub-partitions of every MB from the shared
    ME windows (reference partition proposal + per-partition search,
    `src/h264-lab.h:5224-5256`, `:5423-5498`).

    Returns dict with per-shape quarter-pel MVs, costs, and predictions:
      mv16x8 (k, 2, 2), mv8x16 (k, 2, 2), mv8x8 (k, 4, 2) [..., (y, x)]
      cost*: (k,) summed costs; pred16x8/pred8x16/pred8x8: (k, 16, 16).
    """
    lam = lambda_me(qp)
    wins = aux["wins"]
    full_my = aux["full_my"]
    full_mx = aux["full_mx"]
    k = cur_tiles.shape[0]
    # default: the spatial predictor the 16x16 search costed against
    if mvp_y is None:
        mvp_y = aux.get("mvp_y")
        if mvp_y is None:
            mvp_y = jnp.zeros((k,), jnp.int32)
    if mvp_x is None:
        mvp_x = aux.get("mvp_x")
        if mvp_x is None:
            mvp_x = jnp.zeros((k,), jnp.int32)

    out = {}
    # 16x8 (top, bottom)
    c, my, mx, pr = _search_geometry(
        cur_tiles, wins, lam, [(0, 0), (8, 0)], 8, 16,
        full_my, full_mx, mvp_y, mvp_x)
    out["mv16x8"] = jnp.stack([my, mx], axis=-1).transpose(1, 0, 2)
    out["cost16x8"] = c[0] + c[1]
    out["pred16x8"] = jnp.concatenate([pr[0], pr[1]], axis=1)
    # 8x16 (left, right)
    c, my, mx, pr = _search_geometry(
        cur_tiles, wins, lam, [(0, 0), (0, 8)], 16, 8,
        full_my, full_mx, mvp_y, mvp_x)
    out["mv8x16"] = jnp.stack([my, mx], axis=-1).transpose(1, 0, 2)
    out["cost8x16"] = c[0] + c[1]
    out["pred8x16"] = jnp.concatenate([pr[0], pr[1]], axis=2)
    # 8x8 (raster quadrants)
    c, my, mx, pr = _search_geometry(
        cur_tiles, wins, lam, [(0, 0), (0, 8), (8, 0), (8, 8)], 8, 8,
        full_my, full_mx, mvp_y, mvp_x)
    out["mv8x8"] = jnp.stack([my, mx], axis=-1).transpose(1, 0, 2)
    out["cost8x8"] = c.sum(axis=0)
    top = jnp.concatenate([pr[0], pr[1]], axis=2)
    bot = jnp.concatenate([pr[2], pr[3]], axis=2)
    out["pred8x8"] = jnp.concatenate([top, bot], axis=1)
    return out
