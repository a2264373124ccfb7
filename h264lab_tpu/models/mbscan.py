"""Unified macroblock engine: one wavefront pipeline for I and P frames
with all three MB candidates — inter 16x16 (P only), Intra_16x16 and
Intra_4x4 — plus the unified CAVLC symbolization.

This is the batched re-design of the reference's `mb_encode` decision
cascade (`src/h264-lab.h:5724-5812`). Structure:

1. (P) pre-scan: hierarchical dense ME + MC + inter TQ, fully parallel
   (ops/me.py).
2. Wavefront `lax.scan` (slope-2 diagonals when i4x4 is on, to satisfy
   its top-right dependency): per MB evaluate the enabled candidates from
   carried recon edges, pick by SAD+lambda·bits cost, TQ, and emit
   per-diagonal outputs. The scan is built for minimum per-step kernel
   count: all precomputed per-MB inputs are fed in diagonal order as scan
   `xs` (zero in-step gathers for them), all per-MB outputs leave through
   scan `ys` (zero in-step scatters for them), and the only carried state
   is one packed (nmb, 72)-byte edge record per MB — exactly the data the
   C encoder keeps in its row buffers (`top_line` `src/h264-lab.h:745`).
3. In-loop deblocking as a second, light wavefront with all boundary
   strengths precomputed in parallel (reference `df_strength`/`mb_deblock`
   `src/h264-lab.h:5535-5716`). Legal because intra prediction reads
   *unfiltered* recon; only the reference picture needs the filter.
4. Post-scan, fully parallel: MV predictors/P_Skip, CBPs, nnz contexts,
   CAVLC symbol expansion, device-side syntax-order assembly.

MB selection encoding: sel 0 = inter, 1 = Intra_16x16, 2 = Intra_4x4.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from h264lab_tpu.ops import (cavlc, deblock, intra, intra4, me,
                             qpel, tables, transform)
from h264lab_tpu.ops.tuning import (INTRA_DEADZONE_Q8, INTER_DEADZONE_Q8,
                                    INTRA_IN_P_PENALTY_BITS, I4_PENALTY_BITS,
                                    INTER_ZERO_THR_Q8, INTER_ZERO_THR2_Q8,
                                    PART_16X8_PENALTY_BITS,
                                    PART_8X8_PENALTY_BITS)

SEL_INTER, SEL_I16, SEL_I4 = 0, 1, 2

_ZZ = jnp.asarray(tables.ZIGZAG_4x4)
_BLOCK_SCAN = jnp.asarray(tables.BLOCK_SCAN_4x4)
_CBP_INTRA_CODE = jnp.asarray(tables.CBP_TO_CODENUM[:, 0])
_CBP_INTER_CODE = jnp.asarray(tables.CBP_TO_CODENUM[:, 1])

# packed per-MB edge-record layout (uint8): recon edges + i4 edge modes
_E_BOT_Y = slice(0, 16)
_E_RIGHT_Y = slice(16, 32)
_E_BOT_U = slice(32, 40)
_E_RIGHT_U = slice(40, 48)
_E_BOT_V = slice(48, 56)
_E_RIGHT_V = slice(56, 64)
_E_EM_B = slice(64, 68)
_E_EM_R = slice(68, 72)
_E_BYTES = 72


def mb_to_blocks(mb: jnp.ndarray, nblk: int) -> jnp.ndarray:
    k = mb.shape[0]
    return mb.reshape(k, nblk, 4, nblk, 4).transpose(0, 1, 3, 2, 4)


def blocks_to_mb(blocks: jnp.ndarray) -> jnp.ndarray:
    k, n, _, _, _ = blocks.shape
    return blocks.transpose(0, 1, 3, 2, 4).reshape(k, n * 4, n * 4)


def _bitlen32(x):
    return 32 - jax.lax.clz(x.astype(jnp.int32))


def _ue_codes(v):
    code = v + 1
    return code.astype(jnp.uint32), (2 * _bitlen32(code) - 1).astype(jnp.int32)


def _se_codes(v):
    return _ue_codes(jnp.where(v > 0, 2 * v - 1, -2 * v))


def _quant_blocks(coef, qp, deadzone):
    """quant+dequant of (k, n, n, 4, 4) block grids where `qp` is a
    scalar or a per-MB (k,) array (mb_qp_delta support: QP only enters
    here, so per-MB QP costs one reshape, not a recompile of anything
    else)."""
    if jnp.ndim(qp) == 0:
        lev = transform.quant4x4(coef, qp, deadzone)
        return lev, transform.dequant4x4(lev, qp)
    k = coef.shape[0]
    c = coef.reshape(k, -1, 4, 4)
    lev = transform.quant4x4(c, qp[:, None], deadzone)
    deq = transform.dequant4x4(lev, qp[:, None])
    return lev.reshape(coef.shape), deq.reshape(coef.shape)


def _encode_luma_i16(src, pred, qp):
    sb = mb_to_blocks(src.astype(jnp.int32), 4)
    pb = mb_to_blocks(pred.astype(jnp.int32), 4)
    coef = transform.fdct4x4(sb - pb)
    dc = coef[..., 0, 0]
    dc_lev = transform.quant_luma_dc(dc, qp)
    dc_deq = transform.dequant_luma_dc(dc_lev, qp)
    ac_lev, deq = _quant_blocks(coef, qp, INTRA_DEADZONE_Q8)
    ac_lev = ac_lev.at[..., 0, 0].set(0)
    deq = deq.at[..., 0, 0].set(dc_deq)
    res = transform.idct4x4(deq)
    recon = jnp.clip(res + pb, 0, 255).astype(jnp.uint8)
    return dc_lev, ac_lev, blocks_to_mb(recon)


def _encode_chroma(src, pred, qpc, deadzone):
    """Chroma TQ for one plane batch (k, 8, 8); u and v are usually
    stacked along the batch axis for one fused call. `qpc` scalar or
    per-MB (k,)."""
    sb = mb_to_blocks(src.astype(jnp.int32), 2)
    pb = mb_to_blocks(pred.astype(jnp.int32), 2)
    coef = transform.fdct4x4(sb - pb)
    dc = coef[..., 0, 0]
    dc_lev = transform.quant_chroma_dc(dc, qpc)
    dc_deq = transform.dequant_chroma_dc(dc_lev, qpc)
    ac_lev, deq = _quant_blocks(coef, qpc, deadzone)
    ac_lev = ac_lev.at[..., 0, 0].set(0)
    deq = deq.at[..., 0, 0].set(dc_deq)
    res = transform.idct4x4(deq)
    recon = jnp.clip(res + pb, 0, 255).astype(jnp.uint8)
    return dc_lev, ac_lev, blocks_to_mb(recon)


def _encode_inter_luma(src, pred, qp, zero_thr: bool = True):
    sb = mb_to_blocks(src.astype(jnp.int32), 4)
    pb = mb_to_blocks(pred.astype(jnp.int32), 4)
    coef = transform.fdct4x4(sb - pb)
    lev, deq = _quant_blocks(coef, qp, INTER_DEADZONE_Q8)
    # zero-block thresholding (reference `zero_smallq`,
    # `src/h264-lab.h:2513-2534`; thresholds ours, ops/tuning.py): kill
    # a 4x4 whose coefficients all sit under THR1 quant steps, and a
    # whole 8x8 quarter under THR2 — scattered +-1 levels on noise-like
    # residual cost bits out of proportion to their distortion win.
    if zero_thr and INTER_ZERO_THR_Q8 > 0:
        if jnp.ndim(qp) == 0:
            thr1 = transform.zero_thr4x4(qp, INTER_ZERO_THR_Q8)
            thr2 = transform.zero_thr4x4(qp, INTER_ZERO_THR2_Q8)
        else:
            thr1 = transform.zero_thr4x4(qp, INTER_ZERO_THR_Q8) \
                [:, None, None]
            thr2 = transform.zero_thr4x4(qp, INTER_ZERO_THR2_Q8) \
                [:, None, None]
        a = jnp.abs(coef)                              # (k, 4, 4, 4, 4)
        z1 = jnp.all(a <= thr1, axis=(-2, -1))         # (k, 4, 4) blocks
        z2b = jnp.all(a <= thr2, axis=(-2, -1))
        # 8x8 quarters = 2x2 block groups
        z2q = (z2b.reshape(-1, 2, 2, 2, 2).transpose(0, 1, 3, 2, 4)
               .reshape(-1, 4, 4).all(axis=-1).reshape(-1, 2, 2))
        z2 = jnp.repeat(jnp.repeat(z2q, 2, axis=1), 2, axis=2)
        kill = (z1 | z2)[..., None, None]
        lev = jnp.where(kill, 0, lev)
        deq = jnp.where(kill, 0, deq)
    res = transform.idct4x4(deq)
    recon = jnp.clip(res + pb, 0, 255).astype(jnp.uint8)
    return lev, blocks_to_mb(recon)


# ---------------------------------------------------------------------------
# the frame pipeline, as separately-jittable stages
#
# Stage boundaries mirror the C encoder's own staging (`encode_slice`
# `src/h264-lab.h:6409-6461` drives mb_encode / mb_write / deblock as
# separate phases): ME+inter-TQ -> mode selection (+intra TQ) ->
# symbolization -> deblocking -> bit packing. Each stage compiles as its
# own XLA program: dispatch between stages costs microseconds, while
# compile cost becomes additive and *shared* across frame-type / speed /
# capacity variants (an IDR program and a P program reuse the same
# symbolize/deblock/pack executables) instead of multiplicative.
# ---------------------------------------------------------------------------


def _qp_views(qp, qpc, mb_width: int):
    """Uniform-vs-per-row QP plumbing: returns (qp0, tq_qp, tq_qpc,
    tq_qpc2, per_row_qp). Per-row (mb_height,) arrays feed MB-granular
    fine rate control via mb_qp_delta."""
    if jnp.ndim(qp) == 1:
        qp_mb = jnp.repeat(qp, mb_width)           # (nmb,)
        qpc_mb = jnp.repeat(qpc, mb_width)
        return qp[0], qp_mb, qpc_mb, jnp.concatenate([qpc_mb, qpc_mb]), True
    return qp, qp, qpc, qpc, False


def inter_stage_core(src_y_mb, src_u_mb, src_v_mb,
                     ref_y_pad, ref_u_pad, ref_v_pad, ref4_pad,
                     qp, qpc, mb_row_offset, prev_my, prev_mx,
                     mb_width: int, mb_height: int,
                     enable_partitions: bool = False,
                     enable_qpel: bool = True):
    """Stage 1 (P frames): hierarchical dense ME + partition search + MC
    + inter transform/quant — fully parallel over MBs (ops/me.py; the
    batched form of the reference's `inter_choose_mode` + diamond
    search, `src/h264-lab.h:5283-5524`)."""
    nmb = mb_width * mb_height
    rr = jnp.arange(nmb, dtype=jnp.int32) // mb_width
    cc = jnp.arange(nmb, dtype=jnp.int32) % mb_width
    qp0, tq_qp, _, tq_qpc2, _ = _qp_views(qp, qpc, mb_width)
    lam = me.lambda_me(qp0)

    base_y = qpel.GUARD + 16 * (rr + mb_row_offset)
    base_x = qpel.GUARD + 16 * cc
    # band luma plane for the gather-free hierarchical search
    cur_plane = (src_y_mb.reshape(mb_height, mb_width, 16, 16)
                 .transpose(0, 2, 1, 3)
                 .reshape(mb_height * 16, mb_width * 16))
    mv_y, mv_x, cost16, pred16, aux = me.motion_search_dense(
        cur_plane, src_y_mb, ref_y_pad, ref4_pad, base_y, base_x, qp0,
        mb_height, mb_width, mb_row_offset, enable_subpel=enable_qpel,
        prev_my=prev_my, prev_mx=prev_mx)

    # partition shapes: per-4x4-block MV grid; shape 0=16x16,
    # 1=16x8, 2=8x16, 3=8x8 (reference partition proposal+search,
    # `src/h264-lab.h:5224-5256`, `:5423-5498`)
    mv4_y = jnp.broadcast_to(mv_y[:, None, None], (nmb, 4, 4))
    mv4_x = jnp.broadcast_to(mv_x[:, None, None], (nmb, 4, 4))
    shape = jnp.zeros((nmb,), jnp.int32)
    inter_cost = cost16
    pred_y_inter = pred16
    if enable_partitions and enable_qpel:
        ps = me.partition_search(src_y_mb, aux, qp0)
        c168 = ps["cost16x8"] + lam * PART_16X8_PENALTY_BITS
        c816 = ps["cost8x16"] + lam * PART_16X8_PENALTY_BITS
        c88 = ps["cost8x8"] + lam * PART_8X8_PENALTY_BITS
        costs = jnp.stack([cost16, c168, c816, c88], axis=1)
        shape = jnp.argmin(costs, axis=1).astype(jnp.int32)
        inter_cost = jnp.min(costs, axis=1)

        half = jnp.asarray([0, 0, 1, 1])
        mv168_y = jnp.broadcast_to(
            ps["mv16x8"][:, half, 0][:, :, None], (nmb, 4, 4))
        mv168_x = jnp.broadcast_to(
            ps["mv16x8"][:, half, 1][:, :, None], (nmb, 4, 4))
        mv816_y = jnp.broadcast_to(
            ps["mv8x16"][:, half, 0][:, None, :], (nmb, 4, 4))
        mv816_x = jnp.broadcast_to(
            ps["mv8x16"][:, half, 1][:, None, :], (nmb, 4, 4))
        quad = jnp.asarray([[0, 0, 1, 1], [0, 0, 1, 1],
                            [2, 2, 3, 3], [2, 2, 3, 3]])
        mv88_y = ps["mv8x8"][:, quad, 0]
        mv88_x = ps["mv8x8"][:, quad, 1]
        sh = shape[:, None, None]
        mv4_y = jnp.where(sh == 1, mv168_y,
                          jnp.where(sh == 2, mv816_y,
                                    jnp.where(sh == 3, mv88_y, mv4_y)))
        mv4_x = jnp.where(sh == 1, mv168_x,
                          jnp.where(sh == 2, mv816_x,
                                    jnp.where(sh == 3, mv88_x, mv4_x)))
        pred_y_inter = jnp.where(
            sh == 1, ps["pred16x8"],
            jnp.where(sh == 2, ps["pred8x16"],
                      jnp.where(sh == 3, ps["pred8x8"], pred16)))
        pred_y_inter = pred_y_inter.astype(jnp.uint8)

    cb_y = qpel.GUARD // 2 + 8 * (rr + mb_row_offset)
    cb_x = qpel.GUARD // 2 + 8 * cc
    if enable_partitions and enable_qpel:
        # per-4x4-block MVs: the general (gather-based) chroma MC
        pred_u_inter = qpel.mc_chroma_grid(ref_u_pad, mv4_y, mv4_x,
                                           cb_y, cb_x)
        pred_v_inter = qpel.mc_chroma_grid(ref_v_pad, mv4_y, mv4_x,
                                           cb_y, cb_x)
    else:
        # uniform per-MB MV: windowed gather-free chroma MC
        pred_u_inter, pred_v_inter = qpel.mc_chroma_uniform(
            ref_u_pad, ref_v_pad, cb_y, cb_x,
            aux["full_my"], aux["full_mx"], mv_y, mv_x)
    lev_inter, recon_y_inter = _encode_inter_luma(
        src_y_mb, pred_y_inter, tq_qp)
    # u and v batched through one chroma TQ
    cdc_uv, cac_uv, recon_uv = _encode_chroma(
        jnp.concatenate([src_u_mb, src_v_mb]),
        jnp.concatenate([pred_u_inter, pred_v_inter]),
        tq_qpc2, INTER_DEADZONE_Q8)
    cdc_inter = jnp.stack([cdc_uv[:nmb], cdc_uv[nmb:]], axis=1)
    cac_inter = jnp.stack([cac_uv[:nmb], cac_uv[nmb:]], axis=1)
    recon_u_inter = recon_uv[:nmb]
    recon_v_inter = recon_uv[nmb:]
    return dict(mv_y=mv_y, mv_x=mv_x, mv4_y=mv4_y, mv4_x=mv4_x,
                shape=shape, inter_cost=inter_cost, lev_inter=lev_inter,
                recon_y_inter=recon_y_inter, recon_u_inter=recon_u_inter,
                recon_v_inter=recon_v_inter,
                cdc_inter=cdc_inter, cac_inter=cac_inter)


def _inter_dummies(nmb: int) -> dict:
    """Zero stage-1 outputs for intra frames/slices."""
    return dict(
        mv_y=jnp.zeros((nmb,), jnp.int32),
        mv_x=jnp.zeros((nmb,), jnp.int32),
        mv4_y=jnp.zeros((nmb, 4, 4), jnp.int32),
        mv4_x=jnp.zeros((nmb, 4, 4), jnp.int32),
        shape=jnp.zeros((nmb,), jnp.int32),
        inter_cost=jnp.full((nmb,), 1 << 30, jnp.int32),
        lev_inter=jnp.zeros((nmb, 4, 4, 4, 4), jnp.int32),
        recon_y_inter=jnp.zeros((nmb, 16, 16), jnp.uint8),
        recon_u_inter=jnp.zeros((nmb, 8, 8), jnp.uint8),
        recon_v_inter=jnp.zeros((nmb, 8, 8), jnp.uint8),
        cdc_inter=jnp.zeros((nmb, 2, 2, 2), jnp.int32),
        cac_inter=jnp.zeros((nmb, 2, 2, 2, 4, 4), jnp.int32))


def select_stage_core(src_y_mb, src_u_mb, src_v_mb, qp, qpc,
                      steps, avail_top, avail_left, inter,
                      mb_width: int, mb_height: int,
                      has_inter: bool, enable_i4x4: bool):
    """Stage 2: macroblock mode selection + intra encode — either the
    fully-parallel P path or the anti-diagonal wavefront scan (the
    re-design of the reference's `mb_encode` decision cascade,
    `src/h264-lab.h:5724-5812`). `inter` is stage 1's output dict (or
    None for intra frames). Returns the selection, all quantized levels,
    the unfiltered reconstruction, and the (intra-zeroed) MV fields."""
    nmb = mb_width * mb_height
    qp0, tq_qp, _, tq_qpc2, _ = _qp_views(qp, qpc, mb_width)
    lam = me.lambda_me(qp0)
    if inter is None:
        inter = _inter_dummies(nmb)
    inter_cost = inter["inter_cost"]
    recon_y_inter = inter["recon_y_inter"]
    recon_u_inter = inter["recon_u_inter"]
    recon_v_inter = inter["recon_v_inter"]
    cdc_inter = inter["cdc_inter"]
    cac_inter = inter["cac_inter"]
    mv_y, mv_x = inter["mv_y"], inter["mv_x"]
    mv4_y, mv4_x = inter["mv4_y"], inter["mv4_x"]
    shape = inter["shape"]
    lev_inter = inter["lev_inter"]

    if has_inter and not enable_i4x4:
        # Fully parallel P path — no wavefront. Intra prediction must read
        # the decoder's reconstruction of the left/top neighbours; an
        # encoder-side mode constraint makes that reconstruction known in
        # advance: an MB may only be Intra_16x16 if its in-slice left and
        # top neighbours are inter. Then every intra prediction reads
        # *inter* recon (precomputed in stage 1) and the whole frame
        # encodes in one batched dispatch. The constraint is evaluated on
        # the pre-selection "wants intra" mask, so it is parallel and
        # deterministic; it only costs RD when intra MBs would cluster
        # (the reference's sequential cascade `src/h264-lab.h:5724-5812`
        # allows runs of intra MBs — rare inside P frames, and scene cuts
        # go through IDR/rate-control instead).
        z_row = jnp.zeros((mb_width, 16), jnp.uint8)
        z_col = jnp.zeros((1, 16), jnp.uint8)
        top_row = jnp.concatenate([z_row, recon_y_inter[:-mb_width, 15, :]])
        left_col = jnp.concatenate([z_col, recon_y_inter[:-1, :, 15]])

        preds, valid16 = intra.predict_16x16(top_row, left_col,
                                             avail_top, avail_left)
        mode16, pred_y16, cost16 = intra.select_mode(src_y_mb, preds,
                                                     valid16)
        icost16 = cost16 + lam * INTRA_IN_P_PENALTY_BITS
        want = icost16 < inter_cost
        want_l = jnp.concatenate([jnp.zeros((1,), bool), want[:-1]])
        want_t = jnp.concatenate([jnp.zeros((mb_width,), bool),
                                  want[:-mb_width]])
        sel = jnp.where(want & ~(want_l & avail_left)
                        & ~(want_t & avail_top),
                        SEL_I16, SEL_INTER).astype(jnp.int32)
        is_i16_mb = sel == SEL_I16

        dc_lev, ac_lev, rec_y16 = _encode_luma_i16(src_y_mb, pred_y16,
                                                   tq_qp)

        # chroma intra (u and v batched), edges from inter recon
        zc_row = jnp.zeros((mb_width, 8), jnp.uint8)
        zc_col = jnp.zeros((1, 8), jnp.uint8)
        top_c = jnp.concatenate([
            jnp.concatenate([zc_row, recon_u_inter[:-mb_width, 7, :]]),
            jnp.concatenate([zc_row, recon_v_inter[:-mb_width, 7, :]])])
        left_c = jnp.concatenate([
            jnp.concatenate([zc_col, recon_u_inter[:-1, :, 7]]),
            jnp.concatenate([zc_col, recon_v_inter[:-1, :, 7]])])
        a_top2 = jnp.concatenate([avail_top, avail_top])
        a_left2 = jnp.concatenate([avail_left, avail_left])
        preds_c, valid_c = intra.predict_chroma(top_c, left_c,
                                                a_top2, a_left2)
        src_c = jnp.concatenate([src_u_mb, src_v_mb])
        ccost2 = intra.sad(src_c[:, None], preds_c)
        ccost = ccost2[:nmb] + ccost2[nmb:]
        ccost = jnp.where(valid_c[:nmb], ccost, jnp.int32(1 << 30))
        cmode = jnp.argmin(ccost, axis=1).astype(jnp.int32)
        cm2 = jnp.concatenate([cmode, cmode])
        pred_c = jnp.take_along_axis(preds_c, cm2[:, None, None, None],
                                     axis=1)[:, 0]
        cdc_c, cac_c, rec_c = _encode_chroma(src_c, pred_c, tq_qpc2,
                                             INTRA_DEADZONE_Q8)
        cdc_intra = jnp.stack([cdc_c[:nmb], cdc_c[nmb:]], axis=1)
        cac_intra = jnp.stack([cac_c[:nmb], cac_c[nmb:]], axis=1)

        m_i = is_i16_mb[:, None, None]
        recon_y = jnp.where(m_i, rec_y16, recon_y_inter)
        recon_u = jnp.where(m_i, rec_c[:nmb], recon_u_inter)
        recon_v = jnp.where(m_i, rec_c[nmb:], recon_v_inter)
        i4modes = jnp.full((nmb, 16), 2, jnp.int32)
        i4sym_v = jnp.zeros((nmb, 16), jnp.uint32)
        i4sym_l = jnp.zeros((nmb, 16), jnp.int32)
    else:
        (sel, mode16, cmode, dc_lev, ac_lev, cdc_intra, cac_intra,
         recon_y, recon_u, recon_v, i4modes, i4sym_v, i4sym_l) = \
            _wavefront_scan(
                src_y_mb, src_u_mb, src_v_mb, qp, qpc,
                steps, avail_top, avail_left,
                inter_cost, recon_y_inter, recon_u_inter, recon_v_inter,
                lam, mb_width, nmb, has_inter, enable_i4x4)

    is_intra_mb = sel != SEL_INTER
    cdc_lev = jnp.where(is_intra_mb[:, None, None, None],
                        cdc_intra, cdc_inter)
    cac_lev = jnp.where(is_intra_mb[:, None, None, None, None, None],
                        cac_intra, cac_inter)
    mv_y = jnp.where(is_intra_mb, 0, mv_y)
    mv_x = jnp.where(is_intra_mb, 0, mv_x)
    mv4_y = jnp.where(is_intra_mb[:, None, None], 0, mv4_y)
    mv4_x = jnp.where(is_intra_mb[:, None, None], 0, mv4_x)
    shape = jnp.where(is_intra_mb, 0, shape)

    # materialize the mode-decision outputs before they fan out into
    # symbolization AND deblocking: both consume the same select chains,
    # and XLA would otherwise clone the whole upstream pipeline into
    # each consumer fusion (see the barrier note in ops/me.py). Staged
    # dispatch makes this a no-op (the jit boundary is the barrier); the
    # single-program composition (encode_frame_core) still needs it.
    (sel, recon_y, recon_u, recon_v, cdc_lev, cac_lev, lev_inter,
     dc_lev, ac_lev, mv_y, mv_x, mv4_y, mv4_x, shape) = \
        jax.lax.optimization_barrier(
            (sel, recon_y, recon_u, recon_v, cdc_lev, cac_lev, lev_inter,
             dc_lev, ac_lev, mv_y, mv_x, mv4_y, mv4_x, shape))
    return dict(sel=sel, mode16=mode16, cmode=cmode, dc_lev=dc_lev,
                ac_lev=ac_lev, cdc_lev=cdc_lev, cac_lev=cac_lev,
                lev_inter=lev_inter, i4modes=i4modes,
                i4sym_v=i4sym_v, i4sym_l=i4sym_l,
                recon_y=recon_y, recon_u=recon_u, recon_v=recon_v,
                mv_y=mv_y, mv_x=mv_x, mv4_y=mv4_y, mv4_x=mv4_x,
                shape=shape)


def deblock_stage_core(recon_y, recon_u, recon_v, sel, lev_inter,
                       mv4_y, mv4_x, qp, qpc,
                       avail_top, avail_left,
                       mb_width: int, mb_height: int):
    """Stage 4: in-loop deblocking. `qp`/`qpc` are scalars (uniform
    slice QP) or per-MB (nmb,) *decoded* QPs (the running QP from the
    dQP chain — per-row fine RC)."""
    nnz_inter_blk = jnp.sum(lev_inter != 0, axis=(-2, -1)).astype(jnp.int32)
    return deblock_frame(
        recon_y, recon_u, recon_v, sel, nnz_inter_blk, mv4_y, mv4_x,
        qp, qpc, avail_top, avail_left, mb_width, mb_height)


def encode_frame_core(src_y_mb, src_u_mb, src_v_mb,
                      ref_y_pad, ref_u_pad, ref_v_pad, ref4_pad,
                      qp, qpc, steps, avail_top, avail_left,
                      mb_width: int, mb_height: int,
                      has_inter: bool, enable_i4x4: bool,
                      enable_deblock: bool = False,
                      enable_partitions: bool = False,
                      enable_qpel: bool = True,
                      svc_base_mode_bit: bool = False,
                      mb_row_offset=0,
                      prev_my=None, prev_mx=None):
    """Encode one frame or slice band as ONE composed program (the
    staged pipeline fused back together — see encoder/gop for the
    staged dispatch that compiles each stage separately). For I frames
    pass dummy ref planes and has_inter=False (they are ignored).
    `mb_row_offset` places a band within the full-frame reference planes
    (multi-slice encoding): all entropy/prediction contexts stay
    band-local (slices are independent), but motion compensation reads
    the full reference picture.

    `qp`/`qpc` may be scalars (uniform slice QP) or per-MB-row
    (mb_height,) arrays — MB-granular fine rate control via
    `mb_qp_delta` (reference `rc_mb_end`, `src/h264-lab.h:6146-6179`).
    Per-row QP is supported on the fully-parallel P path (has_inter and
    not enable_i4x4): QP only enters quantization, the dQP syntax and
    the deblocking thresholds, so the row plan adds no wavefront
    dependency."""
    per_row_qp = jnp.ndim(qp) == 1
    if per_row_qp and not (has_inter and not enable_i4x4):
        raise NotImplementedError(
            "per-row QP requires the fully-parallel P path "
            "(encode_speed >= 2)")
    if has_inter:
        inter = inter_stage_core(
            src_y_mb, src_u_mb, src_v_mb,
            ref_y_pad, ref_u_pad, ref_v_pad, ref4_pad,
            qp, qpc, mb_row_offset, prev_my, prev_mx,
            mb_width=mb_width, mb_height=mb_height,
            enable_partitions=enable_partitions, enable_qpel=enable_qpel)
    else:
        inter = None
    st = select_stage_core(
        src_y_mb, src_u_mb, src_v_mb, qp, qpc,
        steps, avail_top, avail_left, inter,
        mb_width=mb_width, mb_height=mb_height,
        has_inter=has_inter, enable_i4x4=enable_i4x4)

    # ---------------- stage 3: symbolization -----------------------------
    # (before deblocking: with per-row QP the filter must use the
    # *decoded* running QP that symbolization derives from the dQP chain)
    out = symbolize(st["sel"], st["mode16"], st["cmode"], st["i4modes"],
                    st["i4sym_v"], st["i4sym_l"],
                    st["mv4_y"], st["mv4_x"], st["shape"], st["dc_lev"],
                    st["ac_lev"], st["lev_inter"],
                    st["cdc_lev"], st["cac_lev"],
                    mb_width, mb_height, has_inter,
                    svc_base_mode_bit=svc_base_mode_bit,
                    qp_rows=qp if per_row_qp else None)

    # ---------------- stage 4: deblocking --------------------------------
    if enable_deblock:
        if per_row_qp:
            qp_db = out["qp_dec"]
            qpc_db = jnp.asarray(tables.QPC_FROM_QPY)[qp_db]
        else:
            qp_db, qpc_db = qp, qpc
        df_y, df_u, df_v = deblock_stage_core(
            st["recon_y"], st["recon_u"], st["recon_v"], st["sel"],
            st["lev_inter"], st["mv4_y"], st["mv4_x"], qp_db, qpc_db,
            avail_top, avail_left, mb_width, mb_height)
    else:
        df_y, df_u, df_v = st["recon_y"], st["recon_u"], st["recon_v"]
    out.update(dict(recon_y=st["recon_y"], recon_u=st["recon_u"],
                    recon_v=st["recon_v"],
                    df_y=df_y, df_u=df_u, df_v=df_v,
                    mv_y=st["mv_y"], mv_x=st["mv_x"],
                    mv4_y=st["mv4_y"], mv4_x=st["mv4_x"],
                    shape=st["shape"], sel=st["sel"],
                    i4modes=st["i4modes"]))
    return out


def _wavefront_scan(src_y_mb, src_u_mb, src_v_mb, qp, qpc,
                    steps, avail_top, avail_left,
                    inter_cost, recon_y_inter, recon_u_inter, recon_v_inter,
                    lam, mb_width: int, nmb: int,
                    has_inter: bool, enable_i4x4: bool):
    """The anti-diagonal wavefront `lax.scan` over MBs (I frames and
    quality-mode P frames with intra 4x4)."""
    n_steps, kmax = steps.shape
    steps_w = jnp.where(steps < 0, nmb, steps)       # dead lanes -> pad row

    def diag_order(x, fill=0):
        """Re-lay a (nmb, ...) per-MB array as (n_steps, kmax, ...) scan
        input in diagonal order (one parallel row-gather)."""
        pad = jnp.full((1,) + x.shape[1:], fill, x.dtype)
        return jnp.concatenate([x, pad])[steps_w]

    xs = dict(
        idx=steps,
        a_top=diag_order(avail_top, False),
        a_left=diag_order(avail_left, False),
        src_y=diag_order(src_y_mb),
        src_u=diag_order(src_u_mb),
        src_v=diag_order(src_v_mb),
    )
    if has_inter:
        xs.update(
            inter_cost=diag_order(inter_cost, 1 << 30),
            rec_y_i=diag_order(recon_y_inter),
            rec_u_i=diag_order(recon_u_inter),
            rec_v_i=diag_order(recon_v_inter),
        )
    intra_pen = lam * INTRA_IN_P_PENALTY_BITS if has_inter else 0

    def step(E, xt):
        idx = xt["idx"]
        mask = idx >= 0
        cidx = jnp.maximum(idx, 0)
        widx = jnp.where(mask, cidx, nmb)
        a_top = xt["a_top"]
        a_left = xt["a_left"]
        c_i = cidx % mb_width
        tidx = jnp.maximum(cidx - mb_width, 0)
        lidx = jnp.maximum(cidx - 1, 0)
        k = cidx.shape[0]

        src_y = xt["src_y"]
        Et = E[tidx]
        El = E[lidx]
        top_row = Et[:, _E_BOT_Y]
        left_col = El[:, _E_RIGHT_Y]

        # ---- intra 16x16 candidate ----
        preds, valid = intra.predict_16x16(top_row, left_col, a_top, a_left)
        m16, pred_y16, cost16 = intra.select_mode(src_y, preds, valid)
        dc_lev, ac_lev16, rec_y16 = _encode_luma_i16(src_y, pred_y16, qp)

        # ---- intra 4x4 candidate ----
        if enable_i4x4:
            a_tl = a_top & a_left
            tlidx = jnp.maximum(cidx - mb_width - 1, 0)
            tridx = jnp.maximum(cidx - mb_width + 1, 0)
            a_tr = a_top & (c_i < mb_width - 1)
            i4 = intra4.encode_i4x4_mb(
                src_y, top_row, left_col,
                E[tlidx][:, 15], E[tridx][:, 0:4],
                a_top, a_left, a_tl, a_tr,
                El[:, _E_EM_R].astype(jnp.int32),
                Et[:, _E_EM_B].astype(jnp.int32),
                qp, INTRA_DEADZONE_Q8, lam)
            cost4 = i4["cost"] + lam * I4_PENALTY_BITS
        else:
            i4 = None
            cost4 = jnp.full((k,), 1 << 30, jnp.int32)

        # ---- chroma (intra), u and v batched ----
        top_c = jnp.concatenate([Et[:, _E_BOT_U], Et[:, _E_BOT_V]])
        left_c = jnp.concatenate([El[:, _E_RIGHT_U], El[:, _E_RIGHT_V]])
        a_top2 = jnp.concatenate([a_top, a_top])
        a_left2 = jnp.concatenate([a_left, a_left])
        preds_c, valid_c = intra.predict_chroma(top_c, left_c,
                                                a_top2, a_left2)
        src_c = jnp.concatenate([xt["src_u"], xt["src_v"]])
        ccost2 = intra.sad(src_c[:, None], preds_c)          # (2k, 3)
        ccost = ccost2[:k] + ccost2[k:]
        ccost = jnp.where(valid_c[:k], ccost, jnp.int32(1 << 30))
        cm = jnp.argmin(ccost, axis=1).astype(jnp.int32)
        cm2 = jnp.concatenate([cm, cm])
        pred_c = jnp.take_along_axis(preds_c, cm2[:, None, None, None],
                                     axis=1)[:, 0]
        cdc_c, cac_c, rec_c = _encode_chroma(src_c, pred_c, qpc,
                                             INTRA_DEADZONE_Q8)

        # ---- selection ----
        icost16 = cost16 + intra_pen
        icost4 = cost4 + (intra_pen if enable_i4x4 else 0)
        if has_inter:
            costs = jnp.stack([xt["inter_cost"], icost16, icost4], axis=1)
        else:
            costs = jnp.stack([jnp.full((k,), 1 << 30, jnp.int32),
                               icost16, icost4], axis=1)
        sel = jnp.argmin(costs, axis=1).astype(jnp.int32)

        is_i4 = sel == SEL_I4
        is_intra = sel != SEL_INTER
        rec_y_intra = jnp.where(is_i4[:, None, None], i4["recon"], rec_y16) \
            if enable_i4x4 else rec_y16
        rec_u_i = rec_c[:k]
        rec_v_i = rec_c[k:]
        if has_inter:
            rec_y = jnp.where(is_intra[:, None, None], rec_y_intra,
                              xt["rec_y_i"])
            rec_u = jnp.where(is_intra[:, None, None], rec_u_i,
                              xt["rec_u_i"])
            rec_v = jnp.where(is_intra[:, None, None], rec_v_i,
                              xt["rec_v_i"])
        else:
            rec_y, rec_u, rec_v = rec_y_intra, rec_u_i, rec_v_i

        # i4x4 edge-mode context for later MBs (2 = DC when not i4x4)
        if enable_i4x4:
            em_b = jnp.where(is_i4[:, None], i4["modes"][:, 12:16], 2)
            em_r = jnp.where(is_i4[:, None], i4["modes"][:, 3::4], 2)
            ac_store = jnp.where(is_i4[:, None, None, None, None],
                                 i4["levels"], ac_lev16)
        else:
            em_b = jnp.full((k, 4), 2, jnp.int32)
            em_r = jnp.full((k, 4), 2, jnp.int32)
            ac_store = ac_lev16

        # ---- new edge record, single carry scatter ----
        rec_new = jnp.concatenate([
            rec_y[:, -1, :], rec_y[:, :, -1],
            rec_u[:, -1, :], rec_u[:, :, -1],
            rec_v[:, -1, :], rec_v[:, :, -1],
            em_b.astype(jnp.uint8), em_r.astype(jnp.uint8)], axis=1)
        E = E.at[widx].set(rec_new, mode="drop")

        ys = dict(sel=sel, mode16=m16, cmode=cm,
                  dc_lev=dc_lev, ac_store=ac_store,
                  cdc_i=jnp.stack([cdc_c[:k], cdc_c[k:]], axis=1),
                  cac_i=jnp.stack([cac_c[:k], cac_c[k:]], axis=1),
                  rec_y=rec_y, rec_u=rec_u, rec_v=rec_v)
        if enable_i4x4:
            ys.update(i4modes=i4["modes"], i4sym_v=i4["mode_sym_val"],
                      i4sym_l=i4["mode_sym_len"])
        return E, ys

    E0 = jnp.zeros((nmb + 1, _E_BYTES), jnp.uint8)
    _, ys = jax.lax.scan(step, E0, xs)

    # undo the diagonal ordering with one parallel gather per output;
    # the inverse permutation is a single scatter of slot positions
    inv = (jnp.zeros((nmb,), jnp.int32)
           .at[steps_w.reshape(-1)]
           .set(jnp.arange(n_steps * kmax, dtype=jnp.int32), mode="drop"))

    def undiag(x):
        return x.reshape((n_steps * kmax,) + x.shape[2:])[inv]

    sel = undiag(ys["sel"])
    mode16 = undiag(ys["mode16"])
    cmode = undiag(ys["cmode"])
    dc_lev = undiag(ys["dc_lev"])
    ac_lev = undiag(ys["ac_store"])
    cdc_intra = undiag(ys["cdc_i"])
    cac_intra = undiag(ys["cac_i"])
    recon_y = undiag(ys["rec_y"])
    recon_u = undiag(ys["rec_u"])
    recon_v = undiag(ys["rec_v"])
    if enable_i4x4:
        i4modes = undiag(ys["i4modes"])
        i4sym_v = undiag(ys["i4sym_v"])
        i4sym_l = undiag(ys["i4sym_l"])
    else:
        i4modes = jnp.full((nmb, 16), 2, jnp.int32)
        i4sym_v = jnp.zeros((nmb, 16), jnp.uint32)
        i4sym_l = jnp.zeros((nmb, 16), jnp.int32)

    return (sel, mode16, cmode, dc_lev, ac_lev, cdc_intra, cac_intra,
            recon_y, recon_u, recon_v, i4modes, i4sym_v, i4sym_l)


# ---------------------------------------------------------------------------
# deblocking: parallel bS derivation + light wavefront filter scan
# ---------------------------------------------------------------------------

def _frame_bs(sel, nnz_blk, mv4_y, mv4_x, avail_top, avail_left,
              mb_width: int, mb_height: int):
    """Boundary strengths for every MB, fully parallel (the hoisted
    equivalent of the reference's per-MB `df_strength`,
    `src/h264-lab.h:5535-5637`). Returns (bs_v, bs_h): (nmb, 4, 4)."""
    nmb = mb_width * mb_height
    is_intra = sel != SEL_INTER
    nnz_pad = jnp.concatenate([nnz_blk, jnp.zeros((1, 4, 4), jnp.int32)])
    mvy_pad = jnp.concatenate([mv4_y, jnp.zeros((1, 4, 4), jnp.int32)])
    mvx_pad = jnp.concatenate([mv4_x, jnp.zeros((1, 4, 4), jnp.int32)])
    intra_pad = jnp.concatenate([is_intra, jnp.zeros((1,), bool)])
    idx = jnp.arange(nmb, dtype=jnp.int32)
    rr = idx // mb_width
    cc = idx % mb_width
    has_left = (cc > 0) & avail_left
    has_top = (rr > 0) & avail_top
    li = jnp.where(has_left, idx - 1, nmb)
    ti = jnp.where(has_top, idx - mb_width, nmb)

    def edges(nb_i, has_nb, vertical):
        def sel_e(a, edge):
            return a[:, :, edge] if vertical else a[:, edge, :]

        out = []
        bs0 = deblock.mb_edge_bs(
            intra_pad[nb_i][:, None], is_intra[:, None],
            sel_e(nnz_pad[nb_i], 3), sel_e(nnz_blk, 0),
            sel_e(mvy_pad[nb_i], 3), sel_e(mvx_pad[nb_i], 3),
            sel_e(mv4_y, 0), sel_e(mv4_x, 0), True)
        out.append(jnp.where(has_nb[:, None], bs0, 0))
        for e in range(1, 4):
            bse = deblock.mb_edge_bs(
                is_intra[:, None], is_intra[:, None],
                sel_e(nnz_blk, e - 1), sel_e(nnz_blk, e),
                sel_e(mv4_y, e - 1), sel_e(mv4_x, e - 1),
                sel_e(mv4_y, e), sel_e(mv4_x, e), False)
            out.append(bse)
        return jnp.stack(out, axis=1)

    bs_v = edges(li, has_left, True)
    bs_h = edges(ti, has_top, False)
    return bs_v, bs_h


@functools.lru_cache(maxsize=32)
def _row_diag_plan(mb_width: int, mb_height: int):
    """Row-indexed slope-1 diagonal plan for the deblock scan.

    Step d, lane r processes MB (r, d - r). Lane index == MB row, so the
    left neighbour (r, d-1-r) sits at lane r of the *previous* diagonal
    and the top neighbour (r-1, d-r) at lane r-1 of the previous
    diagonal — both become static slices of the carry, no gathers.
    Returns (steps_by_row (n_steps+1, mbh) int32 with -1 fill, out_pos
    (nmb,) int32): MB i is finalized at flattened ys position out_pos[i].
    """
    n_steps = mb_width + mb_height - 1
    steps = np.full((n_steps + 1, mb_height), -1, dtype=np.int32)
    out_pos = np.zeros((mb_width * mb_height,), dtype=np.int32)
    for r in range(mb_height):
        for c in range(mb_width):
            steps[r + c, r] = r * mb_width + c
            # finalized one step after its own (right+below edges settle)
            out_pos[r * mb_width + c] = (r + c + 1) * mb_height + r
    return steps, out_pos


def deblock_frame(recon_y, recon_u, recon_v, sel, nnz_blk, mv4_y, mv4_x,
                  qp, qpc, avail_top, avail_left,
                  mb_width: int, mb_height: int):
    """In-loop deblocking of one frame/slice as a gather-free wavefront.

    bS precomputed in parallel; the scan walks slope-1 diagonals with the
    carry indexed *by MB row* (see _row_diag_plan), so every neighbour
    access in the step body is a static slice/shift of a (mbh, ...)
    buffer and finalized MBs leave through scan ys. Slope 1 reproduces
    raster-order spec semantics exactly *because* each step runs its V
    pass over the whole diagonal before its H pass: the one cross-MB
    raster dependency inside a diagonal — MB (r,c)'s top-edge H filter
    reading pixels written by MB (r-1,c+1)'s left-edge V filter — is
    satisfied by the H pass re-reading the carry after the V updates
    (verified against the scalar raster decoder filter in
    tests/test_deblock_order.py). u and v are stacked through one
    filter call."""
    nmb = mb_width * mb_height
    mbh = mb_height
    steps_np, out_pos_np = _row_diag_plan(mb_width, mb_height)
    steps = jnp.asarray(steps_np)
    out_pos = jnp.asarray(out_pos_np)
    bs_v, bs_h = _frame_bs(sel, nnz_blk, mv4_y, mv4_x,
                           avail_top, avail_left, mb_width, mb_height)
    steps_w = jnp.where(steps < 0, nmb, steps)

    def diag_order(x, fill=0):
        pad = jnp.full((1,) + x.shape[1:], fill, x.dtype)
        return jnp.concatenate([x, pad])[steps_w]

    cur_c_all = jnp.stack([recon_u, recon_v], axis=1)     # (nmb, 2, 8, 8)
    xs = dict(valid=steps >= 0,
              cur_y=diag_order(recon_y).astype(jnp.int32),
              cur_c=diag_order(cur_c_all).astype(jnp.int32),
              bs_v=diag_order(bs_v), bs_h=diag_order(bs_h))

    per_mb_qp = jnp.ndim(qp) == 1
    if per_mb_qp:
        # per-edge QP (spec 8.7.2.1: MB edges use the two MBs' average,
        # internal edges the MB's own decoded QP), in diagonal order
        def edge_qps(q):
            q2 = q.reshape(mb_height, mb_width)
            left = jnp.concatenate([q2[:, :1], q2[:, :-1]], axis=1)
            top = jnp.concatenate([q2[:1, :], q2[:-1, :]], axis=0)
            va = ((q2 + left + 1) >> 1).reshape(-1)
            ha = ((q2 + top + 1) >> 1).reshape(-1)
            return (jnp.stack([va, q, q, q], axis=1),
                    jnp.stack([ha, q, q, q], axis=1))
        qv_l, qh_l = edge_qps(qp)
        qv_c, qh_c = edge_qps(qpc)
        xs.update(qv_l=diag_order(qv_l), qh_l=diag_order(qh_l),
                  qv_c=diag_order(qv_c[:, :2]),
                  qh_c=diag_order(qh_c[:, :2]))

    # materialize the scan inputs: without this barrier XLA fuses the
    # upstream producers (ME/TQ/selection) into the scan body and
    # recomputes them EVERY iteration — measured 115 s vs 0.2 s for a
    # 12-MB frame on CPU
    xs = jax.lax.optimization_barrier(xs)

    def step(carry, xt):
        P_y, P_c = carry                 # previous diagonal, by MB row
        valid = xt["valid"][:, None, None]
        cur_y = xt["cur_y"]
        cur_c = xt["cur_c"]
        bs_v = xt["bs_v"]
        bs_h = xt["bs_h"]
        if per_mb_qp:
            qp_v, qp_h = xt["qv_l"], xt["qh_l"]
            qpc_v, qpc_h = xt["qv_c"], xt["qh_c"]
        else:
            qp_v = qp_h = qp
            qpc_v = qpc_h = qpc

        # ---- luma V: 4 left cols from the left neighbour (lane r) ----
        strip = jnp.concatenate([P_y[:, :, 12:16], cur_y], axis=2)
        strip = deblock.filter_luma_v(strip, bs_v, qp_v, edge_x0=4)
        P_y = jnp.where(valid, P_y.at[:, :, 13:16].set(strip[:, :, 1:4]),
                        P_y)
        cur_y = strip[:, :, 4:20]
        # ---- luma H: 4 top rows from the top neighbour (lane r-1) ----
        P_y_up = jnp.concatenate([jnp.zeros_like(P_y[:1]), P_y[:-1]])
        strip = jnp.concatenate([P_y_up[:, 12:16, :], cur_y], axis=1)
        strip = deblock.filter_luma_h(strip, bs_h, qp_h, edge_y0=4)
        upd = jnp.concatenate([strip[1:, 1:4, :],
                               jnp.zeros_like(strip[:1, 1:4, :])])
        vshift = jnp.concatenate([xt["valid"][1:], jnp.zeros((1,), bool)])
        P_y = jnp.where(vshift[:, None, None],
                        P_y.at[:, 13:16, :].set(upd), P_y)
        cur_y = strip[:, 4:20, :]

        # ---- chroma (u, v stacked on a plane axis) ----
        strip = jnp.concatenate([P_c[:, :, :, 6:8], cur_c], axis=3)
        strip = deblock.filter_chroma_v(strip, bs_v, qpc_v, edge_x0=2)
        P_c = jnp.where(valid[:, None], P_c.at[:, :, :, 7:8].set(
            strip[:, :, :, 1:2]), P_c)
        cur_c = strip[:, :, :, 2:10]
        P_c_up = jnp.concatenate([jnp.zeros_like(P_c[:1]), P_c[:-1]])
        strip = jnp.concatenate([P_c_up[:, :, 6:8, :], cur_c], axis=2)
        strip = deblock.filter_chroma_h(strip, bs_h, qpc_h, edge_y0=2)
        updc = jnp.concatenate([strip[1:, :, 1:2, :],
                                jnp.zeros_like(strip[:1, :, 1:2, :])])
        P_c = jnp.where(vshift[:, None, None, None],
                        P_c.at[:, :, 7:8, :].set(updc), P_c)
        cur_c = strip[:, :, 2:10, :]

        ys = dict(y=P_y.astype(jnp.uint8), c=P_c.astype(jnp.uint8))
        return (cur_y, cur_c), ys

    P0 = (jnp.zeros((mbh, 16, 16), jnp.int32),
          jnp.zeros((mbh, 2, 8, 8), jnp.int32))
    _, ys = jax.lax.scan(step, P0, xs)

    n_total = steps.shape[0]
    df_y = ys["y"].reshape(n_total * mbh, 16, 16)[out_pos]
    df_c = ys["c"].reshape(n_total * mbh, 2, 8, 8)[out_pos]
    return df_y, df_c[:, 0], df_c[:, 1]


# ---------------------------------------------------------------------------
# post-scan symbolization
# ---------------------------------------------------------------------------

def _block_nc(nnz_grid, gw, gh, blk_avail_left, blk_avail_top):
    na = jnp.pad(nnz_grid, ((0, 0), (1, 0)))[:, :gw]
    nb = jnp.pad(nnz_grid, ((1, 0), (0, 0)))[:gh, :]
    both = blk_avail_left & blk_avail_top
    return jnp.where(both, (na + nb + 1) >> 1,
                     jnp.where(blk_avail_left, na,
                               jnp.where(blk_avail_top, nb, 0)))


def _median3(a, b, c):
    return jnp.maximum(jnp.minimum(jnp.maximum(a, b), c),
                       jnp.minimum(a, b))


def _mv_predictors(mv4_y, mv4_x, is_intra, mb_width, mb_height):
    """Per-partition MV predictors over the 4x4-block MV grid.

    Implements spec 8.4.1.3 incl. the directional 16x8/8x16 preferences
    and the neighbour availability of partitions in decode order, plus the
    8.4.1.1 P_Skip predictor. Returns a dict of (nmb, ...) arrays:
      mvp[shape][part] for the 4 shapes, skip predictor, per the fixed
      partition layouts (16x16; 16x8 top/bottom; 8x16 left/right; 8x8 q0..3).
    """
    mbh, mbw = mb_height, mb_width
    nmb = mbh * mbw
    BH, BW = 4 * mbh, 4 * mbw
    rr = jnp.arange(nmb, dtype=jnp.int32) // mbw
    cc = jnp.arange(nmb, dtype=jnp.int32) % mbw

    MVY = (mv4_y.reshape(mbh, mbw, 4, 4).transpose(0, 2, 1, 3)
           .reshape(BH, BW))
    MVX = (mv4_x.reshape(mbh, mbw, 4, 4).transpose(0, 2, 1, 3)
           .reshape(BH, BW))
    ref0_mb = (~is_intra).reshape(mbh, mbw)
    REF0 = jnp.repeat(jnp.repeat(ref0_mb, 4, 0), 4, 1)
    pad = ((1, 4), (1, 4))          # allow offsets -1..7
    MVYp = jnp.pad(MVY, pad)
    MVXp = jnp.pad(MVX, pad)
    REF0p = jnp.pad(REF0, pad)
    AVAILp = jnp.pad(jnp.ones((BH, BW), bool), pad)

    def blk(dy, dx, static_avail=True):
        """Neighbour block at MB-relative block offset (dy, dx) — a
        STRIDED STATIC SLICE (rows 4*rr+dy+1 = [1+dy::4]), not a gather:
        (dy, dx) come from the fixed partition tables, so every
        neighbour read is a dense vector slice."""
        def at(arr):
            return arr[1 + dy:1 + dy + 4 * mbh:4,
                       1 + dx:1 + dx + 4 * mbw:4].reshape(-1)
        avail = at(AVAILp) & static_avail
        ref = at(REF0p) & avail
        my = jnp.where(ref, at(MVYp), 0)
        mx = jnp.where(ref, at(MVXp), 0)
        return my, mx, ref, avail

    def derive(a, b, c, d, directional=None):
        """a/b/c/d = (dy, dx, static_avail). Returns (mvp_y, mvp_x)."""
        ay, ax, aref, aav = blk(*a)
        by, bx, bref, bav = blk(*b)
        cy, cx, cref, cav = blk(*c)
        dy_, dx_, dref, dav = blk(*d)
        # C unavailable -> D substitution (8.4.1.3.2)
        cy = jnp.where(cav, cy, dy_)
        cx = jnp.where(cav, cx, dx_)
        cref = jnp.where(cav, cref, dref)
        cav2 = cav | dav
        # B,C both unavailable and A available -> take A
        subst = (~bav) & (~cav2) & aav
        by = jnp.where(subst, ay, by)
        bx = jnp.where(subst, ax, bx)
        bref = jnp.where(subst, aref, bref)
        cy = jnp.where(subst, ay, cy)
        cx = jnp.where(subst, ax, cx)
        cref = jnp.where(subst, aref, cref)

        cnt = (aref.astype(jnp.int32) + bref.astype(jnp.int32)
               + cref.astype(jnp.int32))
        only_a = (cnt == 1) & aref
        only_b = (cnt == 1) & bref
        only_c = (cnt == 1) & cref
        mvp_y = jnp.where(only_a, ay, jnp.where(only_b, by,
                          jnp.where(only_c, cy, _median3(ay, by, cy))))
        mvp_x = jnp.where(only_a, ax, jnp.where(only_b, bx,
                          jnp.where(only_c, cx, _median3(ax, bx, cx))))
        if directional == "A":
            mvp_y = jnp.where(aref, ay, mvp_y)
            mvp_x = jnp.where(aref, ax, mvp_x)
        elif directional == "B":
            mvp_y = jnp.where(bref, by, mvp_y)
            mvp_x = jnp.where(bref, bx, mvp_x)
        elif directional == "C":
            mvp_y = jnp.where(cref, cy, mvp_y)
            mvp_x = jnp.where(cref, cx, mvp_x)
        return mvp_y, mvp_x

    A = lambda dy, dx: (dy, dx, True)
    NO = (0, 0, False)
    out = {}
    out[0] = [derive(A(0, -1), A(-1, 0), A(-1, 4), A(-1, -1))]
    out[1] = [derive(A(0, -1), A(-1, 0), A(-1, 4), A(-1, -1), "B"),
              derive(A(2, -1), A(1, 0), NO, A(1, -1), "A")]
    out[2] = [derive(A(0, -1), A(-1, 0), A(-1, 2), A(-1, -1), "A"),
              derive(A(0, 1), A(-1, 2), A(-1, 4), A(-1, 1), "C")]
    out[3] = [derive(A(0, -1), A(-1, 0), A(-1, 2), A(-1, -1)),
              derive(A(0, 1), A(-1, 2), A(-1, 4), A(-1, 1)),
              derive(A(2, -1), A(1, 0), A(1, 2), A(1, -1)),
              derive(A(2, 1), A(1, 2), NO, A(1, 1))]

    # P_Skip predictor (8.4.1.1): based on the 16x16 A/B neighbours
    ay, ax, aref, aav = blk(0, -1)
    by, bx, bref, bav = blk(-1, 0)
    a_zero = aref & (ay == 0) & (ax == 0)
    b_zero = bref & (by == 0) & (bx == 0)
    force0 = (~aav) | (~bav) | a_zero | b_zero
    skip_y = jnp.where(force0, 0, out[0][0][0])
    skip_x = jnp.where(force0, 0, out[0][0][1])
    return out, skip_y, skip_x


# partition layouts: top-left block (by, bx) per partition, per shape
_PART_BLOCKS = {
    0: [(0, 0)],
    1: [(0, 0), (2, 0)],
    2: [(0, 0), (0, 2)],
    3: [(0, 0), (0, 2), (2, 0), (2, 2)],
}
_N_PARTS = (1, 2, 2, 4)


def symbolize(sel, mode16, cmode, i4modes, i4sym_v, i4sym_l,
              mv4_y, mv4_x, shape, dc_lev, ac_lev, lev_inter, cdc_lev,
              cac_lev, mb_width: int, mb_height: int, has_inter: bool,
              svc_base_mode_bit: bool = False, qp_rows=None):
    """CAVLC + syntax symbol assembly for one slice (I or P).

    `svc_base_mode_bit`: slice lives in a scalable extension NAL with
    `adaptive_base_mode_flag=1` — every coded macroblock_layer leads
    with a base_mode_flag=0 bit (G.7.3.6.1; inter-layer intra frames
    write base_mode_flag=1 through models/svc.py instead).

    `qp_rows` ((mb_height,) or None): per-MB-row QP plan — emits real
    `mb_qp_delta` along the scan (spec 7.4.5; reference `rc_mb_end`)
    and returns the per-MB *decoded* running QP (`qp_dec`) that
    deblocking must use (MBs that emit no dQP inherit the running QP)."""
    nmb = mb_width * mb_height
    ns = cavlc.N_SLOTS
    is_inter = sel == SEL_INTER
    is_i16 = sel == SEL_I16
    is_i4 = sel == SEL_I4
    is_intra = ~is_inter

    # ---- nnz and cbp ------------------------------------------------------
    # ac_lev holds: i16 AC levels (DC zeroed) for i16 MBs, i4 full levels
    # for i4 MBs; lev_inter holds inter full levels.
    nnz_intra = jnp.sum(ac_lev != 0, axis=(-2, -1))            # (nmb,4,4)
    nnz_inter = jnp.sum(lev_inter != 0, axis=(-2, -1))
    cdc_nnz = jnp.sum(cdc_lev != 0, axis=(-2, -1))
    cac_nnz = jnp.sum(cac_lev != 0, axis=(-2, -1))

    def group_bits(nnz):
        grp = nnz.reshape(nmb, 2, 2, 2, 2).transpose(0, 1, 3, 2, 4)
        gnz = jnp.sum(grp, axis=(3, 4)) > 0
        return (gnz[:, 0, 0].astype(jnp.int32) + 2 * gnz[:, 0, 1]
                + 4 * gnz[:, 1, 0] + 8 * gnz[:, 1, 1])

    cbpl_i16 = (jnp.sum(nnz_intra, axis=(1, 2)) > 0)           # all-or-none
    cbpl_i4 = group_bits(nnz_intra)
    cbpl_inter = group_bits(nnz_inter)
    any_cac = jnp.sum(cac_nnz, axis=(1, 2, 3)) > 0
    any_cdc = jnp.sum(cdc_nnz, axis=1) > 0
    cbpc = jnp.where(any_cac, 2, jnp.where(any_cdc, 1, 0)).astype(jnp.int32)

    cbp_luma = jnp.where(is_i4, cbpl_i4,
                         jnp.where(is_inter, cbpl_inter,
                                   jnp.where(cbpl_i16, 15, 0)))
    cbp = cbp_luma + (cbpc << 4)

    # ---- predictors, skip (P) --------------------------------------------
    # per-partition MVDs: (nmb, 4) arrays, only the first _N_PARTS[shape]
    # entries are coded
    mvd_py = jnp.zeros((nmb, 4), jnp.int32)
    mvd_px = jnp.zeros((nmb, 4), jnp.int32)
    if has_inter:
        mvps, skip_y, skip_x = _mv_predictors(
            mv4_y, mv4_x, is_intra, mb_width, mb_height)
        for sh in range(4):
            for p, (by, bx) in enumerate(_PART_BLOCKS[sh]):
                sel_sh = shape == sh
                mvp_y, mvp_x = mvps[sh][p]
                mvd_py = mvd_py.at[:, p].set(
                    jnp.where(sel_sh, mv4_y[:, by, bx] - mvp_y,
                              mvd_py[:, p]))
                mvd_px = mvd_px.at[:, p].set(
                    jnp.where(sel_sh, mv4_x[:, by, bx] - mvp_x,
                              mvd_px[:, p]))
        skip = (is_inter & (shape == 0) & (cbp == 0)
                & (mv4_y[:, 0, 0] == skip_y) & (mv4_x[:, 0, 0] == skip_x))
    else:
        skip = jnp.zeros((nmb,), bool)
    coded = ~skip

    # ---- coded nnz for nC contexts ---------------------------------------
    luma_nnz = jnp.where(
        is_inter[:, None, None], nnz_inter,
        jnp.where(is_i4[:, None, None], nnz_intra,
                  jnp.where(cbpl_i16[:, None, None], nnz_intra, 0)))
    luma_nnz = jnp.where(skip[:, None, None], 0, luma_nnz)
    cac_nnz_coded = jnp.where((cbpc == 2)[:, None, None, None], cac_nnz, 0)
    cac_nnz_coded = jnp.where(skip[:, None, None, None], 0, cac_nnz_coded)

    gw, gh = 4 * mb_width, 4 * mb_height
    lgrid = (luma_nnz.reshape(mb_height, mb_width, 4, 4)
             .transpose(0, 2, 1, 3).reshape(gh, gw))
    bxg = jax.lax.broadcasted_iota(jnp.int32, (gh, gw), 1)
    byg = jax.lax.broadcasted_iota(jnp.int32, (gh, gw), 0)
    nc_grid = _block_nc(lgrid, gw, gh, bxg > 0, byg > 0)
    nc_luma = (nc_grid.reshape(mb_height, 4, mb_width, 4)
               .transpose(0, 2, 1, 3).reshape(nmb, 4, 4))

    cgw, cgh = 2 * mb_width, 2 * mb_height
    cbx = jax.lax.broadcasted_iota(jnp.int32, (cgh, cgw), 1)
    cby = jax.lax.broadcasted_iota(jnp.int32, (cgh, cgw), 0)
    ncc = []
    for p in range(2):
        cgrid = (cac_nnz_coded[:, p].reshape(mb_height, mb_width, 2, 2)
                 .transpose(0, 2, 1, 3).reshape(cgh, cgw))
        g = _block_nc(cgrid, cgw, cgh, cbx > 0, cby > 0)
        ncc.append(g.reshape(mb_height, 2, mb_width, 2)
                   .transpose(0, 2, 1, 3).reshape(nmb, 2, 2))
    nc_chroma = jnp.stack(ncc, axis=1)

    # ---- CAVLC ------------------------------------------------------------
    # luma DC (i16 only)
    dc_scan = dc_lev.reshape(nmb, 16)[:, _ZZ]
    dc_vals, dc_lens, _ = cavlc.encode_blocks(dc_scan, nc_luma[:, 0, 0], 16)
    dc_lens = jnp.where(is_i16[:, None], dc_lens, 0)

    # luma: one CAVLC pass over all blocks — i16 MBs contribute their
    # AC-15 view (zig-zag 1..15 shifted into slots 0..14), others the
    # full 16-coefficient view; per-block max_coeff picks the syntax
    full_lev = jnp.where(is_inter[:, None, None, None, None],
                         lev_inter, ac_lev)
    acn = full_lev.reshape(nmb * 16, 16)[:, _ZZ]
    aci = ac_lev.reshape(nmb * 16, 16)[:, _ZZ]
    aci = jnp.concatenate([aci[:, 1:], jnp.zeros((nmb * 16, 1), aci.dtype)],
                          axis=1)
    i16_blk = jnp.repeat(is_i16, 16)
    scan_lv = jnp.where(i16_blk[:, None], aci, acn)
    mc_blk = jnp.where(i16_blk, 15, 16)
    vv, ll, _ = cavlc.encode_blocks(scan_lv, nc_luma.reshape(nmb * 16),
                                    mc_blk)
    luma_vals = vv.reshape(nmb, 16, ns)
    ll = ll.reshape(nmb, 16, ns)
    bb = jnp.arange(16) // 4
    bc = jnp.arange(16) % 4
    grp_of_block = (bb // 2) * 2 + (bc // 2)
    bit = (cbp_luma[:, None] >> grp_of_block[None, :]) & 1
    blk_coded = jnp.where(
        is_i16[:, None], cbpl_i16[:, None],
        (coded & (is_inter | is_i4))[:, None] & (bit > 0))
    luma_lens = jnp.where(blk_coded[:, :, None], ll, 0)

    # chroma DC
    cdc_scan = cdc_lev.reshape(nmb * 2, 4)
    cdc_scan = jnp.pad(cdc_scan, ((0, 0), (0, 12)))
    cdc_vals, cdc_lens, _ = cavlc.encode_blocks(
        cdc_scan, jnp.full((nmb * 2,), -1, jnp.int32), 4)
    cdc_vals = cdc_vals.reshape(nmb, 2, ns)
    cdc_lens = cdc_lens.reshape(nmb, 2, ns)
    cdc_lens = jnp.where(((cbpc >= 1) & coded)[:, None, None], cdc_lens, 0)

    # chroma AC
    cacf = cac_lev.reshape(nmb * 8, 16)[:, _ZZ][:, 1:]
    cacf = jnp.pad(cacf, ((0, 0), (0, 1)))
    cac_vals, cac_lens, _ = cavlc.encode_blocks(
        cacf, nc_chroma.reshape(nmb * 8), 15)
    cac_vals = cac_vals.reshape(nmb, 8, ns)
    cac_lens = cac_lens.reshape(nmb, 8, ns)
    cac_lens = jnp.where(((cbpc == 2) & coded)[:, None, None], cac_lens, 0)

    # ---- header symbols ---------------------------------------------------
    i16code = 1 + mode16 + 4 * cbpc + 12 * cbpl_i16.astype(jnp.int32)
    if has_inter:
        skip_i = skip.astype(jnp.int32)
        s_cum = jnp.cumsum(skip_i)
        s_excl = s_cum - skip_i
        marker = jnp.where(coded, s_cum, -1)
        run_base = jax.lax.associative_scan(jnp.maximum, marker)
        run_base_prev = jnp.concatenate(
            [jnp.zeros(1, jnp.int32), jnp.maximum(run_base[:-1], 0)])
        skip_run = jnp.where(coded, s_excl - run_base_prev, 0)
        sr_v, sr_l = _ue_codes(jnp.maximum(skip_run, 0))
        sr_l = jnp.where(coded, sr_l, 0)
        trailing = s_cum[-1] - jnp.maximum(jnp.max(marker), 0)
        tr_v, tr_l = _ue_codes(jnp.maximum(trailing, 0))
        tr_l = jnp.where(trailing > 0, tr_l, 0)
        mb_type_val = jnp.where(is_inter, shape,
                                jnp.where(is_i4, 5, 5 + i16code))
    else:
        sr_v = jnp.zeros((nmb,), jnp.uint32)
        sr_l = jnp.zeros((nmb,), jnp.int32)
        tr_v = jnp.zeros((), jnp.uint32)
        tr_l = jnp.zeros((), jnp.int32)
        mb_type_val = jnp.where(is_i4, 0, i16code)

    mt_v, mt_l = _ue_codes(mb_type_val)
    mt_l = jnp.where(coded, mt_l, 0)

    inter_coded = coded & is_inter
    n_parts = jnp.asarray(_N_PARTS)[jnp.clip(shape, 0, 3)]
    # sub_mb_type: P_8x8 emits four ue(0) ("1") entries
    sub_v = jnp.ones((nmb, 4), jnp.uint32)
    sub_l = jnp.where((inter_coded & (shape == 3))[:, None],
                      jnp.ones((nmb, 4), jnp.int32), 0)
    # per-partition MVDs, interleaved (x, y) per partition
    part_active = (jnp.arange(4)[None, :] < n_parts[:, None]) \
        & inter_coded[:, None]
    mvdx_v, mvdx_l = _se_codes(mvd_px)
    mvdy_v, mvdy_l = _se_codes(mvd_py)
    mvdx_l = jnp.where(part_active, mvdx_l, 0)
    mvdy_l = jnp.where(part_active, mvdy_l, 0)
    mvd_vals = jnp.stack([mvdx_v, mvdy_v], axis=2).reshape(nmb, 8)
    mvd_lens = jnp.stack([mvdx_l, mvdy_l], axis=2).reshape(nmb, 8)

    # i4 mode symbols (16 slots, only for i4 MBs)
    i4sym_l = jnp.where(is_i4[:, None], i4sym_l, 0)

    cm_v, cm_l = _ue_codes(cmode)
    cm_l = jnp.where(coded & is_intra, cm_l, 0)

    cbp_c = jnp.clip(cbp, 0, 47)
    cbp_code = jnp.where(is_i4, cavlc._lut(_CBP_INTRA_CODE, cbp_c),
                         cavlc._lut(_CBP_INTER_CODE, cbp_c))
    cbpv, cbpl_ = _ue_codes(cbp_code)
    cbpl_ = jnp.where(coded & (is_inter | is_i4), cbpl_, 0)

    dqp_needed = coded & (is_i16 | (cbp != 0))
    if qp_rows is None:
        dqp_v = jnp.ones((nmb,), jnp.uint32)        # se(0) = '1'
        dqp_l = jnp.where(dqp_needed, 1, 0)
        qp_dec = None
    else:
        qp_mb = jnp.repeat(qp_rows, mb_width)
        idx = jnp.arange(nmb, dtype=jnp.int32)
        emit_idx = jnp.where(dqp_needed, idx, -1)
        run_idx = jax.lax.associative_scan(jnp.maximum, emit_idx)
        prev_run = jnp.concatenate(
            [jnp.full((1,), -1, jnp.int32), run_idx[:-1]])
        qp_prev = jnp.where(prev_run >= 0,
                            qp_mb[jnp.maximum(prev_run, 0)], qp_rows[0])
        dqp_v, dqp_l_all = _se_codes(qp_mb - qp_prev)
        dqp_l = jnp.where(dqp_needed, dqp_l_all, 0)
        qp_dec = jnp.where(run_idx >= 0,
                           qp_mb[jnp.maximum(run_idx, 0)], qp_rows[0])

    # scalable-extension slices: base_mode_flag=0 u(1) before mb_type
    bm_v = jnp.zeros((nmb, 1), jnp.uint32)
    bm_l = (coded.astype(jnp.int32)[:, None]
            if svc_base_mode_bit else jnp.zeros((nmb, 1), jnp.int32))

    hdr_vals = jnp.concatenate([
        sr_v[:, None], bm_v, mt_v[:, None], sub_v, mvd_vals,
        i4sym_v.astype(jnp.uint32), cm_v[:, None],
        cbpv[:, None], dqp_v[:, None]], axis=1)
    hdr_lens = jnp.concatenate([
        sr_l[:, None], bm_l, mt_l[:, None], sub_l, mvd_lens,
        i4sym_l, cm_l[:, None],
        cbpl_[:, None], dqp_l[:, None]], axis=1)

    # ---- assembly ---------------------------------------------------------
    # (nmb, 28*ns) layout: unit 0 = MB header symbols (34 slots),
    # units 1..27 = the CAVLC blocks in decode order — a uniform
    # (nmb, 28, ns) unit grid that the hierarchical device packer
    # exploits (ops/bitpack.py). The trailing skip-run symbol of a P
    # slice is returned separately (appended on host after the MB bits).
    # unit 0 is exactly N_SLOTS wide: 33 syntax slots + the base_mode
    # slot (zero-length unless svc_base_mode_bit)
    sym_vals = jnp.concatenate([
        hdr_vals.astype(jnp.uint32),
        dc_vals,
        luma_vals[:, _BLOCK_SCAN].reshape(nmb, 16 * ns),
        cdc_vals.reshape(nmb, 2 * ns),
        cac_vals.reshape(nmb, 8 * ns),
    ], axis=1)
    sym_lens = jnp.concatenate([
        hdr_lens,
        dc_lens,
        luma_lens[:, _BLOCK_SCAN].reshape(nmb, 16 * ns),
        cdc_lens.reshape(nmb, 2 * ns),
        cac_lens.reshape(nmb, 8 * ns),
    ], axis=1)
    if not has_inter:
        tr_v = jnp.zeros((), jnp.uint32)
        tr_l = jnp.zeros((), jnp.int32)

    out = dict(sym_vals=sym_vals, sym_lens=sym_lens,
               tail_val=tr_v.astype(jnp.uint32), tail_len=tr_l,
               total_bits=(jnp.sum(sym_lens) + tr_l).astype(jnp.int32),
               row_bits=(jnp.sum(sym_lens, axis=1)
                         .reshape(mb_height, mb_width).sum(axis=1)),
               skip=skip, cbp=cbp, cbpc=cbpc,
               mvd_py=mvd_py, mvd_px=mvd_px)
    if qp_dec is not None:
        out["qp_dec"] = qp_dec
    return out


encode_frame = jax.jit(
    encode_frame_core,
    static_argnames=("mb_width", "mb_height", "has_inter", "enable_i4x4",
                     "enable_deblock", "enable_partitions", "enable_qpel",
                     "svc_base_mode_bit"))


# ---------------------------------------------------------------------------
# staged dispatch: each stage is its own jitted program (see the staging
# note at inter_stage_core). This is the production path — XLA compile
# time is superlinear in program size and the per-flag-combination
# monolith variants multiplied it; the staged programs compile
# additively and are shared across IDR/P/speed/capacity variants.
# ---------------------------------------------------------------------------

inter_stage = jax.jit(
    inter_stage_core,
    static_argnames=("mb_width", "mb_height", "enable_partitions",
                     "enable_qpel"))

select_stage = jax.jit(
    select_stage_core,
    static_argnames=("mb_width", "mb_height", "has_inter", "enable_i4x4"))

symbolize_stage = jax.jit(
    symbolize,
    static_argnames=("mb_width", "mb_height", "has_inter",
                     "svc_base_mode_bit"))

deblock_stage = jax.jit(
    deblock_stage_core, static_argnames=("mb_width", "mb_height"))


def encode_frame_staged(src_y_mb, src_u_mb, src_v_mb,
                        ref_y_pad, ref_u_pad, ref_v_pad, ref4_pad,
                        qp, qpc, steps, avail_top, avail_left,
                        mb_width: int, mb_height: int,
                        has_inter: bool, enable_i4x4: bool,
                        enable_deblock: bool = False,
                        enable_partitions: bool = False,
                        enable_qpel: bool = True,
                        svc_base_mode_bit: bool = False,
                        mb_row_offset=0,
                        prev_my=None, prev_mx=None):
    """Same contract as encode_frame_core, dispatched as 3-4 separately
    compiled stage programs (single frame / single band)."""
    per_row_qp = jnp.ndim(qp) == 1
    if per_row_qp and not (has_inter and not enable_i4x4):
        raise NotImplementedError(
            "per-row QP requires the fully-parallel P path "
            "(encode_speed >= 2)")
    if has_inter:
        inter = inter_stage(
            src_y_mb, src_u_mb, src_v_mb,
            ref_y_pad, ref_u_pad, ref_v_pad, ref4_pad,
            qp, qpc, mb_row_offset, prev_my, prev_mx,
            mb_width=mb_width, mb_height=mb_height,
            enable_partitions=enable_partitions, enable_qpel=enable_qpel)
    else:
        inter = None
    st = select_stage(
        src_y_mb, src_u_mb, src_v_mb, qp, qpc,
        steps, avail_top, avail_left, inter,
        mb_width=mb_width, mb_height=mb_height,
        has_inter=has_inter, enable_i4x4=enable_i4x4)
    out = symbolize_stage(
        st["sel"], st["mode16"], st["cmode"], st["i4modes"],
        st["i4sym_v"], st["i4sym_l"], st["mv4_y"], st["mv4_x"],
        st["shape"], st["dc_lev"], st["ac_lev"], st["lev_inter"],
        st["cdc_lev"], st["cac_lev"], mb_width, mb_height, has_inter,
        svc_base_mode_bit=svc_base_mode_bit,
        qp_rows=qp if per_row_qp else None)
    out = dict(out)
    if enable_deblock:
        if per_row_qp:
            qp_db = out["qp_dec"]
            qpc_db = jnp.asarray(tables.QPC_FROM_QPY)[qp_db]
        else:
            qp_db, qpc_db = qp, qpc
        df_y, df_u, df_v = deblock_stage(
            st["recon_y"], st["recon_u"], st["recon_v"], st["sel"],
            st["lev_inter"], st["mv4_y"], st["mv4_x"], qp_db, qpc_db,
            avail_top, avail_left, mb_width=mb_width, mb_height=mb_height)
    else:
        df_y, df_u, df_v = st["recon_y"], st["recon_u"], st["recon_v"]
    out.update(dict(recon_y=st["recon_y"], recon_u=st["recon_u"],
                    recon_v=st["recon_v"],
                    df_y=df_y, df_u=df_u, df_v=df_v,
                    mv_y=st["mv_y"], mv_x=st["mv_x"],
                    mv4_y=st["mv4_y"], mv4_x=st["mv4_x"],
                    shape=st["shape"], sel=st["sel"],
                    i4modes=st["i4modes"]))
    return out


@functools.lru_cache(maxsize=64)
def _banded_stage_fns(mb_width: int, band_rows: int, has_inter: bool,
                      enable_i4x4: bool, enable_partitions: bool,
                      enable_qpel: bool, svc_base_mode_bit: bool):
    """Per-config jitted, band-vmapped stage functions (B equal slice
    bands in one dispatch; the batched form of the reference's
    slice-thread fan-out `src/h264-lab.h:6511-6574`). Reference planes
    are shared across bands (MVs may cross band borders)."""
    f_inter = functools.partial(
        inter_stage_core, mb_width=mb_width, mb_height=band_rows,
        enable_partitions=enable_partitions, enable_qpel=enable_qpel)
    f_select = functools.partial(
        select_stage_core, mb_width=mb_width, mb_height=band_rows,
        has_inter=has_inter, enable_i4x4=enable_i4x4)
    f_sym = functools.partial(
        symbolize, mb_width=mb_width, mb_height=band_rows,
        has_inter=has_inter, svc_base_mode_bit=svc_base_mode_bit)
    f_dbl = functools.partial(
        deblock_stage_core, mb_width=mb_width, mb_height=band_rows)

    @jax.jit
    def inter_fn(sy, su, sv, ry, ru, rv, r4, qp_b, qpc_b, row0s, pmy, pmx):
        return jax.vmap(
            lambda a, b, c, q, qc, r0, my, mx:
                f_inter(a, b, c, ry, ru, rv, r4, q, qc, r0, my, mx)
        )(sy, su, sv, qp_b, qpc_b, row0s, pmy, pmx)

    @jax.jit
    def select_fn(sy, su, sv, qp_b, qpc_b, steps, a_top, a_left, inter):
        return jax.vmap(
            lambda a, b, c, q, qc, it:
                f_select(a, b, c, q, qc, steps, a_top, a_left, it)
        )(sy, su, sv, qp_b, qpc_b, inter)

    @jax.jit
    def sym_fn(st):
        return jax.vmap(
            lambda s: f_sym(s["sel"], s["mode16"], s["cmode"],
                            s["i4modes"], s["i4sym_v"], s["i4sym_l"],
                            s["mv4_y"], s["mv4_x"], s["shape"],
                            s["dc_lev"], s["ac_lev"], s["lev_inter"],
                            s["cdc_lev"], s["cac_lev"])
        )(st)

    @jax.jit
    def deblock_fn(st, qp_b, qpc_b, a_top, a_left):
        return jax.vmap(
            lambda s, q, qc: f_dbl(s["recon_y"], s["recon_u"], s["recon_v"],
                                   s["sel"], s["lev_inter"],
                                   s["mv4_y"], s["mv4_x"], q, qc,
                                   a_top, a_left)
        )(st, qp_b, qpc_b)

    return inter_fn, select_fn, sym_fn, deblock_fn


def encode_frame_banded_staged(src_y, src_u, src_v,
                               ref_y_pad, ref_u_pad, ref_v_pad, ref4_pad,
                               qp, qpc, steps, avail_top, avail_left, row0s,
                               mb_width: int, band_rows: int,
                               has_inter: bool, enable_i4x4: bool,
                               enable_deblock: bool = False,
                               enable_partitions: bool = False,
                               enable_qpel: bool = True,
                               svc_base_mode_bit: bool = False,
                               prev_my=None, prev_mx=None):
    """Staged-dispatch equivalent of encode_frame_banded_core: B bands
    per dispatch, each stage its own compiled program."""
    n_bands = src_y.shape[0]
    nmb_b = band_rows * mb_width
    inter_fn, select_fn, sym_fn, deblock_fn = _banded_stage_fns(
        mb_width, band_rows, has_inter, enable_i4x4,
        enable_partitions, enable_qpel, svc_base_mode_bit)
    qp_b = jnp.broadcast_to(jnp.asarray(qp, jnp.int32), (n_bands,))
    qpc_b = jnp.broadcast_to(jnp.asarray(qpc, jnp.int32), (n_bands,))
    if has_inter:
        if prev_my is None:
            prev_my = jnp.zeros((n_bands, nmb_b), jnp.int32)
            prev_mx = jnp.zeros((n_bands, nmb_b), jnp.int32)
        inter = inter_fn(src_y, src_u, src_v,
                         ref_y_pad, ref_u_pad, ref_v_pad, ref4_pad,
                         qp_b, qpc_b, row0s, prev_my, prev_mx)
    else:
        inter = None
    st = select_fn(src_y, src_u, src_v, qp_b, qpc_b,
                   steps, avail_top, avail_left, inter)
    out = dict(sym_fn(st))
    if enable_deblock:
        df_y, df_u, df_v = deblock_fn(st, qp_b, qpc_b,
                                      avail_top, avail_left)
    else:
        df_y, df_u, df_v = st["recon_y"], st["recon_u"], st["recon_v"]
    out.update(dict(recon_y=st["recon_y"], recon_u=st["recon_u"],
                    recon_v=st["recon_v"],
                    df_y=df_y, df_u=df_u, df_v=df_v,
                    mv_y=st["mv_y"], mv_x=st["mv_x"],
                    mv4_y=st["mv4_y"], mv4_x=st["mv4_x"],
                    shape=st["shape"], sel=st["sel"],
                    i4modes=st["i4modes"]))
    return out


def encode_frame_banded_core(src_y, src_u, src_v,
                             ref_y_pad, ref_u_pad, ref_v_pad, ref4_pad,
                             qp, qpc, steps, avail_top, avail_left, row0s,
                             mb_width: int, band_rows: int,
                             has_inter: bool, enable_i4x4: bool,
                             enable_deblock: bool = False,
                             enable_partitions: bool = False,
                             enable_qpel: bool = True,
                             svc_base_mode_bit: bool = False,
                             prev_my=None, prev_mx=None):
    """Encode B equal-height slice bands of one frame in a single
    dispatch: `jax.vmap` over the band axis turns each wavefront step
    into a (B, k)-wide batch, and under a `("band",)`-sharded mesh the
    band axis partitions across devices — the batched form of the
    reference's slice-thread fan-out (`src/h264-lab.h:6511-6574`).

    src_*: (B, nmb_band, 16, 16)/(B, nmb_band, 8, 8); row0s: (B,) first
    MB row of each band; reference planes are full-frame (replicated
    across devices — motion vectors may cross band borders). qp/qpc may be
    scalars (uniform) or (B,) arrays — per-band QP is the fine-rate-
    control granularity (rc.band_qp_offsets; each band is its own slice,
    so per-band QP is plain slice_qp syntax, no mb_qp_delta needed).
    """
    n_bands = src_y.shape[0]
    f = functools.partial(
        encode_frame_core,
        mb_width=mb_width, mb_height=band_rows, has_inter=has_inter,
        enable_i4x4=enable_i4x4, enable_deblock=enable_deblock,
        enable_partitions=enable_partitions, enable_qpel=enable_qpel,
        svc_base_mode_bit=svc_base_mode_bit)

    qp_b = jnp.broadcast_to(jnp.asarray(qp, jnp.int32), (n_bands,))
    qpc_b = jnp.broadcast_to(jnp.asarray(qpc, jnp.int32), (n_bands,))

    if prev_my is None:
        def one(sy, su, sv, r0, qp_1, qpc_1):
            return f(sy, su, sv, ref_y_pad, ref_u_pad, ref_v_pad, ref4_pad,
                     qp_1, qpc_1, steps, avail_top, avail_left,
                     mb_row_offset=r0)
        return jax.vmap(one)(src_y, src_u, src_v, row0s, qp_b, qpc_b)

    def one(sy, su, sv, r0, qp_1, qpc_1, pmy, pmx):
        return f(sy, su, sv, ref_y_pad, ref_u_pad, ref_v_pad, ref4_pad,
                 qp_1, qpc_1, steps, avail_top, avail_left,
                 mb_row_offset=r0, prev_my=pmy, prev_mx=pmx)
    return jax.vmap(one)(src_y, src_u, src_v, row0s, qp_b, qpc_b,
                         prev_my, prev_mx)


encode_frame_banded = jax.jit(
    encode_frame_banded_core,
    static_argnames=("mb_width", "band_rows", "has_inter", "enable_i4x4",
                     "enable_deblock", "enable_partitions", "enable_qpel",
                     "svc_base_mode_bit"))


def encode_intra_core(src_y_mb, src_u_mb, src_v_mb, qp, qpc,
                      steps, avail_top, avail_left,
                      mb_width: int, mb_height: int,
                      enable_i4x4: bool = True,
                      enable_deblock: bool = False):
    """I-frame/slice entry: unified scan without the inter path.
    vmap-able over leading batch axes (see h264lab_tpu.parallel)."""
    dummy = jnp.zeros((8, 8), jnp.uint8)
    return encode_frame_core(
        src_y_mb, src_u_mb, src_v_mb,
        dummy, dummy, dummy, dummy,
        qp, qpc, steps, avail_top, avail_left,
        mb_width, mb_height, has_inter=False, enable_i4x4=enable_i4x4,
        enable_deblock=enable_deblock)


encode_intra_frame = jax.jit(
    encode_intra_core,
    static_argnames=("mb_width", "mb_height", "enable_i4x4",
                     "enable_deblock"))
