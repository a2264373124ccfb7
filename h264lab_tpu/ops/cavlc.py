"""CAVLC residual entropy coding (spec 9.2), batched over 4x4 blocks.

Batched design: where the reference's `h264e_vlc_encode`
(`src/h264-lab.h:2775-2948`) walks one block at a time emitting bits into
a serial cache, this op computes the complete VLC symbol expansion of
*every* residual block of a frame in parallel:

- inputs: `(n, 16)` zig-zag-ordered levels + per-block nC context
- outputs: fixed-slot `(n, 34)` arrays of (value, nbits) symbols whose
  in-order concatenation (dropping nbits==0 slots) is the exact spec
  bitstream for each block.

The only sequential element of CAVLC — the adaptive level suffix length —
runs as a statically unrolled 16-step loop vectorized over all blocks.
Bit packing happens downstream as a prefix-sum pass (host or device).

Symbol slot layout per block:
  0      coeff_token
  1      trailing-one sign bits (packed into one symbol)
  2..17  level codes (reverse scan order)
  18     total_zeros
  19..33 run_before codes
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from h264lab_tpu.ops import tables_cavlc as tc

N_SLOTS = 34

_CT_LEN = jnp.asarray(tc.COEFF_TOKEN_LEN)     # (5, 17, 4)
_CT_VAL = jnp.asarray(tc.COEFF_TOKEN_VAL)
_TZ_LEN = jnp.asarray(tc.TOTAL_ZEROS_LEN)     # (16, 16)
_TZ_VAL = jnp.asarray(tc.TOTAL_ZEROS_VAL)
_CZ_LEN = jnp.asarray(tc.TOTAL_ZEROS_CDC_LEN)  # (4, 4)
_CZ_VAL = jnp.asarray(tc.TOTAL_ZEROS_CDC_VAL)
_RB_LEN = jnp.asarray(tc.RUN_BEFORE_LEN)      # (8, 15)
_RB_VAL = jnp.asarray(tc.RUN_BEFORE_VAL)


def _lut(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Gather-free small-table lookup: one-hot compare + masked sum
    (for tables of a few hundred entries, a dense contraction in place
    of an elementwise gather). `table` flat (T,), `idx` any shape of
    int32 in [0, T)."""
    flat = table.reshape(-1)
    r = jnp.arange(flat.shape[0], dtype=jnp.int32)
    oh = idx[..., None] == r
    return jnp.sum(jnp.where(oh, flat, 0), axis=-1)


def nc_context(nc: jnp.ndarray) -> jnp.ndarray:
    """Map nC to coeff_token table index (spec 9.2.1): 0,1,2 for the nC
    ranges [0,2),[2,4),[4,8); 3 = FLC nC>=8; 4 = chroma DC (nC==-1)."""
    return jnp.where(
        nc < 0, 4,
        jnp.where(nc < 2, 0, jnp.where(nc < 4, 1, jnp.where(nc < 8, 2, 3))))


def _level_code_bits(level_code: jnp.ndarray, sl: jnp.ndarray):
    """VLC for one (vector of) levelCode given suffixLength sl (spec
    9.2.2.1 inverted). Returns (val, nbits); codes are '0'*p + '1' +
    suffix, emitted as one symbol of nbits <= 32."""
    lc = level_code
    # normal region for sl>0
    prefix = lc >> jnp.maximum(sl, 0)
    mask = (jnp.int32(1) << jnp.maximum(sl, 0)) - 1

    # case A: sl == 0, lc < 14  -> lc zeros + 1
    a_val = jnp.int32(1)
    a_len = lc + 1
    # case B: sl == 0, 14 <= lc < 30 -> 14 zeros + 1 + 4-bit (lc-14)
    b_val = (1 << 4) | (lc - 14)
    b_len = jnp.full_like(lc, 19)
    # case C: sl > 0, prefix < 15 -> prefix zeros + 1 + sl-bit suffix
    c_val = (jnp.int32(1) << sl) | (lc & mask)
    c_len = prefix + 1 + sl
    # case D: escape prefix 15 (12-bit suffix)
    esc_base = (15 << jnp.maximum(sl, 0)) + jnp.where(sl == 0, 15, 0)
    rem = lc - esc_base
    d_val = (1 << 12) | rem
    d_len = jnp.full_like(lc, 16 + 12)
    # case E: escape prefix 16 (13-bit suffix): levelCode += (1<<13)-4096
    e_val = (1 << 13) | (rem - 4096)
    e_len = jnp.full_like(lc, 17 + 13)

    use_a = (sl == 0) & (lc < 14)
    use_b = (sl == 0) & (lc >= 14) & (lc < 30)
    use_c = (sl > 0) & (prefix < 15)
    use_d = ~(use_a | use_b | use_c) & (rem < 4096)
    val = jnp.where(use_a, a_val,
          jnp.where(use_b, b_val,
          jnp.where(use_c, c_val,
          jnp.where(use_d, d_val, e_val))))
    nbits = jnp.where(use_a, a_len,
            jnp.where(use_b, b_len,
            jnp.where(use_c, c_len,
            jnp.where(use_d, d_len, e_len))))
    return val.astype(jnp.uint32), nbits.astype(jnp.int32)


def encode_blocks(levels: jnp.ndarray, nc: jnp.ndarray, max_coeff):
    """CAVLC-encode a batch of blocks.

    Args:
      levels: (n, 16) int32, zig-zag scan order. For 15-coefficient AC
        blocks pass the AC coefficients in slots 0..14 (slot 15 zero);
        for chroma DC pass 4 values in slots 0..3.
      nc: (n,) int32 nC context (-1 for chroma DC).
      max_coeff: 16, 15 or 4 — a static int or a per-block (n,) array
        (mixing 15- and 16-coefficient blocks in one call; both use the
        same total_zeros tables per spec 9.2.3).

    Returns:
      vals (n, 34) uint32, lens (n, 34) int32, total_coeff (n,) int32.
    """
    n = levels.shape[0]
    levels = levels.astype(jnp.int32)
    scan_pos = jnp.arange(16, dtype=jnp.int32)
    if isinstance(max_coeff, int):
        valid = jnp.broadcast_to(scan_pos < max_coeff, levels.shape)
        mc = jnp.full((n,), max_coeff, jnp.int32)
    else:
        mc = max_coeff.astype(jnp.int32)
        valid = scan_pos[None, :] < mc[:, None]
    lv = jnp.where(valid, levels, 0)

    nonzero = lv != 0
    total = jnp.sum(nonzero, axis=1).astype(jnp.int32)           # TotalCoeff

    # Compact nonzero coeffs in REVERSE scan order without sort/gather:
    # rank[p] = number of nonzeros at scan positions > p; for a nonzero
    # at p, rank is its reverse-order index k. The compaction is then a
    # masked one-hot reduction (dense, no elementwise gather).
    nz_i = nonzero.astype(jnp.int32)
    rank = (jnp.cumsum(nz_i[:, ::-1], axis=1)[:, ::-1] - nz_i)    # (n, 16)
    onehot = (jnp.where(nonzero, rank, -1)[:, None, :]
              == scan_pos[None, :, None])                         # (n,16,16)
    lev = jnp.sum(jnp.where(onehot, lv[:, None, :], 0), axis=2)
    pos = jnp.sum(jnp.where(onehot, scan_pos[None, None, :], 0), axis=2)
    k_idx = jnp.broadcast_to(scan_pos[None, :], lv.shape)
    k_valid = k_idx < total[:, None]

    # TrailingOnes: leading run of |level|==1 in k order, capped at 3
    is_one = (jnp.abs(lev) == 1) & k_valid
    c0 = is_one[:, 0]
    c1 = c0 & is_one[:, 1]
    c2 = c1 & is_one[:, 2]
    t1 = (c0.astype(jnp.int32) + c1.astype(jnp.int32) + c2.astype(jnp.int32))
    t1 = jnp.minimum(t1, total)

    ctx = nc_context(nc)
    ct_idx = (ctx * 17 + total) * 4 + t1
    ct_val = _lut(_CT_VAL, ct_idx).astype(jnp.uint32)
    ct_len = _lut(_CT_LEN, ct_idx)

    # trailing one signs, highest frequency first, packed into one symbol
    sign_bits = (lev < 0).astype(jnp.uint32)
    t1_sign_val = jnp.zeros((n,), jnp.uint32)
    for k in range(3):
        in_t1 = k < t1
        t1_sign_val = jnp.where(
            in_t1, (t1_sign_val << 1) | sign_bits[:, k], t1_sign_val)
    t1_sign_len = t1

    # ---- levels (non-trailing-ones), reverse scan order -------------------
    # The adaptive suffix length is the one sequential element of CAVLC;
    # it runs as a 16-step `lax.scan` vectorized over all blocks (a scan,
    # not an unrolled loop: the unrolled form cost ~16x the XLA compile
    # time for identical output).
    suffix_len0 = jnp.where((total > 10) & (t1 < 3), 1, 0).astype(jnp.int32)

    def lev_step(sl, xt):
        l, kv, kk = xt
        is_lvl = kv & (kk >= t1)
        abs_l = jnp.abs(l)
        lc = 2 * (abs_l - 1) + (l < 0).astype(jnp.int32)
        lc = jnp.where((kk == t1) & (t1 < 3), lc - 2, lc)
        val, nbits = _level_code_bits(jnp.maximum(lc, 0), sl)
        # suffixLength adaptation (spec 9.2.2.1)
        sl_next = jnp.where(sl == 0, 1, sl)
        thresh = jnp.int32(3) << jnp.maximum(sl_next - 1, 0)
        sl_next = jnp.where(abs_l > thresh, sl_next + 1, sl_next)
        sl_next = jnp.minimum(sl_next, 6)
        sl = jnp.where(is_lvl, sl_next, sl)
        return sl, (jnp.where(is_lvl, val, 0), jnp.where(is_lvl, nbits, 0))

    _, (lv_v, lv_l) = jax.lax.scan(
        lev_step, suffix_len0,
        (lev.T, k_valid.T, jnp.arange(16, dtype=jnp.int32)))

    # ---- total_zeros ------------------------------------------------------
    highest_pos = pos[:, 0]                       # scan index of last nonzero
    total_zeros = jnp.where(total > 0, highest_pos + 1 - total, 0)
    if isinstance(max_coeff, int) and max_coeff == 4:
        cz_idx = jnp.minimum(total, 3) * 4 + jnp.minimum(total_zeros, 3)
        tz_val = _lut(_CZ_VAL, cz_idx)
        tz_len = _lut(_CZ_LEN, cz_idx)
    else:
        tz_idx = jnp.minimum(total, 15) * 16 + total_zeros
        tz_val = _lut(_TZ_VAL, tz_idx)
        tz_len = _lut(_TZ_LEN, tz_idx)
    has_tz = (total > 0) & (total < mc)
    tz_val = jnp.where(has_tz, tz_val, 0).astype(jnp.uint32)
    tz_len = jnp.where(has_tz, tz_len, 0)

    # ---- run_before -------------------------------------------------------
    # zerosLeft before coding coeff k = pos[k] - (total-1-k); batched
    # over all 15 k positions at once (no per-k unrolling)
    ks = jnp.arange(15, dtype=jnp.int32)[None, :]
    zeros_left = pos[:, :15] - (total[:, None] - 1 - ks)
    run = pos[:, :15] - pos[:, 1:16] - 1
    need = (ks < total[:, None] - 1) & (zeros_left > 0) & (total[:, None] > 0)
    zl = jnp.clip(zeros_left, 0, 7)
    runc = jnp.clip(run, 0, 14)
    rb_idx = zl * 15 + runc
    rb_vals = jnp.where(need, _lut(_RB_VAL, rb_idx).astype(jnp.uint32), 0)
    rb_lens = jnp.where(need, _lut(_RB_LEN, rb_idx), 0)

    vals = jnp.concatenate(
        [ct_val[:, None], t1_sign_val[:, None], lv_v.T, tz_val[:, None],
         rb_vals], axis=1)
    lens = jnp.concatenate(
        [ct_len[:, None], t1_sign_len[:, None], lv_l.T, tz_len[:, None],
         rb_lens], axis=1)
    return vals.astype(jnp.uint32), lens.astype(jnp.int32), total
