"""4x4 integer transform, Hadamard DC transforms, quantization and
dequantization — batched over blocks as `(..., 4, 4)` int32 tensors.

Batched design: where the reference runs one 4x4 block at a time through
scalar butterflies (`FwdTransformResidual4x42` `src/h264-lab.h:2385-2434`,
`TransformResidual4x4` `:2436-2489`, `quantize` `:2536-2597`), these ops
process every block of a frame in one fused XLA computation.
All math is int32 with the spec's exact rounding, so reconstruction is
bit-identical to a conforming decoder:

- forward DCT: spec 8.5.12 core transform (JM encoder formulation)
- dequant + inverse DCT (spec 8.5.12.1-2), including the low-QP rounding
  of the DC paths that the reference approximates (`src/h264-lab.h:2351-2353`)
- forward quant: JM `(|W|*MF + f) >> (15 + qp//6)` with tunable deadzone f
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from h264lab_tpu.ops import tables

# Device-resident constant tables
_MF = jnp.asarray(tables.QUANT_MF)            # (6, 3)
_V = jnp.asarray(tables.DEQUANT_V)            # (6, 3)
_POS = jnp.asarray(tables.POS_CLASS.reshape(4, 4))   # (4, 4) class ids


def _bf(x0, x1, x2, x3):
    """Forward 1-D core transform butterfly (spec 8.5.12 / Cf matrix)."""
    t0 = x0 + x3
    t1 = x0 - x3
    t2 = x1 + x2
    t3 = x1 - x2
    return t0 + t2, 2 * t1 + t3, t0 - t2, t1 - 2 * t3


def _ibf(d0, d1, d2, d3):
    """Inverse 1-D core transform butterfly (spec 8.5.12.2)."""
    e0 = d0 + d2
    e1 = d0 - d2
    e2 = (d1 >> 1) - d3
    e3 = d1 + (d3 >> 1)
    return e0 + e3, e1 + e2, e1 - e2, e0 - e3


def fdct4x4(res: jnp.ndarray) -> jnp.ndarray:
    """Forward 4x4 core transform of residuals, batched (..., 4, 4) int32."""
    res = res.astype(jnp.int32)
    c0, c1, c2, c3 = _bf(res[..., 0, :], res[..., 1, :], res[..., 2, :], res[..., 3, :])
    t = jnp.stack([c0, c1, c2, c3], axis=-2)
    r0, r1, r2, r3 = _bf(t[..., :, 0], t[..., :, 1], t[..., :, 2], t[..., :, 3])
    return jnp.stack([r0, r1, r2, r3], axis=-1)


def idct4x4(coef: jnp.ndarray) -> jnp.ndarray:
    """Inverse 4x4 core transform incl. final (x+32)>>6, batched int32.

    Input: dequantized coefficients; output: residual to add to prediction.
    """
    coef = coef.astype(jnp.int32)
    r0, r1, r2, r3 = _ibf(coef[..., :, 0], coef[..., :, 1], coef[..., :, 2], coef[..., :, 3])
    t = jnp.stack([r0, r1, r2, r3], axis=-1)
    c0, c1, c2, c3 = _ibf(t[..., 0, :], t[..., 1, :], t[..., 2, :], t[..., 3, :])
    out = jnp.stack([c0, c1, c2, c3], axis=-2)
    return (out + 32) >> 6


def hadamard4x4(x: jnp.ndarray) -> jnp.ndarray:
    """4x4 Hadamard transform (self-inverse up to scale), batched int32.

    Used for the Intra_16x16 luma DC plane (spec 8.5.10 forward/inverse).
    """
    x = x.astype(jnp.int32)

    def h(a, b, c, d):
        # spec matrix rows: ++++ / ++-- / +--+ / +-+-
        s0 = a + c
        s1 = b + d
        d0 = a - c
        d1 = b - d
        return s0 + s1, d0 + d1, d0 - d1, s0 - s1

    c0, c1, c2, c3 = h(x[..., 0, :], x[..., 1, :], x[..., 2, :], x[..., 3, :])
    t = jnp.stack([c0, c1, c2, c3], axis=-2)
    r0, r1, r2, r3 = h(t[..., :, 0], t[..., :, 1], t[..., :, 2], t[..., :, 3])
    return jnp.stack([r0, r1, r2, r3], axis=-1)


def hadamard2x2(x: jnp.ndarray) -> jnp.ndarray:
    """2x2 Hadamard for chroma DC (spec 8.5.11), batched (..., 2, 2) int32."""
    x = x.astype(jnp.int32)
    a = x[..., 0, 0]
    b = x[..., 0, 1]
    c = x[..., 1, 0]
    d = x[..., 1, 1]
    return jnp.stack([
        jnp.stack([a + b + c + d, a - b + c - d], axis=-1),
        jnp.stack([a + b - c - d, a - b - c + d], axis=-1),
    ], axis=-2)


# ---------------------------------------------------------------------------
# AC quant / dequant
# ---------------------------------------------------------------------------

def zero_thr4x4(qp, thr_q8) -> jnp.ndarray:
    """Per-coefficient zero thresholds at `thr_q8`/256 quantization steps:
    the largest |coef| treated as negligible for block-kill decisions
    (the analog of the reference's `rc_rnd2thr`-derived `g_thr_inter`
    thresholds, `src/h264-lab.h:5822-5834`, `:2491-2534` — mechanism
    reproduced, thresholds our own fits in ops/tuning.py). Returns
    (..., 4, 4) int32 for scalar or batched qp."""
    qp = jnp.asarray(qp, jnp.int32)
    mf = _MF[qp % 6][..., _POS]                  # (..., 4, 4)
    qbits = jnp.broadcast_to((15 + qp // 6)[..., None, None], mf.shape)
    # thr = thr_q8/256 * step,  step = 2^qbits / MF  (int32-safe:
    # thr_q8 < 2^9 and qbits-8 <= 15, so the shift stays under 2^24)
    return ((jnp.int32(thr_q8) << (qbits - 8)) // mf).astype(jnp.int32)


def quant4x4(coef: jnp.ndarray, qp, deadzone_q8) -> jnp.ndarray:
    """Quantize batched 4x4 coefficient blocks.

    level = sign(W) * ((|W| * MF[qp%6, class] + f) >> (15 + qp//6)),
    f = deadzone_q8/256 * 2^(15+qp//6). `qp` and `deadzone_q8` broadcast
    against the block batch (scalars or per-block arrays).
    """
    # int32 throughout (JAX defaults to 32-bit integers): |coef| <= 255*36 < 2^14
    # (worst-case residual +-255 through the gain-6-per-1D core transform),
    # MF <= 13107 < 2^14, so |coef|*MF < 2^28; f = dz << (qbits-8) <= 2^23.
    coef = coef.astype(jnp.int32)
    qp = jnp.asarray(qp, jnp.int32)
    div6 = qp // 6
    mod6 = qp % 6
    mf = _MF[mod6][..., _POS]          # (..., 4, 4) via class gather
    qbits = 15 + div6
    f = jnp.asarray(deadzone_q8, jnp.int32) << (qbits - 8)
    mf = jnp.broadcast_to(mf, coef.shape)
    qbits = jnp.broadcast_to(qbits[..., None, None], coef.shape)
    f = jnp.broadcast_to(f[..., None, None], coef.shape)
    mag = (jnp.abs(coef) * mf + f) >> qbits
    return (jnp.sign(coef) * mag).astype(jnp.int32)


def dequant4x4(level: jnp.ndarray, qp) -> jnp.ndarray:
    """Dequantize AC blocks: W' = level * V[qp%6, class] << (qp//6)
    (spec 8.5.12.1 for 4x4 residual blocks)."""
    level = level.astype(jnp.int32)
    qp = jnp.asarray(qp, jnp.int32)
    v = _V[qp % 6][..., _POS]
    v = jnp.broadcast_to(v, level.shape)
    shift = jnp.broadcast_to((qp // 6)[..., None, None], level.shape)
    return (level * v) << shift


# ---------------------------------------------------------------------------
# Luma DC (Intra_16x16) — spec 8.5.10
# ---------------------------------------------------------------------------

def quant_luma_dc(dc: jnp.ndarray, qp) -> jnp.ndarray:
    """Forward: Hadamard then quantize with 4x the AC quantization step
    (compensating the unnormalized 4x4 Hadamard's gain 16 against the
    decoder-side gain-16 inverse Hadamard and /4 dequant scale).

    level = sign * ((|f| * MF00 + rnd) >> (17 + qp//6)), rounding 1/2 (no
    deadzone on DC, matching the reference `src/h264-lab.h:2344-2349`).
    Input/output (..., 4, 4).
    """
    # int32 safe: |hadamard(dc)| <= 16*4080 = 65280 < 2^17, MF00 <= 13107
    # < 2^14 -> product < 2^30.7; rnd <= 2^24.
    f = hadamard4x4(dc)
    qp = jnp.asarray(qp, jnp.int32)
    mf00 = _MF[qp % 6, 0]
    qbits = 17 + qp // 6
    rnd = jnp.int32(1) << (qbits - 1)
    qbits = jnp.broadcast_to(qbits[..., None, None], f.shape)
    rnd = jnp.broadcast_to(rnd[..., None, None], f.shape)
    mf00 = jnp.broadcast_to(mf00[..., None, None], f.shape)
    mag = (jnp.abs(f) * mf00 + rnd) >> qbits
    return (jnp.sign(f) * mag).astype(jnp.int32)


def dequant_luma_dc(level: jnp.ndarray, qp) -> jnp.ndarray:
    """Inverse: Hadamard then scale per spec 8.5.10 exact rounding rules.

    Returns the DC values to place at position 0 of each 4x4 block before
    the AC inverse transform.
    """
    f = hadamard4x4(level)
    qp = jnp.asarray(qp, jnp.int32)
    v00 = _V[qp % 6, 0]
    div6 = qp // 6
    v00 = v00[..., None, None]
    div6 = div6[..., None, None]
    hi = (f * v00) << jnp.maximum(div6 - 2, 0)
    lo = (f * v00 + (1 << jnp.maximum(1 - div6, 0))) >> (2 - jnp.minimum(div6, 2))
    return jnp.where(div6 >= 2, hi, lo).astype(jnp.int32)


# ---------------------------------------------------------------------------
# Chroma DC — spec 8.5.11
# ---------------------------------------------------------------------------

def quant_chroma_dc(dc: jnp.ndarray, qpc) -> jnp.ndarray:
    """Forward: 2x2 Hadamard then quantize with doubled step (rounding 1/2).
    Input/output (..., 2, 2)."""
    # int32 safe: |hadamard2(dc)| <= 4*4080 < 2^15, MF00 < 2^14.
    f = hadamard2x2(dc)
    qpc = jnp.asarray(qpc, jnp.int32)
    mf00 = _MF[qpc % 6, 0]
    qbits = 16 + qpc // 6
    rnd = jnp.int32(1) << (qbits - 1)
    mag = (jnp.abs(f) * mf00[..., None, None]
           + rnd[..., None, None]) >> qbits[..., None, None]
    return (jnp.sign(f) * mag).astype(jnp.int32)


def dequant_chroma_dc(level: jnp.ndarray, qpc) -> jnp.ndarray:
    """Inverse: 2x2 Hadamard then dcC = ((f * V00) << qp//6) >> 1.

    Spec 8.5.11 with flat scaling lists: LevelScale = 16*V00 and a >>5,
    which cancels to the plain-V00 form used here.
    """
    f = hadamard2x2(level)
    qpc = jnp.asarray(qpc, jnp.int32)
    v00 = _V[qpc % 6, 0][..., None, None]
    div6 = (qpc // 6)[..., None, None]
    return (((f * v00) << div6) >> 1).astype(jnp.int32)


# ---------------------------------------------------------------------------
# Fused helpers
# ---------------------------------------------------------------------------

def transform_quant_dequant_recon(inp_blocks, pred_blocks, qp, deadzone_q8,
                                  skip_dc=False):
    """residual → coeffs → levels → dequant → inverse → recon, batched.

    `skip_dc=True` zeroes the DC position in the AC scan (Intra_16x16 /
    chroma path, where DC travels through the Hadamard side channel).
    Returns (levels, recon_blocks, dc_coefs) with recon in uint8.
    """
    res = inp_blocks.astype(jnp.int32) - pred_blocks.astype(jnp.int32)
    coef = fdct4x4(res)
    dc = coef[..., 0, 0]
    levels = quant4x4(coef, qp, deadzone_q8)
    if skip_dc:
        levels = levels.at[..., 0, 0].set(0)
    deq = dequant4x4(levels, qp)
    if skip_dc:
        deq = deq.at[..., 0, 0].set(0)
    return levels, deq, dc


def recon_from_deq(deq, pred_blocks):
    """Inverse transform + add prediction + clip to uint8."""
    res = idct4x4(deq)
    out = res + pred_blocks.astype(jnp.int32)
    return jnp.clip(out, 0, 255).astype(jnp.uint8)
