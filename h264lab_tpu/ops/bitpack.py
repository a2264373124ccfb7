"""Device-side variable-length bit packing.

The CAVLC stage emits per-MB symbol slots as a uniform (nmb, 28, S) unit
grid (header unit + 27 CAVLC blocks, mbscan.symbolize); this module packs
the whole frame's symbol stream into MSB-first uint32 words on device, so
only the packed payload (~100 KB for 1080p) crosses the host boundary
instead of the raw symbol arrays (~30 MB). Host-side NAL stitching then
merges the words after the (non-byte-aligned) slice header.

Two packers produce bit-identical words:

- `pack_bits_device`: exclusive bit prefix-sum + non-overlapping
  scatter-add over all slots (one scalar scatter per symbol slot).
- `pack_frame_fast`: three levels that replace the elementwise scatter
  with dense vector math and one *row-granular* scatter:
    L1  pack each unit's S slots into UNIT_WORDS words - a dense masked
        reduction (slot word indices are compared against each output
        word; no scatter),
    L2  merge each MB's 28 units into MB_WORDS words - per-unit variable
        bit shift + one-hot word placement,
    L3  place every MB buffer at its frame bit offset: variable bit
        shift, 7 conditional power-of-two word rolls (the dynamic word
        rotation as static slices), then ONE scatter-add of 128-wide row
        slices - ~25k rows instead of ~8M scalar words at 1080p.

Each symbol spans at most two 32-bit words; contributions from different
symbols never overlap bit-wise, so add assembles the stream exactly.
`pack_frame_fast` is the production packer (`parallel/gop.py`,
`models/encoder.py`, `models/svc.py`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

UNIT_SLOTS = 34     # symbol slots per unit (cavlc.N_SLOTS; header padded)
UNIT_WORDS = 22     # per-unit word span: 630-bit worst-case block + spill
MB_WORDS = 128      # per-MB word cap (spec 7.4.5: <= 3200 bits per MB)


@functools.partial(jax.jit, static_argnames=("cap_words",))
def pack_bits_device(vals: jnp.ndarray, lens: jnp.ndarray, cap_words: int):
    """Pack flat symbol arrays into big-bit-endian uint32 words.

    Args:
      vals: (n,) uint32 symbol values (low `lens` bits significant).
      lens: (n,) int32 bit lengths (0 = empty slot, skipped).
      cap_words: static output capacity in 32-bit words.

    Returns (words (cap_words,) uint32, total_bits scalar int32).
    """
    vals = vals.astype(jnp.uint32)
    lens = lens.astype(jnp.int32)
    mask = (jnp.uint32(0xFFFFFFFF) >> (32 - jnp.clip(lens, 1, 32)).astype(jnp.uint32))
    vals = jnp.where(lens > 0, vals & mask, jnp.uint32(0))

    offs = jnp.cumsum(lens) - lens                 # exclusive prefix sum
    total_bits = jnp.sum(lens)
    w = (offs >> 5).astype(jnp.int32)
    s = (offs & 31).astype(jnp.int32)

    hb = lens + s - 32                             # bits spilling into w+1
    fits = hb <= 0
    sh_hi_l = jnp.clip(32 - s - lens, 0, 31).astype(jnp.uint32)
    sh_hi_r = jnp.clip(hb, 0, 31).astype(jnp.uint32)
    hi = jnp.where(fits, vals << sh_hi_l, vals >> sh_hi_r)
    sh_lo = jnp.clip(32 - hb, 1, 31).astype(jnp.uint32)
    lo = jnp.where(fits, jnp.uint32(0), vals << sh_lo)
    # drop empty slots by pointing them past the buffer
    w = jnp.where(lens > 0, w, cap_words)
    words = jnp.zeros((cap_words,), jnp.uint32)
    words = words.at[w].add(hi, mode="drop")
    words = words.at[w + 1].add(lo, mode="drop")
    return words, total_bits.astype(jnp.int32)


# ---------------------------------------------------------------------------
# the three-level packer (production path)
# ---------------------------------------------------------------------------

def _slot_pieces(vals, lens):
    """Per-slot (hi, lo) word contributions and word/bit offsets within
    the enclosing unit. vals/lens: (..., S)."""
    vals = vals.astype(jnp.uint32)
    lens = lens.astype(jnp.int32)
    mask = (jnp.uint32(0xFFFFFFFF)
            >> (32 - jnp.clip(lens, 1, 32)).astype(jnp.uint32))
    vals = jnp.where(lens > 0, vals & mask, jnp.uint32(0))
    offs = jnp.cumsum(lens, axis=-1) - lens
    ubits = offs[..., -1] + lens[..., -1]
    w = (offs >> 5).astype(jnp.int32)
    s = (offs & 31).astype(jnp.int32)
    hb = lens + s - 32
    fits = hb <= 0
    sh_hi_l = jnp.clip(32 - s - lens, 0, 31).astype(jnp.uint32)
    sh_hi_r = jnp.clip(hb, 0, 31).astype(jnp.uint32)
    hi = jnp.where(fits, vals << sh_hi_l, vals >> sh_hi_r)
    sh_lo = jnp.clip(32 - hb, 1, 31).astype(jnp.uint32)
    lo = jnp.where(fits, jnp.uint32(0), vals << sh_lo)
    return hi, lo, w, ubits


def _pack_units(vals, lens):
    """L1: pack each unit's S slots into UNIT_WORDS words by dense masked
    reduction (no scatter). vals/lens: (nmb, U, S).
    Returns (unit_words (nmb, U, UNIT_WORDS) uint32, unit_bits (nmb, U))."""
    hi, lo, w, ubits = _slot_pieces(vals, lens)
    cols = []
    for r in range(UNIT_WORDS):
        c = (jnp.where(w == r, hi, jnp.uint32(0)).sum(axis=-1)
             + jnp.where(w + 1 == r, lo, jnp.uint32(0)).sum(axis=-1))
        cols.append(c.astype(jnp.uint32))
    return jnp.stack(cols, axis=-1), ubits


def _merge_units(unit_words, unit_bits):
    """L2: merge each MB's U unit buffers into MB_WORDS words. Per-unit
    variable bit shift, then one-hot word placement.
    Returns (mb_words (nmb, MB_WORDS) uint32, mb_bits (nmb,) int32)."""
    nmb, U, _ = unit_words.shape
    uoffs = jnp.cumsum(unit_bits, axis=-1) - unit_bits      # (nmb, U)
    mb_bits = uoffs[:, -1] + unit_bits[:, -1]
    s = (uoffs & 31).astype(jnp.uint32)[..., None]          # (nmb, U, 1)
    b = (uoffs >> 5).astype(jnp.int32)                      # (nmb, U)
    z1 = jnp.zeros_like(unit_words[..., :1])
    cur = jnp.concatenate([unit_words, z1], axis=-1)        # [r] = uw[r]
    prev = jnp.concatenate([z1, unit_words], axis=-1)       # [r] = uw[r-1]
    carry = jnp.where(s == 0, jnp.uint32(0), prev << (32 - s))
    placed = (cur >> s) | carry                  # (nmb, U, UNIT_WORDS+1)

    wi = jnp.arange(MB_WORDS, dtype=jnp.int32)
    out = jnp.zeros((nmb, MB_WORDS), jnp.uint32)
    for r in range(UNIT_WORDS + 1):
        oh = (b + r)[..., None] == wi                       # (nmb, U, MBW)
        out = out + jnp.sum(
            jnp.where(oh, placed[..., r:r + 1], jnp.uint32(0)), axis=1)
    return out, mb_bits


def _mb_grid_to_words(sym_vals, sym_lens):
    """L1 + L2 + MB frame offsets for a (nmb, U*S) symbol grid."""
    nmb = sym_vals.shape[0]
    vals3 = sym_vals.reshape(nmb, -1, UNIT_SLOTS)
    lens3 = sym_lens.reshape(nmb, -1, UNIT_SLOTS)
    unit_words, unit_bits = _pack_units(vals3, lens3)
    mb_words, mb_bits = _merge_units(unit_words, unit_bits)
    offs = jnp.cumsum(mb_bits) - mb_bits
    total_bits = offs[-1] + mb_bits[-1]
    return mb_words, offs.astype(jnp.int32), total_bits.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("cap_words",))
def pack_frame_fast(sym_vals, sym_lens, cap_words: int):
    """Pack a frame's (nmb, U*S) symbol grid into uint32 words.

    `cap_words` must be a multiple of 128. If the stream exceeds it the
    output is invalid — callers detect via total_bits > 32*cap_words and
    re-pack at a larger capacity (ops and buffers stay sized for the
    *typical* frame instead of the 3200-bit/MB worst case).

    Returns (words (cap_words + 256,) uint32, total_bits int32); only the
    first cap_words words are meaningful, the +256 tail is slack.
    """
    assert cap_words % 128 == 0
    mb_words, offs, total_bits = _mb_grid_to_words(sym_vals, sym_lens)
    nmb = mb_words.shape[0]
    rows = cap_words // 128

    # L3, fully vectorized over MBs: bit-shift every MB buffer by
    # (off & 31), word-rotate to its output column with 7 conditional
    # static rolls, then scatter-add 128-wide row slices.
    s = (offs & 31).astype(jnp.uint32)[:, None]
    base_w = offs >> 5
    row = base_w // 128
    col = (base_w % 128)[:, None]
    ext = jnp.concatenate(
        [mb_words, jnp.zeros((nmb, 3 * 128 - MB_WORDS), jnp.uint32)],
        axis=1)                                              # (nmb, 384)
    prev = jnp.concatenate(
        [jnp.zeros((nmb, 1), jnp.uint32), ext[:, :-1]], axis=1)
    t = jnp.where(s == 0, ext, (ext >> s) | (prev << (32 - s)))
    for k in (1, 2, 4, 8, 16, 32, 64):
        rolled = jnp.concatenate([t[:, -k:], t[:, :-k]], axis=1)
        t = jnp.where((col & k) != 0, rolled, t)

    idx = (row[:, None] + jnp.arange(3, dtype=jnp.int32)).reshape(-1)
    out = jnp.zeros((rows + 2, 128), jnp.uint32)
    out = out.at[idx].add(t.reshape(nmb * 3, 128), mode="drop")
    return out.reshape(-1), total_bits


def words_to_bytes(words: np.ndarray, total_bits: int) -> bytes:
    """Convert packed uint32 words to the byte stream (MSB-first)."""
    nbytes = (int(total_bits) + 7) // 8
    return np.asarray(words).astype(">u4").tobytes()[:nbytes]


def pack_frame_scatter(sym_vals, sym_lens, cap_words: int):
    """Pack a (nmb, U*S) symbol grid with the scatter packer (CPU path;
    also the golden model for pack_frame_fast)."""
    return pack_bits_device(sym_vals.reshape(-1), sym_lens.reshape(-1),
                            cap_words)


def bucket_words(total_bits: int) -> int:
    """Round word capacity up to a power-of-two bucket (bounds the number
    of distinct jit specializations of pack_bits_device)."""
    need = (int(total_bits) + 31) // 32 + 2
    cap = 1024
    while cap < need:
        cap *= 2
    return cap
