"""The three-level packer (pack_frame_fast) must be bit-identical to the
scatter packer (pack_bits_device).

Random grids are clamped to the packer's structural bounds, which real
symbol streams satisfy by construction: <= 630 bits per CAVLC unit
(UNIT_WORDS) and <= 3200 bits per MB (spec 7.4.5, MB_WORDS).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from h264lab_tpu.ops import bitpack

S = bitpack.UNIT_SLOTS


def _random_grid(rng, nmb, zero_frac):
    shape = (nmb, 28 * S)
    lens = rng.integers(1, 29, shape).astype(np.int32)
    lens[rng.random(shape) < zero_frac] = 0
    lens[rng.random(shape) < 0.01] = 32
    # clamp to the structural bounds (drop slots past the budget)
    u = lens.reshape(nmb, 28, S)
    ucum = np.cumsum(u, axis=-1)
    u[ucum > 640] = 0
    mcum = np.cumsum(u.reshape(nmb, -1), axis=-1).reshape(nmb, 28, S)
    u[mcum > 3200] = 0
    lens = u.reshape(shape)
    vals = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    return jnp.asarray(vals), jnp.asarray(lens)


@pytest.mark.parametrize("nmb,zero_frac", [(48, 0.97), (48, 0.6), (6, 0.0)])
def test_fast_matches_scatter(nmb, zero_frac):
    rng = np.random.default_rng(nmb + int(zero_frac * 100))
    vals, lens = _random_grid(rng, nmb, zero_frac)
    total = int(np.sum(np.asarray(lens)))
    cap = 128
    while cap * 32 < total:
        cap *= 2
    ws, ts = bitpack.pack_bits_device(vals.reshape(-1), lens.reshape(-1),
                                      cap)
    wf, tf = bitpack.pack_frame_fast(vals, lens, cap)
    assert int(ts) == int(tf) == total
    np.testing.assert_array_equal(np.asarray(ws), np.asarray(wf)[:cap])


def test_unit_bound():
    """A worst-case 630-bit CAVLC unit stays within UNIT_WORDS."""
    lens = np.zeros((1, 28 * S), np.int32)
    lens[0, :22] = 28                      # 616 bits in unit 0
    lens[0, S:S + 2] = 32                  # straddles in unit 1
    assert lens[0, :S].sum() <= bitpack.UNIT_WORDS * 32 - 31
    vals = np.full_like(lens, 0xFFFFFFFF, dtype=np.uint32)
    wf, _ = bitpack.pack_frame_fast(jnp.asarray(vals.astype(np.uint32)),
                                    jnp.asarray(lens), 128)
    ws, _ = bitpack.pack_bits_device(
        jnp.asarray(vals.astype(np.uint32)).reshape(-1),
        jnp.asarray(lens).reshape(-1), 128)
    np.testing.assert_array_equal(np.asarray(ws), np.asarray(wf)[:128])
