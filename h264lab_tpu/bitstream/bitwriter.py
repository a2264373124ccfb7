"""Symbol-buffered bit writer with vectorized packing.

Design: unlike the reference's streaming 32-bit big-endian bit cache
(`src/h264-lab.h:2688-2772`), this writer *records* (value, nbits) symbol
pairs into growable numpy arrays and packs them into bytes in one
vectorized pass at the end. That matches the encoder's shape: device
kernels emit dense symbol arrays (CAVLC levels, golomb codes) which are
appended wholesale, and bit packing is a single prefix-sum/packbits pass
rather than a per-symbol loop.

All H.264 bit fields are MSB-first; symbols longer than 32 bits must be
split by the caller (the longest baseline syntax element is 32 bits).
"""

from __future__ import annotations

import numpy as np


def bit_length(v: np.ndarray) -> np.ndarray:
    """Elementwise bit length for non-negative int64 arrays."""
    v = np.asarray(v, dtype=np.int64)
    b = np.zeros_like(v)
    x = v.copy()
    while np.any(x):
        b += x > 0
        x >>= 1
    return b


def ue_code(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized unsigned Exp-Golomb: returns (code_value, nbits)."""
    v1 = np.asarray(v, dtype=np.int64) + 1
    return v1, 2 * bit_length(v1) - 1


def se_code(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized signed Exp-Golomb (spec 9.1.1)."""
    v = np.asarray(v, dtype=np.int64)
    return ue_code(np.where(v > 0, 2 * v - 1, -2 * v))


class BitWriter:
    """Growable MSB-first bit writer."""

    def __init__(self, capacity: int = 1024):
        self._vals = np.zeros(capacity, dtype=np.uint32)
        self._lens = np.zeros(capacity, dtype=np.uint8)
        self._n = 0

    # -- low level ---------------------------------------------------------
    def _grow(self, need: int):
        cap = len(self._vals)
        if self._n + need > cap:
            new_cap = max(cap * 2, self._n + need)
            self._vals = np.resize(self._vals, new_cap)
            self._lens = np.resize(self._lens, new_cap)

    def u(self, nbits: int, value: int):
        """Write fixed-width unsigned field, MSB first."""
        assert 0 < nbits <= 32
        self._grow(1)
        self._vals[self._n] = value & (0xFFFFFFFF >> (32 - nbits))
        self._lens[self._n] = nbits
        self._n += 1

    def u1(self, bit: int):
        self.u(1, bit)

    def ue(self, v: int):
        """Unsigned Exp-Golomb (spec 9.1)."""
        assert v >= 0
        code = v + 1
        self.u(2 * code.bit_length() - 1, code)

    def se(self, v: int):
        """Signed Exp-Golomb (spec 9.1.1)."""
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def te(self, v: int, max_val: int):
        """Truncated Exp-Golomb (spec 9.1.1): 1-bit inverted when max==1."""
        if max_val == 1:
            self.u1(1 - v)
        else:
            self.ue(v)

    # -- bulk appends (device-produced symbol streams) ---------------------
    def append_symbols(self, vals: np.ndarray, lens: np.ndarray):
        """Append arrays of (value, nbits) symbols; entries with nbits==0
        are skipped. This is the fast path for CAVLC output."""
        lens = np.asarray(lens).ravel()
        vals = np.asarray(vals).ravel()
        keep = lens > 0
        vals = vals[keep].astype(np.uint32)
        lens = lens[keep].astype(np.uint8)
        k = len(vals)
        self._grow(k)
        self._vals[self._n:self._n + k] = vals
        self._lens[self._n:self._n + k] = lens
        self._n += k

    def append_bits_bytes(self, data: bytes, nbits: int):
        """Append a pre-packed MSB-first bit payload of `nbits` bits
        (e.g. device-packed CAVLC words) at the current bit position."""
        if nbits == 0:
            return
        pad = (-len(data)) % 4
        arr = np.frombuffer(data + b"\x00" * pad, dtype=">u4").astype(np.uint32)
        n_full, rem = divmod(nbits, 32)
        k = n_full + (1 if rem else 0)
        vals = arr[:k].copy()
        lens = np.full(k, 32, np.uint8)
        if rem:
            vals[-1] >>= 32 - rem
            lens[-1] = rem
        self.append_symbols(vals, lens)

    def append_writer(self, other: "BitWriter"):
        self._grow(other._n)
        self._vals[self._n:self._n + other._n] = other._vals[:other._n]
        self._lens[self._n:self._n + other._n] = other._lens[:other._n]
        self._n += other._n

    # -- queries -----------------------------------------------------------
    @property
    def bit_length(self) -> int:
        return int(self._lens[:self._n].astype(np.int64).sum())

    def byte_align(self, bit: int = 0):
        """Pad with `bit` up to a byte boundary."""
        rem = (-self.bit_length) % 8
        if rem:
            self.u(rem, 0 if bit == 0 else (1 << rem) - 1)

    def rbsp_trailing_bits(self):
        """rbsp_stop_one_bit + zero padding to byte boundary (spec 7.3.2.11)."""
        self.u1(1)
        self.byte_align(0)

    # -- packing -----------------------------------------------------------
    def to_bits(self) -> np.ndarray:
        """Unpacked bit array (uint8 of 0/1), MSB-first order."""
        return pack_symbols_to_bits(self._vals[:self._n], self._lens[:self._n])

    def to_bytes(self) -> bytes:
        """Pack to bytes; total bit length must be a byte multiple
        (call rbsp_trailing_bits / byte_align first)."""
        assert self.bit_length % 8 == 0, "bitstream not byte aligned"
        try:
            from h264lab_tpu.utils import native
            if native.available():
                data, _ = native.pack_bits(self._vals[:self._n],
                                           self._lens[:self._n])
                return data
        except Exception:  # pragma: no cover
            pass
        return np.packbits(self.to_bits()).tobytes()


def pack_symbols_to_bits(vals: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Vectorized (value,len) symbol list → flat 0/1 bit array (MSB first).

    Right-align each symbol in a (n, maxlen) matrix: column c holds the bit
    with shift (maxlen-1-c); a symbol of length L occupies the last L
    columns. Masked flatten preserves stream order.
    """
    if len(vals) == 0:
        return np.zeros(0, dtype=np.uint8)
    lens = np.asarray(lens, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.uint64)
    maxlen = int(lens.max()) if len(lens) else 0
    if maxlen == 0:
        return np.zeros(0, dtype=np.uint8)
    cols = np.arange(maxlen, dtype=np.int64)[None, :]
    shift = (maxlen - 1 - cols).astype(np.uint64)
    bitmat = ((vals[:, None] >> shift) & 1).astype(np.uint8)
    mask = cols >= (maxlen - lens[:, None])
    return bitmat[mask]


def pack_symbols_to_bytes(vals: np.ndarray, lens: np.ndarray) -> tuple[bytes, int]:
    """Pack symbols to bytes (zero-padded at the tail); returns (data, nbits)."""
    bits = pack_symbols_to_bits(vals, lens)
    nbits = len(bits)
    if nbits % 8:
        bits = np.concatenate([bits, np.zeros((-nbits) % 8, dtype=np.uint8)])
    return np.packbits(bits).tobytes(), nbits
