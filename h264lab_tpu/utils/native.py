"""ctypes bindings for the optional `_h264lab_native` C++ extension.

The native library accelerates the host-side runtime around the device
compute path: NAL emulation-prevention escaping and variable-length bit packing
(the analogs of the reference's `nal_put_esc` `src/h264-lab.h:3952-3977`
and bit cache `:2688-2772`). Falls back transparently to numpy when the
shared library has not been built (see native/README.md; `make -C native`).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _lib_path() -> str:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(here, "..", "native", "libh264lab_native.so")


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = os.path.normpath(_lib_path())
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.h264lab_escape_rbsp.restype = ctypes.c_long
        lib.h264lab_escape_rbsp.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p, ctypes.c_long]
        lib.h264lab_pack_bits.restype = ctypes.c_long
        lib.h264lab_pack_bits.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_long, ctypes.c_char_p, ctypes.c_long]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def escape_rbsp(rbsp: bytes) -> bytes:
    lib = _load()
    out = ctypes.create_string_buffer(len(rbsp) + len(rbsp) // 2 + 8)
    n = lib.h264lab_escape_rbsp(rbsp, len(rbsp), out, len(out))
    return out.raw[:n]


def pack_bits(vals: np.ndarray, lens: np.ndarray) -> tuple[bytes, int]:
    """Pack (value, nbits) symbol arrays into a byte string; returns
    (bytes, total_bits)."""
    lib = _load()
    vals = np.ascontiguousarray(vals, dtype=np.uint32)
    lens = np.ascontiguousarray(lens, dtype=np.uint8)
    total_bits = int(lens.astype(np.int64).sum())
    out = ctypes.create_string_buffer((total_bits + 7) // 8 + 8)
    n = lib.h264lab_pack_bits(
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(vals), out, len(out))
    return out.raw[:n], total_bits
