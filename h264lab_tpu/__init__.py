"""h264lab_tpu — an H.264/AVC baseline-profile encoder framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of a C single-header
H.264 baseline encoder (the reference, `h264-lab`):

- Baseline-profile (I/P slices, CAVLC) Annex-B bitstreams, IDR/I/P/Golden/
  Recovery/Droppable frame types via long-term references.
- Intra 16x16 + 4x4 prediction, inter 16x16/16x8/8x16/8x8 with full-pel +
  sub-pel motion search, 4x4 integer transform + quantization, in-loop
  deblocking, two-level rate control with a VBV model, temporal denoising,
  multi-slice output and SVC 2-layer spatial scalability.

Architecture (batched, not a port):

- Pixel math is batched over macroblocks as `(n_mb, 16, 16)` tensors and
  runs as fused XLA programs; the per-MB scan of the C encoder becomes an
  anti-diagonal *wavefront* `lax.scan`. There are no hand-written
  kernels: every stage is plain `jax.numpy`/`lax`.
- CAVLC symbols are computed for every 4x4 block in parallel on device;
  variable-length bit packing is a prefix-sum pass; NAL framing and
  emulation-prevention escaping run on host (native C++ fast path).
- Scale-out: `jax.sharding.Mesh` with axes `("gop", "band")` — closed
  GOPs data-parallel across devices, MB-row slice bands across devices
  (each band is an independent H.264 slice, mirroring the reference's
  slice-parallel threading mode at `src/h264-lab.h:6511-6574`).
"""

import os as _os

import jax as _jax

# Persistent XLA compilation cache, shared by every entry point (CLI,
# bench, tests): the wavefront-scan programs at 1080p take a long time
# to compile, so a warm on-disk cache shortens every later cold start.
# JAX_COMPILATION_CACHE_DIR, when set, names the directory and JAX reads
# it itself; otherwise the cache lives at the fixed <checkout>/.jax_cache.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.normpath(_os.path.join(
            _os.path.dirname(_os.path.abspath(__file__)), _os.pardir,
            ".jax_cache")))
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
_jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

from h264lab_tpu.config import (
    EncoderConfig,
    RunConfig,
    FrameType,
    SpeedPreset,
)
from h264lab_tpu.models.encoder import H264Encoder

__version__ = "0.1.0"

__all__ = [
    "EncoderConfig",
    "RunConfig",
    "FrameType",
    "SpeedPreset",
    "H264Encoder",
    "__version__",
]
