"""Measure XLA compile time of the encode pipeline, stage by stage.

Times trace+lower and compile separately for the pieces of the
monolithic P-frame program at a small config (128x96, speed 0 and
speed 2) on the CPU backend — the data that drives the staged-jit
decomposition. The persistent compilation cache is off, so every
program really compiles.

Usage: JAX_PLATFORMS=cpu python tools/compile_budget.py [--flags "..."]
"""

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "--flags" in sys.argv:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                               + sys.argv[sys.argv.index("--flags") + 1])

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

import functools                                      # noqa: E402
import jax                                            # noqa: E402
import jax.numpy as jnp                               # noqa: E402
import numpy as np                                    # noqa: E402

from h264lab_tpu.models import mbscan, refstate, wavefront   # noqa: E402
from h264lab_tpu.ops import bitpack, me, qpel         # noqa: E402

jax.config.update("jax_enable_compilation_cache", False)


def timed(name, fn, *args, **kw):
    t0 = time.time()
    lowered = jax.jit(fn, **kw).lower(*args)
    t1 = time.time()
    lowered.compile()
    t2 = time.time()
    print(f"{name:42s} trace+lower {t1-t0:7.2f}s   compile {t2-t1:7.2f}s")
    return t2 - t0


def main():
    mbw, mbh = 8, 6
    nmb = mbw * mbh
    rng = np.random.default_rng(0)
    r = np.arange(nmb) // mbw
    c = np.arange(nmb) % mbw
    plan2 = wavefront.make_plan(mbw, mbh, slope=2)
    steps2 = jnp.asarray(plan2.steps)
    a_top = jnp.asarray(r > 0)
    a_left = jnp.asarray(c > 0)

    src_y = jnp.asarray(rng.integers(0, 256, (nmb, 16, 16), dtype=np.uint8))
    src_u = jnp.asarray(rng.integers(0, 256, (nmb, 8, 8), dtype=np.uint8))
    src_v = jnp.asarray(rng.integers(0, 256, (nmb, 8, 8), dtype=np.uint8))
    ref = refstate.prepare_reference(src_y, src_u, src_v, mbw, mbh)
    qp = jnp.int32(30)
    z = jnp.zeros((nmb,), jnp.int32)

    total = 0.0

    # --- stage 1: ME alone (with subpel, no partitions) ---
    cur_plane = (src_y.reshape(mbh, mbw, 16, 16).transpose(0, 2, 1, 3)
                 .reshape(mbh * 16, mbw * 16))
    base_y = qpel.GUARD + 16 * jnp.asarray(r)
    base_x = qpel.GUARD + 16 * jnp.asarray(c)

    def me_only(cp, st, ry, r4, by, bx, q, pmy, pmx):
        mvy, mvx, cost, pred, aux = me.motion_search_dense(
            cp, st, ry, r4, by, bx, q, mbh, mbw, 0,
            prev_my=pmy, prev_mx=pmx)
        return mvy, mvx, cost, pred

    total += timed("me (16x16+subpel)", me_only, cur_plane, src_y,
                   ref["y_pad"], ref["y4_pad"], base_y, base_x, qp, z, z)

    def me_parts(cp, st, ry, r4, by, bx, q, pmy, pmx):
        mvy, mvx, cost, pred, aux = me.motion_search_dense(
            cp, st, ry, r4, by, bx, q, mbh, mbw, 0,
            prev_my=pmy, prev_mx=pmx)
        ps = me.partition_search(st, aux, q)
        return mvy, mvx, cost, pred, ps

    total += timed("me + partition_search", me_parts, cur_plane, src_y,
                   ref["y_pad"], ref["y4_pad"], base_y, base_x, qp, z, z)

    # --- full monolithic programs for reference ---
    f_p0 = functools.partial(
        mbscan.encode_frame_core, mb_width=mbw, mb_height=mbh,
        has_inter=True, enable_i4x4=True, enable_deblock=True,
        enable_partitions=True, enable_qpel=True,
        mb_row_offset=jnp.int32(0), prev_my=z, prev_mx=z)
    total += timed("MONOLITHIC P speed0 (i4x4+parts)", f_p0,
                   src_y, src_u, src_v, ref["y_pad"], ref["u_pad"],
                   ref["v_pad"], ref["y4_pad"], qp, qp, steps2,
                   a_top, a_left)

    f_p2 = functools.partial(
        mbscan.encode_frame_core, mb_width=mbw, mb_height=mbh,
        has_inter=True, enable_i4x4=False, enable_deblock=True,
        enable_partitions=False, enable_qpel=True,
        mb_row_offset=jnp.int32(0), prev_my=z, prev_mx=z)
    total += timed("MONOLITHIC P speed2 (parallel)", f_p2,
                   src_y, src_u, src_v, ref["y_pad"], ref["u_pad"],
                   ref["v_pad"], ref["y4_pad"], qp, qp, steps2,
                   a_top, a_left)

    f_i = functools.partial(
        mbscan.encode_intra_core, mb_width=mbw, mb_height=mbh,
        enable_i4x4=True, enable_deblock=True)
    total += timed("MONOLITHIC I (i4x4 wavefront)", f_i,
                   src_y, src_u, src_v, qp, qp, steps2, a_top, a_left)

    # --- pack alone ---
    sv = jnp.zeros((nmb, 28 * bitpack.UNIT_SLOTS), jnp.uint32)
    sl = jnp.zeros((nmb, 28 * bitpack.UNIT_SLOTS), jnp.int32)
    total += timed("pack_frame_fast", functools.partial(
        bitpack.pack_frame_fast, cap_words=4096), sv, sl)

    print(f"{'TOTAL':42s} {total:7.2f}s")


if __name__ == "__main__":
    main()
