#!/usr/bin/env python
"""Per-stage timing of the staged GOP-lane pipeline at the bench config
(1080p, 16 lanes, speed 2) on the GPU: what dominates a P step?

Each stage program of one P step runs alone to completion
(block_until_ready), 5 times after a warm-up, and prints its mean wall
time. `pack` is timed with both packers, `pack_frame_fast` (production)
and `pack_bits_device`. Prints the card's name and power limit first;
exits non-zero when JAX's default platform is not a GPU.

Usage: python tools/profile_stages.py   (PROF_W/PROF_H/PROF_LANES/
PROF_SPEED override the configuration)
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

import jax
import jax.numpy as jnp
import numpy as np

from h264lab_tpu.config import EncoderConfig, RunConfig
from h264lab_tpu.models import wavefront
from h264lab_tpu.ops import bitpack
from h264lab_tpu.parallel import gop
from h264lab_tpu.utils import device
from h264lab_tpu.utils.synthetic import chessboard_sequence

W, H = int(os.environ.get("PROF_W", 1920)), int(os.environ.get("PROF_H", 1088))
QP = 33
G = int(os.environ.get("PROF_LANES", "16"))
SPEED = int(os.environ.get("PROF_SPEED", "2"))


def timeit(fn, *args, n=5, **kw):
    out = fn(*args, **kw)
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(n):
        jax.block_until_ready(fn(*args, **kw))
    return (time.time() - t0) / n


def main():
    devs = device.require_gpu()
    print(f"device {devs[0].device_kind}; nvidia-smi: "
          + " | ".join(device.card_lines()))
    cfg = EncoderConfig(width=W, height=H, gop=20, qp=QP)
    enc = gop.GopBandEncoder(cfg, n_gop=G)
    run = RunConfig(qp_min=QP, qp_max=QP, encode_speed=SPEED)
    frames = list(chessboard_sequence(W, H, 3))

    # two steps: IDR + P (builds refs, prev_mv, settles cap_words)
    enc.encode_step([frames[0]] * G, run)
    enc.encode_step([frames[1]] * G, run)

    mbw, B = cfg.mb_width, enc.n_bands
    band_rows = enc.band_rows
    fns = gop._gop_stage_fns(mbw, band_rows, B, True,
                             SPEED < 2, SPEED < 1, SPEED < 9)
    pack = gop._gop_pack_fn(enc.p_cap_words)
    pack_scatter = jax.jit(jax.vmap(jax.vmap(
        lambda v, l: bitpack.pack_bits_device(v.reshape(-1), l.reshape(-1),
                                              enc.p_cap_words))))

    ph, pw = cfg.padded_height, cfg.padded_width
    y, u, v = frames[2]
    py = np.stack([wavefront.pad_plane(np.asarray(y, np.uint8), ph, pw)] * G)
    pu = np.stack([wavefront.pad_plane(np.asarray(u, np.uint8),
                                       ph // 2, pw // 2)] * G)
    pv = np.stack([wavefront.pad_plane(np.asarray(v, np.uint8),
                                       ph // 2, pw // 2)] * G)
    src_y, src_u, src_v = jnp.asarray(py), jnp.asarray(pu), jnp.asarray(pv)
    refs = enc._refs[0]
    qp_arr = jnp.full((G, B), QP, jnp.int32)
    qpc_arr = jnp.full((G, B), QP, jnp.int32)
    row0s = jnp.asarray(np.arange(B, dtype=np.int32) * band_rows)
    steps, a_top, a_left = enc._plan(2 if SPEED < 2 else 1)
    nmb_b = band_rows * mbw
    pmy = pmx = jnp.zeros((G, B, nmb_b), jnp.int32)

    t_pre = timeit(fns.pre, src_y, src_u, src_v)
    sy, su, sv = fns.pre(src_y, src_u, src_v)
    t_inter = timeit(fns.inter, sy, su, sv, refs, qp_arr, qpc_arr,
                     row0s, pmy, pmx)
    inter = fns.inter(sy, su, sv, refs, qp_arr, qpc_arr, row0s, pmy, pmx)
    t_sel = timeit(fns.select, sy, su, sv, qp_arr, qpc_arr,
                   steps, a_top, a_left, inter)
    st = fns.select(sy, su, sv, qp_arr, qpc_arr, steps, a_top, a_left, inter)
    t_sym = timeit(fns.sym, st)
    sym = fns.sym(st)
    t_dbl = timeit(fns.deblock, st, qp_arr, qpc_arr, a_top, a_left)
    df_y, df_u, df_v = fns.deblock(st, qp_arr, qpc_arr, a_top, a_left)
    t_pack = timeit(pack, sym["sym_vals"], sym["sym_lens"])
    t_pack_s = timeit(pack_scatter, sym["sym_vals"], sym["sym_lens"])
    t_ref = timeit(fns.ref, df_y, df_u, df_v, st["mv_y"], st["mv_x"])

    total = t_pre + t_inter + t_sel + t_sym + t_dbl + t_pack + t_ref
    for name, t in [("pre(tile)", t_pre), ("inter(ME+TQ)", t_inter),
                    ("select(intra+merge)", t_sel), ("symbolize", t_sym),
                    ("deblock", t_dbl), ("pack", t_pack),
                    ("pack(scatter)", t_pack_s),
                    ("ref prep", t_ref), ("TOTAL", total)]:
        print(f"{name:20s} {1e3 * t:10.3f} ms"
              + (f"   ({G / t:.2f} fps @ G={G})" if name == "TOTAL" else ""))


if __name__ == "__main__":
    main()
