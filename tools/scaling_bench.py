#!/usr/bin/env python
"""Scaling-efficiency measurement of the GOP-lane machinery.

Two independent scaling axes of the GOP-lane machinery:

1. lane batching on ONE device (the bench.py headline mode): fps at
   G = 1/2/4/8 lanes, same device — how much of the wavefront's latency
   bound lane-batching recovers;
2. multi-chip SPMD over a ("gop", "band") mesh of 8 virtual CPU devices
   (JAX_PLATFORMS=cpu + xla_force_host_platform_device_count=8): fps at
   mesh sizes 1/2/4/8, normalized per device — the parallel efficiency
   of the sharded program itself (closed GOP lanes are embarrassingly
   parallel; the measurement validates nothing serializes in practice).

Run:  python tools/scaling_bench.py [--mesh] [--update]
  (no flag: lane-batching on the default backend; --mesh: virtual mesh)
  --update appends the measured table to SCALING.md.

One JSON line per operating point.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

MESH_MODE = "--mesh" in sys.argv
if MESH_MODE:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    import jax
    jax.config.update("jax_platforms", "cpu")
else:
    import jax

from h264lab_tpu.config import EncoderConfig, RunConfig  # noqa: E402
from h264lab_tpu.parallel.gop import GopBandEncoder, make_mesh  # noqa: E402
from h264lab_tpu.utils.synthetic import chessboard_sequence  # noqa: E402

# mesh mode runs on CPU: use a small frame so the sweep finishes quickly
W, H = (320, 192) if MESH_MODE else (1920, 1088)
QP, GOP = 33, 20
STEPS = int(os.environ.get("SCALE_STEPS", "6"))
WARMUP = 2
SPEED = 2


def measure(n_lanes: int, mesh=None, bands: int = 1) -> float:
    frames = list(chessboard_sequence(W, H, WARMUP + STEPS))

    def lane_inputs(t):
        return [frames[(g * GOP + t) % len(frames)]
                for g in range(n_lanes)]

    cfg = EncoderConfig(width=W, height=H, gop=GOP, qp=QP,
                        slice_bands=bands)
    enc = GopBandEncoder(cfg, n_gop=n_lanes, mesh=mesh)
    run = RunConfig(qp_min=QP, qp_max=QP, encode_speed=SPEED)
    for t in range(WARMUP):
        enc.encode_step(lane_inputs(t), run)
    t0 = time.time()
    pending = None
    for t in range(WARMUP, WARMUP + STEPS):
        nxt = enc.encode_step_async(lane_inputs(t), run)
        if pending is not None:
            enc.finish_step(pending)
        pending = nxt
    enc.finish_step(pending)
    dt = time.time() - t0
    return n_lanes * STEPS / dt


def main():
    rows = []
    if "--bands" in sys.argv:
        # band axis on one device: B independent slices per frame
        # (the reference's slice-thread decomposition; more bands =
        # shorter wavefronts + per-slice overhead)
        base = None
        for b in (1, 2, 4):
            fps = measure(4, bands=b)
            base = fps if base is None else base
            rows.append(dict(mode="bands", lanes=4, bands=b,
                             fps=round(fps, 3),
                             vs_1band=round(fps / base, 3)))
            print(json.dumps(rows[-1]))
        if "--update" in sys.argv:
            path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "SCALING.md")
            with open(path, "a") as f:
                f.write(f"\n## bands {W}x{H} gop={GOP} qp={QP} "
                        f"speed={SPEED} lanes=4\n\n"
                        "| bands | fps | vs 1 band |\n|---:|---:|---:|\n")
                for r in rows:
                    f.write(f"| {r['bands']} | {r['fps']} | "
                            f"{r['vs_1band']} |\n")
            print(f"appended to {path}")
        return
    if MESH_MODE:
        base = None
        for n in (1, 2, 4, 8):
            mesh = make_mesh(n, 1)
            fps = measure(n, mesh=mesh)
            base = fps if base is None else base
            eff = fps / (base * n)
            rows.append(dict(mode="mesh", devices=n, fps=round(fps, 3),
                             fps_per_device=round(fps / n, 3),
                             efficiency=round(eff, 3)))
            print(json.dumps(rows[-1]))
    else:
        base = None
        for n in (1, 2, 4, 8):
            fps = measure(n)
            base = fps if base is None else base
            rows.append(dict(mode="lane-batch", lanes=n,
                             fps=round(fps, 3),
                             speedup=round(fps / base, 3)))
            print(json.dumps(rows[-1]))

    if "--update" in sys.argv:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "..", "SCALING.md")
        header_needed = not os.path.exists(path)
        with open(path, "a") as f:
            if header_needed:
                f.write("# Scaling efficiency (tools/scaling_bench.py)\n")
            f.write(f"\n## {'mesh' if MESH_MODE else 'lane-batch'} "
                    f"{W}x{H} gop={GOP} qp={QP} speed={SPEED}\n\n")
            if MESH_MODE:
                f.write("| devices | fps | fps/device | efficiency |\n"
                        "|---:|---:|---:|---:|\n")
                for r in rows:
                    f.write(f"| {r['devices']} | {r['fps']} | "
                            f"{r['fps_per_device']} | {r['efficiency']} |\n")
            else:
                f.write("| lanes | fps | speedup |\n|---:|---:|---:|\n")
                for r in rows:
                    f.write(f"| {r['lanes']} | {r['fps']} | "
                            f"{r['speedup']} |\n")
        print(f"appended to {path}")


if __name__ == "__main__":
    main()
