#!/usr/bin/env python
"""Smoke test: the encoder's main path on an NVIDIA GPU.

Every stage program runs as compiled for the card, and each phase checks
its output bit for bit against an independent reference:

  a  device: JAX platform, device kind and count; nvidia-smi's card name
     and power limit; whether the C++ host packer (`make -C native`) is
     in use.
  b  bit packer at 1080p width: `pack_frame_fast` and `pack_bits_device`
     on the GPU against the host packer.
  c  lane path, the bench configuration: `GopBandEncoder` at 1920x1088,
     16 lanes, GOP 20, QP 33, speed 2, driven through encode_step_async /
     finish_step; lane 0's IDR + 2 P frames, decoded by the independent
     decoder, equal the encoder's reconstruction.
  d  single-stream path at 1920x1088: the CLI (speed 0) returns 0, and
     `H264Encoder` on the same 3 frames writes the same bytes, whose
     decode equals the encoder's reconstruction.
  e  backend identity: 352x288 streams at speed 0 and 2 have the sha256
     that tests/test_backend_digest.py pins on the CPU
     (tests/fixtures/backend_digest.json).

With --mesh4 only phase f runs (after the device lines), on four GPUs:
  f  `GopBandEncoder` at 1920x1088 with 2 slice bands and 2 GOP lanes over
     a (gop=2, band=2) mesh writes the same bytes as the same encoder on
     card 0 alone, every card holds its share of the step, and lane 0
     decodes bit-exactly.

The decodes run in CPU-only child processes (JAX_PLATFORMS=cpu) beside
the GPU work, so only this process uses the cards. Each phase prints one
line with its wall seconds: the first call, compilation included, and
the steady state. Any failure raises, so the script exits non-zero and
prints no result. The last line of a passing run is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.

Usage: python chip_smoke.py [--mesh4]
"""

import argparse
import hashlib
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import jax
import numpy as np

from h264lab_tpu import cli
from h264lab_tpu.config import EncoderConfig, RunConfig
from h264lab_tpu.decoder.decoder import H264Decoder
from h264lab_tpu.models.encoder import H264Encoder
from h264lab_tpu.ops import bitpack
from h264lab_tpu.parallel.gop import GopBandEncoder, make_mesh
from h264lab_tpu.utils import device, native
from h264lab_tpu.utils.synthetic import chessboard_sequence

ROOT = os.path.dirname(os.path.abspath(__file__))
DIGEST_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                              "backend_digest.json")
W, H = 1920, 1088
GOP, QP = 20, 33


def log(msg: str):
    print(msg, flush=True)


def timed(fn, *args, **kw):
    """(result, seconds) of fn(*args) run to completion on the device."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kw))
    return out, time.perf_counter() - t0


class DecodeChecks:
    """Independent decodes in CPU-only child processes: each child
    decodes an Annex-B stream and compares every frame with the
    encoder's reconstruction (`--decode-check`)."""

    def __init__(self):
        self._tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
        self.tmpdir = self._tmp.name
        self._jobs = []

    def start(self, name: str, stream: bytes, recons: list):
        path = os.path.join(self.tmpdir, f"{len(self._jobs)}.pkl")
        with open(path, "wb") as f:
            pickle.dump((stream, recons), f)
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--decode-check",
             path],
            env=dict(os.environ, JAX_PLATFORMS="cpu"),
            stdout=subprocess.PIPE, text=True)
        self._jobs.append((name, proc))

    def wait(self):
        jobs, self._jobs = self._jobs, []
        for name, proc in jobs:
            out, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(
                    f"{name}: decode check exited {proc.returncode}")
            log(f"{name}: {out.strip()}")

    def close(self):
        for _, proc in self._jobs:
            proc.kill()
            proc.wait()
        self._tmp.cleanup()


def decode_check(path: str):
    with open(path, "rb") as f:
        stream, recons = pickle.load(f)
    t0 = time.perf_counter()
    dec = H264Decoder()
    frames = dec.decode(stream)
    if len(frames) != len(recons):
        raise SystemExit(f"decoded {len(frames)} frames, "
                         f"encoded {len(recons)}")
    for t, (df, rec) in enumerate(zip(frames, recons)):
        for plane, got, want in zip("yuv", df.cropped(dec.sps), rec):
            if not np.array_equal(np.asarray(got), np.asarray(want)):
                raise SystemExit(f"frame {t} plane {plane}: decode "
                                 "differs from the encoder recon")
    print(f"{len(frames)} frames decode bit-exact to the encoder recon "
          f"({time.perf_counter() - t0:.1f} s on the host)")


def phase_device(min_count: int):
    devs = device.require_gpu(min_count)
    d = devs[0]
    log(f"phase a device: platform={d.platform} kind={d.device_kind} "
        f"count={len(devs)}")
    for line in device.card_lines():
        log(f"nvidia-smi: {line}")
    subprocess.run(["make", "-s", "-C", os.path.join(ROOT, "native")],
                   check=True)
    log(f"native host packer in use: {native.available()}")
    return devs


def random_symbol_grid(rng, nmb: int, zero_frac: float):
    """Random (nmb, 28*S) symbol grid clamped to the packer's structural
    bounds: <= 640 bits per CAVLC unit, <= 3200 bits per MB."""
    s = bitpack.UNIT_SLOTS
    shape = (nmb, 28 * s)
    lens = rng.integers(1, 29, shape).astype(np.int32)
    lens[rng.random(shape) < zero_frac] = 0
    lens[rng.random(shape) < 0.01] = 32
    u = lens.reshape(nmb, 28, s)
    u[np.cumsum(u, axis=-1) > 640] = 0
    u[np.cumsum(u.reshape(nmb, -1), axis=-1).reshape(u.shape) > 3200] = 0
    vals = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    return vals, u.reshape(shape)


def phase_packer(nmb: int = (W // 16) * (H // 16)):
    vals, lens = random_symbol_grid(np.random.default_rng(0), nmb, 0.6)
    total = int(lens.sum())
    cap = -(-total // (32 * 128)) * 128
    v, l = jax.device_put(vals), jax.device_put(lens)
    (wf, tf), first_f = timed(bitpack.pack_frame_fast, v, l, cap)
    (wf, tf), steady_f = timed(bitpack.pack_frame_fast, v, l, cap)
    vf, lf = v.reshape(-1), l.reshape(-1)
    (ws, ts), first_s = timed(bitpack.pack_bits_device, vf, lf, cap)
    (ws, ts), steady_s = timed(bitpack.pack_bits_device, vf, lf, cap)
    if not int(tf) == int(ts) == total:
        raise AssertionError(f"bit counts {int(tf)} / {int(ts)} != {total}")
    wf = np.asarray(wf)[:cap]
    if not np.array_equal(wf, np.asarray(ws)):
        raise AssertionError("pack_frame_fast != pack_bits_device")
    if native.available():
        host, _ = native.pack_bits(vals.reshape(-1), lens.reshape(-1))
        host_name = "C++ host packer"
    else:
        cpu = jax.devices("cpu")[0]
        wc, _ = bitpack.pack_bits_device(
            jax.device_put(vals.reshape(-1), cpu),
            jax.device_put(lens.reshape(-1), cpu), cap)
        host = bitpack.words_to_bytes(np.asarray(wc), total)
        host_name = "pack_bits_device on the CPU backend"
    if bitpack.words_to_bytes(wf, total) != host:
        raise AssertionError(f"GPU packers != {host_name}")
    log(f"phase b packer ({nmb}, {lens.shape[1]}) grid, {total} bits: "
        f"pack_frame_fast first {first_f:.2f} s steady {steady_f:.4f} s; "
        f"pack_bits_device first {first_s:.2f} s steady {steady_s:.4f} s; "
        f"both equal the {host_name}")


def phase_lanes(checks: DecodeChecks, width: int = W, height: int = H,
                lanes: int = 16, steady_steps: int = 5):
    cfg = EncoderConfig(width=width, height=height, gop=GOP, qp=QP)
    run = RunConfig(qp_min=QP, qp_max=QP, encode_speed=2)
    n_src = 3 + steady_steps
    src = list(chessboard_sequence(width, height, n_src))

    def inputs(t):          # lane g encodes GOP g, as bench.py does
        return [src[(g * GOP + t) % n_src] for g in range(lanes)]

    enc = GopBandEncoder(cfg, n_gop=lanes)
    stream, recons, first = b"", [], []
    for t in range(3):      # IDR + 2 P, each run to completion
        t0 = time.perf_counter()
        res = enc.finish_step(
            enc.encode_step_async(inputs(t), run, return_recon=True))
        first.append(time.perf_counter() - t0)
        if not all(r.payload for r in res):
            raise AssertionError(f"step {t}: empty lane payload")
        stream += res[0].payload
        recons.append(res[0].recon)
    checks.start("phase c decode of lane 0", stream, recons)

    t0 = time.perf_counter()
    pending, nbytes = None, 0
    for t in range(3, n_src):   # pipelined like bench.py
        nxt = enc.encode_step_async(inputs(t), run)
        if pending is not None:
            nbytes += sum(len(r.payload) for r in enc.finish_step(pending))
        pending = nxt
    nbytes += sum(len(r.payload) for r in enc.finish_step(pending))
    dt = time.perf_counter() - t0
    log(f"phase c lanes {width}x{height} x{lanes} speed 2: IDR step "
        f"{first[0]:.2f} s, first P step {first[1]:.2f} s (compile incl.), "
        f"second P step {first[2]:.2f} s; steady {dt / steady_steps:.3f} "
        f"s/step = {lanes * steady_steps / dt:.2f} frames/s "
        f"({nbytes / (lanes * steady_steps):.0f} bytes/frame)")


def phase_single(checks: DecodeChecks, width: int = W, height: int = H,
                 n_frames: int = 3):
    out = os.path.join(checks.tmpdir, "cli.264")
    t0 = time.perf_counter()
    rc = cli.main(["--gen", "--size", f"{width}x{height}", "--maxframes",
                   str(n_frames), "--speed", "0", "--psnr",
                   "--output", out])
    t_cli = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"CLI returned {rc}")
    cfg = EncoderConfig(width=width, height=height, gop=cli.DEFAULT_GOP,
                        qp=cli.DEFAULT_QP)
    run = RunConfig(qp_min=cfg.qp, qp_max=cfg.qp, encode_speed=0)
    enc = H264Encoder(cfg)
    stream, recons = b"", []
    t0 = time.perf_counter()
    for y, u, v in chessboard_sequence(width, height, n_frames):
        res = enc.encode(y, u, v, run, return_recon=True)
        stream += res.payload
        recons.append(res.recon)
    t_lib = time.perf_counter() - t0
    with open(out, "rb") as f:
        if f.read() != stream:
            raise AssertionError("H264Encoder stream != CLI stream")
    checks.start("phase d decode", stream, recons)
    log(f"phase d single stream {width}x{height} speed 0, {n_frames} "
        f"frames: CLI {t_cli:.2f} s (compile incl.), H264Encoder "
        f"{t_lib:.2f} s = {t_lib / n_frames:.3f} s/frame; same bytes")


def digest_stream(spec: dict, speed: int) -> bytes:
    """The backend-identity stream described by the digest fixture."""
    cfg = EncoderConfig(width=spec["width"], height=spec["height"],
                        gop=spec["gop"], qp=spec["qp"])
    run = RunConfig(qp_min=spec["qp"], qp_max=spec["qp"], encode_speed=speed)
    enc = H264Encoder(cfg)
    return b"".join(enc.encode(*f, run).payload for f in chessboard_sequence(
        spec["width"], spec["height"], spec["frames"]))


def phase_digest():
    with open(DIGEST_FIXTURE) as f:
        spec = json.load(f)
    for speed, want in spec["sha256"].items():
        t0 = time.perf_counter()
        got = hashlib.sha256(digest_stream(spec, int(speed))).hexdigest()
        if got != want:
            raise AssertionError(f"speed {speed}: sha256 {got} != pinned "
                                 f"{want}")
        log(f"phase e {spec['width']}x{spec['height']} speed {speed}: "
            f"sha256 {got} equals the CPU pin "
            f"({time.perf_counter() - t0:.2f} s, compile incl.)")


def phase_mesh(checks: DecodeChecks, width: int = W, height: int = H,
               steps: int = 3):
    devs = jax.devices()[:4]
    cfg = EncoderConfig(width=width, height=height, gop=GOP, qp=QP,
                        slice_bands=2)
    run = RunConfig(qp_min=QP, qp_max=QP, encode_speed=2)
    src = list(chessboard_sequence(width, height, GOP + steps))

    def inputs(t):
        return [src[t], src[GOP + t]]

    enc_m = GopBandEncoder(cfg, n_gop=2, mesh=make_mesh(2, 2, devs))
    mesh_res, t_mesh = [], []
    for t in range(steps):
        t0 = time.perf_counter()
        p = enc_m.encode_step_async(inputs(t), run, return_recon=True)
        holders = {s.device for s in p.out["words"].addressable_shards}
        if holders != set(devs):
            raise AssertionError(f"step {t}: packed words on {holders}")
        mesh_res.append(enc_m.finish_step(p))
        t_mesh.append(time.perf_counter() - t0)
    ref_y = enc_m._refs[0]["y_pad"]
    if {s.device for s in ref_y.addressable_shards} != set(devs):
        raise AssertionError("reference picture not on every card")
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
             for d in devs]
    if min(peaks) < max(peaks) // 4:
        raise AssertionError(f"uneven device peaks {peaks}")
    checks.start("phase f decode of lane 0",
                 b"".join(r[0].payload for r in mesh_res),
                 [r[0].recon for r in mesh_res])

    enc_1 = GopBandEncoder(cfg, n_gop=2, mesh=None)
    t_one = []
    for t in range(steps):
        t0 = time.perf_counter()
        res = enc_1.encode_step(inputs(t), run)
        t_one.append(time.perf_counter() - t0)
        for g in range(2):
            if res[g].payload != mesh_res[t][g].payload:
                raise AssertionError(f"step {t} lane {g}: mesh bytes != "
                                     "card-0 bytes")
    log(f"phase f mesh (gop=2, band=2) {width}x{height} speed 2: mesh "
        f"steps {', '.join(f'{s:.2f}' for s in t_mesh)} s, card-0 steps "
        f"{', '.join(f'{s:.2f}' for s in t_one)} s (first compile incl.); "
        f"streams byte-identical; packed words and reference "
        f"({ref_y.sharding.spec}) on all {len(devs)} cards; peak bytes "
        f"per card {peaks}")


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mesh4", action="store_true",
                   help="run only the four-GPU mesh phase (f)")
    p.add_argument("--decode-check", metavar="PICKLE",
                   help=argparse.SUPPRESS)   # the CPU-only decode child
    args = p.parse_args(argv)
    if args.decode_check:
        decode_check(args.decode_check)
        return
    devs = phase_device(4 if args.mesh4 else 1)
    checks = DecodeChecks()
    try:
        if args.mesh4:
            phase_mesh(checks)
        else:
            phase_packer()
            phase_lanes(checks)
            phase_single(checks)
            phase_digest()
        checks.wait()
    finally:
        checks.close()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main(sys.argv[1:])
