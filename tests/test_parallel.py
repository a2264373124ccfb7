"""Multi-chip parallelism tests on the virtual 8-device CPU mesh.

Validates the (gop x band) sharded encoder end-to-end: the sharded
program must produce byte-identical streams to the single-device
encoder, and the streams must decode bit-exactly (independent decoder).
The batched equivalent of testing the reference's slice-thread mode
(`src/h264-lab.h:6511-6574`) without a cluster (SURVEY.md §4).
"""

import numpy as np
import pytest

import jax

from h264lab_tpu.config import EncoderConfig, RunConfig
from h264lab_tpu.decoder.decoder import H264Decoder
from h264lab_tpu.models.encoder import H264Encoder
from h264lab_tpu.parallel.gop import GopBandEncoder, encode_stream, make_mesh
from h264lab_tpu.utils.synthetic import chessboard_sequence

W, H = 96, 64
QP = 30


def _frames(n):
    return list(chessboard_sequence(W, H, n))


def _sequential_stream(frames, cfg, run):
    enc = H264Encoder(cfg)
    return b"".join(enc.encode(*f, run).payload for f in frames)


@pytest.fixture(scope="module")
def run():
    return RunConfig(qp_min=QP, qp_max=QP, encode_speed=2)


def test_gop_parallel_bit_identical_to_sequential(run):
    """GOP-parallel scheduling is invisible in the bitstream: at fixed QP
    the stitched stream equals the sequential encoder's output."""
    frames = _frames(6)
    cfg = EncoderConfig(width=W, height=H, gop=3, qp=QP, slice_bands=2)
    seq = _sequential_stream(frames, cfg, run)
    par = encode_stream(frames, cfg, n_gop=2, run=run)
    assert par == seq


def test_mesh_sharded_stream_matches_and_decodes(run):
    """The (gop, band)-mesh-sharded program produces the same bytes as
    the unsharded one, and the stream decodes bit-exactly."""
    # fail loudly, never skip: a silently-skipped mesh test is how the
    # round-2 multichip gate went red while the suite stayed green
    assert len(jax.devices()) >= 4, \
        "conftest must provide the 8-virtual-device CPU mesh"
    frames = _frames(3)
    cfg = EncoderConfig(width=W, height=H, gop=3, qp=QP, slice_bands=2)

    mesh = make_mesh(2, 2)
    enc_m = GopBandEncoder(cfg, n_gop=2, mesh=mesh)
    enc_1 = GopBandEncoder(cfg, n_gop=2, mesh=None)

    stream_m = b""
    recons = []
    for f in frames:
        rm = enc_m.encode_step([f, f], run, return_recon=True)
        r1 = enc_1.encode_step([f, f], run)
        assert rm[0].payload == r1[0].payload
        assert rm[1].payload == r1[1].payload
        stream_m += rm[0].payload
        recons.append(rm[0].recon)

    dec = H264Decoder()
    dec_frames = dec.decode(stream_m)
    assert len(dec_frames) == len(frames)
    for t, df in enumerate(dec_frames):
        for plane_dec, plane_enc in zip(df.cropped(dec.sps), recons[t]):
            assert np.array_equal(np.asarray(plane_dec),
                                  np.asarray(plane_enc))


def test_gop_encoder_rejects_unsupported_configs():
    # (long-term references are supported on the GOP path since round 5 —
    # see test_ltr_frame_types_on_gop_path; denoise remains sequential-only)
    cfg = EncoderConfig(width=W, height=H, gop=3, qp=QP,
                        temporal_denoise_flag=True)
    with pytest.raises(ValueError):
        GopBandEncoder(cfg, n_gop=2)


def test_gop_encoder_vbv_transparent_and_decode():
    """Feature parity with H264Encoder's VBV policies in GOP-parallel
    mode: a tiny VBV forces per-lane transparent (all-skip) frames, the
    lane streams stay decodable, and the decode matches the lane recon."""
    cfg = EncoderConfig(width=64, height=48, gop=0, qp=20,
                        vbv_size_bytes=400,
                        vbv_overflow_empty_frame_flag=True)
    enc = GopBandEncoder(cfg, n_gop=2)
    run = RunConfig(desired_frame_bytes=100, qp_min=20, qp_max=24)
    streams = [b"", b""]
    sizes = [[], []]
    recons = [[], []]
    for (y, u, v) in chessboard_sequence(64, 48, 5):
        for g, r in enumerate(enc.encode_step([(y, u, v)] * 2, run,
                                              return_recon=True)):
            streams[g] += r.payload
            sizes[g].append(len(r.payload))
            recons[g].append(r.recon)
    # tiny VBV must trigger at least one all-skip frame per lane
    assert any(s < 30 for s in sizes[0][1:]), sizes[0]
    assert streams[0] == streams[1]
    dec = H264Decoder()
    frames = dec.decode(streams[0])
    assert len(frames) == 5
    for t, df in enumerate(frames):
        got = df.cropped(dec.sps)
        for pd, pe in zip(got, recons[0][t]):
            assert np.array_equal(np.asarray(pd), np.asarray(pe)), t


def test_ltr_frame_types_on_gop_path():
    """Golden/recovery/droppable long-term-reference streams from the
    GOP-parallel encoder (reference policy `src/h264-lab.h:6734-6754`):
    lanes stay byte-identical, the stream equals the sequential
    encoder's for the same schedule, and the independent decoder
    reproduces the encoder reconstruction bit-exactly."""
    import numpy as np
    from h264lab_tpu.config import EncoderConfig, RunConfig, FrameType
    from h264lab_tpu.models.encoder import H264Encoder
    from h264lab_tpu.parallel.gop import GopBandEncoder
    from h264lab_tpu.decoder.decoder import H264Decoder
    from h264lab_tpu.utils.synthetic import chessboard_sequence

    W, H, QP = 64, 48, 31
    types = [FrameType.KEY, FrameType.P, FrameType.GOLDEN,
             FrameType.DROPPABLE, FrameType.RECOVERY, FrameType.P]
    cfg = EncoderConfig(width=W, height=H, gop=0, qp=QP,
                        max_long_term_reference_frames=2)
    frames = list(chessboard_sequence(W, H, len(types)))

    seq = H264Encoder(cfg)
    seq_stream = b""
    for ft, f in zip(types, frames):
        run = RunConfig(frame_type=ft, qp_min=QP, qp_max=QP,
                        encode_speed=2)
        seq_stream += seq.encode(*f, run).payload

    enc = GopBandEncoder(cfg, n_gop=2)
    streams = [b""] * 2
    recons = []
    for ft, f in zip(types, frames):
        run = RunConfig(frame_type=ft, qp_min=QP, qp_max=QP,
                        encode_speed=2)
        rs = enc.encode_step([f] * 2, run, return_recon=True)
        for g, r in enumerate(rs):
            streams[g] += r.payload
        recons.append(rs[0].recon)

    assert streams[0] == streams[1]
    assert streams[0] == seq_stream
    dec = H264Decoder()
    dfs = dec.decode(streams[0])
    assert len(dfs) == len(types)
    for t, df in enumerate(dfs):
        got = df.cropped(dec.sps)
        for pd, pe in zip(got, recons[t]):
            np.testing.assert_array_equal(np.asarray(pd), np.asarray(pe),
                                          err_msg=f"frame {t}")


def test_band_scaling_sanity():
    """Band decomposition scales the wavefront: more bands => strictly
    shorter per-band scans (the latency the band axis buys on a mesh),
    and a multi-band frame still round-trips bit-exactly."""
    from h264lab_tpu.models import wavefront as wf

    depth1 = wf.make_plan(8, 8, slope=1).steps.shape[0]
    depth2 = wf.make_plan(8, 4, slope=1).steps.shape[0]
    depth4 = wf.make_plan(8, 2, slope=1).steps.shape[0]
    assert depth4 < depth2 < depth1

    from h264lab_tpu.models.encoder import H264Encoder
    from h264lab_tpu.decoder.decoder import H264Decoder

    cfg = EncoderConfig(width=64, height=64, gop=2, qp=30, slice_bands=4)
    enc = H264Encoder(cfg)
    stream = b""
    recons = []
    for (y, u, v) in chessboard_sequence(64, 64, 2):
        r = enc.encode(y, u, v, RunConfig(qp_min=30, qp_max=30,
                                          encode_speed=2),
                       return_recon=True)
        stream += r.payload
        recons.append(r.recon)
    dec = H264Decoder()
    frames = dec.decode(stream)
    assert len(frames) == 2
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(f.cropped(dec.sps)[0], recons[i][0],
                                      err_msg=f"frame {i}")
