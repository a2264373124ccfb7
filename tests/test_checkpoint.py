"""Checkpoint/resume: the encoder's full mutable state is a serializable
snapshot (the batched analog of the reference's relocatable flat
arenas, SURVEY.md §5.4). Resuming from a snapshot must continue the
stream bit-exactly."""

import pickle

import numpy as np

from h264lab_tpu.config import EncoderConfig, RunConfig
from h264lab_tpu.models.encoder import H264Encoder
from h264lab_tpu.utils.synthetic import chessboard_sequence

W, H, QP = 64, 48, 30


def test_resume_bit_exact():
    frames = list(chessboard_sequence(W, H, 7))
    run = RunConfig(qp_min=QP, qp_max=QP)
    cfg = EncoderConfig(width=W, height=H, gop=4, qp=QP)

    # straight-through encode
    enc_a = H264Encoder(cfg)
    tail_a = b""
    for i, (y, u, v) in enumerate(frames):
        payload = enc_a.encode(y, u, v, run).payload
        if i >= 3:
            tail_a += payload
        if i == 2:
            snap = pickle.dumps(enc_a.get_state())

    # resume in a brand-new encoder instance from the pickled snapshot
    enc_b = H264Encoder(cfg)
    enc_b.set_state(pickle.loads(snap))
    tail_b = b""
    for (y, u, v) in frames[3:]:
        tail_b += enc_b.encode(y, u, v, run).payload

    assert tail_a == tail_b


def test_vbv_state_roundtrip():
    from h264lab_tpu.rc.ratecontrol import RateControl
    rc = RateControl(n_mb=12, gop=4, vbv_size_bytes=10000, initial_qp=30)
    rc.frame_start(True, 800, 10, 51)
    rc.frame_end(True, 900, 800)
    st = rc.get_state()
    rc2 = RateControl(n_mb=12, gop=4, vbv_size_bytes=10000, initial_qp=30)
    rc2.set_state(st)
    q1 = rc.frame_start(False, 800, 10, 51)
    q2 = rc2.frame_start(False, 800, 10, 51)
    assert q1 == q2
    assert rc.vbv.fullness == rc2.vbv.fullness
