"""desired_nalu_bytes: hard NALU-size enforcement.

The reference starts a new slice whenever the current NALU exceeds the
target (`src/h264-lab.h:6418-6424`). This encoder plans the slice
count from the previous frame's size and *enforces* the bound in
finish(): an oversized NALU rolls the frame back and re-encodes with
more slices — so even a scene cut (which any prediction-based plan
mispredicts) cannot emit an oversized NALU.
"""

import numpy as np

from h264lab_tpu.config import EncoderConfig, RunConfig
from h264lab_tpu.models.encoder import H264Encoder
from h264lab_tpu.bitstream.nal import split_annexb
from h264lab_tpu.utils.synthetic import chessboard_sequence


def test_nalu_size_enforced_on_scene_cut():
    W, H, QP = 96, 96, 30
    target = 1200
    cfg = EncoderConfig(width=W, height=H, gop=10, qp=QP,
                        desired_nalu_bytes=target)
    enc = H264Encoder(cfg)
    run = RunConfig(qp_min=QP, qp_max=QP, encode_speed=2)

    frames = list(chessboard_sequence(W, H, 2))
    rng = np.random.default_rng(11)
    cut = (rng.integers(0, 256, (H, W), np.uint8),
           np.full((H // 2, W // 2), 128, np.uint8),
           np.full((H // 2, W // 2), 128, np.uint8))
    seq = [frames[0], frames[1], cut]      # frame 2 is the scene cut

    stream = b""
    recons = []
    for (y, u, v) in seq:
        r = enc.encode(y, u, v, run, return_recon=True)
        stream += r.payload
        recons.append(r.recon)
    slice_sizes = [len(n) + 4 for n in split_annexb(stream)
                   if (n[0] & 0x1F) in (1, 5)]
    assert len(slice_sizes) > 3, "scene cut did not force extra slices"
    for s in slice_sizes:
        assert s <= target, f"NALU of {s} bytes exceeds target {target}"

    # the re-encoded stream still decodes bit-exactly
    from h264lab_tpu.decoder.decoder import H264Decoder
    dec = H264Decoder()
    dfs = dec.decode(stream)
    assert len(dfs) == 3
    for i, f in enumerate(dfs):
        np.testing.assert_array_equal(f.cropped(dec.sps)[0], recons[i][0],
                                      err_msg=f"frame {i}")
