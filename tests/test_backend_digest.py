"""Backend identity and the GPU entry points' guards, checked on the CPU.

- The CIF streams whose sha256 `chip_smoke.py` (phase e) asserts on the
  GPU are pinned here on the CPU (tests/fixtures/backend_digest.json).
- The ME lambda is an integer table, equal to the float formula it
  replaced, so no float sits on the decision path.
- The compilation cache honours JAX_COMPILATION_CACHE_DIR, and otherwise
  lives at <checkout>/.jax_cache.
- The GPU entry points refuse to run on the CPU backend.
"""

import hashlib
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from h264lab_tpu.config import EncoderConfig, RunConfig
from h264lab_tpu.models.encoder import H264Encoder
from h264lab_tpu.ops import me
from h264lab_tpu.utils.synthetic import chessboard_sequence

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("speed", ["0", "2"])
def test_cpu_stream_digest(speed):
    with open(chip_smoke.DIGEST_FIXTURE) as f:
        spec = json.load(f)
    stream = chip_smoke.digest_stream(spec, int(speed))
    assert hashlib.sha256(stream).hexdigest() == spec["sha256"][speed]


def test_lambda_table_matches_formula():
    qp = np.arange(52)
    formula = np.maximum(np.sqrt(0.85 * 2.0 ** ((qp - 12.0) / 3.0)),
                         1.0).astype(np.int32)
    np.testing.assert_array_equal(me.LAMBDA_ME, formula)
    np.testing.assert_array_equal(np.asarray(me.lambda_me(qp)), formula)


def _python(code_or_args, env_update=None, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(env_update or {})
    args = (["-c", code_or_args] if isinstance(code_or_args, str)
            else code_or_args)
    return subprocess.run([sys.executable] + args, cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("from_env", [True, False])
def test_compile_cache_dir(tmp_path, from_env):
    code = ("import h264lab_tpu, jax; "
            "print(jax.config.jax_compilation_cache_dir)")
    if from_env:
        want = str(tmp_path / "cache")
        r = _python(code, {"JAX_COMPILATION_CACHE_DIR": want})
    else:
        want = os.path.join(ROOT, ".jax_cache")
        r = _python(code, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == want


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py",
                                    "tools/profile_stages.py"])
def test_gpu_entry_points_refuse_cpu(script):
    r = _python([script], {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_smoke_decode_check(tmp_path):
    """The smoke's reference comparison passes a bit-exact recon and
    fails a recon that differs in one sample."""
    cfg = EncoderConfig(width=64, height=48, gop=20, qp=30)
    enc = H264Encoder(cfg)
    run = RunConfig(qp_min=30, qp_max=30, encode_speed=2)
    stream, recons = b"", []
    for y, u, v in chessboard_sequence(64, 48, 2):
        res = enc.encode(y, u, v, run, return_recon=True)
        stream += res.payload
        recons.append(res.recon)
    good = tmp_path / "good.pkl"
    good.write_bytes(pickle.dumps((stream, recons)))
    chip_smoke.decode_check(str(good))

    bad_y = np.array(recons[1][0])
    bad_y[0, 0] ^= 1
    recons[1] = (bad_y,) + tuple(recons[1][1:])
    bad = tmp_path / "bad.pkl"
    bad.write_bytes(pickle.dumps((stream, recons)))
    with pytest.raises(SystemExit, match="frame 1 plane y"):
        chip_smoke.decode_check(str(bad))


def test_smoke_symbol_grid_bounds():
    """The packer phase's random grid stays inside the packer's
    structural bounds: <= 640 bits per unit, <= 3200 bits per MB."""
    vals, lens = chip_smoke.random_symbol_grid(
        np.random.default_rng(1), 64, 0.0)
    assert vals.dtype == np.uint32 and lens.shape == vals.shape
    units = lens.reshape(64, 28, -1).sum(axis=-1)
    assert units.max() <= 640
    assert lens.sum(axis=-1).max() <= 3200
    assert lens.max() <= 32
