"""XLA 2-NN matcher (ops/matching.py) against chip_smoke.py's float64
NumPy brute force, the reference its matcher phase compares with."""

import numpy as np
import pytest

import jax.numpy as jnp

from chip_smoke import reference_match
from sfm_mvs_tpu.ops import matching
from sfm_mvs_tpu.utils.config import FrontendConfig


def _descs(rng, n, d=128):
    x = rng.random((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _case(name, rng):
    """(d0, d1, v0, v1, ratio, run) for one scenario."""
    if name == "reference":
        d0 = _descs(rng, 300)
        d1 = d0[rng.permutation(300)] + 0.01 * rng.standard_normal((300, 128)).astype(np.float32)
        d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
        v0, v1, ratio = np.ones(300, bool), np.ones(300, bool), 0.7
    elif name == "ragged":  # 100 x 600: not a multiple of any tile size
        d0 = _descs(rng, 100)
        d1 = np.vstack([_descs(rng, 500), d0]).astype(np.float32)
        v0, v1, ratio = np.ones(100, bool), np.ones(600, bool), 0.8
    elif name == "masks":  # duplicate train columns masked out
        d0 = _descs(rng, 64)
        d1 = np.vstack([d0[:32], d0[:32]]).astype(np.float32)
        v0, v1, ratio = np.arange(64) < 40, np.arange(64) < 32, 0.7
    elif name == "sparse-masks":  # invalid queries at the end, every 7th column
        d0 = _descs(rng, 200)
        d1 = d0[rng.permutation(200)] + 0.01 * rng.standard_normal((200, 128)).astype(np.float32)
        v0, v1, ratio = np.arange(200) < 180, np.arange(200) % 7 != 0, 0.7
    else:  # "config": the pipeline's entry point with a FrontendConfig
        d0 = _descs(rng, 64)
        d1 = d0 + 0.01 * rng.standard_normal((64, 128)).astype(np.float32)
        v0, v1, ratio = np.ones(64, bool), np.ones(64, bool), 0.8
    cfg = FrontendConfig(lowe_ratio=ratio)

    def run():
        args = (jnp.asarray(d0), jnp.asarray(d1), jnp.asarray(v0), jnp.asarray(v1))
        if name == "config":
            return matching.match_with_config(*args, cfg)
        return matching.knn_match(*args, ratio=ratio)

    return d0, d1, v0, v1, ratio, run


@pytest.mark.parametrize(
    "name", ["reference", "ragged", "masks", "sparse-masks", "config"]
)
def test_knn_match_agrees_with_float64_brute_force(name, rng):
    d0, d1, v0, v1, ratio, run = _case(name, rng)
    m = run()
    idx_ref, valid_ref, margin = reference_match(d0, d1, v0, v1, ratio)
    valid = np.asarray(m.valid)
    np.testing.assert_array_equal(valid, valid_ref)
    np.testing.assert_array_equal(np.asarray(m.idx1)[valid], idx_ref[valid])
    np.testing.assert_array_equal(np.asarray(m.idx0), np.arange(len(d0)))
    if name == "reference":
        assert valid.sum() > 200
    elif name == "ragged":  # exact copies live past the first 500 columns
        assert valid.sum() > 90 and (np.asarray(m.idx1)[valid] >= 500).all()
    elif name == "masks":
        assert not valid[40:].any() and valid[:32].all()
        assert (np.asarray(m.idx1)[:32] == np.arange(32)).all()
    elif name == "sparse-masks":
        assert valid.sum() > 100 and not valid[180:].any()
        assert (margin[valid] > 0).all()
    else:
        assert valid.sum() > 50
