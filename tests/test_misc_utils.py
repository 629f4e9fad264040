"""Coverage for profiling + multihost helper modules."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sfm_mvs_tpu.parallel import multihost
from sfm_mvs_tpu.utils import profiling


def test_multihost_initialize_noop_single_host():
    assert multihost.initialize() is False  # no coordinator configured


def test_slice_mesh_single_process():
    mesh = multihost.slice_mesh()
    assert mesh.axis_names == ("dcn", "ici")
    assert mesh.devices.shape[0] == 1  # one process
    sh = multihost.ba_shardings(mesh)
    assert "points" in sh and "cameras" in sh


def test_roofline_record():
    r = profiling.Roofline("NVIDIA H100 80GB HBM3")
    row = r.record("matmul", seconds=0.001, flops=1e9, bytes_=1e6)
    assert abs(row["achieved_tflops"] - 1.0) < 1e-9
    assert 0 < row["f32_fraction"] < 1
    assert 0 < row["hbm_fraction"] < 1
    row2 = r.time_and_record(
        "add", lambda x: x + 1, jnp.ones(128), flops=128, iters=2
    )
    assert row2["ms"] > 0


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", ""])
def test_roofline_unknown_device_kind_raises(kind):
    with pytest.raises(KeyError):
        profiling.Roofline(kind)


def test_trace_annotation_contexts(tmp_path):
    with profiling.annotate("region"):
        jnp.sum(jnp.ones(8)).block_until_ready()
    # full trace capture (writes files)
    with profiling.trace(str(tmp_path / "tr")):
        jnp.sum(jnp.ones(8)).block_until_ready()
    assert (tmp_path / "tr").exists()
