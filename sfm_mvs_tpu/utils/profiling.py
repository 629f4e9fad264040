"""Profiling hooks: jax.profiler traces + simple roofline accounting.

The reference's only observability is a tqdm bar (sfm.py:341; SURVEY.md
§5). Here any pipeline section can be wrapped in a Perfetto/XProf trace
for kernel-level analysis, and hot kernels can be summarized against the
device's peak numbers.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

# Per-device peaks keyed by JAX's `device_kind`, dense (no sparsity):
# NVIDIA H100 SXM data sheet. "f32_tflops" is float32 outside the tensor
# cores, the rate that matmuls at "highest" precision get.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_tflops": 989.0, "tf32_tflops": 495.0, "f32_tflops": 67.0,
        "hbm_gbps": 3350.0,
    },
}


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/sfm_trace") -> Iterator[None]:
    """Capture a jax.profiler trace around a pipeline section.

    View with XProf/TensorBoard or convert to Perfetto. Usage:

        with profiling.trace("/tmp/trace"):
            pipeline.run(...)
    """
    import jax

    os.makedirs(log_dir, exist_ok=True)
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside a trace (shows up per-frame in the timeline)."""
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield


class Roofline:
    """Accumulate (flops, bytes, seconds) per kernel and report ratios.

    device_kind: a key of PEAKS (`jax.devices()[0].device_kind`); a
    device with no published peaks raises instead of borrowing another's.
    """

    def __init__(self, device_kind: str):
        if device_kind not in PEAKS:
            raise KeyError(f"no peak rates for device kind {device_kind!r}")
        self.chip = PEAKS[device_kind]
        self.rows: list[dict] = []

    def record(self, name: str, seconds: float, flops: float = 0.0, bytes_: float = 0.0):
        row = {"name": name, "ms": seconds * 1e3}
        if flops:
            row["achieved_tflops"] = flops / seconds / 1e12
            row["f32_fraction"] = row["achieved_tflops"] / self.chip["f32_tflops"]
        if bytes_:
            row["achieved_gbps"] = bytes_ / seconds / 1e9
            row["hbm_fraction"] = row["achieved_gbps"] / self.chip["hbm_gbps"]
        self.rows.append(row)
        return row

    def time_and_record(self, name: str, fn, *args, flops=0.0, bytes_=0.0, iters=10):
        import jax

        jax.block_until_ready(fn(*args))
        t0 = time.time()
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        return self.record(name, (time.time() - t0) / iters, flops, bytes_)
