"""Geometry and vision kernels: pure jitted JAX + Pallas.

Every kernel here is the JAX replacement for a native (C++) OpenCV /
SciPy routine the reference delegates to (SURVEY.md §2.2). All functions are
jit-compatible: static shapes, masked validity, no data-dependent Python
control flow.
"""

from sfm_mvs_tpu.ops import lie  # noqa: F401
from sfm_mvs_tpu.ops import projection  # noqa: F401
from sfm_mvs_tpu.ops import triangulation  # noqa: F401
from sfm_mvs_tpu.ops import epipolar  # noqa: F401
