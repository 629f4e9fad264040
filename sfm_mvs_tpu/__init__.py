"""sfm_mvs_tpu — an incremental Structure-from-Motion framework on JAX.

Built from scratch on JAX/XLA, run on an NVIDIA GPU, with the capabilities of the
reference pipeline FlagArihant2000/sfm-mvs (see SURVEY.md): SIFT-style
feature detection, brute-force KNN matching with Lowe-ratio filtering,
essential-matrix RANSAC, SVD pose recovery, PnP camera registration, DLT
triangulation, and sparse-Schur Levenberg-Marquardt bundle adjustment —
all as fixed-capacity, masked, batched, jit-compatible computations.

Subpackages
-----------
ops       Geometry + vision kernels (pure jitted JAX).
models    Pipeline state and drivers (two-view bootstrap, incremental SfM,
          track-based global SfM, bundle adjustment).
parallel  Device-mesh sharding: data-parallel front end, distributed BA.
utils     Host-side IO (images, PLY, pose.csv), config, metrics, synthetic
          scene generation, checkpointing.
"""

__version__ = "0.1.0"

import jax as _jax

# Geometry code needs genuine float32 matmuls. On an NVIDIA GPU the
# default precision runs f32 products in TF32, whose 10-bit mantissa
# corrupts residuals/Jacobians enough to stall bundle adjustment (LM
# plateaus far above a noiseless problem's zero cost, as it did with the
# bf16 pass it was first set against) and skews every pose solve. Code
# that tolerates less can ask for it with a `precision=` argument.
_jax.config.update("jax_default_matmul_precision", "highest")

from sfm_mvs_tpu.utils.config import SfmConfig  # noqa: F401
