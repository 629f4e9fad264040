"""Device-mesh sharding: data-parallel front end, distributed BA.

The reference is single-process/single-thread (SURVEY.md §2.3); these
components have no reference counterpart and are designed for a mesh of
devices: frames shard across devices for feature detection + matching
(the embarrassingly parallel axis of SfM), and bundle adjustment shards
its observation table with a psum-aggregated Schur reduction.
"""

from sfm_mvs_tpu.parallel import mesh  # noqa: F401
