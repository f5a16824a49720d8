"""Multi-chip scaling: meshes, cohort sharding, halo-exchange stencils.

The reference is strictly single-threaded (SURVEY.md §2.6); these are
the capabilities that take the same pipeline across devices:

- ``mesh``   — device mesh construction (data × spatial axes).
- ``cohort`` — whole-recording batches sharded across chips (the
  32-video cohort config of BASELINE.json); XLA inserts the
  collectives for cohort-level reductions.
- ``halo``   — shard_map + ppermute halo exchange for running the
  Farnebäck windowed stencils with the image *height* sharded across
  chips (the tensor/sequence-parallel analogue for vision stencils).
"""
