"""Reference-script compatibility layer.

The reference's public API is its three entry-point scripts
(optical_flow.py / optical_PCA.py / optical_PC1.py) and their file
contracts.  These modules expose the same call signatures and
artifacts, backed by the JAX pipeline — including working versions of
the three functions the reference calls but never defines
(estimate_fs_from_time, safe_auc, exp_decay_regression), which makes
the metrics entry point actually runnable.
"""
