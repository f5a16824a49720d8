"""Compute primitives.

Each module replaces one of the native C/C++ libraries the reference
pipeline calls into (SURVEY.md §2.3): ``farneback`` ↔ OpenCV's
calcOpticalFlowFarneback, ``cvx`` ↔ OpenCV image ops (cvtColor, resize,
GaussianBlur, magnitude), ``rasterize`` ↔ cv2.fillPoly, ``filters`` ↔
scipy.signal sosfiltfilt / scipy.ndimage uniform_filter1d, ``pca`` ↔
np.linalg.eigh-based sliding PCA, ``peaks`` + ``stats`` ↔ the SciPy
rank/percentile/regression statistics.
"""
