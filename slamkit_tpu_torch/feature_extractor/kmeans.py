"""K-means unit assignment on the device.

Counterpart of `slamkit_tpu/feature_extractor/kmeans.py`: `assign_clusters`
(:21) as one matmul + argmin, argmin_k ||x - c_k||^2 = argmin_k (||c_k||^2 -
2 x.c_k), in float32, and `load_kmeans_centroids` (:30). `.npy` / `.npz`
centroids are the rule; a sklearn / joblib pickle is read only where joblib
is installed. Fitting (`kmeans_fit`) is not ported.
"""
from __future__ import annotations

import numpy as np
import torch


def assign_clusters(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """x [..., C] float32; centroids [K, C] float32 -> unit ids [...] int64."""
    c = centroids.float()
    c_sq = (c * c).sum(-1)
    return torch.argmin(c_sq - 2.0 * (x.float() @ c.T), dim=-1)


def load_kmeans_centroids(path: str) -> np.ndarray:
    """Centroids [K, C] float32 from `.npy`, `.npz` (key `centroids` or the
    first array), or a joblib / sklearn pickle (needs joblib)."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    if path.endswith(".npz"):
        with np.load(path) as z:
            key = "centroids" if "centroids" in z.files else z.files[0]
            return z[key].astype(np.float32)
    try:
        import joblib
    except ImportError as e:
        raise RuntimeError(
            f"{path} is not .npy/.npz; reading a sklearn / joblib k-means pickle needs "
            f"joblib (and sklearn), which this environment lacks: save its "
            f"cluster_centers_ with np.save and pass the .npy") from e
    obj = joblib.load(path)
    if hasattr(obj, "cluster_centers_"):
        return np.asarray(obj.cluster_centers_, dtype=np.float32)
    if isinstance(obj, np.ndarray):
        return obj.astype(np.float32)
    raise ValueError(f"Unrecognized k-means checkpoint format: {path} ({type(obj)})")
