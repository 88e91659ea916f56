"""K-means unit assignment and fitting on the device.

Counterpart of `slamkit_tpu/feature_extractor/kmeans.py`: `assign_clusters`
(:21) as one matmul + argmin, argmin_k ||x - c_k||^2 = argmin_k (||c_k||^2 -
2 x.c_k), in float32; `load_kmeans_centroids` (:30) and
`save_kmeans_centroids` (:58); and `kmeans_fit` (:63), Lloyd's algorithm on
the card from the same Forgy start. `.npy` / `.npz` centroids are the rule;
a sklearn / joblib pickle is read only where joblib is installed.
"""
from __future__ import annotations

import contextlib
import warnings
from typing import Union

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import DEFAULT_DEVICE, resolve_device


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


def save_kmeans_centroids(path: str, centroids: np.ndarray):
    np.save(path if path.endswith(".npy") else path + ".npy",
            np.asarray(centroids, dtype=np.float32))


@contextlib.contextmanager
def _full_float32():
    """cuBLAS float32 products without TF32 (JAX's Precision.HIGHEST) for the
    duration, whatever the process has set."""
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32 = before


def kmeans_fit(x: np.ndarray, num_clusters: int, iters: int = 25, seed: int = 0,
               batch: int = 1 << 16,
               device: Union[str, torch.device] = DEFAULT_DEVICE) -> np.ndarray:
    """Lloyd's k-means on `device` (the card unless the caller asks for the
    CPU): centroids [num_clusters, C] float32 from x [N, C]. The start is
    Forgy's, the JAX package's draw (`default_rng(seed).choice(N, K,
    replace=False)`). x streams from the host in `batch` rows a chunk, so it
    may be an np.memmap larger than the card's memory. Each chunk's counts
    and sums are a one-hot product in float32, with no atomics, so a fit
    repeats bit for bit; a cluster that loses every row keeps its centroid."""
    dev = resolve_device(device)
    n, dim = x.shape
    rng = np.random.default_rng(seed)
    start = np.asarray(x[rng.choice(n, num_clusters, replace=False)], dtype=np.float32)
    centroids = torch.from_numpy(start).to(dev)
    staging = torch.empty((min(batch, n), dim), dtype=torch.float32,
                          pin_memory=dev.type == "cuda")
    with _full_float32():
        for _ in range(iters):
            counts = torch.zeros(num_clusters, dtype=torch.float32, device=dev)
            sums = torch.zeros((num_clusters, dim), dtype=torch.float32, device=dev)
            for lo in range(0, n, batch):
                chunk = x[lo:lo + batch]
                host = staging[:len(chunk)]
                with warnings.catch_warnings():     # a read-only memmap is only read
                    warnings.simplefilter("ignore", UserWarning)
                    host.copy_(torch.from_numpy(chunk))
                xb = host.to(dev)
                one_hot = F.one_hot(assign_clusters(xb, centroids), num_clusters).float()
                counts += one_hot.sum(0)
                sums += one_hot.T @ xb
            new_c = sums / torch.clamp(counts[:, None], min=1.0)
            centroids = torch.where(counts[:, None] > 0, new_c, centroids)
    return centroids.cpu().numpy()
