"""The port's `kmeans_fit` against the JAX package's, on the cases of
`tests/test_hubert.py` (three separated blobs for 10 iterations; 5
iterations in one batch and in batches of 64 rows) and on a wider set of
clusters: centroids within 1e-5 (both sum in float32, in other orders). An
np.memmap input fits to the same centroids bit for bit as the array in RAM;
TF32 is off during a fit, whatever the process set, and restored after it;
without a card the default device raises.
"""
import numpy as np
import pytest
import torch

from slamkit_tpu.feature_extractor.kmeans import kmeans_fit as jax_kmeans_fit
from slamkit_tpu_torch.feature_extractor import kmeans
from slamkit_tpu_torch.feature_extractor.kmeans import (assign_clusters, kmeans_fit,
                                                        load_kmeans_centroids,
                                                        save_kmeans_centroids)

torch.set_num_threads(1)


def _blobs(n, spread, dim=4, k=3, seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.standard_normal((n, dim)) + spread * i
                           for i in range(k)]).astype(np.float32)


@pytest.mark.parametrize("x,k,iters,batch", [
    (_blobs(100, 8), 3, 10, 1 << 16),          # test_kmeans_fit_converges
    (_blobs(60, 10), 3, 5, 1 << 16),           # test_kmeans_fit_batched_matches_full, full
    (_blobs(60, 10), 3, 5, 64),                # ... and chunked
    (_blobs(50, 6, dim=16, k=12, seed=3), 10, 8, 96),
], ids=["converges", "full", "chunked", "wide"])
def test_kmeans_fit_equals_jax(x, k, iters, batch):
    got = kmeans_fit(x, k, iters=iters, seed=0, batch=batch, device="cpu")
    want = jax_kmeans_fit(x, k, iters=iters, seed=0, batch=batch)
    assert got.shape == (k, x.shape[1]) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    ids = assign_clusters(torch.from_numpy(x), torch.from_numpy(got)).numpy()
    if k == 3:                                 # every blob maps to one cluster of its own
        assert len(np.unique(ids)) == 3
        for i in range(3):
            assert len(np.unique(ids[i * (len(x) // 3):(i + 1) * (len(x) // 3)])) == 1


def test_kmeans_fit_streams_a_memmap(tmp_path):
    x = _blobs(80, 5, dim=8, k=5, seed=1)
    mm = np.memmap(tmp_path / "x.f32", dtype=np.float32, mode="w+", shape=x.shape)
    mm[:] = x
    mm.flush()
    ro = np.memmap(tmp_path / "x.f32", dtype=np.float32, mode="r", shape=x.shape)
    got = kmeans_fit(ro, 5, iters=4, batch=37, device="cpu")
    np.testing.assert_array_equal(got, kmeans_fit(x, 5, iters=4, batch=37, device="cpu"))
    save_kmeans_centroids(str(tmp_path / "km"), got)
    np.testing.assert_array_equal(load_kmeans_centroids(str(tmp_path / "km.npy")), got)


def test_kmeans_fit_turns_tf32_off_and_restores_it(monkeypatch):
    seen = []
    real = kmeans.assign_clusters

    def spy(x, c):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(x, c)

    monkeypatch.setattr(kmeans, "assign_clusters", spy)
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        kmeans_fit(_blobs(20, 8), 3, iters=2, device="cpu")
        assert seen == [False, False] and torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def test_kmeans_fit_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        kmeans_fit(_blobs(20, 8), 3, iters=1)
