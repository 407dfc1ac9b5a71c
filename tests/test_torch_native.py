"""gsjax_torch.native (the port's simple-knn KD-tree) against gsjax.native on
the CPU: the same tree, heap and float32 sum, so the results are equal bit
for bit, on clouds of k points or fewer too (where scipy's query pads with
inf); the initial state of such clouds; and a build that cannot happen
raises (there is no fallback)."""

import numpy as np
import pytest


def _clouds():
    rng = np.random.default_rng(0)
    for n in (1, 2, 3, 4, 500, 5000):
        yield f"n{n}", rng.normal(size=(n, 3)).astype(np.float32)
    # ties: every point three times, and a lattice of equal distances
    yield "dup", np.repeat(rng.normal(size=(200, 3)).astype(np.float32), 3, axis=0)
    g = np.arange(6, dtype=np.float32)
    yield "lattice", np.stack(np.meshgrid(g, g, g), -1).reshape(-1, 3)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_knn_equals_gsjax_native_bit_for_bit(k):
    from gsjax.native import knn_mean_sq_dist as j_knn
    from gsjax_torch.native import knn_mean_sq_dist

    for name, pts in _clouds():
        got, want = knn_mean_sq_dist(pts, k), j_knn(pts, k)
        assert got.dtype == np.float32 and got.shape == (len(pts),)
        assert np.isfinite(got).all(), name
        np.testing.assert_array_equal(got, want, err_msg=f"{name} k={k}")
    assert knn_mean_sq_dist(np.zeros((1, 3), np.float32), k).tolist() == [0.0]
    assert knn_mean_sq_dist(np.array([[0, 0, 0], [1, 2, 2]], np.float32), k).tolist() == [9, 9]
    for bad, pts in ((0, np.zeros((4, 3), np.float32)), (k, np.zeros((4, 2), np.float32))):
        with pytest.raises(ValueError):
            knn_mean_sq_dist(pts, bad)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_create_from_pcd_of_tiny_clouds_equals_gsjax(n):
    """min(k, n - 1) neighbours: finite log-scales, equal to gsjax's leaf
    for leaf (a scipy query for k + 1 neighbours pads with inf here)."""
    from gsjax.models.gaussians import create_from_pcd as j_create
    from gsjax_torch.models.gaussians import create_from_pcd

    rng = np.random.default_rng(n)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    got, want = create_from_pcd(pts, cols, 1.5, device="cpu"), j_create(pts, cols, 1.5)
    assert got.capacity == want.capacity
    for k, v in want.params.items():
        a = got.params[k].numpy()
        assert np.isfinite(a).all(), k
        np.testing.assert_array_equal(a, np.asarray(v), err_msg=k)
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))


@pytest.mark.parametrize("cxx", ["/nonexistent/g++", "false"], ids=["missing", "failing"])
def test_a_build_that_cannot_happen_raises(monkeypatch, cxx):
    """A compiler that is missing, or a build that fails, raises with what
    the compiler said; no other search stands in."""
    from gsjax_torch import native
    from gsjax_torch.models.gaussians import create_from_pcd, knn_mean_sq_dist

    monkeypatch.setenv("CXX", cxx)
    pts = np.random.default_rng(0).normal(size=(10, 3)).astype(np.float32)
    with pytest.raises(RuntimeError, match="not found" if cxx.startswith("/") else "failed"):
        knn_mean_sq_dist(pts)
    with pytest.raises(RuntimeError):
        create_from_pcd(pts, np.zeros_like(pts), 1.0, device="cpu")
    assert cxx not in native._libs
