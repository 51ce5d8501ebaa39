"""Checks shared by the port's tests that need no JAX (the card's machine
runs the ``cuda``-marked tests without the JAX package's dependencies).
"""

import numpy as np


def np_points(seed: int, n: int, d: int, sigma: float = 0.6,
              lengths_max: int = 0):
    """``n`` points on the hyperboloid (d+1 coordinates, float32) from a
    numpy seed: tangent Gaussian(0, sigma^2) at the origin, exp-mapped.
    With ``lengths_max``, also (n,) int32 token lengths in [1, lengths_max].
    """
    rng = np.random.default_rng(seed)
    v = sigma * rng.standard_normal((n, d))
    r = np.linalg.norm(v, axis=1, keepdims=True)
    x = np.concatenate([np.cosh(r), np.sinh(r) * v / r], axis=1)
    x = x.astype(np.float32)
    if not lengths_max:
        return x
    return x, rng.integers(1, lengths_max + 1, n).astype(np.int32)


def assert_same_best(emb, c, bd, bj, bd_ref, bj_ref, atol=1e-5):
    """Per-row best candidates agree: distances within ``atol``, partners
    equal except at distance ties within ``atol`` (the rule of
    tests/test_pallas_pairwise.py). Returns the number of tied rows."""
    bd, bj = np.asarray(bd), np.asarray(bj)
    bd_ref, bj_ref = np.asarray(bd_ref), np.asarray(bj_ref)
    np.testing.assert_allclose(bd, bd_ref, atol=atol)
    emb = np.asarray(emb, np.float64)
    sig = np.ones(emb.shape[1])
    sig[1:] = -1.0

    def dist(i, j):
        g = max(float(np.sum(emb[i] * sig * emb[j])), 1.0)
        return np.arccosh(g) / np.sqrt(float(c))

    ties = 0
    for i in np.nonzero(bj != bj_ref)[0]:
        assert np.isfinite(bd_ref[i]), (i, bj[i], bj_ref[i])
        assert abs(dist(i, bj[i]) - dist(i, bj_ref[i])) <= atol, i
        ties += 1
    return ties
