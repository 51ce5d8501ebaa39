"""The 3xTF32 split of kernel K3's tensor-core path in plain PyTorch
(``ops/cuda/pairwise.py``): ``tf32_round`` against a numpy model of
``cvt.rna.tf32.f32``, the reconstruction of x from hi + lo, and the
three-product gram of sigma-0.5 points at d = 100 against the float64 gram,
within ``split_error_bound``."""

import numpy as np
import pytest
import torch

from hyptokenizer_tpu_torch.ops.cuda import pairwise as K3
from tests.torch_port_checks import np_points


def _rna_numpy(x):
    """Round float32 to 11 significant bits, ties away from zero, on the
    magnitude (float64 arithmetic, no bit tricks)."""
    x = np.asarray(x, np.float64)
    out = np.zeros_like(x)
    nz = x != 0
    m, e = np.frexp(np.abs(x[nz]))          # |x| = m 2^e, m in [0.5, 1)
    scaled = m * 2.0 ** 11
    out[nz] = np.sign(x[nz]) * np.floor(scaled + 0.5) * 2.0 ** (e - 11)
    return out.astype(np.float32)


def test_tf32_round_matches_a_model():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(10_000) * 10.0 ** rng.integers(-6, 6, 10_000))
    x = x.astype(np.float32)
    got = K3.tf32_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _rna_numpy(x))
    assert not (got.view(np.int32) & 0x1FFF).any()


@pytest.mark.parametrize("bits,want", [
    (0x3F801000, 0x3F802000),    # a tie rounds away from zero
    (0xBF801000, 0xBF802000),    # on the magnitude, for a negative value
    (0x3F800FFF, 0x3F800000),
    (0x3F801001, 0x3F802000),
    (0x3FFFF000, 0x40000000),    # the carry moves into the exponent
])
def test_tf32_round_ties_away_from_zero(bits, want):
    x = torch.tensor([bits], dtype=torch.int64).to(torch.int32) \
        .view(torch.float32)
    got = K3.tf32_round(x).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    assert int(got) == want


def test_split_reconstructs_within_2_pow_minus_22():
    x = torch.from_numpy(np_points(1, 512, 100, sigma=0.5))
    hi, lo = K3.split_tf32(x)
    assert torch.equal(K3.tf32_round(hi), hi)
    assert torch.equal(K3.tf32_round(lo), lo)
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
    assert float(err.max()) > 0.0        # the split is not exact


def test_split_gram_within_its_bound():
    """The three-product gram of sigma-0.5 points at d = 100 (the
    flagship's rows: x0 about 74, grams of several thousand cancelling to
    a few hundred) against the float64 gram."""
    x = torch.from_numpy(np_points(2, 384, 100, sigma=0.5))
    sig = torch.ones(101, dtype=torch.float64)
    sig[1:] = -1.0
    exact = (x.double() * sig) @ x.double().T
    got = K3.split_gram(x, x)
    bound = K3.split_error_bound(x, x)
    assert bool(((got - exact).abs() <= bound).all())
    # The bound is tight to within a factor of 100 at these shapes, and a
    # gram from hi alone (plain TF32) breaks it.
    assert float(((got - exact).abs() / bound).max()) > 0.01
    hi, _ = K3.split_tf32(x)
    tf32_only = (hi.double() * sig) @ hi.double().T
    assert not bool(((tf32_only - exact).abs() <= bound).all())
