"""core/ieee.py's sqrt_rn: bit for bit numpy's np.sqrt (IEEE 754, round
to nearest), on the CPU, where torch.sqrt of float64 is not always
correctly rounded."""
import numpy as np
import pytest
import torch

from hypre_tpu_torch.core.ieee import sqrt_rn


def _inputs(kind: str) -> np.ndarray:
    rng = np.random.default_rng(11)
    n = 200_000
    if kind == "uniform":
        return rng.uniform(0.5, 64.0, n)
    if kind == "bits":
        return ((rng.integers(1, 0x7FE, n, dtype=np.int64) << 52)
                | rng.integers(0, 1 << 52, n, dtype=np.int64)).view(np.float64)
    if kind == "squares":
        sq = np.arange(1, n + 1, dtype=np.float64) ** 2
        return np.concatenate([sq, np.nextafter(sq, 0), np.nextafter(sq, 2 * sq)])
    return np.array([0.0, -0.0, np.inf, np.nan, -1.0, 5e-324,
                     2.2250738585072014e-308, 1.7976931348623157e308,
                     1.0, 2.0, 0.25, 3.0])


@pytest.mark.parametrize("kind", ["uniform", "bits", "squares", "special"])
def test_sqrt_rn_matches_numpy(kind):
    d = _inputs(kind)
    with np.errstate(invalid="ignore"):
        want = np.sqrt(d)
    got = sqrt_rn(torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(got, want)


def test_sqrt_rn_other_dtypes_are_torch_sqrt():
    x = torch.linspace(0.5, 9.0, 101, dtype=torch.float32)
    assert torch.equal(sqrt_rn(x), torch.sqrt(x))
