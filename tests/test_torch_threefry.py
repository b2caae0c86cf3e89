"""core/threefry.py draws JAX's default uniform numbers bit for bit:
jax.random.uniform(jax.random.PRNGKey(7919), (n,), dtype), the start
vector of the device Chebyshev setup, for f32 and f64 and for lengths
that cross the cipher's word and block boundaries; and another seed, to
exercise the key schedule."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypre_tpu_torch.core.threefry import uniform


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [1, 5, 4097, 125000])
def test_uniform_matches_jax(n, dtype):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(7919), (n,),
                                         getattr(jnp, dtype)))
    got = uniform(7919, n, getattr(torch, dtype)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def test_uniform_other_seed_matches_jax():
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(2**33 + 5),
                                         (777,), jnp.float64))
    np.testing.assert_array_equal(uniform(2**33 + 5, 777).numpy(), want)
