"""K4, the port's gather (hypre_tpu_torch/ops/btake.py), against the
reference on the CPU.

On the CPU the wrapper runs its plain version (a masked index_select);
it must equal jnp.take bit for bit, and the reference's Pallas kernel
hypre_tpu.ops.btake (run by the Pallas interpreter, as
tests/test_btake.py runs it) wherever idx >= 0.  Where idx < 0 the
port writes `fill`; the reference leaves junk there, so those slots
are compared only with `fill`.  The kernel itself is checked against
the plain version on the card (tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from hypre_tpu.ops import btake as ref_bt
from hypre_tpu.setup import device_amg as ref_dev
from hypre_tpu_torch import Config, set_config
from hypre_tpu_torch.ops.btake import btake, btake_rows, btake_rows_plain

torch.set_num_threads(1)

DTYPES = {"int32": (np.int32, torch.int32), "float32": (np.float32,
          torch.float32), "float64": (np.float64, torch.float64),
          "bool": (np.bool_, torch.bool)}


@pytest.fixture(autouse=True)
def _cpu():
    set_config(Config(device="cpu"))
    yield


def _index_set(S, n, n_src, seed, banded):
    """idx (S, n) int32 with about 15% holes (-1)."""
    rng = np.random.default_rng(seed)
    if banded:
        center = (np.arange(n) * (n_src / n)).astype(np.int64)
        idx = np.clip(center[None] + rng.integers(-40, 41, (S, n)), 0,
                      n_src - 1)
    else:
        idx = rng.integers(0, n_src, (S, n))
    idx[rng.random((S, n)) < 0.15] = -1
    return idx.astype(np.int32)


def _sources(K, n_src, np_dtype, seed):
    rng = np.random.default_rng(seed)
    if np_dtype == np.bool_:
        return rng.random((K, n_src)) < 0.5
    return (rng.standard_normal((K, n_src)) * 1000).astype(np_dtype)


@pytest.mark.parametrize("banded", [False, True], ids=["random", "banded"])
@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_equals_jnp_take(dtype, K, banded):
    np_dtype, _ = DTYPES[dtype]
    idx = _index_set(5, 700, 300, seed=K, banded=banded)
    X = _sources(K, 300, np_dtype, seed=7)
    fill = -1 if dtype == "int32" else 0
    Y = btake_rows(torch.as_tensor(idx), torch.as_tensor(X), fill).numpy()
    ref = np.asarray(jnp.take(jnp.asarray(X), jnp.asarray(
        np.maximum(idx, 0)), axis=1))
    mask = np.broadcast_to(idx >= 0, Y.shape)
    assert Y.shape == (K, 5, 700) and Y.dtype == X.dtype
    assert np.array_equal(Y[mask], ref[mask])
    assert np.all(Y[~mask] == np.asarray(fill, dtype=X.dtype))


@pytest.mark.parametrize("dtype", ["float64", "int32", "float32"])
def test_plain_equals_reference_kernel_interpreted(monkeypatch, dtype):
    """hypre_tpu's btake kernel under the Pallas interpreter (its plan
    needs a banded index set) against the port's plain version."""
    monkeypatch.setenv("HYPRE_TPU_BTAKE_INTERP", "1")
    np_dtype, _ = DTYPES[dtype]
    idx = _index_set(5, 400, 300, seed=11, banded=True)
    X = _sources(2, 300, np_dtype, seed=3)
    plan = ref_bt.btake_plan(jnp.asarray(idx), 300)
    assert plan is not None
    ref = np.asarray(ref_bt.btake_rows(plan, jnp.asarray(X)))
    Y = btake_rows(torch.as_tensor(idx), torch.as_tensor(X)).numpy()
    mask = np.broadcast_to(idx >= 0, Y.shape)
    assert np.array_equal(Y[mask], ref[mask])
    assert np.all(Y[~mask] == 0)


def test_dell_gather_equals_reference():
    """The 1-D form on a DEll's own index set, against the reference's
    dell_gather_vec (which masks with the same fill)."""
    rng = np.random.default_rng(5)
    A = sp.random(90, 70, density=0.08, random_state=rng, format="csr")
    M = ref_dev.dell_from_scipy(A, np.float64)
    x = rng.standard_normal(70)
    ref = np.asarray(ref_dev.dell_gather_vec(M, jnp.asarray(x), fill=-2.5))
    y = btake(torch.as_tensor(np.array(M.cols)), torch.as_tensor(x),
              fill=-2.5).numpy()
    assert np.array_equal(y, ref)


def test_cpu_call_runs_plain_and_launches_nothing():
    idx = torch.as_tensor(_index_set(3, 50, 40, seed=1, banded=False))
    X = torch.arange(80, dtype=torch.float64).reshape(2, 40)
    before = btake_rows.launches
    assert torch.equal(btake_rows(idx, X, 0), btake_rows_plain(idx, X, 0))
    assert torch.equal(btake(idx, X[1]), btake_rows(idx, X[1:2])[0])
    assert btake_rows.launches == before


def test_row_windows_of_larger_arrays():
    """idx and X may be column windows (row stride > width)."""
    idx_full = torch.as_tensor(_index_set(4, 200, 90, seed=2, banded=True))
    X_full = torch.randn(3, 120, dtype=torch.float64,
                         generator=torch.Generator().manual_seed(0))
    idx, X = idx_full[:, 50:130], X_full[:, :90]
    assert torch.equal(btake_rows(idx, X, 0),
                       btake_rows_plain(idx.contiguous(), X.contiguous(), 0))
