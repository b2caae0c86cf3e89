"""Shared helpers of the tests of the PyTorch port (tests/test_torch_*.py).

The port imports nothing of hypre_tpu, so a reference object crosses
over as numpy arrays: ``op_dict`` turns a hypre_tpu solve-format
operator into the dict that hypre_tpu_torch.convert takes, and
``hierarchy_dicts`` does so for a whole hypre_tpu AmgHierarchy (its
exact-GS factors through ``trisolve_dict``).  For the
device setup, ``dell_to_port`` carries a reference DEll across,
``stage_operators`` gives the stage tests' operators,
``check_extpi_equal`` holds one ext+i stage against the reference's and
``ref_device_hierarchy`` chains the reference's stage functions into a
whole hierarchy.  ``edge_csr`` builds the row-length patterns that K2's
row blocks must handle.  For the AMG breadth tests, ``coupled_system``
builds a systems problem, ``check_host_hierarchy`` holds the port's
host hierarchy against the reference's and ``amg_pair`` sets up both
packages' BoomerAMG on one Laplacian.  For the struct tests,
``struct_to_port`` carries a reference StructMatrix across,
``assert_struct_level_equal`` holds a struct level bit for bit and
``assert_rel_close`` bounds the largest difference by the reference's
largest entry.  For the distributed layer, ``mesh8`` is the reference's
8-device CPU mesh, ``part_dict``/``comm_dict``/``parcsr_dict`` carry a
reference partition, CommPkg and ParCSR across, ``par_golden`` reads
tests/golden/par_reference.npz, ``ref_shard_matvec`` runs the
reference's par_matvec or par_stencil_matvec in its shard_map, and
``gloo_worker`` is one rank of the torch.distributed (gloo) test.
Reference modules are imported
inside the functions: this module is imported by every port test.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

LAPLACE_7PT = [((0, 0, 0), 6.0), ((-1, 0, 0), -1.0), ((1, 0, 0), -1.0),
               ((0, -1, 0), -1.0), ((0, 1, 0), -1.0),
               ((0, 0, -1), -1.0), ((0, 0, 1), -1.0)]
LAPLACE_27PT = [((dx, dy, dz), 26.0 if dx == dy == dz == 0 else -1.0)
                for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                for dx in (-1, 0, 1)]
# reach 2 (K1's row instance): a 13-pt star
STAR_13PT = [((0, 0, 0), 12.0)] + [
    (tuple(s * r if a == ax else 0 for a in range(3)), -1.0 / r)
    for ax in range(3) for r in (1, 2) for s in (-1, 1)]
# reach 1 with arms missing, in no canonical order (K1's tile instance)
SPARSE_ARMS = [((0, 0, 1), -0.5), ((0, 0, 0), 4.0), ((-1, 1, -1), -0.25),
               ((1, 0, 0), -1.0), ((0, -1, 0), -1.5)]
NATIVE_ENV = ("HYPRE_TPU_NATIVE_SETUP", "HYPRE_TPU_TORCH_NATIVE_SETUP")


def set_native(monkeypatch, on: bool) -> None:
    """Turn the OpenMP setup kernels on or off in both packages."""
    for var in NATIVE_ENV:
        monkeypatch.setenv(var, "1" if on else "0")


def op_dict(op) -> dict:
    name = type(op).__name__
    if name == "StencilOp":
        return {"kind": "stencil", "grid": op.grid, "entries": op.entries}
    if name == "GstEllMatrix":
        return {"kind": "gstell", "base": np.asarray(op.base),
                "locs": np.asarray(op.locs), "vals": np.asarray(op.vals),
                "n_rows": op.n_rows, "n_cols": op.n_cols}
    if name == "EllMatrix":
        return {"kind": "ell", "cols": np.asarray(op.cols),
                "vals": np.asarray(op.vals), "n_cols": op.n_cols}
    if name == "DiaMatrix":
        return {"kind": "dia", "offsets": op.offsets,
                "vals": np.asarray(op.vals), "n_cols": op.n_cols}
    if name == "DenseMatrix":
        return {"kind": "dense", "vals": np.asarray(op.vals),
                "n_rows": op.n_rows, "n_cols": op.n_cols}
    raise TypeError(name)


def trisolve_dict(wf) -> dict | None:
    """A hypre_tpu WavefrontTriSolve as convert's dict."""
    if wf is None:
        return None
    return {"perm": np.asarray(wf.perm), "inv_perm": np.asarray(wf.inv_perm),
            "dinv_p": np.asarray(wf.dinv_p),
            "cols": [None if c is None else np.asarray(c) for c in wf.cols],
            "vals": [None if v is None else np.asarray(v) for v in wf.vals],
            "block_bounds": wf.block_bounds}


def hierarchy_dicts(h) -> list[dict]:
    """The levels of a hypre_tpu AmgHierarchy as convert's dicts,
    exact-GS factors included."""
    def arr(a):
        return None if a is None else np.asarray(a)

    out = []
    for lvl in h.levels:
        out.append({
            "A": op_dict(lvl.A),
            "P": None if lvl.P is None else op_dict(lvl.P),
            "R": None if lvl.R is None else op_dict(lvl.R),
            "dinv": arr(lvl.dinv), "gs_lo": arr(lvl.gs_lo),
            "gs_up": arr(lvl.gs_up), "gs_wf_lo": trisolve_dict(lvl.gs_wf_lo),
            "gs_wf_up": trisolve_dict(lvl.gs_wf_up)})
    return out


def assert_csr_equal(a, b) -> None:
    """Bit-for-bit equality of two scipy CSR matrices."""
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


def rel_diff(x, y) -> float:
    x, y = np.asarray(x), np.asarray(y)
    return float(np.linalg.norm(x - y) / np.linalg.norm(y))


def dell_to_port(M):
    """A reference device-setup DEll as the port's (the same slots)."""
    from hypre_tpu_torch.convert import dell_from_numpy

    return dell_from_numpy(np.array(M.cols), np.array(M.vals), M.n_cols)


def assert_ops_close(a, b, tol: float = 1e-12) -> None:
    """Two scipy operators within tol of the first one's largest entry."""
    assert a.shape == b.shape
    scale = max(abs(a).max() if a.nnz else 0.0, 1e-300)
    diff = abs(a - b)
    assert (diff.max() if diff.nnz else 0.0) <= tol * scale


def rand_csr(n, m, density, seed, spd=False):
    rng = np.random.default_rng(seed)
    A = sp.random(n, m, density=density, random_state=rng, format="csr")
    if spd:
        A = (-(A + A.T) + sp.eye(n) * 2.0 * n * density * 2).tocsr()
    A.sort_indices()
    return A


EDGE_CSR = ("empty_rows", "long_row", "long_next_to_short", "one_row",
            "no_rows", "all_empty")


def edge_csr(name: str, seed: int = 0, long_len: int = 100_003):
    """A scipy CSR matrix with one of K2's edge patterns of row lengths:
    runs of empty rows among short ones; one row of ``long_len``
    nonzeros among short rows; rows of 1 to 3 budgets' length beside
    1-entry rows; a single row; no rows; rows that are all empty."""
    rng = np.random.default_rng(seed)
    n_cols = max(long_len, 8000) + 17
    if name == "empty_rows":
        lens = rng.integers(0, 9, 3001) * (rng.random(3001) < 0.6)
    elif name == "long_row":
        lens = rng.integers(1, 6, 2001)
        lens[977] = long_len
    elif name == "long_next_to_short":
        lens = np.ones(1200, dtype=np.int64)
        lens[::97] = rng.integers(2049, 3 * 2048 + 5, len(lens[::97]))
        lens[5::31] = rng.integers(900, 1100, len(lens[5::31]))
    elif name == "one_row":
        lens = np.array([4099])
    elif name == "no_rows":
        lens = np.zeros(0, dtype=np.int64)
    elif name == "all_empty":
        lens = np.zeros(777, dtype=np.int64)
    else:
        raise ValueError(name)
    rows = [np.sort(rng.choice(n_cols, int(k), replace=False)) if k > 64
            else np.unique(rng.integers(0, n_cols, int(k))) for k in lens]
    lens = np.array([len(r) for r in rows], dtype=np.int64)
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    indices = np.concatenate(rows or [np.zeros(0, dtype=np.int64)]).astype(
        np.int32)
    data = rng.standard_normal(len(indices))
    return sp.csr_matrix((data, indices, indptr), shape=(len(lens), n_cols))


STAGE_STENCILS = ("lap7", "lap27")
STAGE_MATRICES = ("difconv", "rand_spd")


def stage_operators(names=STAGE_STENCILS + STAGE_MATRICES) -> dict:
    """Reference DEll operators of the stage tests: stencils (the
    reference keeps their arm structure) and matrices that are no
    stencil."""
    import jax.numpy as jnp

    from hypre_tpu.gen.laplace import difconv
    from hypre_tpu.setup import device_amg as ref

    make = {
        "lap7": lambda: ref.dell_stencil((7, 6, 5), LAPLACE_7PT,
                                         dtype=jnp.float64),
        "lap27": lambda: ref.dell_stencil((6, 5, 4), LAPLACE_27PT,
                                          dtype=jnp.float64),
        "difconv": lambda: ref.dell_from_scipy(
            difconv(5, 5, 5, ax=1.1).tocsr(), np.float64),
        "rand_spd": lambda: ref.dell_from_scipy(
            rand_csr(80, 80, 0.06, 3, True), np.float64),
    }
    return {name: make[name]() for name in names}


def check_extpi_equal(M, max_elmts: int) -> None:
    """ext+i interpolation of the port against hypre_tpu's on one
    reference operator: the same strong mask and CF go into both; P
    within 1e-12 of its largest entry.  max_elmts=4 keeps the largest
    entries of each row; a 27-pt row holds many ties, so this holds only
    if the values before the truncation agree to the last bit."""
    import jax.numpy as jnp
    import torch

    from hypre_tpu.setup import device_amg as ref
    from hypre_tpu_torch.setup import device_amg as dev

    strong = ref.device_strength(M, 0.25, 0.9)
    cf = ref.device_pmis(M, strong, seed=2747)
    nc = int(jnp.sum(cf == ref.C_PT))
    P_ref = ref.device_extpi_interp(M, strong, cf, n_coarse=nc,
                                    trunc_factor=0.0, max_elmts=max_elmts,
                                    chunk=128)
    P = dev.device_extpi_interp(
        dell_to_port(M), torch.as_tensor(np.array(strong)),
        torch.as_tensor(np.array(cf)), n_coarse=nc, trunc_factor=0.0,
        max_elmts=max_elmts, chunk=53)
    assert_ops_close(ref.dell_to_scipy(P_ref), dev.dell_to_scipy(P))


def ref_device_hierarchy(shape, entries, chunk: int = 128):
    """hypre_tpu's device hierarchy of a stencil problem (interp 6,
    relax 18), chained from its stage functions the way its
    iter_device_hierarchy does (hypre_tpu/setup/device_amg.py:949-990):
    device_strength, device_pmis, device_extpi_interp, dell_pad_width,
    and the RAP of device_rap's CPU branch (SpGEMM widths and products,
    device_transpose).  Explicit small chunks: the reference's own
    choices pad even tiny levels to 262,144 lanes and take minutes here.

    Returns (levels, coarsest): each level (A, P, R as scipy, cf as
    numpy, A's valid-slot count), and (coarsest A, its count)."""
    import jax.numpy as jnp

    from hypre_tpu.setup import device_amg as ref
    from hypre_tpu.solvers.amg import AmgConfig

    cfg = AmgConfig(interp_type=6, relax_type=18)
    levels = []
    Al = ref.dell_stencil(shape, entries, dtype=jnp.float64)
    for _ in range(cfg.max_levels - 1):
        n = Al.n_rows
        if n <= cfg.max_coarse_size:
            break
        strong = ref.device_strength(Al, cfg.strong_threshold,
                                     cfg.max_row_sum)
        cf = ref.device_pmis(Al, strong, seed=cfg.seed)
        n_coarse = int(jnp.sum(cf == ref.C_PT))
        if n_coarse == 0 or n_coarse == n:
            break
        P = ref.dell_pad_width(ref.device_extpi_interp(
            Al, strong, cf, n_coarse=n_coarse,
            trunc_factor=cfg.trunc_factor, max_elmts=cfg.p_max_elmts,
            chunk=chunk))
        AP = ref.device_spgemm(Al, P, ref.device_spgemm_width(Al, P, chunk),
                               chunk)
        PT = ref.dell_pad_width(ref.device_transpose(
            P, ref.device_transpose_width(P)))
        Ac = ref.device_spgemm(PT, AP,
                               ref.device_spgemm_width(PT, AP, chunk), chunk)
        levels.append((ref.dell_to_scipy(Al), ref.dell_to_scipy(P),
                       ref.dell_to_scipy(PT), np.asarray(cf),
                       int(jnp.sum(Al.mask))))
        Al = ref.dell_pad_width(Ac)
    return levels, (ref.dell_to_scipy(Al), int(jnp.sum(Al.mask)))


def port_device_hierarchy(shape, entries):
    """The port's device hierarchy of the same problem on the CPU:
    (iter_device_hierarchy's items, the BoomerAMG of setup_device)."""
    from hypre_tpu_torch import Config, set_config
    from hypre_tpu_torch.setup import device_amg as dev
    from hypre_tpu_torch.solvers import AmgConfig, BoomerAMG

    set_config(Config(device="cpu"))
    cfg = AmgConfig(interp_type=6, relax_type=18)
    items = list(dev.iter_device_hierarchy(dev.dell_stencil(shape, entries),
                                           cfg))
    return items, BoomerAMG(cfg).setup_device(stencil=(shape, entries))


HIERARCHY_CHECKS = ("level_sizes", "cf_bitwise", "A", "P", "R",
                    "coarsest", "setup_device")


def check_device_hierarchy(ref_side, items, amg, which: str) -> None:
    """One check of the port's hierarchy against the reference's: level
    sizes; CF bit for bit; A, P or R within 1e-12 at every level; the
    coarsest A; setup_device's sizes, nonzeros (valid slots) and
    operator complexity."""
    from hypre_tpu_torch.setup.device_amg import dell_to_scipy

    levels, coarsest = ref_side
    sizes = [lv[0].shape[0] for lv in levels] + [coarsest[0].shape[0]]
    if which == "level_sizes":
        assert len(levels) >= 2
        assert [it[0].n_rows for it in items[:-1]] + [items[-1].n_rows] \
            == sizes
    elif which == "cf_bitwise":
        for lv, it in zip(levels, items[:-1]):
            assert np.array_equal(it[3].numpy(), lv[3])
    elif which in ("A", "P", "R"):
        k = "APR".index(which)
        for lv, it in zip(levels, items[:-1]):
            assert_ops_close(lv[k], dell_to_scipy(it[k]))
    elif which == "coarsest":
        assert_ops_close(coarsest[0], dell_to_scipy(items[-1]))
    else:
        nnz = [lv[4] for lv in levels] + [coarsest[1]]
        assert amg.level_sizes == sizes and amg.level_nnz == nnz
        assert amg.operator_complexity == sum(nnz) / nnz[0]
        assert len(amg.setup_stats) == len(levels)


def coupled_system(n, nf=2, eps=0.1):
    """nf coupled 2-D Laplacians on an n x n grid, interleaved (dof i =
    node i//nf, function i%nf): block diagonal plus a small symmetric
    cross coupling on each node, the systems problem of
    tests/test_systems.py."""
    from hypre_tpu_torch.gen import laplacian

    L = laplacian(n, n, 1).tocoo()
    nn = L.shape[0]
    rows = [L.row * nf + f for f in range(nf)]
    cols = [L.col * nf + f for f in range(nf)]
    vals = [L.data for _ in range(nf)]
    for f in range(nf):
        for g in range(nf):
            if f != g:
                rows.append(np.arange(nn) * nf + f)
                cols.append(np.arange(nn) * nf + g)
                vals.append(np.full(nn, eps))
    A = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(nn * nf, nn * nf))
    A.sum_duplicates()
    return A


def check_host_hierarchy(A, tol: float = 0.0, **kw) -> None:
    """The port's host hierarchy of A under AmgConfig(**kw) against
    hypre_tpu's: the same number of levels (three or more), CF bit for
    bit, and each level's A, P, R and the coarsest A with equal indptr
    and indices.  tol = 0: the values bit for bit; otherwise within tol
    of each operator's largest entry (for AIR and GSMG, whose batched
    LAPACK solves may part in the last bits)."""
    from hypre_tpu.solvers import amg as ref_amg
    from hypre_tpu_torch.solvers import amg as port_amg

    port = list(port_amg.iter_host_hierarchy(A, port_amg.AmgConfig(**kw)))
    ref = list(ref_amg.iter_host_hierarchy(A, ref_amg.AmgConfig(**kw)))
    assert len(port) == len(ref) >= 3
    pairs = []
    for (a, p, r, cf), (a2, p2, r2, cf2) in zip(port[:-1], ref[:-1]):
        np.testing.assert_array_equal(cf, cf2)
        pairs += [(a, a2), (p, p2), (r, r2)]
    pairs.append((port[-1], ref[-1]))
    for m, m2 in pairs:
        if tol == 0.0:
            assert_csr_equal(m, m2)
        else:
            m, m2 = sp.csr_matrix(m), sp.csr_matrix(m2)
            np.testing.assert_array_equal(m.indptr, m2.indptr)
            np.testing.assert_array_equal(m.indices, m2.indices)
            assert_ops_close(m2, m, tol)


def amg_pair(n: int, stencil: bool = False, **kw):
    """hypre_tpu's and the port's BoomerAMG, host setup, of the n^3 7-pt
    Laplacian under AmgConfig(interp_type=6, **kw), level 0 as the
    analytic stencil if asked: (reference, port), with equal level
    sizes.  The port's side on the configured device."""
    from hypre_tpu.gen import laplacian as ref_laplacian
    from hypre_tpu.solvers import amg as ref_amg
    from hypre_tpu_torch.gen import laplacian
    from hypre_tpu_torch.solvers import amg as port_amg

    kw = dict(interp_type=6, **kw)
    fine = ((n, n, n), LAPLACE_7PT) if stencil else None
    ref = ref_amg.BoomerAMG(ref_amg.AmgConfig(**kw)).setup(
        ref_laplacian(n, n, n), fine_stencil=fine)
    port = port_amg.BoomerAMG(port_amg.AmgConfig(**kw)).setup(
        laplacian(n, n, n), fine_stencil=fine)
    assert port.level_sizes == ref.level_sizes
    return ref, port


def struct_to_port(A):
    """A hypre_tpu StructMatrix as the port's (the same coefficients)."""
    from hypre_tpu_torch.convert import struct_matrix_from_numpy

    return struct_matrix_from_numpy(np.asarray(A.coefs), A.offsets, A.shape,
                                    getattr(A, "periodic", (0, 0, 0)))


def assert_struct_level_equal(ref, port, fields=("wm", "wp", "dinv")) -> None:
    """A struct level (PFMG, SMG or SparseMSG) bit for bit the
    reference's: shapes, cdir, the operator's offsets and coefficients,
    and the named arrays."""
    assert ref.cdir == port.cdir
    assert tuple(ref.fine_shape) == port.fine_shape
    assert tuple(ref.coarse_shape) == port.coarse_shape
    assert tuple(ref.A.offsets) == port.A.offsets
    np.testing.assert_array_equal(np.asarray(ref.A.coefs),
                                  port.A.coefs.numpy())
    for f in fields:
        r, p = getattr(ref, f), getattr(port, f)
        assert (r is None) == (p is None), f
        if r is not None:
            np.testing.assert_array_equal(np.asarray(r), p.numpy(), err_msg=f)


def assert_rel_close(ref, port, tol: float) -> None:
    """max |port - ref| <= tol * max |ref|."""
    ref = np.asarray(ref)
    port = port.numpy() if hasattr(port, "numpy") else np.asarray(port)
    assert ref.shape == port.shape
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)
    assert err <= tol, err


# ---------------------------------------------------------------------------
# the distributed layer
# ---------------------------------------------------------------------------

PAR_GOLDEN = "par_reference.npz"


def mesh8():
    """The reference's 1-D mesh of the 8 virtual CPU devices."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:8]), ("p",))


def part_dict(part) -> dict:
    if hasattr(part, "starts"):
        return {"starts": list(part.starts), "n_local": part.n_local}
    return {"n_global": part.n_global, "n_shards": part.n_shards,
            "n_local": part.n_local}


def comm_dict(cp) -> dict:
    return {"send_idx": np.asarray(cp.send_idx),
            "send_mask": np.asarray(cp.send_mask),
            "recv_idx": np.asarray(cp.recv_idx), "offsets": cp.offsets,
            "n_ghost": cp.n_ghost}


def parcsr_dict(M) -> dict | None:
    if M is None:
        return None
    return {"diag_cols": np.asarray(M.diag_cols),
            "diag_vals": np.asarray(M.diag_vals),
            "offd_cols": np.asarray(M.offd_cols),
            "offd_vals": np.asarray(M.offd_vals), "comm": comm_dict(M.comm),
            "row_part": part_dict(M.row_part),
            "col_part": part_dict(M.col_part)}


def par_golden() -> dict:
    """The reference's stored distributed outputs
    (tools/par_reference_counts.py fixtures)."""
    import pathlib

    path = pathlib.Path(__file__).resolve().parent / "golden" / PAR_GOLDEN
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def golden_csr(g: dict, key: str) -> sp.csr_matrix:
    return sp.csr_matrix((g[f"{key}/data"], g[f"{key}/indices"],
                          g[f"{key}/indptr"]), shape=tuple(g[f"{key}/shape"]))


def ref_shard_matvec(fn, op, x_sh):
    """y = fn(op, x) in the reference's shard_map over mesh8 (op's
    array leaves sharded on their leading axis); x_sh (8, n_local)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = mesh8()
    specs = jax.tree.map(lambda l: P("p", *([None] * (np.ndim(l) - 1))), op)
    f = jax.jit(jax.shard_map(
        lambda A, v: fn(A, v[0])[None, :], mesh=mesh,
        in_specs=(specs, P("p", None)), out_specs=P("p", None),
        check_vma=False))
    return np.asarray(f(op, jax.device_put(x_sh, NamedSharding(
        mesh, P("p", None)))))


def gloo_worker(rank: int, world: int, init_file: str, out: str) -> None:
    """One rank of the gloo test: ParBoomerAMG on a DistComm at 12^3,
    every level's A, P, R applied to a seeded vector and a PCG solve;
    rank 0 writes the gathered results to `out` (npz)."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from hypre_tpu_torch import Config, set_config

    set_config(Config(device="cpu"))
    from hypre_tpu_torch.gen import laplacian
    from hypre_tpu_torch.parallel.comm import DistComm
    from hypre_tpu_torch.parallel.parcsr import par_matvec, to_device_shards
    from hypre_tpu_torch.solvers.amg import AmgConfig
    from hypre_tpu_torch.solvers.par_amg import ParBoomerAMG

    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        comm = DistComm()
        res = gloo_products(ParBoomerAMG(comm, AmgConfig()), laplacian,
                            par_matvec, to_device_shards)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        np.savez(out, **res)


def gloo_products(pamg, laplacian, par_matvec, to_device_shards) -> dict:
    """What the gloo test compares: each level's A, P, R times a seeded
    vector (gathered), a reverse exchange, the PCG's iterations and x."""
    import torch

    A = laplacian(12, 12, 12)
    pamg.setup(A)
    comm = pamg.comm
    res = {}
    for l, lvl in enumerate(pamg.hierarchy.levels):
        for name in ("A", "P", "R"):
            M = getattr(lvl, name)
            if M is None:
                continue
            x = np.random.RandomState(10 * l + len(name)).randn(
                M.col_part.n_global)
            y = par_matvec(M, to_device_shards(x, M.col_part, comm,
                                               torch.float64))
            res[f"{name}{l}"] = comm.gather_host(y)
    # the reverse exchange (summing duplicates) on level 1's A
    M = pamg.hierarchy.levels[1].A
    g = np.random.RandomState(7).randn(comm.n_shards, M.comm.n_ghost)
    s0 = comm.shards.start
    back = comm.exchange_rev(torch.as_tensor(g[s0:s0 + comm.n_held]),
                             M.comm, M.col_part.n_local)
    res["exchange_rev"] = comm.gather_host(back)
    x, it, rel = pamg.solve_pcg(np.ones(A.shape[0]), tol=1e-8)
    res["x"], res["iters"], res["relres"] = x, np.asarray(it), \
        np.asarray(rel)
    return res
