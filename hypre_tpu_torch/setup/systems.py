"""Systems AMG: nodal coarsening + unknown-based interpolation.

Analog of hypre's num_functions > 1 machinery:
  * the condensed NODAL matrix with block-norm entries
    (ref: src/parcsr_ls/par_nodal_systems.c:43
     hypre_BoomerAMGCreateNodalA; modes 1 frobenius, 2 mean |.|,
     3 largest element, 4 row-sum inf-norm, 6 signed sum; diag_option
     1 = diagonal replaced by -sum(offd), 2 = negated)
  * nodal coarsening: PMIS/etc on the nodal strength graph, the node
    CF marker broadcast to all its unknowns
    (ref: par_amg_setup.c:385-407 nodal > 0 path)
  * unknown-based strength: couplings between DIFFERENT functions are
    never strong (ref: par_strength.c dof_func guards), so classical
    interpolation acts per unknown inside the node-coarsened grid.

The dense-block storage twin (parcsr_block_mv/csr_block_matrix.h:32)
lives in ops/block_ell.py.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from hypre_tpu_torch.setup.utils import expand_rows


def nodal_matrix(A: sp.csr_matrix, num_functions: int,
                 mode: int = 4, diag_option: int = 0) -> sp.csr_matrix:
    """Condensed nodal matrix AN (n_nodes x n_nodes).

    mode: 1 frobenius norm of each nf x nf block, 2 sum|.|/nf^2,
    3 largest element (true value), 4 inf (row-sum of |.|) norm,
    6 signed sum of the block.  diag_option: 1 -> diag = -sum(offd);
    2 -> diag negated.  Ref: par_nodal_systems.c:196-420."""
    A = A.tocsr()
    n = A.shape[0]
    nf = num_functions
    if n % nf:
        raise ValueError("rows not divisible by num_functions")
    rows = expand_rows(A.indptr)
    node_r = rows // nf
    node_c = A.indices // nf
    n_nodes = n // nf
    key = node_r.astype(np.int64) * n_nodes + node_c

    def agg(vals, how):
        # unique-compressed keys (never n_nodes^2 memory)
        uk, inv = np.unique(key, return_inverse=True)
        if how == "sum":
            acc = np.bincount(inv, vals, minlength=len(uk))
        elif how == "max":
            acc = np.full(len(uk), -np.inf)
            np.maximum.at(acc, inv, vals)
        return uk, acc

    if mode == 1:
        uk, acc = agg(A.data ** 2, "sum")
        acc = np.sqrt(acc)
    elif mode == 2:
        uk, acc = agg(np.abs(A.data), "sum")
        acc = acc / (nf * nf)
    elif mode == 3:
        # largest |element|, keeping its TRUE value
        uk, mag = agg(np.abs(A.data), "max")
        # recover the signed value of the max-|.| entry
        order = np.argsort(key, kind="stable")
        ks, vs = key[order], A.data[order]
        first = np.searchsorted(ks, uk)
        acc = np.empty(len(uk))
        for t in range(len(uk)):  # small loop over distinct blocks
            lo = first[t]
            hi = first[t + 1] if t + 1 < len(uk) else len(ks)
            blk = vs[lo:hi]
            acc[t] = blk[np.argmax(np.abs(blk))]
    elif mode == 4:
        # inf norm: max over block ROWS of the row-sum of |.|
        rk = node_r.astype(np.int64) * (n_nodes * nf) \
            + (rows % nf) * n_nodes + node_c
        urk, inv = np.unique(rk, return_inverse=True)
        rsum = np.bincount(inv, np.abs(A.data), minlength=len(urk))
        bk = urk // (n_nodes * nf) * n_nodes + urk % n_nodes
        uk, inv2 = np.unique(bk, return_inverse=True)
        acc = np.full(len(uk), -np.inf)
        np.maximum.at(acc, inv2, rsum)
    elif mode == 6:
        uk, acc = agg(A.data, "sum")
    else:
        raise ValueError(f"nodal mode {mode} not supported")

    AN = sp.csr_matrix(
        (acc, (uk // n_nodes, uk % n_nodes)),
        shape=(n_nodes, n_nodes))
    AN.sort_indices()
    if diag_option == 1:
        offd = AN.copy()
        offd.setdiag(0)
        AN.setdiag(-np.asarray(offd.sum(axis=1)).ravel())
    elif diag_option == 2:
        AN.setdiag(-AN.diagonal())
    return AN


def expand_node_cf(cf_nodes: np.ndarray, num_functions: int):
    """Broadcast the node CF marker to every unknown of the node
    (par_amg_setup.c nodal path: all dofs of a node share CF)."""
    return np.repeat(cf_nodes, num_functions)


def default_dof_func(n: int, num_functions: int) -> np.ndarray:
    """Interleaved unknown ordering (hypre's default when no dof_func
    is supplied): dof i belongs to function i % nf."""
    return (np.arange(n) % num_functions).astype(np.int32)
