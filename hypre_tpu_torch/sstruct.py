"""Semi-structured (SStruct) interface.

Port of hypre_tpu/sstruct.py, the analog of hypre's sstruct layer (ref:
src/sstruct_mv/ — parts, variables, graph; src/sstruct_ls/
HYPRE_sstruct_split.c:16 Split solver).  A semi-structured problem is a
set of structured parts plus extra unstructured couplings (the graph).
The assembled object can be
  * handed to the unstructured stack (object type PARCSR: one global
    CSR, solved with BoomerAMG/Krylov), or
  * solved with the SPLIT solver: block-diagonal struct solves per
    part (PFMG/SMG) as a preconditioner, inter-part couplings handled
    by the outer Krylov iteration.

FAC (composite-grid AMR, ref: src/sstruct_ls/fac_setup2.c:19) and
Maxwell (edge multigrid with Hiptmair smoothing, ref:
maxwell_TV_setup.c:25) live with their machinery but are re-exported
here, as in the reference (hypre_tpu/sstruct.py:135): they belong to
the HYPRE_SStructSolver surface.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch


@dataclasses.dataclass
class SStructPart:
    shape: tuple              # (nz, ny, nx)
    entries: list             # [((dz,dy,dx), value-or-array)]


class SStructGrid:
    def __init__(self):
        self.parts: list[SStructPart] = []

    def add_part(self, shape, stencil_entries) -> int:
        self.parts.append(SStructPart(tuple(shape), list(stencil_entries)))
        return len(self.parts) - 1

    def part_offset(self, p: int) -> int:
        return sum(int(np.prod(q.shape)) for q in self.parts[:p])

    @property
    def n_total(self) -> int:
        return sum(int(np.prod(q.shape)) for q in self.parts)

    def flat_index(self, part, z, y, x) -> int:
        nz, ny, nx = self.parts[part].shape
        return self.part_offset(part) + (z * ny + y) * nx + x


class SStructMatrix:
    """Struct stencils per part + unstructured graph couplings."""

    def __init__(self, grid: SStructGrid):
        self.grid = grid
        self._graph_rows: list[int] = []
        self._graph_cols: list[int] = []
        self._graph_vals: list[float] = []

    def add_graph_entry(self, part_i, ijk_i, part_j, ijk_j, value):
        """Couple (part_i, (z,y,x)) to (part_j, (z,y,x))."""
        self._graph_rows.append(self.grid.flat_index(part_i, *ijk_i))
        self._graph_cols.append(self.grid.flat_index(part_j, *ijk_j))
        self._graph_vals.append(float(value))

    def assemble_parcsr(self) -> sp.csr_matrix:
        """Object type PARCSR: one global CSR over all parts."""
        from hypre_tpu_torch.gen.laplace import stencil_matrix

        blocks = []
        for part in self.grid.parts:
            nz, ny, nx = part.shape
            # gen.stencil_matrix is x-fastest with (nx, ny, nz) ordering;
            # translate offsets (dz,dy,dx) -> (dx,dy,dz)
            entries = [((dx, dy, dz), v)
                       for (dz, dy, dx), v in part.entries]
            blocks.append(stencil_matrix((nx, ny, nz), entries))
        A = sp.block_diag(blocks, format="csr")
        if self._graph_rows:
            G = sp.coo_matrix(
                (self._graph_vals, (self._graph_rows, self._graph_cols)),
                shape=A.shape)
            A = (A + G).tocsr()
        A.sort_indices()
        return A

    def struct_blocks(self):
        """Per-part StructMatrix objects (for the Split solver)."""
        from hypre_tpu_torch.struct.grid import struct_matrix_from_stencil

        return [struct_matrix_from_stencil(part.shape, part.entries)
                for part in self.grid.parts]


class SplitSolver:
    """Block-diagonal struct preconditioner: one PFMG (or SMG) cycle
    per part (ref: HYPRE_sstruct_split.c Split solver semantics)."""

    def __init__(self, M: SStructMatrix, struct_solver: str = "pfmg"):
        self.M = M
        self.kind = struct_solver
        self.part_solvers = []

    def setup(self) -> "SplitSolver":
        from hypre_tpu_torch.struct.pfmg import PFMG, PfmgConfig
        from hypre_tpu_torch.struct.smg import SMG, SmgConfig

        for As in self.M.struct_blocks():
            if self.kind == "smg":
                self.part_solvers.append(SMG(SmgConfig()).setup(As))
            else:
                self.part_solvers.append(
                    PFMG(PfmgConfig(relax_type=2)).setup(As))
        return self

    def precondition(self, r):
        out = []
        off = 0
        for part, solver in zip(self.M.grid.parts, self.part_solvers):
            npts = int(np.prod(part.shape))
            rp = r[off:off + npts].reshape(part.shape)
            out.append(solver.precondition(rp).reshape(-1))
            off += npts
        return torch.cat(out)


from hypre_tpu_torch.struct.fac import FAC, FacConfig  # noqa: E402,F401
from hypre_tpu_torch.solvers.maxwell import (  # noqa: E402,F401
    MaxwellConfig, SStructMaxwell,
)
