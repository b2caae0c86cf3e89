"""hypre_tpu_torch — the PyTorch and CUDA port of ``hypre_tpu``.

The JAX package ``hypre_tpu`` beside it is the reference; this package
runs the same algorithms on an NVIDIA GPU.  The AMG setup runs either
on the host (``BoomerAMG.setup``: strength, coarsening, interpolation,
RAP as the same numpy/OpenMP code) or on the card
(``BoomerAMG.setup_device``: torch operations in f64); the solve phase
is PyTorch tensors on the card, with the TPU's Pallas kernels replaced
by hand-written CUDA kernels (``csrc/*.cu``).

It imports torch, numpy and scipy, never jax and nothing of
``hypre_tpu``.  Entry points run on ``cuda`` unless the caller asks for
the CPU with ``set_config(Config(device="cpu"))``.

Subpackages
-----------
core     — config (dtype, device), trace (spans), error state
gen      — problem generators (Laplacians)
setup    — host AMG setup: strength, PMIS/HMIS, direct and ext+i
           interpolation, l1 norms; device_amg: the same on the card
csrc     — host OpenMP setup kernels and the CUDA kernels
ops      — solve-phase operators (stencil, DIA, CSR, dense), the block
           product matmat, and the device setup's gather (btake)
solvers  — BoomerAMG; PCG, GMRES, FlexGMRES, LGMRES, COGMRES, BiCGSTAB,
           CGNR; LOBPCG; the hybrid solver; FSAI, ParaSails, ILU,
           Schwarz and MGR preconditioners; AMS, ADS, AME (ams) and
           SStruct Maxwell (maxwell); iterative refinement (refine)
struct   — structured grids: the struct matrix, PFMG, SMG, SparseMSG,
           SysPFMG, multi-box grids, FAC (setup numpy on the host,
           cycles torch on the device); sstruct — parts, graph, Split
parallel — the distributed layer: partitions, halo-exchange schedules
           and their executors (shards stacked in one process, or
           torch.distributed ranks), ParCSR, the distributed setup, IJ
           assembly and AMG-DD; solvers.par_amg (ParBoomerAMG) and
           struct.par_struct (ParPFMG, ParSMG, ParSysPFMG) run over it
drivers  — hypre's ij and struct drivers; testing — their golden harness
ij, mmio — IJ assembly and Matrix Market I/O (numpy)
hypre_compat — the HYPRE_* C-API call surface; core.checkpoint — AMG
           hierarchies saved and restored (npz + JSON, no pickle)
examples — hypre's examples on the port
convert  — carries hypre_tpu state (as numpy arrays) across
"""

__version__ = "0.1.0"

from hypre_tpu_torch.core.config import Config, get_config, set_config  # noqa: F401
