// Native host setup kernels for hypre_tpu_torch.
//
// Host OpenMP C++, not device code: the AMG setup's irregular graph
// algorithms over CSR (strength of connection, PMIS, CLJP/Falgout and
// the Ruge-Stueben passes, direct, ext+i and the long-range (classical,
// standard, extended) interpolations, truncation, SpGEMM,
// transpose, l1 norms, the stencil generator, the Gauss-Seidel
// wavefront levels, the ILU(k)/ILUT factorization and its
// level-scheduled refactorization).  This is the port's own copy of the subset of
// hypre_tpu/csrc/setup_kernels.cpp that the port calls, kept
// byte-for-byte in every function body so the two packages build the
// same hierarchy bit for bit.  The reference semantics are hypre's
// (src/parcsr_ls/par_strength.c, par_coarsen.c, par_interp.c,
// par_lr_interp.c, par_ilu_setup.c); every kernel but cljp,
// rs_second_pass and ilu_refactor (native only, as in the reference)
// has a numpy twin in hypre_tpu_torch/setup/ (gs_wavefronts:
// ops/trisolve.py; ilu_factor: solvers/ilu.py).  Built with
// g++ by csrc/build.py and loaded with ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {
constexpr int32_t C_PT = 1;
constexpr int32_t F_PT = -1;
constexpr int32_t SF_PT = -3;
}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Classical Ruge-Stüben first pass (the HMIS interior pass,
// ref: par_coarsen.c:911-1870).  Greedy with bucket lists; serial by
// nature (priority updates), O(nnz).
// ---------------------------------------------------------------------------
void rs_first_pass(int64_t n,
                   const int64_t* s_indptr, const int32_t* s_indices,
                   const int64_t* st_indptr, const int32_t* st_indices,
                   int32_t* cf) {
  std::vector<int64_t> measure(n);
  int64_t max_measure = 0;
  for (int64_t i = 0; i < n; ++i) {
    measure[i] = st_indptr[i + 1] - st_indptr[i];
    if (measure[i] > max_measure) max_measure = measure[i];
  }
  for (int64_t i = 0; i < n; ++i) {
    if (measure[i] == 0 && s_indptr[i + 1] == s_indptr[i]) {
      cf[i] = SF_PT;
    } else {
      cf[i] = 0;
    }
  }

  int64_t cap = max_measure + n + 2;
  std::vector<int64_t> head(cap, -1), nxt(n, -1), prv(n, -1);
  std::vector<int64_t> where(n, -1);

  auto bucket_insert = [&](int64_t i, int64_t m) {
    nxt[i] = head[m];
    prv[i] = -1;
    if (head[m] >= 0) prv[head[m]] = i;
    head[m] = i;
    where[i] = m;
  };
  auto bucket_remove = [&](int64_t i) {
    int64_t m = where[i];
    if (prv[i] >= 0) nxt[prv[i]] = nxt[i]; else head[m] = nxt[i];
    if (nxt[i] >= 0) prv[nxt[i]] = prv[i];
    where[i] = -1;
  };

  for (int64_t i = 0; i < n; ++i)
    if (cf[i] == 0) bucket_insert(i, measure[i]);

  int64_t top = max_measure;
  while (true) {
    while (top > 0 && head[top] < 0) --top;
    if (top <= 0) break;
    int64_t i = head[top];
    bucket_remove(i);
    cf[i] = C_PT;
    for (int64_t p = st_indptr[i]; p < st_indptr[i + 1]; ++p) {
      int64_t j = st_indices[p];
      if (cf[j] != 0) continue;
      cf[j] = F_PT;
      bucket_remove(j);
      for (int64_t q = s_indptr[j]; q < s_indptr[j + 1]; ++q) {
        int64_t k = s_indices[q];
        if (cf[k] != 0) continue;
        bucket_remove(k);
        measure[k] += 1;
        if (measure[k] >= cap) measure[k] = cap - 1;
        bucket_insert(k, measure[k]);
        if (measure[k] > top) top = measure[k];
      }
    }
    for (int64_t q = s_indptr[i]; q < s_indptr[i + 1]; ++q) {
      int64_t k = s_indices[q];
      if (cf[k] != 0) continue;
      bucket_remove(k);
      if (measure[k] > 0) measure[k] -= 1;
      bucket_insert(k, measure[k]);
    }
  }
  for (int64_t i = 0; i < n; ++i)
    if (cf[i] == 0) cf[i] = F_PT;
}

// ---------------------------------------------------------------------------
// CLJP coarsening, single-rank semantics of hypre_BoomerAMGCoarsen
// (ref: par_coarsen.c:93-1390): iterative independent-set selection
// with the two CLJP heuristics (C-points remove their S edges and
// decrement neighbor measures; F/unassigned points drop edges to
// neighbors that share a common-C dependency, decrementing measures).
// cf_init = 1 runs the Falgout variant: the caller passes cf with an
// existing C/F splitting (Ruge-Stüben first pass); its C points seed
// the first round's independent set (F points rejoin the graph).
// measure: ST-degree + deterministic hash (caller-provided); modified.
// ---------------------------------------------------------------------------
void cljp(int64_t n, const int64_t* s_indptr, const int32_t* s_indices,
          double* measure, int32_t* cf, int32_t cf_init) {
  const int64_t nnz = s_indptr[n];
  std::vector<int64_t> sj(s_indices, s_indices + nnz);  // sign-removable
  std::vector<int64_t> graph;
  graph.reserve(n);
  constexpr int32_t COMMON_C = 2;

  if (cf_init == 1) {
    for (int64_t i = 0; i < n; ++i) {
      if (cf[i] == SF_PT) {
        measure[i] = 0;
        continue;
      }
      if (cf[i] == F_PT) cf[i] = 0;
      graph.push_back(i);
    }
  } else {
    for (int64_t i = 0; i < n; ++i) {
      if (cf[i] == SF_PT) {
        measure[i] = 0;
        continue;
      }
      cf[i] = 0;
      if (s_indptr[i + 1] == s_indptr[i]) {
        cf[i] = SF_PT;
        measure[i] = 0;
      } else {
        graph.push_back(i);
      }
    }
  }
  int64_t graph_size = (int64_t)graph.size();
  int64_t iter = 0;

  while (true) {
    // ---- set F points / drop assigned from graph ----
    if (iter || cf_init != 1) {
      for (int64_t ig = 0; ig < graph_size; ++ig) {
        const int64_t i = graph[ig];
        if (cf[i] != C_PT && measure[i] < 1) {
          cf[i] = F_PT;
          for (int64_t p = s_indptr[i]; p < s_indptr[i + 1]; ++p)
            if (sj[p] > -1) { cf[i] = 0; break; }
        }
        if (cf[i]) {
          measure[i] = 0;
          --graph_size;
          graph[ig] = graph[graph_size];
          graph[graph_size] = i;
          --ig;
        }
      }
    }
    if (graph_size == 0) break;

    // ---- independent set among measure > 1 (all original edges) ----
    if (iter || cf_init != 1) {
      for (int64_t ig = 0; ig < graph_size; ++ig) {
        const int64_t i = graph[ig];
        if (measure[i] > 1) cf[i] = 1;
      }
      for (int64_t ig = 0; ig < graph_size; ++ig) {
        const int64_t i = graph[ig];
        if (measure[i] <= 1) continue;
        for (int64_t p = s_indptr[i]; p < s_indptr[i + 1]; ++p) {
          int64_t j = sj[p];
          if (j < 0) j = -j - 1;
          if (measure[j] > 1) {
            if (measure[i] > measure[j]) cf[j] = 0;
            else if (measure[j] > measure[i]) cf[i] = 0;
          }
        }
      }
    }
    ++iter;

    // ---- set C points and apply the heuristics ----
    for (int64_t ig = 0; ig < graph_size; ++ig) {
      const int64_t i = graph[ig];
      if (cf[i] > 0) {
        cf[i] = C_PT;
        for (int64_t p = s_indptr[i]; p < s_indptr[i + 1]; ++p) {
          const int64_t j = sj[p];
          if (j > -1) {
            sj[p] = -j - 1;
            if (!cf[j]) measure[j] -= 1.0;
          }
        }
      } else {
        // mark C dependencies of i as COMMON_C; drop edges to C/SF
        for (int64_t p = s_indptr[i]; p < s_indptr[i + 1]; ++p) {
          int64_t j = sj[p];
          if (j < 0) j = -j - 1;
          if (cf[j] > 0) {
            if (sj[p] > -1) sj[p] = -sj[p] - 1;
            cf[j] = COMMON_C;
          } else if (cf[j] == SF_PT) {
            if (sj[p] > -1) sj[p] = -sj[p] - 1;
          }
        }
        // drop edges to unassigned j that depend on a COMMON_C
        for (int64_t p = s_indptr[i]; p < s_indptr[i + 1]; ++p) {
          if (sj[p] <= -1) continue;
          const int64_t j = sj[p];
          for (int64_t q = s_indptr[j]; q < s_indptr[j + 1]; ++q) {
            int64_t k = sj[q];
            if (k < 0) k = -k - 1;
            if (cf[k] == COMMON_C) {
              sj[p] = -sj[p] - 1;
              measure[j] -= 1.0;
              break;
            }
          }
        }
        // reset COMMON_C back to C
        for (int64_t p = s_indptr[i]; p < s_indptr[i + 1]; ++p) {
          int64_t j = sj[p];
          if (j < 0) j = -j - 1;
          if (cf[j] == COMMON_C) cf[j] = C_PT;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Ruge-Stüben second pass, single-rank semantics (ref:
// par_coarsen.c:1400-1640, coarsen_type 1 interior branch): every
// strong F-F pair must share a common C; violations tentatively
// promote the neighbor (ci_tilde) and re-examine, or promote i itself.
// ---------------------------------------------------------------------------
void rs_second_pass(int64_t n, const int64_t* s_indptr,
                    const int32_t* s_indices, int32_t* cf) {
  std::vector<int64_t> graph(n, -1);
  int64_t ci_tilde = -1, ci_tilde_mark = -1;
  int32_t C_i_nonempty = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (ci_tilde_mark != i) ci_tilde = -1;
    if (cf[i] != F_PT) continue;
    for (int64_t p = s_indptr[i]; p < s_indptr[i + 1]; ++p)
      if (cf[s_indices[p]] > 0) graph[s_indices[p]] = i;
    for (int64_t p = s_indptr[i]; p < s_indptr[i + 1]; ++p) {
      const int64_t j = s_indices[p];
      if (cf[j] != F_PT) continue;
      bool set_empty = true;
      for (int64_t q = s_indptr[j]; q < s_indptr[j + 1]; ++q) {
        if (graph[s_indices[q]] == i) { set_empty = false; break; }
      }
      if (set_empty) {
        if (C_i_nonempty) {
          cf[i] = C_PT;
          if (ci_tilde > -1) {
            cf[ci_tilde] = F_PT;
            ci_tilde = -1;
          }
          C_i_nonempty = 0;
          break;
        } else {
          ci_tilde = j;
          ci_tilde_mark = i;
          cf[j] = C_PT;
          C_i_nonempty = 1;
          --i;
          break;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Strength of connection mask (hypre_BoomerAMGCreateS semantics,
// ref: par_strength.c:230-420).  Writes a 0/1 byte per CSR entry of A.
// ---------------------------------------------------------------------------
void strength_mask(int64_t n,
                   const int64_t* indptr, const int32_t* indices,
                   const double* data,
                   double theta, double max_row_sum, int32_t abs_soc,
                   uint8_t* strong /* out, nnz bytes */) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const int64_t b = indptr[i], e = indptr[i + 1];
    double diag = 0.0, row_sum = 0.0, abs_row_sum = 0.0;
    double mx = -INFINITY, mn = INFINITY, amx = 0.0;
    for (int64_t p = b; p < e; ++p) {
      const double v = data[p];
      row_sum += v;
      abs_row_sum += std::fabs(v);
      if (indices[p] == i) {
        diag = v;
      } else {
        if (v > mx) mx = v;
        if (v < mn) mn = v;
        const double av = std::fabs(v);
        if (av > amx) amx = av;
      }
    }
    // abs_soc (CreateSabs, par_strength.c) weak-row rule uses the
    // ABS row sum: weak iff sum|a| < |diag| * (2 - max_row_sum)
    const bool weak_all = (max_row_sum < 1.0)
        && (abs_soc
                ? (abs_row_sum < std::fabs(diag) * (2.0 - max_row_sum))
                : (std::fabs(row_sum) > std::fabs(diag) * max_row_sum));
    if (weak_all) {
      std::memset(strong + b, 0, (size_t)(e - b));
      continue;
    }
    if (abs_soc) {
      const double th = theta * amx;
      for (int64_t p = b; p < e; ++p)
        strong[p] = (indices[p] != i) && (std::fabs(data[p]) >= th);
    } else if (diag < 0.0) {
      const double th = theta * mx;
      for (int64_t p = b; p < e; ++p)
        strong[p] = (indices[p] != i) && (data[p] > th);
    } else {
      const double th = theta * mn;
      for (int64_t p = b; p < e; ++p)
        strong[p] = (indices[p] != i) && (data[p] < th);
    }
  }
}

// ---------------------------------------------------------------------------
// PMIS coarsening rounds (ref: par_coarsen.c:2101 PMISHost; the round
// structure here replicates setup/coarsen.py:pmis exactly so numpy and
// native paths yield identical CF splittings).
//   measure: ST-degree + deterministic hash, precomputed by the caller.
// ---------------------------------------------------------------------------
void pmis(int64_t n,
          const int64_t* s_indptr, const int32_t* s_indices,
          double* measure /* modified in place */,
          int32_t* cf /* out */) {
  std::vector<uint8_t> cand(n), out(n);
  for (int64_t i = 0; i < n; ++i) {
    if (s_indptr[i + 1] == s_indptr[i]) {
      cf[i] = SF_PT;
      measure[i] = 0.0;
    } else {
      cf[i] = 0;
    }
  }
  int64_t n_unassigned = 0;
  for (int64_t i = 0; i < n; ++i) n_unassigned += (cf[i] == 0);

  while (n_unassigned > 0) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
      cand[i] = (cf[i] == 0) && (measure[i] > 1.0);
      out[i] = 0;
    }
    // edge competitions: for a strong edge (i, j) between candidates
    // the smaller measure loses its candidacy
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
      if (!cand[i]) continue;
      for (int64_t p = s_indptr[i]; p < s_indptr[i + 1]; ++p) {
        const int32_t j = s_indices[p];
        if (!cand[j]) continue;
        if (measure[i] > measure[j]) out[j] = 1;
        else if (measure[j] > measure[i]) out[i] = 1;
      }
    }
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
      if (cand[i] && !out[i]) cf[i] = C_PT;
      else if (cf[i] == 0 && measure[i] < 1.0) cf[i] = F_PT;
    }
    // unassigned, not new-C, not low: F if any strong C dependency
    int64_t assigned = 0;
#pragma omp parallel for schedule(static) reduction(+:assigned)
    for (int64_t i = 0; i < n; ++i) {
      if (cf[i] == 0) {
        bool has_c = false;
        for (int64_t p = s_indptr[i]; p < s_indptr[i + 1]; ++p) {
          if (cf[s_indices[p]] == C_PT) { has_c = true; break; }
        }
        if (has_c) cf[i] = F_PT;
      }
      if (cf[i] != 0 && measure[i] != 0.0) {
        measure[i] = 0.0;
      }
      assigned += (cf[i] != 0);
    }
    n_unassigned = n - assigned;
  }
}

// ---------------------------------------------------------------------------
// Direct interpolation (type 3; hypre_BoomerAMGBuildDirInterp,
// ref: par_interp.c:1948-2500).  Two-pass CSR build: pass==0 fills
// p_indptr only; pass==1 fills indices (coarse-numbered) and data.
// ---------------------------------------------------------------------------
void direct_interp(int64_t n, int32_t pass,
                   const int64_t* a_indptr, const int32_t* a_indices,
                   const double* a_data, const uint8_t* strong,
                   const int32_t* cf, const int32_t* cmap,
                   int64_t* p_indptr,
                   int32_t* p_indices, double* p_data) {
  if (pass == 0) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
      int64_t cnt = 0;
      if (cf[i] == C_PT) {
        cnt = 1;
      } else if (cf[i] != 0) {  // F and SF rows
        for (int64_t p = a_indptr[i]; p < a_indptr[i + 1]; ++p)
          if (strong[p] && cf[a_indices[p]] == C_PT) ++cnt;
      }
      p_indptr[i + 1] = cnt;
    }
    p_indptr[0] = 0;
    for (int64_t i = 0; i < n; ++i) p_indptr[i + 1] += p_indptr[i];
    return;
  }
#pragma omp parallel for schedule(dynamic, 512)
  for (int64_t i = 0; i < n; ++i) {
    int64_t w = p_indptr[i];
    if (cf[i] == C_PT) {
      p_indices[w] = cmap[i];
      p_data[w] = 1.0;
      continue;
    }
    if (cf[i] == 0) continue;
    double diag = 0.0;
    double sum_n_neg = 0.0, sum_n_pos = 0.0;
    double sum_p_neg = 0.0, sum_p_pos = 0.0;
    const int64_t b = a_indptr[i], e = a_indptr[i + 1];
    for (int64_t p = b; p < e; ++p) {
      const double v = a_data[p];
      if (a_indices[p] == i) { diag = v; continue; }
      if (v < 0) sum_n_neg += v; else if (v > 0) sum_n_pos += v;
      if (strong[p] && cf[a_indices[p]] == C_PT) {
        if (v < 0) sum_p_neg += v; else if (v > 0) sum_p_pos += v;
      }
    }
    const double alfa =
        (sum_p_neg != 0.0) ? sum_n_neg / (sum_p_neg * diag) : 1.0;
    const double beta =
        (sum_p_pos != 0.0) ? sum_n_pos / (sum_p_pos * diag) : 1.0;
    for (int64_t p = b; p < e; ++p) {
      if (!strong[p]) continue;
      const int32_t j = a_indices[p];
      if (cf[j] != C_PT) continue;
      const double v = a_data[p];
      p_indices[w] = cmap[j];
      p_data[w] = (v < 0) ? -alfa * v : -beta * v;
      ++w;
    }
  }
}

// ---------------------------------------------------------------------------
// Extended+i interpolation (type 6; hypre_BoomerAMGBuildExtPIInterp,
// ref: par_lr_interp.c:1024-1800).  Distance-2 pattern via per-thread
// marker arrays.  pass==0: row counts; pass==1: fill (columns sorted
// ascending in COARSE numbering; per-row accumulation is sequential so
// results are deterministic).
// ---------------------------------------------------------------------------
void extpi_interp(int64_t n, int32_t pass,
                  const int64_t* a_indptr, const int32_t* a_indices,
                  const double* a_data, const uint8_t* strong,
                  const int32_t* cf, const int32_t* cmap,
                  const double* diag /* a_ii per row */,
                  int64_t* p_indptr,
                  int32_t* p_indices, double* p_data) {
#pragma omp parallel
  {
    // marker[j] = stamp when j entered this row's pattern C-hat
    std::vector<int64_t> marker(n, -1);
    std::vector<int32_t> patt;  // fine indices of C-hat, insertion order
    std::vector<double> acc;    // accumulated P values per pattern slot
    patt.reserve(64);
    acc.reserve(64);

#pragma omp for schedule(dynamic, 256)
    for (int64_t i = 0; i < n; ++i) {
      if (cf[i] == C_PT) {
        if (pass == 0) {
          p_indptr[i + 1] = 1;
        } else {
          p_indices[p_indptr[i]] = cmap[i];
          p_data[p_indptr[i]] = 1.0;
        }
        continue;
      }
      if (cf[i] == 0 || cf[i] == SF_PT) {
        if (pass == 0) p_indptr[i + 1] = 0;
        continue;
      }
      // ---- build C-hat_i: strong C of i, plus strong C of each
      // strong F neighbor k of i ----
      patt.clear();
      const int64_t b = a_indptr[i], e = a_indptr[i + 1];
      for (int64_t p = b; p < e; ++p) {
        if (!strong[p]) continue;
        const int32_t j = a_indices[p];
        if (cf[j] == C_PT) {
          if (marker[j] != i) {
            marker[j] = i;
            patt.push_back(j);
          }
        } else if (cf[j] == F_PT) {
          for (int64_t q = a_indptr[j]; q < a_indptr[j + 1]; ++q) {
            if (!strong[q]) continue;
            const int32_t l = a_indices[q];
            if (cf[l] == C_PT && marker[l] != i) {
              marker[l] = i;
              patt.push_back(l);
            }
          }
        }
      }
      if (pass == 0) {
        p_indptr[i + 1] = (int64_t)patt.size();
        continue;
      }
      std::sort(patt.begin(), patt.end());
      const int64_t w0 = p_indptr[i];
      acc.assign(patt.size(), 0.0);
      // encode slot as -(s + 2): distinct from the -1 init value and
      // from any row stamp (>= 0).  slot(j) = -marker[j] - 2.
      for (size_t s = 0; s < patt.size(); ++s)
        marker[patt[s]] = -((int64_t)s + 2);
      double d = diag[i];
      for (int64_t p = b; p < e; ++p) {
        const int32_t j = a_indices[p];
        if (j == i) continue;
        const double aij = a_data[p];
        if (marker[j] <= -2) {
          acc[-marker[j] - 2] += aij;  // direct part: j in C-hat
        } else if (strong[p] && cf[j] == F_PT) {
          // distribute over row j: denom = sum of a_jl with l in
          // C-hat ∪ {i}, sign(a_jj) * a_jl < 0
          const double sgn = (diag[j] > 0) - (diag[j] < 0);
          double denom = 0.0;
          for (int64_t q = a_indptr[j]; q < a_indptr[j + 1]; ++q) {
            const int32_t l = a_indices[q];
            if (l == j) continue;
            const double ajl = a_data[q];
            if (sgn * ajl >= 0) continue;
            if (marker[l] <= -2 || l == (int32_t)i) denom += ajl;
          }
          if (denom == 0.0) {
            d += aij;
          } else {
            const double dist = aij / denom;
            for (int64_t q = a_indptr[j]; q < a_indptr[j + 1]; ++q) {
              const int32_t l = a_indices[q];
              if (l == j) continue;
              const double ajl = a_data[q];
              if (sgn * ajl >= 0) continue;
              if (marker[l] <= -2) acc[-marker[l] - 2] += dist * ajl;
              else if (l == (int32_t)i) d += dist * ajl;
            }
          }
        } else if (cf[j] != SF_PT) {
          d += aij;  // weak connection folds into the diagonal
        }
      }
      const double inv = (d != 0.0) ? (-1.0 / d) : 1.0;
      for (size_t s = 0; s < patt.size(); ++s) {
        p_indices[w0 + (int64_t)s] = cmap[patt[s]];
        p_data[w0 + (int64_t)s] = acc[s] * inv;
        marker[patt[s]] = i;  // restore row stamp
      }
    }
  }
  if (pass == 0) {
    p_indptr[0] = 0;
    for (int64_t i = 0; i < n; ++i) p_indptr[i + 1] += p_indptr[i];
  }
}

// ---------------------------------------------------------------------------
// Long-range interpolation family (single-rank semantics of hypre's
// host builders):
//   variant 0:  classical modified (hypre_BoomerAMGBuildInterp,
//               ref: par_interp.c:15-900) — distance-1 pattern,
//               strong-F couplings distributed over common strong C
//               with the sign filter sgn(a_jj)*a_jl < 0.
//   variant 14: extended (hypre_BoomerAMGBuildExtInterp, ref:
//               par_lr_interp.c:4777-5520) — same distribution but
//               over the distance-2 pattern (strong C of i plus
//               strong C of strong-F neighbors).
//   variant 8/9: standard (hypre_BoomerAMGBuildStdInterp, ref:
//               par_lr_interp.c:22-1010) — eliminates strong-F rows
//               into an extended row ahat over the distance-2
//               pattern; 9 = sep_weight (pos/neg scaled separately).
// Two-pass like the other interp kernels.
// ---------------------------------------------------------------------------
void lr_interp(int64_t n, int32_t pass, int32_t variant,
               const int64_t* a_indptr, const int32_t* a_indices,
               const double* a_data, const uint8_t* strong,
               const int32_t* cf, const int32_t* cmap,
               const double* diag /* a_ii per row */,
               int64_t* p_indptr,
               int32_t* p_indices, double* p_data) {
  const bool dist2 = (variant != 0);
  const bool standard = (variant == 8 || variant == 9);
  const bool sep = (variant == 9);
#pragma omp parallel
  {
    std::vector<int64_t> marker(n, -1);   // C-pattern stamps / slots
    std::vector<int64_t> fslot(n, -1);    // F-slot stamp (standard)
    std::vector<int32_t> patt, fpnt;
    std::vector<double> acc, facc;
    patt.reserve(64);

#pragma omp for schedule(dynamic, 256)
    for (int64_t i = 0; i < n; ++i) {
      if (cf[i] == C_PT) {
        if (pass == 0) {
          p_indptr[i + 1] = 1;
        } else {
          p_indices[p_indptr[i]] = cmap[i];
          p_data[p_indptr[i]] = 1.0;
        }
        continue;
      }
      if (cf[i] == 0 || cf[i] == SF_PT) {
        if (pass == 0) p_indptr[i + 1] = 0;
        continue;
      }
      // ---- pattern: strong C of i (+ strong C of strong-F, dist2) --
      patt.clear();
      const int64_t b = a_indptr[i], e = a_indptr[i + 1];
      for (int64_t p = b; p < e; ++p) {
        if (!strong[p]) continue;
        const int32_t j = a_indices[p];
        if (cf[j] == C_PT) {
          if (marker[j] != i) {
            marker[j] = i;
            patt.push_back(j);
          }
        } else if (dist2 && cf[j] == F_PT) {
          for (int64_t q = a_indptr[j]; q < a_indptr[j + 1]; ++q) {
            if (!strong[q]) continue;
            const int32_t l = a_indices[q];
            if (cf[l] == C_PT && marker[l] != i) {
              marker[l] = i;
              patt.push_back(l);
            }
          }
        }
      }
      if (pass == 0) {
        p_indptr[i + 1] = (int64_t)patt.size();
        continue;
      }
      std::sort(patt.begin(), patt.end());
      const int64_t w0 = p_indptr[i];
      acc.assign(patt.size(), 0.0);
      for (size_t s = 0; s < patt.size(); ++s)
        marker[patt[s]] = -((int64_t)s + 2);  // slot = -marker - 2

      if (!standard) {
        // ---- classical / extended distribution ----
        double d = diag[i];
        for (int64_t p = b; p < e; ++p) {
          const int32_t j = a_indices[p];
          if (j == i) continue;
          const double aij = a_data[p];
          if (marker[j] <= -2) {
            acc[-marker[j] - 2] += aij;
          } else if (strong[p] && cf[j] == F_PT) {
            const double sgn = (diag[j] > 0) - (diag[j] < 0);
            double denom = 0.0;
            for (int64_t q = a_indptr[j]; q < a_indptr[j + 1]; ++q) {
              const int32_t l = a_indices[q];
              if (l == j) continue;
              const double ajl = a_data[q];
              if (sgn * ajl >= 0) continue;
              if (marker[l] <= -2) denom += ajl;
            }
            if (denom == 0.0) {
              d += aij;
            } else {
              const double dist = aij / denom;
              for (int64_t q = a_indptr[j]; q < a_indptr[j + 1]; ++q) {
                const int32_t l = a_indices[q];
                if (l == j) continue;
                const double ajl = a_data[q];
                if (sgn * ajl >= 0) continue;
                if (marker[l] <= -2) acc[-marker[l] - 2] += dist * ajl;
              }
            }
          } else if (cf[j] != SF_PT) {
            d += aij;
          }
        }
        const double inv = (d != 0.0) ? (-1.0 / d) : 1.0;
        for (size_t s = 0; s < patt.size(); ++s) {
          p_indices[w0 + (int64_t)s] = cmap[patt[s]];
          p_data[w0 + (int64_t)s] = acc[s] * inv;
          marker[patt[s]] = i;
        }
        continue;
      }

      // ---- standard: eliminate strong-F rows into ahat ----
      // C slots live in acc[]; F slots in facc[] (slot 0 = i itself,
      // matching hypre's first-F-slot-is-i convention so "diagonal"
      // picks up elimination feedback onto i)
      fpnt.clear();
      facc.clear();
      fslot[i] = 0;
      fpnt.push_back((int32_t)i);
      facc.push_back(diag[i]);
      auto add_at = [&](int32_t k, double v, bool from_elim) {
        if (marker[k] <= -2) {
          acc[-marker[k] - 2] += v;
        } else if (from_elim || cf[k] != SF_PT) {
          if (fslot[k] < 1 || (size_t)fslot[k] >= facc.size() ||
              fpnt[fslot[k]] != k) {
            if (k == (int32_t)i) { facc[0] += v; return; }
            fslot[k] = (int64_t)facc.size();
            fpnt.push_back(k);
            facc.push_back(v);
          } else {
            facc[fslot[k]] += v;
          }
        }
      };
      for (int64_t p = b; p < e; ++p) {
        const int32_t j = a_indices[p];
        if (j == i) continue;
        const double aij = a_data[p];
        if (strong[p] && cf[j] == F_PT) {
          const double ajj = diag[j];
          if (ajj != 0.0) {
            const double dist = aij / ajj;
            for (int64_t q = a_indptr[j]; q < a_indptr[j + 1]; ++q) {
              const int32_t k = a_indices[q];
              if (k == j) continue;
              add_at(k, -a_data[q] * dist, true);
            }
          }
        } else {
          add_at(j, aij, false);
        }
      }
      const double d = facc[0];
      double sum_c = 0.0, sum_all = 0.0;
      double pos_c = 0.0, neg_c = 0.0, pos = 0.0, neg = 0.0;
      for (double v : acc) {
        sum_c += v;
        if (v > 0) pos_c += v; else neg_c += v;
      }
      sum_all = sum_c;
      pos = pos_c;
      neg = neg_c;
      for (size_t s = 1; s < facc.size(); ++s) {
        sum_all += facc[s];
        if (facc[s] > 0) pos += facc[s]; else neg += facc[s];
      }
      double alfa = 1.0, beta = 1.0;
      if (sep) {
        if (neg_c * d != 0.0) alfa = neg / neg_c / d;
        if (pos_c * d != 0.0) beta = pos / pos_c / d;
      } else {
        if (sum_c * d != 0.0) alfa = sum_all / sum_c / d;
        beta = alfa;
      }
      for (size_t s = 0; s < patt.size(); ++s) {
        p_indices[w0 + (int64_t)s] = cmap[patt[s]];
        p_data[w0 + (int64_t)s] =
            (acc[s] > 0) ? -beta * acc[s] : -alfa * acc[s];
        marker[patt[s]] = i;
      }
      for (int32_t k : fpnt) fslot[k] = -1;
    }
  }
  if (pass == 0) {
    p_indptr[0] = 0;
    for (int64_t i = 0; i < n; ++i) p_indptr[i + 1] += p_indptr[i];
  }
}

// ---------------------------------------------------------------------------
// Interpolation truncation (hypre_ParCSRMatrixTruncate semantics,
// ref: par_csr_matrix.c:2874): drop entries below trunc_factor *
// row-max-abs, keep the max_elmts largest by magnitude (stable on
// ties), rescale survivors to preserve the row sum.  Two-pass.
// ---------------------------------------------------------------------------
void truncate_interp(int64_t n, int32_t pass,
                     const int64_t* indptr, const int32_t* indices,
                     const double* data,
                     double trunc_factor, int64_t max_elmts,
                     int64_t* t_indptr,
                     int32_t* t_indices, double* t_data) {
#pragma omp parallel
  {
    std::vector<int64_t> ord;
    std::vector<uint8_t> keep;
#pragma omp for schedule(dynamic, 512)
    for (int64_t i = 0; i < n; ++i) {
      const int64_t b = indptr[i], e = indptr[i + 1];
      const int64_t m = e - b;
      keep.assign(m, 1);
      if (trunc_factor > 0.0) {
        double mx = 0.0;
        for (int64_t p = b; p < e; ++p)
          mx = std::max(mx, std::fabs(data[p]));
        const double th = trunc_factor * mx;
        for (int64_t p = b; p < e; ++p)
          if (std::fabs(data[p]) < th) keep[p - b] = 0;
      }
      if (max_elmts > 0 && m > max_elmts) {
        ord.resize(m);
        std::iota(ord.begin(), ord.end(), (int64_t)0);
        std::stable_sort(ord.begin(), ord.end(),
                         [&](int64_t x, int64_t y) {
                           return std::fabs(data[b + x]) >
                                  std::fabs(data[b + y]);
                         });
        for (int64_t r = max_elmts; r < m; ++r) keep[ord[r]] = 0;
      }
      int64_t cnt = 0;
      double row_sum = 0.0, kept_sum = 0.0;
      for (int64_t p = b; p < e; ++p) {
        row_sum += data[p];
        if (keep[p - b]) { ++cnt; kept_sum += data[p]; }
      }
      if (pass == 0) {
        t_indptr[i + 1] = cnt;
        continue;
      }
      const double scale = (kept_sum != 0.0) ? row_sum / kept_sum : 1.0;
      int64_t w = t_indptr[i];
      for (int64_t p = b; p < e; ++p) {
        if (!keep[p - b]) continue;
        t_indices[w] = indices[p];
        t_data[w] = data[p] * scale;
        ++w;
      }
    }
  }
  if (pass == 0) {
    t_indptr[0] = 0;
    for (int64_t i = 0; i < n; ++i) t_indptr[i + 1] += t_indptr[i];
  }
}

// ---------------------------------------------------------------------------
// Row-parallel SpGEMM C = A @ B with per-thread dense accumulators
// (the hash-free analog of the reference's device SpGEMM binning,
// ref: src/seq_mv/csr_spgemm_device.c:15 — here a scatter array per
// thread replaces the per-warp hash table).  Two-pass; output columns
// ascend because the scatter array is swept in B-column order... no:
// insertion order, then per-row sort in pass 1 fill.
// ---------------------------------------------------------------------------
void spgemm(int64_t n_rows, int64_t b_cols, int32_t pass,
            const int64_t* a_indptr, const int32_t* a_indices,
            const double* a_data,
            const int64_t* b_indptr, const int32_t* b_indices,
            const double* b_data,
            int64_t* c_indptr, int32_t* c_indices, double* c_data) {
#pragma omp parallel
  {
    std::vector<int64_t> next(b_cols, -1);   // stamp per column
    std::vector<double> sums(b_cols, 0.0);
    std::vector<int32_t> cols;
    cols.reserve(256);
#pragma omp for schedule(dynamic, 128)
    for (int64_t i = 0; i < n_rows; ++i) {
      cols.clear();
      for (int64_t p = a_indptr[i]; p < a_indptr[i + 1]; ++p) {
        const int32_t k = a_indices[p];
        const double av = a_data[p];
        for (int64_t q = b_indptr[k]; q < b_indptr[k + 1]; ++q) {
          const int32_t j = b_indices[q];
          if (next[j] != i) {
            next[j] = i;
            sums[j] = 0.0;
            cols.push_back(j);
          }
          sums[j] += av * b_data[q];
        }
      }
      if (pass == 0) {
        c_indptr[i + 1] = (int64_t)cols.size();
        continue;
      }
      std::sort(cols.begin(), cols.end());
      int64_t w = c_indptr[i];
      for (const int32_t j : cols) {
        c_indices[w] = j;
        c_data[w] = sums[j];
        ++w;
      }
    }
  }
  if (pass == 0) {
    c_indptr[0] = 0;
    for (int64_t i = 0; i < n_rows; ++i) c_indptr[i + 1] += c_indptr[i];
  }
}

// ---------------------------------------------------------------------------
// CSR transpose (counting sort over columns) — used for R = P^T and
// the PMIS measure's ST degrees without scipy's COO round trip.
// ---------------------------------------------------------------------------
void csr_transpose(int64_t n_rows, int64_t n_cols,
                   const int64_t* indptr, const int32_t* indices,
                   const double* data,
                   int64_t* t_indptr, int32_t* t_indices, double* t_data) {
  const int64_t nnz = indptr[n_rows];
  std::vector<int64_t> cnt(n_cols + 1, 0);
  for (int64_t p = 0; p < nnz; ++p) ++cnt[indices[p] + 1];
  for (int64_t j = 0; j < n_cols; ++j) cnt[j + 1] += cnt[j];
  std::memcpy(t_indptr, cnt.data(), (size_t)(n_cols + 1) * sizeof(int64_t));
  std::vector<int64_t> w(cnt.begin(), cnt.end() - 1);
  for (int64_t i = 0; i < n_rows; ++i) {
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      const int64_t dst = w[indices[p]]++;
      t_indices[dst] = (int32_t)i;
      if (data) t_data[dst] = data[p];
    }
  }
}


// ---------------------------------------------------------------------------
// Stencil-matrix CSR generator (semantics of hypre's GenerateLaplacian
// family, ref: src/parcsr_ls/par_laplace.c:63): x-fastest ordering,
// Dirichlet truncation at the boundary.  Offsets must be pre-sorted by
// linear displacement so columns come out sorted.  pass 0: indptr;
// pass 1: indices + data.
// ---------------------------------------------------------------------------
void stencil_csr(int64_t nx, int64_t ny, int64_t nz, int32_t n_ent,
                 int32_t pass,
                 const int32_t* dx, const int32_t* dy, const int32_t* dz,
                 const double* v,
                 int64_t* indptr, int32_t* indices, double* data) {
  const int64_t nxy = nx * ny;
#pragma omp parallel for schedule(static) collapse(2)
  for (int64_t iz = 0; iz < nz; ++iz) {
    for (int64_t iy = 0; iy < ny; ++iy) {
      const int64_t row0 = iy * nx + iz * nxy;
      for (int64_t ix = 0; ix < nx; ++ix) {
        const int64_t i = row0 + ix;
        int64_t w = (pass == 0) ? 0 : indptr[i];
        for (int32_t k = 0; k < n_ent; ++k) {
          const int64_t jx = ix + dx[k], jy = iy + dy[k], jz = iz + dz[k];
          if (jx < 0 || jx >= nx || jy < 0 || jy >= ny
              || jz < 0 || jz >= nz) continue;
          if (pass == 0) {
            ++w;
          } else {
            indices[w] = (int32_t)(jx + jy * nx + jz * nxy);
            data[w] = v[k];
            ++w;
          }
        }
        if (pass == 0) indptr[i + 1] = w;
      }
    }
  }
  if (pass == 0) {
    indptr[0] = 0;
    for (int64_t i = 0, n = nx * ny * nz; i < n; ++i)
      indptr[i + 1] += indptr[i];
  }
}


// ---------------------------------------------------------------------------
// Boolean-mask CSR filter: S = entries of A where mask is set (data
// forced to 1.0) — builds the strength pattern from strength_mask's
// output without numpy round trips.
// ---------------------------------------------------------------------------
void mask_to_csr(int64_t n, int32_t pass,
                 const int64_t* indptr, const int32_t* indices,
                 const uint8_t* mask,
                 int64_t* s_indptr, int32_t* s_indices) {
  if (pass == 0) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
      int64_t cnt = 0;
      for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p)
        cnt += (mask[p] != 0);
      s_indptr[i + 1] = cnt;
    }
    s_indptr[0] = 0;
    for (int64_t i = 0; i < n; ++i) s_indptr[i + 1] += s_indptr[i];
    return;
  }
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    int64_t w = s_indptr[i];
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p)
      if (mask[p]) s_indices[w++] = indices[p];
  }
}

// ---------------------------------------------------------------------------
// Gauss-Seidel wavefront levels (the level-scheduling analysis a
// vendor sparse trisolve performs, e.g. cusparse csrsv2 as used by the
// reference's device hybrid-GS): depth[i] = longest chain of
// lower-triangular couplings ending at i.  Rows of equal depth can
// update concurrently in a forward sweep.  dir=0: forward (j < i);
// dir=1: backward (j > i, scanned in reverse).
// ---------------------------------------------------------------------------
void gs_wavefronts(int64_t n, int32_t dir,
                   const int64_t* indptr, const int32_t* indices,
                   int32_t* depth) {
  if (dir == 0) {
    for (int64_t i = 0; i < n; ++i) {
      int32_t d = 0;
      for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
        const int32_t j = indices[p];
        if (j < i && depth[j] > d) d = depth[j];
      }
      depth[i] = d + 1;
    }
  } else {
    for (int64_t i = n - 1; i >= 0; --i) {
      int32_t d = 0;
      for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
        const int32_t j = indices[p];
        if (j > i && depth[j] > d) d = depth[j];
      }
      depth[i] = d + 1;
    }
  }
}

// ---------------------------------------------------------------------------
// Smoother l1 row norms (twin of setup/l1norms.py; semantics of
// hypre_ParCSRComputeL1Norms, ref: src/parcsr_ls/ams.c:628-760).
// option 1: full-row l1; option 4: |a_ii| + 0.5*offproc-l1 with the
// Remark-6.2 truncation; option 5: diagonal (zeros -> 1).
// data is f32 or f64 (is_f32 flag) to avoid a host-side copy.
// ---------------------------------------------------------------------------
void l1_norms(int64_t n, int32_t option, int32_t is_f32,
              const int64_t* indptr, const int32_t* indices,
              const void* data, const uint8_t* offproc_mask,
              double* d) {
  const float* df = (const float*)data;
  const double* dd = (const double*)data;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    double diag = 0.0, sum = 0.0, offp = 0.0;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      const double v = is_f32 ? (double)df[p] : dd[p];
      if (indices[p] == i) diag = v;
      sum += std::abs(v);
      if (offproc_mask && offproc_mask[p]) offp += std::abs(v);
    }
    double r;
    if (option == 5) {
      r = (diag == 0.0) ? 1.0 : diag;
      d[i] = r;
      continue;
    } else if (option == 1) {
      r = sum;
    } else {  // option 4
      r = std::abs(diag) + 0.5 * offp;
      if (r <= (4.0 / 3.0) * std::abs(diag)) r = std::abs(diag);
    }
    if (diag < 0) r = -r;
    if (r == 0.0) r = 1.0;
    d[i] = r;
  }
}


// ---------------------------------------------------------------------------
// PMIS measure: transpose-degree of S plus the splitmix64 hash of the
// global row id (twin of setup/coarsen.py:47-53 + utils.pmis_hash).
// ---------------------------------------------------------------------------
void pmis_measure(int64_t n, int64_t nnz, const int32_t* indices,
                  const int64_t* global_ids, int64_t seed,
                  double* measure) {
  std::vector<int64_t> deg(n, 0);
  // column-degree count: per-thread partials merged (no atomics)
#ifdef _OPENMP
#pragma omp parallel
  {
    std::vector<int64_t> local(n, 0);
#pragma omp for schedule(static)
    for (int64_t p = 0; p < nnz; ++p) ++local[indices[p]];
#pragma omp critical
    for (int64_t i = 0; i < n; ++i) deg[i] += local[i];
  }
#else
  for (int64_t p = 0; p < nnz; ++p) ++deg[indices[p]];
#endif
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    uint64_t z = ((uint64_t)global_ids[i] + (uint64_t)seed) *
                 0x9E3779B97F4A7C15ULL;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    z = z ^ (z >> 31);
    measure[i] = (double)deg[i] +
                 (double)(z >> 11) / 9007199254740992.0;  // 2^53
  }
}

// ---------------------------------------------------------------------------
// ILU(k) / ILUT row factorization (IKJ with dual dropping).
// Independent implementation of the operator semantics of hypre's
// host ILU setup (ref: src/parcsr_ls/par_ilu_setup.c:15,
// hypre_ILUSetupILUK / hypre_ILUSetupILUT): row i is scattered into a
// dense work array, eliminated against previous U rows in ascending
// pivot order, then split/dropped into strict-L (unit diagonal
// implied) and U (diagonal first kept always).
//   is_ilut = 0: level-of-fill dropping, lev(fill) = lev(ik)+lev(kj)+1
//               kept when <= fill_k (classic ILU(k) symbolic+numeric).
//   is_ilut = 1: value dropping at drop_tol * avg|row| and keep the
//               max_keep largest per L/U part (Saad's dual threshold).
// Sequential over rows (true data dependence); stash pattern: pass 0
// factorizes and writes both indptr arrays, pass 1 copies out.
// ---------------------------------------------------------------------------
namespace {
struct IluStash {
  std::vector<int32_t> l_ind, u_ind;
  std::vector<double> l_val, u_val;
  std::vector<int16_t> u_lev;  // fill levels of U entries (ILU(k))
  std::vector<int64_t> l_ptr, u_ptr;
};
IluStash g_ilu;
}  // namespace

extern "C" void ilu_factor(int64_t n, const int64_t* indptr,
                           const int32_t* indices, const double* data,
                           int32_t fill_k, double drop_tol,
                           int32_t max_keep, int32_t is_ilut, int32_t pass,
                           int64_t* l_indptr, int32_t* l_indices,
                           double* l_data, int64_t* u_indptr,
                           int32_t* u_indices, double* u_data) {
  if (pass == 1) {
    std::copy(g_ilu.l_ind.begin(), g_ilu.l_ind.end(), l_indices);
    std::copy(g_ilu.l_val.begin(), g_ilu.l_val.end(), l_data);
    std::copy(g_ilu.u_ind.begin(), g_ilu.u_ind.end(), u_indices);
    std::copy(g_ilu.u_val.begin(), g_ilu.u_val.end(), u_data);
    g_ilu = IluStash();
    return;
  }
  g_ilu = IluStash();
  g_ilu.l_ptr.assign(1, 0);
  g_ilu.u_ptr.assign(1, 0);

  std::vector<double> w(n, 0.0);         // dense work row
  std::vector<int16_t> lev(n, -1);       // fill level per work entry
  std::vector<uint8_t> in_row(n, 0);
  std::vector<int32_t> jw;               // pattern of current row
  std::vector<int32_t> lpart, upart;     // split pattern scratch
  const int16_t KMAX = 30000;

  for (int64_t i = 0; i < n; ++i) {
    jw.clear();
    double rownorm = 0.0;
    int64_t rownnz = indptr[i + 1] - indptr[i];
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      const int32_t j = indices[p];
      w[j] = data[p];
      lev[j] = 0;
      in_row[j] = 1;
      jw.push_back(j);
      rownorm += std::fabs(data[p]);
    }
    const double tau =
        is_ilut ? drop_tol * (rownorm / std::max<int64_t>(rownnz, 1)) : 0.0;
    if (!in_row[i]) {  // ensure a diagonal slot
      w[i] = 0.0; lev[i] = 0; in_row[i] = 1; jw.push_back((int32_t)i);
    }

    // eliminate against previous rows, ascending pivot order (min-heap
    // over the not-yet-processed L-part columns; fills can add new ones)
    std::vector<int32_t> heap;
    for (int32_t j : jw) if (j < i) heap.push_back(j);
    std::make_heap(heap.begin(), heap.end(), std::greater<int32_t>());
    lpart.clear();
    while (!heap.empty()) {
      std::pop_heap(heap.begin(), heap.end(), std::greater<int32_t>());
      const int32_t k = heap.back();
      heap.pop_back();
      const int16_t lev_ik = lev[k];
      // u_val[u_ptr[k]] is the pivot (diagonal stored first in U rows)
      const int64_t ub = g_ilu.u_ptr[k], ue = g_ilu.u_ptr[k + 1];
      const double piv = g_ilu.u_val[ub];
      double lik = w[k] / piv;
      if (is_ilut && std::fabs(lik) < tau) {  // drop small multiplier
        w[k] = 0.0; in_row[k] = 0; lev[k] = -1;
        continue;
      }
      w[k] = lik;
      lpart.push_back(k);
      for (int64_t p = ub + 1; p < ue; ++p) {
        const int32_t j = g_ilu.u_ind[p];
        const int16_t fl = is_ilut
            ? (int16_t)0
            : (int16_t)std::min<int32_t>(
                  lev_ik + (int32_t)g_ilu.u_lev[p] + 1, KMAX);
        if (!in_row[j]) {
          if (!is_ilut && fl > fill_k) continue;  // symbolic drop
          w[j] = -lik * g_ilu.u_val[p];
          lev[j] = fl;
          in_row[j] = 1;
          jw.push_back(j);
          if (j < i) {
            heap.push_back(j);
            std::push_heap(heap.begin(), heap.end(),
                           std::greater<int32_t>());
          }
        } else {
          w[j] -= lik * g_ilu.u_val[p];
          if (!is_ilut && fl < lev[j]) lev[j] = fl;
        }
      }
    }

    // split + drop + store
    upart.clear();
    for (int32_t j : jw)
      if (j > i && in_row[j]) upart.push_back(j);
    if (is_ilut) {
      auto keep_largest = [&](std::vector<int32_t>& part) {
        // drop below tau, then keep the max_keep largest |w|
        size_t m = 0;
        for (size_t q = 0; q < part.size(); ++q)
          if (std::fabs(w[part[q]]) >= tau) part[m++] = part[q];
        part.resize(m);
        if ((int64_t)part.size() > max_keep) {
          std::nth_element(part.begin(), part.begin() + max_keep,
                           part.end(), [&](int32_t a, int32_t b) {
                             return std::fabs(w[a]) > std::fabs(w[b]);
                           });
          part.resize(max_keep);
        }
        std::sort(part.begin(), part.end());
      };
      keep_largest(lpart);
      keep_largest(upart);
    } else {
      std::sort(lpart.begin(), lpart.end());
      std::sort(upart.begin(), upart.end());
    }
    double di = in_row[i] ? w[i] : 0.0;
    if (di == 0.0) di = (rownorm > 0.0 ? 1e-12 * rownorm : 1.0);
    for (int32_t j : lpart) {
      g_ilu.l_ind.push_back(j);
      g_ilu.l_val.push_back(w[j]);
    }
    g_ilu.l_ptr.push_back((int64_t)g_ilu.l_ind.size());
    g_ilu.u_ind.push_back((int32_t)i);   // diagonal first
    g_ilu.u_val.push_back(di);
    g_ilu.u_lev.push_back(0);
    for (int32_t j : upart) {
      g_ilu.u_ind.push_back(j);
      g_ilu.u_val.push_back(w[j]);
      g_ilu.u_lev.push_back(is_ilut ? (int16_t)0 : lev[j]);
    }
    g_ilu.u_ptr.push_back((int64_t)g_ilu.u_ind.size());

    for (int32_t j : jw) { w[j] = 0.0; lev[j] = -1; in_row[j] = 0; }
  }
  std::copy(g_ilu.l_ptr.begin(), g_ilu.l_ptr.end(), l_indptr);
  std::copy(g_ilu.u_ptr.begin(), g_ilu.u_ptr.end(), u_indptr);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Level-scheduled parallel numeric ILU factorization on a FIXED
// pattern.  The parallel-elimination design point of Euclid's PILU
// (ref: src/distributed_ls/Euclid/Euclid_dh.c:127, ilu_mpi_pilu.c):
// the elimination dependency DAG is the L pattern, and every row of
// one wavefront factors concurrently (OpenMP).  Doubles as hypre's
// setup-reuse (keep the symbolic pattern, refresh values for a new A).
// Exact: identical values to the serial IKJ factorization on the same
// pattern.  L = strict lower (unit diag implied), U rows = strict
// upper, udiag = pivots.  Patterns must be column-sorted.
// ---------------------------------------------------------------------------
extern "C" void ilu_refactor(
    int64_t n, const int64_t* a_indptr, const int32_t* a_indices,
    const double* a_data, const int64_t* l_indptr,
    const int32_t* l_indices, const int64_t* u_indptr,
    const int32_t* u_indices, double* l_data, double* udiag,
    double* u_data) {
  std::vector<int32_t> depth(n, 0);
  int32_t maxd = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t d = 0;
    for (int64_t p = l_indptr[i]; p < l_indptr[i + 1]; ++p) {
      const int32_t j = l_indices[p];
      if (depth[j] + 1 > d) d = depth[j] + 1;
    }
    depth[i] = d;
    if (d > maxd) maxd = d;
  }
  // bucket rows by depth (counting sort)
  std::vector<int64_t> lvl_ptr(maxd + 2, 0);
  for (int64_t i = 0; i < n; ++i) ++lvl_ptr[depth[i] + 1];
  for (int32_t d = 0; d < maxd + 1; ++d) lvl_ptr[d + 1] += lvl_ptr[d];
  std::vector<int64_t> rows(n);
  {
    std::vector<int64_t> cur(lvl_ptr.begin(), lvl_ptr.end() - 1);
    for (int64_t i = 0; i < n; ++i) rows[cur[depth[i]]++] = i;
  }

#pragma omp parallel
  {
    std::vector<double> w(n, 0.0);
    std::vector<uint8_t> inpat(n, 0);
    for (int32_t d = 0; d <= maxd; ++d) {
#pragma omp for schedule(dynamic, 64)
      for (int64_t idx = lvl_ptr[d]; idx < lvl_ptr[d + 1]; ++idx) {
        const int64_t i = rows[idx];
        // stamp the row's factor pattern
        for (int64_t p = l_indptr[i]; p < l_indptr[i + 1]; ++p) {
          inpat[l_indices[p]] = 1; w[l_indices[p]] = 0.0;
        }
        for (int64_t p = u_indptr[i]; p < u_indptr[i + 1]; ++p) {
          inpat[u_indices[p]] = 1; w[u_indices[p]] = 0.0;
        }
        inpat[i] = 1; w[i] = 0.0;
        double rownorm = 0.0;
        for (int64_t p = a_indptr[i]; p < a_indptr[i + 1]; ++p) {
          rownorm += std::fabs(a_data[p]);
          if (inpat[a_indices[p]]) w[a_indices[p]] = a_data[p];
        }
        // eliminate in ascending pivot order (L pattern is sorted)
        for (int64_t p = l_indptr[i]; p < l_indptr[i + 1]; ++p) {
          const int32_t j = l_indices[p];
          const double lij = w[j] / udiag[j];
          w[j] = lij;
          for (int64_t q = u_indptr[j]; q < u_indptr[j + 1]; ++q) {
            const int32_t k = u_indices[q];
            if (inpat[k]) w[k] -= lij * u_data[q];
          }
        }
        for (int64_t p = l_indptr[i]; p < l_indptr[i + 1]; ++p)
          l_data[p] = w[l_indices[p]];
        double di = w[i];
        if (di == 0.0) di = (rownorm > 0.0 ? 1e-12 * rownorm : 1.0);
        udiag[i] = di;
        for (int64_t p = u_indptr[i]; p < u_indptr[i + 1]; ++p)
          u_data[p] = w[u_indices[p]];
        // unstamp
        for (int64_t p = l_indptr[i]; p < l_indptr[i + 1]; ++p)
          inpat[l_indices[p]] = 0;
        for (int64_t p = u_indptr[i]; p < u_indptr[i + 1]; ++p)
          inpat[u_indices[p]] = 0;
        inpat[i] = 0;
      }
      // implicit omp-for barrier: udiag/u_data of this level are
      // visible before the next level reads them
    }
  }
}

// ---------------------------------------------------------------------------
// Batched dense solves for the FSAI and ParaSails setups: the port's own
// function, not a copy.  Each system runs LAPACK's getrf, its row swaps
// on the right-hand side, then BLAS's trsm twice (unit lower, upper),
// through the routines' pointers taken from scipy's LAPACK: the calls,
// in the order, that jax's CPU lowering of jnp.linalg.solve makes (lu,
// the pivots' permutation, two triangular_solve), so the solutions are
// the reference's bit for bit.  mats: row-major (batch, k, k), read;
// rhs: (batch, k), overwritten by the solutions; info: getrf's.
// ---------------------------------------------------------------------------
typedef void (*getrf_fn)(int*, int*, double*, int*, int*, int*);
typedef void (*trsm_fn)(char*, char*, char*, char*, int*, int*, double*,
                        double*, int*, double*, int*);

extern "C" void batched_lu_solve(int64_t batch, int32_t k,
                                 const double* mats, double* rhs,
                                 int32_t* info, void* getrf_p,
                                 void* trsm_p) {
  getrf_fn getrf = (getrf_fn)getrf_p;
  trsm_fn trsm = (trsm_fn)trsm_p;
  std::vector<double> a((size_t)k * k);
  std::vector<int> ipiv(k);
  char side = 'L', lower = 'L', upper = 'U', notrans = 'N', unit = 'U',
       nonunit = 'N';
  int n = k, one = 1;
  double alpha = 1.0;
  for (int64_t bi = 0; bi < batch; ++bi) {
    const double* m = mats + bi * k * k;
    for (int i = 0; i < k; ++i)
      for (int j = 0; j < k; ++j) a[(size_t)j * k + i] = m[i * k + j];
    int inf = 0;
    getrf(&n, &n, a.data(), &n, ipiv.data(), &inf);
    double* x = rhs + bi * k;
    for (int i = 0; i < k; ++i) {
      const int p = ipiv[i] - 1;
      if (p != i) std::swap(x[i], x[p]);
    }
    trsm(&side, &lower, &notrans, &unit, &n, &one, &alpha, a.data(), &n, x,
         &n);
    trsm(&side, &upper, &notrans, &nonunit, &n, &one, &alpha, a.data(), &n,
         x, &n);
    info[bi] = inf;
  }
}

// ---------------------------------------------------------------------------
// Entries of a CSR matrix at query pairs (the port's own function): out[q]
// = A[rows[q], cols[q]], 0 where A holds no entry, by a binary search in
// the row's sorted columns, the queries in parallel.  The FSAI and
// ParaSails setups gather their little systems with it; its numpy twin
// is solvers/fsai.py _Lookup's sorted-key search.
// ---------------------------------------------------------------------------
extern "C" void csr_lookup(int64_t n_query, const int64_t* indptr,
                           const int32_t* indices, const double* data,
                           const int64_t* rows, const int64_t* cols,
                           double* out) {
#pragma omp parallel for schedule(static)
  for (int64_t q = 0; q < n_query; ++q) {
    const int32_t* b = indices + indptr[rows[q]];
    const int32_t* e = indices + indptr[rows[q] + 1];
    const int32_t* p = std::lower_bound(b, e, (int32_t)cols[q]);
    out[q] = (p != e && *p == cols[q]) ? data[p - indices] : 0.0;
  }
}
