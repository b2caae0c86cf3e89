// K3: diagonal-storage (DIA) sparse matvec, y = A x, on the card.
//
// Replaces the TPU kernel hypre_tpu/ops/dia_pallas.py dia_matvec_pallas
// (resident `kernel`, pallas_call :171; windowed `kernel_w`, :238),
// whose semantics are formats.dia_matvec (hypre_tpu/ops/formats.py:
// 163-169):
//
//   y[i] = sum_d vals[d, i] * x[i + offsets[d]],  x zero outside [0, n_cols)
//
// with vals (n_diags, n_rows) row-major.  The TPU plan (x laid out as
// (rows, 128), lane rolls per diagonal, band windows and double-buffered
// DMAs) exists because a TPU has no gather; a GPU reads x[i + d] for
// consecutive i as one coalesced run, so none of it is carried over.
// Each row sums its diagonals in offset order, one fma each from zero,
// skipping the terms whose column leaves [0, n_cols).
//
// Bound: memory.  vals is streamed once (8 bytes a diagonal a row in
// f64), x is read and y written once: 72 MB for the 100^3 7-pt operator
// in f64.  Two instances, chosen by the wrapper (ops/dia.py):
//
// * dia_matvec_kernel, at most kMaxDiags diagonals (the path's operators
//   have 7 to 32).  The offsets, their min and max travel in the
//   by-value argument, so no dependent global load precedes a diagonal,
//   and the diagonal loop is unrolled to kMaxDiags (guarded by the
//   count).  A thread takes R consecutive rows (2 in f64, 4 in f32), so
//   vals moves in 16-byte evict-first loads when every diagonal's rows
//   are aligned (n_rows % R == 0; else the scalar instance); x stays in
//   the L2.  A thread issues the loads of kGroup diagonals, vals and x,
//   before the first of their fmas.  A warp whose rows all keep every
//   column inside [0, n_cols) takes the unmasked path, with 16-byte x
//   loads for the diagonals whose offset is a multiple of R; the
//   boundary warps test each term.
// * dia_matvec_wide_kernel, more diagonals: one thread a row, the
//   offsets read from a small int64 array on the card.
//
// C interface (ctypes): pointers and the stream as void*; the offsets
// as the wrapper's packed host int64 array {min, max, offsets...}
// (dia_matvec_*) or a device array of the offsets (dia_matvec_wide_*).
// Each entry returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kMaxDiags = 40;
constexpr int kGroup = 8;          // diagonals whose loads go out together

struct DiaArgs {
  int n;                   // diagonals
  int64_t lo, hi;          // min and max offset
  uint64_t xvec;           // bit d: offset d is a multiple of R
  int64_t off[kMaxDiags];
};

template <typename T, int R> struct Vec;
template <> struct Vec<double, 2> { using type = double2; };
template <> struct Vec<float, 4> { using type = float4; };

// R consecutive values at p: one 16-byte load when kVec (p aligned),
// else R scalar loads; vals are streamed (evict first), x read through
// the read-only path and kept
template <typename T, int R, bool kVec, bool kStream>
__device__ __forceinline__ void load_run(const T* p, T (&v)[R]) {
  if constexpr (kVec) {
    using V = typename Vec<T, R>::type;
    const V w = kStream ? __ldcs(reinterpret_cast<const V*>(p))
                        : __ldg(reinterpret_cast<const V*>(p));
    const T* s = reinterpret_cast<const T*>(&w);
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = s[r];
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r)
      v[r] = kStream ? __ldcs(p + r) : __ldg(p + r);
  }
}

// the sum over every diagonal of rows i0 .. i0 + R - 1 (all < n_rows);
// kMasked tests each term's column
template <typename T, int R, bool kVec, bool kMasked>
__device__ __forceinline__ void dia_rows(int64_t i0, int64_t n_rows,
                                         int64_t n_cols, const T* vals,
                                         const T* x, const DiaArgs& a,
                                         T (&acc)[R]) {
#pragma unroll
  for (int g0 = 0; g0 < kMaxDiags; g0 += kGroup) {
    if (g0 >= a.n) break;
    T v[kGroup][R], xv[kGroup][R];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int d = g0 + g;
      if (d < a.n) {
        load_run<T, R, kVec, true>(vals + d * n_rows + i0, v[g]);
        const int64_t j0 = i0 + a.off[d];
        if constexpr (kMasked) {
#pragma unroll
          for (int r = 0; r < R; ++r)
            xv[g][r] = (j0 + r >= 0 && j0 + r < n_cols) ? __ldg(x + j0 + r)
                                                         : T(0);
        } else if ((a.xvec >> d) & 1) {
          load_run<T, R, kVec, false>(x + j0, xv[g]);
        } else {
          load_run<T, R, false, false>(x + j0, xv[g]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int d = g0 + g;
      if (d < a.n) {
        const int64_t j0 = i0 + a.off[d];
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (!kMasked || (j0 + r >= 0 && j0 + r < n_cols))
            acc[r] = fma(v[g][r], xv[g][r], acc[r]);
      }
    }
  }
}

template <typename T, int R, bool kVec>
__global__ void __launch_bounds__(kBlock)
dia_matvec_kernel(int64_t n_rows, int64_t n_cols, const T* __restrict__ vals,
                  const T* __restrict__ x, T* __restrict__ y,
                  const DiaArgs a) {
  const int64_t i0 = ((int64_t)blockIdx.x * kBlock + threadIdx.x) * R;
  const bool full = i0 + R <= n_rows;
  const bool inner = full && i0 + a.lo >= 0 && i0 + R - 1 + a.hi < n_cols;
  T acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = T(0);
  if (__all_sync(0xffffffffu, inner)) {
    dia_rows<T, R, kVec, false>(i0, n_rows, n_cols, vals, x, a, acc);
  } else if (full) {
    dia_rows<T, R, kVec, true>(i0, n_rows, n_cols, vals, x, a, acc);
  } else if (i0 < n_rows) {
    // the last thread's rows past n_rows (scalar instance only): row by
    // row, each a run of one
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (i0 + r >= n_rows) break;
      T one[1] = {T(0)};
      dia_rows<T, 1, false, true>(i0 + r, n_rows, n_cols, vals, x, a, one);
      acc[r] = one[0];
    }
  } else {
    return;
  }
  if constexpr (kVec) {
    using V = typename Vec<T, R>::type;
    V w;
    T* s = reinterpret_cast<T*>(&w);
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = acc[r];
    *reinterpret_cast<V*>(y + i0) = w;
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (i0 + r < n_rows) y[i0 + r] = acc[r];
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
dia_matvec_wide_kernel(int64_t n_rows, int64_t n_cols, int n_diags,
                       const int64_t* __restrict__ offsets,
                       const T* __restrict__ vals, const T* __restrict__ x,
                       T* __restrict__ y) {
  const int64_t i = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  if (i >= n_rows) return;
  T acc = T(0);
  for (int d = 0; d < n_diags; ++d) {
    const int64_t j = i + __ldg(offsets + d);
    if (j >= 0 && j < n_cols)
      acc = fma(vals[(int64_t)d * n_rows + i], __ldg(x + j), acc);
  }
  y[i] = acc;
}

// packed: the wrapper's argument, {min offset, max offset, offsets...}
template <typename T>
int launch(int64_t n_rows, int64_t n_cols, int n_diags,
           const int64_t* packed, const void* vals, const void* x, void* y,
           void* stream) {
  constexpr int R = 16 / sizeof(T);
  if (n_diags < 0 || n_diags > kMaxDiags || n_rows < 0 || n_cols < 0)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaGetLastError();
  DiaArgs a;
  a.n = n_diags;
  a.lo = packed[0];
  a.hi = packed[1];
  a.xvec = 0;
  for (int d = 0; d < kMaxDiags; ++d) {
    a.off[d] = d < n_diags ? packed[2 + d] : 0;
    if (d < n_diags && a.off[d] % R == 0) a.xvec |= uint64_t(1) << d;
  }
  // 16-byte runs need every diagonal's rows aligned, and x and y too
  const bool vec = n_rows % R == 0 && (uintptr_t)vals % 16 == 0 &&
                   (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0;
  const int64_t threads = (n_rows + R - 1) / R;
  const unsigned blocks = (unsigned)((threads + kBlock - 1) / kBlock);
  const auto s = (cudaStream_t)stream;
  if (vec)
    dia_matvec_kernel<T, R, true><<<blocks, kBlock, 0, s>>>(
        n_rows, n_cols, (const T*)vals, (const T*)x, (T*)y, a);
  else
    dia_matvec_kernel<T, R, false><<<blocks, kBlock, 0, s>>>(
        n_rows, n_cols, (const T*)vals, (const T*)x, (T*)y, a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wide(int64_t n_rows, int64_t n_cols, int n_diags,
                const void* offsets, const void* vals, const void* x,
                void* y, void* stream) {
  if (n_diags < 0 || n_rows < 0 || n_cols < 0)
    return (int)cudaErrorInvalidValue;
  if (n_rows > 0) {
    const int64_t blocks = (n_rows + kBlock - 1) / kBlock;
    dia_matvec_wide_kernel<T><<<(unsigned)blocks, kBlock, 0,
                                (cudaStream_t)stream>>>(
        n_rows, n_cols, n_diags, (const int64_t*)offsets, (const T*)vals,
        (const T*)x, (T*)y);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dia_matvec_f64(int64_t n_rows, int64_t n_cols, int n_diags,
                   const int64_t* packed, const void* vals, const void* x,
                   void* y, void* stream) {
  return launch<double>(n_rows, n_cols, n_diags, packed, vals, x, y,
                        stream);
}

int dia_matvec_f32(int64_t n_rows, int64_t n_cols, int n_diags,
                   const int64_t* packed, const void* vals, const void* x,
                   void* y, void* stream) {
  return launch<float>(n_rows, n_cols, n_diags, packed, vals, x, y,
                       stream);
}

int dia_matvec_wide_f64(int64_t n_rows, int64_t n_cols, int n_diags,
                        const void* offsets, const void* vals, const void* x,
                        void* y, void* stream) {
  return launch_wide<double>(n_rows, n_cols, n_diags, offsets, vals, x, y,
                             stream);
}

int dia_matvec_wide_f32(int64_t n_rows, int64_t n_cols, int n_diags,
                        const void* offsets, const void* vals, const void* x,
                        void* y, void* stream) {
  return launch_wide<float>(n_rows, n_cols, n_diags, offsets, vals, x, y,
                            stream);
}

}  // extern "C"
