// K2: general sparse matvec, y = A x, A in CSR, on the card.
//
// Replaces the TPU kernel hypre_tpu/ops/gstell.py gstell_matvec
// (pallas_call resident :746, windowed :812), whose semantics are
// gstell_matvec_reference (:843-853).  The GST-ELL layout existed
// because a TPU gather runs at scalar speed; a GPU gathers x through
// its caches, so the port keeps plain CSR (indptr int64, indices int32,
// values f32 or f64) and serves every stored operator of the AMG solve
// with it: A on the coarse levels, P and R.
//
// Bound: memory.  A's indices and values are streamed once (12 bytes a
// nonzero in f64), x is gathered (banded, so mostly L2 hits) and y
// written once.  What holds such a kernel back is the number of loads
// in flight and the L2: each nonzero costs a load of its column, then a
// dependent gather of x, and the values and indices, read once, pass
// through the same 50 MB L2 that x (41 MB on level 1 of out.14) needs.
//
// Design: a group of G lanes a row (G a power of two in [2, 32], chosen
// by the caller from the mean row nnz, ops/spmv.py group_size), the
// lanes on neighbouring nonzeros so that every load is coalesced.  Each
// lane first loads U = 4 nonzeros' columns and values (indices p, p+G,
// p+2G, p+3G of its row) with evict-first loads (__ldcs), then issues
// their 4 gathers of x (__ldg), then adds the products: a group covers
// 4 G nonzeros an iteration, about two mean rows, so most rows take one
// iteration with all their loads in flight together.  A shuffle inside
// the group sums the row; lane 0 writes y.
//
// The kernel this one replaced had the same groups with one dependent
// load pair a lane at a time and default-policy loads.  Row blocks
// (CSR-stream: a block streams a run of rows' nonzeros with 16-byte
// loads into shared memory and reduces per row) were tried first and
// lost on the operators with long rows, A1 most (PERF.md, Findings).
//
// C interface (ctypes): pointers and the stream as void*.  Each entry
// returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kUnroll = 4;           // nonzeros a lane has in flight

template <typename T, int G>
__global__ void __launch_bounds__(kBlock)
csr_spmv_kernel(int64_t n_rows, const int64_t* __restrict__ indptr,
                const int32_t* __restrict__ indices,
                const T* __restrict__ vals, const T* __restrict__ x,
                T* __restrict__ y) {
  const int64_t tid = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  const int64_t row = tid / G;
  // rows map to whole groups of G lanes, so a group is either all in
  // range or all out of it: the shuffle below never waits on a lane
  // that returned
  if (row >= n_rows) return;
  const int lane = threadIdx.x & (G - 1);
  const unsigned mask =
      G == 32 ? 0xffffffffu
              : (((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1)));
  const int64_t end = indptr[row + 1];
  T sum = T(0);
  for (int64_t p = indptr[row] + lane; p < end; p += G * kUnroll) {
    int32_t c[kUnroll];
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t q = p + u * G;
      c[u] = q < end ? __ldcs(indices + q) : -1;
      v[u] = q < end ? __ldcs(vals + q) : T(0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (c[u] >= 0) sum += v[u] * __ldg(x + c[u]);
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    sum += __shfl_down_sync(mask, sum, off, G);
  if (lane == 0) y[row] = sum;
}

template <typename T, int G>
void launch_g(int64_t n_rows, const void* indptr, const void* indices,
              const void* vals, const void* x, void* y,
              cudaStream_t stream) {
  const int64_t blocks = (n_rows * G + kBlock - 1) / kBlock;
  csr_spmv_kernel<T, G><<<(unsigned)blocks, kBlock, 0, stream>>>(
      n_rows, (const int64_t*)indptr, (const int32_t*)indices,
      (const T*)vals, (const T*)x, (T*)y);
}

template <typename T>
int launch(int64_t n_rows, int group, const void* indptr,
           const void* indices, const void* vals, const void* x, void* y,
           void* stream) {
  if (n_rows <= 0) return (int)cudaGetLastError();
  if ((n_rows * group + kBlock - 1) / kBlock > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (group) {
    case 2: launch_g<T, 2>(n_rows, indptr, indices, vals, x, y, s); break;
    case 4: launch_g<T, 4>(n_rows, indptr, indices, vals, x, y, s); break;
    case 8: launch_g<T, 8>(n_rows, indptr, indices, vals, x, y, s); break;
    case 16: launch_g<T, 16>(n_rows, indptr, indices, vals, x, y, s); break;
    case 32: launch_g<T, 32>(n_rows, indptr, indices, vals, x, y, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K2-NV: Y = A X for a row-major block X of nv columns (ldx apart).
//
// Replaces the same TPU kernel vmapped over columns by
// hypre_tpu/ops/formats.py matmat (:238), LOBPCG's block product.  It
// keeps K2's design (G lanes a row, nonzeros in flight, a shuffle
// inside the group) and loads each nonzero's column and value once for
// all NV columns: the gather of X[c, 0:NV] is one contiguous run.  Each
// lane sums its nonzeros in K2's order and the group reduces as K2
// does, so column k of Y equals K2 on column k bit for bit.  Fewer
// nonzeros are in flight as NV grows (U = 4, 2, 1), which keeps the
// NV sums and U * NV gathered values in registers.  A block of another
// width is launched as pieces of these widths (ops/spmv.py csr_spmm).

template <typename T, int G, int NV>
__global__ void __launch_bounds__(kBlock)
csr_spmm_kernel(int64_t n_rows, const int64_t* __restrict__ indptr,
                const int32_t* __restrict__ indices,
                const T* __restrict__ vals, const T* __restrict__ x,
                int64_t ldx, T* __restrict__ y, int64_t ldy) {
  constexpr int U = NV <= 2 ? 4 : NV <= 4 ? 2 : 1;
  const int64_t tid = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  const int64_t row = tid / G;
  if (row >= n_rows) return;
  const int lane = threadIdx.x & (G - 1);
  const unsigned mask =
      G == 32 ? 0xffffffffu
              : (((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1)));
  const int64_t end = indptr[row + 1];
  T sum[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) sum[k] = T(0);
  for (int64_t p = indptr[row] + lane; p < end; p += G * U) {
    int32_t c[U];
    T v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t q = p + u * G;
      c[u] = q < end ? __ldcs(indices + q) : -1;
      v[u] = q < end ? __ldcs(vals + q) : T(0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (c[u] >= 0) {
        const T* xr = x + (int64_t)c[u] * ldx;
#pragma unroll
        for (int k = 0; k < NV; ++k) sum[k] += v[u] * __ldg(xr + k);
      }
  }
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      sum[k] += __shfl_down_sync(mask, sum[k], off, G);
  if (lane == 0) {
    T* yr = y + row * ldy;
#pragma unroll
    for (int k = 0; k < NV; ++k) yr[k] = sum[k];
  }
}

template <typename T, int G, int NV>
void launch_nv(int64_t n_rows, const void* indptr, const void* indices,
               const void* vals, const void* x, int64_t ldx, void* y,
               int64_t ldy, cudaStream_t stream) {
  const int64_t blocks = (n_rows * G + kBlock - 1) / kBlock;
  csr_spmm_kernel<T, G, NV><<<(unsigned)blocks, kBlock, 0, stream>>>(
      n_rows, (const int64_t*)indptr, (const int32_t*)indices,
      (const T*)vals, (const T*)x, ldx, (T*)y, ldy);
}

template <typename T, int G>
int launch_mm_g(int nv, int64_t n_rows, const void* indptr,
                const void* indices, const void* vals, const void* x,
                int64_t ldx, void* y, int64_t ldy, cudaStream_t s) {
  switch (nv) {
    case 1: launch_nv<T, G, 1>(n_rows, indptr, indices, vals, x, ldx, y, ldy, s); break;
    case 2: launch_nv<T, G, 2>(n_rows, indptr, indices, vals, x, ldx, y, ldy, s); break;
    case 4: launch_nv<T, G, 4>(n_rows, indptr, indices, vals, x, ldx, y, ldy, s); break;
    case 8: launch_nv<T, G, 8>(n_rows, indptr, indices, vals, x, ldx, y, ldy, s); break;
    case 12: launch_nv<T, G, 12>(n_rows, indptr, indices, vals, x, ldx, y, ldy, s); break;
    case 16: launch_nv<T, G, 16>(n_rows, indptr, indices, vals, x, ldx, y, ldy, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_mm(int64_t n_rows, int group, int nv, const void* indptr,
              const void* indices, const void* vals, const void* x,
              int64_t ldx, void* y, int64_t ldy, void* stream) {
  if (n_rows <= 0) return (int)cudaGetLastError();
  if ((n_rows * group + kBlock - 1) / kBlock > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (group) {
    case 2: return launch_mm_g<T, 2>(nv, n_rows, indptr, indices, vals, x, ldx, y, ldy, s);
    case 4: return launch_mm_g<T, 4>(nv, n_rows, indptr, indices, vals, x, ldx, y, ldy, s);
    case 8: return launch_mm_g<T, 8>(nv, n_rows, indptr, indices, vals, x, ldx, y, ldy, s);
    case 16: return launch_mm_g<T, 16>(nv, n_rows, indptr, indices, vals, x, ldx, y, ldy, s);
    case 32: return launch_mm_g<T, 32>(nv, n_rows, indptr, indices, vals, x, ldx, y, ldy, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int csr_spmv_f64(int64_t n_rows, int group, const void* indptr,
                 const void* indices, const void* vals, const void* x,
                 void* y, void* stream) {
  return launch<double>(n_rows, group, indptr, indices, vals, x, y, stream);
}

int csr_spmv_f32(int64_t n_rows, int group, const void* indptr,
                 const void* indices, const void* vals, const void* x,
                 void* y, void* stream) {
  return launch<float>(n_rows, group, indptr, indices, vals, x, y, stream);
}

int csr_spmm_f64(int64_t n_rows, int group, int nv, const void* indptr,
                 const void* indices, const void* vals, const void* x,
                 int64_t ldx, void* y, int64_t ldy, void* stream) {
  return launch_mm<double>(n_rows, group, nv, indptr, indices, vals, x, ldx,
                           y, ldy, stream);
}

int csr_spmm_f32(int64_t n_rows, int group, int nv, const void* indptr,
                 const void* indices, const void* vals, const void* x,
                 int64_t ldx, void* y, int64_t ldy, void* stream) {
  return launch_mm<float>(n_rows, group, nv, indptr, indices, vals, x, ldx,
                          y, ldy, stream);
}

}  // extern "C"
