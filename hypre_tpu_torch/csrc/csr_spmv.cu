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
// nonzero in f64), x is gathered (banded, so mostly cache hits) and y
// written once.  Design: a fixed group of G threads per row, as hypre's
// device SpMV picks by mean row nnz (csr_spmv_device.c:300-306); the
// group strides over the row so neighbouring threads read neighbouring
// nonzeros, and a shuffle reduction inside the group gives the row sum.
// G is a template argument chosen by the caller from the mean row nnz.
//
// C interface (ctypes): pointers and the stream as void*.  Each entry
// returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

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
  for (int64_t p = indptr[row] + lane; p < end; p += G)
    sum += vals[p] * __ldg(x + indices[p]);
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

}  // extern "C"
