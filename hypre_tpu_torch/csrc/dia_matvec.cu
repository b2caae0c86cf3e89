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
//
// Bound: memory.  vals is streamed once (8 bytes a diagonal a row in
// f64), x is read and y written once: 72 MB for the 100^3 7-pt operator
// in f64.  Design: one thread per row, looping over the diagonals in
// offset order (the plain version's order, one FMA each).  At each
// diagonal consecutive threads read consecutive vals[d, .] and
// x[. + off], so every access is coalesced, and x (8 MB at 100^3) stays
// in the 50 MB L2 across the diagonals.  Reads of x outside [0, n_cols)
// are masked: the first and last planes and rectangular operators reach
// past either end.  vals is indexed in 64 bits (d * n_rows + i).
//
// C interface (ctypes): pointers and the stream as void*; the offsets
// are a small int64 array on the card.  Each entry returns
// cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

template <typename T>
__global__ void __launch_bounds__(kBlock)
dia_matvec_kernel(int64_t n_rows, int64_t n_cols, int n_diags,
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

template <typename T>
int launch(int64_t n_rows, int64_t n_cols, int n_diags, const void* offsets,
           const void* vals, const void* x, void* y, void* stream) {
  if (n_diags < 0) return (int)cudaErrorInvalidValue;
  if (n_rows > 0) {
    const int64_t blocks = (n_rows + kBlock - 1) / kBlock;
    dia_matvec_kernel<T><<<(unsigned)blocks, kBlock, 0,
                           (cudaStream_t)stream>>>(
        n_rows, n_cols, n_diags, (const int64_t*)offsets, (const T*)vals,
        (const T*)x, (T*)y);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dia_matvec_f64(int64_t n_rows, int64_t n_cols, int n_diags,
                   const void* offsets, const void* vals, const void* x,
                   void* y, void* stream) {
  return launch<double>(n_rows, n_cols, n_diags, offsets, vals, x, y,
                        stream);
}

int dia_matvec_f32(int64_t n_rows, int64_t n_cols, int n_diags,
                   const void* offsets, const void* vals, const void* x,
                   void* y, void* stream) {
  return launch<float>(n_rows, n_cols, n_diags, offsets, vals, x, y,
                       stream);
}

}  // extern "C"
