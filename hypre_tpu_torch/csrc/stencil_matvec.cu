// K1: constant-coefficient stencil matvec, y = A x, on the card.
//
// Replaces the TPU kernel hypre_tpu/ops/stencil_pallas.py
// _stencil_matvec_pallas (pallas_call at :238).  A is the operator
// gen/laplace.stencil_matrix builds: an nx*ny*nz grid ordered x-fastest,
// a constant stencil of at most 27 entries, Dirichlet truncation (an
// arm that leaves the grid is dropped).  Every value is a stencil
// constant or zero, so nothing of A is stored: the entries travel as a
// kernel argument and the boundary masks come from the row index, the
// same masks as stencil_pallas.py:209-222.
//
// Bound: memory.  Only x is read and y written, 16 bytes a row in f64;
// the 7 reads of x per row are neighbours that L1/L2 serve after the
// first touch.  Design: one thread per row, (gx, gy, gz) by division so
// any grid works (the TPU kernel needed power-of-two nx and ny).
//
// C interface (ctypes): pointers and the stream as void*, the entries
// as host arrays copied into the by-value argument.  Each entry
// returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxEntries = 27;
constexpr int kBlock = 256;

template <typename T>
struct Stencil {
  int n;
  int dx[kMaxEntries], dy[kMaxEntries], dz[kMaxEntries];
  T v[kMaxEntries];
};

template <typename T>
__global__ void __launch_bounds__(kBlock)
stencil_matvec_kernel(const T* __restrict__ x, T* __restrict__ y,
                      int64_t nx, int64_t ny, int64_t nz,
                      const Stencil<T> st) {
  const int64_t i = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  const int64_t n = nx * ny * nz;
  if (i >= n) return;
  const int64_t gx = i % nx;
  const int64_t t = i / nx;
  const int64_t gy = t % ny;
  const int64_t gz = t / ny;
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < kMaxEntries; ++k) {
    if (k < st.n) {
      const int64_t ax = gx + st.dx[k], ay = gy + st.dy[k],
                    az = gz + st.dz[k];
      if (ax >= 0 && ax < nx && ay >= 0 && ay < ny && az >= 0 && az < nz)
        acc += st.v[k] * x[i + st.dx[k] + nx * (st.dy[k] + ny * st.dz[k])];
    }
  }
  y[i] = acc;
}

template <typename T>
int launch(const void* x, void* y, int64_t nx, int64_t ny, int64_t nz,
           int n_ent, const int32_t* dxyz, const T* vals, void* stream) {
  if (n_ent < 0 || n_ent > kMaxEntries) return (int)cudaErrorInvalidValue;
  Stencil<T> st;
  st.n = n_ent;
  for (int k = 0; k < kMaxEntries; ++k) {
    const bool on = k < n_ent;
    st.dx[k] = on ? dxyz[3 * k] : 0;
    st.dy[k] = on ? dxyz[3 * k + 1] : 0;
    st.dz[k] = on ? dxyz[3 * k + 2] : 0;
    st.v[k] = on ? vals[k] : T(0);
  }
  const int64_t n = nx * ny * nz;
  if (n > 0) {
    const int64_t blocks = (n + kBlock - 1) / kBlock;
    stencil_matvec_kernel<T><<<(unsigned)blocks, kBlock, 0,
                               (cudaStream_t)stream>>>(
        (const T*)x, (T*)y, nx, ny, nz, st);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int stencil_matvec_f64(const void* x, void* y, int64_t nx, int64_t ny,
                       int64_t nz, int n_ent, const int32_t* dxyz,
                       const double* vals, void* stream) {
  return launch<double>(x, y, nx, ny, nz, n_ent, dxyz, vals, stream);
}

int stencil_matvec_f32(const void* x, void* y, int64_t nx, int64_t ny,
                       int64_t nz, int n_ent, const int32_t* dxyz,
                       const float* vals, void* stream) {
  return launch<float>(x, y, nx, ny, nz, n_ent, dxyz, vals, stream);
}

}  // extern "C"
