// K4: multi-source gather, Y[k, s, i] = X[k, idx[s, i]], on the card.
//
// Replaces the TPU kernel hypre_tpu/ops/btake.py _btake_pallas
// (pallas_call resident :317, windowed :389), whose semantics are
// jnp.take (btake.py:443-452).  On the TPU a gather runs at scalar
// speed, so that kernel needs a plan: 128-row window bases per slot,
// int16 lane offsets, banded window DMA and an (8, 128) lane shuffle
// (btake.py:58-259).  A GPU gathers through L1/L2, so none of that is
// carried over: the index set is read as it is.
//
// Bound: memory.  idx is read (4 bytes an element), Y written once
// (K elements an index), and X read at least once; the AMG index sets
// are banded, so the sources' lines are reused from L1/L2.  Design: one
// thread per (k, s, i), with blockIdx.z = k, blockIdx.y = s and adjacent
// threads on adjacent i, so idx reads and Y writes are coalesced.  k is
// the outermost grid dimension, so the card works through one source
// row at a time: the band of X that a chunk names stays in the 50 MB L2
// (a thread looping over all K rows kept K bands in flight and ran at
// half index_select's speed for K = 18).  idx is re-read for each k,
// mostly from L2.  Where idx < 0 the thread writes `fill` (the
// reference leaves junk there and its callers mask).
// A gather moves bits, so the kernel is templated on the element size
// only: 1 byte (bool, uint8), 4 (int32, f32) and 8 (int64, f64).
//
// idx and X may be row windows of larger arrays: ld_idx and ld_x are
// their row strides in elements; Y is contiguous (K, S, n).
//
// C interface (ctypes): pointers and the stream as void*, the fill
// value as its bit pattern.  Each entry returns cudaGetLastError()
// after its launch.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

template <typename T>
__global__ void __launch_bounds__(kBlock)
btake_kernel(int64_t S, int64_t n,
             const int32_t* __restrict__ idx, int64_t ld_idx,
             const T* __restrict__ X, int64_t ld_x, T fill,
             T* __restrict__ Y) {
  const int64_t i = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const int64_t s = blockIdx.y;
  const int64_t k = blockIdx.z;
  const int32_t j = idx[s * ld_idx + i];
  Y[(k * S + s) * n + i] = j < 0 ? fill : __ldg(X + k * ld_x + j);
}

template <typename T>
int launch(int64_t K, int64_t S, int64_t n, const void* idx,
           int64_t ld_idx, const void* X, int64_t ld_x, uint64_t fill_bits,
           void* Y, void* stream) {
  if (K <= 0 || S <= 0 || n <= 0) return (int)cudaGetLastError();
  if (S > 65535 || K > 65535) return (int)cudaErrorInvalidValue;
  T fill;
  static_assert(sizeof(T) <= sizeof(uint64_t), "element size");
  memcpy(&fill, &fill_bits, sizeof(T));
  dim3 grid((unsigned)((n + kBlock - 1) / kBlock), (unsigned)S,
            (unsigned)K);
  btake_kernel<T><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      S, n, (const int32_t*)idx, ld_idx, (const T*)X, ld_x, fill, (T*)Y);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int btake_1(int64_t K, int64_t S, int64_t n, const void* idx,
            int64_t ld_idx, const void* X, int64_t ld_x, uint64_t fill,
            void* Y, void* stream) {
  return launch<unsigned char>(K, S, n, idx, ld_idx, X, ld_x, fill, Y,
                             stream);
}

int btake_4(int64_t K, int64_t S, int64_t n, const void* idx,
            int64_t ld_idx, const void* X, int64_t ld_x, uint64_t fill,
            void* Y, void* stream) {
  return launch<unsigned int>(K, S, n, idx, ld_idx, X, ld_x, fill, Y,
                            stream);
}

int btake_8(int64_t K, int64_t S, int64_t n, const void* idx,
            int64_t ld_idx, const void* X, int64_t ld_x, uint64_t fill,
            void* Y, void* stream) {
  return launch<unsigned long long>(K, S, n, idx, ld_idx, X, ld_x, fill, Y,
                                  stream);
}

}  // extern "C"
