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
// Bound: memory.  The least traffic is idx read once (4 bytes an
// (s, i)), Y written once (K elements an (s, i)) and each source entry
// that idx names read once.  What the design does about each:
//
// 1. idx is read once, however large K is.  A warp takes one slot s
//    and 32 V consecutive i (V = 8), lane l the i = base + l + 32 c,
//    c < V; it loads those V indices once (coalesced 128-byte warp
//    loads, evict-first: __ldcs) and then loops over all K source rows,
//    issuing its V gathers of a row before their V stores.  (The kernel
//    this one replaced walked k in its grid, one thread per (k, s, i),
//    and re-read idx K times: in the SpGEMM expansion, with K = B's
//    width, as many idx bytes as Y bytes for an int32 source.)
// 2. The gathers stay coalesced.  Neighbouring lanes hold neighbouring
//    i, whose indices are near each other in the AMG index sets (a
//    slot of consecutive rows), so a warp's gather touches few 32-byte
//    sectors.  A first version gave each lane V consecutive i, to load
//    its indices and store Y with 16-byte accesses; its gathers then
//    spread each warp instruction over 4 times as many sectors, and the
//    SpGEMM expansion ran 2 to 2.3 times slower (PERF.md, Findings).  The idx
//    loads and Y stores here are 4- or 8-byte, each warp instruction a
//    whole 128- or 256-byte line, so they move the same bytes.
// 3. The live source window stays inside the 50 MB L2.  The grid is
//    persistent: kBlocksPerSm blocks an SM (2 x 132 = 264 on an H100)
//    walk the tiles in order, a tile being 8 slots of one i-range of
//    32 V = 256, and the tiles of one i-range are consecutive.  So at
//    most 264 x 8 x 256 = 540k (s, i) are in flight, 540k / S of i, and
//    the blocks, all doing the same work, step through k together.
//    The device setup's expansion at 256^3 (idx = a chunk of P^T's
//    cols, S = 24, K = 18, X = A P's 16.8M-row slots): 22.5k coarse
//    rows in flight, whose sources span about 73k fine rows plus the
//    7-pt stencil's +-1 plane (2 x 65k rows), so K x 200k x 4 bytes =
//    15 MB for the int32 cols and 29 MB for the f64 vals, even if all K
//    rows stay live.  The K = 1 PMIS reads keep one source row (41 MB
//    f64, 21 MB int32, banded).
// 4. Y does not evict the sources: it is written with streaming stores
//    (__stcs, evict-first); the gathers go through __ldg.
//
// idx and X may be row windows of larger arrays (ld_idx, ld_x are their
// row strides in elements; a window such as A.cols[:, c0:c1] starts at
// any c0), and Y rows start at (k S + s) n: every access is one element
// a lane, so no offset needs a head or a tail.  Where idx < 0 the output
// holds `fill` (the reference leaves junk there and its callers mask).
// A gather moves bits, so the kernel is templated on the element size
// only: 1 byte (bool, uint8), 4 (int32, f32) and 8 (int64, f64).  K and
// S have no limit beyond int64 (the grid is one-dimensional and
// persistent).
//
// C interface (ctypes): pointers and the stream as void*, the fill
// value as its bit pattern.  Each entry returns cudaGetLastError()
// after its launch.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                  // slots a tile
constexpr int kBlock = 32 * kWarps;
constexpr int kBlocksPerSm = 2;
constexpr int V = 8;                       // i a lane

template <typename T>
__global__ void __launch_bounds__(kBlock)
btake_kernel(int64_t K, int64_t S, int64_t n, int64_t n_tiles,
             const int32_t* __restrict__ idx, int64_t ld_idx,
             const T* __restrict__ X, int64_t ld_x, T fill,
             T* __restrict__ Y) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t n_sg = (S + kWarps - 1) / kWarps;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    // the tiles of one i-range are consecutive: all its slots at once
    const int64_t s = (tile % n_sg) * kWarps + warp;
    const int64_t base = (tile / n_sg) * (32 * V) + lane;
    if (s >= S) continue;
    const int32_t* row = idx + s * ld_idx;
    int32_t j[V];
#pragma unroll
    for (int c = 0; c < V; ++c) {
      const int64_t i = base + 32 * c;
      j[c] = i < n ? __ldcs(row + i) : -1;
    }
    for (int64_t k = 0; k < K; ++k) {
      const T* xk = X + k * ld_x;
      T v[V];
#pragma unroll
      for (int c = 0; c < V; ++c) v[c] = j[c] < 0 ? fill : __ldg(xk + j[c]);
      T* yk = Y + (k * S + s) * n;
#pragma unroll
      for (int c = 0; c < V; ++c) {
        const int64_t i = base + 32 * c;
        if (i < n) __stcs(yk + i, v[c]);
      }
    }
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                                  dev) != cudaSuccess)
      count = 0;
  }
  return count;
}

template <typename T>
int launch(int64_t K, int64_t S, int64_t n, const void* idx,
           int64_t ld_idx, const void* X, int64_t ld_x, uint64_t fill_bits,
           void* Y, void* stream) {
  if (K <= 0 || S <= 0 || n <= 0) return (int)cudaGetLastError();
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorNoDevice;
  T fill;
  static_assert(sizeof(T) <= sizeof(uint64_t), "element size");
  memcpy(&fill, &fill_bits, sizeof(T));
  const int64_t n_sg = (S + kWarps - 1) / kWarps;
  const int64_t n_tiles = n_sg * ((n + 32 * V - 1) / (32 * V));
  const int64_t cap = (int64_t)sms * kBlocksPerSm;
  const unsigned grid = (unsigned)(n_tiles < cap ? n_tiles : cap);
  btake_kernel<T><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      K, S, n, n_tiles, (const int32_t*)idx, ld_idx, (const T*)X, ld_x,
      fill, (T*)Y);
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
