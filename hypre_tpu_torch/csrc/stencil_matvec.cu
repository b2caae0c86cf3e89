// K1: constant-coefficient stencil matvec, y = A x, on the card.
//
// Replaces the TPU kernel hypre_tpu/ops/stencil_pallas.py
// _stencil_matvec_pallas (pallas_call at :238).  A is the operator
// gen/laplace.stencil_matrix builds: an nx*ny*nz grid ordered x-fastest,
// a constant stencil of at most 27 entries, Dirichlet truncation (an
// arm that leaves the grid is dropped).  Every value is a stencil
// constant or zero, so nothing of A is stored: the entries travel in
// the kernel's by-value argument.  Each row sums its arms in the
// entries' order, one fma each from zero (the order of
// stencil_matvec_reference).
//
// Bound: memory.  Only x is read and y written, 16 bytes a row in f64.
// Two instances, chosen by the wrapper from the stencil's reach and the
// grid (ops/stencil.py kernel_instance):
//
// * stencil_matvec_tile_kernel, reach 1 (every generator of
//   gen/laplace.py).  A block of 32 x 8 threads (x fastest, so loads
//   coalesce) owns an x-y tile of 32 x 16 cells, two rows a thread, and
//   marches along z over chunks of 16 planes.  Each plane of the tile,
//   with a one-cell halo, is staged in shared memory by cp.async, in a
//   ring of 8 planes (f64) or 16 (f32): 5 or 13 planes in flight, the
//   same bytes in either type, while a step reads the three it needs.
//   In f32, where rows are 16-byte aligned (nx % 4 == 0: the stride
//   rule a TMA copy would impose too), a row's interior moves in
//   16-byte copies; f64 and other grids move cell by cell, in the same
//   kernel template.  Cells outside the grid are zero-filled by the copy
//   itself, so truncation costs no test in the inner loop (a zero arm
//   adds v * 0 = 0 exactly).  A thread reads its arms at byte offsets
//   the host computed per ring slot, one offset serving both its rows,
//   seven arms' reads issued before their fmas.  One barrier a step.
//   No division, 32-bit indices within a plane, each x element read
//   from HBM about once; at most 64 registers, so four blocks share an
//   SM.
// * stencil_matvec_row_kernel, any reach or a grid past the tile
//   kernel's limits: one thread a row, (gx, gy, gz) by division,
//   64-bit indices, each arm tested against the grid.
//
// C interface (ctypes): pointers and the stream as void*, the instance
// as an int, the entries as host arrays copied into the by-value
// argument.  Each entry returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxEntries = 27;

// ---- tile kernel (reach 1) ----
constexpr int kTx = 32, kTy = 8;            // threads of a block
constexpr int kRows = 2;                    // y rows a thread
constexpr int kThreads = kTx * kTy;
constexpr int kHx = kTx + 2;                // the tile with its halo
constexpr int kHy = kTy * kRows + 2;
constexpr int kMaxRing = 16;
constexpr int kCopies = (kHx * kHy + kThreads - 1) / kThreads;  // a thread
constexpr int kGroup = 7;                   // arms read before their fmas
constexpr int kMinBlocks = 4;               // blocks an SM (<= 64 regs)
constexpr int kZChunk = 16;                 // planes a block, at least
constexpr int kMaxGrid = 65535;             // gridDim.y and .z

// A row of the staged tile holds the 32 interior cells from a 16-byte
// boundary (column kPad), its halo cells beside them: pitch 36 cells in
// f64, 40 in f32.  Planes in the ring: 8 in f64, 16 in f32, the same
// bytes in flight in either type.
template <typename T> constexpr int kPad = 16 / sizeof(T);
template <typename T> constexpr int kPitch = kTx + 2 * kPad<T>;
template <typename T> constexpr int kPlane = kPitch<T> * kHy;
template <typename T> constexpr int kRingOf = sizeof(T) == 8 ? 8 : 16;

template <typename T>
struct TileArms {
  int n;
  // off[c][k]: byte offset of arm k from the thread's first cell in
  // ring slot 0, when the centre plane sits in slot c; an absent arm
  // (k >= n) points at the centre cell and is not summed
  int off[kMaxRing][kMaxEntries];
  T v[kMaxEntries];
};

// global -> shared without registers, `B` bytes, zero-filled when !in
template <int B>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (B == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(in ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(d), "l"(src), "n"(B), "r"(in ? B : 0) : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's newest copy groups are pending
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// kWide: rows are 16-byte aligned (nx * sizeof(T) % 16 == 0, x aligned),
// so a row's interior moves in 16-byte copies, its two halo cells one
// by one; else every cell moves alone
template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
stencil_matvec_tile_kernel(const T* __restrict__ x, T* __restrict__ y,
                           int nx, int ny, int nz, int zc,
                           const __grid_constant__ TileArms<T> a) {
  constexpr int kRing = kRingOf<T>;
  constexpr int kAhead = kRing - 3;         // planes in flight
  constexpr int kP = kPitch<T>, kPl = kPlane<T>, kE = kPad<T>;
  constexpr int kChunks = kWide ? kHy * (kTx / kE) : 0;  // 16-byte copies
  constexpr int kSingles = kWide ? 2 * kHy : kHx * kHy;  // one-cell copies
  __shared__ __align__(16) T ring[kRing * kPl];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int t = ty * kTx + tx;
  const int x0 = blockIdx.x * kTx, y0 = blockIdx.y * (kTy * kRows);
  const int z0 = blockIdx.z * zc;
  const int zlen = min(zc, nz - z0);
  const int64_t plane = (int64_t)nx * ny;
  // this thread's copies of a plane: in-plane source (-1: outside the
  // grid, zero-filled), ring cell (-1: none), 16 bytes or one cell
  int src[kCopies], dst[kCopies];
  bool wide[kCopies];
#pragma unroll
  for (int c = 0; c < kCopies; ++c) {
    const int e = t + c * kThreads;
    int row, gx, col;
    if (e < kChunks) {
      row = e / (kTx / kE);
      gx = x0 + e % (kTx / kE) * kE;
      col = kE + gx - x0;
    } else if (kWide) {
      const int h = e - kChunks;
      row = h >> 1;
      gx = h & 1 ? x0 + kTx : x0 - 1;
      col = kE + gx - x0;
    } else {
      row = e / kHx;
      gx = x0 - 1 + e % kHx;
      col = kE - 1 + e % kHx;
    }
    const int gy = y0 - 1 + row;
    const bool any = e < kChunks + kSingles;
    wide[c] = e < kChunks;
    dst[c] = any ? row * kP + col : -1;
    src[c] = (any && gx >= 0 && gx < nx && gy >= 0 && gy < ny)
                 ? gy * nx + gx : -1;
  }
  // plane z (z0 - 1 <= z) into ring slot `slot`, one copy group; planes
  // past z0 + zlen are not needed and only close an empty group
  auto stage = [&](int z, int slot) {
    if (z <= z0 + zlen) {
      const bool zin = z >= 0 && z < nz;
      const T* xp = x + (zin ? (int64_t)z * plane : 0);
#pragma unroll
      for (int c = 0; c < kCopies; ++c) {
        if (dst[c] < 0) continue;
        const bool in = zin && src[c] >= 0;
        T* d = &ring[slot * kPl + dst[c]];
        const T* g = in ? xp + src[c] : x;
        if (kWide && wide[c])
          copy_async<16>(d, g, in);
        else
          copy_async<sizeof(T)>(d, g, in);
      }
    }
    commit_copies();
  };
  // ring slot p % kRing holds plane z0 - 1 + p; planes 0 .. kAhead + 1
  // go out before the first step
#pragma unroll
  for (int p = 0; p < kAhead + 2; ++p) stage(z0 - 1 + p, p);
  const int gx = x0 + tx, gy = y0 + kRows * ty;
  const char* me = reinterpret_cast<const char*>(
      ring + (kRows * ty + 1) * kP + kE + tx);
  T* yp = y + (int64_t)z0 * plane + (int64_t)gy * nx + gx;
  const bool out0 = gx < nx && gy < ny, out1 = gx < nx && gy + 1 < ny;
  for (int j = 0; j < zlen; ++j) {
    // step j reads planes j .. j + 2; the newer kAhead - 1 groups may
    // still be in flight
    wait_copies<kAhead - 1>();
    __syncthreads();
    // plane j + kAhead + 2 into the slot plane j - 1 left (last read in
    // the step before this barrier)
    stage(z0 + j + kAhead + 1, (j + kAhead + 2) % kRing);
    const int c = (j + 1) % kRing;
    T acc0 = T(0), acc1 = T(0);
#pragma unroll
    for (int g0 = 0; g0 < kMaxEntries; g0 += kGroup) {
      if (g0 >= a.n) break;
      T v0[kGroup], v1[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup && g0 + g < kMaxEntries; ++g) {
        const char* p = me + a.off[c][g0 + g];
        v0[g] = *reinterpret_cast<const T*>(p);
        v1[g] = *reinterpret_cast<const T*>(p + kP * sizeof(T));
      }
#pragma unroll
      for (int g = 0; g < kGroup && g0 + g < kMaxEntries; ++g) {
        if (g0 + g < a.n) {
          acc0 = fma(a.v[g0 + g], v0[g], acc0);
          acc1 = fma(a.v[g0 + g], v1[g], acc1);
        }
      }
    }
    if (out0) yp[(int64_t)j * plane] = acc0;
    if (out1) yp[(int64_t)j * plane + nx] = acc1;
  }
  wait_copies<0>();
}

// ---- row kernel (any reach) ----
constexpr int kBlock = 256;

template <typename T>
struct Stencil {
  int n;
  int dx[kMaxEntries], dy[kMaxEntries], dz[kMaxEntries];
  T v[kMaxEntries];
};

template <typename T>
__global__ void __launch_bounds__(kBlock)
stencil_matvec_row_kernel(const T* __restrict__ x, T* __restrict__ y,
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
        acc = fma(st.v[k],
                  x[i + st.dx[k] + nx * (st.dy[k] + ny * st.dz[k])], acc);
    }
  }
  y[i] = acc;
}

template <typename T>
int launch_tile(const T* x, T* y, int64_t nx, int64_t ny, int64_t nz,
                int n_ent, const int32_t* dxyz, const T* vals,
                cudaStream_t stream) {
  constexpr int kRing = kRingOf<T>;
  const int64_t tiles_y = (ny + kTy * kRows - 1) / (kTy * kRows);
  if (nx * ny >= (int64_t(1) << 31) || tiles_y > kMaxGrid ||
      nz >= (int64_t(1) << 31))
    return (int)cudaErrorInvalidValue;
  TileArms<T> a;
  a.n = n_ent;
  for (int k = 0; k < kMaxEntries; ++k) {
    const bool on = k < n_ent;
    const int dx = on ? dxyz[3 * k] : 0, dy = on ? dxyz[3 * k + 1] : 0,
              dz = on ? dxyz[3 * k + 2] : 0;
    if (dx < -1 || dx > 1 || dy < -1 || dy > 1 || dz < -1 || dz > 1)
      return (int)cudaErrorInvalidValue;
    for (int c = 0; c < kMaxRing; ++c)
      a.off[c][k] = (int)sizeof(T) * ((c + dz + kRing) % kRing * kPlane<T>
                                      + dy * kPitch<T> + dx);
    a.v[k] = on ? vals[k] : T(0);
  }
  int64_t zc = (nz + kMaxGrid - 1) / kMaxGrid;
  if (zc < kZChunk) zc = kZChunk;
  const dim3 grid((unsigned)((nx + kTx - 1) / kTx), (unsigned)tiles_y,
                  (unsigned)((nz + zc - 1) / zc));
  // 16-byte staging in f32 only: measured on the H100 at 256^3 it cut
  // f32 from 0.073 to 0.063 ms but slowed f64 from 0.101 to 0.113 ms
  const bool wide = sizeof(T) == 4 && nx * (int64_t)sizeof(T) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (wide)
    stencil_matvec_tile_kernel<T, true><<<grid, dim3(kTx, kTy), 0,
                                          stream>>>(
        x, y, (int)nx, (int)ny, (int)nz, (int)zc, a);
  else
    stencil_matvec_tile_kernel<T, false><<<grid, dim3(kTx, kTy), 0,
                                           stream>>>(
        x, y, (int)nx, (int)ny, (int)nz, (int)zc, a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_row(const T* x, T* y, int64_t nx, int64_t ny, int64_t nz,
               int n_ent, const int32_t* dxyz, const T* vals,
               cudaStream_t stream) {
  Stencil<T> st;
  st.n = n_ent;
  for (int k = 0; k < kMaxEntries; ++k) {
    const bool on = k < n_ent;
    st.dx[k] = on ? dxyz[3 * k] : 0;
    st.dy[k] = on ? dxyz[3 * k + 1] : 0;
    st.dz[k] = on ? dxyz[3 * k + 2] : 0;
    st.v[k] = on ? vals[k] : T(0);
  }
  const int64_t blocks = (nx * ny * nz + kBlock - 1) / kBlock;
  stencil_matvec_row_kernel<T><<<(unsigned)blocks, kBlock, 0, stream>>>(
      x, y, nx, ny, nz, st);
  return (int)cudaGetLastError();
}

// tile: 1 for the tile kernel, 0 for the row kernel
template <typename T>
int launch(const void* x, void* y, int64_t nx, int64_t ny, int64_t nz,
           int tile, int n_ent, const int32_t* dxyz, const T* vals,
           void* stream) {
  if (n_ent < 0 || n_ent > kMaxEntries || nx < 0 || ny < 0 || nz < 0)
    return (int)cudaErrorInvalidValue;
  if (nx * ny * nz == 0) return (int)cudaGetLastError();
  const auto s = (cudaStream_t)stream;
  return tile ? launch_tile<T>((const T*)x, (T*)y, nx, ny, nz, n_ent,
                               dxyz, vals, s)
              : launch_row<T>((const T*)x, (T*)y, nx, ny, nz, n_ent, dxyz,
                              vals, s);
}

}  // namespace

extern "C" {

int stencil_matvec_f64(const void* x, void* y, int64_t nx, int64_t ny,
                       int64_t nz, int tile, int n_ent, const int32_t* dxyz,
                       const double* vals, void* stream) {
  return launch<double>(x, y, nx, ny, nz, tile, n_ent, dxyz, vals, stream);
}

int stencil_matvec_f32(const void* x, void* y, int64_t nx, int64_t ny,
                       int64_t nz, int tile, int n_ent, const int32_t* dxyz,
                       const float* vals, void* stream) {
  return launch<float>(x, y, nx, ny, nz, tile, n_ent, dxyz, vals, stream);
}

}  // extern "C"
