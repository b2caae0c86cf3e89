// K2: general sparse matvec, y = A x, A in CSR, on the card; and K2-NV
// (below), the same product over a row-major block of vectors, Y = A X,
// with each column of Y bit for bit K2's on that column of X.
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
// returns cudaGetLastError() after its launch (K2-NV's also refuses,
// with cudaErrorInvalidValue, a block wider than one launch covers).

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

// K2-NV: Y = A X for a row-major block X of nv columns, X's rows ldx
// apart and Y's ldy apart.
//
// Replaces the same TPU kernel vmapped over columns by
// hypre_tpu/ops/formats.py matmat (:238), LOBPCG's block product.
//
// Bound: memory.  The call must move A's indptr, indices and values
// once (12 bytes a nonzero in f64), X once and Y once
// (chip_smoke.py spmm_timing's bound): on LOBPCG's 128^3 7-pt A at
// nv = 12 in f64, 192 MB of A, 201 MB of X and 201 MB of Y.
//
// The first design was K2 with a loop over the columns: G lanes
// a row, each lane loading one nonzero's column and value and then
// gathering X[c, 0:nv] as nv scalar 8-byte loads into nv running sums,
// nv shuffle trees, and lane 0 writing the row of Y in nv scalar
// stores.  The nv sums and gathered values left registers for one
// nonzero in flight a lane at nv >= 8 (U = 4, 2, 1 as nv grew), one
// X row cost nv requests, and three lanes of four idled while lane 0
// stored: 42-43% of the bound at nv = 8 and 12 (PERF.md, Findings).
// Widths outside {1, 2, 4, 8, 12, 16} ran as several launches, each
// reading A again.
//
// A row's group split into G nonzero lanes by C column lanes of one
// 16-byte piece each (G = min(32 / C, K2's group), one row a group)
// was slower still, 21-41% of the bound in f64, its time in
// proportion to its threads over their occupancy: each thread waited
// out three dependent trips to memory (the row's bounds, then its
// columns and values, then X's rows) with little in flight.
//
// Design.  A unit is one 16-byte piece of one row of Y, the W columns
// [c W, c W + W) (W = 2 in f64, 4 in f32), worked by G nonzero lanes
// (a power of two); a row has P = ceil(nv / W) units, at most
// kMaxPieces = 8, so one launch covers 16 columns in f64 and 32 in f32
// (ops/spmv.py nv_panels cuts wider blocks into panels, a launch
// each).  Units are numbered row by row, so neighbouring threads gather
// neighbouring pieces of X's rows (a nonzero's 96-byte run at nv = 12
// in f64 is one request of 6 threads) and store neighbouring pieces of
// Y.  The grid keeps every SM full and no more (resident_blocks); each
// thread walks units a grid's width apart with three in flight: one
// unit's values and X pieces load while the next unit's columns and the
// bounds of the unit after it load, so a step waits about one trip.
// Columns and values load evict-first as in K2; a unit's G lanes
// load U = 2 S nonzeros each a pass, about one mean row (K2's group
// covers two with 4 a lane), and a longer row takes further passes in
// place.  X is gathered and Y stored in 16-byte pieces; a piece that nv
// does not fill, and every piece when X's or Y's rows are not 16-byte
// aligned (vec false), moves in scalar loads and stores.
//
// What holds it now in f64 is not the trips (two to four blocks an SM
// run alike) but, it seems, the traffic between L2 and the SMs: X's
// rows are gathered about seven times each, 1.4 GB at nv = 12 against the
// 594 MB the call must move, and every width runs at about the same
// 5.6-5.8 TB/s of it.  Keeping the next row's X rows in L1 (a thread
// walking neighbouring rows) or in shared memory (a block staging its
// rows' window) cost more than it saved (PERF.md, Findings).
//
// Order of summation: K2's, so that column k of Y is K2 on column k bit
// for bit.  K2 gives the row G_k = group_size lanes (ops/spmv.py); its
// lane j sums the row's nonzeros j, j + G_k, ... in order, and a shuffle
// tree with offsets G_k / 2, ..., 1 adds the lanes.  Here a unit has
// G = G_k / S nonzero lanes, S = min(G_k, kSlots), and each lane keeps
// S slots: lane g's t-th nonzero (g + G t) is K2's lane g + G (t mod S)'s
// and goes to slot t mod S.  The tree's offsets of G and more add
// slots in registers; those below G are shuffles across the lanes.

constexpr int kMaxPieces = 8;        // 16-byte pieces of a row a launch

// one 16-byte piece of a row: W values, moved as one vector load/store
template <typename T>
struct Piece;

template <>
struct Piece<double> {
  static constexpr int W = 2;
  __device__ __forceinline__ static void load(const double* p, double* o) {
    const double2 v = __ldg(reinterpret_cast<const double2*>(p));
    o[0] = v.x;
    o[1] = v.y;
  }
  __device__ __forceinline__ static void store(double* p, const double* o) {
    *reinterpret_cast<double2*>(p) = make_double2(o[0], o[1]);
  }
};

template <>
struct Piece<float> {
  static constexpr int W = 4;
  __device__ __forceinline__ static void load(const float* p, float* o) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* o) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  }
};

// K2 lanes one K2-NV nonzero lane stands for, at most
constexpr int kSlots = 4;
// K2-NV's blocks of 128 threads an SM: four in f64 (at most 128
// registers a thread), five in f32, whose loads in flight take fewer
// (at most 102; a fifth block costs f64 spills and time)
constexpr int kMmBlock = 128;
template <typename T>
constexpr int kMmMinBlocks = sizeof(T) == 4 ? 5 : 4;

// A unit a thread works: its row and piece (stepped a grid's width of
// units at a time, without a division) and the bounds of its lane's
// nonzeros.
struct Unit {
  int64_t row;
  int piece;
  int64_t p, end;   // the row's first nonzero of this lane, its end
};

__device__ __forceinline__ void unit_bounds(Unit& a, int64_t n_rows, int g,
                                            const int64_t* indptr) {
  if (a.row < n_rows) {
    a.p = indptr[a.row] + g;
    a.end = indptr[a.row + 1];
  } else {
    a.p = a.end = 0;
  }
}

__device__ __forceinline__ void unit_step(Unit& a, int64_t srow, int spiece,
                                          int P) {
  a.row += srow;
  a.piece += spiece;
  if (a.piece >= P) {
    a.piece -= P;
    ++a.row;
  }
}

// the columns (-1 past its end) of U nonzeros of a unit's pass from p,
// a lane's nonzeros G apart
template <int G, int U>
__device__ __forceinline__ void pass_columns(int64_t p, int64_t end,
                                             const int32_t* indices,
                                             int32_t (&c)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t q = p + u * G;
    c[u] = q < end ? __ldcs(indices + q) : -1;
  }
}

// their values (0 past the end)
template <typename T, int G, int U>
__device__ __forceinline__ void pass_values(int64_t p, int64_t end,
                                            const T* vals, T (&v)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t q = p + u * G;
    v[u] = q < end ? __ldcs(vals + q) : T(0);
  }
}

// the piece [k0, k0 + W) of X's rows c[0..U) (0 past the end and past
// nv): one 16-byte load a row where `vec` and the piece is whole, else
// value by value
template <typename T, int U>
__device__ __forceinline__ void pass_gather(const int32_t (&c)[U],
                                            const T* x, int64_t ldx, int k0,
                                            int nv, bool vec,
                                            T (&xv)[U][Piece<T>::W]) {
  constexpr int W = Piece<T>::W;
  const int nk = nv - k0;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const T* xr = x + (int64_t)c[u] * ldx + k0;
    if (c[u] >= 0 && vec && nk >= W) {
      Piece<T>::load(xr, xv[u]);
    } else {
#pragma unroll
      for (int w = 0; w < W; ++w)
        xv[u][w] = c[u] >= 0 && w < nk ? __ldg(xr + w) : T(0);
    }
  }
}

template <typename T, int G, int S>
__global__ void __launch_bounds__(kMmBlock, kMmMinBlocks<T>)
csr_spmm_kernel(int64_t n_rows, int nv, int P, bool vec,
                const int64_t* __restrict__ indptr,
                const int32_t* __restrict__ indices,
                const T* __restrict__ vals, const T* __restrict__ x,
                int64_t ldx, T* __restrict__ y, int64_t ldy) {
  constexpr int W = Piece<T>::W;
  constexpr int U = 2 * S;         // nonzeros a lane a pass: a multiple of S
  const int g = threadIdx.x % G;
  const unsigned mask =
      G == 32 ? 0xffffffffu
              : (((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1)));
  // a thread's units are a grid's width of units apart: a step of
  // (srow, spiece)
  const int64_t sweep = (int64_t)gridDim.x * (kMmBlock / G);
  const int64_t srow = sweep / P;
  const int spiece = (int)(sweep % P);
  const int64_t u0 = (int64_t)blockIdx.x * (kMmBlock / G) + threadIdx.x / G;
  // three units in flight: C's columns loaded, B's bounds loaded; a
  // step gathers C's values and X pieces, loads B's columns and A's
  // bounds, then sums C
  Unit C = {u0 / P, (int)(u0 % P), 0, 0};
  unit_bounds(C, n_rows, g, indptr);
  Unit B = C;
  unit_step(B, srow, spiece, P);
  unit_bounds(B, n_rows, g, indptr);
  int32_t cC[U], cB[U];
  pass_columns<G, U>(C.p, C.end, indices, cC);
  while (C.row < n_rows) {
    const int k0 = C.piece * W;      // C's first column
    const int nk = nv - k0;          // its columns: min(nk, W)
    T vC[U], xv[U][W];
    pass_values<T, G, U>(C.p, C.end, vals, vC);
    pass_gather<T, U>(cC, x, ldx, k0, nv, vec, xv);
    pass_columns<G, U>(B.p, B.end, indices, cB);
    Unit A = B;
    unit_step(A, srow, spiece, P);
    unit_bounds(A, n_rows, g, indptr);
    // slot j: the nonzeros of K2's lane g + G j, in K2's order
    T sum[S][W];
#pragma unroll
    for (int j = 0; j < S; ++j)
#pragma unroll
      for (int w = 0; w < W; ++w) sum[j][w] = T(0);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (cC[u] >= 0)
#pragma unroll
        for (int w = 0; w < W; ++w) sum[u % S][w] += vC[u] * xv[u][w];
    // the rest of a long row, a pass at a time
    for (int64_t p = C.p + G * U; p < C.end; p += G * U) {
      pass_columns<G, U>(p, C.end, indices, cC);
      pass_values<T, G, U>(p, C.end, vals, vC);
      pass_gather<T, U>(cC, x, ldx, k0, nv, vec, xv);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (cC[u] >= 0)
#pragma unroll
          for (int w = 0; w < W; ++w) sum[u % S][w] += vC[u] * xv[u][w];
    }
    // K2's tree: offsets G S / 2 .. G add slots, G / 2 .. 1 nonzero lanes
#pragma unroll
    for (int s = S / 2; s > 0; s >>= 1)
#pragma unroll
      for (int j = 0; j < s; ++j)
#pragma unroll
        for (int w = 0; w < W; ++w) sum[j][w] += sum[j + s][w];
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
#pragma unroll
      for (int w = 0; w < W; ++w)
        sum[0][w] += __shfl_down_sync(mask, sum[0][w], off, G);
    if (g == 0 && nk > 0) {
      T* yr = y + C.row * ldy + k0;
      if (vec && nk >= W) {
        Piece<T>::store(yr, sum[0]);
      } else {
#pragma unroll
        for (int w = 0; w < W; ++w)
          if (w < nk) yr[w] = sum[0][w];
      }
    }
    C = B;
    B = A;
#pragma unroll
    for (int u = 0; u < U; ++u) cC[u] = cB[u];
  }
}

// the grid that keeps every SM full of K2-NV's blocks, one a device
template <typename T, int G, int S>
int64_t resident_blocks() {
  static int64_t cap[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 0;
  if (cap[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, csr_spmm_kernel<T, G, S>, kMmBlock, 0);
    cap[dev] = (int64_t)sms * per_sm;
  }
  return cap[dev];
}

template <typename T, int GK>
int launch_mm_gk(int64_t n_rows, int nv, int P, bool vec, const void* indptr,
                 const void* indices, const void* vals, const void* x,
                 int64_t ldx, void* y, int64_t ldy, cudaStream_t s) {
  constexpr int S = GK < kSlots ? GK : kSlots;
  constexpr int G = GK / S;
  const int64_t cap = resident_blocks<T, G, S>();
  if (cap <= 0) return (int)cudaErrorInvalidValue;
  const int64_t need = (n_rows * P * G + kMmBlock - 1) / kMmBlock;
  const int64_t blocks = need < cap ? need : cap;
  csr_spmm_kernel<T, G, S><<<(unsigned)blocks, kMmBlock, 0, s>>>(
      n_rows, nv, P, vec, (const int64_t*)indptr, (const int32_t*)indices,
      (const T*)vals, (const T*)x, ldx, (T*)y, ldy);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_mm(int64_t n_rows, int group, int nv, const void* indptr,
              const void* indices, const void* vals, const void* x,
              int64_t ldx, void* y, int64_t ldy, void* stream) {
  constexpr int W = Piece<T>::W;
  if (nv < 0 || nv > kMaxPieces * W || ldx < 0 || ldy < 0)
    return (int)cudaErrorInvalidValue;
  if (n_rows <= 0 || nv == 0) return (int)cudaGetLastError();
  const int P = (nv + W - 1) / W;
  // 16-byte pieces need every row of X and Y on a 16-byte boundary
  const bool vec =
      ((reinterpret_cast<std::uintptr_t>(x) |
        reinterpret_cast<std::uintptr_t>(y)) & 15) == 0 &&
      ldx % W == 0 && ldy % W == 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (group) {
    case 2: return launch_mm_gk<T, 2>(n_rows, nv, P, vec, indptr, indices, vals, x, ldx, y, ldy, s);
    case 4: return launch_mm_gk<T, 4>(n_rows, nv, P, vec, indptr, indices, vals, x, ldx, y, ldy, s);
    case 8: return launch_mm_gk<T, 8>(n_rows, nv, P, vec, indptr, indices, vals, x, ldx, y, ldy, s);
    case 16: return launch_mm_gk<T, 16>(n_rows, nv, P, vec, indptr, indices, vals, x, ldx, y, ldy, s);
    case 32: return launch_mm_gk<T, 32>(n_rows, nv, P, vec, indptr, indices, vals, x, ldx, y, ldy, s);
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
