// Kernel A: Doppler evaluation of natural cubic splines at fractional
// knot indices, in float (float32) and in double (float64, the card's
// working type).
//
// Replaces the Pallas TPU kernel rvspecfit_tpu/ops/pallas_spline.py
// (_kernel, driven by _eval_packed; entry points
// spline_eval_index_pallas and spline_eval_index_pallas_shared).
//
// What it computes, per output element (row r, pixel p):
//   i = clip(floor(u), 0, n-2), f = u - i
//   log grid:    dxl = x_i expm1(f step), dxr = x_i (expm1(step) - expm1(f step)),
//                x_i = x0 exp(i step)
//   linear grid: dxl = f step, dxr = (1 - f) step
//   out = A dxl^3 + B dxr^3 + C dxl + D dxr, (A,B,C,D) = coeffs[c, :, i]
// with c = r / rows_per_coeff: 1 for per-row coefficients (optimizer
// trials), V when V query rows (velocities) share one fiber's
// coefficient row.  Coefficients are never broadcast in memory.
//
// Element types: every kernel here is a template on T, float or double,
// and both are built (rvst_*: float, rvst_*_f64: double).  The index
// arithmetic stays 32-bit in both; the math takes T's functions
// (floor/exp/expm1 for double, floorf/expf/expm1f for float).
//
// What bounds it on the H100: memory traffic.  Per element it reads u
// and writes out (4 + 4 B in float, 8 + 8 B in double) against ~30
// flops; the coefficients add 4 sizeof(T) B per knot that the queries
// touch.  Shared mode at the refine scan's shape (200500 x 1024, 500
// coefficient rows) moves 1.654 GB in float (0.49 ms at 3.35 TB/s),
// twice that in double.
//
// Design: a 2-D grid of 1024-pixel tiles x row blocks, with a
// grid-stride loop over row blocks; each thread evaluates 4 consecutive
// pixels with 16-byte streaming loads of u and stores of out (one float4,
// or two double2; streaming, so they do not evict the coefficients from
// L2), and a scalar path for a row that is not 16-byte aligned or the
// tail of npix % 4 != 0.  The row -> coefficient-row division is done
// once per row (per-row kernel) or once per block (shared kernel).
// * Per-row mode (rows_per_coeff < STAGE_MIN_ROWS): read-only gathers
//   straight from the coefficient row, near-coalesced because u
//   increases along p.
// * Shared mode: a block owns up to 32 rows of one coefficient row
//   (401 rows make 13 blocks: enough blocks that the last wave is
//   short, few enough that staging stays under ~10% of the traffic).
//   It takes the knot window its rows touch from the first and last
//   columns of its tile (u is monotone along p), stages it in shared
//   memory as (A, B, C, D) per knot with x_i beside it (so the
//   per-element exp goes; expm1(f step) stays), and evaluates its
//   rows from shared memory, loading 4 rows' u before it evaluates
//   them.  A query outside the staged window (u not monotone, or a
//   window wider than WINDOW_MAX) gathers from device memory instead,
//   so the result never depends on the window.  The window takes
//   WINDOW_MAX (4 + 1) sizeof(T) bytes: 35.8 KB in float (6 blocks of
//   256 threads an SM), 71.7 KB in double (3 blocks an SM, after the
//   launcher raises the block's dynamic shared-memory limit).
// None of the TPU's devices are needed: no one-hot MXU gather, no
// 128-lane window rounding, no Taylor expm1, no row/tile padding.
//
// The adjoint (rvst_spline_adjoint, per-row mode): the transpose of the
// evaluation with respect to the coefficients,
//   dcoeffs[r, :, i(r,p)] += g[r,p] (dxl^3, dxr^3, dxl, dxr)
// summed over p, every other entry 0.  The JAX package has no such
// kernel: its gradient paths switch the Pallas kernel off and
// differentiate the plain gather (rvspecfit_tpu/fit/batch.py,
// BatchedFitter.arms_ad).
// What bounds it on the H100: HBM bytes, nearly all of them output.  The
// dense (R, 4, n-1) result is 4 sizeof(T) B per knot interval and row,
// against 2 sizeof(T) B per query read (u and g); at the polish's
// 500 x 1024 queries on 4095 intervals that is 32.8 of 36.9 MB in float.
// Design: output-stationary, every output element written once, zeros
// included, with no global read-modify-write, no zero-fill pass and no
// atomics.  A block owns one row's segment of AdjCfg<T>::SEG
// consecutive intervals (grid: rows x segments, flattened into x).  In
// float SEG is 4096, so one block a row up to n-1 = 4096 and each row is
// scanned once, with at most 64 registers a thread, so that 4 blocks an
// SM hold the polish's 500 rows in one wave.  In double the same
// shared arrays take twice the bytes, and the static 48 KB of a block
// hold them only with SEG 2048 and half-length store passes (CHUNK,
// SUB 512): a row of 4095 intervals then takes 2 blocks, each of which
// reads the whole row's u and g (16 KB more read per row, against the
// 131 KB it writes), and 2 blocks an SM (128 registers a thread).
// * The usual row, whose clamped interval index does not decrease
//   along p (u increases along p): the queries of interval i are the
//   range [lo(i), lo(i+1)) of the row.  The block reads the row's u
//   and g once (16-byte loads; kept in shared memory for a row of at
//   most ADJ_SCAN queries), checks that the index does not decrease,
//   and writes lo(i) of its intervals into shared memory: a query p
//   starts the runs of the intervals (i(p-1), i(p)].  Then, for
//   CHUNK intervals at a time, each thread sums its intervals'
//   runs in position order into shared memory, and the block stores
//   each plane's CHUNK values with 16-byte streaming stores from
//   the first aligned address (a plane starts at k (n-1) elements, not
//   16-byte aligned for odd n-1), scalar ones at the ends.
// * Any other row (reversed, a descent, a NaN query, which maps to
//   interval 0): the block takes the row's queries in tiles of
//   ADJ_TILE, keeps those that land in its current SUB intervals
//   keyed (interval, position), sorts the keys (bitonic), and the first
//   query of each run adds the run, in position order, to the
//   intervals' sums in shared memory, carried across tiles; then it
//   stores them.
// Both paths add each interval's terms one at a time in increasing
// position, starting from 0, with adds that are never contracted into
// a multiply (__fadd_rn, __dadd_rn): the path a row takes does not
// change the bits, and two launches give the same bits.
// At the polish's shape the stores alone (RVST_ABLATE 1) take ~75% of
// the float kernel's time and the rest alone (2) ~80%: they overlap
// only in part (PERF.md).
// RVST_ABLATE (tools/torch_ablate.py; default 0, the kernel):
//   1  the stores alone: zeros into every element, nothing read;
//   2  the scan and the sums, storing only the intervals that have
//      queries (the caller zeroes the output first).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

#define THREADS 256
#define TILE_PX (4 * THREADS)       // pixels of one row per block pass
#define ROWS_PER_BLOCK 32           // shared mode: rows per block at most
#define WINDOW_MAX 1792             // shared mode: knots staged at most
#define ROW_BATCH 4                 // shared mode: rows loaded together
#define STAGE_MIN_ROWS 16           // rows_per_coeff from which to stage
#define MAX_GRID_Y 65535

// (A, B, C, D) of one knot interval in double
struct __align__(16) dquad {
  double x, y, z, w;
};

// what the kernels need of their element type T
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  using quad = float4;
  __device__ static quad q(float a, float b, float c, float d) {
    return make_float4(a, b, c, d);
  }
  __device__ static float floor_(float x) { return floorf(x); }
  __device__ static float exp_(float x) { return expf(x); }
  __device__ static float expm1_(float x) { return expm1f(x); }
  __device__ static float min_(float a, float b) { return fminf(a, b); }
  __device__ static float max_(float a, float b) { return fmaxf(a, b); }
  __device__ static float add_rn(float a, float b) { return __fadd_rn(a, b); }
  // 4 consecutive values at a 16-byte aligned address
  __device__ static void load4cs(const float* p, float v[4]) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  }
  __device__ static void load4g(const float* p, float v[4]) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  }
  __device__ static void store4cs(float* p, const float v[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
  // 16 bytes (4 values) at a 16-byte aligned address
  __device__ static void store16cs(float* p, const float* v) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};

template <>
struct Elem<double> {
  using quad = dquad;
  __device__ static quad q(double a, double b, double c, double d) {
    return dquad{a, b, c, d};
  }
  __device__ static double floor_(double x) { return floor(x); }
  __device__ static double exp_(double x) { return exp(x); }
  __device__ static double expm1_(double x) { return expm1(x); }
  __device__ static double min_(double a, double b) { return fmin(a, b); }
  __device__ static double max_(double a, double b) { return fmax(a, b); }
  __device__ static double add_rn(double a, double b) {
    return __dadd_rn(a, b);
  }
  __device__ static void load4cs(const double* p, double v[4]) {
    const double2 a = __ldcs(reinterpret_cast<const double2*>(p));
    const double2 b = __ldcs(reinterpret_cast<const double2*>(p) + 1);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  }
  __device__ static void load4g(const double* p, double v[4]) {
    const double2 a = __ldg(reinterpret_cast<const double2*>(p));
    const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  }
  __device__ static void store4cs(double* p, const double v[4]) {
    __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
    __stcs(reinterpret_cast<double2*>(p) + 1, make_double2(v[2], v[3]));
  }
  // 16 bytes (2 values) at a 16-byte aligned address
  __device__ static void store16cs(double* p, const double* v) {
    __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
  }
};

template <typename T>
struct Geo {
  int nm1;          // knot intervals per coefficient row
  int log_step;
  T x0, step, expm1_step;
};

// coefficient window of a block in shared memory (n == 0: none)
template <typename T>
struct Window {
  const typename Elem<T>::quad* c;
  const T* x;
  int w0, n;
};

template <typename T>
__device__ __forceinline__ T eval1(T uu, const Geo<T>& g,
                                   const T* __restrict__ crow,
                                   const Window<T>& w) {
  using E = Elem<T>;
  // max/min map a NaN query to interval 0; frac then stays NaN, so the
  // output is NaN like the plain version's
  T idx = E::min_(E::max_(E::floor_(uu), T(0)), (T)(g.nm1 - 1));
  T frac = uu - idx;
  int i = (int)idx;
  int k = i - w.w0;
  typename E::quad c;
  T xl = 0;
  if ((unsigned)k < (unsigned)w.n) {
    c = w.c[k];
    xl = w.x[k];
  } else {
    c = E::q(__ldg(crow + i), __ldg(crow + g.nm1 + i),
             __ldg(crow + 2 * g.nm1 + i), __ldg(crow + 3 * g.nm1 + i));
    if (g.log_step) xl = g.x0 * E::exp_(idx * g.step);
  }
  T dxl, dxr;
  if (g.log_step) {
    T ef = E::expm1_(frac * g.step);
    dxl = xl * ef;
    dxr = xl * (g.expm1_step - ef);
  } else {
    dxl = frac * g.step;
    dxr = (T(1) - frac) * g.step;
  }
  return c.x * dxl * dxl * dxl + c.y * dxr * dxr * dxr + c.z * dxl
         + c.w * dxr;
}

// this thread's 4 pixels [p, p + 4) of one row
template <typename T>
__device__ __forceinline__ void eval_px4(const T* __restrict__ urow,
                                         T* __restrict__ orow, int p,
                                         int npix, bool vec, const Geo<T>& g,
                                         const T* __restrict__ crow,
                                         const Window<T>& w) {
  if (p >= npix) return;
  if (vec && p + 4 <= npix) {
    T uu[4], o[4];
    Elem<T>::load4cs(urow + p, uu);
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = eval1(uu[e], g, crow, w);
    Elem<T>::store4cs(orow + p, o);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (p + e < npix) orow[p + e] = eval1(urow[p + e], g, crow, w);
  }
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b))
          & 15) == 0;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
spline_rows_kernel(const T* __restrict__ coeffs, const T* __restrict__ u,
                   T* __restrict__ out, int rows, int npix,
                   int rows_per_coeff, Geo<T> g) {
  const int p = blockIdx.x * TILE_PX + 4 * threadIdx.x;
  const Window<T> none = {nullptr, nullptr, 0, 0};
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const T* crow = coeffs + (size_t)(r / rows_per_coeff) * 4 * g.nm1;
    const T* urow = u + (size_t)r * npix;
    T* orow = out + (size_t)r * npix;
    eval_px4(urow, orow, p, npix, aligned16(urow, orow), g, crow, none);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
spline_shared_kernel(const T* __restrict__ coeffs, const T* __restrict__ u,
                     T* __restrict__ out, int ncoef, int npix,
                     int rows_per_coeff, int chunks, int rows_per_chunk,
                     int wmax, Geo<T> g) {
  using E = Elem<T>;
  using quad = typename E::quad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  quad* s_c = reinterpret_cast<quad*>(smem_raw);   // [wmax], then x_i
  T* s_x = reinterpret_cast<T*>(s_c + wmax);
  __shared__ T s_lo[THREADS / 32], s_hi[THREADS / 32];
  __shared__ int s_w0, s_n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int px0 = blockIdx.x * TILE_PX;
  const int px1 = min(px0 + TILE_PX, npix) - 1;
  const int p = px0 + 4 * tid;
  // every row 16-byte aligned: vector access throughout
  const bool vec = npix % 4 == 0 && aligned16(u, out);

  for (int blk = blockIdx.y; blk < ncoef * chunks; blk += gridDim.y) {
    const int c = blk / chunks;
    const int r0 = c * rows_per_coeff + (blk - c * chunks) * rows_per_chunk;
    const int r1 = min(r0 + rows_per_chunk, (c + 1) * rows_per_coeff);
    const T* crow = coeffs + (size_t)c * 4 * g.nm1;

    // the knot window: extremes of the tile's first and last columns
    // (min/max skip NaN queries)
    T lo = INFINITY, hi = -INFINITY;
    for (int r = r0 + tid; r < r1; r += THREADS) {
      const T* urow = u + (size_t)r * npix;
      T a = urow[px0], b = urow[px1];
      lo = E::min_(lo, E::min_(a, b));
      hi = E::max_(hi, E::max_(a, b));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = E::min_(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = E::max_(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (lane == 0) {
      s_lo[warp] = lo;
      s_hi[warp] = hi;
    }
    __syncthreads();   // also: the previous rows are done with s_c
    if (tid == 0) {
      for (int i = 1; i < THREADS / 32; ++i) {
        lo = E::min_(lo, s_lo[i]);
        hi = E::max_(hi, s_hi[i]);
      }
      T top = (T)(g.nm1 - 1);
      int w0 = (int)E::min_(E::max_(E::floor_(lo), T(0)), top);
      int w1 = (int)E::min_(E::max_(E::floor_(hi), T(0)), top);
      s_w0 = w0;
      s_n = lo <= hi ? min(w1 - w0 + 1, wmax) : 0;
    }
    __syncthreads();
    const Window<T> w = {s_c, s_x, s_w0, s_n};
    for (int k = tid; k < w.n; k += THREADS) {
      int i = w.w0 + k;
      s_c[k] = E::q(__ldg(crow + i), __ldg(crow + g.nm1 + i),
                    __ldg(crow + 2 * g.nm1 + i), __ldg(crow + 3 * g.nm1 + i));
      s_x[k] = g.log_step ? g.x0 * E::exp_((T)i * g.step) : T(0);
    }
    __syncthreads();

    if (vec) {
      if (p >= npix) continue;
      int r = r0;
      for (; r + ROW_BATCH <= r1; r += ROW_BATCH) {
        T uu[ROW_BATCH][4];
#pragma unroll
        for (int k = 0; k < ROW_BATCH; ++k)
          E::load4cs(u + (size_t)(r + k) * npix + p, uu[k]);
#pragma unroll
        for (int k = 0; k < ROW_BATCH; ++k) {
          T o[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) o[e] = eval1(uu[k][e], g, crow, w);
          E::store4cs(out + (size_t)(r + k) * npix + p, o);
        }
      }
      for (; r < r1; ++r)
        eval_px4(u + (size_t)r * npix, out + (size_t)r * npix, p, npix,
                 true, g, crow, w);
    } else {
      for (int r = r0; r < r1; ++r)
        eval_px4(u + (size_t)r * npix, out + (size_t)r * npix, p, npix,
                 false, g, crow, w);
    }
  }
}

#ifndef RVST_ABLATE
#define RVST_ABLATE 0
#endif

#define ADJ_THREADS 256
#define ADJ_SCAN (4 * ADJ_THREADS)  // queries of a row per scan pass
#define ADJ_TILE 512                // other rows: queries per sorted tile

// the adjoint's tiling per element type: knot intervals per block
// (SEG), usual rows' intervals per store pass (CHUNK), other rows'
// intervals per summing pass (SUB), blocks an SM (MIN_BLOCKS, which caps
// the registers); see the top of the file
template <typename T>
struct AdjCfg;

template <>
struct AdjCfg<float> {
  static constexpr int SEG = 4096, CHUNK = 1024, SUB = 1024, MIN_BLOCKS = 4;
};

template <>
struct AdjCfg<double> {
  static constexpr int SEG = 2048, CHUNK = 512, SUB = 512, MIN_BLOCKS = 2;
};

// one block's shared memory: the usual row's, then another row's
template <typename T>
union AdjShared {
  struct {
    T u[ADJ_SCAN], g[ADJ_SCAN];      // a short row's queries
    int lo[AdjCfg<T>::SEG + 1];      // first query of each interval (-1:
                                     // none found, so before the first
                                     // or past the last query)
    T out[4][AdjCfg<T>::CHUNK];      // one store pass's sums, by plane
  } row;
  struct {
    typename Elem<T>::quad val[ADJ_TILE];
    typename Elem<T>::quad sum[AdjCfg<T>::SUB];
    unsigned key[ADJ_TILE];  // (interval - first of the pass) << 16 | s
  } other;
};

template <typename T>
__device__ __forceinline__ int adj_interval(T uu, T top) {
  using E = Elem<T>;
  return (int)E::min_(E::max_(E::floor_(uu), T(0)), top);
}

// g (dxl^3, dxr^3, dxl, dxr) of one query, with the forward's interval
// and offsets (eval1): a NaN query gives NaN terms
template <typename T>
__device__ __forceinline__ typename Elem<T>::quad adj_term(T uu, T gg,
                                                           const Geo<T>& g) {
  using E = Elem<T>;
  const T idx = E::min_(E::max_(E::floor_(uu), T(0)), (T)(g.nm1 - 1));
  const T frac = uu - idx;
  T dxl, dxr;
  if (g.log_step) {
    const T xl = g.x0 * E::exp_(idx * g.step);
    const T ef = E::expm1_(frac * g.step);
    dxl = xl * ef;
    dxr = xl * (g.expm1_step - ef);
  } else {
    dxl = frac * g.step;
    dxr = (T(1) - frac) * g.step;
  }
  return E::q(gg * dxl * dxl * dxl, gg * dxr * dxr * dxr, gg * dxl,
              gg * dxr);
}

// acc += t with rounded adds (never fused with the products into FMAs)
template <typename Q>
__device__ __forceinline__ void adj_add(Q& acc, const Q& t) {
  using E = Elem<decltype(acc.x)>;
  acc.x = E::add_rn(acc.x, t.x);
  acc.y = E::add_rn(acc.y, t.y);
  acc.z = E::add_rn(acc.z, t.z);
  acc.w = E::add_rn(acc.w, t.w);
}

// the four planes' values of interval k, counted from drow[0]
template <typename T, typename Q>
__device__ __forceinline__ void adj_store(T* drow, int nm1, int k,
                                          const Q& v) {
  __stcs(drow + k, v.x);
  __stcs(drow + nm1 + k, v.y);
  __stcs(drow + 2 * nm1 + k, v.z);
  __stcs(drow + 3 * nm1 + k, v.w);
}

// x[p, p + 4) of one row into q (16-byte loads where the row is 16-byte
// aligned; the tail past npix is left alone)
template <typename T>
__device__ __forceinline__ void adj_load4(const T* __restrict__ x, int p,
                                          int npix, bool vec, T q[4]) {
  if (vec && p + 4 <= npix) {
    Elem<T>::load4g(x + p, q);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (p + e < npix) q[e] = __ldg(x + p + e);
  }
}

// len consecutive values of one plane from shared memory, by the
// block's threads: 16-byte streaming stores from the first aligned
// address on, scalar ones before it and after the last full vector
template <typename T>
__device__ __forceinline__ void adj_store_run(T* dst, const T* src, int len,
                                              int tid) {
  constexpr int V = 16 / (int)sizeof(T);
  const int skew = (int)(reinterpret_cast<uintptr_t>(dst) & 15);
  const int head = min(len, ((16 - skew) & 15) / (int)sizeof(T));
  if (tid < head) __stcs(dst + tid, src[tid]);
  const int nvec = (len - head) / V;
  for (int v = tid; v < nvec; v += ADJ_THREADS) {
    const int e = head + V * v;
    Elem<T>::store16cs(dst + e, src + e);
  }
  const int done = head + V * nvec;
  if (tid < len - done) __stcs(dst + done + tid, src[done + tid]);
}

template <typename T>
__global__ void __launch_bounds__(ADJ_THREADS, AdjCfg<T>::MIN_BLOCKS)
spline_adjoint_kernel(const T* __restrict__ u, const T* __restrict__ gr,
                      T* __restrict__ dc, int rows, int npix, int nseg,
                      Geo<T> g) {
  using E = Elem<T>;
  using C = AdjCfg<T>;
  __shared__ AdjShared<T> sh;
  const int tid = threadIdx.x, nm1 = g.nm1;
  const T top = (T)(nm1 - 1);
  const int i0 = (int)(blockIdx.x % nseg) * C::SEG;
  const int ns = min(C::SEG, nm1 - i0);
  // a row of at most ADJ_SCAN queries is kept in shared memory; the
  // sums of a longer one read it again from device memory
  const bool staged = npix <= ADJ_SCAN;

  for (int r = blockIdx.x / nseg; r < rows; r += gridDim.x / nseg) {
    const T* urow = u + (size_t)r * npix;
    const T* grow = gr + (size_t)r * npix;
    T* drow = dc + ((size_t)r * 4 * nm1 + i0);
    __syncthreads();   // the previous row is done with shared memory
#if RVST_ABLATE == 1
    for (int k = tid; k < 4 * C::CHUNK; k += ADJ_THREADS)
      sh.row.out[0][k] = T(0);
    __syncthreads();
    for (int c0 = 0; c0 < ns; c0 += C::CHUNK)
      for (int pl = 0; pl < 4; ++pl)
        adj_store_run(drow + pl * nm1 + c0, sh.row.out[pl],
                      min(C::CHUNK, ns - c0), tid);
    continue;
#endif

    // scan the row: does its interval index ever decrease, and where
    // does the run of each of the segment's intervals start
    const bool vec = aligned16(urow, grow);
    int p = 4 * tid;
    T q[4], w[4], qprev = 0;
    if (p < npix) {
      adj_load4(urow, p, npix, vec, q);
      if (staged) adj_load4(grow, p, npix, vec, w);
      qprev = __ldg(urow + max(p - 1, 0));
    }
    const int first = npix > 0 ? adj_interval(__ldg(urow), top) : 0;
    for (int k = tid; k <= ns; k += ADJ_THREADS) sh.row.lo[k] = -1;
    __syncthreads();
    int down = 0;
    while (p < npix) {
      int prev = adj_interval(qprev, top);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (p + e < npix) {
          const int iv = adj_interval(q[e], top);
          down |= iv < prev;
          // query p + e starts the runs of intervals prev + 1 .. iv (not
          // needed once the row is known to take the sorted path)
          const int hi = down ? -1 : min(iv - i0, ns);
#pragma unroll 1
          for (int k = max(prev + 1 - i0, 0); k <= hi; ++k)
            sh.row.lo[k] = p + e;
          if (staged) {
            sh.row.u[p + e] = q[e];
            sh.row.g[p + e] = w[e];
          }
          prev = iv;
        }
      }
      p += ADJ_SCAN;
      if (p < npix) {
        adj_load4(urow, p, npix, vec, q);
        qprev = __ldg(urow + p - 1);
      }
    }

    if (!__syncthreads_or(down)) {
      // the usual row: in passes of CHUNK intervals, each thread sums
      // its intervals' runs, then the block stores the pass
      for (int c0 = 0; c0 < ns; c0 += C::CHUNK) {
        const int len = min(C::CHUNK, ns - c0);
#pragma unroll 1
        for (int k = tid; k < len; k += ADJ_THREADS) {
          int a = sh.row.lo[c0 + k], b = sh.row.lo[c0 + k + 1];
          if (a < 0) a = i0 + c0 + k <= first ? 0 : npix;
          if (b < 0) b = i0 + c0 + k + 1 <= first ? 0 : npix;
          typename E::quad acc = E::q(0, 0, 0, 0);
          if (staged) {
#pragma unroll 1
            for (int pp = a; pp < b; ++pp)
              adj_add(acc, adj_term(sh.row.u[pp], sh.row.g[pp], g));
          } else {
#pragma unroll 1
            for (int pp = a; pp < b; ++pp)
              adj_add(acc, adj_term(__ldg(urow + pp), __ldg(grow + pp), g));
          }
#if RVST_ABLATE == 2
          if (a != b) adj_store(drow, nm1, c0 + k, acc);
#else
          sh.row.out[0][k] = acc.x;
          sh.row.out[1][k] = acc.y;
          sh.row.out[2][k] = acc.z;
          sh.row.out[3][k] = acc.w;
#endif
        }
#if RVST_ABLATE != 2
        __syncthreads();
        for (int pl = 0; pl < 4; ++pl)
          adj_store_run(drow + pl * nm1 + c0, sh.row.out[pl], len, tid);
        __syncthreads();   // the next pass reuses the sums' memory
#endif
      }
      continue;
    }

    // any other row: passes over SUB intervals of the segment, each
    // taking the row's queries that land there in sorted tiles
#pragma unroll 1
    for (int sub = 0; sub < ns; sub += C::SUB) {
      const int nsub = min(C::SUB, ns - sub);
      for (int k = tid; k < nsub; k += ADJ_THREADS)
        sh.other.sum[k] = E::q(0, 0, 0, 0);
#pragma unroll 1
      for (int p0 = 0; p0 < npix; p0 += ADJ_TILE) {
        const int n = min(ADJ_TILE, npix - p0);
        for (int s = tid; s < ADJ_TILE; s += ADJ_THREADS) {
          unsigned key = ~0u;                    // padding sorts last
          if (s < n) {
            const T uu = __ldg(urow + p0 + s);
            const int k = adj_interval(uu, top) - i0 - sub;
            if (k >= 0 && k < nsub) {
              key = ((unsigned)k << 16) | (unsigned)s;
              sh.other.val[s] = adj_term(uu, __ldg(grow + p0 + s), g);
            }
          }
          sh.other.key[s] = key;
        }
        __syncthreads();   // also: the zeroed sums are visible
        // bitonic sort of the keys (unique: position in the low bits)
        for (int k = 2; k <= ADJ_TILE; k <<= 1) {
          for (int j = k >> 1; j > 0; j >>= 1) {
            for (int t = tid; t < ADJ_TILE / 2; t += ADJ_THREADS) {
              const int i = 2 * t - (t & (j - 1));
              const unsigned a = sh.other.key[i], b = sh.other.key[i + j];
              if ((a > b) == ((i & k) == 0)) {
                sh.other.key[i] = b;
                sh.other.key[i + j] = a;
              }
            }
            __syncthreads();
          }
        }
        // the first query of each run adds the run to its interval's sum
        for (int s = tid; s < ADJ_TILE; s += ADJ_THREADS) {
          const unsigned key = sh.other.key[s];
          const unsigned k = key >> 16;
          if (key == ~0u || (s > 0 && (sh.other.key[s - 1] >> 16) == k))
            continue;
          typename E::quad acc = sh.other.sum[k];
#pragma unroll 1
          for (int t = s; t < ADJ_TILE && (sh.other.key[t] >> 16) == k; ++t)
            adj_add(acc, sh.other.val[sh.other.key[t] & 0xffffu]);
          sh.other.sum[k] = acc;
        }
        __syncthreads();   // the next tile reuses the keys and values
      }
      // each thread stores (and next zeroes) the sums of its own k
      for (int k = tid; k < nsub; k += ADJ_THREADS)
        adj_store(drow, nm1, sub + k, sh.other.sum[k]);
    }
  }
}

template <typename T>
static int launch_adjoint(const T* u, const T* g, T* dcoeffs, int rows,
                          int npix, int nm1, Geo<T> geo, void* stream) {
  if (rows == 0 || nm1 <= 0) return 0;
  const int seg = AdjCfg<T>::SEG;
  const int nseg = (nm1 + seg - 1) / seg;
  const int grid = std::min(rows, INT_MAX / nseg) * nseg;
  spline_adjoint_kernel<T><<<grid, ADJ_THREADS, 0, (cudaStream_t)stream>>>(
      u, g, dcoeffs, rows, npix, nseg, geo);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_eval(const T* coeffs, const T* u, T* out, int rows,
                       int npix, int rows_per_coeff, Geo<T> g,
                       void* stream) {
  if (rows == 0 || npix == 0) return 0;
  const unsigned tiles = (npix + TILE_PX - 1) / TILE_PX;
  cudaStream_t s = (cudaStream_t)stream;
  if (rows_per_coeff < STAGE_MIN_ROWS) {
    dim3 grid(tiles, std::min(rows, MAX_GRID_Y));
    spline_rows_kernel<T><<<grid, THREADS, 0, s>>>(coeffs, u, out, rows,
                                                   npix, rows_per_coeff, g);
  } else {
    const int ncoef = rows / rows_per_coeff;
    const int chunks = (rows_per_coeff + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
    const int rows_per_chunk = (rows_per_coeff + chunks - 1) / chunks;
    const int wmax = std::min(g.nm1, WINDOW_MAX);
    const size_t smem =
        (size_t)wmax * (sizeof(typename Elem<T>::quad) + sizeof(T));
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          spline_shared_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    dim3 grid(tiles, std::min(ncoef * chunks, MAX_GRID_Y));
    spline_shared_kernel<T><<<grid, THREADS, smem, s>>>(
        coeffs, u, out, ncoef, npix, rows_per_coeff, chunks, rows_per_chunk,
        wmax, g);
  }
  return (int)cudaGetLastError();
}

extern "C" int rvst_spline_adjoint(const float* u, const float* g,
                                   float* dcoeffs, int rows, int npix,
                                   int nm1, int log_step, float x0,
                                   float step, float expm1_step,
                                   void* stream) {
  return launch_adjoint<float>(u, g, dcoeffs, rows, npix, nm1,
                               {nm1, log_step, x0, step, expm1_step}, stream);
}

extern "C" int rvst_spline_adjoint_f64(const double* u, const double* g,
                                       double* dcoeffs, int rows, int npix,
                                       int nm1, int log_step, double x0,
                                       double step, double expm1_step,
                                       void* stream) {
  return launch_adjoint<double>(u, g, dcoeffs, rows, npix, nm1,
                                {nm1, log_step, x0, step, expm1_step},
                                stream);
}

extern "C" int rvst_spline_eval(const float* coeffs, const float* u,
                                float* out, int rows, int npix, int nm1,
                                int rows_per_coeff, int log_step, float x0,
                                float step, float expm1_step, void* stream) {
  return launch_eval<float>(coeffs, u, out, rows, npix, rows_per_coeff,
                            {nm1, log_step, x0, step, expm1_step}, stream);
}

extern "C" int rvst_spline_eval_f64(const double* coeffs, const double* u,
                                    double* out, int rows, int npix, int nm1,
                                    int rows_per_coeff, int log_step,
                                    double x0, double step,
                                    double expm1_step, void* stream) {
  return launch_eval<double>(coeffs, u, out, rows, npix, rows_per_coeff,
                             {nm1, log_step, x0, step, expm1_step}, stream);
}
