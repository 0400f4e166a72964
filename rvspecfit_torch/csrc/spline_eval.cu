// Kernel A: Doppler evaluation of natural cubic splines at fractional
// knot indices.
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
// What bounds it on the H100: memory traffic.  Per element it reads u
// (4 B) and writes out (4 B) against ~30 flops; the coefficients add
// 16 B per knot that the queries touch.  Shared mode at the refine
// scan's shape (200500 x 1024, 500 coefficient rows) moves 1.654 GB,
// 0.49 ms at 3.35 TB/s.
//
// Design: a 2-D grid of 1024-pixel tiles x row blocks, with a
// grid-stride loop over row blocks; each thread evaluates 4 consecutive
// pixels with one float4 load of u and one float4 store (streaming, so
// they do not evict the coefficients from L2), and a scalar path for a
// row that is not 16-byte aligned or the tail of npix % 4 != 0.  All
// index arithmetic inside a row is 32-bit; the row -> coefficient-row
// division is done once per row (per-row kernel) or once per block
// (shared kernel).
// * Per-row mode (rows_per_coeff < STAGE_MIN_ROWS): read-only gathers
//   straight from the coefficient row, near-coalesced because u
//   increases along p.
// * Shared mode: a block owns up to 32 rows of one coefficient row
//   (401 rows make 13 blocks: enough blocks that the last wave is
//   short, few enough that staging stays under ~10% of the traffic).
//   It takes the knot window its rows touch from the first and last
//   columns of its tile (u is monotone along p), stages it in shared
//   memory as float4 (A, B, C, D) per knot with x_i beside it (so the
//   per-element expf goes; expm1f(f step) stays), and evaluates its
//   rows from shared memory, loading 4 rows' u before it evaluates
//   them.  A query outside the staged window (u not
//   monotone, or a window wider than WINDOW_MAX) gathers from device
//   memory instead, so the result never depends on the window.
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
// dense (R, 4, n-1) float32 result is 16 B per knot interval and row,
// against 8 B per query read (u and g); at the polish's 500 x 1024
// queries on 4095 intervals that is 32.8 of 36.9 MB.
// Design: output-stationary, every output element written once, zeros
// included, with no global read-modify-write, no zero-fill pass and no
// atomics.  A block owns one row's segment of ADJ_SEG consecutive
// intervals (grid: rows x segments, flattened into x; ADJ_SEG is 4096,
// so one block a row up to n-1 = 4096 and each row is scanned once), with
// at most 64 registers a thread, so that 4 blocks an SM hold the
// polish's 500 rows in one wave.
// * The usual row, whose clamped interval index does not decrease
//   along p (u increases along p): the queries of interval i are the
//   range [lo(i), lo(i+1)) of the row.  The block reads the row's u
//   and g once (float4 loads; kept in shared memory for a row of at
//   most ADJ_SCAN queries), checks that the index does not decrease,
//   and writes lo(i) of its intervals into shared memory: a query p
//   starts the runs of the intervals (i(p-1), i(p)].  Then, for
//   ADJ_CHUNK intervals at a time, each thread sums its intervals'
//   runs in position order into shared memory, and the block stores
//   each plane's ADJ_CHUNK values with 16-byte streaming stores from
//   the first aligned address (a plane starts at k (n-1) floats, not
//   16-byte aligned for odd n-1), scalar ones at the ends.
// * Any other row (reversed, a descent, a NaN query, which maps to
//   interval 0): the block takes the row's queries in tiles of
//   ADJ_TILE, keeps those that land in its current ADJ_SUB intervals
//   keyed (interval, position), sorts the keys (bitonic), and the first
//   query of each run adds the run, in position order, to the
//   intervals' sums in shared memory, carried across tiles; then it
//   stores them.
// Both paths add each interval's terms one at a time in increasing
// position, starting from 0, with adds that are never contracted into
// a multiply: the path a row takes does not change the bits, and two
// launches give the same bits.
// At the polish's shape the stores alone (RVST_ABLATE 1) take ~75% of
// the kernel's time and the rest alone (2) ~80%: they overlap only in
// part (PERF.md).
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

struct Geo {
  int nm1;          // knot intervals per coefficient row
  int log_step;
  float x0, step, expm1_step;
};

// coefficient window of a block in shared memory (n == 0: none)
struct Window {
  const float4* c;
  const float* x;
  int w0, n;
};

__device__ __forceinline__ float eval1(float uu, const Geo& g,
                                       const float* __restrict__ crow,
                                       const Window& w) {
  // fmaxf/fminf map a NaN query to interval 0; frac then stays NaN,
  // so the output is NaN like the plain version's
  float idx = fminf(fmaxf(floorf(uu), 0.f), (float)(g.nm1 - 1));
  float frac = uu - idx;
  int i = (int)idx;
  int k = i - w.w0;
  float4 c;
  float xl = 0.f;
  if ((unsigned)k < (unsigned)w.n) {
    c = w.c[k];
    xl = w.x[k];
  } else {
    c = make_float4(__ldg(crow + i), __ldg(crow + g.nm1 + i),
                    __ldg(crow + 2 * g.nm1 + i), __ldg(crow + 3 * g.nm1 + i));
    if (g.log_step) xl = g.x0 * expf(idx * g.step);
  }
  float dxl, dxr;
  if (g.log_step) {
    float ef = expm1f(frac * g.step);
    dxl = xl * ef;
    dxr = xl * (g.expm1_step - ef);
  } else {
    dxl = frac * g.step;
    dxr = (1.f - frac) * g.step;
  }
  return c.x * dxl * dxl * dxl + c.y * dxr * dxr * dxr + c.z * dxl
         + c.w * dxr;
}

// this thread's 4 pixels [p, p + 4) of one row
__device__ __forceinline__ void eval_px4(const float* __restrict__ urow,
                                         float* __restrict__ orow, int p,
                                         int npix, bool vec, const Geo& g,
                                         const float* __restrict__ crow,
                                         const Window& w) {
  if (p >= npix) return;
  if (vec && p + 4 <= npix) {
    float4 uu = __ldcs(reinterpret_cast<const float4*>(urow + p));
    float4 o = make_float4(eval1(uu.x, g, crow, w), eval1(uu.y, g, crow, w),
                           eval1(uu.z, g, crow, w), eval1(uu.w, g, crow, w));
    __stcs(reinterpret_cast<float4*>(orow + p), o);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (p + e < npix) orow[p + e] = eval1(urow[p + e], g, crow, w);
  }
}

__device__ __forceinline__ bool aligned16(const float* a, const float* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b))
          & 15) == 0;
}

__global__ void __launch_bounds__(THREADS)
spline_rows_kernel(const float* __restrict__ coeffs,
                   const float* __restrict__ u, float* __restrict__ out,
                   int rows, int npix, int rows_per_coeff, Geo g) {
  const int p = blockIdx.x * TILE_PX + 4 * threadIdx.x;
  const Window none = {nullptr, nullptr, 0, 0};
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const float* crow = coeffs + (size_t)(r / rows_per_coeff) * 4 * g.nm1;
    const float* urow = u + (size_t)r * npix;
    float* orow = out + (size_t)r * npix;
    eval_px4(urow, orow, p, npix, aligned16(urow, orow), g, crow, none);
  }
}

__global__ void __launch_bounds__(THREADS)
spline_shared_kernel(const float* __restrict__ coeffs,
                     const float* __restrict__ u, float* __restrict__ out,
                     int ncoef, int npix, int rows_per_coeff, int chunks,
                     int rows_per_chunk, int wmax, Geo g) {
  extern __shared__ float4 s_c[];                   // [wmax], then x_i
  float* s_x = reinterpret_cast<float*>(s_c + wmax);
  __shared__ float s_lo[THREADS / 32], s_hi[THREADS / 32];
  __shared__ int s_w0, s_n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int px0 = blockIdx.x * TILE_PX;
  const int px1 = min(px0 + TILE_PX, npix) - 1;
  const int p = px0 + 4 * tid;
  // every row 16-byte aligned: float4 access throughout
  const bool vec = npix % 4 == 0 && aligned16(u, out);

  for (int blk = blockIdx.y; blk < ncoef * chunks; blk += gridDim.y) {
    const int c = blk / chunks;
    const int r0 = c * rows_per_coeff + (blk - c * chunks) * rows_per_chunk;
    const int r1 = min(r0 + rows_per_chunk, (c + 1) * rows_per_coeff);
    const float* crow = coeffs + (size_t)c * 4 * g.nm1;

    // the knot window: extremes of the tile's first and last columns
    // (fminf/fmaxf skip NaN queries)
    float lo = INFINITY, hi = -INFINITY;
    for (int r = r0 + tid; r < r1; r += THREADS) {
      const float* urow = u + (size_t)r * npix;
      float a = urow[px0], b = urow[px1];
      lo = fminf(lo, fminf(a, b));
      hi = fmaxf(hi, fmaxf(a, b));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (lane == 0) {
      s_lo[warp] = lo;
      s_hi[warp] = hi;
    }
    __syncthreads();   // also: the previous rows are done with s_c
    if (tid == 0) {
      for (int i = 1; i < THREADS / 32; ++i) {
        lo = fminf(lo, s_lo[i]);
        hi = fmaxf(hi, s_hi[i]);
      }
      float top = (float)(g.nm1 - 1);
      int w0 = (int)fminf(fmaxf(floorf(lo), 0.f), top);
      int w1 = (int)fminf(fmaxf(floorf(hi), 0.f), top);
      s_w0 = w0;
      s_n = lo <= hi ? min(w1 - w0 + 1, wmax) : 0;
    }
    __syncthreads();
    const Window w = {s_c, s_x, s_w0, s_n};
    for (int k = tid; k < w.n; k += THREADS) {
      int i = w.w0 + k;
      s_c[k] = make_float4(__ldg(crow + i), __ldg(crow + g.nm1 + i),
                           __ldg(crow + 2 * g.nm1 + i),
                           __ldg(crow + 3 * g.nm1 + i));
      s_x[k] = g.log_step ? g.x0 * expf((float)i * g.step) : 0.f;
    }
    __syncthreads();

    if (vec) {
      if (p >= npix) continue;
      int r = r0;
      for (; r + ROW_BATCH <= r1; r += ROW_BATCH) {
        float4 uu[ROW_BATCH];
#pragma unroll
        for (int k = 0; k < ROW_BATCH; ++k)
          uu[k] = __ldcs(reinterpret_cast<const float4*>(
              u + (size_t)(r + k) * npix + p));
#pragma unroll
        for (int k = 0; k < ROW_BATCH; ++k)
          __stcs(reinterpret_cast<float4*>(out + (size_t)(r + k) * npix + p),
                 make_float4(eval1(uu[k].x, g, crow, w),
                             eval1(uu[k].y, g, crow, w),
                             eval1(uu[k].z, g, crow, w),
                             eval1(uu[k].w, g, crow, w)));
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
#define ADJ_SEG 4096                // knot intervals per block
#define ADJ_MIN_BLOCKS 4            // blocks per SM: at most 64 registers
#define ADJ_SCAN (4 * ADJ_THREADS)  // queries of a row per scan pass
#define ADJ_CHUNK (4 * ADJ_THREADS) // usual row: intervals per store pass
#define ADJ_SUB 1024                // other rows: intervals per summing pass
#define ADJ_TILE 512                // other rows: queries per sorted tile

// one block's shared memory: the usual row's, then another row's
union AdjShared {
  struct {
    float u[ADJ_SCAN], g[ADJ_SCAN];   // a short row's queries
    int lo[ADJ_SEG + 1];     // first query of each interval (-1: none
                             // found, so before the first or past the
                             // last query)
    float out[4][ADJ_CHUNK]; // one store pass's sums, plane by plane
  } row;
  struct {
    float4 val[ADJ_TILE];
    float4 sum[ADJ_SUB];
    unsigned key[ADJ_TILE];  // (interval - first of the pass) << 16 | s
  } other;
};

__device__ __forceinline__ int adj_interval(float uu, float top) {
  return (int)fminf(fmaxf(floorf(uu), 0.f), top);
}

// g (dxl^3, dxr^3, dxl, dxr) of one query, with the forward's interval
// and offsets (eval1): a NaN query gives NaN terms
__device__ __forceinline__ float4 adj_term(float uu, float gg,
                                           const Geo& g) {
  const float idx = fminf(fmaxf(floorf(uu), 0.f), (float)(g.nm1 - 1));
  const float frac = uu - idx;
  float dxl, dxr;
  if (g.log_step) {
    const float xl = g.x0 * expf(idx * g.step);
    const float ef = expm1f(frac * g.step);
    dxl = xl * ef;
    dxr = xl * (g.expm1_step - ef);
  } else {
    dxl = frac * g.step;
    dxr = (1.f - frac) * g.step;
  }
  return make_float4(gg * dxl * dxl * dxl, gg * dxr * dxr * dxr, gg * dxl,
                     gg * dxr);
}

// acc += t with rounded adds (never fused with the products into FMAs)
__device__ __forceinline__ void adj_add(float4& acc, const float4& t) {
  acc.x = __fadd_rn(acc.x, t.x);
  acc.y = __fadd_rn(acc.y, t.y);
  acc.z = __fadd_rn(acc.z, t.z);
  acc.w = __fadd_rn(acc.w, t.w);
}

// the four planes' values of interval k, counted from drow[0]
__device__ __forceinline__ void adj_store(float* drow, int nm1, int k,
                                          const float4& v) {
  __stcs(drow + k, v.x);
  __stcs(drow + nm1 + k, v.y);
  __stcs(drow + 2 * nm1 + k, v.z);
  __stcs(drow + 3 * nm1 + k, v.w);
}

// x[p, p + 4) of one row into q (one float4 where the row is 16-byte
// aligned; the tail past npix is left alone)
__device__ __forceinline__ void adj_load4(const float* __restrict__ x,
                                          int p, int npix, bool vec,
                                          float q[4]) {
  if (vec && p + 4 <= npix) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(x + p));
    q[0] = v.x;
    q[1] = v.y;
    q[2] = v.z;
    q[3] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (p + e < npix) q[e] = __ldg(x + p + e);
  }
}

// len consecutive floats of one plane from shared memory, by the
// block's threads: 16-byte streaming stores from the first aligned
// address on, scalar ones before it and after the last full float4
__device__ __forceinline__ void adj_store_run(float* dst, const float* src,
                                              int len, int tid) {
  const int skew = (int)(reinterpret_cast<uintptr_t>(dst) & 15);  // 0, 4, ..
  const int head = min(len, ((16 - skew) & 15) / 4);
  if (tid < head) __stcs(dst + tid, src[tid]);
  const int nvec = (len - head) / 4;
  for (int v = tid; v < nvec; v += ADJ_THREADS) {
    const int e = head + 4 * v;
    __stcs(reinterpret_cast<float4*>(dst + e),
           make_float4(src[e], src[e + 1], src[e + 2], src[e + 3]));
  }
  const int done = head + 4 * nvec;
  if (tid < len - done) __stcs(dst + done + tid, src[done + tid]);
}

__global__ void __launch_bounds__(ADJ_THREADS, ADJ_MIN_BLOCKS)
spline_adjoint_kernel(const float* __restrict__ u,
                      const float* __restrict__ gr, float* __restrict__ dc,
                      int rows, int npix, int nseg, Geo g) {
  __shared__ AdjShared sh;
  const int tid = threadIdx.x, nm1 = g.nm1;
  const float top = (float)(nm1 - 1);
  const int i0 = (int)(blockIdx.x % nseg) * ADJ_SEG;
  const int ns = min(ADJ_SEG, nm1 - i0);
  // a row of at most ADJ_SCAN queries is kept in shared memory; the
  // sums of a longer one read it again from device memory
  const bool staged = npix <= ADJ_SCAN;

  for (int r = blockIdx.x / nseg; r < rows; r += gridDim.x / nseg) {
    const float* urow = u + (size_t)r * npix;
    const float* grow = gr + (size_t)r * npix;
    float* drow = dc + ((size_t)r * 4 * nm1 + i0);
    __syncthreads();   // the previous row is done with shared memory
#if RVST_ABLATE == 1
    for (int k = tid; k < 4 * ADJ_CHUNK; k += ADJ_THREADS)
      sh.row.out[0][k] = 0.f;
    __syncthreads();
    for (int c0 = 0; c0 < ns; c0 += ADJ_CHUNK)
      for (int pl = 0; pl < 4; ++pl)
        adj_store_run(drow + pl * nm1 + c0, sh.row.out[pl],
                      min(ADJ_CHUNK, ns - c0), tid);
    continue;
#endif

    // scan the row: does its interval index ever decrease, and where
    // does the run of each of the segment's intervals start
    const bool vec = ((reinterpret_cast<uintptr_t>(urow)
                       | reinterpret_cast<uintptr_t>(grow)) & 15) == 0;
    int p = 4 * tid;
    float q[4], w[4], qprev = 0.f;
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
      // the usual row: in passes of ADJ_CHUNK intervals, each thread
      // sums its intervals' runs, then the block stores the pass
      for (int c0 = 0; c0 < ns; c0 += ADJ_CHUNK) {
        const int len = min(ADJ_CHUNK, ns - c0);
#pragma unroll 1
        for (int k = tid; k < len; k += ADJ_THREADS) {
          int a = sh.row.lo[c0 + k], b = sh.row.lo[c0 + k + 1];
          if (a < 0) a = i0 + c0 + k <= first ? 0 : npix;
          if (b < 0) b = i0 + c0 + k + 1 <= first ? 0 : npix;
          float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
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

    // any other row: passes over ADJ_SUB intervals of the segment, each
    // taking the row's queries that land there in sorted tiles
#pragma unroll 1
    for (int sub = 0; sub < ns; sub += ADJ_SUB) {
      const int nsub = min(ADJ_SUB, ns - sub);
      for (int k = tid; k < nsub; k += ADJ_THREADS)
        sh.other.sum[k] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
      for (int p0 = 0; p0 < npix; p0 += ADJ_TILE) {
        const int n = min(ADJ_TILE, npix - p0);
        for (int s = tid; s < ADJ_TILE; s += ADJ_THREADS) {
          unsigned key = ~0u;                    // padding sorts last
          if (s < n) {
            const float uu = __ldg(urow + p0 + s);
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
          float4 acc = sh.other.sum[k];
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

extern "C" int rvst_spline_adjoint(const float* u, const float* g,
                                   float* dcoeffs, int rows, int npix,
                                   int nm1, int log_step, float x0,
                                   float step, float expm1_step,
                                   void* stream) {
  if (rows == 0 || nm1 <= 0) return 0;
  const Geo geo = {nm1, log_step, x0, step, expm1_step};
  const int nseg = (nm1 + ADJ_SEG - 1) / ADJ_SEG;
  const int grid = std::min(rows, INT_MAX / nseg) * nseg;
  spline_adjoint_kernel<<<grid, ADJ_THREADS, 0, (cudaStream_t)stream>>>(
      u, g, dcoeffs, rows, npix, nseg, geo);
  return (int)cudaGetLastError();
}

extern "C" int rvst_spline_eval(const float* coeffs, const float* u,
                                float* out, int rows, int npix, int nm1,
                                int rows_per_coeff, int log_step, float x0,
                                float step, float expm1_step, void* stream) {
  if (rows == 0 || npix == 0) return 0;
  const Geo g = {nm1, log_step, x0, step, expm1_step};
  const unsigned tiles = (npix + TILE_PX - 1) / TILE_PX;
  cudaStream_t s = (cudaStream_t)stream;
  if (rows_per_coeff < STAGE_MIN_ROWS) {
    dim3 grid(tiles, std::min(rows, MAX_GRID_Y));
    spline_rows_kernel<<<grid, THREADS, 0, s>>>(coeffs, u, out, rows, npix,
                                                rows_per_coeff, g);
  } else {
    const int ncoef = rows / rows_per_coeff;
    const int chunks = (rows_per_coeff + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
    const int rows_per_chunk = (rows_per_coeff + chunks - 1) / chunks;
    const int wmax = std::min(nm1, WINDOW_MAX);
    const size_t smem = (size_t)wmax * (sizeof(float4) + sizeof(float));
    dim3 grid(tiles, std::min(ncoef * chunks, MAX_GRID_Y));
    spline_shared_kernel<<<grid, THREADS, smem, s>>>(
        coeffs, u, out, ncoef, npix, rows_per_coeff, chunks, rows_per_chunk,
        wmax, g);
  }
  return (int)cudaGetLastError();
}
