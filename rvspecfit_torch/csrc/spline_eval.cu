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
// BatchedFitter.arms_ad).  Bound: the dense (R, 4, n-1) output, 16 B per
// knot interval and row, against 8 B per query read; at the polish's
// 500 x 1024 queries on 4095 intervals that is 36.9 MB.
// Design: one block per row.  It zeroes the row's output with float4
// stores, then takes the row's queries in tiles of ADJ_TILE: each
// query's interval and four products go to shared memory with the key
// (interval, position); a tile whose intervals are not non-decreasing
// is put in key order by a bitonic sort (a tile that is, the usual
// case since u increases along p, is left as it is: the same order);
// the first query of each run of one interval sums the run in position
// order and adds it to the output.  The sums are taken in one fixed
// order whatever the launch: no atomics, so two launches give the same
// bits, and a row's intervals may span any width.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

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

#define ADJ_THREADS 256
#define ADJ_TILE 1024               // queries of one row per tile

__global__ void __launch_bounds__(ADJ_THREADS)
spline_adjoint_kernel(const float* __restrict__ u,
                      const float* __restrict__ gr, float* dc, int npix,
                      Geo g) {
  __shared__ unsigned long long s_key[ADJ_TILE];   // interval << 32 | pos
  __shared__ float4 s_val[ADJ_TILE];
  const int tid = threadIdx.x;
  const int nm1 = g.nm1;
  const float* urow = u + (size_t)blockIdx.x * npix;
  const float* grow = gr + (size_t)blockIdx.x * npix;
  float* drow = dc + (size_t)blockIdx.x * 4 * nm1;

  // the row is 4 nm1 floats: float4 stores where it is 16-byte aligned
  if ((reinterpret_cast<uintptr_t>(drow) & 15) == 0) {
    float4* d4 = reinterpret_cast<float4*>(drow);
    for (int k = tid; k < nm1; k += ADJ_THREADS)
      d4[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int k = tid; k < 4 * nm1; k += ADJ_THREADS) drow[k] = 0.f;
  }
  __syncthreads();

  const float top = (float)(nm1 - 1);
  for (int p0 = 0; p0 < npix; p0 += ADJ_TILE) {
    const int n = min(ADJ_TILE, npix - p0);
    for (int s = tid; s < ADJ_TILE; s += ADJ_THREADS) {
      if (s < n) {
        // the forward's interval and offsets (eval1); a NaN query
        // lands in interval 0 with NaN offsets
        const float uu = urow[p0 + s], gg = grow[p0 + s];
        const float idx = fminf(fmaxf(floorf(uu), 0.f), top);
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
        s_key[s] = ((unsigned long long)(unsigned)(int)idx << 32)
                   | (unsigned)s;
        s_val[s] = make_float4(gg * dxl * dxl * dxl, gg * dxr * dxr * dxr,
                               gg * dxl, gg * dxr);
      } else {
        s_key[s] = ~0ull;                        // padding sorts last
      }
    }
    __syncthreads();
    int down = 0;
    for (int s = tid + 1; s < n; s += ADJ_THREADS)
      down |= (s_key[s] >> 32) < (s_key[s - 1] >> 32);
    if (__syncthreads_or(down)) {
      // bitonic sort of the tile's keys (unique: position in the low bits)
      for (int k = 2; k <= ADJ_TILE; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
          for (int t = tid; t < ADJ_TILE / 2; t += ADJ_THREADS) {
            const int i = 2 * t - (t & (j - 1));
            const unsigned long long a = s_key[i], b = s_key[i + j];
            if ((a > b) == ((i & k) == 0)) {
              s_key[i] = b;
              s_key[i + j] = a;
            }
          }
          __syncthreads();
        }
      }
    }
    for (int s = tid; s < n; s += ADJ_THREADS) {
      const unsigned iv = (unsigned)(s_key[s] >> 32);
      if (s > 0 && (unsigned)(s_key[s - 1] >> 32) == iv) continue;
      float4 acc = s_val[(unsigned)s_key[s]];
      for (int t = s + 1; t < n && (unsigned)(s_key[t] >> 32) == iv; ++t) {
        const float4 v = s_val[(unsigned)s_key[t]];
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      drow[iv] += acc.x;
      drow[nm1 + iv] += acc.y;
      drow[2 * nm1 + iv] += acc.z;
      drow[3 * nm1 + iv] += acc.w;
    }
    __syncthreads();   // the next tile reuses s_key / s_val and may add
                       // to the same intervals
  }
}

extern "C" int rvst_spline_adjoint(const float* u, const float* g,
                                   float* dcoeffs, int rows, int npix,
                                   int nm1, int log_step, float x0,
                                   float step, float expm1_step,
                                   void* stream) {
  if (rows == 0) return 0;
  const Geo geo = {nm1, log_step, x0, step, expm1_step};
  spline_adjoint_kernel<<<rows, ADJ_THREADS, 0, (cudaStream_t)stream>>>(
      u, g, dcoeffs, npix, geo);
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
