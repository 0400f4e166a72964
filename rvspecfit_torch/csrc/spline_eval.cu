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
