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
// coefficient row.  The shared mode indexes the shared row directly,
// so coefficients are never broadcast in memory.
//
// What bounds it on the H100: memory traffic.  Per element it reads
// u (4 B), writes out (4 B) and gathers 4 coefficients (16 B) from
// planes-first (C, 4, n-1) rows, against ~30 flops.  The queries of a
// row increase along p, so neighbouring threads hit the same or the
// next knot interval: the gathers of a warp fall in a few cache lines
// of each plane, and a fiber's 4 x (n-1) x 4 B = 64 KB coefficient row
// stays in L2 while its V shared rows are evaluated.
//
// Design: one thread per (row, pixel) over a flat 1-D grid (rows x
// npix exceeds gridDim.y's 65535 in the refine scan), coalesced u/out
// access, read-only loads of the coefficients, and the real expm1f.
// None of the TPU's devices are needed: no one-hot MXU gather, no
// 128-lane window rounding, no Taylor expm1, no row/tile padding.
#include <cuda_runtime.h>

__global__ void spline_eval_kernel(const float* __restrict__ coeffs,
                                   const float* __restrict__ u,
                                   float* __restrict__ out,
                                   long long total, int npix, int nm1,
                                   int rows_per_coeff, int log_step,
                                   float x0, float step, float expm1_step) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  long long row = t / npix;
  float uu = u[t];
  // fmaxf/fminf map a NaN query to interval 0; frac then stays NaN,
  // so the output is NaN like the plain version's
  float idx = fminf(fmaxf(floorf(uu), 0.f), (float)(nm1 - 1));
  float frac = uu - idx;
  int i = (int)idx;
  float dxl, dxr;
  if (log_step) {
    float xl = x0 * expf(idx * step);
    float ef = expm1f(frac * step);
    dxl = xl * ef;
    dxr = xl * (expm1_step - ef);
  } else {
    dxl = frac * step;
    dxr = (1.f - frac) * step;
  }
  const float* c = coeffs + (row / rows_per_coeff) * 4LL * nm1 + i;
  float a = __ldg(c);
  float b = __ldg(c + nm1);
  float cc = __ldg(c + 2LL * nm1);
  float d = __ldg(c + 3LL * nm1);
  out[t] = a * dxl * dxl * dxl + b * dxr * dxr * dxr + cc * dxl + d * dxr;
}

extern "C" int rvst_spline_eval(const float* coeffs, const float* u,
                                float* out, int rows, int npix, int nm1,
                                int rows_per_coeff, int log_step, float x0,
                                float step, float expm1_step, void* stream) {
  long long total = (long long)rows * npix;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  spline_eval_kernel<<<(unsigned int)blocks, threads, 0,
                       (cudaStream_t)stream>>>(
      coeffs, u, out, total, npix, nm1, rows_per_coeff, log_step, x0, step,
      expm1_step);
  return (int)cudaGetLastError();
}
