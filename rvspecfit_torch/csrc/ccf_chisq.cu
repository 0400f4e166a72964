// Kernel B: fused CCF chi-square of one arm.
//
// Replaces the Pallas TPU kernel rvspecfit_tpu/ops/pallas_ccf.py
// (_kernel, driven by ccf_chisq_pallas, called from fit/ccf.py:391).
//
// What it computes, for fiber b, template t and velocity v:
//   P = T[t,f] S[b,f], Q = T2[t,f] IV[b,f]            (complex products)
//   c0 = sum_f Re(P) Ecos[f,v] - Im(P) Esin[f,v]
//   c1 = sum_f Re(Q) Ecos[f,v] - Im(Q) Esin[f,v]
//   out[b,t,v] = -2 c0 + c1          (continuum)
//              = -c0^2 / c1          (no continuum)
// S and IV are the conjugated spectrum / ivar rFFTs, so these are
// circular cross-correlations evaluated at the velocity grid's
// fractional lags.  Only (B, T, V) is written: the (B, T, F) complex
// products never reach device memory.
//
// What bounds it on the H100: fp32 arithmetic.  At the main path's
// shapes (B=500, T=108, F=2049, V=401, three arms) the contraction is
// ~0.7 TFLOP of FMAs per arm (4 FMA per (b, t, f, v)), against a few
// MB of inputs that sit in L2 (bank 1.8 MB, DFT matrices 3.3 MB each).
// Tensor cores (3xTF32 or wgmma) are not used in this first version.
//
// Design: a block owns one fiber x 64 templates x 128 velocities and
// loops over frequency in chunks of 16.  Each chunk's complex products
// for its 64 templates are formed once (coalesced along f) into
// shared memory together with the 16 x 128 DFT slice; each of the 256
// threads then accumulates a 4-template x 8-velocity register tile of
// c0 and c1 in fp32 FMA, so a product is reused across 128 velocities
// and a DFT value across 64 templates.  Ragged T, V and F edges are
// masked (zero products), nothing is padded in memory.
#include <cuda_runtime.h>

#define TT 64    // templates per block
#define TV 128   // velocities per block
#define FC 16    // frequencies per shared-memory chunk
#define NTY 16   // thread rows (templates ty + NTY*i)
#define NTX 16   // thread columns (velocities tx + NTX*j)
#define RT (TT / NTY)
#define RV (TV / NTX)

__global__ void __launch_bounds__(NTX * NTY)
ccf_chisq_kernel(const float2* __restrict__ tf, const float2* __restrict__ t2f,
                 const float2* __restrict__ sf, const float2* __restrict__ ivf,
                 const float* __restrict__ ec, const float* __restrict__ es,
                 float* __restrict__ out, int nt, int nf, int nv,
                 int continuum) {
  // +1 column: the product stores walk f fastest, conflict-free
  __shared__ float s_pr[FC][TT + 1], s_pi[FC][TT + 1];
  __shared__ float s_qr[FC][TT + 1], s_qi[FC][TT + 1];
  __shared__ float s_ec[FC][TV], s_es[FC][TV];

  const int b = blockIdx.z;
  const int t0 = blockIdx.y * TT;
  const int v0 = blockIdx.x * TV;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * NTX + tx;
  const int nthreads = NTX * NTY;

  float c0[RT][RV], c1[RT][RV];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < RV; ++j) c0[i][j] = c1[i][j] = 0.f;

  const float2* srow = sf + (long long)b * nf;
  const float2* ivrow = ivf + (long long)b * nf;

  for (int f0 = 0; f0 < nf; f0 += FC) {
    for (int k = tid; k < TT * FC; k += nthreads) {
      int tl = k / FC, fl = k % FC;
      int t = t0 + tl, f = f0 + fl;
      float pr = 0.f, pi = 0.f, qr = 0.f, qi = 0.f;
      if (t < nt && f < nf) {
        float2 a = tf[(long long)t * nf + f], s = srow[f];
        float2 a2 = t2f[(long long)t * nf + f], w = ivrow[f];
        pr = a.x * s.x - a.y * s.y;
        pi = a.x * s.y + a.y * s.x;
        qr = a2.x * w.x - a2.y * w.y;
        qi = a2.x * w.y + a2.y * w.x;
      }
      s_pr[fl][tl] = pr;
      s_pi[fl][tl] = pi;
      s_qr[fl][tl] = qr;
      s_qi[fl][tl] = qi;
    }
    for (int k = tid; k < FC * TV; k += nthreads) {
      int fl = k / TV, vl = k % TV;
      int f = f0 + fl, v = v0 + vl;
      bool ok = f < nf && v < nv;
      s_ec[fl][vl] = ok ? ec[(long long)f * nv + v] : 0.f;
      s_es[fl][vl] = ok ? es[(long long)f * nv + v] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int fl = 0; fl < FC; ++fl) {
      float pr[RT], pi[RT], qr[RT], qi[RT], e_c[RV], e_s[RV];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        pr[i] = s_pr[fl][ty + NTY * i];
        pi[i] = s_pi[fl][ty + NTY * i];
        qr[i] = s_qr[fl][ty + NTY * i];
        qi[i] = s_qi[fl][ty + NTY * i];
      }
#pragma unroll
      for (int j = 0; j < RV; ++j) {
        e_c[j] = s_ec[fl][tx + NTX * j];
        e_s[j] = s_es[fl][tx + NTX * j];
      }
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < RV; ++j) {
          c0[i][j] = fmaf(pr[i], e_c[j], fmaf(-pi[i], e_s[j], c0[i][j]));
          c1[i][j] = fmaf(qr[i], e_c[j], fmaf(-qi[i], e_s[j], c1[i][j]));
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    int t = t0 + ty + NTY * i;
    if (t >= nt) continue;
    float* orow = out + ((long long)b * nt + t) * nv;
#pragma unroll
    for (int j = 0; j < RV; ++j) {
      int v = v0 + tx + NTX * j;
      if (v < nv)
        orow[v] = continuum ? -2.f * c0[i][j] + c1[i][j]
                            : -(c0[i][j] * c0[i][j]) / c1[i][j];
    }
  }
}

extern "C" int rvst_ccf_chisq(const float* tfft, const float* t2fft,
                              const float* sfft_conj, const float* ivfft_conj,
                              const float* ecos, const float* esin, float* out,
                              int nb, int nt, int nf, int nv, int continuum,
                              void* stream) {
  if (nb == 0 || nt == 0 || nv == 0) return 0;
  dim3 grid((nv + TV - 1) / TV, (nt + TT - 1) / TT, nb);
  dim3 block(NTX, NTY);
  ccf_chisq_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float2*)tfft, (const float2*)t2fft, (const float2*)sfft_conj,
      (const float2*)ivfft_conj, ecos, esin, out, nt, nf, nv, continuum);
  return (int)cudaGetLastError();
}
