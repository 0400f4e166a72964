// Kernel B: fused CCF chi-square of one arm, on tensor cores: in
// 3xTF32 for complex64 inputs (rvst_ccf_chisq), in float64 on the FP64
// tensor cores for complex128 inputs (rvst_ccf_chisq_f64, the card's
// working type; the second half of this file).
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
// Form: one GEMM over flattened rows m = b T + t (M = B T), N = V and
// K = 2F.  The A operand of row m is [Re X(f) | -Im X(f)] and the B
// operand is [Ecos; Esin], so A E = sum_f Re X Ecos - Im X Esin.  With
// continuum the output is linear in the products and X = R =
// -2 P + Q: a single accumulator, whose value is the output.  Without
// continuum X = P and X = Q give two accumulators that share every
// B-operand tile; the epilogue writes -c0^2 / c1.
//
// What bounds the float form on the H100: tensor-core operations.  At the main
// path's shapes (B=500, T=108, F=2049, V=401) the GEMM is 2 M N K =
// 177.5 GFLOP; 3xTF32 issues it three times, 532 GFLOP at 495 TFLOP/s
// = 1.08 ms.  The inputs (bank 3.5 MB, exposure 16.4 MB, DFT matrices
// 6.6 MB) stay in the 50 MB L2 and the 86.6 MB output is ~26 us of HBM.
//
// Precision: single-pass TF32 (10 mantissa bits) breaks the chi-square
// (device.py).  Each fp32 operand x is split as hi = tf32(x), lo =
// tf32(x - hi) (cvt.rna: round to nearest, ties away), and every tile
// product accumulates lo*hi + hi*lo + hi*hi in fp32 with
// mma.sync.m16n8k8 TF32: about fp32 accuracy (the dropped lo*lo term
// is ~2^-22 relative).
//
// Design: a block of 8 warps owns 128 rows x BN velocities (BN = 208
// with continuum, two column blocks cover V = 401; 112 without, where
// the two accumulators take the registers) and walks K in chunks of 8
// frequencies (16 K entries: 8 real parts, then 8 negated imaginary
// parts).  Each warp accumulates a 32 x (BN / 2) tile with mma.sync.
// * Operand layouts (made by the wrapper, nothing padded): (T, T2) and
//   (S, IV) interleaved per (row, frequency), and [Ecos; Esin] split
//   into TF32 (hi, lo) parts, (F, V, 4) of (Ecos hi, Ecos lo, Esin hi,
//   Esin lo).  Every copy is then a 16-byte cp.async.cg, and one
//   16-byte shared load gives the B fragments of both K steps.
// * A operand: a block's 128 rows hold at most 128 distinct templates
//   and, at T = 108, 2-3 fibers; the chunk's (T, T2) is copied once per
//   distinct template and (S, IV) once per distinct fiber, and the
//   block forms [Re X | -Im X] row by row in shared memory.  It is split
//   into hi/lo as its fragments load (each is reused over 13 column
//   tiles).
// * Pipeline: a three-stage ring of raw inputs, a four-stage ring of B
//   tiles and a double-buffered A tile, with one barrier per chunk.
//   After it the block issues the copies of chunk c + 3 and runs the
//   MMAs of chunk c, with the forming of chunk c + 1's A tile spread
//   between the column tiles so that the tensor cores are not idle
//   while it runs.
// Ragged M, N and K edges are zero-filled in shared memory by the
// copies themselves (src-size 0) or masked at formation; nothing is
// padded in device memory.  The shared-memory strides make every
// fragment load conflict-free.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

// RVST_ABLATE (0 when unset) builds parts of the kernel alone, to time
// them (tools/torch_ablate.py): 1 drops the cp.async copies (the
// shared tiles keep whatever they hold); 2 also drops the A forming,
// the per-chunk barrier and the shared fragment loads (fragments made
// in registers), leaving the 3xTF32 mma.sync stream; 3 is 2 with the
// hi*hi product only.  Only 0 computes the function.
#ifndef RVST_ABLATE
#define RVST_ABLATE 0
#endif

#define NWM 4                      // warps along M
#define NWN 2                      // warps along N
#define MT 2                       // m16 tiles per warp (32 rows)
#define NTHREADS (32 * NWM * NWN)
#define BM (NWM * MT * 16)         // rows per block
#define KF 8                       // frequencies per K chunk
#define BK (2 * KF)                // K entries per chunk
#define NSTAGE 3                   // raw-input ring depth
#define NSTAGE_B 4                 // B-operand ring depth
#define SA_STRIDE (BK + 4)         // 20: (20 g + q) % 32 distinct
#define RAW_F4 (2 * BM * KF)       // (T, T2) per template, (S, IV) per fiber
#define FROWS (NTHREADS / KF)      // rows formed per pass (32)

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16-byte cp.async that bypasses L1 (zero-fill when !ok)
__device__ __forceinline__ void cp_async_cg16(void* dst, const void* src,
                                              bool ok) {
  uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// all but the most recent group complete
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_2() {
  asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

// NACC accumulators; each warp owns MT m16 tiles x NTW n8 tiles
template <int NACC, int NTW>
struct Shape {
  static constexpr int BN = NWN * NTW * 8;
  // float4 stride: SB_STRIDE % 8 == 2, so the 16-byte fragment loads
  // of a quarter-warp hit distinct banks
  static constexpr int SB_STRIDE = BN + 2;
  static constexpr int SB_F4 = KF * SB_STRIDE;
  static constexpr int SA_FLOATS = NACC * BM * SA_STRIDE;
  static constexpr int KSPLIT = NTHREADS / BN;   // threads per B column
  static constexpr size_t SMEM_BYTES =
      sizeof(float4) * (NSTAGE * RAW_F4 + NSTAGE_B * SB_F4)
      + sizeof(float) * 2 * SA_FLOATS;
  static_assert(SB_STRIDE % 8 == 2, "B-operand stride");
  static_assert(KSPLIT >= 1 && KF % KSPLIT == 0, "B copy split");
};

template <int NACC, int NTW>
__global__ void __launch_bounds__(NTHREADS, 1)
ccf_chisq_kernel(const float4* __restrict__ tt2, const float4* __restrict__ siv,
                 const float4* __restrict__ e, float* __restrict__ out,
                 int nb, int nt, int nf, int nv) {
  using S = Shape<NACC, NTW>;
  constexpr int BN = S::BN;
  constexpr int SBS = S::SB_STRIDE;
  extern __shared__ float4 smem4[];
  // raw[stage]: (T, T2)[BM][KF] by template slot, (S, IV)[BM][KF] by
  // fiber slot
  float4* raw = smem4;
  float4* sb = raw + NSTAGE * RAW_F4;
  float* sa = reinterpret_cast<float*>(sb + NSTAGE_B * S::SB_F4);
  __shared__ int s_rt[BM], s_rb[BM];      // row -> template / fiber slot
  __shared__ int s_toff[BM], s_boff[BM];  // slot -> row offset in T / S

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % NWM, wn = warp / NWM;
  const int g = lane >> 2, q = lane & 3;
  const int m_total = nb * nt;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nchunks = (nf + KF - 1) / KF;

  // slots: with T >= BM every row has its own template; otherwise slot
  // t holds template t.  Fiber slot s holds fiber b_first + s.
  const int b_first = m0 / nt, t_first = m0 - b_first * nt;
  const int m_last = min(m0 + BM, m_total) - 1;
  const int nts = min(nt, BM), nbs = m_last / nt - b_first + 1;
  for (int r = tid; r < BM; r += NTHREADS) {
    const int m = m0 + r, b = m / nt, t = m - b * nt;
    const bool valid = m < m_total;
    s_rt[r] = valid ? (nt >= BM ? r : t) : -1;
    s_rb[r] = valid ? b - b_first : -1;
    const int ts = nt >= BM ? (t_first + r) % nt : r;
    s_toff[r] = r < nts && (nt < BM || valid) ? ts * nf : -1;
    s_boff[r] = r < nbs ? (b_first + r) * nf : -1;
  }
  __syncthreads();

  // B copies: column bn, frequencies bk + KSPLIT j of every chunk
  const int bn = tid % BN, bk = tid / BN;
  const bool bcol = n0 + bn < nv;
  const float4* ecol = e + n0 + bn;

  auto issue = [&](int chunk) {
    if (RVST_ABLATE < 1 && chunk < nchunks) {
      const int stage = chunk % NSTAGE, f0 = chunk * KF;
      float4* rdst = raw + stage * RAW_F4;
      for (int i = tid; i < nts * KF; i += NTHREADS) {
        const int slot = i / KF, f = f0 + i % KF, off = s_toff[slot];
        const bool ok = off >= 0 && f < nf;
        cp_async_cg16(rdst + i, ok ? tt2 + off + f : tt2, ok);
      }
      for (int i = tid; i < nbs * KF; i += NTHREADS) {
        const int slot = i / KF, f = f0 + i % KF, off = s_boff[slot];
        const bool ok = f < nf;
        cp_async_cg16(rdst + BM * KF + i, ok ? siv + off + f : siv, ok);
      }
      if (bk < S::KSPLIT) {
        float4* bdst = sb + (chunk % NSTAGE_B) * S::SB_F4 + bn;
#pragma unroll
        for (int j = 0; j < KF / S::KSPLIT; ++j) {
          const int k = bk + S::KSPLIT * j, f = f0 + k;
          const bool ok = bcol && f < nf;
          cp_async_cg16(bdst + k * SBS, ok ? ecol + (size_t)f * nv : e, ok);
        }
      }
    }
    cp_async_commit();   // possibly empty: keeps one group per chunk
  };

  // row i of this thread's share of a chunk's A tile, formed from the
  // raw copies: frequency fl of row rq + FROWS i.  Branch-free, so that
  // it interleaves with the MMAs of the previous chunk.
  const int fl = tid % KF, rq = tid / KF;
  auto form_row = [&](int chunk, int i) {
    const float4* rw = raw + (chunk % NSTAGE) * RAW_F4 + fl;
    const int r = rq + FROWS * i, ts = s_rt[r];
    const float keep = ts >= 0 ? 1.f : 0.f;
    const float4 a = rw[max(ts, 0) * KF];
    const float4 s = rw[BM * KF + max(s_rb[r], 0) * KF];
    const float pr = keep * (a.x * s.x - a.y * s.y);
    const float pi = keep * (a.x * s.y + a.y * s.x);
    const float qr = keep * (a.z * s.z - a.w * s.w);
    const float qi = keep * (a.z * s.w + a.w * s.z);
    float* row = sa + (chunk & 1) * S::SA_FLOATS + r * SA_STRIDE + fl;
    if (NACC == 1) {
      row[0] = -2.f * pr + qr;
      row[KF] = 2.f * pi - qi;
    } else {
      row[0] = pr;
      row[KF] = -pi;
      row[BM * SA_STRIDE] = qr;
      row[BM * SA_STRIDE + KF] = -qi;
    }
  };

  float acc[NACC][MT][NTW][4];
#pragma unroll
  for (int a = 0; a < NACC; ++a)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[a][mt][j][x] = 0.f;

  issue(0);
  issue(1);
  issue(2);
  cp_async_wait_2();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < BM / FROWS; ++i) form_row(0, i);
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait_1();     // this thread's copies of chunk c + 1 landed
    // every thread's copies of c + 1 and A tile of c are visible, and
    // every warp is past the MMAs of c - 1
    if (RVST_ABLATE < 2) __syncthreads();
    // raw inputs into the stage chunk c used, B into that of c - 1
    issue(c + 3);

    const float* wa = sa + (c & 1) * S::SA_FLOATS + wm * MT * 16 * SA_STRIDE;
    const float4* wb = sb + (c % NSTAGE_B) * S::SB_F4 + wn * (NTW * 8);
    // A fragments of both K steps: real parts (step 0), imaginary (1)
    uint32_t ahi[2][NACC][MT][4], alo[2][NACC][MT][4];
#pragma unroll
    for (int st = 0; st < 2; ++st)
#pragma unroll
      for (int a = 0; a < NACC; ++a)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float* p = wa + a * BM * SA_STRIDE
                           + (mt * 16 + g) * SA_STRIDE + st * KF + q;
          if (RVST_ABLATE >= 2) {
            split_tf32((float)(c + mt + st), ahi[st][a][mt][0],
                       alo[st][a][mt][0]);
            for (int x = 1; x < 4; ++x) {
              ahi[st][a][mt][x] = ahi[st][a][mt][0];
              alo[st][a][mt][x] = alo[st][a][mt][0];
            }
            continue;
          }
          split_tf32(p[0], ahi[st][a][mt][0], alo[st][a][mt][0]);
          split_tf32(p[8 * SA_STRIDE], ahi[st][a][mt][1], alo[st][a][mt][1]);
          split_tf32(p[4], ahi[st][a][mt][2], alo[st][a][mt][2]);
          split_tf32(p[8 * SA_STRIDE + 4], ahi[st][a][mt][3],
                     alo[st][a][mt][3]);
        }
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      // frequencies q and q + 4 of column j * 8 + g: (cos hi, cos lo,
      // sin hi, sin lo) feed both steps
      const float4* p = wb + q * SBS + j * 8 + g;
      const float4 e0 =
          RVST_ABLATE >= 2 ? make_float4(c + j, 1.f, c - j, 1.f) : p[0];
      const float4 e1 = RVST_ABLATE >= 2 ? e0 : p[4 * SBS];
      const uint32_t bhi[2][2] = {
          {__float_as_uint(e0.x), __float_as_uint(e1.x)},
          {__float_as_uint(e0.z), __float_as_uint(e1.z)}};
      const uint32_t blo[2][2] = {
          {__float_as_uint(e0.y), __float_as_uint(e1.y)},
          {__float_as_uint(e0.w), __float_as_uint(e1.w)}};
#pragma unroll
      for (int st = 0; st < 2; ++st)
#pragma unroll
        for (int a = 0; a < NACC; ++a)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            if (RVST_ABLATE < 3) {
              mma_tf32(acc[a][mt][j], alo[st][a][mt], bhi[st]);
              mma_tf32(acc[a][mt][j], ahi[st][a][mt], blo[st]);
            }
            mma_tf32(acc[a][mt][j], ahi[st][a][mt], bhi[st]);
          }
      // chunk c + 1's A tile (into the buffer chunk c - 1 used), spread
      // over the column tiles; past the last chunk it forms unused rows
#pragma unroll
      for (int i = 0; i < BM / FROWS; ++i)
        if (RVST_ABLATE < 2 && j == i * NTW / (BM / FROWS))
          form_row(c + 1, i);
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int m = m0 + (wm * MT + mt) * 16 + g + 8 * h;
      if (m >= m_total) continue;
      float* orow = out + (size_t)m * nv;
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          int v = n0 + wn * (NTW * 8) + j * 8 + 2 * q + e;
          if (v >= nv) continue;
          float c0 = acc[0][mt][j][2 * h + e];
          if (NACC == 1) {
            orow[v] = c0;
          } else {
            float c1 = acc[NACC - 1][mt][j][2 * h + e];
            orow[v] = -(c0 * c0) / c1;
          }
        }
    }
}

template <int NACC, int NTW>
static int launch(const float* tt2, const float* siv, const float* e_quads,
                  float* out, int nb, int nt, int nf, int nv,
                  cudaStream_t stream) {
  using S = Shape<NACC, NTW>;
  auto kernel = ccf_chisq_kernel<NACC, NTW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)S::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  long long m_total = (long long)nb * nt;
  dim3 grid((nv + S::BN - 1) / S::BN, (unsigned)((m_total + BM - 1) / BM));
  kernel<<<grid, NTHREADS, S::SMEM_BYTES, stream>>>(
      (const float4*)tt2, (const float4*)siv, (const float4*)e_quads, out, nb,
      nt, nf, nv);
  return (int)cudaGetLastError();
}

// tt2: (T, F) of (T re, T im, T2 re, T2 im); siv: (B, F) of (S re, S im,
// IV re, IV im); e_quads: (F, V) of (Ecos hi, Ecos lo, Esin hi, Esin lo)
extern "C" int rvst_ccf_chisq(const float* tt2, const float* siv,
                              const float* e_quads, float* out, int nb,
                              int nt, int nf, int nv, int continuum,
                              void* stream) {
  if (nb == 0 || nt == 0 || nv == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return continuum
             ? launch<1, 13>(tt2, siv, e_quads, out, nb, nt, nf, nv, s)
             : launch<2, 7>(tt2, siv, e_quads, out, nb, nt, nf, nv, s);
}

// ---------------------------------------------------------------------
// The float64 form: the same GEMM (rows m = b T + t, K = 2F, N = V) with
// every operand, product and sum in double, on the FP64 tensor cores
// (mma.sync.m16n8k8 f64; Hopper's wgmma takes no f64).
//
// Why double: the contraction's terms reach ~4e6 while the best
// template's chi-square rises by 0.1-3 from one velocity step to the
// next, so float32 (and 3xTF32) rounding moves the CCF's minimum by
// steps (ROADMAP C.2).  In double the rounding is ~1e-16 of the terms.
//
// What bounds it on the H100: FP64 tensor-core operations, 2 M N K per
// accumulator at 67 TFLOP/s: at B = 1000, T = 108, F = 2049, V = 401 one
// arm is 3.55e11 FLOP, 5.3 ms.  The inputs stay in L2 but for the
// exposure's (S, IV) at B = 1000 (65.6 MB), each read once per column
// block.
//
// Design (simple first, the float kernel's skeleton): a block of 8 warps
// (2 along M x 4 along N) owns 64 rows x BN velocities, each warp 32 rows
// (two m16 tiles) x NTW n8 tiles; with continuum NTW = 7 (BN = 224, two
// column blocks cover V = 401: the complex products are formed twice),
// without continuum NTW = 3 (BN = 96) because two accumulators take the
// registers.  K goes in chunks of 8 frequencies (16 K entries, two k8
// steps: real parts against Ecos, negated imaginary parts against Esin).
// * Operands (made by the wrapper): (T, T2) and (S, IV) interleaved per
//   (row, frequency) as complex128 pairs, and (Ecos, Esin) interleaved
//   per (frequency, velocity), so every copy is a 16-byte cp.async and
//   one 16-byte shared load gives a B fragment's value for both k steps.
// * A operand: as in the float kernel, the chunk's (T, T2) is copied once
//   per distinct template slot and (S, IV) once per distinct fiber slot,
//   and the block forms [Re X | -Im X] in double in shared memory, the
//   next chunk's rows between this chunk's column tiles.
// * Pipeline: a two-stage ring of raw inputs, a three-stage ring of B
//   tiles and a double-buffered A tile, one barrier per chunk; the copies
//   of chunk c + 2 fly during the MMAs of chunk c.  171 KB of shared
//   memory with continuum: one block an SM.
// * Split over F for few rows (the single-object ccf.fit, B = 1, has one
//   or two row blocks): grid.z slices of the chunks each write their
//   partial sums to a workspace, and a second kernel adds the slices in
//   order and applies the epilogue (no atomics: relaunches give the same
//   bits).  The wrapper picks the slices (ops/ccf_chisq.f64_splits).
// Shared-memory strides: A rows of 20 doubles and B rows of BN + 2
// double2 make every fragment load conflict-free.
namespace f64 {
constexpr int WM = 2, WN = 4;            // warps along M and N
constexpr int MTILES = 2;                // m16 tiles per warp
constexpr int THREADS = 32 * WM * WN;
constexpr int ROWS = WM * MTILES * 16;   // rows per block (64)
constexpr int FREQ = 8;                  // frequencies per K chunk
constexpr int A_STRIDE = 2 * FREQ + 4;   // doubles; % 16 == 4
constexpr int RAW = 2 * ROWS * 2 * FREQ; // double2 per raw stage
constexpr int FORM_ROWS = THREADS / FREQ;
constexpr int NB_STAGE = 3;              // B-operand ring depth

template <int NACC, int NTW>
struct Shape {
  static constexpr int BN = WN * NTW * 8;
  static constexpr int B_STRIDE = BN + 2;          // double2; % 8 == 2
  static constexpr int B_D2 = FREQ * B_STRIDE;
  static constexpr int A_DOUBLES = NACC * ROWS * A_STRIDE;
  static constexpr size_t SMEM_BYTES =
      sizeof(double2) * (2 * RAW + NB_STAGE * B_D2)
      + sizeof(double) * 2 * A_DOUBLES;
  static_assert(B_STRIDE % 8 == 2, "B-operand stride");
};
}  // namespace f64

__device__ __forceinline__ void mma_f64(double* c, const double* a,
                                        const double* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

__device__ __forceinline__ void cp_async_wait_0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// chunks [blockIdx.z cps, + cps) of F; dst is the output (one slice) or
// the slices' workspace (NACC planes of M x V per slice)
template <int NACC, int NTW>
__global__ void __launch_bounds__(f64::THREADS, 1)
ccf_chisq_f64_kernel(const double2* __restrict__ tt2,
                     const double2* __restrict__ siv,
                     const double2* __restrict__ e, double* __restrict__ dst,
                     int nb, int nt, int nf, int nv, int cps, int sliced) {
  using namespace f64;
  using S = f64::Shape<NACC, NTW>;
  constexpr int BN = S::BN;
  constexpr int SBS = S::B_STRIDE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // raw[stage]: (T | T2)[ROWS][FREQ] by template slot, then
  // (S | IV)[ROWS][FREQ] by fiber slot
  double2* raw = reinterpret_cast<double2*>(smem_raw);
  double2* sb = raw + 2 * RAW;
  double* sa = reinterpret_cast<double*>(sb + NB_STAGE * S::B_D2);
  __shared__ int s_rt[ROWS], s_rb[ROWS];      // row -> template / fiber slot
  __shared__ int s_toff[ROWS], s_boff[ROWS];  // slot -> row offset in T / S

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int g = lane >> 2, q = lane & 3;
  const int m_total = nb * nt;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * ROWS;
  const int nchunks = (nf + FREQ - 1) / FREQ;
  const int c_first = blockIdx.z * cps;
  const int nloc = min(cps, nchunks - c_first);

  const int b_first = m0 / nt, t_first = m0 - b_first * nt;
  const int m_last = min(m0 + ROWS, m_total) - 1;
  const int nts = min(nt, ROWS), nbs = m_last / nt - b_first + 1;
  for (int r = tid; r < ROWS; r += THREADS) {
    const int m = m0 + r, b = m / nt, t = m - b * nt;
    const bool valid = m < m_total;
    s_rt[r] = valid ? (nt >= ROWS ? r : t) : -1;
    s_rb[r] = valid ? b - b_first : -1;
    const int ts = nt >= ROWS ? (t_first + r) % nt : r;
    s_toff[r] = r < nts && (nt < ROWS || valid) ? ts * nf : -1;
    s_boff[r] = r < nbs ? (b_first + r) * nf : -1;
  }
  __syncthreads();

  auto issue = [&](int lc) {
    if (lc < nloc) {
      const int f0 = (c_first + lc) * FREQ;
      double2* rdst = raw + (lc & 1) * RAW;
      for (int i = tid; i < nts * 2 * FREQ; i += THREADS) {
        const int slot = i / (2 * FREQ), h = (i / FREQ) & 1;
        const int f = f0 + i % FREQ, off = s_toff[slot];
        const bool ok = off >= 0 && f < nf;
        cp_async_cg16(rdst + i, ok ? tt2 + 2 * (off + f) + h : tt2, ok);
      }
      for (int i = tid; i < nbs * 2 * FREQ; i += THREADS) {
        const int slot = i / (2 * FREQ), h = (i / FREQ) & 1;
        const int f = f0 + i % FREQ, off = s_boff[slot];
        const bool ok = f < nf;
        cp_async_cg16(rdst + ROWS * 2 * FREQ + i,
                      ok ? siv + 2 * (off + f) + h : siv, ok);
      }
      double2* bdst = sb + (lc % NB_STAGE) * S::B_D2;
      for (int i = tid; i < FREQ * BN; i += THREADS) {
        const int k = i / BN, col = i - k * BN;
        const int f = f0 + k, v = n0 + col;
        const bool ok = f < nf && v < nv;
        cp_async_cg16(bdst + k * SBS + col, ok ? e + (size_t)f * nv + v : e,
                      ok);
      }
    }
    cp_async_commit();   // possibly empty: keeps one group per chunk
  };

  // pass i of this thread's share of a chunk's A tile: frequency fl of
  // row rq + FORM_ROWS i
  const int fl = tid % FREQ, rq = tid / FREQ;
  auto form_row = [&](int lc, int i) {
    const double2* rw = raw + (lc & 1) * RAW + fl;
    const int r = rq + FORM_ROWS * i, ts = s_rt[r];
    const double keep = ts >= 0 ? 1.0 : 0.0;
    const double2* rt = rw + max(ts, 0) * 2 * FREQ;
    const double2* rs = rw + ROWS * 2 * FREQ + max(s_rb[r], 0) * 2 * FREQ;
    const double2 a = rt[0], a2 = rt[FREQ], s = rs[0], iv = rs[FREQ];
    const double pr = keep * (a.x * s.x - a.y * s.y);
    const double pi = keep * (a.x * s.y + a.y * s.x);
    const double qr = keep * (a2.x * iv.x - a2.y * iv.y);
    const double qi = keep * (a2.x * iv.y + a2.y * iv.x);
    double* row = sa + (lc & 1) * S::A_DOUBLES + r * A_STRIDE + fl;
    if (NACC == 1) {
      row[0] = -2.0 * pr + qr;
      row[FREQ] = 2.0 * pi - qi;
    } else {
      row[0] = pr;
      row[FREQ] = -pi;
      row[ROWS * A_STRIDE] = qr;
      row[ROWS * A_STRIDE + FREQ] = -qi;
    }
  };

  double acc[NACC][MTILES][NTW][4];
#pragma unroll
  for (int a = 0; a < NACC; ++a)
#pragma unroll
    for (int mt = 0; mt < MTILES; ++mt)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[a][mt][j][x] = 0.0;

  issue(0);
  issue(1);
  cp_async_wait_1();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < ROWS / FORM_ROWS; ++i) form_row(0, i);
  for (int c = 0; c < nloc; ++c) {
    cp_async_wait_0();     // this thread's copies of chunk c + 1 landed
    // every thread's copies of c + 1 and A tile of c are visible, and
    // every warp is past the MMAs of c - 1
    __syncthreads();
    // raw inputs into the stage chunk c used, B into that of c - 1
    issue(c + 2);

    const double* wa = sa + (c & 1) * S::A_DOUBLES
                       + wm * MTILES * 16 * A_STRIDE;
    const double2* wb = sb + (c % NB_STAGE) * S::B_D2 + wn * (NTW * 8);
    // A fragments of both k steps: real parts (step 0), imaginary (1)
    double af[2][NACC][MTILES][4];
#pragma unroll
    for (int st = 0; st < 2; ++st)
#pragma unroll
      for (int a = 0; a < NACC; ++a)
#pragma unroll
        for (int mt = 0; mt < MTILES; ++mt) {
          const double* p = wa + a * ROWS * A_STRIDE
                            + (mt * 16 + g) * A_STRIDE + st * FREQ + q;
          af[st][a][mt][0] = p[0];
          af[st][a][mt][1] = p[8 * A_STRIDE];
          af[st][a][mt][2] = p[4];
          af[st][a][mt][3] = p[8 * A_STRIDE + 4];
        }
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      // frequencies q and q + 4 of column j * 8 + g: (cos, sin) feed
      // both steps
      const double2* p = wb + q * SBS + j * 8 + g;
      const double2 e0 = p[0], e1 = p[4 * SBS];
      const double bf[2][2] = {{e0.x, e1.x}, {e0.y, e1.y}};
#pragma unroll
      for (int st = 0; st < 2; ++st)
#pragma unroll
        for (int a = 0; a < NACC; ++a)
#pragma unroll
          for (int mt = 0; mt < MTILES; ++mt)
            mma_f64(acc[a][mt][j], af[st][a][mt], bf[st]);
      // chunk c + 1's A tile (into the buffer chunk c - 1 used), spread
      // over the column tiles; past the last chunk it forms unused rows
#pragma unroll
      for (int i = 0; i < ROWS / FORM_ROWS; ++i)
        if (j == i * NTW / (ROWS / FORM_ROWS)) form_row(c + 1, i);
    }
  }

  const size_t mv = (size_t)m_total * nv;
#pragma unroll
  for (int mt = 0; mt < MTILES; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int m = m0 + (wm * MTILES + mt) * 16 + g + 8 * h;
      if (m >= m_total) continue;
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          int v = n0 + wn * (NTW * 8) + j * 8 + 2 * q + x;
          if (v >= nv) continue;
          const size_t o = (size_t)m * nv + v;
          const double c0 = acc[0][mt][j][2 * h + x];
          if (sliced) {
#pragma unroll
            for (int a = 0; a < NACC; ++a)
              dst[(blockIdx.z * NACC + a) * mv + o] = acc[a][mt][j][2 * h + x];
          } else if (NACC == 1) {
            dst[o] = c0;
          } else {
            const double c1 = acc[NACC - 1][mt][j][2 * h + x];
            dst[o] = -(c0 * c0) / c1;
          }
        }
    }
}

// the slices' partial sums, added in slice order, through the epilogue
template <int NACC>
__global__ void ccf_chisq_f64_reduce(const double* __restrict__ ws,
                                     double* __restrict__ out, size_t mv,
                                     int nsplit) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < mv;
       i += (size_t)gridDim.x * blockDim.x) {
    double c[NACC];
#pragma unroll
    for (int a = 0; a < NACC; ++a) {
      c[a] = 0.0;
      for (int s = 0; s < nsplit; ++s) c[a] += ws[(s * NACC + a) * mv + i];
    }
    out[i] = NACC == 1 ? c[0] : -(c[0] * c[0]) / c[NACC - 1];
  }
}

template <int NACC, int NTW>
static int launch_f64(const double* tt2, const double* siv, const double* e,
                      double* out, double* ws, int nb, int nt, int nf, int nv,
                      int nsplit, cudaStream_t stream) {
  using S = f64::Shape<NACC, NTW>;
  auto kernel = ccf_chisq_f64_kernel<NACC, NTW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)S::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int nchunks = (nf + f64::FREQ - 1) / f64::FREQ;
  const int cps = std::max(1, (nchunks + nsplit - 1) / nsplit);
  nsplit = std::max(1, (nchunks + cps - 1) / cps);   // no empty slice
  const long long m_total = (long long)nb * nt;
  dim3 grid((nv + S::BN - 1) / S::BN,
            (unsigned)((m_total + f64::ROWS - 1) / f64::ROWS), nsplit);
  const bool sliced = nsplit > 1;
  kernel<<<grid, f64::THREADS, S::SMEM_BYTES, stream>>>(
      (const double2*)tt2, (const double2*)siv, (const double2*)e,
      sliced ? ws : out, nb, nt, nf, nv, cps, sliced);
  err = cudaGetLastError();
  if (err != cudaSuccess || !sliced) return (int)err;
  const size_t mv = (size_t)m_total * nv;
  const unsigned blocks = (unsigned)std::min<size_t>((mv + 255) / 256, 4096);
  ccf_chisq_f64_reduce<NACC><<<blocks, 256, 0, stream>>>(ws, out, mv, nsplit);
  return (int)cudaGetLastError();
}

// tt2: (T, F, 2) complex128 of (T, T2); siv: (B, F, 2) complex128 of
// (S, IV); e: (F, V, 2) double of (Ecos, Esin); ws: with nsplit > 1 a
// workspace of nsplit x (1 with continuum, else 2) x B T V doubles
extern "C" int rvst_ccf_chisq_f64(const double* tt2, const double* siv,
                                  const double* e, double* out, double* ws,
                                  int nb, int nt, int nf, int nv,
                                  int continuum, int nsplit, void* stream) {
  if (nb == 0 || nt == 0 || nv == 0) return 0;
  if (nsplit < 1 || (nsplit > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return continuum
             ? launch_f64<1, 7>(tt2, siv, e, out, ws, nb, nt, nf, nv, nsplit, s)
             : launch_f64<2, 3>(tt2, siv, e, out, ws, nb, nt, nf, nv, nsplit,
                                s);
}
