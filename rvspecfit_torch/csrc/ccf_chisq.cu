// Kernel B: fused CCF chi-square of one arm, on tensor cores: in
// 3xTF32 for complex64 inputs (rvst_ccf_chisq), in float64 on the FP64
// tensor cores for complex128 inputs (rvst_ccf_chisq_f64, the card's
// working type; the second half of this file, with its own design).
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
// them (tools/torch_ablate.py).  Float form: 1 drops the cp.async
// copies (the shared tiles keep whatever they hold); 2 also drops the A
// forming, the per-chunk barrier and the shared fragment loads
// (fragments made in registers), leaving the 3xTF32 mma.sync stream; 3
// is 2 with the hi*hi product only.  Float64 form: 1 drops the bulk
// copies (the ring's barriers still pass); 2 also the complex products
// (A fragments made in registers); 3 also the barriers and shared loads,
// leaving the FP64 mma.sync stream.  Only 0 computes the function.
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
// arm is 3.55e11 FLOP, 5.3 ms.
//
// What held the first float64 kernel (one block of 64 rows x 224
// velocities, an A tile formed in shared memory, cp.async, a barrier per
// 8 frequencies) at 35% of that bound, from its ablation at B = 1000
// (tools/torch_ablate.py ccf_chisq --dtype float64, PERF.md): 6.87 ms of
// MMA stream at its tiling (two column blocks of 224 cover 448 of 401
// velocities), 0.66 ms of barriers and fragment loads, 1.60 ms of
// forming the complex products (each twice, once per column block) and
// 6.07 ms waiting for copies: each 64-row block read 64 templates' and
// 224 velocities' worth of operands per frequency, ~39 GB from L2 in
// all.  Forming is dear because FP64 FMAs and FP64 MMAs share a pipe.
//
// Design:
// * Tiles of fibers x templates.  A block owns BT templates x BB fibers
//   (BT BB = 128 rows with continuum, a power of two BT that the wrapper
//   picks to pad least: 4 x 32 at T = 108) x 136 velocities (three
//   column blocks cover 408 of 401: 1.7% of the MMAs multiply padding,
//   against 10.5% before).  Per frequency a block reads BT + BB operand
//   rows (36 at T = 108, against 64 + 1) and 136 (cos, sin) pairs: ~18
//   GB from L2 at B = 1000.
// * Forming in registers, once per block.  Each warp owns 16 rows x all
//   136 velocities (17 n8 tiles, one m16 tile), so no two warps of a
//   block form the same product: a thread forms its A fragment (rows g
//   and g + 8 at one frequency) straight from the operands in shared
//   memory, 8 FMAs per complex value (the wrapper scales T by -2,
//   exactly, with continuum).  There is no A tile and no barrier between
//   warps.
// * A ring of 4 stages of 8 frequencies whose "full" and "empty"
//   mbarriers let each warp run on its own (no block-wide barrier in
//   the loop).  Warp 0 also fills it, once every warp has released a
//   slot, with 1-D bulk copies (cp.async.bulk, no tensor map): the
//   stage's (Ecos, Esin), the block's templates and, where the blocks
//   fill the card, the block's fibers, each one contiguous run.  At few
//   rows (sliced, below) each warp instead copies the S and IV of its
//   own rows' fibers into its own slots with 16-byte cp.async that
//   zero-fill past F: there a per-call layout would cost more than it
//   saves, while at B = 1000 the cp.async, issued by the warps that
//   feed the MMAs, cost 0.9 ms (64 small bulk copies a stage doubled
//   the time; 512 cp.async a stage from warp 0 alone paced the block).
//   A separate producer warp would put 3 warps on one SM sub-partition
//   and cap every thread at 168 registers: the accumulators then spill.
// * Operand layouts (ops/ccf_chisq.py), padded with zeros: (Fp / 8, T,
//   17) complex (-2T or T, T2 interleaved, then a zero) built once per
//   bank; (ceil(V / 136), Fp, 138, 2) real (Ecos, Esin) once per
//   velocity grid; (Fp / 8, B, 17) complex (S, then IV, then a zero)
//   per call where the blocks fill the card; Fp a multiple of 8.
// * Few rows (the single-object ccf.fit, B = 1: three blocks): the
//   chunks of 8 frequencies are split into slices (grid.z), balanced,
//   none empty.  The slices of a block are the CTAs of a thread-block
//   cluster; after the loop each CTA stages its sums in its own shared
//   memory and the cluster adds them through distributed shared memory in
//   rank order, each CTA a share of the tile.  Where the wrapper asks for
//   more slices than a cluster holds, each cluster writes its sum to a
//   workspace and a second kernel adds them in cluster order.  No
//   atomics: relaunches give the same bits.
// * Without continuum two accumulators take the registers: each warp
//   owns 16 rows x 72 or 64 velocities (two warps a row range, 64-row
//   blocks) and the products are formed twice.
// Shared-memory strides: E rows of 138 double2 (% 8 == 2) and raw slots
// of 17 double2 make every fragment load conflict-free.
namespace f64 {
constexpr int FREQ = 8;                  // frequencies per stage (2 k8 steps)
constexpr int RING = 4;                  // stages in the ring
constexpr int COLS = 136;                // velocities per column block
constexpr int NT8 = COLS / 8;            // n8 tiles per column block (17)
constexpr int E_STRIDE = COLS + 2;       // double2 per E row
constexpr int SLOT = 2 * FREQ + 1;       // double2 per raw operand slot
constexpr int WARPS = 8;                 // warp 0 also fills the ring
constexpr int THREADS = 32 * WARPS;
constexpr int BAR_BYTES = 128;           // full[RING], empty[RING]
constexpr int E_BYTES = FREQ * E_STRIDE * 16;
constexpr int STG_STRIDE = COLS + 2;     // doubles per staged sum row
constexpr int MAX_CLUSTER = 8;           // CTAs a cluster (portable size)

// NACC accumulators: warps along N, rows per block, n8 tiles of warp
// column 0 (column 1 takes the rest)
template <int NACC>
struct Tile {
  static constexpr int WN = NACC;
  static constexpr int ROWS = 16 * WARPS / WN;
  static constexpr int NT = (NT8 + WN - 1) / WN;
};

// fiber slots of one warp (its 16 rows' fibers) and raw operand slots
// of a stage: the block's templates, then each warp's fibers
__host__ __device__ inline int warp_fibers(int tlog) {
  return tlog >= 4 ? 1 : 16 >> tlog;
}

__host__ __device__ inline int raw_slots(int tlog) {
  return (1 << tlog) + WARPS * warp_fibers(tlog);
}

__host__ __device__ inline size_t stage_bytes(int nslots) {
  return E_BYTES + (size_t)nslots * SLOT * 16;
}

// the ring, or (sliced) the staged sums of NACC x 128 rows, whichever
// is larger
__host__ __device__ inline size_t smem_bytes(int nslots, bool sliced) {
  size_t ring = RING * stage_bytes(nslots);
  size_t stg = (size_t)WARPS * 16 * STG_STRIDE * sizeof(double);
  return BAR_BYTES + (sliced && stg > ring ? stg : ring);
}
}  // namespace f64

__device__ __forceinline__ void mma_f64(double* c, const double* a,
                                        const double* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t tx) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(tx) : "memory");
}

// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar), "r"(parity) : "memory");
}

// bytes global -> this CTA's shared memory, completing on ``bar``
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes),
      "r"(bar) : "memory");
}

// 16 bytes global -> shared, zeros where !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

// all but this thread's N most recent groups of cp.async have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// the double2 at this CTA's shared address ``p`` in CTA ``rank`` of
// the cluster
__device__ __forceinline__ double2 ld_cluster2(const double* p,
                                               uint32_t rank) {
  uint32_t remote;
  double2 v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  asm volatile("ld.shared::cluster.v2.f64 {%0, %1}, [%2];\n"
               : "=d"(v.x), "=d"(v.y) : "r"(remote) : "memory");
  return v;
}

// One CTA: column block cb, templates [t0, t0 + BT), fibers [b0, b0 +
// BB) (BT = 2^tlog, BB = ROWS / BT; row r of the block is template t0 +
// r % BT of fiber b0 + r / BT), stages [c_begin, c_end) of slice
// blockIdx.z.  tt2 (Fp / 8, T, SLOT), e (ncb, Fp, E_STRIDE) and siv
// (Fp / 8, B, SLOT, or null) double2 in the layouts of ops/ccf_chisq.py;
// sfft, ivfft (B, F) complex.
// Unsliced it writes out (B, T, V); sliced, the cluster's sum goes to
// out, or with more than one cluster a slice to ws (nslices / csize x
// NACC planes of B T V).
template <int NACC>
__global__ void __launch_bounds__(f64::THREADS, 1)
ccf_chisq_f64_kernel(const double2* __restrict__ tt2,
                     const double2* __restrict__ sfft,
                     const double2* __restrict__ ivfft,
                     const double2* __restrict__ siv,
                     const double2* __restrict__ e, double* __restrict__ out,
                     double* __restrict__ ws, int nb, int nt, int nf,
                     int nv, int tlog, int ncb, int ntt, int nslices,
                     int csize) {
  using namespace f64;
  using TL = f64::Tile<NACC>;
  constexpr int ROWS = TL::ROWS, NT = TL::NT;
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bt_rows = 1 << tlog, bb_rows = ROWS >> tlog;
  const int tile = blockIdx.x;
  const int cb = tile % ncb, tt = (tile / ncb) % ntt, bt = tile / ncb / ntt;
  const int t0 = tt << tlog, b0 = bt * bb_rows, n0 = cb * COLS;
  const int nchunks = (nf + FREQ - 1) / FREQ;
  const int c_begin = (int)((long long)blockIdx.z * nchunks / nslices);
  const int nloc =
      (int)((long long)(blockIdx.z + 1) * nchunks / nslices) - c_begin;
  const int nts = min(bt_rows, nt - t0), nbs = min(bb_rows, nb - b0);
  const size_t sbytes = stage_bytes(raw_slots(tlog));
  auto stage = [&](int s) { return smem + BAR_BYTES + s * sbytes; };
  const uint32_t full0 = smem_u32(smem), empty0 = full0 + 8 * RING;

  if (tid == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int g = lane >> 2, q = lane & 3;
  const int wm = warp % (WARPS / TL::WN), wn = warp / (WARPS / TL::WN);
  const int ntw = wn == 0 ? NT : NT8 - NT;   // this warp's n8 tiles
  const int colw = wn * NT * 8;              // its first column
  // this warp's fibers [wb0, wb0 + fw) of the block, in its own slots of
  // each stage; a warp whose 16 rows all lie past T or B only keeps the
  // ring going
  const int fw = warp_fibers(tlog), wb0 = (wm * 16) >> tlog;
  const int wslot = bt_rows + warp * fw;
  const bool idle =
      wb0 >= nbs || (tlog >= 4 && ((wm * 16) & (bt_rows - 1)) >= nts);
  // with siv, the block's fibers come in one bulk copy a stage, into
  // slots by fiber; else each warp copies its own into its own slots
  const bool fbulk = siv != nullptr;

  // warp 0, lane 0: stage lc of this slice into ring slot lc % RING as
  // 1-D bulk copies: (Ecos, Esin) of 8 frequencies x 136 velocities, the
  // block's templates' (T', T2) and, with siv, its fibers' (S, IV)
  auto fill = [&](int lc) {
    const int s = lc % RING, c = c_begin + lc;
    const uint32_t full = full0 + 8 * s;
    double2* et = reinterpret_cast<double2*>(stage(s));
    if (RVST_ABLATE >= 1) {
      mbar_arrive(full);
      return;
    }
    mbar_arrive_tx(full, E_BYTES + (nts + (fbulk ? nbs : 0)) * SLOT * 16);
    bulk_copy(et, e + ((size_t)cb * nchunks + c) * FREQ * E_STRIDE, E_BYTES,
              full);
    bulk_copy(et + FREQ * E_STRIDE, tt2 + ((size_t)c * nt + t0) * SLOT,
              nts * SLOT * 16, full);
    if (fbulk)
      bulk_copy(et + FREQ * E_STRIDE + bt_rows * SLOT,
                siv + ((size_t)c * nb + b0) * SLOT, nbs * SLOT * 16, full);
  };
  // every warp: its fibers' S and IV of stage lc into its own slots, as
  // 16-byte cp.async (zeros past F and B), one group a stage
  auto fill_fibers = [&](int lc) {
    double2* raw = reinterpret_cast<double2*>(stage(lc % RING))
                   + FREQ * E_STRIDE + wslot * SLOT;
    const int f0 = (c_begin + lc) * FREQ;
    for (int i = lane; RVST_ABLATE < 1 && !fbulk && i < fw * 2 * FREQ;
         i += 32) {
      const int k = i / (2 * FREQ), f = f0 + i % FREQ, b = b0 + wb0 + k;
      const bool ok = f < nf && b < nb;
      cp_async16(raw + k * SLOT + i % (2 * FREQ),
                 ((i / FREQ) & 1 ? ivfft : sfft)
                     + (ok ? (size_t)b * nf + f : 0),
                 ok);
    }
    cp_async_commit();
  };
  for (int lc = 0; lc < RING; ++lc) {
    if (lc < nloc && RVST_ABLATE < 3) {
      if (warp == 0 && lane == 0) fill(lc);
      fill_fibers(lc);
    } else {
      cp_async_commit();
    }
  }

  double acc[NACC][NT][4];
#pragma unroll
  for (int a = 0; a < NACC; ++a)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[a][j][x] = 0.0;
  // rows g and g + 8 of this warp's 16: their template and fiber slots
  int tsl[2], fsl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wm * 16 + g + 8 * h;
    tsl[h] = (r & (bt_rows - 1)) * SLOT;
    fsl[h] = (fbulk ? bt_rows + (r >> tlog) : wslot + (r >> tlog) - wb0)
             * SLOT;
  }

  for (int lc = 0; lc < nloc; ++lc) {
    const int s = lc % RING;
    if (RVST_ABLATE < 3) {
      cp_async_wait<RING - 1>();   // this lane's fibers of stage lc
      __syncwarp();                // and every lane's
      mbar_wait(full0 + 8 * s, (lc / RING) & 1);
    }
    const double2* et = reinterpret_cast<const double2*>(stage(s));
    const double2* raw = et + FREQ * E_STRIDE;
#pragma unroll
    for (int st = 0; st < 2 && !idle; ++st) {
      // k step st: k = q is Re X at frequency f, k = q + 4 is -Im X
      const int f = 4 * st + q;
      double af[NACC][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (RVST_ABLATE >= 2) {
#pragma unroll
          for (int a = 0; a < NACC; ++a) {
            af[a][h] = lc + h + a;
            af[a][2 + h] = lc - st;
          }
          continue;
        }
        const double2 tv = raw[tsl[h] + 2 * f], t2 = raw[tsl[h] + 2 * f + 1];
        const double2 sv = raw[fsl[h] + f], iv = raw[fsl[h] + FREQ + f];
        if (NACC == 1) {
          // R = (-2T) S + T2 IV
          af[0][h] = fma(-t2.y, iv.y, fma(t2.x, iv.x,
                     fma(-tv.y, sv.y, tv.x * sv.x)));
          af[0][2 + h] = fma(-t2.y, iv.x, fma(-t2.x, iv.y,
                         fma(-tv.y, sv.x, -tv.x * sv.y)));
        } else {
          af[0][h] = fma(-tv.y, sv.y, tv.x * sv.x);
          af[0][2 + h] = fma(-tv.y, sv.x, -tv.x * sv.y);
          af[NACC - 1][h] = fma(-t2.y, iv.y, t2.x * iv.x);
          af[NACC - 1][2 + h] = fma(-t2.y, iv.x, -t2.x * iv.y);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j >= ntw) break;
        // (Ecos, Esin) of frequency f at column j * 8 + g: B rows q and
        // q + 4
        const double2 ev = RVST_ABLATE >= 3
                               ? make_double2(lc + j, lc - j)
                               : et[f * E_STRIDE + colw + j * 8 + g];
        const double bf[2] = {ev.x, ev.y};
#pragma unroll
        for (int a = 0; a < NACC; ++a) mma_f64(acc[a][j], af[a], bf);
      }
    }
    __syncwarp();
    if (RVST_ABLATE < 3) {
      if (lc + RING < nloc) fill_fibers(lc + RING);
      else cp_async_commit();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
      // warp 0 refills the rest of the slot once every warp released it
      if (warp == 0 && lane == 0 && lc + RING < nloc) {
        mbar_wait(empty0 + 8 * s, (lc / RING) & 1);
        fill(lc + RING);
      }
    }
  }

  const size_t mv = (size_t)nb * nt * nv;
  if (nslices == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * 16 + g + 8 * h;
      const int t = t0 + (r & (bt_rows - 1)), b = b0 + (r >> tlog);
      if (t >= nt || b >= nb) continue;
      double* orow = out + ((size_t)b * nt + t) * nv;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int v = n0 + colw + j * 8 + 2 * q + x;
          if (j >= ntw || v >= nv) continue;
          const double c0 = acc[0][j][2 * h + x];
          if (NACC == 1) {
            orow[v] = c0;
          } else {
            const double c1 = acc[NACC - 1][j][2 * h + x];
            orow[v] = -(c0 * c0) / c1;
          }
        }
    }
    return;
  }

  // sliced: every warp is past its last read of the ring, and every
  // copy has landed (each was waited for)
  __syncthreads();
  double* stg = reinterpret_cast<double*>(smem + BAR_BYTES);
#pragma unroll
  for (int a = 0; a < NACC; ++a)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      double* srow = stg + (a * ROWS + wm * 16 + g + 8 * h) * STG_STRIDE;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (j < ntw)
          *reinterpret_cast<double2*>(srow + colw + j * 8 + 2 * q) =
              make_double2(acc[a][j][2 * h], acc[a][j][2 * h + 1]);
    }
  cluster_sync();
  // this CTA's share of the block's used rows and column pairs: the
  // cluster's sums, in rank order (all ranks' loads in flight at once)
  const uint32_t rank = cluster_rank();
  const int ncl = nslices / csize, cz = blockIdx.z / csize;
  const int ncols = min(COLS, nv - n0), npairs = (ncols + 1) / 2;
  const int nel = (((nbs - 1) << tlog) + nts) * npairs;
  const int per = (nel + csize - 1) / csize;
  const int i1 = min(nel, (int)(rank + 1) * per);
  for (int i = (int)rank * per + tid; i < i1; i += THREADS) {
    const int r = i / npairs, c = 2 * (i - r * npairs);
    const int t = t0 + (r & (bt_rows - 1)), b = b0 + (r >> tlog);
    if (t >= nt) continue;
    double2 sum[NACC];
#pragma unroll
    for (int a = 0; a < NACC; ++a) {
      const double* p = stg + (a * ROWS + r) * STG_STRIDE + c;
      double2 part[MAX_CLUSTER];
#pragma unroll
      for (int k = 0; k < MAX_CLUSTER; ++k)
        if (k < csize) part[k] = ld_cluster2(p, k);
      sum[a] = part[0];
#pragma unroll
      for (int k = 1; k < MAX_CLUSTER; ++k)
        if (k < csize) {
          sum[a].x += part[k].x;
          sum[a].y += part[k].y;
        }
    }
    const size_t o = ((size_t)b * nt + t) * nv + n0 + c;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      if (c + x >= ncols) break;
      const double c0 = x ? sum[0].y : sum[0].x;
      const double c1 = x ? sum[NACC - 1].y : sum[NACC - 1].x;
      if (ncl == 1) {
        out[o + x] = NACC == 1 ? c0 : -(c0 * c0) / c1;
      } else {
        ws[(size_t)cz * NACC * mv + o + x] = c0;
        if (NACC == 2) ws[((size_t)cz * NACC + 1) * mv + o + x] = c1;
      }
    }
  }
  // no CTA leaves while another may still read its shared memory
  cluster_sync();
}

// the clusters' sums, added in cluster order, through the epilogue
template <int NACC>
__global__ void ccf_chisq_f64_reduce(const double* __restrict__ ws,
                                     double* __restrict__ out, size_t mv,
                                     int nparts) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < mv;
       i += (size_t)gridDim.x * blockDim.x) {
    double c[NACC];
#pragma unroll
    for (int a = 0; a < NACC; ++a) {
      // 8 parts' loads in flight at a time, added in order
      for (int s0 = 0; s0 < nparts; s0 += 8) {
        double v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (s0 + k < nparts) v[k] = ws[((s0 + k) * NACC + a) * mv + i];
        c[a] = s0 == 0 ? v[0] : c[a] + v[0];
#pragma unroll
        for (int k = 1; k < 8; ++k)
          if (s0 + k < nparts) c[a] += v[k];
      }
    }
    out[i] = NACC == 1 ? c[0] : -(c[0] * c[0]) / c[NACC - 1];
  }
}

template <int NACC>
static int launch_f64(const double* tt2, const double* sfft,
                      const double* ivfft, const double* siv,
                      const double* e, double* out,
                      double* ws, int nb, int nt, int nf, int nv, int tlog,
                      int nslices, int csize, cudaStream_t stream) {
  using TL = f64::Tile<NACC>;
  if (tlog < 0 || (1 << tlog) > TL::ROWS || csize < 1
      || csize > f64::MAX_CLUSTER || nslices < csize || nslices % csize)
    return (int)cudaErrorInvalidValue;
  const int ncb = (nv + f64::COLS - 1) / f64::COLS;
  const int bt_rows = 1 << tlog, bb_rows = TL::ROWS >> tlog;
  const int ntt = (nt + bt_rows - 1) / bt_rows;
  const long long nbt = (nb + bb_rows - 1) / bb_rows;
  const long long tiles = (long long)ncb * ntt * nbt;
  const int ncl = nslices / csize;
  if (tiles > 0x7fffffffLL || nslices > (nf + f64::FREQ - 1) / f64::FREQ
      || nslices > 65535 || (ncl > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  auto kernel = ccf_chisq_f64_kernel<NACC>;
  const size_t smem = f64::smem_bytes(f64::raw_slots(tlog), nslices > 1);
  // the dynamic shared-memory limit set so far on each device: raised
  // when a launch needs more, not set again on every launch
  static size_t smem_set[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) smem_set[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)tiles, 1, (unsigned)nslices);
  cfg.blockDim = dim3(f64::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = (unsigned)csize;
  cfg.attrs = attr;
  cfg.numAttrs = nslices > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, (const double2*)tt2,
                           (const double2*)sfft, (const double2*)ivfft,
                           (const double2*)siv, (const double2*)e, out, ws,
                           nb, nt, nf, nv, tlog,
                           ncb, ntt, nslices, csize);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess || ncl == 1) return (int)err;
  const size_t mv = (size_t)nb * nt * nv;
  const unsigned blocks = (unsigned)((mv + 255) / 256 < 4096 ? (mv + 255) / 256
                                                             : 4096);
  ccf_chisq_f64_reduce<NACC><<<blocks, 256, 0, stream>>>(ws, out, mv, ncl);
  return (int)cudaGetLastError();
}

// tt2: (Fp / 8, T, 17) complex128 per 8 frequencies and template, (-2 T,
// T2) with continuum or (T, T2) without interleaved, then one zero; e:
// (ceil(V / 136), Fp, 138, 2) double of (Ecos, Esin) per column block;
// both zero past F (Fp = 8 ceil(F / 8)) and V; sfft, ivfft: (B, F)
// complex128, S and IV; siv (may be null): (Fp / 8, B, 17) complex128,
// per 8 frequencies and fiber S, then IV, then one zero, zero past F.
// Blocks of 2^tlog templates (the rest of 128 rows, 64 without
// continuum, in fibers); nslices slices of F in clusters of csize; ws:
// with nslices > csize a workspace of nslices / csize x (1 with
// continuum, else 2) x B T V doubles.
extern "C" int rvst_ccf_chisq_f64(const double* tt2, const double* sfft,
                                  const double* ivfft, const double* siv,
                                  const double* e, double* out, double* ws,
                                  int nb, int nt, int nf, int nv,
                                  int continuum, int tlog, int nslices,
                                  int csize, void* stream) {
  if (nb == 0 || nt == 0 || nv == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return continuum
             ? launch_f64<1>(tt2, sfft, ivfft, siv, e, out, ws, nb, nt, nf,
                             nv, tlog, nslices, csize, s)
             : launch_f64<2>(tt2, sfft, ivfft, siv, e, out, ws, nb, nt, nf,
                             nv, tlog, nslices, csize, s);
}
