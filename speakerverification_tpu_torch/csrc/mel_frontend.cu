// Mel frontend for Hopper (sm_90a): overlapped frame gather, windowed
// real DFT, power and mel projection in one kernel, both products on the
// TF32 tensor cores at fp32 accuracy.
//
// Replaces speakerverification_tpu/ops/pallas_frontend.py::_mel_kernel
// (driven by make_pallas_mel_frontend):
//     proj = frames @ [C | S];  power = re^2 + im^2;  mel = power @ M
// The TPU kernel took pre-gathered frames [rows, n_fft] from device
// memory. Here a block owns FR consecutive frame rows of the flattened
// [B * F] frame list and loads their overlapping span once (the window's
// samples only), one piece per utterance the rows touch, so frames never
// exist in device memory and no tile slot is empty except in the last
// block.
//
// What bounds it on an H100: operations. Per frame the DFT, folded as
// below, takes 2 * 2 * (win/2 + 1) * K FLOP over the window's rows (the
// basis is zero elsewhere) and the mel product 2 * K * n_mels, against
// (hop + n_mels) * 4 bytes of traffic: hundreds of FLOP per byte. fp32
// FMA outside the tensor cores peaks at 67 TFLOP/s; TF32 tensor cores at
// 495 (through wgmma; mma.sync reaches less). TF32 keeps 10 mantissa
// bits, too few for the fp32 tolerance, so every product is taken as
// three TF32 products ("3xTF32"): each operand is split into
// hi = tf32(x) and lo = tf32(x - hi), and hi*lo + lo*hi + hi*hi is summed
// in fp32. What the design does about it:
// - Half the DFT work, by symmetry. The window is centred on c = n_fft/2
//   and symmetric, so with u_d = x[c+d] + x[c-d] and v_d = x[c+d] - x[c-d]
//   (d >= 0; a side outside the window masked off),
//       re_k = (-1)^k sum_d u_d w_d cos(2 pi k d / n_fft)
//       im_k = (-1)^k sum_d v_d w_d sin(2 pi k d / n_fft)
//   and power_k = P_k^2 + Q_k^2 with P = u @ Cf, Q = v @ Sf over the
//   win/2 + 1 folded rows: two products of half the depth. The wrapper
//   folds the basis (Cf, Sf) and hands the kernel, per folded row d, the
//   span columns of x[c+d] and x[c-d] and their masks.
//   A window that is not symmetric about c (an odd win_length: its
//   centre is c - 1/2) takes the unfolded route of this same kernel: the
//   wrapper hands it row d = sample lo + d with masks 1 and 0 and the
//   plain basis (C, S), so u = v = x and P, Q are the DFT's re and im
//   over all win rows, twice the folded depth. The wrapper picks the
//   route by the window's shape (ops/mel_frontend.py: symmetric).
// - The DFT on wgmma m64n64k8 tf32: warpgroup 0 takes a column block's
//   P (A = u), warpgroup 1 its Q (A = v), for the block's 64 frame rows.
//   Each warp forms and splits its 16 rows of A in registers straight
//   from the span; B (the folded basis, split once by the wrapper) is
//   read by the tensor cores from shared memory. The three passes of a
//   k-step are issued asynchronously, and the next k-step's A is formed
//   while they run. P^2 goes to the power tile, then Q^2 is added after
//   a barrier.
// - Bins 0 .. K-2 go in column blocks of NB (zero-padded); the Nyquist
//   bin's P (its Q is zero) is a plain fp32 dot product that the P warps
//   sum beside the first column block's wgmma, so 256 bins plus Nyquist
//   cost 4 column blocks, not 5.
// - The mel product on mma.sync m16n8k8 tf32, the three passes issued
//   pass-major (the 2 x 4 products of a pass are independent), its B
//   operand stored by the wrapper in fragment order (one float4
//   {b0 hi, b1 hi, b0 lo, b1 lo} per lane). It takes the power tile as
//   its A operand and accumulates in registers across the column blocks.
// - The constants stream through shared memory in chunks with cp.async,
//   two stages: the next chunk lands while this one is multiplied (a
//   third stage was no faster, and would cost the second block per SM its
//   shared memory at 16 kHz). After a column block's basis chunks come
//   its mel-bank chunks, so the mel product's operands are in shared
//   memory when the power tile is, never fetched from L2 on the critical
//   path.
// - A row f of the A operand is read from the span at row offset
//   f * hop: a strided, overlapping view, read and split straight from
//   shared memory. Packed densely, the 8 rows of a fragment fall on
//   (g * hop + t) mod 32 banks: 4-way conflicts at hop 80, 8-way at 160.
//   The span is stored with SKEW = 4 empty slots after every hop
//   samples, so the row stride is hop + 4 (84 or 164 floats) and the 32
//   lanes hit 32 banks (packed densely it was 7 % and 25 % slower at
//   8 and 16 kHz on an H100). (Copying each chunk of frames into a padded, pre-split
//   tile instead was slower: the copy cost more than the conflicts.)
//
// Layouts: wave [B, Tp] (pre-emphasised, reflect-padded by n_fft/2);
// chunks [ncb][nkc + nmc][CHUNK] float4: per column block nkc basis
// chunks [KC / 8 k-steps][P, Q][hi, lo][TILE floats: a wgmma B operand,
// see smem_desc], then nmc
// mel-bank chunks [kpm k-steps][nmt n-tiles][32 lanes], zero-padded,
// kpm = CHUNK / (32 nmt), covering MEL_STEPS k-steps: the block's NB
// bins' rows, then 8 rows led by the Nyquist bin's in block 0;
// fold [Rf][5]: per folded row d, the span columns of x[c+d] and x[c-d]
// (skewed, relative to a row's first sample), their masks, and the
// Nyquist bin's folded basis value; out [B, F, n_mels]; fp32.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int FR = 64;         // frame rows per block
constexpr int NB = 64;         // DFT bins per column block
constexpr int KC = 16;         // folded rows per basis chunk (2 k-steps)
constexpr int THREADS = 256;   // 8 warps
constexpr int STAGES = 2;      // chunks in shared memory at once
constexpr int MEL_STEPS = NB / 8 + 1;  // + the Nyquist bin's k-step
constexpr int SP = NB + 12;    // power tile row stride: conflict-free
constexpr int MAX_MEL_TILES = 16;             // n_mels <= 128
constexpr int CHUNK = KC * 2 * NB * 2 / 4;    // float4 per chunk
constexpr int TILE = 8 * NB;   // floats of one wgmma B tile (8 k x NB n)
constexpr int SKEW = 4;        // empty span slots after every hop samples

// x ~ hi + lo, both TF32 rounded to nearest, ties away from zero (as
// cvt.rna.tf32.f32 rounds, without its NaN and infinity checks: the inputs
// are finite). hi is exact TF32; lo keeps 13 low bits that the mma
// ignores, which makes its rounding the same.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[m][n] += a[m] * b[n] for n < nb at fp32 accuracy, three TF32 passes:
// the two small cross terms first. Pass-major, so that the 2 * nb
// products of a pass are independent and fill the tensor pipe.
__device__ __forceinline__ void mma3(float (&d)[2][4][4],
                                     const uint32_t (&ahi)[2][4],
                                     const uint32_t (&alo)[2][4],
                                     const float4 (&b)[4], int nb) {
#pragma unroll
  for (int pass = 0; pass < 3; ++pass)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      if (n >= nb) break;
      const uint32_t b0 = __float_as_uint(pass == 0 ? b[n].z : b[n].x);
      const uint32_t b1 = __float_as_uint(pass == 0 ? b[n].w : b[n].y);
#pragma unroll
      for (int m = 0; m < 2; ++m)
        mma_tf32(d[m][n], pass == 1 ? alo[m] : ahi[m], b0, b1);
    }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float4* dst, const float4* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// shared-memory writes of this thread visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma B operand: TILE floats, 8 k x 64 n, as K-major core matrices of
// 8 n x 4 k (128 contiguous bytes), [n group][k half]: the k halves 128 B
// apart (leading byte offset), the n groups 256 B (stride byte offset);
// no swizzle
__device__ __forceinline__ uint64_t smem_desc(const float* p) {
  const uint64_t a = (uint32_t)__cvta_generic_to_shared(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// an A operand in flight is read by wgmma after its issue: keep the
// compiler from reusing its registers until the wait
__device__ __forceinline__ void keep(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 64 per warpgroup; this thread's rows g, g + 8 of its warp's 16,
// columns 8 j + 2 t, + 1) += a (64 x 8 from registers, the m16n8k8 A
// fragment of each warp) * B (smem) in TF32, accumulated in fp32
__device__ __forceinline__ void wgmma_tf32(float (&d)[8][4],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__global__ void __launch_bounds__(THREADS, 2)
mel_kernel(const float* __restrict__ wave, const float4* __restrict__ chunks,
           const float* __restrict__ fold, float* __restrict__ out, int Tp,
           int lo, int R, int Rf, int hop, int F, int total,
           int n_mels, int nmt, int ncb) {
  extern __shared__ __align__(16) float smem[];
  float4* s_cs = reinterpret_cast<float4*>(smem);            // [STAGES][CHUNK]
  float* s_pow = reinterpret_cast<float*>(s_cs + STAGES * CHUNK);  // [FR][SP]
  float4* s_fold = reinterpret_cast<float4*>(s_pow + FR * SP);     // [Rf]
  float* s_nyq = reinterpret_cast<float*>(s_fold + Rf);      // [Rf]
  int* s_off = reinterpret_cast<int*>(s_nyq + Rf);           // [FR]
  float* s_span = reinterpret_cast<float*>(s_off + FR);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;   // mma fragment coordinates
  // DFT: rows wr * 16 + [0, 16), the 8 n-tiles of one kind: 0 the P
  // columns (A = u), 1 the Q columns (A = v). Mel product: rows
  // wm * 32 + [0, 32), mel n-tiles wn + 4 i.
  const int wr = warp & 3, kind = warp >> 2;
  const float sign = kind ? -1.f : 1.f;
  const int wm = warp >> 2, wn = warp & 3;
  const int r0 = blockIdx.x * FR;
  const int nrows = min(FR, total - r0);
  // per column block: nkc basis chunks, then nmc mel-bank chunks of kpm
  // k-steps each
  const int kpm = CHUNK / (32 * nmt);
  const int nkc = (Rf + KC - 1) / KC, per = nkc + (MEL_STEPS + kpm - 1) / kpm;
  const int nc = ncb * per;
  const int nb_mel = (nmt - wn + 3) / 4;   // this warp's mel n-tiles

  for (int d = tid; d < Rf; d += THREADS) {   // the fold table
    const float* e = fold + 5 * d;
    s_fold[d] = make_float4(__int_as_float((int)e[0]),
                            __int_as_float((int)e[1]), e[2], e[3]);
    s_nyq[d] = e[4];
  }
  for (int i = tid; i < FR * (SP - NB); i += THREADS)   // the Nyquist k-step
    s_pow[i / (SP - NB) * SP + NB + i % (SP - NB)] = 0.f;
  // The rows' samples [f * hop + lo, f * hop + lo + R), one piece per
  // utterance, packed one after the other, with SKEW empty slots after
  // every hop samples (row f's sample i sits at s_off[f] + i + SKEW *
  // (i / hop)). Rows past the end read row 0 and are never written out.
  {
    int off = 0;
    for (int f = 0; f < nrows;) {
      const int r = r0 + f, b = r / F, fs = r - b * F;
      const int n = min(F - fs, nrows - f);
      const int len = (n - 1) * hop + R;
      const float* src = wave + (size_t)b * Tp + (size_t)fs * hop + lo;
      // sample i at off + i + SKEW * (i / hop), stepped without a division
      for (int i = tid, q = tid / hop, rem = tid % hop; i < len;
           i += THREADS) {
        cp_async4(s_span + off + i + SKEW * q, src + i);
        for (rem += THREADS; rem >= hop; rem -= hop) ++q;
      }
      for (int i = tid; i < n; i += THREADS) s_off[f + i] = off + i * (hop + SKEW);
      off += (len - 1) + SKEW * ((len - 1) / hop) + 1;
      f += n;
    }
    for (int f = nrows + tid; f < FR; f += THREADS) s_off[f] = 0;
  }

  auto issue = [&](int c) {   // chunk c into stage c % STAGES
    if (c < nc) {
      const float4* src = chunks + (size_t)c * CHUNK;
      float4* dst = s_cs + (c % STAGES) * CHUNK;
      for (int i = tid; i < CHUNK; i += THREADS) cp_async16(dst + i, src + i);
    }
    cp_async_commit();        // empty groups keep the count uniform
  };
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) issue(c);   // the span rides with 0
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  int off[2];   // the span offsets of this thread's A rows
#pragma unroll
  for (int h = 0; h < 2; ++h) off[h] = s_off[wr * 16 + g + 8 * h];

  float acc[8][4];       // [n-tile][frag]: P or Q (the wgmma accumulator)
  float macc[2][4][4];   // [m-tile][mel n-tile wn + 4 i][frag]
  float nacc[2] = {0.f, 0.f};   // P warps: the Nyquist bin's P, per t
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) macc[mi][j][q] = 0.f;

  for (int c = 0; c < nc; ++c) {
    cp_async_wait<STAGES - 2>();   // chunk c has landed
    fence_async_shared();          // ... visible to wgmma
    __syncthreads();               // ... for every thread; stage c-1 free
    issue(c + STAGES - 1);
    const float4* bs = s_cs + (c % STAGES) * CHUNK;
    const int k = c % per;
    if (k >= nkc) {
      // a mel chunk: k-steps [m * kpm, (m + 1) * kpm) of the product of
      // the power tile with this column block's rows of the mel bank
      const int m = k - nkc;
      for (int kl = 0; kl < kpm && m * kpm + kl < MEL_STEPS; ++kl) {
        const int ks = m * kpm + kl;
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            split(s_pow[(wm * 32 + mi * 16 + g + 8 * (q & 1)) * SP + ks * 8 +
                        t + 4 * (q >> 1)],
                  ahi[mi][q], alo[mi][q]);
        float4 b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (i < nb_mel) b[i] = bs[(kl * nmt + wn + 4 * i) * 32 + lane];
        mma3(macc, ahi, alo, b, nb_mel);
      }
      continue;
    }
    const bool nyquist = kind == 0 && c < per;   // block 0's P warps
    // per k-step: form and split A, then the warpgroup's 64 rows x 64
    // columns of its kind in three TF32 passes (the two small cross terms
    // first), asynchronously, so that the next k-step's A is formed while
    // the tensor cores work
    uint32_t ahi[KC / 8][4], alo[KC / 8][4];
    const int steps = min(KC / 8, (Rf - k * KC) / 8);
#pragma unroll
    for (int ks = 0; ks < KC / 8; ++ks) {
      if (ks >= steps) break;
      const int d0 = k * KC + ks * 8 + t;
      int cp[2], cm[2];
      float mp[2], mm[2], ny[2];   // a0 (g,t) a1 (g+8,t) a2 (g,t+4) a3
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 fe = s_fold[d0 + 4 * e];
        cp[e] = __float_as_int(fe.x);
        cm[e] = __float_as_int(fe.y);
        mp[e] = fe.z;
        mm[e] = sign * fe.w;
        ny[e] = nyquist ? s_nyq[d0 + 4 * e] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int h = q & 1, e = q >> 1;
        const float a = fmaf(mm[e], s_span[off[h] + cm[e]],
                             mp[e] * s_span[off[h] + cp[e]]);
        if (nyquist) nacc[h] = fmaf(a, ny[e], nacc[h]);
        split(a, ahi[ks][q], alo[ks][q]);
      }
      const float* bt = reinterpret_cast<const float*>(bs) +
                        (ks * 2 + kind) * 2 * TILE;   // B hi, then B lo
      wgmma_fence();
      wgmma_tf32(acc, ahi[ks], smem_desc(bt + TILE));
      wgmma_tf32(acc, alo[ks], smem_desc(bt));
      wgmma_tf32(acc, ahi[ks], smem_desc(bt));
      wgmma_commit();
    }
    wgmma_wait();   // before the registers of A and the stage are reused
#pragma unroll
    for (int ks = 0; ks < KC / 8; ++ks) {   // ... and not before
      keep(ahi[ks]);
      keep(alo[ks]);
    }
    if (k != nkc - 1) continue;

    // the column block's DFT is done: P^2, then Q^2 added, into the power
    // tile that the mel chunks after the next barrier read
    if (kind == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wr * 16 + g + 8 * h;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float* p = acc[j] + 2 * h;
          *reinterpret_cast<float2*>(s_pow + row * SP + j * 8 + 2 * t) =
              make_float2(p[0] * p[0], p[1] * p[1]);
        }
        // the Nyquist bin (zero past block 0): sum over the row's 4 lanes
        float v = nacc[h];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t == 0) s_pow[row * SP + NB] = v * v;
        nacc[h] = 0.f;
      }
    }
    __syncthreads();
    if (kind == 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wr * 16 + g + 8 * h;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float* q = acc[j] + 2 * h;
          float2* dst = reinterpret_cast<float2*>(s_pow + row * SP + j * 8 +
                                                  2 * t);
          const float2 p = *dst;
          *dst = make_float2(fmaf(q[0], q[0], p.x), fmaf(q[1], q[1], p.y));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
  }
  cp_async_wait<0>();   // the trailing empty groups

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wm * 32 + mi * 16 + g + 8 * h;
      if (row >= nrows) continue;
      float* dst = out + (size_t)(r0 + row) * n_mels;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = (wn + 4 * i) * 8 + 2 * t;
        if (m < n_mels) dst[m] = macc[mi][i][2 * h];
        if (m + 1 < n_mels) dst[m + 1] = macc[mi][i][2 * h + 1];
      }
    }
}

}  // namespace

extern "C" int mel_frontend_max_mels() { return 8 * MAX_MEL_TILES; }
extern "C" int mel_frontend_bins_per_block() { return NB; }
extern "C" int mel_frontend_chunk_floats() { return CHUNK * 4; }

// The kernel's attributes, set once per device: the most dynamic shared
// memory the device grants a block (each launch asks for its own size),
// and the largest carveout, which leaves room for two blocks per SM.
static int set_attributes() {
  static std::mutex mu;
  static bool done[64] = {};
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64) return (int)err;
  std::lock_guard<std::mutex> hold(mu);
  if (done[dev]) return 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mel_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  done[dev] = err == cudaSuccess;
  return (int)err;
}

// chunks and fold as the wrapper packs them (layouts above): Rf folded
// rows, or win rows on the unfolded route (a multiple of 8); each frame row's span is its samples
// [lo, lo + R); fold's span columns count SKEW empty slots after every
// hop samples. Returns the launch's cudaError_t (0 on success).
extern "C" int mel_frontend_launch(const float* wave, const float* chunks,
                                   const float* fold, float* out, int B,
                                   int Tp, int lo, int R, int Rf, int hop,
                                   int F, int n_mels, int ncb, void* stream) {
  const int total = B * F;
  const int nmt = (n_mels + 7) / 8;
  // a block's rows touch at most this many utterances; a piece of n rows
  // spans (n - 1) * hop + R samples, plus SKEW slots per hop
  const int pieces = min(FR, (FR - 1) / F + 2);
  const int tail = R + SKEW * ((R - 1) / hop) - hop - SKEW;
  const int span_cap = FR * (hop + SKEW) + pieces * max(tail + 1, 0);
  const size_t smem = (size_t)(STAGES * CHUNK * 4 + FR * SP + 5 * Rf + FR +
                               span_cap) * sizeof(float);
  const int err = set_attributes();
  if (err != 0) return err;
  mel_kernel<<<(total + FR - 1) / FR, THREADS, smem, (cudaStream_t)stream>>>(
      wave, reinterpret_cast<const float4*>(chunks), fold, out, Tp, lo, R, Rf,
      hop, F, total, n_mels, nmt, ncb);
  return (int)cudaGetLastError();
}
