// Res2Net cascade for Hopper (sm_90a), eval mode, in one kernel, its
// products on the tensor cores.
//
// Replaces speakerverification_tpu/ops/pallas_res2net.py::_cascade_kernel
// (driven by fused_res2net_cascade). For an input x [B, s*H, T]:
// group 0 passes through; for i = 1..s-1
//     inp = chunk_i (+ y_{i-1}, rounded to x's type as the JAX add is)
//     h   = sum_k shift(inp, (k-1)*d) @ W_k      (3 taps, REFLECT halo)
//     y_i = relu(h + bias) * bn_scale + bn_shift (eval BN folded by caller)
// with fp32 accumulation, stored in x's type (fp32 or bf16).
//
// What bounds it on an H100: operations. ECAPA-TDNN's block at B=80,
// T=201, H=128 does 11.1 GFLOP against 132 MB of input and output. fp32
// input keeps fp32 accuracy with three TF32 tensor-core products per
// product ("3xTF32": each operand split into hi = tf32(v) and
// lo = tf32(v - hi), hi*lo + lo*hi + hi*hi summed in fp32), 33 GFLOP at
// 495 TFLOP/s; bf16 input takes one bf16 product with fp32 sums, as the
// JAX kernel's bf16 dot with an fp32 result does. What the design does:
// - Time tiles across blocks. The groups depend on one another and each
//   tap reaches d rows, so a block that owns the output rows [o0, o1) of
//   one batch row computes group i over the window
//   W_i = [o0 - (s-1-i) d, o1 + (s-1-i) d), cut to the utterance: the
//   window shrinks by d per side per group, only the utterance's own
//   edges reflect, and blocks exchange nothing. The wrapper splits T
//   evenly into tiles (ops/res2net_cascade.py, tile_schedule) and hands
//   the kernel each block's batch row and windows W_0 .. W_{s-1}
//   (W_0, the span of x the block loads; W_{s-1} = [o0, o1)). A group's
//   window is at most MAX_COLS rows.
// - Activations stay in shared memory. One buffer holds the current
//   group's input over its window, channels x time, row stride R = 8
//   (mod 32) words, so the 8 rows x 4 channels of a B fragment fall on
//   32 banks (bf16: channel pairs interleaved, one 32-bit word per pair
//   and time). The product of group i is [H out] x [3H in] x [columns of
//   W_i]: the weights are the A operand, the buffer's columns at offset
//   (k-1) d the B operand, read straight from the buffer (no im2col).
//   mma.sync m16n8k8 tf32 (three passes, the two small cross terms
//   first) or m16n8k16 bf16.
// - 16 warps: a warp owns 32 output channels and every WN-th 8-column
//   tile, so the tiles of a shrinking window stay spread over the warps
//   and tiles past it are skipped.
// - Accuracy: the tensor cores sum in fp32 with truncation, so a long
//   chain of mma on one accumulator drifts toward zero. Each weight
//   chunk's products go to a fresh partial sum, added to the accumulator
//   rounded to nearest.
// - The epilogue (bias, ReLU, the BN affine) runs in registers. y goes
//   to out for the owned rows only and, rounded to x's type, is added to
//   the next chunk of x into the buffer as the next group's input. That
//   chunk is sent to L2 with prefetch before the group's product and
//   loaded, at the thread's fragment positions, before the barrier that
//   ends the product. Nothing is read back from out. (Staging y in the
//   buffer to store and load along time, coalesced, was slower: two more
//   barriers and the loads' latency in the open.)
// - The weights, packed once by the wrapper in A-fragment order (fp32:
//   tf32 hi and lo planes), stream through a two-stage cp.async ring in
//   chunks of 64 input channels, one stream across all groups, so the
//   next group's first chunk lands during this group's epilogue. (16- and
//   32-channel chunks were slower at H 128 fp32: a barrier per chunk and
//   shorter unrolled k-loops; in bf16 a ring of 4 to 8 stages changed
//   nothing.)
// - One block of 16 warps per SM (at most 128 registers a thread; up to
//   201 KB of shared memory at H 128 fp32, d 4). A warp tile of 32 x 32
//   keeps the A and B loads from shared memory near one wavefront per
//   mma; blocks of 8 warps with 32 x 64 tiles were slower in fp32.
// - The price is the halo's recompute: group i computes |W_i| rows, not
//   o1 - o0 (1.12x at d 2, 1.24x at d 4 for T 201 in 3 tiles).
//
// Layouts: x, out [B, C=s*H, T] contiguous (channels first); w as
// packed by the wrapper: [s-1][3 taps][H / KC][chunk_words]; table
// [blocks][1 + 2 s] int: batch row, then lo, hi of W_0 .. W_{s-1};
// bias/scale/shift [s-1, H] fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace {

constexpr int THREADS = 512;     // 16 warps
constexpr int WARPS = THREADS / 32;
constexpr int MAX_COLS = 128;    // widest group window: 16 tiles of 8
constexpr int STAGES = 2;        // weight chunks in shared memory at once

// Per element type: input channels per weight chunk and per mma k-step
// (a chunk of 64 channels is 64 KB at H 128 in fp32, hi and lo, and
// 16 KB in bf16).
template <typename scalar_t>
struct Traits;
template <>
struct Traits<float> {
  static constexpr int KC = 64, KSTEP = 8;
};
template <>
struct Traits<__nv_bfloat16> {
  static constexpr int KC = 64, KSTEP = 16;
};

// words of one weight chunk: KC input channels x H outputs, fp32 as tf32
// hi and lo, bf16 two to a word
template <typename scalar_t, int H>
__host__ __device__ constexpr int chunk_words() {
  return std::is_same<scalar_t, float>::value ? 2 * Traits<scalar_t>::KC * H
                                              : Traits<scalar_t>::KC * H / 2;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// channel c, buffer column col of the group's input
__device__ __forceinline__ void put(uint32_t* buf, int R, int c, int col,
                                    float v) {
  reinterpret_cast<float*>(buf)[c * R + col] = v;
}
__device__ __forceinline__ void put(uint32_t* buf, int R, int c, int col,
                                    __nv_bfloat16 v) {
  reinterpret_cast<__nv_bfloat16*>(buf)[((c >> 1) * R + col) * 2 + (c & 1)] =
      v;
}
// x ~ hi + lo, both TF32 rounded to nearest, ties away from zero (the
// split of csrc/mel_frontend.cu; the inputs are finite)
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

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(uint4* dst, const uint4* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename scalar_t, int H>
__global__ void __launch_bounds__(THREADS, 1)
cascade_kernel(const scalar_t* __restrict__ x, const uint4* __restrict__ w,
               const int* __restrict__ table,
               const float* __restrict__ cbias,
               const float* __restrict__ bn_scale,
               const float* __restrict__ bn_shift,
               scalar_t* __restrict__ out, int T, int groups, int d, int R) {
  constexpr bool F32 = std::is_same<scalar_t, float>::value;
  constexpr int MT = H / 16;                  // m-tiles of 16 channels
  constexpr int WM = H / 32;                  // warps along the channels
  constexpr int WN = WARPS / WM;              // ... and the column tiles
  constexpr int NTW = MAX_COLS / 8 / WN;      // column tiles per warp
  constexpr int KC = Traits<scalar_t>::KC;
  constexpr int CHUNK = chunk_words<scalar_t, H>();
  constexpr int KS = KC / Traits<scalar_t>::KSTEP;
  constexpr int CPT = H / KC;                 // chunks per tap
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* ring = smem;                      // [STAGES][CHUNK]
  uint32_t* buf = smem + STAGES * CHUNK;      // the group's input

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;     // mma fragment coordinates
  const int wm = warp % WM, wn = warp / WM;
  const int* win = table + (size_t)blockIdx.x * (1 + 2 * groups);
  const int C = groups * H;
  const scalar_t* xb = x + (size_t)win[0] * C * T;
  scalar_t* ob = out + (size_t)win[0] * C * T;
  const int S = win[1];                       // buffer column 0
  const int o0 = win[2 * groups - 1], o1 = win[2 * groups];
  const int nchunks = (groups - 1) * 3 * CPT;

  auto issue = [&](int c) {   // weight chunk c into stage c % STAGES
    if (c < nchunks) {
      const uint4* src = w + (size_t)c * (CHUNK / 4);
      uint4* dst = reinterpret_cast<uint4*>(ring + (c % STAGES) * CHUNK);
      for (int i = tid; i < CHUNK / 4; i += THREADS) cp_async16(dst + i, src + i);
    }
    cp_async_commit();        // empty groups keep the count uniform
  };
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) issue(c);

  {  // group 1's input, chunk 1 over W_0; group 0 passes through. Each
     // thread keeps U loads in flight before it stores.
    constexpr int U = 8;
    const int m = win[2] - S, n = o1 - o0;
    const scalar_t* src = xb + (size_t)H * T + S;
    for (int e0 = tid; e0 < H * m; e0 += U * THREADS) {
      scalar_t v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * THREADS, c = e / m;
        if (e < H * m) v[u] = src[(size_t)c * T + e - c * m];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * THREADS, c = e / m;
        if (e < H * m) put(buf, R, c, e - c * m, v[u]);
      }
    }
    for (int e0 = tid; e0 < H * n; e0 += U * THREADS) {
      scalar_t v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * THREADS, c = e / n;
        if (e < H * n) v[u] = xb[(size_t)c * T + o0 + e - c * n];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * THREADS, c = e / n;
        if (e < H * n) ob[(size_t)c * T + o0 + e - c * n] = v[u];
      }
    }
  }

  int gc = 0;   // weight chunks consumed
  for (int i = 1; i < groups; ++i) {
    const int lo = win[1 + 2 * i], ncols = win[2 + 2 * i] - lo;
    const int nt = (ncols + 7) >> 3;
    float acc[2][NTW][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int q = 0; q < NTW; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][q][e] = 0.f;
    const scalar_t* xnext = xb + (size_t)(i + 1) * H * T + lo;
    if (i + 1 < groups) {
      // chunk i+1 of x over this window, which the epilogue adds, into
      // L2 while the product runs: one address per 128-byte line of each
      // channel's row, and the row's last element
      constexpr int LINE = 128 / sizeof(scalar_t);
      const int per = (ncols + LINE - 1) / LINE + 1;
      for (int e = tid; e < H * per; e += THREADS) {
        const int c = e / per, j = e - c * per;
        prefetch_l2(xnext + (size_t)c * T + min(j * LINE, ncols - 1));
      }
    }

    for (int k = 0; k < 3; ++k) {
      // buffer column of this thread's B rows at tap k: the reflected
      // time (columns past the window repeat its last one)
      int col[NTW];
#pragma unroll
      for (int q = 0; q < NTW; ++q) {
        int t = lo + min((wn + WN * q) * 8 + g, ncols - 1) + (k - 1) * d;
        t = t < 0 ? -t : (t >= T ? 2 * (T - 1) - t : t);
        col[q] = t - S;
      }
      for (int cc = 0; cc < CPT; ++cc, ++gc) {
        cp_async_wait<STAGES - 2>();   // chunk gc has landed
        __syncthreads();               // ... for every thread; stage gc-1 free
        issue(gc + STAGES - 1);
        const uint4* ch = reinterpret_cast<const uint4*>(ring) +
                          (gc % STAGES) * (CHUNK / 4);
        // the chunk's products summed apart, then added to acc rounded to
        // nearest: the tensor cores' fp32 sums truncate, and a chain of
        // 3H / KSTEP of them (x 3 passes in fp32) drifts toward zero
        float part[2][NTW][4];
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int q = 0; q < NTW; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[m][q][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          if constexpr (F32) {
            // A: per (k-step, m-tile) 32 lanes of {a0..a3} hi, then lo
            uint32_t ah[2][4], al[2][4];
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              const uint4* p = ch + (ks * MT + wm * 2 + m) * 64 + lane;
              const uint4 h = p[0], l = p[32];
              ah[m][0] = h.x; ah[m][1] = h.y; ah[m][2] = h.z; ah[m][3] = h.w;
              al[m][0] = l.x; al[m][1] = l.y; al[m][2] = l.z; al[m][3] = l.w;
            }
            const float* bf = reinterpret_cast<const float*>(buf) +
                              (cc * KC + ks * 8 + t4) * R;
            uint32_t bh[NTW][2], bl[NTW][2];
#pragma unroll
            for (int q = 0; q < NTW; ++q) {
              if (wn + WN * q >= nt) break;
              split(bf[col[q]], bh[q][0], bl[q][0]);
              split(bf[4 * R + col[q]], bh[q][1], bl[q][1]);
            }
#pragma unroll
            for (int pass = 0; pass < 3; ++pass)
#pragma unroll
              for (int q = 0; q < NTW; ++q) {
                if (wn + WN * q >= nt) break;
                const uint32_t b0 = pass == 0 ? bl[q][0] : bh[q][0];
                const uint32_t b1 = pass == 0 ? bl[q][1] : bh[q][1];
#pragma unroll
                for (int m = 0; m < 2; ++m)
                  mma_tf32(part[m][q], pass == 1 ? al[m] : ah[m], b0, b1);
              }
          } else {
            uint32_t a[2][4];
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              const uint4 v = ch[(ks * MT + wm * 2 + m) * 32 + lane];
              a[m][0] = v.x; a[m][1] = v.y; a[m][2] = v.z; a[m][3] = v.w;
            }
            const uint32_t* bw = buf + ((cc * KC + ks * 16) / 2 + t4) * R;
#pragma unroll
            for (int q = 0; q < NTW; ++q) {
              if (wn + WN * q >= nt) break;
              const uint32_t b0 = bw[col[q]], b1 = bw[4 * R + col[q]];
#pragma unroll
              for (int m = 0; m < 2; ++m) mma_bf16(part[m][q], a[m], b0, b1);
            }
          }
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int q = 0; q < NTW; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[m][q][e] = __fadd_rn(acc[m][q][e], part[m][q][e]);
      }
    }

    // the next chunk of x at this thread's outputs, every load in flight
    float xv[2][NTW][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int q = 0; q < NTW; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = (wm * 2 + m) * 16 + g + 8 * (e >> 1);
          const int n = (wn + WN * q) * 8 + 2 * t4 + (e & 1);
          xv[m][q][e] = i + 1 < groups && n < ncols
                            ? to_f(xnext[(size_t)o * T + n]) : 0.f;
        }
    __syncthreads();   // every warp has read this group's input
    const float* cb = cbias + (i - 1) * H;
    const float* sc = bn_scale + (i - 1) * H;
    const float* sh = bn_shift + (i - 1) * H;
    scalar_t* oc = ob + (size_t)i * H * T;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = (wm * 2 + m) * 16 + g + 8 * h;
        const float bias = __ldg(cb + o), s = __ldg(sc + o),
                    shift = __ldg(sh + o);
#pragma unroll
        for (int q = 0; q < NTW; ++q) {
          if (wn + WN * q >= nt) break;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = (wn + WN * q) * 8 + 2 * t4 + e;
            if (n >= ncols) continue;
            // rounded as the plain version rounds: no fused multiply-add
            const float v = fmaxf(acc[m][q][2 * h + e] + bias, 0.f);
            const scalar_t y =
                from_f<scalar_t>(__fadd_rn(__fmul_rn(v, s), shift));
            const int t = lo + n;
            if (t >= o0 && t < o1) oc[(size_t)o * T + t] = y;
            if (i + 1 < groups)
              put(buf, R, o, t - S,
                  from_f<scalar_t>(xv[m][q][2 * h + e] + to_f(y)));
          }
        }
      }
    // the next group's first chunk waits at a barrier before any read
  }
  cp_async_wait<0>();   // the trailing empty groups
}

template <typename scalar_t, int H>
size_t smem_bytes(int R) {
  return (size_t)STAGES * chunk_words<scalar_t, H>() * 4 +
         (size_t)H * R * (std::is_same<scalar_t, float>::value ? 4 : 2);
}

// The kernel's attributes, set once per device: the most dynamic shared
// memory the device grants a block (each launch asks for its own size).
template <typename scalar_t, int H>
int set_attributes() {
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
    err = cudaFuncSetAttribute(cascade_kernel<scalar_t, H>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  done[dev] = err == cudaSuccess;
  return (int)err;
}

template <typename scalar_t, int H>
int launch(const void* x, const void* w, const int* table, const float* cb,
           const float* s, const float* t, void* out, int blocks, int T,
           int groups, int d, int R, cudaStream_t stream) {
  const int err = set_attributes<scalar_t, H>();
  if (err != 0) return err;
  cascade_kernel<scalar_t, H>
      <<<blocks, THREADS, smem_bytes<scalar_t, H>(R), stream>>>(
          static_cast<const scalar_t*>(x), static_cast<const uint4*>(w),
          table, cb, s, t, static_cast<scalar_t*>(out), T, groups, d, R);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int res2net_cascade_max_cols() { return MAX_COLS; }

// w and table as the wrapper packs them (layouts above); R, the buffer's
// row stride in words, at least every block's |W_0|. Returns the
// launch's cudaError_t (0 on success); -1 for an H or type the library
// was not built for.
extern "C" int res2net_cascade_launch(const void* x, const void* w,
                                      const int* table, const float* cb,
                                      const float* s, const float* t,
                                      void* out, int blocks, int T, int H,
                                      int groups, int d, int R, int is_bf16,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    if (H == 64)
      return launch<__nv_bfloat16, 64>(x, w, table, cb, s, t, out, blocks, T,
                                       groups, d, R, st);
    if (H == 128)
      return launch<__nv_bfloat16, 128>(x, w, table, cb, s, t, out, blocks,
                                        T, groups, d, R, st);
  } else {
    if (H == 64)
      return launch<float, 64>(x, w, table, cb, s, t, out, blocks, T, groups,
                               d, R, st);
    if (H == 128)
      return launch<float, 128>(x, w, table, cb, s, t, out, blocks, T, groups,
                                d, R, st);
  }
  return -1;
}
