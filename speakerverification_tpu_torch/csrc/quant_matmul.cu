// Static-scale int8 GEMM for Hopper (sm_90a): the activation quantize,
// the int8 tensor-core product and the dequantize epilogue in one kernel.
//
// Replaces speakerverification_tpu/ops/pallas_quant.py::_qmm_kernel
// (driven by quant_matmul). Per output element
//
//   xq  = clip(rint(x * inv_sx), -127, 127)        int8
//   acc = sum_k xq[k] * wq[n, k]                   int32, exact
//   out = f32(acc) * scale[n] + bias[n]            stored in x's dtype
//
// with wq [N, K] int8 and scale = s_w * s_x made outside the kernel. The
// multiply and the add are written with __fmul_rn/__fadd_rn so that nvcc
// cannot contract them into an FMA, and the quantize rounds half to even
// like jnp.round (clipping before the rounding is the same, since +-127
// are integers): the kernel matches its plain PyTorch version bit for bit.
//
// Two kernels, one per layout.
//
// qmm_conv_kernel, channels-first (a 1x1 conv or an im2col'd conv, the
// port's activations, 17 of path C's 22 launches): x [nb, K, T] with the
// time axis contiguous, out [nb, N, T]. A block computes out for CM = 256
// output channels x CN = 128 time steps of one batch row on int8 wgmma
// (m64n128k32, s8 x s8 -> s32), two consumer warpgroups of 128 channels.
// wgmma takes int8 operands K-major only: A = the wq tile, K-major as
// stored, packed once per weights tensor by the wrapper into the
// shared-memory tile order (core matrices of 8 rows x 16 bytes), so one
// bulk copy moves a step's tile; B = the x tile, quantized from shared
// memory into the same K-major layout (the transpose happens there, so
// no transposed copy of the activation exists in device memory).
//
// What bounds it on an H100: bytes. A 4-byte input and a 4-byte output
// per element against K = 1024 int8 multiply-adds is about 256 int8
// operations per byte, under the card's ridge of about 590 (1,979 TOPS
// over 3.35 TB/s); bf16 input halves the bytes (about 512 per byte,
// near the ridge). What the design does about it:
// - Copies: a step's wq tile is one bulk copy (the copy engine,
//   cp.async.bulk); its x rows are 16-byte cp.async chunks, a warp per
//   row, a lane per chunk, whose landing each thread signals on the
//   stage's mbarrier (cp.async.mbarrier.arrive). The rows of x have an
//   odd length T, so a row's piece of the tile starts at any element: the
//   block copies the 16-byte chunks that cover it, and the quantize reads
//   each row shifted by its head ((p & 15) / sizeof(T)). A chunk that
//   straddles x's first or last byte is loaded element by element, so
//   the kernel never reads outside x and takes a view at any element
//   offset. (TMA's tensor copies need global strides that are multiples
//   of 16 bytes: they cannot describe x.)
// - A block covers 256 output channels, and where K <= 1024 and the grid
//   stays at three or more blocks per SM, 2 or 4 such tiles (the wrapper
//   picks): it keeps every step's quantized x tile (K x 128 bytes) in
//   shared memory and, after the first tile, streams only wq. So x is
//   read from L2 and quantized once per block, not once per 256 output
//   channels; a step of a later tile is one 16 KB copy and the products.
//   Measured per step (the trace): copies issued by the threads
//   that quantize cost about as much as the quantize, so sharing both
//   over the tiles is the lever. (Producer warps that only copy were
//   slower: two warps could not keep enough copies in flight.)
// - A ring of stages (4 in fp32, 6 in bf16; 2 in a block that keeps its
//   quantized x): the copies of the next steps are in flight, step k+1
//   is quantized into its xq buffer, and the tensor cores run step k, all
//   at once (wgmma is asynchronous; the quantize runs between its issue
//   and its wait). One barrier per step.
// - The quantize is six full-rate instructions an element: multiply,
//   clip, and a round to nearest even by adding 1.5 * 2^23, whose low
//   byte is then the int8; byte permutes pack four into a word.
// - The int32 sums of the 256 x 128 tile sit in registers (128 per
//   thread). The epilogue stages one warpgroup's 128 rows at a time in
//   the x regions, each row shifted by its own head offset, and writes
//   them along time: 16-byte stores where the row is aligned, element
//   stores at the head and tail of each row. (Staging the whole tile at
//   once where the x regions hold it measured the same.)
// - An optional trace records thread 0's cycles per block by phase
//   (quant_matmul_trace in the wrapper).
//
// qmm_dense_kernel, row-major (a Dense layer, 5 launches of M = 160 per
// path C forward, and the SE blocks' [B, K, 1] convs, whose one time
// step makes them Dense rows): x [M, K], out [M, N]. An mma.sync
// m16n8k32 kernel: its rows are K-contiguous already and its launches
// are small.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// clip(rint(v * inv_sx), -127, 127) in the low byte: clipped to +-127
// (exact integers, so clipping first is the same), then rounded to
// nearest even by adding 1.5 * 2^23, which leaves q in the low mantissa
// bits as 2^22 + q: its low byte is q's int8
__device__ __forceinline__ uint32_t quantize1(float v, float inv_sx) {
  const float c = fminf(fmaxf(__fmul_rn(v, inv_sx), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(c, 12582912.f));
}

// the low bytes of four quantize1 words, packed
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

__device__ __forceinline__ uint32_t quantize4(const float* v, float inv_sx) {
  return pack4(quantize1(v[0], inv_sx), quantize1(v[1], inv_sx),
               quantize1(v[2], inv_sx), quantize1(v[3], inv_sx));
}

__device__ __forceinline__ float epilogue(int acc, float sc, float bi) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), sc), bi);
}

// ---------------------------------------------------------------------
// channels-first: int8 wgmma
// ---------------------------------------------------------------------
constexpr int CM = 256;        // output channels per block and tile
constexpr int CN = 128;        // time steps per block (the wgmma N)
constexpr int CK = 64;         // reduction depth per step
constexpr int CTHREADS = 256;  // two warpgroups
constexpr int CORE_SBO = CK / 16 * 128;   // bytes between 8-row groups
constexpr int RES_STEPS = 16;  // steps (K <= 1024) of quantized x a block
                               // keeps across output-channel tiles
constexpr int TRACE_FIELDS = 7;           // int64 per block in a trace

// Shared memory: STAGES x regions (one step's CK float rows of x, each
// the 16-byte chunks that cover CN elements from any element: CN + V - 1
// elements, V = 16 / sizeof(T), rounded up to whole chunks), STAGES wq
// tiles, the quantized x tiles, the stages' mbarriers. A block that
// covers several output-channel tiles (RES) keeps every step's quantized
// x and has room for 2 stages; one that covers one tile keeps two
// quantized tiles and as many stages as fit. The epilogue stages one
// warpgroup's 128 rows in the x regions.
template <typename T, bool RES>
struct Geom {
  static constexpr int V = 16 / sizeof(T);        // elements per chunk
  static constexpr int PITCH = CN + V;            // elements per row
  static constexpr int X_BYTES = CK * PITCH * sizeof(T);
  static constexpr int W_BYTES = CM * CK;
  static constexpr int XQ_BYTES = CN * CK;
  static constexpr int STAGES = RES ? 2 : sizeof(T) == 4 ? 4 : 6;
  static constexpr int XQ_BUFS = RES ? RES_STEPS : 2;
  static constexpr int W_OFF = STAGES * X_BYTES;
  static constexpr int XQ_OFF = W_OFF + STAGES * W_BYTES;
  static constexpr int BAR_OFF = XQ_OFF + XQ_BUFS * XQ_BYTES;
  static constexpr int SMEM = BAR_OFF + STAGES * 8;
  static_assert(SMEM <= 232448, "shared memory");
  static_assert(128 * PITCH * sizeof(T) <= STAGES * X_BYTES, "staging");
};

// byte offset of (row, 16-byte k chunk kc) in a K-major tile of CK bytes
// per row stored as core matrices of 8 rows x 16 bytes: [row / 8][kc]
// [row % 8][16 bytes]
__device__ __forceinline__ int core_offset(int row, int kc) {
  return (row >> 3) * CORE_SBO + kc * 128 + (row & 7) * 16;
}

// wgmma operand in that layout: the next 16 bytes of K one core matrix
// on (leading byte offset 128), the next 8 rows CORE_SBO on (stride byte
// offset); no swizzle
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t a = (uint32_t)__cvta_generic_to_shared(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(CORE_SBO >> 4) << 32);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// one arrival that also expects `bytes` more from the copies
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// one arrival on `bar` once this thread's cp.async copies so far landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory into shared memory by the copy engine, counted on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// shared-memory writes of this thread visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// sums in flight are written by wgmma after its issue: keep the compiler
// from touching their registers until the wait
__device__ __forceinline__ void keep(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 128 per warpgroup: this thread's rows 16 w + g, + 8 of its
// warp w, columns 8 j + 2 t, + 1 in d[4 j .. 4 j + 3]) += A (64 x 32,
// smem) * B (32 x 128, smem), int8, exact int32 sums
#define D8(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), \
    "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "l"(da), "l"(db), "r"(1));
}
#undef D8

// x [nb, K, T], out [nb, N, T]; wp: wq packed by the wrapper as
// [N / CM][K / CK][CM * CK] K-major core-matrix tiles (rounded up, zero
// past N and K); x_elems = nb * K * T, the extent of x that may be read.
// Grid: (N / CM / tiles, T / CN, nb), rounded up; block (i, j, b) covers
// output-channel tiles i * tiles .. i * tiles + tiles - 1 (tiles > 1 only
// with RES, K <= RES_STEPS * CK) of time tile j of batch row b.
template <typename T, bool RES>
__global__ void __launch_bounds__(CTHREADS, 1)
qmm_conv_kernel(const T* __restrict__ x, const int8_t* __restrict__ wp,
                const float* __restrict__ scale,
                const float* __restrict__ bias, T* __restrict__ out, int K,
                int N, int ncols_all, int tiles, size_t x_elems, float inv_sx,
                long long* __restrict__ trace) {
  using G = Geom<T, RES>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* xs = smem;                         // [STAGES][X_BYTES]
  uint8_t* ws = smem + G::W_OFF;              // [STAGES][W_BYTES]
  uint8_t* xq = smem + G::XQ_OFF;             // [XQ_BUFS][XQ_BYTES]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::BAR_OFF);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;               // this warpgroup's rows: 128 wg..
  const int tile0 = blockIdx.x * tiles;
  const int t0 = blockIdx.y * CN;
  const int ncols = min(CN, ncols_all - t0);
  const size_t xrow0 = (size_t)blockIdx.z * K;   // x's row of (b, k = 0)
  const size_t orow0 = (size_t)blockIdx.z * N;
  const uintptr_t xbeg = (uintptr_t)x;
  const uintptr_t xend = (uintptr_t)(x + x_elems);
  const int nk = (K + CK - 1) / CK;
  const int steps = tiles * nk;   // step g: tile g / nk, depth g % nk
  // optional timeline of thread 0 (see TRACE_FIELDS), clock64 cycles
  const bool tracing = trace != nullptr && tid == 0;
  long long tr[TRACE_FIELDS] = {0, 0, 0, 0, 0, 0, 0}, tw = 0, t_prev = 0;
  if (tracing) t_prev = clock64();
  auto lap = [&](int field) {   // cycles since the last lap, to a field
    if (tracing) {
      tw = clock64();
      tr[field] += tw - t_prev;
      t_prev = tw;
    }
  };

  // a stage is full when every thread's copies and the wq tile's bytes
  // have landed and each warp's element stores are done
  if (tid == 0)
    for (int s = 0; s < G::STAGES; ++s)
      mbar_init(full + s, CTHREADS + CTHREADS / 32 + 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  // step g's wq tile and, on the first tile, its x rows into stage
  // g % STAGES. Thread 0 bulk-copies the wq tile. Warp w copies x rows
  // w, w + 8, ..., lane l the row's 16-byte chunk l (and l + 32): the
  // chunks inside x by cp.async, the (at most two) that straddle x's
  // first or last byte element by element. Each thread's copies arrive
  // on the stage's mbarrier when they land, each warp once its element
  // stores are done.
  auto issue = [&](int g) {
    if (g >= steps) return;
    const int jt = g / nk, kt = g - jt * nk, s = g % G::STAGES;
    uint64_t* bar = full + s;
    if (tid == 0) {
      bulk_copy(ws + s * G::W_BYTES,
                wp + ((size_t)(tile0 + jt) * nk + kt) * G::W_BYTES,
                G::W_BYTES, bar);
      mbar_arrive_tx(bar, G::W_BYTES);
    }
    if (jt == 0) {
      const int k0 = kt * CK;
      const T* seg = x + (xrow0 + k0 + warp) * ncols_all + t0;
#pragma unroll 1
      for (int r = warp; r < CK && k0 + r < K; r += CTHREADS / 32) {
        const uintptr_t a0 = (uintptr_t)seg & ~(uintptr_t)15;
        const uintptr_t a1 = ((uintptr_t)(seg + ncols) + 15) & ~(uintptr_t)15;
        uint8_t* row = xs + s * G::X_BYTES + r * G::PITCH * sizeof(T);
        for (uintptr_t a = a0 + 16 * lane; a < a1; a += 16 * 32) {
          uint8_t* d = row + (a - a0);
          if (a >= xbeg && a + 16 <= xend) {
            cp_async16(d, reinterpret_cast<const void*>(a));
          } else {   // straddles x's first or last byte
#pragma unroll
            for (int e = 0; e < G::V; ++e) {
              const uintptr_t p = a + e * sizeof(T);
              if (p >= xbeg && p < xend)
                reinterpret_cast<T*>(d)[e] = *reinterpret_cast<const T*>(p);
            }
          }
        }
        seg += (size_t)(CTHREADS / 32) * ncols_all;
      }
    }
    cp_async_arrive(bar);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  // depth kt's float x (landed in stage kt % STAGES) -> int8 into xq
  // buffer kt % XQ_BUFS, K-major: thread (column c, 16-k groups kg,
  // kg + 2), one 16-byte store each. A warp reads 32 consecutive elements
  // of one row (no bank conflict) and its stores fill whole 128-byte core
  // matrices.
  auto quantize = [&](int kt) {
    const T* xst = reinterpret_cast<const T*>(xs + (kt % G::STAGES) *
                                                       G::X_BYTES);
    uint8_t* dst = xq + (kt % G::XQ_BUFS) * G::XQ_BYTES;
    const int c = tid & (CN - 1);
    const int step = ncols_all & (G::V - 1);   // head change per row
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kg = (tid >> 7) + 2 * j;
      const int r0 = 16 * kg, k0 = kt * CK + r0;
      uint32_t q[16];
      // row r's head: its first element's place in its 16-byte chunk
      int head = (int)(((uintptr_t)(x + (xrow0 + k0) * ncols_all + t0) &
                        15) / sizeof(T));
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        q[e] = k0 + e < K
                   ? quantize1(to_float(xst[(r0 + e) * G::PITCH + head + c]),
                               inv_sx)
                   : 0u;
        head = (head + step) & (G::V - 1);
      }
      *reinterpret_cast<uint4*>(dst + core_offset(c, kg)) = make_uint4(
          pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]),
          pack4(q[8], q[9], q[10], q[11]), pack4(q[12], q[13], q[14], q[15]));
    }
  };

  int acc[2][64];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[mi][i] = 0;

  // one output-channel tile from the sums: scale and bias rounded as the
  // plain version rounds them, staged one warpgroup's 128 rows at a time
  // in the x regions (row r at r * PITCH, shifted by its head in device
  // memory), then written along time by every thread, consecutive
  // threads on consecutive 16-byte chunks of a row
  auto epilogue_tile = [&](int n0) {
    T* ys = reinterpret_cast<T*>(xs);
    const int w4 = warp & 3, g8 = lane >> 2, t4 = lane & 3;
    constexpr int NCH = G::PITCH / G::V;   // chunks per staged row
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int nh = n0 + 128 * half;
      if (wg == half) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = mi * 64 + w4 * 16 + g8 + 8 * h;
            const int n = nh + r;
            if (n >= N) continue;
            const float sc = scale[n], bi = bias[n];
            const int head = (int)(((uintptr_t)(out + (orow0 + n) *
                                                        ncols_all + t0) &
                                    15) / sizeof(T));
            T* yr = ys + r * G::PITCH + head;
#pragma unroll
            for (int j = 0; j < CN / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                store(yr + 8 * j + 2 * t4 + e,
                      epilogue(acc[mi][4 * j + 2 * h + e], sc, bi));
          }
      }
      __syncthreads();
      const int rows = min(128, N - nh);
#pragma unroll 4
      for (int i = tid; i < rows * NCH; i += CTHREADS) {
        const int r = i / NCH, j = i - r * NCH;
        T* o = out + (orow0 + nh + r) * ncols_all + t0;
        const int lo = j * G::V - (int)(((uintptr_t)o & 15) / sizeof(T));
        const T* y = ys + r * G::PITCH + j * G::V;   // chunk j's first
        if (lo >= 0 && lo + G::V <= ncols) {
          *reinterpret_cast<uint4*>(o + lo) =
              *reinterpret_cast<const uint4*>(y);
        } else if (lo < ncols) {   // the head or tail of the row
#pragma unroll
          for (int e = 0; e < G::V; ++e)
            if (lo + e >= 0 && lo + e < ncols) o[lo + e] = y[e];
        }
      }
      __syncthreads();
    }
  };

#pragma unroll
  for (int g = 0; g < G::STAGES - 1; ++g) issue(g);
  mbar_wait(full, 0);   // step 0 has landed
  quantize(0);
  fence_async_shared();
  __syncthreads();
  lap(0);

  for (int g = 0; g < steps; ++g) {
    const int jt = g / nk, kt = g - jt * nk;
    issue(g + G::STAGES - 1);   // into the stage that step g - 1 freed
    lap(2);
    const uint8_t* wa =
        ws + (g % G::STAGES) * G::W_BYTES + (wg * 128 / 8) * CORE_SBO;
    const uint8_t* xb = xq + (kt % G::XQ_BUFS) * G::XQ_BYTES;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < CK / 32; ++ks)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        wgmma_s8(acc[mi], smem_desc(wa + mi * 8 * CORE_SBO + ks * 256),
                 smem_desc(xb + ks * 256));
    wgmma_commit();
    lap(1);
    if (g + 1 < steps) {   // step g + 1's copies, quantized on tile 0
      mbar_wait(full + (g + 1) % G::STAGES, ((g + 1) / G::STAGES) & 1);
      lap(3);
      if (jt == 0 && kt + 1 < nk) {
        quantize(kt + 1);
        fence_async_shared();
      }
      lap(4);
    }
    wgmma_wait();
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) keep(acc[mi]);
    lap(5);
    __syncthreads();   // stage g % STAGES and the xq buffer it read free
    lap(1);
    if (kt == nk - 1) {   // the tile's sums are complete
      epilogue_tile((tile0 + jt) * CM);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[mi][i] = 0;
      lap(6);
    }
  }
  if (tracing) {
    long long* t = trace + TRACE_FIELDS *
        ((size_t)(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x);
#pragma unroll
    for (int f = 0; f < TRACE_FIELDS; ++f) t[f] = tr[f];
  }
}

// ---------------------------------------------------------------------
// row-major: mma.sync
// ---------------------------------------------------------------------
constexpr int BM = 128;       // output channels (rows of wq) per block
constexpr int BN = 128;       // rows of x per block
constexpr int BK = 64;        // reduction depth per stage
constexpr int LDS = BK + 16;  // shared row stride in bytes: 20 words, so
                              // the fragment reads hit 32 distinct banks
constexpr int THREADS = 256;  // 8 warps: 2 along BM x 4 along BN

// D = A(16x32, row) * B(32x8, col) + D, int8 operands, int32 sums
__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a,
                                       const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x [ncols, K], wq [N, K], out [ncols, N]
template <typename T>
__global__ void __launch_bounds__(THREADS)
qmm_dense_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, T* __restrict__ out, int K,
                 int N, int ncols, float inv_sx) {
  __shared__ __align__(16) int8_t As[BM * LDS];  // wq tile [BM][BK]
  __shared__ __align__(16) int8_t Bs[BN * LDS];  // xq tile [BN][BK]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;        // mma fragment coordinates
  const int wm = warp & 1, wn = warp >> 1;       // warp tile: 64 x 32
  const int n0 = blockIdx.x * BM;
  const int c0 = blockIdx.y * BN;
  const bool k16 = (K & 15) == 0;

  // each thread stages 8 groups of 4 consecutive k of one row of x: a
  // half-warp reads 64 consecutive k
  int col[8], kq[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    col[j] = (tid >> 4) + 16 * j;
    kq[j] = tid & 15;
  }

  float xr[8][4];
  int4 ar[2];

  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + col[j];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + 4 * kq[j] + e;
        xr[j][e] = k < K && c < ncols ? to_float(x[(size_t)c * K + k]) : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int chunk = tid + THREADS * i;
      const int row = n0 + (chunk >> 2);
      const int kc = k0 + 16 * (chunk & 3);
      int4 v = make_int4(0, 0, 0, 0);
      if (row < N) {
        const int8_t* src = wq + (size_t)row * K + kc;
        if (k16) {
          if (kc < K) v = *reinterpret_cast<const int4*>(src);
        } else {
          int8_t* bytes = reinterpret_cast<int8_t*>(&v);
#pragma unroll
          for (int e = 0; e < 16; ++e)
            if (kc + e < K) bytes[e] = src[e];
        }
      }
      ar[i] = v;
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  const int nk = (K + BK - 1) / BK;
  load(0);
  for (int kt = 0; kt < nk; ++kt) {
    // quantize the staged x into shared memory
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(&Bs[col[j] * LDS + 4 * kq[j]]) =
          quantize4(xr[j], inv_sx);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int chunk = tid + THREADS * i;
      *reinterpret_cast<int4*>(&As[(chunk >> 2) * LDS + 16 * (chunk & 3)]) =
          ar[i];
    }
    __syncthreads();
    if (kt + 1 < nk) load((kt + 1) * BK);  // in flight during the mma

#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm * 64 + mi * 16 + g;
        const int8_t* p = &As[r * LDS + kk + 4 * t4];
        a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = &Bs[(wn * 32 + ni * 8 + g) * LDS + kk + 4 * t4];
        b[ni][0] = *reinterpret_cast<const uint32_t*>(p);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

  // epilogue: acc[mi][ni] = {(r, c), (r, c+1), (r+8, c), (r+8, c+1)}
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + wm * 64 + mi * 16 + g + 8 * h;
      if (n >= N) continue;
      const float sc = scale[n], bi = bias[n];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + wn * 32 + ni * 8 + 2 * t4 + e;
          if (c < ncols)
            store(out + (size_t)c * N + n,
                  epilogue(acc[mi][ni][2 * h + e], sc, bi));
        }
      }
    }
  }
}

// The conv kernel's dynamic shared memory, granted once per device.
template <typename T, bool RES>
int set_conv_attributes() {
  static std::mutex mu;
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64) return (int)err;
  std::lock_guard<std::mutex> hold(mu);
  if (done[dev]) return 0;
  err = cudaFuncSetAttribute(qmm_conv_kernel<T, RES>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Geom<T, RES>::SMEM);
  done[dev] = err == cudaSuccess;
  return (int)err;
}

template <typename T, bool RES>
int launch_conv(const T* x, const int8_t* wp, const float* scale,
                const float* bias, T* out, int nb, int K, int N, int ncols,
                int tiles, float inv_sx, long long* trace,
                cudaStream_t stream) {
  const int err = set_conv_attributes<T, RES>();
  if (err != 0) return err;
  const dim3 grid((N + CM - 1) / CM / tiles, (ncols + CN - 1) / CN, nb);
  qmm_conv_kernel<T, RES><<<grid, CTHREADS, Geom<T, RES>::SMEM, stream>>>(
      x, wp, scale, bias, out, K, N, ncols, tiles, (size_t)nb * K * ncols,
      inv_sx, trace);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const int8_t* wq, const float* scale,
           const float* bias, void* out, int nb, int K, int N, int ncols,
           float inv_sx, int tiles, long long* trace, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (tiles > 1)
    return launch_conv<T, true>(xt, wq, scale, bias, ot, nb, K, N, ncols,
                                tiles, inv_sx, trace, stream);
  if (tiles == 1)
    return launch_conv<T, false>(xt, wq, scale, bias, ot, nb, K, N, ncols, 1,
                                 inv_sx, trace, stream);
  const dim3 grid((N + BM - 1) / BM, (ncols + BN - 1) / BN);
  qmm_dense_kernel<T><<<grid, THREADS, 0, stream>>>(xt, wq, scale, bias, ot,
                                                     K, N, ncols, inv_sx);
  return (int)cudaGetLastError();
}

}  // namespace

// The conv kernel's tile (output channels, time steps, depth), the most
// steps a block keeps quantized across tiles, and the int64 fields per
// block of its trace, for the wrapper.
extern "C" void quant_matmul_conv_geometry(int* out) {
  out[0] = CM;
  out[1] = CN;
  out[2] = CK;
  out[3] = RES_STEPS;
  out[4] = TRACE_FIELDS;
}

// x: [nb, K, ncols] (tiles > 0, channels-first) or [ncols, K] (tiles 0,
// Dense rows); wq: int8, 16-byte aligned: for channels-first packed as
// the conv kernel's tiles (see qmm_conv_kernel), else [N, K]; scale,
// bias: [N] fp32; out: x's dtype (fp32, or bf16 when is_bf16),
// contiguous; tiles: output-channel tiles per conv block (> 1 needs K <=
// RES_STEPS * CK and divides N / CM rounded up); trace: null, or for
// channels-first TRACE_FIELDS int64 per block (grid order) that thread 0
// of each block fills with its timeline. Returns the launch's cudaError_t
// (0 on success).
extern "C" int quant_matmul_launch(const void* x, const void* wq,
                                   const float* scale, const float* bias,
                                   void* out, int nb, int K, int N, int ncols,
                                   float inv_sx, int is_bf16, int tiles,
                                   void* trace, void* stream) {
  const int8_t* w = static_cast<const int8_t*>(wq);
  long long* tr = static_cast<long long*>(trace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, w, scale, bias, out, nb, K, N,
                                         ncols, inv_sx, tiles, tr, s)
                 : launch<float>(x, w, scale, bias, out, nb, K, N, ncols,
                                 inv_sx, tiles, tr, s);
}
