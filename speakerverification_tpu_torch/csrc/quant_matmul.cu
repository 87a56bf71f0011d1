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
// cannot contract them into an FMA, and rintf rounds half to even like
// jnp.round: the kernel matches its plain PyTorch version bit for bit.
//
// Layouts. Channels-first (a 1x1 conv or an im2col'd conv, the port's
// activations): x [nb, K, ncols] with the time axis contiguous, out
// [nb, N, ncols]. Row-major (a Dense layer): x [ncols, K], out
// [ncols, N], nb = 1. Either way a block computes out for BM output
// channels x BN columns of one batch row: A = wq (row-major, K
// contiguous), B = the x tile. The transpose that the tensor cores want
// (K contiguous per column) happens while the x tile is quantized into
// shared memory, so no transposed copy of the activation ever exists in
// device memory.
//
// What bounds it on an H100: bytes. At the hot layer (Raw3_ECAPA's
// 1x1 1024 -> 1024 convs at 1,575 frames x 160 crops) a 4-byte input
// and a 4-byte output per element against K = 1024 int8 multiply-adds
// is ~256 int8 operations per byte, below the card's ~590 int8 ops/byte
// ridge. The design reads x once per output-channel tile (the tiles of
// one x tile run next to one another, so the re-reads come from L2),
// keeps the int8 operands in shared memory and the int32 sums in
// registers, and writes out once. It uses mma.sync m16n8k32 (s8 x s8 ->
// s32); the x tile of the next K step is loaded into registers while
// the tensor cores work on the current one. wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;       // output channels (rows of wq) per block
constexpr int BN = 128;       // columns (time steps or Dense rows) per block
constexpr int BK = 64;        // reduction depth per stage
constexpr int LDS = BK + 16;  // shared row stride in bytes: 20 words, so
                              // the fragment reads hit 32 distinct banks
constexpr int THREADS = 256;  // 8 warps: 2 along BM x 4 along BN

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t quantize4(const float* v, float inv_sx) {
  uint32_t word = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float q = rintf(__fmul_rn(v[e], inv_sx));
    q = fminf(fmaxf(q, -127.f), 127.f);
    word |= ((uint32_t)(int)q & 0xffu) << (8 * e);
  }
  return word;
}

// D = A(16x32, row) * B(32x8, col) + D, int8 operands, int32 sums
__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a,
                                       const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T, bool CF>
__global__ void __launch_bounds__(THREADS)
qmm_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
           const float* __restrict__ scale, const float* __restrict__ bias,
           T* __restrict__ out, int K, int N, int ncols, float inv_sx) {
  __shared__ __align__(16) int8_t As[BM * LDS];  // wq tile [BM][BK]
  __shared__ __align__(16) int8_t Bs[BN * LDS];  // xq tile [BN][BK]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;        // mma fragment coordinates
  const int wm = warp & 1, wn = warp >> 1;       // warp tile: 64 x 32
  const int n0 = blockIdx.x * BM;
  const int c0 = blockIdx.y * BN;
  const T* xb = x + (CF ? (size_t)blockIdx.z * K * ncols : 0);
  T* ob = out + (CF ? (size_t)blockIdx.z * N * ncols : 0);
  const bool k16 = (K & 15) == 0;

  // each thread stages 8 groups of 4 consecutive k of one column
  int col[8], kq[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (CF) {            // a warp reads 32 consecutive time steps
      col[j] = tid & (BN - 1);
      kq[j] = (tid >> 7) + 2 * j;
    } else {             // a half-warp reads 64 consecutive k of one row
      col[j] = (tid >> 4) + 16 * j;
      kq[j] = tid & 15;
    }
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
        float v = 0.f;
        if (k < K && c < ncols)
          v = to_float(CF ? xb[(size_t)k * ncols + c] : xb[(size_t)c * K + k]);
        xr[j][e] = v;
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
    // quantize and transpose the staged x into shared memory
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
          if (c >= ncols) continue;
          const float v = __fadd_rn(
              __fmul_rn(__int2float_rn(acc[mi][ni][2 * h + e]), sc), bi);
          store(CF ? ob + (size_t)n * ncols + c : ob + (size_t)c * N + n, v);
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const int8_t* wq, const float* scale,
                   const float* bias, void* out, int nb, int K, int N,
                   int ncols, float inv_sx, bool channels_first,
                   cudaStream_t stream) {
  const dim3 grid((N + BM - 1) / BM, (ncols + BN - 1) / BN,
                  channels_first ? nb : 1);
  if (channels_first)
    qmm_kernel<T, true><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), wq, scale, bias, static_cast<T*>(out), K,
        N, ncols, inv_sx);
  else
    qmm_kernel<T, false><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), wq, scale, bias, static_cast<T*>(out), K,
        N, ncols, inv_sx);
  return cudaGetLastError();
}

}  // namespace

// x: [nb, K, ncols] (channels_first) or [ncols, K]; wq: [N, K] int8;
// scale, bias: [N] fp32; out: x's dtype (fp32, or bf16 when is_bf16).
// Returns the launch's cudaError_t (0 on success).
extern "C" int quant_matmul_launch(const void* x, const void* wq,
                                   const float* scale, const float* bias,
                                   void* out, int nb, int K, int N, int ncols,
                                   float inv_sx, int is_bf16,
                                   int channels_first, void* stream) {
  const int8_t* w = static_cast<const int8_t*>(wq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, w, scale, bias, out, nb, K, N, ncols,
                                      inv_sx, channels_first != 0, s)
              : launch<float>(x, w, scale, bias, out, nb, K, N, ncols,
                              inv_sx, channels_first != 0, s);
  return (int)err;
}
