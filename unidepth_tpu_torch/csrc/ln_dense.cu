// Fused LayerNorm -> GEMM -> bias -> exact GELU for Hopper:
//   out = act(LayerNorm(x; gamma, beta, eps) @ W^T + b)
// x (M, C), W (F, C) in nn.Linear layout, b/gamma/beta fp32, out (M, F) in x's type.
//
// Replaces the TPU Pallas kernel unidepth_tpu/ops/fused_block.py
// _ln_dense_fwd / _ln_dense_kernel (the ViT block's LN2 -> fc1 -> GELU).
//
// What bounds it on the H100: compute. At the ViT-L serving shape
// (M = 8 * 1370, C = 1024, F = 4096) a call is ~92 GFLOP against ~120 MB of
// x, W and out, far above the card's ~295 FLOP/byte balance point, so the
// products run on the tensor cores (mma.sync m16n8k16, fp32 accumulation)
// and the normalised activation never goes to device memory: each block
// takes 128 rows, computes their mean and variance in fp32 (two passes, as
// the TPU kernel does), and normalises every 32-column slice of x in fp32
// in place in shared memory, in the GEMM's input type, just before the
// tensor cores read it (x and W slices arrive by cp.async, four in flight;
// fragments go through ldmatrix). The same block then sweeps several
// 128-column tiles of W, so the statistics are paid once per few output
// tiles, and they are computed while the first slices are in flight. The
// epilogue adds the bias and applies the exact GELU with erff (the TPU
// kernel's A&S erf approximation exists only because Mosaic has no erf).
// bf16 I/O takes the tensor cores; fp32 I/O takes a CUDA-core path
// (ln_dense_simt) whose fp32 products are exact.

#include <math.h>

#include "common.cuh"

namespace {

struct LnDenseArgs {
  const void* x;
  const void* w;
  const float* bias;
  const float* gamma;
  const float* beta;
  void* out;
  int m, c, f;
  float eps;
  int gelu;
};

__device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// Mean and 1/sqrt(var + eps) of `rows` rows starting at m0, one warp per
// row, 16-byte loads (C % 32 == 0 keeps every row 16-byte aligned).
template <typename T>
__device__ void row_stats(const LnDenseArgs& a, int m0, int rows, float* mu, float* rstd) {
  constexpr int kVec = 16 / sizeof(T);
  const T* X = static_cast<const T*>(a.x);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += nwarps) {
    const int row = m0 + r;
    if (row >= a.m) {
      if (lane == 0) mu[r] = rstd[r] = 0.f;
      continue;
    }
    const T* xr = X + (long long)row * a.c;
    float s = 0.f;
#pragma unroll 4
    for (int i = lane * kVec; i < a.c; i += 32 * kVec) {
      const uint4 u = *reinterpret_cast<const uint4*>(xr + i);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int k = 0; k < kVec; ++k) s += ud::to_float(e[k]);
    }
    const float mean = ud::warp_sum(s) / a.c;
    float v = 0.f;
#pragma unroll 4
    for (int i = lane * kVec; i < a.c; i += 32 * kVec) {
      const uint4 u = *reinterpret_cast<const uint4*>(xr + i);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float d = ud::to_float(e[k]) - mean;
        v += d * d;
      }
    }
    const float var = ud::warp_sum(v) / a.c;
    if (lane == 0) {
      mu[r] = mean;
      rstd[r] = 1.f / sqrtf(var + a.eps);
    }
  }
}

constexpr int kBM = 128, kBN = 128, kBK = 32, kThreads = 256;
constexpr int kStages = 4;    // k-slices in flight: the copies hide global latency
constexpr int kAS = kBK + 8;  // smem row stride: 8 ldmatrix rows fall in distinct banks
constexpr int kTile = kBM * kAS;  // elements of one 128 x 32 operand slice
constexpr int kBf16Smem = kStages * 2 * kTile * 2;

// Each thread copies (and later normalises) two 8-element chunks of every
// 128 x 32 slice: rows r and r + 64 at column c.
__device__ __forceinline__ int tile_row() { return threadIdx.x >> 2; }
__device__ __forceinline__ int tile_col() { return (threadIdx.x & 3) * 8; }

// x and W slices k0 -> shared memory by cp.async (x rows past M zero-filled)
__device__ __forceinline__ void issue_slice(const LnDenseArgs& a, int m0, int n0, int k0,
                                            __nv_bfloat16* as, __nv_bfloat16* bs) {
  const __nv_bfloat16* X = static_cast<const __nv_bfloat16*>(a.x);
  const __nv_bfloat16* W = static_cast<const __nv_bfloat16*>(a.w);
  const int c = tile_col();
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = tile_row() + 64 * j;
    const bool in = m0 + r < a.m;
    ud::cp_async16(as + r * kAS + c, X + (long long)(in ? m0 + r : 0) * a.c + k0 + c, in ? 16 : 0);
    ud::cp_async16(bs + r * kAS + c, W + (long long)(n0 + r) * a.c + k0 + c, 16);
  }
}

// Normalise, in place and in fp32, the two x chunks this thread copied
// (its own cp.async results are visible to it after the wait).
__device__ __forceinline__ void normalize_own(const LnDenseArgs& a, int k0, const float* mu,
                                              const float* rstd, __nv_bfloat16* as) {
  const int c = tile_col();
  const float4 g0 = *reinterpret_cast<const float4*>(a.gamma + k0 + c);
  const float4 g1 = *reinterpret_cast<const float4*>(a.gamma + k0 + c + 4);
  const float4 b0 = *reinterpret_cast<const float4*>(a.beta + k0 + c);
  const float4 b1 = *reinterpret_cast<const float4*>(a.beta + k0 + c + 4);
  const float gs[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
  const float bt[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = tile_row() + 64 * j;
    uint4* chunk = reinterpret_cast<uint4*>(as + r * kAS + c);
    const uint4 raw = *chunk;
    const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&raw);
    const float mean = mu[r], rs = rstd[r];
    uint4 packed;
    uint32_t* pw = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float y0 = (__bfloat162float(xe[2 * e]) - mean) * rs * gs[2 * e] + bt[2 * e];
      const float y1 = (__bfloat162float(xe[2 * e + 1]) - mean) * rs * gs[2 * e + 1] + bt[2 * e + 1];
      pw[e] = ud::pack_bf16(y0, y1);
    }
    *chunk = packed;
  }
}

// 8 warps as 2 (rows) x 4 (cols); each warp owns a 64 x 32 output tile:
// 4 x 4 mma tiles, 64 fp32 accumulators per lane. One barrier per k-slice:
// slice kt is multiplied while slices kt+1.. are in flight and each thread
// normalises its own chunks of slice kt+1.
__global__ void __launch_bounds__(kThreads) ln_dense_bf16(LnDenseArgs a) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* slices = reinterpret_cast<bf16*>(smem);  // [stage][x slice | W slice]
  __shared__ float mu[kBM], rstd[kBM];
  auto a_stage = [&](int k) { return slices + (k % kStages) * 2 * kTile; };
  auto b_stage = [&](int k) { return slices + (k % kStages) * 2 * kTile + kTile; };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // epilogue: accumulator (row g, columns 2t, 2t+1)
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int m0 = blockIdx.y * kBM;
  const int ktiles = a.c / kBK;
  bool have_stats = false;

  for (int n0 = blockIdx.x * kBN; n0 < a.f; n0 += gridDim.x * kBN) {
    // every group is committed, empty or not, so the wait counts stay fixed
    for (int k = 0; k < kStages - 1; ++k) {
      if (k < ktiles) issue_slice(a, m0, n0, k * kBK, a_stage(k), b_stage(k));
      ud::cp_async_commit();
    }
    if (!have_stats) {  // overlaps the first slices' flight
      row_stats<bf16>(a, m0, kBM, mu, rstd);
      __syncthreads();
      have_stats = true;
    }
    ud::cp_async_wait<kStages - 2>();
    normalize_own(a, 0, mu, rstd, a_stage(0));
    __syncthreads();

    float acc[4][4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

    for (int kt = 0; kt < ktiles; ++kt) {
      // its stage held slice kt - 1, released by the previous barrier
      if (kt + kStages - 1 < ktiles)
        issue_slice(a, m0, n0, (kt + kStages - 1) * kBK, a_stage(kt + kStages - 1), b_stage(kt + kStages - 1));
      ud::cp_async_commit();
      const bf16* as = a_stage(kt);
      const bf16* bs = b_stage(kt);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t af[4][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
          ud::ldmatrix_x4(af[mi], as + (wm + mi * 16 + (lane & 15)) * kAS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          uint32_t bf[4];  // b0, b1 of column tiles 2nj and 2nj + 1
          ud::ldmatrix_x4(bf, bs + (wn + nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * kAS + kk * 16 +
                                  ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            ud::mma_bf16_16816(acc[mi][2 * nj], af[mi], bf[0], bf[1]);
            ud::mma_bf16_16816(acc[mi][2 * nj + 1], af[mi], bf[2], bf[3]);
          }
        }
      }
      ud::cp_async_wait<kStages - 2>();  // slice kt + 1 has landed
      if (kt + 1 < ktiles) normalize_own(a, (kt + 1) * kBK, mu, rstd, a_stage(kt + 1));
      __syncthreads();
    }

    bf16* out = static_cast<bf16*>(a.out);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn + ni * 8 + 2 * t;
      const float bias0 = a.bias[col], bias1 = a.bias[col + 1];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int row = m0 + wm + mi * 16 + g;
        float v0 = acc[mi][ni][0] + bias0, v1 = acc[mi][ni][1] + bias1;
        float v2 = acc[mi][ni][2] + bias0, v3 = acc[mi][ni][3] + bias1;
        if (a.gelu) {
          v0 = gelu_exact(v0);
          v1 = gelu_exact(v1);
          v2 = gelu_exact(v2);
          v3 = gelu_exact(v3);
        }
        if (row < a.m) *reinterpret_cast<uint32_t*>(out + (long long)row * a.f + col) = ud::pack_bf16(v0, v1);
        if (row + 8 < a.m) *reinterpret_cast<uint32_t*>(out + (long long)(row + 8) * a.f + col) = ud::pack_bf16(v2, v3);
      }
    }
  }
}

// CUDA-core path for fp32 I/O (and any T): 64 x 64 output tile per block,
// 4 x 4 per thread, 16-column k-slices normalised into shared memory.
constexpr int kSBM = 64, kSBN = 64, kSBK = 16;

template <typename T>
__global__ void __launch_bounds__(kThreads) ln_dense_simt(LnDenseArgs a) {
  __shared__ float as[kSBK][kSBM + 4];
  __shared__ float bs[kSBK][kSBN + 4];
  __shared__ float mu[kSBM], rstd[kSBM];
  const T* X = static_cast<const T*>(a.x);
  const T* W = static_cast<const T*>(a.w);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kSBM, n0 = blockIdx.x * kSBN;
  row_stats<T>(a, m0, kSBM, mu, rstd);

  float acc[4][4] = {};
  const int lr = tid >> 2, lk = (tid & 3) * 4;  // loader: 64 rows x 4 chunks of 4
  for (int k0 = 0; k0 < a.c; k0 += kSBK) {
    __syncthreads();  // statistics ready / previous slice consumed
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k0 + lk + e;
      float y = 0.f;
      if (m0 + lr < a.m) {
        const float xv = ud::to_float(X[(long long)(m0 + lr) * a.c + k]);
        y = ud::round_to<T>((xv - mu[lr]) * rstd[lr] * a.gamma[k] + a.beta[k]);
      }
      as[lk + e][lr] = y;
      bs[lk + e][lr] = ud::to_float(W[(long long)(n0 + lr) * a.c + k]);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSBK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = as[k][ty * 4 + i];
        bv[i] = bs[k][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= a.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      float v = acc[i][j] + a.bias[col];
      if (a.gelu) v = gelu_exact(v);
      out[(long long)row * a.f + col] = ud::from_float<T>(v);
    }
  }
}

}  // namespace

// Shapes the wrapper guarantees: C % 32 == 0, F % 128 == 0, rows contiguous,
// 16-byte aligned bases.
extern "C" int ud_ln_dense_fwd(const void* x, const void* w, const float* bias, const float* gamma,
                               const float* beta, void* out, int m, int c, int f, float eps, int gelu,
                               int dtype, void* stream) {
  if (m <= 0 || c % kBK != 0 || f % kBN != 0) return cudaErrorInvalidValue;
  LnDenseArgs a{x, w, bias, gamma, beta, out, m, c, f, eps, gelu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ud::kBFloat16) {
    // a few column tiles per block amortise the row statistics
    const int col_blocks = f / kBN < 8 ? f / kBN : 8;
    if ((m + kBM - 1) / kBM > 65535) return cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(ln_dense_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, kBf16Smem);
    if (e != cudaSuccess) return e;
    dim3 grid(col_blocks, (m + kBM - 1) / kBM);
    ln_dense_bf16<<<grid, kThreads, kBf16Smem, s>>>(a);
  } else if (dtype == ud::kFloat32) {
    if ((m + kSBM - 1) / kSBM > 65535) return cudaErrorInvalidValue;
    dim3 grid(f / kSBN, (m + kSBM - 1) / kSBM);
    ln_dense_simt<float><<<grid, kThreads, 0, s>>>(a);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
