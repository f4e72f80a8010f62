// Flash attention forward for Hopper: softmax(scale * q k^T) v per (batch, head).
//
// Replaces the TPU Pallas kernels of unidepth_tpu/ops/flash_attention.py:
//   * _flash_fwd_qkv / _packed_kernel (flash_attention_qkv): q, k, v are the
//     channel slices [0,C), [C,2C), [2C,3C) of the fused (B, N, 3C) QKV
//     projection, heads channel-major (H, D); output (B, N, C);
//   * _flash_fwd / _flash_kernel (flash_attention): flat (BH, N, D) tensors;
//   * _flash_fwd_packed / _packed_kernel (flash_attention_packed): three
//     (B, N, H*D) tensors, on the int8 serving path the strided channel
//     views of one fused projection (row stride 3C, batch stride N * 3C).
// One kernel serves all three: it takes a base pointer, a batch stride and a
// row stride per tensor, and head h starts at column h * D of each row.
//
// What bounds it on the H100: compute. At the ViT-L serving shape (B=8,
// N=1370, H=16, D=64) a call is ~61.5 GFLOP against < 0.1 GB of q/k/v/o, so
// the kernel must keep both products on the tensor cores and the N x N
// scores out of device memory. Design: a block owns 64 queries of one
// (batch, head); each of its 4 warps keeps 16 query rows in mma.sync
// fragments, walks 64-key K/V tiles that cp.async stages in shared memory
// one tile ahead (fragments through ldmatrix), and keeps an
// online row max and row sum in fp32 registers (FlashAttention-2 order).
// The max-free exp(min(s, 80)) of the TPU serving kernel is a device for
// the TPU's vector unit and is not carried over: the row max makes the
// kernel exact for any logits. `scale` is applied to the fp32 scores.
// Ragged N: key rows past Nk load as 0 and their scores as -inf, query rows
// past Nq load as 0 and are not stored, so no 0 * NaN can arise.
// bf16 I/O runs on the tensor cores (m16n8k16, fp32 accumulation); fp32 I/O
// takes a CUDA-core path (attn_fwd_simt) that keeps fp32 products exact.
// Head dim 8 (the JAX packed regime takes any D dividing 128) runs the
// tensor-core body at the 16-deep mma step: the tiles keep 16 columns whose
// upper 8 are zeroed once in shared memory, q's upper fragment halves are 0,
// and only the first 8 output columns are stored; q/k/v are not copied.

#include <math.h>

#include "common.cuh"

namespace {

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int heads, nq, nk;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs;  // element strides
  float scale;
};

constexpr int kBlockM = 64;   // queries per block (16 per warp)
constexpr int kBlockN = 64;   // keys per shared-memory tile
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

// the head dim the tensor-core body computes with: D rounded up to the mma k step
template <int D>
__host__ __device__ constexpr int mma_dim() {
  return D < 16 ? 16 : D;
}

template <int D>
constexpr int attn_bf16_smem_bytes() {
  return 2 * 2 * kBlockN * (mma_dim<D>() + 8) * 2;  // two stages of K and V tiles
}

template <int D>
__global__ void __launch_bounds__(kThreads) attn_fwd_bf16(AttnArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int DM = mma_dim<D>();
  constexpr int RS = DM + 8;  // tile row stride: 8 ldmatrix rows fall in distinct banks
  constexpr int kStage = 2 * kBlockN * RS;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* tiles = reinterpret_cast<bf16*>(smem);  // [stage][K rows | V rows][RS]
  if constexpr (DM != D) {
    // columns D..DM-1 of every tile row stay zero: cp.async writes only [0, D)
    for (int i = threadIdx.x; i < 2 * 2 * kBlockN; i += kThreads)
      *reinterpret_cast<uint4*>(tiles + i * RS + D) = make_uint4(0u, 0u, 0u, 0u);
  }

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const bf16* Q = static_cast<const bf16*>(a.q) + b * a.q_bs + (long long)h * D;
  const bf16* K = static_cast<const bf16*>(a.k) + b * a.k_bs + (long long)h * D;
  const bf16* V = static_cast<const bf16*>(a.v) + b * a.v_bs + (long long)h * D;
  bf16* O = static_cast<bf16*>(a.o) + b * a.o_bs + (long long)h * D;

  // K and V rows n0.. of this head -> stage `st`, asynchronously; rows past
  // nk are zero-filled (a 0-byte copy reads nothing)
  auto issue = [&](int n0, int st) {
    bf16* ks = tiles + st * kStage;
    bf16* vs = ks + kBlockN * RS;
    constexpr int kChunks = D / 8;  // 16-byte chunks per row
    for (int i = tid; i < kBlockN * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const bool in = n0 + r < a.nk;
      const long long row = in ? n0 + r : 0;
      ud::cp_async16(ks + r * RS + c, K + row * a.k_rs + c, in ? 16 : 0);
      ud::cp_async16(vs + r * RS + c, V + row * a.v_rs + c, in ? 16 : 0);
    }
    ud::cp_async_commit();
  };
  issue(0, 0);

  const int r0 = blockIdx.x * kBlockM + warp * 16 + g;  // this lane's rows r0, r1
  const int r1 = r0 + 8;
  const bool ok0 = r0 < a.nq, ok1 = r1 < a.nq;

  uint32_t qf[DM / 16][4];
#pragma unroll
  for (int kk = 0; kk < DM / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    const bool hi = D >= 16 || c + 8 < D;  // false only in the zero half of D = 8
    qf[kk][0] = ok0 ? *reinterpret_cast<const uint32_t*>(Q + r0 * a.q_rs + c) : 0u;
    qf[kk][1] = ok1 ? *reinterpret_cast<const uint32_t*>(Q + r1 * a.q_rs + c) : 0u;
    qf[kk][2] = ok0 && hi ? *reinterpret_cast<const uint32_t*>(Q + r0 * a.q_rs + c + 8) : 0u;
    qf[kk][3] = ok1 && hi ? *reinterpret_cast<const uint32_t*>(Q + r1 * a.q_rs + c + 8) : 0u;
  }

  float o[DM / 8][4];
#pragma unroll
  for (int i = 0; i < DM / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running row max, log2 domain
  float l0 = 0.f, l1 = 0.f;              // this lane's partial row sums
  const float sl2 = a.scale * kLog2e;

  const int ntiles = (a.nk + kBlockN - 1) / kBlockN;
  for (int it = 0; it < ntiles; ++it) {
    const int n0 = it * kBlockN;
    if (it + 1 < ntiles) {
      issue(n0 + kBlockN, (it + 1) & 1);  // next tile lands during this one's math
      ud::cp_async_wait<1>();
    } else {
      ud::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = tiles + (it & 1) * kStage;
    const bf16* vs = ks + kBlockN * RS;

    // S = Q K^T for this warp's 16 rows x 64 keys (8 tiles of 8 keys);
    // one ldmatrix.x4 gives b0, b1 of two neighbouring key tiles
    float s[kBlockN / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int jp = 0; jp < kBlockN / 16; ++jp) {
#pragma unroll
      for (int kk = 0; kk < DM / 16; ++kk) {
        uint32_t kb[4];
        ud::ldmatrix_x4(kb, ks + (16 * jp + (lane & 7) + ((lane >> 4) << 3)) * RS + kk * 16 + ((lane >> 3) & 1) * 8);
        ud::mma_bf16_16816(s[2 * jp], qf[kk], kb[0], kb[1]);
        ud::mma_bf16_16816(s[2 * jp + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // scale into the log2 domain, mask keys past nk, online row max
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      s[j][0] = col < a.nk ? s[j][0] * sl2 : -INFINITY;
      s[j][1] = col + 1 < a.nk ? s[j][1] * sl2 : -INFINITY;
      s[j][2] = col < a.nk ? s[j][2] * sl2 : -INFINITY;
      s[j][3] = col + 1 < a.nk ? s[j][3] * sl2 : -INFINITY;
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    // a row's 8 key tiles are spread over the 4 lanes of its quad
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // every tile holds key n0 < nk, so mx is finite and exp2(-inf - mx) = 0
    const float al0 = exp2f(m0 - mx0), al1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= al0;
    l1 *= al1;
#pragma unroll
    for (int i = 0; i < DM / 8; ++i) {
      o[i][0] *= al0;
      o[i][1] *= al0;
      o[i][2] *= al1;
      o[i][3] *= al1;
    }

    // P = exp2(S - m): the accumulator tiles of two neighbouring key tiles
    // are exactly the A fragment of one 16-key step of P V
    uint32_t pf[kBlockN / 16][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      const float p0 = exp2f(s[j][0] - m0), p1 = exp2f(s[j][1] - m0);
      const float p2 = exp2f(s[j][2] - m1), p3 = exp2f(s[j][3] - m1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      pf[j / 2][(j & 1) * 2 + 0] = ud::pack_bf16(p0, p1);
      pf[j / 2][(j & 1) * 2 + 1] = ud::pack_bf16(p2, p3);
    }

    // O += P V; ldmatrix.trans turns row-major V into b0, b1 of two
    // neighbouring 8-column tiles of D
#pragma unroll
    for (int ip = 0; ip < DM / 16; ++ip) {
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        uint32_t vb[4];
        ud::ldmatrix_x4_trans(vb, vs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * RS + 16 * ip + (lane >> 4) * 8);
        ud::mma_bf16_16816(o[2 * ip], pf[kk], vb[0], vb[1]);
        ud::mma_bf16_16816(o[2 * ip + 1], pf[kk], vb[2], vb[3]);
      }
    }
    __syncthreads();  // this stage is free for the copy two tiles ahead
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int c = 8 * i + 2 * t;
    if (ok0)
      *reinterpret_cast<uint32_t*>(O + r0 * a.o_rs + c) = ud::pack_bf16(o[i][0] * inv0, o[i][1] * inv0);
    if (ok1)
      *reinterpret_cast<uint32_t*>(O + r1 * a.o_rs + c) = ud::pack_bf16(o[i][2] * inv1, o[i][3] * inv1);
  }
}

// CUDA-core path for fp32 I/O (and any T): 32 queries x 32-key tiles per
// block, 4 threads per query row. Products and sums stay in fp32; P is
// rounded to T before P V, as the TPU kernel casts p to v's type.
constexpr int kSimtM = 32, kSimtN = 32;

template <int D>
constexpr int attn_simt_smem_bytes() {
  return (kSimtM * (D + 1) + kSimtN * (D + 1) + kSimtN * D + kSimtM * (kSimtN + 1)) * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) attn_fwd_simt(AttnArgs a) {
  constexpr int DP = D + 1, PS = kSimtN + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [kSimtM][DP]
  float* ks = qs + kSimtM * DP;                // [kSimtN][DP]
  float* vs = ks + kSimtN * DP;                // [kSimtN][D]
  float* ps = vs + kSimtN * D;                 // [kSimtM][PS]

  const int tid = threadIdx.x, r = tid >> 2, sub = tid & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kSimtM;
  const T* Q = static_cast<const T*>(a.q) + b * a.q_bs + (long long)h * D;
  const T* K = static_cast<const T*>(a.k) + b * a.k_bs + (long long)h * D;
  const T* V = static_cast<const T*>(a.v) + b * a.v_bs + (long long)h * D;
  T* O = static_cast<T*>(a.o) + b * a.o_bs + (long long)h * D;

  for (int i = tid; i < kSimtM * D; i += kThreads) {
    const int rr = i / D, d = i % D;
    qs[rr * DP + d] = q0 + rr < a.nq ? ud::to_float(Q[(q0 + rr) * a.q_rs + d]) : 0.f;
  }
  float o[D / 4];
#pragma unroll
  for (int j = 0; j < D / 4; ++j) o[j] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int n0 = 0; n0 < a.nk; n0 += kSimtN) {
    __syncthreads();
    for (int i = tid; i < kSimtN * D; i += kThreads) {
      const int rr = i / D, d = i % D;
      const bool in = n0 + rr < a.nk;
      ks[rr * DP + d] = in ? ud::to_float(K[(n0 + rr) * a.k_rs + d]) : 0.f;
      vs[rr * D + d] = in ? ud::to_float(V[(n0 + rr) * a.v_rs + d]) : 0.f;
    }
    __syncthreads();

    float s[kSimtN / 4];
    float mx = m;
#pragma unroll
    for (int i = 0; i < kSimtN / 4; ++i) {
      const int c = sub + 4 * i;
      float acc = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) acc = fmaf(qs[r * DP + d], ks[c * DP + d], acc);
      s[i] = n0 + c < a.nk ? acc * a.scale : -INFINITY;
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float alpha = expf(m - mx);
    m = mx;
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < kSimtN / 4; ++i) {
      const float p = expf(s[i] - m);
      psum += p;
      ps[r * PS + sub + 4 * i] = ud::round_to<T>(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    __syncwarp();  // the 4 threads of a row share one warp
#pragma unroll
    for (int j = 0; j < D / 4; ++j) {
      const int d = sub + 4 * j;
      float acc = o[j] * alpha;
#pragma unroll 8
      for (int c = 0; c < kSimtN; ++c) acc = fmaf(ps[r * PS + c], vs[c * D + d], acc);
      o[j] = acc;
    }
  }
  if (q0 + r < a.nq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 4; ++j) O[(q0 + r) * a.o_rs + sub + 4 * j] = ud::from_float<T>(o[j] * inv);
  }
}

template <int D>
cudaError_t launch(const AttnArgs& a, int batch, int dtype, cudaStream_t stream) {
  if (dtype == ud::kBFloat16) {
    constexpr int smem = attn_bf16_smem_bytes<D>();
    cudaError_t e = cudaFuncSetAttribute(attn_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    dim3 grid((a.nq + kBlockM - 1) / kBlockM, a.heads, batch);
    attn_fwd_bf16<D><<<grid, kThreads, smem, stream>>>(a);
  } else {
    constexpr int smem = attn_simt_smem_bytes<D>();
    cudaError_t e = cudaFuncSetAttribute(attn_fwd_simt<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    dim3 grid((a.nq + kSimtM - 1) / kSimtM, a.heads, batch);
    attn_fwd_simt<float, D><<<grid, kThreads, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int ud_attention_fwd(const void* q, const void* k, const void* v, void* o, int batch,
                                int heads, int nq, int nk, int head_dim, long long q_bs,
                                long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                                long long v_rs, long long o_bs, long long o_rs, float scale,
                                int dtype, void* stream) {
  if (dtype != ud::kFloat32 && dtype != ud::kBFloat16) return cudaErrorInvalidValue;
  if (batch > 65535 || heads > 65535 || nq <= 0 || nk <= 0) return cudaErrorInvalidValue;
  AttnArgs a{q, k, v, o, heads, nq, nk, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 8: return launch<8>(a, batch, dtype, s);
    case 16: return launch<16>(a, batch, dtype, s);
    case 32: return launch<32>(a, batch, dtype, s);
    case 64: return launch<64>(a, batch, dtype, s);
    case 128: return launch<128>(a, batch, dtype, s);
    default: return cudaErrorInvalidValue;
  }
}

// K4's entry: the packed regime of _packed_supported (whole-K, at most 4096
// keys; the wrapper routes longer key sets to K3), every row holding all
// heads, and 16-byte aligned rows and batches for cp.async. q arrives
// unscaled; `scale` is applied to the fp32 scores as for K1 and K3.
extern "C" int ud_attention_packed_fwd(const void* q, const void* k, const void* v, void* o,
                                       int batch, int heads, int nq, int nk, int head_dim,
                                       long long q_bs, long long q_rs, long long k_bs,
                                       long long k_rs, long long v_bs, long long v_rs,
                                       long long o_bs, long long o_rs, float scale, int dtype,
                                       void* stream) {
  const long long c = static_cast<long long>(heads) * head_dim;
  if (nk > 4096 || q_rs < c || k_rs < c || v_rs < c || o_rs < c) return cudaErrorInvalidValue;
  if ((q_bs | q_rs | k_bs | k_rs | v_bs | v_rs | o_bs | o_rs) % 8) return cudaErrorInvalidValue;
  return ud_attention_fwd(q, k, v, o, batch, heads, nq, nk, head_dim, q_bs, q_rs, k_bs, k_rs,
                          v_bs, v_rs, o_bs, o_rs, scale, dtype, stream);
}

extern "C" const char* ud_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
