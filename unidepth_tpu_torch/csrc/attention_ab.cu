// Packed-attention A/B variants for Hopper: the kernels of the A/B harness
// (scripts_torch/kernel_ab.py).
//
// Replaces the TPU Pallas kernels of scripts/kernel_ab.py:
//   * make_kernel (run_variant): a family of head-packed attention variants,
//     selected by name, that A/B the softmax levers (row max or none, exp or
//     none, fp32 or bf16 row sum, GEMMs alone). The names compute nine
//     functions M1-M9 (attention_wgmma.cuh lists them); the TPU-only layout
//     names (transposed scores, in-kernel relayout, one q block) compute the
//     same function as another name and share its instantiation
//     (ops/kernel_ab.py maps names to families). Every normalising family
//     divides by max(l, 1e-30), masks keys past N with -1e30, and the caller
//     pre-scales q and rounds it to bf16, as the harness does.
//   * make_bd_kernel (run_bd): head-pair attention. On the TPU two heads of
//     64 share one 128-deep QK^T product through a block-diagonal K/V, which
//     doubles the MACs to fill the MXU; that is not carried over. Here a
//     work tile owns 64 queries of a head pair and both heads' K/V tiles,
//     the 256 contiguous bytes of each q, k and v row, and runs both heads'
//     products on them. It computes M3 (or M4 when l is summed from bf16 p,
//     the harness's l_on_mxu).
//
// What bounds it on the H100: compute, as for K1. At the harness shape (B=8,
// N=1370, H=16, D=64) the full-softmax families do ~61.5 GFLOP (QK^T and
// P V) against < 0.1 GB of I/O; M8 and M9 do one of the two products.
//
// Two bodies. At head dim 64 (the harness shape) both kernels run K1's
// Hopper body (attention_wgmma.cuh: wgmma for both products, TMA through a
// three-stage mbarrier ring, a persistent grid, 128 x 128 tiles), so the
// levers are priced where K1 runs: the entries ud_attention_ab_hopper_fwd
// (M1-M9, one head a work tile, scale 1) and ud_attention_bd_hopper_fwd
// (head pairs, a consumer warpgroup a head). M6 streams K alone in a first
// pass for its row max; M8 skips V and M9 skips K. Head dim 32 (one head is
// half a 128-byte swizzled row) keeps the mma.sync body below, the first
// one, which the entries ud_attention_ab_fwd / ud_attention_bd_fwd still
// launch at 64 too, to time it beside the new one: 64 queries per block,
// 16 per warp in mma.sync m16n8k16 fragments, 64-key K/V tiles staged one
// ahead by cp.async and read by ldmatrix, P re-packed in registers for P V,
// scores never written to device memory; M6 makes two passes over the K
// tiles.
// Both bodies still do all of the product they time: wgmma and mma.sync are
// asm volatile, so a product whose result is dead is not dropped.
// bf16 I/O only: the harness studies the tensor-core path.

#include <math.h>

#include "attention_wgmma.cuh"

namespace {

struct AbArgs {
  const void* q;  // pre-scaled, (B, Nq, C)
  const void* k;  // (B, Nk, C)
  const void* v;  // (B, Nk, C)
  void* o;        // (B, Nq, C)
  int nq, nk, c;  // rows are contiguous: C = heads * D channels, head h at column h * D
};

constexpr int kBlockM = 64;
constexpr int kBlockN = 64;
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked = -1e30f;  // the harness's _NEG_INF
constexpr int kPairStages = 3;     // K7's K/V ring: 3 x 64 KB of K and V

template <int D, int NH>
constexpr int ab_smem_bytes() {
  return 2 * 2 * kBlockN * (NH * D + 8) * 2;  // two stages of K and V tiles
}

// One block: 64 queries of NH consecutive heads of one batch row.
template <int F, int D, int NH>
__global__ void __launch_bounds__(kThreads) ab_fwd(AbArgs a) {
  using P = Policy<F>;
  using bf16 = __nv_bfloat16;
  constexpr int RS = NH * D + 8;  // tile row stride: 8 ldmatrix rows fall in distinct banks
  constexpr int kStage = 2 * kBlockN * RS;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* tiles = reinterpret_cast<bf16*>(smem);  // [stage][K rows | V rows][RS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long b = blockIdx.z;
  const int col0 = blockIdx.y * NH * D;
  const bf16* Q = static_cast<const bf16*>(a.q) + b * a.nq * a.c + col0;
  const bf16* K = static_cast<const bf16*>(a.k) + b * a.nk * a.c + col0;
  const bf16* V = static_cast<const bf16*>(a.v) + b * a.nk * a.c + col0;
  bf16* O = static_cast<bf16*>(a.o) + b * a.nq * a.c + col0;

  auto issue = [&](int n0, int st) {
    bf16* ks = tiles + st * kStage;
    bf16* vs = ks + kBlockN * RS;
    constexpr int kChunks = NH * D / 8;  // 16-byte chunks per row
    for (int i = tid; i < kBlockN * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const bool in = n0 + r < a.nk;
      const long long row = in ? n0 + r : 0;
      ud::cp_async16(ks + r * RS + c, K + row * a.c + c, in ? 16 : 0);
      ud::cp_async16(vs + r * RS + c, V + row * a.c + c, in ? 16 : 0);
    }
    ud::cp_async_commit();
  };

  const int r0 = blockIdx.x * kBlockM + warp * 16 + g;  // this lane's rows r0, r1
  const int r1 = r0 + 8;
  const bool ok0 = r0 < a.nq, ok1 = r1 < a.nq;

  uint32_t qf[NH][D / 16][4];
  float qz[NH][2];  // q[r, 0] of each head: M9's p
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = hh * D + kk * 16 + 2 * t;
      qf[hh][kk][0] = ok0 ? *reinterpret_cast<const uint32_t*>(Q + r0 * a.c + c) : 0u;
      qf[hh][kk][1] = ok1 ? *reinterpret_cast<const uint32_t*>(Q + r1 * a.c + c) : 0u;
      qf[hh][kk][2] = ok0 ? *reinterpret_cast<const uint32_t*>(Q + r0 * a.c + c + 8) : 0u;
      qf[hh][kk][3] = ok1 ? *reinterpret_cast<const uint32_t*>(Q + r1 * a.c + c + 8) : 0u;
    }
    qz[hh][0] = ok0 ? ud::to_float(Q[r0 * a.c + hh * D]) : 0.f;
    qz[hh][1] = ok1 ? ud::to_float(Q[r1 * a.c + hh * D]) : 0.f;
  }

  float o[NH][D / 8][4];
  float m[NH][2], l[NH][2];  // row max (log2 domain for M1/M2, natural for M6), partial row sums
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) {
#pragma unroll
    for (int i = 0; i < D / 8; ++i) o[hh][i][0] = o[hh][i][1] = o[hh][i][2] = o[hh][i][3] = 0.f;
    m[hh][0] = m[hh][1] = -INFINITY;
    l[hh][0] = l[hh][1] = 0.f;
  }

  // M8 stores the scores of keys 0..D-1, so it walks at least those tiles
  // (keys past Nk load as zero rows and score 0, as the harness pads them)
  const int ntiles = max((a.nk + kBlockN - 1) / kBlockN, F == kM8 ? (D + kBlockN - 1) / kBlockN : 0);
  constexpr int kPasses = P::kTwoPass ? 2 : 1;
  for (int pass = 0; pass < kPasses; ++pass) {
    const bool max_pass = P::kTwoPass && pass == 0;
    issue(0, 0);
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

#pragma unroll
      for (int hh = 0; hh < NH; ++hh) {
        // S = Q K^T for this warp's 16 rows x 64 keys of head hh
        float s[kBlockN / 8][4];
#pragma unroll
        for (int j = 0; j < kBlockN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        if constexpr (P::kQK) {
#pragma unroll
          for (int jp = 0; jp < kBlockN / 16; ++jp) {
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
              uint32_t kb[4];
              ud::ldmatrix_x4(kb, ks + (16 * jp + (lane & 7) + ((lane >> 4) << 3)) * RS + hh * D + kk * 16 + ((lane >> 3) & 1) * 8);
              ud::mma_bf16_16816(s[2 * jp], qf[hh][kk], kb[0], kb[1]);
              ud::mma_bf16_16816(s[2 * jp + 1], qf[hh][kk], kb[2], kb[3]);
            }
          }
        }

        if constexpr (F == kM8) {
          // out = s[:, :D]: the scores of keys 0..D-1
#pragma unroll
          for (int j = 0; j < kBlockN / 8; ++j) {
            const int key = n0 + 8 * j + 2 * t;
            if (key >= D) continue;
            if (ok0) *reinterpret_cast<uint32_t*>(O + r0 * a.c + hh * D + key) = ud::pack_bf16(s[j][0], s[j][1]);
            if (ok1) *reinterpret_cast<uint32_t*>(O + r1 * a.c + hh * D + key) = ud::pack_bf16(s[j][2], s[j][3]);
          }
          continue;
        }

        if constexpr (P::kMask) {
#pragma unroll
          for (int j = 0; j < kBlockN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float x = P::kClamp ? fminf(s[j][e], 80.f) : s[j][e];
              s[j][e] = n0 + 8 * j + 2 * t + (e & 1) < a.nk ? x : kMasked;
            }
        }

        if (max_pass) {  // M6, first pass: the full row max
#pragma unroll
          for (int j = 0; j < kBlockN / 8; ++j) {
            m[hh][0] = fmaxf(m[hh][0], fmaxf(s[j][0], s[j][1]));
            m[hh][1] = fmaxf(m[hh][1], fmaxf(s[j][2], s[j][3]));
          }
          continue;
        }

        if constexpr (P::kOnlineMax) {
          // log2 domain; every tile holds key n0 < nk, so mx is finite
          float mx0 = m[hh][0], mx1 = m[hh][1];
#pragma unroll
          for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] *= kLog2e;
            mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
            mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
          }
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
          const float al0 = exp2f(m[hh][0] - mx0), al1 = exp2f(m[hh][1] - mx1);
          m[hh][0] = mx0;
          m[hh][1] = mx1;
          l[hh][0] *= al0;
          l[hh][1] *= al1;
#pragma unroll
          for (int i = 0; i < D / 8; ++i) {
            o[hh][i][0] *= al0;
            o[hh][i][1] *= al0;
            o[hh][i][2] *= al1;
            o[hh][i][3] *= al1;
          }
        }

        // P, packed as the A fragments of the P V steps; l from p32 or bf16(p)
        uint32_t pf[kBlockN / 16][4];
#pragma unroll
        for (int j = 0; j < kBlockN / 8; ++j) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = s[j][e], mrow = m[hh][e >> 1];
            if constexpr (F == kM9) p[e] = qz[hh][e >> 1];
            else if constexpr (F == kM7) p[e] = x;
            else if constexpr (F == kM6) p[e] = x - mrow;
            else if constexpr (P::kOnlineMax) p[e] = exp2f(x - mrow);
            else p[e] = exp2f(x * kLog2e);  // M3-M5: no shift
            (void)mrow;
            if constexpr (P::kNormalise) l[hh][e >> 1] += P::kLFromBf16 ? ud::round_to<bf16>(p[e]) : p[e];
          }
          pf[j / 2][(j & 1) * 2 + 0] = ud::pack_bf16(p[0], p[1]);
          pf[j / 2][(j & 1) * 2 + 1] = ud::pack_bf16(p[2], p[3]);
        }

        // O += P V; ldmatrix.trans turns row-major V into b0, b1 of two
        // neighbouring 8-column tiles of the head
#pragma unroll
        for (int ip = 0; ip < D / 16; ++ip) {
#pragma unroll
          for (int kk = 0; kk < kBlockN / 16; ++kk) {
            uint32_t vb[4];
            ud::ldmatrix_x4_trans(vb, vs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * RS + hh * D + 16 * ip + (lane >> 4) * 8);
            ud::mma_bf16_16816(o[hh][2 * ip], pf[kk], vb[0], vb[1]);
            ud::mma_bf16_16816(o[hh][2 * ip + 1], pf[kk], vb[2], vb[3]);
          }
        }
      }
      __syncthreads();  // this stage is free for the copy two tiles ahead
    }
    if (max_pass) {
#pragma unroll
      for (int hh = 0; hh < NH; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          m[hh][e] = fmaxf(m[hh][e], __shfl_xor_sync(0xffffffffu, m[hh][e], 1));
          m[hh][e] = fmaxf(m[hh][e], __shfl_xor_sync(0xffffffffu, m[hh][e], 2));
        }
    }
  }

  if constexpr (P::kPV) {
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      float div0 = 1.f, div1 = 1.f;
      if constexpr (P::kNormalise) {
        float l0 = l[hh][0], l1 = l[hh][1];
        l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
        l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
        div0 = fmaxf(l0, 1e-30f);
        div1 = fmaxf(l1, 1e-30f);
      }
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const int c = hh * D + 8 * i + 2 * t;
        if (ok0)
          *reinterpret_cast<uint32_t*>(O + r0 * a.c + c) = ud::pack_bf16(o[hh][i][0] / div0, o[hh][i][1] / div0);
        if (ok1)
          *reinterpret_cast<uint32_t*>(O + r1 * a.c + c) = ud::pack_bf16(o[hh][i][2] / div1, o[hh][i][3] / div1);
      }
    }
  }
}

template <int F, int D, int NH>
cudaError_t launch(const AbArgs& a, int batch, int heads, cudaStream_t stream) {
  constexpr int smem = ab_smem_bytes<D, NH>();
  cudaError_t e = cudaFuncSetAttribute(ab_fwd<F, D, NH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.nq + kBlockM - 1) / kBlockM, heads / NH, batch);
  ab_fwd<F, D, NH><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_family(int family, const AbArgs& a, int batch, int heads, cudaStream_t s) {
  switch (family) {
    case kM1: return launch<kM1, D, 1>(a, batch, heads, s);
    case kM2: return launch<kM2, D, 1>(a, batch, heads, s);
    case kM3: return launch<kM3, D, 1>(a, batch, heads, s);
    case kM4: return launch<kM4, D, 1>(a, batch, heads, s);
    case kM5: return launch<kM5, D, 1>(a, batch, heads, s);
    case kM6: return launch<kM6, D, 1>(a, batch, heads, s);
    case kM7: return launch<kM7, D, 1>(a, batch, heads, s);
    case kM8: return launch<kM8, D, 1>(a, batch, heads, s);
    case kM9: return launch<kM9, D, 1>(a, batch, heads, s);
    default: return cudaErrorInvalidValue;
  }
}

bool valid_shape(int batch, int heads, int nq, int nk) {
  return batch >= 1 && batch <= 65535 && heads >= 1 && heads <= 65535 && nq >= 1 && nk >= 1;
}

}  // namespace

// K6 on the mma.sync body: family 1..9 (M1..M9) on contiguous bf16
// (B, N, heads * head_dim) tensors, q pre-scaled; head_dim 32 or 64.
extern "C" int ud_attention_ab_fwd(const void* q, const void* k, const void* v, void* o, int batch,
                                   int heads, int nq, int nk, int head_dim, int family, void* stream) {
  if (!valid_shape(batch, heads, nq, nk)) return cudaErrorInvalidValue;
  const AbArgs a{q, k, v, o, nq, nk, heads * head_dim};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return launch_family<32>(family, a, batch, heads, s);
    case 64: return launch_family<64>(family, a, batch, heads, s);
    default: return cudaErrorInvalidValue;
  }
}

// K7 on the mma.sync body: head pairs of 64, l from p32 (M3) or from bf16 p
// (M4, l_on_mxu).
extern "C" int ud_attention_bd_fwd(const void* q, const void* k, const void* v, void* o, int batch,
                                   int heads, int nq, int nk, int l_from_bf16, void* stream) {
  if (!valid_shape(batch, heads, nq, nk) || heads % 2) return cudaErrorInvalidValue;
  const AbArgs a{q, k, v, o, nq, nk, heads * 64};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return l_from_bf16 ? launch<kM4, 64, 2>(a, batch, heads, s) : launch<kM3, 64, 2>(a, batch, heads, s);
}

// K6 on the Hopper body: family 1..9 (M1..M9) on bf16 (B, N, heads * 64)
// tensors with element strides (head h at column h * 64; q pre-scaled, so
// the body runs at scale 1). Needs what hopper::launch needs: 16-byte
// aligned bases, row and batch strides that are multiples of 8.
extern "C" int ud_attention_ab_hopper_fwd(const void* q, const void* k, const void* v, void* o, int batch,
                                          int heads, int nq, int nk, long long q_bs, long long q_rs,
                                          long long k_bs, long long k_rs, long long v_bs, long long v_rs,
                                          long long o_bs, long long o_rs, int family, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define UD_AB_HOPPER(F)                                                                                      \
  hopper::launch<F, 1, 3, 64>(q, k, v, o, batch, heads, nq, nk, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, \
                              hopper::kLog2e, s)
  switch (family) {
    case kM1: return UD_AB_HOPPER(kM1);
    case kM2: return UD_AB_HOPPER(kM2);
    case kM3: return UD_AB_HOPPER(kM3);
    case kM4: return UD_AB_HOPPER(kM4);
    case kM5: return UD_AB_HOPPER(kM5);
    case kM6: return UD_AB_HOPPER(kM6);
    case kM7: return UD_AB_HOPPER(kM7);
    case kM8: return UD_AB_HOPPER(kM8);
    case kM9: return UD_AB_HOPPER(kM9);
    default: return cudaErrorInvalidValue;
  }
#undef UD_AB_HOPPER
}

// K7 on the Hopper body: head pairs of 64 (an even head count), M3 or, with
// l_from_bf16, M4; the strides and needs of ud_attention_ab_hopper_fwd.
extern "C" int ud_attention_bd_hopper_fwd(const void* q, const void* k, const void* v, void* o, int batch,
                                          int heads, int nq, int nk, long long q_bs, long long q_rs,
                                          long long k_bs, long long k_rs, long long v_bs, long long v_rs,
                                          long long o_bs, long long o_rs, int l_from_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return l_from_bf16 ? hopper::launch<kM4, 2, kPairStages, 64>(q, k, v, o, batch, heads, nq, nk, q_bs, q_rs, k_bs,
                                                               k_rs, v_bs, v_rs, o_bs, o_rs, hopper::kLog2e, s)
                     : hopper::launch<kM3, 2, kPairStages, 64>(q, k, v, o, batch, heads, nq, nk, q_bs, q_rs, k_bs,
                                                               k_rs, v_bs, v_rs, o_bs, o_rs, hopper::kLog2e, s);
}
