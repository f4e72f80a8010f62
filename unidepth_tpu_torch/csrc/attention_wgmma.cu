// Flash attention forward for Hopper on wgmma and TMA: softmax(scale * q k^T) v
// per (batch, head), bf16 I/O, head dim 64.
//
// Replaces, for bf16 at D = 64 (every ViT preset the repo has), the TPU
// Pallas kernels of unidepth_tpu/ops/flash_attention.py that the encoder's
// self-attention and the V2 decoder's cross-attention run:
//   * K1, _flash_fwd_qkv / _packed_kernel (flash_attention_qkv): q, k, v are
//     the channel slices [0,C), [C,2C), [2C,3C) of the fused (B, N, 3C) QKV
//     projection, heads channel-major; output (B, N, C);
//   * K4, _flash_fwd_packed / _packed_kernel (flash_attention_packed): three
//     (B, N, H*D) tensors with any row and batch stride (the int8 path hands
//     it the strided channel views of one projection);
//   * K3, _flash_fwd / _flash_kernel (flash_attention): flat (BH, N, 64)
//     tensors, a map of BH batches of one head; Nq != Nk, and any number of
//     keys (the TPU kernel switches to a blocked online softmax past 4096;
//     this body streams every key tile through its online softmax anyway).
// fp32 I/O and the other head dims keep attention.cu's mma.sync body.
//
// What bounds it on the H100: operations. At the ViT-L serving shape (B=8,
// N=1370, H=16, D=64) a call is 61.5 GFLOP against 45 MB of q/k/v/o, 0.062
// ms at the dense bf16 peak. At D = 64 the softmax's 2^x costs the SM's 16
// SFU lanes as many cycles as the two products cost its tensor cores, so
// the design keeps the tensor cores and the SFUs busy at once:
//   * a work tile is 128 queries of one (batch, head); two consumer
//     warpgroups take 64 query rows each, and one producer warpgroup, of
//     which one thread issues TMA copies (setmaxnreg moves registers from
//     the producer, 24, to the consumers, 240);
//   * persistent grid: one block an SM walks the work tiles (tile index
//     blockIdx.x + i * gridDim.x, q tiles of one head adjacent so its K and V
//     stay in L2), so the next tile's q and first K/V tiles load while the
//     current one finishes, instead of a block's start and end being exposed
//     ~11 times an SM;
//   * q is loaded once per work tile into its own buffer ("full" and "empty"
//     mbarriers); K and V stream in 128-key tiles through a three-stage ring
//     that runs on across work tiles, each stage with "full" mbarriers that
//     TMA completes (K and V apart, so Q K^T starts before V lands) and an
//     "empty" mbarrier that all 256 consumer threads arrive on, instead of
//     a __syncthreads per tile;
//   * each tensor is a 3-D TMA map (channels, rows N, batch B) with its real
//     strides, the head chosen by the channel coordinate h * 64: rows past
//     N fall out of bounds within their own batch and TMA fills them with
//     0, and the 128-byte swizzle it writes is the layout wgmma reads;
//   * S = Q K^T is wgmma m64n128k16 with both operands in shared memory;
//     O += P V is wgmma m64n64k16 with P in registers (the fp32 S
//     accumulator, rounded to bf16, is the A fragment, as the TPU kernel
//     casts p to v's type) and V MN-major through the transpose bit;
//   * each warpgroup runs Q K^T, softmax, P V in turn; the two warpgroups
//     drift apart, so one's softmax runs beside the other's products
//     (issuing Q K^T of tile j before P V of tile j-1, or handing the tensor
//     cores from one warpgroup to the other by named barriers, measured
//     slower on this card: PERF.md, section 6);
//   * softmax on the accumulators: online row max of the raw scores, scale
//     * log2(e) folded into one FFMA before ex2.approx, row max and row sum
//     in fp32, reduced across the 4 lanes of a row; keys >= Nk are masked on
//     the last key tile only. The max-free exp(min(s, 80)) of the TPU
//     serving kernel is not carried over: the row max makes the kernel
//     exact for any logits;
//   * epilogue: O / l rounded to bf16 into the warpgroup's 64 rows of an
//     output buffer in the 128-byte swizzle, then one TMA store that clips
//     rows >= Nq.
// At the serving shape: 11 x 16 x 8 = 1408 work tiles on 132 blocks (10.7
// each, so 11 rounds); one block an SM: 384 threads at 168 registers (ptxas,
// no spills; 240 for the consumers after setmaxnreg) and 133,120 bytes of
// shared memory.

#include <math.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;         // head dim: one 128-byte swizzled row
constexpr int kBlockM = 128;   // queries per work tile
constexpr int kBlockN = 128;   // keys per K/V tile
constexpr int kStages = 3;     // K/V ring depth
constexpr int kConsumers = 2;  // consumer warpgroups, 64 query rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr uint32_t kTileBytes = kBlockN * kD * 2;
constexpr uint32_t kQBytes = kBlockM * kD * 2;
constexpr float kLog2e = 1.4426950408889634f;

struct alignas(1024) Smem {
  bf16 q[kBlockM * kD];
  bf16 o[kBlockM * kD];  // output staging, 64 rows per consumer
  bf16 k[kStages][kBlockN * kD];
  bf16 v[kStages][kBlockN * kD];
  uint64_t q_full, q_empty;
  uint64_t k_full[kStages];
  uint64_t v_full[kStages];
  uint64_t empty[kStages];
};
constexpr int kSmemBytes = sizeof(Smem) + 1024;  // + room to align the base to 1024

// S(64 x 128, f32) (+)= A(64 x 16) B(16 x 128)^T, A and B K-major in shared
// memory (128-byte swizzle). Accumulator element i of thread (warp w, lane
// 4g + t): row 16w + g + 8 * ((i / 2) & 1), column 8 * (i / 4) + 2t + (i & 1).
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O(64 x 64, f32) += A(64 x 16, bf16, registers) B(16 x 64), B MN-major in
// shared memory (128-byte swizzle; the transpose bit set). A's fragment
// (lane 4g + t of warp w): a0 = A[16w+g][2t..2t+1], a1 = A[16w+g+8][2t..],
// a2 = A[16w+g][2t+8..], a3 = A[16w+g+8][2t+8..], as mma.sync m16n8k16's.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

struct Work {
  int q0, h, b;
};

__device__ __forceinline__ Work work_tile(int tile, int q_tiles, int heads) {
  return {(tile % q_tiles) * kBlockM, (tile / q_tiles) % heads, tile / (q_tiles * heads)};
}

__global__ void __launch_bounds__(kThreads, 1)
    attn_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to, int nq,
                   int nk, int heads, int tiles, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on that grid
  const uint32_t pad = (1024u - (ud::smem_u32(smem_raw) & 1023u)) & 1023u;
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + pad);

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int q_tiles = (nq + kBlockM - 1) / kBlockM;
  const int ntiles = (nk + kBlockN - 1) / kBlockN;  // K/V tiles per work tile

  if (threadIdx.x == 0) {
    ud::mbar_init(&sm.q_full, 1);
    ud::mbar_init(&sm.q_empty, 128 * kConsumers);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      ud::mbar_init(&sm.k_full[st], 1);
      ud::mbar_init(&sm.v_full[st], 1);
      ud::mbar_init(&sm.empty[st], 128 * kConsumers);
    }
    ud::fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread keeps q and the K/V ring full ----
    ud::setmaxnreg_dec<24>();
    if (tid == 0) {
      int ring = 0;  // K/V tiles issued so far, across work tiles
      int round = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++round) {
        const Work w = work_tile(tile, q_tiles, heads);
        ud::mbar_wait(&sm.q_empty, (round & 1) ^ 1);  // the first round passes at once
        ud::mbar_arrive_expect_tx(&sm.q_full, kQBytes);
        ud::tma_load_3d(sm.q, &tq, &sm.q_full, w.h * kD, w.q0, w.b);
        for (int it = 0; it < ntiles; ++it, ++ring) {
          const int st = ring % kStages;
          ud::mbar_wait(&sm.empty[st], ((ring / kStages) & 1) ^ 1);
          ud::mbar_arrive_expect_tx(&sm.k_full[st], kTileBytes);
          ud::tma_load_3d(sm.k[st], &tk, &sm.k_full[st], w.h * kD, it * kBlockN, w.b);
          ud::mbar_arrive_expect_tx(&sm.v_full[st], kTileBytes);
          ud::tma_load_3d(sm.v[st], &tv, &sm.v_full[st], w.h * kD, it * kBlockN, w.b);
        }
      }
    }
  } else {
    // ---- consumer warpgroup `wg`: query rows q0 + 64 wg .. + 63 of each work tile ----
    ud::setmaxnreg_inc<240>();
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const uint64_t qdesc = ud::wgmma_desc_sw128(sm.q + wg * 64 * kD);
    bf16* os = sm.o + wg * 64 * kD;
    float s[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
    int ring = 0;
    int round = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++round) {
      const Work w = work_tile(tile, q_tiles, heads);
      float o[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
      float m0 = -INFINITY, m1 = -INFINITY;  // running max of the raw scores, rows g and g + 8
      float l0 = 0.f, l1 = 0.f;              // this lane's partial row sums

      ud::mbar_wait(&sm.q_full, round & 1);
      for (int it = 0; it < ntiles; ++it, ++ring) {
        const int st = ring % kStages;
        const uint32_t parity = (ring / kStages) & 1;

        // S = Q K^T: four 16-deep steps, each 32 bytes further along the swizzled rows
        ud::mbar_wait(&sm.k_full[st], parity);
        const uint64_t kdesc = ud::wgmma_desc_sw128(sm.k[st]);
        ud::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) wgmma_m64n128k16_ss(s, qdesc + 2 * kk, kdesc + 2 * kk, kk);
        ud::wgmma_commit();
        ud::wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 64; ++i) ud::reg_fence(s[i]);
        if (it == ntiles - 1) ud::mbar_arrive(&sm.q_empty);  // the next q may load

        if (it == ntiles - 1 && nk % kBlockN) {  // keys past nk exist only in a ragged last tile
          const int n0 = it * kBlockN;
#pragma unroll
          for (int j = 0; j < kBlockN / 8; ++j) {
            const int col = n0 + 8 * j + 2 * t;
            if (col >= nk) s[4 * j] = s[4 * j + 2] = -INFINITY;
            if (col + 1 >= nk) s[4 * j + 1] = s[4 * j + 3] = -INFINITY;
          }
        }
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int j = 0; j < kBlockN / 8; ++j) {
          mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        // every tile holds key n0 < nk, so mx is finite; the first tile's
        // alpha is 2^-inf = 0 against o = l = 0
        const float al0 = ud::exp2_approx((m0 - mx0) * scale_log2);
        const float al1 = ud::exp2_approx((m1 - mx1) * scale_log2);
        m0 = mx0;
        m1 = mx1;
        const float ms0 = mx0 * scale_log2, ms1 = mx1 * scale_log2;
        l0 *= al0;
        l1 *= al1;
#pragma unroll
        for (int j = 0; j < kD / 8; ++j) {
          o[4 * j] *= al0;
          o[4 * j + 1] *= al0;
          o[4 * j + 2] *= al1;
          o[4 * j + 3] *= al1;
        }

        // P = 2^(scale log2(e) (s - m)), packed to bf16: the accumulator
        // columns of two neighbouring 8-key chunks are one 16-key A fragment
        uint32_t p[kBlockN / 16][4];
#pragma unroll
        for (int j = 0; j < kBlockN / 8; ++j) {
          const float p0 = ud::exp2_approx(fmaf(s[4 * j], scale_log2, -ms0));
          const float p1 = ud::exp2_approx(fmaf(s[4 * j + 1], scale_log2, -ms0));
          const float p2 = ud::exp2_approx(fmaf(s[4 * j + 2], scale_log2, -ms1));
          const float p3 = ud::exp2_approx(fmaf(s[4 * j + 3], scale_log2, -ms1));
          l0 += p0 + p1;
          l1 += p2 + p3;
          p[j / 2][(j & 1) * 2] = ud::pack_bf16(p0, p1);
          p[j / 2][(j & 1) * 2 + 1] = ud::pack_bf16(p2, p3);
        }

        // O += P V: eight 16-key steps, each 16 swizzled rows (2048 bytes) further
        ud::mbar_wait(&sm.v_full[st], parity);
        const uint64_t vdesc = ud::wgmma_desc_sw128(sm.v[st]);
        ud::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlockN / 16; ++kk) wgmma_m64n64k16_rs(o, p[kk], vdesc + kk * (2048 >> 4));
        ud::wgmma_commit();
        ud::wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 32; ++i) ud::reg_fence(o[i]);
#pragma unroll
        for (int kk = 0; kk < kBlockN / 16; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) ud::reg_fence(p[kk][i]);
        ud::mbar_arrive(&sm.empty[st]);  // this stage may be refilled
      }

      // O / l -> bf16 into this warpgroup's rows of the output buffer, in the
      // 128-byte swizzle the output map's TMA store reads, once the previous
      // tile's store from these rows has read them
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float inv0 = 1.f / l0, inv1 = 1.f / l1;  // l >= 1: the row max contributes 2^0
      if (tid == 0) ud::tma_store_wait_read();
      ud::named_barrier_sync(1 + wg, 128);
      unsigned char* ob = reinterpret_cast<unsigned char*>(os);
      const int r0 = warp * 16 + g;  // r0 % 8 == (r0 + 8) % 8 == g
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        const int off = ((j ^ g) << 4) + 4 * t;
        *reinterpret_cast<uint32_t*>(ob + r0 * 128 + off) = ud::pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
        *reinterpret_cast<uint32_t*>(ob + (r0 + 8) * 128 + off) =
            ud::pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
      }
      ud::fence_proxy_async();
      ud::named_barrier_sync(1 + wg, 128);
      if (tid == 0 && w.q0 + 64 * wg < nq) {
        ud::tma_store_3d(&to, os, w.h * kD, w.q0 + 64 * wg, w.b);
        ud::tma_store_commit();
      }
    }
    if (tid == 0) ud::tma_store_wait_read();  // shared memory stays valid until read
  }
}

}  // namespace

// K1's and K4's bf16 entry at head dim 64: the same arguments as
// ud_attention_fwd (element strides; head h at column h * 64 of each row).
// Needs 16-byte aligned base pointers, row and batch strides that are
// multiples of 8 elements, rows that hold all heads, and scale > 0 (the
// row max is taken on the raw scores). The tensor maps are built here, on
// the host, for every call.
extern "C" int ud_attention_hopper_fwd(const void* q, const void* k, const void* v, void* o, int batch,
                                       int heads, int nq, int nk, int head_dim, long long q_bs,
                                       long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                                       long long v_rs, long long o_bs, long long o_rs, float scale,
                                       int dtype, void* stream) {
  if (dtype != ud::kBFloat16 || head_dim != kD) return cudaErrorInvalidValue;
  if (batch <= 0 || heads <= 0 || nq <= 0 || nk <= 0) return cudaErrorInvalidValue;
  if (!(scale > 0.f) || !isfinite(scale)) return cudaErrorInvalidValue;
  const long long c = static_cast<long long>(heads) * kD;
  const long long tiles = static_cast<long long>((nq + kBlockM - 1) / kBlockM) * heads * batch;
  if (tiles > 0x7fffffff || c > 0x7fffffff) return cudaErrorInvalidValue;
  if (q_rs < c || k_rs < c || v_rs < c || o_rs < c) return cudaErrorInvalidValue;
  if ((q_bs | q_rs | k_bs | k_rs | v_bs | v_rs | o_bs | o_rs) % 8) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
       reinterpret_cast<uintptr_t>(o)) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, to;
  if (!ud::make_map_sw128(&tq, q, int(c), nq, batch, q_rs, q_bs, kBlockM) ||
      !ud::make_map_sw128(&tk, k, int(c), nk, batch, k_rs, k_bs, kBlockN) ||
      !ud::make_map_sw128(&tv, v, int(c), nk, batch, v_rs, v_bs, kBlockN) ||
      !ud::make_map_sw128(&to, o, int(c), nq, batch, o_rs, o_bs, 64))
    return cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) e = cudaFuncSetAttribute(attn_fwd_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return e;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  attn_fwd_wgmma<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, to, nq, nk, heads, static_cast<int>(tiles), scale * kLog2e);
  return cudaGetLastError();
}
