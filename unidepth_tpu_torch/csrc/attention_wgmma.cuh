// The Hopper attention body on wgmma and TMA, bf16 I/O, templated on a
// softmax policy, a work-tile mapping and the head dim D (32, 48 or 64).
// Two sources instantiate it:
//   * attention_wgmma.cu: the exact softmax of K1, K3 and K4 (the model's
//     attention; kExact, one head a work tile) at D = 64, and K3's at D =
//     32 and 48 (one head a map);
//   * attention_ab.cu: the A/B families M1-M9 of K6 (one head a work tile)
//     and K7's head pairs (M3 or M4, two heads a work tile).
//
// The design (measured in PERF.md, section 6):
//   * a work tile is 128 queries of one (batch, head), or 64 queries of one
//     head pair; two consumer warpgroups take 64 query rows each (of the one
//     head, or of one head of the pair each), and one producer warpgroup, of
//     which one thread issues TMA copies (setmaxnreg moves registers from
//     the producer, 24, to the consumers, 240);
//   * persistent grid: one block an SM walks the work tiles (tile index
//     blockIdx.x + i * gridDim.x, q tiles of one head adjacent so its K and V
//     stay in L2), so the next tile's q and first K/V tiles load while the
//     current one finishes, instead of a block's start and end being exposed
//     ~11 times an SM;
//   * q is loaded once per work tile into its own buffer ("full" and "empty"
//     mbarriers); K and V stream in 128-key tiles through a ring of stages
//     that runs on across work tiles, each stage with "full" mbarriers that
//     TMA completes (K and V apart, so Q K^T starts before V lands) and an
//     "empty" mbarrier that all 256 consumer threads arrive on, instead of
//     a __syncthreads per tile. A family that needs no K (M9) or no V (M8,
//     and M6's first pass) gets a plain arrival on that "full" barrier in
//     place of the copy, so every stage still completes one phase of each
//     barrier per tile and the consumers' parities stay in step;
//   * each tensor is a 3-D TMA map (channels, rows N, batch B) with its real
//     strides, the head chosen by the channel coordinate h * 64: rows past
//     N fall out of bounds within their own batch and TMA fills them with
//     0, and the 128-byte swizzle it writes is the layout wgmma reads;
//   * S = Q K^T is wgmma m64n128k16 with both operands in shared memory,
//     D / 16 steps deep;
//     O += P V is wgmma m64n{D}k16 with P in registers (the fp32 S
//     accumulator, rounded to bf16, is the A fragment, as the TPU kernel
//     casts p to v's type) and V MN-major through the transpose bit;
//   * each warpgroup runs Q K^T, softmax, P V in turn; the two warpgroups
//     drift apart, so one's softmax runs beside the other's products
//     (issuing Q K^T of tile j before P V of tile j-1, or handing the tensor
//     cores from one warpgroup to the other by named barriers, measured
//     slower on this card);
//   * exact softmax on the accumulators: online row max of the raw scores,
//     scale * log2(e) folded into one FFMA before ex2.approx, row max and
//     row sum in fp32, reduced across the 4 lanes of a row; keys >= Nk are
//     masked on the last key tile only. The max-free exp(min(s, 80)) of the
//     TPU serving kernel is not carried over there: the row max makes the
//     kernel exact for any logits;
//   * epilogue: O / l rounded to bf16 into the warpgroup's 64 rows of an
//     output buffer in the 128-byte swizzle, then one TMA store that clips
//     rows >= Nq;
//   * D = 32 and 48 keep every shared-memory layout and descriptor of D =
//     64: a row is still one 128-byte swizzled row of 64 channels. The
//     map's channel extent is D (one head a map), so TMA fills channels
//     D..63 of each loaded row with zeros and the store through the same
//     map clips them; the products only read the first D channels. A map
//     of several heads at D < 64 would load the next head there and store
//     over it, so launch() takes D < 64 for one head only.
// The products are asm volatile, so a family whose product result is dead
// (M8's later tiles) still runs it, and the time it is priced at is real.

#pragma once

#include <math.h>

#include "common.cuh"

namespace {

// The softmax a body computes. kExact is the model's attention (K1/K3/K4);
// M1-M9 are the A/B families of the harness (ops/kernel_ab.py), on q that
// the caller pre-scaled:
//   M1 row max; l = sum p32            M2 row max; l = sum bf16(p)
//   M3 exp(min(s, 80)); l = sum p32    M4 exp(min(s, 80)); l = sum bf16(p)
//   M5 exp(s), no shift, no clamp      M6 p = s - rowmax (no exp); l = sum p32
//   M7 p = bf16(s): no mask, no normalisation
//   M8 out = s[:, :D] (QK^T alone)     M9 p = q[:, 0] for every key (P V alone)
// The families mask keys past N with -1e30 and divide by max(l, 1e-30).
enum Family : int { kExact = 0, kM1, kM2, kM3, kM4, kM5, kM6, kM7, kM8, kM9 };

template <int F>
struct Policy {
  static constexpr bool kOnlineMax = F == kExact || F == kM1 || F == kM2;
  static constexpr bool kTwoPass = F == kM6;
  static constexpr bool kClamp = F == kM3 || F == kM4;
  static constexpr bool kMask = F <= kM6;
  static constexpr bool kLFromBf16 = F == kM2 || F == kM4;
  static constexpr bool kNormalise = F <= kM6;
  static constexpr bool kQK = F != kM9;
  static constexpr bool kPV = F != kM8;
  static constexpr float kMasked = F == kExact ? -INFINITY : -1e30f;  // the harness's _NEG_INF
};

namespace hopper {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;         // channels a shared-memory row holds: one 128-byte swizzled row
constexpr int kQRows = 128;    // q rows a work tile holds: 128 queries, or 64 queries x 2 heads
constexpr int kBlockN = 128;   // keys per K/V tile
constexpr int kConsumers = 2;  // consumer warpgroups, 64 query rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr uint32_t kQBytes = kQRows * kD * 2;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSmem = 232448;  // what one block may use on the H100

// NH heads a work tile (1, or 2 for a head pair); each K/V stage holds NH
// 64-channel boxes of 128 keys, one per head
template <int NH, int Stages>
struct alignas(1024) Smem {
  bf16 q[kQRows * kD];
  bf16 o[kQRows * kD];  // output staging, 64 rows per consumer
  bf16 k[Stages][NH * kBlockN * kD];
  bf16 v[Stages][NH * kBlockN * kD];
  uint64_t q_full, q_empty;
  uint64_t k_full[Stages];
  uint64_t v_full[Stages];
  uint64_t empty[Stages];
};
template <int NH, int Stages>
constexpr int smem_bytes() {
  return sizeof(Smem<NH, Stages>) + 1024;  // + room to align the base to 1024
}

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

// The same at head dims 48 and 32 (m64n48k16, m64n32k16): the first D
// columns of the swizzled V rows.
__device__ __forceinline__ void wgmma_m64n48k16_rs(float (&d)[24], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 64) wgmma_m64n64k16_rs(d, a, db);
  else if constexpr (D == 48) wgmma_m64n48k16_rs(d, a, db);
  else wgmma_m64n32k16_rs(d, a, db);
}

struct Work {
  int q0, h, b;  // first query row, head (or head pair), batch
};

template <int BlockM>
__device__ __forceinline__ Work work_tile(int tile, int q_tiles, int groups) {
  return {(tile % q_tiles) * BlockM, (tile / q_tiles) % groups, tile / (q_tiles * groups)};
}

template <int F, int NH, int Stages, int D>
__global__ void __launch_bounds__(kThreads, 1)
    attn_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to, int nq,
                   int nk, int heads, int tiles, float scale_log2) {
  using P = Policy<F>;
  static_assert(NH == 1 || NH == kConsumers, "one head a work tile, or one head a consumer");
  static_assert(D == 32 || D == 48 || D == 64, "head dim 32, 48 or 64");
  constexpr int kBlockM = kQRows / NH;  // queries per work tile
  constexpr uint32_t kTileBytes = NH * kBlockN * kD * 2;
  constexpr int kPasses = P::kTwoPass ? 2 : 1;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on that grid
  const uint32_t pad = (1024u - (ud::smem_u32(smem_raw) & 1023u)) & 1023u;
  Smem<NH, Stages>& sm = *reinterpret_cast<Smem<NH, Stages>*>(smem_raw + pad);

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int q_tiles = (nq + kBlockM - 1) / kBlockM;
  const int groups = heads / NH;
  const int ntiles = (nk + kBlockN - 1) / kBlockN;  // K/V tiles per work tile and pass

  if (threadIdx.x == 0) {
    ud::mbar_init(&sm.q_full, 1);
    ud::mbar_init(&sm.q_empty, 128 * kConsumers);
#pragma unroll
    for (int st = 0; st < Stages; ++st) {
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
        const Work w = work_tile<kBlockM>(tile, q_tiles, groups);
        ud::mbar_wait(&sm.q_empty, (round & 1) ^ 1);  // the first round passes at once
        ud::mbar_arrive_expect_tx(&sm.q_full, kQBytes);
#pragma unroll
        for (int hh = 0; hh < NH; ++hh)
          ud::tma_load_3d(sm.q + hh * kBlockM * kD, &tq, &sm.q_full, (w.h * NH + hh) * D, w.q0, w.b);
        for (int pass = 0; pass < kPasses; ++pass) {
          const bool load_v = P::kPV && pass == kPasses - 1;  // M6 streams K alone in its first pass
          for (int it = 0; it < ntiles; ++it, ++ring) {
            const int st = ring % Stages;
            ud::mbar_wait(&sm.empty[st], ((ring / Stages) & 1) ^ 1);
            if (P::kQK) {
              ud::mbar_arrive_expect_tx(&sm.k_full[st], kTileBytes);
#pragma unroll
              for (int hh = 0; hh < NH; ++hh)
                ud::tma_load_3d(sm.k[st] + hh * kBlockN * kD, &tk, &sm.k_full[st], (w.h * NH + hh) * D,
                                it * kBlockN, w.b);
            } else {
              ud::mbar_arrive(&sm.k_full[st]);
            }
            if (load_v) {
              ud::mbar_arrive_expect_tx(&sm.v_full[st], kTileBytes);
#pragma unroll
              for (int hh = 0; hh < NH; ++hh)
                ud::tma_load_3d(sm.v[st] + hh * kBlockN * kD, &tv, &sm.v_full[st], (w.h * NH + hh) * D,
                                it * kBlockN, w.b);
            } else {
              ud::mbar_arrive(&sm.v_full[st]);
            }
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroup `wg`: 64 query rows of each work tile ----
    ud::setmaxnreg_inc<240>();
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const uint64_t qdesc = ud::wgmma_desc_sw128(sm.q + wg * 64 * kD);
    bf16* os = sm.o + wg * 64 * kD;
    const int row0 = NH == 1 ? 64 * wg : 0;         // this warpgroup's first row in the work tile
    const int kv_off = NH == 1 ? 0 : wg * kBlockN * kD;  // its head's box in a K/V stage
    float s[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
    int ring = 0;
    int round = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++round) {
      const Work w = work_tile<kBlockM>(tile, q_tiles, groups);
      const int head = NH == 1 ? w.h : w.h * NH + wg;
      float o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      float m0 = -INFINITY, m1 = -INFINITY;  // running max of the raw scores, rows g and g + 8
      float l0 = 0.f, l1 = 0.f;              // this lane's partial row sums

      ud::mbar_wait(&sm.q_full, round & 1);
      uint32_t pz0 = 0, pz1 = 0;  // M9: q[r, 0] of rows g and g + 8, as a bf16 pair
      if constexpr (F == kM9) {
        // column 0 of swizzled row r is 16-byte chunk r % 8; warp rows r and r + 8 share g
        const unsigned char* qb = reinterpret_cast<const unsigned char*>(sm.q + wg * 64 * kD);
        const int r = warp * 16 + g;
        const bf16 z0 = *reinterpret_cast<const bf16*>(qb + r * 128 + (g << 4));
        const bf16 z1 = *reinterpret_cast<const bf16*>(qb + (r + 8) * 128 + (g << 4));
        pz0 = ud::pack_bf16(__bfloat162float(z0), __bfloat162float(z0));
        pz1 = ud::pack_bf16(__bfloat162float(z1), __bfloat162float(z1));
      }
      (void)pz0;
      (void)pz1;

      for (int pass = 0; pass < kPasses; ++pass) {
        const bool max_pass = P::kTwoPass && pass == 0;  // M6: the full row max before any p
        for (int it = 0; it < ntiles; ++it, ++ring) {
          const int st = ring % Stages;
          const uint32_t parity = (ring / Stages) & 1;

          if constexpr (P::kQK) {
            // S = Q K^T: D / 16 steps 16 deep, each 32 bytes further along the swizzled rows
            ud::mbar_wait(&sm.k_full[st], parity);
            const uint64_t kdesc = ud::wgmma_desc_sw128(sm.k[st] + kv_off);
            ud::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) wgmma_m64n128k16_ss(s, qdesc + 2 * kk, kdesc + 2 * kk, kk);
            ud::wgmma_commit();
            ud::wgmma_wait<0>();
#pragma unroll
            for (int i = 0; i < 64; ++i) ud::reg_fence(s[i]);
          }
          if (pass == kPasses - 1 && it == ntiles - 1) ud::mbar_arrive(&sm.q_empty);  // the next q may load

          if constexpr (F == kM8) {
            // out = s[:, :D]: the first tile's columns 0..D-1 have O's accumulator layout
            if (it == 0) {
#pragma unroll
              for (int i = 0; i < D / 2; ++i) o[i] = s[i];
            }
            ud::mbar_arrive(&sm.empty[st]);
            continue;
          }

          if constexpr (P::kClamp) {
#pragma unroll
            for (int i = 0; i < 64; ++i) s[i] = fminf(s[i], 80.f);
          }
          if constexpr (P::kMask) {
            if (it == ntiles - 1 && nk % kBlockN) {  // keys past nk exist only in a ragged last tile
              const int n0 = it * kBlockN;
#pragma unroll
              for (int j = 0; j < kBlockN / 8; ++j) {
                const int col = n0 + 8 * j + 2 * t;
                if (col >= nk) s[4 * j] = s[4 * j + 2] = P::kMasked;
                if (col + 1 >= nk) s[4 * j + 1] = s[4 * j + 3] = P::kMasked;
              }
            }
          }

          if (max_pass) {
#pragma unroll
            for (int j = 0; j < kBlockN / 8; ++j) {
              m0 = fmaxf(m0, fmaxf(s[4 * j], s[4 * j + 1]));
              m1 = fmaxf(m1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
            }
            ud::mbar_arrive(&sm.empty[st]);
            continue;
          }

          float ms0 = 0.f, ms1 = 0.f;  // the shift, in the exponent's units
          if constexpr (P::kOnlineMax) {
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
            ms0 = mx0 * scale_log2;
            ms1 = mx1 * scale_log2;
            l0 *= al0;
            l1 *= al1;
#pragma unroll
            for (int j = 0; j < D / 8; ++j) {
              o[4 * j] *= al0;
              o[4 * j + 1] *= al0;
              o[4 * j + 2] *= al1;
              o[4 * j + 3] *= al1;
            }
          }

          // P, packed to bf16: the accumulator columns of two neighbouring
          // 8-key chunks are one 16-key A fragment
          uint32_t p[kBlockN / 16][4];
#pragma unroll
          for (int j = 0; j < kBlockN / 8; ++j) {
            if constexpr (F == kM9) {
              p[j / 2][(j & 1) * 2] = pz0;
              p[j / 2][(j & 1) * 2 + 1] = pz1;
              continue;
            }
            float p0, p1, p2, p3;
            if constexpr (P::kOnlineMax) {  // 2^(scale log2(e) (s - m))
              p0 = ud::exp2_approx(fmaf(s[4 * j], scale_log2, -ms0));
              p1 = ud::exp2_approx(fmaf(s[4 * j + 1], scale_log2, -ms0));
              p2 = ud::exp2_approx(fmaf(s[4 * j + 2], scale_log2, -ms1));
              p3 = ud::exp2_approx(fmaf(s[4 * j + 3], scale_log2, -ms1));
            } else if constexpr (F == kM6) {  // s - rowmax, no exp
              p0 = s[4 * j] - m0;
              p1 = s[4 * j + 1] - m0;
              p2 = s[4 * j + 2] - m1;
              p3 = s[4 * j + 3] - m1;
            } else if constexpr (F == kM7) {  // bf16(s)
              p0 = s[4 * j];
              p1 = s[4 * j + 1];
              p2 = s[4 * j + 2];
              p3 = s[4 * j + 3];
            } else {  // M3-M5: no shift
              p0 = ud::exp2_approx(s[4 * j] * scale_log2);
              p1 = ud::exp2_approx(s[4 * j + 1] * scale_log2);
              p2 = ud::exp2_approx(s[4 * j + 2] * scale_log2);
              p3 = ud::exp2_approx(s[4 * j + 3] * scale_log2);
            }
            const uint32_t pg = ud::pack_bf16(p0, p1), pg8 = ud::pack_bf16(p2, p3);  // rows g, g + 8
            if constexpr (P::kLFromBf16) {
              // the bf16 values P V reads, unpacked on the integer pipe (a
              // bf16 is the high half of its fp32): a second rounding per
              // element would double the conversions, which share the
              // softmax's busiest pipe with ex2
              l0 += __uint_as_float(pg << 16) + __uint_as_float(pg & 0xffff0000u);
              l1 += __uint_as_float(pg8 << 16) + __uint_as_float(pg8 & 0xffff0000u);
            } else if constexpr (P::kNormalise) {
              l0 += p0 + p1;
              l1 += p2 + p3;
            }
            p[j / 2][(j & 1) * 2] = pg;
            p[j / 2][(j & 1) * 2 + 1] = pg8;
          }

          // O += P V: eight 16-key steps, each 16 swizzled rows (2048 bytes) further
          ud::mbar_wait(&sm.v_full[st], parity);
          const uint64_t vdesc = ud::wgmma_desc_sw128(sm.v[st] + kv_off);
          ud::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBlockN / 16; ++kk) wgmma_pv<D>(o, p[kk], vdesc + kk * (2048 >> 4));
          ud::wgmma_commit();
          ud::wgmma_wait<0>();
#pragma unroll
          for (int i = 0; i < D / 2; ++i) ud::reg_fence(o[i]);
#pragma unroll
          for (int kk = 0; kk < kBlockN / 16; ++kk)
#pragma unroll
            for (int i = 0; i < 4; ++i) ud::reg_fence(p[kk][i]);
          ud::mbar_arrive(&sm.empty[st]);  // this stage may be refilled
        }
        if (max_pass) {  // the row max of the whole row, over the 4 lanes that hold it
          m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
          m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
          m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
          m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
        }
      }

      // O / l -> bf16 into this warpgroup's rows of the output buffer, in the
      // 128-byte swizzle the output map's TMA store reads, once the previous
      // tile's store from these rows has read them
      float inv0 = 1.f, inv1 = 1.f;
      if constexpr (P::kNormalise) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
        l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
        if constexpr (F == kExact) {
          inv0 = 1.f / l0;  // l >= 1: the row max contributes 2^0
          inv1 = 1.f / l1;
        } else {
          inv0 = 1.f / fmaxf(l0, 1e-30f);
          inv1 = 1.f / fmaxf(l1, 1e-30f);
        }
      }
      if (tid == 0) ud::tma_store_wait_read();
      ud::named_barrier_sync(1 + wg, 128);
      unsigned char* ob = reinterpret_cast<unsigned char*>(os);
      const int r0 = warp * 16 + g;  // r0 % 8 == (r0 + 8) % 8 == g
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int off = ((j ^ g) << 4) + 4 * t;
        *reinterpret_cast<uint32_t*>(ob + r0 * 128 + off) = ud::pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
        *reinterpret_cast<uint32_t*>(ob + (r0 + 8) * 128 + off) =
            ud::pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
      }
      ud::fence_proxy_async();
      ud::named_barrier_sync(1 + wg, 128);
      if (tid == 0 && w.q0 + row0 < nq) {
        ud::tma_store_3d(&to, os, head * D, w.q0 + row0, w.b);
        ud::tma_store_commit();
      }
    }
    if (tid == 0) ud::tma_store_wait_read();  // shared memory stays valid until read
  }
}

// Launch the body on (B, N, heads * D) bf16 tensors with element strides
// (head h at column h * D of each row; NH = 2 takes heads in pairs).
// Needs 16-byte aligned base pointers, row and batch strides that are
// multiples of 8 elements, rows that hold all heads, an even head count
// for pairs, and one head at D < 64. The tensor maps are built here, on
// the host, for every call.
template <int F, int NH, int Stages, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int batch, int heads, int nq, int nk,
                   long long q_bs, long long q_rs, long long k_bs, long long k_rs, long long v_bs, long long v_rs,
                   long long o_bs, long long o_rs, float scale_log2, cudaStream_t stream) {
  constexpr int kBlockM = kQRows / NH;
  constexpr int kSmem = smem_bytes<NH, Stages>();
  static_assert(kSmem <= kMaxSmem, "the ring does not fit in shared memory");
  if (batch <= 0 || heads <= 0 || nq <= 0 || nk <= 0 || heads % NH) return cudaErrorInvalidValue;
  if (D != kD && heads != 1) return cudaErrorInvalidValue;  // a 64-channel box would reach the next head
  const long long c = static_cast<long long>(heads) * D;
  const long long tiles = static_cast<long long>((nq + kBlockM - 1) / kBlockM) * (heads / NH) * batch;
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
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(attn_fwd_wgmma<F, NH, Stages, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return e;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  attn_fwd_wgmma<F, NH, Stages, D><<<grid, kThreads, kSmem, stream>>>(tq, tk, tv, to, nq, nk, heads,
                                                                       static_cast<int>(tiles), scale_log2);
  return cudaGetLastError();
}

}  // namespace hopper
}  // namespace
