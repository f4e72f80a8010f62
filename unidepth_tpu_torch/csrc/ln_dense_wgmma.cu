// Fused LayerNorm -> GEMM -> bias -> exact GELU for Hopper on wgmma and TMA:
//   out = act(LayerNorm(x; gamma, beta, eps) @ W^T + b)
// x (M, C) and W (F, C) (nn.Linear layout) in bf16, b/gamma/beta fp32 or
// bf16 (read as they are: no cast launches), out (M, F) bf16.
//
// Replaces, for bf16 with C % 64 == 0, C <= 2048 and F % 256 == 0, the TPU
// Pallas kernel unidepth_tpu/ops/fused_block.py _ln_dense_fwd /
// _ln_dense_kernel (the ViT block's LN2 -> fc1 -> GELU). fp32 I/O and the
// other shapes keep ln_dense.cu.
//
// What bounds it on the H100: operations. At the ViT-L serving shape
// (M = 8 * 1370 = 10960, C = 1024, F = 4096) a call is 91.9 GFLOP against
// ~120 MB of x, W and out: 0.093 ms at the dense bf16 peak, 0.036 ms at
// 3.35 TB/s. The design:
//   * two launches: ln_row_stats (one warp a row, two passes in fp32, as
//     the TPU kernel) writes each row's mean and 1 / sqrt(var + eps), M x 8
//     bytes; then the GEMM kernel ln_dense_wgmma reads them;
//   * persistent grid: one block an SM walks the 128 x 256 output tiles,
//     column blocks fastest, so the ~9 row blocks of x in flight are each
//     read by F / 256 blocks at once and all of W (8 MB at ViT-L) stays hot
//     in L2, while the 90 MB output streams through it;
//   * a producer warpgroup, of which one thread issues the TMA copies of
//     each 64-deep slice (x 128 x 64, 16 KB; W 256 x 64, 32 KB, K-major as
//     nn.Linear stores it, which is wgmma's B) in the 128-byte swizzle,
//     into a 3-stage ring of full/empty mbarriers (setmaxnreg moves
//     registers from the producer, 24, to the consumers, 240);
//   * two consumer warpgroups, 64 rows each. The LN is applied to the A
//     operand in registers: ldmatrix reads the 64 x 16 x fragments from the
//     swizzled slice (its addresses undo the XOR swizzle TMA wrote), each
//     thread applies (x * rstd - mean * rstd) * gamma + beta in fp32, two
//     FMAs an element (gamma and beta staged once a block in shared memory,
//     the row's rstd and -mean * rstd in registers) and packs to bf16, where
//     the plain version rounds too; wgmma m64n256k16 then takes A from
//     registers and W from shared memory. The normalised activation never
//     reaches shared or device memory, and no barrier guards it. A slice is
//     normalised while the previous slice's wgmma run (two A register sets).
//     Measured on the H100 (PERF.md): the LN still costs the main
//     loop ~17% (the GEMM without GELU 0.205 ms, 0.170 with the LN math
//     left out), and not by its instruction count (three FP32 operations
//     an element or two, the same time); normalising x in shared memory
//     in warps 1-3 of the producer warpgroup instead ran 0.374 ms;
//   * the normalisation stays before the product: folding it into the
//     epilogue (rstd (x (gamma W)) - rstd mean colsum) loses digits as a
//     row's |mean| / std grows;
//   * epilogue: bias and exact GELU (erff) in fp32 on the accumulators (64
//     x 256 a warpgroup, 128 registers a thread), rounded to bf16 into a
//     swizzled staging buffer, then four 64 x 64 TMA stores that clip rows
//     >= M. x rows >= M load as zeros, and no statistics past M are read.
// At the serving shape: 86 x 16 = 1376 tiles on 132 blocks (10.4 each);
// 384 threads, one block an SM.
//
// The gated body, ln_swiglu_wgmma (DINOv2 ViT-g/14's SwiGLU FFN; no TPU
// kernel: the JAX package runs that block unfused):
//   out = silu(a) * g,  (a, g) = the halves of LayerNorm(x) @ W12^T + b12
// with W12 (2H, C) and out (M, H). The same body and ring; a tile's 256 W
// rows are loaded as two 128-row boxes, rows n .. n + 127 of a and H + n ..
// of g, so accumulator columns 8j + 2t and 8(j + 16) + 2t of one thread are
// the value and the gate of output column n + 8j + 2t. The epilogue adds
// both biases and writes silu(a) * g in fp32, rounded once to bf16, as a 64
// x 128 tile (two 64 x 64 TMA stores): the (M, 2H) product and the chunk,
// silu and multiply passes over it never reach device memory. At ViT-g's
// shape (M = 10960, C = 1536, 2H = 8192) a call is 276 GFLOP against ~140 MB
// moved: 0.279 ms at the bf16 peak, bound by operations as GELU's is. The
// GELU kernel is the body's other instantiation, compiled as before.

#include <math.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;       // rows of an output tile: two consumer warpgroups of 64
constexpr int kBN = 256;       // columns of an output tile: one m64n256 wgmma a warpgroup
constexpr int kBK = 64;        // slice depth: one 128-byte swizzled row
constexpr int kStages = 3;     // slices in flight
constexpr int kConsumers = 2;  // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr uint32_t kSliceBytes = (kBM + kBN) * kBK * 2;  // x and W of one slice
constexpr int kMaxC = 2048;    // gamma and beta fit beside the ring in shared memory

struct alignas(1024) Smem {
  bf16 x[kStages][kBM * kBK];
  bf16 w[kStages][kBN * kBK];
  bf16 out[kConsumers][kBN / 64][64 * 64];  // per warpgroup: four swizzled 64 x 64 chunks
  uint64_t full[kStages];
  uint64_t empty[kStages];
};
// followed by gamma and beta, {gamma[2p], gamma[2p+1], beta[2p], beta[2p+1]}
// for column pair p, and room to align the base to 1024
int smem_bytes(int c) { return static_cast<int>(sizeof(Smem)) + 8 * c + 1024; }

__device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// Mean and 1/sqrt(var + eps) of each row of x (M, C), one warp a row, two
// passes in fp32, 16-byte loads (C % 8 == 0).
__global__ void __launch_bounds__(256) ln_row_stats(const bf16* __restrict__ x, float2* __restrict__ stats, int m,
                                                    int c, float eps) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= m) return;
  const bf16* xr = x + static_cast<long long>(row) * c;
  float s = 0.f;
  for (int i = lane * 8; i < c; i += 256) {
    const uint4 u = *reinterpret_cast<const uint4*>(xr + i);
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int k = 0; k < 8; ++k) s += __bfloat162float(e[k]);
  }
  const float mean = ud::warp_sum(s) / c;
  float v = 0.f;
  for (int i = lane * 8; i < c; i += 256) {
    const uint4 u = *reinterpret_cast<const uint4*>(xr + i);
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float d = __bfloat162float(e[k]) - mean;
      v += d * d;
    }
  }
  const float var = ud::warp_sum(v) / c;
  if (lane == 0) stats[row] = make_float2(mean, 1.f / sqrtf(var + eps));
}

// D(64 x 256, f32) (+)= A(64 x 16, bf16, registers) B(16 x 256), B K-major
// in shared memory (128-byte swizzle). A's fragment (lane 4g + t of warp w):
// a0 = A[16w+g][2t..2t+1], a1 = A[16w+g+8][2t..], a2 = A[16w+g][2t+8..],
// a3 = A[16w+g+8][2t+8..]. Accumulator element i: row 16w + g + 8 * ((i /
// 2) & 1), column 8 * (i / 4) + 2t + (i & 1).
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, "
      "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, "
      "%89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, "
      "%109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// element i of a bf16 or fp32 parameter vector, as fp32
__device__ __forceinline__ float param(const void* p, int i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[i]) : static_cast<const float*>(p)[i];
}

// {rstd, -mean * rstd} of row r of the statistics, {0, 0} past M (x rows
// >= M load as zeros, so their normalised value is beta)
__device__ __forceinline__ float2 row_scale(const float2* stats, int r, int m) {
  if (r >= m) return make_float2(0.f, 0.f);
  const float2 st = stats[r];
  return make_float2(st.y, -st.x * st.y);
}

// What a consumer thread keeps across the slices of a tile.
struct Lane {
  uint32_t xoff;      // byte offset of its ldmatrix row in an x slice
  int swz, half, t;   // that row % 8, its 16-byte chunk within a 16-deep step, lane % 4
  float2 st0, st1;    // rstd and -mean * rstd of its accumulator rows g and g + 8
};

// Slice s of a tile: x fragments -> LN in registers -> four wgmma into acc,
// issued while the previous slice's are still running; then wait for those,
// and release the previous slice's stage.
__device__ __forceinline__ void slice_step(Smem& sm, const float4* gb, float (&acc)[128], uint32_t (&cur)[4][4],
                                           uint32_t (&prev)[4][4], int s, int& ring, const Lane& ln) {
  const int st = ring % kStages;
  ud::mbar_wait(&sm.full[st], (ring / kStages) & 1);
  const unsigned char* xs = reinterpret_cast<const unsigned char*>(sm.x[st]) + ln.xoff;
  const float4* g = gb + s * (kBK / 2);
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    ud::ldmatrix_x4(cur[kk], xs + (((2 * kk + ln.half) ^ ln.swz) << 4));
    const float4 lo = g[8 * kk + ln.t];      // columns 16kk + 2t, + 1
    const float4 hi = g[8 * kk + 4 + ln.t];  // columns 16kk + 8 + 2t, + 1
    cur[kk][0] = ud::normalize_pair(cur[kk][0], lo, ln.st0);
    cur[kk][1] = ud::normalize_pair(cur[kk][1], lo, ln.st1);
    cur[kk][2] = ud::normalize_pair(cur[kk][2], hi, ln.st0);
    cur[kk][3] = ud::normalize_pair(cur[kk][3], hi, ln.st1);
  }
  ud::wgmma_fence();
  const uint64_t wdesc = ud::wgmma_desc_sw128(sm.w[st]);
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) wgmma_m64n256k16_rs(acc, cur[kk], wdesc + 2 * kk, s > 0 || kk > 0);
  ud::wgmma_commit();
  ud::wgmma_wait<1>();  // the previous slice's products are done with its A registers and W stage
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) ud::reg_fence(prev[kk][i]);
  if (s > 0) ud::mbar_arrive(&sm.empty[(ring + kStages - 1) % kStages]);
  ++ring;
}

__device__ __forceinline__ float swiglu(float a, float g) { return a / (1.f + expf(-a)) * g; }

// bias[i], bias[i + 1] of a bf16 or fp32 vector (i even), as fp32
__device__ __forceinline__ float2 param_pair(const void* p, int i, int is_bf16) {
  return is_bf16 ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(static_cast<const bf16*>(p) + i))
                 : *reinterpret_cast<const float2*>(static_cast<const float*>(p) + i);
}

// The body of both kernels (see the top of the file): kGated false is
// ln_dense_wgmma, true ln_swiglu_wgmma, whose tensor maps of W and out take
// 128-row boxes and whose f is W12's 2H rows.
template <bool kGated>
__device__ __forceinline__ void ln_dense_body(const CUtensorMap* tx, const CUtensorMap* tw, const CUtensorMap* to,
                                              const float2* __restrict__ stats, const void* __restrict__ bias,
                                              const void* __restrict__ gamma, const void* __restrict__ beta,
                                              int params_bf16, int m, int c, int f, int gelu) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on that grid
  const uint32_t pad = (1024u - (ud::smem_u32(smem_raw) & 1023u)) & 1023u;
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + pad);
  float4* gb = reinterpret_cast<float4*>(smem_raw + pad + sizeof(Smem));

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int n_tiles = f / kBN;
  const int tiles = ((m + kBM - 1) / kBM) * n_tiles;
  const int slices = c / kBK;

  for (int p = threadIdx.x; p < c / 2; p += kThreads)
    gb[p] = make_float4(param(gamma, 2 * p, params_bf16), param(gamma, 2 * p + 1, params_bf16),
                        param(beta, 2 * p, params_bf16), param(beta, 2 * p + 1, params_bf16));
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      ud::mbar_init(&sm.full[st], 1);
      ud::mbar_init(&sm.empty[st], 128 * kConsumers);
    }
    ud::fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring of x and W slices full ----
    ud::setmaxnreg_dec<24>();
    if (tid == 0) {
      int ring = 0;  // slices issued so far, across tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / n_tiles) * kBM, n0 = (tile % n_tiles) * kBN;
        for (int s = 0; s < slices; ++s, ++ring) {
          const int st = ring % kStages;
          ud::mbar_wait(&sm.empty[st], ((ring / kStages) & 1) ^ 1);  // the first round passes at once
          ud::mbar_arrive_expect_tx(&sm.full[st], kSliceBytes);
          ud::tma_load_3d(sm.x[st], tx, &sm.full[st], s * kBK, m0, 0);
          if constexpr (kGated) {  // rows n0 / 2 .. of a, then the same rows of g
            ud::tma_load_3d(sm.w[st], tw, &sm.full[st], s * kBK, n0 / 2, 0);
            ud::tma_load_3d(sm.w[st] + (kBN / 2) * kBK, tw, &sm.full[st], s * kBK, f / 2 + n0 / 2, 0);
          } else {
            ud::tma_load_3d(sm.w[st], tw, &sm.full[st], s * kBK, n0, 0);
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroup `wg`: rows m0 + 64 wg .. + 63 of each tile ----
    ud::setmaxnreg_inc<240>();
    const int warp = tid / 32, lane = tid % 32, g = lane / 4;
    // ldmatrix: lane l gives row l % 16 of its warp's 16 rows, 16-byte chunk l / 16 of each 16-deep step
    const int xrow = 64 * wg + 16 * warp + (lane & 15);
    Lane ln{static_cast<uint32_t>(xrow * 128), xrow & 7, lane >> 4, lane % 4, {}, {}};
    unsigned char* ob = reinterpret_cast<unsigned char*>(sm.out[wg]);
    const int orow = 16 * warp + g;  // orow % 8 == (orow + 8) % 8 == g
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    uint32_t a0[4][4], a1[4][4];
    int ring = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / n_tiles) * kBM, n0 = (tile % n_tiles) * kBN;
      const int r0 = m0 + 64 * wg + orow;
      ln.st0 = row_scale(stats, r0, m);
      ln.st1 = row_scale(stats, r0 + 8, m);
      for (int s = 0; s < slices; s += 2) {
        slice_step(sm, gb, acc, a0, a1, s, ring, ln);
        if (s + 1 < slices) slice_step(sm, gb, acc, a1, a0, s + 1, ring, ln);
      }
      ud::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 128; ++i) ud::reg_fence(acc[i]);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ud::reg_fence(a0[kk][i]);
          ud::reg_fence(a1[kk][i]);
        }
      ud::mbar_arrive(&sm.empty[(ring + kStages - 1) % kStages]);  // the tile's last stage

      // bias (+ GELU, or the gate) -> bf16 into this warpgroup's staging
      // chunks, in the swizzle the output map's TMA store reads, once the
      // previous tile's stores from them have read them
      if (tid == 0) ud::tma_store_wait_read();
      ud::named_barrier_sync(1 + wg, 128);
      if constexpr (kGated) {
        // output columns n0 / 2 + 8j + 2t, + 1: a in acc[4j ..], g in acc[4(j + 16) ..]
#pragma unroll
        for (int j = 0; j < kBN / 16; ++j) {
          const int col = n0 / 2 + 8 * j + 2 * ln.t;
          const float2 ba = param_pair(bias, col, params_bf16), bg = param_pair(bias, f / 2 + col, params_bf16);
          const int ga = 4 * j, gg = 4 * (j + kBN / 16);  // constant once unrolled: acc stays in registers
          unsigned char* chunk = ob + (j / 8) * (64 * 64 * 2);
          const int off = (((j % 8) ^ g) << 4) + 4 * ln.t;
          *reinterpret_cast<uint32_t*>(chunk + orow * 128 + off) = ud::pack_bf16(
              swiglu(acc[ga] + ba.x, acc[gg] + bg.x), swiglu(acc[ga + 1] + ba.y, acc[gg + 1] + bg.y));
          *reinterpret_cast<uint32_t*>(chunk + (orow + 8) * 128 + off) = ud::pack_bf16(
              swiglu(acc[ga + 2] + ba.x, acc[gg + 2] + bg.x), swiglu(acc[ga + 3] + ba.y, acc[gg + 3] + bg.y));
        }
        ud::fence_proxy_async();
        ud::named_barrier_sync(1 + wg, 128);
        if (tid == 0 && m0 + 64 * wg < m) {
#pragma unroll
          for (int q = 0; q < kBN / 128; ++q)
            ud::tma_store_3d(to, ob + q * (64 * 64 * 2), n0 / 2 + 64 * q, m0 + 64 * wg, 0);
          ud::tma_store_commit();
        }
        continue;
      }
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * ln.t;
        const float2 b = params_bf16 ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                                           static_cast<const bf16*>(bias) + col))
                                     : *reinterpret_cast<const float2*>(static_cast<const float*>(bias) + col);
        float v0 = acc[4 * j] + b.x, v1 = acc[4 * j + 1] + b.y;
        float v2 = acc[4 * j + 2] + b.x, v3 = acc[4 * j + 3] + b.y;
        if (gelu) {
          v0 = gelu_exact(v0);
          v1 = gelu_exact(v1);
          v2 = gelu_exact(v2);
          v3 = gelu_exact(v3);
        }
        unsigned char* chunk = ob + (j / 8) * (64 * 64 * 2);
        const int off = (((j % 8) ^ g) << 4) + 4 * ln.t;
        *reinterpret_cast<uint32_t*>(chunk + orow * 128 + off) = ud::pack_bf16(v0, v1);
        *reinterpret_cast<uint32_t*>(chunk + (orow + 8) * 128 + off) = ud::pack_bf16(v2, v3);
      }
      ud::fence_proxy_async();
      ud::named_barrier_sync(1 + wg, 128);
      if (tid == 0 && m0 + 64 * wg < m) {
#pragma unroll
        for (int q = 0; q < kBN / 64; ++q) ud::tma_store_3d(to, ob + q * (64 * 64 * 2), n0 + 64 * q, m0 + 64 * wg, 0);
        ud::tma_store_commit();
      }
    }
    if (tid == 0) ud::tma_store_wait_read();  // shared memory stays valid until read
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    ln_dense_wgmma(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                   const __grid_constant__ CUtensorMap to, const float2* __restrict__ stats,
                   const void* __restrict__ bias, const void* __restrict__ gamma, const void* __restrict__ beta,
                   int params_bf16, int m, int c, int f, int gelu) {
  ln_dense_body<false>(&tx, &tw, &to, stats, bias, gamma, beta, params_bf16, m, c, f, gelu);
}

__global__ void __launch_bounds__(kThreads, 1)
    ln_swiglu_wgmma(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                    const __grid_constant__ CUtensorMap to, const float2* __restrict__ stats,
                    const void* __restrict__ bias, const void* __restrict__ gamma, const void* __restrict__ beta,
                    int params_bf16, int m, int c, int f) {
  ln_dense_body<true>(&tx, &tw, &to, stats, bias, gamma, beta, params_bf16, m, c, f, 0);
}

// The shared launch of both GEMM entries (arguments as they document).
template <bool kGated>
int launch_hopper(const void* x, const void* w, const void* bias, const void* gamma, const void* beta,
                  const void* stats, void* out, int m, int c, int f, int gelu, int params_bf16, void* stream) {
  if (m <= 0 || c <= 0 || c % kBK || c > kMaxC || f <= 0 || f % kBN) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(out) |
       reinterpret_cast<uintptr_t>(stats) | reinterpret_cast<uintptr_t>(bias)) % 16)
    return cudaErrorInvalidValue;
  const long long tiles = static_cast<long long>((m + kBM - 1) / kBM) * (f / kBN);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const int n_out = kGated ? f / 2 : f;  // out's columns
  CUtensorMap tx, tw, to;
  if (!ud::make_map_sw128(&tx, x, c, m, 1, c, static_cast<long long>(m) * c, kBM) ||
      !ud::make_map_sw128(&tw, w, c, f, 1, c, static_cast<long long>(f) * c, kGated ? kBN / 2 : kBN) ||
      !ud::make_map_sw128(&to, out, n_out, m, 1, n_out, static_cast<long long>(m) * n_out, 64))
    return cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) {
    if constexpr (kGated)
      e = cudaFuncSetAttribute(ln_swiglu_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(c));
    else
      e = cudaFuncSetAttribute(ln_dense_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(c));
  }
  if (e != cudaSuccess) return e;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (kGated)
    ln_swiglu_wgmma<<<grid, kThreads, smem_bytes(c), st>>>(tx, tw, to, static_cast<const float2*>(stats), bias, gamma,
                                                           beta, params_bf16, m, c, f);
  else
    ln_dense_wgmma<<<grid, kThreads, smem_bytes(c), st>>>(tx, tw, to, static_cast<const float2*>(stats), bias, gamma,
                                                          beta, params_bf16, m, c, f, gelu);
  return cudaGetLastError();
}

}  // namespace

// K2's first launch: stats[r] = {mean, 1 / sqrt(var + eps)} of row r of the
// bf16 x (M, C), C % 8 == 0, 16-byte aligned rows.
extern "C" int ud_ln_row_stats(const void* x, void* stats, int m, int c, float eps, void* stream) {
  if (m <= 0 || c <= 0 || c % 8) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(stats)) % 16) return cudaErrorInvalidValue;
  ln_row_stats<<<(m + 7) / 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<float2*>(stats), m, c, eps);
  return cudaGetLastError();
}

// K2's bf16 GEMM on the statistics of ud_ln_row_stats: x (M, C) and W (F, C)
// contiguous bf16 with 16-byte aligned bases, C % 64 == 0, C <= 2048,
// F % 256 == 0; bias (F,), gamma and beta (C,) contiguous, all three bf16
// (params_bf16 = 1) or all fp32; out (M, F) bf16. The tensor maps are built
// here, on the host, for every call.
extern "C" int ud_ln_dense_hopper_fwd(const void* x, const void* w, const void* bias, const void* gamma,
                                      const void* beta, const void* stats, void* out, int m, int c, int f,
                                      int gelu, int params_bf16, void* stream) {
  return launch_hopper<false>(x, w, bias, gamma, beta, stats, out, m, c, f, gelu, params_bf16, stream);
}

// K2's gated GEMM on the statistics of ud_ln_row_stats: as
// ud_ln_dense_hopper_fwd with W = W12 (F = 2H, C) and bias (2H,), whose first
// H rows give the value a and last H the gate g; out (M, H) = silu(a) * g.
extern "C" int ud_ln_swiglu_hopper_fwd(const void* x, const void* w, const void* bias, const void* gamma,
                                       const void* beta, const void* stats, void* out, int m, int c, int f,
                                       int params_bf16, void* stream) {
  return launch_hopper<true>(x, w, bias, gamma, beta, stats, out, m, c, f, 0, params_bf16, stream);
}
