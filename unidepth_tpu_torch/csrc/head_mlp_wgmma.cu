// The V2 heads' LayerNorm -> Linear pair for Hopper (kernel K2h), both heads
// in one launch, on wgmma and TMA:
//   out_h = LayerNorm(x; gamma_h, beta_h, eps_h) @ W_h^T + b_h,  h = 0 (depth), 1 (confidence)
// x is the decoder's latents as the feature pyramid leaves them, NCHW bf16
// (B, C, H, W), read in place; W_h (C, C) in nn.Linear layout and b_h,
// gamma_h, beta_h (C,) in bf16; out_h (B, H, W, C) bf16, the layout
// nn.Linear writes on the permuted latents. C is 64 (ViT-S/14's heads) or
// 128 (ViT-L/14's and ViT-g/14's); H * W is a multiple of 64 (the latents'
// grid is 8x the token grid), so a 64-pixel tile never straddles two images.
//
// Replaces no TPU kernel: the JAX package runs DepthHead's depth_mlp and
// confidence_mlp as LayerNorm and Dense modules. The port's module path ran,
// per head, an fp32 copy of the NCHW latents, a contiguous fp32 copy, an fp32
// LayerNorm, a bf16 cast and cuBLAS's linear: ~5 GB moved at 518x518.
//
// What bounds it on the H100: bytes. At 518x518 (B = 8, C = 128, 296 x 296
// pixels, M = 700,928 rows) a call reads 179 MB and writes 359 MB (0.161 ms
// at 3.35 TB/s) for 46 GFLOP (0.046 ms at the bf16 peak). The design:
//   * persistent grid, one block an SM, walking work tiles of 64 pixels of one
//     image. One producer thread loads a tile as a (C channels x 64 pixels)
//     TMA box of the NCHW map, 128 bytes a channel in the 128-byte swizzle,
//     into a 4-stage ring of full/empty mbarriers; no copy of the latents is
//     made before the launch;
//   * both heads' W (2 x C x C bf16, 64 KB at C = 128, K-major: wgmma's B),
//     gamma, beta and bias stay in shared memory for the block's life;
//   * two consumer warpgroups take the tiles in turn (stage s belongs to
//     consumer s % 2). ldmatrix.trans turns the channel-major tile into
//     wgmma's A fragments (pixel rows, channel columns): a thread holds C / 4
//     channels of two pixels, the other C * 3 / 4 are in the three threads of
//     its quad. Each pixel's mean and 1 / sqrt(var + eps) are two passes in
//     fp32 over those registers and two shuffles (no statistics launch);
//     the tile's stage is released as soon as the fragments are loaded;
//   * per head, A = bf16((x - mean) rstd gamma_h + beta_h) in registers (where
//     ln_dense_plain rounds), C / 16 wgmma m64nCk16 with W_h from shared
//     memory, then bias in fp32 on the accumulators and one rounding to bf16
//     into a swizzled staging buffer, stored by C / 64 64 x 64 TMA stores.
//     A head's product and epilogue run while the other warpgroup loads,
//     normalises or stores: the tensor cores are ~1/4 busy at this shape.
// At 518x518: 10,952 tiles on 132 blocks (83 each); 384 threads, one block
// an SM, ~200 KB of shared memory.

#include <math.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;      // pixels of a work tile: one consumer warpgroup's m64
constexpr int kStages = 4;     // tiles in flight; even, so stage s belongs to consumer s % 2
constexpr int kConsumers = 2;  // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kHeads = 2;      // at most: depth and confidence

template <int kC>
struct alignas(1024) Smem {
  bf16 w[kHeads][kC / 64][kC * 64];                    // W_h: 64-column k-blocks of C rows, swizzled
  bf16 x[kStages][kC * kRows];                         // a tile: C channel rows of 64 pixels, swizzled
  bf16 out[kConsumers][kHeads][kC / 64][kRows * 64];  // staging: 64 x 64 chunks a warpgroup and head
  float4 gb[kHeads][kC / 2];                           // {gamma[2p], gamma[2p + 1], beta[2p], beta[2p + 1]}
  float2 bias[kHeads][kC / 2];
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t wfull;
};

template <int kC>
int smem_bytes() { return static_cast<int>(sizeof(Smem<kC>)) + 1024; }  // room to align the base to 1024

// Each head's parameters (entries past `heads` are not read).
struct Params {
  const bf16* gamma[kHeads];
  const bf16* beta[kHeads];
  const bf16* bias[kHeads];
  float eps[kHeads];
};

// D(64 x N, f32) (+)= A(64 x 16, bf16, registers) B(16 x N), B K-major in
// shared memory (128-byte swizzle), N = 2 x the accumulators a thread holds.
// A's fragment (lane 4g + t of warp w): a0 = A[16w+g][2t..2t+1], a1 =
// A[16w+g+8][2t..], a2 = A[16w+g][2t+8..], a3 = A[16w+g+8][2t+8..].
// Accumulator element i: row 16w + g + 8 * ((i / 2) & 1), column 8 * (i / 4)
// + 2t + (i & 1).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ float2 bf16_pair(uint32_t packed) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&packed));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float2 param_pair(const bf16* p, int i) {
  return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(p)[i]);
}

template <int kC>
__global__ void __launch_bounds__(kThreads, 1)
    head_mlp_wgmma(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw0,
                   const __grid_constant__ CUtensorMap tw1, const __grid_constant__ CUtensorMap to0,
                   const __grid_constant__ CUtensorMap to1, const Params prm, int heads, int tiles,
                   int tiles_per_image) {
  constexpr int kK = kC / 16;  // k16 steps
  constexpr int kN = kC / 2;   // accumulators a thread holds: m64nC
  constexpr int kChunk = kRows * 64 * 2;  // bytes of a 64 x 64 staging chunk
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on that grid
  const uint32_t pad = (1024u - (ud::smem_u32(smem_raw) & 1023u)) & 1023u;
  Smem<kC>& sm = *reinterpret_cast<Smem<kC>*>(smem_raw + pad);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

#pragma unroll
  for (int h = 0; h < kHeads; ++h) {  // unrolled: the parameter arrays take constant indices
    if (h == heads) break;
    for (int p = threadIdx.x; p < kC / 2; p += kThreads) {
      const float2 g = param_pair(prm.gamma[h], p), b = param_pair(prm.beta[h], p);
      sm.gb[h][p] = make_float4(g.x, g.y, b.x, b.y);
      sm.bias[h][p] = param_pair(prm.bias[h], p);
    }
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      ud::mbar_init(&sm.full[st], 1);
      ud::mbar_init(&sm.empty[st], 128);
    }
    ud::mbar_init(&sm.wfull, 1);
    ud::fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: the weights once, then one thread keeps the ring of tiles full ----
    ud::setmaxnreg_dec<24>();
    if (tid == 0) {
      const CUtensorMap* tw[kHeads] = {&tw0, &tw1};
      ud::mbar_arrive_expect_tx(&sm.wfull, heads * kC * kC * 2);
#pragma unroll
      for (int h = 0; h < kHeads; ++h) {
        if (h == heads) break;
#pragma unroll
        for (int kb = 0; kb < kC / 64; ++kb) ud::tma_load_3d(sm.w[h][kb], tw[h], &sm.wfull, 64 * kb, 0, 0);
      }
      int j = 0;  // tiles issued by this block
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++j) {
        const int st = j % kStages;
        ud::mbar_wait(&sm.empty[st], ((j / kStages) & 1) ^ 1);  // the first round passes at once
        ud::mbar_arrive_expect_tx(&sm.full[st], kC * kRows * 2);
        ud::tma_load_3d(sm.x[st], &tx, &sm.full[st], (tile % tiles_per_image) * kRows, 0, tile / tiles_per_image);
      }
    }
  } else {
    // ---- consumer warpgroup `wg`: tiles j = wg, wg + 2, ... of this block ----
    ud::setmaxnreg_inc<240>();
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const CUtensorMap* to[kHeads] = {&to0, &to1};
    // ldmatrix.trans: lane l gives the address of channel (l & 7) + 8 (l >> 4) of
    // each 16-channel step, at the 16-byte chunk of pixels 16 warp + 8 ((l >> 3)
    // & 1); the swizzle XORs that chunk with the channel's row % 8, which is l & 7
    const int r = lane & 7, mat = lane >> 3;
    const uint32_t xoff = (r + 8 * (mat >> 1)) * 128 + (((2 * warp + (mat & 1)) ^ r) << 4);
    const int orow = 16 * warp + g;  // orow % 8 == (orow + 8) % 8 == g
    unsigned char* staging = reinterpret_cast<unsigned char*>(sm.out[wg]);
    float acc[kN];
#pragma unroll
    for (int i = 0; i < kN; ++i) acc[i] = 0.f;
    ud::mbar_wait(&sm.wfull, 0);
    int j = wg;
    for (int tile = blockIdx.x + wg * gridDim.x; tile < tiles; tile += kConsumers * gridDim.x, j += kConsumers) {
      const int st = j % kStages;
      ud::mbar_wait(&sm.full[st], (j / kStages) & 1);
      uint32_t xr[kK][4];
      const unsigned char* xs = reinterpret_cast<const unsigned char*>(sm.x[st]) + xoff;
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) ud::ldmatrix_x4_trans(xr[kk], xs + kk * 16 * 128);
      ud::mbar_arrive(&sm.empty[st]);

      // mean and variance of pixel rows g (registers 0 and 2) and g + 8 (1 and 3), two passes in fp32
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        const float2 a = bf16_pair(xr[kk][0]), b = bf16_pair(xr[kk][1]);
        const float2 c = bf16_pair(xr[kk][2]), d = bf16_pair(xr[kk][3]);
        s0 += a.x + a.y + c.x + c.y;
        s1 += b.x + b.y + d.x + d.y;
      }
      const float mean0 = quad_sum(s0) / kC, mean1 = quad_sum(s1) / kC;
      float v0 = 0.f, v1 = 0.f;
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
        for (int q = 0; q < 4; q += 2) {
          const float2 a = bf16_pair(xr[kk][q]), b = bf16_pair(xr[kk][q + 1]);
          v0 += (a.x - mean0) * (a.x - mean0) + (a.y - mean0) * (a.y - mean0);
          v1 += (b.x - mean1) * (b.x - mean1) + (b.y - mean1) * (b.y - mean1);
        }
      }
      const float var0 = quad_sum(v0) / kC, var1 = quad_sum(v1) / kC;

      // the previous tile's stores have read this warpgroup's staging buffers
      if (tid == 0) ud::tma_store_wait_read();
      ud::named_barrier_sync(1 + wg, 128);
#pragma unroll
      for (int h = 0; h < kHeads; ++h) {
        if (h == heads) break;
        const float rstd0 = 1.f / sqrtf(var0 + prm.eps[h]), rstd1 = 1.f / sqrtf(var1 + prm.eps[h]);
        const float2 st0 = make_float2(rstd0, -mean0 * rstd0), st1 = make_float2(rstd1, -mean1 * rstd1);
        uint32_t a[kK][4];
#pragma unroll
        for (int kk = 0; kk < kK; ++kk) {
          const float4 lo = sm.gb[h][8 * kk + t];      // channels 16kk + 2t, + 1
          const float4 hi = sm.gb[h][8 * kk + 4 + t];  // channels 16kk + 8 + 2t, + 1
          a[kk][0] = ud::normalize_pair(xr[kk][0], lo, st0);
          a[kk][1] = ud::normalize_pair(xr[kk][1], lo, st1);
          a[kk][2] = ud::normalize_pair(xr[kk][2], hi, st0);
          a[kk][3] = ud::normalize_pair(xr[kk][3], hi, st1);
        }
        ud::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kK; ++kk)
          wgmma_rs(acc, a[kk], ud::wgmma_desc_sw128(sm.w[h][kk / 4]) + 2 * (kk % 4), kk > 0);
        ud::wgmma_commit();
        ud::wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < kN; ++i) ud::reg_fence(acc[i]);
#pragma unroll
        for (int kk = 0; kk < kK; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) ud::reg_fence(a[kk][i]);

        // bias in fp32, one rounding to bf16, into head h's staging chunks in
        // the swizzle the output map's TMA store reads
        unsigned char* ob = staging + h * (kC / 64) * kChunk;
#pragma unroll
        for (int jj = 0; jj < kC / 8; ++jj) {
          const float2 b = sm.bias[h][4 * jj + t];  // columns 8jj + 2t, + 1
          unsigned char* chunk = ob + (jj / 8) * kChunk;
          const int off = (((jj % 8) ^ g) << 4) + 4 * t;
          *reinterpret_cast<uint32_t*>(chunk + orow * 128 + off) =
              ud::pack_bf16(acc[4 * jj] + b.x, acc[4 * jj + 1] + b.y);
          *reinterpret_cast<uint32_t*>(chunk + (orow + 8) * 128 + off) =
              ud::pack_bf16(acc[4 * jj + 2] + b.x, acc[4 * jj + 3] + b.y);
        }
        ud::fence_proxy_async();
        ud::named_barrier_sync(1 + wg, 128);
        if (tid == 0) {
#pragma unroll
          for (int q = 0; q < kC / 64; ++q) ud::tma_store_3d(to[h], ob + q * kChunk, 64 * q, tile * kRows, 0);
          ud::tma_store_commit();
        }
      }
    }
    if (tid == 0) ud::tma_store_wait_read();  // shared memory stays valid until read
  }
}

template <int kC>
int launch(const void* x, const void* const* w, void* const* out, const Params& prm, int b, int p, int heads,
           void* stream) {
  const long long m = static_cast<long long>(b) * p;
  if (b <= 0 || p <= 0 || p % kRows || heads < 1 || heads > kHeads || m > 0x7fffffff) return cudaErrorInvalidValue;
  uintptr_t bases = reinterpret_cast<uintptr_t>(x);
  for (int h = 0; h < heads; ++h)
    bases |= reinterpret_cast<uintptr_t>(w[h]) | reinterpret_cast<uintptr_t>(out[h]) |
             reinterpret_cast<uintptr_t>(prm.gamma[h]) | reinterpret_cast<uintptr_t>(prm.beta[h]) |
             reinterpret_cast<uintptr_t>(prm.bias[h]);
  if (bases % 16) return cudaErrorInvalidValue;
  // x: (pixels, channels, batch), boxes of 64 pixels x C channels
  const cuuint64_t dims[3] = {cuuint64_t(p), cuuint64_t(kC), cuuint64_t(b)};
  const cuuint64_t strides[2] = {cuuint64_t(p) * 2, cuuint64_t(p) * kC * 2};
  const cuuint32_t box[3] = {kRows, kC, 1};
  CUtensorMap tx, tw[kHeads], to[kHeads];
  if (!ud::make_map(&tx, x, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B)) return cudaErrorInvalidValue;
  for (int h = 0; h < kHeads; ++h) {
    const int src = h < heads ? h : 0;  // a missing head's maps repeat head 0's and are not read
    if (!ud::make_map_sw128(&tw[h], w[src], kC, kC, 1, kC, static_cast<long long>(kC) * kC, kC) ||
        !ud::make_map_sw128(&to[h], out[src], kC, static_cast<int>(m), 1, kC, m * kC, kRows))
      return cudaErrorInvalidValue;
  }
  const int tiles = static_cast<int>(m / kRows);
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(head_mlp_wgmma<kC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<kC>());
  if (e != cudaSuccess) return e;
  const int grid = tiles < sms ? tiles : sms;
  head_mlp_wgmma<kC><<<grid, kThreads, smem_bytes<kC>(), static_cast<cudaStream_t>(stream)>>>(
      tx, tw[0], tw[1], to[0], to[1], prm, heads, tiles, p / kRows);
  return cudaGetLastError();
}

}  // namespace

// K2h: x (B, C, P) bf16 NCHW with P = H * W pixels, P % 64 == 0, C 64 or 128;
// for each of the `heads` (1 or 2) heads h, w_h (C, C), bias_h, gamma_h and
// beta_h (C,) contiguous bf16, eps_h, and out_h (B, P, C) bf16. Every base
// 16-byte aligned; a second head's pointers may be null when heads == 1.
// The tensor maps are built here, on the host, for every call.
extern "C" int ud_head_mlp_hopper_fwd(const void* x, const void* w0, const void* w1, const void* bias0,
                                      const void* bias1, const void* gamma0, const void* gamma1, const void* beta0,
                                      const void* beta1, void* out0, void* out1, int b, int c, int p, int heads,
                                      float eps0, float eps1, void* stream) {
  const bf16* h1[3] = {static_cast<const bf16*>(gamma1), static_cast<const bf16*>(beta1),
                       static_cast<const bf16*>(bias1)};
  if (heads < 2) h1[0] = h1[1] = h1[2] = nullptr;
  const Params prm{{static_cast<const bf16*>(gamma0), h1[0]},
                   {static_cast<const bf16*>(beta0), h1[1]},
                   {static_cast<const bf16*>(bias0), h1[2]},
                   {eps0, eps1}};
  const void* w[kHeads] = {w0, w1};
  void* out[kHeads] = {out0, out1};
  if (c == 64) return launch<64>(x, w, out, prm, b, p, heads, stream);
  if (c == 128) return launch<128>(x, w, out, prm, b, p, heads, stream);
  return cudaErrorInvalidValue;
}
