// 3x3 stride-1 "same" convolution for few output channels, NHWC in and out.
//
// Replaces the TPU Pallas kernel conv3x3_lowchannel (_conv3x3_fwd / _kernel,
// unidepth_tpu/ops/conv_kernels.py): x (B, H, W, Cin), w (3, 3, Cin, Cout)
// HWIO, optional bias, zeros / reflect / replicate padding, fp32
// accumulation, output in x's type with the bias added in that type.
//
// What bounds it on the H100: memory. At the V2 heads' hr conv,
// (8, 518, 518, 64 -> 32) bf16, the work is 79.1 GFLOP against at least
// 412 MB of I/O (x read once, the output written once): 192 FLOP/B, below
// the ~295 FLOP/B at which bf16 tensor cores become the limit, so the bound
// is 412 MB / 3.35 TB/s = 0.123 ms. The kernel must read x about once and
// keep every intermediate on the chip.
//
// Design: an implicit GEMM. The TPU kernel's tap-stacked (9 Cout x Cin) GEMM
// per image row, its fp32 tap buffer and its shifted adds exist to fill the
// TPU's 128-lane matrix unit and are not carried over.
//  * A block owns tiles of kRows x kTileW output pixels (8 rows of 32) and
//    all Cout, and walks the tiles grid-stride, so it stages the weights in
//    shared memory once ([tap][cout][cin], 36 KB at 64 -> 32 bf16).
//  * For each tile it stages the (kRows + 2) x (kTileW + 2) x Cin input
//    window with cp.async. The padding mode is resolved by index at load
//    time (reflect: -1 -> 1, H -> H - 2; replicate clamps; zeros is a 0-byte
//    copy), so no padded copy of x is ever written to device memory.
//  * Each warp owns one output row of the tile (two 16-pixel mma tiles);
//    all nine taps accumulate into the same mma.sync m16n8k16 fp32
//    fragments: M = pixels, N = Cout in 8s, K = Cin in 16s. A tap is only
//    a shifted ldmatrix address into the window. Cin and Cout below the
//    granule are zero-filled in shared memory.
//  * The bias is added in the epilogue: out = T(T(acc) + bias), as the
//    plain version casts the conv to x's type and then adds the bias.
// Two blocks fit an SM (~90 KB each), so one block's window load overlaps
// the other's tensor-core work. fp32 I/O runs a CUDA-core path from the same
// tiling with exact fp32 products (no TF32).

#include "common.cuh"

namespace {

enum PadMode : int { kZeros = 0, kReflect = 1, kReplicate = 2 };

struct ConvArgs {
  const void* x;
  const void* w;
  const void* bias;  // may be null
  void* o;
  int batch, h, wd, cin, cout, mode;  // wd: the image width
};

constexpr int kRows = 8;    // output rows per tile, one warp each
constexpr int kTileW = 32;  // output pixels per tile row (two m16 tiles)
constexpr int kThreads = 32 * kRows;
constexpr int kWinW = kTileW + 2;

// Row or column i of the padded image, resolved to one of x: -1 when it
// reads zeros (zero padding, or past the pad of a ragged tile, whose
// outputs are never stored).
__device__ __forceinline__ int resolve(int i, int n, int mode) {
  if (i >= 0 && i < n) return i;
  if (i == -1) return mode == kReflect ? 1 : mode == kReplicate ? 0 : -1;
  if (i == n) return mode == kReflect ? n - 2 : mode == kReplicate ? n - 1 : -1;
  return -1;
}

struct Tile {
  int b, y0, x0;
};

__device__ __forceinline__ Tile tile_at(long long tile, const ConvArgs& a) {
  const int ncb = (a.wd + kTileW - 1) / kTileW, nrb = (a.h + kRows - 1) / kRows;
  const int cb = static_cast<int>(tile % ncb);
  const long long rest = tile / ncb;
  return {static_cast<int>(rest / nrb), static_cast<int>(rest % nrb) * kRows, cb * kTileW};
}

__host__ __device__ constexpr long long num_tiles(int batch, int h, int w) {
  return static_cast<long long>(batch) * ((h + kRows - 1) / kRows) * ((w + kTileW - 1) / kTileW);
}

// ---- bf16: tensor cores ---------------------------------------------------

template <int CINP, int COUTP>
struct Bf16Layout {
  static constexpr int PS = CINP + 8;  // pixel stride: 8 ldmatrix rows in distinct banks
  static constexpr int kWindow = (kRows + 2) * kWinW * PS;
  static constexpr int kWeights = 9 * COUTP * PS;
  static constexpr int smem_bytes = (kWindow + kWeights) * 2 + COUTP * 4;
};

template <int CINP, int COUTP>
__global__ void __launch_bounds__(kThreads) conv3x3_bf16(ConvArgs a) {
  using bf16 = __nv_bfloat16;
  using L = Bf16Layout<CINP, COUTP>;
  constexpr int PS = L::PS;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* win = reinterpret_cast<bf16*>(smem);                  // [kRows + 2][kWinW][PS]
  bf16* wts = win + L::kWindow;                               // [tap][COUTP][PS]
  float* bias = reinterpret_cast<float*>(wts + L::kWeights);  // [COUTP]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* X = static_cast<const bf16*>(a.x);
  const bf16* W = static_cast<const bf16*>(a.w);
  const bf16* B = static_cast<const bf16*>(a.bias);

  for (int i = tid; i < 9 * COUTP * CINP; i += kThreads) {
    const int ci = i % CINP, co = (i / CINP) % COUTP, tap = i / (CINP * COUTP);
    wts[(tap * COUTP + co) * PS + ci] =
        ci < a.cin && co < a.cout ? W[(tap * a.cin + ci) * a.cout + co] : __float2bfloat16(0.f);
  }
  for (int co = tid; co < COUTP; co += kThreads) bias[co] = B && co < a.cout ? ud::to_float(B[co]) : 0.f;

  const long long ntiles = num_tiles(a.batch, a.h, a.wd);
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const Tile tl = tile_at(tile, a);
    const bf16* Xb = X + static_cast<long long>(tl.b) * a.h * a.wd * a.cin;
    __syncthreads();  // the previous tile's window reads are done
    constexpr int kChunks = CINP / 8;  // 16-byte chunks per pixel
    for (int i = tid; i < (kRows + 2) * kWinW * kChunks; i += kThreads) {
      const int c = i % kChunks, p = i / kChunks;
      const int iy = resolve(tl.y0 - 1 + p / kWinW, a.h, a.mode);
      const int ix = resolve(tl.x0 - 1 + p % kWinW, a.wd, a.mode);
      const bool in = iy >= 0 && ix >= 0 && c * 8 < a.cin;
      const bf16* src = in ? Xb + (static_cast<long long>(iy) * a.wd + ix) * a.cin + c * 8 : X;
      ud::cp_async16(win + p * PS + c * 8, src, in ? 16 : 0);
    }
    ud::cp_async_commit();
    ud::cp_async_wait<0>();
    __syncthreads();

    float acc[2][COUTP / 8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < COUTP / 8; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int kk = 0; kk < CINP / 16; ++kk) {
        // A rows: pixels 16 mt + (lane & 15) of this warp's output row,
        // read at window row warp + dy, column pixel + dx
        uint32_t af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ud::ldmatrix_x4(af[mt], win + ((warp + dy) * kWinW + 16 * mt + (lane & 15) + dx) * PS + kk * 16 + (lane >> 4) * 8);
        // B: weights [tap][co][ci] are the column-major (K x N) operand
#pragma unroll
        for (int np = 0; np < COUTP / 16; ++np) {
          uint32_t bf[4];
          ud::ldmatrix_x4(bf, wts + (tap * COUTP + 16 * np + (lane & 7) + ((lane >> 4) << 3)) * PS + kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            ud::mma_bf16_16816(acc[mt][2 * np], af[mt], bf[0], bf[1]);
            ud::mma_bf16_16816(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
          }
        }
        if constexpr (COUTP % 16 != 0) {  // a last 8-wide Cout tile
          uint32_t bf[2];
          ud::ldmatrix_x2(bf, wts + (tap * COUTP + COUTP - 8 + (lane & 7)) * PS + kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) ud::mma_bf16_16816(acc[mt][COUTP / 8 - 1], af[mt], bf[0], bf[1]);
        }
      }
    }

    const int y = tl.y0 + warp;
    if (y < a.h) {
      bf16* O = static_cast<bf16*>(a.o) + (static_cast<long long>(tl.b) * a.h + y) * a.wd * a.cout;
      const bool pairs = (a.cout & 1) == 0;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int x = tl.x0 + 16 * mt + g + 8 * half;
          if (x >= a.wd) continue;
#pragma unroll
          for (int nt = 0; nt < COUTP / 8; ++nt) {
            const int co = 8 * nt + 2 * t;
            if (co >= a.cout) continue;
            const float v0 = ud::round_to<bf16>(acc[mt][nt][2 * half]) + bias[co];
            const float v1 = ud::round_to<bf16>(acc[mt][nt][2 * half + 1]) + bias[co + 1];
            bf16* dst = O + static_cast<long long>(x) * a.cout + co;
            if (pairs) {
              *reinterpret_cast<uint32_t*>(dst) = ud::pack_bf16(v0, v1);
            } else {
              dst[0] = __float2bfloat16_rn(v0);
              if (co + 1 < a.cout) dst[1] = __float2bfloat16_rn(v1);
            }
          }
        }
    }
  }
}

// ---- fp32: CUDA cores, one output pixel per thread ------------------------

template <int COUTP>
__global__ void __launch_bounds__(kThreads) conv3x3_simt(ConvArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* wts = reinterpret_cast<float*>(smem);  // [tap][cin][COUTP]: float4 broadcast reads
  float* win = wts + 9 * a.cin * COUTP;         // [kRows + 2][kWinW][cin + 1]
  const int CP = a.cin + 1;                     // odd for even cin: a warp's 32 pixels in distinct banks
  const float* X = static_cast<const float*>(a.x);
  const float* W = static_cast<const float*>(a.w);
  const float* B = static_cast<const float*>(a.bias);
  const int tid = threadIdx.x, r = tid / kTileW, c = tid % kTileW;

  for (int i = tid; i < 9 * a.cin * COUTP; i += kThreads) {
    const int co = i % COUTP, rest = i / COUTP;  // rest = tap * cin + ci
    wts[i] = co < a.cout ? W[rest * a.cout + co] : 0.f;
  }

  const long long ntiles = num_tiles(a.batch, a.h, a.wd);
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const Tile tl = tile_at(tile, a);
    const float* Xb = X + static_cast<long long>(tl.b) * a.h * a.wd * a.cin;
    __syncthreads();
    for (int i = tid; i < (kRows + 2) * kWinW * a.cin; i += kThreads) {
      const int ci = i % a.cin, p = i / a.cin;
      const int iy = resolve(tl.y0 - 1 + p / kWinW, a.h, a.mode);
      const int ix = resolve(tl.x0 - 1 + p % kWinW, a.wd, a.mode);
      win[p * CP + ci] = iy >= 0 && ix >= 0 ? Xb[(static_cast<long long>(iy) * a.wd + ix) * a.cin + ci] : 0.f;
    }
    __syncthreads();

    float acc[COUTP];
#pragma unroll
    for (int co = 0; co < COUTP; ++co) acc[co] = 0.f;
    for (int tap = 0; tap < 9; ++tap) {
      const float* xp = win + ((r + tap / 3) * kWinW + c + tap % 3) * CP;
      const float* wp = wts + tap * a.cin * COUTP;
      for (int ci = 0; ci < a.cin; ++ci) {
        const float xv = xp[ci];
#pragma unroll
        for (int co = 0; co < COUTP; co += 4) {
          const float4 wv = *reinterpret_cast<const float4*>(wp + ci * COUTP + co);
          acc[co] = fmaf(xv, wv.x, acc[co]);
          acc[co + 1] = fmaf(xv, wv.y, acc[co + 1]);
          acc[co + 2] = fmaf(xv, wv.z, acc[co + 2]);
          acc[co + 3] = fmaf(xv, wv.w, acc[co + 3]);
        }
      }
    }
    const int y = tl.y0 + r, x = tl.x0 + c;
    if (y < a.h && x < a.wd) {
      float* O = static_cast<float*>(a.o) + ((static_cast<long long>(tl.b) * a.h + y) * a.wd + x) * a.cout;
#pragma unroll
      for (int co = 0; co < COUTP; ++co)
        if (co < a.cout) O[co] = acc[co] + (B ? B[co] : 0.f);
    }
  }
}

// grid-stride blocks: as many as fit on the card at once, at most one a tile
template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, const ConvArgs& a, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long ntiles = num_tiles(a.batch, a.h, a.wd);
  const int grid = static_cast<int>(ntiles < static_cast<long long>(sms) * per_sm ? ntiles : sms * per_sm);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int CINP>
cudaError_t launch_bf16(const ConvArgs& a, cudaStream_t s) {
  if (a.cout <= 8) return launch(conv3x3_bf16<CINP, 8>, Bf16Layout<CINP, 8>::smem_bytes, a, s);
  if (a.cout <= 16) return launch(conv3x3_bf16<CINP, 16>, Bf16Layout<CINP, 16>::smem_bytes, a, s);
  return launch(conv3x3_bf16<CINP, 32>, Bf16Layout<CINP, 32>::smem_bytes, a, s);
}

template <int COUTP>
cudaError_t launch_simt(const ConvArgs& a, cudaStream_t s) {
  const int smem = (9 * a.cin * COUTP + (kRows + 2) * kWinW * (a.cin + 1)) * 4;
  return launch(conv3x3_simt<COUTP>, smem, a, s);
}

}  // namespace

// x (B, H, W, Cin), w (3, 3, Cin, Cout), bias (Cout) or null, o (B, H, W,
// Cout), all contiguous and of one type. Cin <= 64 (bf16: a multiple of 8,
// for 16-byte copies), Cout <= 32; reflect needs H, W >= 2.
extern "C" int ud_conv3x3_fwd(const void* x, const void* w, const void* bias, void* o, int batch,
                              int h, int w_, int cin, int cout, int mode, int dtype, void* stream) {
  if (batch < 1 || h < 1 || w_ < 1 || cin < 1 || cin > 64 || cout < 1 || cout > 32) return cudaErrorInvalidValue;
  if (mode < kZeros || mode > kReplicate || (mode == kReflect && (h < 2 || w_ < 2))) return cudaErrorInvalidValue;
  const ConvArgs a{x, w, bias, o, batch, h, w_, cin, cout, mode};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ud::kBFloat16) {
    if (cin % 8) return cudaErrorInvalidValue;
    if (cin <= 16) return launch_bf16<16>(a, s);
    if (cin <= 32) return launch_bf16<32>(a, s);
    return launch_bf16<64>(a, s);
  }
  if (dtype != ud::kFloat32) return cudaErrorInvalidValue;
  if (cout <= 4) return launch_simt<4>(a, s);
  if (cout <= 8) return launch_simt<8>(a, s);
  if (cout <= 16) return launch_simt<16>(a, s);
  return launch_simt<32>(a, s);
}
