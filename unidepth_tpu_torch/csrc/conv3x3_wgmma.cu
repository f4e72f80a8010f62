// 3x3 stride-1 "same" convolution for few output channels on Hopper: wgmma
// fed by a TMA ring of input rows, bf16 NHWC in and out.
//
// Replaces, for bf16 with Cin a multiple of 8 up to 64 and Cout a multiple
// of 8 up to 32 (the V2 heads' hr convs: ViT-L/14 64 -> 32, ViT-B/14 48 ->
// 32, ViT-S/14 32 -> 32), the TPU Pallas kernel conv3x3_lowchannel
// (_conv3x3_fwd / _kernel, unidepth_tpu/ops/conv_kernels.py): x (B, H, W,
// Cin), w (3, 3, Cin, Cout) HWIO, optional bias, zeros / reflect /
// replicate padding, fp32 accumulation, output in x's type with the bias
// added in that type. fp32 and the other bf16 shapes keep conv3x3.cu.
//
// What bounds it on the H100: memory, closely followed by the products. At
// (8, 518, 518, 64 -> 32) a call reads x once (274.8 MB) and writes the
// output once (137.4 MB): 0.123 ms at 3.35 TB/s, against 79.1 GFLOP, 0.080
// ms at the dense bf16 peak. So the design reads x about once (1.03x: two
// halo rows per ~280 output rows) and keeps the tensor cores fed.
//
// Design:
//  * work: the B x ceil(W / 64) strips of 64 output pixels (one wgmma M),
//    each H rows tall, laid end to end (image, strip, row) and cut into one
//    equal share of rows per consumer warpgroup: one block an SM, two
//    consumer warpgroups a block, persistent. A share is a segment or two
//    of consecutive rows of one strip; a segment of R output rows reads R +
//    2 input rows.
//  * the producer warpgroup gives each consumer warpgroup one thread that
//    streams the input rows of its segments through its own ring of 6 row
//    slots (full / empty mbarriers): 66 pixels (x0 - 1 .. x0 + 64) of 64
//    channels in the 128-byte swizzle, one 4-D TMA box, channels past Cin
//    and pixels outside the image filled with zeros by TMA. The row padding
//    is the TMA row coordinate (-1 -> 1 reflect, 0 replicate; H -> H - 2,
//    H - 1; zeros keeps -1 and H, which load as 0). No padded copy of x is
//    written.
//  * each consumer warpgroup, for input row r and shift dx, loads the A
//    fragment of 64 shifted pixels from the swizzled slot with ldmatrix
//    (per-lane row addresses, so any shift reads without bank conflicts;
//    the column pad of reflect / replicate is a per-lane redirect to pixel
//    1 / 0 or W - 2 / W - 1 of the same slot). One wgmma m64n{3 Cout}k16, A
//    from registers, per dx and 16 channels adds the three dy taps into the
//    accumulators of output rows r + 1, r and r - 1. A row is 3 ceil(Cin /
//    16) wgmmas (12 at Cin 64), each A fragment read once for three taps:
//    the Hopper form of the TPU kernel's tap stacking.
//  * the three accumulators stay in one fixed order, the operand list of
//    every wgmma (a wgmma's accumulators are one run of registers; rotating
//    them through the operand list made ptxas move them and serialize the
//    wgmmas). The rows' roles rotate through the weights instead: for each
//    dx the block stages the taps as five Cout-row blocks, dy = 0, 1, 2, 0,
//    1 ([dx][5 Cout][cin], K-major in the 128-byte swizzle), and row r
//    reads the three blocks from (r - y0 + 1) % 3 on, so each accumulator
//    gets the tap of the output row it holds. The row loop is unrolled by 3.
//  * after row r, output row r - 1 is complete: bf16(bf16(acc) + bias),
//    staged in shared memory (a buffer a warpgroup, the last store's read
//    of it awaited first) and written by one TMA store of 64 pixels x Cout,
//    which clips the ragged last strip. The other consumer warpgroup's
//    products run meanwhile. A row's slot is released once the products
//    that read its fragments are done, as a CUTLASS pipeline releases it.
//
// The V2 heads' high-resolution tail (``DepthHead._hr_head``: this conv at
// Cout 32, LeakyReLU, a 1x1 conv to one channel) runs as the same kernel
// with a second epilogue (``ud_conv3x3_head_hopper_fwd``; no TPU kernel: the
// JAX package leaves the head to XLA). A complete row's pixels are
// bf16(bf16(acc) + bias) as above, then LeakyReLU rounded to bf16, then
// their dot with the 1x1 weights in fp32 (a pixel's Cout columns lie in the
// four lanes of a quad: Cout / 4 FMAs a lane and two shuffles), then
// bf16(bf16(dot) + 1x1 bias): the rounding points of the bf16 modules. The
// 64 bf16 values of the row go straight to global memory (a box of one
// channel is too narrow for TMA), so the (B, H, W, Cout) map is never
// written: at (8, 518, 518, 64 -> 32 -> 1) the kernel reads 274.8 MB and
// writes 4.3 MB, a bound of 0.083 ms.

#include <limits.h>

#include "common.cuh"

namespace {
namespace conv {

using bf16 = __nv_bfloat16;

enum PadMode : int { kZeros = 0, kReflect = 1, kReplicate = 2 };

constexpr int kPx = 64;                        // output pixels a strip: one wgmma M
constexpr int kSlotPx = kPx + 2;               // input pixels a row slot holds: x0 - 1 .. x0 + 64
constexpr uint32_t kRowBytes = kSlotPx * 128;  // what TMA writes into a slot
constexpr int kSlotBytes = 9 * 1024;           // rounded up to the swizzle's 1024-byte period
constexpr int kStages = 6;                     // row slots a consumer warpgroup
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kMaxSmem = 232448;

template <int CO>
struct alignas(1024) Smem {
  unsigned char in[kConsumers][kStages][kSlotBytes];
  bf16 w[3][5 * CO * 64];           // [dx][(dy = 0, 1, 2, 0, 1) x CO][64 channels], swizzled
  bf16 out[kConsumers][kPx * CO];  // output staging, [pixel][co]
  uint64_t full[kConsumers][kStages], empty[kConsumers][kStages];
};

// d0, d1, d2 (64 x CO each, f32) += A(64 x 16, bf16, registers) B(16 x 3 CO):
// wgmma m64n{3 CO}k16 with B K-major in shared memory (128-byte swizzle), its
// columns the dy = 0, 1, 2 taps. Accumulator element i of thread (warp w,
// lane 4g + t): row 16w + g + 8 * ((i / 2) & 1), column 8 * (i / 4) + 2t +
// (i & 1) of its tap; A's fragment as in attention_wgmma.cuh.
template <int CO>
__device__ __forceinline__ void wgmma_taps(float (&d0)[CO / 2], float (&d1)[CO / 2], float (&d2)[CO / 2],
                                           const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_taps<8>(float (&d0)[4], float (&d1)[4], float (&d2)[4],
                                               const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, %16, p, 1, 1, 0;\n}\n"
      :
        "+f"(d0[0]), "+f"(d0[1]), "+f"(d0[2]), "+f"(d0[3]), "+f"(d1[0]), "+f"(d1[1]), "+f"(d1[2]), "+f"(d1[3]),
        "+f"(d2[0]), "+f"(d2[1]), "+f"(d2[2]), "+f"(d2[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_taps<16>(float (&d0)[8], float (&d1)[8], float (&d2)[8],
                                               const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      :
        "+f"(d0[0]), "+f"(d0[1]), "+f"(d0[2]), "+f"(d0[3]), "+f"(d0[4]), "+f"(d0[5]), "+f"(d0[6]), "+f"(d0[7]),
        "+f"(d1[0]), "+f"(d1[1]), "+f"(d1[2]), "+f"(d1[3]), "+f"(d1[4]), "+f"(d1[5]), "+f"(d1[6]), "+f"(d1[7]),
        "+f"(d2[0]), "+f"(d2[1]), "+f"(d2[2]), "+f"(d2[3]), "+f"(d2[4]), "+f"(d2[5]), "+f"(d2[6]), "+f"(d2[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_taps<24>(float (&d0)[12], float (&d1)[12], float (&d2)[12],
                                               const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35}, "
      "{%36, %37, %38, %39}, %40, p, 1, 1, 0;\n}\n"
      :
        "+f"(d0[0]), "+f"(d0[1]), "+f"(d0[2]), "+f"(d0[3]), "+f"(d0[4]), "+f"(d0[5]), "+f"(d0[6]), "+f"(d0[7]),
        "+f"(d0[8]), "+f"(d0[9]), "+f"(d0[10]), "+f"(d0[11]), "+f"(d1[0]), "+f"(d1[1]), "+f"(d1[2]), "+f"(d1[3]),
        "+f"(d1[4]), "+f"(d1[5]), "+f"(d1[6]), "+f"(d1[7]), "+f"(d1[8]), "+f"(d1[9]), "+f"(d1[10]), "+f"(d1[11]),
        "+f"(d2[0]), "+f"(d2[1]), "+f"(d2[2]), "+f"(d2[3]), "+f"(d2[4]), "+f"(d2[5]), "+f"(d2[6]), "+f"(d2[7]),
        "+f"(d2[8]), "+f"(d2[9]), "+f"(d2[10]), "+f"(d2[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_taps<32>(float (&d0)[16], float (&d1)[16], float (&d2)[16],
                                               const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      :
        "+f"(d0[0]), "+f"(d0[1]), "+f"(d0[2]), "+f"(d0[3]), "+f"(d0[4]), "+f"(d0[5]), "+f"(d0[6]), "+f"(d0[7]),
        "+f"(d0[8]), "+f"(d0[9]), "+f"(d0[10]), "+f"(d0[11]), "+f"(d0[12]), "+f"(d0[13]), "+f"(d0[14]), "+f"(d0[15]),
        "+f"(d1[0]), "+f"(d1[1]), "+f"(d1[2]), "+f"(d1[3]), "+f"(d1[4]), "+f"(d1[5]), "+f"(d1[6]), "+f"(d1[7]),
        "+f"(d1[8]), "+f"(d1[9]), "+f"(d1[10]), "+f"(d1[11]), "+f"(d1[12]), "+f"(d1[13]), "+f"(d1[14]), "+f"(d1[15]),
        "+f"(d2[0]), "+f"(d2[1]), "+f"(d2[2]), "+f"(d2[3]), "+f"(d2[4]), "+f"(d2[5]), "+f"(d2[6]), "+f"(d2[7]),
        "+f"(d2[8]), "+f"(d2[9]), "+f"(d2[10]), "+f"(d2[11]), "+f"(d2[12]), "+f"(d2[13]), "+f"(d2[14]), "+f"(d2[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

struct Segment {
  int b, x0, y0, y1;  // image, first pixel of the strip, output rows [y0, y1)
};

// the head's epilogue: LeakyReLU, then the 1x1 conv to one channel into o
// (B, H, W); o null stores the conv's (B, H, W, Cout) map through TMA instead
struct Head {
  const bf16* w1;  // (Cout) 1x1 weights
  const bf16* b1;  // (1) 1x1 bias, or null
  bf16* o;
  float slope;     // LeakyReLU's negative slope
};

// the first segment of the rows [lo, hi) in (image, strip, row) order
__device__ __forceinline__ Segment segment_at(long long lo, long long hi, int h, int strips) {
  const long long col = lo / h;
  const int y0 = static_cast<int>(lo - col * h);
  const int y1 = static_cast<int>(hi - lo < h - y0 ? y0 + (hi - lo) : h);
  return {static_cast<int>(col / strips), static_cast<int>(col % strips) * kPx, y0, y1};
}

// the share of consumer warpgroup `unit` (of `units`): rows [first, last)
__device__ __forceinline__ void share(long long total, int unit, int units, long long& first, long long& last) {
  first = total * unit / units;
  last = total * (unit + 1) / units;
}

template <int CO, int KS>
struct Consumer {
  Smem<CO>& sm;
  const CUtensorMap* to;
  int wg, tid;              // this warpgroup, and the thread within it
  uint64_t wdesc[3];        // the dx tap blocks' first rows
  uint32_t off[3], key[3];  // this lane's A row for each dx: byte offset and swizzle phase in a slot
  float bz[CO / 4];         // the bias at this thread's columns
  float hw[CO / 4], hb;     // the head's 1x1 weights at this thread's columns, and its bias
  Head head;
  int ring, h, wd;

  // the slot pixel each dx reads for this lane (pixel x0 - 1 + p of the image),
  // redirected for the column pad of reflect and replicate
  __device__ __forceinline__ void aim(const Segment& sg, int wd, int mode) {
    const int warp = tid / 32, lane = tid % 32;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      int x = sg.x0 - 1 + 16 * warp + (lane & 15) + dx;
      if (mode != kZeros && x == -1) x = mode == kReflect ? 1 : 0;
      if (mode != kZeros && x == wd) x = mode == kReflect ? wd - 2 : wd - 1;
      const int p = x - (sg.x0 - 1);
      off[dx] = p * 128;
      key[dx] = p & 7;
    }
  }

  // input row r of the segment: its taps, the weight blocks from `shift` on,
  // into a0, a1, a2; then `done` (one of them, output row r - 1) is complete,
  // stored and cleared
  __device__ __forceinline__ void row(float (&a0)[CO / 2], float (&a1)[CO / 2], float (&a2)[CO / 2],
                                      float (&done)[CO / 2], int shift, const Segment& sg, int r) {
    const int st = ring % kStages;
    ud::mbar_wait(&sm.full[wg][st], (ring / kStages) & 1);
    const unsigned char* slot = sm.in[wg][st];
    const int half = (tid % 32) >> 4;
    uint32_t af[3][KS][4];
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ud::ldmatrix_x4(af[dx][kk], slot + off[dx] + (((2 * kk + half) ^ key[dx]) << 4));
    const uint64_t shift_desc = (shift * CO * 128) >> 4;  // the descriptor's address is in 16-byte units
    ud::wgmma_fence();
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) wgmma_taps<CO>(a0, a1, a2, af[dx][kk], wdesc[dx] + shift_desc + 2 * kk);
    ud::wgmma_commit();
    ud::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < CO / 2; ++i) {
      ud::reg_fence(a0[i]);
      ud::reg_fence(a1[i]);
      ud::reg_fence(a2[i]);
    }
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) ud::reg_fence(af[dx][kk][i]);
    // the products that read the fragments are done: the slot may be refilled
    ud::mbar_arrive(&sm.empty[wg][st]);
    ++ring;
    const int y = r - 1;
    if (y >= sg.y0 && y < sg.y1) store(done, sg, y);
#pragma unroll
    for (int i = 0; i < CO / 2; ++i) done[i] = 0.f;
  }

  __device__ __forceinline__ void store(const float (&acc)[CO / 2], const Segment& sg, int y) {
    if (head.o) {
      store_head(acc, sg, y);
      return;
    }
    if (tid == 0) ud::tma_store_wait_read();  // the last store has read its buffer
    ud::named_barrier_sync(1 + wg, 128);
    bf16* ob = sm.out[wg];
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int r0 = warp * 16 + g;
#pragma unroll
    for (int j = 0; j < CO / 8; ++j) {
      const int col = 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(ob + r0 * CO + col) =
          ud::pack_bf16(ud::round_to<bf16>(acc[4 * j]) + bz[2 * j], ud::round_to<bf16>(acc[4 * j + 1]) + bz[2 * j + 1]);
      *reinterpret_cast<uint32_t*>(ob + (r0 + 8) * CO + col) = ud::pack_bf16(
          ud::round_to<bf16>(acc[4 * j + 2]) + bz[2 * j], ud::round_to<bf16>(acc[4 * j + 3]) + bz[2 * j + 1]);
    }
    ud::fence_proxy_async();
    ud::named_barrier_sync(1 + wg, 128);
    if (tid == 0) {
      ud::tma_store_3d(to, ob, 0, sg.x0, sg.b * h + y);
      ud::tma_store_commit();
    }
  }

  // output row y through the head: lane t of quad g holds columns 8j + 2t,
  // + 1 of pixels 16 warp + g and + 8; the quad's sums meet by two shuffles,
  // and lanes 0 and 1 of the quad store the two pixels
  __device__ __forceinline__ void store_head(const float (&acc)[CO / 2], const Segment& sg, int y) {
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < CO / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float v = ud::round_to<bf16>(ud::round_to<bf16>(acc[4 * j + i]) + bz[2 * j + (i & 1)]);
        v = v > 0.f ? v : ud::round_to<bf16>(v * head.slope);
        if (i < 2)
          s0 = fmaf(v, hw[2 * j + (i & 1)], s0);
        else
          s1 = fmaf(v, hw[2 * j + (i & 1)], s1);
      }
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    const int x = sg.x0 + 16 * warp + g + 8 * t;
    if (t < 2 && x < wd)
      head.o[(static_cast<long long>(sg.b) * h + y) * wd + x] =
          __float2bfloat16_rn(ud::round_to<bf16>(t == 0 ? s0 : s1) + hb);
  }
};

template <int CO, int KS>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_wgmma(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap to,
                  const bf16* __restrict__ w, const bf16* __restrict__ bias, Head head, int batch, int h, int wd,
                  int cin, int mode) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (1024u - (ud::smem_u32(smem_raw) & 1023u)) & 1023u;
  Smem<CO>& sm = *reinterpret_cast<Smem<CO>*>(smem_raw + pad);
  const int strips = (wd + kPx - 1) / kPx;
  const long long total = static_cast<long long>(batch) * strips * h;
  const int units = gridDim.x * kConsumers;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < kConsumers; ++c)
#pragma unroll
      for (int st = 0; st < kStages; ++st) {
        ud::mbar_init(&sm.full[c][st], 1);
        ud::mbar_init(&sm.empty[c][st], 128);
      }
    ud::fence_barrier_init();
  }
  // the weights, [dx][n = block * CO + co][ci] with block b holding dy = b % 3:
  // 16-byte chunk ci / 8 of row n at chunk (ci / 8) ^ (n % 8). Read in w's own
  // order (coalesced), then the channels past Cin zeroed
  for (int i = threadIdx.x; i < 9 * cin * CO; i += kThreads) {
    const int co = i % CO, ci = (i / CO) % cin, tap = i / (CO * cin), dy = tap / 3;
    const bf16 v = w[i];
#pragma unroll
    for (int blk = dy; blk < 5; blk += 3) {
      const int n = blk * CO + co;
      sm.w[tap % 3][n * 64 + (((ci >> 3) ^ (n & 7)) << 3) + (ci & 7)] = v;
    }
  }
  for (int i = threadIdx.x; i < 15 * CO * (64 - cin); i += kThreads) {
    const int row = i / (64 - cin), ci = cin + i % (64 - cin), n = row % (5 * CO);
    sm.w[row / (5 * CO)][n * 64 + (((ci >> 3) ^ (n & 7)) << 3) + (ci & 7)] = __float2bfloat16(0.f);
  }
  ud::fence_proxy_async();  // the weights, written here, are read by wgmma
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer warpgroup: lane 0 of warp c streams consumer c's rows ----
    ud::setmaxnreg_dec<40>();
    const int c = (threadIdx.x % 128) / 32;
    if (c < kConsumers && threadIdx.x % 32 == 0) {
      long long lo, last;
      share(total, blockIdx.x * kConsumers + c, units, lo, last);
      int ring = 0;
      while (lo < last) {
        const Segment sg = segment_at(lo, last, h, strips);
        lo += sg.y1 - sg.y0;
        for (int r = sg.y0 - 1; r <= sg.y1; ++r, ++ring) {
          const int st = ring % kStages;
          ud::mbar_wait(&sm.empty[c][st], ((ring / kStages) & 1) ^ 1);  // the first round passes at once
          int ry = r;
          if (mode != kZeros && r < 0) ry = mode == kReflect ? 1 : 0;
          if (mode != kZeros && r >= h) ry = mode == kReflect ? h - 2 : h - 1;
          ud::mbar_arrive_expect_tx(&sm.full[c][st], kRowBytes);
          ud::tma_load_4d(sm.in[c][st], &tx, &sm.full[c][st], 0, sg.x0 - 1, ry, sg.b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup wg ----
  ud::setmaxnreg_inc<232>();
  Consumer<CO, KS> cs{sm, &to, wg, static_cast<int>(threadIdx.x % 128)};
  cs.ring = 0;
  cs.h = h;
  cs.wd = wd;
  cs.head = head;
  cs.hb = head.b1 ? __bfloat162float(head.b1[0]) : 0.f;
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) cs.wdesc[dx] = ud::wgmma_desc_sw128(sm.w[dx]);
  const int t = cs.tid % 4;
#pragma unroll
  for (int j = 0; j < CO / 8; ++j) {
    cs.bz[2 * j] = bias ? __bfloat162float(bias[8 * j + 2 * t]) : 0.f;
    cs.bz[2 * j + 1] = bias ? __bfloat162float(bias[8 * j + 2 * t + 1]) : 0.f;
    cs.hw[2 * j] = head.o ? __bfloat162float(head.w1[8 * j + 2 * t]) : 0.f;
    cs.hw[2 * j + 1] = head.o ? __bfloat162float(head.w1[8 * j + 2 * t + 1]) : 0.f;
  }

  // before row r: a0, a1, a2 hold output rows r + 1, r, r - 1 at shift 0;
  // each row moves the roles one accumulator on, and the weights one block
  float a0[CO / 2], a1[CO / 2], a2[CO / 2];
  long long lo, last;
  share(total, blockIdx.x * kConsumers + wg, units, lo, last);
  while (lo < last) {
    const Segment sg = segment_at(lo, last, h, strips);
    lo += sg.y1 - sg.y0;
    cs.aim(sg, wd, mode);
#pragma unroll
    for (int i = 0; i < CO / 2; ++i) a0[i] = a1[i] = a2[i] = 0.f;
    for (int r = sg.y0 - 1; r <= sg.y1; r += 3) {
      cs.row(a0, a1, a2, a2, 0, sg, r);  // a0: r + 1 (dy 0), a1: r (dy 1), a2: r - 1 (dy 2)
      if (r + 1 > sg.y1) break;
      cs.row(a0, a1, a2, a1, 1, sg, r + 1);  // a0: r + 1 (dy 1), a1: r (dy 2), a2: r + 2 (dy 0)
      if (r + 2 > sg.y1) break;
      cs.row(a0, a1, a2, a0, 2, sg, r + 2);  // a0: r + 1 (dy 2), a1: r + 3 (dy 0), a2: r + 2 (dy 1)
    }
  }
  if (cs.tid == 0) ud::tma_store_wait_read();  // shared memory stays valid until read
}

// o is the (B, H, W, Cout) map, or, with head.o set, unused
template <int CO, int KS>
cudaError_t launch(const void* x, const void* w, const void* bias, void* o, const Head& head, int batch, int h,
                   int wd, int cin, int mode, cudaStream_t stream) {
  constexpr int kSmem = sizeof(Smem<CO>) + 1024;  // + room to align the base to 1024
  static_assert(kSmem <= kMaxSmem, "the ring does not fit in shared memory");
  CUtensorMap tx, to{};
  const cuuint64_t xd[4] = {cuuint64_t(cin), cuuint64_t(wd), cuuint64_t(h), cuuint64_t(batch)};
  const cuuint64_t xs[3] = {cuuint64_t(cin) * 2, cuuint64_t(wd) * cin * 2, cuuint64_t(h) * wd * cin * 2};
  const cuuint32_t xb[4] = {64, kSlotPx, 1, 1};
  const cuuint64_t od[3] = {CO, cuuint64_t(wd), cuuint64_t(batch) * h};
  const cuuint64_t os[2] = {CO * 2, cuuint64_t(wd) * CO * 2};
  const cuuint32_t ob[3] = {CO, kPx, 1};
  if (!ud::make_map(&tx, x, 4, xd, xs, xb, CU_TENSOR_MAP_SWIZZLE_128B) ||
      (!head.o && !ud::make_map(&to, o, 3, od, os, ob, CU_TENSOR_MAP_SWIZZLE_NONE)))
    return cudaErrorInvalidValue;
  auto kernel = conv3x3_wgmma<CO, KS>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, kSmem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = sms * per_sm;  // rows past the last are empty shares
  kernel<<<grid, kThreads, kSmem, stream>>>(tx, to, static_cast<const bf16*>(w), static_cast<const bf16*>(bias),
                                            head, batch, h, wd, cin, mode);
  return cudaGetLastError();
}

template <int CO>
cudaError_t launch_ks(const void* x, const void* w, const void* bias, void* o, const Head& head, int batch, int h,
                      int wd, int cin, int mode, cudaStream_t s) {
  switch ((cin + 15) / 16) {
    case 1: return launch<CO, 1>(x, w, bias, o, head, batch, h, wd, cin, mode, s);
    case 2: return launch<CO, 2>(x, w, bias, o, head, batch, h, wd, cin, mode, s);
    case 3: return launch<CO, 3>(x, w, bias, o, head, batch, h, wd, cin, mode, s);
    default: return launch<CO, 4>(x, w, bias, o, head, batch, h, wd, cin, mode, s);
  }
}

// the checks and the Cout dispatch both entries share
cudaError_t launch_co(const void* x, const void* w, const void* bias, void* o, const Head& head, int batch, int h,
                      int w_, int cin, int cout, int mode, void* stream) {
  if (batch < 1 || h < 1 || w_ < 1 || cin < 8 || cin > 64 || cin % 8 || cout < 8 || cout > 32 || cout % 8)
    return cudaErrorInvalidValue;
  if (mode < kZeros || mode > kReplicate || (mode == kReflect && (h < 2 || w_ < 2))) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16) return cudaErrorInvalidValue;
  if (static_cast<long long>(batch) * h > INT_MAX) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cout) {
    case 8: return launch_ks<8>(x, w, bias, o, head, batch, h, w_, cin, mode, s);
    case 16: return launch_ks<16>(x, w, bias, o, head, batch, h, w_, cin, mode, s);
    case 24: return launch_ks<24>(x, w, bias, o, head, batch, h, w_, cin, mode, s);
    default: return launch_ks<32>(x, w, bias, o, head, batch, h, w_, cin, mode, s);
  }
}

}  // namespace conv
}  // namespace

// K5's bf16 entry on Hopper: x (B, H, W, Cin), w (3, 3, Cin, Cout), bias
// (Cout) or null, o (B, H, W, Cout), all contiguous bf16. Cin and Cout
// multiples of 8, Cin <= 64, Cout <= 32; x and o 16-byte aligned (TMA);
// reflect needs H, W >= 2. The tensor maps are built here, on the host,
// for every call.
extern "C" int ud_conv3x3_hopper_fwd(const void* x, const void* w, const void* bias, void* o, int batch, int h,
                                     int w_, int cin, int cout, int mode, void* stream) {
  if (reinterpret_cast<uintptr_t>(o) % 16) return cudaErrorInvalidValue;  // the TMA store's
  return conv::launch_co(x, w, bias, o, conv::Head{nullptr, nullptr, nullptr, 0.f}, batch, h, w_, cin, cout, mode,
                         stream);
}

// The V2 heads' hr tail on the same body: the conv as above, then
// LeakyReLU(slope) and the 1x1 conv to one channel, w1 (Cout), b1 (1) or
// null; o (B, H, W) bf16, with no alignment asked of it. The same shapes
// as ud_conv3x3_hopper_fwd.
extern "C" int ud_conv3x3_head_hopper_fwd(const void* x, const void* w, const void* bias, const void* w1,
                                          const void* b1, void* o, int batch, int h, int w_, int cin, int cout,
                                          int mode, float slope, void* stream) {
  if (w1 == nullptr || o == nullptr) return cudaErrorInvalidValue;
  const conv::Head head{static_cast<const __nv_bfloat16*>(w1), static_cast<const __nv_bfloat16*>(b1),
                        static_cast<__nv_bfloat16*>(o), slope};
  return conv::launch_co(x, w, bias, nullptr, head, batch, h, w_, cin, cout, mode, stream);
}
