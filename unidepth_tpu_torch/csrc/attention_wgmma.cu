// Flash attention forward for Hopper on wgmma and TMA: softmax(scale * q k^T) v
// per (batch, head), bf16 I/O, head dim 64 (K3 also 32 and 48).
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
//   * K3, _flash_fwd / _flash_kernel (flash_attention): flat (BH, N, D)
//     tensors at D = 64, 48 (the ViT-B/14 V2 decoder) or 32 (ViT-S/14), a
//     map of BH batches of one head; Nq != Nk, and any number of keys (the
//     TPU kernel switches to a blocked online softmax past 4096; this body
//     streams every key tile through its online softmax anyway).
// fp32 I/O and the other head dims keep attention.cu's mma.sync body. At D
// = 32 and 48 the body keeps D = 64's tiles and shared-memory layout (see
// attention_wgmma.cuh): Q K^T runs D / 16 steps, P V is m64n{D}k16, and at
// (BH, 1369, 48) 176 work tiles per 16 heads fill the 132 SMs in 2 rounds.
//
// What bounds it on the H100: operations. At the ViT-L serving shape (B=8,
// N=1370, H=16, D=64) a call is 61.5 GFLOP against 45 MB of q/k/v/o, 0.062
// ms at the dense bf16 peak. At D = 64 the softmax's 2^x costs the SM's 16
// SFU lanes as many cycles as the two products cost its tensor cores, so
// the design keeps the tensor cores and the SFUs busy at once. The body is
// attention_wgmma.cuh's, shared with the A/B kernels K6/K7 (attention_ab.cu);
// this source instantiates its exact softmax (kExact: online row max, scale
// folded into the FFMA) on one head a work tile and a three-stage ring. At
// the serving shape: 11 x 16 x 8 = 1408 work tiles on 132 blocks (10.7
// each, so 11 rounds); one block an SM: 384 threads at 168 registers
// (ptxas, no spills; 240 for the consumers after setmaxnreg) and 133,120
// bytes of shared memory. The D = 64 instantiation, <kExact, 1, 3, 64>, is
// the main path's.

#include "attention_wgmma.cuh"

// K1's, K3's and K4's bf16 entry: the same arguments as ud_attention_fwd
// (element strides; head h at column h * D of each row). head_dim 64, or
// 32 and 48 with heads == 1 (K3's flat tensors). Needs 16-byte aligned base
// pointers, row and batch strides that are multiples of 8 elements, rows
// that hold all heads, and scale > 0 (the row max is taken on the raw
// scores). The tensor maps are built here, on the host, for every call.
extern "C" int ud_attention_hopper_fwd(const void* q, const void* k, const void* v, void* o, int batch,
                                       int heads, int nq, int nk, int head_dim, long long q_bs,
                                       long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                                       long long v_rs, long long o_bs, long long o_rs, float scale,
                                       int dtype, void* stream) {
  if (dtype != ud::kBFloat16) return cudaErrorInvalidValue;
  if (!(scale > 0.f) || !isfinite(scale)) return cudaErrorInvalidValue;
  const float sl2 = scale * hopper::kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return hopper::launch<kExact, 1, 3, 64>(q, k, v, o, batch, heads, nq, nk, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs,
                                              o_bs, o_rs, sl2, s);
    case 48:
      if (heads != 1) return cudaErrorInvalidValue;
      return hopper::launch<kExact, 1, 3, 48>(q, k, v, o, batch, heads, nq, nk, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs,
                                              o_bs, o_rs, sl2, s);
    case 32:
      if (heads != 1) return cudaErrorInvalidValue;
      return hopper::launch<kExact, 1, 3, 32>(q, k, v, o, batch, heads, nq, nk, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs,
                                              o_bs, o_rs, sl2, s);
    default:
      return cudaErrorInvalidValue;
  }
}
