#!/usr/bin/env python3
"""Smoke test of the PyTorch port (unidepth_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc. It
fails (non-zero exit, no result line) without CUDA or outside a checkout.

1. Prints the card's name and power limit, builds the CUDA kernels from
   ``unidepth_tpu_torch/csrc`` with nvcc, and prints what ptxas reported for
   the Hopper bodies (registers, spills): one line for each instantiation
   of attn_fwd_wgmma (the main path's, kExact on one head a work tile at
   head dim 64, is named; K3's at 48 and 32, K6's M1-M9 and K7's head
   pairs), ln_dense_wgmma and each conv3x3_wgmma<Cout, Cin / 16>.
2. One phase per kernel at the shapes its path gives it (K4: strided views
   of one (8, 1370, 3072) projection, 16 heads, scale 1/8; K3: the
   decoder's (64, 1369, 64); K2: M = 10960, C = 1024, F = 4096). In bf16
   I/O it runs the tensor-core kernels that the paths launch, the wgmma +
   TMA Hopper bodies (K1, K3 and K4 at head dim 64: attn_fwd_wgmma of
   attention_wgmma.cu; K2: ln_row_stats, then ln_dense_wgmma of
   ln_dense_wgmma.cu), checks that each bf16 call took its Hopper body, and
   holds them against the plain PyTorch
   version computed in fp32 on the same bf16 inputs: elementwise at rtol
   1.6e-2, atol 1e-2 (bf16 output rounding), and at a relative RMS error
   ||out - ref|| / ||ref|| <= 5e-3, which rounding alone keeps near 2e-3
   and a 2% error in the softmax denominator (the ragged-tile mask lost)
   exceeds. In fp32 I/O it runs the CUDA-core kernels of the same sources
   (attn_fwd_simt, ln_dense_simt), which the main path does not launch, at
   1e-4 (attention) and 2e-4 (ln_dense). It times kernel and plain version
   in bf16 (CUDA events around 10 back-to-back calls, median of 10 runs).
   After K2, its gated body (``ln_dense(..., 'swiglu')``, ViT-g/14's
   LN2 -> w12 -> silu(a) * g) at the v2-vitg14 cell's shape (10960, 1536,
   8192) on random x, w12, bias, gamma and beta: one gated launch, held
   elementwise at the bf16 gates to its plain version on the same bf16
   inputs and at the relative RMS gate to the plain version in fp32, timed
   beside the plain version and the modules it replaces, with bound and
   share (K2's record, ``gated``). Then K3 at the decoders' narrower head dims, on the Hopper body: ViT-B's
   (16, 1369, 48) at B = 2 and (64, 1369, 48) at B = 8, ViT-S's (64, 1369,
   32), each held at the bf16 gates and timed in two turns against the
   mma.sync body of attention.cu (its C entry called directly) and SDPA.
3. K5, then the kernels whose entry points are not a model path (K6, K7): K5
   conv3x3_lowchannel at the V2 heads' hr conv shape, (8, 518, 518, 64 ->
   32) reflect, in bf16 (the Hopper body, conv3x3_wgmma.cu) and fp32 like
   the others, then ViT-B's and ViT-S's hr convs (48 -> 32, 32 -> 32), and
   zeros, reflect and replicate padding at small ragged shapes, every bf16
   call with Cin and Cout multiples of 8 checked to run the Hopper body;
   the mma.sync body of conv3x3.cu at the hr shape, its C entry called
   directly, checked and timed in turns with the Hopper body
   (``mma_sync_ms``); then K5's entry alone (one call: 1 launch, on the
   Hopper body); then its fused head (``conv3x3_head``, the path of the V2
   heads' hr tails: 64 -> 32, LeakyReLU, 1x1 to one channel) at the hr
   shape, held to its plain version and to the bf16 modules, timed beside
   the modules the model ran before it (F.pad reflect, cuDNN's conv,
   LeakyReLU, the 1x1 conv: its ``library_ms``). Then K2h (``head_mlp``,
   the V2 heads' LayerNorm -> Linear pair, both heads in one launch) at the
   518x518 latents (8, 128, 296, 296) NCHW -> 2 x (8, 296, 296, 128), each
   head held to ``ln_dense_plain`` at the bf16 gates, its device operation
   read from a profiler trace (one ``head_mlp_wgmma``, a name none of the
   benchmark's roofline readers counts), timed beside its plain version and
   the modules it replaces (per head: fp32 LayerNorm, bf16 cast, cuBLAS
   linear), with bound and share (record ``head_mlp``). K6, the A/B harness of
   scripts_torch/kernel_ab.py over ``base`` and one name per family M1-M9,
   and K7, the harness over ``bd`` and ``bd_lmxu``, at (8, 1370, 16 x 64)
   bf16, each variant held against its plain version in fp32 at the bf16
   gates, the elementwise atol scaled by max(1, max |ref|) for the
   unnormalised families (relative RMS alone for ``noexp``, ~1e31); the
   harness run is the path whose launches are counted, and every K6 and
   K7 call in it must run the Hopper body. Beside them, the mma.sync body
   that K6 (M1, M3) and K7 ran at head dim 64 before, its C entry called
   directly, held at the same gates and timed (``mma_sync_ms``). Before
   them, head dim 8 of K3 and K4 in bf16 and fp32. ``library_ms`` is one
   PyTorch call computing the
   same function on the same data, timed as a yardstick and never called
   by the port: ``F.scaled_dot_product_attention`` for K1, K3, K4, K6 (M1)
   and K7,
   ``F.conv2d`` (cuDNN, channels-last bf16, on the padded input) for K5;
   for K2, where no one call computes it, ``F.layer_norm -> F.linear ->
   F.gelu`` composed in bf16 (three calls; the record's ``library`` says
   which yardstick each kernel has).
   ``bound_ms`` is the larger of the bytes moved over 3.35 TB/s and the
   operations over 989 TFLOP/s (bf16 dense, H100 SXM).
4. Builds UniDepthV2 ViT-L/14 from configs/config_v2_vitl14.json with no
   device named (the entry point's default: the card, bf16) and random
   weights (``init_params(seed=0)``), runs ``infer()`` on 8 seeded
   518x518 images, checks shapes, finiteness and depth > 0, checks
   that the forward launched K1 (flash_attention_qkv) 24 times, K2
   (ln_dense) 24 times, K3 (flash_attention) 4 times, K5 (the fused heads)
   twice, each of them on its Hopper body, K2h (both heads' MLPs) once,
   and K4 never, and
   holds depth against the same model run on the plain path in fp32 on the
   card (median relative error <= 1e-2). Then times depth-only ``infer()``
   in three rounds and prints each.
5. The int8 serving path on the same model: ``set_serving_precision('int8')``
   quantizes the encoder from the fp32 masters that ``init_params`` kept,
   then ``infer()`` on the same images: shapes, finiteness and depth > 0;
   launches K4 (flash_attention_packed) 24, K1 0, K2 0, K3 4, K5 2, K3, K4
   and K5 on the Hopper body; depth against
   the fp32 plain path at the JAX package's int8 bounds (mean relative
   error < 0.05, 99th percentile < 0.15, intrinsics relative error < 0.1,
   tests/test_quant.py). Then one forward under the stage mask (True, False,
   True, False): launches K4 12, K1 12, K2 12, K3 4, K5 2, every one on the
   Hopper body. Then times int8 depth-only ``infer()`` in three rounds.
6. Builds UniDepthV2 ViT-B/14 from configs/config_v2_vitb14.json the same
   way (12 blocks, C = 768, 12 heads of 64; decoder hidden 384, 8 heads of
   48), runs ``infer()`` on the first 2 images: shapes, finiteness, depth
   > 0; launches K1 12, K2 12, K3 4 (head dim 48), K5 2 (hr Cin 48), each
   on its Hopper body, K4 never; depth against the fp32 plain path at the
   ViT-L gate (median relative error <= 1e-2). Then times depth-only ``infer()`` at B
   = 8 in three rounds.
7. UniDepthV2 ViT-S/14 from configs/config_v2_vits14.json the same way (12
   blocks, C = 384, 6 heads of 64; decoder hidden 256, 8 heads of 32):
   launches K1 12, K2 12, K3 4 (head dim 32), K5 2 (hr Cin 32), each on
   its Hopper body, K4 never; the same checks and timing as ViT-B.
8. UniDepthV1 from configs/config_v1_vitl14.json (DINOv2 ViT-L/14, max_cls
   stacking, the offset-0.1 pos-embed; decoder hidden 512, depths (3, 2,
   1)) and configs/config_v1_cnvnxtl.json (ConvNeXt-L, the same decoder),
   each built with no device named and random weights, ``infer()`` on 8
   seeded uint8 462x616 images: depth, points and intrinsics of the right
   shapes, finite, depth > 0; launches K1 24, K2 30, K3 3 (ViT-L) and K2
   42, K3 3 (ConvNeXt-L), each on its Hopper body, K4 never; the first 2
   images' depth against the fp32 plain path at B = 2 at the V1 gate
   (median relative error <= V1_DEPTH_GATE, set from the JAX package's own
   bf16 drift, PERF.md section 2); images/s at B = 8. Before the models, K2
   at ConvNeXt-L's four stage shapes and the V1 decoder's three CvnxtBlock
   shapes (eps 1e-5), K1 at 1453 tokens and K3 at (64, 1452, 64) and (64,
   1064, 64), in bf16 on their Hopper bodies, held to their plain versions
   at the bf16 gates and timed beside their library calls, with bound and
   share; these join K1's, K2's and K3's records, as do the V1 paths'
   launch counts.

9. UniDepthV2old from configs/config_v2old_vitl14.json (DINOv2 ViT-L/14,
   'last' stacking of blocks 21-24 with the final norm; decoder hidden 512,
   depths (6, 0, 0), 8 heads), built with no device named and random weights
   (``init_params(seed=0)``), ``infer()`` on 8 seeded uint8 480 x 640
   images, which its token budget resizes to 588 x 784 (42 x 56 patches +
   cls = 2353 tokens). Before the model, the kernels at its new shapes on
   their Hopper bodies, held to their plain versions at the bf16 gates and
   timed beside their library calls, with bound and share: K1 at (8, 2353,
   16 x 64), K4 on the views of an (8, 2353, 3072) projection, and K2 at the
   encoder's M = 18824 (C 1024, F 4096) and the upsamplers' CvnxtBlocks
   (M = 18816, 75264 and 301056 at C = 512, 256 and 128). Then bf16
   ``infer()``: depth, confidence, points and intrinsics of the right shapes
   and finite, depth > 0, confidence in [0, 1]; launches K1 24, K2 30 (24
   encoder blocks + 6 CvnxtBlocks), K3 0, K4 0, all on the Hopper bodies;
   depth against the fp32 plain path (median relative error <=
   V2OLD_DEPTH_GATE, set from the JAX package's own bf16 drift,
   tests/v2old_bf16_drift.py, PERF.md section 2); images/s. Then blanket
   int8 (V2old needs no calibration): launches K4 24, K2 6, K1 0, K3 0, on
   the Hopper bodies; depth and intrinsics against the same fp32 plain path
   at the int8 gates; images/s. The phase prints its seconds; its records
   join K1's, K2's and K4's (``v2old``, ``v2old_launches``).

10. The kernels' gradients, then V2 training. K1 at (8, 1531, 16 x 64), K2
   at M = 12248 (C 1024, F 4096), K3 at (64, 1530, 64) (the training path's
   shapes, 476 x 630) and K4 on the views of an (8, 1370, 3072) projection
   (its int8 path): each kernel route's gradients (a random cotangent; the
   launch forward on the Hopper body, the plain VJP backward, which
   launches nothing) against the plain version's autograd in fp32 on the
   same bf16 inputs at the bf16 gates (the elementwise atol scaled by
   max(1, max |ref|): a gradient sums over rows), and the backward timed;
   these join
   the kernels' records as ``grad``. Then UniDepthV2 ViT-L/14 from
   configs/config_v2_vitl14.json through ``build_trainer`` with no device
   named (bf16 model, fp32 masters, moments and EMA on the card, random
   weights from ``init_params(seed=0)``) and its training section (the five
   losses, AdamW with its schedules, clipping 1.0, EMA every 10 steps), one
   seeded ``collate``d Dummy batch of 2 x 8 images at 476 x 630:
   (a) one micro-batch of its first 2 images, no update, on the kernel path
   (K1 48, K2 48, K3 4: forward and the blocks' recompute, all on the
   Hopper bodies) against the same weights on the fp32 plain path (no
   launch): each loss slot's relative drift <= TRAIN_LOSS_GATE, each
   parameter's gradient cosine >= TRAIN_COSINE_GATE (PERF.md section 2,
   from tests/train_bf16_drift.py), and no gradient exactly where the fp32
   path has none (the camera head: the given rays replace its prediction);
   (b) one optimizer step: launches K1 96, K2 96, K3 8, all on the Hopper
   bodies, K4 0 (``train_launches`` in the record); finite loss slots and
   grad_norm; every parameter but the camera head's with a finite, non-zero
   gradient (read from its first Adam moment) and moved; (c) 4 more steps
   on the same batch: the total loss of step 5 below step 1, the EMA shadow
   unmoved (it moves every 10th update), and after ``sync_model`` the int8
   path's fp32 masters are the trained weights; (d) ms per step (median of
   steps 3-5, host clock around a synchronize), images/s (16 a step) and
   the peak of ``torch.cuda.max_memory_allocated``, beside the card's name
   and power limit; (e) one validation under the EMA shadow after the steps
   (``Trainer.validate``, 8 Dummy images at 476 x 630): K1 24, K2 24, K3 4,
   K5 2 (the heads; none in the steps, under autograd) on the Hopper
   bodies, finite metrics, and the live bf16 weights and the fp32 masters
   bitwise what they were before it. A ``{"train": ...}`` line
   carries the figures.

11. Evaluation (configs/config_v2_vitl14.json, random weights). (a) The six
   camera models on the card, B = 8 seeded cameras each at 518 x 518 in
   fp32: ``get_rays`` against the port's CPU result (atol RAY_ATOL on unit
   rays) and ``project(unproject(uv))`` against the CPU's and against uv
   (atol ROUND_TRIP_ATOL pixels); a mixed ``BatchCamera`` of all 48 equals
   its members run one type at a time, bit for bit. (b) ``infer()`` of 8
   seeded 518 x 518 images prompted by a mixed ``BatchCamera`` (Pinhole,
   Fisheye624, OpenCV, MEI, two each): K1 24, K2 24, K3 4, K5 2 on the
   Hopper bodies; depth against the fp32 plain path (median relative error <=
   1e-2); images/s. Then the 6-view surround, six pinhole cameras in one B =
   6 batch: the same launches, finite outputs, rays that differ between
   views. (c) ``validate()`` with the 3-D metrics on Dummy at 476 x 630, B =
   8, 4 batches: every key of DEPTH_METRICS plus chamfer and F1, finite; K1
   24, K2 24, K3 4, K5 2 a batch on the Hopper bodies; ms a batch (host clock,
   second run); on one batch's depth maps the card's depth metrics against
   the CPU's (rtol EVAL_CPU_RTOL; the metrics that count pixels within one
   pixel a sample; the ssi-rescaled ones at SSI_CPU_TOL), and ``eval_3d`` on two samples' clouds
   (strided again by 2, so the CPU takes them) against the CPU's (Chamfer
   rtol 1e-4, F1 atol 1e-3: the squared distances' float32 cancellation,
   summed in another order); a perfect prediction's depth metrics (d1 1,
   arel 0) and 3-D metrics (Chamfer within the float32 cancellation, F1 at
   the formula's maximum, (T - 1) / T for T thresholds); ``eval_3d``'s ms a
   batch. (d) ``scripts_torch/eval.py --dummy-data --eval-3d --max-iters 2``
   and ``scripts_torch/demo.py`` (random weights) as subprocesses on the
   card, at once with item 14's (``cli_phase``, after item 13): both exit
   0, the eval's metrics finite, the demo prints an ARel. A ``{"eval":
   ...}`` line carries the figures; K1-K3's records gain
   ``eval_launches``.

12. Training of the other families, each through the train phase of item
   10 with its own config, recipe and gates (``TRAIN_FAMILIES``), run right
   after V2's: before them the kernels' gradients at the V1 training shapes
   (K1 at (8, 1453, 16 x 64), K2 at ConvNeXt-L's C = 1536 and C = 192, K3
   at (64, 1452, 64)), joining the records as ``grad_v1`` and
   ``grad_cnvnxtl_stage{3,0}``. UniDepthV1 ViT-L/14 and ConvNeXt-L from
   configs/config_v1_{vitl14,cnvnxtl}.json at 462 x 616 with V1's loss
   slots (depth, camera, invariance), and UniDepthV2old ViT-L/14 from
   configs/config_v2old_vitl14.json at 476 x 630 with V2's five, 8 x 2
   images a step: (a) the micro-batch of 2 against the fp32 plain path at
   the family's gates (PERF.md section 2, from
   tests/train_families_bf16_drift.py: the loss slots' drift, the smallest
   and the median gradient cosine), no gradient where the fp32 path has
   none (V1: every parameter has one; V2old: the camera head has none) and
   V2old's shift-invariant biases, whose gradient is rounding noise on both
   paths, held to neither cosine; launches a micro-batch: V1 ViT-L K1 48, K2
   54 (24 + 24 recompute + 6 CvnxtBlocks), K3 3; V1 ConvNeXt-L K2 78 (36 +
   36 + 6), K3 3; V2old K1 48, K2 54; all on the Hopper bodies; (b) one
   optimizer step at twice those, which moves the weights against its
   gradient (g . (p1 - p0) < 0, checked for V2 too; a weight that did not
   move must have had an update under half its float32 spacing); (c) 4
   more steps: finite totals (V1's and V2old's rise over their first steps
   at random weights, V1's in the JAX package's own trainer too,
   tests/train_trajectory.py), the EMA unmoved; (d) ms a step, images/s and
   peak memory. A ``{"train": ...}``
   line carries every family's figures; K1-K3's records gain
   ``family_train_launches``.

13. UniDepthV1 ViT-L/14 int8 (configs/config_v1_vitl14.json, random
   weights): ``set_serving_precision('int8')`` refused before calibration;
   ``calibrate_int8_stages`` on 2 seeded 462 x 616 images at the default
   budget 0.05 (its per-stage errors and mask printed, ``rel_err`` <= 0.05);
   ``infer()`` of 8 other seeded images under the mask: K4 once a block of
   the selected stages, K1 once and K2 once a block of the others, K2 also
   6 (CvnxtBlocks), K3 3, all on the Hopper bodies; depth and intrinsics
   against the fp32 plain path at V1_INT8_GATES (from the JAX package's own
   V1 int8 drift under its calibrated mask); images/s in int8 and in bf16
   from the same call. A ConvNeXt-L V1 refuses int8. K1-K4's records gain
   ``v1_int8_launches``.
14. ``scripts_torch/train.py --config-file configs/config_v1_cnvnxtl.json
   --dummy-data --steps 2`` as a subprocess on the card, at once with item
   11's eval and demo scripts (three processes share the card; their
   seconds are the group's): exit 0, a finite
   JSON line a step, its MetricLogger JSONL stream and one artifact PNG
   (read back). A ``{"v1_int8": ..., "train_cli": ...}`` line carries the
   figures.
15. The data layer (``data_phase``). (a) Synthetic shards of KITTI (375 x
   1242, its pre-crop and per-date intrinsics, 16-bit depth), NYUv2Depth
   (480 x 640, 24-bit packed depth) and ARKit (480 x 640, a sequence row),
   DATA_SAMPLES each from ``datasets/synthetic.py``, every RGB PNG's rows
   through the five filter types, in a temporary data root: HDF5 files, or,
   where h5py is absent, each shard's nodes in an .npz archive (files, so
   that the CLIs' processes read them too) served by ``npz_shard`` in place
   of ``HDF5Dataset._h5`` (the storage is printed).
   (b) The native C helpers against their numpy versions on this host, bit
   for bit, each call counted as the C library's. (c) UniDepthV2 ViT-L/14
   (configs/config_v2_vitl14.json, random weights, ``build_trainer`` on the
   card) trained from ``WeightedConcat`` -> ``ShapeSampler`` (the model's
   constraints, shape seed SEED) -> ``Loader`` (DATA_THREADS threads, 8 x 2
   images) -> ``device_prefetch`` (pinned memory, a side stream) for
   DATA_STEPS steps at the shapes 308 x 686, 602 x 952, 378 x 728, 602 x
   952: finite losses, each batch on the card at its sampled shape (a
   multiple of 14), K1 96, K2 96, K3 8 a step on the Hopper bodies
   (``data_train_launches`` in the records), the native decode helpers
   called. (d) Beside the card's name and power limit: the loader alone in
   batches a second; each step's host wait and ms and the same step on a
   premade batch on the card; one batch's upload, pageable against pinned;
   the peak memory at 602 x 952. (e) ``scripts_torch/train.py --data-root``
   (2 steps of 4 images) and ``scripts_torch/eval.py --data-root --datasets
   KITTI NYUv2Depth`` as subprocesses on the card at once: exit 0, finite
   losses and metrics. A ``{"data": ...}`` line carries the figures.
   (f) The last sixteen transforms, which no dataset builds
   (``augment_phase``), before the CLIs: (a) each numpy transform whose JAX
   counterpart calls Pillow (``PILLOW_CHECKS``: the ``ImageEnhance`` four,
   ``RandomColor``'s HSV round trip, autocontrast, solarize, posterize,
   equalize) against a few lines of Pillow on this host, bit for bit, at
   prob 1 on AUG_SEEDS seeded frames of 375 x 1242 and 602 x 952, at both
   ends of each level's range; (b) the sixteen (the fifteen random ones at
   prob 1, then ``Normalize``) appended to each reader's own augmenter, each
   wrapped to count its calls, the validity pixels it turns False and any
   exception it raises (the loader retries a failed sample, which would
   hide one): the loader alone in batches a second with them, at the shape
   seed (c) timed without them, then AUG_STEPS steps of the same trainer
   fed by that running loader: finite
   losses, each batch on the card at its sampled shape, K1 96, K2 96, K3 8
   a step on the Hopper bodies, every transform called and none raising,
   validity pixels turned False by ``Rotate``, ``RandomShear`` and
   ``RandomTranslate``, and zeros in each step's ``validity_mask``; (c) ms a
   sample of each at 375 x 1242 in this thread (one host core), the median
   of AUG_TIMING_REPS, beside the card's name and power limit. An
   ``{"augment": ...}`` line carries the figures; K1-K3's records gain
   ``augment_train_launches``.
16. The rest of serving (``serve_phase``). (a) ``scripts_torch/infer.py``'s
   ``main`` in this process on a folder of the demo image and two
   NuScenes-style frames of six seeded 900 x 1600 PNGs (13 images, 3
   batches of at most 8 in 2 size buckets, configs/config_v2_vitl14.json,
   random weights): K1 24, K2 24, K3 4, K5 2 a batch on the Hopper bodies;
   the 13 depth PNGs under the JAX CLI's names, each within SERVE_DEPTH_MM of
   ``clip(depth * 1000)`` of a direct ``infer()`` of the same batch;
   images/s. The command line on the demo image alone with ``--save-ply
   --save-panel`` as a subprocess: exit 0, a PLY of H * W vertices, an RGB
   | depth panel. (b) ``export_forward`` of the same V2 ViT-L/14 (bf16) at
   462 x 616, B = 1, without and with rays: no launch while tracing, the
   kernel flags back on; a process that imports torch only loads both
   archives and runs them on the card; their points within relative RMS
   EXPORT_REL_RMS of the plain ``encode_decode`` and their depth within the
   V2 gate of the kernel path's; seconds, MiB and ms a call beside the
   kernel path's; a call of the program loaded here launches nothing. (c)
   V2 ViT-L/14 with 4 register tokens and softmax stacking, ``infer()`` at
   B = 8, 518 x 518 (K1 at 1,374 tokens; K1 24, K2 24, K3 4, K5 2), and ViT-S/14
   under ``max``, ``mean`` and ``first`` at B = 2, each against the fp32
   plain path: ViT-L at the V2 gate, ViT-S at STACKING_DEPTH_GATE (set
   from the JAX package's own bf16 drift of each stacking,
   tests/stacking_bf16_drift.py). (d) DINOv2 ViT-g/14 with registers
   (VITG_REG: SwiGLU, 40 blocks, 24 heads of 64) alone at B = 8, 518 x 518,
   weights drawn on the card: K1 40 on the Hopper body and K2's gated body
   40 (``ln_dense.gated_launches``), K2 and K4 0; the
   features and cls tokens of the bf16 kernel path within VITG_FEATURE_GATE
   relative RMS of the fp32 plain path (the plain bf16 path's drift
   printed beside it). A ``{"serve": ...}`` line carries the figures; K1-K4's
   records gain ``serve_launches``. The whole run's seconds are printed.

17. More than one process (``parallel_phase``). (a) K1, K2 and K3 at the
   shapes tensor parallelism (tp=2) gives them, in bf16, held to their
   plain versions at the bf16 gates, timed beside their library calls,
   with bound and share: K1 at (8, 1531, 8 x 64), K2 at V2 ViT-L/14's M
   12248, C 1024, F 2048 and at ConvNeXt-L's four stages with F halved
   (stage 0's F = 384 on the mma.sync body, which K2's shape gate leaves
   it; the others on the Hopper body), K3 at (32, 1530, 64). (b) Two
   world-size-1 runs of V2 ViT-L/14 (configs/config_v2_vitl14.json,
   ``build_trainer``, random weights), 2 steps of 2 x 8 images at 476 x
   630: the bf16 kernel path (the reference) and the fp32 plain path;
   twice the bf16 run's drift from the fp32 run sets the gates (the loss
   slots' worst relative drift; the global gradient norm's; the masters'
   relative L2 after step 2, the worst tensor and the median; the Adam
   first moment's over every element and the median tensor). (c) Two
   ranks spawned on the one card, a gloo group on CUDA tensors (NCCL
   refuses two ranks on one GPU), each taking the same 2 steps on its
   rows under dp=2, fsdp=2 and tp=2: loss slots equal on both ranks; the
   loss slots, the grad norm, the gathered masters and the gathered first
   moment (which carries the gradient's scale that Adam's step hides from
   the masters) within the gates of the bf16 reference; K1 192, K2 192,
   K3 16 a rank, all on the Hopper bodies, at the local shapes (a hook
   records each launch's shape and body); ms a step and peak memory by
   rank. Then a batch-sharded
   ``infer()`` of 8 seeded 518 x 518 images (4 a rank, the outputs
   all-gathered; depth median relative error from the one-process call
   <= PAR_SERVE_GATE) and ``validate()`` over 9 Dummy images (shards of
   5 and 4 padded to 3 batches of 2) against one process on the ranks'
   batches (PAR_VAL_SAME_RTOL) and on its own (PAR_VAL_RTOL: relative,
   the counting metrics absolute), beside one image's bf16 map rerun,
   beside another image and in another row of its batch. (d) NCCL at
   world size 1 in this process: the collectives' NCCL branches keep
   their input. A rank
   that fails fails the spawn and the run. A ``{"parallel": ...}`` line
   carries the figures; K1-K3's records gain ``parallel`` (the shapes)
   and ``parallel_launches`` (a rank's launches in each mode).

Each path's launch counts (and the Hopper-body counts of K1-K7) are set
to 0 just before it runs and read just after. A K2 call
counts once, though it launches its row statistics and its GEMM. The K6
harness's ``base`` row is K4 itself. The last two lines are the kernels'
JSON record (each kernel with its ``body``) and ``{"ok": true, "device":
{...}}``. Any failing phase raises.
"""

import copy
import importlib.util
import io
import itertools
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "config_v2_vitl14.json"
CONFIG_B = ROOT / "configs" / "config_v2_vitb14.json"
CONFIG_S = ROOT / "configs" / "config_v2_vits14.json"
CONFIG_V1 = {"V1 ViT-L/14": ROOT / "configs" / "config_v1_vitl14.json",
             "V1 ConvNeXt-L": ROOT / "configs" / "config_v1_cnvnxtl.json"}
BATCH, SIDE, SEED = 8, 518, 0
V1_SHAPE = (462, 616)  # both V1 configurations' fixed network shape
V1_DEPTH_GATE = 8e-2  # V1 bf16 depth median relative error against fp32: PERF.md section 2
BATCH_B_CHECK = 2  # ViT-B's and ViT-S's check against the fp32 plain path; their timing runs at BATCH
TOL_BF16 = dict(rtol=1.6e-2, atol=1e-2)
REL_RMS_BF16 = 5e-3
STAGE_MASK = (True, False, True, False)
HBM_BYTES_S, BF16_FLOP_S = 3.35e12, 989e12  # H100 SXM, dense
AB_SHAPE = dict(b=BATCH, heads=16, n=1370, d=64)
AB_ITERS = 20
# base (K4) and one name per K6 family M1-M9; then K7
AB_FAMILY_NAMES = ("base", "tr_max", "bf16p", "nomax_guard", "tr_lmxu", "nomax", "noexp", "gemmonly",
                   "qk_only", "pv_only")
BD_NAMES = ("bd", "bd_lmxu")
# the kernels with a Hopper body (wgmma + TMA) beside their mma.sync one: K1, K3
# and K4 (attention_wgmma.cu, bf16 at head dim 64; K3 also at 32 and 48), K2
# (ln_dense_wgmma.cu), K5 (conv3x3_wgmma.cu), and K6 and K7 (attention_ab.cu
# on attention_wgmma.cuh's body, bf16 at head dim 64)
HOPPER = ("flash_attention_qkv", "ln_dense", "flash_attention", "flash_attention_packed", "conv3x3_lowchannel",
          "run_variant", "run_bd")
# K3 at the decoders' narrower head dims, 8 heads an image: name -> (BH, N, D)
K3_NARROW_SHAPES = {"d48_b2": (2 * 8, 1369, 48), "d48": (BATCH * 8, 1369, 48), "d32": (BATCH * 8, 1369, 32)}
K5_HR_SHAPES = {64: (BATCH, SIDE, SIDE, 64, 32), 48: (BATCH, SIDE, SIDE, 48, 32), 32: (BATCH, SIDE, SIDE, 32, 32)}
# K5's fused heads (conv3x3_head) in a bf16 V2 forward that needs no gradient:
# one launch for each head's hr tail, depth and confidence
K5_HEADS = {"conv3x3_lowchannel": 2}
# K2h (head_mlp): the V2 heads' LayerNorm -> Linear pair at the 518x518
# latents, (B, C, H, W) NCHW, the grid 8x the 37 x 37 tokens; one launch a
# bf16 V2 forward that needs no gradient
K2H_SHAPE = (BATCH, 128, 296, 296)
# K2 on the V1 paths at B = 8, 462 x 616: name -> (M, C, F, eps). ConvNeXt-L's
# four stages (grids 115 x 154, 57 x 77, 28 x 38, 14 x 19), then the V1
# decoder's CvnxtBlocks on ViT-L/14's 33 x 44 grid and its 2x and 4x
V1_K2_SHAPES = {
    "cnvnxtl_stage0": (BATCH * 115 * 154, 192, 768, 1e-6),
    "cnvnxtl_stage1": (BATCH * 57 * 77, 384, 1536, 1e-6),
    "cnvnxtl_stage2": (BATCH * 28 * 38, 768, 3072, 1e-6),
    "cnvnxtl_stage3": (BATCH * 14 * 19, 1536, 6144, 1e-6),
    "v1_decoder_c512": (BATCH * 33 * 44, 512, 2048, 1e-5),
    "v1_decoder_c256": (BATCH * 66 * 88, 256, 1024, 1e-5),
    "v1_decoder_c128": (BATCH * 132 * 176, 128, 512, 1e-5),
}
# K1 on V1 ViT-L/14 (33 x 44 patches + cls) and K3 on the V1 decoder's
# layers_16 (8 heads of 64 an image) at ViT-L's and ConvNeXt-L's grids
V1_K1_TOKENS = 33 * 44 + 1
V1_K3_SHAPES = {"v1_vitl14": (BATCH * 8, 33 * 44, 64), "v1_cnvnxtl": (BATCH * 8, 28 * 38, 64)}
# UniDepthV2old (configs/config_v2old_vitl14.json) at B = 8 on 480 x 640
# images: its token budget (2400) resizes them to 588 x 784, 42 x 56 patches
CONFIG_V2OLD = ROOT / "configs" / "config_v2old_vitl14.json"
V2OLD_IMAGE, V2OLD_NET = (480, 640), (588, 784)
V2OLD_TOKENS = 42 * 56 + 1
# K2 at V2old's encoder, then at its upsamplers' CvnxtBlocks (1x, 2x and 4x
# the patch grid): name -> (M, C, F, eps)
V2OLD_K2_SHAPES = {
    "v2old_encoder": (BATCH * V2OLD_TOKENS, 1024, 4096, 1e-6),
    "v2old_ups_c512": (BATCH * 42 * 56, 512, 2048, 1e-5),
    "v2old_ups_c256": (BATCH * 84 * 112, 256, 1024, 1e-5),
    "v2old_ups_c128": (BATCH * 168 * 224, 128, 512, 1e-5),
}
# the V2old gates (PERF.md section 2, from tests/v2old_bf16_drift.py): twice
# the JAX package's own worst drift against fp32 (ViT-S/14 under the shipped
# decoder), rounded up in the first digit. bf16 kernel path against the fp32
# plain path: depth median 3.14e-2 -> 7e-2. Int8 against the same: depth
# mean 5.01e-2 -> 0.2 and p99 0.199 -> 0.4 (V2old misses V2's 0.05 and 0.15);
# intrinsics 1.88e-2 keeps V2's 0.1
V2OLD_DEPTH_GATE = 7e-2
V2OLD_INT8_GATES = {"mean": 0.2, "p99": 0.4, "intrinsics": 0.1}
# V2 training (configs/config_v2_vitl14.json): 8 images a micro-batch, 2
# micro-batches a step, 480 x 640 floored to 476 x 630 (34 x 45 patches + cls)
TRAIN_TOKENS = 34 * 45 + 1
TRAIN_CHECK_BATCH = 2  # the micro-batch held against the fp32 plain path
TRAIN_DESCENT_STEPS = 5
# the train gate (PERF.md section 2, from tests/train_bf16_drift.py): each
# loss slot's relative drift and each parameter's gradient cosine, bf16
# kernel path against the fp32 plain path
TRAIN_LOSS_GATE = 7e-3  # twice JAX's worst, 3.22e-3 (ViT-S/14), rounded up
TRAIN_COSINE_GATE = 0.85  # 1 - twice (1 - JAX's worst, 0.9299 (the small test model)), rounded down
# the other families' train gates (PERF.md section 2, from
# tests/train_families_bf16_drift.py on the CPU): twice the JAX package's
# own worst drift, the loss rounded up and the cosines down in the first
# digit. V1 ViT (tiny, ViT-S/14 under the shipped decoder): loss 1.84e-2,
# cosine 0.9803, median 0.99971; V1 ConvNeXt (tiny, ConvNeXt-L under the
# shipped decoder): 6.52e-3, 0.6071 (the last stage's layer scale, whose
# gradient sums a whole map), 0.99944; V2old (tiny, the ViT-S/14 config):
# 1.08e-2, 0.5214, 0.96616
V1_TRAIN_GATES = {"loss": 4e-2, "cosine": 0.96, "median": 0.999}
V1_CONVNEXT_TRAIN_GATES = {"loss": 2e-2, "cosine": 0.2, "median": 0.998}
V2OLD_TRAIN_GATES = {"loss": 3e-2, "cosine": 0.04, "median": 0.93}
# parameters the V2 loss gives no gradient, in JAX as here: the given rays
# replace the camera head's prediction
NO_GRADIENT = ("pixel_decoder.camera_layer.", "pixel_decoder.camera_token_adapter.")
# V2old's biases whose shift its whole-map log-depth norm or a softmax
# removes: zero gradient in exact arithmetic, rounding noise on both paths
# (tests/train_families_bf16_drift.py), so held to neither gate
V2OLD_SHIFT_INVARIANT = (r"pixel_decoder\.depth_layer\.depth_mlp\.\d+\.proj2\.bias|pixel_decoder\.depth_layer\.to_depth\.bias"
                         r"|pixel_decoder\.level_embed_layer\.3\.bias")
# each family's train path: the config (trained at its training section's
# 8 x 2 images, the image shape floored to 14: V1 462 x 616, the others
# 476 x 630), the launches of one micro-batch (forward + the checkpointed
# blocks' recompute; the decoders' CvnxtBlocks and attention once), the
# gates (PERF.md section 2: twice the JAX package's own worst bf16 drift of
# the family, tests/train_bf16_drift.py for V2 and
# tests/train_families_bf16_drift.py for the others), the parameters
# without a gradient, whether the loss falls over the 5 steps (V2's does;
# V1's and V2old's rise over their first steps at random weights, V1's in
# the JAX package's own trainer too, tests/train_trajectory.py: they are
# held to first-order descent, which every family is), and for V2 the
# validation and int8-master checks
TRAIN_FAMILIES = {
    "V2 ViT-L/14": dict(config=CONFIG, per_micro={"flash_attention_qkv": 48, "ln_dense": 48, "flash_attention": 4},
                        gates={"loss": TRAIN_LOSS_GATE, "cosine": TRAIN_COSINE_GATE}, no_gradient=NO_GRADIENT,
                        shift_invariant=None, descends=True, int8_masters=True,
                        validation={"flash_attention_qkv": 24, "ln_dense": 24, "flash_attention": 4, **K5_HEADS}),
    "V1 ViT-L/14": dict(config=CONFIG_V1["V1 ViT-L/14"],
                        per_micro={"flash_attention_qkv": 48, "ln_dense": 54, "flash_attention": 3},
                        gates=V1_TRAIN_GATES, no_gradient=(), shift_invariant=None, descends=False),
    "V1 ConvNeXt-L": dict(config=CONFIG_V1["V1 ConvNeXt-L"], per_micro={"ln_dense": 78, "flash_attention": 3},
                          gates=V1_CONVNEXT_TRAIN_GATES, no_gradient=(), shift_invariant=None, descends=False),
    "V2old ViT-L/14": dict(config=CONFIG_V2OLD, per_micro={"flash_attention_qkv": 48, "ln_dense": 54},
                           gates=V2OLD_TRAIN_GATES, no_gradient=NO_GRADIENT, shift_invariant=V2OLD_SHIFT_INVARIANT,
                           descends=False),
}
# K2's gradients at ConvNeXt-L's widest and narrowest stages (V1 at 462 x
# 616, B = 8): name -> (M, C, F, eps)
V1_K2_GRAD_SHAPES = {"cnvnxtl_stage3": V1_K2_SHAPES["cnvnxtl_stage3"], "cnvnxtl_stage0": V1_K2_SHAPES["cnvnxtl_stage0"]}
# V1 int8: calibrate_int8_stages on 2 seeded images at the default budget,
# then BATCH others against the fp32 plain path at the V1 int8 gates
V1_INT8_CALIB = 2
# twice the JAX package's own V1 int8 drift against fp32 under its
# calibrated mask (tests/train_families_bf16_drift.py --int8 on the CPU:
# tiny and ViT-S/14 V1; worst mean 4.36e-2, p99 0.215, intrinsics 4.92e-2),
# rounded up in the first digit
V1_INT8_GATES = {"mean": 0.09, "p99": 0.5, "intrinsics": 0.1}
TRAIN_CLI_STEPS = 2
# evaluation: validate() on Dummy at the training shape (476 x 630), 4
# batches of 8; the cameras and the camera-prompted infer() at 518 x 518
EVAL_BATCH, EVAL_BATCHES = 8, 4
CAMERA_TYPES = ("Pinhole", "EUCM", "Spherical", "OpenCV", "Fisheye624", "MEI")
PROMPT_TYPES = ("Pinhole", "Fisheye624", "OpenCV", "MEI")  # the prompted infer()'s mixed batch, two each
RAY_ATOL = 1e-4  # unit rays, card against CPU
# pixels, card against CPU and against uv: float32 spacing at 518 is 6.1e-5,
# and on the CPU alone the round trip is 1.2e-4 (the Newton models) to 4.0e-4
# (Spherical's asin near its poles) off its float64 value at these cameras
ROUND_TRIP_ATOL = 1e-3
EVAL_CPU_RTOL = 1e-5  # the depth metrics on the same maps, card against CPU
COUNTING_METRICS = ("d1", "d2", "d3", "tau", "d_auc", "d1_si", "tau_si")  # within one pixel a sample
# d1_ssi, tau_ssi and arel_ssi: their scale and shift come from float32 sums
# over 299,880 pixels, which the card adds in another order (~1e-6 relative
# apart), so tens of pixels near the 3% and 25% thresholds may flip: 1e-4 is
# 30 pixels (the first card call saw 3)
SSI_CPU_TOL = 1e-4


# the data phase: synthetic shards of three SPECS rows (an image row with its
# pre-crop and per-date intrinsics, a plain image row, a sequence row), V2
# ViT-L/14 trained from the loader. With shape seed SEED the sampler gives
# batches 0-3 the shapes 308 x 686, 602 x 952, 378 x 728, 602 x 952: three
# shapes, the largest (2925 tokens) twice
DATA_NAMES = ("KITTI", "NYUv2Depth", "ARKit")
DATA_SAMPLES = 48
DATA_STEPS = 4
DATA_LARGEST = (602, 952)
DATA_THREADS = 4
DATA_LOADER_BATCHES = 5  # the loader alone: the first batch is its start, the next four are timed
DATA_CLI_STEPS = 2
# (f) the last sixteen transforms (datasets/pipelines.py), which no dataset
# builds: appended at prob 1 to each reader's own augmenter for AUG_STEPS
# loader-fed steps. Before them, each numpy transform whose JAX counterpart
# calls Pillow against Pillow itself on AUG_SEEDS frames of each AUG_FRAMES
# shape (a synthetic KITTI frame, the sampler's largest shape), at the
# values in PILLOW_CHECKS (both ends of each level's default range)
AUG_STEPS = 2
AUG_SEEDS = 8
AUG_FRAMES = ((375, 1242), DATA_LARGEST)
AUG_TIMING_REPS = 20  # ms a sample of each transform at 375 x 1242: the median of these
PILLOW_CHECKS = {
    "RandomSaturation": ("level", (-0.5, 0.5)), "RandomSharpness": ("level", (-0.5, 0.5)),
    "RandomBrightness": ("level", (-0.5, 0.5)), "RandomContrast": ("level", (-0.5, 0.5)),
    "RandomColor": ("level", (-0.05, 0.05)), "RandomAutoContrast": (None, (None,)),
    "RandomSolarize": ("threshold", (1, 128, 255)), "RandomPosterize": ("bits", (1, 4, 8)),
    "RandomEqualize": (None, (None,)),
}
GEOMETRIC = ("Rotate", "RandomShear", "RandomTranslate")  # the transforms that bring in invalid borders
# what a shard's node paths are served from when h5py is absent: the nodes of
# <shard path>.npz, read through NpzShard
H5PY_ABSENT = importlib.util.find_spec("h5py") is None

# the serving phase. (a) scripts_torch/infer.py on the demo image and two
# NuScenes-style frames of six 900 x 1600 views: 13 images, 3 batches of at
# most SERVE_BATCH in 2 size buckets, each batch K1 24, K2 24, K3 4
SERVE_CAMS = ("CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT", "CAM_FRONT", "CAM_FRONT_LEFT", "CAM_FRONT_RIGHT")
SERVE_FRAME = (900, 1600)
SERVE_BATCH = 8
SERVE_BATCHES = 3
SERVE_DEPTH_MM = 1  # the CLI's depth PNGs against a direct infer() of the same batch
DEMO_RGB = ROOT / "assets" / "demo" / "rgb.png"
# (b) the exporter: V2 ViT-L/14 at 462 x 616 (33 x 44 patches + cls), B = 1,
# bf16; the loaded program's points against the same model's plain
# encode_decode (relative RMS) and against its kernel path (the V2 depth gate)
EXPORT_SHAPE = (462, 616)
EXPORT_REL_RMS = 1e-3
# (c) V2 ViT-L/14 with 4 register tokens and softmax stacking (1 + 4 + 1369 =
# 1374 tokens); the other stackings at ViT-S widths
REGISTER_TOKENS = 4
OTHER_STACKINGS = ("max", "mean", "first")
# the ViT-S stackings' depth gate (PERF.md section 2, tests/stacking_bf16_drift.py
# on the CPU): twice the JAX package's own worst bf16 drift of the shipped
# ViT-S/14 config over the stacking modes (mean: median 9.07e-3), rounded up
STACKING_DEPTH_GATE = 2e-2
# (d) DINOv2 ViT-g/14 with registers (dinov2_vitg14_reg): SwiGLU of hidden
# 4096 (6144 * 2 / 3), 40 blocks, 24 heads of 64, outputs at 10, 20, 30, 40
VITG_REG = dict(embed_dim=1536, depth=40, num_heads=24, mlp_ratio=4.0, num_register_tokens=4, ffn_layer="swiglu",
                output_idx=(10, 20, 30, 40), use_norm=True)
# the features' and cls tokens' relative RMS, bf16 kernel path against fp32
# plain: twice what bf16 rounding alone gives, the plain bf16 path's 4.36e-2
# (H100 80GB HBM3, 700 W; the kernel path measured 4.32e-2), rounded up
VITG_FEATURE_GATE = 9e-2


# --- more than one process ------------------------------------------------------
# two ranks share the one card: gloo on CUDA tensors (NCCL refuses two ranks on
# one GPU); NCCL runs at world size 1 in this process
PAR_MODES = {"dp": (2, 1, 1), "fsdp": (1, 2, 1), "tp": (1, 1, 2)}
PAR_STEPS = 2
PAR_WORLD = 2
PAR_GATE_FACTOR = 2.0  # a sharded bf16 run within twice the bf16 run's own drift from fp32
PAR_VAL_LENGTH, PAR_VAL_BATCH = 9, 2  # an odd Dummy set; images a rank a batch
PAR_SERVE_GATE = 1e-2  # the V2 gate: depth median relative error
# validate() at 2 ranks against 1 process running the ranks' own batches: the
# same maps, so the metrics may differ only by the order of the float64 mean
PAR_VAL_SAME_RTOL = 1e-12
# against 1 process running its own batches ([0, 1], [2, 3], ...): a bf16 map
# moves with its image's row in a batch of 2 (measured beside it: image 1
# second in [0, 1] against first in [1, 3]; a rerun and another batch-mate
# leave it bitwise equal). The op is cuDNN's bf16 3x3 convolution of the V2
# decoder's second ResidualConvUnit stage (ups.1, 512 -> 512 channels; (2, 512,
# 74, 74) at 518 x 518): at B = 2 it rounds row 1 otherwise than the same image
# alone, on ~0.1% of its outputs by one bf16 ulp, and PyTorch's own conv and
# fp32 do not (scripts_torch/batch_row_probe.py, ROADMAP C4). So the evaluation
# contract's rtol 1e-3 (tests/test_torch_validation.py) for the continuous
# metrics, and 1e-3 of the pixels for the metrics that count them
PAR_VAL_RTOL = 1e-3
PAR_VAL_COUNTING = ("d1", "d2", "d3", "tau", "d_auc", "d1_ssi", "tau_ssi", "d1_si", "tau_si")
# the kernels at the local shapes tp=2 gives them (V2 ViT-L/14 training at 476 x 630,
# 8 images a micro-batch; ConvNeXt-L at 462 x 616, B = 8): name -> shape
PAR_K1 = (BATCH, TRAIN_TOKENS, 8, 64)  # 8 of ViT-L's 16 heads
PAR_K2 = {"vitl14_tp2": (BATCH * TRAIN_TOKENS, 1024, 2048, 1e-6),  # fc1's F / 2
          **{f"cnvnxtl_tp2_stage{i}": (rows, c, f // 2, eps) for i, (rows, c, f, eps) in
             enumerate(list(V1_K2_SHAPES.values())[:4])}}
PAR_K3 = (BATCH * 4, TRAIN_TOKENS - 1, 64)  # 4 of the decoder's 8 heads


def _par_hooks():
    """Record the shape and body of every K1, K2 and K3 launch in this
    process: {kernel: Counter of (shape, hopper)}."""
    import collections

    from unidepth_tpu_torch.ops import flash_attention as fa
    from unidepth_tpu_torch.ops import fused_block as fb

    seen = {k: collections.Counter() for k in ("flash_attention_qkv", "ln_dense", "flash_attention")}

    def wrap(module, attr, key, wrapper, shape_of):
        real = getattr(module, attr)

        def launch(*args):
            before = wrapper.hopper_launches
            out = real(*args)
            seen[key][(shape_of(*args), wrapper.hopper_launches - before)] += 1
            return out

        setattr(module, attr, launch)

    wrap(fa, "_qkv_launch", "flash_attention_qkv", fa.flash_attention_qkv,
         lambda qkv, heads, scale: (*qkv.shape[:2], heads, qkv.shape[2] // 3 // heads))
    wrap(fb, "_ln_dense_launch", "ln_dense", fb.ln_dense,
         lambda x, w, *rest: (x.numel() // x.shape[-1], *w.shape[::-1]))
    wrap(fa, "_flash_launch", "flash_attention", fa.flash_attention, lambda q, k, v, scale: tuple(q.shape))
    return seen


def _par_take_rows(batch, mesh):
    local = batch["image"].shape[1] // mesh.batch_shards
    return {k: v[:, mesh.batch_rank * local : (mesh.batch_rank + 1) * local] for k, v in batch.items()}


def _rel_l2(a, b):
    return ((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-300)).item()


def _tree_drift(got, want):
    """(relative L2 over every element of the dicts of tensors, relative L2 by
    name)."""
    rel = {n: _rel_l2(got[n], want[n]) for n in want}
    diff = sum((got[n].double() - want[n].double()).square().sum().item() for n in want)
    norm = sum(want[n].double().square().sum().item() for n in want)
    return (diff / norm) ** 0.5, rel


def _parallel_rank(rank, spec):
    """One rank of the two-rank run: PAR_STEPS train steps under each mode
    of PAR_MODES, batch-sharded ``infer()`` and ``validate()``; writes its
    figures to ``spec['out']/rank{rank}.json``. Any failure raises, and the
    spawn raises in the parent."""
    sys.path.insert(0, str(ROOT))
    import torch.distributed as dist

    from unidepth_tpu_torch.datasets.dummy import Dummy
    from unidepth_tpu_torch.datasets.loader import eval_batches, make_batch
    from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2
    from unidepth_tpu_torch.ops.flash_attention import flash_attention, flash_attention_qkv
    from unidepth_tpu_torch.ops.fused_block import ln_dense
    from unidepth_tpu_torch.parallel.mesh import batch_sharded, initialize_distributed, make_mesh
    from unidepth_tpu_torch.training.trainer import build_trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(spec["device"])
    torch.cuda.set_device(dev)
    initialize_distributed(backend="gloo", init_method=f"file://{spec['store']}", world_size=PAR_WORLD, rank=rank)
    wrappers = {"flash_attention_qkv": flash_attention_qkv, "ln_dense": ln_dense, "flash_attention": flash_attention}
    seen = _par_hooks()
    ref = torch.load(spec["ref"], weights_only=True) if rank == 0 else None
    config = json.loads(CONFIG.read_text())
    shape = tuple(spec["shape"])
    batch = make_batch(Dummy(image_shape=shape, length=1024, seed=SEED), spec["batch"], spec["accum"],
                       np.random.default_rng(SEED))
    out = {"modes": {}}
    for mode, dims in PAR_MODES.items():
        mesh = make_mesh(*dims, device=dev)
        trainer = build_trainer(config, seed=SEED, mesh=mesh)
        rows = _par_take_rows(batch, mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for w in wrappers.values():
            w.launches = w.hopper_launches = 0
        for c in seen.values():
            c.clear()
        slots, ms = [], []
        for step in range(PAR_STEPS):
            dist.barrier()
            t0 = time.perf_counter()
            metrics = trainer.step(rows, (SEED, step))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            slots.append({k: v.item() for k, v in metrics.items()})
        peak = torch.cuda.max_memory_allocated(dev)
        launches = {k: [w.launches, w.hopper_launches] for k, w in wrappers.items()}
        shapes = {k: [[list(s), h, n] for (s, h), n in c.items()] for k, c in seen.items()}
        state, layout = trainer.state, trainer.layout
        held = {"params": sum(t.numel() for t in state.params.values()),
                "moments": sum(t.numel() for t in state.opt_state.mu.values()),
                "shadow": sum(t.numel() for t in state.ema.shadow.values())}
        whole = layout.full(state.params)  # every rank takes part
        mu = layout.full(state.opt_state.mu)
        figures = {"ms": ms, "slots": slots, "peak_gib": peak / 2**30, "launches": launches, "shapes": shapes,
                   "held": held}
        if rank == 0:
            rel = {n: _rel_l2(whole[n], ref["masters"][n]) for n in whole}
            worst = max(rel, key=rel.get)
            mu_global, mu_rel = _tree_drift(mu, ref["mu"])
            figures.update(master_max=rel[worst], master_max_param=worst,
                           master_median=statistics.median(rel.values()), mu_global=mu_global,
                           mu_median=statistics.median(mu_rel.values()))
        out["modes"][mode] = figures
        del trainer, state, layout, whole, mu
        torch.cuda.empty_cache()
    # batch-sharded serving: each rank infers its 4 of the 8 images
    mesh = make_mesh(PAR_WORLD, 1, 1, device=dev)
    model = UniDepthV2.from_config(config).init_params(seed=SEED)
    rgb = torch.load(spec["rgb"], weights_only=True).to(dev)
    for w in wrappers.values():
        w.launches = w.hopper_launches = 0
    with torch.inference_mode():
        served = batch_sharded(model.infer, mesh, rgb)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch_sharded(model.infer, mesh, rgb)
        torch.cuda.synchronize()
    out["serve"] = {"ms": (time.perf_counter() - t0) * 1e3, "shape": list(served["depth"].shape),
                    "launches": {k: [w.launches, w.hopper_launches] for k, w in wrappers.items()}}
    if rank == 0:
        rel = ((served["depth"].float() - ref["depth"].to(dev)).abs() / ref["depth"].to(dev).abs()).flatten()
        out["serve"]["depth_median_rel"] = rel.median().item()
        out["serve"]["depth_max_rel"] = rel.max().item()
    # validate() over a ragged set: each rank its padded shard
    from unidepth_tpu_torch.utils.validation import validate

    data = Dummy(image_shape=shape, length=PAR_VAL_LENGTH, seed=SEED + 2)
    loaders = {"Dummy": eval_batches(data, PAR_VAL_BATCH, mesh.batch_shards, mesh.batch_rank)}
    with torch.inference_mode():
        out["val"] = validate(model, loaders)["Dummy"]
    (Path(spec["out"]) / f"rank{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()


def parallel_phase(kernels, none, smi, dev):
    """Item 17: K1-K3 at the local shapes of tp=2; two world-size-1 runs
    (bf16 kernel path, fp32 plain path) that set the gates; two ranks on the
    card under dp=2, fsdp=2 and tp=2, batch-sharded infer() and validate();
    NCCL at world size 1. Returns (each kernel's figures, the launches by
    mode, the phase's figures)."""
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from unidepth_tpu_torch.datasets.dummy import Dummy
    from unidepth_tpu_torch.datasets.loader import collate, eval_batches, make_batch
    from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2
    from unidepth_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
        flash_attention_qkv,
        flash_attention_qkv_plain,
    )
    from unidepth_tpu_torch.ops.fused_block import ln_dense, ln_dense_plain
    from unidepth_tpu_torch.parallel.mesh import (
        _reduce_scatter,
        all_gather_cat,
        copy_to_tp,
        initialize_distributed,
        reduce_from_tp,
    )
    from unidepth_tpu_torch.training.trainer import build_trainer, train_image_shape
    from unidepth_tpu_torch.utils.misc import normalize_rgb
    from unidepth_tpu_torch.utils.validation import validate

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev)

    def randn(*shape, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * std + mean).to(torch.bfloat16)

    # (a) the kernels at the shapes tp=2 gives them
    rec = {"flash_attention_qkv": {}, "ln_dense": {}, "flash_attention": {}}
    b, n, h, d = PAR_K1

    def k1():
        gen.manual_seed(41)
        return randn(b, n, 3 * h * d), h, d**-0.5

    def sdpa_qkv(qkv, heads, scale):
        return sdpa(*(heads_view(t, heads) for t in qkv.chunk(3, dim=-1)), scale)

    rec["flash_attention_qkv"]["vitl14_tp2"] = {"shape": list(PAR_K1), **shape_phase(
        f"K1 tp=2 {PAR_K1}", flash_attention_qkv, flash_attention_qkv_plain, k1, 4 * b * n * n * h * d, sdpa_qkv,
        smi)}
    for key, (rows, c, f, eps) in PAR_K2.items():
        def k2(rows=rows, c=c, f=f, eps=eps):
            gen.manual_seed(rows + f)
            return (randn(rows, c, std=2.0, mean=0.5), randn(f, c, std=c**-0.5), randn(f, std=0.1),
                    randn(c, std=0.1, mean=1.0), randn(c, std=0.1), eps, "gelu")
        hopper = c % 64 == 0 and c <= 2048 and f % 256 == 0
        rec["ln_dense"][key] = {"shape": [rows, c, f], "body": "wgmma" if hopper else "mma.sync", **shape_phase(
            f"K2 {key} (M {rows}, C {c}, F {f})", ln_dense, ln_dense_plain, k2, 2 * rows * c * f,
            lambda x, w, bias, g, beta, eps, act: lambda: F.gelu(F.linear(F.layer_norm(x, x.shape[-1:], g, beta, eps),
                                                                          w, bias)), smi, hopper=hopper)}
    bh, n3, d3 = PAR_K3

    def k3():
        gen.manual_seed(43)
        return randn(bh, n3, d3), randn(bh, n3, d3), randn(bh, n3, d3), d3**-0.5

    rec["flash_attention"]["decoder_tp2"] = {"shape": list(PAR_K3), **shape_phase(
        f"K3 tp=2 {PAR_K3}", flash_attention, flash_attention_plain, k3, 4 * bh * n3 * n3 * d3,
        lambda q, k, v, scale: sdpa(q[None], k[None], v[None], scale), smi)}

    # (b) two world-size-1 runs on the same batches and seeds: the bf16
    # kernel path (the reference) and the fp32 plain path (its drift sets the gates)
    config = json.loads(CONFIG.read_text())
    tr = config["training"]
    shape = train_image_shape(config)
    batch_size, accum = tr["batch_size"], tr["nsteps_accumulation_gradient"]
    batch = make_batch(Dummy(image_shape=shape, length=1024, seed=SEED), batch_size, accum,
                       np.random.default_rng(SEED))
    runs = {}
    for label in ("bf16", "fp32 plain"):
        trainer = build_trainer(config, seed=SEED)
        if label == "fp32 plain":
            trainer.model.float().set_kernels(False)
        torch.cuda.reset_peak_memory_stats(dev)
        slots, ms = [], []
        for step in range(PAR_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = trainer.step(batch, (SEED, step))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            slots.append({k: v.item() for k, v in metrics.items()})
        runs[label] = {"slots": slots, "ms": ms, "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
                       "masters": {k: v.cpu() for k, v in trainer.state.params.items()},
                       "mu": {k: v.cpu() for k, v in trainer.state.opt_state.mu.items()}}
        log(f"parallel reference, world size 1, {label}: {PAR_STEPS} steps of {accum} x {batch_size} at "
            f"{shape[0]}x{shape[1]}: totals {[s['total'] for s in slots]}, ms {[round(t, 1) for t in ms]}, peak "
            f"{runs[label]['peak_gib']:.2f} GiB ({smi})")
        del trainer
        torch.cuda.empty_cache()
    ref, plain = runs["bf16"], runs["fp32 plain"]
    # the loss slots; the global gradient norm, and the first moment, which
    # carry the gradient's scale (Adam's step hides it from the masters)
    slot_keys = [k for k in ref["slots"][0] if k != "grad_norm"]

    def slot_drift(got, want, keys):
        return max(abs(a[k] - p[k]) / abs(p[k]) for a, p in zip(got, want) for k in keys)

    loss_drift = slot_drift(ref["slots"], plain["slots"], slot_keys)
    norm_drift = slot_drift(ref["slots"], plain["slots"], ["grad_norm"])
    master_rel = {n: _rel_l2(ref["masters"][n], plain["masters"][n]) for n in ref["masters"]}
    mu_global, mu_rel = _tree_drift(ref["mu"], plain["mu"])
    gates = {"loss": PAR_GATE_FACTOR * loss_drift, "grad_norm": PAR_GATE_FACTOR * norm_drift,
             "master_max": PAR_GATE_FACTOR * max(master_rel.values()),
             "master_median": PAR_GATE_FACTOR * statistics.median(master_rel.values()),
             "mu_global": PAR_GATE_FACTOR * mu_global,
             "mu_median": PAR_GATE_FACTOR * statistics.median(mu_rel.values())}
    log(f"parallel gates (twice the bf16 run's drift from the fp32 plain run after {PAR_STEPS} steps): loss slots "
        f"{gates['loss']:.3e}, grad_norm {gates['grad_norm']:.3e}, masters relative L2 max {gates['master_max']:.3e}, "
        f"median {gates['master_median']:.3e}, first moment relative L2 over every element {gates['mu_global']:.3e}, "
        f"median {gates['mu_median']:.3e}")
    model = UniDepthV2.from_config(config).init_params(seed=SEED)
    rgb = torch.from_numpy(np.random.default_rng(SEED + 3).integers(0, 256, (BATCH, SIDE, SIDE, 3), dtype=np.uint8))
    with torch.inference_mode():
        depth = model.infer(rgb.to(dev))["depth"].float()
        val_data = Dummy(image_shape=shape, length=PAR_VAL_LENGTH, seed=SEED + 2)
        # the ranks' batches, shard 0's then shard 1's; and one process's own
        val_same = validate(model, {"Dummy": itertools.chain(
            *(eval_batches(val_data, PAR_VAL_BATCH, PAR_WORLD, r) for r in range(PAR_WORLD)))})["Dummy"]
        val_ref = validate(model, {"Dummy": eval_batches(val_data, PAR_VAL_BATCH, pad=True)})["Dummy"]

        def depth_of(idx):  # a bf16 forward of the images idx, as validate() runs it
            b = collate([val_data[i] for i in idx])
            return model.encode_decode(normalize_rgb(torch.as_tensor(b["image"]).to(dev).float()),
                                       rays_gt=torch.as_tensor(b["rays"]).to(dev))["depth"].float()

        # one image's map against itself: rerun, beside another image, in another row of the batch
        base, rerun, mate, row = (depth_of(idx) for idx in ((0, 1), (0, 1), (0, 2), (1, 3)))
        composition = {k: {"bitwise": bool(torch.equal(m, want)), "differing_share": (m != want).float().mean().item(),
                           "max_rel": ((m - want).abs() / want.abs()).max().item()}
                       for k, m, want in (("rerun", rerun[1], base[1]), ("other_batch_mate", mate[0], base[0]),
                                          ("other_row", row[0], base[1]))}
    log(f"validate() maps, one image's bf16 depth: batch [0, 1] rerun {composition['rerun']}; image 0 beside 2 "
        f"{composition['other_batch_mate']}; image 1 first in [1, 3] against second in [0, 1] "
        f"{composition['other_row']} ({smi})")
    del model, base, rerun, mate, row
    torch.cuda.empty_cache()

    # (c) two ranks on the card
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="parallel_", dir=ROOT / "build"))
    torch.save({"masters": ref["masters"], "mu": ref["mu"], "depth": depth.cpu()}, tmp / "ref.pt")
    torch.save(rgb, tmp / "rgb.pt")
    ref_slots = ref["slots"]
    reference = {"loss_drift": loss_drift, "grad_norm_drift": norm_drift, "mu_global": mu_global,
                 "mu_median": statistics.median(mu_rel.values()), "master_rel_max": max(master_rel.values()),
                 "master_rel_median": statistics.median(master_rel.values()),
                 **{f"{k.replace(' ', '_')}_ms": v["ms"] for k, v in runs.items()},
                 **{f"{k.replace(' ', '_')}_peak_gib": v["peak_gib"] for k, v in runs.items()}}
    del runs, ref, plain, master_rel, mu_rel
    spec = {"store": str(tmp / "store"), "ref": str(tmp / "ref.pt"), "rgb": str(tmp / "rgb.pt"), "out": str(tmp),
            "shape": list(shape), "batch": batch_size, "accum": accum,
            "device": f"cuda:{torch.cuda.current_device()}" if dev.type == "cuda" else str(dev)}
    t0 = time.perf_counter()
    mp.spawn(_parallel_rank, args=(spec,), nprocs=PAR_WORLD, join=True)  # a rank's failure raises here
    spawn_s = time.perf_counter() - t0
    ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(PAR_WORLD)]
    figures = {"gates": gates, "reference": reference, "modes": {}, "spawn_s": spawn_s}
    per_step = {"flash_attention_qkv": 96, "ln_dense": 96, "flash_attention": 8}  # 2 micro-batches, the recompute
    local = {"dp": {"flash_attention_qkv": [batch_size // 2, TRAIN_TOKENS, 16, 64],
                    "ln_dense": [batch_size // 2 * TRAIN_TOKENS, 1024, 4096],
                    "flash_attention": [batch_size // 2 * 8, TRAIN_TOKENS - 1, 64]},
             "tp": {"flash_attention_qkv": list(PAR_K1), "ln_dense": list(PAR_K2["vitl14_tp2"][:3]),
                    "flash_attention": list(PAR_K3)}}
    local["fsdp"] = local["dp"]
    launches_by_mode = {}
    for mode in PAR_MODES:
        figs = [r["modes"][mode] for r in ranks]
        for r, fig in enumerate(figs):
            for k, (count, hop) in fig["launches"].items():
                if (count, hop) != (per_step[k] * PAR_STEPS,) * 2:
                    raise RuntimeError(f"parallel {mode} rank {r}: {k} launched {count} times, {hop} on the Hopper "
                                       f"body; expected {per_step[k] * PAR_STEPS}, all on the Hopper body")
            for k, seen in fig["shapes"].items():  # [shape, hopper, count]
                if {tuple(s) for s, _, _ in seen} != {tuple(local[mode][k])} or any(h != 1 for _, h, _ in seen):
                    raise RuntimeError(f"parallel {mode} rank {r}: {k} ran at {seen}, expected {local[mode][k]} on "
                                       f"the Hopper body")
        if figs[0]["slots"] != figs[1]["slots"]:
            raise RuntimeError(f"parallel {mode}: the ranks' loss slots differ: {figs[0]['slots']} {figs[1]['slots']}")
        loss_dev = slot_drift(figs[0]["slots"], ref_slots, slot_keys)
        norm_dev = slot_drift(figs[0]["slots"], ref_slots, ["grad_norm"])
        a = figs[0]
        log(f"parallel {mode} (2 ranks on one card, gloo): loss slots {loss_dev:.3e} from world size 1 (gate "
            f"{gates['loss']:.3e}), grad_norm {norm_dev:.3e} (gate {gates['grad_norm']:.3e}); after step {PAR_STEPS} "
            f"masters relative L2 max {a['master_max']:.3e} ({a['master_max_param']}; gate {gates['master_max']:.3e}), "
            f"median {a['master_median']:.3e} (gate {gates['master_median']:.3e}), first moment over every element "
            f"{a['mu_global']:.3e} (gate {gates['mu_global']:.3e}), median {a['mu_median']:.3e} (gate "
            f"{gates['mu_median']:.3e}); ms a step by rank {[[round(t, 1) for t in f['ms']] for f in figs]}; "
            f"peak {[round(f['peak_gib'], 2) for f in figs]} GiB a rank; a rank holds "
            f"{a['held']['params'] / 1e6:.1f} M master elements; K1/K2/K3 at {local[mode]} ({smi})")
        got = {"loss": loss_dev, "grad_norm": norm_dev, **{k: a[k] for k in gates if k not in ("loss", "grad_norm")}}
        if not all(got[k] <= gates[k] for k in gates):
            raise RuntimeError(f"parallel {mode} past its gates {gates}: {got}")
        launches_by_mode[mode] = {k: figs[0]["launches"][k][0] for k in per_step}
        figures["modes"][mode] = {"loss_dev": loss_dev, "grad_norm_dev": norm_dev, "mu_global": a["mu_global"],
                                  "mu_median": a["mu_median"], "ms": [f["ms"] for f in figs],
                                  "peak_gib": [f["peak_gib"] for f in figs], "held": a["held"],
                                  "master_max": a["master_max"], "master_max_param": a["master_max_param"],
                                  "master_median": a["master_median"], "totals": [s["total"] for s in a["slots"]]}
    fsdp_saves = figures["modes"]["dp"]["peak_gib"][0] - figures["modes"]["fsdp"]["peak_gib"][0]
    serve = [r["serve"] for r in ranks]
    for r, s in enumerate(serve):
        want = {"flash_attention_qkv": 48, "ln_dense": 48, "flash_attention": 8}  # two calls on 4 images
        if {k: tuple(v) for k, v in s["launches"].items()} != {k: (v, v) for k, v in want.items()}:
            raise RuntimeError(f"parallel serving rank {r}: launches {s['launches']}, expected {want} on Hopper")
        if s["shape"] != [BATCH, SIDE, SIDE, 1]:
            raise RuntimeError(f"parallel serving rank {r}: gathered depth {s['shape']}")
    if not serve[0]["depth_median_rel"] <= PAR_SERVE_GATE:
        raise RuntimeError(f"parallel serving: depth {serve[0]['depth_median_rel']} from world size 1")
    log(f"batch-sharded infer() B={BATCH} {SIDE}x{SIDE} over 2 ranks: depth median relative error "
        f"{serve[0]['depth_median_rel']:.3e} (max {serve[0]['depth_max_rel']:.3e}) from world size 1 (gate "
        f"{PAR_SERVE_GATE}); {[round(s['ms'], 1) for s in serve]} ms a call by rank ({smi})")
    val = [r["val"] for r in ranks]
    if val[0] != val[1] or set(val[0]) != set(val_ref) or set(val_same) != set(val_ref):
        raise RuntimeError(f"parallel validate(): ranks {val}, world size 1 {val_ref}, {val_same}")

    def val_dev(want):  # relative; the counting metrics absolute
        return {k: abs(val[0][k] - v) if k in PAR_VAL_COUNTING else abs(val[0][k] - v) / abs(v)
                for k, v in want.items()}

    same_dev, own_dev = val_dev(val_same), val_dev(val_ref)
    log(f"validate() over {PAR_VAL_LENGTH} Dummy images at 2 ranks (shards of {(PAR_VAL_LENGTH + 1) // 2} and "
        f"{PAR_VAL_LENGTH // 2}, each padded to {-(-(PAR_VAL_LENGTH + 1) // 2 // PAR_VAL_BATCH)} batches of "
        f"{PAR_VAL_BATCH}): against 1 process on the ranks' batches the worst {max(same_dev, key=same_dev.get)} "
        f"{max(same_dev.values()):.3e} (gate {PAR_VAL_SAME_RTOL}); against 1 process on its own batches the worst "
        f"{max(own_dev, key=own_dev.get)} {max(own_dev.values()):.3e} (gate {PAR_VAL_RTOL}; relative, the counting "
        f"ones absolute) (d1 {val[0]['d1']:.6f}, arel {val[0]['arel']:.6f})")
    for k in val_ref:
        if not (np.isfinite(val[0][k]) and same_dev[k] <= PAR_VAL_SAME_RTOL and own_dev[k] <= PAR_VAL_RTOL):
            raise RuntimeError(f"parallel validate(): {k} {val[0][k]} at 2 ranks, {val_same[k]} at 1 on the ranks' "
                               f"batches, {val_ref[k]} on its own")

    # (d) NCCL, the card's production backend, at world size 1: the collectives' NCCL branches
    initialize_distributed(backend="nccl", init_method=f"file://{tmp / 'nccl_store'}", world_size=1, rank=0)
    try:
        from unidepth_tpu_torch.utils.validation import _gather_values

        world = dist.group.WORLD
        x = torch.arange(8, dtype=torch.float32, device=dev)
        y = x.clone().requires_grad_()
        reduce_from_tp(copy_to_tp(y, world) * 2, world).sum().backward()
        ok = (torch.equal(all_gather_cat(x, world), x) and torch.equal(_reduce_scatter(x, world), x)
              and torch.equal(y.grad, torch.full_like(x, 2.0))
              and np.array_equal(_gather_values(np.arange(3.0), world), np.arange(3.0)))
        if dist.get_backend(world) != "nccl" or not ok:
            raise RuntimeError("parallel: the NCCL collectives at world size 1 changed their input")
    finally:
        dist.destroy_process_group()
    shutil.rmtree(tmp, ignore_errors=True)
    figures.update(serve={"depth_median_rel": serve[0]["depth_median_rel"], "ms": [s["ms"] for s in serve]},
                   val=val[0], val_same_dev=same_dev, val_dev=own_dev, val_composition=composition, nccl_world1=True,
                   fsdp_saves_gib=fsdp_saves, seconds=time.perf_counter() - t_phase)
    log(f"parallel phase: {figures['seconds']:.1f} s ({spawn_s:.1f} s in the two ranks); fsdp=2 saves "
        f"{fsdp_saves:.2f} GiB of a rank's peak against dp=2 ({smi}). Two ranks share one card: these figures "
        f"hold correctness and memory, not speed across cards")
    return rec, launches_by_mode, figures


def log(*args):
    print(*args, flush=True)


def time_ms(fn, iters=10, reps=10, warmup=3):
    """Median milliseconds per call of ``fn()``: CUDA events around ``reps``
    back-to-back calls (so the wrapper's host time overlaps the kernel
    before it), the median of ``iters`` such runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def check_close(name, out, ref, **tol):
    err = (out.float() - ref.float()).abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(), **tol, msg=lambda m: f"{name}: {m}")
    return err


def bound(flops, nbytes):
    """The least time the card could take: bytes over HBM bandwidth or bf16
    operations over the dense tensor-core peak, whichever is larger."""
    t_ops, t_bytes = flops / BF16_FLOP_S * 1e3, nbytes / HBM_BYTES_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if torch.is_tensor(t))


def check_bf16(name, out, ref):
    """The bf16 gates: elementwise (output rounding) and relative RMS."""
    err = check_close(f"{name} bf16", out, ref, **TOL_BF16)
    rel_rms = ((out.float() - ref).norm() / ref.norm()).item()
    if not rel_rms <= REL_RMS_BF16:
        raise RuntimeError(f"{name} bf16: relative RMS error {rel_rms:.3e} > {REL_RMS_BF16}")
    return err, rel_rms


def kernel_phase(name, kernel, plain, make_inputs, fp32_tol, flops, library=None):
    """Compare ``kernel`` with ``plain`` in bf16 and fp32 I/O; time both in
    bf16, and ``library(*args)()``, a yardstick call on the same data. A
    kernel with a Hopper body must take it for the bf16 call."""
    args = make_inputs(torch.bfloat16)
    hopper = getattr(kernel, "hopper_launches", None)
    out = kernel(*args)
    torch.cuda.synchronize()
    if hopper is not None and kernel.hopper_launches != hopper + 1:
        raise RuntimeError(f"{name}: the bf16 call at the path shape did not run the Hopper body")
    ref = plain(*[a.float() if torch.is_tensor(a) else a for a in args])
    err, rel_rms = check_bf16(name, out, ref)
    args32 = make_inputs(torch.float32)
    err32 = check_close(f"{name} fp32", kernel(*args32), plain(*args32), rtol=fp32_tol, atol=fp32_tol)
    del args32
    ms = time_ms(lambda: kernel(*args))
    plain_ms = time_ms(lambda: plain(*args))
    library_ms = time_ms(library(*args)) if library else None
    lib = f", library {library_ms:.4f} ms" if library else ""
    log(f"{name}: bf16 max_abs_err {err:.3e} rel_rms {rel_rms:.3e}, fp32 max_abs_err {err32:.3e}; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{lib} (bf16)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            **bound(flops, nbytes(*args, out))}


def shape_phase(name, kernel, plain, make_args, flops, library, smi, hopper=True):
    """``kernel`` in bf16 at one more shape of a model path: it must take its
    Hopper body (``hopper``; else the mma.sync body its shape gate leaves);
    held to its plain version (fp32, same inputs) at the bf16 gates; timed
    beside ``library(*args)()``; its bound and share."""
    args = make_args()
    before = kernel.launches, kernel.hopper_launches
    out = kernel(*args)
    torch.cuda.synchronize()
    if (kernel.launches, kernel.hopper_launches) != (before[0] + 1, before[1] + hopper):
        raise RuntimeError(f"{name}: the bf16 call did not launch the {'Hopper' if hopper else 'mma.sync'} body once")
    err, rel_rms = check_bf16(name, out, plain(*[a.float() if torch.is_tensor(a) else a for a in args]))
    ms, library_ms = time_ms(lambda: kernel(*args)), time_ms(library(*args))
    bd = bound(flops, nbytes(*args, out))
    log(f"{name}: bf16 max_abs_err {err:.3e} rel_rms {rel_rms:.3e}; kernel {ms:.4f} ms, {bd['bound_ms'] / ms:.1%} of "
        f"its {bd['bound_ms']:.4f} ms bound ({bd['bound_by']}), library {library_ms:.4f} ms ({smi})")
    return {"ms": ms, "library_ms": library_ms, "max_abs_err": err, "rel_rms": rel_rms, **bd}


def gated_phase(ln_dense, ln_dense_plain, randn, gen, smi):
    """K2's gated body (``ln_dense(..., 'swiglu')``, ViT-g/14's LN2 -> w12 ->
    silu(a) * g) at the v2-vitg14 cell's shape (8 x 1370, 1536, 8192) on
    random x, w12, bias, gamma and beta: one gated launch and no other K2
    launch; elementwise at the bf16 gates against the plain version on the
    same bf16 inputs (which rounds the normalised activation, as the kernel
    does, and the product to bf16), and at the relative RMS gate against the
    plain version in fp32 (elementwise, a gate's product of two halves moves
    by |g| x the halves' rounding: no fp32 match near silu's zero). A bias
    read from the wrong half, or a LayerNorm without gamma or beta, moves
    the halves by ~0.1 and fails both. Timed beside its plain version and
    the modules it replaces on the serving path (the fp32 LayerNorm cast to
    bf16, w12 on cuBLAS, chunk, silu and the gate product)."""
    c, f = VITG_REG["embed_dim"], 8192  # w12: the value and the gate, 4096 each
    gen.manual_seed(21)
    x = randn(BATCH * 1370, c, dtype=torch.bfloat16, std=2.0, mean=0.5)
    args = (x, randn(f, c, dtype=torch.bfloat16, std=c**-0.5), randn(f, dtype=torch.bfloat16, std=0.1),
            randn(c, dtype=torch.bfloat16, std=0.1, mean=1.0), randn(c, dtype=torch.bfloat16, std=0.1), 1e-6, "swiglu")
    before = ln_dense.launches, ln_dense.gated_launches
    out = ln_dense(*args)
    torch.cuda.synchronize()
    if (ln_dense.launches, ln_dense.gated_launches) != (before[0], before[1] + 1):
        raise RuntimeError("K2g: the 'swiglu' call did not launch the gated body once")
    name = f"K2g ln_dense swiglu (M {x.shape[0]}, C {c}, 2H {f})"
    err = check_close(f"{name} vs plain bf16", out, ln_dense_plain(*args), **TOL_BF16)
    ref = ln_dense_plain(*[a.float() if torch.is_tensor(a) else a for a in args])
    rel_rms = ((out.float() - ref).norm() / ref.norm()).item()
    del ref
    if not rel_rms <= REL_RMS_BF16:
        raise RuntimeError(f"{name}: relative RMS error {rel_rms:.3e} against fp32 > {REL_RMS_BF16}")
    x_, w, bias, gamma, beta, eps, _ = args

    def modules():
        y = F.layer_norm(x_.float(), (c,), gamma.float(), beta.float(), eps).to(torch.bfloat16)
        a, g = F.linear(y, w, bias).chunk(2, dim=-1)
        return F.silu(a) * g

    ms, plain_ms, library_ms = time_ms(lambda: ln_dense(*args)), time_ms(lambda: ln_dense_plain(*args)), time_ms(modules)
    bd = bound(2 * x.shape[0] * c * f, nbytes(*args, out))
    log(f"{name}: bf16 max_abs_err {err:.3e} (vs plain bf16), rel_rms {rel_rms:.3e} (vs fp32); kernel {ms:.4f} ms, "
        f"{bd['bound_ms'] / ms:.1%} of its {bd['bound_ms']:.4f} ms bound ({bd['bound_by']}), plain {plain_ms:.4f} ms, "
        f"modules {library_ms:.4f} ms ({smi})")
    return {"shape": [x.shape[0], c, f], "max_abs_err": err, "rel_rms": rel_rms, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library": "fp32 F.layer_norm -> bf16, F.linear, chunk, F.silu, multiply", **bd}


def head_mlp_phase(head_mlp, head_mlp_plain, ln_dense_plain, randn, gen, smi):
    """K2h (``head_mlp``: the V2 heads' LayerNorm -> Linear pair, both heads
    in one launch) at the 518x518 latents, (8, 128, 296, 296) NCHW bf16 -> 2
    x (8, 296, 296, 128), on random parameters: one launch; each head held
    elementwise at the bf16 gates to ``ln_dense_plain`` on the same bf16
    inputs and at the relative RMS gate to the plain version in fp32; timed
    beside the plain version and the modules it replaces (per head: the
    fp32 LayerNorm of the permuted latents cast to bf16, then the bf16
    nn.Linear on cuBLAS), with bound and share. The kernel's device name, read
    from a profiler trace, must hold none of the kernel names the benchmark's
    roofline readers count (K1/K3, K2, K2g), so no reader counts its time."""
    from benchmark.harness.readers import ATTENTION_KERNELS, LN_DENSE_KERNELS

    b, c, h, w = K2H_SHAPE
    gen.manual_seed(24)
    x = randn(b, c, h, w, dtype=torch.bfloat16, std=2.0, mean=0.5)
    heads = [(randn(c, c, dtype=torch.bfloat16, std=c**-0.5), randn(c, dtype=torch.bfloat16, std=0.1),
              randn(c, dtype=torch.bfloat16, std=0.1, mean=1.0), randn(c, dtype=torch.bfloat16, std=0.1), 1e-5)
             for _ in range(2)]
    args = (x, *(list(t) for t in zip(*heads)))
    before = head_mlp.launches
    outs = head_mlp(*args)
    torch.cuda.synchronize()
    if head_mlp.launches != before + 1:
        raise RuntimeError("K2h: the call did not launch the kernel once")
    name = f"K2h head_mlp {K2H_SHAPE} -> 2 x {(b, h, w, c)}"
    xh = x.permute(0, 2, 3, 1)
    errs, rels = [], []
    for i, (out, head) in enumerate(zip(outs, heads)):
        errs.append(check_close(f"{name} head {i} vs plain bf16", out, ln_dense_plain(xh, *head), **TOL_BF16))
        ref = ln_dense_plain(xh.float(), *(t.float() for t in head[:4]), head[4])
        rels.append(((out.float() - ref).norm() / ref.norm()).item())
        del ref
        if not rels[-1] <= REL_RMS_BF16:
            raise RuntimeError(f"{name} head {i}: relative RMS error {rels[-1]:.3e} against fp32 > {REL_RMS_BF16}")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        head_mlp(*args)
        torch.cuda.synchronize()
    ops = sorted({e.key for e in prof.key_averages()})
    k2h_ops = [op for op in ops if "head_mlp_wgmma" in op]
    counted = [op for op in ops if any(k in op for k in (*ATTENTION_KERNELS, *LN_DENSE_KERNELS, "ln_swiglu_wgmma"))]
    if len(k2h_ops) != 1 or counted:
        raise RuntimeError(f"{name}: operations {ops}; one head_mlp_wgmma expected, none that a reader counts")
    norms = [torch.nn.LayerNorm(c, eps=e).to(x.device, torch.bfloat16) for *_, e in heads]
    linears = [torch.nn.Linear(c, c).to(x.device, torch.bfloat16) for _ in heads]
    with torch.no_grad():
        for (wt, bias, gamma, beta, _), norm, linear in zip(heads, norms, linears):
            norm.weight.copy_(gamma), norm.bias.copy_(beta), linear.weight.copy_(wt), linear.bias.copy_(bias)

    def modules():  # the decoder's path before K2h (nn/layers.py layer_norm, then nn.Linear), both heads
        return [linear(F.layer_norm(xh.float(), (c,), norm.weight.float(), norm.bias.float(), norm.eps)
                       .to(torch.bfloat16)) for norm, linear in zip(norms, linears)]

    with torch.inference_mode():
        ms, plain_ms, library_ms = (time_ms(lambda: head_mlp(*args)), time_ms(lambda: head_mlp_plain(*args)),
                                    time_ms(modules))
    bd = bound(2 * 2 * b * h * w * c * c, nbytes(x, *outs))
    log(f"{name}: bf16 max_abs_err {max(errs):.3e} (vs plain bf16), rel_rms {max(rels):.3e} (vs fp32); device op "
        f"{k2h_ops[0]!r}; kernel {ms:.4f} ms, {bd['bound_ms'] / ms:.1%} of its {bd['bound_ms']:.4f} ms bound "
        f"({bd['bound_by']}), plain {plain_ms:.4f} ms, the modules {library_ms:.4f} ms ({smi})")
    return {"shape": list(K2H_SHAPE), "max_abs_err": max(errs), "rel_rms": max(rels), "device_op": k2h_ops[0], "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, **bd}


def sdpa(q, k, v, scale):
    """One F.scaled_dot_product_attention call on (..., N, D) views: the
    library yardstick of the attention kernels."""
    return lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)


def heads_view(x, num_heads):
    b, n, c = x.shape
    return x.view(b, n, num_heads, c // num_heads).transpose(1, 2)


def load_harness():
    """scripts_torch/kernel_ab.py, the A/B harness of K6 and K7."""
    spec = importlib.util.spec_from_file_location("kernel_ab_harness", ROOT / "scripts_torch" / "kernel_ab.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_path(name, kernels, call):
    """Set every kernel's count to 0, run ``call()`` and return its output
    with the counts it left; ``<name>/wgmma`` counts the Hopper body's
    launches among those of K1 and K4."""
    for fn in kernels.values():
        fn.launches = 0
    for key in HOPPER:
        kernels[key].hopper_launches = 0
    out = call()
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in kernels.items()}
    launches.update({f"{k}/wgmma": kernels[k].hopper_launches for k in HOPPER})
    log(f"launches in one {name}: {launches}")
    return out, launches


def check_launches(name, launches, expected):
    if launches != expected:
        raise RuntimeError(f"{name}: kernel launches {launches} != expected {expected}")


def check_outputs(name, out, batch=BATCH):
    shapes = {"depth": 1, "points": 3, "rays": 3, "confidence": 1, "radius": 1}
    for key, ch in shapes.items():
        if tuple(out[key].shape) != (batch, SIDE, SIDE, ch):
            raise RuntimeError(f"{name}: {key} has shape {tuple(out[key].shape)}")
        if not torch.isfinite(out[key]).all():
            raise RuntimeError(f"{name}: {key} is not finite")
    if tuple(out["intrinsics"].shape) != (batch, 3, 3) or not torch.isfinite(out["intrinsics"]).all():
        raise RuntimeError(f"{name}: intrinsics malformed")
    if not (out["depth"] > 0).all():
        raise RuntimeError(f"{name}: depth is not positive everywhere")


def images_per_s(name, infer, smi, what=f"depth-only B={BATCH} {SIDE}x{SIDE}", iters=5):
    """``infer()`` of one batch of BATCH images in three timed rounds;
    returns the median rate."""
    rounds = []
    for _ in range(2):
        infer()
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            infer()
        torch.cuda.synchronize()
        rounds.append(BATCH * iters / (time.perf_counter() - t0))
    rate = statistics.median(rounds)
    log(f"infer {what} {name}: {BATCH / rate * 1e3:.2f} ms/batch, "
        f"{rate:.2f} images/s, median of rounds {', '.join(f'{r:.2f}' for r in rounds)} ({smi})")
    return rate


def depth_against_plain(name, model_cls, config, rgb, depth, kernels, dev, gate=1e-2, **infer_kwargs):
    """Run ``config`` with the same seeded weights on the plain path in fp32
    on the card, check it launched no kernel, and hold ``depth`` to its
    depth (median relative error <= ``gate``). Returns the reference
    outputs."""
    ref_model = model_cls.from_config(config, device=dev, dtype=torch.float32).init_params(seed=SEED)
    ref_model.set_kernels(False).eval()
    ref, ref_launches = run_path(f"{name} fp32 plain infer()", kernels, lambda: ref_model.infer(rgb, **infer_kwargs))
    if any(ref_launches.values()):
        raise RuntimeError(f"{name}: the plain reference run launched a kernel")
    rel = ((depth - ref["depth"]).abs() / ref["depth"].abs()).flatten()
    med, mx = rel.median().item(), rel.max().item()
    log(f"{name} depth vs fp32 plain path: median rel err {med:.3e}, max rel err {mx:.3e} (gate {gate})")
    if not med <= gate:
        raise RuntimeError(f"{name}: depth median relative error {med} > {gate}")
    return ref


def grad_phase(name, fn, plain, inputs, args, seed, wrapper):
    """The kernel route's gradients (``fn``, which launches ``wrapper``'s
    kernel once) against the plain version's autograd in fp32 on the same
    bf16 inputs (``inputs`` require grad; the gradient of a random
    cotangent), at the bf16 gates with the elementwise atol scaled by
    max(1, max |ref|); the forward takes the Hopper body and the backward
    launches nothing. Times the route's backward (CUDA events)."""
    before = wrapper.launches, wrapper.hopper_launches
    out = fn(*inputs, *args)
    gen = torch.Generator(device=out.device).manual_seed(seed)
    g = torch.randn(out.shape, generator=gen, device=out.device).to(out.dtype)
    grads = torch.autograd.grad(out, inputs, g, retain_graph=True)
    torch.cuda.synchronize()
    if (wrapper.launches, wrapper.hopper_launches) != (before[0] + 1, before[1] + 1):
        raise RuntimeError(f"{name}: the forward did not launch the Hopper body once, or the backward launched")
    ref_inputs = [t.detach().float().requires_grad_() for t in inputs]
    refs = torch.autograd.grad(plain(*ref_inputs, *args), ref_inputs, g.float())
    errs, rms = [], []
    for i, (got, ref) in enumerate(zip(grads, refs)):
        # a gradient is a sum over rows (K2's weight over M = 12248): the
        # elementwise atol scales with it, max(1, max |ref|), as K6's does
        atol = TOL_BF16["atol"] * max(1.0, ref.abs().max().item())
        errs.append(check_close(f"{name} grad {i} bf16", got, ref, rtol=TOL_BF16["rtol"], atol=atol))
        rms.append(((got.float() - ref).norm() / ref.norm()).item())
        if not rms[-1] <= REL_RMS_BF16:
            raise RuntimeError(f"{name} grad {i} bf16: relative RMS error {rms[-1]:.3e} > {REL_RMS_BF16}")
    del refs, ref_inputs
    bwd_ms = time_ms(lambda: torch.autograd.grad(out, inputs, g, retain_graph=True), iters=3, reps=2, warmup=1)
    log(f"{name} gradient: max_abs_err {max(errs):.3e}, rel_rms {max(rms):.3e} (bf16 gates); plain-VJP backward "
        f"{bwd_ms:.3f} ms")
    return {"max_abs_err": max(errs), "rel_rms": max(rms), "backward_ms": bwd_ms, "inputs": len(inputs)}


def train_phase(label, spec, kernels, none, smi, dev):
    """``label``'s training on the card (``build_trainer`` with no device
    named, the family's recipe, ``spec`` a TRAIN_FAMILIES entry). Returns
    (the launches of one optimizer step, the phase's figures)."""
    from unidepth_tpu_torch.datasets.dummy import Dummy
    from unidepth_tpu_torch.datasets.loader import eval_batches, make_batch
    from unidepth_tpu_torch.training.losses import build_losses
    from unidepth_tpu_torch.training.step import compute_losses_v1, compute_losses_v2, forward_backward, to_device
    from unidepth_tpu_torch.training.trainer import build_trainer, train_image_shape

    t_phase = time.perf_counter()
    config = json.loads(spec["config"].read_text())
    tr = config["training"]
    shape = train_image_shape(config)
    config["data"]["image_shape"] = list(shape)  # what build_trainer builds V1 at
    batch_size, accum = tr["batch_size"], tr["nsteps_accumulation_gradient"]
    t0 = time.perf_counter()
    trainer = build_trainer(config, seed=SEED)  # no device named: the card
    model, state = trainer.model, trainer.state
    placed = {(p.device.type, p.dtype) for p in model.parameters()}
    masters = {(t.device.type, t.dtype) for t in state.params.values()}
    if placed != {("cuda", torch.bfloat16)} or masters != {("cuda", torch.float32)}:
        raise RuntimeError(f"{label}: build_trainer placed the model on {placed} and the masters on {masters}")
    log(f"trainer: {label} {sum(t.numel() for t in state.params.values()) / 1e6:.1f} M trained params, bf16 model, "
        f"fp32 masters, moments and EMA, built in {time.perf_counter() - t0:.1f} s")
    batch = make_batch(Dummy(image_shape=shape, length=1024, seed=SEED), batch_size, accum,
                       np.random.default_rng(SEED))
    if batch["image"].shape != (accum, batch_size, *shape, 3):
        raise RuntimeError(f"{label} train batch {batch['image'].shape}")
    losses = build_losses(config)
    recipe = compute_losses_v1 if config["model"]["name"] == "UniDepthV1" else compute_losses_v2
    names = list(state.params)
    camera = [n for n in names if n.startswith(spec["no_gradient"])]
    noise = [n for n in names if spec["shift_invariant"] and re.fullmatch(spec["shift_invariant"], n)]

    # (a) one micro-batch of 2 images, no update: the kernel path (bf16)
    # against the same weights on the fp32 plain path
    micro = to_device({k: v[0, :TRAIN_CHECK_BATCH] for k, v in batch.items()}, dev)
    weights = dict(model.named_parameters())
    per_micro = spec["per_micro"]  # forward + the checkpointed blocks' recompute
    slots, micro_launches = run_path(f"{label} train micro-batch (B=2), kernel path", kernels,
                                     lambda: forward_backward(model, losses, micro, recipe))
    check_launches(f"{label} train micro-batch", micro_launches,
                   {**none, **per_micro, **{f"{k}/wgmma": v for k, v in per_micro.items()}})
    grads = {n: (torch.zeros_like(state.params[n]) if weights[n].grad is None else weights[n].grad.float())
             for n in names}
    model.zero_grad(set_to_none=True)
    ref_model = type(model).from_config(config, device=dev, dtype=torch.float32).init_params(seed=SEED)
    ref_model.set_kernels(False)
    ref_slots, ref_launches = run_path(f"{label} train micro-batch (B=2), fp32 plain path", kernels,
                                       lambda: forward_backward(ref_model, losses, micro, recipe))
    if any(ref_launches.values()):
        raise RuntimeError(f"{label}: the fp32 plain train path launched a kernel")
    ref_weights = dict(ref_model.named_parameters())
    drift = {k: abs(slots[k].item() - ref_slots[k].item()) / abs(ref_slots[k].item()) for k in slots}
    cosines, zero = {}, []
    for n in names:
        ref = ref_weights[n].grad
        got = grads[n]
        if not torch.isfinite(got).all():
            raise RuntimeError(f"{label} train micro-batch: the gradient of {n} is not finite")
        if ref is None or not ref.any():
            zero.append(n)
            if got.any():
                raise RuntimeError(f"{label} train micro-batch: {n} has a gradient where the fp32 plain path has none")
            continue
        if n in noise:  # zero in exact arithmetic: rounding noise on both paths
            continue
        cosines[n] = (torch.dot(got.flatten().double(), ref.flatten().double())
                      / (got.double().norm() * ref.double().norm()).clamp_min(1e-300)).item()
    del ref_model, ref_weights, grads
    model.zero_grad(set_to_none=True)
    worst = min(cosines, key=cosines.get)
    median = statistics.median(cosines.values())
    gates = spec["gates"]
    log(f"{label} train micro-batch kernel vs fp32 plain: loss slots "
        f"{', '.join(f'{k} {v:.3e}' for k, v in drift.items())} relative drift (gate {gates['loss']}); smallest "
        f"gradient cosine {cosines[worst]:.6f} ({worst}; gate {gates['cosine']}), median {median:.6f} (gate "
        f"{gates.get('median')}) over {len(cosines)} parameters; {len(noise)} shift-invariant left out")
    if sorted(zero) != sorted(camera):
        raise RuntimeError(f"{label}: parameters without a gradient {sorted(set(zero) ^ set(camera))} differ from "
                           f"the expected {len(camera)}")
    if max(drift.values()) > gates["loss"]:
        raise RuntimeError(f"{label} train loss slots drift {drift} past the gate {gates['loss']}")
    if cosines[worst] < gates["cosine"] or median < gates.get("median", -1.0):
        raise RuntimeError(f"{label} gradient cosine {cosines[worst]} of {worst} (median {median}) below the gates "
                           f"{gates}")

    # (b) the launches of one optimizer step; finiteness and coverage
    start = {n: t.clone() for n, t in state.params.items()}
    torch.cuda.reset_peak_memory_stats(dev)
    metrics, launches = run_path(f"{label} train step ({accum} x {batch_size} images)", kernels,
                                 lambda: trainer.step(batch, (SEED, 0)))
    state = trainer.state
    expected = {k: v * accum for k, v in per_micro.items()}
    check_launches(f"{label} train step", launches,
                   {**none, **expected, **{f"{k}/wgmma": v for k, v in expected.items()}})
    values = {k: v.item() for k, v in metrics.items()}
    if not all(np.isfinite(list(values.values()))):
        raise RuntimeError(f"{label} train step metrics not finite: {values}")
    opt = trainer.optimizer
    hp = opt.hyperparams(0)
    below = []  # updates under half the float32 spacing of every weight: they round away, in JAX as here
    for n in names:  # mu = (1 - b1) x the clipped gradient after one step
        mu = state.opt_state.mu[n]
        if not torch.isfinite(mu).all():
            raise RuntimeError(f"{label} train step: {n} gradient not finite")
        if n in noise:
            continue
        if bool(mu.any()) == (n in camera):
            raise RuntimeError(f"{label} train step: {n} gradient non-zero {bool(mu.any())}, expected non-zero "
                               f"{n not in camera}")
        if n not in camera and torch.equal(state.params[n], start[n]):
            p0 = start[n].double()
            u = (mu.double() / (1 - hp["b1"])) / ((state.opt_state.nu[n].double() / (1 - opt.b2)).sqrt() + opt.eps)
            update = hp["lr"] * opt.scales[n] * (u + (hp["wd"] * p0 if opt.wd_mask[n] else 0.0))
            spacing = (torch.nextafter(start[n].abs(), torch.tensor(float("inf"), device=dev)) - start[n].abs()).double()
            if not (update.abs() < spacing / 2).all():
                raise RuntimeError(f"{label} train step: {n} did not move, though its update reaches "
                                   f"{(update.abs() / spacing).max().item():.3g} of its weights' float32 spacing")
            below.append(n)
    # first-order descent: the step moved the weights against the step's
    # (clipped) gradient, mu / (1 - b1): g . (p1 - p0) < 0
    b1 = trainer.optimizer.hyperparams(0)["b1"]
    slope = sum(torch.dot(state.opt_state.mu[n].flatten().double(), (state.params[n] - start[n]).flatten().double())
                for n in names).item() / (1 - b1)
    if not slope < 0:
        raise RuntimeError(f"{label} train step: the update's inner product with the gradient is {slope}, not < 0")
    log(f"{label} train step 1: {values}; every parameter with an fp32 gradient but the {len(noise)} shift-invariant "
        f"ones has a finite, non-zero gradient and moved (but {len(below)} whose update is under half their float32 "
        f"spacing: {below[:4]}); the {len(camera)} without one stayed; first-order loss change g . (p1 - p0) = "
        f"{slope:.4e}")

    # (c) descent over 5 steps on the same batch; (d) ms a step (steps 3-5)
    totals, step_ms = [values["total"]], []
    for i in range(1, TRAIN_DESCENT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer.step(batch, (SEED, i))
        totals.append(metrics["total"].item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev)
    state = trainer.state
    if not all(np.isfinite(totals)) or (spec["descends"] and not totals[-1] < totals[0]):
        raise RuntimeError(f"{label} train loss did not descend over {TRAIN_DESCENT_STEPS} steps: {totals}")
    n_updates = state.ema.num_updates
    stale = [n for n in names if not torch.equal(state.ema.shadow[n], start[n])]
    if n_updates != TRAIN_DESCENT_STEPS or stale:  # the shadow moves every 10th update only
        raise RuntimeError(f"{label} EMA after {TRAIN_DESCENT_STEPS} steps: {n_updates} updates, moved {stale[:3]}")
    figures = {}
    if spec.get("validation"):
        # one validation under the EMA shadow: afterwards the live weights
        # and the masters are bitwise what they were
        live = {n: p.detach().clone() for n, p in model.named_parameters()}
        masters = {n: t.clone() for n, t in state.params.items()}
        val_data = Dummy(image_shape=shape, length=batch_size, seed=SEED + 1)
        val, val_launches = run_path(f"{label} validation under the EMA shadow", kernels,
                                     lambda: trainer.validate({"Dummy": eval_batches(val_data, batch_size)}))
        per_forward = spec["validation"]  # no recompute
        check_launches(f"{label} validation under the EMA shadow", val_launches,
                       {**none, **per_forward, **{f"{k}/wgmma": v for k, v in per_forward.items()}})
        if not all(np.isfinite(list(val["Dummy"].values()))):
            raise RuntimeError(f"{label} validation under the EMA shadow: {val}")
        moved = [n for n, p in model.named_parameters() if not torch.equal(p, live[n])]
        moved += [n for n, t in state.params.items() if not torch.equal(t, masters[n])]
        if moved:
            raise RuntimeError(f"{label} validation under the EMA shadow changed {moved[:3]}")
        log(f"{label} validation under the EMA shadow ({batch_size} images): d1 {val['Dummy']['d1']:.4f}, arel "
            f"{val['Dummy']['arel']:.4f}; the live bf16 weights and the fp32 masters bitwise unchanged")
        figures["ema_validation"] = val["Dummy"]
        del live, masters
    if spec.get("int8_masters"):
        # the trainer hands the trained fp32 weights to the model: int8
        # serving then quantizes them, not the init-time masters
        trainer.sync_model()
        for lin, (w, b) in model._int8_weights().items():
            trained = state.params[f"pixel_encoder.{lin}.weight"], state.params[f"pixel_encoder.{lin}.bias"]
            if not (torch.equal(w.to(dev), trained[0]) and torch.equal(b.to(dev), trained[1])):
                raise RuntimeError(f"{label}: int8 serving's master of {lin} is not the trained weight")
        log(f"{label}: after sync_model the int8 path's fp32 masters are the trained weights")
    ms = statistics.median(step_ms[-3:])
    rate = batch_size * accum / (ms / 1e3)
    log(f"{label} train totals: {', '.join(f'{t:.4f}' for t in totals)}"
        f"{' (descending)' if spec['descends'] else ' (finite: not held to fall at random weights)'}; EMA "
        f"{n_updates} updates, shadow unmoved (every 10th)")
    log(f"train step ({label}, {accum} x {batch_size} images at {shape[0]}x{shape[1]}, bf16 + fp32 masters): "
        f"{ms:.1f} ms/step median of steps {', '.join(f'{t:.1f}' for t in step_ms[-3:])}, {rate:.2f} images/s, "
        f"peak {peak / 2**30:.2f} GiB allocated ({smi})")
    figures.update({"shape": list(shape), "ms_per_step": ms, "images_per_s": rate, "peak_gib": peak / 2**30,
                    "totals": totals, "loss_drift": drift, "min_grad_cosine": cosines[worst],
                    "min_grad_cosine_param": worst, "median_grad_cosine": median,
                    "seconds": time.perf_counter() - t_phase})
    del trainer, model, state, start, batch, micro
    torch.cuda.empty_cache()
    return launches, figures


def smoke_camera_params(name, b, side, rng):
    """``b`` seeded cameras of model ``name`` for a side x side image,
    (b, P) float32: focal lengths 380-460 px around a centred principal
    point, mild distortion."""
    f = rng.uniform(380, 460, (b, 1))
    base = np.concatenate([f, f * rng.uniform(0.98, 1.02, (b, 1)), side / 2 + rng.uniform(-9, 9, (b, 2))], 1)
    if name == "Pinhole":
        extra = np.zeros((b, 0))
    elif name == "EUCM":  # alpha, beta
        extra = np.stack([rng.uniform(0.5, 0.65, b), rng.uniform(0.9, 1.1, b)], 1)
    elif name == "Spherical":  # W, H, hfov / 2, vfov / 2
        base[:, :2] = rng.uniform(80, 90, (b, 2))
        extra = np.stack([np.full(b, side), np.full(b, side), rng.uniform(0.8, 1.0, b) * np.pi / 2,
                          rng.uniform(0.35, 0.5, b) * np.pi], 1)
    elif name in ("OpenCV", "Fisheye624"):  # k1, k2, k3..k6, p1, p2, s1..s4
        extra = np.zeros((b, 12))
        extra[:, 0], extra[:, 1] = rng.uniform(-0.05, 0.08, b), rng.uniform(-0.02, 0.02, b)
        extra[:, 6:8], extra[:, 8:] = rng.uniform(-2e-3, 2e-3, (b, 2)), rng.uniform(-1e-3, 1e-3, (b, 4))
    else:  # MEI: k1, k2, p1, p2, xi
        extra = np.stack([rng.uniform(-0.05, 0.05, b), rng.uniform(-0.01, 0.01, b), rng.uniform(-1e-3, 1e-3, b),
                          rng.uniform(-1e-3, 1e-3, b), rng.uniform(0.3, 0.9, b)], 1)
    return np.concatenate([base, extra], 1).astype(np.float32)


def cameras_phase(dev, side=SIDE):
    """The six camera models on the card against the port's CPU results,
    and a mixed BatchCamera against its members. Returns the cameras on the
    card, by model, and the largest errors."""
    from unidepth_tpu_torch.geometry import cameras
    from unidepth_tpu_torch.geometry.coords import coords_grid

    rng = np.random.default_rng(SEED)
    uv_cpu = coords_grid(side, side).expand(EVAL_BATCH, side, side, 2)
    uv = uv_cpu.to(dev)
    on_card, errors = {}, {}
    for name in CAMERA_TYPES:
        params = torch.from_numpy(smoke_camera_params(name, EVAL_BATCH, side, rng))
        cpu, card = getattr(cameras, name)(params), getattr(cameras, name)(params.to(dev))
        ray_err = (card.get_rays(side, side).cpu() - cpu.get_rays(side, side)).abs().max().item()
        round_trip = card.project(card.unproject(uv)).cpu()
        rt_err = (round_trip - cpu.project(cpu.unproject(uv_cpu))).abs().max().item()
        uv_err = (round_trip - uv_cpu).abs().max().item()
        log(f"camera {name} (B={EVAL_BATCH}, {side}x{side}) card vs CPU: rays max_abs_err {ray_err:.3e} (atol "
            f"{RAY_ATOL}), project(unproject(uv)) {rt_err:.3e}, against uv {uv_err:.3e} (atol {ROUND_TRIP_ATOL} px)")
        if not (ray_err <= RAY_ATOL and rt_err <= ROUND_TRIP_ATOL and uv_err <= ROUND_TRIP_ATOL):
            raise RuntimeError(f"camera {name} on the card: rays {ray_err}, round trip {rt_err}, against uv {uv_err}")
        on_card[name] = card
        errors[name] = {"rays": ray_err, "round_trip": rt_err, "round_trip_vs_uv": uv_err}
    mixed = cameras.BatchCamera.concat([on_card[n] for n in CAMERA_TYPES])
    rays = mixed.get_rays(side, side)
    xyz = rays * 2.5
    projected = mixed.project(xyz)
    for i, name in enumerate(CAMERA_TYPES):
        rows = slice(i * EVAL_BATCH, (i + 1) * EVAL_BATCH)
        if not (torch.equal(rays[rows], on_card[name].get_rays(side, side))
                and torch.equal(projected[rows], on_card[name].project(xyz[rows]))):
            raise RuntimeError(f"mixed BatchCamera: the {name} members differ from {name} run alone")
    log(f"mixed BatchCamera of {mixed.batch} ({', '.join(CAMERA_TYPES)}): rays and projections equal to each "
        "model run alone, bit for bit")
    del rays, xyz, projected
    return on_card, errors


def eval_phase(config, kernels, none, smi, dev):
    """Evaluation on the card: the cameras, camera-prompted infer() and
    the 6-view surround, validate() with the 3-D metrics, and the eval and
    demo CLIs. Returns (the launches of one validate() batch, of one
    prompted infer(), the figures)."""
    from unidepth_tpu_torch.datasets.dummy import Dummy
    from unidepth_tpu_torch.datasets.loader import eval_batches
    from unidepth_tpu_torch.geometry.cameras import BatchCamera, Pinhole
    from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2
    from unidepth_tpu_torch.training.trainer import train_image_shape
    from unidepth_tpu_torch.utils.evaluation import DEPTH_METRICS, eval_3d, eval_depth
    from unidepth_tpu_torch.utils.misc import normalize_rgb
    from unidepth_tpu_torch.utils.validation import points_3d, validate

    figures = {}
    on_card, figures["camera_errors"] = cameras_phase(dev)
    per_forward = {"flash_attention_qkv": 24, "ln_dense": 24, "flash_attention": 4, **K5_HEADS}
    expected = {**none, **per_forward, **{f"{k}/wgmma": v for k, v in per_forward.items()}}

    # (b) camera-prompted infer() and the 6-view surround
    model = UniDepthV2.from_config(config).init_params(seed=SEED).eval()  # no device named: the card
    rgb = np.random.default_rng(SEED).integers(0, 256, (EVAL_BATCH, SIDE, SIDE, 3), dtype=np.uint8)
    prompt = BatchCamera.concat([type(on_card[n])(on_card[n].params[:2]) for n in PROMPT_TYPES])
    out, infer_launches = run_path("camera-prompted infer()", kernels, lambda: model.infer(rgb, camera=prompt))
    check_launches("camera-prompted infer()", infer_launches, expected)
    check_outputs("camera-prompted infer()", out)
    depth_against_plain("ViT-L/14 camera-prompted", UniDepthV2, config, rgb, out["depth"], kernels, dev,
                        camera=prompt, outputs=("depth", "intrinsics"))
    del out
    figures["camera_infer_images_per_s"] = images_per_s(
        "bf16 camera-prompted", lambda: model.infer(rgb, camera=prompt, outputs=("depth",)), smi,
        what=f"depth-only B={EVAL_BATCH} {SIDE}x{SIDE}, a BatchCamera of {', '.join(PROMPT_TYPES)}")
    surround = Pinhole(torch.tensor([[400.0 + 20 * i, 400.0 + 20 * i, SIDE / 2 + 4 * i, SIDE / 2 - 3 * i]
                                     for i in range(6)], device=dev))
    out6, launches6 = run_path("6-view surround infer()", kernels, lambda: model.infer(rgb[:6], camera=surround))
    check_launches("6-view surround infer()", launches6, expected)
    check_outputs("6-view surround infer()", out6, 6)
    spread = (out6["rays"][0] - out6["rays"][5]).abs().max().item()
    if not spread > 1e-3:
        raise RuntimeError(f"6-view surround: the rays of views 0 and 5 differ by {spread} only")
    log(f"6-view surround (six pinhole cameras, one B=6 batch): rays of views 0 and 5 differ by {spread:.3e}")
    del out6

    # (c) validate() on Dummy at the training shape, with the 3-D metrics
    shape = train_image_shape(config)
    data = Dummy(image_shape=shape, length=EVAL_BATCH * EVAL_BATCHES, seed=SEED)
    run = lambda: validate(model, {"Dummy": eval_batches(data, EVAL_BATCH)}, with_3d=True)  # noqa: E731
    results, val_launches = run_path(f"validate() ({EVAL_BATCHES} batches of {EVAL_BATCH} at {shape[0]}x{shape[1]})",
                                     kernels, run)
    check_launches("validate()", val_launches, {k: v * EVAL_BATCHES for k, v in expected.items()})
    metrics = results["Dummy"]
    if set(metrics) != {*DEPTH_METRICS, "chamfer", "F1"} or not all(np.isfinite(list(metrics.values()))):
        raise RuntimeError(f"validate(): metrics {metrics}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    figures["validate_ms_per_batch"] = (time.perf_counter() - t0) * 1e3 / EVAL_BATCHES
    # one batch's depth maps: the card's metrics against the CPU's
    batch = next(eval_batches(data, EVAL_BATCH))
    image, rays, gt, mask = (torch.as_tensor(batch[k]).to(dev) for k in ("image", "rays", "depth", "depth_mask"))
    with torch.inference_mode():
        pred = model.encode_decode(normalize_rgb(image), rays_gt=rays)["depth"].float()
    card, cpu = eval_depth(gt, pred, mask), eval_depth(gt.cpu(), pred.cpu(), mask.cpu())
    one_pixel = 1.0 / mask[0].sum().item()  # Dummy: every pixel valid
    for k in DEPTH_METRICS:
        # a metric that counts pixels may flip one a sample; the ssi family
        # rescales by a least-squares fit from float32 sums over every pixel,
        # summed in another order on the card
        if k.endswith("_ssi"):
            tol = dict(rtol=SSI_CPU_TOL, atol=SSI_CPU_TOL)
        else:
            tol = dict(rtol=EVAL_CPU_RTOL, atol=one_pixel if k in COUNTING_METRICS else 1e-6)
        torch.testing.assert_close(card[k].cpu(), cpu[k], **tol,
                                   msg=lambda msg, k=k: f"eval_depth {k}, card against CPU: {msg}")
    figures["ssi_card_vs_cpu"] = {k: (card[k].cpu() - cpu[k]).abs().max().item() for k in DEPTH_METRICS
                                  if k.endswith("_ssi")}
    thresholds = torch.exp(torch.linspace(float(np.log(0.01)), float(np.log(80.0 / 20.0)), 100, device=dev))
    pts = points_3d(rays, gt, pred, mask)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eval_3d(pts["points_gt"], pts["points_pred"], pts["mask3d"], thresholds)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    figures["eval_3d_ms_per_batch"] = statistics.median(times)
    sub = [pts[k][:2, ::2, ::2] for k in ("points_gt", "points_pred", "mask3d")]
    card3, cpu3 = eval_3d(*sub, thresholds), eval_3d(*(t.cpu() for t in sub), thresholds.cpu())
    torch.testing.assert_close(card3["chamfer"].cpu(), cpu3["chamfer"], rtol=1e-4, atol=0)
    torch.testing.assert_close(card3["F1"].cpu(), cpu3["F1"], rtol=0, atol=1e-3)
    perfect = eval_depth(gt, gt, mask)
    perfect3 = eval_3d(pts["points_gt"], pts["points_gt"], pts["mask3d"], thresholds)
    chamfer_bound = (8 * torch.finfo(torch.float32).eps) ** 0.5 * pts["points_gt"].norm(dim=-1).max().item()
    f1_max = (len(thresholds) - 1) / len(thresholds)
    if not (perfect["d1"].eq(1).all() and perfect["arel"].eq(0).all()
            and (perfect3["chamfer"] <= chamfer_bound).all() and (perfect3["F1"] - f1_max).abs().max() < 1e-6):
        raise RuntimeError(f"a perfect prediction: d1 {perfect['d1']}, arel {perfect['arel']}, chamfer "
                           f"{perfect3['chamfer']} (bound {chamfer_bound}), F1 {perfect3['F1']} (max {f1_max})")
    figures["validate"] = metrics
    log(f"validate() metrics: {json.dumps(metrics)}")
    log(f"validate(): {figures['validate_ms_per_batch']:.1f} ms a batch of {EVAL_BATCH} at {shape[0]}x{shape[1]} with "
        f"the 3-D metrics, eval_3d {figures['eval_3d_ms_per_batch']:.1f} ms of it ({smi}); card = CPU on the same "
        f"maps; a perfect prediction: chamfer <= {perfect3['chamfer'].max().item():.3e} (bound {chamfer_bound:.3e}), "
        f"F1 {f1_max}")
    del model, image, rays, gt, mask, pred, pts, sub
    torch.cuda.empty_cache()

    per_batch = {k: v // EVAL_BATCHES for k, v in val_launches.items()}
    return per_batch, infer_launches, figures


def v1_int8_phase(kernels, none, smi, dev):
    """UniDepthV1 ViT-L/14 int8 serving: refused before calibration,
    ``calibrate_int8_stages`` on V1_INT8_CALIB seeded images, then int8
    ``infer()`` of BATCH other images under the calibrated mask against the
    fp32 plain path, images/s beside bf16's; a ConvNeXt-L V1 refuses int8.
    Returns the int8 path's launches and the figures."""
    from unidepth_tpu_torch.models.unidepthv1.model import UniDepthV1

    t_phase = time.perf_counter()
    config = json.loads(CONFIG_V1["V1 ViT-L/14"].read_text())
    model = UniDepthV1.from_config(config).init_params(seed=SEED).eval()  # no device named: the card
    rng = np.random.default_rng(SEED + 7)
    calib = rng.integers(0, 256, (V1_INT8_CALIB, *V1_SHAPE, 3), dtype=np.uint8)
    rgb = rng.integers(0, 256, (BATCH, *V1_SHAPE, 3), dtype=np.uint8)
    try:
        model.set_serving_precision("int8")
        raise RuntimeError("V1 accepted int8 before calibrate_int8_stages")
    except ValueError as err:
        log(f"V1 int8 before calibration refused: {err}")
    t0 = time.perf_counter()
    report = model.calibrate_int8_stages(calib)
    log(f"V1 ViT-L/14 calibrate_int8_stages ({V1_INT8_CALIB} images at {V1_SHAPE[0]}x{V1_SHAPE[1]}, max_rel_err "
        f"{report['max_rel_err']}): per_stage {report['per_stage']}, selected {report['selected']}, rel_err "
        f"{report['rel_err']:.4e}, {time.perf_counter() - t0:.1f} s")
    if not (any(report["selected"]) and report["rel_err"] <= report["max_rel_err"] == 0.05):
        raise RuntimeError(f"V1 int8 calibration: {report}")
    model.set_serving_precision("int8")
    blocks = np.diff([0, *model.pixel_encoder.cfg.output_idx])  # blocks a stage: 5, 7, 6, 6
    int8_blocks = int(sum(n for n, on in zip(blocks, report["selected"]) if on))
    bf16_blocks = int(sum(blocks)) - int8_blocks
    expected = {"flash_attention_packed": int8_blocks, "flash_attention_qkv": bf16_blocks,
                "ln_dense": bf16_blocks + 6, "flash_attention": 3}  # + the decoder's 6 CvnxtBlocks, 3 layers_16
    expected = {k: v for k, v in expected.items() if v}
    out, launches = run_path("V1 int8 infer() under the calibrated mask", kernels, lambda: model.infer(rgb))
    check_launches("V1 int8 infer()", launches, {**none, **expected, **{f"{k}/wgmma": v for k, v in expected.items()}})
    for key, ch in (("depth", 1), ("points", 3)):
        if tuple(out[key].shape) != (BATCH, *V1_SHAPE, ch) or not torch.isfinite(out[key]).all():
            raise RuntimeError(f"V1 int8: {key} has shape {tuple(out[key].shape)} or is not finite")
    if not (out["depth"] > 0).all() or not torch.isfinite(out["intrinsics"]).all():
        raise RuntimeError("V1 int8: depth not positive or intrinsics not finite")
    ref_model = UniDepthV1.from_config(config, device=dev, dtype=torch.float32).init_params(seed=SEED)
    ref_model.set_kernels(False).eval()
    ref, ref_launches = run_path("V1 fp32 plain infer()", kernels, lambda: ref_model.infer(rgb))
    if any(ref_launches.values()):
        raise RuntimeError("V1 int8: the plain reference run launched a kernel")
    del ref_model
    rel = ((out["depth"] - ref["depth"]).abs() / (ref["depth"].abs() + 1e-6)).flatten()
    k_rel = ((out["intrinsics"] - ref["intrinsics"]).abs() / (ref["intrinsics"].abs() + 1e-6)).max().item()
    drift = {"depth_median": rel.median().item(), "depth_mean": rel.mean().item(),
             "depth_p99": torch.quantile(rel, 0.99).item(), "depth_max": rel.max().item(), "intrinsics_max": k_rel}
    log(f"V1 int8 vs fp32 plain path: {json.dumps(drift)} (gates {V1_INT8_GATES})")
    if not (drift["depth_mean"] < V1_INT8_GATES["mean"] and drift["depth_p99"] < V1_INT8_GATES["p99"]
            and k_rel < V1_INT8_GATES["intrinsics"]):
        raise RuntimeError(f"V1 int8 drift {drift} out of the gates {V1_INT8_GATES}")
    del out, ref
    what = f"B={BATCH} {V1_SHAPE[0]}x{V1_SHAPE[1]} (depth, points, intrinsics)"
    rates = {"int8": images_per_s("V1 ViT-L/14 int8 (calibrated mask)", lambda: model.infer(rgb), smi, what=what)}
    model.set_serving_precision("default")
    rates["bf16"] = images_per_s("V1 ViT-L/14 bf16 (same call)", lambda: model.infer(rgb), smi, what=what)
    del model
    torch.cuda.empty_cache()
    convnext = UniDepthV1.from_config(json.loads(CONFIG_V1["V1 ConvNeXt-L"].read_text()), device="cpu")
    try:
        convnext.set_serving_precision("int8")
        raise RuntimeError("V1 ConvNeXt-L accepted int8")
    except ValueError as err:
        if "requires a ViT encoder" not in str(err):
            raise
        log(f"V1 ConvNeXt-L int8 refused: {err}")
    del convnext
    figures = {"calibration": {"per_stage": report["per_stage"], "selected": report["selected"],
                               "rel_err": report["rel_err"]}, "drift": drift, "images_per_s": rates,
               "seconds": time.perf_counter() - t_phase}
    log(f"V1 int8 phase: {figures['seconds']:.1f} s")
    return launches, figures


def run_at_once(commands):
    """Each command (name -> argv) its own process, all at once on the one
    card, killed if still running after 600 s. Returns name -> (exit code,
    stdout, stderr) and the seconds until the last one ended."""
    procs = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as logs:
        try:
            for name, argv in commands.items():
                with open(Path(logs) / f"{name}.out", "w") as out, open(Path(logs) / f"{name}.err", "w") as err:
                    procs[name] = subprocess.Popen(argv, cwd=ROOT, stdout=out, stderr=err)
            for proc in procs.values():
                proc.wait(timeout=600)
        finally:
            for proc in procs.values():
                proc.kill()
                proc.wait()
        seconds = time.perf_counter() - t0
        return {name: (procs[name].returncode, (Path(logs) / f"{name}.out").read_text(),
                       (Path(logs) / f"{name}.err").read_text()) for name in commands}, seconds


def check_exit(script, result):
    code, stdout, stderr = result
    if code != 0:
        raise RuntimeError(f"{script} exited {code}:\n{stdout[-3000:]}\n{stderr[-3000:]}")
    return stdout


def cli_phase():
    """scripts_torch/eval.py (Dummy, the 3-D metrics, 2 batches), demo.py
    (random weights) and train.py (V1 ConvNeXt-L, TRAIN_CLI_STEPS steps on
    Dummy data), each its own process, all at once on the card: exit 0; the
    eval's metrics finite; the demo's ARel; the trainer's JSON line a step,
    its MetricLogger stream and one artifact PNG. Returns the eval's and
    the trainer's figures."""
    from unidepth_tpu_torch.utils.evaluation import DEPTH_METRICS
    from unidepth_tpu_torch.utils.png import read_png

    train_config = CONFIG_V1["V1 ConvNeXt-L"]
    with tempfile.TemporaryDirectory() as tmp:
        argv = {
            "eval": ["--config-file", str(CONFIG), "--dummy-data", "--eval-3d", "--max-iters", "2"],
            "demo": ["--output", str(Path(tmp) / "demo.png")],
            "train": ["--config-file", str(train_config), "--dummy-data", "--steps", str(TRAIN_CLI_STEPS),
                      "--checkpoint-dir", tmp],
        }
        results, seconds = run_at_once(
            {name: [sys.executable, str(ROOT / "scripts_torch" / f"{name}.py"), *a] for name, a in argv.items()})
        out = {name: check_exit(f"scripts_torch/{name}.py", results[name]) for name in argv}
        cli = json.loads(out["eval"].strip().splitlines()[-1])["eval"]["Dummy"]
        if set(cli) != {*DEPTH_METRICS, "chamfer", "F1"} or not all(np.isfinite(list(cli.values()))):
            raise RuntimeError(f"scripts_torch/eval.py: metrics {cli}")
        arel = [line for line in out["demo"].splitlines() if line.startswith("ARel: ")]
        if not arel:
            raise RuntimeError(f"scripts_torch/demo.py printed no ARel:\n{out['demo'][-3000:]}")
        steps = [json.loads(line) for line in out["train"].splitlines() if line.startswith('{"step"')]
        if [s["step"] for s in steps] != list(range(1, TRAIN_CLI_STEPS + 1)) or not all(
                np.isfinite(v) for s in steps for v in s.values()):
            raise RuntimeError(f"scripts_torch/train.py printed {steps}")
        records = [json.loads(line) for line in (Path(tmp) / f"{train_config.stem}.jsonl").read_text().splitlines()]
        images = [r[k] for r in records for k in r if k.startswith("image/")]
        if [r["step"] for r in records if "train/total" in r] != list(range(1, TRAIN_CLI_STEPS + 1)) or len(images) != 1:
            raise RuntimeError(f"scripts_torch/train.py's MetricLogger stream: {records}")
        grid = read_png(images[0])
        peak = [line for line in out["train"].splitlines() if line.startswith("peak device memory")]
    log(f"scripts_torch/eval.py, demo.py and train.py at once: exit 0 in {seconds:.1f} s; eval metrics finite; demo "
        f"{arel[0]} (random weights); train.py {' '.join(argv['train'][:-2])}: {len(records)} JSONL records, artifact "
        f"{grid.shape} PNG; {peak[0] if peak else ''}; step seconds {[round(s['seconds'], 2) for s in steps]}")
    return ({"eval_cli": cli, "demo_arel": arel[0], "cli_seconds": seconds},
            {"seconds": seconds, "steps": steps, "artifact_shape": list(grid.shape)})


class NpzShard:
    """An HDF5 shard's nodes, read from the .npz archive beside its path:
    ``with``, and ``shard[node]`` by the node's HDF5 path."""

    def __init__(self, path):
        self.npz = np.load(path)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.npz.close()

    def __getitem__(self, node):
        return self.npz[node.lstrip("/")]


def npz_shard(self, chunk_idx: int = 0):
    """``HDF5Dataset._h5`` over NpzShard archives (h5py absent)."""
    return NpzShard(Path(self.data_root) / f"{self.spec.hdf5_paths[chunk_idx]}.npz")


def serve_npz_shards():
    """Read every shard of the port's readers through ``npz_shard``: what a
    CLI run in its own process does when h5py is absent."""
    from unidepth_tpu_torch.datasets.base import HDF5Dataset

    HDF5Dataset._h5 = npz_shard


def write_shards(root, shards) -> str:
    """The synthetic shards under ``root``: HDF5 files, or NpzShard archives
    without h5py. Returns the storage used."""
    from unidepth_tpu_torch.datasets.synthetic import write_hdf5

    if not H5PY_ABSENT:
        write_hdf5(root, shards)
        return "hdf5"
    for path, nodes in shards.items():
        np.savez(Path(root) / f"{path}.npz", **nodes)
    return "npz archives, h5py absent"


def native_phase(shards):
    """The native helpers against their numpy versions on this host, bit for
    bit, on the shards' own blobs; each call's count shows the C code ran."""
    import zlib

    from unidepth_tpu_torch import native
    from unidepth_tpu_torch.utils.png import png_asarray, png_samples

    nodes = shards["nyuv2.hdf5"]
    packed = png_asarray(nodes["nyu/depth/0000000000.png"].tobytes())
    depth16 = png_asarray(shards["kitti.hdf5"][next(k for k in shards["kitti.hdf5"] if "/depth/" in k)].tobytes())
    rgb = png_samples(nodes["nyu/rgb/0000000000.png"].tobytes())[0]
    blob = nodes["nyu/rgb/0000000000.png"].tobytes()
    raw = zlib.decompress(blob[blob.index(b"IDAT") + 4 : blob.rindex(b"IEND") - 8])
    rows, stride = 40, rgb.shape[1] * 3  # the Python unfilter takes ~1 s a 100 rows
    kinds = sorted({raw[r * (stride + 1)] for r in range(rows)})
    if kinds != [0, 1, 2, 3, 4]:
        raise RuntimeError(f"native: the RGB rows carry filter types {kinds}, not all five")
    calls = {fn.__name__: fn.calls for fn in (native.unpack24_scale, native.scale_u16, native.normalize_u8,
                                              native.png_unfilter)}
    pairs = {
        "unpack24_scale": (native.unpack24_scale(packed, 1000.0), native.unpack24_scale_plain(packed, 1000.0)),
        "scale_u16": (native.scale_u16(depth16, 256.0), native.scale_u16_plain(depth16, 256.0)),
        "normalize_u8": (native.normalize_u8(rgb, (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
                         native.normalize_u8_plain(rgb, (0.485, 0.456, 0.406), (0.229, 0.224, 0.225))),
        "png_unfilter": (native.png_unfilter(raw, rows, stride, 3), native.png_unfilter_plain(raw, rows, stride, 3)),
    }
    for name, (got, ref) in pairs.items():
        if got.dtype != ref.dtype or not np.array_equal(got, ref):
            raise RuntimeError(f"native {name}: the C helper and its numpy version differ")
        if getattr(native, name).calls != calls[name] + 1:
            raise RuntimeError(f"native {name}: the call did not run the C library")
    log(f"native helpers (C, {native.build().parent.name}) against their numpy versions, bit for bit: "
        f"{', '.join(pairs)}; the unfilter over rows of filter types {kinds}")


def data_cli_phase(root, config_path, smi):
    """scripts_torch/train.py and eval.py over the shards, each in its own
    process on the card, both at once (through serve_npz_shards when h5py is
    absent): exit 0, finite losses a step, finite metrics a dataset."""
    launch = ("import runpy, sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
              + ("chip_smoke.serve_npz_shards(); " if H5PY_ABSENT else "")
              + "sys.argv = sys.argv[2:]; runpy.run_path(sys.argv[0], run_name='__main__')")
    runs = {
        "train": ["--config-file", str(config_path), "--data-root", str(root), "--steps", str(DATA_CLI_STEPS),
                  "--checkpoint-dir", str(Path(root) / "checkpoints")],
        "eval": ["--config-file", str(config_path), "--data-root", str(root), "--datasets", "KITTI", "NYUv2Depth",
                 "--max-iters", "2", "--batch", "4"],
    }
    results, seconds = run_at_once({name: [sys.executable, "-c", launch, str(ROOT),
                                           str(ROOT / "scripts_torch" / f"{name}.py"), *argv]
                                    for name, argv in runs.items()})
    figures = {}
    for name, argv in runs.items():
        stdout = check_exit(f"scripts_torch/{name}.py", results[name])
        lines = [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]
        if name == "train":
            steps = [line for line in lines if "step" in line and "val" not in line]
            if [s["step"] for s in steps] != list(range(1, DATA_CLI_STEPS + 1)) or not all(
                    np.isfinite(v) for s in steps for v in s.values()):
                raise RuntimeError(f"scripts_torch/train.py printed {steps}")
            figures[name] = {"totals": [s["total"] for s in steps], "seconds": seconds}
        else:
            metrics = lines[-1]["eval"]
            if sorted(metrics) != ["KITTI", "NYUv2Depth"] or not all(
                    np.isfinite(v) for r in metrics.values() for v in r.values()):
                raise RuntimeError(f"scripts_torch/eval.py printed {metrics}")
            figures[name] = {"d1": {k: r["d1"] for k, r in metrics.items()}, "seconds": seconds}
        log(f"scripts_torch/{name}.py {' '.join(argv)}: exit 0 in {seconds:.1f} s; {figures[name]} ({smi})")
    return figures


def pillow_reference(name, img, value):
    """What the JAX package's transform ``name`` computes through Pillow on
    ``img`` at ``value`` (its level, threshold or bits)."""
    from PIL import Image, ImageEnhance, ImageOps

    pil = Image.fromarray(img)
    enhance = {"RandomSaturation": ImageEnhance.Color, "RandomSharpness": ImageEnhance.Sharpness,
               "RandomBrightness": ImageEnhance.Brightness, "RandomContrast": ImageEnhance.Contrast}
    if name in enhance:
        return np.asarray(enhance[name](pil).enhance(2.0**value))
    if name == "RandomColor":
        hsv = np.asarray(pil.convert("HSV")).copy()
        hsv[..., 0] = (hsv[..., 0].astype(np.int16) + int(value * 255)) % 256
        return np.asarray(Image.fromarray(hsv, "HSV").convert("RGB"))
    if name == "RandomSolarize":
        return np.asarray(ImageOps.solarize(pil, threshold=value))
    if name == "RandomPosterize":
        return np.asarray(ImageOps.posterize(pil, bits=value))
    return np.asarray({"RandomAutoContrast": ImageOps.autocontrast, "RandomEqualize": ImageOps.equalize}[name](pil))


def pillow_phase(smi):
    """(f)(a): each numpy transform of PILLOW_CHECKS against Pillow on this
    host, bit for bit, at prob 1 on AUG_SEEDS seeded frames of each
    AUG_FRAMES shape. Returns the Pillow version and the count of checks."""
    import PIL

    from unidepth_tpu_torch.datasets import pipelines as P
    from unidepth_tpu_torch.datasets.synthetic import _image

    t0 = time.perf_counter()
    checked = 0
    for h, w in AUG_FRAMES:
        for seed in range(AUG_SEEDS):
            img = _image(np.random.default_rng(seed), h, w)
            for name, (param, values) in PILLOW_CHECKS.items():
                for value in values:
                    transform = getattr(P, name)(prob=1.0, **({param: value} if param else {}))
                    got = transform({"image": img.copy()}, np.random.default_rng(seed))["image"]
                    want = pillow_reference(name, img, value)
                    if got.dtype != want.dtype or got.shape != want.shape or not np.array_equal(got, want):
                        raise RuntimeError(f"augment: {name}({param}={value}) at {h}x{w}, seed {seed}, differs from "
                                           f"Pillow {PIL.__version__} on {np.count_nonzero(got != want)} values")
                    checked += 1
    log(f"augment: the numpy transforms against Pillow {PIL.__version__}, bit for bit: {checked} checks "
        f"({', '.join(PILLOW_CHECKS)}) at {AUG_FRAMES}, {AUG_SEEDS} seeds each, in {time.perf_counter() - t0:.1f} s")
    return PIL.__version__, checked


class CountedTransform:
    """A transform that counts its calls and the validity pixels it turned
    False (under a lock: the loader's threads share it), and records any
    exception before raising it again, so that the loader's retry of a
    failed sample cannot hide it."""

    def __init__(self, transform):
        self.transform, self.name = transform, type(transform).__name__
        self.calls, self.zeroed, self.errors = 0, 0, []
        self.lock = threading.Lock()

    def __call__(self, sample, rng):
        valid = int(np.count_nonzero(sample["validity"]))
        try:
            sample = self.transform(sample, rng)
        except Exception as e:
            with self.lock:
                self.errors.append(repr(e))
            raise
        zeroed = valid - int(np.count_nonzero(sample["validity"]))
        with self.lock:
            self.calls += 1
            self.zeroed += max(zeroed, 0)
        return sample


def sixteen_transforms():
    """The fifteen random transforms no dataset builds, at prob 1 and their
    default ranges, then ``Normalize``."""
    from unidepth_tpu_torch.datasets import pipelines as P
    from unidepth_tpu_torch.utils.constants import IMAGENET_DATASET_MEAN, IMAGENET_DATASET_STD

    random = [getattr(P, name)(prob=1.0) for name in (
        "Rotate", "RandomSaturation", "RandomSharpness", "RandomBrightness", "RandomContrast", "RandomColor",
        "RandomInvert", "RandomAutoContrast", "RandomShear", "RandomTranslate", "RandomSolarize", "RandomPosterize",
        "RandomEqualize", "RandomMasking")]
    return [*random, P.RandomFiller(), P.Normalize(IMAGENET_DATASET_MEAN, IMAGENET_DATASET_STD)]


def loader_rate(it):
    """Batches a second of a loader's iterator ``it`` alone once it runs: its
    first batch is its start, the next DATA_LOADER_BATCHES - 1 are timed."""
    next(it)
    t0 = time.perf_counter()
    for _ in range(DATA_LOADER_BATCHES - 1):
        next(it)
    return (DATA_LOADER_BATCHES - 1) / (time.perf_counter() - t0)


def augment_phase(kernels, none, smi, dev, trainer, datasets, loader, rate_without):
    """(f): the sixteen transforms appended to each reader's augmenter. (a)
    the numpy ones against Pillow; (b) the loader alone with them at the
    shape seed whose rate without them the data phase took
    (``rate_without``), then AUG_STEPS steps of V2 ViT-L/14 fed through them
    from the same running loader (a batch is built on one thread: a fresh
    loader's first batch takes ~16 samples' time); (c) ms a sample of each
    on one host core at 375 x 1242. Returns the figures."""
    from unidepth_tpu_torch.datasets.loader import device_prefetch
    from unidepth_tpu_torch.datasets.pipelines import Compose
    from unidepth_tpu_torch.datasets.synthetic import _image

    t_phase = time.perf_counter()
    pil_version, checked = pillow_phase(smi)
    counted = [CountedTransform(t) for t in sixteen_transforms()]
    own = [ds.augmenter for ds in datasets]
    for ds in datasets:
        ds.augmenter = Compose([ds.augmenter, *counted])
    feed = loader(SEED + 1)
    it = iter(feed)
    rates = {"without": rate_without, "with": loader_rate(it)}
    log(f"augment: the loader alone ({DATA_THREADS} threads) {rates['without']:.3f} batches/s without the sixteen "
        f"transforms, {rates['with']:.3f} with them ({smi})")

    expected_shapes = [feed.shape_for_batch(DATA_LOADER_BATCHES + n) for n in range(AUG_STEPS)]
    steps = []

    def run():
        batches = device_prefetch(it, dev, size=2)
        for i in range(AUG_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = next(batches)
            t1 = time.perf_counter()
            metrics = trainer.step(batch, (SEED + 1, i))
            values = {k: v.item() for k, v in metrics.items()}
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            shape = tuple(batch["image"].shape[-3:-1])
            invalid = int((batch["validity_mask"] == 0).sum().item())
            steps.append({"shape": list(shape), "wait_ms": (t1 - t0) * 1e3, "ms": (t2 - t0) * 1e3,
                          "total": values["total"], "invalid_pixels": invalid})
            if not all(np.isfinite(list(values.values()))):
                raise RuntimeError(f"augment: step {i + 1} at {shape} has non-finite metrics {values}")
            if shape != expected_shapes[i] or batch["image"].device.type != dev.type:
                raise RuntimeError(f"augment: batch {i} of shape {shape} on {batch['image'].device}, expected "
                                   f"{expected_shapes[i]}")
            log(f"augment step {i + 1}: {shape[0]}x{shape[1]}, host wait {steps[-1]['wait_ms']:.1f} ms, step "
                f"{steps[-1]['ms']:.1f} ms, total {values['total']:.4f}, {invalid} pixels of validity_mask 0 ({smi})")
        batches.close()

    _, launches = run_path(f"V2 ViT-L/14 training through the sixteen transforms ({AUG_STEPS} steps)", kernels, run)
    feed.close()
    expected = {k: v * AUG_STEPS for k, v in {"flash_attention_qkv": 96, "ln_dense": 96, "flash_attention": 8}.items()}
    check_launches("augmented training", launches, {**none, **expected, **{f"{k}/wgmma": v for k, v in expected.items()}})
    calls = {c.name: c.calls for c in counted}
    errors = {c.name: c.errors for c in counted if c.errors}
    if errors or not all(calls.values()):
        raise RuntimeError(f"augment: calls {calls}, errors {errors}")
    zeroed = {c.name: c.zeroed for c in counted if c.name in GEOMETRIC}
    if not sum(zeroed.values()) or not all(s["invalid_pixels"] for s in steps):
        raise RuntimeError(f"augment: validity pixels zeroed {zeroed}; validity_mask zeros a step "
                           f"{[s['invalid_pixels'] for s in steps]}")
    for ds, aug in zip(datasets, own):
        ds.augmenter = aug

    # (c) ms a sample of each transform, one at a time in this thread (the loader closed)
    h, w = AUG_FRAMES[0]
    rng = np.random.default_rng(SEED)
    base = {"image": _image(rng, h, w), "depth": rng.uniform(1.0, 80.0, (h, w)).astype(np.float32),
            "validity": rng.random((h, w)) < 0.9, "K": np.eye(3, dtype=np.float32)}
    sample_ms = {}
    for c in counted:
        times = []
        for rep in range(AUG_TIMING_REPS):
            sample = copy.deepcopy(base)
            t0 = time.perf_counter()
            c.transform(sample, np.random.default_rng(rep))
            times.append((time.perf_counter() - t0) * 1e3)
        sample_ms[c.name] = statistics.median(times)
    log(f"augment: ms a sample at {h}x{w} on one host core, median of {AUG_TIMING_REPS}: "
        f"{', '.join(f'{k} {v:.2f}' for k, v in sample_ms.items())}; all sixteen {sum(sample_ms.values()):.1f} ({smi})")
    figures = {"pillow": pil_version, "pillow_checks": checked, "loader_batches_per_s": rates, "steps": steps,
               "launches": {k: launches[k] for k in expected},
               "calls": calls, "validity_zeroed": zeroed, "sample_ms_375x1242": sample_ms, "device": smi,
               "seconds": time.perf_counter() - t_phase}
    log(f"augment step: {figures['seconds']:.1f} s")
    return figures


def data_phase(kernels, none, smi, dev):
    """The data layer on the card: synthetic shards of DATA_NAMES, the native
    helpers against their numpy versions, V2 ViT-L/14 trained from
    WeightedConcat -> ShapeSampler -> Loader (DATA_THREADS threads) ->
    device_prefetch for DATA_STEPS steps of 8 x 2 images, the loader alone,
    the upload pinned and pageable, then the CLIs. Returns the loader-fed
    run's launches and the figures."""
    from unidepth_tpu_torch import native
    from unidepth_tpu_torch.datasets.base import HDF5Dataset
    from unidepth_tpu_torch.datasets.loader import Loader, ShapeSampler, WeightedConcat, device_prefetch
    from unidepth_tpu_torch.datasets.sequence import SequenceHDF5Dataset
    from unidepth_tpu_torch.datasets.specs import SPECS
    from unidepth_tpu_torch.datasets.synthetic import SHAPES, make_shards
    from unidepth_tpu_torch.training.trainer import build_trainer

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    t0 = time.perf_counter()
    shards = make_shards(DATA_NAMES, DATA_SAMPLES, SEED)
    storage = write_shards(root, shards)
    log(f"data: {DATA_SAMPLES} synthetic samples of each of {DATA_NAMES} at {[SHAPES[n] for n in DATA_NAMES]} "
        f"({sum(a.nbytes for v in shards.values() for a in v.values()) / 2**20:.1f} MiB of PNG), storage "
        f"{storage}, made in {time.perf_counter() - t0:.1f} s")
    native_phase(shards)
    del shards

    config = json.loads(CONFIG.read_text())
    config["data"]["train_datasets"] = list(DATA_NAMES)
    tr = config["training"]
    batch_size, accum = tr["batch_size"], tr["nsteps_accumulation_gradient"]
    trainer = build_trainer(config, seed=SEED)  # no device named: the card
    sc = trainer.model.shape_constraints
    sampler = ShapeSampler({k: sc[k] for k in ("ratio_bounds", "pixels_min", "pixels_max", "shape_mult")})
    aug = config["data"]["augmentations"]

    def reader(name):
        base = SequenceHDF5Dataset if SPECS[name].kind == "sequence" else HDF5Dataset
        cls = type(f"Npz{base.__name__}", (base,), {"_h5": npz_shard}) if H5PY_ABSENT else base
        return cls(SPECS[name], data_root=str(root), image_shape=(476, 630), augmentations=aug)

    datasets = [reader(n) for n in DATA_NAMES]

    def loader(seed):
        return Loader(WeightedConcat(datasets), batch_size=batch_size, shape_sampler=sampler, accum=accum,
                      num_threads=DATA_THREADS, seed=seed, shape_seed=seed)

    # the loader alone: batches a second once it runs
    alone = loader(SEED + 1)
    it = iter(alone)
    rate_alone = loader_rate(it)
    host_batch = next(it)
    alone.close()
    if any(t.is_alive() for t in alone._threads):
        raise RuntimeError("data: Loader.close() left a worker thread alive")
    log(f"data: the loader alone ({DATA_THREADS} threads, {accum} x {batch_size} images a batch): "
        f"{rate_alone:.3f} batches/s ({smi})")

    # one batch's upload: pageable, and pinned as device_prefetch sends it
    def pageable():
        return {k: torch.as_tensor(v).to(dev) for k, v in host_batch.items()}

    def pinned():
        return {k: torch.from_numpy(v).pin_memory().to(dev, non_blocking=True) for k, v in host_batch.items()}

    upload = {}
    for name, fn in (("pageable", pageable), ("pinned", pinned), ("pinned_2", pinned), ("pageable_2", pageable)):
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        upload[name] = statistics.median(times)
    nbytes_batch = sum(v.nbytes for v in host_batch.values())
    log(f"data: one batch's upload ({nbytes_batch / 2**20:.1f} MiB at {host_batch['image'].shape[2:4]}), median of 5: "
        f"pageable {upload['pageable']:.2f} / {upload['pageable_2']:.2f} ms, pinned (page-locked copy + "
        f"non-blocking copy) {upload['pinned']:.2f} / {upload['pinned_2']:.2f} ms ({smi})")

    # V2 ViT-L/14 trained from the loader; every count set to 0 just before
    native_before = {fn.__name__: fn.calls for fn in (native.unpack24_scale, native.scale_u16, native.png_unfilter)}
    feed = loader(SEED)
    expected_shapes = [feed.shape_for_batch(n) for n in range(DATA_STEPS)]
    if len(set(expected_shapes)) < 3 or DATA_LARGEST not in expected_shapes:
        raise RuntimeError(f"data: the sampler's first {DATA_STEPS} shapes {expected_shapes}")
    steps = []
    last = None

    def run():
        nonlocal last
        batches = device_prefetch(feed, dev, size=2)
        for i in range(DATA_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = next(batches)
            t1 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats(dev)
            metrics = trainer.step(batch, (SEED, i))
            values = {k: v.item() for k, v in metrics.items()}
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            shape = tuple(batch["image"].shape[2:4])
            steps.append({"shape": list(shape), "wait_ms": (t1 - t0) * 1e3, "ms": (t2 - t0) * 1e3,
                          "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30, "total": values["total"]})
            if not all(np.isfinite(list(values.values()))):
                raise RuntimeError(f"data: step {i + 1} at {shape} has non-finite metrics {values}")
            if shape != expected_shapes[i] or shape[0] % 14 or shape[1] % 14 or batch["image"].device.type != dev.type:
                raise RuntimeError(f"data: batch {i} of shape {shape} on {batch['image'].device}, expected "
                                   f"{expected_shapes[i]}")
            log(f"data step {i + 1}: {accum} x {batch_size} images at {shape[0]}x{shape[1]} "
                f"({(shape[0] // 14) * (shape[1] // 14) + 1} tokens): host wait {steps[-1]['wait_ms']:.1f} ms, "
                f"step {steps[-1]['ms']:.1f} ms, peak {steps[-1]['peak_gib']:.2f} GiB, total {values['total']:.4f} "
                f"({smi})")
            last = batch
        batches.close()

    _, launches = run_path(f"V2 ViT-L/14 data-fed training ({DATA_STEPS} steps)", kernels, run)
    feed.close()
    per_step = {"flash_attention_qkv": 96, "ln_dense": 96, "flash_attention": 8}
    expected = {k: v * DATA_STEPS for k, v in per_step.items()}
    check_launches("V2 ViT-L/14 data-fed training", launches,
                   {**none, **expected, **{f"{k}/wgmma": v for k, v in expected.items()}})
    decoded = {name: getattr(native, name).calls - n for name, n in native_before.items()}
    if not all(decoded.values()):
        raise RuntimeError(f"data: the native helpers' calls during the run {decoded}: one never ran")
    # the same step on a premade batch (the last, already on the card)
    premade = []
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.step(last, (SEED, DATA_STEPS + i))["total"].item()
        torch.cuda.synchronize()
        premade.append((time.perf_counter() - t0) * 1e3)
    largest = [s for s in steps if tuple(s["shape"]) == DATA_LARGEST]
    log(f"data: at {DATA_LARGEST[0]}x{DATA_LARGEST[1]} a loader-fed step {largest[-1]['ms']:.1f} ms (host wait "
        f"{largest[-1]['wait_ms']:.1f}) against {statistics.median(premade):.1f} ms on a premade batch on the card "
        f"({', '.join(f'{t:.1f}' for t in premade)}); peak {max(s['peak_gib'] for s in largest):.2f} GiB; native calls "
        f"{decoded} ({smi})")
    augment = augment_phase(kernels, none, smi, dev, trainer, datasets, loader, rate_alone)
    del trainer, last, datasets
    torch.cuda.empty_cache()

    # the CLIs, each in its own process: V2 ViT-L/14 over the shards, 4 images a step
    cli_config = dict(config)
    cli_config["training"] = {**tr, "batch_size": 4, "nsteps_accumulation_gradient": 1}
    cli_config["data"] = {**config["data"], "val_datasets": ["NYUv2Depth"]}
    (root / "config.json").write_text(json.dumps(cli_config))
    cli = data_cli_phase(root, root / "config.json", smi)
    tmp.cleanup()
    figures = {"storage": storage, "samples": DATA_SAMPLES, "datasets": list(DATA_NAMES), "threads": DATA_THREADS,
               "loader_batches_per_s": rate_alone, "upload_ms": upload, "upload_mib": nbytes_batch / 2**20,
               "steps": steps, "premade_ms": premade, "largest": list(DATA_LARGEST),
               "peak_gib_largest": max(s["peak_gib"] for s in largest), "native_calls": decoded, "cli": cli,
               "augment": augment, "device": smi, "seconds": time.perf_counter() - t_phase}
    log(f"data phase: {figures['seconds']:.1f} s")
    return launches, figures


def check_v2old_outputs(name, out):
    b, (h, w) = BATCH, V2OLD_IMAGE
    for key, ch in (("depth", 1), ("confidence", 1), ("points", 3)):
        if tuple(out[key].shape) != (b, h, w, ch) or not torch.isfinite(out[key]).all():
            raise RuntimeError(f"{name}: {key} has shape {tuple(out[key].shape)} or is not finite")
    if tuple(out["intrinsics"].shape) != (b, 3, 3) or not torch.isfinite(out["intrinsics"]).all():
        raise RuntimeError(f"{name}: intrinsics malformed")
    if not ((out["depth"] > 0).all() and (out["confidence"] >= 0).all() and (out["confidence"] <= 1).all()):
        raise RuntimeError(f"{name}: depth not positive or confidence outside [0, 1]")


def v2old_phase(kernels, none, smi, dev):
    """UniDepthV2old ViT-L/14 ``infer()`` at B = 8 on 480 x 640 in bf16, then
    in blanket int8, each against the fp32 plain path. Returns the launches
    of both paths and the figures."""
    from unidepth_tpu_torch.models.unidepthv2.old import UniDepthV2old

    t_phase = time.perf_counter()
    config = json.loads(CONFIG_V2OLD.read_text())
    model = UniDepthV2old.from_config(config).init_params(seed=SEED).eval()  # no device named: the card
    placed = {(p.device.type, p.dtype) for p in model.parameters()}
    if placed != {("cuda", torch.bfloat16)}:
        raise RuntimeError(f"V2old from_config with no device placed the model on {placed}")
    net = model._shapes(V2OLD_IMAGE)[0]
    if net != V2OLD_NET:
        raise RuntimeError(f"V2old network shape {net} for {V2OLD_IMAGE}, expected {V2OLD_NET}")
    log(f"model: V2old ViT-L/14 {sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params, bf16 on the card; "
        f"{V2OLD_IMAGE[0]}x{V2OLD_IMAGE[1]} images run at {net[0]}x{net[1]} ({V2OLD_TOKENS} tokens)")
    rgb = np.random.default_rng(SEED).integers(0, 256, (BATCH, *V2OLD_IMAGE, 3), dtype=np.uint8)
    figures, launches = {}, {}
    per_path = {"bf16": {"flash_attention_qkv": 24, "ln_dense": 30},  # 24 blocks; 24 + 6 CvnxtBlocks
                "int8": {"flash_attention_packed": 24, "ln_dense": 6}}  # the 6 CvnxtBlocks only
    ref = None
    for precision, expected in per_path.items():
        model.set_serving_precision("default" if precision == "bf16" else "int8")
        out, launches[precision] = run_path(f"V2old {precision} infer()", kernels, lambda: model.infer(rgb))
        check_launches(f"V2old {precision} infer()", launches[precision],
                       {**none, **expected, **{f"{k}/wgmma": v for k, v in expected.items()}})
        check_v2old_outputs(f"V2old {precision} infer()", out)
        if ref is None:
            ref = depth_against_plain("V2old ViT-L/14", UniDepthV2old, config, rgb, out["depth"], kernels, dev,
                                      gate=V2OLD_DEPTH_GATE)
        rel = ((out["depth"] - ref["depth"]).abs() / ref["depth"].abs()).flatten()
        k_rel = ((out["intrinsics"] - ref["intrinsics"]).abs() / (ref["intrinsics"].abs() + 1e-6)).max().item()
        drift = {"depth_median": rel.median().item(), "depth_mean": rel.mean().item(),
                 "depth_p99": torch.quantile(rel, 0.99).item(),
                 "depth_max": rel.max().item(), "intrinsics_max": k_rel}
        log(f"V2old {precision} vs fp32 plain path: {json.dumps(drift)}")
        if precision == "int8":
            gates = V2OLD_INT8_GATES
            if not (drift["depth_mean"] < gates["mean"] and drift["depth_p99"] < gates["p99"]
                    and k_rel < gates["intrinsics"]):
                raise RuntimeError(f"V2old int8 drift {drift} out of the gates {gates}")
        del out
        figures[precision] = {"drift": drift, "images_per_s": images_per_s(
            f"V2old {precision}", lambda: model.infer(rgb), smi,
            what=f"B={BATCH} {V2OLD_IMAGE[0]}x{V2OLD_IMAGE[1]} (network {net[0]}x{net[1]}; depth, confidence, "
                 "points, intrinsics)")}
    figures["seconds"] = time.perf_counter() - t_phase
    log(f"V2old phase: {figures['seconds']:.1f} s")
    del model, ref
    torch.cuda.empty_cache()
    return launches, figures


def serve_cli_phase(kernels, none, smi, model_cls, config):
    """(a) scripts_torch/infer.py's ``main`` in this process on the demo image
    and two 6-view frames (launches counted), every depth PNG held to a
    direct ``infer()`` of the same batch. Returns the CLI's launches, its
    figures and the direct path's model (the exporter's), then starts the
    command line on the demo image alone as a subprocess with --save-ply
    --save-panel, returned with its output folder for ``serve_cli_check``."""
    from unidepth_tpu_torch.datasets.base import decode_rgb
    from unidepth_tpu_torch.utils.png import read_png, write_png

    spec = importlib.util.spec_from_file_location("infer_cli", ROOT / "scripts_torch" / "infer.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    tmp = Path(tempfile.mkdtemp(prefix="serve_"))
    src = tmp / "in"
    (src / "assets" / "demo").mkdir(parents=True)
    (src / "assets" / "demo" / "rgb.png").write_bytes(DEMO_RGB.read_bytes())
    rng = np.random.default_rng(SEED)
    for frame in ("frame0", "frame1"):
        (src / frame).mkdir()
        for cam in SERVE_CAMS:
            write_png(src / frame / f"{cam}.png", rng.integers(0, 256, (*SERVE_FRAME, 3), dtype=np.uint8))
    t0 = time.perf_counter()
    rate, launches = run_path("scripts_torch/infer.py main()", kernels, lambda: cli.main(
        ["--input", str(src), "--output", str(tmp / "out"), "--batch", str(SERVE_BATCH)]))
    seconds = time.perf_counter() - t0
    per_batch = {"flash_attention_qkv": 24, "ln_dense": 24, "flash_attention": 4, **K5_HEADS}
    check_launches("scripts_torch/infer.py", launches,
                   {**none, **{k: SERVE_BATCHES * n for k, n in per_batch.items()},
                    **{f"{k}/wgmma": SERVE_BATCHES * n for k, n in per_batch.items()}})
    paths = sorted(p for p in src.rglob("*.png"))
    stems = ["assets_demo_rgb"] + [f"{f}_{c}" for f in ("frame0", "frame1") for c in SERVE_CAMS]
    if sorted(p.name for p in (tmp / "out").iterdir()) != sorted(f"{s}_depth.png" for s in stems):
        raise RuntimeError(f"scripts_torch/infer.py wrote {sorted(p.name for p in (tmp / 'out').iterdir())}")
    # the CLI's batches: sorted paths by size bucket (the demo image, then the
    # frames), SERVE_BATCH at a time
    model = model_cls.from_config(config).init_params(seed=SEED).eval()
    batches = [paths[:1], paths[1 : 1 + SERVE_BATCH], paths[1 + SERVE_BATCH :]]
    worst = 0
    for batch in batches:
        imgs = np.stack([decode_rgb(p.read_bytes()) for p in batch])
        depth = model.infer(imgs)["depth"][..., 0].float().cpu().numpy()
        for j, p in enumerate(batch):
            stem = "_".join(p.relative_to(src).with_suffix("").parts)
            want = np.clip(depth[j] * 1000.0, 0, 65535).astype(np.uint16)
            worst = max(worst, int(np.abs(read_png(tmp / "out" / f"{stem}_depth.png").astype(np.int64) - want).max()))
    if worst > SERVE_DEPTH_MM:
        raise RuntimeError(f"scripts_torch/infer.py depth PNGs {worst} mm off a direct infer() (> {SERVE_DEPTH_MM})")
    log(f"scripts_torch/infer.py: {len(paths)} images in {len(batches)} batches, {rate:.2f} images/s "
        f"({seconds:.1f} s with the model's build); depth PNGs within {worst} mm of a direct infer() ({smi})")
    demo = tmp / "demo"
    demo.mkdir()
    (demo / "rgb.png").write_bytes(DEMO_RGB.read_bytes())
    proc = subprocess.Popen([sys.executable, str(ROOT / "scripts_torch" / "infer.py"), "--input", str(demo),
                             "--output", str(tmp / "demo_out"), "--save-ply", "--save-panel"], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    figures = {"images": len(paths), "batches": len(batches), "images_per_s": rate, "seconds": seconds,
               "depth_png_max_mm": worst}
    return launches, figures, model, (proc, tmp)


def serve_cli_check(proc, tmp, figures):
    """The command line's run on the demo image: exit 0, a PLY of H * W
    vertices, a panel of RGB | depth."""
    try:
        stdout, _ = proc.communicate(timeout=600)
    finally:
        proc.kill()
        proc.wait()
    if proc.returncode != 0:
        raise RuntimeError(f"scripts_torch/infer.py --save-ply --save-panel exited {proc.returncode}:\n{stdout[-5000:]}")
    from unidepth_tpu_torch.utils.png import read_png

    h, w = read_png(DEMO_RGB).shape[:2]
    with open(tmp / "demo_out" / "rgb.ply", "rb") as f:
        header = f.read(400).split(b"end_header")[0].decode()
    if f"element vertex {h * w}\n" not in header:
        raise RuntimeError(f"the demo's PLY header lacks {h * w} vertices:\n{header}")
    panel = read_png(tmp / "demo_out" / "rgb_panel.png")
    if panel.shape != (h, 2 * w, 3):
        raise RuntimeError(f"the demo's panel has shape {panel.shape}")
    figures["command_line"] = {"ply_vertices": h * w, "panel": list(panel.shape)}
    log(f"scripts_torch/infer.py --save-ply --save-panel on the demo image: exit 0, PLY of {h * w} vertices, "
        f"panel {panel.shape}")
    shutil.rmtree(tmp)


EXPORT_LOADER = """
import json, sys, time
import torch
src = sys.argv[1]
inputs = torch.load(src + "/inputs.pt")
out = {}
for name, args in (("image", inputs[:1]), ("image_rays", inputs)):
    program = torch.export.load(src + "/" + name + ".pt2").module()
    args = [a.cuda() for a in args]
    with torch.no_grad():
        result = program(*args)
        for _ in range(2):
            program(*args)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            program(*args)
        end.record()
        end.synchronize()
    out[name] = [t.cpu() for t in result]
    out[name + "_ms"] = start.elapsed_time(end) / 5
assert not any(m.startswith("unidepth_tpu") for m in sys.modules), "the loader imported the port"
torch.save(out, src + "/outputs.pt")
print(json.dumps({k: v for k, v in out.items() if k.endswith("_ms")}))
"""


def rel_rms(out, ref):
    return ((out.float() - ref.float()).norm() / ref.float().norm()).item()


def serve_export_phase(kernels, none, smi, model, dev):
    """(b) ``export_forward`` of V2 ViT-L/14 (bf16, on the card) at
    EXPORT_SHAPE, without and with rays: no kernel launched while tracing,
    the flags back on after; the bytes loaded and run on the card by a
    process that imports torch only; its points against the same model's
    plain ``encode_decode`` (relative RMS <= EXPORT_REL_RMS) and its kernel
    path's (depth median relative error <= 1e-2); a call of the program
    loaded here launches nothing. Returns the figures."""
    from unidepth_tpu_torch.geometry.cameras import Pinhole
    from unidepth_tpu_torch.models.unidepthv2.export import export_forward

    h, w = EXPORT_SHAPE
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    image = torch.randn((1, h, w, 3), generator=gen, device=dev)
    K = torch.tensor([[[520.0, 0.0, w / 2], [0.0, 520.0, h / 2], [0.0, 0.0, 1.0]]], device=dev)
    rays = Pinhole.from_K(K).get_rays(h, w).reshape(1, h * w, 3)
    figures, blobs = {}, {}
    for name, with_camera in (("image", False), ("image_rays", True)):
        t0 = time.perf_counter()
        blobs[name], launches = run_path(f"export_forward {name}", kernels,
                                         lambda: export_forward(model, EXPORT_SHAPE, with_camera=with_camera))
        figures[f"{name}_export_s"] = time.perf_counter() - t0
        figures[f"{name}_mb"] = len(blobs[name]) / 2**20
        check_launches(f"export_forward {name}", launches, none)
        if not all(m.use_kernels for m in model.modules() if hasattr(m, "use_kernels")):
            raise RuntimeError("export_forward left a module on the plain versions")
        log(f"export_forward {name}: {figures[f'{name}_export_s']:.1f} s, {figures[f'{name}_mb']:.1f} MiB, "
            "no kernel launched, kernels back on")
    refs = {}
    with torch.no_grad():
        for name, args in (("image", (image,)), ("image_rays", (image, rays))):
            out, launches = run_path(f"encode_decode {name} (kernel path)", kernels,
                                     lambda: model.encode_decode(*args)["points"])
            check_launches(f"encode_decode {name}", launches,
                           {**none, "flash_attention_qkv": 24, "flash_attention_qkv/wgmma": 24, "ln_dense": 24,
                            "ln_dense/wgmma": 24, "flash_attention": 4, "flash_attention/wgmma": 4,
                            "conv3x3_lowchannel": 2, "conv3x3_lowchannel/wgmma": 2})
            model.set_kernels(False)
            plain = model.encode_decode(*args)["points"]
            model.set_kernels(True)
            refs[name] = out, plain
        figures["kernel_path_ms"] = time_ms(lambda: model.encode_decode(image), iters=3, reps=3)
    with tempfile.TemporaryDirectory() as tmp:
        for name, blob in blobs.items():
            (Path(tmp) / f"{name}.pt2").write_bytes(blob)
        torch.save([image.cpu(), rays.cpu()], Path(tmp) / "inputs.pt")
        run = subprocess.run([sys.executable, "-c", EXPORT_LOADER, tmp], cwd=tmp, capture_output=True, text=True,
                             timeout=600)
        if run.returncode != 0:
            raise RuntimeError(f"loading the exported program without the port failed:\n{run.stderr[-5000:]}")
        loaded = torch.load(Path(tmp) / "outputs.pt")
    for name, (kernel_pts, plain_pts) in refs.items():
        pts = loaded[name][0].to(dev)
        if pts.shape != plain_pts.shape or not torch.isfinite(pts).all():
            raise RuntimeError(f"the exported {name} program gave points {tuple(pts.shape)} or non-finite values")
        rms = rel_rms(pts, plain_pts)
        depth, ref_depth = pts[..., 2].float(), kernel_pts[..., 2].float()
        med = ((depth - ref_depth).abs() / ref_depth.abs()).median().item()
        log(f"exported {name} program (its own process, torch only): points vs plain encode_decode rel RMS "
            f"{rms:.3e} (gate {EXPORT_REL_RMS}); depth vs the kernel path median rel err {med:.3e} (gate 1e-2); "
            f"{loaded[name + '_ms']:.2f} ms a call, kernel path {figures['kernel_path_ms']:.2f} ms "
            f"(B = 1, {h}x{w}, {smi})")
        if not (rms <= EXPORT_REL_RMS and med <= 1e-2):
            raise RuntimeError(f"the exported {name} program is off: rel RMS {rms}, depth median {med}")
        figures[name] = {"rel_rms_plain": rms, "depth_median_kernel": med, "ms": loaded[name + "_ms"]}
    program = torch.export.load(io.BytesIO(blobs["image"])).module()
    with torch.no_grad():
        _, launches = run_path("the exported program, loaded here", kernels, lambda: program(image))
    check_launches("the exported program", launches, none)
    return figures


def serve_phase(kernels, none, smi, dev):
    """The rest of serving: (a) the infer CLI, (b) the exporter, (c) register
    tokens and the stacking modes at full width, (d) the SwiGLU encoder at
    DINOv2 ViT-g/14 widths. Returns the launches (the CLI's, a register-token
    ``infer()``'s and the SwiGLU encoder's) and the figures."""
    from unidepth_tpu_torch.models.backbones.dinov2 import DinoViT, ViTConfig
    from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2

    t_phase = time.perf_counter()
    config = json.loads(CONFIG.read_text())
    launches, figures = {}, {}
    launches["cli"], figures["cli"], model, (proc, tmp) = serve_cli_phase(kernels, none, smi, UniDepthV2, config)
    try:
        figures["export"] = serve_export_phase(kernels, none, smi, model, dev)
        del model
        torch.cuda.empty_cache()

        # (c) registers and softmax stacking on ViT-L/14, then the other stackings at ViT-S
        rgb = np.random.default_rng(SEED).integers(0, 256, (BATCH, SIDE, SIDE, 3), dtype=np.uint8)
        v2 = {"flash_attention_qkv": 24, "ln_dense": 24, "flash_attention": 4, **K5_HEADS}
        vits = {"flash_attention_qkv": 12, "ln_dense": 12, "flash_attention": 4, **K5_HEADS}
        cases = [("ViT-L/14 registers softmax", CONFIG, {"num_register_tokens": REGISTER_TOKENS,
                                                         "stacking_fn": "softmax"}, rgb, v2, 1e-2)]
        cases += [(f"ViT-S/14 {s}", CONFIG_S, {"stacking_fn": s}, rgb[:BATCH_B_CHECK], vits, STACKING_DEPTH_GATE)
                  for s in OTHER_STACKINGS]
        figures["stacking"] = {}
        for label, path, extra, images, expected, gate in cases:
            cfg = json.loads(path.read_text())
            cfg["model"]["pixel_encoder"].update(extra)
            m = UniDepthV2.from_config(cfg).init_params(seed=SEED).eval()
            tokens = []
            hook = m.pixel_encoder.blocks[0].register_forward_pre_hook(lambda mod, a: tokens.append(a[0].shape[1]))
            out, counts = run_path(f"{label} bf16 infer()", kernels, lambda: m.infer(images))
            hook.remove()
            check_launches(f"{label} bf16 infer()", counts,
                           {**none, **expected, **{f"{k}/wgmma": n for k, n in expected.items()}})
            check_outputs(f"{label} bf16 infer()", out, len(images))
            reg = extra.get("num_register_tokens", 0)
            if tokens != [1 + reg + (SIDE // 14) ** 2]:
                raise RuntimeError(f"{label}: the encoder ran at {tokens} tokens")
            ref = depth_against_plain(label, UniDepthV2, cfg, images, out["depth"], kernels, dev, gate=gate,
                                      outputs=("depth", "intrinsics"))
            rel = ((out["depth"] - ref["depth"]).abs() / ref["depth"].abs()).median().item()
            figures["stacking"][label] = {"tokens": tokens[0], "depth_median": rel}
            if reg:
                launches["registers"] = counts
            del m, out, ref

        # (d) the SwiGLU encoder at DINOv2 ViT-g/14 widths, random weights drawn on the card
        t0 = time.perf_counter()
        with torch.device(dev):
            enc = DinoViT(ViTConfig(**VITG_REG)).eval()
        g = torch.Generator(device=dev).manual_seed(SEED)
        with torch.no_grad():
            for name, p in enc.named_parameters():
                if name.endswith("bias"):
                    p.zero_()
                elif p.ndim >= 2 and name.startswith("blocks."):  # linears: lecun normal
                    p.normal_(0.0, p.shape[1] ** -0.5, generator=g)
                elif p.ndim >= 2:  # patch embedding, cls, pos-embed, registers
                    p.normal_(0.0, 0.02, generator=g)
        enc16 = copy.deepcopy(enc).to(torch.bfloat16)
        n_params = sum(p.numel() for p in enc.parameters())
        image = torch.randn((BATCH, SIDE, SIDE, 3), generator=g, device=dev)
        with torch.no_grad():
            gated = kernels["ln_dense"].gated_launches
            (feats, cls), counts = run_path("ViT-g/14 SwiGLU bf16 encoder", kernels,
                                            lambda: enc16(image.to(torch.bfloat16)))
            gated = kernels["ln_dense"].gated_launches - gated
            # every block: K1 on the raw qkv, K2's gated body for LN2 -> w12 -> silu(a) * g
            expected = {"flash_attention_qkv": VITG_REG["depth"], "flash_attention_qkv/wgmma": VITG_REG["depth"]}
            check_launches("ViT-g/14 SwiGLU bf16 encoder", counts, {**none, **expected})
            if gated != VITG_REG["depth"]:
                raise RuntimeError(f"ViT-g/14 SwiGLU bf16 encoder: {gated} gated K2 launches != {VITG_REG['depth']}")
            launches["swiglu"] = {**counts, "ln_dense/gated": gated}
            for blk in [*enc.blocks, *enc16.blocks]:
                blk.use_kernels = False
            feats32, cls32 = enc(image)
            feats_pb, cls_pb = enc16(image.to(torch.bfloat16))  # plain bf16: the rounding alone
        drift = max(rel_rms(a, b) for a, b in zip([*feats, *cls], [*feats32, *cls32]))
        plain_drift = max(rel_rms(a, b) for a, b in zip([*feats_pb, *cls_pb], [*feats32, *cls32]))
        finite = all(torch.isfinite(t).all() for t in [*feats, *cls])
        side = SIDE // 14
        if not finite or [tuple(f.shape) for f in feats] != [(BATCH, side, side, VITG_REG["embed_dim"])] * 4:
            raise RuntimeError(f"ViT-g/14 SwiGLU features {[tuple(f.shape) for f in feats]} or not finite")
        log(f"ViT-g/14 SwiGLU ({n_params / 1e9:.3f} B params, {1 + VITG_REG['num_register_tokens'] + side * side} "
            f"tokens, B = {BATCH}): bf16 kernel path vs fp32 plain, feature and cls rel RMS {drift:.3e} (gate "
            f"{VITG_FEATURE_GATE}); plain bf16 vs fp32 {plain_drift:.3e}; {time.perf_counter() - t0:.1f} s")
        if not drift <= VITG_FEATURE_GATE:
            raise RuntimeError(f"ViT-g/14 SwiGLU features drift {drift} > {VITG_FEATURE_GATE}")
        figures["swiglu"] = {"params": n_params, "rel_rms": drift, "plain_bf16_rel_rms": plain_drift,
                             "gate": VITG_FEATURE_GATE}
        del enc, enc16, feats, cls, feats32, cls32, feats_pb, cls_pb
        torch.cuda.empty_cache()
        serve_cli_check(proc, tmp, figures["cli"])
    finally:
        proc.kill()
        proc.wait()
    figures["seconds"] = time.perf_counter() - t_phase
    log(f"serve phase: {figures['seconds']:.1f} s")
    return launches, figures


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this test has no CPU path")
    if not CONFIG.is_file():
        raise SystemExit(f"chip_smoke: {CONFIG} not found; run from the root of a checkout")
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    from unidepth_tpu_torch.models.unidepthv1.model import UniDepthV1
    from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2
    from unidepth_tpu_torch.ops import _cuda
    from unidepth_tpu_torch.models.unidepthv2.decoder import DepthHead
    from unidepth_tpu_torch.ops.conv_kernels import (
        PAD_MODES,
        conv3x3_head,
        conv3x3_head_plain,
        conv3x3_lowchannel,
        conv3x3_lowchannel_plain,
    )
    from unidepth_tpu_torch.ops.flash_attention import _launch as attention_launch
    from unidepth_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_packed,
        flash_attention_packed_plain,
        flash_attention_plain,
        flash_attention_qkv,
        flash_attention_qkv_plain,
    )
    from unidepth_tpu_torch.ops.fused_block import ln_dense, ln_dense_plain
    from unidepth_tpu_torch.ops.head_mlp import head_mlp, head_mlp_plain
    from unidepth_tpu_torch.ops.kernel_ab import family, run_bd, run_variant, run_variant_plain
    from unidepth_tpu_torch.ops.flash_attention import HOPPER_KERNEL

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # --- build -------------------------------------------------------------
    t0 = time.perf_counter()
    _cuda.library()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {_cuda.build_seconds} s)")
    reports = (_cuda.ptxas_reports("attn_fwd_wgmma") + _cuda.ptxas_reports("ln_dense_wgmma")
               + _cuda.ptxas_reports("ln_row_stats") + _cuda.ptxas_reports("ln_swiglu_wgmma")
               + _cuda.ptxas_reports("conv3x3_wgmma") + _cuda.ptxas_reports("head_mlp_wgmma"))
    if not any(HOPPER_KERNEL in r[0] for r in reports):
        raise RuntimeError(f"ptxas report for the main path's {HOPPER_KERNEL}: none in the build log")
    for report in reports:  # template arguments (<F, NH, Stages, D>, <Cout, Cin / 16>) stay in the mangled name
        text = "\n".join(report)
        name = re.search(r"\d((?:attn_fwd_wgmma|conv3x3_wgmma|head_mlp_wgmma)I(?:Li\d+E)+E|ln_dense_wgmma|ln_swiglu_wgmma"
                         r"|ln_row_stats)", report[0]).group(1)
        used = re.search(r"Used \d+ registers", text)
        spills = re.search(r"\d+ bytes spill stores, \d+ bytes spill loads", text)
        main = " (the main path's: K1, K3, K4)" if HOPPER_KERNEL in report[0] else ""
        log(f"ptxas {name}{main}: {used and used.group(0)}, {spills and spills.group(0)}")

    # every kernel's wrapper, by the name its record carries
    kernels = {
        "flash_attention_qkv": flash_attention_qkv,
        "ln_dense": ln_dense,
        "flash_attention": flash_attention,
        "flash_attention_packed": flash_attention_packed,
        "conv3x3_lowchannel": conv3x3_lowchannel,
        "run_variant": run_variant,
        "run_bd": run_bd,
    }
    none = dict.fromkeys([*kernels, *(f"{k}/wgmma" for k in HOPPER)], 0)

    # --- kernels at the main path's shapes -----------------------------------
    gen = torch.Generator(device=dev)

    def randn(*shape, dtype, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * std + mean).to(dtype)

    def k1_inputs(dtype):
        gen.manual_seed(1)
        return randn(BATCH, 1370, 3 * 1024, dtype=dtype), 16, 64**-0.5

    def k2_inputs(dtype):
        gen.manual_seed(2)
        c, f = 1024, 4096
        return (
            randn(BATCH * 1370, c, dtype=dtype, std=2.0, mean=0.5),
            randn(f, c, dtype=dtype, std=c**-0.5),
            randn(f, dtype=dtype, std=0.1),
            randn(c, dtype=dtype, std=0.1, mean=1.0),
            randn(c, dtype=dtype, std=0.1),
            1e-6,
            "gelu",
        )

    def k3_inputs(dtype):
        gen.manual_seed(3)
        return tuple(randn(BATCH * 8, 1369, 64, dtype=dtype) for _ in range(3)) + (64**-0.5,)

    def k4_inputs(dtype):
        # the int8 block's call: the three channel slices of its qkv output,
        # read in place (row stride 3C, batch stride N * 3C)
        gen.manual_seed(4)
        return (*randn(BATCH, 1370, 3 * 1024, dtype=dtype).split(1024, dim=-1), 16, 64**-0.5)

    def k5_inputs(dtype, shape=(BATCH, SIDE, SIDE, 64, 32), mode="reflect"):
        # the V2 heads' hr conv (to_depth_hr1 / to_conf_hr1): NHWC, 64 -> 32
        gen.manual_seed(5)
        b, h, w, cin, cout = shape
        return (randn(b, h, w, cin, dtype=dtype), randn(3, 3, cin, cout, dtype=dtype, std=(9 * cin) ** -0.5),
                randn(cout, dtype=dtype, std=0.1), mode)

    def attention_flops(q, k, num_heads):
        b, nq, c = q.shape
        return 4 * b * nq * k.shape[1] * c

    def sdpa_qkv(qkv, num_heads, scale):
        return sdpa(*(heads_view(t, num_heads) for t in qkv.chunk(3, dim=-1)), scale)

    def sdpa_packed(q, k, v, num_heads, scale):
        return sdpa(*(heads_view(t, num_heads) for t in (q, k, v)), scale)

    def ln_dense_library(x, w, bias, gamma, beta, eps, activation):
        # three calls composed in bf16: the yardstick no single call gives
        return lambda: F.gelu(F.linear(F.layer_norm(x, x.shape[-1:], gamma, beta, eps), w, bias))

    def conv_library(x, w, bias, mode):
        # cuDNN on the padded input in channels-last bf16: the same output
        pad = "constant" if mode == "zeros" else mode
        xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode=pad).contiguous(memory_format=torch.channels_last)
        wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        return lambda: F.conv2d(xp, wl, bias)

    m = {}
    m["flash_attention_qkv"] = kernel_phase(
        "K1 flash_attention_qkv", flash_attention_qkv, flash_attention_qkv_plain, k1_inputs, 1e-4,
        4 * BATCH * 1370 * 1370 * 1024, sdpa_qkv)
    m["ln_dense"] = kernel_phase("K2 ln_dense", ln_dense, ln_dense_plain, k2_inputs, 2e-4,
                                 2 * BATCH * 1370 * 1024 * 4096, ln_dense_library)
    m["ln_dense"]["gated"] = gated_phase(ln_dense, ln_dense_plain, randn, gen, smi)
    m["flash_attention"] = kernel_phase(
        "K3 flash_attention", flash_attention, flash_attention_plain, k3_inputs, 1e-4,
        4 * BATCH * 8 * 1369 * 1369 * 64, lambda q, k, v, scale: sdpa(q[None], k[None], v[None], scale))
    m["flash_attention_packed"] = kernel_phase(
        "K4 flash_attention_packed", flash_attention_packed, flash_attention_packed_plain, k4_inputs, 1e-4,
        4 * BATCH * 1370 * 1370 * 1024, sdpa_packed)

    # head dim 8: the K3 and K4 instantiation that zero-fills the mma k step
    for dtype in (torch.bfloat16, torch.float32):
        gen.manual_seed(8)
        q, k, v = randn(BATCH, 1370, 3 * 128, dtype=dtype).split(128, dim=-1)
        qh, kh, vh = (randn(16, 300, 8, dtype=dtype) for _ in range(3))
        for name, out, ref in (
            ("K4 d=8", flash_attention_packed(q, k, v, 16), flash_attention_packed_plain(q.float(), k.float(), v.float(), 16, 8**-0.5)),
            ("K3 d=8", flash_attention(qh, kh, vh, 8**-0.5), flash_attention_plain(qh.float(), kh.float(), vh.float(), 8**-0.5)),
        ):
            if dtype == torch.bfloat16:
                err, rel = check_bf16(name, out, ref)
                log(f"{name} bf16: max_abs_err {err:.3e} rel_rms {rel:.3e}")
            else:
                log(f"{name} fp32: max_abs_err {check_close(name + ' fp32', out, ref, rtol=1e-4, atol=1e-4):.3e}")

    # K3 at the ViT-B (48) and ViT-S (32) decoders' head dims: the Hopper
    # body, held at the bf16 gates beside the mma.sync body of attention.cu
    # (its C entry called directly, so no wrapper counts it), then both and
    # SDPA timed in two turns (a, b, c, c, b, a), since K3 at these shapes
    # moved up to 27% between calls before
    k3_calls, k3_narrow = {}, {}
    for key, (bh, n, d) in K3_NARROW_SHAPES.items():
        gen.manual_seed(bh + d)
        q_, k_, v_ = (randn(bh, n, d, dtype=torch.bfloat16) for _ in range(3))
        out_ = torch.empty_like(q_)
        ref = flash_attention_plain(q_.float(), k_.float(), v_.float(), d**-0.5)
        hopper3 = flash_attention.hopper_launches
        err, rel = check_bf16(f"K3 {key}", flash_attention(q_, k_, v_, d**-0.5), ref)
        if flash_attention.hopper_launches != hopper3 + 1:
            raise RuntimeError(f"K3 {(bh, n, d)}: the bf16 call did not run the Hopper body")

        def old_body(q_=q_, k_=k_, v_=v_, out_=out_, bh=bh, n=n, d=d):
            attention_launch("K3 mma.sync body", q_, k_.data_ptr(), v_.data_ptr(), out_, bh, 1, n, n, d,
                             (n * d, d) * 4, d**-0.5)
            return out_

        err_old, rel_old = check_bf16(f"K3 {key} mma.sync body", old_body(), ref)
        k3_narrow.update({f"{key}_shape": [bh, n, d], f"{key}_max_abs_err": err, f"{key}_rel_rms": rel})
        log(f"K3 {key} {(bh, n, d)}: Hopper body max_abs_err {err:.3e} rel_rms {rel:.3e}; mma.sync body "
            f"max_abs_err {err_old:.3e} rel_rms {rel_old:.3e}")
        k3_calls[f"{key}_ms"] = lambda q_=q_, k_=k_, v_=v_, d=d: flash_attention(q_, k_, v_, d**-0.5)
        k3_calls[f"{key}_mma_sync_ms"] = old_body
        k3_calls[f"{key}_library_ms"] = sdpa(q_[None], k_[None], v_[None], d**-0.5)
        del ref
    k3_turns = {name: [] for name in k3_calls}
    for order in (list(k3_calls), list(reversed(k3_calls))):
        for name in order:
            k3_turns[name].append(time_ms(k3_calls[name]))
    k3_narrow.update({name: statistics.median(ts) for name, ts in k3_turns.items()})
    for key, (bh, n, d) in K3_NARROW_SHAPES.items():
        ms, old, lib = (k3_narrow[f"{key}_{x}"] for x in ("ms", "mma_sync_ms", "library_ms"))
        turns = ", ".join(f"{t:.4f}" for x in ("ms", "mma_sync_ms", "library_ms") for t in k3_turns[f"{key}_{x}"])
        log(f"K3 {key} {(bh, n, d)}: Hopper body {ms:.4f} ms, mma.sync body {old:.4f} ms, SDPA {lib:.4f} ms "
            f"({ms / lib:.3f}x SDPA, {ms / old:.3f}x the old body; turns {turns}) ({smi})")
    del k3_calls

    # --- K2, K1 and K3 at the V1 paths' shapes (462 x 616, B = 8) -------------
    m["ln_dense"]["v1_shapes"] = {}
    for key, (rows, c, f, eps) in V1_K2_SHAPES.items():
        def k2_v1(rows=rows, c=c, f=f, eps=eps):
            gen.manual_seed(rows + c)
            return (randn(rows, c, dtype=torch.bfloat16, std=2.0, mean=0.5),
                    randn(f, c, dtype=torch.bfloat16, std=c**-0.5), randn(f, dtype=torch.bfloat16, std=0.1),
                    randn(c, dtype=torch.bfloat16, std=0.1, mean=1.0), randn(c, dtype=torch.bfloat16, std=0.1), eps, "gelu")
        m["ln_dense"]["v1_shapes"][key] = {"shape": [rows, c, f], "eps": eps, **shape_phase(
            f"K2 {key} (M {rows}, C {c}, F {f}, eps {eps})", ln_dense, ln_dense_plain, k2_v1, 2 * rows * c * f, ln_dense_library, smi)}

    def k1_v1():
        gen.manual_seed(11)
        return randn(BATCH, V1_K1_TOKENS, 3 * 1024, dtype=torch.bfloat16), 16, 64**-0.5

    m["flash_attention_qkv"]["v1_vitl14"] = {"shape": [BATCH, V1_K1_TOKENS, 16, 64], **shape_phase(
        f"K1 V1 ViT-L/14 (8, {V1_K1_TOKENS}, 16 x 64)", flash_attention_qkv, flash_attention_qkv_plain, k1_v1,
        4 * BATCH * V1_K1_TOKENS**2 * 1024, sdpa_qkv, smi)}
    for key, (bh, n, d) in V1_K3_SHAPES.items():
        def k3_v1(bh=bh, n=n, d=d):
            gen.manual_seed(bh + n)
            return tuple(randn(bh, n, d, dtype=torch.bfloat16) for _ in range(3)) + (d**-0.5,)
        m["flash_attention"][key] = {"shape": [bh, n, d], **shape_phase(
            f"K3 {key} {(bh, n, d)}", flash_attention, flash_attention_plain, k3_v1, 4 * bh * n * n * d,
            lambda q, k, v, scale: sdpa(q[None], k[None], v[None], scale), smi)}

    # --- K1, K4 and K2 at the V2old path's shapes (588 x 784, B = 8) ----------
    def k1_v2old():
        gen.manual_seed(31)
        return randn(BATCH, V2OLD_TOKENS, 3 * 1024, dtype=torch.bfloat16), 16, 64**-0.5

    def k4_v2old():
        gen.manual_seed(32)
        return (*randn(BATCH, V2OLD_TOKENS, 3 * 1024, dtype=torch.bfloat16).split(1024, dim=-1), 16, 64**-0.5)

    attn_flops = 4 * BATCH * V2OLD_TOKENS**2 * 1024
    m["flash_attention_qkv"]["v2old"] = {"shape": [BATCH, V2OLD_TOKENS, 16, 64], **shape_phase(
        f"K1 V2old ViT-L/14 (8, {V2OLD_TOKENS}, 16 x 64)", flash_attention_qkv, flash_attention_qkv_plain, k1_v2old,
        attn_flops, sdpa_qkv, smi)}
    m["flash_attention_packed"]["v2old"] = {"shape": [BATCH, V2OLD_TOKENS, 16, 64], **shape_phase(
        f"K4 V2old ViT-L/14 int8 (8, {V2OLD_TOKENS}, 16 x 64) views", flash_attention_packed,
        flash_attention_packed_plain, k4_v2old, attn_flops, sdpa_packed, smi)}
    m["ln_dense"]["v2old_shapes"] = {}
    for key, (rows, c, f, eps) in V2OLD_K2_SHAPES.items():
        def k2_v2old(rows=rows, c=c, f=f, eps=eps):
            gen.manual_seed(rows + c + 1)
            return (randn(rows, c, dtype=torch.bfloat16, std=2.0, mean=0.5),
                    randn(f, c, dtype=torch.bfloat16, std=c**-0.5), randn(f, dtype=torch.bfloat16, std=0.1),
                    randn(c, dtype=torch.bfloat16, std=0.1, mean=1.0), randn(c, dtype=torch.bfloat16, std=0.1), eps, "gelu")
        m["ln_dense"]["v2old_shapes"][key] = {"shape": [rows, c, f], "eps": eps, **shape_phase(
            f"K2 {key} (M {rows}, C {c}, F {f}, eps {eps})", ln_dense, ln_dense_plain, k2_v2old, 2 * rows * c * f,
            ln_dense_library, smi)}

    # --- K5: conv3x3_lowchannel, its entry point the op itself ---------------
    def floats(args):
        return [a.float() if torch.is_tensor(a) else a for a in args]

    def conv_flops(shape):
        b, h, w, cin, cout = shape
        return 2 * b * h * w * 9 * cin * cout

    m["conv3x3_lowchannel"] = kernel_phase(
        "K5 conv3x3_lowchannel (8, 518, 518, 64->32) reflect", conv3x3_lowchannel, conv3x3_lowchannel_plain,
        k5_inputs, 1e-4, conv_flops(K5_HR_SHAPES[64]), conv_library)
    for cin, shape in K5_HR_SHAPES.items():  # the hr convs of ViT-L (timed above), ViT-B and ViT-S
        if cin == 64:
            continue
        args = k5_inputs(torch.bfloat16, shape)
        hopper5 = conv3x3_lowchannel.hopper_launches
        out = conv3x3_lowchannel(*args)
        torch.cuda.synchronize()
        if conv3x3_lowchannel.hopper_launches != hopper5 + 1:
            raise RuntimeError(f"K5 {shape}: the bf16 call did not run the Hopper body")
        err, rel = check_bf16(f"K5 {shape}", out, conv3x3_lowchannel_plain(*floats(args)))
        ms, lib = time_ms(lambda: conv3x3_lowchannel(*args)), time_ms(conv_library(*args))
        bd = bound(conv_flops(shape), nbytes(args[0], out))
        m["conv3x3_lowchannel"][f"cin{cin}"] = {"ms": ms, "library_ms": lib, "max_abs_err": err, **bd}
        log(f"K5 {shape} reflect: bf16 max_abs_err {err:.3e} rel_rms {rel:.3e}; kernel {ms:.4f} ms, cuDNN {lib:.4f} "
            f"ms, {bd['bound_ms'] / ms:.1%} of its {bd['bound_ms']:.4f} ms bound ({smi})")
        del args, out
    for shape, mode in (((2, 37, 45, 64, 32), "zeros"), ((2, 37, 45, 64, 32), "replicate"),
                        ((2, 21, 37, 16, 8), "reflect"), ((1, 10, 40, 32, 16), "zeros"), ((1, 9, 13, 8, 4), "replicate"),
                        ((2, 5, 130, 48, 32), "reflect"), ((3, 1, 70, 32, 32), "zeros")):
        for dtype in (torch.bfloat16, torch.float32):
            args = k5_inputs(dtype, shape, mode)
            hopper5 = conv3x3_lowchannel.hopper_launches
            out = conv3x3_lowchannel(*args)
            torch.cuda.synchronize()
            hopper = dtype == torch.bfloat16 and shape[3] % 8 == 0 and shape[4] % 8 == 0
            if conv3x3_lowchannel.hopper_launches != hopper5 + hopper:
                raise RuntimeError(f"K5 {shape} {mode} {dtype}: the Hopper body ran {not hopper}, expected {hopper}")
            ref = conv3x3_lowchannel_plain(*floats(args))
            name = f"K5 {shape} {mode}"
            if dtype == torch.bfloat16:
                err, rel = check_bf16(name, out, ref)
                log(f"{name} bf16 ({'Hopper' if hopper else 'mma.sync'} body): max_abs_err {err:.3e} rel_rms {rel:.3e}")
            else:
                log(f"{name} fp32: max_abs_err {check_close(name + ' fp32', out, ref, rtol=1e-4, atol=1e-4):.3e}")
    # the mma.sync body that ran the hr conv before, its C entry called
    # directly (no wrapper counts it), then both bodies in turns
    k5_args = k5_inputs(torch.bfloat16)
    x5, w5, b5, mode5 = k5_args
    out5 = torch.empty(*x5.shape[:3], w5.shape[-1], dtype=x5.dtype, device=dev)

    def conv_mma_sync():
        _cuda.check(_cuda.library().ud_conv3x3_fwd(
            x5.data_ptr(), w5.data_ptr(), b5.data_ptr(), out5.data_ptr(), *x5.shape, w5.shape[-1], PAD_MODES[mode5],
            _cuda.DTYPE_CODES[x5.dtype], _cuda.stream_handle(x5)), "ud_conv3x3_fwd")
        return out5

    err, rel = check_bf16("K5 mma.sync body", conv_mma_sync(), conv3x3_lowchannel_plain(*floats(k5_args)))
    k5_turns = {"hopper": [], "mma.sync": []}
    for name in ("hopper", "mma.sync", "mma.sync", "hopper"):
        k5_turns[name].append(time_ms(conv_mma_sync if name == "mma.sync" else lambda: conv3x3_lowchannel(*k5_args)))
    m["conv3x3_lowchannel"]["mma_sync_ms"] = statistics.median(k5_turns["mma.sync"])
    m["conv3x3_lowchannel"]["hopper_turns_ms"] = statistics.median(k5_turns["hopper"])
    log(f"K5 (8, 518, 518, 64->32) in turns: Hopper body {k5_turns['hopper']} ms, mma.sync body "
        f"{k5_turns['mma.sync']} ms (its bf16 max_abs_err {err:.3e} rel_rms {rel:.3e}) ({smi})")
    _, k5_launches = run_path("K5 conv3x3_lowchannel call", kernels, lambda: conv3x3_lowchannel(*k5_args))
    check_launches("K5 conv3x3_lowchannel call", k5_launches,
                   {**none, "conv3x3_lowchannel": 1, "conv3x3_lowchannel/wgmma": 1})
    # the fused head (conv3x3_head: a V2 head's hr tail, 64 -> 32 -> 1) at the
    # hr shape, beside the path the model ran before it: the modules on NCHW,
    # F.pad reflect, cuDNN's conv, LeakyReLU and the 1x1 conv
    gen.manual_seed(6)
    head_args = (x5, w5, b5, randn(32, dtype=torch.bfloat16, std=32**-0.5), randn(1, dtype=torch.bfloat16, std=0.1),
                 "reflect", 0.01)
    hopper5 = conv3x3_lowchannel.hopper_launches
    out = conv3x3_head(*head_args)
    torch.cuda.synchronize()
    if conv3x3_lowchannel.hopper_launches != hopper5 + 1:
        raise RuntimeError("K5 head: the bf16 call did not run the Hopper body")
    def check_head(name, out, ref):
        # the bf16 gates with the atol scaled by max(1, max |ref|), as K6's: one of the 32 bf16
        # conv outputs a pixel sums, rounded to the neighbouring value, moves it by |w1| x its ulp
        err = check_close(f"{name} bf16", out, ref, rtol=TOL_BF16["rtol"],
                          atol=TOL_BF16["atol"] * max(1.0, ref.abs().max().item()))
        rel = ((out.float() - ref).norm() / ref.norm()).item()
        if not rel <= REL_RMS_BF16:
            raise RuntimeError(f"{name} bf16: relative RMS error {rel:.3e} > {REL_RMS_BF16}")
        return err, rel

    err, rel = check_head("K5 head", out, conv3x3_head_plain(*head_args).float())  # rounding where K5 rounds
    hr = DepthHead._hr_head(64).to(dev, torch.bfloat16)
    with torch.no_grad():
        hr[0].weight.copy_(w5.permute(3, 2, 0, 1))
        hr[0].bias.copy_(b5)
        hr[2].weight.copy_(head_args[3].reshape(1, 32, 1, 1))
        hr[2].bias.copy_(head_args[4])
    x_nchw = x5.permute(0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        err_modules, _ = check_head("K5 head against the modules", out.permute(0, 3, 1, 2), hr(x_nchw).float())
        ms, lib = time_ms(lambda: conv3x3_head(*head_args)), time_ms(lambda: hr(x_nchw))
    b, h, w, cin, cout = K5_HR_SHAPES[64]
    bd = bound(conv_flops(K5_HR_SHAPES[64]) + 2 * b * h * w * cout, nbytes(x5, out))
    m["conv3x3_lowchannel"]["head"] = {"ms": ms, "library_ms": lib, "max_abs_err": err, "rel_rms": rel,
                                       "max_abs_err_modules": err_modules, **bd}
    log(f"K5 head (8, 518, 518, 64->32->1) reflect: bf16 max_abs_err {err:.3e} rel_rms {rel:.3e} (against the bf16 "
        f"modules {err_modules:.3e}); kernel {ms:.4f} ms, {bd['bound_ms'] / ms:.1%} of its {bd['bound_ms']:.4f} ms "
        f"bound ({bd['bound_by']}); the modules (F.pad, cuDNN, LeakyReLU, 1x1) {lib:.4f} ms ({smi})")
    del k5_args, x5, w5, b5, out5, head_args, out, hr, x_nchw

    # --- K2h: the V2 heads' LayerNorm -> Linear pair, its entry the decoder --
    k2h = head_mlp_phase(head_mlp, head_mlp_plain, ln_dense_plain, randn, gen, smi)

    # --- K6 and K7: the A/B harness (scripts_torch/kernel_ab.py) -------------
    harness = load_harness()
    calls = 2 + 3 * AB_ITERS  # each variant: the checked call, the warm-up, 3 timed runs
    rows6, k6_launches = run_path(
        "K6 kernel_ab harness", kernels,
        lambda: harness.run(AB_FAMILY_NAMES, iters=AB_ITERS, check=True, log=log, **AB_SHAPE))
    n6 = calls * (len(AB_FAMILY_NAMES) - 1)
    check_launches("K6 kernel_ab harness", k6_launches,
                   {**none, "run_variant": n6, "run_variant/wgmma": n6, "flash_attention_packed": calls,
                    "flash_attention_packed/wgmma": calls})
    rows7, k7_launches = run_path(
        "K7 kernel_ab harness", kernels,
        lambda: harness.run(BD_NAMES, iters=AB_ITERS, check=True, log=log, **AB_SHAPE))
    n7 = calls * len(BD_NAMES)
    check_launches("K7 kernel_ab harness", k7_launches, {**none, "run_bd": n7, "run_bd/wgmma": n7})
    q, k, v = harness.make_inputs(**AB_SHAPE)
    nh, scale = AB_SHAPE["heads"], AB_SHAPE["d"] ** -0.5

    # the mma.sync body that ran these families at head dim 64 before the
    # Hopper body: its C entries called directly, so no wrapper counts them
    old_rows = harness.run(("tr_max", "nomax_guard", "bd"), iters=AB_ITERS, check=True, log=log, bodies=("mma.sync",),
                           **AB_SHAPE)
    old_body = {"run_variant": {family(r["variant"]): r["ms"] for r in old_rows[:2]}, "run_bd": {"bd": old_rows[2]["ms"]}}
    ab_library_ms = time_ms(sdpa_packed(q, k, v, nh, scale))
    ab_bound = bound(attention_flops(q, k, nh), nbytes(q, k, v, q))
    for key, rows, first, plain_name in (("run_variant", rows6, "tr_max", "tr_max"), ("run_bd", rows7, "bd", "bd")):
        row = next(r for r in rows if r["variant"] == first)
        plain_ms = time_ms(lambda: run_variant_plain(plain_name, q, k, v, nh, scale), iters=3, reps=3)
        m[key] = {"max_abs_err": row["plain_max_abs_err"], "ms": row["ms"], "plain_ms": plain_ms,
                  "library_ms": ab_library_ms, **ab_bound,
                  "variants_ms": {r["variant"]: r["ms"] for r in rows}, "mma_sync_ms": old_body[key]}
        log(f"{key}: {first} {row['ms']:.4f} ms on the Hopper body (mma.sync body: {old_body[key]}), "
            f"plain {plain_ms:.4f} ms, library (SDPA) {ab_library_ms:.4f} ms")
    del q, k, v

    # --- the main path: ViT-L/14 infer() at B=8, 518x518 ----------------------
    warnings.simplefilter("ignore")  # resolution_level unset: default budget
    config = json.loads(CONFIG.read_text())
    t0 = time.perf_counter()
    model = UniDepthV2.from_config(config).init_params(seed=SEED).eval()  # no device named: the card
    placed = {(p.device.type, p.dtype) for p in model.parameters()}
    if placed != {("cuda", torch.bfloat16)}:
        raise RuntimeError(f"from_config with no device placed the model on {placed}, not the card in bf16")
    log(f"model: ViT-L/14 {sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params, "
        f"{next(model.parameters()).dtype} on {next(model.parameters()).device}, built in {time.perf_counter() - t0:.1f} s")
    rgb = np.random.default_rng(SEED).integers(0, 256, (BATCH, SIDE, SIDE, 3), dtype=np.uint8)

    head_mlp.launches = 0
    out, launches = run_path("bf16 infer()", kernels, lambda: model.infer(rgb))
    check_launches("bf16 infer()", launches, {**none, "flash_attention_qkv": 24, "flash_attention_qkv/wgmma": 24,
                                              "ln_dense": 24, "ln_dense/wgmma": 24,
                                              "flash_attention": 4, "flash_attention/wgmma": 4,
                                              "conv3x3_lowchannel": 2, "conv3x3_lowchannel/wgmma": 2})
    if head_mlp.launches != 1:
        raise RuntimeError(f"bf16 infer(): K2h launched {head_mlp.launches} times, expected 1 (both heads)")
    k2h["launches"] = head_mlp.launches
    check_outputs("bf16 infer()", out)

    ref = depth_against_plain("ViT-L/14", UniDepthV2, config, rgb, out["depth"], kernels, dev,
                              outputs=("depth", "intrinsics"))
    del out
    images_per_s("bf16", lambda: model.infer(rgb, outputs=("depth",)), smi)

    # --- the int8 serving path: same weights, encoder GEMMs in int8 -----------
    model.set_serving_precision("int8")
    t0 = time.perf_counter()
    model._serving_encoder()
    torch.cuda.synchronize()
    log(f"int8 encoder quantized from the fp32 masters in {time.perf_counter() - t0:.2f} s")
    out_q, launches_q = run_path("int8 infer()", kernels, lambda: model.infer(rgb))
    check_launches("int8 infer()", launches_q, {**none, "flash_attention": 4, "flash_attention/wgmma": 4,
                                                "flash_attention_packed": 24, "flash_attention_packed/wgmma": 24,
                                                "conv3x3_lowchannel": 2, "conv3x3_lowchannel/wgmma": 2})
    check_outputs("int8 infer()", out_q)
    # the JAX package's int8 bounds against full precision (tests/test_quant.py)
    rel = ((out_q["depth"] - ref["depth"]).abs() / (ref["depth"].abs() + 1e-6)).flatten()
    mean, p99 = rel.mean().item(), torch.quantile(rel, 0.99).item()
    k_rel = ((out_q["intrinsics"] - ref["intrinsics"]).abs() / (ref["intrinsics"].abs() + 1e-6)).max().item()
    log(f"int8 depth vs fp32 plain path: mean rel err {mean:.3e}, p99 {p99:.3e}, max {rel.max().item():.3e}; "
        f"intrinsics max rel err {k_rel:.3e}")
    if not (mean < 0.05 and p99 < 0.15 and k_rel < 0.1):
        raise RuntimeError(f"int8 drift out of bounds: mean {mean}, p99 {p99}, intrinsics {k_rel}")
    del out_q

    model._int8_stages = STAGE_MASK
    out_m, launches_m = run_path(f"int8 infer() under stage mask {STAGE_MASK}", kernels, lambda: model.infer(rgb))
    check_launches("masked int8 infer()", launches_m,
                   {**none, "flash_attention_qkv": 12, "flash_attention_qkv/wgmma": 12, "ln_dense": 12,
                    "ln_dense/wgmma": 12, "flash_attention": 4, "flash_attention/wgmma": 4,
                    "flash_attention_packed": 12, "flash_attention_packed/wgmma": 12,
                    "conv3x3_lowchannel": 2, "conv3x3_lowchannel/wgmma": 2})
    check_outputs("masked int8 infer()", out_m)
    del out_m
    model._int8_stages = None
    images_per_s("int8", lambda: model.infer(rgb, outputs=("depth",)), smi)
    del model, ref

    # --- ViT-B/14 and ViT-S/14: the decoders' cross-attentions at head dims 48 and 32
    for label, path in (("ViT-B/14", CONFIG_B), ("ViT-S/14", CONFIG_S)):
        config_b = json.loads(path.read_text())
        t0 = time.perf_counter()
        model_b = UniDepthV2.from_config(config_b).init_params(seed=SEED).eval()  # no device named: the card
        log(f"model: {label} {sum(p.numel() for p in model_b.parameters()) / 1e6:.1f} M params, "
            f"{next(model_b.parameters()).dtype} on {next(model_b.parameters()).device}, "
            f"built in {time.perf_counter() - t0:.1f} s")
        rgb_b = rgb[:BATCH_B_CHECK]
        out_b, launches_b = run_path(f"{label} bf16 infer()", kernels, lambda: model_b.infer(rgb_b))
        check_launches(f"{label} bf16 infer()", launches_b,
                       {**none, "flash_attention_qkv": 12, "flash_attention_qkv/wgmma": 12, "ln_dense": 12,
                        "ln_dense/wgmma": 12, "flash_attention": 4, "flash_attention/wgmma": 4,
                        "conv3x3_lowchannel": 2, "conv3x3_lowchannel/wgmma": 2})
        check_outputs(f"{label} bf16 infer()", out_b, BATCH_B_CHECK)
        depth_against_plain(label, UniDepthV2, config_b, rgb_b, out_b["depth"], kernels, dev,
                            outputs=("depth", "intrinsics"))
        del out_b
        images_per_s(f"bf16 {label}", lambda: model_b.infer(rgb, outputs=("depth",)), smi)
        del model_b

    # --- UniDepthV1: ViT-L/14 and ConvNeXt-L at 462 x 616 ---------------------
    rgb_v1 = np.random.default_rng(SEED).integers(0, 256, (BATCH, *V1_SHAPE, 3), dtype=np.uint8)
    v1_expected = {
        "V1 ViT-L/14": {"flash_attention_qkv": 24, "ln_dense": 30, "flash_attention": 3},  # 24 blocks; 24 + 6 CvnxtBlocks
        "V1 ConvNeXt-L": {"ln_dense": 42, "flash_attention": 3},  # 36 ConvNeXt blocks + 6 CvnxtBlocks
    }
    v1_launches = {}
    for label, path in CONFIG_V1.items():
        config_v1 = json.loads(path.read_text())
        t0 = time.perf_counter()
        model_v1 = UniDepthV1.from_config(config_v1).init_params(seed=SEED).eval()  # no device named: the card
        log(f"model: {label} {sum(p.numel() for p in model_v1.parameters()) / 1e6:.1f} M params, "
            f"{next(model_v1.parameters()).dtype} on {next(model_v1.parameters()).device}, "
            f"built in {time.perf_counter() - t0:.1f} s")
        out_v1, v1_launches[label] = run_path(f"{label} bf16 infer()", kernels, lambda: model_v1.infer(rgb_v1))
        expected = v1_expected[label]
        check_launches(f"{label} bf16 infer()", v1_launches[label],
                       {**none, **expected, **{f"{k}/wgmma": n for k, n in expected.items()}})
        for key, ch in (("depth", 1), ("points", 3)):
            if tuple(out_v1[key].shape) != (BATCH, *V1_SHAPE, ch) or not torch.isfinite(out_v1[key]).all():
                raise RuntimeError(f"{label}: {key} has shape {tuple(out_v1[key].shape)} or is not finite")
        if tuple(out_v1["intrinsics"].shape) != (BATCH, 3, 3) or not torch.isfinite(out_v1["intrinsics"]).all():
            raise RuntimeError(f"{label}: intrinsics malformed")
        if not (out_v1["depth"] > 0).all():
            raise RuntimeError(f"{label}: depth is not positive everywhere")
        depth_against_plain(label, UniDepthV1, config_v1, rgb_v1[:BATCH_B_CHECK], out_v1["depth"][:BATCH_B_CHECK],
                            kernels, dev, gate=V1_DEPTH_GATE)
        del out_v1
        images_per_s(f"bf16 {label}", lambda: model_v1.infer(rgb_v1), smi,
                     what=f"B={BATCH} {V1_SHAPE[0]}x{V1_SHAPE[1]} (depth, points, intrinsics)")
        del model_v1

    # --- UniDepthV2old ViT-L/14 at 480 x 640: bf16, then int8 -----------------
    v2old_launches, v2old_figures = v2old_phase(kernels, none, smi, dev)

    # --- K1-K4 gradients at the training shapes, then V2 ViT-L/14 training ---
    def train_grad_inputs(seed, *shapes, std=1.0, mean=0.0):
        gen.manual_seed(seed)
        return [randn(*s, dtype=torch.bfloat16, std=std, mean=mean).requires_grad_() for s in shapes]

    qkv_t = train_grad_inputs(21, (BATCH, TRAIN_TOKENS, 3 * 1024))
    m["flash_attention_qkv"]["grad"] = grad_phase(
        f"K1 ({BATCH}, {TRAIN_TOKENS}, 16 x 64)", flash_attention_qkv, flash_attention_qkv_plain, qkv_t,
        (16, 64**-0.5), 21, flash_attention_qkv)
    gen.manual_seed(22)
    k2_t = [randn(BATCH * TRAIN_TOKENS, 1024, dtype=torch.bfloat16, std=2.0, mean=0.5),
            randn(4096, 1024, dtype=torch.bfloat16, std=1024**-0.5), randn(4096, dtype=torch.bfloat16, std=0.1),
            randn(1024, dtype=torch.bfloat16, std=0.1, mean=1.0), randn(1024, dtype=torch.bfloat16, std=0.1)]
    m["ln_dense"]["grad"] = grad_phase(f"K2 (M {BATCH * TRAIN_TOKENS}, C 1024, F 4096)", ln_dense, ln_dense_plain,
                                       [t.requires_grad_() for t in k2_t], (1e-6, "gelu"), 22, ln_dense)
    k3_t = train_grad_inputs(23, *[(BATCH * 8, TRAIN_TOKENS - 1, 64)] * 3)
    m["flash_attention"]["grad"] = grad_phase(f"K3 ({BATCH * 8}, {TRAIN_TOKENS - 1}, 64)", flash_attention,
                                              flash_attention_plain, k3_t, (64**-0.5,), 23, flash_attention)
    # K4 on the three channel slices of one projection, its int8 path's call
    k4_base = train_grad_inputs(24, (BATCH, 1370, 3 * 1024))

    def k4_views(base):
        return flash_attention_packed(*base.split(1024, dim=-1), 16, 64**-0.5)

    def k4_views_plain(base):
        return flash_attention_packed_plain(*base.split(1024, dim=-1), 16, 64**-0.5)

    m["flash_attention_packed"]["grad"] = grad_phase(
        f"K4 ({BATCH}, 1370, 16 x 64) views", k4_views, k4_views_plain, k4_base, (), 24, flash_attention_packed)
    del qkv_t, k2_t, k3_t, k4_base
    # K1, K2 and K3 gradients at the V1 training shapes (462 x 616)
    qkv_v1 = train_grad_inputs(25, (BATCH, V1_K1_TOKENS, 3 * 1024))
    m["flash_attention_qkv"]["grad_v1"] = grad_phase(
        f"K1 V1 ({BATCH}, {V1_K1_TOKENS}, 16 x 64)", flash_attention_qkv, flash_attention_qkv_plain, qkv_v1,
        (16, 64**-0.5), 25, flash_attention_qkv)
    for key, (rows, c, f, eps) in V1_K2_GRAD_SHAPES.items():
        gen.manual_seed(rows + c + 2)
        k2_v1 = [randn(rows, c, dtype=torch.bfloat16, std=2.0, mean=0.5),
                 randn(f, c, dtype=torch.bfloat16, std=c**-0.5), randn(f, dtype=torch.bfloat16, std=0.1),
                 randn(c, dtype=torch.bfloat16, std=0.1, mean=1.0), randn(c, dtype=torch.bfloat16, std=0.1)]
        m["ln_dense"][f"grad_{key}"] = {"shape": [rows, c, f], **grad_phase(
            f"K2 {key} (M {rows}, C {c}, F {f})", ln_dense, ln_dense_plain, [t.requires_grad_() for t in k2_v1],
            (eps, "gelu"), rows + c + 2, ln_dense)}
    bh, n, d = V1_K3_SHAPES["v1_vitl14"]
    k3_v1 = train_grad_inputs(26, *[(bh, n, d)] * 3)
    m["flash_attention"]["grad_v1"] = grad_phase(f"K3 V1 {(bh, n, d)}", flash_attention, flash_attention_plain, k3_v1,
                                                 (d**-0.5,), 26, flash_attention)
    del qkv_v1, k2_v1, k3_v1
    train_launches, train_figures = {}, {}
    for label, spec in TRAIN_FAMILIES.items():
        train_launches[label], train_figures[label] = train_phase(label, spec, kernels, none, smi, dev)
    eval_launches, camera_infer_launches, eval_figures = eval_phase(config, kernels, none, smi, dev)
    v1_int8_launches, v1_int8_figures = v1_int8_phase(kernels, none, smi, dev)
    eval_cli, train_cli = cli_phase()
    eval_figures.update(eval_cli)
    data_launches, data_figures = data_phase(kernels, none, smi, dev)
    serve_launches, serve_figures = serve_phase(kernels, none, smi, dev)
    parallel_records, parallel_launches, parallel_figures = parallel_phase(kernels, none, smi, dev)

    # each kernel's count from the path it serves: K1-K3 and K5 (the heads)
    # the bf16 ViT-L path, K4 the int8 one, K6 and K7 the harness
    path_launches = {
        **launches,
        "flash_attention_packed": launches_q["flash_attention_packed"],
        "run_variant": k6_launches["run_variant"],
        "run_bd": k7_launches["run_bd"],
    }
    # the Hopper body's launches on the same paths
    hopper_launches = {
        **{k: launches[f"{k}/wgmma"] for k in HOPPER},
        "flash_attention_packed": launches_q["flash_attention_packed/wgmma"],
        "run_variant": k6_launches["run_variant/wgmma"],
        "run_bd": k7_launches["run_bd/wgmma"],
    }
    sources = {  # source, TPU kernel, body at the path's shapes, the library yardstick
        "flash_attention_qkv": ("attention_wgmma.cu", "unidepth_tpu/ops/flash_attention.py:471", "wgmma", "SDPA"),
        "ln_dense": ("ln_dense_wgmma.cu", "unidepth_tpu/ops/fused_block.py:102", "wgmma",
                     "F.layer_norm -> F.linear -> F.gelu, three calls"),
        "flash_attention": ("attention_wgmma.cu", "unidepth_tpu/ops/flash_attention.py:159", "wgmma", "SDPA"),
        "flash_attention_packed": ("attention_wgmma.cu", "unidepth_tpu/ops/flash_attention.py:347", "wgmma", "SDPA"),
        "conv3x3_lowchannel": ("conv3x3_wgmma.cu", "unidepth_tpu/ops/conv_kernels.py:88", "wgmma", "F.conv2d (cuDNN)"),
        "run_variant": ("attention_ab.cu", "scripts/kernel_ab.py:53", "wgmma", "SDPA"),
        "run_bd": ("attention_ab.cu", "scripts/kernel_ab.py:214", "wgmma", "SDPA"),
    }
    # K3 at the narrower head dims joins K3's record (the path's record is D = 64)
    m["flash_attention"].update(k3_narrow)
    # the V2old paths' counts (bf16, int8) beside them
    for name in ("flash_attention_qkv", "ln_dense", "flash_attention", "flash_attention_packed"):
        m[name]["v2old_launches"] = {p: counts[name] for p, counts in v2old_launches.items()}
    # the V1 paths' counts beside the V2 main path's
    for name in ("flash_attention_qkv", "ln_dense", "flash_attention"):
        m[name]["v1_launches"] = {label: counts[name] for label, counts in v1_launches.items()}
        m[name]["train_launches"] = train_launches["V2 ViT-L/14"][name]  # one optimizer step, 2 micro-batches
        # one optimizer step of each family (V2, V1 ViT-L, V1 ConvNeXt-L, V2old)
        m[name]["family_train_launches"] = {label: counts[name] for label, counts in train_launches.items()}
        m[name]["eval_launches"] = {"validate_batch": eval_launches[name], "camera_infer": camera_infer_launches[name]}
    for name in ("flash_attention_qkv", "ln_dense", "flash_attention", "flash_attention_packed"):
        m[name]["v1_int8_launches"] = v1_int8_launches[name]
    augment_figures = data_figures.pop("augment")
    for name in ("flash_attention_qkv", "ln_dense", "flash_attention"):
        m[name]["data_train_launches"] = data_launches[name]  # DATA_STEPS loader-fed steps
        m[name]["augment_train_launches"] = augment_figures["launches"][name]  # AUG_STEPS steps through the sixteen
    # the serving phase's paths: the CLI's three batches, a register-token V2
    # infer(), the SwiGLU ViT-g/14 encoder
    for name in ("flash_attention_qkv", "ln_dense", "flash_attention", "flash_attention_packed", "conv3x3_lowchannel"):
        m[name]["serve_launches"] = {path: counts[name] for path, counts in serve_launches.items()}
    # the parallel phase: the shapes tp=2 gives K1-K3, and a rank's launches in
    # PAR_STEPS train steps under each mode
    for name in ("flash_attention_qkv", "ln_dense", "flash_attention"):
        m[name]["parallel"] = parallel_records[name]
        m[name]["parallel_launches"] = {mode: counts[name] for mode, counts in parallel_launches.items()}
    record = [
        {"name": name, "route": "cuda", "source": f"unidepth_tpu_torch/csrc/{src}", "replaces": rep, "body": body,
         "launches": path_launches[name],
         **({"hopper_launches": hopper_launches[name]} if name in hopper_launches else {}), **m[name],
         "library": library}
        for name, (src, rep, body, library) in sources.items()
    ]
    record.append({"name": "head_mlp", "route": "cuda", "source": "unidepth_tpu_torch/csrc/head_mlp_wgmma.cu",
                   "replaces": None, "body": "wgmma", **k2h,
                   "library": "per head: fp32 F.layer_norm of the permuted latents -> bf16, nn.Linear"})
    log(json.dumps({"train": train_figures}))
    log(json.dumps({"v1_int8": v1_int8_figures, "train_cli": train_cli}))
    log(json.dumps({"eval": eval_figures}))
    log(json.dumps({"v2old": v2old_figures}))
    log(json.dumps({"data": data_figures}))
    log(json.dumps({"augment": augment_figures}))
    log(json.dumps({"serve": serve_figures}))
    log(json.dumps({"parallel": parallel_figures}))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s, the build included")
    log(json.dumps({"kernels": record}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
