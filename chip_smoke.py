#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: nvcc builds every kernel source of ``src/repro_torch/kernels/
   csrc`` for sm_90a (one nvcc per source, in parallel);
3. kernel vs plain: the fused DCL kernel (1a) against its plain PyTorch
   version on the card, at every distinct DCL shape of resnet50_dcn_bounded
   at buckets 256 and 512 and batch 4, at the five shapes of a training
   step (batch 8, 512) and at edge geometries (ragged output, dilation 2,
   stride 2), with offsets of which ~18% exceed ±B; tolerance
   ``max|kernel - plain| <= 1e-5 * max|plain|``; two calls must give
   ``torch.equal`` outputs; the shared memory must equal the chooser's
   mirror.  Each case prints its instance (pixel lanes, output tiles, M
   tiles, C groups, 16-byte or element-wise staging, blocks an SM) and
   two bounds with the kernel's share of each: fp32 on the CUDA cores and
   its own 3xTF32 products at the TF32 rate (the lower is the row's
   bound); kernel 1a a training step is the five training shapes times
   their DCLs a step.  Times from CUDA events, also of the input
   preparation (padding, weight blocking);
4. serve: full-width resnet50_dcn_bounded (random seeded params, offset
   conv perturbed so taps interpolate) through the port's serving engine
   at buckets 256/512, 4 slots, 8 requests; every request must be ``ok``
   on ``fp32_kernel``, the kernel must launch 12 times per engine step,
   and ``cls``/``box`` must match the plain path on the card within
   ``1e-3 * max|ref|``.  Each bucket's forward is timed with CUDA events.
5. int8 kernels vs plain on the card: first ``mma_s8`` (the s8
   tensor-core product with the kernels' fragment loads) against an int
   matmul; then the int8 dequant kernel (dcq) and the int8 chain kernel
   (dcc, int8 emission) at every distinct DCL shape of both buckets at
   batch 4, and at edge geometries (ragged output, dilation 2 with B =
   1.5, stride 2 on an odd extent, 4-byte staging with several C groups
   and with one, fp32 emission, an int8 input handed over verbatim),
   offsets beyond ±B in a share of taps; each must equal its plain
   version exactly (``torch.equal``), two calls must be equal, and the
   shared memory must equal the chooser's mirror.  Each case prints its
   instance (pixel lanes, tile_m, output and M tiles, C groups, 16-byte or
   4-byte staging, blocks an SM), its device launches a call with each
   one's time (``torch.profiler``), its time queued behind a busy device
   and back to back (CUDA events), and three floors with the kernel's
   share of the largest, the row's bound: int8 products at the
   tensor-core rate, bytes at the HBM rate and ``sample_bound_ms``, the
   patch build (7 fp32 operations a bilinear sample) on the CUDA cores.
6. int8 serve: the same model, calibrated on the card, served on
   ``int8_chain`` and on ``int8`` (cuDNN deterministic, so every path
   feeds the same offsets); every request ``ok`` on its rung, 12 launches
   of the rung's kernel per step and none of the other two, ``cls``/``box``
   within ``1e-3 * max|ref|`` of the same rung with the plain versions in
   place of the kernels, and the relative error of ``cls`` against
   ``fp32_kernel`` at most 0.1.  The three rungs' forwards are timed per
   bucket in turns (CUDA events), beside their device time from
   ``torch.profiler``.

7. backward kernel vs plain on the card: the fused backward (TPU kernel 2)
   at the five distinct DCL shapes of a training step of
   resnet50_dcn_bounded at batch 8 and 512, and at edge geometries
   (ragged output, dilation 2 with B = 1.5, stride 2 on an odd extent;
   every case has tile_c < C), offsets beyond ±B in a share of taps;
   tolerance ``max|kernel - plain| <= 1e-4 * max|plain|`` for each of dx,
   d_offsets and dw (fp32 atomics reorder the sums); the autograd function
   on the card against autograd through the band-local plain forward on
   the same padded inputs (all three gradients), and through the
   global-frame reference (d_input and d_weights; its d_offsets error is
   printed beside the share of taps whose floor differs between the two
   frames, where the bilinear gradient jumps), same tolerance; both
   kernels' shared memory against the chooser's mirrors;
   times from CUDA events, each sub-kernel's from ``torch.profiler``.
   Each case prints its plan (C groups, the d_weights channel width, the
   instance: pixel lanes, mma tiles a warp, k-split, 16-byte or
   element-wise loads) and two bounds with the kernel's share of each:
   fp32 on the CUDA cores and the kernel's own 3xTF32 products at the
   TF32 rate (the lower is the row's bound).  Kernel 2's time a training
   step (the five shapes times their DCLs a step) is printed beside the
   36.876 ms of its CUDA-core design (``PERF.md`` section 6) and half of
   it, 18.4 ms; no gate on time.
8. train: full-width resnet50_dcn_bounded through
   ``launch.train.train_detection`` for 6 steps (batch 8, 512x512, Eq. 5
   at lambda = 0.005, offset convs perturbed as in phase 4, cuDNN
   deterministic); every loss finite, no step skipped, 12 launches of the
   forward kernel and 12 of the backward kernel per step and none of the
   int8 kernels; step 0's loss within 1e-4 relative of the same step with
   the plain versions in place; its gradients within a relative norm of
   1e-3 of the same step with the plain backward in place, and, with both
   plain versions in place, within the plain path's own spread (see
   ``train``); 4 steps plus a resumed run to 6 within a relative norm of
   1e-4 of the uninterrupted run (params).  Step time (host clock
   and CUDA events), its forward/backward split and the device-busy share
   from ``torch.profiler``, and kernels 2's and 1a's shares of the device
   time.

9. sampling, banded forward and matmul kernels vs plain on the card:
   kernel 1b (zero-copy sampling) and kernel 3 (banded sampling) at the
   five DCL shapes of the 512 bucket at batch 4 and at a ragged H and a
   dilation-2 case, in fp32 and bf16, each ``torch.equal`` to its plain
   version (fp32 also within 1e-6 absolute) with its shared memory equal
   to the chooser's mirror; each prints its tiles, C groups and vector
   width, its time back to back, queued behind a busy device and with
   the L2 flushed by a read before each call (the reads' own time taken
   off, so a call also pays the write-back of its output; CUDA events),
   its host launch path (host clock), its bytes bound (at its element
   size) and its share of it (queued, or flushed where the output fits
   in the 50 MB L2), beside ``F.grid_sample`` computing the same function
   in the same dtype (held to the plain version within 1e-5 * max|plain|
   in fp32; a bf16 grid moves positions, so its bf16 error is printed
   only); kernel 4 (the banded fused forward) at every distinct DCL
   shape of both buckets, the five training shapes at batch 8 (kernel 4
   a banded training step) and the same two edge cases, within 1e-5 * max|plain|, each with phase 3's instance, bounds
   and ``torch.equal`` check; kernel 5 (matmul) at 256^3, 512^3,
   4096^3 and 257x129x65 in fp32 (1e-5 * max|plain|) and 512^3 and
   4096^3 in bf16 (one bf16 step, 2^-7 * max|plain|), beside
   ``torch.matmul``, each case naming the instance it ran (tile, aligned
   16-byte or element-wise loads).  Then the
   entry points as a user calls them: ``ops.deform_sample`` on both
   dataflows in fp32 and bf16 and ``ops.deform_conv(dataflow=...)`` on
   both at the five shapes (sample + einsum within 1e-5 * max|fused| of
   the fused output; the bf16 patches ``torch.equal`` to the fp32
   kernel's on the same bf16 inputs, rounded once) and ``ops.matmul`` at
   the six matmul cases, counting launches.
10. serve banded: phase 4's model and requests with ``dataflow="banded"``
   on ``fp32_kernel``; every request ``ok``, 12 launches of kernel 4 per
   step and none of 1a, ``cls``/``box`` within ``1e-3 * max|ref|`` of the
   plain path and within ``1e-4 * max|zc|`` of phase 4's zero-copy
   results for the same requests; forwards of both dataflows timed in
   turns.
11. train banded: phase 8's settings with ``dataflow="banded"`` for 2
   steps; 12 launches of kernel 4 and 12 of kernel 2 per step, none of
   1a; losses finite, no step skipped; step 0's loss within 1e-5 relative
   of phase 8's zero-copy step 0 and its gradients within phase 8's gate
   (the plain path's own spread) of the plain path's; step time, device
   idle share and kernels 2's and 4's shares of the device time.

12. flash attention (kernel 6) vs plain on the card: the six cases of
   ``tests/test_flash_attention.py`` in fp32 and bf16 (tolerance
   ``atol = rtol`` = 2e-5 / 2e-2, elementwise); tinyllama's prefill heads
   (KV 4, G 8, Dh 64, causal) at (B, S) = (1, 512), (4, 512), (1, 2048),
   (4, 2048), (1, 4096) in bf16 and (1, 2048) in fp32, also against the
   LM's ``attention(impl="dense")`` (3e-5 in fp32); deepseek-7b's MHA and
   glm4-9b's GQA heads (Dh 128) at (1, 2048) in bf16 and fp32, and
   recurrentgemma-9b's MQA heads (Dh 256) at (1, 2048) in both, the fp32
   ones also against ``attention(impl="dense")``; softcap 30 at (1, 1024);
   cross shapes Sq=1/Sk=2048 and Sq=100/Sk=1000; (1, 8192) fp32 causal,
   also against ``attention(impl="chunked")`` (3e-5); three decode-like
   cross cases at tinyllama's heads that take the split over K (bf16
   Sq=1/Sk=8192 and Sq=16/Sk=4096, fp32 Sq=1/Sk=2048), summed apart so
   the bf16 totals stay on the 15 bf16 cases before them.  Each case prints
   its split count, every split case is also held to
   ``flash_attention_split_plain`` with the same count (and prints the
   combine kernel's share of its device time), every bf16 case is also
   held to a relative L2 error of 1e-2 against each plain version, and
   each prints
   the kernel's, the plain version's and ``F.scaled_dot_product_attention``'s
   time (CUDA events, median; SDPA held to the plain version within the
   same tolerance; none for softcap) beside its bound and error, and the
   kernel's time with the calls queued behind a busy device (the small
   cases' back-to-back time is the host's launch path); then
   every case once through ``flash_attention`` as a user calls it, with
   one launch per case counted (the split kernel and its combine are
   one).
13. LM serving at full width: tinyllama-1.1b (22 layers, d 2048, vocab
   32000, bf16 compute on fp32 params from seed 0) (a) through the
   launcher's ``serve_lm`` with its defaults (8 requests of 4-12 tokens,
   4 slots, cache 128, 16 new tokens); (b) through the ``ServingEngine``:
   8 prompts of 128-1024 tokens, 32 new tokens, 4 slots, cache 2048; each
   request's served bf16 logits are held to a teacher-forced
   ``forward(mode="train")`` over prompt + output in bf16 and in fp32
   (relative norms): served vs teacher-forced bf16 within 2e-2 or the
   teacher-forced bf16 logits' own distance to fp32, whichever is larger;
   served and teacher-forced bf16 equally far from fp32 within 2e-3; both
   within 4e-2 of fp32; and the teacher-forced argmax must equal the
   served token wherever its top-2 margin exceeds 2e-2 of the row's
   largest |logit|; (c) 4 of those prompts served with ``dtype=float32``
   must equal naive greedy decoding token for token.  Prefill time per
   prompt length, decode-step time (CUDA events), tokens/s, the device
   idle share of decode steps and the share of their weight casts
   (``torch.profiler``), peak memory.  The LM path runs no kernel of the
   port (its attention is plain PyTorch, as the JAX model's is XLA): the
   phase counts 0 launches of every kernel.
14. bf16 DCL: the bf16 instances of kernels 1a, 4 and 2 at the five DCL
   shapes of a training step (batch 8, 512), both serving buckets'
   shapes at batch 4, phase 3's three edge geometries and a narrow chunk
   (C 4, tile_c 2), on bf16 inputs (offsets beyond ±B in a share of
   taps).  Per case and dataflow: 1a-bf16 (zero-copy) and 4-bf16
   (banded) within one bf16 step of their plain versions on the card
   (``max|kernel - plain| <= 2^-7 * max|plain|``, and at most 1% of
   the outputs unequal: a kernel that skipped the bf16 rounding of the
   patches differs in ~40%), two calls ``torch.equal``, shared memory
   equal to the chooser's bf16 mirror; per case kernel 2-bf16 against
   its plain version (dx and d_offsets, rounded to bf16, within one bf16
   step of their max|plain|; dw, fp32, within phase 7's 1e-4) and its
   shared memory against the mirrors.  Each prints its instance, its
   time back to back and queued behind a busy device (CUDA events), the
   fp32 kernel's time on the same inputs upcast, the plain version's,
   its bound and its share of it: the bf16 products at 989 TFLOP/s or
   the bytes at 2 an element over 3.35 TB/s (1a, 4); kernel 2's dP as
   one bf16 pass at 989 TFLOP/s plus its dw as two tf32 passes at 494.7
   TFLOP/s, or its bytes (2).  Then
   the entry-point run: every count set to 0, and per case and dataflow
   one ``ops.deform_conv`` on the bf16 inputs and one gradient through
   it, each forward launching exactly one bf16 kernel of its dataflow and
   no fp32 forward kernel, each gradient one bf16 kernel 2 with d_x,
   d_offsets and d_w within one bf16 step of the plain backward.
15. operations, at full width, every count set to 0 first: (a) phase 8's
   checkpoint (``build/smoke_train/full``) served through
   ``launch.serve --ckpt`` on ``fp32_kernel`` and ``int8_chain`` (buckets
   256/512, batch 4, 8 requests, all ``ok``), ``cls``/``box``
   ``torch.equal`` to the same engine fed the trained params in memory;
   (b) each run's divergence report: one row per DCL shape, 12
   dispatches a step, every dispatch timed on the device and none above
   1.05 of its H100 bound (``core.h100``); ``launch.obs_report`` renders
   the telemetry; each bucket's forward with the recorder on (CUDA
   events) beside phase 4's (6's) without it, and in turns without it,
   with a hook that does nothing and with one that records only the
   events; at 256 the recorder's host cost: the host's time to enqueue
   a forward with and without it (``time.perf_counter``, 20 turns) and
   its ``flush``, per dispatch (printed, not gated); (c)
   ``tune_deform_conv`` on the 256 bucket's DCL shapes (fp32, int8,
   int8_chain; batch 4) and the training step's largest (training
   objective, batch 8), 4 candidates, best of 3, every entry keyed
   ``cuda_sm90`` and every candidate measured (each passed
   ``tiling.tiles_fit``, so one that raises fails the phase); with the cache
   installed (plus ``cpu``-keyed entries for the 512 bucket) the engine
   serves every 256 layer ``"tuned"`` and every 512 layer ``"analytic"``,
   ``int8_chain`` ``torch.equal`` and ``fp32_kernel`` within 1e-5 *
   max|analytic| of (a); (d) a serving chaos plan (slow_step,
   malformed_request, bucket_miss_storm, one dispatch_fault) on
   ``int8_chain`` at 256: every request typed, none degraded, the faulted
   batch retried ok on its rung, the untouched requests ``torch.equal``
   to a clean run; a ``FaultPlan.random`` over 8 full-width training
   steps (nonfinite_grads, ckpt_corrupt, step_crash, data_hiccup): every
   step completes, at least 3 kinds fire, the params within 1e-4
   (relative norm) of the run that sees only its non-finite step (kernel
   2 adds d_input by fp32 atomics, so a replayed step may round another
   way), and the same plan with a wrong recovery planted (its first
   restore loses the step it replays, or replays one already passed)
   lands at least 3 x 1e-4 from it, so the check tells a wrong recovery
   from a sound one; the skip-only run's last update is printed beside
   them.  1a, 1c, 1d and 2 must each launch in the phase; the kernels
   line gives each its ``operations_launches``.
16. LM training and the RG-LRU family, every count set to 0 first (no
   TPU kernel lies on these paths, so none of the port's launches):
   (a) full-width tinyllama-1.1b (1.100B fp32 params from seed 0, bf16
   compute, remat "full", AdamW) through ``launch.train.train_lm`` at
   batch 8 x 2048: 6 steps, every loss finite, none skipped, step 0
   within 5% of ln(32000) and equal (1e-5) to the chunked CE of the same
   batch; the resume check cut to its first 2 layers (0.219B params, a
   2.6 GB checkpoint instead of 13.2): 6 uninterrupted steps, then 4 and
   a new run resumed to 6 from the step-4 checkpoint, its params within
   1e-5 (relative norm) of the uninterrupted run's (not bit for bit: the
   embedding's backward scatter-adds); on step 0's
   batch and params the chunked CE within 1e-5 of the dense CE of the
   full logits, the bf16 loss within 1e-2 of an fp32-compute loss, and
   the gradients of one sequence under remat "full" and "dots" within
   1e-6 of "none"'s; the full-depth step's forward, backward and AdamW
   time (CUDA events), tokens/s, idle share (``torch.profiler``) and
   peak memory;
   then the reduced config in fp32 for 5 steps on the card and on the
   CPU, loss histories within 1e-4.  (b) full-width, full-depth
   recurrentgemma-9b (9.396B fp32 params from seed 0, bf16 compute):
   ``rg_lru_scan`` against 256 ``rg_lru_step`` calls on one full-width
   layer (1e-5); ``serve_lm`` with its defaults at cache 2048; the
   engine on phase 13's 8 prompts (128-1024 tokens, 32 new, 4 slots,
   cache 2048 = the window) under phase 13's gates with the bf16 cap at
   1.5 x max(the predicted 4e-2, 4e-2); 2 prompts x 16 tokens in fp32
   equal to naive greedy decoding; prefill and decode times, idle share,
   peak memory.  (c) recurrentgemma at full width and 3 layers (one
   period, cut from (b)'s params; all 38 layers need 150 GB of fp32
   params, gradients and AdamW state) through ``train_lm`` for 4 steps
   at batch 4 x 2048 (a checkpoint at the end): losses finite, none
   skipped; step time and peak memory.
17. the remaining LM families, every count set to 0 first (no TPU
   kernel lies on these paths either): (a) full-width, full-depth
   rwkv6-3b (3.073B fp32 params from seed 0, bf16 compute):
   ``wkv_chunked`` against 256 ``wkv_step`` calls on layer 0's decays
   (5e-4, JAX's bound); ``serve_lm`` with its defaults; the engine on
   phase 13's prompts, whose bf16 logits are held by
   ``hold_chaotic_logits`` (the random model moves its fp32 logits ~0.5
   under a bf16 roundoff of its embeddings, so phase 13's cap cannot
   hold): served bf16 no farther from teacher-forced bf16 than that is
   from fp32, the fp32 engine's logits within 1e-3 of a teacher-forced
   fp32 forward and its tokens the argmax at clear margins; 2 x 16
   tokens in fp32 equal to naive greedy decoding; prefill and decode
   times, idle share; its first 4 layers (all 32 fit at 70.6 GB, but
   their 37 GB checkpoint takes ~80 s) through ``train_lm`` for 6 steps
   at batch 4 x 2048, remat "full": losses
   finite, none skipped, step 0 within 5% of ln(V) + 1/2; step time, one
   step profiled, peak memory.
   (b) dbrx-132b at its widths cut to 2 layers (7.751B params): the
   launcher at capacity factor 1.25, the share of choices each prefill
   drops printed; phase 13's gates on a drop-free copy (factor e/k = 4);
   2 x 16 fp32 tokens at 1.25 equal to per-request ``prefill`` +
   ``decode_step`` outside the engine; one layer of the same params
   through ``loss_fn`` and its backward at batch 1 x 2048: finite, aux
   above 0, bf16 within 1e-2 of fp32 compute. (c) full musicgen-medium:
   fp32 prefill + 8 ``decode_step`` calls with (2, 4) tokens within
   1e-5 of the teacher-forced forward; ``serve_lm`` refuses it with the
   JAX launcher's message; step-0 checks as (a) of phase 16; its first
   6 layers 6 steps of ``train_lm`` at batch 8 x 2048, step 0 equal
   (1e-5) to the chunked CE of the same cut params (all 48 layers write a
   16.6 GB checkpoint). (d) pixtral-12b at its widths cut to
   4 layers: a forward with a (2, 256, 5120) frontend, ``loss_fn`` on
   the text positions equal to the chunked CE of the hidden state after
   the frontend, prefill with the frontend + 4 decode steps within 1e-5
   of the teacher-forced forward. (e) the five reduced configs in fp32,
   3 ``train_lm`` steps on the card and on the CPU within 1e-4.
   ``--only 17`` runs phases 1 and 17 alone and prints no result.
18. the device mesh, on one card: every mesh repeats ``cuda:0`` (the
   single-controller mesh of ``distributed.sharding``: one card runs every
   shard, halo exchange and kernel launch).  (a) the spatial (height)
   shard of kernels 1a, 1c and 2 at the five distinct shapes of the 512
   bucket's 12 DCLs (batch 4) at 2 and 4 shards and a stride-2 edge case
   (24x21, ragged width), offsets beyond ±B in a share of taps: 1a with
   pinned tiles (tile_h dividing the shard's rows) ``torch.equal`` to the
   unsharded kernel, with the chooser's shard-local tiles within 1e-5 *
   max|y|; 1c pinned ``torch.equal``; kernel 2's three gradients within
   1e-4 * max; one launch of each a shard; each case's unsharded and
   sharded time (CUDA events).  (b) the engine at buckets 256/512 with
   ``spatial_shards=((256, 2), (512, 4))`` on ``fp32_kernel`` and on an
   ``int8_chain`` entry (which enters at ``int8``), 8 requests: every one
   ``ok`` on its rung, 12 x shards launches of the rung's kernel a step,
   ``cls``/``box`` against the flat engine within phase 10's 1e-4 * max
   (fp32: another summation order); int8 by relative norm within half
   the int8 rung's own error against the flat fp32 engine (the
   shard-local tile_h moves the band frame a patch rounds in, and the
   next layer's activation grid turns such a flip into a whole step);
   each bucket's forward timed beside the flat one.  (c) 2 Trainer steps of full-width
   resnet50_dcn_bounded at batch 8 x 512 on a (data=2) mesh without and
   with ``int8_ef``, on a (data=4) mesh (every layer on its data shard,
   ``models.resnet_dcn``) and with ``shard_spatial`` on a (model=2) mesh:
   losses finite, 12 launches of 1a and of 2 a shard a step (each data
   or height shard launches each once a DCL: 24 on 2 shards, 48 on 4);
   params within
   a relative norm of the flat Trainer's of twice the flat run's own
   spread under another summation order (the banded dataflow), and
   never held below 1e-4 (one bit of the step-0 gradient moves the
   random full-width model's later gradients by ~4e-3, phase 8), the
   int8_ef run against the flat int8_ef run (the compression's own move
   of the run is printed beside it); each data run's counted crossings
   (``sharding.count_crossings``) equal to ``launch.collectives.
   dcn_collectives`` kind by kind (every param's fp32 gradient from each
   data shard but the first: an all-reduce), and the bytes autograd
   saves for one step's backward by mesh position
   (``sharding.saved_bytes``, the params not counted) at most 1/n of the
   flat step's plus 5% at each position (the mesh repeats ``cuda:0``, so
   the card's peak memory cannot show the split).  cuDNN is
   deterministic.  (d)
   command-r-35b at its widths cut to 4 of 40 layers (4.92B params drawn
   on the card from a seeded CUDA generator): ``serve_lm`` with its
   defaults, phase 13's prompts and gates through the engine (bf16 cap
   1.5 x max(1e-2 predicted, 4e-2)), 2 x 8 fp32 tokens equal to
   ``prefill`` + ``decode_step``; ``pipelined_forward`` at 2 stages x 2
   layers and 4 microbatches within 1e-5 (relative norm) of
   ``transformer.forward`` in fp32, and the bubble fraction.  (e) the
   reduced command-r-35b (forward, pipelined) and the reduced DCL mesh
   paths (a spatial forward at 128 on 2 shards, 2 data-parallel Trainer
   steps on 2 data shards, each DCL call on one shard's rows) card vs CPU
   within 1e-4.  The main path's launches
   of 1a, 1c and 2 are counted from 0 over (b) and (c); the kernels line
   gives each row its ``mesh_launches``.  ``--only 18`` runs phases 1, 2
   and 18 alone and prints no result.  Phases 16-18 draw their LM params
   on the card (``card_params``).
19. the planning layer.  (a) ``launch.dryrun`` over every runnable (arch
   x shape) cell of the registry on the three meshes (one card, 16x16,
   2x16x16), all on the ``meta`` device; it runs in background CPU
   processes (niced, no card) from the end of phase 2, and the phase
   waits for it.  Each cell must have a record without an error, the
   registry's skipped cells none; one line a cell: params, argument GB
   a device on each mesh, peak live GB on one card, whether that fits
   80 GB, the roofline's dominant term and time (``launch.roofline`` at
   the H100's peaks).  Then one rule experiment through the CLI,
   started beside the dry run: tinyllama-1.1b train_4k on 16x16 with
   ``--set-rule embed=None --tag no_fsdp``; its record must hold
   ``rule_overrides == {"embed": None}``, argument bytes a device equal
   to ``tree_shard_bytes`` of the cell's inputs under those rules and
   above the untagged record's (the params no longer FSDP-sharded over
   ``data``), and collective bytes equal to ``launch.collectives.
   lm_collectives`` under those rules over the mesh's devices; a second
   run with ``--skip-existing`` must skip it.  (b) the shapes this script
   runs on the card —
   resnet50_dcn_bounded's fp32 served forward at buckets 256 and 512
   (batch 4) and phase 8's training step (batch 8 x 512), tinyllama-1.1b's
   training step (8 x 2048) and a decode step (batch 4, cache 2048) —
   each dry-run on ``meta``, then the same step (``launch.steps``) run on
   the card on real tensors (phase 4's DCL params; tinyllama's drawn on
   the card): the argument bytes must equal the real tensors' summed
   ``nbytes`` and the FLOPs those ``FlopCounterMode`` counts over the
   real step (DCL calls priced by ``core.h100``'s works in both); the dry
   run's peak live bytes (an op's own temporaries counted,
   ``dryrun.op_temp_bytes``) over the step's own
   ``torch.cuda.max_memory_allocated()`` must lie within 0.95-1.05, and
   the roofline time is printed beside the step's time between CUDA
   events, with its ratio; before them each op ``op_temp_bytes`` prices
   runs on the card at each layout it tells apart (softmax backward with
   grad and output contiguous or permuted, fp32 and bf16; logsumexp),
   the allocator's peak inside the call beyond its output equal to the
   term.  The DCN
   steps run kernels 1a and 2; their launches are counted from 0 over
   (b) and must not be 0.  ``--only 19`` runs phases 1, 2 and 19 alone
   (the dry run in the foreground) and prints no result.
20. an LM's params laid out on the mesh by their specs, every mesh
   repeating the card.  (a) full-width tinyllama-1.1b cut to 6 of its
   22 layers (bf16 compute) on
   (data=2, model=4): 3 AdamW steps of the Trainer's own step path at
   batch 2 x 2048, plain, with int8_ef and with microbatches=2, each held
   against the flat Trainer of the same setting by relative norm at most
   2x the flat run's own spread (microbatches=2 against 1) and never
   below 1e-4; each prints the bytes every mesh position holds
   (``placement_summary``), the peak memory and the step's time between
   CUDA events beside the flat step's (no gate on those).  (b) fp32
   loss and gradients on placed params against the flat path (loss 1e-5
   relative, each leaf 1e-4 relative norm): tinyllama on (1, 8) (KV 4
   replicated per query group), musicgen-medium at 4 layers on (1, 16)
   (sequence-parallel attention) and command-r-35b at 2 layers on (1, 4)
   (the vocab-parallel tied CE); tinyllama's prefill on (1, 8): its cache
   ``repeat_interleave`` of the flat cache's KV heads, cache and logits
   within 1e-5 x max.  (c) tinyllama at full width, 4 layers (fp32, SGD
   with momentum): 4 steps on (2, 2), a checkpoint, the state restored
   on (4, 2) equal to the checkpointed one, 2 more steps, held against a
   straight 6-step run on (4, 2) at JAX's elastic oracle (rtol 5e-4,
   atol 5e-5), which a planted wrong restore (momentum lost) must fail;
   a flat Trainer restores the same checkpoint; two straight runs with
   JAX's AdamW on the two meshes print how far apart they lie (not
   gated: AdamW's eps turns summation noise into whole steps at this
   width).  The phase runs no kernel.  ``--only 20`` runs phases 1 and 20 alone and prints
   no result.
22. the design-space layer (``core.tiling``'s Sec. 3.2 algebra, the Eq. 6
   inverse and the traffic model of the kernels at their tiles).  (a) At
   the five DCL shapes of the 512 bucket, batch 4, each main-path
   instance (fp32 1a, banded 4, int8 1c, int8_chain 1d, kernel 2, fp32
   1b) at the chooser's tiles: the modeled traffic beside the
   ``core.h100`` bound's bytes (gate: traffic >= bound bytes), the
   kernel's time (CUDA events, best of 5 back to back) and traffic /
   time.  (b) Every ``neighbor_kernel_tiles`` candidate of fp32 1a at
   32² x 256 (then of 1a, kernel 2 and 1c at all five shapes): the
   Spearman rank correlation of traffic and time, and each one's pick
   (no gate).  (c) On 16² x 512, for fp32, int8,
   int8_chain and fp32_bwd, the largest B the chooser takes (B*): a call
   at B* launches its kernel and meets its plain version within the
   datapath's phase tolerance; B* + 1 raises the chooser's ValueError
   through the entry point and launches nothing; beside
   ``max_offset_bound_fitting`` at the paper's tiles.  ``--only 22``
   runs phases 1, 2 and 22 alone and prints no result.

The kernels line gives ``ms``, ``plain_ms`` and ``bound_ms`` per main-path
run: each shape's phase-3 (phase-5, phase-7, phase-9) time times the
launches of that shape in the run of phase 4 (of the kernel's rung in
phase 6, of phase 8's 6 training steps, of phase 10 for kernel 4, of
phase 9's entry-point run for 1b, 3 and 5, of phase 12's run for 6),
summed.  Every bound, of a row and of each case, comes from
``core.h100`` (the module that prices the engine's dispatches): each
call's work, summed over the run's launches and bounded as one; kernel
4's counts the materialised bands, checked against each call's
tensors.  Kernels 1a and 4 also carry ``training``: their launches and
times in phase 8's 6 steps (1a) and phase 11's 2 banded steps (4), with
the step's ``torch.profiler`` time of their launches; their
``bound_ms`` (and kernel 2's) is the lower of the 3xTF32 and the fp32
CUDA-core bounds.  The int8 kernels' (1c, 1d) rows add ``queued_ms``,
phase 5's time queued behind a busy device (a call is 2-4 launches of
5-60 µs, below the host's launch path), and their ``bound_ms`` is the
largest of their three floors.  The sampling kernels' (1b, 3) rows count
their fp32 and bf16 launches of phase 9's entry-point run, add
``queued_ms`` and ``flushed_ms`` (phase 9's times queued and with the L2
flushed) and give each dtype apart in ``by_dtype``.  The bf16 rows of
kernels 1a, 4 and 2 (``*_bf16``) count phase 14's entry-point run, their
times are phase 14's per case summed over the run's launches, and they add
``queued_ms`` and ``fp32_ms`` (the fp32 kernel on the same inputs).

TF32 is off for every fp32 matmul and convolution.  Without a GPU, or
without the rest of the repository beside it, the script prints no result
and exits 2.  Details go to ``chiprun_out/chip_smoke.json``.  The whole
script has 1200 s; it aims at 900 (``SCRIPT_SECONDS``, printed), so the
training runs that write checkpoints of 13-37 GB at full depth are cut
in depth (phases 16(a)'s resume check, 16(c), 17(a), 17(c), 20(a)), each
at full width.
"""
from __future__ import annotations

import atexit
import dataclasses
import json
import math
import os
import shlex
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke.json"

# The H100's peaks (NVIDIA's data sheet), the DCL kernels' work and
# every bound below, from the module that also prices the engine's
# dispatches.  A script alone, without the repository beside it, finds
# none: main() then exits 2 before any is read.
sys.path.insert(0, str(ROOT / "src"))
try:
    from repro_torch.core import h100
except ImportError:
    pass
# Names of the device launches a call of kernel 6 and of the int8 kernels
# makes, as torch.profiler reports them.
FA_KERNEL_NAMES = r"fa_(tc_kernel|kernel|combine)[^(]*"
Q_KERNEL_NAMES = r"dc[qoc]_\w+|dqt_\w+|Memset"
KERNEL_RTOL = 1e-5
BWD_RTOL = 1e-4             # per cotangent: fp32 atomics reorder the sums
SERVE_RTOL = 1e-3
TRAIN_LOSS_RTOL = 1e-4      # step-0 loss, kernels vs plain versions
TRAIN_GRAD_RTOL = 1e-3      # step-0 gradients (relative norm), see train()
RESUME_RTOL = 1e-4          # 4 + resumed 2 steps vs 6 (relative norm)
TRAIN_BATCH = 8
TRAIN_STEPS = 6
INT8_VS_FP32_MAX = 0.1      # relative norm error of cls, int8 vs fp32_kernel
SAMPLE_ATOL = 1e-6          # sampling kernels: the plain version's roundings
LIBRARY_RTOL = 1e-5         # grid_sample vs the plain sampling (its grid
                            # is normalised, so positions move ~1e-6 px;
                            # fp32 only: a bf16 grid moves them ~0.1 px)
SAMPLE_DTYPES = ("float32", "bfloat16")
L2_BYTES = 50 * 2 ** 20     # H100 L2 cache
L2_FLUSH_BYTES = 2 * L2_BYTES
BF16_RTOL = 2.0 ** -7       # one bf16 step at the largest output
BF16_UNEQUAL_MAX = 0.01     # share of a bf16 forward's outputs unequal to
                            # the plain version's (fp32 sums reordered; a
                            # kernel without the bf16 patch rounding: ~40%)
BANDED_VS_ZC_RTOL = 1e-4    # served banded vs zero-copy (summation order)
BANDED_LOSS_RTOL = 1e-5     # step-0 loss, banded vs zero-copy
BANDED_TRAIN_STEPS = 2
MM_SHAPES = [(256, 256, 256, "float32"), (512, 512, 512, "float32"),
             (4096, 4096, 4096, "float32"), (257, 129, 65, "float32"),
             (512, 512, 512, "bfloat16"), (4096, 4096, 4096, "bfloat16")]
# Kernel 2 a training step as first written on CUDA cores (PERF.md §6),
# and half of it.
BWD_STEP_MS_BEFORE = 36.876
BWD_STEP_MS_HALF = 18.4
BATCH = 4
BUCKETS = "256,512"
SCRIPT_SECONDS = 900        # the whole script's budget (printed, not gated)
K, B = 3, 2.0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def time_ms(fn, *, reps: int, iters: int) -> float:
    """Median over ``reps`` of the mean time of ``iters`` calls (CUDA
    events), after two warm-up calls."""
    import torch
    fn()
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def fwd_instance(lib, src, wt, *, n, ho, wo, c, m, s, d, b, th, tw, tc,
                 tm) -> dict:
    """The fp32 forward's instance at one call (kernels 1a and 4): pixel
    lanes, output and M tiles, C groups, staging and blocks an SM."""
    from repro_torch.kernels.deform_conv_fused import fwd_plan, staging_vec
    inst = fwd_plan(n, ho, wo, c, m, tile_h=th, tile_w=tw, tile_c=tc,
                    tile_m=tm)
    vec = staging_vec(src, wt, tc, tm)
    inst["loads"] = ("W 16-byte" if vec & 1 else "W element-wise") \
        + band_loads(vec, src.element_size())
    inst["blocks_per_sm"] = lib.dcf_blocks_per_sm(
        K, s, d, math.ceil(b), th, tw, tc, src.element_size())
    return inst


def band_loads(vec: int, size: int) -> str:
    """The band staging that a ``staging_vec`` of kernels 1a, 4 or 2
    names, for elements of ``size`` bytes."""
    from repro_torch.kernels._staging import band_channels
    unit = band_channels(vec)
    return f", band {unit * size}-byte" if unit > 1 \
        else ", band element-wise"


# A ``core.h100`` work's seconds and the keys (ms) of this script's
# records: the bound, each unit's bound of a split-fp32 kernel (1a, 4,
# 2), the int8 kernels' three floors, the operations' time.
BOUND_KEYS = {"bound_s": "bound_ms", "bound_fp32_s": "bound_fp32_ms",
              "bound_3xtf32_s": "bound_3xtf32_ms", "int8_s": "bound_int8_ms",
              "byte_s": "bound_bytes_ms", "sample_s": "sample_bound_ms",
              "op_s": "op_ms"}


def bound_fields(work: dict) -> dict:
    """A record's bounds (ms), ``bound_by``, ``flops``, ``bytes`` (and
    ``samples``) from one ``core.h100`` work, kept under ``work`` for
    ``h100.total``."""
    out = {ms: work[s] * 1e3 for s, ms in BOUND_KEYS.items() if s in work}
    out.update(bound_by=work["bound_by"], flops=work["ops"],
               bytes=work["bytes"], work=work)
    if "samples" in work:
        out["samples"] = work["samples"]
    return out


def same_bytes(work: dict, tensors, what: str) -> None:
    """Fails unless a ``core.h100`` work counts the bytes of the tensors a
    kernel call reads and writes (kernel 4: the materialised bands)."""
    held = sum(t.numel() * t.element_size() for t in tensors)
    if work["bytes"] != held:
        fail(f"{what}: core.h100 counts {work['bytes']} bytes, the "
             f"kernel's tensors hold {held}")


def fwd_case_line(rec: dict, ok: bool) -> str:
    i = rec["instance"]
    return (f"  {rec['label']:<28} n={rec['n']} tiles "
            f"{rec['tiles'][0]}x{rec['tiles'][1]} tc={rec['tiles'][2]} "
            f"tm={rec['tiles'][3]} smem={rec['smem_bytes']} err="
            f"{rec['max_abs_err']:.3e} (max|plain|={rec['max_abs_plain']:.3f})"
            f" kernel={rec['ms']:.4f} ms plain={rec['plain_ms']:.3f} ms "
            f"prep={rec['prep_ms']:.4f} ms bound fp32="
            f"{rec['bound_fp32_ms']:.4f} ms ({rec['bound_fp32_ms'] / rec['ms']:.1%})"
            f" 3xTF32={rec['bound_3xtf32_ms']:.4f} ms "
            f"({rec['bound_3xtf32_ms'] / rec['ms']:.1%}) "
            f"per_step={rec.get('per_step', {})} {'ok' if ok else 'FAIL'}\n"
            f"    instance: {i['lanes']} pixel lanes, {i['tiles']} tiles x "
            f"{i['m_tiles']} M tiles x {i['c_groups']} C groups, "
            f"{i['loads']}, {i['blocks_per_sm']} blocks an SM; two calls "
            f"torch.equal: {rec['repeatable']}")


def check_kernel(case: dict, gen) -> dict:
    """Kernel vs plain on one geometry; returns the record."""
    import torch

    from repro_torch.core.tiling import out_hw, smem_bytes
    from repro_torch.kernels import _build, plan
    from repro_torch.kernels.deform_conv_fused import (
        deform_conv_fused_zerocopy, deform_conv_fused_zerocopy_plain)

    n, h, w, c, m = case["n"], case["h"], case["w"], case["c"], case["m"]
    s, d = case["stride"], case["dilation"]
    ho, wo = out_hw(h, w, kernel_size=K, stride=s, dilation=d)
    th, tw, tc, tm = plan.resolve_tiles(n, h, w, c, m, kernel_size=K,
                                        stride=s, dilation=d,
                                        offset_bound=B)
    th, tw = min(th, ho), min(tw, wo)
    x = torch.randn(n, h, w, c, device="cuda", generator=gen)
    off = torch.randn(n, ho, wo, 2 * K * K, device="cuda",
                      generator=gen) * 1.5
    wd = torch.randn(K * K, c, m, device="cuda", generator=gen) \
        / (K * K * c) ** 0.5
    spec = plan.DCSpec(K, s, d, B, th, tw, tc, tm)
    xp, offp, wt = plan.zerocopy_inputs(spec, x, off, wd, th, tw, tc)
    kw = dict(kernel_size=K, stride=s, dilation=d, offset_bound=B,
              tile_h=th, tile_w=tw, tile_c=tc, tile_m=tm)
    y = deform_conv_fused_zerocopy(xp, offp, wt, **kw)
    torch.cuda.synchronize()
    repeatable = torch.equal(y, deform_conv_fused_zerocopy(xp, offp, wt,
                                                           **kw))
    yp = deform_conv_fused_zerocopy_plain(xp, offp, wt, **kw)
    err = (y - yp).abs().max().item()
    scale = yp.abs().max().item()
    lib = _build.load("deform_conv_fused")
    smem_c = lib.dcf_smem_bytes(K, s, d, 2, th, tw, tc, 4)
    inst = fwd_instance(lib, xp, wt, n=n, ho=ho, wo=wo, c=c, m=m, s=s, d=d,
                        b=B, th=th, tw=tw, tc=tc, tm=tm)
    smem_py = smem_bytes(th, tw, tc, kernel_size=K, stride=s, dilation=d,
                         offset_bound=B)
    ms = time_ms(lambda: deform_conv_fused_zerocopy(xp, offp, wt, **kw),
                 reps=7, iters=10)
    plain_ms = time_ms(
        lambda: deform_conv_fused_zerocopy_plain(xp, offp, wt, **kw),
        reps=3, iters=3)
    prep_ms = time_ms(lambda: plan.zerocopy_inputs(spec, x, off, wd,
                                                   th, tw, tc),
                      reps=5, iters=10)
    work = h100.forward_work(n, h, w, c, m, kernel_size=K, stride=s,
                             dilation=d)
    rec = dict(case, ho=ho, wo=wo, tiles=[th, tw, tc, tm],
               smem_bytes=smem_c, instance=inst, repeatable=repeatable,
               max_abs_err=err, max_abs_plain=scale,
               clamped_share=(off.abs() > B).float().mean().item(),
               ms=ms, plain_ms=plain_ms, prep_ms=prep_ms,
               **bound_fields(work))
    ok = err <= KERNEL_RTOL * scale and smem_c == smem_py and repeatable
    print(fwd_case_line(rec, ok))
    if smem_c != smem_py:
        fail(f"{case['label']}: shared memory {smem_c} (kernel) != "
             f"{smem_py} (chooser)")
    if err > KERNEL_RTOL * scale:
        fail(f"{case['label']}: max|kernel - plain| = {err} exceeds "
             f"{KERNEL_RTOL} * {scale}")
    if not repeatable:
        fail(f"{case['label']}: two calls of the kernel differ")
    return rec


def perturb_offsets(params, seed: int):
    """Seeded offset-conv weights and biases for every DCL, scaled so the
    offsets are a few pixels and a share of them exceeds ±B."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    for block in params.values():
        if "dcl" not in block:
            continue
        dcl = block["dcl"]
        c = dcl["w_offset"].shape[2]
        std = 1.0 / (K * K * c * 0.5) ** 0.5
        dcl["w_offset"] = (torch.randn(dcl["w_offset"].shape, generator=gen)
                           * std).to(dcl["w_offset"].device)
        dcl["b_offset"] = (torch.randn(dcl["b_offset"].shape, generator=gen)
                           * 0.5).to(dcl["b_offset"].device)
    return params


def serve(record: dict) -> tuple[int, dict]:
    import numpy as np
    import torch

    from repro_torch.configs.resnet50_dcn import CONFIG_BOUNDED
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch
    from repro_torch.models import resnet_dcn as R

    cfg = dataclasses.replace(CONFIG_BOUNDED, use_kernel=True)
    print(f"  config {cfg.name}: stages {cfg.stage_sizes}, widths "
          f"{cfg.widths}, {cfg.num_dcn} DCLs, B={cfg.offset_bound}, "
          f"{cfg.num_classes} classes")
    params = perturb_offsets(R.init_params(cfg, seed=0, device="cuda"), 1)
    args = serve_args(cfg, "fp32_kernel")
    launch.serve_detection(cfg, args, params=params)        # warm-up

    reset_counts()
    engine, images, seconds = launch.serve_detection(cfg, args,
                                                     params=params)
    counts = read_counts()
    launches = counts["deform_conv_fused"]
    if any(n for name, n in counts.items() if name != "deform_conv_fused"):
        fail(f"the fp32_kernel run launched another kernel: {counts}")
    print(launch.report(engine, seconds))
    reqs = engine.completed
    n_dcl = sum(cfg.is_dcn(i) for i in range(cfg.total_blocks))
    bad = [r for r in reqs if r.outcome != "ok" or r.ladder != "fp32_kernel"
           or r.degraded]
    if len(reqs) != 8 or bad:
        fail(f"requests not all ok on fp32_kernel: "
             f"{[(r.uid, r.outcome, r.ladder, r.degraded, r.error) for r in reqs]}")
    if launches != n_dcl * engine.steps or launches == 0:
        fail(f"kernel launched {launches} times in {engine.steps} steps; "
             f"expected {n_dcl} per step")
    print(f"  kernel launches in the served run: {launches} = {n_dcl} x "
          f"{engine.steps} steps")

    # Plain path on the card, same batches; clamp share from the kernel
    # path's offsets (these launches are not counted).
    ref_cfg = dataclasses.replace(cfg, use_kernel=False)
    worst = 0.0
    clamped = []
    real_deform_conv = ops.deform_conv

    def recording_deform_conv(x, offsets, w, **kw):
        clamped.append((offsets.abs() > B).float().mean().item())
        return real_deform_conv(x, offsets, w, **kw)

    for bucket in sorted({r.bucket for r in reqs}):
        rows = [r for r in reqs if r.bucket == bucket]
        x = engine.batch_array(bucket, rows)
        with torch.no_grad():
            ref, _ = R.forward(params, ref_cfg, x, device="cuda")
            ops.deform_conv = recording_deform_conv
            try:
                R.forward(params, cfg, x, device="cuda")
            finally:
                ops.deform_conv = real_deform_conv
        for key in ("cls", "box"):
            r_np = ref[key].cpu().numpy()
            got = np.stack([r.result[key] for r in rows])
            err = float(np.abs(got - r_np[:len(rows)]).max())
            scale = float(np.abs(r_np).max())
            rel = err / scale
            worst = max(worst, rel)
            print(f"  bucket {bucket} {key}: max|kernel path - plain path| "
                  f"= {err:.3e} (max|ref|={scale:.3f}, rel {rel:.2e})")
            if not np.isfinite(got).all() or err > SERVE_RTOL * scale:
                fail(f"bucket {bucket} {key} off the plain path: {err} > "
                     f"{SERVE_RTOL} * {scale}")
    # Where a step's time goes: each bucket's forward on the kernel path
    # and on the plain path (CUDA events), beside the DCL kernels' own
    # time from phase 3.
    fwd_ms: dict[str, dict[str, float]] = {}
    for bucket in sorted({r.bucket for r in reqs}):
        xb = engine.batch_array(bucket, [r for r in reqs
                                         if r.bucket == bucket])
        with torch.no_grad():
            fwd_ms[str(bucket)] = {
                name: time_ms(lambda c=c: R.forward(params, c, xb,
                                                    device="cuda"),
                              reps=5, iters=2)
                for name, c in (("kernel_path", cfg),
                                ("plain_path", ref_cfg))}
        print(f"  {bucket}-bucket forward, batch {BATCH}: kernel path "
              f"{fwd_ms[str(bucket)]['kernel_path']:.3f} ms, plain path "
              f"{fwd_ms[str(bucket)]['plain_path']:.3f} ms")
    steps_per_bucket = engine.telemetry()["steps_per_bucket"]
    device_ms = sum(fwd_ms[b]["kernel_path"] * n
                    for b, n in steps_per_bucket.items())
    lats = sorted(r.latency_s() for r in reqs)
    share = statistics.mean(clamped)
    if share <= 0.0:
        fail("no offset exceeded ±B: the serve run tests no clamp")
    record["serve"] = dict(
        requests=len(reqs), steps=engine.steps, launches=launches,
        steps_per_bucket=steps_per_bucket, seconds=seconds,
        images_per_s=len(reqs) / seconds,
        p50_latency_ms=lats[len(lats) // 2] * 1e3,
        max_latency_ms=lats[-1] * 1e3, clamped_share=share,
        worst_rel_err=worst, cls_shape=list(reqs[0].result["cls"].shape),
        forward_ms=fwd_ms, forward_ms_in_run=device_ms)
    print(f"  clamped offsets {share:.3f}; smoke readings of {len(reqs)} "
          f"requests in {engine.steps} steps (not a serving benchmark): "
          f"wall {seconds * 1e3:.2f} ms, of which the steps' forwards "
          f"{device_ms:.2f} ms (CUDA events), p50 latency "
          f"{record['serve']['p50_latency_ms']:.2f} ms, "
          f"{record['serve']['images_per_s']:.2f} images/s")
    return launches, record, params, reqs


def serve_args(cfg, rung: str):
    from repro_torch.launch import serve as launch
    return launch.build_parser().parse_args(
        ["--arch", cfg.name, "--buckets", BUCKETS, "--requests", "8",
         "--slots", str(BATCH), "--device", "cuda", "--seed", "0",
         "--quant", rung])


def counted():
    from repro_torch.kernels import deform_conv_fused as F
    from repro_torch.kernels import deform_conv_q as Q
    from repro_torch.kernels import deform_sample as S
    from repro_torch.kernels.deform_conv_bwd import deform_conv_bwd_zerocopy
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bh)
    from repro_torch.kernels.matmul import matmul
    return {"deform_conv_fused": F.deform_conv_fused_zerocopy,
            "deform_conv_fused_q": Q.deform_conv_fused_zerocopy_q,
            "deform_conv_chain": Q.deform_conv_fused_zerocopy_chain,
            "deform_conv_bwd": deform_conv_bwd_zerocopy,
            "deform_sample_zerocopy": S.deform_sample_zerocopy,
            "deform_sample_banded": S.deform_sample_banded,
            "deform_conv_banded": F.deform_conv_fused_banded,
            "matmul": matmul,
            "flash_attention": flash_attention,
            "flash_attention_bh": flash_attention_bh}


def counted_bf16():
    """The wrappers with a bf16 instance, whose ``launches_bf16`` counts
    its launches (``launches`` counts both instances)."""
    from repro_torch.kernels import deform_conv_fused as F
    from repro_torch.kernels.deform_conv_bwd import deform_conv_bwd_zerocopy
    return {"deform_conv_fused_bf16": F.deform_conv_fused_zerocopy,
            "deform_conv_banded_bf16": F.deform_conv_fused_banded,
            "deform_conv_bwd_bf16": deform_conv_bwd_zerocopy}


def reset_counts() -> None:
    for fn in counted().values():
        fn.launches = 0
    for fn in counted_bf16().values():
        fn.launches_bf16 = 0


def read_bf16_counts() -> dict[str, int]:
    """Launches of each bf16 instance, and of the fp32 forward instances
    (``fp32_forward``: kernels 1a and 4 together)."""
    fns = counted_bf16()
    out = {name: fn.launches_bf16 for name, fn in fns.items()}
    out["fp32_forward"] = sum(
        fns[k].launches - fns[k].launches_bf16
        for k in ("deform_conv_fused_bf16", "deform_conv_banded_bf16"))
    return out


def read_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in counted().items()}


class plain_kernels:
    """Within the block the int8 plans call the plain versions in place of
    the int8 kernels (the same rung's plain path)."""

    def __enter__(self):
        from repro_torch.kernels import deform_conv_q as Q
        from repro_torch.kernels import plan
        self.saved = (plan.deform_conv_fused_zerocopy_q,
                      plan.deform_conv_fused_zerocopy_chain)
        plan.deform_conv_fused_zerocopy_q = \
            Q.deform_conv_fused_zerocopy_q_plain
        plan.deform_conv_fused_zerocopy_chain = \
            Q.deform_conv_fused_zerocopy_chain_plain

    def __exit__(self, *exc):
        from repro_torch.kernels import plan
        (plan.deform_conv_fused_zerocopy_q,
         plan.deform_conv_fused_zerocopy_chain) = self.saved


def device_events(fn) -> list[tuple[str, float]]:
    """torch.profiler over one call of ``fn`` (after one warm-up): each
    device-side event (kernels, copies, sets) with its device time (ms),
    longest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    # Device-side events only: the host ops that launched them carry the
    # same time again.
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=dev_us, reverse=True)
    return [(e.key, dev_us(e) / 1e3) for e in events]


def device_profile(fn, top: int = 6) -> tuple[float | None, list]:
    """``device_events`` summed (ms; None when the profiler saw none), and
    the ``top`` entries by device time."""
    events = device_events(fn)
    total = sum(ms for _, ms in events)
    return (total or None), [(k[:60], round(ms, 4)) for k, ms in events[:top]]


def kernel_share(events: list[tuple[str, float]],
                 tag: str) -> tuple[float, float]:
    """The device time among ``events`` of the launches whose names hold
    ``tag`` (``dcb_``: kernel 2's d_input, d_weights and two reduction
    kernels; ``dcf_``: the fp32 forward, kernel 1a or 4, and its
    reduction) and its share of their total."""
    k = sum(ms for name, ms in events if tag in name)
    total = sum(ms for _, ms in events)
    return k, (k / total if total else float("nan"))


def mma_s8_check(gen) -> None:
    """The s8 tensor-core product (``mma_s8`` with the int8 kernels'
    ldmatrix fragment loads) against a plain int matmul, before any kernel
    that uses it is trusted."""
    import torch

    from repro_torch.kernels import deform_conv_q as Q
    lib = Q.load_kernel()
    for trial in range(4):
        a = torch.randint(-128, 128, (16, 32), dtype=torch.int8,
                          device="cuda", generator=gen)
        b = torch.randint(-128, 128, (16, 32), dtype=torch.int8,
                          device="cuda", generator=gen)
        if trial == 0:          # the extremes, where a byte-order slip shows
            a[0], b[0] = -128, 127
        d = torch.empty(16, 16, dtype=torch.int32, device="cuda")
        err = lib.dcq_mma_s8_check(a.data_ptr(), b.data_ptr(), d.data_ptr())
        want = (a.cpu().long() @ b.cpu().long().T).int()
        if err or not torch.equal(d.cpu(), want):
            fail(f"mma_s8 (16x32 . 32x16, trial {trial}) != int matmul "
                 f"(error {err})")
    print("  mma_s8 m16n8k32 with ldmatrix fragments == int matmul "
          "(4 trials, the extremes included)")


def check_q_kernel(case: dict, gen) -> dict:
    """An int8 kernel vs its plain version on one geometry (``torch.equal``
    or fail); returns the record."""
    import torch

    from repro_torch.core.deform_conv import conv2d
    from repro_torch.core.tiling import out_hw, q_smem_bytes
    from repro_torch.kernels import deform_conv_q as Q
    from repro_torch.kernels import plan
    from repro_torch.quant.qtypes import compute_scale, quantize_values

    kind, emit = case["kind"], case.get("emit", "int8")
    chain = kind == "dcc"
    n, h, w, c, m = case["n"], case["h"], case["w"], case["c"], case["m"]
    s, d, b = case["stride"], case["dilation"], case.get("bound", B)
    k2 = K * K
    ho, wo = out_hw(h, w, kernel_size=K, stride=s, dilation=d)
    th, tw, tc, tm = plan.resolve_tiles(
        n, h, w, c, m, kernel_size=K, stride=s, dilation=d,
        offset_bound=b, tile_c=case.get("tile_c"),
        dtype="int8_chain" if chain else "int8")
    th, tw = min(th, ho), min(tw, wo)
    x = torch.randn(n, h, w, c, device="cuda", generator=gen)
    wd = torch.randn(k2, c, m, device="cuda", generator=gen) / (k2 * c) ** 0.5
    sx, sw = compute_scale(x), compute_scale(wd, axis=-1)
    xq, wq = quantize_values(x, sx), quantize_values(wd, sw)
    xp = plan.pad_zerocopy(xq, kernel_size=K, stride=s, dilation=d,
                           offset_bound=b, tile_h=th, tile_w=tw, ho=ho,
                           wo=wo)
    kw = dict(kernel_size=K, stride=s, dilation=d, offset_bound=b,
              tile_h=th, tile_w=tw, tile_c=tc, tile_m=tm)
    lib = Q.load_kernel()
    if chain:
        woff = torch.randn(k2, c, 2 * k2, device="cuda", generator=gen)
        woq = quantize_values(woff, compute_scale(woff, axis=-1))
        # Offset-conv sums of std ~1.5 px once dequantized, so a share of
        # the taps clamps; read back through an exact float64 conv.
        acc = conv2d(xq.double(), woq.double().reshape(K, K, c, 2 * k2),
                     stride=s, dilation=d)
        off_scale = torch.full((2 * k2,), 1.5 / acc.std().item(),
                               device="cuda")
        off_bias = torch.randn(2 * k2, device="cuda", generator=gen) * 0.5
        off = acc.float() * off_scale + off_bias
        # Emission of std ~40 on the int8 grid (rounds and clips).
        y_std = (k2 * c) ** 0.5 * 0.8 * xq.float().std() * wq.float().std()
        out_scale = torch.full((m,), 40.0 / y_std.item(), device="cuda")
        out_bias = torch.randn(m, device="cuda", generator=gen)
        args = (xp, plan.tile_weights(wq, c), plan.tile_weights(woq, c),
                off_scale, off_bias, out_scale, out_bias)
        kw.update(emit=emit, ho=ho, wo=wo)
        fn, plain = (Q.deform_conv_fused_zerocopy_chain,
                     Q.deform_conv_fused_zerocopy_chain_plain)
    else:
        off = torch.randn(n, ho, wo, 2 * k2, device="cuda",
                          generator=gen) * 1.5
        args = (xp, off, plan.tile_weights(wq, tc),
                (sx * sw).reshape(m).contiguous())
        fn, plain = (Q.deform_conv_fused_zerocopy_q,
                     Q.deform_conv_fused_zerocopy_q_plain)
    smem_c = lib.dcq_smem_bytes(K, s, d, math.ceil(b), th, tw, tc)
    smem_py = q_smem_bytes(th, tw, tc, kernel_size=K, stride=s, dilation=d,
                           offset_bound=b)
    inst = Q.q_plan(n, ho, wo, c, m, tile_h=th, tile_w=tw, tile_c=tc,
                    tile_m=tm)
    inst["staging"] = "16-byte" if Q.staging_vec(xp, tc) else "4-byte"
    inst["blocks_per_sm"] = lib.dcq_blocks_per_sm(K, s, d, math.ceil(b),
                                                  th, tw, tc)
    y = fn(*args, **kw)
    torch.cuda.synchronize()
    repeat = torch.equal(y, fn(*args, **kw))
    yp = plain(*args, **kw)
    equal = torch.equal(y, yp) and repeat
    err = (y.float() - yp.float()).abs().max().item()
    if case.get("verbatim"):
        # ops.deform_conv_chain: an int8 input on the x_scale grid is taken
        # as it is and gives the fp32 head's emission.
        from repro_torch.kernels import ops
        ck = dict(kernel_size=K, stride=s, dilation=d, offset_bound=b,
                  x_scale=sx, w_scale=sw.reshape(m), y_scale=0.5 * sx,
                  emit="int8", device="cuda")
        woff_f = woq.float()
        head = ops.deform_conv_chain(x, wd, woff_f, off_bias, out_bias, **ck)
        verbatim = ops.deform_conv_chain(xq, wd, woff_f, off_bias,
                                         out_bias, **ck)
        with plain_kernels():
            want = ops.deform_conv_chain(xq, wd, woff_f, off_bias,
                                         out_bias, **ck)
        equal = equal and torch.equal(head, verbatim) \
            and torch.equal(verbatim, want)
    # Time a call back to back (CUDA events, as every kernel row); queued
    # behind a busy device as well, which hides the host's launch path,
    # and each launch's device time by torch.profiler.
    ms = time_ms(lambda: fn(*args, **kw), reps=7, iters=10)
    queued = statistics.median(queued_ms(lambda: fn(*args, **kw))
                               for _ in range(5))
    parts = kernel_device_ms(lambda: fn(*args, **kw), Q_KERNEL_NAMES)
    launches = sum(ct for ct, _ in parts.values())
    plain_ms = time_ms(lambda: plain(*args, **kw), reps=3, iters=2)
    bounds = bound_fields(h100.int8_work(n, h, w, c, m, kernel_size=K,
                                         stride=s, dilation=d, chain=chain,
                                         emit=emit))
    rec = dict(case, ho=ho, wo=wo, tiles=[th, tw, tc, tm], smem_bytes=smem_c,
               instance=inst, equal=equal, repeatable=repeat,
               max_abs_err=err, max_abs_plain=yp.float().abs().max().item(),
               clamped_share=(off.abs() > b).float().mean().item(),
               ms=ms, queued_ms=queued, plain_ms=plain_ms,
               launches_per_call=launches, parts_ms=parts, **bounds)
    ok = equal and smem_c == smem_py
    print(f"  {kind} {case['label']:<28} tiles {th}x{tw} tc={tc} tm={tm} "
          f"smem={smem_c} equal={equal} err={err:.1e} "
          f"clamped={rec['clamped_share']:.3f} kernel={ms:.4f} ms (queued "
          f"{queued:.4f}) plain={plain_ms:.3f} ms bound="
          f"{bounds['bound_ms']:.5f} ms ({bounds['bound_ms'] / ms:.1%}; int8 "
          f"{bounds['bound_int8_ms']:.5f}, bytes {bounds['bound_bytes_ms']:.5f},"
          f" sample_bound_ms {bounds['sample_bound_ms']:.5f}) "
          f"per_step={case.get('per_step', {})} {'ok' if ok else 'FAIL'}\n"
          f"    instance: {inst['lanes']} pixel lanes, tile_m {tm}, "
          f"{inst['tiles']} tiles x {inst['m_tiles']} M tiles x "
          f"{inst['c_groups']} C groups"
          + (f" (offset conv: {inst['off_groups']})" if chain else "")
          + f", {inst['staging']} staging, "
          f"{inst['blocks_per_sm']} blocks an SM; {launches:g} device "
          f"launches a call: "
          f"{[(nm, ct, round(t, 5)) for nm, (ct, t) in parts.items()]}; two "
          f"calls torch.equal: {repeat}")
    if smem_c != smem_py:
        fail(f"{kind} {case['label']}: shared memory {smem_c} (kernel) != "
             f"{smem_py} (chooser)")
    if not equal:
        fail(f"{kind} {case['label']}: kernel != plain version "
             f"(max abs difference {err}; two calls equal: {repeat})")
    return rec


def serve_int8(record: dict, params) -> dict[str, int]:
    """Phase 6: calibrate on the card, serve on int8_chain and on int8."""
    import numpy as np
    import torch

    from repro_torch.configs.resnet50_dcn import CONFIG_BOUNDED
    from repro_torch.launch import serve as launch
    from repro_torch.models import resnet_dcn as R
    from repro_torch.quant.calibrate import scale_table_on

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg = dataclasses.replace(CONFIG_BOUNDED, use_kernel=True)
    n_dcl = sum(cfg.is_dcn(i) for i in range(cfg.total_blocks))
    t0 = time.monotonic()
    table = launch.calibrate(cfg, params, serve_args(cfg, "int8_chain"))
    print(f"  calibrated {len(table) - 1} DCLs on the card in "
          f"{time.monotonic() - t0:.1f} s (absmax, 2 images per bucket)")
    scales = scale_table_on(table, "cuda")      # as the engine holds them
    own = {"int8_chain": "deform_conv_chain", "int8": "deform_conv_fused_q"}
    launches = {}
    batches = {}
    record["serve_int8"] = {}
    fwd_cfgs = {rung: dataclasses.replace(cfg, quant=q)
                for rung, q in (("int8_chain", "int8_chain"),
                                ("int8", "int8"), ("fp32_kernel", "none"))}
    for rung in ("int8_chain", "int8"):
        args = serve_args(cfg, rung)
        launch.serve_detection(cfg, args, params=params,
                               scale_table=table)                # warm-up
        reset_counts()
        engine, _, seconds = launch.serve_detection(
            cfg, args, params=params, scale_table=table)
        counts = read_counts()
        print(launch.report(engine, seconds))
        reqs = engine.completed
        bad = [r for r in reqs if r.outcome != "ok" or r.ladder != rung
               or r.degraded]
        if len(reqs) != 8 or bad:
            fail(f"requests not all ok on {rung}: "
                 f"{[(r.uid, r.outcome, r.ladder, r.error) for r in reqs]}")
        want = {name: (n_dcl * engine.steps if name == own[rung] else 0)
                for name in counts}
        if counts != want or counts[own[rung]] == 0:
            fail(f"{rung}: launches {counts} in {engine.steps} steps; "
                 f"expected {want}")
        print(f"  launches in the {rung} run: {counts} ({n_dcl} x "
              f"{engine.steps} steps of {own[rung]})")
        launches[own[rung]] = counts[own[rung]]
        worst = 0.0
        rel_fp32 = []
        rel_ref = []
        rel_noise = []
        for bucket in sorted({r.bucket for r in reqs}):
            rows = [r for r in reqs if r.bucket == bucket]
            x = engine.batch_array(bucket, rows)
            with torch.no_grad():
                with plain_kernels():
                    plain, _ = R.forward(params, fwd_cfgs[rung], x,
                                         quant_scales=scales, device="cuda")
                fp32, _ = R.forward(params, fwd_cfgs["fp32_kernel"], x,
                                    device="cuda")
                ref, _ = R.forward(
                    params, dataclasses.replace(fwd_cfgs[rung],
                                                use_kernel=False),
                    x, quant_scales=scales, device="cuda")
                # How far fp32 itself moves under a 1e-3 relative input
                # perturbation: the model's own sensitivity, for scale.
                noise = torch.randn(x.shape, generator=torch.Generator(
                    device="cuda").manual_seed(5), device="cuda")
                fp32_noisy, _ = R.forward(params, fwd_cfgs["fp32_kernel"],
                                          x * (1 + 1e-3 * noise),
                                          device="cuda")
            for key in ("cls", "box"):
                p_np = plain[key].cpu().numpy()[:len(rows)]
                got = np.stack([r.result[key] for r in rows])
                err = float(np.abs(got - p_np).max())
                scale = float(np.abs(p_np).max())
                worst = max(worst, err / scale)
                print(f"  {rung} bucket {bucket} {key}: max|kernel path - "
                      f"plain path| = {err:.3e} (max|ref|={scale:.3f})")
                if not np.isfinite(got).all() or err > SERVE_RTOL * scale:
                    fail(f"{rung} bucket {bucket} {key} off the plain path: "
                         f"{err} > {SERVE_RTOL} * {scale}")
            got = np.stack([r.result["cls"] for r in rows])
            for into, other, base in ((rel_fp32, fp32, got),
                                      (rel_ref, ref, got),
                                      (rel_noise, fp32, fp32_noisy)):
                o = other["cls"].cpu().numpy()[:len(rows)]
                if not isinstance(base, np.ndarray):
                    base = base["cls"].cpu().numpy()[:len(rows)]
                into.append(float(np.linalg.norm(base - o)
                                  / np.linalg.norm(o)))
            print(f"  {rung} bucket {bucket} cls: relative error vs "
                  f"fp32_kernel {rel_fp32[-1]:.4f}, vs the fake-quant "
                  f"reference path {rel_ref[-1]:.2e}; fp32_kernel under a "
                  f"1e-3 input perturbation moves {rel_noise[-1]:.4f}")
            if rel_fp32[-1] > INT8_VS_FP32_MAX:
                fail(f"{rung} bucket {bucket}: cls {rel_fp32[-1]:.4f} from "
                     f"fp32_kernel, above {INT8_VS_FP32_MAX}")
            batches[bucket] = x
        lats = sorted(r.latency_s() for r in reqs)
        record["serve_int8"][rung] = dict(
            requests=len(reqs), steps=engine.steps, launches=counts,
            steps_per_bucket=engine.telemetry()["steps_per_bucket"],
            seconds=seconds, images_per_s=len(reqs) / seconds,
            p50_latency_ms=lats[len(lats) // 2] * 1e3,
            worst_rel_err_vs_plain=worst, cls_rel_err_vs_fp32=rel_fp32,
            cls_rel_err_vs_reference=rel_ref,
            fp32_cls_moves_under_1e3_input_noise=rel_noise)
    # Where a step's time goes: each bucket's forward on the three rungs,
    # timed in turns (CUDA events), and each one's device time from
    # torch.profiler.
    record["forward_ms"] = {}
    for bucket, x in sorted(batches.items()):
        fns = {name: (lambda c=c: R.forward(params, c, x, quant_scales=scales,
                                            device="cuda"))
               for name, c in fwd_cfgs.items()}
        # The same rung reading the JSON table's floats, as a caller who
        # does not put the table on the card would.
        fns["int8_chain_host_scales"] = lambda: R.forward(
            params, fwd_cfgs["int8_chain"], x, quant_scales=table,
            device="cuda")
        row: dict = {}
        with torch.no_grad():
            for name, fn in fns.items():
                row[f"{name}_device_busy"], row[f"{name}_top"] = \
                    device_profile(fn)
            turns: dict[str, list[float]] = {name: [] for name in fns}
            for _ in range(7):
                for name, fn in fns.items():
                    turns[name].append(time_ms(fn, reps=1, iters=3))
        for name in fns:
            row[name] = statistics.median(turns[name])
            row[f"{name}_turns"] = turns[name]
            busy = row[f"{name}_device_busy"]
            share = "not measured" if busy is None \
                else f"{1 - busy / row[name]:.0%}"
            print(f"  {bucket}-bucket forward, batch {BATCH}, {name}: "
                  f"median {row[name]:.3f} ms of 7 turns (min "
                  f"{min(turns[name]):.3f}), device busy "
                  f"{busy if busy is None else round(busy, 3)} ms by "
                  f"torch.profiler, idle {share}; top "
                  f"{row[f'{name}_top'][:4]}")
        record["forward_ms"][str(bucket)] = row
    record["scale_table"] = table
    return launches


def check_bwd_kernel(case: dict, gen) -> dict:
    """The backward kernel vs its plain version on one geometry, and the
    autograd function vs autograd through the plain forward; returns the
    record."""
    import torch

    from repro_torch.core.tiling import (bwd_dw_smem_bytes, bwd_smem_bytes,
                                         out_hw)
    from repro_torch.kernels import ops, plan, ref
    from repro_torch.kernels.deform_conv_bwd import (
        bwd_plan, deform_conv_bwd_zerocopy, deform_conv_bwd_zerocopy_plain,
        load_kernel, staging_vec)
    from repro_torch.kernels.deform_conv_fused import \
        deform_conv_fused_zerocopy_plain

    n, h, w, c, m = case["n"], case["h"], case["w"], case["c"], case["m"]
    s, d, b = case["stride"], case["dilation"], case.get("bound", B)
    k2 = K * K
    ho, wo = out_hw(h, w, kernel_size=K, stride=s, dilation=d)
    th, tw, tc, _ = plan.resolve_tiles(n, h, w, c, m, kernel_size=K,
                                       stride=s, dilation=d, offset_bound=b,
                                       tile_c=case.get("tile_c"),
                                       dtype="fp32_bwd")
    th, tw = min(th, ho), min(tw, wo)
    x = torch.randn(n, h, w, c, device="cuda", generator=gen)
    off = torch.randn(n, ho, wo, 2 * k2, device="cuda", generator=gen) * 1.5
    wd = torch.randn(k2, c, m, device="cuda", generator=gen) / (k2 * c) ** 0.5
    g = torch.randn(n, ho, wo, m, device="cuda", generator=gen)
    spec = plan.DCSpec(K, s, d, b, th, tw, tc, None)
    xp, offp, wt = plan.zerocopy_inputs(spec, x, off, wd, th, tw, tc)
    kw = dict(kernel_size=K, stride=s, dilation=d, offset_bound=b,
              tile_h=th, tile_w=tw, tile_c=tc)
    got = deform_conv_bwd_zerocopy(xp, offp, g, wt, **kw)
    torch.cuda.synchronize()
    want = deform_conv_bwd_zerocopy_plain(xp, offp, g, wt, **kw)
    names = ("dx", "d_off", "dw")
    errs = {nm: (a - r).abs().max().item() for nm, a, r in
            zip(names, got, want)}
    scales = {nm: r.abs().max().item() for nm, r in zip(names, want)}
    # The autograd function on the card (forward and backward kernels)
    # against autograd through two plain forwards, for y . g: the
    # band-local plain forward on the same padded inputs and tiles, whose
    # positions round as the kernels' do (all three gradients gated), and
    # the global-frame reference (d_input and d_weights gated).  An offset
    # within an ulp of an integer can floor to another cell in the global
    # frame, where the bilinear gradient jumps: that d_offsets error is
    # printed beside the share of taps whose floor differs.
    leaves = [t.clone().requires_grad_(True) for t in (x, off, wd)]
    ag = torch.autograd.grad(
        (ops.deform_conv(*leaves, offset_bound=b, stride=s, dilation=d)
         * g).sum(), leaves)
    ap = torch.autograd.grad(
        (ref.deform_conv_fused_ref(*leaves, offset_bound=b, stride=s,
                                   dilation=d) * g).sum(), leaves)
    xl, ol, wl = leaves
    band_local = deform_conv_fused_zerocopy_plain(
        plan.pad_zerocopy(xl, kernel_size=K, stride=s, dilation=d,
                          offset_bound=b, tile_h=th, tile_w=tw, ho=ho,
                          wo=wo), ol, plan.tile_weights(wl, tc),
        kernel_size=K, stride=s, dilation=d, offset_bound=b, tile_h=th,
        tile_w=tw, tile_c=tc)
    al = torch.autograd.grad((band_local * g).sum(), leaves)
    grads = ("d_input", "d_offsets", "d_weights")
    auto = {nm: (a - r).abs().max().item() / r.abs().max().item()
            for nm, a, r in zip(grads, ag, al)}
    auto_global = {nm: (a - r).abs().max().item() / r.abs().max().item()
                   for nm, a, r in zip(grads, ag, ap)}
    floor_share = frame_floor_share(off, ho=ho, wo=wo, s=s, d=d, b=b,
                                    th=th, tw=tw)
    # Kernel 2 is up to four launches (d_input/d_offsets, d_weights, the
    # reductions of the d_offsets and d_weights partials) beside a memset:
    # their device times.
    _, parts = device_profile(
        lambda: deform_conv_bwd_zerocopy(xp, offp, g, wt, **kw))
    lib = load_kernel()
    geom = dict(kernel_size=K, stride=s, dilation=d, offset_bound=b)
    smem_c = (lib.dcb_smem_bytes(K, s, d, math.ceil(b), th, tw, tc, 4),
              lib.dcb_dw_smem_bytes(K, s, d, math.ceil(b), th, tw, tc, 4))
    smem_py = (bwd_smem_bytes(th, tw, tc, **geom),
               bwd_dw_smem_bytes(th, tw, tc, **geom))
    kplan = bwd_plan(n, ho, wo, c, m, kernel_size=K, tile_h=th, tile_w=tw,
                     tile_c=tc)
    vec = staging_vec(xp, g, wt, tc)
    kplan["loads"] = ("W/g 16-byte" if vec & 1 else "W/g element-wise") \
        + band_loads(vec, xp.element_size())
    ms = time_ms(lambda: deform_conv_bwd_zerocopy(xp, offp, g, wt, **kw),
                 reps=5, iters=5)
    plain_ms = time_ms(
        lambda: deform_conv_bwd_zerocopy_plain(xp, offp, g, wt, **kw),
        reps=3, iters=2)
    # dw = P^T g and dP = g W^T
    bounds = bound_fields(h100.backward_work(n, h, w, c, m, kernel_size=K,
                                             stride=s, dilation=d))
    fp32_ms, tf32x3_ms = bounds["bound_fp32_ms"], bounds["bound_3xtf32_ms"]
    rec = dict(case, ho=ho, wo=wo, tiles=[th, tw, tc], smem_bytes=smem_c,
               plan=kplan, max_abs_err=max(errs.values()), errs=errs,
               max_abs_plain=scales, autograd_rel_err=auto,
               autograd_rel_err_global=auto_global,
               floor_differs_share=floor_share, parts_ms=parts,
               clamped_share=(off.abs() > b).float().mean().item(),
               ms=ms, plain_ms=plain_ms, **bounds)
    global_gated = max(auto_global["d_input"], auto_global["d_weights"])
    ok = all(errs[nm] <= BWD_RTOL * scales[nm] for nm in names) \
        and max(auto.values()) <= BWD_RTOL and global_gated <= BWD_RTOL \
        and smem_c == smem_py
    print(f"  {case['label']:<28} tiles {th}x{tw} tc={tc} smem={smem_c} "
          + " ".join(f"{nm}={errs[nm]:.2e}/{scales[nm]:.2f}" for nm in names)
          + f" autograd={max(auto.values()):.1e} (global frame: d_input "
          f"{auto_global['d_input']:.1e}, d_weights "
          f"{auto_global['d_weights']:.1e}, d_offsets "
          f"{auto_global['d_offsets']:.1e}; floors differ at "
          f"{floor_share:.2e} of taps) "
          f"clamped={rec['clamped_share']:.3f} kernel={ms:.4f} ms "
          f"plain={plain_ms:.3f} ms bound fp32={fp32_ms:.4f} ms "
          f"({fp32_ms / ms:.1%}) 3xTF32={tf32x3_ms:.4f} ms "
          f"({tf32x3_ms / ms:.1%}) per_step={case.get('per_step', {})} "
          f"{'ok' if ok else 'FAIL'}")
    print(f"    plan: C groups {kplan['c_groups']} x {kplan['tiles']} tiles, "
          f"d_weights {kplan['dw_cols']} channels a block, grid "
          f"{kplan['dw_grid']} x {kplan['dw_splits']} splits; instance "
          f"{kplan['lanes']} pixel lanes, {kplan['warp_tiles']} mma tiles a "
          f"warp, k-split {kplan['k_split']}, {kplan['loads']}")
    print(f"    launches: "
          f"{[(k.split('::')[-1].split('(')[0], v) for k, v in parts[:5]]}")
    if smem_c != smem_py:
        fail(f"backward {case['label']}: shared memory {smem_c} (kernel: "
             f"d_input, d_weights) != {smem_py} (chooser)")
    for nm in names:
        if errs[nm] > BWD_RTOL * scales[nm]:
            fail(f"backward {case['label']} {nm}: max|kernel - plain| = "
                 f"{errs[nm]} exceeds {BWD_RTOL} * {scales[nm]}")
    if max(auto.values()) > BWD_RTOL:
        fail(f"backward {case['label']}: autograd through the kernels is "
             f"{auto} from autograd through the band-local plain forward")
    if global_gated > BWD_RTOL:
        fail(f"backward {case['label']}: autograd through the kernels is "
             f"{auto_global} from autograd through the global-frame "
             f"reference (d_input and d_weights gated)")
    return rec


def frame_floor_share(off, *, ho: int, wo: int, s: int, d: int, b: float,
                      th: int, tw: int) -> float:
    """Share of the taps whose position floors to another cell in the
    global frame (``ref``: ``oy*s - pad + ky*d + o``) than in the
    band-local one (the kernels: ``t*s + hb + ky*d + o`` in the band of
    tile ``oy // th``), both in fp32 on the clamped offsets."""
    import torch
    k2 = K * K
    pad, hb = d * (K // 2), math.ceil(b)
    o = off.clamp(-b, b).reshape(*off.shape[:3], k2, 2)
    dev = off.device
    kk = torch.arange(k2, device=dev)
    differs = torch.zeros(o.shape[:4], dtype=torch.bool, device=dev)
    for axis, (extent, tile, tap) in enumerate(
            ((ho, th, (kk // K) * d), (wo, tw, (kk % K) * d))):
        q = torch.arange(extent, device=dev)
        glob = (q * s - pad)[:, None] + tap
        local = ((q % tile) * s + hb)[:, None] + tap
        shift = (pad + hb - (q // tile) * tile * s)[:, None]
        if axis == 0:
            glob, local, shift = (t[:, None, :] for t in (glob, local, shift))
        else:
            glob, local, shift = (t[None, :, :] for t in (glob, local, shift))
        fg = torch.floor(glob.float() + o[..., axis])
        fl = torch.floor(local.float() + o[..., axis])
        differs |= (fg + shift) != fl
    return differs.float().mean().item()


class plain_training_kernels:
    """Within the block the fp32 plan calls the plain versions of the
    forward kernel (``fwd``) and/or the backward kernel (``bwd``), and
    ``ops.deform_conv`` takes ``tile_c`` when one is given (another fp32
    summation order of the same function)."""

    def __init__(self, *, fwd: bool, bwd: bool, tile_c: int | None = None):
        self.fwd, self.bwd, self.tile_c = fwd, bwd, tile_c

    def __enter__(self):
        from repro_torch.kernels import deform_conv_bwd, deform_conv_fused
        from repro_torch.kernels import ops, plan
        self.saved = (plan.deform_conv_fused_zerocopy,
                      plan.deform_conv_bwd_zerocopy, ops.deform_conv)
        if self.fwd:
            plan.deform_conv_fused_zerocopy = \
                deform_conv_fused.deform_conv_fused_zerocopy_plain
        if self.bwd:
            plan.deform_conv_bwd_zerocopy = \
                deform_conv_bwd.deform_conv_bwd_zerocopy_plain
        if self.tile_c is not None:
            real, tc = ops.deform_conv, self.tile_c
            ops.deform_conv = lambda *a, **kw: real(*a, **dict(kw, tile_c=tc))

    def __exit__(self, *exc):
        from repro_torch.kernels import ops, plan
        (plan.deform_conv_fused_zerocopy, plan.deform_conv_bwd_zerocopy,
         ops.deform_conv) = self.saved


def train(record: dict) -> tuple[int, dict]:
    """Phase 8: train full-width resnet50_dcn_bounded on the card.
    Returns the backward kernel's launches in the 6-step run, step 0
    (loss of the kernel path, gradients of both paths, the gate of the
    kernel path against the plain path) for phase 11, and the trained
    params (saved in ``build/smoke_train/full``) for phase 15."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.configs.resnet50_dcn import CONFIG_BOUNDED
    from repro_torch.data import DetectionDataConfig, detection_batch
    from repro_torch.launch import train as launch
    from repro_torch.models import resnet_dcn as R
    from repro_torch.tree import leaves, tree_map

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg = CONFIG_BOUNDED
    ckpt = ROOT / "build" / "smoke_train"
    shutil.rmtree(ckpt, ignore_errors=True)

    def args(steps: int, where: str):
        return launch.build_parser().parse_args(
            ["--arch", cfg.name, "--full", "--steps", str(steps),
             "--global-batch", str(TRAIN_BATCH), "--ckpt", str(ckpt / where),
             "--ckpt-every", "100", "--log-every", "1", "--seed", "0",
             "--device", "cuda"])

    def params():
        return perturb_offsets(R.init_params(tcfg, seed=0, device="cuda"), 1)

    tcfg = launch.train_config(cfg, args(1, "x"))
    n_dcl = sum(tcfg.is_dcn(i) for i in range(tcfg.total_blocks))
    print(f"  config {tcfg.name}: stages {tcfg.stage_sizes}, widths "
          f"{tcfg.widths}, {n_dcl} DCLs, B={tcfg.offset_bound}, "
          f"{tcfg.img_size}x{tcfg.img_size}, batch {TRAIN_BATCH}, "
          f"use_kernel={tcfg.use_kernel}")
    reset_counts()
    t0 = time.monotonic()
    trainer = launch.train_detection(cfg, args(TRAIN_STEPS, "full"),
                                     params=params())
    wall = time.monotonic() - t0
    # The params the checkpoint holds (the timing below steps the trainer
    # further), for phase 15.
    trained = tree_map(lambda t: t.detach().clone(), trainer.params)
    counts = read_counts()
    losses = [h["loss"] for h in trainer.history if "loss" in h]
    print(f"  {TRAIN_STEPS} steps in {wall:.2f} s; losses "
          f"{[round(v, 5) for v in losses]}; telemetry {trainer.telemetry}; "
          f"launches {counts}")
    want = {name: (n_dcl * TRAIN_STEPS if name in ("deform_conv_fused",
                                                   "deform_conv_bwd") else 0)
            for name in counts}
    if counts != want:
        fail(f"training launched {counts}; expected {want}")
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all() \
            or trainer.telemetry != {"skipped": 0, "recovered": 0,
                                     "retries": 0, "preempted": False}:
        fail(f"training: losses {losses}, telemetry {trainer.telemetry}")

    # Resume: 4 steps, then a new run to 6 from the step-4 checkpoint.
    launch.train_detection(cfg, args(4, "resumed"), params=params())
    resumed = launch.train_detection(cfg, args(TRAIN_STEPS, "resumed"),
                                     params=params())
    flat = torch.cat([p.detach().reshape(-1) for p in leaves(trainer.params)])
    flat_r = torch.cat([p.detach().reshape(-1)
                        for p in leaves(resumed.params)])
    resume_rel = ((flat_r - flat).norm() / flat.norm()).item()
    p0 = torch.cat([p.reshape(-1) for p in leaves(params())])
    moved = ((flat - p0).norm() / p0.norm()).item()
    r_losses = [h["loss"] for h in resumed.history if "loss" in h]
    print(f"  resumed at step 4: losses {[round(v, 5) for v in r_losses]}; "
          f"params vs the uninterrupted run: relative norm {resume_rel:.2e} "
          f"(the 6 steps moved them {moved:.2e})")
    if resume_rel > RESUME_RTOL or len(r_losses) != 2:
        fail(f"resumed run is {resume_rel} from the uninterrupted run")

    # Step 0 against the same step with the plain versions in place.  The
    # gradient of bilinear sampling jumps where a tap crosses an integer
    # position, so at full depth fp32-order differences in the forward move
    # a few taps across and the whole-path gradients differ by more than
    # 1e-3 even between two plain runs.  Hence: the backward kernel is held
    # to 1e-3 against the plain backward on the same forward; the whole
    # path (both plain versions) to the plain path's own spread, measured
    # here under another fp32 order (tile_c = 8) and under a 1e-7 relative
    # perturbation of the images.
    data = DetectionDataConfig(img_size=tcfg.img_size,
                               global_batch=TRAIN_BATCH,
                               num_classes=tcfg.num_classes, seed=0)
    batch = {k: torch.from_numpy(v).to("cuda")
             for k, v in detection_batch(data, 0).items()}
    noise = torch.randn(
        batch["images"].shape, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(7))
    p_step0 = params()
    for t in leaves(p_step0):
        t.requires_grad_(True)

    taps: dict[str, list] = {}

    def loss_and_grads(*, fwd=False, bwd=False, tile_c=None, images=None,
                       record=None):
        from repro_torch.kernels import ops
        b_ = batch if images is None else dict(batch, images=images)
        with plain_training_kernels(fwd=fwd, bwd=bwd, tile_c=tile_c):
            inner = ops.deform_conv
            if record is not None:
                def recording(x, offsets, w, **kw):
                    taps.setdefault(record, []).append(offsets.detach())
                    return inner(x, offsets, w, **kw)
                ops.deform_conv = recording
            loss, _ = R.train_loss(p_step0, tcfg, b_, lam=0.005,
                                   device="cuda")
            ops.deform_conv = inner
            gs = torch.autograd.grad(loss, leaves(p_step0))
        return loss.item(), torch.cat([g.reshape(-1) for g in gs])

    def crossings() -> tuple[int, int]:
        """Unclamped offset coordinates whose integer part differs between
        the kernel path and the plain path, and all offset coordinates."""
        n_cross = n_all = 0
        for a, b_ in zip(taps["kernel"], taps["plain"]):
            inside = (a.abs() < B) & (b_.abs() < B)
            n_cross += ((torch.floor(a) != torch.floor(b_)) & inside) \
                .sum().item()
            n_all += a.numel()
        return n_cross, n_all

    def rel(a, b_):
        return ((a - b_).norm() / b_.norm()).item()
    loss_k, g_k = loss_and_grads(record="kernel")
    _, g_kp = loss_and_grads(bwd=True)
    loss_p, g_p = loss_and_grads(fwd=True, bwd=True, record="plain")
    n_cross, n_taps = crossings()
    _, g_order = loss_and_grads(fwd=True, bwd=True, tile_c=8)
    _, g_noise = loss_and_grads(fwd=True, bwd=True,
                                images=batch["images"] * (1 + 1e-7 * noise))
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    bwd_rel = rel(g_k, g_kp)
    path_rel = rel(g_k, g_p)
    spread = max(rel(g_order, g_p), rel(g_noise, g_p))
    print(f"  step 0 vs the plain versions: loss {loss_k:.6f} vs "
          f"{loss_p:.6f} (rel {loss_rel:.2e}); gradients: backward kernel "
          f"vs plain backward (same forward) {bwd_rel:.2e}; whole path "
          f"{path_rel:.2e}, plain path vs itself under another fp32 order "
          f"{rel(g_order, g_p):.2e} and under 1e-7 input noise "
          f"{rel(g_noise, g_p):.2e}; {n_cross} of {n_taps} offsets cross an "
          f"integer between the two paths; first logged loss "
          f"{losses[0]:.6f}")
    if loss_rel > TRAIN_LOSS_RTOL or abs(losses[0] - loss_k) \
            > TRAIN_LOSS_RTOL * abs(loss_p):
        fail(f"step 0 loss off the plain path: rel {loss_rel}")
    if bwd_rel > TRAIN_GRAD_RTOL:
        fail(f"step 0 gradients through the backward kernel are {bwd_rel} "
             f"from the plain backward's")
    if path_rel > max(TRAIN_GRAD_RTOL, spread):
        fail(f"step 0 gradients of the kernel path are {path_rel} from the "
             f"plain path's, beyond its own spread {spread}")

    # Where a step's time goes: forward / backward split (CUDA events),
    # the whole step, and its device-busy share (torch.profiler).
    def fwd_bwd():
        e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        e0.record()
        loss, _ = R.train_loss(p_step0, tcfg, batch, lam=0.005,
                               device="cuda")
        e1.record()
        torch.autograd.grad(loss, leaves(p_step0))
        e2.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1), e1.elapsed_time(e2)
    fwd_bwd()
    split = [fwd_bwd() for _ in range(5)]
    fwd_ms = statistics.median(f for f, _ in split)
    bwd_ms = statistics.median(b_ for _, b_ in split)
    step_batch = trainer._device_batch(0)
    step_ms = time_ms(lambda: trainer._one_step(step_batch), reps=3, iters=2)
    events = device_events(lambda: trainer._one_step(step_batch))
    busy = sum(ms for _, ms in events) or None
    top = [(k[:60], round(ms, 4)) for k, ms in events[:6]]
    k2_ms, k2_share = kernel_share(events, "dcb_")
    k1_ms, k1_share = kernel_share(events, "dcf_")
    share = "not measured" if busy is None else f"{1 - busy / step_ms:.0%}"
    host_ms = [t * 1e3 for t in trainer.step_seconds]
    # The same step with cuDNN free to pick non-deterministic algorithms
    # (the launcher's setting; the checks above need determinism).
    torch.backends.cudnn.deterministic = False
    free_ms = time_ms(lambda: trainer._one_step(step_batch), reps=3, iters=2)
    free_events = device_events(lambda: trainer._one_step(step_batch))
    free_busy = sum(ms for _, ms in free_events) or None
    free_top = [(k[:60], round(ms, 4)) for k, ms in free_events[:6]]
    free_k2_ms, free_k2_share = kernel_share(free_events, "dcb_")
    free_k1_ms, free_k1_share = kernel_share(free_events, "dcf_")
    torch.backends.cudnn.deterministic = True
    print(f"  step (forward + backward + SGD), batch {TRAIN_BATCH}: "
          f"{step_ms:.3f} ms (CUDA events); forward {fwd_ms:.3f} ms, "
          f"backward {bwd_ms:.3f} ms; device busy "
          f"{busy if busy is None else round(busy, 3)} ms by torch.profiler, "
          f"idle {share}; host-clock steps {[round(t, 2) for t in host_ms]} "
          f"ms; top {top[:5]}")
    free = free_busy if free_busy is None else round(free_busy, 3)
    print(f"  the same step, cuDNN not deterministic: {free_ms:.3f} ms, "
          f"device busy {free} ms; top {free_top[:5]}")
    print(f"  kernel 2 (dcb_* launches) in the step's device time: "
          f"{k2_ms:.3f} ms ({k2_share:.1%}) with cuDNN deterministic, "
          f"{free_k2_ms:.3f} ms ({free_k2_share:.1%}) without")
    print(f"  kernel 1a (dcf_* launches) in the step's device time: "
          f"{k1_ms:.3f} ms ({k1_share:.1%}) with cuDNN deterministic, "
          f"{free_k1_ms:.3f} ms ({free_k1_share:.1%}) without")
    record["train"] = dict(
        steps=TRAIN_STEPS, batch=TRAIN_BATCH, img_size=tcfg.img_size,
        wall_s=wall, losses=losses, telemetry=trainer.telemetry,
        launches=counts, host_step_ms=host_ms,
        median_host_step_ms=trainer.median_step_sec() * 1e3,
        resume_rel=resume_rel, moved_rel=moved, resumed_losses=r_losses,
        step0_loss=[loss_k, loss_p], step0_loss_rel=loss_rel,
        step0_grad_rel_backward=bwd_rel, step0_grad_rel_path=path_rel,
        step0_grad_plain_spread=[rel(g_order, g_p), rel(g_noise, g_p)],
        step0_offsets_crossing=[n_cross, n_taps],
        step_ms=step_ms, forward_ms=fwd_ms,
        backward_ms=bwd_ms, device_busy_ms=busy, device_top=top,
        step_ms_cudnn_free=free_ms, device_busy_ms_cudnn_free=free_busy,
        device_top_cudnn_free=free_top, kernel2_device_ms=k2_ms,
        kernel2_device_share=k2_share, kernel2_device_ms_cudnn_free=free_k2_ms,
        kernel2_device_share_cudnn_free=free_k2_share,
        kernel1a_device_ms=k1_ms, kernel1a_device_share=k1_share,
        kernel1a_device_ms_cudnn_free=free_k1_ms,
        kernel1a_device_share_cudnn_free=free_k1_share)
    step0 = dict(loss=loss_k, loss_plain=loss_p, grads=g_k, grads_plain=g_p,
                 gate=max(TRAIN_GRAD_RTOL, spread))
    return counts["deform_conv_bwd"], step0, trained


def grid_sample_inputs(x, off, *, stride: int, dilation: int, bound: float):
    """``F.grid_sample``'s input (NCHW) and grid (N, Ho, Wo*K*K, 2) for the
    bounded sampling of x at the clamped offsets: the positions of the
    unpadded image, normalised for ``align_corners=True`` (computed in
    float64, then rounded once to fp32)."""
    import torch
    n, h, w, _ = x.shape
    _, ho, wo, _ = off.shape
    k2 = K * K
    pad = dilation * (K // 2)
    o = off.double().reshape(n, ho, wo, k2, 2).clamp(-bound, bound)
    kk = torch.arange(k2, device=x.device)
    oy = torch.arange(ho, device=x.device)[:, None, None] * stride \
        - pad + (kk // K)[None, None, :] * dilation
    ox = torch.arange(wo, device=x.device)[None, :, None] * stride \
        - pad + (kk % K)[None, None, :] * dilation
    py = oy.double() + o[..., 0]
    px = ox.double() + o[..., 1]
    grid = torch.stack((2 * px / (w - 1) - 1, 2 * py / (h - 1) - 1), -1)
    return (x.permute(0, 3, 1, 2).contiguous(),
            grid.reshape(n, ho, wo * k2, 2).float().contiguous())


def grid_sample_patches(xc, grid, ho: int, wo: int):
    """(N, C, Ho, Wo*K*K) from grid_sample -> (N, Ho, Wo, K*K, C)."""
    import torch.nn.functional as F
    y = F.grid_sample(xc, grid, mode="bilinear", padding_mode="zeros",
                      align_corners=True)
    n, c = y.shape[:2]
    return y.reshape(n, c, ho, wo, K * K).permute(0, 2, 3, 4, 1)


def flushed_ms(fn, calls: int = 20, reps: int = 3) -> float:
    """Device time of one call of ``fn`` (ms) with the L2 cache flushed
    before it: ``calls`` pairs of (a read of ``L2_FLUSH_BYTES``, which also
    writes back the last call's output; ``fn``) less ``calls`` reads
    alone, each sequence between two CUDA events queued behind a busy
    device, as ``queued_ms``; the median over ``reps``."""
    import torch
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")

    def seq(with_fn: bool) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(calls):
            flush.sum()
            if with_fn:
                fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)
    fn()
    torch.cuda.synchronize()
    return statistics.median((seq(True) - seq(False)) / calls
                             for _ in range(reps))


def host_us(fn, calls: int = 100) -> float:
    """Host time of one call of ``fn`` (µs): its launch path, read on the
    host clock around ``calls`` calls enqueued behind a busy device, so
    none waits on the device."""
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def check_sample_kernels(case: dict, gen) -> list[dict]:
    """Kernels 1b and 3 vs their plain versions on one geometry, in fp32
    and bf16, at the tiles ``ops.deform_sample`` picks, and
    ``F.grid_sample`` computing the same function; returns the four
    records."""
    import torch

    from repro_torch.core.tiling import (out_hw, sample_c_groups,
                                         sample_smem_bytes, sample_vec_bytes)
    from repro_torch.kernels import deform_sample as S
    from repro_torch.kernels import plan

    n, h, w, c = case["n"], case["h"], case["w"], case["c"]
    s, d, b = case["stride"], case["dilation"], case.get("bound", B)
    ho, wo = out_hw(h, w, kernel_size=K, stride=s, dilation=d)
    geom = dict(kernel_size=K, stride=s, dilation=d, offset_bound=b)
    x32 = torch.randn(n, h, w, c, device="cuda", generator=gen)
    off32 = torch.randn(n, ho, wo, 2 * K * K, device="cuda",
                        generator=gen) * 1.5
    lib = S.load_kernel()
    recs = []
    for dt in SAMPLE_DTYPES:
        dtype = getattr(torch, dt)
        x, off = x32.to(dtype), off32.to(dtype)
        item = x.element_size()
        xc, grid = grid_sample_inputs(x.float(), off.float(), stride=s,
                                      dilation=d, bound=b)
        xc, grid = xc.to(dtype), grid.to(dtype)
        try:
            lib_out = grid_sample_patches(xc, grid, ho, wo)
        except RuntimeError as e:          # a dtype grid_sample refuses
            print(f"  F.grid_sample refuses {dtype}: {e}")
            lib_out = library_ms = None
        else:
            library_ms = time_ms(lambda: grid_sample_patches(xc, grid, ho,
                                                             wo),
                                 reps=7, iters=10)
        th, tw, tc, _ = plan.resolve_tiles(n, h, w, c, c, tile_h=8,
                                           dtype="sample", itemsize=item,
                                           **geom)
        th, tw = min(th, ho), min(tw, wo)
        xp = plan.pad_zerocopy(x, tile_h=th, tile_w=tw, ho=ho, wo=wo, **geom)
        spec = plan.DCSpec(K, s, d, b, 8, dataflow="banded")
        thb, twb, tcb, _ = plan.banded_tiles(spec, x, off, c, dtype="sample")
        bands, offb = plan.banded_inputs(spec, x, off, thb)
        runs = {
            "deform_sample_zerocopy": (
                S.deform_sample_zerocopy, S.deform_sample_zerocopy_plain,
                (xp, off.contiguous()), [th, tw, tc]),
            "deform_sample_banded": (
                S.deform_sample_banded, S.deform_sample_banded_plain,
                (bands, offb), [thb, twb, tcb]),
        }
        for name, (fn, plain, args, tl) in runs.items():
            kw = dict(tile_h=tl[0], tile_w=tl[1], tile_c=tl[2], **geom)
            y = fn(*args, **kw)
            torch.cuda.synchronize()
            yp = plain(*args, **kw)
            equal = torch.equal(y, yp)
            err = (y.float() - yp.float()).abs().max().item()
            scale = yp.float().abs().max().item()
            lib_err = None if lib_out is None else \
                (lib_out.float() - yp[:, :ho].float()).abs().max().item()
            ms = time_ms(lambda: fn(*args, **kw), reps=7, iters=10)
            q_ms = queued_ms(lambda: fn(*args, **kw))
            f_ms = flushed_ms(lambda: fn(*args, **kw))
            h_us = host_us(lambda: fn(*args, **kw))
            plain_ms = time_ms(lambda: plain(*args, **kw), reps=3, iters=2)
            smem_c = lib.ds_smem_bytes(K, s, d, math.ceil(b), tl[0], tl[1],
                                       tl[2], item)
            smem_py = sample_smem_bytes(tl[0], tl[1], tl[2], kernel_size=K,
                                        stride=s, dilation=d, offset_bound=b,
                                        itemsize=item)
            groups = sample_c_groups(n, y.shape[1], wo, c, tile_h=tl[0],
                                     tile_w=tl[1], tile_c=tl[2])
            # Four products and three sums a sample, fp32 in both dtypes.
            work = h100.rate_work(
                item * y.numel() + sum(t.numel() * t.element_size()
                                       for t in args),
                h100.SAMPLE_OPS * y.numel(), h100.PEAK_FP32_FLOPS)
            bound_ms = work["bound_s"] * 1e3
            in_l2 = item * y.numel() <= L2_BYTES
            rec = dict(case, kernel=name, dtype=dt,
                       ho=ho, wo=wo, tiles=tl, groups=groups,
                       vec_bytes=sample_vec_bytes(tl[2], item),
                       smem_bytes=smem_c, equal=equal, max_abs_err=err,
                       max_abs_plain=scale, library_err=lib_err,
                       clamped_share=(off32.abs() > b).float().mean().item(),
                       ms=ms, queued_ms=q_ms, flushed_ms=f_ms, host_us=h_us,
                       plain_ms=plain_ms, library_ms=library_ms,
                       **bound_fields(work), out_in_l2=in_l2,
                       share=bound_ms / (f_ms if in_l2 else q_ms))
            ok = equal and err <= SAMPLE_ATOL and smem_c == smem_py and (
                lib_err is None or dtype != torch.float32
                or lib_err <= LIBRARY_RTOL * scale)
            lib_line = "refused" if library_ms is None else \
                f"{library_ms:.4f} ms (err {lib_err:.1e})"
            print(f"  {name:<22} {dt:<8} {case['label']:<26} "
                  f"tiles {tl[0]}x{tl[1]} tc={tl[2]} groups={groups} "
                  f"vec={rec['vec_bytes']} smem={smem_c} equal={equal} "
                  f"err={err:.1e} kernel={ms:.4f} ms queued={q_ms:.4f} "
                  f"flushed={f_ms:.4f} host={h_us:.1f} us "
                  f"plain={plain_ms:.3f} ms grid_sample={lib_line} "
                  f"bound={bound_ms:.4f} ms share={rec['share']:.1%}"
                  f"{' (flushed: output fits in L2)' if in_l2 else ''} "
                  f"{'ok' if ok else 'FAIL'}")
            if smem_c != smem_py:
                fail(f"{name} {case['label']} {dt}: shared memory "
                     f"{smem_c} (kernel) != {smem_py} (chooser)")
            if not equal or err > SAMPLE_ATOL:
                fail(f"{name} {case['label']} {dt}: the kernel is not "
                     f"equal to its plain version (max|diff| = {err})")
            if dtype == torch.float32 and lib_err > LIBRARY_RTOL * scale:
                fail(f"{name} {case['label']}: grid_sample is {lib_err} "
                     f"from the plain version: not the same function")
            recs.append(rec)
    return recs


def check_banded_kernel(case: dict, gen) -> dict:
    """Kernel 4 vs its plain version on one geometry, at the tiles of the
    banded plan; returns the record."""
    import torch

    from repro_torch.core.tiling import out_hw, smem_bytes
    from repro_torch.kernels import deform_conv_fused as F
    from repro_torch.kernels import plan

    n, h, w, c, m = case["n"], case["h"], case["w"], case["c"], case["m"]
    s, d, b = case["stride"], case["dilation"], case.get("bound", B)
    ho, wo = out_hw(h, w, kernel_size=K, stride=s, dilation=d)
    x = torch.randn(n, h, w, c, device="cuda", generator=gen)
    off = torch.randn(n, ho, wo, 2 * K * K, device="cuda",
                      generator=gen) * 1.5
    wd = torch.randn(K * K, c, m, device="cuda", generator=gen) \
        / (K * K * c) ** 0.5
    spec = plan.DCSpec(K, s, d, b, dataflow="banded")
    th, tw, tc, tm = plan.banded_tiles(spec, x, off, m, dtype="banded")
    bands, offb = plan.banded_inputs(spec, x, off, th)
    wt = plan.tile_weights(wd, tc)
    kw = dict(kernel_size=K, stride=s, dilation=d, offset_bound=b,
              tile_h=th, tile_w=tw, tile_c=tc, tile_m=tm)
    y = F.deform_conv_fused_banded(bands, offb, wt, **kw)
    torch.cuda.synchronize()
    repeatable = torch.equal(y, F.deform_conv_fused_banded(bands, offb, wt,
                                                           **kw))
    yp = F.deform_conv_fused_banded_plain(bands, offb, wt, **kw)
    err = (y - yp).abs().max().item()
    scale = yp.abs().max().item()
    lib = F.load_kernel()
    smem_c = lib.dcf_smem_bytes(K, s, d, math.ceil(b), th, tw, tc, 4)
    inst = fwd_instance(lib, bands, wt, n=n, ho=offb.shape[1], wo=wo, c=c,
                        m=m, s=s, d=d, b=b, th=th, tw=tw, tc=tc, tm=tm)
    smem_py = smem_bytes(th, tw, tc, kernel_size=K, stride=s, dilation=d,
                         offset_bound=b)
    ms = time_ms(lambda: F.deform_conv_fused_banded(bands, offb, wt, **kw),
                 reps=7, iters=10)
    plain_ms = time_ms(
        lambda: F.deform_conv_fused_banded_plain(bands, offb, wt, **kw),
        reps=3, iters=2)
    prep_ms = time_ms(lambda: (plan.banded_inputs(spec, x, off, th),
                               plan.tile_weights(wd, tc)), reps=5, iters=10)
    work = h100.banded_work(n, h, w, c, m, kernel_size=K, stride=s,
                            dilation=d, offset_bound=b, tile_h=th)
    same_bytes(work, (bands, offb, wt, y), f"banded {case['label']}")
    rec = dict(case, ho=ho, wo=wo, tiles=[th, tw, tc, tm], smem_bytes=smem_c,
               instance=inst, repeatable=repeatable,
               bands_bytes=4 * bands.numel(), input_bytes=4 * x.numel(),
               max_abs_err=err, max_abs_plain=scale,
               clamped_share=(off.abs() > b).float().mean().item(),
               ms=ms, plain_ms=plain_ms, prep_ms=prep_ms,
               **bound_fields(work))
    ok = err <= KERNEL_RTOL * scale and smem_c == smem_py and repeatable
    print(fwd_case_line(rec, ok) + f"; bands/input "
          f"{bands.numel() / x.numel():.2f}x")
    if smem_c != smem_py:
        fail(f"banded {case['label']}: shared memory {smem_c} (kernel) != "
             f"{smem_py} (chooser)")
    if err > KERNEL_RTOL * scale:
        fail(f"banded {case['label']}: max|kernel - plain| = {err} exceeds "
             f"{KERNEL_RTOL} * {scale}")
    if not repeatable:
        fail(f"banded {case['label']}: two calls of the kernel differ")
    return rec


def check_matmul(m: int, k: int, n: int, dtype: str, gen) -> dict:
    """Kernel 5 vs its plain version and ``torch.matmul``; the record."""
    import torch

    from repro_torch.kernels import matmul as MM
    x = torch.randn(m, k, device="cuda", generator=gen).to(
        getattr(torch, dtype))
    w = torch.randn(k, n, device="cuda", generator=gen).to(
        getattr(torch, dtype))
    instance = MM.instance(x, w)
    y = MM.matmul(x, w)
    torch.cuda.synchronize()
    yp = MM.matmul_plain(x, w)
    err = (y.float() - yp.float()).abs().max().item()
    scale = yp.float().abs().max().item()
    tol = KERNEL_RTOL if dtype == "float32" else BF16_RTOL
    big = m * n * k > 1e9
    ms = time_ms(lambda: MM.matmul(x, w), reps=5, iters=3 if big else 20)
    plain_ms = time_ms(lambda: MM.matmul_plain(x, w), reps=5,
                       iters=3 if big else 20)
    library_ms = time_ms(lambda: torch.matmul(x, w), reps=5,
                         iters=3 if big else 20)
    flops = 2 * m * n * k
    work = h100.rate_work(x.element_size() * (m * k + k * n + m * n), flops,
                          h100.PEAK_FP32_FLOPS if dtype == "float32"
                          else h100.PEAK_BF16_FLOPS)
    bound_ms = work["bound_s"] * 1e3
    label = f"{m}x{k}x{n} {dtype}"
    rec = dict(label=label, m=m, k=k, n=n, dtype=dtype, instance=instance,
               max_abs_err=err,
               max_abs_plain=scale, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, **bound_fields(work))
    print(f"  matmul {label:<24} [{instance}] err={err:.2e} "
          f"(max|plain|={scale:.2f}) "
          f"kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
          f"torch.matmul={library_ms:.4f} ms bound={bound_ms:.4f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s) "
          f"{'ok' if err <= tol * scale else 'FAIL'}")
    if err > tol * scale:
        fail(f"matmul {label}: max|kernel - plain| = {err} exceeds "
             f"{tol} * {scale}")
    return rec


def entry_points(cases: list[dict], gen) -> dict[str, int]:
    """Phase 9's main path: ``ops.deform_sample`` on both dataflows and
    ``ops.deform_conv`` on both at each case, sample + einsum against the
    fused output, and ``ops.matmul`` at every matmul case, as a user calls
    them.  Returns the launches counted in that run."""
    import torch

    from repro_torch.core.tiling import out_hw
    from repro_torch.kernels import ops

    inputs = []
    for case in cases:
        n, h, w, c, s = (case["n"], case["h"], case["w"], case["c"],
                         case["stride"])
        ho, wo = out_hw(h, w, kernel_size=K, stride=s)
        inputs.append((case, torch.randn(n, h, w, c, device="cuda",
                                         generator=gen),
                       torch.randn(n, ho, wo, 2 * K * K, device="cuda",
                                   generator=gen) * 1.5,
                       torch.randn(K * K, c, c, device="cuda", generator=gen)
                       / (K * K * c) ** 0.5))
    mm_inputs = [(torch.randn(m, k, device="cuda", generator=gen).to(
        getattr(torch, dt)), torch.randn(k, n, device="cuda",
                                          generator=gen).to(getattr(torch, dt)))
        for m, k, n, dt in MM_SHAPES]
    # The bf16 calls' reference: the fp32 kernel on the same bf16-rounded
    # inputs, rounded once to bf16 (the same fp32 sums), before the count.
    bf16_want = {}
    for case, x, off, _ in inputs:
        kw = dict(offset_bound=B, stride=case["stride"], device="cuda")
        for dataflow in ("zero_copy", "banded"):
            bf16_want[case["label"], dataflow] = ops.deform_sample(
                x.bfloat16().float(), off.bfloat16().float(),
                dataflow=dataflow, **kw).bfloat16()
    torch.cuda.synchronize()
    reset_counts()
    worst = {}
    for case, x, off, wd in inputs:
        kw = dict(offset_bound=B, stride=case["stride"], device="cuda")
        for dataflow in ("zero_copy", "banded"):
            patches = ops.deform_sample(x, off, dataflow=dataflow, **kw)
            fused = ops.deform_conv(x, off, wd, dataflow=dataflow, **kw)
            two = torch.einsum("nhwkc,kcm->nhwm", patches, wd)
            rel = ((two - fused).abs().max() / fused.abs().max()).item()
            worst[dataflow] = max(worst.get(dataflow, 0.0), rel)
            if rel > KERNEL_RTOL or patches.shape[-2:] != (K * K, x.shape[-1]):
                fail(f"{case['label']} {dataflow}: sample + einsum is {rel} "
                     f"(relative) from the fused forward")
            patches = ops.deform_sample(x.bfloat16(), off.bfloat16(),
                                        dataflow=dataflow, **kw)
            if not torch.equal(patches,
                               bf16_want.pop((case["label"], dataflow))):
                fail(f"{case['label']} {dataflow}: bf16 patches differ from "
                     f"the fp32 kernel's on the same inputs, rounded")
    for x, w in mm_inputs:
        y = ops.matmul(x, w)
        if y.dtype != x.dtype or not torch.isfinite(y.float()).all():
            fail(f"ops.matmul {tuple(x.shape)} x {tuple(w.shape)}: "
                 f"{y.dtype}, finite {torch.isfinite(y.float()).all()}")
    torch.cuda.synchronize()
    counts = read_counts()
    want = {name: 0 for name in counts}
    want.update(deform_sample_zerocopy=len(cases) * len(SAMPLE_DTYPES),
                deform_sample_banded=len(cases) * len(SAMPLE_DTYPES),
                deform_conv_fused=len(cases), deform_conv_banded=len(cases),
                matmul=len(MM_SHAPES))
    print(f"  entry points: launches {counts}; sample + einsum vs fused, "
          f"worst relative {worst}; bf16 patches equal to the fp32 "
          f"kernel's on the same inputs, rounded")
    if counts != want:
        fail(f"the entry-point run launched {counts}; expected {want}")
    return counts


def serve_banded(record: dict, params, zc_reqs) -> int:
    """Phase 10: phase 4's model and requests on the banded dataflow.
    Returns kernel 4's launches in the served run."""
    import numpy as np
    import torch

    from repro_torch.configs.resnet50_dcn import CONFIG_BOUNDED
    from repro_torch.launch import serve as launch
    from repro_torch.models import resnet_dcn as R

    cfg = dataclasses.replace(CONFIG_BOUNDED, use_kernel=True,
                              dataflow="banded")
    n_dcl = sum(cfg.is_dcn(i) for i in range(cfg.total_blocks))
    args = serve_args(cfg, "fp32_kernel")
    launch.serve_detection(cfg, args, params=params)        # warm-up
    reset_counts()
    engine, _, seconds = launch.serve_detection(cfg, args, params=params)
    counts = read_counts()
    print(launch.report(engine, seconds))
    reqs = engine.completed
    bad = [r for r in reqs if r.outcome != "ok" or r.ladder != "fp32_kernel"
           or r.degraded]
    if len(reqs) != 8 or bad:
        fail(f"banded requests not all ok on fp32_kernel: "
             f"{[(r.uid, r.outcome, r.ladder, r.error) for r in reqs]}")
    want = {name: (n_dcl * engine.steps if name == "deform_conv_banded"
                   else 0) for name in counts}
    if counts != want:
        fail(f"the banded run launched {counts} in {engine.steps} steps; "
             f"expected {want}")
    print(f"  launches in the banded run: {counts}")
    zc = {r.uid: r.result for r in zc_reqs}
    ref_cfg = dataclasses.replace(cfg, use_kernel=False)
    zc_cfg = dataclasses.replace(cfg, dataflow="zero_copy")
    errs = {}
    fwd_ms = {}
    for bucket in sorted({r.bucket for r in reqs}):
        rows = [r for r in reqs if r.bucket == bucket]
        x = engine.batch_array(bucket, rows)
        with torch.no_grad():
            ref, _ = R.forward(params, ref_cfg, x, device="cuda")
        for key in ("cls", "box"):
            got = np.stack([r.result[key] for r in rows])
            r_np = ref[key].cpu().numpy()[:len(rows)]
            z_np = np.stack([zc[r.uid][key] for r in rows])
            err = float(np.abs(got - r_np).max())
            scale = float(np.abs(r_np).max())
            err_zc = float(np.abs(got - z_np).max())
            scale_zc = float(np.abs(z_np).max())
            errs[f"{bucket}/{key}"] = dict(vs_plain=err / scale,
                                           vs_zero_copy=err_zc / scale_zc)
            print(f"  bucket {bucket} {key}: vs plain path {err:.3e} "
                  f"(max|ref|={scale:.3f}); vs phase 4's zero-copy "
                  f"{err_zc:.3e} (rel {err_zc / scale_zc:.2e})")
            if not np.isfinite(got).all() or err > SERVE_RTOL * scale:
                fail(f"banded bucket {bucket} {key} off the plain path: "
                     f"{err} > {SERVE_RTOL} * {scale}")
            if err_zc > BANDED_VS_ZC_RTOL * scale_zc:
                fail(f"banded bucket {bucket} {key} off the zero-copy "
                     f"result: {err_zc} > {BANDED_VS_ZC_RTOL} * {scale_zc}")
        # Both dataflows' forwards, timed in turns.
        fns = {"banded": lambda: R.forward(params, cfg, x, device="cuda"),
               "zero_copy": lambda: R.forward(params, zc_cfg, x,
                                              device="cuda")}
        turns: dict[str, list[float]] = {name: [] for name in fns}
        with torch.no_grad():
            busy, top = device_profile(fns["banded"])
            for _ in range(5):
                for name, fn in fns.items():
                    turns[name].append(time_ms(fn, reps=1, iters=3))
        row = {name: statistics.median(t) for name, t in turns.items()}
        row.update(turns=turns, banded_device_busy=busy, banded_top=top)
        fwd_ms[str(bucket)] = row
        share = "not measured" if busy is None \
            else f"{1 - busy / row['banded']:.0%}"
        print(f"  {bucket}-bucket forward, batch {BATCH}: banded "
              f"{row['banded']:.3f} ms, zero-copy {row['zero_copy']:.3f} ms "
              f"(median of 5 turns); banded device busy "
              f"{busy if busy is None else round(busy, 3)} ms, idle {share}; "
              f"top {top[:4]}")
    lats = sorted(r.latency_s() for r in reqs)
    record["serve_banded"] = dict(
        requests=len(reqs), steps=engine.steps, launches=counts,
        steps_per_bucket=engine.telemetry()["steps_per_bucket"],
        plans=engine.telemetry()["plans"], seconds=seconds,
        p50_latency_ms=lats[len(lats) // 2] * 1e3, errors=errs,
        forward_ms=fwd_ms)
    return counts["deform_conv_banded"]


def train_banded(record: dict, step0: dict) -> int:
    """Phase 11: phase 8's training settings on the banded dataflow.
    Returns kernel 4's launches in the 2-step run."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.configs.resnet50_dcn import CONFIG_BOUNDED
    from repro_torch.data import DetectionDataConfig, detection_batch
    from repro_torch.launch import train as launch
    from repro_torch.models import resnet_dcn as R
    from repro_torch.tree import leaves

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg = dataclasses.replace(CONFIG_BOUNDED, dataflow="banded")
    ckpt = ROOT / "build" / "smoke_train_banded"
    shutil.rmtree(ckpt, ignore_errors=True)
    args = launch.build_parser().parse_args(
        ["--arch", cfg.name, "--full", "--steps", str(BANDED_TRAIN_STEPS),
         "--global-batch", str(TRAIN_BATCH), "--ckpt", str(ckpt),
         "--ckpt-every", "100", "--log-every", "1", "--seed", "0",
         "--device", "cuda"])
    tcfg = launch.train_config(cfg, args)
    n_dcl = sum(tcfg.is_dcn(i) for i in range(tcfg.total_blocks))

    def params():
        return perturb_offsets(R.init_params(tcfg, seed=0, device="cuda"), 1)
    reset_counts()
    t0 = time.monotonic()
    trainer = launch.train_detection(cfg, args, params=params())
    wall = time.monotonic() - t0
    counts = read_counts()
    losses = [h["loss"] for h in trainer.history if "loss" in h]
    print(f"  config {tcfg.name} dataflow={tcfg.dataflow}: "
          f"{BANDED_TRAIN_STEPS} steps in {wall:.2f} s; losses "
          f"{[round(v, 5) for v in losses]}; telemetry {trainer.telemetry}; "
          f"launches {counts}")
    per = n_dcl * BANDED_TRAIN_STEPS
    want = {name: (per if name in ("deform_conv_banded", "deform_conv_bwd")
                   else 0) for name in counts}
    if counts != want:
        fail(f"banded training launched {counts}; expected {want}")
    if len(losses) != BANDED_TRAIN_STEPS or not np.isfinite(losses).all() \
            or trainer.telemetry != {"skipped": 0, "recovered": 0,
                                     "retries": 0, "preempted": False}:
        fail(f"banded training: losses {losses}, telemetry "
             f"{trainer.telemetry}")

    # Step 0 against phase 8's zero-copy step 0 (the same params and batch).
    data = DetectionDataConfig(img_size=tcfg.img_size,
                               global_batch=TRAIN_BATCH,
                               num_classes=tcfg.num_classes, seed=0)
    batch = {k: torch.from_numpy(v).to("cuda")
             for k, v in detection_batch(data, 0).items()}
    p0 = params()
    for t in leaves(p0):
        t.requires_grad_(True)
    loss, _ = R.train_loss(p0, tcfg, batch, lam=0.005, device="cuda")
    g = torch.cat([t.reshape(-1) for t in
                   torch.autograd.grad(loss, leaves(p0))])
    loss_rel = abs(loss.item() - step0["loss"]) / abs(step0["loss"])
    rel_plain = ((g - step0["grads_plain"]).norm()
                 / step0["grads_plain"].norm()).item()
    rel_zc = ((g - step0["grads"]).norm() / step0["grads"].norm()).item()
    print(f"  step 0: loss {loss.item():.6f} vs zero-copy "
          f"{step0['loss']:.6f} (rel {loss_rel:.2e}); gradients vs the "
          f"plain path {rel_plain:.2e} (phase 8's gate "
          f"{step0['gate']:.2e}), vs the zero-copy kernel path "
          f"{rel_zc:.2e}; first logged loss {losses[0]:.6f}")
    if loss_rel > BANDED_LOSS_RTOL or abs(losses[0] - step0["loss"]) \
            > BANDED_LOSS_RTOL * abs(step0["loss"]):
        fail(f"banded step 0 loss is {loss_rel} from the zero-copy step 0")
    if rel_plain > step0["gate"]:
        fail(f"banded step 0 gradients are {rel_plain} from the plain "
             f"path's, beyond phase 8's gate {step0['gate']}")
    step_batch = trainer._device_batch(0)
    step_ms = time_ms(lambda: trainer._one_step(step_batch), reps=3, iters=2)
    events = device_events(lambda: trainer._one_step(step_batch))
    busy = sum(ms for _, ms in events) or None
    top = [(k[:60], round(ms, 4)) for k, ms in events[:6]]
    k2_ms, k2_share = kernel_share(events, "dcb_")
    k4_ms, k4_share = kernel_share(events, "dcf_")
    share = "not measured" if busy is None else f"{1 - busy / step_ms:.0%}"
    print(f"  banded step (forward + backward + SGD), batch {TRAIN_BATCH}: "
          f"{step_ms:.3f} ms (CUDA events, cuDNN deterministic); device "
          f"busy {busy if busy is None else round(busy, 3)} ms, idle "
          f"{share}; kernel 2 {k2_ms:.3f} ms of it ({k2_share:.1%}), "
          f"kernel 4 (dcf_*) {k4_ms:.3f} ms ({k4_share:.1%}); top "
          f"{top[:5]}")
    record["train_banded"] = dict(
        steps=BANDED_TRAIN_STEPS, wall_s=wall, losses=losses,
        telemetry=trainer.telemetry, launches=counts,
        host_step_ms=[t * 1e3 for t in trainer.step_seconds],
        step0_loss=loss.item(), step0_loss_rel=loss_rel,
        step0_grad_rel_plain=rel_plain, step0_grad_rel_zero_copy=rel_zc,
        step_ms=step_ms, device_busy_ms=busy, device_top=top,
        kernel2_device_ms=k2_ms, kernel2_device_share=k2_share,
        kernel4_device_ms=k4_ms, kernel4_device_share=k4_share)
    return counts["deform_conv_banded"]


# ---------------------------------------------------------------------------
# Phase 12: flash attention (kernel 6)
# ---------------------------------------------------------------------------

FA_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_flash_attention.py
# bf16 cases are also held to a relative L2 error: at Sk in the thousands
# a typical |o| (~sqrt(e / Sk)) is below FA_TOL's 2e-2 atol, so the
# elementwise test alone could pass a split left out of the combine
# (PERF.md section 2 has the readings).
FA_BF16_REL_L2 = 1e-2
LM_ATTN_TOL = 3e-5      # the LM's attention vs the kernel, fp32 (same test)
FA_JAX_CASES = [
    # (b, sq, sk, kv, g, dh, causal, softcap): tests/test_flash_attention.py
    (1, 128, 128, 1, 1, 32, True, None),
    (2, 64, 64, 2, 2, 16, True, None),
    (1, 100, 100, 1, 2, 16, True, None),
    (1, 64, 64, 2, 1, 32, False, None),
    (1, 96, 96, 1, 1, 16, True, 8.0),
    (1, 32, 160, 1, 1, 16, False, None),
]


def fa_cases() -> list[dict]:
    def case(label, b, sq, sk, kv, g, dh, causal, cap, dtype, **kw):
        return dict(label=label, b=b, sq=sq, sk=sk, kv=kv, g=g, dh=dh,
                    causal=causal, softcap=cap, dtype=dtype, **kw)
    cases = [case(f"test case {i} {dt}", *c, dt)
             for i, c in enumerate(FA_JAX_CASES)
             for dt in ("float32", "bfloat16")]
    cases += [case(f"tinyllama ({b}, {s}) {dt}", b, s, s, 4, 8, 64, True,
                   None, dt, vs="dense")
              for b, s, dt in [(1, 512, "bfloat16"), (4, 512, "bfloat16"),
                               (1, 2048, "bfloat16"), (4, 2048, "bfloat16"),
                               (1, 4096, "bfloat16"), (1, 2048, "float32")]]
    cases += [case("deepseek-7b MHA (1, 2048) bfloat16", 1, 2048, 2048, 32,
                   1, 128, True, None, "bfloat16"),
              case("glm4-9b GQA (1, 2048) bfloat16", 1, 2048, 2048, 2, 16,
                   128, True, None, "bfloat16"),
              case("deepseek-7b MHA (1, 2048) float32", 1, 2048, 2048, 32,
                   1, 128, True, None, "float32", vs="dense"),
              case("glm4-9b GQA (1, 2048) float32", 1, 2048, 2048, 2, 16,
                   128, True, None, "float32", vs="dense"),
              case("recurrentgemma-9b MQA Dh 256 (1, 2048) float32", 1, 2048,
                   2048, 1, 16, 256, True, None, "float32", vs="dense"),
              case("recurrentgemma-9b MQA Dh 256 (1, 2048) bfloat16", 1,
                   2048, 2048, 1, 16, 256, True, None, "bfloat16"),
              case("grok-1 softcap 30 (1, 1024) bfloat16", 1, 1024, 1024, 8,
                   6, 128, True, 30.0, "bfloat16"),
              case("cross Sq=1 Sk=2048 bfloat16", 1, 1, 2048, 4, 8, 64,
                   False, None, "bfloat16"),
              case("cross Sq=100 Sk=1000 bfloat16", 1, 100, 1000, 4, 8, 64,
                   False, None, "bfloat16"),
              case("tinyllama (1, 8192) float32", 1, 8192, 8192, 4, 8, 64,
                   True, None, "float32", vs="chunked")]
    # Decode-like shapes that take the split over K, kept out of the bf16
    # totals of the 15 bf16 cases above.
    cases += [case("cross Sq=1 Sk=8192 bfloat16", 1, 1, 8192, 4, 8, 64,
                   False, None, "bfloat16", decode=True),
              case("cross Sq=16 Sk=4096 bfloat16", 1, 16, 4096, 4, 8, 64,
                   False, None, "bfloat16", decode=True),
              case("cross Sq=1 Sk=2048 float32", 1, 1, 2048, 4, 8, 64,
                   False, None, "float32", decode=True)]
    return cases


def fa_work(c: dict) -> tuple[int, int]:
    """(operations, bytes) the function needs: 4 * Dh per (query, key)
    pair the mask keeps, for every query head; q, k, v read and the output
    written once."""
    sq, sk = c["sq"], c["sk"]
    if c["causal"]:
        m = min(sq, sk)
        pairs = m * (m + 1) // 2 + (sq - m) * sk
    else:
        pairs = sq * sk
    heads = c["b"] * c["kv"] * c["g"]
    elem = 4 if c["dtype"] == "float32" else 2
    nbytes = elem * c["dh"] * (2 * heads * sq + 2 * c["b"] * c["kv"] * sk)
    return 4 * heads * pairs * c["dh"], nbytes


def sdpa(q, k, v, causal: bool):
    """F.scaled_dot_product_attention on the GQA layout (views only):
    q (B, Sq, KV, G, Dh) -> (B, KV*G, Sq, Dh), k/v -> (B, KV, Sk, Dh)."""
    import torch.nn.functional as F
    b, sq, kv, g, dh = q.shape
    o = F.scaled_dot_product_attention(
        q.reshape(b, sq, kv * g, dh).transpose(1, 2), k.transpose(1, 2),
        v.transpose(1, 2), is_causal=causal, enable_gqa=True)
    return o.transpose(1, 2).reshape(b, sq, kv, g, dh)


def within(got, want, tol: float) -> bool:
    return bool(((got.float() - want.float()).abs()
                 <= tol + tol * want.float().abs()).all())


def rel_l2(got, want) -> float:
    """||got - want|| / ||want|| over the whole tensor, in fp32."""
    want = want.float()
    return ((got.float() - want).norm() / want.norm()).item()


def queued_ms(fn, calls: int = 10) -> float:
    """Device time of one call of ``fn`` (ms): CUDA events around ``calls``
    calls enqueued behind a kernel that keeps the device busy ~10 ms, so
    the host's launch path, which bounds small calls timed back to back,
    hides behind device work."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def kernel_device_ms(fn, pattern: str, calls: int = 10) -> dict:
    """torch.profiler over ``calls`` calls of ``fn`` (after one warm-up):
    ``{name: (launches a call, device ms a call)}`` of each device-side
    event whose name matches ``pattern`` (keyed by the match), longest
    first.  One short call alone leaves the profiler with no kernel
    record."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(
            e, "cuda_time_total", 0)
        name = re.search(pattern, e.key)
        if t and name and e.device_type == torch.autograd.DeviceType.CUDA:
            ct, ms = out.get(name.group(0), (0.0, 0.0))
            out[name.group(0)] = (ct + e.count / calls, ms + t / 1e3 / calls)
    return dict(sorted(out.items(), key=lambda kv: -kv[1][1]))


def check_flash(c: dict, gen) -> tuple[dict, tuple]:
    """Kernel 6 vs its plain version (and SDPA, and the LM's attention
    where the case asks) on one case; the record and the inputs."""
    import torch

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import layers as LY
    dt = getattr(torch, c["dtype"])
    b, sq, sk, kv, g, dh = (c[k] for k in ("b", "sq", "sk", "kv", "g", "dh"))
    q = torch.randn(b, sq, kv, g, dh, device="cuda", generator=gen).to(dt)
    k = torch.randn(b, sk, kv, dh, device="cuda", generator=gen).to(dt)
    v = torch.randn(b, sk, kv, dh, device="cuda", generator=gen).to(dt)
    kw = dict(causal=c["causal"], softcap=c["softcap"])
    tol = FA_TOL[c["dtype"]]
    splits = FA.kernel_splits(q, k)
    y = FA.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    yp = FA.flash_attention_plain(q, k, v, **kw)
    err = (y.float() - yp.float()).abs().max().item()
    ok = within(y, yp, tol) and y.dtype == dt and bool(
        torch.isfinite(y.float()).all())
    # bf16 also passes FA_BF16_REL_L2 against each plain version.
    l2_limit = FA_BF16_REL_L2 if c["dtype"] == "bfloat16" else float("inf")
    l2 = rel_l2(y, yp)
    ok = ok and l2 <= l2_limit
    split_err = split_l2 = None
    if splits > 1:
        ysp = FA.flash_attention_split_plain(q, k, v, splits=splits, **kw)
        split_err = (y.float() - ysp.float()).abs().max().item()
        split_l2 = rel_l2(y, ysp)
        ok = ok and within(y, ysp, tol) and split_l2 <= l2_limit
    big = sq * sk * b * kv * g > 1e8
    reps, iters = 5, (3 if big else 20)
    ms = time_ms(lambda: FA.flash_attention(q, k, v, **kw), reps=reps,
                 iters=iters)
    plain_ms = time_ms(lambda: FA.flash_attention_plain(q, k, v, **kw),
                       reps=3, iters=1 if big else 5)
    queued = queued_ms(lambda: FA.flash_attention(q, k, v, **kw))
    rec = dict(c, splits=splits, split_err=split_err, max_abs_err=err,
               rel_l2=l2, split_rel_l2=split_l2,
               max_abs_plain=yp.float().abs().max().item(), ms=ms,
               queued_ms=queued, plain_ms=plain_ms, library_ms=None)
    combine = ""
    if splits > 1:
        # The combine's share of the device time of a call (torch.profiler
        # over 10 calls: its sums can read low, the ratio is what is kept).
        per_kernel = {name: t for name, (_, t) in kernel_device_ms(
            lambda: FA.flash_attention(q, k, v, **kw),
            FA_KERNEL_NAMES).items()}
        busy = sum(per_kernel.values())
        comb = sum(t for name, t in per_kernel.items() if "fa_combine" in name)
        rec.update(profile_kernels=per_kernel, combine_ms=comb,
                   combine_share=comb / busy if busy else None)
        combine = (f" combine {comb * 1e3:.2f} of {busy * 1e3:.2f} us a call "
                   f"(torch.profiler)" if busy else
                   " combine: not measured (torch.profiler saw no kernel)")
    if c["softcap"] is None:
        ys = sdpa(q, k, v, c["causal"])
        rec["library_err"] = (ys.float() - yp.float()).abs().max().item()
        rec["library_ms"] = time_ms(lambda: sdpa(q, k, v, c["causal"]),
                                    reps=reps, iters=iters)
        rec["library_queued_ms"] = queued_ms(
            lambda: sdpa(q, k, v, c["causal"]))
        if not within(ys, yp, tol):
            fail(f"{c['label']}: SDPA is {rec['library_err']} from the "
                 f"plain version, beyond {tol} (not the same function?)")
    if c.get("vs"):
        pos = torch.arange(sq, device="cuda").expand(b, sq)
        lm = LY.attention(q, k, v, pos, pos, window=None, softcap=None,
                          impl=c["vs"])
        rec["lm_err"] = (y.float() - lm.float()).abs().max().item()
        lm_tol = LM_ATTN_TOL if c["dtype"] == "float32" else tol
        ok = ok and within(y, lm, lm_tol)
    ops, nbytes = fa_work(c)
    rec.update(bound_fields(h100.rate_work(
        nbytes, ops, h100.PEAK_FP32_FLOPS if c["dtype"] == "float32"
        else h100.PEAK_BF16_FLOPS)))
    lib = "-" if rec["library_ms"] is None else \
        f"{rec['library_ms']:.4f} ms (queued {rec['library_queued_ms']:.4f})"
    print(f"  {c['label']:<38} splits={splits} err={err:.2e} "
          f"rel_l2={l2:.2e}"
          + (f" vs split_plain {split_err:.2e} rel_l2={split_l2:.2e}"
             if split_err is not None else "")
          + f" kernel={ms:.4f} ms (queued {queued:.4f} ms) "
          f"plain={plain_ms:.4f} ms sdpa={lib} "
          f"bound={rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
          f"{ops / ms / 1e9:.2f} TFLOP/s)"
          + (f" vs {c['vs']} {rec['lm_err']:.2e}" if c.get("vs") else "")
          + combine + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{c['label']}: max|kernel - plain| = {err}, vs the LM's "
             f"attention {rec.get('lm_err')}, vs the split plain version "
             f"{split_err} (tolerance {tol}); relative L2 {l2}, vs the "
             f"split plain version {split_l2} (limit {l2_limit})")
    return rec, (q, k, v, y)


def flash_phase(record: dict, gen) -> dict:
    """Phase 12; returns the kernels-line row of kernel 6."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA
    lib = FA.load_kernel()
    spills, entry = {}, None
    for line in _build.build_log.get("flash_attention", "").splitlines():
        if "entry function" in line or "registers" in line \
                or "spill" in line:
            print(f"  ptxas: {line.strip()}")
        if "entry function" in line:
            entry = line.split("'")[1]
        elif "spill stores" in line and entry:
            spills[entry] = int(line.split("bytes spill stores")[0]
                                .split(",")[-1])
    # The bf16 instance at Dh 256 keeps a 16 x 256 fp32 accumulator a
    # warp: 128 registers a thread.
    tc256 = [n for n in spills if "fa_tc_kernelILi256E" in n]
    record["flash_bf16_dh256_spill_bytes"] = [spills[n] for n in tc256]
    print(f"  ptxas: the bf16 instance at Dh 256 spills "
          f"{[spills[n] for n in tc256]} bytes (stores)")
    for dtype, name in ((0, "float32"), (1, "bfloat16")):
        smem = {dh: lib.fa_smem_bytes(dh, dtype)
                for dh in (16, 20, 32, 64, 128, 256)}
        print(f"  shared memory per block, {name}: {smem}")
    cases = fa_cases()
    results = [check_flash(c, gen) for c in cases]
    record["flash_shapes"] = [r for r, _ in results]
    # The main path: every case once through the entry point.
    torch.cuda.synchronize()
    reset_counts()
    for (rec, (q, k, v, y)) in results:
        out = FA.flash_attention(q, k, v, causal=rec["causal"],
                                 softcap=rec["softcap"])
        if not torch.equal(out, y):
            fail(f"{rec['label']}: the entry point's output differs from "
                 f"the checked one")
    torch.cuda.synchronize()
    counts = read_counts()
    want = {name: 0 for name in counts}
    want["flash_attention"] = len(cases)
    print(f"  entry point: launches {counts}")
    if counts != want:
        fail(f"the flash-attention run launched {counts}; expected {want}")
    shapes = record["flash_shapes"]
    bound = h100.total((r["work"], 1) for r in shapes)
    # SDPA computes no softcap: ``library_ms`` sums the cases without one,
    # and ``ms_where_library`` the kernel's time on the same cases; the
    # bf16 totals are the LM's serving dtype, where SDPA runs its flash
    # path (fp32 with GQA takes its math path).
    with_lib = [r for r in shapes if r["library_ms"] is not None]
    bf16_lib = [r for r in with_lib if r["dtype"] == "bfloat16"
                and not r.get("decode")]
    decode = [r for r in shapes if r.get("decode")]
    run = dict(ms=sum(r["ms"] for r in shapes),
               plain_ms=sum(r["plain_ms"] for r in shapes),
               library_ms=sum(r["library_ms"] for r in with_lib),
               library_cases=len(with_lib),
               ms_where_library=sum(r["ms"] for r in with_lib),
               bf16_cases=len(bf16_lib),
               bf16_ms=sum(r["ms"] for r in bf16_lib),
               bf16_queued_ms=sum(r["queued_ms"] for r in bf16_lib),
               bf16_library_ms=sum(r["library_ms"] for r in bf16_lib),
               bf16_library_queued_ms=sum(r["library_queued_ms"]
                                          for r in bf16_lib),
               decode_cases=len(decode),
               decode_ms=sum(r["ms"] for r in decode),
               decode_queued_ms=sum(r["queued_ms"] for r in decode),
               decode_plain_ms=sum(r["plain_ms"] for r in decode),
               decode_library_ms=sum(r["library_ms"] for r in decode
                                     if r["library_ms"] is not None),
               bound_ms=bound["bound_s"] * 1e3,
               bf16_max_rel_l2=max(r["rel_l2"] for r in shapes
                                   if r["dtype"] == "bfloat16"),
               bf16_max_split_rel_l2=max(
                   (r["split_rel_l2"] for r in shapes
                    if r["dtype"] == "bfloat16" and r["split_rel_l2"]
                    is not None), default=None))
    record["run_flash_attention"] = run
    print(f"  flash_attention per entry-point run ({len(cases)} cases): "
          f"kernel {run['ms']:.3f} ms, plain {run['plain_ms']:.3f} ms, "
          f"bound {run['bound_ms']:.4f} ms; on the {len(with_lib)} cases "
          f"SDPA computes: kernel {run['ms_where_library']:.3f} ms, SDPA "
          f"{run['library_ms']:.3f} ms; on the {len(bf16_lib)} bf16 ones: "
          f"kernel {run['bf16_ms']:.3f} ms (queued "
          f"{run['bf16_queued_ms']:.3f} ms), SDPA "
          f"{run['bf16_library_ms']:.3f} ms (queued "
          f"{run['bf16_library_queued_ms']:.3f} ms); on the {len(decode)} "
          f"decode-like split cases: kernel {run['decode_ms']:.4f} ms "
          f"(queued {run['decode_queued_ms']:.4f} ms), "
          f"plain {run['decode_plain_ms']:.4f} ms, SDPA "
          f"{run['decode_library_ms']:.4f} ms; bf16 relative L2 at most "
          f"{run['bf16_max_rel_l2']:.2e} vs plain, "
          f"{run['bf16_max_split_rel_l2']:.2e} vs split_plain (limit "
          f"{FA_BF16_REL_L2})")
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:113",
        "launches": counts["flash_attention"],
        "max_abs_err": max(r["max_abs_err"] for r in shapes),
        "ms": run["ms"],
        "plain_ms": run["plain_ms"],
        "bound_ms": run["bound_ms"],
        "bound_by": bound["bound_by"],
        "library_ms": run["library_ms"],
        **{key: run[key] for key in ("library_cases", "ms_where_library",
                                     "bf16_cases", "bf16_ms",
                                     "bf16_library_ms", "decode_cases",
                                     "decode_ms")},
    }


# ---------------------------------------------------------------------------
# Phase 13: LM serving at full width
# ---------------------------------------------------------------------------

LM_ARCH = "tinyllama-1.1b"
LM_RTOL = 2e-2              # bf16 served logits vs teacher-forced forward
LM_EXCESS = 2e-3            # served vs teacher-forced bf16, distance to fp32
LM_BF16_MAX = 4e-2          # bf16 logits vs the fp32 forward (PERF.md §2)
LM_PROMPTS = [128, 256, 384, 512, 640, 768, 896, 1024]
LM_NEW = 32
LM_CACHE = 2048


class recording:
    """Within the block the serving engine's prefill and decode steps keep
    their logits (host copies): ``prefills`` in admission order,
    ``decodes`` as (uids of the active slots, logits)."""

    def __init__(self, engine):
        self.engine = engine
        self.prefills, self.decodes = [], []

    def __enter__(self):
        from repro_torch.serve import engine as E
        self.saved = (E.prefill, E.decode_step)
        pre, dec = self.saved

        def prefill(*a, **kw):
            logits, caches = pre(*a, **kw)
            self.prefills.append(logits[0].float().cpu())
            return logits, caches

        def decode_step(*a, **kw):
            logits, caches = dec(*a, **kw)
            self.decodes.append(([r.uid if r else None
                                  for r in self.engine.active],
                                 logits.float().cpu()))
            return logits, caches
        E.prefill, E.decode_step = prefill, decode_step
        return self

    def __exit__(self, *exc):
        from repro_torch.serve import engine as E
        E.prefill, E.decode_step = self.saved

    def served(self, reqs) -> dict:
        """uid -> (n_tokens, V) logits behind each served token."""
        out = {r.uid: [p[None]] for r, p in zip(reqs, self.prefills)}
        for uids, logits in self.decodes:
            for slot, uid in enumerate(uids):
                if uid is not None:
                    out[uid].append(logits[slot][None])
        return {uid: __import__("torch").cat(rows) for uid, rows in
                out.items()}


def busy_share(fn) -> tuple[float, float, int, list]:
    """torch.profiler over one call of ``fn`` (after a warm-up): (host
    wall ms, device busy ms, kernel launches, device entries by time as
    (name, ms)); device busy sums the device-side events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall = (time.monotonic() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in events) / 1e3
    launches = sum(e.count for e in prof.key_averages()
                   if "LaunchKernel" in e.key)
    return wall, busy, launches, [(e.key, dev_us(e) / 1e3) for e in events]


def hold_served_logits(params, cfg, reqs, served: dict,
                       cap: float) -> tuple[list, int, int]:
    """Hold each request's served bf16 logits (``recording.served``) to a
    teacher-forced ``forward(mode="train")`` over prompt + output in bf16
    and in fp32 (relative norms), and the served tokens to the
    teacher-forced argmax where its top-2 margin is clear; fail beyond
    the gates.  Returns (rows, positions checked, positions under the
    margin)."""
    import numpy as np
    import torch

    from repro_torch.models import transformer as TF

    # bf16 at full depth: the served and teacher-forced bf16 logits (the
    # same tokens through other shapes) differ by ~2e-2 (relative norm),
    # and each lies ~3e-2 from the fp32 forward (PERF.md).  So the served
    # logits are held to the bf16 path's own error: no farther from the
    # teacher-forced bf16 logits than those are from the fp32 forward on
    # the same params, and as far from that fp32 forward as the
    # teacher-forced bf16 logits are, give or take LM_EXCESS; and the bf16
    # path's own error is capped at ``cap``, above its readings.
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    rows = []
    under, checked = 0, 0
    with torch.inference_mode():
        for r in reqs:
            seq = torch.as_tensor(np.concatenate(
                [r.prompt, np.asarray(r.output[:-1], np.int32)]),
                dtype=torch.long, device="cuda")[None]
            p = len(r.prompt)
            tf, ex = (TF.forward(params, c, tokens=seq, mode="train")[0]
                      [0, p - 1:].float().cpu() for c in (cfg, cfg32))
            got = served[r.uid]
            d = dict(uid=r.uid, prompt=p,
                     served_tf=((got - tf).norm() / tf.norm()).item(),
                     served_fp32=((got - ex).norm() / ex.norm()).item(),
                     tf_fp32=((tf - ex).norm() / ex.norm()).item())
            rows.append(d)
            top2 = tf.topk(2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > LM_RTOL * tf.abs().amax(-1)
            agree = tf.argmax(-1) == torch.as_tensor(r.output)
            under += int((~sure).sum())
            checked += int(sure.sum())
            print(f"  request {r.uid} (prompt {p}): served vs teacher-forced "
                  f"bf16 {d['served_tf']:.3e}; vs the fp32 forward: served "
                  f"{d['served_fp32']:.3e}, teacher-forced bf16 "
                  f"{d['tf_fp32']:.3e}")
            if d["served_tf"] > max(LM_RTOL, d["tf_fp32"]) \
                    or abs(d["served_fp32"] - d["tf_fp32"]) > LM_EXCESS \
                    or max(d["tf_fp32"], d["served_fp32"]) > cap:
                fail(f"request {r.uid}: the served logits stray beyond the "
                     f"bf16 path's own error: {d}")
            if not bool(agree[sure].all()):
                bad = (~agree & sure).nonzero().flatten().tolist()
                fail(f"request {r.uid}: argmax of the teacher-forced "
                     f"logits disagrees with the served token at {bad}")
    print(f"  served vs teacher-forced bf16 logits: worst relative norm "
          f"{max(d['served_tf'] for d in rows):.3e} (gate: the bf16 "
          f"path's own error, worst {max(d['tf_fp32'] for d in rows):.3e} "
          f"from fp32, or {LM_RTOL}); the engine's "
          f"excess over teacher-forced bf16, vs fp32: worst "
          f"{max(abs(d['served_fp32'] - d['tf_fp32']) for d in rows):.1e} "
          f"(<= {LM_EXCESS}); bf16 vs fp32 at most {cap}; argmax equal at "
          f"all {checked} positions with a top-2 margin above {LM_RTOL} * "
          f"max|logit|, {under} under it")
    return rows, checked, under


def lm_phase(record: dict) -> None:
    """Phase 13."""
    import numpy as np
    import torch

    from repro_torch.launch import serve as launch
    from repro_torch.models import registry as reg
    from repro_torch.models import transformer as TF
    from repro_torch.serve import Request, ServeConfig, ServingEngine

    cfg = reg.get(LM_ARCH).config
    rec = record["lm"] = {"arch": LM_ARCH,
                          "params": cfg.param_count()}
    print(f"  config {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.kv_heads} KV, Dh {cfg.hd}, vocab "
          f"{cfg.vocab}, {cfg.param_count() / 1e9:.3f}B params (fp32), "
          f"compute {cfg.dtype}")

    # (a) the launcher's LM branch with its defaults.
    args = launch.build_parser().parse_args(
        ["--arch", LM_ARCH, "--device", "cuda", "--seed", "0"])
    reset_counts()
    t0 = time.monotonic()
    engine, steps, seconds = launch.serve_lm(cfg, args)
    rec["launcher_wall_s"] = time.monotonic() - t0
    rec["launcher_serve_s"] = seconds
    counts = read_counts()
    print(launch.report_lm(engine, steps, seconds))
    print(f"  serve_lm: {rec['launcher_wall_s']:.2f} s in all, of which "
          f"{rec['launcher_wall_s'] - seconds:.2f} s drawing the params on "
          f"the CPU and moving them; launches {counts}")
    done = sorted((r.uid, len(r.output)) for r in engine.completed)
    if done != [(i, args.max_new_tokens) for i in range(args.requests)]:
        fail(f"serve_lm completed {done}")
    if any(counts.values()):
        fail(f"the LM path launched a kernel: {counts}")
    params = engine.params
    del engine

    # (b) the engine at long prompts, its logits kept.
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab, n).astype(np.int32)
               for n in LM_PROMPTS]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = ServingEngine(params, cfg, ServeConfig(slots=BATCH,
                                                    cache_len=LM_CACHE),
                           device="cuda")
    reqs = [Request(uid=i, prompt=p, max_new_tokens=LM_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    with recording(engine) as log:
        t0 = time.monotonic()
        engine.run_until_drained()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    rec["engine_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    toks = sum(len(r.output) for r in engine.completed)
    rec.update(engine_s=wall, tokens=toks, tokens_per_s=toks / wall)
    print(f"  engine: {len(engine.completed)} requests / {toks} tokens in "
          f"{wall:.3f} s ({toks / wall:.1f} tok/s, prefills included); "
          f"peak memory {rec['engine_peak_gb']:.2f} GB")
    if sorted((r.uid, len(r.output)) for r in engine.completed) \
            != [(i, LM_NEW) for i in range(len(prompts))]:
        fail("the engine did not serve every request its token count")
    rows, checked, under = hold_served_logits(params, cfg, reqs,
                                              log.served(reqs), LM_BF16_MAX)
    rec.update(logits=rows, argmax_checked=checked,
               argmax_under_margin=under)

    # Where the time goes: prefill per prompt length, the decode step.
    prefill_ms = {}
    with torch.inference_mode():
        for p in prompts:
            t = torch.as_tensor(p, dtype=torch.long, device="cuda")[None]
            prefill_ms[len(p)] = time_ms(
                lambda: TF.prefill(params, cfg, t, cache_len=LM_CACHE),
                reps=3, iters=1)
        caches, pos = engine.caches, torch.full((BATCH,), 1100,
                                                device="cuda")
        tok = torch.zeros(BATCH, dtype=torch.long, device="cuda")
        decode_ms = time_ms(lambda: TF.decode_step(params, cfg, tok, caches,
                                                   pos), reps=5, iters=5)
        steps = 8
        wall_ms, busy_ms, n_launch, top = busy_share(lambda: [
            TF.decode_step(params, cfg, tok, caches, pos)[0].argmax(-1)
            .tolist() for _ in range(steps)])
    cast_ms = sum(ms for key, ms in top if "copy" in key.lower())
    top = [(key[:70], round(ms / steps, 4)) for key, ms in top[:8]]
    rec.update(prefill_ms=prefill_ms, decode_ms=decode_ms,
               decode_wall_ms=wall_ms / steps, decode_busy_ms=busy_ms / steps,
               decode_idle=1 - busy_ms / wall_ms,
               decode_copy_ms=cast_ms / steps, decode_top=top,
               decode_launches=n_launch / steps)
    print(f"  prefill (1 prompt, CUDA events): "
          f"{ {n: round(ms, 3) for n, ms in prefill_ms.items()} } ms")
    print(f"  decode step (4 slots, cache {LM_CACHE}): {decode_ms:.3f} ms "
          f"(CUDA events); under torch.profiler {wall_ms / steps:.3f} ms "
          f"wall, {busy_ms / steps:.3f} ms device busy, idle "
          f"{1 - busy_ms / wall_ms:.1%}; {n_launch / steps:.0f} kernel "
          f"launches a step; dtype casts and copies {cast_ms / steps:.3f} "
          f"ms a step")
    print(f"  decode step's top device entries (ms a step): {top[:6]}")
    del engine, caches

    # (c) fp32: the engine equals naive greedy decoding.
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    engine = ServingEngine(params, cfg32, ServeConfig(slots=BATCH,
                                                      cache_len=LM_CACHE),
                           device="cuda")
    for i, p in enumerate(prompts[:4]):
        engine.submit(Request(uid=i, prompt=p, max_new_tokens=LM_NEW))
    t0 = time.monotonic()
    engine.run_until_drained()
    with torch.inference_mode():
        for r in engine.completed:
            cur = torch.as_tensor(r.prompt, dtype=torch.long,
                                  device="cuda")[None]
            ref = []
            for _ in range(len(r.output)):
                logits, _, _ = TF.forward(params, cfg32, tokens=cur,
                                          mode="train")
                nxt = int(logits[0, -1].argmax())
                ref.append(nxt)
                cur = torch.cat([cur, torch.tensor([[nxt]], device="cuda")],
                                1)
            if r.output != ref:
                fail(f"fp32 request {r.uid}: served {r.output} but greedy "
                     f"decoding gives {ref}")
    rec["fp32_greedy_s"] = time.monotonic() - t0
    print(f"  fp32: {len(engine.completed)} requests x {LM_NEW} tokens "
          f"equal naive greedy decoding token for token "
          f"({rec['fp32_greedy_s']:.1f} s)")
    if any(read_counts().values()):
        fail(f"the LM path launched a kernel: {read_counts()}")


def per_run(shapes: list[dict], steps_per_bucket: dict, launches: int,
            what: str) -> tuple[dict, str]:
    """Sum of each main-path shape's time (and ``core.h100`` work) times
    its launches in the served run, bounded as one work; fails unless the
    shapes account for every launch."""
    for r in shapes:
        r["launches_in_run"] = sum(n * steps_per_bucket.get(b, 0)
                                   for b, n in r["per_step"].items())
    if sum(r["launches_in_run"] for r in shapes) != launches:
        fail(f"{what}: the shapes account for "
             f"{sum(r['launches_in_run'] for r in shapes)} launches, the "
             f"served run made {launches}")
    run = {k: sum(r[k] * r["launches_in_run"] for r in shapes)
           for k in ("ms", "plain_ms")}
    run.update(bound_fields(h100.total((r["work"], r["launches_in_run"])
                                       for r in shapes)))
    return run, run["bound_by"]


def fwd_training(shapes: list[dict], launches: int, steps: int, what: str,
                 device_step_ms: float) -> dict:
    """A forward kernel's training run for the kernels line: its launches,
    the phase-3 (phase-9) shape times times their DCLs a step over
    ``steps`` steps, per step, and the step's profiler time of the
    kernel."""
    run, by = per_run(shapes, {"train": steps}, launches, what)
    return dict(launches=launches, steps=steps, ms=run["ms"],
                plain_ms=run["plain_ms"], bound_ms=run["bound_ms"],
                bound_fp32_ms=run["bound_fp32_ms"], bound_by=by,
                step_ms=run["ms"] / steps,
                step_bound_ms=run["bound_ms"] / steps,
                step_bound_fp32_ms=run["bound_fp32_ms"] / steps,
                device_step_ms=device_step_ms)


BF16_RTOL = 2.0 ** -7        # one bf16 step at the largest output


def bf16_case(case: dict, gen) -> dict:
    """Phase 14 on one geometry: kernels 1a and 4 in bf16 against their
    plain versions on the card (one bf16 step, two calls equal, shared
    memory against the chooser's mirror), timed back to back and queued
    beside the fp32 kernel on the same inputs; kernel 2 in bf16 timed the
    same way, and the plain backward that the entry-point run's gradients
    are held to.  Returns the record (inputs under ``inputs``)."""
    import torch

    from repro_torch.core.tiling import (bwd_dw_smem_bytes, bwd_smem_bytes,
                                         out_hw, smem_bytes)
    from repro_torch.kernels import deform_conv_bwd as BW
    from repro_torch.kernels import deform_conv_fused as F
    from repro_torch.kernels import plan

    n, h, w, c, m = case["n"], case["h"], case["w"], case["c"], case["m"]
    s, d, b = case["stride"], case["dilation"], case.get("bound", B)
    k2 = K * K
    ho, wo = out_hw(h, w, kernel_size=K, stride=s, dilation=d)
    x = torch.randn(n, h, w, c, device="cuda", generator=gen).bfloat16()
    off = (torch.randn(n, ho, wo, 2 * k2, device="cuda", generator=gen)
           * 1.5).bfloat16()
    wd = (torch.randn(k2, c, m, device="cuda", generator=gen)
          / (k2 * c) ** 0.5).bfloat16()
    g = torch.randn(n, ho, wo, m, device="cuda", generator=gen).bfloat16()
    f32 = [t.float() for t in (x, off, wd, g)]
    geom = dict(kernel_size=K, stride=s, dilation=d, offset_bound=b)
    lib = F.load_kernel()
    # Bytes at two an element (offsets bf16 too).
    sizes = dict(kernel_size=K, stride=s, dilation=d, itemsize=2,
                 offset_itemsize=2)
    rec = dict(case, ho=ho, wo=wo, inputs=(x, off, wd, g))

    def prepare(xx, oo, ww, dataflow):
        spec = plan.DCSpec(K, s, d, b, tile_c=case.get("tile_c"),
                           dataflow=dataflow)
        if dataflow == "zero_copy":
            th, tw, tc, tm = plan.spec_tiles(spec, xx, oo, ww)
            src, op, wt = plan.zerocopy_inputs(spec, xx, oo, ww, th, tw, tc)
            fns = (F.deform_conv_fused_zerocopy,
                   F.deform_conv_fused_zerocopy_plain)
        else:
            th, tw, tc, tm = plan.banded_tiles(spec, xx, oo, m,
                                               dtype="banded")
            src, op = plan.banded_inputs(spec, xx, oo, th)
            wt = plan.tile_weights(ww, tc)
            fns = (F.deform_conv_fused_banded,
                   F.deform_conv_fused_banded_plain)
        kw = dict(geom, tile_h=th, tile_w=tw, tile_c=tc, tile_m=tm)
        return fns, (src, op, wt), kw

    for dataflow in ("zero_copy", "banded"):
        (fn, plain), args, kw = prepare(x, off, wd, dataflow)
        y = fn(*args, **kw)
        torch.cuda.synchronize()
        repeatable = torch.equal(y, fn(*args, **kw))
        yp = plain(*args, **kw)
        err = (y.float() - yp.float()).abs().max().item()
        scale = yp.float().abs().max().item()
        unequal = (y != yp).float().mean().item()
        th, tw, tc, tm = (kw["tile_h"], kw["tile_w"], kw["tile_c"],
                          kw["tile_m"])
        smem_c = lib.dcf_smem_bytes(K, s, d, math.ceil(b), th, tw, tc, 2)
        smem_py = smem_bytes(th, tw, tc, itemsize=2, **geom)
        inst = fwd_instance(lib, args[0], args[2], n=n, ho=args[1].shape[1],
                            wo=wo, c=c, m=m, s=s, d=d, b=b, th=th, tw=tw,
                            tc=tc, tm=tm)
        ms = time_ms(lambda: fn(*args, **kw), reps=3, iters=10)
        q_ms = queued_ms(lambda: fn(*args, **kw))
        plain_ms = time_ms(lambda: plain(*args, **kw), reps=2, iters=2)
        (fn32, _), args32, kw32 = prepare(*f32[:3], dataflow)
        fp32_ms = time_ms(lambda: fn32(*args32, **kw32), reps=3, iters=10)
        if dataflow == "zero_copy":
            work = h100.forward_work(n, h, w, c, m, **sizes)
        else:
            work = h100.banded_work(n, h, w, c, m, offset_bound=b,
                                    tile_h=th, **sizes)
            same_bytes(work, (*args, y), f"bf16 banded {case['label']}")
        part = dict(tiles=[th, tw, tc, tm], smem_bytes=smem_c, instance=inst,
                    repeatable=repeatable, max_abs_err=err,
                    max_abs_plain=scale, unequal_share=unequal, ms=ms,
                    queued_ms=q_ms, plain_ms=plain_ms, fp32_ms=fp32_ms,
                    **bound_fields(work))
        rec[dataflow] = part
        ok = err <= BF16_RTOL * scale and repeatable and smem_c == smem_py \
            and unequal <= BF16_UNEQUAL_MAX
        print(f"  {case['label']:<28} {dataflow:<9} n={n} tiles {th}x{tw} "
              f"tc={tc} tm={tm} smem={smem_c} err={err:.3e} "
              f"(max|plain|={scale:.3f}, {unequal:.2e} unequal) kernel="
              f"{ms:.4f} ms queued={q_ms:.4f} ms fp32 kernel={fp32_ms:.4f} "
              f"ms plain={plain_ms:.3f} ms bound={part['bound_ms']:.4f} ms "
              f"({part['bound_by']}; {part['bound_ms'] / ms:.1%} of "
              f"kernel, {part['bound_ms'] / q_ms:.1%} of queued) "
              f"{'ok' if ok else 'FAIL'}\n"
              f"    instance: {inst['lanes']} pixel lanes, {inst['tiles']} "
              f"tiles x {inst['m_tiles']} M tiles x {inst['c_groups']} C "
              f"groups, {inst['loads']}, {inst['blocks_per_sm']} blocks an "
              f"SM; two calls torch.equal: {repeatable}")
        if smem_c != smem_py:
            fail(f"bf16 {case['label']} {dataflow}: shared memory {smem_c} "
                 f"(kernel) != {smem_py} (chooser)")
        if err > BF16_RTOL * scale:
            fail(f"bf16 {case['label']} {dataflow}: max|kernel - plain| = "
                 f"{err} exceeds 2^-7 * {scale}")
        if unequal > BF16_UNEQUAL_MAX:
            fail(f"bf16 {case['label']} {dataflow}: {unequal:.2e} of the "
                 f"outputs differ from the plain version's, more than "
                 f"{BF16_UNEQUAL_MAX}")
        if not repeatable:
            fail(f"bf16 {case['label']} {dataflow}: two calls differ")

    # Kernel 2 at the backward's own tiles (plan.bounded_backward's).
    spec = plan.DCSpec(K, s, d, b, tile_c=case.get("tile_c"))

    def bwd_args(xx, oo, ww):
        th, tw, tc, _ = plan.spec_tiles(spec, xx, oo, ww, dtype="fp32_bwd")
        xp, op, wt = plan.zerocopy_inputs(spec, xx, oo, ww, th, tw, tc)
        return (xp, op, wt), dict(geom, tile_h=th, tile_w=tw, tile_c=tc)

    (xp, op, wt), kwb = bwd_args(x, off, wd)

    def bwd():
        return BW.deform_conv_bwd_zerocopy(xp, op, g, wt, **kwb)
    got = bwd()
    torch.cuda.synchronize()
    dxp, doff, dwt = BW.deform_conv_bwd_zerocopy_plain(xp, op, g, wt, **kwb)
    p0 = d * (K // 2) + math.ceil(b)
    want = (dxp[:, p0:p0 + h, p0:p0 + w], doff,
            plan.untile_weights(dwt, K).bfloat16())
    # d_input and d_offsets (rounded to bf16) within one bf16 step,
    # d_weights (fp32) within phase 7's BWD_RTOL.
    rel = [(a.float() - r.float()).abs().max().item()
           / r.float().abs().max().item()
           for a, r in zip(got, (dxp, doff, dwt))]
    k_err = max(rel[:2])
    ms = time_ms(bwd, reps=3, iters=3)
    q_ms = queued_ms(bwd, calls=5)
    plain_ms = time_ms(lambda: BW.deform_conv_bwd_zerocopy_plain(
        xp, op, g, wt, **kwb), reps=1, iters=1)
    (xp32, op32, wt32), kwb32 = bwd_args(*f32[:3])
    g32 = f32[3]
    fp32_ms = time_ms(lambda: BW.deform_conv_bwd_zerocopy(
        xp32, op32, g32, wt32, **kwb32), reps=3, iters=3)
    lib_b = BW.load_kernel()
    th, tw, tc = kwb["tile_h"], kwb["tile_w"], kwb["tile_c"]
    smem_c = (lib_b.dcb_smem_bytes(K, s, d, math.ceil(b), th, tw, tc, 2),
              lib_b.dcb_dw_smem_bytes(K, s, d, math.ceil(b), th, tw, tc, 2))
    smem_py = (bwd_smem_bytes(th, tw, tc, itemsize=2, **geom),
               bwd_dw_smem_bytes(th, tw, tc, itemsize=2, **geom))
    kplan = BW.bwd_plan(n, ho, wo, c, m, kernel_size=K, tile_h=th,
                        tile_w=tw, tile_c=tc)
    vec = BW.staging_vec(xp, g, wt, tc)
    kplan["loads"] = ("W/g 8-byte" if vec & 1 else "W/g element-wise") \
        + band_loads(vec, 2)
    # Its products: dP one bf16 pass, dw two tf32 passes (P split, g
    # exact in tf32).
    part = dict(tiles=[th, tw, tc], smem_bytes=smem_c, plan=kplan,
                kernel_rel_err=k_err, dw_rel_err=rel[2], ms=ms,
                queued_ms=q_ms, plain_ms=plain_ms, fp32_ms=fp32_ms,
                **bound_fields(h100.backward_work(n, h, w, c, m, **sizes)))
    rec["backward"] = part
    rec["plain_grads"] = want
    print(f"  {case['label']:<28} kernel 2  tiles {th}x{tw} tc={tc} smem="
          f"{smem_c} kernel vs plain {k_err:.2e} (relative, larger of dx, "
          f"d_off) dw {rel[2]:.2e} kernel={ms:.4f} ms queued={q_ms:.4f} ms "
          f"fp32 kernel={fp32_ms:.4f} ms plain={plain_ms:.3f} ms bound="
          f"{part['bound_ms']:.4f} ms ({part['bound_by']}, dP one bf16 "
          f"pass, dw two tf32; {part['bound_ms'] / ms:.1%} of kernel)\n"
          f"    plan: C groups {kplan['c_groups']} x {kplan['tiles']} tiles, "
          f"d_weights grid {kplan['dw_grid']} x {kplan['dw_splits']} splits, "
          f"{kplan['lanes']} pixel lanes, {kplan['warp_tiles']} mma tiles a "
          f"warp, {kplan['loads']}")
    if smem_c != smem_py:
        fail(f"bf16 backward {case['label']}: shared memory {smem_c} "
             f"(kernel) != {smem_py} (chooser)")
    if k_err > BF16_RTOL:
        fail(f"bf16 backward {case['label']}: kernel vs plain {k_err} "
             f"exceeds 2^-7")
    if rel[2] > BWD_RTOL:
        fail(f"bf16 backward {case['label']}: d_weights (fp32) vs plain "
             f"{rel[2]} exceeds {BWD_RTOL}")
    return rec


def bf16_entry_run(cases: list[dict]) -> dict[str, int]:
    """The bf16 main path as a user drives it: per case and dataflow one
    ``ops.deform_conv`` on the case's bf16 inputs and one gradient of
    sum(y * g) through it, with every count set to 0 just before the run
    and read just after.  Each forward must launch exactly one bf16
    kernel of its dataflow and no fp32 forward kernel, each gradient one
    bf16 kernel 2, and d_x, d_offsets and d_w must lie within one bf16
    step of the plain backward."""
    import torch

    from repro_torch.kernels import ops

    reset_counts()
    fwd_of = {"zero_copy": "deform_conv_fused_bf16",
              "banded": "deform_conv_banded_bf16"}
    for rec in cases:
        x, off, wd, g = rec["inputs"]
        for dataflow in ("zero_copy", "banded"):
            leaves = [t.clone().requires_grad_(True) for t in (x, off, wd)]
            before = read_bf16_counts()
            y = ops.deform_conv(*leaves, offset_bound=rec.get("bound", B),
                                stride=rec["stride"],
                                dilation=rec["dilation"],
                                tile_c=rec.get("tile_c"), dataflow=dataflow)
            mid = read_bf16_counts()
            grads = torch.autograd.grad((y.float() * g.float()).sum(),
                                        leaves)
            torch.cuda.synchronize()
            after = read_bf16_counts()
            want_fwd = {k: before[k] + (k == fwd_of[dataflow])
                        for k in before}
            if mid != want_fwd or y.dtype != torch.bfloat16:
                fail(f"bf16 {rec['label']} {dataflow}: ops.deform_conv "
                     f"launched {before} -> {mid} ({y.dtype})")
            if after != dict(mid, deform_conv_bwd_bf16=mid[
                    "deform_conv_bwd_bf16"] + 1):
                fail(f"bf16 {rec['label']} {dataflow}: the gradient "
                     f"launched {mid} -> {after}")
            errs = {}
            for name, a, r in zip(("d_x", "d_offsets", "d_w"), grads,
                                  rec["plain_grads"]):
                scale = r.float().abs().max().item()
                errs[name] = (a.float() - r.float()).abs().max().item() \
                    / scale
                if a.dtype != torch.bfloat16 or errs[name] > BF16_RTOL:
                    fail(f"bf16 {rec['label']} {dataflow} {name}: "
                         f"{errs[name]:.3e} of max|plain| ({a.dtype})")
            rec[dataflow]["grad_rel_err"] = errs
    return read_bf16_counts()


def bf16_per_path(recs: list[dict], key: str, path: str) -> dict:
    """One bf16 instance's phase-14 times summed over a path's DCLs, with
    its bound: ``train`` a training step (batch 8, 512), ``served`` one
    step of each bucket (batch 4)."""
    def dcls(r):
        cnt = r.get("per_step", {})
        return cnt.get("train", 0) if path == "train" else \
            sum(v for k, v in cnt.items() if k != "train")
    out = {k: sum(r[key][k] * dcls(r) for r in recs)
           for k in ("ms", "queued_ms", "fp32_ms")}
    out["dcls"] = sum(dcls(r) for r in recs)
    out.update(bound_fields(h100.total((r[key]["work"], dcls(r))
                                       for r in recs)))
    return out


def bf16_phase(per_step: dict, train_step: dict,
               gen) -> tuple[list[dict], list[dict]]:
    """Phase 14; returns its cases' records and the three bf16 rows of the
    kernels line."""
    cases = [dict(label=f"{h}x{w}x{c}->{m} s{s}", n=BATCH, h=h, w=w, c=c,
                  m=m, stride=s, dilation=1, per_step=cnt)
             for (h, w, c, m, s), cnt in per_step.items()]
    cases += [dict(label=f"train {h}x{w}x{c}->{m} s{s}", n=TRAIN_BATCH, h=h,
                   w=w, c=c, m=m, stride=s, dilation=1, per_step=cnt)
              for (h, w, c, m, s), cnt in train_step.items()]
    cases += [
        dict(label="ragged 17x23x64->64 s1", n=2, h=17, w=23, c=64, m=64,
             stride=1, dilation=1),
        dict(label="dilation2 20x20x64->64", n=2, h=20, w=20, c=64, m=64,
             stride=1, dilation=2),
        dict(label="ragged 15x15x32->48 s2", n=1, h=15, w=15, c=32, m=48,
             stride=2, dilation=1),
        dict(label="narrow 16x16x4->8 tc2", n=2, h=16, w=16, c=4, m=8,
             stride=1, dilation=1, tile_c=2),
    ]
    recs = [bf16_case(case, gen) for case in cases]
    if not any(r["zero_copy"]["tiles"][2] == 2 for r in recs):
        fail("phase 14 missed the narrow-chunk case")
    launches = bf16_entry_run(recs)
    print(f"  entry-point run (ops.deform_conv and its gradient, both "
          f"dataflows, {len(recs)} cases): launches {launches}")
    if launches["fp32_forward"] or any(
            launches[k] != len(recs) for k in ("deform_conv_fused_bf16",
                                               "deform_conv_banded_bf16")) \
            or launches["deform_conv_bwd_bf16"] != 2 * len(recs):
        fail(f"phase 14's run launched {launches}")
    for r in recs:
        del r["inputs"], r["plain_grads"]
    rows = []
    for name, key, source, replaces in (
            ("deform_conv_fused_bf16", "zero_copy", "deform_conv_fused.cu",
             "src/repro/kernels/band_pipeline.py:644"),
            ("deform_conv_banded_bf16", "banded", "deform_conv_fused.cu",
             "src/repro/kernels/deform_conv_fused.py:130"),
            ("deform_conv_bwd_bf16", "backward", "deform_conv_bwd.cu",
             "src/repro/kernels/deform_conv_bwd.py:304")):
        parts = [r[key] for r in recs]
        # One launch of each case in the run (two of kernel 2: one a
        # dataflow), so the run's time is the cases' times summed.
        per = 2 if key == "backward" else 1
        run = {k: per * sum(pt[k] for pt in parts)
               for k in ("ms", "queued_ms", "plain_ms", "fp32_ms")}
        bound = bound_fields(h100.total((pt["work"], per) for pt in parts))
        err_key = "kernel_rel_err" if key == "backward" else "max_abs_err"
        row = {
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces + " (bf16)",
            "launches": launches[name],
            "max_abs_err": max(pt[err_key] for pt in parts),
            "ms": run["ms"],
            "plain_ms": run["plain_ms"],
            "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"],
            "library_ms": None,
            "queued_ms": run["queued_ms"],
            "fp32_ms": run["fp32_ms"],
            "bound_note": ("dP one bf16 pass at 989 TFLOP/s, dw two tf32 "
                           "passes at 494.7 TFLOP/s" if key == "backward"
                           else "bf16 products at 989 TFLOP/s")
                          + ", or the bytes at 3.35 TB/s",
        }
        if key == "backward":
            row["max_abs_err_note"] = "larger of dx, d_off relative to " \
                                      "its max|plain|"
            row["dw_rel_err"] = max(pt["dw_rel_err"] for pt in parts)
        paths = ("train",) if key == "backward" else ("train", "served")
        for path in paths:
            row[path] = t = bf16_per_path(recs, key, path)
            what = "a training step" if path == "train" else "a served run"
            print(f"  {name} {what} ({t['dcls']} DCLs): kernel "
                  f"{t['ms']:.3f} ms (queued "
                  f"{t['queued_ms']:.3f}), fp32 kernel on the same inputs "
                  f"{t['fp32_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms "
                  f"({t['bound_by']}; {t['bound_ms'] / t['ms']:.1%} of the "
                  f"kernel)")
        rows.append(row)
        print(f"  {name} per entry-point run: {row['launches']} launches, "
              f"kernel {row['ms']:.3f} ms (queued {row['queued_ms']:.3f}), "
              f"fp32 kernel on the same inputs {row['fp32_ms']:.3f} ms, plain "
              f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}; {row['bound_ms'] / row['ms']:.1%} of "
              f"the kernel)")
    print("  no single PyTorch call computes the bounded deformable conv or "
          "its backward, so there is no library time to compare with")
    return recs, rows


# ---------------------------------------------------------------------------
# Phase 15: the operations layer (serve a checkpoint, divergence, tuning,
# chaos)
# ---------------------------------------------------------------------------

SHARE_MAX = 1.05            # no dispatch beats the card's bound
CHAOS_SEED = 20260808
CHAOS_STEPS = 8
CHAOS_REQUESTS = 10
CHAOS_STALL_S = 1.0         # fake-clock stall of slow_step
CHAOS_DEADLINE_S = 0.5      # the last two requests' deadline
TUNE_REPS = 3
TUNE_CANDIDATES = 4
HOST_TURNS = 20             # forwards a kind, in turns, for the host cost
PLANTED_MIN = 3             # a wrong recovery lands >= 3 x RESUME_RTOL off
# The kernels phase 15's path runs: 1a, 1c (the tuner's int8 sweep), 1d
# and 2 (the tuner's training objective and the chaos training).
OPS_KERNELS = ("deform_conv_fused", "deform_conv_fused_q",
               "deform_conv_chain", "deform_conv_bwd")


class FakeClock:
    """The engine's clock in the chaos run: ``slow_step`` advances it, so
    the deadlines expire the same way on every card."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def recorder_host_us(forward, n_dcl: int) -> dict:
    """The recorder's host cost at one bucket: the host's time (µs,
    ``time.perf_counter``) to enqueue one forward without a hook and
    under a fresh recorder, as the engine makes one a forward (one
    registry and tracker for all, as the engine keeps them), in
    ``HOST_TURNS`` turns, the device synchronised outside the timed
    call; and its ``flush`` after the synchronisation (the rows' close:
    metrics, span, tracker).  Medians; ``per_dispatch_us`` is the
    enqueue difference plus the flush over the forward's DCLs."""
    import torch

    from repro_torch.obs import (DispatchRecorder, DivergenceTracker,
                                 MetricsRegistry)
    registry, tracker = MetricsRegistry(), DivergenceTracker()
    turns: dict[str, list] = {"unrecorded": [], "recorded": [], "flush": []}
    for i in range(HOST_TURNS + 1):     # the first turn prices each shape
        for kind in ("unrecorded", "recorded"):
            rec = None if kind == "unrecorded" else DispatchRecorder(
                registry=registry, tracker=tracker)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward(rec)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            if rec is not None:
                t2 = time.perf_counter()
                rec.flush()
                if i:
                    turns["flush"].append((time.perf_counter() - t2) * 1e6)
            if i:
                turns[kind].append((t1 - t0) * 1e6)
    out = {k: statistics.median(v) for k, v in turns.items()}
    out["per_dispatch_us"] = (out["recorded"] - out["unrecorded"]
                              + out["flush"]) / n_dcl
    out["turns"] = turns
    return out


def results_of(engine) -> dict:
    return {r.uid: r for r in engine.completed}


def same_results(a, b, *, rtol: float | None = None) -> tuple[bool, float]:
    """Whether two requests' ``cls``/``box`` agree: ``torch.equal``, or
    within ``rtol * max|a|``; and the largest relative difference."""
    import torch
    ok, worst = True, 0.0
    for key in ("cls", "box"):
        x = torch.from_numpy(a.result[key])
        y = torch.from_numpy(b.result[key])
        scale = x.abs().max().item()
        err = (x - y).abs().max().item()
        worst = max(worst, err / scale)
        ok = ok and (torch.equal(x, y) if rtol is None
                     else err <= rtol * scale)
    return ok, worst


def serve_checkpoint(record: dict, trained, n_shapes: int,
                     n_dcl: int) -> dict:
    """Phase 15 (a) and (b): serve phase 8's checkpoint through
    ``launch.serve --ckpt`` on ``fp32_kernel`` and ``int8_chain``, against
    the same engine fed the trained params in memory; each run's
    divergence rows against their bounds."""
    import torch

    from repro_torch.configs.resnet50_dcn import CONFIG_BOUNDED
    from repro_torch.kernels import ops
    from repro_torch.launch import obs_report
    from repro_torch.launch import serve as launch
    from repro_torch.models import resnet_dcn as R
    from repro_torch.obs import (DispatchRecorder, DivergenceTracker,
                                 MetricsRegistry, dump_telemetry)

    ckpt = ROOT / "build" / "smoke_train" / "full"
    out: dict = {}
    for rung in ("fp32_kernel", "int8_chain"):
        args = launch.build_parser().parse_args(
            ["--arch", CONFIG_BOUNDED.name, "--buckets", BUCKETS,
             "--requests", "8", "--slots", str(BATCH), "--device", "cuda",
             "--seed", "0", "--quant", rung, "--ckpt", str(ckpt)])
        engine, _, seconds = launch.serve_detection(
            launch.detection_config(args), args)
        print(launch.report(engine, seconds))
        mem, _, _ = launch.serve_detection(
            CONFIG_BOUNDED, serve_args(CONFIG_BOUNDED, rung), params=trained,
            scale_table=engine.scale_table)
        got, want = results_of(engine), results_of(mem)
        bad = [u for u, r in got.items() if r.outcome != "ok"
               or r.ladder != rung or r.degraded]
        if len(got) != 8 or bad or len(want) != 8:
            fail(f"15(a) {rung}: requests not all ok from the checkpoint: "
                 f"{[(r.uid, r.outcome, r.ladder, r.error) for r in got.values()]}")
        diffs = {u: same_results(got[u], want[u]) for u in got}
        unequal = {u: err for u, (ok, err) in diffs.items() if not ok}
        print(f"  15(a) {rung}: 8/8 ok from {ckpt.relative_to(ROOT)}; "
              f"cls/box torch.equal to the in-memory params: "
              f"{not unequal}")
        if unequal:
            fail(f"15(a) {rung}: requests differ between the checkpoint "
                 f"and the trained params in memory (relative to max: "
                 f"{unequal})")

        # (b) one divergence row per DCL shape, 12 dispatches a step.
        tel = engine.telemetry()
        rows = tel["divergence"]["dispatches"]
        n_disp = sum(r["n"] for r in rows)
        shares = [r["share"] for r in rows]
        for r in rows:
            print(f"    {r['key']:<52} n={r['n']} best "
                  f"{r['best_s'] * 1e3:.4f} ms ({r['clock']}), tiles "
                  f"{r['tiles']}, {r['modeled_bytes'] / 1e6:.3f} MB, bound "
                  f"{r['bound_s'] * 1e3:.5f} ms ({r['bound_by']}), share "
                  f"{r['share']:.2%}")
        if len(rows) != n_shapes or n_disp != n_dcl * engine.steps:
            fail(f"15(b) {rung}: {len(rows)} divergence rows and {n_disp} "
                 f"dispatches; expected {n_shapes} rows and {n_dcl} x "
                 f"{engine.steps} steps")
        if None in shares or max(shares) > SHARE_MAX \
                or {r["clock"] for r in rows} != {"device"}:
            fail(f"15(b) {rung}: shares {shares} (clocks "
                 f"{ {r['clock'] for r in rows} }): a dispatch beat the "
                 f"card's bound, or was not timed on the device")
        path = ROOT / "chiprun_out" / f"phase15_{rung}_telemetry.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        dump_telemetry(path, tel)
        obs_report.main(["--metrics", str(path), "--divergence", str(path)])

        # A served step's forward with the recorder on, beside phase 4's
        # (6's) without it and, in turns here, without it, with a hook
        # that does nothing and with one that only records the two events
        # (CUDA events, not gated).
        cfg = dataclasses.replace(launch._served_cfg(CONFIG_BOUNDED),
                                  quant="none" if rung == "fp32_kernel"
                                  else rung)
        scales = engine._scales if rung == "int8_chain" else None
        fwd = {}
        for bucket in sorted({r.bucket for r in got.values()}):
            x = engine.batch_array(bucket, [r for r in got.values()
                                            if r.bucket == bucket])
            recs = []

            def forward(hook=None):
                with torch.no_grad(), ops.dispatch_hook_scope(hook):
                    R.forward(trained, cfg, x, quant_scales=scales,
                              device="cuda")

            def recorded():
                rec = DispatchRecorder(registry=MetricsRegistry(),
                                       tracker=DivergenceTracker())
                forward(rec)
                recs.append(rec)

            def events_hook(ctx):
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                return lambda out=None, error=None: end.record()
            fns = {"unrecorded": forward,
                   "no-op hook": lambda: forward(lambda ctx: None),
                   "events only": lambda: forward(events_hook),
                   "recorded": recorded}
            turns = {k: [] for k in fns}
            for _ in range(3):
                for k, fn in fns.items():
                    turns[k].append(time_ms(fn, reps=3, iters=2))
            for rec in recs:
                rec.flush()
            before = (record["serve"]["forward_ms"][str(bucket)]
                      ["kernel_path"] if rung == "fp32_kernel"
                      else record["forward_ms"][str(bucket)][rung])
            fwd[str(bucket)] = dict(
                {k: statistics.median(v) for k, v in turns.items()},
                turns=turns, phase_4_or_6_ms=before)
            print(f"  15(b) {rung} {bucket}-bucket forward (CUDA events, "
                  f"median of 3 turns): "
                  + ", ".join(f"{k} {statistics.median(v):.3f} ms"
                              for k, v in turns.items())
                  + f"; phase {4 if rung == 'fp32_kernel' else 6} "
                  f"without a hook: {before:.3f} ms")
            if bucket == 256:
                host = recorder_host_us(forward, n_dcl)
                fwd[str(bucket)]["host_us"] = host
                print(f"  15(b) {rung} 256-bucket host enqueue of a forward "
                      f"(perf_counter, median of {HOST_TURNS} turns): "
                      f"unrecorded {host['unrecorded']:.1f} us, recorded "
                      f"{host['recorded']:.1f} us, flush "
                      f"{host['flush']:.1f} us: the recorder's host cost "
                      f"{host['per_dispatch_us']:.2f} us a dispatch")
        out[rung] = dict(engine=engine, rows=rows, forward_ms=fwd)
    return out


def tune_and_serve(record: dict, trained, served: dict, shapes_256: list,
                   train_largest: tuple) -> dict:
    """Phase 15 (c): tune the 256 bucket's DCL shapes (forward: fp32,
    int8, int8_chain) and the training step's largest (training), install
    the cache and serve again on the tuned plans."""
    from repro_torch.configs.resnet50_dcn import CONFIG_BOUNDED
    from repro_torch.launch import serve as launch
    from repro_torch.serve import bucket_layer_dims
    from repro_torch.tune import (TileCache, install_tile_cache,
                                  tune_deform_conv)

    cache = TileCache()
    runs = []
    t0 = time.monotonic()
    for h, w, c, m, s in shapes_256:
        r = tune_deform_conv(h=h, w=w, c=c, m=m, batch=BATCH, stride=s,
                             offset_bound=B, objective="forward",
                             reps=TUNE_REPS, max_candidates=TUNE_CANDIDATES,
                             cache=cache, device="cuda")
        runs += [r, *r["quant_sweep"].values()]
    h, w, c, m, s = train_largest
    runs.append(tune_deform_conv(
        h=h, w=w, c=c, m=m, batch=TRAIN_BATCH, stride=s, offset_bound=B,
        objective="training", reps=TUNE_REPS,
        max_candidates=TUNE_CANDIDATES, cache=cache, device="cuda"))
    tune_s = time.monotonic() - t0
    for r in runs:
        if r["platform"] != "cuda_sm90":
            fail(f"15(c): the tuner keyed {r['platform']!r} on the card")
        if r["n_candidates"] != r["n_given"]:
            fail(f"15(c): {r['n_given'] - r['n_candidates']} of "
                 f"{r['n_given']} candidates failed on the card for "
                 f"{r['batch']}x{r['h']}x{r['w']}x{r['c']}->{r['m']} "
                 f"{r['objective']}/{r['dtype'] or 'fp32'} (every one "
                 f"passed tiling.tiles_fit): {r['failed']}")
        print(f"  tuned {r['batch']}x{r['h']}x{r['w']}x{r['c']}->{r['m']} "
              f"s{r['stride']} {r['objective']}/{r['dtype'] or 'fp32'}: "
              f"{r['n_candidates']}/{r['n_given']} candidates, measured_us "
              f"{r['best']['us']:.1f} at {r['best']['tiles']}, analytic_us "
              f"{r['analytic']['us']:.1f} at {r['analytic']['tiles']} "
              f"({r['tuned_vs_analytic_ratio']:.3f}x)")
    # Each entry also under the cpu key, with the 512 bucket's shapes:
    # a cpu entry is never served on the card.
    dims_512 = bucket_layer_dims(CONFIG_BOUNDED, 512)
    for d in dims_512.values():
        for dtype in (None, "int8_chain"):
            cache.put({"tiles": [4, 4, 4, min(d["m"], 64)]}, n=BATCH,
                      h=d["h"], w=d["w"], c=d["c"], m=d["m"],
                      stride=d["stride"], offset_bound=B,
                      objective="forward", dtype=dtype, platform="cpu")
    path = cache.save(str(ROOT / "build" / "phase15_tiles.json"))
    print(f"  {len(runs)} tunings in {tune_s:.1f} s; {len(cache)} entries "
          f"-> {Path(path).relative_to(ROOT)}")
    install_tile_cache(path)
    try:
        out = {}
        for rung, rtol in (("int8_chain", None), ("fp32_kernel",
                                                   KERNEL_RTOL)):
            before = served[rung]["engine"]
            engine, _, _ = launch.serve_detection(
                CONFIG_BOUNDED, serve_args(CONFIG_BOUNDED, rung),
                params=trained, scale_table=before.scale_table)
            tel = engine.telemetry()
            sources = tel["plan_sources"]
            if set(sources["256"].values()) != {"tuned"} \
                    or set(sources["512"].values()) != {"analytic"}:
                fail(f"15(c) {rung}: plan sources {sources}; expected every "
                     f"256 layer tuned and every 512 layer analytic (its "
                     f"entries are cpu-keyed)")
            got, want = results_of(engine), results_of(before)
            checks = {u: same_results(want[u], got[u], rtol=rtol)
                      for u in want}
            worst = max(err for _, err in checks.values())
            print(f"  15(c) {rung} on the tuned plans: plan sources "
                  f"{ {b: sorted(set(v.values())) for b, v in sources.items()} }, "
                  f"tuned hits {tel['plan_cache']['tuned_hits']}; against the "
                  f"analytic tiles: "
                  + ("torch.equal" if rtol is None else
                     f"largest difference {worst:.2e} of max|analytic|"))
            if not all(ok for ok, _ in checks.values()) or any(
                    r.outcome != "ok" for r in got.values()):
                fail(f"15(c) {rung}: tuned-plan results differ from the "
                     f"analytic tiles' ({checks})")
            out[rung] = dict(plan_sources=sources, worst_rel=worst)
    finally:
        install_tile_cache(None)
    return dict(entries=cache.entries, tune_s=tune_s, serve=out,
                runs=[{k: v for k, v in r.items() if k != "quant_sweep"}
                      for r in runs])


def chaos_serve(trained, table) -> dict:
    """Phase 15 (d), serving: slow_step, malformed_request,
    bucket_miss_storm and a dispatch_fault on int8_chain at 256."""
    import numpy as np

    from repro_torch.configs.resnet50_dcn import CONFIG_BOUNDED
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch
    from repro_torch.resilience import ChaosHooks, FaultEvent, FaultPlan
    from repro_torch.serve import (OUTCOMES, DCLServeConfig,
                                   DCLServingEngine)

    bucket = 256
    rng = np.random.default_rng(CHAOS_SEED)
    slow_at = int(rng.integers(1, 3))
    plan = FaultPlan(events=(
        FaultEvent(step=slow_at, kind="slow_step", mode=str(CHAOS_STALL_S)),
        FaultEvent(step=0, kind="malformed_request"),
        FaultEvent(step=0, kind="bucket_miss_storm", mode="2"),
        FaultEvent(step=0, kind="dispatch_fault"),
    ), seed=CHAOS_SEED)
    images = [np.random.RandomState(CHAOS_SEED % 2**31 + i)
              .randn(bucket, bucket, 3).astype(np.float32)
              for i in range(CHAOS_REQUESTS)]

    def engine(hooks=None):
        clock = FakeClock()
        if hooks is not None:
            hooks.sleep = clock.advance
        return DCLServingEngine(
            trained, launch._served_cfg(CONFIG_BOUNDED),
            DCLServeConfig(buckets=(bucket,), slots=2, quant="int8_chain"),
            scale_table=table, device="cuda", clock=clock,
            step_hook=None if hooks is None else hooks.serve_step_hook,
            admit_hook=None if hooks is None else hooks.admit_hook)

    hooks = ChaosHooks(plan)
    eng = engine(hooks)
    for uid, img in enumerate(images):
        eng.submit(img, deadline=CHAOS_DEADLINE_S
                   if uid >= CHAOS_REQUESTS - 2 else None)
    with ops.dispatch_hook_scope(hooks.dispatch_hook):
        eng.run_until_drained()
    by_uid = results_of(eng)
    outcomes = {u: (r.outcome, r.ladder, r.retries, r.degraded)
                for u, r in sorted(by_uid.items())}
    print(f"  15(d) serve chaos (slow step at {slow_at}): {outcomes}; "
          f"fired {[f['kind'] for f in hooks.fired]}; counters "
          f"{eng.counters}")
    # The requests the plan did not touch, alone in a clean engine in the
    # same batches (uids 3..9, served two a step as above).
    clean = engine()
    for uid in range(3, CHAOS_REQUESTS):
        clean.submit(images[uid], uid=uid)
    clean.run_until_drained()
    ref = results_of(clean)
    retried = [r for r in by_uid.values() if r.retries]
    expired = {u for u, r in by_uid.items()
               if r.outcome == "deadline_exceeded"}
    untouched = [u for u, r in by_uid.items()
                 if r.outcome == "ok" and not r.retries]
    unequal = [u for u in untouched if not same_results(by_uid[u],
                                                         ref[u])[0]]
    problems = []
    if len(by_uid) != CHAOS_REQUESTS or len(eng.queue) or any(
            not r.done or r.outcome not in OUTCOMES
            or r.outcome in ("pending", "failed") for r in by_uid.values()):
        problems.append("a request untyped, failed or left pending")
    if any(r.degraded for r in by_uid.values()):
        problems.append("a request degraded: on the card a dispatch fault "
                        "must stay on its rung")
    if {f["kind"] for f in hooks.fired} != {
            "slow_step", "malformed_request", "bucket_miss_storm",
            "dispatch_fault"}:
        problems.append("not every fault fired")
    if [by_uid[u].outcome for u in (0, 1, 2)] != [
            "malformed", "unbucketable", "unbucketable"]:
        problems.append("admission faults not typed")
    if not retried or any(r.outcome != "ok" or r.ladder != "int8_chain"
                          for r in retried):
        problems.append("the faulted batch was not retried ok on its rung")
    if not expired or not expired <= {CHAOS_REQUESTS - 2,
                                      CHAOS_REQUESTS - 1}:
        problems.append(f"deadlines expired {expired}")
    if not untouched or unequal:
        problems.append(f"untouched requests {unequal} differ from the "
                        f"clean run")
    if problems:
        fail(f"15(d) serve chaos: {problems}")
    print(f"  15(d) serve chaos: every request typed, none degraded; the "
          f"faulted batch {[r.uid for r in retried]} retried ok on "
          f"int8_chain; expired {sorted(expired)}; {len(untouched)} "
          f"untouched requests torch.equal to a clean run")
    return dict(plan=plan.summary(), outcomes=outcomes,
                fired=[f["kind"] for f in hooks.fired])


def planted_recovery(hooks, shift: int):
    """``hooks`` whose Trainer recovers wrongly once, a fault planted to
    show that the training-chaos check separates: its first restore
    moves the step counter by ``shift`` (+1 loses the step it should
    replay, -1 replays a step the run had already passed)."""
    bind = hooks.bind

    def bind_wrong(trainer):
        resume = trainer.try_resume
        done = []

        def wrong_resume() -> bool:
            ok = resume()
            if ok and not done:
                done.append(trainer.step)
                trainer.step += shift
            return ok
        trainer.try_resume = wrong_resume
        return bind(trainer)
    hooks.bind = bind_wrong
    return hooks


def chaos_train() -> dict:
    """Phase 15 (d), training: a ``FaultPlan.random`` over
    ``CHAOS_STEPS`` full-width steps against a run that sees only its
    non-finite step, and the same plan with a wrong recovery planted
    (a lost step, an extra step), each of which the check must
    tell from a sound one; beside them the skip-only run's last update,
    the distance one step moves the params."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.configs.resnet50_dcn import CONFIG_BOUNDED
    from repro_torch.launch import train as launch
    from repro_torch.models import resnet_dcn as R
    from repro_torch.resilience import ChaosHooks, FaultPlan
    from repro_torch.tree import leaves

    kinds = ("nonfinite_grads", "ckpt_corrupt", "step_crash", "data_hiccup")
    plan = FaultPlan.random(CHAOS_SEED, total_steps=CHAOS_STEPS,
                            kinds=kinds, min_step=2)
    skip_only = FaultPlan(events=tuple(e for e in plan.events
                                       if e.kind == "nonfinite_grads"),
                          seed=CHAOS_SEED)
    root = ROOT / "build" / "smoke_chaos"
    shutil.rmtree(root, ignore_errors=True)

    def flat(params):
        return torch.cat([p.detach().reshape(-1).clone()
                          for p in leaves(params)])

    def run(name: str, hooks):
        args = launch.build_parser().parse_args(
            ["--arch", CONFIG_BOUNDED.name, "--full", "--steps",
             str(CHAOS_STEPS), "--global-batch", str(TRAIN_BATCH),
             "--ckpt", str(root / name), "--ckpt-every", "1",
             "--log-every", "1", "--seed", "0", "--device", "cuda"])
        tcfg = launch.train_config(CONFIG_BOUNDED, args)
        params = perturb_offsets(R.init_params(tcfg, seed=0,
                                               device="cuda"), 1)
        return launch.train_detection(CONFIG_BOUNDED, args, params=params,
                                      chaos=hooks)

    t0 = time.monotonic()
    # The skip-only run, its params kept before its last step.
    oracle_hooks = ChaosHooks(skip_only)
    before_last = {}
    fault_hook = oracle_hooks.fault_hook

    def keep_before_last(step: int) -> None:
        if step == CHAOS_STEPS - 1:
            before_last["flat"] = flat(oracle_hooks.trainer.params)
        fault_hook(step)
    oracle_hooks.fault_hook = keep_before_last
    oracle = run("skip_only", oracle_hooks)
    flat_o = flat(oracle.params)
    hooks = ChaosHooks(plan)
    chaos = run("chaos", hooks)
    rel = ((flat(chaos.params) - flat_o).norm() / flat_o.norm()).item()
    last_update = ((flat_o - before_last["flat"]).norm()
                   / flat_o.norm()).item()
    planted = {}
    for name, shift in (("lost_step", 1), ("extra_step", -1)):
        wrong = run(name, planted_recovery(ChaosHooks(plan), shift))
        planted[name] = ((flat(wrong.params) - flat_o).norm()
                         / flat_o.norm()).item()
    seconds = time.monotonic() - t0
    fired = sorted({f["kind"] for f in hooks.fired})
    losses = [h["loss"] for h in chaos.history if "loss" in h]
    print(f"  15(d) train chaos {plan.summary()['events']}: {chaos.step}/"
          f"{CHAOS_STEPS} steps, fired {fired}, telemetry "
          f"{chaos.telemetry} (skip-only run {oracle.telemetry}); final "
          f"params vs the skip-only run: relative norm {rel:.2e} (gate "
          f"{RESUME_RTOL}); planted wrong recoveries "
          + ", ".join(f"{k} {v:.2e}" for k, v in planted.items())
          + f" (each at least {PLANTED_MIN} x the gate); the skip-only "
          f"run's last update {last_update:.2e}; {seconds:.1f} s for the "
          f"four runs")
    if chaos.step != CHAOS_STEPS or len(fired) < 3 \
            or not np.isfinite(losses).all() or rel > RESUME_RTOL:
        fail(f"15(d) train chaos: {chaos.step} steps, fired {fired}, "
             f"params {rel} from the skip-only run")
    if min(planted.values()) < PLANTED_MIN * RESUME_RTOL:
        fail(f"15(d) train chaos: a planted wrong recovery lands "
             f"{planted} from the skip-only run, under {PLANTED_MIN} x "
             f"{RESUME_RTOL}: the check does not separate it")
    return dict(plan=plan.summary(), fired=fired,
                telemetry=chaos.telemetry, rel_vs_skip_only=rel,
                planted_rel_vs_skip_only=planted,
                last_update_rel=last_update, losses=losses,
                seconds=seconds)


def operations_phase(record: dict, trained, per_step: dict,
                     train_step: dict) -> dict[str, int]:
    """Phase 15; returns each of ``OPS_KERNELS``' launches in it."""
    import torch

    t0 = time.monotonic()
    n_dcl = sum(per_step[k].get("256", 0) for k in per_step)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    reset_counts()
    served = serve_checkpoint(record, trained, len(per_step), n_dcl)
    counts_a = read_counts()
    shapes_256 = [k for k, cnt in per_step.items() if "256" in cnt]
    largest = max(train_step, key=lambda k: (
        k[0] * k[1] * k[2] * k[3] / k[4] ** 2, k[0] * k[1] * k[2]))
    tuned = tune_and_serve(record, trained, served, shapes_256, largest)
    counts_c = read_counts()
    chaos = dict(serve=chaos_serve(trained,
                                   served["int8_chain"]["engine"].scale_table),
                 train=chaos_train())
    counts = read_counts()
    launches = {k: counts[k] for k in OPS_KERNELS}
    print(f"  phase 15 launches: {launches} (after (a)-(b) "
          f"{ {k: counts_a[k] for k in OPS_KERNELS} }, after (c) "
          f"{ {k: counts_c[k] for k in OPS_KERNELS} })")
    if not all(launches.values()):
        fail(f"phase 15 launched a kernel of its path no time: {launches}")
    seconds = time.monotonic() - t0
    print(f"  phase 15 in {seconds:.1f} s on {smi()}")
    record["operations"] = dict(
        divergence={r: v["rows"] for r, v in served.items()},
        forward_ms={r: v["forward_ms"] for r, v in served.items()},
        tuned=tuned, chaos=chaos, launches=launches, seconds=seconds)
    return launches


# ---------------------------------------------------------------------------
# Phase 16: LM training at full width; the RG-LRU family served and trained
# ---------------------------------------------------------------------------

LM_TRAIN = ["--global-batch", "8", "--seq-len", "2048"]  # TinyLlama's context
LM_TRAIN_STEPS, LM_RESUME_AT = 6, 4
LM_RESUME_LAYERS = 2        # of 22: the resume check's depth (its three
                            # checkpoints 2.6 GB each, not 13.2)
LM_LOSS0_RTOL = 0.05        # step-0 loss vs ln(vocab): random logits
LM_RESUME_RTOL = 1e-5       # resumed params vs the uninterrupted run
LM_CE_RTOL = 1e-5           # chunked CE vs dense CE of the full logits
LM_REMAT_RTOL = 1e-6        # step-0 gradients, remat full / dots vs none
LM_BF16_LOSS_RTOL = 1e-2    # bf16-compute loss vs fp32-compute loss
LM_CARD_CPU_RTOL = 1e-4     # reduced fp32 loss history, card vs CPU
LM_REDUCED_STEPS = 5
RG_ARCH = "recurrentgemma-9b"
RG_BF16_PREDICTED = 4e-2    # bf16 vs fp32 logits at 38 layers (PERF.md §6)
RG_BF16_MAX = 1.5 * max(RG_BF16_PREDICTED, LM_BF16_MAX)
RG_GREEDY_PROMPTS, RG_GREEDY_NEW = 2, 16
RG_SCAN_TOKENS = 256
RG_SCAN_RTOL = 1e-5         # rg_lru_scan vs repeated rg_lru_step
RG_TRAIN_LAYERS, RG_TRAIN_STEPS = 3, 4   # one period: all 38 need 150 GB
RG_TRAIN = ["--global-batch", "4", "--seq-len", "2048"]


def cut_depth(params, cfg):
    """The first ``cfg.n_layers`` layers of ``params`` (an LM's params of
    the same family at a greater depth): the prefix layers and stacked
    periods ``cfg`` has, copied, and every other leaf shared."""
    from repro_torch.models import transformer as TF
    from repro_torch.tree import tree_map

    keep = {k: v for k, v in params.items()
            if k in TF.model_def(cfg) and k != "period"}
    keep["layers"] = tree_map(lambda t: t[:cfg.n_periods].clone(),
                              params["layers"])
    return keep


def tree_rel(a, b) -> float:
    """Relative norm of two trees of tensors, leaf by leaf (no flat copy
    of a billion parameters)."""
    from repro_torch.tree import leaves
    num = den = 0.0
    for x, y in zip(leaves(a), leaves(b)):
        num += float((x.detach().float() - y.detach().float()).norm()) ** 2
        den += float(y.detach().float().norm()) ** 2
    return math.sqrt(num / den)


def train_lm_args(arch: str, steps: int, ckpt, *extra: str):
    from repro_torch.launch import train as launch
    return launch.build_parser().parse_args(
        ["--arch", arch, "--steps", str(steps), "--ckpt", str(ckpt),
         "--ckpt-every", "100", "--log-every", "1", "--seed", "0",
         "--device", "cuda", *extra])


def gpu_memory() -> str:
    import torch
    return (f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
            f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


def step_split(trainer, batch, reps: int = 3) -> dict:
    """A training step's forward, backward and optimizer time (CUDA
    events, median of ``reps`` steps after one warm-up), as the Trainer
    runs them; the steps update the trainer's params."""
    import torch

    from repro_torch.optim import global_norm
    from repro_torch.tree import from_paths, leaves_with_paths

    def one():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        pairs = leaves_with_paths(trainer.params)
        ev[0].record()
        loss, _ = trainer.loss_fn(trainer.params, batch)
        ev[1].record()
        gs = torch.autograd.grad(loss, [t for _, t in pairs])
        ev[2].record()
        grads = from_paths([(path, g.float()) for (path, _), g
                            in zip(pairs, gs)])
        global_norm(grads)
        with torch.no_grad():
            trainer.opt.update(grads, trainer.opt_state, trainer.params,
                               trainer.step)
        ev[3].record()
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    one()
    runs = [one() for _ in range(reps)]
    fwd, bwd, opt = (statistics.median(r[i] for r in runs) for i in range(3))
    return dict(forward_ms=fwd, backward_ms=bwd, optimizer_ms=opt,
                step_ms=fwd + bwd + opt)


def lm_training(record: dict) -> None:
    """Phase 16(a): full-width tinyllama-1.1b through ``train_lm``."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.data import LMDataConfig, lm_batch
    from repro_torch.launch import train as launch
    from repro_torch.models import layers as L
    from repro_torch.models import registry as reg
    from repro_torch.models import transformer as TF
    from repro_torch.tree import leaves, tree_map

    cfg = reg.get(LM_ARCH).config
    root = ROOT / "build" / "smoke_lm"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    args = train_lm_args(LM_ARCH, LM_TRAIN_STEPS, root / "full", "--full",
                         *LM_TRAIN)
    rec = record["lm_train"] = dict(
        arch=LM_ARCH, params=cfg.param_count(), batch=args.global_batch,
        seq_len=args.seq_len, steps=LM_TRAIN_STEPS, remat=cfg.remat)
    print(f"  config {cfg.name}: {cfg.param_count() / 1e9:.3f}B fp32 params, "
          f"compute {cfg.dtype}, remat {cfg.remat!r}, batch "
          f"{args.global_batch} x {args.seq_len}; disk free "
          f"{shutil.disk_usage(root).free / 1e9:.0f} GB")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    p0 = TF.init_params(cfg, seed=0, device="cuda")
    rec["init_s"] = time.monotonic() - t0

    def clone(tree):
        return tree_map(lambda t: t.detach().clone(), tree)

    # Step 0's checks, on the step-0 batch and the seeded params.
    data = LMDataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                        global_batch=args.global_batch, seed=args.seed)
    batch = {k: torch.from_numpy(v).to("cuda")
             for k, v in lm_batch(data, 0).items()}
    w = p0["unembed"]["unembedding"]
    with torch.no_grad():
        hidden = TF.forward(p0, cfg, tokens=batch["tokens"],
                            return_hidden=True)[0]
        chunked = L.chunked_cross_entropy(hidden, w, batch["targets"],
                                          tied=False).item()
        dense = L.cross_entropy(TF._logits(p0, cfg, hidden),
                                batch["targets"]).item()
        loss32 = TF.loss_fn(p0, dataclasses.replace(cfg, dtype=torch.float32),
                            batch)[0].item()
        del hidden
    ce_rel = abs(chunked - dense) / dense
    bf16_rel = abs(chunked - loss32) / loss32
    print(f"  step 0: chunked CE {chunked:.6f}, dense CE of the full logits "
          f"{dense:.6f} (rel {ce_rel:.2e}, gate {LM_CE_RTOL}); fp32-compute "
          f"loss {loss32:.6f} (bf16 vs fp32 rel {bf16_rel:.2e}, gate "
          f"{LM_BF16_LOSS_RTOL}); ln(vocab) {math.log(cfg.vocab):.4f}")
    if ce_rel > LM_CE_RTOL:
        fail(f"chunked CE {chunked} vs dense {dense}: rel {ce_rel}")
    if bf16_rel > LM_BF16_LOSS_RTOL:
        fail(f"bf16 loss {chunked} vs fp32 {loss32}: rel {bf16_rel}")

    # Remat modes on one sequence of that batch: 'none' keeps every
    # layer's (32, 2048, 2048) fp32 scores, ~1 GB a layer a sequence.
    one = {k: v[:1] for k, v in batch.items()}
    grads = {}
    for mode in ("none", "full", "dots"):
        torch.cuda.reset_peak_memory_stats()
        pg = tree_map(lambda t: t.detach().requires_grad_(True), p0)
        loss, _ = TF.loss_fn(pg, dataclasses.replace(cfg, remat=mode), one)
        grads[mode] = torch.autograd.grad(loss, leaves(pg))
        rec[f"remat_{mode}_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del pg, loss
    remat_rel = {m: tree_rel(dict(enumerate(grads[m])),
                             dict(enumerate(grads["none"])))
                 for m in ("full", "dots")}
    del grads
    print(f"  step-0 gradients (1 x {args.seq_len}) vs remat 'none': "
          + ", ".join(f"{m} {v:.2e}" for m, v in remat_rel.items())
          + f" (gate {LM_REMAT_RTOL}); peak memory "
          + ", ".join(f"{m} {rec[f'remat_{m}_peak_gb']:.1f} GB"
                      for m in ("none", "full", "dots")))
    if max(remat_rel.values()) > LM_REMAT_RTOL:
        fail(f"remat modes change the gradients: {remat_rel}")

    # 6 steps uninterrupted at full depth; then the resume check at
    # LM_RESUME_LAYERS: 6 uninterrupted, and 4 and a new run resumed to 6.
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    full = launch.train_lm(cfg, args, params=clone(p0))
    rec["wall_s"] = time.monotonic() - t0
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    losses = [h["loss"] for h in full.history if "loss" in h]
    host_ms = [t * 1e3 for t in full.step_seconds]
    print(f"  {LM_TRAIN_STEPS} steps in {rec['wall_s']:.1f} s (a checkpoint "
          f"of params and AdamW state at the end); losses "
          f"{[round(v, 5) for v in losses]}; host-clock steps "
          f"{[round(t, 1) for t in host_ms]} ms; telemetry "
          f"{full.telemetry}; peak memory {rec['peak_gb']:.2f} GB")
    loss0_rel = abs(losses[0] - math.log(cfg.vocab)) / math.log(cfg.vocab)
    if len(losses) != LM_TRAIN_STEPS or not np.isfinite(losses).all() \
            or full.telemetry["skipped"] or loss0_rel > LM_LOSS0_RTOL:
        fail(f"LM training: losses {losses}, telemetry {full.telemetry}, "
             f"step 0 {loss0_rel} from ln(vocab)")
    if abs(losses[0] - chunked) > LM_CE_RTOL * chunked:
        fail(f"the Trainer's step-0 loss {losses[0]} is not the chunked CE "
             f"{chunked} of the same batch")
    moved = tree_rel(full.params, p0)
    shutil.rmtree(root / "full", ignore_errors=True)
    cut_cfg = dataclasses.replace(cfg, n_layers=LM_RESUME_LAYERS)
    p_cut = cut_depth(p0, cut_cfg)
    t0 = time.monotonic()
    straight = launch.train_lm(
        cut_cfg, train_lm_args(LM_ARCH, LM_TRAIN_STEPS, root / "straight",
                               "--full", *LM_TRAIN), params=clone(p_cut))
    s_losses = [h["loss"] for h in straight.history if "loss" in h]
    launch.train_lm(cut_cfg, train_lm_args(LM_ARCH, LM_RESUME_AT,
                                           root / "resumed", "--full",
                                           *LM_TRAIN),
                    params=clone(p_cut))
    resumed = launch.train_lm(
        cut_cfg, train_lm_args(LM_ARCH, LM_TRAIN_STEPS, root / "resumed",
                               "--full", *LM_TRAIN),
        params=tree_map(torch.zeros_like, p_cut))
    rec["resume_wall_s"] = time.monotonic() - t0
    resume_rel = tree_rel(resumed.params, straight.params)
    opt_rel = tree_rel(resumed.opt_state, straight.opt_state)
    r_losses = [h["loss"] for h in resumed.history if "loss" in h]
    print(f"  resume check at {LM_RESUME_LAYERS} layers "
          f"({cut_cfg.param_count() / 1e9:.3f}B params): resumed at step "
          f"{LM_RESUME_AT}, losses {[round(v, 5) for v in r_losses]} "
          f"(uninterrupted {[round(v, 5) for v in s_losses[LM_RESUME_AT:]]}"
          f"); params vs the uninterrupted run {resume_rel:.2e} (gate "
          f"{LM_RESUME_RTOL}), AdamW state {opt_rel:.2e}; the full-depth "
          f"{LM_TRAIN_STEPS} steps moved the params {moved:.2e}; 6, then 4 + "
          f"2 steps with their checkpoints in {rec['resume_wall_s']:.1f} s")
    if resume_rel > LM_RESUME_RTOL or len(r_losses) != 2:
        fail(f"resumed LM run is {resume_rel} from the uninterrupted run")
    del straight, resumed, p_cut
    shutil.rmtree(root / "straight", ignore_errors=True)
    shutil.rmtree(root / "resumed", ignore_errors=True)

    # Where a step's time goes (the full-depth trainer steps on).
    step_batch = full._device_batch(0)
    split = step_split(full, step_batch)
    wall, busy, n_launch, top = busy_share(
        lambda: full._one_step(step_batch))
    top = [(k[:60], round(ms, 3)) for k, ms in top[:6]]
    tokens = args.global_batch * args.seq_len
    print(f"  step {split['step_ms']:.1f} ms (CUDA events): forward "
          f"{split['forward_ms']:.1f}, backward (recompute included) "
          f"{split['backward_ms']:.1f}, AdamW {split['optimizer_ms']:.1f}; "
          f"{tokens / split['step_ms'] * 1e3:.0f} tokens/s; under "
          f"torch.profiler {wall:.1f} ms wall, {busy:.1f} ms device busy, "
          f"idle {1 - busy / wall:.1%}, {n_launch} kernel launches; top "
          f"{top[:5]}")
    rec.update(losses=losses, resume_layers=LM_RESUME_LAYERS,
               resumed_losses=r_losses, straight_losses=s_losses,
               host_step_ms=host_ms,
               loss0=losses[0], loss0_vs_ln_vocab=loss0_rel,
               chunked_ce=chunked, dense_ce=dense, ce_rel=ce_rel,
               loss_fp32=loss32, bf16_loss_rel=bf16_rel, remat_rel=remat_rel,
               resume_rel=resume_rel, resume_opt_rel=opt_rel, moved_rel=moved,
               profiled_wall_ms=wall, device_busy_ms=busy,
               device_idle=1 - busy / wall, launches_a_step=n_launch,
               device_top=top,
               tokens_per_s=tokens / split["step_ms"] * 1e3, **split)
    del full, p0, batch, one, step_batch
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()

    # The reduced config in fp32, 5 steps on the card and on the CPU.
    hist = {}
    for dev in ("cuda", "cpu"):
        a = train_lm_args(LM_ARCH, LM_REDUCED_STEPS, root / f"reduced_{dev}")
        a.device = dev
        tr = launch.train_lm(cfg, a)
        hist[dev] = [h["loss"] for h in tr.history if "loss" in h]
    card_cpu = max(abs(x - y) / abs(y) for x, y in zip(hist["cuda"],
                                                       hist["cpu"]))
    print(f"  reduced {LM_ARCH} (fp32, TF32 off), {LM_REDUCED_STEPS} steps: "
          f"card {[round(v, 6) for v in hist['cuda']]}, CPU "
          f"{[round(v, 6) for v in hist['cpu']]}; worst relative difference "
          f"{card_cpu:.2e} (gate {LM_CARD_CPU_RTOL})")
    if len(hist["cuda"]) != LM_REDUCED_STEPS or card_cpu > LM_CARD_CPU_RTOL:
        fail(f"the reduced run differs between card and CPU: {hist}")
    rec.update(reduced_card=hist["cuda"], reduced_cpu=hist["cpu"],
               reduced_card_cpu_rel=card_cpu)
    shutil.rmtree(root, ignore_errors=True)


def rg_serving(record: dict):
    """Phase 16(b): full-depth, full-width recurrentgemma-9b served.
    Returns its params for (c)."""
    import numpy as np
    import torch

    from repro_torch.launch import serve as serve_launch
    from repro_torch.models import registry as reg
    from repro_torch.models import rglru as RG
    from repro_torch.models import transformer as TF
    from repro_torch.serve import Request, ServeConfig, ServingEngine

    cfg = reg.get(RG_ARCH).config
    rec = record["rg_serve"] = dict(arch=RG_ARCH, params=cfg.param_count(),
                                    bf16_cap=RG_BF16_MAX,
                                    bf16_predicted=RG_BF16_PREDICTED)
    print(f"  config {cfg.name}: {cfg.n_layers} layers (prefix "
          f"{cfg.prefix} + {cfg.n_periods} x {cfg.pattern}), d "
          f"{cfg.d_model}, d_rnn {cfg.rglru.d_rnn}, {cfg.n_heads} heads / "
          f"{cfg.kv_heads} KV, Dh {cfg.hd}, window {cfg.window}, vocab "
          f"{cfg.vocab}, {cfg.param_count() / 1e9:.3f}B params (fp32, "
          f"{cfg.param_count() * 4 / 1e9:.1f} GB), compute {cfg.dtype}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = card_params(cfg, seed=0)
    torch.cuda.synchronize()
    rec["init_s"] = time.monotonic() - t0
    print(f"  params drawn from seed 0 on the card in "
          f"{rec['init_s']:.1f} s; {gpu_memory()}")

    # The scan against the step recurrence on one full-width layer.
    rec_p = params["prefix0"]["rec"]
    x = torch.randn(1, RG_SCAN_TOKENS, cfg.rglru.d_rnn, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3))
    with torch.inference_mode():
        y_scan, h_scan = RG.rg_lru_scan(rec_p, x)
        h = torch.zeros(1, cfg.rglru.d_rnn, device="cuda")
        steps = []
        for t in range(RG_SCAN_TOKENS):
            y, h = RG.rg_lru_step(rec_p, x[:, t], h)
            steps.append(y)
        y_step = torch.stack(steps, 1)
    scan_rel = ((y_scan - y_step).norm() / y_step.norm()).item()
    h_rel = ((h_scan - h).norm() / h.norm()).item()
    print(f"  rg_lru_scan vs {RG_SCAN_TOKENS} rg_lru_step calls (d_rnn "
          f"{cfg.rglru.d_rnn}): y {scan_rel:.2e}, final h {h_rel:.2e} "
          f"(gate {RG_SCAN_RTOL})")
    if max(scan_rel, h_rel) > RG_SCAN_RTOL:
        fail(f"the RG-LRU scan is {scan_rel} / {h_rel} from its steps")
    rec.update(scan_rel=scan_rel, scan_h_rel=h_rel)

    # The launcher's LM branch with cache_len = window.
    args = serve_launch.build_parser().parse_args(
        ["--arch", RG_ARCH, "--device", "cuda", "--seed", "0",
         "--cache-len", str(cfg.window)])
    engine, steps, seconds = serve_launch.serve_lm(cfg, args, params=params)
    print(serve_launch.report_lm(engine, steps, seconds))
    if sorted((r.uid, len(r.output)) for r in engine.completed) \
            != [(i, args.max_new_tokens) for i in range(args.requests)]:
        fail("serve_lm did not serve every request its token count")
    del engine

    # The engine at long prompts, its logits kept.
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab, n).astype(np.int32)
               for n in LM_PROMPTS]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = ServingEngine(params, cfg, ServeConfig(slots=BATCH,
                                                    cache_len=LM_CACHE),
                           device="cuda")
    reqs = [Request(uid=i, prompt=p, max_new_tokens=LM_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    with recording(engine) as log:
        t0 = time.monotonic()
        engine.run_until_drained()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    rec["engine_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    toks = sum(len(r.output) for r in engine.completed)
    rec.update(engine_s=wall, tokens=toks, tokens_per_s=toks / wall,
               engine_steps=engine.steps)
    print(f"  engine: {len(engine.completed)} requests / {toks} tokens in "
          f"{wall:.3f} s ({toks / wall:.1f} tok/s, prefills included), "
          f"{engine.steps} decode steps; peak memory "
          f"{rec['engine_peak_gb']:.2f} GB")
    if sorted((r.uid, len(r.output)) for r in engine.completed) \
            != [(i, LM_NEW) for i in range(len(prompts))]:
        fail("the engine did not serve every request its token count")
    c = engine.caches
    print(f"  caches: h {tuple(c['layers']['m0']['h'].shape)} "
          f"{c['layers']['m0']['h'].dtype}, conv "
          f"{tuple(c['layers']['m0']['conv'].shape)} "
          f"{c['layers']['m0']['conv'].dtype}, K "
          f"{tuple(c['layers']['m2']['k'].shape)} "
          f"{c['layers']['m2']['k'].dtype}")
    if c["prefix0"]["h"].dtype != torch.float32 \
            or c["prefix0"]["conv"].dtype != cfg.dtype:
        fail("the recurrent caches lost their dtypes")
    rows, checked, under = hold_served_logits(params, cfg, reqs,
                                              log.served(reqs), RG_BF16_MAX)
    rec.update(logits=rows, argmax_checked=checked,
               argmax_under_margin=under,
               bf16_vs_fp32_worst=max(max(d["tf_fp32"], d["served_fp32"])
                                      for d in rows))

    # Where the time goes: prefill per prompt length, the decode step.
    prefill_ms = {}
    with torch.inference_mode():
        for p in prompts:
            t = torch.as_tensor(p, dtype=torch.long, device="cuda")[None]
            prefill_ms[len(p)] = time_ms(
                lambda: TF.prefill(params, cfg, t, cache_len=LM_CACHE),
                reps=3, iters=1)
        caches, pos = engine.caches, torch.full((BATCH,), 1100,
                                                device="cuda")
        tok = torch.zeros(BATCH, dtype=torch.long, device="cuda")
        decode_ms = time_ms(lambda: TF.decode_step(params, cfg, tok, caches,
                                                   pos), reps=3, iters=3)
        n = 4
        wall_ms, busy_ms, n_launch, top = busy_share(lambda: [
            TF.decode_step(params, cfg, tok, caches, pos)[0].argmax(-1)
            .tolist() for _ in range(n)])
    cast_ms = sum(ms for key, ms in top if "copy" in key.lower())
    top = [(key[:70], round(ms / n, 4)) for key, ms in top[:8]]
    rec.update(prefill_ms=prefill_ms, decode_ms=decode_ms,
               decode_wall_ms=wall_ms / n, decode_busy_ms=busy_ms / n,
               decode_idle=1 - busy_ms / wall_ms, decode_copy_ms=cast_ms / n,
               decode_top=top, decode_launches=n_launch / n)
    print(f"  prefill (1 prompt, CUDA events): "
          f"{ {k: round(v, 2) for k, v in prefill_ms.items()} } ms")
    print(f"  decode step ({BATCH} slots, cache {LM_CACHE}): {decode_ms:.2f} "
          f"ms (CUDA events); under torch.profiler {wall_ms / n:.2f} ms "
          f"wall, {busy_ms / n:.2f} ms device busy, idle "
          f"{1 - busy_ms / wall_ms:.1%}; {n_launch / n:.0f} kernel launches "
          f"a step; dtype casts and copies {cast_ms / n:.2f} ms a step; top "
          f"{top[:5]}")
    del engine, caches

    # fp32: the engine equals naive greedy decoding.
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    engine = ServingEngine(params, cfg32, ServeConfig(slots=BATCH,
                                                      cache_len=LM_CACHE),
                           device="cuda")
    for i, p in enumerate(prompts[:RG_GREEDY_PROMPTS]):
        engine.submit(Request(uid=i, prompt=p, max_new_tokens=RG_GREEDY_NEW))
    t0 = time.monotonic()
    engine.run_until_drained()
    with torch.inference_mode():
        for r in engine.completed:
            cur = torch.as_tensor(r.prompt, dtype=torch.long,
                                  device="cuda")[None]
            ref = []
            for _ in range(len(r.output)):
                logits, _, _ = TF.forward(params, cfg32, tokens=cur,
                                          mode="train")
                nxt = int(logits[0, -1].argmax())
                ref.append(nxt)
                cur = torch.cat([cur, torch.tensor([[nxt]], device="cuda")],
                                1)
            if r.output != ref:
                fail(f"fp32 request {r.uid}: served {r.output} but greedy "
                     f"decoding gives {ref}")
    rec["fp32_greedy_s"] = time.monotonic() - t0
    print(f"  fp32: {len(engine.completed)} requests x {RG_GREEDY_NEW} "
          f"tokens equal naive greedy decoding token for token "
          f"({rec['fp32_greedy_s']:.1f} s); {gpu_memory()}")
    del engine
    return params


def rg_training(record: dict, held: dict) -> None:
    """Phase 16(c): recurrentgemma at full width and ``RG_TRAIN_LAYERS``
    layers (one period, cut from (b)'s params, which ``held`` gives up so
    that they are freed) through ``train_lm``."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.launch import train as launch
    from repro_torch.models import registry as reg
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(reg.get(RG_ARCH).config,
                              n_layers=RG_TRAIN_LAYERS)
    params = held.pop("params")
    cut = tree_map(lambda t: t.detach().clone(), cut_depth(params, cfg))
    del params
    torch.cuda.empty_cache()
    root = ROOT / "build" / "smoke_rg"
    shutil.rmtree(root, ignore_errors=True)
    args = train_lm_args(RG_ARCH, RG_TRAIN_STEPS, root, "--full", *RG_TRAIN)
    n = cfg.param_count()
    rec = record["rg_train"] = dict(layers=cfg.n_layers, params=n,
                                    batch=args.global_batch,
                                    seq_len=args.seq_len)
    print(f"  config: {cfg.n_layers} layers (prefix {cfg.prefix} + "
          f"{cfg.n_periods} x {cfg.pattern}), {n / 1e9:.3f}B params: fp32 "
          f"params, gradients and AdamW state {n * 16 / 1e9:.1f} GB (the "
          f"full {reg.get(RG_ARCH).config.param_count() / 1e9:.3f}B would "
          f"need {reg.get(RG_ARCH).config.param_count() * 16 / 1e9:.0f} GB, "
          f"more than one 80 GB card); batch {args.global_batch} x "
          f"{args.seq_len}; disk free "
          f"{shutil.disk_usage(ROOT / 'build').free / 1e9:.0f} GB")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    tr = launch.train_lm(cfg, args, params=cut)
    rec["wall_s"] = time.monotonic() - t0
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    losses = [h["loss"] for h in tr.history if "loss" in h]
    host_ms = [t * 1e3 for t in tr.step_seconds]
    tokens = args.global_batch * args.seq_len
    step_ms = statistics.median(host_ms[1:])
    print(f"  {RG_TRAIN_STEPS} steps in {rec['wall_s']:.1f} s (a checkpoint "
          f"at the end); losses {[round(v, 5) for v in losses]}; host-clock "
          f"steps {[round(t, 1) for t in host_ms]} ms (median after the "
          f"first {step_ms:.1f} ms, {tokens / step_ms * 1e3:.0f} tokens/s); "
          f"telemetry {tr.telemetry}; peak memory {rec['peak_gb']:.2f} GB")
    if len(losses) != RG_TRAIN_STEPS or not np.isfinite(losses).all() \
            or tr.telemetry["skipped"]:
        fail(f"recurrentgemma training: losses {losses}, telemetry "
             f"{tr.telemetry}")
    rec.update(losses=losses, host_step_ms=host_ms, step_ms=step_ms,
               tokens_per_s=tokens / step_ms * 1e3)
    del tr, cut
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()


def lm_train_phase(record: dict) -> None:
    """Phase 16: (a), (b), (c); no kernel of the port launches."""
    t0 = time.monotonic()
    reset_counts()
    print("  (a) tinyllama-1.1b training at full width")
    lm_training(record)
    print("  (b) recurrentgemma-9b served at full width and depth")
    held = {"params": rg_serving(record)}
    print(f"  (c) recurrentgemma at full width, {RG_TRAIN_LAYERS} layers, "
          f"trained")
    rg_training(record, held)
    counts = read_counts()
    if any(counts.values()):
        fail(f"the LM paths launched a kernel: {counts}")
    record["phase16_s"] = time.monotonic() - t0
    print(f"  phase 16 in {record['phase16_s']:.1f} s on {smi()}; no kernel "
          f"of the port launched (its LM paths are plain PyTorch, as the "
          f"JAX model's are XLA)")


# ---------------------------------------------------------------------------
# Phase 17: the remaining LM families: RWKV-6, MoE, codebooks, frontend
# ---------------------------------------------------------------------------

RW_ARCH = "rwkv6-3b"
RW_BF16_PREDICTED = 3e-2    # bf16 vs fp32 logits at 32 layers (PERF.md §6)
RW_BF16_MAX = 1.5 * max(RW_BF16_PREDICTED, LM_BF16_MAX)
RW_FP32_RTOL = 1e-3         # served vs teacher-forced fp32 logits (rel norm)
RW_SENSITIVITY_EPS = 2.0 ** -9  # bf16's unit roundoff, on the embeddings
RW_WKV_TOKENS = 256
RW_WKV_RTOL = 5e-4          # chunked vs step: JAX's own bound
RW_GREEDY_PROMPTS, RW_GREEDY_NEW = 2, 16
RW_TRAIN_STEPS = 6
RW_TRAIN_LAYERS = 4         # of 32: all 32 fit (70.6 GB at batch 4), but
                            # their 37 GB checkpoint takes ~80 s, 16 layers'
                            # 20.5 GB ~40 s (PERF.md §4)
RW_TRAIN_BATCH, RW_SEQ = 4, 2048
MOE_ARCH = "dbrx-132b"
MOE_LAYERS = 2              # 7.75B params; all 40 need 528 GB in fp32
MOE_BF16_PREDICTED = 2e-2   # bf16 vs fp32 logits at 2 layers (PERF.md §6)
MOE_BF16_MAX = 1.5 * max(MOE_BF16_PREDICTED, LM_BF16_MAX)
MOE_GREEDY_PROMPTS, MOE_GREEDY_NEW = 2, 16
MOE_LOSS_BATCH = (1, 2048)
MOE_LOSS_BF16_RTOL = 1e-2   # bf16- vs fp32-compute loss, one layer
MG_ARCH = "musicgen-medium"
MG_TRAIN = ["--global-batch", "8", "--seq-len", "2048"]
MG_TRAIN_STEPS = 6
MG_TRAIN_LAYERS = 6         # of 48, trained (served and checked at all 48):
                            # all 48 write a 16.6 GB checkpoint (~34 s)
MG_PROMPT, MG_DECODE_STEPS = 256, 8
PX_ARCH = "pixtral-12b"
PX_LAYERS = 4               # 2.43B params; all 40 need 49 GB of fp32 params
PX_FRONTEND, PX_TEXT, PX_DECODE_STEPS = 256, 512, 4
DECODE_RTOL = 1e-5          # fp32 prefill + decode vs teacher-forced forward
P17_ARCHS = [RW_ARCH, "dbrx-132b", "grok-1-314b", MG_ARCH, PX_ARCH]
P17_REDUCED_STEPS = 3


def ce_prediction(cfg) -> float:
    """Step-0 cross entropy of random untied heads: the logits are normal
    with variance D / fan-in of the head (1 for a (D, V) unembedding, 1/CB
    for (CB, D, V) heads), so the loss is ln(V) + var / 2."""
    return math.log(cfg.vocab) + 0.5 / cfg.codebooks


class drops:
    """Within the block each MoE dispatch of a prefill or train forward
    (not decode's full capacity) records (choices, dropped)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe as M
        self.real = M.dispatch_slots

        def dispatch_slots(experts, e, cap):
            slot, keep = self.real(experts, e, cap)
            if cap < experts.shape[1] * experts.shape[2]:
                self.calls.append((keep.numel(), int((~keep).sum())))
            return slot, keep
        M.dispatch_slots = dispatch_slots
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as M
        M.dispatch_slots = self.real

    def share(self) -> float:
        n = sum(c for c, _ in self.calls)
        return sum(d for _, d in self.calls) / max(n, 1)


def hold_chaotic_logits(params, cfg, prompts, served: dict, reqs) -> dict:
    """Where the random model amplifies a rounding into O(0.1) logits
    (rwkv6-3b at 32 layers: a bf16 run and an fp32 run whose embeddings
    moved by bf16's roundoff land about as far from the fp32 forward),
    phase 13's bf16 cap and margins cannot hold.  Then: the bf16 served
    logits (``served``, ``reqs``) no farther from the teacher-forced bf16
    forward than that is from the fp32 forward (phase 13's first gate);
    the fp32 engine on the same prompts, its logits recorded, within
    ``RW_FP32_RTOL`` (relative norm) of the teacher-forced fp32 forward
    and its tokens the teacher-forced argmax wherever the top-2 margin is
    clear; the fp32 forward's movement under embeddings perturbed by
    ``RW_SENSITIVITY_EPS`` printed beside the bf16 readings."""
    import numpy as np
    import torch

    from repro_torch.models import transformer as TF
    from repro_torch.serve import Request, ServeConfig, ServingEngine

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)

    def seq_of(r):
        return torch.as_tensor(np.concatenate(
            [r.prompt, np.asarray(r.output[:-1], np.int32)]),
            dtype=torch.long, device="cuda")[None]

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()
    out = dict(bf16=[], fp32=[])
    with torch.inference_mode():
        for r in reqs:
            seq, p = seq_of(r), len(r.prompt)
            tf, ex = (TF.forward(params, c, tokens=seq)[0][0, p - 1:]
                      .float().cpu() for c in (cfg, cfg32))
            d = dict(uid=r.uid, prompt=p, served_tf=rel(served[r.uid], tf),
                     served_fp32=rel(served[r.uid], ex),
                     tf_fp32=rel(tf, ex))
            out["bf16"].append(d)
            if d["served_tf"] > max(LM_RTOL, d["tf_fp32"]) \
                    or not bool(torch.isfinite(served[r.uid]).all()):
                fail(f"request {r.uid}: the served bf16 logits stray beyond "
                     f"the bf16 path's own error: {d}")
        real = TF._embed

        def perturbed(*a):
            x = real(*a)
            g = torch.Generator(device="cuda").manual_seed(11)
            return x + RW_SENSITIVITY_EPS * x.float().std() * torch.randn(
                x.shape, device=x.device, generator=g)
        seq, p = seq_of(reqs[0]), len(reqs[0].prompt)
        ex = TF.forward(params, cfg32, tokens=seq)[0][0, p - 1:]
        TF._embed = perturbed
        try:
            moved = TF.forward(params, cfg32, tokens=seq)[0][0, p - 1:]
        finally:
            TF._embed = real
        out["sensitivity"] = rel(moved, ex)

    engine = ServingEngine(params, cfg32, ServeConfig(slots=BATCH,
                                                      cache_len=LM_CACHE),
                           device="cuda")
    reqs32 = [Request(uid=i, prompt=pr, max_new_tokens=LM_NEW)
              for i, pr in enumerate(prompts)]
    for r in reqs32:
        engine.submit(r)
    with recording(engine) as log:
        engine.run_until_drained()
    served32 = log.served(reqs32)
    checked = under = 0
    with torch.inference_mode():
        for r in reqs32:
            p = len(r.prompt)
            tf = TF.forward(params, cfg32, tokens=seq_of(r))[0][0, p - 1:] \
                .float().cpu()
            d = dict(uid=r.uid, prompt=p, served_tf=rel(served32[r.uid], tf))
            top2 = tf.topk(2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > LM_RTOL * tf.abs().amax(-1)
            agree = tf.argmax(-1) == torch.as_tensor(r.output)
            checked += int(sure.sum())
            under += int((~sure).sum())
            out["fp32"].append(d)
            if d["served_tf"] > RW_FP32_RTOL or not bool(agree[sure].all()):
                fail(f"fp32 request {r.uid}: served logits {d['served_tf']} "
                     f"from the teacher-forced fp32 forward, or a served "
                     f"token off its argmax")
    b, f = out["bf16"], out["fp32"]
    for d in b:
        print(f"  request {d['uid']} (prompt {d['prompt']}), bf16: served vs "
              f"teacher-forced bf16 {d['served_tf']:.3e}; vs the fp32 "
              f"forward: served {d['served_fp32']:.3e}, teacher-forced bf16 "
              f"{d['tf_fp32']:.3e}")
    print(f"  the fp32 forward moves {out['sensitivity']:.3e} when its "
          f"embeddings move by {RW_SENSITIVITY_EPS:.1e} (relative), where "
          f"bf16 lies {max(d['tf_fp32'] for d in b):.3e} from it at worst: "
          f"the random model amplifies a rounding, so bf16 logits are held "
          f"only to the bf16 path's own error")
    print(f"  fp32 served vs teacher-forced fp32 logits: worst "
          f"{max(d['served_tf'] for d in f):.3e} (gate {RW_FP32_RTOL}); "
          f"argmax equal at all {checked} positions with a top-2 margin "
          f"above {LM_RTOL} * max|logit|, {under} under it")
    out.update(fp32_checked=checked, fp32_under_margin=under)
    return out


def family_serving(rec: dict, params, cfg, *, cap: float, reference,
                   greedy: tuple[int, int], fp32_cfg=None,
                   chaotic: bool = False) -> None:
    """Phase 13's checks on one family: the engine on phase 13's prompts
    (128-1024 tokens, 32 new, 4 slots, cache 2048), its bf16 logits held to
    teacher-forced forwards (``hold_served_logits``, bf16 cap ``cap``);
    prefill per prompt length and the decode step timed, the decode step's
    idle share under torch.profiler; then ``greedy`` = (prompts, tokens)
    served in fp32 on ``fp32_cfg`` (default ``cfg``), equal to
    ``reference(params, cfg32, prompt, n)``, with the share of MoE choices
    its prefills drop.  ``chaotic`` holds the logits by
    ``hold_chaotic_logits`` instead."""
    import numpy as np
    import torch

    from repro_torch.models import transformer as TF
    from repro_torch.serve import Request, ServeConfig, ServingEngine

    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab, n).astype(np.int32)
               for n in LM_PROMPTS]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = ServingEngine(params, cfg, ServeConfig(slots=BATCH,
                                                    cache_len=LM_CACHE),
                           device="cuda")
    reqs = [Request(uid=i, prompt=p, max_new_tokens=LM_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    with recording(engine) as log:
        t0 = time.monotonic()
        engine.run_until_drained()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    rec["engine_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    toks = sum(len(r.output) for r in engine.completed)
    rec.update(engine_s=wall, tokens=toks, tokens_per_s=toks / wall,
               engine_steps=engine.steps)
    print(f"  engine: {len(engine.completed)} requests / {toks} tokens in "
          f"{wall:.3f} s ({toks / wall:.1f} tok/s, prefills included), "
          f"{engine.steps} decode steps; peak memory "
          f"{rec['engine_peak_gb']:.2f} GB")
    if sorted((r.uid, len(r.output)) for r in engine.completed) \
            != [(i, LM_NEW) for i in range(len(prompts))]:
        fail("the engine did not serve every request its token count")
    if chaotic:
        held = hold_chaotic_logits(params, cfg, prompts, log.served(reqs),
                                   reqs)
        rows = held.pop("bf16")
        rec.update(logits=rows, **held)
    else:
        rows, checked, under = hold_served_logits(params, cfg, reqs,
                                                  log.served(reqs), cap)
        rec.update(logits=rows, argmax_checked=checked,
                   argmax_under_margin=under, bf16_cap=cap)
    rec["bf16_vs_fp32_worst"] = max(max(d["tf_fp32"], d["served_fp32"])
                                    for d in rows)

    prefill_ms = {}
    with torch.inference_mode():
        for p in prompts:
            t = torch.as_tensor(p, dtype=torch.long, device="cuda")[None]
            prefill_ms[len(p)] = time_ms(
                lambda: TF.prefill(params, cfg, t, cache_len=LM_CACHE),
                reps=3, iters=1)
        caches, pos = engine.caches, torch.full((BATCH,), 1100,
                                                device="cuda")
        tok = torch.zeros(BATCH, dtype=torch.long, device="cuda")
        decode_ms = time_ms(lambda: TF.decode_step(params, cfg, tok, caches,
                                                   pos), reps=3, iters=3)
        n = 4
        wall_ms, busy_ms, n_launch, top = busy_share(lambda: [
            TF.decode_step(params, cfg, tok, caches, pos)[0].argmax(-1)
            .tolist() for _ in range(n)])
    cast_ms = sum(ms for key, ms in top if "copy" in key.lower())
    top = [(key[:70], round(ms / n, 4)) for key, ms in top[:8]]
    rec.update(prefill_ms=prefill_ms, decode_ms=decode_ms,
               decode_wall_ms=wall_ms / n, decode_busy_ms=busy_ms / n,
               decode_idle=1 - busy_ms / wall_ms, decode_copy_ms=cast_ms / n,
               decode_top=top, decode_launches=n_launch / n,
               decode_tokens_per_s=BATCH / decode_ms * 1e3)
    print(f"  prefill (1 prompt, CUDA events): "
          f"{ {k: round(v, 2) for k, v in prefill_ms.items()} } ms")
    print(f"  decode step ({BATCH} slots): {decode_ms:.2f} ms (CUDA events, "
          f"{BATCH / decode_ms * 1e3:.1f} tokens/s); under torch.profiler "
          f"{wall_ms / n:.2f} ms wall, {busy_ms / n:.2f} ms device busy, "
          f"idle {1 - busy_ms / wall_ms:.1%}; {n_launch / n:.0f} kernel "
          f"launches a step; dtype casts and copies {cast_ms / n:.2f} ms a "
          f"step; top {top[:5]}")
    del engine, caches

    cfg32 = dataclasses.replace(fp32_cfg or cfg, dtype=torch.float32)
    engine = ServingEngine(params, cfg32, ServeConfig(slots=BATCH,
                                                      cache_len=LM_CACHE),
                           device="cuda")
    n_req, n_new = greedy
    for i, p in enumerate(prompts[:n_req]):
        engine.submit(Request(uid=i, prompt=p, max_new_tokens=n_new))
    t0 = time.monotonic()
    with drops() as log:
        engine.run_until_drained()
    with torch.inference_mode():
        for r in engine.completed:
            ref = reference(params, cfg32, r.prompt, len(r.output))
            if r.output != ref:
                fail(f"fp32 request {r.uid}: served {r.output} but "
                     f"{reference.__name__} gives {ref}")
    rec.update(fp32_reference_s=time.monotonic() - t0,
               fp32_prefill_drop_share=log.share())
    moe = cfg32.moe
    print(f"  fp32: {len(engine.completed)} requests x {n_new} tokens equal "
          f"{reference.__name__} token for token "
          f"({rec['fp32_reference_s']:.1f} s)"
          + ("" if moe is None else
             f"; at capacity factor {moe.capacity_factor} the engine's "
             f"prefills drop {log.share():.2%} of choices")
          + f"; {gpu_memory()}")


def greedy_forward(params, cfg, prompt, n: int) -> list[int]:
    """Naive greedy decoding: a full forward over the sequence a token."""
    import torch

    from repro_torch.models import transformer as TF
    cur = torch.as_tensor(prompt, dtype=torch.long, device="cuda")[None]
    out = []
    for _ in range(n):
        nxt = int(TF.forward(params, cfg, tokens=cur)[0][0, -1].argmax())
        out.append(nxt)
        cur = torch.cat([cur, torch.tensor([[nxt]], device="cuda")], 1)
    return out


def greedy_steps(params, cfg, prompt, n: int) -> list[int]:
    """Greedy decoding by ``prefill`` and ``decode_step`` at batch 1,
    outside the engine."""
    import torch

    from repro_torch.models import transformer as TF
    t = torch.as_tensor(prompt, dtype=torch.long, device="cuda")[None]
    logits, caches = TF.prefill(params, cfg, t, cache_len=LM_CACHE)
    out = [int(logits[0].argmax())]
    pos = len(prompt)
    while len(out) < n:
        logits, caches = TF.decode_step(
            params, cfg, torch.tensor([out[-1]], device="cuda"), caches,
            torch.tensor([pos], device="cuda"))
        out.append(int(logits[0].argmax()))
        pos += 1
    return out


def step_profile(trainer) -> dict:
    """One more training step of ``trainer`` (its step-0 batch) under
    torch.profiler: wall, device busy, idle share, launches and the top
    device entries; the step updates the trainer's params."""
    batch = trainer._device_batch(0)
    wall, busy, n_launch, top = busy_share(lambda: trainer._one_step(batch))
    top = [(key[:60], round(ms, 2)) for key, ms in top[:8]]
    print(f"  one step under torch.profiler: {wall:.1f} ms wall, "
          f"{busy:.1f} ms device busy, idle {1 - busy / wall:.1%}, "
          f"{n_launch} kernel launches; top device entries (ms) {top[:6]}")
    return dict(profiled_wall_ms=wall, device_busy_ms=busy,
                device_idle=1 - busy / wall, launches_a_step=n_launch,
                device_top=top)


def draw(cfg, what: str) -> dict:
    """Params of ``cfg`` from seed 0, drawn on the card (``card_params``)."""
    import torch

    torch.cuda.empty_cache()
    t0 = time.monotonic()
    params = card_params(cfg, seed=0)
    torch.cuda.synchronize()
    print(f"  {what}: {cfg.n_layers} layers, d {cfg.d_model}, vocab "
          f"{cfg.vocab}, {cfg.param_count() / 1e9:.3f}B params (fp32, "
          f"{cfg.param_count() * 4 / 1e9:.1f} GB), compute {cfg.dtype}; "
          f"drawn from seed 0 on the card in {time.monotonic() - t0:.1f} s")
    return params


def rwkv_phase(record: dict) -> None:
    """Phase 17(a): full-depth rwkv6-3b: the WKV scan on one full-width
    layer, served; its first ``RW_TRAIN_LAYERS`` layers trained."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.launch import serve as serve_launch
    from repro_torch.launch import train as launch
    from repro_torch.models import registry as reg
    from repro_torch.models import rwkv6 as RW
    from repro_torch.tree import tree_map

    cfg = reg.get(RW_ARCH).config
    rec = record["rwkv"] = dict(arch=RW_ARCH, params=cfg.param_count(),
                                bf16_predicted=RW_BF16_PREDICTED)
    params = draw(cfg, cfg.name)

    # The chunked scan against the step recurrence on layer 0's decays.
    tm = tree_map(lambda t: t[0], params["layers"]["m0"]["tm"])
    h, dh = cfg.rwkv.n_heads, cfg.rwkv.head_dim
    x = torch.randn(1, RW_WKV_TOKENS, cfg.d_model, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3))
    with torch.inference_mode():
        r, k, v, _, lw = RW._projections(tm, x, RW._token_shift(x, None),
                                         (1, RW_WKV_TOKENS, h, dh))
        u = tm["bonus_u"].reshape(h, dh)
        o_c, s_c = RW.wkv_chunked(r, k, v, lw, u)
        s = torch.zeros(1, h, dh, dh, device="cuda")
        outs = []
        for t in range(RW_WKV_TOKENS):
            o, s = RW.wkv_step(r[:, t], k[:, t], v[:, t], lw[:, t], u, s)
            outs.append(o)
        o_s = torch.stack(outs, 1)
    wkv_rel = ((o_c - o_s).norm() / o_s.norm()).item()
    state_rel = ((s_c - s).norm() / s.norm()).item()
    print(f"  wkv_chunked vs {RW_WKV_TOKENS} wkv_step calls ({h} heads x "
          f"{dh}, decays {lw.min().item():.3f} to {lw.max().item():.3f}): "
          f"out {wkv_rel:.2e}, final state {state_rel:.2e} (gate "
          f"{RW_WKV_RTOL})")
    if max(wkv_rel, state_rel) > RW_WKV_RTOL:
        fail(f"the chunked WKV is {wkv_rel} / {state_rel} from its steps")
    rec.update(wkv_rel=wkv_rel, wkv_state_rel=state_rel)
    del tm, x, r, k, v, lw, o_c, o_s, s, s_c, outs

    # The launcher with its defaults, then phase 13's checks.
    args = serve_launch.build_parser().parse_args(
        ["--arch", RW_ARCH, "--device", "cuda", "--seed", "0"])
    engine, steps, seconds = serve_launch.serve_lm(cfg, args, params=params)
    print(serve_launch.report_lm(engine, steps, seconds))
    if sorted((r.uid, len(r.output)) for r in engine.completed) \
            != [(i, args.max_new_tokens) for i in range(args.requests)]:
        fail("serve_lm did not serve every request its token count")
    rec["serve_lm_s"] = seconds
    c = engine.caches["layers"]["m0"]
    print(f"  caches: shift_tm {tuple(c['shift_tm'].shape)} "
          f"{c['shift_tm'].dtype}, wkv {tuple(c['wkv'].shape)} "
          f"{c['wkv'].dtype}")
    if c["wkv"].dtype != torch.float32 or c["shift_tm"].dtype != cfg.dtype:
        fail("the RWKV caches lost their dtypes")
    del engine, c
    family_serving(rec, params, cfg, cap=RW_BF16_MAX,
                   reference=greedy_forward, chaotic=True,
                   greedy=(RW_GREEDY_PROMPTS, RW_GREEDY_NEW))

    # Training: the first RW_TRAIN_LAYERS layers of the served params.
    tcfg = dataclasses.replace(cfg, n_layers=RW_TRAIN_LAYERS)
    params = cut_depth(params, tcfg)
    root = ROOT / "build" / "smoke_rwkv"
    shutil.rmtree(root, ignore_errors=True)
    batch = RW_TRAIN_BATCH
    args = train_lm_args(RW_ARCH, RW_TRAIN_STEPS, root, "--full",
                         "--global-batch", str(batch), "--seq-len",
                         str(RW_SEQ))
    loss0_want = ce_prediction(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    tr = launch.train_lm(tcfg, args, params=params)
    rec.update(train_wall_s=time.monotonic() - t0,
               train_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               train_batch=batch, seq_len=RW_SEQ,
               train_layers=RW_TRAIN_LAYERS,
               train_params=tcfg.param_count())
    losses = [hh["loss"] for hh in tr.history if "loss" in hh]
    host_ms = [t * 1e3 for t in tr.step_seconds]
    step_ms = statistics.median(host_ms[1:])
    tokens = batch * RW_SEQ
    loss0_rel = abs(losses[0] - loss0_want) / loss0_want
    print(f"  trained {RW_TRAIN_LAYERS} layers ({tcfg.param_count() / 1e9:.3f}"
          f"B params) {RW_TRAIN_STEPS} steps at batch {batch} x {RW_SEQ} "
          f"(remat {cfg.remat!r}, AdamW) in {rec['train_wall_s']:.1f} s (a "
          f"checkpoint of params and AdamW state at the end); losses "
          f"{[round(v, 5) for v in losses]}; step 0 vs the predicted "
          f"{loss0_want:.4f}: {loss0_rel:.2%}; host-clock steps "
          f"{[round(t, 1) for t in host_ms]} ms (median after the first "
          f"{step_ms:.1f} ms, {tokens / step_ms * 1e3:.0f} tokens/s); "
          f"telemetry {tr.telemetry}; peak memory "
          f"{rec['train_peak_gb']:.2f} GB")
    if len(losses) != RW_TRAIN_STEPS or not np.isfinite(losses).all() \
            or tr.telemetry["skipped"] or loss0_rel > LM_LOSS0_RTOL:
        fail(f"{RW_ARCH} training: losses {losses}, telemetry "
             f"{tr.telemetry}, step 0 {loss0_rel} from {loss0_want}")
    rec.update(losses=losses, host_step_ms=host_ms, step_ms=step_ms,
               tokens_per_s=tokens / step_ms * 1e3, loss0_predicted=loss0_want,
               **step_profile(tr))
    del tr, params
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()


def moe_phase(record: dict) -> None:
    """Phase 17(b): dbrx-132b at its published widths, cut to
    ``MOE_LAYERS`` layers: served, then one layer's loss and gradient."""
    import torch

    from repro_torch.launch import serve as serve_launch
    from repro_torch.models import registry as reg
    from repro_torch.models import transformer as TF
    from repro_torch.tree import leaves, tree_map

    full = reg.get(MOE_ARCH).config
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    cfg_free = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=e / k))
    rec = record["moe"] = dict(
        arch=MOE_ARCH, layers=MOE_LAYERS, params=cfg.param_count(),
        active_params=cfg.active_param_count(),
        full_params=full.param_count(), bf16_predicted=MOE_BF16_PREDICTED)
    print(f"  (the full {full.n_layers} layers hold "
          f"{full.param_count() / 1e9:.1f}B params, "
          f"{full.param_count() * 4 / 1e9:.0f} GB in fp32; {MOE_LAYERS} "
          f"layers: {cfg.active_param_count() / 1e9:.3f}B active a token, "
          f"{e} experts, top {k})")
    params = draw(cfg, f"{cfg.name} cut to {MOE_LAYERS} layers")

    # The launcher at the published capacity factor, its drops printed.
    args = serve_launch.build_parser().parse_args(
        ["--arch", MOE_ARCH, "--device", "cuda", "--seed", "0"])
    with drops() as log:
        engine, steps, seconds = serve_launch.serve_lm(cfg, args,
                                                       params=params)
    print(serve_launch.report_lm(engine, steps, seconds))
    if sorted((r.uid, len(r.output)) for r in engine.completed) \
            != [(i, args.max_new_tokens) for i in range(args.requests)]:
        fail("serve_lm did not serve every request its token count")
    per = [round(d / c, 4) for c, d in log.calls]
    print(f"  capacity factor {cfg.moe.capacity_factor}: share of choices "
          f"dropped in each prefill's MoE layers {per}; {log.share():.2%} "
          f"over all; decode drops none (full capacity)")
    rec.update(serve_lm_s=seconds, prefill_drop_shares=per,
               prefill_drop_share=log.share())
    del engine

    # Phase 13's checks on the drop-free copy; fp32 at the published
    # factor against prefill + decode_step outside the engine.
    family_serving(rec, params, cfg_free, cap=MOE_BF16_MAX,
                   reference=greedy_steps, fp32_cfg=cfg,
                   greedy=(MOE_GREEDY_PROMPTS, MOE_GREEDY_NEW))
    # One layer of the same params through loss_fn and its backward.
    one = dataclasses.replace(cfg, n_layers=1)
    p1 = {key: val for key, val in params.items() if key != "layers"}
    p1["layers"] = tree_map(lambda t: t[:1].clone(), params["layers"])
    del params
    torch.cuda.empty_cache()
    b, s = MOE_LOSS_BATCH
    g = torch.Generator(device="cuda").manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), device="cuda",
                                     generator=g),
             "targets": torch.randint(0, cfg.vocab, (b, s), device="cuda",
                                      generator=g)}
    torch.cuda.reset_peak_memory_stats()
    pg = tree_map(lambda t: t.detach().requires_grad_(True), p1)
    t0 = time.monotonic()
    with drops() as log:
        loss, metrics = TF.loss_fn(pg, one, batch)
    grads = torch.autograd.grad(loss, leaves(pg))
    torch.cuda.synchronize()
    loss_s = time.monotonic() - t0
    gnorm = math.sqrt(sum(float(gr.float().square().sum()) for gr in grads))
    peak = torch.cuda.max_memory_allocated() / 1e9
    del grads, pg
    with torch.no_grad():
        loss32, m32 = TF.loss_fn(p1, dataclasses.replace(
            one, dtype=torch.float32), batch)
    loss, aux, loss32 = loss.item(), metrics["moe_aux"].item(), loss32.item()
    rel = abs(loss - loss32) / loss32
    want = ce_prediction(one)
    print(f"  1 layer ({one.param_count() / 1e9:.3f}B params), batch {b} x "
          f"{s}: loss {loss:.5f} (predicted ~{want:.3f} + 0.01 x aux), aux "
          f"{aux:.5f}, drops {log.share():.2%}; fp32-compute loss "
          f"{loss32:.5f} (rel {rel:.2e}, gate {MOE_LOSS_BF16_RTOL}); "
          f"gradient norm {gnorm:.4e}; forward + backward {loss_s:.2f} s; "
          f"peak memory {peak:.2f} GB")
    if not (math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0
            and math.isfinite(aux) and aux > 0) \
            or rel > MOE_LOSS_BF16_RTOL:
        fail(f"{MOE_ARCH} one-layer loss {loss}, aux {aux}, fp32 {loss32}, "
             f"gradient norm {gnorm}")
    rec.update(loss_layers=1, loss=loss, aux=aux, loss_fp32=loss32,
               loss_bf16_rel=rel, grad_norm=gnorm, loss_peak_gb=peak,
               loss_drop_share=log.share(), loss_s=loss_s)
    del p1, batch
    torch.cuda.empty_cache()


def codebook_phase(record: dict) -> None:
    """Phase 17(c): full musicgen-medium: decode with (B, CB) tokens
    against the teacher-forced forward, the launcher's refusal, step-0
    checks; its first ``MG_TRAIN_LAYERS`` layers 6 training steps."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.data import LMDataConfig, lm_batch
    from repro_torch.launch import serve as serve_launch
    from repro_torch.launch import train as launch
    from repro_torch.models import layers as L
    from repro_torch.models import registry as reg
    from repro_torch.models import transformer as TF

    cfg = reg.get(MG_ARCH).config
    cb = cfg.codebooks
    rec = record["codebooks"] = dict(arch=MG_ARCH, params=cfg.param_count())
    params = draw(cfg, cfg.name)

    # fp32 prefill + decode with (B, CB) tokens vs the teacher-forced run.
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    g = torch.Generator(device="cuda").manual_seed(7)
    toks = torch.randint(0, cfg.vocab, (2, MG_PROMPT + MG_DECODE_STEPS, cb),
                         device="cuda", generator=g)
    worst = 0.0
    with torch.inference_mode():
        full = TF.forward(params, cfg32, tokens=toks)[0]
        logits, caches = TF.prefill(params, cfg32, toks[:, :MG_PROMPT],
                                    cache_len=LM_CACHE)
        rows = [(logits, full[:, MG_PROMPT - 1])]
        for i in range(MG_DECODE_STEPS):
            pos = torch.full((2,), MG_PROMPT + i, device="cuda")
            logits, caches = TF.decode_step(params, cfg32,
                                            toks[:, MG_PROMPT + i], caches,
                                            pos)
            rows.append((logits, full[:, MG_PROMPT + i]))
        for got, want in rows:
            if got.shape != (2, cb, cfg.vocab):
                fail(f"codebook logits of shape {tuple(got.shape)}")
            worst = max(worst, ((got - want).abs().max()
                                / want.abs().max()).item())
    del full, caches
    print(f"  fp32 prefill ({MG_PROMPT} tokens x {cb} codebooks) + "
          f"{MG_DECODE_STEPS} decode steps with (2, {cb}) tokens: logits "
          f"(2, {cb}, {cfg.vocab}), worst max|diff| / max|logit| vs the "
          f"teacher-forced forward {worst:.2e} (gate {DECODE_RTOL})")
    if worst > DECODE_RTOL:
        fail(f"{MG_ARCH} decode is {worst} from its teacher-forced forward")
    rec["decode_rel"] = worst

    args = serve_launch.build_parser().parse_args(
        ["--arch", MG_ARCH, "--device", "cuda"])
    try:
        serve_launch.serve_lm(cfg, args, params=params)
        fail("serve_lm served a multi-codebook config")
    except SystemExit as e:
        print(f"  serve_lm refuses it: {e}")
        rec["serve_refusal"] = str(e)

    # Step 0 on the step-0 batch, then 6 steps through train_lm.
    root = ROOT / "build" / "smoke_codebooks"
    shutil.rmtree(root, ignore_errors=True)
    args = train_lm_args(MG_ARCH, MG_TRAIN_STEPS, root, "--full", *MG_TRAIN)
    data = LMDataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                        global_batch=args.global_batch, codebooks=cb,
                        seed=args.seed)
    batch = {key: torch.from_numpy(val).to("cuda")
             for key, val in lm_batch(data, 0).items()}
    w = params["heads"]["unembedding"]
    with torch.no_grad():
        hidden = TF.forward(params, cfg, tokens=batch["tokens"],
                            return_hidden=True)[0]
        chunked = (sum(L.chunked_cross_entropy(
            hidden, w[i], batch["targets"][..., i], tied=False)
            for i in range(cb)) / cb).item()
        logits = TF._logits(params, cfg, hidden)
        dense = (sum(L.cross_entropy(logits[:, :, i], batch["targets"][..., i])
                     for i in range(cb)) / cb).item()
        del logits, hidden
        loss32 = TF.loss_fn(params, cfg32, batch)[0].item()
    ce_rel = abs(chunked - dense) / dense
    bf16_rel = abs(chunked - loss32) / loss32
    want = ce_prediction(cfg)
    print(f"  step 0: chunked CE {chunked:.6f} (mean of {cb} codebooks; "
          f"predicted {want:.4f}), dense CE of the full logits {dense:.6f} "
          f"(rel {ce_rel:.2e}, gate {LM_CE_RTOL}); fp32-compute loss "
          f"{loss32:.6f} (rel {bf16_rel:.2e}, gate {LM_BF16_LOSS_RTOL})")
    if ce_rel > LM_CE_RTOL or bf16_rel > LM_BF16_LOSS_RTOL:
        fail(f"{MG_ARCH} step 0: chunked {chunked}, dense {dense}, fp32 "
             f"{loss32}")
    # Training at MG_TRAIN_LAYERS: its step 0 against the chunked CE of
    # the same cut params.
    tcfg = dataclasses.replace(cfg, n_layers=MG_TRAIN_LAYERS)
    params = cut_depth(params, tcfg)
    with torch.no_grad():
        hidden = TF.forward(params, tcfg, tokens=batch["tokens"],
                            return_hidden=True)[0]
        t_chunked = (sum(L.chunked_cross_entropy(
            hidden, w[i], batch["targets"][..., i], tied=False)
            for i in range(cb)) / cb).item()
        del hidden
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    tr = launch.train_lm(tcfg, args, params=params)
    wall = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [hh["loss"] for hh in tr.history if "loss" in hh]
    host_ms = [t * 1e3 for t in tr.step_seconds]
    step_ms = statistics.median(host_ms[1:])
    tokens = args.global_batch * args.seq_len
    loss0_rel = abs(losses[0] - want) / want
    print(f"  {MG_TRAIN_LAYERS} layers ({tcfg.param_count() / 1e9:.3f}B "
          f"params) {MG_TRAIN_STEPS} steps at batch {args.global_batch} x "
          f"{args.seq_len} x {cb} codebooks in {wall:.1f} s (a checkpoint "
          f"at the end); losses "
          f"{[round(v, 5) for v in losses]} (step 0 {loss0_rel:.2%} from "
          f"the prediction); host-clock steps "
          f"{[round(t, 1) for t in host_ms]} ms (median after the first "
          f"{step_ms:.1f} ms, {tokens / step_ms * 1e3:.0f} tokens/s); "
          f"telemetry {tr.telemetry}; peak memory {peak:.2f} GB")
    if len(losses) != MG_TRAIN_STEPS or not np.isfinite(losses).all() \
            or tr.telemetry["skipped"] or loss0_rel > LM_LOSS0_RTOL \
            or abs(losses[0] - t_chunked) > LM_CE_RTOL * t_chunked:
        fail(f"{MG_ARCH} training: losses {losses}, telemetry "
             f"{tr.telemetry}, step 0 vs chunked CE {t_chunked}")
    rec.update(chunked_ce=chunked, dense_ce=dense, ce_rel=ce_rel,
               train_layers=MG_TRAIN_LAYERS, train_chunked_ce=t_chunked,
               loss_fp32=loss32, bf16_loss_rel=bf16_rel,
               loss0_predicted=want, losses=losses, host_step_ms=host_ms,
               step_ms=step_ms, tokens_per_s=tokens / step_ms * 1e3,
               train_peak_gb=peak, train_wall_s=wall, **step_profile(tr))
    del tr, params, batch
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()


def frontend_phase(record: dict) -> None:
    """Phase 17(d): pixtral-12b at its published widths, cut to
    ``PX_LAYERS`` layers, with (B, 256, D) frontend embeddings."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models import registry as reg
    from repro_torch.models import transformer as TF

    full = reg.get(PX_ARCH).config
    cfg32 = dataclasses.replace(full, n_layers=PX_LAYERS, dtype=torch.float32)
    rec = record["frontend"] = dict(arch=PX_ARCH, layers=PX_LAYERS,
                                    params=cfg32.param_count())
    params = draw(cfg32, f"{full.name} cut to {PX_LAYERS} layers")
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device="cuda").manual_seed(9)
    fe = torch.randn(2, PX_FRONTEND, full.d_model, device="cuda",
                     generator=g)
    toks = torch.randint(0, full.vocab, (2, PX_TEXT), device="cuda",
                         generator=g)
    targets = torch.randint(0, full.vocab, (2, PX_TEXT), device="cuda",
                            generator=g)
    with torch.inference_mode():
        t0 = time.monotonic()
        logits = TF.forward(params, cfg32, tokens=toks, frontend=fe)[0]
        torch.cuda.synchronize()
        fwd_s = time.monotonic() - t0
        if logits.shape != (2, PX_FRONTEND + PX_TEXT, full.vocab) \
                or not bool(torch.isfinite(logits).all()):
            fail(f"frontend forward: logits {tuple(logits.shape)}")
        loss, _ = TF.loss_fn(params, cfg32, {"tokens": toks,
                                             "targets": targets,
                                             "frontend": fe})
        hidden = TF.forward(params, cfg32, tokens=toks, frontend=fe,
                            return_hidden=True)[0]
        text = L.chunked_cross_entropy(hidden[:, PX_FRONTEND:],
                                       params["unembed"]["unembedding"],
                                       targets, tied=False)
        loss_rel = abs(loss.item() - text.item()) / text.item()
        worst = 0.0
        n = PX_TEXT - PX_DECODE_STEPS
        last, caches = TF.prefill(params, cfg32, toks[:, :n],
                                  cache_len=LM_CACHE, frontend=fe)
        worst = (last - logits[:, PX_FRONTEND + n - 1]).abs().max().item()
        for i in range(PX_DECODE_STEPS):
            pos = torch.full((2,), PX_FRONTEND + n + i, device="cuda")
            last, caches = TF.decode_step(params, cfg32, toks[:, n + i],
                                          caches, pos)
            worst = max(worst, (last - logits[:, PX_FRONTEND + n + i])
                        .abs().max().item())
        worst /= logits.abs().max().item()
    print(f"  forward with a (2, {PX_FRONTEND}, {full.d_model}) frontend and "
          f"{PX_TEXT} text tokens in fp32: logits "
          f"{tuple(logits.shape)} in {fwd_s:.2f} s; loss_fn {loss.item():.6f}"
          f" vs the chunked CE of the hidden state after the frontend "
          f"{text.item():.6f} (rel {loss_rel:.1e}); prefill with the "
          f"frontend + {PX_DECODE_STEPS} decode steps vs the teacher-forced "
          f"forward: worst {worst:.2e} (gate {DECODE_RTOL}); {gpu_memory()}")
    if loss_rel > 1e-6 or worst > DECODE_RTOL:
        fail(f"{PX_ARCH}: loss {loss.item()} vs {text.item()}, decode "
             f"{worst}")
    rec.update(loss=loss.item(), text_ce=text.item(), loss_rel=loss_rel,
               decode_rel=worst, forward_s=fwd_s)
    del params, logits, hidden, caches, fe
    torch.cuda.empty_cache()


def reduced_phase(record: dict) -> None:
    """Phase 17(e): each family's reduced config in fp32, 3 steps of
    ``train_lm`` on the card and on the CPU."""
    import shutil

    from repro_torch.launch import train as launch
    from repro_torch.models import registry as reg

    root = ROOT / "build" / "smoke_p17_reduced"
    out = record["p17_reduced"] = {}
    for arch in P17_ARCHS:
        hist = {}
        for dev in ("cuda", "cpu"):
            a = train_lm_args(arch, P17_REDUCED_STEPS,
                              root / f"{arch}_{dev}")
            a.device = dev
            tr = launch.train_lm(reg.get(arch).config, a)
            hist[dev] = [hh["loss"] for hh in tr.history if "loss" in hh]
        rel = max(abs(x - y) / abs(y) for x, y in zip(hist["cuda"],
                                                      hist["cpu"]))
        print(f"  reduced {arch} (fp32, TF32 off): card "
              f"{[round(v, 6) for v in hist['cuda']]}, CPU "
              f"{[round(v, 6) for v in hist['cpu']]}; worst relative "
              f"difference {rel:.2e} (gate {LM_CARD_CPU_RTOL})")
        if len(hist["cuda"]) != P17_REDUCED_STEPS or rel > LM_CARD_CPU_RTOL:
            fail(f"reduced {arch} differs between card and CPU: {hist}")
        out[arch] = dict(card=hist["cuda"], cpu=hist["cpu"], rel=rel)
    shutil.rmtree(root, ignore_errors=True)


def families_phase(record: dict) -> None:
    """Phase 17: (a)-(e); no kernel of the port launches."""
    t0 = time.monotonic()
    reset_counts()
    print(f"  (a) rwkv6-3b at full width and depth: WKV, served; "
          f"{RW_TRAIN_LAYERS} layers trained")
    rwkv_phase(record)
    print(f"  (b) {MOE_ARCH} at full width, {MOE_LAYERS} layers: served; one "
          f"layer's loss and gradient")
    moe_phase(record)
    print("  (c) musicgen-medium at full width and depth: decode, refusal, "
          "trained")
    codebook_phase(record)
    print(f"  (d) {PX_ARCH} at full width, {PX_LAYERS} layers, with frontend "
          f"embeddings")
    frontend_phase(record)
    print("  (e) the five reduced configs, card vs CPU")
    reduced_phase(record)
    counts = read_counts()
    if any(counts.values()):
        fail(f"the LM paths launched a kernel: {counts}")
    record["phase17_s"] = time.monotonic() - t0
    print(f"  phase 17 in {record['phase17_s']:.1f} s on {smi()}; no kernel "
          f"of the port launched (its LM paths are plain PyTorch, as the "
          f"JAX model's are XLA)")


# ---------------------------------------------------------------------------
# Phase 18: the device mesh
# ---------------------------------------------------------------------------

DEV = "cuda"                # phase 18's device (a rehearsal sets "cpu")
MESH_SHARDS = (2, 4)
MESH_SPATIAL = ((256, 2), (512, 4))
MESH_MAX_SHARDS = 4
MESH_RTOL = 1e-5            # kernel 1a at the chooser's shard-local tiles
MESH_SERVE_RTOL = BANDED_VS_ZC_RTOL   # served fp32: another summation order
MESH_INT8_SHARE = 0.5       # served int8 vs the flat int8 engine (relative
                            # norm) over the int8 rung's own error vs fp32:
                            # shard-local tiles move the band frame a patch
                            # rounds in, and the next layer's activation
                            # grid turns those flips into whole steps
MESH_SPREAD = 2.0           # params vs the flat Trainer (relative norm):
                            # at most this x the flat run's own spread under
                            # another summation order (the banded dataflow),
                            # and never held below RESUME_RTOL
MESH_TRAIN_STEPS = 2
MESH_SECONDS = 60           # phase 18's budget (printed, not gated)
CR_ARCH = "command-r-35b"
CR_LAYERS = 4               # 4.92B params (19.7 GB fp32); all 40: 121 GB
CR_BF16_PREDICTED = 1e-2    # bf16 vs fp32 logits at 4 layers (PERF.md §6)
CR_BF16_MAX = 1.5 * max(CR_BF16_PREDICTED, LM_BF16_MAX)
CR_PIPE = (2, 4)            # stages, microbatches
CR_PIPE_TOKENS = (4, 256)
CR_PIPE_RTOL = 1e-5         # pipelined vs transformer.forward (fp32)
CR_GREEDY = (2, 8)
MESH_CARD_CPU_RTOL = 1e-4


def card_params(cfg, seed: int = 0) -> dict:
    """Params of the LM ``cfg`` drawn on ``DEV`` from a seeded generator
    of that device, at ``layers.init_param``'s scales: the same
    distribution as ``transformer.init_params``, another draw, and no
    host round trip (drawing 14.6B params on the CPU took 130 s, PR 24)."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TF
    from repro_torch.tree import tree_map

    gen = torch.Generator(device=DEV).manual_seed(seed)

    def one(d):
        kw = dict(device=DEV)
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=d.dtype, **kw)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=d.dtype, **kw)
        if d.init in ("normal", "embed"):
            return torch.randn(d.shape, generator=gen, **kw) \
                .mul_(L.default_scale(d)).to(d.dtype)
        if d.init == "uniform":
            lim = L.default_scale(d)
            return (torch.rand(d.shape, generator=gen, **kw) * (2 * lim)
                    - lim).to(d.dtype)
        raise ValueError(f"unknown init {d.init!r}")

    defs = TF.model_def(cfg)
    period = defs.pop("period")
    params = tree_map(one, defs)
    params["layers"] = tree_map(one, TF._stacked(period, cfg.n_periods))
    return params


def repeated_mesh(n: int, names=("model",)):
    """A mesh of ``n`` shards on the one card (or the CPU)."""
    import numpy as np
    import torch

    from repro_torch.distributed.sharding import Mesh
    dev = torch.device(DEV, 0) if DEV == "cuda" else torch.device(DEV)
    shape = (n,) if len(names) == 1 else n
    devs = np.empty(shape, dtype=object)
    devs[...] = dev
    return Mesh(devs, names)


def launch_want(n: int) -> int:
    """Launches a kernel wrapper counts for ``n`` calls: none on the CPU
    (the plain versions), where a rehearsal runs this phase."""
    return n if DEV == "cuda" else 0


def n_dcl(cfg) -> int:
    return sum(cfg.is_dcn(i) for i in range(cfg.total_blocks))


def mesh_dcl_config():
    from repro_torch.configs.resnet50_dcn import CONFIG_BOUNDED
    return dataclasses.replace(CONFIG_BOUNDED, use_kernel=True)


def rel_max(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def mesh_kernel_case(case: dict, gen) -> dict:
    """Phase 18(a) at one DCL shape: kernel 1a sharded against unsharded
    (pinned tiles ``torch.equal``, the chooser's within 1e-5), 1c pinned
    ``torch.equal``, kernel 2's three gradients within 1e-4, and one
    launch of each a shard."""
    import math as _m

    import torch

    from repro_torch.core.tiling import out_hw
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.kernels import ops, plan

    n, h, w, c, m, s, shards = (case[k] for k in
                                ("n", "h", "w", "c", "m", "stride",
                                 "shards"))
    ho, wo = out_hw(h, w, kernel_size=K, stride=s)
    x = torch.randn(n, h, w, c, device=DEV, generator=gen)
    off = torch.randn(n, ho, wo, 2 * K * K, device=DEV, generator=gen) * 1.5
    wt = torch.randn(K * K, c, m, device=DEV, generator=gen) \
        / (K * K * c) ** 0.5
    mesh = repeated_mesh(shards)
    kw = dict(offset_bound=B, stride=s, device=DEV)

    def sharded(*args, **extra):
        before = read_counts()
        with use_rules(mesh=mesh):
            out = ops.deform_conv(*args, shard_spatial=True, **kw, **extra)
        return out, {k: v - before[k] for k, v in read_counts().items()}

    ref = ops.deform_conv(x, off, wt, **kw)
    y, launched = sharded(x, off, wt)
    err_chooser = rel_max(y, ref)
    ho_loc = ho // shards
    geom = dict(kernel_size=K, stride=s, dilation=1, offset_bound=B)
    th, tw, tc, tm = plan.resolve_tiles(n, h, w, c, m, device=x.device,
                                        **geom)
    pin = dict(tile_h=_m.gcd(min(th, ho), ho_loc), tile_w=tw, tile_c=tc,
               tile_m=tm)
    y_p, _ = sharded(x, off, wt, **pin)
    equal_fp32 = torch.equal(y_p, ops.deform_conv(x, off, wt, **kw, **pin))
    qh, qw, qc, qm = plan.resolve_tiles(n, h, w, c, m, dtype="int8",
                                        device=x.device, **geom)
    qpin = dict(tile_h=_m.gcd(min(qh, ho), ho_loc), tile_w=qw, tile_c=qc,
                tile_m=qm)
    with torch.no_grad():
        q, q_launched = sharded(x, off, wt, precision="int8", **qpin)
        equal_int8 = torch.equal(q, ops.deform_conv(
            x, off, wt, precision="int8", **kw, **qpin))
    leaves = [t.clone().requires_grad_() for t in (x, off, wt)]
    gy = torch.randn(n, ho, wo, m, device=DEV, generator=gen)
    g_ref = torch.autograd.grad(ops.deform_conv(*leaves, **kw), leaves, gy)
    before = read_counts()
    with use_rules(mesh=mesh):
        ys = ops.deform_conv(*leaves, shard_spatial=True, **kw)
    g_sh = torch.autograd.grad(ys, leaves, gy)
    bwd = read_counts()["deform_conv_bwd"] - before["deform_conv_bwd"]
    g_err = [rel_max(a, b) for a, b in zip(g_sh, g_ref)]
    rec = dict(case, ho=ho, wo=wo, err_chooser=err_chooser,
               pinned=list(pin.values()), int8_pinned=list(qpin.values()),
               equal_fp32=equal_fp32, equal_int8=equal_int8,
               grad_err=g_err, launches=dict(
                   fwd=launched["deform_conv_fused"],
                   int8=q_launched["deform_conv_fused_q"], bwd=bwd))
    if DEV == "cuda":
        with torch.no_grad():
            rec["ms"] = time_ms(lambda: ops.deform_conv(x, off, wt, **kw),
                                reps=3, iters=3)
            with use_rules(mesh=mesh):
                rec["sharded_ms"] = time_ms(lambda: ops.deform_conv(
                    x, off, wt, shard_spatial=True, **kw), reps=3, iters=3)
    ok = (err_chooser <= MESH_RTOL and equal_fp32 and equal_int8
          and max(g_err) <= BWD_RTOL
          and rec["launches"] == dict(fwd=launch_want(shards),
                                      int8=launch_want(shards),
                                      bwd=launch_want(shards)))
    print(f"  {case['label']:<24} {shards} shards: 1a chooser "
          f"{err_chooser:.2e}, pinned {tuple(pin.values())} equal "
          f"{equal_fp32}; 1c pinned {tuple(qpin.values())} equal "
          f"{equal_int8}; kernel 2 dx/doff/dw "
          f"{', '.join(f'{e:.1e}' for e in g_err)}; launches "
          f"{rec['launches']}"
          + (f"; unsharded {rec['ms']:.3f} ms, sharded "
             f"{rec['sharded_ms']:.3f} ms" if "ms" in rec else "")
          + (" ok" if ok else " FAIL"))
    if not ok:
        fail(f"phase 18(a) {case['label']} at {shards} shards: {rec}")
    return rec


def mesh_kernels(record: dict) -> None:
    """Phase 18(a): the 12 DCLs' shapes of the 512 bucket at batch 4 (5
    distinct) at 2 and 4 shards, and a stride-2 edge case."""
    import torch

    from repro_torch.serve import bucket_layer_dims

    shapes: dict[tuple, int] = {}
    for dims in bucket_layer_dims(mesh_dcl_config(), 512).values():
        key = (dims["h"], dims["w"], dims["c"], dims["m"], dims["stride"])
        shapes[key] = shapes.get(key, 0) + 1
    cases = [dict(label=f"{h}x{w}x{c}->{m} s{s} (x{k})", n=BATCH, h=h, w=w,
                  c=c, m=m, stride=s, shards=sh)
             for (h, w, c, m, s), k in shapes.items() for sh in MESH_SHARDS]
    cases.append(dict(label="edge 24x21x32->48 s2", n=2, h=24, w=21, c=32,
                      m=48, stride=2, shards=2))
    gen = torch.Generator(device=DEV).manual_seed(18)
    record["mesh_kernels"] = [mesh_kernel_case(c, gen) for c in cases]


def mesh_images(n: int = 8) -> list:
    """``n`` seeded images, alternately of the two spatial buckets."""
    import numpy as np
    rng = np.random.RandomState(18)
    sides = [b for b, _ in MESH_SPATIAL]
    return [rng.randn(sides[i % 2], sides[i % 2], 3).astype(np.float32)
            for i in range(n)]


def mesh_engine(params, cfg, quant: str, spatial, table):
    import torch

    from repro_torch.serve import DCLServeConfig, DCLServingEngine
    dev = torch.device(DEV, 0) if DEV == "cuda" else torch.device(DEV)
    return DCLServingEngine(
        params, cfg,
        DCLServeConfig(buckets=tuple(b for b, _ in MESH_SPATIAL),
                       slots=BATCH, quant=quant, spatial_shards=spatial),
        scale_table=table, device=DEV, devices=[dev] * MESH_MAX_SHARDS)


def mesh_serve(engine, images) -> list:
    reqs = [engine.submit(img) for img in images]
    engine.run_until_drained()
    return reqs


def mesh_serving(record: dict, params, flat_runs: dict, table) -> None:
    """Phase 18(b): the engine at buckets 256/512 with 2 and 4 shards on
    ``fp32_kernel`` and on an ``int8_chain`` entry (which enters at
    ``int8``); ``flat_runs`` holds the flat engine's requests."""
    import numpy as np

    def rel_norm(a, b) -> float:
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    def cat(reqs, key):
        return np.concatenate([r.result[key].ravel() for r in reqs])

    cfg = mesh_dcl_config()
    images = mesh_images()
    rec = record["mesh_serve"] = {}
    # The int8 rung's own error: the flat int8 engine against the flat
    # fp32 one (phase 6 reads 0.053-0.072 for cls).
    int8_err = max(rel_norm(cat(flat_runs["int8"], k),
                            cat(flat_runs["fp32_kernel"], k))
                   for k in ("cls", "box"))
    for quant, rung, fn in (("fp32_kernel", "fp32_kernel",
                             "deform_conv_fused"),
                            ("int8_chain", "int8", "deform_conv_fused_q")):
        engine = mesh_engine(params, cfg, quant, MESH_SPATIAL,
                             table if quant != "fp32_kernel" else None)
        before = read_counts()
        reqs = mesh_serve(engine, images)
        after = read_counts()
        launched = {k: after[k] - before[k] for k in after}
        steps = engine.telemetry()["steps_per_bucket"]
        want = launch_want(sum(n_dcl(cfg) * dict(MESH_SPATIAL)[int(b)] * n
                               for b, n in steps.items()))
        bad = [(r.uid, r.outcome, r.ladder, r.error) for r in reqs
               if r.outcome != "ok" or r.ladder != rung or r.degraded]
        others = {k: v for k, v in launched.items() if k != fn and v}
        worst, norm = {}, {}
        for key in ("cls", "box"):
            got, ref = cat(reqs, key), cat(flat_runs[rung], key)
            worst[key] = float(abs(got - ref).max() / abs(ref).max())
            norm[key] = rel_norm(got, ref)
        if rung == "fp32_kernel":
            ok = max(worst.values()) <= MESH_SERVE_RTOL
            gate = f"max {MESH_SERVE_RTOL} x max|flat|"
        else:
            ok = max(norm.values()) <= MESH_INT8_SHARE * int8_err
            gate = (f"relative norm {MESH_INT8_SHARE} x the int8 rung's own "
                    f"{int8_err:.2e} from fp32")
        sources = engine.telemetry()["plan_sources"]
        print(f"  {quant} entry, spatial {dict(MESH_SPATIAL)} on "
              f"{MESH_MAX_SHARDS} x {DEV}: {len(reqs)} requests "
              f"{sorted({r.outcome for r in reqs})} on {rung}; {fn} "
              f"{launched[fn]} launches in {dict(steps)} steps (want {want} "
              f"= {n_dcl(cfg)} DCLs x shards a step); cls/box vs the flat "
              f"engine max {worst['cls']:.2e} / {worst['box']:.2e} x "
              f"max|flat|, relative norm {norm['cls']:.2e} / "
              f"{norm['box']:.2e} (gate {gate}); plan sources "
              f"{sorted({v for s in sources.values() for v in s.values()})}")
        if bad or others or launched[fn] != want or not ok:
            fail(f"phase 18(b) {quant}: bad {bad}, other launches {others}, "
                 f"{launched[fn]} != {want}, worst {worst}, norm {norm}")
        rec[quant] = dict(rung=rung, launches=launched[fn], want=want,
                          steps=steps, worst=worst, rel_norm=norm,
                          requests=len(reqs))
    rec["int8_vs_fp32"] = int8_err


def mesh_trainer(cfg, base, *, mesh=None, compression=None, tag="",
                 device=None):
    """``MESH_TRAIN_STEPS`` Trainer steps of ``cfg`` at batch 8 from
    ``base``'s params (the launcher's optimizer and data) on ``device``
    (default ``DEV``), on ``mesh`` where one is given."""
    import shutil

    from repro_torch.data import DetectionDataConfig, detection_batch
    from repro_torch.launch.train import train_optimizer
    from repro_torch.models import resnet_dcn as R
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.tree import tree_map

    dev = device or DEV
    root = ROOT / "build" / "smoke_p18" / tag
    shutil.rmtree(root, ignore_errors=True)
    params = tree_map(lambda t: t.detach().clone(), base)
    data = DetectionDataConfig(img_size=cfg.img_size,
                               global_batch=TRAIN_BATCH,
                               num_classes=cfg.num_classes, seed=0)
    tr = Trainer(
        loss_fn=lambda p, b: R.train_loss(p, cfg, b, lam=0.005, device=dev),
        params=params, optimizer=train_optimizer(
            "resnet50_dcn_bounded", params, MESH_TRAIN_STEPS),
        batch_fn=lambda step: detection_batch(data, step),
        config=TrainerConfig(total_steps=MESH_TRAIN_STEPS, ckpt_every=100,
                             ckpt_dir=str(root), log_every=1,
                             grad_compression=compression),
        device=None if mesh is not None else dev, mesh=mesh)
    tr.run()
    shutil.rmtree(root, ignore_errors=True)
    losses = [h["loss"] for h in tr.history if "loss" in h]
    if len(losses) != MESH_TRAIN_STEPS or tr.telemetry["skipped"] \
            or not all(math.isfinite(v) for v in losses):
        fail(f"phase 18(c) {tag}: losses {losses}, {tr.telemetry}")
    return tr


def param_diff(a, b) -> tuple[float, float]:
    """(max|a - b| / max|b|, relative norm) of two param trees."""
    from repro_torch.tree import leaves
    num = max(float((x.detach() - y.detach()).abs().max())
              for x, y in zip(leaves(a), leaves(b)))
    den = max(float(y.detach().abs().max()) for y in leaves(b))
    return num / den, tree_rel(a, b)


def saved_by_position(cfg, base, mesh) -> dict:
    """The bytes autograd saves for the backward of one training step's
    forward (step 0's batch), by mesh position (``sharding.saved_bytes``;
    the params, which each shard's fetch aliases, count nowhere)."""
    import contextlib

    import torch

    from repro_torch.data import DetectionDataConfig, detection_batch
    from repro_torch.distributed.sharding import saved_bytes, use_rules
    from repro_torch.models import resnet_dcn as R
    from repro_torch.tree import leaves, tree_map

    data = DetectionDataConfig(img_size=cfg.img_size,
                               global_batch=TRAIN_BATCH,
                               num_classes=cfg.num_classes, seed=0)
    batch = {k: torch.as_tensor(v).to(DEV)
             for k, v in detection_batch(data, 0).items()}
    params = tree_map(lambda t: t.detach().requires_grad_(True), base)
    rules = use_rules(mesh=mesh) if mesh is not None \
        else contextlib.nullcontext()
    with rules, saved_bytes(leaves(params)) as held:
        loss, _ = R.train_loss(params, cfg, batch, lam=0.005, device=DEV)
    del loss
    return held


def mesh_training(record: dict, base, flat: dict) -> None:
    """Phase 18(c): the Trainer on (data=2) meshes with and without
    int8_ef, on a (data=4) mesh, and with ``shard_spatial`` on a (model=2)
    mesh, each against the flat Trainer of the same compression
    (``flat``); each data run's crossings against ``dcn_collectives``
    and its positions' saved-activation bytes against the flat step's."""
    from repro_torch.distributed.sharding import (CrossingCounter,
                                                  count_crossings)
    from repro_torch.launch.collectives import dcn_collectives

    cfg = mesh_dcl_config()
    rec = record["mesh_train"] = {}
    runs = [("data2", repeated_mesh((2, 1), ("data", "model")), None, cfg),
            ("data2_int8_ef", repeated_mesh((2, 1), ("data", "model")),
             "int8_ef", cfg),
            ("data4", repeated_mesh((4, 1), ("data", "model")), None, cfg),
            ("model2_spatial", repeated_mesh((1, 2), ("data", "model")),
             None, dataclasses.replace(cfg, shard_spatial=True))]
    ef_move = param_diff(flat["int8_ef"].params, flat[None].params)[1]
    spread = param_diff(flat["banded"].params, flat[None].params)[1]
    print(f"  the flat Trainer's own spread: banded vs zero-copy dataflow "
          f"(another summation order) relative norm {spread:.2e}; int8_ef vs "
          f"none {ef_move:.2e}")
    flat_saved = saved_by_position(cfg, base, None)[()]
    print(f"  the flat step saves {flat_saved / 1e9:.3f} GB for its "
          f"backward (params not counted)")
    rec["flat_saved_bytes"] = flat_saved
    for tag, mesh, compression, c in runs:
        before = read_counts()
        with count_crossings() as counter:
            tr = mesh_trainer(c, base, mesh=mesh, compression=compression,
                              tag=tag)
        launched = {k: v - before[k] for k, v in read_counts().items()}
        mx, rel = param_diff(tr.params, flat[compression].params)
        # Each shard (data or height) launches 1a and 2 once a DCL.
        want = launch_want(n_dcl(cfg) * mesh.size * MESH_TRAIN_STEPS)
        losses = [round(h["loss"], 6) for h in tr.history if "loss" in h]
        flat_losses = [round(h["loss"], 6) for h in flat[compression].history
                       if "loss" in h]
        tol = max(RESUME_RTOL, MESH_SPREAD * spread)
        ok = rel <= tol
        gate = f"relative norm {tol:.2e}"
        print(f"  {tag} ({mesh.shape}, {compression}): losses {losses} "
              f"(flat {flat_losses}); params vs flat: max {mx:.2e} x "
              f"max|param|, relative norm {rel:.2e} (gate {gate}); "
              f"launches 1a {launched['deform_conv_fused']}, 2 "
              f"{launched['deform_conv_bwd']} (want {want} each)"
              + (" ok" if ok else " FAIL"))
        if not ok or launched["deform_conv_fused"] != want \
                or launched["deform_conv_bwd"] != want:
            fail(f"phase 18(c) {tag}: {mx}, {rel}, {launched}")
        got = counter.summary()
        rec[tag] = dict(mesh=mesh.shape, compression=compression,
                        losses=losses, max_rel=mx, rel=rel,
                        launches=launched["deform_conv_fused"],
                        crossings=got)
        n = mesh.shape["data"]
        if n == 1:
            print(f"    crossings ({MESH_TRAIN_STEPS} steps): "
                  f"{crossing_line(got)}")
            continue
        step = dcn_collectives(c, mesh, batch=TRAIN_BATCH, train=True)
        expect = CrossingCounter()
        expect.merge(step, MESH_TRAIN_STEPS)
        expect = expect.summary()
        ok = got == expect
        print(f"    crossings ({MESH_TRAIN_STEPS} steps): "
              f"{crossing_line(got)}; dcn_collectives "
              f"{crossing_line(expect)} (a step: "
              f"{crossing_line(step.summary())})"
              + (" equal" if ok else " FAIL"))
        if not ok:
            fail(f"phase 18(c) {tag}: crossings {got} != {expect}")
        held = saved_by_position(c, base, mesh)
        cap = 1.05 * flat_saved / n
        worst = max(held.values())
        ok = len(held) == n and worst <= cap
        print(f"    saved for the backward by position: "
              + ", ".join(f"{pos} {b / 1e9:.3f} GB"
                          for pos, b in sorted(held.items()))
              + f"; at most 1/{n} of the flat step + 5% = {cap / 1e9:.3f} "
              f"GB (largest {worst / flat_saved:.4f} of the flat step)"
              + (" ok" if ok else " FAIL"))
        if not ok:
            fail(f"phase 18(c) {tag}: saved bytes {held} over {cap}")
        rec[tag]["saved_bytes"] = {str(k): v for k, v in held.items()}
    rec.update(int8_ef_move=ef_move, banded_spread=spread)


def crossing_line(summary: dict) -> str:
    """The kinds a crossing summary moved: transfers and MB."""
    kinds = [f"{k} {v['count']} x, {v['bytes'] / 1e6:.2f} MB"
             for k, v in summary.items()
             if isinstance(v, dict) and v["count"]]
    return "; ".join(kinds) or "none"


def command_r_phase(record: dict) -> None:
    """Phase 18(d): command-r-35b at its widths, cut to ``CR_LAYERS``
    layers: served under phase 13's gates, the GPipe forward against
    ``transformer.forward``."""
    import torch

    from repro_torch.distributed.pipeline import bubble_fraction
    from repro_torch.launch import serve as serve_launch
    from repro_torch.models import pipelined as PL
    from repro_torch.models import registry as reg
    from repro_torch.models import transformer as TF

    full = reg.get(CR_ARCH).config
    cfg = dataclasses.replace(full, n_layers=CR_LAYERS)
    rec = record["command_r"] = dict(arch=CR_ARCH, layers=CR_LAYERS,
                                     params=cfg.param_count(),
                                     full_params=full.param_count(),
                                     bf16_predicted=CR_BF16_PREDICTED)
    t0 = time.monotonic()
    params = card_params(cfg, seed=0)
    if DEV == "cuda":
        torch.cuda.synchronize()
    rec["init_s"] = time.monotonic() - t0
    print(f"  {CR_ARCH} cut to {CR_LAYERS} of {full.n_layers} layers: d "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.kv_heads} KV, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.param_count() / 1e9:.3f}B "
          f"params ({cfg.param_count() * 4 / 1e9:.1f} GB fp32; all "
          f"{full.n_layers}: {full.param_count() * 4 / 1e9:.0f} GB), drawn "
          f"on {DEV} from seed 0 in {rec['init_s']:.1f} s")
    args = serve_launch.build_parser().parse_args(
        ["--arch", CR_ARCH, "--device", DEV, "--seed", "0"])
    engine, steps, seconds = serve_launch.serve_lm(cfg, args, params=params)
    print(serve_launch.report_lm(engine, steps, seconds))
    if sorted((r.uid, len(r.output)) for r in engine.completed) \
            != [(i, args.max_new_tokens) for i in range(args.requests)]:
        fail("serve_lm did not serve every request its token count")
    del engine
    family_serving(rec, params, cfg, cap=CR_BF16_MAX,
                   reference=greedy_steps, greedy=CR_GREEDY)

    stages, micro = CR_PIPE
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32, remat="none")
    g = torch.Generator(device=DEV).manual_seed(7)
    toks = torch.randint(0, cfg.vocab, CR_PIPE_TOKENS, device=DEV,
                         generator=g)
    mesh = repeated_mesh(stages, ("stage",))
    with torch.no_grad():
        flat = TF.forward(params, cfg32, tokens=toks)[0]
        pipe = PL.pipelined_forward(params, cfg32, toks, mesh=mesh,
                                    n_stages=stages, microbatches=micro)
    rel = float((pipe - flat).norm() / flat.norm())
    bubble = bubble_fraction(stages, micro)
    rec.update(pipeline_rel=rel, bubble_fraction=bubble)
    print(f"  pipelined_forward, {stages} stages x {CR_LAYERS // stages} "
          f"layers on {stages} x {DEV}, {micro} microbatches, tokens "
          f"{CR_PIPE_TOKENS}, fp32: relative norm {rel:.2e} from "
          f"transformer.forward (gate {CR_PIPE_RTOL}); GPipe bubble "
          f"fraction (S-1)/(M+S-1) = {bubble:.3f}")
    if not rel <= CR_PIPE_RTOL:
        fail(f"pipelined_forward {rel} from transformer.forward")
    del params, flat, pipe
    if DEV == "cuda":
        torch.cuda.empty_cache()


def mesh_card_vs_cpu(record: dict) -> None:
    """Phase 18(e): the reduced command-r-35b (forward and pipelined) and
    the reduced DCL mesh paths (a spatial forward, 2 data-parallel
    Trainer steps), card against CPU."""
    import torch

    from repro_torch.distributed.sharding import Mesh, use_rules
    from repro_torch.kernels import ops
    from repro_torch.launch.train import reduced_config
    from repro_torch.models import pipelined as PL
    from repro_torch.models import registry as reg
    from repro_torch.models import resnet_dcn as R
    from repro_torch.models import transformer as TF
    from repro_torch.tree import tree_map

    out = record["mesh_card_cpu"] = {}
    cfg = reg.reduced_config(reg.get(CR_ARCH))
    p_cpu = TF.init_params(cfg, seed=0, device="cpu")
    p_dev = tree_map(lambda t: t.to(DEV), p_cpu)
    toks = torch.randint(0, cfg.vocab, (4, 16),
                         generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        res = {}
        for where, p, mesh in (
                ("cpu", p_cpu, Mesh(["cpu"] * 2, ("stage",))),
                (DEV, p_dev, repeated_mesh(2, ("stage",)))):
            t = toks.to(where)
            res[where] = (TF.forward(p, cfg, tokens=t)[0].cpu(),
                          PL.pipelined_forward(p, cfg, t, mesh=mesh,
                                               n_stages=2,
                                               microbatches=2).cpu())
    lm = [float((a - b).norm() / b.norm())
          for a, b in zip(res[DEV], res["cpu"])]
    dcl = dataclasses.replace(reduced_config(mesh_dcl_config()),
                              img_size=128)
    base = perturb_offsets(R.init_params(dcl, seed=0, device="cpu"), 1)
    img = torch.from_numpy(mesh_images(2)[0][None, :128, :128].copy())
    ys = {}
    with torch.no_grad():
        for where, mesh in (("cpu", Mesh(["cpu"] * 2, ("model",))),
                            (DEV, repeated_mesh(2))):
            p = tree_map(lambda t: t.to(where), base)
            with use_rules(mesh=mesh):
                ys[where] = R.forward(p, dataclasses.replace(
                    dcl, shard_spatial=True), img.to(where),
                    device=where)[0]["cls"].cpu()
    spatial = rel_max(ys[DEV], ys["cpu"])
    small = dataclasses.replace(dcl, img_size=64)
    hist, seen = {}, {}
    for where, mesh in (("cpu", Mesh([["cpu"]] * 2, ("data", "model"))),
                        (DEV, repeated_mesh((2, 1), ("data", "model")))):
        seen[where] = []
        with ops.dispatch_hook_scope(lambda ctx: seen[where].append(
                (ctx["shape"][0], ctx["shards"]))):
            tr = mesh_trainer(small, tree_map(lambda t: t.to(where), base),
                              mesh=mesh, tag=f"reduced_{where}",
                              device=where)
        hist[where] = [h["loss"] for h in tr.history if "loss" in h]
    train = max(abs(a - b) / abs(b) for a, b in zip(hist[DEV], hist["cpu"]))
    # Every layer per data shard: each DCL call takes one shard's rows.
    per_shard = [(TRAIN_BATCH // 2, (1, 1, 2))] \
        * (n_dcl(small) * 2 * MESH_TRAIN_STEPS)
    if seen[DEV] != per_shard or seen["cpu"] != per_shard:
        fail(f"phase 18(e): the data-parallel DCL dispatches {seen} are "
             f"not one a data shard of {TRAIN_BATCH // 2} rows")
    out.update(lm_forward=lm[0], lm_pipelined=lm[1], dcl_spatial=spatial,
               dcl_train=train, losses=hist)
    print(f"  reduced {CR_ARCH} fp32, {DEV} vs CPU: forward {lm[0]:.2e}, "
          f"pipelined (2 stages) {lm[1]:.2e}; reduced DCL config: spatial "
          f"forward at 128 on 2 shards (cls) {spatial:.2e}, 2 data-parallel "
          f"Trainer steps on 2 data shards at 64 (every layer per shard, "
          f"{len(seen[DEV])} DCL calls of {TRAIN_BATCH // 2} rows) "
          f"{[round(v, 6) for v in hist[DEV]]}"
          f" vs {[round(v, 6) for v in hist['cpu']]} ({train:.2e}); gate "
          f"{MESH_CARD_CPU_RTOL}")
    if max(lm + [spatial, train]) > MESH_CARD_CPU_RTOL:
        fail(f"phase 18(e) card vs CPU: {out}")


def mesh_phase(record: dict, params) -> dict[str, int]:
    """Phase 18: (a)-(e).  ``params``: phase 4's full-width DCL params.
    Returns the launches of kernels 1a, 1c and 2 in the main path's run
    ((b) the spatial engines and (c) the mesh Trainers), counted from 0
    just before it."""
    import numpy as np
    import torch

    from repro_torch.launch import serve as serve_launch
    from repro_torch.models import resnet_dcn as R

    t0 = time.monotonic()
    # As phases 6 and 8: every path feeds the same offsets.
    torch.backends.cudnn.deterministic = True
    print(f"  meshes: up to {MESH_MAX_SHARDS} shards on {DEV}:0 (one card "
          f"runs every shard, exchange and launch)")
    print("  (a) spatial kernels: 1a, 1c, 2 sharded vs unsharded")
    mesh_kernels(record)

    cfg = mesh_dcl_config()
    table = serve_launch.calibrate(cfg, params, serve_args(cfg, "int8"))
    flat_runs = {}
    for rung in ("fp32_kernel", "int8"):
        flat_runs[rung] = mesh_serve(
            mesh_engine(params, cfg, rung, (), table
                        if rung != "fp32_kernel" else None), mesh_images())
    base = perturb_offsets(R.init_params(cfg, seed=0, device=DEV), 1)
    flat_train = {comp: mesh_trainer(cfg, base, compression=comp,
                                     tag=f"flat_{comp}")
                  for comp in (None, "int8_ef")}
    flat_train["banded"] = mesh_trainer(
        dataclasses.replace(cfg, dataflow="banded"), base, tag="flat_banded")

    reset_counts()
    print("  (b) spatial serving")
    mesh_serving(record, params, flat_runs, table)
    print(f"  (c) training, batch {TRAIN_BATCH} x {cfg.img_size}, "
          f"{MESH_TRAIN_STEPS} steps")
    mesh_training(record, base, flat_train)
    counts = read_counts()
    main = {k: counts[k] for k in ("deform_conv_fused",
                                   "deform_conv_fused_q", "deform_conv_bwd")}
    print(f"  main path ((b) + (c)) launches: {main}")
    if not all(main.values()) and DEV == "cuda":
        fail(f"a kernel of the mesh path never launched: {counts}")
    del flat_train, base

    # Each bucket's forward, spatial beside flat (CUDA events).
    fwd = {}
    if DEV == "cuda":
        from repro_torch.distributed.sharding import use_rules
        for b, shards in MESH_SPATIAL:
            x = torch.from_numpy(np.stack(
                [img for img in mesh_images() if img.shape[0] == b][:BATCH])
            ).to(DEV)
            sp = dataclasses.replace(cfg, shard_spatial=True)
            mesh = repeated_mesh(shards)
            with torch.no_grad():
                flat_ms = time_ms(lambda: R.forward(params, cfg, x,
                                                    device=DEV),
                                  reps=3, iters=2)
                with use_rules(mesh=mesh):
                    sp_ms = time_ms(lambda: R.forward(params, sp, x,
                                                      device=DEV),
                                    reps=3, iters=2)
            fwd[b] = dict(flat_ms=flat_ms, spatial_ms=sp_ms, shards=shards)
            print(f"  {b}-bucket fp32 forward, batch {BATCH}: flat "
                  f"{flat_ms:.3f} ms, {shards} shards on one card "
                  f"{sp_ms:.3f} ms")
    record["mesh_forward_ms"] = fwd

    print(f"  (d) {CR_ARCH} at {CR_LAYERS} layers")
    command_r_phase(record)
    print("  (e) reduced configs, card vs CPU")
    mesh_card_vs_cpu(record)
    record["phase18_s"] = time.monotonic() - t0
    print(f"  phase 18 in {record['phase18_s']:.1f} s (budget "
          f"{MESH_SECONDS} s) on {smi() if DEV == 'cuda' else DEV}")
    return main


# ---------------------------------------------------------------------------
# Phase 19: the planning layer (dry run on meta, roofline)
# ---------------------------------------------------------------------------

DRYRUN_DIR = ROOT / "build" / "dryrun"
DRYRUN_JOBS = 2             # background workers while phases 3-18 run
DRYRUN_JOBS_ALONE = 6       # ``--only 19``: nothing else runs
DRYRUN_WAIT_S = 900
PLAN_SECONDS = 40           # phase 19's budget (printed, not gated)
PEAK_BAND = (0.95, 1.05)    # (b): dry-run peak over the allocator's
RULE = ("tinyllama-1.1b", "train_4k", "single", {"embed": None}, "no_fsdp")
RULE_DIR = DRYRUN_DIR / "rules"
RULE_CMD = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
            RULE[0], "--shape", RULE[1], "--mesh", RULE[2], "--set-rule",
            "embed=None", "--tag", RULE[4]]
_dryrun: dict = {}


def start_dryrun(jobs: int) -> None:
    """Start phase 19(a)'s dry run of every cell: ``launch.dryrun --all``
    in its own session (so it and its workers stop together), niced, on
    the CPU with no card visible."""
    import shutil
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    DRYRUN_DIR.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    log = open(DRYRUN_DIR.parent / "dryrun.log", "w")

    def detach():
        os.setsid()
        os.nice(19)
    _dryrun["proc"] = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--mesh", "all", "--jobs", str(jobs), "--dir", str(DRYRUN_DIR)],
        cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
        preexec_fn=detach)
    # the rule experiment, then the same command with --skip-existing
    once = shlex.join(RULE_CMD + ["--dir", str(RULE_DIR)])
    _dryrun["rules"] = subprocess.Popen(
        ["/bin/sh", "-c", f"{once} && {once} --skip-existing"], cwd=ROOT,
        env=env, stdout=open(DRYRUN_DIR.parent / "dryrun_rules.log", "w"),
        stderr=subprocess.STDOUT, preexec_fn=detach)
    _dryrun["t0"] = time.time()
    _dryrun["jobs"] = jobs
    atexit.register(stop_dryrun)


def stop_dryrun() -> None:
    for key in ("proc", "rules"):
        proc = _dryrun.get(key)
        if proc is not None and proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def dryrun_cells(record: dict) -> None:
    """Phase 19(a): wait for the dry run, check and print every cell."""
    from repro_torch.launch import dryrun, roofline
    from repro_torch.models import registry as reg

    proc = _dryrun["proc"]
    t0 = time.monotonic()
    try:
        rc = proc.wait(timeout=DRYRUN_WAIT_S)
    except subprocess.TimeoutExpired:
        stop_dryrun()
        fail(f"the dry run did not end within {DRYRUN_WAIT_S} s of "
             f"phase 19")
    log_path = DRYRUN_DIR.parent / "dryrun.log"
    log = log_path.read_text()
    waited = time.monotonic() - t0
    # its last line is written as it ends
    wall = log_path.stat().st_mtime - _dryrun["t0"]
    print(f"  dry run: {_dryrun['jobs']} workers, ended {wall:.1f} s after "
          f"its start, phase 19 waited {waited:.1f} s for it; exit {rc}")
    if rc != 0:
        print("\n".join(log.splitlines()[-20:]))
        fail(f"launch.dryrun --all exited {rc}")
    cells = reg.runnable_cells()
    want = {f"{a}__{s}__{m}.json" for a, s in cells for m in dryrun.MESHES}
    have = {p.name for p in DRYRUN_DIR.glob("*.json")}
    if have != want:
        fail(f"dry-run records missing {sorted(want - have)[:4]}, "
             f"unexpected {sorted(have - want)[:4]}")
    skipped = {(a, s) for a, s, _ in reg.skipped_cells()}
    if skipped & set(cells):
        fail("a skipped cell is also runnable")
    rows = {}
    for name in sorted(want):
        rec = json.loads((DRYRUN_DIR / name).read_text())
        if "error" in rec:
            fail(f"dry run of {name}: {rec['error']}")
        rows[(rec["arch"], rec["shape"], rec["mesh"])] = \
            roofline.analyze_cell(rec)
    trace_s = sum(json.loads((DRYRUN_DIR / f"{a}__{s}__card.json")
                             .read_text())["trace_s"] for a, s in cells)
    print(f"  {len(cells)} cells x {len(dryrun.MESHES)} meshes, "
          f"{len(skipped)} skipped ({sorted(skipped)[0][1]} on the "
          f"full-attention archs); each cell traced once, the traces' "
          f"times summed over the workers {trace_s:.1f} s")
    print("  cell: params | args GB/device card/16x16/2x16x16 | peak GB "
          "(card) | fits 80 GB | dominant | roofline ms (card)")
    out = []
    for a, s in cells:
        card = rows[(a, s, "card")]
        args = "/".join(f"{rows[(a, s, m)]['argument_bytes'] / 1e9:.3f}"
                        for m in dryrun.MESHES)
        print(f"  {a} {s}: {card['params'] / 1e9:.3f}B | {args} | "
              f"{card['peak_live_bytes'] / 1e9:.3f} | "
              f"{'yes' if card['fits_card'] else 'no'} | {card['dominant']} | "
              f"{card['roofline_ms']:.3f}")
        out += [rows[(a, s, m)] for m in dryrun.MESHES]
    rule_experiment(record)
    dest = ROOT / "chiprun_out" / "dryrun"
    dest.mkdir(parents=True, exist_ok=True)
    for p in [*DRYRUN_DIR.glob("*.json"), *RULE_DIR.glob("*.json")]:
        (dest / p.name).write_text(p.read_text())
    (dest / "roofline.json").write_text(json.dumps(out, indent=1))
    (dest / "roofline.md").write_text(roofline.markdown_table(out) + "\n")
    record["dryrun"] = {"cells": len(cells), "wall_s": wall,
                        "waited_s": waited, "trace_cpu_s": trace_s}


def rule_experiment(record: dict) -> None:
    """Phase 19(a)'s rule experiment: its record against the rules' own
    shard bytes and crossings and the untagged record; the CLI's second
    run, with ``--skip-existing``, must have skipped it."""
    from repro_torch.distributed.sharding import DEFAULT_RULES
    from repro_torch.launch import collectives, dryrun, steps
    from repro_torch.models import registry as reg

    arch_name, shape, mesh_kind, override, tag = RULE
    proc = _dryrun["rules"]
    try:
        rc = proc.wait(timeout=DRYRUN_WAIT_S)
    except subprocess.TimeoutExpired:
        stop_dryrun()
        fail("the rule experiment did not end")
    log = (DRYRUN_DIR.parent / "dryrun_rules.log").read_text()
    if rc != 0:
        print(log[-2000:])
        fail(f"the rule experiment exited {rc}")
    path = dryrun.record_path(arch_name, shape, mesh_kind, tag, RULE_DIR)
    rec = json.loads(path.read_text())
    base = json.loads(dryrun.record_path(arch_name, shape, mesh_kind,
                                         results_dir=DRYRUN_DIR).read_text())
    rules = {**DEFAULT_RULES, **override}
    arch = reg.get(arch_name)
    mesh = dryrun.meta_mesh(mesh_kind)
    _, inputs, specs, _ = steps.make_cell_step(arch, shape, mesh, rules=rules)
    want_args = sum(dryrun.tree_shard_bytes(t, sp, mesh)
                    for t, sp in zip(inputs, specs))
    spec = arch.shapes[shape]
    chips = math.prod(mesh.devices.shape)
    want_coll = collectives.lm_collectives(
        arch.config, mesh, mode="train", batch=spec.global_batch,
        seq=spec.seq_len, rules=rules,
        micro=steps.microbatches(arch)).summary()["total_bytes"] / chips
    print(f"  rule experiment {path.name}: rule_overrides "
          f"{rec.get('rule_overrides')}; args {rec['argument_bytes']} B a "
          f"device (the rules' shards {want_args}; untagged "
          f"{base['argument_bytes']}); collective bytes "
          f"{rec['collective_bytes']:.6e} a device (lm_collectives "
          f"{want_coll:.6e}; untagged {base['collective_bytes']:.6e})")
    if rec.get("rule_overrides") != override or "error" in rec:
        fail(f"the rule experiment's record: {rec.get('rule_overrides')} "
             f"{rec.get('error')}")
    if rec["argument_bytes"] != want_args \
            or rec["argument_bytes"] <= base["argument_bytes"]:
        fail(f"rule experiment: args {rec['argument_bytes']}, want "
             f"{want_args} and above {base['argument_bytes']}")
    if rec["collective_bytes"] != want_coll:
        fail(f"rule experiment: collective bytes {rec['collective_bytes']}"
             f", lm_collectives {want_coll}")
    skipped = f"[skip] {arch_name} {shape}@{tag} {mesh_kind}"
    written = log.count(f"-> {path.name}")
    print(f"  again with --skip-existing: {skipped!r} "
          f"{'printed' if skipped in log else 'missing'}; the record "
          f"written {written} time(s) in the two runs")
    if skipped not in log or written != 1:
        print(log[-2000:])
        fail("--skip-existing did not skip the tagged record")
    record["rule_experiment"] = dict(
        record=path.name, rule_overrides=rec["rule_overrides"],
        argument_bytes=rec["argument_bytes"],
        untagged_argument_bytes=base["argument_bytes"],
        collective_bytes=rec["collective_bytes"],
        untagged_collective_bytes=base["collective_bytes"])


def plan_cases(params) -> list[dict]:
    """Phase 19(b)'s shapes: (label, arch, shape name, real params or
    None to draw them on the card)."""
    from repro_torch.launch import steps
    from repro_torch.models import registry as reg
    from repro_torch.models.registry import ShapeSpec

    dcn = reg.get("resnet50_dcn_bounded")
    lm = reg.get(LM_ARCH)
    cases = [dict(label=f"{dcn.name} serve {b} (batch {BATCH})",
                  arch=steps.with_shape(dcn, f"serve_{b}", ShapeSpec(
                      "infer_det", 0, BATCH), img_size=b),
                  shape=f"serve_{b}", params=params) for b in (256, 512)]
    cases.append(dict(
        label=f"{dcn.name} train (batch {TRAIN_BATCH} x 512)",
        arch=steps.with_shape(dcn, "train_8", ShapeSpec(
            "train_det", 0, TRAIN_BATCH)), shape="train_8", params=params))
    cases.append(dict(label=f"{LM_ARCH} train (8 x 2048)",
                      arch=steps.with_shape(lm, "train_8x2048", ShapeSpec(
                          "train", 2048, 8)), shape="train_8x2048",
                      params=None))
    cases.append(dict(label=f"{LM_ARCH} decode (batch 4, cache 2048)",
                      arch=steps.with_shape(lm, "decode_4x2048", ShapeSpec(
                          "decode", 2048, 4)), shape="decode_4x2048",
                      params=None))
    return cases


def plan_case(case: dict) -> dict:
    """Dry-run one shape, run the same step on the card, compare."""
    import torch
    from torch.utils._pytree import tree_leaves

    from repro_torch.launch import dryrun, roofline, steps

    arch, shape = case["arch"], case["shape"]
    trace = dryrun.trace_cell(arch, shape)
    rec = dryrun.run_cell(arch.name, shape, "card", arch=arch, trace=trace)
    del trace
    step, inputs, _, _ = steps.make_cell_step(arch, shape, None)
    params = case["params"]
    if params is None:
        params = card_params(arch.config)
    real = steps.real_inputs(arch, shape, inputs, DEV, params=params)
    del inputs
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(real)
                 if isinstance(t, torch.Tensor))
    if nbytes != rec["argument_bytes"]:
        fail(f"{case['label']}: argument bytes {rec['argument_bytes']} "
             f"dry, {nbytes} on the card")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    with dryrun.StepCounter(known=real) as sc:
        out = step(*real)
    del out
    torch.cuda.synchronize()
    # the same counter over the card's tensors, beside the allocator's
    # peak of that run
    counted = sc.peak_new_bytes + nbytes
    counted_alloc = torch.cuda.max_memory_allocated() - before + nbytes
    if sc.flops != rec["flops"] or sc.dcl != rec["dcl_calls"]:
        fail(f"{case['label']}: FLOPs {rec['flops']} dry, {sc.flops} on "
             f"the card; DCL calls {rec['dcl_calls']} vs {sc.dcl}")
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    out = step(*real)
    ev[1].record()
    torch.cuda.synchronize()
    ms = ev[0].elapsed_time(ev[1])
    del out
    # the step's own peak: what it allocated beyond the memory in use
    # before it, plus its arguments
    peak = torch.cuda.max_memory_allocated() - before + nbytes
    roof = roofline.analyze_cell(rec, arch=arch)
    res = dict(label=case["label"], argument_bytes=nbytes,
               flops=rec["flops"], dcl_calls=rec["dcl_calls"],
               dry_peak_bytes=rec["peak_live_bytes"], card_peak_bytes=peak,
               peak_op_temp_bytes=rec["peak_op_temp_bytes"],
               peak_ratio=rec["peak_live_bytes"] / peak,
               counted_peak_bytes=counted,
               counted_run_peak_bytes=counted_alloc, step_ms=ms,
               roofline_ms=roof["roofline_ms"], dominant=roof["dominant"],
               roofline_fraction_measured=roof["roofline_ms"] / ms,
               model_flops=roof["model_flops_per_device"],
               model_share_measured=roof["model_flops_per_device"]
               / h100.PEAK_BF16_FLOPS / (ms / 1e3), dtype=rec["dtype"])
    print(f"  {case['label']}: args {nbytes} B (= dry run), FLOPs "
          f"{rec['flops']:.6e} (= dry run; DCL calls {rec['dcl_calls']}); "
          f"peak dry {rec['peak_live_bytes'] / 1e9:.3f} GB (ops' own "
          f"temporaries {rec['peak_op_temp_bytes'] / 1e9:.3f} of it) vs "
          f"card {peak / 1e9:.3f} GB (ratio {res['peak_ratio']:.3f}, band "
          f"{PEAK_BAND}; the counter over the card's tensors "
          f"{counted / 1e9:.3f} GB, the allocator in that run "
          f"{counted_alloc / 1e9:.3f} GB); roofline "
          f"{roof['roofline_ms']:.3f} ms ({roof['dominant']}) vs "
          f"{ms:.3f} ms between CUDA events (roofline fraction "
          f"{res['roofline_fraction_measured']:.4f}; MODEL_FLOPS at the "
          f"bf16 peak {res['model_share_measured']:.4f} of it; "
          f"{rec['dtype']})")
    if not PEAK_BAND[0] <= res["peak_ratio"] <= PEAK_BAND[1]:
        fail(f"{case['label']}: the dry run's peak is "
             f"{res['peak_ratio']:.4f} of the card's, outside {PEAK_BAND}")
    del real, params
    torch.cuda.empty_cache()
    return res


def op_temp_check(record: dict) -> None:
    """Phase 19(b): every op ``dryrun.op_temp_bytes`` prices, on the card
    at each operand layout the term tells apart: the allocator's peak
    inside the call beyond the memory before it and the output's bytes
    must equal the term."""
    import torch

    from repro_torch.launch import dryrun

    aten = torch.ops.aten
    shape, flat, swap = (8, 4, 8, 512, 512), (0, 1, 2, 3, 4), (0, 1, 3, 2, 4)

    def laid(order, dtype):
        base = torch.randn([shape[i] for i in order], device=DEV)
        return base.to(dtype).permute([order.index(i) for i in range(5)])
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for g_order, o_order in ((flat, flat), (swap, flat), (flat, swap),
                                 (swap, swap)):
            cases.append((
                f"_softmax_backward_data {str(dtype)[6:]} grad "
                f"{'permuted' if g_order == swap else 'contiguous'}, output "
                f"{'permuted' if o_order == swap else 'contiguous'}",
                aten._softmax_backward_data.default,
                lambda g=g_order, o=o_order, d=dtype:
                (laid(g, d), laid(o, d), -1, d)))
        cases.append((f"logsumexp {str(dtype)[6:]} (8, 1024, 32000)",
                      aten.logsumexp.default,
                      lambda d=dtype: (torch.randn(8, 1024, 32000,
                                                   device=DEV).to(d), [-1])))
    rows = []
    for label, func, make in cases:
        args = make()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = func(*args)
        torch.cuda.synchronize()
        made = torch.cuda.max_memory_allocated() - before \
            - out.untyped_storage().nbytes()
        want = dryrun.op_temp_bytes(func, args, [out])
        rows.append(dict(op=label, card_bytes=made, counted_bytes=want))
        print(f"  (b) {label}: temporaries on the card {made} B, counted "
              f"{want} B")
        if made != want:
            fail(f"{label}: the card's allocator made {made} B of "
                 f"temporaries, op_temp_bytes counts {want}")
        del args, out
    torch.cuda.empty_cache()
    record["op_temps"] = rows


def planning_phase(record: dict, params) -> dict[str, int]:
    """Phase 19: (a) every cell's dry run, (b) the card's shapes against
    their dry runs.  Returns the launches of kernels 1a and 2 in (b)."""
    t0 = time.monotonic()
    print("  (a) every cell on the meta device")
    dryrun_cells(record)
    print(f"  (b) dry run vs the same step on the card ({smi()})")
    op_temp_check(record)
    reset_counts()
    record["plan_shapes"] = [plan_case(c) for c in plan_cases(params)]
    counts = read_counts()
    main = {k: counts[k] for k in ("deform_conv_fused", "deform_conv_bwd")}
    print(f"  (b) launches: {main}")
    if not all(main.values()):
        fail(f"a kernel of the DCN steps never launched: {counts}")
    record["phase19_s"] = time.monotonic() - t0
    print(f"  phase 19 in {record['phase19_s']:.1f} s (budget "
          f"{PLAN_SECONDS} s) on {smi()}")
    return main


# ---------------------------------------------------------------------------
# Phase 20: an LM's params laid out on the mesh by their specs
# ---------------------------------------------------------------------------

P20_ARCH = "tinyllama-1.1b"
P20_MESH = (2, 4)           # (a): (data, model)
P20_BATCH = (2, 2048)       # (a): batch x tokens
P20_LAYERS = 6              # (a): depth of 22 (None: all), cut to keep the
                            # script within its time
P20_STEPS = 3
P20_SPREAD = 2.0            # (a): params vs the flat Trainer (relative norm)
                            # at most this x the flat run's own spread under
                            # another summation order (the same setting at
                            # microbatches=2 vs 1, bf16 compute), never
                            # below P20_RTOL
P20_RTOL = 1e-4
P20_LOSS_RTOL = 1e-5        # (b): loss vs the flat path (fp32 compute)
P20_GRAD_RTOL = 1e-4        # (b): each leaf's gradient (relative norm)
P20_LOGIT_TOL = 1e-5        # (b): logits and prefill caches, x max|value|
P20_FWD_BATCH = (1, 2048)   # (b) tinyllama, musicgen
P20_MG = ("musicgen-medium", 4, (1, 16))     # arch, layers, mesh
P20_CR = ("command-r-35b", 2, (1, 4), (1, 512))
P20_PREFILL = (1, 512)      # (b): tinyllama's prefill on (1, 8)
P20_ELASTIC_LAYERS = 4      # (c)
P20_ELASTIC = ((2, 2), (4, 2), 4, 2)   # first mesh, second, steps, more
P20_ELASTIC_BATCH = (4, 512)
P20_ELASTIC_TOL = dict(rtol=5e-4, atol=5e-5)  # JAX's elastic oracle
P20_ELASTIC_LR = 0.1        # (c): SGD, momentum 0.9
P20_SECONDS = 90            # phase 20's budget (printed, not gated)


def p20_mesh(shape):
    return repeated_mesh(tuple(shape), ("data", "model"))


def p20_specs(cfg, mesh):
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TF
    with use_rules(mesh=mesh):
        return L.spec_tree(TF.param_defs(cfg))


def p20_batch(cfg, shape, step: int = 0) -> dict:
    """``lm_batch`` of ``shape`` (batch, tokens) at ``step``, on DEV."""
    import torch

    from repro_torch.data import LMDataConfig, lm_batch
    data = LMDataConfig(vocab=cfg.vocab, seq_len=shape[1],
                        global_batch=shape[0], codebooks=cfg.codebooks,
                        seed=0)
    return {k: torch.from_numpy(v).to(DEV)
            for k, v in lm_batch(data, step).items()}


def p20_trainer(cfg, base, *, mesh=None, compression=None, micro=1,
                opt=None, batch=P20_BATCH, tag="", steps=P20_STEPS):
    """A Trainer of ``cfg`` from ``base``'s params (placed by their specs
    on ``mesh``, else a copy on DEV), the launcher's optimizer unless
    ``opt``, on ``lm_batch`` data of ``batch``."""
    import torch

    from repro_torch.data import LMDataConfig, lm_batch
    from repro_torch.models import transformer as TF
    from repro_torch.optim import default_optimizer_for, warmup_cosine
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.tree import tree_map

    data = LMDataConfig(vocab=cfg.vocab, seq_len=batch[1],
                        global_batch=batch[0], codebooks=cfg.codebooks,
                        seed=0)
    opt = opt or default_optimizer_for(P20_ARCH, cfg.param_count(),
                                       warmup_cosine(3e-3, 10, steps))
    params = base if mesh is not None else tree_map(
        lambda t: t.detach().clone(), base)
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    return Trainer(
        loss_fn=lambda p, b: TF.loss_fn(p, cfg, b), params=params,
        optimizer=opt, batch_fn=lambda s: lm_batch(data, s),
        config=TrainerConfig(total_steps=steps, ckpt_every=steps,
                             ckpt_dir=str(ROOT / "build" / "smoke_p20" / tag),
                             log_every=1, microbatches=micro,
                             grad_compression=compression),
        device=None if mesh is not None else DEV, mesh=mesh,
        param_specs=None if mesh is None else p20_specs(cfg, mesh))


def p20_steps(tr, n: int) -> tuple[list, list]:
    """``n`` steps of the Trainer's own step path (its batch layout,
    sentinel, compression and optimizer), without its checkpoint: the
    losses and each step's time between CUDA events (host clock on the
    CPU)."""
    import torch
    losses, ms = [], []
    for _ in range(n):
        batch = tr._device_batch(tr.step)
        if DEV == "cuda":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        t0 = time.monotonic()
        loss, _, finite = tr._one_step(batch)
        if DEV == "cuda":
            ev[1].record()
            torch.cuda.synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
        else:
            ms.append((time.monotonic() - t0) * 1e3)
        if not finite:
            fail(f"phase 20: a non-finite step ({loss})")
        losses.append(loss)
        tr.step += 1
    return losses, ms


def p20_held(tr) -> dict:
    """Bytes each mesh position holds of the Trainer's params and
    optimizer state (``placement_summary``)."""
    from repro_torch.distributed.sharding import placement_summary
    return placement_summary({"params": tr.params, "opt": tr.opt_state},
                             tr.mesh)


def p20_training(record: dict) -> None:
    """Phase 20(a): ``P20_STEPS`` AdamW steps of full-width tinyllama-1.1b
    on (data=2, model=4), plain, with int8_ef and with microbatches=2,
    each against the flat Trainer of the same setting."""
    import torch

    from repro_torch.models import registry as reg
    from repro_torch.models import transformer as TF
    from repro_torch.distributed.sharding import use_rules

    cfg = reg.get(P20_ARCH).config
    if P20_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=P20_LAYERS)
    mesh = p20_mesh(P20_MESH)
    with use_rules(mesh=mesh):
        plan = TF.shard_plan(cfg, P20_BATCH[0])
    rec = record["p20_train"] = dict(arch=P20_ARCH, layers=cfg.n_layers,
                                     mesh=mesh.shape, batch=P20_BATCH,
                                     steps=P20_STEPS, plan=plan)
    print(f"  (a) {P20_ARCH} ({cfg.n_layers} layers, {cfg.dtype} compute) on "
          f"{mesh.shape}, batch {P20_BATCH[0]} x {P20_BATCH[1]}, "
          f"{P20_STEPS} AdamW steps; per shard: {plan}")
    base = card_params(cfg)
    runs = {"none": {}, "int8_ef": dict(compression="int8_ef"),
            "micro2": dict(micro=2)}
    flat = {}
    for name, kw in {**runs, "int8_ef_micro2": dict(
            compression="int8_ef", micro=2)}.items():
        tr = p20_trainer(cfg, base, tag=f"flat_{name}", **kw)
        losses, ms = p20_steps(tr, P20_STEPS)
        flat[name] = dict(params=tr.params, losses=losses, ms=ms)
        if DEV == "cuda":
            flat[name]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del tr
    # Each setting's flat spread: the same setting at microbatches=2
    # against 1 (the micro2 setting against microbatches=1).
    other = {"none": "micro2", "int8_ef": "int8_ef_micro2",
             "micro2": "none"}
    spread = {name: tree_rel(flat[other[name]]["params"],
                             flat[name]["params"]) for name in runs}
    gates = {name: max(P20_RTOL, P20_SPREAD * v)
             for name, v in spread.items()}
    print("  the flat Trainer's own spread, microbatches=2 vs 1 (another "
          "summation order), relative norm: "
          + ", ".join(f"{k} {v:.2e}" for k, v in spread.items()))
    rec.update(spread=spread, gates=gates, runs={})
    for name, kw in runs.items():
        tol = gates[name]
        tr = p20_trainer(cfg, base, mesh=mesh, tag=name, **kw)
        held = p20_held(tr)
        losses, ms = p20_steps(tr, P20_STEPS)
        peak = torch.cuda.max_memory_allocated() / 1e9 \
            if DEV == "cuda" else float("nan")
        rel = tree_rel(gathered(tr.params), flat[name]["params"])
        ok = rel <= tol
        f_ms = statistics.median(flat[name]["ms"][1:])
        s_ms = statistics.median(ms[1:])
        gb = {"x".join(map(str, k)): round(v / 1e9, 3)
              for k, v in held["held"].items()}
        print(f"  {name}: losses {[round(v, 5) for v in losses]} (flat "
              f"{[round(v, 5) for v in flat[name]['losses']]}); params vs "
              f"flat relative norm {rel:.2e} (gate {tol:.2e})"
              + (" ok" if ok else " FAIL"))
        print(f"    held a position (GB, params + AdamW state): {gb}; "
              f"{len(held['split'])} leaves split, {len(held['whole'])} "
              f"whole; peak {peak:.2f} GB (flat "
              f"{flat[name].get('peak_gb', float('nan')):.2f}); step "
              f"{s_ms:.1f} ms sharded vs {f_ms:.1f} ms flat (CUDA events, "
              f"median of steps 2-{P20_STEPS})")
        rec["runs"][name] = dict(
            losses=losses, flat_losses=flat[name]["losses"], rel=rel,
            held_gb=gb, per_device_gb=held["per_device"] / 1e9,
            split=len(held["split"]), whole=len(held["whole"]),
            peak_gb=peak, flat_peak_gb=flat[name].get("peak_gb"),
            step_ms=ms, flat_step_ms=flat[name]["ms"])
        if not ok:
            fail(f"phase 20(a) {name}: {rel} > {tol}")
        del tr
    del flat, base
    if DEV == "cuda":
        torch.cuda.empty_cache()


def gathered(tree):
    from repro_torch.distributed.sharding import gather_tree
    import torch
    with torch.no_grad():
        return gather_tree(tree)


def p20_loss_case(rec: dict, cfg, mesh_shape, batch_shape, label: str):
    """Loss and gradients of ``cfg`` (fp32 compute) on placed params on a
    ``mesh_shape`` mesh against the flat path on the same params: loss
    within P20_LOSS_RTOL, each leaf's gradient within P20_GRAD_RTOL
    (relative norm)."""
    import torch

    from repro_torch import tree as T
    from repro_torch.distributed.sharding import (gather, is_placed,
                                                  place_tree, use_rules)
    from repro_torch.models import transformer as TF

    params = card_params(cfg)
    batch = p20_batch(cfg, batch_shape)
    leaves = [t.requires_grad_(True) for t in T.leaves(params)]
    loss, _ = TF.loss_fn(params, cfg, batch)
    flat_g = dict(zip([p for p, _ in T.leaves_with_paths(params)],
                      torch.autograd.grad(loss, leaves)))
    flat_loss = float(loss.detach())
    del loss, leaves
    mesh = p20_mesh(mesh_shape)
    placed = place_tree(params, p20_specs(cfg, mesh), mesh)
    del params
    placed = T.tree_map(lambda t: t.requires_grad_(True), placed)
    blocks = T.leaves(placed)
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with use_rules(mesh=mesh):
        plan = TF.shard_plan(cfg, batch_shape[0])
        loss, _ = TF.loss_fn(placed, cfg, batch)
        gs = torch.autograd.grad(loss, blocks, allow_unused=True)
    peak = torch.cuda.max_memory_allocated() / 1e9 \
        if DEV == "cuda" else float("nan")
    by_id = {id(b): torch.zeros_like(b) if g is None else g
             for b, g in zip(blocks, gs)}
    del gs
    loss = float(loss.detach())
    loss_rel = abs(loss - flat_loss) / abs(flat_loss)
    worst, worst_path = 0.0, ""
    for path, x in T.leaves_with_paths(placed, is_leaf=is_placed):
        g = T.tree_map(lambda b: by_id[id(b)], x)
        g = gather(g, device=DEV) if is_placed(g) else g
        want = flat_g.pop(path)
        rel = float((g - want).norm() / want.norm().clamp_min(1e-30))
        if rel > worst:
            worst, worst_path = rel, "/".join(path)
    ok = loss_rel <= P20_LOSS_RTOL and worst <= P20_GRAD_RTOL
    print(f"  {label} on {mesh.shape}, batch {batch_shape[0]} x "
          f"{batch_shape[1]}, fp32: loss {loss:.6f} vs flat "
          f"{flat_loss:.6f} (rel {loss_rel:.2e}, gate {P20_LOSS_RTOL}); "
          f"worst leaf gradient {worst:.2e} ({worst_path}; gate "
          f"{P20_GRAD_RTOL}); peak {peak:.2f} GB"
          + (" ok" if ok else " FAIL"))
    print(f"    per shard: {plan}")
    rec[label] = dict(mesh=mesh.shape, loss=loss, flat_loss=flat_loss,
                      loss_rel=loss_rel, worst_grad=worst,
                      worst_leaf=worst_path, peak_gb=peak, plan=plan)
    if not ok:
        fail(f"phase 20(b) {label}: loss {loss_rel}, gradient {worst}")
    del placed, blocks, by_id, flat_g
    if DEV == "cuda":
        torch.cuda.empty_cache()


def p20_prefill(rec: dict, cfg) -> None:
    """tinyllama (fp32) prefill on (1, 8): KV 4 does not split 8 ways, so
    the cache holds 32 heads, ``repeat_interleave`` of the flat cache's 4;
    the logits equal the flat ones, both within P20_LOGIT_TOL x max."""
    import torch

    from repro_torch.distributed.sharding import place_tree, use_rules
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TF

    params = card_params(cfg)
    toks = p20_batch(cfg, P20_PREFILL)["tokens"]
    mesh = p20_mesh((1, 8))
    with torch.no_grad():
        flat_logits, flat_c = TF.prefill(params, cfg, toks,
                                         cache_len=P20_PREFILL[1])
        placed = place_tree(params, p20_specs(cfg, mesh), mesh)
        del params
        with use_rules(mesh=mesh):
            ekv = L.effective_kv_heads(cfg.attn_cfg())
            logits, caches = TF.prefill(placed, cfg, toks,
                                        cache_len=P20_PREFILL[1])
    rep = ekv // cfg.kv_heads
    errs = {}
    for key in ("k", "v"):
        want = torch.repeat_interleave(flat_c["layers"]["m0"][key], rep,
                                       dim=3)
        got = caches["layers"]["m0"][key]
        if got.shape != want.shape:
            fail(f"phase 20(b) prefill cache {key}: {tuple(got.shape)} vs "
                 f"{tuple(want.shape)}")
        errs[key] = float((got - want).abs().max() / want.abs().max())
    errs["logits"] = float((logits - flat_logits).abs().max()
                           / flat_logits.abs().max())
    ok = max(errs.values()) <= P20_LOGIT_TOL
    print(f"  prefill {P20_PREFILL[0]} x {P20_PREFILL[1]} on {mesh.shape}: "
          f"effective KV heads {ekv} (of {cfg.kv_heads}); cache "
          f"{tuple(caches['layers']['m0']['k'].shape)}; max error / max: "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" (gate {P20_LOGIT_TOL})" + (" ok" if ok else " FAIL"))
    rec["prefill_1x8"] = dict(ekv=ekv, **errs)
    if not ok:
        fail(f"phase 20(b) prefill: {errs}")
    del placed, caches, flat_c


def p20_forward(record: dict) -> None:
    """Phase 20(b): forward and loss on the other rules."""
    import torch

    from repro_torch.models import registry as reg

    rec = record["p20_forward"] = {}
    tl = dataclasses.replace(reg.get(P20_ARCH).config, dtype=torch.float32)
    p20_loss_case(rec, tl, (1, 8), P20_FWD_BATCH, f"{P20_ARCH}")
    p20_prefill(rec, tl)
    name, layers, mesh = P20_MG
    mg = dataclasses.replace(reg.get(name).config, n_layers=layers,
                             dtype=torch.float32)
    p20_loss_case(rec, mg, mesh, P20_FWD_BATCH, f"{name} ({layers} layers)")
    name, layers, mesh, batch = P20_CR
    cr = dataclasses.replace(reg.get(name).config, n_layers=layers,
                             dtype=torch.float32)
    p20_loss_case(rec, cr, mesh, batch, f"{name} ({layers} layers)")


def p20_oracle_share(got, want) -> tuple[float, str]:
    """The share of JAX's elastic allowance (``P20_ELASTIC_TOL``) the
    worst element of two param trees uses (<= 1 passes), and its leaf."""
    from repro_torch import tree as T
    tol = P20_ELASTIC_TOL
    worst, where = 0.0, ""
    for (path, a), (_, b) in zip(T.leaves_with_paths(gathered(got)),
                                 T.leaves_with_paths(gathered(want))):
        a, b = a.detach(), b.detach()
        used = float(((a - b).abs() / (tol["atol"] + tol["rtol"] * b.abs()))
                     .max())
        if used > worst:
            worst, where = used, "/".join(path)
    return worst, where


def p20_elastic(record: dict) -> None:
    """Phase 20(c): tinyllama at full width, ``P20_ELASTIC_LAYERS`` layers
    (fp32), trains on (2, 2), checkpoints, resumes on (4, 2): the
    restored state equals the checkpointed one, and the result is held
    against a straight run on (4, 2) at JAX's elastic oracle, which a
    planted wrong restore (the optimizer state lost) must fail.  The
    checkpoint also restores into a flat Trainer.  SGD with momentum (the
    paper's optimizer) trains: with JAX's AdamW (eps 1e-8) two straight
    runs on the two meshes already differ past the oracle at this width
    (printed), since fp32 summation noise on gradients near eps moves
    whole steps."""
    import shutil

    import torch

    from repro_torch import tree as T
    from repro_torch.distributed.sharding import is_placed
    from repro_torch.models import registry as reg
    from repro_torch.optim import adamw, constant, sgd

    first_mesh, second_mesh, n1, n2 = P20_ELASTIC
    cfg = dataclasses.replace(reg.get(P20_ARCH).config,
                              n_layers=P20_ELASTIC_LAYERS,
                              dtype=torch.float32)
    root = ROOT / "build" / "smoke_p20"
    shutil.rmtree(root / "elastic", ignore_errors=True)
    base = card_params(cfg)

    def build(mesh, tag, opt=None):
        return p20_trainer(
            cfg, base, mesh=mesh, batch=P20_ELASTIC_BATCH, tag=tag,
            steps=n1 + n2, opt=opt or sgd(constant(P20_ELASTIC_LR),
                                          momentum=0.9))

    def state(tr):
        return gathered({"params": tr.params, "opt": tr.opt_state})
    first = build(p20_mesh(first_mesh), "elastic")
    p20_steps(first, n1)
    t0 = time.monotonic()
    first.save()
    first.ckpt.wait()
    save_s = time.monotonic() - t0
    saved = state(first)
    del first
    resumed = build(p20_mesh(second_mesh), "elastic")
    t0 = time.monotonic()
    if not resumed.try_resume() or resumed.step != n1:
        fail(f"phase 20(c): no resume at step {n1}")
    restore_s = time.monotonic() - t0
    exact = all(torch.equal(a, b) for a, b in zip(T.leaves(state(resumed)),
                                                  T.leaves(saved)))
    del saved
    p20_steps(resumed, n2)
    straight = build(p20_mesh(second_mesh), "straight")
    p20_steps(straight, n1 + n2)
    worst, where = p20_oracle_share(resumed.params, straight.params)
    del resumed
    wrong = build(p20_mesh(second_mesh), "elastic")
    wrong.try_resume()
    with torch.no_grad():
        T.tree_map(lambda t: t.zero_(), wrong.opt_state)
    p20_steps(wrong, n2)
    planted, _ = p20_oracle_share(wrong.params, straight.params)
    del wrong
    flat = p20_trainer(cfg, base, batch=P20_ELASTIC_BATCH, tag="elastic",
                       steps=n1 + n2, opt=sgd(constant(P20_ELASTIC_LR),
                                              momentum=0.9))
    flat_ok = flat.try_resume() and flat.step == n1 and not any(
        is_placed(x) for x in T.leaves(flat.params, is_leaf=is_placed))
    del flat
    # JAX's example optimizer: two straight runs, one on each mesh.
    runs = []
    for shape in (first_mesh, second_mesh):
        tr = build(p20_mesh(shape), f"adamw_{shape[0]}",
                   opt=adamw(constant(3e-3)))
        p20_steps(tr, n1 + n2)
        runs.append(tr)
    adamw_share, adamw_where = p20_oracle_share(runs[0].params,
                                                runs[1].params)
    del runs, straight, base
    tol = P20_ELASTIC_TOL
    ok = exact and worst <= 1.0 and planted > 1.0 and flat_ok
    print(f"  (c) {P20_ARCH} ({P20_ELASTIC_LAYERS} layers, fp32), batch "
          f"{P20_ELASTIC_BATCH[0]} x {P20_ELASTIC_BATCH[1]}, SGD "
          f"{P20_ELASTIC_LR} momentum 0.9: {n1} steps on "
          f"{dict(zip(('data', 'model'), first_mesh))}, checkpoint "
          f"({save_s:.1f} s), restored on "
          f"{dict(zip(('data', 'model'), second_mesh))} ({restore_s:.1f} s;"
          f" params and momentum equal to the checkpointed: {exact}), "
          f"{n2} more steps")
    print(f"    vs a straight {n1 + n2}-step run the worst element uses "
          f"{worst:.4f} of rtol {tol['rtol']} + atol {tol['atol']} "
          f"({where}); a planted wrong restore (momentum lost) {planted:.1f};"
          f" a flat Trainer restores the checkpoint: {flat_ok}"
          + (" ok" if ok else " FAIL"))
    print(f"    JAX's AdamW(3e-3): straight runs on the two meshes differ by "
          f"{adamw_share:.1f} of the allowance ({adamw_where}; not gated)")
    record["p20_elastic"] = dict(
        worst_share=worst, worst_leaf=where, planted_share=planted,
        restored_exact=exact, flat_restore=flat_ok, save_s=save_s,
        restore_s=restore_s, adamw_mesh_share=adamw_share,
        adamw_leaf=adamw_where)
    shutil.rmtree(root, ignore_errors=True)
    if DEV == "cuda":
        torch.cuda.empty_cache()
    if not ok:
        fail(f"phase 20(c): exact {exact}, {worst} of the allowance, "
             f"planted {planted}, flat {flat_ok}")


def sharding_phase(record: dict) -> None:
    """Phase 20: an LM's params laid out on the mesh by their specs."""
    import torch

    t0 = time.monotonic()
    if DEV == "cuda":
        torch.cuda.empty_cache()
    print(f"  meshes repeat {DEV}:0 (one card holds every block)")
    p20_training(record)
    print("  (b) forward, loss and gradient on the other rules")
    p20_forward(record)
    p20_elastic(record)
    record["phase20_s"] = time.monotonic() - t0
    print(f"  phase 20 in {record['phase20_s']:.1f} s (budget "
          f"{P20_SECONDS} s) on {smi() if DEV == 'cuda' else DEV}")


# ---------------------------------------------------------------------------
# Phase 21: the last mesh paths: MoE with a split batch, the recurrent
# blocks per shard, Adafactor on placed leaves, collective bytes
# ---------------------------------------------------------------------------

P21_DBRX = ("dbrx-132b", 1, (2, 4))         # arch, layers, (data, model)
P21_GROK = ("grok-1-314b", 1, (1, 4))
P21_RG = ("recurrentgemma-9b", 3, (2, 4))   # one period (rglru, rglru, attn)
P21_RWKV = ("rwkv6-3b", 4, ((1, 8), (1, 16)))
P21_BATCH = (2, 512)        # batch x tokens of every run
P21_STEPS = 3               # (a): Adafactor steps
P21_DECODE = 4              # decode steps after the prefill
P21_SECONDS = 150           # phase 21's budget (printed, not gated)
P21_FP64_RATIO = 2.0        # a leaf past P20_GRAD_RTOL from the flat path
                            # passes if it is at most this x as far from
                            # the fp64 gradient as the flat fp32 one is
P21_FP64_BYTES = 40e9       # fp64 params + gradients: compute the fp64
                            # reference where they fit beside the runs


def p21_params(cfg) -> dict:
    """``card_params`` with every all-zero leaf (norm scales, biases,
    RWKV-6's token-shift mixes, decay offset, bonus and group-norm scale)
    drawn at 0.1, as the CPU parity tests perturb theirs.  At zero init
    RWKV-6's first WKV output is exactly zero and its per-head norm runs
    at its singular point (eps 1e-6): the flat path's own fp32 gradients
    then lie far from its fp64 ones, an ill-conditioned function that no
    summation order can be held to 1e-4 on."""
    import torch

    from repro_torch.tree import tree_map
    gen = torch.Generator(device=DEV).manual_seed(1)
    return tree_map(lambda t: t if bool(t.any()) else 0.1 * torch.randn(
        t.shape, generator=gen, device=DEV).to(t.dtype), card_params(cfg))


def p21_rules(name: str):
    """The arch's rules: the defaults with its registry overrides."""
    from repro_torch.distributed.sharding import DEFAULT_RULES
    from repro_torch.models import registry as reg
    over = reg.get(name).rules_overrides
    return {**DEFAULT_RULES, **over} if over else None


def p21_cfg(name: str, layers: int):
    import torch

    from repro_torch.models import registry as reg
    return dataclasses.replace(reg.get(name).config, n_layers=layers,
                               dtype=torch.float32)


def p21_place(cfg, params, mesh, rules):
    from repro_torch.distributed.sharding import place_tree, use_rules
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TF
    with use_rules(rules, mesh=mesh):
        specs = L.spec_tree(TF.param_defs(cfg))
    return place_tree(params, specs, mesh)


def p21_collectives(rec: dict, label: str, counter, cfg, mesh, rules,
                    steps: list) -> None:
    """(d): the bytes the runs moved between mesh positions, counted where
    they moved (``count_crossings``), equal kind by kind to the dry run's
    count from the specs (``launch.collectives``) of the same steps:
    ``steps`` is [(mode, batch, seq, times)]."""
    from repro_torch.distributed.sharding import CrossingCounter
    from repro_torch.launch.collectives import lm_collectives
    want = CrossingCounter()
    for mode, b, seq, times in steps:
        want.merge(lm_collectives(cfg, mesh, mode=mode, batch=b, seq=seq,
                                  rules=rules), times)
    got, want = counter.summary(), want.summary()
    ok = got == want
    kinds = {k: round(v["bytes"] / 1e9, 4) for k, v in got.items()
             if isinstance(v, dict) and v["count"]}
    print(f"    (d) crossings counted {got['total_count']} transfers, "
          f"{got['total_bytes'] / 1e9:.4f} GB by kind {kinds}; the dry "
          f"run's count {want['total_count']}, "
          f"{want['total_bytes'] / 1e9:.4f} GB"
          + (" equal kind by kind" if ok else " FAIL"))
    rec.setdefault("collectives", {})[label] = dict(counted=got, dryrun=want)
    if not ok:
        fail(f"phase 21(d) {label}: counted {got} != dry run {want}")


def p21_fp64_grads(cfg, batch) -> dict | None:
    """{path: the flat path's fp64 gradient, on the host} of the same
    params and batch, where fp64 params and gradients fit
    (P21_FP64_BYTES); else None."""
    import torch

    from repro_torch import tree as T
    from repro_torch.models import transformer as TF

    if cfg.param_count() * 16 > P21_FP64_BYTES:
        return None
    c64 = dataclasses.replace(cfg, dtype=torch.float64)
    params = T.tree_map(lambda t: t.double(), p21_params(cfg))
    leaves = [t.requires_grad_(True) for t in T.leaves(params)]
    loss, _ = TF.loss_fn(params, c64, batch)
    out = {p: g.cpu() for (p, _), g in zip(
        T.leaves_with_paths(params), torch.autograd.grad(loss, leaves))}
    del params, leaves, loss
    torch.cuda.empty_cache()
    return out


def p21_loss(rec: dict, cfg, mesh_shape, rules, label: str) -> None:
    """fp32 loss, MoE aux and every leaf's gradient on placed params
    against the flat path on the same params (P20's gates), the step's
    crossings counted.  Where the fp64 gradient fits (``p21_fp64_grads``)
    a leaf past P20_GRAD_RTOL from the flat one passes if it is at most
    P21_FP64_RATIO x as far from fp64 as the flat fp32 gradient is: the
    flat path's own error is then at that level too."""
    import torch

    from repro_torch import tree as T
    from repro_torch.distributed.sharding import (count_crossings, gather,
                                                  is_placed, use_rules)
    from repro_torch.models import transformer as TF

    batch = p20_batch(cfg, P21_BATCH)
    exact = p21_fp64_grads(cfg, batch)
    params = p21_params(cfg)
    leaves = [t.requires_grad_(True) for t in T.leaves(params)]
    loss, aux = TF.loss_fn(params, cfg, batch)
    # The flat gradients wait on the host: the card then holds the placed
    # run beside no second set of gradients.
    flat_g = dict(zip([p for p, _ in T.leaves_with_paths(params)],
                      (g.cpu() for g in torch.autograd.grad(loss, leaves))))
    flat_loss, flat_aux = float(loss.detach()), float(aux["moe_aux"])
    del loss, leaves, aux
    mesh = p20_mesh(mesh_shape)
    placed = p21_place(cfg, params, mesh, rules)
    del params
    placed = T.tree_map(lambda t: t.requires_grad_(True), placed)
    blocks = T.leaves(placed)
    torch.cuda.reset_peak_memory_stats()
    with use_rules(rules, mesh=mesh), count_crossings() as counter:
        plan = TF.shard_plan(cfg, P21_BATCH[0])
        loss, aux = TF.loss_fn(placed, cfg, batch)
        gs = torch.autograd.grad(loss, blocks, allow_unused=True)
    peak = torch.cuda.max_memory_allocated() / 1e9
    by_id = {id(b): torch.zeros_like(b) if g is None else g
             for b, g in zip(blocks, gs)}
    del gs
    loss, moe_aux = float(loss.detach()), float(aux["moe_aux"])
    loss_rel = abs(loss - flat_loss) / abs(flat_loss)
    aux_rel = abs(moe_aux - flat_aux) / max(abs(flat_aux), 1e-30)
    def rel_of(a, b) -> float:
        return float((a - b.to(a.dtype)).norm()
                     / b.norm().clamp_min(1e-30))

    worst, worst_path, past, ratio = 0.0, "", [], 0.0
    for path, x in T.leaves_with_paths(placed, is_leaf=is_placed):
        g = T.tree_map(lambda b: by_id[id(b)], x)
        g = gather(g, device=DEV) if is_placed(g) else g
        want = flat_g.pop(path).to(DEV)
        rel = rel_of(g, want)
        if rel > worst:
            worst, worst_path = rel, "/".join(path)
        if rel > P20_GRAD_RTOL:
            # Past the gate: as far from fp64 as the flat path, or fail.
            r = float("inf") if exact is None else \
                rel_of(g.cpu().double(), exact[path]) / max(
                    rel_of(want.cpu().double(), exact[path]), 1e-30)
            past.append(("/".join(path), rel, r))
            ratio = max(ratio, r)
    ok = loss_rel <= P20_LOSS_RTOL and ratio <= P21_FP64_RATIO \
        and (flat_aux == 0 or aux_rel <= P20_LOSS_RTOL) and not plan["whole"]
    print(f"  {label} on {mesh.shape}, batch {P21_BATCH[0]} x "
          f"{P21_BATCH[1]}, fp32: loss {loss:.6f} vs flat {flat_loss:.6f} "
          f"(rel {loss_rel:.2e}), moe_aux {moe_aux:.6f} vs {flat_aux:.6f} "
          f"(rel {aux_rel:.2e}; gates {P20_LOSS_RTOL}); worst leaf gradient "
          f"{worst:.2e} ({worst_path}; gate {P20_GRAD_RTOL}); peak "
          f"{peak:.2f} GB" + (" ok" if ok else " FAIL"))
    for name, rel, r in sorted(past, key=lambda t: -t[2])[:3]:
        print(f"    {name}: {rel:.2e} from the flat gradient; from the fp64 "
              f"one {r:.2f}x as far as the flat fp32 gradient (gate "
              f"{P21_FP64_RATIO}x; {len(past)} leaves past "
              f"{P20_GRAD_RTOL})")
    print(f"    per shard: {plan}")
    rec[label] = dict(mesh=mesh.shape, loss=loss, flat_loss=flat_loss,
                      loss_rel=loss_rel, moe_aux=moe_aux, flat_aux=flat_aux,
                      worst_grad=worst, worst_leaf=worst_path, peak_gb=peak,
                      plan=plan, past_gate=past)
    if not ok:
        fail(f"phase 21 {label}: loss {loss_rel}, aux {aux_rel}, gradient "
             f"{worst}, past the gate {past}, whole {plan['whole']}")
    del placed, blocks, by_id, flat_g
    p21_collectives(rec, f"{label} loss", counter, cfg, mesh, rules,
                    [("train", *P21_BATCH, 1)])
    torch.cuda.empty_cache()


def p21_serve_run(params, cfg, toks, tokens: list) -> list:
    """(logits, caches) of a prefill and a decode step for each of
    ``tokens`` (the flat run's choices, so every run decodes alike)."""
    import torch

    from repro_torch.models import transformer as TF

    b, s = toks.shape
    pos = torch.full((b,), s, device=DEV)
    out = [TF.prefill(params, cfg, toks, cache_len=s + P21_DECODE)]
    for i, nxt in enumerate(tokens):
        out.append(TF.decode_step(params, cfg, nxt, out[-1][1], pos + i))
    return out


def p21_serve_errs(got: list, want: list) -> dict:
    """Max error over max|value| of each step's logits and cache leaves."""
    from repro_torch import tree as T

    def err(a, b):
        b = b.to(a.device)
        return float((a.double() - b.double()).abs().max()
                     / b.double().abs().max().clamp_min(1e-30))
    errs = {"logits": 0.0, "caches": 0.0}
    for (gl, gc), (wl, wc) in zip(got, want):
        errs["logits"] = max(errs["logits"], err(gl, wl))
        for (_, g), (_, w) in zip(T.leaves_with_paths(gc),
                                  T.leaves_with_paths(wc)):
            errs["caches"] = max(errs["caches"], err(g, w))
    return errs


def p21_serve(rec: dict, cfg, mesh_shape, rules, label: str, *,
              forward: bool = False) -> None:
    """A prefill and P21_DECODE decode steps (MoE: drop-free) on placed
    params against the flat path: every step's logits and every cache
    leaf within P20_LOGIT_TOL x max; with ``forward`` also the
    full-sequence logits.  Past the gate, where an fp64 run fits, the
    mesh's outputs pass at most P21_FP64_RATIO x as far from the fp64
    run's as the flat fp32 ones.  The crossings are counted."""
    import torch

    from repro_torch import tree as T
    from repro_torch.distributed.sharding import count_crossings, use_rules
    from repro_torch.models import transformer as TF

    params = p21_params(cfg)
    toks = p20_batch(cfg, P21_BATCH)["tokens"]
    b, s = P21_BATCH
    mesh = p20_mesh(mesh_shape)
    with torch.no_grad():
        flat = p21_serve_run(params, cfg, toks, [])
        tokens = []
        pos = torch.full((b,), s, device=DEV)
        for i in range(P21_DECODE):
            tokens.append(flat[-1][0].argmax(-1))
            flat.append(TF.decode_step(params, cfg, tokens[-1], flat[-1][1],
                                       pos + i))
        if forward:
            flat_fwd = TF.forward(params, cfg, tokens=toks)[0]
        placed = p21_place(cfg, params, mesh, rules)
        del params
        steps = [("prefill", b, s, 1), ("decode", b, s, P21_DECODE)]
        errs = {}
        with use_rules(rules, mesh=mesh), count_crossings() as counter:
            if forward:
                fwd = TF.forward(placed, cfg, tokens=toks)[0]
                errs["forward logits"] = float(
                    (fwd - flat_fwd).abs().max() / flat_fwd.abs().max())
                del fwd, flat_fwd
                steps.append(("forward", b, s, 1))
            got = p21_serve_run(placed, cfg, toks, tokens)
    errs.update(p21_serve_errs(got, flat))
    del placed
    past = {k: v for k, v in errs.items() if v > P20_LOGIT_TOL}
    ratios = {}
    if past and cfg.param_count() * 8 <= P21_FP64_BYTES:
        c64 = dataclasses.replace(cfg, dtype=torch.float64)
        with torch.no_grad():
            exact = p21_serve_run(T.tree_map(lambda t: t.double(),
                                             p21_params(cfg)), c64, toks,
                                  tokens)
        e_mesh, e_flat = p21_serve_errs(got, exact), \
            p21_serve_errs(flat, exact)
        ratios = {k: e_mesh[k] / max(e_flat[k], 1e-30) for k in past
                  if k in e_mesh}
        del exact
    ok = all(ratios.get(k, float("inf")) <= P21_FP64_RATIO for k in past)
    print(f"  {label} on {mesh.shape}: prefill {b} x {s} + {P21_DECODE} "
          f"decode steps, max error / max: "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" (gate {P20_LOGIT_TOL})"
          + "".join(f"; {k} {r:.2f}x as far from the fp64 run as the flat "
                    f"fp32 one (gate {P21_FP64_RATIO}x)"
                    for k, r in ratios.items())
          + (" ok" if ok else " FAIL"))
    rec[f"{label} serve"] = dict(errs=errs, fp64_ratios=ratios)
    if not ok:
        fail(f"phase 21 {label} serve: {errs}, fp64 ratios {ratios}")
    del got, flat
    p21_collectives(rec, f"{label} serve", counter, cfg, mesh, rules, steps)
    torch.cuda.empty_cache()


def p21_adafactor(rec: dict, cfg, name: str, mesh_shape, rules) -> None:
    """(a): P21_STEPS steps of the Trainer's own step path with the
    arch's default optimizer (Adafactor from 90B params) on placed params
    against the flat Trainer: params within max(P20_RTOL, P20_SPREAD x
    the flat run's own spread at microbatches=2 vs 1)."""
    import torch

    from repro_torch import tree as T
    from repro_torch.data import LMDataConfig, lm_batch
    from repro_torch.distributed.sharding import count_crossings
    from repro_torch.models import layers as L
    from repro_torch.models import registry as reg
    from repro_torch.models import transformer as TF
    from repro_torch.optim import constant, default_optimizer_for
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.distributed.sharding import use_rules

    n_full = reg.get(name).config.param_count()
    data = LMDataConfig(vocab=cfg.vocab, seq_len=P21_BATCH[1],
                        global_batch=P21_BATCH[0], seed=0)
    mesh = p20_mesh(mesh_shape)

    def trainer(params, micro=1, on_mesh=False):
        specs = None
        if on_mesh:
            with use_rules(rules, mesh=mesh):
                specs = L.spec_tree(TF.param_defs(cfg))
        torch.cuda.reset_peak_memory_stats()
        return Trainer(
            loss_fn=lambda p, b: TF.loss_fn(p, cfg, b), params=params,
            optimizer=default_optimizer_for(name, n_full, constant(1e-3)),
            batch_fn=lambda s: lm_batch(data, s),
            config=TrainerConfig(total_steps=P21_STEPS, ckpt_every=100,
                                 ckpt_dir=str(ROOT / "build" / "smoke_p21"),
                                 log_every=1, microbatches=micro),
            device=None if on_mesh else DEV, mesh=mesh if on_mesh else None,
            param_specs=specs, rules=rules if on_mesh else None)

    flat = {}
    for micro in (1, 2):
        tr = trainer(p21_params(cfg), micro)
        losses, ms = p20_steps(tr, P21_STEPS)
        flat[micro] = dict(losses=losses, ms=ms, opt=tr.opt.name,
                           peak=torch.cuda.max_memory_allocated() / 1e9,
                           params=T.tree_map(lambda t: t.detach().cpu(),
                                             tr.params))
        del tr
        torch.cuda.empty_cache()
    spread = tree_rel(flat[2]["params"], flat[1]["params"])
    gate = max(P20_RTOL, P20_SPREAD * spread)
    tr = trainer(p21_params(cfg), on_mesh=True)     # it places them
    held = p20_held(tr)
    with count_crossings() as counter:
        losses, ms = p20_steps(tr, P21_STEPS)
    peak = torch.cuda.max_memory_allocated() / 1e9
    got = T.tree_map(lambda t: t.detach().cpu(), gathered(tr.params))
    rel = tree_rel(got, flat[1]["params"])
    ok = rel <= gate and tr.opt.name == "adafactor"
    gb = {"x".join(map(str, k)): round(v / 1e9, 3)
          for k, v in held["held"].items()}
    s_ms, f_ms = statistics.median(ms[1:]), statistics.median(
        flat[1]["ms"][1:])
    print(f"  {tr.opt.name} x {P21_STEPS} steps on {mesh.shape}: losses "
          f"{[round(v, 5) for v in losses]} (flat "
          f"{[round(v, 5) for v in flat[1]['losses']]}); params vs flat "
          f"relative norm {rel:.2e} (gate {gate:.2e}: the flat run's own "
          f"spread at microbatches=2 vs 1 {spread:.2e})"
          + (" ok" if ok else " FAIL"))
    print(f"    held a position (GB, params + Adafactor state): {gb}; "
          f"{len(held['split'])} leaves split, {len(held['whole'])} whole; "
          f"peak {peak:.2f} GB (flat {flat[1]['peak']:.2f}); step "
          f"{s_ms:.1f} ms sharded vs {f_ms:.1f} ms flat (CUDA events, "
          f"median of steps 2-{P21_STEPS})")
    rec["adafactor"] = dict(losses=losses, flat_losses=flat[1]["losses"],
                            rel=rel, spread=spread, gate=gate, held_gb=gb,
                            peak_gb=peak, flat_peak_gb=flat[1]["peak"],
                            step_ms=ms, flat_step_ms=flat[1]["ms"])
    if not ok:
        fail(f"phase 21(a) adafactor: {rel} > {gate} ({tr.opt.name})")
    del tr, flat, got
    p21_collectives(rec, "adafactor steps", counter, cfg, mesh, rules,
                    [("train", *P21_BATCH, P21_STEPS)])
    torch.cuda.empty_cache()


def mesh_paths_phase(record: dict) -> None:
    """Phase 21: dbrx-132b expert-parallel with a split batch and
    Adafactor, grok-1-314b's tensor-parallel experts, recurrentgemma-9b's
    RG-LRU and rwkv6-3b's RWKV-6 per shard, each held to the flat path,
    and every run's crossings to the dry run's count."""
    import torch

    t0 = time.monotonic()
    torch.cuda.empty_cache()
    print(f"  meshes repeat {DEV}:0 (one card holds every block); fp32, "
          f"TF32 off")
    rec = record["p21"] = {}
    name, layers, mesh = P21_DBRX
    cfg, rules = p21_cfg(name, layers), p21_rules(name)
    print(f"  (a) {name} cut to {layers} layer, experts -> "
          f"{rules['experts']}, its default optimizer")
    p21_loss(rec, cfg, mesh, rules, f"{name} ({layers} layer)")
    p21_serve(rec, cfg, mesh, rules, f"{name} ({layers} layer)")
    p21_adafactor(rec, cfg, name, mesh, rules)
    name, layers, mesh = P21_GROK
    cfg, rules = p21_cfg(name, layers), p21_rules(name)
    print(f"  (b) {name} cut to {layers} layer, tensor-parallel experts")
    p21_serve(rec, cfg, mesh, rules, f"{name} ({layers} layer)",
              forward=True)
    name, layers, mesh = P21_RG
    cfg = p21_cfg(name, layers)
    print(f"  (c) {name} cut to {layers} layers (one period)")
    p21_loss(rec, cfg, mesh, None, f"{name} ({layers} layers)")
    p21_serve(rec, cfg, mesh, None, f"{name} ({layers} layers)")
    name, layers, meshes = P21_RWKV
    cfg = p21_cfg(name, layers)
    print(f"      {name} cut to {layers} layers")
    for mesh in meshes:
        label = f"{name} ({layers} layers, {mesh[1]}-way)"
        p21_loss(rec, cfg, mesh, None, label)
        p21_serve(rec, cfg, mesh, None, label)
    record["phase21_s"] = time.monotonic() - t0
    print(f"  phase 21 in {record['phase21_s']:.1f} s (budget "
          f"{P21_SECONDS} s) on {smi()}")


# ---------------------------------------------------------------------------
# Phase 22: the design-space layer (Sec. 3.2 on the H100, the Eq. 6
# inverse, the traffic model of the kernels at their tiles)
# ---------------------------------------------------------------------------

# The five DCL shapes of the 512 bucket: (h, c, stride); C = M.
P22_SHAPES = [(64, 128, 1), (64, 256, 2), (32, 256, 1), (32, 512, 2),
              (16, 512, 1)]
# Each main-path instance: (label, chooser datapath, counter name).
P22_PATHS = [("1a", "fp32", "deform_conv_fused"),
             ("4", "banded", "deform_conv_banded"),
             ("1c", "int8", "deform_conv_fused_q"),
             ("1d", "int8_chain", "deform_conv_chain"),
             ("2", "fp32_bwd", "deform_conv_bwd"),
             ("1b", "sample", "deform_sample_zerocopy")]
P22_RANK_SHAPE = (32, 256, 1)         # a c4 layer
P22_EDGE_SHAPE = (16, 512, 1)         # the c5 layer of (c)
P22_SECONDS = 10                      # phase 22's budget (printed)


def p22_best_ms(fn, reps: int = 5) -> float:
    """Best of ``reps`` calls back to back (CUDA events around each), after
    one untimed call."""
    import torch
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return min(s.elapsed_time(e) for s, e in events)


def p22_call(path: str, n: int, h: int, c: int, s: int, b: float, gen,
             tiles=None) -> dict:
    """One kernel call of a main-path instance at one DCL shape (C = M)
    and bound ``b``: its wrapper and plain version on the same CUDA
    inputs (``run``, ``plain``), its tiles (the chooser's unless given;
    spatial tiles clamped as the dispatch path clamps them), its
    ``core.tiling`` traffic and ``core.h100`` work, and the bytes of
    ``pad_and_band``'s gather that the banded call's traffic holds."""
    import functools

    import torch

    from repro_torch.core import tiling as T
    from repro_torch.kernels import deform_conv_bwd as D
    from repro_torch.kernels import deform_conv_fused as F
    from repro_torch.kernels import deform_conv_q as Q
    from repro_torch.kernels import deform_sample as S
    from repro_torch.kernels import plan
    from repro_torch.quant.qtypes import compute_scale, quantize_values

    dtype = dict((p, d) for p, d, _ in P22_PATHS)[path]
    k2, m = K * K, c
    ho, wo = T.out_hw(h, h, kernel_size=K, stride=s, dilation=1)
    geom = dict(kernel_size=K, stride=s, dilation=1, offset_bound=b)
    if tiles is None:
        tiles = plan.resolve_tiles(n, h, h, c, m, dtype=dtype,
                                   tile_h=8 if path in ("4", "1b") else None,
                                   **geom)
    th, tw, tc, tm = tiles
    th, tw = (th if path == "4" else min(th, ho)), min(tw, wo)
    x = torch.randn(n, h, h, c, device="cuda", generator=gen)
    off = (2 * torch.rand(n, ho, wo, 2 * k2, device="cuda", generator=gen)
           - 1) * (b + 0.5)
    w = torch.randn(k2, c, m, device="cuda", generator=gen) / (k2 * c) ** 0.5
    shape = T.LayerShape(h=h, w=h, c_in=c, c_out=m, stride=s,
                         offset_bound=b)
    kt = T.KernelTiles(th, tw, tc, tm)
    kw = dict(tile_h=th, tile_w=tw, tile_c=tc, **geom)
    g = dict(kernel_size=K, stride=s, dilation=1)
    gather = 0
    if path in ("1a", "2", "1b"):
        xp = plan.pad_zerocopy(x, tile_h=th, tile_w=tw, ho=ho, wo=wo,
                               **geom)
    if path == "1a":
        args = (xp, off, plan.tile_weights(w, tc))
        fn, plainf = F.deform_conv_fused_zerocopy, \
            F.deform_conv_fused_zerocopy_plain
        kw["tile_m"] = tm
        traffic = T.dcl_total_hbm_bytes(shape, kt, batch=n)
        work = h100.forward_work(n, h, h, c, m, **g)
    elif path == "4":
        spec = plan.DCSpec(K, s, 1, b, th, dataflow="banded")
        bands, offb = plan.banded_inputs(spec, x, off, th)
        args = (bands, offb, plan.tile_weights(w, tc))
        fn, plainf = F.deform_conv_fused_banded, \
            F.deform_conv_fused_banded_plain
        kw["tile_m"] = tm
        gather = 2 * bands.numel() * bands.element_size()
        traffic = T.dcl_total_hbm_bytes(shape, kt, batch=n,
                                        dataflow="materialized_band")
        work = h100.banded_work(n, h, h, c, m, offset_bound=b, tile_h=th,
                                **g)
    elif path == "2":
        gy = torch.randn(n, ho, wo, m, device="cuda", generator=gen)
        args = (xp, off, gy, plan.tile_weights(w, tc))
        fn, plainf = D.deform_conv_bwd_zerocopy, \
            D.deform_conv_bwd_zerocopy_plain
        traffic = T.dcl_backward_hbm_bytes(shape, kt, batch=n)
        work = h100.backward_work(n, h, h, c, m, **g)
    elif path == "1b":
        args = (xp, off)
        fn, plainf = S.deform_sample_zerocopy, S.deform_sample_zerocopy_plain
        traffic = T.dcl_sample_hbm_bytes(shape, kt, batch=n)
        work = h100.sample_work(n, h, h, c, **g)
    else:
        sx, sw = compute_scale(x), compute_scale(w, axis=-1)
        xq, wq = quantize_values(x, sx), quantize_values(w, sw)
        xp = plan.pad_zerocopy(xq, tile_h=th, tile_w=tw, ho=ho, wo=wo,
                               **geom)
        kw["tile_m"] = tm
        if path == "1c":
            args = (xp, off, plan.tile_weights(wq, tc),
                    (sx * sw).reshape(m).contiguous())
            fn, plainf = Q.deform_conv_fused_zerocopy_q, \
                Q.deform_conv_fused_zerocopy_q_plain
            traffic = T.dcl_total_hbm_bytes(shape, kt, batch=n,
                                            bytes_per_elem=1)
            work = h100.int8_work(n, h, h, c, m, **g)
        else:
            woff = torch.randn(k2, c, 2 * k2, device="cuda", generator=gen)
            woq = quantize_values(woff, compute_scale(woff, axis=-1))
            # Offsets spread to about the bound once dequantized; an
            # emission of std ~40 on the int8 grid.
            acc_std = (k2 * c) ** 0.5 * xq.float().std() * woq.float().std()
            off_scale = torch.full((2 * k2,), b / acc_std.item(),
                                   device="cuda")
            off_bias = torch.randn(2 * k2, device="cuda", generator=gen)
            y_std = (k2 * c) ** 0.5 * xq.float().std() * wq.float().std()
            out_scale = torch.full((m,), 40.0 / y_std.item(), device="cuda")
            out_bias = torch.randn(m, device="cuda", generator=gen)
            args = (xp, plan.tile_weights(wq, c), plan.tile_weights(woq, c),
                    off_scale, off_bias, out_scale, out_bias)
            fn, plainf = Q.deform_conv_fused_zerocopy_chain, \
                Q.deform_conv_fused_zerocopy_chain_plain
            kw.update(emit="int8", ho=ho, wo=wo)
            traffic = T.dcl_total_hbm_bytes(shape, kt, batch=n,
                                            bytes_per_elem=1,
                                            fused_offsets=True)
            work = h100.int8_work(n, h, h, c, m, chain=True, emit="int8",
                                  **g)
    return dict(run=functools.partial(fn, *args, **kw),
                plain=functools.partial(plainf, *args, **kw),
                tiles=[th, tw, tc, tm], traffic=traffic, work=work,
                gather=gather, inputs=(x, off, w))


def p22_traffic(record: dict, gen) -> None:
    """(a) Each main-path instance at the five shapes: the chooser's tiles,
    the traffic beside the bound's bytes (gate: traffic >= them), the
    kernel's time and traffic / time."""
    rows = []
    for h, c, s in P22_SHAPES:
        for path, _, _ in P22_PATHS:
            call = p22_call(path, BATCH, h, c, s, B, gen)
            ms = p22_best_ms(call["run"])
            # Kernel 4's own bytes: the traffic less pad_and_band's gather,
            # which runs before it (not timed here).
            kernel_bytes = call["traffic"] - call["gather"]
            floor = call["work"]["bytes"]
            row = dict(path=path, h=h, c=c, stride=s, tiles=call["tiles"],
                       traffic=call["traffic"], kernel_bytes=kernel_bytes,
                       bound_bytes=floor, ms=ms,
                       gbps=kernel_bytes / ms / 1e6,
                       bound_ms=call["work"]["bound_s"] * 1e3)
            rows.append(row)
            print(f"  (a) {path:<3} {h}x{h}x{c}->{c} s{s} tiles "
                  f"{call['tiles']} traffic {call['traffic'] / 1e6:.3f} MB"
                  f"{'' if not call['gather'] else f' (kernel {kernel_bytes / 1e6:.3f})'}"
                  f" bound {floor / 1e6:.3f} MB ({call['traffic'] / floor:.1f}x)"
                  f" time {ms:.4f} ms, {row['gbps']:.1f} GB/s "
                  f"(bound {row['bound_ms']:.4f} ms)")
            if kernel_bytes < floor:
                fail(f"phase 22(a) {path} {h}x{c}: traffic {kernel_bytes} "
                     f"< the bound's {floor} bytes")
            del call
    record["phase22_traffic"] = rows


def p22_spearman(a: list, b: list) -> float:
    """Spearman's rank correlation (average ranks for ties)."""
    def ranks(v):
        order = sorted(range(len(v)), key=lambda i: v[i])
        r = [0.0] * len(v)
        i = 0
        while i < len(v):
            j = i
            while j + 1 < len(v) and v[order[j + 1]] == v[order[i]]:
                j += 1
            for k in range(i, j + 1):
                r[order[k]] = (i + j) / 2
            i = j + 1
        return r
    ra, rb = ranks(a), ranks(b)
    ma, mb = statistics.fmean(ra), statistics.fmean(rb)
    cov = sum((x - ma) * (y - mb) for x, y in zip(ra, rb))
    var = (sum((x - ma) ** 2 for x in ra)
           * sum((y - mb) ** 2 for y in rb)) ** 0.5
    return cov / var if var else float("nan")


def p22_rank_one(path: str, h: int, c: int, s: int, gen) -> dict:
    """Every neighbour candidate of one instance at one shape, timed: the
    Spearman rank correlation of traffic and time, and each one's pick."""
    from repro_torch.core import tiling as T
    dtype = dict((p, d) for p, d, _ in P22_PATHS)[path]
    geom = dict(kernel_size=K, stride=s, offset_bound=B, dtype=dtype)
    seed = T.choose_kernel_tiles(BATCH, h, h, c, c, **geom)
    pts = []
    for kt in T.neighbor_kernel_tiles(BATCH, h, h, c, c, seed, **geom):
        call = p22_call(path, BATCH, h, c, s, B, gen,
                        tiles=(kt.tile_h, kt.tile_w, kt.tile_c, kt.tile_m))
        pts.append(dict(tiles=call["tiles"], traffic=call["traffic"],
                        ms=p22_best_ms(call["run"])))
    return dict(path=path, h=h, c=c, stride=s, points=pts,
                spearman=p22_spearman([p["traffic"] for p in pts],
                                      [p["ms"] for p in pts]))


def p22_rank(record: dict, gen) -> None:
    """(b) Does the traffic model rank the tiles as the card times them?
    fp32 1a at one c4 shape, then 1a, kernel 2 and 1c (whose neighbours
    keep the spatial tiles) at all five shapes."""
    def pick(pts, key):
        p = min(pts, key=lambda q: q[key])
        return f"{p['tiles']} ({p['traffic'] / 1e6:.3f} MB, {p['ms']:.4f} ms)"
    rows = []
    for path, shapes in (("1a", [P22_RANK_SHAPE] + [
            sh for sh in P22_SHAPES if sh != P22_RANK_SHAPE]),
            ("2", P22_SHAPES), ("1c", P22_SHAPES)):
        for h, c, s in shapes:
            r = p22_rank_one(path, h, c, s, gen)
            pts = r["points"]
            print(f"  (b) {path:<3} {h}x{h}x{c}->{c} s{s}: {len(pts)} "
                  f"candidates, Spearman rho(traffic, time) = "
                  f"{r['spearman']:.3f}; least traffic "
                  f"{pick(pts, 'traffic')}, fastest {pick(pts, 'ms')}, "
                  f"chooser {pts[0]['tiles']} ({pts[0]['ms']:.4f} ms)")
            rows.append(r)
    record["phase22_rank"] = rows


def p22_bstar(dtype: str, n: int, h: int, c: int, s: int) -> int:
    """The largest integer B the chooser takes for ``dtype`` at one shape
    (it takes 2; doubling, then bisection)."""
    from repro_torch.core.tiling import choose_kernel_tiles

    def fits(b: int) -> bool:
        try:
            choose_kernel_tiles(n, h, h, c, c, kernel_size=K, stride=s,
                                offset_bound=float(b), dtype=dtype)
            return True
        except ValueError:
            return False
    lo, hi = 2, 4
    while fits(hi):
        lo, hi = hi, 2 * hi
        if hi > 4096:
            fail(f"phase 22(c) {dtype}: the chooser takes B = {lo}")
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return lo


def p22_refused(path: str, n: int, h: int, c: int, s: int, b: float,
                gen) -> str:
    """The entry point at bound ``b`` (past B*): the chooser's ValueError,
    which is returned; fails if the call returns."""
    import torch

    from repro_torch.kernels import ops
    x = torch.randn(n, h, h, c, device="cuda", generator=gen)
    ho = (h - 1) // s + 1
    off = torch.zeros(n, ho, ho, 2 * K * K, device="cuda")
    w = torch.randn(K * K, c, c, device="cuda", generator=gen) * 0.01
    kw = dict(kernel_size=K, stride=s, offset_bound=b, device="cuda")
    try:
        if path == "1d":
            ops.deform_conv_chain(x, w, torch.randn(K * K, c, 2 * K * K,
                                                    device="cuda") * 0.01,
                                  torch.zeros(2 * K * K, device="cuda"),
                                  x_scale=0.05, emit="fp32", **kw)
        elif path == "2":
            x.requires_grad_(True)
            y = ops.deform_conv(x, off, w, **kw)
            torch.autograd.grad(y.sum(), x)
        else:
            ops.deform_conv(x, off, w, precision="int8" if path == "1c"
                            else "fp32", **kw)
    except ValueError as e:
        return str(e)
    fail(f"phase 22(c) {path}: the entry point took B = {b}, past B*")


def p22_boundary(record: dict, gen) -> None:
    """(c) The Eq. 5 <-> on-chip boundary on the c5 layer: B* launches and
    holds to its plain version; B* + 1 is refused before any launch."""
    import torch

    from repro_torch.core.tiling import (PAPER_TILES, SMEM_PER_BLOCK,
                                         max_offset_bound_fitting)
    h, c, s = P22_EDGE_SHAPE
    fns = counted()
    paper = max_offset_bound_fitting(K, s, PAPER_TILES.t_w, PAPER_TILES.t_n,
                                     SMEM_PER_BLOCK)
    rows = []
    for path, dtype, counter in P22_PATHS:
        if path not in ("1a", "1c", "1d", "2"):
            continue
        bstar = p22_bstar(dtype, BATCH, h, c, s)
        call = p22_call(path, BATCH, h, c, s, float(bstar), gen)
        before = fns[counter].launches
        got = call["run"]()
        torch.cuda.synchronize()
        launched = fns[counter].launches - before
        want = call["plain"]()
        if path in ("1c", "1d"):
            ok, err = torch.equal(got, want), \
                (got.float() - want.float()).abs().max().item()
            gate = "torch.equal"
        else:
            got, want = (got, want) if path == "2" else ((got,), (want,))
            tol = BWD_RTOL if path == "2" else KERNEL_RTOL
            errs = [((a - r).abs().max() / r.abs().max()).item()
                    for a, r in zip(got, want)]
            err, ok, gate = max(errs), max(errs) <= tol, f"<= {tol}"
        del got, want, call
        before = dict(read_counts())
        msg = p22_refused(path, BATCH, h, c, s, float(bstar + 1), gen)
        moved = read_counts()[counter] - before[counter]
        refused = "too large" in msg and moved == 0
        rows.append(dict(path=path, dtype=dtype, bstar=bstar,
                         launched=launched, err=err, ok=ok,
                         refused=refused, paper_bound=paper))
        print(f"  (c) {path:<3} {dtype:<10} {h}x{h}x{c}: B* = {bstar} "
              f"(RF {K + 2 * bstar}); at B* {launched} launch, error "
              f"{err:.2e} ({gate}) {'ok' if ok else 'FAIL'}; at B* + 1 "
              f"refused, {moved} launches: {msg[:60]}...; paper tiles "
              f"(T_W {PAPER_TILES.t_w}, T_N {PAPER_TILES.t_n}, bf16) "
              f"B = {paper:.0f}")
        if launched != 1 or not ok or not refused:
            fail(f"phase 22(c) {path}: B* = {bstar}, launches {launched}, "
                 f"error {err} ({gate}), B* + 1 refused: {refused} "
                 f"({moved} launches)")
    record["phase22_boundary"] = rows


def design_space_phase(record: dict) -> None:
    """Phase 22: (a) traffic against time, (b) whether the model ranks the
    tiles, (c) the Eq. 5 <-> on-chip boundary."""
    import torch

    from repro_torch.tune.cache import tile_cache_scope
    t0 = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(22)
    print(f"  {smi()}")
    with tile_cache_scope(None):        # the chooser's tiles, not a cache's
        p22_traffic(record, gen)
        p22_rank(record, gen)
        p22_boundary(record, gen)
    torch.cuda.empty_cache()
    record["phase22_s"] = time.monotonic() - t0
    print(f"  phase 22 in {record['phase22_s']:.1f} s (budget "
          f"{P22_SECONDS} s, printed)")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside the script",
              file=sys.stderr)
        return 2
    t_start = time.monotonic()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi()
    record: dict = {"card": card}

    print("== 1. environment")
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")
    print(f"  nvidia-smi: {card}")
    print(f"  TF32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}")
    if sys.argv[1:] == ["--only", "17"]:
        # A debugging run of phase 17 alone: no kernels line, no result.
        print("== 17. the remaining LM families (alone)")
        families_phase(record)
        OUT.parent.mkdir(parents=True, exist_ok=True)
        OUT.write_text(json.dumps(record, indent=2))
        print(f"  details in {OUT.relative_to(ROOT)}; "
              f"{time.monotonic() - t_start:.0f} s in all")
        return 0
    if sys.argv[1:] == ["--only", "21"]:
        # A debugging run of phase 21 alone (it runs no kernel): no
        # kernels line, no result.
        print("== 21. the last mesh paths (alone)")
        mesh_paths_phase(record)
        OUT.parent.mkdir(parents=True, exist_ok=True)
        OUT.write_text(json.dumps(record, indent=2))
        print(f"  details in {OUT.relative_to(ROOT)}; "
              f"{time.monotonic() - t_start:.0f} s in all")
        return 0
    if sys.argv[1:] == ["--only", "20"]:
        # A debugging run of phase 20 alone (it runs no kernel): no
        # kernels line, no result.
        print("== 20. an LM's params on the mesh by their specs (alone)")
        sharding_phase(record)
        OUT.parent.mkdir(parents=True, exist_ok=True)
        OUT.write_text(json.dumps(record, indent=2))
        print(f"  details in {OUT.relative_to(ROOT)}; "
              f"{time.monotonic() - t_start:.0f} s in all")
        return 0

    print("== 2. build")
    from repro_torch.kernels import _build
    t0 = time.monotonic()
    built = _build.build_all()
    print(f"  nvcc {' '.join(_build.NVCC_FLAGS)}: {sorted(built)} in "
          f"{time.monotonic() - t0:.1f} s")
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    record["build_s"] = time.monotonic() - t0

    if sys.argv[1:] == ["--only", "19"]:
        # A debugging run of phase 19 alone (after the build), the dry
        # run in the foreground: no kernels line, no result.
        from repro_torch.configs.resnet50_dcn import CONFIG_BOUNDED
        from repro_torch.models import resnet_dcn as R
        print("== 19. the planning layer (alone)")
        start_dryrun(DRYRUN_JOBS_ALONE)
        planning_phase(record, perturb_offsets(
            R.init_params(CONFIG_BOUNDED, seed=0, device="cuda"), 1))
        OUT.parent.mkdir(parents=True, exist_ok=True)
        OUT.write_text(json.dumps(record, indent=2))
        print(f"  details in {OUT.relative_to(ROOT)}; "
              f"{time.monotonic() - t_start:.0f} s in all")
        return 0

    if sys.argv[1:] == ["--only", "22"]:
        # A debugging run of phase 22 alone (after the build): no kernels
        # line, no result.
        print("== 22. the design-space layer (alone)")
        design_space_phase(record)
        OUT.parent.mkdir(parents=True, exist_ok=True)
        OUT.write_text(json.dumps(record, indent=2))
        print(f"  details in {OUT.relative_to(ROOT)}; "
              f"{time.monotonic() - t_start:.0f} s in all")
        return 0

    if sys.argv[1:] == ["--only", "18"]:
        # A debugging run of phase 18 alone (after the build): no kernels
        # line, no result.
        from repro_torch.models import resnet_dcn as R
        print("== 18. the device mesh (alone)")
        record["mesh_launches"] = mesh_phase(record, perturb_offsets(
            R.init_params(mesh_dcl_config(), seed=0, device="cuda"), 1))
        OUT.parent.mkdir(parents=True, exist_ok=True)
        OUT.write_text(json.dumps(record, indent=2))
        print(f"  details in {OUT.relative_to(ROOT)}; "
              f"{time.monotonic() - t_start:.0f} s in all")
        return 0

    start_dryrun(DRYRUN_JOBS)      # phase 19(a), in the background

    print("== 3. kernel vs plain on the card")
    from repro_torch.configs.resnet50_dcn import CONFIG_BOUNDED
    from repro_torch.serve import bucket_layer_dims
    # {shape: {bucket: DCLs of that shape in one step of the bucket}}
    per_step: dict[tuple, dict[str, int]] = {}
    for bucket in BUCKETS.split(","):
        for dims in bucket_layer_dims(CONFIG_BOUNDED, int(bucket)).values():
            key = (dims["h"], dims["w"], dims["c"], dims["m"],
                   dims["stride"])
            counts = per_step.setdefault(key, {})
            counts[bucket] = counts.get(bucket, 0) + 1
    cases = [dict(label=f"{h}x{w}x{c}->{m} s{s}", n=BATCH, h=h, w=w, c=c,
                  m=m, stride=s, dilation=1, per_step=cnt)
             for (h, w, c, m, s), cnt in per_step.items()]
    # {shape: {"train": DCLs of that shape in one training step}}: phase
    # 8's batch 8 at 512.
    train_step: dict[tuple, dict[str, int]] = {}
    for dims in bucket_layer_dims(CONFIG_BOUNDED, 512).values():
        key = (dims["h"], dims["w"], dims["c"], dims["m"], dims["stride"])
        cnt = train_step.setdefault(key, {})
        cnt["train"] = cnt.get("train", 0) + 1
    train_cases = [dict(label=f"train {h}x{w}x{c}->{m} s{s}",
                        n=TRAIN_BATCH, h=h, w=w, c=c, m=m, stride=s,
                        dilation=1, per_step=cnt)
                   for (h, w, c, m, s), cnt in train_step.items()]
    cases += train_cases
    cases += [
        dict(label="ragged 17x23x64->64 s1", n=2, h=17, w=23, c=64, m=64,
             stride=1, dilation=1),
        dict(label="dilation2 20x20x64->64", n=2, h=20, w=20, c=64, m=64,
             stride=1, dilation=2),
        dict(label="ragged 15x15x32->48 s2", n=1, h=15, w=15, c=32, m=48,
             stride=2, dilation=1),
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    # The training shapes draw from a generator of their own, so every
    # later phase sees the inputs it saw before phases 3 and 9 had them.
    gen_train = torch.Generator(device="cuda").manual_seed(1)
    record["shapes"] = [check_kernel(c, gen_train if c in train_cases
                                     else gen) for c in cases]
    main_path = [r for r in record["shapes"]
                 if r.get("per_step") and "train" not in r["per_step"]]
    train_path = [r for r in record["shapes"]
                  if "train" in r.get("per_step", {})]
    step = {k: sum(r[k] * r["per_step"]["train"] for r in train_path)
            for k in ("ms", "bound_fp32_ms", "bound_3xtf32_ms")}
    print(f"  kernel 1a a training step ({sum(r['per_step']['train'] for r in train_path)}"
          f" DCLs, batch {TRAIN_BATCH}): {step['ms']:.3f} ms; bounds fp32 "
          f"{step['bound_fp32_ms']:.4f} ms ({step['bound_fp32_ms'] / step['ms']:.1%}),"
          f" 3xTF32 {step['bound_3xtf32_ms']:.4f} ms "
          f"({step['bound_3xtf32_ms'] / step['ms']:.1%})")
    print("  no single PyTorch call computes the bounded deformable conv, "
          "so there is no library time to compare with")

    print("== 4. serve")
    launches, record, params, zc_reqs = serve(record)
    run, bound_by = per_run(
        main_path, record["serve"]["steps_per_bucket"], launches,
        "deform_conv_fused")
    run["prep_ms"] = sum(r["prep_ms"] * r["launches_in_run"]
                         for r in main_path)
    record["run"] = run
    kernels = {"kernels": [{
        "name": "deform_conv_fused",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/deform_conv_fused.cu",
        "replaces": "src/repro/kernels/band_pipeline.py:644",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in record["shapes"]),
        "ms": run["ms"],
        "plain_ms": run["plain_ms"],
        "bound_ms": run["bound_ms"],
        "bound_by": bound_by,
        "bound_note": "3xTF32 (three tf32 products a product) at 494.7 "
                      "TFLOP/s; bound_fp32_ms: fp32 on the CUDA cores",
        "bound_fp32_ms": run["bound_fp32_ms"],
        "library_ms": None,
    }]}
    fwd = record["serve"]["forward_ms_in_run"]
    print(f"  (ms, plain_ms and bound_ms are per served run: the sum over "
          f"its {launches} DCL launches, {run['ms'] / fwd:.0%} of its "
          f"steps' {fwd:.3f} ms of forward; input preparation "
          f"{run['prep_ms']:.3f} ms)")
    print(f"  deform_conv_fused per served run: {launches} launches, kernel "
          f"{run['ms']:.3f} ms, plain {run['plain_ms']:.3f} ms, bound "
          f"{run['bound_ms']:.4f} ms (3xTF32, {bound_by}; fp32 CUDA cores "
          f"{run['bound_fp32_ms']:.4f} ms)")

    print("== 5. int8 kernels vs plain on the card (exact)")
    q_cases = []
    for kind in ("dcq", "dcc"):
        q_cases += [dict(kind=kind, label=f"{h}x{w}x{c}->{m} s{s}", n=BATCH,
                         h=h, w=w, c=c, m=m, stride=s, dilation=1,
                         per_step=cnt)
                    for (h, w, c, m, s), cnt in per_step.items()]
        q_cases += [
            dict(kind=kind, label="ragged 17x23x64->64 s1", n=2, h=17, w=23,
                 c=64, m=64, stride=1, dilation=1),
            dict(kind=kind, label="dilation2 B1.5 20x20x64->64", n=2, h=20,
                 w=20, c=64, m=64, stride=1, dilation=2, bound=1.5),
            dict(kind=kind, label="odd s2 15x15x32->48", n=1, h=15, w=15,
                 c=32, m=48, stride=2, dilation=1),
            dict(kind=kind, label="4-byte s2 15x15x32->48 tc8", n=1, h=15,
                 w=15, c=32, m=48, stride=2, dilation=1, tile_c=8),
            dict(kind=kind, label="1 group 4-byte 64x64x24->200", n=4, h=64,
                 w=64, c=24, m=200, stride=1, dilation=1),
        ]
    q_cases += [
        dict(kind="dcc", label="emit fp32 32x32x128->128", n=BATCH, h=32,
             w=32, c=128, m=128, stride=1, dilation=1, emit="fp32"),
        dict(kind="dcc", label="int8 input verbatim 16x16x64", n=2, h=16,
             w=16, c=64, m=64, stride=1, dilation=1, verbatim=True),
    ]
    mma_s8_check(gen)
    record["q_shapes"] = [check_q_kernel(c, gen) for c in q_cases]
    if not {r["instance"]["staging"] for r in record["q_shapes"]} \
            >= {"16-byte", "4-byte"} or \
            min(r["instance"]["c_groups"] for r in record["q_shapes"]) > 1:
        fail("phase 5 missed 16-byte or 4-byte staging, or one C group")
    print("  no single PyTorch call computes either int8 function, so "
          "there is no library time to compare with")

    print("== 6. int8 serve")
    q_launches = serve_int8(record, params)
    sources = {"deform_conv_fused_q": ("dcq", "int8", 74),
               "deform_conv_chain": ("dcc", "int8_chain", 108)}
    for name, (kind, rung, line) in sources.items():
        shapes = [r for r in record["q_shapes"]
                  if r["kind"] == kind and r.get("per_step")]
        run_q, by = per_run(
            shapes, record["serve_int8"][rung]["steps_per_bucket"],
            q_launches[name], name)
        run_q["queued_ms"] = sum(r["queued_ms"] * r["launches_in_run"]
                                 for r in shapes)
        record[f"run_{name}"] = run_q
        kernels["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/deform_conv_q.cu",
            "replaces": f"src/repro/kernels/band_pipeline.py:644 (via "
                        f"src/repro/kernels/deform_conv_q.py:{line})",
            "launches": q_launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in record["q_shapes"]
                               if r["kind"] == kind),
            "ms": run_q["ms"],
            "plain_ms": run_q["plain_ms"],
            "bound_ms": run_q["bound_ms"],
            "bound_by": by,
            "bound_note": "the largest of the int8 products at 1,979 "
                          "TOP/s, the bytes at 3.35 TB/s and the patch "
                          "build (7 fp32 operations a sample) on the CUDA "
                          "cores; queued_ms: queued behind a busy device",
            "bound_int8_ms": run_q["bound_int8_ms"],
            "sample_bound_ms": run_q["sample_bound_ms"],
            "queued_ms": run_q["queued_ms"],
            "library_ms": None,
        })
        print(f"  {name} per served {rung} run: {q_launches[name]} launches, "
              f"kernel {run_q['ms']:.3f} ms (queued "
              f"{run_q['queued_ms']:.3f}), plain "
              f"{run_q['plain_ms']:.3f} ms, bound {run_q['bound_ms']:.4f} ms "
              f"({by}; int8 {run_q['bound_int8_ms']:.4f}, bytes "
              f"{run_q['bound_bytes_ms']:.4f}, sample_bound_ms "
              f"{run_q['sample_bound_ms']:.4f}), "
              f"{run_q['bound_ms'] / run_q['ms']:.1%} of it")

    print("== 7. backward kernel vs plain on the card")
    # {shape: {"512": DCLs of that shape in one training step}}
    bwd_step: dict[tuple, dict[str, int]] = {}
    for dims in bucket_layer_dims(CONFIG_BOUNDED, 512).values():
        key = (dims["h"], dims["w"], dims["c"], dims["m"], dims["stride"])
        cnt = bwd_step.setdefault(key, {})
        cnt["512"] = cnt.get("512", 0) + 1
    b_cases = [dict(label=f"{h}x{w}x{c}->{m} s{s}", n=TRAIN_BATCH, h=h,
                    w=w, c=c, m=m, stride=s, dilation=1, per_step=cnt)
               for (h, w, c, m, s), cnt in bwd_step.items()]
    b_cases += [
        dict(label="ragged 17x23x64->64 s1", n=2, h=17, w=23, c=64, m=64,
             stride=1, dilation=1),
        dict(label="dilation2 B1.5 20x20x64->64", n=2, h=20, w=20, c=64,
             m=64, stride=1, dilation=2, bound=1.5),
        dict(label="odd s2 15x15x32->48 tc16", n=1, h=15, w=15, c=32,
             m=48, stride=2, dilation=1, tile_c=16),
    ]
    record["bwd_shapes"] = [check_bwd_kernel(c, gen) for c in b_cases]
    if any(r["tiles"][2] >= r["c"] for r in record["bwd_shapes"]):
        fail("a backward case has tile_c = C: the C loop is untested")
    step = [r for r in record["bwd_shapes"] if r.get("per_step")]
    k2_step = {k: sum(r[k] * r["per_step"]["512"] for r in step)
               for k in ("ms", "bound_fp32_ms", "bound_3xtf32_ms")}
    record["bwd_step_ms"] = k2_step
    print(f"  kernel 2 a training step ({sum(r['per_step']['512'] for r in step)}"
          f" DCLs): {k2_step['ms']:.3f} ms; CUDA-core design: "
          f"{BWD_STEP_MS_BEFORE} ms, half of it {BWD_STEP_MS_HALF} ms; bounds fp32 "
          f"{k2_step['bound_fp32_ms']:.4f} ms "
          f"({k2_step['bound_fp32_ms'] / k2_step['ms']:.1%}), 3xTF32 "
          f"{k2_step['bound_3xtf32_ms']:.4f} ms "
          f"({k2_step['bound_3xtf32_ms'] / k2_step['ms']:.1%})")
    print("  no single PyTorch call computes the bounded deformable conv's "
          "backward, so there is no library time to compare with")

    print("== 8. train")
    bwd_launches, step0, trained = train(record)
    shapes = [r for r in record["bwd_shapes"] if r.get("per_step")]
    run_b, by = per_run(shapes, {"512": TRAIN_STEPS}, bwd_launches,
                        "deform_conv_bwd")
    record["run_deform_conv_bwd"] = run_b
    kernels["kernels"].append({
        "name": "deform_conv_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/deform_conv_bwd.cu",
        "replaces": "src/repro/kernels/deform_conv_bwd.py:304",
        "launches": bwd_launches,
        "max_abs_err": max(r["max_abs_err"] for r in record["bwd_shapes"]),
        "ms": run_b["ms"],
        "plain_ms": run_b["plain_ms"],
        "bound_ms": run_b["bound_ms"],
        "bound_by": by,
        "bound_note": "3xTF32 (three tf32 products a product) at 494.7 "
                      "TFLOP/s; bound_fp32_ms: fp32 on the CUDA cores",
        "bound_fp32_ms": run_b["bound_fp32_ms"],
        "library_ms": None,
    })
    per_step_ms = run_b["ms"] / TRAIN_STEPS
    # Kernel 1a in the same run: as many launches as kernel 2 (train()
    # checks both counts).
    k1 = fwd_training(train_path, bwd_launches, TRAIN_STEPS,
                      "deform_conv_fused",
                      record["train"]["kernel1a_device_ms"])
    record["run_deform_conv_fused_train"] = k1
    kernels["kernels"][0]["training"] = k1
    print(f"  deform_conv_fused per {TRAIN_STEPS}-step run: {k1['launches']} "
          f"launches, kernel {k1['ms']:.3f} ms ({k1['step_ms']:.3f} ms a "
          f"step; torch.profiler reads {k1['device_step_ms']:.3f} ms a "
          f"step), plain {k1['plain_ms']:.3f} ms, bound "
          f"{k1['bound_ms']:.4f} ms (3xTF32; fp32 CUDA cores "
          f"{k1['bound_fp32_ms']:.4f} ms)")
    print(f"  deform_conv_bwd per {TRAIN_STEPS}-step run: {bwd_launches} "
          f"launches, kernel {run_b['ms']:.3f} ms, plain "
          f"{run_b['plain_ms']:.3f} ms, bound {run_b['bound_ms']:.4f} ms "
          f"(3xTF32, {by}; fp32 CUDA cores {run_b['bound_fp32_ms']:.4f} "
          f"ms); per step {per_step_ms:.3f} ms of the backward's "
          f"{record['train']['backward_ms']:.3f} ms")

    print("== 9. sampling, banded forward and matmul kernels vs plain on "
          "the card")
    five: dict[tuple, dict] = {}
    for dims in bucket_layer_dims(CONFIG_BOUNDED, 512).values():
        h, w, c, m, s = (dims["h"], dims["w"], dims["c"], dims["m"],
                         dims["stride"])
        five.setdefault((h, w, c, m, s), dict(
            label=f"{h}x{w}x{c}->{m} s{s}", n=BATCH, h=h, w=w, c=c, m=m,
            stride=s, dilation=1))
    five_cases = list(five.values())
    edge = [
        dict(label="ragged 17x23x64->64 s1", n=2, h=17, w=23, c=64, m=64,
             stride=1, dilation=1),
        dict(label="dilation2 B1.5 20x20x64->64", n=2, h=20, w=20, c=64,
             m=64, stride=1, dilation=2, bound=1.5),
    ]
    record["sample_shapes"] = [r for case in five_cases + edge
                               for r in check_sample_kernels(case, gen)]
    banded_cases = [dict(label=f"{h}x{w}x{c}->{m} s{s}", n=BATCH, h=h, w=w,
                         c=c, m=m, stride=s, dilation=1, per_step=cnt)
                    for (h, w, c, m, s), cnt in per_step.items()] \
        + train_cases + edge
    record["banded_shapes"] = [
        check_banded_kernel(case, gen_train if case in train_cases else gen)
        for case in banded_cases]
    banded_train = [r for r in record["banded_shapes"]
                    if "train" in r.get("per_step", {})]
    step = {k: sum(r[k] * r["per_step"]["train"] for r in banded_train)
            for k in ("ms", "bound_fp32_ms", "bound_3xtf32_ms")}
    print(f"  kernel 4 a banded training step "
          f"({sum(r['per_step']['train'] for r in banded_train)} DCLs, batch "
          f"{TRAIN_BATCH}): {step['ms']:.3f} ms; bounds fp32 "
          f"{step['bound_fp32_ms']:.4f} ms ({step['bound_fp32_ms'] / step['ms']:.1%}),"
          f" 3xTF32 {step['bound_3xtf32_ms']:.4f} ms "
          f"({step['bound_3xtf32_ms'] / step['ms']:.1%})")
    print("  no single PyTorch call computes the banded fused forward, so "
          "there is no library time to compare with")
    record["mm_shapes"] = [check_matmul(*shape, gen) for shape in MM_SHAPES]
    entry = entry_points(five_cases, gen)
    record["entry_point_launches"] = entry
    five_labels = {case["label"] for case in five_cases}
    for name, replaces in (
            ("deform_sample_zerocopy",
             "src/repro/kernels/band_pipeline.py:644 (via "
             "src/repro/kernels/deform_sample.py:52)"),
            ("deform_sample_banded", "src/repro/kernels/deform_sample.py:107")):
        shapes = [dict(r, per_step={"run": 1}) for r in record["sample_shapes"]
                  if r["kernel"] == name and r["label"] in five_labels]
        run_s, by = per_run(shapes, {"run": 1}, entry[name], name)
        by_dtype = {}
        for dt in SAMPLE_DTYPES:
            sub = [r for r in shapes if r["dtype"] == dt]
            lib_ms = [r["library_ms"] for r in sub]
            by_dtype[dt] = dict(
                {k: sum(r[k] for r in sub)
                 for k in ("ms", "queued_ms", "flushed_ms", "plain_ms",
                           "bytes")},
                launches=len(sub),
                bound_ms=h100.total((r["work"], 1) for r in sub)["bound_s"]
                * 1e3,
                library_ms=None if None in lib_ms else sum(lib_ms),
                host_us=statistics.median(r["host_us"] for r in sub))
            run_dt = by_dtype[dt]
            print(f"  {name} {dt} per entry-point run: {len(sub)} launches, "
                  f"kernel {run_dt['ms']:.4f} ms back to back, "
                  f"{run_dt['queued_ms']:.4f} queued "
                  f"({run_dt['bound_ms'] / run_dt['queued_ms']:.1%} of the "
                  f"bound), {run_dt['flushed_ms']:.4f} L2 flushed; plain "
                  f"{run_dt['plain_ms']:.3f} ms, grid_sample "
                  f"{run_dt['library_ms']} ms, bound "
                  f"{run_dt['bound_ms']:.4f} ms (bytes); host path "
                  f"{run_dt['host_us']:.1f} us a call (median)")
        run_s.update(queued_ms=sum(r["queued_ms"] for r in shapes),
                     flushed_ms=sum(r["flushed_ms"] for r in shapes),
                     library_ms=sum(r["library_ms"] for r in shapes
                                    if r["library_ms"] is not None),
                     by_dtype=by_dtype)
        record[f"run_{name}"] = run_s
        kernels["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/deform_sample.cu",
            "replaces": replaces,
            "launches": entry[name],
            "max_abs_err": max(r["max_abs_err"] for r in
                               record["sample_shapes"] if r["kernel"] == name),
            "ms": run_s["ms"],
            "plain_ms": run_s["plain_ms"],
            "bound_ms": run_s["bound_ms"],
            "bound_by": by,
            "library_ms": run_s["library_ms"],
            "library_note": "F.grid_sample on the shapes it takes"
                            + ("" if None not in (r["library_ms"]
                                                  for r in shapes)
                               else " (it refuses bf16: fp32 only)"),
            "queued_ms": run_s["queued_ms"],
            "flushed_ms": run_s["flushed_ms"],
            "by_dtype": by_dtype,
        })
        print(f"  {name} per entry-point run: {entry[name]} launches (fp32 "
              f"and bf16), kernel {run_s['ms']:.3f} ms, queued "
              f"{run_s['queued_ms']:.4f} ms, plain {run_s['plain_ms']:.3f} "
              f"ms, grid_sample {run_s['library_ms']:.3f} ms, bound "
              f"{run_s['bound_ms']:.4f} ms ({by})")

    print("== 10. serve banded")
    banded_launches = serve_banded(record, params, zc_reqs)
    shapes = [r for r in record["banded_shapes"]
              if r.get("per_step") and "train" not in r["per_step"]]
    run_4, by = per_run(
        shapes, record["serve_banded"]["steps_per_bucket"], banded_launches,
        "deform_conv_banded")
    run_4["prep_ms"] = sum(r["prep_ms"] * r["launches_in_run"]
                           for r in shapes)
    record["run_deform_conv_banded"] = run_4
    kernels["kernels"].append({
        "name": "deform_conv_banded",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/deform_conv_fused.cu",
        "replaces": "src/repro/kernels/deform_conv_fused.py:130",
        "launches": banded_launches,
        "max_abs_err": max(r["max_abs_err"] for r in record["banded_shapes"]),
        "ms": run_4["ms"],
        "plain_ms": run_4["plain_ms"],
        "bound_ms": run_4["bound_ms"],
        "bound_by": by,
        "bound_note": "3xTF32 (three tf32 products a product) at 494.7 "
                      "TFLOP/s; bound_fp32_ms: fp32 on the CUDA cores",
        "bound_fp32_ms": run_4["bound_fp32_ms"],
        "library_ms": None,
    })
    print(f"  deform_conv_banded per served run: {banded_launches} launches, "
          f"kernel {run_4['ms']:.3f} ms, plain {run_4['plain_ms']:.3f} ms, "
          f"bound {run_4['bound_ms']:.4f} ms (3xTF32, {by}; fp32 CUDA cores "
          f"{run_4['bound_fp32_ms']:.4f} ms); bands and weights "
          f"prepared in {run_4['prep_ms']:.3f} ms")

    print("== 11. train banded")
    k4_launches = train_banded(record, step0)
    del step0
    k4 = fwd_training(banded_train, k4_launches, BANDED_TRAIN_STEPS,
                      "deform_conv_banded",
                      record["train_banded"]["kernel4_device_ms"])
    record["run_deform_conv_banded_train"] = k4
    kernels["kernels"][-1]["training"] = k4
    print(f"  deform_conv_banded per {BANDED_TRAIN_STEPS}-step banded run: "
          f"{k4['launches']} launches, kernel {k4['ms']:.3f} ms "
          f"({k4['step_ms']:.3f} ms a step; torch.profiler reads "
          f"{k4['device_step_ms']:.3f} ms a step), plain "
          f"{k4['plain_ms']:.3f} ms, bound {k4['bound_ms']:.4f} ms (3xTF32; "
          f"fp32 CUDA cores {k4['bound_fp32_ms']:.4f} ms)")

    mm = record["mm_shapes"]
    mm_work = h100.total((r["work"], 1) for r in mm)
    record["run_matmul"] = run_mm = dict(
        ms=sum(r["ms"] for r in mm), plain_ms=sum(r["plain_ms"] for r in mm),
        library_ms=sum(r["library_ms"] for r in mm),
        bound_ms=mm_work["bound_s"] * 1e3)
    kernels["kernels"].append({
        "name": "matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/matmul.cu",
        "replaces": "src/repro/kernels/matmul.py:63",
        "launches": entry["matmul"],
        "max_abs_err": max(r["max_abs_err"] for r in mm),
        "ms": run_mm["ms"],
        "plain_ms": run_mm["plain_ms"],
        "bound_ms": run_mm["bound_ms"],
        "bound_by": mm_work["bound_by"],
        "library_ms": run_mm["library_ms"],
    })
    print(f"  matmul per entry-point run: {entry['matmul']} launches, kernel "
          f"{run_mm['ms']:.3f} ms, plain {run_mm['plain_ms']:.3f} ms, "
          f"torch.matmul {run_mm['library_ms']:.3f} ms, bound "
          f"{run_mm['bound_ms']:.4f} ms")

    print("== 12. flash attention (kernel 6) vs plain on the card")
    kernels["kernels"].append(flash_phase(record, gen))

    print("== 13. LM serving at full width")
    lm_phase(record)

    print("== 14. bf16 DCL (kernels 1a, 4 and 2 in bf16) vs plain on the "
          "card")
    record["bf16_shapes"], bf16_rows = bf16_phase(per_step, train_step, gen)
    kernels["kernels"] += bf16_rows

    print("== 15. operations: serve a checkpoint, divergence, tuning, "
          "chaos")
    ops_launches = operations_phase(record, trained, per_step, train_step)
    for row in kernels["kernels"]:
        if row["name"] in ops_launches:
            row["operations_launches"] = ops_launches[row["name"]]

    print("== 16. LM training at full width; recurrentgemma-9b served and "
          "trained")
    lm_train_phase(record)

    print("== 17. the remaining LM families: rwkv6-3b, dbrx-132b, "
          "musicgen-medium, pixtral-12b")
    families_phase(record)

    print("== 18. the device mesh: spatial shards, data parallel, int8_ef, "
          "GPipe, command-r-35b")
    mesh_launches = mesh_phase(record, params)
    for row in kernels["kernels"]:
        if row["name"] in mesh_launches:
            row["mesh_launches"] = mesh_launches[row["name"]]

    print("== 19. the planning layer: every cell dry-run on meta, the "
          "card's shapes against their dry runs")
    plan_launches = planning_phase(record, params)
    for row in kernels["kernels"]:
        if row["name"] in plan_launches:
            row["planning_launches"] = plan_launches[row["name"]]

    print("== 20. an LM's params on the mesh by their specs: tensor-parallel "
          "heads, ff and vocab, FSDP over embed, elastic restore")
    sharding_phase(record)

    print("== 21. the last mesh paths: expert- and tensor-parallel MoE with "
          "a split batch, the RG-LRU and RWKV-6 per shard, Adafactor on "
          "placed leaves, collective bytes")
    mesh_paths_phase(record)

    print("== 22. the design-space layer: traffic of the kernels at their "
          "tiles against time, the model's rank of the tiles, the Eq. 5 "
          "bound at the shared-memory limit")
    design_space_phase(record)

    record["kernels"] = kernels["kernels"]
    record["seconds"] = time.monotonic() - t_start
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(record, indent=2))
    print(f"  details in {OUT.relative_to(ROOT)}; "
          f"{record['seconds']:.0f} s in all (budget {SCRIPT_SECONDS} s, "
          f"printed; the limit is 1200)")
    print(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
