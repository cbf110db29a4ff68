#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gan_class_transfer2_tpu_torch) on one
NVIDIA card. Run it from the root of a checkout:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

  1. build  — compile every csrc/*.cu of the port with nvcc for sm_90a;
  2. kernels — hold B4 against its plain PyTorch version on the card at the
     four full-width k4/s2 down convs at batch 4 (the sampler) and 16
     (training, the GAN), float32 and bfloat16: two launches on the same
     inputs must be bit-identical; print the plan's split of K, and time
     kernel, plain version and one library call (cuDNN) on the same inputs
     beside the bound;
  3. sample — the user's entry point, ``cli.main(["sample", ...])``, at the
     default model width (256², 6 octaves, 41.7 M params, T = 200, stride 50)
     on the card, in float32 and bfloat16: the kernel's launch count must be
     4 per denoiser call, and the images must match the same weights and
     init batch sampled by ``cli sample --device cpu`` in the same dtype (the
     plain versions); then the sampler's steady-state ms per image and a
     torch.profiler breakdown of one sample call by CUDA kernel;
  4. edit   — ``sampler.edit_image`` (invert → edit noise → decode) on one
     synthetic 256² image through the kernel;
  5. reference — a tiny config sampled on the card and on the CPU (the CPU
     path is the one the tests hold against the JAX package) must agree, and
     3 train steps of a tiny config with fused diffusion (B1) and fused Adam
     (B2) on must give the card's and the CPU's losses alike (both draw the
     same Philox noise);
  6. train kernels — B1 (fused forward diffusion, batch 16 × 256²×3, its
     scales gathered from the (T + 1, 2) table by t; bit-identical repeats;
     timed back to back, on the device with L2 warm and cold, and the
     wrapper's host time) and B2
     (fused Adam over every leaf of the 41.7 M-param model, float32 and
     bfloat16 moments) against their plain versions, timed beside their
     bound and, for B2, torch.optim.Adam(fused=True); B4 at the four
     down-conv shapes at batch 16, float32 and bfloat16: its forward and its
     gradients dx, dK, db (cuDNN around the kernel) against the plain
     version's autograd, and the backward timed;
  6a. epilogue — the conv epilogue (csrc/conv_epilogue.cu: a pair's sum,
     bias and ReLU forward; ReLU mask and bias gradient backward) against
     its plain version at the train cell's up0 and up1 outputs at batch 256
     and 16, float32 and bfloat16, timed beside the byte bound (up0 at batch
     256 in bfloat16 must reach 70% of it each way); its launches in one
     train step at batch 256 and one denoiser call at batch 16 of the cell's
     configuration, exactly one a conv forward and two a backward, none a
     torch-op backward. ``python3 chip_smoke.py --epilogue`` runs this phase
     alone, after the build;
  7. train — the user's entry point, ``cli.main(["bench", ...])``, training
     the default model at batch 16 for 3 + 10 steps in float32 and bfloat16,
     through the kernels (``--optimizer adam_fused --fused-diffusion true``)
     and through the optax-form Adam and unfused diffusion (``--optimizer
     adam_tf --fused-diffusion false``), B4 and the epilogue in both: exact
     launch counts per step, finite losses, and a torch.profiler breakdown of
     one step of each;
  7b. train-hbm — the same training fed from a uint8 pool in device memory
     (128 images of 288², ``data/device_augment.HBMDataset(raw=True)``),
     which the step crops, flips and normalises itself: 3 + 10 steps at
     batch 16 on the kernel path, float32 and bfloat16, exact launch counts,
     img/s beside ``[train]``'s, the augment's device time in one profiled
     step; a ``raw=False`` draw against ``apply_augment``; 3 tiny uint8
     steps on the card and on the CPU, losses alike;
  8. train-agree — one injected full-width step from the same weights, t and
     ε through the kernel path on the card and the plain path (the plain
     versions, optax-form Adam) on the CPU: losses and updates agree;
  8a. loader — the native C++ loader on the card's machine: the codec probe
     (png.h, jpeglib.h, zlib.h, the libraries, Pillow), the library built
     with g++ (a failed build fails the run, nothing falls back), its decode
     against utils/png on the 64 class PNGs and on 64 288² PNGs written with
     Paeth and Average rows, and decode img/s at batch 16 for
     NativeImageDataset with 2 and 8 workers and the Python ImageDataset
     with 2 threads, beside [train]'s float32 img/s;
  8b. train-cli — the user's ``cli.main(["train", ...])`` on 64 synthetic
     288² PNGs written by the port's writer and streamed from disk through
     the native loader (the dataset must be NativeImageDataset), with
     ``--fid-samples 16``: the default model, float32, batch 16, 2 epochs × 4
     steps on the kernel path, a checkpoint each epoch and one log_sample
     with its FID/KID; exact B1/B2/B4 launches, finite losses, img/s, every
     reference tag and fid/kid in the event file;
  8c. train-resume — the same from the uint8 pool (``--data-hbm 288``) with
     an EMA: 2 epochs in one call against ``--epochs 1`` then ``--epochs 2``
     on one checkpoint dir (exactly 4 steps restored): epoch-1 losses within
     1e-5 relative; ``cli sample --checkpoint-dir`` equals the restored EMA
     sampled in process (within one uint8 level); one checkpoint save timed;
  8d. cache — ``cli build-cache`` of the Paeth PNGs at store 288, then a
     Runner fed AugmentedCachedDataset for 4 steps at the default width,
     float32, batch 16: exact B1/B2/B4 launches, a finite loss, img/s;
  9. gan-kernel — B3 (instance norm) against its plain version at the seven
     distinct shapes of the cycle-GAN step at batch 16 (each with its plan's
     cluster size) and at a large mean (3·N(0, 1) + 100), float32 and
     bfloat16: forward, and dx, dγ, dβ of its autograd Function against
     autograd through the plain version, and the backward kernel against
     ``_in_bwd`` (bit-identical twice); kernel, plain version,
     F.instance_norm, the backward kernel (host included, and device time
     queued), ``_in_bwd`` and F.instance_norm's autograd backward timed
     beside the byte bounds. B4 with
     ``relu=False`` (every GAN down conv) at its four shapes at batch 16;
  10. gan — the user's entry point, ``cli.main(["profile", "--model", "gan",
     ...])``, at the default width (two default U-Net generators, two
     default discriminators, 256², batch 16 per class) with instance norms
     and B4, float32 and bfloat16, 2 + 3 steps: exact B3
     and B4 launch counts (derived from the config), B3's backward launches
     (194 a step: 102 norms, D's 10 in G's pass without dγ and dβ) and no
     torch-op backward, finite losses, the
     trace's top kernels, busy and idle; the step timed without the
     profiler; ``gan.transfer`` at batch 4;
  10a. cyclegan — the published CycleGAN (arXiv 1703.10593) at its widths
     and the benchmark cell's shapes: ResNet-9 generators (ngf 64), 70×70
     PatchGANs (ndf 64), least squares, an image pool of 50 a class,
     bfloat16 with B4, batch 16 a class: first B3 without
     γ, β against ``instance_norm_plain`` and ``_in_bwd`` at each of the
     step's six norm maps, float32 and bfloat16 (forward, the Function's dx,
     the backward kernel's dx), and B4 (relu=False) at the PatchGAN's C256
     input against the plain conv, the bfloat16 rows going to the kernels
     line; then exact B3 forward
     and backward launches a step (156 each: no norm has γ or β, so no dγ,
     dβ launch) and B4's (D's C256), ``InstanceNorm.graph_backwards`` 0,
     the ``resnet.trunk`` span's device ms a step (6 a step), the step's
     busy time and top kernels in a trace, the step timed without the
     profiler, and the card's peak memory. ``python3 chip_smoke.py
     --cyclegan`` runs this phase alone, after the build;
  11. gan-agree — one full-width float32 GAN step under sgd from the same
     state and batches through the kernels and through cuDNN with the
     plain instance norm and torch-op conv tails: losses and each net's
     update agree;
  12. gan-reference — a tiny GAN whose discriminators reach B4, 3 steps on
     the card and on the CPU: the losses agree;
  13. gan-train-cli — the user's ``cli.main(["gan-train", ...])`` on the two
     class folders of PNGs (circles, crosses) at the default width with
     instance norms and B4, float32, batch 16 per class, 4 steps, one
     checkpoint and one log_sample: exact B3/B4 launches, finite losses;
  14. eval — ``cli.main(["eval", ...])`` on [train-cli]'s checkpoint
     (--model diffusion: 16 samples at stride 50, exact B4 launches) and on
     [gan-train-cli]'s (--model gan, 16 held-out images a class: exact B3/B4
     launches): finite scores; the extractor's features on the card against
     the CPU; run_sampler_benchmark at batch 16, float32 and bfloat16;
  14a. inception — InceptionV3 pool3 (utils/inception.py) of the seeded
     synthetic state dict written as .npz and .pth (no real weights exist
     here; both load alike): 32 images of 256² on the card against the CPU
     port within 1e-4 of the scale, both variants; ms per image against the
     bound (FLOPs from ``profiler.compiled_stats``, fp32 at 67 TFLOP/s);
     ``cli eval --fid-extractor inception:<npz>`` on [train-cli]'s
     checkpoint at fid_samples 16: exact B4 launches, finite FID and KID;
  14b. fid-steps — ``utils/benchmark.steps_to_fixed_fid`` on a full-width
     GANRunner from the class PNGs with that extractor, target 0, 4 steps
     checked every 2: (None, a finite FID) at step 4, exact B3/B4 launches,
     its wall time;
  14c. profiler — ``profiler.compiled_stats`` of one full-width denoiser
     forward at batch 16 (fake tensors, no launch) against
     ``model_flops_per_image``·16; an ``annotate`` range in a trace;
  15. serve — ``serve/server.build_service`` on [train-cli]'s diffusion and
     [gan-train-cli]'s GAN checkpoints behind the threaded Server and the
     AsyncServer on the card: exact B3/B4 launches from HTTP requests
     (/sample num 1 and 3, /denoise, /edit, /transfer ab and ba), npy
     answers equal the in-process sampler, preview and transfer within 1
     uint8 level, the two frontends equal; 8 concurrent requests in ≤ 2
     device batches; a stream spanning /reload ends on the old weights;
     503s past serve_max_queue and serve_max_streams; then latency (p50, and
     p99 from 120 or 200 requests), sample img/s and peak memory by device batch, PNG vs npy encode,
     reload ms and the card's peak memory across each service's /reload, printed;
  16. cond-train-cli — the class-conditional model (3 classes, embedding
     width 8): ``cli train --classes a b c --num-classes 3`` on three class
     folders of PNGs (a third, triangles, written after [eval]) through the
     native loader, float32 on the kernel path, 2 epochs × 4 steps and one
     log_sample: exact B1/B2/B4 launches, epoch img/s beside [train-cli]'s,
     and ``cli bench --num-classes 3``'s step ms beside [train]'s;
     ``cli sample --class-idx 0/1/2`` from the same noise must differ by
     class; ``cli edit --class-idx 1``; one injected labeled step through
     the kernels and the plain path (loss within 1e-5 relative);
  17. cgan — ``cli profile --model cgan`` at the default width, 3 classes,
     batch 16, instance norms and B4, float32 and bfloat16, 2 + 3 steps:
     exact B3/B4 launches (half the cycle GAN's), busy, idle, top kernels;
     the step timed without the profiler;
  18. cgan-agree — one cGAN step with injected targets through the kernels,
     the plain path and float64, [gan-agree]'s bounds;
  19. cgan-train-cli — ``cli cgan-train`` on the three folders, 4 steps,
     --fid-samples 16 (transfer_to_<k>, six pairs' FID/KID), then ``cli eval
     --model cgan`` on its checkpoint: exact B3/B4 launches, finite scores;
  20. serve (classes) — the conditional diffusion and the cGAN checkpoints
     behind both frontends: /sample {"class": k} and /transfer?to=K within
     1 level of the in-process path with exact launches, frontends equal;
     a stream and /edit with a class; mixed classes and mixed targets
     coalesced behind a gate; direction= on the cGAN a 400; latency p50/p99
     at concurrency 1 and 8; the peak memory across each /reload;
  21. distill (run after [cgan-train-cli] and before [serve], which replaces
     [train-cli]'s train state with its served part) — ``cli distill`` on
     [train-cli]'s checkpoint (stride 50), one round of 4 steps to stride
     100 at batch 16: exact launches (B4 3 denoiser calls a step + the
     grids' 6, B1 and B2 none), finite losses,
     ``sample_stride`` 100 in the student's config.json, ``cli sample`` of
     the student (2 calls); one distill step timed beside [train]'s; one
     injected full-width step through the kernels on the card and the plain
     versions on the CPU (1e-5);
  21a. dp-distill (before [serve] too) — 2 processes of this script
     (``--dp-worker distill``) sharing cuda:0 over gloo, each a rank that
     runs ``cli distill --num-processes 2`` on [train-cli]'s checkpoint:
     exact B4 launches a rank, equal losses, rank 0 alone writing the
     student (sample_stride doubled) and the events; one injected two-rank
     step against one process ([dp-agree]'s bounds); the two-rank step and
     its gradient all-reduce timed beside [distill]'s step;
  22. bundle (also before [serve]) — ``cli export-model`` of [train-cli]'s,
     [gan-train-cli]'s and [cgan-train-cli]'s checkpoints on the card:
     export, save and load s and MB of each program; the graphs hold B4 and B3 as ``gct2::`` custom ops
     (no aten convolution where B4's gate admits one); one sample program at
     batch 1, 3 and 16; ``cli sample --bundle`` against ``--checkpoint-dir``
     (1 level); denoise, preview, invert and the transfers against the
     in-process path (1e-4 of the scale, 1 level) with exact launches; the
     card's bundle on the CPU (1e-4); sample ms/image at batch 4 through the
     bundle against in process; B4's host µs direct and through the op;
  22a. serve-mesh (before [serve]) — ``build_service`` with the host's
     devices stubbed to [cuda:0, cuda:0] (two in-process replicas, a
     LocalMesh) on the diffusion, GAN and cGAN checkpoints against one
     replica: /sample num 1, 3 and 5 (1 level), the stream, /denoise, the
     transfers (2e-4) of one image (run on the first replica alone) and
     two (one a replica), their launches exact;
     exact B3/B4 launches from HTTP on both frontends;
     /reload swaps both replicas; /sample p50/p99 at concurrency 1 and 8
     and the card memory of both services; a batch-norm GAN service over
     the two replicas: /transfer of 1 image padded to 2 rows (JAX's
     padding) and run whole, against the CPU service's (2e-4);
  22b. tp-kernel (before [serve], as every phase down to 22f) — B4
     on a rank's output channels under tensor parallelism: the four
     full-width down convs with O halved (the local shapes of
     ``mesh_model=2``) at batch 16, float32 and bfloat16, against the plain
     version ([train-kernel]'s bounds) and timed beside cuDNN on the same
     local shape and the bound; a local shape the gate refuses is named;
  22c. tp-agree, tp-gan, slice — one job of 2 processes of this script
     (``--dp-worker tp``) sharing cuda:0 over gloo as ``mesh_model=2``: one
     injected full-width float32 step (B4 on the kernel path) against one
     process (loss 1e-5 relative, updates at [dp-agree]'s bounds), half of
     every split kernel's bytes a rank, B4's launches as the local gate
     predicts, step, gather and all-reduce ms; one cycle-GAN step with B3,
     B4 and R1 at the default width, batch 8 a class: equal metrics on both
     ranks, g_loss and d_loss within [gan-agree]'s 1e-5 of one process,
     launches equal to one process's; ``mesh_slice=2`` against flat data
     parallelism (one injected step each, [dp-agree]'s bounds);
  22d. tp-train — ``cli train --mesh-model 2 --num-processes 2`` (2 ranks
     of ``--dp-worker cli``) from the uint8 pool, 4 steps, a save and one
     log_sample (the EMA gathered whole, the sampler data-parallel): exact
     launches, equal metrics; the checkpoint restored in this process
     equals the weights the ranks gathered, bit for bit, and ``cli sample``
     runs from it;
  22e. spatial-kernel — B1s on height blocks: the batch of 16 × 256² as
     the two blocks of a 2-way spatial grid (positions 0, 1) and the four
     of a 2 × 2 data × spatial grid (positions 0–3): bit for bit B1 with the
     folded seed, the positions' ε different, a block timed beside its
     byte bound (cold: the median of 24 launches over rotating inputs);
     B3 over height blocks at every norm layer's block of the default
     model on 2 shards at batch 16, float32 and bfloat16: the stats launch
     against the plain triples, the merge-and-apply launch against the
     plain merge and apply and against B3's plain version on the whole
     image (B3's bounds), device and back-to-back ms beside the byte bound,
     the stats launch beside torch.var_mean (float32), one norm layer's
     forward's device operations against the first design's;
  22f. spatial-agree — 2 processes (``--dp-worker spatial``) as 2 height
     shards: ``make_spatial_unet_apply`` against ``unet_apply`` at the
     default width (1e-4 of the scale); one injected full-width spatial
     step and one on the data × spatial layout (data 1 × spatial 2) at
     batch 16 against one process, step ms and halo calls; one injected step
     each with g_norm instance (B3 over height blocks, 2 launches a norm
     layer, a rank and a forward) and batch, per_step_output, the dct and
     mse_multiscale losses, dynamic loss scaling, a uint8 pool, remat,
     and remat with g_norm instance, each against one process with exact
     launches (the remat step's B3-block launches: the forward's and its
     recompute's, equal on both ranks), the remat steps' halo counts and
     each rank's peak memory beside the same step's without remat; 2
     generator-driven steps on the fused path: B1s once a step a rank;
  22g. pp-agree (before [serve], as 22h and 22i) — pipeline parallelism
     (parallel/pipeline.py) at the default width, batch 16, fp32, every
     stage on cuda:0, through the kernels: stages 2 × microbatches 2, 3 ×
     4, and 2 × 2 with 2 in-process replicas (PP × DP), each one step from
     the same weights and generator state as the one-process step (loss
     1e-5 relative, updates at [dp-agree]'s bounds), exact launches (B1 1, B4
     2·4·M·replicas, B2 one a stage), the step timed beside the one-process
     step, the 2 × 2 × 2 step with its replicas in threads too; 2 × 2 with
     2 replicas under batch norm (threads that sum each norm's statistics,
     SGD with momentum, its wait bounded) against the pipeline without
     replicas; one bfloat16 pipeline step with a finite loss;
  22h. pp-train — ``cli train --pipeline-stages 2 --pipeline-microbatches
     2`` from the uint8 pool, 4 steps with an EMA, one log_sample and a
     save: exact launches, a finite loss; ``cli sample`` restores the
     checkpoint in one process;
  22i. plan — ``cli plan --json`` on 1 and 4 cards, diffusion and gan; the
     planner's fp32 img/s at 256² batch 20 (no grid point) against ``cli
     bench`` there in this run, within 25%;
  23. serve-bundle — ``build_bundle_service`` on the three bundles
     behind both frontends: /sample, /denoise, /transfer ab, ba and ?to= within 1
     level of the bundle in process with exact launches, frontends equal;
     /edit, a stream and /reload refused (400); /sample npy p50/p99 at
     concurrency 1 and 8;
  24. dp-kernel — B1s (B1 on one rank's block, its seed folded by the
     rank's position): the batch of 16 split into two blocks of 8, each
     through positions 0 and 1: bit for bit B1 with the folded seed, within
     B1's bound of the plain version, the positions' ε different; one block
     timed beside its byte bound;
  25. dp-train — ``cli train --num-processes 1`` (the parallel code at world
     size 1: [train-cli]'s launches a step); then jobs of 2 processes of this
     script (``--dp-worker``), each ``cli.main`` with ``--coordinator
     --num-processes 2 --process-id k``, sharing cuda:0 over gloo: ``cli
     train`` at the default width, global batch 16, the kernel path from an
     HBM pool of each rank's PNG files, 2 epochs and one log_sample; the same
     as --epochs 1 then --epochs 2 (resumed, within 1e-5 of the unbroken
     epoch 1); ``cli gan-train`` and ``cli cgan-train``, 4 steps and one
     log_sample: exact launches a rank (B1s 1 a step, B2 0, B3/B4 as
     counted), equal metrics and weights on both ranks, checkpoints and
     events from rank 0 alone; two-rank img/s beside [train]'s;
  26. dp-agree (last) — 2 processes: one injected full-width step on 2
     ranks, replicated and under ZeRO-1, against the one-process step on
     the global batch ([train-agree]'s bounds); the optimizer bytes a rank
     holds; a GAN step with batch norms in G and D and R1 (statistics over
     both ranks' rows) against one process; an injected step of a
     batch-norm denoiser under remat (the recompute on autograd's device
     thread) against one process; the gradient all-reduce and ZeRO-1's
     all-gather timed. Every
     two-rank time is of 2 ranks sharing one card, not a multi-card number.

The last two lines of its output are a JSON line of per-kernel results and
``{"ok": true, "device": {...}}``; before them the card's name and power
limit. Without a card, or without the port beside it, it exits non-zero and
prints no result.
"""

import copy
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# H100 SXM: fp32 without tensor cores; bf16 and fp16 dense
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
SHAPES = ((128, 128, 256), (64, 256, 512), (32, 512, 512), (16, 512, 512))  # (H=W, C, O)
BATCH = 4
# kernel vs plain version, relative to max|y|: float32 differs by summation
# order over 16·C ≤ 8192 terms (~1e-6 seen); bfloat16 by one output rounding
# (2^-8 ≈ 4e-3 of the value) on top of that, float16 by one of 2^-11 ≈ 5e-4
KERNEL_RTOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 2.5e-3}
# B4's gradients (cuDNN's dgrad and wgrad around the kernel) vs autograd
# through the plain version, relative to the largest gradient: IEEE float32
# convs in other summation orders; in bfloat16 the plain gradient is float32
# rounded once, cuDNN's bf16 dgrad rounds partial sums over 4·O terms too
GRAD_RTOL = {"float32": 1e-5, "bfloat16": 4e-2}
# card vs CPU images, in uint8 levels (1 level = 2/255 of the [-1, 1)
# range): float32 paths agree to ~1e-5, so only a rounding flip at a level
# boundary; in bfloat16 the CPU's plain versions round the convs' tails
# after each op where the epilogue rounds once (~4e-3 relative a layer),
# and 4 denoiser calls carry that to the image
IMAGE_LEVELS = {"float32": 1, "bfloat16": 6}
TRAIN_BATCH = 16
BENCH_STEPS, BENCH_WARMUP = 10, 3  # run_benchmark's warmup default
KERNEL_PATH = ["--optimizer", "adam_fused", "--fused-diffusion", "true"]
PLAIN_PATH = ["--optimizer", "adam_tf", "--fused-diffusion", "false"]
# B1 kernel vs plain: the same Philox words; ε may differ by the rounding of
# log and cos (|ε| < 6, a few float32 ulps); on an H100 they agree bit for bit
DIFFUSE_ATOL = 4e-6
# B1's operations per element, for its bound: Philox4x32-10 is, per half
# block (one element), 5 rounds of two 32×32→64 products (one IMAD.WIDE each)
# and two 3-input XORs (LOP3), with the key schedule shared by a thread's
# blocks; the SASS of csrc/diffuse.cu holds 181 more integer instructions than
# its probe without the rounds for a thread's 8 elements (tools/
# kernel_plan_sweep.py b1): 23 an element. Box–Muller (2 conversions, 6
# mul/add), the IEEE logf, sqrtf and cosf fast paths (~16, ~7, ~16) and the 3
# of x·ss + ε·sn: about 48 float instructions, what this build runs (fewer
# would only lower the term). An H100 SM quarter dispatches one warp
# instruction a clock and its INT32 pipe takes one every two: the least time
# is the larger of the integer instructions at INT32_RATE and all of them at
# DISPATCH_RATE (132 SMs × 64 or 128 lanes × 1.98 GHz; DISPATCH_RATE is the
# instruction rate of the 67 TFLOP/s of FMA). At 71 instructions that is
# ~89% of the byte term, so the bytes set the bound.
DIFFUSE_INT_PER_ELEMENT = 23
DIFFUSE_FLOAT_PER_ELEMENT = 48
INT32_RATE = 132 * 64 * 1.98e9
DISPATCH_RATE = 132 * 128 * 1.98e9
HBM_POOL = (128, 288, 288)  # [train-hbm]: uint8 images (N, H, W) in device memory, 31.9 MB
ADAM_FLOPS_PER_ELEMENT = 12  # 2 mul + add (m), 3 mul + add (v), sqrt, add, mul, div, sub
GAN_FLAGS = ["--g-norm", "instance", "--d-norm", "instance"]
CLI_FILES = (32, 288)  # [train-cli]: PNGs per class (circles, crosses) and their side
CLI_STEPS = 4  # steps an epoch in [train-cli], [train-resume] and [gan-train-cli]
EVAL_SAMPLES = 16  # fid_samples of [train-cli] and [eval]: held-out files and samples
PAETH_FILES = (64, 288)  # [loader]/[cache]: PNGs written with Paeth and Average rows
# the reference's TensorBoard tags (train.py:356-361, 489-496) and the epoch scalars
REF_TAGS = ("denoised/image", "example loss", "step_1/image/0", "step_0.25/image/0",
            "step_0.5/image/0", "step_0.75/image/0", "fake/image/0", "loss", "images_per_sec")
GAN_WARM, GAN_PROFILE_STEPS, GAN_TIMED_STEPS = 2, 3, 5  # cli profile's two warm steps
# B3 vs plain, relative to max|y|: float32 differs by the order of the
# statistics' sums (Welford/Chan against two passes, ~1e-7 of a value);
# bfloat16 by one output rounding (2^-8 ≈ 4e-3 of the value)
IN_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}
# B3's Function (backward in torch ops) vs autograd through the plain
# version, relative to the largest gradient: float32 reductions in other
# orders; in bfloat16 the plain version's dγ and dβ pass through γ and β
# rounded to bf16, and dx is rounded to bf16 on both sides
IN_GRAD_RTOL = {"float32": 1e-5, "bfloat16": 4e-2}
# B3's backward kernel vs its plain version ``_in_bwd`` on the same inputs,
# relative to the largest value: dx 1e-5 in float32 (shifted one-pass sums
# against two-pass statistics), 1e-2 in bfloat16 (each side rounds its float32
# dx once); dγ and dβ are float32 sums of the same inputs in other orders
IN_BWD_RTOL = {"float32": {"dx": 1e-5, "dgamma": 1e-5, "dbeta": 1e-5},
               "bfloat16": {"dx": 1e-2, "dgamma": 1e-5, "dbeta": 1e-5}}


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, reps=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, match, reps=20):
    """Device time of one call of fn, over its CUDA kernels whose name
    contains ``match`` (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages() if match in e.key) / reps / 1e3


L2_BYTES = 50 * 2**20  # H100 SXM: 50 MB of L2


def queued_ms(fn, reps=10):
    """Device ms of one ``fn()`` back to back: ``reps`` calls enqueued behind
    a wait kernel of ~10 ms and timed between two CUDA events, so the
    host's launch time is hidden (the device's gaps between kernels are
    not)."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_times(run, match, expected):
    """The device ms of each kernel whose name holds ``match`` that ``run()``
    launches, in launch order, from one torch.profiler session; a second
    session when the first did not see ``expected`` of them; None when
    neither did (the profiler dropped device events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        events = sorted((e.time_range.start, e.time_range.elapsed_us() / 1e3)
                        for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA and match in e.name)
        if len(events) == expected:
            return [ms for _, ms in events]
    return None


def cold_device_ms(make_inputs, call, match, reps=24):
    """Device time of single launches of ``call(*inputs)`` with L2 cold: the
    inputs rotate over copies (``make_inputs(i)``) that together hold more
    than twice the L2, so a launch's inputs were last touched over 100 MB
    before; each launch's kernel time (those whose name holds ``match``)
    read from torch.profiler's events, or, when the profiler drops them,
    from CUDA events around each launch (then an upper bound: the launch's
    own latency included). Returns ``(median, min, max)`` ms over ``reps``
    launches."""
    import torch

    sets = [make_inputs(0)]
    per = sum(t.numel() * t.element_size() for t in sets[0])
    sets += [make_inputs(i) for i in range(1, 2 * L2_BYTES // per + 2)]
    for args in sets:
        call(*args)

    def run():
        for k in range(reps):
            call(*sets[k % len(sets)])

    times = kernel_times(run, match, reps)
    if times is None:
        print(f"cold timing of {match!r}: the profiler dropped device events; CUDA events "
              "around each launch instead", flush=True)
        times = []
        for k in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            call(*sets[k % len(sets)])
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
    del sets
    return float(np.median(times)), min(times), max(times)


def host_ms(fn, reps=50):
    """Host time of one call of fn: back-to-back calls timed before the
    final synchronise, so the launch queue absorbs the device time."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / reps * 1e3


def phase_build():
    from gan_class_transfer2_tpu_torch.ops import _build

    t0 = time.perf_counter()
    reports = _build.build_all()
    secs = time.perf_counter() - t0
    print(f"[build] {len(reports)} source(s) compiled in {secs:.2f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def phase_kernels(torch, F, fdc):
    """Kernel vs plain version at the four full-width shapes, at batch 4
    (the sampler) and 16 (training and the GAN): error, the plan's split of
    K, bit-identical repeats, and times beside the bound and cuDNN. Returns
    one summary per dtype (sums over the shapes of one denoiser call at
    batch 4)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = {}
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16),
                              ("float16", torch.float16)):
        for batch in (BATCH, TRAIN_BATCH):
            s = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, flops_ms=0.0,
                     bytes_ms=0.0, max_abs_err=0.0)
            for (hw, c, o) in SHAPES:
                # weight and bias already in x's dtype, as the models pass them
                # (and as the cuDNN call below gets them)
                x = torch.randn((batch, hw, hw, c), generator=gen, device="cuda").to(dtype)
                k = (torch.randn((4, 4, c, o), generator=gen, device="cuda")
                     / (16 * c) ** 0.5).to(dtype)
                b = (torch.randn((o,), generator=gen, device="cuda") * 0.1).to(dtype)
                plan = fdc.plan(batch, hw, hw, c, o, dtype)
                with torch.inference_mode():
                    before = fdc.down_conv_fused.launches
                    y = fdc.down_conv_fused(x, k, b)
                    again = fdc.down_conv_fused(x, k, b)
                    ref = fdc.down_conv_plain(x, k, b)
                    torch.cuda.synchronize()
                    fdc.down_conv_fused.launches = before  # comparison launches do not count
                    if not torch.equal(y, again):
                        fail(f"kernel {dtype_name} {x.shape}->{o}: two launches on the same "
                             f"inputs differ")
                    err = (y.float() - ref.float()).abs().max().item()
                    scale = ref.float().abs().max().item()
                    if not err <= KERNEL_RTOL[dtype_name] * scale:
                        fail(f"kernel {dtype_name} {x.shape}->{o}: max|err| {err} > "
                             f"{KERNEL_RTOL[dtype_name]} x max|y| {scale}")
                    # one library call computing the same function: cuDNN on the
                    # same NHWC memory (a channels_last NCHW view), bias folded in
                    x_lib = x.permute(0, 3, 1, 2)
                    w_lib = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                    b_lib = b
                    ms = cuda_ms(lambda: fdc.down_conv_fused(x, k, b))
                    plain_ms = cuda_ms(lambda: fdc.down_conv_plain(x, k, b))
                    lib_ms = cuda_ms(lambda: torch.relu_(
                        F.conv2d(x_lib, w_lib, b_lib, stride=2, padding=1)))
                    fdc.down_conv_fused.launches = before
                h2 = hw // 2
                flops = 2 * batch * h2 * h2 * o * 16 * c
                nbytes = x.element_size() * (x.numel() + k.numel() + b.numel() + y.numel())
                flops_ms = flops / PEAK_FLOPS[dtype_name] * 1e3
                bytes_ms = nbytes / PEAK_BYTES * 1e3
                bound = max(flops_ms, bytes_ms)
                print(f"[kernel] {dtype_name} x{tuple(x.shape)} -> {o}: max|err| {err:.3e} "
                      f"(max|y| {scale:.3f}), repeat bit-identical; plan {plan.blocks} blocks "
                      f"({plan.tiles_m}x{plan.tiles_n} tiles, split {plan.split}); kernel "
                      f"{ms:.4f} ms, plain {plain_ms:.4f} ms, cuDNN {lib_ms:.4f} ms, bound "
                      f"{bound:.4f} ms ({'operations' if flops_ms >= bytes_ms else 'bytes'}); "
                      f"{flops / ms / 1e9:.1f} TFLOP/s = {bound / ms:.1%} of bound")
                s["ms"] += ms
                s["plain_ms"] += plain_ms
                s["library_ms"] += lib_ms
                s["bound_ms"] += bound
                s["flops_ms"] += flops_ms
                s["bytes_ms"] += bytes_ms
                s["max_abs_err"] = max(s["max_abs_err"], err)
                del x, y, again, ref, x_lib, w_lib
            print(f"[kernel] {dtype_name} batch {batch}, four shapes: kernel {s['ms']:.4f} ms, "
                  f"plain {s['plain_ms']:.4f} ms, cuDNN {s['library_ms']:.4f} ms, bound "
                  f"{s['bound_ms']:.4f} ms = {s['bound_ms'] / s['ms']:.1%} of bound")
            if batch == BATCH:
                summary[dtype_name] = s
            else:
                summary[dtype_name]["max_abs_err"] = max(summary[dtype_name]["max_abs_err"],
                                                         s["max_abs_err"])
        torch.cuda.empty_cache()
    return summary


def phase_sample(fdc, cli, sampler, png, weights_npz, tmp):
    """The slice through the CLI, per dtype: on the card (counted) and on
    the CPU, same weights and init batch. Returns per-dtype launches."""
    from gan_class_transfer2_tpu_torch.config import Config

    cfg = Config(sample_stride=50).validate()
    calls = len(sampler.sample_timesteps(cfg))
    out = {}
    for dtype in ("float32", "bfloat16"):
        images = {}
        for dev in ("cuda", "cpu"):
            dest = os.path.join(tmp, f"{dtype}-{dev}")
            fdc.down_conv_fused.launches = 0
            rc = cli.main(["sample", "--device", dev, "--compute-dtype", dtype, "--num",
                           str(BATCH), "--sample-stride", "50", "--weights", weights_npz,
                           "--out", dest])
            launches = fdc.down_conv_fused.launches
            if rc != 0:
                fail(f"cli sample {dtype} on {dev} returned {rc}")
            want = 4 * calls if dev == "cuda" else 0
            if launches != want:
                fail(f"{dtype} on {dev}: {launches} kernel launches, expected {want} "
                     f"(4 per denoiser call x {calls} calls on the card)")
            if dev == "cuda":
                out[dtype] = {"launches": launches}
            imgs = [png.read_png(os.path.join(dest, f"sample_{i}.png")) for i in range(BATCH)]
            if any(im.shape != (cfg.size, cfg.size, 3) for im in imgs):
                fail(f"{dtype} on {dev}: PNG shapes {[im.shape for im in imgs]}")
            images[dev] = np.stack(imgs).astype(np.int64)
        levels = int(np.abs(images["cuda"] - images["cpu"]).max())
        print(f"[sample] {dtype}: {out[dtype]['launches']} launches over {calls} denoiser "
              f"calls; card vs CPU PNGs differ by at most {levels} uint8 levels "
              f"(tolerance {IMAGE_LEVELS[dtype]})")
        if levels > IMAGE_LEVELS[dtype]:
            fail(f"{dtype}: card and CPU images differ by {levels} levels")
        out[dtype]["png_levels"] = levels
    return out, cfg


def phase_timing(torch, fdc, sampler, weights, weights_npz, cfg):
    """Steady-state ms per image of the sampler (model loaded, batch on the
    card), the median of three runs."""
    from gan_class_transfer2_tpu_torch.models import unet

    model = weights.import_flat_weights(unet.Denoiser(cfg), weights.load_flat_npz(weights_npz))
    model = model.to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    init = torch.randn((BATCH, cfg.size, cfg.size, 3), generator=gen, device="cuda")
    for dtype in ("float32", "bfloat16"):
        c = cfg.replace(compute_dtype=dtype)
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            final = sampler.sample(c, model, init, snapshots=False).images
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3 / BATCH)
        if not torch.isfinite(final).all():
            fail(f"{dtype}: non-finite sample")
        print(f"[timing] {dtype}: ms per image (median of 3, stride 50, batch {BATCH}) "
              f"{sorted(runs)[1]:.3f}; runs {runs}")
    phase_profile(torch, sampler, model, cfg, init)
    fdc.down_conv_fused.launches = 0
    return model


def phase_profile(torch, sampler, model, cfg, init):
    """Where a sample's device time goes: torch.profiler over one sample
    call per dtype, CUDA kernels only, the top six by self time. The
    profiler's own overhead inflates the wall time it sees."""
    from torch.profiler import ProfilerActivity, profile

    from gan_class_transfer2_tpu_torch.utils import profiler

    for dtype in ("float32", "bfloat16"):
        c = cfg.replace(compute_dtype=dtype)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sampler.sample(c, model, init, snapshots=False)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        busy = profiler.device_busy_ms(prof)
        print(f"[profile] {dtype}: one sample call (batch {BATCH}, "
              f"{len(sampler.sample_timesteps(c))} denoiser calls): kernels busy "
              f"{busy:.3f} ms of {wall:.3f} ms wall under the profiler")
        for r in profiler.device_ops(prof, top=6):
            print(f"[profile]   {r['ms']:8.3f} ms x{r['calls']:<4d} {r['op'][:100]}")


def phase_edit(torch, fdc, sampler, model, c):
    ramp = torch.linspace(-1, 1, c.size, device="cuda")
    image = torch.stack([ramp[None, :].expand(c.size, c.size),
                         ramp[:, None].expand(c.size, c.size),
                         (ramp[None, :] * ramp[:, None])], -1)[None]
    fdc.down_conv_fused.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sampler.edit_image(c, model, image)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = fdc.down_conv_fused.launches
    calls = c.steps + len(sampler.sample_timesteps(c))  # invert, then decode
    if launches != 4 * calls:
        fail(f"edit: {launches} launches, expected {4 * calls}")
    if set(out) != {"reconstruction", "pixelate", "shift", "quantise"}:
        fail(f"edit: outputs {sorted(out)}")
    for name, v in out.items():
        if v.shape != image.shape or not torch.isfinite(v).all():
            fail(f"edit: {name} has shape {tuple(v.shape)} or non-finite values")
    print(f"[edit] invert ({c.steps} calls) + decode of 4 candidates "
          f"({len(sampler.sample_timesteps(c))} calls) in {secs:.3f} s, {launches} launches")
    return launches


def phase_reference(torch, api, sampler):
    """Tiny config: the card's sample equals the CPU path's (atol 1e-4, the
    sampler tests' bound against the JAX package)."""
    from gan_class_transfer2_tpu_torch.config import tiny_test_config

    cfg = tiny_test_config()
    model = api.init_denoiser(cfg, device="cpu")
    init = torch.randn((2, cfg.size, cfg.size, 3), generator=torch.Generator().manual_seed(2))
    cpu = sampler.sample(cfg, model, init).images
    gpu = sampler.sample(cfg, model.to("cuda"), init.to("cuda")).images.cpu()
    worst = (cpu - gpu).abs().max().item()
    print(f"[reference] tiny config, card vs CPU: max|diff| {worst:.3e}")
    if not worst <= 1e-4:
        fail(f"tiny sample on the card differs from the CPU path by {worst}")

    # 3 train steps, B1 and B2 on: the CPU takes their plain versions, the
    # card their kernels; both draw t and the B1 seed from one CPU generator
    # stream, so both see the same noise. Losses within 1e-4 relative: IEEE
    # float32 convs in other summation orders, ε within DIFFUSE_ATOL.
    from gan_class_transfer2_tpu_torch.ops import adam_kernel, fused_diffusion
    from gan_class_transfer2_tpu_torch.train import trainer

    cfg = tiny_test_config(fused_diffusion=True, optimizer="adam_fused", lr_schedule="constant",
                           learning_rate=1e-3)
    x = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (2, cfg.size, cfg.size, 3))
                         .astype(np.float32))
    losses = {}
    for dev in ("cpu", "cuda"):
        state = trainer.init_state(cfg, torch.Generator().manual_seed(0), device=dev)
        step, gen = trainer.make_train_step(cfg), torch.Generator().manual_seed(5)
        b1, b2 = fused_diffusion.diffuse_fused.launches, adam_kernel.adam_fused.launches
        losses[dev] = []
        for _ in range(3):
            state, loss = step(state, x.to(dev), gen)
            losses[dev].append(float(loss))
        launched = (fused_diffusion.diffuse_fused.launches - b1,
                    adam_kernel.adam_fused.launches - b2)
        fused_diffusion.diffuse_fused.launches, adam_kernel.adam_fused.launches = b1, b2
        if launched != ((0, 0) if dev == "cpu" else (3, 3)):
            fail(f"reference train on {dev}: B1/B2 launches {launched}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    print(f"[reference] tiny train, B1+B2 on, 3 steps: losses card {losses['cuda']} "
          f"CPU {losses['cpu']}; max relative diff {rel:.3e} (bound 1e-4)")
    if not rel <= 1e-4:
        fail(f"tiny training on the card differs from the CPU by {rel} relative")


def b4_per_call(fdc, cfg, batch, model=1):
    """Down convs of one denoiser call that the B4 gate admits (4 at the
    default width: 128²→…→16² inputs with C ≥ 128; the stem has C = 3, or
    3 + class_embed_dim in the class-conditional model). Under
    ``mesh_model=model`` the gate sees each rank's local kernel, its
    output channels cut by the TP rule."""
    stem = 3 + (cfg.class_embed_dim if cfg.num_classes > 0 else 0)
    n, c = 0, cfg.pixel_size if cfg.block_depth else stem
    for i in range(cfg.octaves):
        f, hw = cfg.octave_filters(i), cfg.size >> i
        local = f // model if f % model == 0 and f >= 2 * model else f
        n += fdc.supported((batch, hw, hw, c), (4, 4, c, local))
        c = f
    return n


def _bytes_ms(nbytes):
    return nbytes / PEAK_BYTES * 1e3


def _row(name, source, replaces, launches, err, ms, plain_ms, flops, nbytes, library_ms):
    flops_ms = flops / PEAK_FLOPS["float32"] * 1e3
    bytes_ms = _bytes_ms(nbytes)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(flops_ms, bytes_ms),
            "bound_by": "operations" if flops_ms >= bytes_ms else "bytes",
            "library_ms": library_ms}


def phase_train_kernels(torch, F, fdc, fd, adam_kernel, api, cfg):
    """B1 and B2 against their plain versions at the training slice's
    shapes, timed; B4's forward and gradients against the plain version at
    batch 16, its backward timed. Returns ({name: row without launches},
    {dtype: B4's forward max|err| at batch 16})."""
    rows = {}
    gen = torch.Generator(device="cuda").manual_seed(7)
    # ---- B1: batch 16 × 256²×3 float32, its scales gathered from the table
    n = cfg.size * cfg.size * 3
    x = torch.rand((TRAIN_BATCH, n), generator=gen, device="cuda") * 2 - 1
    t = torch.randint(1, cfg.steps + 1, (TRAIN_BATCH,), generator=gen, device="cuda",
                      dtype=torch.int32)
    table = fd.scale_table(cfg.steps, cfg.schedule, "cuda")
    seed = torch.randint(0, 2**62, (1,), generator=gen, device="cuda")
    before = fd.diffuse_fused.launches
    y = fd.diffuse_fused(x, t, table, seed)
    ref = fd.diffuse_plain(x, t, table, seed)
    torch.cuda.synchronize()
    err = (y - ref).abs().max().item()
    if not err <= DIFFUSE_ATOL:
        fail(f"diffuse kernel vs plain: max|err| {err} > {DIFFUSE_ATOL}")
    if not torch.equal(fd.diffuse_fused(x, t, table, seed), y):
        fail("diffuse kernel: two launches on the same inputs differ")
    ss = table[t.long(), 0]
    only_ss = torch.stack([table[:, 0], torch.zeros_like(table[:, 0])], 1)
    if not torch.equal(fd.diffuse_fused(x, t, only_ss, seed), x * ss[:, None]):
        fail("diffuse kernel with sn = 0 is not x·ss")
    noise = torch.tensor([[0.0, 1.0]], device="cuda")
    eps = fd.diffuse_fused(x, torch.zeros_like(t), noise, seed)
    mean, std = eps.double().mean().item(), eps.double().std().item()
    if not (abs(mean) < 5 / eps.numel() ** 0.5 and abs(std - 1) < 5 / (2 * eps.numel()) ** 0.5):
        fail(f"diffuse kernel noise has mean {mean}, std {std}")
    call = lambda: fd.diffuse_fused(x, t, table, seed)  # noqa: E731
    ms = cuda_ms(call, reps=50)
    dev_ms = device_ms(call, "diffuse")
    # the bytes the kernel moves: x read and y written, t and the (T + 1, 2)
    # table read
    nbytes = 8 * x.numel() + 4 * t.numel() + 4 * table.numel()
    cold_ms, cold_lo, cold_hi = cold_device_ms(
        lambda i: (torch.rand_like(x),), lambda xi: fd.diffuse_fused(xi, t, table, seed),
        "diffuse")
    wrapper_ms = host_ms(call)
    plain_ms = cuda_ms(lambda: fd.diffuse_plain(x, t, table, seed), reps=5)
    fd.diffuse_fused.launches = before
    elems = x.numel()
    bytes_ms = _bytes_ms(nbytes)
    ops = DIFFUSE_INT_PER_ELEMENT * elems, DIFFUSE_FLOAT_PER_ELEMENT * elems
    ops_ms = max(ops[0] / INT32_RATE, (ops[0] + ops[1]) / DISPATCH_RATE) * 1e3
    bound = max(bytes_ms, ops_ms)
    rows["diffuse_f32"] = {
        "name": "diffuse_f32", "route": "cuda",
        "source": "gan_class_transfer2_tpu_torch/csrc/diffuse.cu",
        "replaces": "gan_class_transfer2_tpu/ops/kernels.py:44", "launches": 0,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "library_ms": None,
        "device_ms": dev_ms, "device_cold_ms": cold_ms, "host_ms": wrapper_ms}
    if not cold_ms >= bytes_ms:
        fail(f"B1: a cold device time of {cold_ms} ms is below the byte bound {bytes_ms} ms: "
             "the reading is impossible, not fast")
    print(f"[train-kernel] B1 diffuse x{tuple(x.shape)}: max|err| {err:.3e} (bound "
          f"{DIFFUSE_ATOL}), repeat bit-identical; noise mean {mean:.2e} std {std:.5f}; kernel "
          f"{ms:.4f} ms back to back (host-included), device {dev_ms:.4f} ms L2 warm, "
          f"{cold_ms:.4f} ms cold (median of 24 launches over rotating inputs, "
          f"{cold_lo:.4f}–{cold_hi:.4f}), the wrapper's host {wrapper_ms:.4f} ms a call; plain "
          f"{plain_ms:.4f} ms; bound {bound:.4f} ms ({rows['diffuse_f32']['bound_by']}: bytes "
          f"{bytes_ms:.4f}, operations {ops_ms:.4f}) = {bound / cold_ms:.1%} of the cold device "
          f"time; no one-call library yardstick")
    del x, y, ref, eps

    # ---- B2: every leaf of the default model, float32 and bfloat16 moments
    model = api.init_denoiser(cfg, device="cuda")
    params = [p.detach() for p in model.parameters()]
    n_params = sum(p.numel() for p in params)
    grads = [torch.randn(p.shape, generator=gen, device="cuda") * 1e-3 for p in params]
    step = torch.tensor([1e-4], device="cuda")
    b1, b2, eps = 0.9, 0.999, cfg.adam_eps
    for mdt, name in ((torch.float32, "adam_f32m"), (torch.bfloat16, "adam_bf16m")):
        m = [(g * 3).to(mdt) for g in grads]
        v = [(g * g).to(mdt) for g in grads]
        p2 = [p.clone() for p in params]
        ref = [[t.clone() for t in ts] for ts in (p2, m, v)]
        before = adam_kernel.adam_fused.launches
        adam_kernel.adam_fused(p2, m, v, grads, step, eps)
        adam_kernel.adam_plain(*ref, grads, step, eps)
        torch.cuda.synchronize()
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(p2 + m + v, ref[0] + ref[1] + ref[2]))
        if err != 0:
            fail(f"{name}: kernel and plain version differ by {err} (they must agree bit for bit)")
        ms = cuda_ms(lambda: adam_kernel.adam_fused(p2, m, v, grads, step, eps))
        plain_ms = cuda_ms(lambda: adam_kernel.adam_plain(p2, m, v, grads, step, eps), reps=3)
        adam_kernel.adam_fused.launches = before
        lib_ms = None
        if mdt == torch.float32:
            # the same update from torch.optim.Adam: eps rescaled by √(1−β₂ᵗ) at t = 1
            lib_params = [torch.nn.Parameter(p.clone()) for p in params]
            for lp, g in zip(lib_params, grads):
                lp.grad = g
            opt = torch.optim.Adam(lib_params, lr=1e-4, betas=(b1, b2),
                                   eps=eps / (1 - b2) ** 0.5, fused=True)
            lib_ms = cuda_ms(opt.step)
            del lib_params, opt
        nbytes = n_params * (3 * 4 + 4 * m[0].element_size())  # g, p, m, v in; p, m, v out
        rows[name] = _row(name, "gan_class_transfer2_tpu_torch/csrc/adam.cu",
                          "gan_class_transfer2_tpu/ops/adam_kernel.py:38", 0, err, ms, plain_ms,
                          ADAM_FLOPS_PER_ELEMENT * n_params, nbytes, lib_ms)
        print(f"[train-kernel] B2 {name}: {len(params)} leaves, {n_params} params, "
              f"{adam_kernel.launches_per_step(len(params))} launch(es); bit-exact vs plain; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {rows[name]['bound_ms']:.4f} ms "
              f"({rows[name]['bound_by']}, {nbytes / 1e9:.3f} GB), torch.optim.Adam(fused) "
              f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms")
        del m, v, p2, ref
    del model, params, grads

    # ---- B4 forward and backward (cuDNN's dgrad and wgrad around the
    # kernel) at batch 16, the training path's shapes
    b4_err = {}
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        b4_err[dtype_name], worst, flips, tot = b4_batch16(torch, fdc, gen, dtype_name, dtype,
                                                           relu=True)
        print(f"[train-kernel] B4 {dtype_name}, batch {TRAIN_BATCH}, four shapes: max error "
              f"relative to the largest value: y {worst['y']:.2e} (bound "
              f"{KERNEL_RTOL[dtype_name]}), dx {worst['dx']:.2e}, dK {worst['dK']:.2e}, db "
              f"{worst['db']:.2e} (bound {GRAD_RTOL[dtype_name]}); {flips} ReLU mask flip(s); "
              f"backward: cuDNN dx+dK+db {tot['ms']:.4f} ms, plain autograd "
              f"{tot['plain_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms (operations)")
    return rows, b4_err


def b4_batch16(torch, fdc, gen, dtype_name, dtype, relu, timed=True, shapes=SHAPES):
    """B4 at ``shapes`` (by default the four down-conv shapes) at batch 16:
    its forward against the plain version (KERNEL_RTOL of max|y|) and dx, dK, db (cuDNN around the
    kernel) against the plain version's autograd (GRAD_RTOL of the largest
    gradient); with ``timed``, the backward timed against the plain one.
    Returns (max|err| of y, worst relative errors, ReLU mask flips, times)."""
    from gan_class_transfer2_tpu_torch.models import unet

    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    worst = {"y": 0.0, "dx": 0.0, "dK": 0.0, "db": 0.0}
    flips, max_err = 0, 0.0
    with unet.ieee_fp32(torch.float32, torch.device("cuda")):
        for (hw, c, o) in shapes:
            xs = torch.randn((TRAIN_BATCH, hw, hw, c), generator=gen, device="cuda").to(dtype)
            k = (torch.randn((4, 4, c, o), generator=gen, device="cuda") / (16 * c) ** 0.5)
            b = torch.randn((o,), generator=gen, device="cuda") * 0.1
            xs.requires_grad_()
            k, b = k.to(dtype).requires_grad_(), b.to(dtype).requires_grad_()
            g = torch.randn((TRAIN_BATCH, hw // 2, hw // 2, o), generator=gen,
                            device="cuda").to(dtype)
            before = fdc.down_conv_fused.launches
            y = fdc.down_conv_fused(xs, k, b, relu)
            yp = fdc.down_conv_plain(xs, k, b, relu)
            err = (y.float() - yp.float()).abs().max().item()
            scale = yp.float().abs().max().item()
            if not err <= KERNEL_RTOL[dtype_name] * scale:
                fail(f"B4 (relu={relu}) forward {dtype_name} x{tuple(xs.shape)}->{o}: max|err| "
                     f"{err} > {KERNEL_RTOL[dtype_name]} x max|y| {scale}")
            if not relu and not (y < 0).any():
                fail(f"B4 (relu=False) {dtype_name} x{tuple(xs.shape)}: no negative output")
            max_err = max(max_err, err)
            worst["y"] = max(worst["y"], err / scale)
            # an output whose pre-activation lies within rounding of 0
            # may pass one ReLU and not the other; g is 0 there for both
            same = (y > 0) == (yp > 0) if relu else torch.ones_like(y, dtype=torch.bool)
            flips += int((~same).sum().item())
            gm = torch.where(same, g, torch.zeros_like(g))
            got = torch.autograd.grad(y, (xs, k, b), gm, retain_graph=True)
            want = torch.autograd.grad(yp, (xs, k, b), gm, retain_graph=True)
            for gname, a, w in zip(("dx", "dK", "db"), got, want):
                gerr = (a.float() - w.float()).abs().max().item()
                gscale = w.float().abs().max().item()
                if not gerr <= GRAD_RTOL[dtype_name] * gscale:
                    fail(f"B4 (relu={relu}) {gname} {dtype_name} x{tuple(xs.shape)}->{o}: "
                         f"max|err| {gerr} > {GRAD_RTOL[dtype_name]} x max|{gname}| {gscale}")
                worst[gname] = max(worst[gname], gerr / gscale)
            if timed:
                tot["ms"] += cuda_ms(lambda: torch.autograd.grad(y, (xs, k, b), g,
                                                                 retain_graph=True))
                tot["plain_ms"] += cuda_ms(lambda: torch.autograd.grad(yp, (xs, k, b), g,
                                                                       retain_graph=True))
                flops = 2 * 2 * TRAIN_BATCH * (hw // 2) ** 2 * o * 16 * c  # dx and dK
                nbytes = xs.element_size() * (2 * xs.numel() + 2 * k.numel() + y.numel())
                tot["bound_ms"] += max(flops / PEAK_FLOPS[dtype_name] * 1e3, _bytes_ms(nbytes))
            fdc.down_conv_fused.launches = before  # comparison launches do not count
            del xs, k, b, g, gm, y, yp, got, want
    return max_err, worst, flips, tot


def _cli_json(cli, args):
    """One CLI run with its standard output captured; returns the JSON
    lines it printed. Fails the smoke on a non-zero return or no output."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    if rc != 0 or not lines:
        fail(f"cli {' '.join(args)} returned {rc}")
    return lines


def phase_train(torch, cli, fdc, fd, adam_kernel, trainer, cfg):
    """The training slice through ``cli bench`` at the default width, per
    dtype × path; exact launch counts; a profile of one step of each.
    Returns the kernel path's launches by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    from gan_class_transfer2_tpu_torch.models import unet
    from gan_class_transfer2_tpu_torch.utils import profiler

    n_leaves = len(list(unet.Denoiser(cfg).parameters()))
    steps = BENCH_STEPS + BENCH_WARMUP
    launches = {"diffuse_f32": 0, "adam_f32m": 0, "adam_bf16m": 0,
                "down_conv_k4s2_f32": 0, "down_conv_k4s2_bf16": 0}
    results = {}
    for dtype in ("float32", "bfloat16"):
        moments = "bfloat16" if dtype == "bfloat16" else "float32"
        for path, flags in (("kernels", KERNEL_PATH), ("plain", PLAIN_PATH)):
            width = [f"--{k.replace('_', '-')}={getattr(cfg, k)}"
                     for k in ("size", "pixel_size", "max_size", "octaves", "steps")]
            args = ["bench", "--device", "cuda", *width, "--batch-size", str(TRAIN_BATCH),
                    "--bench-steps", str(BENCH_STEPS), "--compute-dtype", dtype,
                    "--moment-dtype", moments, *flags]
            fdc.down_conv_fused.launches = fd.diffuse_fused.launches = 0
            adam_kernel.adam_fused.launches = 0
            res = _cli_json(cli, args)[-1]
            print(f"[train] {json.dumps(res)}")
            got = (fd.diffuse_fused.launches, adam_kernel.adam_fused.launches,
                   fdc.down_conv_fused.launches)
            b4 = b4_per_call(fdc, cfg, TRAIN_BATCH)
            per_step = ((1, adam_kernel.launches_per_step(n_leaves), b4) if path == "kernels"
                        else (0, 0, b4))
            want = tuple(steps * k for k in per_step)
            if got != want:
                fail(f"train {dtype}/{path}: launches B1/B2/B4 {got}, expected {want} "
                     f"({per_step} per step x {steps} steps)")
            if not np.isfinite(res["final_loss"]):
                fail(f"train {dtype}/{path}: loss {res['final_loss']}")
            if path == "kernels":
                launches["diffuse_f32"] += got[0]
                launches["adam_bf16m" if moments == "bfloat16" else "adam_f32m"] += got[1]
                launches["down_conv_k4s2_" + ("bf16" if dtype == "bfloat16" else "f32")] += got[2]
            results[(dtype, path)] = res
            print(f"[train] {dtype}/{path}: launches B1/B2/B4 {got} over {steps} steps; "
                  f"{res['images_per_sec']} img/s, {res['step_ms']} ms/step, "
                  f"loss {res['final_loss']:.5f}")

    # one profiled step of each (after two warm steps), outside the counted runs
    for (dtype, path), res in results.items():
        flags = dict(zip(KERNEL_PATH[::2], KERNEL_PATH[1::2]) if path == "kernels"
                     else zip(PLAIN_PATH[::2], PLAIN_PATH[1::2]))
        c = cfg.replace(batch_size=TRAIN_BATCH, compute_dtype=dtype,
                        moment_dtype="bfloat16" if dtype == "bfloat16" else "float32",
                        optimizer=flags["--optimizer"],
                        fused_diffusion=flags["--fused-diffusion"] == "true").validate()
        state = trainer.init_state(c, device="cuda")
        step = trainer.make_train_step(c)
        gen = torch.Generator(device="cuda").manual_seed(0)
        xb = torch.rand((TRAIN_BATCH, c.size, c.size, 3), generator=gen, device="cuda") * 2 - 1
        for _ in range(2):
            state, _ = step(state, xb, gen)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            state, loss = step(state, xb, gen)
            torch.cuda.synchronize()
        rows = profiler.device_ops(prof, top=None)
        busy = profiler.device_busy_ms(prof)
        print(f"[train-profile] {dtype}/{path}: one step at batch {TRAIN_BATCH}: kernels busy "
              f"{busy:.3f} ms of {res['step_ms']:.3f} ms per step (bench, no profiler): idle "
              f"share {max(0.0, 1 - busy / res['step_ms']):.1%}; {len(rows)} kernel names")
        for r in rows[:8]:
            print(f"[train-profile]   {r['ms']:8.3f} ms x{r['calls']:<4d} {r['op'][:100]}")
        del state, step, xb
    fdc.down_conv_fused.launches = fd.diffuse_fused.launches = 0
    adam_kernel.adam_fused.launches = 0
    return launches, results


def phase_train_hbm(torch, fdc, fd, adam_kernel, trainer, cfg, synthetic):
    """The training slice fed as users feed it from a pool in device memory:
    a uint8 pool made from the seed on the card (HBM_POOL, 31.9 MB) behind
    ``HBMDataset(raw=True)``, whose batches ``train_step`` crops, flips and
    normalises itself; the default model at batch 16 on the kernel path
    (B1, B2, B4), float32 and bfloat16, 3 + 10 steps: exact launch counts,
    finite losses, img/s beside ``[train]``'s synthetic batch; one profiled
    step with the augment's device time; a ``raw=False`` draw against
    ``apply_augment`` on the same draws; and a tiny config's 3 uint8 steps on
    the card and on the CPU (losses within 1e-4 relative, as
    ``[reference]``). Returns the launches by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from gan_class_transfer2_tpu_torch.config import tiny_test_config
    from gan_class_transfer2_tpu_torch.data import device_augment as aug
    from gan_class_transfer2_tpu_torch.data.pipeline import EpochIndexStream
    from gan_class_transfer2_tpu_torch.models import unet
    from gan_class_transfer2_tpu_torch.utils import profiler

    n_img, h, w = HBM_POOL
    pool = torch.randint(0, 256, (n_img, h, w, 3), dtype=torch.uint8, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(21))
    n_leaves = len(list(unet.Denoiser(cfg).parameters()))
    per_step = (1, adam_kernel.launches_per_step(n_leaves), b4_per_call(fdc, cfg, TRAIN_BATCH))
    steps = BENCH_WARMUP + BENCH_STEPS
    launches = {"diffuse_f32": 0, "adam_f32m": 0, "adam_bf16m": 0,
                "down_conv_k4s2_f32": 0, "down_conv_k4s2_bf16": 0}
    for dtype in ("float32", "bfloat16"):
        moments = "bfloat16" if dtype == "bfloat16" else "float32"
        c = cfg.replace(batch_size=TRAIN_BATCH, compute_dtype=dtype, moment_dtype=moments,
                        optimizer="adam_fused",
                        fused_diffusion=True).validate()
        data = iter(aug.HBMDataset(pool, c.size, TRAIN_BATCH, seed=0, raw=True, device="cuda"))
        state = trainer.init_state(c, device="cuda")
        step = trainer.make_train_step(c)
        gen = torch.Generator(device="cuda").manual_seed(0)
        fdc.down_conv_fused.launches = fd.diffuse_fused.launches = 0
        adam_kernel.adam_fused.launches = 0
        for i in range(steps):
            if i == BENCH_WARMUP:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            state, loss = step(state, next(data), gen)
        loss = float(loss)
        secs = time.perf_counter() - t0
        got = (fd.diffuse_fused.launches, adam_kernel.adam_fused.launches,
               fdc.down_conv_fused.launches)
        want = tuple(steps * k for k in per_step)
        if got != want:
            fail(f"train-hbm {dtype}: launches B1/B2/B4 {got}, expected {want}")
        if not np.isfinite(loss):
            fail(f"train-hbm {dtype}: loss {loss}")
        launches["diffuse_f32"] += got[0]
        launches["adam_bf16m" if moments == "bfloat16" else "adam_f32m"] += got[1]
        launches["down_conv_k4s2_" + ("bf16" if dtype == "bfloat16" else "f32")] += got[2]
        ips = TRAIN_BATCH * BENCH_STEPS / secs
        print(f"[train-hbm] {dtype}: uint8 pool {tuple(pool.shape)} on the card, batch "
              f"{TRAIN_BATCH}: launches B1/B2/B4 {got} over {steps} steps; {ips:.3f} img/s, "
              f"{secs / BENCH_STEPS * 1e3:.3f} ms/step ([train] on a synthetic batch: "
              f"{synthetic[(dtype, 'kernels')]['images_per_sec']} img/s); loss {loss:.5f}")

        # one profiled step, its augment in a named range; then the augment
        # of one batch alone
        batch = next(data)
        augment = trainer.augment_if_uint8

        def named(*args):
            with record_function("augment_if_uint8"):
                return augment(*args)

        trainer.augment_if_uint8 = named  # fold_and_augment looks it up at each call
        try:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                state, loss = step(state, batch, gen)
                torch.cuda.synchronize()
        finally:
            trainer.augment_if_uint8 = augment
        busy = profiler.device_busy_ms(prof)
        # the kernels launched inside the CPU-side range (the GPU-side
        # annotation of the same name spans the host-paced gaps between them)
        in_step = sum(e.device_time_total for e in prof.events()
                      if e.name == "augment_if_uint8" and e.device_type == DeviceType.CPU) / 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            augment(c, batch, gen)
            torch.cuda.synchronize()
        alone = sum(e.device_time_total for e in prof.key_averages()
                    if not e.key.startswith(("cuda", "Activity"))) / 1e3
        print(f"[train-hbm] {dtype}: one profiled step: kernels busy {busy:.3f} ms, of which the "
              f"augment (draws, gather, normalise) {in_step:.4f} ms ({in_step / busy:.2%}); the "
              f"augment alone {alone:.4f} ms of device time")
        del state, step, data, batch
        torch.cuda.empty_cache()
    fdc.down_conv_fused.launches = fd.diffuse_fused.launches = 0
    adam_kernel.adam_fused.launches = 0

    # a raw=False draw is apply_augment of the same rows and draws
    ds = aug.HBMDataset(pool, cfg.size, TRAIN_BATCH, seed=4, device="cuda")
    idx = EpochIndexStream(n_img, TRAIN_BATCH, seed=4).next_indices()
    got = next(iter(ds))
    off, flip = aug.draw_augment(TRAIN_BATCH, h, w, cfg.size,
                                 torch.Generator(device="cuda").manual_seed(aug._key(4, 0)))
    want = aug.apply_augment(pool[torch.from_numpy(idx).cuda()], off, flip, cfg.size)
    if not torch.equal(got, want):
        fail("HBMDataset(raw=False) differs from apply_augment on the same draws")
    print(f"[train-hbm] HBMDataset(raw=False) batch {tuple(got.shape)} equals apply_augment on "
          f"the same rows and draws")

    # a tiny config, 3 uint8 steps on the card and on the CPU, B1 and B2 on;
    # one CPU generator stream makes both draw the same crops, t and noise
    tiny = tiny_test_config(fused_diffusion=True, optimizer="adam_fused", lr_schedule="constant",
                            learning_rate=1e-3)
    small = np.random.default_rng(22).integers(0, 256, (6, 20, 22, 3), dtype=np.uint8)
    losses = {}
    for dev in ("cpu", "cuda"):
        state = trainer.init_state(tiny, torch.Generator().manual_seed(0), device=dev)
        step, gen = trainer.make_train_step(tiny), torch.Generator().manual_seed(5)
        data = iter(aug.HBMDataset(small, tiny.size, 2, seed=1, raw=True, device=dev))
        b1, b2 = fd.diffuse_fused.launches, adam_kernel.adam_fused.launches
        losses[dev] = []
        for _ in range(3):
            state, loss = step(state, next(data), gen)
            losses[dev].append(float(loss))
        launched = (fd.diffuse_fused.launches - b1, adam_kernel.adam_fused.launches - b2)
        fd.diffuse_fused.launches, adam_kernel.adam_fused.launches = b1, b2
        if launched != ((0, 0) if dev == "cpu" else (3, 3)):
            fail(f"train-hbm tiny on {dev}: B1/B2 launches {launched}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    print(f"[train-hbm] tiny uint8 train, 3 steps: losses card {losses['cuda']} CPU "
          f"{losses['cpu']}; max relative diff {rel:.3e} (bound 1e-4)")
    if not rel <= 1e-4:
        fail(f"tiny uint8 training on the card differs from the CPU by {rel} relative")
    del pool, ds
    torch.cuda.empty_cache()
    return launches


def phase_train_agree(torch, fdc, adam_kernel, api, trainer, cfg, tag="train-agree"):
    """One injected step at full width from the same weights, t and ε (and,
    for a class-conditional ``cfg``, the same labels): kernel path on the
    card (B4 fwd+bwd, the conv epilogue, B2) against plain path on the CPU
    (the plain versions, optax-form Adam), float32, constant LR 1e-3 so that
    the update (≈ ±lr per element on Adam's first step) stands far above a
    float32 ulp of the weights.
    Bounds: loss within 1e-5 relative (IEEE float32 convs, other orders);
    updates within 1e-3·lr for all but 1e-4 of the elements (an element
    whose gradient is ~0 may flip its update's sign between two correct
    orders of summation)."""
    r = np.random.default_rng(9)
    x = torch.from_numpy(r.uniform(-1, 1, (TRAIN_BATCH, cfg.size, cfg.size, 3))
                         .astype(np.float32)).cuda()
    t = torch.from_numpy(r.integers(1, cfg.steps + 1, TRAIN_BATCH).astype(np.int32))
    eps = torch.from_numpy(r.standard_normal(tuple(x.shape)).astype(np.float32)).cuda()
    batch = x
    if cfg.num_classes > 0:
        labels = r.integers(0, cfg.num_classes, TRAIN_BATCH).astype(np.int32)
        batch = {"image": x, "label": torch.from_numpy(labels).cuda()}
    lr = 1e-3
    init = api.init_denoiser(cfg, device="cpu")
    p0 = [p.detach().cuda() for p in init.parameters()]
    out = {}
    for path, dev, opt in (("kernels", "cuda", "adam_fused"), ("plain", "cpu", "adam_tf")):
        c = cfg.replace(batch_size=TRAIN_BATCH, optimizer=opt, lr_schedule="constant",
                        learning_rate=lr).validate()
        model = copy.deepcopy(init).to(dev)
        opt_state = trainer.make_optimizer(c).init(list(model.parameters()))
        state = trainer.TrainState(0, model, opt_state, None, None)
        b4, b2 = fdc.down_conv_fused.launches, adam_kernel.adam_fused.launches
        on_dev = ({k: v.to(dev) for k, v in batch.items()} if isinstance(batch, dict)
                  else batch.to(dev))
        state, loss = trainer.make_injected_train_step(c)(state, on_dev, t, eps.to(dev))
        torch.cuda.synchronize()
        launched = (fdc.down_conv_fused.launches - b4, adam_kernel.adam_fused.launches - b2)
        fdc.down_conv_fused.launches, adam_kernel.adam_fused.launches = b4, b2
        if launched != ((b4_per_call(fdc, cfg, TRAIN_BATCH), 1) if path == "kernels" else (0, 0)):
            fail(f"{tag} {path}: B4/B2 launches {launched}")
        out[path] = (float(loss),
                     [(p.detach().cuda() - q) for p, q in zip(model.parameters(), p0)])
        del state, model
    (lk, dk), (lp, dp) = out["kernels"], out["plain"]
    rel = abs(lk - lp) / abs(lp)
    diff = torch.cat([(a - b).abs().flatten() for a, b in zip(dk, dp)])
    frac = (diff > 1e-3 * lr).double().mean().item()
    mean_update = torch.cat([a.abs().flatten() for a in dp]).mean().item()
    print(f"[{tag}] one injected step, {cfg.size}², batch {TRAIN_BATCH}, fp32"
          f"{f', {cfg.num_classes} classes' if cfg.num_classes else ''}: loss kernels "
          f"{lk:.7f} plain {lp:.7f} (rel {rel:.2e}, bound 1e-5); updates: mean |Δp| "
          f"{mean_update:.3e} (lr {lr}), max|Δk − Δp| {diff.max().item():.3e}, share of "
          f"elements beyond 1e-3·lr {frac:.2e} (bound 1e-4) of {diff.numel()}")
    if not rel <= 1e-5 or not frac <= 1e-4:
        fail(f"kernel and plain training paths disagree: loss rel {rel}, share {frac}")


# ----------------------------------------------- the train commands (files in)


def write_class_pngs(tmp):
    """CLI_FILES[0] circles in ``tmp/a`` and as many crosses in ``tmp/b``,
    CLI_FILES[1]² PNGs from ``data/synthetic.py``, written with the port's
    own PNG writer. Returns the two globs."""
    from gan_class_transfer2_tpu_torch.data import synthetic

    n, side = CLI_FILES
    t0 = time.perf_counter()
    synthetic.save_as_pngs(synthetic.circles(n, side, seed=0), os.path.join(tmp, "a"))
    synthetic.save_as_pngs(synthetic.crosses(n, side, seed=0), os.path.join(tmp, "b"))
    print(f"[train-cli] wrote {2 * n} synthetic {side}² PNGs (circles, crosses) in "
          f"{time.perf_counter() - t0:.2f} s")
    return os.path.join(tmp, "a", "*.png"), os.path.join(tmp, "b", "*.png")


def _width(cfg, names=("size", "pixel_size", "max_size", "octaves", "steps")):
    return [f"--{k.replace('_', '-')}={getattr(cfg, k)}" for k in names]


def _train_cli(cfg, tmp, log, ckpt, *extra):
    """``cli train`` at the default width on the kernel path, float32,
    batch 16, CLI_STEPS steps an epoch and a checkpoint at each epoch's end
    (the newest one kept), from every PNG under ``tmp``."""
    return ["train", "--device", "cuda", *_width(cfg), *KERNEL_PATH, "--compute-dtype",
            "float32", "--batch-size", str(TRAIN_BATCH), "--steps-per-epoch", str(CLI_STEPS),
            "--checkpoint-every", str(CLI_STEPS), "--checkpoint-keep", "1",
            "--sample-stride", "50", "--dataset-pattern", os.path.join(tmp, "*", "*.png"),
            "--log-dir", os.path.join(tmp, log), "--checkpoint-dir", os.path.join(tmp, ckpt),
            *extra]


def _events(log_dir):
    """{tag: [(epoch, value), ...]} of the one event file a run wrote under
    ``log_dir`` (the reference's <day>/<time> layout), read back with the
    port's own reader."""
    import glob

    from gan_class_transfer2_tpu_torch.utils import tensorboard as tb

    files = glob.glob(os.path.join(log_dir, "*", "*", "events.out.tfevents.*"))
    if len(files) != 1:
        fail(f"{log_dir}: {len(files)} event files, expected 1")
    out = {}
    for step, tag, _, value in tb.read_events(files[0]):
        out.setdefault(tag, []).append((step, value))
    return out


def _run_cli(cli, counters, args):
    """``cli.main(args)`` with every counter in ``counters`` (kernel
    wrappers) set to 0 just before; returns (their launches, seconds)."""
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(args)
    secs = time.perf_counter() - t0
    if rc != 0:
        fail(f"cli {' '.join(args[:1])} returned {rc}")
    return tuple(c.launches for c in counters), secs


def phase_train_cli(torch, cli, fdc, fd, adam_kernel, sampler, cfg, tmp):
    """The user's training command, ``cli.main(["train", ...])``, streaming
    the PNG files from disk through the native C++ loader (the default
    ``--native-loader true``, ``--data-hbm 0 --data-workers 2``) with
    ``--fid-samples EVAL_SAMPLES``: the default model, float32, batch 16, 2
    epochs × CLI_STEPS steps on the kernel path, a checkpoint each epoch and
    one ``log_sample`` (at stride 50). The dataset must be the
    ``NativeImageDataset``. Exact B1/B2/B4 launches (the train steps, and B4
    in log_sample's denoiser calls: the preview, T invert steps, the
    stride-50 sample, and the FID/KID sample of EVAL_SAMPLES), finite losses,
    every reference tag and ``fid``/``kid`` in the event file, the last
    checkpoint. Returns the launches by kernel name."""
    from gan_class_transfer2_tpu_torch.data import native_loader, pipeline
    from gan_class_transfer2_tpu_torch.models import unet
    from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt_lib

    n_leaves = len(list(unet.Denoiser(cfg).parameters()))
    steps = 2 * CLI_STEPS
    sample_calls = len(sampler.sample_timesteps(cfg.replace(sample_stride=50)))
    calls = 1 + cfg.steps + sample_calls
    b4 = b4_per_call(fdc, cfg, TRAIN_BATCH)
    b4_fid = sample_calls * b4_per_call(fdc, cfg, EVAL_SAMPLES)
    want = (steps, steps * adam_kernel.launches_per_step(n_leaves), (steps + calls) * b4 + b4_fid)
    args = _train_cli(cfg, tmp, "logs-cli", "ckpt-cli", "--epochs", "2", "--data-hbm", "0",
                      "--data-workers", "2", "--log-images-every", "2",
                      "--fid-samples", str(EVAL_SAMPLES))
    built = []
    make_datasets = pipeline.make_datasets

    def recording(*a, **kw):
        out = make_datasets(*a, **kw)
        built.extend(type(d).__name__ for d in out)
        return out

    pipeline.make_datasets = recording
    try:
        got, secs = _run_cli(cli, (fd.diffuse_fused, adam_kernel.adam_fused,
                                   fdc.down_conv_fused), args)
    finally:
        pipeline.make_datasets = make_datasets
    if built != [native_loader.NativeImageDataset.__name__]:
        fail(f"train-cli: the datasets were {built}, expected one NativeImageDataset")
    if got != want:
        fail(f"train-cli: launches B1/B2/B4 {got}, expected {want} ({steps} steps, "
             f"{calls} denoiser calls in one log_sample and {sample_calls} for its FID/KID "
             f"sample of {EVAL_SAMPLES})")
    ev = _events(os.path.join(tmp, "logs-cli"))
    missing = [t for t in (*REF_TAGS, "fid", "kid") if t not in ev]
    if missing:
        fail(f"train-cli: the event file lacks the tags {missing}")
    fid, kid = ev["fid"][0][1], ev["kid"][0][1]
    if not (np.isfinite(fid) and np.isfinite(kid)):
        fail(f"train-cli: fid {fid}, kid {kid}")
    losses, ips = dict(ev["loss"]), dict(ev["images_per_sec"])
    if sorted(losses) != [0, 1] or not all(np.isfinite(v) for v in losses.values()):
        fail(f"train-cli: epoch losses {losses}")
    if ckpt_lib.all_steps(os.path.join(tmp, "ckpt-cli")) != [steps]:
        fail(f"train-cli: checkpoints {ckpt_lib.all_steps(os.path.join(tmp, 'ckpt-cli'))}")
    for e in (0, 1):
        print(f"[train-cli] epoch {e}: loss {losses[e]:.7f}, {ips[e]:.3f} img/s "
              f"({TRAIN_BATCH * CLI_STEPS} images from PNG files{', after log_sample' if e == 0 else ''})")
    print(f"[train-cli] fp32 kernel path on the NativeImageDataset, {steps} steps + one "
          f"log_sample ({calls} denoiser calls + {sample_calls} for FID/KID of {EVAL_SAMPLES} "
          f"samples): launches B1/B2/B4 {got}; every reference tag logged; fid {fid:.6f}, kid "
          f"{kid:.6f} (random-init weights after {steps} steps, against {EVAL_SAMPLES} held-out "
          f"files); checkpoint step {steps}; wall {secs:.2f} s")
    return {"diffuse_f32": got[0], "adam_f32m": got[1], "down_conv_k4s2_f32": got[2]}


def phase_train_resume(torch, cli, fdc, fd, adam_kernel, trainer, sampler, png, cfg, tmp):
    """A resumed run against an unbroken one, from the HBM-resident pool
    (``--data-hbm 288``: the index stream and the augment replay exactly)
    with an EMA: run A trains 2 epochs in one call; run B trains
    ``--epochs 1``, then ``--epochs 2`` on the same checkpoint dir, which
    must restore and run exactly CLI_STEPS steps. B's epoch-1 loss must
    equal A's within 1e-5 relative (cuDNN's weight gradients may sum in
    another order). Then ``cli sample --checkpoint-dir`` of A's dir must
    write the images that A's restored EMA params give in this process
    (within one uint8 level, in at most 1e-3 of the values), and one save
    of that state is timed. Returns the launches by kernel name."""
    from gan_class_transfer2_tpu_torch.models import unet
    from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt_lib

    n_leaves = len(list(unet.Denoiser(cfg).parameters()))
    per_step = (1, adam_kernel.launches_per_step(n_leaves), b4_per_call(fdc, cfg, TRAIN_BATCH))
    counters = (fd.diffuse_fused, adam_kernel.adam_fused, fdc.down_conv_fused)
    common = ("--data-hbm", "288", "--log-images-every", "0", "--ema-decay", "0.999")
    total = [0, 0, 0]
    loss, secs = {}, {}
    for log, ckpt, epochs, n in (("logs-A", "ckpt-A", 2, 2), ("logs-B1", "ckpt-B", 1, 1),
                                 ("logs-B2", "ckpt-B", 2, 1)):
        got, secs[log] = _run_cli(cli, counters,
                                  _train_cli(cfg, tmp, log, ckpt, "--epochs", str(epochs), *common))
        want = tuple(n * CLI_STEPS * k for k in per_step)
        if got != want:
            fail(f"train-resume {log}: launches B1/B2/B4 {got}, expected {want} "
                 f"({n * CLI_STEPS} steps)")
        total = [t + g for t, g in zip(total, got)]
        loss[log] = dict(_events(os.path.join(tmp, log))["loss"])
    a, b = loss["logs-A"], {**loss["logs-B1"], **loss["logs-B2"]}
    if sorted(b) != [0, 1] or sorted(a) != [0, 1]:
        fail(f"train-resume: epochs logged A {sorted(a)}, B {sorted(b)}")
    rel = {e: abs(a[e] - b[e]) / abs(a[e]) for e in (0, 1)}
    print(f"[train-resume] data_hbm 288, EMA 0.999: A (one call) epoch losses {a[0]:.9f}, "
          f"{a[1]:.9f}; B (--epochs 1, then --epochs 2 restored at step {CLI_STEPS}: "
          f"{CLI_STEPS} steps) {b[0]:.9f}, {b[1]:.9f}; relative differences epoch 0 "
          f"{rel[0]:.3e}, epoch 1 {rel[1]:.3e} (bound 1e-5); wall A {secs['logs-A']:.2f} s, "
          f"B {secs['logs-B1']:.2f} + {secs['logs-B2']:.2f} s")
    if not rel[1] <= 1e-5:
        fail(f"train-resume: the resumed epoch-1 loss differs by {rel[1]} relative")

    ckpt = os.path.join(tmp, "ckpt-A")
    out = os.path.join(tmp, "samples-A")
    got, s_secs = _run_cli(cli, (fdc.down_conv_fused,), [
        "sample", "--device", "cuda", "--checkpoint-dir", ckpt, "--num", str(BATCH),
        "--out", out])
    total[2] += got[0]
    c = ckpt_lib.load_config(ckpt)
    state = ckpt_lib.restore(ckpt, trainer.init_state(c, device="cuda"))
    if state.ema_params is None or state.step != 2 * CLI_STEPS:
        fail(f"train-resume: A's checkpoint holds step {state.step}, EMA "
             f"{state.ema_params is not None}")
    init = torch.from_numpy(np.random.default_rng(c.seed).normal(
        size=(BATCH, c.size, c.size, 3)).astype(np.float32)).cuda()
    fdc.down_conv_fused.launches = 0
    images = sampler.sample(c, trainer.eval_model(state), init, snapshots=False).images
    fdc.down_conv_fused.launches = 0  # the in-process comparison does not count
    diff = np.stack([np.abs(png.read_png(os.path.join(out, f"sample_{i}.png")).astype(int)
                            - png.to_uint8(images[i].cpu().numpy()).astype(int))
                     for i in range(BATCH)])
    # the same weights and inputs; float32 sums may round differently between
    # two allocations (cuBLAS picks kernels by alignment), so a value on a
    # level boundary may flip by one level, as in [sample]
    print(f"[train-resume] cli sample --checkpoint-dir (step {state.step}, EMA params, "
          f"{got[0]} B4 launches, {s_secs:.2f} s) against A's restored EMA sampled in "
          f"process: max {diff.max()} uint8 levels apart (bound {IMAGE_LEVELS['float32']}), "
          f"{int((diff > 0).sum())} of {diff.size} values differ")
    if diff.max() > IMAGE_LEVELS["float32"] or (diff > 0).mean() > 1e-3:
        fail(f"train-resume: sample --checkpoint-dir differs by {diff.max()} levels in "
             f"{int((diff > 0).sum())} values")

    # the checkpoint layer: one save of this state (model, Adam moments, EMA)
    t0 = time.perf_counter()
    snap = ckpt_lib.host_complete(state)
    t1 = time.perf_counter()
    path = ckpt_lib.save(os.path.join(tmp, "ckpt-timed"), snap, c)
    t2 = time.perf_counter()
    size = os.path.getsize(os.path.join(path, ckpt_lib.STATE_FILE))
    print(f"[train-resume] one checkpoint of the default model's train state ({size / 1e6:.1f} "
          f"MB): copy to the host {(t1 - t0) * 1e3:.1f} ms, write {(t2 - t1) * 1e3:.1f} ms")
    del state, images, snap
    torch.cuda.empty_cache()
    return {"diffuse_f32": total[0], "adam_f32m": total[1], "down_conv_k4s2_f32": total[2]}


# ------------------------------------------ the native loader and the cache


def _paeth_png(img):
    """PNG bytes of (H, W, 3) uint8 whose even rows use the Paeth filter and
    odd rows the Average filter (the two a Python decoder runs byte by
    byte); filtering reads the raw bytes only, so numpy does it at once."""
    import struct
    import zlib

    from gan_class_transfer2_tpu_torch.utils import png

    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int16)
    a = np.zeros_like(x)
    a[:, c:] = x[:, :-c]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    ul = np.zeros_like(x)
    ul[1:, c:] = x[:-1, :-c]
    p = a + b - ul
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul))
    ftype = np.where(np.arange(h) % 2 == 0, 4, 3).astype(np.uint8)
    pred = np.where(ftype[:, None] == 4, paeth, (a + b) // 2)
    rows = np.concatenate([ftype[:, None], ((x - pred) % 256).astype(np.uint8)], 1)

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    return (png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes())) + chunk(b"IEND", b""))


def write_paeth_pngs(directory):
    """PAETH_FILES[0] photo-like PNGs of PAETH_FILES[1]²: the synthetic
    circles with Gaussian noise (σ = 6 levels), Paeth and Average rows.
    Returns their glob."""
    from gan_class_transfer2_tpu_torch.data import synthetic
    from gan_class_transfer2_tpu_torch.utils import png

    n, side = PAETH_FILES
    os.makedirs(directory, exist_ok=True)
    imgs = png.to_uint8(synthetic.circles(n, side, seed=1)).astype(np.int16)
    imgs = np.clip(imgs + np.random.default_rng(0).normal(0, 6, imgs.shape), 0, 255)
    for i, img in enumerate(imgs.astype(np.uint8)):
        with open(os.path.join(directory, f"p_{i:04d}.png"), "wb") as fh:
            fh.write(_paeth_png(img))
    return os.path.join(directory, "*.png")


def phase_loader(globs, paeth_glob, step_ips):
    """The native C++ loader on the card's machine: the codec probe (the
    libpng, libjpeg and zlib headers and libraries, Pillow), the library
    built with the host's g++ (a failed build fails the phase), its
    decode against utils/png on every PNG of the smoke (the filter-0 class
    files and the Paeth/Average files), and decode img/s at batch 16 for
    NativeImageDataset with 2 and 8 workers and the Python ImageDataset
    with 2 threads, on the Paeth/Average files (288² → crops of 256²),
    beside what the float32 training step consumes (``step_ips``)."""
    import glob
    import importlib.util

    from gan_class_transfer2_tpu_torch.data import native_loader, pipeline
    from gan_class_transfer2_tpu_torch.utils import png

    for header in ("png.h", "jpeglib.h", "zlib.h"):
        # jpeglib.h needs stdio's FILE and size_t declared before it
        r = subprocess.run(["g++", "-fsyntax-only", "-x", "c++", "-"],
                           input=f"#include <cstdio>\n#include <{header}>\n",
                           capture_output=True, text=True)
        print(f"[loader] probe: #include <{header}> {'found' if r.returncode == 0 else 'missing'}")
    libs = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True).stdout
    names = sorted({ln.split()[0] for ln in libs.splitlines()
                    if ln.strip().startswith(("libpng", "libjpeg", "libz."))})
    print(f"[loader] probe: ldconfig -p has {names}; Pillow importable: "
          f"{importlib.util.find_spec('PIL') is not None}")
    t0 = time.perf_counter()
    if not native_loader.available():
        fail(f"loader: the native loader did not build:\n{native_loader.build_error()}")
    print(f"[loader] dataloader.cc built with g++ and loaded in {time.perf_counter() - t0:.2f} s")

    files = sorted(glob.glob(globs[0]) + glob.glob(globs[1]))
    paeth = sorted(glob.glob(paeth_glob))
    t0 = time.perf_counter()
    for f in files + paeth:
        want = png.read_png(f).astype(np.float32) / 128.0 - 1.0
        if not np.array_equal(native_loader.decode_one(f, 0, augment=False), want):
            fail(f"loader: the native decode of {f} differs from utils/png")
    print(f"[loader] native decode equals utils/png on {len(files)} filter-0 PNGs and "
          f"{len(paeth)} Paeth/Average PNGs of {PAETH_FILES[1]}² ({time.perf_counter() - t0:.2f} s)")

    def rate(make, batches):
        """img/s from the dataset's creation to its ``batches``-th batch (a
        prefetch window filled ahead of the timing would inflate it)."""
        t0 = time.perf_counter()
        ds = make()
        it = iter(ds)
        for _ in range(batches):
            b = next(it)
        secs = time.perf_counter() - t0
        ds.close()
        if b.shape != (TRAIN_BATCH, 256, 256, 3):
            fail(f"loader: batch {b.shape}")
        return batches * TRAIN_BATCH / secs

    rates = {}
    for workers in (2, 8):
        rates[f"native, {workers} workers"] = rate(lambda: native_loader.NativeImageDataset(
            paeth, 256, TRAIN_BATCH, seed=0, num_workers=workers), 16)
    rates["python, 2 threads"] = rate(lambda: pipeline.ImageDataset(
        paeth, 256, TRAIN_BATCH, seed=0, num_workers=2), 4)
    for name, ips in rates.items():
        print(f"[loader] decode + crop + flip + normalise at batch {TRAIN_BATCH}, Paeth/Average "
              f"{PAETH_FILES[1]}² PNGs, {name}: {ips:.3f} img/s ({ips / step_ips:.2f}x the "
              f"{step_ips:.3f} img/s a float32 training step consumes)")
    return rates


def phase_cache(torch, cli, fdc, fd, adam_kernel, cfg, tmp, paeth_glob):
    """``cli build-cache`` of the Paeth/Average PNGs at store 288, then a
    Runner fed ``AugmentedCachedDataset`` (uint8 batches to the card, crop,
    flip and normalise there) for CLI_STEPS steps at the default width,
    float32, batch 16, on the kernel path: exact B1/B2/B4 launches, a finite
    loss, img/s. Returns the launches by kernel name."""
    from gan_class_transfer2_tpu_torch.data import cache
    from gan_class_transfer2_tpu_torch.models import unet
    from gan_class_transfer2_tpu_torch.train.loop import Runner
    from gan_class_transfer2_tpu_torch.utils import tensorboard as tb

    path = os.path.join(tmp, "paeth.gct2cache")
    t0 = time.perf_counter()
    rc = cli.main(["build-cache", "--device", "cuda", "--dataset-pattern", paeth_glob,
                   "--store", str(PAETH_FILES[1]), "--out", path])
    build_s = time.perf_counter() - t0
    data, store = cache.read_cache(path)
    if rc != 0 or data.shape != (PAETH_FILES[0], store, store, 3) or store != PAETH_FILES[1]:
        fail(f"cache: build-cache returned {rc}, records {data.shape}")
    c = cfg.replace(optimizer="adam_fused", fused_diffusion=True,
                    compute_dtype="float32", batch_size=TRAIN_BATCH, checkpoint_dir=None,
                    log_images_every=0).validate()
    n_leaves = len(list(unet.Denoiser(c).parameters()))
    per_step = (1, adam_kernel.launches_per_step(n_leaves), b4_per_call(fdc, c, TRAIN_BATCH))
    ds = cache.AugmentedCachedDataset(path, c.size, TRAIN_BATCH, seed=0, device="cuda")
    runner = Runner(c, dataset=ds, log_dir=os.path.join(tmp, "logs-cache"), device="cuda")
    counters = (fd.diffuse_fused, adam_kernel.adam_fused, fdc.down_conv_fused)
    for k in counters:
        k.launches = 0
    t0 = time.perf_counter()
    runner.fit(epochs=1, steps_per_epoch=CLI_STEPS, log_samples=False)
    secs = time.perf_counter() - t0
    got = tuple(k.launches for k in counters)
    runner.close()
    want = tuple(CLI_STEPS * k for k in per_step)
    if got != want:
        fail(f"cache: launches B1/B2/B4 {got}, expected {want} ({CLI_STEPS} steps)")
    ev = {tag: value for _, tag, _, value in tb.read_events(runner.writer.path)}
    if not np.isfinite(ev.get("loss", np.nan)):
        fail(f"cache: loss {ev.get('loss')}")
    print(f"[cache] cli build-cache: {PAETH_FILES[0]} Paeth/Average PNGs -> {store}² uint8 "
          f"records ({os.path.getsize(path) / 1e6:.1f} MB) in {build_s:.2f} s; Runner on "
          f"AugmentedCachedDataset, fp32 kernel path, {CLI_STEPS} steps at batch "
          f"{TRAIN_BATCH}: launches B1/B2/B4 {got}, loss {ev['loss']:.7f}, "
          f"{ev['images_per_sec']:.3f} img/s (the first steps included), wall {secs:.2f} s")
    del runner, ds
    torch.cuda.empty_cache()
    return {"diffuse_f32": got[0], "adam_f32m": got[1], "down_conv_k4s2_f32": got[2]}


# ------------------------------------------------------------------ GAN


def gan_counts(fdc, cfg, batch, conditional=False):
    """What one cycle-GAN step of ``cfg`` launches (with ``conditional``,
    one conditional-GAN step), derived from the config as models/unet.py,
    models/discriminator.py, train/gan.py and train/conditional_gan.py
    build it: ({(H=W, C): B3 launches per step}, B4 launches per step,
    (B3, B4) per generator forward). Norms follow every G down and up conv
    and every D conv but the first; B4 takes the down convs its gate
    admits."""
    from collections import Counter

    from gan_class_transfer2_tpu_torch.models import discriminator as d_lib

    g_norms, g_b4 = Counter(), b4_per_call(fdc, cfg, batch)
    for i in range(cfg.octaves):
        g_norms[(cfg.size >> (i + 1), cfg.octave_filters(i))] += 1  # down_norm
        g_norms[(cfg.size >> i, cfg.octave_up_filters(i))] += 1  # up_norm
    d_norms, d_b4, c = Counter(), 0, 3
    for i in range(d_lib.d_octaves(cfg)):
        f, hw = d_lib.d_filters(cfg, i), cfg.size >> i
        d_b4 += fdc.supported((batch, hw, hw, c), (4, 4, c, f))
        if i > 0:
            d_norms[(hw // 2, f)] += 1
        c = f
    if conditional:
        # G forwards: the fake, the cycle, the identity; D applies: one in
        # the G loss, two in the D loss (train/conditional_gan.py)
        n_g = 1 + cfg.cycle_term_active + cfg.identity_term_active
        n_d = 3
    else:
        # G forwards: two fakes, two cycle, two identity; D applies: two in
        # the G loss, four in the D loss (train/gan.py, gan.py:165-249)
        n_g = 2 + 2 * cfg.cycle_term_active + 2 * cfg.identity_term_active
        n_d = 6
    per_step = Counter({k: n_g * v for k, v in g_norms.items()})
    per_step.update({k: n_d * v for k, v in d_norms.items()})
    return dict(per_step), n_g * g_b4 + n_d * d_b4, (sum(g_norms.values()), g_b4)


def gan_bwd_launches(fdc, cfg, batch):
    """B3 backward launches of one unconditional GAN step: two a norm whose γ
    and β take gradients (G's, and D's in D's pass), one a norm of D in G's
    pass, where D is a constant (train/gan._constant)."""
    per_step, _, (g_fwd, _) = gan_counts(fdc, cfg, batch)
    n_g = 2 + 2 * cfg.cycle_term_active + 2 * cfg.identity_term_active
    d_apply = (sum(per_step.values()) - n_g * g_fwd) // 6  # D's norms an apply
    return 2 * n_g * g_fwd + (2 * 1 + 4 * 2) * d_apply


def phase_gan_kernels(torch, F, fdc, norm, cfg):
    """B3 against its plain version at the GAN path's distinct shapes at
    batch 16, float32 and bfloat16: the forward and the Function's dx, dγ,
    dβ (its backward the kernel) against autograd through the plain
    version, and the backward kernel against ``_in_bwd``; the kernel, the
    plain version and F.instance_norm timed beside the byte bound, and the
    backward kernel (host included, and its device time queued), ``_in_bwd``
    and F.instance_norm's autograd backward beside theirs. Then B4 with
    ``relu=False`` (every GAN down conv) at its four shapes at batch 16.
    Returns {dtype: row without launches} with times summed over one step's
    launches, forward and backward rows."""
    per_step, _, _ = gan_counts(fdc, cfg, TRAIN_BATCH)
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = {}
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        s = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bwd_ms=0.0, bwd_dev_ms=0.0,
                 bwd_plain_ms=0.0, lib_bwd_ms=0.0, err=0.0, bwd_err=0.0)
        worst = {"y": 0.0, "dx": 0.0, "dgamma": 0.0, "dbeta": 0.0}
        worst_k = {"dx": 0.0, "dgamma": 0.0, "dbeta": 0.0}
        for (hw, c), n in sorted(per_step.items(), reverse=True):
            x = (torch.randn((TRAIN_BATCH, hw, hw, c), generator=gen, device="cuda") * 3 + 2)
            x = x.to(dtype)
            g = 1 + 0.2 * torch.randn((c,), generator=gen, device="cuda")
            b = 0.2 * torch.randn((c,), generator=gen, device="cuda")
            dy = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
            before = norm.instance_norm_fused.launches
            before_bwd = norm.instance_norm_bwd_fused.launches
            y = norm.instance_norm_fused(x, g, b)
            yp = norm.instance_norm_plain(x, g, b)
            err = (y.float() - yp.float()).abs().max().item()
            scale = yp.float().abs().max().item()
            if not err <= IN_RTOL[dtype_name] * scale:
                fail(f"B3 {dtype_name} x{tuple(x.shape)}: max|err| {err} > "
                     f"{IN_RTOL[dtype_name]} x max|y| {scale}")
            s["err"] = max(s["err"], err)
            worst["y"] = max(worst["y"], err / scale)
            leaves = [[t.clone().requires_grad_() for t in (x, g, b)] for _ in range(2)]
            out = norm.instance_norm(*leaves[0])
            ref = norm.instance_norm_plain(*leaves[1])
            got = torch.autograd.grad(out, leaves[0], dy, retain_graph=True)
            want = torch.autograd.grad(ref, leaves[1], dy)
            for gname, a, w in zip(("dx", "dgamma", "dbeta"), got, want):
                gerr = (a.float() - w.float()).abs().max().item()
                gscale = w.float().abs().max().item()
                if not gerr <= IN_GRAD_RTOL[dtype_name] * gscale:
                    fail(f"B3 {gname} {dtype_name} x{tuple(x.shape)}: max|err| {gerr} > "
                         f"{IN_GRAD_RTOL[dtype_name]} x max|{gname}| {gscale}")
                worst[gname] = max(worst[gname], gerr / gscale)
            got = norm.instance_norm_bwd_fused(x, g, dy)
            want = norm._in_bwd(x, g, dy)
            for gname, a, w in zip(("dx", "dgamma", "dbeta"), got, want):
                gerr = (a.float() - w.float()).abs().max().item()
                gscale = w.float().abs().max().item()
                if not gerr <= IN_BWD_RTOL[dtype_name][gname] * gscale:
                    fail(f"B3 backward kernel {gname} {dtype_name} x{tuple(x.shape)}: max|err| "
                         f"{gerr} > {IN_BWD_RTOL[dtype_name][gname]} x max|{gname}| {gscale}")
                worst_k[gname] = max(worst_k[gname], gerr / gscale)
                if gname == "dx":
                    s["bwd_err"] = max(s["bwd_err"], gerr)
            if not all(torch.equal(a, b_) for a, b_ in zip(got, norm.instance_norm_bwd_fused(
                    x, g, dy))):
                fail(f"B3 backward kernel {dtype_name} x{tuple(x.shape)}: two calls differ")
            ms = cuda_ms(lambda: norm.instance_norm_fused(x, g, b))
            plain_ms = cuda_ms(lambda: norm.instance_norm_plain(x, g, b))
            # one library call of the same function: cuDNN/ATen instance norm
            # on the NCHW view of the same NHWC memory
            xl, gl, bl = x.permute(0, 3, 1, 2), g.to(dtype), b.to(dtype)
            lib_ms = cuda_ms(lambda: F.instance_norm(xl, weight=gl, bias=bl, eps=1e-5))
            bwd_ms = cuda_ms(lambda: norm.instance_norm_bwd_fused(x, g, dy))
            bwd_dev_ms = queued_ms(lambda: norm.instance_norm_bwd_fused(x, g, dy))
            bwd_plain_ms = cuda_ms(lambda: norm._in_bwd(x, g, dy))
            # the library's backward of the same function: F.instance_norm's
            # autograd on the NCHW view, dx, dγ and dβ
            lib_in = [xl.detach().requires_grad_(), gl.clone().requires_grad_(),
                      bl.clone().requires_grad_()]
            lib_out = F.instance_norm(lib_in[0], weight=lib_in[1], bias=lib_in[2], eps=1e-5)
            dy_l = dy.permute(0, 3, 1, 2)
            lib_bwd_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, lib_in, dy_l,
                                                             retain_graph=True))
            # comparison launches do not count
            norm.instance_norm_fused.launches = before
            norm.instance_norm_bwd_fused.launches = before_bwd
            nbytes = 2 * x.numel() * x.element_size() + 2 * 4 * c  # x in, y out; γ, β
            bound = _bytes_ms(nbytes)
            plan, bplan = norm.plan(*x.shape), norm.block_plan(*x.shape, dtype)
            print(f"[gan-kernel] B3 {dtype_name} x{tuple(x.shape)} (x{n} a step): cluster "
                  f"{plan.cluster} ({plan.blocks} blocks, chunk {plan.chunk} px); max|err| "
                  f"{err:.3e} (max|y| {scale:.3f}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"F.instance_norm {lib_ms:.4f} ms, bound {bound:.4f} ms (bytes) = "
                  f"{bound / ms:.1%} of bound; backward kernel ({bplan}) {bwd_ms:.4f} ms, "
                  f"device {bwd_dev_ms:.4f} ms = {1.5 * bound / bwd_dev_ms:.1%} of its bound "
                  f"{1.5 * bound:.4f} ms (bytes: x and dy read, dx written), plain (_in_bwd, "
                  f"torch ops) {bwd_plain_ms:.4f} ms, F.instance_norm's backward "
                  f"{lib_bwd_ms:.4f} ms")
            for k, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                         ("bound_ms", bound), ("bwd_ms", bwd_ms), ("bwd_dev_ms", bwd_dev_ms),
                         ("bwd_plain_ms", bwd_plain_ms), ("lib_bwd_ms", lib_bwd_ms)):
                s[k] += n * v
            del x, y, yp, dy, leaves, out, ref, got, want, xl, lib_in, lib_out, dy_l
        print(f"[gan-kernel] B3 {dtype_name}: {sum(per_step.values())} launches a step over "
              f"{len(per_step)} shapes; max error relative to the largest value: y "
              f"{worst['y']:.2e} (bound {IN_RTOL[dtype_name]}), dx {worst['dx']:.2e}, dγ "
              f"{worst['dgamma']:.2e}, dβ {worst['dbeta']:.2e} (bound "
              f"{IN_GRAD_RTOL[dtype_name]}); a step's norms: kernel {s['ms']:.4f} ms, plain "
              f"{s['plain_ms']:.4f} ms, F.instance_norm {s['library_ms']:.4f} ms, bound "
              f"{s['bound_ms']:.4f} ms (bytes); backward kernel {s['bwd_ms']:.4f} ms, device "
              f"{s['bwd_dev_ms']:.4f} ms ({1.5 * s['bound_ms'] / s['bwd_dev_ms']:.1%} of its "
              f"bound), plain (_in_bwd) {s['bwd_plain_ms']:.4f} ms, F.instance_norm's "
              f"backward {s['lib_bwd_ms']:.4f} ms, its bound {1.5 * s['bound_ms']:.4f} ms "
              f"(bytes); backward kernel against _in_bwd: dx {worst_k['dx']:.2e}, dγ "
              f"{worst_k['dgamma']:.2e}, dβ {worst_k['dbeta']:.2e} (bounds "
              f"{IN_BWD_RTOL[dtype_name]})")
        # a large mean, x = 3·N(0, 1) + 100: where a one-pass E[x²] − m² loses
        # the variance's digits; the kernel's Welford/Chan combine must not,
        # nor the backward's sums about the sample's first pixel
        for shape in ((TRAIN_BATCH, 64, 64, 256), (TRAIN_BATCH, 256, 256, 64)):
            x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 100).to(dtype)
            g = 1 + 0.2 * torch.randn((shape[3],), generator=gen, device="cuda")
            b = 0.2 * torch.randn((shape[3],), generator=gen, device="cuda")
            dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            before = norm.instance_norm_fused.launches
            before_bwd = norm.instance_norm_bwd_fused.launches
            y = norm.instance_norm_fused(x, g, b)
            yp = norm.instance_norm_plain(x, g, b)
            got = norm.instance_norm_bwd_fused(x, g, dy)
            want = norm._in_bwd(x, g, dy)
            norm.instance_norm_fused.launches = before
            norm.instance_norm_bwd_fused.launches = before_bwd
            err = (y.float() - yp.float()).abs().max().item()
            scale = yp.float().abs().max().item()
            gerr = {k: (a.float() - w.float()).abs().max().item() / w.float().abs().max().item()
                    for k, a, w in zip(("dx", "dgamma", "dbeta"), got, want)}
            print(f"[gan-kernel] B3 {dtype_name} large mean x{shape} = 3·N(0,1) + 100: max|err| "
                  f"{err:.3e} (max|y| {scale:.3f}, bound {IN_RTOL[dtype_name]} x max|y|); "
                  f"backward kernel against _in_bwd, relative: "
                  f"{', '.join(f'{k} {v:.2e}' for k, v in gerr.items())}")
            if not err <= IN_RTOL[dtype_name] * scale:
                fail(f"B3 {dtype_name} large mean x{shape}: max|err| {err} > "
                     f"{IN_RTOL[dtype_name]} x max|y| {scale}")
            for k, v in gerr.items():
                if not v <= IN_BWD_RTOL[dtype_name][k]:
                    fail(f"B3 backward kernel {k} {dtype_name} large mean x{shape}: {v} > "
                         f"{IN_BWD_RTOL[dtype_name][k]} of the largest value")
            s["err"] = max(s["err"], err)
            del x, y, yp, dy, got, want
        name = f"instance_norm_{'f32' if dtype_name == 'float32' else 'bf16'}"
        rows[dtype_name] = {
            "name": name, "route": "cuda",
            "source": "gan_class_transfer2_tpu_torch/csrc/instance_norm.cu",
            "replaces": "gan_class_transfer2_tpu/ops/norm.py:48", "launches": 0,
            "max_abs_err": s["err"], "ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"], "bound_by": "bytes", "library_ms": s["library_ms"]}
        rows[dtype_name + " backward"] = {
            "name": name.replace("norm", "norm_bwd"), "route": "cuda",
            "source": "gan_class_transfer2_tpu_torch/csrc/instance_norm.cu",
            "replaces": "none (gan_class_transfer2_tpu/ops/norm.py:109 is plain jnp)",
            "launches": 0, "max_abs_err": s["bwd_err"], "ms": s["bwd_ms"],
            "device_ms": s["bwd_dev_ms"], "plain_ms": s["bwd_plain_ms"],
            "bound_ms": 1.5 * s["bound_ms"], "bound_by": "bytes",
            "library_ms": s["lib_bwd_ms"]}
        torch.cuda.empty_cache()

    b4_err = {}
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        b4_err[dtype_name], worst, _, _ = b4_batch16(torch, fdc, gen, dtype_name, dtype,
                                                     relu=False, timed=False)
        print(f"[gan-kernel] B4 relu=False {dtype_name}, batch {TRAIN_BATCH}, four shapes: max "
              f"error relative to the largest value: y {worst['y']:.2e} (bound "
              f"{KERNEL_RTOL[dtype_name]}), dx {worst['dx']:.2e}, dK {worst['dK']:.2e}, db "
              f"{worst['db']:.2e} (bound {GRAD_RTOL[dtype_name]})")
    return rows, b4_err


def phase_gan(torch, cli, fdc, norm, gan, cfg, tmp):
    """The GAN slice through its entry point, ``cli profile --model gan``,
    at the default width (both generators the default U-Net, both
    discriminators the default, batch 16 per class, instance norms on,
    B4), float32 and bfloat16: exact B3 and B4 launch
    counts, finite losses, and the trace's breakdown; then the same step
    timed without the profiler, and ``gan.transfer`` at batch 4. Returns
    {dtype: (B3 launches, B4 launches), dtype + " backward": (B3 backward
    launches,)} of the main-path runs."""
    per_step, b4_step, (b3_fwd, b4_fwd) = gan_counts(fdc, cfg, TRAIN_BATCH)
    b3_step = sum(per_step.values())
    bwd_step = gan_bwd_launches(fdc, cfg, TRAIN_BATCH)
    steps = GAN_WARM + GAN_PROFILE_STEPS
    print(f"[gan] per step: {b3_step} B3 launches "
          f"({', '.join(f'{n}x{hw}²x{c}' for (hw, c), n in sorted(per_step.items()))}), "
          f"{b4_step} B4 launches; per generator forward {b3_fwd} B3, {b4_fwd} B4")
    width = [f"--{k.replace('_', '-')}={getattr(cfg, k)}"
             for k in ("size", "pixel_size", "max_size", "octaves")]
    launches = {}
    for dtype in ("float32", "bfloat16"):
        args = ["profile", "--device", "cuda", "--model", "gan", *width, "--batch-size",
                str(TRAIN_BATCH), "--compute-dtype", dtype, "--profile-steps",
                str(GAN_PROFILE_STEPS), "--trace-dir", os.path.join(tmp, f"gan-{dtype}"),
                *GAN_FLAGS]
        norm.instance_norm_fused.launches = fdc.down_conv_fused.launches = 0
        norm.instance_norm_bwd_fused.launches = 0
        graphs = norm.InstanceNorm.graph_backwards
        *rows, out = _cli_json(cli, args)  # kernel rows, then the summary line
        got = (norm.instance_norm_fused.launches, fdc.down_conv_fused.launches)
        want = (steps * b3_step, steps * b4_step)
        if got != want:
            fail(f"gan {dtype}: B3/B4 launches {got}, expected {want} "
                 f"({b3_step}/{b4_step} a step x {steps} steps)")
        bwd = norm.instance_norm_bwd_fused.launches
        graphs = norm.InstanceNorm.graph_backwards - graphs
        if bwd != steps * bwd_step or graphs:
            fail(f"gan {dtype}: B3 backward launches {bwd} (expected {steps * bwd_step}, "
                 f"{bwd_step} a step), torch-op backwards {graphs} (expected 0)")
        print(f"[gan] {dtype}: B3 backward {bwd} launches over {steps} steps ({bwd_step} a step "
              f"for {b3_step} norms), torch-op backwards {graphs}")
        launches[dtype] = got
        launches[dtype + " backward"] = (bwd,)
        final = out["final"]
        if not (np.isfinite(final["g_loss"]) and np.isfinite(final["d_loss"])):
            fail(f"gan {dtype}: losses {final}")
        busy, wall = out["device_busy_ms_per_step"], out["wall_ms_per_step"]
        print(f"[gan] {dtype}: launches B3/B4 {got} over {steps} steps; under the profiler "
              f"{wall:.3f} ms a step, {out['images_per_sec']:.3f} img/s per class, device busy "
              f"{busy:.3f} ms a step (idle {max(0.0, 1 - busy / wall):.1%}); g_loss "
              f"{final['g_loss']:.5f}, d_loss {final['d_loss']:.5f}")
        for r in rows[:8]:
            print(f"[gan]   {r['ms_per_step']:9.3f} ms x{r['calls']:<5d} {r['op'][:100]}")

        # the same step without the profiler, batches already on the card
        c = cfg.replace(batch_size=TRAIN_BATCH, compute_dtype=dtype, g_norm="instance",
                        d_norm="instance").validate()
        state = gan.init_gan_state(c, device="cuda")
        step = gan.make_gan_train_step(c)
        gen = torch.Generator(device="cuda").manual_seed(3)
        a, b = (torch.rand((TRAIN_BATCH, c.size, c.size, 3), generator=gen, device="cuda") * 2 - 1
                for _ in range(2))
        times = []
        for i in range(GAN_WARM + GAN_TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, a, b, gen)
            float(m["g_loss"])
            if i >= GAN_WARM:
                times.append((time.perf_counter() - t0) * 1e3)
        med = sorted(times)[len(times) // 2]
        print(f"[gan] {dtype}: without the profiler {med:.3f} ms a step (median of "
              f"{len(times)}: {[round(t, 3) for t in times]}), "
              f"{TRAIN_BATCH / med * 1e3:.3f} img/s per class; idle share against the "
              f"profile's busy time {max(0.0, 1 - busy / med):.1%}")

        # transfer at batch 4: one generator forward
        x = a[:4].contiguous()
        with torch.inference_mode():
            for _ in range(2):
                gan.transfer(c, state, x)
            norm.instance_norm_fused.launches = fdc.down_conv_fused.launches = 0
            y = gan.transfer(c, state, x)
            one = (norm.instance_norm_fused.launches, fdc.down_conv_fused.launches)
            if one != (b3_fwd, b4_fwd) or y.shape != x.shape or not torch.isfinite(y).all():
                fail(f"gan.transfer {dtype}: launches {one} (expected {(b3_fwd, b4_fwd)}), "
                     f"shape {tuple(y.shape)}")
            ms = cuda_ms(lambda: gan.transfer(c, state, x), reps=10)
        norm.instance_norm_fused.launches = fdc.down_conv_fused.launches = 0
        print(f"[gan] {dtype}: gan.transfer at batch 4: {ms / 4:.4f} ms per image "
              f"({ms:.4f} ms a call), launches B3/B4 {one} a call")
        del state, step, a, b, x, y
        torch.cuda.empty_cache()
    return launches


CYCLEGAN_STEPS = (2, 3, 5)  # warm, traced, timed


def cyclegan_norm_maps(cfg):
    """{(H=W, C): norms a step} of the CycleGAN step: a generator forward's
    stem, downs, two a residual block and ups (6 forwards a step), a
    discriminator apply's normed k4/s2 layers and its k4/s1 layer (6
    applies a step)."""
    downs = [(cfg.size >> i, cfg.pixel_size << i) for i in range(cfg.octaves + 1)]
    g = downs + [downs[-1]] * (2 * cfg.resnet_blocks) + downs[-2::-1]
    hw, d = cfg.size, []
    for i in range(cfg.d_octaves):
        hw >>= 1
        if i:
            d.append((hw, min(cfg.d_pixel_size << i, cfg.max_size)))
    d.append((hw - 1, min(cfg.d_pixel_size << cfg.d_octaves, cfg.max_size)))
    maps = {}
    for m in g + d:
        maps[m] = maps.get(m, 0) + 6
    return maps


def phase_cyclegan_kernels(torch, F, fdc, norm, cfg):
    """B3 without γ, β (``instance_norm_fused(x, None, None)``,
    ``instance_norm_bwd_fused(x, None, dy, need_affine=False)``) against
    ``instance_norm_plain`` and ``_in_bwd`` at every distinct norm map of the
    CycleGAN step at batch 16, float32 and bfloat16, at IN_RTOL and
    IN_BWD_RTOL; the Function's dx against autograd through the plain
    version at IN_GRAD_RTOL; then B4 with ``relu=False`` at the PatchGAN's
    C256 input (16, 64, 64, 128) -> 256 against the plain conv. Returns
    (the bfloat16 forward and backward rows of the kernels line, times summed
    over the step's norms, without launches; B4's max|err| by dtype)."""
    maps = cyclegan_norm_maps(cfg)
    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = {}
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        s = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bwd_ms=0.0, bwd_dev_ms=0.0,
                 bwd_plain_ms=0.0, lib_bwd_ms=0.0, err=0.0, bwd_err=0.0)
        worst = {"y": 0.0, "dx": 0.0, "dx kernel": 0.0}
        for (hw, c), n in sorted(maps.items(), reverse=True):
            shape = (TRAIN_BATCH, hw, hw, c)
            x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 2).to(dtype)
            dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            before = norm.instance_norm_fused.launches
            before_bwd = norm.instance_norm_bwd_fused.launches
            y = norm.instance_norm_fused(x, None, None)
            yp = norm.instance_norm_plain(x, None, None)
            err = (y.float() - yp.float()).abs().max().item()
            scale = yp.float().abs().max().item()
            if not err <= IN_RTOL[dtype_name] * scale:
                fail(f"B3 without affine {dtype_name} x{shape}: max|err| {err} > "
                     f"{IN_RTOL[dtype_name]} x max|y| {scale}")
            worst["y"] = max(worst["y"], err / scale)
            s["err"] = max(s["err"], err)
            xl = [x.clone().requires_grad_() for _ in range(2)]
            got = torch.autograd.grad(norm.instance_norm(xl[0], None, None), xl[0], dy)[0]
            want = torch.autograd.grad(norm.instance_norm_plain(xl[1], None, None), xl[1], dy)[0]
            gerr = (got.float() - want.float()).abs().max().item()
            gscale = want.float().abs().max().item()
            if not gerr <= IN_GRAD_RTOL[dtype_name] * gscale:
                fail(f"B3 without affine dx {dtype_name} x{shape}: max|err| {gerr} > "
                     f"{IN_GRAD_RTOL[dtype_name]} x max|dx| {gscale}")
            worst["dx"] = max(worst["dx"], gerr / gscale)
            got = norm.instance_norm_bwd_fused(x, None, dy, need_affine=False)
            want = norm._in_bwd(x, None, dy)[0]
            if got[1] is not None or got[2] is not None:
                fail(f"B3 backward kernel without affine {dtype_name} x{shape}: dγ, dβ returned")
            gerr = (got[0].float() - want.float()).abs().max().item()
            gscale = want.float().abs().max().item()
            if not gerr <= IN_BWD_RTOL[dtype_name]["dx"] * gscale:
                fail(f"B3 backward kernel without affine dx {dtype_name} x{shape}: max|err| "
                     f"{gerr} > {IN_BWD_RTOL[dtype_name]['dx']} x max|dx| {gscale}")
            worst["dx kernel"] = max(worst["dx kernel"], gerr / gscale)
            s["bwd_err"] = max(s["bwd_err"], gerr)
            ms = cuda_ms(lambda: norm.instance_norm_fused(x, None, None))
            plain_ms = cuda_ms(lambda: norm.instance_norm_plain(x, None, None))
            xn = x.permute(0, 3, 1, 2)  # the library's call on the NCHW view
            lib_ms = cuda_ms(lambda: F.instance_norm(xn, eps=1e-5))
            bwd_ms = cuda_ms(lambda: norm.instance_norm_bwd_fused(x, None, dy, need_affine=False))
            bwd_dev_ms = queued_ms(lambda: norm.instance_norm_bwd_fused(x, None, dy,
                                                                         need_affine=False))
            bwd_plain_ms = cuda_ms(lambda: norm._in_bwd(x, None, dy))
            lib_in = xn.detach().requires_grad_()
            lib_out = F.instance_norm(lib_in, eps=1e-5)
            dy_l = dy.permute(0, 3, 1, 2)
            lib_bwd_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, lib_in, dy_l,
                                                             retain_graph=True))
            # comparison launches do not count
            norm.instance_norm_fused.launches = before
            norm.instance_norm_bwd_fused.launches = before_bwd
            bound = _bytes_ms(2 * x.numel() * x.element_size())  # x in, y out
            print(f"[cyclegan-kernel] B3 without affine {dtype_name} x{shape} (x{n} a step): "
                  f"max|err| {err:.3e} (max|y| {scale:.3f}); kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, F.instance_norm {lib_ms:.4f} ms, bound {bound:.4f} ms; "
                  f"backward kernel {bwd_ms:.4f} ms, device {bwd_dev_ms:.4f} ms, dx max|err| "
                  f"{gerr:.3e} (max|dx| {gscale:.3f}), plain {bwd_plain_ms:.4f} ms, "
                  f"F.instance_norm's backward {lib_bwd_ms:.4f} ms")
            for k, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                         ("bound_ms", bound), ("bwd_ms", bwd_ms), ("bwd_dev_ms", bwd_dev_ms),
                         ("bwd_plain_ms", bwd_plain_ms), ("lib_bwd_ms", lib_bwd_ms)):
                s[k] += n * v
            del x, dy, y, yp, xl, got, want, xn, lib_in, lib_out, dy_l
        print(f"[cyclegan-kernel] B3 without affine {dtype_name}: {sum(maps.values())} norms a "
              f"step over {len(maps)} maps; max error relative to the largest value: y "
              f"{worst['y']:.2e} (bound {IN_RTOL[dtype_name]}), the Function's dx "
              f"{worst['dx']:.2e} (bound {IN_GRAD_RTOL[dtype_name]}), the backward kernel's dx "
              f"against _in_bwd {worst['dx kernel']:.2e} (bound "
              f"{IN_BWD_RTOL[dtype_name]['dx']}); a step's norms: kernel {s['ms']:.4f} ms, "
              f"plain {s['plain_ms']:.4f} ms, bound {s['bound_ms']:.4f} ms; backward kernel "
              f"{s['bwd_ms']:.4f} ms, device {s['bwd_dev_ms']:.4f} ms, plain "
              f"{s['bwd_plain_ms']:.4f} ms, bound {1.5 * s['bound_ms']:.4f} ms")
        torch.cuda.empty_cache()
        if dtype_name != "bfloat16":  # the cell's path runs bfloat16 alone
            continue
        rows[dtype_name] = {
            "name": "instance_norm_bf16_no_affine", "route": "cuda",
            "source": "gan_class_transfer2_tpu_torch/csrc/instance_norm.cu",
            "replaces": "gan_class_transfer2_tpu/ops/norm.py:48", "launches": 0,
            "max_abs_err": s["err"], "ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"], "bound_by": "bytes", "library_ms": s["library_ms"]}
        rows[dtype_name + " backward"] = {
            "name": "instance_norm_bwd_bf16_no_affine", "route": "cuda",
            "source": "gan_class_transfer2_tpu_torch/csrc/instance_norm.cu",
            "replaces": "none (gan_class_transfer2_tpu/ops/norm.py:109 is plain jnp)",
            "launches": 0, "max_abs_err": s["bwd_err"], "ms": s["bwd_ms"],
            "device_ms": s["bwd_dev_ms"], "plain_ms": s["bwd_plain_ms"],
            "bound_ms": 1.5 * s["bound_ms"], "bound_by": "bytes",
            "library_ms": s["lib_bwd_ms"]}
    b4_err = {}
    b4_shape = (cfg.size >> 2, cfg.d_pixel_size << 1, cfg.d_pixel_size << 2)  # D's C256 input
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        b4_err[dtype_name], worst, _, _ = b4_batch16(torch, fdc, gen, dtype_name, dtype,
                                                     relu=False, timed=False, shapes=(b4_shape,))
        hw, c, o = b4_shape
        print(f"[cyclegan-kernel] B4 relu=False {dtype_name} x{(TRAIN_BATCH, hw, hw, c)}->{o}: "
              f"max error relative to the largest value: y "
              f"{worst['y']:.2e} (bound {KERNEL_RTOL[dtype_name]}), dx {worst['dx']:.2e}, dK "
              f"{worst['dK']:.2e}, db {worst['db']:.2e} (bound {GRAD_RTOL[dtype_name]})")
    return rows, b4_err


def cyclegan_config():
    """The benchmark cell's configuration (``perfbench/configs/cyclegan-r9-256
    .json``) at batch 16 a class."""
    from gan_class_transfer2_tpu_torch.config import Config

    return Config(size=256, pixel_size=64, max_size=512, octaves=2, generator="resnet",
                  resnet_blocks=9, g_norm="instance", d_layout="patchgan70", d_pixel_size=64,
                  d_octaves=3, d_norm="instance", image_pool=50, gan_loss="lsgan",
                  identity_weight=5.0, optimizer="adam", learning_rate=2e-4, adam_b1=0.5,
                  adam_eps=1e-8, lr_schedule="constant", warm_up=0, compute_dtype="bfloat16",
                  batch_size=TRAIN_BATCH).validate()


def phase_cyclegan(torch, fdc, norm, gan, cfg):
    """The published CycleGAN's step at the cell's shapes (``[cyclegan]`` in
    the module docstring). Returns {"bfloat16": (B3 launches, B4
    launches), "bfloat16 backward": (B3 backward launches,)} of the
    main-path steps."""
    from gan_class_transfer2_tpu_torch.utils import profiler

    # every norm without affine has one backward launch
    b3_step = sum(cyclegan_norm_maps(cfg).values())
    c, b4_apply = 3, 0
    for i in range(cfg.d_octaves):
        f, hw = min(cfg.d_pixel_size * 2**i, cfg.max_size), cfg.size >> i
        b4_apply += fdc.supported((TRAIN_BATCH, hw, hw, c), (4, 4, c, f))
        c = f
    b4_step = 6 * b4_apply
    warm, traced, timed = CYCLEGAN_STEPS
    gen = torch.Generator(device="cuda").manual_seed(5)
    batches = [(torch.rand((TRAIN_BATCH, 286, 286, 3), generator=gen, device="cuda") * 255
                ).to(torch.uint8) for _ in range(2)]
    torch.cuda.reset_peak_memory_stats()
    state = gan.init_gan_state(cfg, device="cuda")
    step = gan.make_gan_train_step(cfg)
    for _ in range(warm):
        state, m = step(state, *batches, gen)
    float(m["g_loss"])
    counters = (norm.instance_norm_fused, norm.instance_norm_bwd_fused, fdc.down_conv_fused)
    for fn in counters:
        fn.launches = 0
    graphs = norm.InstanceNorm.graph_backwards
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cyclegan_") as tmp:
        with profiler.trace(tmp) as prof:
            for _ in range(traced):
                state, m = step(state, *batches, gen)
            loss = float(m["g_loss"]), float(m["d_loss"])
        torch.cuda.synchronize()
        recs = profiler.spans()
        rows = profiler.device_ops(prof, top=10)
        busy = profiler.device_busy_ms(prof) / traced
    got = tuple(fn.launches for fn in counters)
    want = (traced * b3_step, traced * b3_step, traced * b4_step)
    graphs = norm.InstanceNorm.graph_backwards - graphs
    if got != want or graphs:
        fail(f"cyclegan: B3 forward/backward and B4 launches {got}, expected {want} "
             f"({b3_step}/{b3_step}/{b4_step} a step x {traced}); torch-op backwards {graphs}")
    if not all(np.isfinite(loss)):
        fail(f"cyclegan: losses {loss}")
    trunks = [r["device_ms"] for r in recs if r["name"] == "resnet.trunk"]
    if len(trunks) != 6 * traced:
        fail(f"cyclegan: {len(trunks)} resnet.trunk spans over {traced} steps, expected "
             f"{6 * traced}")
    pool = profiler.counters()
    print(f"[cyclegan] bfloat16 batch {TRAIN_BATCH} a class: B3 {b3_step} forward and "
          f"{b3_step} backward launches a step (no dγ, dβ), B4 {b4_step} a step, "
          f"InstanceNorm.graph_backwards {graphs}; losses g {loss[0]:.5f} d {loss[1]:.5f}; "
          f"pool counters {pool}")
    print(f"[cyclegan] traced: resnet.trunk {sum(trunks) / traced:.3f} device ms a step "
          f"(6 spans), device busy {busy:.3f} ms a step")
    for r in rows:
        print(f"[cyclegan]   {r['ms'] / traced:9.3f} ms x{r['calls'] // traced:<5d} "
              f"{r['op'][:100]}")
    times = []
    for _ in range(timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, *batches, gen)
        float(m["g_loss"])
        times.append((time.perf_counter() - t0) * 1e3)
    med = sorted(times)[len(times) // 2]
    print(f"[cyclegan] without the profiler {med:.3f} ms a step (median of {timed}: "
          f"{[round(t, 3) for t in times]}), {2 * TRAIN_BATCH / med * 1e3:.3f} img/s; "
          f"idle share against the trace's busy time {max(0.0, 1 - busy / med):.1%}; "
          f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    del state, step, batches
    torch.cuda.empty_cache()
    return {"bfloat16": (got[0], got[2]), "bfloat16 backward": (got[1],)}


def _instance_norm_f64(x, gamma, beta):
    """Instance norm in x's dtype (float64 for the reference step):
    two-pass statistics, no rounding to float32 anywhere."""
    m = x.mean(dim=(1, 2), keepdim=True)
    v = (x - m).square().mean(dim=(1, 2), keepdim=True)
    return (x - m) * (v + 1e-5).rsqrt() * gamma.to(x.dtype) + beta.to(x.dtype)


def _no_kernel(t):
    """``ops/conv._kernels_take`` for the plain and float64 sides of
    [gan-agree] and [cgan-agree]: every conv's tail in torch ops and every
    down conv through cuDNN (the kernels take no float64)."""
    return False


def phase_gan_agree(torch, fdc, norm, gan, cfg):
    """One full-width GAN step from the same initial state and batches,
    under ``optimizer="sgd"`` so that each update is −lr times the gradient,
    three ways: as the entry point runs it in float32 (B3, B4, the conv
    epilogue), through cuDNN with the plain instance norm and torch-op conv
    tails in float32 (``norm.instance_norm`` swapped for its plain version,
    ``ops/conv._kernels_take`` for a gate that takes no kernel), and that
    plain path in float64 (the reference; the losses and D's logits stay
    float32 as the step casts them). The plain side stays on the card: the
    bounds are relative to its distance from float64, which is cuDNN's, and
    the CPU's float32 convs sit closer (the cGAN's discriminator 7.2e-6
    against the card's 3.7e-5 rms). Both float32 paths sit at float32's own
    distance from the float64 update, ~1e-4 of G's largest update and
    ~1e-3 of D's (at this state D's gradient is a difference of nearly
    equal real and fake terms), and that distance moves between runs
    (cuDNN's weight gradients sum in a varying order), and differs between
    the two nets of a kind by up to 10× (a few elements carry it). Bounds:
    g_loss and d_loss of the two float32 paths within 1e-5 relative; for
    each kind of net (the two generators, the two discriminators), the
    kernel path's largest distance from the float64 update, in root mean
    square and at the largest element, at most 2× and 4× the plain float32
    path's largest over that kind, plus 1e-6; distances relative to each
    net's largest float64 update."""
    from gan_class_transfer2_tpu_torch.models import unet
    from gan_class_transfer2_tpu_torch.ops import conv as conv_ops

    c = cfg.replace(batch_size=TRAIN_BATCH, g_norm="instance", d_norm="instance",
                    optimizer="sgd", lr_schedule="constant", learning_rate=1e-2).validate()
    r = np.random.default_rng(12)
    a, b = (torch.from_numpy(r.uniform(-1, 1, (TRAIN_BATCH, c.size, c.size, 3))
                             .astype(np.float32)).cuda() for _ in range(2))
    nets = ("g_ab", "g_ba", "d_a", "d_b")
    out = {}
    for path in ("kernels", "plain", "float64"):
        state = gan.init_gan_state(c, torch.Generator().manual_seed(0), device="cuda")
        xa, xb = a, b
        kernel_op, f32, takes = norm.instance_norm, unet.DTYPES["float32"], conv_ops._kernels_take
        if path != "kernels":  # the modules read both at each call
            conv_ops._kernels_take = _no_kernel
        if path == "plain":
            norm.instance_norm = norm.instance_norm_plain
        if path == "float64":
            norm.instance_norm = _instance_norm_f64
            unet.DTYPES["float32"] = torch.float64  # the models' compute dtype
            for n in nets:
                getattr(state, n).double()
            state = state._replace(g_opt=gan.make_optimizer(c).init(gan.g_params(state)),
                                   d_opt=gan._d_optimizer(c).init(gan.d_params(state)))
            xa, xb = a.double(), b.double()
        before = {n: [p.detach().clone() for p in getattr(state, n).parameters()] for n in nets}
        norm.instance_norm_fused.launches = fdc.down_conv_fused.launches = 0
        try:
            state, m = gan.make_gan_train_step(c)(state, xa, xb, torch.Generator(device="cuda"))
            torch.cuda.synchronize()
        finally:
            norm.instance_norm, unet.DTYPES["float32"] = kernel_op, f32
            conv_ops._kernels_take = takes
        launched = (norm.instance_norm_fused.launches, fdc.down_conv_fused.launches)
        norm.instance_norm_fused.launches = fdc.down_conv_fused.launches = 0
        per_step, b4_step, _ = gan_counts(fdc, c, TRAIN_BATCH)
        want = (sum(per_step.values()), b4_step) if path == "kernels" else (0, 0)
        if launched != want:
            fail(f"gan-agree {path}: B3/B4 launches {launched}, expected {want}")
        deltas = {n: [(p.detach() - q).double() for p, q in
                      zip(getattr(state, n).parameters(), before[n])] for n in nets}
        out[path] = ({k: float(v) for k, v in m.items()}, deltas)
        del state, before
        torch.cuda.empty_cache()
    (mk, dk), (mp, dp), (m64, d64) = out["kernels"], out["plain"], out["float64"]
    rel = {k: abs(mk[k] - mp[k]) / abs(mp[k]) for k in ("g_loss", "d_loss")}

    def dist(x, y, n):
        """(rms, max) of x − y over net n, relative to its largest float64 update."""
        largest = max(t.abs().max().item() for t in d64[n])
        sq = sum((u - v).square().sum().item() for u, v in zip(x[n], y[n]))
        count = sum(u.numel() for u in x[n])
        top = max((u - v).abs().max().item() for u, v in zip(x[n], y[n]))
        return (sq / count) ** 0.5 / largest, top / largest

    ok = max(rel.values()) <= 1e-5
    report = []
    for kind in (("g_ab", "g_ba"), ("d_a", "d_b")):
        k = [dist(dk, d64, n) for n in kind]
        p = [dist(dp, d64, n) for n in kind]
        k_rms, k_max = max(x[0] for x in k), max(x[1] for x in k)
        p_rms, p_max = max(x[0] for x in p), max(x[1] for x in p)
        ok = ok and k_rms <= 2 * p_rms + 1e-6 and k_max <= 4 * p_max + 1e-6
        for n, (kr, km), (pr, pm) in zip(kind, k, p):
            report.append(f"{n} rms {kr:.2e} / {pr:.2e}, max {km:.2e} / {pm:.2e} "
                          f"(kernels − plain max {dist(dk, dp, n)[1]:.2e})")
    print(f"[gan-agree] one step, {c.size}², batch {TRAIN_BATCH}, sgd lr {c.learning_rate}: "
          f"g_loss kernels {mk['g_loss']:.7f} plain {mp['g_loss']:.7f} float64 "
          f"{m64['g_loss']:.7f} (kernels vs plain rel {rel['g_loss']:.2e}), d_loss "
          f"{mk['d_loss']:.7f} / {mp['d_loss']:.7f} / {m64['d_loss']:.7f} (rel "
          f"{rel['d_loss']:.2e}), bound 1e-5; updates, distance from the float64 update "
          f"over the net's largest float64 update, kernels / plain: {'; '.join(report)} "
          f"(bound, per kind of net: kernels ≤ 2 × plain in rms, 4 × plain at the max, "
          f"+ 1e-6)")
    if not ok:
        fail(f"GAN kernel path less accurate than the plain path: losses {rel}, {report}")


def phase_gan_reference(torch, fdc, norm, gan):
    """A tiny GAN config (no diffaug, float batches: the step draws
    nothing) whose discriminators reach B4 (128 channels), 3 steps on the
    card and on the CPU from the same weights: the losses agree within 1e-4
    relative (IEEE float32 on both; the CPU runs the plain versions, the
    card the kernels)."""
    from gan_class_transfer2_tpu_torch.config import tiny_test_config

    cfg = tiny_test_config(g_norm="instance", d_norm="instance", size=32, d_pixel_size=128,
                           max_size=256, d_octaves=2, lr_schedule="constant", learning_rate=1e-4)
    r = np.random.default_rng(13)
    batches = [tuple(torch.from_numpy(r.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32))
                     for _ in range(2)) for _ in range(3)]
    per_step, b4_step, _ = gan_counts(fdc, cfg, 2)
    losses = {}
    for dev in ("cpu", "cuda"):
        state = gan.init_gan_state(cfg, torch.Generator().manual_seed(0), device=dev)
        step = gan.make_gan_train_step(cfg)
        norm.instance_norm_fused.launches = fdc.down_conv_fused.launches = 0
        losses[dev] = []
        for a, b in batches:
            state, m = step(state, a.to(dev), b.to(dev), torch.Generator(device=dev))
            losses[dev] += [float(m["g_loss"]), float(m["d_loss"])]
        launched = (norm.instance_norm_fused.launches, fdc.down_conv_fused.launches)
        norm.instance_norm_fused.launches = fdc.down_conv_fused.launches = 0
        want = (0, 0) if dev == "cpu" else (3 * sum(per_step.values()), 3 * b4_step)
        if launched != want:
            fail(f"gan-reference on {dev}: B3/B4 launches {launched}, expected {want}")
    rel = max(abs(x - y) / abs(y) for x, y in zip(losses["cuda"], losses["cpu"]))
    print(f"[gan-reference] tiny GAN, 3 steps, card vs CPU: g/d losses card "
          f"{[round(v, 7) for v in losses['cuda']]} CPU {[round(v, 7) for v in losses['cpu']]}; "
          f"max relative diff {rel:.3e} (bound 1e-4)")
    if not rel <= 1e-4:
        fail(f"tiny GAN training on the card differs from the CPU by {rel} relative")


def phase_gan_train_cli(torch, cli, fdc, norm, cfg, tmp, globs):
    """The user's GAN training command, ``cli.main(["gan-train", ...])``,
    on the two class folders of PNGs (circles → crosses) streamed from
    disk, at the default width with GAN_FLAGS, float32, batch 16 per class,
    CLI_STEPS steps, one checkpoint and one ``log_sample`` (three
    transfers of a fixed batch): exact B3/B4 launches, finite losses, the
    transfer tags, the checkpoint. Returns (B3, B4) launches."""
    from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt_lib

    c = cfg.replace(batch_size=TRAIN_BATCH, g_norm="instance", d_norm="instance")
    per_step, b4_step, (b3_fwd, b4_fwd) = gan_counts(fdc, c, TRAIN_BATCH)
    want = (CLI_STEPS * sum(per_step.values()) + 3 * b3_fwd, CLI_STEPS * b4_step + 3 * b4_fwd)
    args = ["gan-train", "--device", "cuda", *_width(cfg, ("size", "pixel_size", "max_size",
                                                           "octaves")),
            *GAN_FLAGS, "--compute-dtype", "float32", "--batch-size", str(TRAIN_BATCH),
            "--classes", *globs, "--steps-per-epoch", str(CLI_STEPS), "--epochs", "1",
            "--checkpoint-every", str(CLI_STEPS), "--checkpoint-keep", "1",
            "--data-workers", "2", "--native-loader", "false",
            "--log-dir", os.path.join(tmp, "logs-gan"),
            "--checkpoint-dir", os.path.join(tmp, "ckpt-gan")]
    got, secs = _run_cli(cli, (norm.instance_norm_fused, fdc.down_conv_fused), args)
    if got != want:
        fail(f"gan-train-cli: launches B3/B4 {got}, expected {want} ({CLI_STEPS} steps and 3 "
             f"generator forwards in log_sample)")
    ev = _events(os.path.join(tmp, "logs-gan"))
    missing = [t for t in ("transfer_ab/image/0", "transfer_ba/image/0", "cycle_aba/image/0",
                           "g_loss", "d_loss", "cycle", "images_per_sec") if t not in ev]
    if missing:
        fail(f"gan-train-cli: the event file lacks {missing}")
    vals = {k: ev[k][0][1] for k in ("g_loss", "d_loss", "cycle", "images_per_sec")}
    if not all(np.isfinite(v) for v in vals.values()):
        fail(f"gan-train-cli: {vals}")
    if ckpt_lib.all_steps(os.path.join(tmp, "ckpt-gan")) != [CLI_STEPS]:
        fail("gan-train-cli: no checkpoint at the last step")
    print(f"[gan-train-cli] fp32, {CLI_STEPS} steps at batch {TRAIN_BATCH} per class from PNG "
          f"files + one log_sample: launches B3/B4 {got}; g_loss {vals['g_loss']:.5f}, d_loss "
          f"{vals['d_loss']:.5f}, cycle {vals['cycle']:.5f}; {vals['images_per_sec']:.3f} img/s "
          f"per class; checkpoint step {CLI_STEPS}; wall {secs:.2f} s")
    torch.cuda.empty_cache()
    return got


# ------------------------------------------------------------------ eval


def phase_eval(torch, cli, fdc, norm, sampler, cfg, tmp):
    """The user's ``cli.main(["eval", ...])``: ``--model diffusion`` on
    [train-cli]'s checkpoint (its config: the default width, T = 200, stride
    50, fid_samples EVAL_SAMPLES), exactly ``len(sample_timesteps)`` denoiser
    calls of B4 launches and a finite fid and kid; ``--model gan`` on
    [gan-train-cli]'s checkpoint with ``--fid-samples EVAL_SAMPLES``, two
    generator forwards (A→B, B→A) of exact B3/B4 launches and finite
    transfer scores. Then the trained extractor's features of 16 images at
    256² on the card against the CPU (within 1e-4 relative: IEEE float32
    convolutions in other orders), and ``run_sampler_benchmark`` at batch 16
    in float32 and bfloat16. Returns the eval commands' (B3, B4) launches."""
    from gan_class_transfer2_tpu_torch.utils import benchmark
    from gan_class_transfer2_tpu_torch.utils import fid_extractor as fx

    t_phase = time.perf_counter()
    sample_calls = len(sampler.sample_timesteps(cfg.replace(sample_stride=50)))
    results = {}
    counters = (norm.instance_norm_fused, fdc.down_conv_fused)
    c = cfg.replace(batch_size=TRAIN_BATCH, g_norm="instance", d_norm="instance")
    _, _, (b3_fwd, b4_fwd) = gan_counts(fdc, c, EVAL_SAMPLES)
    wants = {"diffusion": (0, sample_calls * b4_per_call(fdc, cfg, EVAL_SAMPLES)),
             "gan": (2 * b3_fwd, 2 * b4_fwd)}
    total = [0, 0]
    for model, ckpt, extra in (("diffusion", "ckpt-cli", []),
                               ("gan", "ckpt-gan", ["--fid-samples", str(EVAL_SAMPLES)])):
        for k in counters:
            k.launches = 0
        t0 = time.perf_counter()
        out = _cli_json(cli, ["eval", "--device", "cuda", "--model", model,
                              "--checkpoint-dir", os.path.join(tmp, ckpt), *extra])[-1]
        secs = time.perf_counter() - t0
        got = tuple(k.launches for k in counters)
        if got != wants[model]:
            fail(f"eval {model}: launches B3/B4 {got}, expected {wants[model]}")
        keys = ("fid", "kid") if model == "diffusion" else (
            "transfer_fid_ab", "transfer_kid_ab", "transfer_fid_ba", "transfer_kid_ba")
        if not all(np.isfinite(out.get(k, np.nan)) for k in keys):
            fail(f"eval {model}: {out}")
        total = [t + g for t, g in zip(total, got)]
        results[model] = out
        print(f"[eval] cli eval --model {model} (step {out['step']}, fid_samples "
              f"{EVAL_SAMPLES}): {json.dumps({k: out[k] for k in keys})}; launches B3/B4 {got}; "
              f"wall {secs:.2f} s")

    x = np.random.default_rng(0).uniform(-1, 1, (16, 256, 256, 3)).astype(np.float32)
    cpu = fx.trained_features(torch.from_numpy(x)).numpy()
    card = fx.trained_features(torch.from_numpy(x).cuda()).cpu().numpy()
    rel = float(np.abs(card - cpu).max() / np.abs(cpu).max())
    print(f"[eval] trained extractor features, 16 images 256² -> 256: card vs CPU max "
          f"{rel:.3e} relative to max|feature| (bound 1e-4)")
    if not rel <= 1e-4:
        fail(f"eval: the extractor's features on the card differ by {rel} relative")

    for dtype in ("float32", "bfloat16"):
        fdc.down_conv_fused.launches = 0
        res = benchmark.run_sampler_benchmark(
            cfg.replace(compute_dtype=dtype, sample_stride=50),
            batch=TRAIN_BATCH, iters=3, device="cuda")
        print(f"[eval] run_sampler_benchmark {dtype}, batch {TRAIN_BATCH}, stride 50: "
              f"{json.dumps(res)}")
    fdc.down_conv_fused.launches = 0  # the benchmark is not the main path's count
    print(f"[eval] the phase took {time.perf_counter() - t_phase:.2f} s")
    torch.cuda.empty_cache()
    return tuple(total)


# ------------------------------------- InceptionV3 FID, steps-to-fixed-FID


INCEPTION_BATCH = 32  # [inception]: images of 256² per pool3 call


def phase_inception(torch, cli, fdc, sampler, tmp, card):
    """InceptionV3 pool3 (utils/inception.py) on the card: the seeded
    synthetic state dict (no real weights exist here; a draw, not a
    download) written as .npz and .pth in ``tmp``, both loading to equal
    folded parameters; pool3 of INCEPTION_BATCH 256² images (upsampled to
    299²) on the card, inside the ieee_fp32 region, against the port on the
    CPU within 1e-4 of the features' scale, both variants; ms per image
    against the bound (its FLOPs counted by ``profiler.compiled_stats``,
    fp32 without TF32 at 67 TFLOP/s); then ``cli eval --fid-extractor
    inception:<npz>`` on [train-cli]'s checkpoint at fid_samples
    EVAL_SAMPLES: exact B4 launches, finite FID and KID. Returns (the npz
    path, the eval's B4 launches)."""
    from gan_class_transfer2_tpu_torch.utils import inception, profiler

    t_phase = time.perf_counter()
    sd = inception.synthetic_state_dict(0)
    npz, pth = os.path.join(tmp, "inception.npz"), os.path.join(tmp, "inception.pth")
    np.savez(npz, **sd)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
    a, b = inception.load_params(npz), inception.load_params(pth)
    if any(not torch.equal(a[n][k], b[n][k]) for n in a for k in ("kernel", "bias")):
        fail("inception: the .npz and the .pth fold to different parameters")
    on_card = {n: {k: v.cuda() for k, v in p.items()} for n, p in a.items()}
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        -1, 1, (INCEPTION_BATCH, 256, 256, 3)).astype(np.float32))
    xc = x.cuda()
    errs = {}
    for variant in ("fid", "torchvision"):
        want = inception.pool3_features(a, x, variant).numpy()
        got = inception.pool3_features(on_card, xc, variant).cpu().numpy()
        if got.shape != (INCEPTION_BATCH, inception.POOL3_DIM) or not np.isfinite(got).all():
            fail(f"inception: {variant} features {got.shape}, finite {np.isfinite(got).all()}")
        errs[variant] = float(np.abs(got - want).max() / np.abs(want).max())
        if not errs[variant] <= 1e-4:
            fail(f"inception: {variant} pool3 card vs CPU {errs[variant]:.3e} of the scale "
                 "(bound 1e-4)")
    flops = profiler.compiled_stats(lambda v: inception.pool3_features(on_card, v),
                                    xc[:1])["flops"]
    ms = cuda_ms(lambda: inception.pool3_features(on_card, xc), reps=5, warmup=2)
    bound = flops / PEAK_FLOPS["float32"] * 1e3
    print(f"[inception] pool3 of {INCEPTION_BATCH} 256² images (resized to 299²), synthetic "
          f"state dict (seed 0; .npz = .pth): card vs CPU {errs['fid']:.3e} (fid) / "
          f"{errs['torchvision']:.3e} (torchvision) of the scale (bound 1e-4); "
          f"{ms / INCEPTION_BATCH:.4f} ms an image, fp32 IEEE (cuDNN), against a bound of "
          f"{bound:.4f} ms ({flops / 1e9:.3f} GFLOP an image counted by compiled_stats, at "
          f"67 TFLOP/s; {bound * INCEPTION_BATCH / ms:.1%} of it) on {card}")
    del on_card, xc

    ckpt = os.path.join(tmp, "ckpt-cli")
    from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt_lib

    dcfg = ckpt_lib.load_config(ckpt)
    calls = len(sampler.sample_timesteps(dcfg))
    want = calls * b4_per_call(fdc, dcfg, EVAL_SAMPLES)
    fdc.down_conv_fused.launches = 0
    t0 = time.perf_counter()
    out = _cli_json(cli, ["eval", "--device", "cuda", "--checkpoint-dir", ckpt,
                          "--fid-samples", str(EVAL_SAMPLES), "--fid-extractor",
                          f"inception:{npz}"])[-1]
    secs = time.perf_counter() - t0
    got = fdc.down_conv_fused.launches
    if got != want or not (np.isfinite(out.get("fid", np.nan))
                           and np.isfinite(out.get("kid", np.nan))):
        fail(f"inception: cli eval --fid-extractor inception: {out}; B4 {got}, expected {want} "
             f"({calls} calls)")
    print(f"[inception] cli eval --fid-extractor inception:<npz> on [train-cli]'s checkpoint "
          f"(step {out['step']}, fid_samples {EVAL_SAMPLES}): fid {out['fid']:.4f}, kid "
          f"{out['kid']:.4f}; B4 {got}; wall {secs:.2f} s; the phase took "
          f"{time.perf_counter() - t_phase:.2f} s")
    torch.cuda.empty_cache()
    return npz, got


def phase_fid_steps(torch, fdc, norm, cfg, tmp, globs, npz, card):
    """BASELINE.json's second headline metric through
    ``utils/benchmark.steps_to_fixed_fid``: a full-width ``GANRunner`` (two
    default generators and discriminators, instance norms, B4, fp32, batch
    16 a class) on [gan-train-cli]'s class PNGs, EVAL_SAMPLES held-out
    files a class, the InceptionV3 extractor of [inception]'s npz; target
    0, max_steps 4, check_every 2. It must return (None, a finite FID)
    at step 4, with exact B3/B4 launches (4 GAN steps, and one generator
    forward of the 16 held-out images for each of the 3 scores). Returns
    (B3, B4)."""
    from gan_class_transfer2_tpu_torch.train.gan_loop import GANRunner
    from gan_class_transfer2_tpu_torch.utils import benchmark

    c = cfg.replace(batch_size=TRAIN_BATCH, g_norm="instance", d_norm="instance",
                    classes=tuple(globs), fid_samples=EVAL_SAMPLES,
                    fid_extractor=f"inception:{npz}", checkpoint_dir=None,
                    log_dir=os.path.join(tmp, "logs-fid-steps"), native_loader=False,
                    data_workers=2).validate()
    per_step, b4_step, _ = gan_counts(fdc, c, TRAIN_BATCH)
    _, _, (b3_fwd, b4_fwd) = gan_counts(fdc, c, EVAL_SAMPLES)
    want = (4 * sum(per_step.values()) + 3 * b3_fwd, 4 * b4_step + 3 * b4_fwd)
    runner = GANRunner(c, device="cuda")
    try:
        counters = (norm.instance_norm_fused, fdc.down_conv_fused)
        for k in counters:
            k.launches = 0
        t0 = time.perf_counter()
        steps, fid = benchmark.steps_to_fixed_fid(runner, 0.0, max_steps=4, check_every=2)
        secs = time.perf_counter() - t0
        got = tuple(k.launches for k in counters)
        step = int(runner.state.step)
    finally:
        runner.close()
    if steps is not None or not np.isfinite(fid) or step != 4:
        fail(f"fid-steps: steps_to_fixed_fid gave ({steps}, {fid}) at step {step}")
    if got != want:
        fail(f"fid-steps: launches B3/B4 {got}, expected {want}")
    print(f"[fid-steps] steps_to_fixed_fid(target 0, max_steps 4, check_every 2) on a "
          f"full-width GANRunner, InceptionV3 extractor (synthetic weights): ({steps}, "
          f"{fid:.4f}) at step {step}; launches B3/B4 {got}; wall {secs:.2f} s (4 GAN steps, 3 "
          f"transfer scores of {EVAL_SAMPLES} images) on {card}")
    torch.cuda.empty_cache()
    return got


def phase_profiler(torch, fdc, api, cfg, tmp, card):
    """``utils/profiler.compiled_stats`` of one full-width denoiser forward
    at batch 16 (the default model, fp32, B4): its FLOPs
    from fake tensors, no launch, against ``model_flops_per_image(cfg)``·16,
    the analytic forward count; then ``annotate``: its name must appear in
    a ``profiler.trace`` capture of one forward, with CUDA kernels under it."""
    from gan_class_transfer2_tpu_torch.models import unet
    from gan_class_transfer2_tpu_torch.utils import benchmark, profiler

    c = cfg.validate()
    model = api.init_denoiser(c, device="cuda")
    x = torch.rand((TRAIN_BATCH, c.size, c.size, 3), device="cuda") * 2 - 1
    fdc.down_conv_fused.launches = 0
    t0 = time.perf_counter()
    stats = profiler.compiled_stats(lambda v: unet.unet_apply(c, model, v), x)
    secs = time.perf_counter() - t0
    analytic = benchmark.model_flops_per_image(c) * TRAIN_BATCH
    if fdc.down_conv_fused.launches != 0 or not stats["flops"]:
        fail(f"profiler: compiled_stats launched B4 {fdc.down_conv_fused.launches} times, "
             f"gave {stats}")
    diff = stats["flops"] - analytic
    print(f"[profiler] compiled_stats of one denoiser forward at batch {TRAIN_BATCH} (fake "
          f"tensors, no launch, {secs:.2f} s): {json.dumps(stats)}; model_flops_per_image x "
          f"{TRAIN_BATCH} = {analytic}; difference {diff} ({diff / analytic:+.3e})")
    with profiler.trace(os.path.join(tmp, "trace-annotate")) as prof:
        with profiler.annotate("gct2_smoke_forward"), torch.inference_mode():
            unet.unet_apply(c, model, x)
            torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()}
    busy = profiler.device_busy_ms(prof)
    with open(os.path.join(tmp, "trace-annotate", "trace.json")) as fh:
        in_trace = "gct2_smoke_forward" in fh.read()
    if "gct2_smoke_forward" not in names or not in_trace or busy <= 0:
        fail(f"profiler: annotate's range in the capture {('gct2_smoke_forward' in names)}, "
             f"in trace.json {in_trace}, device busy {busy} ms")
    print(f"[profiler] annotate('gct2_smoke_forward') around one forward: in key_averages and "
          f"trace.json; device busy {busy:.3f} ms under it on {card}")
    fdc.down_conv_fused.launches = 0
    del model, x
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ serve


def _http(port, method, path, body=None, timeout=300):
    """(status, headers, body) of one request to the server on ``port``."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body)
        r = conn.getresponse()
        return r.status, {k.lower(): v for k, v in r.getheaders()}, r.read()
    finally:
        conn.close()


def _ok(port, path, body=None, method="POST"):
    status, _, out = _http(port, method, path, body)
    if status != 200:
        fail(f"serve: {method} {path} answered {status}: {out[:300]!r}")
    return out


def _busy(port, path, body, what):
    status, headers, out = _http(port, "POST", path, body)
    if status != 503 or headers.get("retry-after") != "1":
        fail(f"serve: {what}: {status} {headers}, expected 503 with Retry-After 1: {out[:200]!r}")
    return json.loads(out)["error"]


def _levels(got, want, what):
    """Max uint8 difference and the share of values that differ; fails past
    1 level or past 1e-3 of the values (a float32 difference flips a value
    only where it sits on a level boundary)."""
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    share = float((diff > 0).mean())
    if got.shape != want.shape or diff.max() > 1 or share > 1e-3:
        fail(f"serve: {what}: shapes {got.shape}/{want.shape}, max {diff.max()} levels on "
             f"{share:.2e} of the values (bound 1 level on 1e-3)")
    return int(diff.max()), share


def _read_frame(resp):
    """One PNG frame of a /sample stream (None at the terminator)."""
    from gan_class_transfer2_tpu_torch.utils import png

    line = resp.readline()
    if line.startswith(b"--gct2frame--"):
        return None
    if line != b"--gct2frame\r\n":
        fail(f"serve: stream frame starts with {line[:80]!r}")
    headers = {}
    while (line := resp.readline()) != b"\r\n":
        k, _, v = line.decode().partition(":")
        headers[k.strip().lower()] = v.strip()
    frame = png.decode_png(resp.read(int(headers["content-length"])))
    resp.read(2)
    return frame


def _latency(port, path, body, conc, per_thread):
    """(p50, p99, max) ms and the count of ``conc`` clients each sending
    ``per_thread`` requests back to back; fails unless every request got a
    200. The p99 means something only from ~100 requests on: below that it
    is in effect the max."""
    import threading

    lat, bad, lock = [], [], threading.Lock()

    def client():
        for _ in range(per_thread):
            t0 = time.perf_counter()
            status, _, _ = _http(port, "POST", path, body)
            with lock:
                lat.append((time.perf_counter() - t0) * 1e3)
                if status != 200:
                    bad.append(status)

    threads = [threading.Thread(target=client) for _ in range(conc)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if bad or len(lat) != conc * per_thread:
        fail(f"serve: latency of {path} at concurrency {conc}: statuses {bad}, "
             f"{len(lat)} answers")
    p50, p99 = np.percentile(lat, [50, 99])
    return float(p50), float(p99), float(max(lat)), len(lat)


class _Launches:
    """The kernels' launch counters around served requests: ``take`` checks
    the launches since the last reset against ``want`` and adds them to
    ``total``."""

    def __init__(self, *counters):
        self.counters = counters
        self.total = [0] * len(counters)

    def reset(self):
        for k in self.counters:
            k.launches = 0

    def take(self, want, what):
        got = tuple(k.launches for k in self.counters)
        if got != want:
            fail(f"serve: {what}: launches B3/B4 {got}, expected {want}")
        self.total = [t + g for t, g in zip(self.total, got)]
        self.reset()
        return got


def _replay(gen_state, shape):
    """The noise a service's generator in ``gen_state`` draws next."""
    import torch

    g = torch.Generator(device="cuda")
    g.set_state(gen_state)
    return torch.randn(shape, generator=g, device="cuda")


def _both(svc, ports, path, body, launches, want, what):
    """The request through each frontend on the same generator state:
    exact launches each, equal bytes; returns (npy answer, generator
    state)."""
    import io

    gen_state, outs = svc._gen.get_state(), []
    for port in ports:
        svc._gen.set_state(gen_state)
        launches.reset()
        outs.append(_ok(port, path, body))
        launches.take(want, f"{what} on port {port}")
    if outs[0] != outs[1]:
        a, b = (np.load(io.BytesIO(o)).astype(np.int16) for o in outs)
        fail(f"serve: {what}: the threaded and the aio answers differ (max "
             f"{np.abs(a - b).max()} levels on {(a != b).mean():.2e} of the values)")
    return np.load(io.BytesIO(outs[0])), gen_state


def _reload_memory(torch, svc, port, what, card):
    """/reload of ``svc`` (the latest checkpoint, again) with the card's
    peak memory across it: allocated before, the peak during, and after.
    Garbage is collected first and after (a service and its batchers form
    a reference cycle, so a dropped service's weights wait for the
    collector), so before and after count live tensors only."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step = json.loads(_ok(port, "/reload"))["step"]
    ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    gc.collect()
    after = torch.cuda.memory_allocated()
    print(f"[serve] /reload of the {what} service (step {step}): {ms:.1f} ms; card memory "
          f"allocated {before / 2**20:.1f} MiB before, peak {peak / 2**20:.1f} MiB during, "
          f"{after / 2**20:.1f} MiB after ({card})")
    return peak - before


def phase_serve(torch, fdc, norm, sampler, gan, png, tmp, globs, card):
    """The user's serving path: ``serve/server.build_service`` on
    [train-cli]'s diffusion checkpoint (the default width, T = 200, stride
    50, B4) and [gan-train-cli]'s cycle-GAN checkpoint
    (instance norms), each behind the threaded ``Server`` and the
    ``AsyncServer`` on port 0, on the card. Exact B3/B4 launches from HTTP
    requests (/sample num 1 and 3: one device batch each; /denoise: one
    denoiser call; /edit: T invert + 4 decode calls; /transfer ab and ba:
    one generator forward each); the ``format=npy`` answers equal the
    in-process sampler, preview and transfer on the replayed noise within
    1 uint8 level on ≤ 1e-3 of the values, and the two frontends' bytes
    equal; 8 concurrent num=2 requests in ≤ 2 device batches (the test holds
    the device lock until all are queued) and a 503 past serve_max_queue; a
    stream spanning a /reload ends on the old weights, /healthz then reports
    the new step, and a second stream and /edit get 503 past
    serve_max_streams. Then, measured and printed only: latency at
    concurrency 1 and 8 (p50, max, and a p99 where 100 requests or more), sample img/s and peak memory by device batch (fp32
    and bf16), PNG against npy encode, reload ms. Returns the (B3, B4)
    launches of the checked requests."""
    import glob
    import http.client
    import io
    import threading

    from gan_class_transfer2_tpu_torch.serve import server as srv_mod
    from gan_class_transfer2_tpu_torch.serve.aio import AsyncServer
    from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt_lib

    t_phase = time.perf_counter()
    launches = _Launches(norm.instance_norm_fused, fdc.down_conv_fused)
    reset, take = launches.reset, launches.take

    ddir, gdir = os.path.join(tmp, "ckpt-cli"), os.path.join(tmp, "ckpt-gan")
    dcfg = ckpt_lib.load_config(ddir).replace(checkpoint_dir=ddir, serve_max_queue=16,
                                              serve_max_streams=1).validate()
    gcfg = ckpt_lib.load_config(gdir).replace(checkpoint_dir=gdir).validate()
    t0 = time.perf_counter()
    dsvc = srv_mod.build_service(dcfg, "diffusion", "cuda")
    gsvc = srv_mod.build_service(gcfg, "gan", "cuda")
    print(f"[serve] services restored (diffusion step {dsvc.step}, gan step {gsvc.step}) in "
          f"{time.perf_counter() - t0:.2f} s")
    servers = [srv_mod.Server(dsvc).start(), AsyncServer(dsvc).start(),
               srv_mod.Server(gsvc).start(), AsyncServer(gsvc).start()]
    dthr, daio, gthr, gaio = (s.port for s in servers)
    size = dcfg.size
    calls = len(sampler.sample_timesteps(dcfg))
    b4 = b4_per_call(fdc, dcfg, 1)
    _, _, (b3_fwd, b4_fwd) = gan_counts(fdc, gcfg, 1)
    raw = png.read_png(sorted(glob.glob(globs[0]))[0])
    off = (raw.shape[0] - size) // 2
    img = np.ascontiguousarray(raw[off:off + size, off:off + size])
    buf = io.BytesIO()
    np.save(buf, img)
    body_npy = buf.getvalue()
    x = torch.from_numpy(srv_mod._decode_image(body_npy, size)).cuda()

    # cuDNN's default algorithm for a transposed convolution (the up convs)
    # is not bit-reproducible: two runs of one batch-4 program on an H100
    # can differ by a level (printed below). The agreement checks run with
    # deterministic algorithms, so equal requests must give equal bytes.
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True

    # ---- exact launches, agreement with the in-process path, both frontends
    reset()
    for num, padded in ((1, 1), (3, 4)):
        before = dsvc.counters["device_batches"]
        got, gen_state = _both(dsvc, (dthr, daio), "/sample",
                               json.dumps({"num": num, "format": "npy"}).encode(), launches,
                               (0, calls * b4), f"/sample num {num}")
        if dsvc.counters["device_batches"] - before != 2:
            fail(f"serve: /sample num {num} took {dsvc.counters['device_batches'] - before} "
                 "device batches for two requests")
        init = _replay(gen_state, (padded, size, size, 3))
        want = png.to_uint8(sampler.sample(dcfg, dsvc._model, init, snapshots=False)
                            .images[:num].cpu().numpy())
        lv = _levels(got, want, f"/sample num {num} against sampler.sample")
        print(f"[serve] /sample num {num} (device batch {padded}): {calls * b4} B4 launches "
              f"per frontend; npy vs in-process sampler.sample {lv[0]} level(s) on "
              f"{lv[1]:.2e} of the values; threaded = aio bytes")
    got, gen_state = _both(dsvc, (dthr, daio), "/denoise?format=npy", body_npy, launches,
                           (0, b4), "/denoise")
    noise = _replay(gen_state, (1, size, size, 3))
    want = png.to_uint8(sampler.preview(dcfg, dsvc._model, x, noise)[0].cpu().numpy())
    lv = _levels(got, want, "/denoise against sampler.preview")
    print(f"[serve] /denoise: {b4} B4 launches per frontend; npy vs sampler.preview {lv[0]} "
          f"level(s) on {lv[1]:.2e}; threaded = aio bytes")
    for d in ("ab", "ba"):
        got, _ = _both(gsvc, (gthr, gaio), f"/transfer?direction={d}&format=npy", body_npy,
                       launches, (b3_fwd, b4_fwd), f"/transfer {d}")
        with torch.inference_mode():
            want = png.to_uint8(gan.transfer(gcfg, gsvc.gan_state, x, d).cpu().numpy())
        lv = _levels(got, want, f"/transfer {d} against gan.transfer")
        print(f"[serve] /transfer {d}: B3/B4 ({b3_fwd}, {b4_fwd}) per frontend; npy vs "
              f"gan.transfer {lv[0]} level(s) on {lv[1]:.2e}; threaded = aio bytes")
    reset()
    out = png.decode_png(_ok(gthr, "/transfer?direction=ab", png.encode_png(raw)))
    take((b3_fwd, b4_fwd), f"/transfer of a {raw.shape[0]}² PNG")
    if out.shape != (size, size, 3):
        fail(f"serve: /transfer of a {raw.shape} PNG gave {out.shape}")
    t0 = time.perf_counter()
    with np.load(io.BytesIO(_ok(dthr, "/edit?format=npy", body_npy))) as z:
        edited = {k: z[k] for k in z.files}
    edit_s = time.perf_counter() - t0
    take((0, (dcfg.steps + calls) * b4), "/edit")
    if sorted(edited) != ["pixelate", "quantise", "reconstruction", "shift"] or any(
            v.shape != (1, size, size, 3) or v.dtype != np.uint8 for v in edited.values()):
        fail(f"serve: /edit answered {[(k, v.shape, v.dtype) for k, v in edited.items()]}")
    print(f"[serve] /edit: {(dcfg.steps + calls) * b4} B4 launches ({dcfg.steps} invert + "
          f"{calls} decode calls) in {edit_s:.3f} s; /transfer of a {raw.shape[0]}² PNG "
          f"resampled to {size}²")
    torch.backends.cudnn.deterministic = deterministic
    init = _replay(dsvc._gen.get_state(), (4, size, size, 3))
    runs = [dsvc._sample_prog(dsvc._model, init).cpu().numpy().astype(np.int16)
            for _ in range(2)]
    print(f"[serve] cuDNN's default algorithms: two runs of the batch-4 sample program on the "
          f"same noise differ by {np.abs(runs[0] - runs[1]).max()} level(s) on "
          f"{(runs[0] != runs[1]).mean():.2e} of the values")

    # ---- coalescing behind a gate, and the queue's shed
    n_req, per = 8, 2
    batches, orig = [], dsvc._batcher._execute

    def counting(batch):
        batches.append(sum(r.num for r in batch))
        return orig(batch)

    answers, lock = [], threading.Lock()

    def client(port):
        status, _, body = _http(port, "POST", "/sample",
                                json.dumps({"num": per, "format": "npy"}).encode())
        with lock:
            answers.append((status, np.load(io.BytesIO(body)).shape if status == 200 else None))

    dsvc._batcher._execute = counting
    reset()
    with dsvc._lock:
        threads = [threading.Thread(target=client, args=((dthr, daio)[i % 2],))
                   for i in range(n_req)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 120
        while not (batches and batches[0] + dsvc._batcher.depth() == n_req * per):
            if time.monotonic() > deadline:
                fail(f"serve: coalescing gate: batches {batches}, depth "
                     f"{dsvc._batcher.depth()}")
            time.sleep(0.005)
        over = n_req * per - batches[0] - dsvc._batcher.depth() + dcfg.serve_max_queue + 1
        # queued + over > serve_max_queue: shed on both frontends
        for port in (dthr, daio):
            _busy(port, "/sample", json.dumps({"num": over}).encode(), "past serve_max_queue")
    for t in threads:
        t.join(300)
    dsvc._batcher._execute = orig
    if sorted(answers) != [(200, (per, size, size, 3))] * n_req or len(batches) > 2 or sum(
            batches) != n_req * per:
        fail(f"serve: {n_req} concurrent num={per} requests: answers {answers}, device "
             f"batches {batches}")
    take((0, len(batches) * calls * b4), "the coalesced requests")
    print(f"[serve] {n_req} concurrent num={per} requests (both frontends) in {len(batches)} "
          f"device batches {batches}; num={over} past serve_max_queue "
          f"{dcfg.serve_max_queue}: 503 + Retry-After on both frontends")

    # ---- a stream spanning a /reload, and the stream shed
    real, go = dsvc.sample_stream, threading.Event()

    def gated(num, segments=4, class_idx=None):
        inner = real(num, segments=segments, class_idx=class_idx)

        def frames():
            try:
                for i, snap in enumerate(inner):
                    yield snap
                    if i == 0:
                        go.wait(300)  # hold the stream after its first frame
            finally:
                inner.close()

        return frames()

    dsvc.sample_stream = gated
    gen_state, old_model, old_step = dsvc._gen.get_state(), dsvc._model, dsvc.step
    reset()
    conn = http.client.HTTPConnection("127.0.0.1", dthr, timeout=300)
    conn.request("POST", "/sample", body=json.dumps({"num": 1, "stream": True}).encode())
    resp = conn.getresponse()
    if resp.status != 200:
        fail(f"serve: stream answered {resp.status}")
    frames = [_read_frame(resp)]
    stream_shed = _busy(daio, "/sample", json.dumps({"num": 1, "stream": True}).encode(),
                        "a second stream past serve_max_streams")
    _busy(dthr, "/edit", body_npy, "/edit past serve_max_streams")
    new = copy.deepcopy(dsvc.state)
    with torch.no_grad():
        for p in list(new.model.parameters()) + list(new.ema_params or []):
            p.mul_(1.05)
    t0 = time.perf_counter()
    ckpt_lib.save(ddir, new._replace(step=old_step + 1), dcfg)
    save_ms = (time.perf_counter() - t0) * 1e3
    del new
    t0 = time.perf_counter()
    reloaded = json.loads(_ok(daio, "/reload"))
    reload_ms = (time.perf_counter() - t0) * 1e3
    health = json.loads(_ok(dthr, "/healthz", method="GET"))
    if reloaded != {"step": old_step + 1} or health["step"] != old_step + 1:
        fail(f"serve: /reload gave {reloaded}, /healthz {health}; expected step {old_step + 1}")
    go.set()
    while (frame := _read_frame(resp)) is not None:
        frames.append(frame)
    conn.close()
    dsvc.sample_stream = real
    take((0, calls * b4), "the stream")
    init = _replay(gen_state, (1, size, size, 3))
    with torch.inference_mode():
        old = png.to_uint8(sampler.sample(dcfg, old_model, init).images[0].cpu().numpy())
        fresh = png.to_uint8(sampler.sample(dcfg, dsvc._model, init).images[0].cpu().numpy())
    lv = _levels(frames[-1], old, "the stream's last frame against the old weights")
    moved = int(np.abs(frames[-1].astype(np.int16) - fresh.astype(np.int16)).max())
    if len(frames) != calls or moved <= 1:
        fail(f"serve: the stream gave {len(frames)} frames; its last frame is {moved} "
             "levels from the new weights' sample (the reload must have changed them)")
    del old_model
    print(f"[serve] stream of {len(frames)} frames spanning a /reload (step {old_step} -> "
          f"{old_step + 1}): last frame vs the old weights {lv[0]} level(s) on {lv[1]:.2e}, vs "
          f"the new weights {moved} levels; a second stream and /edit got 503 "
          f"({stream_shed!r}); checkpoint save {save_ms:.1f} ms, /reload {reload_ms:.1f} ms "
          f"({card})")
    print(f"[serve] launches B3/B4 from the checked requests: {tuple(launches.total)}; the "
          f"checks took {time.perf_counter() - t_phase:.2f} s")

    # ---- measured and printed, not gated
    # a p99 from 120 requests at concurrency 1 and 200 at 8 (between the
    # second and third largest); /edit (0.6 s a request, serial behind the
    # device lock) only gets a p50
    dsvc.cfg = dsvc.cfg.replace(serve_max_streams=8)  # /edit at concurrency 8
    for path, port, body, reps in (
            ("/sample", dthr, json.dumps({"num": 1}).encode(), (120, 25)),
            ("/sample", dthr, json.dumps({"num": 1, "format": "npy"}).encode(), (120, 25)),
            ("/denoise?format=npy", dthr, body_npy, (120, 25)),
            ("/transfer?direction=ab&format=npy", gthr, body_npy, (120, 25)),
            ("/edit?format=npy", dthr, body_npy, (2, 1))):
        for conc, per_thread in ((1, reps[0]), (8, reps[1])):
            p50, p99, top, n = _latency(port, path, body, conc, per_thread)
            what = path + {b'{"num": 1}': " png", b'{"num": 1, "format": "npy"}': " npy"}.get(
                body, "")
            tail = f", p99 {p99:.3f} ms" if n >= 100 else ""
            print(f"[serve] latency {what} at concurrency {conc}: p50 {p50:.3f} ms{tail}, max "
                  f"{top:.3f} ms over {n} requests ({card})")
    bf16 = srv_mod.ModelService(dcfg.replace(compute_dtype="bfloat16"), state=dsvc.state,
                                device="cuda")
    for name, svc in (("float32", dsvc), ("bfloat16", bf16)):
        for b in (1, 4, 16, 64, 128):
            t0 = time.perf_counter()
            svc._run_sample(b)  # warms this batch's shapes (64 and 128 are new here)
            first = time.perf_counter() - t0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = svc._run_sample(b)
            secs = time.perf_counter() - t0
            if out.shape != (b, size, size, 3):
                fail(f"serve: batch {b} gave {out.shape}")
            print(f"[serve] sample {name} device batch {b} (stride {dcfg.sample_stride}, {calls} "
                  f"calls, uint8 fetch included): {b / secs:.3f} img/s, the call before it "
                  f"{first * 1e3:.1f} ms, peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB ({card})")
    bf16.close()
    del bf16, svc  # they share dsvc's served module, which the reload below must free
    sample = dsvc.sample(1)
    png_ms = host_ms(lambda: srv_mod._png_bytes(sample[0]), reps=20)
    npy_ms = host_ms(lambda: srv_mod._npy_bytes(sample), reps=20)
    print(f"[serve] host encode of one {size}² image: PNG {png_ms:.3f} ms "
          f"({len(srv_mod._png_bytes(sample[0]))} B), npy {npy_ms:.3f} ms ({card})")
    _reload_memory(torch, dsvc, dthr, "diffusion", card)
    _reload_memory(torch, gsvc, gthr, "cycle-GAN", card)
    for s in servers:
        s.stop()
    reset()
    print(f"[serve] the phase took {time.perf_counter() - t_phase:.2f} s")
    torch.cuda.empty_cache()
    return tuple(launches.total)


# ----------------------------------------- the class-conditional model


def write_third_class(tmp):
    """CLI_FILES[0] triangles in ``tmp/c`` (the third class of
    [cond-train-cli] and [cgan-train-cli]), written after [eval], whose
    diffusion held-out split reads ``tmp/*/*.png``. Returns its glob."""
    from gan_class_transfer2_tpu_torch.data import synthetic

    n, side = CLI_FILES
    synthetic.save_as_pngs(synthetic.triangles(n, side, seed=0), os.path.join(tmp, "c"))
    return os.path.join(tmp, "c", "*.png")


def phase_cond_train_cli(torch, cli, fdc, fd, adam_kernel, api, sampler, png, cfg, tmp, globs,
                         train_results):
    """The class-conditional model (BASELINE config 5's 3 classes, embedding
    width 8) through the user's commands: ``cli train --classes a b c
    --num-classes 3`` on the three class folders through the native loader
    (three NativeImageDatasets behind one LabeledDataset), float32 on the
    kernel path, 2 epochs × CLI_STEPS steps, a checkpoint each epoch and
    one log_sample at stride 50: exact B1/B2/B4 launches, finite losses,
    epoch img/s beside [train-cli]'s; then ``cli sample --class-idx k`` for
    k = 0, 1, 2 from the same noise (the images must differ by class, and
    no class equal class 0's default) and ``cli edit --class-idx 1``, with
    exact B4 launches. First, the conditional step's ms through ``cli bench
    --num-classes 3`` (float32, kernel path, 3 + 10 steps, every sample
    class 0 as bench draws no labels) beside [train]'s unconditional step.
    Returns the launches by kernel name."""
    import glob
    import shutil

    from gan_class_transfer2_tpu_torch.data import native_loader, pipeline
    from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt_lib

    t_phase = time.perf_counter()
    ccfg = cfg.replace(num_classes=3, sample_stride=50)
    n_leaves = len(list(api.build_denoiser(ccfg).parameters()))
    bench_steps = BENCH_STEPS + BENCH_WARMUP
    fdc.down_conv_fused.launches = fd.diffuse_fused.launches = 0
    adam_kernel.adam_fused.launches = 0
    res = _cli_json(cli, ["bench", "--device", "cuda", *_width(cfg), "--num-classes", "3",
                          "--batch-size", str(TRAIN_BATCH), "--bench-steps", str(BENCH_STEPS),
                          "--compute-dtype", "float32", *KERNEL_PATH])[-1]
    bench = (fd.diffuse_fused.launches, adam_kernel.adam_fused.launches,
             fdc.down_conv_fused.launches)
    per_step = (1, adam_kernel.launches_per_step(n_leaves), b4_per_call(fdc, ccfg, TRAIN_BATCH))
    if bench != tuple(bench_steps * k for k in per_step) or not np.isfinite(res["final_loss"]):
        fail(f"cond-train-cli: bench launches B1/B2/B4 {bench} ({per_step} a step expected), "
             f"loss {res['final_loss']}")
    base = train_results[("float32", "kernels")]
    print(f"[cond-train-cli] cli bench --num-classes 3, fp32 kernel path, batch {TRAIN_BATCH}: "
          f"{res['step_ms']:.3f} ms a step, {res['images_per_sec']:.3f} img/s ([train], "
          f"unconditional, this run: {base['step_ms']:.3f} ms, {base['images_per_sec']:.3f} img/s; "
          f"{res['step_ms'] / base['step_ms'] - 1:+.2%}); launches B1/B2/B4 {bench}")
    steps = 2 * CLI_STEPS
    sample_calls = len(sampler.sample_timesteps(ccfg))
    calls = 1 + cfg.steps + sample_calls  # one log_sample: preview, T invert, the sample
    b4 = b4_per_call(fdc, ccfg, TRAIN_BATCH)
    want = (steps, steps * adam_kernel.launches_per_step(n_leaves), (steps + calls) * b4)
    ckpt = os.path.join(tmp, "ckpt-cond")
    args = ["train", "--device", "cuda", *_width(cfg), *KERNEL_PATH, "--compute-dtype",
            "float32", "--batch-size", str(TRAIN_BATCH), "--steps-per-epoch", str(CLI_STEPS),
            "--checkpoint-every", str(CLI_STEPS), "--checkpoint-keep", "1", "--sample-stride",
            "50", "--classes", *globs, "--num-classes", "3", "--epochs", "2",
            "--log-images-every", "2", "--data-workers", "2", "--log-dir",
            os.path.join(tmp, "logs-cond"), "--checkpoint-dir", ckpt]
    built, make_datasets = [], pipeline.make_datasets

    def recording(*a, **kw):
        out = make_datasets(*a, **kw)
        built.extend(type(d).__name__ for d in out)
        return out

    pipeline.make_datasets = recording
    try:
        got, secs = _run_cli(cli, (fd.diffuse_fused, adam_kernel.adam_fused,
                                   fdc.down_conv_fused), args)
    finally:
        pipeline.make_datasets = make_datasets
    if built != [native_loader.NativeImageDataset.__name__] * 3:
        fail(f"cond-train-cli: the datasets were {built}, expected three NativeImageDatasets")
    if got != want:
        fail(f"cond-train-cli: launches B1/B2/B4 {got}, expected {want} ({steps} steps, "
             f"{calls} denoiser calls in one log_sample)")
    ev, ref = _events(os.path.join(tmp, "logs-cond")), _events(os.path.join(tmp, "logs-cli"))
    losses, ips = dict(ev["loss"]), dict(ev["images_per_sec"])
    if sorted(losses) != [0, 1] or not all(np.isfinite(v) for v in losses.values()):
        fail(f"cond-train-cli: epoch losses {losses}")
    if ckpt_lib.all_steps(ckpt) != [steps] or ckpt_lib.load_config(ckpt).num_classes != 3:
        fail(f"cond-train-cli: checkpoints {ckpt_lib.all_steps(ckpt)}")
    ref_ips = dict(ref["images_per_sec"])
    for e in (0, 1):
        print(f"[cond-train-cli] epoch {e}: loss {losses[e]:.7f}, {ips[e]:.3f} img/s "
              f"([train-cli], unconditional: {ref_ips[e]:.3f})"
              f"{' after log_sample' if e == 0 else ''}")
    print(f"[cond-train-cli] fp32 kernel path, 3 classes from PNG files (3 NativeImageDatasets "
          f"behind a LabeledDataset), {steps} steps + one log_sample ({calls} calls): launches "
          f"B1/B2/B4 {got} ({n_leaves} leaves); checkpoint step {steps}; wall {secs:.2f} s")

    out, images = os.path.join(tmp, "cond-samples"), {}
    sample_b4 = sample_calls * b4_per_call(fdc, ccfg, 2)
    for k in (None, 0, 1, 2):
        d = os.path.join(out, f"class-{k}")
        extra = [] if k is None else ["--class-idx", str(k)]
        got_k, _ = _run_cli(cli, (fdc.down_conv_fused,), [
            "sample", "--device", "cuda", "--checkpoint-dir", ckpt, "--num", "2", "--out", d,
            *extra])
        if got_k != (sample_b4,):
            fail(f"cond-train-cli: sample --class-idx {k}: B4 launches {got_k}, "
                 f"expected {sample_b4}")
        images[k] = np.stack([png.read_png(os.path.join(d, f"sample_{i}.png"))
                              for i in range(2)]).astype(np.int16)
    diffs = {(a, b): int(np.abs(images[a] - images[b]).max()) for a, b in
             ((0, 1), (0, 2), (1, 2))}
    default = int(np.abs(images[None] - images[0]).max())
    if min(diffs.values()) <= IMAGE_LEVELS["float32"] or default > IMAGE_LEVELS["float32"]:
        fail(f"cond-train-cli: samples by class differ by {diffs} levels (must exceed "
             f"{IMAGE_LEVELS['float32']}); no class against class 0 {default}")
    edit_b4 = cfg.steps * b4_per_call(fdc, ccfg, 1) + sample_calls * b4_per_call(fdc, ccfg, 4)
    got_e, _ = _run_cli(cli, (fdc.down_conv_fused,), [
        "edit", "--device", "cuda", "--checkpoint-dir", ckpt, "--input",
        sorted(glob.glob(globs[1]))[0], "--class-idx", "1", "--out", os.path.join(out, "edit")])
    edited = sorted(os.listdir(os.path.join(out, "edit")))
    if got_e != (edit_b4,) or edited != ["pixelate.png", "quantise.png", "reconstruction.png",
                                         "shift.png"]:
        fail(f"cond-train-cli: edit --class-idx 1: B4 launches {got_e} (expected {edit_b4}), "
             f"wrote {edited}")
    shutil.rmtree(out, ignore_errors=True)
    print(f"[cond-train-cli] cli sample --class-idx 0/1/2 from the same noise (batch 2, "
          f"{sample_calls} calls, {sample_b4} B4 each): max uint8 differences between classes "
          f"{diffs}; no --class-idx against class 0: {default}; cli edit --class-idx 1: "
          f"{edit_b4} B4; the phase took {time.perf_counter() - t_phase:.2f} s")
    n = sample_b4 * 4 + edit_b4
    return {"diffuse_f32": got[0] + bench[0], "adam_f32m": got[1] + bench[1],
            "down_conv_k4s2_f32": got[2] + n + bench[2]}


def phase_cgan(torch, cli, fdc, norm, cgan, cfg, tmp):
    """The conditional GAN through ``cli profile --model cgan`` at the
    default width (the conditional U-Net generator, one projection
    discriminator, 3 classes, batch 16, every source class 0 as the JAX
    command profiles it, instance norms, B4), float32
    and bfloat16, 2 + 3 steps: exact B3 and B4 launches (half the cycle
    GAN's: one generator's fake, cycle and identity, three D applies),
    finite losses, the trace's busy and idle and top kernels; the step timed
    without the profiler. Returns {dtype: (B3, B4)} of the main-path runs."""
    c0 = cfg.replace(num_classes=3)
    per_step, b4_step, (b3_fwd, b4_fwd) = gan_counts(fdc, c0, TRAIN_BATCH, conditional=True)
    b3_step = sum(per_step.values())
    steps = GAN_WARM + GAN_PROFILE_STEPS
    print(f"[cgan] per step: {b3_step} B3 and {b4_step} B4 launches; per generator forward "
          f"{b3_fwd} B3, {b4_fwd} B4")
    launches = {}
    for dtype in ("float32", "bfloat16"):
        args = ["profile", "--device", "cuda", "--model", "cgan", *_width(cfg, (
            "size", "pixel_size", "max_size", "octaves")), "--num-classes", "3",
            "--batch-size", str(TRAIN_BATCH), "--compute-dtype", dtype, "--profile-steps",
            str(GAN_PROFILE_STEPS), "--trace-dir", os.path.join(tmp, f"cgan-{dtype}"),
            *GAN_FLAGS]
        norm.instance_norm_fused.launches = fdc.down_conv_fused.launches = 0
        *rows, out = _cli_json(cli, args)
        got = (norm.instance_norm_fused.launches, fdc.down_conv_fused.launches)
        want = (steps * b3_step, steps * b4_step)
        if got != want:
            fail(f"cgan {dtype}: B3/B4 launches {got}, expected {want}")
        launches[dtype] = got
        final = out["final"]
        if not (np.isfinite(final["g_loss"]) and np.isfinite(final["d_loss"])):
            fail(f"cgan {dtype}: losses {final}")
        busy, wall = out["device_busy_ms_per_step"], out["wall_ms_per_step"]
        print(f"[cgan] {dtype}: launches B3/B4 {got} over {steps} steps; under the profiler "
              f"{wall:.3f} ms a step, {out['images_per_sec']:.3f} img/s, device busy "
              f"{busy:.3f} ms a step (idle {max(0.0, 1 - busy / wall):.1%}); g_loss "
              f"{final['g_loss']:.5f}, d_loss {final['d_loss']:.5f}")
        for r in rows[:8]:
            print(f"[cgan]   {r['ms_per_step']:9.3f} ms x{r['calls']:<5d} {r['op'][:100]}")
        c = c0.replace(batch_size=TRAIN_BATCH, compute_dtype=dtype, g_norm="instance",
                       d_norm="instance").validate()
        state = cgan.init_conditional_gan_state(c, device="cuda")
        step = cgan.make_conditional_gan_train_step(c)
        gen = torch.Generator(device="cuda").manual_seed(3)
        batch = {"image": torch.rand((TRAIN_BATCH, c.size, c.size, 3), generator=gen,
                                     device="cuda") * 2 - 1,
                 "label": torch.arange(TRAIN_BATCH, device="cuda") % 3}
        times = []
        for i in range(GAN_WARM + GAN_TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch, gen)
            float(m["g_loss"])
            if i >= GAN_WARM:
                times.append((time.perf_counter() - t0) * 1e3)
        med = sorted(times)[len(times) // 2]
        print(f"[cgan] {dtype}: without the profiler {med:.3f} ms a step (median of "
              f"{len(times)}: {[round(t, 3) for t in times]}), {TRAIN_BATCH / med * 1e3:.3f} "
              f"img/s; idle share against the profile's busy time {max(0.0, 1 - busy / med):.1%}")
        del state, step, batch
        torch.cuda.empty_cache()
    norm.instance_norm_fused.launches = fdc.down_conv_fused.launches = 0
    return launches


def phase_cgan_agree(torch, fdc, norm, cgan, cfg):
    """One full-width conditional-GAN step with injected targets, under sgd,
    three ways, as [gan-agree] runs the cycle GAN: the entry point in
    float32 (B3, B4, the conv epilogue), cuDNN with the plain instance norm
    and torch-op conv tails in float32, and that plain path in float64.
    Bounds as [gan-agree]'s: the losses of the two float32 paths within
    1e-5 relative; for each net the kernel path's distance from the float64
    update at most 2× the plain path's in root mean square and 4× at the
    largest element, plus 1e-6, relative to the net's largest float64
    update. Under ``cudnn.deterministic``: the
    distances then repeat from run to run (with cuDNN's default algorithms
    the plain path's moved by ±10% between runs, the kernel path's largest
    element not at all)."""
    from gan_class_transfer2_tpu_torch.models import unet
    from gan_class_transfer2_tpu_torch.ops import conv as conv_ops

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    c = cfg.replace(num_classes=3, batch_size=TRAIN_BATCH, g_norm="instance", d_norm="instance",
                    optimizer="sgd", lr_schedule="constant", learning_rate=1e-2).validate()
    r = np.random.default_rng(14)
    x = torch.from_numpy(r.uniform(-1, 1, (TRAIN_BATCH, c.size, c.size, 3))
                         .astype(np.float32)).cuda()
    labels = torch.from_numpy(r.integers(0, 3, TRAIN_BATCH)).cuda()
    targets = (labels + torch.from_numpy(r.integers(1, 3, TRAIN_BATCH)).cuda()) % 3
    nets = ("generator", "discriminator")
    out = {}
    for path in ("kernels", "plain", "float64"):
        state = cgan.init_conditional_gan_state(c, torch.Generator().manual_seed(0),
                                                device="cuda")
        xb = x
        kernel_op, f32, takes = norm.instance_norm, unet.DTYPES["float32"], conv_ops._kernels_take
        if path != "kernels":
            conv_ops._kernels_take = _no_kernel
        if path == "plain":
            norm.instance_norm = norm.instance_norm_plain
        if path == "float64":
            norm.instance_norm = _instance_norm_f64
            unet.DTYPES["float32"] = torch.float64
            for n in nets:
                getattr(state, n).double()
            state = state._replace(
                g_opt=cgan.make_optimizer(c).init(list(state.generator.parameters())),
                d_opt=cgan._d_optimizer(c).init(list(state.discriminator.parameters())))
            xb = x.double()
        before = {n: [p.detach().clone() for p in getattr(state, n).parameters()] for n in nets}
        norm.instance_norm_fused.launches = fdc.down_conv_fused.launches = 0
        try:
            state, m = cgan.make_conditional_gan_train_step(c)(
                state, {"image": xb, "label": labels}, torch.Generator(device="cuda"),
                targets=targets)
            torch.cuda.synchronize()
        finally:
            norm.instance_norm, unet.DTYPES["float32"] = kernel_op, f32
            conv_ops._kernels_take = takes
        launched = (norm.instance_norm_fused.launches, fdc.down_conv_fused.launches)
        norm.instance_norm_fused.launches = fdc.down_conv_fused.launches = 0
        per_step, b4_step, _ = gan_counts(fdc, c, TRAIN_BATCH, conditional=True)
        want = (sum(per_step.values()), b4_step) if path == "kernels" else (0, 0)
        if launched != want:
            fail(f"cgan-agree {path}: B3/B4 launches {launched}, expected {want}")
        deltas = {n: [(p.detach() - q).double() for p, q in
                      zip(getattr(state, n).parameters(), before[n])] for n in nets}
        out[path] = ({k: float(v) for k, v in m.items()}, deltas)
        del state, before
        torch.cuda.empty_cache()
    (mk, dk), (mp, dp), (m64, d64) = out["kernels"], out["plain"], out["float64"]
    rel = {k: abs(mk[k] - mp[k]) / abs(mp[k]) for k in ("g_loss", "d_loss")}

    def dist(a, b, n):
        largest = max(t.abs().max().item() for t in d64[n])
        sq = sum((u - v).square().sum().item() for u, v in zip(a[n], b[n]))
        count = sum(u.numel() for u in a[n])
        top = max((u - v).abs().max().item() for u, v in zip(a[n], b[n]))
        return (sq / count) ** 0.5 / largest, top / largest

    ok = max(rel.values()) <= 1e-5
    report = []
    for n in nets:
        (kr, km), (pr, pm) = dist(dk, d64, n), dist(dp, d64, n)
        ok = ok and kr <= 2 * pr + 1e-6 and km <= 4 * pm + 1e-6
        report.append(f"{n} rms {kr:.2e} / {pr:.2e}, max {km:.2e} / {pm:.2e}")
    print(f"[cgan-agree] one step, {c.size}², batch {TRAIN_BATCH}, 3 classes, injected targets, "
          f"sgd lr {c.learning_rate}: g_loss kernels {mk['g_loss']:.7f} plain {mp['g_loss']:.7f} "
          f"float64 {m64['g_loss']:.7f} (rel {rel['g_loss']:.2e}), d_loss {mk['d_loss']:.7f} / "
          f"{mp['d_loss']:.7f} / {m64['d_loss']:.7f} (rel {rel['d_loss']:.2e}), bound 1e-5; "
          f"updates from the float64 update, kernels / plain: {'; '.join(report)} (bound: "
          f"kernels ≤ 2 × plain in rms, 4 × at the max, + 1e-6)")
    torch.backends.cudnn.deterministic = deterministic
    if not ok:
        fail(f"cGAN kernel path less accurate than the plain path: losses {rel}, {report}")


def phase_cgan_train_cli(torch, cli, fdc, norm, cfg, tmp, globs):
    """The user's ``cli cgan-train`` on the three class folders, default
    width, instance norms and B4, float32, batch 16, CLI_STEPS steps with
    ``--fid-samples 16`` (16 held-out files a class), one checkpoint and one
    log_sample (``transfer_to_<k>`` of a fixed batch for k = 0, 1, 2, and the
    transfer FID/KID of all six ordered pairs); then ``cli eval --model
    cgan`` on its checkpoint (six transfers). Exact B3/B4 launches, finite
    losses and scores. Returns (B3, B4)."""
    from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt_lib

    c = cfg.replace(num_classes=3, batch_size=TRAIN_BATCH, g_norm="instance", d_norm="instance")
    per_step, b4_step, (b3_fwd, b4_fwd) = gan_counts(fdc, c, TRAIN_BATCH, conditional=True)
    fwd = 3 + 6  # log_sample: three targets of the fixed batch, six pairs' held-out transfers
    want = (CLI_STEPS * sum(per_step.values()) + fwd * b3_fwd, CLI_STEPS * b4_step + fwd * b4_fwd)
    ckpt = os.path.join(tmp, "ckpt-cgan")
    args = ["cgan-train", "--device", "cuda", *_width(cfg, ("size", "pixel_size", "max_size",
                                                            "octaves")),
            *GAN_FLAGS, "--compute-dtype", "float32", "--batch-size", str(TRAIN_BATCH),
            "--classes", *globs, "--steps-per-epoch", str(CLI_STEPS), "--epochs", "1",
            "--checkpoint-every", str(CLI_STEPS), "--checkpoint-keep", "1",
            "--fid-samples", str(EVAL_SAMPLES), "--data-workers", "2",
            "--log-dir", os.path.join(tmp, "logs-cgan"), "--checkpoint-dir", ckpt]
    got, secs = _run_cli(cli, (norm.instance_norm_fused, fdc.down_conv_fused), args)
    if got != want:
        fail(f"cgan-train-cli: launches B3/B4 {got}, expected {want} ({CLI_STEPS} steps and "
             f"{fwd} generator forwards in log_sample)")
    ev = _events(os.path.join(tmp, "logs-cgan"))
    pairs = [(s, t) for s in range(3) for t in range(3) if s != t]
    need = ([f"transfer_to_{k}/image/0" for k in range(3)]
            + [f"transfer_{m}_{s}_to_{t}" for s, t in pairs for m in ("fid", "kid")]
            + ["g_loss", "d_loss", "cycle", "images_per_sec"])
    missing = [t for t in need if t not in ev]
    if missing:
        fail(f"cgan-train-cli: the event file lacks {missing}")
    vals = {k: ev[k][0][1] for k in need[3:]}
    if not all(np.isfinite(v) for v in vals.values()):
        fail(f"cgan-train-cli: {vals}")
    if ckpt_lib.all_steps(ckpt) != [CLI_STEPS]:
        fail("cgan-train-cli: no checkpoint at the last step")
    print(f"[cgan-train-cli] fp32, 3 classes, {CLI_STEPS} steps at batch {TRAIN_BATCH} from PNG "
          f"files + one log_sample ({fwd} generator forwards): launches B3/B4 {got}; g_loss "
          f"{vals['g_loss']:.5f}, d_loss {vals['d_loss']:.5f}, cycle {vals['cycle']:.5f}; "
          f"{vals['images_per_sec']:.3f} img/s; mean transfer FID "
          f"{np.mean([vals[f'transfer_fid_{s}_to_{t}'] for s, t in pairs]):.3f}; wall "
          f"{secs:.2f} s")
    for k in (norm.instance_norm_fused, fdc.down_conv_fused):
        k.launches = 0
    t0 = time.perf_counter()
    out = _cli_json(cli, ["eval", "--device", "cuda", "--model", "cgan", "--checkpoint-dir",
                          ckpt])[-1]
    secs = time.perf_counter() - t0
    got_e = (norm.instance_norm_fused.launches, fdc.down_conv_fused.launches)
    if got_e != (6 * b3_fwd, 6 * b4_fwd):
        fail(f"eval cgan: launches B3/B4 {got_e}, expected {(6 * b3_fwd, 6 * b4_fwd)}")
    keys = [f"transfer_{m}_{s}_to_{t}" for s, t in pairs for m in ("fid", "kid")]
    if out.get("step") != CLI_STEPS or not all(np.isfinite(out.get(k, np.nan)) for k in keys):
        fail(f"eval cgan: {out}")
    print(f"[cgan-train-cli] cli eval --model cgan (step {out['step']}, fid_samples "
          f"{EVAL_SAMPLES}): {json.dumps({k: round(out[k], 6) for k in keys})}; launches "
          f"B3/B4 {got_e}; wall {secs:.2f} s")
    torch.cuda.empty_cache()
    return got[0] + got_e[0], got[1] + got_e[1]


def phase_serve_classes(torch, fdc, norm, sampler, cgan, png, tmp, globs, card):
    """[serve] on the class-conditional checkpoints: ``build_service`` on
    [cond-train-cli]'s conditional diffusion checkpoint and
    [cgan-train-cli]'s conditional GAN, each behind the threaded Server and
    the AsyncServer on the card. ``/sample {"class": k}`` (num 1 and 3) and
    ``/transfer?to=K`` answer what the in-process sampler and
    ``conditional_gan.transfer`` give within 1 uint8 level, with exact B3/B4
    launches, the two frontends' bytes equal; a stream and an /edit with a
    class; 8 concurrent /sample requests of mixed classes and 6 /transfer
    requests of mixed targets each in ≤ 2 device batches (the device lock
    held until all are queued) with the right per-sample vectors;
    ``direction=`` on the cGAN is a 400. Then printed: latency p50/p99 at
    concurrency 1 and 8 of /sample with a class and /transfer?to=, and the
    card's peak memory across each service's /reload. Returns the (B3, B4)
    launches of the checked requests."""
    import glob
    import io
    import threading

    from gan_class_transfer2_tpu_torch.serve import server as srv_mod
    from gan_class_transfer2_tpu_torch.serve.aio import AsyncServer
    from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt_lib

    t_phase = time.perf_counter()
    launches = _Launches(norm.instance_norm_fused, fdc.down_conv_fused)
    cdir, kdir = os.path.join(tmp, "ckpt-cond"), os.path.join(tmp, "ckpt-cgan")
    ccfg = ckpt_lib.load_config(cdir).replace(checkpoint_dir=cdir).validate()
    kcfg = ckpt_lib.load_config(kdir).replace(checkpoint_dir=kdir).validate()
    csvc = srv_mod.build_service(ccfg, "diffusion", "cuda")
    ksvc = srv_mod.build_service(kcfg, "cgan", "cuda")
    servers = [srv_mod.Server(csvc).start(), AsyncServer(csvc).start(),
               srv_mod.Server(ksvc).start(), AsyncServer(ksvc).start()]
    cthr, caio, kthr, kaio = (s.port for s in servers)
    size, calls = ccfg.size, len(sampler.sample_timesteps(ccfg))
    b4 = b4_per_call(fdc, ccfg, 1)
    _, _, (b3_fwd, b4_fwd) = gan_counts(fdc, kcfg, 1, conditional=True)
    raw = png.read_png(sorted(glob.glob(globs[2]))[0])
    off = (raw.shape[0] - size) // 2
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(raw[off:off + size, off:off + size]))
    body_npy = buf.getvalue()
    x = torch.from_numpy(srv_mod._decode_image(body_npy, size)).cuda()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # equal requests, equal bytes (see [serve])

    for num, padded, k in ((1, 1, 2), (3, 4, 1)):
        got, gen_state = _both(csvc, (cthr, caio), "/sample", json.dumps(
            {"num": num, "class": k, "format": "npy"}).encode(), launches, (0, calls * b4),
            f"/sample num {num} class {k}")
        c = torch.full((padded,), k, dtype=torch.int32, device="cuda")
        want = png.to_uint8(sampler.sample(ccfg, csvc._model, _replay(
            gen_state, (padded, size, size, 3)), c, snapshots=False).images[:num].cpu().numpy())
        lv = _levels(got, want, f"/sample class {k} against sampler.sample")
        print(f"[serve] conditional /sample num {num} class {k}: {calls * b4} B4 per frontend; "
              f"npy vs sampler.sample {lv[0]} level(s) on {lv[1]:.2e}; threaded = aio bytes")
    for k in (0, 2):
        got, _ = _both(ksvc, (kthr, kaio), f"/transfer?to={k}&format=npy", body_npy, launches,
                       (b3_fwd, b4_fwd), f"/transfer to {k}")
        with torch.inference_mode():
            want = png.to_uint8(cgan.transfer(kcfg, ksvc.cgan_state, x, k).cpu().numpy())
        lv = _levels(got, want, f"/transfer?to={k} against conditional_gan.transfer")
        print(f"[serve] /transfer?to={k}: B3/B4 ({b3_fwd}, {b4_fwd}) per frontend; npy vs "
              f"conditional_gan.transfer {lv[0]} level(s) on {lv[1]:.2e}; threaded = aio bytes")
    status, _, out = _http(kaio, "POST", "/transfer?direction=ab", body_npy)
    if status != 400 or "GAN" not in json.loads(out)["error"]:
        fail(f"serve: /transfer?direction=ab on the cGAN answered {status}: {out[:200]!r}")
    launches.reset()
    resp = _http(cthr, "POST", "/sample", json.dumps(
        {"num": 1, "stream": True, "segments": 2, "class": 1}).encode())
    if resp[0] != 200 or resp[2].count(b"Content-Type: image/png") != 2:
        fail(f"serve: conditional stream answered {resp[0]}")
    launches.take((0, calls * b4), "the stream with a class")
    with np.load(io.BytesIO(_ok(caio, "/edit?format=npy&edits=shift&class=2", body_npy))) as z:
        edited = sorted(z.files)
    launches.take((0, (ccfg.steps + calls) * b4), "/edit with a class")
    if edited != ["reconstruction", "shift"]:
        fail(f"serve: /edit with a class answered {edited}")
    torch.backends.cudnn.deterministic = deterministic

    def gated(svc, batcher, send, n, total):
        """``n`` requests through ``send(i)`` with the device lock held until
        all are queued; returns the device batches' sizes."""
        sizes, orig = [], batcher._execute

        def counting(batch):
            sizes.append(sum(r.num for r in batch))
            return orig(batch)

        batcher._execute = counting
        answers = [None] * n
        with svc._lock:
            threads = [threading.Thread(target=lambda i=i: answers.__setitem__(i, send(i)))
                       for i in range(n)]
            for t in threads:
                t.start()
            deadline = time.monotonic() + 120
            while not (sizes and sizes[0] + batcher.depth() == total):
                if time.monotonic() > deadline:
                    fail(f"serve: coalescing gate: batches {sizes}, depth {batcher.depth()}")
                time.sleep(0.005)
        for t in threads:
            t.join(300)
        batcher._execute = orig
        if any(a != 200 for a in answers) or len(sizes) > 2 or sum(sizes) != total:
            fail(f"serve: {n} concurrent requests: answers {answers}, device batches {sizes}")
        return sizes

    seen, run = [], csvc._batcher._run
    csvc._batcher._run = lambda num, c=None: seen.append(sorted(c.tolist())) or run(num, c)
    sizes = gated(csvc, csvc._batcher, lambda i: _http((cthr, caio)[i % 2], "POST", "/sample",
                  json.dumps({"num": 2, "class": i % 3, "format": "npy"}).encode())[0],
                  8, 16)
    csvc._batcher._run = run
    if sorted(v for s in seen for v in s) != sorted([i % 3 for i in range(8)] * 2):
        fail(f"serve: mixed-class batches carried the classes {seen}")
    launches.take((0, len(sizes) * calls * b4), "the coalesced mixed-class requests")
    targets, trun = [], ksvc._cgan_batcher._targeted_run
    ksvc._cgan_batcher._targeted_run = (
        lambda imgs, t: targets.append(sorted(t.tolist())) or trun(imgs, t))
    tsizes = gated(ksvc, ksvc._cgan_batcher, lambda i: _http(
        (kthr, kaio)[i % 2], "POST", f"/transfer?to={i % 3}&format=npy", body_npy)[0],
        6, 6)
    ksvc._cgan_batcher._targeted_run = trun
    if sorted(v for s in targets for v in s) != [0, 0, 1, 1, 2, 2]:
        fail(f"serve: mixed-target batches carried the targets {targets}")
    launches.take((b3_fwd * len(tsizes), b4_fwd * len(tsizes)), "the coalesced transfers")
    print(f"[serve] 8 concurrent /sample of classes 0/1/2 in device batches {sizes} (classes "
          f"{seen}); 6 /transfer?to= of targets 0/1/2 in {tsizes} ({targets}); a stream and "
          f"/edit with a class; direction= on the cGAN: 400; launches B3/B4 "
          f"{tuple(launches.total)}")

    for path, port, body in (
            ("/sample", cthr, json.dumps({"num": 1, "class": 2, "format": "npy"}).encode()),
            ("/transfer?to=1&format=npy", kthr, body_npy)):
        for conc, per_thread in ((1, 120), (8, 25)):
            p50, p99, top, n = _latency(port, path, body, conc, per_thread)
            print(f"[serve] latency {path}{' class 2' if path == '/sample' else ''} npy at "
                  f"concurrency {conc}: p50 {p50:.3f} ms, p99 {p99:.3f} ms, max {top:.3f} ms "
                  f"over {n} requests ({card})")
    _reload_memory(torch, csvc, cthr, "conditional diffusion", card)
    _reload_memory(torch, ksvc, kthr, "conditional-GAN", card)
    for s in servers:
        s.stop()
    launches.reset()
    print(f"[serve] the class-conditional services took {time.perf_counter() - t_phase:.2f} s")
    torch.cuda.empty_cache()
    return tuple(launches.total)


# ------------------------------------------- distillation and bundles


DISTILL_STEPS = 4  # [distill]: steps of the one round (stride 50 -> 100)
BUNDLE_BATCH = 4  # [bundle]: the batch of the sample timing, as [sample]'s


def _cli_lines(cli, args):
    """One CLI run with its standard output captured and echoed; returns the
    lines it printed. Fails the smoke on a non-zero return."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    sys.stdout.write(buf.getvalue())
    if rc != 0:
        fail(f"cli {' '.join(args[:1])} returned {rc}")
    return buf.getvalue().splitlines()


def phase_distill(torch, cli, fdc, fd, adam_kernel, trainer, sampler, cfg, tmp, train_results):
    """``cli.main(["distill", ...])`` on [train-cli]'s checkpoint (the
    default width, stride 50, fp32 on the kernel path, batch 16, its 16
    held-out files kept out): one round of DISTILL_STEPS steps to stride
    100. Exact launches: B4 three denoiser calls a step (the teacher's two,
    the student's one) plus the grids' six (the teacher at stride 50: 4
    calls, the student at 100: 2), 4 down convs each; B1 and B2 none (the
    JAX step draws ε unfused and takes the optax-form update). Finite
    losses, ``sample_stride`` 100 in the student's config.json, ``cli
    sample --checkpoint-dir`` on it (2 calls). Then one distill step timed
    beside [train]'s fp32 step, and one injected full-width step (the same
    t and ε) through the kernel path on the card and the plain versions on
    the CPU: losses within 1e-5 relative. Returns the B4 launches of the two
    commands and the step's ms."""
    from gan_class_transfer2_tpu_torch.train import distill
    from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt_lib

    t_phase = time.perf_counter()
    ckpt, out = os.path.join(tmp, "ckpt-cli"), os.path.join(tmp, "ckpt-distill")
    dcfg = ckpt_lib.load_config(ckpt)
    b4 = b4_per_call(fdc, dcfg, TRAIN_BATCH)
    grid = len(sampler.sample_timesteps(dcfg)) + len(sampler.sample_timesteps(
        dcfg.replace(sample_stride=2 * dcfg.sample_stride)))
    want = (0, 0, (3 * DISTILL_STEPS + grid) * b4)
    args = ["distill", "--device", "cuda", "--checkpoint-dir", ckpt, "--out", out,
            "--distill-steps", str(DISTILL_STEPS), "--log-dir", os.path.join(tmp, "logs-distill")]
    counters = (fd.diffuse_fused, adam_kernel.adam_fused, fdc.down_conv_fused)
    got, secs = _run_cli(cli, counters, args)
    if got != want:
        fail(f"distill: launches B1/B2/B4 {got}, expected {want} ({DISTILL_STEPS} steps x 3 "
             f"denoiser calls + {grid} grid calls, {b4} B4 each)")
    ev = _events(os.path.join(tmp, "logs-distill"))
    stride = 2 * dcfg.sample_stride
    losses = [v for _, v in ev.get(f"distill_loss/stride_{stride}", [])]
    missing = [t for t in ("distill/teacher_samples/image/0", "distill/student_samples/image/0")
               if t not in ev]
    if not losses or not all(np.isfinite(losses)) or missing:
        fail(f"distill: losses {losses}, missing tags {missing}")
    scfg = ckpt_lib.load_config(out)
    if scfg.sample_stride != stride:
        fail(f"distill: the student's config.json has sample_stride {scfg.sample_stride}")
    s_calls = len(sampler.sample_timesteps(scfg))
    sgot, _ = _run_cli(cli, (fdc.down_conv_fused,), [
        "sample", "--device", "cuda", "--checkpoint-dir", out, "--num", "2",
        "--out", os.path.join(tmp, "out", "samples-distill")])
    if sgot != (s_calls * b4,):
        fail(f"distill: sample of the student launched B4 {sgot}, expected {s_calls * b4}")
    print(f"[distill] cli distill, one round stride {dcfg.sample_stride} -> {stride}, "
          f"{DISTILL_STEPS} steps at batch {dcfg.batch_size}: launches B1/B2/B4 {got}; losses "
          f"{[round(v, 7) for v in losses]}; student sample_stride {scfg.sample_stride}; cli "
          f"sample of the student {sgot[0]} B4 ({s_calls} calls); wall {secs:.2f} s")

    # the step timed, and one injected step through both paths
    c = dcfg.validate()
    teacher = trainer.eval_model(ckpt_lib.restore(ckpt, trainer.init_state(c, device="cuda")))
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = torch.rand((TRAIN_BATCH, c.size, c.size, 3), generator=gen, device="cuda") * 2 - 1
    opt = distill.distill_opt_config(c, 100)
    state = distill.init_student(opt, teacher)
    step = distill.make_distill_step(opt, stride)
    for _ in range(2):
        state, loss = step(state, teacher, batch, gen)
    torch.cuda.synchronize()
    t0, n = time.perf_counter(), 5
    for _ in range(n):
        state, loss = step(state, teacher, batch, gen)
    float(loss)
    step_ms = (time.perf_counter() - t0) * 1e3 / n
    train_ms = train_results[("float32", "kernels")]["step_ms"]
    print(f"[distill] fp32 distill step at batch {TRAIN_BATCH}: {step_ms:.3f} ms ({n} steps, "
          f"after 2 warm), against [train]'s fp32 kernel step {train_ms:.3f} ms "
          f"({step_ms / train_ms:.3f}x)")
    del state
    t, eps = distill.draw(c, batch, gen, stride)
    losses = {}
    for dev in ("cuda", "cpu"):
        tm = teacher if dev == "cuda" else copy.deepcopy(teacher).cpu()
        st = distill.init_student(opt, tm)
        _, lo = distill.make_distill_step(opt, stride)(st, tm, batch.to(dev), None,
                                                       t=t.to(dev), epsilon=eps.to(dev))
        losses[dev] = float(lo)
        del st, tm
    rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    if not rel <= 1e-5:
        fail(f"distill: injected step losses {losses}, relative {rel:.3e} (bound 1e-5)")
    print(f"[distill] injected full-width step (t {t.tolist()}): loss kernels "
          f"{losses['cuda']:.9f}, CPU {losses['cpu']:.9f}, relative {rel:.3e} (bound "
          f"1e-5); the phase took {time.perf_counter() - t_phase:.2f} s")
    fdc.down_conv_fused.launches = 0
    torch.cuda.empty_cache()
    return got[2] + sgot[0], step_ms


def _program_ops(path):
    """(gct2::down_conv_k4s2, gct2::instance_norm, stride-2 aten
    convolutions) in a saved program's graph."""
    import torch

    ep = torch.export.load(path)
    nodes = [(str(n.target), n.args) for n in ep.graph.nodes if n.op == "call_function"]
    return (sum(t == "gct2.down_conv_k4s2.default" for t, _ in nodes),
            sum(t == "gct2.instance_norm.default" for t, _ in nodes),
            sum(t in ("aten.conv2d.default", "aten.convolution.default")
                and list(a[3]) == [2, 2] for t, a in nodes))


def _close_scale(got, want, what, tol=1e-4):
    """Max |got − want| within ``tol`` of max(1, max|want|); returns it."""
    err = float((got.float().cpu() - want.float().cpu()).abs().max())
    scale = max(1.0, float(want.abs().max()))
    if not err <= tol * scale:
        fail(f"bundle: {what}: max difference {err:.3e} over {tol} x scale {scale:.3f}")
    return err


def phase_bundle(torch, cli, fdc, norm, sampler, gan, cgan, png, tmp, card):
    """``cli.main(["export-model", ...])`` on [train-cli]'s, [gan-train-cli]'s
    and [cgan-train-cli]'s checkpoints, traced on the card: each program's
    export s, save s, load s and MB; the graphs hold 4
    ``gct2::down_conv_k4s2`` (and the generators 12 ``gct2::instance_norm``)
    and no aten convolution where B4's gate admits one (2 stride-2 convs
    left: the 3-channel stem and the 8² one). One sample program serves
    batch 1, 3 and 16 (16 B4 each); ``cli sample --bundle`` writes the PNGs
    of ``cli sample --checkpoint-dir`` within 1 level; denoise, preview
    and invert (800 B4) agree with the in-process model and sampler (1e-4
    of the scale on raw arrays, 1 level on images); each transfer with
    gan.transfer / cgan.transfer within 1 level (4 B4, 12 B3 each); the
    bundle runs denoise at batch 1 on the CPU within 1e-4 of the card.
    Printed: sample ms/image at batch 4 through the bundle against the
    in-process sampler (in turns), and B4's eager host µs direct against
    through the custom op. Returns (bundle dirs, (B3, B4) launches)."""
    from gan_class_transfer2_tpu_torch.models import api
    from gan_class_transfer2_tpu_torch.train import trainer
    from gan_class_transfer2_tpu_torch.utils import bundle as bundle_lib
    from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt_lib

    t_phase = time.perf_counter()
    launches = _Launches(norm.instance_norm_fused, fdc.down_conv_fused)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # equal programs, equal bytes (see [serve])
    dirs = {}
    for model, ckpt in (("diffusion", "ckpt-cli"), ("gan", "ckpt-gan"), ("cgan", "ckpt-cgan")):
        out = os.path.join(tmp, f"bundle-{model}")
        t0 = time.perf_counter()
        lines = _cli_lines(cli, ["export-model", "--device", "cuda", "--checkpoint-dir",
                                 os.path.join(tmp, ckpt), "--model", model, "--out", out])
        print(f"[bundle] export-model --model {model}: {time.perf_counter() - t0:.2f} s in all; "
              f"{[ln.strip() for ln in lines if ln.startswith('  ')]}")
        dirs[model] = out
    dcfg = ckpt_lib.load_config(os.path.join(tmp, "ckpt-cli"))
    gcfg = ckpt_lib.load_config(os.path.join(tmp, "ckpt-gan"))
    kcfg = ckpt_lib.load_config(os.path.join(tmp, "ckpt-cgan"))
    b4 = b4_per_call(fdc, dcfg, 1)
    _, _, (b3_fwd, b4_fwd) = gan_counts(fdc, gcfg, 1)
    _, _, (kb3_fwd, kb4_fwd) = gan_counts(fdc, kcfg, 1, conditional=True)
    expect = {"diffusion": (b4, 0, dcfg.octaves - b4), "gan": (b4_fwd, b3_fwd,
                                                               gcfg.octaves - b4_fwd),
              "cgan": (kb4_fwd, kb3_fwd, kcfg.octaves - kb4_fwd)}
    bundles = {}
    for model, out in dirs.items():
        bundles[model] = b = bundle_lib.load_bundle(out, "cuda")
        for name in b.programs:
            path = os.path.join(out, b.manifest["programs"][name]["file"])
            ops = _program_ops(path)
            if ops != expect[model]:
                fail(f"bundle: {model}/{name}: graph holds down-conv ops / norm ops / "
                     f"stride-2 aten convs {ops}, expected {expect[model]}")
            t0 = time.perf_counter()
            b.load(name)
            torch.cuda.synchronize()
            print(f"[bundle] {model}/{name}: load {time.perf_counter() - t0:.3f} s, "
                  f"{os.path.getsize(path) / 1e6:.1f} MB; graph: {ops[0]} gct2::down_conv_k4s2, "
                  f"{ops[1]} gct2::instance_norm, {ops[2]} stride-2 aten convs ({card})")

    # ---- diffusion: batch polymorphism, the CLI, agreement with in-process
    db, size = bundles["diffusion"], dcfg.size
    calls = len(sampler.sample_timesteps(dcfg))
    model = trainer.eval_model(ckpt_lib.restore(
        os.path.join(tmp, "ckpt-cli"), trainer.init_state(dcfg, device="cuda")))
    rng = np.random.default_rng(0)
    launches.reset()
    for n in (1, 3, 16):
        y = db.call("sample", torch.from_numpy(rng.normal(size=(n, size, size, 3)).astype(
            np.float32)).cuda())
        if tuple(y.shape) != (n, size, size, 3) or not bool(torch.isfinite(y).all()):
            fail(f"bundle: sample at batch {n}: shape {tuple(y.shape)}")
        launches.take((0, calls * b4), f"bundle sample at batch {n}")
    print(f"[bundle] one sample program served batch 1, 3 and 16: {calls * b4} B4 launches each")
    pngs = {}
    for kind, src in (("bundle", ["--bundle", dirs["diffusion"]]),
                      ("checkpoint", ["--checkpoint-dir", os.path.join(tmp, "ckpt-cli")])):
        outdir = os.path.join(tmp, "out", f"samples-{kind}")  # outside the PNG globs
        launches.reset()
        _cli_lines(cli, ["sample", "--device", "cuda", *src, "--num", str(BUNDLE_BATCH),
                         "--out", outdir])
        launches.take((0, calls * b4), f"cli sample {src[0]}")
        pngs[kind] = np.stack([png.read_png(os.path.join(outdir, f"sample_{i}.png"))
                               for i in range(BUNDLE_BATCH)])
    lv = _levels(pngs["bundle"], pngs["checkpoint"], "cli sample --bundle against "
                 "--checkpoint-dir")
    print(f"[bundle] cli sample --bundle vs --checkpoint-dir, {BUNDLE_BATCH} PNGs: {lv[0]} "
          f"level(s) on {lv[1]:.2e} of the values; {calls * b4} B4 launches each")
    x = torch.from_numpy(rng.uniform(-1, 1, (1, size, size, 3)).astype(np.float32)).cuda()
    noise = torch.from_numpy(rng.normal(size=(1, size, size, 3)).astype(np.float32)).cuda()
    t = torch.full((1,), 37, dtype=torch.int32, device="cuda")
    launches.reset()
    d = db.call("denoise", x, t)
    launches.take((0, b4), "bundle denoise")
    with torch.inference_mode():
        d_err = _close_scale(d, api.apply_denoiser(dcfg, model, x, t).float(), "denoise")
    launches.reset()
    p = db.call("preview", x, noise)
    launches.take((0, b4), "bundle preview")
    p_lv = _levels(png.to_uint8(p.cpu().numpy()), png.to_uint8(
        sampler.preview(dcfg, model, x, noise)[0].cpu().numpy()), "bundle preview")
    launches.reset()
    gx, ge = db.call("invert", x)
    launches.take((0, dcfg.steps * b4), "bundle invert")
    wx, we = sampler.invert(dcfg, model, x)
    i_err = max(_close_scale(gx, wx, "invert x"), _close_scale(ge, we, "invert eps"))
    cpu = bundle_lib.load_bundle(dirs["diffusion"], "cpu")
    t0 = time.perf_counter()
    dc = cpu.call("denoise", x.cpu(), t.cpu())
    cpu_s = time.perf_counter() - t0
    c_err = _close_scale(dc, d, "denoise on the CPU against the card")
    print(f"[bundle] denoise vs the in-process model {d_err:.3e}, preview vs sampler.preview "
          f"{p_lv[0]} level(s) on {p_lv[1]:.2e}, invert ({dcfg.steps * b4} B4) vs "
          f"sampler.invert {i_err:.3e} (bound 1e-4 of the scale); the card's bundle on the CPU: "
          f"denoise at batch 1 {c_err:.3e} from the card's, load + call {cpu_s:.2f} s")
    del cpu

    # ---- the transfers
    gstate = ckpt_lib.restore(os.path.join(tmp, "ckpt-gan"), gan.init_gan_state(gcfg,
                                                                                  device="cuda"))
    xg = torch.from_numpy(rng.uniform(-1, 1, (1, size, size, 3)).astype(np.float32)).cuda()
    for dr in ("ab", "ba"):
        launches.reset()
        got = bundles["gan"].call(f"transfer_{dr}", xg)
        launches.take((b3_fwd, b4_fwd), f"bundle transfer_{dr}")
        with torch.inference_mode():
            want = gan.transfer(gcfg, gstate, xg, dr)
        lv = _levels(png.to_uint8(got.cpu().numpy()), png.to_uint8(want.cpu().numpy()),
                     f"bundle transfer_{dr}")
        print(f"[bundle] transfer_{dr}: B3/B4 ({b3_fwd}, {b4_fwd}); vs gan.transfer {lv[0]} "
              f"level(s) on {lv[1]:.2e}")
    del gstate
    kstate = ckpt_lib.restore(os.path.join(tmp, "ckpt-cgan"),
                              cgan.init_conditional_gan_state(kcfg, device="cuda"))
    target = torch.tensor([1], dtype=torch.int32, device="cuda")
    launches.reset()
    got = bundles["cgan"].call("transfer", xg, target)
    launches.take((kb3_fwd, kb4_fwd), "bundle transfer?to=1")
    with torch.inference_mode():
        want = cgan.transfer(kcfg, kstate, xg, target)
    lv = _levels(png.to_uint8(got.cpu().numpy()), png.to_uint8(want.cpu().numpy()),
                 "bundle transfer?to=1")
    print(f"[bundle] transfer to 1 (cGAN): B3/B4 ({kb3_fwd}, {kb4_fwd}); vs cgan.transfer "
          f"{lv[0]} level(s) on {lv[1]:.2e}")
    del kstate, bundles
    # timed under cuDNN's default algorithms, as [sample] times the sampler
    torch.backends.cudnn.deterministic = deterministic
    init = torch.from_numpy(rng.normal(size=(BUNDLE_BATCH, size, size, 3)).astype(
        np.float32)).cuda()

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / 3 / BUNDLE_BATCH

    def inproc():
        return sampler.sample(dcfg, model, init, snapshots=False).images

    def bundled():
        return db.call("sample", init)

    runs = [("in-process", ms(inproc)), ("bundle", ms(bundled)), ("bundle", ms(bundled)),
            ("in-process", ms(inproc))]
    print(f"[bundle] sample fp32 batch {BUNDLE_BATCH}, stride {dcfg.sample_stride} ({calls} "
          f"calls), ms per image in turns: {', '.join(f'{k} {v:.3f}' for k, v in runs)} "
          f"({card})")
    xx = torch.randn((1, 128, 128, 128), device="cuda")
    k = torch.randn((4, 4, 128, 256), device="cuda") * 0.05
    bb = torch.zeros(256, device="cuda")
    host = [("direct", host_ms(lambda: fdc._forward(xx, k, bb, True)) * 1e3),
            ("custom op", host_ms(lambda: torch.ops.gct2.down_conv_k4s2(xx, k, bb, True)) * 1e3),
            ("custom op", host_ms(lambda: torch.ops.gct2.down_conv_k4s2(xx, k, bb, True)) * 1e3),
            ("direct", host_ms(lambda: fdc._forward(xx, k, bb, True)) * 1e3)]
    print(f"[bundle] B4 eager host us a call (batch 1, 128² x 128 -> 256), in turns: "
          f"{', '.join(f'{k} {v:.2f}' for k, v in host)} ({card})")

    del model, db
    print(f"[bundle] launches B3/B4 of the bundles' checked calls {tuple(launches.total)}; the "
          f"phase took {time.perf_counter() - t_phase:.2f} s")
    torch.cuda.empty_cache()
    return dirs, tuple(launches.total)


def phase_serve_bundle(torch, fdc, norm, sampler, png, tmp, globs, dirs, card):
    """``serve/server.build_bundle_service`` on [bundle]'s diffusion, GAN and
    cGAN bundles, each behind the threaded Server and the AsyncServer on the
    card: /sample (num 1 and 3), /denoise, /transfer ab and ba and
    /transfer?to=1 answer what the bundle called in process gives on the
    replayed noise within 1 level, with exact B3/B4 launches, the two
    frontends' bytes equal; /edit, a stream and /reload are refused as in
    JAX (400). Then printed: /sample npy p50/p99 at concurrency 1 (120
    requests) and 8 (200). Returns the (B3, B4) launches of the checked
    requests."""
    import glob
    import io

    from gan_class_transfer2_tpu_torch.serve import server as srv_mod
    from gan_class_transfer2_tpu_torch.serve.aio import AsyncServer

    t_phase = time.perf_counter()
    launches = _Launches(norm.instance_norm_fused, fdc.down_conv_fused)
    t0 = time.perf_counter()
    svcs = {m: srv_mod.build_bundle_service(d, device="cuda") for m, d in dirs.items()}
    for svc in svcs.values():
        for name in svc.bundle.programs:
            svc.bundle.load(name)
    print(f"[serve-bundle] three bundle services built and their programs loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    ports = {}
    servers = []
    for m, svc in svcs.items():
        pair = [srv_mod.Server(svc).start(), AsyncServer(svc).start()]
        servers += pair
        ports[m] = tuple(s.port for s in pair)
    dsvc, gsvc, ksvc = svcs["diffusion"], svcs["gan"], svcs["cgan"]
    dcfg = dsvc.cfg
    size, calls = dcfg.size, len(sampler.sample_timesteps(dcfg))
    b4 = b4_per_call(fdc, dcfg, 1)
    _, _, (b3_fwd, b4_fwd) = gan_counts(fdc, gsvc.cfg, 1)
    _, _, (kb3_fwd, kb4_fwd) = gan_counts(fdc, ksvc.cfg, 1, conditional=True)
    raw = png.read_png(sorted(glob.glob(globs[0]))[0])
    off = (raw.shape[0] - size) // 2
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(raw[off:off + size, off:off + size]))
    body_npy = buf.getvalue()
    x = torch.from_numpy(srv_mod._decode_image(body_npy, size)).cuda()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # equal requests, equal bytes (see [serve])
    for num, padded in ((1, 1), (3, 4)):
        got, gen_state = _both(dsvc, ports["diffusion"], "/sample", json.dumps(
            {"num": num, "format": "npy"}).encode(), launches, (0, calls * b4),
            f"bundle /sample num {num}")
        want = dsvc._sample_prog(None, _replay(gen_state, (padded, size, size, 3)))
        lv = _levels(got, want[:num].cpu().numpy(), f"bundle /sample num {num}")
        print(f"[serve-bundle] /sample num {num} (device batch {padded}): {calls * b4} B4 per "
              f"frontend; npy vs the bundle in process {lv[0]} level(s) on {lv[1]:.2e}; "
              f"threaded = aio bytes")
    launches.reset()
    got, gen_state = _both(dsvc, ports["diffusion"], "/denoise?format=npy", body_npy, launches,
                           (0, b4), "bundle /denoise")
    want = dsvc.bundle.call("preview", x, _replay(gen_state, (1, size, size, 3)))
    lv = _levels(got, png.to_uint8(want.cpu().numpy()), "bundle /denoise")
    print(f"[serve-bundle] /denoise: {b4} B4 per frontend; vs the bundle's preview {lv[0]} "
          f"level(s) on {lv[1]:.2e}; threaded = aio bytes")
    for path, svc, m, want_l, prog, extra in (
            ("/transfer?direction=ab&format=npy", gsvc, "gan", (b3_fwd, b4_fwd), "transfer_ab",
             ()),
            ("/transfer?direction=ba&format=npy", gsvc, "gan", (b3_fwd, b4_fwd), "transfer_ba",
             ()),
            ("/transfer?to=1&format=npy", ksvc, "cgan", (kb3_fwd, kb4_fwd), "transfer",
             (torch.tensor([1], dtype=torch.int32, device="cuda"),))):
        got, _ = _both(svc, ports[m], path, body_npy, launches, want_l, f"bundle {path}")
        want = svc.bundle.call(prog, x, *extra)
        lv = _levels(got, png.to_uint8(want.cpu().numpy()), f"bundle {path}")
        print(f"[serve-bundle] {path}: B3/B4 {want_l} per frontend; vs the bundle in process "
              f"{lv[0]} level(s) on {lv[1]:.2e}; threaded = aio bytes")
    torch.backends.cudnn.deterministic = deterministic
    launches.reset()
    refused = []
    for port in ports["diffusion"]:
        for path, body in (("/edit", body_npy), ("/reload", b""),
                           ("/sample", json.dumps({"num": 1, "stream": True}).encode())):
            status, _, out = _http(port, "POST", path, body)
            err = json.loads(out).get("error", "")
            if status != 400 or not ("bundle" in err or "immutable" in err):
                fail(f"serve-bundle: {path} on port {port} answered {status} {out[:200]!r}")
            refused.append(err)
    launches.take((0, 0), "the refused requests")
    print(f"[serve-bundle] /edit, /reload and a stream refused with 400 on both frontends: "
          f"{sorted(set(refused))}")
    print(f"[serve-bundle] launches B3/B4 from the checked requests: {tuple(launches.total)}")
    for conc, per_thread in ((1, 120), (8, 25)):
        p50, p99, top, n = _latency(ports["diffusion"][0], "/sample",
                                    json.dumps({"num": 1, "format": "npy"}).encode(), conc,
                                    per_thread)
        print(f"[serve-bundle] latency /sample npy at concurrency {conc}: p50 {p50:.3f} ms, p99 "
              f"{p99:.3f} ms, max {top:.3f} ms over {n} requests ({card})")
    for s in servers:
        s.stop()
    for svc in svcs.values():
        svc.close()
    launches.reset()
    print(f"[serve-bundle] the phase took {time.perf_counter() - t_phase:.2f} s")
    torch.cuda.empty_cache()
    return tuple(launches.total)


# ------------------------------------- data parallelism over processes


DP_RANKS = 2  # [dp-*]: the ranks of one job; they share cuda:0 over gloo
DP_LOCAL = TRAIN_BATCH // DP_RANKS  # each rank's rows of the global batch of 16


def phase_dp_kernel(torch, fd, cfg, card):
    """B1s: the full-width batch of 16 × 256²×3 split into two blocks of 8;
    each block through B1s at position 0 and 1 must equal B1 on that block
    with the folded seed bit for bit, and its plain version within B1's
    bound; the two positions' ε differ. B1s on one block timed beside its
    bound. Returns the kernel's row (launches filled in by the caller)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    n = cfg.size * cfg.size * 3
    x = torch.rand((TRAIN_BATCH, n), generator=gen, device="cuda") * 2 - 1
    t = torch.randint(1, cfg.steps + 1, (TRAIN_BATCH,), generator=gen, device="cuda",
                      dtype=torch.int32)
    seed = torch.randint(0, 2**62, (1,), generator=gen, device="cuda")
    table = fd.scale_table(cfg.steps, cfg.schedule, "cuda")
    counts = fd.diffuse_fused.launches, fd.diffuse_fused_sharded.launches
    blocks = [(x[r * DP_LOCAL:(r + 1) * DP_LOCAL], t[r * DP_LOCAL:(r + 1) * DP_LOCAL])
              for r in range(DP_RANKS)]
    err = 0.0
    for xb, tb in blocks:
        for pos in range(DP_RANKS):
            y = fd.diffuse_fused_sharded(xb, tb, table, seed, pos)
            b1 = fd.diffuse_fused(xb, tb, table, fd.fold_seed(seed, pos))
            ref = fd.diffuse_sharded_plain(xb, tb, table, seed, pos)
            torch.cuda.synchronize()
            if not torch.equal(y, b1):
                fail(f"dp-kernel: B1s at position {pos} differs from B1 with the folded seed")
            err = max(err, (y - ref).abs().max().item())
    if not err <= DIFFUSE_ATOL:
        fail(f"dp-kernel: B1s vs plain max|err| {err} > {DIFFUSE_ATOL}")
    noise = torch.tensor([[0.0, 1.0]], device="cuda")  # ss = 0, sn = 1: the output is ε
    zero, t0 = torch.zeros_like(blocks[0][0]), torch.zeros_like(blocks[0][1])
    eps = [fd.diffuse_fused_sharded(zero, t0, noise, seed, p) for p in range(DP_RANKS)]
    same = (eps[0] == eps[1]).double().mean().item()
    if same > 1e-3:
        fail(f"dp-kernel: positions 0 and 1 drew the same ε in {same:.2%} of the elements")
    xb, tb = blocks[1]
    call = lambda: fd.diffuse_fused_sharded(xb, tb, table, seed, 1)  # noqa: E731
    ms = cuda_ms(call, reps=50)
    nbytes = 8 * xb.numel() + 4 * tb.numel() + 4 * table.numel()
    cold_ms, cold_lo, cold_hi = cold_device_ms(
        lambda i: (torch.rand_like(xb),),
        lambda xi: fd.diffuse_fused_sharded(xi, tb, table, seed, 1), "diffuse")
    plain_ms = cuda_ms(lambda: fd.diffuse_sharded_plain(xb, tb, table, seed, 1), reps=5)
    fd.diffuse_fused.launches, fd.diffuse_fused_sharded.launches = counts
    elems = xb.numel()
    bytes_ms = _bytes_ms(nbytes)
    ops = DIFFUSE_INT_PER_ELEMENT * elems, DIFFUSE_FLOAT_PER_ELEMENT * elems
    ops_ms = max(ops[0] / INT32_RATE, (ops[0] + ops[1]) / DISPATCH_RATE) * 1e3
    bound = max(bytes_ms, ops_ms)
    row = {"name": "diffuse_sharded_f32", "route": "cuda",
           "source": "gan_class_transfer2_tpu_torch/csrc/diffuse.cu",
           "replaces": "gan_class_transfer2_tpu/ops/kernels.py:209", "launches": 0,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "library_ms": None,
           "device_cold_ms": cold_ms}
    if not cold_ms >= bytes_ms:
        fail(f"dp-kernel: a cold device time of {cold_ms} ms is below the byte bound "
             f"{bytes_ms} ms: the reading is impossible, not fast")
    print(f"[dp-kernel] B1s, batch {TRAIN_BATCH} × {cfg.size}²×3 in {DP_RANKS} blocks of "
          f"{DP_LOCAL}, positions 0 and 1: bit for bit B1 with the folded seed; max|err| vs plain "
          f"{err:.3e} (bound {DIFFUSE_ATOL}); the positions' ε agree in {same:.2e} of the "
          f"elements; one block of {DP_LOCAL}: kernel {ms:.4f} ms back to back, device "
          f"{cold_ms:.4f} ms L2 cold (median of 24 launches over rotating inputs, "
          f"{cold_lo:.4f}–{cold_hi:.4f}), plain {plain_ms:.4f} ms; bound {bound:.4f} ms "
          f"({row['bound_by']}: {nbytes / 1e6:.2f} MB, {bytes_ms * 1e3:.2f} us at 3.35 TB/s; "
          f"operations {ops_ms * 1e3:.2f} us) on {card}; launches in this phase are comparisons "
          "(the main path's are [dp-train]'s)")
    del x, blocks, eps
    return row


def _dp_jobs(jobs, timeout=600):
    """Run ``jobs`` (each ``(mode, [spec of rank 0, spec of rank 1])``) at
    once, each as DP_RANKS processes of this script (``--dp-worker``) with a
    port of its own; returns each job's per-rank DPRESULT dicts. A rank
    that fails fails the smoke, with the end of its output."""
    import socket

    procs = []
    for mode, specs in jobs:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        procs.append([subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dp-worker", mode, str(k), str(port),
             json.dumps(specs[k])], cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for k in range(DP_RANKS)])
    results = []
    for (mode, _), ranks in zip(jobs, procs):
        outs = []
        for k, p in enumerate(ranks):
            out = p.communicate(timeout=timeout)[0]
            line = next((ln for ln in out.splitlines() if ln.startswith("DPRESULT ")), None)
            if p.returncode != 0 or line is None:
                fail(f"dp {mode} rank {k} exited {p.returncode}:\n{out[-3000:]}")
            outs.append(json.loads(line[len("DPRESULT "):]))
        results.append(outs)
    return results


def _dp_scalars(res, tag):
    return {step: v for t, v, step in res["scalars"] if t == tag}


def _dp_cli_specs(args, tmp, log):
    """Both ranks' ``cli`` arguments: the same, but each rank its own
    --log-dir, so that only the coordinator's may exist afterwards."""
    return [{"args": [*args, "--log-dir", os.path.join(tmp, f"{log}-r{k}")]}
            for k in range(DP_RANKS)]


def _dp_same(res, what):
    a, b = res
    for key in ("checksum", "step"):
        if a[key] != b[key]:
            fail(f"dp-train {what}: ranks differ in {key}: {a[key]} vs {b[key]}")
    sa = [(t, v, s) for t, v, s in a["scalars"] if t != "images_per_sec"]
    sb = [(t, v, s) for t, v, s in b["scalars"] if t != "images_per_sec"]
    if sa != sb or not sa:
        fail(f"dp-train {what}: the ranks' logged metrics differ: {sa} vs {sb}")
    if a["saves"] < 1 or b["saves"] != 0:
        fail(f"dp-train {what}: checkpoint saves rank 0 {a['saves']}, rank 1 {b['saves']}")


def phase_dp_train(torch, cli, fdc, fd, adam_kernel, norm, sampler, cfg, tmp, globs, globs3,
                   train_results, card):
    """Data parallelism through the user's commands: ``cli train
    --num-processes 1`` in this process (the parallel code at world size 1:
    B1 unfolded, B2 on, [train-cli]'s launches a step); then 2 processes of
    ``cli train --coordinator ... --num-processes 2 --process-id k`` sharing
    cuda:0 over gloo at the default width, global batch 16, the kernel path
    from an HBM pool of each rank's share of the PNG files: run A (2 epochs
    and one log_sample, its sampler split over the ranks) alone, then B
    (--epochs 1, then --epochs 2 restored) beside ``cli gan-train`` and
    ``cli cgan-train`` of CLI_STEPS steps and one log_sample. Exact launches
    a rank, equal metrics and weights on both ranks, checkpoints and events
    from rank 0 alone, B's epoch 1 against A's within [train-resume]'s
    1e-5. Returns {kernel row name: main-path launches}."""
    from gan_class_transfer2_tpu_torch.models import unet

    n_leaves = len(list(unet.Denoiser(cfg).parameters()))
    b4 = b4_per_call(fdc, cfg, DP_LOCAL)
    launches = {"diffuse_f32": 0, "diffuse_sharded_f32": 0, "adam_f32m": 0,
                "down_conv_k4s2_f32": 0, "instance_norm_f32": 0}
    hbm = ("--data-hbm", "288")
    t0 = time.perf_counter()
    got, secs = _run_cli(cli, (fd.diffuse_fused, fd.diffuse_fused_sharded, adam_kernel.adam_fused,
                               fdc.down_conv_fused),
                         _train_cli(cfg, tmp, "logs-dp1", "ckpt-dp1", "--epochs", "1",
                                    "--num-processes", "1", "--log-images-every", "0", *hbm))
    want = (CLI_STEPS, 0, CLI_STEPS * adam_kernel.launches_per_step(n_leaves),
            CLI_STEPS * b4_per_call(fdc, cfg, TRAIN_BATCH))
    if got != want:
        fail(f"dp-train world size 1: launches B1/B1s/B2/B4 {got}, expected {want} "
             "([train-cli]'s a step)")
    for name, n in zip(("diffuse_f32", "diffuse_sharded_f32", "adam_f32m", "down_conv_k4s2_f32"),
                       got):
        launches[name] += n
    print(f"[dp-train] cli train --num-processes 1: {CLI_STEPS} steps through the parallel code, "
          f"launches B1/B1s/B2/B4 {got} ([train-cli]'s a step: B1 unfolded, B2 on); "
          f"{secs:.2f} s")

    def train(log, ckpt, *extra):  # each rank its own --log-dir, one --checkpoint-dir
        return [{"args": _train_cli(cfg, tmp, f"{log}-r{k}", ckpt, *hbm, *extra)}
                for k in range(DP_RANKS)]

    t1 = time.perf_counter()
    (a,) = _dp_jobs([("cli", train("logs-dpA", "ckpt-dpA", "--epochs", "2",
                                   "--log-images-every", "2"))])
    secs_a = time.perf_counter() - t1
    sample_calls = len(sampler.sample_timesteps(cfg.replace(sample_stride=50)))
    want_a = {"B1": 0, "B1s": 2 * CLI_STEPS, "B2": 0, "B3": 0,
              "B4": (2 * CLI_STEPS + 1 + cfg.steps + sample_calls) * b4}
    for k, res in enumerate(a):
        if res["launches"] != want_a:
            fail(f"dp-train A rank {k}: launches {res['launches']}, expected {want_a}")
    _dp_same(a, "train A")
    events = [glob.glob(os.path.join(tmp, f"logs-dpA-r{k}", "*", "*", "events.out.tfevents.*"))
              for k in range(DP_RANKS)]
    if len(events[0]) != 1 or os.path.exists(os.path.join(tmp, "logs-dpA-r1")):
        fail(f"dp-train A: event files by rank {[len(e) for e in events]}")
    ckpt_files = sorted(os.listdir(os.path.join(tmp, "ckpt-dpA")))
    step = 2 * CLI_STEPS
    want_files = ["config.json", f"step_{step:09d}", f"step_{step:09d}.extra.host0.json",
                  f"step_{step:09d}.extra.host1.json", f"step_{step:09d}.extra.json"]
    if ckpt_files != want_files:
        fail(f"dp-train A: checkpoint dir holds {ckpt_files}, expected {want_files}")
    ips = _dp_scalars(a[0], "images_per_sec")
    loss_a = _dp_scalars(a[0], "loss")
    print(f"[dp-train] A: cli train, 2 ranks x {DP_LOCAL} rows (global batch {TRAIN_BATCH}), "
          f"{2 * CLI_STEPS} steps + one log_sample (its {2 + 4 * 1}-image sampler batch split "
          f"over the ranks): launches a rank {a[0]['launches']} (B1s 1 a step, B2 0); epoch "
          f"losses {loss_a[0]:.7f}, {loss_a[1]:.7f} on both ranks, weights' checksum "
          f"{a[0]['checksum']:.6f} on both; rank 0 saved {a[0]['saves']} checkpoints and the "
          f"events, rank 1 nothing but its data sidecar; epoch 1 (4 steps and rank 0's save): "
          f"{ips[1]:.3f} img/s — 2 ranks sharing one {card}, not a multi-card number; peak "
          f"memory a rank {a[0]['peak_gb']:.2f} GB; wall {a[0]['secs']:.2f} s")
    for res in a:
        launches["diffuse_sharded_f32"] += res["launches"]["B1s"]
        launches["down_conv_k4s2_f32"] += res["launches"]["B4"]

    gan_args = ["--device", "cuda", *_width(cfg, ("size", "pixel_size", "max_size", "octaves")),
                *GAN_FLAGS, "--compute-dtype", "float32", "--batch-size", str(TRAIN_BATCH),
                "--steps-per-epoch", str(CLI_STEPS), "--epochs", "1", "--checkpoint-every",
                str(CLI_STEPS), "--data-workers", "2"]
    jobs = [("cli", train("logs-dpB1", "ckpt-dpB", "--epochs", "1", "--log-images-every", "0")),
            ("cli", _dp_cli_specs(["gan-train", *gan_args, "--classes", *globs,
                                   "--checkpoint-dir", os.path.join(tmp, "ckpt-dpgan")],
                                  tmp, "logs-dpgan"))]
    t1 = time.perf_counter()
    b1, g = _dp_jobs(jobs)
    jobs = [("cli", train("logs-dpB2", "ckpt-dpB", "--epochs", "2", "--log-images-every", "0")),
            ("cli", _dp_cli_specs(["cgan-train", *gan_args, "--classes", *globs3,
                                   "--checkpoint-dir", os.path.join(tmp, "ckpt-dpcgan")],
                                  tmp, "logs-dpcgan"))]
    b2, cg = _dp_jobs(jobs)
    secs_b = time.perf_counter() - t1
    want_b = {"B1": 0, "B1s": CLI_STEPS, "B2": 0, "B3": 0, "B4": CLI_STEPS * b4}
    for name, res in (("B1", b1), ("B2", b2)):
        for k, r in enumerate(res):
            if r["launches"] != want_b:
                fail(f"dp-train {name} rank {k}: launches {r['launches']}, expected {want_b}")
            launches["diffuse_sharded_f32"] += r["launches"]["B1s"]
            launches["down_conv_k4s2_f32"] += r["launches"]["B4"]
        _dp_same(res, name)
    if b2[0]["step"] != 2 * CLI_STEPS:
        fail(f"dp-train B: the resumed job ended at step {b2[0]['step']}")
    loss_b = _dp_scalars(b2[0], "loss")
    rel = abs(loss_b[1] - loss_a[1]) / abs(loss_a[1])
    print(f"[dp-train] B: --epochs 1, then --epochs 2 restored at step {CLI_STEPS} on 2 ranks "
          f"(each rank's data sidecar, the full moments sliced again): epoch-1 loss "
          f"{loss_b[1]:.9f} against A's {loss_a[1]:.9f}, relative {rel:.3e} (bound 1e-5); "
          f"launches a rank {b2[0]['launches']} each call")
    if not rel <= 1e-5:
        fail(f"dp-train: the resumed two-rank epoch-1 loss differs by {rel} relative")
    for what, res, cond, fwd in (("gan-train", g, False, 3), ("cgan-train", cg, True, 3)):
        c = cfg.replace(batch_size=DP_LOCAL, g_norm="instance", d_norm="instance",
                        num_classes=3 if cond else 0)
        per_step, b4_step, (b3_fwd, b4_fwd) = gan_counts(fdc, c, DP_LOCAL, conditional=cond)
        want_g = {"B1": 0, "B1s": 0, "B2": 0,
                  "B3": CLI_STEPS * sum(per_step.values()) + fwd * b3_fwd,
                  "B4": CLI_STEPS * b4_step + fwd * b4_fwd}
        for k, r in enumerate(res):
            if r["launches"] != want_g:
                fail(f"dp-train {what} rank {k}: launches {r['launches']}, expected {want_g}")
            launches["instance_norm_f32"] += r["launches"]["B3"]
            launches["down_conv_k4s2_f32"] += r["launches"]["B4"]
        _dp_same(res, what)
        m = {t: _dp_scalars(res[0], t)[0] for t in ("g_loss", "d_loss", "cycle")}
        if not all(np.isfinite(v) for v in m.values()):
            fail(f"dp-train {what}: {m}")
        print(f"[dp-train] {what}: 2 ranks x {DP_LOCAL} rows a class, {CLI_STEPS} steps + one "
              f"log_sample ({fwd} generator forwards split over the ranks): launches a rank "
              f"{res[0]['launches']}; g {m['g_loss']:.5f} d {m['d_loss']:.5f} cycle "
              f"{m['cycle']:.5f} and the weights' checksum equal on both ranks; rank 0 alone "
              f"saved; {_dp_scalars(res[0], 'images_per_sec')[0]:.3f} img/s (2 ranks sharing one "
              f"{card}, beside train B, not a multi-card number)")
    print(f"[dp-train] the phase took {time.perf_counter() - t0:.2f} s (A {secs_a:.2f} s, B with "
          f"gan-train and cgan-train {secs_b:.2f} s)")
    return launches


def phase_dp_agree(card, train_results):
    """A two-rank injected step, replicated and under ZeRO-1, against the
    one-process injected step on the same global batch and weights at the
    default width (run in rank 0), [train-agree]'s bounds; the bytes of
    optimizer state a rank holds; an injected step of a batch-norm
    denoiser under remat (its recompute in the backward, on autograd's
    device thread, takes both ranks' statistics again) and a batch-norm GAN
    step (the statistics over both ranks' rows, R1's double backward
    through them) against one process; the two-rank train step on the kernel path (B1s, B4; B2 gated
    off) timed beside [train]'s one-process step, replicated and ZeRO-1;
    the gradient all-reduce and ZeRO-1's all-gather timed. Returns the
    batch-norm GAN ranks' B4 launches."""
    (res,) = _dp_jobs([("agree", [{}] * DP_RANKS)])
    r0, r1 = res
    for zero1 in ("replicated", "zero1"):
        a, b = r0[zero1], r1[zero1]
        if a["checksum"] != b["checksum"]:
            fail(f"dp-agree {zero1}: the ranks' weights differ")
        if a["launches"]["B2"] != 0 or a["launches"]["B4"] <= 0:
            fail(f"dp-agree {zero1}: launches {a['launches']}")
        print(f"[dp-agree] {zero1}: one injected step, 2 ranks x {DP_LOCAL} rows against one "
              f"process x {TRAIN_BATCH} (B2 in the one process, the optax-form update on the "
              f"ranks): loss {a['loss']:.7f} vs {r0['ref']['loss']:.7f} (rel {a['rel']:.2e}, "
              f"bound 1e-5); updates: max|Δ2 − Δ1| {a['max_diff']:.3e}, share beyond 1e-3·lr "
              f"{a['share']:.2e} (bound 1e-4); optimizer state a rank "
              f"{a['opt_bytes'] / 1e6:.1f} MB ({b['opt_bytes'] / 1e6:.1f} MB on rank 1); "
              + (f"{a['split_leaves']} of {a['leaves']} optimizer leaves split, each rank "
                 "holding half of each; " if a["split_leaves"] else "every leaf whole on each "
                 "rank; ") +
              f"step {a['step_ms']:.2f} ms (one process: {r0['ref']['step_ms']:.2f} ms) — 2 ranks "
              f"sharing one {card}, not a multi-card number")
        if not a["rel"] <= 1e-5 or not a["share"] <= 1e-4:
            fail(f"dp-agree {zero1}: loss rel {a['rel']}, share {a['share']}")
    if not r0["zero1"]["opt_bytes"] < 0.6 * r0["replicated"]["opt_bytes"]:
        fail("dp-agree: ZeRO-1 did not halve the optimizer state a rank holds")
    a, b = r0["remat_batch"], r1["remat_batch"]
    if a["checksum"] != b["checksum"]:
        fail("dp-agree batch-norm remat: the ranks' weights differ")
    if a["launches"]["B2"] != 0 or a["launches"]["B4"] <= 0:
        fail(f"dp-agree batch-norm remat: launches {a['launches']}")
    print(f"[dp-agree] batch-norm remat (g_norm=batch, remat, SGD with momentum lr 1e-3, B4 down "
          f"convs; the recompute on autograd's device thread): one injected step, 2 ranks x "
          f"{DP_LOCAL} rows against one process x {TRAIN_BATCH}: loss {a['loss']:.7f} vs "
          f"{a['ref_loss']:.7f} (rel {a['rel']:.2e}, bound 1e-5); updates: max|Δ2 − Δ1| "
          f"{a['max_diff']:.3e}, share beyond 1e-3·lr {a['share']:.2e} (bound 1e-4); launches a "
          f"rank {a['launches']}; step {a['step_ms']:.2f} ms")
    if not a["rel"] <= 1e-5 or not a["share"] <= 1e-4:
        fail(f"dp-agree batch-norm remat: loss rel {a['rel']}, share {a['share']}")
    g0, g1 = r0["gan_batch"], r1["gan_batch"]
    if g0["checksum"] != g1["checksum"] or g0["metrics"] != g1["metrics"]:
        fail("dp-agree batch-norm GAN: the ranks' weights or metrics differ")
    if g0["launches"]["B4"] <= 0 or g0["launches"]["B3"] != 0:
        fail(f"dp-agree batch-norm GAN: launches {g0['launches']}")
    print(f"[dp-agree] batch-norm GAN (g_norm=d_norm=batch, R1 weight 1, no DiffAugment, SGD "
          f"lr 1e-3, B4 down convs): one step, 2 ranks x {DP_LOCAL} rows a class against one "
          f"process x {TRAIN_BATCH}: metrics {g0['metrics']} vs {g0['ref']} (worst rel "
          f"{g0['rel']:.2e}, bound 1e-5); updates of the four nets max|Δ2 − Δ1| "
          f"{g0['max_diff']:.3e}, share beyond 1e-3·lr {g0['share']:.2e} (bound 1e-4); "
          f"launches a rank {g0['launches']}")
    if not g0["rel"] <= 1e-5 or not g0["share"] <= 1e-4:
        fail(f"dp-agree batch-norm GAN: metrics rel {g0['rel']}, share {g0['share']}")
    one = train_results[("float32", "kernels")]
    for name in ("replicated", "zero1"):
        ms = r0["train_ms"][name]
        print(f"[dp-agree] the train step on 2 ranks sharing one {card}, {name}, fp32 kernel "
              f"path (B1s, B4; B2 off), global batch {TRAIN_BATCH}: {ms:.2f} ms, "
              f"{TRAIN_BATCH / ms * 1e3:.3f} img/s, against [train]'s one process "
              f"{one['step_ms']:.2f} ms ({one['images_per_sec']} img/s) in this run; not a "
              "multi-card number")
    print(f"[dp-agree] collectives over gloo, host-staged (2 ranks sharing one {card}): the "
          f"gradient all-reduce of {r0['grad_mb']:.1f} MB (one flat float32 bucket) "
          f"{r0['allreduce_ms']:.2f} ms; ZeRO-1's all-gather of the updated slices "
          f"({r0['gather_mb']:.1f} MB a rank) {r0['gather_ms']:.2f} ms; ZeRO-1 step "
          f"{r0['zero1']['step_ms']:.2f} ms against the replicated two-rank step "
          f"{r0['replicated']['step_ms']:.2f} ms; peak memory rank 0 {r0['peak_gb']:.2f} GB")
    return {"down_conv_k4s2_f32": g0["launches"]["B4"] + g1["launches"]["B4"]}


def phase_dp_distill(torch, fdc, sampler, tmp, card, distill_ms):
    """Distillation over ranks (run beside [distill], before [serve]
    replaces [train-cli]'s train state with its served part): one job of
    DP_RANKS processes of this script sharing cuda:0 over gloo
    (``--dp-worker distill``). Each rank joins the group, then runs ``cli
    distill --coordinator ... --num-processes 2 --process-id k`` as a rank
    of it on [train-cli]'s checkpoint (one round of DISTILL_STEPS steps,
    stride 50 -> 100, global batch 16, its own --out and --log-dir): exact
    launches a rank (B4 three denoiser calls a step at DP_LOCAL rows, the
    grids' on rank 0 alone; B1, B1s, B2, B3 none), equal losses on both
    ranks, the student and the events written by rank 0 alone, its
    sample_stride doubled. Then one injected full-width step on two ranks
    against the one-process step on the global batch (loss 1e-5 relative,
    updates at [dp-agree]'s bounds), the two-rank step timed beside
    [distill]'s one-process step, and the gradient all-reduce timed. Returns
    the ranks' B4 launches."""
    from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt_lib

    t_phase = time.perf_counter()
    ckpt = os.path.join(tmp, "ckpt-cli")
    dcfg = ckpt_lib.load_config(ckpt)
    stride = 2 * dcfg.sample_stride
    grid = (len(sampler.sample_timesteps(dcfg))
            + len(sampler.sample_timesteps(dcfg.replace(sample_stride=stride))))
    b4, b4_grid = b4_per_call(fdc, dcfg, DP_LOCAL), b4_per_call(fdc, dcfg, 6)
    outs = [os.path.join(tmp, f"ckpt-dp-distill-r{k}") for k in range(DP_RANKS)]
    logs = [os.path.join(tmp, f"logs-dp-distill-r{k}") for k in range(DP_RANKS)]
    specs = [{"ckpt": ckpt, "args": ["distill", "--device", "cuda", "--checkpoint-dir", ckpt,
                                     "--out", outs[k], "--log-dir", logs[k],
                                     "--distill-steps", str(DISTILL_STEPS)]}
             for k in range(DP_RANKS)]
    (res,) = _dp_jobs([("distill", specs)])
    r0, r1 = res
    for k, r in enumerate(res):
        want = {"B1": 0, "B1s": 0, "B2": 0, "B3": 0,
                "B4": 3 * DISTILL_STEPS * b4 + (grid * b4_grid if k == 0 else 0)}
        if r["rc"] != 0 or r["launches"] != want:
            fail(f"dp-distill rank {k}: rc {r['rc']}, launches {r['launches']}, expected {want}")
    tag = f"distill_loss/stride_{stride}"
    losses = [[v for t, v, _ in r["scalars"] if t == tag] for r in res]
    if not losses[0] or losses[0] != losses[1] or not all(np.isfinite(losses[0])):
        fail(f"dp-distill: the ranks' losses {losses}")
    if r0["saves"] != 1 or r1["saves"] != 0 or os.path.exists(outs[1]) or os.path.exists(logs[1]):
        fail(f"dp-distill: saves rank 0 {r0['saves']}, rank 1 {r1['saves']}; rank 1's --out "
             f"{os.path.exists(outs[1])}, --log-dir {os.path.exists(logs[1])}")
    if ckpt_lib.load_config(outs[0]).sample_stride != stride or not glob.glob(
            os.path.join(logs[0], "*", "*", "events.out.tfevents.*")):
        fail("dp-distill: rank 0's student lacks sample_stride "
             f"{stride} or its events")
    print(f"[dp-distill] cli distill on 2 ranks sharing cuda:0 (gloo), stride "
          f"{dcfg.sample_stride} -> {stride}, {DISTILL_STEPS} steps at global batch "
          f"{TRAIN_BATCH} ({DP_LOCAL} rows a rank): launches rank 0 {r0['launches']}, rank 1 "
          f"{r1['launches']}; losses equal on both ranks {[round(v, 7) for v in losses[0]]}; "
          f"rank 0 alone wrote the student (sample_stride {stride}) and the events; wall "
          f"{r0['secs']:.2f} s")
    if not r0["rel"] <= 1e-5 or not r0["share"] <= 1e-4:
        fail(f"dp-distill: injected step loss rel {r0['rel']}, share {r0['share']}")
    print(f"[dp-distill] one injected full-width distill step, 2 ranks x {DP_LOCAL} rows "
          f"against one process x {TRAIN_BATCH}: loss {r0['loss']:.7f} vs {r0['ref_loss']:.7f} "
          f"(rel {r0['rel']:.2e}, bound 1e-5); updates max|Δ2 − Δ1| {r0['max_diff']:.3e}, "
          f"share beyond 1e-3·lr {r0['share']:.2e} (bound 1e-4)")
    print(f"[dp-distill] the distill step on 2 ranks sharing one {card}, fp32 kernel path, "
          f"global batch {TRAIN_BATCH}: {r0['step_ms']:.2f} ms against [distill]'s one-process "
          f"step {distill_ms:.2f} ms in this run; the gradient all-reduce "
          f"({r0['grad_mb']:.1f} MB over gloo) {r0['allreduce_ms']:.2f} ms; peak memory rank 0 "
          f"{r0['peak_gb']:.2f} GB; not a multi-card number; the phase took "
          f"{time.perf_counter() - t_phase:.2f} s")
    return r0["launches"]["B4"] + r1["launches"]["B4"]


def phase_serve_mesh(torch, fdc, norm, sampler, png, tmp, globs, card):
    """Serving over in-process replicas: ``build_service`` with the host's
    device list stubbed to [cuda:0, cuda:0] (two replicas of every serving
    module on the one card, a ``parallel/mesh.LocalMesh``) on [train-cli]'s
    diffusion, [gan-train-cli]'s GAN and [cgan-train-cli]'s cGAN
    checkpoints, against ``build_service`` without the stub (one replica),
    in-process from the same generator state: /sample num 1, 3 and 5 within
    1 level, the stream and /denoise within 2e-4, /transfer ab, ba and ?to=
    within 2e-4, of one image (the first replica alone) and of two (one a
    replica), with exact launches. From HTTP on both frontends: exact B3/B4
    launches (each replica runs its block; a request of one image, the
    first replica alone), equal bytes, within 1 level / 2e-4 of the
    one-replica service. /reload swaps both replicas. Then p50/p99 of
    /sample npy at concurrency 1 and 8 for both services, and the card
    memory each service holds. Returns the (B3, B4) launches of the checked
    requests."""
    import gc
    import io

    from gan_class_transfer2_tpu_torch.parallel import mesh as mesh_lib
    from gan_class_transfer2_tpu_torch.serve import server as srv_mod
    from gan_class_transfer2_tpu_torch.serve.aio import AsyncServer
    from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt_lib

    t_phase = time.perf_counter()
    launches = _Launches(norm.instance_norm_fused, fdc.down_conv_fused)
    reset = launches.reset
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # equal requests, equal bytes
    kinds = {"diffusion": "ckpt-cli", "gan": "ckpt-gan", "cgan": "ckpt-cgan"}
    cfgs = {m: ckpt_lib.load_config(os.path.join(tmp, d)).replace(
        checkpoint_dir=os.path.join(tmp, d)).validate() for m, d in kinds.items()}
    mem, plain, meshed = {}, {}, {}
    real = mesh_lib.local_devices
    for m, c in cfgs.items():
        for name, out in (("one", plain), ("two", meshed)):
            gc.collect()
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            if name == "two":
                mesh_lib.local_devices = lambda device: [torch.device("cuda", 0)] * 2
            try:
                out[m] = srv_mod.build_service(c, m, "cuda")
            finally:
                mesh_lib.local_devices = real
            mem[(m, name)] = torch.cuda.memory_allocated() - before
        if plain[m].mesh is not None or meshed[m].mesh is None or meshed[m].mesh.size != 2:
            fail(f"serve-mesh: {m}: meshes {plain[m].mesh} / {meshed[m].mesh}")
    print("[serve-mesh] services built, one replica / two on cuda:0: card memory "
          + ", ".join(f"{m} {mem[(m, 'one')] / 2**20:.1f} / {mem[(m, 'two')] / 2**20:.1f} MiB"
                      for m in cfgs) + f" ({card})")
    dcfg, gcfg, kcfg = cfgs["diffusion"], cfgs["gan"], cfgs["cgan"]
    size, calls = dcfg.size, len(sampler.sample_timesteps(dcfg))
    raw = png.read_png(sorted(glob.glob(globs[0]))[0])
    off = (raw.shape[0] - size) // 2
    img = np.ascontiguousarray(raw[off:off + size, off:off + size])
    buf = io.BytesIO()
    np.save(buf, img)
    body_npy = buf.getvalue()
    x = srv_mod._decode_image(body_npy, size)
    d1, d2 = plain["diffusion"], meshed["diffusion"]

    def same_noise(fn1, fn2, svc1, svc2):
        state = svc1._gen.get_state()
        a = fn1()
        svc2._gen.set_state(state)
        return a, fn2()

    # ---- in process: the two-replica service against the one-replica one;
    # a batch of one runs whole on the first replica, two or more split
    for num in (1, 3, 5):
        a, b = same_noise(lambda: d1._run_sample(num), lambda: d2._run_sample(num), d1, d2)
        lv = _levels(b, a, f"/sample num {num}, two replicas against one")
        bucket = d2._pad_bucket(num)
        rows = f"{bucket // 2} rows a replica" if bucket >= 2 else "on the first replica"
        print(f"[serve-mesh] sample num {num} (bucket {bucket}, {rows}): "
              f"{lv[0]} level(s) on {lv[1]:.2e} of the values from one replica")
    _, _, (b3_g, b4_g) = gan_counts(fdc, gcfg, 1)
    _, _, (b3_k, b4_k) = gan_counts(fdc, kcfg, 1, conditional=True)
    b4_d = b4_per_call(fdc, dcfg, 1)
    errs = {}
    for n in (2, 1):  # a block of one image a replica, then one image on the first
        xs = np.concatenate([x, x[:, ::-1]])[:n]
        a, b = same_noise(lambda: list(d1._sample_stream_impl(n, 2)),
                          lambda: list(d2._sample_stream_impl(n, 2)), d1, d2)
        errs[f"stream num {n}"] = max(float(np.abs(u - v).max()) for u, v in zip(a, b))
        launches.reset()
        a, b = same_noise(lambda: d1._run_denoise(xs), lambda: d2._run_denoise(xs), d1, d2)
        launches.take((0, b4_per_call(fdc, dcfg, n) + n * b4_d),
                      f"in-process /denoise of {n} on one and two replicas")
        errs[f"denoise {n}"] = float(np.abs(a - b).max())
        for d in ("ab", "ba"):
            a = plain["gan"]._run_transfer(xs, d)
            launches.reset()
            b = meshed["gan"]._run_transfer(xs, d)
            launches.take((n * b3_g, n * b4_g), f"in-process transfer {d} of {n} over two replicas")
            errs[f"transfer {d} {n}"] = float(np.abs(a - b).max())
        tgt = np.array([2, 0], np.int32)[:n]
        a = plain["cgan"]._run_cgan_transfer(xs, tgt)
        launches.reset()
        b = meshed["cgan"]._run_cgan_transfer(xs, tgt)
        launches.take((n * b3_k, n * b4_k), f"in-process transfer_to of {n} over two replicas")
        errs[f"transfer_to {n}"] = float(np.abs(a - b).max())
    if not all(e <= 2e-4 for e in errs.values()):
        fail(f"serve-mesh: two replicas against one: {errs} (bound 2e-4)")
    print(f"[serve-mesh] two replicas against one (2 images: one a replica; 1 image: on the "
          f"first, launches exact), max|Δ| (bound 2e-4): "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))

    # ---- HTTP: exact launches on both frontends, bytes equal, one replica's answer
    servers = {m: (srv_mod.Server(s).start(), AsyncServer(s).start()) for m, s in meshed.items()}
    ports = {m: tuple(s.port for s in pair) for m, pair in servers.items()}
    checks = [("diffusion", "/sample", json.dumps({"num": 3, "format": "npy"}).encode(),
               (0, 2 * calls * b4_per_call(fdc, dcfg, 2))),
              ("diffusion", "/sample", json.dumps({"num": 1, "format": "npy"}).encode(),
               (0, calls * b4_d)),
              ("diffusion", "/denoise?format=npy", body_npy, (0, b4_d)),
              ("gan", "/transfer?direction=ab&format=npy", body_npy, (b3_g, b4_g)),
              ("cgan", "/transfer?to=2&format=npy", body_npy, (b3_k, b4_k))]
    for m, path, body, want in checks:
        got, gen_state = _both(meshed[m], ports[m], path, body, launches, want,
                               f"two replicas {m} {path}")
        if path == "/sample":  # the one-replica service on the same noise
            num = got.shape[0]
            plain[m]._gen.set_state(gen_state)
            lv = _levels(got, plain[m]._run_sample(num), f"/sample num {num} over HTTP against "
                         "one replica")
        else:
            lv = None
        print(f"[serve-mesh] {m} {path} {len(body)} B over two replicas: launches B3/B4 {want} "
              f"per frontend, "
              f"threaded = aio bytes" + ("" if lv is None else
                                         f"; {lv[0]} level(s) on {lv[1]:.2e} from one replica"))
    old = list(d2._replicas)
    step = json.loads(_ok(ports["diffusion"][0], "/reload"))["step"]
    if len(d2._replicas) != 2 or any(n is o for n, o in zip(d2._replicas, old)) \
            or step != d1.step:
        fail(f"serve-mesh: /reload gave step {step} and replicas {d2._replicas}")
    del old
    reset()
    print(f"[serve-mesh] /reload swapped both replicas (step {step}); launches B3/B4 from the "
          f"checked requests {tuple(launches.total)}; the checks took "
          f"{time.perf_counter() - t_phase:.2f} s")

    # ---- batch norm: the bucket padded to the replicas' extent as JAX pads
    # it, then run whole on the first device, against the CPU service
    from gan_class_transfer2_tpu_torch.train import gan as gan_lib

    bcfg = gcfg.replace(g_norm="batch", checkpoint_dir="").validate()
    services = {}
    for dev, devices in (("cuda", [torch.device("cuda", 0)] * 2), ("cpu", ["cpu", "cpu"])):
        gs = gan_lib.init_gan_state(bcfg, torch.Generator().manual_seed(3), device=dev)
        services[dev] = srv_mod.ModelService(bcfg, gan_state=gs, mesh=devices, device=dev)
    bn, bn_cpu = services["cuda"], services["cpu"]
    if bn.mesh is not None or bn._pad_bucket(1) != 2:
        fail(f"serve-mesh batch norm: mesh {bn.mesh}, bucket of 1 {bn._pad_bucket(1)}")
    _, _, (_, b4_bn) = gan_counts(fdc, bcfg, 2)
    reset()
    got = bn._run_transfer(x, "ab")
    launches.take((0, b4_bn), "batch-norm /transfer of 1 image, 2 rows on the first device")
    want = bn_cpu._run_transfer(x, "ab")
    alone = gan_lib.make_transfer_fn(bcfg)(bn_cpu._generators["ab"], torch.from_numpy(x)).numpy()
    err = float(np.abs(got - want).max())
    print(f"[serve-mesh] batch-norm GAN over two replicas: /transfer ab of 1 image padded to "
          f"{bn._pad_bucket(1)} rows and run whole on cuda:0, launches B3/B4 (0, {b4_bn}); "
          f"max|Δ| against the CPU service {err:.3e} (bound 2e-4); the padding row moves the "
          f"answer by {float(np.abs(want - alone).max()):.3e} from the image run alone")
    if not err <= 2e-4:
        fail(f"serve-mesh batch norm: /transfer differs from the CPU service by {err}")
    for svc in services.values():
        svc.close()
    del services, bn, bn_cpu
    torch.backends.cudnn.deterministic = deterministic

    # ---- measured and printed: latency and the peak memory of a request
    one = srv_mod.Server(d1).start()
    body = json.dumps({"num": 1, "format": "npy"}).encode()
    for name, port in (("one replica", one.port), ("two replicas", ports["diffusion"][0])):
        for conc, per_thread in ((1, 120), (8, 25)):
            p50, p99, top, n = _latency(port, "/sample", body, conc, per_thread)
            print(f"[serve-mesh] latency /sample npy, {name}, concurrency {conc}: p50 "
                  f"{p50:.3f} ms, p99 {p99:.3f} ms, max {top:.3f} ms over {n} requests ({card})")
    for name, svc in (("one replica", d1), ("two replicas", d2)):
        gc.collect()
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        svc._run_sample(16)
        torch.cuda.synchronize()
        print(f"[serve-mesh] {name}: one /sample device batch of 16 peaks "
              f"{(torch.cuda.max_memory_allocated() - resident) / 2**20:.1f} MiB above the "
              f"{resident / 2**20:.1f} MiB every service of the phase holds ({card})")
    one.stop()
    for pair in servers.values():
        for s in pair:
            s.stop()
    for s in plain.values():
        s.close()
    reset()
    print(f"[serve-mesh] the phase took {time.perf_counter() - t_phase:.2f} s")
    torch.cuda.empty_cache()
    return tuple(launches.total)


def _rank_cli(rank, port, spec):
    """``cli.main`` as this rank of a [dp-train] or [dp-distill] job, with
    the launch counts set to 0 just before and read just after, the logged
    scalars (every rank's writer, the coordinator's real one or a
    NullWriter) and the checkpoint saves recorded. Returns {"rc", "secs",
    "launches", "scalars", "saves"}."""
    from gan_class_transfer2_tpu_torch import cli
    from gan_class_transfer2_tpu_torch.ops import adam_kernel
    from gan_class_transfer2_tpu_torch.ops import fused_diffusion as fd
    from gan_class_transfer2_tpu_torch.ops import fused_down_conv as fdc
    from gan_class_transfer2_tpu_torch.ops import norm
    from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt_lib
    from gan_class_transfer2_tpu_torch.utils import tensorboard as tb

    scalars, saves = [], [0]
    write, save = tb.SummaryWriter.scalar, ckpt_lib.save

    def scalar(self, tag, value, step):
        scalars.append((tag, float(value), int(step)))
        if isinstance(self, tb.SummaryWriter):
            write(self, tag, value, step)

    def counted_save(*a, **k):
        saves[0] += 1
        return save(*a, **k)

    tb.SummaryWriter.scalar = tb.NullWriter.scalar = scalar
    ckpt_lib.save = counted_save
    counters = {"B1": fd.diffuse_fused, "B1s": fd.diffuse_fused_sharded,
                "B2": adam_kernel.adam_fused, "B3": norm.instance_norm_fused,
                "B4": fdc.down_conv_fused}
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    rc = cli.main([*spec["args"], "--coordinator", f"127.0.0.1:{port}", "--num-processes",
                   str(DP_RANKS), "--process-id", str(rank)])
    return {"rc": rc, "secs": time.perf_counter() - t0, "scalars": scalars, "saves": saves[0],
            "launches": {k: c.launches for k, c in counters.items()}}


def _dp_cli_worker(torch, rank, port, spec):
    """One rank of a [dp-train] job (``_rank_cli``), with the weights'
    checksum recorded when the runner closes."""
    from gan_class_transfer2_tpu_torch.parallel import mesh as mesh_lib
    from gan_class_transfer2_tpu_torch.train import conditional_gan_loop, gan_loop, loop

    from gan_class_transfer2_tpu_torch.train import trainer

    closing = {}
    for cls in (loop.Runner, gan_loop.GANRunner, conditional_gan_loop.ConditionalGANRunner):
        def close(self, _close=cls.close):
            if mesh_lib.model_axis_size(self.mesh) > 1:  # the weights and EMA gathered whole
                whole = [p.detach() for m in (
                    mesh_lib.whole_module(self.state.model, self.mesh),
                    mesh_lib.whole_module(trainer.eval_model(self.state), self.mesh))
                    for p in m.parameters()]
                closing["whole_sha"] = _sha(whole)
                closing["checksum"] = float(sum(t.double().sum() for t in whole))
            else:
                closing["checksum"] = float(sum(
                    t.double().sum() for p, t in mesh_lib._leaves(self.state)
                    if not mesh_lib._is_opt_state_path(p)))
            closing["step"] = int(self.state.step)
            return _close(self)

        cls.close = close
    out = _rank_cli(rank, port, spec)
    print("DPRESULT " + json.dumps({
        "rank": rank, **out, "peak_gb": torch.cuda.max_memory_allocated() / 1e9, **closing}),
        flush=True)
    return out["rc"]


def _dp_agree_worker(torch, rank, port):
    """One rank of [dp-agree] (see phase_dp_agree)."""
    from gan_class_transfer2_tpu_torch.config import Config
    from gan_class_transfer2_tpu_torch.models import api
    from gan_class_transfer2_tpu_torch.ops import adam_kernel
    from gan_class_transfer2_tpu_torch.ops import fused_down_conv as fdc
    from gan_class_transfer2_tpu_torch.parallel import mesh as mesh_lib
    from gan_class_transfer2_tpu_torch.parallel import multihost
    from gan_class_transfer2_tpu_torch.train import trainer

    dev = "cuda"
    torch.backends.cudnn.allow_tf32 = False
    multihost.initialize(f"127.0.0.1:{port}", DP_RANKS, rank, device=dev)
    mesh = mesh_lib.make_mesh(device=dev)
    lr = 1e-3
    base = Config()
    cfg = base.replace(batch_size=TRAIN_BATCH, optimizer="adam_fused",
                       lr_schedule="constant", learning_rate=lr).validate()
    r = np.random.default_rng(9)
    x = torch.from_numpy(r.uniform(-1, 1, (TRAIN_BATCH, cfg.size, cfg.size, 3))
                         .astype(np.float32)).to(dev)
    t = torch.from_numpy(r.integers(1, cfg.steps + 1, TRAIN_BATCH).astype(np.int32))
    eps = torch.from_numpy(r.standard_normal(tuple(x.shape)).astype(np.float32)).to(dev)
    init = api.init_denoiser(cfg, device="cpu")
    p0 = [p.detach().to(dev) for p in init.parameters()]
    sync = torch.cuda.synchronize

    def timed(fn, reps=3, ranks=True):  # ranks=False: rank 0's one-process step alone
        return _ranks_ms(torch, multihost, fn, reps, ranks)

    def run(c, on_mesh, net=init):
        start = [p.detach().to(dev) for p in net.parameters()]
        model = copy.deepcopy(net).to(dev)
        state = trainer.TrainState(0, model, trainer.make_optimizer(c).init(
            list(model.parameters())), None, None)
        rows = (x, t, eps)
        if on_mesh:
            sh = mesh_lib.state_shardings(state, mesh, c.zero1)
            state = mesh_lib.shard_state(state, sh, mesh)
            rows = tuple(mesh_lib.local_rows(v, mesh) for v in rows)
        step = trainer.make_injected_train_step(c, mesh if on_mesh else None)
        fdc.down_conv_fused.launches = adam_kernel.adam_fused.launches = 0
        state, loss = step(state, *rows)
        sync()
        out = {"loss": float(loss),
               "launches": {"B2": adam_kernel.adam_fused.launches,
                            "B4": fdc.down_conv_fused.launches},
               "delta": [(p.detach() - q) for p, q in zip(model.parameters(), start)],
               "checksum": float(sum(p.detach().double().sum() for p in model.parameters())),
               "opt_bytes": mesh_lib.opt_state_bytes(state)}
        if on_mesh:
            split = [n for n, s in sh.items() if s]
            out["split_leaves"], out["leaves"] = len(split), sum(
                1 for p, _ in mesh_lib._leaves(state) if mesh_lib._is_opt_state_path(p))
        holder = [state]

        def again():
            holder[0], _ = step(holder[0], *rows)

        out["step_ms"] = timed(again, ranks=on_mesh)
        return out

    def against(res, ref):  # rank 0: the two-rank step against the one process's
        if rank == 0:
            res["rel"] = abs(res["loss"] - ref["loss"]) / abs(ref["loss"])
            diff = torch.cat([(a - b).abs().flatten() for a, b in zip(res["delta"], ref["delta"])])
            res["max_diff"] = diff.max().item()
            res["share"] = (diff > 1e-3 * lr).double().mean().item()
        del res["delta"]
        return res

    out = {}
    if rank == 0:
        ref = run(cfg, False)  # one process: B2 on
        out["ref"] = {"loss": ref["loss"], "step_ms": ref["step_ms"]}
    for name, zero1 in (("replicated", False), ("zero1", True)):
        out[name] = against(run(cfg.replace(zero1=zero1), True), ref if rank == 0 else None)
    # batch norms under remat: the inner octaves are recomputed in the
    # backward on autograd's device thread, and must take the statistics
    # over both ranks' rows again (SGD with momentum: a conv bias ahead of a
    # norm has only rounding noise for a gradient, which Adam's normalised
    # step would turn into updates of either sign)
    bcfg = cfg.replace(g_norm="batch", remat=True, optimizer="momentum").validate()
    bnet = api.init_denoiser(bcfg, device="cpu")
    bref = run(bcfg, False, bnet) if rank == 0 else None
    out["remat_batch"] = against(run(bcfg, True, bnet), bref)
    if rank == 0:
        out["remat_batch"]["ref_loss"] = bref["loss"]
        del bref
    out["gan_batch"] = _dp_gan_batch(torch, rank, mesh, base)
    # the train step on the kernel path, timed (B1s and B4; B2 is gated off)
    out["train_ms"] = {}
    tc = base.replace(batch_size=TRAIN_BATCH, optimizer="adam_fused",
                      fused_diffusion=True).validate()
    gen = torch.Generator(device=dev).manual_seed(0)
    xb = mesh_lib.local_rows(torch.rand((TRAIN_BATCH, tc.size, tc.size, 3), generator=gen,
                                        device=dev) * 2 - 1, mesh)
    torch.backends.cudnn.allow_tf32 = True  # the step holds IEEE fp32 itself
    for name, zero1 in (("replicated", False), ("zero1", True)):
        c = tc.replace(zero1=zero1)
        holder = [mesh_lib.init_sharded_state(c, mesh)[0]]
        step = mesh_lib.make_parallel_train_step(c, mesh)

        def train():
            holder[0], _ = step(holder[0], xb, gen)

        for _ in range(2):
            train()
        out["train_ms"][name] = timed(train, reps=5)
        del holder
    grads = [torch.randn_like(p) for p in p0]
    out["grad_mb"] = sum(g.numel() for g in grads) * 4 / 1e6
    out["allreduce_ms"] = timed(lambda: multihost.all_reduce_mean(grads), reps=5)
    half = torch.cat([mesh_lib._data_slice(g, mesh).reshape(-1) for g in grads
                      if mesh_lib._zero1_spec(g, mesh)])
    out["gather_mb"] = half.numel() * 4 / 1e6
    out["gather_ms"] = timed(lambda: multihost.all_gather(half), reps=5)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    multihost.shutdown()
    print("DPRESULT " + json.dumps(out), flush=True)
    return 0


def _dp_gan_batch(torch, rank, mesh, base):
    """One cycle-GAN step at full width with batch norms in both generators
    and discriminators, R1 (its double backward through the norms), no
    DiffAugment (the step draws nothing), B4 for the down convs: the
    two-rank step on each rank's 8 rows a class against the one-process
    step on the 16 (rank 0 alone). Returns the metrics, their relative
    error, the update share, the launches and a checksum."""
    from gan_class_transfer2_tpu_torch.ops import fused_down_conv as fdc
    from gan_class_transfer2_tpu_torch.ops import norm
    from gan_class_transfer2_tpu_torch.parallel import mesh as mesh_lib
    from gan_class_transfer2_tpu_torch.parallel import multihost
    from gan_class_transfer2_tpu_torch.train import gan

    lr = 1e-3
    cfg = base.replace(batch_size=TRAIN_BATCH, g_norm="batch", d_norm="batch", r1_weight=1.0,
                       diffaug="", optimizer="sgd", learning_rate=lr,
                       lr_schedule="constant").validate()
    r = np.random.default_rng(10)
    a, b = (torch.from_numpy(r.uniform(-1, 1, (TRAIN_BATCH, cfg.size, cfg.size, 3))
                             .astype(np.float32)).cuda() for _ in range(2))

    def nets(st):
        return [p.detach().clone() for m in (st.g_ab, st.g_ba, st.d_a, st.d_b)
                for p in m.parameters()]

    p0 = nets(gan.init_gan_state(cfg, device="cuda"))
    if rank == 0:
        st, m = gan.make_gan_train_step(cfg)(gan.init_gan_state(cfg, device="cuda"), a, b, None)
        ref = {k: float(v) for k, v in m.items()}
        ref_delta = [p - q for p, q in zip(nets(st), p0)]
        del st
    multihost.barrier()
    counts = fdc.down_conv_fused.launches, norm.instance_norm_fused.launches
    st, m = mesh_lib.make_parallel_gan_train_step(cfg, mesh)(
        gan.init_gan_state(cfg, device="cuda"), mesh_lib.local_rows(a, mesh),
        mesh_lib.local_rows(b, mesh), None)
    torch.cuda.synchronize()
    res = {"metrics": {k: float(v) for k, v in m.items()},
           "launches": {"B4": fdc.down_conv_fused.launches - counts[0],
                        "B3": norm.instance_norm_fused.launches - counts[1]},
           "checksum": float(sum(p.double().sum() for p in nets(st)))}
    if rank == 0:
        res["ref"] = ref
        res["rel"] = max(abs(res["metrics"][k] - v) / max(abs(v), 1e-12) for k, v in ref.items())
        diff = torch.cat([(p - q - d).abs().flatten() for p, q, d in zip(nets(st), p0, ref_delta)])
        res["max_diff"] = diff.max().item()
        res["share"] = (diff > 1e-3 * lr).double().mean().item()
        del ref_delta, diff
    del st, p0
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------------- tensor parallelism

TP_RANKS = 2  # [tp-*]: mesh_model of the jobs; the ranks share cuda:0 over gloo
TP_GAN_BATCH = 8  # [tp-gan]: images a class (two full GAN steps' activations on one card)


def phase_tp_kernel(torch, F, fdc, card):
    """B4 at the local shapes of ``mesh_model=2``: each full-width down conv
    with its output channels halved, batch 16, float32 and bfloat16,
    against the plain version (KERNEL_RTOL of max|y|), and timed beside
    cuDNN on the same local shape and the bound. Returns {dtype: sums over
    the four shapes}."""
    from gan_class_transfer2_tpu_torch.models import unet

    gen = torch.Generator(device="cuda").manual_seed(21)
    out = {}
    # IEEE float32 for the plain version and cuDNN, as [kernel] runs them:
    # the phases before this one train under torch's TF32 default
    with unet.ieee_fp32(torch.float32, torch.device("cuda")):
        for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            out[dtype_name] = _tp_kernel_dtype(torch, F, fdc, card, gen, dtype_name, dtype)
    return out


def _tp_kernel_dtype(torch, F, fdc, card, gen, dtype_name, dtype):
    """phase_tp_kernel at one dtype: the sums over the four shapes."""
    s = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, max_abs_err=0.0, shapes=0)
    for (hw, c, o) in SHAPES:
        ol = o // TP_RANKS
        if not fdc.supported((TRAIN_BATCH, hw, hw, c), (4, 4, c, ol)):
            print(f"[tp-kernel] {dtype_name} {hw}²×{c} -> {ol} (of {o}): the gate refuses "
                  "this local shape; cuDNN runs it")
            continue
        x = torch.randn((TRAIN_BATCH, hw, hw, c), generator=gen, device="cuda").to(dtype)
        k = (torch.randn((4, 4, c, ol), generator=gen, device="cuda") / (16 * c) ** 0.5
             ).to(dtype)
        b = (torch.randn((ol,), generator=gen, device="cuda") * 0.1).to(dtype)
        before = fdc.down_conv_fused.launches
        with torch.inference_mode():
            y = fdc.down_conv_fused(x, k, b)
            ref = fdc.down_conv_plain(x, k, b)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            if not err <= KERNEL_RTOL[dtype_name] * scale:
                fail(f"tp-kernel {dtype_name} x{tuple(x.shape)}->{ol}: max|err| {err} > "
                     f"{KERNEL_RTOL[dtype_name]} x max|y| {scale}")
            x_lib = x.permute(0, 3, 1, 2)
            w_lib = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            ms = cuda_ms(lambda: fdc.down_conv_fused(x, k, b))
            plain_ms = cuda_ms(lambda: fdc.down_conv_plain(x, k, b), reps=5)
            lib_ms = cuda_ms(lambda: torch.relu_(F.conv2d(x_lib, w_lib, b, stride=2,
                                                          padding=1)))
        fdc.down_conv_fused.launches = before  # comparison launches do not count
        h2 = hw // 2
        flops = 2 * TRAIN_BATCH * h2 * h2 * ol * 16 * c
        nbytes = x.element_size() * (x.numel() + k.numel() + b.numel() + y.numel())
        flops_ms, bytes_ms = flops / PEAK_FLOPS[dtype_name] * 1e3, _bytes_ms(nbytes)
        bound = max(flops_ms, bytes_ms)
        plan = fdc.plan(TRAIN_BATCH, hw, hw, c, ol, dtype)
        print(f"[tp-kernel] {dtype_name} x{tuple(x.shape)} -> {ol} (a rank's half of {o}): "
              f"max|err| {err:.3e} (max|y| {scale:.3f}); plan {plan.blocks} blocks (split "
              f"{plan.split}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, cuDNN "
              f"{lib_ms:.4f} ms on the same local shape, bound {bound:.4f} ms "
              f"({'operations' if flops_ms >= bytes_ms else 'bytes'}) = {bound / ms:.1%}")
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                       ("bound_ms", bound)):
            s[key] += v
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s["shapes"] += 1
        del x, k, b, y, ref, x_lib, w_lib
    print(f"[tp-kernel] {dtype_name} batch {TRAIN_BATCH}, {s['shapes']} local shapes: kernel "
          f"{s['ms']:.4f} ms, plain {s['plain_ms']:.4f} ms, cuDNN {s['library_ms']:.4f} ms, "
          f"bound {s['bound_ms']:.4f} ms = {s['bound_ms'] / s['ms']:.1%} of bound, on {card}")
    torch.cuda.empty_cache()
    return s


def phase_tp(fdc, cfg, card):
    """[tp-agree], [tp-gan] and [slice]: one job of 2 ranks (``--dp-worker
    tp``) sharing cuda:0 over gloo (see _tp_worker); the checks and the
    prints. Returns {kernel row name: main-path launches}."""
    (res,) = _dp_jobs([("tp", [{}] * DP_RANKS)])
    r0, r1 = res
    a, b = r0["tp"], r1["tp"]
    b4 = b4_per_call(fdc, cfg, TRAIN_BATCH, TP_RANKS)
    if a["checksum"] != b["checksum"]:
        fail("tp-agree: the ranks' gathered weights differ")
    for k, r in enumerate((a, b)):
        if r["launches"] != {"B2": 0, "B4": b4}:
            fail(f"tp-agree rank {k}: launches {r['launches']}, expected B2 0, B4 {b4} (the "
                 "local gate's down convs of one forward)")
        if r["kernel_bytes"] != r["want_kernel_bytes"]:
            fail(f"tp-agree rank {k}: kernels {r['kernel_bytes']} B a rank, expected "
                 f"{r['want_kernel_bytes']} (half of each split one) of "
                 f"{r['full_kernel_bytes']}")
    ok = a["rel"] <= 1e-5 and a["share"] <= 1e-4
    comm = a["comm"]
    print(f"[tp-agree] mesh_model=2, one injected step at {cfg.size}², batch {TRAIN_BATCH}, fp32 "
          f"kernel path (B4 on the local shapes; B2 off at world size 2): loss "
          f"{a['loss']:.7f} vs one process {r0['ref']['loss']:.7f} (rel {a['rel']:.2e}, bound "
          f"1e-5); updates gathered whole: max|Δ2 − Δ1| {a['max_diff']:.3e}, share beyond "
          f"1e-3·lr {a['share']:.2e} (bound 1e-4); {a['split']} kernels split, "
          f"{a['kernel_bytes'] / 1e6:.1f} MB of kernels a rank of "
          f"{a['full_kernel_bytes'] / 1e6:.1f}; launches a rank {a['launches']} (predicted B4 {b4}); step {a['step_ms']:.2f} ms "
          f"(one process {r0['ref']['step_ms']:.2f} ms); one step's collectives: gathers "
          f"{comm['calls'].get('gather', 0)} x, "
          f"{comm['bytes'].get('gather', 0) / 1e9:.3f} GB sent a rank; input-gradient "
          f"all-reduces {comm['calls'].get('reduce', 0)} x, "
          f"{comm['bytes'].get('reduce', 0) / 1e9:.3f} GB; that step {comm['step_ms']:.2f} ms — "
          f"2 ranks sharing one {card} over gloo, not a multi-card number")
    if not ok:
        fail(f"tp-agree: loss rel {a['rel']}, share {a['share']}")
    ga, gb, gref = r0["gan"], r1["gan"], r0["gan_ref"]
    if ga["metrics"] != gb["metrics"]:
        fail(f"tp-gan: the ranks' metrics differ: {ga['metrics']} vs {gb['metrics']}")
    if ga["launches"] != gref["launches"] or gb["launches"] != gref["launches"]:
        fail(f"tp-gan: launches {ga['launches']} / {gb['launches']}, one process "
             f"{gref['launches']}")
    rel = {k: abs(ga["metrics"][k] - gref["metrics"][k]) / abs(gref["metrics"][k])
           for k in ("g_loss", "d_loss")}
    print(f"[tp-gan] mesh_model=2, one cycle-GAN step at {cfg.size}², batch {TP_GAN_BATCH} a "
          f"class, B3 and B4, R1 (weight 1): metrics equal on both ranks; g_loss "
          f"{ga['metrics']['g_loss']:.7f} vs one process {gref['metrics']['g_loss']:.7f} (rel "
          f"{rel['g_loss']:.2e}), d_loss {ga['metrics']['d_loss']:.7f} vs "
          f"{gref['metrics']['d_loss']:.7f} (rel {rel['d_loss']:.2e}), r1 "
          f"{ga['metrics']['r1']:.6g} vs {gref['metrics']['r1']:.6g}; bound 1e-5 "
          f"([gan-agree]'s); the sgd updates gathered whole against one process: G max "
          f"{ga['g_diff']:.3e}, D max {ga['d_diff']:.3e} of the largest update; launches a rank "
          f"B3/B4 {ga['launches']} (one process {gref['launches']}); the second step "
          f"{ga['step_ms']:.1f} ms (one process {gref['step_ms']:.1f} ms) on {card}")
    if not max(rel.values()) <= 1e-5:
        fail(f"tp-gan: losses {rel} beyond 1e-5 of one process")
    sa, flat = r0["slice"], r0["flat"]
    rel_s = abs(sa["loss"] - flat["loss"]) / abs(flat["loss"])
    print(f"[slice] mesh_slice=2 on 2 ranks (batch over ('slice', 'data')) against flat data "
          f"parallelism, one injected step at {cfg.size}², batch {TRAIN_BATCH}: loss "
          f"{sa['loss']:.7f} vs {flat['loss']:.7f} (rel {rel_s:.2e}, bound 1e-5); updates max "
          f"|Δ| {sa['max_diff']:.3e}, share beyond 1e-3·lr {sa['share']:.2e} (bound 1e-4); "
          f"launches a rank {sa['launches']}")
    if not rel_s <= 1e-5 or not sa["share"] <= 1e-4 or r1["slice"]["checksum"] != sa["checksum"]:
        fail(f"slice: loss rel {rel_s}, share {sa['share']}, or the ranks differ")
    return {"down_conv_k4s2_f32": a["launches"]["B4"] + b["launches"]["B4"]
            + ga["launches"][1] + gb["launches"][1] + sa["launches"]["B4"]
            + r1["slice"]["launches"]["B4"],
            "instance_norm_f32": ga["launches"][0] + gb["launches"][0]}


def phase_tp_train(torch, cli, fdc, fd, trainer, sampler, cfg, tmp, card):
    """[tp-train]: ``cli train --mesh-model 2 --num-processes 2`` from the
    uint8 pool of the PNGs under ``tmp``, 4 steps, a save and one
    log_sample; the checkpoint restored here equals the weights and EMA the
    ranks gathered when they closed (hashes of their bytes); ``cli sample``
    from it in this process. Returns {kernel row name: launches}."""
    from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt_lib

    ckpt = os.path.join(tmp, "ckpt-tp")
    specs = [{"args": _train_cli(cfg, tmp, f"logs-tp-r{k}", "ckpt-tp", "--data-hbm", "288",
                                 "--epochs", "1", "--log-images-every", "1", "--ema-decay",
                                 "0.99", "--mesh-model", str(TP_RANKS))}
             for k in range(DP_RANKS)]
    t0 = time.perf_counter()
    (res,) = _dp_jobs([("cli", specs)])
    secs = time.perf_counter() - t0
    b4 = b4_per_call(fdc, cfg, TRAIN_BATCH, TP_RANKS)
    calls = 1 + cfg.steps + len(sampler.sample_timesteps(cfg.replace(sample_stride=50)))
    want = {"B1": 0, "B1s": CLI_STEPS, "B2": 0, "B3": 0,
            "B4": CLI_STEPS * b4 + calls * b4_per_call(fdc, cfg, TRAIN_BATCH)}
    for k, r in enumerate(res):
        if r["launches"] != want:
            fail(f"tp-train rank {k}: launches {r['launches']}, expected {want}")
    _dp_same(res, "tp-train")
    if res[0]["whole_sha"] != res[1]["whole_sha"]:
        fail("tp-train: the ranks gathered different weights")
    cfg_ck = ckpt_lib.load_config(ckpt)
    state = ckpt_lib.restore(ckpt, trainer.init_state(cfg_ck.replace(mesh_model=1),
                                                      device="cuda"))
    got = _sha([p.detach() for p in state.model.parameters()] + list(state.ema_params))
    if cfg_ck.mesh_model != TP_RANKS or got != res[0]["whole_sha"]:
        fail(f"tp-train: the checkpoint (mesh_model {cfg_ck.mesh_model}) restored in one "
             "process is not the ranks' gathered weights and EMA bit for bit")
    before = fdc.down_conv_fused.launches
    out = os.path.join(tmp, "tp-samples")
    rc = cli.main(["sample", "--device", "cuda", "--checkpoint-dir", ckpt, "--num", "2",
                   "--out", out])
    fdc.down_conv_fused.launches = before
    if rc != 0 or len(glob.glob(os.path.join(out, "*.png"))) != 2:
        fail(f"tp-train: cli sample from the checkpoint returned {rc}")
    loss = _dp_scalars(res[0], "loss")
    print(f"[tp-train] cli train --mesh-model 2, 2 ranks sharing one {card} (gloo), global batch "
          f"{TRAIN_BATCH} on both (data extent 1), {CLI_STEPS} steps from the uint8 pool + one "
          f"log_sample on the EMA gathered whole: launches a rank {res[0]['launches']} (B4 "
          f"{b4} a step on the local shapes, {b4_per_call(fdc, cfg, TRAIN_BATCH)} a sampler "
          f"call on the whole model); epoch loss {loss[0]:.7f} on both ranks; the checkpoint "
          f"restored in one process equals the gathered weights and EMA bit for bit "
          f"(sha256 {got[:12]}); cli sample from it: 2 PNGs; "
          f"{_dp_scalars(res[0], 'images_per_sec')[0]:.3f} img/s, wall {secs:.2f} s")
    del state
    torch.cuda.empty_cache()
    return {"down_conv_k4s2_f32": sum(r["launches"]["B4"] for r in res),
            "diffuse_sharded_f32": sum(r["launches"]["B1s"] for r in res)}


def _sha(tensors):
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def phase_spatial_kernel(torch, fd, cfg, card):
    """B1s on height blocks: the batch of 16 × 256²×3 as the 2 blocks of a
    2-way spatial grid (16 × 128 rows, positions 0, 1) and the 4 of a 2 × 2
    data × spatial grid (8 × 128 rows, positions d·2 + s): each bit for bit
    B1 on its block with the folded seed, within B1's bound of the plain
    version, distinct positions' ε different; one block timed beside its
    byte bound. Returns its summary."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    x = torch.rand((TRAIN_BATCH, cfg.size, cfg.size, 3), generator=gen, device="cuda") * 2 - 1
    t = torch.randint(1, cfg.steps + 1, (TRAIN_BATCH,), generator=gen, device="cuda",
                      dtype=torch.int32)
    seed = torch.randint(0, 2**62, (1,), generator=gen, device="cuda")
    table = fd.scale_table(cfg.steps, cfg.schedule, "cuda")
    counts = fd.diffuse_fused.launches, fd.diffuse_fused_sharded.launches
    h = cfg.size // 2
    grids = {"2-way spatial": [(slice(None), s, s) for s in range(2)],
             "2x2 data x spatial": [(slice(d * 8, d * 8 + 8), s, d * 2 + s)
                                    for d in range(2) for s in range(2)]}
    err, blocks = 0.0, {}
    for name, cells in grids.items():
        eps = []
        for rows, s, pos in cells:
            xb = x[rows, s * h:(s + 1) * h].contiguous().reshape(x[rows].shape[0], -1)
            tb = t[rows].contiguous()
            if not fd.fused_sharded_ok(cfg, tuple(x.shape), {"data": 2, "spatial": 2}
                                       if "data" in name else {"spatial": 2},
                                       ("data", "spatial") if "data" in name
                                       else (None, "spatial")):
                fail(f"spatial-kernel: fused_sharded_ok refuses the {name} grid")
            y = fd.diffuse_fused_sharded(xb, tb, table, seed, pos)
            b1 = fd.diffuse_fused(xb, tb, table, fd.fold_seed(seed, pos))
            ref = fd.diffuse_sharded_plain(xb, tb, table, seed, pos)
            torch.cuda.synchronize()
            if not torch.equal(y, b1):
                fail(f"spatial-kernel: {name} position {pos} differs from B1 with the folded "
                     "seed")
            err = max(err, (y - ref).abs().max().item())
            noise = torch.tensor([[0.0, 1.0]], device="cuda")
            eps.append(fd.diffuse_fused_sharded(torch.zeros_like(xb), torch.zeros_like(tb),
                                                noise, seed, pos))
            blocks[name] = (xb, tb, pos)
        same = max((a == b).double().mean().item() for i, a in enumerate(eps)
                   for b in eps[:i])
        if same > 1e-3:
            fail(f"spatial-kernel: two positions of the {name} grid drew the same ε in "
                 f"{same:.2%} of the elements")
    if not err <= DIFFUSE_ATOL:
        fail(f"spatial-kernel: B1s vs plain max|err| {err} > {DIFFUSE_ATOL}")
    out = {}
    for name, (xb, tb, pos) in blocks.items():
        call = lambda: fd.diffuse_fused_sharded(xb, tb, table, seed, pos)  # noqa: E731
        ms = cuda_ms(call, reps=50)
        nbytes = 8 * xb.numel() + 4 * tb.numel() + 4 * table.numel()
        cold_ms, cold_lo, cold_hi = cold_device_ms(
            lambda i: (torch.rand_like(xb),),
            lambda xi: fd.diffuse_fused_sharded(xi, tb, table, seed, pos), "diffuse")
        elems = xb.numel()
        bytes_ms = _bytes_ms(nbytes)
        if not cold_ms >= bytes_ms:
            fail(f"spatial-kernel: B1s's cold device time {cold_ms} ms on the {name} grid is "
                 f"below its byte bound {bytes_ms} ms: the reading is impossible, not fast")
        ops = DIFFUSE_INT_PER_ELEMENT * elems, DIFFUSE_FLOAT_PER_ELEMENT * elems
        ops_ms = max(ops[0] / INT32_RATE, (ops[0] + ops[1]) / DISPATCH_RATE) * 1e3
        plain_ms = cuda_ms(lambda: fd.diffuse_sharded_plain(xb, tb, table, seed, pos), reps=10)
        out[name] = dict(ms=ms, cold_ms=cold_ms, bound_ms=max(bytes_ms, ops_ms),
                         plain_ms=plain_ms, shape=tuple(xb.shape))
        print(f"[spatial-kernel] B1s on a block of the {name} grid, {tuple(xb.shape)} "
              f"(position {pos}): kernel {ms:.4f} ms back to back (plain {plain_ms:.4f} ms), "
              f"device {cold_ms:.4f} ms "
              f"L2 cold (median of 24 launches over rotating inputs, {cold_lo:.4f}–"
              f"{cold_hi:.4f}); bound {max(bytes_ms, ops_ms):.4f} ms "
              f"({'operations' if ops_ms >= bytes_ms else 'bytes'}: "
              f"{nbytes / 1e6:.2f} MB) on {card}")
    fd.diffuse_fused.launches, fd.diffuse_fused_sharded.launches = counts
    print(f"[spatial-kernel] both grids: every block bit for bit B1 with the folded seed; "
          f"max|err| vs plain {err:.3e} (bound {DIFFUSE_ATOL}); distinct positions' ε differ; "
          "these launches are comparisons (the main path's are [spatial-agree]'s)")
    del x
    return out


SPATIAL_SHARDS = 2  # [spatial-*]: the height shards of the spatial jobs


def spatial_norm_shapes(cfg, shards=SPATIAL_SHARDS, batch=TRAIN_BATCH):
    """The (B, h, W, C) block a rank holds at every norm layer of ``cfg``'s
    denoiser under ``g_norm`` on ``shards`` height shards: each octave's
    down conv output, then its up conv output (models/unet.py)."""
    out = []
    for i in range(cfg.octaves):
        d, u = cfg.size >> (i + 1), cfg.size >> i
        out += [(batch, d // shards, d, cfg.octave_filters(i)),
                (batch, u // shards, u, cfg.octave_up_filters(i))]
    return out


def device_ops(run):
    """The names of the device operations (kernels, copies, fills) that
    ``run()`` puts on the card, from one torch.profiler session."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):  # a session that saw nothing dropped its device events
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            return names
    return names


def spatial_norm_layer_ops(torch, norm, x, other, g, b, count=False):
    """One norm layer's forward over height blocks as the main path runs it
    (``instance_norm_blocks`` on a rank of a 2-rank axis), with the other
    rank's triples copied into the buffer in place of the gather; beside
    it the first design's sequence rebuilt from its pieces (the stats
    launch, the gathered list's stack, ``merge_block_stats``, the stack of
    (mean, r), an apply launch). Returns (device ops of the layer and of
    the first design's sequence under torch.profiler, each None unless
    ``count``: the profiler drops device events after many sessions in one
    process, so the script counts them in a fresh one, ``--norm-ops``; B3
    launches of the layer; the layer's and the sequence's ms back to back,
    host included)."""
    from gan_class_transfer2_tpu_torch.parallel import multihost

    theirs = norm.block_stats(other)
    bsz = x.shape[0]
    saved = norm._gather_into
    norm._gather_into = lambda parts, mine, group=None: parts[bsz:].copy_(theirs)
    try:
        def layer():
            return norm.instance_norm_blocks(x, g, b, multihost.Axis(None, 2, 0))

        before = norm.block_launches()
        layer()
        launches = norm.block_launches() - before
        ops = device_ops(layer) if count else None
        layer_ms = cuda_ms(layer)
    finally:
        norm._gather_into = saved

    one = theirs[None].contiguous()  # the stand-in apply launch's input, made beforehand

    def first_design():
        parts = torch.stack([norm.block_stats(x), theirs])
        mean, rstd = norm.merge_block_stats(parts)
        torch.stack([mean, rstd], -1).contiguous()
        norm.block_merge_apply(x, one, g, b)

    first = device_ops(first_design) if count else None
    return ops, first, launches, layer_ms, cuda_ms(first_design)


def _norm_layer_inputs(torch, shape, dtype, gen):
    """One norm layer's inputs at a rank's block ``shape`` of 2 height
    shards: the image whose top half the rank holds, its two halves, γ, β."""
    c = shape[-1]
    whole = (torch.randn((shape[0], 2 * shape[1], *shape[2:]), generator=gen, device="cuda")
             * 3 + 2).to(dtype)
    x, other = (blk.contiguous() for blk in whole.chunk(2, 1))
    g = 1 + 0.2 * torch.randn((c,), generator=gen, device="cuda")
    b = 0.2 * torch.randn((c,), generator=gen, device="cuda")
    return whole, x, other, g, b


def norm_ops_worker():
    """``python3 chip_smoke.py --norm-ops``: one norm layer's forward over
    height blocks at the default model's first norm block, float32 and
    bfloat16, its device operations and the first design's counted under
    torch.profiler in a fresh process; one NORMOPS JSON line."""
    import torch

    from gan_class_transfer2_tpu_torch.config import Config
    from gan_class_transfer2_tpu_torch.ops import norm

    gen = torch.Generator(device="cuda").manual_seed(17)
    shape = spatial_norm_shapes(Config().validate())[0]
    out = {}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        _, x, other, g, b = _norm_layer_inputs(torch, shape, dtype, gen)
        ops, first, launches, _, _ = spatial_norm_layer_ops(torch, norm, x, other, g, b,
                                                            count=True)
        out[name] = {"ops": ops, "first": first, "launches": launches}
    print("NORMOPS " + json.dumps(out), flush=True)
    return 0


def phase_spatial_norm(torch, norm, cfg, card):
    """B3 over height blocks at every norm layer's block of the default
    model on 2 height shards at batch 16, float32 and bfloat16: the block's
    triples (stats launch) against the plain version's, the merge-and-apply
    launch from the two blocks' triples against the plain merge and apply
    and against B3's plain version on the whole image; the pair timed on
    the device and back to back beside its byte bound (x read twice, y
    written once), the stats launch alone beside ``torch.var_mean`` (float32:
    the statistics' one library call); one layer's forward's device
    operations under torch.profiler and its ms back to back beside the first
    design's sequence. Returns the float32 row without
    launches: times and bound summed over one forward's norm layers of a
    rank."""
    done = subprocess.run([sys.executable, os.path.abspath(__file__), "--norm-ops"], cwd=HERE,
                          capture_output=True, text=True, timeout=300)
    line = next((ln for ln in done.stdout.splitlines() if ln.startswith("NORMOPS ")), None)
    if done.returncode != 0 or line is None:
        fail(f"spatial-kernel: --norm-ops exited {done.returncode}:\n"
             f"{(done.stdout + done.stderr)[-3000:]}")
    layer_ops = json.loads(line[len("NORMOPS "):])
    gen = torch.Generator(device="cuda").manual_seed(17)
    rows = {}
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        s = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, device_ms=0.0, stats_ms=0.0,
                 var_mean_ms=0.0, layer_ms=0.0, first_ms=0.0, err=0.0, worst=0.0)
        counted = layer_ops[dtype_name]
        ops, first = counted["ops"], counted["first"]
        if counted["launches"] != 2 or not 2 <= len(ops) <= 3:
            fail(f"spatial-kernel: one norm layer's forward launched {counted['launches']} B3 "
                 f"kernels and {len(ops)} device operations {ops} (expected 2, and 2 or 3: "
                 "the stats, the gather's stand-in copy, the merge-and-apply)")
        print(f"[spatial-kernel] B3 over height blocks {dtype_name}: one norm layer's forward "
              f"as the main path runs it, a 2-rank axis with the gather a copy (a fresh "
              f"process, torch.profiler): {len(ops)} device operations ({counted['launches']} "
              f"B3 launches + the copy); the first design's sequence rebuilt from its pieces: "
              f"{len(first)} device operations ({', '.join(n[:24] for n in first)})")
        for shape in spatial_norm_shapes(cfg):
            c = shape[-1]
            whole, x, other, g, b = _norm_layer_inputs(torch, shape, dtype, gen)
            before = norm.block_stats.launches, norm.block_merge_apply.launches
            part = norm.block_stats(x)
            want = norm.block_stats_plain(x)
            # the triples: counts exact, means and M2 within 1e-5 of their largest
            m2_err = ((part[..., 2] - want[..., 2]).abs().max() / want[..., 2].abs().max()).item()
            mean_err = ((part[..., 1] - want[..., 1]).abs().max()
                        / want[..., 1].abs().max()).item()
            if not (m2_err <= 1e-5 and mean_err <= 1e-5
                    and torch.equal(part[..., 0], want[..., 0])):
                fail(f"spatial-kernel: B3 block stats {dtype_name} x{shape}: mean error "
                     f"{mean_err}, M2 error {m2_err} of the largest")
            parts = torch.stack([part, norm.block_stats(other)])
            y, mean, rstd = norm.block_merge_apply(x, parts, g, b)
            m_ref, r_ref = norm.merge_block_stats(parts)
            ref = norm.block_apply_plain(x, m_ref, r_ref, g, b)
            full = norm.instance_norm_plain(whole, g, b)[:, :shape[1]]
            torch.cuda.synchronize()
            scale = ref.float().abs().max().item()
            err = (y.float() - ref.float()).abs().max().item()
            err_whole = (y.float() - full.float()).abs().max().item()
            r_err = ((rstd - r_ref).abs() / r_ref).max().item()
            if not err <= IN_RTOL[dtype_name] * scale or not (
                    err_whole <= IN_RTOL[dtype_name] * scale):
                fail(f"spatial-kernel: B3 over height blocks {dtype_name} x{shape}: max|err| "
                     f"{err} against the plain version, {err_whole} against B3's plain "
                     f"version on the whole image, > {IN_RTOL[dtype_name]} x max|y| {scale}")
            if not torch.equal(mean, m_ref) or not r_err <= 2.4e-7:
                fail(f"spatial-kernel: B3 over height blocks {dtype_name} x{shape}: the merged "
                     f"mean differs from merge_block_stats's, or r by {r_err} relative (2 ulp)")
            ms = cuda_ms(lambda: norm.block_stats(x)) + cuda_ms(
                lambda: norm.block_merge_apply(x, parts, g, b))
            dev_ms = queued_ms(lambda: (norm.block_stats(x),
                                        norm.block_merge_apply(x, parts, g, b)))
            stats_ms = queued_ms(lambda: norm.block_stats(x))
            plain_ms = cuda_ms(lambda: norm.block_stats_plain(x)) + cuda_ms(
                lambda: norm.block_merge_apply_plain(x, parts, g, b))
            var_mean = ""
            if dtype == torch.float32:
                vm_ms = queued_ms(lambda: torch.var_mean(x, dim=(1, 2), correction=0))
                s["var_mean_ms"] += vm_ms
                var_mean = f", torch.var_mean {vm_ms:.4f} ms"
            _, _, launches, layer_ms, first_ms = spatial_norm_layer_ops(torch, norm, x, other,
                                                                        g, b)
            if launches != 2:
                fail(f"spatial-kernel: a norm layer's forward at x{shape} launched {launches} "
                     "B3 kernels (expected 2)")
            s["layer_ms"] += layer_ms
            s["first_ms"] += first_ms
            norm.block_stats.launches, norm.block_merge_apply.launches = before
            nbytes = 3 * x.numel() * x.element_size() + 4 * 4 * shape[0] * c + 2 * 4 * c
            bound = _bytes_ms(nbytes)
            stats_bound = _bytes_ms(x.numel() * x.element_size() + 12 * shape[0] * c)
            print(f"[spatial-kernel] B3 over height blocks {dtype_name}, a block "
                  f"{tuple(x.shape)} of 2, plan {tuple(norm.block_plan(*shape, dtype))}: stats "
                  f"+ merge-and-apply max|err| {err:.3e} (vs the whole image {err_whole:.3e}, "
                  f"max|y| {scale:.3f}, bound {IN_RTOL[dtype_name]} x); triples: mean "
                  f"{mean_err:.2e}, M2 {m2_err:.2e} of the largest; r {r_err:.1e} relative; "
                  f"device {dev_ms:.4f} ms (behind a queued wait), back to back {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms; bound {bound:.4f} ms (bytes, {nbytes / 1e6:.2f} MB) "
                  f"= {bound / dev_ms:.1%} of the device time; the stats launch alone "
                  f"{stats_ms:.4f} ms (bound {stats_bound:.4f}){var_mean}; on {card}")
            for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound),
                         ("device_ms", dev_ms), ("stats_ms", stats_ms)):
                s[k] += v
            s["err"] = max(s["err"], err, err_whole)
            s["worst"] = max(s["worst"], err / scale, err_whole / scale)
            del whole, x, other, y, ref, full
        print(f"[spatial-kernel] B3 over height blocks {dtype_name}: one forward's "
              f"{len(spatial_norm_shapes(cfg))} norm layers a rank (2 launches each): device "
              f"{s['device_ms']:.4f} ms = {s['bound_ms'] / s['device_ms']:.1%} of the bound, "
              f"back to back {s['ms']:.4f} ms, plain {s['plain_ms']:.4f} ms, bound "
              f"{s['bound_ms']:.4f} ms (bytes); the stats launches alone {s['stats_ms']:.4f} ms"
              + (f", torch.var_mean {s['var_mean_ms']:.4f} ms" if s["var_mean_ms"] else "")
              + f"; a layer's forward with the gather's stand-in, host included, summed "
              f"{s['layer_ms']:.4f} ms against the first design's sequence {s['first_ms']:.4f} "
              f"ms; worst error {s['worst']:.2e} of max|y| (bound {IN_RTOL[dtype_name]}); these "
              f"launches are comparisons (the main path's are [spatial-agree]'s)")
        rows[dtype_name] = {
            "name": f"instance_norm_blocks_{'f32' if dtype_name == 'float32' else 'bf16'}",
            "route": "cuda", "source": "gan_class_transfer2_tpu_torch/csrc/instance_norm.cu",
            "replaces": "gan_class_transfer2_tpu/ops/norm.py:48", "launches": 0,
            "max_abs_err": s["err"], "ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"], "bound_by": "bytes", "library_ms": None}
        torch.cuda.empty_cache()
    return rows["float32"]


def phase_spatial_agree(card):
    """[spatial-agree]: one job of 2 ranks (``--dp-worker spatial``) as 2
    height shards of cuda:0 (see _spatial_worker). Returns {kernel row
    name: main-path launches}."""
    (res,) = _dp_jobs([("spatial", [{}] * DP_RANKS)])
    r0, r1 = res
    fw = r0["forward"]
    print(f"[spatial-agree] make_spatial_unet_apply on 2 height shards of {r0['size'] // 2} rows "
          f"at {r0['size']}², batch 4: max|err| {fw['err']:.3e} of max|y| {fw['scale']:.3f} "
          f"against unet_apply on the card (bound 1e-4 of the scale)")
    if not fw["err"] <= 1e-4 * fw["scale"]:
        fail(f"spatial-agree: the sharded forward differs by {fw['err']}")
    for name in ("spatial", "dp_spatial"):
        a = r0[name]
        if a["checksum"] != r1[name]["checksum"]:
            fail(f"spatial-agree {name}: the ranks' weights differ")
        halo = a["comm"]
        print(f"[spatial-agree] {name}: one injected step at {r0['size']}², batch "
              f"{TRAIN_BATCH}, 2 height shards: loss {a['loss']:.7f} vs one process "
              f"{r0['ref']['loss']:.7f} (rel {a['rel']:.2e}, bound 1e-5); updates max|Δ2 − Δ1| "
              f"{a['max_diff']:.3e}, share beyond 1e-3·lr {a['share']:.2e} (bound 1e-4); step "
              f"{a['step_ms']:.2f} ms (one process {r0['ref']['step_ms']:.2f} ms); one step's "
              f"halos {halo['calls'].get('halo', 0)} x, "
              f"{halo['bytes'].get('halo', 0) / 1e6:.2f} MB sent a rank; gradient all-reduces "
              f"{halo['calls'].get('grad', 0)} x — 2 ranks sharing one {card}")
        if not a["rel"] <= 1e-5 or not a["share"] <= 1e-4:
            fail(f"spatial-agree {name}: loss rel {a['rel']}, share {a['share']}")
    norm_layers = 2 * r0["octaves"]  # a down and an up norm an octave
    blocks = 0
    for name, over in SPATIAL_CASES:
        a, b = r0["options"][name], r1["options"][name]
        forward = 2 * norm_layers if "g_norm=instance" in name else 0
        want = {"B3 blocks": forward, "B3": 0, "B1/B1s": 0}
        recompute = a["launches"]["B3 blocks"] - forward
        if over.get("remat") and forward:  # and its recompute's, as counted: the ranks agree
            if recompute <= 0:
                fail(f"spatial-agree {name}: B3-block launches {a['launches']}: no recompute")
            want["B3 blocks"] = forward + recompute
        if a["checksum"] != b["checksum"]:
            fail(f"spatial-agree {name}: the ranks' weights differ")
        if a["launches"] != want or b["launches"] != want:
            fail(f"spatial-agree {name}: launches {a['launches']} / {b['launches']} (expected "
                 f"{want} a rank: 2 a norm layer and forward)")
        if name == "dynamic loss scale" and a.get("scale") != [2.0**15, 1]:
            fail(f"spatial-agree {name}: the scale state {a.get('scale')} after a finite step")
        print(f"[spatial-agree] {name}: one injected step at {r0['size']}², batch "
              f"{TRAIN_BATCH}, 2 height shards: loss {a['loss']:.7f} vs one process "
              f"{a['ref_loss']:.7f} (rel {a['rel']:.2e}, bound 1e-5); updates max|Δ2 − Δ1| "
              f"{a['max_diff']:.3e}, share beyond 1e-3·lr {a['share']:.2e} (bound 1e-4); "
              f"launches a rank {a['launches']}" + (f"; scale state {a['scale']}"
                                                   if "scale" in a else ""))
        if not a["rel"] <= 1e-5 or not a["share"] <= 1e-4:
            fail(f"spatial-agree {name}: loss rel {a['rel']}, share {a['share']}")
        if over.get("remat"):
            halos = [a["comm"].get("halo", 0), b["comm"].get("halo", 0)]
            without = [a["halos_without"], b["halos_without"]]
            if halos[0] != halos[1] or without[0] != without[1] or not halos[0] > without[0]:
                fail(f"spatial-agree {name}: halos {halos} against {without} without remat")
            print(f"[spatial-agree] {name}: halo exchanges a step {halos[0]} on both ranks "
                  f"against {without[0]} without remat; B3 over height blocks "
                  f"{a['launches']['B3 blocks']} = the forward's {forward} + the recompute's "
                  f"{recompute}; the step's peak memory above what was resident before it, "
                  f"rank 0 / rank 1: {a['peak_mb']:.1f} / {b['peak_mb']:.1f} MiB with remat, "
                  f"{a['peak_mb_without']:.1f} / {b['peak_mb_without']:.1f} MiB without ({card})")
        blocks += a["launches"]["B3 blocks"] + b["launches"]["B3 blocks"]
    f0, f1 = r0["fused"], r1["fused"]
    want = {"B1": 0, "B1s": 2}
    if f0["launches"] != want or f1["launches"] != want or f0["losses"] != f1["losses"]:
        fail(f"spatial-agree fused: launches {f0['launches']} / {f1['launches']} (expected "
             f"{want}), losses {f0['losses']} / {f1['losses']}")
    print(f"[spatial-agree] 2 generator-driven steps on the fused path (B1s on each rank's "
          f"(8, 128, 256, 3) block at its spatial index): launches a rank {f0['launches']}, "
          f"losses {f0['losses']} on both ranks")
    return {"diffuse_sharded_f32": f0["launches"]["B1s"] + f1["launches"]["B1s"],
            "instance_norm_blocks_f32": blocks}


PP_CASES = ((2, 2, 1), (3, 4, 1), (2, 2, 2))  # [pp-agree]: stages, microbatches, mesh_data


def _pp_counts(fdc, adam_kernel, pipeline, cfg, tr):
    """The pipeline step's exact launches (B1, B4, B2): one B1 for the
    whole batch's draws; B4 in every octave's descent twice a microbatch
    replica (the no-grad forward and the stage's recompute); one B2 call a
    stage over its leaves."""
    from gan_class_transfer2_tpu_torch.models import unet

    rows = TRAIN_BATCH // (tr.n_micro * tr.dp)
    b4 = 2 * tr.n_micro * tr.dp * b4_per_call(fdc, cfg, rows)
    index = pipeline.stage_indices(unet.Denoiser(cfg), tr.plan)
    b2 = sum(adam_kernel.launches_per_step(len(ix)) for ix in index)
    return 1, b4, b2 if adam_kernel.fused_adam_ok(cfg) else 0


def _bounded(fn, seconds, what):
    """``fn()`` in a thread of its own, waited for at most ``seconds``: a
    call that never returns (a deadlock) ends this script by name."""
    import threading

    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001 — raised below
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        print(f"chip_smoke: FAIL: {what}: no return in {seconds} s (a deadlock?)",
              file=sys.stderr, flush=True)
        os._exit(1)  # the stuck thread would hold the interpreter's exit
    if "err" in box:
        raise box["err"]
    return box["out"]


def phase_pp_agree(torch, fdc, fd, adam_kernel, trainer, cfg, card):
    """Pipeline parallelism (parallel/pipeline.py) at the default width,
    batch 16, float32, every stage on cuda:0, through the kernels (B1 in
    the prep, B4 in every descent and its recompute, B2 a stage): stages 2
    with microbatches 2, stages 3 with 4, and 2 stages x 2 in-process
    replicas (PP x DP on cuda:0), each one step from the same weights and
    generator state as the one-process step: the loss within 1e-5 relative,
    the updates beyond 1e-3·lr on at most 1e-4 of the elements
    ([train-agree]'s bounds; constant lr 1e-3); exact launches; the step
    timed beside the one-process step in the same run; 2 stages x 2
    microbatches x 2 replicas under batch norm, SGD with momentum, the
    replicas in threads that sum each norm's statistics (taking turns on
    the host), against the pipeline without
    replicas (each microbatch's statistics whole) at the same bounds, its
    wait bounded; one bfloat16 pipeline step with a finite loss. Returns
    the pipeline steps' launches by kernel name."""
    from gan_class_transfer2_tpu_torch.parallel import pipeline

    lr = 1e-3
    base = cfg.replace(batch_size=TRAIN_BATCH, optimizer="adam_fused",
                       fused_diffusion=True, lr_schedule="constant", learning_rate=lr).validate()
    x = torch.from_numpy(np.random.default_rng(11).uniform(
        -1, 1, (TRAIN_BATCH, cfg.size, cfg.size, 3)).astype(np.float32)).cuda()
    counters = (fd.diffuse_fused, fdc.down_conv_fused, adam_kernel.adam_fused)
    total = {"diffuse_f32": 0, "down_conv_k4s2_f32": 0, "adam_f32m": 0}

    def one_step(step, state, seed):
        saved = [c.launches for c in counters]
        state, loss = step(state, x, torch.Generator(device="cuda").manual_seed(seed))
        torch.cuda.synchronize()
        got = tuple(c.launches - n for c, n in zip(counters, saved))
        return state, float(loss), got

    def step_ms(step, state, reps=3):
        gen = torch.Generator(device="cuda").manual_seed(1)
        state, _ = step(state, x, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            state, loss = step(state, x, gen)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    t_phase = time.perf_counter()
    state = trainer.init_state(base, device="cuda")
    p0 = [p.detach().clone() for p in state.model.parameters()]
    state, ref_loss, ref_launches = one_step(trainer.make_train_step(base), state, 5)
    ref_delta = [p.detach() - q for p, q in zip(state.model.parameters(), p0)]
    one_ms = step_ms(trainer.make_train_step(base), state)
    del state
    print(f"[pp-agree] one process, {cfg.size}², batch {TRAIN_BATCH}, fp32 kernel path: loss "
          f"{ref_loss:.7f}, launches B1/B4/B2 {ref_launches}, step {one_ms:.2f} ms")
    turns_ms = {}
    for stages, micro, dp in PP_CASES:
        c = base.replace(pipeline_stages=stages, pipeline_microbatches=micro, mesh_data=dp)
        tr = pipeline.PipelineTrainer(c, devices=["cuda:0"])
        st = tr.init_state()
        st, loss, got = one_step(tr.step, st, 5)
        want = _pp_counts(fdc, adam_kernel, pipeline, c, tr)
        for name, n in zip(("diffuse_f32", "down_conv_k4s2_f32", "adam_f32m"), got):
            total[name] += n
        delta = [p.detach() - q for p, q in zip(st.model.parameters(), p0)]
        rel = abs(loss - ref_loss) / abs(ref_loss)
        diff = torch.cat([(a - b).abs().flatten() for a, b in zip(delta, ref_delta)])
        share = (diff > 1e-3 * lr).double().mean().item()
        ms = step_ms(tr.step, st)
        name = f"stages {stages} x microbatches {micro}" + (f" x {dp} replicas" if dp > 1 else "")
        if dp > 1:
            turns_ms[dp] = ms
        print(f"[pp-agree] {name} (plan {tr.plan}, all on cuda:0): loss {loss:.7f} (rel "
              f"{rel:.2e}, bound 1e-5); updates: max|Δpp − Δ1| {diff.max().item():.3e}, share "
              f"beyond 1e-3·lr {share:.2e} (bound 1e-4); launches B1/B4/B2 {got} (expected "
              f"{want}); step {ms:.2f} ms against the one process's {one_ms:.2f} ms in "
              f"this run ({card})")
        if got != want:
            fail(f"pp-agree {name}: launches B1/B4/B2 {got}, expected {want}")
        if not rel <= 1e-5 or not share <= 1e-4:
            fail(f"pp-agree {name}: loss rel {rel}, share {share}")
        del st, tr
    # batch norm: the 2 replicas of a stage a thread each, taking turns on
    # the host and summing each norm's statistics; the reference is the pipeline without
    # replicas, whose stages take each microbatch's statistics whole
    c = base.replace(pipeline_stages=2, pipeline_microbatches=2, mesh_data=2, g_norm="batch",
                     optimizer="momentum")
    name = "batch norm, stages 2 x microbatches 2 x 2 replicas"
    ref_tr = pipeline.PipelineTrainer(c.replace(mesh_data=1), devices=["cuda:0"])
    pb = [p.detach().clone() for p in ref_tr.init_state().model.parameters()]
    st, b_ref, _ = one_step(ref_tr.step, ref_tr.init_state(), 5)
    b_delta = [p.detach() - q for p, q in zip(st.model.parameters(), pb)]
    ref_ms = step_ms(ref_tr.step, st, reps=6)
    del st, ref_tr
    tr = pipeline.PipelineTrainer(c, devices=["cuda:0"])
    st = tr.init_state()
    st, loss, got = _bounded(lambda: one_step(tr.step, st, 5), 300, f"pp-agree {name}")
    want = _pp_counts(fdc, adam_kernel, pipeline, c, tr)
    for key, n in zip(("diffuse_f32", "down_conv_k4s2_f32", "adam_f32m"), got):
        total[key] += n
    delta = [p.detach() - q for p, q in zip(st.model.parameters(), pb)]
    rel = abs(loss - b_ref) / abs(b_ref)
    diff = torch.cat([(a - b).abs().flatten() for a, b in zip(delta, b_delta)])
    share = (diff > 1e-3 * lr).double().mean().item()
    counts = dict(tr.counts)
    ms = _bounded(lambda: step_ms(tr.step, st, reps=6), 300, f"pp-agree {name}, timed")
    print(f"[pp-agree] {name} (threads on cuda:0): loss {loss:.7f} against the pipeline "
          f"without replicas {b_ref:.7f} (rel {rel:.2e}, bound 1e-5); updates: max|Δ − Δref| "
          f"{diff.max().item():.3e}, share beyond 1e-3·lr {share:.2e} (bound 1e-4); launches "
          f"B1/B4/B2 {got} (expected {want}); rows a replica {counts['rows']}, statistics sums "
          f"{counts['sums']}, autograd.grad calls {counts['grads']}; step {ms:.2f} ms against "
          f"{ref_ms:.2f} ms without replicas and {turns_ms[2]:.2f} ms for the 2 x 2 x 2 step "
          f"without batch norm, its replicas in turn ({card})")
    if got != want:
        fail(f"pp-agree {name}: launches B1/B4/B2 {got}, expected {want}")
    if not rel <= 1e-5 or not share <= 1e-4 or not counts["sums"]:
        fail(f"pp-agree {name}: loss rel {rel}, share {share}, counts {counts}")
    del st, tr
    c = base.replace(pipeline_stages=2, pipeline_microbatches=2, compute_dtype="bfloat16")
    tr = pipeline.PipelineTrainer(c, devices=["cuda:0"])
    st, loss, got = one_step(tr.step, tr.init_state(), 5)
    ms = step_ms(tr.step, st)
    print(f"[pp-agree] bfloat16, stages 2 x microbatches 2: loss {loss:.7f}, launches B1/B4 "
          f"(bf16)/B2 {got}, step {ms:.2f} ms")
    if not np.isfinite(loss):
        fail(f"pp-agree bfloat16: loss {loss}")
    print(f"[pp-agree] the phase took {time.perf_counter() - t_phase:.2f} s")
    return total


def phase_pp_train(torch, cli, fdc, fd, adam_kernel, sampler, cfg, tmp, card):
    """[pp-train]: ``cli train --pipeline-stages 2 --pipeline-microbatches
    2`` (every stage on cuda:0) from the uint8 pool of the PNGs under
    ``tmp``, CLI_STEPS steps with an EMA, a save and one log_sample (on the
    EMA gathered to stage 0's device): exact B1/B2/B4 launches, a finite
    loss, the checkpoint; then ``cli sample`` restores it in one process.
    Returns {kernel row name: launches}."""
    from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt_lib

    ckpt = os.path.join(tmp, "ckpt-pp")
    args = _train_cli(cfg, tmp, "logs-pp", "ckpt-pp", "--data-hbm", "288", "--epochs", "1",
                      "--log-images-every", "1", "--ema-decay", "0.99", "--pipeline-stages", "2",
                      "--pipeline-microbatches", "2")
    got, secs = _run_cli(cli, (fd.diffuse_fused, adam_kernel.adam_fused, fdc.down_conv_fused),
                         args)
    b4 = b4_per_call(fdc, cfg, TRAIN_BATCH)
    calls = 1 + cfg.steps + len(sampler.sample_timesteps(cfg.replace(sample_stride=50)))
    want = (CLI_STEPS, 2 * CLI_STEPS, CLI_STEPS * 2 * 2 * b4 + calls * b4)
    if got != want:
        fail(f"pp-train: launches B1/B2/B4 {got}, expected {want} ({CLI_STEPS} steps of 2 "
             f"stages x 2 microbatches, {calls} denoiser calls in one log_sample)")
    ev = _events(os.path.join(tmp, "logs-pp"))
    loss = ev["loss"][0][1]
    if not np.isfinite(loss) or ckpt_lib.all_steps(ckpt) != [CLI_STEPS]:
        fail(f"pp-train: loss {loss}, checkpoints {ckpt_lib.all_steps(ckpt)}")
    out = os.path.join(tmp, "pp-samples")
    before = fdc.down_conv_fused.launches
    rc = cli.main(["sample", "--device", "cuda", "--checkpoint-dir", ckpt, "--num", "2",
                   "--out", out])
    fdc.down_conv_fused.launches = before
    if rc != 0 or len(glob.glob(os.path.join(out, "*.png"))) != 2:
        fail(f"pp-train: cli sample from the pipeline's checkpoint returned {rc}")
    print(f"[pp-train] cli train --pipeline-stages 2 --pipeline-microbatches 2 on one {card} "
          f"(both stages on cuda:0), batch {TRAIN_BATCH}, {CLI_STEPS} steps from the uint8 pool + "
          f"one log_sample on the EMA + a save: launches B1/B2/B4 {got} (B4 {2 * 2 * b4} a step: "
          f"the forward and the recompute of 2 microbatches); epoch loss {loss:.7f}, "
          f"{ev['images_per_sec'][0][1]:.3f} img/s; checkpoint step {CLI_STEPS} restored by a "
          f"one-process cli sample (2 PNGs); wall {secs:.2f} s")
    torch.cuda.empty_cache()
    return {"diffuse_f32": got[0], "adam_f32m": got[1], "down_conv_k4s2_f32": got[2]}


PLAN_HELD_OUT = (256, 20)  # [plan]: not a point of the planner's grid, not a multiple of 8


def phase_plan(torch, cli, cfg, card):
    """[plan]: ``cli plan --json`` for 1 and 4 cards, diffusion and gan, at
    batch 16: the keys, a chosen strategy on one card with a prediction;
    then the planner's float32 img/s at PLAN_HELD_OUT against ``cli
    bench`` there in this run: within 25%."""
    import contextlib
    import io

    from gan_class_transfer2_tpu_torch.parallel import planner

    for chips in (1, 4):
        for model in ("diffusion", "gan"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["plan", "--json", "--chips", str(chips), "--model", model,
                               "--batch-size", str(TRAIN_BATCH)])
            res = json.loads(buf.getvalue())
            if rc != 0 or res["chosen"] is None or res["hbm_gb"] != 80.0:
                fail(f"plan {model} on {chips}: rc {rc}, chosen {res.get('chosen')}")
            best = res["candidates"][0]
            print(f"[plan] {model}, {chips} card(s), batch {TRAIN_BATCH}, fp32: chosen "
                  f"{res['chosen']} ({res['cli_flags']}), {best['total_gb']} GB a card, "
                  f"pred {best['pred_img_s']} img/s; {len(res['candidates'])} candidates")
            if chips == 1 and best["pred_img_s"] is None:
                fail(f"plan {model} on one card: no prediction")
    size, batch = PLAN_HELD_OUT
    c = cfg.replace(size=size, batch_size=batch).validate()
    pred = planner.predict_ips_per_chip(c, batch)
    bench = _cli_json(cli, ["bench", "--device", "cuda", *_width(c), *KERNEL_PATH,
                            "--compute-dtype", "float32", "--batch-size", str(batch),
                            "--bench-steps", str(BENCH_STEPS)])[-1]
    got = bench["images_per_sec"]
    err = pred / got - 1
    print(f"[plan] held out {size}² batch {batch} fp32 (no grid point): the planner predicts "
          f"{pred:.3f} img/s, cli bench measured {got:.3f} img/s in this run ({err:+.2%}, bound "
          f"25%) on {card}")
    if abs(err) > 0.25:
        fail(f"plan: the prediction at {PLAN_HELD_OUT} is off by {err:.1%}")


def _tp_worker(torch, rank, port):
    """One rank of [tp-agree], [tp-gan] and [slice] (see phase_tp)."""
    from gan_class_transfer2_tpu_torch.config import Config
    from gan_class_transfer2_tpu_torch.models import api
    from gan_class_transfer2_tpu_torch.ops import adam_kernel
    from gan_class_transfer2_tpu_torch.ops import fused_down_conv as fdc
    from gan_class_transfer2_tpu_torch.ops import norm
    from gan_class_transfer2_tpu_torch.parallel import mesh as mesh_lib
    from gan_class_transfer2_tpu_torch.parallel import multihost
    from gan_class_transfer2_tpu_torch.train import gan, trainer

    dev = "cuda"
    torch.backends.cudnn.allow_tf32 = False
    multihost.initialize(f"127.0.0.1:{port}", DP_RANKS, rank, device=dev)
    mesh = mesh_lib.make_mesh(device=dev, model=TP_RANKS)
    lr = 1e-3
    cfg = Config().replace(batch_size=TRAIN_BATCH, optimizer="adam_fused",
                           lr_schedule="constant", learning_rate=lr).validate()
    r = np.random.default_rng(9)
    x = torch.from_numpy(r.uniform(-1, 1, (TRAIN_BATCH, cfg.size, cfg.size, 3))
                         .astype(np.float32)).to(dev)
    t = torch.from_numpy(r.integers(1, cfg.steps + 1, TRAIN_BATCH).astype(np.int32))
    eps = torch.from_numpy(r.standard_normal(tuple(x.shape)).astype(np.float32)).to(dev)
    init = api.init_denoiser(cfg, device="cpu")
    p0 = [p.detach().to(dev) for p in init.parameters()]
    sync = torch.cuda.synchronize

    def kernel_bytes(model):
        return sum(p.numel() * p.element_size() for p in model.parameters() if p.ndim == 4)

    def run(on, check_ref=None):
        """One injected step on mesh ``on`` (None: one process)."""
        model = copy.deepcopy(init).to(dev)
        state = trainer.TrainState(0, model, trainer.make_optimizer(cfg).init(
            list(model.parameters())), None, None)
        res = {}
        rows = (x, t, eps)
        if on is not None:
            res["full_kernel_bytes"] = kernel_bytes(model)
            sh = mesh_lib.state_shardings(state, on)
            res["want_kernel_bytes"] = sum(
                p.numel() * p.element_size() // (TP_RANKS if sh[f"model.{k}"] else 1)
                for k, p in model.named_parameters() if p.ndim == 4)
            state = mesh_lib.shard_state(state, sh, on)
            res["kernel_bytes"] = kernel_bytes(model)
            res["split"] = sum(1 for n, s in sh.items() if s and n.startswith("model."))
            rows = tuple(mesh_lib.local_rows(v, on) for v in rows)
        step = trainer.make_injected_train_step(cfg, on)
        fdc.down_conv_fused.launches = adam_kernel.adam_fused.launches = 0
        state, loss = step(state, *rows)
        sync()
        res["launches"] = {"B2": adam_kernel.adam_fused.launches,
                           "B4": fdc.down_conv_fused.launches}
        fdc.down_conv_fused.launches = adam_kernel.adam_fused.launches = 0
        whole = mesh_lib.whole_module(model, on) if on is not None else model
        res["loss"] = float(loss)
        res["delta"] = [(p.detach() - q) for p, q in zip(whole.parameters(), p0)]
        res["checksum"] = float(sum(p.detach().double().sum() for p in whole.parameters()))
        del whole
        holder = [state]

        def again():
            holder[0], _ = step(holder[0], *rows)

        res["step_ms"] = _ranks_ms(torch, multihost, again, 3, ranks=on is not None)
        if on is not None:
            multihost.comm.reset()
            t1 = time.perf_counter()
            again()
            sync()
            res["comm"] = {"step_ms": (time.perf_counter() - t1) * 1e3,
                           "calls": dict(multihost.comm.calls),
                           "bytes": dict(multihost.comm.bytes)}
        if check_ref is not None:
            res["rel"] = abs(res["loss"] - check_ref["loss"]) / abs(check_ref["loss"])
            diff = torch.cat([(a - b).abs().flatten()
                              for a, b in zip(res["delta"], check_ref["delta"])])
            res["max_diff"] = diff.max().item()
            res["share"] = (diff > 1e-3 * lr).double().mean().item()
        fdc.down_conv_fused.launches = adam_kernel.adam_fused.launches = 0
        return res

    out = {}
    ref = run(None) if rank == 0 else None  # one process (B2 on), rank 0 alone
    multihost.barrier()
    if rank == 0:
        out["ref"] = {"loss": ref["loss"], "step_ms": ref["step_ms"]}
    res = run(mesh, ref)
    del res["delta"]
    out["tp"] = res
    torch.cuda.empty_cache()

    # [tp-gan]: a cycle-GAN step, B3 and B4, R1 on
    gcfg = Config().replace(batch_size=TP_GAN_BATCH, g_norm="instance", d_norm="instance",
                            optimizer="sgd", lr_schedule="constant",
                            learning_rate=1e-2, r1_weight=1.0).validate()
    rg = np.random.default_rng(12)
    a_img, b_img = (torch.from_numpy(rg.uniform(-1, 1, (TP_GAN_BATCH, gcfg.size, gcfg.size, 3))
                                     .astype(np.float32)).to(dev) for _ in range(2))
    nets = ("g_ab", "g_ba", "d_a", "d_b")

    def gan_run(on):
        state = gan.init_gan_state(gcfg, torch.Generator().manual_seed(0), device=dev)
        before = {n: [p.detach().clone() for p in getattr(state, n).parameters()] for n in nets}
        if on is not None:
            state = mesh_lib.shard_state(state, mesh_lib.state_shardings(state, on), on)
            step = mesh_lib.make_parallel_gan_train_step(gcfg, on)
        else:
            step = gan.make_gan_train_step(gcfg)
        norm.instance_norm_fused.launches = fdc.down_conv_fused.launches = 0
        state, m = step(state, a_img, b_img, torch.Generator(device=dev))
        sync()
        res = {"launches": [norm.instance_norm_fused.launches, fdc.down_conv_fused.launches],
               "metrics": {k: float(v) for k, v in m.items()}}
        res["delta"] = {n: [(p.detach() - q) for p, q in zip(
            mesh_lib.whole_module(getattr(state, n), on).parameters() if on is not None
            else getattr(state, n).parameters(), before[n])] for n in nets}
        holder = [state]

        def again():
            holder[0], _ = step(holder[0], a_img, b_img, torch.Generator(device=dev))

        res["step_ms"] = _ranks_ms(torch, multihost, again, 1, ranks=on is not None)
        norm.instance_norm_fused.launches = fdc.down_conv_fused.launches = 0
        return res

    gref = gan_run(None) if rank == 0 else None
    torch.cuda.empty_cache()
    multihost.barrier()
    g = gan_run(mesh)
    if rank == 0:
        for kind, names in (("g_diff", ("g_ab", "g_ba")), ("d_diff", ("d_a", "d_b"))):
            largest = max(u.abs().max().item() for n in names for u in gref["delta"][n])
            g[kind] = max((u - v).abs().max().item() for n in names
                          for u, v in zip(g["delta"][n], gref["delta"][n])) / largest
        del gref["delta"]
        out["gan_ref"] = gref
    del g["delta"]
    out["gan"] = g
    torch.cuda.empty_cache()

    # [slice]: mesh_slice=2 against flat data parallelism
    flat = run(mesh_lib.make_mesh(device=dev))
    sl = run(mesh_lib.make_mesh(device=dev, slices=2), flat)
    for d in (flat, sl):
        del d["delta"], d["comm"]
    out["flat"], out["slice"] = flat, sl
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    multihost.shutdown()
    print("DPRESULT " + json.dumps(out), flush=True)
    return 0


def _spatial_worker(torch, rank, port):
    """One rank of [spatial-agree] (see phase_spatial_agree)."""
    from gan_class_transfer2_tpu_torch.config import Config
    from gan_class_transfer2_tpu_torch.models import api, unet
    from gan_class_transfer2_tpu_torch.ops import fused_diffusion as fd
    from gan_class_transfer2_tpu_torch.parallel import multihost
    from gan_class_transfer2_tpu_torch.parallel import spatial_train, spatial_unet
    from gan_class_transfer2_tpu_torch.train import trainer

    dev = "cuda"
    torch.backends.cudnn.allow_tf32 = False
    multihost.initialize(f"127.0.0.1:{port}", DP_RANKS, rank, device=dev)
    mesh = spatial_train.make_spatial_mesh(device=dev)
    sync = torch.cuda.synchronize
    lr = 1e-3
    cfg = Config().replace(batch_size=TRAIN_BATCH, optimizer="adam_tf", lr_schedule="constant",
                           learning_rate=lr, fused_diffusion=False).validate()
    out = {"size": cfg.size, "octaves": cfg.octaves}
    r = np.random.default_rng(5)
    init = api.init_denoiser(cfg, device="cpu")
    model = copy.deepcopy(init).to(dev)
    x4 = torch.from_numpy(r.uniform(-1, 1, (4, cfg.size, cfg.size, 3)).astype(np.float32)).to(dev)
    with torch.no_grad():
        y = spatial_unet.make_spatial_unet_apply(cfg, mesh)(
            model, spatial_train.local_block(x4, mesh).contiguous())
        full = torch.cat(multihost.all_gather(y.contiguous(), "spatial"), 1)
        if rank == 0:
            want = unet.unet_apply(cfg, model, x4)
            out["forward"] = {"err": (full - want).abs().max().item(),
                              "scale": want.abs().max().item()}
    del model, y, full
    x = torch.from_numpy(r.uniform(-1, 1, (TRAIN_BATCH, cfg.size, cfg.size, 3))
                         .astype(np.float32)).to(dev)
    t = torch.from_numpy(r.integers(1, cfg.steps + 1, TRAIN_BATCH).astype(np.int32))
    eps = torch.from_numpy(r.standard_normal(tuple(x.shape)).astype(np.float32)).to(dev)
    p0 = [p.detach().to(dev) for p in init.parameters()]

    def fresh():
        m = copy.deepcopy(init).to(dev)
        return trainer.TrainState(0, m, trainer.make_optimizer(cfg).init(list(m.parameters())),
                                  None, None)

    if rank == 0:  # one process, rank 0 alone
        state = fresh()
        step = trainer.make_injected_train_step(cfg)
        state, loss = step(state, x, t, eps)
        sync()
        ref = {"loss": float(loss),
               "delta": [p.detach() - q for p, q in zip(state.model.parameters(), p0)]}
        holder = [state]

        def again():
            holder[0], _ = step(holder[0], x, t, eps)

        ref["step_ms"] = _ranks_ms(torch, multihost, again, 3, ranks=False)
        out["ref"] = {"loss": ref["loss"], "step_ms": ref["step_ms"]}
        del holder, state
    multihost.barrier()
    for name, m in (("spatial", mesh), ("dp_spatial", spatial_train.make_dp_spatial_mesh(
            1, DP_RANKS, device=dev))):
        make = (spatial_train.make_spatial_train_step if name == "spatial"
                else spatial_train.make_dp_spatial_train_step)
        step = make(cfg, m)
        rows = (spatial_train.local_block(x, m).contiguous(), spatial_train.local_rows(t, m),
                spatial_train.local_block(eps, m).contiguous())
        state = fresh()
        state, loss = step(state, rows[0], None, t_int=rows[1], epsilon=rows[2])
        sync()
        res = {"loss": float(loss), "checksum": float(sum(
            p.detach().double().sum() for p in state.model.parameters()))}
        if rank == 0:
            res["rel"] = abs(res["loss"] - ref["loss"]) / abs(ref["loss"])
            diff = torch.cat([(p.detach() - q - d).abs().flatten() for p, q, d in zip(
                state.model.parameters(), p0, ref["delta"])])
            res["max_diff"] = diff.max().item()
            res["share"] = (diff > 1e-3 * lr).double().mean().item()
        holder = [state]

        def again():
            holder[0], _ = step(holder[0], rows[0], None, t_int=rows[1], epsilon=rows[2])

        res["step_ms"] = _ranks_ms(torch, multihost, again, 3)
        multihost.comm.reset()
        again()
        sync()
        res["comm"] = {"calls": dict(multihost.comm.calls), "bytes": dict(multihost.comm.bytes)}
        out[name] = res
        del holder, state
        torch.cuda.empty_cache()
    out["options"] = _spatial_options(torch, rank, mesh, cfg, x, t, eps, lr)
    # the fused path: 2 generator-driven steps, B1s on each rank's block
    fcfg = cfg.replace(fused_diffusion=True, batch_size=8)
    state = fresh()
    step = spatial_train.make_spatial_train_step(fcfg, mesh)
    xb = spatial_train.local_block(x[:8], mesh).contiguous()
    gen = torch.Generator(device=dev).manual_seed(3)
    fd.diffuse_fused.launches = fd.diffuse_fused_sharded.launches = 0
    losses = []
    for _ in range(2):
        state, loss = step(state, xb, gen)
        losses.append(float(loss))
    out["fused"] = {"launches": {"B1": fd.diffuse_fused.launches,
                                 "B1s": fd.diffuse_fused_sharded.launches},
                    "losses": losses}
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    multihost.shutdown()
    print("DPRESULT " + json.dumps(out), flush=True)
    return 0


# [spatial-agree]'s cases of what JAX's GSPMD step takes besides the plain
# step: SGD with momentum under the norms (a conv bias ahead of a norm has
# no true gradient, only rounding noise, which Adam would scale to ±lr)
SPATIAL_CASES = (("g_norm=instance", dict(g_norm="instance", optimizer="momentum")),
                 ("g_norm=batch", dict(g_norm="batch", optimizer="momentum")),
                 ("per_step_output", dict(per_step_output=True)),
                 ("loss=dct", dict(loss="dct")),
                 ("loss=mse_multiscale", dict(loss="mse_multiscale")),
                 ("dynamic loss scale", dict(dynamic_loss_scale=True)),
                 ("uint8 pool", {}),
                 ("remat", dict(remat=True)),
                 ("remat + g_norm=instance", dict(remat=True, g_norm="instance",
                                                  optimizer="momentum")))
SPATIAL_POOL = (32, 288, 288)  # [spatial-agree]'s uint8 pool: images (N, H, W)


def _spatial_options(torch, rank, mesh, cfg, x, t, eps, lr):
    """One injected full-width step on the 2 height shards for each of
    SPATIAL_CASES against the one-process injected step on the same
    weights, t and ε (rank 0 alone); the uint8 case draws its rows from a
    raw HBMDataset under the spatial mesh (both ranks the same rows) and
    crops them with the step's generator, the one process with the same
    draws. Returns {case: loss, rel, update share, launches, checksum,
    collectives by kind, the step's peak MiB above what was resident
    before it (and, for a remat case, the same step's without remat)}."""
    from gan_class_transfer2_tpu_torch.data import device_augment
    from gan_class_transfer2_tpu_torch.models import api
    from gan_class_transfer2_tpu_torch.ops import fused_diffusion as fd
    from gan_class_transfer2_tpu_torch.ops import norm
    from gan_class_transfer2_tpu_torch.parallel import multihost, spatial_train
    from gan_class_transfer2_tpu_torch.parallel.mesh import Sharding
    from gan_class_transfer2_tpu_torch.train import trainer

    dev = x.device
    pool = torch.from_numpy(np.random.default_rng(8).integers(0, 256, (*SPATIAL_POOL, 3),
                                                               dtype=np.uint8))
    out = {}
    for name, over in SPATIAL_CASES:
        c = cfg.replace(**over).validate()
        init = api.init_denoiser(c, device="cpu")  # seed 0, alike on both ranks
        p0 = [p.detach().to(dev) for p in init.parameters()]

        def fresh():
            m = copy.deepcopy(init).to(dev)
            scale = None
            if c.dynamic_loss_scale:
                scale = trainer.ScaleState(torch.tensor(2.0**15, device=dev),
                                           torch.zeros((), dtype=torch.int32, device=dev))
            return trainer.TrainState(0, m, trainer.make_optimizer(c).init(
                list(m.parameters())), None, scale)

        gen = None
        batch, whole = spatial_train.local_block(x, mesh).contiguous(), x
        if name == "uint8 pool":
            hbm = device_augment.HBMDataset(pool, c.size, TRAIN_BATCH, seed=4, raw=True,
                                            sharding=Sharding(mesh, (None, "spatial")),
                                            device=dev)
            batch = next(iter(hbm))
            whole = device_augment.augment_batch(batch, torch.Generator(device=dev)
                                                 .manual_seed(21), c.size)
            gen = torch.Generator(device=dev).manual_seed(21)
        res = {}
        if rank == 0:
            state, loss = trainer.make_injected_train_step(c)(fresh(), whole, t, eps)
            torch.cuda.synchronize()
            ref_loss = float(loss)
            ref = [p.detach() - q for p, q in zip(state.model.parameters(), p0)]
            del state
        multihost.barrier()
        step = spatial_train.make_spatial_train_step(c, mesh)
        state = fresh()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        multihost.comm.reset()
        counts = (norm.block_launches(), norm.instance_norm_fused.launches,
                  fd.diffuse_fused.launches + fd.diffuse_fused_sharded.launches)
        state, loss = step(state, batch, gen, t_int=spatial_train.local_rows(t, mesh),
                           epsilon=spatial_train.local_block(eps, mesh).contiguous())
        torch.cuda.synchronize()
        res["peak_mb"] = (torch.cuda.max_memory_allocated() - resident) / 2**20
        res["comm"] = dict(multihost.comm.calls)
        res["launches"] = {"B3 blocks": norm.block_launches() - counts[0],
                           "B3": norm.instance_norm_fused.launches - counts[1],
                           "B1/B1s": fd.diffuse_fused.launches
                           + fd.diffuse_fused_sharded.launches - counts[2]}
        res["loss"] = float(loss)
        res["checksum"] = float(sum(p.detach().double().sum() for p in state.model.parameters()))
        if state.scale_state is not None:
            res["scale"] = [float(state.scale_state.scale), int(state.scale_state.good_steps)]
        if rank == 0:
            res["rel"] = abs(res["loss"] - ref_loss) / abs(ref_loss)
            res["ref_loss"] = ref_loss
            diff = torch.cat([(p.detach() - q - d).abs().flatten() for p, q, d in zip(
                state.model.parameters(), p0, ref)])
            res["max_diff"] = diff.max().item()
            res["share"] = (diff > 1e-3 * c.learning_rate).double().mean().item()
            del ref, diff
        del state
        if c.remat:  # the same step without remat, in its place: its peak and its halos
            plain = fresh()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            multihost.comm.reset()
            spatial_train.make_spatial_train_step(c.replace(remat=False), mesh)(
                plain, batch, gen, t_int=spatial_train.local_rows(t, mesh),
                epsilon=spatial_train.local_block(eps, mesh).contiguous())
            torch.cuda.synchronize()
            res["peak_mb_without"] = (torch.cuda.max_memory_allocated() - resident) / 2**20
            res["halos_without"] = multihost.comm.calls.get("halo", 0)
            del plain
        out[name] = res
        del init, p0
        torch.cuda.empty_cache()
    return out


def _ranks_ms(torch, multihost, fn, reps=3, ranks=True):
    """Median ms of ``fn`` over ``reps`` runs, each started on every rank
    together (a barrier first, with ``ranks``) and ended by a synchronise."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        if ranks:
            multihost.barrier()
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    return float(np.median(times)) * 1e3


def _dp_distill_worker(torch, rank, port, spec):
    """One rank of [dp-distill] (see phase_dp_distill): it joins the group
    itself, so that ``cli distill --coordinator`` runs as a rank of it and
    leaves it to this worker for the injected step and the timing."""
    from gan_class_transfer2_tpu_torch.parallel import mesh as mesh_lib
    from gan_class_transfer2_tpu_torch.parallel import multihost
    from gan_class_transfer2_tpu_torch.train import distill, trainer
    from gan_class_transfer2_tpu_torch.utils import checkpoint as ckpt_lib

    multihost.initialize(f"127.0.0.1:{port}", DP_RANKS, rank, device="cuda")
    mesh = mesh_lib.make_mesh(device="cuda")
    out = _rank_cli(rank, port, spec)
    rc = out["rc"]

    # one injected full-width step: two ranks against one process (rank 0)
    c = ckpt_lib.load_config(spec["ckpt"]).validate()
    teacher = trainer.eval_model(ckpt_lib.restore(spec["ckpt"],
                                                  trainer.init_state(c, device="cuda")))
    stride = 2 * c.sample_stride
    opt = distill.distill_opt_config(c, 100)
    r = np.random.default_rng(9)
    x = torch.from_numpy(r.uniform(-1, 1, (TRAIN_BATCH, c.size, c.size, 3))
                         .astype(np.float32)).cuda()
    grid = np.asarray(distill.student_grid(c, stride), np.int32)
    t = torch.from_numpy(grid[r.integers(0, len(grid), TRAIN_BATCH)]).cuda()
    eps = torch.from_numpy(r.standard_normal(tuple(x.shape)).astype(np.float32)).cuda()
    p0 = [p.detach().clone() for p in teacher.parameters()]

    def injected(m):
        st = distill.init_student(opt, teacher, m)
        rows = [mesh_lib.local_rows(v, m) for v in (x, t, eps)]
        st, loss = distill.make_distill_step(opt, stride, m)(st, teacher, rows[0], None,
                                                             t=rows[1], epsilon=rows[2])
        return float(loss), [p.detach() - q for p, q in zip(st.model.parameters(), p0)]

    if rank == 0:
        ref_loss, ref_delta = injected(None)
    loss, delta = injected(mesh)
    if rank == 0:
        lr = opt.learning_rate
        diff = torch.cat([(a - b).abs().flatten() for a, b in zip(delta, ref_delta)])
        out.update(loss=loss, ref_loss=ref_loss, rel=abs(loss - ref_loss) / abs(ref_loss),
                   max_diff=diff.max().item(), share=(diff > 1e-3 * lr).double().mean().item())
        del ref_delta, diff
    del delta
    # the two-rank step on drawn t and ε, timed; the gradient all-reduce
    gen = torch.Generator(device="cuda").manual_seed(0)
    holder = [distill.init_student(opt, teacher, mesh)]
    step = distill.make_distill_step(opt, stride, mesh)
    xb = mesh_lib.local_rows(x, mesh)

    def one():
        holder[0], _ = step(holder[0], teacher, xb, gen)

    for _ in range(2):
        one()
    out["step_ms"] = _ranks_ms(torch, multihost, one, reps=5)
    del holder
    grads = [torch.randn_like(p) for p in p0]
    out["grad_mb"] = sum(g.numel() for g in grads) * 4 / 1e6
    out["allreduce_ms"] = _ranks_ms(torch, multihost, lambda: multihost.all_reduce_mean(grads),
                                    reps=5)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    multihost.shutdown()
    print("DPRESULT " + json.dumps(out), flush=True)
    return rc


def dp_worker(argv):
    """``python3 chip_smoke.py --dp-worker <cli|agree|distill|tp|spatial> <rank> <port> <spec
    JSON>``: one rank of a [dp-train], [dp-agree], [dp-distill], [tp-train],
    [tp-agree]/[tp-gan]/[slice] or [spatial-agree] job (started by
    _dp_jobs)."""
    mode, rank, port, spec = argv[0], int(argv[1]), argv[2], json.loads(argv[3])
    import torch

    if mode == "cli":
        return _dp_cli_worker(torch, rank, port, spec)
    if mode == "distill":
        return _dp_distill_worker(torch, rank, port, spec)
    if mode == "tp":
        return _tp_worker(torch, rank, port)
    if mode == "spatial":
        return _spatial_worker(torch, rank, port)
    return _dp_agree_worker(torch, rank, port)


# [epilogue]: the train cell's two largest up-conv outputs (H = W, C), each
# the sum of a (branch, skip) pair, with bias and ReLU
EPILOGUE_SHAPES = (("up0", 256, 64), ("up1", 128, 128))
EPILOGUE_BATCHES = (256, 16)  # the train cell's batch and the sampler's
# as tests/test_torch_conv_epilogue.py: the forward, and db
EPILOGUE_RTOL = {"float32": 0.0, "bfloat16": 1e-2, "float16": 2e-3}
EPILOGUE_DB_RTOL = {"float32": 1e-5, "bfloat16": 1e-2, "float16": 2e-3}


def epilogue_config(batch):
    """The train and sampler cells' configuration (``perfbench/configs/
    ddpm-unet256.json``: Config()'s widths on the kernel path in bf16)."""
    from gan_class_transfer2_tpu_torch.config import Config

    return Config(compute_dtype="bfloat16", optimizer="adam_fused",
                  fused_diffusion=True, batch_size=batch).validate()


def epilogue_per_call(fdc, cfg, batch):
    """Conv epilogue launches of one denoiser forward: every conv but the
    head's dense and the down convs B4 takes (whose forward fuses it); a
    train step adds 2 a conv with bias and ReLU in the backward (gs, then
    db), B4's backward included. Returns (forward, train step)."""
    from gan_class_transfer2_tpu_torch.models import unet

    convs = sum(isinstance(m, unet.Conv) for m in unet.Denoiser(cfg).modules()) - 1
    b4 = b4_per_call(fdc, cfg, batch)
    return convs - b4, 3 * (convs - b4) + 2 * b4


def phase_epilogue(torch, fdc, trainer):
    """The conv epilogue's kernels against their plain versions at up0's and
    up1's outputs at batch 256 and 16, float32 and bfloat16: a pair's
    forward (sum, bias, ReLU) and its backward (ReLU mask, db), worst
    relative errors, kernel, plain and bound ms (bytes at 3.35 TB/s); the
    host µs of a call without a gradient against the torch ops; then the
    launches of one train step of the train cell (batch 256) and one
    denoiser call of the sampler's (batch 16) against ``epilogue_per_call``
    with no torch-op backward. Returns the kernels line's row."""
    from gan_class_transfer2_tpu_torch.models import unet
    from gan_class_transfer2_tpu_torch.ops import conv_epilogue as ce

    def rel(a, w):
        return (a.float() - w.float()).abs().max().item() / w.float().abs().max().item()

    gen = torch.Generator(device="cuda").manual_seed(23)
    worst = {}
    timed = {}
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16),
                              ("float16", torch.float16)):
        for batch in EPILOGUE_BATCHES:
            for name, hw, c in EPILOGUE_SHAPES:
                shape = (batch, hw, hw, c)
                y, other, g = (torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
                               for _ in range(3))
                bias = torch.randn(c, generator=gen, device="cuda", dtype=dtype)
                nbytes = 3 * y.numel() * y.element_size()
                out = ce.epilogue_fused(y, bias, True, other)
                want = ce.epilogue_plain(y, bias, True, other)
                err = rel(out, want)
                if err > EPILOGUE_RTOL[dtype_name]:
                    fail(f"epilogue {name} b{batch} {dtype_name}: forward error {err:.3e}")
                del want
                gs, db = ce._backward_fused(g, out, True, True, dtype)
                gw, dbw = ce._backward_plain(g, out, True, True, dtype)
                db_err = rel(db, dbw)
                if not torch.equal(gs, gw) or db_err > EPILOGUE_DB_RTOL[dtype_name]:
                    fail(f"epilogue {name} b{batch} {dtype_name}: backward gs equal "
                         f"{torch.equal(gs, gw)}, db error {db_err:.3e}")
                # a float32 bias (B4's parameter) takes db in float32 whatever g's dtype
                _, db = ce._backward_fused(g, out, False, True, torch.float32)
                _, dbw = ce._backward_plain(g, out, False, True, torch.float32)
                db32_err = rel(db, dbw)
                if db.dtype != torch.float32 or db32_err > 1e-5:
                    fail(f"epilogue {name} b{batch} {dtype_name}: float32 db {db.dtype}, error "
                         f"{db32_err:.3e}")
                del gs, gw
                worst[dtype_name] = max(worst.get(dtype_name, 0.0), err)
                fwd = queued_ms(lambda: ce.epilogue_fused(y, bias, True, other))
                fwd_plain = queued_ms(lambda: ce.epilogue_plain(y, bias, True, other))
                bwd = queued_ms(lambda: ce._backward_fused(g, out, True, True, dtype))
                bwd_plain = queued_ms(lambda: ce._backward_plain(g, out, True, True, dtype))
                bound = _bytes_ms(nbytes)
                timed[(dtype_name, batch, name)] = (fwd, bwd, bound, fwd_plain)
                print(f"[epilogue] {name} {shape} {dtype_name}: forward kernel {fwd:.4f} ms "
                      f"({bound / fwd:.1%} of bound), plain {fwd_plain:.4f}; backward kernel "
                      f"{bwd:.4f} ms ({bound / bwd:.1%}), plain {bwd_plain:.4f}; bound "
                      f"{bound:.4f} ms ({nbytes / 1e9:.3f} GB each way); error out {err:.3e}, "
                      f"db {db_err:.3e}, float32 db {db32_err:.3e}")
                del y, other, g, out, bias
                torch.cuda.empty_cache()
    print(f"[epilogue] worst relative error of the forward: float32 {worst['float32']:.3e}, "
          f"bfloat16 {worst['bfloat16']:.3e}, float16 {worst['float16']:.3e}")
    # host time a call on the sampler's path (no gradient): the op against
    # the torch ops it replaced, at up5's pair (16, 8, 8, 512), where the
    # device time is small
    y, other = (torch.randn((16, 8, 8, 512), generator=gen, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2))
    bias = torch.randn(512, generator=gen, device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        host_op = host_ms(lambda: ce.conv_epilogue(y, bias, True, other), reps=2000)
        host_plain = host_ms(lambda: ce.epilogue_plain(y, bias, True, other), reps=2000)
    print(f"[epilogue] host µs a call without a gradient (16, 8, 8, 512) bf16: conv_epilogue "
          f"{host_op * 1e3:.2f}, the torch ops it replaced {host_plain * 1e3:.2f}")
    fwd, bwd, bound, fwd_plain = timed[("bfloat16", 256, "up0")]
    if bound / fwd < 0.7 or bound / bwd < 0.7:
        fail(f"epilogue up0 b256 bf16: forward {bound / fwd:.1%}, backward {bound / bwd:.1%} "
             "of the byte bound, under 70%")

    # the main paths: one train step of the train cell, one denoiser call of
    # the sampler's; every epilogue a launch, none a torch-op backward
    cfg = epilogue_config(256)
    per_call, per_step = epilogue_per_call(fdc, cfg, 256)
    state = trainer.init_state(cfg, device="cuda")
    step = trainer.make_train_step(cfg)
    xb = torch.rand((256, cfg.size, cfg.size, 3), generator=gen, device="cuda") * 2 - 1
    state, _ = step(state, xb, gen)
    # the comparisons and timing loops above do not count
    ce.conv_epilogue.launches = ce.ConvEpilogue.graph_backwards = 0
    state, loss = step(state, xb, gen)
    got = (ce.conv_epilogue.launches, ce.ConvEpilogue.graph_backwards)
    if got != (per_step, 0) or not np.isfinite(float(loss)):
        fail(f"epilogue: a train step at batch 256 launched {got[0]} epilogues with {got[1]} "
             f"torch-op backwards, expected {per_step} and 0 (loss {float(loss)})")
    model = state.model
    del state, step, xb
    torch.cuda.empty_cache()
    sample_cfg = epilogue_config(16)
    x = torch.randn((16, cfg.size, cfg.size, 3), generator=gen, device="cuda")
    with torch.no_grad():
        ce.conv_epilogue.launches = 0
        unet.unet_apply(sample_cfg, model, x)
        call = ce.conv_epilogue.launches
    if call != epilogue_per_call(fdc, sample_cfg, 16)[0]:
        fail(f"epilogue: a denoiser call at batch 16 launched {call} epilogues, expected "
             f"{epilogue_per_call(fdc, sample_cfg, 16)[0]}")
    print(f"[epilogue] launches: {got[0]} a train step at batch 256 ({per_call} forward, "
          f"{per_step - per_call} backward), {call} a denoiser call at batch 16; "
          f"graph_backwards 0")
    del model
    torch.cuda.empty_cache()
    return {"name": "conv_epilogue_bf16", "route": "cuda",
            "source": "gan_class_transfer2_tpu_torch/csrc/conv_epilogue.cu",
            "replaces": "none (XLA's fused conv tail; models/unet.py _pair_up_conv)",
            "launches": got[0], "max_abs_err": worst["bfloat16"],
            "ms": fwd, "plain_ms": fwd_plain, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": None}


def epilogue_only():
    """``[build]`` and ``[epilogue]`` alone."""
    import torch

    from gan_class_transfer2_tpu_torch.ops import fused_down_conv as fdc
    from gan_class_transfer2_tpu_torch.train import trainer

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an NVIDIA card")
    phase_build()
    row = phase_epilogue(torch, fdc, trainer)
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0)}}))
    return 0


def cyclegan_only():
    """``[build]`` and ``[cyclegan]`` alone."""
    import torch

    from gan_class_transfer2_tpu_torch.ops import fused_down_conv as fdc
    from gan_class_transfer2_tpu_torch.ops import norm
    from gan_class_transfer2_tpu_torch.train import gan

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an NVIDIA card")
    phase_build()
    cfg = cyclegan_config()
    rows, _ = phase_cyclegan_kernels(torch, torch.nn.functional, fdc, norm, cfg)
    launches = phase_cyclegan(torch, fdc, norm, gan, cfg)
    print(json.dumps({"kernels": [dict(row, launches=launches[key][0])
                                  for key, row in rows.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0)}}))
    return 0


def main():
    try:
        import torch
        import torch.nn.functional as F
    except ImportError as e:
        fail(f"PyTorch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an NVIDIA card")
    try:
        import gan_class_transfer2_tpu_torch as port
        from gan_class_transfer2_tpu_torch import cli
        from gan_class_transfer2_tpu_torch.models import api
        from gan_class_transfer2_tpu_torch.ops import fused_down_conv as fdc
        from gan_class_transfer2_tpu_torch.sample import sampler
        from gan_class_transfer2_tpu_torch.utils import png, weights
    except ImportError as e:
        fail(f"the port is not beside this script (run it from the repo root): {e}")
    if not os.path.abspath(port.__file__).startswith(HERE + os.sep):
        fail(f"imported the port from {port.__file__}, not from {HERE}")
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        fail("jax was imported")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    # float32 references are IEEE float32 (the JAX package's Precision.HIGHEST)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    phase_build()
    kernels = phase_kernels(torch, F, fdc)

    from gan_class_transfer2_tpu_torch.config import Config

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        weights_npz = os.path.join(tmp, "weights.npz")
        full = api.init_denoiser(Config().validate(), device="cpu")  # random, seed 0
        weights.save_flat_npz(weights_npz, weights.export_flat_weights(full))
        print(f"[weights] default config, {sum(p.numel() for p in full.parameters())} "
              f"params, random from seed 0")
        del full
        sampled, cfg = phase_sample(fdc, cli, sampler, png, weights_npz, tmp)
        model = phase_timing(torch, fdc, sampler, weights, weights_npz, cfg)
    edit_launches = phase_edit(torch, fdc, sampler, model, cfg)
    del model
    phase_reference(torch, api, sampler)

    from gan_class_transfer2_tpu_torch.ops import adam_kernel
    from gan_class_transfer2_tpu_torch.ops import fused_diffusion as fd
    from gan_class_transfer2_tpu_torch.train import trainer

    # the train step holds IEEE float32 itself (models/unet.ieee_fp32, from
    # the loss forward through backward()): train under torch's defaults
    torch.backends.cudnn.allow_tf32 = True
    train_rows, b4_err = phase_train_kernels(torch, F, fdc, fd, adam_kernel, api, cfg)
    epilogue_row = phase_epilogue(torch, fdc, trainer)
    train_launches, train_results = phase_train(torch, cli, fdc, fd, adam_kernel, trainer, cfg)
    hbm_launches = phase_train_hbm(torch, fdc, fd, adam_kernel, trainer, cfg, train_results)
    for name, n in hbm_launches.items():
        train_launches[name] += n
    phase_train_agree(torch, fdc, adam_kernel, api, trainer, cfg)

    from gan_class_transfer2_tpu_torch.ops import norm
    from gan_class_transfer2_tpu_torch.train import gan

    files = tempfile.TemporaryDirectory(prefix="chip_smoke_files_")
    paeth_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_paeth_")
    t0 = time.perf_counter()
    globs = write_class_pngs(files.name)
    paeth_glob = write_paeth_pngs(paeth_dir.name)
    print(f"[loader] wrote {PAETH_FILES[0]} Paeth/Average PNGs of {PAETH_FILES[1]}²")
    phase_loader(globs, paeth_glob, train_results[("float32", "kernels")]["images_per_sec"])
    print(f"[loader] the phase took {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    cli_launches = phase_train_cli(torch, cli, fdc, fd, adam_kernel, sampler, cfg, files.name)
    resume_launches = phase_train_resume(torch, cli, fdc, fd, adam_kernel, trainer, sampler,
                                         png, cfg, files.name)
    t1 = time.perf_counter()
    cache_launches = phase_cache(torch, cli, fdc, fd, adam_kernel, cfg, paeth_dir.name,
                                 paeth_glob)
    print(f"[cache] the phase took {time.perf_counter() - t1:.2f} s")
    paeth_dir.cleanup()
    for name in cli_launches:
        train_launches[name] += cli_launches[name] + resume_launches[name] + cache_launches[name]
    print(f"[train-resume] [train-cli], [train-resume] and [cache] took "
          f"{time.perf_counter() - t0:.2f} s")

    gan_rows, b4_gan_err = phase_gan_kernels(torch, F, fdc, norm, cfg)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gan_") as tmp:
        gan_launches = phase_gan(torch, cli, fdc, norm, gan, cfg, tmp)
    cyclegan_cfg = cyclegan_config()
    cyclegan_rows, b4_cyclegan_err = phase_cyclegan_kernels(torch, F, fdc, norm, cyclegan_cfg)
    cyclegan_launches = phase_cyclegan(torch, fdc, norm, gan, cyclegan_cfg)
    phase_gan_agree(torch, fdc, norm, gan, cfg)
    phase_gan_reference(torch, fdc, norm, gan)
    t0 = time.perf_counter()
    cli_b3, cli_b4 = phase_gan_train_cli(torch, cli, fdc, norm, cfg, files.name, globs)
    print(f"[gan-train-cli] took {time.perf_counter() - t0:.2f} s")
    eval_b3, eval_b4 = phase_eval(torch, cli, fdc, norm, sampler, cfg, files.name)
    t0 = time.perf_counter()
    npz, inception_b4 = phase_inception(torch, cli, fdc, sampler, files.name, card)
    fid_b3, fid_b4 = phase_fid_steps(torch, fdc, norm, cfg, files.name, globs, npz, card)
    phase_profiler(torch, fdc, api, cfg, files.name, card)
    t_new = time.perf_counter() - t0

    from gan_class_transfer2_tpu_torch.train import conditional_gan as cgan

    t0 = time.perf_counter()
    globs3 = (*globs, write_third_class(files.name))
    cond_launches = phase_cond_train_cli(torch, cli, fdc, fd, adam_kernel, api, sampler, png,
                                         cfg, files.name, globs3, train_results)
    phase_train_agree(torch, fdc, adam_kernel, api, trainer, cfg.replace(num_classes=3),
                      tag="cond-train-cli")
    for name, n in cond_launches.items():
        train_launches[name] += n
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cgan_") as tmp:
        cgan_launches = phase_cgan(torch, cli, fdc, norm, cgan, cfg, tmp)
    phase_cgan_agree(torch, fdc, norm, cgan, cfg)
    cgan_b3, cgan_b4 = phase_cgan_train_cli(torch, cli, fdc, norm, cfg, files.name, globs3)
    print(f"[cgan-train-cli] [cond-train-cli], [cgan], [cgan-agree] and [cgan-train-cli] took "
          f"{time.perf_counter() - t0:.2f} s")
    # [distill] and [bundle] read the train states that [serve] replaces
    # with its served part for the reload test, so they come first
    t0 = time.perf_counter()
    distill_b4, distill_ms = phase_distill(torch, cli, fdc, fd, adam_kernel, trainer, sampler,
                                           cfg, files.name, train_results)
    t1 = time.perf_counter()
    dp_distill_b4 = phase_dp_distill(torch, fdc, sampler, files.name, card, distill_ms)
    t_mid = time.perf_counter() - t1
    dirs, (bundle_b3, bundle_b4) = phase_bundle(torch, cli, fdc, norm, sampler, gan, cgan, png,
                                                files.name, card)
    t1 = time.perf_counter()
    mesh_b3, mesh_b4 = phase_serve_mesh(torch, fdc, norm, sampler, png, files.name, globs, card)
    t_mid += time.perf_counter() - t1
    t_db = time.perf_counter() - t0 - t_mid
    t_new += t_mid
    print(f"[serve-mesh] [inception], [fid-steps], [profiler], [dp-distill] and [serve-mesh] "
          f"took {t_new:.2f} s")
    t0 = time.perf_counter()
    tp_rows = phase_tp_kernel(torch, F, fdc, card)
    tp_launches = phase_tp(fdc, cfg, card)
    for name, n in phase_tp_train(torch, cli, fdc, fd, trainer, sampler, cfg, files.name,
                                  card).items():
        tp_launches[name] = tp_launches.get(name, 0) + n
    spatial_rows = phase_spatial_kernel(torch, fd, cfg, card)
    blocks_row = phase_spatial_norm(torch, norm, cfg, card)
    spatial_launches = phase_spatial_agree(card)
    tp_launches["diffuse_sharded_f32"] += spatial_launches["diffuse_sharded_f32"]
    print(f"[spatial-agree] [tp-kernel], [tp-agree], [tp-gan], [slice], [tp-train], "
          f"[spatial-kernel] and [spatial-agree] took {time.perf_counter() - t0:.2f} s; B4 on "
          f"the TP local shapes fp32 {tp_rows['float32']['ms']:.4f} ms / bf16 "
          f"{tp_rows['bfloat16']['ms']:.4f} ms; B1s on a 2-way height block "
          f"{spatial_rows['2-way spatial']['ms']:.4f} ms")
    t0 = time.perf_counter()
    pp_launches = phase_pp_agree(torch, fdc, fd, adam_kernel, trainer, cfg, card)
    for name, n in phase_pp_train(torch, cli, fdc, fd, adam_kernel, sampler, cfg, files.name,
                                  card).items():
        pp_launches[name] += n
    phase_plan(torch, cli, cfg, card)
    print(f"[plan] [pp-agree], [pp-train] and [plan] took {time.perf_counter() - t0:.2f} s")
    serve_b3, serve_b4 = phase_serve(torch, fdc, norm, sampler, gan, png, files.name, globs,
                                     card)
    cls_b3, cls_b4 = phase_serve_classes(torch, fdc, norm, sampler, cgan, png, files.name, globs3,
                                         card)
    t0 = time.perf_counter()
    sb_b3, sb_b4 = phase_serve_bundle(torch, fdc, norm, sampler, png, files.name, globs, dirs,
                                      card)
    print(f"[serve-bundle] [distill], [bundle] and [serve-bundle] took "
          f"{t_db + time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    dp_row = phase_dp_kernel(torch, fd, cfg, card)
    dp_launches = phase_dp_train(torch, cli, fdc, fd, adam_kernel, norm, sampler, cfg, files.name,
                                 globs, globs3, train_results, card)
    agree_launches = phase_dp_agree(card, train_results)
    print(f"[dp-agree] [dp-kernel], [dp-train] and [dp-agree] took "
          f"{time.perf_counter() - t0:.2f} s")
    for name in ("diffuse_f32", "adam_f32m", "down_conv_k4s2_f32"):
        train_launches[name] += dp_launches[name] + pp_launches[name]
    train_launches["down_conv_k4s2_f32"] += (inception_b4 + dp_distill_b4
                                             + tp_launches["down_conv_k4s2_f32"]
                                             + agree_launches["down_conv_k4s2_f32"])
    dp_launches["diffuse_sharded_f32"] += tp_launches["diffuse_sharded_f32"]
    dp_launches["instance_norm_f32"] += tp_launches["instance_norm_f32"]
    files.cleanup()
    gan_launches["float32"] = (
        gan_launches["float32"][0] + cli_b3 + eval_b3 + serve_b3 + cgan_launches["float32"][0]
        + cgan_b3 + cls_b3 + bundle_b3 + sb_b3 + dp_launches["instance_norm_f32"] + fid_b3
        + mesh_b3,
        gan_launches["float32"][1] + cli_b4 + eval_b4 + serve_b4 + cgan_launches["float32"][1]
        + cgan_b4 + cls_b4 + distill_b4 + bundle_b4 + sb_b4 + fid_b4 + mesh_b4)
    gan_launches["bfloat16"] = tuple(a + b for a, b in zip(gan_launches["bfloat16"],
                                                           cgan_launches["bfloat16"]))
    # the CycleGAN's norms have no affine: rows of their own below; its B4
    # launches join the down conv's
    gan_launches["bfloat16"] = (gan_launches["bfloat16"][0],
                                gan_launches["bfloat16"][1] + cyclegan_launches["bfloat16"][1])
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        fail("jax was imported")

    # one row per compiled kernel; the down conv's times and bound sum the
    # four shapes of one denoiser call at batch 4, its max_abs_err is the
    # worst forward error at batch 4 and 16 (with and without ReLU); the
    # instance norm's times and bound sum one GAN step's 102 launches at
    # batch 16 (its backward's row: the step's 102 backwards, launched by
    # [gan]'s profile steps); launches are the main-path runs' (sample, edit, train,
    # train-hbm, train-cli, train-resume, cache, gan, gan-train-cli, eval,
    # cond-train-cli, cgan, cgan-train-cli, serve, distill, bundle,
    # serve-bundle, dp-train's ranks, inception's eval, fid-steps, dp-distill's
    # ranks and serve-mesh for the down conv; gan, gan-train-cli, eval, cgan,
    # cgan-train-cli, serve, bundle, serve-bundle, dp-train's GAN ranks,
    # fid-steps and serve-mesh for the instance norm; the train phases, cache,
    # cond-train-cli and dp-train's world-size-1 run for B1 and B2;
    # dp-train's diffusion ranks for B1s; since PR 13 tp-agree's, tp-gan's,
    # slice's and tp-train's ranks for the down conv, tp-gan's for the
    # instance norm, tp-train's and spatial-agree's ranks for B1s; the
    # pipeline phases' (pp-agree's steps, pp-train's) for B1, B2 and B4;
    # spatial-agree's g_norm=instance step for B3 over height blocks, whose
    # times and bound sum one forward's 12 norm layers of a rank, and
    # dp-agree's batch-norm GAN ranks for the down conv)
    source = "gan_class_transfer2_tpu_torch/csrc/down_conv.cu"
    replaces = "gan_class_transfer2_tpu/ops/pallas_conv.py:36"
    rows = []
    for dtype, launches in (
        ("float32", sampled["float32"]["launches"] + edit_launches
         + train_launches["down_conv_k4s2_f32"] + gan_launches["float32"][1]),
        ("bfloat16", sampled["bfloat16"]["launches"] + train_launches["down_conv_k4s2_bf16"]
         + gan_launches["bfloat16"][1]),
    ):
        s = kernels[dtype]
        rows.append({
            "name": f"down_conv_k4s2_{'f32' if dtype == 'float32' else 'bf16'}",
            "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(s["max_abs_err"], b4_err[dtype], b4_gan_err[dtype],
                               b4_cyclegan_err[dtype]),
            "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": "operations" if s["flops_ms"] >= s["bytes_ms"] else "bytes",
            "library_ms": s["library_ms"],
        })
    for name, row in train_rows.items():
        rows.append(dict(row, launches=train_launches[name]))
    rows.append(dict(dp_row, launches=dp_launches["diffuse_sharded_f32"]))
    for key, row in gan_rows.items():  # B3's forward and backward rows by dtype
        rows.append(dict(row, launches=gan_launches[key][0]))
    for key, row in cyclegan_rows.items():  # B3 without affine, the CycleGAN's norms
        rows.append(dict(row, launches=cyclegan_launches[key][0]))
    rows.append(dict(blocks_row, launches=spatial_launches["instance_norm_blocks_f32"]))
    rows.append(epilogue_row)  # launches: [epilogue]'s train step at batch 256
    for row in rows:
        if row["launches"] <= 0:
            fail(f"kernel {row['name']} was not launched on the main path")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--dp-worker":
        sys.exit(dp_worker(sys.argv[2:]))
    if len(sys.argv) > 1 and sys.argv[1] == "--norm-ops":
        sys.exit(norm_ops_worker())
    if len(sys.argv) > 1 and sys.argv[1] == "--cyclegan":
        sys.exit(cyclegan_only())
    if len(sys.argv) > 1 and sys.argv[1] == "--epilogue":
        sys.exit(epilogue_only())
    sys.exit(main())
