#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gcc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. card     the device's name and power limit (nvidia-smi);
  2. build    nvcc builds every CUDA source under gcc_tpu_torch/csrc;
  3. kernels  each stage kernel (B2-fwd, B2-bwd-pw, B2-bwd-dw) against its
              plain PyTorch version at the main path's teacher and student
              stage shapes and at CycleGAN's batch-1 shapes (teacher
              256 -> 256 at 64x64, student block 8 of cfg_BtoA 96 -> 81 ->
              96), then the differentiable stage against autograd
              through sep_stage_reference (relu's mask from the kernel's
              b-hat, the pixels where it differs from the plain forward's
              counted and held to |b-hat| < 1e-4); that two calls of each
              give the same bits; where chip_ab/b2_parent/ holds an earlier
              commit's mobile_block.cu and mobile_block_bf16.cu (with
              tf32_mma.cuh, bf16_mma.cuh and stage_common.cuh), put there by
              hand for a before/after check, the fp32 outputs bit for bit
              those of its library, built by nvcc in the same run;
              CUDA-event times of the kernel, the plain
              version and the cuDNN route of the stage at teacher_relu,
              student_relu, cg_teacher_relu and cg_student_relu, cuDNN's convolution backward of the two
              backward kernels' convolution parts (a partial yardstick),
              and the device time of each launch of one call of each
              (torch.profiler; a split that misses a launch is profiled
              again);
  4. main     the pix2pix GCC cooperative iteration (train_step + arch_step)
              at full width: resnet backbone with fused blocks, 256 px,
              teacher ngf 64 / ndf 128, the pruned student
              [24, 48, 112] + [72, 112] * 9 + [48, 24], batch 4; 1 warm-up and
              3 timed iterations and one generate, with the kernels' launch
              counters checked against the engine's structure, and one
              profiled iteration: device time by group and by B1/B2 kernel;
  5. agree    fused against unfused engines (kernels vs cuDNN path) from the
              same weights on the same batches at a small width;
  6. attention each flash-attention kernel (B1-fwd, and B1-bwd: dq, dk and
              dv in one pass) against its plain PyTorch version at the SAGAN
              main path's teacher (B 64, N 1024, dq 8, dv 64) and student
              (dq 2, dv 16) shapes, a ragged case (B 2, N 1000, dq 25,
              dv 200), a many-tile case (B 2, N 4096, dq 8, dv 64), a
              wide-logit case (q, k at scale 2, max |S| ~ 80), SAGAN D's
              attn2 at threshold 16 (B 64, N 16, dq 64, dv 512), a wide q
              (B 4, N 1024, dq 320, dv 320) and a long N (B 1, N 16384,
              dq 8, dv 64); the backward also on the kernel forward's own
              lse and O; that two forward and two backward calls give the
              same bits; where chip_ab/b1_parent/ holds an earlier
              commit's flash_attention.cu (and tf32_mma.cuh), put there by
              hand for a before/after check, outputs bit for bit those of
              its library, built by nvcc in the same run; the backward's
              dq scratch in bytes; CUDA-event times of the kernel and the
              plain version (and, at the main path's shapes,
              F.scaled_dot_product_attention(scale=1) pinned to each
              backend that takes dq != dv, timed in turns with the
              kernels, its backward alone on one kept forward: the fastest
              backend is the library time), forward and backward; then N
              65536 (B 1, dq 8, dv 64) on the kernels alone: finite
              outputs, and the peak device memory above the inputs and
              outputs;
  7. sagan    the SAGAN GCC cooperative iteration (train_step + arch_step) at
              full width (scripts/sagan/train.sh): 64 px, batch 64, z_dim
              128, teacher ngf/ndf 64, the pruned student [69, 34, 17, 16]
              with ndf 64; 1 warm-up and 3 timed iterations and one
              generate, with exactly 6/2 B1 launches per iteration (the
              generators' attn2 at N = 1024: three teacher and three student
              forwards, two backwards);
  8. agree    the kernel route of attention against the einsum route
              (pallas_attn_threshold 1024, and 16, which sends D's attn1 and
              attn2 and G's attn1 through the kernels too, vs 2^30) from the
              same weights on the same batches at a small width, gamma
              non-zero;
  9. unet     the default pix2pix path, the U-Net GCC cooperative iteration
              at full width (the shapes of bench.py:170-186): 256 px, 8
              downs, teacher ngf 64 / ndf 128, the student UnetGenerator(32)
              pruned to 3.0 GMACs by the port's prune_unet from the bench's
              spread weights, ndf 128, online distillation, DARTS, hinge,
              dropout on; 1 warm-up and 3 timed iterations, no B1 or B2
              launch, and one profiled iteration;
 10. agree    the U-Net engine on the card against the same engine on the
              CPU, same weights and batches, no dropout, tiny widths,
              3 iterations;
 11. cli      the training run through python -m gcc_tpu_torch.cli.train
              and .test, in this process, on synthetic data (8 images,
              batch 4, one epoch each, a temporary --checkpoints_dir):
              (a) the U-Net workflow of scripts/pix2pix/*.sh at 256 px
              (stage 1 --lambda_scale 1e-2 --ngf 32 --ndf 128; stage 2
              pruned to 3.0 GMACs on startup with online distillation and
              DARTS; stage 3 the test CLI), (b) stage 1 and 2 with the
              resnet backbone and fused blocks (B2 108/36/36 per
              iteration), (c) SAGAN with scripts/sagan/*.sh's flags at
              64 px, batch 64, 128 images (B1 6/2 per iteration), (d)
              --continue_train of (a)'s stage 2 for epoch 2, (e) the test
              CLI on (a)'s final checkpoint on the card and on the CPU
              (--gpu_ids -1): the same pixel-FID within 1e-4 relative, (f)
              scripts/cyclegan/*.sh on synthetic unaligned data at 256 px,
              batch 1, 4 images (stage 1 --lambda_weight 1e-3 --ngf 48 --ndf 64;
              stage 2 --ngf 24 on the reference's cfgs, as the script's
              horse2zebra root takes them, online distillation, DARTS,
              fused blocks with B2 by the structure each iteration; stage 3
              the test CLI over 32 images on the card and on the CPU: the
              same pixel-FID per direction within 1e-4 relative), (g)
              scripts/srgan/*.sh at
              96 px, batch 16 (a --generator_only teacher at ngf 64, stage 1
              --generator_only --ngf 24 --lambda_scale 1e-2, stage 2 pruned
              to 0.20 GMACs on startup with the teacher from
              --teacher_initial_path, no B1 or B2; stage 3 the test CLI on
              the card and on the CPU: the same PSNR and SSIM within 1e-4),
              (h) the evaluators through the CLIs: convert --evaluator
              inception and drn on seeded random .pth files laid out as the
              reference's (the TF-FID fc head, DRN's 'module.' prefixes and
              up kernel), get_real_stat on an aligned root of 8 + 8 images
              at 256 px, a U-Net epoch (ngf 32, ndf 128) whose eval logs the
              real FID and no [proxy], the test CLI's FID on the card and
              on the CPU within 1e-4, and the test CLI's cityscapes mIoU
              (DRN-D-105, labels at 1024x2048).
              Where a two-iteration stage 1 cannot be pruned to its
              budget, its checkpoint is rewritten from phase 9's spread
              weights, and the phase says so. Per stage: wall seconds, ms
              per iteration through the CLI and inside the engine step
              (host clock, each step ended by a synchronize), launches,
              pruned cfgs and GMACs, and the metric.
 12. cyclegan the CycleGAN GCC cooperative iteration (train_step + arch_step)
              at full width (scripts/cyclegan/train.sh): 256 px, batch 1,
              lsgan, pools of 50, teacher ngf 64 / ndf 64, the students of
              cyclegan_reference_cfgs() (ngf 24), ndf 64 masked, online
              distillation, DARTS, content 0.01, gram 10, fused blocks; 1
              warm-up and 3 timed iterations and one generate per direction,
              B2 launches checked against the structure (288/216/216 an
              iteration: 16 generator forwards of 18 stages, 12 of them with
              a gradient), and one profiled iteration;
 13. agree    CycleGAN at 80 px (blocks at 20 px, the fused gate open),
              batch 1, small widths, lambda_weight 1e-3, from the same
              weights on the same batches: (a) fused (kernels) against
              unfused (cuDNN) engines, pools of 1, 2 iterations; (b) the card
              against the CPU, pools at 0, 3 iterations; losses within
              1e-4 + 2e-3|t| (the arch keys, which read the teachers after
              their update, within 3e-2), the parameters by the classes of
              tests/test_cooperative_parity_cyclegan.py and the masked D's
              running stats by the same walk (each class's largest max|d|
              and mean|d| printed); from the same variables, both
              directions' generate and both D's train-mode forward (output
              and the running stats it writes) within 1e-5;
 14. srgan    the SRGAN GCC cooperative iteration at full width
              (scripts/srgan/train.sh): 96 px from 24 px, batch 16, vanilla
              GAN, teacher ngf 64 / ndf 64, the student pruned by the port's
              prune_srresnet(mode="scale") to 0.20 GMACs from spread
              weights, ndf 64 masked, online distillation, DARTS, content
              0.1, gram 0.1, the VGG19 perceptual term on seeded random
              weights (not the pretrained ones); 1 warm-up and 3 timed
              iterations, no B1 or B2 launch, one profiled iteration;
 15. evaluators InceptionV3 (FID) and DRN-D-105 (mIoU) on seeded random
              weights (NOT the pretrained ones), fp32 with TF32 off: (a)
              500 images of 256² through InceptionExtractor in batches of
              50 (images/s, ms per batch, peak memory, one batch's device
              time by group; card vs CPU on 4 images within 1e-4), (b) the
              FID of two sets of 100 from the
              card's and from the CPU's activations (within 1e-4) and the
              host's sqrtm time, (c) DRN-D-105 at 1024x2048, batch 1, 10
              images against its fp32 bound (its convolutions' flops at 67
              TFLOP/s) with peak memory and one image's device time by
              group, (d) DRN card vs CPU at 256x512
              (logits within 1e-4, argmax agreement), (e) compute_miou on 4
              fakes against 1024x2048 labels of a written cityscapes-like
              root (the histogram counts the labels' pixels), (g) (a)'s and
              (c)'s forwards with TF32 on, as a finding.
 16. pipeline the input pipeline on the card (seeded synthetic images at the
              datasets' shapes and counts; no real dataset is in the
              repository): (a) 2975 AB pairs of 512x256 (cityscapes' train
              split; 128 distinct images, every file decoded on its own)
              written by the port's PNG writer and packed by
              python -m gcc_tpu_torch.cli.prepare at load 256 (seconds; the
              store must be 2975*2*256*256*3 bytes); (b) maps' flags (load
              286, crop 256, flips) on 512 pairs: the device cache's uint8
              crops equal PackedDataset's, its float32 within 1 ulp, the
              paths equal, over 8 batches of 128 (two epochs), ms a batch of
              each path; (c) cli.train --memory_guard strict for one epoch of
              20 iterations from three sources (--device_cache on, the packed
              root streaming, the image folder): pix2pix resnet with fused
              blocks (phase 4's teacher 64/128, the student ngf 24 unpruned,
              ndf 128, batch 4; B2 108/36/36 every step call, the guard's
              included) on (a)'s root, SAGAN at batch 64 (B1 6/2) on 1280
              218x178 images packed as sa; ms a CLI iteration, the engine
              step, the loader's wait; (d) the guard's projected peak within
              5 % of max_memory_allocated over the real first step at phase
              9's U-Net (batch 128) and phase 12's CycleGAN (batch 1), and
              strict's MemoryGuardError with a suggested batch at U-Net batch
              512; (e) the native engine (g++): its items within one uint8
              level of the numpy path's, images/s of each through the
              Loader's 8 threads over one batch of 128 pairs.
 17. bf16     the JAX package's default --compute_dtype bfloat16: (a) the
              three bf16 stage kernels (B2-fwd, -bwd-pw, -bwd-dw in bf16)
              against their bf16 plain versions at the teacher stage (B 4,
              C = M = 256, 64x64) and CycleGAN's batch-1 teacher stage, each
              with relu and with a residual: bf16 outputs within 2 bf16 ulps
              of their largest value and at most 1 % of elements apart,
              fp32 weight gradients within 1e-3 of their largest value,
              two calls the same bits; CUDA-event times of the kernel, the
              plain version and cuDNN's bf16 route, bounds at 3.35 TB/s and
              989 TFLOP/s, the device time by launch (the depthwise backward
              one launch up to a batch of 8), cuDNN's bf16 depthwise
              convolution backward as its partial yardstick; nvcc -Xptxas
              -v of mobile_block_bf16.cu; with chip_ab/b2_parent/'s two
              libraries, the depthwise backward's dx bit for bit theirs at
              every shape (and dW_dw, the batch being at most 8), and
              their three bf16 entry points timed in turns with the new
              ones (medians of three rounds of 20): event ms, device ms
              (its launches summed), the host's us a call over 200 enqueued
              calls, the bound with and without the saved tensors; (b) phase 9's U-Net
              iteration on bf16 batches (no B1 or B2 launch); (c) phase 4's
              pix2pix resnet fused iteration on bf16 batches, B2 108/36/36
              bf16 launches an iteration, generate in fp32 (18 fp32 stage
              forwards); (d) tests/test_torch_bf16.py's two configurations
              at learning rate 0, one iteration on the card in bf16 against
              the CPU in bf16 and the CPU in fp32: rms(card - CPU bf16) /
              rms(CPU bf16 - CPU fp32) of the losses, the gradients (Adam's
              first moments) and the running statistics at most 1/4; (e)
              one cli.train epoch of the U-Net with default flags, which
              logs that it computes in bfloat16.
 18. bf16 families SAGAN, CycleGAN and SRGAN in bf16: (a) nvcc -Xptxas -v
              of flash_attention_bf16.cu (registers, spills), then B1's
              bf16 entry points (flash_attention_bf16.cu's kernels, or
              flash_attention.cu's streaming ones for wide shapes: the
              route and the tiles' shared memory printed for each shape)
              against their bf16 plain versions at phase 6's
              shapes: O, dq, dk and dv within flash_attention.BF16_ULPS of
              their largest plain value and at most BF16_SHARE of
              elements apart (an output farther than that from its plain
              version held to the float64 answer: no farther from it than
              the plain version, flash_attention.bf16_share_ok), lse
              within 1e-5, the
              backward also on the kernel forward's own O and lse, two calls
              the same bits; CUDA-event times of the kernel and the plain
              version, SDPA on bf16 tensors at the main path's shapes as
              in phase 6, bounds with 2-byte operands, the function's
              flops at 989 TFLOP/s and its exps at 16 a clock an SM at
              the card's maximum SM clock, whatever kernel runs, and,
              for information, the bound of the mma the kernel issues
              (attn_bounds); (b) phase 7's SAGAN iteration on bf16 batches, 6/2
              bf16 B1 launches an iteration and no fp32 one, generate in
              fp32; (c) phase 12's CycleGAN iteration on bf16 batches,
              288/216/216 bf16 B2 launches an iteration; (d) phase 14's
              SRGAN iteration on bf16 batches; (e) the tiny configurations
              of tests/test_torch_bf16_{sagan,cyclegan,srgan}.py, one
              iteration at learning rate 0 on the card in bf16 against the
              CPU in bf16 and in fp32, as phase 17 (d); (f) one cli.train
              epoch of SAGAN with default flags, which logs bfloat16 and
              launches only B1's bf16 entry points.
 19. serve    the serving export (utils/serve_export.py, cli.export): (a)
              phase 9's pruned U-Net student (the engine's seeded init
              weights: phase 9's spread weights put every output pixel at
              +-1, which the phase prints) written as a checkpoint and
              exported by the CLI in this process in fp32, bf16 and bf16
              with int8 weights (the CLI checks fp32 on cpu and cuda, the
              others on cuda):
              export seconds, MB, the symbolic batch served at 1, 3 and 8,
              the artifact against engine.generate in its dtype (fp32 within
              1e-5 under exact_fp32; bf16 no farther from the fp32 generate,
              in rms, than twice the bf16 generate; int8 >= 45 dB against
              the bf16 generate), images/s at batch 1 and 8 of the artifact
              and of generate (CUDA events); (b) phase 4's fused resnet
              student and phase 12's CycleGAN (both directions), (c) phase
              7's SAGAN student (gammas non-zero) and phase 14's SRGAN
              student: export_generator in fp32 and bf16 against generate
              (fp32 within 1e-3 where generate runs B2 or B1, phases 5's and
              8's bound, else 1e-5; bf16 by (a)'s rule), B2's or B1's
              forward launched by generate and nothing by the artifact, ms
              at batch 1 each way; (d) a U-Net artifact run on the
              card by a fresh python -I process that cannot import
              gcc_tpu_torch (the int8 one), and one traced on the
              CPU by the CLI
              (--gpu_ids -1) moved to the card by load_exported, each within
              1e-5 of the artifact traced on the card.
 20. dp       data-parallel training (parallel/mesh.py): (a) phase 17
              (c)'s pix2pix resnet iteration in bf16 through the DP path at
              W = 1 on NCCL, in turns with the engine without a mesh on the
              same batches: ms an iteration each way and the DP path's
              overhead, the bytes and calls it all-reduces an iteration,
              B2's bf16 launches (108/36/36 an iteration, either way), the
              first iteration's losses within 1e-2 relative; (b) 2 Gloo
              ranks on the one card (NCCL refuses two ranks on one card)
              against 1 process at the same global batch, 2 iterations of
              SAGAN (B1 at N 1024) and of CycleGAN at 80 px (B2, replay
              pools of 4): tests/test_torch_parallel.py's bounds and the
              first update's gradients within 1e-4 rms relative, each at its
              bound or at twice the card's floor where that is above it
              (the 1-process run again, by the plain route and, SAGAN, on
              its rows reversed or rolled, against the first), the ranks'
              states bit for bit equal, B1 or B2
              launched by every kernel run and by none of the plain ones.
 21. spatial  row-sharded eval (parallel/spatial.py), fp32, TF32 off: (a)
              SRResNet x4 (64 channels, 16 blocks) on 256x256 and on
              512x512 LR images (1024^2 and 2048^2 out), the pix2pix resnet
              teacher (ngf 64, 9 blocks, fused blocks on) at 512x1024, the
              U-Net teacher (ngf 64, 8 downs: 256 -> 1 row) at 256^2 and
              CycleGAN's BtoA student (the reference cfgs) at 256^2, on
              seeded weights with spread BatchNorm statistics, each sharded
              over 2 and over 4 Gloo ranks on the one card against the
              unsharded forward of the same weights on the card: max
              |difference| within 1e-4, or twice the float64 floor where
              that is larger (the ratio printed), the fused generate within
              1e-3, the ranks' outputs bit for bit equal, no B2 launch under
              the view (the unsharded fused generate's count beside it),
              each rank's peak device memory against the unsharded run's,
              ms per image either way, halo, statistic and gather bytes and
              calls per image; (b) orchestrators._collect with
              --spatial_shards 2 over 2 ranks against 1 process: the same
              images within 1e-4.
 22. batch_norm  train-mode BatchNorm in bf16 (ops/batch_norm.py,
              csrc/batch_norm_bf16.cu) at the U-Net teacher's up_norm_1
              (128 x 64 x 128^2) and the PatchGAN's norm_3 at ndf 128 (128 x
              1024 x 31^2): y, dx, the statistics and dw, db against the
              plain versions within ops/batch_norm.py's bounds, two calls
              bit for bit, CUDA-event times of the forward and the backward
              against 6 and 10 bytes an element at 3.35 TB/s, the device
              time of each launch, and the former fp32 chain (the plain
              forward under autograd) and F.batch_norm timed beside them.
Phases 1-16 run fp32 (phases 7, 8, 12 and 14 on fp32 batches; phases 11 and
16 pass --compute_dtype float32): TF32 is off for cuDNN and matmul, except
in phase 15 (g). The last twelve lines are phase 11's JSON record of its
stages, phase 15's, phase 16's, phase 17's, phase 18's, phase 19's, phase
20's, phase 21's, phase 22's, the card's name and power limit, the kernels' JSON record
and {"ok": true, "device": ...}. A
kernel's "launches" is the main path's count (phase 4 for B2, phase 7 for
B1, phase 17 (c) for B2's bf16 entry points, phase 18 (b) for B1's);
"launches_by_path" adds phase 12's for B2, phase 16 (c)'s cached runs and
phase 18 (c)'s for B2 in bf16, and phase 20 (a)'s DP iteration's.
"""

import ast
import concurrent.futures
import ctypes
import functools
import hashlib
import json
import math
import multiprocessing
import os
import subprocess
import sys
import time

TEACHER_CASES = [("teacher_relu", 4, 256, 256, 64, True, False),
                 ("teacher_res", 4, 256, 256, 64, False, True)]
STUDENT_CASES = [("student_relu", 4, 112, 72, 64, True, False),
                 ("student_res", 4, 72, 112, 64, False, True)]
STUDENT_CFG = [24, 48, 112] + [72, 112] * 9 + [48, 24]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12  # fp32 outside the tensor cores, H100 SXM at 700 W
TF32_FLOPS = 495e12  # TF32 tensor cores, dense
# split-TF32: three TF32 tensor-core products per product
TF32X3_FLOPS = TF32_FLOPS / 3
BF16_FLOPS = 989e12  # bf16 tensor cores, dense, fp32 accumulation
# the special-function units' exps (ex2) a clock on each SM of a Hopper card
EXP_PER_CLK_SM = 16
# the SDPA backends, pinned one at a time (one that refuses q and k of
# another width than v is skipped)
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH")
# where a before/after check puts an earlier commit's source by hand: B1's
# flash_attention.cu and tf32_mma.cuh; B2's mobile_block.cu,
# mobile_block_bf16.cu and the three headers
B1_PARENT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "chip_ab", "b1_parent")
B2_PARENT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "chip_ab", "b2_parent")
# the argtypes of the earlier B2 sources' bf16 entry points: the forward and
# the pointwise backward in its mobile_block_bf16.cu, the depthwise backward
# in its mobile_block.cu (with per-plane partials: B x C x 9 floats)
_VP, _VI = ctypes.c_void_p, ctypes.c_int
B2_PARENT_BF16 = {"gcc_stage_fwd_bf16": [_VP] * 9 + [_VI] * 7 + [_VP],
                  "gcc_stage_bwd_pw_bf16_partials": [_VI] * 6,
                  "gcc_stage_bwd_pw_bf16": [_VP] * 9 + [_VI] * 7 + [_VP]}
B2_PARENT_DW_BF16 = {"gcc_stage_bwd_dw_bf16": [_VP] * 8 + [_VI] * 4 + [_VP]}
PER_ITER = {"stage_fwd": 108, "stage_bwd_pw": 36, "stage_bwd_dw": 36}
TPU_KERNEL = {"stage_fwd": "gcc_tpu/ops/pallas/mobile_block.py:155",
              "stage_bwd_pw": "gcc_tpu/ops/pallas/mobile_block.py:187",
              "stage_bwd_dw": "gcc_tpu/ops/pallas/mobile_block.py:220",
              "stage_fwd_bf16": "gcc_tpu/ops/pallas/mobile_block.py:155",
              "stage_bwd_pw_bf16": "gcc_tpu/ops/pallas/mobile_block.py:187",
              "stage_bwd_dw_bf16": "gcc_tpu/ops/pallas/mobile_block.py:220",
              "attn_fwd": "gcc_tpu/ops/pallas/attention.py:44",
              "attn_bwd": "gcc_tpu/ops/pallas/attention.py:81, "
                          "gcc_tpu/ops/pallas/attention.py:110"}
# (case, B, N, dq, dv, scale of q and k): the main path's teacher and student
# attn2, then shapes that exercise the ragged key tile and wide features, many
# tiles, and wide logits (max |S| ~ 80), where an error in S weighs most
ATTN_CASES = [("teacher", 64, 1024, 8, 64, 0.5),
              ("student", 64, 1024, 2, 16, 0.5),
              ("ragged", 2, 1000, 25, 200, 0.5),
              ("many_tile", 2, 4096, 8, 64, 0.5),
              ("wide_logit", 16, 1024, 8, 64, 2.0),
              ("d_attn2_wide", 64, 16, 64, 512, 0.5),
              ("wide_q", 4, 1024, 320, 320, 0.5),
              ("long_n", 1, 16384, 8, 64, 0.5)]
# timed beside the main path's shapes: the widths and the length that the
# backward's wide kernel and its grouped dq partials serve
TIMED_WIDE = ("d_attn2_wide", "wide_q", "long_n")
ATTN_PER_ITER = {"attn_fwd": 6, "attn_bwd": 2}
# the student of scripts/sagan/train.sh (ngf 48) pruned to 0.016 GMACs
SAGAN_STUDENT_CFG = [69, 34, 17, 16]
UNET_BATCH = 128  # bench.py's
# CycleGAN's stage shapes at batch 1 (scripts/cyclegan/train.sh, 256 px):
# the teacher's (ngf 64), and block 8 of cfg_BtoA in cyclegan_reference_cfgs
# (96 -> 81 -> 96)
CYCLEGAN_CASES = [("cg_teacher_relu", 1, 256, 256, 64, True, False),
                  ("cg_teacher_res", 1, 256, 256, 64, False, True),
                  ("cg_student_relu", 1, 96, 81, 64, True, False),
                  ("cg_student_res", 1, 81, 96, 64, False, True)]
TIMED_CASES = ("teacher_relu", "student_relu", "cg_teacher_relu",
               "cg_student_relu")
# scripts/cyclegan/train.sh: 256 px, batch 1; teacher ngf 64 / ndf 64, the
# student ngf 24 with the reference's cfgs, its D ndf 64 masked
CYCLEGAN_SIZE = 256
CYCLEGAN_WIDTHS = dict(ngf=24, ndf=64, teacher_ngf=64, teacher_ndf=64)
# phase 13's crop: the blocks at 20 px, where the fused gate opens
CYCLEGAN_AGREE_SIZE = 80
# scripts/srgan/train.sh: 96 px from 24 px (x4), batch 16; teacher 64 / 64,
# the student ngf 24 pruned to 0.20 GMACs, its D ndf 64 masked
SRGAN_HR, SRGAN_BATCH, SRGAN_BUDGET = 96, 16, 0.20
SRGAN_WIDTHS = dict(ngf=24, ndf=64, teacher_ngf=64, teacher_ndf=64)
N_TIMED = 3  # timed iterations of phases 12 and 14, after one warm-up
# phase 15: InceptionV3 over FID_IMAGES images of FID_SIZE² in batches of
# FID_BATCH (fid_score.py's 50); (b)'s two sets of FID_SET images each on
# the card and on the CPU; DRN-D-105 at the cityscapes protocol's 1024x2048
# (DRN_TIMED images), card vs CPU at DRN_AGREE, compute_miou on
# MIOU_IMAGES fakes
FID_IMAGES, FID_BATCH, FID_SIZE, FID_SET = 500, 50, 256, 100
DRN_FULL, DRN_TIMED, DRN_AGREE, MIOU_IMAGES = (1024, 2048), 10, (256, 512), 4
# the arch keys read the teachers after their update in the same
# iteration: tests/test_cooperative_parity_cyclegan.py's chaotic class
CYCLEGAN_CHAOTIC = {"D_arch_A", "D_arch_B", "D_arch_diff_A", "D_arch_diff_B",
                    "teacher_netD_A_arch_diff", "teacher_netD_B_arch_diff"}


def fail(msg):
    raise RuntimeError(msg)


def cuda_ms(torch, fn, n=20, warmup=3):
    """Mean CUDA-event time of fn over n calls, after warmup calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def bound_ms(nbytes, *work):
    """Least time in ms for nbytes of device memory traffic and the work
    given as (flops, peak of the units that do them) pairs: the largest of
    the bytes' time and each unit's time (the units run side by side), and
    which of bytes or operations sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(flops / peak for flops, peak in work)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def stage_bounds(B, C, M, HW, relu, res, act=4, mma=TF32X3_FLOPS):
    """Least time for each wrapper's work at one shape: its inputs read once,
    outputs written once (activations of act bytes: 4 in fp32, 2 in bf16;
    weights and their gradients fp32); its flops at the peak of the units
    they run on: the pointwise products (forward b, backward d a-hat and dW)
    on the tensor cores at mma (split-TF32 in fp32, bf16 in bf16),
    everything else on the fp32 CUDA cores. The
    bytes are those of the TPU kernel's function (forward: x in, y out;
    backward: x and the upstream gradient in, the gradients out): what the
    port also saves in the forward and reads back in the backward is not the
    function's work. Printed beside them: "*_saved", the bounds with those
    tensors (a-hat, b-hat, 1/std of a and b) counted, and "*_fp32", with
    every flop on the fp32 cores."""
    act_c, act_m = B * C * HW, B * M * HW
    # inputs x, dwk, pwk, residual; output y
    fwd_bytes = (act * (act_c + (act_m if res else 0) + act_m)
                 + 4 * (9 * C + M * C))
    saved_bytes = act * (act_c + act_m) + 4 * (B * C + B * M)
    gemm = 2 * act_m * C
    rest = 18 * act_c + 5 * (act_c + act_m) + (act_m if relu or res else 0)
    # backward, pointwise side: inputs x, dwk, pwk, g; outputs d a-hat, d pwk;
    # the port reads g, a-hat, b-hat, 1/std of b and pwk
    pw_bytes = act * (act_c + act_m + act_c) + 4 * (9 * C + 2 * M * C)
    pw_saved = act * (2 * act_m + 2 * act_c) + 4 * (B * M + 2 * M * C)
    pw_prod, pw_rest = 4 * act_m * C, 6 * act_m
    # backward, depthwise side: inputs x, dwk, d a-hat; outputs dx, d dwk;
    # the port also reads a-hat and 1/std of a
    dw_bytes = act * 3 * act_c + 4 * 18 * C
    dw_work = (42 * act_c, FP32_FLOPS)
    return {"stage_fwd": bound_ms(fwd_bytes, (gemm, mma), (rest, FP32_FLOPS)),
            "stage_fwd_saved": bound_ms(fwd_bytes + saved_bytes, (gemm, mma),
                                        (rest, FP32_FLOPS)),
            "stage_fwd_fp32": bound_ms(fwd_bytes, (gemm + rest, FP32_FLOPS)),
            "stage_bwd_pw": bound_ms(pw_bytes, (pw_prod, mma),
                                     (pw_rest, FP32_FLOPS)),
            "stage_bwd_pw_saved": bound_ms(pw_saved, (pw_prod, mma),
                                           (pw_rest, FP32_FLOPS)),
            "stage_bwd_pw_fp32": bound_ms(pw_bytes,
                                          (pw_prod + pw_rest, FP32_FLOPS)),
            "stage_bwd_dw": bound_ms(dw_bytes, dw_work),
            "stage_bwd_dw_saved": bound_ms(
                dw_bytes + act * act_c + 4 * B * C, dw_work)}


def short_name(kernel):
    """A kernel's name without its namespace, return type and arguments."""
    return kernel.replace("(anonymous namespace)::", "").replace(
        "void ", "").split("(")[0]


def launch_split(torch, fn, n=20, launches=1, tries=3):
    """Device time per call (ms) of each kernel that fn launches, by kernel
    name, from torch.profiler over n calls after one warm-up call. Now and
    then the profiler records no kernel for a call, or drops one of its
    launches; a split with fewer than ``launches`` kernels, or with a kernel
    seen a number of times that is not a multiple of n, is reported and
    profiled again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0]
        split = {short_name(e.key): e.self_device_time_total / n / 1e3
                 for e in events}
        counts = {short_name(e.key): e.count for e in events}
        if len(split) >= launches and all(c % n == 0
                                          for c in counts.values()):
            return split
        print(f"    the profiler recorded {len(split)} of {launches} "
              f"kernels over {n} calls ({counts}); profiling again")
    return split


def device_ms(split):
    """A call's device time: its launches' times summed."""
    return sum(split.values())


def print_split(what, split):
    print(f"    one {what} by launch (profiler): device {device_ms(split):.4f}"
          f" ms, " + ", ".join(f"{name} {ms:.4f} ms" for name, ms in
                               sorted(split.items(), key=lambda kv: -kv[1])))


def max_err(a, b):
    return float((a - b).detach().abs().max())


def check_close(name, got, ref, atol):
    err = max_err(got, ref)
    print(f"    {name:<22} max|d| {err:.3e}  tol {atol:.3e}")
    if not err <= atol:
        fail(f"{name}: max |delta| {err} exceeds {atol}")
    return err


# kernels a call of each B2 entry point launches: fp32, and bf16 with the
# backwards' ordered weight-gradient sums (one fewer where the pointwise dW
# takes one run, or where the depthwise dW is summed in a cluster: B <= 8)
B2_LAUNCHES = {"stage_fwd": 3, "stage_bwd_pw": 4, "stage_bwd_dw": 2,
               "stage_fwd_bf16": 3, "stage_bwd_pw_bf16": 3,
               "stage_bwd_dw_bf16": 2}


def b2_same_as_parent(torch, lib, case, fwd_in, fwd, pw_in, pw, dw_in, dw):
    """fp32 B2's outputs against the earlier library's on the same inputs:
    the forward's (y, a-hat, b-hat, both 1/std) on (x, dwk, pwk, residual,
    relu), the pointwise backward's (d a-hat, dW_pw) on (g, a-hat, b-hat,
    1/std of b), the depthwise backward's (dx, dW_dw) on (d a-hat, a-hat,
    1/std of a): the same bits, or fail."""
    x, dwk, pwk, res, relu = fwd_in
    g, ahat, bhat, rstd_b = pw_in
    gah, _, rstd_a = dw_in
    (B, C, H, W), M, dev = x.shape, pwk.shape[0], x.device
    p = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    st = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    outs = [torch.empty_like(fwd[0]), torch.empty_like(x),
            torch.empty_like(fwd[0]), torch.empty(B, C, device=dev),
            torch.empty(B, M, device=dev), torch.empty_like(x),
            torch.empty_like(pwk), torch.empty_like(x),
            torch.empty_like(dwk)]
    gb = torch.empty_like(g)
    part = torch.empty(lib.gcc_stage_bwd_pw_partials(B, C, M, H, W, sms), M,
                       C, device=dev)
    gdw_part = torch.empty(B, C, 9, device=dev)
    errs = (lib.gcc_stage_fwd(p(x), p(dwk), p(pwk), p(res), *map(p, outs[:5]),
                              B, C, M, H, W, int(relu), st),
            lib.gcc_stage_bwd_pw(p(g), p(ahat), p(bhat), p(rstd_b), p(pwk),
                                 p(gb), p(outs[5]), p(part), p(outs[6]), B,
                                 C, M, H, W, int(relu), sms, st),
            lib.gcc_stage_bwd_dw(p(gah), p(ahat), p(rstd_a), p(x), p(dwk),
                                 p(outs[7]), p(gdw_part), p(outs[8]), B, C,
                                 H, W, st))
    if any(errs):
        fail(f"{case}: the earlier B2 library's launch failed: {errs}")
    same = [torch.equal(a, b) for a, b in zip((*fwd, *pw, *dw), outs)]
    print(f"    bit for bit with the earlier source (y, a-hat, b-hat, 1/std "
          f"a, 1/std b, d a-hat, dW_pw, dx, dW_dw): {same}")
    if not all(same):
        fail(f"{case}: fp32 B2 differs from the earlier source: {same}")


def phase_kernels(torch, F, parent=None):
    from gcc_tpu_torch.ops import mobile_block as mb

    print("== phase 3: kernels against their plain versions (fp32, TF32 off)")
    record = {k: {"max_abs_err": 0.0} for k in PER_ITER}
    gen = torch.Generator().manual_seed(0)
    for case, B, C, M, S, relu, has_res in (TEACHER_CASES + STUDENT_CASES
                                            + CYCLEGAN_CASES):
        print(f"  {case}: B={B} C={C} M={M} {S}x{S} relu={relu} res={has_res}")

        def rnd(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen) * scale).cuda()

        x = rnd(B, C, S, S)
        dwk = rnd(C, 1, 3, 3, scale=0.2)
        pwk = rnd(M, C, 1, 1, scale=0.2)
        res = rnd(B, M, S, S) if has_res else None
        g = rnd(B, M, S, S)

        # B2-fwd
        out_k = mb.stage_fwd(x, dwk, pwk, res, relu)
        out_p = mb.stage_fwd_plain(x, dwk, pwk, res, relu)
        errs = [check_close(f"fwd {n}", a, b, 1e-4) for n, a, b in
                zip(("y", "a-hat", "b-hat"), out_k[:3], out_p[:3])]
        record["stage_fwd"]["max_abs_err"] = max(
            record["stage_fwd"]["max_abs_err"], *errs)
        # the kernels take contiguous tensors; einsum may return others
        ahat, bhat, rstd_a, rstd_b = (t.contiguous() for t in out_p[1:])
        # B2-bwd-pw, on the plain forward's saved tensors
        pw_k = mb.stage_bwd_pw(g, ahat, bhat, rstd_b, pwk, relu)
        pw_p = mb.stage_bwd_pw_plain(g, ahat, bhat, rstd_b, pwk, relu)
        errs = [check_close(f"bwd_pw {n}", a, b,
                            1e-4 * max(float(b.abs().max()), 1.0))
                for n, a, b in zip(("d a-hat", "dW_pw"), pw_k, pw_p)]
        record["stage_bwd_pw"]["max_abs_err"] = max(
            record["stage_bwd_pw"]["max_abs_err"], *errs)
        gah = pw_p[0].contiguous()
        # B2-bwd-dw
        dw_k = mb.stage_bwd_dw(gah, ahat, rstd_a, x, dwk)
        dw_p = mb.stage_bwd_dw_plain(gah, ahat, rstd_a, x, dwk)
        errs = [check_close(f"bwd_dw {n}", a, b,
                            1e-4 * max(float(b.abs().max()), 1.0))
                for n, a, b in zip(("dx", "dW_dw"), dw_k, dw_p)]
        record["stage_bwd_dw"]["max_abs_err"] = max(
            record["stage_bwd_dw"]["max_abs_err"], *errs)
        if parent is not None:
            b2_same_as_parent(torch, parent, case, (x, dwk, pwk, res, relu),
                              out_k, (g, ahat, bhat, rstd_b), pw_k,
                              (gah, ahat, rstd_a), dw_k)
        # no float atomics: a second call of each backward gives the same bits
        for name, first, again in (
                ("stage_bwd_pw", pw_k,
                 mb.stage_bwd_pw(g, ahat, bhat, rstd_b, pwk, relu)),
                ("stage_bwd_dw", dw_k,
                 mb.stage_bwd_dw(gah, ahat, rstd_a, x, dwk))):
            if not all(torch.equal(a, b) for a, b in zip(first, again)):
                fail(f"{case}: two {name} calls differ")

        # the differentiable stage against autograd through the reference.
        # relu's derivative jumps at b-hat = 0, and two forwards inside their
        # bound may put a pixel with |b-hat| < 1e-4 on opposite sides of it:
        # there the two gradients differ by O(|g|) whichever is right. So
        # the reference takes relu's mask from the kernel's b-hat (the
        # forward repeats bit for bit), and both backwards see one forward;
        # a pixel where the two masks differ must have |b-hat| < 1e-4 in both.
        mask = out_k[2] > 0
        if relu:
            flips = mask != (out_p[2] > 0)
            near = float(torch.maximum(out_k[2].abs(), out_p[2].abs())[flips]
                         .max()) if bool(flips.any()) else 0.0
            print(f"    relu mask: {int(flips.sum())} of {mask.numel()} "
                  f"pixels differ from the plain forward's, max |b-hat| "
                  f"there {near:.3e}")
            if not near < 1e-4:
                fail(f"{case}: relu mask differs at |b-hat| {near}")
        leaves = [t.clone().requires_grad_(True) for t in (x, dwk, pwk)]
        r_leaf = res.clone().requires_grad_(True) if has_res else None
        inputs = leaves + ([r_leaf] if has_res else [])
        y_f = mb.fused_sep_stage(leaves[0], leaves[1], leaves[2], r_leaf, relu)
        grads_f = torch.autograd.grad((y_f * g).sum(), inputs)
        y_r = mb.sep_stage_reference(leaves[0], leaves[1], leaves[2], None,
                                     False)
        y_r = y_r * mask if relu else y_r
        y_r = y_r + r_leaf if has_res else y_r
        grads_r = torch.autograd.grad((y_r * g).sum(), inputs)
        check_close("stage y vs reference", y_f, y_r, 1e-4)
        for n, a, b in zip(("dx", "dW_dw", "dW_pw", "dres"), grads_f, grads_r):
            check_close(f"stage {n} vs reference", a, b,
                        1e-4 * max(float(b.abs().max()), 1.0))

        if case not in TIMED_CASES:
            continue
        # times at the main path's teacher and student stage shapes; the
        # teacher's (the largest) go to the record
        bounds = stage_bounds(B, C, M, S * S, relu, has_res)

        def lib_fwd():
            a = F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), dwk,
                         groups=C)
            y = F.instance_norm(F.conv2d(F.instance_norm(a), pwk))
            return torch.relu(y) if relu else y

        timings = {
            "stage_fwd": (lambda: mb.stage_fwd(x, dwk, pwk, res, relu),
                          lambda: mb.stage_fwd_plain(x, dwk, pwk, res, relu),
                          lib_fwd),
            "stage_bwd_pw": (
                lambda: mb.stage_bwd_pw(g, ahat, bhat, rstd_b, pwk, relu),
                lambda: mb.stage_bwd_pw_plain(g, ahat, bhat, rstd_b, pwk,
                                              relu), None),
            "stage_bwd_dw": (
                lambda: mb.stage_bwd_dw(gah, ahat, rstd_a, x, dwk),
                lambda: mb.stage_bwd_dw_plain(gah, ahat, rstd_a, x, dwk),
                None),
        }
        for k, (kern, plain, lib) in timings.items():
            rec = {"ms": cuda_ms(torch, kern), "plain_ms": cuda_ms(torch, plain),
                   "library_ms": cuda_ms(torch, lib) if lib else None}
            rec["bound_ms"], rec["bound_by"] = bounds[k]
            print(f"    {k:<13} kernel {rec['ms']:.4f} ms  plain "
                  f"{rec['plain_ms']:.4f} ms  library {rec['library_ms']} ms  "
                  f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
            if case == "teacher_relu":
                record[k].update(rec)
        saved_ms, saved_by = bounds["stage_fwd_saved"]
        print(f"    stage_fwd bound with a-hat, b-hat and both 1/std written "
              f"for the backward {saved_ms:.4f} ms ({saved_by}): the cost of "
              f"saving them, over the function's bound above")
        fp32_ms, fp32_by = bounds["stage_fwd_fp32"]
        print(f"    stage_fwd bound with every flop on the fp32 CUDA cores "
              f"{fp32_ms:.4f} ms ({fp32_by}); the stage_fwd line puts the "
              f"pointwise product on the tensor cores in split-TF32")
        for k, saved in (("stage_bwd_pw", "a-hat, b-hat and 1/std of b"),
                         ("stage_bwd_dw", "a-hat and 1/std of a")):
            saved_ms, saved_by = bounds[f"{k}_saved"]
            print(f"    {k} bound with the saved {saved} read in place of x "
                  f"{saved_ms:.4f} ms ({saved_by})")
        fp32_ms, fp32_by = bounds["stage_bwd_pw_fp32"]
        print(f"    stage_bwd_pw bound with every flop on the fp32 CUDA cores "
              f"{fp32_ms:.4f} ms ({fp32_by}); the stage_bwd_pw line puts its "
              f"two products on the tensor cores in split-TF32")
        for k in ("stage_fwd", "stage_bwd_pw", "stage_bwd_dw"):
            split = launch_split(torch, timings[k][0],
                                 launches=B2_LAUNCHES[k])
            print_split(k, split)
            if case == "teacher_relu":
                record[k]["device_ms"] = device_ms(split)

        # cuDNN on the convolution part of each backward kernel alone, from
        # the gradient at the conv's output (IN's backward left out): a
        # partial yardstick, not library_ms
        g_in = torch.where(bhat > 0, g, torch.zeros_like(g)) if relu else g
        gb = mb._inorm_bwd(g_in, bhat, rstd_b).contiguous()
        ga = mb._inorm_bwd(gah, ahat, rstd_a).contiguous()
        xpad = F.pad(x, (1, 1, 1, 1), mode="reflect")
        conv_bwd = torch.ops.aten.convolution_backward
        cudnn_pw = cuda_ms(torch, lambda: conv_bwd(
            gb, ahat, pwk, None, [1, 1], [0, 0], [1, 1], False, [0, 0], 1,
            [True, True, False]))
        cudnn_dw = cuda_ms(torch, lambda: conv_bwd(
            ga, xpad, dwk, None, [1, 1], [0, 0], [1, 1], False, [0, 0], C,
            [True, True, False]))
        print(f"    cuDNN convolution backward alone (partial yardstick): "
              f"1x1 conv from gb (d a-hat, dW) {cudnn_pw:.4f} ms; depthwise "
              f"conv from ga (d x-padded, dW_dw) {cudnn_dw:.4f} ms")

        def cudnn_stage_fwd_bwd():
            xl = x.clone().requires_grad_(True)
            wl = [dwk.clone().requires_grad_(True),
                  pwk.clone().requires_grad_(True)]
            a = F.conv2d(F.pad(xl, (1, 1, 1, 1), mode="reflect"), wl[0],
                         groups=C)
            y = torch.relu(F.instance_norm(F.conv2d(F.instance_norm(a),
                                                    wl[1])))
            torch.autograd.grad((y * g).sum(), [xl] + wl)

        def fused_stage_fwd_bwd():
            xl = x.clone().requires_grad_(True)
            wl = [dwk.clone().requires_grad_(True),
                  pwk.clone().requires_grad_(True)]
            y = mb.fused_sep_stage(xl, wl[0], wl[1], None, True)
            torch.autograd.grad((y * g).sum(), [xl] + wl)

        print(f"    stage fwd+bwd: kernels "
              f"{cuda_ms(torch, fused_stage_fwd_bwd):.4f} ms, cuDNN route "
              f"{cuda_ms(torch, cudnn_stage_fwd_bwd):.4f} ms")
    return record


def main_config(Config, **kw):
    base = dict(model="pix2pix", backbone="resnet", fused_resblock="on",
                gan_mode="hinge", online_distillation=True,
                darts_discriminator=True, lambda_L1=100.0,
                lambda_content=50.0, lambda_gram=1e4, lr=2e-4, arch_lr=1e-4)
    base.update(kw)
    return Config(**base)


def make_batches(torch, np, n, batch, size, seed, device):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        a, b = (torch.from_numpy(rng.rand(batch, 3, size, size).astype(
            np.float32) * 2 - 1).to(device) for _ in range(2))
        out.append({"A": a, "B": b})
    return out


def drive(torch, engine, cfg, batches, gen_in, counters, per_iter, gen_calls,
          name, generate=None, out_size=None, record=None):
    """Run the engine's iteration (train_step + arch_step) once per pair of
    batches, the first pair as warm-up, then one generate on gen_in (or the
    outputs of generate(state)), with the kernels' launch counters set to 0
    just before and read just after. Fails on a non-finite loss, on
    per-iteration launches other than per_iter, on totals other than the
    iterations' plus gen_calls, and on a generated image that is not finite
    or not of gen_in's batch and out_size (crop_size). Returns the
    launches; ``record``, when given, takes the iteration's ms, images/s,
    peak memory and the profile's shares."""
    n, batch = len(batches) // 2, gen_in.shape[0]
    state, times = engine.init_state(seed=0), []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in counters:  # counts from here on are this path's alone
        counters[k] = 0
    for i in range(n):
        before = dict(counters)
        t0 = time.perf_counter()
        state, m = engine.train_arch_step(state, batches[2 * i],
                                          batches[2 * i + 1], cfg.lr,
                                          cfg.ema_beta)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if i > 0:
            times.append(dt)
        losses = {k: float(v) for k, v in m.items()}
        if not all(math.isfinite(v) for v in losses.values()):
            fail(f"iteration {i}: non-finite loss {losses}")
        grown = {k: counters[k] - before[k] for k in counters}
        if grown != {k: per_iter.get(k, 0) for k in counters}:
            fail(f"iteration {i}: kernel calls {grown}, expected {per_iter}")
        print(f"  iter {i}{' (warm-up)' if i == 0 else ''}: {dt * 1e3:.3f} ms "
              f"launches {grown} "
              + " ".join(f"{k}={v:.5g}" for k, v in losses.items()))
    outs = generate(state) if generate else [engine.generate(state, gen_in)]
    torch.cuda.synchronize()
    launches = dict(counters)
    size = out_size or cfg.crop_size
    for out in outs:
        if tuple(out.shape) != (batch, 3, size, size) \
                or not bool(torch.isfinite(out).all()):
            fail(f"generate: shape {tuple(out.shape)} or non-finite values")
    expected = {k: n * per_iter.get(k, 0) + gen_calls.get(k, 0)
                for k in counters}
    if launches != expected:
        fail(f"kernel calls {launches}, expected {expected}")
    ms = 1e3 * sum(times) / len(times)
    print(f"  {name}: {ms:.3f} ms/iteration (min {1e3 * min(times):.3f}, "
          f"max {1e3 * max(times):.3f}), {batch / (ms / 1e3):.3f} images/s "
          f"(mean of {len(times)}), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
          f"launches {launches}")
    shares = profile_iteration(torch, engine, state, batches[0], batches[1],
                               cfg)
    if record is not None:
        record.update({"ms_per_iter": ms, "images_per_s": batch / (ms / 1e3),
                       "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                       **shares})
    return launches


def phase_main(torch, np, record=None):
    from gcc_tpu_torch.config import Config
    from gcc_tpu_torch.engines.pix2pix import Pix2PixEngine
    from gcc_tpu_torch.ops import mobile_block as mb

    batch, size, n_timed = 4, 256, 3
    print(f"== phase 4: main path, pix2pix resnet GCC iteration, {size}px, "
          f"batch {batch}, 1 warm-up + {n_timed} timed")
    cfg = main_config(Config, ngf=24, ndf=128, teacher_ngf=64,
                      teacher_ndf=128, crop_size=size, batch_size=batch)
    engine = Pix2PixEngine(cfg, filter_cfgs=STUDENT_CFG)  # device: the card
    batches = make_batches(torch, np, 2 * (n_timed + 1), batch, size, 0,
                           engine.device)
    # the student's 9 blocks make 18 stage forwards in generate
    return drive(torch, engine, cfg, batches, batches[0]["A"], mb.LAUNCHES,
                 PER_ITER, {"stage_fwd": 18}, "main path", record=record)


STAGE_KERNELS = ("dw_in_fwd_kernel", "pw_gemm_kernel", "in_fwd_kernel",
                 "in_bwd_kernel", "dw_bwd_plane_kernel", "sum_partials_kernel",
                 "dw_in_fwd_bf16_kernel", "pw_fwd_bf16_kernel",
                 "pw_bwd_bf16_kernel", "in_fwd_bf16_kernel",
                 "in_bwd_bf16_kernel", "dw_bwd_bf16_kernel")
ATTN_KERNELS = ("attn_fwd_kernel", "attn_bwd_kernel", "attn_dq_reduce_kernel",
                "attn_fwd_bf16_kernel", "attn_bwd_bf16_kernel",
                "attn_dq_reduce_bf16_kernel")
CONV_MARKS = ("conv", "cudnn", "xmma", "cutlass", "implicit", "wgrad", "dgrad")


def device_kernels(torch, fn):
    """(name, device us, calls) of every kernel fn launches, by
    torch.profiler, and fn's wall us under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0], wall_us


def profile_iteration(torch, engine, state, batch, val_batch, cfg):
    """One more iteration under torch.profiler: device time by kernel group,
    by B1 and B2 kernel, and the device's busy share of the iteration's wall
    time (the profiler's own overhead lengthens the wall time, so the busy
    share is a floor). Returns the busy share and each group's share of
    device time (empty when the profiler saw no device time)."""
    kernels, wall_us = device_kernels(torch, lambda: engine.train_arch_step(
        state, batch, val_batch, cfg.lr, cfg.ema_beta))
    total = sum(t for _, t, _ in kernels)
    if total == 0:
        print("  profile: the profiler saw no device time")
        return {}
    groups = {"stage kernels (B2)": 0.0, "B1 attention kernels": 0.0,
              "convolutions (cuDNN)": 0.0, "other": 0.0}
    ours = []  # (name, us, calls) of every B1 and B2 kernel
    for name, t, n in kernels:
        low = name.lower()
        if any(k in name for k in ATTN_KERNELS):
            groups["B1 attention kernels"] += t
            ours.append((name, t, n))
        elif any(k in name for k in STAGE_KERNELS):
            groups["stage kernels (B2)"] += t
            ours.append((name, t, n))
        elif any(k in low for k in CONV_MARKS):
            groups["convolutions (cuDNN)"] += t
        else:
            groups["other"] += t
    print(f"  profile of one iteration: device time {total / 1e3:.3f} ms, "
          f"wall {wall_us / 1e3:.3f} ms, device busy {total / wall_us:.3f}")
    for g, t in groups.items():
        print(f"    {g:<22} {t / 1e3:9.3f} ms  {t / total:.3f}")
    for name, t, n in sorted(ours, key=lambda k: -k[1]):
        print(f"      {t / 1e3:9.3f} ms {n:5d}x  {short_name(name)}")
    for name, t, n in sorted(kernels, key=lambda k: -k[1])[:12]:
        print(f"    {t / 1e3:9.3f} ms {n:5d}x  {name[:100]}")
    return {"device_ms": total / 1e3, "busy": total / wall_us,
            **{f"share {g}": t / total for g, t in groups.items()}}


def phase_agree(torch, np):
    from gcc_tpu_torch.config import Config
    from gcc_tpu_torch.engines.pix2pix import Pix2PixEngine

    print("== phase 5: fused (kernels) against unfused (cuDNN) engines, "
          "same weights and batches, 64px, 2 iterations")
    metrics, outs = {}, {}
    for mode in ("on", "off"):
        cfg = main_config(Config, ngf=8, ndf=16, teacher_ngf=16,
                          teacher_ndf=16, crop_size=64, fused_resblock=mode)
        engine = Pix2PixEngine(cfg, device="cuda")
        state = engine.init_state(seed=1)
        batches = make_batches(torch, np, 4, 2, 64, 1, engine.device)
        hist = []
        for i in range(2):
            state, m = engine.train_arch_step(state, batches[2 * i],
                                              batches[2 * i + 1], cfg.lr, 0.9)
            hist.append({k: float(v) for k, v in m.items()})
        metrics[mode] = hist
        outs[mode] = engine.generate(state, batches[0]["A"])
    for i, (a, b) in enumerate(zip(metrics["on"], metrics["off"])):
        for k in a:
            tol = 1e-4 + 2e-3 * abs(b[k])
            if not abs(a[k] - b[k]) < tol:
                fail(f"iter {i} {k}: fused {a[k]} vs unfused {b[k]}")
    err = max_err(outs["on"], outs["off"])
    print(f"  losses agree within 1e-4 + 2e-3|t|; generate max|d| {err:.3e}")
    if not err < 1e-3:
        fail(f"generate differs by {err}")


def pad8(d):
    return (d + 7) // 8 * 8


@functools.lru_cache(maxsize=None)
def sm_clock_hz():
    """The card's maximum SM clock (nvidia-smi clocks.max.sm), in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]
    return float(out) * 1e6


def attn_bounds(B, N, dq, dv, act=4, sms=132, sm_hz=None):
    """Least time for each B1 wrapper's work: its inputs read once and
    outputs written once (q, k, v, dO, O and the gradients of act bytes: 4
    in fp32, 2 in bf16; lse and delta fp32) at 3.35 TB/s, and its
    operations.

    fp32 (act 4), the rate of the units the fp32 kernels run them on: the
    forward's S = q^T k on the fp32 CUDA cores, every other product in
    split-TF32 (three TF32 mma a product); "attn_fwd_fp32" and
    "attn_bwd_fp32" put every flop on the fp32 CUDA cores.

    bf16 (act 2), whatever kernel implements them, the largest of: the
    bytes; the function's multiply-adds (2 B N^2 (dq + dv) flops forward,
    2 B N^2 (3 dq + 2 dv) backward) at the bf16 tensor cores' 989 TFLOP/s;
    and its B N^2 exps at EXP_PER_CLK_SM a clock on each of the sms SMs at
    sm_hz (the card's maximum SM clock). "attn_fwd_issued" and
    "attn_bwd_issued", for information, price what the kernel of the
    shape's route issues: the tiles of flash_attention_bf16.cu dq and dv
    padded to 8, S and dP one bf16 mma a product, P V^T, dV, dK and dQ two
    (P and dS split hi/lo); the wide route S on the fp32 CUDA cores
    (forward), split-TF32 with bf16's zero lo parts skipped elsewhere."""
    pairs, bn = B * N * N, B * N
    fwd_bytes = bn * (act * (2 * dq + 2 * dv) + 4)  # q, k, v in; O, lse out
    # q, k, v, dO, lse, delta in; dq, dk, dv out
    bwd_bytes = bn * (act * (4 * dq + 3 * dv) + 8)
    bwd_flops = 2 * pairs * (3 * dq + 2 * dv)
    if act == 4:
        return {"attn_fwd": bound_ms(fwd_bytes, (2 * pairs * dq, FP32_FLOPS),
                                     (2 * pairs * dv, TF32X3_FLOPS)),
                "attn_fwd_fp32": bound_ms(
                    fwd_bytes, (2 * pairs * (dq + dv), FP32_FLOPS)),
                "attn_bwd": bound_ms(bwd_bytes, (bwd_flops, TF32X3_FLOPS)),
                "attn_bwd_fp32": bound_ms(bwd_bytes,
                                          (bwd_flops, FP32_FLOPS))}
    from gcc_tpu_torch.ops import flash_attention as fa

    exps = (pairs, EXP_PER_CLK_SM * sms * (sm_hz or sm_clock_hz()))
    if fa.bf16_route(dq, dv, False) == "tiles":
        fwd_issued = ((2 * pairs * (pad8(dq) + 2 * dv), BF16_FLOPS), exps)
    else:
        fwd_issued = ((2 * pairs * dq, FP32_FLOPS),
                      (2 * pairs * dv, TF32_FLOPS / 2), exps)
    if fa.bf16_route(dq, dv, True) == "tiles":
        qp, vp = pad8(dq), pad8(dv)
        bwd_issued = ((2 * pairs * (5 * qp + 3 * vp), BF16_FLOPS), exps)
    else:
        bwd_issued = ((2 * pairs * (5 * dq + 3 * dv), TF32_FLOPS), exps)
    return {"attn_fwd": bound_ms(fwd_bytes,
                                 (2 * pairs * (dq + dv), BF16_FLOPS), exps),
            "attn_bwd": bound_ms(bwd_bytes, (bwd_flops, BF16_FLOPS), exps),
            "attn_fwd_issued": bound_ms(fwd_bytes, *fwd_issued),
            "attn_bwd_issued": bound_ms(bwd_bytes, *bwd_issued)}


def library_attention(torch, F, q, k, v, do, kern_fwd, kern_bwd, rounds=3):
    """The B1 kernels and F.scaled_dot_product_attention(scale=1) on the
    same channel-major q, k, v and dO, timed in turns (each of rounds
    rounds times every function, cuda_ms of 20 calls); SDPA pinned to each
    backend (torch.nn.attention.sdpa_kernel: flash, efficient, cuDNN, math;
    one that refuses dq != dv or the dtype is skipped), its backward
    alone: one forward kept, then torch.autograd.grad(out, tok, do_tok,
    retain_graph=True). Returns ({"fwd": ms, "bwd": ms} of the kernels,
    {"fwd": (ms, backend), "bwd": (ms, backend)} of the fastest backend),
    each the median of its rounds."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    tok = [t.transpose(1, 2).unsqueeze(1).contiguous().requires_grad_(True)
           for t in (q, k, v)]
    do_tok = do.transpose(1, 2).unsqueeze(1).contiguous()
    timed = {("kernel", "fwd"): (None, kern_fwd),
             ("kernel", "bwd"): (None, kern_bwd)}
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name)
        try:
            with sdpa_kernel(backend):
                out = F.scaled_dot_product_attention(*tok, scale=1.0)
                torch.autograd.grad(out, tok, do_tok, retain_graph=True)
            torch.cuda.synchronize()
        except RuntimeError as e:
            print(f"    SDPA {name.lower()} refuses these inputs: "
                  f"{str(e).splitlines()[0][:90]}")
            continue
        timed[(name, "fwd")] = (backend, lambda: F.scaled_dot_product_attention(
            *tok, scale=1.0))
        timed[(name, "bwd")] = (backend, lambda out=out: torch.autograd.grad(
            out, tok, do_tok, retain_graph=True))
    runs = {key: [] for key in timed}
    for _ in range(rounds):
        for key, (backend, fn) in timed.items():
            if backend is None:
                runs[key].append(cuda_ms(torch, fn))
                continue
            with sdpa_kernel(backend):
                runs[key].append(cuda_ms(torch, fn))
    ms = {key: sorted(r)[len(r) // 2] for key, r in runs.items()}
    for (name, what), t in ms.items():
        print(f"    {what} {name.lower():<20} {t:.4f} ms (median of "
              + ", ".join(f"{x:.4f}" for x in runs[(name, what)]) + ")")
    lib = {}
    for what in ("fwd", "bwd"):
        libs = [(t, name.lower()) for (name, w), t in ms.items()
                if w == what and name != "kernel"]
        lib[what] = min(libs) if libs else (None, None)
    return {w: ms[("kernel", w)] for w in ("fwd", "bwd")}, lib


def start_parent_build(folder, name):
    """nvcc of an earlier commit's csrc/<name>.cu, placed by hand in folder
    with the headers it includes (for a before/after check; a checkout does
    not hold it), into a library there: (Popen, library path), or None
    where there is no such source."""
    from gcc_tpu_torch.ops import kernels

    src = os.path.join(folder, f"{name}.cu")
    if not os.path.exists(src):
        return None
    out = os.path.join(folder, f"lib{name}_parent.so")
    return subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", out,
                             src], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT), out


def parent_library(build, folder, name, signatures, what):
    """The library that start_parent_build started, the entry points in
    signatures ({name: argtypes}) bound, or None (saying that ``what`` is not
    run) where no source was placed."""
    if build is None:
        print(f"  no earlier {name}.cu in {folder}: {what} is not run")
        return None
    proc, out = build
    log, _ = proc.communicate()
    if proc.returncode != 0:
        fail(f"nvcc of {folder}/{name}.cu:\n{log.decode()}")
    lib = ctypes.CDLL(out)
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    print(f"  {what}: against {folder}/{name}.cu")
    return lib


def same_as_parent(torch, lib, case, fwd, bwd, q, k, v, do, lse, delta):
    """B1's fp32 forward and backward outputs against the earlier source's
    library on the same inputs: the same bits, or fail."""
    (B, dq, N), dv = q.shape, v.shape[1]
    p, st = (lambda t: t.data_ptr()), torch.cuda.current_stream().cuda_stream
    o, ls = torch.empty_like(v), torch.empty(B, N, device=q.device)
    grads = [torch.empty_like(t) for t in (q, k, v)]
    part = torch.empty(B, lib.gcc_attn_bwd_groups(N), dq, N, device=q.device)
    if (lib.gcc_attn_fwd(p(q), p(k), p(v), p(o), p(ls), B, N, dq, dv, st)
            or lib.gcc_attn_bwd(p(q), p(k), p(v), p(do), p(lse), p(delta),
                                *map(p, grads), p(part), B, N, dq, dv, st)):
        fail(f"{case}: the earlier B1 library's launch failed")
    same = [torch.equal(a, b) for a, b in zip((*fwd, *bwd), (o, ls, *grads))]
    print(f"    bit for bit with the earlier source (O, lse, dq, dk, dv): "
          f"{same}")
    if not all(same):
        fail(f"{case}: fp32 B1 differs from the earlier source: {same}")


def phase_attention(torch, F, parent=None):
    from gcc_tpu_torch.ops import flash_attention as fa

    print("== phase 6: flash-attention kernels against their plain versions "
          "(fp32, TF32 off)")
    record = {k: {"max_abs_err": 0.0} for k in ATTN_PER_ITER}
    gen = torch.Generator().manual_seed(0)
    for case, B, N, dq, dv, qk_scale in ATTN_CASES:
        print(f"  {case}: B={B} N={N} dq={dq} dv={dv} q, k scale {qk_scale}")

        def rnd(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen) * scale).cuda()

        q, k = rnd(B, dq, N, scale=qk_scale), rnd(B, dq, N, scale=qk_scale)
        v, do = rnd(B, dv, N), rnd(B, dv, N)
        o, lse = fa.attn_fwd(q, k, v)
        o_p, lse_p = fa.attn_fwd_plain(q, k, v)
        print(f"    max |S| {float(torch.einsum('bci,bcj->bij', q, k).abs().max()):.1f}")
        errs = [check_close(f"fwd {n}", a, b,
                            1e-5 * max(float(b.abs().max()), 1.0))
                for n, a, b in (("O", o, o_p), ("lse", lse, lse_p))]
        record["attn_fwd"]["max_abs_err"] = max(
            record["attn_fwd"]["max_abs_err"], *errs)
        # the backward kernel on the plain forward's saved tensors
        lse_p = lse_p.contiguous()
        delta = (do * o_p).sum(1)
        args = (q, k, v, do, lse_p, delta)
        got = fa.attn_bwd(*args)
        plain = fa.attn_bwd_plain(*args)
        errs = [check_close(f"bwd {n}", a, b,
                            1e-4 * max(float(b.abs().max()), 1.0))
                for n, a, b in zip(("dq", "dk", "dv"), got, plain)]
        # the backward on the kernel forward's own lse and O, as autograd
        # runs it, against the plain backward on the plain forward's
        errs += [check_close(f"bwd on kernel lse {n}", a, b,
                             1e-4 * max(float(b.abs().max()), 1.0))
                 for n, a, b in zip(("dq", "dk", "dv"), fa.attn_bwd(
                     q, k, v, do, lse, (do * o).sum(1)), plain)]
        record["attn_bwd"]["max_abs_err"] = max(
            record["attn_bwd"]["max_abs_err"], *errs)
        # no float atomics: a second call gives the same bits
        if not all(torch.equal(a, b) for a, b in zip(got, fa.attn_bwd(*args))):
            fail(f"{case}: two attn_bwd calls differ")
        if not all(torch.equal(a, b)
                   for a, b in zip((o, lse), fa.attn_fwd(q, k, v))):
            fail(f"{case}: two attn_fwd calls differ")
        print(f"    attn_bwd dq scratch {B * fa.dq_groups(N) * dq * N * 4} B "
              f"({fa.dq_groups(N)} key-tile groups)")
        if case in TIMED_WIDE:
            bounds = attn_bounds(B, N, dq, dv)
            for key, kern, plain in (
                    ("attn_fwd", lambda: fa.attn_fwd(q, k, v),
                     lambda: fa.attn_fwd_plain(q, k, v)),
                    ("attn_bwd", lambda: fa.attn_bwd(*args),
                     lambda: fa.attn_bwd_plain(*args))):
                b_ms, b_by = bounds[key]
                print(f"    {key:<13} kernel {cuda_ms(torch, kern, n=5):.4f} ms"
                      f"  plain {cuda_ms(torch, plain, n=5):.4f} ms  bound "
                      f"{b_ms:.4f} ms ({b_by})")
        if parent is not None:
            same_as_parent(torch, parent, case, (o, lse), got, q, k, v, do,
                           lse_p, delta)
        if case not in ("teacher", "student"):
            continue
        # times at the main path's shapes, the kernels and SDPA in turns;
        # the teacher's go to the record
        bounds = attn_bounds(B, N, dq, dv)
        kern, lib = library_attention(
            torch, F, q, k, v, do, lambda: fa.attn_fwd(q, k, v),
            lambda: fa.attn_bwd(*args))
        timings = {"attn_fwd": lambda: fa.attn_fwd_plain(q, k, v),
                   "attn_bwd": lambda: fa.attn_bwd_plain(*args)}
        for key, plain in timings.items():
            what = key[5:]
            rec = {"ms": kern[what], "plain_ms": cuda_ms(torch, plain),
                   "library_ms": lib[what][0],
                   "library": f"F.scaled_dot_product_attention "
                              f"({lib[what][1]})"}
            rec["bound_ms"], rec["bound_by"] = bounds[key]
            print(f"    {key:<13} kernel {rec['ms']:.4f} ms  plain "
                  f"{rec['plain_ms']:.4f} ms  library {rec['library_ms']} "
                  f"ms ({lib[what][1]})  bound {rec['bound_ms']:.4f} ms "
                  f"({rec['bound_by']})")
            if case == "teacher":
                record[key].update(rec)
        for key in ("attn_fwd", "attn_bwd"):
            fp32_ms, fp32_by = bounds[f"{key}_fp32"]
            print(f"    {key} bound on the fp32 CUDA cores {fp32_ms:.4f} ms "
                  f"({fp32_by}); the line above counts its products on the "
                  f"tensor cores in split-TF32")
    attn_long_kernel_only(torch, fa, gen)
    return record


def attn_long_kernel_only(torch, fa, gen, B=1, N=65536, dq=8, dv=64):
    """B1 at a length whose plain version would need an N x N matrix of
    16 GiB: the kernels alone, forward and backward; finite outputs, and
    the peak device memory above the inputs and outputs (the backward's
    dq scratch, delta and the allocator's rounding)."""
    print(f"  long_n_kernel_only: B={B} N={N} dq={dq} dv={dv}, kernels alone")
    q, k = ((torch.randn(B, dq, N, generator=gen) * 0.5).cuda()
            for _ in range(2))
    v, do = (torch.randn(B, dv, N, generator=gen).cuda() for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    o, lse = fa.attn_fwd(q, k, v)
    grads = fa.attn_bwd(q, k, v, do, lse, (do * o).sum(1))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    outs = 4 * (B * dv * N + B * N + 2 * B * dq * N + B * dv * N)
    above = torch.cuda.max_memory_allocated() - base - outs
    if not all(bool(torch.isfinite(t).all()) for t in (o, lse, *grads)):
        fail("long_n_kernel_only: non-finite output")
    print(f"    finite; forward + backward {dt * 1e3:.1f} ms (host clock); "
          f"peak device memory above inputs and outputs {above} B "
          f"({above / 2**20:.1f} MiB; dq scratch "
          f"{B * fa.dq_groups(N) * dq * N * 4} B)")
    if not above < 2**27:
        fail(f"long_n_kernel_only: {above} B above inputs and outputs")


def sagan_config(Config, **kw):
    base = dict(model="sagan", crop_size=64, gan_mode="hinge",
                online_distillation=True, darts_discriminator=True,
                threshold=0.1, lambda_L1=0.0, lambda_content=1.0,
                lambda_gram=1.0, lr=1e-4, arch_lr=1e-4)
    base.update(kw)
    return Config(**base)


def make_sagan_batches(torch, np, n, batch, z_dim, seed, device):
    rng = np.random.RandomState(seed)
    return [{"z": torch.from_numpy(rng.randn(batch, z_dim).astype(
                np.float32)).to(device),
             "real_img": torch.from_numpy(rng.rand(batch, 3, 64, 64).astype(
                 np.float32) * 2 - 1).to(device)} for _ in range(n)]


def phase_sagan(torch, np):
    from gcc_tpu_torch.config import Config
    from gcc_tpu_torch.engines.sagan import SAGANEngine
    from gcc_tpu_torch.ops import flash_attention as fa

    batch, n_timed = 64, 3
    print(f"== phase 7: SAGAN GCC iteration, 64px, batch {batch}, 1 warm-up "
          f"+ {n_timed} timed")
    cfg = sagan_config(Config, ngf=48, ndf=64, teacher_ngf=64, teacher_ndf=64,
                       z_dim=128, batch_size=batch)
    engine = SAGANEngine(cfg, filter_cfgs=SAGAN_STUDENT_CFG)  # the card
    batches = make_sagan_batches(torch, np, 2 * (n_timed + 1), batch,
                                 cfg.z_dim, 0, engine.device)
    # generate runs the student's attn2 once
    return drive(torch, engine, cfg, batches, batches[0]["z"], fa.LAUNCHES,
                 ATTN_PER_ITER, {"attn_fwd": 1}, "sagan path")


def phase_sagan_agree(torch, np):
    from gcc_tpu_torch.config import Config
    from gcc_tpu_torch.engines.sagan import SAGANEngine
    from gcc_tpu_torch.ops import flash_attention as fa
    from gcc_tpu_torch.ops.attention import SelfAttention

    print("== phase 8: attention kernels against the einsum route, same "
          "weights and batches, SAGAN 64px, 2 iterations, gamma non-zero, "
          "thresholds 1024 and 16")
    metrics, outs, launched = {}, {}, {}
    torch.backends.cudnn.deterministic = True  # only attention may differ
    try:
        for route, thr in (("kernels", 1024), ("kernels16", 16),
                           ("einsum", 2 ** 30)):
            cfg = sagan_config(Config, ngf=16, ndf=16, teacher_ngf=16,
                               teacher_ndf=16, z_dim=16,
                               pallas_attn_threshold=thr)
            engine = SAGANEngine(cfg, device="cuda")
            state = engine.init_state(seed=1)
            for net in state.nets.values():
                for name, mod in net.named_modules():
                    if isinstance(mod, SelfAttention):
                        mod.gamma.data.fill_(0.5 if name == "attn1" else -0.3)
            batches = make_sagan_batches(torch, np, 4, 4, cfg.z_dim, 1,
                                         engine.device)
            before = fa.LAUNCHES["attn_fwd"]
            hist = []
            for i in range(2):
                state, m = engine.train_arch_step(state, batches[2 * i],
                                                  batches[2 * i + 1], cfg.lr,
                                                  0.9)
                hist.append({k: float(v) for k, v in m.items()})
            metrics[route] = hist
            outs[route] = engine.generate(state, batches[0]["z"])
            launched[route] = fa.LAUNCHES["attn_fwd"] - before
    finally:
        torch.backends.cudnn.deterministic = False
    if not 0 < launched["kernels"] < launched["kernels16"] \
            or launched["einsum"] != 0:
        fail(f"attn_fwd launches by route: {launched}")
    for route in ("kernels", "kernels16"):
        for i, (a, b) in enumerate(zip(metrics[route], metrics["einsum"])):
            for k in a:
                tol = 1e-4 + 2e-3 * abs(b[k])
                if not abs(a[k] - b[k]) < tol:
                    fail(f"iter {i} {k}: {route} {a[k]} vs einsum {b[k]}")
        err = max_err(outs[route], outs["einsum"])
        print(f"  {route}: losses agree with the einsum route within 1e-4 + "
              f"2e-3|t|; generate max|d| {err:.3e}")
        if not err < 1e-3:
            fail(f"{route}: generate differs by {err}")
    print(f"  attn_fwd launches by route {launched}")


def spread_tree(np, tree, rng):
    """bench.py:176-182's spread over a JAX-layout params tree, leaves in
    the JAX tree order (sorted keys): rand * exp(U(-6, 2)) per last-axis
    channel, emulating sparsity pretraining."""
    if isinstance(tree, dict):
        return {k: spread_tree(np, tree[k], rng) for k in sorted(tree)}
    return (np.asarray(rng.rand(*tree.shape), np.float32)
            * np.exp(rng.uniform(-6, 2, tree.shape[-1:])).astype(np.float32))


def unet_config(Config, **kw):
    return main_config(Config, **{"backbone": "unet",
                                  "fused_resblock": "auto", **kw})


def unet_engine(torch, np, batch):
    """The bench's U-Net GCC engine on the card at 256 px (bench.py:170-186):
    the student UnetGenerator(32) at spread weights, pruned to 3.0 GMACs by
    the port's prune_unet; (engine, cfg)."""
    from gcc_tpu_torch.compress import prune_unet
    from gcc_tpu_torch.config import Config
    from gcc_tpu_torch.engines.pix2pix import Pix2PixEngine
    from gcc_tpu_torch.models.generators import UnetGenerator
    from gcc_tpu_torch.utils.weights import export_jax_variables

    t0 = time.perf_counter()
    tree = export_jax_variables(UnetGenerator(ngf=32))["params"]
    fc, cc, gmacs = prune_unet(spread_tree(np, tree, np.random.RandomState(0)),
                               mode="scale", ngf=32, target_budget_g=3.0,
                               tolerance_g=0.1)
    print(f"  pruned student filter_cfgs {fc}, channel_cfgs {cc}: "
          f"{gmacs:.4f} GMACs ({time.perf_counter() - t0:.2f} s)")
    cfg = unet_config(Config, ngf=32, ndf=128, teacher_ngf=64,
                      teacher_ndf=128, crop_size=256, batch_size=batch)
    return Pix2PixEngine(cfg, filter_cfgs=fc, channel_cfgs=cc), cfg


def phase_unet(torch, np, record=None):
    from gcc_tpu_torch.ops import flash_attention as fa
    from gcc_tpu_torch.ops import mobile_block as mb

    batch, size, n_timed = UNET_BATCH, 256, 3
    print(f"== phase 9: default pix2pix path, U-Net GCC iteration, {size}px, "
          f"batch {batch}, 1 warm-up + {n_timed} timed; cudnn.benchmark "
          f"{torch.backends.cudnn.benchmark}")
    engine, cfg = unet_engine(torch, np, batch)  # the card
    batches = make_batches(torch, np, 2 * (n_timed + 1), batch, size, 0,
                           engine.device)
    for k in fa.LAUNCHES:
        fa.LAUNCHES[k] = 0
    drive(torch, engine, cfg, batches, batches[0]["A"], mb.LAUNCHES,
          {k: 0 for k in mb.LAUNCHES}, {}, "unet path", record=record)
    if any(fa.LAUNCHES.values()):
        fail(f"unet path launched B1: {fa.LAUNCHES}")


def phase_unet_agree(torch, np):
    from gcc_tpu_torch.config import Config
    from gcc_tpu_torch.engines.pix2pix import Pix2PixEngine

    print("== phase 10: U-Net engine on the card against the same engine on "
          "the CPU, same weights and batches, no dropout, 32px, 3 iterations")
    cfg = unet_config(Config, ngf=4, ndf=8, teacher_ngf=8, teacher_ndf=8,
                      crop_size=32, num_downs=5, no_dropout=True)
    hist, outs = {}, {}
    for dev in ("cuda", "cpu"):
        engine = Pix2PixEngine(cfg, device=dev)
        state = engine.init_state(seed=1)  # the same numbers on every device
        batches = make_batches(torch, np, 6, 2, 32, 1, engine.device)
        hist[dev] = []
        for i in range(3):
            state, m = engine.train_arch_step(state, batches[2 * i],
                                              batches[2 * i + 1], cfg.lr, 0.9)
            hist[dev].append({k: float(v) for k, v in m.items()})
        outs[dev] = engine.generate(state, batches[0]["A"]).cpu()
    for i, (a, b) in enumerate(zip(hist["cuda"], hist["cpu"])):
        for k in b:
            tol = 1e-4 + 2e-3 * abs(b[k])
            if not abs(a[k] - b[k]) < tol:
                fail(f"iter {i} {k}: card {a[k]} vs CPU {b[k]}")
    err = max_err(outs["cuda"], outs["cpu"])
    print(f"  losses agree within 1e-4 + 2e-3|t| over 3 iterations; generate "
          f"max|d| {err:.3e}")
    if not err < 1e-3:
        fail(f"generate differs by {err}")


class IterationClock:
    """Wraps the engines' train_step and train_arch_step while the CLI runs:
    per outermost call, the kernels' launches it made and its duration, and
    the host time at which it ended (each call ends in a synchronize)."""

    def __init__(self, torch, classes, counters):
        self.torch, self.classes, self.counters = torch, classes, counters
        self.calls, self.depth, self.saved = [], 0, []

    def __enter__(self):
        for cls in self.classes:
            for name in ("train_step", "train_arch_step"):
                self.saved.append((cls, name, cls.__dict__.get(name)))
                setattr(cls, name, self._wrap(getattr(cls, name)))
        return self

    def __exit__(self, *exc):
        for cls, name, own in reversed(self.saved):
            if own is None:
                delattr(cls, name)  # inherited again
            else:
                setattr(cls, name, own)

    def _wrap(self, orig):
        def step(engine, *args, **kw):
            self.depth += 1
            before = {k: dict(c) for k, c in self.counters.items()}
            t0 = time.perf_counter()
            try:
                return orig(engine, *args, **kw)
            finally:
                self.depth -= 1
                if self.depth == 0:
                    self.torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    grown = {n: c[n] - before[k][n]
                             for k, c in self.counters.items() for n in c}
                    self.calls.append((t0, t1, grown))
        return step

    def summary(self):
        """(ms per CLI iteration between consecutive ends, engine ms of the
        same iterations, launches of each iteration); the first iteration
        is the warm-up."""
        ends = [t1 for _, t1, _ in self.calls]
        gaps = [b - a for a, b in zip(ends, ends[1:])]
        inside = [t1 - t0 for t0, t1, _ in self.calls[1:]]
        mean = (lambda xs: 1e3 * sum(xs) / len(xs) if xs else float("nan"))
        return mean(gaps), mean(inside), [g for _, _, g in self.calls]


class LogLines:
    """Collects the CLI logger's messages that start with one of prefixes."""

    def __init__(self, logging, prefixes):
        self.logging, self.prefixes, self.lines = logging, prefixes, []

    def __enter__(self):
        owner = self

        class Grab(self.logging.Handler):
            def emit(self, record):
                msg = record.getMessage()
                if msg.startswith(owner.prefixes):
                    owner.lines.append(msg)

        self.handler = Grab()
        self.logging.getLogger("gcc-tpu-torch").addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logging.getLogger("gcc-tpu-torch").removeHandler(self.handler)


CLI_LOG = ("pruned ", "[proxy]", "metrics: ", "resumed ", "val: ",
           "FID: ", "mIoU: ", "AtoB FID: ", "BtoA FID: ",
           "loaded ", "SRGAN perceptual", "data: ", "memory guard",
           "device_cache", "port: ")


def run_cli(torch, stage, argv, counters, records, test=False):
    """One CLI run in this process (the card), timed, with the kernels'
    counts set to 0 just before and read just after; prints its pruned
    cfgs, metric and per-iteration numbers and returns the clock."""
    import logging

    from gcc_tpu_torch.cli import test as cli_test
    from gcc_tpu_torch.cli import train as cli_train
    from gcc_tpu_torch.engines.cyclegan import CycleGANEngine
    from gcc_tpu_torch.engines.pix2pix import Pix2PixEngine
    from gcc_tpu_torch.engines.sagan import SAGANEngine
    from gcc_tpu_torch.engines.srgan import SRGANEngine

    for c in counters.values():
        for k in c:
            c[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engines = (Pix2PixEngine, SAGANEngine, CycleGANEngine, SRGANEngine)
    with IterationClock(torch, engines, counters) as clock, \
            LogLines(logging, CLI_LOG) as log:
        rc = (cli_test if test else cli_train).main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"{stage}: exit code {rc}")
    cli_ms, engine_ms, per_iter = clock.summary()
    totals = {k: dict(c) for k, c in counters.items()}
    print(f"  {stage}: {wall:.3f} s wall, {len(per_iter)} iterations, "
          f"{cli_ms:.3f} ms/iteration through the CLI, {engine_ms:.3f} ms in "
          f"the engine step; launches per iteration {per_iter}, in all "
          f"{totals}")
    for line in log.lines:
        print(f"    {line}")
    # a number, or a dict of named ones (CycleGAN's directions, SRGAN's
    # sets)
    metric = [ast.literal_eval(x.split(": ", 1)[1]) for x in log.lines
              if x.startswith("metrics: ")]
    ms = (lambda x: None if math.isnan(x) else round(x, 3))
    records.append({"stage": stage, "seconds": round(wall, 3),
                    "iterations": len(per_iter), "ms_per_iter": ms(cli_ms),
                    "engine_ms_per_iter": ms(engine_ms)})
    return clock, metric[0] if metric else None, log.lines


def host_batch_ms(argv, n=3):
    """Host ms to build one training batch of argv's dataset on one thread
    (items + collate), the least of n after a first one: the data path's
    cost per batch, which the loader's threads overlap with the card."""
    from gcc_tpu_torch import config
    from gcc_tpu_torch.data import build_dataset
    from gcc_tpu_torch.data.loader import collate

    cfg = config.parse(argv)
    ds = build_dataset(cfg, seed=0)
    times = []
    for r in range(n + 1):
        t0 = time.perf_counter()
        collate([ds[(r * cfg.batch_size + i) % len(ds)]
                 for i in range(cfg.batch_size)])
        times.append(time.perf_counter() - t0)
    return 1e3 * min(times[1:])


def spread_checkpoint(np, net, path, why):
    """Stage 1's checkpoint from bench.py's spread weights (phase 9's), as
    sparsity pretraining would leave them, written by the port."""
    from gcc_tpu_torch.utils.checkpoint import save_checkpoint
    from gcc_tpu_torch.utils.weights import export_jax_variables

    tree = export_jax_variables(net)
    tree["params"] = spread_tree(np, tree["params"], np.random.RandomState(0))
    save_checkpoint(path, {"G": tree, "D": None, "epoch": 1,
                           "cfg": (None, None), "fid": None})
    print(f"  stage 1 checkpoint replaced by spread weights: {why}")


def prunable(argv):
    """None when stage 2's prune-on-startup meets its budget from argv's
    --pretrain_path, else the search's error."""
    import logging

    from gcc_tpu_torch import config
    from gcc_tpu_torch.cli.train import build_engine

    try:
        build_engine(config.parse(argv), logging.getLogger("chip_smoke"),
                     device="cpu")
    except RuntimeError as e:
        return str(e)
    return None


def phase_cli(torch, np):
    """Phase 11: the training run through the CLIs on the card."""
    import tempfile

    from gcc_tpu_torch.models.generators import (MobileResnetGenerator,
                                                 SAGANGenerator,
                                                 UnetGenerator)
    from gcc_tpu_torch.ops import flash_attention as fa
    from gcc_tpu_torch.ops import mobile_block as mb

    counters = {"B2": mb.LAUNCHES, "B1": fa.LAUNCHES}
    records = []
    print("== phase 11: the training run through python -m "
          "gcc_tpu_torch.cli.{train,test} on the card, synthetic data")
    with tempfile.TemporaryDirectory() as tmp:
        # fp32, as this phase has always run: phase 17 (e) runs the
        # default bf16
        common = (f"--dataroot synthetic --dataset_mode synthetic "
                  f"--model pix2pix --max_dataset_size 8 --batch_size 4 "
                  f"--n_epochs 1 --n_epochs_decay 0 --print_freq 4 "
                  f"--num_threads 4 --compute_dtype float32 "
                  f"--checkpoints_dir {tmp}").split()
        # (a) U-Net, scripts/pix2pix/*.sh at 256 px
        s1 = common + "--lambda_scale 1e-2 --ngf 32 --ndf 128 --name u1".split()
        run_cli(torch, "unet stage 1", s1, counters, records)
        best1 = f"{tmp}/u1/checkpoints/model_best_AtoB.ckpt"
        gcc = (f"--ngf 32 --ndf 128 --darts_discriminator --arch_lr 1e-4 "
               f"--arch_lr_step --scale_prune --target_budget 3.0 "
               f"--pretrain_path {best1} --online_distillation "
               f"--lambda_content 50 --lambda_gram 1e4 --name u2").split()
        why = prunable(common + gcc)
        if why:
            spread_checkpoint(np, UnetGenerator(ngf=32), best1, why)
        run_cli(torch, "unet stage 2", common + gcc, counters, records)
        test_args = (f"--dataroot synthetic --dataset_mode synthetic "
                     f"--model pix2pix --ngf 32 --max_dataset_size 8 "
                     f"--checkpoints_dir {tmp} --pretrain_path "
                     f"{tmp}/u2/checkpoints/model_1.ckpt").split()
        run_cli(torch, "unet stage 3 (test)", test_args + ["--name", "u3"],
                counters, records, test=True)
        # (b) resnet with fused blocks (B2), pruned from a resnet stage 1
        res = "--backbone resnet --fused_resblock on --ngf 64 --ndf 128"
        r1 = common + f"{res} --lambda_scale 1e-2 --name r1".split()
        run_cli(torch, "resnet stage 1", r1, counters, records)
        rbest = f"{tmp}/r1/checkpoints/model_best_AtoB.ckpt"
        r2 = common + (f"{res} --darts_discriminator --arch_lr 1e-4 "
                       f"--arch_lr_step --scale_prune --target_budget 3.0 "
                       f"--pretrain_path {rbest} --online_distillation "
                       f"--lambda_content 50 --lambda_gram 1e4 "
                       f"--name r2").split()
        why = prunable(r2)
        if why:
            spread_checkpoint(np, MobileResnetGenerator(ngf=64), rbest, why)
        clock, _, _ = run_cli(torch, "resnet stage 2 (B2)", r2, counters,
                              records)
        b2 = [{k: g[k] for k in PER_ITER} for g in clock.summary()[2]]
        print(f"  B2 launches per iteration through the CLI: {b2}")
        if any(g != PER_ITER for g in b2) or not b2:
            fail(f"resnet stage 2: B2 launches {b2}, expected {PER_ITER}")
        # (c) SAGAN, scripts/sagan/*.sh at 64 px, batch 64, two iterations
        sg = (f"--dataroot synthetic/celeb --dataset_mode synthetic "
              f"--model sagan --max_dataset_size 128 --n_epochs 1 "
              f"--save_epoch_freq 1 --print_freq 64 --num_threads 4 "
              f"--compute_dtype float32 --checkpoints_dir {tmp}").split()
        g1 = sg + "--lambda_scale 1e-2 --ngf 48 --ndf 64 --name g1".split()
        run_cli(torch, "sagan stage 1", g1, counters, records)
        gbest = f"{tmp}/g1/checkpoints/model_best_AtoB.ckpt"
        g2 = sg + (f"--ngf 48 --ndf 64 --scale_prune --pretrain_path {gbest} "
                   f"--target_budget 0.016 --darts_discriminator "
                   f"--threshold 0.1 --online_distillation --lambda_L1 0 "
                   f"--lambda_content 1 --lambda_gram 1 --name g2").split()
        why = prunable(g2)
        if why:
            spread_checkpoint(np, SAGANGenerator(ngf=48), gbest, why)
        clock, _, _ = run_cli(torch, "sagan stage 2 (B1)", g2, counters,
                              records)
        b1 = [{k: g[k] for k in ATTN_PER_ITER} for g in clock.summary()[2]]
        print(f"  B1 launches per iteration through the CLI: {b1}")
        if any(g != ATTN_PER_ITER for g in b1) or not b1:
            fail(f"sagan stage 2: B1 launches {b1}, expected {ATTN_PER_ITER}")
        # (d) resume (a)'s stage 2 for a second epoch
        _, _, lines = run_cli(
            torch, "unet stage 2 resumed", common + gcc
            + "--n_epochs 2 --continue_train".split(), counters, records)
        if not any("continuing at epoch 2" in x for x in lines):
            fail(f"resume did not continue at epoch 2: {lines}")
        with open(f"{tmp}/u2/checkpoints/train_state.json") as f:
            meta = json.load(f)
        if meta != {"epoch": 2}:
            fail(f"resume: train_state.json {meta}")
        # (e) the final checkpoint's metric on the card and on the CPU
        final = test_args[:-1] + [f"{tmp}/u2/checkpoints/model_2.ckpt"]
        _, card, _ = run_cli(torch, "unet test on the card",
                             final + ["--name", "e_card"], counters, records,
                             test=True)
        _, cpu, _ = run_cli(torch, "unet test on the CPU",
                            final + ["--name", "e_cpu", "--gpu_ids", "-1"],
                            counters, records, test=True)
        for name, argv, stage in (("unet 256 px, batch 4", common + gcc,
                                   "unet stage 2"),
                                  ("resnet 256 px, batch 4", r2,
                                   "resnet stage 2 (B2)"),
                                  ("sagan 64 px, batch 64", g2,
                                   "sagan stage 2 (B1)")):
            ms = host_batch_ms(argv)
            rec = next(r for r in records if r["stage"] == stage)
            rec["host_batch_ms"] = round(ms, 3)
            # a DARTS iteration takes a train and a val batch
            print(f"  data path, {name}: {ms:.3f} ms a batch on one host "
                  f"thread; two batches an iteration = "
                  f"{2 * ms / rec['ms_per_iter']:.3f} of the CLI iteration")
        same_metric("unet", card, cpu)
        cli_cyclegan(torch, np, tmp, counters, records)
        cli_srgan(torch, np, tmp, counters, records)
        cli_evaluators(torch, np, tmp, counters, records)
    return records


def same_metric(what, card, cpu):
    """The test CLI's metric on the card and on the CPU: each named value
    within 1e-4 relative."""
    card_d = card if isinstance(card, dict) else {"metric": card}
    cpu_d = cpu if isinstance(cpu, dict) else {"metric": cpu}
    if set(card_d) != set(cpu_d):
        fail(f"{what}: metrics {card} vs {cpu}")
    for k in cpu_d:
        rel = abs(card_d[k] - cpu_d[k]) / abs(cpu_d[k])
        print(f"  {what} {k}: card {card_d[k]!r}, CPU {cpu_d[k]!r}: "
              f"relative difference {rel:.3e} (bound 1e-4)")
        if not rel <= 1e-4:
            fail(f"{what} {k}: card {card_d[k]} vs CPU {cpu_d[k]}")


def cli_test_both(torch, stage, argv, counters, records):
    """The test CLI on the card and on the CPU: the same metric."""
    name = stage.replace(" ", "_")
    _, card, _ = run_cli(torch, f"{stage} (test) on the card",
                         argv + ["--name", f"{name}_card"], counters,
                         records, test=True)
    _, cpu, _ = run_cli(torch, f"{stage} (test) on the CPU",
                        argv + ["--name", f"{name}_cpu", "--gpu_ids", "-1"],
                        counters, records, test=True)
    same_metric(stage, card, cpu)


def cli_cyclegan(torch, np, tmp, counters, records):
    """(f) scripts/cyclegan/*.sh on synthetic unaligned data named like the
    script's horse2zebra root, so stage 2 takes the reference's cfgs (its
    prune on startup there, utils/prune_util.py:120-121); stage 2 with
    fused blocks (B2 by the structure each iteration); the test CLI on the
    card and on the CPU."""
    from gcc_tpu_torch.compress import cyclegan_reference_cfgs

    size = CYCLEGAN_SIZE
    cg = (f"--dataroot synthetic/horse2zebra --dataset_mode synthetic "
          f"--model cyclegan --max_dataset_size 4 --n_epochs 1 "
          f"--n_epochs_decay 0 --save_epoch_freq 1 --print_freq 1 "
          f"--crop_size {size} --load_size {size} --num_threads 4 "
          f"--compute_dtype float32 --checkpoints_dir {tmp}").split()
    run_cli(torch, "cyclegan stage 1",
            cg + "--lambda_weight 1e-3 --ndf 64 --ngf 48 --name c1".split(),
            counters, records)
    c2 = cg + (f"--ngf 24 --ndf 64 --darts_discriminator --arch_lr 1e-4 "
               f"--arch_lr_step --norm_prune --pretrain_path "
               f"{tmp}/c1/checkpoints/model_1.ckpt --target_budget 2.4 "
               f"--target_budget_B 2.7 --online_distillation "
               f"--lambda_content 0.01 --lambda_gram 10 --fused_resblock on "
               f"--name c2").split()
    clock, _, _ = run_cli(torch, "cyclegan stage 2 (B2)", c2, counters,
                          records)
    per_iter, _ = cyclegan_launches(*cyclegan_reference_cfgs())
    b2 = [{k: g[k] for k in per_iter} for g in clock.summary()[2]]
    print(f"  B2 launches per iteration through the CLI: {b2}")
    if any(g != per_iter for g in b2) or not b2:
        fail(f"cyclegan stage 2: B2 launches {b2}, expected {per_iter}")
    # the test CLI's pixel-FID over 32 images a domain: over 4 (rank-3
    # covariances of 192 features), one uint8 step of one feature moves it
    # by up to ~1e-4 relative between card and CPU; over 32, under 1e-5
    cli_test_both(torch, "cyclegan stage 3", cg + (
        "--ngf 24 --max_dataset_size 32 --pretrain_path "
        f"{tmp}/c2/checkpoints/model_best_AtoB.ckpt").split(), counters,
        records)


def cli_srgan(torch, np, tmp, counters, records):
    """(g) scripts/srgan/*.sh on synthetic sr data: the teacher's G and
    stage 1 by --generator_only pretraining, stage 2 pruned on startup to
    SRGAN_BUDGET from stage 1 with the teacher from --teacher_initial_path
    (no B1 or B2), the test CLI on the card and on the CPU."""
    from gcc_tpu_torch.models.generators import SRResNet

    sr = (f"--dataroot synthetic/sr --dataset_mode synthetic --model srgan "
          f"--max_dataset_size 32 --n_epochs 1 --n_epochs_decay 0 "
          f"--save_epoch_freq 1 --print_freq 16 --image_size {SRGAN_HR} "
          f"--num_threads 4 --compute_dtype float32 --checkpoints_dir {tmp}"
          ).split()
    run_cli(torch, "srgan teacher",
            sr + "--generator_only --ngf 64 --name t0".split(), counters,
            records)
    run_cli(torch, "srgan stage 1", sr + (
        "--generator_only --ngf 24 --ndf 64 --lambda_scale 1e-2 "
        "--name s1").split(), counters, records)
    s1 = f"{tmp}/s1/checkpoints/model_1.ckpt"
    s2 = sr + (f"--ngf 24 --teacher_ngf 64 --scale_prune "
               f"--target_budget {SRGAN_BUDGET} --pretrain_path {s1} "
               f"--teacher_initial_path {tmp}/t0/checkpoints/model_1.ckpt "
               f"--darts_discriminator --arch_lr 1e-4 --arch_lr_step "
               f"--online_distillation --lambda_gram 0.1 --lambda_content 0.1 "
               f"--name s2").split()
    why = prunable(s2)
    if why:
        spread_checkpoint(np, SRResNet(24), s1, why)
    clock, _, _ = run_cli(torch, "srgan stage 2", s2, counters, records)
    launched = [g for g in clock.summary()[2] if any(g.values())]
    if launched or not clock.summary()[2]:
        fail(f"srgan stage 2 launched B1 or B2: {launched}")
    cli_test_both(torch, "srgan stage 3", sr + (
        "--ngf 24 --pretrain_path "
        f"{tmp}/s2/checkpoints/model_best_val_psnr.ckpt").split(), counters,
        records)


def write_aligned_root(np, root, phases, size=256, seed=0):
    """An aligned root of side-by-side AB PNGs (size x 2size): smooth
    random B, A its edge-like rendition, as the synthetic mode draws them;
    {phase: [names]}."""
    from gcc_tpu_torch.data.resample import BICUBIC, resize
    from gcc_tpu_torch.utils.image import png_bytes

    rng = np.random.RandomState(seed)
    names = {}
    for phase, n in phases.items():
        os.makedirs(os.path.join(root, phase), exist_ok=True)
        names[phase] = [f"{phase}_{i:03d}" for i in range(n)]
        for name in names[phase]:
            b = resize((rng.rand(8, 8, 3) * 255).astype(np.uint8),
                       (size, size), BICUBIC).astype(np.float32) / 127.5 - 1
            a = np.sign(b) * np.abs(b) ** 0.5
            ab = np.concatenate([a, b], 1)
            with open(os.path.join(root, phase, name + ".png"), "wb") as f:
                f.write(png_bytes(((ab + 1) * 127.5).clip(0, 255).astype(
                    np.uint8)))
    return names


def write_labels(np, root, names, hw, seed=0):
    """trainIds label maps (0-18, 255 ignored) at hw for names, and the
    reference's table.txt ("<name> <label file> <leftImg8bit file>") in
    root; the count of pixels the histogram takes."""
    from gcc_tpu_torch.utils.image import png_bytes

    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "labels"), exist_ok=True)
    lines, counted = [], 0
    for name in names:
        # blocks of 16x16 of one class each, 5 % of them ignored
        blocks = rng.randint(0, 19, (hw[0] // 16, hw[1] // 16))
        blocks[rng.rand(*blocks.shape) < 0.05] = 255
        label = np.kron(blocks, np.ones((16, 16), np.int64)).astype(np.uint8)
        counted += int((label < 19).sum())
        with open(os.path.join(root, "labels", name + ".png"), "wb") as f:
            f.write(png_bytes(label))
        lines.append(f"{name} labels/{name}.png {name}_leftImg8bit.png")
    with open(os.path.join(root, "table.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return counted


def random_evaluator(np, net, seed, extra=None):
    """A seeded state dict for an evaluator network (NOT the pretrained
    weights): He-scaled convolutions, BatchNorm near identity with positive
    running variances, so that InceptionV3's and DRN-D-105's activations
    stay O(1) through every layer; ``extra`` adds keys a reference file
    carries."""
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in net.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith("running_var"):
            a = 1.0 + 0.2 * rng.rand(*shape)
        elif k.endswith("running_mean"):
            a = 0.1 * rng.randn(*shape)
        elif len(shape) == 4:
            a = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif k.endswith("weight"):  # BatchNorm's scale
            a = 1.0 + 0.1 * rng.randn(*shape)
        else:
            a = 0.05 * rng.randn(*shape)
        sd[k] = a.astype(np.float32)
    sd.update(extra or {})
    return sd


def cli_evaluators(torch, np, tmp, counters, records):
    """(h) the evaluators through the CLIs on the card: convert --evaluator
    inception and drn (seeded random .pth files laid out as the reference's:
    the TF-FID file's fc head, DRN's 'module.' prefixes and up kernel),
    get_real_stat on an aligned root, a U-Net epoch whose eval logs the real
    FID, the test CLI's FID on the card and on the CPU within 1e-4, and the
    cityscapes mIoU branch of the test CLI."""
    from gcc_tpu_torch.cli import convert, get_real_stat
    from gcc_tpu_torch.metrics.inception import FIDInceptionV3
    from gcc_tpu_torch.metrics.miou import DRNSeg, bilinear_up_weights

    inc_pth, drn_pth = f"{tmp}/pt_inception.pth", f"{tmp}/drn_d_105.pth"
    rng = np.random.RandomState(7)
    torch.save({k: torch.from_numpy(v) for k, v in random_evaluator(
        np, FIDInceptionV3(), 7, {
            "fc.weight": (0.01 * rng.randn(1008, 2048)).astype(np.float32),
            "fc.bias": np.zeros(1008, np.float32)}).items()}, inc_pth)
    up = np.broadcast_to(bilinear_up_weights(16), (19, 1, 16, 16))
    torch.save({"module." + k: torch.from_numpy(np.array(v)) for k, v in
                random_evaluator(np, DRNSeg(), 8, {"up.weight": up}).items()},
               drn_pth)
    city = f"{tmp}/cityscapes_synth"
    os.makedirs(city)
    for kind, src, out in (("inception", inc_pth, f"{tmp}/inception.npz"),
                           ("drn", drn_pth, f"{city}/drn.npz")):
        t0 = time.perf_counter()
        if convert.main(["--evaluator", kind, "--pretrain_path", src,
                         "--output", out]) != 0:
            fail(f"convert --evaluator {kind}")
        print(f"  convert --evaluator {kind} on the card: "
              f"{time.perf_counter() - t0:.3f} s")
    root = f"{tmp}/facades_synth"
    write_aligned_root(np, root, {"train": 8, "val": 8})
    flags = (f"--dataroot {root} --dataset_mode aligned --model pix2pix "
             f"--inception_path {tmp}/inception.npz --num_threads 4 "
             f"--compute_dtype float32 --checkpoints_dir {tmp}").split()
    t0 = time.perf_counter()
    if get_real_stat.main(flags + ["--batch_size", "4"]) != 0:
        fail("get_real_stat")
    print(f"  get_real_stat on the card, 8 images: "
          f"{time.perf_counter() - t0:.3f} s")
    train = flags + ("--ngf 32 --ndf 128 --batch_size 4 --n_epochs 1 "
                     "--n_epochs_decay 0 --print_freq 4 --name fid1").split()
    _, _, lines = run_cli(torch, "unet epoch, real FID", train, counters,
                          records)
    if not any(x.startswith("FID: ") for x in lines) or any(
            x.startswith("[proxy]") for x in lines):
        fail(f"unet epoch: no real FID line: {lines}")
    best = f"{tmp}/fid1/checkpoints/model_best_AtoB.ckpt"
    test = flags + ["--ngf", "32", "--pretrain_path", best]
    cli_test_both(torch, "unet real FID", test, counters, records)
    names = write_aligned_root(np, city, {"val": 4}, seed=1)["val"]
    write_labels(np, city, names, (1024, 2048))
    _, miou, lines = run_cli(torch, "cityscapes mIoU (test)", [
        "--dataroot", city, "--dataset_mode", "aligned", "--model",
        "pix2pix", "--phase", "val", "--ngf", "32", "--pretrain_path", best,
        "--drn_path",
        f"{city}/drn.npz", "--checkpoints_dir", tmp, "--name", "miou1"],
        counters, records, test=True)
    if not any(x.startswith("mIoU: ") for x in lines) or any(
            x.startswith("[proxy]") for x in lines) or not math.isfinite(
                float(miou)):
        fail(f"cityscapes test: no real mIoU line: {lines}")


def cyclegan_config(Config, **kw):
    """scripts/cyclegan/train.sh's GCC run: lsgan, the reference's pools
    of 50, online distillation, DARTS, content 0.01, gram 10; fused
    blocks."""
    base = dict(model="cyclegan", gan_mode="lsgan", pool_size=50,
                crop_size=256, load_size=256, batch_size=1,
                online_distillation=True, darts_discriminator=True,
                lambda_content=0.01, lambda_gram=10.0, lr=2e-4, arch_lr=1e-4,
                fused_resblock="on")
    base.update(kw)
    return Config(**base)


def cyclegan_launches(cfg_a, cfg_b):
    """B2 launches of one CycleGAN iteration by the engine's structure: two
    stages a residual block that exists; the teacher and student G updates
    each run 3 forwards of each direction's G with a gradient, the arch
    step one forward of each of the four G's without; and of one generate
    per direction (the students). Each G has 9 residual blocks."""
    def stages(c):
        return 2 * sum(1 for b in range(9) if c[3 + 2 * b] != 0)
    s = stages(cfg_a) + stages(cfg_b)
    t = 2 * 2 * 9  # the teachers are unpruned
    per_iter = {"stage_fwd": 4 * (s + t), "stage_bwd_pw": 3 * (s + t),
                "stage_bwd_dw": 3 * (s + t)}
    return per_iter, {"stage_fwd": s}


def phase_cyclegan(torch, np):
    from gcc_tpu_torch.compress import cyclegan_reference_cfgs
    from gcc_tpu_torch.config import Config
    from gcc_tpu_torch.engines.cyclegan import CycleGANEngine
    from gcc_tpu_torch.ops import flash_attention as fa
    from gcc_tpu_torch.ops import mobile_block as mb

    cfg_a, cfg_b = cyclegan_reference_cfgs()
    size, w = CYCLEGAN_SIZE, CYCLEGAN_WIDTHS
    print(f"== phase 12: CycleGAN GCC iteration (scripts/cyclegan/train.sh), "
          f"{size}px, batch 1, pools of 50, teacher ngf {w['teacher_ngf']} / "
          f"ndf {w['teacher_ndf']}, the reference's students cfg_AtoB "
          f"{cfg_a} and cfg_BtoA {cfg_b}, ndf {w['ndf']} masked, fused "
          f"blocks; 1 warm-up + {N_TIMED} timed")
    cfg = cyclegan_config(Config, crop_size=size, load_size=size, **w)
    engine = CycleGANEngine(cfg, cfg_AtoB=cfg_a, cfg_BtoA=cfg_b)  # the card
    batches = make_batches(torch, np, 2 * (N_TIMED + 1), 1, size, 0,
                           engine.device)
    per_iter, gen_calls = cyclegan_launches(cfg_a, cfg_b)
    print(f"  B2 launches by the structure: {per_iter} an iteration, "
          f"{gen_calls} for the two generates")
    for k in fa.LAUNCHES:
        fa.LAUNCHES[k] = 0
    b0 = batches[0]
    launches = drive(
        torch, engine, cfg, batches, b0["A"], mb.LAUNCHES, per_iter,
        gen_calls, "cyclegan path",
        generate=lambda st: [engine.generate(st, b0["A"], "AtoB"),
                             engine.generate(st, b0["B"], "BtoA")])
    if any(fa.LAUNCHES.values()):
        fail(f"cyclegan path launched B1: {fa.LAUNCHES}")
    return launches


def _agree_losses(hist_a, hist_b, what):
    """Loss histories within 1e-4 + 2e-3|t|, CycleGAN's arch keys within
    3e-2 (they read the teachers after their update)."""
    worst = {}
    for i, (a, b) in enumerate(zip(hist_a, hist_b)):
        if set(a) != set(b):
            fail(f"{what}: loss keys {sorted(set(a) ^ set(b))}")
        for k in b:
            tol = 3e-2 if k in CYCLEGAN_CHAOTIC else 1e-4 + 2e-3 * abs(b[k])
            worst[k] = max(worst.get(k, 0.0), abs(a[k] - b[k]) / tol)
            if not abs(a[k] - b[k]) < tol:
                fail(f"{what}: iter {i} {k}: {a[k]} vs {b[k]}")
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    print(f"  {what}: losses agree; largest |d| / bound " + ", ".join(
        f"{k} {v:.3f}" for k, v in top))


def _cyclegan_run(torch, np, cfg, device, n_iters):
    """n_iters CycleGAN iterations from the seeded init on seeded batches:
    (loss history, engine, state, first batch)."""
    from gcc_tpu_torch.engines.cyclegan import CycleGANEngine
    engine = CycleGANEngine(cfg, device=device)
    state = engine.init_state(seed=1)  # the same numbers on every device
    batches = make_batches(torch, np, 2 * n_iters, 1, cfg.crop_size, 1,
                           engine.device)
    hist = []
    for i in range(n_iters):
        state, m = engine.train_arch_step(state, batches[2 * i],
                                          batches[2 * i + 1], cfg.lr, 0.9)
        hist.append({k: float(v) for k, v in m.items()})
    return hist, engine, state, batches[0]


def _feeds_instance_norm(net, path):
    """Conv biases followed by an affine-free InstanceNorm: no gradient,
    they random-walk at +-lr on both sides (forward-inert)."""
    if not path.endswith("/bias"):
        return False
    if net.startswith(("g_", "tg_")):
        return not path.startswith("params/conv_out/")
    return net.startswith("td_") and path.startswith(
        ("params/conv_1/", "params/conv_2/", "params/conv_3/"))


def _agree_params(np, cfg, state_a, state_b, n_iters, what):
    """tests/test_cooperative_parity_cyclegan.py's classes after n_iters
    iterations: kernels and the rest within 2*lr*N*1.25 with a mean under
    lr/2 (isolated opposite Adam steps where a gradient is ~0), alphas
    within 2*arch_lr*N*1.25 with a mean under 2*arch_lr; InstanceNorm-fed
    biases not compared. The masked D's BatchNorm running stats (its convs
    have no bias) within 2*lr*N*1.25 with a mean under lr: they are the
    statistics of D's activations, which from iteration 0's arch step on
    see the generators' isolated opposite Adam steps through the fakes, and
    then D's own weights, each entry within 2*lr a step; from the same
    variables the stats agree to fp32 rounding (_same_weights_d). Prints
    each class's largest max|d| and mean|d| beside its bounds."""
    from gcc_tpu_torch.utils.weights import to_jax_nets

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", np.asarray(v, np.float64)

    walk = 2 * n_iters * 1.25
    classes = {"weights": (walk * cfg.lr, cfg.lr / 2),
               "alphas": (walk * cfg.arch_lr, 2 * cfg.arch_lr),
               "running stats": (walk * cfg.lr, cfg.lr)}
    worst = {c: [0.0, "-", 0.0, "-"] for c in classes}
    ja, jb = to_jax_nets(state_a), to_jax_nets(state_b)
    for net in ja:
        if net.startswith(("pool", "tpool")):
            continue
        other = dict(leaves(jb[net]))
        for path, a in leaves(ja[net]):
            if _feeds_instance_norm(net, path):
                continue
            d = np.abs(a - other[path])
            c = ("alphas" if path.startswith("arch/") else "running stats"
                 if path.startswith("batch_stats/") else "weights")
            bound, mean_bound = classes[c]
            w = worst[c]
            if d.max() > w[0]:
                w[:2] = float(d.max()), f"{net}/{path}"
            if d.mean() > w[2]:
                w[2:] = float(d.mean()), f"{net}/{path}"
            if not (d.max() < bound and d.mean() < mean_bound):
                fail(f"{what}: {net}/{path} max {d.max()} mean {d.mean()}, "
                     f"bounds {bound} and {mean_bound}")
    for c, (mx, at, mean, at_mean) in worst.items():
        print(f"  {what} {c}: max|d| {mx:.3e} ({at}; bound "
              f"{classes[c][0]:.1e}), mean|d| {mean:.3e} ({at_mean}; bound "
              f"{classes[c][1]:.1e})")
    print(f"  {what}: parameters agree")


def _same_weights_generate(torch, run_a, run_b, what):
    """Both engines' generators of each direction on one batch, with the
    second run's weights in both: the forward routes agree within 1e-5
    (on the H100 they differ by 1.1e-6 to 2.1e-6, fused vs unfused and card
    vs CPU)."""
    from gcc_tpu_torch.utils.weights import export_jax_variables
    from gcc_tpu_torch.utils.weights import load_jax_variables

    (_, eng_a, state_a, batch), (_, eng_b, state_b, _) = run_a, run_b
    for key in ("g_a", "g_b"):
        load_jax_variables(state_a.nets[key],
                           export_jax_variables(state_b.nets[key]))
    err = 0.0
    for direction, key in (("AtoB", "A"), ("BtoA", "B")):
        x = batch[key]
        out_a = eng_a.generate(state_a, x, direction).cpu()
        out_b = eng_b.generate(state_b, x.to(eng_b.device), direction).cpu()
        err = max(err, max_err(out_a, out_b))
    print(f"  {what}: generate from the same weights, both directions: "
          f"max|d| {err:.3e}")
    if not err < 1e-5:
        fail(f"{what}: generate differs by {err}")


def _same_weights_d(torch, run_a, run_b, what):
    """Both engines' masked D's from the second run's variables, one
    train-mode forward on the same batch: the outputs and the BatchNorm
    running statistics that forward writes agree within 1e-5."""
    from gcc_tpu_torch.utils.weights import export_jax_variables
    from gcc_tpu_torch.utils.weights import load_jax_variables

    (_, _, state_a, batch), (_, eng_b, state_b, _) = run_a, run_b
    err = {"output": 0.0, "running stats": 0.0}
    for net, key in (("d_a", "B"), ("d_b", "A")):
        d_a, d_b = state_a.nets[net], state_b.nets[net]
        load_jax_variables(d_a, export_jax_variables(d_b))
        with torch.no_grad():
            p_a, _ = d_a(batch[key])
            p_b, _ = d_b(batch[key].to(eng_b.device))
        err["output"] = max(err["output"], max_err(p_a.cpu(), p_b.cpu()))
        stats_b = dict(d_b.named_buffers())
        for name, t in d_a.named_buffers():
            err["running stats"] = max(err["running stats"], max_err(
                t.cpu(), stats_b[name].cpu()))
    print(f"  {what}: D from the same variables, one train-mode forward: "
          + ", ".join(f"{k} max|d| {v:.3e}" for k, v in err.items()))
    if not max(err.values()) < 1e-5:
        fail(f"{what}: D from the same variables differs: {err}")


def phase_cyclegan_agree(torch, np):
    from gcc_tpu_torch.config import Config
    from gcc_tpu_torch.ops import mobile_block as mb

    size = CYCLEGAN_AGREE_SIZE
    print(f"== phase 13: CycleGAN agreement, {size}px (the blocks at "
          f"{size // 4}px, the fused gate open), batch 1, ngf 8 / ndf 16, "
          f"teacher 16/16, lambda_weight 1e-3: (a) fused (kernels) against "
          f"unfused (cuDNN) engines, pools of 1, 2 iterations; (b) the card "
          f"(kernels) against the CPU, pools at 0, 3 iterations")
    kw = dict(ngf=8, ndf=16, teacher_ngf=16, teacher_ndf=16, crop_size=size,
              load_size=size, lambda_weight=1e-3)
    runs = {}
    for mode in ("on", "off"):
        before = mb.LAUNCHES["stage_fwd"]
        runs[mode] = _cyclegan_run(
            torch, np, cyclegan_config(Config, fused_resblock=mode,
                                       pool_size=1, **kw), "cuda", 2)
        grown = mb.LAUNCHES["stage_fwd"] - before
        if (grown > 0) != (mode == "on"):
            fail(f"fused_resblock {mode}: {grown} stage_fwd launches")
    _agree_losses(runs["on"][0], runs["off"][0], "(a) fused vs unfused")
    _agree_params(np, runs["on"][1].cfg, runs["on"][2], runs["off"][2], 2,
                  "(a)")
    _same_weights_generate(torch, runs["on"], runs["off"], "(a)")
    _same_weights_d(torch, runs["on"], runs["off"], "(a)")
    for dev in ("cuda", "cpu"):
        runs[dev] = _cyclegan_run(
            torch, np, cyclegan_config(Config, pool_size=0, **kw), dev, 3)
    _agree_losses(runs["cuda"][0], runs["cpu"][0], "(b) card vs CPU")
    _agree_params(np, runs["cuda"][1].cfg, runs["cuda"][2], runs["cpu"][2],
                  3, "(b)")
    _same_weights_generate(torch, runs["cuda"], runs["cpu"], "(b)")
    _same_weights_d(torch, runs["cuda"], runs["cpu"], "(b)")


def random_vgg19(np):
    """A torchvision-named VGG19 state dict of seeded He-scaled weights, so
    that the features neither vanish nor blow up: NOT the pretrained
    weights the reference's perceptual term uses."""
    from gcc_tpu_torch.metrics.vgg import VGG19_CONV_IDX, load_torch_vgg19
    rng = np.random.RandomState(0)
    sd, in_ch = {}, 3
    for idx in VGG19_CONV_IDX:
        out = 64 * min(2 ** sum(1 for p in (2, 7, 16, 25) if p < idx), 8)
        sd[f"features.{idx}.weight"] = (rng.randn(out, in_ch, 3, 3) * np.sqrt(
            2.0 / (9 * in_ch))).astype(np.float32)
        sd[f"features.{idx}.bias"] = np.zeros(out, np.float32)
        in_ch = out
    return load_torch_vgg19(sd)


def srgan_student(np):
    """Phase 14's student: SRResNet(ngf 24) pruned by the port's
    prune_srresnet(mode="scale") from spread weights to SRGAN_BUDGET GMACs
    at SRGAN_HR / 4 px; (filter_cfgs, GMACs)."""
    from gcc_tpu_torch.compress import prune_srresnet
    from gcc_tpu_torch.models.generators import SRResNet
    from gcc_tpu_torch.utils.weights import export_jax_variables

    w = SRGAN_WIDTHS
    tree = export_jax_variables(SRResNet(w["ngf"]))["params"]
    return prune_srresnet(spread_tree(np, tree, np.random.RandomState(0)),
                          mode="scale", n_channels=w["ngf"],
                          target_budget_g=SRGAN_BUDGET, tolerance_g=0.01,
                          lr_size=SRGAN_HR // 4)


def phase_srgan(torch, np, dtype=None, record=None):
    """Phase 14 (and phase 18 (d) with dtype bfloat16: the batches cast to
    it, generate on the fp32 batch, as the epoch-end eval runs)."""
    from gcc_tpu_torch.config import Config
    from gcc_tpu_torch.engines.srgan import SRGANEngine
    from gcc_tpu_torch.ops import flash_attention as fa
    from gcc_tpu_torch.ops import mobile_block as mb

    hr, batch, w = SRGAN_HR, SRGAN_BATCH, SRGAN_WIDTHS
    lr_size = hr // 4
    print(f"{'  (d) bf16 batches' if dtype else '== phase 14'}: SRGAN GCC "
          f"iteration (scripts/srgan/train.sh), "
          f"{hr}px from {lr_size}px (x4), batch {batch}, vanilla GAN, "
          f"teacher ngf {w['teacher_ngf']} / ndf {w['teacher_ndf']}, ndf "
          f"{w['ndf']} masked, content 0.1, gram 0.1; VGG19 perceptual term "
          f"on SEEDED RANDOM weights (not the pretrained ones), "
          f"lambda_SR_perceptual 1; 1 warm-up + {N_TIMED} timed")
    fc, gmacs = srgan_student(np)
    print(f"  student pruned by prune_srresnet(mode='scale') from spread "
          f"weights: filter_cfgs {fc}, {gmacs:.4f} GMACs")
    cfg = Config(model="srgan", gan_mode="vanilla", image_size=hr,
                 batch_size=batch, online_distillation=True,
                 darts_discriminator=True, lambda_content=0.1,
                 lambda_gram=0.1, lambda_SR_perceptual=1.0, lr=1e-4,
                 arch_lr=1e-4, **w)
    engine = SRGANEngine(cfg, filter_cfgs=fc, vgg_params=random_vgg19(np))
    rng = np.random.RandomState(0)
    batches = [{"lr": torch.from_numpy(rng.randn(
                    batch, 3, lr_size, lr_size).astype(np.float32))
                .to(engine.device),
                "hr": torch.from_numpy(rng.rand(batch, 3, hr, hr).astype(
                    np.float32) * 2 - 1).to(engine.device)}
               for _ in range(2 * (N_TIMED + 1))]
    for k in fa.LAUNCHES:
        fa.LAUNCHES[k] = 0
    gen_in = batches[0]["lr"]
    if dtype is not None:
        batches = [{k: v.to(dtype) for k, v in b.items()} for b in batches]
    drive(torch, engine, cfg, batches, gen_in, mb.LAUNCHES,
          {k: 0 for k in mb.LAUNCHES}, {}, "srgan path", out_size=hr,
          record=record)
    if any(fa.LAUNCHES.values()):
        fail(f"srgan path launched B1: {fa.LAUNCHES}")


def sync_time(torch, dev, fn, n=1):
    """Host seconds of n calls of fn, each ended by a synchronize."""
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n, out


def peak_gib(torch, dev):
    if dev.type != "cuda":
        return None
    return round(torch.cuda.max_memory_allocated() / 2 ** 30, 3)


def reset_peak(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def conv_flops(torch, net, x):
    """2 x the multiply-adds of every convolution of net on x."""
    total = [0]

    def hook(m, inp, out):
        total[0] += 2 * out.numel() * (m.in_channels // m.groups) * \
            m.kernel_size[0] * m.kernel_size[1]

    hooks = [m.register_forward_hook(hook) for m in net.modules()
             if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        net(x)
    for h in hooks:
        h.remove()
    return total[0]


def evaluator_profile(torch, fn, what):
    """One call of fn under torch.profiler: device time by group (cuDNN's
    convolutions, batch norm, the rest: ReLU, pools, concatenation, the
    resize and upsample) and the busy share of its wall time (a floor)."""
    kernels, wall_us = device_kernels(torch, fn)
    total = sum(t for _, t, _ in kernels)
    groups = {"convolutions": 0.0, "batch norm": 0.0, "other": 0.0}
    for name, t, _ in kernels:
        low = name.lower()
        if "bn_fw" in low or "batch_norm" in low:
            groups["batch norm"] += t
        elif any(k in low for k in CONV_MARKS):
            groups["convolutions"] += t
        else:
            groups["other"] += t
    print(f"    profile of {what}: device {total / 1e3:.3f} ms, wall "
          f"{wall_us / 1e3:.3f} ms, busy {total / max(wall_us, 1e-9):.3f}; "
          + ", ".join(f"{g} {t / max(total, 1e-9):.3f}"
                      for g, t in groups.items()))
    for name, t, n in sorted(kernels, key=lambda k: -k[1])[:5]:
        print(f"      {t / 1e3:9.3f} ms {n:5d}x  {name[:90]}")
    return {"device_ms": round(total / 1e3, 3),
            "busy": round(total / max(wall_us, 1e-9), 3),
            **{g.replace(" ", "_") + "_share": round(t / max(total, 1e-9), 3)
               for g, t in groups.items()}}


def rel_err(np, ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-30))


class TF32On:
    """TF32 on for cuDNN and matmul inside the block: (g)'s comparison."""

    def __init__(self, torch):
        self.b = torch.backends

    def __enter__(self):
        self.saved = (self.b.cudnn.allow_tf32, self.b.cuda.matmul.allow_tf32)
        self.b.cudnn.allow_tf32 = self.b.cuda.matmul.allow_tf32 = True

    def __exit__(self, *exc):
        self.b.cudnn.allow_tf32, self.b.cuda.matmul.allow_tf32 = self.saved


def phase_evaluators(torch, np, dev=None):
    """Phase 15: InceptionV3 FID and DRN-D-105 mIoU on the card, on seeded
    random weights (NOT the pretrained ones). Returns the evaluators
    record."""
    from gcc_tpu_torch.device import exact_fp32
    from gcc_tpu_torch.metrics.fid import activation_statistics
    from gcc_tpu_torch.metrics.inception import (FIDInceptionV3,
                                                 InceptionExtractor,
                                                 load_torch_fid_inception)

    dev = torch.device(dev or "cuda")
    cpu = torch.device("cpu")
    n_img, batch, size = FID_IMAGES, FID_BATCH, FID_SIZE
    print(f"== phase 15: the evaluators on the card, fp32 with TF32 off, "
          f"seeded random weights (NOT the pretrained ones): InceptionV3 "
          f"{n_img} images of {size}², batches of {batch}; DRN-D-105 at "
          f"{DRN_FULL[0]}x{DRN_FULL[1]}")
    rec = {}
    rng = np.random.RandomState(0)
    inc_sd = random_evaluator(np, FIDInceptionV3(), 0)
    card = InceptionExtractor(load_torch_fid_inception(inc_sd), dev, batch)
    host = InceptionExtractor(load_torch_fid_inception(inc_sd), cpu, batch)
    imgs = rng.uniform(-1, 1, (n_img, size, size, 3)).astype(np.float32)

    # (a) the full protocol through the extractor, and one batch's forward
    card.activations(imgs[:batch])  # warm-up
    reset_peak(torch, dev)
    secs, acts = sync_time(torch, dev, lambda: card.activations(imgs))
    u8 = torch.from_numpy(np.clip((imgs[:batch] + 1) / 2 * 255.0, 0, 255)
                          .astype(np.uint8)).to(dev).permute(0, 3, 1, 2)

    def one_batch():
        with torch.no_grad():
            return card.net(u8.float() / 255.0)

    with exact_fp32():
        batch_s, ref_batch = sync_time(torch, dev, one_batch, n=5)
    host_acts = host.activations(imgs[:4])
    rel = rel_err(np, acts[:4], host_acts)
    rec["inception"] = {
        "images": n_img, "size": size, "batch": batch,
        "images_per_s": round(n_img / secs, 3),
        "protocol_ms_per_batch": round(1e3 * secs / (n_img / batch), 3),
        "forward_ms_per_batch": round(1e3 * batch_s, 3),
        "peak_gib": peak_gib(torch, dev), "card_vs_cpu_rel": rel}
    print(f"  (a) InceptionV3: {n_img} images in {secs:.3f} s = "
          f"{n_img / secs:.3f} images/s through the extractor (uint8 round "
          f"trip on the host, batches of {batch}); one batch's forward "
          f"(resize + network) {1e3 * batch_s:.3f} ms; peak "
          f"{rec['inception']['peak_gib']} GiB; card vs CPU on 4 images "
          f"{rel:.3e} (bound 1e-4)")
    if not (acts.shape == (n_img, 2048) and np.isfinite(acts).all()
            and rel <= 1e-4):
        fail(f"InceptionV3: shape {acts.shape}, card vs CPU {rel}")
    if dev.type == "cuda":
        with exact_fp32():
            rec["inception"]["profile"] = evaluator_profile(
                torch, one_batch, f"one batch of {batch}")

    # (b) FID of two sets on the card and on the CPU. Each Fréchet distance
    # is the host's 2048-d sqrtm (seconds): the two run side by side in
    # worker processes of half the host's BLAS threads each
    other = rng.uniform(-0.5, 0.5, (FID_SET, size, size, 3)).astype(
        np.float32)
    card_b = card.activations(other)
    cpu_s, cpu_ab = sync_time(torch, cpu, lambda: (
        host.activations(imgs[:FID_SET]), host.activations(other)))
    with concurrent.futures.ProcessPoolExecutor(
            2, mp_context=multiprocessing.get_context("spawn"),
            initializer=blas_threads, initargs=(
                max(1, (os.cpu_count() or 2) // 2),)) as pool:
        jobs = {where: pool.submit(timed_frechet, activation_statistics(a)
                                   + activation_statistics(b))
                for where, a, b in (("card", acts[:FID_SET], card_b),
                                    ("cpu", cpu_ab[0], cpu_ab[1]))}
        fids = {}
        for where, job in jobs.items():
            fids[where], secs = job.result()
            fids[f"{where}_frechet_s"] = round(secs, 3)
    rel = abs(fids["card"] - fids["cpu"]) / abs(fids["cpu"])
    rec["fid"] = {"set": FID_SET, **fids, "card_vs_cpu_rel": rel,
                  "cpu_activations_s": round(cpu_s, 3)}
    print(f"  (b) FID of two sets of {FID_SET}: card {fids['card']!r}, CPU "
          f"{fids['cpu']!r}, relative difference {rel:.3e} (bound 1e-4); "
          f"frechet_distance (host sqrtm, 2048-d; two worker processes side "
          f"by side) {fids['card_frechet_s']} / "
          f"{fids['cpu_frechet_s']} s; the CPU's activations of the "
          f"{2 * FID_SET} images {cpu_s:.3f} s")
    if not rel <= 1e-4:
        fail(f"FID card {fids['card']} vs CPU {fids['cpu']}")
    rec.update(card_gpu_checks(torch, np, dev, rng, one_batch, batch_s,
                               ref_batch))
    return rec


def blas_threads(n):
    """A worker's BLAS threads, set before it imports numpy."""
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = str(n)


def timed_frechet(stats):
    """frechet_distance of (mu1, sigma1, mu2, sigma2) and its host seconds:
    phase 15 (b)'s work for a worker process."""
    from gcc_tpu_torch.metrics.fid import frechet_distance
    t0 = time.perf_counter()
    value = frechet_distance(*stats)
    return value, time.perf_counter() - t0


def card_gpu_checks(torch, np, dev, rng, one_batch, batch_s, ref_batch):
    """Phase 15 (c)-(e) and (g): DRN-D-105 and compute_miou on the card,
    then TF32 on as a finding (``one_batch``: (a)'s InceptionV3 batch
    forward, its fp32 seconds and output)."""
    import tempfile

    from gcc_tpu_torch.config import Config
    from gcc_tpu_torch.data.datasets import AlignedDataset
    from gcc_tpu_torch.device import exact_fp32
    from gcc_tpu_torch.metrics.miou import (DRNSeg, load_torch_drnseg,
                                            miou_from_hist, miou_histogram,
                                            upsample_logits_8x)

    rec = {}
    # (c) DRN-D-105 at the protocol's resolution, batch 1
    drn_sd = random_evaluator(np, DRNSeg(), 1)
    drn = load_torch_drnseg(drn_sd).to(dev)
    h, w = DRN_FULL
    x = torch.randn(1, 3, h, w, generator=torch.Generator().manual_seed(0)
                    ).to(dev)
    with exact_fp32():
        flops = conv_flops(torch, drn, x)

    def drn_forward(inp=x):
        with torch.no_grad():
            return upsample_logits_8x(drn(inp))

    with exact_fp32():
        drn_forward()  # warm-up
        reset_peak(torch, dev)
        drn_s, logits = sync_time(torch, dev, drn_forward, n=DRN_TIMED)
    bound = flops / FP32_FLOPS * 1e3
    rec["drn"] = {"hw": [h, w], "images": DRN_TIMED,
                  "ms_per_image": round(1e3 * drn_s, 3),
                  "tflop_per_image": round(flops / 1e12, 4),
                  "bound_ms": round(bound, 3), "bound_by": "operations",
                  "peak_gib": peak_gib(torch, dev)}
    print(f"  (c) DRN-D-105 at {h}x{w}, batch 1: {1e3 * drn_s:.3f} ms an "
          f"image over {DRN_TIMED} (convolutions {flops / 1e12:.4f} TFLOP; "
          f"fp32 bound {bound:.3f} ms at {FP32_FLOPS / 1e12:.0f} TFLOP/s, "
          f"{bound / (1e3 * drn_s):.3f} of it); peak "
          f"{rec['drn']['peak_gib']} GiB")
    if not (logits.shape == (1, 19, h, w) and torch.isfinite(logits).all()):
        fail(f"DRN: logits {tuple(logits.shape)}, finite "
             f"{bool(torch.isfinite(logits).all())}")
    del logits
    if dev.type == "cuda":
        with exact_fp32():
            rec["drn"]["profile"] = evaluator_profile(torch, drn_forward,
                                                      "one image")

    # (d) DRN on the card against the CPU
    ah, aw = DRN_AGREE
    xs = torch.randn(1, 3, ah, aw, generator=torch.Generator().manual_seed(1))
    with exact_fp32():
        ours = drn_forward(xs.to(dev)).cpu()
    host_drn = load_torch_drnseg(drn_sd)
    with torch.no_grad():
        ref = upsample_logits_8x(host_drn(xs))
    rel = rel_err(np, ours.numpy(), ref.numpy())
    agree = float((ours.argmax(1) == ref.argmax(1)).float().mean())
    rec["drn_agree"] = {"hw": [ah, aw], "rel": rel, "argmax_agree": agree}
    print(f"  (d) DRN card vs CPU at {ah}x{aw}: logits {rel:.3e} (bound "
          f"1e-4), argmax agreement {agree:.6f}")
    if not (rel <= 1e-4 and agree >= 0.999):
        fail(f"DRN card vs CPU: {rel}, argmax {agree}")

    # (e) compute_miou end to end on a cityscapes-like root
    with tempfile.TemporaryDirectory() as tmp:
        names = write_aligned_root(np, tmp, {"val": MIOU_IMAGES}, seed=2)
        counted = write_labels(np, tmp, names["val"], DRN_FULL, seed=3)
        np.savez(f"{tmp}/drn.npz", **drn_sd)
        cfg = Config(dataroot=tmp, phase="val", drn_path=f"{tmp}/drn.npz")
        fakes = rng.uniform(-1, 1, (MIOU_IMAGES, 256, 256, 3)).astype(
            np.float32)
        miou_s, hist = sync_time(torch, dev, lambda: miou_histogram(
            cfg, fakes, AlignedDataset(cfg), device=dev))
    value = miou_from_hist(hist)
    rec["miou"] = {"images": MIOU_IMAGES, "label_hw": list(DRN_FULL),
                   "miou": value, "pixels": int(hist.sum()),
                   "ms_per_image": round(1e3 * miou_s / MIOU_IMAGES, 3)}
    print(f"  (e) compute_miou, {MIOU_IMAGES} fakes of 256² against labels "
          f"at {h}x{w}: mIoU {value}, histogram {int(hist.sum())} pixels "
          f"(labels' counted {counted}); {1e3 * miou_s / MIOU_IMAGES:.3f} ms "
          f"an image end to end, loading --drn_path included")
    if int(hist.sum()) != counted or not math.isfinite(value):
        fail(f"compute_miou: {value}, {hist.sum()} pixels of {counted}")

    # (g) TF32 on, as a finding only: the evaluators keep it off
    with TF32On(torch):
        tf_batch_s, tf_batch = sync_time(torch, dev, one_batch, n=5)
        tf_drn_s, _ = sync_time(torch, dev, drn_forward, n=DRN_TIMED)
        tf_small = drn_forward(xs.to(dev)).cpu()
    rec["tf32"] = {
        "inception_forward_ms_per_batch": round(1e3 * tf_batch_s, 3),
        "inception_rel": rel_err(np, tf_batch.cpu().numpy(),
                                 ref_batch.cpu().numpy()),
        "drn_ms_per_image": round(1e3 * tf_drn_s, 3),
        "drn_rel": rel_err(np, tf_small.numpy(), ours.numpy()),
        "drn_argmax_agree": float((tf_small.argmax(1) == ours.argmax(1))
                                  .float().mean())}
    tf = rec["tf32"]
    print(f"  (g) TF32 on (a finding; the evaluators keep it off): "
          f"InceptionV3 batch {1e3 * tf_batch_s:.3f} ms (fp32 "
          f"{1e3 * batch_s:.3f}), activations {tf['inception_rel']:.3e} from "
          f"fp32's; DRN {1e3 * tf_drn_s:.3f} ms an image (fp32 "
          f"{1e3 * drn_s:.3f}), logits {tf['drn_rel']:.3e}, argmax "
          f"agreement {tf['drn_argmax_agree']:.6f}")
    return rec


# phase 16: cityscapes' train split (pix2pix's cityscapes: 2975 AB pairs of
# 512x256) packed at load 256; maps' flags (load 286, crop 256, flips) on
# MAPS_PAIRS pairs in batches of MAPS_BATCH for MAPS_BATCHES batches; the
# CLI runs of (c) take one epoch of PIPE_ITERS iterations; (d) holds the
# guard to GUARD_TOL at U-Net batch 128 and CycleGAN batch 1 and shows
# strict at GUARD_OVER, a U-Net batch the card cannot hold
CITYSCAPES_PAIRS, CITYSCAPES_SIZE = 2975, 256
MAPS_PAIRS, MAPS_BATCH, MAPS_BATCHES = 512, 128, 8
PIPE_ITERS, SAGAN_FACE = 20, (218, 178)
GUARD_TOL, GUARD_OVER = 0.05, 512


def write_images(np, folder, n, h, w, seed, pair=False, distinct=128,
                 threads=8):
    """n PNGs of h x w (side-by-side AB pairs of h x 2w with pair) written
    by the port's PNG writer on threads: a smooth random field (an 8x8
    field resized bicubically) and, for A, its edge-like rendition. File i
    holds image i % distinct: every file is decoded on its own, and the
    writing stays a small part of the phase."""
    from gcc_tpu_torch.data.resample import BICUBIC, resize
    from gcc_tpu_torch.utils.image import png_bytes

    os.makedirs(folder, exist_ok=True)

    def encode(i):
        rng = np.random.RandomState(seed * 1000003 + i)
        b = resize((rng.rand(8, 8, 3) * 255).astype(np.uint8), (w, h),
                   BICUBIC)
        if pair:
            f = b.astype(np.float32) / 127.5 - 1
            a = ((np.sign(f) * np.abs(f) ** 0.5 + 1) * 127.5).clip(
                0, 255).astype(np.uint8)
            b = np.concatenate([a, b], 1)
        return png_bytes(b)

    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        files = list(pool.map(encode, range(min(n, distinct))))
    for i in range(n):
        with open(os.path.join(folder, f"{i:05d}.png"), "wb") as fh:
            fh.write(files[i % len(files)])


def pack_root(src, flags, phase, extra=""):
    """python -m gcc_tpu_torch.cli.prepare in this process: (seconds, the
    packed root, its phase's store bytes)."""
    import contextlib
    import io

    from gcc_tpu_torch.cli import prepare

    out = src.rstrip("/") + "_packed"
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = prepare.main(f"{flags} --dataroot {src} --phase {phase} "
                          f"--pack_output {out} --num_threads 8{extra}"
                          .split())
    dt = time.perf_counter() - t0
    if rc != 0:
        fail(f"cli.prepare {src} {phase}: exit code {rc}")
    with open(os.path.join(out, "gcc_pack.json")) as f:
        keys = json.load(f)["phases"][phase]["keys"].values()
    return dt, out, sum(os.path.getsize(os.path.join(out, k["bin"]))
                        for k in keys)


def pipe_cache_vs_host(torch, np, root, rec):
    """(b) maps' flags on a packed root: the device cache's crops against
    PackedDataset's over MAPS_BATCHES batches of MAPS_BATCH (two epochs'
    orders), uint8 exactly, float32 within 1 ulp, the same paths; ms per
    batch of each path."""
    from gcc_tpu_torch import config
    from gcc_tpu_torch.data.device_cache import DeviceCacheLoader
    from gcc_tpu_torch.data.loader import Loader
    from gcc_tpu_torch.data.packed import PackedDataset, device_normalize

    cfg = config.parse(f"--dataroot {root} --model pix2pix --batch_size "
                       f"{MAPS_BATCH}".split())
    if (cfg.load_size, cfg.crop_size, cfg.no_flip) != (286, 256, False):
        fail(f"maps preset: load {cfg.load_size} crop {cfg.crop_size} "
             f"no_flip {cfg.no_flip}")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cache = DeviceCacheLoader(PackedDataset(cfg, seed=0), MAPS_BATCH, dev,
                              seed=0, drop_last=True)
    torch.cuda.synchronize()
    upload = time.perf_counter() - t0
    host = PackedDataset(cfg, seed=0, out_dtype="uint8")
    hl = Loader(host, MAPS_BATCH, seed=0, drop_last=True)
    one_ulp = float(np.spacing(np.float32(1.0)))
    t_cache, t_host, t_up, n, worst = [], [], [], 0, 0.0
    for epoch in (1, 2):
        cache.set_epoch(epoch)
        hl.set_epoch(epoch)
        for idx_c, idx_h in zip(cache._index_batches(), hl._index_batches()):
            t0 = time.perf_counter()
            args, paths = cache.param_batch(idx_c)
            crops = cache.crops(args)
            out = cache.materialize(args)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            hb = host.get_batch(idx_h)
            t2 = time.perf_counter()
            up = device_normalize({k: torch.from_numpy(hb[k]).to(dev)
                                   for k in ("A", "B")})
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            t_cache.append(t1 - t0)
            t_host.append(t2 - t1)
            t_up.append(t3 - t2)
            for k in ("A", "B"):
                if paths[f"{k}_paths"] != hb[f"{k}_paths"]:
                    fail(f"(b) batch {n}: {k} paths differ")
                if not torch.equal(crops[k].cpu(), torch.from_numpy(hb[k])):
                    fail(f"(b) batch {n}: {k} uint8 crops differ")
                want = (hb[k].astype(np.float32) / 255.0) * 2.0 - 1.0
                got = out[k].permute(0, 2, 3, 1).cpu().numpy()
                d = float(np.abs(got - want).max())
                worst = max(worst, d)
                if not d <= one_ulp:
                    fail(f"(b) batch {n}: {k} float32 off by {d}")
                if not torch.equal(up[k], out[k]):
                    fail(f"(b) batch {n}: {k} host upload + normalize "
                         f"differs from the cache's")
            n += 1
    if n != MAPS_BATCHES:
        fail(f"(b) compared {n} batches, expected {MAPS_BATCHES}")
    ms = (lambda xs: round(1e3 * sum(xs[1:]) / len(xs[1:]), 3))
    rec["maps"] = {"pairs": MAPS_PAIRS, "batch": MAPS_BATCH, "batches": n,
                   "store_bytes": host.total_bytes(),
                   "upload_s": round(upload, 3), "max_abs_err": worst,
                   "cache_ms": ms(t_cache), "host_batch_ms": ms(t_host),
                   "host_upload_normalize_ms": ms(t_up)}
    print(f"  (b) maps' flags (load 286, crop 256, flips), {MAPS_PAIRS} pairs "
          f"({host.total_bytes()} bytes, uploaded in {upload:.3f} s): "
          f"{n} batches of {MAPS_BATCH}, uint8 crops and paths equal, "
          f"float32 max|d| {worst:.3e} (1 ulp {one_ulp:.3e}); ms a batch "
          f"(mean of {n - 1} after the first): cache (draw + gather + "
          f"normalize) {rec['maps']['cache_ms']}, host get_batch "
          f"{rec['maps']['host_batch_ms']} + upload and normalize "
          f"{rec['maps']['host_upload_normalize_ms']}")


def pipe_cli(torch, name, argv, per_iter, counters, records, rec):
    """One cli.train run of phase 16 (c): the launches of every step call
    (the guard's measurement included) equal per_iter; ms per iteration
    over the steady iterations (after the guard's call and the first),
    the loader's wait and the guard's and cache's log lines."""
    clock, _, lines = run_cli(torch, name, argv, counters, records)
    calls = clock.calls
    launched = [{k: g[k] for k in per_iter} for _, _, g in calls]
    if len(calls) < PIPE_ITERS or any(g != per_iter for g in launched):
        fail(f"{name}: {len(calls)} step calls, launches {launched}, "
             f"expected {per_iter} in each of at least {PIPE_ITERS}")
    ends = [t1 for _, t1, _ in calls[1:]]
    gaps = [b - a for a, b in zip(ends, ends[1:])]
    inside = [t1 - t0 for t0, t1, _ in calls[2:]]
    wait = [float(x.split("waited ")[1].split(" ms")[0]) for x in lines
            if x.startswith("data: waited")]
    guard = [x for x in lines if x.startswith("memory guard")]
    if not guard or not wait:
        fail(f"{name}: no memory guard or data line in {lines}")
    rec[name] = {"iterations": len(calls) - 1,
                 "ms_per_iter": round(1e3 * sum(gaps) / len(gaps), 3),
                 "engine_ms": round(1e3 * sum(inside) / len(inside), 3),
                 "loader_wait_ms": wait[0],
                 "launches": {k: counters[f][k] for f, c in counters.items()
                              for k in c if k in per_iter}}
    print(f"  {name}: {rec[name]['ms_per_iter']} ms a CLI iteration over "
          f"{len(gaps)} steady iterations (engine step "
          f"{rec[name]['engine_ms']} ms), the loader's wait {wait[0]} ms an "
          f"iteration; launches per step call {per_iter}")
    return rec[name]["launches"]


def pipe_guard(torch, np, rec):
    """(d) the guard's projected peak against max_memory_allocated over the
    real first step, at phase 9's U-Net (batch UNET_BATCH) and phase 12's
    CycleGAN (batch 1); strict at U-Net batch GUARD_OVER."""
    from gcc_tpu_torch.compress import cyclegan_reference_cfgs
    from gcc_tpu_torch.config import Config
    from gcc_tpu_torch.engines.cyclegan import CycleGANEngine
    from gcc_tpu_torch.utils import memory_guard as mg

    class Log:
        def info(self, msg):
            print(f"    {msg}")

        warning = info

    def case(what, engine, cfg, batch):
        state = engine.init_state(seed=0)
        b, v = make_batches(torch, np, 2, batch, cfg.crop_size, 0,
                            engine.device)

        def step(n):
            return engine.train_arch_step(
                state, {k: x[:n] for k, x in b.items()},
                {k: x[:n] for k, x in v.items()}, cfg.lr, 0.9)

        t0 = time.perf_counter()
        r = mg.check_step(step, state, batch, engine.device, logger=Log(),
                          strict=True)
        guard_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(batch)
        measured = mg._read_peak(engine.device)
        err = abs(r["peak_bytes"] - measured) / measured
        rec[what] = {"projected_bytes": r["peak_bytes"],
                     "measured_bytes": measured, "rel_err": round(err, 5),
                     "guard_s": round(guard_s, 3),
                     "hbm_bytes": r["hbm_bytes"]}
        print(f"  (d) {what}: projected {r['peak_bytes'] / 2**30:.3f} GiB, "
              f"measured over the real first step {measured / 2**30:.3f} "
              f"GiB: {100 * err:.3f} % apart (the guard took "
              f"{guard_s:.3f} s)")
        if not err <= GUARD_TOL:
            fail(f"(d) {what}: projected {r['peak_bytes']} vs measured "
                 f"{measured}")
        return state, step

    engine, cfg = unet_engine(torch, np, UNET_BATCH)
    case(f"unet batch {UNET_BATCH}", engine, cfg, UNET_BATCH)
    state = engine.init_state(seed=0)
    big, bigv = make_batches(torch, np, 2, GUARD_OVER, cfg.crop_size, 0,
                             engine.device)
    over = (lambda n: engine.train_arch_step(
        state, {k: x[:n] for k, x in big.items()},
        {k: x[:n] for k, x in bigv.items()}, cfg.lr, 0.9))
    t0 = time.perf_counter()
    try:
        mg.check_step(over, state, GUARD_OVER, engine.device, logger=Log(),
                      strict=True)
    except mg.MemoryGuardError as e:
        rec["strict"] = {"batch": GUARD_OVER, "message": str(e),
                         "seconds": round(time.perf_counter() - t0, 3)}
        print(f"  (d) strict at U-Net batch {GUARD_OVER} raised "
              f"MemoryGuardError in {rec['strict']['seconds']} s: {e}")
    else:
        fail(f"(d) strict did not raise at U-Net batch {GUARD_OVER}")
    if "largest projected-to-fit batch" not in rec["strict"]["message"]:
        fail("(d) strict's message suggests no batch")
    del engine, state, big, bigv, over
    cfg_a, cfg_b = cyclegan_reference_cfgs()
    cfg = cyclegan_config(Config, crop_size=CYCLEGAN_SIZE,
                          load_size=CYCLEGAN_SIZE, **CYCLEGAN_WIDTHS)
    case("cyclegan batch 1", CycleGANEngine(cfg, cfg_AtoB=cfg_a,
                                            cfg_BtoA=cfg_b), cfg, 1)


def pipe_native(torch, np, src, rec):
    """(e) the native engine: its items against the numpy path's within one
    uint8 level, and images/s of each path through the Loader's threads
    (decode included) over one batch of src's pairs at maps' flags."""
    from gcc_tpu_torch import config, native
    from gcc_tpu_torch.data import build_dataset
    from gcc_tpu_torch.data.loader import Loader

    t0 = time.perf_counter()
    native.library()
    built = time.perf_counter() - t0
    argv = (f"--dataroot {src} --model pix2pix --batch_size {MAPS_BATCH} "
            f"--max_dataset_size {MAPS_BATCH}")
    ds = {flag: build_dataset(config.parse(f"{argv}{flag}".split()), seed=3)
          for flag in ("", " --native_loader")}
    worst = 0.0
    for i in range(min(16, len(ds[""]))):
        a, b = ds[" --native_loader"][i], ds[""][i]
        for k in ("A", "B"):
            worst = max(worst, float(np.abs(a[k] - b[k]).max()))
    if not worst <= 2.0 / 255.0 + 1e-6:
        fail(f"(e) native items off the numpy path's by {worst}")
    rates = {}
    for flag, d in ds.items():
        loader = Loader(d, MAPS_BATCH, num_threads=8, seed=0, drop_last=True)
        t0 = time.perf_counter()
        n = sum(2 * len(b["A"]) for b in loader)  # A and B halves
        rates["native" if flag else "numpy"] = round(
            n / (time.perf_counter() - t0), 3)
    rec["native"] = {"build_s": round(built, 3), "max_abs_err": worst,
                     "images_per_s": rates}
    print(f"  (e) native engine built in {built:.3f} s (g++); its items "
          f"within {worst:.3e} of the numpy path's (one level "
          f"{2 / 255:.3e}); images/s through the Loader's 8 threads, decode "
          f"included: numpy {rates['numpy']}, native {rates['native']}")


def phase_pipeline(torch, np, smi):
    """Phase 16: the input pipeline on the card."""
    import tempfile

    from gcc_tpu_torch.ops import flash_attention as fa
    from gcc_tpu_torch.ops import mobile_block as mb

    print(f"== phase 16: the input pipeline on the card ({smi}): packed "
          f"roots (cli.prepare), the device cache, the memory guard, the "
          f"native engine")
    t_phase = time.perf_counter()
    rec, records, by_path = {}, [], {}
    counters = {"B2": mb.LAUNCHES, "B1": fa.LAUNCHES}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) cityscapes' train split, packed at load 256
        city = os.path.join(tmp, "cityscapes")
        t0 = time.perf_counter()
        write_images(np, f"{city}/train", CITYSCAPES_PAIRS, CITYSCAPES_SIZE,
                     CITYSCAPES_SIZE, 0, pair=True)
        write_images(np, f"{city}/val", 4, CITYSCAPES_SIZE, CITYSCAPES_SIZE,
                     1, pair=True)
        wrote = time.perf_counter() - t0
        flags = (f"--model pix2pix --dataset_mode aligned --load_size "
                 f"{CITYSCAPES_SIZE}")
        secs, city_p, nbytes = pack_root(city, flags, "train")
        want = CITYSCAPES_PAIRS * 2 * CITYSCAPES_SIZE ** 2 * 3
        rec["cityscapes"] = {"pairs": CITYSCAPES_PAIRS,
                             "write_s": round(wrote, 3),
                             "pack_s": round(secs, 3), "store_bytes": nbytes}
        print(f"  (a) {CITYSCAPES_PAIRS} AB pairs of {2 * CITYSCAPES_SIZE}x"
              f"{CITYSCAPES_SIZE} written in {wrote:.3f} s; cli.prepare at "
              f"load {CITYSCAPES_SIZE} packed them in "
              f"{secs:.3f} s ({CITYSCAPES_PAIRS / secs:.3f} pairs/s, 8 "
              f"threads): {nbytes} bytes")
        if nbytes != want:
            fail(f"(a) store of {nbytes} bytes, expected {want}")
        pack_root(city, flags, "val")
        # (b) maps' flags
        maps = os.path.join(tmp, "maps")
        write_images(np, f"{maps}/train", MAPS_PAIRS, 256, 256, 2, pair=True)
        _, maps_p, _ = pack_root(maps, "--model pix2pix", "train")
        pipe_cache_vs_host(torch, np, maps_p, rec)
        # (c) cli.train from packed roots: cached, streaming, image folder
        res = (f"--model pix2pix --backbone resnet --fused_resblock on "
               f"--ngf 24 --ndf 128 --teacher_ngf 64 --teacher_ndf 128 "
               f"--online_distillation --darts_discriminator --lambda_content "
               f"50 --lambda_gram 1e4 --batch_size 4 --max_dataset_size "
               f"{4 * PIPE_ITERS} --n_epochs 1 --n_epochs_decay 0 "
               f"--save_epoch_freq 1 --print_freq {4 * PIPE_ITERS} "
               f"--num_threads 4 --memory_guard strict --compute_dtype "
               f"float32 --checkpoints_dir {tmp}").split()
        faces = os.path.join(tmp, "celeb")
        write_images(np, f"{faces}/train", 64 * PIPE_ITERS, *SAGAN_FACE, 3)
        write_images(np, f"{faces}/val", 32, *SAGAN_FACE, 4)
        sg_flags = "--model sagan --dataset_mode sa"
        _, faces_p, _ = pack_root(faces, sg_flags, "train")
        pack_root(faces, sg_flags, "val")
        sg = (f"{sg_flags} --ngf 48 --ndf 64 --teacher_ngf 64 --teacher_ndf "
              f"64 --batch_size 64 --n_epochs 1 --save_epoch_freq 1 "
              f"--print_freq {64 * PIPE_ITERS} --darts_discriminator "
              f"--threshold 0.1 --online_distillation --lambda_L1 0 "
              f"--lambda_content 1 --lambda_gram 1 --num_threads 4 "
              f"--memory_guard strict --compute_dtype float32 "
              f"--checkpoints_dir {tmp}").split()
        print(f"  (c) cli.train, one epoch of {PIPE_ITERS} iterations from "
              f"each source, --memory_guard strict")
        for path, argv, per_iter, (packed, folder) in (
                ("pix2pix resnet", res, PER_ITER, (city_p, city)),
                ("sagan", sg, ATTN_PER_ITER, (faces_p, faces))):
            for source, extra in (
                    ("cached", f"--dataroot {packed} --device_cache on"),
                    ("packed stream", f"--dataroot {packed} --device_cache "
                                      f"off"),
                    ("image folder", f"--dataroot {folder}")):
                name = f"{path}, {source}"
                launches = pipe_cli(
                    torch, name, argv + extra.split() + [
                        "--name", name.replace(" ", "_").replace(",", "")],
                    per_iter, counters, records, rec)
                if source == "cached":
                    by_path.update({k: {f"{path} (packed, cached)": v}
                                    for k, v in launches.items()})
        # (e) the native engine on maps' source folder
        pipe_native(torch, np, maps, rec)
    # (d) the guard's accuracy, on a card free of (c)'s runs
    pipe_guard(torch, np, rec)
    rec["seconds"] = round(time.perf_counter() - t_phase, 3)
    print(f"  phase 16 took {rec['seconds']} s")
    return rec, by_path


# phase 17: the bf16 compute path (--compute_dtype bfloat16, the default).
# B2's bf16 kernels at the main path's teacher and student stages, with relu
# and with a residual, and at CycleGAN's batch-1 teacher stage (phase 18
# (c)'s path)
BF16_CASES = [("teacher_relu", 4, 256, 256, 64, True, False),
              ("teacher_res", 4, 256, 256, 64, False, True),
              ("student_relu", 4, 112, 72, 64, True, False),
              ("student_res", 4, 72, 112, 64, False, True),
              ("cg_teacher_relu", 1, 256, 256, 64, True, False),
              ("cg_teacher_res", 1, 256, 256, 64, False, True)]
PER_ITER_BF16 = {"stage_fwd_bf16": 108, "stage_bwd_pw_bf16": 36,
                 "stage_bwd_dw_bf16": 36}
# tests/test_torch_bf16.py's configurations for (d)
BF16_AGREE = {
    "unet": (dict(backbone="unet", num_downs=5, fused_resblock="auto"),
             [3, 6, 12, 20, 24, 20, 12, 6, 5]),
    "resnet_fused": (dict(backbone="resnet", fused_resblock="on"),
                     [3, 6, 12, 5, 12] + [0, 0] * 7 + [3, 12, 6, 3])}
# (d)'s losses, by the update that computes them
LOSS_GROUPS = {"D": ("D_fake", "D_real"),
               "G": ("G_GAN", "G_L1", "content", "gram"),
               "arch": ("D_arch", "D_arch_diff", "teacher_D_arch_diff")}
# (d)'s bounds of the composed iteration, 1/4 unless named (measured on the
# card, PR 11). The named results read a resnet teacher forward in which the
# card's and the CPU's fp32 convolution sums first round to different bf16
# neighbours (_first_difference), which every later layer spreads; a bound
# is set from the measurement up to 1/2, and None leaves a result above
# that without one in the composed iteration: its discriminator work is
# held to 1/4 on the CPU's own generator outputs instead (_disc_work), the
# teacher forward by _first_difference
AGREE_BOUNDS = {("resnet_fused", "grad td"): 0.35,  # measured 0.245
                ("resnet_fused", "stats td"): 0.4,  # measured 0.296
                ("resnet_fused", "grad tg"): None,  # measured 0.463
                ("resnet_fused", "loss arch"): None}  # measured 5.27


def check_bf16(torch, name, got, ref, rec):
    from gcc_tpu_torch.ops import kernels
    from gcc_tpu_torch.ops import mobile_block as mb

    ulps, err, share = kernels.bf16_err(got, ref)
    print(f"    {name:<14} {ulps:.3f} bf16 ulps of max|ref| (max|d| "
          f"{err:.3e}), {share:.2e} of elements differ; tol {mb.BF16_ULPS} "
          f"ulps, {mb.BF16_SHARE}")
    if got.dtype != torch.bfloat16 or not (ulps <= mb.BF16_ULPS
                                           and share <= mb.BF16_SHARE):
        fail(f"bf16 {name}: {got.dtype}, {ulps} ulps, share {share}")
    rec["max_ulps"] = max(rec["max_ulps"], ulps)
    rec["max_share"] = max(rec["max_share"], share)
    rec["max_abs_err"] = max(rec["max_abs_err"], err)


def check_dw(torch, name, got, ref, rec):
    from gcc_tpu_torch.ops import mobile_block as mb

    rel = max_err(got, ref) / float(ref.abs().max())
    print(f"    {name:<14} max|d| {rel:.3e} of max|ref| (tol {mb.BF16_DW})")
    if got.dtype != torch.float32 or not rel <= mb.BF16_DW:
        fail(f"bf16 {name}: {got.dtype}, relative error {rel}")
    rec["max_rel_dw"] = max(rec["max_rel_dw"], rel)
    rec["max_abs_err"] = max(rec["max_abs_err"], max_err(got, ref))


def host_us(torch, fn, n=200):
    """The host's us a call of fn: perf_counter over n enqueued calls,
    before the synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def in_turns(torch, fns, rounds=3, n=20, clock=cuda_ms):
    """Median time a call of each of fns ({name: fn}) over rounds of n
    calls by clock (CUDA-event ms, or host_us), timed in turns (the order
    reversed every other round)."""
    times = {k: [] for k in fns}
    for r in range(rounds):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            times[k].append(clock(torch, fns[k], n))
    return {k: sorted(v)[len(v) // 2] for k, v in times.items()}


def parent_bf16_calls(torch, libs, x, dwk, pwk, res, relu, g, ahat, bhat,
                      rstd_a, rstd_b, gah):
    """The earlier B2 sources' bf16 entry points as their wrapper called them
    (the same checks; the outputs and scratch allocated each call, the
    depthwise backward's per-plane partials too): libs = (mobile_block.cu's
    library, mobile_block_bf16.cu's). Returns (forward, pointwise backward,
    depthwise backward), each a function of no argument."""
    from gcc_tpu_torch.ops import kernels
    from gcc_tpu_torch.ops import mobile_block as mb

    fp32_lib, lib = libs
    (B, C, H, W), M, dev, dt = x.shape, pwk.shape[0], x.device, x.dtype
    p = kernels.ptr
    sms = kernels.sm_count(dev.index)
    n_part = lib.gcc_stage_bwd_pw_bf16_partials(B, C, M, H, W, sms)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def fwd():
        kernels.check(dev, "x", x, (B, C, H, W), dt)
        kernels.check(dev, "dwk", dwk, (C, 1, 3, 3))
        kernels.check(dev, "pwk", pwk, (M, C, 1, 1))
        if res is not None:
            kernels.check(dev, "residual", res, (B, M, H, W), dt)
        y = torch.empty(B, M, H, W, device=dev, dtype=dt)
        outs = (y, torch.empty_like(x), torch.empty_like(y),
                torch.empty(B, C, device=dev), torch.empty(B, M, device=dev))
        err = lib.gcc_stage_fwd_bf16(
            p(x), p(dwk), p(pwk), p(res), *map(p, outs), B, C, M, H, W,
            int(relu), sms, stream())
        if err:
            fail(f"the earlier gcc_stage_fwd_bf16 failed with {err}")
        return outs

    def bwd():
        kernels.check(dev, "g", g, (B, M, H, W), dt)
        kernels.check(dev, "ahat", ahat, (B, C, H, W), dt)
        kernels.check(dev, "bhat", bhat, (B, M, H, W), dt)
        kernels.check(dev, "rstd_b", rstd_b, (B, M))
        kernels.check(dev, "pwk", pwk, (M, C, 1, 1))
        gah_o, gpw = torch.empty_like(ahat), torch.empty_like(pwk)
        # scratch: gb, then the dW partials, in one allocation
        gb_bytes = -(-g.numel() * g.element_size() // 256) * 256
        scratch = torch.empty(gb_bytes + n_part * M * C * 4, device=dev,
                              dtype=torch.uint8)
        err = lib.gcc_stage_bwd_pw_bf16(
            p(g), p(ahat), p(bhat), p(rstd_b), p(pwk), scratch.data_ptr(),
            p(gah_o), scratch.data_ptr() + gb_bytes, p(gpw), B, C, M, H, W,
            int(relu), sms, stream())
        if err:
            fail(f"the earlier gcc_stage_bwd_pw_bf16 failed with {err}")
        return gah_o, gpw

    def bwd_dw():
        kernels.check(dev, "gah", gah, (B, C, H, W), dt)
        kernels.check(dev, "ahat", ahat, (B, C, H, W), dt)
        kernels.check(dev, "rstd_a", rstd_a, (B, C))
        kernels.check(dev, "x", x, (B, C, H, W), dt)
        kernels.check(dev, "dwk", dwk, (C, 1, 3, 3))
        gx, gdw = torch.empty_like(x), torch.empty_like(dwk)
        part = torch.empty(B, C, 9, device=dev)
        err = fp32_lib.gcc_stage_bwd_dw_bf16(
            p(gah), p(ahat), p(rstd_a), p(x), p(dwk), p(gx), p(part), p(gdw),
            B, C, H, W, stream())
        if err:
            fail(f"the earlier gcc_stage_bwd_dw_bf16 failed with {err}")
        return gx, gdw

    return fwd, bwd, bwd_dw


def bits(t):
    """A tensor's bits, for bit-for-bit comparisons (-0 is not 0)."""
    import torch

    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def bf16_kernels(torch, F, parent=None, ptxas=None):
    """(a) The three bf16 entry points against their bf16 plain versions,
    each on the plain version's inputs; two calls repeat the bits; times
    of the kernel, the plain version and cuDNN's bf16 route, bounds at
    3.35 TB/s and 989 TFLOP/s (bf16) / 67 (fp32 CUDA cores), device time by
    launch, cuDNN's bf16 depthwise convolution backward as the depthwise
    backward's partial yardstick; where the earlier B2 sources were built
    (parent: their two libraries), the depthwise backward's dx (and dW_dw)
    bit for bit theirs, and their three bf16 entry points timed in turns
    with the new ones: event ms, device ms, the host's us a call."""
    from gcc_tpu_torch.ops import kernels
    from gcc_tpu_torch.ops import mobile_block as mb

    if ptxas is not None:
        print_ptxas(ptxas, "(a) mobile_block_bf16.cu")
    bf = torch.bfloat16
    record = {k: {"max_abs_err": 0.0, "max_ulps": 0.0, "max_share": 0.0,
                  "max_rel_dw": 0.0} for k in PER_ITER_BF16}
    gen = torch.Generator().manual_seed(0)
    for case, B, C, M, S, relu, has_res in BF16_CASES:
        print(f"  (a) {case}: B={B} C={C} M={M} {S}x{S} relu={relu} "
              f"res={has_res}, bf16")

        def rnd(*shape, scale=1.0, dtype=torch.float32):
            return (torch.randn(*shape, generator=gen) * scale).to(
                "cuda", dtype)

        x, dwk = rnd(B, C, S, S, dtype=bf), rnd(C, 1, 3, 3, scale=0.2)
        pwk = rnd(M, C, 1, 1, scale=0.2)
        res = rnd(B, M, S, S, dtype=bf) if has_res else None
        g = rnd(B, M, S, S, dtype=bf)
        out_k = mb.stage_fwd(x, dwk, pwk, res, relu)
        out_p = [t.contiguous()
                 for t in mb.stage_fwd_plain(x, dwk, pwk, res, relu)]
        rec = record["stage_fwd_bf16"]
        for n, a, b in zip(("fwd y", "fwd a-hat", "fwd b-hat"), out_k[:3],
                           out_p[:3]):
            check_bf16(torch, n, a, b, rec)
        for n, a, b in zip(("fwd 1/std a", "fwd 1/std b"), out_k[3:],
                           out_p[3:]):
            check_close(n, a, b, 1e-4 * max(float(b.abs().max()), 1.0))
        _, ahat, bhat, rstd_a, rstd_b = out_p
        pw_k = mb.stage_bwd_pw(g, ahat, bhat, rstd_b, pwk, relu)
        pw_p = mb.stage_bwd_pw_plain(g, ahat, bhat, rstd_b, pwk, relu)
        rec = record["stage_bwd_pw_bf16"]
        check_bf16(torch, "bwd_pw d a-hat", pw_k[0], pw_p[0], rec)
        check_dw(torch, "bwd_pw dW_pw", pw_k[1], pw_p[1], rec)
        gah = pw_p[0].contiguous()
        dw_k = mb.stage_bwd_dw(gah, ahat, rstd_a, x, dwk)
        dw_p = mb.stage_bwd_dw_plain(gah, ahat, rstd_a, x, dwk)
        rec = record["stage_bwd_dw_bf16"]
        check_bf16(torch, "bwd_dw dx", dw_k[0], dw_p[0], rec)
        check_dw(torch, "bwd_dw dW_dw", dw_k[1], dw_p[1], rec)
        old = (None if parent is None else dict(zip(
            ("stage_fwd_bf16", "stage_bwd_pw_bf16", "stage_bwd_dw_bf16"),
            parent_bf16_calls(torch, parent, x, dwk, pwk, res, relu, g, ahat,
                              bhat, rstd_a, rstd_b, gah))))
        if old is not None:
            # the depthwise backward's IN1 sums and dW_dw's keep the earlier
            # kernel's strips and its order of the plane sums (B <= 8: the
            # cluster's sample order is sum_partials'), the taps their
            # roundings: the same bits
            dw_o = old["stage_bwd_dw_bf16"]()
            same = [torch.equal(bits(a), bits(b)) for a, b in zip(dw_k, dw_o)]
            print(f"    bwd_dw bit for bit with the earlier source (dx, "
                  f"dW_dw): {same}")
            if not same[0]:
                fail(f"{case}: bf16 dx differs from the earlier source")
            if not (same[1] if B <= 8 else max_err(dw_k[1], dw_o[1]) <=
                    mb.BF16_DW * float(dw_o[1].abs().max())):
                fail(f"{case}: bf16 dW_dw differs from the earlier source")
        for name, first, again in (
                ("stage_fwd", out_k, mb.stage_fwd(x, dwk, pwk, res, relu)),
                ("stage_bwd_pw", pw_k,
                 mb.stage_bwd_pw(g, ahat, bhat, rstd_b, pwk, relu)),
                ("stage_bwd_dw", dw_k,
                 mb.stage_bwd_dw(gah, ahat, rstd_a, x, dwk))):
            if not all(torch.equal(bits(a), bits(b))
                       for a, b in zip(first, again)):
                fail(f"{case}: two bf16 {name} calls differ")
        if has_res:
            continue
        bounds = stage_bounds(B, C, M, S * S, relu, has_res, act=2,
                              mma=BF16_FLOPS)
        dwk_b, pwk_b = dwk.to(bf), pwk.to(bf)

        def lib_fwd():  # cuDNN's bf16 route of the same function
            a = F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), dwk_b,
                         groups=C)
            y = F.instance_norm(F.conv2d(F.instance_norm(a), pwk_b))
            return torch.relu(y) if relu else y

        timings = {
            "stage_fwd_bf16": (
                lambda: mb.stage_fwd(x, dwk, pwk, res, relu),
                lambda: mb.stage_fwd_plain(x, dwk, pwk, res, relu), lib_fwd),
            "stage_bwd_pw_bf16": (
                lambda: mb.stage_bwd_pw(g, ahat, bhat, rstd_b, pwk, relu),
                lambda: mb.stage_bwd_pw_plain(g, ahat, bhat, rstd_b, pwk,
                                              relu), None),
            "stage_bwd_dw_bf16": (
                lambda: mb.stage_bwd_dw(gah, ahat, rstd_a, x, dwk),
                lambda: mb.stage_bwd_dw_plain(gah, ahat, rstd_a, x, dwk),
                None)}
        for k, (kern, plain, lib) in timings.items():
            t = {"ms": cuda_ms(torch, kern), "plain_ms": cuda_ms(torch, plain),
                 "library_ms": cuda_ms(torch, lib) if lib else None}
            t["bound_ms"], t["bound_by"] = bounds[k.replace("_bf16", "")]
            print(f"    {k:<18} kernel {t['ms']:.4f} ms  plain "
                  f"{t['plain_ms']:.4f} ms  library {t['library_ms']} ms  "
                  f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
                  f"{t['bound_ms'] / t['ms']:.3f} of it")
            if case == "teacher_relu":
                record[k].update(t)
        splits, launches = {}, {}
        for k in timings:
            launches[k] = B2_LAUNCHES[k]
            if k == "stage_bwd_pw_bf16" and not mb._pw_grad_partials(
                    B, C, M, S, S, kernels.sm_count(x.device.index), "_bf16"):
                launches[k] -= 1  # dW in one run: no ordered sum
            if k == "stage_bwd_dw_bf16" and not mb._dw_grad_partials(
                    B, "_bf16"):
                launches[k] -= 1  # dW_dw summed in a cluster
            splits[k] = launch_split(torch, timings[k][0],
                                     launches=launches[k])
            print_split(k, splits[k])
            if case == "teacher_relu":
                record[k]["device_ms"] = device_ms(splits[k])
                record[k]["launches_a_call"] = len(splits[k])
        # cuDNN's bf16 depthwise convolution backward (d padded x and the
        # weight's gradient, from ga: IN1's backward and the pad's adjoint
        # left out), the depthwise backward's partial yardstick
        ga = mb._inorm_bwd(gah, ahat, rstd_a).contiguous()
        xpad = F.pad(x, (1, 1, 1, 1), mode="reflect")
        cudnn_dw = cuda_ms(torch, lambda: torch.ops.aten.convolution_backward(
            ga, xpad, dwk_b, None, [1, 1], [0, 0], [1, 1], False, [0, 0], C,
            [True, True, False]))
        print(f"    cuDNN bf16 depthwise convolution backward alone (partial "
              f"yardstick of stage_bwd_dw_bf16): {cudnn_dw:.4f} ms")
        if case == "teacher_relu":
            record["stage_bwd_dw_bf16"]["cudnn_partial_ms"] = cudnn_dw
        if old is None:
            continue
        for k, fn in old.items():
            base = k.replace("_bf16", "")
            ev = in_turns(torch, {"new": timings[k][0], "earlier": fn})
            host = in_turns(torch, {"new": timings[k][0], "earlier": fn},
                            n=200, clock=host_us)
            # the earlier depthwise backward always summed dW_dw in a second
            # launch
            dev = {"new": device_ms(splits[k]), "earlier": device_ms(
                launch_split(torch, fn, launches=B2_LAUNCHES[k]
                             if k == "stage_bwd_dw_bf16" else launches[k]))}
            print(f"    {k} in turns with the earlier library (medians of 3 "
                  f"rounds of 20): event ms {ev['new']:.4f} / earlier "
                  f"{ev['earlier']:.4f}; device ms {dev['new']:.4f} / "
                  f"{dev['earlier']:.4f}; host us a call (medians of 3 rounds of 200 "
                  f"enqueued) "
                  f"{host['new']:.1f} / {host['earlier']:.1f}; bound "
                  f"{bounds[base][0]:.4f} ms, {bounds[base + '_saved'][0]:.4f}"
                  f" with a-hat, b-hat and 1/std saved")
            if case == "teacher_relu":
                record[k].update({"turns_ms": ev["new"],
                                  "earlier_ms": ev["earlier"],
                                  "turns_device_ms": dev["new"],
                                  "earlier_device_ms": dev["earlier"],
                                  "host_us": host["new"],
                                  "earlier_host_us": host["earlier"]})
    return record


def _bf16_batches(torch, batches):
    return [{k: v.to(torch.bfloat16) for k, v in b.items()} for b in batches]


def _ratio(card, cpu, ref):
    """rms(card - cpu) / rms(cpu - ref) over lists of tensors."""
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(card, cpu))
    den = sum(float(((a - b) ** 2).sum()) for a, b in zip(cpu, ref))
    return math.sqrt(num / den) if den else (0.0 if not num else math.inf)


def _disc_work(torch, engine, state, batch, val, fakes):
    """The step's discriminator work that reads a generator's output, on
    ``fakes`` (teacher fake, val student fake, val teacher fake): the
    teacher D's update (its gradients and running statistics) and the arch
    step's three D forwards, as lists of float64 CPU tensors."""
    from gcc_tpu_torch.engines.common import d_pair, weight_params
    from gcc_tpu_torch.losses import gan_loss

    A, B, Av, Bv = batch["A"], batch["B"], val["A"], val["B"]
    tfake, fake_v, tfake_v = fakes
    TD, D = state.nets["td"], state.nets["d"]
    pf, pr, _ = d_pair(TD, torch.cat([A, tfake], 1), torch.cat([A, B], 1))
    loss = (gan_loss(pf, False, engine.gan_mode)
            + gan_loss(pr, True, engine.gan_mode)) * 0.5
    grads = torch.autograd.grad(loss, weight_params(TD))
    stats = [t.clone() for n, t in TD.state_dict().items() if "running" in n]
    with torch.no_grad():
        outs = [TD(torch.cat([Av, tfake_v], 1))[0],
                D(torch.cat([Av, fake_v], 1))[0],
                D(torch.cat([Av, Bv], 1))[0]]
    return {k: [t.detach().cpu().double() for t in v] for k, v in
            (("td gradients", grads), ("td running statistics", stats),
             ("arch D outputs", outs))}


def _first_difference(torch, np, name, device="cuda"):
    """Where the card's bf16 teacher forward first leaves the CPU's: the
    configuration's teacher G on (d)'s train and val batch, module by module.
    The first module whose output differs, if one does, must be a
    convolution within one bf16 ulp (at the larger magnitude of the two) in
    at most 1 % of its outputs: the two devices' fp32 sums rounding to
    different bf16 neighbours; or a fused stage (kernel B2) within (a)'s
    bounds of the CPU's plain version. Returns {batch: (module, share of
    its outputs apart, rms(card - CPU) / rms(CPU - CPU fp32) at the
    teacher's output)}."""
    from gcc_tpu_torch.config import Config
    from gcc_tpu_torch.engines.pix2pix import Pix2PixEngine
    from gcc_tpu_torch.ops import kernels
    from gcc_tpu_torch.ops import mobile_block as mb
    from gcc_tpu_torch.ops.layers import Conv, ConvTranspose

    kw, student = BF16_AGREE[name]
    cfg = main_config(Config, ngf=4, ndf=8, teacher_ngf=8, teacher_ndf=8,
                      crop_size=32, no_dropout=True, **kw)
    seen, order = {}, []
    stage = mb.fused_sep_stage

    def recorded(*a, **k):
        y = stage(*a, **k)
        order.append(("fused_sep_stage", None, y))
        return y

    mb.fused_sep_stage = recorded
    try:
        for run, dev, dt in (("cpu", "cpu", torch.bfloat16),
                             ("ref", "cpu", torch.float32),
                             ("card", device, torch.bfloat16)):
            engine = Pix2PixEngine(cfg, filter_cfgs=student, device=dev)
            tg = engine.init_state(seed=5).nets["tg"]
            for mname, mod in tg.named_modules():
                if mname:
                    mod.register_forward_hook(
                        lambda m, i, o, n=mname: order.append((n, m, o)))
            b = make_batches(torch, np, 2, 2, 32, 7, engine.device)
            for batch, x in (("train", b[0]["A"]), ("val", b[1]["A"])):
                order.clear()
                with torch.no_grad():
                    out = tg(x.to(dt), None, update_stats=False)[0]
                seen[(run, batch)] = (
                    out.float().cpu().double(),
                    [(n, m, o.cpu()) for n, m, o in order
                     if isinstance(o, torch.Tensor)])
    finally:
        mb.fused_sep_stage = stage
    result = {}
    for batch in ("train", "val"):
        (c_out, card), (r_out, cpu), (f_out, _) = (
            seen[(run, batch)] for run in ("card", "cpu", "ref"))
        first, share = None, 0.0
        for (n, m, a), (_, _, b) in zip(card, cpu):
            if torch.equal(a, b):
                continue
            a, b = a.float(), b.float()
            share = float((a != b).float().mean())
            if m is None:  # a fused stage: (a)'s bounds
                ulps = kernels.bf16_err(a, b)[0]
                ok = ulps <= mb.BF16_ULPS and share <= mb.BF16_SHARE
            else:
                big = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126)
                ulps = float(((a - b).abs() / 2.0 ** (
                    big.log2().floor() - 7)).max())
                ok = (isinstance(m, (Conv, ConvTranspose)) and ulps <= 1.0
                      and share <= 0.01)
            if not ok:
                fail(f"bf16 {name} {batch}: the teacher first differs at {n} "
                     f"({type(m).__name__}), {ulps} ulps, share {share}")
            first = n
            break
        result[batch] = (first, share, _ratio([c_out], [r_out], [f_out]))
    return result


def _bf16_agree(torch, np, name, device="cuda"):
    """(d) One train_step + arch_step at learning rate 0 of
    tests/test_torch_bf16.py's configuration on the card in bf16, on the CPU
    in bf16 and on the CPU in fp32, from the same seeded init on the same
    batches; rms(card - CPU bf16) / rms(CPU bf16 - CPU fp32) for each
    update's losses, each optimizer's gradients (Adam's first moments) and
    each net's running statistics. Then the discriminator work that reads a
    generator's output (_disc_work), on the card and in the CPU bf16 run on
    that run's generator outputs (the fp32 run on its own): the same ratio.
    ``device`` stands in for the card in a dry run."""
    from gcc_tpu_torch.config import Config
    from gcc_tpu_torch.engines.pix2pix import Pix2PixEngine

    kw, student = BF16_AGREE[name]
    cfg = main_config(Config, ngf=4, ndf=8, teacher_ngf=8, teacher_ndf=8,
                      crop_size=32, no_dropout=True, lr=0.0, arch_lr=0.0,
                      **kw)
    runs, fakes = {}, {}
    for run, dev, dt in (("cpu", "cpu", torch.bfloat16),
                         ("ref", "cpu", torch.float32),
                         ("card", device, torch.bfloat16)):
        engine = Pix2PixEngine(cfg, filter_cfgs=student, device=dev)
        state = engine.init_state(seed=5)  # the same numbers on every device
        b = make_batches(torch, np, 2, 2, 32, 7, engine.device)
        b = [{k: v.to(dt) for k, v in x.items()} for x in b]
        state, m = engine.train_arch_step(state, b[0], b[1], 0.0, 0.9, 0.0)
        host = lambda ts: [t.detach().cpu().double() for t in ts]  # noqa: E731
        out = {f"loss {g}": host(m[k] for k in keys)
               for g, keys in LOSS_GROUPS.items()}
        out.update({f"grad {k}": host(o.mu) for k, o in state.opts.items()})
        for n, net in state.nets.items():
            stats = [t for k, t in net.state_dict().items() if "running" in k]
            if stats:
                out[f"stats {n}"] = host(stats)
        state = engine.init_state(seed=5)
        if run != "card":
            nets = state.nets
            with torch.no_grad():
                fakes[run] = (
                    nets["tg"](b[0]["A"], None, update_stats=False)[0],
                    nets["g"](b[1]["A"])[0], nets["tg"](b[1]["A"])[0])
        own = fakes["ref" if run == "ref" else "cpu"]
        work = _disc_work(torch, engine, state, b[0], b[1],
                          [t.to(engine.device) for t in own])
        out.update({f"on CPU fakes: {k}": v for k, v in work.items()})
        runs[run] = out
    return {k: _ratio(runs["card"][k], runs["cpu"][k], runs["ref"][k])
            for k in runs["cpu"]}


def phase_bf16(torch, np, F, fp32, parent=None, ptxas=None):
    from gcc_tpu_torch.config import Config
    from gcc_tpu_torch.engines.pix2pix import Pix2PixEngine
    from gcc_tpu_torch.ops import flash_attention as fa
    from gcc_tpu_torch.ops import mobile_block as mb

    t_phase = time.perf_counter()
    print("== phase 17: the bf16 path (--compute_dtype bfloat16, the JAX "
          "package's default)")
    # phases 9's and 4's fp32 iterations, beside (b)'s and (c)'s
    rec = {"fp32": fp32}
    record = bf16_kernels(torch, F, parent, ptxas)

    # (b) the U-Net iteration in bf16 at phase 9's shapes
    batch, size, n_timed = UNET_BATCH, 256, 3
    print(f"  (b) U-Net GCC iteration in bf16, {size}px, batch {batch}, 1 "
          f"warm-up + {n_timed} timed (phase 9's fp32 run above)")
    engine, cfg = unet_engine(torch, np, batch)
    batches = make_batches(torch, np, 2 * (n_timed + 1), batch, size, 0,
                           engine.device)
    for k in fa.LAUNCHES:
        fa.LAUNCHES[k] = 0
    rec["unet"] = {}
    drive(torch, engine, cfg, _bf16_batches(torch, batches), batches[0]["A"],
          mb.LAUNCHES, {}, {}, "unet bf16 path", record=rec["unet"])
    if any(fa.LAUNCHES.values()):
        fail(f"unet bf16 path launched B1: {fa.LAUNCHES}")
    del engine, batches
    torch.cuda.empty_cache()

    # (c) the pix2pix resnet fused iteration in bf16 at phase 4's config
    batch, size = 4, 256
    print(f"  (c) pix2pix resnet GCC iteration in bf16, fused blocks, "
          f"{size}px, batch {batch}, 1 warm-up + {n_timed} timed; generate "
          f"in fp32, as the epoch-end eval runs")
    cfg = main_config(Config, ngf=24, ndf=128, teacher_ngf=64,
                      teacher_ndf=128, crop_size=size, batch_size=batch)
    engine = Pix2PixEngine(cfg, filter_cfgs=STUDENT_CFG)
    batches = make_batches(torch, np, 2 * (n_timed + 1), batch, size, 0,
                           engine.device)
    rec["resnet"] = {}
    launches = drive(torch, engine, cfg, _bf16_batches(torch, batches),
                     batches[0]["A"], mb.LAUNCHES, PER_ITER_BF16,
                     {"stage_fwd": 18}, "resnet bf16 path",
                     record=rec["resnet"])
    del engine, batches
    torch.cuda.empty_cache()

    # (d) the card against the CPU, in the CPU test's manner
    print("  (d) card against CPU in bf16, tests/test_torch_bf16.py's "
          "configurations at learning rate 0, one iteration: rms(card - "
          "CPU bf16) / rms(CPU bf16 - CPU fp32) by update, optimizer and "
          "net, bound 1/4 unless AGREE_BOUNDS names it")
    rec["agree"] = {}
    for name in BF16_AGREE:
        got = _bf16_agree(torch, np, name)
        first = _first_difference(torch, np, name)
        rec["agree"][name] = {"ratios": got, "teacher first difference": {
            batch: {"module": n, "share": share, "output ratio": r}
            for batch, (n, share, r) in first.items()}}
        for batch, (n, share, r) in first.items():
            print(f"    {name} teacher forward, {batch} batch: first "
                  f"differs at {n} ({share:.2e} of its outputs), ratio "
                  f"{r:.4f} at its output")
        for k, v in got.items():
            bound = AGREE_BOUNDS.get((name, k), 0.25)
            print(f"    {name} {k}: {v:.4f} (bound {bound})")
            if not (math.isfinite(v) and (bound is None or v <= bound)):
                fail(f"bf16 {name}: card against CPU, {k} {v} > {bound}")

    # (e) one cli.train epoch of pix2pix U-Net with default flags
    import tempfile
    counters = {"B2": mb.LAUNCHES, "B1": fa.LAUNCHES}
    with tempfile.TemporaryDirectory() as tmp:
        argv = (f"--dataroot synthetic --dataset_mode synthetic --model "
                f"pix2pix --max_dataset_size 8 --batch_size 4 --n_epochs 1 "
                f"--n_epochs_decay 0 --print_freq 4 --num_threads 4 --ngf 32 "
                f"--ndf 128 --checkpoints_dir {tmp} --name bf").split()
        records = []
        _, _, lines = run_cli(torch, "(e) unet, default flags", argv,
                              counters, records)
    want = "port: computes in bfloat16 (--compute_dtype bfloat16)"
    if not any(line.startswith(want) for line in lines):
        fail(f"(e) the CLI did not log {want!r}")
    rec["cli"] = records[0]
    rec["seconds"] = round(time.perf_counter() - t_phase, 3)
    print(f"  phase 17 took {rec['seconds']} s")
    return record, launches, rec




# phase 18: SAGAN, CycleGAN and SRGAN in bf16, and kernel B1's bf16 entry
# points. B1 in bf16 on the main path: SAGAN's generators' attn2 at N 1024,
# three teacher and three student forwards and two backwards an iteration
ATTN_PER_ITER_BF16 = {"attn_fwd_bf16": 6, "attn_bwd_bf16": 2}
TPU_KERNEL.update({"attn_fwd_bf16": TPU_KERNEL["attn_fwd"],
                   "attn_bwd_bf16": TPU_KERNEL["attn_bwd"]})
# (e)'s bounds of the composed iteration, 1/4 unless named (None: finite
# only), as phase 17 (d)'s AGREE_BOUNDS (measured on an H100). The
# named results are the teachers' gradients: they read a teacher forward in
# which the card's and the CPU's convolution sums first round to different
# bf16 neighbours (family_first_difference), which the deep teacher
# spreads, and the teacher D's backward on its fakes; the CPU test files
# name the same results against gcc_tpu for the same cause
FAMILY_BOUNDS = {("sagan", "grad td"): 0.4,  # measured 0.319
                 ("sagan", "grad tg"): 0.5,  # measured 0.449
                 ("cyclegan", "grad tg"): 0.5,  # measured 0.439
                 ("cyclegan", "grad td"): None}  # measured 0.551


def check_attn_bf16(torch, fa, name, got, plain, rec, exact=None):
    """A bf16 kernel output against its plain version: within fa.BF16_ULPS
    of the plain version's largest value, and fa.bf16_share_ok (the share
    apart, or, for an output more than fa.BF16_SHARE from its plain
    version, no farther from the float64 answer than the plain version)."""
    from gcc_tpu_torch.ops import kernels

    ulps, err, _ = kernels.bf16_err(got, plain)
    ok, share, plain_off, got_off = fa.bf16_share_ok(got, plain, exact)
    print(f"    {name:<10} {ulps:.3f} bf16 ulps of max|plain| (max|d| "
          f"{err:.3e}), {share:.2e} of elements apart"
          + (f"; from the float64 answer: the plain version {plain_off:.4e},"
             f" the kernel {got_off:.4e}" if exact is not None else "")
          + f"; tol {fa.BF16_ULPS} ulps, {fa.BF16_SHARE}")
    if got.dtype != torch.bfloat16 or not (ulps <= fa.BF16_ULPS and ok):
        fail(f"bf16 {name}: {got.dtype}, {ulps} ulps, share {share}")
    rec["max_ulps"] = max(rec["max_ulps"], ulps)
    rec["max_share"] = max(rec["max_share"], share)
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    if exact is not None:
        rec["float64_share"] = max(rec.get("float64_share", 0.0), got_off)
        rec["plain_float64_share"] = max(rec.get("plain_float64_share", 0.0),
                                         plain_off)
    return share


def start_ptxas(name):
    """nvcc -Xptxas -v of csrc/<name>.cu into a scratch cubin, started now
    and read by ptxas_log: (name, Popen, scratch directory)."""
    import tempfile
    from gcc_tpu_torch.ops import kernels

    tmp = tempfile.mkdtemp()
    flags = [f for f in kernels.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    return name, subprocess.Popen(
        [kernels._nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o",
         os.path.join(tmp, f"{name}.cubin"), str(kernels.CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp


def ptxas_log(started):
    """The output of the nvcc that start_ptxas started (names demangled by
    cu++filt where the toolkit has it)."""
    import shutil
    from gcc_tpu_torch.ops import kernels

    name, proc, tmp = started
    log = proc.communicate()[0].decode(errors="replace")
    shutil.rmtree(tmp, ignore_errors=True)
    if proc.returncode != 0:
        fail(f"nvcc -Xptxas -v of {name}.cu:\n{log}")
    filt = os.path.join(os.path.dirname(kernels._nvcc()), "cu++filt")
    if os.path.exists(filt):
        log = subprocess.run([filt], input=log, capture_output=True,
                             text=True).stdout
    return log


def print_ptxas(log, what):
    """Registers, stack and spills of each kernel of a source from
    ptxas_log's output, under the heading ``what``."""
    print(f"  {what}, nvcc -Xptxas -v (sm_90a):")
    name = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            # attn_fwd_bf16_kernel<8, 1, 1>: template arguments kept
            name = line.split("'")[1].replace("void ", "").replace(
                "<unnamed>::", "").replace("(anonymous namespace)::", "")
            name = (name.split(">(")[0] + ">" if ">(" in name
                    else name.split("(")[0])
            name = name.replace("(int)", "").replace("(bool)", "")
        elif name and ("spill" in line or "Used" in line):
            print(f"    {name}: {line.split(':', 1)[-1].strip()}")


def attention_bf16(torch, F, ptxas):
    """(a) B1's bf16 entry points against their bf16 plain versions at
    phase 6's shapes."""
    from gcc_tpu_torch.ops import flash_attention as fa

    bf = torch.bfloat16
    record = {k: {"max_abs_err": 0.0, "max_ulps": 0.0, "max_share": 0.0}
              for k in ATTN_PER_ITER_BF16}
    print_ptxas(ptxas, "(a) flash_attention_bf16.cu")
    print(f"  (a) bounds: bytes at {HBM_BYTES_PER_S / 1e12} TB/s, the "
          f"function's flops at {BF16_FLOPS / 1e12:.0f} TFLOP/s, B N^2 exps "
          f"at {EXP_PER_CLK_SM} a clock on "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs "
          f"at {sm_clock_hz() / 1e6:.0f} MHz (nvidia-smi clocks.max.sm)")
    gen = torch.Generator().manual_seed(0)
    for case, B, N, dq, dv, qk_scale in ATTN_CASES:
        print(f"  (a) {case}: B={B} N={N} dq={dq} dv={dv} q, k scale "
              f"{qk_scale}, bf16; routes: forward "
              f"{fa.bf16_route(dq, dv, False)}, backward "
              f"{fa.bf16_route(dq, dv, True)}; dynamic shared memory of the "
              f"tiles' kernels {fa.bf16_smem(dq, dv, False)} B forward, "
              f"{fa.bf16_smem(dq, dv, True)} B backward")

        def rnd(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen) * scale).to(
                "cuda", bf)

        q, k = rnd(B, dq, N, scale=qk_scale), rnd(B, dq, N, scale=qk_scale)
        v, do = rnd(B, dv, N), rnd(B, dv, N)
        o, lse = fa.attn_fwd(q, k, v)
        o_p, lse_p = fa.attn_fwd_plain(q, k, v)
        check_attn_bf16(torch, fa, "fwd O", o, o_p, record["attn_fwd_bf16"])
        check_close("fwd lse", lse, lse_p,
                    1e-5 * max(float(lse_p.abs().max()), 1.0))
        rec = record["attn_bwd_bf16"]
        # the backward on the plain forward's O and lse, then on the kernel
        # forward's own, each against the plain backward on the same O and
        # lse (the bf16 rounding of O moves delta more than the kernels do)
        for what, (oo, ll) in (("", (o_p, lse_p)), (" on kernel O", (o, lse))):
            delta = (do.float() * oo.float()).sum(1)
            args = (q, k, v, do, ll.contiguous(), delta)
            got, plain = fa.attn_bwd(*args), fa.attn_bwd_plain(*args)
            exact = None
            if any(not fa.bf16_share_ok(a, b)[0] for a, b in zip(got, plain)):
                # the float64 answer: the plain version on float64 inputs
                exact = fa.attn_bwd_plain(*(t.double() for t in args))
            for i, n in enumerate(("dq", "dk", "dv")):
                check_attn_bf16(torch, fa, f"bwd {n}{what}", got[i], plain[i],
                                rec, None if exact is None else exact[i])
            del exact
        if not all(torch.equal(a, b) for a, b in zip(got, fa.attn_bwd(*args))):
            fail(f"{case}: two bf16 attn_bwd calls differ")
        if not all(torch.equal(a, b)
                   for a, b in zip((o, lse), fa.attn_fwd(q, k, v))):
            fail(f"{case}: two bf16 attn_fwd calls differ")
        bounds = {f"{k}_bf16": v for k, v in
                  attn_bounds(B, N, dq, dv, act=2).items()}
        timed = {"attn_fwd_bf16": (lambda: fa.attn_fwd(q, k, v),
                                   lambda: fa.attn_fwd_plain(q, k, v)),
                 "attn_bwd_bf16": (lambda: fa.attn_bwd(*args),
                                   lambda: fa.attn_bwd_plain(*args))}
        main = case in ("teacher", "student")
        if main:
            kern, lib = library_attention(
                torch, F, q, k, v, do, timed["attn_fwd_bf16"][0],
                timed["attn_bwd_bf16"][0])
        for key, (fn, plain) in timed.items():
            n = 20 if main else 3
            what = key[5:8]
            t = {"ms": kern[what] if main else cuda_ms(torch, fn, n=n),
                 "plain_ms": cuda_ms(torch, plain, n=n),
                 "library_ms": lib[what][0] if main else None,
                 "library": (f"F.scaled_dot_product_attention "
                             f"({lib[what][1]})" if main else None),
                 "bf16_route": fa.bf16_route(dq, dv, what == "bwd")}
            t["bound_ms"], t["bound_by"] = bounds[key]
            issued, issued_by = bounds[f"{key[:8]}_issued_bf16"]
            print(f"    {key:<14} ({t['bf16_route']}) kernel {t['ms']:.4f} ms  "
                  f"plain {t['plain_ms']:.4f} ms  library "
                  f"{t['library_ms']} ms ({t['library']})  bound "
                  f"{t['bound_ms']:.4f} ms ({t['bound_by']}), "
                  f"{t['bound_ms'] / t['ms']:.3f} of it; the issued mma's "
                  f"bound {issued:.4f} ms ({issued_by})")
            if case == "teacher":
                record[key].update(t)
        del q, k, v, do, o, lse, o_p, lse_p, got, plain
        torch.cuda.empty_cache()
    return record


def family_engine(torch, np, family, dev):
    """The tests' tiny configuration of a family on ``dev`` at learning
    rate 0 (tests/test_torch_bf16_{sagan,cyclegan,srgan}.py) and its two
    batches' maker: (engine, batches(dtype))."""
    from gcc_tpu_torch.config import Config
    if family == "sagan":
        from gcc_tpu_torch.engines.sagan import SAGANEngine
        cfg = sagan_config(Config, ngf=8, ndf=8, teacher_ngf=8,
                           teacher_ndf=8, z_dim=8, lambda_L1=0.5, lr=0.0,
                           arch_lr=0.0, lambda_weight=1e-4)
        engine = SAGANEngine(cfg, filter_cfgs=[20, 12, 9, 16], device=dev)
        shapes = {"z": (2, 8), "real_img": (2, 3, 64, 64)}
    elif family == "cyclegan":
        from gcc_tpu_torch.engines.cyclegan import CycleGANEngine
        cfg = cyclegan_config(Config, ngf=4, ndf=8, teacher_ngf=8,
                              teacher_ndf=8, crop_size=32, load_size=32,
                              pool_size=0, lr=0.0, arch_lr=0.0,
                              lambda_L1=1.0, lambda_weight=1e-3)
        engine = CycleGANEngine(cfg, cfg_AtoB=[
            3, 6, 12, 5, 12, 7, 12, 4, 12, 2, 12, 0, 0, 6, 12, 5, 12, 3, 12,
            8, 12, 6, 3], device=dev)
        shapes = {"A": (2, 3, 32, 32), "B": (2, 3, 32, 32)}
    else:
        from gcc_tpu_torch.engines.srgan import SRGANEngine
        cfg = Config(model="srgan", ngf=8, ndf=8, teacher_ngf=8,
                     teacher_ndf=8, image_size=32, gan_mode="vanilla",
                     online_distillation=True, darts_discriminator=True,
                     lr=0.0, arch_lr=0.0, lambda_SR_adversarial=1e-3,
                     lambda_SR_perceptual=1.0, lambda_content=1.0,
                     lambda_gram=1.0, lambda_L1=1.0)
        engine = SRGANEngine(cfg, filter_cfgs=[4, 6, 8, 4, 6, 8, 4, 0, 8, 4,
                                               6, 8, 4, 6, 8, 4],
                             device=dev, vgg_params=random_vgg19(np))
        shapes = {"lr": (2, 3, 8, 8), "hr": (2, 3, 32, 32)}

    def batches(dtype):
        rng = np.random.RandomState(7)
        out = []
        for _ in range(2):
            b = {}
            for k, shp in shapes.items():
                a = rng.randn(*shp) if k == "z" else rng.rand(*shp) * 2 - 1
                b[k] = torch.from_numpy(a.astype(np.float32)).to(dev, dtype)
            out.append(b)
        return out

    return engine, batches


def family_agree(torch, np, family, device="cuda"):
    """(e) One train_step + arch_step at learning rate 0 of the family's
    test configuration on the card in bf16, on the CPU in bf16 and on the
    CPU in fp32, from the same seeded init on the same batches:
    rms(card - CPU bf16) / rms(CPU bf16 - CPU fp32) of each update's losses
    (D, G, arch), each optimizer's gradients (first moments) and each
    net's running statistics. ``device`` stands in for the card in a dry
    run."""
    runs = {}
    for run, dev, dt in (("cpu", "cpu", torch.bfloat16),
                         ("ref", "cpu", torch.float32),
                         ("card", device, torch.bfloat16)):
        engine, batches = family_engine(torch, np, family, dev)
        state = engine.init_state(seed=5)
        for net in state.nets.values():  # attention gammas non-zero
            for name, mod in net.named_modules():
                if hasattr(mod, "gamma") and name.endswith("attn1"):
                    mod.gamma.data.fill_(0.5)
                elif hasattr(mod, "gamma"):
                    mod.gamma.data.fill_(-0.3)
        b = batches(dt)
        state, m = engine.train_arch_step(state, b[0], b[1], 0.0, 0.9, 0.0)
        host = lambda ts: [t.detach().cpu().double() for t in ts]  # noqa: E731
        arch = sorted(k for k in m if "arch" in k)
        d = sorted(k for k in m if k in ("D_A", "D_B", "D_fake", "D_real"))
        g = sorted(k for k in m if k not in arch and k not in d)
        out = {f"loss {n}": host(m[k] for k in keys)
               for n, keys in (("D", d), ("G", g), ("arch", arch))}
        out.update({f"grad {k}": host(o.mu) for k, o in state.opts.items()})
        for n, net in state.nets.items():
            stats = [t for k, t in net.state_dict().items() if "running" in k]
            if stats:
                out[f"stats {n}"] = host(stats)
        runs[run] = out
    return {k: _ratio(runs["card"][k], runs["cpu"][k], runs["ref"][k])
            for k in runs["cpu"]}


def family_first_difference(torch, np, family, device="cuda"):
    """Where the card's bf16 teacher G forward first leaves the CPU's, on
    (e)'s train batch, module by module: the first module whose output
    differs, if one does, must be a convolution or a BatchNorm within one
    bf16 ulp of its largest output in at most 1 % of its outputs (the two
    devices' fp32 sums, a conv's products or a BatchNorm's batch
    statistics, rounding to different bf16 neighbours), a self-attention
    within B1's bf16 bounds or a fused stage within B2's. Returns (module, share
    of its outputs apart, rms(card - CPU) / rms(CPU - CPU fp32) at the
    teacher's output)."""
    from gcc_tpu_torch.ops import flash_attention as fa
    from gcc_tpu_torch.ops import kernels
    from gcc_tpu_torch.ops import mobile_block as mb
    from gcc_tpu_torch.ops.attention import SelfAttention
    from gcc_tpu_torch.ops.layers import BatchNorm, Conv, ConvTranspose

    seen, order = {}, []
    stage = mb.fused_sep_stage

    def recorded(*a, **k):
        y = stage(*a, **k)
        order.append(("fused_sep_stage", None, y))
        return y

    mb.fused_sep_stage = recorded
    try:
        for run, dev, dt in (("cpu", "cpu", torch.bfloat16),
                             ("ref", "cpu", torch.float32),
                             ("card", device, torch.bfloat16)):
            engine, batches = family_engine(torch, np, family, dev)
            nets = engine.init_state(seed=5).nets
            tg = nets["tg_a" if family == "cyclegan" else "tg"]
            for name, mod in tg.named_modules():
                if isinstance(mod, SelfAttention):
                    mod.gamma.data.fill_(0.5 if name == "attn1" else -0.3)
                if name:
                    mod.register_forward_hook(
                        lambda m, i, o, n=name: order.append((n, m, o)))
            x = next(iter(batches(dt)[0].values()))
            order.clear()
            with torch.no_grad():
                out = tg(x)[0]
            seen[run] = (out.float().cpu().double(),
                         [(n, m, o.cpu()) for n, m, o in order
                          if isinstance(o, torch.Tensor)])
    finally:
        mb.fused_sep_stage = stage
    (c_out, card), (r_out, cpu), (f_out, _) = (
        seen[run] for run in ("card", "cpu", "ref"))
    for (n, m, a), (_, _, b) in zip(card, cpu):
        if torch.equal(a, b):
            continue
        ulps, _, share = kernels.bf16_err(a, b)
        if m is None:  # a fused stage: B2's bounds
            ok = ulps <= mb.BF16_ULPS and share <= mb.BF16_SHARE
        elif isinstance(m, SelfAttention):  # B1's bounds
            ok = ulps <= fa.BF16_ULPS and fa.bf16_share_ok(a, b)[0]
        else:
            ok = (isinstance(m, (Conv, ConvTranspose, BatchNorm))
                  and ulps <= 1.0 and share <= 0.01)
        if not ok:
            fail(f"bf16 {family}: the teacher first differs at {n} "
                 f"({type(m).__name__}), {ulps} ulps, share {share}")
        return n, share, _ratio([c_out], [r_out], [f_out])
    return None, 0.0, _ratio([c_out], [r_out], [f_out])


def phase_bf16_families(torch, np, F, ptxas):
    from gcc_tpu_torch.compress import cyclegan_reference_cfgs
    from gcc_tpu_torch.config import Config
    from gcc_tpu_torch.engines.cyclegan import CycleGANEngine
    from gcc_tpu_torch.engines.sagan import SAGANEngine
    from gcc_tpu_torch.ops import flash_attention as fa
    from gcc_tpu_torch.ops import mobile_block as mb

    t_phase = time.perf_counter()
    print("== phase 18: bf16 families: SAGAN (kernel B1 in bf16), CycleGAN "
          "and SRGAN in --compute_dtype bfloat16")
    rec = {}
    record = attention_bf16(torch, F, ptxas)

    # (b) SAGAN at phase 7's full width on bf16 batches
    batch, n_timed = 64, 3
    print(f"  (b) SAGAN GCC iteration in bf16, 64px, batch {batch}, 1 "
          f"warm-up + {n_timed} timed (phase 7's fp32 run above); generate "
          f"in fp32, as the epoch-end eval runs")
    cfg = sagan_config(Config, ngf=48, ndf=64, teacher_ngf=64, teacher_ndf=64,
                       z_dim=128, batch_size=batch)
    engine = SAGANEngine(cfg, filter_cfgs=SAGAN_STUDENT_CFG)
    batches = make_sagan_batches(torch, np, 2 * (n_timed + 1), batch,
                                 cfg.z_dim, 0, engine.device)
    rec["sagan"] = {}
    launches = drive(torch, engine, cfg, _bf16_batches(torch, batches),
                     batches[0]["z"], fa.LAUNCHES, ATTN_PER_ITER_BF16,
                     {"attn_fwd": 1}, "sagan bf16 path", record=rec["sagan"])
    del engine, batches
    torch.cuda.empty_cache()

    # (c) CycleGAN at phase 12's full width on bf16 batches
    cfg_a, cfg_b = cyclegan_reference_cfgs()
    size, w = CYCLEGAN_SIZE, CYCLEGAN_WIDTHS
    print(f"  (c) CycleGAN GCC iteration in bf16, {size}px, batch 1, fused "
          f"blocks, 1 warm-up + {N_TIMED} timed (phase 12's fp32 run above)")
    cfg = cyclegan_config(Config, crop_size=size, load_size=size, **w)
    engine = CycleGANEngine(cfg, cfg_AtoB=cfg_a, cfg_BtoA=cfg_b)
    batches = make_batches(torch, np, 2 * (N_TIMED + 1), 1, size, 0,
                           engine.device)
    per_iter, gen_calls = cyclegan_launches(cfg_a, cfg_b)
    per_iter = {f"{k}_bf16": v for k, v in per_iter.items()}
    for k in fa.LAUNCHES:
        fa.LAUNCHES[k] = 0
    b0 = batches[0]
    rec["cyclegan"] = {}
    cg_launches = drive(
        torch, engine, cfg, _bf16_batches(torch, batches), b0["A"],
        mb.LAUNCHES, per_iter, gen_calls, "cyclegan bf16 path",
        generate=lambda st: [engine.generate(st, b0["A"], "AtoB"),
                             engine.generate(st, b0["B"], "BtoA")],
        record=rec["cyclegan"])
    if any(fa.LAUNCHES.values()):
        fail(f"cyclegan bf16 path launched B1: {fa.LAUNCHES}")
    del engine, batches
    torch.cuda.empty_cache()

    # (d) SRGAN at phase 14's full width on bf16 batches
    rec["srgan"] = {}
    phase_srgan(torch, np, dtype=torch.bfloat16, record=rec["srgan"])
    torch.cuda.empty_cache()

    # (e) the card against the CPU in bf16, in the CPU tests' manner
    print("  (e) card against CPU in bf16, the tiny configurations of "
          "tests/test_torch_bf16_{sagan,cyclegan,srgan}.py at learning rate "
          "0, one iteration: rms(card - CPU bf16) / rms(CPU bf16 - CPU "
          "fp32) by update, optimizer and net, bound 1/4 unless "
          "FAMILY_BOUNDS names it")
    rec["agree"], over = {}, []
    for family in ("sagan", "cyclegan", "srgan"):
        got = family_agree(torch, np, family)
        n, share, r = family_first_difference(torch, np, family)
        print(f"    {family} teacher forward, train batch: first differs "
              f"at {n} ({share:.2e} of its outputs), ratio {r:.4f} at its "
              f"output")
        rec["agree"][family] = {"ratios": got, "teacher first difference": {
            "module": n, "share": share, "output ratio": r}}
        for k, v in got.items():
            bound = FAMILY_BOUNDS.get((family, k), 0.25)
            print(f"    {family} {k}: {v:.4f} (bound {bound})")
            if not (math.isfinite(v) and (bound is None or v <= bound)):
                over.append(f"{family} {k} {v} > {bound}")
    if over:
        fail(f"bf16 card against CPU: {over}")

    # (f) one cli.train epoch of SAGAN with default flags
    import tempfile
    counters = {"B2": mb.LAUNCHES, "B1": fa.LAUNCHES}
    with tempfile.TemporaryDirectory() as tmp:
        argv = (f"--dataroot synthetic/celeb --dataset_mode synthetic "
                f"--model sagan --max_dataset_size 128 --n_epochs 1 "
                f"--save_epoch_freq 1 --print_freq 64 --num_threads 4 "
                f"--ngf 48 --ndf 64 --checkpoints_dir {tmp} --name bf").split()
        records = []
        clock, _, lines = run_cli(torch, "(f) sagan, default flags", argv,
                                  counters, records)
    want = "port: computes in bfloat16 (--compute_dtype bfloat16)"
    if not any(line.startswith(want) for line in lines):
        fail(f"(f) the CLI did not log {want!r}")
    b1 = [{k: g[k] for k in fa.LAUNCHES} for g in clock.summary()[2]]
    print(f"  (f) B1 launches per iteration through the CLI: {b1}")
    if not b1 or any(g["attn_fwd"] or g["attn_bwd"] or not g["attn_fwd_bf16"]
                     or not g["attn_bwd_bf16"] for g in b1):
        fail(f"(f) sagan default flags: B1 launches {b1}")
    rec["cli"] = records[0]
    rec["seconds"] = round(time.perf_counter() - t_phase, 3)
    print(f"  phase 18 took {rec['seconds']} s")
    return record, launches, cg_launches, rec



# phase 19: the batches the U-Net artifact serves (one symbolic export), the
# batches timed for images/s, and the batches of the other generators'
# comparisons; the bf16 rule: an artifact no farther from the fp32 generate,
# in rms, than SERVE_BF16_RMS times the engine's own bf16 generate
SERVE_BATCHES, SERVE_TIMED, SERVE_CHECK = (1, 3, 8), (1, 8), 2
SERVE_BF16_RMS = 2.0
SERVE_INT8_DB = 45.0  # int8 artifact against the bf16 generate
# fp32 artifact against generate: 1e-5 where generate runs no kernel (cuDNN
# both ways under exact_fp32); phases 5's and 8's kernel-against-plain-route
# bound where generate runs B2 or B1
SERVE_FP32_TOL = {"unet": 1e-5, "resnet": 1e-3, "cyclegan": 1e-3,
                  "sagan": 1e-3, "srgan": 1e-5}
SERVE_LOADER = """
import importlib.util, sys
for m in ("gcc_tpu_torch", "gcc_tpu"):
    assert importlib.util.find_spec(m) is None, m
    sys.modules[m] = None
import numpy as np, torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
x = torch.from_numpy(np.load(sys.argv[2])).to(sys.argv[4],
                                               getattr(torch, sys.argv[5]))
with torch.no_grad():
    y = torch.export.load(sys.argv[1]).module()(x)
np.save(sys.argv[3], y.float().cpu().numpy())
print(y.device, torch.cuda.get_device_name(0) if y.is_cuda else "")
"""


def rms(a):
    return float(a.detach().double().pow(2).mean().sqrt())


def psnr(a, b):
    """dB of b against a, for images in [-1, 1]."""
    mse = float((a.detach().double() - b.detach().double()).pow(2).mean())
    return math.inf if mse == 0 else 10 * math.log10(4.0 / mse)


def launched(torch, counters, fn):
    """fn() under no_grad and the kernel launches it made, the counters set
    to 0 just before and read just after."""
    for c in counters:
        for k in c:
            c[k] = 0
    with torch.no_grad():
        out = fn()
    torch.cuda.synchronize()
    return out, {k: v for c in counters for k, v in c.items() if v}


def serve_images_per_s(torch, fn, b):
    with torch.no_grad():
        return b / (cuda_ms(torch, fn, n=10, warmup=2) / 1e3)


def bf16_rule(what, art, gen, ref32, rec):
    """The bf16 artifact no farther from the fp32 generate, in rms, than
    SERVE_BF16_RMS times the engine's own bf16 generate."""
    got, own = rms(art.float() - ref32), rms(gen.float() - ref32)
    rec.update({"rms_to_fp32": got, "generate_bf16_rms_to_fp32": own,
                "rms_ratio": got / own if own else math.inf})
    print(f"    {what}: rms to the fp32 generate {got:.4g}, the bf16 "
          f"generate's {own:.4g} (ratio {got / own if own else math.inf:.3f}"
          f", bound {SERVE_BF16_RMS})")
    if not got <= SERVE_BF16_RMS * own:
        fail(f"phase 19 {what}: bf16 artifact {got} from the fp32 generate, "
             f"the bf16 generate {own}")


def serve_family(torch, name, engine, state, x, counters, kernels, rec,
                 direction=None):
    """Phase 19 (b), (c): the generator's artifact (export_generator) in
    fp32 and bf16 against engine.generate on x, the kernels' launches
    around each call (``kernels``: the wrapper counted in each dtype's
    generate, None where generate runs none), ms at batch 1 each way."""
    from gcc_tpu_torch.device import exact_fp32
    from gcc_tpu_torch.utils import serve_export as sx

    kw = {} if direction is None else {"direction": direction}
    label = name if direction is None else f"{name} {direction}"
    with exact_fp32():
        ref32 = launched(torch, counters,
                         lambda: engine.generate(state, x, **kw))[0]
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).replace("torch.", "")
        t0 = time.perf_counter()
        ep = sx.export_generator(engine, state, (1,) + tuple(x.shape[1:]),
                                 direction=direction or "AtoB", dtype=dtype)
        export_s = time.perf_counter() - t0
        art, xd, x1 = ep.module(), x.to(dtype), x[:1].to(dtype)
        with exact_fp32(), torch.no_grad():
            got, l_art = launched(torch, counters, lambda: art(xd))
            gen, l_gen = launched(torch, counters,
                                  lambda: engine.generate(state, xd, **kw))
            ms_art = cuda_ms(torch, lambda: art(x1), n=10, warmup=2)
            ms_gen = cuda_ms(torch, lambda: engine.generate(state, x1, **kw),
                             n=10, warmup=2)
        r = {"export_s": export_s, "artifact_ms_b1": ms_art,
             "generate_ms_b1": ms_gen, "artifact_launches": l_art,
             "generate_launches": l_gen}
        want = kernels and kernels[dtype]
        print(f"  {label} {dt}: export {export_s:.2f} s; batch 1 artifact "
              f"{ms_art:.4f} ms, generate {ms_gen:.4f} ms; launches: "
              f"artifact {l_art}, generate {l_gen}")
        if l_art or (want and not l_gen.get(want)) \
                or (not want and l_gen):
            fail(f"phase 19 {label} {dt}: launches artifact {l_art}, "
                 f"generate {l_gen}, expected {want} in generate only")
        if tuple(got.shape) != tuple(gen.shape) \
                or not bool(torch.isfinite(got).all()):
            fail(f"phase 19 {label} {dt}: artifact output "
                 f"{tuple(got.shape)} or not finite")
        if dtype == torch.float32:
            err, tol = max_err(got, gen), SERVE_FP32_TOL[name]
            r["max_abs_err"] = err
            print(f"    {label} fp32: max|artifact - generate| {err:.3e} "
                  f"(bound {tol})")
            if not err <= tol:
                fail(f"phase 19 {label} fp32: artifact {err} from generate")
        else:
            r["max_abs_err"] = max_err(got.float(), gen.float())
            bf16_rule(f"{label} bf16", got, gen, ref32, r)
        rec[f"{label} {dt}"] = r


def serve_unet(torch, np, tmp, counters, rec):
    """Phase 19 (a) and (d): phase 9's pruned U-Net student through
    python -m gcc_tpu_torch.cli.export (in this process) in fp32, bf16 and
    bf16 with int8 weights; a fresh python -I process that cannot import
    gcc_tpu_torch runs the fp32 artifact on the card; the CLI on the CPU
    (--gpu_ids -1) traces one that load_exported moves to the card."""
    import copy

    from gcc_tpu_torch.cli import export
    from gcc_tpu_torch.device import exact_fp32
    from gcc_tpu_torch.utils import serve_export as sx
    from gcc_tpu_torch.utils.checkpoint import save_checkpoint
    from gcc_tpu_torch.utils.weights import (export_jax_variables,
                                             load_jax_variables)

    engine, cfg = unet_engine(torch, np, max(SERVE_BATCHES))
    state = engine.init_state(seed=0)
    net = state.nets["g"]
    tree = export_jax_variables(net)
    ckpt = os.path.join(tmp, "unet_student.ckpt")
    save_checkpoint(ckpt, {"G": tree, "D": None, "epoch": 1,
                           "cfg": (engine.filter_cfgs, engine.channel_cfgs),
                           "fid": None})
    size = cfg.crop_size
    gen = torch.Generator().manual_seed(19)
    x = (torch.rand(max(SERVE_BATCHES), 3, size, size, generator=gen) * 2
         - 1).to(engine.device)
    # phase 9's spread weights (prune_unet's input) drive the eval-mode
    # output to +-1 (BatchNorm's running statistics 0 and 1 do not
    # renormalize them), which would hide any error: the checkpoint holds
    # the engine's seeded init weights
    spread = dict(tree, params=spread_tree(np, tree["params"],
                                           np.random.RandomState(0)))
    probe = copy.deepcopy(net)
    load_jax_variables(probe, spread)
    with torch.no_grad():
        sat = float((probe.eval()(x[:1])[0].abs() > 0.999).float().mean())
        sat_init = float((engine.generate(state, x[:1]).abs() > 0.999)
                         .float().mean())
    del probe
    print(f"  (a) U-Net student {engine.filter_cfgs}: share of output "
          f"pixels at +-1 (|y| > 0.999): {sat:.4f} with phase 9's spread "
          f"weights, {sat_init:.4f} with the seeded init weights the "
          f"checkpoint holds")
    rec["unet saturated share"] = {"spread": sat, "init": sat_init}
    with exact_fp32():
        ref = {torch.float32: engine.generate(state, x),
               torch.bfloat16: engine.generate(state, x.to(torch.bfloat16))}
    base = ["--model", "pix2pix", "--dataroot", "unused", "--name", "serve",
            "--checkpoints_dir", tmp, "--pretrain_path", ckpt, "--ngf",
            str(cfg.ngf), "--num_downs", str(cfg.num_downs), "--crop_size",
            str(size), "--load_size", str(size)]
    paths = {}
    # the default --platforms cpu,cuda once; (d) checks the CPU again
    for mode, flags in (("fp32", []),
                        ("bf16", ["--serve_dtype", "bfloat16",
                                  "--platforms", "cuda"]),
                        ("int8", ["--serve_dtype", "bfloat16",
                                  "--quantize", "int8",
                                  "--platforms", "cuda"])):
        out_dir = os.path.join(tmp, f"serving_{mode}")
        t0 = time.perf_counter()
        export.main(base + flags + ["--output_dir", out_dir])
        export_s = time.perf_counter() - t0
        path = os.path.join(out_dir, "pix2pix_G"
                            + ("_int8" if mode == "int8" else "") + ".pt2")
        paths[mode] = path
        dtype = torch.float32 if mode == "fp32" else torch.bfloat16
        art = sx.load_exported(path, engine.device)
        r = {"export_s": export_s, "mb": os.path.getsize(path) / 1e6}
        with exact_fp32():
            for b in SERVE_BATCHES:
                y, l_art = launched(torch, counters,
                                    lambda: art(x[:b].to(dtype)))
                if tuple(y.shape) != (b, 3, size, size) or l_art \
                        or not bool(torch.isfinite(y).all()):
                    fail(f"phase 19 (a) {mode} at batch {b}: "
                         f"{tuple(y.shape)}, launches {l_art}, or not finite")
            r["max_abs_err"] = max_err(y.float(), ref[dtype].float())
            if mode == "fp32":
                if not r["max_abs_err"] <= SERVE_FP32_TOL["unet"]:
                    fail(f"phase 19 (a) fp32: {r['max_abs_err']} from "
                         f"generate")
            elif mode == "bf16":
                bf16_rule("(a) U-Net bf16", y, ref[dtype],
                          ref[torch.float32], r)
            else:
                r["psnr_db"] = psnr(ref[dtype].float(), y.float())
                if not r["psnr_db"] >= SERVE_INT8_DB:
                    fail(f"phase 19 (a) int8: {r['psnr_db']} dB against "
                         f"the bf16 generate")
            for b in SERVE_TIMED:
                xb = x[:b].to(dtype)
                r[f"artifact_images_per_s_b{b}"] = serve_images_per_s(
                    torch, lambda: art(xb), b)
                r[f"generate_images_per_s_b{b}"] = serve_images_per_s(
                    torch, lambda: engine.generate(state, xb), b)
            if mode == "fp32":  # where the artifact's time goes
                for who, fn in (("artifact", lambda: art(xb)),
                                ("generate",
                                 lambda: engine.generate(state, xb))):
                    with torch.no_grad():
                        ks, wall_us = device_kernels(torch, fn)
                    ks.sort(key=lambda k: -k[1])
                    r[f"{who}_profile_b{b}"] = {
                        "wall_ms": wall_us / 1e3,
                        "device_ms": sum(k[1] for k in ks) / 1e3,
                        "launches": sum(k[2] for k in ks),
                        "top": [(short_name(k[0]), round(k[1] / 1e3, 4), k[2])
                                for k in ks[:4]]}
                    print(f"    (a) fp32 {who} at batch {b} under the "
                          f"profiler: {r[f'{who}_profile_b{b}']}")
        print(f"  (a) {mode}: export {export_s:.2f} s (the CLI, its load "
              f"and call on cpu and cuda included), {r['mb']:.3f} MB; "
              f"served at batches {SERVE_BATCHES}; max|artifact - generate "
              f"{str(dtype).replace('torch.', '')}| {r['max_abs_err']:.3e}"
              + (f", PSNR {r['psnr_db']:.2f} dB" if "psnr_db" in r else "")
              + "; images/s " + ", ".join(
                  f"batch {b}: artifact {r[f'artifact_images_per_s_b{b}']:.1f}"
                  f" generate {r[f'generate_images_per_s_b{b}']:.1f}"
                  for b in SERVE_TIMED))
        rec[f"unet {mode}"] = r

    # (d) a fresh interpreter that cannot import the port runs the int8
    # artifact (the smallest file), after this process's call of it
    xin = os.path.join(tmp, "serve_x.npy")
    yout = os.path.join(tmp, "serve_y.npy")
    xq = x[:SERVE_CHECK].to(torch.bfloat16)
    np.save(xin, xq.float().cpu().numpy())
    with torch.no_grad():
        here = sx.load_exported(paths["int8"], engine.device)(xq)
    t0 = time.perf_counter()
    done = subprocess.run([sys.executable, "-I", "-c", SERVE_LOADER,
                           paths["int8"], xin, yout, engine.device.type,
                           "bfloat16"],
                          cwd=tmp, capture_output=True, text=True,
                          timeout=600)
    seconds = time.perf_counter() - t0
    if done.returncode != 0:
        fail(f"phase 19 (d) python -I: {done.stderr[-2000:]}")
    err = max_err(torch.from_numpy(np.load(yout)).to(here.device),
                  here.float())
    print(f"  (d) python -I without gcc_tpu_torch on "
          f"{done.stdout.strip()}: {seconds:.2f} s, int8 artifact max|d| "
          f"{err:.3e} from this process's call")
    if not err <= 1e-5:
        fail(f"phase 19 (d) python -I: {err}")
    rec["python -I"] = {"seconds": seconds, "max_abs_err": err}
    with exact_fp32(), torch.no_grad():
        here = sx.load_exported(paths["fp32"], engine.device)(
            x[:SERVE_CHECK])
    # (d) traced on the CPU by the CLI, moved to the card
    out_dir = os.path.join(tmp, "serving_cpu")
    t0 = time.perf_counter()
    export.main(base + ["--gpu_ids", "-1", "--output_dir", out_dir])
    cpu_s = time.perf_counter() - t0
    moved = sx.load_exported(os.path.join(out_dir, "pix2pix_G.pt2"), "cuda")
    with exact_fp32(), torch.no_grad():
        err = max_err(moved(x[:SERVE_CHECK]), here)
    print(f"  (d) traced on the CPU ({cpu_s:.2f} s with its checks on cpu "
          f"and cuda), moved by load_exported(path, 'cuda'): max|d| "
          f"{err:.3e} from the artifact traced on the card")
    if not err <= 1e-5:
        fail(f"phase 19 (d) CPU-traced artifact on the card: {err}")
    rec["cpu traced"] = {"export_s": cpu_s, "max_abs_err": err}


def serve_kernel_paths(torch, np, counters, rec):
    """Phase 19 (b) and (c): the generators whose generate runs B2 or B1,
    and SRGAN's, at their phases' full widths."""
    from gcc_tpu_torch.compress import cyclegan_reference_cfgs
    from gcc_tpu_torch.config import Config
    from gcc_tpu_torch.engines.cyclegan import CycleGANEngine
    from gcc_tpu_torch.engines.pix2pix import Pix2PixEngine
    from gcc_tpu_torch.engines.sagan import SAGANEngine
    from gcc_tpu_torch.engines.srgan import SRGANEngine
    from gcc_tpu_torch.ops.attention import SelfAttention

    rng = np.random.RandomState(19)

    def normal(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda()

    def images(b, size):
        return torch.from_numpy((rng.rand(b, 3, size, size) * 2 - 1).astype(
            np.float32)).cuda()

    b2 = {torch.float32: "stage_fwd", torch.bfloat16: "stage_fwd_bf16"}
    b1 = {torch.float32: "attn_fwd", torch.bfloat16: "attn_fwd_bf16"}
    # (b) phase 4's fused pix2pix resnet student, phase 12's CycleGAN
    cfg = main_config(Config, ngf=24, ndf=128, teacher_ngf=64,
                      teacher_ndf=128, crop_size=256, batch_size=4)
    engine = Pix2PixEngine(cfg, filter_cfgs=STUDENT_CFG)
    serve_family(torch, "resnet", engine, engine.init_state(seed=0),
                 images(SERVE_CHECK, 256), counters, b2, rec)
    cfg_a, cfg_b = cyclegan_reference_cfgs()
    cfg = cyclegan_config(Config, crop_size=CYCLEGAN_SIZE,
                          load_size=CYCLEGAN_SIZE, **CYCLEGAN_WIDTHS)
    engine = CycleGANEngine(cfg, cfg_AtoB=cfg_a, cfg_BtoA=cfg_b)
    state = engine.init_state(seed=0)
    x = images(SERVE_CHECK, CYCLEGAN_SIZE)
    for direction in ("AtoB", "BtoA"):
        serve_family(torch, "cyclegan", engine, state, x, counters, b2, rec,
                     direction)
    # (c) phase 7's SAGAN (B1 at N 1024; gammas non-zero, as phase 8's),
    # phase 14's SRGAN
    cfg = sagan_config(Config, ngf=48, ndf=64, teacher_ngf=64,
                       teacher_ndf=64, z_dim=128, batch_size=64)
    engine = SAGANEngine(cfg, filter_cfgs=SAGAN_STUDENT_CFG)
    state = engine.init_state(seed=0)
    for name, mod in state.nets["g"].named_modules():
        if isinstance(mod, SelfAttention):
            mod.gamma.data.fill_(0.5 if name == "attn1" else -0.3)
    serve_family(torch, "sagan", engine, state, normal(8, cfg.z_dim),
                 counters, b1, rec)
    cfg = Config(model="srgan", image_size=SRGAN_HR, **SRGAN_WIDTHS)
    engine = SRGANEngine(cfg, filter_cfgs=srgan_student(np)[0])
    lr_size = SRGAN_HR // 4
    serve_family(torch, "srgan", engine, engine.init_state(seed=0),
                 normal(4, 3, lr_size, lr_size), counters, None, rec)


def phase_serve_export(torch, np):
    """Phase 19: the serving export on the card (module docstring)."""
    import tempfile

    from gcc_tpu_torch.ops import flash_attention as fa
    from gcc_tpu_torch.ops import mobile_block as mb

    t_phase = time.perf_counter()
    print("== phase 19: serving export (gcc_tpu_torch.cli.export, "
          "utils/serve_export.py) on the card")
    counters, rec = (mb.LAUNCHES, fa.LAUNCHES), {}
    with tempfile.TemporaryDirectory() as tmp:
        serve_unet(torch, np, tmp, counters, rec)
    serve_kernel_paths(torch, np, counters, rec)
    rec["seconds"] = round(time.perf_counter() - t_phase, 3)
    print(f"  phase 19 took {rec['seconds']} s")
    return rec

# phase 20: data-parallel training (gcc_tpu_torch/parallel/mesh.py). (a)
# phase 17 (c)'s pix2pix resnet iteration in bf16 (fused blocks, batch 4)
# through the DP path at W = 1 on NCCL, in turns with the same engine
# without a mesh on the same batches; (b) 2 Gloo ranks on the one card (NCCL
# refuses two ranks on one card) against 1 process over the same global
# batch, 2 iterations each: SAGAN with B1 (attn2 at N 1024) and CycleGAN
# with B2 (80 px) and replay pools, at tests/test_torch_parallel.py's bounds
# or, where the card's own floor is above them, at twice that floor: the
# 1-process run again, by the plain route, and (without pools) on its rows
# reversed or rolled, each against the first, measured in the same phase
# (dp_ranks). The CPU tests' bounds assume the
# per-sample arithmetic of one process at one thread, the same at any
# batch; on the card it depends on the batch (cuDNN's algorithms, the
# kernels' grids), and Adam's first steps move a parameter +-lr by the sign
# of its gradient even where that gradient is at noise level
DP_TIMED = 3
DP_LOSS_RTOL = 1e-2  # (a): the first iteration's losses, DP against plain
DP_GRAD_RTOL = 1e-4  # (b): first-update gradients, rms relative by update
# tests/test_torch_parallel.py's SAGAN and CycleGAN, CycleGAN at 80 px, where
# the fused blocks' gate opens (their bounds are set at these widths: at
# ngf 16 two thread counts of one process already move SAGAN's spectral
# vectors 4x past theirs, through Adam's sign steps)
DP_FAMILIES = {
    "sagan": dict(model="sagan", ngf=4, ndf=4, teacher_ngf=8, teacher_ndf=8,
                  crop_size=64, z_dim=16, gan_mode="hinge",
                  online_distillation=True, darts_discriminator=True,
                  lambda_content=1.0, lambda_gram=1.0, lr=2e-4,
                  arch_lr=1e-4),
    "cyclegan": dict(model="cyclegan", ngf=4, ndf=4, teacher_ngf=4,
                     teacher_ndf=4, crop_size=80, gan_mode="lsgan",
                     online_distillation=True, darts_discriminator=True,
                     lambda_content=0.01, lambda_gram=10.0, pool_size=4,
                     fused_resblock="on", lr=2e-4, arch_lr=1e-4),
}
DP_BATCH = {"sagan": 4, "cyclegan": 4}  # global batches


def dp_turn(torch, engine, batches, mesh, counters):
    """One run of the engine over the batches (the first pair a warm-up),
    the counters set to 0 just before and read by iteration: ms, losses,
    B2 launches and the bytes the mesh reduced, by iteration."""
    state = engine.init_state(seed=0)
    torch.cuda.synchronize()
    for k in counters:
        counters[k] = 0
    out = {"ms": [], "losses": [], "launches": [], "bytes": []}
    for i in range(len(batches) // 2):
        before = dict(counters)
        if mesh is not None:
            mesh.reset_counters()
        t0 = time.perf_counter()
        state, m = engine.train_arch_step(state, batches[2 * i],
                                          batches[2 * i + 1], 2e-4, 0.9)
        torch.cuda.synchronize()
        dt = 1e3 * (time.perf_counter() - t0)
        if i:
            out["ms"].append(dt)
        out["losses"].append({k: float(v) for k, v in m.items()})
        out["launches"].append({k: counters[k] - before[k] for k in counters
                                if counters[k] != before[k]})
        out["bytes"].append({} if mesh is None else dict(mesh.counters))
    return out


def dp_overhead(torch, np):
    """Phase 20 (a)."""
    from gcc_tpu_torch.config import Config
    from gcc_tpu_torch.engines.pix2pix import Pix2PixEngine
    from gcc_tpu_torch.ops import mobile_block as mb
    from gcc_tpu_torch.parallel import mesh as pmesh

    batch, size = 4, 256
    print(f"  (a) phase 17 (c)'s pix2pix resnet iteration in bf16 through "
          f"the DP path at W = 1 (NCCL) and without a mesh, in turns, "
          f"{size}px, batch {batch}, 1 warm-up + {DP_TIMED} timed a turn")
    cfg = main_config(Config, ngf=24, ndf=128, teacher_ngf=64,
                      teacher_ndf=128, crop_size=size, batch_size=batch)
    batches = _bf16_batches(torch, make_batches(
        torch, np, 2 * (DP_TIMED + 1), batch, size, 0, "cuda"))
    mesh = pmesh.init_distributed(
        0, 1, f"tcp://127.0.0.1:{pmesh.free_port()}", "cuda:0")
    if mesh.group is None or torch.distributed.get_backend() != "nccl":
        fail("phase 20 (a): the W = 1 mesh is not NCCL")
    runs = {"plain": [], "dp": []}
    try:
        cost = collective_cost(torch, mesh)
        for name in ("plain", "dp", "dp", "plain"):
            engine = Pix2PixEngine(cfg, filter_cfgs=STUDENT_CFG,
                                   mesh=mesh if name == "dp" else None)
            runs[name].append(dp_turn(torch, engine, batches,
                                      engine.mesh, mb.LAUNCHES))
            del engine
            torch.cuda.empty_cache()
    finally:
        pmesh.shutdown()
    for name, turns in runs.items():
        for t in turns:
            for i, got in enumerate(t["launches"]):
                if got != PER_ITER_BF16:
                    fail(f"(a) {name} iteration {i}: B2 launches {got}, "
                         f"expected {PER_ITER_BF16}")
            for losses in t["losses"]:
                if not all(math.isfinite(v) for v in losses.values()):
                    fail(f"(a) {name}: non-finite losses {losses}")
    plain0, dp0 = runs["plain"][0]["losses"][0], runs["dp"][0]["losses"][0]
    worst = max(abs(dp0[k] - plain0[k]) / max(abs(plain0[k]), 1e-3)
                for k in plain0)
    if worst > DP_LOSS_RTOL:
        fail(f"(a) first iteration: DP losses {dp0} against plain {plain0}")
    ms = {k: float(np.mean([m for t in v for m in t["ms"]]))
          for k, v in runs.items()}
    per_iter = runs["dp"][0]["bytes"][1]
    rec = {"plain_ms_per_iter": ms["plain"], "dp_ms_per_iter": ms["dp"],
           "dp_overhead": ms["dp"] / ms["plain"] - 1.0,
           "turn_ms": {k: [float(np.mean(t["ms"])) for t in v]
                       for k, v in runs.items()},
           "bytes_per_iter": per_iter["grad_bytes"] + per_iter["stat_bytes"],
           **{f"{k}_per_iter": v for k, v in per_iter.items()},
           "b2_launches_per_iter": runs["dp"][0]["launches"][1],
           "first_losses_rel_diff": worst, **cost}
    print(f"    plain {ms['plain']:.3f} ms/iteration, DP W=1 {ms['dp']:.3f} "
          f"ms/iteration (overhead {100 * rec['dp_overhead']:.2f} %; turns "
          f"{rec['turn_ms']}); all-reduced per iteration "
          f"{rec['bytes_per_iter']} bytes ({per_iter['grad_calls']} gradient "
          f"all-reduces of {per_iter['grad_bytes']} bytes, "
          f"{per_iter['stat_calls']} statistics collectives of "
          f"{per_iter['stat_bytes']} bytes); B2 {rec['b2_launches_per_iter']} "
          f"an iteration; first-iteration losses within {worst:.2e} "
          f"relative (bound {DP_LOSS_RTOL})")
    print(f"    one NCCL all-reduce at W = 1: {cost['small_call_host_us']:.1f} "
          f"us of host time for 4 bytes, {cost['grad_buffer_ms']:.3f} ms "
          f"(CUDA events) for the iteration's largest gradient buffer of "
          f"{cost['grad_buffer_bytes']} bytes")
    return rec


def collective_cost(torch, mesh, n=200):
    """What one collective of the mesh costs: host us a call of a 4-byte
    all-reduce (n calls, then a synchronize), and the CUDA-event ms of an
    all-reduce of phase 20 (a)'s largest gradient buffer (the student G's
    and transforms' update, fp32)."""
    from gcc_tpu_torch.config import Config
    from gcc_tpu_torch.engines.common import weight_params
    from gcc_tpu_torch.engines.pix2pix import Pix2PixEngine

    small = torch.ones(1, device=mesh.device)
    for _ in range(10):
        torch.distributed.all_reduce(small)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        torch.distributed.all_reduce(small)
    torch.cuda.synchronize()
    host_us = 1e6 * (time.perf_counter() - t0) / n
    cfg = main_config(Config, ngf=24, ndf=128, teacher_ngf=64,
                      teacher_ndf=128, crop_size=256, batch_size=4)
    nets = Pix2PixEngine(cfg, filter_cfgs=STUDENT_CFG).build_nets()
    numel = max(sum(p.numel() for p in ps) for ps in (
        weight_params(nets["g"]) + weight_params(nets["tf"]),
        weight_params(nets["tg"]), weight_params(nets["d"]),
        weight_params(nets["td"])))
    buf = torch.zeros(numel, device=mesh.device)
    ms = cuda_ms(torch, lambda: torch.distributed.all_reduce(buf))
    return {"small_call_host_us": host_us, "grad_buffer_bytes": 4 * numel,
            "grad_buffer_ms": ms}


def dp_batches(np, family):
    """The 2 iterations' global (train, val) batches of a phase 20 (b)
    family, numpy NCHW."""
    cfg, n = DP_FAMILIES[family], DP_BATCH[family]
    rng = np.random.RandomState(5)

    def img(size):
        return (rng.rand(n, 3, size, size) * 2 - 1).astype(np.float32)

    def one():
        if family == "sagan":
            return {"z": rng.randn(n, cfg["z_dim"]).astype(np.float32),
                    "real_img": img(cfg["crop_size"])}
        return {"A": img(cfg["crop_size"]), "B": img(cfg["crop_size"])}

    return [(one(), one()) for _ in range(2)]


def dp_run(family, device, mesh=None, plain=False, order=None):
    """A phase 20 (b) family's 2 iterations on ``device``; under ``mesh`` on
    this rank's rows; ``plain``: without B1 and B2 (the einsum attention,
    the unfused blocks); ``order``: the global batches' rows in that order
    (the same batch, its sums in another order). Metrics, nets (JAX
    layout), the state's checksum, the first update's moments and the B1/B2
    launches counted from 0 just before."""
    import numpy as np
    import torch

    from gcc_tpu_torch.cli.train import engine_class
    from gcc_tpu_torch.config import Config
    from gcc_tpu_torch.ops import flash_attention as fa
    from gcc_tpu_torch.ops import mobile_block as mb
    from gcc_tpu_torch.parallel import mesh as pmesh
    from gcc_tpu_torch.utils.weights import to_jax_nets

    cfg = Config(**DP_FAMILIES[family])
    if plain:
        cfg = cfg.replace(pallas_attn_threshold=2 ** 31,
                          fused_resblock="off")
    engine = engine_class(cfg.model)(cfg, device=device, mesh=mesh)
    state = pmesh.replicate_state(engine.init_state(seed=0), mesh)
    for counters in (mb.LAUNCHES, fa.LAUNCHES):
        for k in counters:
            counters[k] = 0
    metrics, moments = [], None
    for tb, vb in dp_batches(np, family):
        tb, vb = ({k: torch.from_numpy(v if order is None else v[order]).to(
            device) for k, v in b.items()} for b in (tb, vb))
        state, m = engine.train_arch_step(
            state, pmesh.shard_batch(tb, mesh), pmesh.shard_batch(vb, mesh),
            cfg.lr, 0.9)
        metrics.append({k: float(v) for k, v in m.items()})
        if moments is None:  # a fixed multiple of each update's gradient
            moments = {k: np.concatenate([
                np.ravel(a) for a in _first_moments(o.state_dict())])
                for k, o in state.opts.items()}
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    launches = {k: v for c in (mb.LAUNCHES, fa.LAUNCHES)
                for k, v in c.items() if v}
    return {"metrics": metrics, "nets": to_jax_nets(state),
            "checksum": pmesh.state_checksum(state), "launches": launches,
            "moments": moments}


def _first_moments(sd):
    """An optimizer state_dict's first moments (Adam's mu; DupAdam's two)."""
    if "mu" in sd:
        return sd["mu"]
    return sd["single"]["mu"] + sd["double"]["mu"]


def dp_rank(mesh, out_dir):
    """A phase 20 (b) rank: each family's run, pickled by rank. A new
    process: TF32 off, as main sets it for the 1-process run."""
    import pickle

    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for family in DP_FAMILIES:
        res = dp_run(family, mesh.device, mesh)
        with open(os.path.join(out_dir, f"{family}.{mesh.rank}.pkl"),
                  "wb") as f:
            pickle.dump(res, f)


def _tree_leaves(tree, prefix=""):
    if not isinstance(tree, dict):
        yield prefix.rstrip("/"), tree
        return
    for k in sorted(tree):
        yield from _tree_leaves(tree[k], f"{prefix}{k}/")


def dp_agree(np, one, two, what):
    """tests/test_torch_parallel.py's bounds, as the worst ratio of a
    difference to its bound: losses rtol 2e-4 / atol 1e-5 (the first
    iteration's on their own); generators' BatchNorm scale, bias and running
    stats 2e-5 / 2e-3; spectral u, v 1e-5 / 1e-4; every other leaf atol
    1e-3; and the first update's gradients (Adam's first moments, a fixed
    multiple of them), rms relative by update, DP_GRAD_RTOL."""
    worst = {}

    def held(name, a, b, atol, rtol):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        r = float(np.max(np.abs(a - b) / (atol + rtol * np.abs(a))))
        worst[name] = max(worst.get(name, 0.0), r)

    for i, (a, b) in enumerate(zip(one["metrics"], two["metrics"])):
        if set(a) != set(b):
            fail(f"{what}: metrics {sorted(a)} against {sorted(b)}")
        for k in a:
            held("losses", a[k], b[k], 1e-5, 2e-4)
            if i == 0:
                held("first-iteration losses", a[k], b[k], 1e-5, 2e-4)
    for net, colls in one["nets"].items():
        for coll, tree in colls.items():
            other = dict(_tree_leaves(two["nets"][net][coll]))
            leaves = dict(_tree_leaves(tree))
            norms = {p.rsplit("/", 1)[0] for p in leaves
                     if p.endswith("/scale")}
            for path, a in leaves.items():
                d_side = net.lstrip("t").startswith("d")
                if not d_side and (coll == "batch_stats"
                                   or path.rsplit("/", 1)[0] in norms):
                    held("generator BatchNorm", a, other[path], 2e-5, 2e-3)
                elif coll == "spectral":
                    held("spectral u, v", a, other[path], 1e-5, 1e-4)
                else:
                    held("other leaves", a, other[path], 1e-3, 0.0)
    for k, a in one["moments"].items():
        b = two["moments"][k]
        den = float(np.sqrt(np.sum(np.square(a, dtype=np.float64))))
        err = float(np.sqrt(np.sum(np.square(a - b, dtype=np.float64))))
        worst["first-update gradients"] = max(
            worst.get("first-update gradients", 0.0),
            (err / den if den else 0.0) / DP_GRAD_RTOL)
    return worst


def dp_ranks(torch, np):
    """Phase 20 (b)."""
    import pickle
    import tempfile

    from gcc_tpu_torch.parallel import mesh as pmesh

    print("  (b) 2 Gloo ranks on the one card against 1 process, the same "
          f"global batch ({DP_BATCH}), 2 iterations: SAGAN (B1) and "
          "CycleGAN (fused blocks, pools of 4)")
    one = {f: dp_run(f, "cuda") for f in DP_FAMILIES}
    # the card's floor: the 1-process run again (the card's convolutions
    # need not repeat bit for bit), by the plain route (another valid
    # arithmetic, phases 5 and 8), and, where rows are exchangeable (no
    # replay pool, whose fill follows the rows), on the batch's rows
    # reversed and rolled (every batch sum in another order, as the ranks
    # sum them)
    floor_runs = {f: {"again": dp_run(f, "cuda"),
                      "plain route": dp_run(f, "cuda", plain=True)}
                  for f in DP_FAMILIES}
    for f, cfg in DP_FAMILIES.items():
        if not cfg.get("pool_size"):
            n = DP_BATCH[f]
            for name, order in (("rows reversed", np.arange(n)[::-1]),
                                ("rows rolled by 1", np.roll(np.arange(n), 1)),
                                ("rows rolled by 2",
                                 np.roll(np.arange(n), 2))):
                floor_runs[f][name] = dp_run(f, "cuda", order=order)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        pmesh.spawn(dp_rank, 2, args=(tmp,), device_kind="cuda",
                    devices=[0, 0], backend="gloo", timeout=300.0)
        spawn_s = time.perf_counter() - t0
        two = {f: [pickle.load(open(os.path.join(tmp, f"{f}.{r}.pkl"),
                                    "rb")) for r in (0, 1)]
               for f in DP_FAMILIES}
    rec, failed = {"spawn_s": spawn_s}, []
    for f in DP_FAMILIES:
        r0, r1 = two[f]
        if r0["checksum"] != r1["checksum"]:
            failed.append(f"(b) {f}: the two ranks' states differ")
        kernel = "attn_fwd" if f == "sagan" else "stage_fwd"
        for who, res in (("1 process", one[f]), ("rank 0", r0),
                         ("rank 1", r1)):
            if not res["launches"].get(kernel):
                failed.append(f"(b) {f} {who}: {kernel} not launched "
                              f"({res['launches']})")
        if floor_runs[f]["plain route"]["launches"]:
            failed.append(f"(b) {f}: the plain run launched "
                          f"{floor_runs[f]['plain route']['launches']}")
        worst = {}
        for r in (r0, r1):
            for k, v in dp_agree(np, one[f], r, f).items():
                worst[k] = max(worst.get(k, 0.0), v)
        floors = {name: dp_agree(np, one[f], run, f"{f} {name}")
                  for name, run in floor_runs[f].items()}
        floor = {k: max(fl[k] for fl in floors.values()) for k in worst}
        allowed = {k: max(1.0, 2.0 * floor[k]) for k in worst}
        rec[f] = {"worst_ratio_to_bound": worst, "floors": floors,
                  "allowed_ratio": allowed,
                  "launches_1_process": one[f]["launches"],
                  "launches_a_rank": r0["launches"],
                  "ranks_bit_equal": r0["checksum"] == r1["checksum"]}
        print(f"    {f}: difference / the CPU tests' bound, 2 ranks against "
              f"1 process {worst}; the same for the 1-process floor runs "
              f"{floors}; allowed "
              f"{allowed}; launches 1 process {one[f]['launches']}, a rank "
              f"{r0['launches']}; the ranks' states bit for bit equal: "
              f"{rec[f]['ranks_bit_equal']}")
        over = {k: v for k, v in worst.items() if not v <= allowed[k]}
        if over:
            failed.append(f"(b) {f}: 2 ranks against 1 process past the "
                          f"bounds {over}")
    print(f"    the two ranks took {spawn_s:.1f} s, start-up included")
    if failed:
        fail("; ".join(failed))
    return rec


def phase_dp(torch, np):
    """Phase 20: data-parallel training (module docstring)."""
    t_phase = time.perf_counter()
    print("== phase 20: data-parallel training (parallel/mesh.py)")
    rec = {"w1_nccl": dp_overhead(torch, np), "two_gloo_ranks":
           dp_ranks(torch, np)}
    rec["seconds"] = round(time.perf_counter() - t_phase, 3)
    print(f"  phase 20 took {rec['seconds']} s")
    return rec


# phase 21: row-sharded eval (gcc_tpu_torch/parallel/spatial.py). (a) each
# full-width generator in fp32 (TF32 off) sharded over 2 and over 4 Gloo
# ranks on the one card (NCCL refuses two ranks on one card), against the
# unsharded forward of the same weights on the same input on the card, by
# the route the view takes (the unfused blocks): within 1e-4 on the tanh
# outputs, or within twice the floor measured beside it, the unsharded fp32
# output's distance from the same forward in float64, where that is larger;
# the fused generate (B2) beside it within 1e-3 (phases 5's and 19's
# bound). (b) the eval path, orchestrators._collect with --spatial_shards 2
# over 2 ranks, against the unsharded _collect: the same images within
# 1e-4. One image whose rows the ranks share buys memory a rank, not speed:
# the ranks share one card and its time, and every exchange goes through
# the host (Gloo)
SPATIAL_WORLDS = (2, 4)
SPATIAL_ATOL = 1e-4
SPATIAL_FUSED_ATOL = 1e-3
SPATIAL_TIMED = 2
# name: (net, constructor kwargs, input (batch, height, width))
SPATIAL_CASES = {
    "srresnet_x4_256": ("srresnet", dict(n_channels=64, n_blocks=16,
                                         scaling_factor=4), (1, 256, 256)),
    "srresnet_x4_512": ("srresnet", dict(n_channels=64, n_blocks=16,
                                         scaling_factor=4), (1, 512, 512)),
    "pix2pix_resnet_teacher": ("mobile_resnet", dict(
        ngf=64, n_blocks=9, use_fused_blocks=True), (1, 512, 1024)),
    "unet_teacher": ("unet", dict(ngf=64, num_downs=8, use_dropout=True),
                     (1, 256, 256)),
    "cyclegan_BtoA_student": ("mobile_resnet", dict(
        ngf=24, n_blocks=9, cfg="BtoA", use_fused_blocks=True),
        (1, 256, 256)),
}
SPATIAL_EVAL = dict(model="pix2pix", backbone="unet", ngf=64, ndf=64,
                    num_downs=8, crop_size=256, load_size=256,
                    dataroot="synthetic", dataset_mode="synthetic",
                    max_dataset_size=4, eval_batch=2)


def spatial_net(torch, name):
    """A phase 21 generator from a seed, in eval mode on the CPU, its
    BatchNorm running statistics spread so that they take part."""
    from gcc_tpu_torch.compress import cyclegan_reference_cfgs
    from gcc_tpu_torch.models import generators as G
    from gcc_tpu_torch.ops.layers import BatchNorm, init_params

    kind, kw, _ = SPATIAL_CASES[name]
    kw = dict(kw)
    if kw.get("cfg") == "BtoA":
        kw["cfg"] = cyclegan_reference_cfgs()[1]
    net = {"srresnet": G.SRResNet, "mobile_resnet": G.MobileResnetGenerator,
           "unet": G.UnetGenerator}[kind](**kw)
    gen = torch.Generator().manual_seed(21)
    init_params(net, gen)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.normal_(0.0, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    return net.eval()


def spatial_input(torch, np, name):
    n, h, w = SPATIAL_CASES[name][2]
    rng = np.random.RandomState(21)
    return torch.from_numpy((rng.rand(n, 3, h, w) * 2 - 1).astype(np.float32))


def spatial_rank(mesh, out_dir):
    """A phase 21 rank: every case sharded over the group's ranks (one
    warm-up, SPATIAL_TIMED timed calls), and with two ranks (b)'s eval
    path; pickled by rank. A new process: TF32 off, as main sets it."""
    import pickle

    import numpy as np
    import torch

    from gcc_tpu_torch.engines.common import generate_rows
    from gcc_tpu_torch.ops import mobile_block as mb
    from gcc_tpu_torch.parallel import spatial

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, cuda = mesh.device, mesh.device.type == "cuda"
    grid = spatial.default_mesh()
    res = {"cases": {}}
    for name in SPATIAL_CASES:
        net = spatial_net(torch, name).to(dev)
        x = spatial_input(torch, np, name).to(dev)
        generate_rows(net, x, mesh.world)
        if cuda:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        mb.reset_launches()
        grid.reset_counters()
        ms = []
        for _ in range(SPATIAL_TIMED):
            t0 = time.perf_counter()
            out = generate_rows(net, x, mesh.world)
            if cuda:
                torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        host = out.cpu().numpy()
        res["cases"][name] = {
            "ms": ms, "base_bytes": base if cuda else None,
            "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None,
            "per_image": {k: v / (SPATIAL_TIMED * x.shape[0])
                          for k, v in grid.counters.items()},
            "b2": {k: v for k, v in mb.LAUNCHES.items() if v},
            "sum": hashlib.sha256(host.tobytes()).hexdigest(),
            "out": host if mesh.rank == 0 else None}
        del net, x, out
        if cuda:
            torch.cuda.empty_cache()
    if mesh.world == 2:
        res["eval"] = spatial_collect(torch, dev, 2)
    with open(os.path.join(out_dir, f"{mesh.rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def spatial_collect(torch, dev, shards):
    """(b): orchestrators._collect over SPATIAL_EVAL's eval loader, its
    rows sharded up to ``shards`` ways; the fakes, NHWC numpy."""
    from gcc_tpu_torch.config import Config
    from gcc_tpu_torch.data import create_dataset
    from gcc_tpu_torch.engines.pix2pix import Pix2PixEngine
    from gcc_tpu_torch.eval.orchestrators import _collect, eval_cfg

    cfg = Config(**SPATIAL_EVAL, spatial_shards=shards)
    engine = Pix2PixEngine(cfg, device=dev)
    state = engine.init_state(seed=0)
    loader = create_dataset(eval_cfg(cfg, load_size=256), seed=1234)
    return _collect(cfg, engine, state, loader, "A", "B")[0]


def spatial_reference(torch, np, name, dev):
    """The unsharded side of a case on ``dev``: the engines' generate (the
    fused blocks where the net has them; B2 counted), its ms and peak
    memory, the unfused forward the view takes, and the float64 floor."""
    from gcc_tpu_torch.ops import mobile_block as mb

    cuda = dev.type == "cuda"
    net = spatial_net(torch, name).to(dev)
    x = spatial_input(torch, np, name).to(dev)

    def generate():
        with torch.no_grad():
            return net(x)[0]

    generate()
    if cuda:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    mb.reset_launches()
    ms = []
    for _ in range(SPATIAL_TIMED):
        t0 = time.perf_counter()
        fused = generate()
        if cuda:
            torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    rec = {"ms": ms, "base_bytes": base if cuda else None,
           "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None,
           "b2_per_image": {k: v / (SPATIAL_TIMED * x.shape[0])
                            for k, v in mb.LAUNCHES.items() if v}}
    has_fused = bool(getattr(net, "use_fused_blocks", False))
    if has_fused:
        net.use_fused_blocks = False
    plain = generate()
    net.double()
    x = x.double()
    floor = float((generate() - plain.double()).abs().max())
    del net, x
    if cuda:
        torch.cuda.empty_cache()
    return rec, plain.cpu().numpy(), fused.cpu().numpy() if has_fused \
        else None, floor


def phase_spatial(torch, np, device="cuda"):
    """Phase 21: row-sharded eval (the comment above SPATIAL_WORLDS)."""
    import pickle
    import tempfile

    from gcc_tpu_torch.parallel import mesh as pmesh

    t_phase = time.perf_counter()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    print("== phase 21: row-sharded eval (parallel/spatial.py), fp32, "
          f"{'/'.join(map(str, SPATIAL_WORLDS))} Gloo ranks on the one card")
    ranks = {}
    for world in SPATIAL_WORLDS:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            pmesh.spawn(spatial_rank, world, args=(tmp,),
                        device_kind="cuda" if cuda else "cpu",
                        devices=[dev.index or 0] * world, backend="gloo",
                        threads=None if cuda else 1, timeout=300.0)
            ranks[world] = [pickle.load(open(os.path.join(
                tmp, f"{r}.pkl"), "rb")) for r in range(world)]
            print(f"  {world} ranks took {time.perf_counter() - t0:.1f} s, "
                  "start-up included")
    rec, failed = {"cases": {}}, []
    gib = 2 ** 30
    for name in SPATIAL_CASES:
        ref, plain, fused, floor = spatial_reference(torch, np, name, dev)
        bound = max(SPATIAL_ATOL, 2.0 * floor)
        case = {"unsharded": {"ms_per_image": float(np.mean(ref["ms"])),
                              "peak_gib": None if not cuda else
                              ref["peak_bytes"] / gib,
                              "peak_above_base_gib": None if not cuda else
                              (ref["peak_bytes"] - ref["base_bytes"]) / gib,
                              "b2_per_image": ref["b2_per_image"]},
                "float64_floor": floor, "bound": bound,
                "out_mean_abs": float(np.abs(plain).mean()),
                "out_share_saturated": float((np.abs(plain) > 0.99).mean())}
        if "pix2pix" in name or "cyclegan" in name:
            if cuda and not ref["b2_per_image"]:
                failed.append(f"(a) {name}: the unsharded generate "
                              "launched no B2")
        for world, res in ranks.items():
            got = [r["cases"][name] for r in res]
            out = got[0]["out"]
            diff = float(np.abs(out - plain).max())
            row = {"max_abs_diff": diff, "ratio_to_bound": diff / bound,
                   "ms_per_image": float(np.mean(got[0]["ms"])) /
                   SPATIAL_CASES[name][2][0],
                   "peak_gib_by_rank": None if not cuda else
                   [g["peak_bytes"] / gib for g in got],
                   "peak_above_base_gib_by_rank": None if not cuda else
                   [(g["peak_bytes"] - g["base_bytes"]) / gib for g in got],
                   "per_image": got[0]["per_image"],
                   "b2_under_the_view": [g["b2"] for g in got],
                   "ranks_bit_equal": len({g["sum"] for g in got}) == 1}
            if fused is not None:
                row["max_abs_diff_to_fused"] = float(np.abs(out - fused).max())
                if not row["max_abs_diff_to_fused"] <= SPATIAL_FUSED_ATOL:
                    failed.append(f"(a) {name} over {world}: "
                                  f"{row['max_abs_diff_to_fused']} from the "
                                  "fused generate")
            if not diff <= bound:
                failed.append(f"(a) {name} over {world}: max |sharded - "
                              f"unsharded| {diff} > {bound}")
            if any(g["b2"] for g in got):
                failed.append(f"(a) {name} over {world}: B2 launched under "
                              f"the view {[g['b2'] for g in got]}")
            if not row["ranks_bit_equal"]:
                failed.append(f"(a) {name} over {world}: the ranks' outputs "
                              "differ")
            case[f"{world}_ranks"] = row
        rec["cases"][name] = case
        print(f"  (a) {name} {SPATIAL_CASES[name][2]}: {json.dumps(case)}")
    plain = spatial_collect(torch, dev, 1)
    sharded = ranks[2][0]["eval"]
    diff = float(np.abs(sharded - plain).max())
    rec["eval"] = {"images": int(plain.shape[0]), "shape": list(plain.shape),
                   "max_abs_diff": diff, "bound": SPATIAL_ATOL,
                   "ranks_equal": bool(np.array_equal(sharded,
                                                      ranks[2][1]["eval"]))}
    print(f"  (b) _collect --spatial_shards 2 on 2 ranks against 1 process: "
          f"{json.dumps(rec['eval'])}")
    if not diff <= SPATIAL_ATOL or not rec["eval"]["ranks_equal"]:
        failed.append(f"(b) the sharded eval's images {rec['eval']}")
    rec["seconds"] = round(time.perf_counter() - t_phase, 3)
    print(f"  phase 21 took {rec['seconds']} s")
    if failed:
        fail("phase 21: " + "; ".join(failed))
    return rec


# phase 22: train-mode BatchNorm in bf16 (ops/batch_norm.py), at the U-Net
# teacher's up_norm_1 and the PatchGAN's norm_3 at ndf 128, batch 128
BN_TIMED = [("unet_up_norm_1", 128, 64, 128, 128),
            ("patchgan_norm_3", 128, 1024, 31, 31)]
BN_BYTES = {"fwd": 6, "bwd": 10}  # bytes an element, each way


def phase_batch_norm(torch, F, device="cuda"):
    """Each BatchNorm kernel pair against its plain version at BN_TIMED's
    shapes, two calls bit for bit, then CUDA-event times of the forward and
    the backward alone against their byte bounds, the device time of each
    launch, and the layer's former fp32 chain (the plain forward under
    autograd, its backward by autograd) and F.batch_norm timed the same
    way."""
    from gcc_tpu_torch.ops import batch_norm as bn
    from gcc_tpu_torch.ops import kernels

    print("== phase 22: train-mode BatchNorm in bf16, kernels against their "
          "plain versions and their byte bounds")
    dev, bf16 = torch.device(device), torch.bfloat16
    out = {}
    for name, N, C, H, W in BN_TIMED:
        gen = torch.Generator(device=dev).manual_seed(0)

        def rnd(*shape, scale=1.0, shift=0.0):
            return torch.randn(*shape, device=dev, generator=gen) * scale \
                + shift

        x = rnd(N, C, H, W, scale=1.5, shift=0.3).to(bf16)
        g = rnd(N, C, H, W, scale=0.01).to(bf16)
        w, b = rnd(C, scale=0.02, shift=1.0), rnd(C)
        rm, rv = torch.zeros(C, device=dev), torch.ones(C, device=dev)
        y, mean, invstd = bn.bn_fwd(x, w, b, rm, rv)
        y_p, mean_p, invstd_p = bn.bn_fwd_plain(x, w, b)
        dx, dw, db = bn.bn_bwd(g, x, mean, invstd, w)
        dx_p, dw_p, db_p = bn.bn_bwd_plain(g, x, mean, invstd, w)
        rec = {}
        for what, got, ref in (("y", y, y_p), ("dx", dx, dx_p)):
            ulps, err, share = kernels.bf16_err(got, ref)
            rec[f"{what}_ulps"], rec[f"{what}_share"] = ulps, share
            if ulps > bn.BF16_ULPS or share > bn.BF16_SHARE:
                fail(f"phase 22 {name} {what}: {ulps} ulps, {share} of the "
                     f"elements apart")
        for what, got, ref, rtol in (("mean", mean, mean_p, bn.STAT_RTOL),
                                     ("invstd", invstd, invstd_p,
                                      bn.STAT_RTOL),
                                     ("dw", dw, dw_p, bn.GRAD_RTOL),
                                     ("db", db, db_p, bn.GRAD_RTOL)):
            rel = max_err(got, ref) / float(ref.abs().max())
            rec[f"{what}_rel"] = rel
            if not rel <= rtol:
                fail(f"phase 22 {name} {what}: {rel} of its largest value")
        again = bn.bn_fwd(x, w, b) + bn.bn_bwd(g, x, mean, invstd, w)
        if not all(torch.equal(a, c) for a, c in zip(
                (y, mean, invstd, dx, dw, db), again)):
            fail(f"phase 22 {name}: two calls differ")

        def fwd():
            bn.bn_fwd(x, w, b, rm, rv)

        def bwd():
            bn.bn_bwd(g, x, mean, invstd, w)

        xr = x.detach().requires_grad_(True)
        wr, br = w.detach().requires_grad_(True), \
            b.detach().requires_grad_(True)

        def chain_fwd():
            bn.bn_fwd_plain(xr, wr, br, rm, rv)

        def chain_fwd_bwd():
            bn.bn_fwd_plain(xr, wr, br, rm, rv)[0].backward(g)

        elements = N * C * H * W
        for way, fn in (("fwd", fwd), ("bwd", bwd)):
            rec[f"{way}_ms"] = cuda_ms(torch, fn)
            rec[f"{way}_bound_ms"] = \
                BN_BYTES[way] * elements / HBM_BYTES_PER_S * 1e3
            split = launch_split(torch, fn, launches=2)
            print_split(f"{name} {way}", split)
            rec[f"{way}_device_ms"] = device_ms(split)
            rec[f"{way}_by_launch"] = split
        rec["chain_fwd_ms"] = cuda_ms(torch, chain_fwd, n=5)
        rec["chain_fwd_bwd_ms"] = cuda_ms(torch, chain_fwd_bwd, n=5)
        rec["chain_fwd_launches"] = len(launch_split(torch, chain_fwd, n=5))
        # the yardstick: torch's own train-mode batch_norm (cuDNN or ATen;
        # two-pass statistics), which the port does not call
        rl, vl = rm.clone(), rv.clone()
        rec["library_fwd_ms"] = cuda_ms(torch, lambda: F.batch_norm(
            x, rl, vl, w, b, training=True), n=5)
        rec["library_fwd_bwd_ms"] = cuda_ms(torch, lambda: F.batch_norm(
            xr, rl, vl, wr, br, training=True).backward(g), n=5)
        print(f"  {name} ({N} x {C} x {H} x {W}): forward {rec['fwd_ms']:.4f}"
              f" ms (bound {rec['fwd_bound_ms']:.4f}, "
              f"{100 * rec['fwd_bound_ms'] / rec['fwd_ms']:.1f} %), backward "
              f"{rec['bwd_ms']:.4f} ms (bound {rec['bwd_bound_ms']:.4f}, "
              f"{100 * rec['bwd_bound_ms'] / rec['bwd_ms']:.1f} %); the fp32 "
              f"chain {rec['chain_fwd_ms']:.4f} ms forward, "
              f"{rec['chain_fwd_bwd_ms']:.4f} ms with its backward; "
              f"F.batch_norm {rec['library_fwd_ms']:.4f} / "
              f"{rec['library_fwd_bwd_ms']:.4f} ms; y "
              f"{rec['y_ulps']:g} ulps ({rec['y_share']:.2e} apart), dx "
              f"{rec['dx_ulps']:g} ulps ({rec['dx_share']:.2e} apart)")
        out[name] = rec
        del x, g, y, y_p, dx, dx_p, xr, again
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main():
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from gcc_tpu_torch.ops import kernels

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"== phase 1: card {name}; {torch.cuda.device_count()} visible; "
          f"torch {torch.__version__} CUDA {torch.version.cuda}")
    print(smi)

    # more nvcc beside the build's, all started together: earlier B1 and B2
    # sources for phases 6's and 3's bit checks and phase 17 (a)'s timing in
    # turns, where they were put in place, and the registers and spills of
    # mobile_block_bf16.cu (phase 17 (a)) and flash_attention_bf16.cu (18 (a))
    sigs = kernels.SIGNATURES
    parents = {"b1": start_parent_build(B1_PARENT, "flash_attention"),
               "b2": start_parent_build(B2_PARENT, "mobile_block"),
               "b2_bf16": start_parent_build(B2_PARENT, "mobile_block_bf16")}
    ptxas = {n: start_ptxas(n)
             for n in ("mobile_block_bf16", "flash_attention_bf16")}
    print(f"== phase 2: build {kernels.build():.2f} s (nvcc, from "
          f"{kernels.CSRC})")
    parent = parent_library(
        parents["b1"], B1_PARENT, "flash_attention",
        {fn: sigs["flash_attention"][fn]
         for fn in ("gcc_attn_fwd", "gcc_attn_bwd_groups", "gcc_attn_bwd")},
        "phase 6's bit check of B1's fp32 outputs")
    b2_parent = parent_library(
        parents["b2"], B2_PARENT, "mobile_block",
        {**{fn: sigs["mobile_block"][fn]
            for fn in ("gcc_stage_fwd", "gcc_stage_bwd_pw_partials",
                       "gcc_stage_bwd_pw", "gcc_stage_bwd_dw")},
         **B2_PARENT_DW_BF16},
        "phase 3's bit check of B2's fp32 outputs")
    b2_bf16_parent = parent_library(
        parents["b2_bf16"], B2_PARENT, "mobile_block_bf16", B2_PARENT_BF16,
        "phase 17 (a)'s bf16 bit check and timing in turns")
    if b2_parent is None or b2_bf16_parent is None:
        b2_bf16_parent = None
    ptxas = {n: ptxas_log(v) for n, v in ptxas.items()}

    record = phase_kernels(torch, F, b2_parent)
    # launches: the main path's (pix2pix resnet for B2, SAGAN for B1);
    # by_path: each path's own count, each read from counters set to 0
    # just before the path
    fp32 = {"unet": {}, "resnet": {}}
    launches = phase_main(torch, np, fp32["resnet"])
    by_path = {k: {"pix2pix resnet": v} for k, v in launches.items()}
    phase_agree(torch, np)
    record.update(phase_attention(torch, F, parent))
    sagan = phase_sagan(torch, np)
    launches.update(sagan)
    by_path.update({k: {"sagan": v} for k, v in sagan.items()})
    phase_sagan_agree(torch, np)
    phase_unet(torch, np, fp32["unet"])
    phase_unet_agree(torch, np)
    cli = phase_cli(torch, np)
    for k, v in phase_cyclegan(torch, np).items():
        by_path[k]["cyclegan"] = v
    phase_cyclegan_agree(torch, np)
    phase_srgan(torch, np)
    evaluators = phase_evaluators(torch, np)
    pipeline, pipe_paths = phase_pipeline(torch, np, smi)
    for k, v in pipe_paths.items():
        by_path[k].update(v)
    bf16_record, bf16_launches, bf16 = phase_bf16(
        torch, np, F, fp32,
        None if b2_bf16_parent is None else (b2_parent, b2_bf16_parent),
        ptxas["mobile_block_bf16"])
    record.update(bf16_record)
    for k in PER_ITER_BF16:
        launches[k] = bf16_launches[k]
        by_path[k] = {"pix2pix resnet bf16": bf16_launches[k]}
    attn_record, sagan_bf16, cg_bf16, families = phase_bf16_families(
        torch, np, F, ptxas["flash_attention_bf16"])
    record.update(attn_record)
    for k in ATTN_PER_ITER_BF16:
        launches[k] = sagan_bf16[k]
        by_path[k] = {"sagan bf16": sagan_bf16[k]}
    for k in PER_ITER_BF16:
        by_path[k]["cyclegan bf16"] = cg_bf16[k]
    serve = phase_serve_export(torch, np)
    dp = phase_dp(torch, np)
    spatial = phase_spatial(torch, np)
    batch_norm = phase_batch_norm(torch, F)
    for k, v in dp["w1_nccl"]["b2_launches_per_iter"].items():
        by_path[k]["pix2pix resnet bf16, DP W=1, an iteration"] = v

    entries = []
    for k, rec in record.items():
        family, csrc = (("B1", "flash_attention") if k.startswith("attn")
                        else ("B2", "mobile_block"))
        if k.endswith("_bf16"):
            csrc = f"{csrc}_bf16"
        short = k.replace("stage_", "").replace("attn_", "").replace("_", "-")
        entries.append({
            "name": f"{family}-{short}", "route": "cuda",
            "source": f"gcc_tpu_torch/csrc/{csrc}.cu",
            "replaces": TPU_KERNEL[k], "launches": launches[k],
            "launches_by_path": by_path[k],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            **{m: rec[m] for m in ("max_ulps", "max_share", "max_rel_dw",
                                   "float64_share", "plain_float64_share",
                                   "library", "bf16_route", "device_ms",
                                   "launches_a_call", "cudnn_partial_ms",
                                   "turns_ms", "earlier_ms",
                                   "turns_device_ms", "earlier_device_ms",
                                   "host_us", "earlier_host_us")
               if m in rec}})
    print(json.dumps({"cli": cli}))
    print(json.dumps({"evaluators": evaluators}))
    print(json.dumps({"pipeline": pipeline}))
    print(json.dumps({"bf16": bf16}))
    print(json.dumps({"bf16_families": families}))
    print(json.dumps({"serve_export": serve}))
    print(json.dumps({"dp": dp}))
    print(json.dumps({"spatial": spatial}))
    print(json.dumps({"batch_norm": batch_norm}))
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
