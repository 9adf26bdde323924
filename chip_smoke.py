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
              give the same bits; CUDA-event times of the kernel, the plain
              version and the cuDNN route of the stage at teacher_relu,
              student_relu, cg_teacher_relu and cg_student_relu, cuDNN's convolution backward of the two
              backward kernels' convolution parts (a partial yardstick),
              and the device time of each launch of one call of each
              (torch.profiler);
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
              same bits; the backward's dq scratch in bytes; CUDA-event
              times of the kernel and the plain version (and, at the main
              path's shapes, F.scaled_dot_product_attention(scale=1)),
              forward and backward; then N 65536 (B 1, dq 8, dv 64) on the
              kernels alone: finite outputs, and the peak device memory
              above the inputs and outputs;
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
The run is fp32 throughout: TF32 is off for cuDNN and matmul, except in
phase 15 (g). The last five lines are phase 11's JSON record of its stages,
phase 15's, the card's name and power limit, the kernels' JSON record and
{"ok": true, "device": ...}. A kernel's "launches" is the main path's count
(phase 4 for B2, phase 7 for B1); "launches_by_path" adds phase 12's for
B2.
"""

import ast
import concurrent.futures
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
# split-TF32: three TF32 tensor-core products (495 TFLOP/s dense) per product
TF32X3_FLOPS = 495e12 / 3
PER_ITER = {"stage_fwd": 108, "stage_bwd_pw": 36, "stage_bwd_dw": 36}
TPU_KERNEL = {"stage_fwd": "gcc_tpu/ops/pallas/mobile_block.py:155",
              "stage_bwd_pw": "gcc_tpu/ops/pallas/mobile_block.py:187",
              "stage_bwd_dw": "gcc_tpu/ops/pallas/mobile_block.py:220",
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


def stage_bounds(B, C, M, HW, relu, res):
    """Least time for each wrapper's work at one shape: its inputs read once,
    outputs written once (fp32); its flops at the peak of the units they run
    on: the pointwise products (forward b, backward d a-hat and dW) on the
    tensor cores in split-TF32, everything else on the fp32 CUDA cores. The
    bytes are those of the TPU kernel's function (forward: x in, y out;
    backward: x and the upstream gradient in, the gradients out): what the
    port also saves in the forward and reads back in the backward is not the
    function's work. Printed beside them: "*_saved", the bounds with those
    tensors (a-hat, b-hat, 1/std of a and b) counted, and "*_fp32", with
    every flop on the fp32 cores."""
    act_c, act_m = B * C * HW, B * M * HW
    # inputs x, dwk, pwk, residual; output y
    fwd_bytes = 4 * (act_c + 9 * C + M * C + (act_m if res else 0) + act_m)
    saved_bytes = 4 * (act_c + act_m + B * C + B * M)
    gemm = 2 * act_m * C
    rest = 18 * act_c + 5 * (act_c + act_m) + (act_m if relu or res else 0)
    # backward, pointwise side: inputs x, dwk, pwk, g; outputs d a-hat, d pwk;
    # the port reads g, a-hat, b-hat, 1/std of b and pwk
    pw_bytes = 4 * (act_c + 9 * C + M * C + act_m + act_c + M * C)
    pw_saved = 4 * (2 * act_m + B * M + M * C + 2 * act_c + M * C)
    pw_prod, pw_rest = 4 * act_m * C, 6 * act_m
    # backward, depthwise side: inputs x, dwk, d a-hat; outputs dx, d dwk;
    # the port also reads a-hat and 1/std of a
    dw_bytes = 4 * (3 * act_c + 18 * C)
    dw_work = (42 * act_c, FP32_FLOPS)
    return {"stage_fwd": bound_ms(fwd_bytes, (gemm, TF32X3_FLOPS),
                                  (rest, FP32_FLOPS)),
            "stage_fwd_saved": bound_ms(fwd_bytes + saved_bytes,
                                        (gemm, TF32X3_FLOPS),
                                        (rest, FP32_FLOPS)),
            "stage_fwd_fp32": bound_ms(fwd_bytes, (gemm + rest, FP32_FLOPS)),
            "stage_bwd_pw": bound_ms(pw_bytes, (pw_prod, TF32X3_FLOPS),
                                     (pw_rest, FP32_FLOPS)),
            "stage_bwd_pw_saved": bound_ms(pw_saved, (pw_prod, TF32X3_FLOPS),
                                           (pw_rest, FP32_FLOPS)),
            "stage_bwd_pw_fp32": bound_ms(pw_bytes,
                                          (pw_prod + pw_rest, FP32_FLOPS)),
            "stage_bwd_dw": bound_ms(dw_bytes, dw_work),
            "stage_bwd_dw_saved": bound_ms(dw_bytes + 4 * (act_c + B * C),
                                           dw_work)}


def short_name(kernel):
    """A kernel's name without its namespace, return type and arguments."""
    return kernel.replace("(anonymous namespace)::", "").replace(
        "void ", "").split("(")[0]


def launch_split(torch, fn, n=20):
    """Device time per call (ms) of each kernel that fn launches, by kernel
    name, from torch.profiler over n calls after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {short_name(e.key): e.self_device_time_total / n / 1e3
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0}


def max_err(a, b):
    return float((a - b).detach().abs().max())


def check_close(name, got, ref, atol):
    err = max_err(got, ref)
    print(f"    {name:<22} max|d| {err:.3e}  tol {atol:.3e}")
    if not err <= atol:
        fail(f"{name}: max |delta| {err} exceeds {atol}")
    return err


def phase_kernels(torch, F):
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
            split = launch_split(torch, timings[k][0])
            print(f"    one {k} by launch (profiler): " + ", ".join(
                f"{name} {ms:.4f} ms" for name, ms in
                sorted(split.items(), key=lambda kv: -kv[1])))

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
          name, generate=None, out_size=None):
    """Run the engine's iteration (train_step + arch_step) once per pair of
    batches, the first pair as warm-up, then one generate on gen_in (or the
    outputs of generate(state)), with the kernels' launch counters set to 0
    just before and read just after. Fails on a non-finite loss, on
    per-iteration launches other than per_iter, on totals other than the
    iterations' plus gen_calls, and on a generated image that is not finite
    or not of gen_in's batch and out_size (crop_size). Returns the
    launches."""
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
        grown = {k: counters[k] - before[k] for k in per_iter}
        if grown != per_iter:
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
    expected = {k: n * v + gen_calls.get(k, 0) for k, v in per_iter.items()}
    if launches != expected:
        fail(f"kernel calls {launches}, expected {expected}")
    ms = 1e3 * sum(times) / len(times)
    print(f"  {name}: {ms:.3f} ms/iteration (min {1e3 * min(times):.3f}, "
          f"max {1e3 * max(times):.3f}), {batch / (ms / 1e3):.3f} images/s "
          f"(mean of {len(times)}), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
          f"launches {launches}")
    profile_iteration(torch, engine, state, batches[0], batches[1], cfg)
    return launches


def phase_main(torch, np):
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
                 PER_ITER, {"stage_fwd": 18}, "main path")


STAGE_KERNELS = ("dw_in_fwd_kernel", "pw_gemm_kernel", "in_fwd_kernel",
                 "in_bwd_kernel", "dw_bwd_plane_kernel", "sum_partials_kernel")
ATTN_KERNELS = ("attn_fwd_kernel", "attn_bwd_kernel", "attn_dq_reduce_kernel")
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
    share is a floor)."""
    kernels, wall_us = device_kernels(torch, lambda: engine.train_arch_step(
        state, batch, val_batch, cfg.lr, cfg.ema_beta))
    total = sum(t for _, t, _ in kernels)
    if total == 0:
        print("  profile: the profiler saw no device time")
        return
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


def attn_bounds(B, N, dq, dv):
    """Least time for each B1 wrapper's work (fp32): its inputs read once and
    outputs written once; its multiply-adds (2 flops each) at the peak of
    the units it runs on: the forward's S = q^T k on the fp32 CUDA cores and
    its P V^T on the tensor cores in split-TF32, every product of the
    backward in split-TF32. "attn_fwd_fp32" and "attn_bwd_fp32" are the
    bounds with every flop on the fp32 CUDA cores, printed beside them."""
    pairs, bn = B * N * N, 4 * B * N
    fwd_bytes = bn * (2 * dq + 2 * dv + 1)  # q, k, v in; O, lse out
    # q, k, v, dO, lse, delta in; dq, dk, dv out
    bwd_bytes, bwd_flops = bn * (4 * dq + 3 * dv + 2), 2 * pairs * (3 * dq + 2 * dv)
    return {"attn_fwd": bound_ms(fwd_bytes, (2 * pairs * dq, FP32_FLOPS),
                                 (2 * pairs * dv, TF32X3_FLOPS)),
            "attn_fwd_fp32": bound_ms(fwd_bytes,
                                      (2 * pairs * (dq + dv), FP32_FLOPS)),
            "attn_bwd": bound_ms(bwd_bytes, (bwd_flops, TF32X3_FLOPS)),
            "attn_bwd_fp32": bound_ms(bwd_bytes, (bwd_flops, FP32_FLOPS))}


def phase_attention(torch, F):
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
        if case not in ("teacher", "student"):
            continue
        # times at the main path's shapes; the teacher's go to the record
        bounds = attn_bounds(B, N, dq, dv)
        tok = [t.transpose(1, 2).unsqueeze(1).contiguous().requires_grad_(True)
               for t in (q, k, v)]
        do_tok = do.transpose(1, 2).unsqueeze(1).contiguous()

        def sdpa():
            return F.scaled_dot_product_attention(*tok, scale=1.0)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(), tok, do_tok)

        lib_fwd = cuda_ms(torch, sdpa)
        # SDPA's backward computes dq, dk and dv together
        lib_bwd = cuda_ms(torch, sdpa_fwd_bwd) - lib_fwd
        timings = {
            "attn_fwd": (lambda: fa.attn_fwd(q, k, v),
                         lambda: fa.attn_fwd_plain(q, k, v), lib_fwd),
            "attn_bwd": (lambda: fa.attn_bwd(*args),
                         lambda: fa.attn_bwd_plain(*args), lib_bwd),
        }
        for key, (kern, plain, lib) in timings.items():
            rec = {"ms": cuda_ms(torch, kern), "plain_ms": cuda_ms(torch, plain),
                   "library_ms": lib}
            rec["bound_ms"], rec["bound_by"] = bounds[key]
            print(f"    {key:<13} kernel {rec['ms']:.4f} ms  plain "
                  f"{rec['plain_ms']:.4f} ms  library {rec['library_ms']:.4f} "
                  f"ms  bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
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


def phase_unet(torch, np):
    from gcc_tpu_torch.compress import prune_unet
    from gcc_tpu_torch.config import Config
    from gcc_tpu_torch.engines.pix2pix import Pix2PixEngine
    from gcc_tpu_torch.models.generators import UnetGenerator
    from gcc_tpu_torch.ops import flash_attention as fa
    from gcc_tpu_torch.ops import mobile_block as mb
    from gcc_tpu_torch.utils.weights import export_jax_variables

    batch, size, n_timed = UNET_BATCH, 256, 3
    print(f"== phase 9: default pix2pix path, U-Net GCC iteration, {size}px, "
          f"batch {batch}, 1 warm-up + {n_timed} timed; cudnn.benchmark "
          f"{torch.backends.cudnn.benchmark}")
    # the bench's student: UnetGenerator(32) at spread weights, pruned to
    # 3.0 GMACs (bench.py:170-186)
    t0 = time.perf_counter()
    tree = export_jax_variables(UnetGenerator(ngf=32))["params"]
    fc, cc, gmacs = prune_unet(spread_tree(np, tree, np.random.RandomState(0)),
                               mode="scale", ngf=32, target_budget_g=3.0,
                               tolerance_g=0.1)
    print(f"  pruned student filter_cfgs {fc}, channel_cfgs {cc}: "
          f"{gmacs:.4f} GMACs ({time.perf_counter() - t0:.2f} s)")
    cfg = unet_config(Config, ngf=32, ndf=128, teacher_ngf=64,
                      teacher_ndf=128, crop_size=size, batch_size=batch)
    engine = Pix2PixEngine(cfg, filter_cfgs=fc, channel_cfgs=cc)  # the card
    batches = make_batches(torch, np, 2 * (n_timed + 1), batch, size, 0,
                           engine.device)
    for k in fa.LAUNCHES:
        fa.LAUNCHES[k] = 0
    drive(torch, engine, cfg, batches, batches[0]["A"], mb.LAUNCHES,
          {k: 0 for k in mb.LAUNCHES}, {}, "unet path")
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
           "loaded ", "SRGAN perceptual")


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
        common = (f"--dataroot synthetic --dataset_mode synthetic "
                  f"--model pix2pix --max_dataset_size 8 --batch_size 4 "
                  f"--n_epochs 1 --n_epochs_decay 0 --print_freq 4 "
                  f"--num_threads 4 --checkpoints_dir {tmp}").split()
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
              f"--checkpoints_dir {tmp}").split()
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
          f"--checkpoints_dir {tmp}").split()
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
          f"--num_threads 4 --checkpoints_dir {tmp}").split()
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
             f"--checkpoints_dir {tmp}").split()
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


def phase_srgan(torch, np):
    from gcc_tpu_torch.compress import prune_srresnet
    from gcc_tpu_torch.config import Config
    from gcc_tpu_torch.engines.srgan import SRGANEngine
    from gcc_tpu_torch.models.generators import SRResNet
    from gcc_tpu_torch.ops import flash_attention as fa
    from gcc_tpu_torch.ops import mobile_block as mb
    from gcc_tpu_torch.utils.weights import export_jax_variables

    hr, batch, w = SRGAN_HR, SRGAN_BATCH, SRGAN_WIDTHS
    lr_size = hr // 4
    print(f"== phase 14: SRGAN GCC iteration (scripts/srgan/train.sh), "
          f"{hr}px from {lr_size}px (x4), batch {batch}, vanilla GAN, "
          f"teacher ngf {w['teacher_ngf']} / ndf {w['teacher_ndf']}, ndf "
          f"{w['ndf']} masked, content 0.1, gram 0.1; VGG19 perceptual term "
          f"on SEEDED RANDOM weights (not the pretrained ones), "
          f"lambda_SR_perceptual 1; 1 warm-up + {N_TIMED} timed")
    tree = export_jax_variables(SRResNet(w["ngf"]))["params"]
    fc, gmacs = prune_srresnet(spread_tree(np, tree, np.random.RandomState(0)),
                               mode="scale", n_channels=w["ngf"],
                               target_budget_g=SRGAN_BUDGET, tolerance_g=0.01,
                               lr_size=lr_size)
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
    drive(torch, engine, cfg, batches, batches[0]["lr"], mb.LAUNCHES,
          {k: 0 for k in mb.LAUNCHES}, {}, "srgan path", out_size=hr)
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

    print(f"== phase 2: build {kernels.build():.2f} s (nvcc, from "
          f"{kernels.CSRC})")

    record = phase_kernels(torch, F)
    # launches: the main path's (pix2pix resnet for B2, SAGAN for B1);
    # by_path: each path's own count, each read from counters set to 0
    # just before the path
    launches = phase_main(torch, np)
    by_path = {k: {"pix2pix resnet": v} for k, v in launches.items()}
    phase_agree(torch, np)
    record.update(phase_attention(torch, F))
    sagan = phase_sagan(torch, np)
    launches.update(sagan)
    by_path.update({k: {"sagan": v} for k, v in sagan.items()})
    phase_sagan_agree(torch, np)
    phase_unet(torch, np)
    phase_unet_agree(torch, np)
    cli = phase_cli(torch, np)
    for k, v in phase_cyclegan(torch, np).items():
        by_path[k]["cyclegan"] = v
    phase_cyclegan_agree(torch, np)
    phase_srgan(torch, np)
    evaluators = phase_evaluators(torch, np)

    entries = []
    for k, rec in record.items():
        family, csrc = (("B1", "flash_attention") if k.startswith("attn")
                        else ("B2", "mobile_block"))
        short = k.replace("stage_", "").replace("attn_", "").replace("_", "-")
        entries.append({
            "name": f"{family}-{short}", "route": "cuda",
            "source": f"gcc_tpu_torch/csrc/{csrc}.cu",
            "replaces": TPU_KERNEL[k], "launches": launches[k],
            "launches_by_path": by_path[k],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
    print(json.dumps({"cli": cli}))
    print(json.dumps({"evaluators": evaluators}))
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
