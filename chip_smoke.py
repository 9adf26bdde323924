#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gcc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. card     the device's name and power limit (nvidia-smi);
  2. build    nvcc builds every CUDA source under gcc_tpu_torch/csrc;
  3. kernels  each stage kernel (B2-fwd, B2-bwd-pw, B2-bwd-dw) against its
              plain PyTorch version at the main path's teacher and student
              stage shapes, then the differentiable stage against autograd
              through sep_stage_reference (relu's mask from the kernel's
              b-hat, the pixels where it differs from the plain forward's
              counted and held to |b-hat| < 1e-4); that two calls of each
              give the same bits; CUDA-event times of the kernel, the plain
              version and the cuDNN route of the stage at teacher_relu and
              student_relu, cuDNN's convolution backward of the two
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
              3 iterations.
The run is fp32 throughout: TF32 is off for cuDNN and matmul. The last two
lines are the kernels' JSON record and {"ok": true, "device": ...}.
"""

import json
import math
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
    for case, B, C, M, S, relu, has_res in TEACHER_CASES + STUDENT_CASES:
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

        if case not in ("teacher_relu", "student_relu"):
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
          name):
    """Run the engine's iteration (train_step + arch_step) once per pair of
    batches, the first pair as warm-up, then one generate on gen_in, with the
    kernels' launch counters set to 0 just before and read just after. Fails
    on a non-finite loss, on per-iteration launches other than per_iter, on
    totals other than the iterations' plus gen_calls, and on a generate that
    is not finite or not of gen_in's batch and image shape. Returns the
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
    out = engine.generate(state, gen_in)
    torch.cuda.synchronize()
    launches = dict(counters)
    if tuple(out.shape) != (batch, 3, cfg.crop_size, cfg.crop_size) \
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


def profile_iteration(torch, engine, state, batch, val_batch, cfg):
    """One more iteration under torch.profiler: device time by kernel group,
    by B1 and B2 kernel, and the device's busy share of the iteration's wall
    time (the profiler's own overhead lengthens the wall time, so the busy
    share is a floor)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.train_arch_step(state, batch, val_batch, cfg.lr, cfg.ema_beta)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [(e.key, e.self_device_time_total, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
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
    return (rng.rand(*tree.shape).astype(np.float32)
            * np.exp(rng.uniform(-6, 2, tree.shape[-1])).astype(np.float32))


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
    launches = phase_main(torch, np)
    phase_agree(torch, np)
    record.update(phase_attention(torch, F))
    launches.update(phase_sagan(torch, np))
    phase_sagan_agree(torch, np)
    phase_unet(torch, np)
    phase_unet_agree(torch, np)

    entries = []
    for k, rec in record.items():
        family, csrc = (("B1", "flash_attention") if k.startswith("attn")
                        else ("B2", "mobile_block"))
        short = k.replace("stage_", "").replace("attn_", "").replace("_", "-")
        entries.append({
            "name": f"{family}-{short}", "route": "cuda",
            "source": f"gcc_tpu_torch/csrc/{csrc}.cu",
            "replaces": TPU_KERNEL[k], "launches": launches[k],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
