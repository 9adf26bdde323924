#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gcc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. card     the device's name and power limit (nvidia-smi);
  2. build    nvcc builds every CUDA source under gcc_tpu_torch/csrc;
  3. kernels  each stage kernel (B2-fwd, B2-bwd-pw, B2-bwd-dw) against its
              plain PyTorch version at the main path's teacher and student
              stage shapes, then the differentiable stage against autograd
              through sep_stage_reference; CUDA-event times of the kernel,
              the plain version and the cuDNN route of the same stage;
  4. main     the pix2pix GCC cooperative iteration (train_step + arch_step)
              at full width: resnet backbone with fused blocks, 256 px,
              teacher ngf 64 / ndf 128, the pruned student
              [24, 48, 112] + [72, 112] * 9 + [48, 24], batch 4; 1 warm-up and
              3 timed iterations and one generate, with the kernels' launch
              counters checked against the engine's structure;
  5. agree    fused against unfused engines (kernels vs cuDNN path) from the
              same weights on the same batches at a small width.
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
PER_ITER = {"stage_fwd": 108, "stage_bwd_pw": 36, "stage_bwd_dw": 36}
TPU_KERNEL = {"stage_fwd": "gcc_tpu/ops/pallas/mobile_block.py:155",
              "stage_bwd_pw": "gcc_tpu/ops/pallas/mobile_block.py:187",
              "stage_bwd_dw": "gcc_tpu/ops/pallas/mobile_block.py:220"}


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


def bound_ms(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def stage_bounds(B, C, M, HW, relu, res):
    """Least time for each wrapper's work at one shape: its inputs read once,
    outputs written once (fp32), and its flops at the fp32 peak."""
    act_c, act_m = B * C * HW, B * M * HW
    fwd = bound_ms(4 * (act_c + 9 * C + M * C + act_m * (2 if res else 1)),
                   2 * act_m * C + 18 * act_c + 5 * (act_c + act_m)
                   + (act_m if relu or res else 0))
    # inputs g, a-hat, b-hat, 1/std, pwk; outputs d a-hat, d pwk
    pw = bound_ms(4 * (2 * act_m + B * M + M * C + 2 * act_c + M * C),
                  4 * act_m * C + 6 * act_m)
    # inputs d a-hat, a-hat, 1/std, x, dwk; outputs dx, d dwk
    dw = bound_ms(4 * (4 * act_c + B * C + 18 * C), 42 * act_c)
    return {"stage_fwd": fwd, "stage_bwd_pw": pw, "stage_bwd_dw": dw}


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

        # the differentiable stage against autograd through the reference
        leaves = [t.clone().requires_grad_(True) for t in (x, dwk, pwk)]
        r_leaf = res.clone().requires_grad_(True) if has_res else None
        inputs = leaves + ([r_leaf] if has_res else [])
        y_f = mb.fused_sep_stage(leaves[0], leaves[1], leaves[2], r_leaf, relu)
        grads_f = torch.autograd.grad((y_f * g).sum(), inputs)
        y_r = mb.sep_stage_reference(leaves[0], leaves[1], leaves[2], r_leaf,
                                     relu)
        grads_r = torch.autograd.grad((y_r * g).sum(), inputs)
        check_close("stage y vs reference", y_f, y_r, 1e-4)
        for n, a, b in zip(("dx", "dW_dw", "dW_pw", "dres"), grads_f, grads_r):
            check_close(f"stage {n} vs reference", a, b,
                        1e-4 * max(float(b.abs().max()), 1.0))

        if case not in ("teacher_relu",):
            continue
        # times at the teacher stage shape (the largest the main path runs)
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
            rec = record[k]
            rec["ms"] = cuda_ms(torch, kern)
            rec["plain_ms"] = cuda_ms(torch, plain)
            rec["library_ms"] = cuda_ms(torch, lib) if lib else None
            rec["bound_ms"], rec["bound_by"] = bounds[k]
            print(f"    {k:<13} kernel {rec['ms']:.4f} ms  plain "
                  f"{rec['plain_ms']:.4f} ms  library {rec['library_ms']} ms  "
                  f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")

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
    state = engine.init_state(seed=0)
    batches = make_batches(torch, np, 2 * (n_timed + 1), batch, size, 0,
                           engine.device)
    gen_in = batches[0]["A"]
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    mb.reset_launches()  # counts from here on are the main path's alone
    times = []
    for i in range(n_timed + 1):
        before = dict(mb.LAUNCHES)
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
        grown = {k: mb.LAUNCHES[k] - before[k] for k in PER_ITER}
        if grown != PER_ITER:
            fail(f"iteration {i}: kernel calls {grown}, expected {PER_ITER}")
        print(f"  iter {i}{' (warm-up)' if i == 0 else ''}: {dt * 1e3:.3f} ms "
              f"launches {grown} "
              + " ".join(f"{k}={v:.5g}" for k, v in losses.items()))
    out = engine.generate(state, gen_in)
    torch.cuda.synchronize()
    launches = dict(mb.LAUNCHES)
    if tuple(out.shape) != (batch, 3, size, size) \
            or not bool(torch.isfinite(out).all()):
        fail(f"generate: shape {tuple(out.shape)} or non-finite values")
    expected_fwd = (n_timed + 1) * PER_ITER["stage_fwd"] + 18
    if launches["stage_fwd"] != expected_fwd:
        fail(f"stage_fwd calls {launches['stage_fwd']}, expected {expected_fwd}")
    ms = 1e3 * sum(times) / len(times)
    print(f"  main path: {ms:.3f} ms/iteration (min {1e3 * min(times):.3f}, "
          f"max {1e3 * max(times):.3f}), {batch / (ms / 1e3):.3f} images/s "
          f"(mean of {n_timed}), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
          f"launches {launches}")
    profile_iteration(torch, engine, state, batches[0], batches[1], cfg)
    return launches, ms


STAGE_KERNELS = ("dw_in_fwd_kernel", "in_fwd_kernel", "in_bwd_kernel",
                 "dw_bwd_kernel", "sgemm_kernel", "sum_partials_kernel")
CONV_MARKS = ("conv", "cudnn", "xmma", "cutlass", "implicit", "wgrad", "dgrad")


def profile_iteration(torch, engine, state, batch, val_batch, cfg):
    """One more iteration under torch.profiler: device time by kernel group
    and the device's busy share of the iteration's wall time (the profiler's
    own overhead lengthens the wall time, so the busy share is a floor)."""
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
    groups = {"stage kernels (B2)": 0.0, "convolutions (cuDNN)": 0.0,
              "other": 0.0}
    for name, t, _ in kernels:
        low = name.lower()
        if any(k in name for k in STAGE_KERNELS):
            groups["stage kernels (B2)"] += t
        elif any(k in low for k in CONV_MARKS):
            groups["convolutions (cuDNN)"] += t
        else:
            groups["other"] += t
    print(f"  profile of one iteration: device time {total / 1e3:.3f} ms, "
          f"wall {wall_us / 1e3:.3f} ms, device busy {total / wall_us:.3f}")
    for g, t in groups.items():
        print(f"    {g:<22} {t / 1e3:9.3f} ms  {t / total:.3f}")
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
    launches, _ = phase_main(torch, np)
    phase_agree(torch, np)

    entries = []
    for k in PER_ITER:
        rec = record[k]
        entries.append({
            "name": f"B2-{k.replace('stage_', '').replace('_', '-')}",
            "route": "cuda", "source": "gcc_tpu_torch/csrc/mobile_block.cu",
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
