#!/usr/bin/env python3
"""Probes of kernel B2's bf16 depthwise backward (gcc_stage_bwd_dw_bf16 in
gcc_tpu_torch/csrc/mobile_block_bf16.cu) on one NVIDIA GPU.

    python3 scripts/b2_dw_bf16_probes.py

Builds variants of the source from this checkout by small text edits, each
into chip_ab/dw_<variant>/ beside copies of the headers (nvcc -Xptxas -v, whose
registers and spills of the kernel are printed), and measures them against
the source as it stands:

  emulated      the transposed taps in the fp32 forms, round_bf16(
                __fmul_rn(w, g)) and round_bf16(__fadd_rn(s, p)), two
                conversions and a widening each, where the source takes
                mul.rn.bf16x2 / add.rn.bf16x2 (the same bits)
  two_launches  dW_dw always through per-plane partials and sum_partials,
                where the source sums a batch up to 8 in a cluster
  blocks4, blocks5, blocks7, blocks8
                launch bounds of 4, 5, 7 or 8 blocks an SM (64, 51, 36 or
                32 registers), where the source asks for 6 (42)
  no_dx, no_dw, no_stats, skeleton
                timing only, wrong outputs: the dx pass, the dW_dw pass,
                IN1's sums taken out, and all three (the copies, ga and the
                block sums are left)

For each: the device microseconds of a call (torch.profiler, its launches
summed) at the teacher stage (B 4, C 256, 64x64), the student's (B 4, 112
and 72 channels) and CycleGAN's batch-1 teacher stage (B 1, C 256); and,
for the source and two_launches, the CUDA-event ms and the host's us a
call of the wrapper, timed in turns.
"""

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def fp32_form(op, fn):
    """A bf16x2 helper's inline mul/add replaced by the fp32 form."""
    return (f'  asm("{op}.rn.bf16x2 %0, %1, %2;\\n" : "=r"(d) : "r"(a), '
            f'"r"(b));',
            "  const float2 x = __bfloat1622float2(\n"
            "      *reinterpret_cast<const __nv_bfloat162*>(&a));\n"
            "  const float2 y = __bfloat1622float2(\n"
            "      *reinterpret_cast<const __nv_bfloat162*>(&b));\n"
            f"  const __nv_bfloat162 r = __floats2bfloat162_rn({fn}(x.x, y.x),"
            f" {fn}(x.y, y.y));\n"
            "  d = *reinterpret_cast<const uint32_t*>(&r);")


BLOCKS = "constexpr int kDwBlocksPerSM = 6;"
NO_DX = ("for (int e = threadIdx.x; e < n / kVec; e += NT) {\n"
         "      const int p0 = kVec * e, i = p0 / W, j0 = p0 - i * W;",
         "for (int e = threadIdx.x; e < 0; e += NT) {\n"
         "      const int p0 = kVec * e, i = p0 / W, j0 = p0 - i * W;")
NO_DW = ("  strips([&](int j, int i0, int i1) {\n    const int jc[3]",
         "  if (false) strips([&](int j, int i0, int i1) {\n"
         "    const int jc[3]")
NO_STATS = ("  strips([&](int j, int i0, int i1) {\n#pragma unroll 4\n"
            "    for (int i = i0; i < i1; ++i) {\n      const float v",
            "  if (false) strips([&](int j, int i0, int i1) {\n"
            "#pragma unroll 4\n    for (int i = i0; i < i1; ++i) {\n"
            "      const float v")
VARIANTS = {
    "emulated": [fp32_form("mul", "__fmul_rn"), fp32_form("add", "__fadd_rn")],
    "two_launches": [("int dw_partials(int B) { return B <= kDwCluster ? 0 : "
                      "B; }", "int dw_partials(int B) { return B; }")],
    **{f"blocks{k}": [(BLOCKS, BLOCKS.replace("6", str(k)))]
       for k in (4, 5, 7, 8)},
    "no_dx": [NO_DX], "no_dw": [NO_DW], "no_stats": [NO_STATS],
    "skeleton": [NO_DX, NO_DW, NO_STATS],
}
CASES = [("teacher", 4, 256, 64), ("student_112", 4, 112, 64),
         ("student_72", 4, 72, 64), ("cg_teacher", 1, 256, 64)]


def build(kernels):
    """Start one nvcc per variant and for the source:
    {name: (Popen, library path)}."""
    src = (kernels.CSRC / "mobile_block_bf16.cu").read_text()
    procs = {}
    for name, edits in {"source": [], **VARIANTS}.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer holds "
                                   f"{old[:60]!r}")
            text = text.replace(old, new)
        d = os.path.join(ROOT, "chip_ab", f"dw_{name}")
        os.makedirs(d, exist_ok=True)
        for header in kernels.CSRC.glob("*.cuh"):
            shutil.copy(header, d)
        with open(os.path.join(d, "mobile_block_bf16.cu"), "w") as f:
            f.write(text)
        out = os.path.join(d, "libmobile_block_bf16.so")
        procs[name] = (subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o", out,
             os.path.join(d, "mobile_block_bf16.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), out)
    return procs


def wrapper(torch, kernels, lib, gah, ahat, rstd, x, dwk):
    """What mobile_block.stage_bwd_dw does on a CUDA tensor, on lib: the
    checks, the outputs and the partials' scratch (none where the library
    sums dW_dw in one launch) allocated each call, the launch."""
    (B, C, H, W), dev, dt = x.shape, x.device, x.dtype
    parts = lib.gcc_stage_bwd_dw_bf16_partials(B)
    p = kernels.ptr

    def fn():
        kernels.check(dev, "gah", gah, (B, C, H, W), dt)
        kernels.check(dev, "ahat", ahat, (B, C, H, W), dt)
        kernels.check(dev, "rstd_a", rstd, (B, C))
        kernels.check(dev, "x", x, (B, C, H, W), dt)
        kernels.check(dev, "dwk", dwk, (C, 1, 3, 3))
        gx = torch.empty_like(x)
        part = torch.empty(parts, C, 9, device=dev) if parts else None
        gdw = torch.empty_like(dwk)
        if lib.gcc_stage_bwd_dw_bf16(
                p(gah), p(ahat), p(rstd), p(x), p(dwk), p(gx), p(part),
                p(gdw), B, C, H, W, torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("gcc_stage_bwd_dw_bf16 failed")
        return gx, gdw

    return fn


def main():
    import ctypes

    import torch

    import chip_smoke as cs
    from gcc_tpu_torch.ops import kernels
    from gcc_tpu_torch.ops import mobile_block as mb

    if not torch.cuda.is_available():
        print("b2_dw_bf16_probes: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = {}
    for name, (proc, out) in build(kernels).items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"nvcc of the {name} variant:\n{log}")
        lines = log.splitlines()
        for k, line in enumerate(lines):  # the kernel's registers and spills
            if "Compiling entry function" in line and "dw_bwd_bf16" in line:
                inst = "VEC" if "ILb1ELb1E" in line else (
                    "SMEM" if "ILb0ELb1E" in line else "device memory")
                print(f"  {name} dw_bwd_bf16_kernel ({inst} route): "
                      + "; ".join(s.split(":", 1)[-1].strip()
                                  for s in lines[k + 1:k + 4]
                                  if "spill" in s or "Used" in s))
        lib = ctypes.CDLL(out)
        for fn, argtypes in kernels.SIGNATURES["mobile_block_bf16"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib

    def use(name):
        kernels._LIBS["mobile_block_bf16"] = libs[name]
        kernels._ENTRIES.clear()
        mb._dw_grad_partials.cache_clear()

    bf, gen = torch.bfloat16, torch.Generator().manual_seed(0)
    for case, B, C, S in CASES:
        x, gah, ahat = (torch.randn(B, C, S, S, generator=gen).to("cuda", bf)
                        for _ in range(3))
        rstd = (torch.rand(B, C, generator=gen) + 0.5).cuda()
        dwk = (torch.randn(C, 1, 3, 3, generator=gen) * 0.2).cuda()

        def call():
            return mb.stage_bwd_dw(gah, ahat, rstd, x, dwk)

        use("source")
        want = call()
        row = {}
        for name in libs:
            use(name)
            got = call()
            same = all(torch.equal(cs.bits(a), cs.bits(b))
                       for a, b in zip(got, want))
            split = cs.launch_split(torch, call, launches=1 + (
                mb._dw_grad_partials(B, "_bf16") > 0))
            row[name] = {"us": round(cs.device_ms(split) * 1e3, 2),
                         "launches": len(split), "same_bits": same}
        print(f"{case} (B {B}, C {C}, {S}x{S}): device us a call "
              + json.dumps(row))
        fns = {name: wrapper(torch, kernels, libs[name], gah, ahat, rstd, x,
                             dwk) for name in ("source", "two_launches")}
        ev = cs.in_turns(torch, fns)
        host = cs.in_turns(torch, fns, n=200, clock=cs.host_us)
        print(f"  {case}: event ms {json.dumps(ev)}; host us a call "
              f"{json.dumps(host)} (medians of 3 rounds in turns)")
    use("source")
    return 0


if __name__ == "__main__":
    sys.exit(main())
