#!/usr/bin/env python3
"""Probes of kernel B2's bf16 forward and pointwise backward
(gcc_tpu_torch/csrc/mobile_block_bf16.cu) on one NVIDIA GPU.

    python3 scripts/b2_bf16_probes.py

Builds variants of the source from this checkout by small text edits, each
into chip_ab/<variant>/ beside copies of the headers, and measures them
against the source as it stands:

  narrow, wide  the products always on 128 x 128 tiles (256 threads), or
                always on 128 x 256 (512 threads), where the grid size
                picks between them
  zeroed        each 16-deep k step into a zeroed fragment added in fp32,
                where it is summed straight into the accumulator
  rotated       each product block's k tiles taken from a start rotated by
                its pixel tile and sample
  vectors       the plane statistics summed as the 16-byte routes hold the
                pixels (8 neighbours a thread), where they are summed pixel
                by pixel (plane_stats)
  no_w, no_x, no_mma, skeleton
                timing only, wrong outputs: the products without the
                weight's copies, without the activation's, without the mma,
                and without all three

For each: the device microseconds of the two products (torch.profiler) at
the teacher stage (B 4, C = M = 256, 64x64), the student's (112 -> 72) and
CycleGAN's batch-1 teacher stage; the forward product against K with
cuBLAS's bf16 product of the same shape (torch.matmul) as a yardstick; and
chip_smoke.py phase 18 (e)'s CycleGAN check (the card in bf16 against the
CPU in bf16 and fp32) with the source, zeroed, vectors and, where
chip_ab/b2_parent/ holds an earlier mobile_block_bf16.cu with its headers,
that library's bf16 entry points.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ZEROED = ("    for (int j = 0; j < 4; ++j) mma(acc[i][j], af, bfr[j]);",
          """    for (int j = 0; j < 4; ++j) {
      float d[4] = {};
      mma(d, af, bfr[j]);
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] += d[r];
    }""")
NO_W = ("""        const bool ok = row < rows && col < ldw;
        cp_async16(dst, ok ? src : Wt, ok ? 16 : 0);""",
        "        (void)dst;\n        (void)src;")
NO_X = ("""        cp_async16(bs + r * LDX + cc,
                   ok ? X + (size_t)(k0 + r) * N + n0 + cc : X, ok ? 16 : 0);""",
        "        (void)ok;")
NO_MMA = ("    for (int j = 0; j < 4; ++j) mma(acc[i][j], af, bfr[j]);",
          "    for (int j = 0; j < 4; ++j)\n"
          "      acc[i][j][0] += __uint_as_float(af[0] ^ bfr[j][0]);")
WIDE = "bool wide_tiles(long long blocks, int sms) { return 4 * blocks >= 3LL * sms; }"
VARIANTS = {
    "narrow": [(WIDE, WIDE.replace("4 * blocks >= 3LL * sms", "false"))],
    "wide": [(WIDE, WIDE.replace("4 * blocks >= 3LL * sms", "true"))],
    "zeroed": [ZEROED],
    "rotated": [("    const int k0 = kt * BK;\n    bf16* bs = xs + s * T::kXTile;",
                 "    const int k0 = ((kt + tn + b) % cdiv(K, BK)) * BK;\n"
                 "    bf16* bs = xs + s * T::kXTile;")],
    "vectors": [("const int p = threadIdx.x + u * NT;",
                 "const int p = kVec * (threadIdx.x + u / kVec * NT) + u % kVec;")],
    "no_w": [NO_W], "no_x": [NO_X], "no_mma": [NO_MMA],
    "skeleton": [NO_W, NO_X, NO_MMA],
}
CASES = [("teacher", 4, 256, 256, 64), ("student", 4, 112, 72, 64),
         ("cg_teacher", 1, 256, 256, 64)]


def build_variants(kernels):
    """Start one nvcc per variant: {name: (Popen, library path)}."""
    src = (kernels.CSRC / "mobile_block_bf16.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer holds "
                                   f"{old[:60]!r}")
            text = text.replace(old, new)
        d = os.path.join(ROOT, "chip_ab", name)
        os.makedirs(d, exist_ok=True)
        for header in kernels.CSRC.glob("*.cuh"):
            shutil.copy(header, d)
        with open(os.path.join(d, "mobile_block_bf16.cu"), "w") as f:
            f.write(text)
        out = os.path.join(d, "libmobile_block_bf16.so")
        procs[name] = (subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", out,
             os.path.join(d, "mobile_block_bf16.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), out)
    return procs


def bind(kernels, path):
    lib = ctypes.CDLL(path)
    for fn, argtypes in kernels.SIGNATURES["mobile_block_bf16"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def parent_entry_points(torch, mb, kernels, lib):
    """stage_fwd / stage_bwd_pw on the earlier library's bf16 entry points,
    for bf16 CUDA tensors."""
    p, bf = kernels.ptr, torch.bfloat16
    fwd0, bwd0 = mb.stage_fwd, mb.stage_bwd_pw

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def fwd(x, dwk, pwk, residual=None, relu=False):
        if not x.is_cuda or x.dtype != bf:
            return fwd0(x, dwk, pwk, residual, relu)
        (B, C, H, W), M, dev = x.shape, pwk.shape[0], x.device
        y = torch.empty(B, M, H, W, device=dev, dtype=bf)
        outs = (y, torch.empty_like(x), torch.empty_like(y),
                torch.empty(B, C, device=dev), torch.empty(B, M, device=dev))
        if lib.gcc_stage_fwd_bf16(p(x), p(dwk), p(pwk), p(residual),
                                  *map(p, outs), B, C, M, H, W, int(relu),
                                  mb._sms(dev.index), stream()):
            raise RuntimeError("the earlier gcc_stage_fwd_bf16 failed")
        mb.LAUNCHES["stage_fwd_bf16"] += 1
        return outs[:5]

    def bwd(g, ahat, bhat, rstd_b, pwk, relu):
        if not g.is_cuda or g.dtype != bf:
            return bwd0(g, ahat, bhat, rstd_b, pwk, relu)
        (B, C, H, W), M, dev = ahat.shape, pwk.shape[0], g.device
        sms = mb._sms(dev.index)
        n = lib.gcc_stage_bwd_pw_bf16_partials(B, C, M, H, W, sms)
        outs = (torch.empty_like(g), torch.empty_like(ahat),
                torch.empty(n, M, C, device=dev), torch.empty_like(pwk))
        if lib.gcc_stage_bwd_pw_bf16(p(g), p(ahat), p(bhat), p(rstd_b),
                                     p(pwk), *map(p, outs), B, C, M, H, W,
                                     int(relu), sms, stream()):
            raise RuntimeError("the earlier gcc_stage_bwd_pw_bf16 failed")
        mb.LAUNCHES["stage_bwd_pw_bf16"] += 1
        return outs[1], outs[3]

    return fwd, bwd


def main():
    import numpy as np
    import torch

    import chip_smoke as cs
    from gcc_tpu_torch.ops import kernels
    from gcc_tpu_torch.ops import mobile_block as mb

    if not torch.cuda.is_available():
        print("b2_bf16_probes: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    procs = build_variants(kernels)
    parent = cs.start_parent_build(cs.B2_PARENT, "mobile_block_bf16")
    kernels.build()
    libs = {"source": kernels.library("mobile_block_bf16")}
    for name, (proc, out) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"nvcc of the {name} variant:\n{log}")
        libs[name] = bind(kernels, out)
    parent = cs.parent_library(
        parent, cs.B2_PARENT, "mobile_block_bf16", cs.B2_PARENT_BF16,
        "the CycleGAN check with the earlier bf16 entry points")

    def use(name):
        kernels._LIBS["mobile_block_bf16"] = libs[name]
        kernels._ENTRIES.clear()
        mb._pw_grad_partials.cache_clear()

    def products(x, dwk, pwk, g, ahat, bhat, rstd_b):
        """Device us of the forward's and the backward's product kernels."""
        fs = cs.launch_split(torch, lambda: mb.stage_fwd(x, dwk, pwk, None,
                                                         True), launches=3)
        bs = cs.launch_split(torch, lambda: mb.stage_bwd_pw(
            g, ahat, bhat, rstd_b, pwk, True), launches=2)
        pick = lambda split: round(sum(  # noqa: E731
            t for k, t in split.items() if k.startswith("pw_")) * 1e3, 2)
        return pick(fs), pick(bs)

    bf, gen = torch.bfloat16, torch.Generator().manual_seed(0)

    def stage(B, C, M, S):
        x = torch.randn(B, C, S, S, generator=gen).to("cuda", bf)
        dwk = (torch.randn(C, 1, 3, 3, generator=gen) * 0.2).cuda()
        pwk = (torch.randn(M, C, 1, 1, generator=gen) * 0.2).cuda()
        g = torch.randn(B, M, S, S, generator=gen).to("cuda", bf)
        _, ahat, bhat, _, rstd_b = (
            t.contiguous() for t in mb.stage_fwd_plain(x, dwk, pwk, None,
                                                       True))
        return x, dwk, pwk, g, ahat, bhat, rstd_b

    record = {}
    for case, B, C, M, S in CASES:
        args = stage(B, C, M, S)
        record[case] = {}
        for name in libs:
            use(name)
            record[case][name] = products(*args)
        print(f"{case} (B {B}, {C} -> {M}, {S}x{S}): forward / backward "
              f"product us " + json.dumps(record[case]))
    for C in (64, 128, 256, 512, 1024):
        x, dwk, pwk, g, ahat, bhat, rstd_b = stage(4, C, 256, 64)
        row = {}
        for name in ("source", "skeleton"):
            use(name)
            row[name] = products(x, dwk, pwk, g, ahat, bhat, rstd_b)[0]
        wb, ah = pwk[:, :, 0, 0].to(bf), ahat.view(4, C, -1)
        mm = cs.launch_split(torch, lambda: torch.matmul(wb, ah))
        row["cuBLAS"] = round(cs.device_ms(mm) * 1e3, 2)
        print(f"forward product at K {C} (B 4, M 256, 64x64): us "
              + json.dumps(row))
    use("source")
    fwd0, bwd0 = mb.stage_fwd, mb.stage_bwd_pw
    runs = ["source", "zeroed", "vectors"] + (["earlier"] if parent else [])
    for name in runs:
        if name == "earlier":
            mb.stage_fwd, mb.stage_bwd_pw = parent_entry_points(
                torch, mb, kernels, parent)
        else:
            use(name)
        got = cs.family_agree(torch, np, "cyclegan")
        mb.stage_fwd, mb.stage_bwd_pw = fwd0, bwd0
        print(f"CycleGAN card against CPU with {name}: " + json.dumps(
            {k: round(v, 4) for k, v in got.items()
             if k in ("grad tg", "grad td", "loss G")}))
    use("source")
    return 0


if __name__ == "__main__":
    sys.exit(main())
