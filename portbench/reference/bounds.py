"""The yardstick's constants and work counts: the H100's peaks (NVIDIA's
data sheet, SXM, dense), the kernel name marks that group a trace's
device operations, and the least time of kernel B2's three wrappers at a
shape (frozen copies from the repository's chip_smoke.py), with the list
of B2 calls one CycleGAN iteration makes, derived from its configuration.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12  # outside the tensor cores
TF32_FLOPS = 495e12
TF32X3_FLOPS = TF32_FLOPS / 3  # split-TF32: three TF32 products a product
BF16_FLOPS = 989e12  # tensor cores, fp32 accumulation

# kernel names of B2 (ops/mobile_block.py -> csrc/mobile_block*.cu) and B1
# (ops/flash_attention.py), and the marks of a library convolution
STAGE_KERNELS = ("dw_in_fwd_kernel", "pw_gemm_kernel", "in_fwd_kernel",
                 "in_bwd_kernel", "dw_bwd_plane_kernel", "sum_partials_kernel",
                 "dw_in_fwd_bf16_kernel", "pw_fwd_bf16_kernel",
                 "pw_bwd_bf16_kernel", "in_fwd_bf16_kernel",
                 "in_bwd_bf16_kernel", "dw_bwd_bf16_kernel")
ATTN_KERNELS = ("attn_fwd_kernel", "attn_bwd_kernel", "attn_dq_reduce_kernel",
                "attn_fwd_bf16_kernel", "attn_bwd_bf16_kernel",
                "attn_dq_reduce_bf16_kernel")
CONV_MARKS = ("conv", "cudnn", "xmma", "cutlass", "implicit", "wgrad", "dgrad")


def group(name: str) -> str:
    """A device operation's group: b1, b2, conv or other."""
    if any(k in name for k in ATTN_KERNELS):
        return "b1"
    if any(k in name for k in STAGE_KERNELS):
        return "b2"
    if any(k in name.lower() for k in CONV_MARKS):
        return "conv"
    return "other"


def bound_ms(nbytes, *work) -> Tuple[float, str]:
    """Least ms for nbytes of memory traffic and (flops, peak) pairs run
    side by side, and which of bytes or operations sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(flops / peak for flops, peak in work)
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def stage_bounds(B, C, M, HW, relu, res, act=4, mma=TF32X3_FLOPS
                 ) -> Dict[str, Tuple[float, str]]:
    """Least time of each B2 wrapper at one shape: inputs read once,
    outputs written once (activations of ``act`` bytes, weights and their
    gradients fp32), the pointwise products at ``mma``, the rest on the
    fp32 cores. The bytes are the function's (forward: x in, y out;
    backward: x and the upstream gradient in, the gradients out); "*_saved"
    also counts what the port saves in the forward and reads back."""
    act_c, act_m = B * C * HW, B * M * HW
    fwd_bytes = (act * (act_c + (act_m if res else 0) + act_m)
                 + 4 * (9 * C + M * C))
    saved_bytes = act * (act_c + act_m) + 4 * (B * C + B * M)
    gemm = 2 * act_m * C
    rest = 18 * act_c + 5 * (act_c + act_m) + (act_m if relu or res else 0)
    pw_bytes = act * (act_c + act_m + act_c) + 4 * (9 * C + 2 * M * C)
    pw_saved = act * (2 * act_m + 2 * act_c) + 4 * (B * M + 2 * M * C)
    pw_prod, pw_rest = 4 * act_m * C, 6 * act_m
    dw_bytes = act * 3 * act_c + 4 * 18 * C
    dw_work = (42 * act_c, FP32_FLOPS)
    return {"stage_fwd": bound_ms(fwd_bytes, (gemm, mma), (rest, FP32_FLOPS)),
            "stage_fwd_saved": bound_ms(fwd_bytes + saved_bytes, (gemm, mma),
                                        (rest, FP32_FLOPS)),
            "stage_bwd_pw": bound_ms(pw_bytes, (pw_prod, mma),
                                     (pw_rest, FP32_FLOPS)),
            "stage_bwd_pw_saved": bound_ms(pw_saved, (pw_prod, mma),
                                           (pw_rest, FP32_FLOPS)),
            "stage_bwd_dw": bound_ms(dw_bytes, dw_work),
            "stage_bwd_dw_saved": bound_ms(
                dw_bytes + act * act_c + 4 * B * C, dw_work)}


def mobile_stages(cfg: Sequence[int], n_blocks: int = 9
                  ) -> List[Tuple[int, int, bool, bool]]:
    """(C, M, relu, residual) of each B2 stage of a MobileResnet: two a
    residual block that exists (layer 1 with relu, layer 2 with the add)."""
    out, width = [], cfg[2]
    for b in range(n_blocks):
        l1, l2 = cfg[3 + 2 * b], cfg[4 + 2 * b]
        if l1 != 0:
            out += [(width, l1, True, False), (l1, l2, False, True)]
    return out


def cyclegan_b2_calls(cfgs: Sequence[Sequence[int]], batch: int, size: int,
                      act: int = 2, mma: float = BF16_FLOPS
                      ) -> List[Tuple[str, int, float]]:
    """(wrapper, calls, least ms a call) of one CycleGAN iteration: each of
    the four generators runs 4 forwards (3 with a gradient in the G
    updates, 1 in the arch step) and 3 backwards; the blocks work at a
    quarter of the image's side."""
    hw = (size // 4) ** 2
    calls = []
    for cfg in cfgs:
        for c, m, relu, res in mobile_stages(cfg):
            b = stage_bounds(batch, c, m, hw, relu, res, act, mma)
            calls += [("stage_fwd", 4, b["stage_fwd"][0]),
                      ("stage_bwd_pw", 3, b["stage_bwd_pw"][0]),
                      ("stage_bwd_dw", 3, b["stage_bwd_dw"][0])]
    return calls
