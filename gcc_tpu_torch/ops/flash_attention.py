"""Flash self-attention: CUDA kernels and their plain PyTorch versions
(counterpart of gcc_tpu/ops/pallas/attention.py).

Unscaled single-head attention, as SAGAN's Self_Attn (SAGAN.py:97-103):

    O_i = sum_j softmax_j(q_i . k_j) v_j,   lse_i = log sum_j exp(q_i . k_j)

Tensors are channel-major, the layout the 1x1 q/k/v convs leave in NCHW:
q, k (B, dq, N), v and O (B, dv, N), lse (B, N). q, k, v and dO are float32
or bfloat16, as the TPU kernels take them; O, dq, dk and dv come in their
dtype, lse and delta in float32. The JAX package takes (B, N, d); tests
transpose at the boundary.

Two wrappers stand for the three TPU kernels:

    attn_fwd  <- _attn_fwd_kernel      (ops/pallas/attention.py:44)
    attn_bwd  <- _attn_bwd_dq_kernel   (:81) and _attn_bwd_dkv_kernel (:110),
                 one pass that computes dq, dk and dv together

On a CUDA tensor each launches its kernel or raises, also for a dtype
without a kernel: fp32 in csrc/flash_attention.cu; bf16 in
csrc/flash_attention_bf16.cu (bf16 tensor-core products), or, for the wide
shapes whose tiles it cannot hold, flash_attention.cu's streaming kernels
on bf16 (``bf16_route``). On a CPU tensor it runs its plain version,
``*_plain`` below,
which materialises the N x N matrix and repeats the kernel's formulas: in
bf16 on the fp32 values of its inputs, its outputs rounded once, as the TPU
kernels upcast and round (ops/pallas/attention.py:54-56, :70).
``attn_bwd_dq_plain`` and ``attn_bwd_dkv_plain`` are the plain versions of
the two TPU backward kernels' functions. ``LAUNCHES`` counts the CUDA calls
of each wrapper by dtype (``attn_fwd`` fp32, ``attn_fwd_bf16`` bf16, and so
on; a bf16 call counts under ``*_bf16`` whichever kernel takes it).
``flash_attention`` is the differentiable function: its forward saves
(q, k, v, O, lse), its backward computes delta = sum_c dO * O in fp32 (from
bf16 dO and O too, attention.py:259) and calls ``attn_bwd`` once.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from gcc_tpu_torch.ops import kernels

# the entry points' suffix by the dtype of q, k, v and dO
_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16"}

LAUNCHES = {f"{k}{sfx}": 0 for sfx in _SUFFIX.values()
            for k in ("attn_fwd", "attn_bwd")}

# How close the bf16 kernels stay to their plain versions: O, dq, dk and dv
# within BF16_ULPS bf16 ulps of the tensor's largest value and at most
# BF16_SHARE of their elements apart at all (both round once from fp32
# values that differ only by the order of fp32 sums, ex2.approx and the
# split-TF32 products; a few land on the other bf16 neighbour); lse within
# the fp32 kernel's 1e-5 max(|lse|, 1). Where the two are more than
# BF16_SHARE apart (an ill-conditioned output: dq at q, k scale 2, whose
# plain version itself rounds 3.1 % of its elements away from the float64
# answer's rounding on the H100), the kernel is held to the float64 answer:
# no more of its elements apart from that answer's rounding than the plain
# version's (bf16_share_ok).
BF16_ULPS, BF16_SHARE = 1.0, 0.01


def bf16_share_ok(got, plain, exact=None
                  ) -> Tuple[bool, float, float, float]:
    """(within the share rule, share of ``got`` apart from ``plain``, and,
    given ``exact``, the shares of ``plain`` and of ``got`` apart from
    ``exact``'s rounding, else 0 and 0): the BF16_SHARE rule above for a
    bf16 kernel output."""
    apart = float((got != plain).float().mean())
    if exact is None:
        return apart <= BF16_SHARE, apart, 0.0, 0.0
    ref = exact.to(got.dtype)
    plain_off = float((plain != ref).float().mean())
    got_off = float((got != ref).float().mean())
    return (apart <= BF16_SHARE or got_off <= plain_off, apart, plain_off,
            got_off)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _scores(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, d, N) x (B, d, N) -> (B, N, N): a_i . b_j."""
    return torch.einsum("bci,bcj->bij", a, b)


def _ds(q, k, v, do, lse, delta) -> Tuple[torch.Tensor, torch.Tensor]:
    """(p, ds): p_ij = exp(q_i . k_j - lse_i), ds_ij = p_ij (dO_i . v_j - delta_i)."""
    p = torch.exp(_scores(q, k) - lse[:, :, None])
    return p, p * (_scores(do, v) - delta[:, :, None])


def attn_fwd_plain(q, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``attn_fwd``: (O (B, dv, N), lse (B, N)). Below fp32:
    the fp32 function of the widened inputs, O rounded to q's dtype, lse
    fp32; float64 inputs run the formulas in float64."""
    if q.dtype.itemsize < 4:
        o, lse = attn_fwd_plain(q.float(), k.float(), v.float())
        return o.to(q.dtype), lse
    s = _scores(q, k)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[:, :, None])
    return torch.einsum("bij,bcj->bci", p, v), lse


def attn_bwd_plain(q, k, v, do, lse, delta
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``attn_bwd``: (dq = ds k, dk = ds^T q, dv = p^T dO),
    p and ds computed once. Below fp32: from the widened inputs, each
    gradient rounded to its input's dtype."""
    if q.dtype.itemsize < 4:
        grads = attn_bwd_plain(q.float(), k.float(), v.float(), do.float(),
                               lse, delta)
        return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v)))
    p, ds = _ds(q, k, v, do, lse, delta)
    return (torch.einsum("bij,bcj->bci", ds, k),
            torch.einsum("bij,bci->bcj", ds, q),
            torch.einsum("bij,bci->bcj", p, do))


def attn_bwd_dq_plain(q, k, v, do, lse, delta) -> torch.Tensor:
    """dq = ds k (B, dq, N): the function of _attn_bwd_dq_kernel."""
    _, ds = _ds(q, k, v, do, lse, delta)
    return torch.einsum("bij,bcj->bci", ds, k)


def attn_bwd_dkv_plain(q, k, v, do, lse, delta
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk = ds^T q, dv = p^T dO): the function of _attn_bwd_dkv_kernel."""
    p, ds = _ds(q, k, v, do, lse, delta)
    return (torch.einsum("bij,bci->bcj", ds, q),
            torch.einsum("bij,bci->bcj", p, do))


def attention_reference(q, k, v) -> torch.Tensor:
    """softmax(q k^T) v in plain PyTorch; its backward is autograd's."""
    return torch.einsum("bij,bcj->bci", torch.softmax(_scores(q, k), -1), v)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _suffix(t: torch.Tensor) -> str:
    """The entry points' suffix for q's dtype; raises for a dtype the
    kernels do not take."""
    if t.dtype not in _SUFFIX:
        raise ValueError(f"the attention kernels take float32 or bfloat16 "
                         f"q, k, v, got {t.dtype}")
    return _SUFFIX[t.dtype]


def _check_qkv(q, k, v):
    (B, dq, N), dv = q.shape, v.shape[1]
    for name, t, d in (("q", q, dq), ("k", k, dq), ("v", v, dv)):
        kernels.check(q.device, name, t, (B, d, N), q.dtype)
    return B, N, dq, dv


@functools.lru_cache(maxsize=None)
def bf16_route(dq: int, dv: int, backward: bool) -> str:
    """Which kernel takes bf16 q, k, v of widths (dq, dv): "tiles"
    (flash_attention_bf16.cu, where its tiles fit one block's shared
    memory) or "wide" (flash_attention.cu's streaming kernels)."""
    lib = kernels.library("flash_attention_bf16")
    return "tiles" if lib.gcc_attn_bf16_serves(dq, dv, int(backward)) \
        else "wide"


def bf16_smem(dq: int, dv: int, backward: bool) -> int:
    """Bytes of dynamic shared memory flash_attention_bf16.cu's forward (or
    backward) kernel takes at widths (dq, dv); past a block's 232,448 the
    shape goes to the "wide" route."""
    return kernels.library("flash_attention_bf16").gcc_attn_bf16_smem(
        dq, dv, int(backward))


def _entry(kind: str, q: torch.Tensor, dq: int, dv: int) -> Tuple[str, str]:
    """(library, entry point) of ``kind`` ("fwd" or "bwd") for q's dtype
    and the widths."""
    if _suffix(q) == "":
        return "flash_attention", f"gcc_attn_{kind}"
    if bf16_route(dq, dv, kind == "bwd") == "tiles":
        return "flash_attention_bf16", f"gcc_attn_{kind}_bf16"
    return "flash_attention", f"gcc_attn_{kind}_bf16_wide"


def attn_fwd(q, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward: (O (B, dv, N) in q's dtype, lse (B, N) fp32), any N, dq and
    dv."""
    if not q.is_cuda:
        return attn_fwd_plain(q, k, v)
    sfx = _suffix(q)
    B, N, dq, dv = _check_qkv(q, k, v)
    with torch.cuda.device(q.device):
        o = torch.empty(B, dv, N, device=q.device, dtype=q.dtype)
        lse = torch.empty(B, N, device=q.device)
        p = kernels.ptr
        kernels.launch(*_entry("fwd", q, dq, dv), p(q), p(k), p(v), p(o),
                       p(lse), B, N, dq, dv)
    LAUNCHES[f"attn_fwd{sfx}"] += 1
    return o, lse


@functools.lru_cache(maxsize=None)
def dq_groups(N: int) -> int:
    """Key-tile groups of the fp32 (and wide bf16) backward's dq partials
    for N keys, as the kernel library sizes them (at most 16, whatever N
    is)."""
    return kernels.library("flash_attention").gcc_attn_bwd_groups(N)


@functools.lru_cache(maxsize=None)
def dq_groups_bf16(B: int, N: int, dq: int, dv: int) -> int:
    """Key-tile groups of flash_attention_bf16.cu's backward: about two
    blocks an SM over its grid, at most 64."""
    return kernels.library("flash_attention_bf16").gcc_attn_bwd_bf16_groups(
        B, N, dq, dv)


def _check_bwd(q, k, v, do, lse, delta):
    B, N, dq, dv = _check_qkv(q, k, v)
    kernels.check(q.device, "do", do, (B, dv, N), q.dtype)
    kernels.check(q.device, "lse", lse, (B, N))
    kernels.check(q.device, "delta", delta, (B, N))
    return B, N, dq, dv


def attn_bwd(q, k, v, do, lse, delta
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(d loss / d q, d loss / d k (B, dq, N), d loss / d v (B, dv, N)) from
    dO = d loss / d O, the saved lse and delta = sum_c dO * O; any N, dq and
    dv; the gradients in q's dtype, lse and delta fp32. Scratch: dq partials
    of key-tile groups, B * 16 * dq * N floats at most in fp32 (and bf16's
    wide shapes), at most (2 SMs + B) * dq * N in bf16."""
    if not q.is_cuda:
        return attn_bwd_plain(q, k, v, do, lse, delta)
    sfx = _suffix(q)
    B, N, dq, dv = _check_bwd(q, k, v, do, lse, delta)
    lib, fn = _entry("bwd", q, dq, dv)
    groups = (dq_groups_bf16(B, N, dq, dv) if lib == "flash_attention_bf16"
              else dq_groups(N))
    with torch.cuda.device(q.device):
        dq_out, dk, dv_out = (torch.empty_like(q), torch.empty_like(k),
                              torch.empty_like(v))
        # the key-tile groups' dq partials, summed in order by the second pass
        part = torch.empty(B, groups, dq, N, device=q.device)
        p = kernels.ptr
        kernels.launch(lib, fn, p(q), p(k), p(v), p(do), p(lse), p(delta),
                       p(dq_out), p(dk), p(dv_out), p(part), B, N, dq, dv)
    LAUNCHES[f"attn_bwd{sfx}"] += 1
    return dq_out, dk, dv_out


# ---------------------------------------------------------------------------
# differentiable attention
# ---------------------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = attn_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        # delta_i = dO_i . O_i in fp32, O(N dv): outside the kernels, as in
        # JAX (.float() of an fp32 tensor is the tensor itself)
        delta = (do.float() * o.float()).sum(dim=1)
        return attn_bwd(q, k, v, do, lse, delta)


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T) v over channel-major q, k (B, dq, N), v (B, dv, N),
    differentiable through the kernels' backward."""
    return _FlashAttention.apply(q, k, v)
