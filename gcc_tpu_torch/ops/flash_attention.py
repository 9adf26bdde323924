"""Flash self-attention: CUDA kernels and their plain PyTorch versions
(counterpart of gcc_tpu/ops/pallas/attention.py).

Unscaled single-head attention, as SAGAN's Self_Attn (SAGAN.py:97-103):

    O_i = sum_j softmax_j(q_i . k_j) v_j,   lse_i = log sum_j exp(q_i . k_j)

Tensors are channel-major, the layout the 1x1 q/k/v convs leave in NCHW:
q, k (B, dq, N), v and O (B, dv, N), lse (B, N); fp32 only. The JAX package
takes (B, N, d); tests transpose at the boundary.

Two wrappers stand for the three TPU kernels:

    attn_fwd  <- _attn_fwd_kernel      (ops/pallas/attention.py:44)
    attn_bwd  <- _attn_bwd_dq_kernel   (:81) and _attn_bwd_dkv_kernel (:110),
                 one pass that computes dq, dk and dv together

On a CUDA tensor each launches its kernel (csrc/flash_attention.cu) or
raises; on a CPU tensor it runs its plain version, ``*_plain`` below, which
materialises the N x N matrix and repeats the kernel's formulas.
``attn_bwd_dq_plain`` and ``attn_bwd_dkv_plain`` are the plain versions of
the two TPU backward kernels' functions. ``LAUNCHES`` counts the CUDA calls
of each wrapper. ``flash_attention`` is the differentiable function: its
forward saves (q, k, v, O, lse), its backward computes delta = sum_c dO * O
and calls ``attn_bwd`` once.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from gcc_tpu_torch.ops import kernels

LAUNCHES = {"attn_fwd": 0, "attn_bwd": 0}


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
    """Plain version of ``attn_fwd``: (O (B, dv, N), lse (B, N))."""
    s = _scores(q, k)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[:, :, None])
    return torch.einsum("bij,bcj->bci", p, v), lse


def attn_bwd_plain(q, k, v, do, lse, delta
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``attn_bwd``: (dq = ds k, dk = ds^T q, dv = p^T dO),
    p and ds computed once."""
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

def _check_qkv(q, k, v):
    (B, dq, N), dv = q.shape, v.shape[1]
    for name, t, d in (("q", q, dq), ("k", k, dq), ("v", v, dv)):
        kernels.check(q.device, name, t, (B, d, N))
    return B, N, dq, dv


def attn_fwd(q, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward: (O (B, dv, N), lse (B, N)), any N, dq and dv."""
    if not q.is_cuda:
        return attn_fwd_plain(q, k, v)
    B, N, dq, dv = _check_qkv(q, k, v)
    with torch.cuda.device(q.device):
        o = torch.empty(B, dv, N, device=q.device)
        lse = torch.empty(B, N, device=q.device)
        p = kernels.ptr
        kernels.launch("flash_attention", "gcc_attn_fwd", p(q), p(k), p(v),
                       p(o), p(lse), B, N, dq, dv)
    LAUNCHES["attn_fwd"] += 1
    return o, lse


@functools.lru_cache(maxsize=None)
def dq_groups(N: int) -> int:
    """Key-tile groups of the backward's dq partials for N keys, as the
    kernel library sizes them (at most 16, whatever N is)."""
    return kernels.library("flash_attention").gcc_attn_bwd_groups(N)


def _check_bwd(q, k, v, do, lse, delta):
    B, N, dq, dv = _check_qkv(q, k, v)
    kernels.check(q.device, "do", do, (B, dv, N))
    kernels.check(q.device, "lse", lse, (B, N))
    kernels.check(q.device, "delta", delta, (B, N))
    return B, N, dq, dv


def attn_bwd(q, k, v, do, lse, delta
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(d loss / d q, d loss / d k (B, dq, N), d loss / d v (B, dv, N)) from
    dO = d loss / d O, the saved lse and delta = sum_c dO * O; any N, dq and
    dv. Scratch: dq partials of at most 16 key-tile groups, B * 16 * dq * N
    floats at most."""
    if not q.is_cuda:
        return attn_bwd_plain(q, k, v, do, lse, delta)
    B, N, dq, dv = _check_bwd(q, k, v, do, lse, delta)
    with torch.cuda.device(q.device):
        dq_out, dk, dv_out = (torch.empty_like(q), torch.empty_like(k),
                              torch.empty_like(v))
        # the key-tile groups' dq partials, summed in order by the second pass
        part = torch.empty(B, dq_groups(N), dq, N, device=q.device)
        p = kernels.ptr
        kernels.launch("flash_attention", "gcc_attn_bwd", p(q), p(k), p(v),
                       p(do), p(lse), p(delta), p(dq_out), p(dk), p(dv_out),
                       p(part), B, N, dq, dv)
    LAUNCHES["attn_bwd"] += 1
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
        # delta_i = dO_i . O_i, O(N dv): outside the kernels, as in JAX
        delta = (do * o).sum(dim=1)
        return attn_bwd(q, k, v, do, lse, delta)


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T) v over channel-major q, k (B, dq, N), v (B, dv, N),
    differentiable through the kernels' backward."""
    return _FlashAttention.apply(q, k, v)
