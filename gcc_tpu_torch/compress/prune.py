"""Structured channel pruning: score extraction, cfg derivation, budget search
(port of gcc_tpu/compress/prune.py).

Reimplements the reference's prune semantics as pure functions of the
parameter pytree (no model rebuilds in the loop — the reference instantiates
a full torch model + thop profile per bisection probe, utils/prune_util.py:35-45):

  * unet scale/norm cfg derivation  — models/Pix2Pix.py:823-902 (incl. the
    U-Net skip arithmetic, innermost zero-pairing and f[0] fixup)
  * mobile-resnet residual-averaged norms — models/CycleGAN.py:844-885
  * sagan BN-scale cfgs             — models/SAGAN.py:726-750
  * srresnet inner-width cfgs       — models/SRGAN.py:766-831
  * threshold bounds                — max_min_bn_scale / max_min_conv_norm
    (Pix2Pix.py:754-818, SAGAN.py:704-717, SRGAN.py:712-761, CycleGAN.py:798-839)
  * budget binary search            — utils/prune_util.py:20-47

Weight layout: the JAX package's parameter trees, conv kernels HWIO; a
port net reaches them as ``export_jax_variables(net)["params"]``
(gcc_tpu_torch/utils/weights.py). Per-output-channel L1 norm = sum |w| over
(0, 1, 2), matching torch's sum over (1,2,3) for Conv2d and (0,2,3) for
ConvTranspose2d (both reduce to "all axes but the out-channel axis").

Like the reference, pruned students are re-initialized from scratch and
retrained under distillation; weights are not transplanted (except SRGAN's
lottery path, gcc_tpu.engines.srgan, which the port does not have yet).
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np

from gcc_tpu_torch.compress.macs import (
    mobile_resnet_macs, sagan_macs, srresnet_macs, unet_macs,
)


def l1_out(kernel) -> np.ndarray:
    """Per-out-channel L1 norm of an HWIO kernel."""
    k = np.asarray(kernel, np.float64)
    return np.abs(k).sum(axis=(0, 1, 2))


def _count(scores: np.ndarray, threshold: float) -> int:
    return int((scores > threshold).sum())


# ---------------------------------------------------------------------------
# U-Net
# ---------------------------------------------------------------------------

def unet_norm_scores(params: dict, num_downs: int = 8) -> List[np.ndarray]:
    """Conv L1 norms in traversal order [d0..d_{n-1}, u_{n-1}..u_1, u_0]."""
    n = num_downs
    downs = [l1_out(params[f"down_{d}"]["kernel"]) for d in range(n)]
    ups = [l1_out(params[f"up_{d}"]["kernel"]) for d in range(n - 1, 0, -1)]
    return downs + ups + [l1_out(params["up_0"]["kernel"])]


def unet_scale_scores(params: dict, num_downs: int = 8) -> List[np.ndarray]:
    """BN scales in traversal order [d1..d_{n-2}, u_{n-1}, u_{n-2}..u_1]."""
    n = num_downs
    downs = [np.asarray(params[f"down_norm_{d}"]["scale"], np.float64)
             for d in range(1, n - 1)]
    ups = [np.asarray(params[f"up_norm_{d}"]["scale"], np.float64)
           for d in range(n - 1, 0, -1)]
    return downs + ups


def unet_norm_cfgs(scores: Sequence[np.ndarray], ngf: int, threshold: float,
                   num_downs: int = 8) -> Tuple[list, list]:
    """norm_prune (Pix2Pix.py:866-902). scores as from unet_norm_scores."""
    n = num_downs
    filter_cfgs: list = []
    channel_cfgs: list = []
    upconv_num = 0
    for i, s in enumerate(scores):
        cnt = _count(s, threshold)
        filter_cfgs.append(cnt)
        is_up = i >= n
        is_outermost_up = i == 2 * n - 1
        if is_up:
            upconv_num += 1
            if not is_outermost_up:
                channel_cfgs.append(cnt + filter_cfgs[-1 + (-2) * upconv_num])
        else:
            channel_cfgs.append(cnt)
    if filter_cfgs[0] == 0:
        filter_cfgs[0] = ngf
        channel_cfgs[0] = ngf
        channel_cfgs[-1] += ngf
    return filter_cfgs, channel_cfgs


def unet_scale_cfgs(scores: Sequence[np.ndarray], ngf: int, threshold: float,
                    num_downs: int = 8) -> Tuple[list, list]:
    """scale_prune (Pix2Pix.py:823-864). scores as from unet_scale_scores.

    Traversal: d1..d_{n-2} then u_{n-1} (innermost) .. u_1. The innermost
    downconv has no BN: a fixed ngf*8 entry is appended after d_{n-2}
    (zeroed if d_{n-2} pruned empty). Up entries are zero-paired with their
    skip-side down entries.
    """
    n = num_downs
    filter_cfgs: list = [ngf]
    channel_cfgs: list = [ngf]
    upconv_num = 0
    in_ups = False
    for i, s in enumerate(scores):
        cnt = _count(s, threshold)
        filter_cfgs.append(cnt)
        is_innermost_up = i == n - 2  # first up entry (u_{n-1})
        if is_innermost_up:
            in_ups = True
            if cnt == 0:
                filter_cfgs[-2] = 0  # zero the innermost down
        if in_ups:
            upconv_num += 1
            if filter_cfgs[(-2) * upconv_num] == 0:
                filter_cfgs[-1] = 0
                cnt = 0
            channel_cfgs.append(cnt + filter_cfgs[-1 + (-2) * upconv_num])
        else:
            channel_cfgs.append(cnt)
        is_last_down = i == n - 3  # d_{n-2}
        if is_last_down:
            if filter_cfgs[-1] == 0:
                filter_cfgs.append(0)
                channel_cfgs.append(0)
            else:
                filter_cfgs.append(ngf * 8)
                channel_cfgs.append(ngf * 8)
    return filter_cfgs, channel_cfgs


def unet_bounds(scores: Sequence[np.ndarray], mode: str,
                num_downs: int = 8) -> Tuple[float, float]:
    """(hi, lo) threshold bounds (max_min_bn_scale / max_min_conv_norm,
    Pix2Pix.py:754-818). Prunable = innermost-adjacent layers; hi stays below
    every other layer's max so only the inner pair can vanish."""
    n = num_downs
    if mode == "norm":
        # order [d0..d_{n-1}, u_{n-1}..u_1, u_0]; prunable: d5, d6, d7, u7, u6, u5
        prunable_idx = {n - 3, n - 2, n - 1, n, n + 1, n + 2}
    else:
        # order [d1..d_{n-2}, u_{n-1}..u_1]; prunable: d5, d6, u7, u6, u5
        prunable_idx = {n - 4, n - 3, n - 2, n - 1, n}
    prunable_max = -np.inf
    unprunable_max = np.inf
    overall_min = np.inf
    for i, s in enumerate(scores):
        if i in prunable_idx:
            prunable_max = max(prunable_max, float(s.max()))
        else:
            unprunable_max = min(unprunable_max, float(s.max()))
        overall_min = min(overall_min, float(s.min()))
    return min(prunable_max, unprunable_max), overall_min


# ---------------------------------------------------------------------------
# Mobile ResNet (cyclegan)
# ---------------------------------------------------------------------------

def mobile_resnet_scores(params: dict, n_blocks: int = 9):
    """(per-layer scores dict, residual mean-norm vector).

    Residual group = down_1 + every block's second pointwise conv, scored by
    the mean of their per-channel norms (CycleGAN.py:852-863). Depthwise convs
    and conv_out are unprunable (CycleGAN.py:847-850)."""
    res = [l1_out(params["down_1"]["kernel"])]
    for b in range(n_blocks):
        res.append(l1_out(params[f"block_{b}_sep2"]["pointwise"]["kernel"]))
    residual_mean = np.mean(np.stack(res), axis=0)
    layers = {
        "conv_in": l1_out(params["conv_in"]["kernel"]),
        "down_0": l1_out(params["down_0"]["kernel"]),
    }
    for b in range(n_blocks):
        layers[f"block_{b}_sep1"] = l1_out(
            params[f"block_{b}_sep1"]["pointwise"]["kernel"])
    layers["up_0"] = l1_out(params["up_0"]["kernel"])
    layers["up_1"] = l1_out(params["up_1"]["kernel"])
    return layers, residual_mean


def mobile_resnet_cfgs(layers: dict, residual_mean: np.ndarray,
                       threshold: float, n_blocks: int = 9) -> list:
    """get_prunenet_cfg (CycleGAN.py:844-885): 23-entry cfg for n_blocks=9."""
    res_cnt = _count(residual_mean, threshold)
    cfg = [_count(layers["conv_in"], threshold),
           _count(layers["down_0"], threshold), res_cnt]
    for b in range(n_blocks):
        cfg.append(_count(layers[f"block_{b}_sep1"], threshold))
        cfg.append(res_cnt)
    cfg.append(_count(layers["up_0"], threshold))
    cfg.append(_count(layers["up_1"], threshold))
    return cfg


def mobile_resnet_bounds(layers: dict, residual_mean: np.ndarray):
    """max_min_conv_norm(netG) (CycleGAN.py:798-839): hi = min over all
    considered layers of per-layer max, lo = overall min."""
    all_scores = list(layers.values()) + [residual_mean]
    hi = min(float(s.max()) for s in all_scores)
    lo = min(float(s.min()) for s in all_scores)
    return hi, lo


def mobile_resnet_scores_union(params: dict, n_blocks: int = 9):
    """Pix2Pix resnet-backbone variant (Pix2Pix.py:904-952): the residual
    group keeps a channel if ANY member conv's norm clears the threshold
    (union mask), unlike CycleGAN's mean-norm tying. Returns per-layer
    scores plus the stacked residual norms (union applied per-threshold)."""
    res = [l1_out(params["down_1"]["kernel"])]
    for b in range(n_blocks):
        res.append(l1_out(params[f"block_{b}_sep2"]["pointwise"]["kernel"]))
    layers = {
        "conv_in": l1_out(params["conv_in"]["kernel"]),
        "down_0": l1_out(params["down_0"]["kernel"]),
    }
    for b in range(n_blocks):
        layers[f"block_{b}_sep1"] = l1_out(
            params[f"block_{b}_sep1"]["pointwise"]["kernel"])
    layers["up_0"] = l1_out(params["up_0"]["kernel"])
    layers["up_1"] = l1_out(params["up_1"]["kernel"])
    return layers, np.stack(res)


def mobile_resnet_cfgs_union(layers: dict, residual_norms: np.ndarray,
                             threshold: float, n_blocks: int = 9) -> list:
    res_cnt = int(((residual_norms > threshold).sum(axis=0) > 0).sum())
    cfg = [_count(layers["conv_in"], threshold),
           _count(layers["down_0"], threshold), res_cnt]
    for b in range(n_blocks):
        cfg.append(_count(layers[f"block_{b}_sep1"], threshold))
        cfg.append(res_cnt)
    cfg.append(_count(layers["up_0"], threshold))
    cfg.append(_count(layers["up_1"], threshold))
    return cfg


def prune_mobile_resnet_union(params: dict, *, target_budget_g: float,
                              tolerance_g: float = 0.1, n_blocks: int = 9,
                              image_size: int = 256):
    """Pix2Pix --backbone resnet prune driver (resnet_prune semantics)."""
    layers, res = mobile_resnet_scores_union(params, n_blocks)
    all_scores = list(layers.values()) + [res.max(axis=0)]
    hi = min(float(s.max()) for s in all_scores)
    lo = min(float(s.min()) for s in all_scores)
    _, cfg, g = binary_search_threshold(
        (hi, lo), lambda t: mobile_resnet_cfgs_union(layers, res, t, n_blocks),
        lambda c: mobile_resnet_macs(c, n_blocks, image_size),
        target_budget_g, tolerance_g)
    return cfg, g


def cyclegan_reference_cfgs() -> Tuple[list, list]:
    """The hard-coded horse2zebra cfgs the reference actually trains with,
    overriding its own search (utils/prune_util.py:120-121)."""
    cfg_AtoB = [24, 48, 86, 72, 86, 47, 86, 44, 86, 43, 86, 43, 86, 29, 86,
                30, 86, 37, 86, 36, 86, 48, 24]
    cfg_BtoA = [24, 48, 96, 91, 96, 73, 96, 62, 96, 61, 96, 74, 96, 54, 96,
                51, 96, 58, 96, 81, 96, 48, 24]
    return cfg_AtoB, cfg_BtoA


# ---------------------------------------------------------------------------
# SAGAN
# ---------------------------------------------------------------------------

def sagan_scale_scores(params: dict) -> List[np.ndarray]:
    return [np.asarray(params[f"bn{i}"]["scale"], np.float64)
            for i in range(1, 5)]


def sagan_cfgs(scores: Sequence[np.ndarray], threshold: float) -> list:
    return [_count(s, threshold) for s in scores]


def sagan_bounds(scores: Sequence[np.ndarray]):
    hi = min(float(s.max()) for s in scores)
    lo = min(float(s.min()) for s in scores)
    return hi, lo


# ---------------------------------------------------------------------------
# SRResNet
# ---------------------------------------------------------------------------

def srresnet_scores(params: dict, mode: str, n_blocks: int = 16):
    if mode == "norm":
        return [l1_out(params[f"block_{b}_conv1"]["kernel"])
                for b in range(n_blocks)]
    return [np.asarray(params[f"block_{b}_bn1"]["scale"], np.float64)
            for b in range(n_blocks)]


def srresnet_cfgs(scores: Sequence[np.ndarray], threshold: float) -> list:
    return [_count(s, threshold) for s in scores]


def srresnet_bounds(scores: Sequence[np.ndarray]):
    hi = min(float(s.max()) for s in scores)
    lo = min(float(s.min()) for s in scores)
    return hi, lo


# ---------------------------------------------------------------------------
# Budget binary search (utils/prune_util.py:20-47, pure)
# ---------------------------------------------------------------------------

def binary_search_threshold(bounds: Tuple[float, float],
                            cfg_fn: Callable[[float], object],
                            macs_fn: Callable[[object], float],
                            target_budget_g: float,
                            tolerance_g: float,
                            max_iters: int = 200):
    """Bisect threshold until GMACs within tolerance of target.

    Returns (threshold, cfgs, gmacs). Raises if no threshold fits, like the
    reference — but bounded instead of looping forever on float bisection."""
    hi, lo = bounds
    for _ in range(max_iters):
        if not hi > lo:
            break
        mid = (hi + lo) / 2
        cfgs = cfg_fn(mid)
        g = macs_fn(cfgs) / 1e9
        if abs(target_budget_g - g) <= tolerance_g:
            return mid, cfgs, g
        if target_budget_g - g > tolerance_g:
            hi = mid  # pruned too much; lower the threshold ceiling
        else:
            lo = mid
    raise RuntimeError(
        f"no threshold found for budget {target_budget_g}G "
        f"(tolerance {tolerance_g}G, bounds [{lo}, {hi}])")


def tolerance_for(dataroot: str) -> float:
    """Task-dependent GMACs tolerance (utils/prune_util.py:28-33)."""
    if "sr" in dataroot:
        return 0.01
    if "celeb" in dataroot or "church" in dataroot:
        return 0.001
    return 0.1


# ---------------------------------------------------------------------------
# One-call drivers per family
# ---------------------------------------------------------------------------

def prune_unet(params: dict, *, mode: str, ngf: int, target_budget_g: float,
               tolerance_g: float = 0.1, num_downs: int = 8,
               image_size: int = 256):
    """Derive (filter_cfgs, channel_cfgs) for a U-Net under a MACs budget."""
    if mode == "scale":
        scores = unet_scale_scores(params, num_downs)
        cfg_fn = lambda t: unet_scale_cfgs(scores, ngf, t, num_downs)
    elif mode == "norm":
        scores = unet_norm_scores(params, num_downs)
        cfg_fn = lambda t: unet_norm_cfgs(scores, ngf, t, num_downs)
    else:
        raise NotImplementedError("only scale and norm pruning are supported")
    bounds = unet_bounds(scores, mode, num_downs)
    _, cfgs, g = binary_search_threshold(
        bounds, cfg_fn, lambda c: unet_macs(c[0], num_downs, image_size),
        target_budget_g, tolerance_g)
    return cfgs[0], cfgs[1], g


def prune_mobile_resnet(params: dict, *, target_budget_g: float,
                        tolerance_g: float = 0.05, n_blocks: int = 9,
                        image_size: int = 256):
    layers, res = mobile_resnet_scores(params, n_blocks)
    bounds = mobile_resnet_bounds(layers, res)
    _, cfg, g = binary_search_threshold(
        bounds, lambda t: mobile_resnet_cfgs(layers, res, t, n_blocks),
        lambda c: mobile_resnet_macs(c, n_blocks, image_size),
        target_budget_g, tolerance_g)
    return cfg, g


def prune_sagan(params: dict, *, target_budget_g: float,
                tolerance_g: float = 0.001, z_dim: int = 128,
                image_size: int = 64):
    scores = sagan_scale_scores(params)
    _, cfg, g = binary_search_threshold(
        sagan_bounds(scores), lambda t: sagan_cfgs(scores, t),
        lambda c: sagan_macs(c, z_dim, image_size),
        target_budget_g, tolerance_g)
    return cfg, g


def prune_srresnet(params: dict, *, mode: str, n_channels: int,
                   target_budget_g: float, tolerance_g: float = 0.01,
                   n_blocks: int = 16, lr_size: int = 24):
    scores = srresnet_scores(params, mode, n_blocks)
    _, cfg, g = binary_search_threshold(
        srresnet_bounds(scores), lambda t: srresnet_cfgs(scores, t),
        lambda c: srresnet_macs(c, n_channels, n_blocks, lr_size),
        target_budget_g, tolerance_g)
    return cfg, g
