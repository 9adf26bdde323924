"""Reference (torch) GCC checkpoints as the JAX-layout parameter trees the
port's checkpoints store (copy of gcc_tpu/utils/torch_port.py; numpy only).

Lets reference users bring their trained .pth checkpoints: generators and
discriminators port layer-for-layer, into the trees that
``utils/checkpoint.py`` writes and ``utils/weights.load_jax_variables``
reads (the evaluators' loaders live in gcc_tpu_torch.metrics.inception /
miou / vgg).

Layout conventions:
  torch Conv2d weight (O, I, H, W)            -> HWIO transpose (2, 3, 1, 0)
  torch ConvTranspose2d weight (I, O, H, W)   -> HWIO transpose (2, 3, 0, 1)
    (our ConvTranspose flips spatially at call time, matching torch's
     cross-correlation-of-dilated-input semantics)
  torch BatchNorm2d {weight, bias, running_mean, running_var}
    -> params {scale, bias} + batch_stats {mean, var}

Name maps follow the reference module trees:
  UnetGenertor   models/Pix2Pix.py:79-130   (recursive model.model... paths)
  NLayerDiscriminator / MaskNLayerDiscriminator  Pix2Pix.py:267-348
  MobileResnetGenerator  models/CycleGAN.py:77-138
  SRResNet Generator     models/SRGAN.py:139-197
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def _conv(sd, key):
    return np.transpose(np.asarray(sd[key]), (2, 3, 1, 0))


def _deconv(sd, key):
    return np.transpose(np.asarray(sd[key]), (2, 3, 0, 1))


def _bn(sd, prefix):
    return ({"scale": np.asarray(sd[f"{prefix}.weight"]),
             "bias": np.asarray(sd[f"{prefix}.bias"])},
            {"mean": np.asarray(sd[f"{prefix}.running_mean"]),
             "var": np.asarray(sd[f"{prefix}.running_var"])})


def _to_numpy_sd(sd):
    out = {}
    for k, v in sd.items():
        out[k] = v.numpy() if hasattr(v, "numpy") else np.asarray(v)
    return out


# ---------------------------------------------------------------------------
# U-Net generator (UnetGenertor)
# ---------------------------------------------------------------------------

def _unet_prefix(depth: int) -> str:
    """torch Sequential path prefix of the block at `depth` (>=1)."""
    return "model.model.1.model." + "3.model." * (depth - 1)


def port_unet_generator(sd: dict, num_downs: int = 8) -> Tuple[dict, dict]:
    """torch UnetGenertor state_dict -> (params, batch_stats)."""
    sd = _to_numpy_sd(sd)
    n = num_downs
    params: Dict = {}
    stats: Dict = {}

    params["down_0"] = {"kernel": _conv(sd, "model.model.0.weight")}
    params["up_0"] = {"kernel": _deconv(sd, "model.model.3.weight"),
                      "bias": np.asarray(sd["model.model.3.bias"])}
    for d in range(1, n):
        p = _unet_prefix(d)
        if f"{p}1.weight" not in sd:
            continue  # elided block (pruned to zero width)
        params[f"down_{d}"] = {"kernel": _conv(sd, f"{p}1.weight")}
        if d == n - 1:  # innermost: up at index 3, norm at 4, no down norm
            params[f"up_{d}"] = {"kernel": _deconv(sd, f"{p}3.weight")}
            pn, sn = _bn(sd, f"{p}4")
            params[f"up_norm_{d}"], stats[f"up_norm_{d}"] = pn, sn
        else:
            pn, sn = _bn(sd, f"{p}2")
            params[f"down_norm_{d}"], stats[f"down_norm_{d}"] = pn, sn
            params[f"up_{d}"] = {"kernel": _deconv(sd, f"{p}5.weight")}
            pn, sn = _bn(sd, f"{p}6")
            params[f"up_norm_{d}"], stats[f"up_norm_{d}"] = pn, sn
    return params, stats


# ---------------------------------------------------------------------------
# PatchGAN (NLayerDiscriminator / MaskNLayerDiscriminator)
# ---------------------------------------------------------------------------

def port_patchgan(sd: dict, n_layers: int = 3, masked: bool = False
                  ) -> Tuple[dict, dict, Optional[dict]]:
    """torch PatchGAN state_dict -> (params, batch_stats, arch or None).

    Plain layout (Pix2Pix.py:280-301): convs at 0, 3k-1... derived from the
    Sequential indices; masked layout (l.320-344) interleaves DifferentiableOP
    (alpha) entries.
    """
    sd = _to_numpy_sd(sd)
    params: Dict = {}
    stats: Dict = {}
    arch: Dict = {}
    if masked:
        # indices: 0 conv,1 lrelu,2 op | 3 conv,4 bn,5 op,6 lrelu | 7,8,9,10 |
        #          11 conv,12 bn,13 op,14 lrelu | 15 conv
        conv_idx = [0, 3, 7, 11]
        bn_idx = [None, 4, 8, 12]
        op_idx = [2, 5, 9, 13]
        out_idx = 15
    else:
        # 0 conv,1 lrelu | 2 conv,3 bn,4 lrelu | 5,6,7 | 8 conv,9 bn,10 | 11
        conv_idx = [0, 2, 5, 8]
        bn_idx = [None, 3, 6, 9]
        op_idx = [None] * 4
        out_idx = 11
    for i, (ci, bi, oi) in enumerate(zip(conv_idx, bn_idx, op_idx)):
        node = {"kernel": _conv(sd, f"model.{ci}.weight")}
        if f"model.{ci}.bias" in sd:
            node["bias"] = np.asarray(sd[f"model.{ci}.bias"])
        params[f"conv_{i}"] = node
        if bi is not None and f"model.{bi}.weight" in sd:
            pn, sn = _bn(sd, f"model.{bi}")
            params[f"norm_{i}"], stats[f"norm_{i}"] = pn, sn
        if oi is not None and f"model.{oi}.alpha" in sd:
            arch[f"mask_{i}"] = {"alpha": np.asarray(
                sd[f"model.{oi}.alpha"]).reshape(-1)}
    params["conv_out"] = {"kernel": _conv(sd, f"model.{out_idx}.weight"),
                          "bias": np.asarray(sd[f"model.{out_idx}.bias"])}
    return params, stats, (arch if arch else None)


# ---------------------------------------------------------------------------
# Mobile ResNet generator
# ---------------------------------------------------------------------------

def port_mobile_resnet(sd: dict, n_blocks: int = 9) -> dict:
    """torch MobileResnetGenerator state_dict -> params (InstanceNorm is
    stateless). Handles elided (pruned-away) blocks by key absence."""
    sd = _to_numpy_sd(sd)
    params: Dict = {}

    def sep(prefix):
        return {"depthwise": {"kernel": _conv(sd, f"{prefix}.0.weight"),
                              "bias": np.asarray(sd[f"{prefix}.0.bias"])},
                "pointwise": {"kernel": _conv(sd, f"{prefix}.2.weight"),
                              "bias": np.asarray(sd[f"{prefix}.2.bias"])}}

    params["conv_in"] = {"kernel": _conv(sd, "model.1.weight"),
                         "bias": np.asarray(sd["model.1.bias"])}
    params["down_0"] = {"kernel": _conv(sd, "model.4.weight"),
                        "bias": np.asarray(sd["model.4.bias"])}
    params["down_1"] = {"kernel": _conv(sd, "model.7.weight"),
                        "bias": np.asarray(sd["model.7.bias"])}
    torch_block = 10
    for b in range(n_blocks):
        key = f"model.{torch_block}.conv_block.1.conv.0.weight"
        if key not in sd:
            continue  # block elided by pruning; torch indices shift
        params[f"block_{b}_sep1"] = sep(f"model.{torch_block}.conv_block.1.conv")
        params[f"block_{b}_sep2"] = sep(f"model.{torch_block}.conv_block.6.conv")
        torch_block += 1
    up0 = torch_block
    params["up_0"] = {"kernel": _deconv(sd, f"model.{up0}.weight"),
                      "bias": np.asarray(sd[f"model.{up0}.bias"])}
    params["up_1"] = {"kernel": _deconv(sd, f"model.{up0 + 3}.weight"),
                      "bias": np.asarray(sd[f"model.{up0 + 3}.bias"])}
    params["conv_out"] = {"kernel": _conv(sd, f"model.{up0 + 7}.weight"),
                          "bias": np.asarray(sd[f"model.{up0 + 7}.bias"])}
    return params


# ---------------------------------------------------------------------------
# SAGAN generator / discriminator (spectral norm: weight_bar + u/v state)
# ---------------------------------------------------------------------------

def _attn(sd, prefix):
    node = {}
    for name in ("query_conv", "key_conv", "value_conv"):
        node[name] = {"kernel": _conv(sd, f"{prefix}.{name}.weight"),
                      "bias": np.asarray(sd[f"{prefix}.{name}.bias"])}
    node["gamma"] = np.asarray(sd[f"{prefix}.gamma"]).reshape(())
    return node


def _spec_v(sd, module_prefix):
    """Power-iteration v: torch (c,kh,kw)-flattened -> jax (h,w,c)-flattened
    (inverse of torch_export._inv_spec_v; see that docstring). The torch
    weight_bar's shape[1] is the non-height channel axis for BOTH Conv2d
    (O,I,kh,kw) and ConvTranspose2d (I,O,kh,kw)."""
    w = np.asarray(sd[f"{module_prefix}.weight_bar"])
    c, kh, kw = w.shape[1], w.shape[2], w.shape[3]
    return np.ascontiguousarray(
        np.asarray(sd[f"{module_prefix}.weight_v"])
        .reshape(c, kh, kw).transpose(1, 2, 0).ravel())


def port_sagan_generator(sd: dict) -> Tuple[dict, dict, dict]:
    """torch SAGAN Generator (models/SAGAN.py:109-171) ->
    (params, batch_stats, spectral). SpectralNorm wrappers store the raw
    kernel as `module.weight_bar` plus power-iteration vectors
    `module.weight_u` / `module.weight_v` (SAGAN.py:40-56)."""
    sd = _to_numpy_sd(sd)
    params: Dict = {}
    stats: Dict = {}
    spectral: Dict = {}
    for i in range(1, 5):
        p = f"l{i}.0.module"
        params[f"l{i}"] = {"kernel": _deconv(sd, f"{p}.weight_bar"),
                           "bias": np.asarray(sd[f"{p}.bias"])}
        spectral[f"l{i}"] = {"u": np.asarray(sd[f"{p}.weight_u"]),
                             "v": _spec_v(sd, p)}
        pn, sn = _bn(sd, f"l{i}.1")
        params[f"bn{i}"], stats[f"bn{i}"] = pn, sn
    params["attn1"] = _attn(sd, "attn1")
    params["attn2"] = _attn(sd, "attn2")
    params["last"] = {"kernel": _deconv(sd, "last.0.weight"),
                      "bias": np.asarray(sd["last.0.bias"])}
    return params, stats, spectral


def port_sagan_discriminator(sd: dict, masked: bool = False
                             ) -> Tuple[dict, dict, Optional[dict]]:
    """torch SAGAN Discriminator / MaskDiscriminator (SAGAN.py:173-277) ->
    (params, spectral, arch or None)."""
    sd = _to_numpy_sd(sd)
    params: Dict = {}
    spectral: Dict = {}
    arch: Dict = {}
    for i in range(1, 5):
        p = f"l{i}.0.module"
        params[f"l{i}"] = {"kernel": _conv(sd, f"{p}.weight_bar"),
                           "bias": np.asarray(sd[f"{p}.bias"])}
        spectral[f"l{i}"] = {"u": np.asarray(sd[f"{p}.weight_u"]),
                             "v": _spec_v(sd, p)}
        if masked and f"l{i}.1.alpha" in sd:
            arch[f"mask_{i}"] = {"alpha": np.asarray(
                sd[f"l{i}.1.alpha"]).reshape(-1)}
    params["attn1"] = _attn(sd, "attn1")
    params["attn2"] = _attn(sd, "attn2")
    params["last"] = {"kernel": _conv(sd, "last.0.weight"),
                      "bias": np.asarray(sd["last.0.bias"])}
    return params, spectral, (arch if arch else None)


# ---------------------------------------------------------------------------
# SRGAN discriminator (VGG-style, models/SRGAN.py:199-295)
# ---------------------------------------------------------------------------

def port_srgan_discriminator(sd: dict, n_blocks: int = 4, masked: bool = False
                             ) -> Tuple[dict, dict, Optional[dict]]:
    """torch SRGAN Discriminator / MaskDiscriminator state_dict ->
    (params, batch_stats, arch or None).

    Layout (SRGAN.py:15-69, 199-295): conv_blocks.{i}.conv_block is
    [Conv2d] + ([BatchNorm2d] if i != 0) + ([DifferentiableOP] if masked)
    + LeakyReLU; head is fc1 (torch Linear weight (out, in) -> Dense
    kernel (in, out))."""
    sd = _to_numpy_sd(sd)
    params: Dict = {}
    stats: Dict = {}
    arch: Dict = {}
    for i in range(n_blocks):
        p = f"conv_blocks.{i}.conv_block"
        params[f"conv_{i}"] = {"kernel": _conv(sd, f"{p}.0.weight"),
                               "bias": np.asarray(sd[f"{p}.0.bias"])}
        if i != 0:
            pn, sn = _bn(sd, f"{p}.1")
            params[f"norm_{i}"], stats[f"norm_{i}"] = pn, sn
        if masked:
            oi = 1 if i == 0 else 2
            if f"{p}.{oi}.alpha" in sd:
                arch[f"mask_{i}"] = {"alpha": np.asarray(
                    sd[f"{p}.{oi}.alpha"]).reshape(-1)}
    params["fc"] = {"kernel": np.transpose(np.asarray(sd["fc1.weight"])),
                    "bias": np.asarray(sd["fc1.bias"])}
    return params, stats, (arch if arch else None)


# ---------------------------------------------------------------------------
# SRResNet generator
# ---------------------------------------------------------------------------

def port_srresnet(sd: dict, n_blocks: int = 16) -> Tuple[dict, dict]:
    sd = _to_numpy_sd(sd)
    params: Dict = {}
    stats: Dict = {}
    params["conv_in"] = {
        "kernel": _conv(sd, "conv_block1.conv_block.0.weight"),
        "bias": np.asarray(sd["conv_block1.conv_block.0.bias"])}
    params["prelu_in"] = {"alpha": np.asarray(
        sd["conv_block1.conv_block.1.weight"]).reshape(())}
    for b in range(n_blocks):
        p = f"residual_blocks.{b}"
        if f"{p}.conv_block1.conv_block.0.weight" not in sd:
            continue
        params[f"block_{b}_conv1"] = {
            "kernel": _conv(sd, f"{p}.conv_block1.conv_block.0.weight"),
            "bias": np.asarray(sd[f"{p}.conv_block1.conv_block.0.bias"])}
        pn, sn = _bn(sd, f"{p}.conv_block1.conv_block.1")
        params[f"block_{b}_bn1"], stats[f"block_{b}_bn1"] = pn, sn
        params[f"block_{b}_prelu"] = {"alpha": np.asarray(
            sd[f"{p}.conv_block1.conv_block.2.weight"]).reshape(())}
        params[f"block_{b}_conv2"] = {
            "kernel": _conv(sd, f"{p}.conv_block2.conv_block.0.weight"),
            "bias": np.asarray(sd[f"{p}.conv_block2.conv_block.0.bias"])}
        pn, sn = _bn(sd, f"{p}.conv_block2.conv_block.1")
        params[f"block_{b}_bn2"], stats[f"block_{b}_bn2"] = pn, sn
    params["conv_mid"] = {
        "kernel": _conv(sd, "conv_block2.conv_block.0.weight"),
        "bias": np.asarray(sd["conv_block2.conv_block.0.bias"])}
    pn, sn = _bn(sd, "conv_block2.conv_block.1")
    params["bn_mid"], stats["bn_mid"] = pn, sn
    for i in range(2):
        p = f"subpixel_convolutional_blocks.{i}"
        params[f"subpixel_{i}"] = {
            "conv": {"kernel": _conv(sd, f"{p}.conv.weight"),
                     "bias": np.asarray(sd[f"{p}.conv.bias"])},
            "prelu": {"alpha": np.asarray(
                sd[f"{p}.prelu.weight"]).reshape(())}}
    params["conv_out"] = {
        "kernel": _conv(sd, "conv_block3.conv_block.0.weight"),
        "bias": np.asarray(sd["conv_block3.conv_block.0.bias"])}
    return params, stats
