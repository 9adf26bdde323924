"""Export the port's checkpoints (JAX-layout trees) back to reference
(torch) state dicts (copy of gcc_tpu/utils/torch_export.py).

The inverse of gcc_tpu_torch.utils.torch_port: lets models trained here be
evaluated/served with the reference's own tooling (reference test.py loads
`ckpt['G']` with `load_discriminator=False`, test.py:140-155), or compared
side-by-side in torch. Round-trip is exact by construction — every mapping
mirrors the corresponding port_* loop; tests/test_torch_convert.py holds
the .pth tensors equal to gcc_tpu's.

Layout inverses:
  HWIO conv kernel  -> torch Conv2d (O, I, H, W):           transpose (3, 2, 0, 1)
  HWIO forward-conv kernel of a transpose conv
                    -> torch ConvTranspose2d (I, O, H, W):  transpose (2, 3, 0, 1)
  params{scale,bias}+batch_stats{mean,var}
                    -> {weight, bias, running_mean, running_var,
                        num_batches_tracked}
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _inv_conv(kernel) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def _inv_deconv(kernel) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(kernel), (2, 3, 0, 1)))


def _inv_bn(sd: dict, prefix: str, p: dict, s: dict) -> None:
    sd[f"{prefix}.weight"] = np.asarray(p["scale"])
    sd[f"{prefix}.bias"] = np.asarray(p["bias"])
    sd[f"{prefix}.running_mean"] = np.asarray(s["mean"])
    sd[f"{prefix}.running_var"] = np.asarray(s["var"])
    sd[f"{prefix}.num_batches_tracked"] = np.asarray(0, np.int64)


# ---------------------------------------------------------------------------
# U-Net generator (reference UnetGenertor, models/Pix2Pix.py:79-130)
# ---------------------------------------------------------------------------

def export_unet_generator(params: dict, stats: dict,
                          num_downs: int = 8) -> dict:
    from gcc_tpu_torch.utils.torch_port import _unet_prefix
    n = num_downs
    sd: Dict[str, np.ndarray] = {}
    sd["model.model.0.weight"] = _inv_conv(params["down_0"]["kernel"])
    sd["model.model.3.weight"] = _inv_deconv(params["up_0"]["kernel"])
    sd["model.model.3.bias"] = np.asarray(params["up_0"]["bias"])
    for d in range(1, n):
        if f"down_{d}" not in params:
            continue  # elided block
        p = _unet_prefix(d)
        sd[f"{p}1.weight"] = _inv_conv(params[f"down_{d}"]["kernel"])
        if d == n - 1:
            sd[f"{p}3.weight"] = _inv_deconv(params[f"up_{d}"]["kernel"])
            _inv_bn(sd, f"{p}4", params[f"up_norm_{d}"],
                    stats[f"up_norm_{d}"])
        else:
            _inv_bn(sd, f"{p}2", params[f"down_norm_{d}"],
                    stats[f"down_norm_{d}"])
            sd[f"{p}5.weight"] = _inv_deconv(params[f"up_{d}"]["kernel"])
            _inv_bn(sd, f"{p}6", params[f"up_norm_{d}"],
                    stats[f"up_norm_{d}"])
    return sd


# ---------------------------------------------------------------------------
# PatchGAN (NLayerDiscriminator / MaskNLayerDiscriminator)
# ---------------------------------------------------------------------------

def export_patchgan(params: dict, stats: dict,
                    arch: Optional[dict] = None,
                    masked: bool = False) -> dict:
    if masked:
        conv_idx, bn_idx, op_idx, out_idx = ([0, 3, 7, 11], [None, 4, 8, 12],
                                             [2, 5, 9, 13], 15)
    else:
        conv_idx, bn_idx, op_idx, out_idx = ([0, 2, 5, 8], [None, 3, 6, 9],
                                             [None] * 4, 11)
    sd: Dict[str, np.ndarray] = {}
    for i, (ci, bi, oi) in enumerate(zip(conv_idx, bn_idx, op_idx)):
        node = params[f"conv_{i}"]
        sd[f"model.{ci}.weight"] = _inv_conv(node["kernel"])
        if "bias" in node:
            sd[f"model.{ci}.bias"] = np.asarray(node["bias"])
        if bi is not None and f"norm_{i}" in params:
            _inv_bn(sd, f"model.{bi}", params[f"norm_{i}"],
                    stats[f"norm_{i}"])
        if oi is not None and arch and f"mask_{i}" in arch:
            sd[f"model.{oi}.alpha"] = np.asarray(
                arch[f"mask_{i}"]["alpha"]).reshape(-1)
    sd[f"model.{out_idx}.weight"] = _inv_conv(params["conv_out"]["kernel"])
    sd[f"model.{out_idx}.bias"] = np.asarray(params["conv_out"]["bias"])
    return sd


# ---------------------------------------------------------------------------
# Mobile ResNet generator (models/CycleGAN.py:77-138)
# ---------------------------------------------------------------------------

def export_mobile_resnet(params: dict, n_blocks: int = 9) -> dict:
    sd: Dict[str, np.ndarray] = {}

    def sep(prefix, node):
        sd[f"{prefix}.0.weight"] = _inv_conv(node["depthwise"]["kernel"])
        sd[f"{prefix}.0.bias"] = np.asarray(node["depthwise"]["bias"])
        sd[f"{prefix}.2.weight"] = _inv_conv(node["pointwise"]["kernel"])
        sd[f"{prefix}.2.bias"] = np.asarray(node["pointwise"]["bias"])

    def conv(prefix, node, deconv=False):
        sd[f"{prefix}.weight"] = (_inv_deconv if deconv
                                  else _inv_conv)(node["kernel"])
        sd[f"{prefix}.bias"] = np.asarray(node["bias"])

    conv("model.1", params["conv_in"])
    conv("model.4", params["down_0"])
    conv("model.7", params["down_1"])
    torch_block = 10
    for b in range(n_blocks):
        if f"block_{b}_sep1" not in params:
            continue  # elided: torch indices shift (CycleGAN.py:112-113)
        sep(f"model.{torch_block}.conv_block.1.conv",
            params[f"block_{b}_sep1"])
        sep(f"model.{torch_block}.conv_block.6.conv",
            params[f"block_{b}_sep2"])
        torch_block += 1
    conv(f"model.{torch_block}", params["up_0"], deconv=True)
    conv(f"model.{torch_block + 3}", params["up_1"], deconv=True)
    conv(f"model.{torch_block + 7}", params["conv_out"])
    return sd


# ---------------------------------------------------------------------------
# SAGAN generator / discriminator (spectral norm: weight_bar + u/v state)
# ---------------------------------------------------------------------------

def _inv_attn(sd, prefix, node):
    for name in ("query_conv", "key_conv", "value_conv"):
        sd[f"{prefix}.{name}.weight"] = _inv_conv(node[name]["kernel"])
        sd[f"{prefix}.{name}.bias"] = np.asarray(node[name]["bias"])
    sd[f"{prefix}.gamma"] = np.asarray(node["gamma"]).reshape(1)


def _inv_spec_v(v, kernel_hwio, deconv: bool = False):
    """Power-iteration v: jax (h,w,c)-flattened -> torch (c,kh,kw)-flattened
    (torch matricizes w.view(height, -1) over C-ordered (c,kh,kw) columns,
    SAGAN.py:31-38; ours moves the height axis to the front of HWIO, leaving
    (h,w,c) columns — see ops/spectral.py). c is I for conv (height=O) and
    O for deconv (height=I). The vectors are equivalent up to this column
    permutation (sigma and u are permutation-invariant), but torch resumes
    power iteration from the stored v only if it is in ITS column order."""
    kh, kw, ci, co = np.shape(kernel_hwio)
    c = co if deconv else ci
    return np.ascontiguousarray(
        np.asarray(v).reshape(kh, kw, c).transpose(2, 0, 1).ravel())


def export_sagan_generator(params: dict, stats: dict,
                           spectral: dict) -> dict:
    sd: Dict[str, np.ndarray] = {}
    for i in range(1, 5):
        p = f"l{i}.0.module"
        sd[f"{p}.weight_bar"] = _inv_deconv(params[f"l{i}"]["kernel"])
        sd[f"{p}.bias"] = np.asarray(params[f"l{i}"]["bias"])
        sd[f"{p}.weight_u"] = np.asarray(spectral[f"l{i}"]["u"])
        sd[f"{p}.weight_v"] = _inv_spec_v(
            spectral[f"l{i}"]["v"], params[f"l{i}"]["kernel"], deconv=True)
        _inv_bn(sd, f"l{i}.1", params[f"bn{i}"], stats[f"bn{i}"])
    _inv_attn(sd, "attn1", params["attn1"])
    _inv_attn(sd, "attn2", params["attn2"])
    sd["last.0.weight"] = _inv_deconv(params["last"]["kernel"])
    sd["last.0.bias"] = np.asarray(params["last"]["bias"])
    return sd


def export_sagan_discriminator(params: dict, spectral: dict,
                               arch: Optional[dict] = None) -> dict:
    sd: Dict[str, np.ndarray] = {}
    for i in range(1, 5):
        p = f"l{i}.0.module"
        sd[f"{p}.weight_bar"] = _inv_conv(params[f"l{i}"]["kernel"])
        sd[f"{p}.bias"] = np.asarray(params[f"l{i}"]["bias"])
        sd[f"{p}.weight_u"] = np.asarray(spectral[f"l{i}"]["u"])
        sd[f"{p}.weight_v"] = _inv_spec_v(
            spectral[f"l{i}"]["v"], params[f"l{i}"]["kernel"])
        if arch and f"mask_{i}" in arch:
            sd[f"l{i}.1.alpha"] = np.asarray(
                arch[f"mask_{i}"]["alpha"]).reshape(-1)
    _inv_attn(sd, "attn1", params["attn1"])
    _inv_attn(sd, "attn2", params["attn2"])
    sd["last.0.weight"] = _inv_conv(params["last"]["kernel"])
    sd["last.0.bias"] = np.asarray(params["last"]["bias"])
    return sd


# ---------------------------------------------------------------------------
# SRGAN discriminator (VGG-style, models/SRGAN.py:199-295)
# ---------------------------------------------------------------------------

def export_srgan_discriminator(params: dict, stats: dict,
                               arch: Optional[dict] = None,
                               n_blocks: int = 4) -> dict:
    """Inverse of port_srgan_discriminator: conv_blocks.{i}.conv_block =
    [Conv2d] + ([BN] if i != 0) + ([DifferentiableOP] if masked) + LeakyReLU;
    fc head transposed back to torch Linear (out, in)."""
    sd: Dict[str, np.ndarray] = {}
    for i in range(n_blocks):
        p = f"conv_blocks.{i}.conv_block"
        sd[f"{p}.0.weight"] = _inv_conv(params[f"conv_{i}"]["kernel"])
        sd[f"{p}.0.bias"] = np.asarray(params[f"conv_{i}"]["bias"])
        if i != 0 and f"norm_{i}" in params:
            _inv_bn(sd, f"{p}.1", params[f"norm_{i}"], stats[f"norm_{i}"])
        if arch and f"mask_{i}" in arch:
            oi = 1 if i == 0 else 2
            sd[f"{p}.{oi}.alpha"] = np.asarray(
                arch[f"mask_{i}"]["alpha"]).reshape(-1)
    sd["fc1.weight"] = np.ascontiguousarray(
        np.transpose(np.asarray(params["fc"]["kernel"])))
    sd["fc1.bias"] = np.asarray(params["fc"]["bias"])
    return sd


# ---------------------------------------------------------------------------
# SRResNet generator (models/SRGAN.py:139-197)
# ---------------------------------------------------------------------------

def export_srresnet(params: dict, stats: dict, n_blocks: int = 16) -> dict:
    sd: Dict[str, np.ndarray] = {}

    def conv(prefix, node):
        sd[f"{prefix}.weight"] = _inv_conv(node["kernel"])
        sd[f"{prefix}.bias"] = np.asarray(node["bias"])

    def prelu(prefix, node):
        sd[f"{prefix}.weight"] = np.asarray(node["alpha"]).reshape(1)

    conv("conv_block1.conv_block.0", params["conv_in"])
    prelu("conv_block1.conv_block.1", params["prelu_in"])
    for b in range(n_blocks):
        if f"block_{b}_conv1" not in params:
            continue
        p = f"residual_blocks.{b}"
        conv(f"{p}.conv_block1.conv_block.0", params[f"block_{b}_conv1"])
        _inv_bn(sd, f"{p}.conv_block1.conv_block.1",
                params[f"block_{b}_bn1"], stats[f"block_{b}_bn1"])
        prelu(f"{p}.conv_block1.conv_block.2", params[f"block_{b}_prelu"])
        conv(f"{p}.conv_block2.conv_block.0", params[f"block_{b}_conv2"])
        _inv_bn(sd, f"{p}.conv_block2.conv_block.1",
                params[f"block_{b}_bn2"], stats[f"block_{b}_bn2"])
    conv("conv_block2.conv_block.0", params["conv_mid"])
    _inv_bn(sd, "conv_block2.conv_block.1", params["bn_mid"],
            stats["bn_mid"])
    for i in range(2):
        p = f"subpixel_convolutional_blocks.{i}"
        conv(f"{p}.conv", params[f"subpixel_{i}"]["conv"])
        prelu(f"{p}.prelu", params[f"subpixel_{i}"]["prelu"])
    conv("conv_block3.conv_block.0", params["conv_out"])
    return sd


# ---------------------------------------------------------------------------
# Checkpoint container
# ---------------------------------------------------------------------------

def _tensors(sd: dict):
    import torch
    return {k: torch.tensor(v) for k, v in sd.items()}


def export_checkpoint(model: str, ckpt: dict, out_path: str,
                      num_downs: int = 8, n_blocks: int = 9) -> dict:
    """GCC-TPU checkpoint dict -> reference-format torch .pth.

    Emits the reference container (models/Pix2Pix.py:636-649 etc.):
    {'G' (or 'G_A'/'G_B'), optional 'D*', 'epoch', 'cfg', 'fid'|'psnr'}.
    """
    import torch

    def net(key):
        return ckpt[key]

    out: Dict = {"epoch": ckpt.get("epoch"),
                 "cfg": ckpt.get("cfg", (None, None))}
    if "pix2pix" in model:
        g = net("G")
        out["G"] = _tensors(export_unet_generator(
            g["params"], g.get("batch_stats", {}), num_downs))
        if ckpt.get("D") is not None:
            d = net("D")
            masked = bool(d.get("arch"))
            out["D"] = _tensors(export_patchgan(
                d["params"], d.get("batch_stats", {}), d.get("arch"),
                masked=masked))
        out["fid"] = ckpt.get("fid")
    elif "cyclegan" in model:
        for side in ("A", "B"):
            g = net(f"G_{side}")
            out[f"G_{side}"] = _tensors(export_mobile_resnet(
                g["params"], n_blocks))
            if ckpt.get(f"D_{side}") is not None:
                d = net(f"D_{side}")
                out[f"D_{side}"] = _tensors(export_patchgan(
                    d["params"], d.get("batch_stats", {}), d.get("arch"),
                    masked=bool(d.get("arch"))))
        out["fid"] = ckpt.get("fid")
    elif model == "sagan":
        g = net("G")
        out["G"] = _tensors(export_sagan_generator(
            g["params"], g.get("batch_stats", {}), g["spectral"]))
        if ckpt.get("D") is not None:
            d = net("D")
            out["D"] = _tensors(export_sagan_discriminator(
                d["params"], d["spectral"], d.get("arch")))
        out["fid"] = ckpt.get("fid")
    elif model == "srgan":
        g = net("G")
        out["G"] = _tensors(export_srresnet(
            g["params"], g.get("batch_stats", {})))
        if ckpt.get("D") is not None:
            # reference SRGAN.load_models defaults to load_discriminator=True
            # and indexes ckpt['D'] (SRGAN.py:593-607) — the exported ckpt
            # must carry it for the default load/fine-tune path
            d = net("D")
            out["D"] = _tensors(export_srgan_discriminator(
                d["params"], d.get("batch_stats", {}), d.get("arch")))
        out["psnr"] = ckpt.get("psnr", ckpt.get("fid"))
    else:
        raise NotImplementedError(model)
    torch.save(out, out_path)
    return out
