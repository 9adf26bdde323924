"""SRGAN engine: SRResNet + VGG-perceptual GAN for 4x super-resolution with
online distillation and a DARTS-searched discriminator (port of
gcc_tpu/engines/srgan.py; models/SRGAN.py:297-831).

One cooperative train step per iteration, in the JAX engine's order
(engines/srgan.py:160-312):
  teacher G fwd -> teacher G update (content + adversarial + perceptual,
  features captured) -> teacher D update (real, then the pre-update teacher
  fake; its features are the D targets) -> student G update (content +
  adversarial + perceptual, sqrt-MSE content/gram distillation against
  the transformed G features and the teacher-D features of the student
  fake, L1 to the teacher fake) -> student D update, unhalved.
``--generator_only`` replaces it with the content step: MSE to the high
resolution image plus the sparsity injection (:147-166). The arch step
(:316-354) is pix2pix's with imagenet-normalised images and unhalved D
terms.

Semantics kept from the JAX engine: the GAN, VGG and D terms see
imagenet-normalised images (the reference mutates its tensors in place,
SRGAN.py:442-454); Adam (0.9, 0.999) everywhere, the teacher at constant
LR; no sparsity on the GAN path; every parameter of G trains, PReLU
included (the documented deviation of engines/srgan.py:22-25); every
train-mode forward moves the BatchNorm running stats where the JAX
engine's does. Without VGG19 weights (``--vgg_path``) the perceptual term
is off, loudly: random-feature perceptual loss is another algorithm.

Batches are {"lr": (B, 3, h, w), "hr": (B, 3, 4h, 4w)} NCHW tensors on the
engine's device; "lr" is imagenet-normalised, "hr" in [-1, 1].
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from gcc_tpu_torch.config import Config
from gcc_tpu_torch.device import resolve_device
from gcc_tpu_torch.engines.common import (
    Adam, CheckpointMixin, CombinedStepMixin, GANState, add_sign_sparsity,
    arch_params, d_pair, discrepancy, distill_losses, ema_update, eval_mode,
    grads_of, weight_params,
)
from gcc_tpu_torch.engines.pix2pix import TransformConvs
from gcc_tpu_torch.losses import gan_loss, l1, mse
from gcc_tpu_torch.metrics.vgg import (
    TruncatedVGG19, load_torch_vgg19, to_imagenet_norm,
)
from gcc_tpu_torch.models.discriminators import SRGANDiscriminator
from gcc_tpu_torch.models.generators import SRResNet
from gcc_tpu_torch.ops.layers import init_params
from gcc_tpu_torch.ops.mask import clip_alphas
from gcc_tpu_torch.utils.weights import load_jax_variables


class SRGANEngine(CheckpointMixin, CombinedStepMixin):
    """Engine surface of the JAX package's SRGANEngine: build_nets,
    init_state, state_for, train_step (the content step under
    --generator_only), arch_step, train_arch_step, generate,
    checkpoint_payload, load_net_params. ``vgg_params`` is the JAX-layout
    VGG19 tree (``metrics.vgg.load_torch_vgg19``); None reads
    ``cfg.vgg_path``."""

    visual_names = ["real_lr", "fake_hr", "real_hr"]

    def __init__(self, cfg: Config, filter_cfgs=None, device=None,
                 vgg_params: Optional[dict] = None, channel_cfgs=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.filter_cfgs, self.channel_cfgs = filter_cfgs, channel_cfgs
        self.distill = cfg.online_distillation or cfg.normal_distillation
        self.online = cfg.online_distillation
        self.darts = cfg.darts_discriminator
        self.gan_mode = cfg.gan_mode
        self.fused_d = cfg.fused_d_batch
        self.generator_only = cfg.generator_only
        if vgg_params is None and cfg.vgg_path:
            vgg_params = load_torch_vgg19(cfg.vgg_path)
        self.vgg = None
        if vgg_params is not None:
            self.vgg = TruncatedVGG19()
            load_jax_variables(self.vgg, {"params": vgg_params})
            self.vgg.to(self.device).eval().requires_grad_(False)
        elif cfg.lambda_SR_perceptual:
            logging.getLogger("gcc-tpu-torch").warning(
                "SRGAN perceptual loss DISABLED: no pretrained VGG19 weights "
                "(--vgg_path). The reference uses torchvision's pretrained "
                "VGG19(5,4); training proceeds with content+adversarial only.")

    # ------------------------------------------------------------------ init

    def build_nets(self) -> Dict[str, nn.Module]:
        """The engine's nets with uninitialised parameters, on the CPU."""
        cfg = self.cfg
        nets = {"g": SRResNet(cfg.ngf, scaling_factor=cfg.upscale_factor,
                              filter_cfgs=self.filter_cfgs),
                "d": SRGANDiscriminator(cfg.ndf, masked=self.darts,
                                        threshold=cfg.threshold)}
        if self.distill:
            nets["tg"] = SRResNet(cfg.teacher_ngf,
                                  scaling_factor=cfg.upscale_factor)
            nets["td"] = SRGANDiscriminator(cfg.teacher_ndf)
            # the captured block outputs have the trunk's width
            nets["tf"] = TransformConvs((cfg.ngf,) * 4,
                                        (cfg.teacher_ngf,) * 4)
        return nets

    def init_state(self, seed: int = 0) -> GANState:
        """Fresh state: parameters drawn from a CPU generator seeded with
        ``seed``, then moved to the engine's device; Adam moments at zero;
        EMA unset."""
        gen = torch.Generator().manual_seed(seed)
        nets = {k: init_params(v, gen).to(self.device).train()
                for k, v in self.build_nets().items()}
        return self.state_for(nets, seed)

    def state_for(self, nets: Dict[str, nn.Module], seed: int = 0
                  ) -> GANState:
        """A step-0 state around already-initialised nets."""
        bundle = weight_params(nets["g"])
        if self.distill:
            bundle += weight_params(nets["tf"])
        opts = {"g": Adam(bundle, 0.9, 0.999),
                "d": Adam(weight_params(nets["d"]), 0.9, 0.999)}
        if self.online:
            opts["td"] = Adam(weight_params(nets["td"]), 0.9, 0.999)
            opts["tg"] = Adam(weight_params(nets["tg"]), 0.9, 0.999)
        if self.darts:
            opts["arch"] = Adam(arch_params(nets["d"]), 0.9, 0.999)
        ema = {"d_arch": torch.zeros((), device=self.device)}
        return GANState(step=0, nets=nets, opts=opts, ema=ema)

    # ------------------------------------------------------------- train step

    def _perceptual(self, fake_in: torch.Tensor,
                    real_in: torch.Tensor) -> torch.Tensor:
        """MSE in VGG19(5,4) space, the real side a constant; 0 without
        weights."""
        if self.vgg is None:
            return fake_in.new_zeros(())
        with torch.no_grad():
            target = self.vgg(real_in)
        return mse(self.vgg(fake_in), target)

    def train_step(self, state: GANState, batch: Dict[str, torch.Tensor],
                   lr: float) -> Tuple[GANState, Dict[str, torch.Tensor]]:
        if self.generator_only:
            return self._content_step(state, batch, lr)
        return self._gan_step(state, batch, lr)

    def _content_step(self, state, batch, lr):
        """optimize_content_parameters: MSE-only pretraining with the
        sparsity injection (SRGAN.py:514-522)."""
        cfg = self.cfg
        G = state.nets["g"]
        fake, _ = G(batch["lr"])
        loss = mse(fake, batch["hr"])
        params = weight_params(G)
        grads = add_sign_sparsity(G, params, grads_of(loss, params),
                                  cfg.lambda_weight, cfg.lambda_scale)
        state.opts["g"].step(params, grads, lr)
        state.step += 1
        return state, {"content": loss.detach()}

    def _gan_step(self, state, batch, lr):
        cfg = self.cfg
        lr_img, hr = batch["lr"], batch["hr"]
        real_in = to_imagenet_norm(hr)
        nets, opts, gm = state.nets, state.opts, self.gan_mode
        G, D = nets["g"], nets["d"]
        m: Dict[str, torch.Tensor] = {}

        if self.distill and not self.online:
            # normal_distillation: frozen teacher, forward-only targets
            with torch.no_grad(), eval_mode(nets["tg"], nets["td"]):
                tfake, tg_feats = nets["tg"](lr_img)
                t_fake_in = to_imagenet_norm(tfake)
                _, td_feats = nets["td"](t_fake_in)
            targets = tg_feats + td_feats
        if self.online:
            TG, TD = nets["tg"], nets["td"]
            with torch.no_grad():
                tfake, _ = TG(lr_img, update_stats=False)
                t_fake_in = to_imagenet_norm(tfake)

            # ---- teacher G update (G-then-D order) ----
            tfake2, tg_feats = TG(lr_img)
            fake_in2 = to_imagenet_norm(tfake2)
            pf, _ = TD(fake_in2)
            loss = cfg.lambda_SR_content * mse(tfake2, hr) \
                + cfg.lambda_SR_adversarial * gan_loss(
                    pf, True, gm, for_discriminator=False) \
                + cfg.lambda_SR_perceptual * self._perceptual(fake_in2,
                                                              real_in)
            tg_params = weight_params(TG)
            opts["tg"].step(tg_params, grads_of(loss, tg_params), cfg.lr)

            # ---- teacher D update; the pre-update teacher fake's features
            # are the D targets (SRGAN.py:397-405) ----
            pr, pf, td_feats = d_pair(TD, real_in, t_fake_in, self.fused_d)
            loss = gan_loss(pr, True, gm) + gan_loss(pf, False, gm)
            td_params = weight_params(TD)
            opts["td"].step(td_params, grads_of(loss, td_params), cfg.lr)
            targets = [f.detach() for f in tg_feats + td_feats]

        # ---- student G update (first: G-then-D, SRGAN.py:483-502) ----
        fake, g_feats = G(lr_img)
        fake_in = to_imagenet_norm(fake)
        pf, _ = D(fake_in)
        aux = {"content": cfg.lambda_SR_content * mse(fake, hr),
               "G_GAN": cfg.lambda_SR_adversarial * gan_loss(
                   pf, True, gm, for_discriminator=False),
               "perceptual": cfg.lambda_SR_perceptual * self._perceptual(
                   fake_in, real_in)}
        loss = aux["content"] + aux["G_GAN"] + aux["perceptual"]
        if self.distill:
            transformed = nets["tf"](g_feats)
            # not detached: the teacher D's features of the student fake
            # carry gradient here (SRGAN.py:462-470)
            _, sd_feats = nets["td"](fake_in)
            content, gram_l = distill_losses(transformed + sd_feats, targets,
                                             use_sqrt=True)
            aux["distill_content"] = cfg.lambda_content * content
            aux["gram"] = cfg.lambda_gram * gram_l
            aux["L1"] = cfg.lambda_L1 * l1(fake_in, t_fake_in)
            loss = loss + aux["distill_content"] + aux["gram"] + aux["L1"]
        bundle = weight_params(G)
        if self.distill:
            bundle += weight_params(nets["tf"])
        # no sparsity on the GAN path: backward_G does not call L1_sparsity
        # (SRGAN.py:442-481)
        opts["g"].step(bundle, grads_of(loss, bundle), lr)
        m.update({k: v.detach() for k, v in aux.items()})

        # ---- student D update, unhalved ----
        pr, pf, _ = d_pair(D, real_in, fake_in.detach(), self.fused_d)
        lf = gan_loss(pf, False, gm)
        lr_ = gan_loss(pr, True, gm)
        d_params = weight_params(D)
        opts["d"].step(d_params, grads_of(lf + lr_, d_params), lr)
        m["D_fake"], m["D_real"] = lf.detach(), lr_.detach()

        state.step += 1
        return state, m

    # -------------------------------------------------------------- arch step

    def arch_step(self, state: GANState, batch: Dict[str, torch.Tensor],
                  ema_beta: float, arch_lr: Optional[float] = None
                  ) -> Tuple[GANState, Dict[str, torch.Tensor]]:
        """clipping_mask_alpha + optimizer_netD_arch on a val batch
        (engines/srgan.py:316-354)."""
        if arch_lr is None:
            arch_lr = self.cfg.arch_lr
        lr_img, hr = batch["lr"], batch["hr"]
        real_in = to_imagenet_norm(hr)
        nets, gm = state.nets, self.gan_mode
        D, TD = nets["d"], nets["td"]
        alphas = arch_params(D)
        clip_alphas(alphas)

        with torch.no_grad():
            # student + teacher forwards (train mode, stats updated)
            fake_in = to_imagenet_norm(nets["g"](lr_img)[0])
            t_fake_in = to_imagenet_norm(nets["tg"](lr_img)[0])
            tpf, _ = TD(t_fake_in)
            TD(real_in)
            state.ema["d_arch"] = ema_update(state.ema["d_arch"],
                                             discrepancy(tpf, gm), ema_beta)
        target = state.ema["d_arch"]

        pf, _ = D(fake_in)
        s_disc = discrepancy(pf, gm)
        pr, _ = D(real_in)
        loss = torch.abs(s_disc - target) + gan_loss(pr, True, gm) \
            + gan_loss(pf, False, gm)
        state.opts["arch"].step(alphas, grads_of(loss, alphas), arch_lr)
        return state, {"D_arch": loss.detach(), "D_arch_diff": s_disc.detach(),
                       "teacher_D_arch_diff": target.clone()}

    # ------------------------------------------------------------------ eval

    @torch.no_grad()
    def generate(self, state: GANState, lr_img: torch.Tensor,
                 teacher: bool = False) -> torch.Tensor:
        """Eval-mode forward of the student (or teacher) generator."""
        with eval_mode(state.nets["tg" if teacher else "g"]) as (net,):
            return net(lr_img)[0]

    # ------------------------------------------------------------- checkpoint

    def checkpoint_payload(self, state: GANState, epoch: int,
                           metric=None) -> dict:
        """G and D in the JAX layout, the epoch, cfg and the metric under
        'psnr' (engines/srgan.py:370-372)."""
        payload = super().checkpoint_payload(state, epoch, metric)
        payload["psnr"] = payload.pop("fid")
        return payload


def lottery_transplant(pruned_params: dict, full_params: dict,
                       filter_cfgs: Sequence[int], scores) -> dict:
    """Lottery-ticket warm start on JAX-layout parameter trees (port of
    gcc_tpu/engines/srgan.py:386-421): each pruned block keeps the full
    checkpoint's weights of its highest-scoring inner channels; every other
    layer is copied whole. ``scores`` are the per-block channel scores the
    prune used."""
    out = {k: v for k, v in pruned_params.items()}

    def order(s, k):
        return np.argsort(-np.asarray(s))[:k]

    for name, sub in full_params.items():
        if name not in out:
            continue
        if name.startswith("block_") and name.endswith("_conv1"):
            b = int(name.split("_")[1])
            keep = order(scores[b], np.asarray(out[name]["kernel"]).shape[-1])
            out[name] = {"kernel": np.asarray(sub["kernel"])[..., keep],
                         "bias": np.asarray(sub["bias"])[keep]}
        elif name.startswith("block_") and name.endswith("_conv2"):
            b = int(name.split("_")[1])
            keep = order(scores[b], np.asarray(out[name]["kernel"]).shape[-2])
            out[name] = {"kernel": np.asarray(sub["kernel"])[:, :, keep, :],
                         "bias": np.asarray(sub["bias"])}
        elif name.startswith("block_") and "_bn1" in name:
            b = int(name.split("_")[1])
            keep = order(scores[b], np.asarray(out[name]["scale"]).shape[0])
            out[name] = {k: np.asarray(v)[keep] for k, v in sub.items()}
        else:
            out[name] = _copy_tree(sub)
    return out


def _copy_tree(tree):
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    return np.array(tree)
