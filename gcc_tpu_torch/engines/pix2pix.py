"""Pix2Pix engine: conditional GAN + L1 with online distillation and a
DARTS-searched discriminator (port of gcc_tpu/engines/pix2pix.py).

One cooperative train step per iteration, in the JAX engine's exact order
of forwards (engines/pix2pix.py:148-288):
  teacher G fwd -> teacher D update -> teacher G update (features captured)
  -> student D update -> student G update (GAN + L1 + content/gram distill
  + optional L1-sparsity gradient injection)
and the arch step on a validation batch (:300-350):
  clip alphas -> teacher discrepancy EMA -> L1(student disc, EMA) + D GAN
  terms -> Adam over the mask alphas only.

Semantics kept from the JAX engine: D-then-G order; the teacher trains
online at constant LR (never scheduled); both teacher and student get the
sparsity injection; every train-mode forward moves the BatchNorm running
stats exactly where the JAX engine's does. Under normal distillation the
teacher is frozen: its targets come from eval-mode forwards that update
nothing (engines/pix2pix.py:157-168), and it has no optimizers.

Backbones: the U-Net (the default) and the MobileResnet. U-Net dropout
masks come from ``torch.Generator``s seeded from the state's ``rng``, one
seed for both student forwards of a train step and one for both teacher
forwards (the JAX engine's ``drng`` and ``tdrng``), fresh seeds in the arch
step.

Batches are NCHW tensors on the engine's device: {"A": ..., "B": ...}.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from gcc_tpu_torch.config import Config
from gcc_tpu_torch.device import configure_precision, resolve_device
from gcc_tpu_torch.engines.common import (
    Adam, CheckpointMixin, CombinedStepMixin, GANState, RowShardedMixin,
    add_sign_sparsity, arch_params, d_pair, discrepancy, distill_losses,
    ema_update, eval_mode, grads_of, weight_params,
)
from gcc_tpu_torch.losses import gan_loss, l1
from gcc_tpu_torch.models.discriminators import PatchGAN
from gcc_tpu_torch.models.generators import (
    MobileResnetGenerator, UnetGenerator, mobile_resnet_default_cfg,
)
from gcc_tpu_torch.ops.layers import Conv, init_params
from gcc_tpu_torch.ops.mask import clip_alphas
from gcc_tpu_torch.parallel.mesh import mesh_step
from gcc_tpu_torch.utils.tracing import span, spanned


class TransformConvs(nn.Module):
    """1x1 student->teacher width adapters (Pix2Pix.py:402-415), bias-free."""

    def __init__(self, in_widths: Sequence[int], out_widths: Sequence[int]):
        super().__init__()
        for i, (ci, co) in enumerate(zip(in_widths, out_widths)):
            self.add_module(f"tf_{i}", Conv(ci, co, (1, 1), use_bias=False))

    def forward(self, feats):
        return [getattr(self, f"tf_{i}")(f) for i, f in enumerate(feats)]


class Pix2PixEngine(CheckpointMixin, CombinedStepMixin, RowShardedMixin):
    """Engine surface of the JAX package's Pix2PixEngine: init_state,
    train_step, arch_step, train_arch_step, generate, checkpoint_payload,
    load_net_params. ``channel_cfgs`` (the
    U-Net's input widths) is carried, not used to build, as in JAX."""

    def __init__(self, cfg: Config, filter_cfgs=None, device=None,
                 channel_cfgs=None, mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device)
        configure_precision(self.device)  # the family's bf16 path
        self.filter_cfgs, self.channel_cfgs = filter_cfgs, channel_cfgs
        self.distill = cfg.online_distillation or cfg.normal_distillation
        self.online = cfg.online_distillation
        self.darts = cfg.darts_discriminator
        self.gan_mode = cfg.gan_mode
        self.fused_d = cfg.fused_d_batch
        self.fused_blocks = {"auto": None, "on": True,
                             "off": False}[cfg.fused_resblock]
        self.dropout = cfg.backbone != "resnet" and not cfg.no_dropout

    # ------------------------------------------------------------------ init

    def build_nets(self) -> Dict[str, nn.Module]:
        """The engine's nets with uninitialised parameters, on the CPU."""
        cfg = self.cfg
        d_in = cfg.input_nc + cfg.output_nc
        if cfg.backbone == "resnet":
            s_cfg = list(self.filter_cfgs) if self.filter_cfgs is not None \
                else mobile_resnet_default_cfg(cfg.ngf)
            g = MobileResnetGenerator(cfg.input_nc, cfg.output_nc, cfg.ngf,
                                      cfg=s_cfg,
                                      use_fused_blocks=self.fused_blocks)
            # every captured student feature has the width of down2 (residual
            # adds keep it); the teacher's are teacher_ngf * 4
            s_widths = (s_cfg[2],) * 4
        else:
            g = UnetGenerator(cfg.input_nc, cfg.output_nc, cfg.num_downs,
                              cfg.ngf, self.dropout, self.filter_cfgs,
                              self.channel_cfgs)
            s_widths = g.feature_widths
        nets = {"g": g, "d": PatchGAN(d_in, cfg.ndf, norm="batch",
                                      masked=self.darts,
                                      threshold=cfg.threshold)}
        if self.distill:
            tngf = cfg.teacher_ngf
            if cfg.backbone == "resnet":
                nets["tg"] = MobileResnetGenerator(
                    cfg.input_nc, cfg.output_nc, tngf,
                    use_fused_blocks=self.fused_blocks)
                t_widths = (tngf * 4,) * 4
            else:
                nets["tg"] = UnetGenerator(cfg.input_nc, cfg.output_nc,
                                           cfg.num_downs, tngf, self.dropout)
                t_widths = (tngf * 2, tngf * 8, tngf * 16, tngf * 4)
            nets["td"] = PatchGAN(d_in, cfg.teacher_ndf, norm="batch")
            nets["tf"] = TransformConvs(s_widths, t_widths)
        return nets

    def init_state(self, seed: int = 0) -> GANState:
        """Fresh state: parameters drawn from a CPU generator seeded with
        ``seed`` (the same numbers on every device), then moved to the
        engine's device; Adam moments at zero; EMA unset."""
        gen = torch.Generator().manual_seed(seed)
        nets = {k: init_params(v, gen).to(self.device).train()
                for k, v in self.build_nets().items()}
        return self.state_for(nets, seed)

    def state_for(self, nets: Dict[str, nn.Module], seed: int = 0
                  ) -> GANState:
        """A step-0 state around already-initialised nets; ``seed`` seeds
        the dropout masks' generator."""
        opts = {"g": Adam(self._g_bundle(nets), 0.5, 0.999),
                "d": Adam(weight_params(nets["d"]), 0.5, 0.999)}
        if self.online:
            opts["td"] = Adam(weight_params(nets["td"]), 0.5, 0.999)
            opts["tg"] = Adam(weight_params(nets["tg"]), 0.5, 0.999)
        if self.darts:
            opts["arch"] = Adam(arch_params(nets["d"]), 0.9, 0.999)
        ema = {"d_arch": torch.zeros((), device=self.device)}
        return GANState(step=0, nets=nets, opts=opts, ema=ema,
                        rng=torch.Generator().manual_seed(seed))

    def _g_bundle(self, nets):
        """The student G update's parameters: G, plus the transforms when
        distilling (one Adam state, as the JAX bundle {'g', 'tf'})."""
        bundle = weight_params(nets["g"])
        if self.distill:
            bundle += weight_params(nets["tf"])
        return bundle

    def _masks(self, state: GANState):
        """A dropout-mask source for one net's forwards, from a seed drawn
        from the state's rng: call it for each forward that must draw the
        same masks (None without dropout)."""
        if not self.dropout:
            return lambda: None
        seed = int(torch.randint(2 ** 62, (), generator=state.rng))
        return lambda: torch.Generator(device=self.device).manual_seed(seed)

    # ------------------------------------------------------------- train step

    @mesh_step
    def train_step(self, state: GANState, batch: Dict[str, torch.Tensor],
                   lr: float) -> Tuple[GANState, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        A, B = batch["A"], batch["B"]
        nets, opts = state.nets, state.opts
        G, D = nets["g"], nets["d"]
        m: Dict[str, torch.Tensor] = {}
        AB = torch.cat([A, B], 1)

        masks, t_masks = self._masks(state), self._masks(state)

        if self.distill and not self.online:
            # normal_distillation: frozen teacher, forward-only targets
            with span("gcc.teacher_g"), torch.no_grad(), \
                    eval_mode(nets["tg"], nets["td"]):
                tfake, tg_feats = nets["tg"](A)
                _, td_feats = nets["td"](torch.cat([A, tfake], 1))
            target_feats = tg_feats + td_feats
        if self.online:
            TG, TD = nets["tg"], nets["td"]
            # ---- teacher D update (D-then-G order, Pix2Pix.py:565-583),
            # after the teacher forward that makes its tfake ----
            with span("gcc.teacher_d"):
                with torch.no_grad():
                    tfake, _ = TG(A, t_masks(), update_stats=False)
                pf, pr, _ = d_pair(TD, torch.cat([A, tfake], 1), AB,
                                   self.fused_d)
                loss = (gan_loss(pf, False, self.gan_mode)
                        + gan_loss(pr, True, self.gan_mode)) * 0.5
                td_params = weight_params(TD)
                opts["td"].step(td_params, grads_of(loss, td_params),
                                cfg.lr)  # teacher LR is never scheduled

            # ---- teacher G update; capture distillation targets ----
            with span("gcc.teacher_g"):
                tfake2, tg_feats = TG(A, t_masks())
                pf, td_feats = TD(torch.cat([A, tfake2], 1))
                loss = gan_loss(pf, True, self.gan_mode,
                                for_discriminator=False) \
                    + cfg.lambda_L1 * l1(tfake2, B)
                tg_params = weight_params(TG)
                # the TEACHER gets the sparsity injection too
                # (train.py:93-98, Pix2Pix.py:552)
                gtg = add_sign_sparsity(TG, tg_params,
                                        grads_of(loss, tg_params),
                                        cfg.lambda_weight, cfg.lambda_scale)
                opts["tg"].step(tg_params, gtg, cfg.lr)
                target_feats = [f.detach() for f in tg_feats + td_feats]

        # ---- student D update (alphas are constants here), after the
        # student forward that makes its fake ----
        with span("gcc.student_d"):
            with torch.no_grad():
                fake, _ = G(A, masks(), update_stats=False)
            pf, pr, _ = d_pair(D, torch.cat([A, fake], 1), AB, self.fused_d)
            lf = gan_loss(pf, False, self.gan_mode)
            lr_ = gan_loss(pr, True, self.gan_mode)
            d_params = weight_params(D)
            opts["d"].step(d_params, grads_of((lf + lr_) * 0.5, d_params),
                           lr)
            m["D_fake"], m["D_real"] = lf.detach(), lr_.detach()

        # ---- student G update ----
        with span("gcc.student_g"):
            fake2, g_feats = G(A, masks())
            pf, _ = D(torch.cat([A, fake2], 1))
            l_gan = gan_loss(pf, True, self.gan_mode,
                             for_discriminator=False)
            l_l1 = cfg.lambda_L1 * l1(fake2, B)
            loss = l_gan + l_l1
            m["G_GAN"], m["G_L1"] = l_gan.detach(), l_l1.detach()
            if self.distill:
                transformed = nets["tf"](g_feats)
                _, sd_feats = nets["td"](torch.cat([A, fake2], 1))
                content, gram_l = distill_losses(transformed + sd_feats,
                                                 target_feats, use_sqrt=True)
                m["content"] = cfg.lambda_content * content.detach()
                m["gram"] = cfg.lambda_gram * gram_l.detach()
                loss = loss + cfg.lambda_content * content \
                    + cfg.lambda_gram * gram_l
            bundle = self._g_bundle(nets)
            gg = grads_of(loss, bundle)
            n_g = len(weight_params(G))
            gg[:n_g] = add_sign_sparsity(G, bundle[:n_g], gg[:n_g],
                                         cfg.lambda_weight, cfg.lambda_scale)
            opts["g"].step(bundle, gg, lr)

        state.step += 1
        return state, m

    # -------------------------------------------------------------- arch step

    @spanned("gcc.arch")
    @mesh_step
    def arch_step(self, state: GANState, batch: Dict[str, torch.Tensor],
                  ema_beta: float, arch_lr: Optional[float] = None
                  ) -> Tuple[GANState, Dict[str, torch.Tensor]]:
        """clipping_mask_alpha + optimizer_netD_arch on a val batch
        (train.py:147-151, Pix2Pix.py:479-511, 585-593)."""
        if arch_lr is None:
            arch_lr = self.cfg.arch_lr
        A, B = batch["A"], batch["B"]
        nets = state.nets
        D, TD = nets["d"], nets["td"]
        AB = torch.cat([A, B], 1)
        alphas = arch_params(D)
        clip_alphas(alphas)

        with torch.no_grad():
            # student + teacher generator forwards (train mode, stats
            # updated, fresh dropout masks)
            fake, _ = nets["g"](A, self._masks(state)())
            tfake, _ = nets["tg"](A, self._masks(state)())
            # teacher discrepancy EMA (Pix2Pix.py:489-511); both TD
            # forwards move its running stats
            tpf, _ = TD(torch.cat([A, tfake], 1))
            TD(AB)
            t_disc = discrepancy(tpf, self.gan_mode)
            state.ema["d_arch"] = ema_update(state.ema["d_arch"], t_disc,
                                             ema_beta)
        target = state.ema["d_arch"]

        pf, _ = D(torch.cat([A, fake], 1))
        s_disc = discrepancy(pf, self.gan_mode)
        pr, _ = D(AB)
        l_fake = gan_loss(pf, False, self.gan_mode)
        l_real = gan_loss(pr, True, self.gan_mode)
        loss = torch.abs(s_disc - target) + (l_real + l_fake) * 0.5
        state.opts["arch"].step(alphas, grads_of(loss, alphas), arch_lr)

        return state, {"D_arch": loss.detach(), "D_arch_diff": s_disc.detach(),
                       "teacher_D_arch_diff": target.clone()}

    # ------------------------------------------------------------------ eval

    @torch.no_grad()
    def generate(self, state: GANState, A: torch.Tensor,
                 teacher: bool = False) -> torch.Tensor:
        """Eval-mode forward of the student (or teacher) generator."""
        with eval_mode(state.nets["tg" if teacher else "g"]) as (net,):
            return net(A)[0]
