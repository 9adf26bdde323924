"""SAGAN engine: hinge-loss self-attention GAN with TTUR, online distillation
and a DARTS-searched discriminator (port of gcc_tpu/engines/sagan.py;
models/SAGAN.py:279-755).

One cooperative train step per iteration, in the JAX engine's order of
forwards (engines/sagan.py:141-279):
  teacher G fwd -> teacher D update (real, then fake) -> teacher G update
  (features captured) -> student G fwd -> student D update (real, then fake)
  -> student G update (GAN + content/gram distill + L1 to the teacher fake
  + optional L1-sparsity gradient injection)
and the arch step on a validation batch (:289-330): clip alphas -> G and
teacher G forwards -> teacher discrepancy EMA -> |student disc - EMA| + the
unhalved D GAN terms -> Adam over the mask alphas only.

Under normal distillation the teacher is frozen: its targets come from
eval-mode forwards that update nothing (engines/sagan.py:150-160), and it
has no optimizers.

Semantics kept from the JAX engine: Adam betas (0, 0.9); D learning rate 4x
the G rate (the teacher D at the constant cfg.lr * 4, the student D at the
scheduled lr * 4); the student G bundle {g, tf} and the masked D step their
spectral and q/k/v convs twice (``DupAdam``); the teacher's Adams are
single. Every train-mode forward with ``update_stats`` moves the spectral
vectors and BatchNorm running stats exactly where the JAX engine's does.

Batches are {"z": (B, z_dim), "real_img": (B, 3, 64, 64)} tensors, NCHW, on
the engine's device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from gcc_tpu_torch.config import Config
from gcc_tpu_torch.device import resolve_device
from gcc_tpu_torch.engines.common import (
    Adam, CheckpointMixin, CombinedStepMixin, DupAdam, GANState,
    add_sign_sparsity, arch_params, d_pair, discrepancy, distill_losses,
    ema_update, eval_mode, grads_of, weight_params,
)
from gcc_tpu_torch.engines.pix2pix import TransformConvs
from gcc_tpu_torch.losses import gan_loss, l1
from gcc_tpu_torch.models.discriminators import SAGANDiscriminator
from gcc_tpu_torch.models.generators import (
    SAGANGenerator, sagan_default_filter_cfgs,
)
from gcc_tpu_torch.ops.layers import init_params
from gcc_tpu_torch.ops.mask import clip_alphas

_DUP_SEGMENTS = ("l1", "l2", "l3", "l4", "query_conv", "key_conv",
                 "value_conv")


def ref_dup_param(name: str) -> bool:
    """True for the parameters the reference adds twice to the student
    optimizer group (engines/sagan.py:85-95): the spectral stage convs l1-l4
    and the attention q/k/v convs, at any depth."""
    return any(s in _DUP_SEGMENTS for s in name.split("."))


def _dup_flags(*nets: nn.Module) -> list:
    """ref_dup_param of each of weight_params(net) for net in nets, in order."""
    return [ref_dup_param(n) for net in nets
            for n, _ in net.named_parameters() if not n.endswith("alpha")]


class SAGANEngine(CheckpointMixin, CombinedStepMixin):
    """Engine surface of the JAX package's SAGANEngine: build_nets,
    init_state, state_for, train_step, arch_step, train_arch_step, generate,
    checkpoint_payload, load_net_params."""

    def __init__(self, cfg: Config, filter_cfgs=None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.filter_cfgs = filter_cfgs
        self.distill = cfg.online_distillation or cfg.normal_distillation
        self.online = cfg.online_distillation
        self.darts = cfg.darts_discriminator
        self.gan_mode = cfg.gan_mode
        self.fused_d = cfg.fused_d_batch

    # ------------------------------------------------------------------ init

    def build_nets(self) -> Dict[str, nn.Module]:
        """The engine's nets with uninitialised parameters, on the CPU."""
        cfg = self.cfg
        thr = cfg.pallas_attn_threshold
        f = list(self.filter_cfgs) if self.filter_cfgs is not None \
            else sagan_default_filter_cfgs(cfg.ngf, cfg.crop_size)
        nets = {
            "g": SAGANGenerator(cfg.ngf, cfg.crop_size, cfg.z_dim, f, thr),
            "d": SAGANDiscriminator(cfg.ndf, masked=self.darts,
                                    threshold=cfg.threshold,
                                    attn_threshold=thr),
        }
        if self.distill:
            nets["tg"] = SAGANGenerator(cfg.teacher_ngf, cfg.crop_size,
                                        cfg.z_dim, attn_threshold=thr)
            nets["td"] = SAGANDiscriminator(cfg.teacher_ndf,
                                            attn_threshold=thr)
            nets["tf"] = TransformConvs((f[1], f[3]), (cfg.teacher_ngf * 4,
                                                       cfg.teacher_ngf))
        return nets

    def init_state(self, seed: int = 0) -> GANState:
        """Fresh state: parameters and spectral vectors drawn from a CPU
        generator seeded with ``seed`` (the same numbers on every device),
        then moved to the engine's device; Adam moments at zero; EMA unset."""
        gen = torch.Generator().manual_seed(seed)
        nets = {k: init_params(v, gen).to(self.device).train()
                for k, v in self.build_nets().items()}
        return self.state_for(nets)

    def state_for(self, nets: Dict[str, nn.Module]) -> GANState:
        """A step-0 state around already-initialised nets."""
        opts = {}
        if self.online:
            opts["td"] = Adam(weight_params(nets["td"]), 0.0, 0.9)
            opts["tg"] = Adam(weight_params(nets["tg"]), 0.0, 0.9)
        if self.distill:
            # duplicate-scan branch (SAGAN.py:315-327)
            opts["g"] = DupAdam(self._g_bundle(nets),
                                _dup_flags(nets["g"], nets["tf"]), 0.0, 0.9)
        else:  # plain netG.parameters() (SAGAN.py:302)
            opts["g"] = Adam(self._g_bundle(nets), 0.0, 0.9)
        if self.darts:  # duplicate-scan branch (SAGAN.py:339-346)
            opts["d"] = DupAdam(weight_params(nets["d"]),
                                _dup_flags(nets["d"]), 0.0, 0.9)
            opts["arch"] = Adam(arch_params(nets["d"]), 0.9, 0.999)
        else:  # plain netD.parameters() (SAGAN.py:356)
            opts["d"] = Adam(weight_params(nets["d"]), 0.0, 0.9)
        ema = {"d_arch": torch.zeros((), device=self.device)}
        return GANState(step=0, nets=nets, opts=opts, ema=ema)

    def _g_bundle(self, nets):
        """The student G update's parameters: G, plus the transforms when
        distilling (one optimizer state, as the JAX bundle {'g', 'tf'})."""
        bundle = weight_params(nets["g"])
        if self.distill:
            bundle += weight_params(nets["tf"])
        return bundle

    # ------------------------------------------------------------- train step

    def train_step(self, state: GANState, batch: Dict[str, torch.Tensor],
                   lr: float) -> Tuple[GANState, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        z, real = batch["z"], batch["real_img"]
        nets, opts = state.nets, state.opts
        G, D = nets["g"], nets["d"]
        m: Dict[str, torch.Tensor] = {}

        if self.distill and not self.online:
            # normal_distillation: frozen teacher, forward-only targets
            with torch.no_grad(), eval_mode(nets["tg"], nets["td"]):
                tfake, tg_feats = nets["tg"](z)
                _, td_feats = nets["td"](tfake)
            target_feats = tg_feats + td_feats
        if self.online:
            TG, TD = nets["tg"], nets["td"]
            with torch.no_grad():
                tfake0, _ = TG(z, update_stats=False)

            # ---- teacher D update: real first (SAGAN.py:379), TTUR ----
            pr, pf, _ = d_pair(TD, real, tfake0, self.fused_d)
            loss = gan_loss(pf, False, self.gan_mode) \
                + gan_loss(pr, True, self.gan_mode)
            td_params = weight_params(TD)
            opts["td"].step(td_params, grads_of(loss, td_params),
                            cfg.lr * 4)  # teacher LR is never scheduled

            # ---- teacher G update; capture distillation targets ----
            tfake, tg_feats = TG(z)
            pf, td_feats = TD(tfake)
            loss = gan_loss(pf, True, self.gan_mode, for_discriminator=False)
            tg_params = weight_params(TG)
            # the TEACHER gets the sparsity injection too (train.py:93-98,
            # SAGAN.py:494-496)
            gtg = add_sign_sparsity(TG, tg_params, grads_of(loss, tg_params),
                                    cfg.lambda_weight, cfg.lambda_scale)
            opts["tg"].step(tg_params, gtg, cfg.lr)
            target_feats = [f.detach() for f in tg_feats + td_feats]
            tfake = tfake.detach()

        # ---- student D update (alphas are constants here) ----
        with torch.no_grad():
            fake, _ = G(z, update_stats=False)
        pr, pf, _ = d_pair(D, real, fake, self.fused_d)
        lf = gan_loss(pf, False, self.gan_mode)
        lr_ = gan_loss(pr, True, self.gan_mode)
        d_params = weight_params(D)
        opts["d"].step(d_params, grads_of(lf + lr_, d_params), lr * 4)
        m["D_fake"], m["D_real"] = lf.detach(), lr_.detach()

        # ---- student G update ----
        fake2, g_feats = G(z)
        pf, _ = D(fake2)
        l_gan = gan_loss(pf, True, self.gan_mode, for_discriminator=False)
        loss = l_gan
        m["G_GAN"] = l_gan.detach()
        if self.distill:
            transformed = nets["tf"](g_feats)
            _, sd_feats = nets["td"](fake2)
            content, gram_l = distill_losses(transformed + sd_feats,
                                             target_feats, use_sqrt=True)
            l_l1 = cfg.lambda_L1 * l1(fake2, tfake)
            loss = loss + cfg.lambda_content * content \
                + cfg.lambda_gram * gram_l + l_l1
            m["content"] = cfg.lambda_content * content.detach()
            m["gram"] = cfg.lambda_gram * gram_l.detach()
            m["L1"] = l_l1.detach()
        bundle = self._g_bundle(nets)
        gg = grads_of(loss, bundle)
        n_g = len(weight_params(G))
        gg[:n_g] = add_sign_sparsity(G, bundle[:n_g], gg[:n_g],
                                     cfg.lambda_weight, cfg.lambda_scale)
        opts["g"].step(bundle, gg, lr)

        state.step += 1
        return state, m

    # -------------------------------------------------------------- arch step

    def arch_step(self, state: GANState, batch: Dict[str, torch.Tensor],
                  ema_beta: float, arch_lr: Optional[float] = None
                  ) -> Tuple[GANState, Dict[str, torch.Tensor]]:
        """clipping_mask_alpha + optimizer_netD_arch on a val batch
        (SAGAN.py:388-395; engines/sagan.py:289-330)."""
        if arch_lr is None:
            arch_lr = self.cfg.arch_lr
        z, real = batch["z"], batch["real_img"]
        nets = state.nets
        D, TD = nets["d"], nets["td"]
        alphas = arch_params(D)
        clip_alphas(alphas)

        with torch.no_grad():
            # train-mode G and teacher G forwards: both move their state
            fake, _ = nets["g"](z)
            tfake, _ = nets["tg"](z)
            tpf, _ = TD(tfake)
            TD(real)
            t_disc = discrepancy(tpf, self.gan_mode)
            state.ema["d_arch"] = ema_update(state.ema["d_arch"], t_disc,
                                             ema_beta)
        target = state.ema["d_arch"]

        pf, _ = D(fake)
        s_disc = discrepancy(pf, self.gan_mode)
        pr, _ = D(real)
        l_fake = gan_loss(pf, False, self.gan_mode)
        l_real = gan_loss(pr, True, self.gan_mode)
        loss = torch.abs(s_disc - target) + l_real + l_fake  # unhalved
        state.opts["arch"].step(alphas, grads_of(loss, alphas), arch_lr)

        return state, {"D_arch": loss.detach(), "D_arch_diff": s_disc.detach(),
                       "teacher_D_arch_diff": target.clone()}

    # ------------------------------------------------------------------ eval

    @torch.no_grad()
    def generate(self, state: GANState, z: torch.Tensor,
                 teacher: bool = False) -> torch.Tensor:
        """Eval-mode forward of the student (or teacher) generator: running
        BatchNorm stats, spectral vectors iterated but not stored."""
        with eval_mode(state.nets["tg" if teacher else "g"]) as (net,):
            return net(z)[0]
