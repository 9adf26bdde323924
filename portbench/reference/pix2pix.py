"""The GCC pix2pix cooperative iteration in plain PyTorch (SJLeo/GCC
train.py:144-151, models/Pix2Pix.py:460-593), in the order of forwards the
port's engine keeps: teacher D update, teacher G update (its features and
the updated teacher D's are the distillation targets), student D update,
student G update (hinge, L1, sqrt-MSE content and gram through the 1x1
transforms and the teacher D), then the DARTS arch step on a validation
batch (alphas clipped, the teacher discrepancy's EMA, |student
discrepancy - EMA| + the D terms, Adam over the alphas alone).

A U-Net forward that needs no gradient and the one that follows it with
a gradient draw the same dropout masks (the reference's single forward,
reused). Frozen copy of the repository's benchmarks/torch_ref.py,
rewritten as functions of parameter dicts, with the port's net names.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.reference import gan, nets as N

BETA1, ARCH_BETA1 = 0.5, 0.9


def specs(cfg: dict) -> Dict[str, dict]:
    """Every net's parameter spec: student G and its masked D, teacher G
    and D, the transforms."""
    h, st = cfg["hyper"], cfg["student"]
    n, fc = h["num_downs"], st["filter_cfgs"]
    t_cfgs = N.unet_default_cfgs(h["teacher_ngf"], n)
    s_widths = N.unet_plan(fc, n)[3]
    t_ngf = h["teacher_ngf"]
    return {"g": N.unet_spec(fc, n),
            "d": N.patchgan_spec(6, h["ndf"], True, "batch"),
            "tg": N.unet_spec(t_cfgs, n),
            "td": N.patchgan_spec(6, h["teacher_ndf"], False, "batch"),
            "tf": N.transforms_spec(s_widths, (t_ngf * 2, t_ngf * 8,
                                               t_ngf * 16, t_ngf * 4))}


def optimizer_leaves(spec: Dict[str, dict]) -> Dict[str, list]:
    """Each optimizer's leaves: the student G with the transforms, the
    student D's weights, the teachers', and the student D's alphas."""
    def weights(net):
        return [(net, k) for k in spec[net] if not k.endswith("alpha")]
    return {"g": weights("g") + weights("tf"), "d": weights("d"),
            "td": weights("td"), "tg": weights("tg"),
            "arch": [("d", k) for k in spec["d"] if k.endswith("alpha")]}


def student(cfg: dict, P, x, prec):
    """The pruned student in eval mode (no dropout, running statistics)."""
    h = cfg["hyper"]
    return N.unet(P, x, cfg["student"]["filter_cfgs"], h["num_downs"], prec,
                  train=False)[0]


class Iteration:
    """The cooperative iteration's state (parameters, five Adams, the EMA,
    the masks' seeds) and one iteration a call."""

    def __init__(self, cfg: dict, weights: Dict[str, Dict[str, torch.Tensor]],
                 seed: int, prec, device):
        h = cfg["hyper"]
        self.h, self.prec, self.device = h, prec, torch.device(device)
        self.n = h["num_downs"]
        self.s_cfgs = cfg["student"]["filter_cfgs"]
        self.t_cfgs = N.unet_default_cfgs(h["teacher_ngf"], self.n)
        self.nets = {net: {k: v.detach().to(self.device, torch.float32)
                           .clone().requires_grad_(True)
                           for k, v in params.items()}
                     for net, params in weights.items()}
        leaves = optimizer_leaves(self.nets)
        self.opts = {k: gan.Adam(self.nets, v,
                                 ARCH_BETA1 if k == "arch" else BETA1)
                     for k, v in leaves.items()}
        self.ema = torch.zeros((), device=self.device)
        self.seeds = gan.MaskSeeds(seed)
        self.dropout = h["dropout"]

    def _g(self, net, x, masks):
        cfgs = self.s_cfgs if net == "g" else self.t_cfgs
        keep = masks() if self.dropout else None
        return N.unet(self.nets[net], x, cfgs, self.n, self.prec, keep)

    def _d(self, net, x):
        return N.patchgan(self.nets[net], x, net == "d", "batch", self.prec,
                          self.h["threshold"])

    def _step(self, opt, loss, lr):
        o = self.opts[opt]
        o.step(self.nets, gan.grads_of(loss, o.params(self.nets)), lr)

    def __call__(self, A, B, Av, Bv, lr, ema_beta, arch_lr):
        h, mode, m = self.h, self.h["gan_mode"], {}
        masks = self.seeds.next(self.device)
        t_masks = self.seeds.next(self.device)
        AB = torch.cat([A, B], 1)

        # teacher D, then teacher G (targets captured)
        with torch.no_grad():
            tfake, _ = self._g("tg", A, t_masks)
        pf, _ = self._d("td", torch.cat([A, tfake], 1))
        pr, _ = self._d("td", AB)
        self._step("td", (gan.gan_loss(pf, False, mode)
                          + gan.gan_loss(pr, True, mode)) * 0.5, h["lr"])
        tfake2, tg_feats = self._g("tg", A, t_masks)
        pf, td_feats = self._d("td", torch.cat([A, tfake2], 1))
        self._step("tg", gan.gan_loss(pf, True, mode, False)
                   + h["lambda_L1"] * gan.l1(tfake2, B), h["lr"])
        targets = [f.detach() for f in tg_feats + td_feats]

        # student D
        with torch.no_grad():
            fake, _ = self._g("g", A, masks)
        pf, _ = self._d("d", torch.cat([A, fake], 1))
        pr, _ = self._d("d", AB)
        lf, lr_ = gan.gan_loss(pf, False, mode), gan.gan_loss(pr, True, mode)
        self._step("d", (lf + lr_) * 0.5, lr)
        m["D_fake"], m["D_real"] = lf, lr_

        # student G with distillation
        fake2, g_feats = self._g("g", A, masks)
        pf, _ = self._d("d", torch.cat([A, fake2], 1))
        m["G_GAN"] = gan.gan_loss(pf, True, mode, False)
        m["G_L1"] = h["lambda_L1"] * gan.l1(fake2, B)
        _, sd_feats = self._d("td", torch.cat([A, fake2], 1))
        content, gram_l = gan.distill(
            N.transforms(self.nets["tf"], g_feats, self.prec) + sd_feats,
            targets, use_sqrt=True)
        m["content"] = h["lambda_content"] * content
        m["gram"] = h["lambda_gram"] * gram_l
        self._step("g", m["G_GAN"] + m["G_L1"] + m["content"] + m["gram"], lr)

        # the arch step on the validation batch
        alphas = self.opts["arch"].params(self.nets)
        with torch.no_grad():
            for a in alphas:
                a.clamp_(0.0, 1.0)
            fake, _ = self._g("g", Av, self.seeds.next(self.device))
            tfake, _ = self._g("tg", Av, self.seeds.next(self.device))
            tpf, _ = self._d("td", torch.cat([Av, tfake], 1))
            self.ema = gan.ema_update(self.ema, gan.discrepancy(tpf, mode),
                                      ema_beta)
        pf, _ = self._d("d", torch.cat([Av, fake], 1))
        s_disc = gan.discrepancy(pf, mode)
        pr, _ = self._d("d", torch.cat([Av, Bv], 1))
        loss = torch.abs(s_disc - self.ema) + (
            gan.gan_loss(pr, True, mode) + gan.gan_loss(pf, False, mode)) * 0.5
        self._step("arch", loss, arch_lr)
        m.update({"D_arch": loss, "D_arch_diff": s_disc,
                  "teacher_D_arch_diff": self.ema.clone()})
        return {k: v.detach() for k, v in m.items()}
