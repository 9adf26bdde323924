"""CycleGAN engine: two MobileResnet generators and two PatchGANs with cycle
and identity losses, replay pools and online distillation (port of
gcc_tpu/engines/cyclegan.py; models/CycleGAN.py:223-898).

One cooperative train step per iteration, in the JAX engine's order
(engines/cyclegan.py:136-370):
  teacher G update, joint over both directions (GAN + cycle + identity,
  with the heavy sparsity injection) -> teacher D update on its own pools
  (its fake-side features captured as targets) -> student G update (lsgan,
  cycle, identity, plain-MSE content/gram distillation against the teacher
  G and D features, teacher-D features of the DETACHED student fake, and
  the L1 to the teacher fake once per feature pair) -> student D update on
  the pooled fakes, halved.
and the per-direction arch step on a validation batch (:377-438).

Semantics kept from the JAX engine: G-then-D order; both G's (and both
D's) share one Adam over the joint parameters; the teacher trains online at
constant LR; InstanceNorm everywhere but the masked student D, which is
BatchNorm and moves its running stats on every train-mode forward; the
replay pools are queried teacher B, teacher A, student B, student A, all
from the state's generator. Under normal distillation the teacher is frozen
and its targets come from forward passes that update nothing.

``--fused_resblock on`` runs every residual block of the four generators
through the stage kernels (``ops/mobile_block.fused_mobile_block``) under
MobileResnetGenerator's gate. Batches are {"A", "B"} NCHW tensors on the
engine's device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from gcc_tpu_torch.config import Config
from gcc_tpu_torch.device import configure_precision, resolve_device
from gcc_tpu_torch.engines.common import (
    Adam, CombinedStepMixin, GANState, add_sign_sparsity, arch_params,
    cyclegan_heavy_sparsity, d_pair, discrepancy, distill_losses, ema_update,
    eval_mode, generate_rows, grads_of, weight_params,
)
from gcc_tpu_torch.engines.pix2pix import TransformConvs
from gcc_tpu_torch.losses import gan_loss, l1
from gcc_tpu_torch.models.discriminators import PatchGAN
from gcc_tpu_torch.models.generators import (
    MobileResnetGenerator, mobile_resnet_default_cfg,
)
from gcc_tpu_torch.ops.layers import init_params
from gcc_tpu_torch.ops.mask import clip_alphas
from gcc_tpu_torch.parallel.mesh import mesh_step
from gcc_tpu_torch.utils.tracing import span, spanned
from gcc_tpu_torch.ops.pool import ReplayPool
from gcc_tpu_torch.utils.weights import export_jax_variables, load_jax_variables

SIDES = ("a", "b")


class CycleGANEngine(CombinedStepMixin):
    """Engine surface of the JAX package's CycleGANEngine: build_nets,
    init_state, state_for, train_step, arch_step, train_arch_step, generate
    (per direction), checkpoint_payload, load_net_params."""

    loss_names = ["D_A", "G_A", "cycle_A", "idt_A",
                  "D_B", "G_B", "cycle_B", "idt_B"]
    visual_names = ["real_A", "fake_B", "rec_A", "idt_B",
                    "real_B", "fake_A", "rec_B", "idt_A"]

    def __init__(self, cfg: Config, cfg_AtoB=None, cfg_BtoA=None,
                 device=None, mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device)
        configure_precision(self.device)  # the family's bf16 path
        self.cfg_AtoB, self.cfg_BtoA = cfg_AtoB, cfg_BtoA
        self.distill = cfg.online_distillation or cfg.normal_distillation
        self.online = cfg.online_distillation
        self.darts = cfg.darts_discriminator
        self.gan_mode = cfg.gan_mode
        self.fused_d = cfg.fused_d_batch
        self.fused_blocks = {"auto": None, "on": True,
                             "off": False}[cfg.fused_resblock]

    # ------------------------------------------------------------------ init

    def build_nets(self) -> Dict[str, nn.Module]:
        """The engine's nets (and replay pools) with uninitialised
        parameters, on the CPU; the pools hold crop_size images."""
        cfg = self.cfg
        size = cfg.crop_size
        nets: Dict[str, nn.Module] = {}
        s_cfgs = {"a": self.cfg_AtoB, "b": self.cfg_BtoA}
        for s in SIDES:
            s_cfgs[s] = list(s_cfgs[s]) if s_cfgs[s] is not None \
                else mobile_resnet_default_cfg(cfg.ngf)
            nets[f"g_{s}"] = MobileResnetGenerator(
                ngf=cfg.ngf, cfg=s_cfgs[s], use_fused_blocks=self.fused_blocks)
        for s in SIDES:
            nets[f"d_{s}"] = PatchGAN(3, cfg.ndf, norm="instance",
                                      masked=self.darts,
                                      threshold=cfg.threshold)
        # one pool size for student and teacher pools (engines/cyclegan.py:
        # 103-111); 0 passes images through
        pool = (cfg.pool_size, (3, size, size))
        for s in SIDES:
            nets[f"pool_{s}"] = ReplayPool(*pool)
        if self.distill:
            tngf = cfg.teacher_ngf
            for s in SIDES:
                nets[f"tg_{s}"] = MobileResnetGenerator(
                    ngf=tngf, use_fused_blocks=self.fused_blocks)
                nets[f"td_{s}"] = PatchGAN(3, cfg.teacher_ndf,
                                           norm="instance")
                nets[f"tpool_{s}"] = ReplayPool(*pool)
                # every captured feature has the width of down_1's output
                nets[f"tf_{s}"] = TransformConvs((s_cfgs[s][2],) * 4,
                                                 (tngf * 4,) * 4)
        return nets

    def init_state(self, seed: int = 0) -> GANState:
        """Fresh state: parameters drawn from a CPU generator seeded with
        ``seed`` (the same numbers on every device), then moved to the
        engine's device; Adam moments at zero; EMAs unset; pools empty."""
        gen = torch.Generator().manual_seed(seed)
        nets = {k: init_params(v, gen).to(self.device).train()
                for k, v in self.build_nets().items()}
        return self.state_for(nets, seed)

    def state_for(self, nets: Dict[str, nn.Module], seed: int = 0
                  ) -> GANState:
        """A step-0 state around already-initialised nets; ``seed`` seeds
        the replay pools' generator."""
        opts = {"g": Adam(self._g_bundle(nets), 0.5, 0.999),
                "d": Adam(self._pair(nets, "d"), 0.5, 0.999)}
        if self.online:
            opts["tg"] = Adam(self._pair(nets, "tg"), 0.5, 0.999)
            opts["td"] = Adam(self._pair(nets, "td"), 0.5, 0.999)
        if self.darts:
            opts["arch"] = Adam(self._pair(nets, "d", arch_params), 0.9,
                                0.999)
        ema = {f"d_{s}_arch": torch.zeros((), device=self.device)
               for s in SIDES}
        return GANState(step=0, nets=nets, opts=opts, ema=ema,
                        rng=torch.Generator().manual_seed(seed))

    @staticmethod
    def _pair(nets, kind: str, params=weight_params):
        """One Adam group over both directions' nets of a kind."""
        return params(nets[f"{kind}_a"]) + params(nets[f"{kind}_b"])

    def _g_bundle(self, nets):
        """The student G update's parameters: both G's, plus both transforms
        when distilling (the JAX bundle {g_a, g_b, tf_a, tf_b})."""
        bundle = self._pair(nets, "g")
        if self.distill:
            bundle += self._pair(nets, "tf")
        return bundle

    def _sparsify(self, nets, kind: str, params, grads):
        """The heavy-weighted sign sparsity on the G entries of a bundle
        that starts with G_A's then G_B's parameters."""
        cfg = self.cfg
        n_a = len(weight_params(nets[f"{kind}_a"]))
        n_b = len(weight_params(nets[f"{kind}_b"]))
        for net, lo, hi in ((nets[f"{kind}_a"], 0, n_a),
                            (nets[f"{kind}_b"], n_a, n_a + n_b)):
            grads[lo:hi] = add_sign_sparsity(
                net, params[lo:hi], grads[lo:hi], cfg.lambda_weight,
                cfg.lambda_scale, weight_scale_fn=cyclegan_heavy_sparsity)
        return grads

    @staticmethod
    def _g_forward_all(GA, GB, A, B):
        """fake_B, rec_A, fake_A, rec_B, idt_A, idt_B and the features of
        the fake_B and fake_A forwards (engines/cyclegan.py:150-164)."""
        fake_B, feats_A = GA(A)
        rec_A, _ = GB(fake_B)
        fake_A, feats_B = GB(B)
        rec_B, _ = GA(fake_A)
        idt_A, _ = GA(B)
        idt_B, _ = GB(A)
        return fake_B, rec_A, fake_A, rec_B, idt_A, idt_B, feats_A, feats_B

    # ------------------------------------------------------------- train step

    @mesh_step
    def train_step(self, state: GANState, batch: Dict[str, torch.Tensor],
                   lr: float) -> Tuple[GANState, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        A, B = batch["A"], batch["B"]
        lam_idt, lam_A, lam_B = cfg.lambda_identity, cfg.lambda_A, cfg.lambda_B
        nets, opts, gm = state.nets, state.opts, self.gan_mode
        m: Dict[str, torch.Tensor] = {}

        if self.distill and not self.online:
            # normal_distillation: frozen teachers, forward-only targets
            with span("gcc.teacher_g"), torch.no_grad(), \
                    eval_mode(nets["td_a"], nets["td_b"]):
                (t_fake_B, _, t_fake_A, _, _, _, tgfA, tgfB) = \
                    self._g_forward_all(nets["tg_a"], nets["tg_b"], A, B)
                _, tdfA = nets["td_a"](t_fake_B)
                _, tdfB = nets["td_b"](t_fake_A)
            targets_A, targets_B = tgfA + tdfA, tgfB + tdfB
        if self.online:
            # ---- teacher G update, joint over both directions ----
            TDA, TDB = nets["td_a"], nets["td_b"]
            with span("gcc.teacher_g"):
                (tfB, trA, tfA, trB, tiA, tiB, tgfA, tgfB) = \
                    self._g_forward_all(nets["tg_a"], nets["tg_b"], A, B)
                pfa, _ = TDA(tfB, False)
                pfb, _ = TDB(tfA, False)
                loss = (gan_loss(pfa, True, gm) + gan_loss(pfb, True, gm)
                        + lam_A * l1(trA, A) + lam_B * l1(trB, B)
                        + lam_idt * (lam_B * l1(tiA, B) + lam_A * l1(tiB, A)))
                tg_params = self._pair(nets, "tg")
                # the TEACHER gets the sparsity injection too, heavy
                # weighting included (train.py:93-98, CycleGAN.py:537)
                gtg = self._sparsify(nets, "tg", tg_params,
                                     grads_of(loss, tg_params))
                opts["tg"].step(tg_params, gtg, cfg.lr)
                t_fake_B, t_fake_A = tfB.detach(), tfA.detach()

            # ---- teacher D update on its own pools; the fake passes'
            # features are the D targets ----
            with span("gcc.teacher_d"):
                tp_fake_B = nets["tpool_b"].query(t_fake_B, state.rng)
                tp_fake_A = nets["tpool_a"].query(t_fake_A, state.rng)
                pra, pfa, tdfA = d_pair(TDA, B, tp_fake_B, self.fused_d, False)
                prb, pfb, tdfB = d_pair(TDB, A, tp_fake_A, self.fused_d, False)
                loss = ((gan_loss(pra, True, gm)
                         + gan_loss(pfa, False, gm)) * 0.5
                        + (gan_loss(prb, True, gm)
                           + gan_loss(pfb, False, gm)) * 0.5)
                td_params = self._pair(nets, "td")
                opts["td"].step(td_params, grads_of(loss, td_params), cfg.lr)
                targets_A = [f.detach() for f in tgfA + tdfA]
                targets_B = [f.detach() for f in tgfB + tdfB]

        # ---- student G update (G-then-D, CycleGAN.py:567-588) ----
        with span("gcc.student_g"):
            (fake_B, rec_A, fake_A, rec_B, idt_A, idt_B, fA, fB) = \
                self._g_forward_all(nets["g_a"], nets["g_b"], A, B)
            # the masked student D is BatchNorm: its stats move on this
            # forward
            pfa, _ = nets["d_a"](fake_B)
            pfb, _ = nets["d_b"](fake_A)
            aux = {"G_A": gan_loss(pfa, True, gm),
                   "G_B": gan_loss(pfb, True, gm),
                   "cycle_A": lam_A * l1(rec_A, A),
                   "cycle_B": lam_B * l1(rec_B, B),
                   "idt_A": lam_idt * lam_B * l1(idt_A, B),
                   "idt_B": lam_idt * lam_A * l1(idt_B, A)}
            loss = sum(aux.values())
            if self.distill:
                trA, trB = nets["tf_a"](fA), nets["tf_b"](fB)
                # teacher-D features of the student fake are detached in
                # the reference (CycleGAN.py:492-493): no gradient through
                # them
                with torch.no_grad():
                    _, sdA = nets["td_a"](fake_B.detach(), False)
                    _, sdB = nets["td_b"](fake_A.detach(), False)
                cA, gA = distill_losses(trA + sdA, targets_A, use_sqrt=False)
                cB, gB = distill_losses(trB + sdB, targets_B, use_sqrt=False)
                n_feats = len(trA) + len(sdA)
                aux["content_A"] = cfg.lambda_content * cA
                aux["content_B"] = cfg.lambda_content * cB
                aux["gram_A"] = cfg.lambda_gram * gA
                aux["gram_B"] = cfg.lambda_gram * gB
                # L1 accumulated once per feature pair (CycleGAN.py:515,523)
                aux["L1_A"] = cfg.lambda_L1 * n_feats * l1(fake_B, t_fake_B)
                aux["L1_B"] = cfg.lambda_L1 * n_feats * l1(fake_A, t_fake_A)
                for k in ("content_A", "content_B", "gram_A", "gram_B",
                          "L1_A", "L1_B"):
                    loss = loss + aux[k]
            bundle = self._g_bundle(nets)
            gg = self._sparsify(nets, "g", bundle, grads_of(loss, bundle))
            opts["g"].step(bundle, gg, lr)
            m.update({k: v.detach() for k, v in aux.items()})

        # ---- student D update on the pooled fakes ----
        with span("gcc.student_d"):
            pooled_fake_B = nets["pool_b"].query(fake_B.detach(), state.rng)
            pooled_fake_A = nets["pool_a"].query(fake_A.detach(), state.rng)
            pra, pfa, _ = d_pair(nets["d_a"], B, pooled_fake_B, self.fused_d)
            prb, pfb, _ = d_pair(nets["d_b"], A, pooled_fake_A, self.fused_d)
            lda = (gan_loss(pra, True, gm) + gan_loss(pfa, False, gm)) * 0.5
            ldb = (gan_loss(prb, True, gm) + gan_loss(pfb, False, gm)) * 0.5
            d_params = self._pair(nets, "d")
            opts["d"].step(d_params, grads_of(lda + ldb, d_params), lr)
            m["D_A"], m["D_B"] = lda.detach(), ldb.detach()

        state.step += 1
        return state, m

    # -------------------------------------------------------------- arch step

    @spanned("gcc.arch")
    @mesh_step
    def arch_step(self, state: GANState, batch: Dict[str, torch.Tensor],
                  ema_beta: float, arch_lr: Optional[float] = None
                  ) -> Tuple[GANState, Dict[str, torch.Tensor]]:
        """Per direction: the teacher discrepancy EMA, then |student disc -
        EMA| + the halved D GAN terms, Adam over both D's mask alphas
        (engines/cyclegan.py:377-438)."""
        if arch_lr is None:
            arch_lr = self.cfg.arch_lr
        A, B = batch["A"], batch["B"]
        nets, gm = state.nets, self.gan_mode
        DA, DB = nets["d_a"], nets["d_b"]

        with torch.no_grad():
            fake_B, _ = nets["g_a"](A)
            fake_A, _ = nets["g_b"](B)
            t_fake_B, _ = nets["tg_a"](A)
            t_fake_A, _ = nets["tg_b"](B)
            tpa, _ = nets["td_a"](t_fake_B, False)
            tpb, _ = nets["td_b"](t_fake_A, False)
            state.ema["d_a_arch"] = ema_update(
                state.ema["d_a_arch"], discrepancy(tpa, gm), ema_beta)
            state.ema["d_b_arch"] = ema_update(
                state.ema["d_b_arch"], discrepancy(tpb, gm), ema_beta)
        alphas = self._pair(nets, "d", arch_params)
        clip_alphas(alphas)

        pfa, _ = DA(fake_B)
        disc_a = discrepancy(pfa, gm)
        pra, _ = DA(B)
        pfb, _ = DB(fake_A)
        disc_b = discrepancy(pfb, gm)
        prb, _ = DB(A)
        loss_a = torch.abs(disc_a - state.ema["d_a_arch"]) + (
            gan_loss(pfa, False, gm) + gan_loss(pra, True, gm)) * 0.5
        loss_b = torch.abs(disc_b - state.ema["d_b_arch"]) + (
            gan_loss(pfb, False, gm) + gan_loss(prb, True, gm)) * 0.5
        state.opts["arch"].step(alphas, grads_of(loss_a + loss_b, alphas),
                                arch_lr)
        return state, {"D_arch_A": loss_a.detach(),
                       "D_arch_B": loss_b.detach(),
                       "D_arch_diff_A": disc_a.detach(),
                       "D_arch_diff_B": disc_b.detach(),
                       "teacher_netD_A_arch_diff":
                           state.ema["d_a_arch"].clone(),
                       "teacher_netD_B_arch_diff":
                           state.ema["d_b_arch"].clone()}

    # ------------------------------------------------------------------ eval

    @torch.no_grad()
    def generate(self, state: GANState, x: torch.Tensor,
                 direction: str = "AtoB", teacher: bool = False
                 ) -> torch.Tensor:
        """Eval-mode forward of the student (or teacher) generator of a
        direction: G_A for AtoB, G_B for BtoA."""
        side = "a" if direction == "AtoB" else "b"
        with eval_mode(state.nets[f"{'tg' if teacher else 'g'}_{side}"]) \
                as (net,):
            return net(x)[0]

    def generate_spatial(self, state: GANState, x: torch.Tensor,
                         n_spatial=None, mesh=None, direction: str = "AtoB",
                         teacher: bool = False) -> torch.Tensor:
        """``generate`` with the image's rows sharded over the ranks
        (engines/common.py ``generate_rows``; gcc_tpu/engines/
        cyclegan.py:457-466)."""
        side = "a" if direction == "AtoB" else "b"
        return generate_rows(state.nets[f"{'tg' if teacher else 'g'}_{side}"],
                             x, n_spatial, mesh)

    # ------------------------------------------------------------- checkpoint

    def checkpoint_payload(self, state: GANState, epoch: int,
                           metric=None) -> dict:
        """G_A, G_B, D_A, D_B in the JAX layout, the epoch, cfg =
        (cfg_AtoB, cfg_BtoA) and the metric (engines/cyclegan.py:465-469)."""
        nets = state.nets
        return {"G_A": export_jax_variables(nets["g_a"]),
                "G_B": export_jax_variables(nets["g_b"]),
                "D_A": export_jax_variables(nets["d_a"]),
                "D_B": export_jax_variables(nets["d_b"]),
                "epoch": epoch, "cfg": (self.cfg_AtoB, self.cfg_BtoA),
                "fid": metric}

    def load_net_params(self, state: GANState, ckpt: dict,
                        load_discriminator: bool = True) -> GANState:
        """The checkpoint's G_A and G_B (and D_A, D_B) written into the
        state's nets."""
        load_jax_variables(state.nets["g_a"], ckpt["G_A"])
        load_jax_variables(state.nets["g_b"], ckpt["G_B"])
        if load_discriminator and ckpt.get("D_A") is not None:
            load_jax_variables(state.nets["d_a"], ckpt["D_A"])
            load_jax_variables(state.nets["d_b"], ckpt["D_B"])
        return state
