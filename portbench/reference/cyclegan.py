"""The GCC CycleGAN cooperative iteration in plain PyTorch (SJLeo/GCC
models/CycleGAN.py:342-640, train.py:144-151), in the port's order: the
teacher G update joint over both directions (lsgan, cycle, identity),
the teacher D update on its replay pools (the fake passes' features are
the D targets), the student G update (lsgan, cycle, identity, MSE content
and gram against the teacher G and D features, the teacher D run on the
detached student fake, the L1 to the teacher fake once a feature pair),
the student D update on its pools, then the arch step per direction.

The replay pools keep ImagePool's sequential semantics (utils/
image_pool.py:23-54): while a pool fills, each image is stored and
returned; once full, a host draw swaps it in at a random slot or passes
it. Frozen copy of the repository's benchmarks/torch_ref_cyclegan.py,
rewritten as functions of parameter dicts, with the port's net names and
the pools as configured.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.reference import gan, nets as N

BETA1, ARCH_BETA1 = 0.5, 0.9
SIDES = ("a", "b")


def _cfgs(cfg: dict):
    st = cfg["student"]
    return {"a": st["cfg_AtoB"], "b": st["cfg_BtoA"]}


def specs(cfg: dict) -> Dict[str, dict]:
    h, s_cfgs = cfg["hyper"], _cfgs(cfg)
    t_ngf = h["teacher_ngf"]
    out = {}
    for s in SIDES:
        out[f"g_{s}"] = N.mobile_resnet_spec(s_cfgs[s])
        out[f"d_{s}"] = N.patchgan_spec(3, h["ndf"], True, "batch")
        out[f"tg_{s}"] = N.mobile_resnet_spec(
            N.mobile_resnet_default_cfg(t_ngf))
        out[f"td_{s}"] = N.patchgan_spec(3, h["teacher_ndf"], False,
                                         "instance")
        out[f"tf_{s}"] = N.transforms_spec((s_cfgs[s][2],) * 4,
                                           (t_ngf * 4,) * 4)
    return out


def optimizer_leaves(spec: Dict[str, dict]) -> Dict[str, list]:
    """One Adam a kind over both directions: student G's with the
    transforms, student D's weights, the teachers', the D alphas."""
    def weights(kind):
        return [(f"{kind}_{s}", k) for s in SIDES
                for k in spec[f"{kind}_{s}"] if not k.endswith("alpha")]
    return {"g": weights("g") + weights("tf"), "d": weights("d"),
            "tg": weights("tg"), "td": weights("td"),
            "arch": [(f"d_{s}", k) for s in SIDES for k in spec[f"d_{s}"]
                     if k.endswith("alpha")]}


def student(cfg: dict, P, x, prec, side: str = "a"):
    """A direction's pruned student (InstanceNorm only: eval = train)."""
    return N.mobile_resnet(P, x, _cfgs(cfg)[side], prec)[0]


class Pool:
    """ImagePool with its draws from the caller's host generator. It also
    keeps every image it was offered (``seen``) and, for each slot, which
    of them the slot holds (``ids``): where each stored image came from."""

    def __init__(self, size: int):
        self.size, self.images, self.ids, self.seen = size, [], [], []

    @torch.no_grad()
    def query(self, images: torch.Tensor, gen: torch.Generator):
        if self.size == 0:
            return images
        out = []
        for img in images:
            self.seen.append(img.clone())
            if len(self.images) < self.size:
                self.images.append(img.clone())
                self.ids.append(len(self.seen) - 1)
                out.append(img)
                continue
            swap = float(torch.rand((), generator=gen)) > 0.5
            idx = int(torch.randint(self.size, (), generator=gen))
            if swap:
                out.append(self.images[idx])
                self.images[idx] = img.clone()
                self.ids[idx] = len(self.seen) - 1
            else:
                out.append(img)
        return torch.stack(out)

    def record(self, shape, device) -> dict:
        """The stored images as one (size, *shape) tensor, zeros in the
        slots not yet filled (``slots``); every image offered (``seen``);
        the offered image each slot holds, -1 where none (``ids``)."""
        slots = torch.zeros((self.size,) + tuple(shape), device=device)
        for i, img in enumerate(self.images):
            slots[i] = img
        seen = torch.stack(self.seen).float() if self.seen else \
            torch.zeros((0,) + tuple(shape), device=device)
        ids = self.ids + [-1] * (self.size - len(self.ids))
        return {"slots": slots, "seen": seen, "ids": ids}


class Iteration:
    """Parameters, five Adams, two EMAs, four pools, the pools' host
    generator; one iteration a call."""

    def __init__(self, cfg: dict, weights, seed: int, prec, device):
        h = cfg["hyper"]
        self.h, self.prec, self.device = h, prec, torch.device(device)
        self.s_cfgs = _cfgs(cfg)
        self.t_cfg = N.mobile_resnet_default_cfg(h["teacher_ngf"])
        self.nets = {net: {k: v.detach().to(self.device, torch.float32)
                           .clone().requires_grad_(True)
                           for k, v in params.items()}
                     for net, params in weights.items()}
        self.opts = {k: gan.Adam(self.nets, v,
                                 ARCH_BETA1 if k == "arch" else BETA1)
                     for k, v in optimizer_leaves(self.nets).items()}
        self.ema = {s: torch.zeros((), device=self.device) for s in SIDES}
        self.pools = {k: Pool(h["pool_size"])
                      for k in ("tpool_b", "tpool_a", "pool_b", "pool_a")}
        self.rng = torch.Generator().manual_seed(seed)

    def _g(self, net, x):
        cfg = self.t_cfg if net.startswith("tg") else self.s_cfgs[net[-1]]
        return N.mobile_resnet(self.nets[net], x, cfg, self.prec)

    def _d(self, net, x):
        masked = net.startswith("d_")
        return N.patchgan(self.nets[net], x, masked,
                          "batch" if masked else "instance", self.prec,
                          self.h["threshold"])

    def _all(self, kind, A, B):
        fake_B, feats_A = self._g(f"{kind}_a", A)
        rec_A, _ = self._g(f"{kind}_b", fake_B)
        fake_A, feats_B = self._g(f"{kind}_b", B)
        rec_B, _ = self._g(f"{kind}_a", fake_A)
        idt_A, _ = self._g(f"{kind}_a", B)
        idt_B, _ = self._g(f"{kind}_b", A)
        return fake_B, rec_A, fake_A, rec_B, idt_A, idt_B, feats_A, feats_B

    def _step(self, opt, loss, lr):
        o = self.opts[opt]
        o.step(self.nets, gan.grads_of(loss, o.params(self.nets)), lr)

    def __call__(self, A, B, Av, Bv, lr, ema_beta, arch_lr):
        h, mode = self.h, self.h["gan_mode"]
        lA, lB, li = h["lambda_A"], h["lambda_B"], h["lambda_identity"]

        def gl(p, real):
            return gan.gan_loss(p, real, mode)

        # teacher G, joint over both directions
        tfB, trA, tfA, trB, tiA, tiB, tgfA, tgfB = self._all("tg", A, B)
        pfa, _ = self._d("td_a", tfB)
        pfb, _ = self._d("td_b", tfA)
        self._step("tg", gl(pfa, True) + gl(pfb, True)
                   + lA * gan.l1(trA, A) + lB * gan.l1(trB, B)
                   + li * (lB * gan.l1(tiA, B) + lA * gan.l1(tiB, A)),
                   h["lr"])
        t_fake_B, t_fake_A = tfB.detach(), tfA.detach()

        # teacher D on its pools; the fake passes' features are targets
        tp_B = self.pools["tpool_b"].query(t_fake_B, self.rng)
        tp_A = self.pools["tpool_a"].query(t_fake_A, self.rng)
        pra, _ = self._d("td_a", B)
        pfa, tdfA = self._d("td_a", tp_B)
        prb, _ = self._d("td_b", A)
        pfb, tdfB = self._d("td_b", tp_A)
        self._step("td", (gl(pra, True) + gl(pfa, False)) * 0.5
                   + (gl(prb, True) + gl(pfb, False)) * 0.5, h["lr"])
        targets = {"a": [f.detach() for f in tgfA + tdfA],
                   "b": [f.detach() for f in tgfB + tdfB]}

        # student G
        fake_B, rec_A, fake_A, rec_B, idt_A, idt_B, fA, fB = \
            self._all("g", A, B)
        pfa, _ = self._d("d_a", fake_B)
        pfb, _ = self._d("d_b", fake_A)
        m = {"G_A": gl(pfa, True), "G_B": gl(pfb, True),
             "cycle_A": lA * gan.l1(rec_A, A),
             "cycle_B": lB * gan.l1(rec_B, B),
             "idt_A": li * lB * gan.l1(idt_A, B),
             "idt_B": li * lA * gan.l1(idt_B, A)}
        with torch.no_grad():
            _, sdA = self._d("td_a", fake_B.detach())
            _, sdB = self._d("td_b", fake_A.detach())
        for s, feats, sd, fake, t_fake in (("A", fA, sdA, fake_B, t_fake_B),
                                           ("B", fB, sdB, fake_A, t_fake_A)):
            side = s.lower()
            tr = N.transforms(self.nets[f"tf_{side}"], feats, self.prec)
            c, g = gan.distill(tr + sd, targets[side], use_sqrt=False)
            m[f"content_{s}"] = h["lambda_content"] * c
            m[f"gram_{s}"] = h["lambda_gram"] * g
            m[f"L1_{s}"] = h["lambda_L1"] * (len(tr) + len(sd)) * gan.l1(
                fake, t_fake)
        self._step("g", sum(m.values()), lr)

        # student D on its pools
        p_B = self.pools["pool_b"].query(fake_B.detach(), self.rng)
        p_A = self.pools["pool_a"].query(fake_A.detach(), self.rng)
        pra, _ = self._d("d_a", B)
        pfa, _ = self._d("d_a", p_B)
        prb, _ = self._d("d_b", A)
        pfb, _ = self._d("d_b", p_A)
        m["D_A"] = (gl(pra, True) + gl(pfa, False)) * 0.5
        m["D_B"] = (gl(prb, True) + gl(pfb, False)) * 0.5
        self._step("d", m["D_A"] + m["D_B"], lr)

        # the arch step, per direction
        with torch.no_grad():
            vfB, _ = self._g("g_a", Av)
            vfA, _ = self._g("g_b", Bv)
            tvfB, _ = self._g("tg_a", Av)
            tvfA, _ = self._g("tg_b", Bv)
            tpa, _ = self._d("td_a", tvfB)
            tpb, _ = self._d("td_b", tvfA)
            self.ema["a"] = gan.ema_update(
                self.ema["a"], gan.discrepancy(tpa, mode), ema_beta)
            self.ema["b"] = gan.ema_update(
                self.ema["b"], gan.discrepancy(tpb, mode), ema_beta)
            for a in self.opts["arch"].params(self.nets):
                a.clamp_(0.0, 1.0)
        pfa, _ = self._d("d_a", vfB)
        disc_a = gan.discrepancy(pfa, mode)
        pra, _ = self._d("d_a", Bv)
        pfb, _ = self._d("d_b", vfA)
        disc_b = gan.discrepancy(pfb, mode)
        prb, _ = self._d("d_b", Av)
        la = torch.abs(disc_a - self.ema["a"]) + (gl(pfa, False)
                                                  + gl(pra, True)) * 0.5
        lb = torch.abs(disc_b - self.ema["b"]) + (gl(pfb, False)
                                                  + gl(prb, True)) * 0.5
        self._step("arch", la + lb, arch_lr)
        m.update({"D_arch_A": la, "D_arch_B": lb, "D_arch_diff_A": disc_a,
                  "D_arch_diff_B": disc_b,
                  "teacher_netD_A_arch_diff": self.ema["a"].clone(),
                  "teacher_netD_B_arch_diff": self.ema["b"].clone()})
        return {k: v.detach() for k, v in m.items()}
