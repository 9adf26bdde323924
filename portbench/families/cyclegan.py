"""CycleGAN (MobileResnet generators, PatchGAN discriminators, replay
pools): the engine the harness drives and its plain reference."""

from portbench.family import Family
from portbench.reference import bounds, cyclegan


class CycleGAN(Family):
    reference = cyclegan
    serve_nets = ("g_a", "g_b")
    pool_names = ("tpool_b", "tpool_a", "pool_b", "pool_a")

    def engine(self, cfg, cfgj: dict, device):
        from gcc_tpu_torch.engines.cyclegan import CycleGANEngine
        st = cfgj["student"]
        return CycleGANEngine(cfg, cfg_AtoB=st["cfg_AtoB"],
                              cfg_BtoA=st["cfg_BtoA"], device=device)

    def b2_calls(self, cfgj: dict, batch: int, size: int):
        st, h = cfgj["student"], cfgj["hyper"]
        if cfgj.get("expect", {}).get("fused_resblock") != "on":
            return None
        teacher = cyclegan.N.mobile_resnet_default_cfg(h["teacher_ngf"])
        return bounds.cyclegan_b2_calls(
            [st["cfg_AtoB"], st["cfg_BtoA"], teacher, teacher], batch, size)


FAMILY = CycleGAN()
