"""pix2pix (U-Net or ResNet generator, PatchGAN discriminator): the
engine the harness drives and its plain reference."""

from portbench.family import Family
from portbench.reference import pix2pix


class Pix2Pix(Family):
    reference = pix2pix
    serve_nets = ("g",)

    def engine(self, cfg, cfgj: dict, device):
        from gcc_tpu_torch.engines.pix2pix import Pix2PixEngine
        st = cfgj["student"]
        return Pix2PixEngine(cfg, filter_cfgs=st["filter_cfgs"],
                             channel_cfgs=st.get("channel_cfgs"),
                             device=device)


FAMILY = Pix2Pix()
