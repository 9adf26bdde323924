"""The row-sharded forwards that tests/test_torch_spatial.py holds against
the unsharded ones and against the JAX package: the nets and inputs, built
from seeds, and the job that every rank of a Gloo group runs.

Spawned ranks import this module by name, so it imports torch and the port
only (no JAX): a rank starts in a few seconds.
"""

from __future__ import annotations

import logging
import os
import pickle

import numpy as np
import torch

from gcc_tpu_torch.config import Config
from gcc_tpu_torch.engines.cyclegan import CycleGANEngine
from gcc_tpu_torch.engines.pix2pix import Pix2PixEngine
from gcc_tpu_torch.engines.srgan import SRGANEngine
from gcc_tpu_torch.models import generators
from gcc_tpu_torch.models.generators import (
    MobileResnetGenerator, SRResNet, UnetGenerator,
)
from gcc_tpu_torch.ops.layers import (
    BatchNorm, Conv, ConvTranspose, init_params,
)
from gcc_tpu_torch.parallel import spatial

MESHES = ((1, 2), (1, 4), (2, 2))
NETS = {
    "srresnet": lambda: SRResNet(n_channels=8, n_blocks=2),
    "mobile_resnet": lambda: MobileResnetGenerator(ngf=4, n_blocks=2),
    "unet": lambda: UnetGenerator(ngf=4, num_downs=5, use_dropout=False),
}
# (the LR height and width, n_spatial): 2-row shards under SRResNet's 9x9
# convs (halo 4), 3-row shards, and a height that lowers 4 shards to 2
SRGAN_CASES = {"lr8": (8, 4), "lr12": (12, 4), "lr10": (10, 4)}


def build_net(name: str) -> torch.nn.Module:
    """A seeded net in eval mode; BatchNorm running statistics spread, so
    that they take part."""
    g = torch.Generator().manual_seed(7)
    net = init_params(NETS[name](), g)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.normal_(0.0, 0.2, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    return net.eval()


def odd_layers() -> torch.nn.Module:
    """Layers no generator has: a transposed conv whose output padding
    reaches past the last row any input touches (16 -> 34 rows), then a
    5x5 stride-2 conv whose 17 output rows do not split over 2 shards."""
    net = torch.nn.Sequential(ConvTranspose(3, 4, (3, 3), (2, 2), 0, 1),
                              Conv(4, 3, (5, 5), (2, 2), 2))
    return init_params(net, torch.Generator().manual_seed(11)).eval()


def image(n: int, h: int, w: int, seed: int) -> torch.Tensor:
    rng = np.random.RandomState(seed)
    return torch.from_numpy((rng.rand(n, 3, h, w) * 2 - 1).astype(np.float32))


def engines() -> dict:
    """The engines of the engine-level cases, seeded (CPU)."""
    sr = SRGANEngine(Config(model="srgan", ngf=4, ndf=4, image_size=32,
                            upscale_factor=4, gan_mode="vanilla"),
                     filter_cfgs=[4] * 16, device="cpu")
    cg = CycleGANEngine(Config(model="cyclegan", ngf=4, ndf=4, teacher_ngf=8,
                               teacher_ndf=8, crop_size=32,
                               online_distillation=True), device="cpu")
    p2p = Pix2PixEngine(Config(model="pix2pix", backbone="resnet", ngf=4,
                               ndf=4, crop_size=32, fused_resblock="on"),
                        device="cpu")
    return {name: (e, e.init_state(seed=0))
            for name, e in (("srgan", sr), ("cyclegan", cg),
                            ("pix2pix_fused", p2p))}


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def spatial_job(mesh, out_dir: str) -> None:
    """Every case on this rank; the outputs, counters, errors and log lines
    pickled as <out_dir>/<rank>.pkl. Rank 0 also keeps the unsharded
    forwards."""
    log = _Records()
    logging.getLogger("gcc-tpu-torch").addHandler(log)
    logging.getLogger("gcc-tpu-torch").setLevel(logging.INFO)
    res = {"nets": {}, "plain": {}, "counters": {}, "errors": {},
           "engines": {}}
    x = image(2, 32, 32, seed=3)
    for name in NETS:
        net = build_net(name)
        for shape in MESHES:
            grid = spatial.make_mesh_2d(*shape)
            grid.reset_counters()
            res["nets"][(name, shape)] = spatial.spatial_apply(
                net, x, mesh=grid).numpy()
            res["counters"][(name, shape)] = dict(grid.counters)
        # no mesh: more shards than ranks, lowered to the 4 ranks
        res["nets"][(name, "n_spatial=8")] = spatial.spatial_apply(
            net, x, n_spatial=8).numpy()
        with torch.no_grad():
            res["plain"][name] = net(x)[0].numpy()
    net, xo = odd_layers(), image(2, 16, 12, seed=12)
    with torch.no_grad():
        res["plain"]["odd_layers"] = net(xo).numpy()
    res["nets"][("odd_layers", (1, 2))] = spatial.spatial_apply(
        net, xo, mesh=spatial.make_mesh_2d(1, 2)).numpy()
    # an explicit mesh is validated
    net = build_net("srresnet")
    for what, shape, xx in (("height", (1, 4), image(2, 10, 16, 4)),
                            ("batch", (2, 2), image(3, 8, 8, 4))):
        try:
            spatial.spatial_apply(net, xx, mesh=spatial.make_mesh_2d(*shape))
        except ValueError as e:
            res["errors"][what] = str(e)

    calls = {"fused": 0}
    fused = generators.fused_mobile_block

    def counting(*a, **kw):
        calls["fused"] += 1
        return fused(*a, **kw)

    generators.fused_mobile_block = counting
    try:
        for fam, (engine, state) in engines().items():
            out = res["engines"]
            if fam == "srgan":
                for case, (h, ns) in SRGAN_CASES.items():
                    lr = image(1, h, h, seed=5)
                    out[case] = (engine.generate_spatial(state, lr,
                                                         n_spatial=ns),
                                 engine.generate(state, lr))
            elif fam == "cyclegan":
                xc = image(1, 32, 32, seed=6)
                for direction in ("AtoB", "BtoA"):
                    for teacher in (False, True):
                        out[("cyclegan", direction, teacher)] = (
                            engine.generate_spatial(
                                state, xc, n_spatial=4, direction=direction,
                                teacher=teacher),
                            engine.generate(state, xc, direction=direction,
                                            teacher=teacher))
            else:
                xp = image(2, 32, 32, seed=8)
                calls["fused"] = 0
                sharded = engine.generate_spatial(state, xp, n_spatial=4)
                under_scope = calls["fused"]
                plain = engine.generate(state, xp)
                out["pix2pix_fused"] = (sharded, plain)
                res["fused_calls"] = (under_scope, calls["fused"])
    finally:
        generators.fused_mobile_block = fused
    res["engines"] = {k: tuple(t.numpy() for t in v)
                      for k, v in res["engines"].items()}
    res["log"] = list(log.lines)
    with open(os.path.join(out_dir, f"{mesh.rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
