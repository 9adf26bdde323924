"""The bf16 SRGAN tests' configuration and helpers
(tests/test_torch_bf16_srgan.py, tests/test_torch_bf16_srgan_step.py).
"""

import numpy as np

import jax

from gcc_tpu_torch.config import Config
from gcc_tpu_torch.engines.srgan import SRGANEngine
from gcc_tpu_torch.metrics.vgg import (
    VGG19_CONV_IDX, load_torch_vgg19,
)
from gcc_tpu_torch.utils.weights import to_jax_nets


LR = 1e-4
FILTERS = [4, 6, 8, 4, 6, 8, 4, 0, 8, 4, 6, 8, 4, 6, 8, 4]  # block 7 elided
KW = dict(model="srgan", ngf=8, ndf=8, teacher_ngf=8, teacher_ndf=8,
          image_size=32, upscale_factor=4, gan_mode="vanilla",
          online_distillation=True, darts_discriminator=True, lr=LR,
          arch_lr=1e-4, lambda_SR_content=1.0, lambda_SR_adversarial=1e-3,
          lambda_SR_perceptual=1.0, lambda_content=1.0, lambda_gram=1.0,
          lambda_L1=1.0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def vgg_state_dict(seed=0):
    """A torchvision-named VGG19 state dict of seeded He-scaled weights
    (tests/test_torch_srgan.py's)."""
    rng = np.random.RandomState(seed)
    sd, in_ch = {}, 3
    for idx in VGG19_CONV_IDX:
        out = 64 * min(2 ** sum(1 for p in (2, 7, 16, 25) if p < idx), 8)
        sd[f"features.{idx}.weight"] = (rng.randn(out, in_ch, 3, 3) * np.sqrt(
            2.0 / (9 * in_ch))).astype(np.float32)
        sd[f"features.{idx}.bias"] = (rng.randn(out) * 0.01).astype(
            np.float32)
        in_ch = out
    return sd


def setup(**kw):
    """The port's engine with the configuration's learning rate 0 (the
    teachers'; the students' is each step's), the JAX-layout nets of its
    seeded init, and the batch source ((lr, hr) train then val)."""
    vgg = vgg_state_dict()
    eng = SRGANEngine(Config(**dict(KW, lr=0.0, arch_lr=0.0, **kw)),
                      filter_cfgs=FILTERS, device="cpu",
                      vgg_params=load_torch_vgg19(vgg))
    nets0 = to_jax_nets(eng.init_state(seed=5))
    rng = np.random.RandomState(5)

    def batches():
        return [((rng.rand(2, 8, 8, 3) * 2 - 1).astype(np.float32),
                 (rng.rand(2, 32, 32, 3) * 2 - 1).astype(np.float32))
                for _ in range(2)]

    return eng, nets0, batches, vgg
