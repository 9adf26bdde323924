"""The bf16 CycleGAN tests' configuration and batches
(tests/test_torch_bf16_cyclegan.py, tests/test_torch_bf16_cyclegan_step.py).
"""

import numpy as np

import jax

from gcc_tpu_torch.config import Config
from gcc_tpu_torch.engines.cyclegan import CycleGANEngine
from gcc_tpu_torch.utils.weights import to_jax_nets


LR = 2e-4
KW = dict(model="cyclegan", ngf=4, ndf=8, teacher_ngf=8, teacher_ndf=8,
          crop_size=32, gan_mode="lsgan", online_distillation=True,
          darts_discriminator=True, pool_size=0, lr=LR, arch_lr=1e-4,
          lambda_A=10.0, lambda_B=10.0, lambda_identity=0.5,
          lambda_content=0.01, lambda_gram=10.0, lambda_L1=1.0,
          lambda_weight=1e-3, fused_resblock="off")
# G_A's student of tests/test_torch_cyclegan.py: block 4 elided
CFG_A = [3, 6, 12, 5, 12, 7, 12, 4, 12, 2, 12, 0, 0, 6, 12, 5, 12, 3, 12,
         8, 12, 6, 3]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def setup(lr, **kw):
    """The port's engine at learning rate lr (the teachers' too, the arch
    step's halved), the JAX-layout nets of its seeded init, and the batch
    source (A, B, val A, val B)."""
    eng = CycleGANEngine(Config(**dict(KW, lr=lr, arch_lr=lr / 2, **kw)),
                         cfg_AtoB=CFG_A, device="cpu")
    nets0 = to_jax_nets(eng.init_state(seed=3))
    rng = np.random.RandomState(11)

    def batches():
        return [rng.rand(2, 32, 32, 3).astype(np.float32) * 2 - 1
                for _ in range(4)]

    return eng, nets0, batches
