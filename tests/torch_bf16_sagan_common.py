"""The bf16 SAGAN tests' configuration and helpers
(tests/test_torch_bf16_sagan.py, tests/test_torch_bf16_sagan_step.py).
"""

import numpy as np

import jax

from gcc_tpu_torch.config import Config
from gcc_tpu_torch.engines.sagan import SAGANEngine
from gcc_tpu_torch.utils.weights import to_jax_nets


GAMMA = {"attn1": 0.5, "attn2": -0.3}
G_CFG = [20, 12, 9, 16]  # the pruned student of tests/test_torch_sagan.py
LR = 2e-4
KW = dict(model="sagan", ngf=8, ndf=8, teacher_ngf=8, teacher_ndf=8, z_dim=8,
          crop_size=64, gan_mode="hinge", online_distillation=True,
          darts_discriminator=True, lambda_content=1.0, lambda_gram=1.0,
          lambda_L1=0.5, lr=LR, arch_lr=1e-4, lambda_weight=1e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _gammas(variables):
    for name, g in GAMMA.items():
        variables["params"][name]["gamma"] = np.float32(g)
    return variables


def setup(lr, seed=5):
    """The port's engine at learning rate lr (the teachers' too, the arch
    step's halved), the JAX-layout nets of its seeded init with every gamma
    non-zero, and the batch source ({z, real} train then val)."""
    eng = SAGANEngine(Config(**dict(KW, lr=lr, arch_lr=lr / 2)),
                      filter_cfgs=G_CFG, device="cpu")
    nets0 = to_jax_nets(eng.init_state(seed=seed))
    for net in ("g", "d", "tg", "td"):
        _gammas(nets0[net])
    rng = np.random.RandomState(7)

    def batches():
        return [(rng.randn(2, 8).astype(np.float32),
                 (rng.rand(2, 64, 64, 3) * 2 - 1).astype(np.float32))
                for _ in range(2)]

    return eng, nets0, batches
