"""CycleGAN's normal distillation (frozen teachers) in the port against the
JAX engine (gcc_tpu.engines.cyclegan) over 2 iterations at 80 px, where
the blocks are 20 px a side and the fused gate opens: the port with
``--fused_resblock on`` (the stage kernels' plain versions on the CPU,
counted) against the JAX engine unfused. One JAX compile serves both
tests. Bounds: tests/test_torch_cyclegan.py's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gcc_tpu_torch.ops import mobile_block  # noqa: E402
from torch_limits import one_thread  # noqa: E402,F401
from torch_cyclegan_common import (  # noqa: E402
    CFG_A, CHAOTIC, KW, LR, _leaves, _tnets, flips, trajectory,
)


@pytest.fixture(scope="module")
def normal80():
    """Two iterations of normal distillation (frozen teachers) at 80 px,
    where the blocks are 20 px a side: the port's blocks of all four
    generators run fused, through the stage kernels' plain versions
    (counted), the JAX engine's unfused. One JAX compile serves both tests
    below."""
    calls = {"fwd": 0}
    plain = mobile_block.stage_fwd_plain

    def counted(*a, **k):
        calls["fwd"] += 1
        return plain(*a, **k)

    kw = {**KW, "crop_size": 80, "online_distillation": False,
          "normal_distillation": True, "fused_resblock": "on"}
    mobile_block.stage_fwd_plain = counted
    try:
        run = trajectory(kw, 2, 80, cfg_a=CFG_A, seed=5)
    finally:
        mobile_block.stage_fwd_plain = plain
    return run, calls["fwd"]


def test_fused_blocks_at_80px_match_jax_unfused(normal80):
    """The port's fused blocks hold the JAX engine's unfused ones: every
    loss of the first iteration at the pix2pix bound, every kernel within
    1e-6 after it but isolated opposite Adam steps. The two sides' trees
    are the same; the separable convs' biases are not read on the fused
    path and keep their values there."""
    (nets0, snaps, hist), fwd = normal80
    # an iteration: the teachers' 6 target forwards (9 blocks each), the
    # students' 6 with a gradient (G_A 8 blocks, G_B 9) and the arch
    # step's one of each of the four G's; two stages a block
    per_iter = 2 * (6 * 9 + 3 * (8 + 9) + (8 + 9 + 9 + 9))
    assert fwd == 2 * per_iter
    j, t = hist[0]
    for k in j:
        tol = 3e-2 if k in CHAOTIC else 1e-4 + 2e-3 * abs(j[k])
        assert abs(j[k] - t[k]) < tol, (k, j[k], t[k])
    jnets, tnets = snaps[0]
    found = flips(jnets, _tnets(tnets))
    print(f"isolated opposite Adam steps: {found}")
    for name, (n, size, worst) in found.items():
        assert worst <= 2 * LR + 1e-6 and n <= max(1, size // 100), name
    for net in ("g_a", "g_b"):
        for path, a in _leaves(tnets[net]):
            if "_sep" in path and path.endswith("/bias"):
                np.testing.assert_array_equal(
                    a, dict(_leaves(nets0[net]))[path])


def test_normal_distillation_parity(normal80):
    """Frozen teachers: both iterations at the pix2pix bound on every loss
    (the arch keys 3e-2), and the teachers' parameters unchanged on both
    sides."""
    (nets0, snaps, hist), _ = normal80
    for i, (j, t) in enumerate(hist):
        assert set(j) == set(t)
        for k in j:
            tol = 3e-2 if k in CHAOTIC else 1e-4 + 2e-3 * abs(j[k])
            assert abs(j[k] - t[k]) < tol, (i, k, j[k], t[k])
    jnets, tnets = snaps[-1]
    for net in ("tg_a", "tg_b", "td_a", "td_b"):
        for path, a in _leaves(nets0[net]):
            np.testing.assert_array_equal(dict(_leaves(tnets[net]))[path], a)
            np.testing.assert_array_equal(dict(_leaves(jnets[net]))[path], a)
