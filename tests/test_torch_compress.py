"""The port's MACs counting and pruning (gcc_tpu_torch.compress) against
gcc_tpu.compress.

Both take the JAX package's parameter trees, which a port net gives as
``export_jax_variables(net)["params"]``. Each family's tree is made once,
from the port's net where the port has one (U-Net, MobileResnet, SAGAN;
its paths and shapes are checked against the JAX net's), from the JAX
net's shapes where it has not (SRResNet), with the long-tailed
per-channel spread that sparsity pretraining leaves (bench.py:176-182,
np.random.RandomState). Both packages prune the same numpy tree: the
filter/channel cfgs must be equal and the GMACs equal to the last bit
(the same integer arithmetic). The hand-computed MACs of
tests/test_compress.py hold for the port too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gcc_tpu.compress import macs as JM  # noqa: E402
from gcc_tpu.compress import prune as JP  # noqa: E402
from gcc_tpu.models import generators as JG  # noqa: E402
from gcc_tpu_torch.compress import macs as M  # noqa: E402
from gcc_tpu_torch.compress import prune as P  # noqa: E402
from gcc_tpu_torch.models.generators import (  # noqa: E402
    MobileResnetGenerator, SAGANGenerator, UnetGenerator,
    mobile_resnet_default_cfg, unet_default_filter_cfgs,
)
from gcc_tpu_torch.utils.weights import export_jax_variables  # noqa: E402
from torch_limits import one_thread  # noqa: E402,F401

K = jax.random.PRNGKey(0)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _spread(tree, seed):
    """bench.py's spread over a tree, leaves in the JAX tree order (sorted
    keys): rand * exp(U(-6, 2)) per last-axis channel; a scalar leaf gets
    rand."""
    rng = np.random.RandomState(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if not t.shape:  # SAGAN's attention gammas
            return np.float32(rng.rand())
        return (rng.rand(*t.shape).astype(np.float32)
                * np.exp(rng.uniform(-6, 2, t.shape[-1])).astype(np.float32))

    return walk(tree)


def _port_tree(net, jax_net, *example):
    """The port net's params tree; its paths and shapes are the JAX net's."""
    tree = export_jax_variables(net)["params"]
    shapes = jax.eval_shape(lambda k: jax_net.init(
        {"params": k, "dropout": k}, *example), K)["params"]
    assert {p: a.shape for p, a in _leaves(tree)} == \
        {p: tuple(s.shape) for p, s in _leaves(shapes)}
    return tree


def _outcome(fn, *args, **kw):
    try:
        return fn(*args, **kw)
    except RuntimeError as e:  # no threshold fits: both must say so
        return type(e)


@pytest.fixture(scope="module")
def trees():
    x256 = jnp.ones((1, 256, 256, 3))
    z = jnp.ones((1, 128))
    return {
        "unet": _spread(_port_tree(UnetGenerator(ngf=32),
                                   JG.UnetGenerator(ngf=32), x256), 0),
        "resnet": _spread(_port_tree(MobileResnetGenerator(ngf=32),
                                     JG.MobileResnetGenerator(ngf=32), x256),
                          1),
        "sagan": _spread(_port_tree(SAGANGenerator(ngf=48),
                                    JG.SAGANGenerator(ngf=48), z), 2),
        "srresnet": _spread(jax.eval_shape(lambda k: JG.SRResNet().init(
            k, jnp.ones((1, 24, 24, 3))), K)["params"], 3),
    }


# case: (family, driver in both packages, keyword arguments)
PRUNE_CASES = {
    "unet_norm": ("unet", "prune_unet",
                  dict(mode="norm", ngf=32, target_budget_g=3.0,
                       tolerance_g=0.1)),
    "unet_scale": ("unet", "prune_unet",
                   dict(mode="scale", ngf=32, target_budget_g=3.0,
                        tolerance_g=0.1)),
    "resnet_mean": ("resnet", "prune_mobile_resnet",
                    dict(target_budget_g=3.0, tolerance_g=0.1)),
    "resnet_union": ("resnet", "prune_mobile_resnet_union",
                     dict(target_budget_g=3.0, tolerance_g=0.1)),
    "sagan": ("sagan", "prune_sagan",
              dict(target_budget_g=0.12, tolerance_g=0.005)),
    "srresnet_norm": ("srresnet", "prune_srresnet",
                      dict(mode="norm", n_channels=64, target_budget_g=0.8,
                           tolerance_g=0.01)),
    "srresnet_scale": ("srresnet", "prune_srresnet",
                       dict(mode="scale", n_channels=64, target_budget_g=0.8,
                            tolerance_g=0.01)),
}


@pytest.mark.parametrize("case", sorted(PRUNE_CASES))
def test_prune_matches_jax(trees, case):
    family, driver, kw = PRUNE_CASES[case]
    got = _outcome(getattr(P, driver), trees[family], **kw)
    want = _outcome(getattr(JP, driver), trees[family], **kw)
    assert got == want
    assert not isinstance(got, type), f"{case}: no threshold fits"


def test_pruned_unet_builds_at_its_macs(trees):
    """The bench's student: the scale-pruned cfg builds in the port, with
    JAX's parameter count, and runs at the MACs the search reports."""
    fc, cc, g = P.prune_unet(trees["unet"], mode="scale", ngf=32,
                             target_budget_g=3.0, tolerance_g=0.1)
    assert abs(g - 3.0) <= 0.1 and fc[0] == 32
    net = UnetGenerator(ngf=32, filter_cfgs=fc, channel_cfgs=cc)
    jnet = JG.UnetGenerator(ngf=32, filter_cfgs=fc, channel_cfgs=cc)
    assert M.count_params(net) == JM.count_params(
        jnet, jnp.ones((1, 256, 256, 3)))
    assert M.unet_macs(fc) / 1e9 == g


def test_count_params_collections():
    from gcc_tpu.models.discriminators import PatchGAN as JaxPatchGAN
    from gcc_tpu_torch.models.discriminators import PatchGAN
    x = jnp.ones((1, 64, 64, 6))
    net = PatchGAN(6, 8, masked=True)
    jnet = JaxPatchGAN(ndf=8, norm="batch", masked=True)
    for coll in ("params", "arch"):
        assert M.count_params(net, coll) == JM.count_params(
            jnet, x, collection=coll) > 0


def test_unet_macs_hand_computed():
    # ngf=4, num_downs=5, 32x32 input, hand-computed layer by layer
    f = unet_default_filter_cfgs(4, 5)
    assert f == [4, 8, 16, 32, 32, 32, 16, 8, 4]
    expected = 0
    expected += 16 * 16 * 4 * 3 * 16      # d0
    expected += 8 * 8 * 8 * 4 * 16        # d1
    expected += 4 * 4 * 16 * 8 * 16       # d2
    expected += 2 * 2 * 32 * 16 * 16      # d3
    expected += 1 * 1 * 32 * 32 * 16      # d4 (innermost)
    expected += 2 * 2 * 32 * 32 * 16               # u4
    expected += 4 * 4 * 16 * (32 + 32) * 16        # u3: in = d3 + u4
    expected += 8 * 8 * 8 * (16 + 16) * 16         # u2: in = d2 + u3
    expected += 16 * 16 * 4 * (8 + 8) * 16         # u1: in = d1 + u2
    expected += 32 * 32 * 3 * (4 + 4) * 16         # u0 -> output_nc
    assert M.unet_macs(f, num_downs=5, image_size=32) == expected
    assert M.unet_macs(None, num_downs=5, image_size=32, ngf=4) == expected
    f2 = unet_default_filter_cfgs(4, 6)
    f2[5] = f2[6] = 0  # innermost pair elided
    assert M.unet_macs(f2, 6, 64) < M.unet_macs(None, 6, 64, ngf=4)
    assert M.unet_macs(f2, 6, 64) == JM.unet_macs(f2, 6, 64)


def test_mobile_resnet_macs_hand_computed():
    cfg = mobile_resnet_default_cfg(2, 1)
    assert cfg == [2, 4, 8, 8, 8, 4, 2]
    e = 0
    e += 8 * 8 * 2 * 3 * 49              # conv_in 7x7
    e += 4 * 4 * 4 * 2 * 9               # down0
    e += 2 * 2 * 8 * 4 * 9               # down1
    e += 2 * 2 * 8 * 1 * 9 + 2 * 2 * 8 * 8 * 1
    e += 2 * 2 * 8 * 1 * 9 + 2 * 2 * 8 * 8 * 1
    e += 4 * 4 * 4 * 8 * 9               # up0
    e += 8 * 8 * 2 * 4 * 9               # up1
    e += 8 * 8 * 3 * 2 * 49              # conv_out
    assert M.mobile_resnet_macs(cfg, n_blocks=1, image_size=8) == e


def test_sagan_macs_hand_computed():
    f = [16, 8, 4, 2]
    e = 0
    e += 4 * 4 * 16 * 128 * 16          # l1
    e += 8 * 8 * 8 * 16 * 16            # l2
    e += 16 * 16 * 4 * 8 * 16           # l3
    e += 2 * 16 * 16 * 1 * 4 + 16 * 16 * 4 * 4  # attn1
    e += 32 * 32 * 2 * 4 * 16           # l4
    e += 2 * 32 * 32 * 1 * 2 + 32 * 32 * 2 * 2  # attn2
    e += 64 * 64 * 3 * 2 * 16           # last
    assert M.sagan_macs(f, z_dim=128, image_size=64) == e
    assert M.sagan_macs(None, ngf=48) == JM.sagan_macs(None, ngf=48)


def test_srresnet_macs_hand_computed():
    f, nc = [4, 0], 8
    e = 0
    e += 6 * 6 * 8 * 3 * 81              # conv_in 9x9 @6
    e += 6 * 6 * 4 * 8 * 9 + 6 * 6 * 8 * 4 * 9  # block 0
    e += 6 * 6 * 8 * 8 * 9               # conv_mid
    e += 6 * 6 * 32 * 8 * 9              # subpixel 0 @6
    e += 12 * 12 * 32 * 8 * 9            # subpixel 1 @12
    e += 24 * 24 * 3 * 8 * 81            # conv_out @24
    assert M.srresnet_macs(f, n_channels=nc, n_blocks=2, lr_size=6) == e


def _vec(n_keep, width):
    v = np.full(width, 0.1)
    v[:n_keep] = 2.0
    return v


WIDTHS_NORM = [64, 128, 256, 512, 512, 512, 512, 512,
               512, 512, 512, 512, 256, 128, 64, 3]
WIDTHS_SCALE = [128, 256, 512, 512, 512, 512, 512, 512, 512, 512, 256, 128,
                64]
# synthetic score goldens of tests/test_compress.py: (cfg function, keeps)
GOLDEN = {
    "norm": ("unet_norm_cfgs", WIDTHS_NORM,
             [4, 8, 16, 30, 30, 30, 30, 30, 30, 30, 30, 30, 16, 8, 4, 3]),
    "norm_zero_stem": ("unet_norm_cfgs", WIDTHS_NORM,
                       [0, 8, 16, 30, 30, 30, 30, 30, 30, 30, 30, 30, 16, 8,
                        4, 3]),
    "scale": ("unet_scale_cfgs", WIDTHS_SCALE,
              [8, 16, 30, 30, 30, 30, 30, 30, 30, 30, 16, 8, 4]),
    "scale_innermost_cascade": ("unet_scale_cfgs", WIDTHS_SCALE,
                                [8, 16, 30, 30, 30, 30, 0, 30, 30, 30, 16, 8,
                                 4]),
}


@pytest.mark.parametrize("case", sorted(GOLDEN))
def test_unet_cfg_goldens_match_jax(case):
    fn, widths, keeps = GOLDEN[case]
    scores = [_vec(k, w) for k, w in zip(keeps, widths)]
    got = getattr(P, fn)(scores, ngf=64, threshold=1.0, num_downs=8)
    assert got == getattr(JP, fn)(scores, ngf=64, threshold=1.0, num_downs=8)
    if case == "scale_innermost_cascade":
        assert got[0][7] == 0 and got[0][8] == 0


def test_mobile_resnet_cfgs_match_jax():
    layers = {"conv_in": _vec(3, 4), "down_0": _vec(5, 8),
              "up_0": _vec(6, 8), "up_1": _vec(2, 4)}
    for b in range(9):
        layers[f"block_{b}_sep1"] = _vec(b + 1, 16)
    res = _vec(7, 16)
    cfg = P.mobile_resnet_cfgs(layers, res, threshold=1.0)
    assert cfg == JP.mobile_resnet_cfgs(layers, res, threshold=1.0)
    assert all(cfg[4 + 2 * b] == 7 for b in range(9))
    norms = np.full((10, 16), 0.1)
    norms[3, 0] = 5.0
    assert P.mobile_resnet_cfgs_union(layers, norms, 1.0) == \
        JP.mobile_resnet_cfgs_union(layers, norms, 1.0)


def test_reference_cfgs_and_tolerances():
    assert P.cyclegan_reference_cfgs() == JP.cyclegan_reference_cfgs()
    for root in ("database/cityscapes", "database/sr_dataset",
                 "database/celeb", "database/church"):
        assert P.tolerance_for(root) == JP.tolerance_for(root)
    with pytest.raises(RuntimeError):
        P.binary_search_threshold((1.0, 0.0), lambda t: t,
                                  lambda c: 1e9 * c, 5.0, 0.01)
