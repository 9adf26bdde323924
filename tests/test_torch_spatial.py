"""The port's row-sharded eval (gcc_tpu_torch/parallel/spatial.py) on the
CPU: one spawn of 4 Gloo ranks runs every sharded case
(tests/torch_spatial_workers.py), and each is held here, at
tests/test_parallel.py's atol = rtol = 1e-5, against

* the port's unsharded forward of the same net (every rank returns the
  full output, the same bits on every rank);
* for SRResNet (8 channels, 2 blocks), MobileResnet (ngf 4, 2 blocks) and
  the U-Net (ngf 4, 5 downs, no dropout; its height falls to 1 row, below
  the shard count), at 32 px, batch 2, on 1x2, 1x4 and 2x2 meshes, also
  against gcc_tpu's apply and gcc_tpu's own spatial_apply on make_mesh_2d(2,
  2) over the 8 CPU devices, with the weights carried across by
  utils/weights.py.

Engine level: SRGAN's generate_spatial at 4 shards (2-row shards under 9x9
convs, whose halo of 4 rows is wider than a shard), a 12-row image on 3-row
shards, a 10-row image whose 4 shards are lowered to 2; CycleGAN both
directions, student and teacher; pix2pix resnet with the fused blocks on,
which takes the unfused blocks under the view (logged once); SAGAN refuses.
An explicit mesh that does not divide the batch or the height raises
gcc_tpu's ValueError; without a process group the count degrades to 1 with
gcc_tpu's warning. cli.test over 2 Gloo ranks with --spatial_shards 2
writes the images of the unsharded cli.test.
"""

import logging
import os
import pickle
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_spatial_workers as W  # noqa: E402

from gcc_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from gcc_tpu_torch.parallel import spatial  # noqa: E402
from gcc_tpu_torch.utils.weights import export_jax_variables  # noqa: E402
from torch_limits import one_thread, spawn_within  # noqa: E402,F401

TOL = dict(atol=1e-5, rtol=1e-5)  # tests/test_parallel.py's
WORLD = 4


@pytest.fixture(scope="module")
def ranks():
    """Every rank's results of one spawn of 4 Gloo ranks."""
    with tempfile.TemporaryDirectory() as out:
        with spawn_within(120, "the four ranks of the ranks fixture"):
            pmesh.spawn(W.spatial_job, WORLD, args=(out,), threads=1,
                        timeout=120.0)
        res = []
        for r in range(WORLD):
            with open(os.path.join(out, f"{r}.pkl"), "rb") as f:
                res.append(pickle.load(f))
    return res


def _jax_net(name):
    from gcc_tpu.models.generators import (
        MobileResnetGenerator, SRResNet, UnetGenerator)
    return {"srresnet": lambda: SRResNet(n_channels=8, n_blocks=2),
            "mobile_resnet": lambda: MobileResnetGenerator(ngf=4, n_blocks=2),
            "unet": lambda: UnetGenerator(ngf=4, num_downs=5,
                                          use_dropout=False)}[name]()


@pytest.fixture(scope="module")
def jax_refs():
    """gcc_tpu's unsharded apply and its spatial_apply over a 2x2 mesh of
    the CPU devices, of the port's nets' weights, NCHW."""
    import jax
    import jax.numpy as jnp

    from gcc_tpu.parallel import make_mesh_2d, spatial_apply
    x = jnp.asarray(W.image(2, 32, 32, seed=3).numpy().transpose(0, 2, 3, 1))
    mesh = make_mesh_2d(2, 2)
    out = {}
    for name in W.NETS:
        g = _jax_net(name)
        v = jax.tree_util.tree_map(jnp.asarray,
                                   export_jax_variables(W.build_net(name)))
        apply = jax.jit(lambda v, x, g=g: g.apply(v, x, train=False))
        out[name] = {
            "apply": np.asarray(apply(v, x)).transpose(0, 3, 1, 2),
            "spatial_apply": np.asarray(spatial_apply(
                g, v, x, mesh)).transpose(0, 3, 1, 2)}
    return out


def test_auto_shards_equals_gcc_tpu():
    from gcc_tpu.parallel.spatial import auto_shards
    for h in range(1, 80):
        for n in range(0, 10):
            assert spatial.auto_shards(h, n) == auto_shards(h, n), (h, n)


@pytest.mark.parametrize("name", list(W.NETS))
def test_sharded_nets_equal_unsharded_and_gcc_tpu(name, ranks, jax_refs):
    plain = ranks[0]["plain"][name]
    for shape in list(W.MESHES) + ["n_spatial=8"]:
        got = ranks[0]["nets"][(name, shape)]
        for r in range(1, WORLD):  # the full output on every rank
            np.testing.assert_array_equal(ranks[r]["nets"][(name, shape)],
                                          got)
        np.testing.assert_allclose(got, plain, **TOL)
        np.testing.assert_allclose(got, jax_refs[name]["apply"], **TOL)
        np.testing.assert_allclose(got, jax_refs[name]["spatial_apply"],
                                   **TOL)


def test_output_padding_past_the_inputs_and_an_unsplit_stride(ranks):
    got = ranks[0]["nets"][("odd_layers", (1, 2))]
    assert got.shape == (2, 3, 17, 13)
    np.testing.assert_allclose(got, ranks[0]["plain"]["odd_layers"], **TOL)


def test_counters(ranks):
    """Halos went through the all-gathers; InstanceNorm's sums through the
    all-reduces (two a norm: MobileResnet's, not the BatchNormed nets');
    the U-Net gathered at its bottleneck. A rank outside a 1x2 grid put
    nothing in."""
    c = ranks[0]["counters"]
    for name in W.NETS:
        for shape in W.MESHES:
            assert c[(name, shape)]["halo_calls"] > 0
            assert c[(name, shape)]["gather_calls"] >= 1
    # MobileResnet: 3 + 4 per block (two separable convs, each with its own
    # norm inside) + 2 instance norms, 2 sums each
    assert c[("mobile_resnet", (1, 4))]["stat_calls"] == 2 * (3 + 4 * 2 + 2)
    assert c[("srresnet", (1, 4))]["stat_calls"] == 0
    # the U-Net at 4 shards: the 2-row down output gathered, 1 output gather
    assert c[("unet", (1, 4))]["gather_calls"] == 2
    assert c[("unet", (1, 2))]["gather_calls"] == 2  # the 1-row bottleneck
    assert all(v == 0 for v in ranks[3]["counters"][("unet",
                                                     (1, 2))].values())


@pytest.mark.parametrize("case", list(W.SRGAN_CASES))
def test_srgan_generate_spatial(case, ranks):
    sharded, plain = ranks[0]["engines"][case]
    h = W.SRGAN_CASES[case][0]
    assert sharded.shape == (1, 3, 4 * h, 4 * h)
    np.testing.assert_allclose(sharded, plain, **TOL)
    for r in range(1, WORLD):
        np.testing.assert_array_equal(ranks[r]["engines"][case][0], sharded)


@pytest.mark.parametrize("direction", ["AtoB", "BtoA"])
@pytest.mark.parametrize("teacher", [False, True])
def test_cyclegan_generate_spatial(direction, teacher, ranks):
    sharded, plain = ranks[0]["engines"][("cyclegan", direction, teacher)]
    np.testing.assert_allclose(sharded, plain, **TOL)


def test_pix2pix_fused_takes_unfused_blocks(ranks):
    sharded, plain = ranks[0]["engines"]["pix2pix_fused"]
    np.testing.assert_allclose(sharded, plain, **TOL)
    under_scope, unsharded = ranks[0]["fused_calls"]
    assert under_scope == 0 and unsharded > 0
    lines = [ln for ln in ranks[0]["log"]
             if "MobileResnet runs its unfused blocks" in ln]
    assert len(lines) == 1


def test_sagan_refuses():
    from gcc_tpu_torch.config import Config
    from gcc_tpu_torch.engines.sagan import SAGANEngine
    eng = SAGANEngine(Config(model="sagan", ngf=4, ndf=4, z_dim=8),
                      device="cpu")
    with pytest.raises(ValueError, match="no spatial axis"):
        eng.generate_spatial(None, torch.zeros(1, 8), n_spatial=2)


def test_explicit_mesh_validated_and_count_lowered(ranks):
    errors = ranks[0]["errors"]
    assert "height 10 not divisible by mesh (data=1, spatial=4)" \
        in errors["height"]
    assert "batch 3 / height 8 not divisible by mesh (data=2, spatial=2)" \
        in errors["batch"]
    assert ("spatial_apply: 8 shards requested but only 4 ranks; "
            "degrading to 4") in ranks[0]["log"]


def test_no_group_degrades_with_warning(caplog):
    net = W.build_net("srresnet")
    x = W.image(1, 8, 8, seed=9)
    with caplog.at_level(logging.WARNING, logger="gcc-tpu-torch"):
        got = spatial.spatial_apply(net, x, n_spatial=2)
    assert ("spatial_apply: 2 shards requested but only 1 ranks; "
            "degrading to 1") in caplog.text
    with torch.no_grad():
        torch.testing.assert_close(got, net(x)[0], atol=0, rtol=0)


def test_batchnorm_train_mode_refused_under_the_view():
    from gcc_tpu_torch.ops.layers import BatchNorm
    bn = BatchNorm(3)
    view = spatial.Rows(None, 2, 0, spatial.SpatialMesh(1, 2, 0, 2))
    with spatial.scope(view), pytest.raises(RuntimeError, match="eval only"):
        bn(torch.zeros(1, 3, 4, 4))


def test_cli_test_sharded_writes_the_unsharded_images(tmp_path):
    """cli.test --gpu_ids -1 --mesh_shape 2 --spatial_shards 2 against the
    unsharded cli.test of the same checkpoint: the same decoded pixels and
    the same metric; in one process the flag degrades with the warning."""
    from PIL import Image

    from gcc_tpu_torch.cli import test as ttest
    from gcc_tpu_torch.config import Config
    from gcc_tpu_torch.engines.pix2pix import Pix2PixEngine
    from gcc_tpu_torch.utils.checkpoint import save_checkpoint
    eng = Pix2PixEngine(Config(model="pix2pix", ngf=4, ndf=4, num_downs=5,
                               crop_size=32, load_size=32), device="cpu")
    ck = str(tmp_path / "g.ckpt")
    save_checkpoint(ck, eng.checkpoint_payload(eng.init_state(seed=0), 1))
    base = (f"--dataroot synthetic --dataset_mode synthetic --model pix2pix "
            f"--ngf 4 --ndf 4 --num_downs 5 --crop_size 32 --load_size 32 "
            f"--max_dataset_size 3 --num_threads 1 --pretrain_path {ck} "
            f"--checkpoints_dir {tmp_path} --gpu_ids -1")
    for name, flags in (("plain", ""), ("one", " --spatial_shards 2"),
                        ("two", " --mesh_shape 2 --spatial_shards 2")):
        with spawn_within(120, f"test_cli_spatial_shards: {name}"):
            assert ttest.main(f"{base} --name {name}{flags}".split()) == 0
    logs = {n: (tmp_path / n / "logger.log").read_text()
            for n in ("plain", "one", "two")}
    assert ("spatial_apply: 2 shards requested but only 1 ranks; "
            "degrading to 1") in logs["one"]
    assert ("spatial partitioning: image rows sharded up to 2-way "
            "(auto-reduced per image height)") in logs["two"]
    metric = {n: [ln.split("metrics: ")[1] for ln in log.splitlines()
                  if "metrics: " in ln] for n, log in logs.items()}
    assert metric["plain"] and metric["two"] == metric["plain"] \
        == metric["one"]
    files = sorted(os.listdir(tmp_path / "plain" / "test_results"))
    assert len(files) == 3 * 3
    for n in ("one", "two"):
        assert sorted(os.listdir(tmp_path / n / "test_results")) == files
        for f in files:
            np.testing.assert_array_equal(
                np.asarray(Image.open(tmp_path / n / "test_results" / f)),
                np.asarray(Image.open(tmp_path / "plain" / "test_results"
                                      / f)))
