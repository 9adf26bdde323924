"""The port's data path against Pillow and the JAX package, on the CPU.

* ``data.resample``: bit for bit against ``PIL.Image.resize`` (BICUBIC and
  BILINEAR, RGB and L) over a grid of up- and down-scales, and a hypothesis
  sweep of sizes.
* ``transforms``: crop past the border and every preprocess mode against
  ``gcc_tpu.data.transforms`` on PIL images.
* Datasets: ``SyntheticDataset`` (aligned, unaligned, sa, sr),
  ``AlignedDataset``, ``UnalignedDataset``, ``SADataset`` and ``SRDataset``
  from a folder of PNGs (crop and flip draws, random B, train and test
  crops) give ``gcc_tpu.data``'s items bit for bit.
* ``Loader``: the batch order of every ``set_epoch`` equals JAX's.
* ``pixel_fid`` equals ``gcc_tpu.eval.orchestrators.pixel_fid`` within
  1e-9 relative; the PNG writer's files decode to the saved pixels.
"""

import os

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st
from PIL import Image

torch = pytest.importorskip("torch")

from gcc_tpu.config import Config as JConfig  # noqa: E402
from gcc_tpu.data import datasets as jdatasets  # noqa: E402
from gcc_tpu.data import transforms as jtransforms  # noqa: E402
from gcc_tpu.data.loader import Loader as JLoader  # noqa: E402
from gcc_tpu.eval.orchestrators import pixel_fid as jpixel_fid  # noqa: E402
from gcc_tpu_torch.config import Config  # noqa: E402
from gcc_tpu_torch.data import create_split_dataset  # noqa: E402
from gcc_tpu_torch.data import datasets, transforms  # noqa: E402
from gcc_tpu_torch.data.loader import InfiniteLoader, Loader  # noqa: E402
from gcc_tpu_torch.data.resample import BICUBIC, BILINEAR, resize  # noqa: E402
from gcc_tpu_torch.eval.orchestrators import pixel_fid  # noqa: E402
from gcc_tpu_torch.utils.image import png_bytes, save_images  # noqa: E402
from torch_limits import one_thread  # noqa: E402,F401

PIL_METHOD = {BICUBIC: Image.BICUBIC, BILINEAR: Image.BILINEAR}
IN_SIZES = [(8, 8), (17, 29), (64, 32), (256, 512), (1, 7)]
OUT_SIZES = [(8, 8), (3, 100), (1, 1), (32, 16), (286, 286), (7, 5)]


def _pil_resize(a, size, method):
    return np.asarray(Image.fromarray(a).resize(size, PIL_METHOD[method]))


@pytest.mark.parametrize("method", [BICUBIC, BILINEAR])
@pytest.mark.parametrize("hw", IN_SIZES, ids=str)
def test_resample_matches_pil_grid(method, hw):
    rng = np.random.RandomState(hash(hw) % 2 ** 31)
    for gray in (False, True):
        shape = hw if gray else hw + (3,)
        a = (rng.rand(*shape) * 255).astype(np.uint8)
        for size in OUT_SIZES:
            got, ref = resize(a, size, method), _pil_resize(a, size, method)
            assert got.dtype == np.uint8 and got.shape == ref.shape
            np.testing.assert_array_equal(got, ref, err_msg=f"{hw}->{size}")


@settings(max_examples=40, deadline=None)
@given(h=st.integers(1, 70), w=st.integers(1, 70), oh=st.integers(1, 90),
       ow=st.integers(1, 90), method=st.sampled_from([BICUBIC, BILINEAR]),
       seed=st.integers(0, 2 ** 16))
def test_resample_matches_pil_sweep(h, w, oh, ow, method, seed):
    a = (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)
    np.testing.assert_array_equal(resize(a, (ow, oh), method),
                                  _pil_resize(a, (ow, oh), method))


def test_crop_matches_pil():
    a = (np.random.RandomState(1).rand(20, 30, 3) * 255).astype(np.uint8)
    pil = Image.fromarray(a)
    for box in [(0, 0, 15, 20), (5, 3, 25, 18), (-4, -2, 10, 9),
                (20, 10, 40, 30)]:
        np.testing.assert_array_equal(transforms.crop(a, box),
                                      np.asarray(pil.crop(box)))


@pytest.mark.parametrize("preprocess", ["resize_and_crop", "scale_width",
                                        "scale_width_and_crop", "crop",
                                        "none"])
def test_transforms_match_jax(preprocess):
    a = (np.random.RandomState(2).rand(37, 51, 3) * 255).astype(np.uint8)
    kw = dict(preprocess=preprocess, load_size=40, crop_size=32,
              no_flip=False)
    cfg, jcfg = Config(**kw), JConfig(**kw)
    for seed in range(4):
        got = transforms.apply_transform(cfg, a,
                                         rng=np.random.RandomState(seed))
        ref = jtransforms.apply_transform(jcfg, Image.fromarray(a),
                                          rng=np.random.RandomState(seed))
        np.testing.assert_array_equal(got, ref)
        params = transforms.get_params(cfg, (51, 37),
                                       np.random.RandomState(seed))
        assert params == jtransforms.get_params(jcfg, (51, 37),
                                                np.random.RandomState(seed))
        np.testing.assert_array_equal(
            transforms.apply_transform(cfg, a, params),
            jtransforms.apply_transform(jcfg, Image.fromarray(a), params))


def _same_items(port_ds, jax_ds):
    assert len(port_ds) == len(jax_ds)
    for i in range(len(port_ds)):
        p, j = port_ds[i], jax_ds[i]
        assert p.keys() == j.keys()
        for k in p:
            if isinstance(p[k], np.ndarray):
                assert p[k].dtype == j[k].dtype, k
                np.testing.assert_array_equal(p[k], j[k], err_msg=k)
            else:
                assert p[k] == j[k], k


@pytest.mark.parametrize("model,size", [("pix2pix", 32), ("sagan", 64),
                                        ("pix2pix", 256), ("cyclegan", 32),
                                        ("srgan", 96)])
def test_synthetic_dataset_matches_jax(model, size):
    kw = dict(model=model, dataset_mode="synthetic", crop_size=size,
              image_size=size, z_dim=16, max_dataset_size=5)
    _same_items(datasets.SyntheticDataset(Config(**kw), seed=3),
                jdatasets.SyntheticDataset(JConfig(**kw), seed=3))


def _write_pngs(root, n, w, h):
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(0)
    for i in range(n):
        arr = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(root, f"img_{i:03d}.png"))


@pytest.mark.parametrize("preprocess,flip", [("resize_and_crop", True),
                                             ("scale_width_and_crop", True),
                                             ("none", False)])
def test_aligned_dataset_matches_jax(tmp_path, preprocess, flip):
    _write_pngs(str(tmp_path / "train"), 4, 90, 41)
    kw = dict(dataroot=str(tmp_path), phase="train", load_size=40,
              crop_size=32, no_flip=not flip, preprocess=preprocess,
              max_dataset_size=3)
    _same_items(datasets.AlignedDataset(Config(**kw), seed=5),
                jdatasets.AlignedDataset(JConfig(**kw), seed=5))


@pytest.mark.parametrize("center", [False, True])
def test_sa_dataset_matches_jax(tmp_path, center):
    _write_pngs(str(tmp_path / "train"), 3, 178, 218)
    kw = dict(dataroot=str(tmp_path), phase="train", crop_size=64,
              center_crop=center, z_dim=8)
    _same_items(datasets.SADataset(Config(**kw), seed=2),
                jdatasets.SADataset(JConfig(**kw), seed=2))


@pytest.mark.parametrize("serial,split", [(False, False), (True, False),
                                          (False, True)])
def test_unaligned_dataset_matches_jax(tmp_path, serial, split):
    _write_pngs(str(tmp_path / "trainA"), 5, 45, 40)
    _write_pngs(str(tmp_path / "trainB"), 3, 37, 50)
    kw = dict(dataroot=str(tmp_path), phase="train", load_size=36,
              crop_size=32, serial_batches=serial, split_dataset=split)
    ours = datasets.UnalignedDataset(Config(**kw), seed=6)
    theirs = jdatasets.UnalignedDataset(JConfig(**kw), seed=6)
    assert len(ours) == len(theirs) == (2 if split else 5)
    _same_items(ours, theirs)


@pytest.mark.parametrize("phase,test_set", [("train", None), ("val", None),
                                            ("train", "Set5")])
def test_sr_dataset_matches_jax(tmp_path, phase, test_set):
    for folder in ("train", "val", "Set5"):
        _write_pngs(str(tmp_path / folder), 3, 103, 98)
    kw = dict(dataroot=str(tmp_path), phase=phase, image_size=96,
              upscale_factor=4)
    ours = datasets.SRDataset(Config(**kw), seed=1, test_data_name=test_set)
    theirs = jdatasets.SRDataset(JConfig(**kw), seed=1,
                                 test_data_name=test_set)
    assert ours.split == theirs.split
    _same_items(ours, theirs)


def test_loader_epoch_order_matches_jax():
    cfg = Config(dataset_mode="synthetic", crop_size=8, max_dataset_size=11)
    jcfg = JConfig(dataset_mode="synthetic", crop_size=8,
                   max_dataset_size=11)
    for drop_last in (False, True):
        ours = Loader(datasets.SyntheticDataset(cfg), 3, seed=7,
                      num_threads=3, drop_last=drop_last)
        theirs = JLoader(jdatasets.SyntheticDataset(jcfg), 3, seed=7,
                         num_threads=3, drop_last=drop_last)
        for epoch in (None, 1, 2, 5):
            if epoch is not None:
                ours.set_epoch(epoch)
                theirs.set_epoch(epoch)
            got = [b["A_paths"] for b in ours]
            assert got == [b["A_paths"] for b in theirs]
            assert len(got) == len(ours)
        assert [len(p) for p in got] == ([3, 3, 3] if drop_last
                                         else [3, 3, 3, 2])


def test_split_loaders_and_infinite_stream():
    cfg = Config(dataset_mode="synthetic", crop_size=8, max_dataset_size=5,
                 batch_size=2, num_threads=2)
    train, val = create_split_dataset(cfg, seed=4)
    assert (train.seed, val.seed) == (4, 5) and train.drop_last
    val.set_epoch(3)  # each pass of the stream replays epoch 3's order
    stream = InfiniteLoader(val)
    try:
        names = [next(stream)["A_paths"] for _ in range(5)]
    finally:
        stream.close()
    assert all(len(n) == 2 for n in names) and names[:2] == names[2:4]


def test_pixel_fid_matches_jax():
    rng = np.random.RandomState(0)
    fakes = np.tanh(rng.randn(24, 32, 32, 3)).astype(np.float32)
    reals = np.tanh(rng.randn(24, 32, 32, 3) + 0.3).astype(np.float32)
    got, ref = pixel_fid(fakes, reals), jpixel_fid(fakes, reals)
    assert np.isfinite(got) and abs(got - ref) <= 1e-9 * abs(ref)


def test_png_writer_decodes_to_the_pixels(tmp_path):
    a = (np.random.RandomState(3).rand(13, 7, 3) * 255).astype(np.uint8)
    path = tmp_path / "x.png"
    path.write_bytes(png_bytes(a))
    np.testing.assert_array_equal(np.asarray(Image.open(path)), a)
    visual = np.tanh(np.random.RandomState(4).randn(1, 16, 12, 3))
    save_images(str(tmp_path / "out"), {"fake_B": visual}, "dir/img_3.jpg",
                aspect_ratio=1.5)
    im = np.asarray(Image.open(tmp_path / "out" / "img_3_fake_B.png"))
    assert im.shape == (24, 12, 3)
