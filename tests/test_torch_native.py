"""The port's native image engine (gcc_tpu_torch/native) on the CPU.

* ``transform_batch`` and ``resize_bicubic`` equal ``gcc_tpu.native``'s bit
  for bit (the same source algorithm, the same g++ flags), and the resize is
  within one uint8 level of ``data.resample`` (Pillow's, bit for bit).
* ``--native_loader`` routes the aligned and unaligned datasets'
  resize_and_crop through the engine with the numpy path's draws: the JAX
  package's native items bit for bit, the numpy path's within one level.
* A failed build raises with the compiler's output.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gcc_tpu import native as jnative  # noqa: E402
from gcc_tpu.config import Config as JConfig  # noqa: E402
from gcc_tpu.data import build_dataset as jbuild_dataset  # noqa: E402
from gcc_tpu_torch import native  # noqa: E402
from gcc_tpu_torch.config import Config  # noqa: E402
from gcc_tpu_torch.data import build_dataset  # noqa: E402
from gcc_tpu_torch.data.resample import BICUBIC, resize  # noqa: E402
from torch_data_roots import cfg_kw, write_root  # noqa: E402
from torch_limits import one_thread  # noqa: E402,F401

LEVEL = 2.0 / 255.0  # one uint8 level in [-1, 1]


@pytest.fixture(scope="module", autouse=True)
def _built(tmp_path_factory):
    """Both engines built; the JAX package's into a directory of this
    module's own, so no other test process's build of its library (next to
    its source) races this one."""
    native.library()
    lib = tmp_path_factory.mktemp("jax_native") / "libgcc_image.so"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_LIB", str(lib))
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jnative, "_build_failed", False)
        if not jnative.available():
            pytest.fail("gcc_tpu.native did not build with g++")
        yield


def _images(seed, n=6):
    rng = np.random.RandomState(seed)
    sizes = [(30, 40), (17, 23), (64, 48), (24, 24), (50, 13), (9, 70)]
    return [(rng.rand(h, w, 3) * 255).astype(np.uint8)
            for h, w in sizes[:n]]


@pytest.mark.parametrize("load,crop", [(24, 16), (32, 32), (12, 8)])
def test_transform_batch_equals_jax(load, crop):
    imgs = _images(load)
    rng = np.random.RandomState(crop)
    pos = [(rng.randint(0, load - crop + 1), rng.randint(0, load - crop + 1))
           for _ in imgs]
    flips = [bool(i % 2) for i in range(len(imgs))]
    ours = native.transform_batch(imgs, load, crop, pos, flips, num_threads=3)
    theirs = jnative.transform_batch(imgs, load, crop, pos, flips,
                                     num_threads=2)
    assert ours.dtype == np.float32 and ours.shape == (len(imgs), crop,
                                                       crop, 3)
    np.testing.assert_array_equal(ours, theirs)


def test_resize_equals_jax_and_within_a_level_of_pillow():
    for img in _images(1):
        for oh, ow in ((24, 24), (7, 31), (80, 16)):
            ours = native.resize_bicubic(img, oh, ow)
            np.testing.assert_array_equal(ours,
                                          jnative.resize_bicubic(img, oh, ow))
            exact = resize(img, (ow, oh), BICUBIC)
            assert np.abs(ours.astype(int) - exact.astype(int)).max() <= 1


@pytest.mark.parametrize("mode", ["aligned", "unaligned"])
def test_native_loader_items(tmp_path, mode):
    src = write_root(str(tmp_path / "src"), mode, "resize_and_crop")
    kw = cfg_kw(src, mode, "resize_and_crop", native_loader=True)
    ours = build_dataset(Config(**kw), seed=4)
    theirs = jbuild_dataset(JConfig(**kw), seed=4)
    plain = build_dataset(Config(**{**kw, "native_loader": False}), seed=4)
    for i in range(len(ours)):
        a, b, p = ours[i], theirs[i], plain[i]
        for k in ("A", "B"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert np.abs(a[k] - p[k]).max() <= LEVEL + 1e-6, k
            assert a[k + "_paths"] == p[k + "_paths"]


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "image_ops.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        native.build()
    assert "error" in str(e.value)
