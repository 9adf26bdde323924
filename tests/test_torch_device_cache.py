"""The port's device-resident cache (gcc_tpu_torch/data/device_cache.py) and
its routing (data._maybe_device_cache) on the CPU.

* ``DeviceCacheLoader`` gives ``gcc_tpu.data.device_cache``'s batches
  within 1 ulp of the [-1, 1] range with the same paths, for aligned,
  unaligned (random and serial B) and sa; its uint8 crops equal
  ``PackedDataset(out_dtype="uint8")``'s and its float32 ones the host
  path's within 1 ulp of each value; ``InfiniteParams`` gives
  the JAX stream's parameter matrices in the same order.
* The train and val loaders share one copy of the store.
* ``--device_cache``: ``off`` streams, ``on`` caches and raises on a store
  that cannot be cached, ``auto`` caches a store of at most 25 % of the
  card's memory on a card and never on the CPU.
* ``FusedCachedStep`` leaves the same state as the engine's step on the
  materialized batches, with BtoA's swap.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gcc_tpu.config import Config as JConfig  # noqa: E402
from gcc_tpu.data import device_cache as jcache  # noqa: E402
from gcc_tpu.data import packed as jpacked  # noqa: E402
from gcc_tpu_torch.config import Config  # noqa: E402
from gcc_tpu_torch.data import (  # noqa: E402
    _maybe_device_cache, create_split_dataset, packed,
)
from gcc_tpu_torch.data import device_cache  # noqa: E402
from gcc_tpu_torch.data.loader import Loader  # noqa: E402
from torch_data_roots import cfg_kw, write_root  # noqa: E402
from torch_limits import one_thread  # noqa: E402,F401

CACHEABLE = [("aligned", "resize_and_crop", False),
             ("unaligned", "resize_and_crop", False),
             ("unaligned", "resize_and_crop", True),
             ("sa", None, False)]
CACHE_IDS = ["aligned", "unaligned", "unaligned-serial", "sa"]


def _root(tmp_path, mode, preprocess, serial=False, **kw):
    src = write_root(str(tmp_path / "src"), mode, preprocess)
    kw = cfg_kw(src, mode, preprocess, serial_batches=serial, **kw)
    out = packed.pack_dataset(Config(**kw), out_dir=str(tmp_path / "p"),
                              num_threads=2)
    return {**kw, "dataroot": out}


# one float32 ulp of the [-1, 1] range: XLA divides by 255 as a reciprocal
# multiply, which the port's x / 255 need not round alike
RANGE_ULP = float(np.spacing(np.float32(1.0)))


def _ulp_close(got: np.ndarray, want: np.ndarray, what: str,
               atol: float = None):
    """Within 1 ulp of each value (atol None: the port against its own host
    path), or within atol."""
    assert got.shape == want.shape, what
    tol = np.spacing(np.abs(want).astype(np.float32)) if atol is None \
        else atol
    assert (np.abs(got - want) <= tol).all(), what


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("mode,preprocess,serial", CACHEABLE, ids=CACHE_IDS)
def test_batches_match_jax_and_the_host_path(tmp_path, mode, preprocess,
                                             serial):
    kw = _root(tmp_path, mode, preprocess, serial)
    ours = device_cache.DeviceCacheLoader(
        packed.PackedDataset(Config(**kw), seed=3), 2, "cpu", seed=3)
    theirs = jcache.DeviceCacheLoader(
        jpacked.PackedDataset(JConfig(**kw), seed=3), 2,
        dtype=np.float32, seed=3)
    host = Loader(packed.PackedDataset(Config(**kw), seed=3,
                                       out_dtype="uint8"), 2, seed=3,
                  num_threads=1)
    host_f32 = Loader(packed.PackedDataset(Config(**kw), seed=3), 2, seed=3,
                      num_threads=1)
    for ld in (ours, theirs, host, host_f32):
        ld.set_epoch(2)
    # the uint8 crops against the host's uint8 path, on a second loader
    # over the same stream
    crops = device_cache.DeviceCacheLoader(
        packed.PackedDataset(Config(**kw), seed=3), 2, "cpu", seed=3)
    crops.set_epoch(2)
    n = 0
    for a, b, h, hf, (args, paths) in zip(ours, theirs, host, host_f32,
                                          crops.iter_param_batches()):
        assert sorted(a) == sorted(b)
        for k, v in b.items():
            if isinstance(v, list):
                assert a[k] == v == h[k] == paths[k], k
            elif k == "z":
                np.testing.assert_array_equal(a[k].numpy(), np.asarray(v))
            else:
                assert a[k].dtype == torch.float32
                _ulp_close(_nhwc(a[k]), np.asarray(v), k, RANGE_ULP)
                _ulp_close(_nhwc(a[k]), hf[k], k)
        for k, v in crops.crops(args).items():
            np.testing.assert_array_equal(v.numpy(), h[k], err_msg=k)
        n += 1
    assert n == len(ours) > 0


def test_infinite_params_follow_jax(tmp_path):
    kw = _root(tmp_path, "unaligned", "resize_and_crop")
    ours = device_cache.InfiniteParams(device_cache.DeviceCacheLoader(
        packed.PackedDataset(Config(**kw), seed=1), 2, "cpu", seed=1))
    theirs = jcache.InfiniteParams(jcache.DeviceCacheLoader(
        jpacked.PackedDataset(JConfig(**kw), seed=1), 2, dtype=np.float32,
        seed=1))
    for _ in range(9):  # past two epochs of 3 batches
        (a,), pa = next(ours)
        (b,), pb = next(theirs)
        np.testing.assert_array_equal(a, b)
        assert pa == pb
    ours.close()


def test_split_loaders_share_the_store(tmp_path):
    kw = _root(tmp_path, "aligned", "resize_and_crop", batch_size=2,
               device_cache="on")
    tl, vl = create_split_dataset(Config(**kw), seed=0, device="cpu")
    assert isinstance(tl, device_cache.DeviceCacheLoader)
    assert isinstance(vl, device_cache.DeviceCacheLoader)
    for k in ("A", "B"):
        assert tl._data[k] is vl._data[k]
    assert tl.seed == 0 and vl.seed == 1 and tl.drop_last


@pytest.mark.parametrize("mode,preprocess", [("sr", None),
                                             ("aligned", "crop")],
                         ids=["sr", "crop-pad"])
def test_on_raises_on_a_store_it_cannot_cache(tmp_path, mode, preprocess):
    kw = _root(tmp_path, mode, preprocess)
    ds = packed.PackedDataset(Config(**kw), seed=0, out_dtype="uint8")
    assert not ds.device_cacheable()
    with pytest.raises(ValueError, match="not device-cacheable"):
        _maybe_device_cache(ds, Config(**{**kw, "device_cache": "on"}), 0,
                            False, "cpu", None)
    for mode in ("auto", "off"):
        assert _maybe_device_cache(ds, Config(**{**kw, "device_cache": mode}),
                                   0, False, "cpu", None) is None


def test_auto_rules(tmp_path, monkeypatch):
    """auto: never on the CPU; on a card, a store of at most 25 % of its
    memory (device_hbm_bytes patched: the CPU has no card)."""
    from gcc_tpu_torch.utils import memory_guard
    kw = _root(tmp_path, "aligned", "resize_and_crop")
    cfg = Config(**{**kw, "device_cache": "auto"})
    ds = packed.PackedDataset(cfg, seed=0, out_dtype="uint8")
    n = ds.total_bytes()
    assert _maybe_device_cache(ds, cfg, 0, False, "cpu", None) is None
    made = []
    monkeypatch.setattr(device_cache, "DeviceCacheLoader",
                        lambda *a, **k: made.append((a, k)) or "cached")
    monkeypatch.setattr(memory_guard, "device_hbm_bytes",
                        lambda d=None: (4 * n - 1, "patched"))
    assert _maybe_device_cache(ds, cfg, 0, False, "cuda", None) is None
    monkeypatch.setattr(memory_guard, "device_hbm_bytes",
                        lambda d=None: (4 * n, "patched"))
    assert _maybe_device_cache(ds, cfg, 0, False, "cuda", None) == "cached"
    assert made[0][0][2] == torch.device("cuda")
    off = Config(**{**kw, "device_cache": "off"})
    assert _maybe_device_cache(ds, off, 0, False, "cuda", None) is None


@pytest.mark.parametrize("direction", ["AtoB", "BtoA"])
def test_fused_step_equals_the_engine_step(tmp_path, direction):
    """FusedCachedStep.train_arch_step == engine.train_arch_step on the
    loaders' materialized (and swapped) batches, from the same state."""
    from gcc_tpu_torch.engines.pix2pix import Pix2PixEngine
    kw = _root(tmp_path, "aligned", "resize_and_crop", batch_size=2,
               load_size=36, crop_size=32)
    kw.update(model="pix2pix", backbone="resnet", ngf=4, ndf=4,
              teacher_ngf=4, teacher_ndf=4, online_distillation=True,
              darts_discriminator=True, lambda_content=1.0, lambda_gram=1.0,
              direction=direction, device_cache="on")
    cfg = Config(**kw)
    runs = []
    for fused in (True, False):
        engine = Pix2PixEngine(cfg, device="cpu")
        state = engine.init_state(seed=0)
        tl, vl = create_split_dataset(cfg, seed=0, device="cpu")
        step = device_cache.FusedCachedStep(engine, tl, vl,
                                            swap_ab=direction == "BtoA")
        vstream = device_cache.InfiniteParams(vl)
        for targs, _ in tl.iter_param_batches():
            vargs, _ = next(vstream)
            if fused:
                state, m = step.train_arch_step(state, targs, vargs, 2e-4,
                                                0.9, 1e-4)
            else:
                b, v = tl.materialize(targs), vl.materialize(vargs)
                if direction == "BtoA":
                    b["A"], b["B"] = b["B"], b["A"]
                    v["A"], v["B"] = v["B"], v["A"]
                state, m = engine.train_arch_step(state, b, v, 2e-4, 0.9,
                                                  1e-4)
        runs.append(state.state_dict())
    a, b = runs
    for net in a["nets"]:
        for name, t in a["nets"][net].items():
            np.testing.assert_array_equal(t, b["nets"][net][name],
                                          err_msg=f"{net}.{name}")
