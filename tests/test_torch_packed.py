"""The port's packed datasets (gcc_tpu_torch/data/packed.py, cli/prepare.py)
against the JAX package's, on the CPU, on tiny written roots.

* The packer writes the same .bin, .idx.npy and gcc_pack.json bytes as
  ``gcc_tpu.data.packed.pack_dataset`` for aligned (resize_and_crop,
  scale_width_and_crop, and a crop that pads past the edge), unaligned
  (split_dataset on), sa and sr (train and a Set5 phase); the CLI writes
  the same root as ``gcc_tpu.cli.prepare``.
* ``PackedDataset`` gives the JAX one's batches bit for bit over an epoch in
  float32 and uint8, reading either package's root, and the port's online
  datasets' batches in float32.
* ``device_normalize`` is within 1 ulp of the host's float32.
* Validation errors name the cause, as the JAX package's do.
"""

import filecmp
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gcc_tpu.cli import prepare as jprepare  # noqa: E402
from gcc_tpu.config import Config as JConfig  # noqa: E402
from gcc_tpu.data import packed as jpacked  # noqa: E402
from gcc_tpu.data.loader import Loader as JLoader  # noqa: E402
from gcc_tpu_torch.cli import prepare  # noqa: E402
from gcc_tpu_torch.config import Config  # noqa: E402
from gcc_tpu_torch.data import build_dataset, packed  # noqa: E402
from gcc_tpu_torch.data.loader import Loader  # noqa: E402
from torch_data_roots import CASES, IDS, cfg_kw, write_root  # noqa: E402
from torch_limits import one_thread  # noqa: E402,F401


def _pack_both(tmp_path, mode, preprocess, split):
    """The root written, then packed by each package: (kw, ours, theirs)."""
    src = write_root(str(tmp_path / "src"), mode, preprocess)
    kw = cfg_kw(src, mode, preprocess, split)
    ours = packed.pack_dataset(Config(**kw), out_dir=str(tmp_path / "ours"),
                               num_threads=2)
    theirs = jpacked.pack_dataset(JConfig(**kw),
                                  out_dir=str(tmp_path / "theirs"),
                                  num_threads=2)
    if mode == "sr":
        packed.pack_dataset(Config(**{**kw, "phase": "Set5"}), out_dir=ours,
                            num_threads=1)
        jpacked.pack_dataset(JConfig(**{**kw, "phase": "Set5"}),
                             out_dir=theirs, num_threads=1)
    return kw, ours, theirs


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    return names


@pytest.mark.parametrize("mode,preprocess,split", CASES, ids=IDS)
def test_packer_writes_the_jax_bytes(tmp_path, mode, preprocess, split):
    _, ours, theirs = _pack_both(tmp_path, mode, preprocess, split)
    names = _same_files(ours, theirs)
    assert packed.PACK_META in names
    assert any(n.endswith(".bin") for n in names)
    assert any(n.endswith(".idx.npy") for n in names)


def _batches(loader):
    return [b for b in loader]


def _same_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert list(g[k]) == list(w[k]), k


def _epoch(loader_cls, ds, seed):
    loader = loader_cls(ds, 2, shuffle=True, num_threads=1, seed=seed)
    loader.set_epoch(3)
    return _batches(loader)


@pytest.mark.parametrize("out_dtype", ["float32", "uint8"])
@pytest.mark.parametrize("mode,preprocess,split", CASES, ids=IDS)
def test_batches_equal_jax_and_cross_read(tmp_path, mode, preprocess, split,
                                          out_dtype):
    """An epoch of each package's PackedDataset, each on the OTHER
    package's root, bit for bit (sr also on its Set5 test phase)."""
    kw, ours, theirs = _pack_both(tmp_path, mode, preprocess, split)
    extra = [{}, {"test_data_name": "Set5"}] if mode == "sr" else [{}]
    for part in ([True, False] if split else [True]):
        for ex in extra:
            if split:
                ex = {**ex, "first_part": part}
            mine = packed.PackedDataset(Config(**{**kw, "dataroot": theirs}),
                                        seed=5, out_dtype=out_dtype, **ex)
            ref = jpacked.PackedDataset(JConfig(**{**kw, "dataroot": ours}),
                                        seed=5, out_dtype=out_dtype, **ex)
            assert len(mine) == len(ref)
            _same_batches(_epoch(Loader, mine, 7), _epoch(JLoader, ref, 7))


@pytest.mark.parametrize("mode,preprocess,split", CASES, ids=IDS)
def test_float32_equals_the_online_dataset(tmp_path, mode, preprocess, split):
    """build_dataset on the packed root gives the online dataset's batches
    (the image folder it was packed from), bit for bit."""
    kw, ours, _ = _pack_both(tmp_path, mode, preprocess, split)
    online = build_dataset(Config(**kw), seed=9)
    pk = build_dataset(Config(**{**kw, "dataroot": ours}), seed=9)
    assert isinstance(pk, packed.PackedDataset) and pk.out_dtype == "float32"
    _same_batches(_epoch(Loader, pk, 1), _epoch(Loader, online, 1))


@pytest.mark.parametrize("mode", ["aligned", "sr"])
def test_device_normalize_within_one_ulp(tmp_path, mode):
    pre = "resize_and_crop" if mode == "aligned" else None
    kw, ours, _ = _pack_both(tmp_path, mode, pre, False)
    cfg = Config(**{**kw, "dataroot": ours})
    f32 = packed.PackedDataset(cfg, seed=2)
    u8 = packed.PackedDataset(cfg, seed=2, out_dtype="uint8")
    for i in range(len(f32)):
        want, raw = f32[i], u8[i]
        keys = [k for k, v in raw.items()
                if isinstance(v, np.ndarray) and v.dtype == np.uint8]
        assert keys
        got = packed.device_normalize(
            {k: torch.from_numpy(raw[k])[None] for k in keys})
        for k in keys:
            g = got[k][0].permute(1, 2, 0).numpy()
            w = want[k]
            assert g.dtype == np.float32 and g.shape == w.shape
            ulp = np.spacing(np.abs(w).astype(np.float32))
            assert (np.abs(g - w) <= ulp).all(), k


def test_cli_prepare_writes_the_jax_root(tmp_path):
    """python -m gcc_tpu_torch.cli.prepare with pix2pix's preset (load 256)
    and a second phase into the same root: gcc_tpu.cli.prepare's bytes, the
    metadata merged."""
    src = tmp_path / "src"
    write_root(str(src), "aligned", "resize_and_crop")
    os.rename(src / "train", src / "val")
    write_root(str(src), "aligned", "resize_and_crop")
    for phase in ("train", "val"):
        args = (f"--dataroot {src} --model pix2pix --phase {phase} "
                f"--num_threads 2").split()
        assert prepare.main(args + ["--pack_output",
                                    str(tmp_path / "ours")]) == 0
        assert jprepare.main(args + ["--pack_output",
                                     str(tmp_path / "theirs")]) == 0
    _same_files(tmp_path / "ours", tmp_path / "theirs")
    with open(tmp_path / "ours" / packed.PACK_META) as f:
        meta = json.load(f)
    assert sorted(meta["phases"]) == ["train", "val"]
    assert meta["phases"]["train"]["load_size"] == 256


def test_validation_errors(tmp_path):
    kw, ours, _ = _pack_both(tmp_path, "aligned", "resize_and_crop", False)
    with pytest.raises(ValueError, match="re-pack"):
        packed.PackedDataset(Config(**{**kw, "dataroot": ours,
                                       "load_size": 32}))
    with pytest.raises(FileNotFoundError, match="no phase 'val'"):
        packed.PackedDataset(Config(**{**kw, "dataroot": ours,
                                       "phase": "val"}))
    with pytest.raises(ValueError, match="dataset_mode"):
        packed.PackedDataset(Config(**{**kw, "dataroot": ours,
                                       "dataset_mode": "unaligned"}))
    with pytest.raises(ValueError, match="cannot pack"):
        packed.pack_dataset(Config(**{**kw, "dataset_mode": "synthetic"}),
                            out_dir=str(tmp_path / "x"))
