"""Packed pre-decoded datasets (port of gcc_tpu/data/packed.py).

The reference feeds training from a torch DataLoader that decodes and
resamples every image every epoch (data/__init__.py:61-91). This module runs
the DETERMINISTIC transform prefix once, offline (decode + resize /
center-crop), stores the result as raw uint8 blobs that mmap straight out of
the page cache, and keeps only the cheap randomized remainder (crop / flip /
pairing / z) online.

  * pack_dataset(cfg)   -- offline packer (python -m gcc_tpu_torch.cli.prepare)
  * PackedDataset       -- drop-in dataset; build_dataset selects it when
                           --dataroot is a packed root (a directory holding
                           gcc_pack.json)
  * device_normalize    -- uint8 NHWC -> float32 NCHW on the batch's device,
                           so host->device moves 4x fewer bytes than float32

Resampling goes through ``resample.resize`` (Pillow's algorithm, bit for
bit), so a root packed here is byte-identical to one packed by the JAX
package, and each package reads the other's. Per-sample semantics, including
the rng draw ORDER, match the online datasets (data/datasets.py) bit for bit
on the float32 path.

Layout of a packed root:
  gcc_pack.json            # format marker + per-phase metadata and paths
  <phase>.<key>.bin        # concatenated raw uint8 HWC images
  <phase>.<key>.idx.npy    # int64 (n, 6): offset h w c orig_w orig_h
"""

from __future__ import annotations

import concurrent.futures as futures
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from gcc_tpu_torch.data.image_folder import make_dataset
from gcc_tpu_torch.data.resample import BICUBIC, BILINEAR, resize
from gcc_tpu_torch.data.rng import LockedRandomState
from gcc_tpu_torch.data.transforms import (
    center_crop, crop, make_power_2, scale_width, size_of,
)
from gcc_tpu_torch.metrics.vgg import IMAGENET_MEAN, IMAGENET_STD

PACK_META = "gcc_pack.json"
PACK_FORMAT = 1


def is_packed_root(path: str) -> bool:
    return bool(path) and os.path.isfile(os.path.join(path, PACK_META))


# --------------------------------------------------------------------------
# packer
# --------------------------------------------------------------------------

def _det_prefix(cfg, img: np.ndarray) -> np.ndarray:
    """Deterministic prefix of apply_transform (transforms.py): resize /
    scale_width / make_power_2. Crop and flip stay online."""
    if "resize" in cfg.preprocess:
        img = resize(img, (cfg.load_size, cfg.load_size), BICUBIC)
    elif "scale_width" in cfg.preprocess:
        img = scale_width(img, cfg.load_size, cfg.crop_size, BICUBIC)
    if cfg.preprocess == "none":
        img = make_power_2(img, 4, BICUBIC)
    return img


class _BlobWriter:
    """Appends uint8 HWC images to <phase>.<key>.bin and tracks the index."""

    def __init__(self, out_dir: str, phase: str, key: str):
        self.bin_name = f"{phase}.{key}.bin"
        self.idx_name = f"{phase}.{key}.idx.npy"
        self.out_dir = out_dir
        self.f = open(os.path.join(out_dir, self.bin_name), "wb")
        self.rows: List[Tuple[int, ...]] = []
        self.paths: List[str] = []
        self.off = 0

    def add(self, arr: np.ndarray, orig_size: Tuple[int, int],
            path: str) -> None:
        arr = np.ascontiguousarray(arr, dtype=np.uint8)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        self.f.write(arr.tobytes())
        h, w, c = arr.shape
        self.rows.append((self.off, h, w, c,
                          int(orig_size[0]), int(orig_size[1])))
        self.off += arr.nbytes
        self.paths.append(path)

    def close(self) -> Dict:
        self.f.close()
        idx = np.asarray(self.rows, np.int64).reshape(-1, 6)
        np.save(os.path.join(self.out_dir, self.idx_name), idx)
        return {"bin": self.bin_name, "idx": self.idx_name,
                "count": len(self.rows), "paths": self.paths}


def pack_dataset(cfg, out_dir: Optional[str] = None,
                 num_threads: int = 8, logger=None) -> str:
    """Decode + deterministic-prefix every image of cfg.dataroot/cfg.phase
    once, writing a packed root. Re-runnable per phase (the metadata
    merges)."""
    from gcc_tpu_torch.data.datasets import read_rgb

    log = logger.info if logger else print
    mode = cfg.dataset_mode
    if mode not in ("aligned", "unaligned", "sa", "sr"):
        raise ValueError(f"cannot pack dataset_mode [{mode}] "
                         "(packable: aligned|unaligned|sa|sr)")
    out_dir = out_dir or (cfg.dataroot.rstrip("/") + "_packed")
    os.makedirs(out_dir, exist_ok=True)
    meta_path = os.path.join(out_dir, PACK_META)
    meta = {"format": PACK_FORMAT, "phases": {}}
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("format", 0) > PACK_FORMAT:
            raise ValueError(f"{meta_path} has pack format {meta['format']} "
                             f"> {PACK_FORMAT}; upgrade gcc_tpu_torch")
    phase = cfg.phase
    ph: Dict = {"mode": mode, "keys": {}}

    def write(key: str, items, job) -> None:
        """One stream: job(item) -> (array, orig size, path) on the pool,
        written in the items' order."""
        w = _BlobWriter(out_dir, phase, key)
        for arr, size, path in pool.map(job, items):
            w.add(arr, size, path)
        ph["keys"][key] = w.close()

    with futures.ThreadPoolExecutor(max(1, num_threads)) as pool:
        if mode == "aligned":
            # AlignedDataset: split the AB halves, resize each
            paths = make_dataset(os.path.join(cfg.dataroot, phase))
            ph.update(load_size=int(cfg.load_size), preprocess=cfg.preprocess)

            def halves(p):
                AB = read_rgb(p)
                w, h = size_of(AB)
                A, B = crop(AB, (0, 0, w // 2, h)), crop(AB, (w // 2, 0, w, h))
                return (_det_prefix(cfg, A), size_of(A),
                        _det_prefix(cfg, B), size_of(B))

            wa = _BlobWriter(out_dir, phase, "A")
            wb = _BlobWriter(out_dir, phase, "B")
            for p, (a, asz, b, bsz) in zip(paths, pool.map(halves, paths)):
                wa.add(a, asz, p)
                wb.add(b, bsz, p)
            ph["keys"]["A"] = wa.close()
            ph["keys"]["B"] = wb.close()

        elif mode == "unaligned":
            # UnalignedDataset: two directories, resize each side
            ph.update(load_size=int(cfg.load_size), preprocess=cfg.preprocess)
            for key, d in (("A", phase + "A"), ("B", phase + "B")):
                def one(p):
                    img = read_rgb(p)
                    return _det_prefix(cfg, img), size_of(img), p

                write(key, make_dataset(os.path.join(cfg.dataroot, d)), one)

        elif mode == "sa":
            # SADataset: center-crop 160 + bilinear resize is fully
            # deterministic; only z stays online
            folder = os.path.join(cfg.dataroot, phase)
            ph.update(crop_size=int(cfg.crop_size),
                      center_crop=bool(cfg.center_crop))

            def real(name):
                img = read_rgb(os.path.join(folder, name))
                orig = size_of(img)
                if cfg.center_crop:
                    img = center_crop(img, 160)
                img = resize(img, (cfg.crop_size, cfg.crop_size), BILINEAR)
                return img, orig, name

            write("real", sorted(os.listdir(folder)), real)

        else:  # sr
            # SRDataset: the random HR crop precedes any resize, so store the
            # raw decode; crop + bicubic /scale stay online
            folder = os.path.join(cfg.dataroot, phase)

            def raw(name):
                img = read_rgb(os.path.join(folder, name))
                return img, size_of(img), name

            write("img", sorted(os.listdir(folder)), raw)

    meta["format"] = PACK_FORMAT
    meta["phases"][phase] = ph
    tmp = meta_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, meta_path)
    n = next(iter(ph["keys"].values()))["count"]
    mb = sum(os.path.getsize(os.path.join(out_dir, k["bin"]))
             for k in ph["keys"].values()) / 1e6
    log(f"packed {n} items x {len(ph['keys'])} streams "
        f"({mb:.1f} MB) -> {out_dir} [phase={phase} mode={mode}]")
    return out_dir


# --------------------------------------------------------------------------
# loader-side dataset
# --------------------------------------------------------------------------

def _m11(a: np.ndarray) -> np.ndarray:
    """ToTensor + Normalize(0.5): uint8 -> float32 in [-1, 1]."""
    return (a.astype(np.float32) / 255.0) * 2.0 - 1.0


class PackedDataset:
    """Streams samples from a packed root with no image decode.

    out_dtype:
      * "float32" -- host-normalized arrays, drop-in for the online datasets
        (bit-identical streams on the same seed).
      * "uint8"   -- raw uint8 crops; the consumer normalizes on the device
        with device_normalize (4x smaller host->device transfers). z stays
        float32.
    """

    def __init__(self, cfg, seed: int = 0, out_dtype: str = "float32",
                 first_part: bool = True,
                 test_data_name: Optional[str] = None):
        if out_dtype not in ("float32", "uint8"):
            raise ValueError(f"out_dtype {out_dtype!r}: float32 or uint8")
        self.cfg = cfg
        self.out_dtype = out_dtype
        root = cfg.dataroot
        with open(os.path.join(root, PACK_META)) as f:
            meta = json.load(f)
        if meta.get("format", 0) > PACK_FORMAT:
            raise ValueError(f"packed root {root} has format {meta['format']}"
                             f" > {PACK_FORMAT}; upgrade gcc_tpu_torch")
        phase = test_data_name if test_data_name else cfg.phase
        if phase not in meta.get("phases", {}):
            raise FileNotFoundError(
                f"packed root {root} has no phase '{phase}' (packed: "
                f"{sorted(meta.get('phases', {}))}). Pack it with: python -m"
                f" gcc_tpu_torch.cli.prepare --dataroot <original> "
                f"--dataset_mode {cfg.dataset_mode} --phase {phase}")
        ph = meta["phases"][phase]
        self.mode = ph["mode"]
        if cfg.dataset_mode != self.mode:
            raise ValueError(
                f"packed phase '{phase}' of {root} was packed as "
                f"[{self.mode}] but --dataset_mode is [{cfg.dataset_mode}]")
        if self.mode in ("aligned", "unaligned"):
            if (int(ph["load_size"]) != int(cfg.load_size)
                    or ph["preprocess"] != cfg.preprocess):
                raise ValueError(
                    f"packed root {root} was packed with load_size="
                    f"{ph['load_size']} preprocess={ph['preprocess']}, but "
                    f"the run wants load_size={cfg.load_size} preprocess="
                    f"{cfg.preprocess}; re-pack with matching flags")
        if self.mode == "sa":
            if (int(ph["crop_size"]) != int(cfg.crop_size)
                    or bool(ph["center_crop"]) != bool(cfg.center_crop)):
                raise ValueError(
                    f"packed root {root} (sa) has crop_size="
                    f"{ph['crop_size']} center_crop={ph['center_crop']}; "
                    f"re-pack to change them")
        self._mm: Dict[str, np.memmap] = {}
        self._idx: Dict[str, np.ndarray] = {}
        self._paths: Dict[str, List[str]] = {}
        for key, info in ph["keys"].items():
            self._mm[key] = np.memmap(os.path.join(root, info["bin"]),
                                      np.uint8, mode="r")
            self._idx[key] = np.load(os.path.join(root, info["idx"]))
            self._paths[key] = info["paths"]
        self.rng = LockedRandomState(seed)
        self._sr_split = ("train" if cfg.phase.lower() == "train"
                          and test_data_name is None else "test")

        # index remaps mirroring the online classes' path slicing + sorting
        def order(key, split=False):
            paths = self._paths[key]
            n = len(paths)
            if np.isfinite(cfg.max_dataset_size):
                n = min(int(cfg.max_dataset_size), n)
            sel = list(range(len(paths)))
            if split and getattr(cfg, "split_dataset", False):
                # make_split_dataset (image_folder.py)
                sel = sel[: n // 2] if first_part else sel[n // 2:]
            else:
                sel = sel[:n]
            sel.sort(key=paths.__getitem__)  # the outer sorted(...)
            return np.asarray(sel, np.int64)

        if self.mode == "aligned":
            self._order = {"A": order("A")}
        elif self.mode == "unaligned":
            self._order = {"A": order("A", split=True),
                           "B": order("B", split=True)}
        elif self.mode == "sa":
            self._order = {"real": order("real")}
        else:
            self._order = {"img": order("img")}

    # -- raw access ------------------------------------------------------
    def _raw(self, key: str, j: int) -> np.ndarray:
        off, h, w, c = (int(v) for v in self._idx[key][j][:4])
        return np.asarray(self._mm[key][off: off + h * w * c]).reshape(h, w, c)

    @staticmethod
    def _crop(a: np.ndarray, x: int, y: int, size: int) -> np.ndarray:
        """img.crop((x, y, x+size, y+size)), black past the right and bottom
        edges as PIL pads (transforms.apply_transform guards the call)."""
        sub = a[y: y + size, x: x + size]
        if sub.shape[0] < size or sub.shape[1] < size:
            out = np.zeros((size, size, a.shape[2]), np.uint8)
            out[: sub.shape[0], : sub.shape[1]] = sub
            sub = out
        return sub

    def _finish(self, a: np.ndarray, flip: bool) -> np.ndarray:
        if flip:
            a = a[:, ::-1]
        a = np.ascontiguousarray(a)
        return a if self.out_dtype == "uint8" else _m11(a)

    def _norm_imagenet(self, a: np.ndarray) -> np.ndarray:
        if self.out_dtype == "uint8":
            return np.ascontiguousarray(a)
        a01 = a.astype(np.float32) / 255.0
        return ((a01 - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)

    # -- sampling --------------------------------------------------------
    def __len__(self):
        if self.mode == "unaligned":
            return max(len(self._order["A"]), len(self._order["B"]))
        return len(next(iter(self._order.values())))

    def sample_params(self, index: int) -> tuple:
        """This index's randomized transform parameters, drawn WITHOUT
        touching pixels: the same rng and draw order as __getitem__, so host
        and device materialization consume identical streams. Shapes come
        from the index rows, which mirror the stored arrays."""
        cfg = self.cfg
        if self.mode == "aligned":
            j = int(self._order["A"][index])
            ow0, oh0 = (int(v) for v in self._idx["A"][j][4:6])
            # get_params: x, y, flip, with new_w/new_h from the
            # PRE-transform size; the flip is always drawn
            if cfg.preprocess == "resize_and_crop":
                nw = nh = cfg.load_size
            elif cfg.preprocess == "scale_width_and_crop":
                nw, nh = cfg.load_size, cfg.load_size * oh0 // ow0
            else:
                nw, nh = ow0, oh0
            x = self.rng.randint(0, max(0, nw - cfg.crop_size) + 1)
            y = self.rng.randint(0, max(0, nh - cfg.crop_size) + 1)
            flip = self.rng.rand() > 0.5
            return (j, x, y, bool(flip) and not cfg.no_flip)

        if self.mode == "unaligned":
            oA, oB = self._order["A"], self._order["B"]
            jA = int(oA[index % len(oA)])
            if cfg.serial_batches:
                jB = int(oB[index % len(oB)])
            else:
                jB = int(oB[self.rng.randint(0, len(oB))])
            ps = []
            for key, j in (("A", jA), ("B", jB)):
                # apply_transform with params=None: x, y from the
                # POST-resize size, then the flip only without no_flip
                h, w = (int(v) for v in self._idx[key][j][1:3])
                x = self.rng.randint(0, max(0, w - cfg.crop_size) + 1)
                y = self.rng.randint(0, max(0, h - cfg.crop_size) + 1)
                flip = (not cfg.no_flip) and self.rng.rand() > 0.5
                ps.append((j, x, y, bool(flip)))
            return tuple(ps)

        if self.mode == "sa":
            j = int(self._order["real"][index])
            return (j, self.rng.randn(cfg.z_dim).astype(np.float32))

        # sr
        j = int(self._order["img"][index])
        if self._sr_split == "train":
            h, w = (int(v) for v in self._idx["img"][j][1:3])
            cs = int(cfg.image_size)
            # low bound 1 as the reference (sr_dataset.py:94-95)
            left = self.rng.randint(1, w - cs + 1)
            top = self.rng.randint(1, h - cs + 1)
            return (j, left, top)
        return (j,)

    def __getitem__(self, index: int) -> Dict:
        return self.materialize(self.sample_params(index))

    def materialize(self, params: tuple) -> Dict:
        """The host pixel path for drawn params (see sample_params)."""
        cfg = self.cfg
        if self.mode == "aligned":
            j, x, y, flip = params
            a, b = self._raw("A", j), self._raw("B", j)
            if "crop" in cfg.preprocess:
                if a.shape[1] > cfg.crop_size or a.shape[0] > cfg.crop_size:
                    a = self._crop(a, x, y, cfg.crop_size)
                if b.shape[1] > cfg.crop_size or b.shape[0] > cfg.crop_size:
                    b = self._crop(b, x, y, cfg.crop_size)
            path = self._paths["A"][j]
            return {"A": self._finish(a, flip), "B": self._finish(b, flip),
                    "A_paths": path, "B_paths": path}

        if self.mode == "unaligned":
            out = {}
            for key, (j, x, y, flip) in zip(("A", "B"), params):
                a = self._raw(key, j)
                h, w = a.shape[:2]
                if "crop" in cfg.preprocess and (w > cfg.crop_size
                                                 or h > cfg.crop_size):
                    a = self._crop(a, x, y, cfg.crop_size)
                out[key] = self._finish(a, flip)
                out[key + "_paths"] = self._paths[key][j]
            return out

        if self.mode == "sa":
            j, z = params
            return {"z": z, "real_img": self._finish(self._raw("real", j),
                                                     False),
                    "img_path": self._paths["real"][j]}

        # sr
        j = params[0]
        img = self._raw("img", j)
        h, w = img.shape[:2]
        cs, scale = int(cfg.image_size), int(cfg.upscale_factor)
        if self._sr_split == "train":
            _, left, top = params
            hr = img[top: top + cs, left: left + cs]
        else:
            xr, yr = w % scale, h % scale
            hr = img[yr // 2: yr // 2 + h - yr, xr // 2: xr // 2 + w - xr]
        hr = np.ascontiguousarray(hr)
        lr = resize(hr, (hr.shape[1] // scale, hr.shape[0] // scale), BICUBIC)
        name = self._paths["img"][j]
        if self.out_dtype == "uint8":
            return {"lr": np.ascontiguousarray(lr), "hr": hr,
                    "lr_names": name, "hr_names": name}
        return {"lr": self._norm_imagenet(lr), "hr": _m11(hr),
                "lr_names": name, "hr_names": name}

    def get_batch(self, indices, rows: slice = slice(None)) -> Dict:
        """Whole-batch path: the Loader submits ONE pool task per batch,
        since there is no decode to spread, only slicing and copies. Every
        item's parameters are drawn, in order; only ``rows`` of the batch
        are built (a data-parallel rank's)."""
        from gcc_tpu_torch.data.loader import collate
        params = [self.sample_params(int(i)) for i in indices]
        return collate([self.materialize(p) for p in params[rows]])

    # -- device-cache support (data/device_cache.py) ----------------------
    def uniform_shapes(self) -> Optional[Dict[str, tuple]]:
        """(h, w, c) per key iff every stored item shares one shape and the
        blob is contiguously packed (reshapeable to (n, h, w, c))."""
        out = {}
        for key, idx in self._idx.items():
            if len(idx) == 0:
                return None
            hwc = idx[0, 1:4]
            if not (idx[:, 1:4] == hwc).all():
                return None
            size = int(hwc[0]) * int(hwc[1]) * int(hwc[2])
            if not (idx[:, 0]
                    == np.arange(len(idx), dtype=np.int64) * size).all():
                return None
            out[key] = tuple(int(v) for v in hwc)
        return out

    def device_cacheable(self) -> bool:
        """True when the whole store can live in device memory and the
        online remainder (crop / flip / pairing / z) is a gather with the
        host path's semantics."""
        cfg = self.cfg
        if self.mode not in ("aligned", "unaligned", "sa"):
            return False  # sr: variable HR shapes + an online bicubic
        shapes = self.uniform_shapes()
        if shapes is None:
            return False
        if self.mode in ("aligned", "unaligned") and "crop" in cfg.preprocess:
            cs = int(cfg.crop_size)
            for key, (h, w, _) in shapes.items():
                # the host crops iff (w > cs or h > cs) and pads past the
                # edge; the device path covers the pure-slice case only
                if (h > cs or w > cs) and (h < cs or w < cs):
                    return False
            if self.mode == "aligned":
                # one x/y pair crops BOTH sides: their sizes must agree, and
                # the draw comes from the PRE-transform size, which must
                # equal the stored size or a crop could overrun
                if shapes["A"] != shapes["B"]:
                    return False
                h, w, _ = shapes["A"]
                for row in self._idx["A"]:
                    ow0, oh0 = int(row[4]), int(row[5])
                    if cfg.preprocess == "resize_and_crop":
                        nw = nh = cfg.load_size
                    elif cfg.preprocess == "scale_width_and_crop":
                        nw, nh = cfg.load_size, cfg.load_size * oh0 // ow0
                    else:
                        nw, nh = ow0, oh0
                    if (nw, nh) != (w, h):
                        return False
        return True

    def total_bytes(self) -> int:
        return sum(int(mm.size) for mm in self._mm.values())


# --------------------------------------------------------------------------
# device-side normalization for the uint8 path
# --------------------------------------------------------------------------

def normalize_tensor(x, spec: str, dtype=None):
    """A uint8 NHWC (or HWC) tensor as NCHW (CHW) on its device: x/255*2-1,
    or the imagenet normalization for ``spec == "imagenet"``, in the host
    path's float32 arithmetic op for op, then cast to ``dtype`` (default
    float32), as the JAX package's device_normalize casts."""
    import torch
    dtype = torch.float32 if dtype is None else dtype
    y = x.to(torch.float32) / 255.0
    if spec == "imagenet":
        mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
        std = torch.as_tensor(IMAGENET_STD, device=x.device)
        y = (y - mean) / std
    else:
        y = y * 2.0 - 1.0
    return y.movedim(-1, -3).to(dtype).contiguous()


def device_normalize(batch: Dict, dtype=None) -> Dict:
    """A dict of uint8 NHWC tensors -> NCHW tensors of ``dtype`` (default
    float32) on their device: SRGAN's 'lr' imagenet-normalized, every other
    key to [-1, 1], as the host path normalizes them. In float32 within 1
    ulp of its values; a bf16 batch is those values rounded once."""
    return {k: normalize_tensor(v, "imagenet" if k == "lr" else "m11", dtype)
            for k, v in batch.items()}
