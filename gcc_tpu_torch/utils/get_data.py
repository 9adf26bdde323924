"""Dataset downloader (port of gcc_tpu/utils/get_data.py; the reference's
utils/get_data.py:11-110 and datasets/download_*.sh, with the SR flow of
datasets/download_esrgan_dataset.sh:1-20).

Downloads the standard pix2pix and CycleGAN dataset archives and the SR
training corpus (Flickr2K; the reference's esrgan script fetches only this,
DIV2K left commented out). The SR evaluation sets (Set5, Set14, B100,
Urban100) and COCO train2014/val2014 are listed with their upstream URLs.
Without network access a download fails at once with a RuntimeError that
names the URL, so that the archive can be fetched by hand and unpacked into
the target (then ``datasets/prepare_sr_dataset.py`` builds the SR layout).
"""

from __future__ import annotations

import os
import tarfile
import urllib.request
import zipfile

PIX2PIX_URL = "http://efrosgans.eecs.berkeley.edu/pix2pix/datasets/"
CYCLEGAN_URL = \
    "https://people.eecs.berkeley.edu/~taesung_park/CycleGAN/datasets/"

PIX2PIX_DATASETS = ["cityscapes", "edges2handbags", "edges2shoes",
                    "facades", "maps", "night2day"]
CYCLEGAN_DATASETS = ["apple2orange", "summer2winter_yosemite", "horse2zebra",
                     "monet2photo", "cezanne2photo", "ukiyoe2photo",
                     "vangogh2photo", "maps", "cityscapes", "facades",
                     "iphone2dslr_flower"]

# SR: the training corpus and COCO (prepare_sr_dataset.py:37-114 expects
# train2014/val2014); the eval sets as one archive of the SelfExSR release
# used across the SR literature
SR_URLS = {
    "flickr2k": "http://cv.snu.ac.kr/research/EDSR/Flickr2K.tar",
    "coco_train2014": "http://images.cocodataset.org/zips/train2014.zip",
    "coco_val2014": "http://images.cocodataset.org/zips/val2014.zip",
    "sr_testsets": ("https://uofi.box.com/shared/static/"
                    "kfahv87nfe8ax910l85dksyl2q212voc.zip"),
}
SR_DATASETS = list(SR_URLS)


class GetData:
    """``GetData(technique, save_path).get(dataset)``: the dataset's folder
    under save_path, downloaded and unpacked unless it is there already.
    ``technique``: 'pix2pix', 'cyclegan' or 'sr'."""

    def __init__(self, technique: str = "cyclegan",
                 save_path: str = "./database"):
        self.technique = technique.lower()
        self.save_path = save_path

    def available(self):
        if self.technique == "pix2pix":
            return PIX2PIX_DATASETS
        if self.technique == "sr":
            return SR_DATASETS
        return CYCLEGAN_DATASETS

    def _url_for(self, dataset: str) -> str:
        if self.technique == "sr":
            return SR_URLS[dataset]
        base = PIX2PIX_URL if self.technique == "pix2pix" else CYCLEGAN_URL
        ext = ".tar.gz" if self.technique == "pix2pix" else ".zip"
        return f"{base}{dataset}{ext}"

    def get(self, dataset: str) -> str:
        if dataset not in self.available():
            raise ValueError(f"unknown dataset [{dataset}]; "
                             f"available: {self.available()}")
        url = self._url_for(dataset)
        ext = ".tar.gz" if url.endswith(".tar.gz") else url[url.rindex("."):]
        os.makedirs(self.save_path, exist_ok=True)
        archive = os.path.join(self.save_path, dataset + ext)
        target = os.path.join(self.save_path, dataset)
        if os.path.isdir(target):
            return target
        try:
            print(f"downloading {url}")
            urllib.request.urlretrieve(url, archive)
        except OSError as e:
            raise RuntimeError(
                f"download failed ({e}); fetch {url} manually and unpack "
                f"into {target}") from e
        if ext == ".zip":
            with zipfile.ZipFile(archive) as z:
                z.extractall(self.save_path)
        else:
            with tarfile.open(archive) as t:
                t.extractall(self.save_path, filter="data")
        os.remove(archive)
        return target
