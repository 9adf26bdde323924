"""Best-metric tracker (port of gcc_tpu/utils/best_info.py;
utils/best_information.py:1-55). The direction follows the metric the
epoch-end eval reports: mIoU and PSNR rise, FID falls."""

from __future__ import annotations

import math


def maximize_metric(cfg) -> bool:
    """Whether the model's eval metric improves upward (mIoU/PSNR) or
    downward (FID) — train.py:16-73 best-tracking directions. pix2pix on
    cityscapes reports mIoU, or the PSNR proxy; with InceptionV3 weights
    and real statistics but no DRN weights it reports FID, which falls
    (gcc_tpu maximises it there too)."""
    if cfg.model == "srgan":
        return True
    if "pix2pix" not in cfg.model or "cityscapes" not in cfg.dataroot:
        return False
    from gcc_tpu_torch.eval.orchestrators import uses_fid, uses_miou
    return uses_miou(cfg) or not uses_fid(cfg)


class BestInfo:
    def __init__(self, cfg):
        self.cfg = cfg
        if "pix2pix" in cfg.model:
            self.best_metric = [0.0] if maximize_metric(cfg) else [math.inf]
            self.best_epoch = [0]
        elif cfg.model == "srgan":
            self.best_metric = [0.0] * 8  # PSNR x4 sets + SSIM x4 sets
            self.best_epoch = [0] * 8
        elif cfg.model == "sagan":
            self.best_metric = [math.inf]
            self.best_epoch = [0]
        elif "cyclegan" in cfg.model:
            self.best_metric = [math.inf] * 2
            self.best_epoch = [0] * 2
        else:
            self.best_metric = [math.inf]
            self.best_epoch = [0]

    def update(self, metric: float, epoch: int, index: int = 0) -> bool:
        if maximize_metric(self.cfg):
            if self.best_metric[index] <= metric:
                self.best_metric[index] = metric
                self.best_epoch[index] = epoch
                return True
        else:
            if self.best_metric[index] >= metric:
                self.best_metric[index] = metric
                self.best_epoch[index] = epoch
                return True
        return False

    def summary(self) -> str:
        pairs = ", ".join(
            f"epoch {e}: {m:.4f}" for e, m in zip(self.best_epoch, self.best_metric))
        return f"best [{pairs}]"
