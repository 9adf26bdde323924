"""Evaluation metrics of the port: FID (``inception``: the TF-FID
InceptionV3; ``fid``: the Fréchet distance), cityscapes mIoU (``miou``:
DRN-D-105), PSNR/SSIM (``psnr_ssim``), SRGAN's VGG19 perceptual features
(``vgg``) and the ingestion of their pretrained weights (``ingest``)."""
