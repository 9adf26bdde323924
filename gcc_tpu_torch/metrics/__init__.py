"""Evaluation metrics of the port (numpy and scipy), and SRGAN's VGG19
perceptual feature extractor; the evaluator networks (InceptionV3 FID, DRN
mIoU) are not in the port yet."""
