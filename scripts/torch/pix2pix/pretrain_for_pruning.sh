#!/usr/bin/env bash
# Stage 1 (pix2pix): sparsity pretraining. The port's counterpart of
# scripts/pix2pix/pretrain_for_pruning.sh, flag for flag; it runs on card 0
# (the port's default --gpu_ids 0). Append --gpu_ids 0,1,... to train
# data-parallel, or --gpu_ids -1 for the CPU.
python -m gcc_tpu_torch.cli.train \
  --dataroot ./database/cityscapes/ \
  --model pix2pix \
  --lambda_scale 1e-2 \
  --ngf 32 \
  --ndf 128 \
  --name cityscapes_ngf32_ndf128_scale1e-2
