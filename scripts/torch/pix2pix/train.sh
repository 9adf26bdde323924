#!/usr/bin/env bash
# Stage 2 (pix2pix): prune to the budget, then GCC compression training. The
# port's counterpart of scripts/pix2pix/train.sh, flag for flag; it runs on
# card 0 (the port's default --gpu_ids 0). Append --gpu_ids 0,1,... to train
# data-parallel, or --gpu_ids -1 for the CPU.
python -m gcc_tpu_torch.cli.train \
  --dataroot ./database/cityscapes/ \
  --model pix2pix \
  --ngf 32 \
  --ndf 128 \
  --darts_discriminator \
  --arch_lr 1e-4 \
  --arch_lr_step \
  --scale_prune \
  --target_budget 3.0 \
  --pretrain_path ./experiments/cityscapes_ngf32_ndf128_scale1e-2/checkpoints/model_best_BtoA.ckpt \
  --online_distillation \
  --lambda_content 50 \
  --lambda_gram 1e4 \
  --name cityscapes_ngf32scale3.0_darts_c50g1e4
