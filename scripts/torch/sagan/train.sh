#!/usr/bin/env bash
# Stage 2 (SAGAN): prune to the budget, then GCC compression training. The
# port's counterpart of scripts/sagan/train.sh, flag for flag; it runs on card
# 0 (the port's default --gpu_ids 0). Append --gpu_ids 0,1,... to train
# data-parallel, or --gpu_ids -1 for the CPU.
python -m gcc_tpu_torch.cli.train \
  --dataroot ./database/celeb/ \
  --model sagan \
  --ngf 48 \
  --ndf 64 \
  --scale_prune \
  --pretrain_path ./experiments/celeb_ngf48_scale1e-2/checkpoints/model_best_AtoB.ckpt \
  --target_budget 0.016 \
  --darts_discriminator \
  --threshold 0.1 \
  --online_distillation \
  --lambda_L1 0 \
  --lambda_content 1 \
  --lambda_gram 1 \
  --name celeb_ngf48scale16.0_dartsT0.1_l0c1g1
