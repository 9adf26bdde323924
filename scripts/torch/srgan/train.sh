#!/usr/bin/env bash
# Stage 2 (SRGAN): prune to the budget, then GCC compression training. The
# port's counterpart of scripts/srgan/train.sh, flag for flag; it runs on card
# 0 (the port's default --gpu_ids 0). Append --gpu_ids 0,1,... to train
# data-parallel, or --gpu_ids -1 for the CPU.
python -m gcc_tpu_torch.cli.train \
  --dataroot ./database/sr \
  --model srgan \
  --ngf 24 \
  --scale_prune \
  --target_budget 0.20 \
  --pretrain_path ./experiments/sr_ngf24_scale1e-2/checkpoints/model_13.ckpt \
  --initial_path ./experiments/sr_ngf24scaleprune0.20/checkpoints/model_130.ckpt \
  --teacher_initial_path ./experiments/sr_ngf64/checkpoints/model_100.ckpt \
  --darts_discriminator \
  --arch_lr 1e-4 \
  --arch_lr_step \
  --online_distillation \
  --lambda_gram 0.1 \
  --lambda_content 0.1 \
  --name sr_ngf24scale0.2_darts_l1c0.1g0.1
