#!/usr/bin/env bash
# Stage 2 (CycleGAN): prune to the budget, then GCC compression training. The
# port's counterpart of scripts/cyclegan/train.sh, flag for flag; it runs on
# card 0 (the port's default --gpu_ids 0). Append --gpu_ids 0,1,... to train
# data-parallel, or --gpu_ids -1 for the CPU.
python -m gcc_tpu_torch.cli.train \
  --dataroot ./database/horse2zebra/ \
  --model cyclegan \
  --ngf 24 \
  --ndf 64 \
  --darts_discriminator \
  --arch_lr 1e-4 \
  --arch_lr_step \
  --norm_prune \
  --pretrain_path ./experiments/horse2zebra_ngf24_ndf64_norm1e-3/checkpoints/model_20.ckpt \
  --target_budget 2.4 \
  --target_budget_B 2.7 \
  --online_distillation \
  --lambda_content 0.01 \
  --lambda_gram 10 \
  --name cyclegan_ngf24norm2.4_ndf32_c0.01g1000
