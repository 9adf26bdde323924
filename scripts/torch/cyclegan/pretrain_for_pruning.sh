#!/usr/bin/env bash
# Stage 1 (CycleGAN): sparsity pretraining. The port's counterpart of
# scripts/cyclegan/pretrain_for_pruning.sh, flag for flag; it runs on card 0
# (the port's default --gpu_ids 0). Append --gpu_ids 0,1,... to train
# data-parallel, or --gpu_ids -1 for the CPU.
python -m gcc_tpu_torch.cli.train \
  --dataroot ./database/horse2zebra/ \
  --model cyclegan \
  --lambda_weight 1e-3 \
  --ndf 64 \
  --ngf 48 \
  --name horse2zebra_ngf24_ndf64_norm1e-3
