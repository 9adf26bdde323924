#!/usr/bin/env bash
# Stage 1 (SRGAN): sparsity pretraining. The port's counterpart of
# scripts/srgan/pretrain_for_pruning.sh, flag for flag; it runs on card 0 (the
# port's default --gpu_ids 0). Append --gpu_ids 0,1,... to train
# data-parallel, or --gpu_ids -1 for the CPU.
python -m gcc_tpu_torch.cli.train \
  --dataroot ./database/sr/ \
  --model srgan \
  --initial_path ./experiments/sr_ngf24/checkpoints/model_130.ckpt \
  --ngf 24 \
  --ndf 64 \
  --lambda_scale 1e-2 \
  --name sr_ngf24_scale1e-2
