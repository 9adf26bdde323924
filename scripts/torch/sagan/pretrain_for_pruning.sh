#!/usr/bin/env bash
# Stage 1 (SAGAN): sparsity pretraining. The port's counterpart of
# scripts/sagan/pretrain_for_pruning.sh, flag for flag; it runs on card 0 (the
# port's default --gpu_ids 0). Append --gpu_ids 0,1,... to train
# data-parallel, or --gpu_ids -1 for the CPU.
python -m gcc_tpu_torch.cli.train \
  --dataroot ./database/celeb/ \
  --model sagan \
  --lambda_scale 1e-2 \
  --ngf 48 \
  --ndf 64 \
  --name celeb_ngf48_scale1e-2
