#!/usr/bin/env bash
# Stage 3 (SRGAN): evaluate the compressed generator. The port's counterpart
# of scripts/srgan/test.sh, flag for flag; it runs on card 0 (the port's
# default --gpu_ids 0). Append --gpu_ids -1 for the CPU.
python -m gcc_tpu_torch.cli.test \
  --dataroot ./database/sr \
  --model srgan \
  --ngf 24 \
  --pretrain_path ./experiments/sr_ngf24scale0.2_darts_l1c0.1g0.1/checkpoints/model_best_Set5_psnr.ckpt \
  --name srgan_test
