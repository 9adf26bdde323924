#!/usr/bin/env bash
# Stage 3 (SAGAN): evaluate the compressed generator. The port's counterpart
# of scripts/sagan/test.sh, flag for flag; it runs on card 0 (the port's
# default --gpu_ids 0). Append --gpu_ids -1 for the CPU.
python -m gcc_tpu_torch.cli.test \
  --dataroot ./database/celeb/ \
  --model sagan \
  --ngf 48 \
  --pretrain_path ./experiments/celeb_ngf48scale16.0_dartsT0.1_l0c1g1/checkpoints/model_best_AtoB.ckpt \
  --name sagan_test
