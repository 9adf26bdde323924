#!/usr/bin/env bash
# Stage 3 (CycleGAN): evaluate the compressed generator. The port's
# counterpart of scripts/cyclegan/test.sh, flag for flag; it runs on card 0
# (the port's default --gpu_ids 0). Append --gpu_ids -1 for the CPU.
python -m gcc_tpu_torch.cli.test \
  --dataroot ./database/horse2zebra/ \
  --model cyclegan \
  --ngf 24 \
  --pretrain_path ./experiments/cyclegan_ngf24norm2.4_ndf32_c0.01g1000/checkpoints/model_best_AtoB.ckpt \
  --name cyclegan_test
