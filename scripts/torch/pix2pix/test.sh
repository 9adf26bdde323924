#!/usr/bin/env bash
# Stage 3 (pix2pix): evaluate the compressed generator. The port's counterpart
# of scripts/pix2pix/test.sh, flag for flag; it runs on card 0 (the port's
# default --gpu_ids 0). Append --gpu_ids -1 for the CPU.
python -m gcc_tpu_torch.cli.test \
  --dataroot ./database/cityscapes/ \
  --model pix2pix \
  --ngf 32 \
  --pretrain_path ./experiments/cityscapes_ngf32scale3.0_darts_c50g1e4/checkpoints/model_best_BtoA.ckpt \
  --name cityscapes_test
