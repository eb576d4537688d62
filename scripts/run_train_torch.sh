#!/usr/bin/env bash
# Canonical PartNet training recipe (reference run_train.sh) on the PyTorch port,
# on the GPU; the flags are scripts/run_train.sh's.
python -m hpcs_torch.train \
  --dataset 'partnet' \
  --category 'Dishwasher' \
  --level 3 \
  --fixed_points 1024 \
  --model 'vn_dgcnn_partseg' \
  --eucl_embedding 4 \
  --hyp_embedding 4 \
  --k 20 \
  --margin 0.35 \
  --t_per_anchor 50 \
  --fraction 1.2 \
  --temperature 0.10 \
  --epochs 40 \
  --batch 2 \
  --lr 0.05 \
  --accelerator 'cuda' \
  --trade_off 0.10
