#!/usr/bin/env bash
# Canonical PartNet inference recipe (reference run_infer.sh; local checkpoint
# dir instead of a wandb run path) on the PyTorch port, on the GPU; the flags are
# scripts/run_infer.sh's.
python -m hpcs_torch.train \
  --dataset 'partnet' \
  --category 'Dishwasher' \
  --level 1 \
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
  --batch 1 \
  --lr 0.05 \
  --accelerator 'cuda' \
  --trade_off 0.10 \
  --resume "${1:-logs/partnet_vn_dgcnn_partseg/checkpoints/best}" \
  --infer
