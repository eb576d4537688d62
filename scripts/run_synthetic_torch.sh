#!/usr/bin/env bash
# Hermetic end-to-end run on procedural clouds (no dataset download) on the
# PyTorch port (the GPU: --accelerator defaults to cuda); the flags are
# scripts/run_synthetic.sh's.
python -m hpcs_torch.train \
  --dataset 'synthetic' \
  --fixed_points 1024 \
  --model 'vn_dgcnn_partseg' \
  --eucl_embedding 32 \
  --hyp_embedding 32 \
  --k 20 \
  --margin 0.35 \
  --t_per_anchor 50 \
  --temperature 0.05 \
  --epochs 150 \
  --batch 8 \
  --lr 0.05 \
  --trade_off 0.10 \
  --patience 60
