#!/bin/bash
# The port of tools/run_fullscale_train.sh: the reference-scale training
# run on the CUDA card.
#
# The reference commits a 30-epoch history over 8,000 images (~500 steps an
# epoch at batch 16).  Its dataset is not shipped, so this reproduces the
# scale with the pseudo-GT set of tools/torch_make_finetune_set.py: 20
# golden frames x 400 augmented copies = 8,000 training items, 30 epochs at
# batch 16 -> 500 steps an epoch (15,000 steps), per-epoch mAP validation,
# from random initialisation.
#
# Usage: bash tools/torch_run_fullscale_train.sh [OUT]
# Everything goes under OUT (default train_runs/, which git ignores):
# OUT/ft8000 (the set), OUT/ck8000 (checkpoints), OUT/fullscale_logs
# (train_info.log, metrics.jsonl).  A run that was cut continues from its
# newest checkpoint with the same train line and --resume latest.
set -e
cd "$(dirname "$0")/.."
OUT=${1:-train_runs}

python3 - <<'PY'
import subprocess
import torch
assert torch.cuda.is_available(), "no CUDA card: the recipe trains on the card"
print("devices:", [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())])
print("probe:", float(torch.ones(8, device="cuda").sum()))
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True, check=True).stdout.strip())
PY

python3 tools/torch_make_finetune_set.py --out "$OUT/ft8000" --copies 400

rm -rf "$OUT/ck8000" "$OUT/fullscale_logs"
python3 -m yolofastest_torch train --config 256x320 \
  --train-dir "$OUT/ft8000/train" --val-dir "$OUT/ft8000/val" \
  --epochs 30 --batch-size 16 --cache-images \
  --checkpoint-dir "$OUT/ck8000" --log-dir "$OUT/fullscale_logs" --max-to-keep 2

echo "=== DONE ==="
