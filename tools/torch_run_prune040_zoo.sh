#!/bin/bash
# The port of tools/run_prune040_zoo.sh: the pruned checkpoint's recipe on
# the CUDA card.
#
# prune 0.4 of the 256x320 zoo checkpoint -> 60-epoch fine-tune on the
# pseudo-GT set (tools/torch_make_finetune_set.py) with EMA -> the
# deployable EMA variables -> the golden recall check, fp32 through the
# folded graph (the chain and NMS kernels) and pure int8 after calibration.
#
# Usage: bash tools/torch_run_prune040_zoo.sh [OUT]
# Everything goes under OUT (default train_runs/, which git ignores):
# OUT/ft040, OUT/pruned040.npz, OUT/ck040, OUT/prune040_logs and the
# deployable OUT/yolofastest_pruned040_256x320.npz.  Nothing is written to
# weights/.
set -e
cd "$(dirname "$0")/.."
OUT=${1:-train_runs}

echo "=== card probe ==="
python3 - <<'PY'
import subprocess
import torch
assert torch.cuda.is_available(), "no CUDA card: the recipe trains on the card"
print("devices:", [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())])
print("probe sum:", float(torch.ones(8, device="cuda").sum()))
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True, check=True).stdout.strip())
PY

echo "=== pseudo-GT fine-tune set ==="
python3 tools/torch_make_finetune_set.py --out "$OUT/ft040" --copies 16

echo "=== prune 0.4 ==="
python3 -m yolofastest_torch prune --config 256x320 \
  --weights weights/yolofastest_256x320.npz --ratio 0.4 --out "$OUT/pruned040.npz"

echo "=== fine-tune (60 epochs, EMA) ==="
rm -rf "$OUT/ck040" "$OUT/prune040_logs"
python3 -m yolofastest_torch train --config 256x320 \
  --train-dir "$OUT/ft040/train" --val-dir "$OUT/ft040/val" \
  --pretrained "$OUT/pruned040.npz" --epochs 60 --batch-size 16 \
  --warmup-min-iters 60 --ema --checkpoint-dir "$OUT/ck040" \
  --log-dir "$OUT/prune040_logs" --max-to-keep 3

echo "=== extract deployable variables (EMA) ==="
OUT="$OUT" python3 - <<'PY'
import os
import re

from yolofastest_torch.models import save_variables
from yolofastest_torch.train import checkpoint_variables

out = os.environ["OUT"]
root = os.path.join(out, "ck040")
epochs = sorted(int(m.group(1)) for d in os.listdir(root)
                if (m := re.fullmatch(r"epoch_(\d+)", d)))
path = os.path.join(root, f"epoch_{epochs[-1]}")
dst = os.path.join(out, "yolofastest_pruned040_256x320.npz")
save_variables(checkpoint_variables(path), dst)  # EMA preferred
print("wrote", dst, "from", path)
PY

echo "=== golden recall check (fp + int8) ==="
OUT="$OUT" python3 - <<'PY'
import os

from yolofastest_torch.configs import get_config
from yolofastest_torch.eval.golden import fp_recall, golden_inputs, int8_recalls
from yolofastest_torch.models import fold_batchnorm, load_variables
from yolofastest_torch.quant import calibrate

cfg = get_config("256x320")
variables = load_variables(os.path.join(os.environ["OUT"], "yolofastest_pruned040_256x320.npz"))
print("pruned040 fp recall: %d/%d" % fp_recall(variables, cfg, "cuda"))
imgs, golden = golden_inputs("256x320")
folded = fold_batchnorm(variables)
scales = calibrate(folded, [imgs], device="cuda")
r8 = int8_recalls(folded, scales, (), cfg, imgs, golden, "cuda")[0]
print("pruned040 int8 recall: %d/%d" % (r8, len(golden)))
PY

echo "=== DONE ==="
