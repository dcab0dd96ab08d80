#!/usr/bin/env bash
# The skirt quality gate of the PyTorch port on one GPU: write the skirt,
# train configs/synthetic_skirt_512_shadowed.json (3000 iterations, 512²,
# tet grid 96, n_samples 8, batch 2, shadowed ground truth), then measure 16
# held-out views (PSNR) and the Chamfer-L2 against the skirt.
#
#   bash tools/torch_quality_gate.sh [OUT_DIR] [TRAIN_SECONDS] [REPORT_DIR]
#
# TRAIN_SECONDS (default: no limit) stops training after that many seconds;
# --resume continues from OUT_DIR/run/state.pt, which is written every
# save_interval (250) iterations, so a stopped run loses at most one interval
# and the evaluation reads the last snapshot (its step is printed).  The logs,
# metrics.txt, the first four validation triptychs and the last mesh are
# copied to REPORT_DIR (default OUT_DIR/report).
set -u
OUT=${1:-out/gate}
LIMIT=${2:-0}
REPORT=${3:-$OUT/report}
CONFIG=configs/synthetic_skirt_512_shadowed.json
mkdir -p "$OUT" "$REPORT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$REPORT/card.txt"
python -m gshell_tpu_torch.utils.synthetic_gt skirt "$OUT/skirt.obj" || exit 1
train=(python -m gshell_tpu_torch.train_gshell --config "$CONFIG" --ref-mesh "$OUT/skirt.obj"
       --out-dir "$OUT/run" --resume --snapshot-images 0)
if [ "$LIMIT" -gt 0 ]; then
    timeout -s INT "$LIMIT" "${train[@]}" > "$REPORT/train.log" 2>&1
else
    "${train[@]}" > "$REPORT/train.log" 2>&1
fi
echo "train exit $? (124 or 130: stopped at the time limit)"
tail -n 3 "$REPORT/train.log"
python -m gshell_tpu_torch.eval_reconstruction --state "$OUT/run/state.pt" --config "$CONFIG" \
    --synthetic-ref-mesh "$OUT/skirt.obj" --gt-mesh "$OUT/skirt.obj" --gt-unit-size \
    --out-dir "$OUT/validate" --dump-images 2>&1 | tee "$REPORT/eval.log"
rc=${PIPESTATUS[0]}
cp "$OUT/validate/metrics.txt" "$REPORT/" 2>/dev/null
cp "$OUT"/validate/val_00[0-3].png "$REPORT/" 2>/dev/null
last=$(ls "$OUT"/run/mesh_*.obj 2>/dev/null | tail -n 1)
[ -n "$last" ] && cp "$last" "$REPORT/"
exit "$rc"
