#!/usr/bin/env bash
# The long-video and accuracy entry points of the PyTorch port on one card,
# from the repository root: long_video_bench --limit (960 frames, three
# rounds) and its 300-frame cache comparison; synthetic pretraining, the
# JAX recipe's first stages cut to prop 500 steps at 192x192, 110 chain-3
# steps at 256x448 and s2m 500, and fusion training on it (100
# iterations); full_protocol with fusion and without; the accuracy
# envelope with the fusion weights and its diagnosis. Weights go to
# $TMPDIR/long_accuracy_weights, logs and reports to OUT (default
# log/torch_long_accuracy, which git ignores). A protocol or envelope gate
# that fails prints its exit code and the run goes on.
#
#   bash scripts/torch_long_accuracy_run.sh [OUT]
set -o pipefail
OUT=${1:-log/torch_long_accuracy}
W=${TMPDIR:-/tmp}/long_accuracy_weights; mkdir -p $W $OUT
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -m mivos_tpu_torch.long_video_bench --limit 2>&1 | tee $OUT/lv_limit.log || exit 11
python -m mivos_tpu_torch.long_video_bench 2>&1 | tee $OUT/lv_300.log || exit 12
python -m mivos_tpu_torch.pretrain_synthetic --net prop --steps 500 --hw 192 --lr 2e-4 --chain 1 --seed 1000 --log-every 100 --out $W 2>&1 | tail -3 || exit 13
python -m mivos_tpu_torch.pretrain_synthetic --net prop --steps 110 --hw 256 448 --lr 1e-4 --chain 3 --seed 2000 --resume --log-every 50 --out $W 2>&1 | tail -3 || exit 14
python -m mivos_tpu_torch.pretrain_synthetic --net s2m --steps 500 --hw 192 --lr 2e-4 --seed 1000 --log-every 100 --out $W 2>&1 | tail -3 || exit 15
python -m mivos_tpu_torch.train_fusion_synthetic --root $W/fusion_syn --weights $W/prop_synthetic.pth --out $W/fusion_synthetic.pth --iterations 100 --videos 24 --frames 12 --hw 384 --separation 4 --batch 12 --report-every 10 --num-workers 8 2>&1 | tail -4 || exit 16
python -m mivos_tpu_torch.full_protocol --weights $W --fusion auto --out $OUT/fp_fusion.json > $OUT/fp_fusion.log 2>&1; echo "fusion protocol rc=$?"
grep -a "max per-round\|FULL-PROTOCOL\|total wall\|fusion:" $OUT/fp_fusion.log
python -m mivos_tpu_torch.full_protocol --weights $W --fusion off --out $OUT/fp_off.json > $OUT/fp_off.log 2>&1; echo "fusion-off protocol rc=$?"
grep -a "max per-round\|FULL-PROTOCOL\|total wall" $OUT/fp_off.log
python -m mivos_tpu_torch.accuracy_envelope --weights $W/prop_synthetic.pth --fusion-weights $W/fusion_synthetic.pth --dump-dir $W 2>&1 | tail -2; echo "envelope rc=${PIPESTATUS[0]}"
python -m mivos_tpu_torch.envelope_diagnose $W/envelope_arrays.npz --out $OUT/envelope_diagnosis.json 2>&1 | grep -a "flips\|decided\|DIAGNOSE"
