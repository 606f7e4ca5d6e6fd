#!/usr/bin/env bash
# The 8-round protocol's fast-vs-exact |dJ&F| in both packages, on the CPU,
# on one weight set made by chip_smoke.py's pretraining recipe (prop 500
# steps at 192x192, chain 3 at 256x448 from seed 2000 with a fresh Adam,
# S2M 500 steps at 192x192; fusion off).
#
#   JAX   scripts/full_protocol_tpu.py: bf16 towers and S2M with the
#         plain threshold read (`auto` on the CPU) against fp32 and the
#         exact read
#   port  python -m mivos_tpu_torch.full_protocol --device cpu: bf16
#         towers and S2M with the plain read against fp32, TF32 off, and
#         the exact read
#
# Both read the same .pth (the JAX side through its own converter into
# .npz) and the same synthetic sequences (seeds 100, 101). It tells
# whether a max per-round |dJ&F| past 0.01 on these weights is the
# port's or the protocol's.
#
# Usage: scripts/torch_protocol_witness.sh OUT_DIR [H W] [CHAIN3_STEPS]
#   (defaults 192 192 and 104, the chain-3 steps chip_smoke.py's 30 s box
#   took on an H100). Writes OUT_DIR/{jax,torch}.json and prints both
#   maxima. Run from the repo root; the CPU work takes about an hour on
#   8 cores.
set -euo pipefail
OUT=${1:?usage: $0 OUT_DIR [H W] [CHAIN3_STEPS]}
H=${2:-192}
W=${3:-192}
CHAIN3=${4:-104}
mkdir -p "$OUT"
export PYTHONPATH="$PWD${PYTHONPATH:+:$PYTHONPATH}"

pre() { python -m mivos_tpu_torch.pretrain_synthetic --device cpu --out "$OUT" \
          --log-every 100 "$@"; }
if [ ! -f "$OUT/s2m_synthetic.pth" ]; then
  pre --net prop --steps 500 --hw 192 --lr 2e-4 --seed 1000
  pre --net prop --resume --steps "$CHAIN3" --hw 256 448 --chain 3 --lr 1e-4 --seed 2000
  pre --net s2m --steps 500 --hw 192 --lr 2e-4 --seed 1000
fi

python - "$OUT" <<'EOF'
import sys

from mivos_tpu.checkpoint.convert import convert_prop_net, convert_s2m, load_torch_state_dict
from mivos_tpu.checkpoint.npz import save_params_npz

out = sys.argv[1]
for name, convert in (("prop", convert_prop_net), ("s2m", convert_s2m)):
    save_params_npz(f"{out}/{name}_synthetic.npz",
                    convert(load_torch_state_dict(f"{out}/{name}_synthetic.pth")))
EOF

# Each script writes its report before its own |dJ&F| gate; a breach is
# the reading, not a failure of this script.
MIVOS_PLATFORM=cpu python scripts/full_protocol_tpu.py --hw "$H" "$W" \
  --weights "$OUT" --fusion off --out "$OUT/jax.json" > "$OUT/jax.log" 2>&1 || true
python -m mivos_tpu_torch.full_protocol --hw "$H" "$W" --weights "$OUT" \
  --fusion off --device cpu --out "$OUT/torch.json" > "$OUT/torch.log" 2>&1 || true

python - "$OUT" <<'EOF'
import json
import sys

for side in ("jax", "torch"):
    with open(f"{sys.argv[1]}/{side}.json") as f:
        rep = json.load(f)
    recs = {t: rep[t]["summary"]["records"] for t in ("fast", "exact")}
    djf = [abs(a[1] - b[1]) for n in recs["fast"]
           for a, b in zip(recs["fast"][n], recs["exact"][n])]
    print(json.dumps({"side": side, "hw": rep["hw"], "max_round_jf_delta": max(djf),
                      "per_round_jf_delta": djf,
                      "auc": {t: rep[t]["summary"]["auc"] for t in ("fast", "exact")},
                      "jf": {t: {n: [jf for _, jf in r] for n, r in recs[t].items()}
                             for t in ("fast", "exact")}}))
EOF
