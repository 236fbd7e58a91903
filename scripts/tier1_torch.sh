#!/usr/bin/env bash
# The port's smoke gate: the staged liquidSVM cycle through the port's CLI
# as separate processes (the same steps scripts/tier1.sh runs through the
# JAX package's), then the LM launchers and one dry-run cell.
#   ./scripts/tier1_torch.sh              # on the CPU (the plain versions)
#   DEVICE=cuda ./scripts/tier1_torch.sh  # on the card (the kernels)
# It imports no JAX.  The dry run is a CPU tool on every machine.
set -euo pipefail
cd "$(dirname "$0")/.."
DEVICE=${DEVICE:-cpu}
export PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH}

SMOKE=$(mktemp -d)
trap 'rm -rf "$SMOKE"' EXIT
python - "$SMOKE" <<'PY'
import sys
import numpy as np
from repro_torch.data.synthetic import covtype_like, train_test_split
x, y = covtype_like(n=300, d=4, seed=0, label_noise=0.05, n_modes=3)
xtr, ytr, xte, yte = train_test_split(x, np.where(y == 0, -1, 1), 0.25, 0)
d = sys.argv[1]
np.save(f"{d}/xtr.npy", xtr); np.save(f"{d}/ytr.npy", ytr)
np.save(f"{d}/xte.npy", xte); np.save(f"{d}/yte.npy", yte)
PY
python -m repro_torch.cli train --data "$SMOKE/xtr.npy" \
  --labels "$SMOKE/ytr.npy" --model-dir "$SMOKE/model" --scenario npl \
  -S FOLDS=2 -S MAX_ITERATIONS=150 -S ADAPTIVITY_CONTROL=1 \
  -S WEIGHTS='0.5 1.0 2.0' --device "$DEVICE" > /dev/null
python -m repro_torch.cli select --model-dir "$SMOKE/model" \
  -S NPL_CONSTRAINT=0.05 --device "$DEVICE" > /dev/null
python -m repro_torch.cli test --data "$SMOKE/xte.npy" \
  --labels "$SMOKE/yte.npy" --model-dir "$SMOKE/model" --device "$DEVICE"
python -m repro_torch.cli serve --data "$SMOKE/xte.npy" \
  --model-dir "$SMOKE/model" --wave 16 --device "$DEVICE" \
  --out "$SMOKE/pred.npy" > "$SMOKE/serve_out.json"
python - "$SMOKE" <<'PY'
import sys
import numpy as np
pred = np.load(f"{sys.argv[1]}/pred.npy")
yte = np.load(f"{sys.argv[1]}/yte.npy")
assert pred.shape == yte.shape, (pred.shape, yte.shape)
assert (pred == np.sign(yte)).mean() > 0.5, "serve predictions degenerate"
PY
echo "tier1_torch: CLI smoke OK"

# the LM launchers (smoke configs) and the production-mesh dry run of one
# cell (a fake process group of 256 ranks, fake tensors)
python -m repro_torch.launch.train --arch stablelm-1.6b --steps 3 \
  --batch 2 --seq 32 --device "$DEVICE" > "$SMOKE/train.json"
python -m repro_torch.launch.serve --arch stablelm-1.6b \
  --device "$DEVICE" > "$SMOKE/serve.json"
python -m repro_torch.launch.serve --arch hubert-xlarge --device "$DEVICE"
python -m repro_torch.launch.dryrun --arch stablelm-1.6b \
  --shape decode_32k --mesh single --out "$SMOKE/dryrun.jsonl" > /dev/null
python - "$SMOKE" <<'PY'
import json
import math
import sys
d = sys.argv[1]
tr = json.loads(open(f"{d}/train.json").read().splitlines()[-1])
assert math.isfinite(tr["loss_first"]) and math.isfinite(tr["loss_last"]), tr
sv = json.loads(open(f"{d}/serve.json").read().splitlines()[-1])
assert sv["out_shape"] == [4, 32], sv
dr = json.loads(open(f"{d}/dryrun.jsonl").read().splitlines()[-1])
assert dr["n_devices"] == 256 and dr["flops"] > 0, dr
PY
echo "tier1_torch: launchers OK"
