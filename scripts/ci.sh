#!/usr/bin/env bash
# Full validation battery — what a CI job for this repo would run.
#   scripts/ci.sh          # everything except the GPU benchmark
#   scripts/ci.sh bench    # also run the GPU benchmark (one JSON line)
set -euo pipefail
cd "$(dirname "$0")/.."

echo "== oracle (-O2 + ASan/UBSan) =="
make -s -C oracle
make -s -C oracle asan

echo "== native planner build =="
python - <<'PY'
from hvqm4_jax.native import _build
print(_build())
PY

echo "== test suite (virtual 8-device CPU mesh) =="
python -m pytest tests/ -q

echo "== sanitizer spot-run on a sliced clip =="
python - <<'PY'
from hvqm4_jax.config import SeqConfig
from tools.encoder import make_clip
open('/tmp/ci_sliced.h4m','wb').write(
    make_clip(SeqConfig(128, 96), ['IPBPB'], seed=90, slices=4))
PY
oracle/hvqm4_oracle_asan /tmp/ci_sliced.h4m /dev/null
echo "sanitizer clean"

if [[ "${1:-}" == "bench" ]]; then
  echo "== GPU benchmark =="
  python bench.py
fi
echo "CI OK"
