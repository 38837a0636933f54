#!/usr/bin/env bash
# GPU resource discovery script for Spark executors, in the shape of the
# getGpusResources.sh Spark ships. Configure with:
#   spark.executor.resource.gpu.discoveryScript=/path/to/get_gpus_resources.sh
# Prints one Spark ResourceInformation JSON line, e.g.
#   {"name": "gpu", "addresses": ["0", "1", "2", "3"]}
# and {"name": "gpu", "addresses": []} when it finds no GPU.
set -euo pipefail

quote() { sed 's/^ *//; s/ *$//' | { grep -v '^$' || true; } \
  | sed 's/.*/"&"/' | paste -sd, -; }

# Explicit pinning first; set but empty means no GPU is visible, as CUDA
# reads it. `|| true` in quote: grep exits 1 on zero matches, which would
# abort the script under pipefail instead of printing [].
if [[ -n "${CUDA_VISIBLE_DEVICES+set}" ]]; then
  ADDRS=$(echo "$CUDA_VISIBLE_DEVICES" | tr ',' '\n' | quote)
  echo "{\"name\": \"gpu\", \"addresses\": [${ADDRS}]}"
  exit 0
fi

# Then the driver's own listing, which needs no Python.
if command -v nvidia-smi >/dev/null 2>&1; then
  if OUT=$(nvidia-smi --query-gpu=index --format=csv,noheader 2>/dev/null); then
    ADDRS=$(echo "$OUT" | quote)
    if [[ -n "$ADDRS" ]]; then
      echo "{\"name\": \"gpu\", \"addresses\": [${ADDRS}]}"
      exit 0
    fi
  fi
fi

echo '{"name": "gpu", "addresses": []}'
