#!/usr/bin/env bash
# Launch the PyTorch port's HTTP service + web UI on the reference port
# 8527, on the card (the port's counterpart of scripts/serve.sh).
#
#   ./scripts/torch_serve.sh                          # defaults
#   MAS_DATA_ROOT=/data MAS_API_TOKEN=s3cret \
#   MAS_ASR_WEIGHTS=~/ckpts/whisper-base ./scripts/torch_serve.sh
#
# All MAS_* engine overrides (config_from_env) apply: sample rate, segment
# seconds, presets, weights paths, ingest batch, analyzer, short context.
set -euo pipefail
cd "$(dirname "$0")/.."
if [ -d .venv ]; then
    # shellcheck disable=SC1091
    source .venv/bin/activate
fi
exec python -m multimodal_audio_search_tpu_torch serve "$@"
