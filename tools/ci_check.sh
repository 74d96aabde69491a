#!/bin/sh
# CI-style gate (SURVEY.md section 7 step 8), mirroring the reference
# workflows (.github/workflows/x86-linux.yml:24-42): the test suite on
# the virtual CPU mesh plus the harness executables.  On a GPU machine
# the one-command check is `python chip_smoke.py`.
set -e
cd "$(dirname "$0")/.."

python -m pytest tests/ -q
python tools/run_simple.py --cpu
python tools/run_tests.py --cpu
python tools/run_punctured_decoder.py --cpu
echo "ci_check: ALL GREEN"
