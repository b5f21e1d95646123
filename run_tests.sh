#!/bin/bash
# Run the test suite on the CPU (tests/conftest.py adds 8 virtual devices).
#
# Usage: ./run_tests.sh [pytest args]     (default: the whole suite)
#        ./run_tests.sh tests/ -m 'not slow'   (the quick tier)

set -u
if [ $# -eq 0 ]; then set -- tests/; fi
JAX_PLATFORMS=cpu exec python -m pytest "$@" -q
