#!/bin/sh
# Build the native audio decoder shared library.
# Usage: build.sh [output.so]
set -e
cd "$(dirname "$0")"
OUT="${1:-libfadtk_audio.so}"
g++ -O2 -fPIC -shared -o "$OUT" decode.cc \
    -lavformat -lavcodec -lavutil -lswresample
echo "built $OUT"
