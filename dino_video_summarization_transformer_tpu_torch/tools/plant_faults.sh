#!/bin/bash
# Plants each kernel fault in a copy of the tree and runs chip_smoke.py
# from the copy; each must exit 1 in phase 3 (the kernels against their
# plain twins). Run from the repository root on a machine with a CUDA
# card:
#
#     bash dino_video_summarization_transformer_tpu_torch/tools/plant_faults.sh
#
# Faults: the rowsum(dp * p) term dropped from the attention backward's
# ds; the proj weight gradient transposed (dY and X swapped in gemm_dw);
# the CLS row's gradient taken from the first frame only; the standalone
# attention's logit scale dropped; every strip of a multi-sequence
# attention block (the standalone attention's and the temporal
# attention's) scored against the block's first sequence's keys; the
# banded temporal attention's windows shifted by one frame; its rows'
# keys left unmasked past the window (the rest of the step's keys and the
# zero keys that pad its last 16-key block); the spatial attention of rows
# 2 and 11 without its CLS prefix key; the wgmma GEMM's second K stage of
# every tile replaced by its third (one stage of the ring skipped); the
# temporal attention of rows 1 and 6 reading (and writing) each
# sequence's rows at stride 1 instead of N. Name faults as arguments to
# run only those:
#
#     bash .../plant_faults.sh fa_unscaled fa_first_seq band_shifted band_pad_unmasked
#     bash .../plant_faults.sh cls_key_dropped gemm_stage_skipped temporal_stride_one
set -u
SRC=$(pwd)
ONLY="$*"
CSRC=dino_video_summarization_transformer_tpu_torch/ops/csrc
run() {
  name=$1; file=$2; expr=$3
  if [ -n "$ONLY" ] && [[ " $ONLY " != *" $name "* ]]; then return; fi
  dst=$(mktemp -d)
  (cd "$SRC" && tar --exclude=./build --exclude=./chiprun_out --exclude=./.git -cf - .) \
    | (cd "$dst" && tar xf -)
  f=$dst/$CSRC/$file
  before=$(md5sum < "$f"); sed -i "$expr" "$f"; after=$(md5sum < "$f")
  if [ "$before" = "$after" ]; then echo "FAULT $name: sed changed nothing"; rm -rf "$dst"; return; fi
  (cd "$dst" && timeout 600 python3 chip_smoke.py > out.log 2>&1); rc=$?
  echo "FAULT $name: exit $rc, last phase $(grep -o '^\[[0-9]\]' "$dst/out.log" | tail -1)"
  grep -E "FAILED|^FAIL" "$dst/out.log" | cut -c1-400 | head -8
  rm -rf "$dst"
}
run no_rowsum dvst_common.cuh 's/pf \* (p_w\[j\] - t) \* scale/pf * p_w[j] * scale/'
run dw_transposed fused_block_bwd.cu 's/gemm_dw(w.dproj, w.a,/gemm_dw(w.a, w.dproj,/'
run dcls_frame0 dvst_common.cuh 's/for (int t = 0; t < reps; ++t) s +=/for (int t = 0; t < 1; ++t) s +=/'
run fa_unscaled attention.cu 's/static_cast<bf16\*>(out), BH, L, G, scale);/static_cast<bf16*>(out), BH, L, G, 1.f);/'
run fa_first_seq tc_attention.cuh 's/kb, ke, lo0, lo0 + L, lo1, lo1 + L,/0, L, 0, L, 0, L,/g'
run band_shifted banded_block.cu 's/lo0 = band_lo(q0 + g, eff, hi), lo1 = band_lo(q0 + g + 8, eff, hi);/lo0 = band_lo(q0 + g, eff, hi) + 1, lo1 = band_lo(q0 + g + 8, eff, hi) + 1;/'
run band_pad_unmasked banded_block.cu 's/lo0, lo0 + eff, lo1, lo1 + eff,/lo0, 1 << 30, lo1, 1 << 30,/'
run cls_key_dropped tc_attention.cuh 's/const int k0 = 0;  \/\/ the first key: the prefix row/const int k0 = 1;/'
run gemm_stage_skipped wgmma_gemm.cuh 's/const int k0 = kt \* kWgBK;/const int k0 = (kt + (kt == 1)) * kWgBK;/'
run temporal_stride_one tc_attention.cuh 's/return ((long)b \* T + t) \* N + (s - b \* N);/return (long)s * T + t;/'
