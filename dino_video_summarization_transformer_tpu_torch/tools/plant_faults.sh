#!/bin/bash
# Plants each kernel fault in a copy of the tree and runs chip_smoke.py
# from the copy; each must exit 1 in phase 3 (the kernels against their
# plain twins). Run from the repository root on a machine with a CUDA
# card:
#
#     bash dino_video_summarization_transformer_tpu_torch/tools/plant_faults.sh
#
# Faults: the rowsum(dp * p) term dropped from the attention backward's
# ds, in the tensor-core backward tile that rows 7 and 8 share (both
# passes), and in its key pass alone where a strip packs several
# sequences (row 7's temporal sequences, two to a strip at T = 8); the
# proj weight gradient transposed (dY and X swapped), in row 8's wgmma dW
# and in row 7's; row 8's tile leaving the CLS key's dk and dv unwritten;
# its dk summed over the first query strip only; row 7's strided tile with
# each row's keys (and each key's queries) masked to its strip, not its
# sequence, and reading (and writing) each sequence's rows at stride 1
# instead of N; the LayerNorm backward of rows 7-9 without its
# mean(dxh * xhat) term; the
# MN-major wgmma descriptor's two byte offsets swapped (every dX and dW of
# rows 7-9); the CLS row's gradient taken from the first frame only; the standalone
# attention's logit scale dropped; every strip of a multi-sequence
# attention block (the standalone attention's and the temporal
# attention's) scored against the block's first sequence's keys; the
# banded temporal attention's windows shifted by one frame; its rows'
# keys left unmasked past the window (the rest of the step's keys and the
# zero keys that pad its last 16-key block); the spatial attention of rows
# 2 and 11 without its CLS prefix key; the wgmma GEMM's second K stage of
# every tile replaced by its third (one stage of the ring skipped); the
# temporal attention of rows 1 and 6 reading (and writing) each
# sequence's rows at stride 1 instead of N; row 12's CLS window
# aggregation without the self key (its probability and its value), with
# every row's window shifted by one frame, and with each frame's P V
# divided by the sum of the exponentials over the strip's frames so far
# instead of its own pair's; row 5's attention over sequences of L - 1
# rows; the mixed teacher's f32 tiers: row 1's LN reading its f32 x as
# bf16 elements, row 2's wrapper handing the kernel the f32 CLS row
# rounded to bf16 before its LN, row 3's f32 residual read
# through the bf16-residual epilogue; the frame wire's gather
# (``wire.cu``): the V plane placed by whole rows (right only where
# H % 4 == 0; the 226-row frames of phase 3 show it), the colour math with
# a multiply and an add contracted into an FMA, bf16 rounded toward zero;
# and the scorer's uint8 RGB gather casting the bytes without normalizing
# them (the fault the wire's port repaired; it exits 1 in phase 4c, the
# others in phase 3); the int8 tier's kernels (each exits 1 in phase 4d):
# the codes rounded toward zero instead of to nearest even, the s8 GEMM's
# dequantization with its product by the channel scale and the bias add
# contracted into an FMA, the row scale dropped from the dequantization,
# the LN + quantize kernel quantizing its f32 LN row instead of its bf16
# rounding, and the quantization grid stretched to +-128 (the scale
# amax / 128), whose largest codes clip at 127; the trainer's mixed tier
# (each exits 1 in phase 7b): the f32 LayerNorm backward's dx rounded to
# bf16 at its store (rows 7f, 8f and 9f's dx), row 9f's db2 summed from
# the cotangent's bf16 copy instead of the f32 rows, the f32 LayerNorm
# backward reading each x value through a bf16 rounding, and row 4f's f32
# CLS rows rounded to bf16 (a sed of the Python wrapper); the strided
# scorer (each exits 1 in phase 4e; seds of the scorer): Catmull-Rom's
# tangent weights exchanged (cl <-> cr), and the student pass returning
# the chunks of a call of several (student_dispatch) in reverse order;
# the int8 tier's f32 boundary: row 2qf's fc2 taking its f32 residual
# through the bf16-residual epilogue (exits 1 in phase 4d); the banded
# mixed teacher: the teacher pass fed the students' bf16 views cast back
# to f32 (a sed of the scorer; exits 1 in phase 6b); the strided attention
# backward's whole-sequence strips (kSeqStrips, T >= 16, which only the
# rand-fr step's 16-frame locals reach) reading each row's cotangent from
# the next row of its sequence (rows r and r ^ 1 swapped; exits 1 in phase
# 7c).
# Name faults as arguments to run only those:
#
#     bash .../plant_faults.sh fa_unscaled fa_first_seq band_shifted band_pad_unmasked
#     bash .../plant_faults.sh cls_key_dropped gemm_stage_skipped temporal_stride_one
#     bash .../plant_faults.sh no_rowsum dw_transposed bwd_cls_key_dropped bwd_dk_first_strip dw_desc_offsets_swapped
#     bash .../plant_faults.sh no_rowsum_row7 dw_transposed_row7 bwd_strided_seq_unmasked bwd_temporal_stride_one ln_bwd_mean_term_dropped
#     bash .../plant_faults.sh cls_self_dropped cls_window_shifted cls_norm_over_frames attn_phase_seq_short
#     bash .../plant_faults.sh f32_in_read_as_bf16 cls_rounded_bf16 mixed_residual_bf16
#     bash .../plant_faults.sh wire_chroma_rows wire_fma wire_bf16_truncated u8_unnormalized
#     bash .../plant_faults.sh q8_round_rz q8_rescale_fma q8_no_row_scale q8_ln_unrounded q8_clip128
#     bash .../plant_faults.sh f32bwd_dx_bf16 f32bwd_db_from_bf16 f32_ln_bwd_x_bf16 f32_spatial_cls_bf16
#     bash .../plant_faults.sh cr_tangents_swapped dispatch_chunks_reversed
#     bash .../plant_faults.sh q8f_residual_bf16 band_mt_teacher_bf16
#     bash .../plant_faults.sh seq_strips_row_swapped f32_cls_b1_rounded
#
# A fault's file is relative to ops/csrc/ (../fused_block.py is the ops'
# Python module, ../../engine/scoring.py the scorer).
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
  (cd "$dst" && timeout 900 python3 chip_smoke.py > out.log 2>&1); rc=$?
  echo "FAULT $name: exit $rc, last phase $(grep -o '^\[[0-9]*[a-z]*\]' "$dst/out.log" | tail -1)"
  grep -E "FAILED|^FAIL" "$dst/out.log" | cut -c1-400 | head -8
  rm -rf "$dst"
}
run no_rowsum tc_attention.cuh 's/return p \* (dp - delta) \* scale;/return p * dp * scale;/'
run no_rowsum_row7 tc_attention.cuh 's/dpt\[t\]\[e\] = ok ? tc_ds(p, dpt\[t\]\[e\], dl\[x\], scale) : 0.f;/dpt[t][e] = ok ? tc_ds(p, dpt[t][e], L < 16 ? 0.f : dl[x], scale) : 0.f;/'
run dw_transposed fused_block_bwd.cu 's/wg_gemm_dw(w.dproj, w.a, static_cast<float\*>(dproj_w), w.part, R,/wg_gemm_dw(w.a, w.dproj, static_cast<float*>(dproj_w), w.part, R,/'
run dw_transposed_row7 fused_block_bwd.cu 's/wg_gemm_dw(w.dproj, w.a, static_cast<float\*>(dproj_w), w.part, M,/wg_gemm_dw(w.a, w.dproj, static_cast<float*>(dproj_w), w.part, M,/'
run bwd_cls_key_dropped tc_attention.cuh 's/return dst(k0 + r) + \(2 \* \)\?D; }/return k0 + r == 0 ? nullptr : dst(k0 + r) + \1D; }/'
run bwd_dk_first_strip tc_attention.cuh 's/      tc_acc_rows(dsa, Q, i0, sp.ke, zero, dk);/      if (i0 == sp.kb) tc_acc_rows(dsa, Q, i0, sp.ke, zero, dk);/'
run bwd_strided_seq_unmasked tc_attention.cuh 's/lo0 = (sp.r0 + g) \/ L \* L; lo1 = (sp.r0 + g + 8) \/ L \* L; hi0 = lo0 + L; hi1 = lo1 + L;/lo0 = sp.kb; lo1 = sp.kb; hi0 = sp.ke; hi1 = sp.ke;/'
run bwd_temporal_stride_one tc_attention.cuh 's/return ((long)b \* T + r % L) \* N + s % N;/return (long)s * T + r % L;/'
run ln_bwd_mean_term_dropped dvst_common.cuh 's/o\[e\] = rs \* (g\[CW \* c + e\] - m1 - xh \* m2);/o[e] = rs * (g[CW * c + e] - m1);/'
run dw_desc_offsets_swapped wgmma_gemm.cuh 's/((uint64_t)(kWgMnLbo >> 4) << 16) | ((uint64_t)(kWgMnSbo >> 4) << 32)/((uint64_t)(kWgMnSbo >> 4) << 16) | ((uint64_t)(kWgMnLbo >> 4) << 32)/'
run dcls_frame0 dvst_common.cuh 's/for (int t = 0; t < reps; ++t) s +=/for (int t = 0; t < 1; ++t) s +=/'
run fa_unscaled attention.cu 's/static_cast<bf16\*>(out), BH, L, G, scale);/static_cast<bf16*>(out), BH, L, G, 1.f);/'
run fa_first_seq tc_attention.cuh 's/sp.kb, sp.ke, lo0, lo0 + L, lo1, lo1 + L,/0, L, 0, L, 0, L,/g'
run band_shifted banded_block.cu 's/lo0 = band_lo(q0 + g, eff, hi), lo1 = band_lo(q0 + g + 8, eff, hi);/lo0 = band_lo(q0 + g, eff, hi) + 1, lo1 = band_lo(q0 + g + 8, eff, hi) + 1;/'
run band_pad_unmasked banded_block.cu 's/lo0, lo0 + eff, lo1, lo1 + eff,/lo0, 1 << 30, lo1, 1 << 30,/'
run cls_key_dropped tc_attention.cuh 's/const int k0 = 0;  \/\/ the first key: the prefix row/const int k0 = 1;/'
run gemm_stage_skipped wgmma_gemm.cuh 's/const int k0 = kt \* kBK;/const int k0 = (kt + (kt == 1)) * kBK;/'
run temporal_stride_one tc_attention.cuh 's/return ((long)b \* T + t) \* N + (s - b \* N);/return (long)s * T + t;/'
run cls_self_dropped banded_block.cu 's/const float e0 = ex2(fmaf(self0, sl, -mx0)), e1 = ex2(fmaf(self1, sl, -mx1));/const float e0 = 0.f, e1 = 0.f;/'
run cls_window_shifted banded_block.cu 's/const int lo0 = band_lo(i0 + r0 + g, eff, hi), lo1 = band_lo(i0 + r0 + g + 8, eff, hi);/const int lo0 = band_lo(i0 + r0 + g, eff, hi) + 1, lo1 = band_lo(i0 + r0 + g + 8, eff, hi) + 1;/'
run cls_norm_over_frames banded_block.cu 's/  float acc\[CH\]\[4\];                \/\/ the rows. running sums over their frames/  float acc[CH][4], lt0 = 0.f, lt1 = 0.f;/; s/const float inv0 = 1.f \/ (l0 + e0), inv1 = 1.f \/ (l1 + e1);/lt0 += l0 + e0; lt1 += l1 + e1; const float inv0 = 1.f \/ lt0, inv1 = 1.f \/ lt1;/'
run attn_phase_seq_short fused_block.cu 's/tc_strided_attn(hd, qkv, buf, S, L, 1, H,/tc_strided_attn(hd, qkv, buf, S, L - 1, 1, H,/'
run f32_in_read_as_bf16 fused_block.cu 's/e = ln_launch<float>(static_cast<const float\*>(x_), lw, lb, w.buf1, M, D, st);/e = ln_launch<bf16>(static_cast<const bf16*>(x_), lw, lb, w.buf1, M, D, st);/'
run cls_rounded_bf16 ../fused_block.py 's/_run(lib.dvst_spatial_mlp, x1.data_ptr(), cls.data_ptr(),/_run(lib.dvst_spatial_mlp, x1.data_ptr(), cls.to(torch.bfloat16).to(cls.dtype).data_ptr(),/'
run mixed_residual_bf16 fused_block.cu 's/wg_gemm<kEpiResF32F32>(w.hid, fc2_w, fc2_b, x_, out, M, D, Dh, st)/wg_gemm<kEpiResBf16F32>(w.hid, fc2_w, fc2_b, x_, out, M, D, Dh, st)/'
run wire_chroma_rows wire.cu 's|const long v_at = u_at + (long)(H / sub) \* cw;|const long v_at = u_at + (long)(H / (2 * sub)) * W;|'
run wire_fma wire.cu 's|r = clip255(__fadd_rn(c, __fmul_rn(kRV, e)));|r = clip255(fmaf(kRV, e, c));|'
run wire_bf16_truncated wire.cu 's|__float2bfloat16_rn|__float2bfloat16_rz|g'
run u8_unnormalized ../../engine/scoring.py 's|        if layout is not None:|        if layout not in (None, "rgb8"):|'
run q8_round_rz dvst_common.cuh 's/return fminf(fmaxf(rintf(__fdiv_rn(v, sx)), -127.f), 127.f);/return fminf(fmaxf(truncf(__fdiv_rn(v, sx)), -127.f), 127.f);/'
run q8_rescale_fma wgmma_gemm.cuh 's/lo\[t_\] = __fadd_rn(__fmul_rn(__fmul_rn(/lo[t_] = fmaf((__fmul_rn(/; s/rsx\[h\]), c\[t_\]\.x), b\[t_\]\.x);/rsx[h])), c[t_].x, b[t_].x);/'
run q8_no_row_scale wgmma_gemm.cuh 's/if (row0 + 8 \* h < M) rsx\[h\] = sx\[row0 + 8 \* h\];/rsx[h] = 1.f;/'
run q8_ln_unrounded dvst_common.cuh 's/v\[i\] = __bfloat162float(__float2bfloat16_rn(y));  \/\/ what gets quantized/v[i] = y;/'
run q8_clip128 dvst_common.cuh 's/return __fdiv_rn(fmaxf(amax, 1e-12f), 127.f);/return __fdiv_rn(fmaxf(amax, 1e-12f), 128.f);/'
run f32bwd_dx_bf16 dvst_common.cuh 's/        ln_store<CW>(dx + r \* D + d, o);/        if constexpr (sizeof(TX) == 4) { for (int e = 0; e < CW; ++e) o[e] = __bfloat162float(__float2bfloat16(o[e])); } ln_store<CW>(dx + r * D + d, o);/'
run f32bwd_db_from_bf16 fused_block_bwd.cu 's/if (!f32 \&\& (e = colsum<bf16>(dout, M, D, w.part, static_cast<float\*>(dfc2_b), st)))/if ((e = colsum<bf16>(dout, M, D, w.part, static_cast<float*>(dfc2_b), st)))/'
run f32_ln_bwd_x_bf16 dvst_common.cuh 's/float v(int i) const { return f\[i\]; }/float v(int i) const { return __bfloat162float(__float2bfloat16(f[i])); }/'
run f32_spatial_cls_bf16 ../fused_block.py 's/    launches\["spatial_phase_f32" if x_f32 else "spatial_phase"\] += 1/    launches["spatial_phase_f32" if x_f32 else "spatial_phase"] += 1; cls_rows = cls_rows.to(torch.bfloat16).to(cls_rows.dtype)/'
run cr_tangents_swapped ../../engine/scoring.py 's/w = np.stack(\[-cl, h00 - cr, h01 + cl, cr\], axis=1)/w = np.stack([-cr, h00 - cl, h01 + cr, cl], axis=1)/'
run dispatch_chunks_reversed ../../engine/scoring.py 's/for r0 in range(0, views.shape\[0\], c)\])/for r0 in range(0, views.shape[0], c)][::-1])/'
run q8f_residual_bf16 fused_block.cu 's/return wg_gemm_s8<kEpiResF32F32>(w.q, w.sx, fc2_w, fc2_s, fc2_b, w.x2, out, M, D, Dh, st);/return wg_gemm_s8<kEpiResBf16F32>(w.q, w.sx, fc2_w, fc2_s, fc2_b, w.x2, out, M, D, Dh, st);/'
run band_mt_teacher_bf16 ../../engine/scoring.py 's/            fr = self._gather(buf, idx, self.teacher_dtype)/            fr = self._gather(buf, idx, self.compute_dtype).to(self.teacher_dtype)/'
run seq_strips_row_swapped tc_attention.cuh 's/    cp_async16(dA.at(r, c), da + rr \* D + h \* HD + c \* 8, 16);/    cp_async16(dA.at(r, c), da + (kRows == kSeqStrips ? row(r ^ 1) : rr) * D + h * HD + c * 8, 16);/'
run f32_cls_b1_rounded ../fused_block.py 's/        _run(lib.dvst_spatial_mlp, x1.data_ptr(), cls.data_ptr(),/        _run(lib.dvst_spatial_mlp, x1.data_ptr(), (cls.to(torch.bfloat16).to(cls.dtype) if B == 1 else cls).data_ptr(),/'
