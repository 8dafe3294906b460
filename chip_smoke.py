#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout; needs one CUDA card
    python3 chip_smoke.py --ab-training DIR   # the training cells (bf16, f32), DIR's tree against this one
    python3 chip_smoke.py --vocoder           # the fused vocoder kernels alone
    python3 chip_smoke.py --flash-f32         # the f32 flash kernels at head dim 64 alone
    python3 chip_smoke.py --vocoder-split DIR # the fused kernels' time split, DIR's tree against this one

`--vocoder` is the quick loop for the fused stage / tail kernels: it builds
only their library, logs ptxas's registers and spills, runs check_vocoder's
cases, times both kernels at T=512 and at the per-file main path's shapes
([1,40964,125] stage, [1,163856,62] tail, bf16) and the 41 s
hifigan_inference file's ([1,42244,125] / [1,168976,62], f32), on seeded
random inputs with full-width weights, each timed output held against its
plain version and each launch's block plan logged, holds VOC_REGS, and ends
with the same `ok` line. `--flash-f32` does the same for the f32 forward
(flash_f32_mode: the forward at HuBERT's shape, and the forward with lse,
dQ and dK/dV at both training shapes). Neither replaces the default run.

Phases (any failure exits non-zero, nothing is passed over):
  1. print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the ported paths from the checkout's sources
     (nvcc, sm_90a) into covomix_tpu_torch/_build/: the flash kernels (non-
     causal and causal, the rotary pre-pass) for the head dim 64 and for the
     edge head dims checked below (one nvcc per head dim) and the fused
     vocoder stage/tail library (both dtypes), all started together; log
     ptxas's registers, spills and wgmma notes, and hold the dh-64 flash
     kernels to FLASH_REGS and the fused vocoder kernels to VOC_REGS, with
     no spills;
  3. hold each kernel against its plain PyTorch version on the card, at the
     shapes the paths give it and at edge shapes, with stated tolerances:
     the rotary pre-pass bit for bit against `_rotary_plain`; the inference
     forward; the training forms (forward with lse, dQ,
     dK/dV); their causal forms (the T2S decoder's: [6, 8, 1026, 64], odd
     and even T 513-2050, T under 512, valid_len [1] < T and [B], rotary off
     and on, head dims 16-256, also the causal forward without lse); with
     the rotary tables, dQ and dK bit for bit against `_rotary_transpose` of
     the kernels' untabled outputs and within tolerance of the plain
     versions with the tables; autograd through the kernels against
     autograd through the plain version, in both forms; the fused vocoder
     stage and tail;
  4. run batched dialogue serving at full width (CoMix T2S -> VoMix flow ->
     HiFi-GAN, bf16, B=4, prompt 400, decode 512) with random weights from a
     seed: one warm-up batch, then timed batches; the flash kernel's launch
     count over one batch must be 8 layers x 16 steps x 2 evals = 256, and
     as many rotary pre-passes;
  5. time the kernels at the paths' shapes beside their plain versions, and
     hold each timed output against its plain version on the same inputs.
     Each kernel's `ms` is CUDA events around calls issued back to back, as
     a path issues them (a call's host side shows where it outlasts the
     kernel); `device_ms` the same calls queued behind a sleep kernel (the
     card's time alone). The forward's entry is the attention kernel alone;
     with the rotary pre-pass, as the flow sampler calls it, it is logged as
     `ms_with_prepass`. The host microseconds per call of the forward's
     wrapper are logged at the serving shape;
  6. per-file generation: full-width random checkpoints written with the
     port's save_params, two dialogue scripts with 400-frame prompts, and
     `covomix_tpu_torch.dialogue_generation.main([... --mode covomix
     --fuse_tail --device cuda ...])` in-process; every vocode must launch the
     fused stage and tail once each, every flow sample the flash kernel and
     the rotary pre-pass 256 times, and every wav be finite int16 of 160 x generated frames; the
     fused kernels are then checked and timed on the very inputs the last
     vocode gave them, and the flash kernel at the flow sample's shape;
  7. check small f32 runs on the card against the same runs on the CPU, with
     greedy decode and shared noise: batched serving (the flash kernel's
     plain version on the CPU), and the Synthesizer's covomix dialogue with
     fuse_tail and a full-width vocoder (the unfused generator on the CPU);
  8. full-width VoMix training (the recipe of running_command/Acous_VoMix.sh,
     bf16, B=8, T=832) through `covomix_tpu_torch.train.cli.main` on random
     data: 12 optimizer steps, one eval on 8 dev files and its top-k save,
     then `--resume` for one more step; every step must launch the forward
     with lse, dQ, dK/dV and the rotary pre-pass 8 times each (and nothing
     else), the eval only the forward without lse and the pre-pass; then the step's forward / backward / optimizer
     split, the three training kernels timed at [8, 16, 832, 64] beside
     their plain versions, bounds and PyTorch yardsticks (dQ and dK/dV with
     the rotary tables, as the step calls them; the pair against one SDPA
     gradient call; the PyTorch re-rotation and counter-rotation that the
     tables replaced), and two f32 steps of a tiny model on the card against
     the CPU;
  9. full-width CoMix T2S training (running_command/T2S_CoMix.sh on one card,
     bf16, B=6, the tokenizer's fallback vocab) through
     `covomix_tpu_torch.train.cli.main` on 24 + 6 random items of 520-1000
     codes: 12 optimizer steps, one eval (a 512-step decode) on the 6 dev
     files and its top-k save, then `--resume` for one more step; every step
     must launch the causal forward with lse, causal dQ and causal dK/dV 4
     times each (the 4 decoder layers) and no other flash kernel (the encoder
     stays below 512 ids, on layers.attend), the eval none; then the step's
     split at decoder T 1026, the three causal kernels timed at
     [6, 8, 1026, 64] beside their plain versions, bounds and
     `scaled_dot_product_attention(is_causal=True)` and its gradient, and two
     f32 steps of a tiny CoMix T2S model on the card against the CPU;
  9b. full-width training at the recipes' own precision (f32, the recipes
     of phases 8 and 9 without --bf16) on the same random items: 8
     optimizer steps each, no eval, no resume; every VoMix step must launch
     exactly 8 f32 forwards with lse, 8 dQ and 8 dK/dV (the tiled f32
     kernels; the backward takes the rotary tables, no pre-pass), every T2S
     step 4 causal ones of each, nothing else; finite losses; the median ms
     per step, samples/s, the forward / backward / optimizer split and the
     peak memory. Phases 8 and 9 also time the f32 forms of the three
     kernels (time_flash_f32: [8, 16, 832, 64] with the tables, [6, 8,
     1026, 64] causal) beside their plain versions, their bounds at the f32
     peak, f32 SDPA and its gradient, and the `_unrotate` passes the tables
     replace; with the tables dq and dk bit for bit against
     `_rotary_transpose` of the untabled kernels';
 10. the released checkpoint formats (run after phase 7, on phase 6's
     full-width trees): Lightning `.ckpt` files (hyper_parameters, an EMA
     shadow) of the CoMix T2S and VoMix models and a weight-normed HiFi-GAN
     `g_<step>` + vocoder_config.json, written by tests/_torch_ckpt.py and
     converted back by `python -m covomix_tpu_torch.convert_checkpoint`
     (every leaf equal to its source: bit for bit, the folded vocoder within
     CKPT_WN_RTOL); then one `serve_batch --device cuda` batch at the
     serving shape read straight from the `.ckpt` / `g_` files (256 flash
     launches and pre-passes, finite wavs of the expected lengths);
 11. `hifigan_inference --device cuda` from the `g_` file over four 8 kHz
     wavs (3, 10.24, 20, 41 s), f32, with --metrics_csv, with and without
     --fuse_tail: per file one f32 fused stage and tail launch with it and
     none without, finite wavs of output_length(T), finite CSV values, the
     two runs' wavs within HIFI_FUSED_TOL outside the generator's reach from
     the valid end; then the f32 stage and tail timed (and held to their
     plain versions) on the inputs the 41 s file gave them;
 12. HuBERT: `extract_semantic_tokens --device cuda` at full width (random
     seeded weights written to `.npz`) over twelve 16 kHz wavs of 3-60 s, in
     f32 and with --bf16: per batch 12 non-causal forwards without lse when
     its padded frames are >= 512 and none below (both routes occur), no
     rotary pre-pass, no other flash kernel; string arrays of
     num_output_frames ids in [0, 500); tokens/s and x realtime; one padded
     batch at 2 encoder layers card vs CPU in f32 (features within
     HUBERT_FEAT_TOL, the share of equal ids printed); the forward at the
     largest flash batch's shape in f32 and bf16, held to its plain version
     and timed beside it, SDPA in the same dtype and its bound;
 13. speculative decode at full width (on phase 4's VoMix / HiFi-GAN and
     phase 6's assets): (a) fit the draft heads of the serving CoMix T2S
     with the early exit at layer 2 (`train.loop.make_train_step`,
     `t2s_loss_fn`, bf16, Adam 3e-4, B=8, 24-id texts, targets of 576
     codes: bench.py's positional pattern for 480, then EOS) for 400 steps,
     each launching exactly 4 causal forwards with lse, 4 causal dQ and 4
     causal dK/dV and no other flash kernel, with finite losses and the
     first step's gradient on both draft heads; (b) greedy `generate`
     against `generate_speculative` at gamma 2, 4, 8 on 8 texts, max_length
     512: tokens equal in f32 (TF32 off), in bf16 equal up to a near-tie
     (SPEC_BF16_TIE), at most tokens / 2 verify rounds; bf16 walls best of
     3 and bench.py's t2s_spec_* keys; (c) BatchedPipeline(speculative=True,
     spec_gamma=4) at phase 4's shape: 256 flash forwards and pre-passes per
     batch, a finite wav, tokens a greedy decode's, the split beside phase
     4's; (d) `dialogue_generation --speculative` on phase 6's assets with
     the fitted T2S: phase 6's gates, tokens a greedy Synthesizer's;
 14. the one-program T2S decode (after phase 13, on phase 4's T2S and
     phase 13's fitted heads): `generate` as a captured CUDA graph against
     the same step called directly (text2semantic.CAPTURE off) at the
     serving shape (B=4, 512 steps, min_length 512, bf16 and f32) and the
     per-file shape (B=1, 2048 steps, bf16), and greedy / speculative
     (gamma 2 / 4 / 8) at B=8 in bf16: tokens equal (f32 exactly, bf16 up
     to hold_tokens' near-tie), num_steps equal, the generator's next draw
     equal; walls best of DECODE_TURNS in turns, ms per step or round, host
     reads per call, each graph's capture time, peak memory, and
     `util.profiling`'s device idle share of each decode window (phase 4
     adds one serving batch's, phase 8 one bf16 VoMix step's). Phases 4, 6,
     7, 9 and 13 decode through the graphs too, with their gates unchanged;
 15. print a `kernels` JSON line (phase 13's launches as
     `speculative_launches`) and, last, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))

H100_BF16_FLOPS = 989e12      # dense bf16 tensor-core peak (H100 SXM data sheet)
H100_F32_FLOPS = 67e12        # float32 outside the tensor cores (the f32 kernels' scalar FMAs; same sheet)
H100_BYTES_PER_S = 3.35e12    # HBM3 bandwidth (H100 SXM data sheet)
BF16_TOL = 1e-2               # |out| <~ 1: a few bf16 ulps (2^-8 at 1) of p and out rounding
F32_TOL = 1e-4                # f32: summation order and __expf vs expf only
LSE_TOL = 1e-4                # lse = m + log(l): |lse| ~ 10, l a sum of __expf terms (~2 ulps each)
# backward kernels against their plain versions in bf16: both round p and ds
# to bf16 at the same points and the outputs once, so an f32 sum taken in
# another order can only flip a rounding to the neighbouring value: a few
# ulps (2^-8 relative) of the output's scale at worst
BWD_BF16_TOL = 4 * 2 ** -8
# bf16 gradients through the autograd Function (kernels) against torch
# autograd through the plain forward: autograd rounds other intermediates
# (the gradient of p, of the rotated q and k) to bf16, so the two differ by
# several bf16 roundings; a wrong rotation or lse shows as errors of order 1
AUTOGRAD_BF16_TOL = 2 ** -4
AUTOGRAD_F32_TOL = 1e-5       # f32 both sides: summation order only
# card vs CPU wav of the small f32 serving run: both sides f32, so only
# summation order differs; an H100 80GB HBM3 read 2.98e-8, this is ~30x that
SMALL_WAV_TOL = 1e-6
SERVING_DH = 64
EDGE_DH = (16, 32, 48, 128, 256)   # 32: the small f32 model's head dim
# fused vocoder stage / tail against their plain versions. f32: both sides
# true f32 (TF32 off), only the summation order differs. bf16: both round at
# the same points, so an f32 sum taken in another order can only flip a
# rounding to the neighbouring bf16 value (2^-8 relative), which the later
# convs carry: a few ulps of the output's scale at worst, far less on average.
VOC_F32_TOL = 1e-5
VOC_BF16_TOL = 4 * 2 ** -8   # four ulps at 1, x max(1, max |plain|)
VOC_BF16_MEAN_TOL = 1e-4     # mean |err|, x max(1, max |plain|): flips are rare
# card vs CPU wav of the small f32 Synthesizer run: f32 both sides, the
# full-width vocoder's fused kernels on the card against the unfused
# generator (conv by conv) on the CPU
SMALL_SYNTH_WAV_TOL = 1e-5
# card vs CPU, two f32 training steps of a tiny model (flash kernels on the
# card, einsum attention on the CPU): the losses differ by summation order
# only; Adam divides each gradient element by its own size, so an element
# whose gradient is small next to its leaf's rounding noise moves by up to a
# few thousandths of the learning rate (1e-3): parameters to 1e-2 of it
SMALL_TRAIN_LOSS_TOL = 1e-5
SMALL_TRAIN_PARAM_TOL = 1e-5
# a Lightning / HiFi-GAN file converted back to .npz against its source
# tree: weight-norm folding g * v / |v| with g = |v| computed in another
# order gives w back within a few f32 roundings (3e-7 measured on the CPU)
CKPT_WN_RTOL = 1e-6
# hifigan_inference, --fuse_tail against the exact (valid_len) path, f32
# with TF32 off: the fused kernels against cuDNN's convs differ by summation
# order only (the small Synthesizer run read 3e-8 end to end)
HIFI_FUSED_TOL = 1e-5
# HuBERT features (full width, 2 encoder layers, post-LN so |x| ~ 1) card vs
# CPU in f32 with TF32 off: sums of up to 3072 terms in another order through
# 7 convs, 2 layers and 4 layernorms; a wrong mask or route shows as O(1)
HUBERT_FEAT_TOL = 1e-3
DIALOGUE_SCRIPT = ("hello there, how are you doing today? [spkchange] i am fine, thank you. "
                   "[spkchange] good to hear [laughter] see you soon")


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3, behind_sleep: bool = False) -> float:
    """ms per call of fn, by CUDA events around `iters` calls issued back to
    back, as a path issues them: where a call's host side (Python, checks,
    allocation, launch) outlasts its kernels, the card waits and the host's
    time is what shows. With `behind_sleep`, the calls are first queued
    behind a ~50 ms sleep kernel, so that the events time the card's work
    alone (the device time)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if behind_sleep:
        torch.cuda._sleep(100_000_000)   # SM cycles: ~50 ms at 1.98 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def both_times(results, key, fn, iters: int = 20) -> float:
    """results[f"{key}_ms"] (back to back) and results[f"{key}_device_ms"]
    (behind a sleep) of fn; returns the first."""
    results[f"{key}_device_ms"] = cuda_time_ms(fn, iters, behind_sleep=True)
    results[f"{key}_ms"] = cuda_time_ms(fn, iters)
    return results[f"{key}_ms"]


# ---------------------------------------------------------------------------
# phase 3: the flash kernel against its plain version


def flash_inputs(b, h, t, dh, dtype, seed, valid, rotary):
    import torch
    from covomix_tpu_torch.models import layers as L
    from covomix_tpu_torch.ops import flash_attention as FA

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((b, h, t, dh), generator=g, device="cuda").to(dtype) for _ in range(3))
    valid_arr = FA._valid_array(valid, b, t, "cuda")
    tables = None
    if rotary:
        tables = FA.rotary_tables_halfsplit(torch.arange(t, device="cuda"),
                                            L.rotary_freqs(dh, device="cuda"), dtype)
    return q, k, v, valid_arr, tables


def quick_case(f32_dh64: bool, dh, dtype) -> bool:
    """Whether a flash check case runs: every case, or with `f32_dh64` (the
    `--flash-f32` loop) only the f32 cases at head dim 64."""
    import torch

    return not f32_dh64 or (dh == 64 and dtype == torch.float32)


def check_flash(results, f32_dh64=False):
    import torch
    from covomix_tpu_torch.ops import flash_attention as FA

    cases = []
    for t in (512, 600, 912, 1024, 2048):
        cases += [(2, 4, t, 64, torch.bfloat16, t, False),
                  (2, 4, t, 64, torch.bfloat16, [1, t - 37], True)]
    cases += [(8, 16, 912, 64, torch.bfloat16, [912, 700, 1, 912, 912, 700, 1, 912], True),  # serving
              (2, 4, 600, 64, torch.float32, [600, 1], True),
              (4, 2, 512, 32, torch.float32, [512, 362, 512, 362], True),   # the small f32 run's shape
              (1, 2, 512, 16, torch.bfloat16, 300, True),
              (1, 2, 512, 32, torch.bfloat16, 300, False),
              (2, 2, 600, 48, torch.bfloat16, [555, 1], True),
              (1, 2, 600, 48, torch.float32, 600, True),
              (1, 2, 640, 128, torch.bfloat16, [500], True),
              (1, 2, 513, 128, torch.float32, 513, False),
              (2, 2, 700, 256, torch.bfloat16, [650, 700], True),
              (1, 2, 520, 256, torch.float32, 400, True)]
    worst = 0.0
    for i, (b, h, t, dh, dtype, valid, rotary) in enumerate(cases):
        if not quick_case(f32_dh64, dh, dtype):
            continue
        q, k, v, valid_arr, tables = flash_inputs(b, h, t, dh, dtype, i, valid, rotary)
        out = FA.KERNEL(q, k, v, valid_arr, tables)
        ref = FA.flash_attention_plain(q, k, v, valid_arr, tables)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        ok = bool(torch.isfinite(out).all()) and err <= tol
        log(f"flash check [{b},{h},{t},{dh}] {str(dtype)[6:]} valid={valid} rotary={rotary}: "
            f"max_abs_err {err:.3e} (tol {tol:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash kernel disagrees with its plain version at case {i}")
        if dtype == torch.bfloat16:
            worst = max(worst, err)
    results["flash_check_max_abs_err"] = worst


def flash_agreement(what, out, ref, tol):
    """Max |out - ref| of a flash kernel's output (out, lse, dq, dk, dv)
    against its plain version, held to tol x max(1, max |plain|) (both round
    at the same points, so only the order of f32 sums differs); logged,
    raises on disagreement."""
    import torch

    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    scale = max(1.0, ref.float().abs().max().item())
    ok = (out.shape == ref.shape and out.dtype == ref.dtype and bool(torch.isfinite(out).all())
          and err.max().item() <= tol * scale)
    log(f"  {what}: max_abs_err {err.max().item():.3e}, mean {err.mean().item():.3e}, |plain| max {scale:.3g} "
        f"(tol {tol:g} x max(1, |plain|)) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: the kernel disagrees with its plain version")
    return err.max().item()


def check_flash_training_case(b, h, t, dh, dtype, seed, valid, rotary, causal=False):
    """The forward with lse, dQ and dK/dV against their plain versions on the
    same inputs (causal: also the causal forward without lse); returns
    {kernel: max_abs_err}."""
    import torch
    from covomix_tpu_torch.ops import flash_attention as FA

    q, k, v, valid_arr, tables = flash_inputs(b, h, t, dh, dtype, seed, valid, rotary)
    dout = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(seed + 1000),
                       device="cuda").to(dtype)
    bf16 = dtype == torch.bfloat16
    log(f"flash training check [{b},{h},{t},{dh}] {str(dtype)[6:]} valid={valid} rotary={rotary} "
        f"causal={causal}:")
    out, lse = FA.KERNEL(q, k, v, valid_arr, tables, return_lse=True, causal=causal)
    ref, ref_lse = FA.flash_attention_plain(q, k, v, valid_arr, tables, return_lse=True, causal=causal)
    out_tol = BF16_TOL if bf16 else F32_TOL
    errs = {"fwd_lse": max(flash_agreement("out", out, ref, out_tol),
                           flash_agreement("lse", lse, ref_lse, LSE_TOL))}
    if causal:
        errs["fwd"] = flash_agreement("out without lse", FA.KERNEL(q, k, v, valid_arr, tables, causal=True), ref,
                                      out_tol)
    if tables is not None:
        # _FlashCoreRot rotates with the pre-pass (bf16) or _rotary_plain
        # (f32) and the backward reads what it saved: the kernel's own rotary
        # (bf16: the pre-pass; f32: in shared memory) must give the very
        # operands _rotary_plain gives, bit for bit
        q, k = FA._rotary_plain(q, *tables), FA._rotary_plain(k, *tables)
        out2, lse2 = FA.KERNEL(q, k, v, valid_arr, None, return_lse=True, causal=causal)
        same = torch.equal(out2, out) and torch.equal(lse2, lse)
        log(f"  kernel's rotary == _rotary_plain then the kernel, bit for bit: {same}")
        if not same:
            raise AssertionError("the kernel's rotary differs from _rotary_plain")
    delta = FA.flash_delta(dout, ref)
    tol = BWD_BF16_TOL if bf16 else F32_TOL
    bwd = (q, k, v, dout, ref_lse, delta, valid_arr, causal)
    errs["bwd_dq"] = flash_agreement("dq", FA.KERNEL.bwd_dq(*bwd), FA.flash_bwd_dq_plain(*bwd), tol)
    (dk, dv), (dk_p, dv_p) = FA.KERNEL.bwd_dkv(*bwd), FA.flash_bwd_dkv_plain(*bwd)
    errs["bwd_dkv"] = max(flash_agreement("dk", dk, dk_p, tol), flash_agreement("dv", dv, dv_p, tol))
    for bi in range(b):
        vl = int(valid_arr[bi if valid_arr.numel() > 1 else 0])
        if not (bool((dk[bi, :, vl:] == 0).all()) and bool((dv[bi, :, vl:] == 0).all())):
            raise AssertionError(f"key rows past valid_len {vl} did not get exact zeros")
    if tables is not None and FA.backward_takes_tables(q):
        # with the tables (bf16, and f32 at head dim 64), dq and dk leave
        # through the rotary's transpose (in the epilogue, or a pass after the
        # kernels that have none): bit-equal to _rotary_transpose of the
        # untabled outputs, and held to the plain versions with the tables
        dq_t = FA.KERNEL.bwd_dq(*bwd, rotary=tables)
        dk_t, dv_t = FA.KERNEL.bwd_dkv(*bwd, rotary=tables)
        dq = FA.KERNEL.bwd_dq(*bwd)
        same = (torch.equal(dq_t, FA._rotary_transpose(dq, *tables))
                and torch.equal(dk_t, FA._rotary_transpose(dk, *tables)) and torch.equal(dv_t, dv))
        log(f"  with tables: dq, dk == _rotary_transpose of the untabled kernels', dv unchanged, bit for bit: {same}")
        if not same:
            raise AssertionError("the backward's rotary transpose differs from _rotary_transpose")
        errs["bwd_dq"] = max(errs["bwd_dq"], flash_agreement("dq with tables", dq_t,
                                                             FA.flash_bwd_dq_plain(*bwd, rotary=tables), tol))
        errs["bwd_dkv"] = max(errs["bwd_dkv"], flash_agreement("dk with tables", dk_t,
                                                               FA.flash_bwd_dkv_plain(*bwd, rotary=tables)[0], tol))
    return errs


def check_flash_training(results, f32_dh64=False):
    """The training form of the flash kernels against their plain versions,
    in bf16 and f32: the training shape [8, 16, 832, 64], a ragged T, T above
    2048, valid_len [1] < T and [B], rotary on and off, the edge head dims;
    then the gradients of the autograd Function on the card against torch
    autograd through flash_attention_plain."""
    import torch
    from covomix_tpu_torch.ops import flash_attention as FA

    bf, f32 = torch.bfloat16, torch.float32
    cases = [(8, 16, 832, 64, bf, 832, True),                     # the training shape
             (2, 4, 832, 64, f32, 832, True),
             (2, 4, 300, 64, bf, [300, 1], True), (2, 4, 1026, 64, bf, [1026, 700], True),   # 2-row last tile
             (2, 4, 1000, 64, bf, [1000, 613], True), (2, 4, 1000, 64, f32, [1000, 613], False),
             (1, 2, 2100, 64, bf, 2100, False), (1, 2, 2100, 64, f32, 1500, True),
             (2, 2, 2304, 64, bf, 1999, True),
             (2, 2, 600, 16, bf, [600, 1], True), (1, 2, 520, 16, f32, 400, False),
             (2, 2, 700, 32, bf, [650, 700], True), (1, 2, 513, 32, f32, 513, True),
             (2, 2, 600, 48, bf, [555, 1], True), (1, 2, 600, 48, f32, 600, False),
             (1, 2, 640, 128, bf, [500], True), (2, 2, 513, 128, f32, [513, 200], True),
             (2, 2, 700, 256, bf, [650, 700], True), (1, 2, 520, 256, f32, 400, True)]
    worst = {}
    for i, (b, h, t, dh, dtype, valid, rotary) in enumerate(cases):
        if not quick_case(f32_dh64, dh, dtype):
            continue
        errs = check_flash_training_case(b, h, t, dh, dtype, 200 + i, valid, rotary)
        if dtype == bf:
            for key, e in errs.items():
                worst[key] = max(worst.get(key, 0.0), e)
    for key, e in worst.items():
        results[f"{key}_check_max_abs_err"] = e

    # gradients of _FlashCoreRot (rotary, kernel forward with lse, dQ and
    # dK/dV with the tables) against torch autograd through the plain version
    for b, h, t, dtype, valid, tol in ((2, 4, 1000, f32, [1000, 613], F32_TOL),
                                       (8, 16, 832, bf, 832, AUTOGRAD_BF16_TOL)):
        if not quick_case(f32_dh64, 64, dtype):
            continue
        q, k, v, valid_arr, tables = flash_inputs(b, h, t, 64, dtype, 300 + t, valid, True)
        w = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(7), device="cuda").to(dtype)
        grads = []
        for fn in (lambda q, k, v: FA.flash_attention(q, k, v, valid_len=valid_arr, rotary=tables),
                   lambda q, k, v: FA.flash_attention_plain(q, k, v, valid_arr, tables)):
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            out = fn(*leaves)
            grads.append(torch.autograd.grad((out.float() * w.float()).sum(), leaves))
        log(f"autograd through the kernels vs through the plain version [{b},{h},{t},64] {str(dtype)[6:]} "
            f"valid={valid} rotary:")
        for name, a, r in zip(("dq", "dk", "dv"), *grads):
            flash_agreement(name, a, r, tol)


def check_flash_causal(results, f32_dh64=False):
    """The causal form of the three kernels (the T2S training decoder's) against
    their plain versions, in bf16 and f32: the T2S step's shape [6, 8, 1026,
    64], odd T 513 / 1025 / 2049 and even 2050 (one live row in the last
    tile, or two), T under 512, valid_len [1] < T and [B] with a row < T,
    rotary off (the T2S path) and on, the edge head dims; then the gradients
    of the autograd Function with causal=True against torch autograd through
    the plain forward. Every key row past valid_len must get exact zeros."""
    import torch
    from covomix_tpu_torch.ops import flash_attention as FA

    bf, f32 = torch.bfloat16, torch.float32
    cases = [(6, 8, 1026, 64, bf, 1026, False),                    # the T2S step's shape
             (2, 4, 1026, 64, f32, 1026, False),
             (2, 4, 513, 64, bf, [513, 300], False), (2, 4, 513, 64, f32, [513, 300], False),
             (2, 4, 1025, 64, bf, 700, False), (2, 4, 1025, 64, f32, [1025, 1], False),
             (1, 2, 2049, 64, bf, 2049, False), (1, 2, 2050, 64, f32, 1999, False),
             (2, 2, 2050, 64, bf, [2050, 1234], False),
             (2, 4, 300, 64, bf, [300, 1], False), (2, 4, 300, 64, f32, 300, False),
             (2, 4, 600, 64, bf, [600, 451], True), (1, 2, 600, 64, f32, 600, True),
             (2, 2, 513, 16, bf, [513, 200], False), (1, 2, 520, 16, f32, 400, True),
             (2, 2, 700, 32, bf, [650, 700], True), (1, 2, 600, 32, f32, 600, False),
             (2, 2, 520, 48, bf, [520, 1], True), (1, 2, 600, 48, f32, 555, False),
             (1, 2, 640, 128, bf, [500], False), (2, 2, 513, 128, f32, [513, 200], True),
             (2, 2, 700, 256, bf, [650, 700], False), (1, 2, 520, 256, f32, 400, True)]
    worst = {}
    for i, (b, h, t, dh, dtype, valid, rotary) in enumerate(cases):
        if not quick_case(f32_dh64, dh, dtype):
            continue
        errs = check_flash_training_case(b, h, t, dh, dtype, 500 + i, valid, rotary, causal=True)
        if dtype == bf:
            for key, e in errs.items():
                worst[key] = max(worst.get(key, 0.0), e)
    for key, e in worst.items():
        results[f"{key}_causal_check_max_abs_err"] = e

    for b, h, t, dtype, valid, tol in ((2, 4, 1025, f32, [1025, 613], AUTOGRAD_F32_TOL),
                                       (6, 8, 1026, bf, 1026, AUTOGRAD_BF16_TOL)):
        if not quick_case(f32_dh64, 64, dtype):
            continue
        q, k, v, valid_arr, _ = flash_inputs(b, h, t, 64, dtype, 600 + t, valid, False)
        w = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(8), device="cuda").to(dtype)
        grads = []
        for fn in (lambda q, k, v: FA.flash_attention(q, k, v, valid_len=valid_arr, causal=True),
                   lambda q, k, v: FA.flash_attention_plain(q, k, v, valid_arr, causal=True)):
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            grads.append(torch.autograd.grad((fn(*leaves).float() * w.float()).sum(), leaves))
        log(f"causal autograd through the kernels vs through the plain version [{b},{h},{t},64] "
            f"{str(dtype)[6:]} valid={valid}:")
        for name, a, r in zip(("dq", "dk", "dv"), *grads):
            flash_agreement(name, a, r, tol)


def check_rotary_prepass(results):
    """The bf16 rotary pre-pass against `_rotary_plain`, bit for bit
    (torch.equal): at the serving shape [8, 16, 912, 64], at odd T, with
    tables longer than T, and at the edge head dims."""
    import torch
    from covomix_tpu_torch.models import layers as L
    from covomix_tpu_torch.ops import flash_attention as FA

    for b, h, t, dh in ((8, 16, 912, 64), (2, 3, 301, 64), (1, 2, 1027, 64), (2, 2, 77, 16), (1, 2, 99, 48),
                        (1, 2, 65, 128), (1, 1, 33, 256)):
        q, k, _, _, tables = flash_inputs(b, h, t, dh, torch.bfloat16, 40 + t, t, True)
        if t == 1027:   # tables of 1100 positions, the first T of them used
            tables = FA.rotary_tables_halfsplit(torch.arange(1100, device="cuda"),
                                                L.rotary_freqs(dh, device="cuda"), torch.bfloat16)
        before = FA.KERNEL.rotary_launches
        qr, kr = FA.KERNEL.rotary(q, k, *tables)
        torch.cuda.synchronize()
        cos, sin = tables[0][:t], tables[1][:t]
        same = torch.equal(qr, FA._rotary_plain(q, cos, sin)) and torch.equal(kr, FA._rotary_plain(k, cos, sin))
        log(f"rotary pre-pass [{b},{h},{t},{dh}] == _rotary_plain, bit for bit: {same}")
        if not same or FA.KERNEL.rotary_launches != before + 1:
            raise AssertionError(f"the rotary pre-pass differs from _rotary_plain at [{b},{h},{t},{dh}]")
    results["rotary_check_bit_equal"] = True


def time_flash(results, key, b, t, valid):
    """The forward at [b, 16, t, 64] bf16 with rotary and a run's own valid
    lengths (one per row, or one for all): the attention kernel alone on the
    pre-rotated inputs (results[f"{key}_ms"] etc., the kernel's own entry),
    the rotary pre-pass (f"{key}_rotary_*"), the two together as the path
    calls them (f"{key}_with_prepass_ms": the gated number), each back to
    back and behind a sleep (`both_times`), beside the plain version and the
    SDPA yardstick on the pre-rotated inputs. The forward's output on the
    timed inputs is held against the plain version's (BF16_TOL)."""
    import torch
    import torch.nn.functional as F
    from covomix_tpu_torch.ops import flash_attention as FA

    h, dh = 16, 64
    q, k, v, valid_arr, tables = flash_inputs(b, h, t, dh, torch.bfloat16, 99, valid, True)
    out = FA.KERNEL(q, k, v, valid_arr, tables)
    ref = FA.flash_attention_plain(q, k, v, valid_arr, tables)
    err = results[f"{key}_max_abs_err"] = (out.float() - ref.float()).abs().max().item()
    ok = bool(torch.isfinite(out).all()) and err <= BF16_TOL
    log(f"flash check at the timed inputs [{b},{h},{t},{dh}] bf16: max_abs_err {err:.3e} (tol {BF16_TOL:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash kernel disagrees with its plain version at [{b},{h},{t},{dh}]")
    del out, ref
    both = both_times(results, f"{key}_with_prepass", lambda: FA.KERNEL(q, k, v, valid_arr, tables))
    qr, kr = FA._rotary_plain(q, *tables), FA._rotary_plain(k, *tables)
    time_rotary_prepass(results, f"{key}_rotary", q, k, tables)
    ms = both_times(results, key, lambda: FA.KERNEL(qr, kr, v, valid_arr, None))
    results[f"{key}_plain_ms"] = cuda_time_ms(lambda: FA.flash_attention_plain(qr, kr, v, valid_arr, None),
                                              iters=5)
    mask = None
    if int(valid_arr.min()) < t:
        mask = (torch.arange(t, device="cuda")[None, :] < valid_arr[:, None])[:, None, None, :]
    both_times(results, f"{key}_library", lambda: F.scaled_dot_product_attention(qr, kr, v, attn_mask=mask))
    live = valid_arr.long().expand(b).sum().item()
    flops = 4.0 * h * dh * t * live
    nbytes = 4 * b * h * t * dh * 2 + valid_arr.numel() * 4   # q, k, v read, out written; valid
    bound_flops_ms, bound_bytes_ms = flops / H100_BF16_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    bound = results[f"{key}_bound_ms"] = max(bound_flops_ms, bound_bytes_ms)
    by = results[f"{key}_bound_by"] = "operations" if bound_flops_ms >= bound_bytes_ms else "bytes"
    r = {name: results[f"{key}{part}"] for name, part in (
        ("prepass", "_rotary_ms"), ("prepass_dev", "_rotary_device_ms"), ("dev", "_device_ms"),
        ("both_dev", "_with_prepass_device_ms"), ("sdpa", "_library_ms"), ("sdpa_dev", "_library_device_ms"))}
    log(f"flash timing [{b},{h},{t},{dh}] bf16 rotary, valid={valid_arr.tolist()} (ms back to back / behind a "
        f"sleep): pre-pass + attention {both:.4f} / {r['both_dev']:.4f}; pre-pass {r['prepass']:.4f} / "
        f"{r['prepass_dev']:.4f}; attention {ms:.4f} / {r['dev']:.4f}; SDPA {r['sdpa']:.4f} / {r['sdpa_dev']:.4f}; "
        f"plain {results[f'{key}_plain_ms']:.4f}; bound {bound:.4f} ({by}: {flops / 1e9:.2f} GFLOP, "
        f"{nbytes / 1e6:.1f} MB) -> attention {flops / r['dev'] / 1e9:.1f} TFLOP/s on the card")


def time_rotary_prepass(results, key, q, k, tables):
    """The rotary pre-pass on q, k (bf16 [B, H, T, dh]) beside `_rotary_plain`
    of both (its plain version, and the one PyTorch call per tensor that
    computes the same function, timed once for both fields) and its bound:
    bytes, each of q, k read and each of their rotated copies written once,
    the tables read once."""
    from covomix_tpu_torch.ops import flash_attention as FA

    t = q.shape[2]
    cos, sin = tables[0][:t], tables[1][:t]
    ms = both_times(results, key, lambda: FA.KERNEL.rotary(q, k, cos, sin), iters=50)
    plain = cuda_time_ms(lambda: (FA._rotary_plain(q, cos, sin), FA._rotary_plain(k, cos, sin)), iters=20)
    results[f"{key}_plain_ms"] = results[f"{key}_library_ms"] = plain
    nbytes = 4 * q.numel() * 2 + 2 * cos.numel() * 2
    results[f"{key}_bound_ms"] = nbytes / H100_BYTES_PER_S * 1e3
    results[f"{key}_bound_by"] = "bytes"
    qr, kr = FA.KERNEL.rotary(q, k, cos, sin)
    same = bool((qr == FA._rotary_plain(q, cos, sin)).all() and (kr == FA._rotary_plain(k, cos, sin)).all())
    results[f"{key}_max_abs_err"] = 0.0 if same else float("inf")
    log(f"rotary pre-pass timing {list(q.shape)} bf16: {ms:.4f} ms back to back, "
        f"{results[f'{key}_device_ms']:.4f} ms behind a sleep, _rotary_plain of q and k {plain:.4f} ms, bound "
        f"{results[f'{key}_bound_ms']:.4f} ms (bytes: {nbytes / 1e6:.1f} MB) -> "
        f"{nbytes / results[f'{key}_device_ms'] / 1e6:.1f} GB/s on the card; bit-equal on the timed inputs {same}")
    if not same:
        raise AssertionError("the rotary pre-pass differs from _rotary_plain on the timed inputs")


def flash_host_us(b=8, h=16, t=912, dh=64, iters=100) -> dict:
    """Host microseconds per call of the bf16 forward's wrapper
    (`flash_attention.KERNEL`: checks, allocations, ctypes launches) at
    [b, h, t, dh]: the host clock around `iters` calls while the card is kept
    busy behind a sleep kernel, so no call waits for the card. "forward with
    rotary" is the call the flow sampler makes (tables given); "attention
    alone" the same call on pre-rotated q and k, without tables."""
    import torch
    from covomix_tpu_torch.ops import flash_attention as FA

    q, k, v, valid_arr, tables = flash_inputs(b, h, t, dh, torch.bfloat16, 98, t, True)
    qr, kr = FA._rotary_plain(q, *tables), FA._rotary_plain(k, *tables)
    calls = {"forward with rotary": lambda: FA.KERNEL(q, k, v, valid_arr, tables),
             "attention alone": lambda: FA.KERNEL(qr, kr, v, valid_arr, None)}
    out = {}
    for name, fn in calls.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)   # ~100 ms: longer than the host takes to issue the calls
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        out[name] = (time.perf_counter() - t0) / iters * 1e6
        torch.cuda.synchronize()
    return out


def time_flash_host(results):
    us = results["flash_host_us"] = flash_host_us()
    log("flash forward wrapper, host us per call at [8,16,912,64] bf16: "
        + ", ".join(f"{name} {v:.1f}" for name, v in us.items()))


def bound_and_log(results, key, shape, flops, nbytes, f32=False):
    """results[f"{key}_bound_ms"] / f"{key}_bound_by" from the work's operations
    (over the bf16 tensor-core peak, or with `f32` the f32 FMA peak) and
    bytes, and one log line of the kernel's, plain version's and library
    call's times (back to back / behind a sleep)."""
    bf_ms, bb_ms = flops / (H100_F32_FLOPS if f32 else H100_BF16_FLOPS) * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    bound = results[f"{key}_bound_ms"] = max(bf_ms, bb_ms)
    by = results[f"{key}_bound_by"] = "operations" if bf_ms >= bb_ms else "bytes"
    dev = results[f"{key}_device_ms"]
    log(f"{key} timing {shape} {'f32' if f32 else 'bf16'} (ms back to back / behind a sleep): kernel "
        f"{results[f'{key}_ms']:.4f} / "
        f"{dev:.4f}, library {results[f'{key}_library_ms']:.4f} / {results[f'{key}_library_device_ms']:.4f}, "
        f"plain {results[f'{key}_plain_ms']:.4f}, bound {bound:.4f} ({by}: {flops / 1e9:.2f} GFLOP, "
        f"{nbytes / 1e6:.1f} MB) -> {flops / dev / 1e9:.1f} TFLOP/s on the card")


def time_flash_training(results, b=8, h=16, t=832, dh=64):
    """The forward with lse, dQ and dK/dV at the training shape (bf16, rotary,
    all keys live), each beside its plain version, its bound and one PyTorch
    call of the same function: SDPA on the pre-rotated inputs for the
    forward, the gradient of SDPA (one call computes dQ, dK and dV) for the
    pair. The outputs on the timed inputs are held against the plain
    versions'."""
    import torch
    import torch.nn.functional as F
    from covomix_tpu_torch.ops import flash_attention as FA

    bf = torch.bfloat16
    q, k, v, valid_arr, tables = flash_inputs(b, h, t, dh, bf, 401, t, True)
    dout = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(402), device="cuda").to(bf)
    log(f"flash training kernels at the timed inputs [{b},{h},{t},{dh}] bf16 rotary:")
    out, lse = FA.KERNEL(q, k, v, valid_arr, tables, return_lse=True)
    ref, ref_lse = FA.flash_attention_plain(q, k, v, valid_arr, tables, return_lse=True)
    results["fwd_lse_max_abs_err"] = max(flash_agreement("out", out, ref, BF16_TOL),
                                         flash_agreement("lse", lse, ref_lse, LSE_TOL))
    qr, kr = FA._rotary_plain(q, *tables), FA._rotary_plain(k, *tables)
    delta = FA.flash_delta(dout, ref)
    bwd = (qr, kr, v, dout, ref_lse, delta, valid_arr, False)
    # as the VoMix step calls them: rotated q and k, the tables (dq and dk
    # leave through the rotary's transpose)
    dq = FA.KERNEL.bwd_dq(*bwd, rotary=tables)
    results["bwd_dq_max_abs_err"] = flash_agreement("dq", dq, FA.flash_bwd_dq_plain(*bwd, rotary=tables),
                                                    BWD_BF16_TOL)
    (dk, dv), (dk_p, dv_p) = FA.KERNEL.bwd_dkv(*bwd, rotary=tables), FA.flash_bwd_dkv_plain(*bwd, rotary=tables)
    results["bwd_dkv_max_abs_err"] = max(flash_agreement("dk", dk, dk_p, BWD_BF16_TOL),
                                         flash_agreement("dv", dv, dv_p, BWD_BF16_TOL))
    del out, ref, dk, dv, dk_p, dv_p

    timed = {   # the forward's entry is the attention kernel alone, on the pre-rotated inputs
        "fwd_lse": (lambda: FA.KERNEL(qr, kr, v, valid_arr, None, return_lse=True),
                    lambda: FA.flash_attention_plain(qr, kr, v, valid_arr, None, return_lse=True)),
        "bwd_dq": (lambda: FA.KERNEL.bwd_dq(*bwd, rotary=tables),
                   lambda: FA.flash_bwd_dq_plain(*bwd, rotary=tables)),
        "bwd_dkv": (lambda: FA.KERNEL.bwd_dkv(*bwd, rotary=tables),
                    lambda: FA.flash_bwd_dkv_plain(*bwd, rotary=tables)),
    }
    for key, (kern, plain) in timed.items():
        both_times(results, key, kern)
        results[f"{key}_plain_ms"] = cuda_time_ms(plain, iters=5)
    untabled = {key: cuda_time_ms(fn, behind_sleep=True) for key, fn in (
        ("dq", lambda: FA.KERNEL.bwd_dq(*bwd)), ("dk/dv", lambda: FA.KERNEL.bwd_dkv(*bwd)))}
    # what a backward that saves the unrotated q and k runs in PyTorch
    # around the kernels, per layer: the re-rotation of q and k, then the
    # counter-rotation of dq and dk
    old_rot = both_times(results, "old_rotary_bwd", lambda: (
        FA._rotary_plain(q, *tables), FA._rotary_plain(k, *tables),
        FA._rotary_transpose(qr, *tables), FA._rotary_transpose(kr, *tables)))
    log(f"backward at [{b},{h},{t},{dh}] bf16, behind a sleep: with the tables (the VoMix step's form) dq "
        f"{results['bwd_dq_device_ms']:.4f} / dk-dv {results['bwd_dkv_device_ms']:.4f} ms, without "
        f"{untabled['dq']:.4f} / {untabled['dk/dv']:.4f} ms; the re-rotation and counter-rotation in PyTorch "
        f"that the tables replace: {old_rot:.4f} / {results['old_rotary_bwd_device_ms']:.4f} ms per layer "
        f"(back to back / behind a sleep)")
    # the call the path makes (pre-pass + attention: the gated number), and
    # what the lse output and the pre-pass cost, on these inputs
    both_times(results, "fwd_lse_with_prepass", lambda: FA.KERNEL(q, k, v, valid_arr, tables, return_lse=True))
    variants = {"no lse, with the pre-pass": cuda_time_ms(lambda: FA.KERNEL(q, k, v, valid_arr, tables)),
                "the rotary pre-pass alone": cuda_time_ms(lambda: FA.KERNEL.rotary(q, k, *tables))}
    log(f"forward with lse at [{b},{h},{t},{dh}] bf16 (ms back to back / behind a sleep): with the pre-pass "
        f"{results['fwd_lse_with_prepass_ms']:.4f} / {results['fwd_lse_with_prepass_device_ms']:.4f}, "
        f"attention alone {results['fwd_lse_ms']:.4f} / {results['fwd_lse_device_ms']:.4f}; "
        + ", ".join(f"{name} {ms:.4f}" for name, ms in variants.items()))
    both_times(results, "fwd_lse_library", lambda: F.scaled_dot_product_attention(qr, kr, v))
    leaves = [x.detach().clone().requires_grad_() for x in (qr, kr, v)]
    o = F.scaled_dot_product_attention(*leaves)
    both_times(results, "bwd_library", lambda: torch.autograd.grad(o, leaves, dout, retain_graph=True))
    for key in ("bwd_dq", "bwd_dkv"):   # one call computes dQ, dK and dV
        results[f"{key}_library_ms"] = results["bwd_library_ms"]
        results[f"{key}_library_device_ms"] = results["bwd_library_device_ms"]
    del o, leaves

    n, rows = b * h * t * dh * 2, b * h * t * 4          # one [B,H,T,dh] bf16 tensor; one f32 [B,H,T] row array
    live = valid_arr.long().expand(b).sum().item()
    tab = 2 * t * dh * 2                                  # the two bf16 rotary tables the backward reads
    work = {"fwd_lse": (4.0 * h * dh * t * live, 4 * n + rows),                       # q,k,v,out; lse
            "bwd_dq": (6.0 * h * dh * t * live, 5 * n + 2 * rows + tab),              # q,k,v,dO,dq; lse,delta
            "bwd_dkv": (8.0 * h * dh * t * live, 6 * n + 2 * rows + tab)}             # q,k,v,dO,dk,dv; lse,delta
    for key, (flops, nbytes) in work.items():
        bound_and_log(results, key, [b, h, t, dh], flops, nbytes + valid_arr.numel() * 4)
    log_backward_pair(results, "", [b, h, t, dh])


def time_flash_f32(results, suffix, b, h, t, causal, rotary, dh=64):
    """The f32 training forms (the recipes' own precision) of the forward
    with lse, dQ and dK/dV at a training path's shape: VoMix [8, 16, 832, 64]
    with the rotary tables (suffix "_f32"), CoMix T2S [6, 8, 1026, 64] causal
    ("_causal_f32"), all keys live. The backward is called as the step calls
    it: rotated q and k (`_rotary_plain`, what `_FlashCoreRot` saves) and the
    tables, so dq and dk leave through the rotary's transpose in the kernels.
    Each output on the timed inputs is held against its plain version
    (F32_TOL), dq and dk with the tables also bit for bit against
    `_rotary_transpose` of the untabled kernels'; each kernel is timed back
    to back and behind a sleep beside its plain version, its bound at the f32
    peak and one PyTorch call of the same function on the pre-rotated inputs
    (f32 SDPA; the gradient of f32 SDPA, which computes dQ, dK and dV). Also
    logged: the untabled kernels and the `_unrotate` passes of dq and dk that
    a backward without the tables runs in PyTorch."""
    import torch
    import torch.nn.functional as F
    from covomix_tpu_torch.ops import flash_attention as FA

    f32 = torch.float32
    q, k, v, valid_arr, tables = flash_inputs(b, h, t, dh, f32, 411 + t, t, rotary)
    dout = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(412), device="cuda")
    if rotary:
        q, k = FA._rotary_plain(q, *tables), FA._rotary_plain(k, *tables)
    log(f"f32 flash training kernels at the timed inputs [{b},{h},{t},{dh}] rotary={rotary} causal={causal}:")
    out, lse = FA.KERNEL(q, k, v, valid_arr, None, return_lse=True, causal=causal)
    ref, ref_lse = FA.flash_attention_plain(q, k, v, valid_arr, None, causal, return_lse=True)
    results[f"fwd_lse{suffix}_max_abs_err"] = max(flash_agreement("out", out, ref, F32_TOL),
                                                 flash_agreement("lse", lse, ref_lse, LSE_TOL))
    bwd = (q, k, v, dout, ref_lse, FA.flash_delta(dout, ref), valid_arr, causal)
    dq, (dk, dv) = FA.KERNEL.bwd_dq(*bwd, rotary=tables), FA.KERNEL.bwd_dkv(*bwd, rotary=tables)
    results[f"bwd_dq{suffix}_max_abs_err"] = flash_agreement(
        "dq", dq, FA.flash_bwd_dq_plain(*bwd, rotary=tables), F32_TOL)
    dk_p, dv_p = FA.flash_bwd_dkv_plain(*bwd, rotary=tables)
    results[f"bwd_dkv{suffix}_max_abs_err"] = max(flash_agreement("dk", dk, dk_p, F32_TOL),
                                                  flash_agreement("dv", dv, dv_p, F32_TOL))
    if rotary:
        dq0, (dk0, _) = FA.KERNEL.bwd_dq(*bwd), FA.KERNEL.bwd_dkv(*bwd)
        same = torch.equal(dq, FA._rotary_transpose(dq0, *tables)) and torch.equal(dk, FA._rotary_transpose(dk0, *tables))
        log(f"  with tables: dq, dk == _rotary_transpose of the untabled kernels', bit for bit: {same}")
        if not same:
            raise AssertionError("the f32 backward's rotary transpose differs from _rotary_transpose")
        del dq0, dk0
    del out, ref, dq, dk, dv, dk_p, dv_p

    timed = {
        f"fwd_lse{suffix}": (lambda: FA.KERNEL(q, k, v, valid_arr, None, return_lse=True, causal=causal),
                             lambda: FA.flash_attention_plain(q, k, v, valid_arr, None, causal, return_lse=True)),
        f"bwd_dq{suffix}": (lambda: FA.KERNEL.bwd_dq(*bwd, rotary=tables),
                            lambda: FA.flash_bwd_dq_plain(*bwd, rotary=tables)),
        f"bwd_dkv{suffix}": (lambda: FA.KERNEL.bwd_dkv(*bwd, rotary=tables),
                             lambda: FA.flash_bwd_dkv_plain(*bwd, rotary=tables)),
    }
    for key, (kern, plain) in timed.items():
        both_times(results, key, kern, iters=10)
        results[f"{key}_plain_ms"] = cuda_time_ms(plain, iters=3, warmup=1)
    if rotary:
        untabled = {name: cuda_time_ms(fn, 10, behind_sleep=True) for name, fn in (
            ("dq", lambda: FA.KERNEL.bwd_dq(*bwd)), ("dk/dv", lambda: FA.KERNEL.bwd_dkv(*bwd)))}
        dq0, (dk0, _) = FA.KERNEL.bwd_dq(*bwd), FA.KERNEL.bwd_dkv(*bwd)
        unrot = both_times(results, f"unrotate{suffix}",
                           lambda: (FA._unrotate(dq0, tables), FA._unrotate(dk0, tables)))
        log(f"f32 backward at [{b},{h},{t},{dh}] behind a sleep: with the tables (the step's form) dq "
            f"{results[f'bwd_dq{suffix}_device_ms']:.4f} / dk-dv {results[f'bwd_dkv{suffix}_device_ms']:.4f} ms, "
            f"without {untabled['dq']:.4f} / {untabled['dk/dv']:.4f} ms; the _unrotate of dq and dk in PyTorch that "
            f"the tables replace: {unrot:.4f} / {results[f'unrotate{suffix}_device_ms']:.4f} ms per layer "
            f"(back to back / behind a sleep)")
        del dq0, dk0
    both_times(results, f"fwd_lse{suffix}_library",
               lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal), iters=10)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    o = F.scaled_dot_product_attention(*leaves, is_causal=causal)
    both_times(results, f"bwd{suffix}_library", lambda: torch.autograd.grad(o, leaves, dout, retain_graph=True),
               iters=10)
    for key in (f"bwd_dq{suffix}", f"bwd_dkv{suffix}"):   # one call computes dQ, dK and dV
        results[f"{key}_library_ms"] = results[f"bwd{suffix}_library_ms"]
        results[f"{key}_library_device_ms"] = results[f"bwd{suffix}_library_device_ms"]
    del o, leaves

    n, rows = b * h * t * dh * 4, b * h * t * 4           # one [B,H,T,dh] f32 tensor; one f32 [B,H,T] row array
    pairs = b * h * t * (t + 1) / 2 if causal else b * h * t * t   # live (query, key) pairs, all keys valid
    tab = 2 * t * dh * 4 if rotary else 0                 # the two f32 rotary tables the backward reads
    work = {f"fwd_lse{suffix}": (4.0 * dh * pairs, 4 * n + rows),                  # q,k,v,out; lse
            f"bwd_dq{suffix}": (6.0 * dh * pairs, 5 * n + 2 * rows + tab),         # q,k,v,dO,dq; lse,delta
            f"bwd_dkv{suffix}": (8.0 * dh * pairs, 6 * n + 2 * rows + tab)}        # q,k,v,dO,dk,dv; lse,delta
    for key, (flops, nbytes) in work.items():
        bound_and_log(results, key, [b, h, t, dh], flops, nbytes + valid_arr.numel() * 4, f32=True)
    log_backward_pair(results, suffix, [b, h, t, dh])
    pair_bound = results[f"bwd_dq{suffix}_bound_ms"] + results[f"bwd_dkv{suffix}_bound_ms"]
    log(f"f32 backward pair{suffix.replace('_', ' ')}: {results[f'bwd_pair{suffix}_device_ms']:.4f} ms on the card, "
        f"{pair_bound / results[f'bwd_pair{suffix}_device_ms'] * 100:.1f} % of its {pair_bound:.4f} ms bound")


def f32_backward_times(results, iters=10):
    """Device ms of the f32 backward at the two training shapes, with the
    calls every tree since the causal form has (for --ab-training): the
    untabled dQ and dK/dV kernels, and `_backward` as the step calls it
    (delta, both kernels and, where the kernels take no tables, the
    `_unrotate` of dq and dk)."""
    import torch
    from covomix_tpu_torch.ops import flash_attention as FA

    for suffix, (b, h, t, causal, rotary) in F32_SHAPES.items():
        q, k, v, valid_arr, tables = flash_inputs(b, h, t, 64, torch.float32, 421 + t, t, rotary)
        g = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(422), device="cuda")
        if rotary:
            q, k = FA._rotary_plain(q, *tables), FA._rotary_plain(k, *tables)
        out, lse = FA.KERNEL(q, k, v, valid_arr, None, return_lse=True, causal=causal)
        bwd = (q, k, v, g, lse, FA.flash_delta(g, out), valid_arr, causal)
        results[f"bwd_dq{suffix}_untabled_device_ms"] = cuda_time_ms(lambda: FA.KERNEL.bwd_dq(*bwd), iters,
                                                                     behind_sleep=True)
        results[f"bwd_dkv{suffix}_untabled_device_ms"] = cuda_time_ms(lambda: FA.KERNEL.bwd_dkv(*bwd), iters,
                                                                      behind_sleep=True)
        results[f"backward{suffix}_device_ms"] = cuda_time_ms(
            lambda: FA._backward(q, k, v, out, lse, g, valid_arr, causal, tables), iters, behind_sleep=True)


# the f32 training shapes: suffix -> (B, H, T, causal, rotary)
F32_SHAPES = {"_f32": (8, 16, 832, False, True), "_causal_f32": (6, 8, 1026, True, False)}


def log_backward_pair(results, suffix, shape):
    """The dQ + dK/dV pair's time beside one SDPA gradient call (dQ, dK and
    dV), both ways."""
    pair = {way: results[f"bwd_dq{suffix}{way}"] + results[f"bwd_dkv{suffix}{way}"] for way in ("_ms", "_device_ms")}
    lib = {way: results[f"bwd{suffix}_library{way}"] for way in ("_ms", "_device_ms")}
    results[f"bwd_pair{suffix}_device_ms"] = pair["_device_ms"]
    log(f"backward pair{suffix.replace('_', ' ')} at {shape}: dQ + dK/dV {pair['_ms']:.4f} / {pair['_device_ms']:.4f} "
        f"ms, SDPA gradient {lib['_ms']:.4f} / {lib['_device_ms']:.4f} ms (back to back / behind a sleep): "
        f"{pair['_device_ms'] / lib['_device_ms']:.2f}x by device time")


# ---------------------------------------------------------------------------
# phase 3b: the fused vocoder stage and tail against their plain versions


def vocoder_stage_params(channel, tail: bool, seed: int):
    """(up, blocks, post) of the rate-4 stage (tail=False) or the last stage
    of the generator with `channel` initial channels, random from a seed."""
    import torch
    from covomix_tpu_torch.models import vocoder as V

    cfg = V.VocoderConfig(upsample_initial_channel=channel)
    p = V.init_generator(torch.Generator(device="cuda").manual_seed(seed), cfg, device="cuda")
    i = len(cfg.upsample_rates) - (1 if tail else 2)
    n = len(cfg.resblock_kernel_sizes)
    return p["ups"][i], p["resblocks"][i * n:(i + 1) * n], p["conv_post"] if tail else None


def check_vocoder(results):
    """Both kernels in bf16 and f32 at the Synthesizer's shape (B=1, T=512
    mel frames), B=4 with a length that is not a multiple of the tile, inputs
    shorter than the halo, upsample_initial_channel 496, and the other
    channel padding of each kernel: a 32-channel and a 2-channel stage
    (initial channels 256, 16) and a 64-channel tail (1024) and 1-channel
    tail (16), one of odd length."""
    import torch
    from covomix_tpu_torch.ops import vocoder_tail as VT

    worst = {"stage": 0.0, "tail": 0.0}
    cases = [("stage", 500, 1, 20 * 512 + 4), ("tail", 500, 1, 80 * 512 + 16),
             ("stage", 500, 4, 1001), ("tail", 500, 4, 2002),
             ("stage", 500, 2, 1), ("tail", 500, 2, 2), ("stage", 500, 1, 3),
             ("stage", 496, 2, 700), ("tail", 496, 2, 1400),
             ("stage", 256, 2, 300), ("stage", 16, 1, 50), ("tail", 1024, 1, 601), ("tail", 16, 2, 100)]
    for ci, (kind, channel, b, t) in enumerate(cases):
        up, blocks, post = vocoder_stage_params(channel, kind == "tail", ci)
        g = torch.Generator(device="cuda").manual_seed(100 + ci)
        x = torch.randn((b, t, up["w"].shape[1]), generator=g, device="cuda")
        for dtype in (torch.bfloat16, torch.float32):
            xd = x.to(dtype)
            packed = VT.pack_weights(up, blocks, post, (3, 7, 11), ((1, 3, 5),) * 3, dtype, xd.device)
            if kind == "tail":
                out = VT.TAIL(xd, packed)
                ref = VT.fused_tail_plain(xd, up, blocks, post)
            else:
                out = VT.STAGE(xd, packed)
                ref = VT.fused_stage_plain(xd, up, blocks)
            err = vocoder_agreement(f"fused {kind} check channel {channel}", xd, out, ref)
            if dtype == torch.bfloat16:
                worst[kind] = max(worst[kind], err)
    results["stage_check_max_abs_err"], results["tail_check_max_abs_err"] = worst["stage"], worst["tail"]


def vocoder_agreement(what, x, out, ref) -> float:
    """Max |out - ref| of a fused kernel on input `x` against its plain
    version, logged and held to the tolerances of x's dtype above; raises on
    disagreement."""
    import torch

    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    scale = max(1.0, ref.float().abs().max().item())
    if x.dtype == torch.bfloat16:
        ok = err.max().item() <= VOC_BF16_TOL * scale and err.mean().item() <= VOC_BF16_MEAN_TOL * scale
    else:
        ok = err.max().item() <= VOC_F32_TOL
    ok = ok and out.shape == ref.shape and out.dtype == ref.dtype and bool(torch.isfinite(out).all())
    log(f"{what} x{list(x.shape)} {str(x.dtype)[6:]}: max_abs_err {err.max().item():.3e}, "
        f"mean {err.mean().item():.3e}, |plain| max {scale:.3g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: the kernel disagrees with its plain version")
    return err.max().item()


def unfused_stage(x, up, blocks, tail_post=None):
    """The port's unfused generator ops for the same stage (cuDNN convs)."""
    import torch
    from covomix_tpu_torch.models import layers as L
    from covomix_tpu_torch.models import vocoder as V

    u = 2 if tail_post is not None else 4
    h = L.conv_transpose1d(up, L.leaky_relu(x, V.LRELU_SLOPE), stride=u, padding=(4 - u) // 2, kernel=4)
    acc = None
    for j, kr in enumerate((3, 7, 11)):
        y = V._resblock1(blocks[j], h, kr, (1, 3, 5))
        acc = y if acc is None else acc + y
    h = acc / 3
    if tail_post is None:
        return h
    return torch.tanh(L.conv1d(tail_post, L.leaky_relu(h), padding=3))[..., 0].float()


def time_vocoder(results, key, kind, x, up, blocks, post=None):
    """Kernel, plain version and the unfused generator ops of the stage
    (kind "stage") or tail ("tail") on input x [B, T, Cin] with the default
    taps, into results[f"{key}_ms"] etc.; the kernel's output on these inputs
    is held against the plain version's. No single PyTorch call computes
    either function, so there is no library yardstick. The bound counts the
    operations at the peak of x's type (bf16: tensor cores; f32: the f32
    kernels' scalar FMAs)."""
    import torch
    from covomix_tpu_torch.ops import vocoder_tail as VT

    tail = kind == "tail"
    b, t, cin = x.shape
    c = up["w"].shape[2]
    packed = VT.pack_weights(up, blocks, post, (3, 7, 11), ((1, 3, 5),) * 3, x.dtype, x.device)
    kern = VT.TAIL if tail else VT.STAGE
    log_vocoder_plan(results, key, kern, x, packed)
    plain = (lambda: VT.fused_tail_plain(x, up, blocks, post)) if tail else (
        lambda: VT.fused_stage_plain(x, up, blocks))
    results[f"{key}_max_abs_err"] = vocoder_agreement(f"fused {kind} at the timed inputs", x, kern(x, packed),
                                                      plain())
    ms = both_times(results, key, lambda: kern(x, packed))
    results[f"{key}_plain_ms"] = cuda_time_ms(plain, iters=5)
    results[f"{key}_unfused_ms"] = cuda_time_ms(lambda: unfused_stage(x, up, blocks, post), iters=10)
    n_out = (2 if tail else 4) * b * t
    taps_up = 2 if tail else 1
    macs = n_out * (taps_up * cin * c + 126 * c * c + (7 * c if tail else 0))   # 126 = 6 convs x (3+7+11)
    w_bytes = ((4 * cin * c + 126 * c * c + (7 * c if tail else 0)) * x.element_size()
               + (19 * c + 1) * 4)
    nbytes = b * t * cin * x.element_size() + n_out * (4 if tail else c * x.element_size()) + w_bytes
    peak = H100_BF16_FLOPS if x.dtype == torch.bfloat16 else H100_F32_FLOPS
    bf, bb = 2 * macs / peak * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    results[f"{key}_bound_ms"] = max(bf, bb)
    results[f"{key}_bound_by"] = "operations" if bf >= bb else "bytes"
    log(f"fused {kind} timing x{list(x.shape)} {str(x.dtype)[6:]}: kernel {ms:.4f} ms ("
        f"{results[f'{key}_device_ms']:.4f} behind a sleep), plain "
        f"{results[f'{key}_plain_ms']:.4f} ms, unfused generator ops {results[f'{key}_unfused_ms']:.4f} ms, "
        f"bound {results[f'{key}_bound_ms']:.4f} ms ({results[f'{key}_bound_by']}: {2 * macs / 1e9:.2f} GFLOP, "
        f"{nbytes / 1e6:.2f} MB) -> {2 * macs / ms / 1e9:.1f} TFLOP/s")


def log_vocoder_plan(results, key, kern, x, packed):
    """The block plan the library gives a fused kernel on x (tile, blocks,
    waves on this card's SMs, shared memory) and, per MRF conv, the busiest
    warp's units against the mean over the 16 warps and the idlest warp's
    units (bf16 units: 16-row x 32-channel m-tiles; f32: one row x 8
    channels); into results[f"{key}_plan"]."""
    p = kern.plan(x, packed)
    ratios = [round(busiest / (units / 16), 3) for _, units, busiest, _ in p.convs]
    idlest = min(c[3] for c in p.convs)
    results[f"{key}_plan"] = {**p._asdict(), "unit_max_over_mean": ratios, "idlest_warp_units": idlest}
    log(f"fused {'tail' if kern.tail else 'stage'} plan x{list(x.shape)}: tile {p.tile}, {p.blocks} blocks = "
        f"{p.waves:.3f} waves, {p.smem} B shared, busiest warp / mean units per conv {ratios}, "
        f"idlest warp's units in any conv {idlest}")


def time_vocoder_t512(results):
    """Both kernels at B=1 and the Synthesizer's smallest bucket, 512 mel
    frames, bf16, on random inputs and weights."""
    import torch

    for kind, t in (("stage", 20 * 512 + 4), ("tail", 80 * 512 + 16)):
        up, blocks, post = vocoder_stage_params(500, kind == "tail", 7)
        x = torch.randn((1, t, up["w"].shape[1]), generator=torch.Generator(device="cuda").manual_seed(8),
                        device="cuda").to(torch.bfloat16)
        time_vocoder(results, f"{kind}_t512", kind, x, up, blocks, post)


# ---------------------------------------------------------------------------
# phase 4: full-width serving


def full_width_configs():
    from covomix_tpu_torch.models import acoustic as A, text2semantic as T, vocoder as V

    t2s = T.T2SConfig(dim=512, source_depth=4, target_depth=4, heads=8, dim_head=64,
                      num_text_tokens=30528, num_semantic_tokens=501, target_dim=1024, two_output=True)
    ac = A.AcousticConfig(dim_in=160, dim=1024, depth=8, heads=16, dim_head=64,
                          num_phoneme_tokens=502, mode="two_one")
    return t2s, ac, V.VocoderConfig()


def serving_inputs(b, prompt, text_len, cond_dim, seed):
    import numpy as np

    rs = np.random.RandomState(seed)
    return (rs.randint(1, 30000, (b, text_len)).astype(np.int32),
            rs.randint(0, 500, (b, prompt, 2)).astype(np.int32),
            (rs.randn(b, prompt, cond_dim) * 0.1).astype(np.float32))


def run_serving(results, batch=4, prompt=400, decode=512, timed=2):
    import torch
    from covomix_tpu_torch.models import acoustic as A, text2semantic as T, vocoder as V
    from covomix_tpu_torch.ops import flash_attention as FA
    from covomix_tpu_torch.serving import BatchedPipeline

    t2s_cfg, ac_cfg, voc_cfg = full_width_configs()
    g = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.time()
    pipe = BatchedPipeline(T.init(g, t2s_cfg), t2s_cfg, A.init(g, ac_cfg), ac_cfg,
                           V.init_generator(g, voc_cfg), voc_cfg, decode_len=decode, cond_scale=0.7,
                           dtype=torch.bfloat16, min_length=decode, device="cuda")
    log(f"serving: full-width random weights built in {time.time() - t0:.1f} s")
    placed = pipe.place(*serving_inputs(batch, prompt, 64, ac_cfg.dim_in, 1))
    gen = torch.Generator(device="cuda").manual_seed(10)

    t0 = time.time()
    wav, res = pipe(gen, *placed)
    torch.cuda.synchronize()
    log(f"serving warm-up batch: {time.time() - t0:.3f} s")

    walls = []
    launches = []
    for _ in range(timed):
        FA.KERNEL.launches = FA.KERNEL.rotary_launches = 0
        t0 = time.time()
        wav, res = pipe(gen, *placed)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
        launches.append(FA.KERNEL.launches)
        if FA.KERNEL.rotary_launches != FA.KERNEL.launches:
            raise AssertionError(f"{FA.KERNEL.rotary_launches} rotary pre-pass launches for {FA.KERNEL.launches} "
                                 f"forwards with rotary in a serving batch")
    expect = ac_cfg.depth * 16 * 2
    audio_s = batch * decode * 0.02
    wall = min(walls)
    log(f"serving B={batch} prompt={prompt} decode={decode} bf16: wall {walls} s, best {wall:.4f} s, "
        f"audio {audio_s:.2f} s, RTF {wall / audio_s:.5f}, flash launches per batch {launches}, "
        f"decode steps {res.num_steps}")
    if any(n != expect for n in launches):
        raise AssertionError(f"flash kernel launched {launches} times per batch, expected {expect}")
    if tuple(wav.shape) != (batch, V.output_length(voc_cfg, decode)) or not bool(torch.isfinite(wav).all()):
        raise AssertionError(f"bad wav: shape {tuple(wav.shape)}, finite {bool(torch.isfinite(wav).all())}")
    results.update(flash_launches=launches[0], serving_wall_s=wall, serving_rtf=wall / audio_s,
                   serving_models=(pipe.acoustic_params, pipe.vocoder_params),   # phase 13 serves with them
                   serving_t2s=pipe.t2s_params)                                  # phase 14 decodes with them
    results["serving_idle"] = traced_idle_share("serving batch", lambda: pipe(gen, *placed), wall)
    stages, valid = split_serving_batch(pipe, gen, placed)
    log("serving stage times (s): " + json.dumps(stages))
    results["stages"] = stages
    vrows = valid.tolist()
    return vrows + vrows   # the CFG-doubled batch the flow model attends over


def split_serving_batch(pipe, gen, placed):
    """The stages of one BatchedPipeline batch (bf16, two streams): the same
    calls as its __call__, each timed alone (host clock ended by a
    synchronize). Returns ({stage: s}, per-row valid frames of the flow)."""
    import torch
    from covomix_tpu_torch.models import acoustic as A, vocoder as V
    from covomix_tpu_torch.serving import pack_rows, slice_generated

    stages = {}
    text_ids, pt, pm, pl = placed

    def timed_stage(name, fn):
        torch.cuda.synchronize()
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = time.time() - t
        return out

    r = timed_stage("t2s_decode_s", lambda: pipe._gen(pipe.t2s_params, gen, text_ids))
    gl = torch.minimum(r.lengths, r.lengths2).to(torch.int32)
    ph, cond = timed_stage("pack_s", lambda: pack_rows(r.tokens, r.tokens2, gl, pt, pm, pl, True))
    mel = timed_stage("flow_s", lambda: A.sample(pipe.acoustic_params, pipe.acoustic_cfg, gen, ph, cond,
                                                 cond_scale=pipe.cond_scale, valid_len=pl + gl, dtype=pipe.dtype))
    timed_stage("vocoder_s", lambda: V.generator(pipe.vocoder_params, pipe.vocoder_cfg,
                                                 slice_generated(mel, pl, pipe.decode_len), dtype=pipe.dtype,
                                                 valid_len=gl))
    return stages, pl + gl


# ---------------------------------------------------------------------------
# phase 5: small f32 run, card vs CPU


def check_small_against_cpu():
    import numpy as np
    import torch
    from covomix_tpu_torch.models import acoustic as A, text2semantic as T, vocoder as V
    from covomix_tpu_torch.ops import flash_attention as FA
    from covomix_tpu_torch.serving import BatchedPipeline

    t2s_cfg = T.T2SConfig(dim=32, source_depth=1, target_depth=1, heads=2, dim_head=16,
                          num_text_tokens=200, target_dim=64, two_output=True)
    ac_cfg = A.AcousticConfig(dim_in=160, dim=64, depth=2, heads=2, dim_head=32, dim_phoneme_emb=16,
                              mode="two_one")
    voc_cfg = V.VocoderConfig(upsample_initial_channel=16)
    g = torch.Generator().manual_seed(3)
    params = (T.init(g, t2s_cfg), A.init(g, ac_cfg), V.init_generator(g, voc_cfg))
    b, prompt, decode = 2, 400, 112        # 512 frames: the flash kernel's threshold on the card
    text, pt, pm = serving_inputs(b, prompt, 8, 160, 4)
    plens = np.array([400, 250], np.int32)
    noise = torch.from_numpy(np.random.RandomState(5).randn(b, prompt + decode, 80).astype(np.float32))
    outs = []
    for dev in ("cuda", "cpu"):
        pipe = BatchedPipeline(params[0], t2s_cfg, params[1], ac_cfg, params[2], voc_cfg, decode_len=decode,
                               dtype=torch.float32, top_k_thres=1e-3, device=dev)   # k = 1: greedy
        before = FA.KERNEL.launches
        wav, res = pipe(torch.Generator(device=dev).manual_seed(0), text, pt, pm, prompt_lens=plens,
                        noise=noise.to(dev))
        outs.append((wav.cpu(), res.tokens.cpu(), res.tokens2.cpu(), FA.KERNEL.launches - before))
    (wc, t1c, t2c, nc), (wh, t1h, t2h, nh) = outs
    err = (wc - wh).abs().max().item()
    log(f"small f32 serving, card vs CPU: tokens equal {bool((t1c == t1h).all() and (t2c == t2h).all())}, "
        f"wav max_abs_err {err:.3e} (tol {SMALL_WAV_TOL:g}), flash launches card {nc} / cpu {nh}")
    if not (torch.equal(t1c, t1h) and torch.equal(t2c, t2h)):
        raise AssertionError("greedy tokens differ between the card and the CPU")
    if nc != ac_cfg.depth * 32 or nh != 0:
        raise AssertionError("the small card run did not go through the flash kernel")
    if not err <= SMALL_WAV_TOL:
        raise AssertionError(f"card and CPU wavs differ by {err}")


# ---------------------------------------------------------------------------
# phase 6: per-file generation through the dialogue CLI


def write_dialogue_assets(root, n_scripts=2, seed=0):
    """Full-width random checkpoints (.npz + .json config sidecars, written
    with the port's save_params) and `n_scripts` two-speaker scripts with
    `_1`/`_2` prompts of 400 frames: 8 s noise wavs and codes as strings."""
    import dataclasses

    import numpy as np
    import torch
    from covomix_tpu_torch.audio import save_wav
    from covomix_tpu_torch.checkpoint.io import save_params
    from covomix_tpu_torch.models import acoustic as A, text2semantic as T, vocoder as V

    g = torch.Generator(device="cuda").manual_seed(seed)
    for name, init, cfg in zip(("t2s", "acoustic", "vocoder"), (T.init, A.init, V.init_generator),
                               full_width_configs()):
        save_params(os.path.join(root, f"{name}.npz"), init(g, cfg), meta={"config": dataclasses.asdict(cfg)})
    os.makedirs(os.path.join(root, "texts"))
    os.makedirs(os.path.join(root, "prompts"))
    rs = np.random.RandomState(seed)
    for i in range(n_scripts):
        with open(os.path.join(root, "texts", f"dlg{i}.txt"), "w") as f:
            f.write(DIALOGUE_SCRIPT)
        for spk in (1, 2):
            base = os.path.join(root, "prompts", f"dlg{i}_{spk}")
            np.save(base + ".hubert_code.npy", rs.randint(0, 500, 400).astype(str))
            save_wav(base + ".wav", (rs.randn(8 * 8000) * 0.05).astype(np.float32), 8000)


def run_dialogue_cli(results, root, t2s="t2s.npz", extra=(), key="dialogue"):
    """The dialogue CLI over the assets in `root` (T2S checkpoint `t2s`, more
    flags `extra`), full width, bf16, covomix, --fuse_tail. The launch counts
    are set to 0 just before and read just after; per call, flow_sample and
    vocode record their own launches. Results go to results[f"{key}_*"];
    returns [(Synthesizer, GenerateResult)] of every T2S decode, through
    `generate` or, with --speculative, `generate_speculative` (and then
    never the other)."""
    import numpy as np
    from scipy.io import wavfile
    from covomix_tpu_torch import dialogue_generation, pipeline as P
    from covomix_tpu_torch.models import text2semantic as T
    from covomix_tpu_torch.ops import flash_attention as FA, vocoder_tail as VT

    calls = {"flow": [], "vocode": [], "steps": [], "dialogue": [], "flow_s": [], "vocode_s": [], "decodes": []}
    speculative = "--speculative" in extra
    orig = (P.Synthesizer.flow_sample, P.Synthesizer.vocode, P.Synthesizer._decode, T.generate,
            VT.fused_stage, VT.fused_tail, P.Synthesizer.dialogue)
    inputs = {}      # the last vocode's fused-kernel inputs (default taps), for the timing phase

    def fused_stage(x, up_p, resblocks, kernels, dilations):
        inputs["stage"] = (x.contiguous().clone(), up_p, resblocks, None)
        return orig[4](x, up_p, resblocks, kernels, dilations)

    def fused_tail(x, up_p, resblocks, post_p, kernels, dilations):
        inputs["tail"] = (x.contiguous().clone(), up_p, resblocks, post_p)
        return orig[5](x, up_p, resblocks, post_p, kernels, dilations)

    def flow_sample(self, phoneme_ids, cond, generator, noise=None):
        n0, t0 = FA.KERNEL.launches, time.time()
        out = orig[0](self, phoneme_ids, cond, generator, noise)   # numpy: the card has finished
        calls["flow"].append((FA.KERNEL.launches - n0, len(phoneme_ids)))
        calls["flow_s"].append(time.time() - t0)
        return out

    def vocode(self, mel):
        s0, n0, t0 = VT.STAGE.launches, VT.TAIL.launches, time.time()
        wav = orig[1](self, mel)
        calls["vocode"].append((VT.STAGE.launches - s0, VT.TAIL.launches - n0, len(mel), len(wav)))
        calls["vocode_s"].append(time.time() - t0)
        return wav

    def dialogue(self, *args, **kwargs):
        t0 = time.time()
        wav = orig[6](self, *args, **kwargs)          # numpy: the card has finished
        calls["dialogue"].append((time.time() - t0, len(wav)))
        return wav

    def decode(self, text, generator):
        res = orig[2](self, text, generator)
        calls["steps"].append(res.num_steps)
        calls["decodes"].append((self, res))
        return res

    def generate(*args, **kwargs):
        raise AssertionError("the sampling decode ran in a --speculative run")

    out = os.path.join(root, f"{key}_out")
    argv = ["--t2s_ckpt", os.path.join(root, t2s), "--acous_ckpt", os.path.join(root, "acoustic.npz"),
            "--hifigan_ckpt", os.path.join(root, "vocoder.npz"), "--text_dir", os.path.join(root, "texts"),
            "--prompt_dir", os.path.join(root, "prompts"), "--saved_dir", out, "--mode", "covomix",
            "--fuse_tail", "--device", "cuda", "--allow_fallback_vocab", *extra]
    (P.Synthesizer.flow_sample, P.Synthesizer.vocode, P.Synthesizer._decode, VT.fused_stage, VT.fused_tail,
     P.Synthesizer.dialogue) = (flow_sample, vocode, decode, fused_stage, fused_tail, dialogue)
    if speculative:
        T.generate = generate
    FA.KERNEL.launches = FA.KERNEL.rotary_launches = VT.STAGE.launches = VT.TAIL.launches = 0
    try:
        t0 = time.time()
        dialogue_generation.main(argv)
        total = time.time() - t0
    finally:
        (P.Synthesizer.flow_sample, P.Synthesizer.vocode, P.Synthesizer._decode, T.generate, VT.fused_stage,
         VT.fused_tail, P.Synthesizer.dialogue) = orig
    launches = {"flash": FA.KERNEL.launches, "rotary": FA.KERNEL.rotary_launches, "stage": VT.STAGE.launches,
                "tail": VT.TAIL.launches}
    log(f"dialogue CLI {' '.join(extra)}: {total:.2f} s for {len(calls['dialogue'])} scripts incl. loading; per "
        f"script (wall s, samples) {calls['dialogue']}; decode steps {calls['steps']}; flow (flash launches, "
        f"frames) {calls['flow']}; vocode (stage, tail launches, frames, samples) {calls['vocode']}; totals "
        f"{launches}")
    n = len(calls["vocode"])
    if n == 0 or len(calls["flow"]) != n or len(calls["dialogue"]) != n or len(calls["decodes"]) != n:
        raise AssertionError(f"expected one decode, flow sample and vocode per script, got {calls}")
    if any(synth.speculative != speculative for synth, _ in calls["decodes"]):
        raise AssertionError(f"the CLI's Synthesizer decoded with speculative != {speculative}")
    for (flash, frames), (stage, tail, mel_frames, samples) in zip(calls["flow"], calls["vocode"]):
        if flash != 8 * 16 * 2 or stage != 1 or tail != 1:
            raise AssertionError(f"per call: {flash} flash launches (expected 256), {stage} stage and {tail} "
                                 f"tail launches (expected 1 each)")
        if frames < 400 or samples != 160 * mel_frames:
            raise AssertionError(f"flow over {frames} frames, vocode {mel_frames} frames -> {samples} samples")
    if launches != {"flash": 256 * n, "rotary": 256 * n, "stage": n, "tail": n}:
        raise AssertionError(f"launch totals {launches} do not add up over {n} scripts")
    for i, (_, _, mel_frames, samples) in enumerate(calls["vocode"]):
        sr, wav = wavfile.read(os.path.join(out, f"dlg{i}.wav"))
        if sr != 8000 or wav.dtype != np.int16 or len(wav) != 160 * mel_frames or len(wav) != samples:
            raise AssertionError(f"dlg{i}.wav: {sr} Hz, {wav.dtype}, {len(wav)} samples, expected "
                                 f"{160 * mel_frames}")
    if not os.path.isfile(os.path.join(out, "config.txt")):
        raise AssertionError("the CLI wrote no config.txt")
    wall, samples = calls["dialogue"][-1]        # the last script: the first one warmed the card up
    audio_s = samples / 8000
    stages = {"flow_s": calls["flow_s"][-1], "vocode_s": calls["vocode_s"][-1]}
    stages["rest_s (prompts, T2S decode)"] = wall - sum(stages.values())
    results.update({f"{key}_launches": launches, f"{key}_wall_s": wall, f"{key}_audio_s": audio_s,
                    f"{key}_rtf": wall / audio_s, f"{key}_steps": calls["steps"][-1],
                    f"{key}_flow_frames": calls["flow"][-1][1], f"{key}_vocoder_inputs": inputs,
                    f"{key}_stages": stages})
    log(f"per-file dialogue {' '.join(extra)}, full width bf16 --fuse_tail: wall {wall:.4f} s for {audio_s:.2f} s "
        f"of audio, RTF {wall / audio_s:.5f}, T2S decode steps {calls['steps'][-1]}, stages (s) "
        f"{json.dumps(stages)}")
    return calls["decodes"]


# ---------------------------------------------------------------------------
# phase 7b: small f32 Synthesizer run, card vs CPU


def check_small_synth_against_cpu(prompt_dir):
    """Tiny T2S / acoustic models with the full-width vocoder, so that the
    fused kernels run on the card: covomix dialogue with fuse_tail, greedy
    T2S, the same y0 on both sides, prompt mel from shared `.mel.npy` caches."""
    import functools

    import numpy as np
    import torch
    from covomix_tpu_torch.audio import MelConfig, load_wav, mel_spectrogram
    from covomix_tpu_torch.data.tokenizer import load_covomix_tokenizer
    from covomix_tpu_torch.models import acoustic as A, text2semantic as T, vocoder as V
    from covomix_tpu_torch.ops import flash_attention as FA, vocoder_tail as VT
    from covomix_tpu_torch.pipeline import Synthesizer
    from covomix_tpu_torch.util.misc import round_up

    t2s_cfg = T.T2SConfig(dim=32, source_depth=1, target_depth=1, heads=2, dim_head=16,
                          num_text_tokens=30528, target_dim=64, two_output=True)
    ac_cfg = A.AcousticConfig(dim_in=160, dim=64, depth=2, heads=2, dim_head=32, dim_phoneme_emb=16,
                              mode="two_one")
    voc_cfg = V.VocoderConfig()
    g = torch.Generator().manual_seed(3)
    params = (T.init(g, t2s_cfg), A.init(g, ac_cfg), V.init_generator(g, voc_cfg))
    p1, p2 = (os.path.join(prompt_dir, f"dlg0_{spk}.hubert_code.npy") for spk in (1, 2))
    for p in (p1, p2):    # one prompt mel for both sides
        wav, _ = load_wav(p.replace(".hubert_code.npy", ".wav"), sr=8000)
        mel = mel_spectrogram(torch.as_tensor(wav)[None], MelConfig())[0].numpy()
        np.save(p.replace(".hubert_code.npy", ".mel.npy"), mel)
    max_len = 112                           # 400 + 112 = 512 frames: the flash kernel runs on the card
    outs = []
    for dev in ("cuda", "cpu"):
        synth = Synthesizer(params[0], t2s_cfg, params[1], ac_cfg, params[2], voc_cfg,
                            load_covomix_tokenizer(None, strict=False), dtype=torch.float32, fuse_tail=True,
                            t2s_max_length=max_len, device=dev)
        tokens = []
        greedy = functools.partial(T.generate, cfg=t2s_cfg, max_length=max_len, dtype=torch.float32,
                                   top_k_thres=1e-3)        # k = 1

        def gen_fn(*args, _tokens=tokens, **kwargs):
            _tokens.append(greedy(*args, **kwargs))
            return _tokens[-1]

        synth._gen_fn = gen_fn
        synth.flow_sample = lambda ph, cond, gen, s=synth: Synthesizer.flow_sample(
            s, ph, cond, gen, noise=torch.from_numpy(np.random.RandomState(5).randn(
                1, max(s.bucket, round_up(len(ph), s.bucket)), 80).astype(np.float32)))
        before = (FA.KERNEL.launches, VT.STAGE.launches, VT.TAIL.launches)
        wav = synth.dialogue("covomix", DIALOGUE_SCRIPT, p1, p2, torch.Generator(device=dev).manual_seed(0))
        after = (FA.KERNEL.launches, VT.STAGE.launches, VT.TAIL.launches)
        outs.append((wav, [(r.tokens.cpu(), r.tokens2.cpu()) for r in tokens],
                     [a - b for a, b in zip(after, before)]))
    (wc, tc, nc), (wh, th, nh) = outs
    same_tokens = len(tc) == len(th) and all(torch.equal(a, c) and torch.equal(b, d) for (a, b), (c, d) in zip(tc, th))
    err = float(np.abs(wc - wh).max()) if wc.shape == wh.shape else float("inf")
    log(f"small f32 Synthesizer (full-width vocoder, fuse_tail), card vs CPU: tokens equal {same_tokens}, "
        f"wav {wc.shape} max_abs_err {err:.3e} (tol {SMALL_SYNTH_WAV_TOL:g}), (flash, stage, tail) launches "
        f"card {nc} / cpu {nh}")
    if not same_tokens:
        raise AssertionError("greedy tokens differ between the card and the CPU")
    if nc[1] < 1 or nc[2] < 1 or nc[0] < 1 or any(nh):
        raise AssertionError("the small card run did not go through the kernels, or the CPU run did")
    if not err <= SMALL_SYNTH_WAV_TOL:
        raise AssertionError(f"card and CPU wavs differ by {err}")


# ---------------------------------------------------------------------------
# phase 8: full-width VoMix training through the training CLI


# the VoMix acoustic recipe (running_command/Acous_VoMix.sh) on one card, bf16
VOMIX_RECIPE = ["--format", "hubert_overlap_two_input_one_output", "--twocondition_oneoutput",
                "--CoVoMix_dim", "160", "--CoVoMix_dim_transformer", "1024", "--CoVoMix_depth", "8",
                "--CoVoMix_heads", "16", "--CoVoMix_num_phoneme_tokens", "502", "--cond_drop_prob", "0.3",
                "--random_mask", "--batch_size", "8", "--lr", "1e-4", "--lr_scheduler", "--bf16"]
TRAIN_STEPS = 12


def write_vomix_items(root, n, seed):
    """n random VoMix items in the hubert_overlap_two_input_one_output layout:
    u.mel.npy (mixed), u-A / u-B .mel.npy [80, ~1000] f32 and u-A / u-B
    .hubert_code.npy as string arrays."""
    import numpy as np

    rs = np.random.RandomState(seed)
    os.makedirs(root)
    for i in range(n):
        t = 960 + 7 * i
        base = os.path.join(root, f"u{i}")
        np.save(base + ".mel.npy", (rs.randn(80, t) * 2 - 5).astype(np.float32))
        for ch in "AB":
            np.save(f"{base}-{ch}.mel.npy", (rs.randn(80, t) * 2 - 5).astype(np.float32))
            np.save(f"{base}-{ch}.hubert_code.npy", rs.randint(0, 500, t).astype(str))


COUNTS = {"fwd": "launches", "fwd_lse": "lse_launches", "bwd_dq": "dq_launches", "bwd_dkv": "dkv_launches",
          "fwd_causal": "causal_launches", "fwd_lse_causal": "causal_lse_launches",
          "bwd_dq_causal": "causal_dq_launches", "bwd_dkv_causal": "causal_dkv_launches",
          "rotary": "rotary_launches"}


def flash_counts():
    """Every launch count of the flash kernels, by kernel."""
    from covomix_tpu_torch.ops import flash_attention as FA

    return {key: getattr(FA.KERNEL, attr) for key, attr in COUNTS.items()}


def launches(**nonzero):
    """A flash_counts()-shaped dict: the counts given, 0 for every other kernel."""
    return {key: nonzero.get(key, 0) for key in COUNTS}


def run_train_cli(argv, evaluate_name, steps_total, resume=True):
    """`covomix_tpu_torch.train.cli.main(argv)` for `steps_total` steps, then
    (with `resume`) with `--resume` for one more, with every optimizer step
    timed (host clock ended by a synchronize) and the eval
    `train.evaluate.<evaluate_name>` recorded, each with the flash launches
    it made. The launch counts are set to 0 just before and read just after.
    Returns (steps, evals, totals, peak GiB, seconds of the first run,
    seconds of the resumed one or None)."""
    import numpy as np
    import torch
    from covomix_tpu_torch.ops import flash_attention as FA
    from covomix_tpu_torch.train import cli, evaluate as E, loop

    steps, evals = [], []
    orig = (loop.make_train_step, getattr(E, evaluate_name))

    def make_train_step(loss_fn, cfg):
        step = orig[0](loss_fn, cfg)

        def timed_step(state, batch, generator):
            torch.cuda.synchronize()
            c0, t0 = flash_counts(), time.time()
            metrics = step(state, batch, generator)
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])   # waits for the card
            torch.cuda.synchronize()
            steps.append({"ms": (time.time() - t0) * 1e3, "loss": loss, "grad_norm": gnorm,
                          "shapes": {k: tuple(np.asarray(v).shape) for k, v in batch.items()},
                          "launches": {k: v - c0[k] for k, v in flash_counts().items()}})
            return metrics

        return timed_step

    def evaluate(params, cfg, batches, generator, **kw):
        c0, t0 = flash_counts(), time.time()
        ev = orig[1](params, cfg, batches, generator, **kw)
        evals.append({"s": time.time() - t0, "batches": len(batches),
                      "rows": sum(len(next(iter(b.values()))) for b in batches), **ev,
                      "launches": {k: v - c0[k] for k, v in flash_counts().items()}})
        return ev

    loop.make_train_step = make_train_step
    setattr(E, evaluate_name, evaluate)
    for attr in COUNTS.values():
        setattr(FA.KERNEL, attr, 0)
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.time()
        cli.main(argv + ["--max_steps", str(steps_total)])
        first_s = time.time() - t0
        resume_s = None
        if resume:
            t0 = time.time()
            cli.main(argv + ["--max_steps", str(steps_total + 1), "--resume"])
            resume_s = time.time() - t0
    finally:
        loop.make_train_step = orig[0]
        setattr(E, evaluate_name, orig[1])
    return steps, evals, flash_counts(), torch.cuda.max_memory_allocated() / 2 ** 30, first_s, resume_s


def check_steps(what, steps, per_step):
    """Every optimizer step logged, with a finite loss and grad norm and
    exactly the flash launches `per_step`."""
    import numpy as np

    for i, s in enumerate(steps):
        log(f"{what} step {i + 1}: {s['ms']:.1f} ms, batch {s['shapes']}, loss {s['loss']:.5f}, "
            f"grad_norm {s['grad_norm']:.4f}, launches {s['launches']}")
        if not (np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"])):
            raise AssertionError(f"{what} step {i + 1}: loss {s['loss']}, grad_norm {s['grad_norm']}")
        if s["launches"] != per_step:
            raise AssertionError(f"{what} step {i + 1}: launches {s['launches']} (expected {per_step})")


def check_train_run(what, steps, evals, ckpt, steps_total, rows, per_step, eval_launches):
    """The checks both training runs share: finite loss and grad norm every
    step, exactly `per_step` flash launches every step, steps_total + 1 steps
    over the run and its resume, one eval over `rows` dev files with a finite
    l2 and `eval_launches`, the top-k save and the resumed checkpoint.
    Returns the median ms per step over steps 3..steps_total."""
    import numpy as np

    check_steps(what, steps, per_step)
    if len(steps) != steps_total + 1:
        raise AssertionError(f"{len(steps)} optimizer steps over the run and its resume, expected "
                             f"{steps_total} + 1: the resume did not start from step {steps_total}")
    log(f"{what} eval: {evals}")
    if len(evals) != 1 or evals[0]["rows"] != rows or not np.isfinite(evals[0]["l2"]):
        raise AssertionError(f"expected one eval over the {rows} dev files with a finite l2, got {evals}")
    if evals[0]["launches"] != eval_launches:
        raise AssertionError(f"the eval launched {evals[0]['launches']}, expected {eval_launches}")
    with open(os.path.join(ckpt, "topk.json")) as f:
        topk = json.load(f)
    with np.load(os.path.join(ckpt, f"step_{steps_total + 1:08d}", "state.npz")) as z:
        counters = (int(z["step"]), int(z["adam_step"]), int(z["ema_num_updates"]))
    log(f"checkpoints {sorted(os.listdir(ckpt))}, topk.json {topk}, step {steps_total + 1} counters {counters}")
    if (sorted(os.listdir(ckpt)) != [f"step_{steps_total:08d}", f"step_{steps_total + 1:08d}", "topk.json"]
            or topk["best_step"] != steps_total or counters != (steps_total + 1,) * 3):
        raise AssertionError("the top-k save, the resume or its checkpoint is not as expected")
    ms = sorted(s["ms"] for s in steps[2:steps_total])
    return ms[len(ms) // 2] if len(ms) % 2 else (ms[len(ms) // 2 - 1] + ms[len(ms) // 2]) / 2


def run_training(results, root):
    """`covomix_tpu_torch.train.cli.main` with the VoMix recipe at full width
    (B=8, items cropped to 800 frames and bucketed to 832), bf16, on 24 train
    and 8 dev items: TRAIN_STEPS steps with one eval on the 8 dev files and
    its top-k save, then `--resume` for one more step. Every optimizer step
    must launch the forward with lse, dQ and dK/dV 8 times each (8 layers)
    and nothing else, the eval's sampler only the forward without lse."""
    train_dir, dev_dir, logs = (os.path.join(root, d) for d in ("train", "dev", "logs"))
    t0 = time.time()
    write_vomix_items(train_dir, 24, 0)
    write_vomix_items(dev_dir, 8, 1)
    log(f"training data: 24 train + 8 dev random VoMix items written in {time.time() - t0:.1f} s")
    argv = ["--base_dir", train_dir, "--dev_base_dir", dev_dir, *VOMIX_RECIPE, "--device", "cuda",
            "--log_every", "1", "--eval_every", str(TRAIN_STEPS), "--num_eval_files", "8", "--ckpt_every", "1000",
            "--no_wandb", "--log_dir", logs, "--run_name", "vomix", "--seed", "0"]
    steps, evals, totals, peak_gb, first_s, resume_s = run_train_cli(argv, "evaluate_acoustic", TRAIN_STEPS)
    per_step = launches(fwd_lse=8, bwd_dq=8, bwd_dkv=8, rotary=8)   # the VoMix layers take rotary
    bad = [s["shapes"]["x"] for s in steps if s["shapes"]["x"] != (8, 832, 240)]
    if bad:
        raise AssertionError(f"VoMix batches {bad}, expected (8, 832, 240)")
    median = check_train_run("VoMix train", steps, evals, os.path.join(logs, "vomix", "checkpoints"), TRAIN_STEPS,
                             8, per_step, launches(fwd=256 * evals[0]["batches"], rotary=256 * evals[0]["batches"]))
    expect = {k: v * len(steps) for k, v in per_step.items()}
    expect["fwd"] = evals[0]["launches"]["fwd"]
    expect["rotary"] += evals[0]["launches"]["rotary"]
    if totals != expect:
        raise AssertionError(f"launch totals {totals} over the training run, expected {expect}")
    results.update(train_launches=totals, train_steps=len(steps), train_step_ms=median,
                   train_samples_per_s=8 / (median / 1e3), train_peak_gb=peak_gb)
    log(f"full-width VoMix training (bf16, B=8, T=832): median {median:.2f} ms per optimizer step over steps 3-"
        f"{TRAIN_STEPS}, {8 / (median / 1e3):.2f} samples/s, peak device memory {peak_gb:.2f} GiB; run "
        f"{first_s:.1f} s incl. init and {TRAIN_STEPS} steps, eval {evals[0]['s']:.2f} s, resume run "
        f"{resume_s:.1f} s; launch totals {totals}")
    return train_dir


def split_training_step(results, key, params, loss_fn, batch, n=5, idle_key=None):
    """Where an optimizer step's time goes at full width: the loss forward,
    the backward and the optimizer (Adam + EMA), each ended by a synchronize,
    the median of `n` steps after one warm-up, into results[key]. With
    `idle_key`, one more whole step traced: its device idle share into
    results[idle_key]."""
    import torch
    from covomix_tpu_torch.train import loop

    gen = torch.Generator(device="cuda").manual_seed(5)
    tcfg = loop.TrainConfig(lr=1e-4)
    state = loop.init_train_state(params, tcfg)
    batch = loop.to_device(batch, "cuda")
    parts = {"forward": [], "backward": [], "optimizer": []}
    for i in range(n + 1):
        times = []
        torch.cuda.synchronize()
        t0 = time.time()
        loss = loss_fn(state.params, batch, gen)
        torch.cuda.synchronize()
        times.append(time.time())
        loss.backward()
        torch.cuda.synchronize()
        times.append(time.time())
        state.optimizer.step()
        loop.ema_update(state.ema_params, state.params, state.ema_num_updates, tcfg.ema_decay)
        state.optimizer.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        times.append(time.time())
        if i:
            for part, a, b in zip(parts, [t0] + times[:2], times):
                parts[part].append((b - a) * 1e3)
    split = results[key] = {k: sorted(v)[len(v) // 2] for k, v in parts.items()}
    if idle_key is not None:
        def whole_step():
            loss_fn(state.params, batch, gen).backward()
            state.optimizer.step()
            loop.ema_update(state.ema_params, state.params, state.ema_num_updates, tcfg.ema_decay)
            state.optimizer.zero_grad(set_to_none=True)

        results[idle_key] = traced_idle_share(f"{key} step", whole_step, sum(split.values()) / 1e3)
    log(f"{key}: optimizer step split at full width, batch {[tuple(v.shape) for v in batch.values()]} "
        f"(median of {n}, ms): {json.dumps(split)}")


def split_vomix_step(results, train_dir, key="train_split_ms", f32=False, idle_key=None):
    import torch
    from covomix_tpu_torch.data.datasets import CoVoMixDataset, collate_acoustic
    from covomix_tpu_torch.models import acoustic as A
    from covomix_tpu_torch.train import loop

    cfg = A.AcousticConfig(dim_in=160, dim=1024, depth=8, heads=16, dim_head=64, num_phoneme_tokens=502,
                           mode="two_one")
    ds = CoVoMixDataset(train_dir, format="hubert_overlap_two_input_one_output", random_mask=True)
    split_training_step(results, key, A.init(torch.Generator(device="cuda").manual_seed(5), cfg),
                        loop.acoustic_loss_fn(cfg, cond_drop_prob=0.3, dtype=torch.float32 if f32 else torch.bfloat16),
                        collate_acoustic([ds[i] for i in range(8)]), idle_key=idle_key)


def check_small_training_against_cpu():
    """Two optimizer steps of a tiny f32 VoMix model (dh 16, T = 576 >= 512, so
    the card takes the flash kernels) on the card and on the CPU (einsum
    attention there), TF32 off, the same batches and the same draws (one CPU
    generator: the loss draws on the generator's device)."""
    import numpy as np
    import torch
    from covomix_tpu_torch.models import acoustic as A
    from covomix_tpu_torch.train import loop
    from covomix_tpu_torch.util.misc import tree_leaves, tree_map

    cfg = A.AcousticConfig(dim_in=160, dim=32, depth=2, heads=2, dim_head=16, dim_phoneme_emb=16, mode="two_one")
    tcfg = loop.TrainConfig(lr=1e-3, use_lr_schedule=True, steps_per_epoch=1, wake_up_epochs=2, grad_clip=1.0)
    rs = np.random.RandomState(9)
    batches = []
    for _ in range(2):
        mask = np.zeros((2, 576), bool)
        mask[:, 100:400] = True
        batches.append({"x": rs.randn(2, 576, 240).astype(np.float32),
                        "phonemes": rs.randint(0, 502, (2, 576, 2)).astype(np.int32), "mask": mask})
    init = A.init(torch.Generator().manual_seed(0), cfg)
    runs = {}
    for dev in ("cuda", "cpu"):
        state = loop.init_train_state(tree_map(lambda p: p.clone().to(dev), init), tcfg)
        step = loop.make_train_step(loop.acoustic_loss_fn(cfg, cond_drop_prob=0.3), tcfg)
        gen = torch.Generator().manual_seed(1)
        c0 = flash_counts()
        losses = [float(step(state, b, gen)["loss"]) for b in batches]
        runs[dev] = (losses, tree_map(lambda p: p.detach().cpu(), state.params),
                     {k: v - c0[k] for k, v in flash_counts().items()})
    (lc, pc, nc), (lh, ph, nh) = runs["cuda"], runs["cpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    param_err = max((a - b).abs().max().item() for a, b in zip(tree_leaves(pc), tree_leaves(ph)))
    log(f"small f32 training, card vs CPU, 2 steps: losses {lc} / {lh} (max rel err {loss_err:.3e}, tol "
        f"{SMALL_TRAIN_LOSS_TOL:g}), params max_abs_err {param_err:.3e} (tol {SMALL_TRAIN_PARAM_TOL:g}), "
        f"launches card {nc} / cpu {nh}")
    if nc != launches(fwd_lse=4, bwd_dq=4, bwd_dkv=4) or any(nh.values()):
        raise AssertionError("the small card run did not go through the training kernels, or the CPU run did")
    if not (loss_err <= SMALL_TRAIN_LOSS_TOL and param_err <= SMALL_TRAIN_PARAM_TOL):
        raise AssertionError("card and CPU training steps differ")


# ---------------------------------------------------------------------------
# phase 9: full-width CoMix T2S training through the training CLI


# the CoMix T2S recipe (running_command/T2S_CoMix.sh) on one card, bf16, with
# the tokenizer's fallback vocab (no BERT vocab.txt in the checkout)
COMIX_T2S_RECIPE = ["--format", "text2semantic_2output", "--text2semantic", "--text2semantic_two_output",
                    "--allow_fallback_vocab", "--CoVoMix_dim_transformer", "512", "--target_transformer_dim", "1024",
                    "--text2semantic_tokens", "501", "--text2semantic_source_depth", "4",
                    "--text2semantic_target_depth", "4", "--text2semantic_head", "8", "--batch_size", "6",
                    "--lr", "1e-4", "--lr_scheduler", "--bf16"]
T2S_WORDS = ("hello there how are you doing today i am fine thank you good to hear see you soon yes no "
             "okay right sure well maybe later").split()


def write_t2s_items(root, n, seed):
    """n random CoMix T2S items: `u<i>.hubert_code.npy` of 520-1000 codes (as
    strings) beside `u<i>.txt` of 4-12 words, every fourth one a `_1` / `_2`
    two-speaker pair. The texts stay short enough that a 20 % concatenation
    of two is far below 512 ids of the fallback vocab, so the encoder stays on
    layers.attend; the codes are long enough that every decoder runs from 578
    positions on, so every layer takes the causal flash kernels."""
    import numpy as np

    rs = np.random.RandomState(seed)
    os.makedirs(root)
    for i in range(n):
        t = int(rs.randint(520, 1001))
        base = os.path.join(root, f"u{i}")
        if i % 4 == 3:
            np.save(base + "_1.hubert_code.npy", rs.randint(0, 500, t).astype(str))
            np.save(base + "_2.hubert_code.npy", rs.randint(0, 500, t - int(rs.randint(0, 60))).astype(str))
        else:
            np.save(base + ".hubert_code.npy", rs.randint(0, 500, t).astype(str))
        with open(base + ".txt", "w") as f:
            f.write(" ".join(rs.choice(T2S_WORDS, int(rs.randint(4, 13)))))


def run_t2s_training(results, root):
    """`covomix_tpu_torch.train.cli.main` with the CoMix T2S recipe at full
    width (dim 512, target_dim 1024, 4 + 4 layers, 8 heads, two streams, B=6),
    bf16, on 24 train and 6 dev random items: TRAIN_STEPS steps with one eval
    (a 512-step decode of the EMA parameters on the 6 dev files) and its
    top-k save, then `--resume` for one more step. Every optimizer step must
    launch the causal forward with lse, causal dQ and causal dK/dV 4 times
    each (the 4 decoder layers) and no other flash kernel; the eval's decode
    none."""
    train_dir, dev_dir, logs = (os.path.join(root, d) for d in ("train", "dev", "logs"))
    write_t2s_items(train_dir, 24, 0)
    write_t2s_items(dev_dir, 6, 1)
    argv = ["--base_dir", train_dir, "--dev_base_dir", dev_dir, *COMIX_T2S_RECIPE, "--device", "cuda",
            "--log_every", "1", "--eval_every", str(TRAIN_STEPS), "--num_eval_files", "6", "--ckpt_every", "1000",
            "--no_wandb", "--log_dir", logs, "--run_name", "comix_t2s", "--seed", "0"]
    steps, evals, totals, peak_gb, first_s, resume_s = run_train_cli(argv, "evaluate_t2s", TRAIN_STEPS)
    per_step = launches(fwd_lse_causal=4, bwd_dq_causal=4, bwd_dkv_causal=4)
    shapes = [s["shapes"]["semantic_ids"] for s in steps]
    if any(sh[0] != 6 or sh[2] != 2 or not 576 <= sh[1] <= 2048 for sh in shapes):
        raise AssertionError(f"T2S batches {shapes}: expected [6, 576..2048, 2] semantic ids")
    median = check_train_run("T2S train", steps, evals, os.path.join(logs, "comix_t2s", "checkpoints"),
                             TRAIN_STEPS, 6, per_step, launches())
    if totals != {k: v * len(steps) for k, v in per_step.items()}:
        raise AssertionError(f"launch totals {totals} over the T2S training run")
    results.update(t2s_launches=totals, t2s_steps=len(steps), t2s_step_ms=median,
                   t2s_samples_per_s=6 / (median / 1e3), t2s_peak_gb=peak_gb)
    decoder_t = sorted(sh[1] + 2 for sh in shapes)
    log(f"full-width CoMix T2S training (bf16, B=6, decoder T {decoder_t[0]}-{decoder_t[-1]}): median "
        f"{median:.2f} ms per optimizer step over steps 3-{TRAIN_STEPS}, {6 / (median / 1e3):.2f} samples/s, "
        f"peak device memory {peak_gb:.2f} GiB; run {first_s:.1f} s incl. init and {TRAIN_STEPS} steps, eval "
        f"{evals[0]['s']:.2f} s, resume run {resume_s:.1f} s; launch totals {totals}")


def split_t2s_step(results, key="t2s_split_ms", f32=False):
    """The T2S step's split at the shape the causal kernels are timed at: a
    random batch of 6 texts of 64 ids and semantic targets bucketed to 1024
    (decoder T = 1026), bf16 or with `f32` in f32."""
    import numpy as np
    import torch
    from covomix_tpu_torch.models import text2semantic as T
    from covomix_tpu_torch.train import loop

    cfg = T.T2SConfig(dim=512, source_depth=4, target_depth=4, heads=8, dim_head=64, num_text_tokens=30528,
                      num_semantic_tokens=501, target_dim=1024, two_output=True)
    rs = np.random.RandomState(6)
    batch = {"text_ids": rs.randint(1, 180, (6, 64)).astype(np.int32),
             "semantic_ids": rs.randint(0, 500, (6, 1024, 2)).astype(np.int32)}
    split_training_step(results, key, T.init(torch.Generator(device="cuda").manual_seed(5), cfg),
                        loop.t2s_loss_fn(cfg, dtype=torch.float32 if f32 else torch.bfloat16), batch)


def time_flash_causal(results, b=6, h=8, t=1026, dh=64):
    """The causal forward with lse, dQ and dK/dV at the T2S step's shape (B=6,
    8 heads, targets bucketed to 1024 -> decoder T 1026, bf16, no rotary, all
    keys live), each beside its plain version, its bound and one PyTorch call
    of the same function: SDPA with is_causal=True for the forward, its
    gradient (dQ, dK and dV in one call) for the pair. The bound counts the
    live pairs B*H*T(T+1)/2 at 4, 6 and 8 dh operations each. The outputs on
    the timed inputs are held against the plain versions'."""
    import torch
    import torch.nn.functional as F
    from covomix_tpu_torch.ops import flash_attention as FA

    bf = torch.bfloat16
    q, k, v, valid_arr, _ = flash_inputs(b, h, t, dh, bf, 701, t, False)
    dout = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(702), device="cuda").to(bf)
    log(f"causal flash kernels at the timed inputs [{b},{h},{t},{dh}] bf16:")
    out, lse = FA.KERNEL(q, k, v, valid_arr, None, return_lse=True, causal=True)
    ref, ref_lse = FA.flash_attention_plain(q, k, v, valid_arr, None, True, return_lse=True)
    results["fwd_lse_causal_max_abs_err"] = max(flash_agreement("out", out, ref, BF16_TOL),
                                                flash_agreement("lse", lse, ref_lse, LSE_TOL))
    bwd = (q, k, v, dout, ref_lse, FA.flash_delta(dout, ref), valid_arr, True)
    results["bwd_dq_causal_max_abs_err"] = flash_agreement("dq", FA.KERNEL.bwd_dq(*bwd),
                                                           FA.flash_bwd_dq_plain(*bwd), BWD_BF16_TOL)
    (dk, dv), (dk_p, dv_p) = FA.KERNEL.bwd_dkv(*bwd), FA.flash_bwd_dkv_plain(*bwd)
    results["bwd_dkv_causal_max_abs_err"] = max(flash_agreement("dk", dk, dk_p, BWD_BF16_TOL),
                                                flash_agreement("dv", dv, dv_p, BWD_BF16_TOL))
    del out, ref, dk, dv, dk_p, dv_p
    timed = {
        "fwd_lse_causal": (lambda: FA.KERNEL(q, k, v, valid_arr, None, return_lse=True, causal=True),
                           lambda: FA.flash_attention_plain(q, k, v, valid_arr, None, True, return_lse=True)),
        "bwd_dq_causal": (lambda: FA.KERNEL.bwd_dq(*bwd), lambda: FA.flash_bwd_dq_plain(*bwd)),
        "bwd_dkv_causal": (lambda: FA.KERNEL.bwd_dkv(*bwd), lambda: FA.flash_bwd_dkv_plain(*bwd)),
    }
    for key, (kern, plain) in timed.items():
        both_times(results, key, kern)
        results[f"{key}_plain_ms"] = cuda_time_ms(plain, iters=5)
    noncausal = cuda_time_ms(lambda: FA.KERNEL(q, k, v, valid_arr, None, return_lse=True), behind_sleep=True)
    log(f"forward with lse at [{b},{h},{t},{dh}] bf16 behind a sleep: causal "
        f"{results['fwd_lse_causal_device_ms']:.4f} ms, non-causal {noncausal:.4f} ms")
    both_times(results, "fwd_lse_causal_library", lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    o = F.scaled_dot_product_attention(*leaves, is_causal=True)
    both_times(results, "bwd_causal_library", lambda: torch.autograd.grad(o, leaves, dout, retain_graph=True))
    for key in ("bwd_dq_causal", "bwd_dkv_causal"):   # one call computes dQ, dK and dV
        results[f"{key}_library_ms"] = results["bwd_causal_library_ms"]
        results[f"{key}_library_device_ms"] = results["bwd_causal_library_device_ms"]
    del o, leaves

    n, rows = b * h * t * dh * 2, b * h * t * 4
    pairs = b * h * t * (t + 1) / 2                      # live (query, key) pairs, all keys valid
    work = {"fwd_lse_causal": (4.0 * dh * pairs, 4 * n + rows),      # q,k,v,out; lse
            "bwd_dq_causal": (6.0 * dh * pairs, 5 * n + 2 * rows),   # q,k,v,dO,dq; lse,delta
            "bwd_dkv_causal": (8.0 * dh * pairs, 6 * n + 2 * rows)}  # q,k,v,dO,dk,dv; lse,delta
    for key, (flops, nbytes) in work.items():
        bound_and_log(results, key, [b, h, t, dh], flops, nbytes + valid_arr.numel() * 4)
    log_backward_pair(results, "_causal", [b, h, t, dh])


def check_small_t2s_training_against_cpu():
    """Two optimizer steps of a tiny f32 CoMix T2S model (dh 16, 2 decoder
    layers, targets of 512 -> decoder T 514, so the card takes the causal
    flash kernels) on the card and on the CPU (layers.attend there), TF32 off,
    the same batches."""
    import numpy as np
    import torch
    from covomix_tpu_torch.models import text2semantic as T
    from covomix_tpu_torch.train import loop
    from covomix_tpu_torch.util.misc import tree_leaves, tree_map

    cfg = T.T2SConfig(dim=32, source_depth=1, target_depth=2, heads=2, dim_head=16, num_text_tokens=200,
                      target_dim=64, two_output=True)
    tcfg = loop.TrainConfig(lr=1e-3, use_lr_schedule=True, steps_per_epoch=1, wake_up_epochs=2, grad_clip=1.0)
    rs = np.random.RandomState(9)
    batches = []
    for _ in range(2):
        text = rs.randint(1, 200, (2, 16)).astype(np.int32)
        text[1, 9:] = 0
        sem = rs.randint(0, 500, (2, 512, 2)).astype(np.int32)
        sem[1, 400:] = 501
        batches.append({"text_ids": text, "semantic_ids": sem})
    init = T.init(torch.Generator().manual_seed(0), cfg)
    runs = {}
    for dev in ("cuda", "cpu"):
        state = loop.init_train_state(tree_map(lambda p: p.clone().to(dev), init), tcfg)
        step = loop.make_train_step(loop.t2s_loss_fn(cfg), tcfg)
        c0 = flash_counts()
        losses = [float(step(state, b, None)["loss"]) for b in batches]
        runs[dev] = (losses, tree_map(lambda p: p.detach().cpu(), state.params),
                     {k: v - c0[k] for k, v in flash_counts().items()})
    (lc, pc, nc), (lh, ph, nh) = runs["cuda"], runs["cpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    param_err = max((a - b).abs().max().item() for a, b in zip(tree_leaves(pc), tree_leaves(ph)))
    log(f"small f32 CoMix T2S training, card vs CPU, 2 steps: losses {lc} / {lh} (max rel err {loss_err:.3e}, tol "
        f"{SMALL_TRAIN_LOSS_TOL:g}), params max_abs_err {param_err:.3e} (tol {SMALL_TRAIN_PARAM_TOL:g}), "
        f"launches card {nc} / cpu {nh}")
    if nc != launches(fwd_lse_causal=4, bwd_dq_causal=4, bwd_dkv_causal=4) or any(nh.values()):
        raise AssertionError("the small card run did not go through the causal kernels, or the CPU run did")
    if not (loss_err <= SMALL_TRAIN_LOSS_TOL and param_err <= SMALL_TRAIN_PARAM_TOL):
        raise AssertionError("card and CPU T2S training steps differ")


# ---------------------------------------------------------------------------
# phase 9b: full-width f32 training, the recipes' own precision


F32_TRAIN_STEPS = 8
F32_CELLS = ("vomix", "t2s")


def run_f32_training(results, root, cell):
    """`covomix_tpu_torch.train.cli.main` with the VoMix (cell "vomix") or
    CoMix T2S ("t2s") recipe as running_command/ gives it, without --bf16 (the
    recipes train in f32), at full width on the items phases 8 / 9 write (24
    train items): F32_TRAIN_STEPS optimizer steps, no eval, no resume (the
    bf16 phases cover those). Every VoMix step must launch exactly 8 f32
    forwards with lse, 8 dQ and 8 dK/dV (and no rotary pre-pass: the f32
    kernels take q and k rotated, dq and dk through the tables), every T2S
    step 4 causal ones of each, nothing else; finite losses. Then the step's
    forward / backward / optimizer split in f32 (VoMix at B=8, T=832; T2S at
    decoder T 1026). Logs the median ms per step over steps 3-8, samples/s,
    the split and the peak device memory into results[f"{cell}_f32_*"]."""
    train_dir, logs = os.path.join(root, "train"), os.path.join(root, "logs")
    if cell == "vomix":
        write_vomix_items(train_dir, 24, 0)
        recipe, b, evaluate_name = VOMIX_RECIPE, 8, "evaluate_acoustic"
        per_step = launches(fwd_lse=8, bwd_dq=8, bwd_dkv=8)
    else:
        write_t2s_items(train_dir, 24, 0)
        recipe, b, evaluate_name = COMIX_T2S_RECIPE, 6, "evaluate_t2s"
        per_step = launches(fwd_lse_causal=4, bwd_dq_causal=4, bwd_dkv_causal=4)
    argv = ["--base_dir", train_dir, "--dev_base_dir", train_dir, *[a for a in recipe if a != "--bf16"],
            "--device", "cuda", "--log_every", "1", "--num_eval_files", "0", "--ckpt_every", "1000", "--no_wandb",
            "--log_dir", logs, "--run_name", f"{cell}_f32", "--seed", "0"]
    steps, evals, totals, peak_gb, first_s, _ = run_train_cli(argv, evaluate_name, F32_TRAIN_STEPS, resume=False)
    what = f"{cell} f32 train"
    check_steps(what, steps, per_step)
    if len(steps) != F32_TRAIN_STEPS or evals or totals != {key: n * F32_TRAIN_STEPS for key, n in per_step.items()}:
        raise AssertionError(f"{what}: {len(steps)} steps, {len(evals)} evals, launch totals {totals}")
    ms = sorted(st["ms"] for st in steps[2:])
    median = (ms[len(ms) // 2 - 1] + ms[len(ms) // 2]) / 2
    if cell == "vomix":
        split_vomix_step(results, train_dir, f"{cell}_f32_split_ms", f32=True)
    else:
        split_t2s_step(results, f"{cell}_f32_split_ms", f32=True)
    results.update({f"{cell}_f32_launches": totals, f"{cell}_f32_steps": len(steps), f"{cell}_f32_step_ms": median,
                    f"{cell}_f32_samples_per_s": b / (median / 1e3), f"{cell}_f32_peak_gb": peak_gb})
    shapes = sorted({st["shapes"]["x" if cell == "vomix" else "semantic_ids"] for st in steps})
    log(f"full-width {cell} training in f32 (B={b}, batches {shapes}): median {median:.2f} ms per optimizer step "
        f"over steps 3-{F32_TRAIN_STEPS}, {b / (median / 1e3):.2f} samples/s, peak device memory {peak_gb:.2f} GiB, "
        f"split {json.dumps(results[f'{cell}_f32_split_ms'])}; run {first_s:.1f} s incl. init and "
        f"{F32_TRAIN_STEPS} steps; launch totals {totals}")


# ---------------------------------------------------------------------------
# phase 10: the released checkpoint formats, converted and served directly


def zero_counts():
    """Every launch count of the flash and fused vocoder kernels set to 0."""
    from covomix_tpu_torch.ops import flash_attention as FA, vocoder_tail as VT

    for attr in COUNTS.values():
        setattr(FA.KERNEL, attr, 0)
    VT.STAGE.launches = VT.TAIL.launches = 0


def write_torch_checkpoints(root):
    """Full-width files in the reference's formats, written from the trees of
    the `.npz` checkpoints in `root` by tests/_torch_ckpt.py (the inverse of
    torch_convert): Lightning `.ckpt` files of the CoMix T2S and the VoMix
    model (hyper_parameters, the raw weights + 1 in `state_dict`, the tree as
    the EMA shadow) and a weight-normed HiFi-GAN `g_<step>` with the
    vocoder_config.json beside it, under `root`/torch. Each is converted back
    by `python -m covomix_tpu_torch.convert_checkpoint` (three processes at
    once, CPU only) and every converted leaf held to its source: the T2S and
    acoustic trees (linear, embedding and EMA-swapped leaves) bit for bit,
    the folded vocoder weights within CKPT_WN_RTOL relative. Returns
    {kind: path of the torch-format file}."""
    import numpy as np
    from covomix_tpu_torch.checkpoint.io import load_params
    from covomix_tpu_torch.util.misc import named_leaves

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import _torch_ckpt as CK

    t2s_cfg, ac_cfg, voc_cfg = full_width_configs()
    tdir = os.path.join(root, "torch")
    os.makedirs(tdir)
    paths = {"t2s": os.path.join(tdir, "t2s.ckpt"), "acoustic": os.path.join(tdir, "acoustic.ckpt"),
             "vocoder": os.path.join(tdir, "g_00400000")}
    t0 = time.time()
    CK.write_lightning_ckpt(paths["t2s"], load_params(os.path.join(root, "t2s.npz")), t2s_cfg, "t2s")
    CK.write_lightning_ckpt(paths["acoustic"], load_params(os.path.join(root, "acoustic.npz")), ac_cfg, "acoustic")
    CK.write_hifigan_ckpt(paths["vocoder"], load_params(os.path.join(root, "vocoder.npz")), voc_cfg)
    log(f"torch-format checkpoints written in {time.time() - t0:.1f} s: "
        + ", ".join(f"{os.path.basename(p)} {os.path.getsize(p) / 1e6:.1f} MB" for p in paths.values()))
    t0 = time.time()
    jobs = {kind: subprocess.Popen([sys.executable, "-m", "covomix_tpu_torch.convert_checkpoint",
                                    "hifigan" if kind == "vocoder" else "lightning", src,
                                    os.path.join(tdir, f"{kind}_converted.npz")],
                                   cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for kind, src in paths.items()}
    for kind, proc in jobs.items():
        out = proc.communicate(timeout=900)[0]
        if proc.returncode != 0:
            raise RuntimeError(f"convert_checkpoint of the {kind} file failed:\n{out[-3000:]}")
    log(f"convert_checkpoint x3 (in parallel): {time.time() - t0:.1f} s")
    for kind in paths:
        src = dict(named_leaves(load_params(os.path.join(root, f"{kind}.npz"))))
        got = dict(named_leaves(load_params(os.path.join(tdir, f"{kind}_converted.npz"))))
        if src.keys() != got.keys():
            raise AssertionError(f"converted {kind} tree has other leaves: {sorted(set(src) ^ set(got))[:8]}")
        if kind == "vocoder":
            rel = max(float((np.abs(got[k] - v) / np.maximum(np.abs(v), 1e-30)).max()) for k, v in src.items())
            ok = rel <= CKPT_WN_RTOL
            log(f"converted {kind}: {len(src)} leaves, folded weight norm max relative error {rel:.3e} "
                f"(tol {CKPT_WN_RTOL:g}) {'ok' if ok else 'FAIL'}")
        else:
            bad = [k for k, v in src.items() if not np.array_equal(got[k], v)]
            ok = not bad
            log(f"converted {kind}: {len(src)} leaves, bit-equal to the source tree: {ok} {bad[:5]}")
        if not ok:
            raise AssertionError(f"the converted {kind} checkpoint differs from its source tree")
    return paths


def run_serve_batch_from_torch(results, root, paths, batch=4, decode=512, text_len=64):
    """`covomix_tpu_torch.serve_batch.main([... --device cuda])` reading the
    `.ckpt` / `g_<step>` files directly, one batch at the serving shape (B=4,
    the two dialogue scripts repeated to fill it, 400-frame prompts, decode
    512, bf16): 256 flash launches and as many rotary pre-passes in the run,
    a finite [4, output_length(512)] wav, every saved wav 160 x its
    generated frames long."""
    import numpy as np
    import torch
    from scipy.io import wavfile
    from covomix_tpu_torch import serve_batch, serving
    from covomix_tpu_torch.models import vocoder as V

    out = os.path.join(root, "served")
    seen = []
    orig = serving.BatchedPipeline.__call__

    def call(self, *args, **kwargs):
        wav, res = orig(self, *args, **kwargs)
        seen.append((wav.detach().clone(), torch.minimum(res.lengths, res.lengths2).cpu().numpy()))
        return wav, res

    argv = ["--t2s_ckpt", paths["t2s"], "--acous_ckpt", paths["acoustic"], "--hifigan_ckpt", paths["vocoder"],
            "--text_dir", os.path.join(root, "texts"), "--prompt_dir", os.path.join(root, "prompts"),
            "--saved_dir", out, "--batch", str(batch), "--decode_len", str(decode), "--max_text_tokens",
            str(text_len), "--allow_fallback_vocab", "--device", "cuda"]
    serving.BatchedPipeline.__call__ = call
    zero_counts()
    try:
        t0 = time.time()
        serve_batch.main(argv)
        wall = time.time() - t0
    finally:
        serving.BatchedPipeline.__call__ = orig
    counts = flash_counts()
    log(f"serve_batch from .ckpt / g_ files: {wall:.2f} s incl. reading and converting them; launches {counts}")
    if len(seen) != 1 or counts != launches(fwd=256, rotary=256):
        raise AssertionError(f"expected one batch with 256 flash forwards and pre-passes, got {len(seen)} "
                             f"batches, {counts}")
    wav, lengths = seen[0]
    if tuple(wav.shape) != (batch, V.output_length(V.VocoderConfig(), decode)) or not bool(torch.isfinite(wav).all()):
        raise AssertionError(f"bad served wav: {tuple(wav.shape)}, finite {bool(torch.isfinite(wav).all())}")
    for i, name in enumerate(sorted(os.listdir(os.path.join(root, "texts")))):
        sr, w = wavfile.read(os.path.join(out, name.replace(".txt", ".wav")))
        if sr != 8000 or len(w) != max(int(lengths[i]) * 160, 160):
            raise AssertionError(f"served {name}: {sr} Hz, {len(w)} samples for {lengths[i]} frames")
    results.update(serve_torch_wall_s=wall, serve_torch_launches=counts)


# ---------------------------------------------------------------------------
# phase 11: HiFi-GAN inference (copy synthesis with metrics) from the g_ file


HIFI_SECONDS = (3.0, 10.24, 20.0, 41.0)


def write_hifigan_wavs(wav_dir, seed=3):
    """8 kHz speech-like inputs of HIFI_SECONDS: harmonics of a gliding f0
    under a syllable-rate envelope, plus a little noise."""
    import numpy as np
    from covomix_tpu_torch.audio import save_wav

    os.makedirs(wav_dir)
    rs = np.random.RandomState(seed)
    for i, s in enumerate(HIFI_SECONDS):
        t = np.arange(int(8000 * s)) / 8000
        f0 = 110 + 40 * np.sin(2 * np.pi * 0.3 * t + rs.rand())
        phase = 2 * np.pi * np.cumsum(f0) / 8000
        x = sum(np.sin(h * phase) / h for h in range(1, 12)) * (0.55 + 0.45 * np.sin(2 * np.pi * 4 * t)) ** 2
        save_wav(os.path.join(wav_dir, f"f{i}.wav"), (0.25 * x + 0.005 * rs.randn(len(t))).astype(np.float32), 8000)


def generator_right_reach(cfg) -> float:
    """Mel frames to the left of the valid end that bucket padding can reach
    through the generator: conv_pre's 3 frames, each upsample's padding, each
    stage's widest ResBlock1 branch (sum of (k-1)/2 x dilation + (k-1)/2 per
    pair) at that stage's rate, conv_post's 3 samples. 19.45 for the covomix
    config."""
    reach, rate = 3.0, 1
    for u, k in zip(cfg.upsample_rates, cfg.upsample_kernel_sizes):
        reach += ((k - u) // 2) / (rate * u)
        rate *= u
        reach += max((kr - 1) // 2 * (sum(d) + len(d)) for kr, d in
                     zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)) / rate
    return reach + 3 / rate


def run_hifigan_inference(results, root, g_path):
    """`covomix_tpu_torch.hifigan_inference.main([... --device cuda])` from the
    full-width `g_<step>` over the HIFI_SECONDS wavs, f32, with --metrics_csv,
    once with --fuse_tail and once without. Counts set to 0 before each run
    and read after: with --fuse_tail each file launches the f32 fused stage
    and tail once, without them neither; every wav finite and
    output_length(T) long; every CSV value finite; the two runs' wavs equal
    within HIFI_FUSED_TOL outside the generator's reach from the valid end
    (the fused kernels are static-length, the exact path masks padding).
    Then the f32 stage and tail timed on the inputs the longest file gave
    them."""
    import csv

    import numpy as np
    import torch
    from covomix_tpu_torch import hifigan_inference as HI
    from covomix_tpu_torch.models import vocoder as V
    from covomix_tpu_torch.ops import vocoder_tail as VT

    wav_dir = os.path.join(root, "hifi_wavs")
    write_hifigan_wavs(wav_dir)
    cfg = V.VocoderConfig()
    orig = (HI.vocode, VT.fused_stage, VT.fused_tail)
    runs = {}
    for fuse in (True, False):
        calls, inputs = [], {}

        def vocode(params, cfg_, mel, fuse_tail, _calls=calls):
            s0, n0 = VT.STAGE.launches, VT.TAIL.launches
            torch.cuda.synchronize()
            t0 = time.time()
            out = orig[0](params, cfg_, mel, fuse_tail)
            torch.cuda.synchronize()
            _calls.append({"frames": mel.shape[1], "wall_s": time.time() - t0, "stage": VT.STAGE.launches - s0,
                           "tail": VT.TAIL.launches - n0, "wav": out[0].float().cpu().numpy()})
            return out

        def fused_stage(x, up_p, resblocks, kernels, dilations, _inputs=inputs):
            _inputs["stage"] = (x.contiguous().clone(), up_p, resblocks, None)
            return orig[1](x, up_p, resblocks, kernels, dilations)

        def fused_tail(x, up_p, resblocks, post_p, kernels, dilations, _inputs=inputs):
            _inputs["tail"] = (x.contiguous().clone(), up_p, resblocks, post_p)
            return orig[2](x, up_p, resblocks, post_p, kernels, dilations)

        csv_path = os.path.join(root, f"hifi_{'fused' if fuse else 'exact'}.csv")
        argv = ["--checkpoint_file", g_path, "--input_wavs_dir", wav_dir, "--output_dir",
                os.path.join(root, f"hifi_out_{fuse}"), "--metrics_csv", csv_path, "--device", "cuda"]
        HI.vocode, VT.fused_stage, VT.fused_tail = vocode, fused_stage, fused_tail
        zero_counts()
        try:
            t0 = time.time()
            HI.main(argv + (["--fuse_tail"] if fuse else []))
            wall = time.time() - t0
        finally:
            HI.vocode, VT.fused_stage, VT.fused_tail = orig
        counts = {"stage": VT.STAGE.launches, "tail": VT.TAIL.launches, **flash_counts()}
        with open(csv_path) as f:
            rows = list(csv.DictReader(f))
        per_file = [(c["frames"], round(c["wall_s"], 6), c["stage"], c["tail"]) for c in calls]
        log(f"hifigan_inference {'--fuse_tail' if fuse else 'exact (valid_len)'} f32: {wall:.2f} s for "
            f"{len(calls)} files incl. metrics; per file (frames, vocode wall s, stage, tail launches) {per_file}; "
            f"launches {counts}; CSV {rows}")
        want = 1 if fuse else 0
        if len(calls) != len(HIFI_SECONDS) or any(c["stage"] != want or c["tail"] != want for c in calls):
            raise AssertionError(f"per file stage / tail launches {per_file}, expected {want} each")
        if counts != {"stage": want * len(calls), "tail": want * len(calls), **launches()}:
            raise AssertionError(f"launch totals {counts}")
        for c in calls:
            if len(c["wav"]) != V.output_length(cfg, c["frames"]) or not np.isfinite(c["wav"]).all():
                raise AssertionError(f"wav of {c['frames']} frames: {len(c['wav'])} samples, finite "
                                     f"{np.isfinite(c['wav']).all()}")
        if len(rows) != len(HIFI_SECONDS) or not all(np.isfinite(float(r[k])) for r in rows for k in r
                                                     if k != "file"):
            raise AssertionError(f"metrics CSV not complete and finite: {rows}")
        runs[fuse] = (calls, inputs, rows, counts)
    reach = int(np.ceil(generator_right_reach(cfg)))
    worst = 0.0
    for a, b in zip(runs[True][0], runs[False][0]):
        n = 160 * (a["frames"] - reach)
        diff = np.abs(a["wav"] - b["wav"])
        worst = max(worst, float(diff[:n].max()))
        log(f"  {a['frames']} frames: fused vs exact max |diff| {diff[:n].max():.3e} before the last {reach} "
            f"frames, {diff[n:].max():.3e} within them")
    log(f"hifigan_inference fused vs exact (f32, TF32 off): max |diff| {worst:.3e} outside the last {reach} frames "
        f"(the generator's reach, {generator_right_reach(cfg):.2f}) (tol {HIFI_FUSED_TOL:g}) "
        f"{'ok' if worst <= HIFI_FUSED_TOL else 'FAIL'}")
    if not worst <= HIFI_FUSED_TOL:
        raise AssertionError("the fused and exact hifigan_inference wavs differ")
    for fuse, (calls, _, rows, _) in runs.items():
        rtf = [c["wall_s"] / (len(c["wav"]) / 8000) for c in calls]
        results[f"hifi_{'fused' if fuse else 'exact'}"] = {
            "rtf_per_file": rtf, "audio_s": [len(c["wav"]) / 8000 for c in calls],
            "metrics_mean": {k: float(np.mean([float(r[k]) for r in rows])) for k in rows[0] if k != "file"}}
    results["hifi_launches"] = {kind: runs[True][3][kind] for kind in ("stage", "tail")}
    for kind, (x, up, blocks, post) in runs[True][1].items():   # the longest file's, f32
        time_vocoder(results, f"{kind}_f32", kind, x, up, blocks, post)


# ---------------------------------------------------------------------------
# phase 12: HuBERT semantic tokens through the extraction CLI


HUBERT_SECONDS = (3, 4, 5, 6, 8, 9.5, 20, 22, 30, 45, 50, 60)


def write_hubert_assets(root, seed=4):
    """Full-width random HuBERT weights (HubertConfig(), seeded, on the card)
    written as an `.npz` by the port's save_params, and 16 kHz wavs of
    HUBERT_SECONDS (harmonics under an envelope plus noise) in two
    subdirectories."""
    import numpy as np
    import torch
    from covomix_tpu_torch.audio import save_wav
    from covomix_tpu_torch.checkpoint.io import save_params
    from covomix_tpu_torch.models import hubert as H

    save_params(os.path.join(root, "hubert.npz"), H.init(torch.Generator(device="cuda").manual_seed(seed),
                                                         H.HubertConfig()), meta={"kind": "hubert", "config": {}})
    rs = np.random.RandomState(seed)
    for i, s in enumerate(HUBERT_SECONDS):
        t = np.arange(int(16000 * s)) / 16000
        x = sum(np.sin(2 * np.pi * h * (140 + 20 * i) * t) / h for h in range(1, 9))
        x = 0.2 * x * (0.5 + 0.5 * np.sin(2 * np.pi * 3.5 * t)) + 0.02 * rs.randn(len(t))
        sub = os.path.join(root, "wavs", f"spk{i % 2}")
        os.makedirs(sub, exist_ok=True)
        save_wav(os.path.join(sub, f"u{i}.wav"), x.astype(np.float32), 16000)


def run_extract_semantic_tokens(results, root, bf16: bool):
    """`covomix_tpu_torch.extract_semantic_tokens.main([... --device cuda])`
    at full width over the HUBERT_SECONDS wavs (f32, or bf16 with --bf16),
    counts set to 0 before and read after: each batch launches exactly 12
    non-causal forwards without lse (one per encoder layer) when its padded
    frame count is >= 512 and none below, no rotary pre-pass and no other
    flash kernel; every output a string array of num_output_frames ids in
    [0, 500). Returns the batches' (rows, padded frames, valid frames)."""
    import numpy as np
    import torch
    from covomix_tpu_torch import extract_semantic_tokens as EST
    from covomix_tpu_torch.audio import load_wav
    from covomix_tpu_torch.models import hubert as H

    cfg = H.HubertConfig()
    key = "bf16" if bf16 else "f32"
    out = os.path.join(root, f"codes_{key}")
    batches = []
    orig = H.wav2units_batch

    def wav2units_batch(params, cfg_, wav, padding_mask=None, valid_samples=None, dtype=torch.float32):
        c0 = flash_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        ids = orig(params, cfg_, wav, padding_mask=padding_mask, valid_samples=valid_samples, dtype=dtype)
        torch.cuda.synchronize()
        batches.append({"rows": wav.shape[0], "frames": padding_mask.shape[1], "wall_s": time.time() - t0,
                        "valid": padding_mask.sum(dim=1).tolist(),
                        "launches": {k: v - c0[k] for k, v in flash_counts().items()}})
        return ids

    argv = ["--data_dir", os.path.join(root, "wavs"), "--hubert_ckpt", os.path.join(root, "hubert.npz"),
            "--out_dir", out, "--device", "cuda"] + (["--bf16"] if bf16 else [])
    H.wav2units_batch = wav2units_batch
    zero_counts()
    try:
        t0 = time.time()
        EST.main(argv)
        wall = time.time() - t0
    finally:
        H.wav2units_batch = orig
    counts = flash_counts()
    log(f"extract_semantic_tokens {key}: {wall:.2f} s incl. reading the wavs; batches (rows, frames, s, flash "
        f"forwards) {[(b['rows'], b['frames'], round(b['wall_s'], 6), b['launches']['fwd']) for b in batches]}; "
        f"launches {counts}")
    for b in batches:
        want = cfg.encoder_layers if b["frames"] >= 512 else 0
        if b["launches"] != launches(fwd=want):
            raise AssertionError(f"a batch of {b['rows']} x {b['frames']} frames launched {b['launches']}, "
                                 f"expected {want} forwards and nothing else")
    if counts != launches(fwd=sum(cfg.encoder_layers for b in batches if b["frames"] >= 512)):
        raise AssertionError(f"launch totals {counts}")
    if not any(b["frames"] >= 512 for b in batches) or not any(b["frames"] < 512 for b in batches):
        raise AssertionError("the batches did not exercise both attention routes")
    frames = 0
    for i, s in enumerate(HUBERT_SECONDS):
        wav, _ = load_wav(os.path.join(root, "wavs", f"spk{i % 2}", f"u{i}.wav"), sr=16000)
        codes = np.load(os.path.join(out, f"spk{i % 2}", f"u{i}.hubert_code.npy"))
        ids = codes.astype(int)
        if codes.dtype.kind != "U" or len(ids) != H.num_output_frames(cfg, len(wav)) or not (
                (ids >= 0) & (ids < cfg.num_units)).all():
            raise AssertionError(f"u{i}: {codes.dtype}, {len(ids)} ids, range [{ids.min()}, {ids.max()}]")
        frames += len(ids)
    ext = sum(b["wall_s"] for b in batches)
    audio_s = sum(HUBERT_SECONDS)
    results[f"hubert_{key}"] = {"tokens": frames, "audio_s": audio_s, "batch_s": ext, "tokens_per_s": frames / ext,
                                "x_realtime": audio_s / ext, "cli_wall_s": wall, "launches": counts["fwd"],
                                "batches": [{k: v for k, v in b.items() if k != "launches"} for b in batches]}
    log(f"HuBERT {key}: {frames} tokens from {audio_s:.1f} s of audio in {ext:.4f} s of batches: "
        f"{frames / ext:.1f} tokens/s, {audio_s / ext:.1f}x realtime")
    return batches


def check_hubert_against_cpu(root):
    """One padded batch (11 s and 8 s, padded to 15 s: 749 frames, the flash
    route on the card) through the full-width HuBERT cut to 2 encoder layers,
    f32, TF32 off, on the card and on the CPU (layers.attend there): the
    features within HUBERT_FEAT_TOL; the share of equal k-means ids printed."""
    import dataclasses

    import numpy as np
    import torch
    from covomix_tpu_torch.checkpoint.io import load_params, params_from_numpy
    from covomix_tpu_torch.models import hubert as H

    cfg = dataclasses.replace(H.HubertConfig(), output_layer=2)
    tree = load_params(os.path.join(root, "hubert.npz"))
    lens = [11 * 16000, 8 * 16000]
    rs = np.random.RandomState(6)
    batch = np.zeros((2, 15 * 16000), np.float32)
    for i, n in enumerate(lens):
        batch[i, :n] = 0.1 * rs.randn(n)
    fv = [H.num_output_frames(cfg, n) for n in lens]
    outs = {}
    for dev in ("cuda", "cpu"):
        params = params_from_numpy(tree, dev)
        mask = torch.arange(H.num_output_frames(cfg, batch.shape[1]), device=dev)[None, :] < torch.tensor(
            fv, device=dev)[:, None]
        c0 = flash_counts()["fwd"]
        with torch.no_grad():
            feats = H.extract_features(params, cfg, torch.from_numpy(batch).to(dev), padding_mask=mask,
                                       valid_samples=torch.tensor(lens, device=dev),
                                       valid_frames=mask.sum(dim=1).to(torch.int32))
            ids = H.kmeans_assign(params, feats)
        outs[dev] = (feats.cpu(), ids.cpu(), flash_counts()["fwd"] - c0)
    (fc, ic, nc), (fh, ih, nh) = outs["cuda"], outs["cpu"]
    err = max(float((fc[i, :n] - fh[i, :n]).abs().max()) for i, n in enumerate(fv))
    agree = sum(int((ic[i, :n] == ih[i, :n]).sum()) for i, n in enumerate(fv)) / sum(fv)
    log(f"HuBERT (full width, 2 layers) card vs CPU, f32, batch [2, {batch.shape[1]}] ({mask.shape[1]} frames, "
        f"valid {fv}): features max_abs_err {err:.3e} (tol {HUBERT_FEAT_TOL:g}), |features| max "
        f"{float(fh.abs().max()):.3g}; k-means ids equal on {agree:.4%} of the valid frames; flash forwards card "
        f"{nc} / cpu {nh}")
    if nc != cfg.output_layer or nh != 0:
        raise AssertionError("the card run did not take the flash kernel in every layer, or the CPU run did")
    if not err <= HUBERT_FEAT_TOL:
        raise AssertionError(f"HuBERT features differ between the card and the CPU by {err}")
    return agree


def time_flash_hubert(results, key, dtype, b, t, valid, h=12, dh=64):
    """The forward at a HuBERT batch's shape [b, 12, t, 64] (no rotary, the
    batch's per-row valid frames) in `dtype`: the kernel's output on the
    timed inputs held against the plain version (F32_TOL / BF16_TOL), the
    kernel back to back and behind a sleep, the plain version, SDPA in the
    same dtype with the key mask, and the bound (operations over the peak
    of the dtype: f32 outside the tensor cores, bf16 on them)."""
    import torch
    import torch.nn.functional as F
    from covomix_tpu_torch.ops import flash_attention as FA

    q, k, v, valid_arr, _ = flash_inputs(b, h, t, dh, dtype, 97, valid, False)
    out = FA.KERNEL(q, k, v, valid_arr, None)
    ref = FA.flash_attention_plain(q, k, v, valid_arr, None)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    err = results[f"{key}_max_abs_err"] = (out.float() - ref.float()).abs().max().item()
    ok = bool(torch.isfinite(out).all()) and err <= tol
    log(f"flash check at the HuBERT batch's shape [{b},{h},{t},{dh}] {str(dtype)[6:]} valid={valid_arr.tolist()}: "
        f"max_abs_err {err:.3e} (tol {tol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash kernel disagrees with its plain version at [{b},{h},{t},{dh}] {dtype}")
    del out, ref
    ms = both_times(results, key, lambda: FA.KERNEL(q, k, v, valid_arr, None), iters=10)
    results[f"{key}_plain_ms"] = cuda_time_ms(lambda: FA.flash_attention_plain(q, k, v, valid_arr, None),
                                              iters=3, warmup=1)
    mask = (torch.arange(t, device="cuda")[None, :] < valid_arr[:, None])[:, None, None, :]
    both_times(results, f"{key}_library", lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), iters=10)
    flops = 4.0 * h * dh * t * valid_arr.long().sum().item()
    nbytes = 4 * b * h * t * dh * q.element_size() + valid_arr.numel() * 4
    peak = H100_F32_FLOPS if dtype == torch.float32 else H100_BF16_FLOPS
    bf_ms, bb_ms = flops / peak * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    results[f"{key}_bound_ms"] = max(bf_ms, bb_ms)
    results[f"{key}_bound_by"] = "operations" if bf_ms >= bb_ms else "bytes"
    log(f"flash timing at the HuBERT batch's shape [{b},{h},{t},{dh}] {str(dtype)[6:]} (ms back to back / behind a "
        f"sleep): kernel {ms:.4f} / {results[f'{key}_device_ms']:.4f}; SDPA {results[f'{key}_library_ms']:.4f} / "
        f"{results[f'{key}_library_device_ms']:.4f}; plain {results[f'{key}_plain_ms']:.4f}; bound "
        f"{results[f'{key}_bound_ms']:.4f} ({results[f'{key}_bound_by']}: {flops / 1e9:.2f} GFLOP at "
        f"{peak / 1e12:g} TFLOP/s, {nbytes / 1e6:.1f} MB) -> {flops / results[f'{key}_device_ms'] / 1e9:.1f} "
        f"TFLOP/s on the card")


def run_hubert(results, root):
    """Phase 12: the HuBERT assets, the extraction CLI in f32 and in bf16,
    the card-vs-CPU check, and the forward timed at the largest flash
    batch's shape (most query-key pairs) in both dtypes."""
    t0 = time.time()
    write_hubert_assets(root)
    log(f"HuBERT assets (full-width .npz, {len(HUBERT_SECONDS)} wavs of {sum(HUBERT_SECONDS)} s) written in "
        f"{time.time() - t0:.1f} s")
    batches = run_extract_semantic_tokens(results, root, bf16=False)
    run_extract_semantic_tokens(results, root, bf16=True)
    results["hubert_ids_agree_cpu"] = check_hubert_against_cpu(root)
    import torch

    big = max((b for b in batches if b["frames"] >= 512), key=lambda b: b["rows"] * b["frames"] ** 2)
    for dtype, key in ((torch.float32, "hubert_fwd_f32"), (torch.bfloat16, "hubert_fwd_bf16")):
        time_flash_hubert(results, key, dtype, big["rows"], big["frames"], big["valid"])


# ---------------------------------------------------------------------------
# phase 13: speculative decode at full width


SPEC_FIT_STEPS = 400      # bench.py's BENCH_SPEC_FIT
SPEC_FIT_BATCH = 8
SPEC_TARGET = 576         # targets bucketed to 576: decoder T 578, on the causal flash kernels
SPEC_PATTERN = 480        # pattern tokens before the trained EOS
SPEC_GAMMAS = (2, 4, 8)
SPEC_DECODE = 512
# bf16 greedy [B, 1] steps and the verify's [B, gamma+1] forward may round
# their products differently: a first divergence passes only where greedy's
# top two logits lie within 2^-6 x max(1, |top logit|), a bf16 near-tie
SPEC_BF16_TIE = 2 ** -6


def spec_config():
    """The serving CoMix T2S with the draft heads after decoder layer 2 of 4
    (bench.py's spec_decode_stats config)."""
    import dataclasses

    return dataclasses.replace(full_width_configs()[0], target_early_exit_layer=2)


def spec_batch(rs, b):
    """bench.py's `synth` at the causal-kernel length: b texts of 24 ids in
    [1, 200) (the fallback vocab's characters lie there), targets the
    positional pattern (7 + j) % 501 for j < SPEC_PATTERN, then pad (-1, so
    the CE trains EOS right after the pattern), on both streams."""
    import numpy as np

    j = np.arange(SPEC_TARGET)
    tgt = np.where(j < SPEC_PATTERN, (7 + j) % 501, -1)
    return {"text_ids": rs.randint(1, 200, (b, 24)).astype(np.int32),
            "semantic_ids": np.ascontiguousarray(np.broadcast_to(np.stack([tgt, tgt], -1), (b, SPEC_TARGET, 2)))
            .astype(np.int32)}


def fit_draft_heads(results):
    """SPEC_FIT_STEPS optimizer steps of `train.loop.make_train_step` with
    `t2s_loss_fn` (bf16, Adam 3e-4, EMA on) over fresh spec_batch rows:
    every step must launch exactly 4 causal forwards with lse, 4 causal dQ
    and 4 causal dK/dV (the 4 decoder layers; the early-exit CE reuses the
    hidden states) and no other flash kernel, with a finite loss; the first
    step's gradient reaches both draft heads. Returns (config, parameters)."""
    import numpy as np
    import torch
    from covomix_tpu_torch.models import text2semantic as T
    from covomix_tpu_torch.train import loop
    from covomix_tpu_torch.util.misc import tree_map

    cfg = spec_config()
    tcfg = loop.TrainConfig(lr=3e-4)
    state = loop.init_train_state(T.init(torch.Generator(device="cuda").manual_seed(21), cfg), tcfg)
    step = loop.make_train_step(loop.t2s_loss_fn(cfg, dtype=torch.bfloat16), tcfg)
    per_step = launches(fwd_lse_causal=4, bwd_dq_causal=4, bwd_dkv_causal=4)
    rs = np.random.RandomState(100)
    ms, losses = [], []
    zero_counts()
    for i in range(SPEC_FIT_STEPS):
        batch = spec_batch(rs, SPEC_FIT_BATCH)
        torch.cuda.synchronize()
        c0, t0 = flash_counts(), time.time()
        loss = float(step(state, batch, None)["loss"])      # waits for the card
        ms.append((time.time() - t0) * 1e3)
        losses.append(loss)
        made = {k: v - c0[k] for k, v in flash_counts().items()}
        if made != per_step or not np.isfinite(loss):
            raise AssertionError(f"draft-head fit step {i + 1}: loss {loss}, launches {made} (expected {per_step})")
        if i == 0:
            ee = state.params["early_exit"]
            heads = {h: float(ee[h]["w"].grad.abs().sum()) for h in ("to_logits", "to_logits2")}
            if not all(g > 0 for g in heads.values()):
                raise AssertionError(f"the first fit step's gradient does not reach the draft heads: {heads}")
    median = float(np.median(ms[2:]))
    totals = flash_counts()
    log(f"draft-head fit (CoMix full width + early exit at layer 2, bf16, B={SPEC_FIT_BATCH}, decoder T "
        f"{SPEC_TARGET + 2}): {SPEC_FIT_STEPS} steps, median {median:.2f} ms per step, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; launch totals {totals}")
    results.update(spec_fit_step_ms=median, spec_fit_loss=losses[-1], spec_fit_launches=totals)
    return cfg, tree_map(lambda p: p.detach(), state.params)


class GreedyLogits:
    """Records the scores `generate` samples from, per step and stream: the
    logits plus temperature x the Gumbel noise (greedy, temperature 1e-10:
    the logits). While it is entered, `sampling.gumbel_sample` is replaced
    by a copy that records (the same operations), and the decode runs its
    step directly (text2semantic.CAPTURE off): a captured graph would run
    the Python of the step only once. `streams`: samples per step."""

    def __init__(self, streams=2):
        self.steps, self.streams = [], streams

    def __enter__(self):
        import torch
        from covomix_tpu_torch.models import text2semantic as T
        from covomix_tpu_torch.ops import sampling as S

        self._orig, self._capture = S.gumbel_sample, T.CAPTURE

        def gumbel_sample(generator, logits, temperature=1.0, dim=-1):
            t = max(float(temperature), 1e-10)
            noise = S.gumbel_noise(generator, logits.shape, logits.device)
            self.steps.append((logits.detach().float() + t * noise).clone())
            return torch.argmax(logits / t + noise, dim=dim)

        S.gumbel_sample, T.CAPTURE = gumbel_sample, False
        return self

    def __exit__(self, *exc):
        from covomix_tpu_torch.models import text2semantic as T
        from covomix_tpu_torch.ops import sampling as S

        S.gumbel_sample, T.CAPTURE = self._orig, self._capture

    def margin(self, pos, stream, row, n_steps):
        """The top-two gap of the score sampled at step `pos` on `stream`,
        over max(1, |top score|). (The step function runs past the stop to
        the end of its chunk, so the record may hold more than n_steps
        steps; step `pos` is at pos * streams.)"""
        import torch

        top = torch.topk(self.steps[pos * self.streams + min(stream, self.streams - 1)][row], 2).values
        return float((top[0] - top[1]) / max(1.0, abs(float(top[0]))))


def hold_tokens(what, greedy, spec, logits=None):
    """The speculative tokens (both streams) against greedy's, row by row.
    Without `logits` (f32, TF32 off) every position must be equal. With the
    greedy run's GreedyLogits (bf16), a row may diverge where greedy's top
    two logits are within SPEC_BF16_TIE; a row whose first difference is
    pad against a token (the global stop moved) passes only beside such a
    tie. Returns [(row, position, relative margin)] of the divergences."""
    import numpy as np

    g = [greedy.tokens.cpu().numpy(), greedy.tokens2.cpu().numpy()]
    s = [spec.tokens.cpu().numpy(), spec.tokens2.cpu().numpy()]
    found, stops = [], []
    for r in range(g[0].shape[0]):
        diff = np.nonzero((g[0][r] != s[0][r]) | (g[1][r] != s[1][r]))[0]
        if not len(diff):
            continue
        p = int(diff[0])
        if any(min(g[k][r, p], s[k][r, p]) < 0 for k in (0, 1)) or logits is None:
            stops.append((r, p, float("inf")))
            continue
        found.append((r, p, max(logits.margin(p, k, r, greedy.num_steps) for k in (0, 1)
                                if g[k][r, p] != s[k][r, p])))
    ties = [d for d in found if d[2] < SPEC_BF16_TIE]
    log(f"{what}: tokens equal in {g[0].shape[0] - len(found) - len(stops)} of {g[0].shape[0]} rows; "
        f"divergences (row, position, top-two margin / max(1, |logit|)) {found + stops} (tie below "
        f"{SPEC_BF16_TIE:g})")
    if len(ties) != len(found) or (stops and not ties):
        raise AssertionError(f"{what}: speculative tokens differ from greedy's beyond a bf16 near-tie: "
                             f"{found + stops}")
    return found + stops


def spec_tokens(res):
    """Decoded positions per row (the shorter stream's, EOS included)."""
    import torch

    return torch.minimum(res.lengths, res.lengths2).double().cpu().numpy()


def run_spec_decode(results, cfg, params):
    """Greedy `generate` (temperature 1e-10, top_k_thres 1.0) against
    `generate_speculative` at every gamma of SPEC_GAMMAS on 8 seeded texts,
    max_length 512: in f32 with TF32 off the tokens must be equal position
    for position; in bf16 equal up to near-ties (hold_tokens). Every
    speculative run must take at most tokens / 2 verify rounds. The bf16
    decodes are timed as the best of 3, taken in turns (greedy's scores
    recorded by one more, untimed call of the direct step); bench.py's keys
    are logged for gamma 4."""
    import numpy as np
    import torch
    from covomix_tpu_torch.models import text2semantic as T

    text = torch.as_tensor(spec_batch(np.random.RandomState(7), 8)["text_ids"], device="cuda")
    gen = torch.Generator(device="cuda")
    table = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = "f32" if dtype == torch.float32 else "bf16"
        runs = 3 if dtype == torch.bfloat16 else 1     # the f32 walls: one run each, first calls included
        decoders = {"greedy": lambda: T.generate(params, cfg, gen.manual_seed(0), text, max_length=SPEC_DECODE,
                                                 temperature=1e-10, top_k_thres=1.0, dtype=dtype)}
        for g in SPEC_GAMMAS:
            decoders[g] = lambda g=g: T.generate_speculative(params, cfg, text, max_length=SPEC_DECODE, gamma=g,
                                                             dtype=dtype)
        logits, out, walls = GreedyLogits(), {}, {key: float("inf") for key in decoders}
        if dtype == torch.bfloat16:
            with logits:        # greedy's scores, recorded by the direct step, untimed
                decoders["greedy"]()
        # every decode once a turn, so that a slow spell of the shared host
        # falls on all of them alike
        for turn in range(runs):
            for key, fn in decoders.items():
                torch.cuda.synchronize()
                t0 = time.time()
                out[key] = fn()
                torch.cuda.synchronize()
                walls[key] = min(walls[key], time.time() - t0)
        greedy, wg = out["greedy"], walls["greedy"]
        gtok = spec_tokens(greedy)
        row = {"greedy_wall_s": wg, "greedy_steps": greedy.num_steps, "greedy_tokens": float(gtok.mean())}
        for gamma in SPEC_GAMMAS:
            spec, ws = out[gamma], walls[gamma]
            hold_tokens(f"spec decode {name} gamma {gamma} vs greedy", greedy, spec,
                        logits if dtype == torch.bfloat16 else None)
            stok = spec_tokens(spec)
            per_round = float(stok.mean()) / max(spec.num_steps, 1)
            row[gamma] = {"wall_s": ws, "rounds": spec.num_steps, "tokens": float(stok.mean()),
                          "tokens_per_round": per_round, "acceptance": max(0.0, (per_round - 1.0) / gamma),
                          "speedup": (stok.sum() / ws) / (gtok.sum() / wg)}
            if spec.num_steps > stok.mean() / 2:
                raise AssertionError(f"spec decode {name} gamma {gamma}: {spec.num_steps} rounds for "
                                     f"{stok.mean()} tokens (acceptance collapsed)")
        table[name] = row
        log(f"spec decode {name} (B=8, max_length {SPEC_DECODE}): " + json.dumps(row))
    g4, bf = table["bf16"][4], table["bf16"]
    bench_keys = {"t2s_spec_gamma": 4, "t2s_spec_tokens_per_round": g4["tokens_per_round"],
                  "t2s_spec_acceptance": g4["acceptance"],
                  "t2s_greedy_tok_per_s": bf["greedy_tokens"] * 8 / bf["greedy_wall_s"],
                  "t2s_spec_tok_per_s": g4["tokens"] * 8 / g4["wall_s"], "t2s_spec_speedup": g4["speedup"]}
    log("spec decode bench keys (bf16): " + json.dumps(bench_keys))
    results.update(spec_decode=table, spec_bench=bench_keys)


def run_spec_serving(results, cfg, params, models, batch=4, prompt=400, decode=SPEC_DECODE):
    """BatchedPipeline(speculative=True, spec_gamma=4) at phase 4's shape
    (B=4, prompt 400, decode 512, bf16) with the fitted T2S and phase 4's
    VoMix and HiFi-GAN: one batch timed with the launch counts set to 0
    just before (256 flash forwards and as many pre-passes, nothing
    else), a finite wav of the expected shape, the tokens a greedy
    `generate` of the same rows gives (hold_tokens' bf16 rule), and the
    batch's split beside phase 4's."""
    import numpy as np
    import torch
    from covomix_tpu_torch.models import text2semantic as T, vocoder as V
    from covomix_tpu_torch.serving import BatchedPipeline

    _, ac_cfg, voc_cfg = full_width_configs()
    pipe = BatchedPipeline(params, cfg, models[0], ac_cfg, models[1], voc_cfg, decode_len=decode, cond_scale=0.7,
                           dtype=torch.bfloat16, device="cuda", speculative=True, spec_gamma=4)
    _, pt, pm = serving_inputs(batch, prompt, 24, ac_cfg.dim_in, 1)
    placed = pipe.place(spec_batch(np.random.RandomState(8), batch)["text_ids"], pt, pm)
    gen = torch.Generator(device="cuda").manual_seed(10)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.time()
    wav, res = pipe(gen, *placed)     # no warm-up: run_spec_decode and phase 4 ran every stage before
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = flash_counts()
    if counts != launches(fwd=256, rotary=256):
        raise AssertionError(f"speculative serving batch launched {counts}, expected 256 forwards and pre-passes")
    if tuple(wav.shape) != (batch, V.output_length(voc_cfg, decode)) or not bool(torch.isfinite(wav).all()):
        raise AssertionError(f"bad wav: shape {tuple(wav.shape)}, finite {bool(torch.isfinite(wav).all())}")
    with GreedyLogits() as logits:
        greedy = T.generate(pipe.t2s_params, cfg, gen, placed[0], max_length=decode, temperature=1e-10,
                            top_k_thres=1.0, dtype=torch.bfloat16)
    hold_tokens("speculative serving vs greedy", greedy, res, logits)

    stages, valid = split_serving_batch(pipe, gen, placed)
    audio_s = float(spec_tokens(res).sum()) * 0.02
    log(f"speculative serving B={batch} prompt={prompt} decode={decode} gamma 4 bf16: wall {wall:.4f} s for "
        f"{audio_s:.2f} s of generated audio (RTF {wall / audio_s:.5f}), verify rounds {res.num_steps}, tokens "
        f"{spec_tokens(res).tolist()}; split (s) {json.dumps(stages)}; phase 4 (sampling, EOS masked, 512 "
        f"frames each): {json.dumps(results['stages'])}")
    results.update(spec_serving_wall_s=wall, spec_serving_rtf=wall / audio_s, spec_serving_stages=stages,
                   spec_serving_launches=counts, spec_serving_rounds=res.num_steps)


def run_spec_dialogue(results, root, cfg, params):
    """The fitted T2S saved with save_params, then the dialogue CLI with
    --speculative on phase 6's prompts and scripts (run_dialogue_cli's gates:
    one fused stage and tail per vocode, 256 flash forwards and pre-passes
    per flow sample, int16 wavs of 160 x generated frames), and the decoded
    tokens against a greedy Synthesizer's (temperature 1e-10) decode of the
    same script."""
    import dataclasses

    import torch
    from covomix_tpu_torch import pipeline as P
    from covomix_tpu_torch.checkpoint.io import save_params

    save_params(os.path.join(root, "t2s_spec.npz"), params, meta={"config": dataclasses.asdict(cfg)})
    decodes = run_dialogue_cli(results, root, t2s="t2s_spec.npz", extra=["--speculative"], key="spec_dialogue")
    results.pop("spec_dialogue_vocoder_inputs")
    spec_synth, spec = decodes[-1]
    greedy_synth = dataclasses.replace(spec_synth, speculative=False, temperature=1e-10)
    with GreedyLogits() as logits:
        greedy = greedy_synth._decode(P.clean_text(DIALOGUE_SCRIPT), torch.Generator(device="cuda").manual_seed(0))
    hold_tokens("speculative per-file decode vs a greedy Synthesizer", greedy, spec, logits)
    log(f"per-file dialogue RTF with --speculative {results['spec_dialogue_rtf']:.5f} (verify rounds "
        f"{results['spec_dialogue_steps']}), phase 6 (sampling) {results['dialogue_rtf']:.5f} "
        f"(decode steps {results['dialogue_steps']})")


def run_speculative(results, root, models):
    """Phase 13 (a-d), each part's wall logged; returns the fitted (config,
    parameters)."""
    walls = {}
    t0 = time.time()
    cfg, params = fit_draft_heads(results)
    walls["fit_s"] = time.time() - t0
    for name, fn in (("decode_s", lambda: run_spec_decode(results, cfg, params)),
                     ("serving_s", lambda: run_spec_serving(results, cfg, params, models)),
                     ("per_file_s", lambda: run_spec_dialogue(results, root, cfg, params))):
        t0 = time.time()
        fn()
        walls[name] = time.time() - t0
    log(f"phase 13 walls (s): {json.dumps(walls)}")
    results["spec_walls"] = walls
    return cfg, params


# ---------------------------------------------------------------------------
# phase 14: the one-program T2S decode, captured graphs against the direct step


DECODE_TURNS = 3          # timed calls of each form, in turns (graph, direct, graph, ...)
READ_METHODS = ("__bool__", "item", "__int__", "__float__", "__index__", "tolist", "numpy")


def traced_idle_share(what, fn, untraced_s=None) -> dict:
    """fn() once under `profiling.trace`, inside a scope that ends after a
    synchronize; the scope's device idle share (1 - the union of the card's
    kernels, copies and sets over its wall), logged. Tracing slows the
    host's launches, so with `untraced_s`, the best wall of the same call
    untraced, the share of that wall the traced device work leaves idle is
    logged beside it. A trace that saw no device work fails."""
    import torch
    from covomix_tpu_torch.util import profiling

    torch.cuda.synchronize()
    with profiling.trace() as prof:
        with profiling.scope("window"):
            fn()
            torch.cuda.synchronize()
    share = profiling.device_idle_share(prof, "window")
    if untraced_s is not None:
        share.update(untraced_wall_ms=untraced_s * 1e3,
                     idle_share_of_untraced_wall=max(0.0, 1.0 - share["busy_ms"] / (untraced_s * 1e3)))
    log(f"device idle share, {what}: {json.dumps(share)}")
    if share["device_events"] == 0:
        raise AssertionError(f"{what}: the trace shows no device activity")
    return share


@contextlib.contextmanager
def host_reads():
    """Yields a list that gets one name per tensor read back to the host
    (bool / item / int / float / index / tolist / numpy) while entered."""
    import torch

    orig = {name: getattr(torch.Tensor, name) for name in READ_METHODS}
    reads = []

    def counting(name):
        def read(self, *args, **kwargs):
            reads.append(name)
            return orig[name](self, *args, **kwargs)
        return read

    for name in READ_METHODS:
        setattr(torch.Tensor, name, counting(name))
    try:
        yield reads
    finally:
        for name, fn in orig.items():
            setattr(torch.Tensor, name, fn)


@contextlib.contextmanager
def decode_form(graph: bool):
    """The graph form (text2semantic.CAPTURE, the default) or the direct
    step on the card, the yardstick the graphs are held and timed against."""
    from covomix_tpu_torch.models import text2semantic as T

    prev, T.CAPTURE = T.CAPTURE, graph
    try:
        yield
    finally:
        T.CAPTURE = prev


def decode_forms(what, fn, seed=None) -> dict:
    """fn(generator) -> GenerateResult, in both forms: the graph form's first
    call (capture included on a new shape), then DECODE_TURNS turns of
    graph, direct. Each call starts from a generator seeded `seed` (None:
    no generator) and is followed by one draw from it. Returns per form the
    last result, the walls, the host reads of the last call and the next
    draw."""
    import torch

    out = {}
    for turn in range(DECODE_TURNS + 1):
        for form in ("graph", "direct"):
            if turn == 0 and form == "direct":
                continue
            gen = None if seed is None else torch.Generator(device="cuda").manual_seed(seed)
            torch.cuda.synchronize()
            with decode_form(form == "graph"), host_reads() as reads:
                t0 = time.time()
                res = fn(gen)
                torch.cuda.synchronize()
                wall = time.time() - t0
            rec = out.setdefault(form, {"walls": []})
            if turn == 0:
                rec["first_call_s"] = wall
            else:
                rec["walls"].append(wall)
            rec.update(res=res, reads=len(reads),
                       next_draw=None if gen is None else torch.rand(8, generator=gen, device="cuda"))
    log(f"{what}: walls (s) graph {out['graph']['walls']} (first call {out['graph']['first_call_s']:.4f}), "
        f"direct {out['direct']['walls']}; steps {out['graph']['res'].num_steps} / "
        f"{out['direct']['res'].num_steps}; host reads per call {out['graph']['reads']} / {out['direct']['reads']}")
    return out


def hold_forms(what, forms, exact, redo=None):
    """The graph form's result against the direct form's: num_steps equal,
    the generator's next draw equal, tokens equal (`exact`), or, in bf16,
    equal up to the near-tie rule of hold_tokens, the margins recorded by
    `redo()` (the direct form's decode again, under GreedyLogits). Returns
    the divergences."""
    import torch

    g, d = forms["graph"], forms["direct"]
    if g["res"].num_steps != d["res"].num_steps:
        raise AssertionError(f"{what}: {g['res'].num_steps} steps captured, {d['res'].num_steps} direct")
    if g["next_draw"] is not None and not torch.equal(g["next_draw"], d["next_draw"]):
        raise AssertionError(f"{what}: the generator stands elsewhere after the captured decode")
    same = all(torch.equal(getattr(g["res"], f), getattr(d["res"], f)) for f in ("tokens", "tokens2"))
    if same:
        log(f"{what}: graph == direct (tokens, steps, next draw)")
        return []
    if exact or redo is None:
        raise AssertionError(f"{what}: the captured decode's tokens differ from the direct step's")
    with GreedyLogits() as logits:
        ref = redo()
    return hold_tokens(f"{what}: graph vs direct", ref, g["res"], logits)


def per_step_ms(forms, steps) -> dict:
    return {form: {"best_s": min(rec["walls"]), "ms_per_step": min(rec["walls"]) / steps * 1e3,
                   "host_reads": rec["reads"], **({"first_call_s": rec["first_call_s"]} if "first_call_s" in rec
                                                   else {})}
            for form, rec in forms.items()}


def run_decode_graphs(results, serving_t2s, spec_cfg, spec_params):
    """Phase 14: `generate` and `generate_speculative` as CUDA graphs against
    the same step called directly, at full width with phase 4's T2S: the
    serving shape (B=4, 512 steps, min_length 512, sampled, bf16 and f32),
    the per-file shape (B=1, 2048 steps, sampled, bf16), and greedy /
    speculative at B=8 on phase 13's fitted heads (gamma 2 / 4 / 8, bf16).
    Tokens, steps and the generator's next draw must agree (f32 exactly,
    bf16 up to hold_tokens' near-tie); walls best of DECODE_TURNS in turns,
    ms per step or round, host reads per call, each graph's capture time,
    the peak memory, and the device idle share of each decode window."""
    import numpy as np
    import torch
    from covomix_tpu_torch.models import text2semantic as T

    cfg = full_width_configs()[0]
    torch.cuda.reset_peak_memory_stats()
    text_serving = torch.as_tensor(serving_inputs(4, 400, 64, 160, 1)[0], device="cuda")
    text_file = torch.as_tensor(np.random.RandomState(2).randint(1, 30000, (1, 48)), dtype=torch.int32,
                                device="cuda")
    cells = {"serving_bf16": (text_serving, 512, 512, torch.bfloat16), "serving_f32": (text_serving, 512, 512,
                                                                                       torch.float32),
             "per_file_bf16": (text_file, 2048, 0, torch.bfloat16)}
    table, idle = {}, {}
    for name, (text, max_length, min_length, dtype) in cells.items():
        def decode(gen, text=text, max_length=max_length, min_length=min_length, dtype=dtype):
            return T.generate(serving_t2s, cfg, gen, text, max_length=max_length, min_length=min_length,
                              dtype=dtype)

        forms = decode_forms(f"decode {name}", decode, seed=10)
        ties = hold_forms(f"decode {name}", forms, exact=dtype == torch.float32,
                          redo=lambda: decode(torch.Generator(device="cuda").manual_seed(10)))
        steps = forms["graph"]["res"].num_steps
        table[name] = {"steps": steps, "ties": ties, **per_step_ms(forms, steps)}
        if name != "serving_f32":
            idle[f"{name}_graph"] = traced_idle_share(f"decode {name}, graph",
                                                      lambda: decode(torch.Generator(device="cuda").manual_seed(10)),
                                                      table[name]["graph"]["best_s"])
        if name == "serving_bf16":
            with decode_form(False):
                idle[f"{name}_direct"] = traced_idle_share(
                    f"decode {name}, direct", lambda: decode(torch.Generator(device="cuda").manual_seed(10)),
                    table[name]["direct"]["best_s"])

    text_spec = torch.as_tensor(spec_batch(np.random.RandomState(7), 8)["text_ids"], device="cuda")

    def greedy(gen):
        return T.generate(spec_params, spec_cfg, gen, text_spec, max_length=SPEC_DECODE, temperature=1e-10,
                          top_k_thres=1.0, dtype=torch.bfloat16)

    forms = {"greedy": decode_forms("greedy B=8 bf16", greedy, seed=0)}
    hold_forms("greedy B=8 bf16", forms["greedy"], exact=False,
               redo=lambda: greedy(torch.Generator(device="cuda").manual_seed(0)))
    for gamma in SPEC_GAMMAS:
        def spec(gen, gamma=gamma):
            return T.generate_speculative(spec_params, spec_cfg, text_spec, max_length=SPEC_DECODE, gamma=gamma,
                                          dtype=torch.bfloat16)

        forms[gamma] = decode_forms(f"speculative gamma {gamma} B=8 bf16", spec)
        hold_forms(f"speculative gamma {gamma} B=8 bf16", forms[gamma], exact=False,
                   redo=lambda: greedy(torch.Generator(device="cuda").manual_seed(0)))
    g = forms["greedy"]
    gsteps = g["graph"]["res"].num_steps
    tokens = float(spec_tokens(g["graph"]["res"]).mean())
    spec_row = {"greedy": {"steps": gsteps, "tokens": tokens, **per_step_ms(g, gsteps)}}
    for gamma in SPEC_GAMMAS:
        rounds = forms[gamma]["graph"]["res"].num_steps
        row = per_step_ms(forms[gamma], rounds)
        for form in ("graph", "direct"):
            row[form]["ms_per_round"] = row[form].pop("ms_per_step")
            row[form]["speedup_over_greedy"] = min(g[form]["walls"]) / row[form]["best_s"]
        spec_row[gamma] = {"rounds": rounds, **row}
    idle["greedy_b8_graph"] = traced_idle_share("greedy B=8 bf16, graph",
                                                lambda: greedy(torch.Generator(device="cuda").manual_seed(0)),
                                                spec_row["greedy"]["graph"]["best_s"])
    for form in ("graph", "direct"):
        with decode_form(form == "graph"):
            idle[f"spec_gamma4_{form}"] = traced_idle_share(
                f"speculative gamma 4, {form}",
                lambda: T.generate_speculative(spec_params, spec_cfg, text_spec, max_length=SPEC_DECODE, gamma=4,
                                               dtype=torch.bfloat16), spec_row[4][form]["best_s"])
    captures = [{"kind": key[0], "batch": key[2], "source": key[3][1], "dtype": str(key[5]), "max_length": key[6],
                 "gamma": key[7] if key[0] == "speculative" else None, "capture_s": dec.capture_s}
                for key, dec in T._GRAPHS.items()]
    memory = {"peak_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "reserved_gib": torch.cuda.memory_reserved() / 2 ** 30, "graphs_cached": len(T._GRAPHS)}
    log(f"one-program decode (steps per read {T.STEPS_PER_READ}, rounds per read {T.ROUNDS_PER_READ}): "
        + json.dumps({"decode": table, "speculative": spec_row}))
    log("decode graphs captured: " + json.dumps(captures))
    log("decode memory: " + json.dumps(memory))
    results.update(decode_graphs=table, decode_spec=spec_row, decode_idle=idle, decode_captures=captures,
                   decode_memory=memory)


# registers per thread of the dh-64 flash kernels (ptxas, CUDA 12.8), held
# to the counts of their first build: the bf16 TMA + wgmma forward's four
# forms (<dh, lse, causal>), the rotary pre-pass, the TMA + wgmma backward
# pair's three forms each (<dh, causal, tables>), the rotary transpose that
# follows a backward kernel without the fused epilogue, the f32 tiled
# forward's two forms and the f32 tiled dQ and dK/dV's two forms each
# (<dh, causal>; the tables are a run-time argument). ptxas caps the wgmma
# kernels at 168 (two blocks of 160 threads per SM) and the f32 tiled
# kernels at 255 (two blocks of 128); none may spill.
FLASH_REGS = {"flash_fwd_wgmma<Li64ELb0ELb0E>": 155, "flash_fwd_wgmma<Li64ELb1ELb0E>": 155,
              "flash_fwd_wgmma<Li64ELb0ELb1E>": 162, "flash_fwd_wgmma<Li64ELb1ELb1E>": 162,
              "flash_rotary_halfsplit_bf16<Li64E>": 48,
              "flash_bwd_dq_wgmma<Li64ELb0ELb0E>": 122, "flash_bwd_dq_wgmma<Li64ELb1ELb0E>": 124,
              "flash_bwd_dq_wgmma<Li64ELb0ELb1E>": 122,
              "flash_bwd_dkv_wgmma<Li64ELb0ELb0E>": 168, "flash_bwd_dkv_wgmma<Li64ELb1ELb0E>": 168,
              "flash_bwd_dkv_wgmma<Li64ELb0ELb1E>": 168, "flash_rotary_transpose_bf16<Li64E>": 48,
              "flash_fwd_f32_tile<Li64ELb0E>": 209, "flash_fwd_f32_tile<Li64ELb1E>": 217,
              "flash_bwd_dq_f32_tile<Li64ELb0E>": 168, "flash_bwd_dq_f32_tile<Li64ELb1E>": 168,
              "flash_bwd_dkv_f32_tile<Li64ELb0E>": 211, "flash_bwd_dkv_f32_tile<Li64ELb1E>": 215}


# The fused vocoder kernels (`<type, channel padding, tail>`, all eight the
# library instantiates): 512 threads per block cap a thread at 128
# registers, and ptxas spills beyond; none may spill. The f32 forms hold
# their conv's R x 8 accumulators (R up to 4) at that cap.
VOC_REGS = {"vocoder_fused_kernel<13__nv_bfloat16Li64ELb0E>": 124, "vocoder_fused_kernel<13__nv_bfloat16Li32ELb1E>": 123,
            "vocoder_fused_kernel<13__nv_bfloat16Li32ELb0E>": 128, "vocoder_fused_kernel<13__nv_bfloat16Li64ELb1E>": 121,
            "vocoder_fused_kernel<fLi64ELb0E>": 128, "vocoder_fused_kernel<fLi32ELb1E>": 127,
            "vocoder_fused_kernel<fLi32ELb0E>": 128, "vocoder_fused_kernel<fLi64ELb1E>": 128}


def parse_ptxas(name, build_log, regs, spills):
    """Log ptxas's registers, spills and wgmma notes per kernel of one
    library's build log into regs / spills ({kernel: count})."""
    kernel = "?"
    for line in build_log.splitlines():
        if "Compiling entry function" in line:   # the kernel's name, length-prefixed in the mangled one
            m = re.search(r"\d+((?:flash|vocoder)_[a-z_0-9]+)I(.*?)EEv", line)
            kernel = f"{m.group(1)}<{m.group(2)}>" if m else line.split("'")[1]
        elif "Used" in line or "spill" in line or "wgmma.mma_async" in line:
            log(f"  ptxas {name} {kernel}: " + line.strip().replace("ptxas info    : ", ""))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                regs[kernel] = int(m.group(1))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                spills[kernel] = int(m.group(1)) + int(m.group(2))


def parallel_builds(builds, libs):
    """Run the build callables all at once; log each library's seconds."""
    def timed(build):
        start = time.time()
        build()
        return time.time() - start

    t0 = time.time()
    with ThreadPoolExecutor(len(builds)) as pool:
        seconds = list(pool.map(timed, builds))
    log(f"built {[os.path.relpath(p, REPO) for p in libs]} in {time.time() - t0:.1f} s, each (s): "
        + ", ".join(f"{os.path.basename(p)} {t:.1f}" for p, t in zip(libs, seconds)))


def build_kernels():
    """Build every kernel library from the checkout's sources, all nvcc runs
    started together: the flash kernels for the serving / training head dim
    and the edge head dims checked below, and the fused vocoder library. Logs
    ptxas's registers, spills and wgmma notes per kernel of the dh-64 flash
    library and the vocoder library; returns ({kernel: registers},
    {kernel: spill bytes}) of those."""
    from covomix_tpu_torch.ops import flash_attention as FA, vocoder_tail as VT

    dhs = (SERVING_DH,) + EDGE_DH
    parallel_builds([lambda dh=dh: FA.KERNEL.build(dh) for dh in dhs] + [VT.LIBRARY.build],
                    [FA.KERNEL.lib_path(dh) for dh in dhs] + [VT.LIBRARY.lib_path()])
    regs, spills = {}, {}
    parse_ptxas(f"flash dh {SERVING_DH}", FA.KERNEL.build_logs.get(SERVING_DH, ""), regs, spills)
    parse_ptxas("vocoder_tail", VT.LIBRARY.build_log, regs, spills)
    return regs, spills


def check_registers(regs, spills, expected=None):
    """The kernels of `expected` ({kernel: registers}; default FLASH_REGS and
    VOC_REGS) keep their register counts, with no spills."""
    expected = expected or {**FLASH_REGS, **VOC_REGS}
    found = {k: regs.get(k) for k in expected}
    spilled = {k: spills.get(k) for k in expected}
    log(f"registers {found} (expected {expected}), spill bytes {spilled}")
    if found != expected or any(v != 0 for v in spilled.values()):
        raise AssertionError("a flash or vocoder kernel's register count changed, or it spills")


def kernel_entry(results, key, name, source, replaces, launches, with_prepass=False, **extra) -> dict:
    """One entry of the `kernels` line from results[f"{key}_*"]: `ms` back to
    back, `device_ms` behind a sleep (the same for the library call where
    there is one), and with `with_prepass` the forward's time with the rotary
    pre-pass, as the path calls it."""
    entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
             "max_abs_err": results[f"{key}_max_abs_err"], "ms": results[f"{key}_ms"],
             "plain_ms": results[f"{key}_plain_ms"], "bound_ms": results[f"{key}_bound_ms"],
             "bound_by": results[f"{key}_bound_by"], "library_ms": results.get(f"{key}_library_ms"),
             "device_ms": results[f"{key}_device_ms"],
             "library_device_ms": results.get(f"{key}_library_device_ms")}
    if with_prepass:
        entry["ms_with_prepass"] = results[f"{key}_with_prepass_ms"]
        entry["device_ms_with_prepass"] = results[f"{key}_with_prepass_device_ms"]
    return {**entry, **extra}


def plan_summary(results, key) -> dict:
    """The timed launch's block plan for the `kernels` line: tile, waves,
    shared bytes."""
    p = results[f"{key}_plan"]
    return {"tile": p["tile"], "waves": p["waves"], "smem": p["smem"]}


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "covomix_tpu_torch")):
        print("chip_smoke: covomix_tpu_torch/ not found beside this script; run from a checkout",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from covomix_tpu_torch.ops import flash_attention as FA, vocoder_tail as VT
    from covomix_tpu_torch.util.misc import round_up

    t_start = time.time()
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    regs, spills = build_kernels()
    check_registers(regs, spills)

    results = {}
    check_rotary_prepass(results)
    check_flash(results)
    check_flash_training(results)
    check_vocoder(results)
    valid_rows = run_serving(results)
    time_flash(results, "flash_serving", 8, 912, valid_rows)
    time_flash_host(results)
    time_vocoder_t512(results)
    root = os.path.join(VT.BUILD_DIR, "smoke_dialogue")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        t0 = time.time()
        write_dialogue_assets(root)
        log(f"dialogue assets (full-width checkpoints, scripts, prompts) written in {time.time() - t0:.1f} s")
        run_dialogue_cli(results, root)
        frames = results["dialogue_flow_frames"]   # the Synthesizer's shape: CFG-doubled, bucketed, scalar valid_len
        time_flash(results, "flash", 2, round_up(frames, 128), frames)
        for kind, (x, up, blocks, post) in results.pop("dialogue_vocoder_inputs").items():
            time_vocoder(results, kind, kind, x, up, blocks, post)   # the main path's own inputs
        check_small_against_cpu()
        check_small_synth_against_cpu(os.path.join(root, "prompts"))
        paths = write_torch_checkpoints(root)
        run_serve_batch_from_torch(results, root, paths)
        run_hifigan_inference(results, root, paths["vocoder"])
        spec_cfg, spec_params = run_speculative(results, root, results.pop("serving_models"))
        t0 = time.time()
        run_decode_graphs(results, results.pop("serving_t2s"), spec_cfg, spec_params)
        log(f"phase 14 wall {time.time() - t0:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    root = os.path.join(VT.BUILD_DIR, "smoke_hubert")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        run_hubert(results, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    root = os.path.join(VT.BUILD_DIR, "smoke_train")
    shutil.rmtree(root, ignore_errors=True)
    try:
        train_dir = run_training(results, root)
        split_vomix_step(results, train_dir, idle_key="train_idle")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    time_flash_training(results)
    time_flash_f32(results, "_f32", *F32_SHAPES["_f32"])
    check_small_training_against_cpu()
    root = os.path.join(VT.BUILD_DIR, "smoke_t2s")
    shutil.rmtree(root, ignore_errors=True)
    try:
        run_t2s_training(results, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    split_t2s_step(results)
    time_flash_causal(results)
    time_flash_f32(results, "_causal_f32", *F32_SHAPES["_causal_f32"])
    check_small_t2s_training_against_cpu()
    for cell in F32_CELLS:
        root = os.path.join(VT.BUILD_DIR, f"smoke_{cell}_f32")
        shutil.rmtree(root, ignore_errors=True)
        try:
            run_f32_training(results, root, cell)
        finally:
            shutil.rmtree(root, ignore_errors=True)

    launches = results["dialogue_launches"]     # this slice's main path: the per-file dialogue CLI
    # phase 13's path (speculative decode): the fit's causal kernels, the
    # speculative serving batch's and per-file run's forwards, pre-passes and
    # fused vocoder kernels
    spec_file, spec_serving, spec_fit = (results["spec_dialogue_launches"], results["spec_serving_launches"],
                                         results["spec_fit_launches"])
    flash_src, voc_src = "covomix_tpu_torch/csrc/flash_attention.cu", "covomix_tpu_torch/csrc/vocoder_tail.cu"
    kernels = [
        # the attention kernel alone; with the pre-pass, as the path calls it, in ms_with_prepass
        kernel_entry(results, "flash", "flash_attention_fwd", flash_src, "covomix_tpu/ops/flash_attention.py:162",
                     launches["flash"], with_prepass=True,
                     speculative_launches=spec_file["flash"] + spec_serving["fwd"]),
        # the rotary half of the TPU kernel's fused rotary (`if fused_rotary:` in _flash_kernel), once per call
        kernel_entry(results, "flash_rotary", "flash_rotary_halfsplit", flash_src,
                     "covomix_tpu/ops/flash_attention.py:213", launches["rotary"],
                     speculative_launches=spec_file["rotary"] + spec_serving["rotary"]),
    ]
    for kind, replaces in (("stage", "covomix_tpu/ops/vocoder_tail.py:369"),
                           ("tail", "covomix_tpu/ops/vocoder_tail.py:209")):
        kernels.append(kernel_entry(results, kind, f"vocoder_fused_{kind}", voc_src, replaces, launches[kind],
                                    unfused_ms=results[f"{kind}_unfused_ms"], plan=plan_summary(results, kind),
                                    speculative_launches=spec_file[kind]))
    replaces = {"fwd_lse": "covomix_tpu/ops/flash_attention.py:162",
                "bwd_dq": "covomix_tpu/ops/flash_attention.py:502",
                "bwd_dkv": "covomix_tpu/ops/flash_attention.py:544"}
    train = results["train_launches"]     # this slice's main path: full-width VoMix training
    for key, where in replaces.items():
        kernels.append(kernel_entry(results, key, f"flash_attention_{key}", flash_src, where, train[key],
                                    with_prepass=key == "fwd_lse",
                                    launches_per_train_step=train[key] // results["train_steps"]))
    for dt in ("f32", "bf16"):     # this slice's main path: HuBERT extraction (f32, and --bf16)
        kernels.append(kernel_entry(results, f"hubert_fwd_{dt}", f"flash_attention_fwd_hubert_{dt}", flash_src,
                                    "covomix_tpu/ops/flash_attention.py:162", results[f"hubert_{dt}"]["launches"]))
    for kind, where in (("stage", "covomix_tpu/ops/vocoder_tail.py:369"),
                        ("tail", "covomix_tpu/ops/vocoder_tail.py:209")):   # hifigan_inference --fuse_tail, f32
        kernels.append(kernel_entry(results, f"{kind}_f32", f"vocoder_fused_{kind}_f32", voc_src, where,
                                    results["hifi_launches"][kind], unfused_ms=results[f"{kind}_f32_unfused_ms"],
                                    plan=plan_summary(results, f"{kind}_f32")))
    t2s = results["t2s_launches"]     # this slice's main path: full-width CoMix T2S training
    for key, where in replaces.items():
        key = f"{key}_causal"
        kernels.append(kernel_entry(results, key, f"flash_attention_{key}", flash_src, where, t2s[key],
                                    launches_per_train_step=t2s[key] // results["t2s_steps"],
                                    speculative_launches=spec_fit[key]))
    for cell, suffix in (("vomix", "_f32"), ("t2s", "_causal_f32")):   # f32 training at the recipes' precision
        runs = results[f"{cell}_f32_launches"]
        for key, where in replaces.items():
            count = runs[f"{key}_causal" if cell == "t2s" else key]
            kernels.append(kernel_entry(results, f"{key}{suffix}", f"flash_attention_{key}{suffix}", flash_src, where,
                                        count, launches_per_train_step=count // results[f"{cell}_f32_steps"]))
    log(f"total chip_smoke time {time.time() - t_start:.1f} s")
    log("speculative decode: " + json.dumps({"bench": results["spec_bench"], "decode": results["spec_decode"],
                                              "serving_wall_s": results["spec_serving_wall_s"],
                                              "serving_stages": results["spec_serving_stages"],
                                              "per_file_rtf": results["spec_dialogue_rtf"],
                                              "fit_step_ms": results["spec_fit_step_ms"],
                                              "walls": results["spec_walls"]}))
    log("one-program decode: " + json.dumps({"decode": results["decode_graphs"], "speculative": results["decode_spec"],
                                               "idle": {**results["decode_idle"], "serving_batch": results["serving_idle"],
                                                        "vomix_bf16_step": results["train_idle"]},
                                               "captures": results["decode_captures"],
                                               "memory": results["decode_memory"]}, default=str))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


# One tree's training cells, run from the root of that tree's checkout with
# this chip_smoke.py (its path the first argument), so both trees are driven
# and gated by the same code: the dh-64 flash library, the bf16 VoMix
# training run and its step split, the bf16 CoMix T2S run and its split, the
# two f32 cells (the recipes' own precision: run and split), then the f32
# backward's device times at both training shapes; prints one "AB {json}"
# line.
AB_CELLS = """
import importlib.util, json, os, shutil, sys
sys.path.insert(0, os.getcwd())
spec = importlib.util.spec_from_file_location("chip_smoke_ab", sys.argv[1])
CS = importlib.util.module_from_spec(spec)
spec.loader.exec_module(CS)
from covomix_tpu_torch.ops import flash_attention as FA
FA.KERNEL.build(64)
root = os.path.join(os.getcwd(), "covomix_tpu_torch", "_build", "ab")
shutil.rmtree(root, ignore_errors=True)
r = {}
try:
    CS.split_vomix_step(r, CS.run_training(r, os.path.join(root, "vomix")))
    CS.run_t2s_training(r, os.path.join(root, "t2s"))
    CS.split_t2s_step(r)
    for cell in CS.F32_CELLS:
        CS.run_f32_training(r, os.path.join(root, cell + "_f32"), cell)
finally:
    shutil.rmtree(root, ignore_errors=True)
CS.f32_backward_times(r)
keys = [f"{c}_{p}_ms" for c in CS.AB_STEP_CELLS for p in ("step", "split")] + CS.AB_KERNEL_KEYS
print("AB " + json.dumps({k: r[k] for k in keys}), flush=True)
"""
AB_STEP_CELLS = ("train", "t2s", "vomix_f32", "t2s_f32")
AB_KERNEL_KEYS = [f"{name}{suffix}_{what}" for suffix in F32_SHAPES for name, what in (
    ("bwd_dq", "untabled_device_ms"), ("bwd_dkv", "untabled_device_ms"), ("backward", "device_ms"))]
AB_ORDER = ("other", "this", "this", "other") * 5   # ten pairs, each side first in half of them


def ab_training(other: str) -> int:
    """`python3 chip_smoke.py --ab-training DIR`: the training cells (VoMix and
    CoMix T2S in bf16 and in f32, AB_CELLS) of the checkout at DIR (another
    commit, unpacked with git archive) and of this one, one process per run,
    in the order AB_ORDER on one card (both trees' dh-64 libraries built
    first, in parallel; both driven by this script); logs every run's median
    step times, step splits (forward / backward / optimizer) and f32
    backward device times, then per cell and per backward time each tree's
    medians, the pairs (runs 2i and 2i + 1) this tree won, and the spread
    between the other tree's quartiles: a gain is resolved when this tree
    wins nine tenths of the pairs and the medians differ by more than that
    spread."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    trees = {"other": os.path.abspath(other), "this": REPO}
    log(card_line())
    build = ("import os, sys; sys.path.insert(0, os.getcwd()); "
             "from covomix_tpu_torch.ops import flash_attention as FA; FA.KERNEL.build(64)")
    procs = [subprocess.Popen([sys.executable, "-c", build], cwd=d) for d in trees.values()]
    if any(p.wait() for p in procs):
        raise RuntimeError("a tree's flash library did not build")
    runs = []
    for name in AB_ORDER:
        res = subprocess.run([sys.executable, "-c", AB_CELLS, os.path.abspath(__file__)], cwd=trees[name],
                             capture_output=True, text=True)
        line = [x for x in res.stdout.splitlines() if x.startswith("AB ")]
        if res.returncode != 0 or not line:
            raise RuntimeError(f"{name} tree's training cells failed:\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
        runs.append((name, json.loads(line[0][3:])))
        log(f"A/B run {len(runs)} ({name}, {trees[name]}): {runs[-1][1]}")

    def quantile(xs, f):
        xs = sorted(xs)
        i = f * (len(xs) - 1)
        return xs[int(i)] + (xs[min(int(i) + 1, len(xs) - 1)] - xs[int(i)]) * (i - int(i))

    measures = [(f"{cell} {part}", (lambda r, c=cell: r[f"{c}_step_ms"]) if part == "step" else
                 (lambda r, c=cell: r[f"{c}_split_ms"]["backward"])) for cell in AB_STEP_CELLS
                for part in ("step", "backward")]
    measures += [(key, lambda r, k=key: r[k]) for key in AB_KERNEL_KEYS]
    for what, get in measures:
        times = {n: [get(r) for m, r in runs if m == n] for n in trees}
        pairs = [dict(runs[i:i + 2]) for i in range(0, len(runs), 2)]
        wins = sum(get(p["this"]) < get(p["other"]) for p in pairs)
        med = {n: quantile(t, 0.5) for n, t in times.items()}
        spread = quantile(times["other"], 0.75) - quantile(times["other"], 0.25)
        resolved = wins >= 0.9 * len(pairs) and abs(med["this"] - med["other"]) > spread
        log(f"A/B {what} ms: median other {med['other']:.4f}, this {med['this']:.4f} "
            f"({med['this'] - med['other']:+.4f}); this tree faster in {wins} of {len(pairs)} pairs; other's "
            f"quartile spread {spread:.4f}; gain {'resolved' if resolved else 'unresolved'}")
    return 0


# ---------------------------------------------------------------------------
# python3 chip_smoke.py --vocoder: the fused vocoder kernels alone


MAIN_PATH_VOCODER = {"stage": (1, 40964, 125), "tail": (1, 163856, 62)}   # x of the per-file run's vocode
# x of hifigan_inference's 41 s file (f32; phase 11 times the kernels on the captured inputs)
HIFI_VOCODER = {"stage": (1, 42244, 125), "tail": (1, 168976, 62)}


def main_path_vocoder_inputs(kind, dtype=None):
    """Seeded random x of the stage or tail and the full-width weights of
    that stage (x, up, blocks, post): bf16 at the per-file main path's shape,
    or f32 at the 41 s hifigan_inference file's."""
    import torch

    dtype = dtype or torch.bfloat16
    shape = (MAIN_PATH_VOCODER if dtype == torch.bfloat16 else HIFI_VOCODER)[kind]
    up, blocks, post = vocoder_stage_params(500, kind == "tail", 7)
    x = torch.randn(shape, generator=torch.Generator(device="cuda").manual_seed(9), device="cuda").to(dtype)
    return x, up, blocks, post


def vocoder_mode() -> int:
    """`python3 chip_smoke.py --vocoder`: build only the fused vocoder
    library, log ptxas's registers and spills, run check_vocoder's cases,
    time both kernels at T=512 and at the per-file main path's shapes on
    seeded random inputs with full-width weights (each timed output held
    against its plain version); hold VOC_REGS last, so that a build with
    new counts still prints every timing."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from covomix_tpu_torch.ops import vocoder_tail as VT

    t_start = time.time()
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if os.path.exists(VT.LIBRARY.lib_path()):   # ptxas's counts come from the build's log: always build
        os.remove(VT.LIBRARY.lib_path())
    parallel_builds([VT.LIBRARY.build], [VT.LIBRARY.lib_path()])
    regs, spills = {}, {}
    parse_ptxas("vocoder_tail", VT.LIBRARY.build_log, regs, spills)
    results = {}
    check_vocoder(results)
    time_vocoder_t512(results)
    for kind in MAIN_PATH_VOCODER:
        time_vocoder(results, kind, kind, *main_path_vocoder_inputs(kind))
        time_vocoder(results, f"{kind}_f32", kind, *main_path_vocoder_inputs(kind, torch.float32))
    check_registers(regs, spills, VOC_REGS)
    log(f"total chip_smoke --vocoder time {time.time() - t_start:.1f} s")
    log(json.dumps({"vocoder": {k: v for k, v in results.items() if k.startswith(("stage", "tail"))}}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# python3 chip_smoke.py --flash-f32: the f32 forward at head dim 64 alone

HUBERT_FLASH_BATCH = (2, 2499, [2249, 2499])   # rows, frames, valid frames of the largest HuBERT flash batch


def flash_f32_mode() -> int:
    """`python3 chip_smoke.py --flash-f32`: build only the dh-64 flash
    library (always, since ptxas's counts come from the build log), log its
    kernels' registers and spills, run every f32 dh-64 case of check_flash,
    check_flash_training and check_flash_causal (every form of the forward,
    dQ and dK/dV, the in-kernel rotary and the backward's rotary transpose
    bit for bit, autograd), time the forward at the largest HuBERT batch's
    shape in f32 and bf16 beside SDPA (seeded inputs) and the f32 training
    kernels at both training shapes (time_flash_f32), and hold FLASH_REGS
    last, so that a build with new counts still prints every timing."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from covomix_tpu_torch.ops import flash_attention as FA

    t_start = time.time()
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    if os.path.exists(FA.KERNEL.lib_path(SERVING_DH)):
        os.remove(FA.KERNEL.lib_path(SERVING_DH))
    parallel_builds([lambda: FA.KERNEL.build(SERVING_DH)], [FA.KERNEL.lib_path(SERVING_DH)])
    regs, spills = {}, {}
    parse_ptxas(f"flash dh {SERVING_DH}", FA.KERNEL.build_logs[SERVING_DH], regs, spills)
    results = {}
    check_flash(results, f32_dh64=True)
    check_flash_training(results, f32_dh64=True)
    check_flash_causal(results, f32_dh64=True)
    b, t, valid = HUBERT_FLASH_BATCH
    for dtype, key in ((torch.float32, "hubert_fwd_f32"), (torch.bfloat16, "hubert_fwd_bf16")):
        time_flash_hubert(results, key, dtype, b, t, valid)
    for suffix, shape in F32_SHAPES.items():
        time_flash_f32(results, suffix, *shape)
    check_registers(regs, spills, FLASH_REGS)
    log(f"total chip_smoke --flash-f32 time {time.time() - t_start:.1f} s")
    log(json.dumps({"flash_f32": {k: v for k, v in results.items() if k.startswith("hubert") or k.endswith(
        tuple(f"{suffix}_{what}" for suffix in F32_SHAPES for what in ("ms", "device_ms", "bound_ms")))}}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# python3 chip_smoke.py --vocoder-split DIR: where the fused kernels' time goes


def split_sources(text: str) -> dict:
    """The fused vocoder source `text` as three variants: "full" as it is;
    "no_mrf" without the MRF (`// 3. the MRF` up to `// 4. epilogue`, and the
    weight ring's first fills in the kernel's prologue, whose copies the MRF
    would have waited for); "staging" without the MRF and the epilogue (the
    input frames and the upsample alone). The kernels' times of the three
    split each into staging + upsample / MRF / epilogue."""
    head, rest = text.split("  // 3. the MRF", 1)
    _, epilogue = rest.split("  // 4. epilogue", 1)
    _, end = epilogue.split("\n}\n\nconstexpr int kErrChannels", 1)
    before, kernel = head.split("vocoder_fused_kernel(Params<T> p) {", 1)
    prologue, body = kernel.split("  // 1. the block's input frames", 1)
    prologue = "\n".join(line for line in prologue.split("\n") if "fill_stage<" not in line)
    head = f"{before}vocoder_fused_kernel(Params<T> p) {{{prologue}  // 1. the block's input frames{body}"
    return {"full": text, "no_mrf": f"{head}  // 4. epilogue{epilogue}",
            "staging": f"{head}\n}}\n\nconstexpr int kErrChannels{end}"}


# One tree's split, run from the root of that tree's checkout with this
# file's split_sources output written into the tree's (git-ignored) build
# directory, compiled against the tree's own headers: each variant
# built into its own library (in parallel), then the stage and tail timed on
# the card alone (behind a sleep) at the per-file shapes in bf16 and the 41 s
# hifigan_inference file's in f32, seeded random inputs, full-width weights;
# prints one "SPLIT {json}" line.
SPLIT_CELL = """
import json, os, sys
from concurrent.futures import ThreadPoolExecutor
sys.path.insert(0, os.getcwd())
import torch
from covomix_tpu_torch.models import vocoder as V
from covomix_tpu_torch.ops import vocoder_tail as VT
from covomix_tpu_torch.ops.cuda_build import build_library
variants, shapes = json.loads(sys.argv[1]), json.loads(sys.argv[2])
def build(name):
    path = os.path.join(VT.BUILD_DIR, f"libvocoder_split_{name}.so")
    build_library(os.path.join(VT.BUILD_DIR, f"_split_{name}.cu"), path, ["-I" + os.path.dirname(VT.SOURCE)])
    return path
with ThreadPoolExecutor(len(variants)) as pool:
    paths = dict(zip(variants, pool.map(build, variants)))
cfg = V.VocoderConfig()
p = V.init_generator(torch.Generator(device="cuda").manual_seed(7), cfg, device="cuda")
n = len(cfg.resblock_kernel_sizes)
def time_ms(fn, iters):
    fn(); torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000); a.record()
    for _ in range(iters): fn()
    b.record(); torch.cuda.synchronize()
    return a.elapsed_time(b) / iters
out = {}
for name in variants:
    VT.LIBRARY = VT.VocoderTailLibrary()
    VT.LIBRARY.lib_path = lambda path=paths[name]: path
    for kind, dt, shape in shapes:
        i = len(cfg.upsample_rates) - (1 if kind == "tail" else 2)
        up, blocks, post = p["ups"][i], p["resblocks"][i * n:(i + 1) * n], p["conv_post"] if kind == "tail" else None
        dtype = getattr(torch, dt)
        x = torch.randn(shape, generator=torch.Generator(device="cuda").manual_seed(9), device="cuda").to(dtype)
        packed = VT.pack_weights(up, blocks, post, (3, 7, 11), ((1, 3, 5),) * 3, dtype, x.device)
        kern = VT.TAIL if kind == "tail" else VT.STAGE
        out[f"{kind}_{dt}_{name}"] = time_ms(lambda: kern(x, packed), 10 if dt == "float32" else 20)
print("SPLIT " + json.dumps(out), flush=True)
"""


def vocoder_split(other: str) -> int:
    """`python3 chip_smoke.py --vocoder-split DIR`: the fused stage and tail
    of the checkout at DIR (another commit, unpacked with git archive) and of
    this one split into staging + upsample / MRF / epilogue by timing the
    split_sources variants (one process per tree, in the order other, this,
    this, other; ms on the card alone); logs each run and each tree's means."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    trees = {"other": os.path.abspath(other), "this": REPO}
    log(card_line())
    for tree in trees.values():
        build = os.path.join(tree, "covomix_tpu_torch", "_build")
        os.makedirs(build, exist_ok=True)
        with open(os.path.join(tree, "covomix_tpu_torch", "csrc", "vocoder_tail.cu")) as f:
            for name, text in split_sources(f.read()).items():
                with open(os.path.join(build, f"_split_{name}.cu"), "w") as g:
                    g.write(text)
    shapes = [(kind, "float32", HIFI_VOCODER[kind]) for kind in HIFI_VOCODER] + [
        (kind, "bfloat16", MAIN_PATH_VOCODER[kind]) for kind in MAIN_PATH_VOCODER]
    args = [json.dumps(["full", "no_mrf", "staging"]), json.dumps(shapes)]
    runs = []
    for name in ("other", "this", "this", "other"):
        res = subprocess.run([sys.executable, "-c", SPLIT_CELL, *args], cwd=trees[name], capture_output=True,
                             text=True)
        line = [x for x in res.stdout.splitlines() if x.startswith("SPLIT ")]
        if res.returncode != 0 or not line:
            raise RuntimeError(f"{name} tree's split failed:\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
        runs.append((name, json.loads(line[0][6:])))
        log(f"split run {len(runs)} ({name}, {trees[name]}): {runs[-1][1]}")
    for name in trees:
        ms = {k: sum(r[k] for n, r in runs if n == name) / 2 for k in runs[0][1]}
        for kind, dt, _ in shapes:
            full, no_mrf, staging = (ms[f"{kind}_{dt}_{v}"] for v in ("full", "no_mrf", "staging"))
            log(f"split {name} {kind} {dt} (device ms, mean of 2 runs): total {full:.4f} = staging + upsample "
                f"{staging:.4f} + MRF {full - no_mrf:.4f} + epilogue {no_mrf - staging:.4f}")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ab-training"]:
        sys.exit(ab_training(sys.argv[2]))
    if sys.argv[1:2] == ["--vocoder"]:
        sys.exit(vocoder_mode())
    if sys.argv[1:2] == ["--flash-f32"]:
        sys.exit(flash_f32_mode())
    if sys.argv[1:2] == ["--vocoder-split"]:
        sys.exit(vocoder_split(sys.argv[2]))
    sys.exit(main())
