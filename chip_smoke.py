#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout; needs one CUDA card

Phases (any failure exits non-zero, nothing is passed over):
  1. print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the ported paths from the checkout's sources
     (nvcc, sm_90a) into covomix_tpu_torch/_build/: the flash kernel for the
     serving head dim 64 and for the edge head dims checked below (one nvcc
     per head dim) and the fused vocoder stage/tail library (both dtypes),
     all started together;
  3. hold each kernel against its plain PyTorch version on the card, at the
     shapes the paths give it and at edge shapes, with stated tolerances;
  4. run batched dialogue serving at full width (CoMix T2S -> VoMix flow ->
     HiFi-GAN, bf16, B=4, prompt 400, decode 512) with random weights from a
     seed: one warm-up batch, then timed batches; the flash kernel's launch
     count over one batch must be 8 layers x 16 steps x 2 evals = 256;
  5. time the kernels at the paths' shapes beside their plain versions, and
     hold each timed output against its plain version on the same inputs;
  6. per-file generation: full-width random checkpoints written with the
     port's save_params, two dialogue scripts with 400-frame prompts, and
     `covomix_tpu_torch.dialogue_generation.main([... --mode covomix
     --fuse_tail --device cuda ...])` in-process; every vocode must launch the
     fused stage and tail once each, every flow sample the flash kernel 256
     times, and every wav be finite int16 of 160 x generated frames; the
     fused kernels are then checked and timed on the very inputs the last
     vocode gave them, and the flash kernel at the flow sample's shape;
  7. check small f32 runs on the card against the same runs on the CPU, with
     greedy decode and shared noise: batched serving (the flash kernel's
     plain version on the CPU), and the Synthesizer's covomix dialogue with
     fuse_tail and a full-width vocoder (the unfused generator on the CPU);
  8. print a `kernels` JSON line and, last, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))

H100_BF16_FLOPS = 989e12      # dense bf16 tensor-core peak (H100 SXM data sheet)
H100_BYTES_PER_S = 3.35e12    # HBM3 bandwidth (H100 SXM data sheet)
BF16_TOL = 1e-2               # |out| <~ 1: a few bf16 ulps (2^-8 at 1) of p and out rounding
F32_TOL = 1e-4                # f32: summation order and __expf vs expf only
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
DIALOGUE_SCRIPT = ("hello there, how are you doing today? [spkchange] i am fine, thank you. "
                   "[spkchange] good to hear [laughter] see you soon")


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def check_flash(results):
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


def time_flash(results, key, b, t, valid):
    """Kernel, plain version and SDPA yardstick at [b, 16, t, 64] bf16 with
    rotary and a run's own valid lengths (one per row, or one for all), into
    results[f"{key}_ms"] etc.; the kernel's output on the timed inputs is
    held against the plain version's (BF16_TOL)."""
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
    ms = results[f"{key}_ms"] = cuda_time_ms(lambda: FA.KERNEL(q, k, v, valid_arr, tables))
    results[f"{key}_plain_ms"] = cuda_time_ms(lambda: FA.flash_attention_plain(q, k, v, valid_arr, tables),
                                              iters=5)
    # yardstick: one SDPA call on the pre-rotated inputs (the rotation is not timed)
    qr, kr = FA._rotary_plain(q, *tables), FA._rotary_plain(k, *tables)
    mask = None
    if int(valid_arr.min()) < t:
        mask = (torch.arange(t, device="cuda")[None, :] < valid_arr[:, None])[:, None, None, :]
    results[f"{key}_sdpa_ms"] = cuda_time_ms(lambda: F.scaled_dot_product_attention(qr, kr, v, attn_mask=mask))
    live = valid_arr.long().expand(b).sum().item()
    flops = 4.0 * h * dh * t * live
    nbytes = 4 * b * h * t * dh * 2 + 2 * t * dh * 2 + valid_arr.numel() * 4
    bound_flops_ms, bound_bytes_ms = flops / H100_BF16_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    bound = results[f"{key}_bound_ms"] = max(bound_flops_ms, bound_bytes_ms)
    by = results[f"{key}_bound_by"] = "operations" if bound_flops_ms >= bound_bytes_ms else "bytes"
    log(f"flash timing [{b},{h},{t},{dh}] bf16 rotary, valid={valid_arr.tolist()}: kernel {ms:.4f} ms, plain "
        f"{results[f'{key}_plain_ms']:.4f} ms, SDPA {results[f'{key}_sdpa_ms']:.4f} ms, bound {bound:.4f} ms "
        f"({by}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB) -> {flops / ms / 1e9:.1f} TFLOP/s")


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
    either function, so there is no library yardstick."""
    from covomix_tpu_torch.ops import vocoder_tail as VT

    tail = kind == "tail"
    b, t, cin = x.shape
    c = up["w"].shape[2]
    packed = VT.pack_weights(up, blocks, post, (3, 7, 11), ((1, 3, 5),) * 3, x.dtype, x.device)
    kern = VT.TAIL if tail else VT.STAGE
    plain = (lambda: VT.fused_tail_plain(x, up, blocks, post)) if tail else (
        lambda: VT.fused_stage_plain(x, up, blocks))
    results[f"{key}_max_abs_err"] = vocoder_agreement(f"fused {kind} at the timed inputs", x, kern(x, packed),
                                                      plain())
    ms = results[f"{key}_ms"] = cuda_time_ms(lambda: kern(x, packed))
    results[f"{key}_plain_ms"] = cuda_time_ms(plain, iters=5)
    results[f"{key}_unfused_ms"] = cuda_time_ms(lambda: unfused_stage(x, up, blocks, post), iters=10)
    n_out = (2 if tail else 4) * b * t
    taps_up = 2 if tail else 1
    macs = n_out * (taps_up * cin * c + 126 * c * c + (7 * c if tail else 0))   # 126 = 6 convs x (3+7+11)
    w_bytes = ((4 * cin * c + 126 * c * c + (7 * c if tail else 0)) * x.element_size()
               + (19 * c + 1) * 4)
    nbytes = b * t * cin * x.element_size() + n_out * (4 if tail else c * x.element_size()) + w_bytes
    bf, bb = 2 * macs / H100_BF16_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    results[f"{key}_bound_ms"] = max(bf, bb)
    results[f"{key}_bound_by"] = "operations" if bf >= bb else "bytes"
    log(f"fused {kind} timing x{list(x.shape)} {str(x.dtype)[6:]}: kernel {ms:.4f} ms, plain "
        f"{results[f'{key}_plain_ms']:.4f} ms, unfused generator ops {results[f'{key}_unfused_ms']:.4f} ms, "
        f"bound {results[f'{key}_bound_ms']:.4f} ms ({results[f'{key}_bound_by']}: {2 * macs / 1e9:.2f} GFLOP, "
        f"{nbytes / 1e6:.2f} MB) -> {2 * macs / ms / 1e9:.1f} TFLOP/s")


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
    from covomix_tpu_torch.serving import BatchedPipeline, pack_rows, slice_generated

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
        FA.KERNEL.launches = 0
        t0 = time.time()
        wav, res = pipe(gen, *placed)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
        launches.append(FA.KERNEL.launches)
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
    results.update(flash_launches=launches[0], serving_wall_s=wall, serving_rtf=wall / audio_s)

    # stage breakdown: the same calls as BatchedPipeline.__call__, timed one by one
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
    mel = timed_stage("flow_s", lambda: A.sample(pipe.acoustic_params, ac_cfg, gen, ph, cond, cond_scale=0.7,
                                                 valid_len=pl + gl, dtype=torch.bfloat16))
    timed_stage("vocoder_s", lambda: V.generator(pipe.vocoder_params, voc_cfg, slice_generated(mel, pl, decode),
                                                 dtype=torch.bfloat16, valid_len=gl))
    log("serving stage times (s): " + json.dumps(stages))
    results["stages"] = stages
    vrows = (pl + gl).tolist()
    return vrows + vrows   # the CFG-doubled batch the flow model attends over


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


def run_dialogue_cli(results, root):
    """The dialogue CLI over the assets in `root`, full width, bf16, covomix,
    --fuse_tail. The launch counts are set to 0 just before and read just
    after; per call, flow_sample and vocode record their own launches."""
    import numpy as np
    from scipy.io import wavfile
    from covomix_tpu_torch import dialogue_generation, pipeline as P
    from covomix_tpu_torch.models import text2semantic as T
    from covomix_tpu_torch.ops import flash_attention as FA, vocoder_tail as VT

    calls = {"flow": [], "vocode": [], "steps": [], "dialogue": [], "flow_s": [], "vocode_s": []}
    orig = (P.Synthesizer.flow_sample, P.Synthesizer.vocode, P.Synthesizer.dialogue, T.generate,
            VT.fused_stage, VT.fused_tail)
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
        wav = orig[2](self, *args, **kwargs)          # numpy: the card has finished
        calls["dialogue"].append((time.time() - t0, len(wav)))
        return wav

    def generate(*args, **kwargs):
        res = orig[3](*args, **kwargs)
        calls["steps"].append(res.num_steps)
        return res

    out = os.path.join(root, "out")
    argv = ["--t2s_ckpt", os.path.join(root, "t2s.npz"), "--acous_ckpt", os.path.join(root, "acoustic.npz"),
            "--hifigan_ckpt", os.path.join(root, "vocoder.npz"), "--text_dir", os.path.join(root, "texts"),
            "--prompt_dir", os.path.join(root, "prompts"), "--saved_dir", out, "--mode", "covomix",
            "--fuse_tail", "--device", "cuda", "--allow_fallback_vocab"]
    (P.Synthesizer.flow_sample, P.Synthesizer.vocode, P.Synthesizer.dialogue, T.generate, VT.fused_stage,
     VT.fused_tail) = (flow_sample, vocode, dialogue, generate, fused_stage, fused_tail)
    FA.KERNEL.launches = VT.STAGE.launches = VT.TAIL.launches = 0
    try:
        t0 = time.time()
        dialogue_generation.main(argv)
        total = time.time() - t0
    finally:
        (P.Synthesizer.flow_sample, P.Synthesizer.vocode, P.Synthesizer.dialogue, T.generate, VT.fused_stage,
         VT.fused_tail) = orig
    launches = {"flash": FA.KERNEL.launches, "stage": VT.STAGE.launches, "tail": VT.TAIL.launches}
    log(f"dialogue CLI: {total:.2f} s for {len(calls['dialogue'])} scripts incl. loading; per script "
        f"(wall s, samples) {calls['dialogue']}; decode steps {calls['steps']}; flow (flash launches, frames) "
        f"{calls['flow']}; vocode (stage, tail launches, frames, samples) {calls['vocode']}; totals {launches}")
    n = len(calls["vocode"])
    if n == 0 or len(calls["flow"]) != n or len(calls["dialogue"]) != n:
        raise AssertionError(f"expected one flow sample and one vocode per script, got {calls}")
    for (flash, frames), (stage, tail, mel_frames, samples) in zip(calls["flow"], calls["vocode"]):
        if flash != 8 * 16 * 2 or stage != 1 or tail != 1:
            raise AssertionError(f"per call: {flash} flash launches (expected 256), {stage} stage and {tail} "
                                 f"tail launches (expected 1 each)")
        if frames < 400 or samples != 160 * mel_frames:
            raise AssertionError(f"flow over {frames} frames, vocode {mel_frames} frames -> {samples} samples")
    if launches != {"flash": 256 * n, "stage": n, "tail": n}:
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
    results.update(dialogue_launches=launches, dialogue_wall_s=wall, dialogue_audio_s=audio_s,
                   dialogue_rtf=wall / audio_s, dialogue_steps=calls["steps"][-1],
                   dialogue_flow_frames=calls["flow"][-1][1], dialogue_vocoder_inputs=inputs)
    stages = {"flow_s": calls["flow_s"][-1], "vocode_s": calls["vocode_s"][-1]}
    stages["rest_s (prompts, T2S decode)"] = wall - sum(stages.values())
    results["dialogue_stages"] = stages
    log(f"per-file dialogue, full width bf16 --fuse_tail: wall {wall:.4f} s for {audio_s:.2f} s of audio, "
        f"RTF {wall / audio_s:.5f}, T2S decode steps {calls['steps'][-1]}, stages (s) {json.dumps(stages)}")


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

    t0 = time.time()
    dhs = (SERVING_DH,) + EDGE_DH
    builds = [lambda dh=dh: FA.KERNEL.build(dh) for dh in dhs] + [VT.LIBRARY.build]
    with ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda build: build(), builds))
    libs = [FA.KERNEL.lib_path(dh) for dh in dhs] + [VT.LIBRARY.lib_path()]
    log(f"built {[os.path.relpath(p, REPO) for p in libs]} in {time.time() - t0:.1f} s")
    for name, build_log in ((f"flash dh {SERVING_DH}", FA.KERNEL.build_logs.get(SERVING_DH, "")),
                            ("vocoder_tail", VT.LIBRARY.build_log)):
        for line in build_log.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  ptxas {name}: " + line.strip())

    results = {}
    check_flash(results)
    check_vocoder(results)
    valid_rows = run_serving(results)
    time_flash(results, "flash_serving", 8, 912, valid_rows)
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
    finally:
        shutil.rmtree(root, ignore_errors=True)

    launches = results["dialogue_launches"]     # this slice's main path: the per-file dialogue CLI
    kernels = [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "covomix_tpu_torch/csrc/flash_attention.cu",
        "replaces": "covomix_tpu/ops/flash_attention.py:162",
        "launches": launches["flash"], "max_abs_err": results["flash_max_abs_err"],
        "ms": results["flash_ms"], "plain_ms": results["flash_plain_ms"],
        "bound_ms": results["flash_bound_ms"], "bound_by": results["flash_bound_by"],
        "library_ms": results["flash_sdpa_ms"],
    }]
    for kind, replaces in (("stage", "covomix_tpu/ops/vocoder_tail.py:369"),
                           ("tail", "covomix_tpu/ops/vocoder_tail.py:209")):
        kernels.append({
            "name": f"vocoder_fused_{kind}", "route": "cuda",
            "source": "covomix_tpu_torch/csrc/vocoder_tail.cu", "replaces": replaces,
            "launches": launches[kind], "max_abs_err": results[f"{kind}_max_abs_err"],
            "ms": results[f"{kind}_ms"], "plain_ms": results[f"{kind}_plain_ms"],
            "bound_ms": results[f"{kind}_bound_ms"], "bound_by": results[f"{kind}_bound_by"],
            "library_ms": None, "unfused_ms": results[f"{kind}_unfused_ms"],
        })
    log(f"total chip_smoke time {time.time() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
