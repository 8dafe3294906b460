#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout; needs one CUDA card

Phases (any failure exits non-zero, nothing is passed over):
  1. print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the serving path from the checkout's sources
     (nvcc, sm_90a) into covomix_tpu_torch/_build/: the flash kernel for the
     serving head dim 64 and for the edge head dims checked below, one nvcc
     per head dim, all started together;
  3. hold each kernel against its plain PyTorch version on the card, at the
     shapes the serving path gives it and at edge shapes, with stated tolerances;
  4. run batched dialogue serving at full width (CoMix T2S -> VoMix flow ->
     HiFi-GAN, bf16, B=4, prompt 400, decode 512) with random weights from a
     seed: one warm-up batch, then timed batches; the flash kernel's launch
     count over one batch must be 8 layers x 16 steps x 2 evals = 256;
  5. check a small f32 serving run on the card against the same run on the
     CPU (plain versions), with greedy decode and shared noise;
  6. print a `kernels` JSON line and, last, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
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
    results["flash_max_abs_err"] = worst


def time_flash(valid_rows, results):
    """Kernel, plain version and SDPA yardstick at the serving shape, with
    the serving run's own per-row valid lengths."""
    import torch
    import torch.nn.functional as F
    from covomix_tpu_torch.ops import flash_attention as FA

    b, h, t, dh = 8, 16, 912, 64
    q, k, v, valid_arr, tables = flash_inputs(b, h, t, dh, torch.bfloat16, 99, valid_rows, True)
    results["flash_ms"] = cuda_time_ms(lambda: FA.KERNEL(q, k, v, valid_arr, tables))
    results["flash_plain_ms"] = cuda_time_ms(lambda: FA.flash_attention_plain(q, k, v, valid_arr, tables),
                                             iters=5)
    # yardstick: one SDPA call on the pre-rotated inputs (the rotation is not timed)
    qr, kr = FA._rotary_plain(q, *tables), FA._rotary_plain(k, *tables)
    mask = None
    if int(valid_arr.min()) < t:
        mask = (torch.arange(t, device="cuda")[None, :] < valid_arr[:, None])[:, None, None, :]
    results["sdpa_ms"] = cuda_time_ms(lambda: F.scaled_dot_product_attention(qr, kr, v, attn_mask=mask))
    live = valid_arr.long().expand(b).sum().item()
    flops = 4.0 * h * dh * t * live
    nbytes = 4 * b * h * t * dh * 2 + 2 * t * dh * 2 + valid_arr.numel() * 4
    bound_flops_ms, bound_bytes_ms = flops / H100_BF16_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    results["flash_bound_ms"] = max(bound_flops_ms, bound_bytes_ms)
    results["flash_bound_by"] = "operations" if bound_flops_ms >= bound_bytes_ms else "bytes"
    log(f"flash timing [8,16,912,64] bf16 rotary, valid={valid_arr.tolist()}: kernel "
        f"{results['flash_ms']:.4f} ms, plain {results['flash_plain_ms']:.4f} ms, SDPA "
        f"{results['sdpa_ms']:.4f} ms, bound {results['flash_bound_ms']:.4f} ms "
        f"({results['flash_bound_by']}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB) "
        f"-> {flops / results['flash_ms'] / 1e9:.1f} TFLOP/s")


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
    from covomix_tpu_torch.ops import flash_attention as FA

    t_start = time.time()
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()
    dhs = (SERVING_DH,) + EDGE_DH
    with ThreadPoolExecutor(len(dhs)) as pool:
        list(pool.map(FA.KERNEL.build, dhs))
    log(f"built {[os.path.relpath(FA.KERNEL.lib_path(dh), REPO) for dh in dhs]} in {time.time() - t0:.1f} s")
    for line in FA.KERNEL.build_logs.get(SERVING_DH, "").splitlines():
        if "Used" in line or "spill" in line:
            log(f"  ptxas dh {SERVING_DH}: " + line.strip())

    results = {}
    check_flash(results)
    valid_rows = run_serving(results)
    time_flash(valid_rows, results)
    check_small_against_cpu()

    kernels = [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "covomix_tpu_torch/csrc/flash_attention.cu",
        "replaces": "covomix_tpu/ops/flash_attention.py:162",
        "launches": results["flash_launches"], "max_abs_err": results["flash_max_abs_err"],
        "ms": results["flash_ms"], "plain_ms": results["flash_plain_ms"],
        "bound_ms": results["flash_bound_ms"], "bound_by": results["flash_bound_by"],
        "library_ms": results["sdpa_ms"],
    }]
    log(f"total chip_smoke time {time.time() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
