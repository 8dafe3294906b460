"""Serving benchmark of the port on one card: the JAX package's `bench.py`
measurement (its child process), run in PyTorch on CUDA.

    python -m covomix_tpu_torch.bench [--device cuda|cpu]

Models at the released widths with seeded random weights (RTF depends on
compute, not on weight values), bf16: CoMix T2S (dim 512, 4 + 4 layers,
decoder 1024, two streams), VoMix (`two_one`, dim 1024, depth 8) and the
HiFi-GAN generator. Prompt 400 frames, decode 512 (10.24 s a dialogue), EOS
masked for every step (`min_length` = the decode length) so that random
weights decode the whole length. For each batch size B of BENCH_SWEEP
(default 4, 16, 64; the headline is the first):

  * staged serving (`measure_pipeline`): `generate` -> `acoustic.sample`
    (16 midpoint steps x 2 field evaluations, CFG 0.7) -> `vocoder.generator`
    over the whole mel, each stage ended by a synchronize, best of the runs
    after one warm-up;
  * one-call serving (`measure_fused`): one `serving.BatchedPipeline` call
    per batch on inputs placed once (`place`, timed as `upload_s`), best of
    the runs after one warm-up. "Fused" is the JAX package's name for this
    path, whose cascade is one jitted program there; here it is one call of
    the cascade whose stages run in sequence, the T2S decode a captured CUDA
    graph. The headline `value` is its RTF, as in JAX.

Then vocoder throughput (BENCH_VOC_LOOP generator calls on the headline mel
back to back, the fused stage and tail kernels on the card; 4 calls at the
largest B), HuBERT throughput (`wav2units_batch`, BENCH_HUBERT_BATCH rows of
BENCH_HUBERT_SECONDS s), one training step of each recipe
(`train.loop.make_train_step`, bf16) and speculative decode (draft heads
fitted on a decodable pattern, greedy `generate` against
`generate_speculative`). BENCH_NO_TRAIN / BENCH_NO_SPEC skip the last two.

FLOPs are counted by formula from the shapes (the kernels are ctypes
launches that `torch.utils.flop_counter` cannot see): 2 M N K per linear and
conv, 4 dh per (query, live key) pair per head for attention. MFU is those
FLOPs over the wall over the card's dense bf16 peak (PEAK_BF16_TFLOPS, or
BENCH_CHIP_PEAK_TFLOPS); a card not in the table, and any CPU run, gives
null MFUs.

Prints one JSON line with every key the JAX bench prints, in its units,
plus the card's facts (`device`: name, count, power limit; per B
`peak_mem_gib`; `device_idle_share` of one separately traced headline call;
the timed walls run untraced) and the kernel launches of each part
(`launches`). A CPU run (`--device cpu` or BENCH_CPU) writes
"platform": "cpu" and no device metric. A part that fails raises: the
bench runs in one process and prints no result then."""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from covomix_tpu_torch import resolve_device
from covomix_tpu_torch.models import acoustic as A
from covomix_tpu_torch.models import hubert as H
from covomix_tpu_torch.models import text2semantic as T
from covomix_tpu_torch.models import vocoder as V
from covomix_tpu_torch.ops import flash_attention as FA
from covomix_tpu_torch.ops import vocoder_tail as VT
from covomix_tpu_torch.serving import BatchedPipeline
from covomix_tpu_torch.train import loop
from covomix_tpu_torch.util import profiling
from covomix_tpu_torch.util.misc import tree_leaves, tree_map

HEADLINE_UNIT = "wall_s_per_audio_s"
BASELINE_RTF = 0.05
PROMPT = 400
FRAME_S = 0.02             # one semantic token / mel frame of the flow: 20 ms
FLOW_EVALS = 32            # 16 midpoint steps x 2 field evaluations per sample
DTYPE = torch.bfloat16
# dense bf16 tensor-core peak in TFLOP/s by torch.cuda.get_device_name:
# NVIDIA's H100 SXM data sheet, at its 700 W power limit
PEAK_BF16_TFLOPS = {"NVIDIA H100 80GB HBM3": 989.0}


@dataclasses.dataclass(frozen=True)
class Settings:
    """The JAX bench's environment settings (the same names and defaults)."""
    sweep: tuple = (4, 16, 64)     # BENCH_SWEEP
    decode_len: int = 512          # BENCH_DECODE_LEN
    runs: Optional[int] = None     # BENCH_RUNS; None: 3 at the headline B, 2 at the others
    tiny: bool = False             # BENCH_TINY: plumbing-sized models, numbers meaningless
    voc_loop: int = 10             # BENCH_VOC_LOOP
    train_loop: int = 4            # BENCH_TRAIN_LOOP
    spec_fit: int = 400            # BENCH_SPEC_FIT
    spec_gamma: int = 4            # BENCH_SPEC_GAMMA
    hubert_batch: int = 8          # BENCH_HUBERT_BATCH
    hubert_seconds: int = 20       # BENCH_HUBERT_SECONDS
    hubert_loop: int = 8           # BENCH_HUBERT_LOOP
    no_train: bool = False         # BENCH_NO_TRAIN
    no_spec: bool = False          # BENCH_NO_SPEC
    peak_tflops: float = 0.0       # BENCH_CHIP_PEAK_TFLOPS; 0: PEAK_BF16_TFLOPS

    @classmethod
    def from_env(cls, env) -> "Settings":
        d = cls()
        num = lambda name, default, kind=int: kind(env[name]) if env.get(name) else default
        runs = env.get("BENCH_RUNS")
        return cls(sweep=tuple(int(x) for x in env.get("BENCH_SWEEP", "4,16,64").split(",") if x),
                   decode_len=num("BENCH_DECODE_LEN", d.decode_len), runs=int(runs) if runs else None,
                   tiny=bool(env.get("BENCH_TINY")), voc_loop=num("BENCH_VOC_LOOP", d.voc_loop),
                   train_loop=num("BENCH_TRAIN_LOOP", d.train_loop), spec_fit=num("BENCH_SPEC_FIT", d.spec_fit),
                   spec_gamma=num("BENCH_SPEC_GAMMA", d.spec_gamma),
                   hubert_batch=num("BENCH_HUBERT_BATCH", d.hubert_batch),
                   hubert_seconds=num("BENCH_HUBERT_SECONDS", d.hubert_seconds),
                   hubert_loop=num("BENCH_HUBERT_LOOP", d.hubert_loop), no_train=bool(env.get("BENCH_NO_TRAIN")),
                   no_spec=bool(env.get("BENCH_NO_SPEC")),
                   peak_tflops=num("BENCH_CHIP_PEAK_TFLOPS", d.peak_tflops, float))


def configs(tiny: bool):
    """(T2S, acoustic, vocoder) configs: the released widths
    (running_command/*.sh), or with `tiny` the JAX bench's plumbing sizes."""
    if tiny:
        return (T.T2SConfig(dim=32, source_depth=1, target_depth=1, heads=2, dim_head=16, num_text_tokens=30528,
                            num_semantic_tokens=501, target_dim=64, two_output=True),
                A.AcousticConfig(dim_in=160, dim=32, depth=2, heads=2, dim_head=16, dim_phoneme_emb=16,
                                 num_phoneme_tokens=502, mode="two_one"),
                V.VocoderConfig(upsample_initial_channel=16))
    return (T.T2SConfig(dim=512, source_depth=4, target_depth=4, heads=8, dim_head=64, num_text_tokens=30528,
                        num_semantic_tokens=501, target_dim=1024, two_output=True),
            A.AcousticConfig(dim_in=160, dim=1024, depth=8, heads=16, dim_head=64, num_phoneme_tokens=502,
                             mode="two_one"),
            V.VocoderConfig())


# ---------------------------------------------------------------------------
# FLOP counts (model FLOPs from the shapes: 2 M N K per linear or conv, 4 dh
# per (query, live key) pair per head; elementwise work is not counted)


def _linear(rows: int, d_in: int, d_out: int) -> int:
    return 2 * rows * d_in * d_out


def attention_pairs(rows: int, t: int, keys: Optional[int] = None, valid_len=None, causal: bool = False) -> int:
    """(query, live key) pairs of one attention call over `rows` rows of t
    queries against `keys` keys (default t): all keys, the first
    valid_len[r] of row r (one per row), or with `causal` the pairs j <= i."""
    keys = t if keys is None else keys
    if causal:
        return rows * t * (t + 1) // 2
    if valid_len is None:
        return rows * t * keys
    return sum(t * min(int(v), keys) for v in valid_len)


def _acoustic_flops(cfg: A.AcousticConfig, batch: int, t: int, valid_len, in_dim: int) -> int:
    d, hd, rows = cfg.dim, cfg.heads * cfg.dim_head, batch * t
    pairs = attention_pairs(batch, t, valid_len=valid_len)
    f = _linear(rows, in_dim, d)                         # to_embed (its x-share alone in the sampler)
    f += 2 * rows * cfg.conv_pos_kernel * d              # depthwise positional conv
    f += _linear(batch, d, cfg.time_hidden_dim)          # time MLP
    for i in range(cfg.depth):
        f += 4 * _linear(batch, cfg.time_hidden_dim, d)  # adaptive RMSNorm gamma / beta, twice
        f += _linear(rows, d, 3 * hd) + _linear(rows, hd, d)
        f += _linear(rows, d, cfg.ff_mult * d) + _linear(rows, cfg.ff_mult * d, d)
        if i >= cfg.depth // 2:
            f += _linear(rows, 2 * d, d)                 # U-Net skip combiner
        f += 4 * cfg.dim_head * cfg.heads * pairs
    return f + _linear(rows, d, cfg.mel_dim)


def flow_field_flops(cfg: A.AcousticConfig, batch: int, t: int, valid_len=None) -> int:
    """One field evaluation of `acoustic.forward` as the sampler calls it
    (`precomputed_embed`: the x-independent share of the input projection is
    computed once per sample and left out) on `batch` rows of t frames
    (for CFG, batch = 2B); `valid_len` one per row, None = all frames live."""
    return _acoustic_flops(cfg, batch, t, valid_len, cfg.mel_dim)


def acoustic_train_flops(cfg: A.AcousticConfig, batch: int, t: int) -> int:
    """One OT-CFM training step: 3x the forward (model FLOPs: the backward
    of each product is two products of its size), the forward with the
    whole input projection."""
    return 3 * _acoustic_flops(cfg, batch, t, None, cfg.embed_in_dim)


def vocoder_flops(cfg: V.VocoderConfig, batch: int, frames: int) -> int:
    """One HiFi-GAN generator call on `batch` mels of `frames` frames (the
    fused stage and tail compute the same convs)."""
    t, c0 = frames, cfg.upsample_initial_channel
    f = 2 * batch * t * 7 * cfg.num_mels * c0                         # conv_pre
    per_dilation = 2 if cfg.resblock == "1" else 1
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        cin, cout = c0 // 2 ** i, c0 // 2 ** (i + 1)
        f += 2 * batch * t * k * cin * cout                           # transposed conv: k taps per input frame
        t = (t - 1) * u - 2 * ((k - u) // 2) + k
        for kr, dr in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            f += per_dilation * len(dr) * 2 * batch * t * kr * cout * cout
    return f + 2 * batch * t * 7 * (c0 // 2 ** len(cfg.upsample_rates))   # conv_post


def hubert_flops(cfg: H.HubertConfig, batch: int, samples: int) -> int:
    """One `wav2units_batch` call on `batch` rows of `samples` samples (no
    padding): the conv frontend, the projection, the positional conv (its
    extra output frame for an even kernel included), `output_layer` encoder
    layers and the k-means distances."""
    t, c_in, f = samples, 1, 0
    for dim, k, s in cfg.conv_layers:
        t = (t - k) // s + 1
        f += 2 * batch * t * k * c_in * dim
        c_in = dim
    d, rows = cfg.encoder_embed_dim, batch * t
    f += _linear(rows, c_in, d)
    t_pos = t + 1 if cfg.conv_pos % 2 == 0 else t
    f += 2 * batch * t_pos * cfg.conv_pos * (d // cfg.conv_pos_groups) * d
    per_layer = 4 * _linear(rows, d, d) + _linear(rows, d, cfg.encoder_ffn_dim) + _linear(rows, cfg.encoder_ffn_dim, d)
    per_layer += 4 * (d // cfg.encoder_heads) * cfg.encoder_heads * attention_pairs(batch, t)
    return f + cfg.output_layer * per_layer + _linear(rows, d, cfg.num_units)


def t2s_forward_flops(cfg: T.T2SConfig, batch: int, text_len: int, target_len: int) -> int:
    """`text2semantic.forward_loss`'s forward on `batch` rows of `text_len`
    text ids and `target_len` targets without padding: the encoder over
    text_len + 1 positions (EOS appended), the decoder over target_len + 2
    ([BOS | targets | EOS]) with causal self-attention and cross-attention
    over the encoder's positions plus the null slot, the tied logits and,
    with `target_early_exit_layer`, the draft head(s)."""
    s, t = text_len + 1, target_len + 2
    d, dt, hd, dh = cfg.dim, cfg.target_dim, cfg.heads * cfg.dim_head, cfg.dim_head
    vocab = cfg.num_semantic_tokens + 1
    f = 0
    if not cfg.no_source_transformer:
        enc = (_linear(batch * s, d, hd) + _linear(batch * s, d, 2 * hd) + _linear(batch * s, hd, d)
               + 4 * dh * cfg.heads * attention_pairs(batch, s)
               + _linear(batch * s, d, 2 * cfg.ff_inner) + _linear(batch * s, cfg.ff_inner, d))
        f += cfg.source_depth * enc
    rows = batch * t
    dec = (_linear(rows, dt, hd) + _linear(rows, dt, 2 * hd) + _linear(rows, hd, dt)       # self-attention
           + 4 * dh * cfg.heads * attention_pairs(batch, t, causal=True)
           + _linear(rows, dt, hd) + _linear(batch * s, d, 2 * hd) + _linear(rows, hd, dt)  # cross-attention
           + 4 * dh * cfg.heads * attention_pairs(batch, t, keys=s + 1)
           + _linear(rows, dt, 2 * cfg.target_ff_inner) + _linear(rows, cfg.target_ff_inner, dt))
    f += cfg.target_depth * dec
    f += _linear(rows, dt, vocab)                     # both streams' halves together when two_output
    if cfg.target_early_exit_layer > 0:
        inner = int(dt * 4 * 2 / 3)
        heads = 2 if cfg.two_output else 1
        f += _linear(rows, dt, 2 * inner) + _linear(rows, inner, dt) + heads * _linear(rows, dt, vocab)
    return f


def t2s_train_flops(cfg: T.T2SConfig, batch: int, text_len: int, target_len: int) -> int:
    """One T2S training step: 3x `t2s_forward_flops` (model FLOPs)."""
    return 3 * t2s_forward_flops(cfg, batch, text_len, target_len)


# ---------------------------------------------------------------------------
# speculative decode's fit data and statistics


def synth_targets(cfg: T.T2SConfig, b: int, t: int) -> np.ndarray:
    """The JAX bench's decodable pattern: (7 + j) % num_semantic_tokens at
    position j < t - 16, then semantic_pad_id (the CE trains EOS there), on
    both streams: int32 [b, t, 2]."""
    j = np.arange(t)
    tgt = np.where(j < t - 16, (7 + j) % cfg.num_semantic_tokens, cfg.semantic_pad_id)
    return np.ascontiguousarray(np.broadcast_to(np.stack([tgt, tgt], -1), (b, t, 2))).astype(np.int32)


def synth_text(rs: np.random.RandomState, b: int) -> np.ndarray:
    """b texts of 24 ids in [1, 100)."""
    return rs.randint(1, 100, (b, 24)).astype(np.int32)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def spec_stats(gamma: int, greedy, greedy_wall: float, spec, spec_wall: float) -> dict:
    """The JAX bench's speculative-decode keys from a greedy and a
    speculative GenerateResult and their walls (s): decoded positions per
    row are the shorter stream's; tokens per verify round, the acceptance
    (tokens per round - 1) / gamma, tokens/s of each and their ratio.
    Unrounded (the JAX bench rounds them for its line)."""
    lens = np.minimum(_host(spec.lengths), _host(spec.lengths2)).astype(np.float64)
    rounds = float(_host(spec.num_steps))
    per_round = float(lens.mean()) / max(rounds, 1.0)
    gtok = float(np.minimum(_host(greedy.lengths), _host(greedy.lengths2)).sum())
    stok = float(lens.sum())
    return {"t2s_spec_gamma": gamma,
            "t2s_spec_tokens_per_round": per_round,
            "t2s_spec_acceptance": max(0.0, (per_round - 1.0) / gamma),
            "t2s_greedy_tok_per_s": gtok / greedy_wall if greedy_wall else None,
            "t2s_spec_tok_per_s": stok / spec_wall if spec_wall else None,
            "t2s_spec_speedup": (stok / spec_wall) / (gtok / greedy_wall) if greedy_wall and spec_wall and gtok
            else None}


# ---------------------------------------------------------------------------
# the measurement


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel."""
    k = FA.KERNEL
    return {"fwd": k.launches, "fwd_lse": k.lse_launches, "bwd_dq": k.dq_launches, "bwd_dkv": k.dkv_launches,
            "fwd_causal": k.causal_launches, "fwd_lse_causal": k.causal_lse_launches,
            "bwd_dq_causal": k.causal_dq_launches, "bwd_dkv_causal": k.causal_dkv_launches,
            "rotary": k.rotary_launches, "stage": VT.STAGE.launches, "tail": VT.TAIL.launches}


def log(msg: str):
    print(f"# {msg}", file=sys.stderr, flush=True)


class Bench:
    """One run of the measurement on `device` (None: cuda). `run()` returns
    the line; the models, the staged mels by B (`mels`) and the kernel
    launches by part (`launches`) stay on the object."""

    def __init__(self, settings: Settings, device=None):
        self.s = settings
        self.device = resolve_device(device)
        self.cuda = self.device.type == "cuda"
        self.launches = {}
        self.mels = {}
        self.placed = {}
        self.t2s_cfg, self.ac_cfg, self.voc_cfg = configs(settings.tiny)
        self.peak_tflops = None
        if self.cuda:
            self.peak_tflops = settings.peak_tflops or PEAK_BF16_TFLOPS.get(torch.cuda.get_device_name(self.device))

    def gen(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def timed(self, fn):
        """(fn(), wall s), the wall ended by a synchronize."""
        self.sync()
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        return out, time.perf_counter() - t0

    @contextlib.contextmanager
    def count(self, part: str, calls: int = 1):
        """Adds the kernel launches made inside the block, and `calls`, to
        launches[part]."""
        before = launch_counts()
        yield
        rec = self.launches.setdefault(part, {"calls": 0, **{k: 0 for k in before}})
        rec["calls"] += calls
        for k, v in launch_counts().items():
            rec[k] += v - before[k]

    def mfu(self, flops, wall_s):
        if flops is None or not self.peak_tflops or not wall_s:
            return None
        return flops / wall_s / (self.peak_tflops * 1e12)

    def check_wav(self, what, wav, b, frames):
        want = (b, V.output_length(self.voc_cfg, frames))
        if tuple(wav.shape) != want or not bool(torch.isfinite(wav).all()):
            raise AssertionError(f"{what}: wav {tuple(wav.shape)} (expected {want}), "
                                 f"finite {bool(torch.isfinite(wav).all())}")

    def inputs(self, b: int):
        """The batch's text ids [b, 64], prompt tokens [b, 400] and prompt
        mels [b, 400, dim_in] (the JAX bench's RandomState(0) / (1)
        expressions)."""
        text_ids = np.random.RandomState(2).randint(1, 30000, (b, 64)).astype(np.int32)
        prompt_tok = np.random.RandomState(0).randint(0, 500, (b, PROMPT)).astype(np.int32)
        prompt_mel = (np.random.RandomState(1).randn(b, PROMPT, self.ac_cfg.dim_in) * 0.1).astype(np.float32)
        return text_ids, prompt_tok, prompt_mel

    def build_models(self):
        t0 = time.perf_counter()
        dev = self.device
        self.pipe = BatchedPipeline(T.init(self.gen(0), self.t2s_cfg), self.t2s_cfg, A.init(self.gen(1), self.ac_cfg),
                                    self.ac_cfg, V.init_generator(self.gen(2), self.voc_cfg), self.voc_cfg,
                                    decode_len=self.s.decode_len, cond_scale=0.7, dtype=DTYPE,
                                    min_length=self.s.decode_len, device=dev)
        log(f"models built in {time.perf_counter() - t0:.2f} s")

    def staged_inputs(self, b: int):
        """The staged path's text ids [b, 64], phonemes [b, prompt + decode,
        2] and cond [b, prompt + decode, dim_in], on the device."""
        total, dev = PROMPT + self.s.decode_len, self.device
        rs = np.random.RandomState(3)
        ph = rs.randint(0, 502, (b, total, 2)).astype(np.int32)
        cond = rs.randn(b, total, self.ac_cfg.dim_in).astype(np.float32)
        return tuple(torch.as_tensor(x, device=dev) for x in (self.inputs(b)[0], ph, cond))

    @torch.no_grad()
    def measure_pipeline(self, b: int, runs: int):
        """Per-stage best walls at batch b: `generate` (max_length =
        min_length = the decode length), `sample` (CFG 0.7) over prompt +
        decode frames, the generator over the whole mel."""
        p, total, L = self.pipe, PROMPT + self.s.decode_len, self.s.decode_len
        text_ids, ph, cond = self.staged_inputs(b)

        def stages(g):
            with self.count(f"staged_t2s_b{b}"):
                gen, t_t2s = self.timed(lambda: T.generate(p.t2s_params, p.t2s_cfg, g, text_ids, max_length=L,
                                                           min_length=L, dtype=DTYPE))
            with self.count(f"staged_flow_b{b}"):
                mel, t_flow = self.timed(lambda: A.sample(p.acoustic_params, p.acoustic_cfg, g, ph, cond,
                                                          cond_scale=p.cond_scale, dtype=DTYPE))
            with self.count(f"staged_vocoder_b{b}"):
                wav, t_voc = self.timed(lambda: V.generator(p.vocoder_params, p.vocoder_cfg, mel, dtype=DTYPE))
            self.check_wav(f"staged B={b}", wav, b, total)
            return gen, mel, {"t2s": t_t2s, "flow": t_flow, "vocoder": t_voc}

        stages(self.gen(10))                                   # warm-up: captures, kernel builds
        best = {"t2s": math.inf, "flow": math.inf, "vocoder": math.inf}
        for i in range(runs):
            gen, mel, walls = stages(self.gen(100 + i))
            best = {k: min(best[k], walls[k]) for k in best}
        audio_s = b * L * FRAME_S
        rtf = sum(best.values()) / audio_s
        log(f"B={b}: best walls {best} RTF {rtf:.5f} decoded_steps={gen.num_steps}/{L}")
        self.mels[b] = mel
        return {"rtf": rtf, "t2s_wall_s": best["t2s"], "flow_wall_s": best["flow"],
                "vocoder_wall_s": best["vocoder"], "audio_s": audio_s, "decoded_steps": gen.num_steps}

    def measure_fused(self, b: int, runs: int):
        """One `BatchedPipeline` call per batch on inputs placed once; the
        upload is reported apart (a server keeps enrolled prompts on the
        card)."""
        L = self.s.decode_len
        placed, upload_s = self.timed(lambda: self.pipe.place(*self.inputs(b)))

        def call(seed):
            with self.count(f"serving_b{b}"):
                (wav, gen), wall = self.timed(lambda: self.pipe(self.gen(seed), *placed))
            self.check_wav(f"one-call B={b}", wav, b, L)
            return gen, wall

        call(10)
        best = math.inf
        for i in range(runs):
            gen, wall = call(100 + i)
            best = min(best, wall)
        rtf = best / (b * L * FRAME_S)
        log(f"B={b} one call: best wall {best:.4f} s RTF {rtf:.5f} upload {upload_s:.4f} s "
            f"decoded_steps={gen.num_steps}/{L}")
        self.placed[b] = placed
        return {"rtf_fused": rtf, "fused_wall_s": best, "upload_s": upload_s, "fused_decoded_steps": gen.num_steps}

    def idle_share(self, b: int) -> dict:
        """The device idle share of one traced one-call batch at B=b."""
        with profiling.trace() as prof, self.count(f"serving_b{b}"):
            with profiling.scope("bench_serving"):
                self.pipe(self.gen(7), *self.placed[b])
                self.sync()
        share = profiling.device_idle_share(prof, "bench_serving")
        if share["device_events"] == 0:
            raise AssertionError("the traced serving call shows no device activity")
        return share

    @torch.no_grad()
    def vocoder_throughput(self, b: int, nloop: int):
        """`nloop` generator calls on the staged mel of batch b back to back,
        then one synchronize. Returns (samples/s, s per call)."""
        mel = self.mels[b]
        p = self.pipe
        with self.count(f"vocoder_b{b}"):
            wav = V.generator(p.vocoder_params, p.vocoder_cfg, mel, dtype=DTYPE)   # warm-up
        self.check_wav(f"vocoder throughput B={b}", wav, b, mel.shape[1])
        with self.count(f"vocoder_b{b}", nloop):
            _, wall = self.timed(lambda: [V.generator(p.vocoder_params, p.vocoder_cfg, mel, dtype=DTYPE)
                                          for _ in range(nloop)])
        wall /= nloop
        return b * mel.shape[1] * self.voc_cfg.total_upsample / wall, wall

    def hubert_throughput(self):
        """BENCH_HUBERT_BATCH rows of BENCH_HUBERT_SECONDS s at 16 kHz through
        `wav2units_batch` (bf16), BENCH_HUBERT_LOOP calls back to back.
        Returns (tokens/s, audio s/s, MFU)."""
        hcfg = H.HubertConfig()
        params = H.init(self.gen(3), hcfg)
        b, seconds, nloop = self.s.hubert_batch, self.s.hubert_seconds, self.s.hubert_loop
        wav = torch.randn((b, seconds * hcfg.sample_rate), generator=self.gen(4), device=self.device)
        frames = H.num_output_frames(hcfg, wav.shape[1])
        with self.count("hubert"):
            ids = H.wav2units_batch(params, hcfg, wav, dtype=DTYPE)
        if tuple(ids.shape) != (b, frames) or int(ids.min()) < 0 or int(ids.max()) >= hcfg.num_units:
            raise AssertionError(f"HuBERT ids {tuple(ids.shape)} in [{int(ids.min())}, {int(ids.max())}]")
        with self.count("hubert", nloop):
            _, wall = self.timed(lambda: [H.wav2units_batch(params, hcfg, wav, dtype=DTYPE) for _ in range(nloop)])
        wall /= nloop
        log(f"HuBERT [{b}, {seconds} s]: {wall * 1e3:.2f} ms per batch")
        return b * frames / wall, b * seconds / wall, self.mfu(hubert_flops(hcfg, b, wav.shape[1]), wall)

    def train_throughput(self) -> dict:
        """Step walls at the recipes' shapes (bf16): VoMix B=8 x 800 frames
        (`acoustic_loss_fn`, cond-drop 0.3) and CoMix T2S B=6 x 1024
        two-stream targets, 128 text ids (`t2s_loss_fn`); one warm step,
        then BENCH_TRAIN_LOOP steps and a synchronize."""
        tcfg = loop.TrainConfig(lr=1e-4)
        nloop, tiny, dev = self.s.train_loop, self.s.tiny, self.device
        ab, at = (2, 64) if tiny else (8, 800)
        tb, tt, text_len = (2, 32, 32) if tiny else (6, 1024, 128)
        rs = np.random.RandomState(5)
        cells = (
            ("acoustic", A, self.ac_cfg, loop.acoustic_loss_fn(self.ac_cfg, cond_drop_prob=0.3, dtype=DTYPE),
             {"x": rs.randn(ab, at, 240).astype(np.float32), "phonemes": rs.randint(0, 502, (ab, at, 2)),
              "mask": np.ones((ab, at), bool)},
             acoustic_train_flops(self.ac_cfg, ab, at)),
            ("t2s", T, self.t2s_cfg, loop.t2s_loss_fn(self.t2s_cfg, dtype=DTYPE),
             {"text_ids": rs.randint(1, 30000, (tb, text_len)), "semantic_ids": rs.randint(0, 501, (tb, tt, 2))},
             t2s_train_flops(self.t2s_cfg, tb, text_len, tt)))
        out = {}
        for name, module, cfg, loss_fn, batch, flops in cells:
            batch = loop.to_device(batch, dev)
            state = loop.init_train_state(module.init(self.gen(5), cfg), tcfg)
            step = loop.make_train_step(loss_fn, tcfg)
            g = self.gen(6)
            with self.count(f"train_{name}"):
                float(step(state, batch, g)["loss"])           # warm-up
            with self.count(f"train_{name}", nloop):
                m, wall = self.timed(lambda: [step(state, batch, g) for _ in range(nloop)][-1])
            loss = float(m["loss"])
            if not math.isfinite(loss):
                raise AssertionError(f"{name} training step: loss {loss}")
            ms = wall / nloop * 1e3
            log(f"{name} training: {ms:.2f} ms per step, loss {loss:.4f}")
            out[f"{name}_train_ms_per_step"] = ms
            out[f"{name}_train_mfu"] = self.mfu(flops, ms / 1e3)
            out[f"{name}_train_tflops_per_step"] = flops / 1e12
        return out

    def spec_decode_stats(self) -> dict:
        """Speculative decode at the T2S width: the draft heads (early exit
        after decoder layer 2) fitted BENCH_SPEC_FIT steps (f32
        `forward_loss`, Adam 3e-4 with optax's defaults, B=16, T=96) on the
        decodable pattern, then greedy `generate` (temperature 1e-10,
        top_k_thres 1.0) and `generate_speculative(gamma)` on 8 texts, each
        the best of 3 after one warm call. Random weights would accept at
        the 1/vocab floor; the fitted pattern stands in for a converged
        checkpoint's draft."""
        tiny = self.s.tiny
        cfg = dataclasses.replace(self.t2s_cfg, target_early_exit_layer=1 if tiny else 2)
        fit_steps, fit_t = (8, 32) if tiny else (self.s.spec_fit, 96)
        gamma, L, dev = self.s.spec_gamma, self.s.decode_len, self.device
        params = T.init(self.gen(21), cfg)
        leaves = tree_leaves(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        opt = torch.optim.Adam(leaves, lr=3e-4, betas=(0.9, 0.999), eps=1e-8)
        rs = np.random.RandomState(100)
        tgt = torch.as_tensor(synth_targets(cfg, 16, fit_t), device=dev)
        with self.count("spec_fit", fit_steps):
            for _ in range(fit_steps):
                text = torch.as_tensor(synth_text(rs, 16), device=dev)
                loss = T.forward_loss(params, cfg, text, tgt, dtype=torch.float32)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
        loss = float(loss.detach())
        if not math.isfinite(loss):
            raise AssertionError(f"spec fit: loss {loss}")
        log(f"spec fit {fit_steps} steps, final loss {loss:.4f}")
        params = tree_map(lambda p: p.detach(), params)
        text = torch.as_tensor(synth_text(np.random.RandomState(7), 8), device=dev)

        def best_of_3(part, fn):
            with self.count(part, 4):
                r = fn()
                best = math.inf
                for _ in range(3):
                    r, wall = self.timed(fn)
                    best = min(best, wall)
            return best, r

        wg, rg = best_of_3("spec_greedy", lambda: T.generate(params, cfg, self.gen(0), text, max_length=L,
                                                              temperature=1e-10, top_k_thres=1.0, dtype=DTYPE))
        ws, rs_ = best_of_3("spec_decode", lambda: T.generate_speculative(params, cfg, text, max_length=L,
                                                                          gamma=gamma, dtype=DTYPE))
        out = spec_stats(gamma, rg, wg, rs_, ws)
        log(f"spec decode: {out}")
        return out

    def run(self) -> dict:
        s, L = self.s, self.s.decode_len
        sweep = list(s.sweep)
        headline_b = sweep[0]
        self.build_models()
        total = PROMPT + L
        scaling = {}
        for b in sweep:
            runs = s.runs if s.runs is not None else (3 if b == headline_b else 2)
            if self.cuda:
                torch.cuda.reset_peak_memory_stats(self.device)
            stats = self.measure_pipeline(b, runs)
            stats.update(self.measure_fused(b, runs))
            flops = FLOW_EVALS * flow_field_flops(self.ac_cfg, 2 * b, total)
            stats["flow_mfu"] = self.mfu(flops, stats["flow_wall_s"])
            # the one call also decodes and vocodes: the flow's FLOPs over its
            # wall bound its MFU from below
            stats["fused_mfu_lb"] = self.mfu(flops, stats["fused_wall_s"])
            if self.cuda:
                stats["peak_mem_gib"] = torch.cuda.max_memory_allocated(self.device) / 2 ** 30
            scaling[str(b)] = stats
        idle = self.idle_share(headline_b) if self.cuda else None

        flow_flops = FLOW_EVALS * flow_field_flops(self.ac_cfg, 2 * headline_b, total)
        voc_tp, voc_wall = self.vocoder_throughput(headline_b, s.voc_loop)
        big = max(sweep)
        voc_tp_big = self.vocoder_throughput(big, 4)[0] if big != headline_b else None
        hub_tok, hub_audio, hub_mfu = self.hubert_throughput()
        train = {} if s.no_train else self.train_throughput()
        spec = {} if s.no_spec else self.spec_decode_stats()

        headline = scaling[str(headline_b)]
        rtf = headline["rtf_fused"]
        out = {
            "metric": "dialogue_rtf_per_chip",
            "value": rtf,
            "unit": HEADLINE_UNIT,
            "vs_baseline": rtf / BASELINE_RTF,
            "chip": torch.cuda.get_device_name(self.device) if self.cuda else "cpu",
            "chip_peak_bf16_tflops": self.peak_tflops,
            "rtf_staged": headline["rtf"],
            "t2s_wall_s": headline["t2s_wall_s"],
            "flow_wall_s": headline["flow_wall_s"],
            "vocoder_wall_s": headline["vocoder_wall_s"],
            "t2s_decoded_steps": headline["decoded_steps"],
            "decode_len": L,
            "batch": headline_b,
            "batch_scaling": scaling,
            "vocoder_samples_per_sec_per_chip": voc_tp,
            "hubert_tokens_per_sec_per_chip": hub_tok,
            "hubert_audio_s_per_sec_per_chip": hub_audio,
            "flow_model_tflops": flow_flops / 1e12,
            "flow_mfu": self.mfu(flow_flops, headline["flow_wall_s"]),
            "vocoder_mfu": self.mfu(vocoder_flops(self.voc_cfg, headline_b, total), voc_wall),
            "hubert_mfu": hub_mfu,
        }
        if voc_tp_big is not None:
            out[f"vocoder_samples_per_sec_b{big}"] = voc_tp_big
        out.update(train)
        out.update(spec)
        if "64" in scaling:
            out["rtf_b64"] = scaling["64"]["rtf_fused"]   # 64 concurrent dialogues, one call
        out["platform"] = "gpu" if self.cuda else "cpu"
        if self.cuda:
            limits = profiling.power_limits()
            out["device"] = {"name": torch.cuda.get_device_name(self.device), "count": torch.cuda.device_count(),
                             "power_limit": limits[0].split(",")[-1].strip() if limits else None}
            out["device_idle_share"] = idle["idle_share"]
            out["device_idle_trace"] = {k: idle[k] for k in ("window_ms", "busy_ms", "device_events")}
        else:
            out["device"] = {"name": "cpu", "count": 1, "power_limit": None}
        out["launches"] = {part: {k: v for k, v in rec.items() if v} for part, rec in self.launches.items()}
        return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The port's serving benchmark: one JSON line (see the module doc).")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="cuda (the default) or cpu; BENCH_CPU=1 also selects cpu")
    args = ap.parse_args(argv)
    device = args.device or ("cpu" if os.environ.get("BENCH_CPU") else None)
    line = Bench(Settings.from_env(os.environ), device).run()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
