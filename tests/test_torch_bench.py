"""The port's serving benchmark (`python -m covomix_tpu_torch.bench`, the JAX
package's bench.py measurement) on the CPU: one JSON line with every key the
JAX bench prints at plumbing size, nothing written, no card -> an error; the
FLOP counts against `torch.utils.flop_counter.FlopCounterMode` over the
port's plain forwards at tiny configs; the speculative fit's pattern and the
speculative-decode keys against the JAX bench's expressions."""

import builtins
import dataclasses
import json
import math
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from covomix_tpu_torch import bench as B
from covomix_tpu_torch.models import acoustic as A, hubert as H, text2semantic as T, vocoder as V
from covomix_tpu_torch.train import loop

# every key of the JAX bench's line (bench.py:632-666) at the sweep 2,3, and
# of each batch_scaling row (measure_pipeline, measure_fused, the MFUs)
JAX_KEYS = ("metric", "value", "unit", "vs_baseline", "chip", "chip_peak_bf16_tflops", "rtf_staged", "t2s_wall_s",
            "flow_wall_s", "vocoder_wall_s", "t2s_decoded_steps", "decode_len", "batch", "batch_scaling",
            "vocoder_samples_per_sec_per_chip", "hubert_tokens_per_sec_per_chip", "hubert_audio_s_per_sec_per_chip",
            "flow_model_tflops", "flow_mfu", "vocoder_mfu", "hubert_mfu", "vocoder_samples_per_sec_b3",
            "acoustic_train_ms_per_step", "acoustic_train_mfu", "acoustic_train_tflops_per_step",
            "t2s_train_ms_per_step", "t2s_train_mfu", "t2s_train_tflops_per_step", "t2s_spec_gamma",
            "t2s_spec_tokens_per_round", "t2s_spec_acceptance", "t2s_greedy_tok_per_s", "t2s_spec_tok_per_s",
            "t2s_spec_speedup")
PER_B_KEYS = ("rtf", "t2s_wall_s", "flow_wall_s", "vocoder_wall_s", "audio_s", "decoded_steps", "rtf_fused",
              "fused_wall_s", "upload_s", "flow_mfu", "fused_mfu_lb")
MFU_KEYS = ("flow_mfu", "vocoder_mfu", "hubert_mfu", "acoustic_train_mfu", "t2s_train_mfu")
TINY_ENV = {"BENCH_TINY": "1", "BENCH_SWEEP": "2,3", "BENCH_DECODE_LEN": "8", "BENCH_VOC_LOOP": "1",
            "BENCH_TRAIN_LOOP": "1", "BENCH_HUBERT_BATCH": "1", "BENCH_HUBERT_SECONDS": "1", "BENCH_HUBERT_LOOP": "1",
            "BENCH_SPEC_GAMMA": "2"}


def count_flops(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def test_settings_read_the_jax_bench_environment():
    s = B.Settings.from_env({**TINY_ENV, "BENCH_RUNS": "1", "BENCH_NO_TRAIN": "1", "BENCH_SPEC_FIT": "9",
                             "BENCH_CHIP_PEAK_TFLOPS": "500"})
    assert (s.sweep, s.decode_len, s.runs, s.tiny, s.voc_loop, s.train_loop) == ((2, 3), 8, 1, True, 1, 1)
    assert (s.hubert_batch, s.hubert_seconds, s.hubert_loop, s.spec_gamma, s.spec_fit) == (1, 1, 1, 2, 9)
    assert s.no_train and not s.no_spec and s.peak_tflops == 500.0
    assert B.Settings.from_env({}) == B.Settings()


def test_bench_cpu_line(monkeypatch, tmp_path, capsys):
    """The whole bench at plumbing size on the CPU: one JSON line on stdout
    with every JAX key, "platform": "cpu", null MFUs (a CPU run is no
    device), the whole decode at every B, and no file opened for writing."""
    writes = []
    real_open = builtins.open

    def open_(file, mode="r", *args, **kwargs):
        if any(c in mode for c in "wax+"):
            writes.append(file)
        return real_open(file, mode, *args, **kwargs)

    for name, value in TINY_ENV.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setattr(builtins, "open", open_)
    monkeypatch.chdir(tmp_path)
    assert B.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert writes == [] and list(tmp_path.iterdir()) == []
    missing = [k for k in JAX_KEYS if k not in line]
    assert not missing, missing
    assert line["platform"] == "cpu" and line["chip"] == "cpu" and line["chip_peak_bf16_tflops"] is None
    assert "device_idle_share" not in line and line["device"]["power_limit"] is None
    assert all(line[k] is None for k in MFU_KEYS)
    assert line["metric"] == "dialogue_rtf_per_chip" and line["unit"] == "wall_s_per_audio_s"
    assert line["value"] == line["batch_scaling"]["2"]["rtf_fused"] and line["batch"] == 2
    assert line["vs_baseline"] == pytest.approx(line["value"] / 0.05)
    assert line["t2s_decoded_steps"] == 8 and line["decode_len"] == 8 and "rtf_b64" not in line
    for b in ("2", "3"):
        row = line["batch_scaling"][b]
        assert all(k in row for k in PER_B_KEYS), row
        assert row["decoded_steps"] == row["fused_decoded_steps"] == 8 and "peak_mem_gib" not in row
        assert row["flow_mfu"] is None and row["fused_mfu_lb"] is None
        assert row["audio_s"] == pytest.approx(int(b) * 8 * 0.02)
        assert row["rtf"] == pytest.approx((row["t2s_wall_s"] + row["flow_wall_s"] + row["vocoder_wall_s"])
                                           / row["audio_s"])
    numbers = [v for k, v in line.items() if isinstance(v, (int, float)) and not isinstance(v, bool)]
    assert all(math.isfinite(v) for v in numbers)
    t2s, ac, voc = B.configs(True)
    assert line["flow_model_tflops"] == pytest.approx(32 * B.flow_field_flops(ac, 4, 408) / 1e12)
    assert line["t2s_spec_gamma"] == 2
    # the parts the line counts launches for (the CPU runs the plain versions: no launch)
    launches = line["launches"]
    assert launches["serving_b2"] == {"calls": 4} and launches["serving_b3"] == {"calls": 3}
    assert launches["vocoder_b2"] == {"calls": 2} and launches["vocoder_b3"] == {"calls": 1 + 4}
    assert launches["spec_fit"] == {"calls": 8} and launches["train_t2s"] == {"calls": 2}


def test_bench_raises_without_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: --device cuda would run the whole bench")
    monkeypatch.delenv("BENCH_CPU", raising=False)
    with pytest.raises(RuntimeError, match="cuda"):
        B.main(["--device", "cuda"])
    with pytest.raises(RuntimeError, match="cuda"):
        B.main([])


@pytest.mark.parametrize("valid", [None, [30, 17, 30, 9]])
def test_flow_field_flops_equal_the_counter(valid):
    """One CFG field evaluation as the sampler calls `acoustic.forward`
    (precomputed embed): the counter sees every product; the plain path
    also multiplies the masked keys (taken out by formula) and runs the
    depthwise conv as shifted elementwise multiply-adds (added back)."""
    _, cfg, _ = B.configs(True)
    b, t = 4, 30
    g = torch.Generator().manual_seed(0)
    params = A.init(g, cfg)
    x = torch.randn(b, t, cfg.mel_dim, generator=g)
    ph = torch.randint(0, 502, (b, t, 2), generator=g)
    cond = torch.randn(b, t, cfg.dim_in, generator=g)
    drop = torch.tensor([False, False, True, True])
    emb = A.static_embed(params, cfg, ph, cond, cond_drop_mask=drop)
    vl = None if valid is None else torch.tensor(valid)
    counted = count_flops(lambda: A.forward(params, cfg, x, ph, cond, torch.rand(b, generator=g),
                                            precomputed_embed=emb, valid_len=vl))
    masked = 0 if valid is None else b * t * t - sum(t * v for v in valid)
    depthwise = 2 * b * t * cfg.conv_pos_kernel * cfg.dim
    formula = B.flow_field_flops(cfg, b, t, valid)
    assert counted == formula - depthwise + 4 * cfg.dim_head * cfg.heads * cfg.depth * masked


@pytest.mark.parametrize("upsample", [16, 32])
def test_vocoder_flops_equal_the_counter(upsample):
    cfg = V.VocoderConfig(upsample_initial_channel=upsample)
    params = V.init_generator(torch.Generator().manual_seed(1), cfg)
    mel = torch.randn(2, 13, cfg.num_mels)
    assert count_flops(lambda: V.generator(params, cfg, mel)) == B.vocoder_flops(cfg, 2, 13)


def test_hubert_flops_equal_the_counter():
    cfg = H.HubertConfig(conv_layers=((16, 10, 5), (16, 3, 2), (16, 2, 2)), encoder_layers=2, encoder_embed_dim=32,
                         encoder_ffn_dim=64, encoder_heads=4, conv_pos=8, conv_pos_groups=4, output_layer=2,
                         num_units=20)
    params = H.init(torch.Generator().manual_seed(2), cfg)
    wav = torch.randn(2, 1200)
    assert count_flops(lambda: H.wav2units_batch(params, cfg, wav)) == B.hubert_flops(cfg, 2, 1200)


@pytest.mark.parametrize("early_exit", [0, 1])
def test_t2s_forward_flops_equal_the_counter(early_exit):
    """forward_loss: the plain causal path multiplies the whole [T, T]
    square, the count only the pairs j <= i (the rest taken out here)."""
    cfg = dataclasses.replace(B.configs(True)[0], target_early_exit_layer=early_exit)
    params = T.init(torch.Generator().manual_seed(3), cfg)
    b, s, tt = 2, 12, 20
    text = torch.randint(1, 30000, (b, s))
    sem = torch.randint(0, 501, (b, tt, 2))
    t = tt + 2
    above = b * (t * t - t * (t + 1) // 2)
    counted = count_flops(lambda: T.forward_loss(params, cfg, text, sem))
    assert counted == B.t2s_forward_flops(cfg, b, s, tt) + 4 * cfg.dim_head * cfg.heads * cfg.target_depth * above


def test_train_flops_against_the_counter_over_one_step():
    """A step's model FLOPs are 3x the forward's (the backward of a product
    is two products of its size). Over one tiny VoMix step the counter
    reads 95-100 % of that: the backward skips the input gradient of the
    noisy mel's share of the input projection (its input is data), and the
    plain depthwise conv is elementwise (at this width 4 % of the step); the
    T2S step has every input gradient, and the plain causal attention also
    multiplies the pairs above the diagonal. With those stated, the counts
    agree exactly."""
    t2s, ac, _ = B.configs(True)
    g = torch.Generator().manual_seed(4)
    b, t = 2, 40
    state = loop.init_train_state(A.init(g, ac), loop.TrainConfig())
    step = loop.make_train_step(loop.acoustic_loss_fn(ac, cond_drop_prob=0.3), loop.TrainConfig())
    batch = {"x": torch.randn(b, t, 240, generator=g), "phonemes": torch.randint(0, 502, (b, t, 2), generator=g),
             "mask": torch.ones(b, t, dtype=torch.bool)}
    counted = count_flops(lambda: step(state, batch, g))
    model = B.acoustic_train_flops(ac, b, t)
    assert 0.95 <= counted / model <= 1.0
    depthwise = 2 * b * t * ac.conv_pos_kernel * ac.dim
    assert counted == model - 3 * depthwise - 2 * b * t * ac.mel_dim * ac.dim

    state = loop.init_train_state(T.init(g, t2s), loop.TrainConfig())
    step = loop.make_train_step(loop.t2s_loss_fn(t2s), loop.TrainConfig())
    s, tt = 12, 20
    batch = {"text_ids": torch.randint(1, 30000, (b, s), generator=g),
             "semantic_ids": torch.randint(0, 501, (b, tt, 2), generator=g)}
    counted = count_flops(lambda: step(state, batch, g))
    dt = tt + 2
    above = 3 * 4 * t2s.dim_head * t2s.heads * t2s.target_depth * b * (dt * dt - dt * (dt + 1) // 2)
    model = B.t2s_train_flops(t2s, b, s, tt)
    assert 1.0 <= counted / model <= 1.0 + above / model
    assert counted == model + above


def test_attention_pairs():
    assert B.attention_pairs(2, 4) == 32 and B.attention_pairs(2, 4, keys=5) == 40
    assert B.attention_pairs(2, 4, causal=True) == 20
    assert B.attention_pairs(2, 4, valid_len=[4, 2]) == 24


@pytest.mark.parametrize("t", [32, 96])
def test_synth_pattern_equals_the_jax_bench(t):
    """bench.py's spec_decode_stats `synth` targets (the jnp expression as
    written there) against `synth_targets`."""
    cfg = B.configs(False)[0]
    tgt = (7 + jnp.arange(t)) % cfg.num_semantic_tokens
    tgt = jnp.where(jnp.arange(t) < t - 16, tgt, cfg.semantic_pad_id)
    tgt = jnp.broadcast_to(tgt[None, :], (16, t))
    want = np.asarray(jnp.stack([tgt, tgt], axis=-1).astype(jnp.int32))
    got = B.synth_targets(cfg, 16, t)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    text = B.synth_text(np.random.RandomState(0), 16)
    assert text.shape == (16, 24) and text.min() >= 1 and text.max() < 100


def test_spec_stats_follow_the_jax_formulas():
    """bench.py:513-525 on a hand-made pair of results, unrounded."""
    greedy = SimpleNamespace(lengths=torch.tensor([80, 81, 80]), lengths2=torch.tensor([81, 80, 80]), num_steps=81)
    spec = SimpleNamespace(lengths=np.array([80, 83, 80]), lengths2=np.array([81, 80, 79]), num_steps=25)
    out = B.spec_stats(4, greedy, 0.5, spec, 0.2)
    lens = np.minimum(np.asarray(spec.lengths), np.asarray(spec.lengths2)).astype(np.float64)
    per_round = float(lens.mean()) / max(float(spec.num_steps), 1.0)
    gtok, stok = 240.0, float(lens.sum())
    assert out == pytest.approx({"t2s_spec_gamma": 4, "t2s_spec_tokens_per_round": per_round,
                                 "t2s_spec_acceptance": max(0.0, (per_round - 1.0) / 4),
                                 "t2s_greedy_tok_per_s": gtok / 0.5, "t2s_spec_tok_per_s": stok / 0.2,
                                 "t2s_spec_speedup": (stok / 0.2) / (gtok / 0.5)})
    assert round(out["t2s_spec_tokens_per_round"], 2) == 3.19 and round(out["t2s_spec_acceptance"], 3) == 0.547
    none = B.spec_stats(4, greedy, 0.0, spec, 0.2)
    assert none["t2s_greedy_tok_per_s"] is None and none["t2s_spec_speedup"] is None
