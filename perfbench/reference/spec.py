"""The weight trees of the three models: every leaf's name, shape and how it
is drawn, from a configuration's sizes.

A leaf is `Leaf(shape, kind, bound, zero_last_rows)`: kind "u" uniform in
+-bound, "n" normal with standard deviation `bound`, "1" ones, "0" zeros;
its last `zero_last_rows` rows zero. Linear layers
are uniform in +-1/sqrt(fan_in) (bias too), embeddings and learned vectors
standard normal, norm gains ones. Three choices keep a random model's
outputs informative for the check:
  * the adaptive RMSNorms' projections are drawn like any linear layer
    (their bias gain 1), so that the flow time reaches every layer;
  * the semantic embedding (tied to the T2S logits) has standard deviation
    0.1, so that the logits spread like a trained model's (std ~2) rather
    than ~25, where every argmax wins by hundreds; its EOS row is zero, so
    that EOS's logit stays 0, far below the top-k, and a random model never
    ends a decode early (random weights give EOS no meaning, and every seed
    then does the same work);
  * the vocoder's conv biases are drawn at a hundredth of that bound, so
    that its wave carries the mel's signal rather than a bias-driven offset
    (at the full bound the offset is 94-99 % of the wave's energy).
The null condition is zero. The tree's names and layouts are the ones the
program reads (linear `w` [in, out], conv `w` [K, C_in / groups, C_out])."""

from __future__ import annotations

import math
from typing import NamedTuple


SEM_EMB_STD = 0.1
VOCODER_BIAS_SCALE = 0.01


class Leaf(NamedTuple):
    shape: tuple
    kind: str
    bound: float = 0.0
    zero_last_rows: int = 0


def _linear(d_in: int, d_out: int, bias: bool = True):
    bound = 1.0 / math.sqrt(d_in)
    p = {"w": Leaf((d_in, d_out), "u", bound)}
    if bias:
        p["b"] = Leaf((d_out,), "u", bound)
    return p


def _conv(c_in: int, c_out: int, k: int, groups: int = 1, bias_scale: float = 1.0):
    bound = 1.0 / math.sqrt(k * c_in // groups)
    return {"w": Leaf((k, c_in // groups, c_out), "u", bound), "b": Leaf((c_out,), "u", bound * bias_scale)}


def _normal(*shape, std: float = 1.0, zero_last_rows: int = 0):
    return Leaf(tuple(shape), "n", std, zero_last_rows)


def _norm(d: int):
    return {"gamma": Leaf((d,), "1")}


def t2s(c: dict):
    """CoSingle / CoMix text-to-semantic transformer. `c`: dim, target_dim,
    source_depth, target_depth, heads, dim_head, ff_mult, num_text_tokens,
    num_semantic_tokens, two_output."""
    d, dt, inner = c["dim"], c["target_dim"], c["heads"] * c["dim_head"]
    ff, tff = int(d * c["ff_mult"] * 2 / 3), int(dt * c["ff_mult"] * 2 / 3)
    sem_dim = dt // 2 if c["two_output"] else dt

    def attn(dim, ctx=None, null=False):
        p = {"norm": _norm(dim), "q": _linear(dim, inner, False), "kv": _linear(ctx or dim, 2 * inner, False),
             "out": _linear(inner, dim, False)}
        if null:
            p["null_kv"] = _normal(2, c["heads"], 1, c["dim_head"])
        return p

    def feed(dim, hidden):
        return {"norm": _norm(dim), "w1": _linear(dim, 2 * hidden), "w2": _linear(hidden, dim)}

    return {
        "text_emb": {"w": _normal(c["num_text_tokens"] + 1, d)},
        "sem_emb": {"w": _normal(c["num_semantic_tokens"] + 1, sem_dim, std=SEM_EMB_STD, zero_last_rows=1)},
        "start_text": _normal(d),
        "start_speech": _normal(dt),
        "source_final_norm": _norm(d),
        "target_final_norm": _norm(dt),
        "source_layers": [{"self_attn": attn(d), "ff": feed(d, ff)} for _ in range(c["source_depth"])],
        "target_layers": [{"self_attn": attn(dt), "cross_attn": attn(dt, ctx=d, null=True), "ff": feed(dt, tff)}
                          for _ in range(c["target_depth"])],
    }


def acoustic_dims(c: dict):
    """(mel_dim, input projection width, phoneme streams) of a VoSingle /
    VoMix configuration."""
    mode, p = c["mode"], c["dim_phoneme_emb"]
    if mode == "two_one":
        return 80, c["dim_in"] + 80 + 2 * p, 2
    if mode == "two_two":
        return c["dim_in"], 2 * c["dim_in"] + 2 * p, 2
    return c["dim_in"], 2 * c["dim_in"] + p, 1


def acoustic(c: dict):
    """Voicebox-style flow-matching transformer (VoSingle / VoMix). `c`:
    dim_in, dim, depth, heads, dim_head, ff_mult, num_phoneme_tokens,
    dim_phoneme_emb, conv_pos_kernel, mode."""
    d, hidden = c["dim"], 4 * c["dim"]
    mel_dim, embed_in, _ = acoustic_dims(c)

    def adaptive():
        bound = 1.0 / math.sqrt(hidden)
        return {"to_gamma": {"w": Leaf((hidden, d), "u", bound), "b": Leaf((d,), "1")},
                "to_beta": {"w": Leaf((hidden, d), "u", bound), "b": Leaf((d,), "0")}}

    layers = []
    for i in range(c["depth"]):
        lp = {"attn_norm": adaptive(), "qkv": _linear(d, 3 * c["heads"] * c["dim_head"], False),
              "attn_out": _linear(c["heads"] * c["dim_head"], d, False), "ff_norm": adaptive(),
              "ff1": _linear(d, c["ff_mult"] * d), "ff2": _linear(c["ff_mult"] * d, d)}
        if i >= c["depth"] // 2:
            lp["skip"] = _linear(2 * d, d)
        layers.append(lp)
    return {
        "sinu_weights": _normal(d // 2),
        "time_mlp": _linear(d, hidden),
        "phoneme_emb": {"w": _normal(c["num_phoneme_tokens"] + 1, c["dim_phoneme_emb"])},
        "null_cond": Leaf((c["dim_in"],), "0"),
        "to_embed": _linear(embed_in, d),
        "conv_embed": _conv(d, d, c["conv_pos_kernel"], groups=d),
        "final_norm": _norm(d),
        "to_pred": _linear(d, mel_dim, False),
        "layers": layers,
    }


def vocoder(c: dict):
    """HiFi-GAN generator (ResBlock1). `c`: num_mels,
    upsample_initial_channel, upsample_rates, upsample_kernel_sizes,
    resblock_kernel_sizes, resblock_dilation_sizes."""
    c0 = c["upsample_initial_channel"]
    ups, blocks = [], []
    for i, k in enumerate(c["upsample_kernel_sizes"]):
        cin, cout = c0 // 2 ** i, c0 // 2 ** (i + 1)
        ups.append(_conv(cin, cout, k, bias_scale=VOCODER_BIAS_SCALE))
        for kr, dr in zip(c["resblock_kernel_sizes"], c["resblock_dilation_sizes"]):
            blocks.append({name: [_conv(cout, cout, kr, bias_scale=VOCODER_BIAS_SCALE) for _ in dr]
                           for name in ("convs1", "convs2")})
    return {"conv_pre": _conv(c["num_mels"], c0, 7, bias_scale=VOCODER_BIAS_SCALE), "ups": ups, "resblocks": blocks,
            "conv_post": _conv(c0 // 2 ** len(c["upsample_rates"]), 1, 7, bias_scale=VOCODER_BIAS_SCALE)}
