"""Model FLOPs and kernel bytes from the shapes (the yardstick's copy of
`covomix_tpu_torch/bench.py`'s arithmetic, on the configuration files' dicts).

FLOPs: 2 M N K per linear or conv, 4 dh per (query, live key) pair per head
for attention; elementwise work is not counted. Bytes: each input read once
and each output written once."""

from __future__ import annotations

from typing import Optional

from perfbench.reference.spec import acoustic_dims


def _linear(rows: int, d_in: int, d_out: int) -> int:
    return 2 * rows * d_in * d_out


def attention_pairs(rows: int, t: int, keys: Optional[int] = None, valid_len=None, causal: bool = False) -> int:
    """(query, live key) pairs of one attention call over `rows` rows of t
    queries against `keys` keys (default t): all keys, the first valid_len[r]
    of row r, or with `causal` the pairs j <= i."""
    keys = t if keys is None else keys
    if causal:
        return rows * t * (t + 1) // 2
    if valid_len is None:
        return rows * t * keys
    return sum(t * min(int(v), keys) for v in valid_len)


def _acoustic_flops(c: dict, batch: int, t: int, valid_len, in_dim: int) -> int:
    d, hd, hidden, rows = c["dim"], c["heads"] * c["dim_head"], 4 * c["dim"], batch * t
    pairs = attention_pairs(batch, t, valid_len=valid_len)
    mel_dim = acoustic_dims(c)[0]
    f = _linear(rows, in_dim, d) + 2 * rows * c["conv_pos_kernel"] * d + _linear(batch, d, hidden)
    for i in range(c["depth"]):
        f += 4 * _linear(batch, hidden, d)
        f += _linear(rows, d, 3 * hd) + _linear(rows, hd, d)
        f += _linear(rows, d, c["ff_mult"] * d) + _linear(rows, c["ff_mult"] * d, d)
        if i >= c["depth"] // 2:
            f += _linear(rows, 2 * d, d)
        f += 4 * c["dim_head"] * c["heads"] * pairs
    return f + _linear(rows, d, mel_dim)


def flow_field_flops(c: dict, batch: int, t: int, valid_len=None) -> int:
    """One field evaluation as the sampler makes it (the x-independent share
    of the input projection computed once per sample and left out) on
    `batch` rows of t frames (CFG: 2B rows)."""
    return _acoustic_flops(c, batch, t, valid_len, acoustic_dims(c)[0])


def acoustic_train_flops(c: dict, batch: int, t: int) -> int:
    """One OT-CFM training step: 3x the forward with the whole input projection."""
    return 3 * _acoustic_flops(c, batch, t, None, acoustic_dims(c)[1])


def vocoder_stage_flops(c: dict, batch: int, frames_in: int, stage: int, post: bool = False) -> int:
    """Stage `stage` of the generator on `frames_in` input frames: the
    transposed conv (k taps per input frame) and the MRF, with `post` the
    conv_post after it."""
    c0 = c["upsample_initial_channel"]
    u, k = c["upsample_rates"][stage], c["upsample_kernel_sizes"][stage]
    cin, cout = c0 // 2 ** stage, c0 // 2 ** (stage + 1)
    f = 2 * batch * frames_in * k * cin * cout
    t = (frames_in - 1) * u - 2 * ((k - u) // 2) + k
    for kr, dr in zip(c["resblock_kernel_sizes"], c["resblock_dilation_sizes"]):
        f += 2 * len(dr) * 2 * batch * t * kr * cout * cout
    if post:
        f += 2 * batch * t * 7 * cout
    return f


def stage_frames(c: dict, frames: int, stage: int) -> int:
    """Input frames of stage `stage` for a mel of `frames` frames."""
    t = frames
    for u, k in list(zip(c["upsample_rates"], c["upsample_kernel_sizes"]))[:stage]:
        t = (t - 1) * u - 2 * ((k - u) // 2) + k
    return t


def vocoder_flops(c: dict, batch: int, frames: int) -> int:
    """One generator call on `batch` mels of `frames` frames."""
    n = len(c["upsample_rates"])
    f = 2 * batch * frames * 7 * c["num_mels"] * c["upsample_initial_channel"]
    for s in range(n):
        f += vocoder_stage_flops(c, batch, stage_frames(c, frames, s), s, post=(s == n - 1))
    return f


def t2s_forward_flops(c: dict, batch: int, text_len: int, target_len: int) -> int:
    """The teacher-forced forward on `batch` rows of `text_len` ids and
    `target_len` targets: the encoder over text_len + 1 positions, the decoder
    over target_len + 2 with causal self-attention and cross-attention over
    the encoder positions plus the null slot, the tied logits."""
    s, t = text_len + 1, target_len + 2
    d, dt, hd, dh = c["dim"], c["target_dim"], c["heads"] * c["dim_head"], c["dim_head"]
    ff, tff = int(d * c["ff_mult"] * 2 / 3), int(dt * c["ff_mult"] * 2 / 3)
    enc = (_linear(batch * s, d, hd) + _linear(batch * s, d, 2 * hd) + _linear(batch * s, hd, d)
           + 4 * dh * c["heads"] * attention_pairs(batch, s)
           + _linear(batch * s, d, 2 * ff) + _linear(batch * s, ff, d))
    rows = batch * t
    dec = (_linear(rows, dt, hd) + _linear(rows, dt, 2 * hd) + _linear(rows, hd, dt)
           + 4 * dh * c["heads"] * attention_pairs(batch, t, causal=True)
           + _linear(rows, dt, hd) + _linear(batch * s, d, 2 * hd) + _linear(rows, hd, dt)
           + 4 * dh * c["heads"] * attention_pairs(batch, t, keys=s + 1)
           + _linear(rows, dt, 2 * tff) + _linear(rows, tff, dt))
    return c["source_depth"] * enc + c["target_depth"] * dec + _linear(rows, dt, c["num_semantic_tokens"] + 1)


def t2s_train_flops(c: dict, batch: int, text_len: int, target_len: int) -> int:
    return 3 * t2s_forward_flops(c, batch, text_len, target_len)


def flash_forward(rows: int, heads: int, t: int, dh: int, valid_len=None, elem_bytes: int = 2):
    """(FLOPs, bytes) of one flash forward over [rows, heads, t, dh] with the
    keys of row r cut at valid_len[r]: q, k, v read, out written."""
    flops = 4 * dh * heads * attention_pairs(rows, t, valid_len=valid_len)
    return flops, 4 * rows * heads * t * dh * elem_bytes


def vocoder_fused(c: dict, batch: int, frames: int, elem_bytes: int = 2):
    """(FLOPs, bytes) of the fused stage (rate 4, the stage before the last)
    and the fused tail (the last stage with conv_post and tanh) on a mel of
    `frames` frames: input and output activations, the stage's weights."""
    n = len(c["upsample_rates"])
    c0 = c["upsample_initial_channel"]
    out = []
    for s, post in ((n - 2, False), (n - 1, True)):
        t_in = stage_frames(c, frames, s)
        t_out = stage_frames(c, frames, s + 1)
        cin, cout = c0 // 2 ** s, c0 // 2 ** (s + 1)
        k = c["upsample_kernel_sizes"][s]
        weights = k * cin * cout + cout
        weights += sum(2 * len(dr) * (kr * cout * cout + cout)
                       for kr, dr in zip(c["resblock_kernel_sizes"], c["resblock_dilation_sizes"]))
        if post:
            weights += 7 * cout + 1
        act = batch * t_in * cin * elem_bytes + (batch * t_out * 4 if post else batch * t_out * cout * elem_bytes)
        out.append((vocoder_stage_flops(c, batch, t_in, s, post), act + weights * elem_bytes))
    return out


def flash_backward(rows: int, heads: int, t: int, dh: int, causal: bool = False, elem_bytes: int = 2):
    """[(FLOPs, bytes) of dQ, (FLOPs, bytes) of dK/dV] of one flash backward
    over [rows, heads, t, dh]: dQ recomputes S and dP and forms dS K (6 dh
    a pair); dK/dV recomputes S and dP and forms P^T dO and dS^T Q (8 dh a
    pair). Bytes: q, k, v, dO and the f32 lse and delta read, dQ (dK and dV)
    written."""
    pairs = heads * attention_pairs(rows, t, causal=causal)
    act, stat = rows * heads * t * dh * elem_bytes, rows * heads * t * 4
    return [(6 * dh * pairs, 5 * act + 2 * stat), (8 * dh * pairs, 6 * act + 2 * stat)]
