"""Read the reference's released PyTorch checkpoints into parameter trees
(the port's own copy of covomix_tpu/checkpoint/torch_convert.py).

Three source formats:
  1. PyTorch-Lightning `.ckpt` for acoustic / T2S models: `state_dict` under
     `cfm_wrapper.*`, `hyper_parameters`, and the EMA shadow under `ema`
     (torch_ema: `shadow_params` is a list aligned with the requires_grad
     parameters in registration order).
  2. HiFi-GAN `g_<step>` (`{'generator': sd}`) and `do_<step>`
     (`{'mpd', 'msd', ...}`), weight norm (weight_g / weight_v) folded for
     inference or kept as (v, g) for training.
  3. fairseq HuBERT `.pt` (`model` state dict) + joblib k-means `.bin`
     (sklearn KMeans `cluster_centers_`).

The trees are numpy float32 in the JAX package's layouts, so `checkpoint.io.
save_params` writes them and `params_from_numpy` carries them unchanged; the
numpy arithmetic (weight-norm folding, the spectral-norm `v` permutation) is
the JAX package's, so both give the same trees bit for bit.

Layout conventions (torch -> tree):
  Linear          [out, in]         -> w [in, out]         (transpose)
  Embedding       [V, d]            -> w [V, d]
  Conv1d          [out, in/g, k]    -> w [k, in/g, out]    (transpose 2,1,0)
  ConvTranspose1d [in, out, k]      -> w [k, in, out]      (transpose 2,0,1)
  Conv2d          [out, in, kh, kw] -> w [kh, kw, in, out] (transpose 2,3,1,0)
"""

from __future__ import annotations

import numpy as np
import torch


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().float().numpy()
    return np.asarray(t, np.float32)


def load_torch_file(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=False)


def _lin(sd, key):
    p = {"w": _np(sd[key + ".weight"]).T}
    if key + ".bias" in sd:
        p["b"] = _np(sd[key + ".bias"])
    return p


def _conv1d(sd, key, suffix=".weight"):
    p = {"w": _np(sd[key + suffix]).transpose(2, 1, 0)}
    if key + ".bias" in sd:
        p["b"] = _np(sd[key + ".bias"])
    return p


def _fold_wn(sd, key, dim: int = 0):
    """Fold torch weight_norm: w = g * v / ||v||_(dims != dim). HiFi-GAN uses
    the default dim=0; fairseq's conv positional embedding uses dim=2
    (wav2vec2.py:939 `weight_norm(pos_conv, name="weight", dim=2)`)."""
    v = _np(sd[key + ".weight_v"])
    g = _np(sd[key + ".weight_g"])
    axes = tuple(ax for ax in range(v.ndim) if ax != dim)
    norm = np.sqrt(np.sum(v * v, axis=axes, keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def _conv1d_wn(sd, key, wn_dim: int = 0):
    if key + ".weight_v" in sd:
        w = _fold_wn(sd, key, dim=wn_dim)
    else:
        w = _np(sd[key + ".weight"])
    p = {"w": w.transpose(2, 1, 0)}
    if key + ".bias" in sd:
        p["b"] = _np(sd[key + ".bias"])
    return p


def _convt1d_wn(sd, key):
    if key + ".weight_v" in sd:
        w = _fold_wn(sd, key)
    else:
        w = _np(sd[key + ".weight"])
    p = {"w": w.transpose(2, 0, 1)}
    if key + ".bias" in sd:
        p["b"] = _np(sd[key + ".bias"])
    return p


def _rms(sd, key):
    return {"gamma": _np(sd[key + ".gamma"])}


def _ln(sd, key):
    return {"gamma": _np(sd[key + ".weight"]), "beta": _np(sd[key + ".bias"])}


# ---------------------------------------------------------------------------
# EMA swap (torch_ema shadow list -> state dict)

# buffers / requires_grad=False params that torch_ema does NOT track, by
# substring (acoustic.py:116-130 rotary inv_freq buffer; rotary_embedding_torch
# freqs is a Parameter(requires_grad=False); Attend.mask is non-persistent)
_EMA_SKIP_SUBSTR = ("rotary_emb", "inv_freq", ".freqs")


def _storage_sid(v):
    """Identity key for tied-tensor detection. torch.save/load preserves storage
    sharing, so tied weights (T2S to_logits.weight is token_emb.weight,
    text2semantic.py:545-552) compare equal here."""
    ptr = getattr(v, "data_ptr", None)
    if callable(ptr):
        try:
            return (ptr(), tuple(v.shape))
        except Exception:
            pass
    return (id(v), tuple(np.shape(v)))


def apply_ema(state_dict: dict, ema_state: dict) -> dict:
    """Replace parameter tensors with the EMA shadow (torch_ema layout:
    {'decay', 'num_updates', 'shadow_params': [tensor, ...]}), matching
    ExponentialMovingAverage.copy_to at eval time (conditional_model.py:203-217).

    torch_ema tracks `[p for p in module.parameters() if p.requires_grad]`;
    `parameters()` dedupes tied tensors and excludes buffers, and its order is
    the state-dict registration order. So alignment proceeds by (1) collapsing
    state-dict keys that share storage (tied weights) to their first occurrence,
    (2) dropping known non-trained entries (rotary freqs/inv_freq), then
    (3) zipping with the shadow list; if the count still disagrees, a greedy
    shape-sequence alignment skips unrecognized buffers. Every alias of a tied
    weight receives the shadow value."""
    shadow = list(ema_state["shadow_params"])
    out = dict(state_dict)

    canon: dict = {}
    aliases: dict = {}
    order = []
    for k, v in state_dict.items():
        sid = _storage_sid(v)
        if sid in canon:
            aliases.setdefault(canon[sid], []).append(k)
        else:
            canon[sid] = k
            order.append(k)

    cand = [k for k in order if not any(s in k for s in _EMA_SKIP_SUBSTR)]

    pairs = None
    if len(cand) == len(shadow) and all(
        tuple(state_dict[k].shape) == tuple(s.shape) for k, s in zip(cand, shadow)
    ):
        pairs = list(zip(cand, shadow))
    else:
        # greedy shape-sequence alignment over unique keys in registration
        # order; keys whose shape doesn't match the next shadow are untracked
        # buffers / requires_grad=False params
        pairs = []
        si = 0
        for k in cand:
            if si < len(shadow) and tuple(state_dict[k].shape) == tuple(shadow[si].shape):
                pairs.append((k, shadow[si]))
                si += 1
        if si != len(shadow):
            raise ValueError(
                f"EMA shadow has {len(shadow)} tensors but only {si} aligned with "
                f"{len(cand)} unique trainable state-dict entries"
            )
    for k, s in pairs:
        out[k] = s
        for a in aliases.get(k, ()):
            out[a] = s
    return out


# ---------------------------------------------------------------------------
# acoustic (CoVoMix) — reference keys under cfm_wrapper.CoVoMix.*


def convert_acoustic(state_dict: dict, depth: int, prefix: str = "cfm_wrapper.CoVoMix.") -> dict:
    sd = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
    p = {
        "sinu_weights": _np(sd["sinu_pos_emb.0.weights"]),
        "time_mlp": _lin(sd, "sinu_pos_emb.1"),
        "phoneme_emb": {"w": _np(sd["to_phoneme_emb.weight"])},
        "null_cond": _np(sd["null_cond"]),
        "to_embed": _lin(sd, "to_embed"),
        "conv_embed": _conv1d(sd, "conv_embed.dw_conv1d.0"),
        "final_norm": _rms(sd, "transformer.final_norm"),
        "to_pred": _lin(sd, "to_pred"),
        "layers": [],
    }
    half = depth // 2
    for i in range(depth):
        base = f"transformer.layers.{i}."
        lp = {
            "attn_norm": {"to_gamma": _lin(sd, base + "1.to_gamma"), "to_beta": _lin(sd, base + "1.to_beta")},
            "qkv": _lin(sd, base + "2.to_qkv"),
            "attn_out": _lin(sd, base + "2.to_out"),
            "ff_norm": {"to_gamma": _lin(sd, base + "3.to_gamma"), "to_beta": _lin(sd, base + "3.to_beta")},
            "ff1": _lin(sd, base + "4.0"),
            "ff2": _lin(sd, base + "4.2"),
        }
        if i >= half:
            lp["skip"] = _lin(sd, base + "0")
        p["layers"].append(lp)
    return p


# ---------------------------------------------------------------------------
# text2semantic — reference keys under cfm_wrapper.model.*


def _t2s_self_attn(sd, base):
    return {
        "norm": _rms(sd, base + "norm"),
        "q": {"w": _np(sd[base + "to_q.0.weight"]).T},
        "kv": {"w": _np(sd[base + "to_kv.0.weight"]).T},
        "out": {"w": _np(sd[base + "to_out.weight"]).T},
    }


def _t2s_ff(sd, base):
    return {
        "norm": _rms(sd, base + "0"),
        "w1": _lin(sd, base + "1"),
        "w2": _lin(sd, base + "4"),
    }


def convert_t2s(state_dict: dict, source_depth: int, target_depth: int, prefix: str = "cfm_wrapper.model.") -> dict:
    sd = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
    p = {
        "text_emb": {"w": _np(sd["token_emb.text.weight"])},
        "sem_emb": {"w": _np(sd["token_emb.speech.weight"])},
        "start_text": _np(sd["start_token.text"]),
        "start_speech": _np(sd["start_token.speech"]),
        "target_final_norm": _rms(sd, "target_transformer.final_norm"),
    }
    if "null_source_embedding" in sd:
        p["null_source_embedding"] = _np(sd["null_source_embedding"])
    if any(k.startswith("source_transformer.layers") for k in sd):
        p["source_final_norm"] = _rms(sd, "source_transformer.final_norm")
        p["source_layers"] = [
            {
                "self_attn": _t2s_self_attn(sd, f"source_transformer.layers.{i}.0."),
                "ff": _t2s_ff(sd, f"source_transformer.layers.{i}.2."),
            }
            for i in range(source_depth)
        ]
    else:
        p["source_final_norm"] = {"gamma": np.ones_like(_np(sd["start_token.text"]))}
    p["target_layers"] = []
    for i in range(target_depth):
        base = f"target_transformer.layers.{i}."
        cross = _t2s_self_attn(sd, base + "1.")
        # null_kv torch shape [2, kv_heads, 1, dh] matches the tree's directly
        cross["null_kv"] = _np(sd[base + "1.null_kv"])
        p["target_layers"].append({
            "self_attn": _t2s_self_attn(sd, base + "0."),
            "cross_attn": cross,
            "ff": _t2s_ff(sd, base + "2."),
        })
    # early-exit speculative-decoding head: Residual(FeedForward) -> RMSNorm ->
    # Linear (text2semantic.py:603-615)
    if "to_early_exit_semantic_logits.2.weight" in sd:
        p["early_exit"] = {
            "ff": {
                "norm": _rms(sd, "to_early_exit_semantic_logits.0.fn.0"),
                "w1": _lin(sd, "to_early_exit_semantic_logits.0.fn.1"),
                "w2": _lin(sd, "to_early_exit_semantic_logits.0.fn.4"),
            },
            "norm": _rms(sd, "to_early_exit_semantic_logits.1"),
            "to_logits": {"w": _np(sd["to_early_exit_semantic_logits.2.weight"]).T},
        }
    return p


# ---------------------------------------------------------------------------
# HiFi-GAN


def _conv1d_vg(sd, key):
    """Training-form (v, g) leaf from a torch weight_norm Conv1d: keeps the
    checkpoint's exact parametrization instead of folding — resuming training
    with folded weights would be a reparametrized point (same function, but
    ||v|| rescales the weight-norm gradient geometry)."""
    p = {"v": _np(sd[key + ".weight_v"]).transpose(2, 1, 0),
         "g": _np(sd[key + ".weight_g"]).transpose(2, 1, 0)}
    if key + ".bias" in sd:
        p["b"] = _np(sd[key + ".bias"])
    return p


def _convt1d_vg(sd, key):
    """ConvTranspose1d (v, g): torch [I, O, K] with weight_norm dim=0 (per-I
    g of shape [I, 1, 1]) -> tree [K, In, Out] with g [1, In, 1]."""
    p = {"v": _np(sd[key + ".weight_v"]).transpose(2, 0, 1),
         "g": _np(sd[key + ".weight_g"]).transpose(2, 0, 1)}
    if key + ".bias" in sd:
        p["b"] = _np(sd[key + ".bias"])
    return p


def convert_hifigan_generator(state_dict: dict, num_ups: int, num_resblock_convs: int = 3,
                              num_kernels: int = 3, parametrized: bool = False) -> dict:
    """g_<step> generator state dict -> param tree. Default: weight norm
    FOLDED (inference form, remove_weight_norm semantics,
    covomix/vocoder/models.py:118-125). parametrized=True keeps torch's
    (v, g) leaves: the training form, for resuming a reference GAN run
    with identical weight-norm geometry."""
    sd = state_dict
    c1 = _conv1d_vg if parametrized else _conv1d_wn
    ct = _convt1d_vg if parametrized else _convt1d_wn
    p = {
        "conv_pre": c1(sd, "conv_pre"),
        "ups": [ct(sd, f"ups.{i}") for i in range(num_ups)],
        "resblocks": [],
        "conv_post": c1(sd, "conv_post"),
    }
    n_res = num_ups * num_kernels
    for r in range(n_res):
        if f"resblocks.{r}.convs1.0.weight_v" in sd or f"resblocks.{r}.convs1.0.weight" in sd:
            p["resblocks"].append({
                "convs1": [c1(sd, f"resblocks.{r}.convs1.{j}") for j in range(num_resblock_convs)],
                "convs2": [c1(sd, f"resblocks.{r}.convs2.{j}") for j in range(num_resblock_convs)],
            })
        else:  # ResBlock2
            p["resblocks"].append({
                "convs": [c1(sd, f"resblocks.{r}.convs.{j}") for j in range(2)],
            })
    return p


# ---------------------------------------------------------------------------
# HuBERT (fairseq .pt) + k-means


def convert_hubert(ckpt: dict, encoder_layers: int = 12, conv_layers: int = 7) -> dict:
    sd = ckpt["model"] if "model" in ckpt else ckpt
    p = {
        "conv_layers": [],
        "fe_group_norm": {"gamma": _np(sd["feature_extractor.conv_layers.0.2.weight"]),
                          "beta": _np(sd["feature_extractor.conv_layers.0.2.bias"])},
        "layer_norm": _ln(sd, "layer_norm"),
        "post_extract_proj": _lin(sd, "post_extract_proj"),
        # fairseq weight-norms pos_conv along dim=2 (wav2vec2.py:939)
        "pos_conv": _conv1d_wn(sd, "encoder.pos_conv.0", wn_dim=2),
        "encoder_layer_norm": _ln(sd, "encoder.layer_norm"),
        "layers": [],
    }
    for i in range(conv_layers):
        p["conv_layers"].append(_conv1d(sd, f"feature_extractor.conv_layers.{i}.0"))
    for i in range(encoder_layers):
        b = f"encoder.layers.{i}."
        p["layers"].append({
            "q": _lin(sd, b + "self_attn.q_proj"),
            "k": _lin(sd, b + "self_attn.k_proj"),
            "v": _lin(sd, b + "self_attn.v_proj"),
            "out": _lin(sd, b + "self_attn.out_proj"),
            "attn_ln": _ln(sd, b + "self_attn_layer_norm"),
            "fc1": _lin(sd, b + "fc1"),
            "fc2": _lin(sd, b + "fc2"),
            "final_ln": _ln(sd, b + "final_layer_norm"),
        })
    return p


def load_kmeans(path: str) -> np.ndarray:
    """joblib sklearn KMeans .bin -> [n_units, dim] centroids (dgslm k-means).
    joblib (and scikit-learn, to unpickle a KMeans) are needed only here."""
    try:
        import joblib
    except ImportError as e:
        raise ImportError(f"load_kmeans({path!r}) needs joblib (and scikit-learn for a KMeans .bin), "
                          f"which are not installed") from e

    km = joblib.load(path)
    if hasattr(km, "cluster_centers_"):
        return np.asarray(km.cluster_centers_, np.float32)
    return np.asarray(km, np.float32)


# ---------------------------------------------------------------------------
# top-level entry points


def cfg_kwargs_from_hparams(hp: dict, kind: str | None = None) -> dict:
    """Lightning hyper_parameters -> config kwargs (a plain dict, so this
    module imports no model). The one hparams -> config mapping that the
    generation CLIs and the converter use (conditional_model.py:80-136
    constructor wiring). T2S when hp['text2semantic'] is truthy, else acoustic; pass
    kind='t2s'/'acoustic' to override (callers that know the model family
    out-of-band, e.g. by CLI flag, even when hparams are sparse)."""
    if (kind == "t2s") if kind else hp.get("text2semantic", False):
        return {
            "dim": int(hp.get("CoVoMix_dim_transformer", 512)),
            "source_depth": int(hp.get("text2semantic_source_depth", 4)),
            "target_depth": int(hp.get("text2semantic_target_depth", 4)),
            "heads": int(hp.get("text2semantic_head", 8)),
            "num_text_tokens": int(hp.get("num_text_token_ids", 30528)),
            "num_semantic_tokens": int(hp.get("text2semantic_tokens", 501)),
            "target_dim": int(hp.get("target_transformer_dim")
                              or hp.get("CoVoMix_dim_transformer", 512)),
            "two_output": bool(hp.get("text2semantic_two_output", False)),
            "no_source_transformer": bool(hp.get("no_source_transformer", False)),
        }
    mode = "two_one" if hp.get("twocondition_oneoutput") else (
        "two_two" if hp.get("twocondition_twooutput") else "single")
    return {
        "dim_in": int(hp.get("CoVoMix_dim", 80)),
        "dim": int(hp.get("CoVoMix_dim_transformer", 1024)),
        "depth": int(hp.get("CoVoMix_depth", 8)),
        "heads": int(hp.get("CoVoMix_heads", 16)),
        "dim_head": int(hp.get("CoVoMix_dim_head", 64)),
        "num_phoneme_tokens": int(hp.get("CoVoMix_num_phoneme_tokens", 502)),
        "mode": mode,
    }


def convert_lightning_ckpt(path: str, *, use_ema: bool = True) -> tuple[dict, dict]:
    """PL .ckpt -> (param pytree, hyper_parameters dict). Detects acoustic vs
    T2S from the hyperparameters (conditional_model.py:97-136)."""
    ckpt = load_torch_file(path)
    hparams = dict(ckpt.get("hyper_parameters", {}))
    sd = ckpt["state_dict"]
    if use_ema and "ema" in ckpt:
        sd = apply_ema(sd, ckpt["ema"])
    if hparams.get("text2semantic", False):
        params = convert_t2s(
            sd,
            source_depth=int(hparams.get("text2semantic_source_depth", 4)),
            target_depth=int(hparams.get("text2semantic_target_depth", 4)),
        )
    else:
        params = convert_acoustic(sd, depth=int(hparams.get("CoVoMix_depth", 8)))
    return params, hparams


def _wn_leaf(sd: dict, base: str, perm: tuple) -> dict:
    """torch weight_norm conv -> our (v, g, b) leaf. torch stores weight_v
    (w-shaped) and weight_g ([O, 1, ...], dim=0 keepdims); both transpose by
    the same perm into our trailing-O layout ([1, ..., O] keepdims)."""
    return {"v": _np(sd[base + ".weight_v"]).transpose(perm),
            "g": _np(sd[base + ".weight_g"]).transpose(perm),
            "b": _np(sd[base + ".bias"])}


def _sn_leaf(sd: dict, base: str) -> dict:
    """torch (legacy util) spectral_norm Conv1d -> our (w, b, u, v) leaf.
    weight_orig [O, I/g, K] -> w [K, I/g, O]; u [O] copies; torch's v is flat
    over (i, k) (weight.reshape(O, -1) column order) while the tree's is flat over
    (k, i) (w.reshape(-1, O) row order) — permute."""
    w_t = _np(sd[base + ".weight_orig"])          # [O, I/g, K]
    o, ig, k = w_t.shape
    v_t = _np(sd[base + ".weight_v"])             # [(I/g)*K], (i, k) order
    return {"w": w_t.transpose(2, 1, 0),
            "b": _np(sd[base + ".bias"]),
            "u": _np(sd[base + ".weight_u"]),
            "v": v_t.reshape(ig, k).T.ravel()}


def convert_hifigan_discriminators(ckpt: dict) -> tuple[dict, dict]:
    """do_<step> checkpoint ({'mpd': sd, 'msd': sd, 'optim_g', 'optim_d',
    'steps', 'epoch'}, hifi-gan/train.py:179-190) -> (mpd, msd) param trees
    in the TRAINING parametrization (the JAX package's train.gan): weight_norm
    (v, g) on every MPD conv and MSD sub-discriminators 1-2, spectral-norm
    buffers (w, u, v) on MSD sub-discriminator 0, so a reference GAN run
    resumes with identical discriminator geometry (optimizer moments are not
    converted).

    Layouts: MPD Conv2d [O, I, kh, kw] -> [kh, kw, I, O]; MSD Conv1d
    [O, I/g, K] -> [K, I/g, O] (models.py:128-161, :191-232)."""
    mpd_sd, msd_sd = ckpt["mpd"], ckpt["msd"]
    p2 = (2, 3, 1, 0)
    mpd = {"discriminators": []}
    for di in range(5):
        base = f"discriminators.{di}"
        mpd["discriminators"].append({
            "convs": [_wn_leaf(mpd_sd, f"{base}.convs.{ci}", p2) for ci in range(5)],
            "conv_post": _wn_leaf(mpd_sd, f"{base}.conv_post", p2),
        })
    p1 = (2, 1, 0)
    msd = {"discriminators": []}
    for di in range(3):
        base = f"discriminators.{di}"
        leaf = (lambda b: _sn_leaf(msd_sd, b)) if di == 0 else (lambda b: _wn_leaf(msd_sd, b, p1))
        msd["discriminators"].append({
            "convs": [leaf(f"{base}.convs.{ci}") for ci in range(7)],
            "conv_post": leaf(f"{base}.conv_post"),
        })
    return mpd, msd


def convert_hifigan_ckpt(path: str, config: dict | None = None,
                         parametrized: bool = False) -> dict:
    """HiFi-GAN generator checkpoint ({'generator': sd}) -> param pytree.
    parametrized=True keeps the (v, g) training form (see
    convert_hifigan_generator)."""
    ckpt = load_torch_file(path)
    sd = ckpt["generator"] if "generator" in ckpt else ckpt
    num_ups = len((config or {}).get("upsample_rates", [5, 4, 4, 2]))
    num_kernels = len((config or {}).get("resblock_kernel_sizes", [3, 7, 11]))
    return convert_hifigan_generator(sd, num_ups=num_ups, num_kernels=num_kernels,
                                     parametrized=parametrized)


def convert_hubert_ckpt(pt_path: str, km_path: str | None = None) -> dict:
    ckpt = load_torch_file(pt_path)
    params = convert_hubert(ckpt)
    if km_path:
        params["kmeans"] = load_kmeans(km_path)
    return params
