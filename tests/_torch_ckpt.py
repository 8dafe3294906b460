"""Reference-format checkpoint files written from parameter trees: the
inverse of `checkpoint/torch_convert.py`, for the port's tests and
chip_smoke.py. torch and numpy only (chip_smoke imports it on the card).

  * `write_lightning_ckpt`: a PyTorch-Lightning `.ckpt` of a T2S or acoustic
    tree: `state_dict` under the reference's module names holding the raw
    weights (the tree + 1), `hyper_parameters` that map back to the config,
    and a torch_ema `ema` shadow holding the tree itself, so the converter
    gives the tree back only through the EMA swap. The T2S `to_logits.weight`
    is tied to `token_emb.speech.weight` (one tensor under two keys) and the
    acoustic state dict carries a rotary buffer, the two cases the swap's
    alignment must pass over.
  * `write_hifigan_ckpt`: a HiFi-GAN `g_<step>` with every conv weight-normed
    (weight_v = w, weight_g = |w| per output channel of torch's layout,
    dim 0), and the `vocoder_config.json` beside it. Folding gives w back to
    within f32 rounding, not bit for bit."""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    a = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return torch.from_numpy(np.array(a, np.float32, order="C"))   # own copy, writable


def _lin(sd, key, p):
    sd[key + ".weight"] = _t(p["w"]).T.contiguous()
    if "b" in p:
        sd[key + ".bias"] = _t(p["b"])


def _rms(sd, key, p):
    sd[key + ".gamma"] = _t(p["gamma"])


def acoustic_state_dict(tree) -> dict:
    """Acoustic tree -> state dict under `cfm_wrapper.CoVoMix.` (with a rotary
    buffer that the EMA shadow does not track)."""
    sd = {"sinu_pos_emb.0.weights": _t(tree["sinu_weights"])}
    _lin(sd, "sinu_pos_emb.1", tree["time_mlp"])
    sd["to_phoneme_emb.weight"] = _t(tree["phoneme_emb"]["w"])
    sd["null_cond"] = _t(tree["null_cond"])
    _lin(sd, "to_embed", tree["to_embed"])
    sd["conv_embed.dw_conv1d.0.weight"] = _t(tree["conv_embed"]["w"]).permute(2, 1, 0).contiguous()
    sd["conv_embed.dw_conv1d.0.bias"] = _t(tree["conv_embed"]["b"])
    sd["transformer.rotary_emb.inv_freq"] = torch.linspace(1.0, 1e-3, 8)
    for i, lp in enumerate(tree["layers"]):
        base = f"transformer.layers.{i}."
        if "skip" in lp:
            _lin(sd, base + "0", lp["skip"])
        _lin(sd, base + "1.to_gamma", lp["attn_norm"]["to_gamma"])
        _lin(sd, base + "1.to_beta", lp["attn_norm"]["to_beta"])
        _lin(sd, base + "2.to_qkv", lp["qkv"])
        _lin(sd, base + "2.to_out", lp["attn_out"])
        _lin(sd, base + "3.to_gamma", lp["ff_norm"]["to_gamma"])
        _lin(sd, base + "3.to_beta", lp["ff_norm"]["to_beta"])
        _lin(sd, base + "4.0", lp["ff1"])
        _lin(sd, base + "4.2", lp["ff2"])
    _rms(sd, "transformer.final_norm", tree["final_norm"])
    _lin(sd, "to_pred", tree["to_pred"])
    return {"cfm_wrapper.CoVoMix." + k: v for k, v in sd.items()}


def _attn(sd, base, p):
    _rms(sd, base + "norm", p["norm"])
    sd[base + "to_q.0.weight"] = _t(p["q"]["w"]).T.contiguous()
    sd[base + "to_kv.0.weight"] = _t(p["kv"]["w"]).T.contiguous()
    sd[base + "to_out.weight"] = _t(p["out"]["w"]).T.contiguous()
    if "null_kv" in p:
        sd[base + "null_kv"] = _t(p["null_kv"])


def _ff(sd, base, p):
    _rms(sd, base + "0", p["norm"])
    _lin(sd, base + "1", p["w1"])
    _lin(sd, base + "4", p["w2"])


def t2s_state_dict(tree) -> dict:
    """T2S tree -> state dict under `cfm_wrapper.model.`."""
    sd = {"token_emb.text.weight": _t(tree["text_emb"]["w"]), "token_emb.speech.weight": _t(tree["sem_emb"]["w"]),
          "start_token.text": _t(tree["start_text"]), "start_token.speech": _t(tree["start_speech"])}
    if "null_source_embedding" in tree:
        sd["null_source_embedding"] = _t(tree["null_source_embedding"])
    for i, lp in enumerate(tree.get("source_layers", [])):
        _attn(sd, f"source_transformer.layers.{i}.0.", lp["self_attn"])
        _ff(sd, f"source_transformer.layers.{i}.2.", lp["ff"])
    if "source_layers" in tree:
        _rms(sd, "source_transformer.final_norm", tree["source_final_norm"])
    for i, lp in enumerate(tree["target_layers"]):
        _attn(sd, f"target_transformer.layers.{i}.0.", lp["self_attn"])
        _attn(sd, f"target_transformer.layers.{i}.1.", lp["cross_attn"])
        _ff(sd, f"target_transformer.layers.{i}.2.", lp["ff"])
    _rms(sd, "target_transformer.final_norm", tree["target_final_norm"])
    if "early_exit" in tree:
        ee = tree["early_exit"]
        _ff(sd, "to_early_exit_semantic_logits.0.fn.", ee["ff"])
        _rms(sd, "to_early_exit_semantic_logits.1", ee["norm"])
        sd["to_early_exit_semantic_logits.2.weight"] = _t(ee["to_logits"]["w"]).T.contiguous()
    return {"cfm_wrapper.model." + k: v for k, v in sd.items()}


def hparams(kind: str, cfg) -> dict:
    """Lightning hyper_parameters that `cfg_kwargs_from_hparams` maps back to
    `cfg` (the fields it reads; the others must be at their defaults)."""
    if kind == "t2s":
        return {"text2semantic": True, "CoVoMix_dim_transformer": cfg.dim,
                "text2semantic_source_depth": cfg.source_depth, "text2semantic_target_depth": cfg.target_depth,
                "text2semantic_head": cfg.heads, "num_text_token_ids": cfg.num_text_tokens,
                "text2semantic_tokens": cfg.num_semantic_tokens, "target_transformer_dim": cfg.target_dim,
                "text2semantic_two_output": cfg.two_output, "no_source_transformer": cfg.no_source_transformer}
    return {"CoVoMix_dim": cfg.dim_in, "CoVoMix_dim_transformer": cfg.dim, "CoVoMix_depth": cfg.depth,
            "CoVoMix_heads": cfg.heads, "CoVoMix_dim_head": cfg.dim_head,
            "CoVoMix_num_phoneme_tokens": cfg.num_phoneme_tokens,
            "twocondition_oneoutput": cfg.mode == "two_one", "twocondition_twooutput": cfg.mode == "two_two"}


def lightning_ckpt(tree, cfg, kind: str) -> dict:
    """The `.ckpt` dict of a T2S ("t2s") or acoustic tree: raw weights (the
    tree + 1) in `state_dict`, the tree as the EMA shadow."""
    shadow_sd = t2s_state_dict(tree) if kind == "t2s" else acoustic_state_dict(tree)
    raw = {k: v + 1.0 for k, v in shadow_sd.items()}
    if kind == "t2s":
        raw["cfm_wrapper.model.to_logits.weight"] = raw["cfm_wrapper.model.token_emb.speech.weight"]   # tied
    tracked = [k for k in raw if "rotary_emb" not in k and k != "cfm_wrapper.model.to_logits.weight"]
    return {"state_dict": raw, "hyper_parameters": hparams(kind, cfg),
            "ema": {"decay": 0.9999, "num_updates": 10, "shadow_params": [shadow_sd[k] for k in tracked]}}


def write_lightning_ckpt(path: str, tree, cfg, kind: str) -> None:
    torch.save(lightning_ckpt(tree, cfg, kind), path)


def _wn(sd, key, w_torch: torch.Tensor, b):
    """weight_v = w, weight_g = |w| over every dim but 0 (torch weight_norm
    dim=0 keeps dims)."""
    sd[key + ".weight_v"] = w_torch.contiguous()
    sd[key + ".weight_g"] = torch.sqrt((w_torch * w_torch).sum(dim=tuple(range(1, w_torch.dim())), keepdim=True))
    sd[key + ".bias"] = _t(b)


def hifigan_state_dict(tree) -> dict:
    """Generator tree -> the weight-normed `g_<step>` state dict. Conv1d
    [K, I, O] -> [O, I, K]; ConvTranspose1d [K, I, O] -> [I, O, K]."""
    sd = {}
    conv = lambda key, p: _wn(sd, key, _t(p["w"]).permute(2, 1, 0), p["b"])
    conv("conv_pre", tree["conv_pre"])
    for i, p in enumerate(tree["ups"]):
        _wn(sd, f"ups.{i}", _t(p["w"]).permute(1, 2, 0), p["b"])
    for r, rb in enumerate(tree["resblocks"]):
        for name in ("convs1", "convs2", "convs"):
            for j, p in enumerate(rb.get(name, [])):
                conv(f"resblocks.{r}.{name}.{j}", p)
    conv("conv_post", tree["conv_post"])
    return sd


def write_hifigan_ckpt(path: str, tree, cfg) -> None:
    """`g_<step>` ({'generator': sd}) and the vocoder_config.json beside it."""
    torch.save({"generator": hifigan_state_dict(tree)}, path)
    with open(os.path.join(os.path.dirname(path), "vocoder_config.json"), "w") as f:
        json.dump(json.loads(json.dumps(dataclasses.asdict(cfg))), f)
