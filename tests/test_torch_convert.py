"""The port's checkpoint reader (`covomix_tpu_torch/checkpoint/torch_convert.py`)
and its convert_checkpoint CLI against the JAX package's on the same
reference-format state dicts: every leaf of every tree `np.array_equal`
(the same numpy arithmetic on both sides), and the files the port's CLI
writes read back equal by the JAX package's `load_params`."""

import json

import jax
import numpy as np
import pytest
import torch

from covomix_tpu.checkpoint import io as jio
from covomix_tpu.checkpoint import torch_convert as jtc
from covomix_tpu_torch import convert_checkpoint
from covomix_tpu_torch.checkpoint import torch_convert as ptc

import _torch_ckpt as CK
from _torch_port import J_AC, J_T2S, J_VOC, jax_params


def _flat(tree):
    return {k: np.asarray(v) for k, v in jio._flatten(tree).items()}


def assert_trees_equal(port, ref):
    p, r = _flat(port), _flat(ref)
    assert p.keys() == r.keys()
    for k in r:
        assert p[k].dtype == r[k].dtype == np.float32, k
        assert np.array_equal(p[k], r[k]), k


def _rand(*shape, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32))


@pytest.fixture(scope="module")
def trees():
    return [jax.tree_util.tree_map(np.asarray, t) for t in jax_params(0)]


def test_convert_acoustic_equals_jax_and_tree(trees):
    sd = CK.acoustic_state_dict(trees[1])
    out = ptc.convert_acoustic(sd, depth=J_AC.depth)
    assert_trees_equal(out, jtc.convert_acoustic(sd, depth=J_AC.depth))
    assert_trees_equal(out, trees[1])


def _t2s_variant(tree, variant):
    tree = jax.tree_util.tree_map(np.copy, tree)
    rs = np.random.RandomState(1)
    if variant == "no_source_transformer":
        del tree["source_layers"]
        tree["source_final_norm"] = {"gamma": np.ones_like(tree["start_text"])}
    elif variant == "null_source":
        tree["null_source_embedding"] = rs.randn(J_T2S.dim).astype(np.float32)
    elif variant == "early_exit":
        d, ff = J_T2S.target_dim, 24
        tree["early_exit"] = {
            "ff": {"norm": {"gamma": rs.randn(d).astype(np.float32)},
                   "w1": {"w": rs.randn(d, 2 * ff).astype(np.float32), "b": rs.randn(2 * ff).astype(np.float32)},
                   "w2": {"w": rs.randn(ff, d).astype(np.float32), "b": rs.randn(d).astype(np.float32)}},
            "norm": {"gamma": rs.randn(d).astype(np.float32)},
            "to_logits": {"w": rs.randn(d, 502).astype(np.float32)}}
    return tree


@pytest.mark.parametrize("variant", ["source_transformer", "no_source_transformer", "null_source", "early_exit"])
def test_convert_t2s_equals_jax_and_tree(trees, variant):
    tree = _t2s_variant(trees[0], variant)
    sd = CK.t2s_state_dict(tree)
    out = ptc.convert_t2s(sd, source_depth=J_T2S.source_depth, target_depth=J_T2S.target_depth)
    assert_trees_equal(out, jtc.convert_t2s(sd, source_depth=J_T2S.source_depth, target_depth=J_T2S.target_depth))
    assert_trees_equal(out, tree)


@pytest.mark.parametrize("kind", ["t2s", "acoustic"])
def test_apply_ema_swaps_shadow_and_ties(trees, kind):
    """The raw state dict holds tree + 1; the EMA swap puts the tree back,
    on both keys of the tied T2S weight, and leaves the rotary buffer."""
    tree, cfg = (trees[0], J_T2S) if kind == "t2s" else (trees[1], J_AC)
    ck = CK.lightning_ckpt(tree, cfg, kind)
    out = ptc.apply_ema(ck["state_dict"], ck["ema"])
    ref = jtc.apply_ema(ck["state_dict"], ck["ema"])
    assert out.keys() == ref.keys()
    for k in out:
        assert torch.equal(out[k], ref[k]), k
    if kind == "t2s":
        tied = ("cfm_wrapper.model.to_logits.weight", "cfm_wrapper.model.token_emb.speech.weight")
        assert torch.equal(out[tied[0]], out[tied[1]])
        np.testing.assert_array_equal(out[tied[0]].numpy(), tree["sem_emb"]["w"])
    else:
        key = "cfm_wrapper.CoVoMix.transformer.rotary_emb.inv_freq"
        assert torch.equal(out[key], ck["state_dict"][key])


def test_apply_ema_greedy_alignment_and_mismatch(trees):
    """An untracked buffer the skip list does not name is passed over by the
    shape alignment; a shadow that does not align raises, as in JAX."""
    ck = CK.lightning_ckpt(trees[1], J_AC, "acoustic")
    sd = dict(ck["state_dict"])
    sd["cfm_wrapper.CoVoMix.some_buffer"] = torch.zeros(5)
    out = ptc.apply_ema(sd, ck["ema"])
    assert torch.equal(out["cfm_wrapper.CoVoMix.some_buffer"], torch.zeros(5))
    assert torch.equal(out["cfm_wrapper.CoVoMix.null_cond"], torch.from_numpy(trees[1]["null_cond"]))
    for conv in (ptc, jtc):
        with pytest.raises(ValueError, match="EMA shadow"):
            conv.apply_ema(sd, {"shadow_params": [torch.zeros(3)], "decay": 0.999, "num_updates": 0})


@pytest.mark.parametrize("parametrized", [False, True], ids=["folded", "parametrized"])
def test_convert_hifigan_generator_equals_jax(trees, parametrized):
    sd = CK.hifigan_state_dict(trees[2])
    out = ptc.convert_hifigan_generator(sd, num_ups=4, parametrized=parametrized)
    assert_trees_equal(out, jtc.convert_hifigan_generator(sd, num_ups=4, parametrized=parametrized))
    if not parametrized:   # weight_v = w, weight_g = |w|: folding gives w back to f32 rounding
        for k, v in _flat(trees[2]).items():
            np.testing.assert_allclose(_flat(out)[k], v, rtol=1e-6, atol=1e-7, err_msg=k)


def _discriminator_ckpt():
    """A do_<step> dict: MPD (5 x 6 weight-normed Conv2d), MSD (3 x 8 Conv1d;
    sub-discriminator 0 spectral-normed), shapes cut down."""
    seed = iter(range(10_000))
    mpd, msd = {}, {}
    for di in range(5):
        for ci, shape in enumerate([(4, 1, 5, 1)] * 5 + [(1, 4, 3, 1)]):
            base = f"discriminators.{di}.{'convs.%d' % ci if ci < 5 else 'conv_post'}"
            mpd[base + ".weight_v"] = _rand(*shape, seed=next(seed))
            mpd[base + ".weight_g"] = _rand(shape[0], 1, 1, 1, seed=next(seed)).abs()
            mpd[base + ".bias"] = _rand(shape[0], seed=next(seed))
    for di in range(3):
        for ci, (o, ig, k) in enumerate([(6, 2, 5)] * 7 + [(1, 6, 3)]):
            base = f"discriminators.{di}.{'convs.%d' % ci if ci < 7 else 'conv_post'}"
            if di == 0:
                msd[base + ".weight_orig"] = _rand(o, ig, k, seed=next(seed))
                msd[base + ".weight_u"] = _rand(o, seed=next(seed))
                msd[base + ".weight_v"] = _rand(ig * k, seed=next(seed))
            else:
                msd[base + ".weight_v"] = _rand(o, ig, k, seed=next(seed))
                msd[base + ".weight_g"] = _rand(o, 1, 1, seed=next(seed)).abs()
            msd[base + ".bias"] = _rand(o, seed=next(seed))
    return {"mpd": mpd, "msd": msd, "steps": 123, "epoch": 1}


def test_convert_hifigan_discriminators_equals_jax():
    ck = _discriminator_ckpt()
    mpd, msd = ptc.convert_hifigan_discriminators(ck)
    jmpd, jmsd = jtc.convert_hifigan_discriminators(ck)
    assert_trees_equal(mpd, jmpd)
    assert_trees_equal(msd, jmsd)
    # spectral-norm v: torch flattens (i, k), the tree (k, i)
    v = ck["msd"]["discriminators.0.convs.0.weight_v"].numpy().reshape(2, 5)
    np.testing.assert_array_equal(msd["discriminators"][0]["convs"][0]["v"], v.T.ravel())


def _hubert_ckpt(layers=1, convs=2):
    """A fairseq HuBERT `.pt` dict at width 16 with `layers` encoder layers
    and `convs` frontend convs."""
    seed = iter(range(10_000))
    sd = {"feature_extractor.conv_layers.0.2.weight": _rand(16, seed=next(seed)),
          "feature_extractor.conv_layers.0.2.bias": _rand(16, seed=next(seed)),
          "encoder.pos_conv.0.weight_v": _rand(16, 8, 8, seed=next(seed)),
          "encoder.pos_conv.0.weight_g": _rand(1, 1, 8, seed=next(seed)).abs(),
          "encoder.pos_conv.0.bias": _rand(16, seed=next(seed))}
    for i in range(convs):
        sd[f"feature_extractor.conv_layers.{i}.0.weight"] = _rand(16, 1 if i == 0 else 16, 3, seed=next(seed))
    names = [("layer_norm", (16,)), ("post_extract_proj", (16, 16)), ("encoder.layer_norm", (16,))]
    for i in range(layers):
        b = f"encoder.layers.{i}."
        names += [(b + "self_attn.q_proj", (16, 16)), (b + "self_attn.k_proj", (16, 16)),
                  (b + "self_attn.v_proj", (16, 16)), (b + "self_attn.out_proj", (16, 16)), (b + "fc1", (32, 16)),
                  (b + "fc2", (16, 32)), (b + "self_attn_layer_norm", (16,)), (b + "final_layer_norm", (16,))]
    for n, shape in names:
        sd[n + ".weight"] = _rand(*shape, seed=next(seed))
        sd[n + ".bias"] = _rand(shape[0], seed=next(seed))
    return {"model": sd}


def test_convert_hubert_equals_jax():
    ck = _hubert_ckpt()
    out = ptc.convert_hubert(ck, encoder_layers=1, conv_layers=2)
    assert_trees_equal(out, jtc.convert_hubert(ck, encoder_layers=1, conv_layers=2))
    v, g = ck["model"]["encoder.pos_conv.0.weight_v"].numpy(), ck["model"]["encoder.pos_conv.0.weight_g"].numpy()
    folded = g * v / np.sqrt((v * v).sum(axis=(0, 1), keepdims=True))   # weight norm along dim 2
    np.testing.assert_allclose(out["pos_conv"]["w"], folded.transpose(2, 1, 0), rtol=1e-6)


def test_load_kmeans_equals_jax(tmp_path):
    import joblib
    from sklearn.cluster import KMeans

    x = np.random.RandomState(0).randn(40, 6).astype(np.float32)
    km = KMeans(n_clusters=4, n_init=1, random_state=0).fit(x)
    joblib.dump(km, tmp_path / "km.bin")
    joblib.dump(km.cluster_centers_, tmp_path / "centers.bin")
    for name in ("km.bin", "centers.bin"):
        out = ptc.load_kmeans(str(tmp_path / name))
        assert out.dtype == np.float32 and out.shape == (4, 6)
        np.testing.assert_array_equal(out, jtc.load_kmeans(str(tmp_path / name)))


def test_load_kmeans_names_missing_joblib(tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "joblib", None)
    with pytest.raises(ImportError, match="joblib"):
        ptc.load_kmeans(str(tmp_path / "km.bin"))


@pytest.mark.parametrize("hp,kind", [
    ({"text2semantic": True, "CoVoMix_dim_transformer": 256, "target_transformer_dim": 1024,
      "text2semantic_two_output": True}, None),
    ({"text2semantic": True, "no_source_transformer": True}, None),
    ({"twocondition_oneoutput": True, "CoVoMix_dim": 160, "CoVoMix_depth": 4}, None),
    ({"twocondition_twooutput": True}, None),
    ({}, None), ({}, "t2s"), ({"text2semantic": True}, "acoustic")])
def test_cfg_kwargs_from_hparams_equals_jax(hp, kind):
    assert ptc.cfg_kwargs_from_hparams(hp, kind=kind) == jtc.cfg_kwargs_from_hparams(hp, kind=kind)


def _cli(argv):
    convert_checkpoint.main(argv)


@pytest.mark.parametrize("kind", ["t2s", "acoustic"])
def test_cli_lightning_reads_back_in_jax(trees, tmp_path, kind):
    tree, cfg = (trees[0], J_T2S) if kind == "t2s" else (trees[1], J_AC)
    src, dst = str(tmp_path / "m.ckpt"), str(tmp_path / "m.npz")
    CK.write_lightning_ckpt(src, tree, cfg, kind)
    _cli(["lightning", src, dst])
    ref, hp = jtc.convert_lightning_ckpt(src)
    assert_trees_equal(jio.load_params(dst), ref)
    assert_trees_equal(jio.load_params(dst), tree)
    meta = jio.load_meta(dst)
    assert meta == {"kind": kind, "config": jtc.cfg_kwargs_from_hparams(hp), "source": src, "ema": True}
    _cli(["lightning", src, dst, "--no-ema"])     # the raw weights: tree + 1
    raw = _flat(jio.load_params(dst))
    for k, v in _flat(tree).items():
        np.testing.assert_array_equal(raw[k], v + np.float32(1.0), err_msg=k)


def test_cli_hifigan_generator_reads_back_in_jax(trees, tmp_path):
    src, dst = str(tmp_path / "g_00000100"), str(tmp_path / "voc.npz")
    CK.write_hifigan_ckpt(src, trees[2], J_VOC)
    _cli(["hifigan", src, dst])
    with open(tmp_path / "vocoder_config.json") as f:
        h = json.load(f)
    assert_trees_equal(jio.load_params(dst), jtc.convert_hifigan_ckpt(src, h))
    meta = jio.load_meta(dst)
    assert meta["kind"] == "vocoder" and meta["config"]["upsample_initial_channel"] == J_VOC.upsample_initial_channel
    assert meta["config"]["resblock_dilation_sizes"] == [[1, 3, 5]] * 3 and meta["config"]["sampling_rate"] == 8000


def test_cli_hifigan_discriminators_and_hubert(tmp_path):
    torch.save(_discriminator_ckpt(), tmp_path / "do_00000123")
    _cli(["hifigan", str(tmp_path / "do_00000123"), str(tmp_path / "disc.npz")])
    mpd, msd = jtc.convert_hifigan_discriminators(_discriminator_ckpt())
    assert_trees_equal(jio.load_params(str(tmp_path / "disc.npz")), {"mpd": mpd, "msd": msd})
    assert jio.load_meta(str(tmp_path / "disc.npz"))["steps"] == 123

    ck = _hubert_ckpt(layers=12, convs=7)       # the CLI reads the full layout
    torch.save(ck, tmp_path / "hubert.pt")
    km = np.random.RandomState(1).randn(5, 16).astype(np.float32)
    import joblib

    joblib.dump(km, tmp_path / "km.bin")
    _cli(["hubert", str(tmp_path / "hubert.pt"), str(tmp_path / "hubert.npz"), "--km", str(tmp_path / "km.bin")])
    got = jio.load_params(str(tmp_path / "hubert.npz"))
    np.testing.assert_array_equal(got.pop("kmeans"), km)
    assert_trees_equal(got, jtc.convert_hubert(ck))
    assert jio.load_meta(str(tmp_path / "hubert.npz"))["kind"] == "hubert"
