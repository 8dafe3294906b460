"""The port's T2S training against the JAX package: `forward_loss` and its
gradients (CoSingle, CoMix two-stream, two text streams with cond-drop), with
the decoder's causal self-attention on the flash route when the decoder is 512
positions long; `collate_t2s`; the token WER and BLEU of the eval;
`evaluate_t2s` with greedy decodes on both sides; and
`python -m covomix_tpu_torch.train --text2semantic --device cpu` for two steps,
an eval, a checkpoint and a resume.

f32 at 'highest' precision on both sides: the loss to 1e-5 relative, every
gradient leaf to 1e-5 of its scale (summation order only)."""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covomix_tpu import native as JN
from covomix_tpu.data import datasets as JD, tokenizer as JTok
from covomix_tpu.models import text2semantic as JT
from covomix_tpu.ops import flash_attention as JF
from covomix_tpu.train import evaluate as JE, loop as JLoop
from covomix_tpu_torch.data import datasets as PD, tokenizer as PTok
from covomix_tpu_torch.models import text2semantic as PT
from covomix_tpu_torch.ops import flash_attention as PF
from covomix_tpu_torch.train import evaluate as PE, loop as PLoop
from covomix_tpu_torch.util import text_metrics as TM
from covomix_tpu_torch.util.misc import named_leaves, tree_leaves

from _torch_port import GREEDY_THRES, J_T2S, port_cfg, to_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
CONFIGS = {   # the tiny CoMix config of _torch_port, and its CoSingle and two-text-stream variants
    "cosingle": dataclasses.replace(J_T2S, two_output=False),
    "comix": J_T2S,
    "two_input_cfg_drop": dataclasses.replace(J_T2S, two_output=False, two_input=True,
                                              classifier_free_guidance=True, cond_drop_prob=1.0),
    # the early-exit draft heads' CE at decoder layer 1 of 2 (CoMix: both heads)
    "cosingle_early_exit": dataclasses.replace(J_T2S, two_output=False, target_depth=2, target_early_exit_layer=1),
    "cosingle_early_exit_detach": dataclasses.replace(J_T2S, two_output=False, target_depth=2,
                                                      target_early_exit_layer=1, detach_early_exit_embed=True),
    "comix_early_exit": dataclasses.replace(J_T2S, target_depth=2, target_early_exit_layer=1),
}


def _params(cfg, seed=0):
    return jax.jit(JT.init, static_argnums=1)(jax.random.PRNGKey(seed), cfg)


def _batch(cfg, t, seed):
    """Right-padded text ids (pad 0) and semantic targets (pad 501)."""
    rs = np.random.RandomState(seed)
    b, s = 3, 12
    text = rs.randint(1, 200, (b, s, 2) if cfg.two_input else (b, s)).astype(np.int32)
    text[1, 7:] = 0
    sem = rs.randint(0, 501, (b, t, 2) if cfg.two_output else (b, t)).astype(np.int32)
    sem[2, t - 9:] = 501
    return text, sem


def _flash_dispatch_jax(q, k, v, *, key_mask=None, valid_len=None, causal=False, rotary=None,
                        min_seq_for_flash=512):
    """The JAX dispatcher with 'on TPU' read as true: the Pallas kernels in
    interpret mode from 512 positions on, as on the card."""
    assert rotary is None
    if key_mask is None and q.shape[-2] >= min_seq_for_flash and (not causal or q.shape[-2] == k.shape[-2]):
        return JF.flash_attention(q, k, v, valid_len=valid_len, causal=causal, interpret=True)
    return JF.attend_flash_or_xla(q, k, v, key_mask=key_mask, valid_len=valid_len, causal=causal,
                                  min_seq_for_flash=min_seq_for_flash)


@pytest.mark.parametrize("name,t,route", [
    ("cosingle", 40, "dispatched"),
    ("comix", 40, "dispatched"),
    ("two_input_cfg_drop", 40, "dispatched"),
    ("comix", 510, "flash"),       # decoder [BOS | 510 targets | EOS] = 512 positions
    ("cosingle_early_exit", 40, "dispatched"),
    ("cosingle_early_exit_detach", 40, "dispatched"),
    ("comix_early_exit", 40, "dispatched"),
    ("comix_early_exit", 510, "flash"),   # the early-exit CE adds no attention call
])
def test_forward_loss_and_every_gradient_match_jax(name, t, route, monkeypatch):
    """forward_loss and the gradient of every parameter against
    jax.value_and_grad(forward_loss). 'dispatched': both packages take their
    CPU attention; 'flash': the decoder's causal self-attention goes through
    the flash route on both sides (the Pallas kernels in interpret mode; the
    port's autograd Function with the plain versions), the 13-id encoder stays
    on layers.attend. The cond-drop case drops every row (probability 1), so
    both packages take the same draw."""
    jcfg = CONFIGS[name]
    pcfg = port_cfg(PT.T2SConfig, jcfg)
    text, sem = _batch(jcfg, t, 3)
    jp = _params(jcfg)
    cond_drop = jcfg.classifier_free_guidance
    causal_backwards = []
    if route == "flash":
        monkeypatch.setattr(JT, "attend_flash_or_xla", _flash_dispatch_jax)
        rule = PF.use_flash_kernel
        monkeypatch.setattr(PF, "use_flash_kernel", lambda **kw: rule(**{**kw, "on_cuda": True}))
        plain_bwd = PF.flash_attention_bwd_plain
        monkeypatch.setattr(PF, "flash_attention_bwd_plain",
                            lambda *a: causal_backwards.append(a[-1]) or plain_bwd(*a))

    def jax_loss(p):
        return JT.forward_loss(p, jcfg, jnp.asarray(text), jnp.asarray(sem), key=jax.random.PRNGKey(1),
                               cond_drop=cond_drop)

    with jax.default_matmul_precision("highest"):
        loss_j, grads_j = jax.jit(jax.value_and_grad(jax_loss))(jp)
        _, logits_j = jax.jit(functools.partial(JT.forward_loss, cfg=jcfg, return_logits=True))(
            jp, source_ids=jnp.asarray(text), target_ids=jnp.asarray(sem))
    pp = to_port(jp)
    for p in tree_leaves(pp):
        p.requires_grad_(True)
    loss_p, logits_p = PT.forward_loss(pp, pcfg, torch.from_numpy(text), torch.from_numpy(sem),
                                       generator=torch.Generator().manual_seed(0), cond_drop=cond_drop,
                                       return_logits=True)
    loss_p.backward()
    assert causal_backwards == ([True] * pcfg.target_depth if route == "flash" else [])
    assert abs(loss_p.item() - float(loss_j)) <= TOL * abs(float(loss_j))
    for lp, lj in zip(logits_p if jcfg.two_output else [logits_p], logits_j if jcfg.two_output else [logits_j]):
        assert lp.shape == lj.shape == (3, t + 2, 502)   # [BOS | targets | EOS]
        if not cond_drop:   # return_logits runs without the drop on the JAX side
            assert np.abs(lp.detach().numpy() - np.asarray(lj)).max() <= TOL * max(1.0, np.abs(lj).max())
    flat_j = dict(named_leaves(jax.tree_util.tree_map(np.asarray, grads_j)))
    named = named_leaves(pp)
    assert sorted(flat_j) == sorted(n for n, _ in named)
    for leaf_name, p in named:
        ref = flat_j[leaf_name]
        grad = torch.zeros_like(p) if p.grad is None else p.grad   # start_text: no use, no gradient
        err = np.abs(grad.numpy() - ref).max()
        assert err <= TOL * max(1.0, np.abs(ref).max()), (leaf_name, err)
    if cond_drop:
        assert float(np.abs(flat_j["null_source_embedding"]).max()) > 0
    else:
        assert float(np.abs(flat_j["text_emb/w"]).max()) > 0
    if jcfg.target_early_exit_layer:
        heads = ["to_logits", "to_logits2"] if jcfg.two_output else ["to_logits"]
        assert sorted(k for k in flat_j if k.startswith("early_exit/to_logits")) == [f"early_exit/{h}/w" for h in heads]
        assert all(float(np.abs(flat_j[f"early_exit/{h}/w"]).max()) > 0 for h in heads)


def test_forward_loss_with_precomputed_source_emb_matches_jax():
    """The external-text-encoder path: precomputed source embeddings with an
    explicit (here not prefix) source_mask, the loss and the gradients."""
    jp = _params(J_T2S, 4)
    rs = np.random.RandomState(8)
    emb = (rs.randn(3, 12, J_T2S.dim) * 0.5).astype(np.float32)
    mask = rs.rand(3, 12) < 0.7
    mask[:, 0] = True
    _, sem = _batch(J_T2S, 30, 9)

    def jax_loss(p):
        return JT.forward_loss(p, J_T2S, None, jnp.asarray(sem), source_emb=jnp.asarray(emb),
                               source_mask=jnp.asarray(mask))

    with jax.default_matmul_precision("highest"):
        loss_j, grads_j = jax.jit(jax.value_and_grad(jax_loss))(jp)
    pp = to_port(jp)
    for p in tree_leaves(pp):
        p.requires_grad_(True)
    loss_p = PT.forward_loss(pp, port_cfg(PT.T2SConfig, J_T2S), None, torch.from_numpy(sem),
                             source_emb=torch.from_numpy(emb), source_mask=torch.from_numpy(mask))
    loss_p.backward()
    assert abs(loss_p.item() - float(loss_j)) <= TOL * abs(float(loss_j))
    flat_j = dict(named_leaves(jax.tree_util.tree_map(np.asarray, grads_j)))
    for leaf_name, p in named_leaves(pp):
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        assert np.abs(grad.numpy() - flat_j[leaf_name]).max() <= TOL * max(1.0, np.abs(flat_j[leaf_name]).max())
    with pytest.raises(ValueError, match="source_mask"):
        PT.forward_loss(pp, port_cfg(PT.T2SConfig, J_T2S), None, torch.from_numpy(sem),
                        source_emb=torch.from_numpy(emb))


def test_early_exit_head_not_ported():
    """A tree without the `early_exit` head (a checkpoint trained without
    it) under a config with target_early_exit_layer > 0: both packages add
    no early-exit CE, so the loss is the loss without the head's config."""
    jcfg = dataclasses.replace(J_T2S, target_early_exit_layer=1)
    jp = _params(J_T2S, 6)
    assert "early_exit" not in jp
    text, sem = _batch(J_T2S, 24, 7)
    with jax.default_matmul_precision("highest"):
        ref = float(JT.forward_loss(jp, jcfg, jnp.asarray(text), jnp.asarray(sem)))
        plain = float(JT.forward_loss(jp, J_T2S, jnp.asarray(text), jnp.asarray(sem)))
    loss = PT.forward_loss(to_port(jp), port_cfg(PT.T2SConfig, jcfg), torch.from_numpy(text), torch.from_numpy(sem))
    assert ref == plain
    assert abs(loss.item() - ref) <= TOL * abs(ref)


def test_t2s_loss_fn_matches_jax():
    """The loss adapter reads {'text_ids', 'semantic_ids'} as the JAX one."""
    jp = _params(J_T2S, 2)
    text, sem = _batch(J_T2S, 24, 4)
    batch = {"text_ids": text, "semantic_ids": sem}
    with jax.default_matmul_precision("highest"):
        ref = float(JLoop.t2s_loss_fn(J_T2S)(jp, jax.tree_util.tree_map(jnp.asarray, batch), jax.random.PRNGKey(0)))
    loss = PLoop.t2s_loss_fn(port_cfg(PT.T2SConfig, J_T2S))(to_port(jp), PLoop.to_device(batch, "cpu"), None)
    assert abs(loss.item() - ref) <= TOL * abs(ref)


def _check_loss_and_grads(jax_loss, port_loss, jp):
    """jax.value_and_grad(jax_loss) at jp against port_loss at the carried
    parameters and its backward: the loss and every gradient leaf within TOL."""
    with jax.default_matmul_precision("highest"):
        loss_j, grads_j = jax.jit(jax.value_and_grad(jax_loss))(jp)
    pp = to_port(jp)
    for p in tree_leaves(pp):
        p.requires_grad_(True)
    loss_p = port_loss(pp)
    loss_p.backward()
    assert abs(loss_p.item() - float(loss_j)) <= TOL * abs(float(loss_j))
    flat_j = dict(named_leaves(jax.tree_util.tree_map(np.asarray, grads_j)))
    for leaf_name, p in named_leaves(pp):
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        ref = flat_j[leaf_name]
        assert np.abs(grad.numpy() - ref).max() <= TOL * max(1.0, np.abs(ref).max()), leaf_name
    return flat_j


def test_semantic_to_text_loss_matches_jax():
    """Back-translation (speech tokens in, text out through the weight-tied
    text logits): loss and every gradient; the JAX asserts on the config."""
    jcfg = dataclasses.replace(J_T2S, two_output=False, target_dim=J_T2S.dim)
    pcfg = port_cfg(PT.T2SConfig, jcfg)
    rs = np.random.RandomState(11)
    sem = rs.randint(0, 501, (3, 20)).astype(np.int32)
    sem[1, 14:] = -1
    text = rs.randint(1, 200, (3, 12)).astype(np.int32)
    text[2, 5:] = 0
    flat_j = _check_loss_and_grads(
        lambda p: JT.semantic_to_text_loss(p, jcfg, jnp.asarray(sem), jnp.asarray(text)),
        lambda p: PT.semantic_to_text_loss(p, pcfg, torch.from_numpy(sem), torch.from_numpy(text)),
        _params(jcfg, 12))
    assert float(np.abs(flat_j["start_text"]).max()) > 0 and float(np.abs(flat_j["sem_emb/w"]).max()) > 0
    for bad in (J_T2S, dataclasses.replace(jcfg, two_input=True)):
        with pytest.raises(AssertionError):
            JT.semantic_to_text_loss({}, bad, jnp.asarray(sem), jnp.asarray(text))
        with pytest.raises(AssertionError):
            PT.semantic_to_text_loss({}, port_cfg(PT.T2SConfig, bad), torch.from_numpy(sem), torch.from_numpy(text))


def test_speech_speech_pretrain_loss_matches_jax():
    """Denoising pretraining with JAX's deletion draw handed to the port as
    `drop`: loss and every gradient. Without `drop` the draw comes from the
    generator, reproducibly."""
    jcfg = dataclasses.replace(J_T2S, two_output=False)
    pcfg = port_cfg(PT.T2SConfig, jcfg)
    rs = np.random.RandomState(13)
    sem = rs.randint(0, 501, (3, 18)).astype(np.int32)
    sem[0, 11:] = -1
    key = jax.random.PRNGKey(5)
    drop = np.array(jax.random.uniform(key, sem.shape) < 0.6)
    _check_loss_and_grads(
        lambda p: JT.speech_speech_pretrain_loss(p, jcfg, key, jnp.asarray(sem)),
        lambda p: PT.speech_speech_pretrain_loss(p, pcfg, None, torch.from_numpy(sem), drop=torch.from_numpy(drop)),
        _params(jcfg, 14))
    pp = to_port(_params(jcfg, 14))
    a, b = (PT.speech_speech_pretrain_loss(pp, pcfg, torch.Generator().manual_seed(2), torch.from_numpy(sem))
            for _ in range(2))
    assert torch.isfinite(a) and a.item() == b.item()


WORDS = ["hello", "there", "good", "morning", "yes", "no", "okay", "right", "sure", "well", "laugh"]


def write_t2s_items(root, n, seed=0, pair_every=3, lengths=(20, 50)):
    """n random T2S items: `.hubert_code.npy` (codes as strings) beside a
    `.txt`; every `pair_every`-th item a `_1` / `_2` two-speaker pair (none
    for 0: the CoSingle format reads a `.txt` beside every code file)."""
    rs = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        t = int(rs.randint(*lengths))
        base = os.path.join(root, f"u{i}")
        if pair_every and i % pair_every == pair_every - 1:
            np.save(base + "_1.hubert_code.npy", rs.randint(0, 500, t).astype(str))
            np.save(base + "_2.hubert_code.npy", rs.randint(0, 500, t - 3).astype(str))
        else:
            np.save(base + ".hubert_code.npy", rs.randint(0, 500, t).astype(str))
        with open(base + ".txt", "w") as f:
            f.write(" ".join(rs.choice(WORDS, int(rs.randint(2, 8)))))


@pytest.mark.parametrize("fmt", ["text2semantic", "text2semantic_2output"])
def test_collate_t2s_gives_the_jax_packages_batches(tmp_path, fmt):
    write_t2s_items(str(tmp_path), 8, pair_every=3 if fmt == "text2semantic_2output" else 0)
    jtok = JTok.load_covomix_tokenizer(None, strict=False)
    ptok = PTok.load_covomix_tokenizer(None, strict=False)
    jds = JD.CoVoMixDataset(str(tmp_path), format=fmt, seed=3)
    pds = PD.CoVoMixDataset(str(tmp_path), format=fmt, seed=3)
    assert pds.files == jds.files
    jl = JD.data_loader(jds, 3, lambda items: JD.collate_t2s(items, jtok), seed=3)
    pl = PD.data_loader(pds, 3, lambda items: PD.collate_t2s(items, ptok), seed=3)
    for _ in range(5):
        jb, pb = next(jl), next(pl)
        assert jb.keys() == pb.keys() == {"text_ids", "semantic_ids"}
        for key in jb:
            assert jb[key].dtype == pb[key].dtype and np.array_equal(jb[key], pb[key]), key
        assert pb["text_ids"].shape[1] % 16 == 0 and pb["semantic_ids"].shape[1] % 64 == 0
    stacked = PD.stack_microbatches([next(pl), PD.collate_t2s([pds[0]], ptok)])
    ref = JD.stack_microbatches([next(jl), JD.collate_t2s([jds[0]], jtok)])
    assert all(np.array_equal(stacked[k], ref[k]) for k in ref)


def test_levenshtein_and_token_wer_match_native():
    rs = np.random.RandomState(0)
    for i in range(40):
        a = rs.randint(0, 6, rs.randint(0, 30))
        b = rs.randint(0, 6, rs.randint(0, 30)) if i % 3 else a.copy()
        assert TM.levenshtein(a, b) == JN.levenshtein(a, b), (a, b)
        assert PE.token_wer(a, b) == JE.token_wer(a, b)


def test_bleu_matches_native():
    rs = np.random.RandomState(1)
    mine, ref = TM.BleuScorer(pad=-1, eos=-2, unk=-3), JN.BleuScorer(pad=-1, eos=-2, unk=-3)
    for _ in range(12):
        r = rs.randint(0, 8, rs.randint(1, 40))
        h = np.concatenate([r[: rs.randint(0, len(r) + 1)], rs.randint(0, 8, rs.randint(0, 10))])
        mine.add(r, h)
        ref.add(r, h)
        assert np.array_equal(mine.stat, ref.stat)
    assert mine.score() == pytest.approx(ref.score(), rel=1e-12) and mine.score() > 0
    assert mine.precision() == ref.precision() and mine.brevity() == ref.brevity()


def test_evaluate_t2s_matches_jax(tmp_path, monkeypatch):
    """Both packages' evaluate_t2s on the same weights and batches, each
    decoding greedily (top_k_thres small enough that k = 1): the same WER
    ('l2'), accuracy and token BLEU."""
    write_t2s_items(str(tmp_path), 6, seed=5)
    jtok = JTok.load_covomix_tokenizer(None, strict=False)
    ds = JD.CoVoMixDataset(str(tmp_path), format="text2semantic_2output", seed=0)
    batches = [JD.collate_t2s([ds[i] for i in range(j, j + 3)], jtok) for j in (0, 3)]
    jp = _params(J_T2S, 7)
    jgen, pgen = JT.generate, PT.generate
    monkeypatch.setattr(JT, "generate", lambda *a, **kw: jgen(*a, **{**kw, "top_k_thres": GREEDY_THRES}))
    monkeypatch.setattr(PT, "generate", lambda *a, **kw: pgen(*a, **{**kw, "top_k_thres": GREEDY_THRES}))
    with jax.default_matmul_precision("highest"):
        ref = JE.evaluate_t2s(jp, J_T2S, batches, jax.random.PRNGKey(0), max_length=40)
    out = PE.evaluate_t2s(to_port(jp), port_cfg(PT.T2SConfig, J_T2S), batches, torch.Generator().manual_seed(0),
                          max_length=40)
    assert out.keys() == ref.keys() == {"l2", "accuracy", "token_bleu"}
    for key in ref:
        assert out[key] == pytest.approx(float(ref[key]), abs=1e-12), key
    assert 0 < out["l2"] <= 1


def _train(data, logs, *extra):
    return subprocess.run(
        [sys.executable, "-m", "covomix_tpu_torch.train", "--device", "cpu", "--base_dir", str(data),
         "--format", "text2semantic_2output", "--text2semantic", "--text2semantic_two_output",
         "--allow_fallback_vocab", "--CoVoMix_dim_transformer", "32", "--target_transformer_dim", "64",
         "--text2semantic_source_depth", "1", "--text2semantic_target_depth", "1", "--text2semantic_head", "2",
         "--num_text_token_ids", "200", "--batch_size", "2", "--lr_scheduler", "--log_dir", str(logs),
         "--run_name", "t2s", "--log_every", "1", "--eval_every", "2", "--num_eval_files", "2",
         "--ckpt_every", "1000", "--no_wandb", *extra],
        cwd=REPO, capture_output=True, text=True, timeout=300)


def test_t2s_train_cli_two_steps_then_resume(tmp_path):
    """CoMix T2S training through the CLI: two steps with an eval (a 512-step
    decode of the EMA parameters) and a top-k save at step 2, then --resume
    for a third step from step 2's state."""
    data, logs = tmp_path / "data", tmp_path / "logs"
    write_t2s_items(str(data), 5, seed=2)
    r = _train(data, logs, "--max_steps", "2")
    assert r.returncode == 0, r.stderr[-2500:]
    run = logs / "t2s"
    lines = [json.loads(line) for line in open(run / "metrics.jsonl") if line.strip()]
    steps = [rec for rec in lines if "train_loss" in rec]
    assert [rec["step"] for rec in steps] == [1, 2]
    assert all(np.isfinite(rec["train_loss"]) and np.isfinite(rec["grad_norm"]) for rec in steps)
    evals = [rec for rec in lines if "eval_l2" in rec]
    assert len(evals) == 1 and {"eval_accuracy", "eval_token_bleu"} <= evals[0].keys()
    assert 0 <= evals[0]["eval_l2"] <= 1
    ckpt = run / "checkpoints"
    topk = json.load(open(ckpt / "topk.json"))
    assert topk["best_step"] == 2 and (ckpt / "step_00000002" / "state.npz").is_file()
    with open(run / "args.txt") as f:
        assert json.load(f)["text2semantic"] is True

    r = _train(data, logs, "--max_steps", "3", "--resume")
    assert r.returncode == 0, r.stderr[-2500:]
    assert "resumed from step 2" in r.stdout
    steps = [json.loads(line) for line in open(run / "metrics.jsonl") if "train_loss" in line]
    assert [rec["step"] for rec in steps] == [1, 2, 3]
    with np.load(ckpt / "step_00000003" / "state.npz") as z:
        assert int(z["step"]) == 3 and int(z["adam_step"]) == 3 and int(z["ema_num_updates"]) == 3
        assert z["params/sem_emb/w"].shape == (502, 32)


def test_t2s_refuses_pp_and_sp_as_train_py_does(tmp_path):
    from covomix_tpu_torch.train import cli

    for flag in ("--pp", "--sp"):
        with pytest.raises(SystemExit, match="--pp/--sp apply to the acoustic model only"):
            cli.main(["--base_dir", str(tmp_path), "--device", "cpu", "--text2semantic", flag, "2"])
