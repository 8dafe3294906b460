"""The port's CoVoSingle family against the JAX package: the VoSingle
acoustic model (`mode="single"`, 80-d, one phoneme stream) and the CoSingle
T2S model (one output stream), as `running_command/Acous_VoSingle.sh` and
`T2S_CoSingle.sh` train them, at tiny widths, f32 at 'highest' precision.

  * `cfm_inputs` with JAX's draws handed to the port (with the batch's mask,
    as the hubert_fisher items carry it without --random_mask, and with the
    mask drawn when the batch carries none);
  * the loss of `train.loop.acoustic_loss_fn` (target = cond = x) and every
    gradient, on the dispatched and on the flash route (the Pallas kernels in
    interpret mode; the port's autograd Function with the plain versions);
  * three Adam steps (schedule, clip, EMA) against JAX's make_train_step;
  * the in-training evals: `evaluate_acoustic` in 'single' (the first 70 %
    generated from the trailing context) and 'two_one', JAX's y0 handed to
    the port, and `evaluate_t2s` on a CoSingle model, greedy on both sides;
  * the train CLI with `--format hubert_fisher` and `--format text2semantic`:
    two steps with an eval and a top-k save, then `--resume` for a third (the
    two recipes' runs side by side in two processes).

Tolerances, as the VoMix / CoMix counterparts state them
(tests/test_torch_acoustic_train.py, test_torch_t2s_train.py,
test_torch_oracle_eval.py): `cfm_inputs` to 1e-6 (the same f32 arithmetic on
the same draws); the loss and each gradient leaf to GRAD_TOL = 1e-5 of its
scale; parameters and EMA after three Adam steps to 1e-2 of the learning rate;
the acoustic eval's l2 to 1e-4 relative (32 flow evaluations of summation-order
differences); the T2S eval's WER, accuracy and BLEU to 1e-12 (the same
greedy tokens)."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covomix_tpu.data import datasets as JD, tokenizer as JTok
from covomix_tpu.models import acoustic as JA, text2semantic as JT
from covomix_tpu.train import evaluate as JE, loop as JLoop
from covomix_tpu_torch.models import acoustic as PA, text2semantic as PT
from covomix_tpu_torch.ops import flash_attention as PF
from covomix_tpu_torch.train import evaluate as PE, loop as PLoop
from covomix_tpu_torch.util.misc import named_leaves, tree_leaves

from _torch_port import GREEDY_THRES, J_AC, port_cfg, to_port
from test_torch_acoustic_train import _assert_trees_close, _flash_dispatch_jax, _train_cfgs
from test_torch_t2s_train import write_t2s_items

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
J_VS = JA.AcousticConfig(dim_in=80, dim=32, depth=2, heads=2, dim_head=16, dim_phoneme_emb=16,
                         num_phoneme_tokens=502, mode="single")
P_VS = port_cfg(PA.AcousticConfig, J_VS)
J_CS = JT.T2SConfig(dim=32, source_depth=1, target_depth=1, heads=2, dim_head=16, num_text_tokens=200,
                    num_semantic_tokens=501, target_dim=32)
B, T = 3, 128
DROP = 0.3
INPUTS_TOL = 1e-6
GRAD_TOL = 1e-5
EVAL_RTOL = 1e-4
MASKS = ["batch_mask", "drawn_mask"]


def _end_mask(rs, b, t):
    """The hubert_fisher item's mask without --random_mask: one span of a
    uniform fraction in [0.5, 1) of the row, at its end."""
    mask = np.zeros((b, t), bool)
    for i in range(b):
        mask[i, t - int(rs.uniform(0.5, 1.0) * t):] = True
    return mask


def _batch(seed, with_mask=True):
    rs = np.random.RandomState(seed)
    batch = {"x": (rs.randn(B, T, 80) * 0.5).astype(np.float32),
             "phonemes": rs.randint(0, 502, (B, T)).astype(np.int32)}
    if with_mask:
        batch["mask"] = _end_mask(rs, B, T)
    return batch


def _vosingle_params(seed=0):
    """Tiny VoSingle parameters with the adaptive norms' projections made
    random (zero at init, when no gradient would reach the time embedding)."""
    jp = jax.jit(JA.init, static_argnums=1)(jax.random.PRNGKey(seed), J_VS)
    rs = np.random.RandomState(11)

    def perturb(path, x):
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        if name.endswith(("to_gamma/w", "to_beta/w")):
            return x + jnp.asarray(rs.randn(*x.shape).astype(np.float32) * 0.02)
        return x

    return jax.tree_util.tree_map_with_path(perturb, jp)


def _drop_key(batch):
    """A key whose cond-drop coin drops some rows and keeps others."""
    x = jnp.asarray(batch["x"])
    for seed in range(100):
        key = jax.random.PRNGKey(seed)
        drop = np.asarray(JA.cfm_inputs(J_VS, key, x, x, cond_drop_prob=DROP)[5])
        if drop.any() and not drop.all():
            return key
    raise AssertionError("no key drops some rows and keeps others")


def _jax_inputs(key, batch):
    """JAX's cfm_inputs of a VoSingle batch (target = cond = x), as tensors."""
    x = jnp.asarray(batch["x"])
    mask = None if batch.get("mask") is None else jnp.asarray(batch["mask"])
    return tuple(torch.from_numpy(np.array(r)) for r in JA.cfm_inputs(J_VS, key, x, x, mask, cond_drop_prob=DROP))


@pytest.mark.parametrize("mask", MASKS)
def test_vosingle_cfm_inputs_match_jax(mask, monkeypatch):
    """The port's cfm_inputs on JAX's raw draws (x0, t, the cond-drop
    uniforms from the same key splits; the training mask JAX draws when the
    batch carries none) gives JAX's w, times, flow, mask, masked cond and
    drop."""
    batch = _batch(3, with_mask=mask == "batch_mask")
    key = _drop_key(batch)
    k_noise, k_t, k_mask, k_drop = jax.random.split(key, 4)
    draws = [torch.from_numpy(np.array(jax.random.normal(k_noise, (B, T, 80), jnp.float32))),
             torch.from_numpy(np.array(jax.random.uniform(k_t, (B,)))),
             torch.from_numpy(np.array(jax.random.uniform(k_drop, (B,))))]
    monkeypatch.setattr(PA, "_draw", lambda sample, gen, shape, device, mesh=None: draws.pop(0))
    if mask == "drawn_mask":
        jmask = torch.from_numpy(np.array(JA.training_mask(k_mask, J_VS, B, T)))
        monkeypatch.setattr(PA, "training_mask", lambda gen, cfg, b, t, device=None, mesh=None: jmask)
    x = torch.from_numpy(batch["x"])
    got = PA.cfm_inputs(P_VS, None, x, x, None if "mask" not in batch else torch.from_numpy(batch["mask"]),
                        cond_drop_prob=DROP)
    assert not draws
    ref = _jax_inputs(key, batch)
    for name, g, r in zip(("w", "times", "flow", "mask", "cond", "drop"), got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        if g.dtype == torch.bool:
            assert torch.equal(g, r), name
        else:
            assert (g - r).abs().max().item() <= INPUTS_TOL, name
    assert got[3].any() and not got[3].all()          # some frames masked, some kept as prompt


@pytest.mark.parametrize("route", ["dispatched", "flash"])
@pytest.mark.parametrize("mask", MASKS)
def test_vosingle_loss_and_every_gradient_match_jax(mask, route, monkeypatch):
    """train.loop.acoustic_loss_fn on a VoSingle batch (target = cond = x)
    and the gradient of every parameter against jax.value_and_grad of JAX's
    acoustic_loss_fn, JAX's cfm_inputs handed to the port."""
    jp = _vosingle_params()
    batch = _batch(7, with_mask=mask == "batch_mask")
    key = _drop_key(batch)
    backward_calls = []
    if route == "flash":
        monkeypatch.setattr(JA, "attend_flash_or_xla", _flash_dispatch_jax)
        monkeypatch.setattr(PF, "use_flash_kernel", lambda **kw: True)
        plain_bwd = PF.flash_attention_bwd_plain
        monkeypatch.setattr(PF, "flash_attention_bwd_plain", lambda *a: backward_calls.append(1) or plain_bwd(*a))
    with jax.default_matmul_precision("highest"):
        loss_j, grads_j = jax.jit(jax.value_and_grad(JLoop.acoustic_loss_fn(J_VS, cond_drop_prob=DROP)))(
            jp, jax.tree_util.tree_map(jnp.asarray, batch), key)
        inputs = _jax_inputs(key, batch)
    monkeypatch.setattr(PA, "cfm_inputs", lambda *a, **kw: inputs)
    pp = to_port(jp)
    for p in tree_leaves(pp):
        p.requires_grad_(True)
    loss_p = PLoop.acoustic_loss_fn(P_VS, cond_drop_prob=DROP)(
        pp, {k: torch.from_numpy(v) for k, v in batch.items()}, None)
    loss_p.backward()
    assert backward_calls == ([1] * P_VS.depth if route == "flash" else [])
    assert abs(loss_p.item() - float(loss_j)) <= GRAD_TOL * abs(float(loss_j))
    flat_j = dict(named_leaves(jax.tree_util.tree_map(np.asarray, grads_j)))
    named = named_leaves(pp)
    assert sorted(flat_j) == sorted(n for n, _ in named)
    for name, p in named:
        ref = flat_j[name]
        assert p.grad is not None, name
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= GRAD_TOL * max(1.0, np.abs(ref).max()), (name, err)
    for name in ("phoneme_emb/w", "null_cond", "sinu_weights"):
        assert float(np.abs(flat_j[name]).max()) > 0, name


def test_vosingle_three_adam_steps_match_jax_make_train_step(monkeypatch):
    """Three optimizer steps of the VoSingle loss (loss, global norm, the
    clip, Adam at the schedule's rate, EMA) against JAX's make_train_step on
    the same batches (end masks, as the recipe's items carry them)."""
    jcfg, pcfg = _train_cfgs(grad_clip=0.25)    # the tiny VoSingle model's grad norms are ~0.8: the clip fires
    jp = _vosingle_params()
    batches = [_batch(20 + i) for i in range(3)]
    keys = [jax.random.PRNGKey(30 + i) for i in range(3)]
    with jax.default_matmul_precision("highest"):
        jstate = JLoop.init_train_state(jp, jcfg)
        jstep = JLoop.make_train_step(JLoop.acoustic_loss_fn(J_VS, cond_drop_prob=DROP), jcfg, donate=False)
        jmetrics = []
        for batch, key in zip(batches, keys):
            jstate, m = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch), key)
            jmetrics.append(m)
        pending = [_jax_inputs(key, batch) for batch, key in zip(batches, keys)]
    monkeypatch.setattr(PA, "cfm_inputs", lambda *a, **kw: pending.pop(0))
    pstate = PLoop.init_train_state(to_port(jp), pcfg)
    pstep = PLoop.make_train_step(PLoop.acoustic_loss_fn(P_VS, cond_drop_prob=DROP), pcfg)
    for i, batch in enumerate(batches):
        m = pstep(pstate, batch, None)
        assert abs(m["loss"].item() - float(jmetrics[i]["loss"])) <= GRAD_TOL * abs(float(jmetrics[i]["loss"]))
        gn = float(jmetrics[i]["grad_norm"])
        assert gn > pcfg.grad_clip and abs(m["grad_norm"].item() - gn) <= GRAD_TOL * gn
    assert not pending and pstate.step == 3 and pstate.ema_num_updates == 3
    _assert_trees_close(pstate.params, jstate.params, 1e-2 * pcfg.lr, "params")
    _assert_trees_close(pstate.ema_params, jstate.ema_params, 1e-2 * pcfg.lr, "ema")


def _write_acoustic_items(root, fmt, n, seed):
    """n short random items of `fmt` (frames 40-110, codes as strings)."""
    rs = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        t = 40 + 14 * i
        base = os.path.join(root, f"u{i}")
        np.save(base + ".mel.npy", (rs.randn(80, t) - 5).astype(np.float32))
        if fmt == "hubert_fisher":
            np.save(base + ".hubert_code.npy", rs.randint(0, 500, t).astype(str))
            continue
        for ch in "AB":
            np.save(f"{base}-{ch}.mel.npy", (rs.randn(80, t) - 5).astype(np.float32))
            np.save(f"{base}-{ch}.hubert_code.npy", rs.randint(0, 500, t).astype(str))


EVAL_MODES = {"single": ("hubert_fisher", J_VS), "two_one": ("hubert_overlap_two_input_one_output", J_AC)}


@pytest.mark.parametrize("mode", list(EVAL_MODES))
def test_evaluate_acoustic_matches_jax(tmp_path, mode, monkeypatch):
    """Both packages' in-training acoustic eval on the same weights and
    collated batches of rows of unequal length (pad frames MEL_PAD), JAX's
    y0 of each batch handed to the port's sampler: the same l2. 'single'
    generates the first 70 % of each row from its trailing context,
    'two_one' the second half of the mixed mel from the first."""
    fmt, jcfg = EVAL_MODES[mode]
    _write_acoustic_items(str(tmp_path), fmt, 5, seed=4)
    ds = JD.CoVoMixDataset(str(tmp_path), format=fmt, seed=0)
    batches = [JD.collate_acoustic([ds[i] for i in idx]) for idx in ((0, 1, 2), (3, 4))]
    jp = jax.jit(JA.init, static_argnums=1)(jax.random.PRNGKey(3), jcfg)
    noises = []
    j_sample = JA.sample

    def recording(params, cfg, key, phoneme_ids, cond, **kw):
        y0 = jax.random.normal(key, cond.shape[:2] + (cfg.mel_dim,), jnp.float32)
        jax.debug.callback(lambda n: noises.append(np.asarray(n).copy()), y0)
        return j_sample(params, cfg, key, phoneme_ids, cond, **kw)

    monkeypatch.setattr(JA, "sample", recording)
    with jax.default_matmul_precision("highest"):
        ref = JE.evaluate_acoustic(jp, jcfg, batches, jax.random.PRNGKey(5))
    assert len(noises) == len(batches)
    p_sample = PA.sample
    monkeypatch.setattr(PA, "sample", lambda *a, **kw: p_sample(*a, **kw, noise=torch.from_numpy(noises.pop(0))))
    got = PE.evaluate_acoustic(to_port(jp), port_cfg(PA.AcousticConfig, jcfg), batches,
                               torch.Generator().manual_seed(0))
    assert not noises and got.keys() == ref.keys() == {"l2"}
    assert np.isfinite(got["l2"]) and got["l2"] > 0
    assert got["l2"] == pytest.approx(float(ref["l2"]), rel=EVAL_RTOL)


def test_evaluate_t2s_cosingle_matches_jax(tmp_path, monkeypatch):
    """Both packages' evaluate_t2s on a CoSingle model (one output stream)
    and `--format text2semantic` batches, each decoding greedily: the same
    WER ('l2'), accuracy and token BLEU."""
    write_t2s_items(str(tmp_path), 6, seed=5, pair_every=0)
    jtok = JTok.load_covomix_tokenizer(None, strict=False)
    ds = JD.CoVoMixDataset(str(tmp_path), format="text2semantic", seed=0)
    batches = [JD.collate_t2s([ds[i] for i in range(j, j + 3)], jtok) for j in (0, 3)]
    assert batches[0]["semantic_ids"].ndim == 2
    jp = jax.jit(JT.init, static_argnums=1)(jax.random.PRNGKey(7), J_CS)
    jgen, pgen = JT.generate, PT.generate
    monkeypatch.setattr(JT, "generate", lambda *a, **kw: jgen(*a, **{**kw, "top_k_thres": GREEDY_THRES}))
    monkeypatch.setattr(PT, "generate", lambda *a, **kw: pgen(*a, **{**kw, "top_k_thres": GREEDY_THRES}))
    with jax.default_matmul_precision("highest"):
        ref = JE.evaluate_t2s(jp, J_CS, batches, jax.random.PRNGKey(0), max_length=40)
    out = PE.evaluate_t2s(to_port(jp), port_cfg(PT.T2SConfig, J_CS), batches, torch.Generator().manual_seed(0),
                          max_length=40)
    assert out.keys() == ref.keys() == {"l2", "accuracy", "token_bleu"}
    for key in ref:
        assert out[key] == pytest.approx(float(ref[key]), abs=1e-12), key
    assert 0 < out["l2"] <= 1


# the two single recipes at tiny widths: running_command/Acous_VoSingle.sh and T2S_CoSingle.sh's flags
# (the fallback vocab in place of --bert_vocab; target dim = dim, as T2S_CoSingle.sh leaves it)
RECIPES = {
    "vosingle": ["--format", "hubert_fisher", "--CoVoMix_dim", "80", "--CoVoMix_dim_transformer", "32",
                 "--CoVoMix_depth", "2", "--CoVoMix_heads", "2", "--CoVoMix_dim_head", "16",
                 "--CoVoMix_num_phoneme_tokens", "502", "--cond_drop_prob", "0.3"],
    "cosingle": ["--format", "text2semantic", "--text2semantic", "--allow_fallback_vocab",
                 "--CoVoMix_dim_transformer", "32", "--text2semantic_tokens", "501",
                 "--text2semantic_source_depth", "1", "--text2semantic_target_depth", "1",
                 "--text2semantic_head", "2", "--num_text_token_ids", "200"],
}


# the parameters those flags build: VoSingle's 80-d single-stream model, CoSingle's one-stream T2S
RECIPE_MODELS = {
    "vosingle": lambda: PA.init(torch.Generator().manual_seed(0), PA.AcousticConfig(
        dim_in=80, dim=32, depth=2, heads=2, dim_head=16, num_phoneme_tokens=502, mode="single")),
    "cosingle": lambda: PT.init(torch.Generator().manual_seed(0), PT.T2SConfig(
        dim=32, source_depth=1, target_depth=1, heads=2, num_text_tokens=200, num_semantic_tokens=501,
        target_dim=32, two_output=False)),
}


def _launch(data, logs, recipe, *extra):
    return subprocess.Popen(
        [sys.executable, "-m", "covomix_tpu_torch.train", "--device", "cpu", "--base_dir", str(data),
         *RECIPES[recipe], "--batch_size", "2", "--lr", "1e-4", "--lr_scheduler", "--log_dir", str(logs),
         "--run_name", recipe, "--log_every", "1", "--eval_every", "2", "--num_eval_files", "2",
         "--ckpt_every", "1000", "--no_wandb", *extra],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"})


def _finish(procs):
    """Wait for every process; {recipe: stdout}, failing on a non-zero exit."""
    out = {}
    for recipe, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=400)
        assert proc.returncode == 0, (recipe, stderr[-2500:])
        out[recipe] = stdout
    return out


@pytest.fixture(scope="module")
def recipe_runs(tmp_path_factory):
    """Both recipes through `python -m covomix_tpu_torch.train --device cpu`,
    side by side: two steps with an eval and a top-k save at step 2, then
    --resume for a third step. {recipe: (run dir, stdout of the resume)}."""
    root = tmp_path_factory.mktemp("single_recipes")
    _write_acoustic_items(str(root / "vosingle_data"), "hubert_fisher", 5, seed=2)
    write_t2s_items(str(root / "cosingle_data"), 5, seed=2, pair_every=0)
    _finish({r: _launch(root / f"{r}_data", root / "logs", r, "--max_steps", "2") for r in RECIPES})
    resumed = _finish({r: _launch(root / f"{r}_data", root / "logs", r, "--max_steps", "3", "--resume")
                       for r in RECIPES})
    return {r: (root / "logs" / r, resumed[r]) for r in RECIPES}


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_single_recipe_train_cli_two_steps_then_resume(recipe_runs, recipe):
    run, resume_out = recipe_runs[recipe]
    lines = [json.loads(line) for line in open(run / "metrics.jsonl") if line.strip()]
    steps = [rec for rec in lines if "train_loss" in rec]
    assert [rec["step"] for rec in steps] == [1, 2, 3]
    assert all(np.isfinite(rec["train_loss"]) and np.isfinite(rec["grad_norm"]) for rec in steps)
    evals = [rec for rec in lines if "eval_l2" in rec]
    assert len(evals) == 1 and np.isfinite(evals[0]["eval_l2"])
    if recipe == "cosingle":
        assert {"eval_accuracy", "eval_token_bleu"} <= evals[0].keys() and 0 <= evals[0]["eval_l2"] <= 1
    assert "resumed from step 2" in resume_out
    ckpt = run / "checkpoints"
    assert json.load(open(ckpt / "topk.json"))["best_step"] == 2
    assert sorted(os.listdir(ckpt)) == ["step_00000002", "step_00000003", "topk.json"]
    with np.load(ckpt / "step_00000003" / "state.npz") as z:
        assert int(z["step"]) == 3 and int(z["adam_step"]) == 3 and int(z["ema_num_updates"]) == 3
        saved = {k[len("params/"):]: z[k].shape for k in z.files if k.startswith("params/")}
    assert saved == {name: tuple(p.shape) for name, p in named_leaves(RECIPE_MODELS[recipe]())}
    with open(run / "args.txt") as f:
        args = json.load(f)
    assert args["format"] == RECIPES[recipe][1] and not args["bf16"]
