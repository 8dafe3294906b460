"""The acoustic training configurations that no recipe script sets, against
the JAX package at tiny widths, f32 at 'highest' precision:

  * VoMix `two_two` (`--format hubert_overlap_two_input_two_output
    --twocondition_twooutput --CoVoMix_dim 160`: the A and B channel mels
    are both the condition and the 160-d target, two phoneme streams, no
    mixed mel on disk);
  * the `default` format (a mel and its `.phone_by_frame.npy`, cropped at
    1600 frames, the single-stream model);
  * `--dummy` (1/150 of the files, before the every-10th-file eval split);
  * `--grad_accum 2` with `--num_workers 2` (a prefetch thread).

What is held:
  * the dataset items of both formats (same files, seed, crops and masks,
    bit for bit) and the `--dummy` file list;
  * `two_two`'s `cfm_inputs` on JAX's draws, its loss and every gradient on
    the dispatched and the flash route (the Pallas kernels in interpret
    mode; the port's autograd Function with the plain versions), three Adam
    steps against JAX's make_train_step, `evaluate_acoustic` with JAX's y0,
    and the weight carry of a `two_two` tree;
  * the train CLI against JAX's train.py on the same files and flags: the
    port's run is given JAX's initial parameters and JAX's key chain (one
    split a step, split again over the micro-batches; one split an eval, one
    per eval batch), so every logged loss, grad norm, epoch and eval l2 must
    agree: `two_two` and `default --dummy` for two steps with an eval and a
    top-k save, then `--resume` for a third; VoMix with `--grad_accum 2
    --num_workers 2` for two steps.

Tolerances, as tests/test_torch_acoustic_train.py states them: `cfm_inputs`
to 1e-6 (the same f32 arithmetic on the same draws); the loss and each
gradient leaf to GRAD_TOL = 1e-5 of its scale (summation order); parameters
and EMA after three Adam steps to 1e-2 of the learning rate (Adam divides each
gradient element by its own magnitude); an eval's l2 to 1e-4 relative (32
flow evaluations of summation-order differences). The CLI runs hold each
step's loss and grad norm to GRAD_TOL relative: JAX's train step runs jitted
at XLA's default precision, which on the CPU is full f32."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covomix_tpu.data import datasets as JD
from covomix_tpu.models import acoustic as JA
from covomix_tpu.train import evaluate as JE, loop as JLoop
from covomix_tpu_torch.checkpoint.io import params_from_numpy
from covomix_tpu_torch.data import datasets as PD
from covomix_tpu_torch.models import acoustic as PA
from covomix_tpu_torch.ops import flash_attention as PF
from covomix_tpu_torch.train import cli, evaluate as PE, loop as PLoop
from covomix_tpu_torch.util.misc import named_leaves, tree_leaves

from _torch_port import port_cfg, to_port
from test_torch_acoustic_train import _assert_trees_close, _flash_dispatch_jax, _train_cfgs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
J_TT = JA.AcousticConfig(dim_in=160, dim=32, depth=2, heads=2, dim_head=16, dim_phoneme_emb=16,
                         num_phoneme_tokens=502, mode="two_two")
P_TT = port_cfg(PA.AcousticConfig, J_TT)
TWO_TWO = "hubert_overlap_two_input_two_output"
B, T = 3, 128
DROP = 0.3
INPUTS_TOL = 1e-6
GRAD_TOL = 1e-5
EVAL_RTOL = 1e-4
MASKS = ["batch_mask", "drawn_mask"]


def _write_two_two(root, lengths, seed):
    """Items of the two_two layout: u<i>-A / -B .mel.npy [80, t] and their
    codes (string arrays, 3 codes longer than the mel; item 1's A channel as
    `-16k` codes, which the dataset prefers); no base u<i>.mel.npy."""
    rs = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    for i, t in enumerate(lengths):
        for ch in "AB":
            base = os.path.join(root, f"u{i}-{ch}")
            np.save(base + ".mel.npy", (rs.randn(80, t) - 5).astype(np.float32))
            codes = ".hubert_code.npy" if (i, ch) != (1, "A") else "-16k.hubert_code.npy"
            np.save(base + codes, rs.randint(0, 500, t + 3).astype(str))


def _write_default(root, lengths, seed, names=None):
    """Items of the default layout: u<i>.mel.npy [80, t] and
    u<i>.phone_by_frame.npy (integers, 2 frames short of the mel)."""
    rs = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    for i, t in enumerate(lengths):
        base = os.path.join(root, names[i] if names else f"u{i}")
        np.save(base + ".mel.npy", (rs.randn(80, t) - 5).astype(np.float32))
        np.save(base + ".phone_by_frame.npy", rs.randint(0, 500, t - 2))


def _write_two_one(root, n, t, seed):
    """VoMix items: u<i>.mel.npy (mixed) beside the -A / -B mels and codes."""
    rs = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        base = os.path.join(root, f"u{i}")
        np.save(base + ".mel.npy", (rs.randn(80, t) - 5).astype(np.float32))
        for ch in "AB":
            np.save(f"{base}-{ch}.mel.npy", (rs.randn(80, t) - 5).astype(np.float32))
            np.save(f"{base}-{ch}.hubert_code.npy", rs.randint(0, 500, t).astype(str))


# format -> (writer of 6 items spanning the crop, the crop, x's width)
ITEMS = {TWO_TWO: (lambda root: _write_two_two(root, [600, 760, 800, 860, 930, 1000], 1), 800, 160),
         "default": (lambda root: _write_default(root, [1500, 1598, 1602, 1700, 2000, 2400], 1), 1600, 80)}


@pytest.mark.parametrize("fmt", list(ITEMS))
def test_dataset_items_match_jax(tmp_path, fmt):
    """The port's dataset against JAX's on the same files and seed: the file
    list (two_two: the base names of the -A mels, whose base .mel.npy does
    not exist), each item over two passes (random crops, masks at the end or
    anywhere), the centred crop of an eval dataset, and collated batches,
    bit for bit."""
    write, crop, width = ITEMS[fmt]
    write(str(tmp_path))
    for random_mask, shuffle_spec in ((False, True), (True, True), (False, False)):
        jds = JD.CoVoMixDataset(str(tmp_path), format=fmt, random_mask=random_mask, shuffle_spec=shuffle_spec,
                                seed=5)
        pds = PD.CoVoMixDataset(str(tmp_path), format=fmt, random_mask=random_mask, shuffle_spec=shuffle_spec,
                                seed=5)
        assert pds.files == jds.files and len(pds) == 6
        if fmt == TWO_TWO:
            assert not any(os.path.exists(f) for f in pds.files)
        for _ in range(2):
            for i in range(len(pds)):
                ji, pi = jds[i], pds[i]
                assert ji.keys() == pi.keys() == {"x", "phonemes", "mask"}
                for key in ji:
                    assert ji[key].dtype == pi[key].dtype and np.array_equal(ji[key], pi[key]), (i, key)
                assert pi["x"].shape[1] == width and len(pi["mask"]) <= crop
        assert pi["phonemes"].ndim == (2 if fmt == TWO_TWO else 1)
        jb = JD.collate_acoustic([jds[i] for i in (5, 0, 3)])
        pb = PD.collate_acoustic([pds[i] for i in (5, 0, 3)])
        assert all(np.array_equal(jb[k], pb[k]) for k in jb) and pb["x"].shape[1] == crop + (32 if crop == 800 else 0)


# format -> the files to create (empty: only the listing is read), of which --dummy keeps the first 2
DUMMY_FILES = {TWO_TWO: lambda i: [f"u{i:03d}-A.mel.npy", f"u{i:03d}-B.mel.npy"],
               "default": lambda i: [f"u{i:03d}.mel.npy"],
               "text2semantic_2output": lambda i: [f"u{i:03d}.hubert_code.npy"] + (
                   [f"p{i:03d}_1.hubert_code.npy", f"p{i:03d}_2.hubert_code.npy"] if i % 3 == 0 else [])}


@pytest.mark.parametrize("fmt", list(DUMMY_FILES))
def test_dummy_keeps_the_jax_packages_files(tmp_path, fmt):
    """`--dummy` keeps the first len // 150 of the sorted list (at least one)
    in both packages, after the format's own filtering (the -A base names;
    no _2 pair files), and the short-utterance pool follows it."""
    n = 320
    for i in range(n):
        for name in DUMMY_FILES[fmt](i):
            open(tmp_path / name, "w").close()
    for dummy in (False, True):
        jds = JD.CoVoMixDataset(str(tmp_path), format=fmt, dummy=dummy)
        pds = PD.CoVoMixDataset(str(tmp_path), format=fmt, dummy=dummy)
        assert pds.files == jds.files and pds.short_files == jds.short_files
    full = len(PD.CoVoMixDataset(str(tmp_path), format=fmt).files)
    assert len(pds.files) == full // 150 >= 2 and pds.files == sorted(pds.files)
    (tmp_path / "only").mkdir()
    for name in DUMMY_FILES[fmt](0):
        open(tmp_path / "only" / name, "w").close()
    assert len(PD.CoVoMixDataset(str(tmp_path / "only"), format=fmt, dummy=True)) == 1


def _two_two_params(seed=0):
    """Tiny two_two parameters with the adaptive norms' projections made
    random (zero at init, when no gradient would reach the time embedding)."""
    jp = jax.jit(JA.init, static_argnums=1)(jax.random.PRNGKey(seed), J_TT)
    rs = np.random.RandomState(11)

    def perturb(path, x):
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        if name.endswith(("to_gamma/w", "to_beta/w")):
            return x + jnp.asarray(rs.randn(*x.shape).astype(np.float32) * 0.02)
        return x

    return jax.tree_util.tree_map_with_path(perturb, jp)


def _batch(seed, with_mask=True):
    """A two_two batch: x = [mel_A | mel_B] (160-d), two phoneme streams and,
    as the items carry it, one span of 30-70 % of each row."""
    rs = np.random.RandomState(seed)
    batch = {"x": (rs.randn(B, T, 160) * 0.5).astype(np.float32),
             "phonemes": rs.randint(0, 502, (B, T, 2)).astype(np.int32)}
    if with_mask:
        mask = np.zeros((B, T), bool)
        for i in range(B):
            n = int(rs.uniform(0.3, 0.7) * T)
            s = rs.randint(0, T - n)
            mask[i, s:s + n] = True
        batch["mask"] = mask
    return batch


def _drop_key(batch):
    """A key whose cond-drop coin drops some rows and keeps others."""
    x = jnp.asarray(batch["x"])
    for seed in range(100):
        key = jax.random.PRNGKey(seed)
        drop = np.asarray(JA.cfm_inputs(J_TT, key, x, x, cond_drop_prob=DROP)[5])
        if drop.any() and not drop.all():
            return key
    raise AssertionError("no key drops some rows and keeps others")


def _jax_inputs(key, batch):
    """JAX's cfm_inputs of a two_two batch (target = cond = x), as tensors."""
    x = jnp.asarray(batch["x"])
    mask = None if batch.get("mask") is None else jnp.asarray(batch["mask"])
    return tuple(torch.from_numpy(np.array(r)) for r in JA.cfm_inputs(J_TT, key, x, x, mask, cond_drop_prob=DROP))


@pytest.mark.parametrize("mask", MASKS)
def test_two_two_cfm_inputs_match_jax(mask, monkeypatch):
    """The port's cfm_inputs on JAX's raw draws (x0 over all 160 dims, t, the
    cond-drop uniforms; the training mask JAX draws when the batch carries
    none) gives JAX's w, times, flow, mask, masked cond and drop."""
    batch = _batch(3, with_mask=mask == "batch_mask")
    key = _drop_key(batch)
    k_noise, k_t, k_mask, k_drop = jax.random.split(key, 4)
    draws = [torch.from_numpy(np.array(jax.random.normal(k_noise, (B, T, 160), jnp.float32))),
             torch.from_numpy(np.array(jax.random.uniform(k_t, (B,)))),
             torch.from_numpy(np.array(jax.random.uniform(k_drop, (B,))))]
    monkeypatch.setattr(PA, "_draw", lambda sample, gen, shape, device, mesh=None: draws.pop(0))
    if mask == "drawn_mask":
        jmask = torch.from_numpy(np.array(JA.training_mask(k_mask, J_TT, B, T)))
        monkeypatch.setattr(PA, "training_mask", lambda gen, cfg, b, t, device=None, mesh=None: jmask)
    x = torch.from_numpy(batch["x"])
    got = PA.cfm_inputs(P_TT, None, x, x, torch.from_numpy(batch["mask"]) if "mask" in batch else None,
                        cond_drop_prob=DROP)
    assert not draws
    ref = _jax_inputs(key, batch)
    for name, g, r in zip(("w", "times", "flow", "mask", "cond", "drop"), got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        if g.dtype == torch.bool:
            assert torch.equal(g, r), name
        else:
            assert (g - r).abs().max().item() <= INPUTS_TOL, name
    assert got[0].shape == (B, T, 160) and got[3].any() and not got[3].all()


@pytest.mark.parametrize("route", ["dispatched", "flash"])
def test_two_two_loss_and_every_gradient_match_jax(route, monkeypatch):
    """train.loop.acoustic_loss_fn on a two_two batch (target = cond = x, all
    160 dims) and the gradient of every parameter against
    jax.value_and_grad of JAX's acoustic_loss_fn, JAX's cfm_inputs handed to
    the port; the to_embed rows of x (the first 160) and of the condition
    (past the phoneme embeddings) both carry gradient."""
    jp = _two_two_params()
    batch = _batch(7)
    key = _drop_key(batch)
    backward_calls = []
    if route == "flash":
        monkeypatch.setattr(JA, "attend_flash_or_xla", _flash_dispatch_jax)
        monkeypatch.setattr(PF, "use_flash_kernel", lambda **kw: True)
        plain_bwd = PF.flash_attention_bwd_plain
        monkeypatch.setattr(PF, "flash_attention_bwd_plain", lambda *a: backward_calls.append(1) or plain_bwd(*a))
    with jax.default_matmul_precision("highest"):
        loss_j, grads_j = jax.jit(jax.value_and_grad(JLoop.acoustic_loss_fn(J_TT, cond_drop_prob=DROP)))(
            jp, jax.tree_util.tree_map(jnp.asarray, batch), key)
        inputs = _jax_inputs(key, batch)
    monkeypatch.setattr(PA, "cfm_inputs", lambda *a, **kw: inputs)
    pp = to_port(jp)
    for p in tree_leaves(pp):
        p.requires_grad_(True)
    loss_p = PLoop.acoustic_loss_fn(P_TT, cond_drop_prob=DROP)(pp, {k: torch.from_numpy(v) for k, v in batch.items()},
                                                               None)
    loss_p.backward()
    assert backward_calls == ([1] * P_TT.depth if route == "flash" else [])
    assert abs(loss_p.item() - float(loss_j)) <= GRAD_TOL * abs(float(loss_j))
    flat_j = dict(named_leaves(jax.tree_util.tree_map(np.asarray, grads_j)))
    named = named_leaves(pp)
    assert sorted(flat_j) == sorted(n for n, _ in named)
    for name, p in named:
        ref = flat_j[name]
        assert p.grad is not None, name
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= GRAD_TOL * max(1.0, np.abs(ref).max()), (name, err)
    emb = flat_j["to_embed/w"]
    assert emb.shape == (2 * 160 + 2 * 16, 32)
    assert np.abs(emb[:160]).max() > 0 and np.abs(emb[160 + 32:]).max() > 0
    for name in ("phoneme_emb/w", "null_cond", "sinu_weights"):
        assert float(np.abs(flat_j[name]).max()) > 0, name


def test_two_two_three_adam_steps_match_jax_make_train_step(monkeypatch):
    """Three optimizer steps of the two_two loss (loss, global norm, the
    clip, Adam at the schedule's rate, EMA) against JAX's make_train_step on
    the same batches."""
    jcfg, pcfg = _train_cfgs(grad_clip=0.25)
    jp = _two_two_params()
    batches = [_batch(20 + i) for i in range(3)]
    keys = [jax.random.PRNGKey(30 + i) for i in range(3)]
    with jax.default_matmul_precision("highest"):
        jstate = JLoop.init_train_state(jp, jcfg)
        jstep = JLoop.make_train_step(JLoop.acoustic_loss_fn(J_TT, cond_drop_prob=DROP), jcfg, donate=False)
        jmetrics = []
        for batch, key in zip(batches, keys):
            jstate, m = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch), key)
            jmetrics.append(m)
        pending = [_jax_inputs(key, batch) for batch, key in zip(batches, keys)]
    monkeypatch.setattr(PA, "cfm_inputs", lambda *a, **kw: pending.pop(0))
    pstate = PLoop.init_train_state(to_port(jp), pcfg)
    pstep = PLoop.make_train_step(PLoop.acoustic_loss_fn(P_TT, cond_drop_prob=DROP), pcfg)
    for i, batch in enumerate(batches):
        m = pstep(pstate, batch, None)
        assert abs(m["loss"].item() - float(jmetrics[i]["loss"])) <= GRAD_TOL * abs(float(jmetrics[i]["loss"]))
        gn = float(jmetrics[i]["grad_norm"])
        assert gn > pcfg.grad_clip and abs(m["grad_norm"].item() - gn) <= GRAD_TOL * gn
    assert not pending and pstate.step == 3 and pstate.ema_num_updates == 3
    _assert_trees_close(pstate.params, jstate.params, 1e-2 * pcfg.lr, "params")
    _assert_trees_close(pstate.ema_params, jstate.ema_params, 1e-2 * pcfg.lr, "ema")


def test_evaluate_acoustic_two_two_matches_jax(tmp_path, monkeypatch):
    """Both packages' in-training eval in two_two on the same weights and
    collated batches of rows of unequal length: the second half of both
    channels generated from the first, scored over all 160 dims; JAX's y0 of
    each batch handed to the port's sampler. The same l2."""
    _write_two_two(str(tmp_path), [60, 74, 88, 102, 116], 4)
    ds = JD.CoVoMixDataset(str(tmp_path), format=TWO_TWO, seed=0)
    batches = [JD.collate_acoustic([ds[i] for i in idx]) for idx in ((0, 1, 2), (3, 4))]
    assert batches[0]["x"].shape[-1] == 160 and batches[0]["phonemes"].ndim == 3
    jp = jax.jit(JA.init, static_argnums=1)(jax.random.PRNGKey(3), J_TT)
    noises = []
    j_sample = JA.sample

    def recording(params, cfg, key, phoneme_ids, cond, **kw):
        y0 = jax.random.normal(key, cond.shape[:2] + (cfg.mel_dim,), jnp.float32)
        jax.debug.callback(lambda n: noises.append(np.asarray(n).copy()), y0)
        return j_sample(params, cfg, key, phoneme_ids, cond, **kw)

    monkeypatch.setattr(JA, "sample", recording)
    with jax.default_matmul_precision("highest"):
        ref = JE.evaluate_acoustic(jp, J_TT, batches, jax.random.PRNGKey(5))
    assert len(noises) == len(batches) and noises[0].shape[-1] == 160
    p_sample = PA.sample
    monkeypatch.setattr(PA, "sample", lambda *a, **kw: p_sample(*a, **kw, noise=torch.from_numpy(noises.pop(0))))
    got = PE.evaluate_acoustic(to_port(jp), P_TT, batches, torch.Generator().manual_seed(0))
    assert not noises and got.keys() == ref.keys() == {"l2"}
    assert np.isfinite(got["l2"]) and got["l2"] > 0
    assert got["l2"] == pytest.approx(float(ref["l2"]), rel=EVAL_RTOL)


def test_params_from_numpy_carries_a_two_two_tree():
    """The weight carry of a two_two tree at the recipe's phoneme-embedding
    width: to_embed [2 x 160 + 2 x 1024, dim], to_pred [dim, 160], every
    leaf under its name and bit for bit, and the port's own init of the
    same config draws the same names and shapes."""
    jcfg = dataclasses.replace(J_TT, dim_phoneme_emb=1024)
    jp = jax.jit(JA.init, static_argnums=1)(jax.random.PRNGKey(2), jcfg)
    flat = dict(named_leaves(jax.tree_util.tree_map(np.asarray, jp)))
    pp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    assert tuple(pp["to_embed"]["w"].shape) == (2 * 160 + 2 * 1024, 32)
    assert tuple(pp["to_pred"]["w"].shape) == (32, 160)
    named = dict(named_leaves(pp))
    assert named.keys() == flat.keys()
    assert all(named[k].dtype == torch.float32 and np.array_equal(named[k].numpy(), flat[k]) for k in flat)
    own = PA.init(torch.Generator().manual_seed(0), port_cfg(PA.AcousticConfig, jcfg))
    assert {k: tuple(v.shape) for k, v in named_leaves(own)} == {k: v.shape for k, v in flat.items()}


# ---------------------------------------------------------------------------
# the train CLI against JAX's train.py

TINY = ["--CoVoMix_dim_transformer", "32", "--CoVoMix_depth", "2", "--CoVoMix_heads", "2", "--CoVoMix_dim_head", "16",
        "--cond_drop_prob", "0.3", "--batch_size", "2", "--lr", "1e-4", "--lr_scheduler", "--log_every", "1",
        "--ckpt_every", "1000", "--no_wandb", "--seed", "0", "--dp", "1"]
# name -> (data dir, flags, grad_accum, eval after these steps, resume for a third step)
CLI_RUNS = {
    "two_two": ("two_two", ["--format", TWO_TWO, "--twocondition_twooutput", "--CoVoMix_dim", "160",
                            "--random_mask", "--eval_every", "2", "--num_eval_files", "2"], 1, (2,), True),
    "default_dummy": ("default", ["--format", "default", "--dummy", "--eval_every", "2", "--num_eval_files", "2"],
                      1, (2,), True),
    "vomix_accum_workers": ("two_one", ["--format", "hubert_overlap_two_input_one_output",
                                        "--twocondition_oneoutput", "--CoVoMix_dim", "160", "--random_mask",
                                        "--grad_accum", "2", "--num_workers", "2", "--num_eval_files", "0"],
                            2, (), False),
}
# the JAX runs of one CLI_RUNS entry in one child process (one import of jax and train.py; the resume hits
# the persistent compile cache of the first run), its TensorBoard events through TensorBoard's own file
# layer, as the port's logger writes them (TensorFlow's import is the slowest part of a child's start)
JAX_DRIVER = ("import json, sys, types\n"
              "sys.modules['tensorboard.compat.notf'] = types.ModuleType('tensorboard.compat.notf')\n"
              "import train\n"
              "for argv in json.loads(sys.argv[1]):\n"
              "    sys.argv = ['train.py', *argv]\n"
              "    train.main()\n")


def _write_cli_data(root):
    """two_two: 5 items of 820-900 frames (cropped at 800, bucket 832);
    default: 1500 files, of which --dummy keeps the first 10 (1700-1790
    frames, cropped at 1600; the every-10th split holds the first out for
    the eval), the others 8 frames long and never read; two_one: 6 items of
    56 frames (one bucket, so grad_accum's micro-batches stack)."""
    _write_two_two(str(root / "two_two"), [820, 840, 860, 880, 900], 2)
    _write_default(str(root / "default"), [1700 + 10 * i for i in range(10)] + [8] * 1490, 2,
                   names=[f"u{i:04d}" for i in range(1500)])
    _write_two_one(str(root / "two_one"), 6, 56, 2)


def _argv(root, name, side, resume):
    """The flags of run `name` for `side` ("jax" or "port"): two steps, or
    with `resume` a third from the second's checkpoint."""
    data, flags = CLI_RUNS[name][:2]
    return (["--base_dir", str(root / data), *flags, *TINY, "--log_dir", str(root / side), "--run_name", name]
            + (["--max_steps", "3", "--resume"] if resume else ["--max_steps", "2"]))


class JaxKeys:
    """JAX's train.py draws for one run of the port's CLI, from
    PRNGKey(seed) as train.py splits it: one split a step (under grad_accum
    split again over the micro-batches), one more after a step that
    evaluates; in the eval one split a batch, the batch's y0 drawn from it.
    The port's cfm_inputs and sample take them in call order."""

    def __init__(self, jcfg, steps, accum, evals):
        self.jcfg, key = jcfg, jax.random.PRNGKey(0)
        self.train, self.evals, self.eval_key = [], [], None
        for step in range(1, steps + 1):
            key, sub = jax.random.split(key)
            self.train += list(jax.random.split(sub, accum)) if accum > 1 else [sub]
            if step in evals:
                key, sub = jax.random.split(key)
                self.evals.append(sub)

    def cfm_inputs(self, cfg, gen, x1, cond, mask=None, *, cond_drop_prob=0.0, **kw):
        self.eval_key = None
        res = JA.cfm_inputs(self.jcfg, self.train.pop(0), jnp.asarray(x1.numpy()), jnp.asarray(cond.numpy()),
                            None if mask is None else jnp.asarray(mask.numpy()), cond_drop_prob=cond_drop_prob)
        return tuple(None if r is None else torch.from_numpy(np.array(r)) for r in res)

    def noise(self, cond):
        """y0 of the next eval batch (the first batch of an eval takes the
        eval's key)."""
        if self.eval_key is None:
            self.eval_key = self.evals.pop(0)
        self.eval_key, sub = jax.random.split(self.eval_key)
        return torch.from_numpy(np.array(jax.random.normal(sub, tuple(cond.shape[:2]) + (self.jcfg.mel_dim,),
                                                           jnp.float32)))


def _port_run(root, name, resume):
    """The port's CLI in this process on JAX's initial parameters and key
    chain (JaxKeys: a resumed run starts the chain afresh, as train.py
    does); returns the number of keys left unused."""
    accum, evals = CLI_RUNS[name][2:4]
    first = 3 if resume else 1
    holder = {}
    p_sample = PA.sample

    def init(gen, cfg):
        holder["keys"] = JaxKeys(JA.AcousticConfig(**dataclasses.asdict(cfg)), 1 if resume else 2, accum,
                                 [s - first + 1 for s in evals if s >= first])
        return to_port(JA.init(jax.random.PRNGKey(0), holder["keys"].jcfg))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PA, "init", init)
        mp.setattr(PA, "cfm_inputs", lambda *a, **kw: holder["keys"].cfm_inputs(*a, **kw))
        mp.setattr(PA, "sample", lambda params, cfg, gen, ph, cond, **kw: p_sample(
            params, cfg, gen, ph, cond, **kw, noise=holder["keys"].noise(cond)))
        cli.main(["--device", "cpu", *_argv(root, name, "port", resume)])
    return len(holder["keys"].train) + len(holder["keys"].evals)


def _records(run_dir):
    recs = [json.loads(line) for line in open(run_dir / "metrics.jsonl") if line.strip()]
    return ({r["step"]: r for r in recs if "train_loss" in r},
            {r["step"]: r["eval_l2"] for r in recs if "eval_l2" in r})


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Every CLI_RUNS run through JAX's train.py (one child process each,
    side by side, f32 on the CPU) and through the port's CLI (in this
    process, meanwhile):
    {name: (JAX run dir, port run dir, keys the port left unused)}."""
    root = tmp_path_factory.mktemp("recipe_cli")
    _write_cli_data(root)
    resumes = {name: (False, True) if CLI_RUNS[name][4] else (False,) for name in CLI_RUNS}
    children = {}
    for name in CLI_RUNS:
        runs = [_argv(root, name, "jax", resume) for resume in resumes[name]]
        children[name] = subprocess.Popen(
            [sys.executable, "-c", JAX_DRIVER, json.dumps(runs)], cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
            env={**os.environ, "COVOMIX_FORCE_CPU": "1", "JAX_PLATFORMS": "cpu",
                 "COVOMIX_JAX_CACHE": str(root / f"jax_cache_{name}")})
    try:
        left = {name: [_port_run(root, name, resume) for resume in resumes[name]] for name in CLI_RUNS}
    finally:
        done = {name: child.communicate(timeout=600) for name, child in children.items()}
    for name, child in children.items():
        assert child.returncode == 0, (name, done[name][1][-3000:])
    return {name: (root / "jax" / name, root / "port" / name, left[name]) for name in CLI_RUNS}


@pytest.mark.parametrize("name", list(CLI_RUNS))
def test_train_cli_matches_jax_train_py(cli_runs, name):
    """The port's CLI against JAX's train.py: the same steps logged with the
    same epochs, each step's loss and grad norm within GRAD_TOL relative
    (the same items, initial parameters, draws, schedule, accumulation and,
    after --resume, the same state read back), the same eval l2 within
    EVAL_RTOL, every JAX key taken, the same checkpoint steps and top-k
    pick, and the parameters saved under the names and shapes of JAX's
    model."""
    jax_dir, port_dir, left = cli_runs[name]
    accum, evals, resume = CLI_RUNS[name][2:]
    assert left == [0] * len(left)
    (jsteps, jevals), (psteps, pevals) = _records(jax_dir), _records(port_dir)
    want = [1, 2, 3] if resume else [1, 2]
    assert sorted(jsteps) == sorted(psteps) == want
    for step in want:
        j, p = jsteps[step], psteps[step]
        assert p["epoch"] == j["epoch"], step
        for key in ("train_loss", "grad_norm"):
            assert np.isfinite(p[key]) and abs(p[key] - j[key]) <= GRAD_TOL * abs(j[key]), (step, key, p[key], j[key])
    assert sorted(pevals) == sorted(jevals) == list(evals)
    for step in evals:
        assert pevals[step] == pytest.approx(jevals[step], rel=EVAL_RTOL)
    ckpt = port_dir / "checkpoints"
    assert sorted(os.listdir(ckpt)) == sorted(os.listdir(jax_dir / "checkpoints"))
    if evals:
        assert json.load(open(ckpt / "topk.json"))["best_step"] == json.load(
            open(jax_dir / "checkpoints" / "topk.json"))["best_step"] == 2
    last = want[-1]
    with np.load(ckpt / f"step_{last:08d}" / "state.npz") as z:
        assert int(z["step"]) == int(z["adam_step"]) == int(z["ema_num_updates"]) == last
        saved = {k[len("params/"):]: z[k].shape for k in z.files if k.startswith("params/")}
    with open(jax_dir / "args.txt") as f:
        jargs = json.load(f)
    jcfg = JA.AcousticConfig(dim_in=jargs["CoVoMix_dim"], dim=32, depth=2, heads=2, dim_head=16,
                             mode="two_two" if jargs["twocondition_twooutput"] else (
                                 "two_one" if jargs["twocondition_oneoutput"] else "single"))
    shapes = jax.eval_shape(lambda: JA.init(jax.random.PRNGKey(0), jcfg))
    assert saved == {n: tuple(s.shape) for n, s in named_leaves(shapes)}
    with open(port_dir / "args.txt") as f:
        pargs = json.load(f)
    assert pargs.keys() - jargs.keys() == {"device"}
    assert all(pargs[k] == v for k, v in jargs.items() if k != "log_dir")
