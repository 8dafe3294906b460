"""`make_multi_step` (K optimizer steps per call, `--steps_per_dispatch`) of
the port against the JAX package's on the CPU, where the port runs the K
steps directly (on CUDA it captures them as one CUDA graph; chip_smoke.py
phase 22 holds that form against the eager steps on the card).

  * against JAX's `make_multi_step` on the same stacked batches, JAX's draws
    (`fold_in(key, i)`, split over the micro-batches under grad_accum)
    handed to the port: tiny VoMix with the clip firing and the schedule
    crossing an epoch inside the dispatch, the same with grad_accum=2, and
    tiny CoMix T2S (its loss draws nothing). The tolerances of
    test_torch_acoustic_train.py: loss and grad norm to 1e-5 relative,
    parameters and EMA to 1e-2 of the learning rate;
  * against K of the port's own `make_train_step` calls, bit for bit, on one
    generator seed (the generator's next draw included);
  * the train CLI's `--steps_per_dispatch`: the overshoot to a whole
    dispatch, JAX's `crossed()` cadence, the checkpoint of one step a
    dispatch bit for bit, and a resume at a dispatch boundary."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covomix_tpu.models import acoustic as JA, text2semantic as JT
from covomix_tpu.train import loop as JLoop
from covomix_tpu_torch.checkpoint import io as cio
from covomix_tpu_torch.models import acoustic as PA
from covomix_tpu_torch.train import cli, loop as PLoop
from covomix_tpu_torch.util.misc import named_leaves, tree_leaves, tree_map

from _torch_port import J_AC, J_T2S, P_AC, P_T2S, jax_params, to_port

B, T = 3, 128
GRAD_TOL = 1e-5
DROP = 0.3


def _vomix_batch(rs, lead):
    """A VoMix batch with leading axes `lead` (e.g. (K,) or (K, A)), one
    random span of the mask a row."""
    mask = np.zeros(lead + (B, T), bool)
    start = rs.randint(0, T // 2, lead + (B,))
    idx = np.arange(T)
    mask[...] = (idx >= start[..., None]) & (idx < start[..., None] + T // 3)
    return {"x": (rs.randn(*lead, B, T, 240) * 0.5).astype(np.float32),
            "phonemes": rs.randint(0, 502, lead + (B, T, 2)).astype(np.int32), "mask": mask}


def _t2s_batch(rs, k):
    text = rs.randint(1, 200, (k, B, 12)).astype(np.int32)
    text[:, 1, 7:] = 0
    sem = rs.randint(0, 501, (k, B, 24, 2)).astype(np.int32)
    sem[:, 2, 15:] = 501
    return {"text_ids": text, "semantic_ids": sem}


def _vomix_params():
    """The tiny VoMix parameters with the adaptive norms' projections made
    random (at init they are zero and no gradient reaches the time MLP)."""
    rs = np.random.RandomState(11)

    def perturb(path, x):
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        if name.endswith(("to_gamma/w", "to_beta/w")):
            return x + jnp.asarray(rs.randn(*x.shape).astype(np.float32) * 0.02)
        return x

    return jax.tree_util.tree_map_with_path(perturb, jax_params(0)[1])


def _cfgs(**kw):
    """The schedule changes every step (one step an epoch is too fast to
    cross inside a dispatch at K=3; two are not) and the clip fires."""
    base = dict(lr=1e-3, use_lr_schedule=True, steps_per_epoch=2, wake_up_epochs=2, decay_start_epoch=3,
                total_epochs=6, ema_decay=0.999, grad_clip=1.0, **kw)
    return JLoop.TrainConfig(**base), PLoop.TrainConfig(**base)


def _close(port_tree, jax_tree, atol, what):
    flat_j = dict(named_leaves(jax.tree_util.tree_map(np.asarray, jax_tree)))
    for name, p in named_leaves(port_tree):
        err = np.abs(p.detach().numpy() - flat_j[name]).max()
        assert err <= atol, (what, name, err)


def _jax_cfm_inputs(key, mb):
    x = jnp.asarray(mb["x"])
    res = JA.cfm_inputs(J_AC, key, x[..., -80:], x[..., :-80], jnp.asarray(mb["mask"]), cond_drop_prob=DROP)
    return tuple(torch.from_numpy(np.array(r)) for r in res)


@pytest.mark.parametrize("case", ["vomix", "vomix_grad_accum", "t2s"])
def test_multi_step_matches_jax(case):
    """One port dispatch against JAX's jitted multi-step: the K losses and
    grad norms, then parameters and EMA."""
    rs = np.random.RandomState(30)
    accum = 2 if case == "vomix_grad_accum" else 1
    k = 2 if accum > 1 else 3
    jcfg, pcfg = _cfgs(grad_accum=accum)
    key = jax.random.PRNGKey(7)
    pending = []
    if case == "t2s":
        jp = jax.jit(JT.init, static_argnums=1)(jax.random.PRNGKey(2), J_T2S)
        batch = _t2s_batch(rs, k)
        jloss, ploss = JLoop.t2s_loss_fn(J_T2S), PLoop.t2s_loss_fn(P_T2S)
    else:
        jp = _vomix_params()
        batch = _vomix_batch(rs, (k, accum) if accum > 1 else (k,))
        jloss = JLoop.acoustic_loss_fn(J_AC, cond_drop_prob=DROP)
        for i in range(k):      # JAX's draws of each step (and micro-batch), in the order the port asks
            step_key = jax.random.fold_in(key, i)
            if accum > 1:
                pending += [_jax_cfm_inputs(mk, {n: v[i, j] for n, v in batch.items()})
                            for j, mk in enumerate(jax.random.split(step_key, accum))]
            else:
                pending.append(_jax_cfm_inputs(step_key, {n: v[i] for n, v in batch.items()}))

        def ploss(params, mb, generator):
            x = mb["x"]
            return PA.cfm_loss(params, P_AC, generator, x[..., -80:], mb["phonemes"], x[..., :-80], mb["mask"],
                               cond_drop_prob=DROP, inputs=pending.pop(0))

    with jax.default_matmul_precision("highest"):
        jstate = JLoop.init_train_state(jp, jcfg)
        jstate, jm = JLoop.make_multi_step(jloss, jcfg, k, donate=False)(
            jstate, jax.tree_util.tree_map(jnp.asarray, batch), key)
    pstate = PLoop.init_train_state(to_port(jp), pcfg)
    pm = PLoop.make_multi_step(ploss, pcfg, k)(pstate, batch, None)
    assert not pending
    assert pm["loss"].shape == pm["grad_norm"].shape == (k,)
    for name in ("loss", "grad_norm"):
        ref = np.asarray(jm[name])
        assert np.all(np.abs(pm[name].numpy() - ref) <= GRAD_TOL * np.abs(ref)), (name, pm[name], ref)
    if case != "t2s":
        assert float(np.max(np.asarray(jm["grad_norm"]))) > pcfg.grad_clip    # the clip fired
    assert (pstate.step, pstate.ema_num_updates) == (k, k) == (int(jstate.step), int(jstate.ema_num_updates))
    _close(pstate.params, jstate.params, 1e-2 * pcfg.lr, "params")
    _close(pstate.ema_params, jstate.ema_params, 1e-2 * pcfg.lr, "ema")


@pytest.mark.parametrize("k,accum", [(1, 1), (3, 1), (2, 2)])
def test_multi_step_is_k_single_steps(k, accum):
    """make_multi_step(K) equals K make_train_step calls on the slices, bit
    for bit, with the port's own draws from one generator seed: metrics,
    parameters, EMA, Adam's moments and counts, and the generator's next
    draw. K=1 is the single step itself."""
    _, pcfg = _cfgs(grad_accum=accum)
    init = to_port(_vomix_params())
    batch = _vomix_batch(np.random.RandomState(31), (k, accum) if accum > 1 else (k,))
    loss_fn = PLoop.acoustic_loss_fn(P_AC, cond_drop_prob=DROP)
    runs = []
    for multi in (False, True):
        state = PLoop.init_train_state(tree_map(torch.clone, init), pcfg)
        gen = torch.Generator().manual_seed(3)
        if multi:
            step = PLoop.make_multi_step(loss_fn, pcfg, k)
            if k == 1:      # the single step, taking one step's batch
                m = step(state, {n: v[0] for n, v in batch.items()}, gen)
                m = {n: v[None] for n, v in m.items()}
            else:
                m = step(state, batch, gen)
        else:
            step = PLoop.make_train_step(loss_fn, pcfg)
            ms = [step(state, {n: v[i] for n, v in batch.items()}, gen) for i in range(k)]
            m = {n: torch.stack([x[n] for x in ms]) for n in ms[0]}
        runs.append((state, m, torch.rand(8, generator=gen)))
    (a, ma, da), (b, mb, db) = runs
    assert all(torch.equal(ma[n], mb[n]) for n in ("loss", "grad_norm")) and torch.equal(da, db)
    for x, y in zip(tree_leaves([a.params, a.ema_params]), tree_leaves([b.params, b.ema_params])):
        assert torch.equal(x, y)
    for p, q in zip(tree_leaves(a.params), tree_leaves(b.params)):
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        assert all(torch.equal(sa[n], sb[n]) for n in ("step", "exp_avg", "exp_avg_sq"))
    assert (a.step, a.ema_num_updates) == (b.step, b.ema_num_updates) == (k, k)


def test_multi_step_refuses_a_batch_of_another_k():
    _, pcfg = _cfgs()
    state = PLoop.init_train_state(to_port(_vomix_params()), pcfg)
    step = PLoop.make_multi_step(PLoop.acoustic_loss_fn(P_AC), pcfg, 3)
    with pytest.raises(ValueError, match="expected K=3"):
        step(state, _vomix_batch(np.random.RandomState(0), (2,)), torch.Generator())


def _items(data):
    """Five random VoMix items of one length, so that every batch has one
    shape: stacking a dispatch pads its batches to their common shape (JAX's
    stack_microbatches), and a padded step is another computation."""
    rs, t = np.random.RandomState(2), 56
    data.mkdir()
    for i in range(5):
        base = data / f"u{i}"
        np.save(f"{base}.mel.npy", rs.randn(80, t).astype(np.float32))
        for ch in "AB":
            np.save(f"{base}-{ch}.mel.npy", rs.randn(80, t).astype(np.float32))
            np.save(f"{base}-{ch}.hubert_code.npy", rs.randint(0, 500, t).astype(str))


def _main(capsys, data, logs, run, *extra):
    """cli.main in this process; returns the step lines it printed."""
    capsys.readouterr()
    cli.main(["--device", "cpu", "--base_dir", str(data), "--format", "hubert_overlap_two_input_one_output",
              "--twocondition_oneoutput", "--CoVoMix_dim", "160", "--CoVoMix_dim_transformer", "32",
              "--CoVoMix_depth", "2", "--CoVoMix_heads", "2", "--CoVoMix_dim_head", "16", "--cond_drop_prob", "0.3",
              "--random_mask", "--batch_size", "2", "--lr_scheduler", "--log_dir", str(logs), "--run_name", run,
              "--eval_every", "0", "--no_wandb", *extra])
    out = capsys.readouterr().out
    return out, [json.loads(line) for line in out.splitlines() if line.startswith('{"step"')]


def test_cli_steps_per_dispatch(tmp_path, capsys, monkeypatch):
    """`--steps_per_dispatch 2 --max_steps 5` overshoots to 6 (three
    dispatches), logs and saves where a multiple of the cadence (3) falls
    inside a dispatch (JAX's `crossed`: after the dispatches ending at 4 and
    6), and its step-6 checkpoint equals the one of `--steps_per_dispatch 1`
    run to 6 bit for bit (the same batches and draws); `--resume` to 8 then
    starts at the dispatch boundary 6 and runs one dispatch."""
    data, logs = tmp_path / "data", tmp_path / "logs"
    _items(data)
    saved, real_save = [], cio.save_train_state

    def save_train_state(ckpt_dir, state, step):
        saved.append((os.path.basename(os.path.dirname(ckpt_dir)), step))
        real_save(ckpt_dir, state, step)

    monkeypatch.setattr(cio, "save_train_state", save_train_state)
    out, lines = _main(capsys, data, logs, "k2", "--steps_per_dispatch", "2", "--max_steps", "5",
                       "--log_every", "3", "--ckpt_every", "3")
    assert [r["step"] for r in lines] == [4, 6] and "done: 6 steps" in out
    _, lines1 = _main(capsys, data, logs, "k1", "--max_steps", "6", "--log_every", "3", "--ckpt_every", "3")
    assert [r["step"] for r in lines1] == [3, 6]
    assert lines[-1]["train_loss"] == lines1[-1]["train_loss"] and lines[-1]["grad_norm"] == lines1[-1]["grad_norm"]
    paths = [logs / run / "checkpoints" / "step_00000006" / "state.npz" for run in ("k2", "k1")]
    with np.load(paths[0]) as a, np.load(paths[1]) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert np.array_equal(a[name], b[name]), name
        assert int(a["step"]) == int(a["adam_step"]) == int(a["ema_num_updates"]) == 6
    out, lines = _main(capsys, data, logs, "k2", "--steps_per_dispatch", "2", "--max_steps", "8",
                       "--log_every", "1", "--ckpt_every", "3", "--resume")
    assert "resumed from step 6" in out and [r["step"] for r in lines] == [8]
    assert saved == [("k2", 4), ("k2", 6), ("k1", 3), ("k1", 6), ("k2", 8)]
    k2 = logs / "k2" / "checkpoints"
    assert sorted(os.listdir(k2)) == ["step_00000008", "topk.json"]
    with np.load(k2 / "step_00000008" / "state.npz") as z:
        assert int(z["step"]) == int(z["adam_step"]) == int(z["ema_num_updates"]) == 8
