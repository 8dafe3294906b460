"""The port's acoustic training (OT-CFM loss, Adam + EMA + LR schedule, grad
accumulation) against the JAX package at the tiny VoMix config, f32 at
'highest' precision. JAX's `cfm_inputs` (noise, times, mask, cond-drop) are
handed to the port, since the two draw different random numbers.

Tolerances: the loss and each parameter's gradient to 1e-5 of the leaf's
scale (summation order only). Adam divides each gradient element by its own
magnitude, so an element whose gradient is small next to its leaf's scale
(its 1e-5 error then a larger share of it) takes an update that differs by up
to ~1e-3 of the learning rate: parameters and EMA after three steps are held
to 1e-2 of the learning rate, far below the learning-rate-sized change a
wrong schedule step would make."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covomix_tpu.models import acoustic as JA
from covomix_tpu.ops import flash_attention as JF
from covomix_tpu.train import loop as JLoop
from covomix_tpu_torch.models import acoustic as PA
from covomix_tpu_torch.ops import flash_attention as PF
from covomix_tpu_torch.train import loop as PLoop
from covomix_tpu_torch.util.misc import named_leaves, tree_leaves, tree_map

from _torch_port import J_AC, P_AC, jax_params, to_port

B, T = 3, 128
GRAD_TOL = 1e-5
DROP = 0.3


def _batch(seed, b=B, t=T):
    rs = np.random.RandomState(seed)
    mask = np.zeros((b, t), bool)
    for i in range(b):
        s = rs.randint(0, t // 2)
        mask[i, s:s + t // 3] = True
    return {"x": (rs.randn(b, t, 240) * 0.5).astype(np.float32),
            "phonemes": rs.randint(0, 502, (b, t, 2)).astype(np.int32), "mask": mask}


def _jax_inputs(key, batch):
    """JAX's cfm_inputs for a VoMix batch, as torch tensors."""
    x = jnp.asarray(batch["x"])
    res = JA.cfm_inputs(J_AC, key, x[..., -80:], x[..., :-80], jnp.asarray(batch["mask"]), cond_drop_prob=DROP)
    return tuple(torch.from_numpy(np.array(r)) for r in res)


def _params():
    """The tiny VoMix parameters with the adaptive norms' projections made
    random: at init they are zero, and no gradient would reach the time
    embedding (sinu_weights, time_mlp)."""
    jp = jax_params(0)[1]
    rs = np.random.RandomState(11)

    def perturb(path, x):
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        if name.endswith(("to_gamma/w", "to_beta/w")):
            return x + jnp.asarray(rs.randn(*x.shape).astype(np.float32) * 0.02)
        return x

    return jax.tree_util.tree_map_with_path(perturb, jp)


def _drop_key():
    """A key whose cond-drop coin drops some rows and keeps others, so the
    null-condition path and the conditioned path both carry gradient."""
    for seed in range(100):
        key = jax.random.PRNGKey(seed)
        drop = np.asarray(JA.cfm_inputs(J_AC, key, jnp.zeros((B, T, 80)), jnp.zeros((B, T, 160)),
                                        cond_drop_prob=DROP)[5])
        if drop.any() and not drop.all():
            return key
    raise AssertionError("no key drops some rows and keeps others")


def _flash_dispatch_jax(q, k, v, *, key_mask=None, valid_len=None, causal=False, rotary=None, **kw):
    """The JAX dispatcher with the Pallas kernel forced (interpret mode), as
    tests/test_flash_attention.py forces it."""
    assert key_mask is None and not causal
    tables = JF.rotary_tables_halfsplit(rotary[0], rotary[1], q.dtype) if rotary is not None else None
    return JF.flash_attention(q, k, v, valid_len=valid_len, rotary=tables, interpret=True)


@pytest.mark.parametrize("route", ["dispatched", "flash"])
def test_cfm_loss_and_every_gradient_match_jax(route, monkeypatch):
    """cfm_loss with a training mask drawn by cfm_inputs (no batch mask) and
    cond-drop, and the gradient of every parameter, against
    jax.value_and_grad(cfm_loss). 'dispatched': both packages take their CPU
    attention (einsum); 'flash': both are forced through the flash route (the
    Pallas kernels in interpret mode; the port's autograd Function with the
    plain versions)."""
    jp = _params()
    rs = np.random.RandomState(7)
    x1 = rs.randn(B, T, 80).astype(np.float32)
    cond = (rs.randn(B, T, 160) * 0.5).astype(np.float32)
    ph = rs.randint(0, 502, (B, T, 2)).astype(np.int32)
    key = _drop_key()
    backward_calls = []
    if route == "flash":
        monkeypatch.setattr(JA, "attend_flash_or_xla", _flash_dispatch_jax)
        monkeypatch.setattr(PF, "use_flash_kernel", lambda **kw: True)
        plain_bwd = PF.flash_attention_bwd_plain
        monkeypatch.setattr(PF, "flash_attention_bwd_plain",
                            lambda *a: backward_calls.append(1) or plain_bwd(*a))
    with jax.default_matmul_precision("highest"):
        loss_j, grads_j = jax.jit(jax.value_and_grad(JA.cfm_loss), static_argnums=1,
                                  static_argnames="cond_drop_prob")(
            jp, J_AC, key, jnp.asarray(x1), jnp.asarray(ph), jnp.asarray(cond), cond_drop_prob=DROP)
        inputs = tuple(torch.from_numpy(np.array(r)) for r in
                       JA.cfm_inputs(J_AC, key, jnp.asarray(x1), jnp.asarray(cond), cond_drop_prob=DROP))
    pp = to_port(jp)
    for p in tree_leaves(pp):
        p.requires_grad_(True)
    loss_p = PA.cfm_loss(pp, P_AC, None, torch.from_numpy(x1), torch.from_numpy(ph), torch.from_numpy(cond),
                         cond_drop_prob=DROP, inputs=inputs)
    loss_p.backward()
    assert backward_calls == ([1] * P_AC.depth if route == "flash" else [])
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


def test_ema_ramp_and_lr_schedule_match_jax():
    cfg = dict(lr=2e-3, steps_per_epoch=3, wake_up_epochs=2, decay_start_epoch=4, total_epochs=6)
    js, ps = JLoop.reference_lr_schedule(JLoop.TrainConfig(**cfg)), PLoop.reference_lr_schedule(
        PLoop.TrainConfig(**cfg))
    for step in range(25):
        assert abs(ps(step) - float(js(step))) <= 1e-7 * cfg["lr"], step
    assert ps(0) == pytest.approx(cfg["lr"] / 2) and ps(24) == 0.0
    rs = np.random.RandomState(0)
    ema = {"a": rs.randn(5).astype(np.float32), "b": [rs.randn(2, 3).astype(np.float32)]}
    ema_p = tree_map(torch.from_numpy, jax.tree_util.tree_map(np.copy, ema))
    ema_j = jax.tree_util.tree_map(jnp.asarray, ema)
    for n in range(4):
        params = {"a": rs.randn(5).astype(np.float32), "b": [rs.randn(2, 3).astype(np.float32)]}
        ema_j = JLoop.ema_update(ema_j, jax.tree_util.tree_map(jnp.asarray, params), jnp.int32(n), 0.999)
        PLoop.ema_update(ema_p, tree_map(torch.from_numpy, params), n, 0.999)
        for (name, e), (_, r) in zip(named_leaves(ema_p), named_leaves(ema_j)):
            np.testing.assert_allclose(e.numpy(), np.asarray(r), rtol=0, atol=1e-7, err_msg=f"{name} n={n}")


def _train_cfgs(**kw):
    base = dict(lr=1e-3, use_lr_schedule=True, steps_per_epoch=1, wake_up_epochs=2, decay_start_epoch=3,
                total_epochs=6, ema_decay=0.999, **kw)
    return JLoop.TrainConfig(**base), PLoop.TrainConfig(**base)


def _assert_trees_close(port_tree, jax_tree, atol, what):
    flat_j = dict(named_leaves(jax.tree_util.tree_map(np.asarray, jax_tree)))
    for name, p in named_leaves(port_tree):
        err = np.abs(p.detach().numpy() - flat_j[name]).max()
        assert err <= atol, (what, name, err)


def test_three_adam_steps_match_jax_make_train_step():
    """Three optimizer steps (loss, global norm, clipping, Adam at the
    schedule's rate before each update, EMA) against JAX's make_train_step on
    the same batches; the schedule changes every step and the clip fires."""
    jcfg, pcfg = _train_cfgs(grad_clip=1.0)
    jp = _params()
    batches = [_batch(20 + i) for i in range(3)]
    keys = [jax.random.PRNGKey(30 + i) for i in range(3)]
    with jax.default_matmul_precision("highest"):
        jstate = JLoop.init_train_state(jp, jcfg)
        jstep = JLoop.make_train_step(JLoop.acoustic_loss_fn(J_AC, cond_drop_prob=DROP), jcfg, donate=False)
        jmetrics = []
        for batch, key in zip(batches, keys):
            jstate, m = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch), key)
            jmetrics.append(m)
        pending = [_jax_inputs(key, batch) for batch, key in zip(batches, keys)]

    def port_loss(params, batch, generator):
        x = batch["x"]
        return PA.cfm_loss(params, P_AC, generator, x[..., -80:], batch["phonemes"], x[..., :-80], batch["mask"],
                           cond_drop_prob=DROP, inputs=pending.pop(0))

    pstate = PLoop.init_train_state(to_port(jp), pcfg)
    pstep = PLoop.make_train_step(port_loss, pcfg)
    for i, batch in enumerate(batches):
        m = pstep(pstate, batch, None)
        assert abs(m["loss"].item() - float(jmetrics[i]["loss"])) <= GRAD_TOL * abs(float(jmetrics[i]["loss"]))
        gn = float(jmetrics[i]["grad_norm"])
        assert gn > pcfg.grad_clip and abs(m["grad_norm"].item() - gn) <= GRAD_TOL * gn
    assert pstate.step == 3 and pstate.ema_num_updates == 3
    _assert_trees_close(pstate.params, jstate.params, 1e-2 * pcfg.lr, "params")
    _assert_trees_close(pstate.ema_params, jstate.ema_params, 1e-2 * pcfg.lr, "ema")


def test_grad_accum_two_gives_the_mean():
    """grad_accum=2 on [2, b, ...] micro-batches: loss and gradients are the
    mean over the micro-batches, as JAX's accumulated_value_and_grad."""
    jp = _params()
    mbs = [_batch(40), _batch(41)]
    stacked = {k: np.stack([mb[k] for mb in mbs]) for k in mbs[0]}
    key = jax.random.PRNGKey(5)
    with jax.default_matmul_precision("highest"):
        loss_j, grads_j = jax.jit(JLoop.accumulated_value_and_grad(JLoop.acoustic_loss_fn(J_AC, cond_drop_prob=DROP), 2))(
            jp, jax.tree_util.tree_map(jnp.asarray, stacked), key)
        pending = [_jax_inputs(k, mb) for k, mb in zip(jax.random.split(key, 2), mbs)]

    def port_loss(params, batch, generator):
        x = batch["x"]
        return PA.cfm_loss(params, P_AC, generator, x[..., -80:], batch["phonemes"], x[..., :-80], batch["mask"],
                           cond_drop_prob=DROP, inputs=pending.pop(0))

    pp = to_port(jp)
    for p in tree_leaves(pp):
        p.requires_grad_(True)
    loss_p, grads_p = PLoop.accumulated_value_and_grad(port_loss, 2)(
        pp, PLoop.to_device(stacked, "cpu"), None)
    assert not pending
    assert abs(loss_p.item() - float(loss_j)) <= GRAD_TOL * abs(float(loss_j))
    flat_j = dict(named_leaves(jax.tree_util.tree_map(np.asarray, grads_j)))
    for (name, _), g in zip(named_leaves(pp), grads_p):
        ref = flat_j[name]
        assert np.abs(g.numpy() - ref).max() <= GRAD_TOL * max(1.0, np.abs(ref).max()), name


def test_training_mask_and_inputs_shapes():
    """The port's own draws: a coin between one span per row (a fraction in
    [0.7, 1) of the row) and bernoulli(0.3); cond zeroed on the mask; the
    same generator seed gives the same draws on any device of the data."""
    gen = torch.Generator().manual_seed(0)
    spans = [PA.random_span_mask(gen, 4, 100, 0.7, 1.0) for _ in range(5)]
    for m in spans:
        n = m.sum(-1)
        assert bool(((n >= 70) & (n <= 100)).all())
        for row in m:   # one contiguous run
            idx = torch.nonzero(row)[:, 0]
            assert int(idx[-1] - idx[0] + 1) == len(idx)
    x1, cond = torch.randn(3, 50, 80), torch.randn(3, 50, 160)
    a = PA.cfm_inputs(P_AC, torch.Generator().manual_seed(1), x1, cond, cond_drop_prob=DROP)
    b = PA.cfm_inputs(P_AC, torch.Generator().manual_seed(1), x1, cond, cond_drop_prob=DROP)
    w, times, flow, mask, cond_m, drop = a
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert w.shape == x1.shape and times.shape == (3,) and mask.dtype == torch.bool and drop.shape == (3,)
    assert bool((cond_m[mask] == 0).all()) and torch.equal(cond_m[~mask], cond[~mask])
    torch.testing.assert_close(flow + (w - times[:, None, None] * x1) / (1 - times[:, None, None]),
                               x1, rtol=0, atol=1e-4)
