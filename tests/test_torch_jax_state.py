"""Carrying a JAX train state into the port: the JAX package's own
`checkpoint.io.save_train_state` writes orbax step directories into
tmp_path, `convert_jax_train_state.py` (at the repo root) turns them into
the port's state.npz, and `checkpoint.io.load_train_state` reads them:

  * a tiny VoMix TrainState and a tiny CoMix T2S one (after one JAX step,
    so Adam's moments and count are live), and a --pp {'stacked', 'rest'}
    one: every parameter, EMA leaf, moment and counter bit for bit, then
    one port step from the loaded state with JAX's draws against JAX's next
    step: the loss to 1e-5 relative, parameters and EMA to 1e-2 of the
    learning rate (tests/test_torch_acoustic_train.py's bounds);
  * a --bmuf_sync stack (two workers of a least-squares model after the
    warmup sync and a local step, the lr schedule at one step an epoch):
    each worker's row into its own state and BMUF state, then each
    worker's next (local) step against JAX's stacked step, the learning
    rate from the schedule's count that the warmup reset;
  * a GanState (a tiny generator under weight norm and stand-in
    discriminator trees with spectral buffers, both AdamW states after one
    update): every leaf, moment and count equal to `params_from_numpy`'s
    carry of the same state in memory, which tests/test_torch_gan_step.py
    holds to JAX's next step;
  * the train CLI's `--resume` from a converted directory of a JAX run
    continuing at step N + 1."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convert_jax_train_state as CJ
from covomix_tpu.checkpoint import io as jio
from covomix_tpu.models import acoustic as JA, text2semantic as JT, vocoder as JV
from covomix_tpu.parallel import bmuf as JB, pipeline as JPP
from covomix_tpu.train import gan as JG, loop as JLoop
from covomix_tpu_torch.checkpoint import io as pio
from covomix_tpu_torch.models import acoustic as PA, text2semantic as PT
from covomix_tpu_torch.parallel import bmuf as PB, pipeline as PP
from covomix_tpu_torch.parallel.mesh import Mesh
from covomix_tpu_torch.train import cli, gan as PG, loop as PLoop
from covomix_tpu_torch.util.misc import named_leaves

from _torch_port import J_AC, J_VOC, P_AC, port_cfg, to_port
from _torch_tp_cases import J_T2S_PAD, _acoustic_batch, _acoustic_params, _np, _t2s_batch
from test_torch_dp_cli import _argv, _steps, _write_items

LR = 1e-3
DROP = 0.3
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-2 * LR


def _jax_two_steps(loss_fn, params, batches, keys, ckpt_dir):
    """JAX's make_train_step for two steps; the state after the first saved
    (orbax) as step 1. Returns (state 1, metrics of step 2, state 2), numpy."""
    cfg = JLoop.TrainConfig(lr=LR)
    with jax.default_matmul_precision("highest"):
        step = JLoop.make_train_step(loss_fn, cfg, donate=False)
        s1, _ = step(JLoop.init_train_state(params, cfg), batches[0], keys[0])
        jio.save_train_state(ckpt_dir, s1, 1)
        s2, m = step(s1, batches[1], keys[1])
    return _np(s1), {k: float(v) for k, v in m.items()}, _np(s2)


def _acoustic_inputs(batch, key):
    x = jnp.asarray(batch["x"])
    with jax.default_matmul_precision("highest"):
        res = JA.cfm_inputs(J_AC, key, x[..., -80:], x[..., :-80], jnp.asarray(batch["mask"]), cond_drop_prob=DROP)
    return tuple(None if a is None else torch.from_numpy(np.array(a)) for a in res)


def _port_acoustic_loss(inputs, unstack=None):
    def loss(p, batch, generator):
        x = batch["x"]
        p = p if unstack is None else unstack(p)
        return PA.cfm_loss(p, P_AC, generator, x[..., -80:], batch["phonemes"], x[..., :-80], batch["mask"],
                           cond_drop_prob=DROP, inputs=inputs)

    return loss


def _cases():
    """{name: (JAX params, JAX loss, batches, keys, port loss on step 2's
    draws, port params tree of the same layout)}."""
    rs = np.random.RandomState(0)
    keys = list(jax.random.split(jax.random.PRNGKey(3), 2))
    ac = _acoustic_params()
    ac_batches = [_acoustic_batch(rs) for _ in range(2)]
    jloss = JLoop.acoustic_loss_fn(J_AC, cond_drop_prob=DROP)
    port_ac = to_port(ac)
    stacked, rest = JPP.stack_layer_params(ac, J_AC)
    t2s = jax.jit(JT.init, static_argnums=1)(jax.random.PRNGKey(4), J_T2S_PAD)
    t2s_cfg = port_cfg(PT.T2SConfig, J_T2S_PAD)
    return {
        "acoustic": (ac, jloss, ac_batches, keys, _port_acoustic_loss(_acoustic_inputs(ac_batches[1], keys[1])),
                     port_ac),
        "t2s": (t2s, JLoop.t2s_loss_fn(J_T2S_PAD), [_t2s_batch(rs) for _ in range(2)], keys,
                PLoop.t2s_loss_fn(t2s_cfg), to_port(t2s)),
        "pp_stacked": ({"stacked": stacked, "rest": rest},
                       lambda p, b, k: jloss(JPP.unstack_layer_params(p["stacked"], p["rest"], J_AC), b, k),
                       ac_batches, keys,
                       _port_acoustic_loss(_acoustic_inputs(ac_batches[1], keys[1]),
                                           lambda p: PP.unstack_layer_params(p["stacked"], p["rest"], P_AC)),
                       dict(zip(("stacked", "rest"), PP.stack_layer_params(to_port(ac), P_AC)))),
    }


CASES = _cases()


def _adam(state):
    opt = state.optimizer
    return {n: opt.state[p] for n, p in named_leaves(state.params)}


@pytest.mark.parametrize("name", list(CASES))
def test_converted_state_steps_as_jax(tmp_path, name):
    jparams, jloss, batches, keys, ploss, pparams = CASES[name]
    s1, m2, s2 = _jax_two_steps(jloss, jparams, batches, keys, str(tmp_path))
    path = CJ.convert(str(tmp_path / "step_00000001"))
    assert path == str(tmp_path / "step_00000001" / "state.npz")
    state = pio.load_train_state(str(tmp_path), 1, PLoop.init_train_state(pparams, PLoop.TrainConfig(lr=LR)))
    assert (state.step, state.ema_num_updates) == (1, 1)
    count, mu, nu = pio._adam_moments(s1.opt_state)
    adam = _adam(state)
    for (n, p), (_, e) in zip(named_leaves(state.params), named_leaves(state.ema_params)):
        np.testing.assert_array_equal(p.detach().numpy(), dict(named_leaves(s1.params))[n], err_msg=n)
        np.testing.assert_array_equal(e.numpy(), dict(named_leaves(s1.ema_params))[n], err_msg=n)
        np.testing.assert_array_equal(adam[n]["exp_avg"].numpy(), dict(named_leaves(mu))[n], err_msg=n)
        np.testing.assert_array_equal(adam[n]["exp_avg_sq"].numpy(), dict(named_leaves(nu))[n], err_msg=n)
        assert int(adam[n]["step"]) == count == 1
    m = PLoop.make_train_step(ploss, PLoop.TrainConfig(lr=LR))(state, batches[1], None)
    assert abs(m["loss"].item() - m2["loss"]) <= LOSS_RTOL * abs(m2["loss"])
    assert abs(m["grad_norm"].item() - m2["grad_norm"]) <= LOSS_RTOL * m2["grad_norm"]
    for tree, ref in ((state.params, s2.params), (state.ema_params, s2.ema_params)):
        ref = dict(named_leaves(ref))
        for n, p in named_leaves(tree):
            np.testing.assert_allclose(p.detach().numpy(), ref[n], rtol=0, atol=PARAM_ATOL, err_msg=n)


def test_bmuf_stack_converts_and_each_worker_steps_as_jax(tmp_path):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 6).astype(np.float32)
    y = (x @ rng.randn(6, 1) + rng.randn(2, 8, 1) * 0.01).astype(np.float32)

    def jloss(params, batch, key):
        return jnp.mean(jnp.square(batch["x"] @ params["w"] - batch["y"]))

    tcfg = JLoop.TrainConfig(lr=0.05, ema_decay=0.9, use_lr_schedule=True, steps_per_epoch=1, wake_up_epochs=15)
    bcfg = JB.BMUFConfig(sync_every=4, warmup_steps=1)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("dp",))
    ts = JLoop.init_train_state({"w": jnp.zeros((6, 1), jnp.float32)}, tcfg)
    state = JB.stack_for_bmuf(ts, JB.init_bmuf_state(ts.params), mesh)
    step = JB.make_bmuf_train_step(jloss, tcfg, bcfg, mesh)
    batch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    for i in range(2):
        state, _ = step(state, batch, jax.random.PRNGKey(i))
    jio.save_train_state(str(tmp_path / "jax"), state, 2)
    state3, m3 = step(state, batch, jax.random.PRNGKey(2))
    state3 = _np(state3)
    CJ.main([str(tmp_path / "jax" / "step_00000002"), "--out", str(tmp_path / "port")])

    ploss = lambda p, b, g: torch.mean(torch.square(b["x"] @ p["w"] - b["y"]))
    pcfg = PLoop.TrainConfig(lr=0.05, ema_decay=0.9, use_lr_schedule=True, steps_per_epoch=1, wake_up_epochs=15)
    losses = []
    for w in range(2):
        st = PLoop.init_train_state({"w": torch.zeros(6, 1)}, pcfg)
        bst = PB.init_bmuf_state(st.params)
        pio.load_train_state(str(tmp_path / "port"), 2, st, bmuf=(bst, 2, w))
        assert (bst["t"], st.step, PG.opt_count(st.optimizer)) == (2, 2, 1)    # Adam's count reset at the warmup
        m = PB.make_bmuf_train_step(ploss, pcfg, PB.BMUFConfig(sync_every=4, warmup_steps=1), Mesh(2, rank=w),
                                    bst)(st, {"x": x[w], "y": y[w]}, None)
        losses.append(m["loss"].item())
        assert st.optimizer.param_groups[0]["lr"] == pytest.approx(float(JLoop.reference_lr_schedule(tcfg)(1)))
        np.testing.assert_allclose(st.params["w"].detach().numpy(), state3["train"][0]["w"][w], rtol=0, atol=1e-7)
        np.testing.assert_allclose(st.ema_params["w"].numpy(), state3["train"][2]["w"][w], rtol=0, atol=1e-7)
        np.testing.assert_array_equal(bst["global"]["w"].numpy(), state3["bmuf"]["global"]["w"][w])
    assert abs(np.mean(losses) - float(np.asarray(m3["loss"])[0])) <= LOSS_RTOL * abs(float(np.asarray(m3["loss"])[0]))


def test_gan_state_converts_as_params_from_numpy_carries_it(tmp_path):
    rs = np.random.RandomState(2)
    gen = JG.wn_split(_np(jax.jit(JV.init_generator, static_argnums=1)(jax.random.PRNGKey(0), J_VOC)))
    conv = lambda c: {"w": rs.randn(5, 1, c).astype(np.float32), "b": rs.randn(c).astype(np.float32)}
    mpd = JG.wn_split({"discriminators": [{"convs": [conv(4), conv(8)]}]})
    msd = [{"convs": [dict(conv(4), u=rs.randn(4).astype(np.float32), v=rs.randn(5).astype(np.float32))]}]
    cfg = JG.GanConfig()
    opt_g, opt_d = JG._make_opt(cfg), JG._make_opt_d(cfg)
    d = {"mpd": mpd, "msd": msd}
    noise = lambda tree: jax.tree_util.tree_map(lambda a: jnp.asarray(rs.randn(*np.shape(a)).astype(np.float32)), tree)
    _, og = opt_g.update(noise(gen), opt_g.init(gen), gen)
    _, od = opt_d.update(noise(d), opt_d.init(d), d)
    js = JG.GanState(gen, mpd, msd, og, od, jnp.int32(7))
    jio.save_train_state(str(tmp_path), js, 7)
    CJ.convert(str(tmp_path / "step_00000007"))
    carried = pio.params_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu")
    fresh = lambda t: pio.params_from_numpy(jax.tree_util.tree_map(np.zeros_like, t), "cpu")
    port = PG.make_gan_state(fresh(gen), fresh(mpd), fresh(msd), PG.GanConfig())
    pio.load_train_state(str(tmp_path), 7, port)
    assert port.step == carried.step == 7
    for key in ("gen_params", "mpd_params", "msd_params"):
        a, b = dict(named_leaves(getattr(port, key))), dict(named_leaves(getattr(carried, key)))
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a), key
    for (_, opt_a, tree_a), (_, opt_b, tree_b) in zip(pio._gan_opts(port), pio._gan_opts(carried)):
        assert PG.opt_count(opt_a) == PG.opt_count(opt_b) == 1
        b = dict(PG.trainable_leaves(tree_b))
        for n, p in PG.trainable_leaves(tree_a):
            for slot in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(opt_a.state[p][slot], opt_b.state[b[n]][slot]), (n, slot)


def test_cli_resumes_a_converted_jax_run(tmp_path, capsys):
    """A JAX TrainState of the CLI's tiny VoMix model at step 2, converted in
    place: the port's --resume reads it and trains step 3."""
    data, logs = tmp_path / "data", tmp_path / "logs"
    _write_items(data)
    cfg = JA.AcousticConfig(dim_in=160, dim=32, depth=2, dim_head=16, heads=2, num_phoneme_tokens=502,
                            mode="two_one")
    params = jax.jit(JA.init, static_argnums=1)(jax.random.PRNGKey(5), cfg)
    state = JLoop.init_train_state(params, JLoop.TrainConfig())._replace(ema_num_updates=jnp.int32(2),
                                                                         step=jnp.int32(2))
    ckpt = logs / "jaxrun" / "checkpoints"
    jio.save_train_state(str(ckpt), state, 2)
    CJ.convert(str(ckpt / "step_00000002"))
    cli.main(_argv(data, logs, "jaxrun", "--dp", "1", "--resume", "--num_eval_files", "0")[3:])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and [r["step"] for r in _steps(out)] == [3]
    with np.load(ckpt / "step_00000003" / "state.npz") as z:
        assert int(z["step"]) == 3 and z["params/to_embed/w"].shape == tuple(params["to_embed"]["w"].shape)
