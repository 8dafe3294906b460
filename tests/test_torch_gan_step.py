"""The port's GAN step (`train.gan.make_gan_step`) against the JAX package's
jitted step, on the CPU: one carried state (a tiny generator, initial
channel 16; the MPD / MSD at full width), segment 1600, B=2.

Two steps with steps_per_epoch=1 (so the second step's learning rate has
decayed once) hold the losses, both sides' gradients (the JAX gradients read
from the first AdamW moment, m = (1 - b1) g after one update), the
parameters and both moments after two updates, the optimizer counts and the
spectral buffers. These run with mel_loss_weight 0: at a random generator's
output the mel-L1 gradient is ill-conditioned (a 1e-6 relative change of
y_hat moves JAX's own gradient by ~10 %, tests/test_torch_gan.py), so the
mel term's gradient is held there on a broadband input; the step at the
recipe's mel weight: tests/test_torch_gan_finetune.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covomix_tpu.audio.mel import MelConfig as JMel
from covomix_tpu.train import gan as JG
from covomix_tpu_torch.audio.mel import MelConfig as PMel
from covomix_tpu_torch.checkpoint import io as pio
from covomix_tpu_torch.train import gan as PG
from covomix_tpu_torch.util.misc import named_leaves

from _torch_port import J_VOC, P_VOC, jax_gan_state, numpy_tree, torch_threads

SEG = 1600
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
# after two updates: 2 lr bounds what a sign-flipped first update of a
# near-zero gradient moves a leaf; all but 0.1 % of elements within 1e-6
STEP_ATOL, STEP_TIGHT, STEP_TIGHT_SHARE = 4e-4, 1e-6, 1e-3
KW = dict(segment_size=SEG, steps_per_epoch=1, mel_loss_weight=0.0)


def audio(seed, scale=0.1):
    return (np.random.RandomState(seed).randn(2, SEG) * scale).astype(np.float32)


def moments(opt_state):
    count, mu, nu = pio._adam_moments(opt_state)
    return count, dict(named_leaves(mu)), dict(named_leaves(nu))


@pytest.fixture(scope="module")
def trees():
    st = PG.init_gan_state(torch.Generator().manual_seed(0), P_VOC, PG.GanConfig(segment_size=SEG))
    return numpy_tree(st.gen_params), numpy_tree(st.mpd_params), numpy_tree(st.msd_params)


@pytest.fixture(scope="module")
def run(trees):
    """Both packages, two steps each from one state: JAX states / metrics in
    numpy after each step, the port's metrics, its gradients after step 1
    and its final state."""
    cfg_j, cfg_p = JG.GanConfig(**KW), PG.GanConfig(**KW)
    batches = [audio(1), audio(2)]
    js = [jax.device_get(jax_gan_state(*trees, cfg_j))]
    jm = []
    step = JG.make_gan_step(J_VOC, JMel(), JMel(), cfg_j)
    for b in batches:
        s, m = step(js[-1], {"audio": jnp.asarray(b)})
        js.append(jax.device_get(s))
        jm.append({k: float(v) for k, v in m.items()})
    ps = pio.params_from_numpy(js[0], "cpu", gan_cfg=cfg_p)
    pstep = PG.make_gan_step(P_VOC, PMel(), PMel(), cfg_p)
    pm, grads = [], None
    with torch_threads(4):
        for b in batches:
            m = pstep(ps, {"audio": torch.from_numpy(b)})
            pm.append({k: float(v) for k, v in m.items()})
            if grads is None:
                grads = {side: {n: p.grad.numpy().copy() for n, p in PG.trainable_leaves(tree)}
                         for side, tree in (("g", ps.gen_params), ("d", ps.d_params))}
    return {"js": js, "jm": jm, "ps": ps, "pm": pm, "grads": grads, "cfg": cfg_p}


def test_losses_match_jax(run):
    for jm, pm in zip(run["jm"], run["pm"]):
        assert set(jm) == set(pm)
        for k in jm:        # mel_error is 0 / 0 at mel_loss_weight 0 on both sides
            np.testing.assert_allclose(pm[k], jm[k], rtol=LOSS_RTOL, equal_nan=True, err_msg=k)


@pytest.mark.parametrize("side", ["g", "d"])
def test_gradients_match_jax(run, side):
    count, mu, _ = moments(getattr(run["js"][1], f"opt_{side}"))
    assert count == 1
    got = run["grads"][side]
    assert got.keys() == mu.keys()
    for name, g in got.items():
        np.testing.assert_allclose(g, mu[name] / np.float32(1 - JG.GanConfig().adam_b1), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("side", ["g", "d"])
def test_two_steps_match_jax(run, side):
    """Parameters and both AdamW moments after two updates (the second at
    lr x lr_decay), and both counts."""
    js, ps = run["js"][2], run["ps"]
    tree = ps.gen_params if side == "g" else ps.d_params
    opt = getattr(ps, f"opt_{side}")
    count, mu, nu = moments(getattr(js, f"opt_{side}"))
    assert count == PG.opt_count(opt) == 2 and ps.step == int(js.step) == 2
    assert opt.param_groups[0]["lr"] == pytest.approx(2e-4 * 0.999, rel=1e-12)
    ref_params = dict(named_leaves(jax.device_get({"g": js.gen_params, "d": {"mpd": js.mpd_params,
                                                                              "msd": js.msd_params}}[side])))
    far = total = 0
    for name, p in PG.trainable_leaves(tree):
        st = opt.state[p]
        for what, got, want in (("param", p.detach().numpy(), ref_params[name]),
                                ("mu", st["exp_avg"].numpy(), mu[name]), ("nu", st["exp_avg_sq"].numpy(), nu[name])):
            np.testing.assert_allclose(got, want, rtol=0, atol=STEP_ATOL, err_msg=f"{what} {name}")
            far += int(np.sum(np.abs(got - want) > STEP_TIGHT))
            total += got.size
    assert far <= STEP_TIGHT_SHARE * total, (far, total)


def test_spectral_buffers_outside_the_optimizer(run):
    """MSD[0]'s u, v: no optimizer state, no gradient, one power iteration a
    step (equal to JAX's after two), unit norm; a weight-norm leaf's v is
    trained."""
    ps, js = run["ps"], run["js"][2]
    d0 = ps.msd_params["discriminators"][0]
    ref = dict(named_leaves(jax.device_get(js.msd_params["discriminators"][0])))
    opt_params = {id(p) for p in ps.opt_d.param_groups[0]["params"]}
    for i, leaf in enumerate([*d0["convs"], d0["conv_post"]]):
        for k in ("u", "v"):
            t = leaf[k]
            assert id(t) not in opt_params and t not in ps.opt_d.state and not t.requires_grad
            name = f"convs/{i}/{k}" if i < len(d0["convs"]) else f"conv_post/{k}"
            np.testing.assert_allclose(t.numpy(), ref[name], rtol=1e-5, atol=1e-6, err_msg=name)
            np.testing.assert_allclose(torch.linalg.vector_norm(t).item(), 1.0, rtol=1e-5)
    assert id(ps.msd_params["discriminators"][1]["convs"][0]["v"]) in opt_params


def test_carry_from_jax_state(run):
    """params_from_numpy takes a JAX GanState after a step: the leaves, the
    spectral buffers, both optimizers' moments and counts, bit for bit."""
    js = run["js"][1]
    ps = pio.params_from_numpy(js, "cpu", gan_cfg=run["cfg"])
    assert ps.step == 1
    for side, tree in (("g", ps.gen_params), ("d", ps.d_params)):
        opt = getattr(ps, f"opt_{side}")
        count, mu, nu = moments(getattr(js, f"opt_{side}"))
        assert PG.opt_count(opt) == count == 1
        for name, p in PG.trainable_leaves(tree):
            assert p.requires_grad
            np.testing.assert_array_equal(opt.state[p]["exp_avg"].numpy(), mu[name])
            np.testing.assert_array_equal(opt.state[p]["exp_avg_sq"].numpy(), nu[name])
    u = ps.msd_params["discriminators"][0]["conv_post"]["u"]
    np.testing.assert_array_equal(u.numpy(), np.asarray(js.msd_params["discriminators"][0]["conv_post"]["u"]))
