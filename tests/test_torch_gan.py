"""HiFi-GAN training pieces of the port against the JAX package, on the CPU
at a tiny generator (initial channel 16, segment 1600, B=2; the MPD / MSD at
their only, full, width): the discriminators and the three losses, the
weight-norm and spectral-norm forms, the mel-L1 and generator gradients,
the exported generator, the GAN train state's save / load, and the fused
vocoder wrappers' refusal under autograd. The GAN step itself:
tests/test_torch_gan_step.py.

States and batches are drawn once with torch / numpy and carried to both
packages as numpy arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covomix_tpu.audio.mel import MelConfig as JMel, mel_spectrogram as jmel
from covomix_tpu.models import vocoder as JV
from covomix_tpu.train import gan as JG
from covomix_tpu_torch.audio.mel import MelConfig as PMel, mel_spectrogram as pmel
from covomix_tpu_torch.checkpoint import io as pio
from covomix_tpu_torch.models import vocoder as PV
from covomix_tpu_torch.ops import vocoder_tail as PVT
from covomix_tpu_torch.train import gan as PG
from covomix_tpu_torch.util.misc import named_leaves, tree_map

from _torch_port import J_VOC, P_VOC, jnp_tree, numpy_tree

SEG = 1600
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
# f32 convolutions of up to 1024 x 41 terms summed in another order
DISC_RTOL, DISC_ATOL = 1e-4, 1e-6


def assert_trees_close(port_tree, jax_tree, rtol, atol, what=""):
    ref = dict(named_leaves(jax.tree_util.tree_map(np.asarray, jax_tree)))
    got = dict(named_leaves(numpy_tree(port_tree)))
    assert got.keys() == ref.keys(), what
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=rtol, atol=atol, err_msg=f"{what} {k}")


@pytest.fixture(scope="module")
def state_np():
    """(gen, mpd, msd) numpy trees in the training (v, g) / (w, u, v) forms."""
    st = PG.init_gan_state(torch.Generator().manual_seed(0), P_VOC, PG.GanConfig(segment_size=SEG))
    return numpy_tree(st.gen_params), numpy_tree(st.mpd_params), numpy_tree(st.msd_params)


def audio(seed, b=2, t=SEG, scale=0.3):
    return (np.random.RandomState(seed).randn(b, t) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# discriminators and losses


@pytest.mark.parametrize("t", [SEG, SEG + 1])
def test_discriminators_and_losses_match_jax(t):
    """MPD / MSD scores and feature maps (JAX layouts), and the three losses,
    on plain weights; SEG+1 reflect-pads every period, SEG the periods 3, 7
    and 11."""
    g = torch.Generator().manual_seed(1)
    mpd, msd = numpy_tree(PV.init_mpd(g)), numpy_tree(PV.init_msd(g))
    y, y_hat = audio(2, t=t), audio(3, t=t)
    for name, prm in (("mpd", mpd), ("msd", msd)):
        jr = jax.jit(getattr(JV, name))(jnp_tree(prm), jnp.asarray(y), jnp.asarray(y_hat))
        pr = getattr(PV, name)(tree_map(torch.from_numpy, prm), torch.from_numpy(y), torch.from_numpy(y_hat))
        for part, a, b in zip(("real", "gen", "fmap_r", "fmap_g"), pr, jr):
            assert_trees_close(a, b, DISC_RTOL, DISC_ATOL, f"{name} {part}")
        for fn, args in (("feature_loss", (2, 3)), ("discriminator_loss", (0, 1)), ("generator_adv_loss", (1,))):
            want = float(getattr(JV, fn)(*(jr[i] for i in args)))
            got = float(getattr(PV, fn)(*(pr[i] for i in args)))
            np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, err_msg=f"{name} {fn}")


def test_avgpool_counts_padding():
    x = audio(4, t=37)
    want = np.asarray(JV._avgpool4_2(jnp.asarray(x)))
    np.testing.assert_allclose(PV._avgpool4_2(torch.from_numpy(x)).numpy(), want, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# weight norm and spectral norm


def test_weight_norm_split_fold_match_jax():
    """(v, g) of the generator (ConvTranspose1d `ups` normed per input
    channel) and of the discriminators, folded back, against the JAX package."""
    g = torch.Generator().manual_seed(2)
    gen = numpy_tree(PV.init_generator(g, P_VOC))
    mpd = {"discriminators": numpy_tree(PV.init_mpd(g))["discriminators"][:1]}
    split = PG.wn_split(tree_map(torch.from_numpy, gen))
    jsplit = JG.wn_split(jnp_tree(gen))
    assert_trees_close(split, jsplit, 1e-6, 1e-7, "wn_split")
    assert split["ups"][0]["g"].shape == (1, 16, 1)      # per input channel: torch [I, O, K], dim 0
    assert split["conv_pre"]["g"].shape == (1, 1, 16)
    assert_trees_close(PG.wn_fold(split), JG.wn_fold(jsplit), 1e-6, 1e-7, "wn_fold")
    assert_trees_close(PG.wn_fold(split), gen, 1e-5, 1e-7, "fold of split")
    pm = PG.wn_split(tree_map(torch.from_numpy, mpd), transposed_paths=())
    assert_trees_close(pm, JG.wn_split(jnp_tree(mpd), transposed_paths=()), 1e-6, 1e-7, "mpd wn_split")


def test_spectral_norm_matches_jax(state_np):
    """MSD[0]'s (u, v): the JAX package's RandomState draws in tree order,
    each normalized in f32 (the norm's sum is reduced in another order: the
    norm may differ by one unit in the last place and so each quotient by
    up to two; a draw out of order would differ everywhere); then three
    power iterations and the fold."""
    msd0 = state_np[2]["discriminators"][0]
    plain = tree_map(lambda a: a, msd0)
    for leaf in [*plain["convs"], plain["conv_post"]]:
        leaf.pop("u"), leaf.pop("v")
    ps = PG.sn_split(tree_map(torch.from_numpy, plain))
    js = JG.sn_split(jnp_tree(plain))
    ref = dict(named_leaves(jax.tree_util.tree_map(np.asarray, js)))
    for name, a in named_leaves(numpy_tree(ps)):
        np.testing.assert_array_max_ulp(a, ref[name], maxulp=2 if name.endswith(("/u", "/v")) else 0)
    for _ in range(3):
        ps, js = PG.sn_power_iter(ps), JG.sn_power_iter(js)
    assert_trees_close(ps, js, 1e-5, 1e-7, "sn_power_iter")
    for leaf in [*ps["convs"], ps["conv_post"]]:
        np.testing.assert_allclose(torch.linalg.vector_norm(leaf["u"]).item(), 1.0, rtol=1e-6)
    assert_trees_close(PG.sn_fold(ps), JG.sn_fold(js), 1e-5, 1e-7, "sn_fold")


def test_split_discriminators_layout(state_np):
    _, mpd, msd = state_np
    ds = msd["discriminators"]
    assert set(ds[0]["convs"][0]) == {"w", "b", "u", "v"} and set(ds[1]["convs"][0]) == {"b", "v", "g"}
    assert set(mpd["discriminators"][0]["convs"][0]) == {"b", "v", "g"}
    names = [n for n, _ in PG.trainable_leaves({"mpd": mpd, "msd": msd})]
    assert not any(n.startswith("msd/discriminators/0/") and n.endswith(("/u", "/v")) for n in names)
    assert "msd/discriminators/1/convs/0/v" in names and "msd/discriminators/0/convs/0/w" in names


# ---------------------------------------------------------------------------
# gradients of the generator side


def test_mel_l1_and_generator_gradients_match_jax(state_np):
    """The two pieces of the G step's mel term, each against jax.grad: the
    mel-L1 gradient with respect to a broadband waveform, and the
    generator's parameter gradient (through the (v, g) fold) of a weighted
    sum of its output. At a random generator's output the mel-L1 gradient is
    ill-conditioned (bins at the 1e-9 / 1e-5 floors: a 1e-6 relative change
    of y_hat moves JAX's own gradient by ~10 %), so the pieces are held
    apart; tests/test_torch_gan_step.py holds the step's gradients."""
    y = audio(5)
    tgt = jmel(jnp.asarray(audio(6)), JMel())
    gj = np.asarray(jax.jit(jax.grad(lambda x: jnp.mean(jnp.abs(jmel(x, JMel()) - tgt))))(jnp.asarray(y)))
    t = torch.tensor(y, requires_grad=True)
    torch.mean(torch.abs(pmel(t, PMel()) - torch.from_numpy(np.array(tgt)))).backward()
    np.testing.assert_allclose(t.grad.numpy(), gj, rtol=GRAD_RTOL, atol=GRAD_ATOL)

    gen = state_np[0]
    rs = np.random.RandomState(7)
    mel = rs.randn(2, 10, 80).astype(np.float32)
    w = rs.randn(2, PV.output_length(P_VOC, 10)).astype(np.float32)
    jg = jax.jit(jax.grad(lambda p: jnp.sum(JV.generator(JG.wn_fold(p), J_VOC, jnp.asarray(mel), fuse_tail=False)
                                            * w)))(jnp_tree(gen))
    pp = tree_map(lambda a: torch.tensor(a, requires_grad=True), gen)
    (PV.generator(PG.wn_fold(pp), P_VOC, torch.from_numpy(mel), fuse_tail=False) * torch.from_numpy(w)).sum().backward()
    assert_trees_close(tree_map(lambda p: p.grad, pp), jg, GRAD_RTOL, GRAD_ATOL, "generator grad")


# ---------------------------------------------------------------------------
# export


def test_export_generator_matches_jax(state_np):
    """export_generator folds the (v, g) leaves as the JAX package's, detached."""
    cfg_p = PG.GanConfig(segment_size=SEG)
    ps = PG.make_gan_state(*(tree_map(torch.from_numpy, t) for t in state_np), cfg_p)
    out = PG.export_generator(ps, cfg_p)
    assert "w" in out["conv_pre"] and not any(p.requires_grad for _, p in named_leaves(out))
    js = JG.GanState(jnp_tree(state_np[0]), None, None, None, None, None)   # export reads the generator only
    assert_trees_close(out, JG.export_generator(js, JG.GanConfig(segment_size=SEG)), 1e-6, 1e-7, "export")


# ---------------------------------------------------------------------------
# GAN train state on disk


def test_gan_state_save_load_roundtrip(tmp_path, state_np):
    """Every leaf, the spectral buffers, both optimizers' moments and counts
    and the step survive save / load into a state of other values."""
    cfg = PG.GanConfig(segment_size=SEG)
    ps = PG.make_gan_state(*(tree_map(torch.from_numpy, t) for t in state_np), cfg, step=7)
    rs = np.random.RandomState(3)
    for opt, tree, count in ((ps.opt_g, ps.gen_params, 7), (ps.opt_d, ps.d_params, 6)):
        leaves = PG.trainable_leaves(tree)
        moments = [{n: rs.randn(*p.shape).astype(np.float32) for n, p in leaves} for _ in range(2)]
        pio._set_adam(opt, leaves, count, *moments)
    ds = ps.msd_params["discriminators"]
    ds[0] = PG.sn_power_iter(ds[0])
    pio.save_train_state(str(tmp_path), ps, 7)
    assert pio.latest_step(str(tmp_path)) == 7

    other = PG.init_gan_state(torch.Generator().manual_seed(5), P_VOC, cfg)
    loaded = pio.load_train_state(str(tmp_path), 7, other)
    assert loaded.step == 7
    for key in ("gen_params", "mpd_params", "msd_params"):
        for (n, a), (_, b) in zip(named_leaves(getattr(ps, key)), named_leaves(getattr(loaded, key))):
            assert torch.equal(a, b), f"{key} {n}"
    u = loaded.msd_params["discriminators"][0]["convs"][0]["u"]
    assert not u.requires_grad and torch.equal(u, ds[0]["convs"][0]["u"])
    for opt_a, opt_b in ((ps.opt_g, loaded.opt_g), (ps.opt_d, loaded.opt_d)):
        assert PG.opt_count(opt_a) == PG.opt_count(opt_b)
        for pa, pb in zip(opt_a.param_groups[0]["params"], opt_b.param_groups[0]["params"]):
            for slot in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(opt_a.state[pa][slot], opt_b.state[pb][slot])
    assert (PG.opt_count(loaded.opt_g), PG.opt_count(loaded.opt_d)) == (7, 6)


# ---------------------------------------------------------------------------
# the fused kernels have no backward


def test_fused_wrappers_raise_under_grad():
    """As in the JAX package (no VJP): a fused stage / tail call that
    autograd would record raises, on any device, instead of handing the
    input to the plain version; under no_grad the plain version runs on CPU
    tensors."""
    gen = PV.init_generator(torch.Generator().manual_seed(3), P_VOC)
    mel = torch.randn(1, 16, 80)
    with torch.no_grad():
        ref = PV.generator(gen, P_VOC, mel, fuse_tail=True)
    for p in [p for _, p in named_leaves(gen)]:
        p.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        PV.generator(gen, P_VOC, mel, fuse_tail=True)
    with pytest.raises(RuntimeError, match="fused_tail has no backward"):
        PVT.fused_tail(torch.randn(1, 8, 2, requires_grad=True), gen["ups"][3], gen["resblocks"][9:12],
                       gen["conv_post"])
    with pytest.raises(RuntimeError, match="fused_stage has no backward"):
        PVT.fused_stage(torch.randn(1, 4, 4, requires_grad=True), gen["ups"][2], gen["resblocks"][6:9])
    with torch.no_grad():
        torch.testing.assert_close(PV.generator(gen, P_VOC, mel, fuse_tail=True), ref, rtol=0, atol=0)
    out = PV.generator(gen, P_VOC, mel, fuse_tail=False)     # the unfused generator is differentiable
    out.sum().backward()
    assert gen["conv_pre"]["w"].grad is not None
