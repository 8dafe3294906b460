"""`python -m covomix_tpu_torch.hifigan_train` on the CPU (`--device cpu`) at
a tiny generator (initial channel 16, segment 1600, batch 2): two steps
write the `g_` generator and the `step_` train state, a resume continues the
counters, `--init_g` / `--init_do` read reference-layout `g_` / `do_` files
written here with torch.nn convolutions under weight_norm / spectral_norm,
`--dp 3` on a batch of 2 raises, and the exported `g_*.npz` loads in the JAX package and
vocodes as the port does."""

import contextlib
import dataclasses
import io
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covomix_tpu.checkpoint import io as jio
from covomix_tpu.models import vocoder as JV
from covomix_tpu_torch import hifigan_train as HT
from covomix_tpu_torch.audio import save_wav
from covomix_tpu_torch.checkpoint import io as pio
from covomix_tpu_torch.models import vocoder as PV
from covomix_tpu_torch.train import gan as PG
from covomix_tpu_torch.util.misc import named_leaves

from _torch_port import torch_threads

CONFIG = {"resblock": "1", "batch_size": 2, "learning_rate": 0.0002, "adam_b1": 0.8, "adam_b2": 0.99,
          "lr_decay": 0.999, "upsample_rates": [5, 4, 4, 2], "upsample_kernel_sizes": [8, 8, 4, 4],
          "upsample_initial_channel": 16, "resblock_kernel_sizes": [3, 7, 11],
          "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]], "segment_size": 1600, "num_mels": 80,
          "n_fft": 480, "hop_size": 160, "win_size": 480, "sampling_rate": 8000, "fmin": 0, "fmax": 4000,
          "fmax_for_loss": None}
LOSSES = ("loss_disc", "loss_gen", "mel_error", "loss_fm", "loss_adv")


def write_assets(root):
    """Four training wavs (0.15-0.6 s: shorter and longer than a segment),
    one validation wav, the config JSON."""
    rs = np.random.RandomState(0)
    for d, secs in (("wavs", (0.15, 0.3, 0.45, 0.6)), ("val", (0.3,))):
        os.makedirs(os.path.join(root, d))
        for i, s in enumerate(secs):
            t = np.arange(int(8000 * s)) / 8000
            x = 0.3 * np.sin(2 * np.pi * (120 + 40 * i) * t) + 0.02 * rs.randn(len(t))
            save_wav(os.path.join(root, d, f"u{i}.wav"), x.astype(np.float32), 8000)
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(CONFIG, f)


def run_cli(root, ckpt, *extra):
    """main() in process with 4 torch threads; returns (state, stdout)."""
    out = io.StringIO()
    argv = ["--input_wavs_dir", os.path.join(root, "wavs"), "--config", os.path.join(root, "config.json"),
            "--checkpoint_path", ckpt, "--device", "cpu", "--num_workers", "1", "--stdout_interval", "1", *extra]
    with torch_threads(4), contextlib.redirect_stdout(out):
        state = HT.main(argv)
    return state, out.getvalue()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("hifigan_train"))
    write_assets(root)
    ckpt = os.path.join(root, "cp")
    state, out = run_cli(root, ckpt, "--training_steps", "2", "--checkpoint_interval", "2",
                         "--input_validation_dir", os.path.join(root, "val"), "--validation_interval", "2")
    return root, ckpt, state, out


def json_lines(out):
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def test_two_steps_write_generator_and_state(trained):
    root, ckpt, state, out = trained
    lines = json_lines(out)
    steps = [r for r in lines if "loss_gen" in r]
    assert [r["step"] for r in steps] == [1, 2]
    assert all(np.isfinite(r[k]) for r in steps for k in LOSSES)
    val = [r for r in lines if "validation_mel_l1" in r]
    assert len(val) == 1 and val[0]["step"] == 2 and np.isfinite(val[0]["validation_mel_l1"])
    assert os.path.isfile(os.path.join(ckpt, "step_00000002", "state.npz"))
    assert pio.latest_step(ckpt) == 2
    meta = pio.load_meta(os.path.join(ckpt, "g_00000002.npz"))
    assert meta["kind"] == "vocoder" and meta["config"]["upsample_initial_channel"] == 16
    g = pio.load_params(os.path.join(ckpt, "g_00000002.npz"))
    assert set(g["conv_pre"]) == {"w", "b"}
    exported = PG.export_generator(state, PG.GanConfig(segment_size=1600))
    for (n, a), (_, b) in zip(named_leaves(exported), named_leaves(g)):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=n)
    assert state.step == 2 and PG.opt_count(state.opt_g) == PG.opt_count(state.opt_d) == 2
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        assert any("validation_mel_l1" in json.loads(line) for line in f)


def test_resume_continues_counters(trained, tmp_path):
    """A second run over the same checkpoint directory loads step 2 (leaves,
    spectral buffers, moments, counts) and takes one more step."""
    root, ckpt, state, _ = trained
    ckpt2 = str(tmp_path / "cp")
    shutil.copytree(ckpt, ckpt2)
    saved = pio.load_train_state(ckpt2, 2, PG.init_gan_state(torch.Generator().manual_seed(9), PV.VocoderConfig(
        upsample_initial_channel=16), PG.GanConfig(segment_size=1600)))
    for key in ("gen_params", "msd_params"):
        for (n, a), (_, b) in zip(named_leaves(getattr(saved, key)), named_leaves(getattr(state, key))):
            assert torch.equal(a, b), n
    resumed, out = run_cli(root, ckpt2, "--training_steps", "3", "--checkpoint_interval", "2")
    assert "resumed from step 2" in out
    assert [r["step"] for r in json_lines(out) if "loss_gen" in r] == [3]
    assert resumed.step == 3 and PG.opt_count(resumed.opt_g) == PG.opt_count(resumed.opt_d) == 3


def test_dp_raises(trained):
    """--dp 3 on the config's batch of 2 raises JAX's assertion before any
    rank starts (the batch must divide by dp)."""
    root, _, _, _ = trained
    with pytest.raises(AssertionError, match="batch 2 not divisible by dp=3"):
        HT.main(["--input_wavs_dir", os.path.join(root, "wavs"), "--config", os.path.join(root, "config.json"),
                 "--dp", "3", "--device", "cpu"])


# ---------------------------------------------------------------------------
# reference-layout g_ / do_ files


def _wn(m):
    return torch.nn.utils.weight_norm(m)


def _put(sd, prefix, module):
    for k, v in module.state_dict().items():
        sd[f"{prefix}.{k}"] = v


def reference_generator(cfg):
    """{key: tensor} of hifi-gan's Generator (models.py:75-125) built from
    weight-normed torch.nn convolutions, and {path: effective weight}."""
    torch.manual_seed(1)
    sd, mods = {}, {}
    c0 = cfg["upsample_initial_channel"]
    conv = lambda key, m: (_put(sd, key, m), mods.__setitem__(key, m))
    conv("conv_pre", _wn(torch.nn.Conv1d(80, c0, 7, 1, padding=3)))
    for i, (u, k) in enumerate(zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"])):
        conv(f"ups.{i}", _wn(torch.nn.ConvTranspose1d(c0 // 2 ** i, c0 // 2 ** (i + 1), k, u, padding=(k - u) // 2)))
        ch = c0 // 2 ** (i + 1)
        for j, (kr, dil) in enumerate(zip(cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"])):
            for n, d in enumerate(dil):
                conv(f"resblocks.{3 * i + j}.convs1.{n}", _wn(torch.nn.Conv1d(ch, ch, kr, 1, dilation=d,
                                                                               padding=(kr * d - d) // 2)))
                conv(f"resblocks.{3 * i + j}.convs2.{n}", _wn(torch.nn.Conv1d(ch, ch, kr, 1, padding=(kr - 1) // 2)))
    conv("conv_post", _wn(torch.nn.Conv1d(c0 // 16, 1, 7, 1, padding=3)))
    return sd, mods


def reference_discriminators():
    """{'mpd': sd, 'msd': sd} of hifi-gan's MPD / MSD (models.py:128-248):
    weight_norm on every MPD conv and MSD 1-2, spectral_norm on MSD 0."""
    torch.manual_seed(2)
    mpd, msd, mods = {}, {}, {}
    for d in range(5):
        cin = 1
        for c, cout in enumerate((32, 128, 512, 1024, 1024)):
            m = _wn(torch.nn.Conv2d(cin, cout, (5, 1), (3, 1) if c < 4 else 1, padding=(2, 0)))
            _put(mpd, f"discriminators.{d}.convs.{c}", m)
            mods[f"mpd/discriminators/{d}/convs/{c}"] = m
            cin = cout
        m = _wn(torch.nn.Conv2d(1024, 1, (3, 1), 1, padding=(1, 0)))
        _put(mpd, f"discriminators.{d}.conv_post", m)
        mods[f"mpd/discriminators/{d}/conv_post"] = m
    for d in range(3):
        norm = torch.nn.utils.spectral_norm if d == 0 else _wn
        cin = 1
        for c, (cout, k, s, g, pd) in enumerate(PV._MSD_SPECS):
            m = norm(torch.nn.Conv1d(cin, cout, k, s, groups=g, padding=pd))
            _put(msd, f"discriminators.{d}.convs.{c}", m)
            mods[f"msd/discriminators/{d}/convs/{c}"] = m
            cin = cout
        m = norm(torch.nn.Conv1d(1024, 1, 3, 1, padding=1))
        _put(msd, f"discriminators.{d}.conv_post", m)
        mods[f"msd/discriminators/{d}/conv_post"] = m
    return {"mpd": mpd, "msd": msd, "steps": 0, "epoch": 0}, mods


def _tree_leaf(tree, path):
    for part in path.split("/"):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


def test_init_from_reference_torch_checkpoints(trained, tmp_path):
    """The generator, MPD and MSD as the reference's weight_norm /
    spectral_norm modules hold them: the folded weights equal each module's
    effective weight, MSD[0] keeps weight_orig and the u / v buffers."""
    root = trained[0]
    g_sd, g_mods = reference_generator(CONFIG)
    do, d_mods = reference_discriminators()
    g_path, do_path = str(tmp_path / "g_00000100"), str(tmp_path / "do_00000100")
    torch.save({"generator": g_sd}, g_path)
    torch.save(do, do_path)
    state, out = run_cli(root, str(tmp_path / "cp"), "--training_steps", "0", "--init_g", g_path,
                         "--init_do", do_path)
    assert f"generator initialized from {g_path}" in out and f"discriminators initialized from {do_path}" in out
    gen = PG.export_generator(state, PG.GanConfig(segment_size=1600))
    for key, m in g_mods.items():
        perm = (2, 0, 1) if key.startswith("ups.") else (2, 1, 0)     # ConvTranspose [I, O, K] -> [K, I, O]
        want = m.weight.detach().permute(*perm).numpy()
        np.testing.assert_allclose(_tree_leaf(gen, key.replace(".", "/"))["w"].numpy(), want, rtol=1e-5,
                                   atol=1e-7, err_msg=key)
    with torch.no_grad():
        mpd_f, msd_f = PG.fold_discriminators(state.mpd_params, state.msd_params)
    folded = {"mpd": mpd_f, "msd": msd_f}
    for key, m in d_mods.items():
        leaf = _tree_leaf(state.d_params, key)
        perm = (2, 3, 1, 0) if key.startswith("mpd") else (2, 1, 0)
        if key.startswith("msd/discriminators/0/"):
            np.testing.assert_array_equal(leaf["w"].detach().numpy(), m.weight_orig.detach().permute(*perm).numpy())
            np.testing.assert_array_equal(leaf["u"].numpy(), m.weight_u.numpy())
            # torch's v is flat over (i, k), the tree's over (k, i)
            np.testing.assert_array_equal(leaf["v"].numpy(),
                                          m.weight_v.reshape(-1, m.weight_orig.shape[2]).T.reshape(-1).numpy())
            assert not leaf["u"].requires_grad and leaf["w"].requires_grad
        else:
            want = m.weight.detach().permute(*perm).numpy()
            np.testing.assert_allclose(_tree_leaf(folded, key)["w"].detach().numpy(), want, rtol=1e-5, atol=1e-7,
                                       err_msg=key)
    assert state.step == 0 and PG.opt_count(state.opt_g) == PG.opt_count(state.opt_d) == 0


# ---------------------------------------------------------------------------
# the exported generator in the JAX package


def test_exported_generator_vocodes_in_jax(trained):
    """g_00000002.npz through the JAX package's load_params / load_meta and
    generator: the port generator's waveform within 1e-5."""
    _, ckpt, _, _ = trained
    path = os.path.join(ckpt, "g_00000002.npz")
    assert jio.load_meta(path)["kind"] == "vocoder"
    jparams = jax.tree_util.tree_map(jnp.asarray, jio.load_params(path))
    cfg = PV.config_from_json(pio.load_meta(path)["config"])
    mel = np.random.RandomState(4).randn(1, 24, 80).astype(np.float32) - 4.0
    jcfg = JV.VocoderConfig(**dataclasses.asdict(cfg))
    want = np.asarray(jax.jit(lambda p, m: JV.generator(p, jcfg, m, fuse_tail=False))(jparams, jnp.asarray(mel)))
    with torch.no_grad():
        got = PV.generator(pio.params_from_numpy(pio.load_params(path), "cpu"), cfg, torch.from_numpy(mel),
                           fuse_tail=False).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
