"""The port's helper modules that only tests reach, against the JAX
package on the same seeded inputs: the complex STFT / iSTFT and spectral
transforms (audio/spec.py) with the legacy `Specs` dataset
(data/specs_legacy.py) within 1e-5, mcep / f0 (audio/mcep_f0.py) and the
DDPM schedules (util/ddpm_schedules.py) within 1e-9, light / dynamic
convolution (ops/lightconv.py) within 1e-5, and the host helpers that were
the JAX package's `native` functions (levenshtein_batch, token_block_slices,
block_to_dataset_index: equal; balanced_assignment: exactly balanced and
within T eps of JAX's total score)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from covomix_tpu import native as JN
from covomix_tpu.audio import mcep_f0 as JMc, spec as JS
from covomix_tpu.audio.wav import save_wav
from covomix_tpu.data import specs_legacy as JL
from covomix_tpu.ops import lightconv as JLC
from covomix_tpu.util import ddpm_schedules as JDS
from covomix_tpu_torch.audio import mcep_f0 as PMc, spec as PS
from covomix_tpu_torch.data import batching as PB, specs_legacy as PL
from covomix_tpu_torch.ops import lightconv as PLC
from covomix_tpu_torch.util import assignment as PAs, ddpm_schedules as PDS, text_metrics as PTM

N_FFT, HOP = 510, 128


def _close(got, ref, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, (got.shape, ref.shape, got.dtype, ref.dtype)
    assert np.abs(got - ref).max() <= tol * max(1.0, np.abs(ref).max()), np.abs(got - ref).max()


@pytest.mark.parametrize("window_type", ["hann", "sqrthann"])
def test_stft_istft_match_jax_and_round_trip(window_type):
    rs = np.random.RandomState(0)
    x = (rs.randn(2, HOP * 41 + 17) * 0.3).astype(np.float32)
    assert np.array_equal(PS.get_window(window_type, N_FFT), JS.get_window(window_type, N_FFT))
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JS.stft_complex(jnp.asarray(x), N_FFT, HOP, window_type))
        ref1 = np.asarray(JS.stft_complex(jnp.asarray(x[0]), N_FFT, HOP, window_type, center=False))
        back = np.asarray(JS.istft(jnp.asarray(ref), N_FFT, HOP, window_type, length=x.shape[1]))
        back_short = np.asarray(JS.istft(jnp.asarray(ref[0]), N_FFT, HOP, window_type, length=HOP * 50))
    spec = PS.stft_complex(torch.from_numpy(x), N_FFT, HOP, window_type)
    _close(spec, ref, 1e-5)
    _close(PS.stft_complex(torch.from_numpy(x[0]), N_FFT, HOP, window_type, center=False), ref1, 1e-5)
    y = PS.istft(torch.from_numpy(ref), N_FFT, HOP, window_type, length=x.shape[1])
    _close(y, back, 1e-5)
    _close(PS.istft(torch.from_numpy(ref[0]), N_FFT, HOP, window_type, length=HOP * 50), back_short, 1e-5)
    assert np.abs(PS.istft(spec, N_FFT, HOP, window_type, length=x.shape[1]).numpy() - x)[:, N_FFT:-N_FFT].max() < 1e-4
    with pytest.raises(NotImplementedError):
        PS.get_window("blackman", 16)


@pytest.mark.parametrize("transform_type", ["exponent", "log", "none"])
def test_spec_transforms_match_jax(transform_type):
    rs = np.random.RandomState(2)
    z = (rs.randn(64, 33) + 1j * rs.randn(64, 33)).astype(np.complex64)
    z[3, 4] = 0
    for e in (0.5, 1.0):
        ref = np.asarray(JS.spec_fwd(jnp.asarray(z), transform_type, 0.15, e))
        got = PS.spec_fwd(torch.from_numpy(z), transform_type, 0.15, e)
        _close(got, ref, 1e-5)
        _close(PS.spec_back(got, transform_type, 0.15, e), np.asarray(JS.spec_back(jnp.asarray(ref), transform_type,
                                                                                   0.15, e)), 1e-5)
    with pytest.raises(ValueError):
        PS.spec_fwd(torch.from_numpy(z), "nope")


@pytest.fixture(scope="module")
def specs_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("specs")
    rs = np.random.RandomState(3)
    for sub in ("s1", "mix_both", "mix_single"):
        (d / "train" / sub).mkdir(parents=True)
    for i, t in enumerate([HOP * 300, HOP * 280, HOP * 100]):   # the last is shorter than the crop
        x = rs.randn(t) * 0.1
        save_wav(str(d / "train" / "s1" / f"u{i}.wav"), x.astype(np.float32), 8000)
        save_wav(str(d / "train" / "mix_both" / f"u{i}.wav"), (x + rs.randn(t) * 0.05).astype(np.float32), 8000)
        save_wav(str(d / "train" / "mix_single" / f"u{i}.wav"), (x + rs.randn(t) * 0.02).astype(np.float32), 8000)
    return str(d)


@pytest.mark.parametrize("shuffle,normalize,only", [(False, "noisy", "no"), (True, "clean", "no"),
                                                     (True, "not", "yes")])
def test_specs_dataset_matches_jax(specs_dir, shuffle, normalize, only):
    kw = dict(dummy=False, shuffle_spec=shuffle, num_frames=256, normalize=normalize, only_enhancement=only,
              stft_kwargs=dict(n_fft=N_FFT, hop_length=HOP, center=True, window="hann"))
    jds, pds = JL.Specs(specs_dir, "train", **kw), PL.Specs(specs_dir, "train", device="cpu", **kw)
    assert pds.clean_files == jds.clean_files and pds.noisy_files == jds.noisy_files and len(pds) == len(jds) == 3
    for i in range(3):
        np.random.seed(10 + i)
        with jax.default_matmul_precision("highest"):
            ref = [np.asarray(a) for a in jds[i]]
        np.random.seed(10 + i)
        got = pds[i]
        for g, r in zip(got, ref):
            _close(g, r, 1e-5)
    assert len(PL.Specs(specs_dir, "train", device="cpu", **{**kw, "dummy": True})) == 0
    with pytest.raises(AssertionError):
        PL.Specs(specs_dir, "train", device="cpu", **{**kw, "stft_kwargs": dict(n_fft=N_FFT, hop_length=HOP,
                                                                               center=False, window="hann")})


def test_remove_unwanted_backchannels_matches_jax():
    for s in ("hi [backchannel] there", "[spkchange] [backchannel] ok", "[backchannel] lead",
              "a [spkchange] [partialoverlap] b [partialoverlap]", "", "[partialoverlap]"):
        assert PL.remove_unwanted_backchannels(s) == JL.remove_unwanted_backchannels(s)


def test_mcep_f0_match_jax():
    rs = np.random.RandomState(4)
    noisy = np.abs(rs.randn(257)) + 0.05
    assert np.abs(PMc.mcep(noisy, 20) - JMc.mcep(noisy, 20)).max() <= 1e-9
    order = 60          # decode_harmonic keeps 60 coefficients
    basis = JMc._warp_basis(JMc.FFT_SIZE // 2 + 1, order - 1, JMc.ALPHA)
    sp = np.exp((rs.randn(3, order) * 0.2 / (1 + np.arange(order))) @ basis.T)
    mfsc = PMc.code_harmonic(sp, order)
    assert np.abs(mfsc - JMc.code_harmonic(sp, order)).max() <= 1e-9 * np.abs(mfsc).max()
    dec = PMc.decode_harmonic(mfsc)
    assert np.abs(dec - JMc.decode_harmonic(mfsc)).max() <= 1e-9 * np.abs(dec).max()
    f0 = np.array([0.0, 30.0, 50.0, 120.0, 440.0, 1100.0, 2000.0])
    assert np.array_equal(PMc.f0_to_coarse(f0), JMc.f0_to_coarse(f0))


def test_ddpm_schedules_match_jax():
    for kind in ("linear", "cosine", "sqrt_linear", "sqrt"):
        assert np.abs(PDS.make_beta_schedule(kind, 50) - JDS.make_beta_schedule(kind, 50)).max() <= 1e-9
    for kind in ("uniform", "quad"):
        assert np.array_equal(PDS.make_ddim_timesteps(kind, 8, 100, verbose=False),
                              JDS.make_ddim_timesteps(kind, 8, 100, verbose=False))
    acum = np.cumprod(1 - JDS.make_beta_schedule("linear", 100))
    ts = JDS.make_ddim_timesteps("uniform", 10, 100, verbose=False) - 1
    for got, ref in zip(PDS.make_ddim_sampling_parameters(acum, ts, 0.5, verbose=False),
                        JDS.make_ddim_sampling_parameters(acum, ts, 0.5, verbose=False)):
        assert np.abs(got - ref).max() <= 1e-9
    bar = lambda t: np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
    assert np.abs(PDS.betas_for_alpha_bar(30, bar) - JDS.betas_for_alpha_bar(30, bar)).max() <= 1e-9
    a = np.linspace(0.1, 0.9, 40)
    t = np.array([0, 7, 39])
    got = PDS.extract_into_tensor(torch.from_numpy(a), torch.from_numpy(t), (3, 80, 16))
    ref = np.asarray(JDS.extract_into_tensor(jnp.asarray(a, jnp.float32), jnp.asarray(t), (3, 80, 16)))
    assert got.shape == ref.shape == (3, 1, 1) and np.abs(got.numpy() - ref).max() <= 1e-7
    with pytest.raises(ValueError):
        PDS.make_beta_schedule("nope", 5)


@pytest.mark.parametrize("softmax", [True, False])
@pytest.mark.parametrize("padding_l", [3, 1], ids=["causal", "centred"])
def test_light_and_dynamic_conv_match_jax(softmax, padding_l):
    rs = np.random.RandomState(5)
    x = rs.randn(2, 10, 8).astype(np.float32)
    w = rs.randn(2, 4).astype(np.float32)
    ref = np.asarray(JLC.light_conv(jnp.asarray(x), jnp.asarray(w), padding_l=padding_l, softmax=softmax))
    _close(PLC.light_conv(torch.from_numpy(x), torch.from_numpy(w), padding_l=padding_l, softmax=softmax), ref, 1e-5)
    dw = rs.randn(2, 10, 4, 4).astype(np.float32)
    ref = np.asarray(JLC.dynamic_conv(jnp.asarray(x), jnp.asarray(dw), padding_l=padding_l, softmax=softmax))
    _close(PLC.dynamic_conv(torch.from_numpy(x), torch.from_numpy(dw), padding_l=padding_l, softmax=softmax),
           ref, 1e-5)


def test_levenshtein_batch_matches_jax():
    rs = np.random.RandomState(6)
    refs = [rs.randint(0, 5, rs.randint(0, 20)) for _ in range(15)]
    hyps = [rs.randint(0, 5, rs.randint(0, 20)) for _ in range(15)]
    got = PTM.levenshtein_batch(refs, hyps)
    assert got.dtype == np.int64 and np.array_equal(got, JN.levenshtein_batch(refs, hyps))
    assert PTM.levenshtein_batch([], []).shape == (0,)


@pytest.mark.parametrize("mode", ["none", "complete", "complete_doc", "eos"])
def test_token_blocks_match_jax(mode):
    rs = np.random.RandomState(7)
    sizes = rs.randint(1, 9, 40)
    sizes[[5, 17, 30]] = 1          # document separators for complete_doc
    sizes[[8, 22]] = 0
    for block in (1, 6, 16):
        got = PB.token_block_slices(sizes, block, mode)
        ref = JN.token_block_slices(sizes, block, mode)
        assert got.dtype == np.int64 and np.array_equal(got, ref), (mode, block)
        assert np.array_equal(PB.block_to_dataset_index(sizes, got), JN.block_to_dataset_index(sizes, ref))
    assert np.array_equal(PB.token_block_slices([], 4, mode), JN.token_block_slices([], 4, mode).reshape(-1, 2))
    with pytest.raises(ValueError):
        PB.token_block_slices(sizes, 4, "sentence")


@pytest.mark.parametrize("t,e", [(6, 2), (12, 4), (64, 8)])
def test_balanced_assignment_within_bound_of_jax(t, e):
    rs = np.random.RandomState(t + e)
    scores = rs.randn(t, e).astype(np.float32)
    got, ref = PAs.balanced_assignment(scores), JN.balanced_assignment(scores)
    assert got.dtype == np.int64 and np.array_equal(np.bincount(got, minlength=e), np.full(e, t // e))
    total = lambda owner: float(scores[np.arange(t), owner].sum())
    eps = max((scores.max() - scores.min()) / 50.0, 1e-4)
    assert abs(total(got) - total(ref)) <= t * eps + 1e-4
    blocks = np.full((8, 2), -1.0, np.float32)
    blocks[:4, 0] = blocks[4:, 1] = 1.0
    assert np.array_equal(PAs.balanced_assignment(blocks), [0, 0, 0, 0, 1, 1, 1, 1])
