"""The port's fused vocoder stage and tail against the JAX package's Pallas
kernels (interpret mode) on the same weights and inputs.

On the CPU the port's `fused_stage` / `fused_tail` run their plain versions,
so these tests hold that arithmetic (and the generator's fused dispatch) to
the TPU kernels'; `chip_smoke.py` holds the CUDA kernels to the plain
versions on the card. f32 at 'highest' precision: 2e-5, the JAX package's
own tolerance for its fused kernels against the op-by-op path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from covomix_tpu.models import layers as JL
from covomix_tpu.models import vocoder as JV
from covomix_tpu.ops import vocoder_tail as JVT
from covomix_tpu_torch.models import vocoder as PV
from covomix_tpu_torch.ops import vocoder_tail as PVT

from _torch_port import port_cfg, to_port

KERNELS = (3, 7, 11)
DILS = ((1, 3, 5),) * 3
TOL = 2e-5


def _stage_params(seed, cin, c, post=False):
    """(up, blocks, post) JAX parameters of one stage: up [4, cin, c]."""
    key = jax.random.PRNGKey(seed)
    up = JL.conv1d_init(key, cin, c, 4)
    blocks = [JV._resblock1_init(jax.random.fold_in(key, j), c, KERNELS[j], DILS[j]) for j in range(3)]
    post_p = JL.conv1d_init(jax.random.fold_in(key, 9), c, 1, 7) if post else None
    return up, blocks, post_p


def _x(seed, shape, dtype=np.float32):
    return np.random.RandomState(seed).randn(*shape).astype(dtype)


def _generator_params(jcfg, seed):
    """(JAX, port) generator parameters, drawn by the port's init (faster on
    the CPU than JAX's per-shape random compiles) and carried as numpy."""
    pp = PV.init_generator(torch.Generator().manual_seed(seed), port_cfg(PV.VocoderConfig, jcfg))
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), pp), pp


@pytest.mark.parametrize("b,t1,tbu", [(1, 40, 512), (2, 100, 48), (1, 2, 48)],
                         ids=["one_tile", "tiles_tbu48", "shorter_than_halo"])
def test_fused_stage_plain_matches_jax(b, t1, tbu):
    c, cin = 62, 125
    up, blocks, _ = _stage_params(7, cin, c)
    x1 = _x(8, (b, t1, cin))
    with jax.default_matmul_precision("highest"):
        wup, wm, bm, plan = JVT.pack_stage_weights(up, blocks, c, cin, KERNELS, DILS, dtype=jnp.float32)
        ref = np.asarray(JVT.fused_stage(jnp.asarray(x1), wup, wm, bm, plan, channels=c, tbu=tbu, interpret=True))
    out = PVT.fused_stage(torch.from_numpy(x1), to_port(up), to_port(blocks), KERNELS, DILS).numpy()
    assert out.shape == ref.shape == (b, 4 * t1, c)
    assert np.abs(out - ref).max() < TOL


@pytest.mark.parametrize("b,t2,tbu", [(1, 120, 512), (2, 420, 64), (1, 2, 64)],
                         ids=["one_tile", "tiles_tbu64", "shorter_than_halo"])
def test_fused_tail_plain_matches_jax(b, t2, tbu):
    c = 31
    up, blocks, post = _stage_params(0, 2 * c, c, post=True)
    x2 = _x(1, (b, t2, 2 * c))
    with jax.default_matmul_precision("highest"):
        wm, bm, plan = JVT.pack_tail_weights(up, blocks, post, c, KERNELS, DILS, dtype=jnp.float32)
        ref = np.asarray(JVT.fused_tail(jnp.asarray(x2), wm, bm, plan, channels=c, tbu=tbu, interpret=True))
    out = PVT.fused_tail(torch.from_numpy(x2), to_port(up), to_port(blocks), to_port(post), KERNELS, DILS).numpy()
    assert out.shape == ref.shape == (b, 2 * t2)
    assert np.abs(out - ref).max() < TOL


def test_fused_stage_plain_bf16_matches_jax():
    """bf16 both sides, rounding at the same points: outputs of magnitude ~1
    differ by at most a few bf16 ulps (2^-8 at 1) where f32 sums taken in
    another order round to the neighbouring bf16 value and carry through."""
    c, cin = 62, 125
    up, blocks, _ = _stage_params(3, cin, c)
    x1 = _x(4, (1, 64, cin))
    with jax.default_matmul_precision("highest"):
        wup, wm, bm, plan = JVT.pack_stage_weights(up, blocks, c, cin, KERNELS, DILS, dtype=jnp.bfloat16)
        ref = JVT.fused_stage(jnp.asarray(x1, jnp.bfloat16), wup, wm, bm, plan, channels=c, tbu=64,
                              interpret=True)
        ref = np.asarray(ref.astype(jnp.float32))
    out = PVT.fused_stage(torch.from_numpy(x1).to(torch.bfloat16), to_port(up), to_port(blocks), KERNELS, DILS)
    assert out.dtype == torch.bfloat16
    err = np.abs(out.float().numpy() - ref)
    assert err.max() < 3e-2 and err.mean() < 1e-3


@pytest.mark.parametrize("channel", [496, 500])
def test_generator_fused_matches_jax_interpret(channel):
    """The port's generator(fuse_tail=True) (fused stage + tail, plain
    versions on the CPU) against JAX generator(fuse_tail='interpret')."""
    jcfg = JV.VocoderConfig(upsample_initial_channel=channel)
    jp, pp = _generator_params(jcfg, channel)
    mel = _x(6, (2, 4, 80)) * 0.5 - 4.0
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JV.generator(jp, jcfg, jnp.asarray(mel), fuse_tail="interpret"))
    out = PV.generator(pp, port_cfg(PV.VocoderConfig, jcfg), torch.from_numpy(mel), fuse_tail=True).numpy()
    assert out.shape == ref.shape == (2, PV.output_length(port_cfg(PV.VocoderConfig, jcfg), 4))
    assert np.abs(out - ref).max() < TOL


# rates / kernel sizes: the covomix chain, a rate-2 stage before the last, an
# odd last-stage length (kernel 5 at rate 4), a 3-stage chain, a kernel-3 tail
CHAINS = (((5, 4, 4, 2), (8, 8, 4, 4)), ((5, 4, 2, 2), (8, 8, 4, 4)), ((5, 4, 4, 2), (8, 8, 5, 4)),
          ((4, 4, 4), (8, 4, 4)), ((5, 4, 4, 2), (8, 8, 4, 3)))


def _cfg_grid():
    return [JV.VocoderConfig(upsample_initial_channel=c0, upsample_rates=rates, upsample_kernel_sizes=ks,
                             resblock=resblock)
            for c0 in (16, 496, 500, 512, 600) for rates, ks in CHAINS for resblock in ("1", "2")]


def test_can_fuse_tail_matches_jax():
    grid = _cfg_grid() + [JV.VocoderConfig(resblock_kernel_sizes=(3, 7)), JV.VocoderConfig()]
    flags = [PV._can_fuse_tail(port_cfg(PV.VocoderConfig, c)) for c in grid]
    assert flags == [JV._can_fuse_tail(c) for c in grid]
    assert any(flags) and not all(flags)


def test_per_stage_rule_matches_jax(monkeypatch):
    """With fuse_tail=True both generators fuse the same stages: the fused
    functions are swapped for recorders that return zeros of the right
    shape, over configs that do and do not meet the per-stage rule (odd
    last-stage length, rate/kernel mismatches, more than 64 channels)."""
    calls = {"jax": [], "port": []}

    def j_stage(x, wup, wm, bm, plan, *, channels, interpret=False):
        calls["jax"].append(("stage", x.shape[1], channels))
        return jnp.zeros((x.shape[0], 4 * x.shape[1], channels), x.dtype)

    def j_tail(x, wm, bm, plan, *, channels, interpret=False):
        calls["jax"].append(("tail", x.shape[1], channels))
        return jnp.zeros((x.shape[0], 2 * x.shape[1]), jnp.float32)

    def p_stage(x, up_p, blocks, kernels, dilations):
        calls["port"].append(("stage", x.shape[1], up_p["w"].shape[2]))
        return torch.zeros((x.shape[0], 4 * x.shape[1], up_p["w"].shape[2]), dtype=x.dtype)

    def p_tail(x, up_p, blocks, post_p, kernels, dilations):
        calls["port"].append(("tail", x.shape[1], up_p["w"].shape[2]))
        return torch.zeros((x.shape[0], 2 * x.shape[1]))

    monkeypatch.setattr(JVT, "fused_stage", j_stage)
    monkeypatch.setattr(JVT, "fused_tail", j_tail)
    monkeypatch.setattr(JVT, "pack_stage_weights", lambda *a, **k: (None, None, None, None))
    monkeypatch.setattr(JVT, "pack_tail_weights", lambda *a, **k: (None, None, None))
    monkeypatch.setattr(PVT, "fused_stage", p_stage)
    monkeypatch.setattr(PVT, "fused_tail", p_tail)
    mel = _x(2, (1, 2, 80))
    j_generator = jax.jit(JV.generator, static_argnums=(1,), static_argnames=("fuse_tail",))  # one compile per config
    n_fused = 0
    # 600 channels: 75 at the rate-4 stage, above the stage rule's 64
    for jcfg in [JV.VocoderConfig(upsample_initial_channel=16, upsample_rates=r, upsample_kernel_sizes=k)
                 for r, k in CHAINS] + [JV.VocoderConfig(upsample_initial_channel=600)]:
        calls["jax"].clear()
        calls["port"].clear()
        jp, pp = _generator_params(jcfg, 0)
        j_generator(jp, jcfg, jnp.asarray(mel), fuse_tail=True)
        PV.generator(pp, port_cfg(PV.VocoderConfig, jcfg), torch.from_numpy(mel), fuse_tail=True)
        assert calls["port"] == calls["jax"], jcfg
        n_fused += len(calls["jax"])
    assert n_fused > 0


def test_auto_on_cpu_equals_unfused():
    """fuse_tail=None on CPU tensors is the unfused path, even for the
    covomix config; valid_len forces it too."""
    jcfg = JV.VocoderConfig(upsample_initial_channel=16)
    cfg = port_cfg(PV.VocoderConfig, jcfg)
    _, pp = _generator_params(jcfg, 1)
    mel = torch.from_numpy(_x(3, (2, 6, 80)))
    unfused = PV.generator(pp, cfg, mel, fuse_tail=False)
    assert torch.equal(PV.generator(pp, cfg, mel), unfused)
    assert torch.equal(PV.generator(pp, cfg, mel, fuse_tail=True, valid_len=6),
                       PV.generator(pp, cfg, mel, valid_len=6))
    # f32: the fused functions' rounding points are no-ops, so only summation order may differ
    assert (PV.generator(pp, cfg, mel, fuse_tail=True) - unfused).abs().max() < TOL


def test_pack_weights_layout():
    """The bf16 MRF weights are in the kernel's fragment order: lane (g, t)
    of (tap, k-step, n-tile) holds w[ci = 16ks + 2t + {0, 1, 8, 9}][co = 8nt + g]."""
    c, cin = 62, 125
    up, blocks, _ = _stage_params(5, cin, c)
    pu, pb = to_port(up), to_port(blocks)
    pk = PVT.pack_weights(pu, pb, None, KERNELS, DILS, torch.bfloat16, "cpu")
    assert pk.cp == 64 and pk.w_up.shape == (4, cin, 64) and pk.b_mrf.shape == (18, 64)
    assert pk.taps == (3, 7, 11, 1, 3, 5, 1, 3, 5, 1, 3, 5)
    w = pb[0]["convs1"][0]["w"].to(torch.bfloat16)          # first conv: k = 3, [3, 62, 62]
    frag = pk.w_mrf[: 3 * 64 * 64].reshape(3, 4, 8, 8, 4, 4)  # tau, ks, nt, g, t, 4 values
    for tau, ks, nt, g, t in ((0, 0, 0, 0, 0), (2, 3, 7, 5, 3), (1, 2, 4, 7, 1)):
        co = 8 * nt + g
        for e, dci in enumerate((0, 1, 8, 9)):
            ci = 16 * ks + 2 * t + dci
            want = w[tau, ci, co] if ci < c and co < c else 0.0
            assert frag[tau, ks, nt, g, t, e] == want
    # f32: per tap and input channel, the first 4 channels of each 8-channel
    # group g, then their last 4: w[ci][co = 8g + 4h + e] at [tau, ci, h, g, e]
    f32 = PVT.pack_weights(pu, pb, None, KERNELS, DILS, torch.float32, "cpu")
    w32 = pb[0]["convs1"][0]["w"]
    blk = f32.w_mrf[: 3 * 64 * 64].reshape(3, 64, 2, 8, 4)
    for tau, ci, h, g, e in ((0, 0, 0, 0, 0), (2, 61, 1, 7, 1), (1, 5, 1, 3, 3), (2, 63, 0, 7, 3)):
        co = 8 * g + 4 * h + e
        assert blk[tau, ci, h, g, e] == (w32[tau, ci, co] if ci < c and co < c else 0.0)
    assert torch.equal(blk.permute(0, 1, 3, 2, 4).reshape(3, 64, 64)[:, :c, :c], w32)   # unpacked: the weights back
    tail = PVT.pack_weights(*(to_port(p) for p in _stage_params(6, 62, 31, post=True)), KERNELS, DILS,
                            torch.float32, "cpu")
    assert tail.cp == 32 and tail.w_post.shape == (7, 32)
    with pytest.raises(ValueError, match="3 ResBlock1 branches"):
        PVT.pack_weights(pu, pb, None, (3, 7), DILS[:2], torch.float32, "cpu")


@pytest.mark.parametrize("cin,c,cp", [(125, 62, 64), (62, 31, 32)])
def test_packed_mrf_taps_are_whole_aligned_slices(cin, c, cp):
    """The kernel's weight ring copies one tap per bulk copy: the bf16
    `w_mrf` holds the 126 taps of the default convs back to back, conv c
    starting at (sum of the earlier convs' k) * cp * cp, each tap one
    contiguous cp * cp slice at a 16-byte multiple, in fragment order (the
    stage's padding 64 and the tail's 32)."""
    up, blocks, _ = _stage_params(11, cin, c)
    pu, pb = to_port(up), to_port(blocks)
    pk = PVT.pack_weights(pu, pb, None, KERNELS, DILS, torch.bfloat16, "cpu")
    assert pk.cp == cp and pk.w_mrf.numel() == 126 * cp * cp == 6 * sum(KERNELS) * cp * cp
    assert pk.w_mrf.is_contiguous() and pk.w_mrf.data_ptr() % 16 == 0
    start = 0
    for j, k in enumerate(KERNELS):
        for l in range(3):
            for which in ("convs1", "convs2"):
                w = F.pad(pb[j][which][l]["w"].float(), (0, cp - c, 0, cp - c)).to(torch.bfloat16)
                for tau in range(k):
                    off = (start + tau) * cp * cp
                    assert off * 2 % 16 == 0
                    assert torch.equal(pk.w_mrf[off:off + cp * cp], PVT._mma_fragment_order(w[tau:tau + 1]))
                start += k
    assert start == 126


@pytest.mark.parametrize("cin,c,cp", [(125, 62, 64), (62, 31, 32)])
def test_packed_f32_mrf_taps_are_whole_aligned_slices(cin, c, cp):
    """The f32 ring copies one tap per bulk copy too: `w_mrf` holds the 126
    f32 taps back to back, each one contiguous cp * cp slice at a 16-byte
    multiple ([ci][h][g][4]), and unpacking each gives the conv's weights
    back."""
    up, blocks, _ = _stage_params(12, cin, c)
    pu, pb = to_port(up), to_port(blocks)
    pk = PVT.pack_weights(pu, pb, None, KERNELS, DILS, torch.float32, "cpu")
    assert pk.cp == cp and pk.w_mrf.dtype == torch.float32 and pk.w_mrf.numel() == 126 * cp * cp
    assert pk.w_mrf.is_contiguous() and pk.w_mrf.data_ptr() % 16 == 0
    start = 0
    for j, k in enumerate(KERNELS):
        for l in range(3):
            for which in ("convs1", "convs2"):
                w = pb[j][which][l]["w"]
                for tau in range(k):
                    off = (start + tau) * cp * cp
                    assert off * 4 % 16 == 0
                    tap = pk.w_mrf[off:off + cp * cp]
                    assert torch.equal(tap, PVT._f32_tap_order(F.pad(w[tau:tau + 1], (0, cp - c, 0, cp - c))))
                    unpacked = tap.reshape(cp, 2, cp // 8, 4).permute(0, 2, 1, 3).reshape(cp, cp)
                    assert torch.equal(unpacked[:c, :c], w[tau]) and not unpacked[c:].any() and not unpacked[:, c:].any()
                start += k
    assert start == 126


def test_split_probe_cuts_the_mrf_and_the_epilogue():
    """`chip_smoke.py --vocoder-split` times copies of the kernel source: one
    without the MRF (and without the weight ring's first fills, whose copies
    only the MRF waits for), one without the MRF and the epilogue. The
    markers it cuts at must stay in the source."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    with open(PVT.SOURCE) as f:
        text = f.read()
    v = chip_smoke.split_sources(text)
    assert v["full"] == text
    kernel = lambda t: t.split("vocoder_fused_kernel(Params<T> p) {", 1)[1].split("constexpr int kErrChannels", 1)[0]
    assert "run_conv<" in kernel(text) and "fill_stage<" in kernel(text)
    for name in ("no_mrf", "staging"):
        body = kernel(v[name])
        assert "run_conv<" not in body and "fill_stage<" not in body and "// 1. the block's input frames" in body
        assert v[name].endswith(text.split("constexpr int kErrChannels", 1)[1])
    assert "conv_post" in kernel(v["no_mrf"]) and "// 4. epilogue" not in kernel(v["staging"])


def test_inputs_reach_the_kernel_16_byte_aligned():
    """The kernel reads x in 16-byte chunks: the wrapper hands it x as is
    when x starts 16-byte aligned, else a contiguous aligned copy."""
    x = torch.zeros(4 * 1000 + 1, dtype=torch.bfloat16)
    aligned = x[:4000].view(1, 40, 100)
    assert PVT._aligned(aligned) is aligned
    odd = x[1:].view(1, 40, 100)
    assert odd.data_ptr() % 16 != 0
    y = PVT._aligned(odd)
    assert y.data_ptr() % 16 == 0 and y.is_contiguous() and torch.equal(y, odd)


def test_fused_functions_take_the_plain_version_on_cpu():
    """A CPU tensor never reaches the kernel: the launch counts stay 0."""
    up, blocks, post = (to_port(p) for p in _stage_params(2, 4, 2, post=True))
    before = (PVT.STAGE.launches, PVT.TAIL.launches)
    x = torch.from_numpy(_x(0, (1, 5, 4)))
    assert PVT.fused_stage(x, up, blocks).shape == (1, 20, 2)
    assert PVT.fused_tail(x, up, blocks, post).shape == (1, 10)
    assert (PVT.STAGE.launches, PVT.TAIL.launches) == before
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA"):
            PVT.STAGE(x, PVT.pack_weights(up, blocks, None, KERNELS, DILS, torch.float32, "cpu"))


def test_weights_are_packed_once_per_parameter_set():
    """The wrapper packs a stage's weights once per (tensor, dtype, device)
    and forgets them with the tensor."""
    import gc

    up, blocks, post = (to_port(p) for p in _stage_params(8, 8, 4, post=True))
    a = PVT._packed(up, blocks, None, KERNELS, DILS, torch.bfloat16, torch.device("cpu"))
    assert PVT._packed(up, blocks, None, KERNELS, DILS, torch.bfloat16, torch.device("cpu")) is a
    b = PVT._packed(up, blocks, post, KERNELS, DILS, torch.bfloat16, torch.device("cpu"))
    f = PVT._packed(up, blocks, None, KERNELS, DILS, torch.float32, torch.device("cpu"))
    assert b is not a and f is not a and b.w_post.abs().sum() > 0 and f.w_mrf.dtype == torch.float32
    key = id(up["w"])
    assert key in PVT._PACKED
    del up, a, b, f
    gc.collect()
    assert key not in PVT._PACKED


def test_build_library_skips_fresh_libraries_and_needs_nvcc(tmp_path, monkeypatch):
    """A library newer than its source is reused without nvcc; a stale or
    missing one with no nvcc raises instead of running anything else."""
    import os

    from covomix_tpu_torch.ops import cuda_build

    src, lib = tmp_path / "k.cu", tmp_path / "build" / "libk.so"
    src.write_text("// kernel\n")
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: str(tmp_path / "no-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build_library(str(src), str(lib))
    lib.parent.mkdir()
    lib.write_bytes(b"")
    os.utime(lib, (os.path.getmtime(src) + 10,) * 2)
    assert cuda_build.build_library(str(src), str(lib)) == ""
    os.utime(src, (os.path.getmtime(lib) + 10,) * 2)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build_library(str(src), str(lib))
