"""The yardstick's arithmetic: FLOP and byte counts against hand sums (and
the program's own bench formulas), the idle and span arithmetic on
synthetic intervals, the seeded weights."""

import numpy as np
import pytest
import torch

from perfbench.lib import flops as FL
from perfbench.lib import trace as TR
from perfbench.lib import weights
from perfbench.reference import spec
from perfbench.tests import tiny


def test_attention_pairs():
    assert FL.attention_pairs(2, 4) == 32
    assert FL.attention_pairs(1, 4, causal=True) == 4 + 3 + 2 + 1
    assert FL.attention_pairs(2, 4, valid_len=[1, 3]) == 4 * 1 + 4 * 3
    assert FL.attention_pairs(1, 4, keys=2) == 8


def test_flash_forward_counts():
    f, b = FL.flash_forward(2, 3, 8, 16, valid_len=[8, 4])
    assert f == 4 * 16 * 3 * (8 * 8 + 8 * 4)
    assert b == 4 * 2 * 3 * 8 * 16 * 2


def test_vocoder_stage_by_hand():
    c = {"upsample_initial_channel": 8, "upsample_rates": [2], "upsample_kernel_sizes": [4],
         "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 2]], "num_mels": 4}
    # transposed conv: 5 frames x 4 taps x 8 -> 4; out 10 frames; 2 dilations x 2 convs of k 3, 4 -> 4
    want = 2 * 5 * 4 * 8 * 4 + 2 * 2 * 2 * 10 * 3 * 4 * 4 + 2 * 10 * 7 * 4
    assert FL.vocoder_stage_flops(c, 1, 5, 0, post=True) == want
    assert FL.vocoder_flops(c, 1, 5) == 2 * 5 * 7 * 4 * 8 + want


def test_fused_pair_is_the_last_two_stages():
    c = tiny.VOCODER
    (fs, _), (ft, _) = FL.vocoder_fused(c, 2, 40)
    rest = FL.vocoder_flops(c, 2, 40) - fs - ft
    assert rest == 2 * 2 * 40 * 7 * 80 * 16 + sum(
        FL.vocoder_stage_flops(c, 2, FL.stage_frames(c, 40, s), s) for s in (0, 1))


def test_formulas_equal_the_programs():
    from covomix_tpu_torch import bench as B
    from perfbench.lib import models
    for name, conf in tiny.CONFIGS.items():
        tc, ac, vc = models.program_configs(conf)
        assert FL.flow_field_flops(conf["acoustic"], 4, 50, [50, 40, 50, 40]) == \
            B.flow_field_flops(ac, 4, 50, [50, 40, 50, 40])
        assert FL.acoustic_train_flops(conf["acoustic"], 2, 30) == B.acoustic_train_flops(ac, 2, 30)
        assert FL.t2s_forward_flops(conf["t2s"], 3, 20, 33) == B.t2s_forward_flops(tc, 3, 20, 33)
        assert FL.vocoder_flops(conf["vocoder"], 2, 17) == B.vocoder_flops(vc, 2, 17)


def test_idle_share_of_intervals():
    assert TR.idle_share([(0, 2), (1, 3), (6, 8)], (0, 10)) == pytest.approx(0.5)
    assert TR.idle_share([(-5, 1), (9, 20)], (0, 10)) == pytest.approx(0.8)
    assert TR.idle_share([], (0, 10)) == 1.0


def test_trace_view_gaps_and_kernels():
    device = [(0, 20, "flash_fwd_wgmma"), (10, 30, "gemm"), (60, 100, "flash_fwd_wgmma")]
    host = [(0, 100, TR.WINDOW), (0, 100, "entry"), (25, 70, "flow")]
    v = TR.TraceView((0, 100), device, host)
    assert v.idle == pytest.approx(0.3)
    assert v.kernel_time_s(lambda n: "flash" in n) == (2, 60 / 1e9)
    assert v.idle_gaps() == [["flow", 30 / 1e9]]
    assert v.by_kernel()[0] == ["flash_fwd_wgmma", 60 / 1e9]


def test_self_times():
    S = TR.Span
    spans = [S("decode", 1, 3, 1, 0), S("flow", 3, 8, 1, 0), S("entry", 0, 10, 0, 0)]
    assert TR.self_times(spans, "entry") == [pytest.approx(3)]


def test_weights_are_the_seeds():
    sp = spec.acoustic(tiny.acoustic("two_one"))
    a = weights.make(sp, torch.Generator().manual_seed(3), "cpu")
    b = weights.make(sp, torch.Generator().manual_seed(3), "cpu")
    c = weights.make(sp, torch.Generator().manual_seed(4), "cpu")
    assert torch.equal(a["to_embed"]["w"], b["to_embed"]["w"])
    assert not torch.equal(a["to_embed"]["w"], c["to_embed"]["w"])
    bound = 1 / np.sqrt(sp["to_embed"]["w"].shape[0])
    assert float(a["to_embed"]["w"].abs().max()) <= bound
    assert torch.equal(a["layers"][0]["attn_norm"]["to_gamma"]["b"], torch.ones(32))
    assert [tuple(t.shape) for t in _leaves(a)] == [x.shape for x in weights._leaves(sp, [])]


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    vals = tree.values() if isinstance(tree, dict) else tree
    return [x for v in vals for x in _leaves(v)]


def test_spec_is_the_programs_tree():
    """The weight trees name and shape every leaf the program's own init makes."""
    from covomix_tpu_torch.models import acoustic as A
    from covomix_tpu_torch.models import text2semantic as T
    from covomix_tpu_torch.models import vocoder as V
    from covomix_tpu_torch.util.misc import named_leaves
    from perfbench.lib import models
    for conf in tiny.CONFIGS.values():
        tc, ac, vc = models.program_configs(conf)
        g = torch.Generator().manual_seed(0)
        for ours, theirs in ((spec.t2s(conf["t2s"]), T.init(g, tc)), (spec.acoustic(conf["acoustic"]), A.init(g, ac)),
                             (spec.vocoder(conf["vocoder"]), V.init_generator(g, vc))):
            mine = weights.make(ours, torch.Generator().manual_seed(1), "cpu")
            assert {n: tuple(t.shape) for n, t in named_leaves(mine)} == \
                {n: tuple(t.shape) for n, t in named_leaves(theirs)}



def test_reference_front_end_agrees_with_the_programs():
    """The reference's own log-mel and fallback-vocabulary ids equal the
    program's (the per-file check works both out again)."""
    import warnings

    from covomix_tpu_torch.audio import mel_spectrogram
    from covomix_tpu_torch.data.tokenizer import COVOMIX_ADDED_TOKENS, WordPieceTokenizer
    from perfbench.lib.harness import load_module
    from perfbench.reference import frontend as RF

    wav = np.random.default_rng(0).standard_normal(8000).astype(np.float32) * 0.3
    ours = RF.log_mel(wav)
    theirs = mel_spectrogram(torch.as_tensor(wav)[None])[0].numpy().T
    assert ours.shape == theirs.shape and np.abs(ours - theirs).max() < 1e-3
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tok = WordPieceTokenizer(None, added_tokens=COVOMIX_ADDED_TOKENS)
    make_text = load_module("drivers", "file").make_text
    for seed in range(3):
        text = make_text(np.random.default_rng(seed), (191, 206), (2, 9))
        assert list(RF.encode(text)) == tok.encode(text)
        assert 193 <= len(RF.encode(text)) <= 208
