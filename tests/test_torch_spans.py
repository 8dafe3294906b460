"""The port's spans and decode counters on the CPU at tiny sizes: under a
profiler, `util/profiling.scope` ranges at the layer boundaries of serving
(`BatchedPipeline.__call__`), per-file generation (`Synthesizer.monologue`)
and a `MultiStep` dispatch, nested as the hot path calls them, each
top-level range numbered by its call; `text2semantic.DECODE` counting one
host read per `t2s.read` range; and with no profiler running, no range
entered at all and outputs bit-equal to a traced run's."""

import numpy as np
import pytest
import torch

from covomix_tpu_torch.audio import save_wav
from covomix_tpu_torch.data.tokenizer import COVOMIX_ADDED_TOKENS, WordPieceTokenizer
from covomix_tpu_torch.models import acoustic as PA, text2semantic as PT, vocoder as PV
from covomix_tpu_torch.pipeline import Synthesizer
from covomix_tpu_torch.serving import BatchedPipeline
from covomix_tpu_torch.train import loop as PLoop
from covomix_tpu_torch.util import profiling as P

COMIX = PT.T2SConfig(dim=32, source_depth=1, target_depth=1, heads=2, dim_head=16, num_text_tokens=200,
                     num_semantic_tokens=501, target_dim=64, two_output=True)
SINGLE = PT.T2SConfig(dim=32, source_depth=1, target_depth=1, heads=2, dim_head=16, num_text_tokens=200,
                      num_semantic_tokens=501, target_dim=32)
VOMIX = PA.AcousticConfig(dim_in=160, dim=32, depth=2, heads=2, dim_head=16, dim_phoneme_emb=16,
                          num_phoneme_tokens=502, mode="two_one")
VOSINGLE = PA.AcousticConfig(dim_in=80, dim=32, depth=2, heads=2, dim_head=16, dim_phoneme_emb=16,
                             num_phoneme_tokens=502)
VOC = PV.VocoderConfig(upsample_initial_channel=16)
B, PMAX, L = 2, 8, 20         # L / STEPS_PER_READ: three host reads, the last one short of a chunk
FLOW_STEPS = 16


def _ranges(prof):
    """[(name, start ns, end ns, numbers)] of the trace's user ranges."""
    return [(e.name(), e.start_ns(), e.end_ns(), list(e.concrete_inputs()))
            for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]


def _inside(ranges, outer):
    """The ranges that lie within `outer` (itself excluded)."""
    return [r for r in ranges if r is not outer and outer[1] <= r[1] and r[2] <= outer[2]]


def _names(ranges):
    return [r[0] for r in ranges]


def _only(ranges, name):
    got = [r for r in ranges if r[0] == name]
    assert len(got) == 1, (name, _names(ranges))
    return got[0]


def _numbered(fn):
    """fn() under a profiler that records shapes (the ranges' numbers)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU], record_shapes=True) as prof:
        fn()
    return _ranges(prof)


@pytest.fixture(scope="module")
def pipe():
    g = torch.Generator().manual_seed(0)
    return BatchedPipeline(PT.init(g, COMIX), COMIX, PA.init(g, VOMIX), VOMIX, PV.init_generator(g, VOC), VOC,
                           decode_len=L, dtype=torch.float32, device="cpu")


def _serve_inputs():
    rs = np.random.RandomState(3)
    return (rs.randint(1, 200, (B, 6)).astype(np.int32), rs.randint(0, 500, (B, PMAX, 2)).astype(np.int32),
            (rs.randn(B, PMAX, 160) * 0.1).astype(np.float32))


def _serve(pipe):
    return pipe(torch.Generator().manual_seed(5), *_serve_inputs())


def test_scope_without_a_profiler_enters_nothing(monkeypatch):
    """No profiler: neither record_function nor a numbered range is entered
    and no NVTX range pushed, on the whole serving call; every scope is the
    one shared do-nothing context. Under a trace the same scopes record."""
    entered = []
    real_enter = torch.autograd.profiler.record_function.__enter__
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__",
                        lambda self: entered.append(self.name) or real_enter(self))
    real_numbered = torch.autograd._record_function_with_args_enter
    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter",
                        lambda name, *a: entered.append(name) or real_numbered(name, *a))
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", lambda *a: entered.append("nvtx"))
    g = torch.Generator().manual_seed(0)
    pipe = BatchedPipeline(PT.init(g, COMIX), COMIX, PA.init(g, VOMIX), VOMIX, PV.init_generator(g, VOC), VOC,
                           decode_len=L, dtype=torch.float32, device="cpu")
    assert P.scope("a") is P.scope("b", 3) is P.scope("c")
    _serve(pipe)
    assert entered == []
    with P.trace():
        with P.scope("t2s.read"), P.scope("serve.call", 1):
            pass
    assert entered == ["t2s.read", "serve.call"]


def test_serving_spans_nest_and_count_the_reads(pipe):
    """One BatchedPipeline call: serve.call > serve.place, t2s.generate
    (> t2s.encode, t2s.prepare, a t2s.read a chunk, t2s.finish),
    serve.pack, flow.sample (> flow.embed, 16 flow.step), serve.slice,
    vocoder.generator, in that order; the t2s.read ranges are the change in
    DECODE.reads; outputs bit-equal to an untraced call's."""
    before = PT.DECODE.reads
    with P.trace() as prof:
        wav, res = _serve(pipe)
    reads = PT.DECODE.reads - before
    ranges = _ranges(prof)
    call = _only(ranges, "serve.call")
    inner = _inside(ranges, call)
    assert len(inner) == len(ranges) - 1
    direct = [r for r in inner if not any(o is not r and o[1] <= r[1] and r[2] <= o[2] for o in inner)]
    assert _names(direct) == ["serve.place", "t2s.generate", "serve.pack", "flow.sample", "serve.slice",
                              "vocoder.generator"]
    chunks = -(-res.num_steps // PT.STEPS_PER_READ)
    decode = _inside(ranges, _only(ranges, "t2s.generate"))
    assert _names(decode) == ["t2s.encode", "t2s.prepare"] + ["t2s.read"] * chunks + ["t2s.finish"]
    assert reads == chunks == _names(ranges).count("t2s.read") and res.num_steps == L
    flow = _inside(ranges, _only(ranges, "flow.sample"))
    assert _names(flow) == ["flow.embed"] + ["flow.step"] * FLOW_STEPS
    assert PT.DECODE.replays == 0 or PT.DECODE.captures > 0     # the CPU runs its steps directly
    wav2, res2 = _serve(pipe)
    assert torch.equal(wav, wav2) and torch.equal(res.tokens, res2.tokens) and torch.equal(res.tokens2, res2.tokens2)


def test_serving_call_number(pipe):
    """serve.call keeps the pipeline's call count; the ranges inside carry none."""
    ranges = _numbered(lambda: _serve(pipe))
    assert _only(ranges, "serve.call")[3] == [pipe.calls]
    assert all(r[3] == [] for r in ranges if r[0] != "serve.call")


@pytest.fixture(scope="module")
def prompt(tmp_path_factory):
    d = tmp_path_factory.mktemp("prompt")
    rs = np.random.RandomState(0)
    save_wav(str(d / "utt.wav"), (rs.randn(4000) * 0.05).astype(np.float32), 8000)
    np.save(str(d / "utt.hubert_code.npy"), rs.randint(0, 500, 24).astype(str))
    return str(d / "utt.hubert_code.npy")


def test_monologue_spans(prompt):
    """Synthesizer.monologue("covosingle"): file.call > file.prompt,
    t2s.generate, flow.sample, vocoder.generator, the call numbered; the
    decode's reads one a t2s.read range; the wav bit-equal untraced."""
    g = torch.Generator().manual_seed(1)
    synth = Synthesizer(PT.init(g, SINGLE), SINGLE, PA.init(g, VOSINGLE), VOSINGLE, PV.init_generator(g, VOC), VOC,
                        WordPieceTokenizer(None, added_tokens=COVOMIX_ADDED_TOKENS), bucket=32, t2s_max_length=12,
                        device="cpu")
    text = "a short text"
    before = PT.DECODE.reads
    with P.trace() as prof:
        wav = synth.monologue("covosingle", text, prompt, torch.Generator().manual_seed(2))
    ranges = _ranges(prof)
    call = _only(ranges, "file.call")
    inner = _inside(ranges, call)
    direct = [r for r in inner if not any(o is not r and o[1] <= r[1] and r[2] <= o[2] for o in inner)]
    assert _names(direct) == ["file.prompt", "t2s.generate", "flow.sample", "vocoder.generator"]
    assert PT.DECODE.reads - before == _names(ranges).count("t2s.read") > 0
    numbered = _numbered(lambda: synth.monologue("covosingle", text, prompt, torch.Generator().manual_seed(2)))
    assert _only(numbered, "file.call")[3] == [2] == [synth.calls]
    again = synth.monologue("covosingle", text, prompt, torch.Generator().manual_seed(2))
    assert np.array_equal(wav, again)


def test_multi_step_dispatch_span():
    """An eager MultiStep dispatch (the CPU's path) is one train.dispatch
    range numbered by the dispatch; the captured path's train.fill /
    train.capture / train.replay belong to CUDA."""
    g = torch.Generator().manual_seed(4)
    state = PLoop.init_train_state(PT.init(g, COMIX), PLoop.TrainConfig(lr=1e-3))
    step = PLoop.make_multi_step(PLoop.t2s_loss_fn(COMIX), PLoop.TrainConfig(lr=1e-3), 2)
    rs = np.random.RandomState(0)
    batch = lambda: {"text_ids": torch.as_tensor(rs.randint(1, 200, (2, 2, 6)), dtype=torch.int32),
                     "semantic_ids": torch.as_tensor(rs.randint(0, 501, (2, 2, 10, 2)), dtype=torch.int32)}
    step(state, batch(), None)
    ranges = _numbered(lambda: step(state, batch(), None))
    dispatch = _only(ranges, "train.dispatch")
    assert dispatch[3] == [2] == [step.dispatches]
    assert not [r for r in ranges if r[0].startswith("train.") and r is not dispatch]
