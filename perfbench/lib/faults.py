"""Faults planted under a cell's timed path, to see `correct` come out
false: the program's function `module:attribute` is replaced by a broken
wrapper of it for the run. The CPU tests plant each at tiny sizes;
`perfbench/control.py --fault` reads one on the card at the cell's size."""

from __future__ import annotations

import contextlib
import importlib

import torch


def _alter_tokens(fn):
    def wrapped(*args, **kwargs):
        res = fn(*args, **kwargs)
        t1 = res.tokens.clone()
        t1[:, 1] = (t1[:, 1] + 1) % 501
        return res._replace(tokens=t1)
    return wrapped


def _state_unchanged(fn):
    def wrapped(params, cfg, generator, phoneme_ids, cond, **kwargs):
        fn(params, cfg, generator, phoneme_ids, cond, **kwargs)
        noise = kwargs.get("noise")
        if noise is None:       # what the sampler would start from
            return torch.randn((cond.shape[0], cond.shape[1], 80), generator=generator, device=cond.device)
        return noise.float()
    return wrapped


def _alter_wav(fn):
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        return out * 0.8
    return wrapped


def _half_batch(fn):
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        out = out.clone()
        out[out.shape[0] // 2:] = out[: out.shape[0] - out.shape[0] // 2].mean(0)
        return out
    return wrapped


def _optimizer_skipped(fn):
    def make(*args, **kwargs):
        body = fn(*args, **kwargs)

        def skipped(state, *a, **k):
            step = state.optimizer.step
            state.optimizer.step = lambda *x, **y: None
            try:
                return body(state, *a, **k)
            finally:
                state.optimizer.step = step
        return skipped
    return make


def _half_rows(fn):
    def make(*args, **kwargs):
        loss = fn(*args, **kwargs)

        def half(params, batch, generator):
            n = next(iter(batch.values())).shape[0]
            return loss(params, {k: v[: n // 2] for k, v in batch.items()}, generator)
        return half
    return make


# name -> (target, wrapper, drivers the fault applies to, training model it needs or None)
FAULTS = {
    "token_altered": ("covomix_tpu_torch.models.text2semantic:generate", _alter_tokens, ("serve",), None),
    "flow_state_unchanged": ("covomix_tpu_torch.models.acoustic:sample", _state_unchanged, ("serve", "file"), None),
    "wav_altered": ("covomix_tpu_torch.models.vocoder:generator", _alter_wav, ("serve", "file"), None),
    "half_batch_replaced": ("covomix_tpu_torch.models.acoustic:sample", _half_batch, ("serve",), None),
    "step_state_unchanged": ("covomix_tpu_torch.train.loop:make_step_body", _optimizer_skipped, ("train",), None),
    "acoustic_half_batch": ("covomix_tpu_torch.train.loop:acoustic_loss_fn", _half_rows, ("train",), "acoustic"),
    "t2s_half_batch": ("covomix_tpu_torch.train.loop:t2s_loss_fn", _half_rows, ("train",), "t2s"),
}


def applies(fault: str, wl: dict) -> bool:
    """Whether `fault` can happen in the cell of workload file `wl`."""
    _, _, drivers, model = FAULTS[fault]
    return wl["driver"] in drivers and (model is None or wl["traffic"].get("model") == model)


@contextlib.contextmanager
def planted(fault: str):
    """The program with `fault` planted, for the block."""
    target, make, _, _ = FAULTS[fault]
    mod, attr = target.split(":")
    module = importlib.import_module(mod)
    original = getattr(module, attr)
    setattr(module, attr, make(original))
    try:
        yield
    finally:
        setattr(module, attr, original)
