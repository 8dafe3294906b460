"""The program's side of a cell: its configuration objects built from a
configuration file, the seeded weights handed to it, and wrappers around
its module functions (the traced run's layer spans, the taps that keep
what the check compares)."""

from __future__ import annotations

import dataclasses
import importlib

import torch

from perfbench.lib import weights
from perfbench.reference import spec

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def program_configs(cfg: dict):
    """(T2SConfig, AcousticConfig, VocoderConfig) of the program."""
    from covomix_tpu_torch.models import acoustic as A
    from covomix_tpu_torch.models import text2semantic as T
    from covomix_tpu_torch.models import vocoder as V

    def build(cls, d):
        names = {f.name for f in dataclasses.fields(cls)}
        tup = lambda v: tuple(tup(x) for x in v) if isinstance(v, list) else v
        return cls(**{k: tup(v) for k, v in d.items() if k in names})

    return build(T.T2SConfig, cfg["t2s"]), build(A.AcousticConfig, cfg["acoustic"]), \
        build(V.VocoderConfig, cfg["vocoder"])


def make_weights(ctx) -> dict:
    """The three weight trees, drawn on the device from the run's seed."""
    g = ctx.generator("weights")
    return {"t2s": weights.make(spec.t2s(ctx.cfg["t2s"]), g, ctx.device),
            "acoustic": weights.make(spec.acoustic(ctx.cfg["acoustic"]), g, ctx.device),
            "vocoder": weights.make(spec.vocoder(ctx.cfg["vocoder"]), g, ctx.device)}


def _resolve(target: str):
    mod, attr = target.split(":")
    return importlib.import_module(mod), attr


def wrap(ctx, target: str, make_wrapper) -> None:
    """Replace module attribute `target` ("package.module:function") by
    make_wrapper(original) for the run `ctx`, until `unwrap_all(ctx)`."""
    mod, attr = _resolve(target)
    original = getattr(mod, attr)
    ctx.wrapped.append((mod, attr, original))
    setattr(mod, attr, make_wrapper(original))


def unwrap_all(ctx) -> None:
    while ctx.wrapped:
        mod, attr, original = ctx.wrapped.pop()
        setattr(mod, attr, original)


def install_spans(ctx) -> None:
    """In a traced run, a span around each layer function the workload
    names (`spans`: {span name: "module:function"}); before the program's
    objects are built, since some bind the functions then."""
    if ctx.trace:
        for name, target in ctx.wl.get("spans", {}).items():
            wrap(ctx, target, lambda fn, name=name: ctx.spans.wrap(fn, name))
