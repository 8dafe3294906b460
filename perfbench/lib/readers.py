"""Arithmetic the metric files share: rates over the window, span times per
step, rooflines and the model-FLOP share from the traced window."""

from __future__ import annotations

from perfbench.lib import trace as TR


def window_rate(ctx, key: str):
    """Sum of `key` over every step of the window / the window's length."""
    if not ctx.records or ctx.window_s <= 0:
        return None
    return sum(float(r.get(key, 0.0)) for r in ctx.records) / ctx.window_s


def span_per_step(ctx, name: str):
    """Mean seconds of span `name` per step of the window (traced run)."""
    total = [s.end - s.start for s in ctx.spans.spans if s.name == name and s.call >= 0]
    return sum(total) / len(ctx.records) if total else None


def self_per_step(ctx, name: str):
    """Mean self time of span `name` per step (its length minus the spans
    directly inside it)."""
    times = TR.self_times([s for s in ctx.spans.spans if s.call >= 0], name)
    return sum(times) / len(ctx.records) if times else None


def roofline_pct(ctx, key: str, match):
    """100 x the least time of the traced steps' launches of a kernel (each
    record's `key`: [(FLOPs, bytes, launches)], the least time of one launch
    max(FLOPs / peak FLOP/s, bytes / peak bytes/s)) over the device time of
    the operations whose name `match`es in the traced window."""
    if ctx.view is None or ctx.peak is None:
        return None
    least = sum(n * max(f / ctx.peak["bf16_flops"], b / ctx.peak["bytes_s"])
                for r in ctx.records[:ctx.traced_steps] for f, b, n in r.get(key, ()))
    launches, busy = ctx.view.kernel_time_s(match)
    if launches == 0 or busy <= 0 or least <= 0:
        return None
    return 100.0 * least / busy


def mfu_pct(ctx):
    """100 x the traced steps' model FLOPs / the traced window / the card's
    dense bf16 peak."""
    if ctx.view is None or ctx.peak is None:
        return None
    flops = sum(float(r.get("flops", 0)) for r in ctx.records[:ctx.traced_steps])
    return 100.0 * flops / ctx.view.window_s / ctx.peak["bf16_flops"] if flops else None


def idle_pct(ctx):
    return None if ctx.view is None else 100.0 * ctx.view.idle
