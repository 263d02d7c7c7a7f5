"""Timing spans and device profiler traces.

The reference instruments wall-clock with ad-hoc time.time() pairs
(train_hybrid_maml_v5.py:262-300, main.py:32-52). Here: a reusable Timer and
an optional `jax.profiler` trace context for device profiles.
"""

from __future__ import annotations

import contextlib
import glob
import os
import re
import time
from dataclasses import dataclass, field

# `jax.named_scope` names the model and MAML code put on their ops; they
# survive vmap/grad/scan in each op's name stack, so a device trace can be
# attributed to them.
SCOPES = ("gcn_encoder", "lstm", "inner_update")


@dataclass
class Timer:
    """Accumulating named span timer."""

    spans: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - t0

    def summary(self) -> dict:
        return dict(self.spans)


@contextlib.contextmanager
def trace_span(log_dir: str | None):
    """Capture a jax.profiler trace into `log_dir` (no-op when None)."""
    if log_dir is None:
        yield
        return
    import jax

    with jax.profiler.trace(log_dir):
        yield


def block_until_ready(tree):
    """Pytree-aware completion barrier (delegates to jax.block_until_ready).

    Timed code ends its window with this: JAX returns before the device
    finishes."""
    import jax

    return jax.block_until_ready(tree)


def _union_ns(intervals) -> int:
    busy, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def load_trace(trace_dir: str):
    """The newest `jax.profiler` trace (.xplane.pb) under `trace_dir`."""
    from jax.profiler import ProfileData

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    return ProfileData.from_file(max(paths, key=os.path.getmtime))


def hlo_op_names(hlo_text: str) -> dict:
    """{HLO instruction name: op_name metadata} from a compiled module's
    text (`Compiled.as_text()`); the op_name carries the jax name stack."""
    return dict(re.findall(r'%([^\s=]+) = [^\n]*?op_name="([^"]*)"', hlo_text))


def summarize_trace(data, op_names=None, scopes=SCOPES, top: int = 25) -> dict:
    """Reduce a device trace (`load_trace`) to device metrics: the traced
    window, the busy time (union of kernel intervals on the device planes),
    device time per named scope and the top kernels.

    A kernel counts toward a scope when one of its string stats names the
    scope, or when `op_names` maps its `hlo_op` stat to an op_name that
    does. XLA's GPU command buffers hide the HLO op behind each kernel, so
    per-scope times need a program compiled without them. Scopes can nest,
    so their times may overlap.
    """
    op_names = op_names or {}
    intervals, by_kernel, by_op = [], {}, {}
    scope_ns = {k: 0 for k in scopes}
    scope_ns["unattributed"] = 0
    for plane in data.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                dur = ev.duration_ns
                intervals.append((ev.start_ns, ev.start_ns + dur))
                by_kernel[ev.name] = by_kernel.get(ev.name, 0) + dur
                stats = {k: v for k, v in ev.stats if isinstance(v, str)}
                op = op_names.get(stats.get("hlo_op", ""), "")
                by_op[op] = by_op.get(op, 0) + dur
                text = " ".join([*stats.values(), op])
                hit = [k for k in scopes if k in text]
                for k in hit:
                    scope_ns[k] += dur
                if not hit:
                    scope_ns["unattributed"] += dur
    window = (
        max(e for _, e in intervals) - min(s for s, _ in intervals)
        if intervals else 0
    )

    def top_of(d):
        return dict(sorted(d.items(), key=lambda kv: -kv[1])[:top])

    return {
        "window_ns": window,
        "busy_ns": _union_ns(intervals),
        "kernel_ns": sum(by_kernel.values()),
        "kernels": len(intervals),
        "scopes_ns": scope_ns,
        "top_kernels_ns": top_of(by_kernel),
        "top_op_names_ns": top_of(by_op) if op_names else {},
    }
