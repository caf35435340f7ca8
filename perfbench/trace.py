"""The traced run: named spans around the calls into each layer, a log of
every kernel launch's least work, and the reading of ``torch.profiler``'s
trace of the window.

Nothing in the program changes: spans and launch records wrap module
attributes (``spans.json``; the kernel wrappers of
``repro_torch.kernels.ops.KERNELS`` wherever a module of the program holds
them) and are put back when the window closes.
"""

from __future__ import annotations

import contextlib
import functools
import json
import sys
from pathlib import Path
from typing import Callable, Dict, List

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
WINDOW = "perfbench.window"
#: Launches of a paired kernel whose work is read after the window.
PAIRED_LAUNCHES = 64


def _union_ns(starts: np.ndarray, ends: np.ndarray) -> tuple:
    """Merged (start, end) intervals of the given ones, sorted."""
    order = np.argsort(starts, kind="stable")
    merged_s, merged_e = [], []
    for s, e in zip(starts[order].tolist(), ends[order].tolist()):
        if merged_e and s <= merged_e[-1]:
            if e > merged_e[-1]:
                merged_e[-1] = e
        else:
            merged_s.append(s)
            merged_e.append(e)
    return np.asarray(merged_s, np.int64), np.asarray(merged_e, np.int64)


class Tracer:
    """Spans, launch records and the profiler, for one window.

    ``kernels`` maps a kernel wrapper's name (a key of ``ops.KERNELS``) to
    its roofline reader module: ``work(*args, **kwargs)`` gives the
    launch's (bytes, operations), a function that gives them once the
    window has closed (``PAIRED`` readers), or None for a call that
    launches nothing."""

    def __init__(self, kernels: Dict[str, object]):
        self.kernels = kernels
        self.launches: Dict[str, list] = {k: [] for k in kernels}
        #: Every launch that ran a kernel, recorded or not.
        self.counts: Dict[str, int] = {k: 0 for k in kernels}
        self._undo: List[Callable[[], None]] = []
        self.device = None
        self.window_ns = None

    # -- wrapping ------------------------------------------------------------

    def _patch(self, orig, wrapped, skip_module: str | None = None) -> None:
        for name, mod in list(sys.modules.items()):
            if not name.startswith("repro_torch") or name == skip_module:
                continue
            for attr, val in list(vars(mod).items()):
                if val is orig:
                    setattr(mod, attr, wrapped)
                    self._undo.append(
                        functools.partial(setattr, mod, attr, orig))

    def _install(self) -> None:
        import importlib

        from repro_torch.kernels import ops

        spans = json.loads((HERE / "spans.json").read_text())["spans"]
        for module, attr, label in spans:
            mod = importlib.import_module(module)
            orig = getattr(mod, attr)

            def spanned(*a, _f=orig, _l=label, **kw):
                with torch.profiler.record_function(_l):
                    return _f(*a, **kw)
            setattr(mod, attr, spanned)
            self._undo.append(functools.partial(setattr, mod, attr, orig))
        for kname, reader in self.kernels.items():
            orig = ops.KERNELS[kname]
            log = self.launches[kname]
            paired = getattr(reader, "PAIRED", False)

            def logged(*a, _f=orig, _r=reader, _log=log, _p=paired, _k=kname,
                       **kw):
                w = _r.work(*a, **kw)
                if w is not None:
                    self.counts[_k] += 1
                    if not (_p and len(_log) >= PAIRED_LAUNCHES):
                        _log.append(w)
                return _f(*a, **kw)
            self._patch(orig, logged, skip_module=orig.__module__)

    def _uninstall(self) -> None:
        while self._undo:
            self._undo.pop()()

    # -- the window ----------------------------------------------------------

    @contextlib.contextmanager
    def window(self):
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                               if cuda else [])
        self._install()
        try:
            with profile(activities=activities) as prof:
                with torch.profiler.record_function(WINDOW):
                    yield self
                if cuda:
                    torch.cuda.synchronize()
        finally:
            self._uninstall()
        self._read(prof)

    def resolve(self) -> None:
        """Count the work of the launches whose count waited for the
        window to close (after the memory peak has been read)."""
        for kname in self.kernels:
            self.launches[kname] = [w() if callable(w) else w
                                    for w in self.launches[kname]]

    @staticmethod
    def span(label: str):
        return torch.profiler.record_function(label)

    def _read(self, prof) -> None:
        dev_s, dev_e, dev_n = [], [], []
        cpu_s, cpu_e, cpu_n = [], [], []
        window = None
        for e in prof.profiler.kineto_results.events():
            s = e.start_ns()
            d = e.duration_ns()
            if e.is_user_annotation():
                # A span, also drawn on the device's timeline: not work.
                if e.device_type() == torch.autograd.DeviceType.CUDA:
                    continue
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                dev_s.append(s)
                dev_e.append(s + d)
                dev_n.append(e.name())
            else:
                name = e.name()
                if name == WINDOW:
                    window = (s, s + d)
                cpu_s.append(s)
                cpu_e.append(s + d)
                cpu_n.append(name)
        if window is None:
            raise RuntimeError("the profiler recorded no window span")
        ws, we = window
        self.window_ns = window
        dev_s = np.clip(np.asarray(dev_s, np.int64), ws, we)
        dev_e = np.clip(np.asarray(dev_e, np.int64), ws, we)
        keep = dev_e > dev_s
        self.device = (dev_s[keep], dev_e[keep],
                       [n for n, k in zip(dev_n, keep.tolist()) if k])
        self.cpu = (np.asarray(cpu_s, np.int64), np.asarray(cpu_e, np.int64),
                    cpu_n)

    # -- readings ------------------------------------------------------------

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def busy_intervals(self):
        return _union_ns(self.device[0], self.device[1])

    @property
    def busy_s(self) -> float:
        s, e = self.busy_intervals()
        return float((e - s).sum()) / 1e9

    def kernel_seconds(self, names) -> List[float]:
        """Device seconds of each activity whose name holds one of
        ``names``, in the order they ran."""
        starts, ends, labels = self.device
        hit = [i for i, n in enumerate(labels) if any(p in n for p in names)]
        hit.sort(key=lambda i: starts[i])
        return [float(ends[i] - starts[i]) / 1e9 for i in hit]

    def device_ops(self, top: int = 10) -> list:
        starts, ends, labels = self.device
        total: Dict[str, float] = {}
        for s, e, n in zip(starts.tolist(), ends.tolist(), labels):
            total[n] = total.get(n, 0.0) + (e - s) / 1e9
        return sorted(([n[:160], t] for n, t in total.items()),
                      key=lambda nt: -nt[1])[:top]

    def idle_gaps(self, top: int = 10, longest: int = 400) -> list:
        """Idle seconds between device activities: first all of them, by
        the benchmark's span the host was in (``all idle in <span>``);
        then the window's longest gaps, summed by that span and the
        innermost host operation at each gap's middle."""
        ws, we = self.window_ns
        s, e = self.busy_intervals()
        gap_s = np.concatenate([[ws], e])
        gap_e = np.concatenate([s, [we]])
        size = gap_e - gap_s
        cs, ce, cn = self.cpu
        own = np.asarray([n.startswith("perfbench.") and n != WINDOW
                          for n in cn], dtype=bool)
        mids = (gap_s + gap_e) // 2
        order = np.argsort(cs[own], kind="stable")
        os_, oe = cs[own][order], ce[own][order]
        names = [n for n, o in zip(cn, own.tolist()) if o]
        names = [names[i] for i in order.tolist()]
        at = np.searchsorted(os_, mids, side="right") - 1
        coarse: Dict[str, float] = {}
        for i, j in enumerate(at.tolist()):
            span = names[j] if j >= 0 and oe[j] >= mids[i] else "host"
            key = f"all idle in {span}"
            coarse[key] = coarse.get(key, 0.0) + float(size[i]) / 1e9
        head = sorted(([n, t] for n, t in coarse.items() if t > 0),
                      key=lambda nt: -nt[1])
        pick = np.argsort(-size, kind="stable")[:longest]
        pick = pick[size[pick] > 0]
        total: Dict[str, float] = {}
        for i in pick.tolist():
            mid = (gap_s[i] + gap_e[i]) // 2
            inside = np.flatnonzero((cs <= mid) & (ce >= mid))
            ours = [j for j in inside.tolist() if own[j]]
            theirs = [j for j in inside.tolist()
                      if not own[j] and cn[j] != WINDOW]
            label = cn[max(ours, key=lambda j: cs[j])] if ours else "host"
            if theirs:
                label += " > " + cn[max(theirs, key=lambda j: cs[j])]
            total[label] = total.get(label, 0.0) + float(size[i]) / 1e9
        tail = sorted(([n[:160], t] for n, t in total.items()),
                      key=lambda nt: -nt[1])
        return (head + tail)[:top]
