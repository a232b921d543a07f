"""What a traced run (``--trace 1``) reads: the ``torch.profiler`` timeline
of the window, the harness's op spans in it, the ops' records and the
port's launch counters, as one object that the per-layer metric readers
(``metrics/<name>.py``) take.

Times in the timeline are microseconds on the profiler's clock; device
events are the kernels, copies and fills that ran on the card.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

OP_SPAN = "portbench.op"


@dataclass
class Trace:
    device_name: str
    window_s: float
    ops: list                       # the window's op records (``Session.op``)
    counters: dict                  # counter name -> launches in the window
    device: np.ndarray              # [E, 2] start, end (us) of device events
    device_names: list              # their names
    cpu: np.ndarray                 # [C, 2] start, end (us) of host events
    cpu_names: list
    spans: np.ndarray = field(default=None)  # [ops, 2] the op spans

    @classmethod
    def from_profiler(cls, prof, device_name, window_s, ops, counters) -> "Trace":
        from torch.autograd import DeviceType

        dev, dev_names, cpu, cpu_names = [], [], [], []
        for e in prof.events():
            tr = e.time_range
            if e.device_type != DeviceType.CPU and (
                    getattr(e, "is_user_annotation", False) or e.name == OP_SPAN):
                continue  # the device-side copy of a span covers the gaps inside it
            if e.device_type == DeviceType.CUDA:
                dev.append((tr.start, tr.end))
                dev_names.append(e.name)
            elif e.device_type == DeviceType.CPU:
                cpu.append((tr.start, tr.end))
                cpu_names.append(e.name)
        t = cls(device_name, window_s, ops, counters,
                np.asarray(dev, dtype=np.float64).reshape(-1, 2), dev_names,
                np.asarray(cpu, dtype=np.float64).reshape(-1, 2), cpu_names)
        t.spans = t.cpu[[i for i, n in enumerate(cpu_names) if n == OP_SPAN]]
        t.spans = t.spans[np.argsort(t.spans[:, 0])] if len(t.spans) else t.spans
        return t

    # -- device time -----------------------------------------------------
    def busy(self) -> np.ndarray:
        """The union of the device events' intervals, ``[K, 2]`` sorted."""
        if not len(self.device):
            return self.device
        iv = self.device[np.argsort(self.device[:, 0])]
        ends = np.maximum.accumulate(iv[:, 1])
        starts_new = np.ones(len(iv), dtype=bool)
        starts_new[1:] = iv[1:, 0] > ends[:-1]
        idx = np.flatnonzero(starts_new)
        return np.stack([iv[idx, 0], ends[np.r_[idx[1:] - 1, len(iv) - 1]]], axis=1)

    @property
    def busy_s(self) -> float:
        b = self.busy()
        return float((b[:, 1] - b[:, 0]).sum()) * 1e-6 if len(b) else 0.0

    def device_seconds(self, patterns) -> float:
        """Summed device time of the events whose name holds any pattern."""
        sel = [i for i, n in enumerate(self.device_names) if any(p in n for p in patterns)]
        if not sel:
            return 0.0
        iv = self.device[sel]
        return float((iv[:, 1] - iv[:, 0]).sum()) * 1e-6

    # -- host prep -------------------------------------------------------
    def host_prep_s(self) -> np.ndarray:
        """Per op: from its span's start to its first device event."""
        if not len(self.spans) or not len(self.device):
            return np.zeros(0)
        starts = np.sort(self.device[:, 0])
        k = np.minimum(np.searchsorted(starts, self.spans[:, 0]), len(starts) - 1)
        first = starts[k]
        ok = (first >= self.spans[:, 0]) & (first <= self.spans[:, 1])
        return (first[ok] - self.spans[ok, 0]) * 1e-6

    def busy_in_spans(self) -> np.ndarray:
        """Per op: the device's busy time inside its span."""
        b = self.busy()
        out = []
        for a, c in self.spans:
            lo, hi = np.clip(b[:, 0], a, c), np.clip(b[:, 1], a, c)
            out.append((hi - lo).sum() * 1e-6)
        return np.asarray(out)

    # -- breakdown -------------------------------------------------------
    def top_device_ops(self, top: int = 10) -> list:
        sums: dict = {}
        for (a, b), n in zip(self.device, self.device_names):
            sums[n] = sums.get(n, 0.0) + (b - a) * 1e-6
        return sorted(([n, s] for n, s in sums.items()), key=lambda x: -x[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """The longest gaps between device activity inside the op spans,
        each named by the innermost host event open at its middle."""
        b = self.busy()
        if len(b) < 2 or not len(self.spans):
            return []
        gaps = np.stack([b[:-1, 1], b[1:, 0]], axis=1)
        lo, hi = self.spans[0, 0], self.spans[-1, 1]
        gaps = gaps[(gaps[:, 0] >= lo) & (gaps[:, 1] <= hi)]
        gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])][:top]
        out = []
        for a, c in gaps:
            mid = 0.5 * (a + c)
            open_ = np.flatnonzero((self.cpu[:, 0] <= mid) & (self.cpu[:, 1] >= mid))
            name = "host"
            if len(open_):
                inner = open_[np.argmin(self.cpu[open_, 1] - self.cpu[open_, 0])]
                name = self.cpu_names[inner]
            out.append([name, float(c - a) * 1e-6])
        return out
