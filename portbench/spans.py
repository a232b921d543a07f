"""The port's own spans (``msbwt.*``, from ``utils/profiling.annotate``)
as the per-layer readers take them: each assigned to the harness's op span
(``portbench.op``) that holds it, on the profiler's clock."""

from __future__ import annotations

import numpy as np


def per_op(trace, names) -> np.ndarray:
    """Host seconds of the spans named in ``names`` inside each op span,
    summed an op, for the ops that hold any of them (none: empty)."""
    spans = trace.spans
    sel = [i for i, n in enumerate(trace.cpu_names) if n in names]
    if spans is None or not len(spans) or not sel:
        return np.zeros(0)
    ev = trace.cpu[sel]
    k = np.searchsorted(spans[:, 0], ev[:, 0], side="right") - 1
    inside = (k >= 0) & (ev[:, 1] <= spans[np.maximum(k, 0), 1])
    k, ev = k[inside], ev[inside]
    held = np.bincount(k, minlength=len(spans)) > 0
    return np.bincount(k, weights=ev[:, 1] - ev[:, 0], minlength=len(spans))[held] * 1e-6
