"""Closed-loop build traffic: one client calls the port's build entry,
``ops.bcr.build_msbwt_with_index``, back to back, each call waiting for the
last (every op ends in ``torch.cuda.synchronize()``).

A mix's JSON names this module as its ``generator`` and sets ``op``:

* ``"build"``: one-shot builds of the configuration's ``reads`` reads, with
  no base. ``READ_SETS`` distinct sets are drawn from the seed in set-up
  and taken in turn, op i the set i mod ``READ_SETS``.
* ``"append"``: set-up builds a base of ``base_reads`` reads once and keeps
  it on the device with its packed index, and draws ``BATCHES`` batches of
  ``batch_reads`` reads from the seed; op i appends batch i mod
  ``BATCHES`` onto the base (``base`` / ``base_string_count`` /
  ``base_rot_max`` / ``base_index``: what
  ``utils.streaming.StreamingBuilder.add_batch`` passes). The base is
  never changed, so every op does the same work, and no op's inputs are
  drawn inside the window.

One op, drawn from the seed among the first ops (one of each input), and
the window's last op are compared with the reference. The drawn op's
outputs are copied into pinned host buffers made in set-up, between ops;
the last op's stay on the device until the window has closed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import data

READ_SETS = 2   # build: distinct read sets taken in turn
BATCHES = 32    # append: distinct batches taken in turn


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _outputs(res) -> dict:
    idx, packed = res
    return {"bwt": idx.bwt, "table": packed.table, "occ": idx.occ, "starts": idx.starts,
            "packed_starts": packed.starts, "n": idx.n, "packed_n": packed.n}


class Session:
    """One run's program state, from set-up to the check."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device, *, control=False):
        from rust_msbwt_tpu_torch.ops.bcr import build_msbwt_with_index

        if cfg["insertion"] != "sorted":
            raise ValueError("the reference holds sorted insertion only")
        self.build = build_msbwt_with_index
        self.device = torch.device(device)
        self.sorted = not control  # the control: the program's chronological insertion
        self.phases, t0 = {}, time.perf_counter()
        codes = data.genome(cfg, self.device)
        _sync(self.device)
        self.phases["genome_s"], t0 = time.perf_counter() - t0, time.perf_counter()
        self.base_kw, self.base_n, self.base_parts = {}, 0, []
        if mix["op"] == "build":
            n, count = cfg["reads"], READ_SETS
        elif mix["op"] == "append":
            base = data.reads_host(codes, cfg, mix["base_reads"], data.stream(seed, "base"))
            idx, packed = self.build(*base, device=self.device)
            _sync(self.device)
            self.base_parts = [base]
            self.base_n = idx.n
            self.base_kw = {"base": idx.bwt[: idx.n], "base_string_count": mix["base_reads"],
                            "base_rot_max": cfg["read_length"] + 1, "base_index": packed}
            del idx
            self.phases["base_s"], t0 = time.perf_counter() - t0, time.perf_counter()
            n, count = mix["batch_reads"], BATCHES
        else:
            raise ValueError(f"unknown op {mix['op']!r}")
        reads, lengths = data.reads_host(codes, cfg, n * count, data.stream(seed, "inputs"))
        self.sets = [(reads[k * n: (k + 1) * n], lengths[k * n: (k + 1) * n])
                     for k in range(count)]
        del codes
        self.phases["inputs_s"], t0 = time.perf_counter() - t0, time.perf_counter()
        rng = np.random.default_rng(data.stream(seed, "checked"))
        self.drawn = int(rng.integers(count))
        self.kept = None     # (op, outputs on the host, the op's reads)
        self.last = None     # (op, outputs on the device, the op's reads)
        self.out = self.inp = None
        # warm-up: one op of the window's shapes, which also sizes the staging buffers
        res = _outputs(self.build(*self.sets[-1], self.sorted, **self.base_kw,
                                  device=self.device))
        pin = self.device.type == "cuda"
        self.stage = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=pin)
                      for k, v in res.items() if isinstance(v, torch.Tensor)}
        del res
        _sync(self.device)
        self.phases["warm_s"] = time.perf_counter() - t0

    def _inputs(self, i: int):
        return self.sets[i % len(self.sets)]

    def op(self, i: int, span) -> dict:
        """Run op i; its record: call and return times, the read bases
        inserted, the base's symbols and the reads' lengths."""
        reads, lengths = self._inputs(i)
        t0 = time.perf_counter()
        with span:
            res = self.build(reads, lengths, self.sorted, **self.base_kw, device=self.device)
            _sync(self.device)
        t1 = time.perf_counter()
        self.out, self.inp = res, (reads, lengths)
        return {"start": t0, "end": t1, "bases": int(lengths.sum()), "n0": self.base_n,
                "lengths": lengths}

    def after(self, i: int, last: bool) -> None:
        """Between ops: copy the drawn op's outputs to the host; keep the
        last op's; free the rest before the next op."""
        if i == self.drawn:
            out = _outputs(self.out)
            for k, buf in self.stage.items():
                buf.copy_(out[k])
            self.kept = (i, dict(out, **self.stage), self.inp)
        if last:
            self.last = (i, _outputs(self.out), self.inp)
        self.out = None

    def checked(self) -> list:
        """``(op, outputs on the host, reference parts)`` of every checked
        op, once the window has closed; frees the program's state."""
        todo = [self.kept] if self.kept is not None else []
        if self.last is not None and (self.kept is None or self.last[0] != self.kept[0]):
            i, out, inp = self.last
            todo.append((i, {k: v.cpu() if isinstance(v, torch.Tensor) else v
                             for k, v in out.items()}, inp))
        self.free()
        return [(i, out, self.base_parts + [inp]) for i, out, inp in todo]

    def free(self) -> None:
        self.base_kw, self.out, self.last = {}, None, None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
