"""fmlrc-style read error detection and correction over a BWT (port of the
JAX package's ``apps.correct``).

The original msbwt's headline application is k-mer-spectrum read
correction (fmlrc / fmlrc2 drive the reference's ``RleBWT::count_kmer``
one k-mer at a time, ref: src/rle_bwt.rs:202-287). Here every read, window
and candidate base is scored in a few batched ``count_kmers`` calls on the
engine's device:

1. profile: counts of every length-``k`` window of every read (optionally
   forward + reverse complement, fmlrc's convention);
2. flag: base ``p`` is suspect iff EVERY window covering it is weak (count
   < ``tau``);
3. correct: score each of the 4 DNA substitutions of a suspect base by the
   minimum count over its covering windows; accept the best iff it reaches
   ``tau``. All (suspect, candidate, window) k-mers of a chunk of suspects
   go to one batched call.

The engine is any of the port's BWTs (``RleBWT``, ``DynamicBWT``): only its
``count_kmers`` / ``count_kmers_bidirectional`` / ``kmer_profile`` are used,
so the tier it picks answers.
"""

from __future__ import annotations

import numpy as np

from rust_msbwt_tpu_torch.ops.alphabet import VC_LEN

_DNA = np.array([1, 2, 3, 5], dtype=np.uint8)  # A C G T (no $ / N)


def _window_profile(bwt, reads: np.ndarray, k: int, bidirectional: bool) -> np.ndarray:
    """[B, L-k+1] counts of every length-k window (fw or fw+rc)."""
    if bidirectional:
        B, L = reads.shape
        w = L - k + 1
        windows = np.lib.stride_tricks.sliding_window_view(reads, k, axis=1)
        return bwt.count_kmers_bidirectional(windows.reshape(B * w, k)).reshape(B, w)
    return bwt.kmer_profile(reads, k)


def flag_read_errors(bwt, reads, k: int = 21, tau: int = 2,
                     bidirectional: bool = True) -> np.ndarray:
    """[B, L] bool mask of suspect bases: every covering window is weak.

    ``reads`` is an int-encoded [B, L] batch (no '$'); counts strictly
    below ``tau`` are weak.

    >>> from rust_msbwt_tpu_torch.models.dynamic import DynamicBWT
    >>> from rust_msbwt_tpu_torch.ops.alphabet import convert_stoi
    >>> bwt = DynamicBWT(device="cpu")
    >>> bwt.insert_strings(["ACGTAACC"] * 30, sorted=True)
    >>> flags = flag_read_errors(bwt, np.array([convert_stoi("ACGTATCC")]), k=4)
    >>> bool(flags[0, 5]), bool(flags[0, 1])  # the error is at index 5
    (True, False)
    """
    reads = np.asarray(reads, dtype=np.uint8)
    if reads.ndim == 1:
        reads = reads[None, :]
    if not np.all((reads > 0) & (reads < VC_LEN)):
        raise ValueError("reads must be over symbols 1..5 (no '$')")
    B, L = reads.shape
    if not 1 <= k <= L:
        raise ValueError(f"k={k} out of range for read length {L}")
    weak = _window_profile(bwt, reads, k, bidirectional) < tau   # [B, L-k+1]
    # base p is covered by windows j in [p-k+1, p] clipped to [0, L-k]
    flags = np.empty((B, L), dtype=bool)
    for p in range(L):
        j0, j1 = max(0, p - k + 1), min(p, L - k)
        flags[:, p] = weak[:, j0: j1 + 1].all(axis=1)
    return flags


def _score_candidates(bwt, reads, ridx, pidx, k: int, bidirectional: bool) -> np.ndarray:
    """[S, 4] min covering-window count per (suspect, candidate base); -1
    where the candidate equals the read's current base."""
    L = reads.shape[1]
    S = ridx.size
    p = pidx.astype(np.int64)
    j0 = np.maximum(0, p - k + 1)                    # first covering window
    j1 = np.minimum(p, L - k)                        # last covering window
    w = np.arange(k, dtype=np.int64)                 # window slot axis
    j = j0[:, None] + w[None, :]                     # [S, k] window starts
    valid_w = j <= j1[:, None]
    jc = np.minimum(j, j1[:, None])                  # clip for safe gathers
    t = np.arange(k, dtype=np.int64)                 # within-window axis
    base_win = reads[ridx[:, None, None], jc[:, :, None] + t[None, None, :]]  # [S, k, k]
    is_sub = t[None, None, :] == (p[:, None] - jc)[:, :, None]
    # all four candidate substitutions at once: [S, 4, k, k]
    km = np.where(is_sub[:, None, :, :], _DNA[None, :, None, None], base_win[:, None, :, :])
    cand_ok = _DNA[None, :] != reads[ridx, pidx][:, None]   # [S, 4]
    cell_ok = cand_ok[:, :, None] & valid_w[:, None, :]     # [S, 4, k]
    flat_ok = cell_ok.reshape(-1)
    kmers = km.reshape(-1, k)[flat_ok]
    counts_flat = np.zeros(flat_ok.size, dtype=np.int64)
    counts_flat[flat_ok] = np.asarray(
        bwt.count_kmers_bidirectional(kmers) if bidirectional else bwt.count_kmers(kmers)
    )
    counts = counts_flat.reshape(S, len(_DNA), k)
    counts[~cell_ok] = np.iinfo(np.int64).max        # excluded from the min
    mins = counts.min(axis=2)
    mins[~cand_ok] = -1
    return mins


def correct_reads(bwt, reads, k: int = 21, tau: int = 2, bidirectional: bool = True,
                  max_corrections_per_read: int | None = None,
                  suspect_chunk: int = 16384):
    """Returns ``(corrected_reads, n_corrected)``.

    One substitution per suspect base (the candidate whose weakest covering
    window is strongest, accepted iff it reaches ``tau``);
    ``max_corrections_per_read`` caps accepted fixes per read (leftmost
    first). Suspects are scored in chunks of ``suspect_chunk`` (one batched
    call of at most ``suspect_chunk * 4 * k`` k-mers each), so a batch where
    nearly every base is flagged makes more calls, not one enormous one.

    >>> from rust_msbwt_tpu_torch.models.dynamic import DynamicBWT
    >>> from rust_msbwt_tpu_torch.ops.alphabet import convert_itos, convert_stoi
    >>> bwt = DynamicBWT(device="cpu")
    >>> bwt.insert_strings(["ACGTAACC"] * 30, sorted=True)
    >>> fixed, n = correct_reads(bwt, np.array([convert_stoi("ACGTATCC")]), k=4)
    >>> convert_itos(fixed[0]), n
    ('ACGTAACC', 1)
    """
    reads = np.asarray(reads, dtype=np.uint8)
    if reads.ndim == 1:
        reads = reads[None, :]
    if suspect_chunk < 1:
        raise ValueError(f"suspect_chunk must be >= 1, got {suspect_chunk}")
    ridx, pidx = np.nonzero(flag_read_errors(bwt, reads, k, tau, bidirectional))
    S = ridx.size
    if S == 0:
        return reads.copy(), 0
    mins = np.concatenate([
        _score_candidates(bwt, reads, ridx[c0: c0 + suspect_chunk],
                          pidx[c0: c0 + suspect_chunk], k, bidirectional)
        for c0 in range(0, S, suspect_chunk)
    ])
    out = reads.copy()
    n_fixed = 0
    per_read: dict[int, int] = {}
    for s in range(S):
        c = int(np.argmax(mins[s]))
        if mins[s, c] < tau:
            continue
        r, p = int(ridx[s]), int(pidx[s])
        if max_corrections_per_read is not None:
            if per_read.get(r, 0) >= max_corrections_per_read:
                continue
            per_read[r] = per_read.get(r, 0) + 1
        out[r, p] = _DNA[c]
        n_fixed += 1
    return out, n_fixed
