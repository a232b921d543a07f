"""``msbwt2-correct`` on the port: k-mer-spectrum read correction.

    python -m rust_msbwt_tpu_torch.cli.correct BWT.npy READS.fa[.gz]
        [-o OUT.fa] [-k 21] [--tau 2] [--single-strand]
        [--max-corrections N] [--batch-size 4096] [--cache-k K]
        [--device cuda|cpu]

Loads a ``comp_msbwt.npy`` BWT, reads FASTA/FASTQ (plain or gzip), flags
and repairs suspect bases with ``apps.correct`` on the device, and writes
the reads as FASTA in input order, under their own names. Reads are
bucketed by length (one batch shape each) and scored ``--batch-size`` at a
time; reads shorter than k pass through unchanged. Exit codes follow the
build CLI's convention (66 NOINPUT, 74 IOERR).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

EX_NOINPUT = 66
EX_IOERR = 74


def main(argv=None) -> int:
    logging.basicConfig(
        level=os.environ.get("RUST_LOG", "info").upper(),
        format="[%(asctime)s %(levelname)s %(name)s] %(message)s",
    )
    logger = logging.getLogger("msbwt2-correct")

    parser = argparse.ArgumentParser(
        prog="msbwt2-correct",
        description="k-mer-spectrum read correction over a msbwt2 BWT "
        "(PyTorch / CUDA implementation)",
    )
    parser.add_argument("BWT", help="comp_msbwt.npy file")
    parser.add_argument("READS", help="FASTA/FASTQ reads to correct (plain or gzip)")
    parser.add_argument("-o", "--out", default=None,
                        help="output FASTA (default: stdout)")
    parser.add_argument("-k", "--kmer-size", type=int, default=21,
                        help="window size (default 21)")
    parser.add_argument("--tau", type=int, default=2,
                        help="weak-count threshold: counts strictly below "
                        "tau are weak (default 2)")
    parser.add_argument("--single-strand", action="store_true",
                        help="count forward-strand k-mers only (default "
                        "counts both strands, the fmlrc convention)")
    parser.add_argument("--max-corrections", type=int, default=None,
                        metavar="N", help="cap accepted fixes per read")
    parser.add_argument("--batch-size", type=int, default=4096,
                        help="reads scored per device batch (default 4096)")
    parser.add_argument("--cache-k", type=int, default=0, metavar="K",
                        help="precompute a 6^K prefix-range cache")
    parser.add_argument("--device", default="cuda",
                        help="torch device to correct on (default: cuda)")
    args = parser.parse_args(argv)

    for path in (args.BWT, args.READS):
        if not os.path.isfile(path):
            logger.error("Failed to open file: %r", path)
            return EX_NOINPUT
    if args.kmer_size < 1:
        logger.error("k must be >= 1 (got %d)", args.kmer_size)
        return EX_NOINPUT
    if args.batch_size < 1:
        logger.error("--batch-size must be >= 1 (got %d)", args.batch_size)
        return EX_NOINPUT

    import numpy as np

    from rust_msbwt_tpu_torch.apps.correct import correct_reads
    from rust_msbwt_tpu_torch.models.rle_bwt import RleBWT
    from rust_msbwt_tpu_torch.ops.alphabet import STRING_TO_INT, convert_itos
    from rust_msbwt_tpu_torch.utils.fastx import parse_fastx_records

    try:
        bwt = RleBWT(device=args.device)
        bwt.load_numpy_file(args.BWT)
    except OSError as e:
        logger.error("Error loading BWT: %s", e)
        return EX_IOERR
    if args.cache_k > 0:
        bwt.enable_kmer_cache(args.cache_k)

    try:
        records = list(parse_fastx_records(args.READS))
    except (OSError, ValueError) as e:
        logger.error("Error reading %r: %s", args.READS, e)
        return EX_IOERR
    names = [n for n, _ in records]
    seqs = [s for _, s in records]

    by_len: dict[int, list[int]] = {}
    for i, s in enumerate(seqs):
        by_len.setdefault(len(s), []).append(i)

    out_seqs: list[str | None] = [None] * len(seqs)
    n_fixed = n_scored = 0
    for length, idxs in sorted(by_len.items()):
        if length < args.kmer_size or length == 0:
            for i in idxs:  # too short to score: passed through verbatim
                out_seqs[i] = seqs[i].decode()
            continue
        for lo in range(0, len(idxs), args.batch_size):
            chunk = idxs[lo: lo + args.batch_size]
            mat = np.stack([STRING_TO_INT[np.frombuffer(seqs[i], dtype=np.uint8)]
                            for i in chunk])
            fixed, nf = correct_reads(
                bwt, mat, k=args.kmer_size, tau=args.tau,
                bidirectional=not args.single_strand,
                max_corrections_per_read=args.max_corrections,
            )
            n_fixed += nf
            n_scored += len(chunk)
            for row, i in enumerate(chunk):
                out_seqs[i] = convert_itos(fixed[row])
    logger.info("corrected %d bases across %d reads (%d scored, %d too short)",
                n_fixed, len(seqs), n_scored, len(seqs) - n_scored)

    try:
        fh = open(args.out, "w") if args.out else sys.stdout
        try:
            for i, s in enumerate(out_seqs):
                # keep each record's name (mate pairing, barcodes); a
                # nameless record gets a positional one
                name = names[i].decode(errors="replace") or f"read_{i}"
                fh.write(f">{name}\n{s}\n")
        finally:
            if fh is not sys.stdout:
                fh.close()
    except OSError as e:
        logger.error("Error writing output: %s", e)
        return EX_IOERR
    return 0


if __name__ == "__main__":
    sys.exit(main())
