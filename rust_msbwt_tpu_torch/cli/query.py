"""``msbwt2-query`` on the port: batched k-mer counts from the command line.

    python -m rust_msbwt_tpu_torch.cli.query BWT.npy [KMER ...] [-i FILE|-]
        [--cache-k K] [--device cuda|cpu]

Loads a ``comp_msbwt.npy`` BWT, counts every k-mer given as arguments or
one per line from a file/stdin, prints ``kmer<TAB>count``. The JAX CLI's
``--locate``, ``--max-mismatch`` and ``--index-pack`` are not ported yet.

Exit codes follow the build CLI's convention (66 NOINPUT, 74 IOERR).
"""

from __future__ import annotations

import argparse
import contextlib
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
    logger = logging.getLogger("msbwt2-query")

    parser = argparse.ArgumentParser(
        prog="msbwt2-query",
        description="Batched k-mer counts over a msbwt2 BWT "
        "(PyTorch / CUDA implementation)",
    )
    parser.add_argument("BWT", help="comp_msbwt.npy file")
    parser.add_argument("KMER", nargs="*", help="k-mers ($ACGNT strings)")
    parser.add_argument(
        "-i", "--input", default=None,
        help="file with one k-mer per line ('-' for stdin)",
    )
    parser.add_argument(
        "--cache-k", type=int, default=0, metavar="K",
        help="precompute a 6^K prefix-range cache before querying (K <= 8)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="torch device to query on (default: cuda)",
    )
    args = parser.parse_args(argv)

    if not os.path.isfile(args.BWT):
        logger.error("Failed to open BWT file: %r", args.BWT)
        return EX_NOINPUT

    kmers_txt = list(args.KMER)
    if args.input is not None:
        try:
            fp = sys.stdin if args.input == "-" else open(args.input)
            with contextlib.nullcontext(fp) if fp is sys.stdin else fp:
                kmers_txt += [ln.strip() for ln in fp if ln.strip()]
        except OSError as e:
            logger.error("Failed to read k-mers: %s", e)
            return EX_NOINPUT
    if not kmers_txt:
        logger.error("No k-mers given (arguments or --input)")
        return EX_NOINPUT

    import numpy as np

    from rust_msbwt_tpu_torch.models.rle_bwt import RleBWT
    from rust_msbwt_tpu_torch.ops.alphabet import convert_stoi

    try:
        bwt = RleBWT(device=args.device)
        bwt.load_numpy_file(args.BWT)
    except OSError as e:
        logger.error("Error loading BWT: %s", e)
        return EX_IOERR
    if args.cache_k > 0:
        bwt.enable_kmer_cache(args.cache_k)

    K = max(len(k) for k in kmers_txt)
    B = len(kmers_txt)
    kmers = np.zeros((B, K), dtype=np.uint8)
    lengths = np.empty(B, dtype=np.int32)
    for i, txt in enumerate(kmers_txt):
        enc = convert_stoi(txt)
        kmers[i, K - len(enc):] = enc
        lengths[i] = len(enc)
    counts = bwt.count_kmers(kmers, lengths)
    out = sys.stdout
    for txt, cnt in zip(kmers_txt, counts.tolist()):
        out.write(f"{txt}\t{cnt}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
