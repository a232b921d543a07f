"""``msbwt2-build`` on the port: FASTX file(s) -> MSBWT -> npy or stdout.

    python -m rust_msbwt_tpu_torch.cli.build [-o OUT.npy] [--unsorted]
        [--batch-size N] [--distributed] [--device cuda|cpu] FASTX [FASTX ...]

Flag surface mirrors the reference (ref: src/bin/msbwt2-build.rs:23-41) and
the JAX package's ``cli.build``: ``-o/--out-bwt`` (default stdout), one or
more positional FASTX files (FASTA/FASTQ, gzip accepted), ``--unsorted``
for chronological insertion, ``--batch-size N`` to stream the reads
through the builder N at a time (each batch extends the BWT on the device),
``--distributed`` for a build over the ranks of a ``torch.distributed``
group (``parallel.multihost``: one process per card, NCCL; gloo with
``--device cpu``; rank 0 writes the output, the other ranks exit 0), plus
``--device`` (default ``cuda``)::

    torchrun --nproc-per-node 4 -m rust_msbwt_tpu_torch.cli.build \\
        --distributed -o out.npy reads.fq.gz

Exit codes follow the reference: 66 NOINPUT, 73 CANTCREAT, 74 IOERR
(ref: src/bin/msbwt2-build.rs:68,80,91,108).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

EX_NOINPUT = 66
EX_CANTCREAT = 73
EX_IOERR = 74


def main(argv=None) -> int:
    logging.basicConfig(
        level=os.environ.get("RUST_LOG", "info").upper(),
        format="[%(asctime)s %(levelname)s %(name)s] %(message)s",
    )
    logger = logging.getLogger("msbwt2-build")

    parser = argparse.ArgumentParser(
        prog="msbwt2-build",
        description="msbwt2 BWT Builder - will construct a BWT from one or "
        "more FASTX files (PyTorch / CUDA implementation)",
    )
    parser.add_argument(
        "-o", "--out-bwt", dest="out_bwt", default="stdout",
        help="The output BWT (default: stdout)",
    )
    parser.add_argument(
        "--unsorted", action="store_true",
        help="Insert strings chronologically instead of lexicographically",
    )
    parser.add_argument(
        "--batch-size", type=int, default=0, metavar="N",
        help="Stream reads through the builder N at a time (bounded device "
        "memory; 0 = one batch per file)",
    )
    parser.add_argument(
        "--distributed", action="store_true",
        help="Build over the ranks of a torch.distributed group: each rank "
        "builds its record stripe, a distributed D-way merge combines them; "
        "launch one process per card with torchrun (see "
        "parallel/multihost.py)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="torch device to build on (default: cuda)",
    )
    parser.add_argument(
        "FASTX", nargs="+",
        help="The FASTQ/A file(s) to load into the BWT, gzip accepted",
    )
    args = parser.parse_args(argv)
    sorted_strings = not args.unsorted

    logger.info("Input parameters (required):")
    logger.info("\tFASTX: %s", args.FASTX)
    logger.info("\tout_bwt: %r", args.out_bwt)
    logger.info("Optional Parameters:")
    logger.info(
        "\tsort order: %s",
        "lexicographical" if sorted_strings else "chronological",
    )
    if args.batch_size > 0:
        logger.info("\tbatch size: %d", args.batch_size)
    if args.distributed:
        logger.info("\tdistributed: yes")
    logger.info("\tdevice: %s", args.device)

    for fn in args.FASTX:
        if not os.path.isfile(fn):
            logger.error("Failed to open FASTX file: %r", fn)
            return EX_NOINPUT

    if args.out_bwt != "stdout":
        try:
            with open(args.out_bwt, "w"):
                pass
        except OSError as e:
            logger.error("Failed to create output BWT file: %r", args.out_bwt)
            logger.error("Error: %s", e)
            return EX_CANTCREAT

    from rust_msbwt_tpu_torch.models import dynamic
    from rust_msbwt_tpu_torch.ops.alphabet import convert_itos
    from rust_msbwt_tpu_torch.ops.rle import runs_from_symbols
    from rust_msbwt_tpu_torch.utils.npy import save_bwt_runs

    try:
        if args.distributed:
            from rust_msbwt_tpu_torch.parallel import mesh
            from rust_msbwt_tpu_torch.parallel.multihost import (
                build_from_fastx_distributed,
            )

            try:
                decoded, is_zero = build_from_fastx_distributed(
                    args.FASTX, sorted_strings, device=args.device)
            finally:
                mesh.shutdown()
            if not is_zero:  # only rank 0 writes output
                logger.info("Non-zero rank finished; skipping output.")
                return 0
        elif args.batch_size > 0:
            decoded = dynamic.create_from_fastx_streaming(
                args.FASTX, sorted_strings, args.batch_size, device=args.device).to_vec()
        else:
            decoded = dynamic.create_from_fastx(args.FASTX, sorted_strings,
                                               device=args.device).to_vec()
    except (OSError, ValueError) as e:  # parse errors
        logger.error("Error while parsing FASTX files: %s", args.FASTX)
        logger.error("Error: %s", e)
        return EX_IOERR

    if args.out_bwt == "stdout":
        sys.stdout.write(convert_itos(decoded))
        sys.stdout.write("\n")
    else:
        logger.info("Saving results to file: %r", args.out_bwt)
        try:
            syms, counts = runs_from_symbols(decoded)
            save_bwt_runs(syms, counts, args.out_bwt)
        except OSError as e:
            logger.error("Error saving BWT to file: %r", args.out_bwt)
            logger.error("Error: %s", e)
            return EX_IOERR

    logger.info("Processes successfully finished.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
