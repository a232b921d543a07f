"""``msbwt2-convert`` on the port: a raw BWT character stream -> the
compressed ``comp_msbwt.npy``.

    python -m rust_msbwt_tpu_torch.cli.convert [-i RAW_BWT] COMP_MSBWT.NPY

The flags mirror the reference (ref: src/bin/msbwt2-convert.rs:24-42):
``-i/--input`` (default stdin) and the positional output. Intended for
externally built BWTs, such as the ropebwt2 pipeline of the reference
README. The conversion runs on the host (numpy). Exit codes: 66 when the
input cannot be opened, 74 for a bad symbol or an unwritable output.
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
    logger = logging.getLogger("msbwt2-convert")

    parser = argparse.ArgumentParser(
        prog="msbwt2-convert",
        description="msbwt2 BWT Converter - this will convert an external "
        "BWT to our expected representation",
    )
    parser.add_argument("-i", "--input", dest="in_fn", default="stdin",
                        help="The raw uncompressed BWT (default: stdin)")
    parser.add_argument("COMP_MSBWT_NPY", metavar="COMP_MSBWT.NPY",
                        help="The location to store the compressed BWT")
    args = parser.parse_args(argv)

    logger.info("Input parameters (required):")
    logger.info('\tInput BWT: "%s"', args.in_fn)
    if args.in_fn == "stdin":
        data = sys.stdin.buffer.read()
    else:
        try:
            with open(args.in_fn, "rb") as fp:
                data = fp.read()
        except OSError as e:
            logger.error("Failed to open BWT file: %s", e)
            return EX_NOINPUT
    logger.info('\tOutput BWT: "%s"', args.COMP_MSBWT_NPY)

    from rust_msbwt_tpu_torch.ops.rle import convert_to_vec, symbol_counts_from_bytes
    from rust_msbwt_tpu_torch.utils.npy import save_bwt_bytes

    try:
        comp = convert_to_vec(data)
    except ValueError as e:
        logger.error("Error: %s", e)
        return EX_IOERR
    logger.info("Converted BWT with symbol counts: %s",
                symbol_counts_from_bytes(comp).tolist())
    logger.info("RLE-BWT byte length: %d", comp.size)
    try:
        save_bwt_bytes(comp, args.COMP_MSBWT_NPY)
    except OSError as e:
        logger.error("Error saving BWT to file: %r", args.COMP_MSBWT_NPY)
        logger.error("Error: %s", e)
        return EX_IOERR
    logger.info("RLE-BWT conversion complete.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
