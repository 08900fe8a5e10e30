"""hypergen-tpu-torch CLI: sketch / dist on a CUDA card or the CPU.

The flags mirror ``hypergen_tpu.cli`` (reference:src/utils.rs:16-206), and
the outputs are byte-identical to ``python -m hypergen_tpu.cli ... -D cpu``:
  sketch -p DIR -o OUT.sketch [-k 21 -s 1500 -d 4096 -S 123 -m t1ha2 ...]
  dist   -r REF.sketch -q QUERY.sketch -o OUT.tsv [-a 85.0 ...]
``-D cuda`` (the default) runs on the first CUDA card and fails when there
is none; ``-D cpu`` runs the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from pathlib import Path

from hypergen_tpu_torch import params as P
from hypergen_tpu_torch.params import DistParams, SketchParams
from hypergen_tpu_torch.utils.logging import setup_logging

log = logging.getLogger("hypergen")

# minimum ANI threshold at which `dist` filters pairs on the device (below
# it, most pairs survive and whole dot tiles go to the host)
THRESHOLDED_DIST_MIN = 50.0


def _str2bool(v: str) -> bool:
    if v.lower() in ("true", "1", "yes"):
        return True
    if v.lower() in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"expected bool, got {v!r}")


def _add_common(sp: argparse.ArgumentParser) -> None:
    sp.add_argument("-t", "--thread", type=int, default=16,
                    help="# of host worker threads for file I/O")
    sp.add_argument("-C", "--canonical", type=_str2bool, default=True,
                    help="use canonical k-mers")
    sp.add_argument("-k", "--ksize", type=int, default=21, help="k-mer size")
    sp.add_argument("-S", "--seed", type=int, default=123, help="hash seed")
    sp.add_argument("-s", "--scaled", type=int, default=1500,
                    help="FracMinHash scaled factor")
    sp.add_argument("-d", "--hv_d", type=int, default=4096,
                    help="hypervector dimension")
    sp.add_argument("-Q", "--quant_scale", type=float, default=1.0,
                    help="HV quantization scale (parsed for compatibility; "
                         "unused, as in the reference)")
    sp.add_argument("-a", "--ani_th", type=float, default=85.0,
                    help="ANI report threshold")
    sp.add_argument("-D", "--device", type=str, default="cuda",
                    choices=["cuda", "cpu"],
                    help="device: 'cuda' runs on the first CUDA card and "
                         "fails without one; 'cpu' runs the plain PyTorch "
                         "versions of the kernels")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="hypergen-tpu-torch",
        description=(
            "HyperGen in PyTorch: genome sketching in hyperdimensional "
            "space on a CUDA card.\n"
            "1. sketch: FracMinHash + HDC sketching of .fna/.fa/.fasta\n"
            "2. dist:   ANI estimation between sketch files"
        ),
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--version", action="version", version=P.VERSION)
    sub = ap.add_subparsers(dest="mode", required=True)

    sk = sub.add_parser(P.CMD_SKETCH, help="sketch genome FASTA files")
    sk.add_argument("-p", "--path", type=Path, required=True,
                    help="input folder to sketch")
    # the reference's sketch subcommand parses -r/-q too (unused there,
    # reference:src/utils.rs:48-53); accept them so scripts port verbatim
    sk.add_argument("-r", "--path_r", type=Path, default=None,
                    help="(compat) unused in sketch mode")
    sk.add_argument("-q", "--path_q", type=Path, default=None,
                    help="(compat) unused in sketch mode")
    sk.add_argument("-o", "--out", type=Path, required=True,
                    help="output sketch file (.sketch)")
    sk.add_argument("-m", "--sketch_method", type=str, default="t1ha2",
                    choices=["t1ha2", "mmhash"])
    sk.add_argument("--shards", type=int, default=1,
                    help="(.hgdb output, not in this port yet)")
    sk.add_argument("--resume", action="store_true",
                    help="(.hgdb output, not in this port yet)")
    _add_common(sk)

    dp = sub.add_parser(P.CMD_DIST, help="estimate ANI between sketches")
    dp.add_argument("-p", "--path", type=Path, default=None,
                    help="(compat) unused")
    dp.add_argument("-r", "--path_r", type=Path, required=True,
                    help="reference sketch file")
    dp.add_argument("-q", "--path_q", type=Path, required=True,
                    help="query sketch file")
    dp.add_argument("-o", "--out", type=Path, required=True,
                    help="output ANI TSV")
    dp.add_argument("-m", "--sketch_method", type=str, default="fracminhash")
    _add_common(dp)
    return ap


def _device(name: str):
    import torch

    if name == "cuda" and not torch.cuda.is_available():
        log.error("-D cuda: no CUDA device is available (use -D cpu)")
        sys.exit(1)
    return torch.device(name)


def _load_db(path: Path):
    from hypergen_tpu_torch.io.sketch_db import load_sketch, sketches_to_db

    if path.is_dir():
        log.error("%s: .hgdb directories are not in this port yet", path)
        sys.exit(1)
    return sketches_to_db(load_sketch(path))


def run_sketch(args) -> None:
    from hypergen_tpu_torch.io.fastx import get_fasta_files
    from hypergen_tpu_torch.io.sketch_db import dump_sketch
    from hypergen_tpu_torch.models.sketcher import Sketcher

    sp = SketchParams(
        path=args.path, out_file=args.out, sketch_method=args.sketch_method,
        canonical=args.canonical, device=args.device, ksize=args.ksize,
        seed=args.seed, scaled=args.scaled, hv_d=args.hv_d,
        hv_quant_scale=args.quant_scale, threads=args.thread,
    )
    if str(args.out).endswith(".hgdb"):
        log.error(".hgdb output is not in this port yet; write a .sketch")
        sys.exit(1)
    files = get_fasta_files(sp.path)
    if not files:
        log.error("no FASTA files found under %s", sp.path)
        sys.exit(1)
    device = _device(args.device)
    log.info("Start sketching...")
    t0 = time.monotonic()
    sketches = Sketcher(sp, device=device).sketch_files(files)
    dt = time.monotonic() - t0
    log.info(
        "Sketching %d files took %.2fs - Speed: %.1f files/s",
        len(files), dt, len(files) / dt if dt > 0 else 0.0,
    )
    size = dump_sketch(sketches, args.out)
    log.info(
        "Dump sketch file to %s with size %.2f MB",
        args.out, size / 1024.0 / 1024.0,
    )


def run_dist(args) -> None:
    from hypergen_tpu_torch.models.comparator import (
        Comparator,
        report_sparsity,
        write_ani_report,
    )

    dp = DistParams(
        path_ref_sketch=args.path_r, path_query_sketch=args.path_q,
        out_file=args.out, ksize=args.ksize, hv_d=args.hv_d,
        ani_threshold=args.ani_th,
    )
    device = _device(args.device)
    t0 = time.monotonic()
    if_sym = dp.path_ref_sketch == dp.path_query_sketch
    ref_db = _load_db(dp.path_ref_sketch)
    query_db = ref_db if if_sym else _load_db(dp.path_query_sketch)
    if ref_db.ksize != query_db.ksize:
        log.error("Ref and query sketches use different kmer sizes!")
        sys.exit(1)
    if ref_db.hv_d != query_db.hv_d:
        log.error("Ref and query sketches use different HV dimensions!")
        sys.exit(1)
    log.info("Computing ANI..")
    # ksize comes from the sketch file, not the CLI flag
    # (reference:src/dist.rs:26,50)
    comp = Comparator(ksize=ref_db.ksize, device=device)
    if dp.ani_threshold >= THRESHOLDED_DIST_MIN:
        ri, qi, ani, n_total = comp.ani_pairs_thresholded(
            ref_db, query_db, symmetric=if_sym, threshold=dp.ani_threshold
        )
    else:
        ri, qi, ani, n_total = comp.ani_pairs_streamed(
            ref_db, query_db, symmetric=if_sym, threshold=dp.ani_threshold
        )
    n_rep = write_ani_report(
        dp.out_file, ref_db.names, query_db.names, ri, qi, ani,
        dp.ani_threshold,
    )
    report_sparsity(n_rep, n_total, dp.ani_threshold)
    log.info(
        "Computed ANIs for %d ref files and %d query files took %.3fs",
        len(ref_db.names), len(query_db.names), time.monotonic() - t0,
    )


def main(argv=None) -> None:
    setup_logging()
    args = build_parser().parse_args(argv)
    if args.mode == P.CMD_SKETCH:
        run_sketch(args)
    elif args.mode == P.CMD_DIST:
        run_dist(args)


if __name__ == "__main__":
    main()
