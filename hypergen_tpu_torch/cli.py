"""hypergen-tpu-torch CLI: sketch / dist / search / hist on CUDA or the CPU.

The flags mirror ``hypergen_tpu.cli`` (reference:src/utils.rs:16-206), and
the outputs are byte-identical to ``python -m hypergen_tpu.cli ... -D cpu``:
  sketch -p DIR -o OUT.sketch|OUT.hgdb [--shards n] [--resume] [-k 21 ...]
  dist   -r REF -q QUERY -o OUT.tsv [-a 85.0 ...]   (.sketch or .hgdb)
  search -r REF -q QUERY -o OUT.tsv [--top_k 10 ...]
  hist   -r REF                                      (value\tcount)
``-D cuda`` (the default) runs on the CUDA cards (`search` on all of them,
the rest on the first) and fails when there is none; ``-D cpu`` runs the
plain PyTorch versions of the kernels. The multi-process (pod) paths of the
JAX CLI are not in this port.
"""

from __future__ import annotations

import argparse
import json
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
                    help="device: 'cuda' runs on the first CUDA card "
                         "(search: on every card) and fails without one; "
                         "'cpu' runs the plain PyTorch versions of the "
                         "kernels")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="hypergen-tpu-torch",
        description=(
            "HyperGen in PyTorch: genome sketching in hyperdimensional "
            "space on a CUDA card.\n"
            "1. sketch: FracMinHash + HDC sketching of .fna/.fa/.fasta\n"
            "2. dist:   ANI estimation between sketch databases\n"
            "3. search: top-k database search"
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
                    help="output sketch file (.sketch) or DB dir (.hgdb)")
    sk.add_argument("-m", "--sketch_method", type=str, default="t1ha2",
                    choices=["t1ha2", "mmhash"])
    sk.add_argument("--shards", type=int, default=1,
                    help="number of shards when writing an .hgdb directory")
    sk.add_argument("--resume", action="store_true",
                    help="skip genomes already present in an existing .hgdb "
                         "output (crash/preemption recovery; the reference's "
                         "all-or-nothing .sketch write has no equivalent)")
    _add_common(sk)

    for name, extra in ((P.CMD_DIST, False), (P.CMD_SEARCH, True)):
        dp = sub.add_parser(
            name,
            help="estimate ANI between sketches" if not extra
            else "top-k search of query sketches against a reference DB",
        )
        dp.add_argument("-p", "--path", type=Path, default=None,
                        help="(compat) unused")
        dp.add_argument("-r", "--path_r", type=Path, required=True,
                        help="reference sketch file / .hgdb dir")
        dp.add_argument("-q", "--path_q", type=Path, required=True,
                        help="query sketch file / .hgdb dir")
        dp.add_argument("-o", "--out", type=Path, required=True,
                        help="output ANI TSV")
        dp.add_argument("-m", "--sketch_method", type=str,
                        default="fracminhash")
        if extra:
            dp.add_argument("--top_k", type=int, default=10,
                            help="hits reported per query")
        _add_common(dp)

    hp = sub.add_parser(
        "hist",
        help="print value\\tcount histogram of all HV entries in a sketch "
             "(debug utility, reference:src/utils.rs:312-337)",
    )
    hp.add_argument("-r", "--path_r", type=Path, required=True,
                    help="sketch file to histogram")
    return ap


def _device(name: str):
    import torch

    if name == "cuda" and not torch.cuda.is_available():
        log.error("-D cuda: no CUDA device is available (use -D cpu)")
        sys.exit(1)
    return torch.device(name)


def _load_db(path: Path):
    from hypergen_tpu_torch.io.sketch_db import (
        load_sharded_db, load_sketch, sketches_to_db,
    )

    if path.is_dir():
        return load_sharded_db(path)
    return sketches_to_db(load_sketch(path))


def run_sketch(args) -> None:
    from hypergen_tpu_torch.io.fastx import get_fasta_files
    from hypergen_tpu_torch.io.sketch_db import (
        append_db_shard, dump_sharded_db, dump_sketch, sketches_to_db,
    )
    from hypergen_tpu_torch.models.sketcher import Sketcher

    sp = SketchParams(
        path=args.path, out_file=args.out, sketch_method=args.sketch_method,
        canonical=args.canonical, device=args.device, ksize=args.ksize,
        seed=args.seed, scaled=args.scaled, hv_d=args.hv_d,
        hv_quant_scale=args.quant_scale, threads=args.thread,
    )
    files = get_fasta_files(sp.path)
    if not files:
        log.error("no FASTA files found under %s", sp.path)
        sys.exit(1)
    is_hgdb = str(args.out).endswith(".hgdb")
    resuming = False
    if args.resume and is_hgdb and (Path(args.out) / "manifest.json").exists():
        manifest = json.loads((Path(args.out) / "manifest.json").read_text())
        _check_resume_params(manifest, sp)
        files, skipped = _filter_resumed(manifest, files)
        if skipped:
            log.info("Resume: %d of %d genomes already sketched", skipped,
                     skipped + len(files))
        resuming = True
        if not files:
            log.info("Resume: nothing left to sketch")
            return
    device = _device(args.device)
    log.info("Start sketching...")
    t0 = time.monotonic()
    sketches = Sketcher(sp, device=device).sketch_files(files)
    dt = time.monotonic() - t0
    log.info(
        "Sketching %d files took %.2fs - Speed: %.1f files/s",
        len(files), dt, len(files) / dt if dt > 0 else 0.0,
    )
    if is_hgdb:
        db = sketches_to_db(sketches)
        db.sketch_method = sp.sketch_method
        if resuming:
            # one new shard; the existing shard files stay untouched
            append_db_shard(args.out, db)
        else:
            dump_sharded_db(db, args.out, n_shards=args.shards)
        log.info("Dump sharded DB to %s", args.out)
    else:
        size = dump_sketch(sketches, args.out)
        log.info(
            "Dump sketch file to %s with size %.2f MB",
            args.out, size / 1024.0 / 1024.0,
        )


def _resolved_set(manifest: dict) -> set:
    """Absolute-path resume keys for an existing manifest.

    Prefers the manifest's resolved_names (absolute paths written by the
    run that recorded them, in its own cwd), so resuming from another
    working directory still matches relative input paths; a manifest
    without the field resolves its names in the current cwd."""
    names = manifest.get("resolved_names") or manifest["names"]
    return {str(Path(n).resolve()) for n in names}


def _check_resume_params(manifest: dict, sp: SketchParams) -> None:
    """--resume must never append rows sketched with other parameters."""
    if (
        manifest["ksize"], manifest["scaled"], manifest["seed"],
        manifest["hv_d"], manifest["canonical"],
        manifest.get("sketch_method", "t1ha2"),
    ) != (
        sp.ksize, sp.scaled, sp.seed, sp.hv_d,
        sp.canonical, sp.sketch_method,
    ):
        log.error("--resume: existing DB has different sketch params")
        sys.exit(1)


def _filter_resumed(manifest: dict, files) -> tuple:
    """(files not yet in the DB, skipped count), matched by resolved path,
    so an input spelled differently (relative or absolute) is not sketched
    twice. Each path resolves once."""
    done = _resolved_set(manifest)
    resolved = [str(Path(f).resolve()) for f in files]
    remaining = [f for f, r in zip(files, resolved) if r not in done]
    return remaining, len(files) - len(remaining)


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


def run_search(args) -> None:
    from hypergen_tpu_torch.parallel.search import (
        default_devices, run_search_cli,
    )

    _device(args.device)
    run_search_cli(args, _load_db, default_devices(args.device))


def run_hist(args) -> None:
    from hypergen_tpu_torch.io.sketch_db import (
        hv_value_histogram, hv_value_histogram_sharded, load_sketch,
    )

    if args.path_r.is_dir():
        hist = hv_value_histogram_sharded(args.path_r)
    else:
        hist = hv_value_histogram(load_sketch(args.path_r))
    try:
        for value, count in sorted(hist.items()):
            print(f"{value}\t{count}")
    except BrokenPipeError:  # downstream `head` etc. closed the pipe
        sys.stderr.close()


def main(argv=None) -> None:
    setup_logging()
    args = build_parser().parse_args(argv)
    if args.mode == P.CMD_SKETCH:
        run_sketch(args)
    elif args.mode == P.CMD_DIST:
        run_dist(args)
    elif args.mode == P.CMD_SEARCH:
        run_search(args)
    elif args.mode == "hist":
        run_hist(args)


if __name__ == "__main__":
    main()
