"""hypergen-tpu-torch CLI: sketch / dist / search / hist on CUDA or the CPU.

The flags mirror ``hypergen_tpu.cli`` (reference:src/utils.rs:16-206), and
the outputs are byte-identical to ``python -m hypergen_tpu.cli ... -D cpu``:
  sketch -p DIR -o OUT.sketch|OUT.hgdb [--shards n] [--resume] [-k 21 ...]
  dist   -r REF -q QUERY -o OUT.tsv [-a 85.0 ...]   (.sketch or .hgdb)
  search -r REF -q QUERY -o OUT.tsv [--top_k 10 ...]
  hist   -r REF                                      (value\tcount)
``-D cuda`` (the default) runs on the CUDA cards (`search` on all of them,
the rest on the first) and fails when there is none; ``-D cpu`` runs the
plain PyTorch versions of the kernels. ``HG_TRACE_DIR=DIR`` wraps the
command in a ``torch.profiler`` trace written under DIR (one file for each
process of a pod), in which the port's spans are the ranges ``hg:<name>``
(``utils.timing``); ``HG_STAGE_TIMING=1`` logs the sketch's per-stage times
(``Sketcher.sketch_files``): the host stages, which add up to the wall,
then the host's enqueue of each part of the sketch step, from the span
totals over the call.

A pod (several processes, ``parallel.mesh``: the ``HG_*`` variables or
``torchrun`` with ``HG_DIST=1``) runs the JAX CLI's pod paths, each process
on its own card only: `sketch` into an ``.hgdb`` (process p sketches
files[p::n] into one shard; process 0 merges the manifest; ``--resume``
keeps the existing shards as the prefix), `dist` (each process takes its
own range of reference rows; process 0 merges the parts into the TSV) and
`search` (each process loads only its own DB rows; the top-k candidates
are gathered). The outputs are the one-process run's bytes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import time
from pathlib import Path

import numpy as np

from hypergen_tpu_torch import params as P
from hypergen_tpu_torch.params import DistParams, SketchParams
from hypergen_tpu_torch.utils.logging import setup_logging
from hypergen_tpu_torch.utils.timing import maybe_profile

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
                         "(search: on every card; a pod process: on its "
                         "own card only) and fails without one; 'cpu' runs "
                         "the plain PyTorch versions of the kernels")


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
    from hypergen_tpu_torch.parallel import mesh

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
    if mesh.process_count() > 1:
        if not is_hgdb:
            log.error("multi-host sketching requires an .hgdb output")
            sys.exit(1)
        _run_sketch_pod(sp, files, args)
        return
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


def _run_sketch_pod(sp: SketchParams, files, args) -> None:
    """Pod sketch: process p sketches files[p::nproc] on its own card and
    writes one DB shard; process 0 merges the manifest. With --resume on an
    existing .hgdb, sketched genomes are skipped and the existing shards
    stay the merged manifest's prefix. The JAX package's _run_sketch_pod,
    except that a huge genome's sequence-parallel route stays on this
    process's card (Sketcher's seqpar_devices)."""
    from hypergen_tpu_torch.io.sketch_db import (
        ShardedDB, dump_db_shard_part, merge_db_parts, sketches_to_db,
    )
    from hypergen_tpu_torch.models.sketcher import Sketcher
    from hypergen_tpu_torch.parallel import mesh

    token = mesh.shared_run_token()  # guards the merge against stale parts
    pid, nproc = mesh.process_index(), mesh.process_count()
    base_manifest = None
    shard_offset = 0
    manifest_path = Path(args.out) / "manifest.json"
    if args.resume and manifest_path.exists():
        base_manifest = json.loads(manifest_path.read_text())
        _check_resume_params(base_manifest, sp)
        files, skipped = _filter_resumed(base_manifest, files)
        if skipped and pid == 0:
            log.info("Resume: %d of %d genomes already sketched", skipped,
                     skipped + len(files))
        shard_offset = max(
            (sh["id"] + 1 for sh in base_manifest["shards"]), default=0
        )
    mine = files[pid::nproc]
    (card,) = mesh.local_devices(args.device)
    log.info("Pod sketch: process %d/%d takes %d of %d files on %s",
             pid, nproc, len(mine), len(files), card)
    t0 = time.monotonic()
    sketches = Sketcher(sp, device=card, seqpar_devices=[card]).sketch_files(
        mine)
    dt = time.monotonic() - t0
    log.info("Sketching %d files took %.2fs - Speed: %.1f files/s",
             len(mine), dt, len(mine) / dt if dt > 0 else 0.0)
    if sketches:
        db = sketches_to_db(sketches)
        db.sketch_method = sp.sketch_method
    else:  # more processes than files: publish an empty part
        db = ShardedDB(
            ksize=sp.ksize, scaled=sp.scaled, canonical=sp.canonical,
            seed=sp.seed, hv_d=sp.hv_d, names=[],
            hvs=np.zeros((0, sp.hv_d), np.int16),
            norms=np.zeros((0,), np.int32),
            sketch_method=sp.sketch_method,
        )
    dump_db_shard_part(
        db, args.out, pid, nproc, token=token, shard_id=shard_offset + pid
    )
    if pid == 0:
        merge_db_parts(args.out, nproc, token=token,
                       base_manifest=base_manifest)
        log.info("Merged %d DB parts into %s", nproc, args.out)


def run_dist(args, top_k: int = 0) -> None:
    """All-pairs dist. top_k (library callers only; the CLI always passes
    0) is a global cap on report rows, not the per-query cap of `search`."""
    from hypergen_tpu_torch.models.comparator import (
        Comparator,
        report_sparsity,
        write_ani_report,
    )
    from hypergen_tpu_torch.parallel import mesh

    dp = DistParams(
        path_ref_sketch=args.path_r, path_query_sketch=args.path_q,
        out_file=args.out, ksize=args.ksize, hv_d=args.hv_d,
        ani_threshold=args.ani_th, top_k=top_k,
    )
    device = _device(args.device)
    t0 = time.monotonic()
    if_sym = dp.path_ref_sketch == dp.path_query_sketch
    if mesh.process_count() > 1:
        _run_dist_pod(dp, if_sym, t0, mesh.local_devices(args.device)[0])
        return
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
        dp.ani_threshold, top_k=dp.top_k,
    )
    report_sparsity(n_rep, n_total, dp.ani_threshold)
    log.info(
        "Computed ANIs for %d ref files and %d query files took %.3fs",
        len(ref_db.names), len(query_db.names), time.monotonic() - t0,
    )


# query rows a pod process holds at once when it streams the query side
Q_CHUNK = 8192


def _run_dist_pod(dp: DistParams, if_sym: bool, t0: float, device) -> None:
    """Pod dist: process p computes the pairs of its own reference row
    range [round(p*M/n), round((p+1)*M/n)) on `device`; process 0 merges
    the parts into the TSV. An .hgdb is read row range by row range
    (load_db_rows); a .sketch is loaded once and row-sliced. Queries stream
    in Q_CHUNK rows; global row offsets keep the symmetric i < j pair set
    exact across processes and let the comparator skip tiles below the
    diagonal. The merge loads the parts one at a time with int32 indices
    and streams the TSV (write_ani_report). The JAX package's
    _run_dist_pod."""
    from hypergen_tpu_torch.io.sketch_db import (
        load_db_rows, wait_for_part_files,
    )
    from hypergen_tpu_torch.models.comparator import (
        Comparator, report_sparsity, write_ani_report,
    )
    from hypergen_tpu_torch.parallel import mesh

    token = mesh.shared_run_token()
    pid, nproc = mesh.process_index(), mesh.process_count()
    r_is_hgdb = Path(dp.path_ref_sketch).is_dir()
    if r_is_hgdb:
        manifest = json.loads(
            (Path(dp.path_ref_sketch) / "manifest.json").read_text()
        )
        M, r_names, r_ksize, r_hvd = (
            manifest["n_genomes"], manifest["names"],
            manifest["ksize"], manifest["hv_d"],
        )
    else:
        ref_full = _load_db(dp.path_ref_sketch)
        M, r_names, r_ksize, r_hvd = (
            len(ref_full.names), ref_full.names,
            ref_full.ksize, ref_full.hv_d,
        )
    q_is_hgdb = Path(dp.path_query_sketch).is_dir()
    if q_is_hgdb:
        q_manifest = json.loads(
            (Path(dp.path_query_sketch) / "manifest.json").read_text()
        )
        q_names, q_ksize, q_hvd = (
            q_manifest["names"], q_manifest["ksize"], q_manifest["hv_d"],
        )
    else:
        query_full = ref_full if if_sym else _load_db(dp.path_query_sketch)
        q_names, q_ksize, q_hvd = (
            query_full.names, query_full.ksize, query_full.hv_d,
        )
    if r_ksize != q_ksize or r_hvd != q_hvd:
        log.error("Ref and query sketch parameters mismatch!")
        sys.exit(1)
    N = len(q_names)
    lo = round(pid * M / nproc)
    hi = round((pid + 1) * M / nproc)
    log.info("Pod dist: process %d/%d takes reference rows [%d, %d) of %d",
             pid, nproc, lo, hi, M)
    ref_part = (
        load_db_rows(dp.path_ref_sketch, lo, hi)
        if r_is_hgdb else _slice_db(ref_full, lo, hi)
    )
    comp = Comparator(ksize=q_ksize, device=device)
    thresholded = dp.ani_threshold >= THRESHOLDED_DIST_MIN
    ref_blocks = (
        comp.preload_ref(ref_part) if thresholded
        else comp.preload_rows(ref_part.hvs)
    )
    pairs = (comp.ani_pairs_thresholded if thresholded
             else comp.ani_pairs_streamed)
    rs, qs, asv = [], [], []
    for qlo in range(0, N, Q_CHUNK):
        qhi = min(qlo + Q_CHUNK, N)
        q_part = (
            load_db_rows(dp.path_query_sketch, qlo, qhi)
            if q_is_hgdb else _slice_db(query_full, qlo, qhi)
        )
        ri, qi, ani, _ = pairs(
            ref_part, q_part, symmetric=if_sym, threshold=dp.ani_threshold,
            ref_blocks=ref_blocks, ref_offset=lo, query_offset=qlo,
        )
        rs.append((ri + lo).astype(np.int32))
        qs.append((qi + qlo).astype(np.int32))
        asv.append(ani)
    ri = np.concatenate(rs) if rs else np.zeros(0, np.int32)
    qi = np.concatenate(qs) if qs else np.zeros(0, np.int32)
    ani = np.concatenate(asv) if asv else np.zeros(0, np.float32)
    n_total = M * (M - 1) // 2 if if_sym else M * N
    out = Path(dp.out_file)
    part = out.with_suffix(out.suffix + f".part{pid:05d}.{token}.npz")
    np.savez(part, ri=ri, qi=qi, ani=ani)
    part.with_suffix(".done").write_text("ok")
    if pid != 0:
        return
    # process 0: wait for this run's parts and merge them in rank order,
    # one part at a time, with int32 indices (12 B a pair and the sort)
    parts = [
        out.with_suffix(out.suffix + f".part{p:05d}.{token}.npz")
        for p in range(nproc)
    ]
    wait_for_part_files([p.with_suffix(".done") for p in parts])
    ri_l, qi_l, ani_l = [], [], []
    for p in parts:
        with np.load(p) as z:
            ri_l.append(z["ri"].astype(np.int32, copy=False))
            qi_l.append(z["qi"].astype(np.int32, copy=False))
            ani_l.append(z["ani"])
    ri, qi, ani = (
        np.concatenate(ri_l), np.concatenate(qi_l), np.concatenate(ani_l)
    )
    del ri_l, qi_l, ani_l
    order = np.lexsort((qi, ri))
    ri, qi, ani = ri[order], qi[order], ani[order]
    del order
    n_rep = write_ani_report(
        out, r_names, q_names, ri, qi, ani, dp.ani_threshold,
        top_k=dp.top_k,
    )
    for p in parts:
        p.unlink(missing_ok=True)
        p.with_suffix(".done").unlink(missing_ok=True)
    report_sparsity(n_rep, n_total, dp.ani_threshold)
    log.info(
        "Computed ANIs for %d ref files and %d query files took %.3fs",
        M, N, time.monotonic() - t0,
    )


def _slice_db(db, lo: int, hi: int):
    """Rows [lo, hi) of a ShardedDB, as views."""
    return dataclasses.replace(
        db, names=db.names[lo:hi], hvs=db.hvs[lo:hi], norms=db.norms[lo:hi]
    )


def run_search(args) -> None:
    from hypergen_tpu_torch.parallel import mesh
    from hypergen_tpu_torch.parallel.search import (
        default_devices, run_search_cli,
    )

    _device(args.device)
    devices = (mesh.local_devices(args.device) if mesh.process_count() > 1
               else default_devices(args.device))
    run_search_cli(args, _load_db, devices)


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
    # a pod's group starts before the first CUDA allocation; without it
    # every pod branch below would run as N one-process runs
    from hypergen_tpu_torch.parallel import mesh

    device = getattr(args, "device", "cpu")
    owned = mesh.maybe_init_distributed(device)
    try:
        with maybe_profile(os.environ.get("HG_TRACE_DIR", ""),
                           cuda=device == "cuda"):
            if args.mode == P.CMD_SKETCH:
                run_sketch(args)
            elif args.mode == P.CMD_DIST:
                run_dist(args)
            elif args.mode == P.CMD_SEARCH:
                run_search(args)
            elif args.mode == "hist":
                run_hist(args)
    finally:
        if owned:
            mesh.finalize()


if __name__ == "__main__":
    main()
