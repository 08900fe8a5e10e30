"""Database search: per-shard top-k ANI and a merge.

Counterpart of ``hypergen_tpu.parallel.search``. The JAX package shards the
DB over a (db, q) mesh with ``shard_map`` and merges the per-shard
candidates with ``all_gather``. Here one process walks a list of
``torch.device``s (repeats allowed, as ``parallel.seqpar`` takes them), and
the collective becomes copies to ``devices[0]``. There is one layout, for
any number of devices:

  DB rows padded with zero HVs to Mp = ceil(M / ndev) * ndev
    -> row tiles of ndev * rp rows over [0, Mp) (rp from the per-device
       pair budget PAIRS_PER_DEVICE_TILE_LIMIT, at most Mp / ndev, so a
       DB within the budget is one tile), each split evenly over the
       devices
    -> on each device: exact dots, the device float32 ANI, a local top-k
       (-inf slots when a shard has fewer than k rows)
    -> the candidates copied to devices[0], device-major, and merged after
       the running candidates of the earlier tiles
    -> rows at or past M masked to (-inf, 0, 0) once, after the fetch

Ranking follows ``jax.lax.top_k``: ANI descending, and among equal values
the lower DB row first (``ops.ani.topk_desc``). Every merge lists lower
rows first, and a zero padding row has ANI exactly 0 (every real row has
ANI >= 0) after every real row, so padding never displaces a real row and
the winners, the -inf slots included, are the JAX package's. In a pod
(``parallel.mesh``), ``multihost_topk_search`` runs the same tiles per
process over its own block of rows and gathers the processes' candidates
with ``torch.distributed.all_gather``.

The dot mode is decided on the devices from the bytes already uploaded
(``ops.ani.resolve_mode``): the queries once a call, on devices[0], then,
where the mode is True (or None on a card) and the queries fit
SMALL_SPLIT_MAX, each tile's rows on their device, so one tile may take
the 3-product split and the next the 4-way one; every mode gives the same
int32 dots. The search times its parts in the spans
(``utils.timing.span``) ``search_mode_scan`` (the mode's decision: once
for the queries and once a tile on each device, each a reduction on the
device and one host read), ``search_upload`` (the rows' and queries'
copies to the devices), ``search_dot_topk`` (the dots, top-k, pads and
merges), ``search_fetch`` (the copy back, which waits for the devices)
and, in ``run_search_cli``, ``search_host_chain`` (the host float chain
and the TSV).
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np
import torch

from hypergen_tpu_torch.ops.ani import ani_topk, resolve_mode, topk_desc
from hypergen_tpu_torch.utils.timing import span

log = logging.getLogger("hypergen")

# per-device ANI-matrix budget above which DB search streams row tiles
# instead of materializing the full (M/ndb x N) matrix at once
PAIRS_PER_DEVICE_TILE_LIMIT = 1 << 28


def default_devices(name: str) -> List[torch.device]:
    """Every CUDA card for ``"cuda"``, else ``[torch.device(name)]``."""
    if name != "cuda":
        return [torch.device(name)]
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("search: no CUDA device (pass devices=['cpu'])")
    return [torch.device("cuda", i) for i in range(n)]


def _padded_rows(hv: np.ndarray, lo: int, rows: int,
                 device) -> torch.Tensor:
    """Rows [lo, lo + rows) of hv on ``device``, zero past hv's end (the
    JAX package's zero-HV padding)."""
    t = torch.from_numpy(np.ascontiguousarray(hv[lo : lo + rows])).to(device)
    if t.shape[0] == rows:
        return t
    return torch.cat([t, t.new_zeros((rows - t.shape[0],) + t.shape[1:])])


def _on_devices(devices, *arrays):
    """{device: tuple of tensors} with each array uploaded once a device."""
    with span("search_upload"):
        return {d: tuple(torch.from_numpy(np.ascontiguousarray(a)).to(d)
                         for a in arrays) for d in set(devices)}


def _query_mode(mode, devices, q_on):
    """(the call's mode, whether each DB tile is still to be reduced):
    resolve_mode over the queries on devices[0], in the span
    search_mode_scan. The tiles are reduced only where the mode was True
    (or None on a card) and the queries fit; an explicit mode is kept."""
    with span("search_mode_scan"):
        got = resolve_mode(mode, devices[0], q_on[devices[0]][0])
    return got, got == "small" and mode != "small"


def _tile_mode(mode, scan: bool, hv: torch.Tensor):
    """A tile's mode from its uploaded rows (_query_mode's scan), in the
    span search_mode_scan."""
    with span("search_mode_scan"):
        return resolve_mode(True, hv.device, hv) if scan else mode


def _fetch(*tensors) -> Tuple[np.ndarray, ...]:
    """The tensors as numpy arrays, in the span search_fetch."""
    with span("search_fetch"):
        return tuple(t.cpu().numpy() for t in tensors)


def _block_candidates(devices, db_hv, db_norm, lo: int, rows: int, q_on,
                      ksize: int, k_top: int, mode, scan: bool):
    """Top-k of rows [lo, lo + rows) of the DB (zero-padded past its end)
    split evenly over ``devices``; the sharded program of the JAX package
    (``_local_search``), each device's part in its own mode (_tile_mode).
    Returns tensors on devices[0] (ani, idx into db_hv, dot), each [N,
    k_top]."""
    rp = rows // len(devices)
    home = devices[0]
    vs, ids, ds = [], [], []
    for di, dev in enumerate(devices):
        q, qn = q_on[dev]
        with span("search_upload"):
            hv = _padded_rows(db_hv, lo + di * rp, rp, dev)
            norm = _padded_rows(db_norm, lo + di * rp, rp, dev)
        tmode = _tile_mode(mode, scan, hv)
        with span("search_dot_topk"):
            v, i, d = ani_topk(hv, norm, q, qn, ksize, min(k_top, rp), tmode)
            del hv
            pad = k_top - v.shape[1]
            if pad:  # shard smaller than k: -inf slots, local index 0
                v = torch.nn.functional.pad(v, (0, pad), value=float("-inf"))
                i = torch.nn.functional.pad(i, (0, pad))
                d = torch.nn.functional.pad(d, (0, pad))
            vs.append(v.to(home))
            ids.append((i + (lo + di * rp)).to(home))
            ds.append(d.to(home))
    with span("search_dot_topk"):
        return _merge(vs, ids, ds, k_top)


def _merge(vs, ids, ds, k_top: int):
    """Top-k over candidate lists concatenated in list order; among equal
    ANIs the earlier position wins (topk_desc)."""
    mv, mp = topk_desc(torch.cat(vs, dim=1), k_top)
    mi = torch.gather(torch.cat(ids, dim=1), 1, mp)
    md = torch.gather(torch.cat(ds, dim=1), 1, mp)
    return mv, mi, md


def _candidates(devices, db_hv, db_norm, end: int, q_on, ksize: int,
                k_top: int, mode, scan: bool, tile_rows=None):
    """Top-k of rows [0, end) of the DB (zero past its end; end a multiple
    of len(devices)), in row tiles of len(devices) * rp rows, each split
    evenly over the devices (_block_candidates) and merged on devices[0]
    after the running candidates. rp is ceil(tile_rows / ndev), by default
    the rows that keep a device's ANI tile within
    PAIRS_PER_DEVICE_TILE_LIMIT (at least 256), and at most end / ndev; the
    last tile stops at end. mode, scan: from _query_mode. Returns tensors
    on devices[0] (ani, idx into db_hv, dot), each [N, k_top]."""
    ndev, N = len(devices), q_on[devices[0]][0].shape[0]
    rp = (-(-tile_rows // ndev) if tile_rows else
          max(256, PAIRS_PER_DEVICE_TILE_LIMIT // max(N, 1)))
    step = ndev * max(1, min(end // ndev, rp))
    run = None
    for lo in range(0, end or 1, step):  # an empty DB gives its -inf slots
        tile = _block_candidates(devices, db_hv, db_norm, lo,
                                 min(step, end - lo), q_on, ksize, k_top,
                                 mode, scan)
        if run is None:
            run = tile
            continue
        with span("search_dot_topk"):
            run = _merge(*zip(run, tile), k_top)
    return run


def _mask_padding(ani, idx, dot, M: int):
    """Padded DB rows (index >= M) -> (-inf, 0, 0), in place."""
    bad = idx >= M
    ani[bad], idx[bad], dot[bad] = -np.inf, 0, 0
    return ani, idx, dot


def topk_search(
    devices: Sequence, db_hv: np.ndarray, db_norm: np.ndarray,
    q_hv: np.ndarray, q_norm: np.ndarray, ksize: int, k_top: int, mode=None,
    tile_rows=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Top-k ANI search of queries against the DB split over ``devices``
    (the module docstring's layout). tile_rows: the rows of a tile (None:
    from PAIRS_PER_DEVICE_TILE_LIMIT).

    Returns (ani [N, k_top] float32 device ANI, idx [N, k_top] int32 DB
    rows, dot [N, k_top] exact int32 dots of the winners, which the TSV
    feeds through the host float chain).
    """
    devs = [torch.device(d) for d in devices]
    M, ndev = db_hv.shape[0], len(devs)
    q_on = _on_devices(devs, q_hv, q_norm)
    cand = _candidates(devs, db_hv, db_norm, -(-M // ndev) * ndev, q_on,
                       ksize, k_top, *_query_mode(mode, devs, q_on),
                       tile_rows)
    return _mask_padding(*_fetch(*cand), M)


def multihost_topk_search(
    db, q_hv: np.ndarray, q_norm: np.ndarray, ksize: int, k_top: int,
    devices: Sequence, mode=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pod DB search: each process holds only its own devices' DB rows.

    db: an .hgdb directory (each process memory-maps only its rows with
    load_db_rows) or a ShardedDB every process has loaded. The global
    shards are the processes' device lists in rank order: process r owns
    the block of rows [r * block, min((r + 1) * block, M)) with block =
    n_local * ceil(M / (nproc * n_local)), zero-padded to block rows. Each
    process ranks its block in topk_search's row tiles, which stop at the
    block's end, so no padding row takes another process's index;
    all_gather brings every process's [N, k] candidates, merged rank-major
    and masked as the JAX package's multihost_topk_search. Ties keep
    ``jax.lax.top_k``'s rule (equal ANI: the lower global row first)
    through every merge: each stage lists the candidates of lower rows
    first among equal values, so the staged top-k picks and orders what
    one top-k over every row would. Each process decides its tiles' dot
    modes from its own rows and the queries on its cards; every mode is
    exact, so tiles and processes need not agree. Call after
    parallel.mesh's init; with one process it is topk_search. Returns
    (ani, idx, dot) [N, k_top], the same on every process.
    """
    from hypergen_tpu_torch.io.sketch_db import ShardedDB, load_db_rows
    from hypergen_tpu_torch.parallel import mesh

    devs = [torch.device(d) for d in devices]
    rank, nproc = mesh.process_index(), mesh.process_count()
    n_local = len(devs)
    if nproc > 1:
        counts = mesh.all_gather(torch.tensor([n_local]))
        if any(int(c) != n_local for c in counts):
            raise ValueError(f"pod search: device counts differ across "
                             f"processes: {[int(c) for c in counts]}")
    in_memory = isinstance(db, ShardedDB)
    M = len(db.names) if in_memory else json.loads(
        (Path(db) / "manifest.json").read_text())["n_genomes"]
    block = n_local * -(-M // (nproc * n_local))
    lo, hi = min(rank * block, M), min((rank + 1) * block, M)
    if in_memory:
        hv, norm = db.hvs[lo:hi], db.norms[lo:hi]
    else:
        part = load_db_rows(db, lo, hi)
        hv, norm = part.hvs, part.norms
    log.info("pod search: process %d/%d holds DB rows [%d, %d) of %d",
             rank, nproc, lo, hi, M)
    q_on = _on_devices(devs, q_hv, q_norm)
    v, i, d = _candidates(devs, hv, norm, block, q_on, ksize, k_top,
                          *_query_mode(mode, devs, q_on))
    i = i + rank * block
    if nproc > 1:
        with span("search_dot_topk"):
            v, i, d = _merge(*(mesh.all_gather(t) for t in (v, i, d)), k_top)
    if devs[0].type == "cuda":
        log.info("pod search: process %d/%d peak allocated %d B on %s",
                 rank, nproc, torch.cuda.max_memory_allocated(devs[0]),
                 devs[0])
    return _mask_padding(*_fetch(v, i, d), M)


def _exact_ani(ref_norms, query_db, ani: np.ndarray, idx: np.ndarray,
               dot: np.ndarray) -> np.ndarray:
    """Each winner's ANI from its exact dot by the host float chain (so the
    rows print as `dist` rows do); -inf slots (short shards) become NaN,
    which the writer drops."""
    from hypergen_tpu_torch.models.comparator import ani_host_pairs

    N, k_top = ani.shape
    exact = ani_host_pairs(
        dot.ravel().astype(np.int32),
        np.asarray(ref_norms)[idx.ravel()],
        np.repeat(np.asarray(query_db.norms), k_top),
        query_db.ksize,
    ).reshape(N, k_top)
    return np.where(np.isfinite(ani), exact, np.nan)


def write_search_tsv(out, ref_names, ref_norms: np.ndarray, query_db,
                     ani: np.ndarray, idx: np.ndarray, dot: np.ndarray,
                     threshold: float) -> int:
    """The search TSV from top-k winners (_exact_ani); returns the rows
    written."""
    from hypergen_tpu_torch.models.comparator import write_search_report

    return write_search_report(
        out, ref_names, query_db.names, idx,
        _exact_ani(ref_norms, query_db, ani, idx, dot), threshold)


def run_search_cli(args, load_db, devices: Sequence) -> None:
    """CLI glue for the `search` subcommand.

    Output rows are byte-consistent with `dist`: the `ref\\tquery\\tani`
    columns (reference:src/utils.rs:272-286), with each winner's ANI from
    the host chain on its exact dot (the device float chain only ranks).
    In a pod, every process searches its own DB rows on `devices` (its own
    card) through multihost_topk_search; an .hgdb reference is read only
    in those rows, a .sketch is loaded whole by each process. Process 0
    writes the TSV, the others only count its rows."""
    from hypergen_tpu_torch.models.comparator import count_search_hits
    from hypergen_tpu_torch.parallel import mesh

    t0 = time.monotonic()
    query_db = load_db(args.path_q)
    pod = mesh.process_count() > 1
    if pod and Path(args.path_r).is_dir():
        from hypergen_tpu_torch.io.sketch_db import load_db_norms

        manifest = json.loads((Path(args.path_r) / "manifest.json")
                              .read_text())
        if (manifest["ksize"] != query_db.ksize
                or manifest["hv_d"] != query_db.hv_d):
            raise SystemExit("ref/query sketch parameter mismatch")
        ref, M = args.path_r, manifest["n_genomes"]
        ref_names, ref_norms = manifest["names"], load_db_norms(args.path_r)
    else:
        ref = load_db(args.path_r)
        if ref.ksize != query_db.ksize or ref.hv_d != query_db.hv_d:
            raise SystemExit("ref/query sketch parameter mismatch")
        M, ref_names, ref_norms = ref.hvs.shape[0], ref.names, ref.norms
    N = query_db.hvs.shape[0]
    k_top = min(args.top_k, M)
    if pod:
        ani, idx, dot = multihost_topk_search(
            ref, query_db.hvs, query_db.norms, query_db.ksize, k_top, devices)
    else:
        ani, idx, dot = topk_search(devices, ref.hvs, ref.norms,
                                    query_db.hvs, query_db.norms, ref.ksize,
                                    k_top)
    with span("search_host_chain"):
        if mesh.process_index() == 0:
            n_hits = write_search_tsv(args.out, ref_names, ref_norms,
                                      query_db, ani, idx, dot, args.ani_th)
        else:  # the results are the same on every process
            n_hits = count_search_hits(
                _exact_ani(ref_norms, query_db, ani, idx, dot), args.ani_th)
    log.info(
        "Searched %d queries against %d refs (top-%d) in %.3fs -> %d hits%s",
        N, M, k_top, time.monotonic() - t0, n_hits,
        f" (process {mesh.process_index()}/{mesh.process_count()})" if pod
        else "",
    )
