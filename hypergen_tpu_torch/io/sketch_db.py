"""Sketch database serialization.

Two formats:

1. **Reference-compatible `.sketch`** — byte-identical to the reference's
   bincode serialization of `Vec<FileSketch>` (reference:src/utils.rs:234-258,
   struct layout reference:src/types.rs:224-235). bincode 1.x legacy config:
   little-endian, fixed-width ints, u64 length prefixes, bool as one byte,
   usize as u64. This keeps sketches interoperable with the reference CLI in
   both directions.

2. **Sharded DB + manifest** (`.hgdb/` directory) — the TPU-native layout for
   multi-host search: HVs stored as one dense int16 matrix per shard
   (row-major, mmap-friendly) with norms and metadata in a JSON manifest.
   The reference has no equivalent (its single-file DB is all-or-nothing,
   SURVEY §5 checkpoint/resume); shards enable resume and per-host loading.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import struct
from pathlib import Path
from typing import List, Optional

import numpy as np

from hypergen_tpu_torch.io.bitpack import compress_hv, unpack_hv
from hypergen_tpu_torch.utils.timing import span


@dataclasses.dataclass
class FileSketch:
    """One genome's sketch record (reference:src/types.rs:224-235)."""

    ksize: int
    scaled: int
    canonical: bool
    seed: int
    hv_d: int
    hv_quant_bits: int
    hv_norm_2: int
    file_str: str
    hv: np.ndarray  # int16; packed bytes reinterpreted as i16 when compressed

    def decompress(self) -> np.ndarray:
        """Unpack to the dense int16 HV (reference:src/hd.rs:184-212).

        hv_quant_bits == 0 marks an UNcompressed record (dense i16 stored
        as-is). The reference always compresses (`if_compressed` is
        hard-coded true, reference:src/utils.rs:200) and its bit widths are
        in [6, 16], so 0 is free as a marker and round-trips through the
        .sketch byte format; such files are ours-only, not reference-readable.
        """
        if self.hv_quant_bits == 0:
            if self.hv.shape[0] != self.hv_d:
                raise ValueError(
                    f"uncompressed sketch hv length {self.hv.shape[0]} != "
                    f"hv_d {self.hv_d}"
                )
            return np.asarray(self.hv, dtype=np.int16).copy()
        return unpack_hv(self.hv.tobytes(), self.hv_quant_bits, self.hv_d)

    @classmethod
    def from_dense(
        cls,
        hv_dense: np.ndarray,
        norm2: int,
        file_str: str,
        ksize: int,
        scaled: int,
        canonical: bool,
        seed: int,
    ) -> "FileSketch":
        packed, bits = compress_hv(hv_dense)
        hv_i16 = np.frombuffer(packed, dtype="<i2").copy()
        return cls(
            ksize=ksize,
            scaled=scaled,
            canonical=canonical,
            seed=seed,
            hv_d=int(hv_dense.shape[0]),
            hv_quant_bits=bits,
            hv_norm_2=int(norm2),
            file_str=file_str,
            hv=hv_i16,
        )


def dump_sketch(sketches: List[FileSketch], out_path) -> int:
    """Write reference-compatible .sketch bytes; returns file size."""
    parts = [struct.pack("<Q", len(sketches))]
    for s in sketches:
        name = s.file_str.encode("utf-8")
        parts.append(
            struct.pack(
                "<BQ?QQBi",
                s.ksize & 0xFF,
                s.scaled,
                bool(s.canonical),
                s.seed,
                s.hv_d,
                s.hv_quant_bits & 0xFF,
                _wrap_i32(s.hv_norm_2),
            )
        )
        parts.append(struct.pack("<Q", len(name)))
        parts.append(name)
        hv = np.asarray(s.hv, dtype="<i2")
        parts.append(struct.pack("<Q", hv.shape[0]))
        parts.append(hv.tobytes())
    blob = b"".join(parts)
    Path(out_path).write_bytes(blob)
    return len(blob)


def load_sketch(path) -> List[FileSketch]:
    """Read a reference-compatible .sketch file."""
    blob = Path(path).read_bytes()
    off = 0

    def take(n: int) -> bytes:
        nonlocal off
        if off + n > len(blob):
            raise ValueError(f"{path}: truncated sketch file at offset {off}")
        out = blob[off : off + n]
        off += n
        return out

    (count,) = struct.unpack("<Q", take(8))
    sketches: List[FileSketch] = []
    for _ in range(count):
        ksize, scaled, canonical, seed, hv_d, qbits, norm2 = struct.unpack(
            "<BQ?QQBi", take(31)
        )
        (name_len,) = struct.unpack("<Q", take(8))
        name = take(name_len).decode("utf-8")
        (hv_len,) = struct.unpack("<Q", take(8))
        hv = np.frombuffer(take(2 * hv_len), dtype="<i2").copy()
        sketches.append(
            FileSketch(ksize, scaled, canonical, seed, hv_d, qbits, norm2, name, hv)
        )
    return sketches


def _wrap_i32(x: int) -> int:
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x


# --- sharded TPU-native DB ---------------------------------------------------


def append_db_shard(out_dir, db: "ShardedDB") -> None:
    """Append new rows to an existing .hgdb as one extra shard.

    Resume path: the existing shard files are untouched (no reload/rewrite
    of potentially GTDB-scale data); only the new rows are written and the
    manifest is extended. New shard id = max existing + 1.
    """
    out = Path(out_dir)
    manifest = json.loads((out / "manifest.json").read_text())
    if not len(db.names):
        return
    sid = max((sh["id"] for sh in manifest["shards"]), default=-1) + 1
    row = manifest["n_genomes"]
    np.save(out / f"shard_{sid:05d}_hv.npy", db.hvs)
    np.save(out / f"shard_{sid:05d}_norm.npy", db.norms)
    manifest["shards"].append(
        {
            "id": sid,
            "rows": [row, row + len(db.names)],
            "hv": f"shard_{sid:05d}_hv.npy",
            "norm": f"shard_{sid:05d}_norm.npy",
        }
    )
    manifest["names"] = manifest["names"] + list(db.names)
    # keep resolved_names aligned. Backfilling a pre-field manifest's prefix
    # must NOT freeze this run's cwd as authoritative (resuming once from
    # the wrong directory would permanently poison future resumes): keep
    # relative names verbatim so they stay resolved at READ time, exactly
    # like the pre-field behavior; only already-absolute paths normalize.
    manifest["resolved_names"] = (
        manifest.get("resolved_names")
        or [
            str(Path(n).resolve()) if Path(n).is_absolute() else n
            for n in manifest["names"][: row]
        ]
    ) + _resolve_names(db.names)
    manifest["n_genomes"] = row + len(db.names)
    tmp = out / "manifest.json.tmp"
    tmp.write_text(json.dumps(manifest, indent=1))
    tmp.rename(out / "manifest.json")


def _resolve_names(names) -> List[str]:
    """Absolute-path resume keys, resolved in the cwd of the run that
    RECORDED the names — stored in the manifest so a later --resume run
    from a different cwd still matches relative input paths correctly."""
    return [str(Path(n).resolve()) for n in names]


@dataclasses.dataclass
class ShardedDB:
    """Dense sketch DB: HVs as an int16 [n, hv_d] matrix per shard."""

    ksize: int
    scaled: int
    canonical: bool
    seed: int
    hv_d: int
    names: List[str]
    hvs: np.ndarray  # int16 [n, hv_d]
    norms: np.ndarray  # int32 [n]
    # hash method used at sketch time; the reference's .sketch format has no
    # such field (FileSketch, reference:src/types.rs:224-235), but the .hgdb
    # manifest records it so resume/dist can reject mixed-method DBs
    sketch_method: str = "t1ha2"


def dump_sharded_db(db: ShardedDB, out_dir, n_shards: int = 1) -> None:
    """Write an .hgdb directory: manifest.json + per-shard .npy files (the
    span ``db_save``)."""
    out = Path(out_dir)
    with span("db_save"):
        out.mkdir(parents=True, exist_ok=True)
        n = len(db.names)
        bounds = [round(i * n / n_shards) for i in range(n_shards + 1)]
        shards = []
        for i in range(n_shards):
            a, b = bounds[i], bounds[i + 1]
            np.save(out / f"shard_{i:05d}_hv.npy", db.hvs[a:b])
            np.save(out / f"shard_{i:05d}_norm.npy", db.norms[a:b])
            shards.append(
                {
                    "id": i,
                    "rows": [a, b],
                    "hv": f"shard_{i:05d}_hv.npy",
                    "norm": f"shard_{i:05d}_norm.npy",
                }
            )
        manifest = {
            "format": "hgdb-v1",
            "ksize": db.ksize,
            "scaled": db.scaled,
            "canonical": db.canonical,
            "seed": db.seed,
            "hv_d": db.hv_d,
            "sketch_method": db.sketch_method,
            "n_genomes": n,
            "names": db.names,
            "resolved_names": _resolve_names(db.names),
            "shards": shards,
        }
        (out / "manifest.json").write_text(json.dumps(manifest, indent=1))


def _read_npy_into(path: Path, out: np.ndarray) -> bool:
    """Read a ``.npy`` file's payload straight into ``out`` (C-contiguous).

    Returns False, having read no payload, where the file's header is not
    the one ``np.save`` writes for an array of ``out``'s shape and dtype in
    C order (header version 1.0 or 2.0). Raises ValueError naming the file
    where the payload is shorter than the header says.
    """
    with open(path, "rb") as f:
        try:
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                header = np.lib.format.read_array_header_1_0(f)
            elif version == (2, 0):
                header = np.lib.format.read_array_header_2_0(f)
            else:
                return False
        except ValueError:
            return False
        if header != (out.shape, False, out.dtype):
            return False
        got = f.readinto(out.reshape(-1).view(np.uint8))
    if got != out.nbytes:
        raise ValueError(
            f"{path}: truncated .npy payload, {got} of {out.nbytes} bytes")
    return True


def load_sharded_db(path, shard_ids: Optional[List[int]] = None) -> ShardedDB:
    """Load all (or selected) shards of an .hgdb directory in global row
    order, in the spans ``db_load_manifest`` (manifest.json, the names and
    each shard's row offset), ``db_load_assemble`` (one HV and one norm
    array for all the selected rows) and ``db_load_read`` (each shard's
    ``.npy`` payload read straight into its rows of those arrays).

    A shard whose header is not the one ``dump_sharded_db`` and
    ``append_db_shard`` write (``<i2`` HVs of shape ``(rows, hv_d)``,
    ``<i4`` norms of shape ``(rows,)``, C order, header version 1.0 or 2.0)
    sends the whole load to ``np.load`` and ``np.concatenate`` in the span
    ``db_load_fallback``, which returns the files' arrays as they are."""
    root = Path(path)
    with span("db_load_manifest"):
        manifest = json.loads((root / "manifest.json").read_text())
        # names are derived from each shard's row range, so any order is
        # internally consistent — but global row order keeps DB row indices
        # stable across loaders (load_db_rows/load_db_norms sort the same way)
        shards = sorted(manifest["shards"], key=lambda sh: sh["rows"][0])
        if shard_ids is not None:
            shards = [s for s in shards if s["id"] in set(shard_ids)]
        rows = [r for s in shards for r in range(s["rows"][0], s["rows"][1])]
        names = [manifest["names"][r] for r in rows]
        hv_d = manifest["hv_d"]
        # each selected shard's first row in the arrays loaded (not its
        # global row: a subset packs its shards together)
        bounds = list(itertools.accumulate(
            (s["rows"][1] - s["rows"][0] for s in shards), initial=0))
    with span("db_load_assemble"):
        hvs = np.empty((bounds[-1], hv_d), np.int16)
        norms = np.empty((bounds[-1],), np.int32)
    with span("db_load_read"):
        in_place = all(
            _read_npy_into(root / s["hv"], hvs[a:b])
            and _read_npy_into(root / s["norm"], norms[a:b])
            for s, a, b in zip(shards, bounds[:-1], bounds[1:]))
    if not in_place:
        with span("db_load_fallback"):
            hvs = np.concatenate([np.load(root / s["hv"]) for s in shards])
            norms = np.concatenate([np.load(root / s["norm"]) for s in shards])
    return ShardedDB(
        ksize=manifest["ksize"],
        scaled=manifest["scaled"],
        canonical=manifest["canonical"],
        seed=manifest["seed"],
        hv_d=manifest["hv_d"],
        names=names,
        hvs=hvs,
        norms=norms,
        sketch_method=manifest.get("sketch_method", "t1ha2"),
    )


def sketches_to_db(sketches: List[FileSketch]) -> ShardedDB:
    """Decompress a .sketch list into the dense DB layout (the span
    ``db_decompress``)."""
    if not sketches:
        raise ValueError("empty sketch list")
    s0 = sketches[0]
    with span("db_decompress"):
        hvs = np.stack([s.decompress() for s in sketches])
    return ShardedDB(
        ksize=s0.ksize,
        scaled=s0.scaled,
        canonical=s0.canonical,
        seed=s0.seed,
        hv_d=s0.hv_d,
        names=[s.file_str for s in sketches],
        hvs=hvs,
        norms=np.array([s.hv_norm_2 for s in sketches], dtype=np.int32),
    )


def hv_value_histogram(sketches: List[FileSketch]) -> dict:
    """value -> count histogram over all decompressed HV entries.

    Debug/analysis utility mirroring the reference's distribution dump
    (reference:src/utils.rs:312-337); used to eyeball the HV entry
    distribution when tuning quantization bit-widths.
    """
    hist: dict = {}
    for s in sketches:
        vals, counts = np.unique(s.decompress(), return_counts=True)
        for v, c in zip(vals.tolist(), counts.tolist()):
            hist[int(v)] = hist.get(int(v), 0) + int(c)
    return hist


def hv_value_histogram_sharded(db_dir) -> dict:
    """value -> count histogram over an .hgdb, one memory-mapped shard at a
    time — a GTDB-scale DB never fully materializes on host."""
    db_dir = Path(db_dir)
    manifest = json.loads((db_dir / "manifest.json").read_text())
    hist: dict = {}
    for sh in manifest["shards"]:
        hvs = np.load(db_dir / sh["hv"], mmap_mode="r")
        vals, counts = np.unique(hvs, return_counts=True)
        for v, c in zip(vals.tolist(), counts.tolist()):
            hist[int(v)] = hist.get(int(v), 0) + int(c)
    return hist


def load_db_rows(path, lo: int, hi: int) -> ShardedDB:
    """Load only global rows [lo, hi) of an .hgdb (multi-host shard loading).

    Each host of a pod loads just the rows its local devices own; shard
    .npy files are memory-mapped so only the overlapping slices touch disk.
    """
    root = Path(path)
    manifest = json.loads((root / "manifest.json").read_text())
    hvs = []
    norms = []
    # rows pair with names[lo:hi] positionally: iterate in global row
    # order, not manifest list order (load_db_norms does the same)
    for s in sorted(manifest["shards"], key=lambda sh: sh["rows"][0]):
        a, b = s["rows"]
        sl_lo, sl_hi = max(lo, a), min(hi, b)
        if sl_lo >= sl_hi:
            continue
        hv = np.load(root / s["hv"], mmap_mode="r")
        nm = np.load(root / s["norm"], mmap_mode="r")
        hvs.append(np.asarray(hv[sl_lo - a : sl_hi - a]))
        norms.append(np.asarray(nm[sl_lo - a : sl_hi - a]))
    hv_d = manifest["hv_d"]
    return ShardedDB(
        ksize=manifest["ksize"],
        scaled=manifest["scaled"],
        canonical=manifest["canonical"],
        seed=manifest["seed"],
        hv_d=hv_d,
        names=manifest["names"][lo:hi],
        hvs=np.concatenate(hvs) if hvs else np.zeros((0, hv_d), np.int16),
        norms=np.concatenate(norms) if norms else np.zeros((0,), np.int32),
        sketch_method=manifest.get("sketch_method", "t1ha2"),
    )


def load_db_norms(path) -> np.ndarray:
    """All L2-norm² values of an .hgdb as one [M] int32 array.

    Norms are 4 bytes/genome — tiny next to the HVs — so loading them all
    is fine even at GTDB scale (search uses them to recompute exact
    host-chain ANI for the top-k winners)."""
    root = Path(path)
    manifest = json.loads((root / "manifest.json").read_text())
    shards = sorted(manifest["shards"], key=lambda sh: sh["rows"][0])
    parts = [np.load(root / sh["norm"]) for sh in shards]
    return (
        np.concatenate(parts) if parts else np.zeros(0, np.int32)
    ).astype(np.int32, copy=False)


def dump_db_shard_part(
    db: ShardedDB, out_dir, part_id: int, n_parts: int, token: str = "",
    shard_id: int | None = None,
) -> None:
    """Write one host's DB rows as a shard + part-manifest (pod sketching).

    Every process of a multi-host sketch run writes its own rows; when all
    parts are on the shared filesystem, merge_db_parts assembles the final
    manifest. Part files are self-describing so a crashed run can be
    resumed/merged later.
    """
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    sid = part_id if shard_id is None else shard_id
    np.save(out / f"shard_{sid:05d}_hv.npy", db.hvs)
    np.save(out / f"shard_{sid:05d}_norm.npy", db.norms)
    part = {
        "part": part_id,
        "shard_id": sid,
        "n_parts": n_parts,
        "ksize": db.ksize,
        "scaled": db.scaled,
        "canonical": db.canonical,
        "seed": db.seed,
        "hv_d": db.hv_d,
        "sketch_method": db.sketch_method,
        "names": db.names,
        "resolved_names": _resolve_names(db.names),
        "n_rows": len(db.names),
    }
    name = f"manifest.part{part_id:05d}.{token}.json" if token else \
        f"manifest.part{part_id:05d}.json"
    tmp = out / (name + ".tmp")
    tmp.write_text(json.dumps(part))
    tmp.rename(out / name)  # atomic publish


def merge_db_parts(out_dir, n_parts: int, timeout_s: Optional[float] = None,
                   token: str = "", base_manifest: Optional[dict] = None) -> None:
    """Wait for all part manifests, then write the merged manifest.json.

    Called by process 0 after dump_db_shard_part; parts become shards in
    part order, global row ranges assigned by concatenation. When a run
    token is given, only parts published with the SAME token are accepted —
    stale parts from a previous crashed run in the same directory are
    ignored (and cleaned up after the merge). base_manifest (pod resume)
    keeps an existing DB's shards and names as the prefix; new parts must
    have been written with non-colliding shard_ids.
    """
    out = Path(out_dir)
    if token:
        paths = [
            out / f"manifest.part{p:05d}.{token}.json" for p in range(n_parts)
        ]
    else:
        paths = [out / f"manifest.part{p:05d}.json" for p in range(n_parts)]
    wait_for_part_files(paths, timeout_s)
    parts = [json.loads(p.read_text()) for p in paths]
    names: List[str] = []
    resolved: List[str] = []
    shards = []
    row = 0
    if base_manifest is not None:
        shards = [dict(sh) for sh in base_manifest["shards"]]
        names = list(base_manifest["names"])
        resolved = list(
            base_manifest.get("resolved_names") or _resolve_names(names)
        )
        row = base_manifest["n_genomes"]
    for part in parts:
        n = part["n_rows"]
        sid = part.get("shard_id", part["part"])
        shards.append(
            {
                "id": sid,
                "rows": [row, row + n],
                "hv": f"shard_{sid:05d}_hv.npy",
                "norm": f"shard_{sid:05d}_norm.npy",
            }
        )
        names.extend(part["names"])
        resolved.extend(
            part.get("resolved_names") or _resolve_names(part["names"])
        )
        row += n
    p0 = parts[0]
    manifest = {
        "format": "hgdb-v1",
        "ksize": p0["ksize"],
        "scaled": p0["scaled"],
        "canonical": p0["canonical"],
        "seed": p0["seed"],
        "hv_d": p0["hv_d"],
        "sketch_method": p0.get("sketch_method", "t1ha2"),
        "n_genomes": row,
        "names": names,
        "resolved_names": resolved,
        "shards": shards,
    }
    (out / "manifest.json").write_text(json.dumps(manifest, indent=1))
    for p_ in paths:  # tidy this run's part manifests (merged above)
        p_.unlink(missing_ok=True)


def wait_for_part_files(
    paths,
    timeout_s: Optional[float] = None,
    stall_s: Optional[float] = None,
) -> None:
    """Poll a shared filesystem until every part file exists (pod merges).

    Default is to wait with no *total* ceiling (peer hosts of a pod run can
    lag hours behind on large workloads; a short timeout would discard the
    whole run's compute), but fail on *stall*: if no new part appears for
    stall_s (HG_PART_STALL_S, default 24 h) a peer host has almost certainly
    crashed and the merge raises instead of hanging unattended forever. The
    default is deliberately far beyond any legitimate single-part gap — a
    merge waiting on ONE part has no progress events to reset the clock, so
    a tight default would abort healthy long-tail runs; tune HG_PART_STALL_S
    down for fail-fast behavior on small workloads.
    Missing parts are logged every 60 s so a stuck merge stays visible.
    Set HG_PART_TIMEOUT_S (or pass timeout_s) to also bound total wait.
    """
    import logging as _logging
    import os as _os
    import time as _time

    if timeout_s is None:
        env = _os.environ.get("HG_PART_TIMEOUT_S", "")
        timeout_s = float(env) if env else float("inf")
    if stall_s is None:
        env = _os.environ.get("HG_PART_STALL_S", "")
        stall_s = float(env) if env else 24 * 3600.0
    log_ = _logging.getLogger("hypergen")
    start = _time.monotonic()
    next_report = start + 60.0
    last_progress = start
    n_done_prev = -1
    while True:
        n_done = sum(1 for p in paths if p.exists())
        if n_done == len(paths):
            return
        now = _time.monotonic()
        if n_done != n_done_prev:
            n_done_prev = n_done
            last_progress = now
        missing = [str(p) for p in paths if not p.exists()]
        if now - start > timeout_s:
            raise TimeoutError(f"missing parts: {missing}")
        if now - last_progress > stall_s:
            raise TimeoutError(
                f"no new pod part for {now - last_progress:.0f}s "
                f"(peer host crashed?); missing parts: {missing}"
            )
        if now >= next_report:
            log_.info(
                "waiting for %d/%d pod part files (%.0fs elapsed)",
                len(missing), len(paths), now - start,
            )
            next_report = now + 60.0
        _time.sleep(0.2)
