#!/usr/bin/env python3
"""Smoke test of the PyTorch port (hypergen_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card and the
CUDA toolkit. It builds the hand-written kernels K1 and K2 and the native
FASTA parser from csrc/, checks each kernel bit for bit against its plain
PyTorch version and times both, drives `sketch` and `dist` through the
port's CLI on 16 synthetic 4.19 Mbp genomes, and checks the card's output
files against the port's CPU run byte for byte. Then it drives the
huge-genome path on a synthetic 134 Mbp (2^27 bp) plant-scale genome: the
CLI's routing, sequence parallelism over one and four shards, the tiled
route and the one-row batch, which must agree, and it checks the
sequence-parallel and tiled routes on the card against the CPU. Every
phase prints one line; any failure raises and exits non-zero before the
last line. The last two lines are the kernel table and the result, each
one JSON object.
"""

from __future__ import annotations

import gzip
import json
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

GENOME_BP = 1 << 22  # one bacterial genome (BASELINE.md): 4,194,304 bp
SEED = 20261016
RATES = (0.005, 0.01, 0.02, 0.05)  # point-mutation rates of family copies
CHUNK, CELLS = 1 << 17, 2048  # production chunk positions and K1 cells
PROD_CAP = 4  # Sketcher.cell_cap at scaled=1500: max(4, ceil(8*64/1500))
K1_CONFIGS = [
    # (label, B, n_chunks, k, method, canonical, scaled, cap)
    ("production", 8, 32, 21, "t1ha2", True, 1500, PROD_CAP),
    ("k15", 2, 8, 15, "t1ha2", True, 1500, PROD_CAP),
    ("k31", 2, 8, 31, "t1ha2", True, 1500, PROD_CAP),
    ("k32", 2, 8, 32, "t1ha2", True, 1500, PROD_CAP),
    ("mmhash", 2, 8, 21, "mmhash", True, 1500, PROD_CAP),
    ("noncanonical", 2, 8, 21, "t1ha2", False, 1500, PROD_CAP),
    ("cap_overflow", 2, 8, 21, "t1ha2", True, 50, 1),
]
K2_CONFIGS = [
    # (label, k, method, canonical, scaled)
    ("production", 21, "t1ha2", True, 1500),
    ("k15", 15, "t1ha2", True, 1500),
    ("k31", 31, "t1ha2", True, 1500),
    ("k32", 32, "t1ha2", True, 1500),
    ("mmhash", 21, "mmhash", True, 1500),
    ("noncanonical", 21, "t1ha2", False, 1500),
    ("scaled1", 21, "t1ha2", True, 1),
]
K2_CHUNKS = 32
# the huge-genome route whose K2 launches the kernel table reports: it runs
# on one card and on several alike
K2_ROUTE = "seqpar on [cuda:0] x 4"
HUGE_BP = 1 << 27  # 134,217,728 bp: between A. thaliana and rice
HUGE_N_RUNS = 200
MID_BP = 3_000_000  # card-vs-CPU genome for the huge-genome routes
DEVICE = "cuda"
SOURCE = "hypergen_tpu_torch/csrc/hash_kernel.cu"
K1_REPLACES = "hypergen_tpu/ops/pallas/hash_kernel.py:219"
K2_REPLACES = "hypergen_tpu/ops/pallas/hash_kernel.py:158"
# Bounds, from NVIDIA's H100 SXM data sheet: 3.35 TB/s of HBM; integer
# multiply-adds at 64 INT32 lanes per SM, half the 128 FP32 lanes behind the
# 67 TFLOP/s float32 rate (two flops per FMA): 67e12 / 4 per second.
HBM_BYTES_PER_S = 3.35e12
INT32_MAD_PER_S = 67e12 / 4


def phase(n: int, msg: str) -> None:
    print(f"[phase {n}] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


# -- phase 3/4 inputs ---------------------------------------------------------

def random_rows(torch, rng, B, n_chunks, C, short_by):
    """Random packed words with each row's genome ending short of the row
    (all-'A' zero words past its end) and the matching n_pos."""
    import numpy as np

    from hypergen_tpu_torch.models.sketcher import packed_row_words

    W = packed_row_words(n_chunks, C)
    words = rng.integers(0, 2**32, size=(B, W), dtype=np.uint64).astype(
        np.uint32)
    n_pos = np.array([n_chunks * C - short_by * (b + 1) for b in range(B)],
                     np.int32)
    for b in range(B):
        words[b, (int(n_pos[b]) + 20) // 16 + 1 :] = 0
    return (torch.from_numpy(words.view(np.int32)).cuda(),
            torch.from_numpy(n_pos).cuda())


def max_abs_err(torch, a, b) -> int:
    """Largest integer difference over all outputs; int64 hashes compare
    as their two 32-bit halves so that no difference can overflow."""
    worst = 0
    for x, y in zip(a, b):
        x, y = x.to(torch.int64), y.to(torch.int64)
        for part in ((x >> 32, y >> 32), (x & 0xFFFFFFFF, y & 0xFFFFFFFF)):
            worst = max(worst, int((part[0] - part[1]).abs().max()))
    return worst


def t1ha2_mads(k: int) -> int:
    """32-bit integer multiply-adds of one t1ha2 hash of a k-mer, from
    hash_window in csrc/hash_kernel.cu: NW = ceil(k/8) mixups (a low and a
    high 64-bit product each) and the final mix (three low products and one
    high); a low 64x64 product is 3 IMADs, a high one about 8."""
    nw = (k + 7) // 8
    return 3 * (nw + 3) + 8 * (nw + 1)


def bound(n_bytes: int, n_mads: int):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    multiply-adds over the INT32 rate."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_mads / INT32_MAD_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def time_ms(torch, fn, runs: int = 12, warmup: int = 2) -> float:
    """Median milliseconds of fn() over `runs` timed calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# -- phase 5/6 genomes --------------------------------------------------------

def fasta(records, width: int = 80) -> bytes:
    out = []
    for name, seq in records:
        out.append(b">" + name + b"\n")
        out.extend(seq[i : i + width] + b"\n" for i in range(0, len(seq), width))
    return b"".join(out)


def write_genomes(d: Path):
    """16 genomes of 4,194,304 bp: three families of a base plus copies
    mutated at RATES, and one unrelated genome with 600 N runs. Returns
    {path: (family, rate)}."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    genomes = {}
    for fam in range(3):
        base = rng.integers(0, 4, size=GENOME_BP).astype(np.uint8)
        for rate in (0.0,) + RATES:
            codes = base.copy()
            hit = rng.random(GENOME_BP) < rate
            codes[hit] = (codes[hit] + rng.integers(1, 4, size=int(hit.sum()),
                                                    dtype=np.uint8)) % 4
            seq = acgt[codes]
            if fam == 1:  # interior N runs, shared by the family
                for s in range(100_000, GENOME_BP, 400_000):
                    seq[s : s + 1 + s % 997] = ord("N")
            if fam == 0 and rate == RATES[0]:  # a soft-masked stretch
                seq[200_000:300_000] += 32
            seq = seq.tobytes()
            name = f"fam{fam}_r{int(rate * 1000):03d}"
            if fam == 2 and rate == RATES[1]:  # three records
                recs = [(b"c1", seq[:1_000_000]), (b"c2", seq[1_000_000:3_000_000]),
                        (b"c3", seq[3_000_000:])]
            else:
                recs = [(name.encode() + b" synthetic", seq)]
            if fam == 1 and rate == RATES[2]:
                path = d / f"{name}.fna.gz"
                with gzip.open(path, "wb", compresslevel=1) as fh:
                    fh.write(fasta(recs))
            else:
                path = d / f"{name}.fna"
                path.write_bytes(fasta(recs))
            genomes[str(path)] = (fam, rate)
    seq = acgt[rng.integers(0, 4, size=GENOME_BP)]
    for s in rng.choice(GENOME_BP - 50, size=600, replace=False):
        seq[s : s + 1 + s % 40] = ord("N")
    path = d / "lone_nruns.fna"
    path.write_bytes(fasta([(b"lone", seq.tobytes())]))
    genomes[str(path)] = (3, 0.0)
    return genomes


def read_tsv(path: Path):
    """{frozenset((ref, query)): ANI} of a dist TSV."""
    rows = {}
    for line in path.read_text().splitlines():
        a, b, v = line.split("\t")
        rows[frozenset((a, b))] = float(v)
    return rows


def run_cli(argv) -> float:
    from hypergen_tpu_torch.cli import main

    t0 = time.monotonic()
    main(argv)
    return time.monotonic() - t0


def kernel_vs_plain(torch):
    """Phase 3: K1 against its plain version on the card, bit for bit
    (tolerance 0), in every configuration of K1_CONFIGS. Returns (largest
    difference, the production configuration's arguments)."""
    import numpy as np

    from hypergen_tpu_torch import SketchParams
    from hypergen_tpu_torch.ops.kernels.hash_kernel import (
        hash_packed_rows, hash_packed_rows_plain,
    )

    rng = np.random.default_rng(SEED)
    hash_packed_rows.launches = 0
    worst, prod = 0, None
    for label, B, nc, k, method, canonical, scaled, cap in K1_CONFIGS:
        words, n_pos = random_rows(torch, rng, B, nc, CHUNK, short_by=1000)
        args = (words, n_pos, nc, CHUNK, k, 123,
                SketchParams(scaled=scaled).threshold)
        kw = dict(canonical=canonical, method=method, cells=CELLS, cap=cap)
        got = hash_packed_rows(*args, **kw)
        want = hash_packed_rows_plain(*args, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        cell_max = int(got[3].max())
        check(same and err == 0, f"K1 {label}: kernel != plain (err {err})")
        check((cell_max > cap) == (label == "cap_overflow"),
              f"K1 {label}: unexpected cell_max {cell_max} for cap {cap}")
        worst = max(worst, err)
        prod = prod or (args, kw)
        phase(3, f"K1 {label}: B={B} chunks={nc} k={k} {method} "
                 f"canonical={canonical} cap={cap} cell_max={cell_max} "
                 f"survivors={int(got[2].sum())}: bit-identical")
    check(hash_packed_rows.launches == len(K1_CONFIGS), "launch counter")
    return worst, prod


def main_path(torch, tmp: Path):
    """Phase 5: sketch + dist of 16 genomes through the CLI on the card.
    Returns (genomes, K1 launches of the run)."""
    from hypergen_tpu_torch.ops.kernels.hash_kernel import hash_packed_rows

    gdir = tmp / "genomes"
    gdir.mkdir()
    genomes = write_genomes(gdir)
    db, tsv = tmp / "db.sketch", tmp / "ani.tsv"
    hash_packed_rows.launches = 0
    sketch_s = run_cli(["sketch", "-p", str(gdir), "-o", str(db),
                        "-D", DEVICE])
    dist_s = run_cli(["dist", "-r", str(db), "-q", str(db), "-o", str(tsv),
                      "-a", "85", "-D", DEVICE])
    launches = hash_packed_rows.launches
    check(launches > 0, "the main path launched no K1 kernel")
    rows = read_tsv(tsv)
    n = len(genomes)
    pairs = n * (n - 1) // 2
    fams = {}
    for path, (fam, rate) in genomes.items():
        fams.setdefault(fam, {})[rate] = path
    for fam, members in sorted(fams.items()):
        if len(members) == 1:
            continue
        names = sorted(members.values())
        for i, a in enumerate(names):
            for b in names[i + 1 :]:
                check(frozenset((a, b)) in rows,
                      f"family pair {a} {b} not reported")
        anis = [rows[frozenset((members[0.0], members[r]))] for r in RATES]
        check(all(x > y for x, y in zip(anis, anis[1:])),
              f"family {fam}: ANI does not fall with mutation rate: {anis}")
        phase(5, f"family {fam}: ANI to its base at rates {RATES}: {anis}")
    cross = [(sorted(ab), v) for ab, v in rows.items()
             if len({genomes[g][0] for g in ab}) > 1]
    check(not cross, f"cross-family pairs above 85: {cross}")
    phase(5, f"sketch {n} x {GENOME_BP} bp in {sketch_s:.3f} s "
             f"({n / sketch_s:.3f} genomes/s); dist {pairs} pairs in "
             f"{dist_s:.3f} s ({pairs / dist_s:.1f} pairs/s); "
             f"{len(rows)} pairs >= 85; K1 launches {launches}")
    return genomes, launches


def card_vs_cpu(tmp: Path, genomes) -> None:
    """Phase 6: the CLI on the card and with -D cpu give the same bytes, on
    one full genome with two short ones, and on one batch at scaled=50
    that climbs the cell-cap ladder."""
    from hypergen_tpu_torch.ops.kernels.hash_kernel import hash_packed_rows

    sub = tmp / "subset"
    sub.mkdir()
    paths = sorted(genomes)
    full = Path(next(p for p in paths if p.endswith("fam1_r000.fna")))
    (sub / "full.fna").write_bytes(full.read_bytes())
    for i, p in enumerate(paths[:2]):
        (sub / f"short{i}.fna").write_bytes(
            Path(p).read_bytes()[: 150_000 + 90_000 * i] + b"\n")
    # one batch (both genomes in one bucket) whose tandem repeat holds a
    # k-mer under the scaled=50 threshold 16 times in every 64-position
    # cell, past the initial 11 slots
    ladder = tmp / "ladder"
    ladder.mkdir()
    seq = bytearray(Path(paths[3]).read_bytes()[:300_000])
    seq[100_000:120_000] = b"AACC" * 5000
    (ladder / "repeat.fna").write_bytes(bytes(seq) + b"\n")
    (ladder / "plain.fna").write_bytes(full.read_bytes()[:280_000] + b"\n")
    for d, extra in ((sub, []), (ladder, ["-s", "50"])):
        for dev in (DEVICE, "cpu"):
            hash_packed_rows.launches = 0
            run_cli(["sketch", "-p", str(d), "-o", str(d / f"{dev}.sketch"),
                     "-D", dev, *extra])
            if dev == DEVICE and d is ladder:
                # one batch: a second launch is the cell-cap ladder
                check(hash_packed_rows.launches >= 2,
                      "scaled=50 batch did not climb the cell-cap ladder")
            for a in ("85", "0"):
                run_cli(["dist", "-r", str(d / f"{dev}.sketch"), "-q",
                         str(d / f"{dev}.sketch"), "-o",
                         str(d / f"{dev}_{a}.tsv"), "-a", a, "-D", dev])
        for name in ("{}.sketch", "{}_85.tsv", "{}_0.tsv"):
            a = (d / name.format(DEVICE)).read_bytes()
            b = (d / name.format("cpu")).read_bytes()
            check(a == b, f"{d.name}: {name.format('*')} differs, card vs CPU")
        phase(6, f"{d.name} {' '.join(extra) or 'defaults'}: .sketch and "
                 f"TSVs byte-identical, card vs CPU")


# -- phase 7/8: K2 ------------------------------------------------------------

def k2_base(rng):
    """Flat codes for K2_CHUNKS - 1 chunks plus the largest halo, with N runs
    across every chunk boundary and across K2's 64-position cells. Chunked
    into K2_CHUNKS chunks, the last one is all padding (invalid)."""
    import numpy as np

    n = (K2_CHUNKS - 1) * CHUNK + 31
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    for c in range(1, K2_CHUNKS - 1):
        codes[c * CHUNK - 7 : c * CHUNK + 5 + c % 13] = 4
    for s in rng.choice(n // 64 - 2, size=400, replace=False):
        s = int(s) * 64 + 60  # 4 codes before a cell boundary
        codes[s : s + 3 + s % 50] = 4
    return codes


def k2_vs_plain(torch):
    """Phase 7: K2 against its plain version on the card, bit for bit
    (tolerance 0): every hash, the U64_MAX sentinel included, and every keep
    flag, in every configuration of K2_CONFIGS. Returns (largest
    difference, the production configuration's arguments)."""
    import numpy as np

    from hypergen_tpu_torch import SketchParams
    from hypergen_tpu_torch.ops.kernels.hash_kernel import (
        hash_chunks, hash_chunks_plain,
    )
    from hypergen_tpu_torch.parallel.seqpar import _chunk_codes

    base = k2_base(np.random.default_rng(SEED + 2))
    hash_chunks.launches = 0
    worst, prod = 0, None
    for label, k, method, canonical, scaled in K2_CONFIGS:
        chunks = _chunk_codes(base[: (K2_CHUNKS - 1) * CHUNK + k - 1], k,
                              CHUNK, K2_CHUNKS)
        # the last chunk is padding: all its windows hold an invalid code
        check(chunks.shape == (K2_CHUNKS, CHUNK + k - 1)
              and bool((chunks[-1, k - 1 :] >= 4).all()), "K2 input geometry")
        args = (torch.from_numpy(chunks).cuda(), k, 123,
                SketchParams(scaled=scaled).threshold)
        kw = dict(canonical=canonical, method=method)
        got = hash_chunks(*args, **kw)
        want = hash_chunks_plain(*args, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        check(same and err == 0, f"K2 {label}: kernel != plain (err {err})")
        h, keep = got
        kept = int(keep.sum())
        check(kept > 0 and not bool(keep[-1].any())
              and bool((h[~keep] == -1).all()),
              f"K2 {label}: keep flags or sentinels wrong")
        worst = max(worst, err)
        prod = prod or (args, kw)
        phase(7, f"K2 {label}: {K2_CHUNKS} chunks x {CHUNK} k={k} {method} "
                 f"canonical={canonical} scaled={scaled} kept={kept}: "
                 f"bit-identical")
    check(hash_chunks.launches == len(K2_CONFIGS), "K2 launch counter")
    return worst, prod


def k2_work(torch, codes, k):
    """(bytes, multiply-adds) K2 needs on these chunks at t1ha2: codes read
    once, hashes and keep flags written once, one hash per window whose k
    codes are valid (the kernel hashes no other)."""
    nc, width = codes.shape
    C = width - k + 1
    inv = torch.nn.functional.pad((codes >= 4).to(torch.int32), (1, 0))
    cs = torch.cumsum(inv, dim=1, dtype=torch.int32)
    hashed = int(((cs[:, k:] - cs[:, :C]) == 0).sum())
    return codes.numel() + nc * C * 9, hashed * t1ha2_mads(k)


# -- phase 9/10: the huge-genome path -----------------------------------------

def write_genome(path: Path, bp: int, seed: int, n_runs: int) -> None:
    """A synthetic genome of `bp` bases in three records, with n_runs N runs
    of 1-4000 bp and a lowercase (soft-masked) stretch."""
    import numpy as np

    rng = np.random.default_rng(seed)
    seq = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, size=bp, dtype=np.uint8)]
    for s in rng.choice(bp - 5000, size=n_runs, replace=False):
        seq[s : s + 1 + s % 4000] = ord("N")
    seq[bp // 10 : bp // 10 + bp // 64] += 32
    seq = seq.tobytes()
    cuts = [0, bp * 3 // 10, bp * 7 // 10, bp]
    path.write_bytes(fasta([(b"chr%d synthetic" % (i + 1),
                             seq[cuts[i] : cuts[i + 1]]) for i in range(3)]))


def k2_full_vs_plain(torch, label, chunks, args) -> int:
    """K2 against its plain version, bit for bit, on chunks at a shape of
    the huge-genome path. Returns the largest difference."""
    from hypergen_tpu_torch.ops.kernels.hash_kernel import (
        hash_chunks, hash_chunks_plain,
    )

    got = hash_chunks(chunks, *args)
    want = hash_chunks_plain(chunks, *args)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    check(same and err == 0, f"K2 {label}: kernel != plain (err {err})")
    phase(9, f"K2 {label} {tuple(chunks.shape)}: kernel and plain "
             f"bit-identical, kept {int(got[1].sum())}")
    return err


def huge_genome(torch, tmp: Path):
    """Phase 9: one 2^27 bp genome through every huge-genome route on the
    card; all must give the same hv, norm2 and n_hashes. K2 is held to its
    plain version at the genome's full 1024-chunk shape and at one shard of
    the four-shard split. Returns (the K2 launches of K2_ROUTE, the largest
    K2 difference, K2 kernel ms, plain ms, bound) at the full shape."""
    import numpy as np

    from hypergen_tpu_torch import SketchParams
    from hypergen_tpu_torch.io.fastx import codes_from_packed, read_genome_packed
    from hypergen_tpu_torch.io.sketch_db import load_sketch
    from hypergen_tpu_torch.models.sketcher import Sketcher
    from hypergen_tpu_torch.ops.kernels.hash_kernel import (
        hash_chunks, hash_chunks_plain, hash_packed_rows,
    )
    from hypergen_tpu_torch.parallel.seqpar import (
        _chunk_codes, sketch_codes_seqpar,
    )

    d = tmp / "huge"
    d.mkdir()
    path = d / "plant.fna"
    t0 = time.monotonic()
    write_genome(path, HUGE_BP, SEED + 3, HUGE_N_RUNS)
    write_s = time.monotonic() - t0
    t0 = time.monotonic()
    g = read_genome_packed(path)
    parse_s = time.monotonic() - t0
    p = SketchParams()
    sk = Sketcher(p, device=DEVICE)
    n_chunks = sk._bucket(g.length)
    check(n_chunks == HUGE_BP // CHUNK and n_chunks >= sk.seqpar_min_chunks,
          f"huge genome bucket {n_chunks}")
    codes = codes_from_packed(g)
    phase(9, f"{HUGE_BP} bp genome, {g.runs.shape[0]} invalid runs, "
             f"{n_chunks} chunks: FASTA written in {write_s:.3f} s, parsed "
             f"in {parse_s:.3f} s")
    card = torch.device(DEVICE, 0)
    out = d / "plant.sketch"

    def cli():
        run_cli(["sketch", "-p", str(d), "-o", str(out), "-D", DEVICE])
        (s,) = load_sketch(out)
        return {"hv": s.decompress(), "norm2": s.hv_norm_2, "n_hashes": None}

    cards = torch.cuda.device_count()
    # (name, route, K2 launches it makes; K1 launches iff that is 0). On
    # one card the CLI takes the tiled route, on several it splits the
    # genome over all of them.
    routes = [
        (f"CLI sketch ({'seqpar' if cards > 1 else 'tiled route'}, "
         f"{cards} card(s), FASTA parse included)", cli,
         cards if cards > 1 else 0),
        ("seqpar on [cuda:0]",
         lambda: sketch_codes_seqpar(codes, p, [card]), 1),
        (K2_ROUTE, lambda: sketch_codes_seqpar(codes, p, [card] * 4), 4),
        ("sketch_packed_tiled",
         lambda: sk.sketch_packed_tiled(
             g, tile_chunks=max(1, sk.seqpar_min_chunks // 8)), 0),
        ("one-row K1 batch", lambda: sk.sketch_batch([g])[0], 0),
    ]
    if cards > 1:
        routes.append((f"seqpar on all {cards} cards",
                       lambda: sketch_codes_seqpar(codes, p), cards))
    results, k2_launches = [], {}
    for name, fn, want_k2 in routes:
        hash_packed_rows.launches = hash_chunks.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(card)
        t0 = time.monotonic()
        res = fn()
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        k1, k2 = hash_packed_rows.launches, hash_chunks.launches
        peak = torch.cuda.max_memory_allocated(card)
        check(k2 == want_k2 and (k1 > 0) == (want_k2 == 0),
              f"{name}: launches K1 {k1}, K2 {k2}")
        k2_launches[name] = k2
        results.append(res)
        phase(9, f"{name}: {secs:.3f} s, {HUGE_BP / 1e6 / secs:.1f} Mbp/s; "
                 f"n_hashes {res['n_hashes']}, norm2 {res['norm2']}; "
                 f"launches K1 {k1}, K2 {k2}; peak allocated on cuda:0 "
                 f"{peak / 2**20:.1f} MiB")
    ref = results[1]
    for (name, *_), res in zip(routes, results):
        check(np.array_equal(res["hv"], ref["hv"])
              and res["norm2"] == ref["norm2"]
              and res["n_hashes"] in (None, ref["n_hashes"]),
              f"{name} differs from seqpar on [cuda:0]")
    # the expected survivor count: valid windows / scaled
    chunks = torch.from_numpy(_chunk_codes(codes, p.ksize, CHUNK, 1)).cuda()
    n_bytes, n_mads = k2_work(torch, chunks, p.ksize)
    expect = n_mads / t1ha2_mads(p.ksize) / p.scaled
    check(ref["hv"].shape == (p.hv_d,) and ref["norm2"] > 0
          and abs(ref["n_hashes"] / expect - 1) < 0.05,
          f"huge genome: {ref['n_hashes']} hashes, expected ~{expect:.0f}")
    phase(9, f"all {len(routes)} routes agree: hv, norm2, n_hashes "
             f"{ref['n_hashes']} (expected ~{expect:.0f} = valid windows / "
             f"{p.scaled})")

    k2_args = (p.ksize, p.seed, p.threshold)
    err = k2_full_vs_plain(torch, "full shape", chunks, k2_args)
    shards = _chunk_codes(codes, p.ksize, CHUNK, 4)
    per = shards.shape[0] // 4  # the last shard holds the genome's end
    err = max(err, k2_full_vs_plain(
        torch, "one shard of four",
        torch.from_numpy(shards[3 * per :]).cuda(), k2_args))
    args = (chunks, *k2_args)
    k2_ms = time_ms(torch, lambda: hash_chunks(*args))
    plain_ms = time_ms(torch, lambda: hash_chunks_plain(*args), runs=3,
                       warmup=1)
    bound_ms, bound_by = bound(n_bytes, n_mads)
    phase(9, f"K2 at the full shape {tuple(chunks.shape)}: kernel "
             f"{k2_ms:.4f} ms, plain {plain_ms:.4f} ms (median of 12 and 3, "
             f"CUDA events); bound {bound_ms:.4f} ms by {bound_by} "
             f"({n_bytes} bytes, {n_mads} multiply-adds)")
    return k2_launches[K2_ROUTE], err, k2_ms, plain_ms, bound_ms, bound_by


def huge_card_vs_cpu(torch, tmp: Path) -> None:
    """Phase 10: the seqpar and tiled routes on the card equal their CPU
    runs, on a 3 Mbp genome with seqpar_min_chunks lowered to 16."""
    import numpy as np

    from hypergen_tpu_torch import SketchParams
    from hypergen_tpu_torch.io.fastx import codes_from_packed, read_genome_packed
    from hypergen_tpu_torch.models.sketcher import Sketcher
    from hypergen_tpu_torch.ops.kernels.hash_kernel import (
        hash_chunks, hash_packed_rows,
    )
    from hypergen_tpu_torch.parallel.seqpar import sketch_codes_seqpar

    path = tmp / "mid.fna"
    write_genome(path, MID_BP, SEED + 4, 20)
    g = read_genome_packed(path)
    codes = codes_from_packed(g)
    p = SketchParams()
    card = torch.device(DEVICE, 0)
    hash_chunks.launches = 0
    a = sketch_codes_seqpar(codes, p, [card] * 2)
    check(hash_chunks.launches == 2, "seqpar on the card launched no K2")
    b = sketch_codes_seqpar(codes, p, ["cpu"] * 2)
    check(np.array_equal(a["hv"], b["hv"]) and a["norm2"] == b["norm2"]
          and a["n_hashes"] == b["n_hashes"], "seqpar: card != CPU")
    # sketch_files routes the genome: on the CPU and on one card to the
    # tiled route, on several cards to seqpar over all of them
    cards = torch.cuda.device_count()
    routed = []
    for dev in (DEVICE, "cpu"):
        sk = Sketcher(p, device=dev, seqpar_min_chunks=16)
        check(sk._bucket(g.length) >= 16, "mid genome is not routed")
        hash_packed_rows.launches = hash_chunks.launches = 0
        (fs,) = sk.sketch_files([path])
        if dev == DEVICE:
            check(hash_chunks.launches == cards if cards > 1
                  else hash_packed_rows.launches > 0,
                  "sketch_files did not take the huge-genome route")
        routed.append(fs)
    check(np.array_equal(routed[0].hv, routed[1].hv)
          and routed[0].hv_norm_2 == routed[1].hv_norm_2
          and routed[0].hv_quant_bits == routed[1].hv_quant_bits,
          "sketch_files: card != CPU")
    check(np.array_equal(routed[0].decompress(), a["hv"])
          and routed[0].hv_norm_2 == a["norm2"], "sketch_files != seqpar")
    phase(10, f"{MID_BP} bp: seqpar over 2 shards, and sketch_files with "
              f"seqpar_min_chunks=16 ({'seqpar' if cards > 1 else 'tiled'} "
              f"on the card, tiled on the CPU), identical on the card and "
              f"the CPU; n_hashes {a['n_hashes']}")


def main() -> None:
    import torch

    # 1. the device
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    phase(1, f"device {kind}; torch {torch.__version__} cuda "
             f"{torch.version.cuda}; {torch.cuda.device_count()} card(s)")
    print(smi, flush=True)

    # 2. build the kernels and the FASTA parser from the checkout's
    # sources, both compilers at once
    from hypergen_tpu_torch.io import fastx
    from hypergen_tpu_torch.ops.kernels import build
    from hypergen_tpu_torch.ops.kernels.hash_kernel import (
        hash_packed_rows, hash_packed_rows_plain,
    )

    t0 = time.monotonic()
    with ThreadPoolExecutor(max_workers=2) as pool:
        libs = list(pool.map(build.build, ("hash_kernel", "fastx")))
    phase(2, f"built {', '.join(lib.name for lib in libs)} in "
             f"{time.monotonic() - t0:.2f} s; FASTA parser: {fastx.parser()}")

    worst, (args, kw) = kernel_vs_plain(torch)

    # 4. kernel time against plain time at the production shape
    k1_ms = time_ms(torch, lambda: hash_packed_rows(*args, **kw))
    plain_ms = time_ms(torch, lambda: hash_packed_rows_plain(*args, **kw))
    words, n_pos, nc = args[:3]
    B, S = words.shape[0], nc * kw["cap"] * kw["cells"]
    k1_bound = bound(
        words.numel() * 4 + B * 4 + B * S * (8 + 4 + 1) + B * 4,
        int(n_pos.sum()) * t1ha2_mads(args[4]),
    )
    phase(4, f"K1 at {B} rows x {nc} chunks x {CHUNK}: kernel {k1_ms:.4f} "
             f"ms, plain {plain_ms:.4f} ms (median of 12, CUDA events); "
             f"bound {k1_bound[0]:.4f} ms by {k1_bound[1]}")

    k2_err, (k2_args, k2_kw) = k2_vs_plain(torch)

    # 8. K2 time against plain time, K2_CHUNKS chunks
    from hypergen_tpu_torch.ops.kernels.hash_kernel import (
        hash_chunks, hash_chunks_plain,
    )

    k2_small = time_ms(torch, lambda: hash_chunks(*k2_args, **k2_kw))
    k2_small_plain = time_ms(torch, lambda: hash_chunks_plain(*k2_args, **k2_kw))
    small_bound = bound(*k2_work(torch, k2_args[0], k2_args[1]))
    phase(8, f"K2 at {K2_CHUNKS} chunks x {CHUNK}: kernel {k2_small:.4f} ms, "
             f"plain {k2_small_plain:.4f} ms (median of 12, CUDA events); "
             f"bound {small_bound[0]:.4f} ms by {small_bound[1]}")

    with tempfile.TemporaryDirectory(prefix="hg_smoke_") as tmp:
        genomes, launches = main_path(torch, Path(tmp))
        card_vs_cpu(Path(tmp), genomes)
        k2_launches, k2_full_err, k2_ms, k2_plain_ms, k2_bound, k2_by = (
            huge_genome(torch, Path(tmp)))
        huge_card_vs_cpu(torch, Path(tmp))

    check("jax" not in sys.modules, "jax was imported")
    leaked = sorted(m for m in sys.modules if m.startswith("hypergen_tpu")
                    and not m.startswith("hypergen_tpu_torch"))
    check(not leaked, f"modules of the JAX package were imported: {leaked}")
    phase(11, "imports: no jax, nothing of hypergen_tpu")
    print(json.dumps({"kernels": [{
        "name": "hash_packed_rows", "route": "cuda", "source": SOURCE,
        "replaces": K1_REPLACES, "launches": launches,
        "launches_on": "CLI sketch + dist of 16 genomes (phase 5)",
        "max_abs_err": worst, "ms": k1_ms, "plain_ms": plain_ms,
        "bound_ms": k1_bound[0], "bound_by": k1_bound[1], "library_ms": None,
    }, {
        "name": "hash_chunks", "route": "cuda", "source": SOURCE,
        "replaces": K2_REPLACES, "launches": k2_launches,
        "launches_on": f"{K2_ROUTE}, 2^27 bp genome (phase 9)",
        "max_abs_err": max(k2_err, k2_full_err), "ms": k2_ms,
        "plain_ms": k2_plain_ms, "bound_ms": k2_bound, "bound_by": k2_by,
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
