#!/usr/bin/env python3
"""Smoke test of the PyTorch port (hypergen_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card and the
CUDA toolkit. It builds the hand-written kernel from csrc/, checks it bit
for bit against its plain PyTorch version, times both, drives `sketch` and
`dist` through the port's CLI on 16 synthetic 4.19 Mbp genomes, and checks
the card's output files against the port's CPU run byte for byte. Every
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
DEVICE = "cuda"
K1_SOURCE = "hypergen_tpu_torch/csrc/hash_kernel.cu"
K1_REPLACES = "hypergen_tpu/ops/pallas/hash_kernel.py:219"


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

    # 2. build the kernel from the checkout's sources
    from hypergen_tpu_torch.ops.kernels import build
    from hypergen_tpu_torch.ops.kernels.hash_kernel import (
        hash_packed_rows, hash_packed_rows_plain,
    )

    t0 = time.monotonic()
    lib = build.build("hash_kernel")
    phase(2, f"built {lib.name} in {time.monotonic() - t0:.2f} s")

    worst, (args, kw) = kernel_vs_plain(torch)

    # 4. kernel time against plain time at the production shape
    k1_ms = time_ms(torch, lambda: hash_packed_rows(*args, **kw))
    plain_ms = time_ms(torch, lambda: hash_packed_rows_plain(*args, **kw))
    phase(4, f"K1 at {args[0].shape[0]} rows x {args[2]} chunks x {CHUNK}: "
             f"kernel {k1_ms:.4f} ms, plain {plain_ms:.4f} ms "
             f"(median of 12, CUDA events)")

    with tempfile.TemporaryDirectory(prefix="hg_smoke_") as tmp:
        genomes, launches = main_path(torch, Path(tmp))
        card_vs_cpu(Path(tmp), genomes)

    check("jax" not in sys.modules, "jax was imported")
    print(json.dumps({"kernels": [{
        "name": "hash_packed_rows", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": launches,
        "max_abs_err": worst, "ms": k1_ms, "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
