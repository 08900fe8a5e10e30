#!/usr/bin/env python3
"""Smoke test of the PyTorch port (hypergen_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--encode-baseline SRC.cu]

Run from the root of the repository on a machine with a CUDA card and the
CUDA toolkit. It builds the hand-written kernels (K1 and K2, and the HV
encode) and the native FASTA parser from csrc/, prints each kernel's
registers, shared memory and occupancy as the CUDA runtime reports them,
checks each kernel bit for bit against its plain PyTorch version and times
it alone (outputs allocated beforehand) and through its wrapper, drives
`sketch` and
`dist` through the port's CLI on 16 synthetic 4.19 Mbp genomes, and checks
the card's output files against the port's CPU run byte for byte. Then it
drives the huge-genome path on a synthetic 134 Mbp (2^27 bp) plant-scale
genome: the CLI's routing (the one-row K1 batch), K1 at that one-row shape,
sequence parallelism over one and four shards, the tiled route and the
one-row batch, which must agree; it measures the one-row batch's peak
memory at 2^27, 2^29 and 2^31 - 1 bp (the longest genome the router gives
it, where it must equal the tiled route) against the router's estimate,
and it checks the sequence-parallel and tiled routes and the routing on
the card, with its memory free and held down, against the CPU. Phase 12
drives the database path: `search --top_k 10` of 4,096 queries against a
synthetic 131,072-genome `.hgdb` (the 16 real sketches and families of
near copies, made on the card from a seed) through the CLI and through the
sharded search over [cuda:0] x 4, `dist -a 95` of its first 16,384 rows,
card-vs-CPU TSVs on a subset, the exact dot's float64 and int8 modes timed
at 2048 x 2048 x 4096, and `sketch -o .hgdb --shards 4` with `--resume` and
`hist`, card against CPU. Phase 13 drives the pod paths on phase 12's files
in child processes, one per card over NCCL (two sharing the one card over
gloo on a one-card machine): `sketch` with `--resume`, `dist -a 95` and
`search` (started by torchrun), each held to phase 12's one-process bytes,
with each process's row range, K1 launches, times and peak memory. Phase
14 prints the sketch's per-stage times (HG_STAGE_TIMING) for the 16 genomes
and the 2^27 bp genome, checks that they cover the sketch's wall and leave
its bytes unchanged and that an HG_TRACE_DIR trace names K1; then it
sketches a 2,181,038,080 bp genome (2^31 + 2^25, N runs on both sides of
2^31) through the CLI, the tiled route and seqpar over its parsed codes,
each equal to seqpar over codes made from the records in memory. Phase 15
drives the asynchronous sketch API: 8 batches submitted under
torch.cuda.set_sync_debug_mode("error") and collected in reverse order,
equal to phase 5's .sketch; a cell-cap and a compaction-width retry at
collect, equal to the CPU; sketch_files of 128 genomes at pipeline_depth 1
and 3, alternated, with wall and the host's stages and step parts, the bytes
identical. Phase 16 holds the encode kernel to its plain version at the
16-genome step's inputs, the 2^27 bp one-row step's and the 2.18 Gbp
genome's tiled encode, and at its wrap cases, times it alone on the card
(each call queued behind a spin, so that CUDA events bracket the card's
work and not the host's enqueue) and the host's part of a call, and shows
one call to be one kernel and no memset under torch.profiler; with
--encode-baseline it also holds another version of the encode kernel to
the plain version and times it in turns with the kernel; phases 5, 9, 10, 14 and 15
count its launches on every route that encodes. Every phase prints its
lines; any failure raises and exits non-zero before the last line. The last two lines are the kernel table
and the result, each one JSON object.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
BIG_BP = 1 << 29  # the one-row batch's memory: 2^27, 2^29 and LIMIT_BP
LIMIT_BP = (1 << 31) - 1  # the longest genome the one-row batch takes
HUGE_N_RUNS = 200
MID_BP = 3_000_000  # card-vs-CPU genome for the huge-genome routes
DEVICE = "cuda"
SOURCE = "hypergen_tpu_torch/csrc/hash_kernel.cu"
K1_REPLACES = "hypergen_tpu/ops/pallas/hash_kernel.py:219"
K2_REPLACES = "hypergen_tpu/ops/pallas/hash_kernel.py:158"
ENCODE_SOURCE = "hypergen_tpu_torch/csrc/encode_kernel.cu"
# XLA code, no pallas_call: encode_hv with hv_to_i16 (:149) and
# hv_norm2_i32 (:155), fused into the JAX package's sketch step
ENCODE_REPLACES = "hypergen_tpu/ops/encode.py:95"
# the 2,181,038,080 bp genome's distinct hashes (phase 14): the size of
# its tiled route's one encode
P4_HASHES = 1_453_769
# 32-bit multiply-adds of one (valid hash, wyrng word) pair of the encode:
# the one 64 x 64 -> 128-bit product that wymum needs, four 32 x 32 -> 64
# partial products (the low half falls out of the same partials; the
# carries and the offset's add are adds on the ALU pipe, not counted)
ENCODE_MADS = 4
# Bounds, from NVIDIA's H100 SXM data sheet: 3.35 TB/s of HBM; integer
# multiply-adds at 64 INT32 lanes per SM, half the 128 FP32 lanes behind the
# 67 TFLOP/s float32 rate (two flops per FMA): 67e12 / 4 per second.
HBM_BYTES_PER_S = 3.35e12
INT32_MAD_PER_S = 67e12 / 4
# a spin of about 0.5 ms on the card (torch.cuda._sleep), longer than the
# host takes to enqueue any call that card_ms times behind it
QUEUE_CYCLES = 1_000_000


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
    hash_window in csrc/hash_kernel.cu: NW = ceil(k/8) mixups, whose low
    and high halves are one 64 x 64 -> 128-bit product, four 32 x 32 -> 64
    partial products; the final mix, two low-only products (three partial
    products each) and one 128-bit product (four): 4 NW + 10."""
    nw = (k + 7) // 8
    return 4 * nw + 10


def bound(n_bytes: int, n_mads: int):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    multiply-adds over the INT32 rate."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_mads / INT32_MAD_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def kernel_resources(lib, chunks: bool, k: int) -> str:
    """Registers, static shared memory and occupancy of the kernel that the
    wrapper launches at the production shape for k (t1ha2; K1 with its
    uint4 loads), as the CUDA runtime reports them for card 0."""
    import ctypes

    out = (ctypes.c_int * 5)()
    err = lib.hg_kernel_resources(int(chunks), k, 0, 1, out)
    check(err == 0, f"hg_kernel_resources: CUDA error {err}")
    return resources_text(out)


def encode_resources() -> str:
    """Registers, shared memory and occupancy of the encode kernel, as the
    CUDA runtime reports them for card 0."""
    import ctypes

    from hypergen_tpu_torch.ops.kernels import build

    out = (ctypes.c_int * 5)()
    err = build.load("encode_kernel").hg_encode_resources(out)
    check(err == 0, f"hg_encode_resources: CUDA error {err}")
    return resources_text(out)


def resources_text(out) -> str:
    regs, smem, blocks, threads, per_sm = out
    return (f"{regs} registers, {smem} B static shared memory, {blocks} "
            f"blocks of {threads} threads an SM (occupancy "
            f"{blocks * threads / per_sm:.3f})")


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


def card_ms(torch, fns: dict, runs: int = 12, warmup: int = 2) -> dict:
    """Median milliseconds of the card's work in a call of each of fns
    (name -> fn) over `runs` rounds, the fns in turns and their order
    reversed every round. Each call is enqueued behind a spin of
    QUEUE_CYCLES on the card and bracketed by CUDA events, so the events
    time the card's work alone, not the host's enqueue (an event pair's
    own few microseconds included)."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    names = list(fns)
    times = {k: [] for k in names}
    for r in range(runs):
        for k in (names if r % 2 == 0 else names[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(QUEUE_CYCLES)
            start.record()
            fns[k]()
            end.record()
            torch.cuda.synchronize()
            times[k].append(start.elapsed_time(end))
    return {k: statistics.median(v) for k, v in times.items()}


def host_us(torch, fn, calls: int = 200) -> float:
    """Mean microseconds of the host's time in fn() over `calls` calls in a
    row, the card not waited for between them."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / calls * 1e6


def k1_times(torch, args, kw, plain_runs: int = 12):
    """K1 on args: (kernel ms, wrapper ms, plain ms). The kernel alone runs
    into outputs allocated beforehand (CUDA events around the launch only);
    the wrapper allocates its outputs as the sketch step calls it."""
    from hypergen_tpu_torch.ops.kernels.hash_kernel import (
        hash_packed_rows, hash_packed_rows_plain, launch_rows, rows_outputs,
    )

    words, n_pos, nc = args[:3]
    outs = rows_outputs(words.shape[0], nc, kw["cells"], kw["cap"],
                        words.device)
    rest = (*args[3:], kw["canonical"], kw["method"], kw["cells"], kw["cap"])
    kernel = time_ms(torch, lambda: launch_rows(outs, words, n_pos, nc, *rest))
    wrapper = time_ms(torch, lambda: hash_packed_rows(*args, **kw))
    plain = time_ms(torch, lambda: hash_packed_rows_plain(*args, **kw),
                    runs=plain_runs, warmup=min(plain_runs, 2))
    return kernel, wrapper, plain


def k2_times(torch, args, kw, plain_runs: int = 12):
    """K2 on args: (kernel ms, wrapper ms, plain ms), as k1_times."""
    from hypergen_tpu_torch.ops.kernels.hash_kernel import (
        hash_chunks, hash_chunks_plain, launch_chunks,
    )

    codes, k = args[:2]
    C = codes.shape[1] - k + 1
    outs = (torch.empty((codes.shape[0], C), dtype=torch.int64,
                        device=codes.device),
            torch.empty((codes.shape[0], C), dtype=torch.bool,
                        device=codes.device))
    rest = (*args[1:], kw["canonical"], kw["method"])
    kernel = time_ms(torch, lambda: launch_chunks(outs, codes, *rest))
    wrapper = time_ms(torch, lambda: hash_chunks(*args, **kw))
    plain = time_ms(torch, lambda: hash_chunks_plain(*args, **kw),
                    runs=plain_runs, warmup=min(plain_runs, 1))
    return kernel, wrapper, plain


def k1_bound(words, n_pos, nc, k, cap, cells):
    """K1's bound on these inputs: packed words and n_pos read once, the
    slots (h, pos, valid) and cell_max written once; a t1ha2 hash for every
    position below n_pos."""
    B = words.shape[0]
    S = nc * cap * cells
    return bound(words.numel() * 4 + B * 4 + B * S * (8 + 4 + 1) + B * 4,
                 int(n_pos.sum()) * t1ha2_mads(k))


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
    Returns (genomes, K1 launches of the run, encode launches)."""
    from hypergen_tpu_torch.ops.kernels.encode_kernel import encode_hv_i16
    from hypergen_tpu_torch.ops.kernels.hash_kernel import hash_packed_rows

    gdir = tmp / "genomes"
    gdir.mkdir()
    genomes = write_genomes(gdir)
    db, tsv = tmp / "db.sketch", tmp / "ani.tsv"
    hash_packed_rows.launches = encode_hv_i16.launches = 0
    with sketch_calls() as calls:
        sketch_s = run_cli(["sketch", "-p", str(gdir), "-o", str(db),
                            "-D", DEVICE])
    dist_s = run_cli(["dist", "-r", str(db), "-q", str(db), "-o", str(tsv),
                      "-a", "85", "-D", DEVICE])
    launches = hash_packed_rows.launches
    enc_launches = encode_hv_i16.launches
    check(launches > 0, "the main path launched no K1 kernel")
    check(enc_launches == launches,
          f"the main path launched the encode kernel {enc_launches} times, "
          f"K1 {launches} times: one each a step")
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
             f"{len(rows)} pairs >= 85; K1 launches {launches}, encode "
             f"launches {enc_launches}")
    phase(5, stage_text("the process's first sketch (CLI, pipeline_depth 3)",
                        *calls[-1]))
    return genomes, launches, enc_launches


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
    card; all must give the same hv, norm2 and n_hashes. The CLI routes it
    to the one-row K1 batch on one card and on several. K1 is held to its
    plain version and timed at that one-row shape, K2 at the genome's full
    1024-chunk shape and at one shard of the four-shard split; the one-row
    batch's peak memory is measured at 2^27, 2^29 and 2^31 - 1 bp against
    the router's estimate. Returns a dict of the numbers the kernels line
    reports."""
    import numpy as np

    from hypergen_tpu_torch import SketchParams
    from hypergen_tpu_torch.io.fastx import (
        PackedGenome, codes_from_packed, read_genome_packed,
    )
    from hypergen_tpu_torch.io.sketch_db import load_sketch
    from hypergen_tpu_torch.models import sketcher as sm
    from hypergen_tpu_torch.ops.kernels.encode_kernel import encode_hv_i16
    from hypergen_tpu_torch.ops.kernels.hash_kernel import (
        hash_chunks, hash_packed_rows, hash_packed_rows_plain,
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
    sk = sm.Sketcher(p, device=DEVICE)
    n_chunks = sk._bucket(g.length)
    check(n_chunks == HUGE_BP // CHUNK and n_chunks >= sk.seqpar_min_chunks,
          f"huge genome bucket {n_chunks}")
    check(sk._one_row_fits(g.length), "the router sends 2^27 bp elsewhere")
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
    tiles = -(-n_chunks // max(1, sk.seqpar_min_chunks // 8))
    # (name, route, K1, K2 and encode launches it makes); the CLI takes
    # the one-row batch on one card and on several; seqpar encodes a slab
    # a shard, the tiled route once
    routes = [
        (f"CLI sketch (one-row K1 batch, {cards} card(s), FASTA parse "
         f"included)", cli, 1, 0, 1),
        ("seqpar on [cuda:0]",
         lambda: sketch_codes_seqpar(codes, p, [card]), 0, 1, 1),
        (K2_ROUTE, lambda: sketch_codes_seqpar(codes, p, [card] * 4), 0, 4,
         4),
        ("sketch_packed_tiled", lambda: sk.sketch_packed_tiled(g),
         -(-tiles // sk.batch), 0, 1),
        ("one-row K1 batch", lambda: sk.sketch_batch([g])[0], 1, 0, 1),
    ]
    if cards > 1:
        routes.append((f"seqpar on all {cards} cards",
                       lambda: sketch_codes_seqpar(codes, p), 0, cards,
                       cards))
    results, k2_launches = [], {}
    for name, fn, want_k1, want_k2, want_enc in routes:
        hash_packed_rows.launches = hash_chunks.launches = 0
        encode_hv_i16.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(card)
        t0 = time.monotonic()
        res = fn()
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        k1, k2 = hash_packed_rows.launches, hash_chunks.launches
        enc = encode_hv_i16.launches
        peak = torch.cuda.max_memory_allocated(card)
        check((k1, k2, enc) == (want_k1, want_k2, want_enc),
              f"{name}: launches K1 {k1}, K2 {k2}, encode {enc}, want "
              f"{want_k1}, {want_k2}, {want_enc}")
        k2_launches[name] = k2
        results.append(res)
        phase(9, f"{name}: {secs:.3f} s, {HUGE_BP / 1e6 / secs:.1f} Mbp/s; "
                 f"n_hashes {res['n_hashes']}, norm2 {res['norm2']}; "
                 f"launches K1 {k1}, K2 {k2}, encode {enc}; peak allocated "
                 f"on cuda:0 {peak / 2**20:.1f} MiB")
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

    # K1 at the one-row shape, on this genome's packed row
    host = sk._prepare_batch([g], n_chunks)
    a1 = (torch.from_numpy(host.words).cuda(),
          torch.from_numpy(host.n_pos).cuda(),
          n_chunks, CHUNK, p.ksize, p.seed, p.threshold)
    kw1 = dict(canonical=p.canonical, method=p.sketch_method,
               cells=sk.cells, cap=sk.cell_cap)
    got = hash_packed_rows(*a1, **kw1)
    want = hash_packed_rows_plain(*a1, **kw1)
    torch.cuda.synchronize()
    err1 = max_abs_err(torch, got, want)
    check(all(torch.equal(a, b) for a, b in zip(got, want)) and err1 == 0,
          f"K1 one-row: kernel != plain (err {err1})")
    del got, want
    one_row = dict(zip(("ms", "wrapper_ms", "plain_ms"),
                       k1_times(torch, a1, kw1, plain_runs=1)))
    one_row["bound_ms"], one_row["bound_by"] = k1_bound(
        a1[0], a1[1], n_chunks, p.ksize, sk.cell_cap, sk.cells)
    phase(9, f"K1 at the one-row shape 1 x {n_chunks} x {CHUNK}: kernel and "
             f"plain bit-identical; kernel alone {one_row['ms']:.4f} ms, "
             f"wrapper {one_row['wrapper_ms']:.4f} ms, plain "
             f"{one_row['plain_ms']:.4f} ms (CUDA events, median of 12, "
             f"plain 1); bound {one_row['bound_ms']:.4f} ms by "
             f"{one_row['bound_by']}")
    del a1

    # the one-row batch's peak memory at 2^27, 2^29 and 2^31 - 1 bp against
    # the router's estimate (Sketcher._one_row_bytes); the larger genomes
    # are random packed bytes with no invalid run, built in memory
    def one_row_peak(genome):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(card)
        torch.cuda.reset_peak_memory_stats(card)
        t0 = time.monotonic()
        (res,) = sk.sketch_batch([genome])
        torch.cuda.synchronize()
        return (res, torch.cuda.max_memory_allocated(card) - base,
                time.monotonic() - t0)

    rng = np.random.default_rng(SEED + 5)
    peaks = []
    for bp in (HUGE_BP, BIG_BP, LIMIT_BP):
        genome = g if bp == HUGE_BP else PackedGenome(
            rng.integers(0, 256, size=-(-bp // 4), dtype=np.uint8),
            np.zeros((0, 2), np.int32), bp)
        n = sk._bucket(bp)
        check(sk._one_row_fits(bp), f"the router sends {bp} bp elsewhere")
        res, peak, secs = one_row_peak(genome)
        check(peak <= sk._one_row_bytes(n),
              f"one-row peak {peak} B at {bp} bp exceeds the router's "
              f"estimate {sk._one_row_bytes(n)} B")
        peaks.append(f"{peak} B at {bp} bp ({n} chunks, {secs:.3f} s)")
        if bp == HUGE_BP:
            n0, peak0 = n, peak
    check(not sk._one_row_fits(LIMIT_BP + 1), "the router takes 2^31 bp")
    slots = sk.cells * sk.cell_cap
    per_slot = ((peak - peak0) / (n - n0) - CHUNK // 4) / slots
    phase(9, f"one-row batch peak allocated above its start: "
             f"{', '.join(peaks)}: {per_slot:.2f} B a slot above the packed "
             f"words ({slots} slots a chunk); the router assumes "
             f"{sm.ONE_ROW_BYTES_PER_SLOT} B a slot, doubled, plus "
             f"{sm.ONE_ROW_RESERVE} B free, for genomes below "
             f"{LIMIT_BP + 1} bp")
    # at the limit the one-row batch equals the tiled route
    t0 = time.monotonic()
    tiled = sk.sketch_packed_tiled(genome)
    secs = time.monotonic() - t0
    del genome
    expect = (LIMIT_BP - p.ksize + 1) / p.scaled
    check(np.array_equal(res["hv"], tiled["hv"])
          and res["norm2"] == tiled["norm2"]
          and res["n_hashes"] == tiled["n_hashes"]
          and abs(res["n_hashes"] / expect - 1) < 0.01,
          f"{LIMIT_BP} bp: one-row batch != tiled, or {res['n_hashes']} "
          f"hashes against ~{expect:.0f}")
    phase(9, f"{LIMIT_BP} bp: the one-row batch equals the tiled route "
             f"({secs:.3f} s): hv, norm2, n_hashes {res['n_hashes']} "
             f"(expected ~{expect:.0f})")

    k2_args = (p.ksize, p.seed, p.threshold)
    err = k2_full_vs_plain(torch, "full shape", chunks, k2_args)
    shards = _chunk_codes(codes, p.ksize, CHUNK, 4)
    per = shards.shape[0] // 4  # the last shard holds the genome's end
    err = max(err, k2_full_vs_plain(
        torch, "one shard of four",
        torch.from_numpy(shards[3 * per :]).cuda(), k2_args))
    k2 = dict(zip(("ms", "wrapper_ms", "plain_ms"), k2_times(
        torch, (chunks, *k2_args),
        dict(canonical=p.canonical, method=p.sketch_method), plain_runs=3)))
    k2["bound_ms"], k2["bound_by"] = bound(n_bytes, n_mads)
    phase(9, f"K2 at the full shape {tuple(chunks.shape)}: kernel alone "
             f"{k2['ms']:.4f} ms, wrapper {k2['wrapper_ms']:.4f} ms, plain "
             f"{k2['plain_ms']:.4f} ms (median of 12, plain 3, CUDA events); "
             f"bound {k2['bound_ms']:.4f} ms by {k2['bound_by']} ({n_bytes} "
             f"bytes, {n_mads} multiply-adds)")
    return dict(k2_launches=k2_launches[K2_ROUTE], k2_err=err, k2=k2,
                k1_err=err1, k1_one_row=one_row)


def huge_card_vs_cpu(torch, tmp: Path) -> None:
    """Phase 10: the seqpar and tiled routes on the card equal their CPU
    runs, on a 3 Mbp genome with seqpar_min_chunks lowered to 16; and
    sketch_files routes it on the card to the one-row batch, and, with the
    card's memory held down to 1 GiB free (below the router's reserve), to
    tiles on one card or seqpar on several, all equal to the CPU's tiled
    route."""
    import numpy as np

    from hypergen_tpu_torch import SketchParams
    from hypergen_tpu_torch.io.fastx import codes_from_packed, read_genome_packed
    from hypergen_tpu_torch.models import sketcher as sm
    from hypergen_tpu_torch.ops.kernels.encode_kernel import encode_hv_i16
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
    hash_chunks.launches = encode_hv_i16.launches = 0
    a = sketch_codes_seqpar(codes, p, [card] * 2)
    check(hash_chunks.launches == 2 and encode_hv_i16.launches == 2,
          "seqpar on the card launched K2 or the encode not once a shard")
    b = sketch_codes_seqpar(codes, p, ["cpu"] * 2)
    check(np.array_equal(a["hv"], b["hv"]) and a["norm2"] == b["norm2"]
          and a["n_hashes"] == b["n_hashes"], "seqpar: card != CPU")
    cards = torch.cuda.device_count()

    def routed(dev, want):
        sk = sm.Sketcher(p, device=dev, seqpar_min_chunks=16)
        check(sk._bucket(g.length) >= 16, "mid genome is not routed")
        hash_packed_rows.launches = hash_chunks.launches = 0
        (fs,) = sk.sketch_files([path])
        got = (hash_packed_rows.launches > 0, hash_chunks.launches)
        check(dev == "cpu" or got == want,
              f"sketch_files on {dev}: launches (K1 > 0, K2) {got}, want "
              f"{want}")
        return fs

    cpu = routed("cpu", None)  # tiled, as the JAX package routes
    one_row = routed(DEVICE, (True, 0))
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info(card)
    hog = torch.empty(free - (1 << 30), dtype=torch.uint8, device=card)
    try:
        check(torch.cuda.mem_get_info(card)[0] < sm.ONE_ROW_RESERVE,
              "the card's memory was not held down")
        held = routed(DEVICE, (True, 0) if cards == 1 else (False, cards))
    finally:
        del hog
        torch.cuda.empty_cache()
    for name, fs in (("one-row", one_row), ("memory held down", held)):
        check(np.array_equal(fs.hv, cpu.hv) and fs.hv_norm_2 == cpu.hv_norm_2
              and fs.hv_quant_bits == cpu.hv_quant_bits,
              f"sketch_files {name}: card != CPU")
    check(np.array_equal(cpu.decompress(), a["hv"])
          and cpu.hv_norm_2 == a["norm2"], "sketch_files != seqpar")
    phase(10, f"{MID_BP} bp: seqpar over 2 shards, and sketch_files with "
              f"seqpar_min_chunks=16 (the one-row batch on the card; with "
              f"1 GiB of the card free "
              f"{'seqpar' if cards > 1 else 'tiled'}; tiled on the CPU), "
              f"identical on the card and the CPU; n_hashes {a['n_hashes']}")


# -- phase 16: the encode kernel -----------------------------------------------

def encode_bound(h, valid, hv_d: int):
    """The encode's bound on these inputs: hashes and flags read once, the
    int16 HV and the norms written once; ENCODE_MADS multiply-adds for each
    valid hash and wyrng word."""
    B = h.shape[0]
    n_bytes = h.numel() * 8 + valid.numel() + B * hv_d * 2 + B * 4
    return bound(n_bytes, int(valid.sum()) * (hv_d // 64) * ENCODE_MADS)


def encode_baseline(torch, src: Path):
    """A maker of calls of another version of the encode kernel, built from
    `src` with the port's nvcc flags: one with the C interface of the first
    version, two memsets, an accumulate and a tail kernel
    (hg_encode_hv_i16(h, valid, B, N, D, scratch, out_hv, out_norm2,
    stream), scratch u32 [B*D + B]), as in commit dea9f10's
    hypergen_tpu_torch/csrc/encode_kernel.cu. make(h, valid, hv_d) returns
    a function that runs it into outputs allocated beforehand."""
    import ctypes
    import hashlib

    from hypergen_tpu_torch.ops.kernels import build

    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = build.BUILD_DIR / f"libencode_baseline_{digest}.so"
    if not out.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                        str(src)], check=True, timeout=600)
    fn = ctypes.CDLL(str(out)).hg_encode_hv_i16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_int] + [ctypes.c_void_p] * 4

    def make(h, valid, hv_d):
        B, N = h.shape
        scratch = torch.empty(B * hv_d + B, dtype=torch.int32,
                              device=h.device)
        hv16 = torch.empty((B, hv_d), dtype=torch.int16, device=h.device)
        norm2 = torch.empty((B,), dtype=torch.int32, device=h.device)
        stream = torch.cuda.current_stream(h.device).cuda_stream

        def call():
            err = fn(h.data_ptr(), valid.data_ptr(), B, N, hv_d,
                     scratch.data_ptr(), hv16.data_ptr(), norm2.data_ptr(),
                     stream)
            check(err == 0, f"baseline encode: CUDA error {err}")
            return hv16, norm2
        return call
    return make


def encode_vs_plain(torch, tmp: Path, baseline=None) -> dict:
    """Phase 16: the encode kernel against its plain version, bit for bit
    (tolerance 0), and timed beside its bound at (a) the 16-genome step's
    inputs, taken from a step over 8 of phase 5's genomes (8 x 6,144), (b)
    the 2^27 bp genome's one-row step (1 x 179,712), (c) P4_HASHES
    all-valid hashes, the 2.18 Gbp genome's tiled encode: the kernel alone
    on the card (card_ms, into outputs allocated beforehand), the wrapper
    and plain on an idle card (CUDA events around the call, the host's
    enqueue included), each the median of 12 (plain 3 at (c)); at (a) also
    the host's microseconds a call of the wrapper, of launch with its
    outputs given and of the bare C entry. With `baseline` (encode_baseline
    of another version), that version is held to the plain version too and
    timed in turns with the kernel. Then one call at (a) is one kernel
    event and no memset under torch.profiler, and (a) right after (c) on
    one stream (one ticket buffer) is bit-identical; then the wrap cases
    (one hash 40,000 times: the int16 and int32 wraps; an empty row;
    D = 256). Returns the numbers of the kernels line."""
    import numpy as np

    from hypergen_tpu_torch import SketchParams
    from hypergen_tpu_torch.io.fastx import read_genome_packed
    from hypergen_tpu_torch.io.sketch_db import load_sketch
    from hypergen_tpu_torch.models.sketcher import Sketcher
    from hypergen_tpu_torch.ops.kernels import encode_kernel as ek

    p = SketchParams()
    sk = Sketcher(p, device=DEVICE)

    def step_inputs(genomes):
        """The encode's inputs in a step over `genomes`: its sorted hashes
        and their first-occurrence mask."""
        n_chunks = max(sk._bucket(g.length) for g in genomes)
        hs, first = sk._submit(genomes, n_chunks, hashes=True).device_out[:2]
        torch.cuda.synchronize()
        return hs, first

    names = [fs.file_str for fs in load_sketch(tmp / "db.sketch")]
    rng = np.random.default_rng(SEED + 16)
    tiled = torch.from_numpy(np.unique(rng.integers(
        0, 2**64, size=P4_HASHES, dtype=np.uint64)).view(np.int64))[None]
    tiled = tiled.to(DEVICE)
    shapes = {
        "a": ("the 16-genome step",
              *step_inputs([read_genome_packed(n) for n in names[:8]]), 12),
        "b": (f"the {HUGE_BP} bp one-row step",
              *step_inputs([read_genome_packed(tmp / "huge" / "plant.fna")]),
              12),
        "c": ("the 2.18 Gbp genome's tiled encode", tiled,
              torch.ones_like(tiled, dtype=torch.bool), 3),
    }
    out, wants, worst = {}, {}, 0
    for key, (label, h, valid, plain_runs) in shapes.items():
        got = ek.encode_hv_i16(h, valid, p.hv_d)
        want = wants[key] = ek.encode_hv_i16_plain(h, valid, p.hv_d)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        check(same and err == 0, f"encode {label}: kernel != plain "
                                 f"(err {err})")
        worst = max(worst, err)
        outs = ek.encode_outputs(*h.shape, p.hv_d, h.device)
        alone = {"kernel": lambda: ek.launch(outs, h, valid, p.hv_d)}
        if baseline is not None:
            alone["baseline"] = baseline(h, valid, p.hv_d)
            got = alone["baseline"]()
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"baseline encode {label}: != plain")
        card = card_ms(torch, alone)
        t = {
            "shape": f"{h.shape[0]} x {h.shape[1]}",
            "blocks": outs[0] * ek.word_groups(p.hv_d) * h.shape[0],
            "valid": int(valid.sum()),
            "ms": card["kernel"],
            "wrapper_ms": time_ms(
                torch, lambda: ek.encode_hv_i16(h, valid, p.hv_d)),
            "plain_ms": time_ms(
                torch, lambda: ek.encode_hv_i16_plain(h, valid, p.hv_d),
                runs=plain_runs, warmup=1),
        }
        t["bound_ms"], t["bound_by"] = encode_bound(h, valid, p.hv_d)
        base_text = ""
        if baseline is not None:
            t["baseline_ms"] = card["baseline"]
            base_text = (f"; the baseline version alone {card['baseline']:.4f}"
                         f" ms, in turns with it")
        out[key] = t
        phase(16, f"encode ({key}) {label}, {t['shape']} at D={p.hv_d}, "
                  f"{t['valid']} valid, {outs[0]} slabs a row, {t['blocks']} "
                  f"blocks: kernel and plain bit-identical; kernel alone on "
                  f"the card {t['ms']:.4f} ms{base_text}; wrapper "
                  f"{t['wrapper_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms "
                  f"(CUDA events, the host's enqueue included); median of "
                  f"12, plain {plain_runs}; bound {t['bound_ms']:.6f} ms by "
                  f"{t['bound_by']}")
    # the host's part of a call at (a): the wrapper (checks, plan, outputs,
    # ticket buffer, C entry), launch with its outputs given, the C entry
    h, valid = shapes["a"][1:3]
    B, N = h.shape
    outs = ek.encode_outputs(B, N, p.hv_d, h.device)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    tickets = ek.ticket_buffer(B, p.hv_d, h.device, stream)
    entry_args = (h.data_ptr(), valid.data_ptr(), B, N, p.hv_d, outs[0],
                  outs[1].data_ptr(), outs[1].numel(), tickets.data_ptr(),
                  tickets.numel(), outs[2].data_ptr(), outs[3].data_ptr(),
                  stream)
    entry = ek._entry()
    host = {"wrapper": host_us(
                torch, lambda: ek.encode_hv_i16(h, valid, p.hv_d)),
            "launch": host_us(
                torch, lambda: ek.launch(outs, h, valid, p.hv_d)),
            "entry": host_us(torch, lambda: entry(*entry_args))}
    out["a"]["host_us"] = host
    phase(16, f"host time a call at (a), mean of 200 (perf_counter): "
              f"wrapper {host['wrapper']:.1f} us, launch with its outputs "
              f"given {host['launch']:.1f} us, the bare C entry "
              f"{host['entry']:.1f} us: the wrapper adds "
              f"{host['wrapper'] - host['entry']:.1f} us")
    # one call is one kernel and no memset, under the profiler (the
    # ticket buffer of this stream exists already); then (a) right after
    # (c) on the same stream and ticket buffer, no synchronisation between
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        ek.encode_hv_i16(h, valid, p.hv_d)
        torch.cuda.synchronize()
    trace = tmp / "encode_one_call.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    memsets = [e for e in events if e.get("cat") == "gpu_memset"]
    check(len(kernels) == 1 and "encode_hv_kernel" in kernels[0]["name"]
          and not memsets, f"one encode call under the profiler: kernels "
                           f"{[e['name'] for e in kernels]}, {len(memsets)} "
                           f"memsets")
    got_c = ek.encode_hv_i16(*shapes["c"][1:3], p.hv_d)
    got_a = ek.encode_hv_i16(h, valid, p.hv_d)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(got_c + got_a,
                                                wants["c"] + wants["a"])),
          "encode (a) right after (c) on one stream: kernel != plain")
    phase(16, f"one encode call at (a) under torch.profiler: 1 kernel event "
              f"({kernels[0]['name'][:40]}, {kernels[0]['dur']} us), 0 "
              f"memsets; (a) right after (c) on one stream and ticket "
              f"buffer: bit-identical to plain")
    # the wraps: one hash 40,000 times in row 0, row 1 empty, 300,000
    # all-valid hashes in row 2 (several tiles a slab), at D 256 and 4096
    h = torch.from_numpy(np.sort(rng.integers(
        0, 2**63, size=(3, 300_000), dtype=np.uint64).view(np.int64)))
    h[0, :40_000] = h[0, 0]
    valid = torch.ones_like(h, dtype=torch.bool)
    valid[0, 40_000:] = False
    valid[1] = False
    h, valid = h.to(DEVICE), valid.to(DEVICE)
    for hv_d in (256, 4096):
        got = ek.encode_hv_i16(h, valid, hv_d)
        want = ek.encode_hv_i16_plain(h, valid, hv_d)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        check(all(torch.equal(a, b) for a, b in zip(got, want)) and err == 0,
              f"encode wrap case at D={hv_d}: kernel != plain (err {err})")
        check(set(got[0][0].abs().tolist()) == {65_536 - 40_000}
              and int(got[1][1]) == 0
              and (got[0][0].to(torch.int64) ** 2).sum() > 2**31,
              f"encode wrap case at D={hv_d}: the wraps did not happen")
        worst = max(worst, err)
    phase(16, f"encode wrap cases at D=256 and 4096 (one hash 40,000 times: "
              f"+-40000 -> -+25536, norm^2 above 2^31; an empty row; "
              f"300,000 hashes in a row): kernel and plain bit-identical")
    return {"max_abs_err": worst, **out}


# -- phase 12: the database path ----------------------------------------------

DB_ROWS = 1 << 17  # 131,072 genomes: GTDB r220 has 113,104 species reps
DB_SHARDS = 8
FAMILY = 16  # synthetic rows per family of near copies
N_QUERIES, SELF_QUERIES = 4096, 1024
TOP_K = 10
DEREP_ROWS = 1 << 14  # `dist -a 95` of the first 16,384 rows
SUB_ROWS, SUB_QUERIES = 8192, 512  # card-vs-CPU TSVs
RESUME_BP = 300_000  # the four genomes a --resume adds
DOT_M = DOT_N = 2048
# Bounds of the exact dot, from NVIDIA's H100 SXM data sheet: 1,979 TOPS of
# dense int8 tensor-core operations, 67 TFLOP/s of float64 (tensor core)
INT8_OPS_PER_S = 1979e12
FP64_FLOPS_PER_S = 67e12


def count_calls(torch):
    """Count calls of torch._int_mm (the int8 tensor-core products) and of
    torch.matmul (the float64 direct dot) until the returned restore()."""
    counts = {"_int_mm": 0, "matmul": 0}
    orig = torch._int_mm, torch.matmul

    def int_mm(*a, **k):
        counts["_int_mm"] += 1
        return orig[0](*a, **k)

    def matmul(*a, **k):
        counts["matmul"] += 1
        return orig[1](*a, **k)

    def restore():
        torch._int_mm, torch.matmul = orig

    torch._int_mm, torch.matmul = int_mm, matmul
    return counts, restore


def wrap_norms(torch, hv, block: int = 1 << 14):
    """Wrapping-int32 norm^2 of each int16 row of hv (numpy), on the card."""
    import numpy as np

    from hypergen_tpu_torch.ops.encode import hv_norm2_i32

    return np.concatenate([
        hv_norm2_i32(torch.from_numpy(hv[i : i + block]).cuda()).cpu().numpy()
        for i in range(0, hv.shape[0], block)])


def synth_db(torch, real, seed: int):
    """The 131,072-row database and its 4,096 queries, made on the card.

    Rows: the 16 real sketches, then families of FAMILY near copies: member
    i = sqrt(1 - p_i) S + sqrt(p_i) E_i with S, E_i Gaussian of the real
    sketches' standard deviation (the range a 4.19 Mbp genome's HV has at
    scaled 1500) and p_i uniform in [0.01, 0.91], so the ANI within a
    family spans about 89-100 % and across families about 0. Queries: 1,024
    DB rows (which must hit themselves at 100.000), then 3,072 new members
    of random families. Returns (db, queries) as ShardedDBs."""
    import numpy as np

    from hypergen_tpu_torch.io.sketch_db import ShardedDB

    D = real.hv_d
    sigma = float(real.hvs.astype(np.float64).std())
    n_fam = (DB_ROWS - len(real.names)) // FAMILY
    g = torch.Generator(device="cuda").manual_seed(seed)
    shared = torch.randn((n_fam, D), generator=g, device="cuda") * sigma

    def members(fam):  # fam: int64 tensor of family ids
        p = torch.rand((fam.numel(), 1), generator=g, device="cuda") * 0.9
        p += 0.01
        hv = shared[fam] * (1 - p).sqrt()
        hv += torch.randn((fam.numel(), D), generator=g, device="cuda") * (
            sigma * p.sqrt())
        return hv.round_().to(torch.int16).cpu().numpy()

    fam_ids = torch.arange(n_fam, device="cuda").repeat_interleave(FAMILY)
    hv = np.concatenate([real.hvs] + [
        members(fam_ids[i : i + (1 << 14)])
        for i in range(0, fam_ids.numel(), 1 << 14)])
    names = list(real.names) + [f"fam{f:05d}_m{j:02d}" for f in range(n_fam)
                                for j in range(FAMILY)]
    rng = np.random.default_rng(seed)
    self_rows = np.sort(rng.choice(hv.shape[0], SELF_QUERIES, replace=False))
    q_fam = rng.integers(0, n_fam, N_QUERIES - SELF_QUERIES)
    q_hv = np.concatenate([hv[self_rows], members(torch.from_numpy(q_fam)
                                                  .cuda())])
    q_names = [names[r] for r in self_rows] + [
        f"query{j:04d}_fam{f:05d}" for j, f in enumerate(q_fam)]
    del shared

    def db(n, h):
        return ShardedDB(ksize=real.ksize, scaled=real.scaled,
                         canonical=real.canonical, seed=real.seed, hv_d=D,
                         names=n, hvs=h, norms=wrap_norms(torch, h))

    return db(names, hv), db(q_names, q_hv)


def family(name: str) -> str:
    """The family of a synthetic row or query name ('' for a real genome)."""
    return name.split("fam")[1][:5] if "fam" in name and "/" not in name \
        else ""


def read_hits(path: Path):
    """{query: [(ref, ani string), ...]} of a search TSV, in file order."""
    hits = {}
    for line in path.read_text().splitlines():
        ref, query, ani = line.split("\t")
        hits.setdefault(query, []).append((ref, ani))
    return hits


def profiled(torch, fn):
    """(result, wall s, device busy ms, the top device ops) of fn() under
    torch.profiler: busy is the sum of the kernels' device times (None
    when the trace holds none); the profiler's own cost is in the wall."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        res = fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    kernels = sorted(
        ((e.self_device_time_total / 1e3, e.key, e.count)
         for e in prof.key_averages()
         if str(e.device_type).endswith("CUDA")), reverse=True)
    busy = sum(ms for ms, _, _ in kernels)
    top = "; ".join(f"{name[:60]} x{n} {ms:.3f} ms"
                    for ms, name, n in kernels[:6])
    return res, wall, busy or None, top


def idle_text(wall: float, busy, top: str) -> str:
    if busy is None:
        return "device busy time not measured (no device events traced)"
    return (f"device busy {busy:.3f} ms of {wall * 1e3:.3f} ms wall under "
            f"the profiler: idle share {1 - busy / (wall * 1e3):.4f}; top "
            f"kernels: {top}")


def timed_cli(torch, argv):
    """(wall seconds, peak bytes allocated on cuda:0) of one CLI call."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(0)
    secs = run_cli(argv)
    torch.cuda.synchronize()
    return secs, torch.cuda.max_memory_allocated(0)


def database_search(torch, tmp: Path, real, one_proc: dict):
    """Phase 12, the database: `search --top_k 10 -a 80` of 4,096 queries
    against the 131,072-row .hgdb through the CLI (every card) and through
    topk_search over [cuda:0] x 4, identical TSVs; `dist -a 95` of
    its first 16,384 rows; card-vs-CPU TSV bytes of `search` and `dist` on
    8,192 rows and 512 queries. Returns the database as loaded; the CLI's
    wall times go into one_proc."""
    import numpy as np

    from hypergen_tpu_torch.io.sketch_db import dump_sharded_db, load_sharded_db
    from hypergen_tpu_torch.models.comparator import Comparator
    from hypergen_tpu_torch.parallel.search import (
        topk_search, write_search_tsv,
    )

    t0 = time.monotonic()
    db, qs = synth_db(torch, real, SEED + 6)
    gen_s = time.monotonic() - t0
    t0 = time.monotonic()
    dump_sharded_db(db, tmp / "db.hgdb", n_shards=DB_SHARDS)
    dump_sharded_db(qs, tmp / "q.hgdb")
    write_s = time.monotonic() - t0
    check(db.hvs.shape == (DB_ROWS, real.hv_d), "database shape")
    phase(12, f"{DB_ROWS} x {real.hv_d} int16 database ({db.hvs.nbytes} B, "
              f"|v| <= {max(int(db.hvs.max()), -int(db.hvs.min()))}) and "
              f"{N_QUERIES} queries made on the card in {gen_s:.3f} s, "
              f"written as {DB_SHARDS} shards in {write_s:.3f} s")
    cards = torch.cuda.device_count()
    hits_cli = tmp / "hits.tsv"
    counts, restore = count_calls(torch)
    try:
        secs, peak = timed_cli(torch, [
            "search", "-r", str(tmp / "db.hgdb"), "-q", str(tmp / "q.hgdb"),
            "-o", str(hits_cli), "--top_k", str(TOP_K), "-a", "80",
            "-D", DEVICE])
        one_proc["search"] = secs
        calls = dict(counts)
        check(calls["_int_mm"] > 0 and calls["matmul"] == 0,
              f"search on the card: calls {calls}, want the int8 products "
              f"and no float64 matmul")
        phase(12, f"CLI search ({cards} card(s); "
                  f"{'row tiles of 65,536' if cards == 1 else 'one sharded pass'}"
                  f"): {secs:.3f} s wall with loading, peak allocated on "
                  f"cuda:0 {peak} B; torch._int_mm calls {calls['_int_mm']}, "
                  f"float64 matmul calls {calls['matmul']}")
        t0 = time.monotonic()
        db = load_sharded_db(tmp / "db.hgdb")  # as the CLI loads it
        load_s = time.monotonic() - t0
        card = torch.device(DEVICE, 0)
        _, wall, busy, top = profiled(torch, lambda: topk_search(
            [card], db.hvs, db.norms, qs.hvs, qs.norms, db.ksize, TOP_K))
        phase(12, f"where the CLI search's time goes: loading the .hgdb "
                  f"{load_s:.3f} s; the one-card route on arrays in memory "
                  f"(bound scan, uploads, two row tiles) {wall:.3f} s; "
                  f"{idle_text(wall, busy, top)}")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(0)
        t0 = time.monotonic()
        ani, idx, dot = topk_search(
            [card] * 4, db.hvs, db.norms, qs.hvs, qs.norms, db.ksize, TOP_K)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        peak = torch.cuda.max_memory_allocated(0)
        write_search_tsv(tmp / "hits_sharded.tsv", db.names, db.norms, qs,
                         ani, idx, dot, 80.0)
        check(hits_cli.read_bytes() == (tmp / "hits_sharded.tsv").read_bytes(),
              "search TSV: CLI != topk_search over [cuda:0] x 4")
        phase(12, f"topk_search over [cuda:0] x 4: {secs:.3f} s "
                  f"(arrays in memory), peak allocated {peak} B; TSV "
                  f"identical to the CLI's")
        if cards > 1:
            t0 = time.monotonic()
            ani, idx, dot = topk_search(
                [torch.device(DEVICE, i) for i in range(cards)], db.hvs,
                db.norms, qs.hvs, qs.norms, db.ksize, TOP_K)
            torch.cuda.synchronize()
            secs = time.monotonic() - t0
            write_search_tsv(tmp / "hits_all.tsv", db.names, db.norms, qs,
                             ani, idx, dot, 80.0)
            check(hits_cli.read_bytes() == (tmp / "hits_all.tsv").read_bytes(),
                  "search TSV: CLI != topk_search over every card")
            phase(12, f"topk_search over all {cards} cards: "
                      f"{secs:.3f} s; TSV identical")
        hits = read_hits(hits_cli)
        self_names = qs.names[:SELF_QUERIES]
        check(all(hits[n][0] == (n, "100.000") for n in self_names),
              "a DB row queried did not hit itself first at 100.000")
        wrong = [q for q in qs.names[SELF_QUERIES:]
                 if q not in hits or family(hits[q][0][0]) != family(q)]
        check(not wrong, f"{len(wrong)} perturbed queries missed their "
                         f"family: {wrong[:3]}")
        n_rows = sum(len(v) for v in hits.values())
        phase(12, f"search hits: {n_rows} rows >= 80; all {SELF_QUERIES} "
                  f"DB rows hit themselves first at 100.000; all "
                  f"{N_QUERIES - SELF_QUERIES} perturbed queries hit their "
                  f"family first")

        # dereplication: the first 16,384 rows against themselves
        first = dataclasses.replace(db, names=db.names[:DEREP_ROWS],
                                    hvs=db.hvs[:DEREP_ROWS],
                                    norms=db.norms[:DEREP_ROWS])
        dump_sharded_db(first, tmp / "derep.hgdb", n_shards=2)
        counts.update(_int_mm=0, matmul=0)
        secs, peak = timed_cli(torch, [
            "dist", "-r", str(tmp / "derep.hgdb"), "-q",
            str(tmp / "derep.hgdb"), "-o", str(tmp / "derep.tsv"), "-a", "95",
            "-D", DEVICE])
        one_proc["dist"] = secs
        calls = dict(counts)
        check(calls["_int_mm"] == 36 * 3 and calls["matmul"] == 0,
              f"dist on the card: calls {calls}, want 36 tiles x 3 int8 "
              f"products and no float64 matmul")
        rows = [line.split("\t") for line in
                (tmp / "derep.tsv").read_text().splitlines()]
        check(rows and all(float(v) >= 95.0 for _, _, v in rows)
              and all(family(a) == family(b) for a, b, _ in rows),
              "dist -a 95: a row below 95 or across families")
        phase(12, f"dist -a 95 of {DEREP_ROWS} rows against themselves "
                  f"(36 of 64 tiles of 2048): {secs:.3f} s wall with "
                  f"loading, {len(rows)} pairs, peak allocated {peak} B; "
                  f"torch._int_mm calls {calls['_int_mm']}, float64 matmul "
                  f"calls {calls['matmul']}")
        comp = Comparator(db.ksize, device=card)
        _, wall, busy, top = profiled(
            torch, lambda: comp.ani_pairs_thresholded(first, first, True, 95.0))
        phase(12, f"where dist's time goes: ani_pairs_thresholded on the "
                  f"arrays in memory {wall:.3f} s; "
                  f"{idle_text(wall, busy, top)}")
    finally:
        restore()

    # card vs CPU, TSV bytes, on 8,192 rows and 512 mixed queries
    sub = dataclasses.replace(db, names=db.names[:SUB_ROWS],
                              hvs=db.hvs[:SUB_ROWS], norms=db.norms[:SUB_ROWS])
    pick = slice(0, N_QUERIES, N_QUERIES // SUB_QUERIES)
    sq = dataclasses.replace(qs, names=qs.names[pick], hvs=qs.hvs[pick],
                             norms=qs.norms[pick])
    dump_sharded_db(sub, tmp / "sub.hgdb", n_shards=2)
    dump_sharded_db(sq, tmp / "subq.hgdb")
    for dev in (DEVICE, "cpu"):
        run_cli(["search", "-r", str(tmp / "sub.hgdb"), "-q",
                 str(tmp / "subq.hgdb"), "-o", str(tmp / f"sub_s_{dev}.tsv"),
                 "--top_k", str(TOP_K), "-a", "80", "-D", dev])
        run_cli(["dist", "-r", str(tmp / "sub.hgdb"), "-q",
                 str(tmp / "subq.hgdb"), "-o", str(tmp / f"sub_d_{dev}.tsv"),
                 "-a", "80", "-D", dev])
    for what in ("s", "d"):
        a = (tmp / f"sub_{what}_{DEVICE}.tsv").read_bytes()
        check(a and a == (tmp / f"sub_{what}_cpu.tsv").read_bytes(),
              f"{'search' if what == 's' else 'dist'} on {SUB_ROWS} x "
              f"{SUB_QUERIES}: card != CPU")
    phase(12, f"search --top_k {TOP_K} -a 80 and dist -a 80 of "
              f"{SUB_QUERIES} queries against {SUB_ROWS} rows: TSVs "
              f"byte-identical, card (int8) vs CPU (float64 direct dot)")
    return db


def dot_timings(torch, db) -> None:
    """Phase 12, the exact dot at 2048 x 2048 x 4096 on the card: float64,
    the int8 4-way and 3-product splits (whole and with r presplit, as the
    resident DB runs), their int8 products alone, the split of one
    operand and the elementwise rest; each mode equal to the float64 dot on real-range rows, and the
    4-way dot on full-range rows with int32-wrapping extremes. Median of
    12 by CUDA events."""
    import numpy as np

    from hypergen_tpu_torch.ops import ani

    D = db.hv_d
    r = torch.from_numpy(db.hvs[:DOT_M]).cuda()
    q = torch.from_numpy(db.hvs[DOT_M : DOT_M + DOT_N]).cuda()
    ref = ani.dot_i16_exact(r, q, False)
    for mode in (True, "small"):
        check(torch.equal(ani.dot_i16_exact(r, q, mode), ref),
              f"dot mode {mode} != float64 on the database rows")
    rng = np.random.default_rng(SEED + 7)
    wide = rng.integers(-32768, 32768, size=(2 * DOT_M, D)).astype(np.int16)
    wide[0], wide[DOT_M], wide[1], wide[DOT_M + 1] = 32767, 32767, -32768, 32767
    wide[2, ::2], wide[DOT_M + 2] = -6176, 6175
    rw = torch.from_numpy(wide[:DOT_M]).cuda()
    qw = torch.from_numpy(wide[DOT_M:]).cuda()
    exact = (wide[:3].astype(np.int64) @ wide[DOT_M : DOT_M + 3]
             .astype(np.int64).T)
    got = ani.dot_i16_exact(rw, qw, True)
    check(torch.equal(got, ani.dot_i16_exact(rw, qw, False))
          and np.array_equal(got[:3, :3].cpu().numpy(),
                             exact.astype(np.int32))
          and abs(int(exact[0, 0])) > 2**31,
          "4-way dot != float64 on full-range rows")
    del rw, qw, got
    split4 = ani.presplit_rows(r)
    small = ani.presplit_rows_small(r)
    qh, ql = ani.split_i16_to_i8(q)
    sh, sl = ani._split_small(q)
    shl = sh + sl
    mm = torch._int_mm
    t = {
        "float64": time_ms(torch, lambda: ani.dot_i16_exact(r, q, False)),
        "int8_4way": time_ms(torch, lambda: ani.dot_i16_exact(r, q, True)),
        "int8_small": time_ms(torch,
                              lambda: ani.dot_i16_exact(r, q, "small")),
        "int8_4way_presplit": time_ms(
            torch, lambda: ani.dot_i16_presplit(*split4, q)),
        "int8_small_presplit": time_ms(
            torch, lambda: ani.dot_i16_presplit_small(small, q)),
        "products_4way": time_ms(torch, lambda: (
            mm(split4[0], qh.T), mm(split4[0], ql.T), mm(split4[1], qh.T),
            mm(split4[1], ql.T))),
        "products_small": time_ms(torch, lambda: (
            mm(small.h, sh.T), mm(small.l, sl.T), mm(small.hl, shl.T))),
        "split_4way_q": time_ms(torch, lambda: ani.split_i16_to_i8(q)),
        "split_small_q": time_ms(torch, lambda: ani._split_small(q)),
    }
    # the elementwise share of the presplit dot (the split of q and the
    # combine): the presplit dot less its products, a difference of medians
    for m in ("4way", "small"):
        t[f"elementwise_{m}"] = t[f"int8_{m}_presplit"] - t[f"products_{m}"]
    macs = DOT_M * DOT_N * D
    bounds = {"float64": 2 * macs / FP64_FLOPS_PER_S * 1e3,
              "int8_4way": 4 * 2 * macs / INT8_OPS_PER_S * 1e3,
              "int8_small": 3 * 2 * macs / INT8_OPS_PER_S * 1e3}
    # each input read once and the int32 output written once
    byte_ms = (2 * (DOT_M + DOT_N) * D + 4 * DOT_M * DOT_N) / HBM_BYTES_PER_S * 1e3
    phase(12, f"exact dot {DOT_M} x {DOT_N} x {D}, median of 12 (CUDA "
              f"events), ms: " + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
          + "; bounds by operations: " + ", ".join(
              f"{k} {v:.4f}" for k, v in bounds.items())
          + f" (bytes {byte_ms:.4f}); every mode equal to float64, the "
            f"4-way dot also on full-range rows with int32-wrapping "
            f"extremes")


def hgdb_cli(torch, tmp: Path, one_proc: dict) -> None:
    """Phase 12, the .hgdb CLI: the 16 genomes of phase 5 through `sketch
    -o db.hgdb --shards 4`, then four more (300 kb) through `--resume`, and
    a resume with nothing left, on the card and with -D cpu: every file of
    the two directories equal, and `hist` of the two equal. The card's wall
    times go into one_proc."""
    import contextlib
    import io

    import numpy as np

    from hypergen_tpu_torch.ops.kernels.hash_kernel import hash_packed_rows

    gdir = tmp / "genomes"
    for dev in (DEVICE, "cpu"):
        hash_packed_rows.launches = 0
        secs = run_cli(["sketch", "-p", str(gdir), "-o",
                        str(tmp / f"{dev}.hgdb"), "--shards", "4", "-D", dev])
        one_proc.setdefault("sketch", secs)
        phase(12, f"sketch -o {dev}.hgdb --shards 4 of 16 genomes on "
                  f"{dev}: {secs:.3f} s, K1 launches "
                  f"{hash_packed_rows.launches}")
    rng = np.random.default_rng(SEED + 8)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    for i in range(4):
        seq = acgt[rng.integers(0, 4, size=RESUME_BP)].tobytes()
        (gdir / f"resumed_{i}.fna").write_bytes(
            fasta([(b"resumed%d" % i, seq)]))
    for dev in (DEVICE, "cpu"):
        for again in (False, True):
            d = tmp / f"{dev}.hgdb"
            before = {p.name: p.read_bytes() for p in d.iterdir()}
            secs = run_cli(["sketch", "-p", str(gdir), "-o", str(d),
                            "--resume", "-D", dev])
            one_proc.setdefault("resume", secs)
            after = {p.name: p.read_bytes() for p in d.iterdir()}
            check(all(after[n] == b for n, b in before.items()
                      if n.endswith(".npy")), f"{dev}: a shard was rewritten")
            check(len(after) == len(before) + (0 if again else 2)
                  and (not again or after == before),
                  f"{dev}: resume {'with nothing left ' if again else ''}"
                  f"wrote {sorted(set(after) - set(before))}")
    card, cpu = tmp / f"{DEVICE}.hgdb", tmp / "cpu.hgdb"
    names = sorted(p.name for p in card.iterdir())
    check(names == sorted(p.name for p in cpu.iterdir())
          and all((card / n).read_bytes() == (cpu / n).read_bytes()
                  for n in names), ".hgdb: card != CPU")
    hists = []
    for d in (card, cpu):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run_cli(["hist", "-r", str(d)])
        hists.append(buf.getvalue())
    check(hists[0] and hists[0] == hists[1], "hist: card .hgdb != CPU")
    phase(12, f"--resume added 4 genomes as one shard (existing shards "
              f"untouched), a second resume changed nothing; all "
              f"{len(names)} files of the .hgdb and hist's "
              f"{len(hists[0].splitlines())} lines identical, card vs CPU")


# -- phase 13: the pod ---------------------------------------------------------

POD_TIMEOUT_S = 300  # a pod step, process start-up included
# one process of a pod step started with the HG_* variables (argv: the
# launch's epoch time, then the CLI's): the CLI's main, then what the
# process saw (its start-up from the launch to main, torch imported; its K1
# launches; its time inside the command; its peak allocated bytes)
_POD_RANK = """
import sys, time
import torch
from hypergen_tpu_torch.cli import main
from hypergen_tpu_torch.ops.kernels.hash_kernel import hash_packed_rows
up = time.time() - float(sys.argv[1])
t0 = time.monotonic()
main(sys.argv[2:])
print(f"pod rank: start-up {up:.3f} s; K1 launches "
      f"{hash_packed_rows.launches}; {time.monotonic() - t0:.3f} s inside "
      f"the command; peak allocated {torch.cuda.max_memory_allocated()} B",
      flush=True)
"""
_POD_VARS = ("HG_NUM_PROCESSES", "HG_PROCESS_ID", "HG_COORDINATOR", "HG_DIST",
             "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
             "MASTER_ADDR", "MASTER_PORT")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def pod_env(n: int, **extra) -> dict:
    import os

    env = {k: v for k, v in os.environ.items() if k not in _POD_VARS}
    env.update(PYTHONPATH=str(ROOT) + os.pathsep + env.get("PYTHONPATH", ""),
               HG_DIST_TIMEOUT_S=str(POD_TIMEOUT_S),
               HG_PART_STALL_S=str(POD_TIMEOUT_S),
               OMP_NUM_THREADS=str(max(1, (os.cpu_count() or n) // n)), **extra)
    return env


def pod_step(label: str, cmds):
    """Run the processes of one pod step, cmds = [(argv, env), ...], each
    in its own session. Returns (wall seconds, process start-up included;
    each process's stdout). A process that exits non-zero fails the phase
    with the tail of its output; on any failure every process started is
    killed with its children."""
    import os
    import signal

    t0 = time.monotonic()
    procs = [subprocess.Popen(argv, env=env, cwd=ROOT, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              start_new_session=True) for argv, env in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=POD_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    wall = time.monotonic() - t0
    for i, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(f"[phase 13] {label}: process {i} exited {p.returncode}; "
                  f"stderr tail:\n{err[-4000:]}\nstdout tail:\n{out[-2000:]}",
                  flush=True)
        check(p.returncode == 0, f"{label}: process {i} exited "
                                 f"{p.returncode}")
    return wall, [out for out, _ in outs]


def _field(out: str, before: str, after: str) -> str:
    """The text between `before` and `after` on the first line of out that
    holds `before`."""
    line = next(x for x in out.splitlines() if before in x)
    return line.split(before, 1)[1].split(after, 1)[0]


def pod(torch, tmp: Path, one_proc: dict) -> None:
    """Phase 13, the pod paths through the CLI, one process per card (2 to
    4 over NCCL), or, on one card, 2 processes sharing it over gloo: `sketch
    -o pod.hgdb` of the 16 genomes of phase 5, then `--resume` with phase
    12's four; `dist -a 95` of derep.hgdb; `search --top_k 10 -a 80` of
    q.hgdb against db.hgdb, started by torchrun with HG_DIST=1. The .hgdb
    must equal phase 12's card .hgdb by name, in the pod's row order, and
    the TSVs phase 12's bytes."""
    import numpy as np

    from hypergen_tpu_torch.io.fastx import get_fasta_files
    from hypergen_tpu_torch.io.sketch_db import load_sharded_db

    cards = torch.cuda.device_count()
    n, backend = (min(cards, 4), "nccl") if cards > 1 else (2, "gloo")
    phase(13, f"layout: {n} processes, " + (
        f"one card each, over NCCL" if backend == "nccl"
        else "sharing cuda:0, over gloo"))
    torch.cuda.empty_cache()

    def ranks(argv):  # one process per rank, from the HG_* variables
        port = free_port()
        return [([sys.executable, "-c", _POD_RANK, repr(time.time()), *argv],
                 pod_env(n, HG_NUM_PROCESSES=str(n), HG_PROCESS_ID=str(i),
                         HG_COORDINATOR=f"localhost:{port}"))
                for i in range(n)]

    def rank0(outs):
        """Process 0's start-up, group start and time inside the command."""
        o = outs[0]
        return (f"process 0: start-up {_field(o, 'start-up ', ' s')} s, "
                f"group started in {_field(o, 'group started in ', ' s')} "
                f"s, inside the command {_field(o, 'launches ', ' s')
                                          .split('; ')[1]} s")

    # sketch: the 16 genomes first (the four resume genomes held aside)
    gdir, hold, out = tmp / "genomes", tmp / "pod_hold", tmp / "pod.hgdb"
    hold.mkdir()
    resumed = sorted(gdir.glob("resumed_*.fna"))
    for f in resumed:
        f.rename(hold / f.name)
    first = get_fasta_files(gdir)
    argv = ["sketch", "-p", str(gdir), "-o", str(out), "-D", DEVICE]
    walls, inside = [], []
    for step in ("sketch", "--resume"):
        if step == "--resume":
            for f in resumed:
                (hold / f.name).rename(f)
            argv.append("--resume")
        wall, outs = pod_step(f"pod {step}", ranks(argv))
        check(all(f"backend {backend}" in o for o in outs),
              f"pod {step}: a process did not log backend {backend}")
        k1 = [int(_field(o, "K1 launches ", ";")) for o in outs]
        check(sum(k1) > 0, f"pod {step}: no process launched K1")
        walls.append(wall)
        inside.append(rank0(outs))
        phase(13, f"pod {step}: K1 launches by process {k1}")
    new = [f for f in get_fasta_files(gdir) if f not in first]
    want = [str(f) for part in (first, new) for i in range(n)
            for f in part[i::n]]
    manifest = json.loads((out / "manifest.json").read_text())
    check(manifest["names"] == want and [sh["id"] for sh in manifest["shards"]]
          == list(range(2 * n)), "pod .hgdb: the rows or shards are not "
          "files[0::n] + files[1::n] + ... with the resumed shards after")
    got, ref = load_sharded_db(out), load_sharded_db(tmp / f"{DEVICE}.hgdb")
    rows = {nm: i for i, nm in enumerate(ref.names)}
    check(sorted(got.names) == sorted(ref.names) and all(
        np.array_equal(got.hvs[i], ref.hvs[rows[nm]])
        and got.norms[i] == ref.norms[rows[nm]]
        for i, nm in enumerate(got.names)),
        "pod .hgdb != phase 12's card .hgdb by name")
    phase(13, f"pod sketch of {len(first)} genomes then --resume of "
              f"{len(new)}: {len(got.names)} rows in {2 * n} shards equal "
              f"phase 12's card .hgdb by name, in the pod's row order; "
              f"wall {walls[0]:.3f} s / {walls[1]:.3f} s ({inside[0]} / "
              f"{inside[1]}); one process (phase 12, --shards 4): "
              f"{one_proc['sketch']:.3f} s / {one_proc['resume']:.3f} s")

    # dist -a 95 of the first 16,384 rows
    derep = str(tmp / "derep.hgdb")
    wall, outs = pod_step("pod dist", ranks(
        ["dist", "-r", derep, "-q", derep, "-o", str(tmp / "pod_derep.tsv"),
         "-a", "95", "-D", DEVICE]))
    check((tmp / "pod_derep.tsv").read_bytes()
          == (tmp / "derep.tsv").read_bytes(),
          "pod dist -a 95 TSV != phase 12's")
    phase(13, f"pod dist -a 95 of {DEREP_ROWS} rows: TSV byte-identical to "
              f"phase 12's; wall {wall:.3f} s ({rank0(outs)}); one "
              f"process (phase 12) {one_proc['dist']:.3f} s")

    # search, started as a user starts a pod on one machine
    wall, (log_,) = pod_step("pod search", [(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(n), "-m", "hypergen_tpu_torch.cli",
         "search", "-r", str(tmp / "db.hgdb"), "-q", str(tmp / "q.hgdb"),
         "-o", str(tmp / "pod_hits.tsv"), "--top_k", str(TOP_K), "-a", "80",
         "-D", DEVICE], pod_env(n, HG_DIST="1"))])
    check((tmp / "pod_hits.tsv").read_bytes() == (tmp / "hits.tsv").read_bytes(),
          "pod search TSV != phase 12's")
    lines = log_.splitlines()
    ranges = sorted(tuple(int(x) for x in _field(ln, "rows [", ")").split(", "))
                    for ln in lines if "holds DB rows" in ln)
    check(len(ranges) == n and ranges[0][0] == 0 and ranges[-1][1] == DB_ROWS
          and all(a[1] == b[0] for a, b in zip(ranges, ranges[1:])),
          f"pod search: row ranges {ranges} are not disjoint and covering "
          f"[0, {DB_ROWS})")
    peaks = sorted(_field(ln, "search: process ", " on cuda")
                   for ln in lines if "peak allocated" in ln)
    check(len(peaks) == n and sum(f"backend {backend}" in ln for ln in lines)
          == n, f"pod search: {len(peaks)} peak lines, want {n}")
    done = next(ln for ln in lines if f"(process 0/{n})" in ln)
    inside = float(done.split(" in ", 1)[1].split("s -> ", 1)[0])
    groups = [_field(ln, "started in ", " s") for ln in lines
              if "group started in" in ln]
    phase(13, f"pod search --top_k {TOP_K} of {N_QUERIES} queries against "
              f"{DB_ROWS} rows (torchrun, HG_DIST=1): TSV byte-identical to "
              f"phase 12's; row ranges {ranges}; peak allocated: "
              f"{'; '.join(peaks)}; wall {wall:.3f} s (torchrun and "
              f"process start-up included; groups started in "
              f"{', '.join(groups)} s; process 0 searched in {inside:.3f} s "
              f"from the CLI's start after the group's); one process "
              f"(phase 12 CLI) {one_proc['search']:.3f} s")


# -- phase 14: a genome above 2^31 bp, and the stage table ---------------------

P4_BP = (1 << 31) + (1 << 25)  # 2,181,038,080 bp: a maize-sized assembly
G31 = 1 << 31
# record lengths: the second record boundary lies above 2^31
P4_RECORDS = (1_200_000_000, G31 + (1 << 24) - 1_200_000_000, 1 << 24)
P4_SEQPAR_SHARDS = 8  # the run-free reference: seqpar over [cuda:0] x 8
LINE_BP = 80
STAGE_SUM_TOLERANCE = 0.10  # the stages must cover the sketch_files wall


def p4_genome_records(seed: int):
    """The P4 genome in memory: three records of seeded random ACGT, P4_BP
    bases in all, with N runs of 1-5000 bases: 60 below 2^31, one across
    it and 30 above it (in the second and the third record), none touching
    another or a record separator. Returns (records [(name, bytes)], the
    invalid runs in code coordinates, separators included, sorted)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    starts = np.cumsum((0,) + P4_RECORDS[:-1]) + np.arange(3)  # code pos
    seps = [(int(s) - 1, int(s)) for s in starts[1:]]
    across = (G31 - 3000, G31 + 4000)
    runs = [across]
    for lo, hi, n in ((0, G31, 60), (G31, P4_BP, 30)):
        grid = (hi - lo) // (2 * n)  # one run at each of n grid points
        cuts = rng.choice(2 * n - 1, size=n, replace=False) + 1
        lens = rng.integers(1, min(5000, grid // 2) + 1, size=n)
        runs += [(lo + int(c) * grid, lo + int(c) * grid + int(m))
                 for c, m in zip(cuts, lens)]
    runs = sorted(r for r in runs if r == across or all(
        r[1] < a or r[0] > b for a, b in seps + [across]))
    lut = np.frombuffer(b"ACGT", np.uint8)
    records, step = [], 1 << 26
    for i, n in enumerate(P4_RECORDS):
        seq = np.empty(n, np.uint8)
        for a in range(0, n, step):
            m = min(step, n - a)
            seq[a : a + m] = lut[np.frombuffer(rng.bytes(m), np.uint8) & 3]
        for lo, hi in runs:
            if starts[i] <= lo < starts[i] + n:
                seq[lo - starts[i] : hi - starts[i]] = ord("N")
        records.append((b"chr%d synthetic" % (i + 1), seq.tobytes()))
        del seq
    return records, sorted(runs + seps)


def write_fasta_blocks(path: Path, records) -> None:
    """A FASTA of LINE_BP-base lines, written a block of lines at a time."""
    import numpy as np

    block = LINE_BP << 20
    with open(path, "wb") as fh:
        for name, seq in records:
            fh.write(b">" + name + b"\n")
            for a in range(0, len(seq), block):
                chunk = np.frombuffer(seq, np.uint8, min(block, len(seq) - a), a)
                full = chunk.size // LINE_BP * LINE_BP
                lines = np.empty((full // LINE_BP, LINE_BP + 1), np.uint8)
                lines[:, :LINE_BP] = chunk[:full].reshape(-1, LINE_BP)
                lines[:, LINE_BP] = ord("\n")
                fh.write(lines.tobytes())
                if full < chunk.size:
                    fh.write(chunk[full:].tobytes() + b"\n")


def valid_windows(length: int, runs, k: int) -> int:
    """k-mer windows of a genome of `length` codes that touch no run."""
    n, prev = 0, 0
    for lo, hi in list(runs) + [(length, length)]:
        n += max(lo - prev - k + 1, 0)
        prev = hi
    return n


@contextlib.contextmanager
def sketch_calls(depth=None):
    """Record (wall seconds, last_stage_times, the step's parts) of each
    Sketcher.sketch_files call made inside the block; depth: the
    pipeline_depth every call runs at (None: the caller's)."""
    from hypergen_tpu_torch.models import sketcher as sm

    calls, orig = [], sm.Sketcher.sketch_files

    def timed(self, *a, **kw):
        if depth is not None:
            kw["pipeline_depth"] = depth
        t0 = time.monotonic()
        out = orig(self, *a, **kw)
        calls.append((time.monotonic() - t0, dict(self.last_stage_times),
                      dict(self.last_part_times)))
        return out

    sm.Sketcher.sketch_files = timed
    try:
        yield calls
    finally:
        sm.Sketcher.sketch_files = orig


def ms_list(stages: dict) -> str:
    return ", ".join(f"{k} {v * 1e3:.3f} ms"
                     for k, v in sorted(stages.items(), key=lambda kv: -kv[1]))


def stage_text(label: str, wall: float, stages: dict, parts: dict) -> str:
    """The host stages against the sketch_files wall, then the step's
    parts (the host's enqueue of each, inside dispatch)."""
    total = sum(stages.values())
    return (f"stage times{', ' + label if label else ''}: host "
            f"{ms_list(stages)}; sum "
            f"{total * 1e3:.3f} ms of the sketch_files wall {wall * 1e3:.3f} "
            f"ms ({total / wall:.3f}); step parts (host enqueue, inside "
            f"dispatch) {ms_list(parts)}")


def host_peak_gib() -> float:
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def p4_genome(torch, tmp: Path) -> dict:
    """Phase 14, part 1: a 2,181,038,080 bp genome (2^31 + 2^25) through the
    CLI (the tiled route on one card, seqpar on several), the tiled route
    called directly, and seqpar over the parsed genome's codes, each held
    to a reference that needs no run list: seqpar over [cuda:0] x 8 on the
    codes that codes_from_records makes from the records in memory (K2
    counts the runs from the codes). Every route's numbers are printed
    before any check. Returns each route's (K1, K2, encode) launches."""
    import os
    import shutil

    import numpy as np

    from hypergen_tpu_torch import SketchParams
    from hypergen_tpu_torch.io.fastx import (
        codes_from_packed, codes_from_records, read_genome_packed,
    )
    from hypergen_tpu_torch.io.sketch_db import load_sketch
    from hypergen_tpu_torch.models import sketcher as sm
    from hypergen_tpu_torch.ops.kernels.encode_kernel import encode_hv_i16
    from hypergen_tpu_torch.ops.kernels.hash_kernel import (
        hash_chunks, hash_packed_rows,
    )
    from hypergen_tpu_torch.parallel.seqpar import sketch_codes_seqpar

    d = tmp / "p4"
    d.mkdir()
    need = P4_BP * (LINE_BP + 1) // LINE_BP + (1 << 30)
    free = shutil.disk_usage(d).free
    check(free >= need, f"phase 14 needs {need} B free in {d}, has {free}")
    p = SketchParams()
    card = torch.device(DEVICE, 0)
    cards = torch.cuda.device_count()
    t0 = time.monotonic()
    records, runs = p4_genome_records(SEED + 14)
    codes = codes_from_records(records)
    make_s = time.monotonic() - t0
    length = codes.shape[0]
    expect = valid_windows(length, runs, p.ksize) / p.scaled
    path = d / "maize_sized.fna"
    t0 = time.monotonic()
    write_fasta_blocks(path, records)
    write_s = time.monotonic() - t0
    del records
    phase(14, f"{P4_BP} bp in {len(P4_RECORDS)} records ({length} codes), "
              f"{len(runs)} invalid runs (largest end {runs[-1][1]}): made "
              f"in {make_s:.3f} s, FASTA of {path.stat().st_size} B written "
              f"in {write_s:.3f} s")
    results = {}

    def route(key, name, fn):
        hash_packed_rows.launches = hash_chunks.launches = 0
        encode_hv_i16.launches = 0
        torch.cuda.synchronize()
        t0 = time.monotonic()
        res = fn()
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        launches = (hash_packed_rows.launches, hash_chunks.launches,
                    encode_hv_i16.launches)
        results[key] = (name, res, launches)
        phase(14, f"{name}: {secs:.3f} s; n_hashes {res['n_hashes']}, norm2 "
                  f"{res['norm2']}; launches K1 {launches[0]}, K2 "
                  f"{launches[1]}, encode {launches[2]}")

    route("reference", f"reference: seqpar on [cuda:0] x {P4_SEQPAR_SHARDS}, "
          f"codes from the records in memory",
          lambda: sketch_codes_seqpar(codes, p, [card] * P4_SEQPAR_SHARDS))
    ref = results["reference"][1]
    t0 = time.monotonic()
    g = read_genome_packed(path)
    parse_s = time.monotonic() - t0
    phase(14, f"read_genome_packed: {parse_s:.3f} s; runs {g.runs.dtype} "
              f"{tuple(g.runs.shape)}, largest end {int(g.runs[:, 1].max())}")
    parsed_codes = codes_from_packed(g)
    same_codes = np.array_equal(parsed_codes, codes)
    del codes
    route("seqpar_parsed", f"seqpar on [cuda:0] x {P4_SEQPAR_SHARDS}, codes "
          f"from the parsed runs (codes equal: {same_codes})",
          lambda: sketch_codes_seqpar(parsed_codes, p,
                                      [card] * P4_SEQPAR_SHARDS))
    del parsed_codes
    sk = sm.Sketcher(p, device=DEVICE)
    route("tiled", "sketch_packed_tiled", lambda: sk.sketch_packed_tiled(g))
    runs_ok = (g.runs.dtype == np.int64
               and g.runs.tolist() == [list(r) for r in runs])
    del g

    # the CLI, with its huge-genome result kept for n_hashes (the .sketch
    # holds hv and norm2 only)
    seen = []
    orig = sm.Sketcher._sketch_huge
    sm.Sketcher._sketch_huge = lambda self, g: seen.append(orig(self, g)) \
        or seen[-1]
    out = d / "big.sketch"
    try:
        with sketch_calls() as calls:
            route("cli", f"CLI sketch -D {DEVICE} ({cards} card(s); FASTA "
                  f"parse included)",
                  lambda: run_cli(["sketch", "-p", str(d), "-o", str(out),
                                   "-D", DEVICE]) and seen[-1])
    finally:
        sm.Sketcher._sketch_huge = orig
        path.unlink()
    phase(14, stage_text(f"{P4_BP} bp genome, CLI", *calls[-1]))
    (fs,) = load_sketch(out)
    cli_launches = results["cli"][2]
    on = ("seqpar" if cli_launches[1] else
          "the one-row batch" if cli_launches[0] == 1 else "tiles")
    n_tiles = -(-(length - p.ksize + 1) // (sk.seqpar_min_chunks // 8 * sk.C))
    # seqpar encodes a slab a card, the tiled route once
    want = (0, cards, cards) if cards > 1 else (-(-n_tiles // sk.batch), 0, 1)
    phase(14, f"the CLI took {on}; host peak resident {host_peak_gib():.2f} "
              f"GiB")

    check(cli_launches == want, f"CLI launches (K1, K2, encode) "
                                f"{cli_launches}, want {want} ({n_tiles} "
                                f"tiles)")
    check(results["tiled"][2][2] == 1
          and results["reference"][2][2] == P4_SEQPAR_SHARDS,
          f"encode launches: tiled {results['tiled'][2][2]}, seqpar "
          f"{results['reference'][2][2]}; want 1 and {P4_SEQPAR_SHARDS}")
    check(runs_ok, "read_genome_packed: the runs are not the int64 runs "
                   "of the genome")
    check(same_codes, "codes_from_packed != codes_from_records")
    check(np.array_equal(fs.decompress(), ref["hv"])
          and fs.hv_norm_2 == ref["norm2"], "CLI .sketch != the reference")
    for name, res, _ in results.values():
        check(np.array_equal(res["hv"], ref["hv"])
              and res["norm2"] == ref["norm2"]
              and res["n_hashes"] == ref["n_hashes"],
              f"{name} != the reference")
    check(ref["hv"].shape == (p.hv_d,)
          and abs(ref["n_hashes"] / expect - 1) < 0.01,
          f"{ref['n_hashes']} hashes, expected ~{expect:.0f}")
    phase(14, f"every route equals the reference: hv, norm2, n_hashes "
              f"{ref['n_hashes']} (expected ~{expect:.0f} = valid windows "
              f"/ {p.scaled}); the CLI's .sketch too")
    return {key: launches for key, (_, _, launches) in results.items()}


def stage_table(torch, tmp: Path, genomes) -> None:
    """Phase 14, part 2: HG_STAGE_TIMING=1 on the CLI sketch of phase 5's
    16 genomes and of phase 9's 2^27 bp genome, at pipeline_depth 1: each
    one's host and device stages as one line, the host stages' sum within
    STAGE_SUM_TOLERANCE of the sketch_files wall, every device stage of
    the step timed, the .sketch bytes equal to the run without the switch;
    then one HG_TRACE_DIR run of the 16 genomes, whose trace must name
    K1 and the encode kernel."""
    import collections
    import os

    from hypergen_tpu_torch.ops.kernels.encode_kernel import encode_hv_i16
    from hypergen_tpu_torch.ops.kernels.hash_kernel import hash_packed_rows

    cells = tmp / "stage16"
    cells.mkdir()
    for g in genomes:
        (cells / Path(g).name).symlink_to(g)
    with sketch_calls(depth=1) as calls:
        for label, src in (("16 x 4.19 Mbp genomes (phase 5)", cells),
                           (f"{HUGE_BP} bp genome (phase 9)", tmp / "huge")):
            sketches = []
            for switch in ("", "1"):
                os.environ["HG_STAGE_TIMING"] = switch
                out = tmp / f"stage_{src.name}_{switch or 'off'}.sketch"
                run_cli(["sketch", "-p", str(src), "-o", str(out), "-D",
                         DEVICE])
                sketches.append(out.read_bytes())
            os.environ.pop("HG_STAGE_TIMING")
            wall, stages, parts = calls[-1]
            total = sum(stages.values())
            phase(14, stage_text(f"{label}, pipeline_depth 1", wall, stages,
                                 parts))
            check(sketches[0] == sketches[1],
                  f"{label}: .sketch bytes differ with HG_STAGE_TIMING")
            check(abs(total / wall - 1) <= STAGE_SUM_TOLERANCE,
                  f"{label}: the stages sum to {total:.4f} s of a "
                  f"{wall:.4f} s wall")
            for stage in ("hash", "compact", "distinct", "encode"):
                check(parts.get(stage, 0) > 0, f"{label}: no {stage} span")

    trace_dir = tmp / "trace"
    os.environ["HG_TRACE_DIR"] = str(trace_dir)
    hash_packed_rows.launches = encode_hv_i16.launches = 0
    try:
        run_cli(["sketch", "-p", str(cells), "-o", str(tmp / "traced.sketch"),
                 "-D", DEVICE])
    finally:
        os.environ.pop("HG_TRACE_DIR")
    launches = hash_packed_rows.launches
    (trace,) = trace_dir.iterdir()
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1 = [e for e in kernels if "rolling_packed_kernel" in e.get("name", "")]
    check(k1, f"the trace {trace.name} names no K1 launch")
    enc = [e for e in kernels if "encode_hv_kernel" in e.get("name", "")]
    check(enc, f"the trace {trace.name} names no encode kernel")
    memsets = [e for e in events if e.get("cat") == "gpu_memset"]
    top = collections.Counter(e["name"][:60] for e in kernels).most_common(4)
    # the device's own time: the kernels' and copies' durations, without
    # the waits for the host's next launch that a CUDA-event span includes
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"]
    own = [sum(e.get("dur", 0) for e in x) / 1e3 for x in (kernels, copies)]
    phase(14, f"HG_TRACE_DIR: {trace.name}, {trace.stat().st_size} B, "
              f"{len(events)} events, {len(kernels)} kernel events, {len(k1)} "
              f"of them K1 ({sum(e.get('dur', 0) for e in k1):.1f} us; K1 "
              f"launches by its counter {launches}), {len(enc)} the encode "
              f"kernel ({sum(e.get('dur', 0) for e in enc):.1f} us; encode "
              f"launches by its counter {encode_hv_i16.launches}); kernels' "
              f"own time {own[0]:.3f} ms, {len(copies)} copies "
              f"{own[1]:.3f} ms, {len(memsets)} memsets; most "
              f"frequent kernels {top}")



# -- phase 15: the pipelined sketch -------------------------------------------

DEPTH_COPIES = 8  # phase 15(c): 16 genomes x 8 names = 128 genomes
DEPTH_RUNS = 3  # runs at each depth, alternated


def width_repeat(rng, p, bp: int):
    """Codes of a repeat-rich genome of bp codes: one 64-code unit (one
    K1 cell) repeated, whose windows keep 1-3 hashes, so that no cell
    overflows its slots while the genome's survivors (at least bp / 64)
    overflow its bucket's compaction width."""
    import numpy as np
    import torch

    from hypergen_tpu_torch.ops.kmers import hash_kmer_positions

    lsub = CHUNK // CELLS
    while True:
        unit = rng.integers(0, 4, size=lsub).astype(np.uint8)
        window = torch.from_numpy(np.tile(unit, 2)[None, : lsub + p.ksize - 1])
        _, keep = hash_kmer_positions(window, p.ksize, p.seed, p.threshold)
        if 1 <= int(keep.sum()) <= 3:
            return np.tile(unit, -(-bp // lsub))[:bp]


def same_results(a, b) -> bool:
    return len(a) == len(b) and all(
        x["n_hashes"] == y["n_hashes"] and x["norm2"] == y["norm2"]
        and (x["hv"] == y["hv"]).all() for x, y in zip(a, b))


def pipelined(torch, tmp: Path) -> dict:
    """Phase 15: the asynchronous sketch API on the card. (a) 8 batches of
    phase 5's genomes submitted under torch.cuda.set_sync_debug_mode
    ("error"), then collected in reverse order: each equal to sketch_batch
    of its group and, as .sketch bytes, to phase 5's CLI output. (b) the
    capacity retries at collect: phase 6's scaled=50 batch (cell cap) and a
    repeat-rich genome (compaction width), equal to the CPU. (c)
    sketch_files of 128 x 4.19 Mbp at pipeline_depth 1 and 3, alternated:
    wall, genomes/s, host stages and the step's parts, identical
    bytes. Returns K1's and the encode's launches in one depth-3 run of
    (c)."""
    import numpy as np

    from hypergen_tpu_torch import SketchParams
    from hypergen_tpu_torch.io.fastx import packed_from_codes, read_genome_packed
    from hypergen_tpu_torch.io.sketch_db import dump_sketch, load_sketch
    from hypergen_tpu_torch.models.sketcher import Sketcher
    from hypergen_tpu_torch.ops.kernels.encode_kernel import encode_hv_i16
    from hypergen_tpu_torch.ops.kernels.hash_kernel import hash_packed_rows

    p = SketchParams()
    db = tmp / "db.sketch"
    names = [fs.file_str for fs in load_sketch(db)]
    parsed = [read_genome_packed(n) for n in names]
    groups = [parsed[i : i + 2] for i in range(0, len(parsed), 2)]
    sk = Sketcher(p, device=DEVICE)
    ref = [sk.sketch_batch(g) for g in groups]
    torch.cuda.synchronize()

    # (a) submit without waiting: the mode is live (a read raises), then
    # the submits under it
    hash_packed_rows.launches = encode_hv_i16.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        try:
            torch.zeros(1, device=DEVICE).item()
            live = False
        except RuntimeError:
            live = True
        t0 = time.monotonic()
        handles = [sk.submit_batch_packed(g) for g in groups]
        submit_s = time.monotonic() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(live, "set_sync_debug_mode('error') did not raise on .item()")
    t0 = time.monotonic()
    got = sk.collect_batches(handles[::-1])[::-1]
    collect_s = time.monotonic() - t0
    check(hash_packed_rows.launches == len(groups),
          f"{len(groups)} submits launched K1 {hash_packed_rows.launches} times")
    check(encode_hv_i16.launches == len(groups),
          f"{len(groups)} submits launched the encode "
          f"{encode_hv_i16.launches} times")
    check(all(same_results(a, b) for a, b in zip(got, ref)),
          "a collected batch differs from sketch_batch of its group")
    out = tmp / "p15a.sketch"
    dump_sketch([sk._to_filesketch(r, n) for r, n in
                 zip([r for b in got for r in b], names)], out)
    check(out.read_bytes() == db.read_bytes(),
          "the collected batches' .sketch differs from phase 5's")
    phase(15, f"(a) {len(groups)} batches of 2 x {GENOME_BP} bp submitted "
              f"under set_sync_debug_mode('error') (live: .item() raised) in "
              f"{submit_s * 1e3:.3f} ms, K1 and the encode kernel launched "
              f"{len(groups)} times each, no host read of the card; "
              f"collected in reverse order in "
              f"{collect_s * 1e3:.3f} ms; each equals sketch_batch of its "
              f"group, and the .sketch equals phase 5's byte for byte")

    # (b) capacity retries at collect, card against CPU
    rng = np.random.default_rng(SEED + 15)
    cases = (
        ("cell cap, phase 6's scaled=50 batch", SketchParams(scaled=50),
         [read_genome_packed(tmp / "ladder" / n)
          for n in ("repeat.fna", "plain.fna")], "cell_cap"),
        ("compaction width, a 64-code unit repeated to 300,000 bp", p,
         [packed_from_codes(width_repeat(rng, p, 300_000)),
          read_genome_packed(tmp / "ladder" / "plain.fna")], "width"),
    )
    for label, params, genomes, kind in cases:
        card = Sketcher(params, device=DEVICE)
        hash_packed_rows.launches = 0
        a = card.collect_batch(card.submit_batch_packed(genomes))
        launches = hash_packed_rows.launches
        b = Sketcher(params, device="cpu").sketch_batch(genomes)
        check(card.retries[kind] >= 1, f"{label}: no {kind} retry")
        check(same_results(a, b), f"{label}: card != CPU after the retry")
        phase(15, f"(b) {label}: retries {dict(card.retries)}, K1 launches "
                  f"{launches}; n_hashes {[r['n_hashes'] for r in a]}; hv, "
                  f"norm2 and n_hashes equal the CPU's")

    # (c) depth: 128 genomes, 16 files under 8 names each
    d = tmp / "depth"
    d.mkdir()
    for c in range(DEPTH_COPIES):
        for n in names:
            (d / f"c{c}_{Path(n).name}").symlink_to(n)
    paths = sorted(d.iterdir())
    sk = Sketcher(p, device=DEVICE)
    t0 = time.monotonic()
    sk.sketch_files(paths, progress=False, pipeline_depth=3)  # warm-up
    phase(15, f"(c) warm-up at depth 3: {time.monotonic() - t0:.4f} s")
    runs = {1: [], 3: []}
    k1 = {1: set(), 3: set()}
    enc = {1: set(), 3: set()}
    sketches = set()
    for depth in (1, 3) * DEPTH_RUNS:
        hash_packed_rows.launches = encode_hv_i16.launches = 0
        t0 = time.monotonic()
        fs = sk.sketch_files(paths, progress=False, pipeline_depth=depth)
        wall = time.monotonic() - t0
        k1[depth].add(hash_packed_rows.launches)
        enc[depth].add(encode_hv_i16.launches)
        host, parts = dict(sk.last_stage_times), dict(sk.last_part_times)
        out = tmp / "p15c.sketch"
        dump_sketch(fs, out)
        sketches.add(out.read_bytes())
        runs[depth].append(wall)
        phase(15, f"(c) depth {depth}: {len(paths)} genomes in {wall:.4f} s, "
                  f"{len(paths) / wall:.3f} genomes/s, K1 launches "
                  f"{hash_packed_rows.launches}, encode launches "
                  f"{encode_hv_i16.launches}; "
                  + stage_text("", wall, host, parts))
        check(abs(sum(host.values()) / wall - 1) <= STAGE_SUM_TOLERANCE,
              f"depth {depth}: the host stages sum to "
              f"{sum(host.values()):.4f} s of a {wall:.4f} s wall")
    check(len(sketches) == 1, "the .sketch bytes differ across depths or runs")
    check(len(k1[1]) == 1 and k1[1] == k1[3], f"K1 launches vary: {k1}")
    check(enc == k1, f"encode launches {enc} differ from K1's {k1}")
    med = {dep: statistics.median(r) for dep, r in runs.items()}
    phase(15, f"(c) {len(paths)} x {GENOME_BP} bp, median wall: depth 1 "
              f"{med[1]:.4f} s, depth 3 {med[3]:.4f} s (depth 3 / depth 1 "
              f"{med[3] / med[1]:.3f}); .sketch bytes identical across "
              f"{2 * DEPTH_RUNS} runs")
    on = f"sketch_files of {len(paths)} x {GENOME_BP} bp at pipeline_depth " \
         f"3 (phase 15)"
    return {"k1": {"launches_depth3": k1[3].pop(), "launches_depth3_on": on},
            "encode": {"launches_depth3": enc[3].pop(),
                       "launches_depth3_on": on}}


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--encode-baseline", type=Path, metavar="SRC.cu",
                    help="another version of the encode kernel, with the C "
                         "interface of its first version, to hold to the "
                         "plain version and time in turns with the kernel "
                         "in phase 16 (see encode_baseline)")
    cli = ap.parse_args()
    t_start = time.monotonic()
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
    # sources, both compilers at once; the kernels' resources at k=21
    from hypergen_tpu_torch.io import fastx
    from hypergen_tpu_torch.ops.kernels import build

    t0 = time.monotonic()
    with ThreadPoolExecutor(max_workers=3) as pool:
        libs = list(pool.map(build.build,
                             ("hash_kernel", "encode_kernel", "fastx")))
    phase(2, f"built {', '.join(lib.name for lib in libs)} in "
             f"{time.monotonic() - t0:.2f} s; FASTA parser: {fastx.parser()}")
    lib = build.load("hash_kernel")
    for name, chunks in (("K1", False), ("K2", True)):
        phase(2, f"{name} at k=21, t1ha2: "
                 f"{kernel_resources(lib, chunks, 21)}")
    phase(2, f"encode kernel: {encode_resources()}")

    worst, (args, kw) = kernel_vs_plain(torch)

    # 4. K1 alone, through its wrapper, and plain, at the production shape
    k1_ms, k1_wrapper_ms, plain_ms = k1_times(torch, args, kw)
    words, n_pos, nc = args[:3]
    k1_b = k1_bound(words, n_pos, nc, args[4], kw["cap"], kw["cells"])
    phase(4, f"K1 at {words.shape[0]} rows x {nc} chunks x {CHUNK}: kernel "
             f"alone {k1_ms:.4f} ms, wrapper {k1_wrapper_ms:.4f} ms, plain "
             f"{plain_ms:.4f} ms (median of 12, CUDA events); bound "
             f"{k1_b[0]:.4f} ms by {k1_b[1]}")

    k2_err, (k2_args, k2_kw) = k2_vs_plain(torch)

    # 8. K2 alone, through its wrapper, and plain, K2_CHUNKS chunks
    k2_small = k2_times(torch, k2_args, k2_kw)
    small_bound = bound(*k2_work(torch, k2_args[0], k2_args[1]))
    phase(8, f"K2 at {K2_CHUNKS} chunks x {CHUNK}: kernel alone "
             f"{k2_small[0]:.4f} ms, wrapper {k2_small[1]:.4f} ms, plain "
             f"{k2_small[2]:.4f} ms (median of 12, CUDA events); bound "
             f"{small_bound[0]:.4f} ms by {small_bound[1]}")

    with tempfile.TemporaryDirectory(prefix="hg_smoke_") as tmp:
        genomes, launches, enc_launches = main_path(torch, Path(tmp))
        card_vs_cpu(Path(tmp), genomes)
        huge = huge_genome(torch, Path(tmp))
        huge_card_vs_cpu(torch, Path(tmp))

        # 16. the encode kernel against its plain version at the step's,
        # the one-row step's and the tiled route's shapes, and the wraps
        enc = encode_vs_plain(torch, Path(tmp), cli.encode_baseline and
                              encode_baseline(torch, cli.encode_baseline))

        # 12. the database path: search, dist, the dot, .hgdb and hist
        from hypergen_tpu_torch.cli import _load_db

        one_proc = {}
        db = database_search(torch, Path(tmp), _load_db(Path(tmp) / "db.sketch"),
                             one_proc)
        dot_timings(torch, db)
        del db
        hgdb_cli(torch, Path(tmp), one_proc)

        # 13. the pod: sketch with --resume, dist and search, one process
        # per card, on phase 12's files
        pod(torch, Path(tmp), one_proc)

        # 14. the stage table on the card, and a genome above 2^31 bp
        stage_table(torch, Path(tmp), genomes)
        p4 = p4_genome(torch, Path(tmp))

        # 15. the pipelined sketch: submit without a host read, retries at
        # collect, sketch_files at depth 1 and 3
        p15 = pipelined(torch, Path(tmp))

    check("jax" not in sys.modules, "jax was imported")
    leaked = sorted(m for m in sys.modules if m.startswith("hypergen_tpu")
                    and not m.startswith("hypergen_tpu_torch"))
    check(not leaked, f"modules of the JAX package were imported: {leaked}")
    phase(11, f"imports: no jax, nothing of hypergen_tpu; the script took "
              f"{time.monotonic() - t_start:.1f} s")
    k1_one = huge["k1_one_row"]
    k2 = huge["k2"]
    print(json.dumps({"kernels": [{
        "name": "hash_packed_rows", "route": "cuda", "source": SOURCE,
        "replaces": K1_REPLACES, "launches": launches,
        "launches_on": "CLI sketch + dist of 16 genomes (phase 5)",
        "max_abs_err": max(worst, huge["k1_err"]), "ms": k1_ms,
        "wrapper_ms": k1_wrapper_ms, "plain_ms": plain_ms,
        "bound_ms": k1_b[0], "bound_by": k1_b[1], "library_ms": None,
        "one_row": {"shape": "1 x 1024 chunks (2^27 bp)", **k1_one},
        "launches_2_31": {k: v[0] for k, v in p4.items()},
        **p15["k1"],
    }, {
        "name": "hash_chunks", "route": "cuda", "source": SOURCE,
        "replaces": K2_REPLACES, "launches": huge["k2_launches"],
        "launches_on": f"{K2_ROUTE}, 2^27 bp genome (phase 9)",
        "max_abs_err": max(k2_err, huge["k2_err"]), "ms": k2["ms"],
        "wrapper_ms": k2["wrapper_ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
        "library_ms": None,
        "launches_2_31": {k: v[1] for k, v in p4.items()},
    }, {
        "name": "encode_hv_i16", "route": "cuda", "source": ENCODE_SOURCE,
        "replaces": ENCODE_REPLACES, "launches": enc_launches,
        "launches_on": "CLI sketch + dist of 16 genomes (phase 5)",
        "max_abs_err": enc["max_abs_err"], "ms": enc["a"]["ms"],
        "wrapper_ms": enc["a"]["wrapper_ms"], "plain_ms": enc["a"]["plain_ms"],
        "bound_ms": enc["a"]["bound_ms"], "bound_by": enc["a"]["bound_by"],
        "library_ms": None,
        "one_row": enc["b"], "tiled_2_31": enc["c"],
        "launches_2_31": {k: v[2] for k, v in p4.items()},
        **p15["encode"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
