"""Inputs made from the seed: the genome pool (as FASTA files or as codes
held in memory) and the search database with its queries.

Each generator takes the configuration's and the mix's parameters and a
seed, and makes the same inputs for the same seed. The set of sizes does
not depend on the seed: genome lengths, contig counts, N runs and
soft-masked genomes are fixed quantiles of the configuration's
distributions, so every seed does the same work; the seed draws the bases,
where the contigs are cut, where the runs and the masked stretch lie, the
database's values, the queries and the orders of arrival.

Random bases and database values are made with a ``torch.Generator`` on the
given device, in a few large calls.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
from pathlib import Path
from typing import List

import numpy as np
import torch

INVALID = 4  # the code of a base that no k-mer may hold
_ASCII = np.frombuffer(b"ACGT", dtype=np.uint8)
_LINE = ord("\n")


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for one purpose of one seed."""
    return np.random.default_rng([seed & (2**63 - 1), *stream])


def _torch_gen(seed: int, device, stream: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(rng(seed, stream).integers(0, 2**63 - 1)))
    return g


# -- the genome pool -----------------------------------------------------------

@dataclasses.dataclass
class Genome:
    """One generated genome: its contigs' codes (0-3 bases, INVALID for an
    N) and which stretch of it is written in lower case."""

    name: str
    contigs: List[np.ndarray]
    masked: tuple  # (start, end) in genome coordinates, or ()

    @property
    def bases(self) -> int:
        return sum(c.size for c in self.contigs)

    def codes(self) -> np.ndarray:
        """The genome as one code array, contigs joined by one INVALID
        code, so that no k-mer spans two contigs."""
        parts = []
        for i, c in enumerate(self.contigs):
            if i:
                parts.append(np.array([INVALID], np.uint8))
            parts.append(c)
        return np.concatenate(parts)


def pool_sizes(pool: dict) -> List[tuple]:
    """The pool's fixed set of (bp, contigs, n_runs, masked): bp at the
    log-normal's quantiles (i + 1/2) / n, clipped; contig counts at the
    log-uniform's quantiles; run counts spread evenly over their range; a
    soft-masked stretch in every tenth genome. Paired by a fixed shuffle,
    the same for every seed."""
    n = pool["genomes"]
    a = pool["assumed"]
    size, cont, runs = a["genome_bp"], a["contigs"], a["n_runs"]
    nd = statistics.NormalDist(math.log(size["median"]), size["log_sd"])
    bp = [int(min(max(math.exp(nd.inv_cdf((i + 0.5) / n)), size["min"]),
                  size["max"])) for i in range(n)]
    lo, hi = math.log(cont["min"]), math.log(cont["max"])
    contigs = [int(round(math.exp(lo + (hi - lo) * (i + 0.5) / n)))
               for i in range(n)]
    n_runs = [runs["min"] + i * (runs["max"] - runs["min"] + 1) // n
              for i in range(n)]
    every = round(1 / a["soft_masked_share"])
    fixed = np.random.default_rng(0)
    contigs = [contigs[i] for i in fixed.permutation(n)]
    n_runs = [n_runs[i] for i in fixed.permutation(n)]
    masked = [i % every == 0 for i in fixed.permutation(n)]
    return list(zip(bp, contigs, n_runs, masked))


def make_pool(pool: dict, seed: int, device) -> List[Genome]:
    """The genome pool of a configuration: random bases made on ``device``
    in one call, cut into contigs of at least ``contigs.min_bp``, with N
    runs and at most one lower-case stretch."""
    sizes = pool_sizes(pool)
    a = pool["assumed"]
    total = sum(s[0] for s in sizes)
    gen = _torch_gen(seed, device, 1)
    allc = torch.randint(0, 4, (total,), generator=gen, dtype=torch.uint8,
                         device=device).cpu().numpy()
    draw = rng(seed, 2)
    out, at = [], 0
    min_bp = a["contigs"]["min_bp"]
    run_lo, run_hi = a["n_runs"]["min_bp"], a["n_runs"]["max_bp"]
    for i, (bp, n_contigs, n_runs, masked) in enumerate(sizes):
        codes = allc[at : at + bp]
        at += bp
        for s, ln in zip(draw.integers(0, bp - run_hi, n_runs),
                         draw.integers(run_lo, run_hi + 1, n_runs)):
            codes[s : s + ln] = INVALID
        n_contigs = max(1, min(n_contigs, bp // min_bp))
        # contig lengths: min_bp each plus a random share of the rest
        w = draw.random(n_contigs) ** 2 + 1e-3
        extra = np.floor(w / w.sum() * (bp - n_contigs * min_bp)).astype(np.int64)
        extra[0] += bp - n_contigs * min_bp - int(extra.sum())
        cuts = np.cumsum(extra + min_bp)[:-1]
        mask = ()
        if masked:
            ln = int(draw.integers(bp // 100, bp // 10))
            s = int(draw.integers(0, bp - ln))
            mask = (s, s + ln)
        out.append(Genome(f"g{i:03d}", np.split(codes, cuts), mask))
    return out


def fasta_bytes(g: Genome, width: int) -> bytes:
    """The genome as FASTA: one record a contig, lines of ``width`` bases,
    N for an invalid base, the masked stretch in lower case."""
    parts = []
    at = 0
    for j, c in enumerate(g.contigs):
        seq = np.where(c == INVALID, ord("N"), _ASCII[np.minimum(c, 3)]).astype(
            np.uint8)
        if g.masked:
            s, e = max(g.masked[0] - at, 0), min(g.masked[1] - at, c.size)
            if s < e:
                seq[s:e] |= 0x20
        at += c.size
        n_full = seq.size // width
        body = np.empty((n_full, width + 1), np.uint8)
        body[:, :width] = seq[: n_full * width].reshape(n_full, width)
        body[:, width] = _LINE
        tail = seq[n_full * width :]
        parts.append(f">{g.name}_c{j} synthetic contig\n".encode())
        parts.append(body.tobytes())
        if tail.size:
            parts.append(tail.tobytes() + b"\n")
    return b"".join(parts)


def write_pool(genomes: List[Genome], d: Path, width: int) -> List[Path]:
    """One plain .fna file a genome under d; returns their paths."""
    d.mkdir(parents=True, exist_ok=True)
    paths = []
    for g in genomes:
        p = d / f"{g.name}.fna"
        p.write_bytes(fasta_bytes(g, width))
        paths.append(p)
    return paths


# -- the search database ---------------------------------------------------------

@dataclasses.dataclass
class Rows:
    """Sketch rows as a .hgdb holds them."""

    names: List[str]
    hvs: np.ndarray  # int16 [n, D]
    norms: np.ndarray  # int32 [n], wrapping sum of squares


def norms_i32(hv: torch.Tensor) -> torch.Tensor:
    """Wrapping int32 sum of squares of each int16 row."""
    x = hv.to(torch.int64)
    s = (x * x).sum(-1) & 0xFFFFFFFF
    return torch.where(s >= 2**31, s - 2**32, s).to(torch.int32)


def make_database(db: dict, mix: dict, seed: int, device):
    """(database Rows, query Rows). Rows are families of ``family`` near
    copies of a shared Gaussian S: member i = sqrt(1 - p_i) S + sqrt(p_i)
    E_i with p_i uniform in [p_min, p_max] and S, E_i of standard deviation
    ``sigma``, rounded to int16. Queries: ``self_queries`` database rows
    (which must find themselves at 100) and new members of random
    families."""
    rows, fam_size, D = db["rows"], db["family"], db["sketch"]["hv_d"]
    sigma = db["assumed"]["sigma"]
    p_lo, p_hi = db["assumed"]["p_min"], db["assumed"]["p_max"]
    n_fam = rows // fam_size
    gen = _torch_gen(seed, device, 3)
    shared = torch.randn((n_fam, D), generator=gen, device=device) * sigma

    def members(fam: torch.Tensor) -> torch.Tensor:
        p = torch.rand((fam.numel(), 1), generator=gen, device=device)
        p = p * (p_hi - p_lo) + p_lo
        hv = shared[fam] * (1 - p).sqrt()
        hv += torch.randn((fam.numel(), D), generator=gen, device=device) * (
            sigma * p.sqrt())
        return hv.round_().to(torch.int16)

    block = 1 << 14
    fam_ids = torch.arange(n_fam, device=device).repeat_interleave(fam_size)
    hv = torch.empty((rows, D), dtype=torch.int16)
    norms = torch.empty((rows,), dtype=torch.int32)
    for i in range(0, rows, block):
        m = members(fam_ids[i : i + block])
        hv[i : i + m.shape[0]] = m.cpu()
        norms[i : i + m.shape[0]] = norms_i32(m).cpu()
    names = [f"fam{f:05d}_m{j:02d}" for f in range(n_fam)
             for j in range(fam_size)]
    draw = rng(seed, 4)
    n_q, n_self = mix["queries"], mix["self_queries"]
    self_rows = np.sort(draw.choice(rows, n_self, replace=False))
    q_fam = draw.integers(0, n_fam, n_q - n_self)
    new = members(torch.from_numpy(q_fam).to(device))
    hv, norms = hv.numpy(), norms.numpy()
    q_hv = np.concatenate([hv[self_rows], new.cpu().numpy()])
    q_norms = np.concatenate([norms[self_rows],
                              norms_i32(new).cpu().numpy()])
    q_names = [names[r] for r in self_rows] + [
        f"query{j:04d}_fam{f:05d}" for j, f in enumerate(q_fam)]
    return (Rows(names, hv, norms),
            Rows(q_names, q_hv, q_norms))


# -- the .hgdb format (hgdb-v1), written and read here without the program --

def write_hgdb(rows: Rows, out: Path, sketch: dict, n_shards: int) -> None:
    """An .hgdb directory: manifest.json and one pair of .npy files a
    shard, rows split as evenly as ``sketch -o X.hgdb --shards n`` splits
    them."""
    out.mkdir(parents=True, exist_ok=True)
    n = len(rows.names)
    bounds = [round(i * n / n_shards) for i in range(n_shards + 1)]
    shards = []
    for i in range(n_shards):
        a, b = bounds[i], bounds[i + 1]
        np.save(out / f"shard_{i:05d}_hv.npy", rows.hvs[a:b])
        np.save(out / f"shard_{i:05d}_norm.npy", rows.norms[a:b])
        shards.append({"id": i, "rows": [a, b], "hv": f"shard_{i:05d}_hv.npy",
                       "norm": f"shard_{i:05d}_norm.npy"})
    manifest = {
        "format": "hgdb-v1", "ksize": sketch["ksize"],
        "scaled": sketch["scaled"], "canonical": sketch["canonical"],
        "seed": sketch["seed"], "hv_d": sketch["hv_d"],
        "sketch_method": sketch["sketch_method"], "n_genomes": n,
        "names": list(rows.names), "resolved_names": list(rows.names),
        "shards": shards,
    }
    (out / "manifest.json").write_text(json.dumps(manifest))


def read_hgdb(path: Path) -> Rows:
    """The rows of an .hgdb directory in row order."""
    manifest = json.loads((path / "manifest.json").read_text())
    shards = sorted(manifest["shards"], key=lambda s: s["rows"][0])
    D = manifest["hv_d"]
    hv = [np.load(path / s["hv"]) for s in shards]
    nm = [np.load(path / s["norm"]) for s in shards]
    return Rows(list(manifest["names"]),
                np.concatenate(hv) if hv else np.zeros((0, D), np.int16),
                np.concatenate(nm) if nm else np.zeros((0,), np.int32))
