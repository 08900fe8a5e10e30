"""The port's pod paths (parallel.mesh, the pod branches of the CLI and
multihost_topk_search) against the JAX package's, on the CPU.

The port's pods are real processes: two ranks of ``python -m
hypergen_tpu_torch.cli`` (or of a worker that calls the CLI's ``main`` for
several steps in one process group), started with the HG_* variables over
gloo and ``-D cpu``. Every launch has a timeout, and the group and the part
merges have short ones, so a dead rank fails the test instead of hanging
the suite. The JAX side runs its pod functions in this process, one process
id after the other (process 1 writes its part, then process 0 writes its
own and merges), with ``jax.process_index``, ``jax.process_count`` and the
run token patched.

Tolerance: every file and TSV byte-identical; the search arrays equal to
the port's one-process sharded search over the same 8 shards, and to the
JAX package's over 8 virtual devices with equal indices, dots and -inf
slots (the float32 device ANI within 1e-4, as tests/test_torch_search.py
holds it: XLA's log and PyTorch's differ in the last bits).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from hypergen_tpu import cli as jcli
from hypergen_tpu.parallel import mesh as jmesh
from hypergen_tpu.parallel import search as jsearch
from hypergen_tpu.params import DistParams as JDistParams
from hypergen_tpu_torch import cli as tcli
from hypergen_tpu_torch.io import sketch_db as tdb
from hypergen_tpu_torch.models import sketcher as tsketcher
from hypergen_tpu_torch.parallel import mesh as tmesh
from hypergen_tpu_torch.parallel import search as tsearch
from hypergen_tpu_torch.params import DistParams, SketchParams

ROOT = Path(__file__).resolve().parent.parent
TOKEN = "0123456789abcdef"
LAUNCH_TIMEOUT_S = 150
SKETCH = ["-s", "30", "-d", "512", "-D", "cpu"]
DIST_CASES = [("hgdb", "60"), ("hgdb", "30"), ("sketch", "60")]

# A pod worker: starts the group from the HG_* variables, runs each step
# (a CLI argv, or a multihost_topk_search case whose result every rank
# saves), and tears the group down.
_STEPS = """
import json, sys
import numpy as np
from hypergen_tpu_torch.cli import main
from hypergen_tpu_torch.parallel import mesh
from hypergen_tpu_torch.parallel.search import multihost_topk_search
mesh.maybe_init_distributed("cpu")
try:
    for step in json.loads(open(sys.argv[1]).read()):
        if "cli" in step:
            main(step["cli"])
            continue
        q = np.load(step["q"])
        res = multihost_topk_search(step["db"], q["hv"], q["norm"], 21,
                                    step["k"], ["cpu"] * 4, step["mode"])
        np.savez(step["out"] % mesh.process_index(), ani=res[0], idx=res[1],
                 dot=res[2])
finally:
    mesh.finalize()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(pid: int, n: int, port: int) -> dict:
    env = dict(os.environ)
    env.pop("HG_DIST", None)
    env.update(
        HG_NUM_PROCESSES=str(n), HG_PROCESS_ID=str(pid),
        HG_COORDINATOR=f"localhost:{port}", HG_DIST_TIMEOUT_S="60",
        HG_PART_STALL_S="60", OMP_NUM_THREADS="1",
        PYTHONPATH=str(ROOT) + os.pathsep + env.get("PYTHONPATH", ""),
    )
    return env


def _start(argv, n: int = 2):
    """Start the n ranks of a pod running argv (a CLI argv, or ["-c",
    code, ...])."""
    port = _free_port()
    cmd = [sys.executable] + (argv if argv[0] == "-c" else
                              ["-m", "hypergen_tpu_torch.cli", *argv])
    return [subprocess.Popen(cmd, env=_env(pid, n, port), cwd=ROOT,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
            for pid in range(n)]


def _wait(procs, ok: bool = True):
    """Each rank's output, once every rank has exited with 0 (ok) or
    non-zero (not ok); a rank still running after LAUNCH_TIMEOUT_S is
    killed and fails the test."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=LAUNCH_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert (p.returncode == 0) == ok, (
            f"rank {pid} exited {p.returncode}:\n{out[-4000:]}")
    return outs


def _jax_pod(n: int, fn) -> None:
    """fn() as JAX process n - 1, ..., 0 in turn, with a fixed run token."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmesh, "shared_run_token", lambda: TOKEN)
        mp.setattr(jax, "process_count", lambda: n)
        for pid in reversed(range(n)):
            mp.setattr(jax, "process_index", lambda pid=pid: pid)
            fn()


def _files(d: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def _write_genomes(d: Path, lo: int, hi: int) -> None:
    rng = np.random.default_rng(12 + lo)
    for i in range(lo, hi):
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=3000)
        (d / f"g{i}.fna").write_bytes(b">g\n" + seq.tobytes() + b"\n")


def _dist_db(root: Path) -> dict:
    """The M = 31, D = 256 near-copy database of the JAX package's pod dist
    test, as an .hgdb of 3 shards and as a .sketch. Returns {kind: path}."""
    rng = np.random.default_rng(41)
    M, D = 31, 256
    base = rng.integers(-25, 25, size=(1, D)).astype(np.int16)
    hv = base + rng.integers(-3, 4, size=(M, D)).astype(np.int16)
    norms = np.sum(hv.astype(np.int64) ** 2, axis=1).astype(np.int32)
    db = tdb.ShardedDB(ksize=21, scaled=30, canonical=True, seed=123,
                       hv_d=D, names=[f"g{i}" for i in range(M)], hvs=hv,
                       norms=norms)
    tdb.dump_sharded_db(db, root / "db.hgdb", n_shards=3)
    tdb.dump_sketch([tdb.FileSketch.from_dense(hv[i], int(norms[i]), f"g{i}",
                                               21, 30, True, 123)
                     for i in range(M)], root / "db.sketch")
    return {"hgdb": root / "db.hgdb", "sketch": root / "db.sketch"}


def _search_db(seed: int, dup: bool):
    """A 53-row (not a multiple of 8 shards of 7) D = 128 DB and 6 queries.
    dup: rows 7, 27, 28 and 50 are copies of row 6 (ties across the shard
    boundary 6|7 and the process boundary 27|28), and query 0 is row 6."""
    rng = np.random.default_rng(seed)
    hv = rng.integers(-30, 30, size=(53, 128)).astype(np.int16)
    if dup:
        hv[[7, 27, 28, 50]] = hv[6]
    norms = np.sum(hv.astype(np.int64) ** 2, axis=1).astype(np.int32)
    q = hv[[6, 0, 1, 2, 3, 4]] if dup else hv[:6]
    return hv, norms, q.copy(), norms[[6, 0, 1, 2, 3, 4] if dup else
                                      slice(0, 6)].copy()


# (seed, duplicated rows, k, mode): k 9 is past a shard's 7 rows; with the
# copies, k 3 cuts the five-way tie at 100 between rows 27 and 28
SEARCH_CASES = [(3, False, 3, None), (3, False, 9, None), (5, True, 3, None),
                (5, True, 4, None), (5, True, 9, True)]


@pytest.fixture(scope="module")
def pod(tmp_path_factory):
    """Every pod run of the module: the port's in subprocesses, overlapped
    with the JAX package's in this process."""
    root = tmp_path_factory.mktemp("torch_pod")
    genomes = root / "genomes"
    genomes.mkdir()
    res = {"root": root, "hgdb": []}

    # pod sketch into .hgdb: 5 genomes, --resume after 3 more, --resume
    # after 1 more (rank 1 then publishes an empty part)
    for step, (lo, hi) in enumerate([(0, 5), (5, 8), (8, 9)]):
        _write_genomes(genomes, lo, hi)
        extra = ["--resume"] if step else []
        procs = _start(["sketch", "-p", str(genomes), "-o",
                        str(root / "t.hgdb"), *SKETCH, *extra])
        _jax_pod(2, lambda: jcli.main(["sketch", "-p", str(genomes), "-o",
                                       str(root / "j.hgdb"), *SKETCH,
                                       *extra]))
        res["hgdb"].append((_wait(procs), _files(root / "t.hgdb"),
                            _files(root / "j.hgdb")))

    # dist (3 cases), search (.hgdb and .sketch reference) and
    # multihost_topk_search, in one pod launch
    dbs = _dist_db(root)
    steps = []
    for kind, a in DIST_CASES:
        steps.append({"cli": ["dist", "-r", str(dbs[kind]), "-q",
                              str(dbs[kind]), "-o",
                              str(root / f"t_{kind}_{a}.tsv"), "-a", a,
                              "-D", "cpu"]})
    for kind in dbs:
        steps.append({"cli": ["search", "-r", str(dbs[kind]), "-q",
                              str(dbs[kind]), "-o",
                              str(root / f"t_search_{kind}.tsv"),
                              "--top_k", "3", "-a", "60", "-D", "cpu"]})
    for c, (seed, dup, k, mode) in enumerate(SEARCH_CASES):
        hv, norms, q, qn = _search_db(seed, dup)
        d = root / f"search{c}.hgdb"
        if not d.exists():
            tdb.dump_sharded_db(
                tdb.ShardedDB(ksize=21, scaled=30, canonical=True, seed=123,
                              hv_d=128, names=[f"r{i}" for i in range(53)],
                              hvs=hv, norms=norms), d, n_shards=3)
        np.savez(root / f"q{c}.npz", hv=q, norm=qn)
        steps.append({"db": str(d), "q": str(root / f"q{c}.npz"), "k": k,
                      "mode": mode, "out": str(root / f"mh{c}_%d.npz")})
    (root / "steps.json").write_text(json.dumps(steps))
    procs = _start(["-c", _STEPS, str(root / "steps.json")])
    for kind, a in DIST_CASES:
        db = dbs[kind]
        jcli.main(["dist", "-r", str(db), "-q", str(db), "-o",
                   str(root / f"j1_{kind}_{a}.tsv"), "-a", a, "-D", "cpu"])
        dp = JDistParams(path_ref_sketch=db, path_query_sketch=db,
                         out_file=root / f"j_{kind}_{a}.tsv",
                         ani_threshold=float(a))
        _jax_pod(2, lambda: jcli._run_dist_pod(dp, if_sym=True, t0=0.0))
    for kind in dbs:
        jcli.main(["search", "-r", str(dbs[kind]), "-q", str(dbs[kind]),
                   "-o", str(root / f"j_search_{kind}.tsv"), "--top_k", "3",
                   "-a", "60", "-D", "cpu"])
    res["steps"] = _wait(procs)
    return res


@pytest.mark.parametrize("step", [0, 1, 2])
def test_pod_sketch_hgdb_equals_jax_pod(pod, step):
    """Every file of the .hgdb after the pod sketch, after a --resume of 3
    new genomes, and after a --resume of 1 (an empty part from rank 1)."""
    outs, got, want = pod["hgdb"][step]
    assert got == want
    manifest = json.loads(got["manifest.json"])
    n_files = [5, 8, 9][step]
    names = [f"g{i}.fna" for i in range(n_files)]
    shards = {0: [0, 1], 1: [0, 1, 2, 3], 2: [0, 1, 2, 3, 4, 5]}[step]
    assert [sh["id"] for sh in manifest["shards"]] == shards
    # rows: each step's new files in rank order, files[0::2] + files[1::2]
    order, lo = [], 0
    for hi in [5, 8, 9][: step + 1]:
        new = names[lo:hi]
        order += new[0::2] + new[1::2]
        lo = hi
    assert [Path(n).name for n in manifest["names"]] == order
    if step == 2:
        assert manifest["shards"][-1]["rows"] == [9, 9]  # the empty part
    assert not [n for n in got if "part" in n]
    assert any("backend gloo" in o for o in outs)


@pytest.mark.parametrize("kind,ani", DIST_CASES)
def test_pod_dist_tsv_equals_jax(pod, kind, ani):
    root = pod["root"]
    got = (root / f"t_{kind}_{ani}.tsv").read_bytes()
    assert got == (root / f"j_{kind}_{ani}.tsv").read_bytes()
    assert got == (root / f"j1_{kind}_{ani}.tsv").read_bytes()
    assert got.strip(), f"expected pairs above {ani}"
    assert not [p for p in root.iterdir() if ".part" in p.name]


@pytest.mark.parametrize("kind", ["hgdb", "sketch"])
def test_pod_search_tsv_equals_jax_cli(pod, kind):
    root = pod["root"]
    got = (root / f"t_search_{kind}.tsv").read_bytes()
    assert got == (root / f"j_search_{kind}.tsv").read_bytes()
    rows = [r.split("\t") for r in got.decode().splitlines()]
    assert len(rows) == 31 * 3 and all(r[0] == r[1] for r in rows[::3])


@pytest.mark.parametrize("case", range(len(SEARCH_CASES)))
def test_multihost_topk_search_equals_sharded(pod, case):
    """2 processes x ["cpu"] * 4 against the port's topk_search over
    ["cpu"] * 8 (equal arrays) and the JAX package's over 8 devices."""
    seed, dup, k, mode = SEARCH_CASES[case]
    root = pod["root"]
    got = [np.load(root / f"mh{case}_{r}.npz") for r in range(2)]
    got = [tuple(z[n] for n in ("ani", "idx", "dot")) for z in got]
    hv, norms, q, qn = _search_db(seed, dup)
    one = tsearch.topk_search(["cpu"] * 8, hv, norms, q, qn, 21, k, mode)
    for a, b, c in zip(got[0], got[1], one):
        np.testing.assert_array_equal(a, b)  # the same on every process
        np.testing.assert_array_equal(a, c)
    ani, idx, dot = got[0]
    jani, jidx, jdot = (np.asarray(x) for x in jsearch.sharded_topk_search(
        jmesh.make_mesh(8, 1), hv, norms, q, qn, 21, k, use_mxu=mode))
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(dot, jdot)
    np.testing.assert_array_equal(np.isinf(ani), np.isinf(jani))
    np.testing.assert_allclose(ani, jani, rtol=0, atol=1e-4)
    if dup:  # five copies at 100: the lowest rows make the cut, in order
        np.testing.assert_array_equal(idx[0, : min(k, 5)],
                                      [6, 7, 27, 28, 50][: min(k, 5)])


@pytest.mark.parametrize("n_local", [1, 2])
def test_multihost_topk_search_one_process_tiles(tmp_path, monkeypatch,
                                                 n_local):
    """One process (no group): with the pair budget shrunk, its block of
    1,100 rows runs in row tiles of 256 rows a device, and the arrays equal
    the untiled search's, from a ShardedDB and from an .hgdb."""
    rng = np.random.default_rng(7)
    hv = rng.integers(-30, 30, size=(1100, 64)).astype(np.int16)
    hv[[300, 700, 1099]] = hv[5]  # ties at 100 across the tiles
    norms = np.sum(hv.astype(np.int64) ** 2, axis=1).astype(np.int32)
    q, qn = hv[[5, 0, 600]].copy(), norms[[5, 0, 600]].copy()
    db = tdb.ShardedDB(ksize=21, scaled=30, canonical=True, seed=123,
                       hv_d=64, names=[f"r{i}" for i in range(1100)],
                       hvs=hv, norms=norms)
    tdb.dump_sharded_db(db, tmp_path / "r.hgdb", n_shards=3)
    devs = ["cpu"] * n_local
    want = tsearch.topk_search(devs, hv, norms, q, qn, 21, 4)
    tiles = []
    orig = tsearch._block_candidates
    monkeypatch.setattr(tsearch, "_block_candidates",
                        lambda *a: tiles.append(a[3:5]) or orig(*a))
    monkeypatch.setattr(tsearch, "PAIRS_PER_DEVICE_TILE_LIMIT", 1)
    for ref in (db, tmp_path / "r.hgdb"):
        tiles.clear()
        got = tsearch.multihost_topk_search(ref, q, qn, 21, 4, devs)
        assert len(tiles) == (5 if n_local == 1 else 3)
        assert sum(rows for _, rows in tiles) == 1100
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(want[1][0], [5, 300, 700, 1099])


def test_pod_logs_row_ranges(pod):
    """Each search rank logs its own DB rows: disjoint, covering [0, M)."""
    ranges = []
    for out in pod["steps"]:
        ranges += [line.split("holds DB rows ")[1].split(" of ")[0]
                   for line in out.splitlines() if "holds DB rows" in line]
    assert "[0, 28)" in ranges and "[28, 53)" in ranges  # 8 shards of 7


def _mk_db(tmp_path, n=6, d=256):
    rng = np.random.default_rng(0)
    base = rng.integers(-30, 30, size=(1, d)).astype(np.int16)
    hvs = base + rng.integers(-3, 4, size=(n, d)).astype(np.int16)
    norms = np.sum(hvs.astype(np.int64) ** 2, axis=1).astype(np.int32)
    out = tmp_path / "db.hgdb"
    tdb.dump_sharded_db(tdb.ShardedDB(
        ksize=21, scaled=30, canonical=True, seed=123, hv_d=d,
        names=[f"g{i}.fna" for i in range(n)], hvs=hvs, norms=norms),
        out, n_shards=2)
    return out


class _Args:
    def __init__(self, r, q, out, ani_th, device="cpu"):
        self.path_r, self.path_q, self.out = r, q, out
        self.ani_th, self.ksize, self.hv_d, self.device = ani_th, 21, 256, \
            device


def test_pod_merge_matches_plain_dist(tmp_path):
    """The pod dist's part write, merge and streamed TSV in one process
    without a group equal run_dist."""
    db = _mk_db(tmp_path)
    tcli.run_dist(_Args(db, db, tmp_path / "plain.tsv", 0.0))
    dp = DistParams(path_ref_sketch=db, path_query_sketch=db,
                    out_file=tmp_path / "pod.tsv", ani_threshold=0.0)
    tcli._run_dist_pod(dp, if_sym=True, t0=0.0, device="cpu")
    plain = (tmp_path / "plain.tsv").read_text()
    assert (tmp_path / "pod.tsv").read_text() == plain
    assert plain.count("\n") == 15  # 6 * 5 / 2 pairs


def test_pod_merge_top_k(tmp_path):
    """top_k caps the (descending) rows at exactly k, in the pod merge and
    through run_dist's library argument."""
    db = _mk_db(tmp_path)
    dp = DistParams(path_ref_sketch=db, path_query_sketch=db,
                    out_file=tmp_path / "pod_topk.tsv", ani_threshold=0.0,
                    top_k=4)
    tcli._run_dist_pod(dp, if_sym=True, t0=0.0, device="cpu")
    tcli.run_dist(_Args(db, db, tmp_path / "topk.tsv", 0.0), top_k=4)
    tcli.run_dist(_Args(db, db, tmp_path / "full.tsv", 0.0))
    full = (tmp_path / "full.tsv").read_text().splitlines()
    assert (tmp_path / "pod_topk.tsv").read_text().splitlines() == full[:4]
    assert (tmp_path / "topk.tsv").read_text().splitlines() == full[:4]


def test_pod_sketch_to_a_sketch_file_exits(tmp_path):
    (tmp_path / "g").mkdir()
    _write_genomes(tmp_path / "g", 0, 1)
    outs = _wait(_start(["sketch", "-p", str(tmp_path / "g"), "-o",
                         str(tmp_path / "x.sketch"), *SKETCH]), ok=False)
    assert all("requires an .hgdb output" in o for o in outs)
    assert not (tmp_path / "x.sketch").exists()


def test_unreachable_coordinator_fails_within_its_timeout(tmp_path):
    """Rank 1 of 2 with no coordinator listening exits non-zero once the
    group's timeout passes; it never runs on as one process."""
    (tmp_path / "g").mkdir()
    _write_genomes(tmp_path / "g", 0, 1)
    env = _env(1, 2, _free_port())
    env["HG_DIST_TIMEOUT_S"] = "3"
    out = subprocess.run(
        [sys.executable, "-m", "hypergen_tpu_torch.cli", "sketch", "-p",
         str(tmp_path / "g"), "-o", str(tmp_path / "x.hgdb"), *SKETCH],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=90)
    assert out.returncode != 0
    assert not (tmp_path / "x.hgdb").exists()


@pytest.mark.parametrize("device,local,cards,want", [
    ("cuda", 4, 4, "nccl"), ("cuda", 1, 8, "nccl"), ("cuda", 2, 1, "gloo"),
    ("cuda", 4, 2, "gloo"), ("cpu", 2, 0, "gloo"), ("cpu", 2, 8, "gloo"),
])
def test_backend_follows_the_layout(device, local, cards, want):
    assert tmesh.choose_backend(device, local, cards) == want


def test_own_card(monkeypatch):
    """LOCAL_RANK, else the process id, modulo the host's cards."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert tmesh._own_card(3) == torch.device("cuda", 1)
    monkeypatch.setenv("LOCAL_RANK", "2")
    assert tmesh._own_card(3) == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tmesh._own_card(1) == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError):
        tmesh._own_card(0)


def test_one_process_starts_no_group(monkeypatch):
    for var in ("HG_NUM_PROCESSES", "HG_DIST"):
        monkeypatch.delenv(var, raising=False)
    assert tmesh.maybe_init_distributed("cpu") is False
    assert not torch.distributed.is_initialized()
    assert (tmesh.process_index(), tmesh.process_count()) == (0, 1)
    assert len(tmesh.shared_run_token()) == 16


def test_pod_sketcher_gets_its_own_card_only(tmp_path, monkeypatch):
    """_run_sketch_pod hands the Sketcher rank 1's card, and only that card
    for a huge genome's sequence-parallel route."""
    seen = []

    class Recorder(tsketcher.Sketcher):
        def sketch_files(self, paths):
            seen.append((self.device, self.seqpar_devices, list(paths)))
            return []

    monkeypatch.setattr(tsketcher, "Sketcher", Recorder)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setattr(tmesh, "process_index", lambda: 1)
    monkeypatch.setattr(tmesh, "process_count", lambda: 2)
    monkeypatch.setattr(tmesh, "shared_run_token", lambda: TOKEN)
    args = tcli.build_parser().parse_args(
        ["sketch", "-p", str(tmp_path), "-o", str(tmp_path / "x.hgdb")])
    files = [tmp_path / f"g{i}.fna" for i in range(3)]
    tcli._run_sketch_pod(SketchParams(), files, args)
    card = torch.device("cuda", 1)
    assert seen == [(card, [card], files[1::2])]
    assert (tmp_path / "x.hgdb" / f"manifest.part00001.{TOKEN}.json").exists()


@pytest.mark.parametrize("seqpar_devices,route", [
    (None, "seqpar"), (["cuda:1"], "tiled"), (["cuda:0", "cuda:1"], "seqpar"),
])
def test_huge_genome_route_stays_on_the_given_cards(monkeypatch,
                                                    seqpar_devices, route):
    """A genome the one-row batch cannot take is split over seqpar_devices
    (default every card) only when they are several; one card tiles."""
    from hypergen_tpu_torch.parallel import seqpar

    calls = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(tsketcher.Sketcher, "_one_row_fits",
                        lambda self, n: False)
    monkeypatch.setattr(tsketcher.Sketcher, "sketch_packed_tiled",
                        lambda self, g: calls.append(("tiled", None)))
    monkeypatch.setattr(seqpar, "sketch_codes_seqpar",
                        lambda codes, p, devs, chunk_positions: calls.append(
                            ("seqpar", [str(d) for d in devs])))
    sk = tsketcher.Sketcher(SketchParams(), device="cuda",
                            seqpar_devices=seqpar_devices)
    g = tsketcher.PackedGenome(np.zeros(16, np.uint8),
                               np.zeros((0, 2), np.int32), 64)
    sk._sketch_huge(g)
    want = seqpar_devices or [f"cuda:{i}" for i in range(4)]
    assert calls == [(route, want if route == "seqpar" else None)]


def test_import_scan_covers_the_process_layer():
    """tests/test_torch_io.py's scan for imports of the JAX package reads
    the new process layer too."""
    from tests.test_torch_io import _port_sources

    assert ROOT / "hypergen_tpu_torch" / "parallel" / "mesh.py" in \
        _port_sources()
