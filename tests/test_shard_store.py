"""Sharded multi-host output (parallel/shard_store.py): row partition,
per-host stores, point-to-point routing, shard HDF5 + stitch — the
config-5 architecture where NO host holds or transfers the full triplet
set.
"""

import json
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from sequencealigner_tpu import matrices
from sequencealigner_tpu.engine import Engine
from sequencealigner_tpu.io.input import SequenceSet
from sequencealigner_tpu.io.output import OutputStore
from sequencealigner_tpu.parallel.shard_store import (
    RowPartition, ShardStore, stitch_shards, tri, write_shard,
)

REPO = Path(__file__).resolve().parents[1]
M = matrices.get("blosum62")


def test_row_partition_tiles_and_balances():
    for dim, P in [(10, 2), (1000, 3), (100_000, 8), (1_000_000, 16)]:
        part = RowPartition(dim, P)
        b = part.bounds
        assert b[0] == 0 and b[-1] == dim
        assert (np.diff(b) >= 0).all()
        counts = [tri(int(b[k + 1])) - tri(int(b[k])) for k in range(P)]
        assert sum(counts) == tri(dim)
        # Equal-pair balance: every shard within ~1 row of ideal.
        ideal = tri(dim) / P
        for c in counts:
            assert abs(c - ideal) <= dim + 1
        # owner_of agrees with the ranges.
        j = np.arange(1, dim)
        o = part.owner_of(j)
        for k in range(P):
            lo, hi = part.rows_of(k)
            sel = (j >= lo) & (j < hi)
            assert (o[sel] == k).all()


def test_shard_store_fill_read_and_range_check():
    store = ShardStore(100, 30, 60)
    rng = np.random.default_rng(0)
    j = rng.integers(30, 60, 500).astype(np.int64)
    i = (rng.random(500) * j).astype(np.int64)
    s = rng.integers(-100, 100, 500).astype(np.int32)
    store.fill_pairs(i, j, s)
    # last-write-wins like the flat triangle; check via a dict replay
    want = {}
    for a, b, v in zip(i, j, s):
        want[(a, b)] = v
    ii = np.array([k[0] for k in want], np.int64)
    jj = np.array([k[1] for k in want], np.int64)
    np.testing.assert_array_equal(
        store.read_pairs(ii, jj), np.array(list(want.values()), np.int32)
    )
    with pytest.raises(ValueError):
        store.fill_pairs(np.array([1]), np.array([60]), np.array([1]))


def test_stitch_shards_reproduces_full_matrix(tmp_path):
    dim, P = 57, 3
    rng = np.random.default_rng(7)
    full = np.zeros((dim, dim), np.int32)
    iu = np.triu_indices(dim, 1)
    vals = rng.integers(-500, 500, len(iu[0])).astype(np.int32)
    full[iu] = vals
    full = full + full.T

    part = RowPartition(dim, P)
    paths = []
    for k in range(P):
        lo, hi = part.rows_of(k)
        sh = ShardStore(dim, lo, hi)
        jj = iu[1]
        sel = (jj >= lo) & (jj < hi)
        sh.fill_pairs(iu[0][sel], jj[sel], vals[sel])
        p = str(tmp_path / f"shard{k}.h5")
        write_shard(p, sh)
        paths.append(p)

    seqs = SequenceSet.from_list(
        [np.frombuffer(b"ARND", np.uint8)] * dim, M.lut
    )
    out = str(tmp_path / "out.h5")
    stitch_shards(paths, out, seqs)
    import h5py

    with h5py.File(out) as f:
        got = np.asarray(f["/similarity_matrix"])
        assert len(f["/sequences"]) == dim
    np.testing.assert_array_equal(got, full)


_WORKER = textwrap.dedent("""
    import json, os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    import numpy as np
    from sequencealigner_tpu import matrices, ui
    from sequencealigner_tpu.engine import Engine
    from sequencealigner_tpu.io.input import SequenceSet
    from sequencealigner_tpu.parallel.shard_store import (
        RowPartition, ShardStore, TripletRouter, write_shard,
    )

    host, nhosts, port0, port1, outdir = (
        int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
        int(sys.argv[4]), sys.argv[5],
    )
    ui.configure(quiet=True)
    M = matrices.get("blosum62")
    rng = np.random.default_rng(3)
    seqs = [rng.choice(np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8),
                       int(rng.integers(5, 30))) for _ in range(80)]
    ss = SequenceSet.from_list(seqs, M.lut)
    part = RowPartition(ss.num, nhosts)
    addrs = [("127.0.0.1", port0), ("127.0.0.1", port1)]
    # Generous connect deadline: both workers import jax/numpy on what may
    # be ONE loaded core, so peer listeners can lag minutes behind under a
    # full parallel test run (the 60 s default flaked there once).
    router = TripletRouter(host, nhosts, part, addrs, connect_timeout=600.0)
    lo, hi = part.rows_of(host)
    store = ShardStore(ss.num, lo, hi)
    eng = Engine("ga", M.matrix, (0, -10, -1), device_kind="cpu",
                 target_cells=1 << 12)
    stats = eng.align_all(ss, store, progress=False,
                          partition=(host, nhosts), merger=router)
    write_shard(f"{outdir}/shard{host}.h5", store)
    total_bytes = 20 * ss.num * (ss.num - 1) // 2
    print(json.dumps(dict(
        host=host, pairs=stats.pairs, sent=router.bytes_sent,
        received=router.bytes_received, full_set_bytes=total_bytes,
    )))
    router.close()
""")


def test_two_process_routed_shards_match_full_run(tmp_path):
    """Two REAL processes route triplets point-to-point over TCP; each
    holds only its row-range shard; the stitched output equals the
    single-process full run bit-for-bit, and neither process sent or
    received anything close to the full triplet set."""
    ports = []
    socks = []
    for _ in range(2):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
        socks.append(s)
    for s in socks:
        s.close()
    w = tmp_path / "worker.py"
    w.write_text(_WORKER)
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    procs = [
        subprocess.Popen(
            [sys.executable, str(w), str(h), "2", str(ports[0]),
             str(ports[1]), str(tmp_path)],
            cwd=str(REPO), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for h in range(2)
    ]
    outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
    stats = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("{"):
                d = json.loads(line)
                stats[d["host"]] = d
    assert set(stats) == {0, 1}
    total = stats[0]["pairs"] + stats[1]["pairs"]

    # Reference: single-process full run.
    rng = np.random.default_rng(3)
    seqs = [rng.choice(np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8),
                       int(rng.integers(5, 30))) for _ in range(80)]
    ss = SequenceSet.from_list(seqs, M.lut)
    assert total == ss.num * (ss.num - 1) // 2
    eng = Engine("ga", M.matrix, (0, -10, -1), device_kind="cpu",
                 target_cells=1 << 12)
    full = OutputStore(ss.num, triangular=False, spill=False)
    eng.align_all(ss, full, progress=False)
    want = np.asarray(full.matrix).reshape(ss.num, ss.num)

    out = str(tmp_path / "stitched.h5")
    stitch_shards(
        [str(tmp_path / "shard0.h5"), str(tmp_path / "shard1.h5")], out, ss
    )
    import h5py

    with h5py.File(out) as f:
        got = np.asarray(f["/similarity_matrix"])
    np.testing.assert_array_equal(got, want)

    # The point of the architecture: no process transferred the full set.
    full_bytes = stats[0]["full_set_bytes"]
    for h in (0, 1):
        assert stats[h]["sent"] < full_bytes // 2 + 4096
        assert stats[h]["received"] < full_bytes // 2 + 4096
