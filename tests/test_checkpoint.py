"""Checkpoint/resume by pair-block: an interrupted run must complete from its
journal with bit-identical results and without recomputing finished blocks."""

import numpy as np
import pytest

from sequencealigner_tpu import checkpoint as ckpt
from sequencealigner_tpu import matrices
from sequencealigner_tpu.engine import Engine
from sequencealigner_tpu.io.input import SequenceSet
from sequencealigner_tpu.io.output import OutputStore

M = matrices.get("blosum62")


def _random_set(rng, n):
    seqs = [
        rng.choice(np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8),
                   int(rng.integers(4, 40)))
        for _ in range(n)
    ]
    return SequenceSet.from_list(seqs, M.lut)


def _header(ss, algo="ga", gaps=(0, -10, -1)):
    return ckpt.config_fingerprint(
        algo=algo, gaps=gaps, matrix="blosum62", num_seqs=ss.num,
        lengths=ss.lengths, triangular=True,
    )


def test_journal_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    ss = _random_set(rng, 8)
    p = tmp_path / "run.ckpt"
    j = ckpt.Journal(p, _header(ss))
    j.commit([0, 3, 5])
    j.commit([7])
    j.close()
    j2 = ckpt.Journal(p, _header(ss))
    assert j2.done == {0, 3, 5, 7}
    j2.close()


def test_journal_rejects_config_mismatch(tmp_path):
    rng = np.random.default_rng(0)
    ss = _random_set(rng, 8)
    p = tmp_path / "run.ckpt"
    ckpt.Journal(p, _header(ss)).close()
    with pytest.raises(ckpt.CheckpointError):
        ckpt.Journal(p, _header(ss, algo="sw"))


def test_persistent_array_survives(tmp_path):
    p = tmp_path / "scores.dat"
    a = ckpt.persistent_array(p, 16)
    a[3] = 42
    a.flush()
    del a
    b = ckpt.persistent_array(p, 16)
    assert b[3] == 42


def test_resume_completes_interrupted_run(tmp_path):
    rng = np.random.default_rng(11)
    ss = _random_set(rng, 40)
    gaps = (0, -10, -1)
    eng = Engine("ga", M.matrix, gaps, device_kind="cpu", target_cells=1 << 11)

    full = OutputStore(ss.num, triangular=True, spill=False)
    eng.align_all(ss, full, progress=False)

    header = _header(ss)
    jpath = tmp_path / "run.ckpt"
    spath = tmp_path / "run.scores"

    # "Interrupted" first run: journal only a synthetic prefix of blocks by
    # running fully, then truncating the journal to its first commit line.
    store1 = OutputStore(ss.num, triangular=True, spill=False,
                         persist_path=spath)
    j1 = ckpt.Journal(jpath, header)
    eng.align_all(ss, store1, progress=False, journal=j1)
    j1.close()
    lines = jpath.read_text().splitlines()
    assert len(lines) >= 2  # header + >=1 commit
    # keep header + half the commits (simulates a crash mid-run)
    keep = 1 + max(1, (len(lines) - 1) // 2)
    jpath.write_text("\n".join(lines[:keep]) + "\n")

    # resumed run: must skip journaled blocks and fill in the rest
    store2 = OutputStore(ss.num, triangular=True, spill=False,
                         persist_path=spath)
    j2 = ckpt.Journal(jpath, header)
    n_done = len(j2.done)
    assert n_done > 0
    stats = eng.align_all(ss, store2, progress=False, journal=j2)
    assert stats.pairs_resumed > 0
    assert stats.pairs + stats.pairs_resumed == ss.num * (ss.num - 1) // 2
    np.testing.assert_array_equal(
        np.asarray(store2.matrix), np.asarray(full.matrix)
    )
    j2.close()


def test_cli_checkpoint_resume(tmp_path):
    """End-to-end: run with -k, delete nothing, re-run — second run resumes
    and produces the same HDF5 output."""
    import h5py

    from sequencealigner_tpu.cli import run

    rng = np.random.default_rng(3)
    fa = tmp_path / "in.fasta"
    with open(fa, "w") as f:
        for i in range(12):
            s = "".join(
                rng.choice(list("ARNDCQEGHILKMFPSTWYV"))
                for _ in range(int(rng.integers(5, 30)))
            )
            f.write(f">s{i}\n{s}\n")
    out1 = tmp_path / "o1.h5"
    out2 = tmp_path / "o2.h5"
    ck = tmp_path / "run.ckpt"
    base = ["-m", "blosum62", "-a", "ga", "-s", "10", "-e", "1", "-F", "-P",
            "-Q", "-C", "-k", str(ck)]
    assert run(["-i", str(fa), "-o", str(out1)] + base) == 0
    assert run(["-i", str(fa), "-o", str(out2)] + base) == 0
    with h5py.File(out1) as f1, h5py.File(out2) as f2:
        np.testing.assert_array_equal(
            f1["/similarity_matrix"][:], f2["/similarity_matrix"][:]
        )


def test_journal_tolerates_torn_tail(tmp_path):
    """A crash mid-commit tears the last line; resume must truncate it and
    keep earlier commits (the docstring's 'lose only the tail flush')."""
    rng = np.random.default_rng(0)
    ss = _random_set(rng, 8)
    p = tmp_path / "run.ckpt"
    j = ckpt.Journal(p, _header(ss))
    j.commit([0, 1])
    j.commit([2])
    j.close()
    with open(p, "a") as f:
        f.write("[7, 8")  # torn tail, no newline
    j2 = ckpt.Journal(p, _header(ss))
    assert j2.done == {0, 1, 2}
    j2.commit([3])
    j2.close()
    j3 = ckpt.Journal(p, _header(ss))
    assert j3.done == {0, 1, 2, 3}
    j3.close()


def test_journal_complete_line_without_newline_is_torn(tmp_path):
    """Tail torn exactly after a complete JSON line but before its newline:
    the line must be DISCARDED (not kept), or the append-mode reopen would
    concatenate the next commit onto it ('[5,6][7,8]') and a later resume
    would then drop both flushes as corrupt."""
    rng = np.random.default_rng(0)
    ss = _random_set(rng, 8)
    p = tmp_path / "run.ckpt"
    j = ckpt.Journal(p, _header(ss))
    j.commit([0, 1])
    j.close()
    with open(p, "a") as f:
        f.write("[5, 6]")  # complete JSON, missing trailing newline
    j2 = ckpt.Journal(p, _header(ss))
    assert j2.done == {0, 1}  # the un-terminated flush is treated as torn
    j2.commit([7, 8])
    j2.close()
    j3 = ckpt.Journal(p, _header(ss))
    assert j3.done == {0, 1, 7, 8}
    j3.close()


def test_fingerprint_binds_sequence_content(tmp_path):
    """Same lengths, different bytes (point mutations) must be rejected on
    resume — the journal would otherwise reuse stale scores."""
    rng = np.random.default_rng(0)
    ss = _random_set(rng, 8)
    data2 = ss.data.copy()
    data2[0] = data2[0] + 1 if data2[0] < 80 else data2[0] - 1
    h1 = ckpt.config_fingerprint(
        algo="ga", gaps=(0, -10, -1), matrix="blosum62", num_seqs=ss.num,
        lengths=ss.lengths, triangular=True, data=ss.data,
    )
    h2 = ckpt.config_fingerprint(
        algo="ga", gaps=(0, -10, -1), matrix="blosum62", num_seqs=ss.num,
        lengths=ss.lengths, triangular=True, data=data2,
    )
    assert h1 != h2
    p = tmp_path / "run.ckpt"
    ckpt.Journal(p, h1).close()
    with pytest.raises(ckpt.CheckpointError):
        ckpt.Journal(p, h2)


def test_journal_rejects_mid_file_corruption(tmp_path):
    rng = np.random.default_rng(0)
    ss = _random_set(rng, 8)
    p = tmp_path / "run.ckpt"
    j = ckpt.Journal(p, _header(ss))
    j.commit([0])
    j.close()
    lines = p.read_text().splitlines()
    lines.insert(1, "[5, 6")  # torn line NOT at the tail
    p.write_text("\n".join(lines) + "\n")
    with pytest.raises(ckpt.CheckpointError):
        ckpt.Journal(p, _header(ss))


def test_sync_interval_batches_commits(tmp_path, monkeypatch):
    """Journal commits are batched to sync points (engine.SYNC_INTERVAL):
    with a large interval a multi-flush run writes ONE commit line (the
    final drain); with interval 0 (legacy) every flush commits.  Both must
    journal every block and produce identical stores."""
    import sequencealigner_tpu.engine as eng_mod

    rng = np.random.default_rng(5)
    ss = _random_set(rng, 30)
    total = ss.num * (ss.num - 1) // 2
    eng = Engine("ga", M.matrix, (0, -10, -1), device_kind="cpu",
                 target_cells=1 << 10)
    monkeypatch.setattr(eng_mod, "FLUSH_PAIRS", 64)  # force many flushes

    def run(interval, tag):
        import json

        monkeypatch.setattr(eng_mod, "SYNC_INTERVAL", interval)
        jpath = tmp_path / f"j_{tag}"
        store = OutputStore(ss.num, triangular=True, spill=False,
                            persist_path=tmp_path / f"s_{tag}")
        j = ckpt.Journal(jpath, _header(ss))
        eng.align_all(ss, store, progress=False, journal=j)
        j.close()
        lines = jpath.read_text().splitlines()
        done = sum(len(json.loads(l)) for l in lines[1:])
        assert done >= 1 and done == len(set(
            x for l in lines[1:] for x in json.loads(l)
        ))
        return len(lines) - 1, np.asarray(store.matrix).copy()

    n_batched, m1 = run(1e9, "batched")
    n_legacy, m2 = run(0.0, "legacy")
    assert n_batched == 1  # everything committed at the final drain
    assert n_legacy > 1  # per-flush commits
    np.testing.assert_array_equal(m1, m2)


def test_schedule_kill_resume(tmp_path, monkeypatch):
    """Kill/resume under the linear superblock schedule (token linear-v1)
    with a bucket of 140 rows and many small superblocks: the resumed run
    must skip committed blocks (take()'s journal.done branch) and converge
    bit-exactly."""
    from sequencealigner_tpu import engine as eng_mod

    monkeypatch.setattr(eng_mod, "FLUSH_PAIRS", 1500)  # force several commits
    monkeypatch.setattr(eng_mod, "SYNC_INTERVAL", 0.0)  # commit per flush
    rng = np.random.default_rng(23)
    seqs = [
        rng.choice(np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8),
                   int(rng.integers(10, 17)))
        for _ in range(140)
    ]
    ss = SequenceSet.from_list(seqs, M.lut)
    gaps = (0, -10, -1)
    eng = Engine("ga", M.matrix, gaps, device_kind="cpu", target_cells=1 << 14)
    token = eng.schedule_token(ss.lengths)
    assert token.startswith("linear-v1")
    header = ckpt.config_fingerprint(
        algo="ga", gaps=gaps, matrix="blosum62", num_seqs=ss.num,
        lengths=ss.lengths, triangular=True, schedule=token,
    )

    full = OutputStore(ss.num, triangular=True, spill=False)
    eng.align_all(ss, full, progress=False)

    jpath = tmp_path / "run.ckpt"
    spath = tmp_path / "run.scores"
    store1 = OutputStore(ss.num, triangular=True, spill=False,
                         persist_path=spath)
    j1 = ckpt.Journal(jpath, header)
    eng.align_all(ss, store1, progress=False, journal=j1)
    j1.close()
    lines = jpath.read_text().splitlines()
    assert len(lines) >= 3, "need >=2 commits for a meaningful truncation"
    keep = 1 + (len(lines) - 1) // 2  # crash mid-run: keep half the commits
    jpath.write_text("\n".join(lines[:keep]) + "\n")

    store2 = OutputStore(ss.num, triangular=True, spill=False,
                         persist_path=spath)
    j2 = ckpt.Journal(jpath, header)
    assert len(j2.done) > 0
    stats = eng.align_all(ss, store2, progress=False, journal=j2)
    assert stats.pairs_resumed > 0 and stats.pairs > 0
    assert stats.pairs + stats.pairs_resumed == ss.num * (ss.num - 1) // 2
    np.testing.assert_array_equal(
        np.asarray(store2.matrix), np.asarray(full.matrix)
    )
    j2.close()


def test_schedule_mismatch_error_names_schedule(tmp_path):
    """A journal written under one schedule geometry must be rejected with
    an error NAMING the schedule field."""
    rng = np.random.default_rng(0)
    ss = _random_set(rng, 8)
    p = tmp_path / "run.ckpt"
    h1 = ckpt.config_fingerprint(
        algo="ga", gaps=(0, -10, -1), matrix="blosum62", num_seqs=ss.num,
        lengths=ss.lengths, triangular=True, schedule="linear-v1.0000aaaa",
    )
    ckpt.Journal(p, h1).close()
    h2 = dict(h1, schedule="linear-v1.0000bbbb")
    with pytest.raises(ckpt.CheckpointError) as ei:
        ckpt.Journal(p, h2)
    msg = str(ei.value)
    assert "schedule" in msg and "0000aaaa" in msg and "0000bbbb" in msg
