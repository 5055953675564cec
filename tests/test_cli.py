"""CLI end-to-end and flag-surface tests (reference README.md:153-180 and the
relations declared in src/bio/align.c, io/output.c, io/format/hdf5.c)."""

import os

import numpy as np
import pytest

from sequencealigner_tpu import cli
from sequencealigner_tpu.ops import oracle
from sequencealigner_tpu import matrices

FASTA = b">s1\nARNDCQ\n>s2\nARNDCC\n>s3\nWWWWWW\n"


@pytest.fixture()
def fasta_file(tmp_path):
    p = tmp_path / "in.fasta"
    p.write_bytes(FASTA)
    return p


def run_cli(*args):
    return cli.run(list(args))


class TestFlags:
    def test_help(self, capsys):
        assert run_cli("-h") == 0
        out = capsys.readouterr().out
        for flag in ("--input", "--output", "--matrix", "--align", "--gap-penalty",
                     "--gap-open", "--gap-extend", "--list-matrices", "--filter",
                     "--compression", "--benchmark", "--threads", "--no-device",
                     "--no-write", "--no-progress", "--no-detail",
                     "--force-proceed", "--quiet", "--verbose", "--help"):
            assert flag in out, flag

    def test_list_matrices(self, capsys):
        assert run_cli("-l") == 0
        out = capsys.readouterr().out
        assert "Amino Matrices (65):" in out and "nuc44" in out

    def test_missing_required(self, capsys, fasta_file):
        assert run_cli("-i", str(fasta_file)) == 1
        assert "Missing required option" in capsys.readouterr().err

    def test_gap_conflicts(self, capsys, fasta_file, tmp_path):
        rc = run_cli("-i", str(fasta_file), "-o", str(tmp_path / "o.h5"),
                     "-m", "blosum62", "-a", "nw", "-p", "4", "-s", "10", "-F")
        assert rc == 1
        assert "conflicts" in capsys.readouterr().err

    def test_gap_pen_on_affine_method(self, capsys, fasta_file, tmp_path):
        rc = run_cli("-i", str(fasta_file), "-o", str(tmp_path / "o.h5"),
                     "-m", "blosum62", "-a", "sw", "-p", "4", "-F")
        assert rc == 1
        assert "Gap penalty cannot be set for non-linear methods" in capsys.readouterr().err

    def test_affine_on_linear_method(self, capsys, fasta_file, tmp_path):
        rc = run_cli("-i", str(fasta_file), "-o", str(tmp_path / "o.h5"),
                     "-m", "blosum62", "-a", "nw", "-s", "10", "-e", "1", "-F")
        assert rc == 1
        assert "Affine gaps cannot be set" in capsys.readouterr().err

    def test_unknown_matrix(self, capsys, fasta_file, tmp_path):
        rc = run_cli("-i", str(fasta_file), "-o", str(tmp_path / "o.h5"),
                     "-m", "nosuch", "-a", "nw", "-p", "4", "-F")
        assert rc == 1
        assert "Invalid substitution matrix name" in capsys.readouterr().err

    def test_negative_gap_rejected(self, capsys, fasta_file, tmp_path):
        rc = run_cli("-i", str(fasta_file), "-o", str(tmp_path / "o.h5"),
                     "-m", "blosum62", "-a", "nw", "-p", "-4", "-F")
        assert rc == 1
        assert "Gap values must be positive integers" in capsys.readouterr().err

    def test_compression_depends_on_output(self, capsys, fasta_file):
        rc = run_cli("-i", str(fasta_file), "-m", "blosum62", "-a", "nw",
                     "-p", "4", "-z", "6", "-W", "-F")
        assert rc == 1
        assert "requires" in capsys.readouterr().err

    def test_input_not_found(self, capsys, tmp_path):
        rc = run_cli("-i", str(tmp_path / "nope.fasta"), "-o", str(tmp_path / "o.h5"),
                     "-m", "blosum62", "-a", "nw", "-p", "4", "-F")
        assert rc == 1
        assert "File not found" in capsys.readouterr().err

    def test_no_write_skips_output_requirement(self, fasta_file):
        assert run_cli("-i", str(fasta_file), "-m", "blosum62", "-a", "nw",
                       "-p", "4", "-W", "-F", "-Q", "-C") == 0

    def test_existing_output_force_deletes(self, fasta_file, tmp_path):
        out = tmp_path / "o.h5"
        out.write_bytes(b"junk")
        assert run_cli("-i", str(fasta_file), "-o", str(out), "-m", "blosum62",
                       "-a", "nw", "-p", "4", "-F", "-Q", "-C") == 0
        import h5py

        with h5py.File(out) as f:
            assert "/similarity_matrix" in f


class TestEndToEnd:
    def _scores(self, path):
        import h5py

        with h5py.File(path) as f:
            return f["/similarity_matrix"][...], list(f["/sequences"].asstr())

    def test_nw_end_to_end(self, fasta_file, tmp_path):
        out = tmp_path / "out.h5"
        rc = run_cli("-i", str(fasta_file), "-o", str(out), "-m", "blosum62",
                     "-a", "nw", "-p", "4", "-F", "-Q", "-C")
        assert rc == 0
        m = matrices.get("blosum62")
        mat, seqs = self._scores(out)
        assert seqs == ["ARNDCQ", "ARNDCC", "WWWWWW"]
        enc = lambda s: m.lut[np.frombuffer(s.encode(), np.uint8)]
        for i in range(3):
            for j in range(3):
                want = 0 if i == j else oracle.nw_linear(
                    enc(seqs[i]), enc(seqs[j]), m.matrix, -4
                )
                assert mat[i, j] == want

    def test_sw_affine_end_to_end(self, fasta_file, tmp_path):
        out = tmp_path / "out.h5"
        rc = run_cli("-i", str(fasta_file), "-o", str(out), "-m", "blosum62",
                     "-a", "sw", "-s", "10", "-e", "1", "-F", "-Q", "-C")
        assert rc == 0
        m = matrices.get("blosum62")
        mat, seqs = self._scores(out)
        enc = lambda s: m.lut[np.frombuffer(s.encode(), np.uint8)]
        assert mat[0, 1] == oracle.sw_affine(enc(seqs[0]), enc(seqs[1]), m.matrix, -10, -1)

    def test_ga_equal_gaps_switches_to_nw(self, fasta_file, tmp_path, capsys):
        # -F auto-answers the Yn prompt, switching GA(open==extend) to NW.
        out = tmp_path / "out.h5"
        rc = run_cli("-i", str(fasta_file), "-o", str(out), "-m", "blosum62",
                     "-a", "ga", "-s", "3", "-e", "3", "-F", "-C")
        assert rc == 0
        assert "Needleman-Wunsch" in capsys.readouterr().out
        m = matrices.get("blosum62")
        mat, seqs = self._scores(out)
        enc = lambda s: m.lut[np.frombuffer(s.encode(), np.uint8)]
        assert mat[0, 1] == oracle.nw_linear(enc(seqs[0]), enc(seqs[1]), m.matrix, -3)

    def test_csv_with_filter_and_benchmark(self, tmp_path, capsys):
        p = tmp_path / "in.csv"
        p.write_bytes(b"id,sequence\n1,ARNDCQ\n2,ARNDCQ\n3,WWWWWW\n")
        out = tmp_path / "out.h5"
        rc = run_cli("-i", str(p), "-o", str(out), "-m", "blosum62",
                     "-a", "ga", "-s", "10", "-e", "1", "-f", "0.9", "-B", "-F",
                     "-C")
        assert rc == 0
        txt = capsys.readouterr().out
        assert "Filtered out 1 sequences" in txt
        assert "Alignments per second" in txt
        _, seqs = self._scores(out)
        assert seqs == ["ARNDCQ", "WWWWWW"]  # duplicate dropped

    def test_dna_matrix_end_to_end(self, tmp_path):
        p = tmp_path / "in.fasta"
        p.write_bytes(b">a\nACGTACGT\n>b\nACGTTGCA\n")
        out = tmp_path / "out.h5"
        rc = run_cli("-i", str(p), "-o", str(out), "-m", "nuc44",
                     "-a", "nw", "-p", "2", "-F", "-Q", "-C")
        assert rc == 0
        m = matrices.get("nuc44")
        mat, seqs = self._scores(out)
        enc = lambda s: m.lut[np.frombuffer(s.encode(), np.uint8)]
        assert mat[0, 1] == oracle.nw_linear(enc(seqs[0]), enc(seqs[1]), m.matrix, -2)

    def test_quiet_mode_silent(self, fasta_file, tmp_path, capsys):
        rc = run_cli("-i", str(fasta_file), "-o", str(tmp_path / "o.h5"),
                     "-m", "blosum62", "-a", "nw", "-p", "4", "-F", "-Q", "-P",
                     "-C")
        assert rc == 0
        assert capsys.readouterr().out == ""

    def test_cpu_fallback_flag(self, fasta_file, tmp_path):
        # -C is the CPU path: it needs no GPU and no prompt.
        out = tmp_path / "o.h5"
        rc = run_cli("-i", str(fasta_file), "-o", str(out), "-m", "blosum62",
                     "-a", "nw", "-p", "4", "-C", "-F", "-Q")
        assert rc == 0


def test_cli_trace_flag(tmp_path):
    import os

    fa = tmp_path / "in.fasta"
    fa.write_text(">a\nAAAA\n>b\nAARN\n>c\nDDDD\n")
    out = tmp_path / "o.h5"
    tdir = tmp_path / "trace"
    rc = cli.run(["-i", str(fa), "-o", str(out), "-m", "blosum62", "-a", "nw",
              "-p", "4", "-F", "-P", "-Q", "-C", "-t", str(tdir)])
    assert rc == 0
    # a profiler trace directory must have been produced
    assert tdir.exists() and any(tdir.rglob("*"))


def test_cli_piped_stdin_drives_column_chooser(tmp_path, monkeypatch):
    """Headless prompt parity: the reference reads prompts from stdin even
    when it is a pipe (clix print.h terminal_read_input), so
    printf '0\\n' | seqalign-tpu headerless.csv must drive the DSV column
    chooser without a TTY."""
    import io

    csv = tmp_path / "in.csv"
    csv.write_text("ARNDCQ,x\nARNDCC,y\nWWWWWW,z\n")  # no header row
    out = tmp_path / "o.h5"
    # Answer "2" = the "No header line" option, then "0" = column 0.
    monkeypatch.setattr("sys.stdin", io.StringIO("2\n0\n"))
    rc = cli.run(["-i", str(csv), "-o", str(out), "-m", "blosum62", "-a",
                  "nw", "-p", "4", "-P", "-C"])
    assert rc == 0 and out.exists()
    import h5py

    with h5py.File(out) as f:
        assert [s.decode() for s in f["/sequences"][:]] == [
            "ARNDCQ", "ARNDCC", "WWWWWW"
        ]


def test_cli_piped_stdin_exhausted_choice_fails(tmp_path, monkeypatch):
    import io

    csv = tmp_path / "in.csv"
    csv.write_text("ARNDCQ,x\nARNDCC,y\n")
    out = tmp_path / "o.h5"
    monkeypatch.setattr("sys.stdin", io.StringIO(""))  # exhausted pipe
    rc = cli.run(["-i", str(csv), "-o", str(out), "-m", "blosum62", "-a",
                  "nw", "-p", "4", "-P", "-C"])
    assert rc == 1


def _two_seqs(tmp_path):
    fa = tmp_path / "in.fasta"
    fa.write_text(">a\nAAAA\n>b\nAARN\n")
    return ["-i", str(fa), "-o", str(tmp_path / "o.h5"), "-m", "blosum62",
            "-a", "nw", "-p", "4", "-P"]


def test_cli_no_gpu_force_fails(tmp_path, capsys):
    """Without a GPU, -F does not confirm the CPU: a scripted run fails
    instead of quietly aligning on the host."""
    rc = cli.run(_two_seqs(tmp_path) + ["-F"])
    assert rc == 1
    assert "No GPU device found" in capsys.readouterr().err
    assert not (tmp_path / "o.h5").exists()


@pytest.mark.parametrize("answer,rc", [("y\n", 0), ("n\n", 1), ("", 1)])
def test_cli_no_gpu_prompt(tmp_path, monkeypatch, answer, rc):
    """Without a GPU and without -F, the CPU runs only on a typed "y" (an
    empty or exhausted answer is a no)."""
    import io

    monkeypatch.setattr("sys.stdin", io.StringIO(answer))
    assert cli.run(_two_seqs(tmp_path)) == rc
    assert (tmp_path / "o.h5").exists() == (rc == 0)


def test_cli_cpu_flag_runs_without_gpu(tmp_path):
    assert cli.run(_two_seqs(tmp_path) + ["-F", "-C", "-Q"]) == 0
    assert (tmp_path / "o.h5").exists()


def test_cli_benchmark_summary_names_device(tmp_path, capsys):
    assert cli.run(_two_seqs(tmp_path) + ["-F", "-C", "-B"]) == 0
    assert "Device: cpu" in capsys.readouterr().out


def test_cli_missing_h5py_stops_before_alignment(tmp_path, monkeypatch, capsys):
    """-o needs h5py only for the final write; its absence is reported at
    start-up, before any alignment work."""
    import sys

    from sequencealigner_tpu.engine import Engine

    monkeypatch.setitem(sys.modules, "h5py", None)  # import raises
    monkeypatch.setattr(
        Engine, "align_all",
        lambda *a, **k: pytest.fail("aligned without a writer"),
    )
    assert cli.run(_two_seqs(tmp_path) + ["-F", "-C"]) == 1
    assert "h5py" in capsys.readouterr().err


def test_cpu_engine_fast_with_default_backend_registered():
    """Regression: a -C run with progress enabled must stay fast whatever
    the process's default backend is — _put_i64 pins its 8-byte puts to the
    mesh's backend instead of committing them to the default device.  Runs
    in a subprocess WITHOUT the conftest CPU pin, so the machine's default
    platform is the one registered; asserts the engine-side wall time only
    (free of process/backend startup)."""
    import subprocess
    import sys

    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    code = r"""
import time, numpy as np
from sequencealigner_tpu import matrices
from sequencealigner_tpu.engine import Engine
from sequencealigner_tpu.io.input import SequenceSet
from sequencealigner_tpu.io.output import OutputStore
m = matrices.get("blosum62")
rng = np.random.default_rng(0)
seqs = [rng.choice(np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8),
                   int(rng.integers(20, 60))) for _ in range(64)]
ss = SequenceSet.from_list(seqs, m.lut)
store = OutputStore(ss.num, triangular=False, spill=False)
eng = Engine("nw", m.matrix, (-4, 0, 0), device_kind="cpu")
t0 = time.time()
eng.align_all(ss, store, progress=True)
print(f"ALIGN_WALL={time.time()-t0:.2f}")
"""
    r = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True,
        text=True, timeout=240,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    wall = float(r.stdout.split("ALIGN_WALL=")[1].split()[0])
    assert wall < 30.0, f"CPU-mesh align took {wall}s"
