"""Parser + output-store + HDF5 tests against the reference's documented
semantics (fasta.c / dsv.c / output.c / hdf5.c)."""

import numpy as np
import pytest

from sequencealigner_tpu import matrices
from sequencealigner_tpu.io import dsv, fasta, hdf5_io, input as sio
from sequencealigner_tpu.io.output import OutputStore, alignments

LUT = matrices.get("blosum62").lut
NLUT = matrices.get("nuc44").lut


def decode(seqs):
    back = []
    for s in seqs:
        back.append(bytes(s.tolist()).decode())
    return back


class TestFasta:
    def test_basic(self):
        data = b">h1\nARND\n>h2\nCQEG\nHILK\n"
        seqs = fasta.parse(data, "fasta", LUT)
        assert decode(seqs) == ["ARND", "CQEGHILK"]

    def test_lowercase_and_spaces(self):
        seqs = fasta.parse(b">x\narn d\r\nc\n", "fa", LUT)
        assert decode(seqs) == ["ARNDC"]

    def test_all_extensions(self):
        for ext in ("fasta", "fa", "fas", "fna", "ffn", "faa", "frn", "mpfa", "FASTA"):
            assert decode(fasta.parse(b">a\nAC\n>b\nGT\n", ext, LUT)) == ["AC", "GT"]

    def test_unsupported_extension(self):
        with pytest.raises(sio.Unsupported):
            fasta.parse(b">a\nAC\n", "txt", LUT)

    def test_data_before_header(self):
        with pytest.raises(sio.ParseError, match="Data before first header"):
            fasta.parse(b"ACGT\n>x\nAC\n", "fasta", LUT)

    def test_last_header_no_data(self):
        with pytest.raises(sio.ParseError, match="Last header has no data"):
            fasta.parse(b">a\nAC\n>b\n", "fasta", LUT)

    def test_empty_sequence_mid_file(self):
        with pytest.raises(sio.ParseError, match="Sequence #1 is empty"):
            fasta.parse(b">a\n   \n>b\nAC\n", "fasta", LUT)

    def test_invalid_char_for_matrix(self):
        # 'O' is not in the amino alphabet.
        with pytest.raises(sio.ParseError, match="Sequence #2 is invalid"):
            fasta.parse(b">a\nAC\n>b\nAO\n", "fasta", LUT)

    def test_alphabet_depends_on_matrix(self):
        # 'E' is amino-valid but not a nucleotide code.
        assert decode(fasta.parse(b">a\nAE\n", "fasta", LUT)) == ["AE"]
        with pytest.raises(sio.ParseError, match="invalid"):
            fasta.parse(b">a\nAE\n", "fasta", NLUT)

    def test_gt_inside_header_line_not_a_record(self):
        # fasta.c's header scan only stops at CR/LF, so '>' mid-header is text.
        seqs = fasta.parse(b">a>b\nAC\n", "fasta", LUT)
        assert decode(seqs) == ["AC"]

    def test_record_split_without_newline(self):
        seqs = fasta.parse(b">a\nAC>b\nGT\n", "fasta", LUT)
        assert decode(seqs) == ["AC", "GT"]


class TestDsv:
    def test_csv_autodetect_column(self):
        data = b"id,sequence\n1,ARND\n2,CQEG\n"
        assert decode(dsv.parse(data, "csv", LUT)) == ["ARND", "CQEG"]

    def test_key_case_insensitive(self):
        data = b"ID,Protein\n1,ARND\n"
        assert decode(dsv.parse(data, "csv", LUT)) == ["ARND"]

    def test_tsv_ssv_psv(self):
        for ext, d in (("tsv", b"\t"), ("ssv", b";"), ("psv", b"|")):
            data = b"seq" + d + b"x\nARND" + d + b"1\n"
            assert decode(dsv.parse(data, ext, LUT)) == ["ARND"]

    def test_quoted_fields(self):
        data = b'"name","seq"\n"a,b","ARND"\n'
        assert decode(dsv.parse(data, "csv", LUT)) == ["ARND"]

    def test_doubled_quotes_in_field(self):
        data = b'name,seq\n"say ""hi""",ARND\n'
        assert decode(dsv.parse(data, "csv", LUT)) == ["ARND"]

    def test_chooser_when_no_match(self):
        data = b"a,b\nARND,CQEG\n"
        picked = []

        def choose(opts, prompt):
            picked.append(list(opts))
            return 0

        assert decode(dsv.parse(data, "csv", LUT, choose=choose)) == ["ARND"]
        assert picked[0] == ["a", "b", "No header line"]

    def test_chooser_no_header_line(self):
        data = b"ARND,x\nCQEG,y\n"
        calls = []

        def choose(opts, prompt):
            calls.append(list(opts))
            return len(opts) - 1 if len(calls) == 1 else 0

        # First row is data: choosing "No header line" keeps it.
        assert decode(dsv.parse(data, "csv", LUT, choose=choose)) == ["ARND", "CQEG"]

    def test_too_many_columns(self):
        with pytest.raises(sio.ParseError, match="row #2 has too many columns"):
            dsv.parse(b"id,seq\n1,ARND\n2,CQEG,zz\n", "csv", LUT)

    def test_too_few_columns(self):
        with pytest.raises(sio.ParseError, match="row #1 has too few columns"):
            dsv.parse(b"id,seq,extra\n1,ARND\n", "csv", LUT)

    def test_no_sequence_column(self):
        with pytest.raises(sio.ParseError, match="row #1 has no sequence column"):
            dsv.parse(b"id,x,seq\n1\n", "csv", LUT)

    def test_empty_lines_skipped(self):
        data = b"seq\nARND\n\n\nCQEG\n"
        assert decode(dsv.parse(data, "csv", LUT)) == ["ARND", "CQEG"]

    def test_quoted_path_matches_fast_path(self):
        plain = b"id,seq\n1,ARND\n2,CQEG\n"
        quoted = b'id,seq\n"1",ARND\n2,"CQEG"\n'
        assert decode(dsv.parse(plain, "csv", LUT)) == decode(
            dsv.parse(quoted, "csv", LUT)
        )


class TestLoad:
    def test_load_fasta(self, tmp_path):
        p = tmp_path / "in.fasta"
        p.write_bytes(b">a\nARND\n>b\nCQ\n")
        ss = sio.load(p, LUT)
        assert ss.num == 2
        assert ss.max_len == 4
        assert ss.get_str(0) == "ARND" and ss.get_str(1) == "CQ"
        np.testing.assert_array_equal(ss.lengths, [4, 2])

    def test_min_sequences(self, tmp_path):
        p = tmp_path / "in.fasta"
        p.write_bytes(b">a\nARND\n")
        with pytest.raises(sio.ParseError, match="Not enough sequences: 1"):
            sio.load(p, LUT)

    def test_no_extension(self, tmp_path):
        p = tmp_path / "noext"
        p.write_bytes(b">a\nAC\n>b\nAG\n")
        with pytest.raises(sio.ParseError, match="File extension not found"):
            sio.load(p, LUT)

    def test_unknown_extension(self, tmp_path):
        p = tmp_path / "in.xyz"
        p.write_bytes(b">a\nAC\n>b\nAG\n")
        with pytest.raises(sio.ParseError, match="Unsupported file format"):
            sio.load(p, LUT)

    def test_indices_padded(self, tmp_path):
        p = tmp_path / "in.fasta"
        p.write_bytes(b">a\nAR\n>b\nNDCQ\n")
        ss = sio.load(p, LUT)
        idx = ss.indices_padded(6, 24)
        np.testing.assert_array_equal(idx[0], [0, 1, 24, 24, 24, 24])
        np.testing.assert_array_equal(idx[1], [2, 3, 4, 5, 24, 24])


class TestOutputStore:
    def test_full_vs_triangular_equivalence(self):
        rng = np.random.default_rng(0)
        n = 12
        full = OutputStore(n, triangular=False, spill=False)
        tri = OutputStore(n, triangular=True, spill=False)
        ii, jj = np.triu_indices(n, 1)
        scores = rng.integers(-100, 100, len(ii)).astype(np.int32)
        full.fill_pairs(ii, jj, scores)
        tri.fill_pairs(ii, jj, scores)
        for r in range(n):
            np.testing.assert_array_equal(full.row(r), tri.row(r))
        # Packed layout: index of pair (i<j) is alignments(j)+i (macros.h:13).
        assert tri.matrix[alignments(5) + 2] == full.get_pair(2, 5)

    def test_spill_store(self):
        st = OutputStore(8, triangular=True, spill=True)
        st.fill_pairs(np.array([0]), np.array([3]), np.array([42]))
        assert st.get_pair(3, 0) == 42

    def test_permuted_layout_equivalence(self):
        """Sorted-coordinate layout: identical public API results, packed
        offsets laid out in permuted space (sequential for combo streams)."""
        rng = np.random.default_rng(3)
        n = 23
        perm = rng.permutation(n).astype(np.int64)
        plain = OutputStore(n, triangular=True, spill=False)
        permu = OutputStore(n, triangular=True, spill=False, perm=perm)
        ii, jj = np.triu_indices(n, 1)
        scores = rng.integers(-100, 100, len(ii)).astype(np.int32)
        plain.fill_pairs(ii, jj, scores)
        permu.fill_pairs(ii, jj, scores)
        np.testing.assert_array_equal(
            plain.read_pairs(ii, jj), permu.read_pairs(ii, jj)
        )
        for r in range(n):
            np.testing.assert_array_equal(plain.row(r), permu.row(r))
        np.testing.assert_array_equal(plain.rows(0, n), permu.rows(0, n))
        np.testing.assert_array_equal(
            plain.rows(5, n // 2 + 5), permu.rows(5, n // 2 + 5)
        )
        assert plain.get_pair(2, 9) == permu.get_pair(2, 9)
        # The underlying layouts genuinely differ (unless perm is identity).
        assert not np.array_equal(np.asarray(plain.matrix),
                                  np.asarray(permu.matrix))

    def test_sorted_window_conversion_matches_rows(self, tmp_path):
        """The SEQUENTIAL tri->square converter for the sorted-coordinate
        layout (rows_sorted_window) reproduces rows()
        exactly, both directly and through the HDF5 writer."""
        rng = np.random.default_rng(11)
        n = 137
        perm = rng.permutation(n).astype(np.int64)
        st = OutputStore(n, triangular=True, spill=False, perm=perm)
        ii, jj = np.triu_indices(n, 1)
        scores = rng.integers(-999, 999, len(ii)).astype(np.int32)
        st.fill_pairs(ii.astype(np.int64), jj.astype(np.int64), scores)
        want = st.rows(0, n)
        got = np.zeros((n, n), np.int32)
        for s0 in range(0, n, 48):
            s1 = min(s0 + 48, n)
            targets, block = st.rows_sorted_window(s0, s1, qchunk=33)
            assert (np.diff(targets) > 0).all()  # h5py selection rule
            got[targets] = block
        np.testing.assert_array_equal(got, want)

        from sequencealigner_tpu.io import hdf5_io
        from sequencealigner_tpu.io.input import SequenceSet
        from sequencealigner_tpu import matrices

        m = matrices.get("blosum62")
        ss = SequenceSet.from_list(
            [np.frombuffer(b"ARNDC", np.uint8)] * n, m.lut)
        p = str(tmp_path / "perm.h5")
        hdf5_io.write(p, st, ss, progress=False)
        import h5py

        with h5py.File(p) as f:
            np.testing.assert_array_equal(
                np.asarray(f["/similarity_matrix"]), want)

    def test_permuted_plan_gated_on_spill(self):
        # In-RAM plans ignore perm; only spilling stores adopt the layout.
        st = OutputStore.plan(16, perm=np.arange(16)[::-1])
        assert st.pos is None

    def test_permuted_engine_ordered_offsets_ascend(self):
        """The property the layout exists for: a combo-ordered stream of
        original pairs maps to strictly ascending packed offsets."""
        from sequencealigner_tpu.scheduler import Schedule, linear_to_pair

        rng = np.random.default_rng(11)
        lengths = rng.integers(10, 200, 500).astype(np.int32)
        sched = Schedule.build(lengths)
        st = OutputStore(500, triangular=True, spill=False, perm=sched.order)
        b = max(range(len(sched.buckets)),
                key=lambda k: sched.buckets[k].count)
        bb = sched.buckets[b]
        lin = np.arange(0, min(4000, bb.count * (bb.count - 1) // 2),
                        dtype=np.int64)
        rk, rc = linear_to_pair(lin)
        ok = sched.order[bb.start + rk]
        oc = sched.order[bb.start + rc]
        oi, oj = np.minimum(ok, oc), np.maximum(ok, oc)
        ti, tj = st._translate(oi, oj)
        off = tj * (tj - 1) // 2 + ti
        assert (np.diff(off) > 0).all()


class TestHdf5:
    def test_chunk_heuristic(self):
        # dim <= 256 -> contiguous; else prev-pow2 clamped to [256, 4096].
        assert hdf5_io.chunk_dim(100, 0) is None
        assert hdf5_io.chunk_dim(256, 0) is None
        assert hdf5_io.chunk_dim(300, 0) == 256
        assert hdf5_io.chunk_dim(1000, 0) == 512
        assert hdf5_io.chunk_dim(5000, 0) == 4096
        assert hdf5_io.chunk_dim(100000, 9) == 4096

    @pytest.mark.parametrize("triangular", [False, True])
    def test_roundtrip(self, tmp_path, triangular):
        import h5py

        p = tmp_path / "in.fasta"
        p.write_bytes(b">a\nARND\n>b\nCQ\n>c\nGHIL\n")
        ss = sio.load(p, LUT)
        st = OutputStore(3, triangular=triangular, spill=False)
        ii, jj = np.triu_indices(3, 1)
        st.fill_pairs(ii, jj, np.array([5, -3, 9], np.int32))
        out = tmp_path / "out.h5"
        hdf5_io.write(str(out), st, ss, progress=False)
        with h5py.File(out) as f:
            assert list(f["/sequences"].asstr()) == ["ARND", "CQ", "GHIL"]
            m = f["/similarity_matrix"][...]
            assert m.dtype == np.dtype("<i4")
            expected = np.array(
                [[0, 5, -3], [5, 0, 9], [-3, 9, 0]], dtype=np.int32
            )
            np.testing.assert_array_equal(m, expected)

    def test_compression(self, tmp_path):
        import h5py

        p = tmp_path / "in.fasta"
        seqs = b"".join(b">s%d\nARNDCQEGHILK\n" % i for i in range(300))
        p.write_bytes(seqs)
        ss = sio.load(p, LUT)
        st = OutputStore(300, triangular=True, spill=False)
        ii, jj = np.triu_indices(300, 1)
        st.fill_pairs(ii, jj, np.arange(len(ii), dtype=np.int32))
        out = tmp_path / "out.h5"
        hdf5_io.write(str(out), st, ss, compression=6, progress=False)
        with h5py.File(out) as f:
            d = f["/similarity_matrix"]
            assert d.compression == "gzip" and d.compression_opts == 6
            assert d.chunks == (256, 256)
            assert d[5, 10] == st.get_pair(5, 10)
