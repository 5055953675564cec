"""End-to-end engine tests: all-vs-all scores vs the NumPy oracle, full vs
triangular stores, multi-device sharding on the virtual CPU mesh."""

import functools

import numpy as np
import pytest

from sequencealigner_tpu import matrices
from sequencealigner_tpu.engine import Engine, make_mesh
from sequencealigner_tpu.filter import filter_sequences
from sequencealigner_tpu.io.input import SequenceSet
from sequencealigner_tpu.io.output import OutputStore
from sequencealigner_tpu.ops import oracle
from sequencealigner_tpu.scheduler import Schedule

M = matrices.get("blosum62")


def make_set(rng, n, lmin=1, lmax=40, alphabet=b"ARNDCQEGHILKMFPSTWYV"):
    seqs = []
    for _ in range(n):
        ln = int(rng.integers(lmin, lmax + 1))
        chars = rng.choice(list(alphabet), ln).astype(np.uint8)
        seqs.append(chars)
    return SequenceSet.from_list(seqs, M.lut)


def oracle_matrix(ss, algo, gaps):
    n = ss.num
    out = np.zeros((n, n), dtype=np.int32)
    kw = {"gap": gaps[0], "opn": gaps[1], "ext": gaps[2]}
    idx = [M.lut[ss.data[ss.offsets[i] : ss.offsets[i + 1]]] for i in range(n)]
    for j in range(1, n):
        for i in range(j):
            s = oracle.align_score(algo, idx[j], idx[i], M.matrix, **kw)
            out[i, j] = out[j, i] = s
    return out


@pytest.mark.parametrize("algo,gaps", [("nw", (-4, 0, 0)), ("ga", (0, -10, -1)), ("sw", (0, -10, -1))])
def test_engine_matches_oracle(algo, gaps):
    rng = np.random.default_rng(42)
    ss = make_set(rng, 17)
    store = OutputStore(ss.num, triangular=False, spill=False)
    eng = Engine(algo, M.matrix, gaps, target_cells=1 << 14)
    stats = eng.align_all(ss, store, progress=False)
    want = oracle_matrix(ss, algo, gaps)
    got = np.asarray(store.matrix).reshape(ss.num, ss.num)
    np.testing.assert_array_equal(got, want)
    assert stats.pairs == ss.num * (ss.num - 1) // 2
    ls = ss.lengths.astype(np.int64)
    assert stats.cells == ((ls.sum() ** 2 - (ls * ls).sum()) // 2)


def test_engine_triangular_store_equivalent():
    rng = np.random.default_rng(3)
    ss = make_set(rng, 11)
    full = OutputStore(ss.num, triangular=False, spill=False)
    tri = OutputStore(ss.num, triangular=True, spill=False)
    eng = Engine("nw", M.matrix, (-5, 0, 0), target_cells=1 << 14)
    eng.align_all(ss, full, progress=False)
    eng.align_all(ss, tri, progress=False)
    for r in range(ss.num):
        np.testing.assert_array_equal(full.row(r), tri.row(r))


def test_engine_permuted_store_equivalent():
    """Sorted-coordinate (spill-layout) store driven by the real engine
    flush stream reproduces the plain store's matrix exactly."""
    rng = np.random.default_rng(13)
    ss = make_set(rng, 29)
    perm = np.argsort(ss.lengths, kind="stable")
    plain = OutputStore(ss.num, triangular=True, spill=False)
    permu = OutputStore(ss.num, triangular=True, spill=False, perm=perm)
    eng = Engine("ga", M.matrix, (0, -10, -1), target_cells=1 << 14)
    eng.align_all(ss, plain, progress=False)
    eng.align_all(ss, permu, progress=False)
    np.testing.assert_array_equal(plain.rows(0, ss.num), permu.rows(0, ss.num))


def test_engine_multi_device_mesh_matches_single():
    rng = np.random.default_rng(7)
    ss = make_set(rng, 23)
    mesh8 = make_mesh("cpu", 8)
    assert mesh8.devices.size == 8
    s1 = OutputStore(ss.num, triangular=False, spill=False)
    s8 = OutputStore(ss.num, triangular=False, spill=False)
    Engine("ga", M.matrix, (0, -11, -1), target_cells=1 << 14).align_all(
        ss, s1, progress=False
    )
    Engine("ga", M.matrix, (0, -11, -1), mesh=mesh8, target_cells=1 << 14).align_all(
        ss, s8, progress=False
    )
    np.testing.assert_array_equal(np.asarray(s1.matrix), np.asarray(s8.matrix))


@pytest.mark.parametrize("algo,gaps", [
    ("nw", (-4, 0, 0)), ("sw", (0, -9, -2)), ("ga", (0, -10, -1)),
])
def test_multi_device_mesh_multi_bucket_matches_oracle(algo, gaps):
    """Several buckets (cross-bucket rectangles and same-bucket triangles)
    on the 8-device virtual mesh: each superblock is split over devices
    under shard_map, padding slots included, and the matrix equals the
    oracle's."""
    rng = np.random.default_rng(21)
    seqs = [
        rng.choice(list(b"ARNDCQEGHILKMFPSTWYV"), int(ln)).astype(np.uint8)
        for ln in np.r_[rng.integers(3, 9, 64), rng.integers(33, 41, 64)]
    ]
    ss = SequenceSet.from_list(seqs, M.lut)
    store = OutputStore(ss.num, triangular=False, spill=False)
    eng = Engine(algo, M.matrix, gaps, mesh=make_mesh("cpu", 8),
                 target_cells=1 << 14)
    assert len(Schedule.build(ss.lengths).buckets) == 2
    stats = eng.align_all(ss, store, progress=False)
    assert stats.pairs == ss.num * (ss.num - 1) // 2
    want = oracle_matrix(ss, algo, gaps)
    got = np.asarray(store.matrix).reshape(ss.num, ss.num)
    np.testing.assert_array_equal(got, want)


def test_progress_counts_exact_with_poller(monkeypatch):
    """The is_ready() poller (live progress) and the flush path must not
    double-count: the bar ends exactly at the total pair count."""
    from sequencealigner_tpu import ui

    bars = []
    orig = ui.Progress

    class Rec(orig):
        def __init__(self, total, label):
            super().__init__(total, label)
            bars.append(self)

    monkeypatch.setattr(ui, "Progress", Rec)
    rng = np.random.default_rng(5)
    ss = make_set(rng, 40)
    eng = Engine("ga", M.matrix, (0, -10, -1), target_cells=1 << 14)
    eng.align_all(ss, None, progress=True)
    assert bars and bars[0].count == bars[0].total == ss.num * (ss.num - 1) // 2


def test_oversized_substitution_matrix_scores_exactly():
    """|sub| > 127 (no shipped matrix; a custom one could) keeps exact int32
    scores: no scorer has an int8 table, and the int16 transfer bound uses
    the matrix's real range."""
    rng = np.random.default_rng(11)
    ss = make_set(rng, 9)
    big = np.asarray(M.matrix, np.int32) * 100  # |scores| up to 1100
    eng = Engine("ga", big, (0, -10, -1), target_cells=1 << 14)
    assert not eng._int16_ok(64, 64)
    store = OutputStore(ss.num, triangular=False, spill=False)
    eng.align_all(ss, store, progress=False)
    n = ss.num
    idx = [M.lut[ss.data[ss.offsets[i] : ss.offsets[i + 1]]] for i in range(n)]
    got = np.asarray(store.matrix).reshape(n, n)
    for j in range(1, n):
        for i in range(j):
            want = oracle.align_score(
                "ga", idx[j], idx[i], big, gap=0, opn=-10, ext=-1
            )
            assert got[i, j] == want


def test_engine_mixed_extreme_lengths():
    rng = np.random.default_rng(9)
    seqs = [
        rng.choice(list(b"ARNDC"), ln).astype(np.uint8)
        for ln in (1, 2, 3, 50, 51, 120, 121, 250, 1)
    ]
    ss = SequenceSet.from_list(seqs, M.lut)
    store = OutputStore(ss.num, triangular=False, spill=False)
    Engine("sw", M.matrix, (0, -8, -2), target_cells=1 << 14).align_all(
        ss, store, progress=False
    )
    want = oracle_matrix(ss, "sw", (0, -8, -2))
    np.testing.assert_array_equal(
        np.asarray(store.matrix).reshape(ss.num, ss.num), want
    )


class TestFilter:
    def _ss(self, strs):
        return SequenceSet.from_list(
            [np.frombuffer(s.encode(), np.uint8) for s in strs], M.lut
        )

    def test_no_threshold_noop(self):
        ss = self._ss(["ARND", "ARND"])
        out, dropped = filter_sequences(ss, 0.0, progress=False)
        assert dropped == 0 and out is ss

    def test_exact_duplicates_dropped(self):
        ss = self._ss(["ARND", "ARND", "CQEG"])
        out, dropped = filter_sequences(ss, 0.9, progress=False)
        assert dropped == 1
        assert [out.get_str(i) for i in range(out.num)] == ["ARND", "CQEG"]

    def test_greedy_keep_first_semantics(self):
        # B similar to A (dropped); C similar to B but NOT to A: since B was
        # dropped, C survives — the keep-first greedy chain.
        a = "AAAAAAAAAA"
        b = "AAAAAAAACC"  # 8/10 vs a
        c = "AAAAAACCCC"  # 6/10 vs a, 8/10 vs b
        ss = self._ss([a, b, c])
        out, dropped = filter_sequences(ss, 0.7, progress=False)
        assert dropped == 1
        assert [out.get_str(i) for i in range(out.num)] == [a, c]

    def test_min_length_prefix_identity(self):
        # matches/min(len) over the common prefix (filter.c:48-54): "ARND"
        # vs "ARNDXXXX" is 4/4 = 1.0.
        ss = self._ss(["ARND", "ARNDWWWW", "CCCC"])
        out, dropped = filter_sequences(ss, 0.99, progress=False)
        assert dropped == 1
        assert out.get_str(0) == "ARND"

    def test_threshold_boundary(self):
        # exactly at threshold -> dropped (>= comparison)
        ss = self._ss(["AAAA", "AACC"])
        out, dropped = filter_sequences(ss, 0.5, progress=False)
        assert dropped == 1
        out, dropped = filter_sequences(ss, 0.51, progress=False)
        assert dropped == 0

    def test_blocked_matches_unblocked(self):
        rng = np.random.default_rng(5)
        strs = [
            "".join(rng.choice(list("AC"), rng.integers(4, 12)))
            for _ in range(40)
        ]
        ss = self._ss(strs)
        # block=4 -> segments of 32: the pair space CROSSES dispatch
        # segments, exercising the device-reduced prior-segment verdicts.
        a, da = filter_sequences(ss, 0.6, block=4, progress=False)
        b, db = filter_sequences(ss, 0.6, block=512, progress=False)
        assert da == db
        assert [a.get_str(i) for i in range(a.num)] == [
            b.get_str(i) for i in range(b.num)
        ]

    def test_cross_segment_kill_and_cascade(self):
        # Segment-1's base kills B in segment 2 (prior-segment verdict);
        # C (same segment as B) is similar only to the KILLED B, not to
        # base, so C must survive — the greedy cascade must see B's
        # non-kept status from the device-reduced verdict.  block=1 ->
        # segment size 8: base idx 0, B idx 8, C idx 9.
        base = "AAAAAAAAAA"
        b = "AAAAAAAACC"    # 8/10 vs base -> killed by base
        c = "AAAAAACCCC"    # 6/10 vs base (survives), 8/10 vs b
        filler = ["GGGGCCCCGG", "CCCCGGGGCC", "GCGCGCGCGC", "CGCGCGCGCG",
                  "GGCCGGCCGG", "CCGGCCGGCC", "GCCGGCCGGC"]
        strs = [base] + filler + [b, c]
        ss = self._ss(strs)
        out, dropped = filter_sequences(ss, 0.75, block=1, progress=False)
        kept = [out.get_str(i) for i in range(out.num)]
        assert dropped == 1 and base in kept and c in kept and b not in kept


def test_engine_long_sequences_streamed_path():
    """Lengths far beyond the reference's 1023-char GPU cap route through the
    streamed scorer; scores must match the oracle."""
    from sequencealigner_tpu.ops import oracle

    rng = np.random.default_rng(23)
    seqs = [
        rng.choice(np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8),
                   int(rng.integers(1100, 2100)))
        for _ in range(4)
    ]
    ss = SequenceSet.from_list(seqs, M.lut)
    eng = Engine("ga", M.matrix, (0, -10, -1), device_kind="cpu")
    store = OutputStore(ss.num, triangular=False, spill=False)
    stats = eng.align_all(ss, store, progress=False)
    assert stats.pairs == 6
    i0, i1 = M.lut[seqs[0]], M.lut[seqs[1]]
    want = oracle.ga_affine(i0, i1, M.matrix, -10, -1)
    assert store.get_pair(0, 1) == want


def test_int64_pair_ids_preserved_on_device():
    """Linear pair ids must stay 64-bit on device (explicit_x64_dtypes=allow;
    a plain device_put would silently truncate past 2^31)."""
    import jax
    import jax.numpy as jnp

    eng = Engine("nw", M.matrix, (-4, 0, 0), device_kind="cpu")
    big = eng._put_i64(np.array([2**40 + 7]))
    assert big.dtype == jnp.int64
    assert int(big[0]) == 2**40 + 7
    # the in-jit id arithmetic keeps 64 bits too
    f = jax.jit(lambda t: t + jnp.arange(4, dtype=jnp.int64))
    out = f(big[0])
    assert out.dtype == jnp.int64 and int(out[3]) == 2**40 + 10


def test_large_gap_penalties_exceed_int16():
    """Scores beyond int16 range (legal with large -p) must come back exact —
    the int16 transfer shortcut may only engage when the bound allows."""
    rng = np.random.default_rng(31)
    seqs = [
        rng.choice(np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8), ln)
        for ln in (1, 120, 128)
    ]
    ss = SequenceSet.from_list(seqs, M.lut)
    gaps = (-300, 0, 0)
    store = OutputStore(ss.num, triangular=False, spill=False)
    Engine("nw", M.matrix, gaps, device_kind="cpu").align_all(
        ss, store, progress=False
    )
    want = oracle_matrix(ss, "nw", gaps)
    got = np.asarray(store.matrix).reshape(ss.num, ss.num)
    assert want.min() < -32768  # the scenario really exceeds int16
    np.testing.assert_array_equal(got, want)


def test_library_align_entry_point():
    """sequencealigner_tpu.align(): the documented library API."""
    import sequencealigner_tpu as sa

    seqs = ["ARNDCQ", "ARNDCC", "WWWWWW", "ARNDCQ"]
    m = sa.align(seqs, algo="nw", gap=4)
    assert m.shape == (4, 4) and (m == m.T).all() and m[0, 0] == 0
    idx = [matrices.get("blosum62").lut[np.frombuffer(s.encode(), np.uint8)]
           for s in seqs]
    want01 = oracle.align_score("nw", idx[0], idx[1], M.matrix, gap=-4, opn=0, ext=0)
    assert m[0, 1] == want01
    # filtered variant returns (matrix, kept original indices)
    m2, kept = sa.align(seqs, algo="sw", open=10, extend=1,
                        filter_threshold=0.99)
    assert list(kept) == [0, 1, 2]  # the duplicate of #0 is dropped
    assert m2.shape == (3, 3)


def test_align_all_limit_pairs():
    """limit_pairs truncates scheduling at a superblock boundary with
    consistent stats (the scale-benchmark knob)."""
    rng = np.random.default_rng(21)
    ss = make_set(rng, 60)
    eng = Engine("ga", M.matrix, (0, -10, -1), target_cells=1 << 12)
    total = ss.num * (ss.num - 1) // 2
    stats = eng.align_all(ss, None, progress=False, limit_pairs=total // 3)
    assert total // 3 <= stats.pairs < total
    full = eng.align_all(ss, None, progress=False)
    assert full.pairs == total


def test_triangle_inversion_int64_window():
    # Regression: same-bucket combos with 46342..65536 rows have npairs
    # < 2^31 but j*(j-1) overflows int32 — the engine must route them to
    # the int64 inversion (_int32_ids_ok) and the int64 path must be exact.
    import jax

    from sequencealigner_tpu.engine import _gather_pairs, _int32_ids_ok
    from sequencealigner_tpu.scheduler import linear_to_pair, pair_count

    count = 50_000
    npairs = pair_count(count)
    assert not _int32_ids_ok(npairs, True, count)
    assert _int32_ids_ok(npairs, False, count)
    assert _int32_ids_ok(pair_count(46_000), True, 46_000)

    bucket = np.zeros((count, 1), np.int8)
    lens = np.arange(count, dtype=np.int32)  # lens[r] = r reveals the row
    W = 64
    t0 = np.int64(npairs - W)  # the top of the triangle, where j is largest

    f = jax.jit(functools.partial(
        _gather_pairs, Wloc=W, mode="tri", small=False))
    _, _, l1, l2 = f(bucket, bucket, lens, lens, t0, np.int64(npairs))
    i_ref, j_ref = linear_to_pair(np.arange(t0, t0 + W))
    np.testing.assert_array_equal(np.asarray(l1), j_ref)  # rc = j
    np.testing.assert_array_equal(np.asarray(l2), i_ref)  # rk = i


def test_library_align_rejects_invalid_characters():
    import sequencealigner_tpu as sa

    with pytest.raises(ValueError, match="sequence 2.*'1'"):
        sa.align(["ARNDCQ", "ARND1Q", "ARNDCC"], algo="nw", gap=4)


@pytest.mark.parametrize(
    "algo,gaps", [("nw", (-4, 0, 0)), ("sw", (0, -9, -2)), ("ga", (0, -10, -1))]
)
def test_engine_two_buckets_match_oracle(algo, gaps):
    """Engine-level schedule for ALL three algorithms on one CPU device:
    two buckets that survive the small-bucket merge policy (edge ratio
    64/16 > 2), so cross-bucket rectangles and same-bucket triangles both
    run, over more than one superblock each."""
    rng = np.random.default_rng(21)
    seqs = [
        rng.choice(list(b"ARNDCQEGHILKMFPSTWYV"), int(ln)).astype(np.uint8)
        for ln in np.r_[rng.integers(10, 17, 140), rng.integers(50, 65, 70)]
    ]
    ss = SequenceSet.from_list(seqs, M.lut)
    eng = Engine(algo, M.matrix, gaps, device_kind="cpu", target_cells=1 << 16)
    assert eng.schedule_token(ss.lengths).startswith("linear-v1")
    store = OutputStore(ss.num, triangular=False, spill=False)
    stats = eng.align_all(ss, store, progress=False)
    assert stats.pairs == ss.num * (ss.num - 1) // 2
    want = oracle_matrix(ss, algo, gaps)
    got = np.asarray(store.matrix).reshape(ss.num, ss.num)
    np.testing.assert_array_equal(got, want)


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX's own setting stands and no
    other cache directory is configured in code."""
    import jax

    from sequencealigner_tpu import engine as eng_mod

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert eng_mod.enable_compile_cache.__wrapped__() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_inside_checkout(monkeypatch):
    import jax

    from sequencealigner_tpu import engine as eng_mod

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = eng_mod.enable_compile_cache.__wrapped__()
        assert got == str(eng_mod.DEFAULT_CACHE_DIR)
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    root = eng_mod.DEFAULT_CACHE_DIR.parent
    assert (root / "pyproject.toml").exists()
    ignored = (root / ".gitignore").read_text().split()
    assert eng_mod.DEFAULT_CACHE_DIR.name + "/" in ignored, (
        "the default cache must be gitignored")
