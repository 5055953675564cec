"""seqalign-tpu: all-vs-all pairwise sequence alignment engine in JAX, with a
CUDA DP kernel for NVIDIA Hopper GPUs.

Package-level JAX configuration (must precede any tracing in submodules):
linear pair ids and triangle tables are explicit int64 (they exceed 2^31
beyond ~65k sequences per bucket).  Rather than enabling x64 globally —
which makes Python scalar literals trace as 64-bit — explicit 64-bit dtypes
are simply respected while default promotion semantics stay 32-bit.
"""

import jax as _jax

_jax.config.update("jax_explicit_x64_dtypes", "allow")


def align(
    sequences,
    *,
    algo: str = "ga",
    matrix: str = "blosum62",
    gap: int = 4,
    open: int = 10,
    extend: int = 1,
    filter_threshold: float = 0.0,
    device: str = "auto",
    progress: bool = False,
):
    """Library entry point: all-vs-all similarity matrix for ``sequences``.

    sequences: iterable of str/bytes.  algo: "nw" (linear gap, uses ``gap``)
    | "ga" | "sw" (affine, use ``open``/``extend``).  Penalties are positive
    magnitudes, negated internally like the CLI (-p/-s/-e,
    reference src/bio/align.c:127-128).  Returns an (n, n) int32 NumPy
    array (0 on the diagonal); with filter_threshold > 0 returns
    (matrix, kept_indices) instead.

    >>> import sequencealigner_tpu as sa
    >>> m = sa.align(["ARNDCQ", "ARNDCC"], algo="nw", gap=4)
    """
    import numpy as np

    from . import filter as _filter
    from . import matrices as _matrices
    from .engine import Engine
    from .io.input import SequenceSet
    from .io.output import OutputStore

    m = _matrices.get(matrix)
    seqs = [
        np.frombuffer(s.upper().encode() if isinstance(s, str) else bytes(s).upper(),
                      np.uint8)
        for s in sequences
    ]
    # Validate like the CLI parsers do (fasta.c:56-66 semantics): a char
    # outside the matrix alphabet maps to LUT -1, which would silently wrap
    # into the substitution matrix's last row and corrupt scores.
    lut = np.asarray(m.lut)
    for sno, s in enumerate(seqs):
        bad = lut[s] < 0
        if bad.any():
            ch = chr(int(s[np.argmax(bad)]))
            raise ValueError(
                f"sequence {sno + 1}: invalid character {ch!r} for matrix "
                f"{matrix!r}"
            )
    ss = SequenceSet.from_list(seqs, m.lut)
    kept = None
    if filter_threshold > 0.0:
        ss, _dropped = _filter.filter_sequences(
            ss, filter_threshold, progress=progress
        )
        kept = ss.kept
    if algo == "nw":
        gaps = (-abs(int(gap)), 0, 0)
    else:
        gaps = (0, -abs(int(open)), -abs(int(extend)))
    store = OutputStore(ss.num, triangular=False, spill=False)
    eng = Engine(algo, m.matrix, gaps, device_kind=device)
    eng.align_all(ss, store, progress=progress)
    out = np.asarray(store.matrix).reshape(ss.num, ss.num)
    if filter_threshold > 0.0:
        return out, kept
    return out

