"""The scorer seam: which DP implementation scores a block of pairs.

One scorer per platform, chosen from what the engine can see (its mesh's
platform), never as a fallback after an error:

- ``gpu`` -> ``"kernel"``: the Hopper DP kernel (ops/gpu_dp.py), any length;
- anything else (``cpu``) -> ``"xla"``: the plain lax.scan wavefront
  (ops/xla_dp.py), streamed for long pairs.

The XLA scorer runs on any platform; it is the GPU kernel's reference, and
the comparison point for its measurements.  Every scorer keeps
``xla_dp.align_block``'s contract.
"""

from __future__ import annotations

from . import gpu_dp, xla_dp

#: Score-grid bytes per pair above which the XLA scorer streams the grid
#: (align_block_streamed) instead of materializing it.
STREAM_GRID_BYTES = 4 << 20


def kind_for(platform: str) -> str:
    """The scorer for a mesh on ``platform``."""
    return "kernel" if platform == "gpu" else "xla"


def score_block(kind, s1, s2, l1, l2, sub_p, gaps, *, algo, Lc, Lk):
    """(B,) int32 scores of one block with the scorer ``kind``."""
    if kind == "kernel":
        return gpu_dp.align_block(
            s1, s2, l1, l2, sub_p, gaps, algo=algo, Lc=Lc, Lk=Lk
        )
    if (Lc + Lk) * (Lk + 1) * 4 > STREAM_GRID_BYTES:
        return xla_dp.align_block_streamed(
            s1, s2, l1, l2, sub_p, gaps, algo=algo, Lc=Lc, Lk=Lk
        )
    return xla_dp.align_block(s1, s2, l1, l2, sub_p, gaps, algo=algo, Lc=Lc, Lk=Lk)
