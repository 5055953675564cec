"""The GPU DP kernel's wrapper, build and engine wiring.

The CUDA kernel has no interpret mode: on the CPU these tests check what
surrounds it (shapes, int8 narrowing, padding, chunk choice, the nvcc
command line and build errors, the engine's superblock widths).  Tests
marked ``gpu`` run the kernel itself against the XLA reference and skip
where there is no card."""

import subprocess
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sequencealigner_tpu import matrices
from sequencealigner_tpu.engine import GPU_PAIRS, Engine, make_mesh
from sequencealigner_tpu.ops import gpu_dp, oracle, xla_dp
from sequencealigner_tpu.ops.xla_dp import PAD, padded_submatrix

M = matrices.get("blosum62")
SUB_P = padded_submatrix(M.matrix)
GAPS = {"nw": (-4, 0, 0), "ga": (0, -10, -1), "sw": (0, -10, -1)}


def _ffi_eqn(B, Lc, Lk, algo, dtype=jnp.int32):
    """The ffi_call equation of the wrapper's jaxpr (no card needed)."""
    args = (
        jax.ShapeDtypeStruct((B, Lc), dtype),
        jax.ShapeDtypeStruct((B, Lk), dtype),
        jax.ShapeDtypeStruct((B,), jnp.int32),
        jax.ShapeDtypeStruct((B,), jnp.int32),
        jax.ShapeDtypeStruct((25, 25), jnp.int32),
        jax.ShapeDtypeStruct((3,), jnp.int32),
    )
    f = lambda *a: gpu_dp.align_block(*a, algo=algo, Lc=Lc, Lk=Lk)
    out = jax.eval_shape(f, *args)
    jaxpr = jax.make_jaxpr(f)(*args)
    eqns = [e for e in jaxpr.eqns if e.primitive.name == "ffi_call"]
    assert len(eqns) == 1
    return out, eqns[0]


@pytest.mark.parametrize("B,Lc,Lk,algo", [
    (300, 40, 33, "ga"),     # ragged B, Lk past one 32-row chunk
    (128, 64, 16, "nw"),     # whole blocks, 16-row chunk
    (1, 24, 24, "sw"),       # one pair -> one padded block
    (4096, 2048, 1536, "ga"),
])
def test_wrapper_shapes_and_padding(B, Lc, Lk, algo):
    out, eqn = _ffi_eqn(B, Lc, Lk, algo)
    assert out.shape == (B,) and out.dtype == jnp.int32
    R = gpu_dp.chunk_rows(Lk)
    Bp = max(gpu_dp.THREADS, -(-B // gpu_dp.THREADS) * gpu_dp.THREADS)
    Lkp = -(-Lk // R) * R
    s1t, s2t, l1, l2, sub, gaps = (v.aval for v in eqn.invars)
    # Codes are narrowed to int8 and laid out pair-minor.
    assert (s1t.shape, s1t.dtype) == ((Lc, Bp), jnp.int8)
    assert (s2t.shape, s2t.dtype) == ((Lkp, Bp), jnp.int8)
    assert l1.shape == l2.shape == (Bp,)
    assert sub.shape == (25, 25) and gaps.shape == (3,)
    scores, scratch = (v.aval for v in eqn.outvars)
    assert scores.shape == (Bp,)
    assert scratch.shape == ((1 if algo == "nw" else 2), Lc, Bp)
    assert eqn.params["target_name"] == gpu_dp.TARGET
    assert dict(eqn.params["attributes"]) == {
        "algo": gpu_dp.ALGO_IDS[algo], "rows": R
    }


def test_wrapper_pads_with_pad_code_and_zero_lengths(monkeypatch):
    """Padding pairs have length 0 (no kernel work) and padding rows and
    pairs hold the PAD code, which scores BIG_NEG."""
    captured = {}

    def fake_call(name, shapes):
        def call(s1t, s2t, l1, l2, sub, gaps, **attrs):
            captured.update(s1t=s1t, s2t=s2t, l1=l1, l2=l2)
            return tuple(jnp.zeros(s.shape, s.dtype) for s in shapes)
        return call

    rng = np.random.default_rng(0)
    B, Lc, Lk = 5, 12, 20
    s1 = rng.integers(0, 20, (B, Lc)).astype(np.int32)
    s2 = rng.integers(0, 20, (B, Lk)).astype(np.int32)
    l1 = np.full(B, Lc, np.int32)
    l2 = np.full(B, Lk, np.int32)
    monkeypatch.setattr(jax.ffi, "ffi_call", fake_call)
    out = gpu_dp.align_block(s1, s2, l1, l2, SUB_P, np.zeros(3, np.int32),
                             algo="ga", Lc=Lc, Lk=Lk)
    assert out.shape == (B,)
    s1t, s2t = np.asarray(captured["s1t"]), np.asarray(captured["s2t"])
    np.testing.assert_array_equal(s1t[:, :B], s1.T)
    np.testing.assert_array_equal(s2t[:Lk, :B], s2.T)
    assert (s1t[:, B:] == PAD).all() and (s2t[Lk:] == PAD).all()
    assert (s2t[:, B:] == PAD).all()
    assert (np.asarray(captured["l1"])[B:] == 0).all()
    assert (np.asarray(captured["l2"])[B:] == 0).all()


@pytest.mark.parametrize("Lk,R", [
    (1, 16), (16, 16), (17, 24), (24, 24), (25, 32), (32, 32), (33, 32),
    (2048, 32),
])
def test_chunk_rows(Lk, R):
    assert gpu_dp.chunk_rows(Lk) == R
    assert R in gpu_dp.CHUNK_ROWS


def test_nvcc_command_targets_hopper():
    cmd = gpu_dp.nvcc_command("nvcc", gpu_dp.SOURCE, gpu_dp.library_path(),
                              jax.ffi.include_dir())
    joined = " ".join(cmd)
    assert "arch=compute_90a,code=sm_90a" in joined
    assert cmd[cmd.index("-I") + 1] == jax.ffi.include_dir()
    assert "-shared" in cmd and "-fPIC" in cmd
    assert cmd[-1] == str(gpu_dp.SOURCE) and gpu_dp.SOURCE.exists()


def test_library_built_into_ignored_dir_keyed_by_source(tmp_path):
    so = gpu_dp.library_path()
    assert so.parent == gpu_dp.BUILD_DIR == gpu_dp.ROOT / "build"
    ignored = (gpu_dp.ROOT / ".gitignore").read_text().split()
    assert "build/" in ignored, "build output must be gitignored"
    other = tmp_path / "dp.cu"
    other.write_bytes(gpu_dp.SOURCE.read_bytes() + b"\n// changed\n")
    assert gpu_dp.library_path(other) != so


def test_build_failure_raises_with_compiler_message(tmp_path, monkeypatch):
    monkeypatch.setattr(gpu_dp, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(gpu_dp, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(
        gpu_dp.subprocess, "run",
        lambda cmd, **k: subprocess.CompletedProcess(
            cmd, 1, "", "dp_hopper.cu(7): error: boom"),
    )
    with pytest.raises(RuntimeError, match="boom"):
        gpu_dp.build()
    assert not list(tmp_path.iterdir())  # no partial library left behind


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(gpu_dp.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        gpu_dp.find_nvcc()


@pytest.mark.parametrize("Lc,Lk,npairs,ndev", [
    (64, 64, 10, 1),          # tiny combo: one block of threads
    (384, 256, 10**6, 1),     # large combo: full launch
    (8192, 8192, 10**6, 1),   # long pairs: scratch cap
    (384, 256, 5000, 4),      # four devices: per-device slices
])
def test_kernel_superblock_width(Lc, Lk, npairs, ndev):
    eng = Engine("ga", M.matrix, (0, -10, -1), mesh=make_mesh("cpu", ndev))
    eng.scorer = "kernel"  # width policy only; nothing is dispatched
    w = eng._superblock_width(Lc, Lk, npairs)
    per_dev = w // ndev
    assert w % ndev == 0 and per_dev % gpu_dp.THREADS == 0
    assert per_dev & (per_dev - 1) == 0  # powers of two: few compiled shapes
    assert per_dev <= GPU_PAIRS
    assert 2 * Lc * per_dev * 4 <= (1 << 30)  # scratch bound
    assert per_dev * ndev >= min(npairs, GPU_PAIRS * ndev) or Lc > 4096


def test_cpu_engine_uses_xla_scorer():
    eng = Engine("ga", M.matrix, (0, -10, -1), device_kind="cpu")
    assert eng.platform == "cpu" and eng.scorer == "xla"


# ---------------------------------------------------------------------------
# On the card


def _block(rng, B, Lc, Lk):
    l1 = rng.integers(1, Lc + 1, B).astype(np.int32)
    l2 = rng.integers(1, Lk + 1, B).astype(np.int32)
    l1[0], l2[0] = Lc, Lk
    s1 = np.full((B, Lc), PAD, np.int8)
    s2 = np.full((B, Lk), PAD, np.int8)
    for b in range(B):
        s1[b, : l1[b]] = rng.integers(0, 20, l1[b])
        s2[b, : l2[b]] = rng.integers(0, 20, l2[b])
    return s1, s2, l1, l2


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["nw", "ga", "sw"])
def test_kernel_matches_reference_on_gpu(gpu, algo):
    gpu_dp.ensure_registered()
    g = np.array(GAPS[algo], np.int32)
    for Lc, Lk in [(21, 13), (40, 24), (40, 25), (70, 33), (300, 257)]:
        rng = np.random.default_rng(zlib.crc32(f"{algo}{Lc}{Lk}".encode()))
        s1, s2, l1, l2 = _block(rng, 200, Lc, Lk)
        args = [jax.device_put(x, gpu) for x in (s1, s2, l1, l2, SUB_P, g)]
        got = np.asarray(jax.jit(
            gpu_dp.align_block, static_argnames=("algo", "Lc", "Lk")
        )(*args, algo=algo, Lc=Lc, Lk=Lk))
        want = np.asarray(xla_dp.align_block(*args, algo=algo, Lc=Lc, Lk=Lk))
        np.testing.assert_array_equal(got, want, err_msg=f"{Lc}x{Lk}")
        for b in range(4):
            assert got[b] == oracle.align_score(
                algo, s1[b, : l1[b]], s2[b, : l2[b]], M.matrix,
                gap=int(g[0]), opn=int(g[1]), ext=int(g[2]),
            )


@pytest.mark.gpu
def test_engine_on_gpu_matches_cpu(gpu):
    from sequencealigner_tpu.io.input import SequenceSet
    from sequencealigner_tpu.io.output import OutputStore

    rng = np.random.default_rng(5)
    seqs = [rng.choice(np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8),
                       int(n)) for n in rng.integers(5, 300, 150)]
    ss = SequenceSet.from_list(seqs, M.lut)
    stores = []
    for kind in ("gpu", "cpu"):
        st = OutputStore(ss.num, triangular=False, spill=False)
        eng = Engine("sw", M.matrix, (0, -10, -1), device_kind=kind)
        assert eng.scorer == ("kernel" if kind == "gpu" else "xla")
        eng.align_all(ss, st, progress=False)
        stores.append(np.asarray(st.matrix))
    np.testing.assert_array_equal(stores[0], stores[1])
