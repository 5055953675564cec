// Pairwise DP scorer for Hopper (sm_90a), called from JAX through the XLA FFI
// (sequencealigner_tpu/ops/gpu_dp.py builds and registers it).
//
// One thread scores one pair, as the reference's CUDA path does
// (src/bio/kernels.cu:32-221), so a warp holds 32 pairs of one bucket combo
// and the scheduler's length buckets keep their work nearly uniform.
//
// - The padded 25x25 substitution table lives in shared memory; every cell
//   reads its score from it.  No score grid is written to device memory.
// - The DP rows (the shorter sequence) are processed in chunks of R rows held
//   in registers.  A chunk sweeps every column of its pair; between chunks
//   the bottom row's H (and, for affine gaps, its vertical-gap state Y) goes
//   through per-pair scratch laid out [column][pair], so the 32 threads of a
//   warp touch 32 consecutive words.
// - Inner max-plus steps use Hopper's DPX instructions (__viaddmax_s32,
//   __vimax3_s32, __vimax3_s32_relu).
//
// Semantics are those of ops/oracle.py and ops/xla_dp.py exactly: every
// state is clamped at SCORE_MIN like the XLA scan, NW/GA return cell
// (l2, l1), SW the running maximum with the zero floor.  Rows past l2 in a
// pair's last chunk and padding columns score PAD = BIG_NEG, which never
// reaches a valid cell (the DP moves right and down).  A pair with l2 = 0
// does no work and scores 0 (the engine's padding slots).

#include <cstddef>
#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kThreads = 128;        // threads (= pairs) per block
constexpr int kLutDim = 25;          // 24 letters + PAD
constexpr int kLutStride = 33;       // odd row stride spreads lookups over banks
constexpr int32_t kScoreMin = -(1 << 30);  // matrices.SCORE_MIN

enum Algo : int32_t { kNW = 0, kGA = 1, kSW = 2 };

template <int ALGO, int R>
__global__ void __launch_bounds__(kThreads) dp_kernel(
    const int8_t* __restrict__ s1t,    // (Lc, B) column codes
    const int8_t* __restrict__ s2t,    // (Lkp, B) row codes, Lkp % R == 0
    const int32_t* __restrict__ l1s,   // (B,) column lengths
    const int32_t* __restrict__ l2s,   // (B,) row lengths
    const int32_t* __restrict__ sub,   // (25, 25) padded substitution table
    const int32_t* __restrict__ gaps,  // (3,) gap, open, extend (all <= 0)
    int B, int32_t* __restrict__ out,  // (B,) scores
    int32_t* __restrict__ hrow,        // (Lc, B) chunk-crossing H
    int32_t* __restrict__ yrow) {      // (Lc, B) chunk-crossing Y (affine)
  __shared__ int32_t lut[kLutDim * kLutStride];
  for (int i = threadIdx.x; i < kLutDim * kLutDim; i += blockDim.x) {
    lut[(i / kLutDim) * kLutStride + i % kLutDim] = sub[i];
  }
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int l1 = l1s[b];
  const int l2 = l2s[b];
  const int32_t gap = gaps[0], opn = gaps[1], ext = gaps[2];
  const size_t stride = static_cast<size_t>(B);

  int32_t best = 0;   // SW running maximum
  int32_t score = 0;  // NW/GA capture of cell (l2, l1)
  int32_t hb = 0;     // H[r0][0]: left border of the row above the chunk
  int32_t yb = kScoreMin;  // Y[r0][0]

  for (int r0 = 0; r0 < l2; r0 += R) {
    const bool first = r0 == 0;
    const bool last = r0 + R >= l2;
    int32_t hl[R];  // H[r][c-1] of the chunk's rows
    int32_t xl[R];  // X[r][c-1] (horizontal gap state, affine)
    int roff[R];    // row code * kLutStride
    const int32_t corner = hb;  // H[r0][0]
#pragma unroll
    for (int i = 0; i < R; ++i) {
      roff[i] = s2t[static_cast<size_t>(r0 + i) * stride + b] * kLutStride;
      if (ALGO == kNW) {
        hb = __viaddmax_s32(hb, gap, kScoreMin);
      } else if (ALGO == kGA) {
        yb = __viaddmax_s32(hb, opn, __viaddmax_s32(yb, ext, kScoreMin));
        hb = yb;
      } else {
        hb = 0;
      }
      hl[i] = hb;
      xl[i] = kScoreMin;
    }

    int32_t th = 0;           // first chunk: H[0][c-1] of the top border
    int32_t tx = kScoreMin;   // first chunk: X[0][c-1]
    int32_t diag = corner;    // H[r0][c-1]
    for (int c = 1; c <= l1; ++c) {
      const size_t at = static_cast<size_t>(c - 1) * stride + b;
      const int32_t* lcol = lut + s1t[at];
      int32_t hup, yup = kScoreMin;  // H[r0][c], Y[r0][c]
      if (first) {
        if (ALGO == kNW) {
          th = __viaddmax_s32(th, gap, kScoreMin);
        } else if (ALGO == kGA) {
          tx = __viaddmax_s32(th, opn, __viaddmax_s32(tx, ext, kScoreMin));
          th = tx;
        }
        hup = th;  // SW: th stays 0
      } else {
        hup = hrow[at];
        if (ALGO != kNW) yup = yrow[at];
      }
      int32_t d = diag;
      diag = hup;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int32_t s = lcol[roff[i]];
        int32_t h;
        if (ALGO == kNW) {
          h = __viaddmax_s32(
              d, s,
              __viaddmax_s32(hup, gap, __viaddmax_s32(hl[i], gap, kScoreMin)));
        } else {
          const int32_t x =
              __viaddmax_s32(hl[i], opn, __viaddmax_s32(xl[i], ext, kScoreMin));
          yup = __viaddmax_s32(hup, opn, __viaddmax_s32(yup, ext, kScoreMin));
          if (ALGO == kGA) {
            h = __vimax3_s32(d + s, x, yup);
          } else {
            h = __vimax3_s32_relu(d + s, x, yup);
            best = max(best, h);
          }
          xl[i] = x;
        }
        d = hl[i];
        hl[i] = h;
        hup = h;
      }
      if (!last) {
        hrow[at] = hup;
        if (ALGO != kNW) yrow[at] = yup;
      }
    }
    if (last && ALGO != kSW) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (r0 + i + 1 == l2) score = hl[i];
      }
    }
  }
  out[b] = ALGO == kSW ? best : score;
}

template <int ALGO>
cudaError_t launch_rows(int rows, cudaStream_t stream, int grid,
                        const int8_t* s1t, const int8_t* s2t,
                        const int32_t* l1, const int32_t* l2,
                        const int32_t* sub, const int32_t* gaps, int B,
                        int32_t* out, int32_t* hrow, int32_t* yrow) {
  switch (rows) {
    case 16:
      dp_kernel<ALGO, 16><<<grid, kThreads, 0, stream>>>(
          s1t, s2t, l1, l2, sub, gaps, B, out, hrow, yrow);
      break;
    case 24:
      dp_kernel<ALGO, 24><<<grid, kThreads, 0, stream>>>(
          s1t, s2t, l1, l2, sub, gaps, B, out, hrow, yrow);
      break;
    case 32:
      dp_kernel<ALGO, 32><<<grid, kThreads, 0, stream>>>(
          s1t, s2t, l1, l2, sub, gaps, B, out, hrow, yrow);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

ffi::Error DpImpl(cudaStream_t stream, ffi::Buffer<ffi::S8> s1t,
                  ffi::Buffer<ffi::S8> s2t, ffi::Buffer<ffi::S32> l1,
                  ffi::Buffer<ffi::S32> l2, ffi::Buffer<ffi::S32> sub,
                  ffi::Buffer<ffi::S32> gaps, int32_t algo, int32_t rows,
                  ffi::ResultBuffer<ffi::S32> out,
                  ffi::ResultBuffer<ffi::S32> scratch) {
  const auto d1 = s1t.dimensions();
  const auto d2 = s2t.dimensions();
  const auto ds = scratch->dimensions();
  if (d1.size() != 2 || d2.size() != 2 || ds.size() != 3) {
    return ffi::Error::InvalidArgument("seqalign_dp: bad operand ranks");
  }
  const int64_t Lc = d1[0], B = d1[1], Lkp = d2[0];
  if (d2[1] != B || l1.element_count() != static_cast<size_t>(B) ||
      l2.element_count() != static_cast<size_t>(B) ||
      out->element_count() != static_cast<size_t>(B) ||
      sub.element_count() != kLutDim * kLutDim || gaps.element_count() != 3 ||
      rows <= 0 || Lkp % rows != 0 || ds[1] != Lc || ds[2] != B ||
      ds[0] != (algo == kNW ? 1 : 2)) {
    return ffi::Error::InvalidArgument("seqalign_dp: inconsistent shapes");
  }
  if (B == 0) return ffi::Error::Success();
  const int grid = static_cast<int>((B + kThreads - 1) / kThreads);
  int32_t* hrow = scratch->typed_data();
  int32_t* yrow = algo == kNW ? nullptr : hrow + Lc * B;
  const int8_t* a1 = s1t.typed_data();
  const int8_t* a2 = s2t.typed_data();
  const int32_t *n1 = l1.typed_data(), *n2 = l2.typed_data();
  const int32_t *tab = sub.typed_data(), *g = gaps.typed_data();
  int32_t* res = out->typed_data();
  const int nb = static_cast<int>(B);
  cudaError_t err;
  switch (algo) {
    case kNW:
      err = launch_rows<kNW>(rows, stream, grid, a1, a2, n1, n2, tab, g, nb,
                             res, hrow, yrow);
      break;
    case kGA:
      err = launch_rows<kGA>(rows, stream, grid, a1, a2, n1, n2, tab, g, nb,
                             res, hrow, yrow);
      break;
    case kSW:
      err = launch_rows<kSW>(rows, stream, grid, a1, a2, n1, n2, tab, g, nb,
                             res, hrow, yrow);
      break;
    default:
      return ffi::Error::InvalidArgument("seqalign_dp: unknown algorithm");
  }
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("seqalign_dp: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(SeqalignDp, DpImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()   // s1t
                                  .Arg<ffi::Buffer<ffi::S8>>()   // s2t
                                  .Arg<ffi::Buffer<ffi::S32>>()  // l1
                                  .Arg<ffi::Buffer<ffi::S32>>()  // l2
                                  .Arg<ffi::Buffer<ffi::S32>>()  // sub
                                  .Arg<ffi::Buffer<ffi::S32>>()  // gaps
                                  .Attr<int32_t>("algo")
                                  .Attr<int32_t>("rows")
                                  .Ret<ffi::Buffer<ffi::S32>>()   // scores
                                  .Ret<ffi::Buffer<ffi::S32>>());  // scratch
