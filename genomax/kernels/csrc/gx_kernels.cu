// Hopper wavefront kernels for SW and PairHMM scoring, called from JAX
// through the XLA FFI (genomax/kernels/cuda.py builds and registers them).
//
// One group of G threads (4, 8, 16 or 32 lanes of one warp) scores one
// pair; each lane keeps C cells of DP state in registers, and the group
// sweeps the streamed sequence with a skew of one step per lane, passing
// boundary cells by warp shuffle (gx_cells.h has the mapping and the
// per-cell arithmetic). The handlers only enqueue work on XLA's stream.

#include <cuda_runtime.h>

#include <string>

#include "gx_cells.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlock = 128;

// Stream codes for the group: rank r holds element base + r.
__device__ __forceinline__ int prefetch_stream(const int8_t* buf, int t,
                                               int nds, int nxs, int l,
                                               int k, int len) {
  return k < len ? gx::stream_code(buf, t, nds, nxs, l, k) : 0;
}

template <int C>
__global__ void __launch_bounds__(kBlock)
    sw_kernel(const int8_t* __restrict__ sx, const int8_t* __restrict__ sy,
              const int32_t* __restrict__ nx, const int32_t* __restrict__ ny,
              int32_t* __restrict__ out, int nxs, int nds, int group,
              gx::SWParams prm) {
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int pair = gtid / group;
  const int rank = gtid - pair * group;
  const int t = pair / gx::kLanes, l = pair % gx::kLanes;
  const int lenx = nx[pair] - 1, leny = ny[pair] - 1;

  gx::SWLane<C> L;
  gx::sw_lane_load(L, sx, t, nxs, l, rank, lenx);

  const int steps = __reduce_max_sync(kFull, leny + group - 1);
  int send_d = 0, send_q = gx::kNegGap, send_y = 0;
  int ynext = prefetch_stream(sy, t, nds, nxs, l, rank, leny);
  for (int base = 0; base < steps; base += group) {
    const int ycur = ynext;
    ynext = prefetch_stream(sy, t, nds, nxs, l, base + group + rank, leny);
    for (int u = 0; u < group; ++u) {
      int in_d = __shfl_up_sync(kFull, send_d, 1, group);
      int in_q = __shfl_up_sync(kFull, send_q, 1, group);
      int y = __shfl_up_sync(kFull, send_y, 1, group);
      const int y0 = __shfl_sync(kFull, ycur, u, group);
      if (rank == 0) {
        in_d = 0;
        in_q = gx::kNegGap;
        y = y0;
      }
      const int i = base + u - rank + 1;
      if (i >= 1 && i <= leny) {
        gx::sw_lane_row(L, y, in_d, in_q, prm, send_d, send_q);
      }
      send_y = y;
    }
  }
  int best = L.best;
  for (int off = group / 2; off > 0; off /= 2) {
    best = gx::imax(best, __shfl_xor_sync(kFull, best, off, group));
  }
  if (rank == 0) out[pair] = best;
}

template <int C, bool kBitmask>
__global__ void __launch_bounds__(kBlock)
    phmm_kernel(const int8_t* __restrict__ rchar, const float* __restrict__ qr,
                const float* __restrict__ mmv, const float* __restrict__ gapm,
                const float* __restrict__ qi, const float* __restrict__ qd,
                const float* __restrict__ qg, const int8_t* __restrict__ hap,
                const int32_t* __restrict__ rl_arr,
                const int32_t* __restrict__ hl_arr, float* __restrict__ out,
                int nxs, int nds, int group, float inv_mm_div) {
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int pair = gtid / group;
  const int rank = gtid - pair * group;
  const int t = pair / gx::kLanes, l = pair % gx::kLanes;
  const int rl = rl_arr[pair], hl = hl_arr[pair];

  gx::PhmmLane<C> L;
  gx::phmm_lane_load<C, kBitmask>(L, rchar, qr, mmv, gapm, qi, qd, qg, t,
                                  nxs, l, rank, rl, inv_mm_div);
  gx::phmm_lane_start(L, rank, hl);
  const float y0 = gx::phmm_row0(hl);
  const bool owns_rows = rank * C < rl;

  const int steps = __reduce_max_sync(kFull, hl + group - 1);
  float send_m = 0.0f, send_x = 0.0f, send_y = 0.0f;
  int send_h = 0;
  int hnext = prefetch_stream(hap, t, nds, nxs, l, rank, hl);
  for (int base = 0; base < steps; base += group) {
    const int hcur = hnext;
    hnext = prefetch_stream(hap, t, nds, nxs, l, base + group + rank, hl);
    for (int u = 0; u < group; ++u) {
      float in_m = __shfl_up_sync(kFull, send_m, 1, group);
      float in_x = __shfl_up_sync(kFull, send_x, 1, group);
      float in_y = __shfl_up_sync(kFull, send_y, 1, group);
      int h = __shfl_up_sync(kFull, send_h, 1, group);
      const int h0 = __shfl_sync(kFull, hcur, u, group);
      if (rank == 0) {
        in_m = 0.0f;
        in_x = 0.0f;
        in_y = y0;
        h = h0;
      }
      const int j = base + u - rank + 1;
      if (owns_rows && j >= 1 && j <= hl) {
        gx::phmm_lane_col<C, kBitmask>(L, h, in_m, in_x, in_y, send_m, send_x,
                                       send_y);
      }
      send_h = h;
    }
  }
  float acc = L.acc;
  for (int off = group / 2; off > 0; off /= 2) {
    acc += __shfl_xor_sync(kFull, acc, off, group);
  }
  if (rank == 0) out[pair] = gx::phmm_result(acc);
}

ffi::Error check_tiles(const ffi::AnyBuffer::Dimensions& d, const char* what) {
  if (d.size() != 3 || d[2] != gx::kLanes) {
    return ffi::Error::InvalidArgument(std::string(what) +
                                       ": expected (NT, rows, 128) tiles");
  }
  return ffi::Error::Success();
}

ffi::Error launch_status() {
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(e));
  return ffi::Error::Success();
}

bool valid_group(int g) { return g == 4 || g == 8 || g == 16 || g == 32; }

ffi::Error SwScoresImpl(cudaStream_t stream, ffi::Buffer<ffi::S8> sx,
                        ffi::Buffer<ffi::S8> sy, ffi::Buffer<ffi::S32> nx,
                        ffi::Buffer<ffi::S32> ny,
                        ffi::ResultBuffer<ffi::S32> out, int32_t group,
                        int32_t cols, int32_t match, int32_t mismatch,
                        int32_t gap_open, int32_t gap_extend) {
  if (auto e = check_tiles(sx.dimensions(), "sx"); e.failure()) return e;
  if (auto e = check_tiles(sy.dimensions(), "sy"); e.failure()) return e;
  if (!valid_group(group)) return ffi::Error::InvalidArgument("group");
  const int64_t nt = sx.dimensions()[0];
  const int nxs = static_cast<int>(sx.dimensions()[1]);
  const int nds = static_cast<int>(sy.dimensions()[1]);
  if (sy.dimensions()[0] != nt || nds <= nxs ||
      static_cast<int64_t>(nx.element_count()) != nt * gx::kLanes ||
      static_cast<int64_t>(ny.element_count()) != nt * gx::kLanes) {
    return ffi::Error::InvalidArgument("sw: inconsistent bucket shapes");
  }
  if (nt == 0) return ffi::Error::Success();
  const gx::SWParams prm{match, mismatch, gap_open + gap_extend, gap_extend};
  const dim3 grid(static_cast<unsigned>(nt * gx::kLanes * group / kBlock));
  const int8_t* a = sx.typed_data();
  const int8_t* b = sy.typed_data();
  const int32_t* n0 = nx.typed_data();
  const int32_t* n1 = ny.typed_data();
  int32_t* o = out->typed_data();
#define GX_SW_CASE(C)                                                   \
  case C:                                                               \
    sw_kernel<C><<<grid, kBlock, 0, stream>>>(a, b, n0, n1, o, nxs, nds, \
                                             group, prm);              \
    break;
  switch (cols) {
    GX_SW_COLS(GX_SW_CASE)
    default:
      return ffi::Error::InvalidArgument("sw: unsupported cols");
  }
#undef GX_SW_CASE
  return launch_status();
}

ffi::Error PhmmImpl(cudaStream_t stream, ffi::Buffer<ffi::S8> rchar,
                    ffi::Buffer<ffi::F32> qr, ffi::Buffer<ffi::F32> mmv,
                    ffi::Buffer<ffi::F32> gapm, ffi::Buffer<ffi::F32> qi,
                    ffi::Buffer<ffi::F32> qd, ffi::Buffer<ffi::F32> qg,
                    ffi::Buffer<ffi::S8> hap, ffi::Buffer<ffi::S32> rl,
                    ffi::Buffer<ffi::S32> hl, ffi::ResultBuffer<ffi::F32> out,
                    int32_t group, int32_t cols, int32_t bitmask,
                    float inv_mm_div) {
  if (auto e = check_tiles(rchar.dimensions(), "rchar"); e.failure()) return e;
  if (auto e = check_tiles(hap.dimensions(), "hap"); e.failure()) return e;
  if (!valid_group(group)) return ffi::Error::InvalidArgument("group");
  const int64_t nt = rchar.dimensions()[0];
  const int nxs = static_cast<int>(rchar.dimensions()[1]);
  const int nds = static_cast<int>(hap.dimensions()[1]);
  const size_t tiles = rchar.element_count();
  if (hap.dimensions()[0] != nt || nds <= nxs ||
      qr.element_count() != tiles || mmv.element_count() != tiles ||
      gapm.element_count() != tiles || qi.element_count() != tiles ||
      qd.element_count() != tiles || qg.element_count() != tiles ||
      static_cast<int64_t>(rl.element_count()) != nt * gx::kLanes ||
      static_cast<int64_t>(hl.element_count()) != nt * gx::kLanes) {
    return ffi::Error::InvalidArgument("pairhmm: inconsistent bucket shapes");
  }
  if (nt == 0) return ffi::Error::Success();
  const dim3 grid(static_cast<unsigned>(nt * gx::kLanes * group / kBlock));
#define GX_PHMM_ARGS                                                        \
  rchar.typed_data(), qr.typed_data(), mmv.typed_data(), gapm.typed_data(), \
      qi.typed_data(), qd.typed_data(), qg.typed_data(), hap.typed_data(),  \
      rl.typed_data(), hl.typed_data(), out->typed_data(), nxs, nds, group,  \
      inv_mm_div
#define GX_PHMM_CASE(C)                                           \
  case C:                                                         \
    if (bitmask) {                                                \
      phmm_kernel<C, true><<<grid, kBlock, 0, stream>>>(GX_PHMM_ARGS);  \
    } else {                                                      \
      phmm_kernel<C, false><<<grid, kBlock, 0, stream>>>(GX_PHMM_ARGS); \
    }                                                             \
    break;
  switch (cols) {
    GX_PHMM_COLS(GX_PHMM_CASE)
    default:
      return ffi::Error::InvalidArgument("pairhmm: unsupported cols");
  }
#undef GX_PHMM_CASE
#undef GX_PHMM_ARGS
  return launch_status();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(GxSwScores, SwScoresImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("group")
                                  .Attr<int32_t>("cols")
                                  .Attr<int32_t>("match")
                                  .Attr<int32_t>("mismatch")
                                  .Attr<int32_t>("gap_open")
                                  .Attr<int32_t>("gap_extend"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(GxPairhmm, PhmmImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Attr<int32_t>("group")
                                  .Attr<int32_t>("cols")
                                  .Attr<int32_t>("bitmask")
                                  .Attr<float>("inv_mm_div"));
