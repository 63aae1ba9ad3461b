// Host emulation of the wavefront kernels in gx_kernels.cu, for the CPU
// tests: the same lane functions from gx_cells.h, the same skewed group
// schedule over the same packed tiles, with each warp shuffle replaced by
// a read of the previous lane's outputs from the step before.
//
// Exposed through a C ABI for ctypes.

#include <stdint.h>

#include <vector>

#include "gx_cells.h"

namespace {

template <int C>
void sw_tiles(const int8_t* sx, const int8_t* sy, const int32_t* nx,
              const int32_t* ny, int32_t* out, int64_t nt, int nxs, int nds,
              int group, const gx::SWParams& prm) {
  std::vector<gx::SWLane<C>> lanes(group);
  std::vector<int> send_d(group), send_q(group), send_y(group);
  for (int64_t pair = 0; pair < nt * gx::kLanes; ++pair) {
    const int t = static_cast<int>(pair / gx::kLanes);
    const int l = static_cast<int>(pair % gx::kLanes);
    const int lenx = nx[pair] - 1, leny = ny[pair] - 1;
    for (int r = 0; r < group; ++r) {
      gx::sw_lane_load(lanes[r], sx, t, nxs, l, r, lenx);
      send_d[r] = 0;
      send_q[r] = gx::kNegGap;
      send_y[r] = 0;
    }
    for (int s = 0; s < leny + group - 1; ++s) {
      // Descending ranks: lane r reads lane r-1's outputs of step s-1.
      for (int r = group - 1; r >= 0; --r) {
        int in_d = 0, in_q = gx::kNegGap, y;
        if (r == 0) {
          y = s < leny ? gx::stream_code(sy, t, nds, nxs, l, s) : 0;
        } else {
          in_d = send_d[r - 1];
          in_q = send_q[r - 1];
          y = send_y[r - 1];
        }
        const int i = s - r + 1;
        if (i >= 1 && i <= leny) {
          gx::sw_lane_row(lanes[r], y, in_d, in_q, prm, send_d[r],
                          send_q[r]);
        }
        send_y[r] = y;
      }
    }
    int best = 0;
    for (int r = 0; r < group; ++r) best = gx::imax(best, lanes[r].best);
    out[pair] = best;
  }
}

template <int C, bool kBitmask>
void phmm_tiles(const int8_t* rchar, const float* qr, const float* mmv,
                const float* gapm, const float* qi, const float* qd,
                const float* qg, const int8_t* hap, const int32_t* rl_arr,
                const int32_t* hl_arr, float* out, int64_t nt, int nxs,
                int nds, int group, float inv_mm_div) {
  std::vector<gx::PhmmLane<C>> lanes(group);
  std::vector<float> send_m(group), send_x(group), send_y(group);
  std::vector<int> send_h(group);
  for (int64_t pair = 0; pair < nt * gx::kLanes; ++pair) {
    const int t = static_cast<int>(pair / gx::kLanes);
    const int l = static_cast<int>(pair % gx::kLanes);
    const int rl = rl_arr[pair], hl = hl_arr[pair];
    const float y0 = gx::phmm_row0(hl);
    for (int r = 0; r < group; ++r) {
      gx::phmm_lane_load<C, kBitmask>(lanes[r], rchar, qr, mmv, gapm, qi, qd,
                                      qg, t, nxs, l, r, rl, inv_mm_div);
      gx::phmm_lane_start(lanes[r], r, hl);
      send_m[r] = send_x[r] = send_y[r] = 0.0f;
      send_h[r] = 0;
    }
    for (int s = 0; s < hl + group - 1; ++s) {
      for (int r = group - 1; r >= 0; --r) {
        float in_m = 0.0f, in_x = 0.0f, in_y = y0;
        int h;
        if (r == 0) {
          h = s < hl ? gx::stream_code(hap, t, nds, nxs, l, s) : 0;
        } else {
          in_m = send_m[r - 1];
          in_x = send_x[r - 1];
          in_y = send_y[r - 1];
          h = send_h[r - 1];
        }
        const int j = s - r + 1;
        if (r * C < rl && j >= 1 && j <= hl) {
          gx::phmm_lane_col<C, kBitmask>(lanes[r], h, in_m, in_x, in_y,
                                         send_m[r], send_x[r], send_y[r]);
        }
        send_h[r] = h;
      }
    }
    float acc = 0.0f;
    for (int r = 0; r < group; ++r) acc += lanes[r].acc;
    out[pair] = gx::phmm_result(acc);
  }
}

}  // namespace

extern "C" {

// Returns 0, or -1 for a column count the kernels do not instantiate.
int gx_host_sw_tiles(const int8_t* sx, const int8_t* sy, const int32_t* nx,
                     const int32_t* ny, int32_t* out, int64_t nt, int32_t nxs,
                     int32_t nds, int32_t group, int32_t cols, int32_t match,
                     int32_t mismatch, int32_t gap_open, int32_t gap_extend) {
  const gx::SWParams prm{match, mismatch, gap_open + gap_extend, gap_extend};
#define GX_SW_CASE(C)                                                       \
  case C:                                                                   \
    sw_tiles<C>(sx, sy, nx, ny, out, nt, nxs, nds, group, prm);             \
    return 0;
  switch (cols) {
    GX_SW_COLS(GX_SW_CASE)
    default:
      return -1;
  }
#undef GX_SW_CASE
}

int gx_host_phmm_tiles(const int8_t* rchar, const float* qr, const float* mmv,
                       const float* gapm, const float* qi, const float* qd,
                       const float* qg, const int8_t* hap,
                       const int32_t* rl, const int32_t* hl, float* out,
                       int64_t nt, int32_t nxs, int32_t nds, int32_t group,
                       int32_t cols, int32_t bitmask, float inv_mm_div) {
#define GX_PHMM_CASE(C)                                                     \
  case C:                                                                   \
    if (bitmask) {                                                          \
      phmm_tiles<C, true>(rchar, qr, mmv, gapm, qi, qd, qg, hap, rl, hl,    \
                          out, nt, nxs, nds, group, inv_mm_div);            \
    } else {                                                                \
      phmm_tiles<C, false>(rchar, qr, mmv, gapm, qi, qd, qg, hap, rl, hl,   \
                           out, nt, nxs, nds, group, inv_mm_div);           \
    }                                                                       \
    return 0;
  switch (cols) {
    GX_PHMM_COLS(GX_PHMM_CASE)
    default:
      return -1;
  }
#undef GX_PHMM_CASE
}

}  // extern "C"
