// Per-cell recurrences and per-lane sweep steps of the Hopper wavefront
// kernels (gx_kernels.cu), shared with a host build (gx_cells_host.cc)
// so that the CPU tests run the kernels' own arithmetic against
// kernels/oracle.py.
//
// Work mapping. A group of G threads scores one pair. Thread (lane) r of
// the group owns C consecutive cells of the pair's sublane-fixed
// sequence (SW: x columns r*C+1 .. r*C+C; PairHMM: read rows) and keeps
// their DP state in registers. The group sweeps the streamed sequence
// (SW: y; PairHMM: the haplotype) one element per step, skewed: at step
// s, lane r works on stream element s - r + 1, using the boundary cells
// that lane r-1 produced for the same element one step earlier (a warp
// shuffle on the card, an array read in the host emulation).
//
// Input layout is the packer's (genomax/pack/bucketing.py): tiles of
// kLanes pairs, (NT, rows, kLanes) int8 codes, sublane-fixed sequence at
// rows 1..len, and the streamed sequence reversed around the anchor
// A = NDs - NXs (element k at row A-1-k).

#pragma once

#include <math.h>
#include <stdint.h>

#if defined(__CUDACC__)
#define GX_HD __host__ __device__ __forceinline__
#define GX_UNROLL _Pragma("unroll")
#else
#define GX_HD inline
#define GX_UNROLL
#endif

// Cells a lane owns (C) for which the kernels are instantiated; keep
// kernels/cuda.py SW_COLS / PHMM_COLS equal (tests/test_cuda.py).
#define GX_SW_COLS(X) X(4) X(8) X(9) X(12) X(16) X(17) X(24) X(32) X(33)
#define GX_PHMM_COLS(X) X(4) X(6) X(8) X(10) X(12) X(16)

namespace gx {

constexpr int kLanes = 128;          // pairs per packed tile (layout.py LANES)
constexpr int kNegGap = -(1 << 30);  // gap-state boundary: below any score
constexpr int kNoCode = 1 << 12;     // x column past the pair: equals no code

GX_HD int imax(int a, int b) { return a > b ? a : b; }

// max(a + b, c)
GX_HD int addmax(int a, int b, int c) {
#if defined(__CUDA_ARCH__)
  return __viaddmax_s32(a, b, c);
#else
  const int s = a + b;
  return s > c ? s : c;
#endif
}

// max(a + b, c, 0)
GX_HD int addmax_relu(int a, int b, int c) {
#if defined(__CUDA_ARCH__)
  return __viaddmax_s32_relu(a, b, c);
#else
  const int s = imax(a + b, c);
  return s > 0 ? s : 0;
#endif
}

// Element k (0-based) of the reversed stream of pair lane l in tile t.
GX_HD int stream_code(const int8_t* buf, int t, int nds, int nxs, int l,
                      int k) {
  const int64_t row = static_cast<int64_t>(nds - nxs) - 1 - k;
  return buf[(static_cast<int64_t>(t) * nds + row) * kLanes + l];
}

// Row `row` of a sublane-fixed (NT, NXs, kLanes) tile array.
template <typename T>
GX_HD T tile_at(const T* buf, int t, int nxs, int l, int row) {
  return buf[(static_cast<int64_t>(t) * nxs + row) * kLanes + l];
}

// ---------------------------------------------------------------------------
// Smith-Waterman (Gotoh affine gap, score only)
// ---------------------------------------------------------------------------

struct SWParams {
  int match, mismatch, open_extend, extend;  // open_extend = open + extend
};

// One cell (antidiagonalSmithWaterman.c:309-335; oracle.sw_score), with
// up = (i-1, j), left = (i, j-1), diag = (i-1, j-1). P is the gap along
// y, Q the gap along x.
GX_HD void sw_cell(int up_d, int up_p, int left_d, int left_q, int diag_d,
                   bool eq, const SWParams& s, int& d, int& p, int& q) {
  p = addmax(up_p, s.extend, up_d + s.open_extend);
  q = addmax(left_q, s.extend, left_d + s.open_extend);
  d = addmax_relu(diag_d, eq ? s.match : s.mismatch, imax(p, q));
}

template <int C>
struct SWLane {
  int x[C];  // codes of the owned columns (kNoCode past the pair's x)
  int d[C];  // D of the previous row
  int p[C];  // P of the previous row
  int diag;  // D of the column left of the first owned one, previous row
  int best;
};

// Row 0 boundary: D = 0, P = -inf; columns past len(x) never match, so
// their cells stay below the pair's best (they only add penalties to
// real cells' values).
template <int C>
GX_HD void sw_lane_load(SWLane<C>& L, const int8_t* sx, int t, int nxs,
                        int l, int rank, int lenx) {
  GX_UNROLL
  for (int c = 0; c < C; ++c) {
    const int col = rank * C + c + 1;
    L.x[c] = col <= lenx ? static_cast<int>(tile_at(sx, t, nxs, l, col))
                         : kNoCode;
    L.d[c] = 0;
    L.p[c] = kNegGap;
  }
  L.diag = 0;
  L.best = 0;
}

// One row for the owned columns. (in_d, in_q): D and Q of the column left
// of the first owned one in this row (column 0: D = 0, Q = -inf).
// Returns D and Q of the last owned column through (out_d, out_q).
template <int C>
GX_HD void sw_lane_row(SWLane<C>& L, int y, int in_d, int in_q,
                       const SWParams& s, int& out_d, int& out_q) {
  int diag = L.diag;
  L.diag = in_d;
  int left = in_d;
  int q = in_q;
  GX_UNROLL
  for (int c = 0; c < C; ++c) {
    int d, p;
    sw_cell(L.d[c], L.p[c], left, q, diag, L.x[c] == y, s, d, p, q);
    diag = L.d[c];
    L.d[c] = d;
    L.p[c] = p;
    left = d;
    L.best = imax(L.best, d);
  }
  out_d = left;
  out_q = q;
}

// ---------------------------------------------------------------------------
// PairHMM forward
// ---------------------------------------------------------------------------

// fp32 start value of the row-0 Y boundary, 2**120 / hap_len, and its
// log10 (kernels/wavefront.py PHMM_INIT_LOG2 / PHMM_INIT_LOG10). The
// likelihood mass never grows along the matrix, so with this start every
// result at or above the engine's -45 log10 fallback threshold keeps its
// cells at least 29 orders above fp32's smallest normal; deeper results
// come out below the threshold (or -inf) and the engine recomputes them
// in fp64.
constexpr float kPhmmInit = 1.329227995784916e36f;  // 2**120
constexpr float kPhmmInitLog10 = 36.12359947967774f;  // 120 * log10(2)
constexpr int kCodeN = 'N';

// One cell (pairHMMmatrix.c:49-55; oracle.pairhmm_log10) of read row i
// and haplotype column j: diag = (i-1, j-1), up = (i-1, j),
// left = (i, j-1). The operand order follows kernels/wavefront.py.
GX_HD void phmm_cell(float p, float mmv, float gapm, float qi, float qd,
                     float qg, float dm, float dx, float dy, float um,
                     float ux, float lm, float ly, float& m, float& x,
                     float& y) {
  m = p * (mmv * dm + gapm * (dx + dy));
  x = um * qi + ux * qg;
  y = lm * qd + ly * qg;
}

template <int C>
struct PhmmLane {
  int code[C];  // read codes of the owned rows
  float pm[C];  // emission on a match: 1 - Qr
  float pq[C];  // emission on a mismatch: Qr / mm_div (1 - Qr at read 'N')
  float mmv[C], gapm[C], qi[C], qd[C], qg[C];
  float m[C], x[C], y[C];  // M, X, Y of the previous haplotype column
  float dm, dx, dy;  // M, X, Y above the first owned row, previous column
  float acc;         // sum of M + X over the read's last row, j ascending
  int acc_c;         // owned index of the read's last row, -1 if not owned
};

// Rows past the read's length keep all-zero coefficients, so their cells
// stay exactly zero. The row-0 Y boundary enters through the first lane's
// inputs (phmm_row0).
template <int C, bool kBitmask>
GX_HD void phmm_lane_load(PhmmLane<C>& L, const int8_t* rchar,
                          const float* qr, const float* mmv,
                          const float* gapm, const float* qi,
                          const float* qd, const float* qg, int t, int nxs,
                          int l, int rank, int rl, float inv_mm_div) {
  GX_UNROLL
  for (int c = 0; c < C; ++c) {
    const int row = rank * C + c + 1;
    const bool live = row <= rl;
    const int code = live ? tile_at(rchar, t, nxs, l, row) : 0;
    const float q = live ? tile_at(qr, t, nxs, l, row) : 0.0f;
    const bool read_n = code == (kBitmask ? 15 : kCodeN);
    L.code[c] = code;
    L.pm[c] = live ? 1.0f - q : 0.0f;
    L.pq[c] = live ? (read_n ? 1.0f - q : q * inv_mm_div) : 0.0f;
    L.mmv[c] = live ? tile_at(mmv, t, nxs, l, row) : 0.0f;
    L.gapm[c] = live ? tile_at(gapm, t, nxs, l, row) : 0.0f;
    L.qi[c] = live ? tile_at(qi, t, nxs, l, row) : 0.0f;
    L.qd[c] = live ? tile_at(qd, t, nxs, l, row) : 0.0f;
    L.qg[c] = live ? tile_at(qg, t, nxs, l, row) : 0.0f;
    L.m[c] = 0.0f;
    L.x[c] = 0.0f;
    L.y[c] = 0.0f;
  }
  L.acc = 0.0f;
  L.acc_c = rl - 1 - rank * C;
  if (L.acc_c >= C) L.acc_c = -1;
}

// Y of read row 0 at every column (the DBL_MAX/16 / hap_len analogue).
GX_HD float phmm_row0(int hl) {
  return kPhmmInit / static_cast<float>(hl > 1 ? hl : 1);
}

// Diagonal input of the first owned row at column 1: row 0 for lane 0,
// column 0 (all zero) for the others.
template <int C>
GX_HD void phmm_lane_start(PhmmLane<C>& L, int rank, int hl) {
  L.dm = 0.0f;
  L.dx = 0.0f;
  L.dy = rank == 0 ? phmm_row0(hl) : 0.0f;
}

template <bool kBitmask>
GX_HD bool phmm_match(int read_code, int hap_code) {
  return kBitmask ? (read_code & hap_code) != 0
                  : (read_code == hap_code) || (hap_code == kCodeN);
}

// One haplotype column for the owned rows. (in_m, in_x, in_y): M, X, Y of
// the row above the first owned one in this column. Returns M, X, Y of
// the last owned row through (out_m, out_x, out_y).
template <int C, bool kBitmask>
GX_HD void phmm_lane_col(PhmmLane<C>& L, int h, float in_m, float in_x,
                         float in_y, float& out_m, float& out_x,
                         float& out_y) {
  float dm = L.dm, dx = L.dx, dy = L.dy;
  L.dm = in_m;
  L.dx = in_x;
  L.dy = in_y;
  float um = in_m, ux = in_x;
  GX_UNROLL
  for (int c = 0; c < C; ++c) {
    const float p = phmm_match<kBitmask>(L.code[c], h) ? L.pm[c] : L.pq[c];
    float m, x, y;
    phmm_cell(p, L.mmv[c], L.gapm[c], L.qi[c], L.qd[c], L.qg[c], dm, dx, dy,
              um, ux, L.m[c], L.y[c], m, x, y);
    dm = L.m[c];
    dx = L.x[c];
    dy = L.y[c];
    L.m[c] = m;
    L.x[c] = x;
    L.y[c] = y;
    um = m;
    ux = x;
    if (c == L.acc_c) L.acc += m + x;
  }
  out_m = um;
  out_x = ux;
  out_y = L.y[C - 1];
}

// log10 likelihood relative to the reference's scaling constant.
GX_HD float phmm_result(float acc) { return log10f(acc) - kPhmmInitLog10; }

}  // namespace gx
