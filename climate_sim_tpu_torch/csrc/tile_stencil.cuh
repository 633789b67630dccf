// What the kernels of the sharded path share (K2-K5, region_stencil.cu
// and slab_stencil.cu): the edge rule on a tile, the row and column state
// their sources give the streaming core (stencil_core.cuh), the argument
// checks.
//
// The edge rule on a tile.  In one process every tile's edge flags
// [left, right, bottom, top] (does the tile's side lie on the physical
// grid edge?) are known on the host, so they come in as scalars.  A window
// row r (tile-local, r in [-k, ny+k)) reads the bottom BC ghost for ym
// when the bottom side is fixed and the row is global row 0: r == 0 on a
// bottom-edge tile, or r == ny on a top-edge tile whose top halo holds the
// wrap block of a one-sided periodic axis.  It reads the top ghost for yp
// when the top side is fixed and the row is global row ny-1: r == ny-1 on
// a top-edge tile, r == -1 on a bottom-edge tile.  Columns likewise.  On a
// carrier tile (K5) the true extent l replaces the tile extent n on the
// high side: the top fixup sits at r == ly-1 and the one-sided wrap block
// staged above the true edge starts at r == ly; K2-K4 pass l == n.  These
// are the TPU kernel's flag-gated fixups and its wrap_*_mask patches as
// one rule; the extra cases the rule also sets (a wrap row beyond a fixed
// side) sit behind that side's own fixup and change no output.  All flags
// 0 means no fixups and no patches: K3's flagged=False.

#pragma once

#include "stencil_core.cuh"

namespace climate {

// The edge rule's data on a tile: extents, true extents on a high-edge
// tile (K5; else ly == ny, lx == nx), halo depth, flags and side codes.
struct TileEdges {
  int ny, nx;
  int ly, lx;
  int kh;
  int flags[4];  // left, right, bottom, top: 1 on the physical edge
  int fix[4];
};

// Edge bits of window line g (tile-local) along an axis whose true extent
// on a high-edge tile is l.
__device__ __forceinline__ unsigned edge_bits(int g, int l, int fix_lo, int fix_hi,
                                              int flag_lo, int flag_hi) {
  const bool lo = fix_lo != FIX_NONE && ((flag_lo && g == 0) || (flag_hi && g == l));
  const bool hi = fix_hi != FIX_NONE && ((flag_hi && g == l - 1) || (flag_lo && g == -1));
  return (lo ? 1u : 0u) | (hi ? 2u : 0u);
}

// What K2-K5's sources share: tile-local rows as the row state, and the
// edge bits.  A column outside [-kh, nx + kh) (the ragged part of a last
// band) reads a clamped column: it feeds only columns that are not output.
struct TileRows {
  TileEdges e;
  __device__ int row_start(int r) const { return r; }
  __device__ int row_next(int r) const { return r + 1; }
  __device__ unsigned row_bits(int r) const {
    return edge_bits(r, e.ly, e.fix[2], e.fix[3], e.flags[2], e.flags[3]);
  }
  __device__ unsigned col_bits(int c) const {
    return edge_bits(c, e.lx, e.fix[0], e.fix[1], e.flags[0], e.flags[1]);
  }
  __device__ int clamp_col(int c) const {
    return min(max(c, -e.kh), e.nx + e.kh - 1);
  }
};

// Checks shared by the entry points; false when an argument is out of range.
inline bool make_tile(Pass* p, TileEdges* e, int ny, int nx, int kh,
                      long long ld_out, int k, double wc, double wxm, double wxp,
                      double wym, double wyp, int fix_left, int fix_right,
                      int fix_bottom, int fix_top, int flag_left, int flag_right,
                      int flag_bottom, int flag_top, double bc_value, int band_w,
                      int seg_rows) {
  if (ny < 1 || nx < 1 || ld_out < nx || kh < k ||
      !make_stencil(&p->s, k, wc, wxm, wxp, wym, wyp, fix_left, fix_right,
                    fix_bottom, fix_top, bc_value) ||
      !band_ok(band_w, seg_rows, k)) {
    return false;
  }
  p->ny = e->ny = e->ly = ny;
  p->nx = e->nx = e->lx = nx;
  p->ld_out = ld_out;
  p->band_w = band_w;
  p->seg_rows = seg_rows;
  e->kh = kh;
  const int flags[4] = {flag_left, flag_right, flag_bottom, flag_top};
  for (int i = 0; i < 4; ++i) {
    if (flags[i] != 0 && flags[i] != 1) return false;
    e->flags[i] = flags[i];
    e->fix[i] = p->s.fix[i];
  }
  return true;
}

}  // namespace climate
