// K4 and K5: the sharded path's tile kernels, for one NVIDIA Hopper card
// (built for sm_90a).  Each advances one tile of a mesh-decomposed field
// whose halos have already been exchanged into two slabs, and writes a
// fresh output, never its input.
//
// Replaces the TPU kernels of climate_sim_tpu/ops/pallas_stencil.py:
//   K4 sharded_tile_slab_multistep: k steps on one tile read straight
//      from three buffers, with no padded tile materialised: the tile
//      (ny, nx), the x-halo (ny, 2kh) [left kh columns | right kh columns]
//      and the y-halo (2kh, nx+2kh) [bottom kh rows ; top kh rows] at the
//      x-extended width, whose corners hold the diagonal neighbours.  The
//      TPU's 128-lane slab pads are a TPU layout answer and are not kept.
//   K5 carrier_tile_slab_multistep: K4 on one tile of a zero-padded
//      carrier (a grid the mesh does not divide, embedded in mesh-uniform
//      tiles).  The true right/top edge lies at a runtime tile column lx /
//      row ly of the tile that holds it; the edge rule (tile_stencil.cuh)
//      fires there instead of at the tile's own edge, and the pad beyond
//      evolves as inert garbage that the fixup keeps out of the true
//      extent.  The whole (ny, nx) carrier tile, pad included, goes to a
//      fresh output.
//
// What bounds them on the card: the same as K1 (the sub-steps on chip at
// k = 8), plus the halo reads from two extra buffers, which touch 4kh/n
// of the tile.  Both run K1's streaming core (stencil_core.cuh): the
// source gives each thread's column part of the address once (tile, left
// or right x-halo) and the row part once per row (bottom y-halo, tile, top
// y-halo), so the three buffers cost no per-element choice.

#include "tile_stencil.cuh"

namespace {

using namespace climate;

// K4/K5 input: the tile (ny, nx), the x-halo (ny, 2kh) [left kh columns |
// right kh columns] and the y-halo (2kh, nx + 2kh) [bottom kh rows; top kh
// rows] at the x-extended width.
template <typename T>
struct SlabSource : TileRows {
  const T* tile;
  const T* xhalo;
  const T* yhalo;
  struct Col {
    const T* mid;  // this column in the tile or the x-halo, row 0
    int mid_ld;
    const T* y;    // this column in the y-halo, row 0
  };
  __device__ Col column(int c) const {
    const int cc = clamp_col(c);
    Col out;
    if (cc < 0) {
      out.mid = xhalo + e.kh + cc;
      out.mid_ld = 2 * e.kh;
    } else if (cc >= e.nx) {
      out.mid = xhalo + e.kh + cc - e.nx;
      out.mid_ld = 2 * e.kh;
    } else {
      out.mid = tile + cc;
      out.mid_ld = e.nx;
    }
    out.y = yhalo + cc + e.kh;
    return out;
  }
  __device__ const T* at(int r, const Col& col) const {
    const long long yld = e.nx + 2 * e.kh;
    if (r < 0) return col.y + (e.kh + r) * yld;
    if (r >= e.ny) return col.y + (e.kh + r - e.ny) * yld;
    return col.mid + static_cast<long long>(r) * col.mid_ld;
  }
};

int slab_dispatch(int dtype, const TileEdges& e, const Pass& p, const void* tile,
                  const void* xhalo, const void* yhalo, void* out, void* stream) {
  return dispatch(dtype, p, out, stream, [&](auto tag) {
    using T = typename decltype(tag)::type;
    return SlabSource<T>{{e}, static_cast<const T*>(tile),
                         static_cast<const T*>(xhalo), static_cast<const T*>(yhalo)};
  });
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64, 2 = bfloat16 (storage; f32 arithmetic).
// fix_*: 0 live periodic, 1 Dirichlet, 2 Neumann, 3 compat zero.
// flag_*: 1 where the tile's side lies on the physical grid edge.
// band_w, seg_rows: the band geometry from
// ops/cuda_stencil.py::band_geometry for the output extent and k.
// Each returns the cudaError_t of the launch (0 on success).  Outputs must
// not alias inputs; the wrappers check that.

// K4: tile (ny, nx), xhalo (ny, 2kh), yhalo (2kh, nx+2kh), all contiguous
// -> out (ny, nx) contiguous.
int climate_slab_multistep(const void* tile, const void* xhalo,
                           const void* yhalo, void* out, int ny, int nx,
                           int k, int kh, int dtype, double wc, double wxm,
                           double wxp, double wym, double wyp, int fix_left,
                           int fix_right, int fix_bottom, int fix_top,
                           int flag_left, int flag_right, int flag_bottom,
                           int flag_top, double bc_value, int band_w,
                           int seg_rows, void* stream) {
  Pass p;
  TileEdges e;
  if (out == tile || out == xhalo || out == yhalo ||
      !make_tile(&p, &e, ny, nx, kh, nx, k, wc, wxm, wxp, wym, wyp, fix_left,
                 fix_right, fix_bottom, fix_top, flag_left, flag_right,
                 flag_bottom, flag_top, bc_value, band_w, seg_rows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return slab_dispatch(dtype, e, p, tile, xhalo, yhalo, out, stream);
}

// K5: K4's buffers on a carrier tile (ny, nx) whose true extent on a
// top/right-edge tile is (ly, lx), 1 <= ly <= ny, 1 <= lx <= nx.  The
// flags' top/right mark the tile holding the true edge.
int climate_carrier_multistep(const void* tile, const void* xhalo,
                              const void* yhalo, void* out, int ny, int nx,
                              int ly, int lx, int k, int kh, int dtype,
                              double wc, double wxm, double wxp, double wym,
                              double wyp, int fix_left, int fix_right,
                              int fix_bottom, int fix_top, int flag_left,
                              int flag_right, int flag_bottom, int flag_top,
                              double bc_value, int band_w, int seg_rows,
                              void* stream) {
  Pass p;
  TileEdges e;
  if (out == tile || out == xhalo || out == yhalo || ly < 1 || ly > ny ||
      lx < 1 || lx > nx ||
      !make_tile(&p, &e, ny, nx, kh, nx, k, wc, wxm, wxp, wym, wyp, fix_left,
                 fix_right, fix_bottom, fix_top, flag_left, flag_right,
                 flag_bottom, flag_top, bc_value, band_w, seg_rows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  e.ly = ly;
  e.lx = lx;
  return slab_dispatch(dtype, e, p, tile, xhalo, yhalo, out, stream);
}

}  // extern "C"
