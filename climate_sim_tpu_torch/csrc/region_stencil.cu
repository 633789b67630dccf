// K2 and K3: the sharded path's region kernels, for one NVIDIA Hopper card
// (built for sm_90a).  Each advances one padded region of a tile whose
// halos have already been exchanged, and writes a fresh output, never its
// input.
//
// Replaces the TPU kernels of climate_sim_tpu/ops/pallas_stencil.py:
//   K2 prepadded_kernel_step: one step on a (ny+2, nx+2) tile whose ghost
//      ring is valid; no fixups.  Here: a region pass with k = 1, halo 1
//      and every flag 0.
//   K3 tile_region_multistep / sharded_tile_multistep: k steps on an
//      already-assembled padded region (ny+2kh, >= nx+2kh) read by pointer
//      and row stride, so a region of a larger tensor needs no copy; the
//      output goes to a pointer and row stride too, so the overlap path's
//      five regions write one tile in place of a stitch.
//
// What bounds them on the card: the same as K1 (device-memory bytes per
// pass at k = 1, the sub-steps on chip at k = 8).  Both run K1's streaming
// core (stencil_core.cuh): each thread's column address is computed once,
// each row's once per row, and the wrapper sizes the band to the region,
// so K3's k-column bands run 32-wide blocks instead of idle lanes, and
// K2's one step streams with one barrier per row.  The edge rule on a
// tile is in tile_stencil.cuh.

#include "tile_stencil.cuh"

namespace {

using namespace climate;

// K2/K3 input: a padded region whose row 0, column 0 is region cell
// (-kh, -kh), rows ld apart.
template <typename T>
struct RegionSource : TileRows {
  const T* p;
  long long ld;
  __device__ const T* column(int c) const { return p + clamp_col(c) + e.kh; }
  __device__ const T* at(int r, const T* col) const {
    return col + static_cast<long long>(r + e.kh) * ld;
  }
};

int region_dispatch(int dtype, const TileEdges& e, const Pass& p, const void* in,
                    long long ld_in, void* out, void* stream) {
  return dispatch(dtype, p, out, stream, [&](auto tag) {
    using T = typename decltype(tag)::type;
    return RegionSource<T>{{e}, static_cast<const T*>(in), ld_in};
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

// K2: in (ny+2, nx+2) contiguous -> out (ny, nx) contiguous, one step.
int climate_prepadded_step(const void* in, void* out, int ny, int nx,
                           int dtype, double wc, double wxm, double wxp,
                           double wym, double wyp, int band_w, int seg_rows,
                           void* stream) {
  Pass p;
  TileEdges e;
  if (in == out || !make_tile(&p, &e, ny, nx, 1, nx, 1, wc, wxm, wxp, wym, wyp,
                              FIX_NONE, FIX_NONE, FIX_NONE, FIX_NONE, 0, 0, 0,
                              0, 0.0, band_w, seg_rows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return region_dispatch(dtype, e, p, in, nx + 2, out, stream);
}

// K3: in = padded region, row 0 / column 0 at region cell (-kh, -kh), row
// stride ld_in >= nx + 2kh; out = (ny, nx) at row stride ld_out.
int climate_region_multistep(const void* in, long long ld_in, void* out,
                             long long ld_out, int ny, int nx, int k, int kh,
                             int dtype, double wc, double wxm, double wxp,
                             double wym, double wyp, int fix_left,
                             int fix_right, int fix_bottom, int fix_top,
                             int flag_left, int flag_right, int flag_bottom,
                             int flag_top, double bc_value, int band_w,
                             int seg_rows, void* stream) {
  Pass p;
  TileEdges e;
  if (in == out || ld_in < nx + 2LL * kh ||
      !make_tile(&p, &e, ny, nx, kh, ld_out, k, wc, wxm, wxp, wym, wyp,
                 fix_left, fix_right, fix_bottom, fix_top, flag_left,
                 flag_right, flag_bottom, flag_top, bc_value, band_w, seg_rows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return region_dispatch(dtype, e, p, in, ld_in, out, stream);
}

}  // extern "C"
