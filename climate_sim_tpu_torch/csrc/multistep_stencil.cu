// K1: k forward-Euler steps of the global (ny, nx) field in one pass over
// device memory, for one NVIDIA Hopper card (built for sm_90a).
//
// Replaces the TPU kernel climate_sim_tpu/ops/pallas_stencil.py::
// multistep_kernel_step, i.e. the value-chained form of _build_kernel_body.
// It computes the same function: k iterations of pad_with_ghosts + the
// 5-point weighted stencil of _stencil_weights, every physical-edge ghost
// re-pinned at every sub-step, one-sided periodic axes included.
//
// What bounds it on the card.  One step of the update reads and writes
// every point once (8 bytes a point in f32) and does 9 flops a point, far
// below the card's flop-to-byte ratio, so a one-step pass would run at the
// memory roofline.  Temporal blocking does k steps per pass, so device
// memory sees one read and one write every k steps, and the sub-steps on
// chip become the bound: their shared-memory accesses, their issue slots
// and the barriers between rows.  The core (stencil_core.cuh) streams each
// column band down its rows with the k levels pipelined one row apart:
// the vertical operands stay in registers, one barrier per row for all k
// levels, rows loaded AHEAD rows early with cp.async, and the redundant
// halo work is about band_w/(band_w-2k) x (seg+2k)/seg instead of a
// window's shrinking rim.  Up to 8 steps a pass K1 runs the core's wide
// body: each thread holds 4 adjacent columns (2 in f64), their x
// neighbours come from its own registers, the lanes beside it (shuffles)
// and, at a warp's ends, a small exchange row, so the shared-memory pipe
// that bound the one-column body (one store and two loads an update)
// carries a few accesses per 4 x k updates, and each level has 4
// independent FMA chains.  What bounds the wide body is its issue, how
// many warps an SM holds (its registers allow 12) and the latency of each
// row's chain through the k levels; the wrapper cuts the field into one
// wave of such blocks, with short segments where the field is too small to
// fill the SMs (ops/cuda_stencil.py::k1_geometry), and where its cut is
// one warp wide the band needs no exchange row and no barrier, which
// takes about a sixth of a row's instructions.  Deeper passes run the
// one-column body (band_w threads of one column each).  wgmma and TMA are
// not used: the update is 9 flops a cell, and TMA fills out-of-bounds
// with zeros, not wrapped rows.
//
// The edge rule.  Each window cell knows its wrapped global coordinate.
// Its neighbour in one direction is the window neighbour, except when the
// cell lies on the physical edge of that side and the side is not
// live-periodic: then the operand is the BC ghost (Dirichlet: bc_value;
// Neumann: the cell's own value; periodic under strict_reference_compat:
// 0).  This one rule gives the per-sub-step fixups, the one-sided-periodic
// wrap patches (the wrapped copy of row ny-1 below row 0 reads bc(top),
// not row 0) and the true torus, for every grid shape, including bands
// wider than the grid.  A thread wraps its column once (one `%`), a block
// its first row once; later rows wrap by a compare.

#include "stencil_core.cuh"

namespace {

using namespace climate;

// The wrapped global field.  Row state: the wrapped global row.
template <typename T>
struct WrapSource {
  const T* p;
  int ny, nx;
  int fix[4];

  __device__ int row_start(int g) const {
    const int m = g % ny;
    return m < 0 ? m + ny : m;
  }
  __device__ int row_next(int r) const { return r + 1 == ny ? 0 : r + 1; }
  __device__ unsigned row_bits(int r) const {
    return ((r == 0 && fix[2] != FIX_NONE) ? 1u : 0u) |
           ((r == ny - 1 && fix[3] != FIX_NONE) ? 2u : 0u);
  }
  __device__ int column(int g) const {
    const int m = g % nx;
    return m < 0 ? m + nx : m;
  }
  __device__ unsigned col_bits(int g) const {
    const int x = column(g);
    return ((x == 0 && fix[0] != FIX_NONE) ? 1u : 0u) |
           ((x == nx - 1 && fix[1] != FIX_NONE) ? 2u : 0u);
  }
  __device__ const T* at(int r, int x) const {
    return p + static_cast<long long>(r) * nx + x;
  }
  // Columns g .. g + n - 1 lie side by side, the first aligned to n
  // elements in every row: one copy of n elements brings them.
  __device__ bool contiguous(int g, int n) const {
    const int x = column(g);
    return x + n <= nx && nx % n == 0 &&
           reinterpret_cast<uintptr_t>(p + x) % (n * sizeof(T)) == 0;
  }
};

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64, 2 = bfloat16 (storage; f32 arithmetic).
// fix_*: 0 live periodic, 1 Dirichlet, 2 Neumann, 3 compat zero.
// band_w, seg_rows: the band geometry (window columns a block, output rows
// a segment) from ops/cuda_stencil.py::k1_geometry, which also knows the
// columns a thread that k and dtype give (stencil_core.cuh::launch_band).
// Returns the cudaError_t of the launch (0 on success).  ``out`` must not
// alias ``in``.
int climate_multistep_stencil(const void* in, void* out, int ny, int nx,
                              int k, int dtype, double wc, double wxm,
                              double wxp, double wym, double wyp, int fix_left,
                              int fix_right, int fix_bottom, int fix_top,
                              double bc_value, int band_w, int seg_rows,
                              void* stream) {
  Pass p;
  p.ny = ny;
  p.nx = nx;
  p.ld_out = nx;
  p.band_w = band_w;
  p.seg_rows = seg_rows;
  if (ny < 1 || nx < 1 || in == out ||
      !make_stencil(&p.s, k, wc, wxm, wxp, wym, wyp, fix_left, fix_right,
                    fix_bottom, fix_top, bc_value)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch<true>(dtype, p, out, stream, [&](auto tag) {
    using T = typename decltype(tag)::type;
    return WrapSource<T>{static_cast<const T*>(in), ny, nx,
                         {fix_left, fix_right, fix_bottom, fix_top}};
  });
}

const char* climate_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
