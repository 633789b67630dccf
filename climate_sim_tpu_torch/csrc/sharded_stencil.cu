// K2, K3, K4 and K5: the kernels of the sharded path, for one NVIDIA
// Hopper card (built for sm_90a).  Each advances one tile (or one region
// of a tile) of a mesh-decomposed field whose halos have already been
// exchanged; each writes a fresh output and never its input.
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
//   K4 sharded_tile_slab_multistep: k steps on one tile read straight
//      from three buffers, with no padded tile materialised: the tile
//      (ny, nx), the x-halo (ny, 2kh) [left kh columns | right kh columns]
//      and the y-halo (2kh, nx+2kh) [bottom kh rows ; top kh rows] at the
//      x-extended width, whose corners hold the diagonal neighbours.  The
//      TPU's 128-lane slab pads are a TPU layout answer and are not kept.
//   K5 carrier_tile_slab_multistep: K4 on one tile of a zero-padded
//      carrier (a grid the mesh does not divide, embedded in mesh-uniform
//      tiles).  The true right/top edge lies at a runtime tile column lx /
//      row ly of the tile that holds it; the edge rule below fires there
//      instead of at the tile's own edge, and the pad beyond evolves as
//      inert garbage that the fixup keeps out of the true extent.  The
//      whole (ny, nx) carrier tile, pad included, goes to a fresh output.
//
// What bounds them on the card: the same as K1 (device-memory bytes per
// pass at k = 1, the shared-memory sub-steps at k = 8), plus, for K4, the
// halo reads from two extra buffers, which touch 4kh/n of the tile.  The
// window load and the k sub-steps are K1's (stencil_core.cuh).
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

#include "stencil_core.cuh"

namespace {

using namespace climate;

struct TileParams {
  int ny, nx;         // output extent
  int ly, lx;         // true extent on a top/right-edge tile (K5), else ny, nx
  int kh;             // halo depth of the inputs (>= k)
  int flags[4];       // left, right, bottom, top: 1 on the physical edge
  long long ld_out;   // output row stride
  Stencil s;
};

// K2/K3 input: a padded region whose row 0, column 0 is region cell
// (-kh, -kh).
template <typename T>
struct RegionSource {
  const T* p;
  long long ld;
  __device__ T operator()(int r, int c, const TileParams& q) const {
    return p[(r + q.kh) * ld + (c + q.kh)];
  }
};

// K4 input: the tile and its two halo slabs.
template <typename T>
struct SlabSource {
  const T* tile;
  const T* xhalo;
  const T* yhalo;
  __device__ T operator()(int r, int c, const TileParams& q) const {
    if (r < 0 || r >= q.ny) {
      const int hr = r < 0 ? q.kh + r : q.kh + r - q.ny;
      return yhalo[static_cast<long long>(hr) * (q.nx + 2 * q.kh) + c + q.kh];
    }
    const long long row = static_cast<long long>(r);
    if (c < 0) return xhalo[row * 2 * q.kh + q.kh + c];
    if (c >= q.nx) return xhalo[row * 2 * q.kh + q.kh + c - q.nx];
    return tile[row * q.nx + c];
  }
};

// Edge byte of window line g (tile-local) along an axis whose true extent
// on a high-edge tile is l.
__device__ __forceinline__ unsigned char edge_byte(int g, int l, int fix_lo,
                                                   int fix_hi, int flag_lo,
                                                   int flag_hi) {
  const bool lo = fix_lo != FIX_NONE &&
                  ((flag_lo && g == 0) || (flag_hi && g == l));
  const bool hi = fix_hi != FIX_NONE &&
                  ((flag_hi && g == l - 1) || (flag_lo && g == -1));
  return (lo ? 1 : 0) | (hi ? 2 : 0);
}

template <typename T, typename C, typename Source>
__global__ void __launch_bounds__(BLOCK_X* BLOCK_Y)
    tile_stencil_kernel(Source in, T* __restrict__ out, TileParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = p.s.k;
  Window<C> w(smem, k);
  const int y0 = blockIdx.y * TILE_Y - k;  // tile row of window row 0
  const int x0 = blockIdx.x * TILE_X - k;  // tile column of window column 0
  const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
  const int* fix = p.s.fix;

  for (int i = tid; i < w.wy; i += BLOCK_X * BLOCK_Y) {
    w.rowf[i] = edge_byte(y0 + i, p.ly, fix[2], fix[3], p.flags[2], p.flags[3]);
  }
  for (int i = tid; i < w.wx; i += BLOCK_X * BLOCK_Y) {
    w.colf[i] = edge_byte(x0 + i, p.lx, fix[0], fix[1], p.flags[0], p.flags[1]);
  }
  // The window covers tile rows/columns [-k, n+k); the part of a ragged
  // last block beyond that feeds only masked outputs and is zero-filled.
  for (int r = threadIdx.y; r < w.wy; r += BLOCK_Y) {
    const int tr = y0 + r;
    const bool row_in = tr >= -k && tr < p.ny + k;
    for (int c = threadIdx.x; c < w.wx; c += BLOCK_X) {
      const int tc = x0 + c;
      w.src[r * w.wx + c] = (row_in && tc >= -k && tc < p.nx + k)
                                ? to_compute(in(tr, tc, p))
                                : static_cast<C>(0);
    }
  }
  __syncthreads();
  const C* res = run_substeps(w, p.s);

  for (int r = threadIdx.y; r < TILE_Y; r += BLOCK_Y) {
    const int gy = blockIdx.y * TILE_Y + r;
    if (gy >= p.ny) break;
    for (int c = threadIdx.x; c < TILE_X; c += BLOCK_X) {
      const int gx = blockIdx.x * TILE_X + c;
      if (gx >= p.nx) break;
      store(&out[gy * p.ld_out + gx], res[(r + k) * w.wx + (c + k)]);
    }
  }
}

template <typename T, typename C, typename Source>
cudaError_t launch(const Source& in, void* out, const TileParams& p,
                   cudaStream_t stream) {
  const size_t smem = window_smem_bytes(p.s.k, sizeof(C));
  const cudaError_t e = allow_smem(tile_stencil_kernel<T, C, Source>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.nx + TILE_X - 1) / TILE_X, (p.ny + TILE_Y - 1) / TILE_Y);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  tile_stencil_kernel<T, C, Source>
      <<<grid, dim3(BLOCK_X, BLOCK_Y), smem, stream>>>(in, static_cast<T*>(out), p);
  return cudaGetLastError();
}

template <typename T, typename C>
cudaError_t launch_region(const void* in, long long ld_in, void* out,
                          const TileParams& p, cudaStream_t stream) {
  const RegionSource<T> src{static_cast<const T*>(in), ld_in};
  return launch<T, C>(src, out, p, stream);
}

template <typename T, typename C>
cudaError_t launch_slab(const void* tile, const void* xhalo, const void* yhalo,
                        void* out, const TileParams& p, cudaStream_t stream) {
  const SlabSource<T> src{static_cast<const T*>(tile),
                          static_cast<const T*>(xhalo),
                          static_cast<const T*>(yhalo)};
  return launch<T, C>(src, out, p, stream);
}

// Checks shared by the entry points; false when an argument is out of range.
bool make_tile_params(TileParams* p, int ny, int nx, int kh, long long ld_out,
                      int k, double wc, double wxm, double wxp, double wym,
                      double wyp, int fix_left, int fix_right, int fix_bottom,
                      int fix_top, int flag_left, int flag_right,
                      int flag_bottom, int flag_top, double bc_value) {
  if (ny < 1 || nx < 1 || ld_out < nx || kh < k ||
      !make_stencil(&p->s, k, wc, wxm, wxp, wym, wyp, fix_left, fix_right,
                    fix_bottom, fix_top, bc_value)) {
    return false;
  }
  p->ny = ny;
  p->nx = nx;
  p->ly = ny;
  p->lx = nx;
  p->kh = kh;
  p->ld_out = ld_out;
  const int flags[4] = {flag_left, flag_right, flag_bottom, flag_top};
  for (int i = 0; i < 4; ++i) {
    if (flags[i] != 0 && flags[i] != 1) return false;
    p->flags[i] = flags[i];
  }
  return true;
}

int slab_dispatch(int dtype, const void* tile, const void* xhalo,
                  const void* yhalo, void* out, const TileParams& p,
                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(
          launch_slab<float, float>(tile, xhalo, yhalo, out, p, s));
    case 1:
      return static_cast<int>(
          launch_slab<double, double>(tile, xhalo, yhalo, out, p, s));
    case 2:
      return static_cast<int>(
          launch_slab<__nv_bfloat16, float>(tile, xhalo, yhalo, out, p, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int region_dispatch(int dtype, const void* in, long long ld_in, void* out,
                    const TileParams& p, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_region<float, float>(in, ld_in, out, p, s));
    case 1:
      return static_cast<int>(launch_region<double, double>(in, ld_in, out, p, s));
    case 2:
      return static_cast<int>(
          launch_region<__nv_bfloat16, float>(in, ld_in, out, p, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64, 2 = bfloat16 (storage; f32 arithmetic).
// fix_*: 0 live periodic, 1 Dirichlet, 2 Neumann, 3 compat zero.
// flag_*: 1 where the tile's side lies on the physical grid edge.
// Each returns the cudaError_t of the launch (0 on success).  Outputs must
// not alias inputs; the wrappers check that.

// K2: in (ny+2, nx+2) contiguous -> out (ny, nx) contiguous, one step.
int climate_prepadded_step(const void* in, void* out, int ny, int nx,
                           int dtype, double wc, double wxm, double wxp,
                           double wym, double wyp, void* stream) {
  TileParams p;
  if (in == out || !make_tile_params(&p, ny, nx, 1, nx, 1, wc, wxm, wxp, wym,
                                     wyp, FIX_NONE, FIX_NONE, FIX_NONE,
                                     FIX_NONE, 0, 0, 0, 0, 0.0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return region_dispatch(dtype, in, nx + 2, out, p, stream);
}

// K3: in = padded region, row 0 / column 0 at region cell (-kh, -kh), row
// stride ld_in >= nx + 2kh; out = (ny, nx) at row stride ld_out.
int climate_region_multistep(const void* in, long long ld_in, void* out,
                             long long ld_out, int ny, int nx, int k, int kh,
                             int dtype, double wc, double wxm, double wxp,
                             double wym, double wyp, int fix_left,
                             int fix_right, int fix_bottom, int fix_top,
                             int flag_left, int flag_right, int flag_bottom,
                             int flag_top, double bc_value, void* stream) {
  TileParams p;
  if (in == out || ld_in < nx + 2LL * kh ||
      !make_tile_params(&p, ny, nx, kh, ld_out, k, wc, wxm, wxp, wym, wyp,
                        fix_left, fix_right, fix_bottom, fix_top, flag_left,
                        flag_right, flag_bottom, flag_top, bc_value)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return region_dispatch(dtype, in, ld_in, out, p, stream);
}

// K4: tile (ny, nx), xhalo (ny, 2kh), yhalo (2kh, nx+2kh), all contiguous
// -> out (ny, nx) contiguous.
int climate_slab_multistep(const void* tile, const void* xhalo,
                           const void* yhalo, void* out, int ny, int nx,
                           int k, int kh, int dtype, double wc, double wxm,
                           double wxp, double wym, double wyp, int fix_left,
                           int fix_right, int fix_bottom, int fix_top,
                           int flag_left, int flag_right, int flag_bottom,
                           int flag_top, double bc_value, void* stream) {
  TileParams p;
  if (out == tile || out == xhalo || out == yhalo ||
      !make_tile_params(&p, ny, nx, kh, nx, k, wc, wxm, wxp, wym, wyp,
                        fix_left, fix_right, fix_bottom, fix_top, flag_left,
                        flag_right, flag_bottom, flag_top, bc_value)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return slab_dispatch(dtype, tile, xhalo, yhalo, out, p, stream);
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
                              double bc_value, void* stream) {
  TileParams p;
  if (out == tile || out == xhalo || out == yhalo || ly < 1 || ly > ny ||
      lx < 1 || lx > nx ||
      !make_tile_params(&p, ny, nx, kh, nx, k, wc, wxm, wxp, wym, wyp,
                        fix_left, fix_right, fix_bottom, fix_top, flag_left,
                        flag_right, flag_bottom, flag_top, bc_value)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.ly = ly;
  p.lx = lx;
  return slab_dispatch(dtype, tile, xhalo, yhalo, out, p, stream);
}

}  // extern "C"
