// K1: k forward-Euler steps of the global (ny, nx) field in one pass over
// device memory, for one NVIDIA Hopper card (built for sm_90a).
//
// Replaces the TPU kernel climate_sim_tpu/ops/pallas_stencil.py::
// multistep_kernel_step, i.e. the value-chained form of _build_kernel_body.
// It computes the same function: k iterations of pad_with_ghosts + the
// 5-point weighted stencil of _stencil_weights, every physical-edge ghost
// re-pinned at every sub-step, one-sided periodic axes included.
//
// What bounds it on the card: device-memory bytes per pass.  One step of
// the update reads and writes every point once (8 bytes a point in f32) and
// does 9 flops a point, far below the card's flop-to-byte ratio, so a
// one-step-per-pass kernel runs at the memory roofline.  This kernel keeps
// a (TILE_Y+2k) x (TILE_X+2k) window in shared memory across k sub-steps,
// so device memory sees one read (plus halo reads, mostly served by L2)
// and one write every k steps.  The sub-steps then run out of shared
// memory, whose traffic (5 reads and 1 write per point per sub-step over a
// region that shrinks by one cell a side per sub-step) becomes the next
// bound.  wgmma, TMA and register blocking are not used yet.
//
// The edge rule.  Each window cell knows its wrapped global coordinate
// ((g % n) + n) % n.  Its neighbour in one direction is the window
// neighbour, except when the cell lies on the physical edge of that side
// and the side is not live-periodic: then the operand is the BC ghost
// (Dirichlet: bc_value; Neumann: the cell's own value; periodic under
// strict_reference_compat: 0).  This one rule gives the per-sub-step
// fixups, the one-sided-periodic wrap patches (the wrapped copy of row
// ny-1 below row 0 reads bc(top), not row 0) and the true torus, for every
// grid shape, including windows wider than the grid.
//
// The sub-step core, the edge bytes and the dtype rules are shared with
// K2-K4 (stencil_core.cuh).

#include "stencil_core.cuh"

namespace {

using namespace climate;

struct Params {
  int ny, nx;
  Stencil s;
};

__device__ __forceinline__ int wrap(int g, int n) {
  const int m = g % n;
  return m < 0 ? m + n : m;
}

template <typename T, typename C>
__global__ void __launch_bounds__(BLOCK_X* BLOCK_Y)
    multistep_stencil_kernel(const T* __restrict__ in, T* __restrict__ out,
                             Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = p.s.k;
  Window<C> w(smem, k);
  const int y0 = blockIdx.y * TILE_Y - k;  // global row of window row 0
  const int x0 = blockIdx.x * TILE_X - k;  // global column of window column 0
  const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
  const int* fix = p.s.fix;

  // Edge bytes from the wrapped global coordinate: bit 0 on the low
  // physical edge of a fixed side, bit 1 on the high one.
  for (int i = tid; i < w.wy; i += BLOCK_X * BLOCK_Y) {
    const int g = wrap(y0 + i, p.ny);
    w.rowf[i] = ((g == 0 && fix[2] != FIX_NONE) ? 1 : 0) |
                ((g == p.ny - 1 && fix[3] != FIX_NONE) ? 2 : 0);
  }
  for (int i = tid; i < w.wx; i += BLOCK_X * BLOCK_Y) {
    const int g = wrap(x0 + i, p.nx);
    w.colf[i] = ((g == 0 && fix[0] != FIX_NONE) ? 1 : 0) |
                ((g == p.nx - 1 && fix[1] != FIX_NONE) ? 2 : 0);
  }
  // Window load with wrapped global indices: correct for any grid size,
  // including windows larger than the grid.
  for (int r = threadIdx.y; r < w.wy; r += BLOCK_Y) {
    const long long row = static_cast<long long>(wrap(y0 + r, p.ny)) * p.nx;
    for (int c = threadIdx.x; c < w.wx; c += BLOCK_X) {
      w.src[r * w.wx + c] = to_compute(in[row + wrap(x0 + c, p.nx)]);
    }
  }
  __syncthreads();
  const C* res = run_substeps(w, p.s);

  // Write back the exact centre; the ragged edge of the grid is masked.
  for (int r = threadIdx.y; r < TILE_Y; r += BLOCK_Y) {
    const int gy = blockIdx.y * TILE_Y + r;
    if (gy >= p.ny) break;
    for (int c = threadIdx.x; c < TILE_X; c += BLOCK_X) {
      const int gx = blockIdx.x * TILE_X + c;
      if (gx >= p.nx) break;
      store(&out[static_cast<long long>(gy) * p.nx + gx],
            res[(r + k) * w.wx + (c + k)]);
    }
  }
}

template <typename T, typename C>
cudaError_t launch(const void* in, void* out, const Params& p,
                   cudaStream_t stream) {
  const size_t smem = window_smem_bytes(p.s.k, sizeof(C));
  const cudaError_t e = allow_smem(multistep_stencil_kernel<T, C>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.nx + TILE_X - 1) / TILE_X, (p.ny + TILE_Y - 1) / TILE_Y);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  multistep_stencil_kernel<T, C><<<grid, dim3(BLOCK_X, BLOCK_Y), smem, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64, 2 = bfloat16 (storage; f32 arithmetic).
// fix_*: 0 live periodic, 1 Dirichlet, 2 Neumann, 3 compat zero.
// Returns the cudaError_t of the launch (0 on success).  ``out`` must not
// alias ``in``.
int climate_multistep_stencil(const void* in, void* out, int ny, int nx,
                              int k, int dtype, double wc, double wxm,
                              double wxp, double wym, double wyp, int fix_left,
                              int fix_right, int fix_bottom, int fix_top,
                              double bc_value, void* stream) {
  Params p;
  p.ny = ny;
  p.nx = nx;
  if (ny < 1 || nx < 1 || in == out ||
      !make_stencil(&p.s, k, wc, wxm, wxp, wym, wyp, fix_left, fix_right,
                    fix_bottom, fix_top, bc_value)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<float, float>(in, out, p, s));
    case 1:
      return static_cast<int>(launch<double, double>(in, out, p, s));
    case 2:
      return static_cast<int>(launch<__nv_bfloat16, float>(in, out, p, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* climate_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
