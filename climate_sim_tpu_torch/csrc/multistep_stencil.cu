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
// bf16 is a storage type: loads widen to f32, the k sub-steps run in f32,
// and the result rounds to bf16 once, on the write.  f64 runs in f64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE_X = 64;   // output tile width (columns)
constexpr int TILE_Y = 32;   // output tile height (rows)
constexpr int BLOCK_X = 32;  // threads along x: one warp per window row
constexpr int BLOCK_Y = 8;
constexpr int MAX_STEPS = 32;  // the config's steps_per_pass ceiling

// Side codes, in the order left, right, bottom, top.
constexpr int FIX_NONE = 0;       // live periodic: read the window neighbour
constexpr int FIX_DIRICHLET = 1;  // ghost = bc_value
constexpr int FIX_NEUMANN = 2;    // ghost = the cell's own value
constexpr int FIX_ZERO = 3;       // reference-compat periodic: ghost = 0

struct Params {
  int ny, nx, k;
  double wc, wxm, wxp, wym, wyp;
  int fix[4];
  double bc_value;
};

__device__ __forceinline__ float to_compute(float v) { return v; }
__device__ __forceinline__ double to_compute(double v) { return v; }
__device__ __forceinline__ float to_compute(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ int wrap(int g, int n) {
  const int m = g % n;
  return m < 0 ? m + n : m;
}

template <typename C>
__device__ __forceinline__ C ghost_const(int fix, double bc_value) {
  return fix == FIX_DIRICHLET ? static_cast<C>(bc_value) : static_cast<C>(0);
}

// One block owns a TILE_Y x TILE_X output tile.  Shared memory holds two
// window buffers of the compute type (ping-pong between sub-steps) and one
// edge-flag byte per window row and column.
template <typename T, typename C>
__global__ void __launch_bounds__(BLOCK_X* BLOCK_Y)
    multistep_stencil_kernel(const T* __restrict__ in, T* __restrict__ out,
                             Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = p.k;
  const int wy = TILE_Y + 2 * k;
  const int wx = TILE_X + 2 * k;
  C* src = reinterpret_cast<C*>(smem);
  C* dst = src + wy * wx;
  unsigned char* rowf = reinterpret_cast<unsigned char*>(dst + wy * wx);
  unsigned char* colf = rowf + wy;

  const int y0 = blockIdx.y * TILE_Y - k;  // global row of window row 0
  const int x0 = blockIdx.x * TILE_X - k;  // global column of window column 0
  const int tid = threadIdx.y * BLOCK_X + threadIdx.x;

  // Edge flags: bit 0 = on the low physical edge of a fixed side, bit 1 =
  // on the high one.  A live-periodic side never sets its bit.
  for (int i = tid; i < wy; i += BLOCK_X * BLOCK_Y) {
    const int g = wrap(y0 + i, p.ny);
    rowf[i] = ((g == 0 && p.fix[2] != FIX_NONE) ? 1 : 0) |
              ((g == p.ny - 1 && p.fix[3] != FIX_NONE) ? 2 : 0);
  }
  for (int i = tid; i < wx; i += BLOCK_X * BLOCK_Y) {
    const int g = wrap(x0 + i, p.nx);
    colf[i] = ((g == 0 && p.fix[0] != FIX_NONE) ? 1 : 0) |
              ((g == p.nx - 1 && p.fix[1] != FIX_NONE) ? 2 : 0);
  }
  // Window load with wrapped global indices: correct for any grid size,
  // including windows larger than the grid.
  for (int r = threadIdx.y; r < wy; r += BLOCK_Y) {
    const long long row = static_cast<long long>(wrap(y0 + r, p.ny)) * p.nx;
    for (int c = threadIdx.x; c < wx; c += BLOCK_X) {
      src[r * wx + c] = to_compute(in[row + wrap(x0 + c, p.nx)]);
    }
  }
  __syncthreads();

  const C wc = static_cast<C>(p.wc), wxm = static_cast<C>(p.wxm),
          wxp = static_cast<C>(p.wxp), wym = static_cast<C>(p.wym),
          wyp = static_cast<C>(p.wyp);
  const bool self_l = p.fix[0] == FIX_NEUMANN, self_r = p.fix[1] == FIX_NEUMANN;
  const bool self_b = p.fix[2] == FIX_NEUMANN, self_t = p.fix[3] == FIX_NEUMANN;
  const C g_l = ghost_const<C>(p.fix[0], p.bc_value);
  const C g_r = ghost_const<C>(p.fix[1], p.bc_value);
  const C g_b = ghost_const<C>(p.fix[2], p.bc_value);
  const C g_t = ghost_const<C>(p.fix[3], p.bc_value);

  // Sub-step s updates the cells at distance >= s+1 from the window edge;
  // they read neighbours at distance >= s, which sub-step s-1 wrote (or the
  // load did), so after k sub-steps the centre tile is exact.
  for (int s = 0; s < k; ++s) {
    const int lo = s + 1, hy = wy - s - 1, hx = wx - s - 1;
    for (int r = lo + threadIdx.y; r < hy; r += BLOCK_Y) {
      const unsigned char rf = rowf[r];
      for (int c = lo + threadIdx.x; c < hx; c += BLOCK_X) {
        const unsigned char cf = colf[c];
        const int i = r * wx + c;
        const C a = src[i];
        const C ym = (rf & 1) ? (self_b ? a : g_b) : src[i - wx];
        const C yp = (rf & 2) ? (self_t ? a : g_t) : src[i + wx];
        const C xm = (cf & 1) ? (self_l ? a : g_l) : src[i - 1];
        const C xp = (cf & 2) ? (self_r ? a : g_r) : src[i + 1];
        // The JAX kernel's accumulation order: c, ym, yp, xm, xp.
        dst[i] = wc * a + wym * ym + wyp * yp + wxm * xm + wxp * xp;
      }
    }
    __syncthreads();
    C* t = src;
    src = dst;
    dst = t;
  }

  // Write back the exact centre; the ragged edge of the grid is masked.
  for (int r = threadIdx.y; r < TILE_Y; r += BLOCK_Y) {
    const int gy = blockIdx.y * TILE_Y + r;
    if (gy >= p.ny) break;
    for (int c = threadIdx.x; c < TILE_X; c += BLOCK_X) {
      const int gx = blockIdx.x * TILE_X + c;
      if (gx >= p.nx) break;
      store(&out[static_cast<long long>(gy) * p.nx + gx],
            src[(r + k) * wx + (c + k)]);
    }
  }
}

template <typename T, typename C>
cudaError_t launch(const void* in, void* out, const Params& p,
                   cudaStream_t stream) {
  const size_t wy = TILE_Y + 2 * p.k, wx = TILE_X + 2 * p.k;
  const size_t smem = 2 * wy * wx * sizeof(C) + wy + wx;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        multistep_stencil_kernel<T, C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
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
  if (ny < 1 || nx < 1 || k < 1 || k > MAX_STEPS || in == out) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int fixes[4] = {fix_left, fix_right, fix_bottom, fix_top};
  Params p;
  p.ny = ny;
  p.nx = nx;
  p.k = k;
  p.wc = wc;
  p.wxm = wxm;
  p.wxp = wxp;
  p.wym = wym;
  p.wyp = wyp;
  for (int i = 0; i < 4; ++i) {
    if (fixes[i] < FIX_NONE || fixes[i] > FIX_ZERO) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    p.fix[i] = fixes[i];
  }
  p.bc_value = bc_value;
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
