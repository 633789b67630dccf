// The sub-step core shared by every stencil kernel of the port (K1-K4).
//
// A block owns a TILE_Y x TILE_X output tile.  Its shared memory holds two
// (TILE_Y+2k) x (TILE_X+2k) window buffers of the compute type (ping-pong
// between sub-steps) and one edge byte per window row and column.  The
// kernels differ only in how they fill the window and the edge bytes: K1
// from the global field with wrapped indices, K2-K4 from a tile and its
// exchanged halos with edge flags.  The k sub-steps are the same.
//
// Edge bytes: bit 0 of a row (column) byte says that the cell's ym (xm)
// operand is the bottom (left) BC ghost instead of the window neighbour;
// bit 1 says the same of yp (xp) and the top (right) ghost.  The ghost is
// the Dirichlet value, the cell's own value (Neumann) or 0 (periodic under
// strict_reference_compat).  A live-periodic side never sets a bit.
//
// bf16 is a storage type: loads widen to f32, the sub-steps run in f32,
// and the result rounds to bf16 once, on the write.  f64 runs in f64.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace climate {

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

// The update of one sub-step: the unsplit Euler step collapsed to five
// weights, and what each physical side's ghost is.
struct Stencil {
  int k;
  double wc, wxm, wxp, wym, wyp;
  int fix[4];
  double bc_value;
};

// Fill a Stencil from a C entry point's arguments; false when k or a side
// code is out of range.
inline bool make_stencil(Stencil* s, int k, double wc, double wxm, double wxp,
                         double wym, double wyp, int fix_left, int fix_right,
                         int fix_bottom, int fix_top, double bc_value) {
  if (k < 1 || k > MAX_STEPS) return false;
  const int fixes[4] = {fix_left, fix_right, fix_bottom, fix_top};
  for (int i = 0; i < 4; ++i) {
    if (fixes[i] < FIX_NONE || fixes[i] > FIX_ZERO) return false;
    s->fix[i] = fixes[i];
  }
  s->k = k;
  s->wc = wc;
  s->wxm = wxm;
  s->wxp = wxp;
  s->wym = wym;
  s->wyp = wyp;
  s->bc_value = bc_value;
  return true;
}

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

template <typename C>
__device__ __forceinline__ C ghost_const(int fix, double bc_value) {
  return fix == FIX_DIRICHLET ? static_cast<C>(bc_value) : static_cast<C>(0);
}

// Bytes of dynamic shared memory a block needs for pass size k.
inline size_t window_smem_bytes(int k, size_t compute_size) {
  const size_t wy = TILE_Y + 2 * k, wx = TILE_X + 2 * k;
  return 2 * wy * wx * compute_size + wy + wx;
}

// Raise a kernel's dynamic shared-memory ceiling when a pass needs more
// than the default 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The shared-memory carve-up of one block.
template <typename C>
struct Window {
  int wy, wx;
  C* src;
  C* dst;
  unsigned char* rowf;
  unsigned char* colf;

  __device__ Window(unsigned char* smem, int k)
      : wy(TILE_Y + 2 * k), wx(TILE_X + 2 * k) {
    src = reinterpret_cast<C*>(smem);
    dst = src + wy * wx;
    rowf = reinterpret_cast<unsigned char*>(dst + wy * wx);
    colf = rowf + wy;
  }
};

// Run the k sub-steps on a loaded window (edge bytes set, block
// synchronised).  Sub-step s updates the cells at distance >= s+1 from the
// window edge; they read neighbours at distance >= s, which sub-step s-1
// wrote (or the load did), so after k sub-steps the centre tile is exact.
// Returns the buffer that holds the result.
template <typename C>
__device__ __forceinline__ const C* run_substeps(Window<C>& w, const Stencil& p) {
  const C wc = static_cast<C>(p.wc), wxm = static_cast<C>(p.wxm),
          wxp = static_cast<C>(p.wxp), wym = static_cast<C>(p.wym),
          wyp = static_cast<C>(p.wyp);
  const bool self_l = p.fix[0] == FIX_NEUMANN, self_r = p.fix[1] == FIX_NEUMANN;
  const bool self_b = p.fix[2] == FIX_NEUMANN, self_t = p.fix[3] == FIX_NEUMANN;
  const C g_l = ghost_const<C>(p.fix[0], p.bc_value);
  const C g_r = ghost_const<C>(p.fix[1], p.bc_value);
  const C g_b = ghost_const<C>(p.fix[2], p.bc_value);
  const C g_t = ghost_const<C>(p.fix[3], p.bc_value);
  const int wx = w.wx;
  C* src = w.src;
  C* dst = w.dst;
  for (int s = 0; s < p.k; ++s) {
    const int lo = s + 1, hy = w.wy - s - 1, hx = wx - s - 1;
    for (int r = lo + threadIdx.y; r < hy; r += BLOCK_Y) {
      const unsigned char rf = w.rowf[r];
      for (int c = lo + threadIdx.x; c < hx; c += BLOCK_X) {
        const unsigned char cf = w.colf[c];
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
  return src;
}

}  // namespace climate
