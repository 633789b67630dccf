// The sub-step core shared by every stencil kernel of the port (K1-K5):
// streaming temporal blocking with the vertical operands in registers.
//
// Geometry.  A block of band_w threads (a multiple of 32) owns a column band
// of band_w window columns, one column a thread, whose centre band_w - 2k
// columns are its output.  It walks down a segment of seg_rows output rows
// (the last segment of a field may be shorter), reading k halo rows above
// and below: rows = segment + 2k window rows, one per iteration.  Level s
// (the field after s sub-steps) trails level s-1 by one row, so at
// iteration i level 0 receives window row i and level s computes row i-s
// from level s-1's rows i-s-1, i-s and i-s+1; the k levels advance
// together, one row and one barrier per iteration, and level k's row is
// the output from iteration 2k on.  The wrapper computes band_w and
// seg_rows (ops/cuda_stencil.py::band_geometry); the kernel derives the
// grid from them.
//
// Operands.  Each thread keeps, for each level, its column's last two rows
// in registers (m2 = row r-1, m1 = row r) and gets row r+1 from the level
// below in the same iteration, so ym, c and yp never touch shared memory.
// Only xm and xp cross threads: each level's new row goes to a shared row
// buffer (two parities, so one barrier per iteration separates the writes
// of one iteration from the reads of the next), and the level above reads
// its neighbours there one iteration later.  Per update that is one shared
// store and two shared loads; level 0 needs no store of its own (its
// neighbours are read from the load ring) except in bf16, where the ring
// holds raw words and level 0 goes to a row buffer in f32 once per row.
//
// Loads.  Window rows arrive AHEAD rows early through cp.async (LDGSTS)
// into a ring of RING = AHEAD + 2 shared rows, one element per thread per
// row, and cp.async.wait_group precedes the barrier of the iteration that
// uses them, so the load of row i + AHEAD overlaps the sub-steps on row i.
// bf16 loads the aligned 4-byte word that holds the element (cp.async
// copies 4, 8 or 16 bytes) and the thread keeps which half it wants.
// Every address comes from a Source (wrapped global field for K1, a padded
// region for K2/K3, the tile and its halo slabs for K4/K5): its column part
// is computed once per thread, its row part once per row and uniform
// across the block, so no element pays a run-time `%`.
//
// The edge rule.  A row's (column's) edge bits say that a cell's ym (xm)
// operand is the bottom (left) BC ghost instead of the neighbour (bit 0),
// or that its yp (xp) is the top (right) ghost (bit 1).  The ghost is the
// Dirichlet value, the cell's own value (Neumann) or 0 (periodic under
// strict_reference_compat); a live-periodic side never sets a bit.  Column
// bits are computed once per thread; row bits once per row and shifted
// into a 64-bit history, so level s reads bit s (warp-uniform).  A block
// whose window touches no fixed side runs an instantiation without any
// select (decided once per block; level counts up to FAST_MAX).  A bit
// row e reaches level s at iteration e + s, so its selects can fire only
// on the KB iterations after it.
//
// k.  The levels' registers need a compile-time count, so the core is
// instantiated for 1, 2, 4, 8, 16 and 32 levels and a pass runs the least
// count that covers k: every level runs, the output is level k's row, and
// the levels above k compute rows that nothing reads (k = 1, 2, 4, 8, 16
// and 32 waste nothing; k = 5 wastes most, 3 levels of 8).  Every k in
// [1, MAX_STEPS] is one launch, so bf16 still rounds once per pass.  The
// loop body covers six rows, the ring's period and a multiple of the level
// rows' parity (2) and of the registers' rotation (3), so ring slots,
// shared offsets and registers are constants: no moves, no computed
// shared addresses, no branch per level.
//
// bf16 is a storage type: loads widen to f32, the sub-steps run in f32,
// and the result rounds to bf16 once, on the write.  f64 runs in f64.
//
// Several columns a thread (K1's wide body, stream_band_wide).  Each
// thread owns CPT adjacent window columns of every level (4 in f32 and
// bf16, 2 in f64, whose registers are twice as wide), so a band is
// CPT x threads columns and the pipeline above runs with CPT independent
// FMA chains a level.  Only a thread's two outer columns cross threads:
// their x neighbours come from the lanes beside it by shuffle, and at a
// warp's ends from a small exchange row a level and parity (each warp's
// first and last column, written one row earlier, read after the row's
// barrier).  A row takes all its shuffles and exchange reads first, so
// their latency stays off the levels' chain; per CPT x k updates a thread
// that is two shuffles and a predicated shared load and store a level,
// against three shared accesses an update in the one-column body.  Rows
// arrive as above, one 16-byte cp.async a thread where its columns are
// 16 aligned bytes of the field (f32, f64), else a copy an element.  The
// edge rule is the same, but decided per warp and range of rows: a fixed
// x side at a thread's first or last column only replaces that outer
// neighbour (one select a level); the warps with one at an inner column
// run the copy of the loop with the selects on every row, the others only
// on the rows that a fixed side's row can reach (from the block's first
// window row with edge bits to KB rows past its last, on the loop's
// rotation), and a copy without them on the rest.  A warp with no such
// row runs an instantiation that holds only the copy without selects.
// The copies meet at one barrier a row (barrier.sync without .aligned).
// A block of one warp (the band of 32 threads) runs an instantiation of
// its own: its outer lanes' x operands beyond the band fall in the halo it
// discards, so it has no exchange rows and no barrier, and its warps drift
// freely against each other's chains.
// Its loop body covers three rows, the registers' rotation; ring slot and
// parity step at run time, which keeps the loop small enough for the
// instruction cache (a six-row body of four columns ran at less than half
// the speed).  The launch bounds hold it to 170
// registers, so three blocks of 128 threads (or 12 of one warp) fit an
// SM; the wrapper cuts the field into one wave of blocks
// (ops/cuda_stencil.py::k1_geometry), since on the H100 the warps an SM
// holds decide its speed more than the halo that taller segments and
// wider bands save, and on a field too small to fill the SMs each row's
// chain through the levels does.  K1 runs it up to FAST_MAX levels;
// deeper passes and K2-K5 (whose sources, a padded region or a tile with
// its halo slabs, have other column layouts, and K3 bands k columns
// wide) run the one-column body.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

namespace climate {

constexpr int MAX_STEPS = 32;  // the config's steps_per_pass ceiling
constexpr int FAST_MAX = 8;    // level counts up to this have a select-free path
constexpr int MAX_BAND = 256;  // threads (window columns) of a block
constexpr int AHEAD = 4;       // rows in flight ahead of the row in use
constexpr int RING = AHEAD + 2;
// Entries of a shared row: MAX_BAND columns and a pad on each side that the
// edge threads read as xm / xp.  Fixed, so every shared address in the
// loop is a register plus an immediate, whatever the band's width.
constexpr int STRIDE = MAX_BAND + 2;
// K1's wide body (stream_band_wide): window columns a thread in f32 and
// bf16, and in f64 (whose registers are twice as wide); threads of a block
// at most; and the blocks of that size an SM must hold: ptxas keeps a wide
// instantiation to 65536 / (3 x 128) = 170 registers, so each runs 12
// warps an SM.  ops/cuda_stencil.py reads these `constexpr int` lines (and
// MAX_BAND, FAST_MAX) for its band geometry.
constexpr int WIDE_COLS = 4;
constexpr int WIDE_COLS_F64 = 2;
constexpr int WIDE_THREADS = 128;
constexpr int WIDE_MIN_BLOCKS = 3;
// The warps an SM holds of the wide body: blocks of one warp (the one-warp
// body) are held to as many a block as the wider blocks make together.
constexpr int WIDE_WARPS = WIDE_MIN_BLOCKS * WIDE_THREADS / 32;

// Side codes, in the order left, right, bottom, top.
constexpr int FIX_NONE = 0;       // live periodic: read the neighbour
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

// One pass: the output extent and row stride, the band geometry.
struct Pass {
  int ny, nx;
  long long ld_out;
  int band_w, seg_rows;
  Stencil s;
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

// The band geometry the wrapper chose; false when the kernel cannot run it.
// One column a thread: at most MAX_BAND columns.  cpt > 1 columns a thread
// (the wide body): at most WIDE_THREADS threads, k <= FAST_MAX.
inline bool band_ok(int band_w, int seg_rows, int k, int cpt = 1) {
  if (cpt == 1) {
    return band_w >= 32 && band_w <= MAX_BAND && band_w % 32 == 0 &&
           band_w > 2 * k && seg_rows >= 1;
  }
  return cpt > 1 && band_w % (32 * cpt) == 0 && band_w <= WIDE_THREADS * cpt &&
         band_w > 2 * k && k <= FAST_MAX && seg_rows >= 1;
}

// What a ring slot holds: the element, or for bf16 the aligned word
// around it.
template <typename T>
struct Word {
  using type = T;
};
template <>
struct Word<__nv_bfloat16> {
  using type = uint32_t;
};

template <typename T>
__device__ __forceinline__ const typename Word<T>::type* word_of(const T* p) {
  return p;
}
__device__ __forceinline__ const uint32_t* word_of(const __nv_bfloat16* p) {
  return reinterpret_cast<const uint32_t*>(reinterpret_cast<uintptr_t>(p) &
                                           ~static_cast<uintptr_t>(3));
}
// Which half of its word a bf16 element is (1: the high one).
template <typename T>
__device__ __forceinline__ unsigned half_of(const T*) {
  return 0;
}
__device__ __forceinline__ unsigned half_of(const __nv_bfloat16* p) {
  return static_cast<unsigned>(reinterpret_cast<uintptr_t>(p) >> 1) & 1u;
}

__device__ __forceinline__ float widen(float w, unsigned) { return w; }
__device__ __forceinline__ double widen(double w, unsigned) { return w; }
__device__ __forceinline__ float widen(uint32_t w, unsigned hi) {
  return __uint_as_float(hi ? (w & 0xffff0000u) : (w << 16));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename W>
__device__ __forceinline__ void cp_async(W* dst, const W* src) {
  static_assert(sizeof(W) == 4 || sizeof(W) == 8, "cp.async copies 4 or 8 bytes here");
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
               "n"(sizeof(W)));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename C>
__device__ __forceinline__ C ghost_const(int fix, double bc_value) {
  return fix == FIX_DIRICHLET ? static_cast<C>(bc_value) : static_cast<C>(0);
}

// Shared rows a KB-level instantiation keeps per parity: levels 1..KB-1,
// and level 0 in bf16.
template <typename T, typename C, int KB>
__host__ __device__ constexpr int levels_buffered() {
  return (KB - 1) + (std::is_same<T, C>::value ? 0 : 1);
}

template <typename T>
__host__ __device__ constexpr size_t ring_bytes() {
  return (RING * STRIDE * sizeof(typename Word<T>::type) + 15) / 16 * 16;
}

template <typename T, typename C, int KB>
__host__ __device__ constexpr size_t band_smem_bytes() {
  return ring_bytes<T>() + 2 * static_cast<size_t>(levels_buffered<T, C, KB>()) *
                               STRIDE * sizeof(C);
}

// Raise a kernel's dynamic shared-memory ceiling when a pass needs more
// than the default 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Stream one band segment: `rows` window rows starting at tile row y0 - k,
// this thread's window column c at tile column tc.  All KB levels run; the
// output is level k's row (k <= KB), levels above it compute unused rows.
template <typename T, typename C, int KB, bool EDGES, typename Source>
__device__ __forceinline__ void stream_band(const Source& src, T* __restrict__ out,
                                            const Pass& p, unsigned char* smem,
                                            int y0, int rows, int tc,
                                            unsigned colbits) {
  using W = typename Word<T>::type;
  constexpr bool kWidened = !std::is_same<T, C>::value;
  constexpr int NB = levels_buffered<T, C, KB>();
  static_assert(RING == 6, "the six-row loop body keeps ring slot == row mod 6");
  const int k = p.s.k, c = threadIdx.x;
  W* ring = reinterpret_cast<W*>(smem) + 1 + c;
  C* lvl = reinterpret_cast<C*>(smem + ring_bytes<T>()) + 1 + c;

  const C wc = static_cast<C>(p.s.wc), wxm = static_cast<C>(p.s.wxm),
          wxp = static_cast<C>(p.s.wxp), wym = static_cast<C>(p.s.wym),
          wyp = static_cast<C>(p.s.wyp);
  const int* fix = p.s.fix;
  const bool self_l = fix[0] == FIX_NEUMANN, self_r = fix[1] == FIX_NEUMANN;
  const bool self_b = fix[2] == FIX_NEUMANN, self_t = fix[3] == FIX_NEUMANN;
  const C g_l = ghost_const<C>(fix[0], p.s.bc_value);
  const C g_r = ghost_const<C>(fix[1], p.s.bc_value);
  const C g_b = ghost_const<C>(fix[2], p.s.bc_value);
  const C g_t = ghost_const<C>(fix[3], p.s.bc_value);
  const bool x_lo = colbits & 1u, x_hi = colbits & 2u;
  const bool writes = c >= k && c < p.band_w - k && tc < p.nx;
  T* dst = out + static_cast<long long>(y0) * p.ld_out + tc;  // next output row

  // The load cursor runs AHEAD rows in front of the row in use.
  const auto col = src.column(tc);
  int ld_row = src.row_start(y0 - k);
  unsigned halves = 0;  // bf16: bit j is the half of row i + j's word
#pragma unroll
  for (int j = 0; j < AHEAD; ++j) {
    if (j < rows) {
      const T* e = src.at(ld_row, col);
      cp_async(ring + j * STRIDE, word_of(e));
      halves |= half_of(e) << j;
      ld_row = src.row_next(ld_row);
    }
    cp_async_commit();
  }

  int bits_row = src.row_start(y0 - k);
  unsigned long long h_lo = 0, h_hi = 0;  // bit s: row i - s's edge bits
  // q[s][i % 3]: level s's row computed at iteration i (row i - s).
  C q[KB][3];
#pragma unroll
  for (int s = 0; s < KB; ++s) q[s][0] = q[s][1] = q[s][2] = static_cast<C>(0);

  // Row i, with U = i mod 6: the ring slot (U), the parity of the shared
  // level rows (U & 1) and the register rotation (U % 3) are constants.
  auto row = [&](int i, auto u) {
    constexpr int U = decltype(u)::value;
    constexpr int PAR = U & 1, NOW = U % 3, ONE = (U + 2) % 3, TWO = (U + 1) % 3;
    cp_async_wait<AHEAD - 1>();
    __syncthreads();
    q[0][NOW] = widen(ring[U * STRIDE], halves & 1u);
    halves >>= 1;
    if (i + AHEAD < rows) {
      const T* e = src.at(ld_row, col);
      cp_async(ring + ((U + AHEAD) % RING) * STRIDE, word_of(e));
      halves |= half_of(e) << (AHEAD - 1);
      ld_row = src.row_next(ld_row);
    }
    cp_async_commit();
    if (EDGES) {
      const unsigned b = src.row_bits(bits_row);
      bits_row = src.row_next(bits_row);
      h_lo = (h_lo << 1) | (b & 1u);
      h_hi = (h_hi << 1) | ((b >> 1) & 1u);
    }
    C* cur = lvl + PAR * NB * STRIDE;              // rows written now
    const C* old = lvl + (PAR ^ 1) * NB * STRIDE;  // rows of row i - 1
    const C* below;  // level 0's row i-1 at this column
    if constexpr (kWidened) {
      cur[0] = q[0][NOW];
      below = old;
    } else {
      below = reinterpret_cast<const C*>(ring + ((U + RING - 1) % RING) * STRIDE);
    }
    C res = static_cast<C>(0);
#pragma unroll
    for (int s = 1; s <= KB; ++s) {
      const C a = q[s - 1][ONE];
      C ym = q[s - 1][TWO], yp = q[s - 1][NOW], xm = below[-1], xp = below[1];
      if (EDGES) {
        if ((h_lo >> s) & 1ull) ym = self_b ? a : g_b;
        if ((h_hi >> s) & 1ull) yp = self_t ? a : g_t;
        if (x_lo) xm = self_l ? a : g_l;
        if (x_hi) xp = self_r ? a : g_r;
      }
      // The JAX kernel's accumulation order: c, ym, yp, xm, xp.
      const C r = wc * a + wym * ym + wyp * yp + wxm * xm + wxp * xp;
      if (s == k) res = r;
      if (s < KB) {
        constexpr int kOff = kWidened ? 1 : 0;
        q[s][NOW] = r;
        cur[(s - 1 + kOff) * STRIDE] = r;
        below = old + (s - 1 + kOff) * STRIDE;
      }
    }
    // res is level k's window row i - k: output row y0 + i - 2k.
    if (i >= 2 * k) {
      if (writes) store(dst, res);
      dst += p.ld_out;
    }
  };

  for (int i = 0; i < rows; i += 6) {
    row(i, std::integral_constant<int, 0>{});
    if (i + 1 < rows) row(i + 1, std::integral_constant<int, 1>{});
    if (i + 2 < rows) row(i + 2, std::integral_constant<int, 2>{});
    if (i + 3 < rows) row(i + 3, std::integral_constant<int, 3>{});
    if (i + 4 < rows) row(i + 4, std::integral_constant<int, 4>{});
    if (i + 5 < rows) row(i + 5, std::integral_constant<int, 5>{});
  }
}

// The wide body's shared layout.  A ring row holds the band's window
// columns between a 16-byte pad on each side, so each thread's cpt words
// start 16-byte aligned; its stride follows the band's width.  The
// exchange rows hold, per parity and level, each warp's first and last
// column (slot w + 1 for warp w; slots 0 and warps + 1 stay zero).
template <typename T>
__host__ __device__ constexpr int wide_pad() {
  return 16 / static_cast<int>(sizeof(typename Word<T>::type));
}
template <typename T>
__host__ __device__ constexpr int wide_stride(int band_w) {
  return band_w + 2 * wide_pad<T>();
}
constexpr int WIDE_SLOTS = WIDE_THREADS / 32 + 2;
template <typename T, typename C, int KB, int CPT, bool ONE_WARP>
__host__ __device__ constexpr size_t wide_smem_bytes(int band_w) {
  return RING * static_cast<size_t>(wide_stride<T>(band_w)) *
             sizeof(typename Word<T>::type) +
         (ONE_WARP ? 0 : 2 * static_cast<size_t>(KB) * WIDE_SLOTS * 2 * sizeof(C));
}

// cpt words of a ring row into registers, in one shared load where they
// span 16 bytes.
template <int CPT, typename W>
__device__ __forceinline__ void load_words(const W* p, W (&v)[CPT]) {
  if constexpr (CPT * sizeof(W) == 16) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    memcpy(v, &t, 16);
  } else {
#pragma unroll
    for (int j = 0; j < CPT; ++j) v[j] = p[j];
  }
}

// cpt adjacent outputs, in one global store (aligned to their whole size)
// for the column counts of WIDE_COLS and WIDE_COLS_F64.
template <int CPT>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[CPT]) {
  if constexpr (CPT == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < CPT; ++j) p[j] = v[j];
  }
}
template <int CPT>
__device__ __forceinline__ void store_vec(double* p, const double (&v)[CPT]) {
  if constexpr (CPT == 2) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  } else {
#pragma unroll
    for (int j = 0; j < CPT; ++j) p[j] = v[j];
  }
}
template <int CPT>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[CPT]) {
  if constexpr (CPT == 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 w;
    memcpy(&w.x, &lo, 4);
    memcpy(&w.y, &hi, 4);
    *reinterpret_cast<uint2*>(p) = w;
  } else {
#pragma unroll
    for (int j = 0; j < CPT; ++j) store(p + j, v[j]);
  }
}

// A block barrier that the warps of a block may reach from different
// instantiations of the wide body (barrier.sync without .aligned): the
// edge warps and the others run the same rows, one barrier each.
__device__ __forceinline__ void wide_sync() {
  asm volatile("barrier.sync 0;\n" ::: "memory");
}

// The wide body: stream_band with CPT adjacent window columns a thread,
// c0 = CPT * threadIdx.x .. c0 + CPT - 1, tile columns tc0 onwards.  The
// pipeline is stream_band's (levels one row apart, m2 / m1 / the incoming
// row in registers, one barrier a row, rows AHEAD rows early); what
// differs is where xm and xp come from: a thread's inner columns read
// their neighbours' registers, its outer two take the lane beside it by
// shuffle, and at a warp's ends lane 0 and lane 31 read the neighbouring
// warp's end column that it wrote to the exchange rows one row earlier.
// All of a row's shuffles and exchange reads come first, off the levels'
// chain, and a fixed x side at a thread's outer column replaces that
// neighbour there.  SELECTS: window rows [lo, hi) run every select
// (band_kernel sets the range: the rows a fixed side's row reaches, or
// every row in a warp with a fixed side's column at an inner column) and
// the rest a copy of the loop without them; without SELECTS every row runs
// that copy.  The loop body covers three rows, the registers' rotation;
// the ring slot and the exchange parity step at run time.
//
// ONE_WARP: the block is one warp, the whole band.  Lane 0's xm and lane
// 31's xp are then the band's outer halo columns, whose levels the band
// discards (a garbage operand there reaches k - 1 columns in by level k,
// and the band writes none of its outer k), so they take what the
// shuffles give (the lane's own value) and the exchange rows go: no shared
// access but the ring's, and no barrier, since each thread reads back only
// the ring words it copied itself (cp.async.wait_group orders them for
// it).  The x sides' selects stay in the copy without selects, as in
// wider blocks: a copy without them for the warps that hold no fixed x
// side ran the select-free pass slower where it shared an SM with the
// other copy, as a second copy of the loop does (PERF.md).
template <typename T, typename C, int KB, int CPT, bool ONE_WARP, bool SELECTS, typename Source>
__device__ __forceinline__ void stream_band_wide(const Source& src, T* __restrict__ out,
                                                 const Pass& p, unsigned char* smem,
                                                 int y0, int rows, int tc0,
                                                 unsigned colbits, int lo, int hi) {
  using W = typename Word<T>::type;
  constexpr bool kWidened = !std::is_same<T, C>::value;
  // One 16-byte copy brings a thread's columns where they are 16 bytes of
  // the field; bf16's ring holds one word an element.
  constexpr bool kVecIn = !kWidened && CPT * sizeof(T) == 16;
  constexpr int SL = 2 * WIDE_SLOTS;  // exchange entries a level
  constexpr unsigned FULL = 0xffffffffu;
  const int k = p.s.k, c = threadIdx.x, lane = c & 31, warp = c >> 5;
  const int rs = wide_stride<T>(p.band_w);
  W* ring = reinterpret_cast<W*>(smem) + wide_pad<T>() + c * CPT;
  C* xch = reinterpret_cast<C*>(
      smem + RING * static_cast<size_t>(rs) * sizeof(W));  // [parity][level][slot][end]
  const bool lo_lane = lane == 0, hi_lane = lane == 31, end_lane = lo_lane || hi_lane;
  const int xw = 2 * (warp + 1) + (hi_lane ? 1 : 0);      // this lane's entry
  const int xr = lo_lane ? 2 * warp + 1 : 2 * (warp + 2);  // the one it reads

  const C wc = static_cast<C>(p.s.wc), wxm = static_cast<C>(p.s.wxm),
          wxp = static_cast<C>(p.s.wxp), wym = static_cast<C>(p.s.wym),
          wyp = static_cast<C>(p.s.wyp);
  const int* fix = p.s.fix;
  const bool self_l = fix[0] == FIX_NEUMANN, self_r = fix[1] == FIX_NEUMANN;
  const bool self_b = fix[2] == FIX_NEUMANN, self_t = fix[3] == FIX_NEUMANN;
  const C g_l = ghost_const<C>(fix[0], p.s.bc_value);
  const C g_r = ghost_const<C>(fix[1], p.s.bc_value);
  const C g_b = ghost_const<C>(fix[2], p.s.bc_value);
  const C g_t = ghost_const<C>(fix[3], p.s.bc_value);

  // Which columns this thread writes: the band's centre, inside the field.
  unsigned writes = 0;
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int cw = CPT * c + j;
    if (cw >= k && cw < p.band_w - k && tc0 + j < p.nx) writes |= 1u << j;
  }
  T* dst = out + static_cast<long long>(y0) * p.ld_out + tc0;  // next output row
  const bool vec_out =
      writes == (1u << CPT) - 1 && p.ld_out % CPT == 0 &&
      reinterpret_cast<uintptr_t>(dst) % (CPT * sizeof(T)) == 0;

  // The load cursor runs AHEAD rows in front of the row in use.
  int col[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) col[j] = src.column(tc0 + j);
  const bool vec_in = kVecIn && src.contiguous(tc0, CPT);
  int ld_row = src.row_start(y0 - k);
  unsigned halves = 0;  // bf16: bit CPT * j + c, the half of column c in row i + j
  auto load = [&](W* slot, int ahead) {
    if (vec_in) {
      cp_async16(slot, src.at(ld_row, col[0]));
    } else {
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const T* e = src.at(ld_row, col[j]);
        cp_async(slot + j, word_of(e));
        halves |= half_of(e) << (CPT * ahead + j);
      }
    }
    ld_row = src.row_next(ld_row);
  };
#pragma unroll
  for (int j = 0; j < AHEAD; ++j) {
    if (j < rows) load(ring + j * rs, j);
    cp_async_commit();
  }

  int bits_row = 0;
  unsigned long long h_lo = 0, h_hi = 0;  // bit s: row i - s's edge bits
  // q[s][i % 3][j]: level s's row computed at iteration i (row i - s).
  C q[KB][3][CPT];
  C last[CPT];  // level KB's row
#pragma unroll
  for (int s = 0; s < KB; ++s) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) q[s][0][j] = q[s][1][j] = q[s][2][j] = static_cast<C>(0);
  }

  auto emit = [&](const C(&v)[CPT]) {
    if (vec_out) {
      store_vec<CPT>(dst, v);
    } else {
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        if ((writes >> j) & 1u) store(dst + j, v[j]);
      }
    }
  };

  int slot = 0;        // ring slot of row i: i mod RING
  C* cur = xch;        // exchange rows written at row i (parity i & 1) ...
  C* old = xch + KB * SL;  // ... and those of row i - 1
  auto row = [&](int i, auto u, auto edges) {
    constexpr int U = decltype(u)::value;
    constexpr int NOW = U, ONE = (U + 2) % 3, TWO = (U + 1) % 3;
    constexpr bool EDGES = decltype(edges)::value;
    cp_async_wait<AHEAD - 1>();
    if constexpr (!ONE_WARP) wide_sync();
    {
      W v[CPT];
      load_words<CPT>(ring + slot * rs, v);
#pragma unroll
      for (int j = 0; j < CPT; ++j) q[0][NOW][j] = widen(v[j], (halves >> j) & 1u);
      halves >>= CPT;
    }
    if (i + AHEAD < rows) load(ring + (slot + AHEAD) % RING * rs, AHEAD - 1);
    cp_async_commit();
    if (EDGES) {
      const unsigned b = src.row_bits(bits_row);
      bits_row = src.row_next(bits_row);
      h_lo = (h_lo << 1) | (b & 1u);
      h_hi = (h_hi << 1) | ((b >> 1) & 1u);
    }
    // The outer neighbours of every level's centre row (level s - 1's row
    // i - s, one row old), before this row's exchange writes.
    C left[KB], right[KB];
#pragma unroll
    for (int s = 0; s < KB; ++s) {
      [[maybe_unused]] C far;
      if constexpr (!ONE_WARP) far = end_lane ? old[s * SL + xr] : static_cast<C>(0);
      left[s] = __shfl_up_sync(FULL, q[s][ONE][CPT - 1], 1);
      right[s] = __shfl_down_sync(FULL, q[s][ONE][0], 1);
      if constexpr (!ONE_WARP) {
        if (lo_lane) left[s] = far;
        if (hi_lane) right[s] = far;
      }
      // A fixed x side at the thread's first (last) column: its xm (xp)
      // is the ghost, whatever lies beyond.
      if (colbits & 1u) left[s] = self_l ? q[s][ONE][0] : g_l;
      if ((colbits >> (2 * CPT - 1)) & 1u) right[s] = self_r ? q[s][ONE][CPT - 1] : g_r;
    }
    if constexpr (!ONE_WARP) {
      if (end_lane) cur[xw] = hi_lane ? q[0][NOW][CPT - 1] : q[0][NOW][0];
    }
#pragma unroll
    for (int s = 1; s <= KB; ++s) {
      C r[CPT];
      // The JAX kernel's accumulation order: c, ym, yp, xm, xp; each step
      // across the columns, so their chains interleave.  The first sum
      // keeps the one-column body's expression, so nvcc fuses its two
      // products the same way.
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const C a = q[s - 1][ONE][j];
        C ym = q[s - 1][TWO][j];
        if (EDGES && ((h_lo >> s) & 1ull)) ym = self_b ? a : g_b;
        r[j] = wc * a + wym * ym;
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        C yp = q[s - 1][NOW][j];
        if (EDGES && ((h_hi >> s) & 1ull)) yp = self_t ? q[s - 1][ONE][j] : g_t;
        r[j] = r[j] + wyp * yp;
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        C xm = j == 0 ? left[s - 1] : q[s - 1][ONE][j - 1];
        if (EDGES && ((colbits >> (2 * j)) & 1u)) xm = self_l ? q[s - 1][ONE][j] : g_l;
        r[j] = r[j] + wxm * xm;
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        C xp = j == CPT - 1 ? right[s - 1] : q[s - 1][ONE][j + 1];
        if (EDGES && ((colbits >> (2 * j + 1)) & 1u)) xp = self_r ? q[s - 1][ONE][j] : g_r;
        r[j] = r[j] + wxp * xp;
      }
      if (s < KB) {
#pragma unroll
        for (int j = 0; j < CPT; ++j) q[s][NOW][j] = r[j];
        if constexpr (!ONE_WARP) {
          if (end_lane) cur[s * SL + xw] = hi_lane ? r[CPT - 1] : r[0];
        }
      } else {
#pragma unroll
        for (int j = 0; j < CPT; ++j) last[j] = r[j];
      }
    }
    // Level k's window row i - k: output row y0 + i - 2k.
    if (i >= 2 * k) {
      if (k == KB) {
        emit(last);
      } else {
#pragma unroll
        for (int s = 1; s < KB; ++s) {
          if (s == k) emit(q[s][NOW]);
        }
      }
      dst += p.ld_out;
    }
    slot = slot == RING - 1 ? 0 : slot + 1;
    if constexpr (!ONE_WARP) {
      C* t = cur;
      cur = old;
      old = t;
    }
  };

  constexpr std::false_type kFree{};
  constexpr std::true_type kEdges{};
  if constexpr (!SELECTS) {
    for (int i = 0; i < rows; i += 3) {
      row(i, std::integral_constant<int, 0>{}, kFree);
      if (i + 1 < rows) row(i + 1, std::integral_constant<int, 1>{}, kFree);
      if (i + 2 < rows) row(i + 2, std::integral_constant<int, 2>{}, kFree);
    }
  } else {
    // Rows [0, lo) and [hi, rows) run the copy of the loop without the
    // selects, [lo, hi) the copy with them; lo and hi keep the rotation (lo
    // a multiple of 3, hi too or rows), and the rows before lo hold no edge
    // bits, so the history starts empty at lo.
    int i = 0, stop = lo;
#pragma unroll 1
    for (;;) {
      for (; i < stop; i += 3) {
        row(i, std::integral_constant<int, 0>{}, kFree);
        if (i + 1 < stop) row(i + 1, std::integral_constant<int, 1>{}, kFree);
        if (i + 2 < stop) row(i + 2, std::integral_constant<int, 2>{}, kFree);
      }
      if (i >= rows) break;
      bits_row = src.row_start(y0 - k + lo);
      h_lo = h_hi = 0;
      for (; i < hi; i += 3) {
        row(i, std::integral_constant<int, 0>{}, kEdges);
        if (i + 1 < hi) row(i + 1, std::integral_constant<int, 1>{}, kEdges);
        if (i + 2 < hi) row(i + 2, std::integral_constant<int, 2>{}, kEdges);
      }
      stop = rows;
    }
  }
}

// One block per band segment (grid: bands x segments).  minBlocks = 1 lets
// ptxas keep every level's rows in registers: without it, it trades the
// 8- and 16-level f32/bf16 kernels down to 80 registers and spills.  CPT
// columns a thread: 1 runs stream_band, more the wide body, in blocks of
// one warp (ONE_WARP, WIDE_WARPS of them an SM) or of several.
template <typename T, typename C, int KB, int CPT, bool ONE_WARP, typename Source>
__global__ void __launch_bounds__(CPT == 1 ? MAX_BAND : ONE_WARP ? 32 : WIDE_THREADS,
                                  CPT == 1 ? 1 : ONE_WARP ? WIDE_WARPS : WIDE_MIN_BLOCKS)
    band_kernel(Source src, T* __restrict__ out, Pass p) {
  static_assert(!ONE_WARP || CPT > 1, "the one-warp body is the wide body's");
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = p.s.k;
  const int x0 = blockIdx.x * (p.band_w - 2 * k);  // first output column
  const int y0 = blockIdx.y * p.seg_rows;          // first output row
  const int rows = min(p.seg_rows, p.ny - y0) + 2 * k;
  const int tc = x0 - k + CPT * static_cast<int>(threadIdx.x);

  // Zero the shared layout (pads and start-up rows hold zeros, not stale
  // bits), and decide whether this block's window touches a fixed side.
  // A one-warp block's layout is its threads' ring words alone, each
  // written before it is read.
  if constexpr (!ONE_WARP) {
    const int words = static_cast<int>(
        (CPT == 1 ? band_smem_bytes<T, C, KB>()
                  : wide_smem_bytes<T, C, KB, CPT, false>(p.band_w)) / 4);
    for (int i = threadIdx.x; i < words; i += blockDim.x) {
      reinterpret_cast<uint32_t*>(smem)[i] = 0u;
    }
  }
  unsigned colbits = 0;
#pragma unroll
  for (int j = 0; j < CPT; ++j) colbits |= src.col_bits(tc + j) << (2 * j);
  if constexpr (CPT == 1) {
    unsigned rowbits = 0;
    for (int j = threadIdx.x; j < rows; j += blockDim.x) {
      rowbits |= src.row_bits(src.row_start(y0 - k + j));
    }
    const bool edges = __syncthreads_or((colbits | rowbits) != 0u);
    if constexpr (KB <= FAST_MAX) {
      if (!edges) {
        stream_band<T, C, KB, false>(src, out, p, smem, y0, rows, tc, 0u);
        return;
      }
    }
    stream_band<T, C, KB, true>(src, out, p, smem, y0, rows, tc, colbits);
  } else {
    // The rows' bits decide for the block which rows take the selects, the
    // columns' for each warp: a fixed x side at a thread's first or last
    // column costs one select a level (its outer neighbour is the ghost);
    // one at an inner column takes the selects of every column and row.
    // Level s reads row i - s's bits at iteration i, so a bit row e can
    // select only on iterations e + 1 .. e + KB: the selects run from the
    // first bit row (rounded down to the loop's three-row rotation) to KB
    // rows past the last (rounded up), and every other row runs without.
    // Each warp finds the window's first and last row with edge bits by
    // itself, with no shared memory and no second barrier.
    int first = rows, last = -1;
    for (int j = threadIdx.x & 31; j < rows; j += 32) {
      if (src.row_bits(src.row_start(y0 - k + j)) != 0u) {
        first = min(first, j);
        last = j;
      }
    }
    first = __reduce_min_sync(0xffffffffu, first);
    last = __reduce_max_sync(0xffffffffu, last);
    if constexpr (!ONE_WARP) __syncthreads();  // the zeroed layout before the first loads
    constexpr unsigned outer = 1u | (1u << (2 * CPT - 1));
    int lo = rows, hi = rows;  // no bit row: no selects
    if (__any_sync(0xffffffffu, (colbits & ~outer) != 0u)) {
      lo = 0;
    } else if (last >= 0) {
      lo = first / 3 * 3;
      hi = min(rows, (last + KB + 3) / 3 * 3);
    }
    // A warp with no row to select runs an instantiation of its own, the
    // loop without selects alone, which kept the select-free passes as fast
    // as before on the H100 where the other layouts tried did not (PERF.md).
    if (lo >= rows) {
      stream_band_wide<T, C, KB, CPT, ONE_WARP, false>(src, out, p, smem, y0, rows, tc, colbits,
                                                       lo, hi);
    } else {
      stream_band_wide<T, C, KB, CPT, ONE_WARP, true>(src, out, p, smem, y0, rows, tc, colbits,
                                                      lo, hi);
    }
  }
}

template <typename T, typename C, int KB, int CPT, bool ONE_WARP, typename Source>
cudaError_t launch_kernel(const Source& src, T* out, const Pass& p, cudaStream_t stream) {
  const size_t smem = CPT == 1 ? band_smem_bytes<T, C, KB>()
                               : wide_smem_bytes<T, C, KB, CPT, ONE_WARP>(p.band_w);
  const cudaError_t e = allow_smem(band_kernel<T, C, KB, CPT, ONE_WARP, Source>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.nx + p.band_w - 2 * p.s.k - 1) / (p.band_w - 2 * p.s.k),
                  (p.ny + p.seg_rows - 1) / p.seg_rows);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  band_kernel<T, C, KB, CPT, ONE_WARP, Source><<<grid, p.band_w / CPT, smem, stream>>>(src, out,
                                                                                      p);
  return cudaGetLastError();
}

// A band of one warp (band_w == 32 x CPT) of the wide body runs its
// one-warp instantiation.
template <typename T, typename C, int KB, int CPT, typename Source>
cudaError_t launch_levels(const Source& src, T* out, const Pass& p,
                          cudaStream_t stream) {
  if constexpr (CPT > 1) {
    if (p.band_w == 32 * CPT) return launch_kernel<T, C, KB, CPT, true>(src, out, p, stream);
  }
  return launch_kernel<T, C, KB, CPT, false>(src, out, p, stream);
}

// Launch one pass of the core on the current stream, with the least level
// count that covers k.  WIDE (K1 alone): passes up to FAST_MAX steps run
// the wide body, WIDE_COLS columns a thread (WIDE_COLS_F64 in f64), and
// only deeper ones the one-column body.
template <typename T, typename C, bool WIDE, typename Source>
cudaError_t launch_band(const Source& src, void* out, const Pass& p,
                        cudaStream_t stream) {
  T* o = static_cast<T*>(out);
  const int k = p.s.k;
  if constexpr (WIDE) {
    constexpr int W = std::is_same<T, double>::value ? WIDE_COLS_F64 : WIDE_COLS;
    if (k <= FAST_MAX) {
      if (!band_ok(p.band_w, p.seg_rows, k, W)) return cudaErrorInvalidValue;
      if (k <= 1) return launch_levels<T, C, 1, W>(src, o, p, stream);
      if (k <= 2) return launch_levels<T, C, 2, W>(src, o, p, stream);
      if (k <= 4) return launch_levels<T, C, 4, W>(src, o, p, stream);
      return launch_levels<T, C, FAST_MAX, W>(src, o, p, stream);
    }
  }
  if (!band_ok(p.band_w, p.seg_rows, k)) return cudaErrorInvalidValue;
  if constexpr (!WIDE) {
    if (k <= 1) return launch_levels<T, C, 1, 1>(src, o, p, stream);
    if (k <= 2) return launch_levels<T, C, 2, 1>(src, o, p, stream);
    if (k <= 4) return launch_levels<T, C, 4, 1>(src, o, p, stream);
    if (k <= 8) return launch_levels<T, C, 8, 1>(src, o, p, stream);
  }
  if (k <= 16) return launch_levels<T, C, 16, 1>(src, o, p, stream);
  return launch_levels<T, C, MAX_STEPS, 1>(src, o, p, stream);
}

template <typename T>
struct Tag {
  using type = T;
};

// Launch one pass for a dtype code (0 float32, 1 float64, 2 bfloat16
// storage with float32 arithmetic) with the source make(Tag<T>) builds;
// WIDE as in launch_band.
template <bool WIDE = false, typename Make>
inline int dispatch(int dtype, const Pass& p, void* out, void* stream, Make make) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_band<float, float, WIDE>(make(Tag<float>{}), out, p, s));
    case 1:
      return static_cast<int>(
          launch_band<double, double, WIDE>(make(Tag<double>{}), out, p, s));
    case 2:
      return static_cast<int>(
          launch_band<__nv_bfloat16, float, WIDE>(make(Tag<__nv_bfloat16>{}), out, p, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace climate
