// Layered min-sum LDPC decoder for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX reference,
// srsran_edgeric_5g_tpu/ops/ldpc/decoder_pallas.py:
//  * K1: _make_kernel (:100-146) behind _decode_pallas_inner / decode_pallas
//    (:211-258);
//  * K2: _make_kernel_int8 (:152-208) behind _decode_pallas_int8_inner /
//    decode_pallas_int8 (:261-311);
// and their in-kernel parity check and sweep loop (_syndrome_ok /
// _iterate_kernel, :53-97).  Three arithmetic modes (template parameter M):
//
//  * kF32  (0): K1's arithmetic — normalised min-sum with scale 0.8,
//    R = (sgn*st) * (mag*scale), L = t + R, hard bit post < 0
//    (decode_pallas), or L <= 0 when the launch asks for it (hard_le: the
//    reference's "layered" schedule, which its decode("auto") runs off the
//    TPU).  The two rules differ only on an exact-zero posterior.  Every
//    multiply and add is rounded separately (__fmul_rn / __fadd_rn, and the
//    library is built with --fmad=false), so the result is bit-equal to the
//    plain PyTorch version.
//  * kWire (1): the semantics of the reference's layered_wire schedule
//    (srsran_edgeric_5g_tpu/ops/ldpc/decoder.py:212-273 with
//    _minsum(scale_floor=True)), which the main path's decode("wire_auto")
//    computes: ±64 load clamp, ±120 v2c saturation with frozen (|L| > 120)
//    posteriors passing through, min trackers capped at 120, truncating scale
//    (mag * floor(0.8 * 2^16)) >> 16, the promotion sum pinning at ±127 with
//    its infinite-addend rules (kWirePin, kFrozen), hard bit L <= 0.  All values are
//    integers, so it runs in int32 arithmetic, and since every posterior
//    stays within ±127 L is stored as int8.  The card takes scaling <= 1,
//    which keeps every message within ±120.
//  * kInt8 (2): K2's fixed-point arithmetic — int8 input (the wrapper rounds
//    and clips to ±127), no load clamp; int32 t = L - R, running minima with
//    the second minimum starting at 1 << 20, mag = (mag * 13) >> 4,
//    R = clip(sgn*st*mag, ±120), L = t + R stored int16 and never clamped,
//    hard bit L < 0.
//
// Design.  One CTA decodes one codeblock; thread z owns lane z of the Zc
// lifting dimension, with Zc rounded up to whole warps (the lanes past Zc
// only join the barriers and ballots), so every NR lifting size from 2 to
// 384 runs.  The lifted cyclic shift by s of the TPU kernel's lane roll
// becomes thread z reading L[c][(z + s) % Zc] and writing its update back to
// the same element: inside one check row every edge has a different column
// and (z + s) % Zc is a permutation of the lanes, so no two threads touch one
// element; a __syncthreads() separates rows.
//  * Rows are specialised by degree: row_update<M, D, kFirst> holds the
//    row's D gather positions and v2c values in registers, issues its D
//    gathers together, and has no slot past D; a warp-uniform switch on the
//    row's degree picks it (BG1: {3..10, 19}, BG2: {3, 4, 5, 6, 8, 10}).  The
//    first sweep has its own copy, which neither reads nor rebuilds R (it is
//    0): at 25 dB most codeblocks stop after it.
//  * R is kept per row and lane in the compressed form of hardware decoders:
//    the two scaled magnitudes sm1 = scale(m1) and sm2 = scale(m2), the index
//    of the first minimum and one sign bit per edge; R_j = ±(j == amin ? sm2 :
//    sm1) is rebuilt exactly.  Integer modes: one 32-bit word per row and lane
//    (rows of degree > kSmallDeg keep sm2 in one extra byte), in shared
//    memory — 188 B per lane at BG1 against 316 for a byte per edge.  f32
//    mode: three words per row and lane in a device-memory scratch that the
//    wrapper allocates (its L alone takes 61 KB at BG1 Zc=224).
//  * A barrier follows a row only where the next row shares a column with a
//    row since the last barrier (the wrapper's row_sync): 32 of BG1's 46
//    rows, 28 of BG2's 42.
//  * Shared memory of one CTA at BG1 Zc=224: tables 2,048 B, packed hard
//    bits 1,904 B, L 15,232 B (wire, int8) or 30,464 B (K2, int16), R
//    42,112 B: 61,296 B for wire and 76,528 B for K2, so three CTAs (21
//    warps) fit on an SM in both; __launch_bounds__(384, 2) caps a thread at
//    80 registers, which three CTAs of 224 threads leave room for.
//  * LLRs come in as 16-byte loads and hard bits leave as 16-byte stores when
//    the rows are 16-byte multiples (BG1 Zc=224: 15,232 B in, 4,928 B out).
//  * The syndrome is bit-packed: a __ballot_sync per warp and column packs
//    the hard bits of L, and a row's parity is the XOR of its edges' Zc-bit
//    vectors, each rotated by the edge's shift (a funnel shift of two words,
//    plus the wrapped low word where the 32 lanes cross Zc): 316 x 7 word
//    operations per codeblock at BG1 Zc=224 instead of 316 gathers per lane.
//
// Early exit.  The Pallas kernels stop a whole tile of b_tile codeblocks once
// every codeword of the tile meets parity (after at least one sweep); the
// schedules that K1 computes off the TPU ("layered", "layered_wire") stop the
// whole batch of a call once every codeword meets parity, under the
// reference's vmap over TBs each TB's codeblocks, and under its sharding
// every codeblock on every device (one while_loop over the global batch).
// K1 takes the group size: exit_group g stops each group of g consecutive
// codeblocks together; the wrapper extends a group over ranks.
//  * Fused path (ldpc_layered_decode): all sweeps in one launch, each CTA
//    decides for itself — g == 1, and with g == 0 the fixed-sweep decode.
//    After each sweep the CTA evaluates the syndrome of its hard bits
//    (__syncthreads_or over the row parities); the same syndrome gives the
//    `ok` output.
//  * Group exit (modes 0 and 1).  The batch rule runs every codeblock of a
//    group s* sweeps, the first n at which all of them meet parity; it is at
//    least the largest own exit f_i of the group, and a codeblock that met
//    parity after f_i sweeps can miss it after more (waterfall input,
//    bler_sweep MCS 24 at 16 dB), so its bits are those after s* sweeps.
//    What bounds a design here is repeated work: decoding a codeblock again
//    from its LLRs (as an earlier cooperative kernel did) repeats its first f_i
//    sweeps, and restarting a group on each missed round repeats them all.
//    So no sweep runs twice: the fused launch posts each codeblock's own
//    exit to its group's target (atomicMax) and, while the target it reads
//    is above its own, sweeps on in shared memory; a codeblock that still
//    stops before num_iters keeps its L (and, in wire mode, its compressed R:
//    57,344 B at BG1 Zc=224; the f32 mode's R lives in r_state) in a device
//    scratch.  Round 0 of resume_kernel brings every codeblock to its
//    group's target from that state (sweep<M, false>, never the first-sweep
//    form), round r one more sweep for the groups where a codeblock missed
//    parity in round r - 1; CTAs with nothing to do return at once, and
//    state goes back to the scratch only where another round can follow.
//    Every codeblock ends with exactly s* sweeps; `executed` counts them.
//    Over one rank the rounds are num_iters launches with no host sync;
//    over several the wrapper all-reduces the targets and each round's
//    flags between launches (decoder_cuda._rounds_over_ranks).
//  * Tiled path (ldpc_int8_decode_tiled, K2 with early stop and b_tile > 1):
//    one launch runs one sweep: L and R live in device memory between
//    launches; each CTA that ends a sweep with a violated syndrome marks its
//    tile in viol[sweep][tile]; a CTA whose tile had no violation after the
//    previous sweep returns at once.  num_iters launches, no host sync.  Each
//    launch writes its codeblocks' hard bits, ok and sweep count, so a tile
//    that stopped keeps the outputs of its last sweep.
//
// Bound (H100 SXM, main path: B = 2048 codeblocks, BG1, Zc = 224, 316 edges).
// The check-node update is about 16 ALU operations per edge-lane per sweep
// (subtract, saturate, abs, two min-tracker updates, sign parity, magnitude
// select, scale, sign, add, pin), i.e. 16 * 316 * 224 * 6 * 2048 = 1.4e10
// operations for 6 sweeps, against ~3.3e13 32-bit lane operations/s: about
// 0.4 ms; the 31 MB int8 input is 0.01 ms of HBM time.  So the decode is
// bound by operations, not bytes; all arithmetic here is 32-bit scalar (no
// packed SIMD), so the 32-bit rate is the right peak for that floor.  The
// kernel issues about twice those 16 operations per edge-lane (gather
// address, rebuilding the old message, bookkeeping), and almost all of them
// are integer instructions, which an SM runs on 64 INT32 lanes per clock
// against the 128 lanes the 32-bit rate assumes; that, more than latency, is
// what stands between it and the floor.  The group exit adds the kept
// state's round trip (at most 3 x 117 MB on the main path, 0.1 ms of HBM
// time) and the tiled path L and R through device memory per sweep.

#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

namespace {

constexpr int kF32 = 0, kWire = 1, kInt8 = 2;

constexpr int kMaxZc = 384;     // largest lifting size
constexpr int kSmallDeg = 11;   // rows up to this degree keep R in one word
constexpr int kWireLoad = 64;   // soft_bits_clamp at load
constexpr int kWireMax = 120;   // LLR_MAX
constexpr int kWirePin = 121;   // a fixed bit (the reference's LLR_INFTY, 127)
constexpr int kInt8Clamp = 120; // decoder_pallas.LLR_CLAMP
// Wire mode takes 0 <= scaling <= 1 (the wrapper checks), so every message
// has |R| <= 120 and the reference's promotion rules (an infinite addend,
// |x| > 120, forces its sign unless both addends are infinite with opposite
// signs) reduce to: a frozen posterior keeps its sign, anything else pins
// past ±120.  The kernel stores a pinned bit as ±kWirePin = ±121 instead of
// the reference's ±127, so the pin is one clamp to ±121: every use of L
// (the frozen test |L| > 120, the hard bit L <= 0) reads the same from
// either.  A frozen v2c value is carried as ±kFrozen = ±254, so that the
// clamp of t + R keeps it frozen with its sign (|R| <= 120); its sign and
// its tracked magnitude (capped at 120) are those of ±127.
constexpr int kFrozen = 254;
constexpr int kMaxDevices = 64;

template <int M> struct Types;
// In: input element, L: stored posterior, V: arithmetic type, kBig: initial
// second minimum (above any tracked magnitude), kRowWords: 32-bit words of
// compressed R per row and lane.
template <> struct Types<kF32> {
  using In = float; using L = float; using V = float;
  static constexpr float kBig = 1e30f;
  static constexpr int kRowWords = 3;
};
template <> struct Types<kWire> {
  using In = int8_t; using L = int8_t; using V = int;
  static constexpr int kBig = 1 << 30;
  static constexpr int kRowWords = 1;
};
template <> struct Types<kInt8> {
  using In = int8_t; using L = int16_t; using V = int;
  static constexpr int kBig = 1 << 20;
  static constexpr int kRowWords = 1;
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Bytes of compressed R per codeblock: words [rows * kRowWords][zc] and, in
// the integer modes, one byte per lane for each row of degree > kSmallDeg.
template <int M>
__host__ __device__ inline size_t r_bytes(int rows, int n_big, int zc) {
  size_t bytes = size_t(rows) * Types<M>::kRowWords * zc * sizeof(uint32_t);
  if constexpr (M != kF32) bytes += size_t(n_big) * zc;
  return align16(bytes);
}

// Shared memory of one CTA: the edge table (one word per edge for the row
// update, one uint16 for the syndrome), row starts, barrier flags, the
// group exit's target as read by thread 0, packed hard bits, L, and (fused
// integer modes) R.
struct Layout {
  size_t cs, rs, sync, tgt, hb, l, r, total;
};

template <int M>
__host__ __device__ inline Layout layout(int rows, int cols, int n_edges, int n_big, int zc,
                                         bool r_in_smem) {
  const int nw = (zc + 31) / 32;
  Layout o;
  o.cs = align16(size_t(n_edges) * sizeof(uint32_t));
  o.rs = o.cs + align16(size_t(n_edges) * sizeof(uint16_t));
  o.sync = o.rs + align16(size_t(rows + 1) * sizeof(uint16_t));
  o.tgt = o.sync + align16(size_t(rows));
  o.hb = o.tgt + 16;
  o.l = o.hb + align16(size_t(cols) * nw * sizeof(uint32_t));
  o.r = o.l + align16(size_t(cols) * zc * sizeof(typename Types<M>::L));
  o.total = o.r + (r_in_smem ? r_bytes<M>(rows, n_big, zc) : 0);
  return o;
}

struct Scale {
  float f;     // f32 mode
  int q16;     // wire mode: floor(scaling * 2^16)
};

// The base graph as the wrapper passes it, in device memory: row starts
// (rows + 1), barrier flags (rows; 1 = __syncthreads() after the row), and
// per edge (row-major, columns ascending) its column and shift.
struct Tables {
  const int32_t* row_start;
  const int32_t* row_sync;
  const int32_t* edge_col;
  const int32_t* edge_shift;
};

// le: the f32 mode's hard rule L <= 0 (else L < 0); the other modes fix it.
template <int M>
__device__ __forceinline__ int hard_bit(typename Types<M>::L v, bool le) {
  if constexpr (M == kWire) return v <= 0;
  else if constexpr (M == kF32) return le ? v <= 0 : v < 0;
  else return v < 0;
}

template <int M>
__device__ __forceinline__ typename Types<M>::L load_llr(typename Types<M>::In x) {
  if constexpr (M == kWire) return static_cast<int8_t>(max(-kWireLoad, min(kWireLoad, int(x))));
  else return static_cast<typename Types<M>::L>(x);
}

// Compressed R of one row and lane: R_j = (flips bit j ? -1 : 1) *
// (j == amin ? sm2 : sm1).
template <int M, int D>
struct RowR {
  using V = typename Types<M>::V;
  V sm1 = V(0), sm2 = V(0);
  int amin = 0;
  uint32_t flips = 0;

  __device__ __forceinline__ V msg(int j) const {
    const V m = j == amin ? sm2 : sm1;
    return (flips >> j) & 1u ? -m : m;
  }

  // rw: this row's words ([kRowWords][zc]); rb: its sm2 bytes (degree > kSmallDeg).
  __device__ __forceinline__ void load(const uint32_t* rw, const uint8_t* rb, int zc, int z) {
    const uint32_t w = rw[z];
    if constexpr (M == kF32) {
      flips = w & 0xffffffu;
      amin = int(w >> 24);
      sm1 = __uint_as_float(rw[zc + z]);
      sm2 = __uint_as_float(rw[2 * zc + z]);
    } else if constexpr (D <= kSmallDeg) {
      flips = w & 0x7ffu;
      amin = int((w >> 11) & 31u);
      sm2 = int((w >> 16) & 255u);
      sm1 = int(w >> 24);
    } else {
      flips = w & 0x7ffffu;
      amin = int((w >> 19) & 31u);
      sm1 = int(w >> 24);
      sm2 = int(rb[z]);
    }
  }

  __device__ __forceinline__ void store(uint32_t* rw, uint8_t* rb, int zc, int z) const {
    if constexpr (M == kF32) {
      rw[z] = flips | uint32_t(amin) << 24;
      rw[zc + z] = __float_as_uint(sm1);
      rw[2 * zc + z] = __float_as_uint(sm2);
    } else if constexpr (D <= kSmallDeg) {
      rw[z] = flips | uint32_t(amin) << 11 | uint32_t(sm2) << 16 | uint32_t(sm1) << 24;
    } else {
      rw[z] = flips | uint32_t(amin) << 19 | uint32_t(sm1) << 24;
      rb[z] = uint8_t(sm2);
    }
  }
};

// The scaled magnitude of a tracked minimum.
template <int M>
__device__ __forceinline__ typename Types<M>::V scale_mag(typename Types<M>::V mag, Scale sc) {
  // Wire: mag <= 120 (the tracker cap), so the reference's pass-through of
  // larger magnitudes never applies.
  if constexpr (M == kWire) return (mag * sc.q16) >> 16;
  else if constexpr (M == kInt8) return min((mag * 13) >> 4, kInt8Clamp);   // x 0.8125
  else return __fmul_rn(mag, sc.f);
}

// One check row of degree D for lane z: gather, min-sum update, scatter.
// kFirst: the first sweep, where R == 0 is neither read nor rebuilt.
// edges: the row's (c * zc + s) | (zc - s) << 16 per edge (column c, shift
// s), so lane z gathers L[c][(z + s) % zc] at c * zc + z + s, less zc once
// z >= zc - s.
template <int M, int D, bool kFirst>
__device__ __forceinline__ void row_update(typename Types<M>::L* s_l, uint32_t* rw, uint8_t* rb,
                                           const uint32_t* edges, int zc, int z, Scale sc) {
  using LT = typename Types<M>::L;
  using VT = typename Types<M>::V;
  RowR<M, D> old;
  if constexpr (!kFirst) old.load(rw, rb, zc, z);
  int pos[D];
  VT t[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const uint32_t e = edges[j];
    const int p = int(e & 0xffffu) + z;
    pos[j] = z >= int(e >> 16) ? p - zc : p;
  }
#pragma unroll
  for (int j = 0; j < D; ++j) t[j] = VT(s_l[pos[j]]);
  VT m1 = VT(0), m2 = Types<M>::kBig;
  int amin = 0;
  int k1 = 0, k2 = 0x7fffffff;            // integer modes: |t| << 5 | j
  uint32_t neg = 0;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const VT lg = t[j];
    const VT rold = kFirst ? VT(0) : old.msg(j);
    VT tv, a;
    if constexpr (M == kWire) {
      // v2c saturation; a frozen posterior (|L| > 120: ±kWirePin) passes
      // through, carried as ±kFrozen so that the pin below keeps it.
      tv = max(-kWireMax, min(kWireMax, lg - rold));
      tv = lg > kWireMax ? kFrozen : (lg < -kWireMax ? -kFrozen : tv);
      a = min(abs(tv), kWireMax);                      // tracker cap
    } else if constexpr (M == kInt8) {
      tv = lg - rold;
      a = abs(tv);
    } else {
      tv = __fsub_rn(lg, rold);
      a = fabsf(tv);
    }
    t[j] = tv;
    if constexpr (M == kF32) {
      if (j == 0) {
        m1 = a;
      } else {
        m2 = a < m1 ? m1 : (a < m2 ? a : m2);
        amin = a < m1 ? j : amin;
        m1 = a < m1 ? a : m1;
      }
    } else {
      // Magnitude and slot in one key: the smallest key is the first of the
      // equal minima, the second smallest the minimum over the other slots.
      const int key = a << 5 | j;
      if (j == 0) {
        k1 = key;
      } else {
        k2 = min(k2, max(k1, key));
        k1 = min(k1, key);
      }
    }
    neg |= uint32_t(tv < VT(0)) << j;
  }
  if constexpr (M != kF32) {
    m1 = k1 >> 5;
    amin = k1 & 31;
    m2 = k2 >> 5;
  }
  RowR<M, D> nw;
  nw.sm1 = scale_mag<M>(m1, sc);
  nw.sm2 = scale_mag<M>(m2, sc);
  nw.amin = amin;
  nw.flips = (__popc(neg) & 1) ? neg ^ ((1u << D) - 1u) : neg;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const VT tv = t[j];
    const VT rn = nw.msg(j);
    VT v;
    if constexpr (M == kWire) {
      v = max(-kWirePin, min(kWirePin, tv + rn));      // promotion sum and pin
    } else if constexpr (M == kInt8) {
      v = tv + rn;                                     // int16 range, no clamp
    } else {
      v = __fadd_rn(tv, rn);
    }
    s_l[pos[j]] = static_cast<LT>(v);
  }
  nw.store(rw, rb, zc, z);
}

// One layered sweep over every check row, updating s_l (shared) and the
// compressed R (r_words / r_big, shared or device memory) in place.  A
// barrier follows a row only where s_sync says so: where the next row
// shares a column with a row since the last barrier, and after the last row.
// Between two rows with no column in common no thread touches an element the
// other row's threads touch, and each thread keeps its own lane of R.
template <int M, bool kFirst>
__device__ __forceinline__ void sweep(typename Types<M>::L* s_l, uint32_t* r_words,
                                      uint8_t* r_big, const uint32_t* s_edge,
                                      const uint16_t* s_rs, const uint8_t* s_sync, int rows,
                                      int zc, int z, Scale sc) {
  int big = 0;
  for (int row = 0; row < rows; ++row) {
    const int e0 = s_rs[row], deg = s_rs[row + 1] - e0;
    uint32_t* rw = r_words + size_t(row) * Types<M>::kRowWords * zc;
    uint8_t* rb = r_big + size_t(big) * zc;
    const uint32_t* ed = s_edge + e0;
    if (z < zc) {
      switch (deg) {
#define LDPC_ROW(D) case D: row_update<M, D, kFirst>(s_l, rw, rb, ed, zc, z, sc); break;
        LDPC_ROW(3) LDPC_ROW(4) LDPC_ROW(5) LDPC_ROW(6) LDPC_ROW(7) LDPC_ROW(8)
        LDPC_ROW(9) LDPC_ROW(10) LDPC_ROW(19)
#undef LDPC_ROW
        default: __trap();   // the wrapper admits only these degrees
      }
    }
    big += deg > kSmallDeg;
    if (s_sync[row]) __syncthreads();   // uniform: the next row shares a column
  }
}

// 1 if any check row of this codeblock is violated (block-wide).  Packs the
// hard bits of each column into s_hb ([cols][nw] words, lanes past Zc 0),
// then XORs each row's rotated column vectors one 32-lane word at a time.
template <int M>
__device__ int syndrome_violated(const typename Types<M>::L* s_l, uint32_t* s_hb,
                                 const uint16_t* s_cs, const uint16_t* s_rs, int rows,
                                 int cols, int zc, bool le) {
  const int z = threadIdx.x, lane = z & 31, nw = blockDim.x >> 5;
#pragma unroll 4
  for (int c = 0; c < cols; ++c) {
    const bool bit = z < zc && hard_bit<M>(s_l[c * zc + z], le);
    const uint32_t m = __ballot_sync(0xffffffffu, bit);
    if (lane == 0) s_hb[c * nw + (z >> 5)] = m;
  }
  __syncthreads();
  uint32_t viol = 0;
  for (int task = z; task < rows * nw; task += blockDim.x) {
    const int row = task / nw, w = task - row * nw;
    const int nvalid = min(32, zc - 32 * w);
    uint32_t x = 0;
    for (int e = s_rs[row]; e < s_rs[row + 1]; ++e) {
      const uint32_t cs = s_cs[e];
      const uint32_t* v = s_hb + (cs & 127u) * nw;         // the edge's column
      int p = 32 * w + int(cs >> 7);                       // first lane rotated in
      if (p >= zc) p -= zc;
      const int k = p >> 5;
      uint32_t r = __funnelshift_r(v[k], v[k + 1 < nw ? k + 1 : 0], p & 31);
      const int left = zc - p;                             // lanes before the wrap
      if (left < 32) r = (r & ((1u << left) - 1u)) | (v[0] << left);
      x ^= r;
    }
    viol |= nvalid == 32 ? x : x & ((1u << nvalid) - 1u);
  }
  return __syncthreads_or(viol != 0);
}

// Copy the tables to shared memory: per edge with column c and shift s the
// row update's word (c * zc + s) | (zc - s) << 16 and the syndrome's
// c | s << 7; the row starts as uint16 and the barrier flags as bytes.
// Returns the shared-memory layout.
template <int M>
__device__ Layout load_tables(unsigned char* smem, Tables tb, int rows, int cols, int n_edges,
                              int n_big, int zc, bool r_in_smem) {
  const Layout o = layout<M>(rows, cols, n_edges, n_big, zc, r_in_smem);
  uint32_t* s_edge = reinterpret_cast<uint32_t*>(smem);
  uint16_t* s_cs = reinterpret_cast<uint16_t*>(smem + o.cs);
  uint16_t* s_rs = reinterpret_cast<uint16_t*>(smem + o.rs);
  uint8_t* s_sync = smem + o.sync;
  for (int i = threadIdx.x; i <= rows; i += blockDim.x) {
    s_rs[i] = uint16_t(tb.row_start[i]);
    if (i < rows) s_sync[i] = uint8_t(tb.row_sync[i] != 0);
  }
  for (int i = threadIdx.x; i < n_edges; i += blockDim.x) {
    const uint32_t c = uint32_t(tb.edge_col[i]), sh = uint32_t(tb.edge_shift[i]);
    s_edge[i] = (c * uint32_t(zc) + sh) | (uint32_t(zc) - sh) << 16;
    s_cs[i] = uint16_t(c | sh << 7);
  }
  return o;
}

// L = the load clamp of the codeblock's LLRs; 16-byte loads when `vec`
// (the row is a multiple of 16 bytes at a 16-byte aligned address).
template <int M>
__device__ __forceinline__ void load_llrs(typename Types<M>::L* s_l,
                                          const typename Types<M>::In* src, int n, bool vec) {
  using In = typename Types<M>::In;
  using LT = typename Types<M>::L;
  if (vec) {
    constexpr int kV = 16 / sizeof(In);
    union { uint4 v; In e[kV]; } in;
    union { uint4 v[sizeof(LT) * kV / 16]; LT e[kV]; } out;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(s_l);
#pragma unroll 4
    for (int k = threadIdx.x; k < n / kV; k += blockDim.x) {
      in.v = __ldcs(s4 + k);
#pragma unroll
      for (int i = 0; i < kV; ++i) out.e[i] = load_llr<M>(in.e[i]);
#pragma unroll
      for (int q = 0; q < int(sizeof(out.v) / 16); ++q) d4[k * int(sizeof(out.v) / 16) + q] = out.v[q];
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) s_l[i] = load_llr<M>(src[i]);
  }
}

// Hard bits of the first n entries of L; 16 bytes a store when `vec`.
template <int M>
__device__ __forceinline__ void store_hard(const typename Types<M>::L* s_l, int8_t* dst, int n,
                                           bool vec, bool le) {
  using LT = typename Types<M>::L;
  if (vec) {
    union { uint4 v[sizeof(LT)]; LT e[16]; } in;
    union { uint4 v; int8_t b[16]; } out;
    const uint4* s4 = reinterpret_cast<const uint4*>(s_l);
    for (int k = threadIdx.x; k < n / 16; k += blockDim.x) {
#pragma unroll
      for (int q = 0; q < int(sizeof(LT)); ++q) in.v[q] = s4[k * int(sizeof(LT)) + q];
#pragma unroll
      for (int i = 0; i < 16; ++i) out.b[i] = static_cast<int8_t>(hard_bit<M>(in.e[i], le));
      reinterpret_cast<uint4*>(dst)[k] = out.v;
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      dst[i] = static_cast<int8_t>(hard_bit<M>(s_l[i], le));
  }
}

// Copy n elements between shared and device memory, 16 bytes at a time when
// `vec`.
template <typename T>
__device__ __forceinline__ void copy_elems(T* dst, const T* src, int n, bool vec) {
  if (vec) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
#pragma unroll 4
    for (int k = threadIdx.x; k < int(n * sizeof(T) / 16); k += blockDim.x) d4[k] = s4[k];
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

// Bytes of the state a codeblock keeps for the group exit, in device
// memory: its compressed R (integer modes; the f32 mode's R lives in
// r_state already), then its posterior L.
template <int M>
__host__ __device__ inline size_t keep_bytes(int rows, int cols, int n_big, int zc) {
  const size_t l = align16(size_t(cols) * zc * sizeof(typename Types<M>::L));
  return (M == kF32 ? 0 : r_bytes<M>(rows, n_big, zc)) + l;
}

// Copy a codeblock's state between shared memory (L at s_l, R at s_r in
// the integer modes) and its slot `k` of the keep scratch; to_keep picks
// the direction.  Whole 16-byte words where L's bytes allow.
template <int M>
__device__ __forceinline__ void move_state(unsigned char* k, typename Types<M>::L* s_l,
                                           unsigned char* s_r, int rows, int cols, int n_big,
                                           int zc, bool to_keep) {
  using LT = typename Types<M>::L;
  size_t off = 0;
  if constexpr (M != kF32) {
    const int words = int(r_bytes<M>(rows, n_big, zc) / 16);
    uint4* kr = reinterpret_cast<uint4*>(k);
    uint4* sr = reinterpret_cast<uint4*>(s_r);
    if (to_keep) copy_elems(kr, sr, words, false);
    else copy_elems(sr, kr, words, false);
    off = r_bytes<M>(rows, n_big, zc);
  }
  const int n = cols * zc;
  const bool vec = n * sizeof(LT) % 16 == 0;
  LT* kl = reinterpret_cast<LT*>(k + off);
  if (to_keep) copy_elems(kl, s_l, n, vec);
  else copy_elems(s_l, kl, n, vec);
}

// The group exit's bookkeeping in device memory, zeroed by the caller:
// target[g] the sweeps group g runs at least (the largest own exit of its
// codeblocks), missed[round][g] 1 where a codeblock of g misses parity after
// target[g] + round sweeps.
struct GroupExit {
  int32_t* target;          // null: no group exit follows
  int32_t* missed;
  unsigned char* keep;      // keep_bytes<M> per codeblock
  int group;                // codeblocks per group
};

// Decode codeblock `cb` in the calling CTA, whose tables load_tables has put
// in shared memory (layout o): load its LLRs, run up to num_iters sweeps
// (with early_stop, until its own syndrome is zero), store its hard bits, ok
// and sweep count, and add the sweeps to *executed.  When a group exit
// follows (ge.target), the codeblock posts its own exit to its group's
// target, sweeps on in shared memory while the target it reads is higher,
// and keeps its state if it stopped before num_iters.
template <int M>
__device__ void decode_codeblock(int cb, unsigned char* smem, const Layout& o,
                                 const typename Types<M>::In* __restrict__ llr,
                                 int8_t* __restrict__ hard, uint8_t* __restrict__ ok_out,
                                 int32_t* __restrict__ sweeps_out,
                                 unsigned char* __restrict__ r_state, GroupExit ge,
                                 unsigned long long* executed, int rows, int cols,
                                 int kb, int n_big, int zc, int num_iters, Scale sc,
                                 int early_stop, int hard_le, int vec_in, int vec_out) {
  using LT = typename Types<M>::L;
  const int z = threadIdx.x;
  const uint32_t* s_edge = reinterpret_cast<const uint32_t*>(smem);
  const uint16_t* s_cs = reinterpret_cast<const uint16_t*>(smem + o.cs);
  const uint16_t* s_rs = reinterpret_cast<const uint16_t*>(smem + o.rs);
  const uint8_t* s_sync = smem + o.sync;
  uint32_t* s_hb = reinterpret_cast<uint32_t*>(smem + o.hb);
  LT* s_l = reinterpret_cast<LT*>(smem + o.l);
  unsigned char* r;
  if constexpr (M == kF32) r = r_state + size_t(cb) * r_bytes<M>(rows, n_big, zc);
  else r = smem + o.r;
  uint32_t* r_words = reinterpret_cast<uint32_t*>(r);
  uint8_t* r_big = r + size_t(rows) * zc * sizeof(uint32_t);
  load_llrs<M>(s_l, llr + size_t(cb) * cols * zc, cols * zc, vec_in);
  __syncthreads();

  int it = 0;
  int violated = 1;
  for (; it < num_iters; ++it) {
    if (it == 0) sweep<M, true>(s_l, r_words, r_big, s_edge, s_rs, s_sync, rows, zc, z, sc);
    else sweep<M, false>(s_l, r_words, r_big, s_edge, s_rs, s_sync, rows, zc, z, sc);
    if (early_stop) {
      violated = syndrome_violated<M>(s_l, s_hb, s_cs, s_rs, rows, cols, zc, hard_le);
      if (!violated) { ++it; break; }
    }
  }
  if (!early_stop || it == 0)
    violated = syndrome_violated<M>(s_l, s_hb, s_cs, s_rs, rows, cols, zc, hard_le);

  if (ge.target != nullptr) {
    // Every codeblock of the group runs at least the largest exit posted
    // so far: sweep on to it here instead of resuming from kept state.
    int* t = ge.target + cb / ge.group;
    int* s_target = reinterpret_cast<int*>(smem + o.tgt);
    bool moved = false;
    for (;;) {
      if (z == 0) *s_target = max(atomicMax(t, it), it);
      __syncthreads();
      const int m = *s_target;
      if (m <= it) break;   // uniform
      // Each sweep ends in a barrier: every thread has read s_target
      // before thread 0 writes it again.
      for (; it < m; ++it)
        sweep<M, false>(s_l, r_words, r_big, s_edge, s_rs, s_sync, rows, zc, z, sc);
      moved = true;
    }
    if (moved) violated = syndrome_violated<M>(s_l, s_hb, s_cs, s_rs, rows, cols, zc, hard_le);
    if (it < num_iters)
      move_state<M>(ge.keep + size_t(cb) * keep_bytes<M>(rows, cols, n_big, zc), s_l,
                    smem + o.r, rows, cols, n_big, zc, true);
  }

  store_hard<M>(s_l, hard + size_t(cb) * kb * zc, kb * zc, vec_out, hard_le);
  if (z == 0) {
    ok_out[cb] = violated ? 0 : 1;
    sweeps_out[cb] = it;
    if (executed != nullptr) atomicAdd(executed, static_cast<unsigned long long>(it));
  }
}

// Fused path: every sweep of one codeblock in one launch.
template <int M>
__global__ void __launch_bounds__(kMaxZc, 2)
layered_kernel(const typename Types<M>::In* __restrict__ llr,
               int8_t* __restrict__ hard, uint8_t* __restrict__ ok_out,
               int32_t* __restrict__ sweeps_out, unsigned char* __restrict__ r_state,
               GroupExit ge, unsigned long long* executed,
               Tables tb, int rows, int cols, int kb, int n_edges, int n_big, int zc,
               int num_iters,
               Scale sc, int early_stop, int hard_le, int vec_in, int vec_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout o = load_tables<M>(smem, tb, rows, cols, n_edges, n_big, zc, M != kF32);
  decode_codeblock<M>(blockIdx.x, smem, o, llr, hard, ok_out, sweeps_out, r_state, ge,
                      executed, rows, cols, kb, n_big, zc, num_iters, sc, early_stop,
                      hard_le, vec_in, vec_out);
}

// One round of the group exit, after the fused path (modes 0 and 1).  The
// batch rule runs every codeblock of a group for s* sweeps, the first n at
// which all of them meet parity, or num_iters.  A codeblock's sweeps do not
// depend on the others, so s* >= target[g], the largest own exit of the
// group's codeblocks (num_iters where one missed parity: it ran them all).
// Round 0 brings every codeblock of group g to target[g] sweeps, resuming
// from its kept state; round r > 0 runs one more sweep on every codeblock
// of a group in which one missed parity in round r - 1.  A CTA with nothing
// to do returns at once.  The kept state is written back only where
// another round can follow (target below num_iters).  Every codeblock thus
// runs exactly its group's s* sweeps, none of them twice.
template <int M>
__global__ void __launch_bounds__(kMaxZc, 2)
resume_kernel(int8_t* __restrict__ hard, uint8_t* __restrict__ ok_out,
              int32_t* __restrict__ sweeps_out, unsigned char* __restrict__ r_state,
              GroupExit ge, unsigned long long* executed, Tables tb, int round, int rows,
              int cols, int kb, int n_edges, int n_big, int zc, int num_iters, Scale sc,
              int hard_le, int vec_out) {
  using LT = typename Types<M>::L;
  const int cb = blockIdx.x, g = cb / ge.group;
  const int n_groups = (int(gridDim.x) + ge.group - 1) / ge.group;
  const int t = ge.target[g] + round;
  if (t > num_iters || (round > 0 && ge.missed[(round - 1) * n_groups + g] == 0)) return;
  const int done = sweeps_out[cb];
  int violated;
  if (done >= t) {
    violated = !ok_out[cb];   // round 0: reached its group's target in the fused path
  } else {
    extern __shared__ __align__(16) unsigned char smem[];
    const int z = threadIdx.x;
    const Layout o = load_tables<M>(smem, tb, rows, cols, n_edges, n_big, zc, M != kF32);
    const uint32_t* s_edge = reinterpret_cast<const uint32_t*>(smem);
    const uint16_t* s_cs = reinterpret_cast<const uint16_t*>(smem + o.cs);
    const uint16_t* s_rs = reinterpret_cast<const uint16_t*>(smem + o.rs);
    const uint8_t* s_sync = smem + o.sync;
    uint32_t* s_hb = reinterpret_cast<uint32_t*>(smem + o.hb);
    LT* s_l = reinterpret_cast<LT*>(smem + o.l);
    unsigned char* r;
    if constexpr (M == kF32) r = r_state + size_t(cb) * r_bytes<M>(rows, n_big, zc);
    else r = smem + o.r;
    uint32_t* r_words = reinterpret_cast<uint32_t*>(r);
    uint8_t* r_big = r + size_t(rows) * zc * sizeof(uint32_t);
    unsigned char* k = ge.keep + size_t(cb) * keep_bytes<M>(rows, cols, n_big, zc);
    move_state<M>(k, s_l, smem + o.r, rows, cols, n_big, zc, false);
    __syncthreads();
    for (int it = done; it < t; ++it)
      sweep<M, false>(s_l, r_words, r_big, s_edge, s_rs, s_sync, rows, zc, z, sc);
    violated = syndrome_violated<M>(s_l, s_hb, s_cs, s_rs, rows, cols, zc, hard_le);
    if (t < num_iters) move_state<M>(k, s_l, smem + o.r, rows, cols, n_big, zc, true);
    store_hard<M>(s_l, hard + size_t(cb) * kb * zc, kb * zc, vec_out, hard_le);
    if (z == 0) {
      ok_out[cb] = violated ? 0 : 1;
      sweeps_out[cb] = t;
      if (executed != nullptr) atomicAdd(executed, static_cast<unsigned long long>(t - done));
    }
  }
  if (violated && t < num_iters && threadIdx.x == 0)
    ge.missed[round * n_groups + g] = 1;   // every writer stores 1
}

// K2's tiled path: sweep number `it` of every codeblock whose tile has not
// met parity yet.  L (B, cols*zc) int16 and compressed R (B, r_bytes)
// persist in device memory.  viol (num_iters, n_tiles) int32 is zero before
// the first launch.
__global__ void __launch_bounds__(kMaxZc, 2)
int8_tiled_sweep_kernel(const int8_t* __restrict__ llr, int16_t* __restrict__ l_state,
                        unsigned char* __restrict__ r_state, int32_t* __restrict__ viol,
                        int8_t* __restrict__ hard, uint8_t* __restrict__ ok_out,
                        int32_t* __restrict__ sweeps_out, Tables tb,
                        int rows, int cols, int kb, int n_edges, int n_big, int zc, int it,
                        int b_tile, int n_tiles, int vec_in, int vec_state, int vec_out) {
  const int tile = blockIdx.x / b_tile;
  if (it > 0 && viol[(it - 1) * n_tiles + tile] == 0) return;   // tile done

  extern __shared__ __align__(16) unsigned char smem[];
  const int z = threadIdx.x;
  const Layout o = load_tables<kInt8>(smem, tb, rows, cols, n_edges, n_big, zc, false);
  const uint32_t* s_edge = reinterpret_cast<const uint32_t*>(smem);
  const uint16_t* s_cs = reinterpret_cast<const uint16_t*>(smem + o.cs);
  const uint16_t* s_rs = reinterpret_cast<const uint16_t*>(smem + o.rs);
  const uint8_t* s_sync = smem + o.sync;
  uint32_t* s_hb = reinterpret_cast<uint32_t*>(smem + o.hb);
  int16_t* s_l = reinterpret_cast<int16_t*>(smem + o.l);
  unsigned char* r = r_state + size_t(blockIdx.x) * r_bytes<kInt8>(rows, n_big, zc);
  const int n = cols * zc;
  int16_t* gl = l_state + size_t(blockIdx.x) * n;
  if (it == 0) load_llrs<kInt8>(s_l, llr + size_t(blockIdx.x) * n, n, vec_in);
  else copy_elems(s_l, gl, n, vec_state);
  __syncthreads();

  uint32_t* r_words = reinterpret_cast<uint32_t*>(r);
  uint8_t* r_big = r + size_t(rows) * zc * sizeof(uint32_t);
  if (it == 0) sweep<kInt8, true>(s_l, r_words, r_big, s_edge, s_rs, s_sync, rows, zc, z, {});
  else sweep<kInt8, false>(s_l, r_words, r_big, s_edge, s_rs, s_sync, rows, zc, z, {});
  copy_elems(gl, s_l, n, vec_state);
  const int violated = syndrome_violated<kInt8>(s_l, s_hb, s_cs, s_rs, rows, cols, zc, false);

  store_hard<kInt8>(s_l, hard + size_t(blockIdx.x) * kb * zc, kb * zc, vec_out, false);
  if (z == 0) {
    if (violated) viol[it * n_tiles + tile] = 1;   // every writer stores 1
    ok_out[blockIdx.x] = violated ? 0 : 1;
    sweeps_out[blockIdx.x] = it + 1;
  }
}

// Let `kernel` ask for all the dynamic shared memory a block may have, and
// prefer shared memory over L1, once per device (the attributes belong to
// the function, not to a launch).  Tag tells the kernels apart.
template <int Tag>
cudaError_t allow_max_smem(const void* kernel) {
  static std::once_flag once[kMaxDevices];
  static cudaError_t err[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [&] {
    int optin = 0;
    err[dev] = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err[dev] == cudaSuccess)
      err[dev] = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err[dev] == cudaSuccess)
      err[dev] = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                      int(cudaSharedmemCarveoutMaxShared));
  });
  return err[dev];
}

constexpr int kTiledTag = 3;
constexpr int kResumeTag = 4;   // + M: the group exit's resume kernels

inline int threads_for(int zc) { return 32 * ((zc + 31) / 32); }

inline bool aligned16(const void* p, size_t row_bytes) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && row_bytes % 16 == 0;
}

// The arguments the fused and the resume launches share.
struct Launch {
  int8_t* hard;
  uint8_t* ok;
  int32_t* sweeps;
  unsigned char* r_state;
  GroupExit ge;
  unsigned long long* executed;
  Tables tb;
  int batch, rows, cols, kb, n_edges, n_big, zc, num_iters;
  Scale sc;
  int hard_le;
  cudaStream_t stream;
};

// Round `round` of the group exit (resume_kernel<M>), one CTA per codeblock.
template <int M>
int resume(const Launch& a, int round) {
  const size_t smem = layout<M>(a.rows, a.cols, a.n_edges, a.n_big, a.zc, M != kF32).total;
  cudaError_t err = allow_max_smem<kResumeTag + M>(reinterpret_cast<const void*>(resume_kernel<M>));
  if (err != cudaSuccess) return int(err);
  resume_kernel<M><<<a.batch, threads_for(a.zc), smem, a.stream>>>(
      a.hard, a.ok, a.sweeps, a.r_state, a.ge, a.executed, a.tb, round, a.rows, a.cols, a.kb,
      a.n_edges, a.n_big, a.zc, a.num_iters, a.sc, a.hard_le,
      int(aligned16(a.hard, size_t(a.kb) * a.zc)));
  return int(cudaGetLastError());
}

// The fused path, then (with a group exit) `rounds` rounds of resume_kernel.
template <int M>
int launch(const Launch& a, const void* llr, int exit_group, int rounds) {
  using In = typename Types<M>::In;
  const size_t smem = layout<M>(a.rows, a.cols, a.n_edges, a.n_big, a.zc, M != kF32).total;
  cudaError_t err = allow_max_smem<M>(reinterpret_cast<const void*>(layered_kernel<M>));
  if (err != cudaSuccess) return int(err);
  layered_kernel<M><<<a.batch, threads_for(a.zc), smem, a.stream>>>(
      static_cast<const In*>(llr), a.hard, a.ok, a.sweeps, a.r_state, a.ge, a.executed, a.tb,
      a.rows, a.cols, a.kb, a.n_edges, a.n_big, a.zc, a.num_iters, a.sc, exit_group != 0,
      a.hard_le, int(aligned16(llr, size_t(a.cols) * a.zc * sizeof(In))),
      int(aligned16(a.hard, size_t(a.kb) * a.zc)));
  err = cudaGetLastError();
  if constexpr (M != kInt8) {
    for (int round = 0; err == cudaSuccess && a.ge.target != nullptr && round < rounds; ++round)
      err = cudaError_t(resume<M>(a, round));
  }
  return int(err);
}

template <int M>
int blocks_per_sm(int rows, int cols, int n_edges, int n_big, int zc) {
  cudaError_t err = allow_max_smem<M>(reinterpret_cast<const void*>(layered_kernel<M>));
  if (err != cudaSuccess) return -int(err);
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, layered_kernel<M>, threads_for(zc),
      layout<M>(rows, cols, n_edges, n_big, zc, M != kF32).total);
  return err == cudaSuccess ? n : -int(err);
}

}  // namespace

extern "C" {

// Shared memory one CTA of the fused path needs (bytes); mode 0 f32, 1 wire,
// 2 int8.  n_big: rows of degree > 11.
size_t ldpc_layered_smem_bytes(int mode, int rows, int cols, int n_edges, int n_big, int zc) {
  switch (mode) {
    case kF32: return layout<kF32>(rows, cols, n_edges, n_big, zc, false).total;
    case kWire: return layout<kWire>(rows, cols, n_edges, n_big, zc, true).total;
    default: return layout<kInt8>(rows, cols, n_edges, n_big, zc, true).total;
  }
}

// Bytes of compressed R per codeblock that the caller allocates in device
// memory: the f32 fused path's r_state and the int8 tiled path's r_state.
size_t ldpc_layered_state_bytes(int mode, int rows, int n_big, int zc) {
  return mode == kF32 ? r_bytes<kF32>(rows, n_big, zc) : r_bytes<kInt8>(rows, n_big, zc);
}

// CTAs of the fused path resident per SM (negative: a CUDA error).
int ldpc_layered_blocks_per_sm(int mode, int rows, int cols, int n_edges, int n_big, int zc) {
  switch (mode) {
    case kF32: return blocks_per_sm<kF32>(rows, cols, n_edges, n_big, zc);
    case kWire: return blocks_per_sm<kWire>(rows, cols, n_edges, n_big, zc);
    default: return blocks_per_sm<kInt8>(rows, cols, n_edges, n_big, zc);
  }
}

// Bytes of kept state per codeblock that the caller allocates for the group
// exit (keep_bytes: the integer modes' compressed R, then L).
size_t ldpc_layered_keep_bytes(int mode, int rows, int cols, int n_big, int zc) {
  return mode == kF32 ? keep_bytes<kF32>(rows, cols, n_big, zc)
                      : keep_bytes<kWire>(rows, cols, n_big, zc);
}

// Fused path: decode `batch` codeblocks of (cols * zc) LLRs laid out
// row-major, all sweeps in one launch.  exit_group: 0 runs num_iters sweeps,
// >= 1 stops each codeblock at its own zero syndrome.  With ctrl (modes 0
// and 1) every group of exit_group consecutive codeblocks stops together,
// the batch rule: every codeblock of a group runs the sweeps after which all
// of them first meet parity (or num_iters).  The fused launch posts each
// codeblock's own exit to its group's target and keeps the state of those
// that stop early in `keep` (batch * ldpc_layered_keep_bytes); `rounds`
// launches of the resume kernel follow (num_iters gives the rule; 0 leaves
// the rounds to ldpc_layered_resume, as a caller that reduces ctrl over
// several ranks between them does).  ctrl: ceil(batch / exit_group) *
// (num_iters + 1) int32 zeroed by the caller: the targets, then per round
// the groups that missed parity.
// mode 0 (f32): llr float32, r_state holds batch * ldpc_layered_state_bytes.
// mode 1 (wire) / 2 (int8): llr int8, r_state unused (may be null).
// executed (may be null): a uint64 to which every launch adds the sweeps it
// ran.
// Tables (device memory, int32): row_start (rows + 1), row_sync (rows; 1 =
// a barrier after the row: the next row shares a column with a row since the
// last barrier, or it is the last row), edge_col and edge_shift (E, row-major,
// columns ascending).  Row degrees must be in {3..10, 19}.
// hard_le: 1 gives the f32 mode the hard rule L <= 0 (else L < 0); the wire
// mode is always L <= 0 and the int8 mode L < 0.
// Outputs: hard (batch, kb * zc) int8, ok (batch,) uint8, sweeps (batch,) int32.
// Returns cudaGetLastError() after the launches (0 = launched).
int ldpc_layered_decode(const void* llr, int mode, int8_t* hard, uint8_t* ok,
                        int32_t* sweeps, void* r_state, void* keep, int32_t* ctrl,
                        unsigned long long* executed, const int32_t* row_start,
                        const int32_t* row_sync, const int32_t* edge_col,
                        const int32_t* edge_shift, int batch,
                        int rows, int cols, int kb, int n_edges, int n_big, int zc,
                        int num_iters, float scale, int scale16, int exit_group,
                        int hard_le, int rounds, void* stream) {
  if (batch == 0) return 0;
  if (zc < 1 || zc > kMaxZc || exit_group < 0 ||
      (ctrl != nullptr && (exit_group < 1 || keep == nullptr || mode == kInt8)))
    return int(cudaErrorInvalidValue);
  const int n_groups = ctrl == nullptr ? 0 : (batch + exit_group - 1) / exit_group;
  const Launch a{hard, ok, sweeps, static_cast<unsigned char*>(r_state),
                 {ctrl, ctrl == nullptr ? nullptr : ctrl + n_groups,
                  static_cast<unsigned char*>(keep), exit_group},
                 executed, {row_start, row_sync, edge_col, edge_shift},
                 batch, rows, cols, kb, n_edges, n_big, zc, num_iters, {scale, scale16},
                 hard_le, static_cast<cudaStream_t>(stream)};
  switch (mode) {
    case kF32: return launch<kF32>(a, llr, exit_group, rounds);
    case kWire: return launch<kWire>(a, llr, exit_group, rounds);
    case kInt8: return launch<kInt8>(a, llr, exit_group, rounds);
    default: return int(cudaErrorInvalidValue);
  }
}

// Round `round` of the group exit after ldpc_layered_decode(..., rounds=0)
// with the same arguments (ctrl's targets and earlier rounds' flags as the
// caller left them).  Modes 0 and 1.
int ldpc_layered_resume(int mode, int8_t* hard, uint8_t* ok, int32_t* sweeps, void* r_state,
                        void* keep, int32_t* ctrl, unsigned long long* executed,
                        const int32_t* row_start, const int32_t* row_sync,
                        const int32_t* edge_col, const int32_t* edge_shift, int batch,
                        int rows, int cols, int kb, int n_edges, int n_big, int zc,
                        int num_iters, float scale, int scale16, int exit_group,
                        int hard_le, int round, void* stream) {
  if (batch == 0) return 0;
  if (zc < 1 || zc > kMaxZc || exit_group < 1 || ctrl == nullptr || keep == nullptr ||
      round < 0 || round >= num_iters)
    return int(cudaErrorInvalidValue);
  const int n_groups = (batch + exit_group - 1) / exit_group;
  const Launch a{hard, ok, sweeps, static_cast<unsigned char*>(r_state),
                 {ctrl, ctrl + n_groups, static_cast<unsigned char*>(keep), exit_group},
                 executed, {row_start, row_sync, edge_col, edge_shift},
                 batch, rows, cols, kb, n_edges, n_big, zc, num_iters, {scale, scale16},
                 hard_le, static_cast<cudaStream_t>(stream)};
  switch (mode) {
    case kF32: return resume<kF32>(a, round);
    case kWire: return resume<kWire>(a, round);
    default: return int(cudaErrorInvalidValue);
  }
}

// K2's tiled path: one launch per sweep, tiles of b_tile consecutive
// codeblocks stop together once all of them meet parity (batch % b_tile ==
// 0).  llr: int8; l_state: batch * cols * zc int16; r_state: batch *
// ldpc_layered_state_bytes(2, ...) bytes; viol: num_iters * (batch / b_tile)
// int32, zeroed by the caller.  Tables and outputs as ldpc_layered_decode.
int ldpc_int8_decode_tiled(const int8_t* llr, int16_t* l_state, void* r_state,
                           int32_t* viol, int8_t* hard, uint8_t* ok, int32_t* sweeps,
                           const int32_t* row_start, const int32_t* row_sync,
                           const int32_t* edge_col, const int32_t* edge_shift, int batch, int rows, int cols, int kb,
                           int n_edges, int n_big, int zc, int num_iters, int b_tile,
                           void* stream) {
  if (batch == 0) return 0;
  if (b_tile <= 0 || batch % b_tile != 0 || zc < 1 || zc > kMaxZc)
    return int(cudaErrorInvalidValue);
  const size_t smem = layout<kInt8>(rows, cols, n_edges, n_big, zc, false).total;
  cudaError_t err =
      allow_max_smem<kTiledTag>(reinterpret_cast<const void*>(int8_tiled_sweep_kernel));
  if (err != cudaSuccess) return int(err);
  const int n_tiles = batch / b_tile;
  const int vec_in = aligned16(llr, size_t(cols) * zc);
  const int vec_out = aligned16(hard, size_t(kb) * zc);
  const int vec_state = aligned16(l_state, size_t(cols) * zc * sizeof(int16_t));
  const Tables tb{row_start, row_sync, edge_col, edge_shift};
  for (int it = 0; it < num_iters; ++it) {
    int8_tiled_sweep_kernel<<<batch, threads_for(zc), smem, static_cast<cudaStream_t>(stream)>>>(
        llr, l_state, static_cast<unsigned char*>(r_state), viol, hard, ok, sweeps, tb, rows,
        cols, kb, n_edges, n_big, zc, it, b_tile, n_tiles, vec_in, vec_state, vec_out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  return 0;
}

}  // extern "C"
