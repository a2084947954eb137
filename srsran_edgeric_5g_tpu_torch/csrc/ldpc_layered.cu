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
//    R = (sgn*st) * (mag*scale), L = t + R, hard bit post < 0.  Every multiply
//    and add is rounded separately (__fmul_rn / __fadd_rn, and the library is
//    built with --fmad=false), so the result is bit-equal to the plain
//    PyTorch version.
//  * kWire (1): the semantics of the reference's layered_wire schedule
//    (srsran_edgeric_5g_tpu/ops/ldpc/decoder.py:212-273 with
//    _minsum(scale_floor=True)), which the main path's decode("wire_auto")
//    computes: ±64 load clamp, ±120 v2c saturation with frozen (|L| > 120)
//    posteriors passing through, min trackers capped at 120, truncating scale
//    (mag * floor(0.8 * 2^16)) >> 16 with magnitudes > 120 passed through,
//    the promotion sum pinning at ±127 with its infinite-addend rules, hard
//    bit L <= 0.  All values are integers, so it runs in int32 arithmetic.
//  * kInt8 (2): K2's fixed-point arithmetic — int8 input (the wrapper rounds
//    and clips to ±127), no load clamp; int32 t = L - R, running minima with
//    the second minimum starting at 1 << 20, mag = (mag * 13) >> 4,
//    R = clip(sgn*st*mag, ±120) stored int8, L = t + R stored int16 and never
//    clamped, hard bit L < 0.
//
// Design.  One CTA decodes one codeblock; thread z owns lane z of the Zc
// lifting dimension (blockDim.x == Zc).  The posterior L (cols x Zc) lives in
// shared memory during a sweep.  The lifted cyclic shift by s of the TPU
// kernel's lane roll becomes thread z reading L[c][(z + s) % Zc] and writing
// its update back to the same element: inside one check row every edge has a
// different column and (z + s) % Zc is a permutation of the lanes, so no two
// threads touch one element; a __syncthreads() separates rows.
//   R (one message per edge and lane):
//  * wire / int8: |R| <= 120, so R is int8 in shared memory (E x Zc bytes)
//    beside an int16 L — 101 KB at BG1 Zc=224, 173.6 KB at the largest
//    Zc=384;
//  * f32: E x Zc x 4 bytes is 283 KB at BG1 Zc=224, above the 227 KB a CTA can
//    have, so R lives in a device-memory scratch of (B, E, Zc) floats that the
//    wrapper allocates; thread z reads and writes only its own lane, so the
//    accesses of a warp are coalesced and most stay in L2.
// The edge table (row starts, columns, shifts; row-major, columns ascending
// within a row as in the reference's edge list) is copied to shared memory.
// Within a row the t values and gather positions stay in registers (rows
// have at most kMaxDeg = 19 edges; the loops are unrolled and predicated).
// The first-minimum slot is the lowest-index argmin; on a tie m2 == m1, so
// the Pallas kernels' "a == m1 -> m2" rule gives the same messages.
//
// Early exit.  The Pallas kernels stop a whole tile of b_tile codeblocks once
// every codeword of the tile meets parity (after at least one sweep).
//  * Fused path (ldpc_layered_decode): all sweeps in one launch, each CTA
//    decides for itself — the tile exit for b_tile == 1, and with
//    early_stop == 0 the fixed-sweep decode for any b_tile.  After each sweep
//    the CTA evaluates the syndrome of its hard bits (XOR over each check row
//    of the rotated bits, __syncthreads_or over lanes); the same syndrome
//    gives the `ok` output.
//  * Tiled path (ldpc_int8_decode_tiled, K2 with early stop and b_tile > 1):
//    the CTAs of a tile are not guaranteed to be resident together, so they
//    cannot wait for each other.
//    One launch runs one sweep: L and R live in device memory between
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
// bound by operations (and, in this simple design, by the latency of the
// shared-memory gathers and the 46 barriers per sweep) — not by bytes.  The
// tiled path adds the L and R round trip through device memory per sweep.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kF32 = 0, kWire = 1, kInt8 = 2;

constexpr int kMaxDeg = 19;     // largest check-row degree (BG1; BG2: 10)
constexpr int kMaxZc = 384;     // largest lifting size
constexpr int kWireLoad = 64;   // soft_bits_clamp at load
constexpr int kWireMax = 120;   // LLR_MAX
constexpr int kWireInf = 127;   // LLR_INFTY: a fixed bit
constexpr int kInt8Clamp = 120; // decoder_pallas.LLR_CLAMP

template <int M> struct Types;
// In: input element, L/R: stored posterior/message, V: arithmetic type,
// kBig: initial second minimum (above any tracked magnitude).
template <> struct Types<kF32> {
  using In = float; using L = float; using R = float; using V = float;
  static constexpr float kBig = 1e30f;
};
template <> struct Types<kWire> {
  using In = int8_t; using L = int16_t; using R = int8_t; using V = int;
  static constexpr int kBig = 1 << 30;
};
template <> struct Types<kInt8> {
  using In = int8_t; using L = int16_t; using R = int8_t; using V = int;
  static constexpr int kBig = 1 << 20;
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

__host__ __device__ inline size_t table_bytes(int rows, int n_edges) {
  return align16(size_t(rows + 1 + 2 * n_edges) * sizeof(int32_t));
}

// Shared memory of one CTA: the edge table, L, and (fused integer modes) R.
template <int M>
__host__ __device__ inline size_t smem_bytes(int rows, int cols, int n_edges, int zc,
                                             bool r_in_smem) {
  size_t bytes = table_bytes(rows, n_edges) +
                 align16(size_t(cols) * zc * sizeof(typename Types<M>::L));
  if (r_in_smem) bytes += align16(size_t(n_edges) * zc * sizeof(typename Types<M>::R));
  return bytes;
}

template <int M>
__device__ __forceinline__ int hard_bit(typename Types<M>::L v) {
  if constexpr (M == kWire) return v <= 0;
  else return v < 0;
}

template <int M>
__device__ __forceinline__ typename Types<M>::L load_llr(typename Types<M>::In x) {
  if constexpr (M == kWire) return static_cast<int16_t>(max(-kWireLoad, min(kWireLoad, int(x))));
  else return static_cast<typename Types<M>::L>(x);
}

// 1 if any check row of this codeblock is violated (block-wide).
template <int M>
__device__ int syndrome_violated(const typename Types<M>::L* s_l, const int32_t* s_rs,
                                 const int32_t* s_col, const int32_t* s_shift,
                                 int rows, int zc, int z) {
  int viol = 0;
  for (int row = 0; row < rows; ++row) {
    int par = 0;
    for (int e = s_rs[row]; e < s_rs[row + 1]; ++e) {
      int p = z + s_shift[e];
      if (p >= zc) p -= zc;
      par ^= hard_bit<M>(s_l[s_col[e] * zc + p]);
    }
    viol |= par;
  }
  return __syncthreads_or(viol);
}

// One layered sweep over every check row, updating s_l (shared) and r_msg
// (shared or device memory, indexed [edge * zc + lane]) in place.  `first`:
// R == 0 before the first sweep, so it is not read.
template <int M>
__device__ void sweep(typename Types<M>::L* s_l, typename Types<M>::R* r_msg,
                      const int32_t* s_rs, const int32_t* s_col, const int32_t* s_shift,
                      int rows, int zc, int z, bool first, float scale, int scale16) {
  using LT = typename Types<M>::L;
  using RT = typename Types<M>::R;
  using VT = typename Types<M>::V;
  for (int row = 0; row < rows; ++row) {
    const int e0 = s_rs[row];
    const int deg = s_rs[row + 1] - e0;
    int pos[kMaxDeg];
    VT t[kMaxDeg];
    VT m1 = 0, m2 = 0;
    int amin = 0, neg = 0;
#pragma unroll
    for (int j = 0; j < kMaxDeg; ++j) {
      if (j < deg) {
        const int e = e0 + j;
        int p = z + s_shift[e];
        if (p >= zc) p -= zc;
        pos[j] = s_col[e] * zc + p;
        const VT lg = s_l[pos[j]];
        const VT rold = first ? VT(0) : VT(r_msg[size_t(e) * zc + z]);
        VT tv, a;
        if constexpr (M == kWire) {
          tv = max(-kWireMax, min(kWireMax, lg - rold));   // v2c saturation
          if (abs(lg) > kWireMax) tv = lg;                 // frozen posterior
          a = min(abs(tv), kWireMax);                      // tracker cap
        } else if constexpr (M == kInt8) {
          tv = lg - rold;
          a = abs(tv);
        } else {
          tv = __fsub_rn(lg, rold);
          a = fabsf(tv);
        }
        t[j] = tv;
        if (j == 0) { m1 = a; m2 = Types<M>::kBig; }
        else if (a < m1) { m2 = m1; m1 = a; amin = j; }
        else if (a < m2) { m2 = a; }
        neg ^= tv < VT(0);
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxDeg; ++j) {
      if (j < deg) {
        const int e = e0 + j;
        const VT tv = t[j];
        const VT mag = j == amin ? m2 : m1;
        const bool flip = (neg ^ (tv < VT(0))) != 0;
        VT rn, v;
        if constexpr (M == kWire) {
          const int sm = mag > kWireMax ? mag : (mag * scale16) >> 16;
          rn = flip ? -sm : sm;
          v = tv + rn;
          v = v > kWireMax ? kWireInf : (v < -kWireMax ? -kWireInf : v);
          const bool tp = tv > kWireMax, tn = tv < -kWireMax;
          const bool rp = rn > kWireMax, rneg = rn < -kWireMax;
          if ((tp && !rneg) || (rp && !tn)) v = kWireInf;
          if ((tn && !rp) || (rneg && !tp)) v = -kWireInf;
        } else if constexpr (M == kInt8) {
          const int sm = (mag * 13) >> 4;                  // x 0.8125
          rn = max(-kInt8Clamp, min(kInt8Clamp, flip ? -sm : sm));
          v = tv + rn;                                     // int16 range, no clamp
        } else {
          const float sm = __fmul_rn(mag, scale);
          rn = flip ? -sm : sm;
          v = __fadd_rn(tv, rn);
        }
        s_l[pos[j]] = static_cast<LT>(v);
        r_msg[size_t(e) * zc + z] = static_cast<RT>(rn);
      }
    }
    __syncthreads();
  }
}

// Copy the edge table to shared memory; returns the L array behind it.
template <int M>
__device__ typename Types<M>::L* load_tables(unsigned char* smem, const int32_t* row_start,
                                             const int32_t* edge_col,
                                             const int32_t* edge_shift, int rows,
                                             int n_edges, int z, int32_t** s_rs,
                                             int32_t** s_col, int32_t** s_shift) {
  *s_rs = reinterpret_cast<int32_t*>(smem);
  *s_col = *s_rs + rows + 1;
  *s_shift = *s_col + n_edges;
  for (int i = z; i <= rows; i += blockDim.x) (*s_rs)[i] = row_start[i];
  for (int i = z; i < n_edges; i += blockDim.x) {
    (*s_col)[i] = edge_col[i];
    (*s_shift)[i] = edge_shift[i];
  }
  return reinterpret_cast<typename Types<M>::L*>(smem + table_bytes(rows, n_edges));
}

template <int M>
__device__ void write_hard(const typename Types<M>::L* s_l, int8_t* hard, int kb, int zc,
                           int z) {
  int8_t* dst = hard + size_t(blockIdx.x) * kb * zc;
  for (int c = 0; c < kb; ++c) dst[c * zc + z] = static_cast<int8_t>(hard_bit<M>(s_l[c * zc + z]));
}

// Fused path: every sweep of one codeblock in one launch.
template <int M>
__global__ void __launch_bounds__(kMaxZc)
layered_kernel(const typename Types<M>::In* __restrict__ llr,
               int8_t* __restrict__ hard, uint8_t* __restrict__ ok_out,
               int32_t* __restrict__ sweeps_out, float* __restrict__ r_scratch,
               const int32_t* __restrict__ row_start,
               const int32_t* __restrict__ edge_col,
               const int32_t* __restrict__ edge_shift,
               int rows, int cols, int kb, int n_edges, int zc, int num_iters,
               float scale, int scale16, int early_stop) {
  using LT = typename Types<M>::L;
  using RT = typename Types<M>::R;

  extern __shared__ __align__(16) unsigned char smem[];
  const int z = threadIdx.x;
  int32_t *s_rs, *s_col, *s_shift;
  LT* s_l = load_tables<M>(smem, row_start, edge_col, edge_shift, rows, n_edges, z,
                           &s_rs, &s_col, &s_shift);
  RT* r_msg;
  if constexpr (M == kF32) r_msg = r_scratch + size_t(blockIdx.x) * n_edges * zc;
  else r_msg = reinterpret_cast<RT*>(reinterpret_cast<unsigned char*>(s_l) +
                                     align16(size_t(cols) * zc * sizeof(LT)));
  const typename Types<M>::In* src = llr + size_t(blockIdx.x) * cols * zc;
  for (int i = z; i < cols * zc; i += blockDim.x) s_l[i] = load_llr<M>(src[i]);
  __syncthreads();

  int it = 0;
  int violated = 1;
  for (; it < num_iters; ++it) {
    sweep<M>(s_l, r_msg, s_rs, s_col, s_shift, rows, zc, z, it == 0, scale, scale16);
    if (early_stop) {
      violated = syndrome_violated<M>(s_l, s_rs, s_col, s_shift, rows, zc, z);
      if (!violated) { ++it; break; }
    }
  }
  if (!early_stop || it == 0)
    violated = syndrome_violated<M>(s_l, s_rs, s_col, s_shift, rows, zc, z);

  write_hard<M>(s_l, hard, kb, zc, z);
  if (z == 0) {
    ok_out[blockIdx.x] = violated ? 0 : 1;
    sweeps_out[blockIdx.x] = it;
  }
}

// K2's tiled path: sweep number `it` of every codeblock whose tile has not
// met parity yet.  L (B, cols*zc) int16 and R (B, E, zc) int8 persist in
// device memory.  viol (num_iters, n_tiles) int32 is zero before the first
// launch.
__global__ void __launch_bounds__(kMaxZc)
int8_tiled_sweep_kernel(const int8_t* __restrict__ llr, int16_t* __restrict__ l_state,
                        int8_t* __restrict__ r_state, int32_t* __restrict__ viol,
                        int8_t* __restrict__ hard, uint8_t* __restrict__ ok_out,
                        int32_t* __restrict__ sweeps_out,
                        const int32_t* __restrict__ row_start,
                        const int32_t* __restrict__ edge_col,
                        const int32_t* __restrict__ edge_shift,
                        int rows, int cols, int kb, int n_edges, int zc, int it,
                        int b_tile, int n_tiles) {
  const int tile = blockIdx.x / b_tile;
  if (it > 0 && viol[(it - 1) * n_tiles + tile] == 0) return;   // tile done

  extern __shared__ __align__(16) unsigned char smem[];
  const int z = threadIdx.x;
  int32_t *s_rs, *s_col, *s_shift;
  int16_t* s_l = load_tables<kInt8>(smem, row_start, edge_col, edge_shift, rows, n_edges, z,
                                    &s_rs, &s_col, &s_shift);
  int16_t* gl = l_state + size_t(blockIdx.x) * cols * zc;
  const int8_t* src = llr + size_t(blockIdx.x) * cols * zc;
  for (int i = z; i < cols * zc; i += blockDim.x) s_l[i] = it == 0 ? int16_t(src[i]) : gl[i];
  __syncthreads();

  sweep<kInt8>(s_l, r_state + size_t(blockIdx.x) * n_edges * zc, s_rs, s_col, s_shift, rows,
               zc, z, it == 0, 0.0f, 0);
  for (int i = z; i < cols * zc; i += blockDim.x) gl[i] = s_l[i];
  const int violated = syndrome_violated<kInt8>(s_l, s_rs, s_col, s_shift, rows, zc, z);

  write_hard<kInt8>(s_l, hard, kb, zc, z);
  if (z == 0) {
    if (violated) viol[it * n_tiles + tile] = 1;   // every writer stores 1
    ok_out[blockIdx.x] = violated ? 0 : 1;
    sweeps_out[blockIdx.x] = it + 1;
  }
}

template <int M>
int launch(const void* llr, int8_t* hard, uint8_t* ok, int32_t* sweeps, float* r_scratch,
           const int32_t* row_start, const int32_t* edge_col, const int32_t* edge_shift,
           int batch, int rows, int cols, int kb, int n_edges, int zc, int num_iters,
           float scale, int scale16, int early_stop, cudaStream_t stream) {
  const size_t smem = smem_bytes<M>(rows, cols, n_edges, zc, M != kF32);
  cudaError_t err = cudaFuncSetAttribute(layered_kernel<M>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  layered_kernel<M><<<batch, zc, smem, stream>>>(
      static_cast<const typename Types<M>::In*>(llr), hard, ok, sweeps, r_scratch,
      row_start, edge_col, edge_shift, rows, cols, kb, n_edges, zc, num_iters, scale,
      scale16, early_stop);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one CTA of the fused path needs (bytes); mode 0 f32, 1 wire,
// 2 int8.
size_t ldpc_layered_smem_bytes(int mode, int rows, int cols, int n_edges, int zc) {
  switch (mode) {
    case kF32: return smem_bytes<kF32>(rows, cols, n_edges, zc, false);
    case kWire: return smem_bytes<kWire>(rows, cols, n_edges, zc, true);
    default: return smem_bytes<kInt8>(rows, cols, n_edges, zc, true);
  }
}

// Fused path: decode `batch` codeblocks of (cols * zc) LLRs laid out
// row-major, all sweeps in one launch, per-codeblock early exit.
// mode 0 (f32): llr float32, r_scratch holds batch * n_edges * zc floats.
// mode 1 (wire) / 2 (int8): llr int8, r_scratch unused (may be null).
// Outputs: hard (batch, kb * zc) int8, ok (batch,) uint8, sweeps (batch,) int32.
// Returns cudaGetLastError() after the launch (0 = launched).
int ldpc_layered_decode(const void* llr, int mode, int8_t* hard, uint8_t* ok,
                        int32_t* sweeps, float* r_scratch, const int32_t* row_start,
                        const int32_t* edge_col, const int32_t* edge_shift, int batch,
                        int rows, int cols, int kb, int n_edges, int zc, int num_iters,
                        float scale, int scale16, int early_stop, void* stream) {
  if (batch == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
#define LDPC_ARGS llr, hard, ok, sweeps, r_scratch, row_start, edge_col, edge_shift, batch, \
    rows, cols, kb, n_edges, zc, num_iters, scale, scale16, early_stop, s
  switch (mode) {
    case kF32: return launch<kF32>(LDPC_ARGS);
    case kWire: return launch<kWire>(LDPC_ARGS);
    case kInt8: return launch<kInt8>(LDPC_ARGS);
    default: return int(cudaErrorInvalidValue);
  }
#undef LDPC_ARGS
}

// K2's tiled path: one launch per sweep, tiles of b_tile consecutive
// codeblocks stop together once all of them meet parity (batch % b_tile ==
// 0).  llr: int8; l_state: batch * cols * zc int16; r_state: batch * n_edges
// * zc int8; viol: num_iters * (batch / b_tile) int32, zeroed by the caller.
// Outputs as ldpc_layered_decode.
int ldpc_int8_decode_tiled(const int8_t* llr, int16_t* l_state, int8_t* r_state,
                           int32_t* viol, int8_t* hard, uint8_t* ok, int32_t* sweeps,
                           const int32_t* row_start, const int32_t* edge_col,
                           const int32_t* edge_shift, int batch, int rows, int cols, int kb,
                           int n_edges, int zc, int num_iters, int b_tile, void* stream) {
  if (batch == 0) return 0;
  if (b_tile <= 0 || batch % b_tile != 0) return int(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<kInt8>(rows, cols, n_edges, zc, false);
  cudaError_t err = cudaFuncSetAttribute(int8_tiled_sweep_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  const int n_tiles = batch / b_tile;
  for (int it = 0; it < num_iters; ++it) {
    int8_tiled_sweep_kernel<<<batch, zc, smem, static_cast<cudaStream_t>(stream)>>>(
        llr, l_state, r_state, viol, hard, ok, sweeps, row_start, edge_col, edge_shift,
        rows, cols, kb, n_edges, zc, it, b_tile, n_tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  return 0;
}

}  // extern "C"
