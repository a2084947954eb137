// Layered min-sum LDPC decoder for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel K1 of the JAX reference:
// srsran_edgeric_5g_tpu/ops/ldpc/decoder_pallas.py, _make_kernel (:100-146)
// behind _decode_pallas_inner / decode_pallas (:211-258).  Two modes:
//
//  * f32 mode  (wire == 0): the Pallas kernel's own arithmetic — normalised
//    min-sum with scale 0.8, R = (sgn*st) * (mag*scale), L = t + R, hard bit
//    post < 0.  Every multiply and add is rounded separately (__fmul_rn /
//    __fadd_rn, and the library is built with --fmad=false), so the result is
//    bit-equal to the plain PyTorch version.
//  * wire mode (wire == 1): the semantics of the reference's layered_wire
//    schedule (srsran_edgeric_5g_tpu/ops/ldpc/decoder.py:212-273 with
//    _minsum(scale_floor=True)), which the main path's decode("wire_auto")
//    computes: ±64 load clamp, ±120 v2c saturation with frozen (|L| > 120)
//    posteriors passing through, min trackers capped at 120, truncating scale
//    (mag * floor(0.8 * 2^16)) >> 16 with magnitudes > 120 passed through,
//    the promotion sum pinning at ±127 with its infinite-addend rules, hard
//    bit L <= 0.  All values are integers, so it runs in int32 arithmetic.
//
// Design.  One CTA decodes one codeblock; thread z owns lane z of the Zc
// lifting dimension (blockDim.x == Zc).  The posterior L (cols x Zc) lives in
// shared memory for the whole decode.  The lifted cyclic shift by s of the
// TPU kernel's lane roll becomes thread z reading L[c][(z + s) % Zc] and
// writing its update back to the same element: inside one check row every
// edge has a different column and (z + s) % Zc is a permutation of the lanes,
// so no two threads touch one element; a __syncthreads() separates rows.
//   R (one message per edge and lane) is where the two modes differ:
//  * wire: |R| <= 96, so R is int8 in shared memory (E x Zc bytes) beside an
//    int16 L — 101 KB at BG1 Zc=224, 173 KB at the largest Zc=384.
//  * f32: E x Zc x 4 bytes is 283 KB at BG1 Zc=224, above the 227 KB a CTA can
//    have, so R lives in a device-memory scratch of (B, E, Zc) floats that the
//    wrapper allocates; thread z reads and writes only its own lane, so the
//    accesses of a warp are coalesced and most stay in L2.  (The per-row
//    compressed form of decoder.py:735-758 is the later alternative.)
// The edge table (row starts, columns, shifts; row-major, columns ascending
// within a row as in the reference's edge list) is copied to shared memory.
// Within a row the t values and gather positions stay in registers (rows
// have at most kMaxDeg = 19 edges; the loops are unrolled and predicated).
// The first-minimum slot is the lowest-index argmin, as in the reference;
// on a tie m2 == m1, so the Pallas kernel's "a == m1 -> m2" rule gives the
// same messages.
//   Early exit (early_stop != 0) is per codeblock: after each sweep the CTA
// evaluates the syndrome of its hard bits (XOR over each check row of the
// rotated bits, __syncthreads_or over lanes) and stops once it is zero.  The
// JAX path exits per batch; with early_stop == 0 both run num_iters sweeps.
// The same syndrome gives the `ok` output, so no separate parity pass runs.
//
// Bound (H100 SXM, main path: B = 2048 codeblocks, BG1, Zc = 224, 316 edges).
// The check-node update is about 16 ALU operations per edge-lane per sweep
// (subtract, saturate, abs, two min-tracker updates, sign parity, magnitude
// select, scale, sign, add, pin), i.e. 16 * 316 * 224 * 6 * 2048 = 1.4e10
// operations for 6 sweeps, against ~3.3e13 32-bit lane operations/s: about
// 0.4 ms; the 31 MB int8 input is 0.01 ms of HBM time.  So the decode is
// bound by operations (and, in this simple design, by the latency of the
// shared-memory gathers and the 46 barriers per sweep) — not by bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDeg = 19;     // largest check-row degree (BG1; BG2: 10)
constexpr int kMaxZc = 384;     // largest lifting size
constexpr int kWireLoad = 64;   // soft_bits_clamp at load
constexpr int kWireMax = 120;   // LLR_MAX
constexpr int kWireInf = 127;   // LLR_INFTY: a fixed bit

template <bool kWire> struct Types;
// In: input element, L/R: stored posterior/message, V: arithmetic type,
// kBig: initial second minimum (above any tracked magnitude).
template <> struct Types<false> {
  using In = float; using L = float; using R = float; using V = float;
  static constexpr float kBig = 1e30f;
};
template <> struct Types<true> {
  using In = int8_t; using L = int16_t; using R = int8_t; using V = int;
  static constexpr int kBig = 1 << 30;
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

__host__ __device__ inline size_t table_bytes(int rows, int n_edges) {
  return align16(size_t(rows + 1 + 2 * n_edges) * sizeof(int32_t));
}

template <bool kWire>
__host__ __device__ inline size_t smem_bytes(int rows, int cols, int n_edges, int zc) {
  size_t bytes = table_bytes(rows, n_edges) +
                 align16(size_t(cols) * zc * sizeof(typename Types<kWire>::L));
  if (kWire) bytes += align16(size_t(n_edges) * zc * sizeof(typename Types<kWire>::R));
  return bytes;
}

template <bool kWire>
__device__ __forceinline__ int hard_bit(typename Types<kWire>::L v) {
  if constexpr (kWire) return v <= 0;
  else return v < 0.0f;
}

// 1 if any check row of this codeblock is violated (block-wide).
template <bool kWire>
__device__ int syndrome_violated(const typename Types<kWire>::L* s_l, const int32_t* s_rs,
                                 const int32_t* s_col, const int32_t* s_shift,
                                 int rows, int zc, int z) {
  int viol = 0;
  for (int row = 0; row < rows; ++row) {
    int par = 0;
    for (int e = s_rs[row]; e < s_rs[row + 1]; ++e) {
      int p = z + s_shift[e];
      if (p >= zc) p -= zc;
      par ^= hard_bit<kWire>(s_l[s_col[e] * zc + p]);
    }
    viol |= par;
  }
  return __syncthreads_or(viol);
}

template <bool kWire>
__global__ void __launch_bounds__(kMaxZc)
layered_kernel(const typename Types<kWire>::In* __restrict__ llr,
               int8_t* __restrict__ hard, uint8_t* __restrict__ ok_out,
               int32_t* __restrict__ sweeps_out, float* __restrict__ r_scratch,
               const int32_t* __restrict__ row_start,
               const int32_t* __restrict__ edge_col,
               const int32_t* __restrict__ edge_shift,
               int rows, int cols, int kb, int n_edges, int zc, int num_iters,
               float scale, int scale16, int early_stop) {
  using LT = typename Types<kWire>::L;
  using RT = typename Types<kWire>::R;
  using VT = typename Types<kWire>::V;

  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* s_rs = reinterpret_cast<int32_t*>(smem);
  int32_t* s_col = s_rs + rows + 1;
  int32_t* s_shift = s_col + n_edges;
  size_t off = table_bytes(rows, n_edges);
  LT* s_l = reinterpret_cast<LT*>(smem + off);
  off += align16(size_t(cols) * zc * sizeof(LT));
  RT* r_msg;
  if constexpr (kWire) r_msg = reinterpret_cast<RT*>(smem + off);
  else r_msg = r_scratch + size_t(blockIdx.x) * n_edges * zc;

  const int z = threadIdx.x;
  for (int i = z; i <= rows; i += blockDim.x) s_rs[i] = row_start[i];
  for (int i = z; i < n_edges; i += blockDim.x) {
    s_col[i] = edge_col[i];
    s_shift[i] = edge_shift[i];
  }
  const typename Types<kWire>::In* src = llr + size_t(blockIdx.x) * cols * zc;
  for (int i = z; i < cols * zc; i += blockDim.x) {
    if constexpr (kWire) s_l[i] = static_cast<LT>(max(-kWireLoad, min(kWireLoad, int(src[i]))));
    else s_l[i] = src[i];
  }
  __syncthreads();

  int it = 0;
  int violated = 1;
  for (; it < num_iters; ++it) {
    const bool first = it == 0;  // R == 0 before the first sweep: not read
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
          if constexpr (kWire) {
            tv = max(-kWireMax, min(kWireMax, lg - rold));   // v2c saturation
            if (abs(lg) > kWireMax) tv = lg;                 // frozen posterior
            a = min(abs(tv), kWireMax);                      // tracker cap
          } else {
            tv = __fsub_rn(lg, rold);
            a = fabsf(tv);
          }
          t[j] = tv;
          if (j == 0) { m1 = a; m2 = Types<kWire>::kBig; }
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
          if constexpr (kWire) {
            const int sm = mag > kWireMax ? mag : (mag * scale16) >> 16;
            rn = flip ? -sm : sm;
            v = tv + rn;
            v = v > kWireMax ? kWireInf : (v < -kWireMax ? -kWireInf : v);
            const bool tp = tv > kWireMax, tn = tv < -kWireMax;
            const bool rp = rn > kWireMax, rneg = rn < -kWireMax;
            if ((tp && !rneg) || (rp && !tn)) v = kWireInf;
            if ((tn && !rp) || (rneg && !tp)) v = -kWireInf;
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
    if (early_stop) {
      violated = syndrome_violated<kWire>(s_l, s_rs, s_col, s_shift, rows, zc, z);
      if (!violated) { ++it; break; }
    }
  }
  if (!early_stop || it == 0)
    violated = syndrome_violated<kWire>(s_l, s_rs, s_col, s_shift, rows, zc, z);

  int8_t* dst = hard + size_t(blockIdx.x) * kb * zc;
  for (int c = 0; c < kb; ++c) dst[c * zc + z] = static_cast<int8_t>(hard_bit<kWire>(s_l[c * zc + z]));
  if (z == 0) {
    ok_out[blockIdx.x] = violated ? 0 : 1;
    sweeps_out[blockIdx.x] = it;
  }
}

template <bool kWire>
int launch(const void* llr, int8_t* hard, uint8_t* ok, int32_t* sweeps, float* r_scratch,
           const int32_t* row_start, const int32_t* edge_col, const int32_t* edge_shift,
           int batch, int rows, int cols, int kb, int n_edges, int zc, int num_iters,
           float scale, int scale16, int early_stop, cudaStream_t stream) {
  const size_t smem = smem_bytes<kWire>(rows, cols, n_edges, zc);
  cudaError_t err = cudaFuncSetAttribute(layered_kernel<kWire>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  layered_kernel<kWire><<<batch, zc, smem, stream>>>(
      static_cast<const typename Types<kWire>::In*>(llr), hard, ok, sweeps, r_scratch,
      row_start, edge_col, edge_shift, rows, cols, kb, n_edges, zc, num_iters, scale,
      scale16, early_stop);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one CTA needs (bytes); the wrapper checks it against the card.
size_t ldpc_layered_smem_bytes(int wire, int rows, int cols, int n_edges, int zc) {
  return wire ? smem_bytes<true>(rows, cols, n_edges, zc)
              : smem_bytes<false>(rows, cols, n_edges, zc);
}

// Decode `batch` codeblocks of (cols * zc) LLRs laid out row-major.
// wire == 1: llr is int8, r_scratch unused (may be null).
// wire == 0: llr is float32, r_scratch holds batch * n_edges * zc floats.
// Outputs: hard (batch, kb * zc) int8, ok (batch,) uint8, sweeps (batch,) int32.
// Returns cudaGetLastError() after the launch (0 = launched).
int ldpc_layered_decode(const void* llr, int wire, int8_t* hard, uint8_t* ok,
                        int32_t* sweeps, float* r_scratch, const int32_t* row_start,
                        const int32_t* edge_col, const int32_t* edge_shift, int batch,
                        int rows, int cols, int kb, int n_edges, int zc, int num_iters,
                        float scale, int scale16, int early_stop, void* stream) {
  if (batch == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  return wire ? launch<true>(llr, hard, ok, sweeps, r_scratch, row_start, edge_col,
                             edge_shift, batch, rows, cols, kb, n_edges, zc, num_iters,
                             scale, scale16, early_stop, s)
              : launch<false>(llr, hard, ok, sweeps, r_scratch, row_start, edge_col,
                              edge_shift, batch, rows, cols, kb, n_edges, zc, num_iters,
                              scale, scale16, early_stop, s);
}

}  // extern "C"
