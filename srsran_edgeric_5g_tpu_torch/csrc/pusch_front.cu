// PUSCH front for NVIDIA Hopper (sm_90a): the slot receiver's per-RE chain,
// from the CFO derotation to the descrambled int8 wire LLRs, in one kernel.
//
// Replaces no Pallas kernel: the JAX reference runs the chain as XLA ops
// (srsran_edgeric_5g_tpu/parallel/slot_pipeline.py _ul_front and
// _ul_front_mimo), and the port's plain version (ops/pusch_front.py's CPU
// path) as some 170-190 PyTorch ops: the derotation, the 1xN MMSE per RE
// or the LxP weights applied per RE, the max-log demap with a round, clamp
// and square per bit and a stack per axis, the wire quantisation and the
// descrambling by a float32 GEMM that draws each row's Gold sequence anew.
// Each op passes float32 tensors of tens of millions of elements through
// device memory.
//
//  * pusch_demap_kernel: a CTA per (TB row, run of at most 256 of its
//    subcarriers), a thread per subcarrier.  The thread computes what stays
//    fixed over the row's data symbols once: the 1xN MMSE's terms from the
//    row's channel estimate at its subcarrier and the row's noise variance
//    (kSiso: one port, one layer, equalize_mmse_1xn's abnormal-input rules,
//    an invalid RE erasing: x = 0, nvar = inf, so rcp = 0), or the LxP
//    weights and equalised noise that mmse_weights_grid computes once per
//    subcarrier in PyTorch; and each layer's reciprocal noise.  Then for
//    each data symbol it reads its RE on each receive port straight from
//    the demodulated grid (no copy of the band), multiplies it by its row's
//    derotation factor for the symbol, equalises it (x = conj(h) y c, or
//    x_l = sum_p W_lp y_p), and writes the max-log LLRs of
//    modulation.demodulate_soft after the wire scale, round and clip of
//    wire_quantize and the sign of the row's Gold sequence, in the widest
//    stores the RE's Qm L bytes allow.  Qm and L are template arguments, so
//    every per-bit loop unrolls.  The CTA first makes the Gold sequence of
//    its LLRs, 32 bits at a time, from the packed x1 row and x2 basis of
//    ops/pdsch_code.py's gold_words (the x1 word XOR the basis rows of
//    c_init's set bits), into shared memory.
//  * Arithmetic: the plain chain's float32 operations in its order, each
//    rounded alone (the library is built with --fmad=false).  Two of them
//    follow what PyTorch's CUDA kernels compute, so that the LLRs equal the
//    plain chain's on the card bit for bit:
//      - a complex product a * b is c10::complex's (ac - bd, ad + bc) as
//        nvcc contracts it there: fma(a.re, b.re, -(a.im b.im)) and
//        fma(a.re, b.im, a.im b.re);
//      - a tensor divided by a host scalar s is multiplied by the float32
//        1 / s (div_true_kernel_cuda), so the demapper's / (2a) is a
//        product with inv_two_a.
//
// Bound (H100 SXM): bytes.  The least traffic is the data REs in (8 bytes a
// port), the per-subcarrier estimate or weights (read once per subcarrier
// and row), and one int8 per LLR out: 191 MB a SISO step of the benchmark's
// cell (S = 1024, 4 UEs x 288 subcarriers x 11 data symbols, 64QAM) and 205
// MB a 2x2 step (S = 512), 0.057 / 0.061 ms at 3.35 TB/s.  The instructions
// come next: ~150 an RE at 64QAM for the demap alone.  With a thread per RE,
// each also dividing twice and finding its symbol, the kernel took 0.39 /
// 0.35 ms (SISO / 2x2) on the card, bound by instruction throughput; a
// thread per subcarrier does the divisions once per row and walks the
// symbols, 0.14 / 0.15 ms.  Each input is read once, coalesced (neighbouring threads on
// neighbouring subcarriers), and each LLR written once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;  // subcarriers of a CTA, one a thread
constexpr int kMaxPorts = 4;

struct DemapArgs {
  const float2* grid;       // (slots, ports, nsymb, nsubc) demodulated REs
  const float2* eq;         // kSiso: (rows, w) channel estimate; else (rows, w, L, P) weights
  const float* nv;          // kSiso: (rows,) noise variance; else (rows, w, L) equalised noise
  const float2* rot;        // (rows, ndata) CFO derotation factors, or null
  const long long* c_init;  // (rows,) scrambling initialisers (the low 31 bits)
  const uint32_t* x1;       // (nwg,) packed x1(n + Nc)
  const uint32_t* basis;    // (31, nwg) packed x2(n + Nc) of c_init = e_i
  int8_t* out;              // (rows, g) wire LLRs, g = ndata * w * L * qm
  int ue, w, ndata, nsymb, nsubc, band0, ports;
  int kc;                   // subcarriers of a CTA (blockIdx.y takes the k-th run of them)
  int stride;               // sequence words a data symbol takes in shared memory
  float amp, inv_two_amp;   // the per-axis PAM unit a and float32 1 / (2a)
  float llr_scale;          // the wire scale 120 / range limit
  uint32_t sym_mask;        // bit s set: grid symbol s carries data (ndata bits)
};

// a * b as PyTorch's CUDA kernels round it (see the note at the top).
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(__fmaf_rn(a.x, b.x, -__fmul_rn(a.y, b.y)),
                     __fmaf_rn(a.x, b.y, __fmul_rn(a.y, b.x)));
}

__device__ __forceinline__ float wire(float llr, float scale) {
  return fminf(fmaxf(rintf(__fmul_rn(llr, scale)), -120.0f), 120.0f);
}

// The M max-log LLRs of one real axis (modulation._axis_maxlog), MSB first,
// each times rcp and quantised, into q[0], q[2], ...
template <int M>
__device__ __forceinline__ void axis_llrs(float u, float rcp, float amp, float inv_two_amp,
                                          float scale, float* q) {
  const float two_a = 2.0f * amp, four_a = 4.0f * amp;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    constexpr int kTop = 1 << (M - 1);
    const int k = kTop >> j;
    float lj;
    if (k == 1) {
      lj = __fmul_rn(four_a, u);
    } else {
      const float hi = float(k - 1);
      const float kp = fminf(fmaxf(rintf(__fmul_rn(__fsub_rn(u, amp), inv_two_amp)), 0.0f), hi);
      const float kn = fminf(fmaxf(rintf(__fmul_rn(__fsub_rn(-u, amp), inv_two_amp)), 0.0f), hi);
      const float p = __fadd_rn(__fmul_rn(two_a, kp), amp);
      const float n = -__fadd_rn(__fmul_rn(two_a, kn), amp);
      const float dn = __fsub_rn(u, n), dp = __fsub_rn(u, p);
      lj = __fsub_rn(__fmul_rn(dn, dn), __fmul_rn(dp, dp));
    }
    q[2 * j] = wire(__fmul_rn(lj, rcp), scale);
    if (j < M - 1) u = __fsub_rn(float(k) * amp, fabsf(u));
  }
}

// Stores the kBytes bytes of v (little-endian words) at p, in the widest
// pieces that p's alignment (a multiple of kBytes' lowest set bit) allows.
template <int kBytes>
__device__ __forceinline__ void store_bytes(int8_t* p, const uint32_t* v) {
  constexpr int kAlign = (kBytes & -kBytes) < 16 ? (kBytes & -kBytes) : 16;
  if constexpr (kAlign == 16) {
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c)
      reinterpret_cast<uint4*>(p)[c] = make_uint4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
  } else if constexpr (kAlign == 8) {
#pragma unroll
    for (int c = 0; c < kBytes / 8; ++c)
      reinterpret_cast<uint2*>(p)[c] = make_uint2(v[2 * c], v[2 * c + 1]);
  } else if constexpr (kAlign == 4) {
#pragma unroll
    for (int c = 0; c < kBytes / 4; ++c) reinterpret_cast<uint32_t*>(p)[c] = v[c];
  } else if constexpr (kAlign == 2) {
#pragma unroll
    for (int c = 0; c < kBytes / 2; ++c)
      reinterpret_cast<uint16_t*>(p)[c] = uint16_t(v[c / 2] >> (16 * (c % 2)));
  } else {
#pragma unroll
    for (int c = 0; c < kBytes; ++c) p[c] = int8_t(v[c / 4] >> (8 * (c % 4)));
  }
}

template <bool kSiso, int L, int kQm>
__global__ void __launch_bounds__(kMaxThreads) pusch_demap_kernel(DemapArgs a) {
  constexpr int kPerRe = L * kQm;               // LLRs of one RE
  extern __shared__ uint32_t s_seq[];           // [ndata][stride] sequence words
  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const int k0 = blockIdx.y * a.kc;
  const int kn = min(a.kc, a.w - k0);           // subcarriers of this CTA
  const size_t g = size_t(a.ndata) * a.w * kPerRe;
  const int nwg = int((g + 31) >> 5);

  // The Gold sequence bits of this CTA's LLRs: for each data symbol d the
  // words from the one holding LLR (d w + k0) * kPerRe to the second word of
  // its last RE's 64-bit window.
  const uint32_t ci = uint32_t(a.c_init[row]) & 0x7fffffffu;
  const int nw = ((31 + (kn - 1) * kPerRe) >> 5) + 2;
  for (int t = tid; t < a.ndata * nw; t += blockDim.x) {
    const int d = t / nw, idx = t - d * nw;
    const int gw = int((size_t(d * a.w + k0) * kPerRe) >> 5) + idx;
    uint32_t s = 0;
    if (gw < nwg) {
      s = a.x1[gw];
#pragma unroll
      for (int i = 0; i < 31; ++i)
        if ((ci >> i) & 1u) s ^= a.basis[size_t(i) * nwg + gw];
    }
    s_seq[d * a.stride + idx] = s;
  }
  __syncthreads();
  if (tid >= kn) return;

  // What the subcarrier k = k0 + tid keeps over its data symbols: the
  // equaliser's terms and the reciprocal noise of each layer.
  const int k = k0 + tid;
  const int slot = row / a.ue, u = row - slot * a.ue;
  const size_t plane = size_t(a.nsymb) * a.nsubc;
  const float2* y_k = a.grid + size_t(slot) * a.ports * plane + a.band0 + u * a.w + k;
  const size_t sc = size_t(row) * a.w + k;
  float rcp[L];
  float2 hc = make_float2(0.0f, 0.0f), wt[L][kMaxPorts];
  float c = 0.0f;
  bool valid = false, ok = false;
  if constexpr (kSiso) {
    const float2 h = a.eq[sc];
    const float nv = a.nv[row];
    const float h_norm = __fadd_rn(__fmul_rn(h.x, h.x), __fmul_rn(h.y, h.y));
    valid = isfinite(h_norm) && h_norm > 0.0f && isfinite(nv) && nv > 0.0f;
    const float ch = valid ? h_norm : 0.0f;
    const float acc = valid ? __fmul_rn(h_norm, nv) : 0.0f;
    ok = ch > 0.0f && isfinite(ch) && acc > 0.0f && isfinite(acc);
    const float d_rcp = ok ? 1.0f / __fadd_rn(__fmul_rn(ch, ch), acc) : 0.0f;
    c = __fmul_rn(ch, d_rcp);
    hc = make_float2(h.x, -h.y);
    const float nvo = ok ? __fmul_rn(acc, d_rcp) : __int_as_float(0x7f800000);
    rcp[0] = nvo > 0.0f ? 1.0f / fmaxf(nvo, 1e-30f) : 0.0f;
  } else {
#pragma unroll
    for (int l = 0; l < L; ++l) {
#pragma unroll
      for (int p = 0; p < kMaxPorts; ++p)
        if (p < a.ports) wt[l][p] = a.eq[(sc * L + l) * a.ports + p];
      const float nvo = a.nv[sc * L + l];
      rcp[l] = nvo > 0.0f ? 1.0f / fmaxf(nvo, 1e-30f) : 0.0f;
    }
  }

  int8_t* out_row = a.out + size_t(row) * g;
  uint32_t syms = a.sym_mask;
  for (int d = 0; d < a.ndata; ++d, syms &= syms - 1) {
    const float2* y_d = y_k + size_t(__ffs(syms) - 1) * a.nsubc;
    const float2 rot = a.rot ? a.rot[size_t(row) * a.ndata + d] : make_float2(1.0f, 0.0f);
    float2 x[L];
    if constexpr (kSiso) {
      float2 y = *y_d;
      if (a.rot) y = cmul(y, rot);
      const float2 mf = valid ? cmul(y, hc) : make_float2(0.0f, 0.0f);
      x[0] = ok ? make_float2(__fmul_rn(mf.x, c), __fmul_rn(mf.y, c)) : make_float2(0.0f, 0.0f);
    } else {
      float2 y[kMaxPorts];
#pragma unroll
      for (int p = 0; p < kMaxPorts; ++p) {
        if (p < a.ports) {
          y[p] = y_d[p * plane];
          if (a.rot) y[p] = cmul(y[p], rot);
        }
      }
#pragma unroll
      for (int l = 0; l < L; ++l) {
        float2 acc = cmul(wt[l][0], y[0]);
#pragma unroll
        for (int p = 1; p < kMaxPorts; ++p) {
          if (p < a.ports) {
            const float2 t = cmul(wt[l][p], y[p]);
            acc = make_float2(__fadd_rn(acc.x, t.x), __fadd_rn(acc.y, t.y));
          }
        }
        x[l] = acc;
      }
    }
    // This RE's sequence bits: a 64-bit window from the symbol's words.
    const int pos = int(size_t(d * a.w + k) * kPerRe - (size_t(d * a.w + k0) * kPerRe & ~size_t(31)));
    const uint32_t* sq = s_seq + d * a.stride + (pos >> 5);
    const uint64_t seq = (uint64_t(sq[1]) << 32 | sq[0]) >> (pos & 31);
    uint32_t v[(kPerRe + 3) / 4] = {};
#pragma unroll
    for (int l = 0; l < L; ++l) {
      float q[kQm];
      if constexpr (kQm == 1) {
        const float c2 = 2.0f * 1.41421353816986083984375f;  // 2 * float32(sqrt 2)
        q[0] = wire(__fmul_rn(__fmul_rn(c2, __fadd_rn(x[l].x, x[l].y)), rcp[l]), a.llr_scale);
      } else {
        axis_llrs<kQm / 2>(x[l].x, rcp[l], a.amp, a.inv_two_amp, a.llr_scale, q);      // b0, b2, ..
        axis_llrs<kQm / 2>(x[l].y, rcp[l], a.amp, a.inv_two_amp, a.llr_scale, q + 1);  // b1, b3, ..
      }
#pragma unroll
      for (int b = 0; b < kQm; ++b) {
        const int j = l * kQm + b;
        const int s = static_cast<int>(q[b]);
        v[j / 4] |= uint32_t(uint8_t(((seq >> j) & 1u) ? -s : s)) << (8 * (j % 4));
      }
    }
    store_bytes<kPerRe>(out_row + size_t(d * a.w + k) * kPerRe, v);
  }
}

template <bool kSiso, int L, int kQm>
int launch(const DemapArgs& a, int rows, int threads, cudaStream_t stream) {
  const dim3 grid(rows, (a.w + a.kc - 1) / a.kc);
  const size_t smem = sizeof(uint32_t) * size_t(a.ndata) * a.stride;
  pusch_demap_kernel<kSiso, L, kQm><<<grid, threads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

template <bool kSiso, int L>
int launch_qm(const DemapArgs& a, int qm, int rows, int threads, cudaStream_t stream) {
  switch (qm) {
    case 1: return launch<kSiso, L, 1>(a, rows, threads, stream);
    case 2: return launch<kSiso, L, 2>(a, rows, threads, stream);
    case 4: return launch<kSiso, L, 4>(a, rows, threads, stream);
    case 6: return launch<kSiso, L, 6>(a, rows, threads, stream);
    case 8: return launch<kSiso, L, 8>(a, rows, threads, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// The per-RE chain of `rows` TB rows (row r: slot r / ue, UE r % ue; its
// data symbols the set bits of sym_mask, in order) -> out (rows, ndata * w *
// layers * qm) int8.  `layers` 0 takes the 1xN MMSE from a (rows, w)
// estimate and (rows,) noise variance on a one-port grid; 1, 2 or 4 applies
// (rows, w, layers, ports) weights.  Returns a cudaError_t (0: launched).
int pusch_demap(const void* grid, const void* eq, const float* nv, const void* rot,
                const long long* c_init, const uint32_t* x1, const uint32_t* basis,
                int8_t* out, unsigned sym_mask, int rows, int ue, int w, int ndata, int nsymb,
                int nsubc, int band0, int ports, int layers, int qm, float amp,
                float inv_two_amp, float llr_scale, void* stream) {
  if (rows == 0 || ndata == 0 || w == 0) return 0;
  if (ndata != __builtin_popcount(sym_mask) || nsymb > 32 || (nsymb < 32 && sym_mask >> nsymb) ||
      ports < 1 || ports > kMaxPorts || ue < 1 || band0 < 0 || band0 + ue * w > nsubc ||
      (layers == 0 && ports != 1))
    return int(cudaErrorInvalidValue);
  // A row's subcarriers in as few CTAs of at most kMaxThreads as it takes,
  // evenly: 288 subcarriers go as two of 144.
  const int runs = (w + kMaxThreads - 1) / kMaxThreads;
  const int kc = (w + runs - 1) / runs;
  const int per_re = (layers ? layers : 1) * qm;
  const DemapArgs args{static_cast<const float2*>(grid), static_cast<const float2*>(eq), nv,
                       static_cast<const float2*>(rot), c_init, x1, basis, out, ue, w, ndata,
                       nsymb, nsubc, band0, ports, kc, ((31 + (kc - 1) * per_re) >> 5) + 2, amp,
                       inv_two_amp, llr_scale, sym_mask};
  const int threads = (kc + 31) / 32 * 32;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (layers) {
    case 0: return launch_qm<true, 1>(args, qm, rows, threads, s);
    case 1: return launch_qm<false, 1>(args, qm, rows, threads, s);
    case 2: return launch_qm<false, 2>(args, qm, rows, threads, s);
    case 4: return launch_qm<false, 4>(args, qm, rows, threads, s);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // extern "C"
