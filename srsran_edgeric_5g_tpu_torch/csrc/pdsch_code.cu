// PDSCH coding for NVIDIA Hopper (sm_90a): two kernels on bit-packed data.
//
// Replaces no Pallas kernel: the JAX reference codes the PDSCH with XLA ops
// (srsran_edgeric_5g_tpu/parallel/slot_pipeline.py _dl_code: segment + CRC,
// LDPC encode, rate match, scramble, modulate), and the port's plain version
// (ops/pdsch_code.py's CPU path) does GF(2) algebra on float32 lanes: CRCs
// and the Gold sequences as float32 matmuls over {0,1} tables, the encoder as
// a gather of every rotated Zc-block cast to float32 and reduced by selector
// GEMMs.  These kernels keep every bit in 32-bit words and do the algebra as
// XORs; no float32 intermediate reaches device memory.
//
//  * pdsch_encode_kernel: one CTA per codeblock.  It packs the codeblock's
//    message bits (its share of the TB payload, the TB CRC, its CRC24B, the
//    filler zeros) into Zc-bit column vectors in shared memory with one
//    __ballot_sync per 32 bits, LDPC-encodes them there, and writes the
//    rate-matched bits.
//      - CRCs: a CRC over N bits is linear, so the wrapper tabulates the
//        remainder x^(N-1-i+L) mod g of every bit position i as one word;
//        each lane XORs the words of its set bits and the CTA XOR-reduces
//        them (shuffles, then one shared atomicXor per warp).  The TB CRC
//        needs the whole TB, so the CTA of a TB's last codeblock reads all A
//        payload bits; the others read only their own.  The TB CRC bits
//        enter the last codeblock's CRC24B by the same table.
//      - Encode (TS 38.212 §5.3.2): a check row's sum is the XOR of its
//        edges' column vectors, each rotated by the edge's shift; a rotated
//        word is a funnel shift of two words plus the wrapped low word where
//        the 32 lanes cross Zc (as K1's syndrome in ldpc_layered.cu).  The
//        four core parities are p = A^-1 s over the core rows' message sums
//        s; A^-1 is block-circulant, so the wrapper gives it as a list of
//        (core row, rotation) terms per core column: 20 at every lifting
//        size of both base graphs.  Extension row r's parity is its row sum
//        over the message and core columns (its own column has shift 0).
//        Only the rows whose parity columns the rate matcher reads are
//        computed (rows_used).
//      - Rate match: the plan's fused select / skip-fillers / interleave
//        index vector, mapped by the wrapper to bit addresses in the packed
//        columns (uint16), one shared-memory bit read per output bit.
//  * pdsch_modulate_kernel: one CTA per TB row of G bits.  It packs the
//    row's bits 32 at a time (ballot), XORs the row's Gold sequence, made
//    32 bits at a time as the packed x1 word XOR the packed x2 basis rows of
//    c_init's set bits (at most 31 words, read from L2), and maps Qm bits
//    at a time through the 2^Qm-entry complex64 table that the wrapper
//    builds from modulation.modulate, so every symbol is the plain version's
//    float32 value.
//
// Bound (H100 SXM, the SISO cell's normal slots: 3684 TBs of A = 8968 bits,
// BG1, Zc = 208, C = 2, E = 9000, 64QAM).  The least traffic is the int8
// payload in (33 MB) and the complex64 symbols out (88 MB), plus the int8
// rate-matched bits between the kernels (66 MB out, 66 MB in): about 0.04 ms
// for kernel 1 and 0.05 ms for kernel 2 at 3.35 TB/s.  The ALU work is small
// beside it: about 24 x 7 word-XOR row tasks of ~6 edges, 4 x 7 core tasks
// of ~19 and 4 x 7 x 20 solve terms per codeblock (~1e4 rotated words, each
// ~8 instructions), and one shift-and-mask per rate-matched bit.  So both
// kernels are bound by bytes; the design keeps every intermediate in shared
// memory, reads the int8 bits with one coalesced byte per lane and writes
// each output once.  The tables every CTA reads (CRC remainders, rate-match
// addresses, the Gold basis) are shared by all CTAs of a launch and stay in
// L2.  At these sizes a CTA's time is the latency of its loads, not their
// bytes, so every loop of loads is unrolled to keep its loads in flight
// together (the CRC words are loaded whatever the bit, so a bit and its word
// arrive in one round trip).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxZc = 384;
constexpr int kMaxQm = 8;

struct EncodeArgs {
  const int8_t* payload;    // (n_tb, a) payload bits of the TBs that hold the codeblocks
  int8_t* out;              // (n_out, e) rate-matched bits
  const int32_t* tables;    // row_start[rows + 1], edges[n_edges] (col << 16 | shift),
                            // core_start[5], core terms (row << 16 | shift)
  const uint32_t* crc_tb;   // (a,) remainder words of the TB CRC per payload bit
  const uint32_t* crc_cb;   // (p,) remainder words of CRC24B per codeblock bit (cb_crc)
  const uint16_t* rm_addr;  // (e,) bit address of each output bit in the packed columns
  int n_out, cb0, a, c, p, l_tb, cb_crc, zc, kb, rows, rows_used, n_edges, n_core, e;
};

// Output word w of the column vector v (nw words, bits past zc zero) rotated
// by s: lane l holds v[(32 w + l + s) mod zc].  Lanes past zc are garbage.
__device__ __forceinline__ uint32_t rot_word(const uint32_t* v, int nw, int zc, int w, int s) {
  int p = 32 * w + s;
  if (p >= zc) p -= zc;
  const int k = p >> 5;
  uint32_t r = __funnelshift_r(v[k], v[k + 1 < nw ? k + 1 : 0], p & 31);
  const int left = zc - p;  // lanes before the wrap
  if (left < 32) r = (r & ((1u << left) - 1u)) | (v[0] << left);
  return r;
}

__device__ __forceinline__ uint32_t valid_mask(int zc, int w) {
  const int n = zc - 32 * w;
  return n >= 32 ? ~0u : (1u << n) - 1u;
}

__device__ __forceinline__ void set_bit(uint32_t* s_cw, int nw, int zc, int k) {
  const int col = k / zc, z = k - col * zc;
  s_cw[col * nw + (z >> 5)] |= 1u << (z & 31);
}

__device__ __forceinline__ uint32_t warp_xor(uint32_t x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x ^= __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// XOR of the rotated column vectors of one row's edges with columns in
// [0, col_end), word w.
__device__ __forceinline__ uint32_t row_word(const uint32_t* s_cw, const int32_t* s_edge,
                                             int e0, int e1, int col_end, int nw, int zc,
                                             int w) {
  uint32_t x = 0;
  for (int e = e0; e < e1; ++e) {
    const int col = s_edge[e] >> 16;
    if (col < col_end) x ^= rot_word(s_cw + col * nw, nw, zc, w, s_edge[e] & 0xffff);
  }
  return x;
}

__global__ void __launch_bounds__(kThreads) pdsch_encode_kernel(EncodeArgs a) {
  extern __shared__ uint32_t smem[];
  const int nw = (a.zc + 31) >> 5;
  const int cols_used = a.kb + a.rows_used;
  const int n_tab = a.rows + 1 + a.n_edges + 5 + a.n_core;
  uint32_t* s_cw = smem;                                    // [cols_used][nw]
  uint32_t* s_lam = s_cw + cols_used * nw;                  // [4][nw] core row sums
  uint32_t* s_acc = s_lam + 4 * nw;                         // TB CRC, CB CRC
  int32_t* s_tab = reinterpret_cast<int32_t*>(s_acc + 2);
  const int32_t* s_rs = s_tab;
  const int32_t* s_edge = s_tab + a.rows + 1;
  const int32_t* s_cs = s_edge + a.n_edges;
  const int32_t* s_term = s_cs + 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;

  const int cb = a.cb0 + blockIdx.x;
  const int tb = cb / a.c, r = cb - tb * a.c;
  const int8_t* pay = a.payload + size_t(tb) * a.a;
  const int base = r * a.p;                   // the codeblock's first TB-stream bit
  const int n_pay = min(a.p, a.a - base);     // payload bits in it (the rest: TB CRC)
  const bool last = r == a.c - 1;

  for (int i = tid; i < n_tab; i += blockDim.x) s_tab[i] = a.tables[i];
  if (tid < 2) s_acc[tid] = 0;

  // Message columns 0..kb-1: payload bits, zeros where the CRCs and fillers go.
  uint32_t acc_cb = 0, acc_tb = 0;
#pragma unroll 4
  for (int task = warp; task < a.kb * nw; task += nwarps) {
    const int col = task / nw, z = 32 * (task - col * nw) + lane;
    const int k = col * a.zc + z;
    bool bit = false;
    if (z < a.zc && k < n_pay) {
      const uint32_t w = a.cb_crc ? a.crc_cb[k] : 0u;
      bit = pay[base + k] & 1;
      if (bit) acc_cb ^= w;
    }
    const uint32_t word = __ballot_sync(0xffffffffu, bit);
    if (lane == 0) s_cw[task] = word;
  }
  if (last) {
#pragma unroll 8
    for (int t = tid; t < a.a; t += blockDim.x) {
      const uint32_t w = a.crc_tb[t];  // loaded whatever the bit: no second round trip
      if (pay[t] & 1) acc_tb ^= w;
    }
  }
  acc_cb = warp_xor(acc_cb);
  acc_tb = warp_xor(acc_tb);
  __syncthreads();  // s_acc zeroed, message words written
  if (lane == 0) {
    atomicXor(&s_acc[0], acc_tb);
    atomicXor(&s_acc[1], acc_cb);
  }
  __syncthreads();
  if (tid == 0) {
    uint32_t cbr = s_acc[1];
    if (last) {
      const uint32_t tbr = s_acc[0];
      for (int i = 0; i < a.l_tb; ++i) {
        if (!((tbr >> (a.l_tb - 1 - i)) & 1u)) continue;
        const int k = a.a + i - base;
        set_bit(s_cw, nw, a.zc, k);
        if (a.cb_crc) cbr ^= a.crc_cb[k];
      }
    }
    if (a.cb_crc)
      for (int i = 0; i < 24; ++i)
        if ((cbr >> (23 - i)) & 1u) set_bit(s_cw, nw, a.zc, a.p + i);
  }
  __syncthreads();

  // Core rows' message sums, then the core parities p_j = XOR rot(s_i, t).
  for (int task = tid; task < 4 * nw; task += blockDim.x) {
    const int row = task / nw, w = task - row * nw;
    s_lam[task] = row_word(s_cw, s_edge, s_rs[row], s_rs[row + 1], a.kb, nw, a.zc, w) &
                  valid_mask(a.zc, w);
  }
  __syncthreads();
  for (int task = tid; task < 4 * nw; task += blockDim.x) {
    const int j = task / nw, w = task - j * nw;
    uint32_t x = 0;
    for (int t = s_cs[j]; t < s_cs[j + 1]; ++t)
      x ^= rot_word(s_lam + (s_term[t] >> 16) * nw, nw, a.zc, w, s_term[t] & 0xffff);
    s_cw[(a.kb + j) * nw + w] = x & valid_mask(a.zc, w);
  }
  __syncthreads();
  // Extension parities: each row's sum over the message and core columns.
  for (int task = tid; task < (a.rows_used - 4) * nw; task += blockDim.x) {
    const int row = 4 + task / nw, w = task - (row - 4) * nw;
    s_cw[(a.kb + row) * nw + w] =
        row_word(s_cw, s_edge, s_rs[row], s_rs[row + 1], a.kb + 4, nw, a.zc, w) &
        valid_mask(a.zc, w);
  }
  __syncthreads();

  // Rate match: four output bits per thread where E allows (E % 4 == 0).
  int8_t* out = a.out + size_t(blockIdx.x) * a.e;
  if ((a.e & 3) == 0) {
    const ushort4* adr4 = reinterpret_cast<const ushort4*>(a.rm_addr);
    char4* out4 = reinterpret_cast<char4*>(out);
#pragma unroll 4
    for (int i = tid; i < (a.e >> 2); i += blockDim.x) {
      const ushort4 q = adr4[i];
      out4[i] = make_char4(static_cast<signed char>((s_cw[q.x >> 5] >> (q.x & 31)) & 1u),
                           static_cast<signed char>((s_cw[q.y >> 5] >> (q.y & 31)) & 1u),
                           static_cast<signed char>((s_cw[q.z >> 5] >> (q.z & 31)) & 1u),
                           static_cast<signed char>((s_cw[q.w >> 5] >> (q.w & 31)) & 1u));
    }
  } else {
    for (int k = tid; k < a.e; k += blockDim.x) {
      const int q = a.rm_addr[k];
      out[k] = static_cast<int8_t>((s_cw[q >> 5] >> (q & 31)) & 1u);
    }
  }
}

struct ModulateArgs {
  const int8_t* bits;        // (rows, g) bits
  const long long* c_init;   // (rows,) scrambling initialisers (the low 31 bits)
  const uint32_t* x1;        // (nwg,) packed x1(n + Nc)
  const uint32_t* basis;     // (31, nwg) packed x2(n + Nc) of c_init = e_i
  const float2* table;       // (2^qm,) symbols by bit pattern, b_0 in the lowest bit
  float2* out;               // (rows, g / qm)
  int rows, g, qm;
};

__global__ void __launch_bounds__(kThreads) pdsch_modulate_kernel(ModulateArgs a) {
  extern __shared__ uint32_t smem[];
  const int nwg = (a.g + 31) >> 5;
  uint32_t* s_bits = smem;                                   // [nwg] scrambled bits
  float2* s_tab = reinterpret_cast<float2*>(s_bits + nwg + (nwg & 1));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int row = blockIdx.x;
  const int8_t* b = a.bits + size_t(row) * a.g;
  const uint32_t ci = uint32_t(a.c_init[row]) & 0x7fffffffu;

  for (int i = tid; i < (1 << a.qm); i += blockDim.x) s_tab[i] = a.table[i];
  // A warp packs 32 words (lane i keeps word i), then each lane scrambles its own.
  for (int grp = warp; grp * 32 < nwg; grp += nwarps) {
    const int w0 = grp * 32;
    uint32_t mine = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) {  // unrolled: the 32 loads are in flight together
      const int k = 32 * (w0 + i) + lane;
      const uint32_t m = __ballot_sync(0xffffffffu, k < a.g && (b[k] & 1));
      if (lane == i) mine = m;
    }
    const int w = w0 + lane;
    if (w < nwg) {
      uint32_t seq = a.x1[w];
#pragma unroll
      for (int i = 0; i < 31; ++i)
        if ((ci >> i) & 1u) seq ^= a.basis[size_t(i) * nwg + w];
      s_bits[w] = mine ^ seq;
    }
  }
  __syncthreads();
  const int nsym = a.g / a.qm;
  const uint32_t mask = (1u << a.qm) - 1u;
  float2* o = a.out + size_t(row) * nsym;
  for (int m = tid; m < nsym; m += blockDim.x) {
    const int q = m * a.qm, k = q >> 5, sh = q & 31;
    uint32_t v = s_bits[k] >> sh;
    if (sh + a.qm > 32) v |= s_bits[k + 1] << (32 - sh);
    o[m] = s_tab[v & mask];
  }
}

// Shared memory of one CTA (bytes): at most 5 KB for the encoder (BG1,
// Zc = 384); G / 8 + 2 KB for the modulator, which opts in above 48 KB.
size_t encode_smem_bytes(int zc, int kb, int rows, int rows_used, int n_edges, int n_core) {
  const int nw = (zc + 31) / 32;
  return sizeof(uint32_t) * (size_t((kb + rows_used) * nw + 4 * nw + 2) + rows + 1 + n_edges +
                             5 + n_core);
}

size_t modulate_smem_bytes(int g, int qm) {
  const int nwg = (g + 31) / 32;
  return sizeof(uint32_t) * size_t(nwg + (nwg & 1)) + sizeof(float2) * (size_t(1) << qm);
}

}  // namespace

extern "C" {

// Codeblocks cb0 .. cb0 + n_out - 1 of the TBs in `payload` (codeblock i of
// TB t is t * c + i) -> out (n_out, e).  Returns a cudaError_t (0: launched).
int pdsch_encode(const int8_t* payload, int8_t* out, const int32_t* tables,
                 const uint32_t* crc_tb, const uint32_t* crc_cb, const uint16_t* rm_addr,
                 int n_out, int cb0, int a, int c, int p, int l_tb, int cb_crc, int zc, int kb,
                 int rows, int rows_used, int n_edges, int n_core, int e, void* stream) {
  if (n_out == 0) return 0;
  if (zc < 1 || zc > kMaxZc || c < 1 || rows_used < 4 || rows_used > rows || e < 1 ||
      (cb_crc && crc_cb == nullptr))
    return int(cudaErrorInvalidValue);
  const EncodeArgs args{payload, out, tables, crc_tb, crc_cb, rm_addr, n_out, cb0, a, c, p,
                        l_tb, cb_crc, zc, kb, rows, rows_used, n_edges, n_core, e};
  const size_t smem = encode_smem_bytes(zc, kb, rows, rows_used, n_edges, n_core);
  pdsch_encode_kernel<<<n_out, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args);
  return int(cudaGetLastError());
}

// (rows, g) bits scrambled by the rows' Gold sequences and mapped Qm bits at
// a time -> out (rows, g / qm) complex64.  Returns a cudaError_t.
int pdsch_modulate(const int8_t* bits, const long long* c_init, const uint32_t* x1,
                   const uint32_t* basis, const void* table, void* out, int rows, int g, int qm,
                   void* stream) {
  if (rows == 0) return 0;
  if (qm < 1 || qm > kMaxQm || g < 1 || g % qm) return int(cudaErrorInvalidValue);
  const ModulateArgs args{bits, c_init, x1, basis, static_cast<const float2*>(table),
                          static_cast<float2*>(out), rows, g, qm};
  const size_t smem = modulate_smem_bytes(g, qm);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pdsch_modulate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  pdsch_modulate_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args);
  return int(cudaGetLastError());
}

}  // extern "C"
