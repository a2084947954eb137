"""PDSCH coding's two CUDA kernels (``ops/pdsch_code.py``,
``csrc/pdsch_code.cu``).

On the CPU: the tables the kernels read (base-graph edges and the core
solve's rotation terms, CRC remainder words, rate-match bit addresses, the
packed Gold basis, the symbol table) and a numpy model of the kernels'
packed-word schedule, held to the plain chain (``segmenter``, ``encoder``,
``rate_match``, ``sequences``, ``modulation``) bit for bit; ``_dl_code`` on
CPU tensors still runs that chain.  On the card (``-m cuda``; skipped on a
host without a CUDA device): both kernels against the plain chain bit for
bit at the cells' shapes, a BG2 TB with CRC16, Qm 1 to 8, rv 1-3, an LBRM
buffer and a mesh's split; two launches of each per full DL step; and the
wrapper's refusals.

The JAX package codes the PDSCH too (its ``slot_pipeline._dl_code``).  A
card's machine need not have JAX, so the comparison goes through
``JAX_DL_CODE_SHA256``, the digests of the JAX package's symbols on the
cases' inputs: on the CPU the JAX package recomputes them (and the port's
plain chain equals its symbols), on the card the port's ``_dl_code`` must
give the same digests.  JAX is imported only inside those CPU tests.
"""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from srsran_edgeric_5g_tpu_torch import cuda_build
from srsran_edgeric_5g_tpu_torch.ops import (crc, modulation, pdsch_code,
                                             sequences)
from srsran_edgeric_5g_tpu_torch.ops.ldpc import encoder, rate_match, segmenter
from srsran_edgeric_5g_tpu_torch.ops.ldpc.graph import get_graph, lifting_sizes
from srsran_edgeric_5g_tpu_torch.parallel import full_cell as fcm
from srsran_edgeric_5g_tpu_torch.parallel import slot_pipeline as sp

torch.set_num_threads(2)

RNTIS = 0x4601 + np.arange(4, dtype=np.int64)
SISO, MIMO = fcm.FullCellConfig(), fcm.FullCellConfig(n_layers=2)


def _small(mod, prb):
    return sp.CellConfig(nof_prb=52, nfft=768, nof_ue=2, prb_per_ue=prb,
                         modulation=mod, target_rate=0.5)


def _odd_e_plans():
    """BG2, CRC16, C = 1 and E = 482: E % 4 != 0 takes the kernel's one-bit
    rate-match path."""
    seg = segmenter.get_segment_plan(100, 2, 482, 2)
    return seg, rate_match.get_rate_match_plan(seg.bg, seg.zc, seg.e[0], 0, 2,
                                               seg.k_prime)


def _plans(case):
    if case == "odd_e_bg2":
        return _odd_e_plans()
    cell, rv = ENCODE_CASES[case]
    return sp._plans(cell, rv)


# name -> (cell, rv): the four shapes of the benchmark's cells, then BG2 with
# CRC16 (QPSK), QAM16 / QAM256 at rv 1 / 2, and rv 3 over an LBRM buffer
# shorter than E (bits repeat).
ENCODE_CASES = {
    "siso_normal": (SISO.dl_cell(), 0),          # BG1 Zc 208, C 2, E 9000
    "siso_ssb": (SISO.dl_cell_ssb(), 0),         # Zc 256, C 1, no CB CRC
    "mimo_normal": (MIMO.dl_cell_mimo(), 0),     # Zc 288, C 3, E 12000
    "mimo_ssb": (MIMO.dl_cell_ssb_mimo(), 0),    # Zc 256, C 2
    "bg2_crc16_qpsk": (_small("qpsk", 4), 0),    # BG2 Zc 64, CRC16
    "qam16_rv1": (_small("qam16", 25), 1),
    "qam256_rv2": (_small("qam256", 25), 2),     # C 2, Zc 288
    "lbrm_rv3": (dataclasses.replace(SISO.dl_cell(), tbs_lbrm=8968), 3),
}
ALL_ENCODE = [*ENCODE_CASES, "odd_e_bg2"]

# sha256 of the JAX package's ``_dl_code`` symbols (complex64, as bytes) on
# each case's ``_dl_inputs``; test_jax_package_gives_the_digests holds them
# to the JAX package.
JAX_DL_CODE_SHA256 = {
    "siso_normal": "6483135623dd1c97ab5d7ea9723c823992715ff4d8e6801f74af120bee26e694",
    "siso_ssb": "0dfc64bf2faaf9da9ffb46bc488feb54822ae384aae076c250642d8de35e08dc",
    "mimo_normal": "b3249c33b4f3ba5fd483f25612bb8e9fc0e75ad6c2e444558589299303301888",
    "mimo_ssb": "335cd8580814c6648d6a2d7dbacab701a8243f584572e14ea262c8c672e68d0d",
    "bg2_crc16_qpsk": "ed86002d60ecb7054e66a680dd89ff53a9c1736d1f7e714377f2df5888c9f17d",
    "qam16_rv1": "4ff8579effb7388ec5ce91ef96743e40f0b8d0ef69d0051b676ce4cd7c239f93",
    "qam256_rv2": "f2f246583eeb328613283860897f50531aad21a546e26edd98dd34d618cfc686",
    "lbrm_rv3": "01e46a65665bded9ce8456e691621835d33c6fc31a3010b05a354c1cd7e8a48e",
}


# ------------------------------------------------ numpy model of the kernels

def _words(bits: np.ndarray) -> np.ndarray:
    """(..., n) bits -> (..., ceil(n/32)) uint64 words, bit i in word i // 32."""
    n = bits.shape[-1]
    nw = -(-n // 32)
    b = np.zeros((*bits.shape[:-1], nw * 32), dtype=np.uint64)
    b[..., :n] = bits
    return (b.reshape(*bits.shape[:-1], nw, 32)
            << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint64)


def _bits(words: np.ndarray, n: int) -> np.ndarray:
    b = (words[..., None] >> np.arange(32, dtype=np.uint64)) & 1
    return b.reshape(*words.shape[:-1], -1)[..., :n].astype(np.int8)


def _rot(v: np.ndarray, zc: int, s: int) -> np.ndarray:
    """The kernel's rot_word for every word: (B, nw) -> (B, nw), lanes past
    Zc cleared."""
    nw = v.shape[-1]
    out = np.zeros_like(v)
    for w in range(nw):
        p = 32 * w + s
        if p >= zc:
            p -= zc
        k = p >> 5
        hi = v[:, k + 1] if k + 1 < nw else v[:, 0]
        r = (((hi << np.uint64(32)) | v[:, k]) >> np.uint64(p & 31)) & np.uint64(0xFFFFFFFF)
        left = zc - p
        if left < 32:
            r = (r & np.uint64((1 << left) - 1)) | ((v[:, 0] << np.uint64(left))
                                                    & np.uint64(0xFFFFFFFF))
        out[:, w] = r
    return out & _valid(zc, nw)


def _valid(zc: int, nw: int) -> np.ndarray:
    return np.array([(1 << min(32, zc - 32 * w)) - 1 for w in range(nw)], dtype=np.uint64)


def _tables(bg: int, zc: int):
    g = get_graph(bg, zc)
    t = pdsch_code.encode_tables(bg, zc)
    rs = t[:g.rows + 1]
    edges = t[g.rows + 1:g.rows + 1 + g.num_edges]
    cs = t[g.rows + 1 + g.num_edges:g.rows + 6 + g.num_edges]
    terms = t[g.rows + 6 + g.num_edges:]
    return g, rs, edges, cs, terms


def model_encode(msg: np.ndarray, bg: int, zc: int, rows_used: int | None = None):
    """The encoder kernel's schedule on (B, K) message bits -> (B, cols_used,
    nw) words: core rows' message sums, the core solve's rotation terms,
    extension rows over the message and core columns."""
    g, rs, edges, cs, terms = _tables(bg, zc)
    rows_used = g.rows if rows_used is None else rows_used
    nw, b, kb = -(-zc // 32), msg.shape[0], g.kb
    cols = np.zeros((b, kb + rows_used, nw), dtype=np.uint64)
    cols[:, :kb] = _words(msg.reshape(b, kb, zc))

    def row(r, col_end):
        x = np.zeros((b, nw), dtype=np.uint64)
        for e in edges[rs[r]:rs[r + 1]]:
            if e >> 16 < col_end:
                x ^= _rot(cols[:, e >> 16], zc, int(e & 0xFFFF))
        return x

    lam = [row(r, kb) for r in range(4)]
    for j in range(4):
        x = np.zeros((b, nw), dtype=np.uint64)
        for t in terms[cs[j]:cs[j + 1]]:
            x ^= _rot(lam[t >> 16], zc, int(t & 0xFFFF))
        cols[:, kb + j] = x
    for r in range(4, rows_used):
        cols[:, kb + r] = row(r, kb + 4)
    return cols


def model_messages(payload: np.ndarray, seg, cbs: range) -> np.ndarray:
    """The encoder kernel's message of each codeblock in ``cbs``: its share
    of the payload, the TB CRC (last codeblock) and CRC24B from the
    remainder words, filler zeros."""
    p = seg.k_prime - (24 if seg.cb_crc else 0)
    l_tb = pdsch_code.CRC_LEN[seg.tb_crc]
    w_tb = pdsch_code.crc_words(seg.tb_crc, seg.a)
    w_cb = pdsch_code.crc_words("crc24b", p) if seg.cb_crc else None
    xor = lambda w, sel: int(np.bitwise_xor.reduce(w[sel], initial=np.uint32(0)))
    out = np.zeros((len(cbs), seg.k), dtype=np.int8)
    for n, cb in enumerate(cbs):
        tb, r = divmod(cb, seg.c)
        base, pay = r * p, payload[tb] & 1
        n_pay = min(p, seg.a - base)
        msg = out[n]
        msg[:n_pay] = pay[base:base + n_pay]
        acc = xor(w_cb[:n_pay], msg[:n_pay] == 1) if seg.cb_crc else 0
        if r == seg.c - 1:
            tbr = xor(w_tb, pay == 1)
            for i in range(l_tb):
                if tbr >> (l_tb - 1 - i) & 1:
                    msg[seg.a + i - base] = 1
                    acc ^= int(w_cb[seg.a + i - base]) if seg.cb_crc else 0
        if seg.cb_crc:
            msg[p:p + 24] = (acc >> np.arange(23, -1, -1)) & 1
    return out


def model_pdsch_encode(payload: np.ndarray, seg, rm, cbs: range) -> np.ndarray:
    addr, rows_used = pdsch_code.rm_addresses(rm)
    words = model_encode(model_messages(payload, seg, cbs), seg.bg, seg.zc,
                         rows_used).reshape(len(cbs), -1)
    a = addr.astype(np.int64)
    return ((words[:, a >> 5] >> (a & 31).astype(np.uint64)) & 1).astype(np.int8)


def model_modulate(bits: np.ndarray, c_init: np.ndarray, qm: int) -> np.ndarray:
    rows, g = bits.shape
    x1, basis = (w.astype(np.uint64) for w in pdsch_code.gold_words(g))
    seq = np.broadcast_to(x1, (rows, len(x1))).copy()
    for i in range(31):
        seq ^= np.where(((c_init >> i) & 1)[:, None] == 1, basis[i], 0).astype(np.uint64)
    scr = _bits(_words(bits) ^ seq, g).reshape(rows, g // qm, qm).astype(np.int64)
    idx = (scr << np.arange(qm)).sum(-1)
    return pdsch_code.symbol_table(qm)[idx]


def _payload(seg, n_tb, seed):
    return np.random.default_rng(seed).integers(0, 2, (n_tb, seg.a), dtype=np.int8)


def _dl_inputs(case):
    """(cell, rv, (3, U, TBS) payloads, (U,) RNTIs): three slots of a case."""
    cell, rv = ENCODE_CASES[case]
    seg, _ = sp._plans(cell, rv)
    pay = _payload(seg, 3 * cell.nof_ue, 11).reshape(3, cell.nof_ue, -1)
    return cell, rv, pay, RNTIS[:cell.nof_ue]


def _sha256(syms) -> str:
    return hashlib.sha256(np.ascontiguousarray(syms).tobytes()).hexdigest()


def _jax_cell(case):
    """The JAX package's CellConfig of a case, built from its own
    configurations."""
    from srsran_edgeric_5g_tpu.parallel import full_cell as jfc
    from srsran_edgeric_5g_tpu.parallel import slot_pipeline as jsp
    siso, mimo = jfc.FullCellConfig(), jfc.FullCellConfig(n_layers=2)
    small = lambda mod, prb: jsp.CellConfig(nof_prb=52, nfft=768, nof_ue=2,
                                            prb_per_ue=prb, modulation=mod,
                                            target_rate=0.5)
    return {"siso_normal": siso.dl_cell, "siso_ssb": siso.dl_cell_ssb,
            "mimo_normal": mimo.dl_cell_mimo, "mimo_ssb": mimo.dl_cell_ssb_mimo,
            "bg2_crc16_qpsk": lambda: small("qpsk", 4),
            "qam16_rv1": lambda: small("qam16", 25),
            "qam256_rv2": lambda: small("qam256", 25),
            "lbrm_rv3": lambda: dataclasses.replace(siso.dl_cell(), tbs_lbrm=8968),
            }[case]()


# -------------------------------------------------------------- CPU tests

@pytest.mark.parametrize("bg,zc", [(bg, z) for bg in (1, 2) for z in lifting_sizes()])
def test_packed_schedule_equals_encode(bg, zc):
    """Rotation, XOR row sums and the core solve's rotation terms give the
    plain encoder's codeword at every lifting size of both base graphs."""
    g = get_graph(bg, zc)
    msg = np.random.default_rng(zc).integers(0, 2, (2, g.k), dtype=np.int8)
    cw = encoder.encode(torch.as_tensor(msg), bg, zc).numpy()
    assert np.array_equal(_bits(model_encode(msg, bg, zc), zc).reshape(2, -1), cw)


def test_core_solve_has_twenty_terms_at_every_lifting_size():
    n = [len(_tables(bg, z)[4]) for bg in (1, 2) for z in lifting_sizes()]
    assert set(n) == {20}


@pytest.mark.parametrize("name,n", [("crc16", 37), ("crc16", 3104), ("crc24a", 5376),
                                    ("crc24a", 8968), ("crc24b", 4496), ("crc24b", 61)])
def test_crc_words_reproduce_crc_attach(name, n):
    bits = np.random.default_rng(n).integers(0, 2, (4, n), dtype=np.int8)
    bits[0] = 0
    w = pdsch_code.crc_words(name, n)
    length = crc.BY_NAME[name][1]
    for row, ref in zip(bits, crc.crc_attach(torch.as_tensor(bits), name).numpy()):
        r = int(np.bitwise_xor.reduce(w[row == 1], initial=np.uint32(0)))
        assert np.array_equal((r >> np.arange(length - 1, -1, -1)) & 1, ref[n:])
        assert np.array_equal(ref[n:], crc.np_crc(row, name))


@pytest.mark.parametrize("length", [1, 31, 33, 1000, 10800, 18000])
def test_packed_gold_basis_reproduces_gold_sequence(length):
    ci = np.array([0, 1, 2 ** 31 - 1, (0x4601 << 15) + 1, 123456789], dtype=np.int64)
    x1, basis = (w.astype(np.uint64) for w in pdsch_code.gold_words(length))
    ref = sequences.gold_sequence(torch.as_tensor(ci), length).numpy()
    for c, r in zip(ci, ref):
        seq = x1.copy()
        for i in range(31):
            if c >> i & 1:
                seq ^= basis[i]
        assert np.array_equal(_bits(seq, length), r)


@pytest.mark.parametrize("qm", [1, 2, 4, 6, 8])
def test_symbol_table_equals_modulate_on_every_bit_pattern(qm):
    idx = np.arange(1 << qm)
    bits = torch.as_tensor(((idx[:, None] >> np.arange(qm)) & 1).reshape(-1), dtype=torch.int8)
    ref = modulation.modulate(bits, modulation.NAME_BY_QM[qm]).numpy()
    tab = pdsch_code.symbol_table(qm)
    assert tab.dtype == np.complex64 and tab.view(np.uint64).tolist() == ref.view(np.uint64).tolist()


@pytest.mark.parametrize("g,qm", [(18000, 6), (42, 6), (480, 2), (1920, 4), (33, 1), (2048, 8)])
def test_modulate_model_equals_plain_chain(g, qm):
    """The modulate kernel's schedule (packed bits XOR the packed Gold
    words, Qm bits through the table) gives the plain chain's symbols."""
    rng = np.random.default_rng(g)
    bits = rng.integers(0, 2, (5, g), dtype=np.int8)
    ci = np.concatenate([[0, 2 ** 31 - 1], (RNTIS[:3] << 15) + 1])
    ref = pdsch_code.modulate(torch.as_tensor(bits), torch.as_tensor(ci),
                              modulation.NAME_BY_QM[qm]).numpy()
    assert np.array_equal(model_modulate(bits, ci, qm).view(np.uint64), ref.view(np.uint64))


@pytest.mark.parametrize("case", ALL_ENCODE)
def test_encode_model_equals_plain_chain(case):
    """The encode kernel's schedule (message words, CRC remainder words,
    encode, rate-match addresses) gives the plain chain's bits: every TB's
    codeblocks, and a mesh's run that starts in the middle of a TB."""
    seg, rm = _plans(case)
    pay = _payload(seg, 3, seed=len(case))
    n = 3 * seg.c
    for cbs in (range(n), range(1, min(n, 4))):
        ref = pdsch_code.encode(torch.as_tensor(pay), seg, rm,
                                slice(cbs.start, cbs.stop)).numpy()
        assert np.array_equal(model_messages(pay, seg, cbs),
                              segmenter.segment_tb(torch.as_tensor(pay), seg)[
                                  cbs.start:cbs.stop].numpy())
        assert np.array_equal(model_pdsch_encode(pay, seg, rm, cbs), ref)


def test_rate_match_addresses_fit_and_trim_rows():
    """The addresses fit uint16 at the largest buffer, and the kernel skips
    the extension rows no rate-matched bit reaches (the SISO cell reads 24
    of BG1's 46 rows at rv 0, every row at rv 3)."""
    rm = rate_match.get_rate_match_plan(1, 384, 30000, 0, 6, 8448)
    addr, rows = pdsch_code.rm_addresses(rm)
    assert addr.max() < 2 ** 16 and rows == 46
    seg, rm = sp._plans(SISO.dl_cell())
    assert pdsch_code.rm_addresses(rm)[1] == 24
    assert pdsch_code.rm_addresses(sp._plans(SISO.dl_cell(), 3)[1])[1] == 46


def test_dl_code_on_cpu_runs_the_plain_chain():
    """On CPU tensors ``_dl_code`` is segment -> encode -> rate match ->
    scramble -> modulate, and launches nothing."""
    cell = SISO.dl_cell()
    seg, rm = sp._plans(cell)
    pay = torch.as_tensor(_payload(seg, 2 * cell.nof_ue, 7)).reshape(2, cell.nof_ue, -1)
    rntis = torch.as_tensor(RNTIS)
    before = dict(cuda_build.LAUNCHES)
    syms = sp._dl_code(pay, rntis, cell)
    assert dict(cuda_build.LAUNCHES) == before
    cw = encoder.encode(segmenter.segment_tb(pay.reshape(-1, seg.a), seg), seg.bg, seg.zc)
    bits = rate_match.rate_match(cw, rm).reshape(2 * cell.nof_ue, -1)
    ci = ((rntis << 15) + cell.n_id).repeat(2)
    ref = modulation.modulate(sequences.scramble_bits(bits, ci), cell.modulation)
    assert torch.equal(syms, ref)


@pytest.mark.parametrize("case", list(ENCODE_CASES))
def test_jax_package_gives_the_digests(case):
    """The JAX package's ``_dl_code`` on a case's inputs (its own cell
    configuration, which converts to the port's) gives the digest the card
    test holds the kernels to, and the port's plain chain its symbols bit
    for bit."""
    import jax.numpy as jnp
    from srsran_edgeric_5g_tpu.parallel import slot_pipeline as jsp
    from srsran_edgeric_5g_tpu_torch import convert
    cell, rv, pay, rntis = _dl_inputs(case)
    jc = _jax_cell(case)
    assert convert.cell_from_dict(dataclasses.asdict(jc)) == cell
    ref = np.asarray(jsp._dl_code(jnp.asarray(pay.reshape(-1, pay.shape[-1])),
                                  jnp.asarray(rntis.astype(np.uint32)), jc, rv))
    assert _sha256(ref) == JAX_DL_CODE_SHA256[case]
    got = sp._dl_code(torch.as_tensor(pay), torch.as_tensor(rntis), cell, rv).numpy()
    assert got.dtype == ref.dtype and np.array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_wrappers_refuse_a_device_with_no_kernel():
    seg, rm = _plans("bg2_crc16_qpsk")
    with pytest.raises(ValueError, match="no pdsch_encode kernel"):
        pdsch_code.encode(torch.zeros((1, seg.a), dtype=torch.int8, device="meta"),
                          seg, rm, slice(0, 1))
    with pytest.raises(ValueError, match="no pdsch_modulate kernel"):
        pdsch_code.modulate(torch.zeros((1, 8), dtype=torch.int8, device="meta"),
                            torch.zeros(1, dtype=torch.int64), "qpsk")


# ------------------------------------------------------------- card tests

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the PDSCH kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ALL_ENCODE)
def test_encode_kernel_equals_plain_chain(cuda_device, case):
    """pdsch_encode's bits equal the plain chain's: every codeblock of 37
    TBs, and runs of codeblocks as a mesh's ranks take them (each from the
    TBs that hold it)."""
    seg, rm = _plans(case)
    pay = _payload(seg, 37, seed=len(case))
    n = 37 * seg.c
    ref = pdsch_code.encode(torch.as_tensor(pay), seg, rm, slice(0, n))
    before = cuda_build.LAUNCHES[pdsch_code.KERNEL_ENCODE]
    got = pdsch_code.encode(torch.as_tensor(pay, device=cuda_device), seg, rm, slice(0, n))
    assert cuda_build.LAUNCHES[pdsch_code.KERNEL_ENCODE] == before + 1
    assert torch.equal(got.cpu(), ref)
    for lo, hi in ((1, 4), (n // 2 - 1, n // 2 + 2), (n - 1, n), (5, 5)):
        t0, t1 = lo // seg.c, -(-hi // seg.c)
        own = slice(lo - t0 * seg.c, hi - t0 * seg.c)
        part = pdsch_code.encode(torch.as_tensor(pay[t0:max(t1, t0 + 1)], device=cuda_device),
                                 seg, rm, own)
        assert torch.equal(part.cpu(), ref[lo:hi])


@pytest.mark.cuda
@pytest.mark.parametrize("g,qm", [(18000, 6), (10800, 6), (36000, 6), (21600, 6),
                                  (42, 6), (480, 2), (1920, 4), (33, 1), (24000, 8)])
def test_modulate_kernel_equals_plain_chain(cuda_device, g, qm):
    """pdsch_modulate's symbols equal the plain chain's bit for bit, for
    every row and for a mesh's block of rows."""
    rng = np.random.default_rng(g)
    bits = torch.as_tensor(rng.integers(0, 2, (37, g), dtype=np.int8))
    ci = torch.as_tensor(np.concatenate([[0, 2 ** 31 - 1], rng.integers(0, 2 ** 31, 35)]))
    name = modulation.NAME_BY_QM[qm]
    ref = pdsch_code.modulate(bits, ci, name)
    before = cuda_build.LAUNCHES[pdsch_code.KERNEL_MODULATE]
    got = pdsch_code.modulate(bits.to(cuda_device), ci.to(cuda_device), name)
    assert cuda_build.LAUNCHES[pdsch_code.KERNEL_MODULATE] == before + 1
    assert torch.equal(got.cpu().view(torch.float32), ref.view(torch.float32))
    part = pdsch_code.modulate(bits[5:9].to(cuda_device), ci[5:9].to(cuda_device), name)
    assert torch.equal(part.cpu().view(torch.float32), ref[5:9].view(torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["siso_normal", "mimo_normal", "qam256_rv2"])
def test_dl_code_on_the_card_equals_cpu_with_no_plain_op(cuda_device, case, monkeypatch):
    """``_dl_code`` on CUDA tensors gives the CPU's symbols with the plain
    chain's functions made to raise: no fallback."""
    cell, rv, pay, rntis = _dl_inputs(case)
    ref = sp._dl_code(torch.as_tensor(pay), torch.as_tensor(rntis), cell, rv)
    args = (torch.as_tensor(pay, device=cuda_device),
            torch.as_tensor(rntis, device=cuda_device), cell, rv)
    sp._dl_code(*args)                      # the tables built

    def plain(*a, **k):
        raise AssertionError("the plain chain ran on CUDA tensors")

    for mod, name in ((encoder, "encode"), (segmenter, "segment_tb"),
                      (rate_match, "rate_match"), (sequences, "gold_sequence"),
                      (sequences, "scramble_bits"), (modulation, "modulate"),
                      (crc, "crc")):
        monkeypatch.setattr(mod, name, plain)
    got = sp._dl_code(*args)
    assert torch.equal(got.cpu().view(torch.float32), ref.view(torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ENCODE_CASES))
def test_dl_code_on_the_card_equals_the_jax_package(cuda_device, case):
    """``_dl_code`` on CUDA tensors (the two kernels) gives the JAX
    package's symbols: the four shapes of the cells, BG2 with CRC16, rv 1-3
    and an LBRM buffer."""
    cell, rv, pay, rntis = _dl_inputs(case)
    before = dict(cuda_build.LAUNCHES)
    got = sp._dl_code(torch.as_tensor(pay, device=cuda_device),
                      torch.as_tensor(rntis, device=cuda_device), cell, rv)
    for k in (pdsch_code.KERNEL_ENCODE, pdsch_code.KERNEL_MODULATE):
        assert cuda_build.LAUNCHES[k] == before.get(k, 0) + 1
    assert _sha256(got.cpu().numpy()) == JAX_DL_CODE_SHA256[case]


@pytest.mark.cuda
@pytest.mark.parametrize("fc", [SISO, MIMO], ids=["siso", "mimo2x2"])
def test_a_full_dl_step_launches_each_kernel_twice(cuda_device, fc):
    """One step of gnb_dl_slot_batch(_mimo): the normal and the SSB slots'
    coding, one launch of each kernel each."""
    from srsran_edgeric_5g_tpu_torch import bench
    s = 20
    x = bench.full_cell_inputs(fc, s, None, cuda_device)
    x["gnb_dl"](x["pay_n"], x["pay_s"], x["dci"], x["pbch"], fc, s, device=cuda_device)
    torch.cuda.synchronize()
    before = dict(cuda_build.LAUNCHES)
    x["gnb_dl"](x["pay_n"], x["pay_s"], x["dci"], x["pbch"], fc, s, device=cuda_device)
    torch.cuda.synchronize()
    after = dict(cuda_build.LAUNCHES)
    for k in (pdsch_code.KERNEL_ENCODE, pdsch_code.KERNEL_MODULATE):
        assert after.get(k, 0) - before.get(k, 0) == 2


@pytest.mark.cuda
def test_the_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    seg, rm = _plans("siso_normal")
    pay = torch.zeros((2, seg.a), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="payload must be"):
        pdsch_code.encode(pay[:, :-1], seg, rm, slice(0, 2))
    with pytest.raises(ValueError, match="a run"):
        pdsch_code.encode(pay, seg, rm, slice(0, 4, 2))
    with pytest.raises(ValueError, match="not the segment plan's"):
        pdsch_code.encode(pay, seg, _plans("siso_ssb")[1], slice(0, 2))
    bits = torch.zeros((2, 18000), dtype=torch.int8, device=cuda_device)
    ci = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of Qm"):
        pdsch_code.modulate(bits[:, :-1], ci, "qam64")
    with pytest.raises(ValueError, match="c_init must be"):
        pdsch_code.modulate(bits, ci[:1], "qam64")
