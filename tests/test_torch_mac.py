"""Parity of the port's MAC layer (``srsran_edgeric_5g_tpu_torch/mac``) and
the RAN helpers it uses with the JAX package's: the same seeded call
sequences through both packages give equal grants, reports, PDUs and
scheduling decisions.

Everything here is plain Python on the host: every comparison is exact.
"""

import dataclasses

import numpy as np
import pytest

from srsran_edgeric_5g_tpu.mac import bcch as jbcch, rach as jrach
from srsran_edgeric_5g_tpu.mac import scheduler as jmac
from srsran_edgeric_5g_tpu.mac import uci_allocator as juci, ul_procedures as julp
from srsran_edgeric_5g_tpu.ran import alloc as jalloc, numerology as jnum, tbs as jtbs
from srsran_edgeric_5g_tpu_torch import mac as tmac_pkg
from srsran_edgeric_5g_tpu_torch.mac import bcch as tbcch, rach as trach
from srsran_edgeric_5g_tpu_torch.mac import scheduler as tmac
from srsran_edgeric_5g_tpu_torch.mac import uci_allocator as tuci, ul_procedures as tulp
from srsran_edgeric_5g_tpu_torch.models import pdsch as tpdsch
from srsran_edgeric_5g_tpu_torch.ran import alloc as talloc, numerology as tnum, tbs as ttbs

RNTIS = [0x4601 + u for u in range(4)]


def _asdicts(xs):
    return [dataclasses.asdict(x) for x in xs]


# ---------------------------------------------------------------- ran


@pytest.mark.parametrize("n_size", [24, 52, 106, 273])
def test_riv_encode_decode(n_size):
    for start in range(n_size):
        for length in range(1, n_size - start + 1):
            riv = talloc.riv_encode(n_size, start, length)
            assert riv == jalloc.riv_encode(n_size, start, length)
            assert talloc.riv_decode(n_size, riv) == jalloc.riv_decode(n_size, riv) \
                == (start, length)


@pytest.mark.parametrize("table", ["qam64", "qam256", "qam64lowse"])
def test_tbs_for_alloc(table):
    for idx in range(32):
        try:
            mj = jtbs.mcs_config(idx, table)
        except ValueError:
            with pytest.raises(ValueError):
                ttbs.mcs_config(idx, table)
            continue
        mt = ttbs.mcs_config(idx, table)
        for n_prb in (1, 3, 8, 25, 52, 106, 273):
            for n_sym, n_dmrs in ((12, 24), (13, 12), (10, 36)):
                for layers in (1, 2):
                    assert ttbs.tbs_for_alloc(n_prb, n_sym, n_dmrs, mt, layers) == \
                        jtbs.tbs_for_alloc(n_prb, n_sym, n_dmrs, mj, layers)


def test_slots_per_subframe_and_frame():
    for mu in range(5):
        assert tnum.slots_per_subframe(mu) == jnum.slots_per_subframe(mu)
        assert tnum.slots_per_frame(mu) == jnum.slots_per_frame(mu)


# ---------------------------------------------------------- scheduler


@pytest.mark.parametrize("table", ["qam64", "qam256"])
def test_mcs_from_cqi(table):
    for cqi in range(-1, 18):
        assert tmac.mcs_from_cqi(cqi, table) == jmac.mcs_from_cqi(cqi, table)


@pytest.mark.parametrize("nof_prb", [25, 52, 106, 273])
def test_prbs_for_bytes_and_rbg_size(nof_prb):
    assert tmac.rbg_size_for_bwp(nof_prb) == jmac.rbg_size_for_bwp(nof_prb)
    assert tmac.rbg_size_for_bwp(nof_prb, 2) == jmac.rbg_size_for_bwp(nof_prb, 2)
    for idx in (0, 9, 17, 28):
        mj, mt = jtbs.mcs_config(idx), ttbs.mcs_config(idx)
        for nbytes in (0, 1, 100, 1500, 9000, 40000, 10 ** 6):
            assert tmac.prbs_for_bytes(nbytes, mt, 12, 24, nof_prb) == \
                jmac.prbs_for_bytes(nbytes, mj, 12, 24, nof_prb)


def _drive_scheduler(mac, ucimod, seed, policy, weights, mcs, uci, hysteresis,
                     slots=40, nof_prb=52):
    """A seeded sequence of arrivals, CSI reports, EdgeRIC weights and MCS
    overrides through one package's CellScheduler: per slot the DL grants,
    the UL grants and the EdgeRIC reports.  The draws do not depend on the
    scheduler's answers."""
    rng = np.random.default_rng(seed)
    cfg = mac.SchedulerConfig(nof_prb=nof_prb, policy=policy,
                              rbg_size=mac.rbg_size_for_bwp(nof_prb),
                              mcs_hysteresis=hysteresis)
    s = mac.CellScheduler(cfg, list(RNTIS),
                          uci_allocator=ucimod.UciAllocator() if uci else None)
    out = []
    for _ in range(slots):
        arr_dl = rng.poisson(3000, len(RNTIS))
        arr_ul = rng.poisson(800, len(RNTIS))
        csi = rng.random(len(RNTIS)) < 0.3
        cqis = rng.integers(0, 16, len(RNTIS))
        snrs = rng.normal(18.0, 6.0, len(RNTIS))
        w_on = rng.random(len(RNTIS)) < 0.8
        w_val = rng.random(len(RNTIS))
        m_on = rng.random(len(RNTIS)) < 0.5
        m_val = rng.integers(0, 32, len(RNTIS))
        apply_w, apply_m = rng.random() < 0.7, rng.random() < 0.6
        for u, r in enumerate(RNTIS):
            s.update_buffer(r, dl_bytes=s.ues[r].dl_buffer + int(arr_dl[u]),
                            ul_bytes=s.ues[r].ul_buffer + int(arr_ul[u]))
            if csi[u]:
                s.handle_csi(r, int(cqis[u]), float(snrs[u]))
        w = ({r: float(w_val[u]) for u, r in enumerate(RNTIS) if w_on[u]}
             if weights and apply_w else None)
        m = ({r: int(m_val[u]) for u, r in enumerate(RNTIS) if m_on[u]}
             if mcs and apply_m else None)
        dl = s.run_slot(weights=w, mcs_overrides=m)
        ul = s.run_slot_ul()
        out.append((_asdicts(dl), _asdicts(ul), _asdicts(s.ue_reports())))
    return out


@pytest.mark.parametrize("policy,weights,mcs,uci,hysteresis", [
    ("time_pf", False, False, False, 0),
    ("time_rr", False, False, False, 0),
    ("time_pf", True, False, False, 0),
    ("time_rr", True, False, False, 0),
    ("time_pf", False, True, False, 2),
    ("time_pf", True, True, True, 0),
    ("time_rr", True, True, True, 2),
])
def test_cell_scheduler_sequences(policy, weights, mcs, uci, hysteresis):
    ref = _drive_scheduler(jmac, juci, 7, policy, weights, mcs, uci, hysteresis)
    got = _drive_scheduler(tmac, tuci, 7, policy, weights, mcs, uci, hysteresis)
    assert got == ref
    assert sum(len(dl) for dl, _, _ in got) > 40          # the sequence grants
    if uci:
        assert any(g["pucch_res"] is not None for dl, _, _ in got for g in dl)


def _drive_harq(mac, seed, slots=30):
    """HARQ indications plumbed: UE 0x4601's DL TBs always NACK (retx at rv
    2, 3, 1, 1, then the drop at max retx), the others NACK at random; the
    UL CRCs the same way.  Per slot the DL and UL grants with the process
    states, and the dropped counts."""
    rng = np.random.default_rng(seed)
    cfg = mac.SchedulerConfig(nof_prb=52, rbg_size=4)
    s = mac.CellScheduler(cfg, list(RNTIS))
    s.enable_harq()
    out = []
    for _ in range(slots):
        nack_dl, nack_ul = rng.random(8) < 0.3, rng.random(8) < 0.3
        for r in RNTIS:
            s.update_buffer(r, dl_bytes=s.ues[r].dl_buffer + 2500,
                            ul_bytes=s.ues[r].ul_buffer + 600)
        dl, ul = s.run_slot(), s.run_slot_ul()
        for i, g in enumerate(dl):
            s.handle_dl_ack(g.rnti, g.pid, not (g.rnti == RNTIS[0] or nack_dl[i]))
        for i, g in enumerate(ul):
            s.handle_crc_indication(g.rnti, g.pid, not nack_ul[i])
        procs = [(p.pid, p.tx_count, p.pending_retx, p.awaiting_crc, p.busy)
                 for r in RNTIS for e in (s.ues[r].dl_harq, s.ues[r].ul_harq)
                 for p in e.procs]
        out.append((_asdicts(dl), _asdicts(ul), procs,
                    [(s.ues[r].dl_harq.nof_dropped, s.ues[r].ul_harq.nof_dropped)
                     for r in RNTIS]))
    return out


def test_harq_retx_and_drop():
    ref, got = _drive_harq(jmac, 3), _drive_harq(tmac, 3)
    assert got == ref
    rvs = [g["rv"] for dl, _, _, _ in got for g in dl
           if g["rnti"] == RNTIS[0] and g["is_retx"]]
    assert rvs[:4] == [2, 3, 1, 1]
    assert got[-1][3][0][0] > 0                  # UE 0x4601 dropped TBs
    assert any(g["is_retx"] for _, ul, _, _ in got for g in ul)


def test_harq_crc_timeout_and_auto_ack():
    """Without indications the scheduler auto-ACKs; an unanswered process
    self-frees after the CRC timeout."""
    for mac in (jmac, tmac):
        s = mac.CellScheduler(mac.SchedulerConfig(nof_prb=52), [RNTIS[0]])
        s.update_buffer(RNTIS[0], dl_bytes=10 ** 6)
        grants = [s.run_slot() for _ in range(3)]
        assert all(not p.busy for p in s.ues[RNTIS[0]].dl_harq.procs)
        s.enable_harq()
        for _ in range(12):
            s.update_buffer(RNTIS[0], dl_bytes=10 ** 6)
            grants.append(s.run_slot())
        if mac is jmac:
            ref = _asdicts(g for gs in grants for g in gs)
    assert _asdicts(g for gs in grants for g in gs) == ref


def test_to_pdsch_configs_and_exports():
    s_j = jmac.CellScheduler(jmac.SchedulerConfig(nof_prb=106, rbg_size=8), RNTIS)
    s_t = tmac.CellScheduler(tmac.SchedulerConfig(nof_prb=106, rbg_size=8), RNTIS)
    for u, r in enumerate(RNTIS):
        for s in (s_j, s_t):
            s.update_buffer(r, dl_bytes=2000 * (u + 1))
            s.handle_csi(r, 9 + 2 * u, 20.0)
    gj, gt = s_j.run_slot(), s_t.run_slot()
    cj, ct = s_j.to_pdsch_configs(gj, slot=3), s_t.to_pdsch_configs(gt, slot=3)
    assert all(type(c) is tpdsch.PdschConfig for c in ct)
    assert _asdicts(ct) == _asdicts(cj)
    assert [c.derived_tbs() for c in ct] == [g.tbs for g in gt]
    assert [g.modulation for g in gt] == [g.modulation for g in gj]
    for name in ("CellScheduler", "DlGrant", "SchedUe", "SchedulerConfig",
                 "mcs_from_cqi", "prbs_for_bytes"):
        assert getattr(tmac_pkg, name) is getattr(tmac, name)


# ------------------------------------------------------ UCI allocator


def _drive_uci(ucimod, seed):
    rng = np.random.default_rng(seed)
    a = ucimod.UciAllocator(resources=ucimod.default_resource_set(4, 3))
    out = []
    for slot in range(24):
        kinds = rng.integers(0, 4, 6)
        rntis = rng.choice(RNTIS, 6)
        k1s = [tuple(sorted(rng.choice([2, 3, 4, 5, 6, 7], 3, replace=False)))
               for _ in range(6)]
        a.slot_indication(slot)
        for kind, r, k1 in zip(kinds, rntis, k1s):
            r = int(r)
            if kind == 0:
                res = a.alloc_harq_ack(slot, r, k1)
            elif kind == 1:
                a.on_pusch_grant(slot + int(k1[0]), r)
                res = None
            elif kind == 2:
                res = a.alloc_sr(slot + 4, r)
            else:
                res = a.alloc_csi(slot + 4, r, csi_bits=int(k1[1]))
            out.append(None if res is None else dataclasses.asdict(res))
        out.append({s: {r: dataclasses.asdict(u) for r, u in a.occasions(s).items()}
                    for s in range(slot, slot + 8)})
    return out


def test_uci_allocator():
    ref, got = _drive_uci(juci, 5), _drive_uci(tuci, 5)
    assert got == ref
    assert any(x and x.get("on_pusch") for x in got if "k1" in (x or {}))
    assert any(x is None for x in got)                  # resources ran out
    assert _asdicts(tuci.default_resource_set()) == _asdicts(juci.default_resource_set())


# ---------------------------------------------------- UL procedures


def test_bsr_index_and_bytes():
    for n in list(range(0, 3000, 7)) + [10 ** 5, 149_999, 150_000, 150_001, 10 ** 7]:
        assert tulp.bsr_index(n) == julp.bsr_index(n)
    for i in range(-1, 33):
        assert tulp.bsr_bytes(i) == julp.bsr_bytes(i)


@pytest.mark.parametrize("pdu_bits", [64, 1032, 8456, 40976])
def test_ul_mac_pdu_build_and_parse(pdu_bits):
    rng = np.random.default_rng(pdu_bits)
    cap = tulp.sdu_capacity(pdu_bits)
    assert cap == julp.sdu_capacity(pdu_bits)
    for take in sorted({0, 1, cap // 3, cap}):
        sdu = rng.integers(0, 256, take, dtype=np.uint8).tobytes()
        queue = int(rng.integers(0, 200_000))
        bits = tulp.build_ul_mac_pdu(queue, sdu, pdu_bits)
        np.testing.assert_array_equal(bits, julp.build_ul_mac_pdu(queue, sdu, pdu_bits))
        assert bits.dtype == np.int8 and bits.size == pdu_bits
        assert tulp.parse_ul_mac_pdu(bits) == julp.parse_ul_mac_pdu(bits)
        assert tulp.parse_ul_mac_pdu(bits)[1] == sdu


def test_sr_config():
    sj, st = julp.SrConfig(), tulp.SrConfig()
    assert dataclasses.asdict(st) == dataclasses.asdict(sj)
    assert [st.is_occasion(s) for s in range(40)] == [sj.is_occasion(s) for s in range(40)]
    assert [st.m0_of_ue(u) for u in range(4)] == [sj.m0_of_ue(u) for u in range(4)]


# -------------------------------------------------------------- RACH


def test_rar_msg3_msg4_codecs():
    rng = np.random.default_rng(11)
    for n in (1, 2, 5):
        subs = [(int(rng.integers(0, 64)), int(rng.integers(0, 3847)),
                 (int(rng.integers(0, 2)), int(rng.integers(0, 1 << 14)),
                  int(rng.integers(0, 16)), int(rng.integers(0, 16)),
                  int(rng.integers(0, 8)), int(rng.integers(0, 2))),
                 int(rng.integers(1, 1 << 16))) for _ in range(n)]
        pdus = []
        for mod in (jrach, trach):
            pdus.append(mod.encode_rar_pdu([
                mod.RarSubPdu(rapid=a, ta_cmd=ta, ul_grant=mod.RarUlGrant(*g), tc_rnti=tc)
                for a, ta, g, tc in subs]))
        np.testing.assert_array_equal(pdus[1], pdus[0])
        assert _asdicts(trach.decode_rar_pdu(pdus[0])) == _asdicts(jrach.decode_rar_pdu(pdus[0]))
    for ue_id in (0, 1, (1 << 48) - 1, int(rng.integers(0, 1 << 48))):
        m3, m4 = trach.encode_msg3_ccch(ue_id), trach.encode_msg4_conres(ue_id)
        np.testing.assert_array_equal(m3, jrach.encode_msg3_ccch(ue_id))
        np.testing.assert_array_equal(m4, jrach.encode_msg4_conres(ue_id))
        assert trach.decode_msg3_ccch(m3) == jrach.decode_msg3_ccch(m3) == ue_id
        assert trach.decode_msg4_conres(m4) == jrach.decode_msg4_conres(m4) == ue_id
        assert trach.decode_msg4_conres(m3) is None and trach.decode_msg3_ccch(m4) is None


def test_ra_rnti_ta_and_riv():
    for s_id in range(14):
        for t_id in range(80):
            assert trach.ra_rnti(s_id, t_id) == jrach.ra_rnti(s_id, t_id)
    for d in np.linspace(0.0, 2.1e-3, 57):
        for mu in (0, 1):
            assert trach.ta_command_from_delay(float(d), mu) == \
                jrach.ta_command_from_delay(float(d), mu)
    for n in (24, 52, 106):
        for start in range(0, n, 5):
            for length in range(1, n - start + 1, 3):
                riv = trach.riv_type1(start, length, n)
                assert riv == jrach.riv_type1(start, length, n)
                assert trach.riv_type1_decode(riv, n) == jrach.riv_type1_decode(riv, n)


def _drive_rach(mod):
    """Three preambles on one occasion and one late, a Msg3 CRC failure then
    success, a procedure left to expire: per slot the RAR, the Msg3 grants
    due and the connected UEs."""
    p = mod.RachProcedure(mod.RachConfig(bwp_prbs=52), in_use_rntis={0x4602})
    out = []
    for slot in range(40):
        if slot == 5:
            out.append([p.handle_prach_detection(slot, pre, d)
                        for pre, d in ((7, 1e-6), (18, 4.2e-6), (40, 0.0))])
        if slot == 25:
            out.append(p.handle_prach_detection(slot, 3, 2e-6))
        rar, due = p.run_slot(slot)
        out.append(None if rar is None else
                   (rar.ra_rnti, rar.payload_bits.tolist(), _asdicts(rar.subpdus)))
        out.append(_asdicts(due))
        for i, m in enumerate(due):
            ok = not (m.tc_rnti == 0x4601 and m.retx_left == 4) and i != 2
            bits = mod.encode_msg3_ccch(0xABCDEF000000 + m.tc_rnti) if ok else None
            conn = p.handle_msg3_crc(m.tc_rnti, ok, bits)
            out.append(None if conn is None else
                       (conn.c_rnti, conn.ue_id48, conn.msg4_bits.tolist()))
    return out


def test_rach_procedure():
    ref, got = _drive_rach(jrach), _drive_rach(trach)
    assert got == ref
    assert any(isinstance(x, tuple) and len(x) == 3 and isinstance(x[2], list)
               and len(x[2]) == 56 for x in got)            # a UE connected


# -------------------------------------------------------------- BCCH


@pytest.mark.parametrize("si_kw", [
    {},
    dict(si_messages=((b"\x01\x02", 40),)),
    dict(si_messages=((b"\x01", 8), (b"\x02", 16)), si_window_slots=5),
    dict(si_messages=((b"\x03\x04\x05", 8),), si_window_slots=10, mu=1),
])
def test_si_scheduler(si_kw):
    sj, st = jbcch.SiScheduler(jbcch.SiConfig(**si_kw)), tbcch.SiScheduler(tbcch.SiConfig(**si_kw))
    seen = 0
    for slot in range(640):
        gj, gt = sj.run_slot(slot), st.run_slot(slot)
        assert (gt is None) == (gj is None)
        if gj is not None:
            seen += 1
            assert (gt.rnti, gt.kind, gt.start_prb, gt.nof_prb, gt.modulation,
                    gt.target_rate) == (gj.rnti, gj.kind, gj.start_prb, gj.nof_prb,
                                        gj.modulation, gj.target_rate)
            np.testing.assert_array_equal(gt.payload_bits, gj.payload_bits)
    assert seen > 0


@pytest.mark.parametrize("pg_kw", [
    dict(drx_cycle_frames=2),
    dict(drx_cycle_frames=32, nof_pf_per_drx=4, paging_frame_offset=3),
    dict(drx_cycle_frames=8, ns=2, mu=1),
])
def test_paging_scheduler(pg_kw):
    pj, pt = (m.PagingScheduler(m.PagingConfig(**pg_kw)) for m in (jbcch, tbcch))
    rng = np.random.default_rng(len(pg_kw))
    pages = {int(s): (int(rng.integers(0, 4096)), bytes(rng.integers(0, 256, 3, np.uint8)))
             for s in rng.integers(0, 600, 12)}
    got = 0
    for slot in range(1400):
        if slot in pages:
            pj.page_ue(*pages[slot])
            pt.page_ue(*pages[slot])
        gj, gt = pj.run_slot(slot), pt.run_slot(slot)
        assert (gt is None) == (gj is None)
        if gj is not None:
            np.testing.assert_array_equal(gt.payload_bits, gj.payload_bits)
            assert (gt.rnti, gt.start_prb, gt.nof_prb) == (gj.rnti, gj.start_prb, gj.nof_prb)
            recs = tbcch.decode_paging(gt.payload_bits)
            assert recs == jbcch.decode_paging(gj.payload_bits)
            got += len(recs)
    assert got > 0 and not pt.pending and not pj.pending
    assert tbcch.SI_RNTI == jbcch.SI_RNTI and tbcch.P_RNTI == jbcch.P_RNTI
