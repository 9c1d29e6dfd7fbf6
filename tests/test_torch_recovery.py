"""The port's crash-consistent journal and power-off recovery against the
JAX reference, on the CPU.

Framing: the port's frames are the reference's bytes, and a cut at every
byte offset of the last record is detected. The crash axis writes the
scheduled share of a commit's bytes as the reference's does, file for
file. A torn tail at every byte offset of a page manager's last commit
(a 3-page admission striped over two channels, a retirement chain, a
mid-swap tear) replays in the port as in the reference: the same map,
free lists, retirement and counters, the OOB scan exactly when the OOB
frame landed whole and the record did not.

Recovery: the reference's recovery shape (4 slots, 12 device + 24 host
blocks, macro_k=4, two channels) crashes in the port and in the JAX
engine at the same commit; the two journals are equal at the crash,
each recovers (``last_recovery`` equal, the OOB scan among the cases)
and drains to the uncrashed tokens, and the journals are equal again
after the drain. A second crash after the recovery replays cleanly. A
journal written by either package recovers in the other and drains to
the uncrashed tokens. ``reset`` keeps the engine's cache tensors.
A GC, SHARE or COW record, or a snapshot with sharing refcounts, makes
the port's ``replay`` raise. A journaled mamba2 engine recovers too."""
import os
import random
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import faults as JF  # noqa: E402
from repro.core import journal as JJ  # noqa: E402
from repro.paging.kv_manager import KVPageManager as JKVM  # noqa: E402
from repro_torch.core import faults as TF  # noqa: E402
from repro_torch.core import journal as TJ  # noqa: E402
from repro_torch.paging.kv_manager import KVPageManager as TKVM  # noqa: E402
from repro_torch.serving import ServeConfig, ServeEngine  # noqa: E402
from test_torch_faults import (CHAOS, MAX_NEW, PROMPTS,  # noqa: E402
                               assert_journals_equal, engine_pair,
                               model_pair, shared_jax_programs)  # noqa: F401

RECOVER = dict(CHAOS, channels=2)


@pytest.fixture(scope="module")
def engines():
    """The port's and the JAX engine at the recovery shape, on the same
    weights, and their uncrashed tokens."""
    te, je = engine_pair(model_pair("llama3.2-1b"), **RECOVER)
    ref = []
    for eng in (te, je):
        eng.reset(None)
        rids = [eng.submit(list(p), max_new=MAX_NEW) for p in PROMPTS]
        done = eng.run()
        ref.append([done[r] for r in rids])
    assert ref[0] == ref[1]
    return te, je, ref[0]


def crash_plane(mod, crash_at, tear, **kw):
    """A plane (of package ``mod``) that cuts power at the
    ``crash_at``-th journaled commit with ``tear`` of its bytes landing,
    under light program faults."""
    plan = mod.make_plan(7, channels=2, crash_at=crash_at,
                         program_fail_p=0.1, **kw)
    return mod.FaultPlane(plan._replace(
        crash_tear=np.full_like(plan.crash_tear, tear)))


def run_to_crash(eng, mod, d, plane):
    """Journaled run of the workload until the plane's power cut.
    Returns the ``Crash``."""
    eng.reset(plane)
    eng.attach_journal(d, snapshot_every=4)
    with pytest.raises(mod.Crash) as ei:
        for p in PROMPTS:
            eng.submit(list(p), max_new=MAX_NEW)
        eng.run()
    return ei.value


def resume(eng, d, plane=None):
    """Recover from ``d`` and drain, re-submitting what never became
    durable. Returns (outputs in prompt order, last_recovery without its
    wall time)."""
    durable = eng.recover(d, fault_plane=plane)
    present = set(durable) | {r.rid for r in eng.queue}
    remap = {eng.submit(list(PROMPTS[i]), max_new=MAX_NEW): i
             for i in range(len(PROMPTS)) if i not in present}
    done = eng.run()
    assert not eng.active and not eng.queue
    final = {**durable, **done}
    for nr, i in remap.items():
        final[i] = final.pop(nr)
    info = dict(eng.last_recovery)
    assert info.pop("recover_s") > 0
    return [final[i] for i in range(len(PROMPTS))], info


def _oob_scan_cut(te, tmp_path):
    """A (crash_at, tear) that tears a map commit's record after its OOB
    frame: the first PRECOMMIT of an uncrashed journaled run under the
    same plan, cut halfway through its record."""
    d = str(tmp_path / "probe")
    te.reset(crash_plane(TF, 4000, 1.0, horizon=4096))
    te.attach_journal(d, snapshot_every=4)
    for p in PROMPTS:
        te.submit(list(p), max_new=MAX_NEW)
    te.run()
    frames, _, _ = TJ.read_frames(os.path.join(d, "journal.log"))
    oob = {s: p for s, k, p in
           TJ.read_frames(os.path.join(d, "oob.log"))[0]}
    seq, kind, payload = next(f for f in frames if f[1] == TJ.PRECOMMIT)
    n_oob = len(TJ._frame(seq, TJ.OOB, oob[seq]))
    n_rec = len(TJ._frame(seq, kind, payload))
    te.reset(None)
    return seq - 1, (n_oob + n_rec // 2) / (n_oob + n_rec)


# ------------------------------------------------------------ framing
def test_frames_are_the_references_and_every_cut_is_detected(tmp_path):
    """``_frame`` gives the reference's bytes for each record kind; a
    log cut at every byte offset of its last record reads back the
    records before it, with the valid prefix and the torn flag the
    reference's reader reports."""
    payloads = [(TJ.SUBMIT, {"rid": 0, "tokens": [1, 2], "max_new": 3,
                             "lanes": 0}),
                (TJ.NEW_SEQ, {"slot": 1, "dl": [8, 9], "blocks": [0, 2],
                              "lanes": 2}),
                (TJ.RETIRE, {"done": [[8, 0, 4]], "popped": [4],
                             "retired": [0], "pages": {1: [4, 2]},
                             "lanes": 1})]
    blob = b""
    for i, (k, p) in enumerate(payloads, 1):
        f = TJ._frame(i, k, p)
        assert f == JJ._frame(i, k, p)
        blob += f
    path = str(tmp_path / "log")
    last = len(blob) - len(TJ._frame(3, *payloads[2]))
    for cut in range(last, len(blob) + 1):
        with open(path, "wb") as f:
            f.write(blob[:cut])
        got = TJ.read_frames(path)
        assert got == JJ.read_frames(path)
        frames, valid, torn = got
        whole = cut == len(blob)
        assert len(frames) == (3 if whole else 2), cut
        assert valid == (cut if whole else last)
        assert torn == (last < cut < len(blob))


@pytest.mark.parametrize("tear", [0.0, 0.3, 0.62, 0.99, 1.0])
def test_crash_axis_tears_like_the_reference(tear, tmp_path):
    """A power cut at the third commit writes round(tear * bytes) of its
    (OOB + record) stream in both packages, file for file, and raises
    the same ``Crash``; the dead journal refuses further appends."""
    errs = []
    for mod, name in ((TJ, "t"), (JJ, "j")):
        fm = TF if mod is TJ else JF
        plan = fm.make_plan(1, crash_at=2)
        plan = plan._replace(crash_tear=np.full_like(plan.crash_tear, tear))
        j = mod.Journal(str(tmp_path / name), faults=fm.FaultPlane(plan))
        j.append(mod.SUBMIT, {"rid": 0, "tokens": [5], "max_new": 2,
                              "lanes": 0})
        j.append(mod.NEW_SEQ, {"slot": 0, "dl": [0], "blocks": [3]},
                 programmed=[(0, 3)])
        with pytest.raises(fm.Crash) as ei:
            j.append(mod.EXTEND, {"dl": [1, 2], "blocks": [5, 7]},
                     programmed=[(1, 5), (2, 7)])
        errs.append((ei.value.seq, ei.value.kind, ei.value.torn))
        with pytest.raises(AssertionError):
            j.append(mod.FREE, {"slot": 0, "blocks": [], "lanes": 0})
    assert errs[0] == errs[1] and errs[0][2] == (tear < 1.0)
    assert_journals_equal(str(tmp_path / "t"), str(tmp_path / "j"))


def _traffic(kvm, rng):
    """A random, always-legal script of journaled commits (the
    reference test's ``_traffic``)."""
    live = []
    for _ in range(rng.randrange(6, 11)):
        op = rng.random()
        free_slots = [s for s in range(kvm.n_slots) if s not in live]
        roomy = [s for s in live
                 if len(kvm.seq_pages[s]) + 2 <= kvm.max_pages]
        headroom = min(kvm.pool.free_device_ch(c)
                       for c in range(kvm.channels)) >= 4
        if op < 0.5 and free_slots and headroom:
            kvm.new_seq(free_slots[0], rng.randrange(1, 4))
            live.append(free_slots[0])
        elif op < 0.8 and roomy and headroom:
            kvm.extend_seqs({rng.choice(roomy): rng.randrange(1, 3)})
        elif live:
            kvm.free_seq(live.pop(rng.randrange(len(live))))


@pytest.mark.parametrize("final", ["new3", "retire", "swap"])
def test_torn_tail_replays_like_the_reference(final, tmp_path):
    """A port manager at two channels writes journaled traffic, then a
    last commit (a 3-page admission striped over both channels, a
    retirement whose first replacement fails too, or a swap-out); its
    bytes are cut at every offset. Each cut replays in the port as in
    the reference (mapping, free lists in order, retirement, counters,
    flags), never a corrupt map, and gives the pre-commit map while the
    OOB frame is torn, the post-commit map from the OOB scan after."""
    rng = random.Random(31)
    src = str(tmp_path / "j")
    kvm = TKVM(4, 8, 24, 8 if final == "swap" else 0, channels=2,
               device="cpu")
    kvm.journal = TJ.Journal(src)
    kvm.journal.snapshot(kvm.snapshot_state())
    _traffic(kvm, rng)
    while (min(kvm.pool.free_device_ch(c) for c in range(2)) < 6
           and kvm.seq_pages) or len(kvm.seq_pages) == kvm.n_slots:
        kvm.free_seq(min(kvm.seq_pages))
    victim = next(s for s in range(4) if s not in kvm.seq_pages)
    if final != "new3":
        kvm.new_seq(victim, 3)
    before = TJ.replay(src).mapping()
    o_base = os.path.getsize(os.path.join(src, "oob.log"))
    r_base = os.path.getsize(os.path.join(src, "journal.log"))
    if final == "new3":
        kvm.new_seq(victim, 3)
    elif final == "retire":
        kvm.faults = TF.FaultPlane(TF.make_plan(0)._replace(
            program_fail=np.array([True] + [False] * 7)))
        kvm.retire_bad_blocks([(victim * 8, kvm.seq_pages[victim][0])])
    else:
        kvm.swap_out(victim, [torch.zeros((24 + 8 + 1, 2))])
    kvm.journal.close()
    after = TJ.replay(src).mapping()
    assert after != before
    o_tail = os.path.getsize(os.path.join(src, "oob.log")) - o_base
    total = o_tail + os.path.getsize(os.path.join(src, "journal.log")) \
        - r_base
    work = str(tmp_path / "cut")
    for cut in range(total + 1):
        shutil.rmtree(work, ignore_errors=True)
        shutil.copytree(src, work)
        with open(os.path.join(work, "oob.log"), "r+b") as f:
            f.truncate(o_base + min(cut, o_tail))
        with open(os.path.join(work, "journal.log"), "r+b") as f:
            f.truncate(r_base + max(0, cut - o_tail))
        rec, jrec = TJ.replay(work), JJ.replay(work)
        for name in ("seq_pages", "host_pages", "free_dev_ch",
                     "free_host_ch", "retired", "retired_ch", "stats",
                     "last_seq", "replayed", "torn", "oob_scan"):
            assert getattr(rec, name) == getattr(jrec, name), (cut, name)
        assert rec.mapping() == (after if cut >= o_tail else before), cut
        assert rec.oob_scan == (o_tail <= cut < total), cut


# ------------------------------------------------------------ recovery
@pytest.mark.parametrize("crash_at,tear", [(3, 0.4), (25, 1.0),
                                           ("oob", None)])
def test_recover_bit_identical_to_reference(engines, crash_at, tear,
                                            tmp_path):
    """Both engines cut power at the same commit (early and torn,
    mid-run between commits, and a map commit whose record tore after
    its OOB frame): the journals are equal at the crash, recovery
    reports the same (the OOB scan in the last case), the drains give
    the uncrashed tokens, the journals are equal after them, and the
    device's committed lanes match the journal's. The port's cache
    tensors survive its resets."""
    te, je, ref = engines
    oob = crash_at == "oob"
    if oob:
        crash_at, tear = _oob_scan_cut(te, tmp_path)
    caches = dict(te.caches)
    d_t, d_j = str(tmp_path / "t"), str(tmp_path / "j")
    e_t = run_to_crash(te, TF, d_t, crash_plane(TF, crash_at, tear))
    e_j = run_to_crash(je, JF, d_j, crash_plane(JF, crash_at, tear))
    assert (e_t.seq, e_t.kind, e_t.torn) == (e_j.seq, e_j.kind, e_j.torn)
    assert_journals_equal(d_t, d_j)
    got, info = resume(te, d_t)
    want, jinfo = resume(je, d_j)
    assert info == jinfo
    assert got == want == ref
    assert info["oob_scan"] == oob and info["torn"] == (tear < 1.0)
    assert e_t.kind == "precommit" or not oob
    assert te.metrics == {k: je.metrics[k] for k in te.metrics}
    assert te.journal_lane_check() and je.journal_lane_check()
    te.journal.close()
    je.journal.close()
    assert_journals_equal(d_t, d_j)
    assert all(te.caches[n] is c for n, c in caches.items())


def test_second_crash_after_recovery(engines, tmp_path):
    """A plane handed to ``recover`` cuts power again 12 commits later,
    in both packages: the second recovery replays from the snapshot the
    first one wrote and reports as the reference's, the journals are
    equal after each crash and after the drain, and the drain gives the
    uncrashed tokens."""
    te, je, ref = engines
    infos = []
    for eng, mod in ((te, TF), (je, JF)):
        d = str(tmp_path / type(eng).__module__)
        run_to_crash(eng, mod, d, crash_plane(mod, 20, 0.5))
        with pytest.raises(mod.Crash):
            resume(eng, d, plane=crash_plane(mod, 12, 0.5))
        got, info = resume(eng, d)
        assert got == ref
        assert info["snap_seq"] > 0
        assert eng.metrics["recoveries"] == 2
        eng.journal.close()
        infos.append((d, info))
    assert infos[0][1] == infos[1][1]
    assert_journals_equal(infos[0][0], infos[1][0])


def test_journals_recover_across_packages(engines, tmp_path):
    """A journal the JAX engine wrote up to its power cut recovers in
    the port's engine and drains to the uncrashed tokens, and one the
    port wrote recovers in the JAX engine."""
    te, je, ref = engines
    for src_eng, src_mod, dst_eng in ((je, JF, te), (te, TF, je)):
        d = str(tmp_path / type(src_eng).__module__)
        run_to_crash(src_eng, src_mod, d, crash_plane(src_mod, 30, 0.7))
        src_eng.reset(None)
        got, info = resume(dst_eng, d)
        assert got == ref, type(dst_eng).__module__
        assert info["replayed"] > 0
        dst_eng.reset(None)


def test_unported_records_raise(tmp_path):
    """GC, SHARE and COW records (written by the reference's journal)
    make the port's ``replay`` raise ``NotImplementedError`` naming the
    ROADMAP item; so does a snapshot with sharing refcounts. The
    reference replays the same prefix up to them."""
    for kind in (JJ.GC, JJ.SHARE, JJ.COW):
        d = str(tmp_path / f"k{kind}")
        kvm = JKVM(2, 4, 8)
        j = JJ.Journal(d)
        j.snapshot(kvm.snapshot_state())
        j.append(kind, {"moves": [], "returned": [], "op": "pin",
                        "blocks": []})
        j.close()
        with pytest.raises(NotImplementedError, match="item 4"):
            TJ.replay(d)
    d = str(tmp_path / "ref")
    kvm = TKVM(2, 4, 8, device="cpu")
    j = TJ.Journal(d)
    j.snapshot(dict(kvm.snapshot_state(), ref={"3": 2}, pinned=[3]))
    j.close()
    with pytest.raises(NotImplementedError, match="item 4"):
        TJ.replay(d)


def test_mamba2_engine_recovers(tmp_path):
    """A journaled mamba2 engine (no KV pool: recovery re-prefills)
    crashes mid-run and recovers to the uncrashed tokens."""
    _, _, tm, tp = model_pair("mamba2-1.3b")
    eng = ServeEngine(tm, tp, config=ServeConfig(n_slots=2, max_ctx=64,
                                                 macro_k=4), device="cpu")
    prompts = [list(range(1, 12)), list(range(50, 62)), [7, 8, 9]]
    rids = [eng.submit(p, max_new=6) for p in prompts]
    done = eng.run()
    ref = [done[r] for r in rids]
    eng.reset(TF.FaultPlane(TF.make_plan(0, crash_at=9)))
    d = str(tmp_path / "m")
    eng.attach_journal(d, snapshot_every=2)
    with pytest.raises(TF.Crash):
        for p in prompts:
            eng.submit(p, max_new=6)
        eng.run()
    durable = eng.recover(d)
    present = set(durable) | {r.rid for r in eng.queue}
    assert present == {0, 1, 2}
    done = eng.run()
    assert [{**durable, **done}[r] for r in rids] == ref
