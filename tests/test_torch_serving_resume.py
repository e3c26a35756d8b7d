"""Crash recovery of the PyTorch port against the JAX package: snapshots,
kill-and-resume, mid-run resume arrivals, cancellation, and resumes that
cross between the two packages.

The crash-and-resume cases of tests/test_serving_faults.py, and the page
restore of tests/test_kv_hierarchy.py:411, run on one JAX engine and one
port engine (``tiny`` in f32 on the same numpy weights, each on a fresh
synthetic tick clock read by its ``_clock`` and its telemetry): the same
tokens in the same retirement order, the same ``fault_log`` records, the
same injections, telemetry snapshot and Prometheus text, a drained pool,
and snapshots equal dict for dict. Gate 2: a JAX ``last_crash_snapshot``
resumes on the port engine token for token and the reverse, also when the
resumed pages come from a swap tier that the other package wrote. JAX's
tiers write through the port's aio handle (the JAX engine's own has a lost
wakeup; ROADMAP.md section C).
"""

import json

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu.inference.v2.faults as jfaults
import deepspeed_tpu.inference.v2.kv_hierarchy as jh
import deepspeed_tpu.inference.v2.scheduler as jsched
import deepspeed_tpu_torch.inference.v2.faults as tfaults
import deepspeed_tpu_torch.inference.v2.kv_hierarchy as th
import deepspeed_tpu_torch.inference.v2.scheduler as tsched
from deepspeed_tpu.inference.v2.engine_v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2.engine_v2 import \
    RaggedInferenceEngineConfig as JaxConfig
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.models import build_model
from deepspeed_tpu_torch.module_inject import params_from_numpy
from deepspeed_tpu_torch.ops.aio import AsyncIOHandle

KW = dict(kv_block_size=16, prefill_chunk_size=16, max_tokens_per_step=256,
          dtype="float32", max_ragged_batch_size=8, frame_steps=4,
          frame_retry_backoff_s=0.0)
PROMPTS = {u: np.random.default_rng(5).integers(0, 200, (200,)).astype(np.int32)[o:o + n]
           for u, (o, n) in enumerate(((0, 7), (10, 24), (40, 33), (80, 5)))}
SCHEDULE = {0: [0, 1], 2: [2], 3: [3]}
PREEMPT = {u: np.random.default_rng(7).integers(0, 200, (24,)).astype(np.int32) + u
           for u in range(3)}
CRASH = [{"kind": "dispatch_exception", "frame": 3, "times": 10}]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the tiny model's ops are too
    small to gain from more, and the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class TickClock:
    """A synthetic clock: every read advances it by a millisecond."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t

    def sleep(self, seconds):
        self.t += seconds


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) on the same weights."""
    jm = jax_build_model("tiny")
    jp = jm.init(jax.random.PRNGKey(0))
    je = JaxEngine(jm, JaxConfig(**KW), params=jp, max_seq_len=128)
    tm = build_model("tiny")
    te = InferenceEngineV2(tm, RaggedInferenceEngineConfig(**KW),
                           params=params_from_numpy(tm.cfg, jax.tree.map(np.asarray, jp),
                                                    device="cpu"),
                           max_seq_len=128, device="cpu")
    yield je, te
    for e in (je, te):
        e.kv_swap = None


def _jax(e):
    return isinstance(e, JaxEngine)


def _arrivals(schedule=None):
    schedule = SCHEDULE if schedule is None else schedule

    def gen():
        for k in range(max(schedule) + 2):
            yield [(u, PROMPTS[u]) for u in schedule.get(k, [])]
    return gen


def _run(e, arrivals, faults=None, sched=None, **kw):
    """One serve run of ``e`` on a fresh tick clock, with an injector of
    ``faults`` (a schedule) and a scheduler of ``sched`` (a config dict).
    ``arrivals`` is called with the engine. Returns (outputs in retirement
    order, injector, scheduler, the FrameDispatchError or None)."""
    clock = TickClock()
    e._clock = e.telemetry.clock = clock
    e.fault_log.clear()
    fm = jfaults if _jax(e) else tfaults
    inj = None if faults is None else fm.FaultInjector(faults, sleep=clock.sleep)
    s = None
    if sched is not None:
        m = jsched if _jax(e) else tsched
        s = m.RequestScheduler(m.SchedulerConfig(**sched), clock=lambda: 0.0)
    got, err = [], None
    try:
        for item in e.serve(arrivals(e), faults=inj, scheduler=s, **kw):
            got.append(item)
    except fm.FrameDispatchError as ex:
        err = ex
    return got, inj, s, err


def _records(e):
    return [(f.uid, f.kind, f.frame, f.tokens_emitted, f.partial, f.tenant, f.priority)
            for f in e.fault_log]


def _prom(e):
    """Prometheus text without the compile count and the commit split
    (``_snapshot`` compares the commits' sum)."""
    tel = e.telemetry
    return "\n".join(
        line for line in tel.render_prometheus().replace(
            f"ds_serving_recompiled_programs {tel.gauges['recompiled_programs']}",
            "ds_serving_recompiled_programs 0").splitlines()
        if not line.startswith("ds_serving_kv_swap_commits_"))


def _snapshot(e):
    snap = e.telemetry.snapshot()
    snap["gauges"].pop("recompiled_programs")
    # the same commits; the port's lookups leave a queued swap-out to the
    # boundary's drain (overlapped) where JAX's force it (blocking)
    c = snap["counters"]
    c["kv_swap_commits"] = c.pop("kv_swap_commits_overlapped") + c.pop(
        "kv_swap_commits_blocking")
    return snap


def _clean(e):
    return e.kv.free_blocks == e.kv.num_blocks - 1 and not e.state.seqs and not e._ledger


def _same(pair, runs):
    """The port's run must be JAX's: tokens, retirement order, fault
    records, injections, telemetry and Prometheus text; both pools
    drained."""
    (jgot, jinj, js, jerr), (tgot, tinj, ts, terr) = runs
    je, te = pair
    assert [u for u, _ in tgot] == [u for u, _ in jgot], "retirement order"
    for (u, a), (_, b) in zip(jgot, tgot):
        np.testing.assert_array_equal(b, a, err_msg=f"uid={u}")
    assert (terr is None) == (jerr is None)
    assert _records(te) == _records(je)
    if jinj is not None:
        assert tinj.fired == jinj.fired
    assert _snapshot(te) == _snapshot(je)
    assert _prom(te) == _prom(je)
    if js is not None:
        assert ts.stats() == js.stats()
    assert _clean(je) and _clean(te)


def _both(pair, arrivals, resume=None, **kw):
    """Serve on both engines (``resume``: the snapshot of each side, by
    position) and hold the port to JAX. Returns both runs."""
    runs = [_run(e, arrivals, resume_from=None if resume is None else resume[i], **kw)
            for i, e in enumerate(pair)]
    _same(pair, runs)
    return runs


def _assert_tokens(got, base):
    for u, toks in dict(got).items():
        np.testing.assert_array_equal(toks, base[u], err_msg=f"uid={u}")


@pytest.fixture(scope="module")
def base(engines):
    return dict(_both(engines, lambda e: _arrivals()(), max_new_tokens=8)[1][0])


@pytest.fixture(scope="module")
def crashed(engines):
    """Both engines crash at frame 3 (the retry budget exhausted): the
    runs, held to each other, and each side's snapshot."""
    runs = _both(engines, lambda e: _arrivals()(), max_new_tokens=8, faults=CRASH)
    return runs, [e.last_crash_snapshot for e in engines]


# ---------------------------------------------------------------------------
# kill and resume
# ---------------------------------------------------------------------------


def test_kill_and_resume_token_identical(engines, base, crashed):
    """A fatal dispatch failure surfaces as FrameDispatchError after the
    ledger snapshot; the snapshots are equal dict for dict (and survive
    JSON), and resuming each completes every in-flight request: pre-crash
    and resumed outputs together are the fault-free run."""
    runs, (jsnap, tsnap) = crashed
    assert all(isinstance(r[3], m.FrameDispatchError) for r, m in zip(runs, (jfaults, tfaults)))
    assert tsnap == jsnap == json.loads(json.dumps(tsnap)) and tsnap["version"] == 1
    in_flight = {r["uid"] for r in tsnap["requests"]}
    assert in_flight and in_flight.isdisjoint(dict(runs[1][0]))
    assert [f.kind for f in engines[1].fault_log].count("dispatch_failed") == 1
    rest = _both(engines, lambda e: iter([[]]), resume=(jsnap, tsnap), max_new_tokens=8)
    done = dict(runs[1][0]) | dict(rest[1][0])
    assert done.keys() == base.keys()
    _assert_tokens(done, base)
    tel = engines[1].telemetry
    assert tel.counters["recoveries"] == len(in_flight) and tel.gauges["last_recovery_ms"] > 0
    assert "ds_serving_recoveries_total" in tel.render_prometheus()


def test_crash_snapshots_resume_across_packages(engines, base, crashed):
    """Gate 2: the JAX snapshot resumes on the port engine and the port's
    on the JAX engine, token for token with the fault-free run."""
    runs, (jsnap, tsnap) = crashed
    rest = _both(engines, lambda e: iter([[]]), resume=(tsnap, jsnap), max_new_tokens=8)
    done = dict(runs[0][0]) | dict(rest[1][0])
    assert done.keys() == base.keys()
    _assert_tokens(done, base)


def test_snapshot_restore_parity_without_crash(engines, base):
    """``snapshot_serving_state()`` on a healthy engine: abandon a serve
    after its first retirement, resume the snapshot, and the outputs extend
    the committed prefixes token-identically."""
    snaps, firsts = [], []
    for e in engines:
        e._clock = e.telemetry.clock = TickClock()
        gen = e.serve(_arrivals()(), max_new_tokens=8)
        firsts.append(next(gen))
        snaps.append(e.snapshot_serving_state())
        gen.close()
        assert _clean(e)
    assert firsts[1][0] == firsts[0][0] and snaps[1] == snaps[0]
    assert {r["uid"] for r in snaps[1]["requests"]} == {1}
    rest = _both(engines, lambda e: iter([[]]), resume=snaps, max_new_tokens=8)
    done = dict([firsts[1]]) | dict(rest[1][0])
    assert done.keys() == {0, 1}
    _assert_tokens(done, base)


def test_resume_through_scheduler_preserves_metadata(engines, base):
    """Tenant and class ride the ledger into the snapshot, and resumed
    requests re-enter the scheduler's queues with them."""
    def arr(e):
        yield [{"uid": 0, "tokens": PROMPTS[0], "tenant": "acme", "priority": "interactive"},
               {"uid": 1, "tokens": PROMPTS[1], "tenant": "umbrella", "priority": "batch"}]

    _both(engines, arr, max_new_tokens=8, sched={},
          faults=[{"kind": "dispatch_exception", "frame": 1, "times": 10}])
    snaps = [e.last_crash_snapshot for e in engines]
    assert snaps[1] == snaps[0]
    by_uid = {r["uid"]: r for r in snaps[1]["requests"]}
    assert (by_uid[0]["tenant"], by_uid[0]["priority"]) == ("acme", "interactive")
    assert by_uid[1]["priority"] == "batch"
    rest = _both(engines, lambda e: iter([[]]), resume=snaps, max_new_tokens=8, sched={})
    assert dict(rest[1][0]).keys() == {0, 1}
    _assert_tokens(rest[1][0], base)


def test_resume_bypasses_tenant_queue_quota(engines, base):
    """Resumed requests were accepted once: a tenant queue quota smaller
    than the in-flight count sheds none of them, while new arrivals still
    face it."""
    def arr(e):
        yield [{"uid": 0, "tokens": PROMPTS[0], "tenant": "t"},
               {"uid": 1, "tokens": PROMPTS[1], "tenant": "t"}]

    _both(engines, arr, max_new_tokens=8, sched={},
          faults=[{"kind": "dispatch_exception", "frame": 1, "times": 10}])
    snaps = [e.last_crash_snapshot for e in engines]
    assert {r["uid"] for r in snaps[1]["requests"]} == {0, 1}
    rest = _both(engines, lambda e: iter([[]]), resume=snaps, max_new_tokens=8,
                 sched=dict(tenant_max_queued=1))
    assert rest[1][2].stats()["shed_total"] == 0
    _assert_tokens(rest[1][0], base)
    s = rest[1][2]
    s.submit(tsched.Request(uid=90, tokens=PROMPTS[0], limit=8, temp=0.0, eos=None,
                            tenant="t"))
    assert s.submit(tsched.Request(uid=91, tokens=PROMPTS[1], limit=8, temp=0.0, eos=None,
                                   tenant="t")) is not None


def test_abandonment_after_preemption_releases_everything(engines):
    """Abandon a scheduled serve right after a preemption (the victim
    evicted and re-queued, not yet re-admitted): the ledger sweep releases
    its descriptor, and the engine serves again."""
    def arr(e):
        yield [{"uid": 60, "tokens": PROMPTS[1], "priority": "best_effort"},
               {"uid": 61, "tokens": PROMPTS[2], "priority": "best_effort"}]
        yield []
        yield [{"uid": 62, "tokens": PROMPTS[0], "max_new_tokens": 4,
                "priority": "interactive"}]
        for _ in range(8):
            yield []

    firsts = []
    for e in engines:
        m = jsched if _jax(e) else tsched
        s = m.RequestScheduler(m.SchedulerConfig(), clock=lambda: 0.0)
        e._clock = e.telemetry.clock = TickClock()
        gen = e.serve(arr(e), max_new_tokens=12, frame_slots=2, scheduler=s)
        firsts.append(next(gen))
        gen.close()
        assert s.summary["preempted"] == 1 and _clean(e)
    assert firsts[1][0] == firsts[0][0] == 62
    np.testing.assert_array_equal(firsts[1][1], firsts[0][1])
    rest = _both(engines, lambda e: iter([[(60, PROMPTS[0])]]), max_new_tokens=4,
                 frame_slots=2)
    assert len(dict(rest[1][0])[60]) == 4


# ---------------------------------------------------------------------------
# cancellation and mid-run resume arrivals
# ---------------------------------------------------------------------------


def test_cancel_request_live_and_queued(engines, base):
    """``cancel_request`` from the arrival stream (a client disconnect at a
    boundary): a live row and a queued one are retired with ``cancelled``
    at the next boundary, their blocks freed; an unknown uid is False."""
    answers = {}

    def arr(e):
        yield [(0, PROMPTS[0]), (1, PROMPTS[1]), (2, PROMPTS[2])]
        answers[e] = (e.cancel_request(1), e.cancel_request(2), e.cancel_request(77))
        yield []
        yield []

    runs = _both(engines, arr, max_new_tokens=8, frame_slots=2)
    assert set(answers.values()) == {(True, True, False)}
    assert dict(runs[1][0]).keys() == {0}
    _assert_tokens(runs[1][0], base)
    cancelled = {f.uid: f for f in engines[1].fault_log if f.kind == "cancelled"}
    assert cancelled.keys() == {1, 2}
    assert "live row" in cancelled[1].detail and cancelled[1].partial
    assert "queued" in cancelled[2].detail and cancelled[2].partial is None
    assert engines[1].telemetry.counters["cancelled"] == 2


def test_mid_run_resume_arrivals(engines, base):
    """Dict arrivals carrying ``generated`` (``faults.snapshot_split``'s
    form): one re-prefills its committed tokens and finishes its budget
    token-identically, one already at its budget retires at once, and one
    whose prompt + budget exceeds ``max_seq_len`` is clamped and recorded
    as ``resume_truncated``."""
    long_prompt = np.random.default_rng(3).integers(0, 200, (100,)).astype(np.int32)

    def arr(e):
        yield [{"uid": 1, "tokens": PROMPTS[1], "generated": base[1][:3].tolist(),
                "max_new_tokens": 8},
               {"uid": 2, "tokens": PROMPTS[2], "generated": base[2].tolist(),
                "max_new_tokens": 8, "tenant": "t"},
               {"uid": 5, "tokens": long_prompt, "generated": [7, 8],
                "max_new_tokens": 40}]
        yield []

    runs = _both(engines, arr, max_new_tokens=8)
    got = dict(runs[1][0])
    _assert_tokens({u: got[u] for u in (1, 2)}, base)
    assert [u for u, _ in runs[1][0]][0] == 2          # retired at ingestion
    assert len(got[5]) == 128 - len(long_prompt) - 1 and got[5][:2].tolist() == [7, 8]
    (tr,) = [f for f in engines[1].fault_log if f.kind == "resume_truncated"]
    assert tr.uid == 5 and "40->27" in tr.detail
    with pytest.raises(ValueError, match="beyond its budget"):
        list(engines[1].serve(iter([[{"uid": 3, "tokens": PROMPTS[3],
                                      "generated": [1, 2, 3], "max_new_tokens": 2}]])))
    with pytest.raises(ValueError, match="deadline_ms must be > 0"):
        list(engines[1].serve(iter([[{"uid": 3, "tokens": PROMPTS[3], "deadline_ms": 0}]])))
    assert _clean(engines[1])


def test_snapshot_split_matches_jax(crashed):
    """``snapshot_split`` cuts a snapshot into the same resume arrivals in
    both packages, and refuses an unknown version alike."""
    _, (jsnap, tsnap) = crashed
    assert tfaults.snapshot_split(tsnap) == jfaults.snapshot_split(jsnap)
    msgs = []
    for m in (jfaults, tfaults):
        with pytest.raises(ValueError) as err:
            m.snapshot_split({"version": 2})
        msgs.append(str(err.value))
    assert msgs[1] == msgs[0]


# ---------------------------------------------------------------------------
# gate 2: pages restored from a tier the other package wrote
# ---------------------------------------------------------------------------


def _preempt_arrivals(e):
    yield [{"uid": 0, "tokens": PREEMPT[0], "priority": "best_effort"},
           {"uid": 1, "tokens": PREEMPT[1], "priority": "best_effort"}]
    yield []
    yield []
    yield [{"uid": 2, "tokens": PREEMPT[2], "priority": "interactive"}]


def _tier(e, path):
    """A tier of ``e``'s package on ``path``; a JAX tier writes through the
    port's aio handle."""
    if _jax(e):
        return jh.KVSwapTier(str(path), aio_handle=AsyncIOHandle())
    return th.KVSwapTier(str(path))


def test_resume_restores_pages_from_the_other_packages_tier(engines, tmp_path):
    """Both engines crash after a preemption swapped a victim's pages to
    their own tiers; each package then resumes the other's snapshot over
    the other's directory, restoring the victim's pages
    (``kv_swap_resume_restores``) token for token with the crash-free
    run (tests/test_kv_hierarchy.py:411 across packages)."""
    kw = dict(max_new_tokens=16, frame_slots=2, sched={})
    base = dict(_both(engines, _preempt_arrivals, **kw)[1][0])
    dirs = [tmp_path / "jax", tmp_path / "port"]
    for e, d in zip(engines, dirs):
        e.attach_kv_tier(_tier(e, d))
    try:
        runs = _both(engines, _preempt_arrivals,
                     faults=[{"kind": "dispatch_exception", "frame": 4, "times": 100}], **kw)
        snaps = [e.last_crash_snapshot for e in engines]
        assert snaps[1] == snaps[0]
        assert any(r["swapped_tokens"] for r in snaps[1]["requests"])
        assert engines[1].telemetry.counters["kv_swap_out_requests"] >= 1
        # each engine resumes the other's snapshot over the other's tier
        for e, d in zip(engines, reversed(dirs)):
            e.attach_kv_tier(_tier(e, d))
        rest = _both(engines, lambda e: iter([[]]), resume=snaps[::-1], **kw)
        for e in engines:
            assert e.telemetry.counters["kv_swap_resume_restores"] >= 1
            assert not e.kv_swap._index["requests"]
        done = dict(runs[1][0]) | dict(rest[1][0])
        assert done.keys() == base.keys()
        _assert_tokens(done, base)
    finally:
        for e in engines:
            e.kv_swap = None
