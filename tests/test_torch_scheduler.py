"""The SLO request scheduler of the PyTorch port against the JAX package.

Two layers, as in tests/test_serving_scheduler.py:

* **Policy units**: the same scripted calls (the schedules of that file's
  policy tests and of its admission-lookahead tests) go to both
  ``RequestScheduler``s, each bound to a fake engine; picks, sheds, victims,
  raises and ``stats()`` must be identical.
* **Serving**: one JAX engine and one port engine, ``tiny`` weights through
  the numpy bridge, f32, one slot-table shape (``frame_slots=2``), serve
  that file's schedules with ``serve(scheduler=)``: greedy tokens,
  retirement order, spans, telemetry counters and Prometheus text must
  match. Both engines' telemetry reads one kind of synthetic clock (a tick
  a call), so the latency histograms and the SLO control loop's decisions
  are the same numbers on both sides.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu.inference.v2.scheduler as jsched
import deepspeed_tpu.inference.v2.telemetry as jtel
import deepspeed_tpu_torch.inference.v2.scheduler as tsched
import deepspeed_tpu_torch.inference.v2.telemetry as ttel
from deepspeed_tpu.inference.v2.engine_v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2.engine_v2 import \
    RaggedInferenceEngineConfig as JaxConfig
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.models import build_model
from deepspeed_tpu_torch.module_inject import params_from_numpy

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the tiny model's ops are too
    small to gain from more, and the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SIDES = ((jsched, jtel), (tsched, ttel))
INTERACTIVE, BATCH, BEST_EFFORT = 0, 1, 2


# ---------------------------------------------------------------------------
# policy units: one script, both schedulers
# ---------------------------------------------------------------------------


class _FakeKV:
    def blocks_for(self, n):
        return -(-n // 16)


class _FakeEngine:
    def __init__(self, tel_mod):
        self.kv = _FakeKV()
        self.telemetry = tel_mod.ServingTelemetry(clock=lambda: 0.0)


def _obs(x):
    """A comparable view of what a scheduler call returned."""
    if isinstance(x, list):
        return [_obs(v) for v in x]
    if isinstance(x, tuple):
        return tuple(_obs(v) for v in x)
    if dataclasses.is_dataclass(x):
        d = dataclasses.asdict(x)
        if "tokens" in d:
            d["tokens"] = np.asarray(d["tokens"]).tolist()
        return (type(x).__name__, d)
    return x


class Script:
    """Drives one side's scheduler and records every observation."""

    def __init__(self, sides, **cfg):
        self.m, tel = sides
        self.s = self.m.RequestScheduler(self.m.SchedulerConfig(**cfg), clock=lambda: 0.0)
        self.s.begin_serve(_FakeEngine(tel))
        self.log = []

    def req(self, uid, tenant="default", prio=INTERACTIVE, n=8, limit=25, slo=None):
        return self.m.Request(uid=uid, tokens=np.zeros(n, np.int32), limit=limit,
                              temp=0.0, eos=None, tenant=tenant, priority=prio, slo_ms=slo)

    def submit(self, *a, **kw):
        self.log.append(("submit", _obs(self.s.submit(self.req(*a, **kw)))))

    def boundary(self, slo=None, live=1):
        self.log.append(("boundary", _obs(self.s.on_boundary(slo or {}, live_count=live)),
                         self.s.risk, self.s.pressure))

    def pick(self, free, live=1, ok=True):
        got = self.s.pick(free, (lambda r: object()) if ok else (lambda r: None),
                          live_count=live)
        uids = [r.uid for r, _ in got]
        self.log.append(("pick", uids))
        return uids

    def note(self, *vals):
        self.log.append(("note",) + tuple(_obs(v) for v in vals))


def sc_strict_priority(t):
    t.submit(0, prio=BEST_EFFORT)
    t.submit(1, prio=BATCH)
    t.submit(2, prio=INTERACTIVE)
    t.boundary()
    t.pick(3)


def sc_weighted_fair_share(t):
    t.s.cfg.tenant_weights.update(a=2.0, b=1.0)
    uid = 0
    for _ in range(40):
        t.submit(uid, "a")
        t.submit(uid + 1, "b")
        uid += 2
    for _ in range(30):
        t.boundary()
        for u in t.pick(1):
            t.s.on_retire(u)


def sc_idle_tenant(t):
    for uid in range(20):
        t.submit(uid, "busy")
    for _ in range(10):
        t.boundary()
        for u in t.pick(1):
            t.s.on_retire(u)
    for uid in (100, 101, 102):
        t.submit(uid, "idler")
    t.boundary()
    t.pick(4)


def sc_quotas(t):
    t.s.cfg.tenant_max_queued, t.s.cfg.tenant_max_live = 2, 1
    for uid in range(3):
        t.submit(uid, "t")
    t.note(list(t.s.shed_log))
    t.boundary()
    t.pick(4)
    t.s.on_retire(0)
    t.boundary()
    t.pick(4)


def sc_aging(t):
    t.s.cfg.aging_frames = 2
    t.submit(0, prio=BEST_EFFORT)
    r = next(iter(t.s._queues[(BEST_EFFORT, "default")]))
    for _ in range(4):
        t.boundary()
        t.note(t.s._eff(r))
    t.submit(1, prio=INTERACTIVE)
    t.pick(1)


def sc_slo_pressure(t):
    t.s.cfg.slo_ttft_ms = 100.0
    for uid, p in ((0, INTERACTIVE), (1, BATCH), (2, BEST_EFFORT)):
        t.submit(uid, prio=p)
    t.boundary({"ttft_p90_ms": 50.0})
    t.pick(3)
    for u in (0, 1, 2):
        t.s.on_retire(u)
    for uid, p in ((3, INTERACTIVE), (4, BATCH), (5, BEST_EFFORT)):
        t.submit(uid, prio=p)
    t.boundary({"ttft_p90_ms": 90.0})
    t.pick(3)
    t.boundary({"ttft_p90_ms": 150.0})
    t.note(t.s.queued_count(), t.s.is_queued(5))
    t.pick(3, live=0)


def sc_preempted_never_shed(t):
    t.s.cfg.slo_ttft_ms = 100.0
    t.submit(0, prio=BEST_EFFORT)
    t.boundary()
    (uid,) = t.pick(1)
    t.s.requeue_front(t.s.on_evict(uid))
    t.submit(1, prio=BEST_EFFORT)
    t.boundary({"ttft_p90_ms": 500.0})
    t.note(t.s.is_queued(0), t.s.is_queued(1))


def sc_futility_guard(t):
    t.submit(0, prio=BEST_EFFORT, n=8, limit=25)
    t.boundary(live=0)
    (victim,) = t.pick(1, live=0)
    t.submit(1, prio=INTERACTIVE, n=8, limit=500)
    t.boundary()
    t.note(t.s.preempt_wanted(free_slots=0))
    committed = {victim: 4}
    t.note(t.s.pick_victims(committed, free_blocks=5),
           t.s.pick_victims(committed, free_blocks=30), t.s.pick_victims(committed))


def sc_per_request_slo(t):
    t.s.cfg.slo_ttft_ms = 1000.0
    t.submit(0, prio=INTERACTIVE, slo=10.0)
    t.boundary({"ttft_p90_ms": 20.0})


def sc_frame_steps_cap(t):
    t.s.cfg.slo_ttft_ms = 100.0
    t.note(t.s.frame_steps_cap(8))
    t.submit(0)
    t.boundary({"ttft_p90_ms": 90.0})
    t.note(t.s.frame_steps_cap(8))
    t.boundary({"ttft_p90_ms": 200.0})
    t.note(t.s.frame_steps_cap(8), t.s.frame_steps_cap(1))


def sc_impossible_fit(t):
    t.submit(0, n=500, limit=500)
    t.boundary(live=0)
    with pytest.raises(RuntimeError, match="can never fit") as err:
        t.pick(4, live=0, ok=False)
    t.note(str(err.value))


def sc_lookahead_reserves(t):
    t.s.cfg.lookahead_reserve, t.s.cfg.lookahead_ewma_alpha = True, 1.0
    t.s.cfg.lookahead_max_reserve = 2
    for b in range(3):
        t.submit(100 + b, prio=INTERACTIVE)
        t.boundary()
        t.pick(4)
    t.note(t.s._ia_ewma, t.s.lookahead_reserved(4))
    for u in range(4):
        t.submit(200 + u, prio=BATCH)
    t.pick(2, live=2)
    t.submit(300, prio=INTERACTIVE)
    t.boundary(live=3)
    t.pick(1, live=3)


def sc_lookahead_off(t):
    for b in range(3):
        t.submit(100 + b, prio=INTERACTIVE)
        t.boundary()
        t.pick(4)
    for u in range(4):
        t.submit(200 + u, prio=BATCH)
    t.pick(2, live=2)
    t.submit(300, prio=INTERACTIVE)
    t.boundary(live=4)
    t.pick(0, live=4)
    t.note(t.s.is_queued(300))


def sc_lookahead_decays(t):
    t.s.cfg.lookahead_reserve, t.s.cfg.lookahead_ewma_alpha = True, 0.5
    t.s.cfg.lookahead_max_reserve = 4
    for b in range(4):
        t.submit(100 + b, prio=INTERACTIVE)
        t.boundary()
        t.pick(8)
    t.note(t.s.lookahead_reserved(8), t.s.lookahead_reserved(1))
    t.submit(500, prio=BATCH)
    t.pick(1)
    for _ in range(12):
        t.boundary()
    t.note(t.s.lookahead_reserved(8))


def sc_lookahead_aged_ignores_reserve(t):
    t.s.cfg.lookahead_reserve, t.s.cfg.lookahead_ewma_alpha = True, 1.0
    t.s.cfg.aging_frames = 1
    t.submit(0, prio=INTERACTIVE)
    t.boundary()
    t.pick(4)
    t.submit(1, prio=BATCH)
    t.boundary()
    t.boundary()
    t.pick(1)


SCRIPTS = {f.__name__[3:]: f for f in (
    sc_strict_priority, sc_weighted_fair_share, sc_idle_tenant, sc_quotas, sc_aging,
    sc_slo_pressure, sc_preempted_never_shed, sc_futility_guard, sc_per_request_slo,
    sc_frame_steps_cap, sc_impossible_fit, sc_lookahead_reserves, sc_lookahead_off,
    sc_lookahead_decays, sc_lookahead_aged_ignores_reserve)}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_policy_script_matches_jax(name):
    """The same scripted calls give the same picks, sheds (as structured
    records), victims, risk, pressure and ``stats()`` on both sides."""
    runs = []
    for sides in SIDES:
        t = Script(sides)
        SCRIPTS[name](t)
        t.note(t.s.stats(), list(t.s.shed_log))
        runs.append(t.log)
    assert runs[1] == runs[0]


@pytest.mark.parametrize("bad", [dict(aging_frames=0), dict(tenant_weights={"a": 0.0}),
                                 dict(tenant_max_live=0),
                                 dict(slo_defer_threshold=1.5, slo_shed_threshold=1.0),
                                 dict(lookahead_ewma_alpha=0.0),
                                 dict(lookahead_max_reserve=-1)])
def test_config_validation_matches_jax(bad):
    msgs = []
    for m, _ in SIDES:
        with pytest.raises(ValueError) as err:
            m.SchedulerConfig(**bad)
        msgs.append(str(err.value))
    assert msgs[1] == msgs[0]


def test_normalize_priority_matches_jax():
    for p in (None, "interactive", "batch", "best_effort", 0, 1, 2):
        assert tsched.normalize_priority(p) == jsched.normalize_priority(p)
    for bad in ("bulk", 3):
        with pytest.raises(ValueError):
            tsched.normalize_priority(bad)


# ---------------------------------------------------------------------------
# serving: one JAX engine, one port engine, frame_slots=2 throughout
# ---------------------------------------------------------------------------

KW = dict(kv_block_size=16, prefill_chunk_size=16, max_tokens_per_step=256,
          dtype="float32", max_ragged_batch_size=8, frame_steps=4)
SLOTS = 2


class TickClock:
    """A synthetic clock: every read advances it by a millisecond."""

    def __init__(self):
        self.n = 0

    def __call__(self):
        self.n += 1
        return self.n * 1e-3


@pytest.fixture(scope="module")
def engines():
    jm = jax_build_model("tiny")
    jp = jm.init(jax.random.PRNGKey(0))
    je = JaxEngine(jm, JaxConfig(**KW), params=jp, max_seq_len=128)
    tm = build_model("tiny")
    te = InferenceEngineV2(tm, RaggedInferenceEngineConfig(**KW),
                           params=params_from_numpy(tm.cfg, jax.tree.map(np.asarray, jp),
                                                    device="cpu"),
                           max_seq_len=128, device="cpu")
    for e in (je, te):
        e.telemetry.record_spans = True
    return je, te


PROMPTS = {u: np.random.default_rng(5).integers(0, 200, (120,)).astype(np.int32)[o:o + n]
           for u, (o, n) in enumerate(((0, 7), (10, 14), (30, 9), (50, 5), (60, 11), (75, 13)))}


def _serve_both(engines, arrivals, sched_cfg=None, **kw):
    """Serve ``arrivals()`` on both engines, each on a fresh tick clock;
    returns [(outputs in retirement order, scheduler)] per engine."""
    out = []
    for e in engines:
        clock = TickClock()
        e.telemetry.clock = clock
        sched = None
        if sched_cfg is not None:
            m = jsched if isinstance(e, JaxEngine) else tsched
            sched = m.RequestScheduler(m.SchedulerConfig(**sched_cfg), clock=lambda: 0.0)
        got = list(e.serve(arrivals(), frame_slots=SLOTS, scheduler=sched, **kw))
        assert e.kv.free_blocks == e.kv.num_blocks - 1 and not e.state.seqs
        out.append((got, sched))
    return out


def _view(e):
    """``serve_stats`` (JAX's ``serve_view``) as plain values."""
    return {k: list(v) if k == "frame_steps_trace" else v for k, v in e.serve_stats.items()}


def _assert_same_serving(engines, runs):
    (jgot, jsched_), (tgot, tsched_) = runs
    assert [u for u, _ in tgot] == [u for u, _ in jgot]          # retirement order
    for (u, a), (_, b) in zip(jgot, tgot):
        np.testing.assert_array_equal(b, a, err_msg=f"uid={u}")
    je, te = engines
    jsnap, tsnap = je.telemetry.snapshot(), te.telemetry.snapshot()
    for snap in (jsnap, tsnap):
        snap["gauges"].pop("recompiled_programs")   # JAX compiles, the CPU port captures nothing
    assert tsnap == jsnap
    assert _view(te) == _view(je)
    assert list(te.telemetry.spans)[-len(tgot):] == list(je.telemetry.spans)[-len(jgot):]
    if jsched_ is not None:
        assert tsched_.stats() == jsched_.stats()
        assert [_obs(x) for x in tsched_.shed_log] == [_obs(x) for x in jsched_.shed_log]


def test_no_scheduler_path_is_fifo_identical(engines):
    """scheduler=None and a default RequestScheduler give the same tokens
    in the same retirement order, on both engines."""
    def arrivals():
        sched = {0: [0, 1], 2: [2], 3: [3]}
        for k in range(5):
            yield [(u, PROMPTS[u]) for u in sched.get(k, [])]

    fifo = _serve_both(engines, arrivals, max_new_tokens=8)
    _assert_same_serving(engines, fifo)
    runs = _serve_both(engines, arrivals, sched_cfg={}, max_new_tokens=8)
    _assert_same_serving(engines, runs)
    assert [u for u, _ in runs[1][0]] == [u for u, _ in fifo[1][0]]
    for (_, a), (_, b) in zip(fifo[1][0], runs[1][0]):
        np.testing.assert_array_equal(a, b)


def test_interactive_never_waits_behind_best_effort(engines):
    be = {u: PROMPTS[u % 6] for u in (20, 21, 22, 23)}
    ia = {u: PROMPTS[u % 6] for u in (30, 31)}

    def arrivals():
        yield [{"uid": u, "tokens": be[u], "priority": "best_effort"} for u in be]
        yield []
        yield [{"uid": u, "tokens": ia[u], "priority": "interactive"} for u in ia]

    runs = _serve_both(engines, arrivals, sched_cfg=dict(preemption=False), max_new_tokens=6)
    _assert_same_serving(engines, runs)
    spans = {s["uid"]: s for s in engines[1].telemetry.spans}
    be_admits = sorted(spans[u]["admit_t"] for u in be)
    assert max(spans[u]["admit_t"] for u in ia) < be_admits[2]


@pytest.mark.parametrize("aging_frames", [2, 1000])
def test_aging_admits_starved_best_effort(engines, aging_frames):
    def arrivals():
        yield [{"uid": 40, "tokens": PROMPTS[3], "priority": "interactive"},
               {"uid": 41, "tokens": PROMPTS[4], "priority": "interactive"},
               {"uid": 50, "tokens": PROMPTS[5], "priority": "best_effort"}]
        for k in range(6):
            yield [{"uid": 42 + k, "tokens": PROMPTS[k % 6], "priority": "interactive"}]

    runs = _serve_both(engines, arrivals, sched_cfg=dict(preemption=False,
                                                         aging_frames=aging_frames),
                       max_new_tokens=6)
    _assert_same_serving(engines, runs)
    spans = {s["uid"]: s for s in engines[1].telemetry.spans}
    last_ia = max(s["admit_t"] for u, s in spans.items() if u in range(40, 48))
    assert (spans[50]["admit_t"] < last_ia) == (aging_frames == 2)


def test_preemption_by_reprefill_token_parity(engines):
    """An interactive arrival preempts a live best-effort row, which
    re-prefills its committed prefix and finishes with the tokens of an
    unpreempted run; the counters, labels and Prometheus text agree."""
    def arrivals():
        yield [{"uid": 60, "tokens": PROMPTS[1], "priority": "best_effort"},
               {"uid": 61, "tokens": PROMPTS[2], "priority": "best_effort"}]
        yield []
        yield [{"uid": 62, "tokens": PROMPTS[0], "max_new_tokens": 4,
                "priority": "interactive"}]

    runs = _serve_both(engines, arrivals, sched_cfg={}, max_new_tokens=12)
    _assert_same_serving(engines, runs)
    je, te = engines
    assert runs[1][1].summary["preempted"] == 1
    prom = te.telemetry.render_prometheus()
    assert "ds_serving_requests_preempted_total 1" in prom and 'class="best_effort"' in prom
    assert prom == je.telemetry.render_prometheus().replace(
        f"ds_serving_recompiled_programs {je.telemetry.gauges['recompiled_programs']}",
        "ds_serving_recompiled_programs 0")
    got = dict(runs[1][0])
    solo = dict(te.serve(iter([[(60, PROMPTS[1])]]), max_new_tokens=12, frame_slots=SLOTS))
    np.testing.assert_array_equal(solo[60], got[60])


def test_shed_and_defer_under_slo_pressure(engines):
    """An impossible TTFT target drives the control loop critical after the
    first interactive emission: the best-effort arrival is shed with a
    structured reason, the batch arrival is deferred until the machine
    drains, and frames shrink to the pressure-capped bucket."""
    def arrivals():
        yield [{"uid": 70, "tokens": PROMPTS[0], "max_new_tokens": 16,
                "priority": "interactive"}]
        yield []
        yield [{"uid": 71, "tokens": PROMPTS[3], "priority": "best_effort"}]
        yield [{"uid": 72, "tokens": PROMPTS[4], "max_new_tokens": 4, "priority": "batch"}]

    runs = _serve_both(engines, arrivals, sched_cfg=dict(slo_ttft_ms=1e-4), max_new_tokens=16)
    _assert_same_serving(engines, runs)
    je, te = engines
    got = dict(runs[1][0])
    assert set(got) == {70, 72} and len(got[72]) == 4
    (shed,) = runs[1][1].shed_log
    assert shed.uid == 71 and shed.reason == "slo_pressure" and shed.risk > 1.0
    assert te.telemetry.counters["requests_shed"] == 1
    assert te.telemetry.gauges["slo_risk"] == je.telemetry.gauges["slo_risk"] > 1.0
    spans = {s["uid"]: s for s in te.telemetry.spans}
    assert spans[72]["admit_t"] >= spans[70]["retire_t"]
    assert any(k < 4 for k in te.serve_stats["frame_steps_hist"])


def test_dict_arrivals_without_scheduler(engines):
    """Dict arrivals on the FIFO path: the scheduling fields are inert."""
    def arrivals():
        yield [{"uid": 96, "tokens": PROMPTS[2], "tenant": "t", "priority": "batch",
                "slo_ms": 5.0}, (95, PROMPTS[2])]

    runs = _serve_both(engines, arrivals, max_new_tokens=6)
    _assert_same_serving(engines, runs)
    got = dict(runs[1][0])
    np.testing.assert_array_equal(got[95], got[96])


def test_tenant_labels_exported(engines):
    def arrivals():
        yield [{"uid": 97, "tokens": PROMPTS[0], "tenant": "acme", "priority": "interactive"},
               {"uid": 98, "tokens": PROMPTS[3], "tenant": "umbrella", "priority": "batch"}]

    runs = _serve_both(engines, arrivals, sched_cfg={}, max_new_tokens=6)
    _assert_same_serving(engines, runs)
    prom = engines[1].telemetry.render_prometheus()
    assert 'ds_serving_requests_retired_total{class="interactive",tenant="acme"} 1' in prom
    assert 'ds_serving_tokens_emitted_total{class="interactive",tenant="acme"} 6' in prom
    assert 'ds_serving_class_ttft_p90_seconds{class="interactive"}' in prom


def test_abandonment_releases_scheduler_state(engines):
    """Breaking out of a scheduled serve with queued, live and preempted
    requests strands nothing: descriptors flushed, KV drained, ledger
    empty, and the engine serves again."""
    te = engines[1]

    def arrivals():
        yield [{"uid": 110 + i, "tokens": PROMPTS[i % 6], "priority": "best_effort"}
               for i in range(5)]
        yield []
        yield [{"uid": 120, "tokens": PROMPTS[0], "priority": "interactive"}]
        yield []

    for _ in te.serve(arrivals(), max_new_tokens=12, frame_slots=SLOTS,
                      scheduler=tsched.RequestScheduler()):
        break
    assert not te.state.seqs and not te._ledger
    assert te.kv.free_blocks == te.kv.num_blocks - 1
    got = dict(te.serve(iter([[(110, PROMPTS[0])]]), max_new_tokens=4, frame_slots=SLOTS))
    assert len(got[110]) == 4


def test_scheduler_takes_the_engine_clock(engines):
    """``begin_serve`` binds a scheduler built without a clock to the
    engine's ``_clock``, as JAX's does."""
    te = engines[1]
    s = tsched.RequestScheduler()
    s.begin_serve(te)
    assert s._clock is te._clock and s._telemetry is te.telemetry
