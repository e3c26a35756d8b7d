"""Serving resilience of the PyTorch port against the JAX package: fault
injection, resilient frame dispatch with its watchdog, quarantine and the
repair policy, KV-allocation failures and deadlines.

Every case of tests/test_serving_faults.py that is not a crash-and-resume
case (those are in tests/test_torch_serving_resume.py) runs on one JAX
engine and one port engine: ``tiny`` in f32 with the same numpy weights
(``module_inject.params_from_numpy``), the same schedule, each engine on a
fresh synthetic tick clock read by both its ``_clock`` and its telemetry
(an injected ``slow_frame`` sleeps by advancing it). Each case asserts the
same tokens in the same retirement order, the same ``fault_log`` records
(uid, kind, frame, tokens emitted, partial, tenant, priority), the same
injections fired, the same telemetry snapshot and Prometheus text, and a
drained pool. The port's own cases: a failure after a frame's first step is
not retried, ``repair`` names its own CUDA-graph keys, and a faulted frame
still makes one device-to-host copy (plus the (B,) watermark read at a
repair boundary only).
"""

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu.inference.v2.faults as jfaults
import deepspeed_tpu.inference.v2.scheduler as jsched
import deepspeed_tpu_torch.inference.v2.faults as tfaults
import deepspeed_tpu_torch.inference.v2.scheduler as tsched
from deepspeed_tpu.inference.v2.engine_v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2.engine_v2 import \
    RaggedInferenceEngineConfig as JaxConfig
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.models import build_model
from deepspeed_tpu_torch.module_inject import params_from_numpy

KW = dict(kv_block_size=16, prefill_chunk_size=16, max_tokens_per_step=256,
          dtype="float32", max_ragged_batch_size=8, frame_steps=4,
          frame_retry_backoff_s=0.0)
PROMPTS = {u: np.random.default_rng(5).integers(0, 200, (200,)).astype(np.int32)[o:o + n]
           for u, (o, n) in enumerate(((0, 7), (10, 24), (40, 33), (80, 5)))}
SCHEDULE = {0: [0, 1], 2: [2], 3: [3]}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the tiny model's ops are too
    small to gain from more, and the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class TickClock:
    """A synthetic clock: every read advances it by a millisecond, and an
    injected stall (``sleep``) by its seconds."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t

    def sleep(self, seconds):
        self.t += seconds


@pytest.fixture(scope="module")
def weights():
    jm = jax_build_model("tiny")
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, jax.tree.map(np.asarray, jp)


def _pair(weights, draft=False, graphs=None, **over):
    """(JAX engine, port engine) on the same weights; ``draft`` attaches a
    self-draft to both; ``graphs`` is the port runner's ``cuda_graphs``."""
    jm, jp, np_params = weights
    je = JaxEngine(jm, JaxConfig(**{**KW, **over}), params=jp, max_seq_len=128)
    tm = build_model("tiny")
    te = InferenceEngineV2(tm, RaggedInferenceEngineConfig(**{**KW, **over}),
                           params=params_from_numpy(tm.cfg, np_params, device="cpu"),
                           max_seq_len=128, device="cpu", cuda_graphs=graphs)
    if draft:
        je.attach_draft(jm, jp)
        te.attach_draft(build_model("tiny"), params_from_numpy(tm.cfg, np_params, device="cpu"))
    return je, te


@pytest.fixture(scope="module")
def engines(weights):
    return _pair(weights)


@pytest.fixture(scope="module")
def repair_engines(weights):
    return _pair(weights, nonfinite_policy="repair", nonfinite_repair_limit=2)


@pytest.fixture(scope="module")
def spec_repair_engines(weights):
    return _pair(weights, draft=True, nonfinite_policy="repair")


def _arrivals(schedule=None):
    schedule = SCHEDULE if schedule is None else schedule

    def gen():
        for k in range(max(schedule) + 2):
            yield [(u, PROMPTS[u]) for u in schedule.get(k, [])]
    return gen


def _faults_mod(e):
    return jfaults if isinstance(e, JaxEngine) else tfaults


def _run(e, arrivals, faults=None, sched=None, **kw):
    """One serve run of ``e`` on a fresh tick clock, with an injector of
    ``faults`` (a schedule) and a scheduler of ``sched`` (a config dict).
    Returns (outputs in retirement order, injector, scheduler, the
    FrameDispatchError or None)."""
    clock = TickClock()
    e._clock = e.telemetry.clock = clock
    e.fault_log.clear()
    inj = None if faults is None else _faults_mod(e).FaultInjector(faults, sleep=clock.sleep)
    s = None
    if sched is not None:
        m = jsched if isinstance(e, JaxEngine) else tsched
        s = m.RequestScheduler(m.SchedulerConfig(**sched), clock=lambda: 0.0)
    got, err = [], None
    try:
        for item in e.serve(arrivals(), faults=inj, scheduler=s, **kw):
            got.append(item)
    except _faults_mod(e).FrameDispatchError as ex:
        err = ex
    return got, inj, s, err


def _records(e):
    return [(f.uid, f.kind, f.frame, f.tokens_emitted, f.partial, f.tenant, f.priority)
            for f in e.fault_log]


def _prom(e):
    tel = e.telemetry
    return tel.render_prometheus().replace(
        f"ds_serving_recompiled_programs {tel.gauges['recompiled_programs']}",
        "ds_serving_recompiled_programs 0")


def _clean(e):
    return e.kv.free_blocks == e.kv.num_blocks - 1 and not e.state.seqs and not e._ledger


def _both(pair, arrivals, **kw):
    """Serve on both engines; the port must give JAX's tokens, retirement
    order, fault records, injections, telemetry and Prometheus text, and
    both pools must drain. Returns the port's run."""
    (jgot, jinj, js, jerr), (tgot, tinj, ts, terr) = (_run(e, arrivals, **kw) for e in pair)
    je, te = pair
    assert [u for u, _ in tgot] == [u for u, _ in jgot], "retirement order"
    for (u, a), (_, b) in zip(jgot, tgot):
        np.testing.assert_array_equal(b, a, err_msg=f"uid={u}")
    assert (terr is None) == (jerr is None)
    assert _records(te) == _records(je)
    if jinj is not None:
        assert tinj.fired == jinj.fired
    snaps = [e.telemetry.snapshot() for e in pair]
    for snap in snaps:
        snap["gauges"].pop("recompiled_programs")
    assert snaps[1] == snaps[0]
    assert _prom(te) == _prom(je)
    if js is not None:
        assert ts.stats() == js.stats()
    assert _clean(je) and _clean(te)
    return tgot, tinj, ts, terr


@pytest.fixture(scope="module")
def base(engines):
    """The fault-free outputs every scenario's survivors must match."""
    return dict(_both(engines, _arrivals(), max_new_tokens=8)[0])


# ---------------------------------------------------------------------------
# fault spec / injector units (no model)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bad", [dict(kind="meteor_strike", frame=0),
                                 dict(kind="poison_row", frame=0),
                                 dict(kind="dispatch_exception", frame=0, times=0),
                                 dict(kind="slow_frame", frame=0, seconds=-1.0)])
def test_fault_spec_validation(bad):
    msgs = []
    for m in (jfaults, tfaults):
        with pytest.raises(ValueError) as err:
            m.FaultSpec(**bad)
        msgs.append(str(err.value))
    assert msgs[1] == msgs[0]


def test_injector_is_deterministic_and_rearms():
    schedule = [{"kind": "dispatch_exception", "frame": 1, "times": 2},
                {"kind": "poison_row", "frame": 2, "uid": 7},
                {"kind": "kv_alloc_fail", "frame": 0, "times": 2},
                {"kind": "slow_frame", "frame": 3, "seconds": 0.5}]
    seen = []
    for m in (jfaults, tfaults):
        slept = []
        inj = m.FaultInjector(schedule, sleep=slept.append)

        def run():
            events = []
            for frame in range(4):
                if inj.kv_alloc_blocked(frame):
                    events.append(("alloc", frame))
                events.append(("poison", frame, inj.poison_uids(frame)))
                attempt = 0
                while True:
                    try:
                        inj.before_dispatch(frame, attempt)
                        break
                    except m.InjectedFault as e:
                        events.append(("raise", frame, attempt, str(e)))
                        attempt += 1
            return events

        first = run()
        inj.begin_serve()                   # rearm: an identical second run
        assert run() == first
        assert ("poison", 2, [7]) in first and ("alloc", 1) in first
        assert ("alloc", 2) not in first and slept == [0.5, 0.5]
        seen.append((first, inj.fired))
    assert seen[1] == seen[0]


# ---------------------------------------------------------------------------
# resilient dispatch: retry and the watchdog
# ---------------------------------------------------------------------------


def test_transient_dispatch_failure_recovers_token_identical(engines, base):
    """Two consecutive dispatch failures at one frame are absorbed by the
    retry loop (no step had begun): the same tokens, two retries counted."""
    got, inj, _, err = _both(engines, _arrivals(), max_new_tokens=8,
                             faults=[{"kind": "dispatch_exception", "frame": 2, "times": 2}])
    assert err is None and len(inj.fired) == 2
    assert dict(got).keys() == base.keys()
    for u, toks in got:
        np.testing.assert_array_equal(toks, base[u], err_msg=f"uid={u}")
    te = engines[1]
    assert te.telemetry.counters["frame_retries"] == 2 and te.telemetry.counters["faults"] == 2
    assert [f.frame for f in te.fault_log if f.kind == "dispatch_retry"] == [2, 2]


def test_watchdog_flags_slow_frame(engines, base):
    """An injected stall past ``watchdog_frame_ms`` is counted and logged,
    never killed; a natural frame (one tick of the synthetic clock) stays
    under the threshold."""
    for e in engines:
        e._config.watchdog_frame_ms = 100.0
    try:
        got, inj, _, _ = _both(engines, _arrivals(), max_new_tokens=8,
                               faults=[{"kind": "slow_frame", "frame": 1, "seconds": 0.25}])
    finally:
        for e in engines:
            e._config.watchdog_frame_ms = None
    for u, toks in got:
        np.testing.assert_array_equal(toks, base[u], err_msg=f"uid={u}")
    te = engines[1]
    assert te.telemetry.counters["slow_frames"] == 1
    assert [f.frame for f in te.fault_log if f.kind == "slow_frame"] == [1]
    assert inj.fired == [{"kind": "slow_frame", "frame": 1, "seconds": 0.25}]


def test_failure_after_first_step_is_not_retried(weights, base):
    """A failure raised after the frame's first step changed the slot
    state in place goes straight to the crash path: no retry, one
    ``dispatch_failed``, a snapshot of the last boundary whose committed
    tokens are prefixes of the fault-free run's, and a resume from it on
    the same engine completes every request token-identically. Held on the
    functional loops and on the static buffers of the captured steps."""
    for graphs in (None, True):
        te = _pair(weights, graphs=graphs)[1]
        forward, calls = te.runner._forward, [0]

        def failing(*a, **kw):
            calls[0] += 1
            if calls[0] == 2 * KW["frame_steps"] + 2:    # frame 2, step 2
                raise RuntimeError("device fault mid-frame")
            return forward(*a, **kw)

        te.runner._forward = failing
        got, _, _, err = _run(te, _arrivals(), max_new_tokens=8)
        te.runner._forward = forward
        assert isinstance(err, tfaults.FrameDispatchError) and "not retried" in str(err)
        assert [f.kind for f in te.fault_log] == ["dispatch_failed"]
        assert te.telemetry.counters["frame_retries"] == 0 and _clean(te)
        snap = te.last_crash_snapshot
        in_flight = {r["uid"] for r in snap["requests"]}
        assert in_flight == {1, 2} and in_flight.isdisjoint(dict(got))
        for r in snap["requests"]:
            assert r["generated"] == base[r["uid"]][:len(r["generated"])].tolist()
        rest, _, _, _ = _run(te, lambda: iter([[]]), max_new_tokens=8, resume_from=snap)
        done = dict(got) | dict(rest)
        assert done.keys() == {0, 1, 2}
        for u, toks in done.items():
            np.testing.assert_array_equal(toks, base[u], err_msg=f"uid={u}")
        assert _clean(te)


# ---------------------------------------------------------------------------
# poison-row quarantine and KV-allocation failure
# ---------------------------------------------------------------------------


def test_poison_row_quarantined_siblings_unaffected(engines, base):
    """A poisoned row is evicted at the boundary and retired with its
    committed partial, never yielded; its siblings are untouched."""
    got, inj, _, _ = _both(engines, _arrivals(), max_new_tokens=8,
                           faults=[{"kind": "poison_row", "frame": 1, "uid": 1}])
    got = dict(got)
    assert 1 not in got and inj.fired == [{"kind": "poison_row", "frame": 1, "uid": 1}]
    for u in (0, 2, 3):
        np.testing.assert_array_equal(got[u], base[u], err_msg=f"uid={u}")
    te = engines[1]
    (fr,) = [f for f in te.fault_log if f.kind == "poison_row"]
    assert fr.uid == 1 and fr.frame == 1 and fr.tokens_emitted == len(fr.partial) > 0
    np.testing.assert_array_equal(fr.partial, base[1][:len(fr.partial)])
    prom = te.telemetry.render_prometheus()
    assert "ds_serving_quarantined_total 1" in prom
    assert 'ds_serving_faults_total{kind="poison_row"} 1' in prom


def test_kv_alloc_failure_defers_then_recovers(engines, base):
    got, _, _, _ = _both(engines, _arrivals(), max_new_tokens=8,
                         faults=[{"kind": "kv_alloc_fail", "frame": 2, "times": 2}])
    for u, toks in got:
        np.testing.assert_array_equal(toks, base[u], err_msg=f"uid={u}")
    te = engines[1]
    assert [f.frame for f in te.fault_log if f.kind == "kv_alloc_failed"] == [2, 3]
    assert te.telemetry.counters["admission_deferrals"] >= 1


def test_one_copy_a_frame_with_faults(engines, repair_engines, monkeypatch):
    """With a poison fault firing and a quarantine running, a frame still
    makes its one device-to-host copy and the boundary adds none; under
    repair the boundary adds one (B,) read of the watermark, at the repair
    boundary only. Nothing reads a single value back."""
    reads = {"cpu": 0, "sync": 0}
    cpu = torch.Tensor.cpu

    def counted_cpu(self, *a, **kw):
        reads["cpu"] += 1
        return cpu(self, *a, **kw)

    def scalar(name):
        orig = getattr(torch.Tensor, name)

        def read(self, *a, **kw):
            reads["sync"] += 1
            return orig(self, *a, **kw)
        return read

    monkeypatch.setattr(torch.Tensor, "cpu", counted_cpu)
    for name in ("item", "tolist", "__bool__", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, scalar(name))
    poison = [{"kind": "poison_row", "frame": 1, "uid": 1}]
    for pair, extra in ((engines, 0), (repair_engines, 1)):
        te = pair[1]
        reads.update(cpu=0, sync=0)
        # an int seed: no draw from the engine's host generator
        _run(te, _arrivals(), max_new_tokens=8, faults=poison, rng=0)
        assert reads == {"cpu": te.serve_stats["frames"] + extra, "sync": 0}
        assert _clean(te)


# ---------------------------------------------------------------------------
# per-request deadlines
# ---------------------------------------------------------------------------


def test_deadline_expiry_frees_blocks_and_counts(engines, base):
    """A live row past its deadline is cancelled at the next boundary: its
    blocks freed, a ``deadline_expired`` retirement with its partial."""
    def arr():
        yield [(0, PROMPTS[0]), {"uid": 9, "tokens": PROMPTS[1], "deadline_ms": 10.0}]
        for _ in range(3):
            yield []

    got, _, _, _ = _both(engines, arr, max_new_tokens=8)
    got = dict(got)
    assert 9 not in got
    np.testing.assert_array_equal(got[0], base[0])
    te = engines[1]
    (fr,) = [f for f in te.fault_log if f.kind == "deadline_expired"]
    assert fr.uid == 9 and "live row" in fr.detail and fr.partial
    assert "ds_serving_deadline_expired_total 1" in te.telemetry.render_prometheus()


def test_deadline_expiry_in_queue_before_admission(engines):
    """A queued request past its deadline is cancelled before a slot or
    any block is spent on it."""
    def arr():
        yield [{"uid": 20, "tokens": PROMPTS[1]}, {"uid": 21, "tokens": PROMPTS[2]},
               {"uid": 22, "tokens": PROMPTS[3], "deadline_ms": 0.5}]
        for _ in range(2):
            yield []

    got, _, _, _ = _both(engines, arr, max_new_tokens=8, frame_slots=2)
    assert {u for u, _ in got} == {20, 21}
    (fr,) = [f for f in engines[1].fault_log if f.kind == "deadline_expired"]
    assert fr.uid == 22 and "queued" in fr.detail and fr.tokens_emitted == 0
    assert fr.partial is None


def test_deadline_cancelled_before_preemption_or_aging(engines):
    """An expired queued interactive request is cancelled before the
    boundary's preemption pass: no live best-effort row is evicted for it."""
    def arr():
        yield [{"uid": 30, "tokens": PROMPTS[1], "priority": "best_effort"},
               {"uid": 31, "tokens": PROMPTS[2], "priority": "best_effort"}]
        yield []
        yield [{"uid": 32, "tokens": PROMPTS[0], "priority": "interactive",
                "deadline_ms": 1e-6}]
        for _ in range(2):
            yield []

    got, _, s, _ = _both(engines, arr, max_new_tokens=12, frame_slots=2, sched={})
    assert {u for u, _ in got} == {30, 31} and s.summary["preempted"] == 0
    (fr,) = [f for f in engines[1].fault_log if f.kind == "deadline_expired"]
    assert fr.uid == 32 and fr.priority == "interactive"


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


def test_fault_log_is_bounded(weights):
    for e in _pair(weights, fault_log_max=4):
        assert e.fault_log.maxlen == 4


@pytest.mark.parametrize("over", [dict(nonfinite_policy="hope"),
                                  dict(nonfinite_policy="repair", nonfinite_repair_limit=0)])
def test_nonfinite_policy_validation(weights, over):
    msgs = []
    for build in (lambda: JaxEngine(weights[0], JaxConfig(**{**KW, **over}), params=weights[1],
                                    max_seq_len=128),
                  lambda: InferenceEngineV2(build_model("tiny"),
                                            RaggedInferenceEngineConfig(**{**KW, **over}),
                                            max_seq_len=128, device="cpu")):
        with pytest.raises(ValueError) as err:
            build()
        msgs.append(str(err.value))
    assert msgs[1] == msgs[0]


# ---------------------------------------------------------------------------
# nonfinite_policy="repair": the rollback in the frame
# ---------------------------------------------------------------------------


def test_nonfinite_repair_transient_blip_parity(repair_engines, base):
    """A one-frame blip under repair: the row rolls back to its pre-step
    carry and goes on; every request, the poisoned one too, matches the
    fault-free run."""
    got, inj, _, _ = _both(repair_engines, _arrivals(), max_new_tokens=8,
                           faults=[{"kind": "poison_row", "frame": 1, "uid": 1}])
    assert inj.fired and dict(got).keys() == base.keys()
    for u, toks in got:
        np.testing.assert_array_equal(toks, base[u], err_msg=f"uid={u}")
    te = repair_engines[1]
    kinds = [f.kind for f in te.fault_log]
    assert "nonfinite_repaired" in kinds and "poison_row" not in kinds
    assert te.telemetry.counters["quarantined"] == 0


def test_nonfinite_repair_escalates_persistent_fault(repair_engines, base):
    """A fault latched on more consecutive boundaries than the limit is not
    a blip: the row escalates to quarantine, its siblings stay exact."""
    got, _, _, _ = _both(repair_engines, _arrivals(), max_new_tokens=8,
                         faults=[{"kind": "poison_row", "frame": f, "uid": 1}
                                 for f in (1, 2, 3, 4, 5)])
    got = dict(got)
    assert 1 not in got
    for u in (0, 2, 3):
        np.testing.assert_array_equal(got[u], base[u], err_msg=f"uid={u}")
    kinds = [f.kind for f in repair_engines[1].fault_log]
    assert kinds.count("nonfinite_repaired") == 2 and kinds.count("poison_row") == 1
    assert kinds.index("poison_row") > kinds.index("nonfinite_repaired")


@pytest.mark.parametrize("frame", [0, 1, 2], ids=["wide", "verify", "jax_case"])
def test_nonfinite_repair_speculative_parity(spec_repair_engines, base, frame):
    """The rollback selects ride the speculative steps too: a blip in a
    wide frame (uid 1 prefilling, frame 0) or a draft/verify frame (frame
    1) repairs token-identically. Frame 2 is JAX's case, where the
    self-draft has already finished uid 1: nothing to repair."""
    got, inj, _, _ = _both(spec_repair_engines, _arrivals(), max_new_tokens=8,
                           faults=[{"kind": "poison_row", "frame": frame, "uid": 1}])
    for u, toks in got:
        np.testing.assert_array_equal(toks, base[u], err_msg=f"uid={u}")
    c = spec_repair_engines[1].telemetry.counters
    assert c["quarantined"] == 0 and c["nonfinite_repaired"] == (frame < 2)
    assert inj.fired == [{"kind": "poison_row", "frame": frame, "uid": 1}]


def test_repair_names_its_own_graph_keys(weights, repair_engines, base):
    """A repair engine's steps on static buffers (the captured steps, run
    eagerly on the CPU) carry ``repair`` in their keys, so a repair engine
    never replays a graph without the rollback, and give the functional
    repair engine's tokens under a blip and an escalation."""
    static = _pair(weights, graphs=True, nonfinite_policy="repair")[1]
    func = repair_engines[1]
    for faults in ([{"kind": "poison_row", "frame": 1, "uid": 1}],
                   [{"kind": "poison_row", "frame": f, "uid": 1} for f in (1, 2, 3, 4)]):
        runs = [_run(e, _arrivals(), faults=faults, max_new_tokens=8) for e in (func, static)]
        assert [u for u, _ in runs[1][0]] == [u for u, _ in runs[0][0]]
        for (u, a), (_, b) in zip(runs[0][0], runs[1][0]):
            np.testing.assert_array_equal(b, a, err_msg=f"uid={u}")
        assert _records(static) == _records(func) and _clean(static)
    frames = [k for k in static.runner.graphs.keys() if k[0] == "frame"]
    assert frames and all(k[3] is True for k in frames)
    plain = _pair(weights, graphs=True)[1]
    _run(plain, _arrivals(), max_new_tokens=8)
    assert all(k[3] is False for k in plain.runner.graphs.keys() if k[0] == "frame")
