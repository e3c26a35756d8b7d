"""Serving telemetry of the PyTorch port against the JAX package.

``ServingTelemetry`` is host code (numpy and the standard library), so the
port's copy must make JAX's numbers exactly: the same event sequence, under
one injected clock, gives equal ``snapshot()``, ``render_prometheus()``,
``latency_ms()``, ``monitor_events()``, ``serve_view`` and ``slo_view()``.
The sequences cover every ``on_*`` hook (lifecycle, scheduler labels,
faults, the KV hierarchy's prefix and swap hooks, frames and deferrals),
with telemetry on and off and with identity labels. Also: the histogram's
bucket math, the ``/metrics`` endpoint (localhost), the profiler range
around a frame, the deferral warning, and the fault and ledger records.
"""

import dataclasses
import logging
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import deepspeed_tpu.inference.v2.faults as jfaults
import deepspeed_tpu.inference.v2.telemetry as jtel
import deepspeed_tpu_torch.inference.v2.faults as tfaults
import deepspeed_tpu_torch.inference.v2.telemetry as ttel


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module runs: the suite's workers share
    the machine's cores, and tiny ops gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class TickClock:
    def __init__(self):
        self.n = 0

    def __call__(self):
        self.n += 1
        return self.n * 7e-4


def _events(tel, rng):
    """One scripted serve run's worth of hook calls, drawn from ``rng``."""
    tel.begin_serve(speculate=True, gamma=2, adaptive=True, n_slots=4,
                    kv_blocks_total=33, tp_degree=1, kv_block_bytes=4096)
    live = []
    for frame in range(12):
        for _ in range(int(rng.integers(0, 3))):
            uid = 100 * frame + len(live)
            labels = {} if rng.random() < 0.3 else dict(
                tenant=str(rng.choice(["acme", "umbrella"])),
                pclass=str(rng.choice(["interactive", "batch", "best_effort"])))
            tel.on_enqueue(uid, **labels)
            live.append(uid)
        if live and rng.random() < 0.8:
            tel.on_admit(live[0])
        tel.on_prefix_lookup(int(rng.integers(0, 3)) * 16, int(rng.integers(0, 3)),
                             bool(rng.random() < 0.3))
        tel.on_frame_plan(float(rng.random()), bool(rng.random() < 0.5), 4)
        delta = rng.integers(0, 9, (ttel.N_STATS,)).astype(np.int64)
        tel.on_frame(delta=delta, width=int(rng.choice([1, 16])), steps=4,
                     live_slots=len(live), kv_blocks_in_use=int(rng.integers(1, 33)),
                     arrival_ewma=float(rng.random()), recompiled_programs=3,
                     queue_depth=int(rng.integers(0, 5)))
        for uid in live[:2]:
            tel.on_emit(uid, int(rng.integers(0, 4)))
        tel.on_prefix_update(*(int(x) for x in rng.integers(0, 3, 4)), 5)
        if rng.random() < 0.3:
            tel.on_kv_swap_out(int(rng.integers(1, 4)), uid=live[-1] if live else None)
            tel.on_kv_swap_in(2, uid=live[0] if live else None)
            tel.on_kv_swap_commits(1, int(rng.integers(0, 2)))
            tel.on_tier_prefix_hit(16, 1)
        if rng.random() < 0.3:
            tel.on_defer(queue_depth=3, frame_steps=4, free_slots=0, free_blocks=7,
                         reserved_blocks=2)
        if live and rng.random() < 0.2:
            tel.on_preempt(live[-1], "acme", "batch")
        if live and rng.random() < 0.2:
            uid = live.pop()
            tel.on_shed(uid, "umbrella", "best_effort", "slo_pressure")
        if live and rng.random() < 0.15:
            tel.on_fault("poison_row", uid=live.pop())
        if rng.random() < 0.2:
            tel.on_fault("swap_failed")
        if live and rng.random() < 0.5:
            tel.on_retire(live.pop(0))
        tel.slo_view()
    tel.on_shed(99999, "acme", "interactive", "tenant_queue_full")


def _views(tel):
    return {"snapshot": tel.snapshot(), "prom": tel.render_prometheus(),
            "latency": tel.latency_ms(), "monitor": tel.monitor_events(),
            "serve_view": {k: (list(v) if k == "frame_steps_trace" else v)
                           for k, v in tel.serve_view.items()},
            "slo": tel.slo_view(), "spans": list(tel.spans)}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("enabled", [True, False])
def test_event_sequence_matches_jax(seed, enabled):
    views = []
    for mod in (jtel, ttel):
        tel = mod.ServingTelemetry(enabled=enabled, clock=TickClock(), record_spans=True,
                                   slo_window=8)
        if seed == 2:
            tel.set_base_labels(engine="e0", model="tiny")
        _events(tel, np.random.default_rng(seed))
        views.append(_views(tel))
    assert views[1] == views[0]


def test_monitor_fan_out_matches_jax():
    sinks = []
    for mod in (jtel, ttel):
        events = []

        class Sink:
            def write_events(self, batch):
                events.extend(batch)

        tel = mod.ServingTelemetry(clock=TickClock())
        tel.attach_monitor(Sink(), every_frames=2)
        _events(tel, np.random.default_rng(4))
        sinks.append(events)
    assert sinks[1] == sinks[0] and sinks[1]


@pytest.mark.parametrize("values", [[1e-5, 3e-4, 0.02, 0.02, 1.5, 700.0],
                                    list(np.geomspace(1e-4, 10.0, 40))])
def test_histogram_matches_jax(values):
    hs = [mod.LogBucketHistogram() for mod in (jtel, ttel)]
    for h in hs:
        for i, v in enumerate(values):
            h.record(float(v), count=1 + i % 3)
    assert hs[1].counts.tolist() == hs[0].counts.tolist()
    assert hs[1].summary() == hs[0].summary()
    assert [hs[1].percentile(p) for p in (1, 50, 99.9)] == \
        [hs[0].percentile(p) for p in (1, 50, 99.9)]


def test_http_metrics_endpoint():
    tel = ttel.ServingTelemetry(clock=lambda: 0.0)
    tel.counters["tokens_emitted"] = 42
    srv = tel.serve_metrics_http(0)
    try:
        base = f"http://127.0.0.1:{srv.metrics_port}"
        with urllib.request.urlopen(f"{base}/metrics", timeout=5) as resp:
            assert resp.status == 200
            assert resp.headers["Content-Type"].startswith("text/plain")
            assert resp.read().decode() == tel.render_prometheus()
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{base}/other", timeout=5)
        assert err.value.code == 404
    finally:
        srv.shutdown()
        srv.server_close()


def test_frame_trace_is_a_profiler_range():
    off = ttel.ServingTelemetry()
    with off.frame_trace(16, 4):
        pass
    on = ttel.ServingTelemetry(trace=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with on.frame_trace(16, 4):
            torch.ones(4).sum()
    assert "serve_frame/w16/s4" in {e.key for e in prof.key_averages()}


def test_defer_warning_carries_reserved_blocks(caplog):
    tel = ttel.ServingTelemetry(clock=lambda: 0.0)
    with caplog.at_level(logging.WARNING, logger=ttel.logger.name):
        tel.on_defer(queue_depth=3, frame_steps=8, free_slots=2, free_blocks=7,
                     reserved_blocks=5)
    (msg,) = [r.getMessage() for r in caplog.records if "admission deferred" in r.getMessage()]
    assert "free_kv_blocks=7" in msg and "kv_blocks_reserved_this_round=5" in msg


@pytest.mark.parametrize("name", ["FaultReason", "LedgerEntry"])
def test_records_match_jax(name):
    """The port's records have JAX's fields, in order, with its defaults."""
    def shape(cls):
        return [(f.name, f.default if f.default is not dataclasses.MISSING else None)
                for f in dataclasses.fields(cls)]

    assert shape(getattr(tfaults, name)) == shape(getattr(jfaults, name))
    assert set(tfaults.FAULT_KINDS) == set(jfaults.FAULT_KINDS)
