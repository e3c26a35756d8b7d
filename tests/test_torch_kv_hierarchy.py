"""The KV hierarchy of the PyTorch port against the JAX package: the prefix
cache with copy-on-write, the host swap tier, and the serving paths that use
them.

* **Units on the same pools**: ``PrefixCache`` publish, match, reclaim order
  and spill/restore on a JAX pool and a port pool give the same decisions
  and the same page bytes (the schedules of tests/test_kv_hierarchy.py's
  unit tests).
* **Tier bytes both ways**: request, block and prefix records written by
  JAX's ``KVSwapTier`` restore into the port's pools byte for byte, and the
  reverse, for f32, bf16 and int8 pools; a record of another layout, dtype
  or geometry raises ``IOError`` on both sides.
* **Serving**: one JAX engine and one port engine (``tiny`` weights, f32,
  ``frame_slots=2`` throughout), with the hierarchy switched per test,
  serve the schedules of tests/test_kv_hierarchy.py: greedy tokens,
  retirement order and the whole telemetry snapshot must match JAX's, and
  every exit path must leave the pool drained once the cache is cleared. A
  third engine, the port's static-buffer steps (the steps the card captures
  into CUDA graphs, run eagerly here), serves the hit and swap schedules
  too and must give the same tokens: a hit row enters those steps at a
  nonzero watermark over shared blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.inference.v2.kv_hierarchy as jh
import deepspeed_tpu.inference.v2.scheduler as jsched
import deepspeed_tpu_torch.inference.v2.kv_hierarchy as th
import deepspeed_tpu_torch.inference.v2.scheduler as tsched
from deepspeed_tpu.inference.v2.engine_v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2.engine_v2 import \
    RaggedInferenceEngineConfig as JaxConfig
from deepspeed_tpu.inference.v2.faults import FaultInjector
from deepspeed_tpu.inference.v2.kv_cache import BlockedKVCache as JaxKV
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.inference.v2.kv_cache import BlockedKVCache as PortKV
from deepspeed_tpu_torch.inference.v2.ragged_manager import DeviceSlotTable
from deepspeed_tpu_torch.models import build_model
from deepspeed_tpu_torch.ops.aio import AsyncIOHandle
from deepspeed_tpu_torch.module_inject import params_from_numpy

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the tiny model's ops are too
    small to gain from more, and the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BS, CHUNK = 16, 8          # block > chunk: mid-block copy-on-write hits are reachable
SLOTS = 2


# ---------------------------------------------------------------------------
# pools: the same pages on both sides
# ---------------------------------------------------------------------------

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pools(dtype="float32", block_size=4, seed=0):
    """A JAX pool and a port pool (2 layers, 2 heads, head dim 4, 8 blocks)
    holding the same random page bytes in every block."""
    quant = dtype == "int8"
    jkv = JaxKV(num_layers=2, kv_heads=2, head_dim=4, num_blocks=8, block_size=block_size,
                dtype=jnp.float32 if quant else JDT[dtype], kv_dtype="int8" if quant else None)
    tkv = PortKV(2, 2, 4, num_blocks=8, block_size=block_size,
                 dtype=torch.float32 if quant else TDT[dtype], device="cpu",
                 kv_dtype="int8" if quant else None)
    rng = np.random.default_rng(seed)
    for name in ("k", "v"):
        pool = getattr(tkv, name)
        raw = rng.integers(-100, 100, pool.shape).astype(np.float32)
        t = torch.from_numpy(raw).to(pool.dtype)
        pool.copy_(t)
        j = np.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16) \
            if pool.dtype == torch.bfloat16 else t.numpy()
        setattr(jkv, name, jnp.asarray(j))
    for kv in (jkv, tkv):
        kv.reserve_trash_block()
    return jkv, tkv


def _bytes(x, blocks):
    """Raw bytes of pages ``blocks`` of a JAX or port pool."""
    if isinstance(x, torch.Tensor):
        return bytes(x[:, :, blocks].contiguous().view(torch.uint8).numpy())
    return np.asarray(x[:, :, np.asarray(blocks)]).tobytes()


# ---------------------------------------------------------------------------
# units: the prefix cache on the same pools
# ---------------------------------------------------------------------------


def _cache_script(mod, kv, tier):
    """tests/test_kv_hierarchy.py's unit schedules in one script: publish
    a hot one-block prefix and a cold three-block chain, hit the hot one,
    reclaim under pressure (spilling when there is a tier), match and
    restore. Returns every observable decision."""
    pc = mod.PrefixCache(kv, swap=tier)
    bs = kv.block_size
    log = []
    hot, cold = list(range(bs)), [100 + t for t in range(3 * bs)]
    for uid, stream, n in ((1, hot, 1), (2, cold, 3)):
        blocks = kv.allocator.allocate(n)
        log.append(("publish", blocks, pc.publish(uid=uid, stream=stream, blocks=blocks,
                                                   upto_tokens=n * bs)))
        kv.allocator.free(blocks)
    for _ in range(3):
        full, _ = pc.match(hot + [9])
        pc.touch(full, bs)
    full, partial = pc.match(cold[:2 * bs + 3] + [7])
    log.append(("match", [(e.eid, e.block) for e in full],
                partial and (partial[0].eid, partial[1])))
    log.append(("reclaim", pc.reclaim(3), pc.resident_blocks(), kv.allocator.free_blocks,
                sorted((e.eid, e.block) for e in pc._by_id.values())))
    full, _ = pc.match(cold + [9])
    ok = [pc.ensure_resident(e, protect={x.eid for x in full}) for e in full]
    log.append(("restore", ok, [e.block for e in full], kv.allocator.free_blocks))
    log.append(("stats", dict(pc.stats), len(pc)))
    resident = [e.block for e in full if e.block is not None]
    pc.clear()
    log.append(("clear", kv.allocator.free_blocks))
    return log, resident


@pytest.mark.parametrize("tiered", [False, True])
def test_prefix_cache_decisions_match_jax(tmp_path, tiered):
    """Same publish/match/reclaim/restore decisions on both sides; with a
    tier, the restored pages hold the spilled bytes on both."""
    jkv, tkv = _pools()
    runs = []
    for mod, kv, sub in ((jh, jkv, "j"), (th, tkv, "t")):
        tier = _tier(mod, tmp_path / sub) if tiered else None
        runs.append(_cache_script(mod, kv, tier))
    assert runs[1][0] == runs[0][0]
    if tiered:
        blocks = runs[1][1]
        assert blocks and _bytes(tkv.k, blocks) == _bytes(jkv.k, blocks)


# ---------------------------------------------------------------------------
# tier records cross between the packages byte for byte
# ---------------------------------------------------------------------------


def _put_all(mod_kv, tier, src):
    """One record of each kind over blocks ``src``."""
    tier.put_request(7, tokens=len(src) * mod_kv.block_size - 1, kv=mod_kv, blocks=src,
                     fingerprint="fp")
    tier.put_blocks(["kvblk_a", "kvblk_b"], mod_kv, src[:2])
    tier.put_prefix(list(range(len(src) * mod_kv.block_size)), mod_kv, src)
    assert tier.drain() == 1      # the prefix record's async commit


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_tier_files_are_identical(tmp_path, dtype):
    """The same records written by both packages: the same index and the
    same page files, byte for byte; each side's block records (which name
    in-memory cache entries, so a fresh tier drops them) restore in place."""
    import json
    jkv, tkv = _pools(dtype)
    src = [1, 2, 3]
    tiers = []
    for mod, kv, sub in ((jh, jkv, "j"), (th, tkv, "t")):
        tier = _tier(mod, tmp_path / sub)
        _put_all(kv, tier, src)
        tiers.append(tier)
    index = [json.loads((tmp_path / sub / "kv_tier_index.json").read_text())
             for sub in ("j", "t")]
    assert index[1] == index[0]
    files = sorted(p.name for p in (tmp_path / "j").glob("*.swp"))
    assert files == sorted(p.name for p in (tmp_path / "t").glob("*.swp")) and files
    for name in files:
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    for tier, kv in zip(tiers, (jkv, tkv)):
        tier.restore_block("kvblk_b", kv, 4)
    assert _bytes(tkv.k, [4]) == _bytes(jkv.k, [2]) == _bytes(tkv.k, [2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tier_records_cross_byte_for_byte(tmp_path, dtype, writer):
    """Request and prefix records written by one package restore into the
    other's pools, byte for byte."""
    jkv, tkv = _pools(dtype)
    src, dst = [1, 2, 3], [5, 6, 7]
    assert _bytes(tkv.k, src) == _bytes(jkv.k, src)
    (wmod, wkv), (rmod, rkv) = ((jh, jkv), (th, tkv)) if writer == "jax" else \
        ((th, tkv), (jh, jkv))
    _put_all(wkv, _tier(wmod, tmp_path), src)
    tier = _tier(rmod, tmp_path)
    rec = tier.request_record(7)
    assert rec["segments"][0]["dtype"] == dtype
    assert rec["segments"][0]["layout"] == ("int8_scale_lanes_v1" if dtype == "int8" else "raw")
    tier.restore_request(7, rkv, dst)
    assert _bytes(rkv.k, dst) == _bytes(wkv.k, src)
    assert _bytes(rkv.v, dst) == _bytes(wkv.v, src)
    key, prec = tier.match_prefix(list(range(3 * rkv.block_size)) + [1], rkv.block_size)
    assert prec["tokens"] == 3 * rkv.block_size
    tier.restore_prefix(key, rkv, [4, 5])
    assert _bytes(rkv.v, [4, 5]) == _bytes(wkv.v, src[:2])


def test_lookup_drains_only_for_a_queued_record(tmp_path):
    """A queued (async) request record is visible to its own uid's lookup,
    which commits it blocking; a lookup of another uid or of the prefix
    records leaves it queued, to commit at the boundary's drain."""
    tkv = _pools()[1]
    tier = _tier(th, tmp_path)
    tier.put_request(7, tokens=7, kv=tkv, blocks=[1, 2], fingerprint="fp", async_commit=True)
    assert tier.request_record(8) is None
    assert tier.match_prefix(list(range(16)), 4) is None
    assert tier.pending_commits() == 1
    assert tier.drain(blocking=False) == 1
    assert tier.stats["commits_overlapped"] == 1 and tier.stats["commits_blocking"] == 0
    tier.put_request(9, tokens=7, kv=tkv, blocks=[3, 4], fingerprint="fp", async_commit=True)
    assert tier.request_record(9)["blocks"] == 2
    assert tier.pending_commits() == 0 and tier.stats["commits_blocking"] == 1


@pytest.mark.parametrize("pair", [("int8", "float32"), ("bfloat16", "float32"),
                                  ("float32", "bfloat16")])
def test_foreign_records_raise_ioerror_on_both_sides(tmp_path, pair):
    """A record of another layout or dtype, or another page geometry, is
    refused with IOError by both packages' tiers."""
    wrote, pool = pair
    for i, (wmod, rmod) in enumerate(((jh, th), (th, jh))):
        d = str(tmp_path / f"{i}")
        wkv = _pools(wrote)[0 if wmod is jh else 1]
        _tier(wmod, d).put_request(3, tokens=7, kv=wkv, blocks=[1, 2])
        for rkv in (_pools(pool)[0 if rmod is jh else 1],
                    _pools(wrote, block_size=8)[0 if rmod is jh else 1]):
            tier = _tier(rmod, d)
            with pytest.raises(IOError):
                tier.restore_request(3, rkv, [4, 5])


# ---------------------------------------------------------------------------
# serving: one JAX engine, one port engine, the hierarchy switched per test
# ---------------------------------------------------------------------------

KW = dict(kv_block_size=BS, prefill_chunk_size=CHUNK, max_tokens_per_step=256,
          dtype="float32", max_ragged_batch_size=4, frame_steps=2)
RNG = np.random.default_rng(7)
SHARED = RNG.integers(0, 200, (40,)).astype(np.int32)     # 2.5 blocks
TAILS = {u: RNG.integers(0, 200, (6,)).astype(np.int32) for u in range(8)}
PREEMPT = {u: RNG.integers(0, 200, (24,)).astype(np.int32) for u in range(3)}
OTHER = RNG.integers(0, 200, (46,)).astype(np.int32)      # no shared prefix


class TickClock:
    def __init__(self):
        self.n = 0

    def __call__(self):
        self.n += 1
        return self.n * 1e-3


@pytest.fixture(scope="module")
def engines():
    """(JAX, port, port static-buffer) engines; tests switch the hierarchy
    on and off through ``_hier``."""
    jm = jax_build_model("tiny")
    jp = jm.init(jax.random.PRNGKey(0))
    je = JaxEngine(jm, JaxConfig(**KW), params=jp, max_seq_len=160)
    out = [je]
    for graphs in (None, True):
        tm = build_model("tiny")
        out.append(InferenceEngineV2(
            tm, RaggedInferenceEngineConfig(**KW),
            params=params_from_numpy(tm.cfg, jax.tree.map(np.asarray, jp), device="cpu"),
            max_seq_len=160, device="cpu", cuda_graphs=graphs))
    yield out
    for e in out:
        _hier(e)


def _mod(e):
    return jh if isinstance(e, JaxEngine) else th


def _tier(mod, path):
    """A tier of ``mod`` on ``path``. A JAX tier writes through the port's
    aio handle: the JAX engine's own copy has the lost wakeup (its wait()
    can sleep forever), and the record bytes are the swapper's either way."""
    return mod.KVSwapTier(str(path), aio_handle=AsyncIOHandle() if mod is jh else None)


def _hier(e, cache=False, max_blocks=None, swap_dir=None):
    """Switch an engine's hierarchy as its config would have built it."""
    if e.prefix_cache is not None:
        e.prefix_cache.clear()
    e.kv_swap = _tier(_mod(e), swap_dir) if swap_dir else None
    e.prefix_cache = _mod(e).PrefixCache(e.kv, max_blocks=max_blocks, swap=e.kv_swap) \
        if cache else None
    if e.prefix_cache is not None:
        e.prefix_cache.draft_kv = e.draft_kv


@pytest.fixture(autouse=True)
def _reset_engines(request):
    """Whatever a serving test leaves behind (a failed assertion skips its
    own cleanup) is released before the next test: hogged blocks, the
    hierarchy, descriptors."""
    yield
    if "engines" not in request.fixturenames:
        return
    for e in request.getfixturevalue("engines"):
        hog = _HOGS.pop(id(e), [])
        if hog:
            e.kv.allocator.free(hog)
        _hier(e)
        e.flush(list(e.state.seqs))


_HOGS = {}


def _clean(e, hog=()):
    """Live blocks == cache-held blocks (+ trash, + the test's hog), and a
    cache clear returns the pool to trash-only."""
    resident = e.prefix_cache.resident_blocks() if e.prefix_cache else 0
    assert e.kv.num_blocks - e.kv.free_blocks == resident + 1 + len(hog)
    assert not e.state.seqs and not e._ledger
    if e.prefix_cache is not None:
        e.prefix_cache.clear()
    if hog:
        e.kv.allocator.free(_HOGS.pop(id(e)))
    assert e.kv.free_blocks == e.kv.num_blocks - 1


def _serve(e, arrivals, sched=False, pool=None, hook=None, **kw):
    """One serve run on a fresh tick clock; ``pool`` squeezes the pool to
    that many blocks for the run (the rest held by a hog)."""
    e.telemetry.clock = TickClock()
    hog = e.kv.allocator.allocate(e.kv.free_blocks - (pool - 1)) if pool else []
    if hog:
        _HOGS[id(e)] = hog
    s = None
    if sched:
        m = jsched if isinstance(e, JaxEngine) else tsched
        s = m.RequestScheduler(m.SchedulerConfig(), clock=lambda: 0.0)
    got = list(e.serve(arrivals(), frame_slots=SLOTS, scheduler=s, **kw))
    return got, s, hog


def _both(engines, arrivals, port_graphs=False, **kw):
    """Serve on the JAX engine and the port engine(s); the port must give
    JAX's tokens, retirement order and telemetry snapshot. Each engine is
    left as the run left it (checked by the caller with ``_clean``)."""
    runs = [_serve(e, arrivals, **kw) for e in (engines if port_graphs else engines[:2])]
    (jgot, _, _), (tgot, _, _) = runs[:2]
    for got in [r[0] for r in runs[1:]]:
        assert [u for u, _ in got] == [u for u, _ in jgot]
        for (u, a), (_, b) in zip(jgot, got):
            np.testing.assert_array_equal(b, a, err_msg=f"uid={u}")
    je, te = engines[:2]
    snaps = [e.telemetry.snapshot() for e in (je, te)]
    for snap in snaps:
        snap["gauges"].pop("recompiled_programs")
        # the same commits, but the port's admission probes leave queued
        # swap-outs to the boundary's drain (overlapped) where JAX's force
        # them (blocking): compare the total
        c = snap["counters"]
        c["kv_swap_commits"] = (c.pop("kv_swap_commits_overlapped")
                                + c.pop("kv_swap_commits_blocking"))
    assert snaps[1] == snaps[0]
    assert _view(te) == _view(je)
    return runs


def _view(e):
    """``serve_stats`` (JAX's ``serve_view``) as plain values."""
    return {k: list(v) if k == "frame_steps_trace" else v for k, v in e.serve_stats.items()}


def _shared_arrivals(n=6):
    """One arrival per boundary, all SHARED + a unique tail: later arrivals
    land while earlier donors are still live."""
    def gen():
        for u in range(n):
            yield [(u, np.concatenate([SHARED, TAILS[u]]))]
    return gen


def test_prefix_hit_fifo(engines):
    base = dict(_serve(engines[1], _shared_arrivals(), max_new_tokens=8)[0])
    off = dict(engines[1].telemetry.counters)
    for e in engines:
        _hier(e, cache=True)
    runs = _both(engines, _shared_arrivals(), port_graphs=True, max_new_tokens=8)
    for u, toks in runs[1][0]:
        np.testing.assert_array_equal(toks, base[u], err_msg=f"uid={u} cache-on vs off")
    c = engines[1].telemetry.counters
    assert c["prefix_hits"] >= 3 and c["prefix_blocks_published"] > 0
    assert c["prefill_tokens"] < off["prefill_tokens"]
    assert engines[1].serve_stats["frames"] == engines[0].serve_stats["frames"]
    for e in engines:
        _clean(e)
        _hier(e)


def test_prefix_hit_under_scheduler(engines):
    def arrivals():
        for u in range(4):
            yield [{"uid": u, "tokens": np.concatenate([SHARED, TAILS[u]]),
                    "priority": "batch" if u % 2 else "interactive", "tenant": f"t{u % 2}"}]

    for e in engines:
        _hier(e, cache=True)
    _both(engines, arrivals, sched=True, max_new_tokens=8)
    assert engines[1].telemetry.counters["prefix_hits"] >= 2
    for e in engines[:2]:
        _clean(e)
        _hier(e)


def test_cow_isolation_under_divergent_continuations(engines):
    """B extends A's stream mid-block (copy-on-write), C diverges mid-block,
    D replays A's prompt and must still match A's clean pages."""
    a_prompt = np.concatenate([SHARED, TAILS[0]])
    a_gen = dict(_serve(engines[1], lambda: iter([[(0, a_prompt)]]), max_new_tokens=8)[0])[0]
    b = np.concatenate([a_prompt, a_gen[:4]])
    c = np.concatenate([a_prompt, (a_gen[:4] + 1) % 200])

    def arrivals():
        for batch in ([(0, a_prompt)], [], [], [(1, b)], [(2, c)], [], [(3, a_prompt)]):
            yield batch

    base = dict(_serve(engines[1], arrivals, max_new_tokens=8)[0])
    for e in engines[:2]:
        _hier(e, cache=True)
    runs = _both(engines, arrivals, max_new_tokens=8)
    for u, toks in runs[1][0]:
        np.testing.assert_array_equal(toks, base[u], err_msg=f"uid={u} under copy-on-write")
    assert engines[1].telemetry.counters["prefix_cow_copies"] >= 1
    for e in engines[:2]:
        _clean(e)
        _hier(e)


def test_refcounts_after_retire_evict_quarantine(engines, monkeypatch):
    """A cache-on scheduled run with a preemption (evict) and a poisoned row
    (quarantine, the JAX side through its fault injector, the port's by
    arming the same row's poison flag before the same frame): every
    non-cache reference unwinds, the quarantined row's published entries
    are dropped, and clear() drains the pool."""
    poison_frame, poison_uid = 4, 2
    frames = [0]
    orig = DeviceSlotTable.run_frame

    def run_frame(self, *a, **kw):
        if frames[0] == poison_frame and poison_uid in self.slot_of_uid:
            self.poison[self.slot_of_uid[poison_uid]] = True
        frames[0] += 1
        return orig(self, *a, **kw)

    monkeypatch.setattr(DeviceSlotTable, "run_frame", run_frame)

    def arrivals():
        yield [{"uid": 0, "tokens": np.concatenate([SHARED, TAILS[0]]),
                "priority": "best_effort"}]
        yield [{"uid": 1, "tokens": np.concatenate([SHARED, TAILS[1]]),
                "priority": "best_effort"}]
        yield [{"uid": 2, "tokens": np.concatenate([SHARED, TAILS[2]]),
                "priority": "interactive"}]
        for _ in range(4):
            yield []

    je, te = engines[:2]
    for e in (je, te):
        _hier(e, cache=True)
    inj = FaultInjector([{"kind": "poison_row", "frame": poison_frame, "uid": poison_uid}])
    jgot, js, _ = _serve(je, arrivals, sched=True, max_new_tokens=8, faults=inj)
    tgot, ts, _ = _serve(te, arrivals, sched=True, max_new_tokens=8)
    assert [u for u, _ in tgot] == [u for u, _ in jgot] and poison_uid not in dict(tgot)
    for (u, a), (_, b) in zip(jgot, tgot):
        np.testing.assert_array_equal(b, a, err_msg=f"uid={u}")
    assert ts.summary["preempted"] == js.summary["preempted"] >= 1
    (jf,), (tf,) = ([(f.uid, f.kind, f.frame, f.partial) for f in e.fault_log
                     if f.kind == "poison_row"][-1:] for e in (je, te))
    assert tf == jf
    assert all(ent.source_uid != poison_uid for ent in te.prefix_cache._by_id.values())
    for e in (je, te):
        _clean(e)
        _hier(e)


def _preempt_arrivals():
    yield [{"uid": 0, "tokens": PREEMPT[0], "priority": "best_effort"},
           {"uid": 1, "tokens": PREEMPT[1], "priority": "best_effort"}]
    yield []
    yield []
    yield [{"uid": 2, "tokens": PREEMPT[2], "priority": "interactive"}]


def test_preemption_swap_in_parity(engines, tmp_path):
    """A victim re-admitted by swap-in emits the tokens of the re-prefill
    path and of JAX's swap-in; the tier carried the pages, its commits were
    counted, and every record was consumed."""
    base = dict(_serve(engines[1], _preempt_arrivals, sched=True, max_new_tokens=16)[0])
    for i, e in enumerate(engines):
        _hier(e, swap_dir=str(tmp_path / f"tier{i}"))
    runs = _both(engines, _preempt_arrivals, port_graphs=True, sched=True, max_new_tokens=16)
    for u, toks in runs[1][0]:
        np.testing.assert_array_equal(toks, base[u], err_msg=f"uid={u} swap-in vs re-prefill")
    c = engines[1].telemetry.counters
    assert runs[1][1].summary["preempted"] >= 1
    assert c["kv_swap_out_blocks"] == c["kv_swap_in_blocks"] > 0
    # the swap-outs rode the aio queue into the next frame: no probe of
    # another uid forced them (JAX's probes make them all blocking)
    assert c["kv_swap_commits_overlapped"] >= 1 and c["kv_swap_commits_blocking"] == 0
    assert engines[0].telemetry.counters["kv_swap_commits_blocking"] >= 1
    for e in engines:
        assert not e.kv_swap._index["requests"]
        _clean(e)
        _hier(e)


def test_stale_swap_record_rejected_on_uid_reuse(engines, tmp_path):
    p = np.concatenate([SHARED, TAILS[0]])
    base = dict(_serve(engines[1], lambda: iter([[(5, p)]]), max_new_tokens=8)[0])
    for i, e in enumerate(engines[:2]):
        _hier(e, swap_dir=str(tmp_path / f"tier{i}"))
        blocks = e.kv.allocator.allocate(2)
        e.kv_swap.put_request(5, tokens=30, kv=e.kv, blocks=blocks,
                              fingerprint=_mod(e).token_fingerprint(OTHER[:30]))
        e.kv.allocator.free(blocks)
    runs = _both(engines, lambda: iter([[(5, p)]]), max_new_tokens=8)
    np.testing.assert_array_equal(dict(runs[1][0])[5], base[5])
    for e in engines[:2]:
        assert e.telemetry.counters["kv_swap_in_requests"] == 0
        assert e.kv_swap.request_record(5) is None
        _clean(e)
        _hier(e)


def test_spill_under_pressure_then_restore(engines, tmp_path):
    """A pool of 7 blocks cannot hold the cache and new work: admission
    spills cold prefix blocks to the tier, and a later hit restores them."""
    a = np.concatenate([SHARED, TAILS[0]])

    def arrivals():
        yield [(0, a)]
        yield [(1, OTHER)]
        for _ in range(16):      # the hit arrives once the table has drained
            yield []
        yield [(2, a)]

    base, _, _ = _serve(engines[1], arrivals, pool=7, max_new_tokens=8)
    engines[1].kv.allocator.free(_HOGS.pop(id(engines[1])))
    for i, e in enumerate(engines[:2]):
        _hier(e, cache=True, swap_dir=str(tmp_path / f"tier{i}"))
    runs = _both(engines, arrivals, pool=7, max_new_tokens=8)
    for (u, a), (_, b) in zip(base, runs[1][0]):
        np.testing.assert_array_equal(b, a, err_msg=f"uid={u}")
    c = engines[1].telemetry.counters
    assert c["prefix_blocks_swapped_out"] >= 1 and c["prefix_blocks_swapped_in"] >= 1
    for e, (_, _, hog) in zip(engines[:2], runs):
        _clean(e, hog)
        _hier(e)


def test_deferred_hit_resumes_at_watermark(engines):
    """A hit whose remainder reservation defers keeps its mapped blocks and
    its watermark across the retry; the donor's pages stay clean."""
    a = np.concatenate([SHARED, TAILS[0]])
    c = np.concatenate([SHARED, TAILS[1]])

    def arrivals():
        yield [(0, a, 8)]
        yield [(1, OTHER, 24)]
        for _ in range(8):
            yield []
        yield [(2, c, 24)]
        for _ in range(2):
            yield []
        yield [(3, a, 8)]

    base, _, _ = _serve(engines[1], arrivals, pool=10, max_new_tokens=8)
    engines[1].kv.allocator.free(_HOGS.pop(id(engines[1])))
    for e in engines[:2]:
        _hier(e, cache=True)
    runs = _both(engines, arrivals, pool=10, max_new_tokens=8)
    for (u, x), (_, y) in zip(base, runs[1][0]):
        np.testing.assert_array_equal(y, x, err_msg=f"uid={u}")
    c = engines[1].telemetry.counters
    assert c["prefix_hits"] >= 2 and c["admission_deferrals"] >= 1
    for e, (_, _, hog) in zip(engines[:2], runs):
        _clean(e, hog)
        _hier(e)


def test_prefix_cache_max_blocks_cap(engines):
    for e in engines[:2]:
        _hier(e, cache=True, max_blocks=2)
    _both(engines, _shared_arrivals(4), max_new_tokens=8)
    for e in engines[:2]:
        assert e.prefix_cache.resident_blocks() <= 2
        _clean(e)
        _hier(e)


def test_spec_draft_rides_a_prefix_hit(engines):
    """Self-draft speculative serving: mapped prefix blocks carry the
    draft's pages too (copy-on-write copies them), so the tokens stay the
    cache-off tokens and JAX's."""
    je, te = engines[:2]
    je.attach_draft(jax_build_model("tiny"), je.params)
    te.attach_draft(build_model("tiny"), te.params)
    base = dict(_serve(te, _shared_arrivals(4), max_new_tokens=12)[0])
    for e in (je, te):
        _hier(e, cache=True)
    runs = _both(engines, _shared_arrivals(4), max_new_tokens=12)
    for u, toks in runs[1][0]:
        np.testing.assert_array_equal(toks, base[u], err_msg=f"uid={u} (spec)")
    assert te.telemetry.counters["prefix_hits"] >= 2
    assert te.serve_stats["spec"] == je.serve_stats["spec"]
    for e in (je, te):
        _clean(e)
        _hier(e)
