"""Multi-tenant admission and scheduling in the port, held to the JAX
package: token buckets, the shed controller's levels, the weighted-fair
queue's dequeue order, its victims and sweeps, and a whole engine's
dequeue order, per-tenant outcomes and served outputs — each scenario run
through both packages with the same injected clocks and numpy-seeded
request streams, compared exactly. Then the JAX package's fairness
invariants (tests/test_serve_fairness.py) on the port: a greedy tenant at
10x its quota, preemption under a full queue, the admission audit span in
the request's trace tree, the fast-shed probe, default traffic never shed,
and the kill switches.

Tests synchronise on events, queue state and injected clocks, not on
sleeps; counters are read as deltas (each package's metrics registry is
process-wide).
"""

import threading
import time
import types

import numpy as np
import pytest

from spark_rapids_ml_tpu import PCA as JaxPCA
from spark_rapids_ml_tpu.obs import get_registry as jax_registry
from spark_rapids_ml_tpu.serve import FairQueue as JaxFairQueue
from spark_rapids_ml_tpu.serve import ModelRegistry as JaxModelRegistry
from spark_rapids_ml_tpu.serve import ServeEngine as JaxEngine
from spark_rapids_ml_tpu.serve import ShedController as JaxShedController
from spark_rapids_ml_tpu.serve import ShedLoad as JaxShedLoad
from spark_rapids_ml_tpu.serve import TokenBucket as JaxTokenBucket
from spark_rapids_ml_tpu.serve.admission import (
    AdmissionController as JaxAdmissionController,
)
from spark_rapids_ml_tpu_torch import PCAModel
from spark_rapids_ml_tpu_torch.obs import spans as spans_mod
from spark_rapids_ml_tpu_torch.obs import tracectx
from spark_rapids_ml_tpu_torch.obs.metrics import get_registry
from spark_rapids_ml_tpu_torch.serve import (
    DeadlineExpired,
    FairQueue,
    FifoQueue,
    MicroBatcher,
    ModelRegistry,
    QueueFull,
    ServeEngine,
    ShedController,
    ShedLoad,
    TokenBucket,
    fair_scheduling_from_env,
)
from spark_rapids_ml_tpu_torch.serve.admission import (
    OVERFLOW_TENANT,
    AdmissionController,
    parse_tenant_quotas,
    parse_tenant_weights,
)

WAIT = 30.0
TENANTS = ("alpha", "beta", "gamma")
PRIORITIES = ("interactive", "batch")


@pytest.fixture(autouse=True)
def _cpu_requested(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")


class _FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _counter(registry, name, **labels):
    family = registry.snapshot().get(name, {"samples": []})
    return sum(s["value"] for s in family["samples"]
               if all(s["labels"].get(k) == v for k, v in labels.items()))


def _until(predicate, timeout=WAIT):
    end = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > end:
            raise AssertionError("condition not reached")
        time.sleep(0.001)


def _req(i, n=8, tenant="default", priority="interactive", over_quota=False,
         expired=False):
    """A scheduler-visible request stand-in (the queues read n, tenant,
    priority, over_quota and expired)."""
    return types.SimpleNamespace(
        id=i, n=n, tenant=tenant, priority=priority, over_quota=over_quota,
        expired=lambda now=None, _e=expired: _e)


def _forced_shed(cls, clock=None):
    """A controller pinned at level 2: signals injected once, never
    refreshed, never de-escalated."""
    kw = {"clock": clock} if clock is not None else {}
    shed = cls(refresh_seconds=1e9, hold_seconds=1e9, **kw)
    shed.note_signals(burn=100.0, queue_wait_s=10.0, depth_frac=1.0)
    return shed


# -- token buckets and admission, against the JAX package --------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_token_bucket_verdicts_and_refills_match_jax(seed):
    rng = np.random.default_rng(seed)
    rate = float(rng.choice([0.0, 5.0, 100.0, 2500.0]))
    burst = float(rng.choice([1.0, 50.0, 400.0]))
    clocks = (_FakeClock(), _FakeClock())
    ours = TokenBucket(rate, burst, clock=clocks[0])
    theirs = JaxTokenBucket(rate, burst, clock=clocks[1])
    assert (ours.rate, ours.burst, ours.unlimited) == (
        theirs.rate, theirs.burst, theirs.unlimited)
    for _ in range(300):
        dt = float(rng.exponential(0.05))
        n = int(rng.integers(1, 200))
        for c in clocks:
            c.advance(dt)
        assert ours.take(n) == theirs.take(n)
        assert ours.tokens() == theirs.tokens()


def test_parse_tenant_quotas_and_weights_match_jax():
    from spark_rapids_ml_tpu.serve.admission import (
        parse_tenant_quotas as jax_quotas,
        parse_tenant_weights as jax_weights,
    )

    for raw in ("a:1000:2000, b:50;c:7", "bad,:5,x:y,ok:10", "", "z:0"):
        assert parse_tenant_quotas(raw) == jax_quotas(raw)
    assert parse_tenant_quotas("a:1000:2000, b:50;c:7") == {
        "a": (1000.0, 2000.0), "b": (50.0, 200.0), "c": (7.0, 28.0)}
    for raw in ("a:4,b:1", "a:4:1,b:-1,c:x,d:0.5", ""):
        assert parse_tenant_weights(raw) == jax_weights(raw)


@pytest.mark.parametrize("seed", [0, 1])
def test_admission_verdicts_match_jax(seed):
    """A seeded stream of (tenant, priority, rows, clock step) through both
    controllers with a live shed controller on the same scripted signals:
    the same decisions, sheds and reasons."""
    rng = np.random.default_rng(seed)
    clocks = (_FakeClock(), _FakeClock())
    quotas = {"alpha": (200.0, 400.0), "beta": 30.0}
    ctrls = []
    for cls, shed_cls, clock in ((AdmissionController, ShedController,
                                  clocks[0]),
                                 (JaxAdmissionController, JaxShedController,
                                  clocks[1])):
        shed = shed_cls(burn_threshold=14.4, queue_wait_target_s=0.1,
                        depth_frac_target=0.5, hold_seconds=1.0,
                        refresh_seconds=0.25, clock=clock)
        ctrl = cls(tenant_quotas=quotas, max_tenants=3, shed=shed,
                   default_tenant="default", default_priority="interactive",
                   default_rate=0.0, clock=clock)
        ctrls.append(ctrl)
    signals = {"burn": 0.0, "queue_wait_s": 0.0, "depth_frac": 0.0}
    for ctrl in ctrls:
        ctrl.bind(lambda: dict(signals), lambda: 2.5)
    names = TENANTS + ("default", "delta", None)
    for step in range(400):
        if step % 40 == 0:
            signals = {"burn": float(rng.choice([0.0, 20.0])),
                       "queue_wait_s": float(rng.choice([0.0, 0.3])),
                       "depth_frac": float(rng.uniform(0.0, 0.6))}
        dt = float(rng.exponential(0.03))
        tenant = names[int(rng.integers(len(names)))]
        priority = PRIORITIES[int(rng.integers(2))]
        rows = int(rng.integers(1, 64))
        results = []
        for ctrl, clock in zip(ctrls, clocks):
            clock.advance(dt)
            fast = ctrl.fast_shed(tenant, priority)
            try:
                d = ctrl.admit(tenant, priority, rows, model="m")
                results.append((fast is None, fast and fast.reason,
                                d.tenant, d.priority, d.over_quota,
                                d.decision))
            except (ShedLoad, JaxShedLoad) as exc:
                results.append((fast is None, fast and fast.reason,
                                exc.tenant, exc.reason, exc.retry_after))
        assert results[0] == results[1], step
        assert ctrls[0].shed.level() == ctrls[1].shed.level()
    snaps = [c.snapshot() for c in ctrls]
    assert snaps[0]["tenants"].keys() == snaps[1]["tenants"].keys()
    assert snaps[0]["shed"] == snaps[1]["shed"]


def test_admission_tenant_cardinality_bounded():
    ctrl = AdmissionController(
        max_tenants=2, clock=_FakeClock(),
        shed=ShedController(enabled=False, clock=_FakeClock()),
    )
    assert ctrl.admit("a", None, 1).tenant == "a"
    assert ctrl.admit("b", None, 1).tenant == "b"
    assert ctrl.resolve_tenant("c") == OVERFLOW_TENANT
    assert ctrl.admit("zz", None, 1).tenant == OVERFLOW_TENANT
    assert ctrl.resolve_tenant("a") == "a"


# -- the shed controller, against the JAX package ----------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shed_controller_levels_match_jax(seed):
    """A scripted signal sequence (pressure on and off, burn on and off,
    healthy stretches shorter and longer than the hold) drives both
    controllers through levels 0/1/2 with the hysteresis; every level,
    verdict and snapshot agrees."""
    rng = np.random.default_rng(seed)
    clocks = (_FakeClock(), _FakeClock())
    ctrls = [cls(burn_threshold=14.4, queue_wait_target_s=0.1,
                 depth_frac_target=0.5, hold_seconds=2.0, clock=clock)
             for cls, clock in ((ShedController, clocks[0]),
                                (JaxShedController, clocks[1]))]
    levels = []
    for _ in range(300):
        dt = float(rng.choice([0.1, 0.5, 1.0, 2.5]))
        burn = float(rng.choice([0.0, 5.0, 14.4, 30.0]))
        wait = float(rng.choice([0.0, 0.05, 0.1, 0.5]))
        depth = float(rng.choice([0.0, 0.3, 0.5, 0.9]))
        got = []
        for ctrl, clock in zip(ctrls, clocks):
            clock.advance(dt)
            got.append((ctrl.note_signals(burn=burn, queue_wait_s=wait,
                                          depth_frac=depth),
                        ctrl.level(), ctrl.pressure(),
                        [ctrl.decide(p, q) for p in PRIORITIES
                         for q in (False, True)]))
        assert got[0] == got[1]
        assert ctrls[0].snapshot() == ctrls[1].snapshot()
        levels.append(got[0][0])
    assert set(levels) == {0, 1, 2}


def test_shed_controller_levels_and_hysteresis():
    clock = _FakeClock()
    shed = ShedController(burn_threshold=14.4, queue_wait_target_s=0.1,
                          depth_frac_target=0.5, hold_seconds=2.0,
                          clock=clock)
    assert shed.level() == 0 and shed.decide("batch", True) is None
    shed.note_signals(burn=0.0, queue_wait_s=0.5, depth_frac=0.0)
    assert shed.level() == 1
    assert shed.decide("batch", True) == "over_quota_batch"
    assert shed.decide("batch", False) is None
    assert shed.decide("interactive", True) is None
    shed.note_signals(burn=20.0, queue_wait_s=0.5, depth_frac=0.0)
    assert shed.level() == 2
    assert shed.decide("interactive", True) == "over_quota"
    assert shed.decide("interactive", False) is None
    shed.note_signals(burn=0.0, queue_wait_s=0.0, depth_frac=0.0)
    clock.advance(1.0)
    shed.note_signals(burn=0.0, queue_wait_s=0.0, depth_frac=0.0)
    assert shed.level() == 2  # the hold has not elapsed
    clock.advance(1.5)
    shed.note_signals(burn=0.0, queue_wait_s=0.0, depth_frac=0.0)
    assert shed.level() == 0
    off = ShedController(enabled=False, clock=clock)
    off.note_signals(burn=100.0, queue_wait_s=10.0, depth_frac=1.0)
    assert off.level() == 0 and off.decide("batch", True) is None


# -- the fair queue, against the JAX package ---------------------------------


def _stream(seed, n=200):
    """n requests of 3 tenants x 2 priorities, row counts 1..64, about a
    quarter over quota."""
    rng = np.random.default_rng(seed)
    return [dict(i=i, n=int(rng.integers(1, 65)),
                 tenant=TENANTS[int(rng.integers(3))],
                 priority=PRIORITIES[int(rng.integers(2))],
                 over_quota=bool(rng.random() < 0.25))
            for i in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fair_queue_dequeue_order_matches_jax(seed):
    """The seeded 200-request stream, appended and popped in a seeded
    interleaving, with tenant weights, over-quota demotion and a pressure
    flip every 37 operations (including between a peek and its pop): the
    same requests leave both queues in the same order."""
    weights = {"alpha": 4.0, "beta": 1.0, "gamma": 0.5}
    pressure = {"on": False}
    queues = [cls(tenant_weights=weights, pressure_fn=lambda: pressure["on"])
              for cls in (FairQueue, JaxFairQueue)]
    stream = _stream(seed)
    rng = np.random.default_rng(seed + 100)
    orders = ([], [])
    pos, ops = 0, 0
    while pos < len(stream) or queues[0]:
        ops += 1
        if ops % 37 == 0:
            pressure["on"] = not pressure["on"]
        if pos < len(stream) and (not queues[0] or rng.random() < 0.6):
            for q in queues:
                q.append(_req(**stream[pos]))
            pos += 1
            continue
        peeked = [q.peek().id for q in queues]
        if ops % 5 == 0:
            pressure["on"] = not pressure["on"]  # between peek and pop
        popped = [q.popleft().id for q in queues]
        assert peeked == popped
        for order, i in zip(orders, popped):
            order.append(i)
    assert orders[0] == orders[1]
    assert sorted(orders[0]) == list(range(len(stream)))
    # and the pressure changed the order: not plain arrival order
    assert orders[0] != list(range(len(stream)))


@pytest.mark.parametrize("seed", [0, 1])
def test_select_victim_and_pop_expired_match_jax(seed):
    """A full queue receiving seeded arrivals: each package picks the same
    victim (or none), and whole-queue sweeps of expired entries return
    the same requests."""
    stream = _stream(seed, n=120)
    rng = np.random.default_rng(seed + 7)
    expired = set(int(i) for i in rng.choice(120, 30, replace=False))
    queues = [FairQueue(), JaxFairQueue()]
    depth, picks, sweeps = 12, ([], []), ([], [])

    def make(spec):
        return _req(spec["i"], spec["n"], spec["tenant"], spec["priority"],
                    spec["over_quota"], expired=spec["i"] in expired)

    for k, spec in enumerate(stream):
        for q, got in zip(queues, picks):
            if len(q) >= depth:
                victim = q.select_victim(make(spec))
                got.append(None if victim is None else victim.id)
                if victim is None:
                    continue
            q.append(make(spec))
        if k % 10 == 9:
            for q, got in zip(queues, sweeps):
                got.append([r.id for r in q.pop_expired()])
        if k % 4 == 3:
            assert queues[0].popleft().id == queues[1].popleft().id
    assert picks[0] == picks[1] and sweeps[0] == sweeps[1]
    assert any(p is not None for p in picks[0])
    assert any(p is None for p in picks[0])
    assert any(sweeps[0])


def test_fifo_queue_declines_preemption_and_sweeps_nothing():
    q = FifoQueue()
    reqs = [_req(i, i + 1, expired=True) for i in range(4)]
    for r in reqs:
        q.append(r)
    assert len(q) == 4 and q.peek() is reqs[0]
    assert q.select_victim(_req(9, priority="interactive")) is None
    assert q.pop_expired() == [] and len(q) == 4
    assert [q.popleft() for _ in range(4)] == reqs
    assert not q
    with pytest.raises(IndexError):
        q.popleft()


def test_fair_queue_single_flow_is_fifo_and_greedy_cannot_starve():
    q = FairQueue()
    reqs = [_req(i, n) for i, n in enumerate((8, 64, 1, 32, 8))]
    for r in reqs:
        q.append(r)
    assert [q.popleft() for _ in range(len(reqs))] == reqs
    greedy = [_req(i, 64, tenant="greedy") for i in range(10)]
    compliant = [_req(10 + i, 8, tenant="compliant") for i in range(3)]
    for r in greedy + compliant:
        q.append(r)
    order = [q.popleft() for _ in range(13)]
    positions = [order.index(r) for r in compliant]
    assert positions[0] <= 1 and max(positions) <= 5
    assert [r for r in order if r.tenant == "greedy"] == greedy


# -- the batcher: preemption and the whole-queue sweep -----------------------


class _Blocking:
    """A blocking transform: the first call waits on ``release``."""

    def __init__(self):
        self.started = threading.Event()
        self.release = threading.Event()

    def __call__(self, matrix):
        self.started.set()
        assert self.release.wait(WAIT)
        return matrix


def test_preemption_under_full_queue_micro_batcher():
    gate = _Blocking()
    batcher = MicroBatcher(gate, name="preempt", max_batch_rows=8,
                           max_wait_ms=1.0, max_queue_depth=2,
                           queue=FairQueue())
    reg = get_registry()
    before = _counter(reg, "sparkml_serve_shed_total", tenant="g",
                      reason="preempted")
    try:
        batcher.submit(np.ones((8, 2)))
        assert gate.started.wait(WAIT)  # the worker is inside a batch
        victims = [batcher.submit(np.ones((8, 2)), tenant="g",
                                  priority="batch", over_quota=True)
                   for _ in range(2)]
        vip = batcher.submit(np.ones((8, 2)), tenant="c",
                             priority="interactive")
        shed = [v for v in victims if v.error is not None]
        assert len(shed) == 1
        with pytest.raises(ShedLoad) as exc_info:
            shed[0].wait(0.1)
        assert exc_info.value.reason == "preempted"
        assert exc_info.value.retry_after >= 1.0
        assert _counter(reg, "sparkml_serve_shed_total", tenant="g",
                        reason="preempted") == before + 1
        # nothing strictly lower-ranked left to evict: rejected
        with pytest.raises(QueueFull):
            batcher.submit(np.ones((8, 2)), tenant="g2", priority="batch",
                           over_quota=True)
        gate.release.set()
        assert vip.wait(WAIT).shape == (8, 2)
    finally:
        gate.release.set()
        batcher.close(drain=False, timeout=5.0)


def test_batcher_sweeps_an_expired_batch_request_under_pressure():
    gate = _Blocking()
    batcher = MicroBatcher(gate, name="sweep", max_batch_rows=8,
                           max_wait_ms=1.0, max_queue_depth=8,
                           queue=FairQueue(pressure_fn=lambda: True))
    try:
        batcher.submit(np.ones((8, 2)))
        assert gate.started.wait(WAIT)
        doomed = batcher.submit(np.ones((8, 2)), tenant="g",
                                priority="batch",
                                deadline=time.monotonic() + 0.05)
        vip = batcher.submit(np.ones((8, 2)), priority="interactive")
        _until(lambda: doomed.expired())
        gate.release.set()
        assert vip.wait(WAIT).shape == (8, 2)
        # swept (DeadlineExpired), not stranded behind interactive-first
        with pytest.raises(DeadlineExpired):
            doomed.wait(WAIT)
    finally:
        gate.release.set()
        batcher.close(drain=False, timeout=5.0)


def test_queue_wait_estimate_follows_waits_and_decays():
    batcher = MicroBatcher(lambda m: m, name="ewma", max_wait_ms=1.0)
    try:
        assert batcher.queue_wait_estimate() == 0.0
        batcher._note_queue_wait(1.0)
        first = batcher.queue_wait_estimate()
        assert 0.19 < first <= 0.2
        batcher._wait_ewma_at -= 2.0  # two idle seconds halve it
        assert batcher.queue_wait_estimate() == pytest.approx(first / 2,
                                                              rel=1e-3)
    finally:
        batcher.close()


# -- the engine: the JAX package's fairness invariants on the port -----------


class _Slow:
    def __init__(self, delay=0.0):
        self.delay = delay

    def transform(self, matrix):
        if self.delay:
            time.sleep(self.delay)
        return np.asarray(matrix)


def _engine(shed=None, **kw):
    registry = ModelRegistry()
    registry.register("fair_m", _Slow(kw.pop("delay", 0.0)))
    return ServeEngine(registry, max_batch_rows=8, max_wait_ms=1.0,
                       retries=0, shed=shed, **kw)


def test_starvation_greedy_10x_quota_compliant_availability():
    """A greedy tenant far over its quota, from 4 threads, never drops the
    compliant tenant's availability below 1.0; the flood absorbs the
    sheds."""
    eng = _engine(shed=_forced_shed(ShedController),
                  tenant_quotas={"greedy": (1.0, 1.0)}, delay=0.002)
    stop = threading.Event()
    counts = {"ok": 0, "shed": 0, "other": 0}
    lock = threading.Lock()

    def greedy_client():
        while not stop.is_set():
            try:
                eng.predict("fair_m", np.ones((4, 2)), tenant="greedy",
                            priority="batch")
                key = "ok"
            except ShedLoad:
                key = "shed"
            except Exception:  # noqa: BLE001 - counted, asserted below
                key = "other"
            with lock:
                counts[key] += 1

    workers = [threading.Thread(target=greedy_client, daemon=True)
               for _ in range(4)]
    try:
        for w in workers:
            w.start()
        _until(lambda: counts["shed"] >= 10)
        served = 0
        for _ in range(30):
            out = eng.predict("fair_m", np.ones((2, 2)), tenant="compliant",
                              priority="interactive")
            assert out.shape == (2, 2)
            served += 1
    finally:
        stop.set()
        for w in workers:
            w.join(WAIT)
        eng.shutdown()
    assert not any(w.is_alive() for w in workers)
    assert served == 30
    assert counts["shed"] > 0 and counts["other"] == 0


def _find(nodes, name):
    for node in nodes:
        if node["name"] == name:
            return node
        hit = _find(node.get("children", []), name)
        if hit is not None:
            return hit
    return None


def test_shed_audit_span_nests_under_the_request_span():
    eng = _engine(shed=_forced_shed(ShedController),
                  tenant_quotas={"g": (1.0, 1.0)})
    try:
        ctx = tracectx.new_context()
        with pytest.raises(ShedLoad) as exc_info:
            with tracectx.activate(ctx):
                eng.predict("fair_m", np.ones((4, 2)), tenant="g",
                            priority="batch")
        assert exc_info.value.retry_after >= 1.0
        tree = spans_mod.assemble_trace(ctx.trace_id)
        request = _find(tree["spans"], "serve:request:fair_m")
        assert request is not None, tree
        audit = _find(request["children"], "serve:admission")
        assert audit is not None, tree
        assert audit["args"]["decision"] == "shed"
        assert audit["args"]["tenant"] == "g"
        assert "retry_after" in audit["args"]
        assert request["args"]["error"] == "ShedLoad"
    finally:
        eng.shutdown()


def test_served_request_trace_holds_queue_and_linked_batch_spans():
    eng = _engine()
    try:
        ctx = tracectx.new_context()
        with tracectx.activate(ctx):
            result = eng.predict_detailed("fair_m", np.ones((3, 2)),
                                          tenant="t")
        assert result.trace_id == ctx.trace_id
        tree = spans_mod.assemble_trace(ctx.trace_id)
        request = _find(tree["spans"], "serve:request:fair_m")
        queue = _find(request["children"], "serve:queue:fair_m")
        assert queue is not None and queue["args"]["rows"] == 3
        batch = _find(tree["spans"], "serve:batch:fair_m")
        assert batch is not None and batch["link"] is True
        assert ctx.trace_id in batch["links"]
    finally:
        eng.shutdown()


def test_fast_shed_preparse_probe():
    eng = _engine(shed=_forced_shed(ShedController),
                  tenant_quotas={"g": (0.000001, 0.000001)})
    reg = get_registry()
    before = _counter(reg, "sparkml_serve_tenant_requests_total",
                      tenant="g", outcome="shed")
    try:
        eng.admission._bucket_for("g").take(1)  # dry the bucket
        exc = eng.fast_shed("g", "batch")
        assert isinstance(exc, ShedLoad) and exc.tenant == "g"
        assert exc.reason == "over_quota"
        assert eng.fast_shed("someone", "batch") is None  # unlimited
        assert eng.fast_shed(None, "batch") is None  # header-less
        assert isinstance(eng.fast_shed("g", "interactive"), ShedLoad)
        assert _counter(reg, "sparkml_serve_tenant_requests_total",
                        tenant="g", outcome="shed") == before + 2
    finally:
        eng.shutdown()


def test_no_shedding_for_default_traffic_and_kill_switches(monkeypatch):
    eng = _engine(shed=_forced_shed(ShedController))
    try:
        for _ in range(5):
            assert eng.predict("fair_m", np.ones((2, 2))).shape == (2, 2)
        (batcher,) = eng._batchers.values()
        assert isinstance(batcher._queue, FairQueue)
    finally:
        eng.shutdown()
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_SERVE_SCHED", "fifo")
    assert fair_scheduling_from_env() is False
    eng2 = _engine()
    try:
        assert eng2.fair_scheduling is False
        eng2.predict("fair_m", np.ones((2, 2)))
        (batcher,) = eng2._batchers.values()
        assert isinstance(batcher._queue, FifoQueue)
    finally:
        eng2.shutdown()
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_SERVE_SCHED", "fair")
    assert fair_scheduling_from_env() is True
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_SERVE_SHED", "0")
    assert ShedController().enabled is False
    eng3 = _engine()
    try:
        assert eng3.admission.shed.enabled is False
        assert eng3.shed_posture().level() == 0
    finally:
        eng3.shutdown()


def test_env_knobs_use_the_port_prefix(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_SERVE_TENANT_QUOTAS",
                       "q:10:20")
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_SERVE_TENANT_WEIGHTS", "q:3")
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_SERVE_PRIORITY_DEFAULT",
                       "batch")
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_SERVE_SHED_QUEUE_WAIT_MS",
                       "20")
    monkeypatch.setenv("SPARK_RAPIDS_ML_TPU_SERVE_SHED_DEPTH_FRAC", "0.9")
    ctrl = AdmissionController(clock=_FakeClock())
    assert ctrl._quota_config == {"q": (10.0, 20.0)}
    assert ctrl.weight_for("q") == 3.0
    assert ctrl.resolve_priority(None) == "batch"
    assert ctrl.shed.queue_wait_target_s == 0.02
    assert ctrl.shed.depth_frac_target == 0.5  # the JAX prefix is ignored


def test_retry_after_is_twice_the_wait_clamped():
    eng = _engine()
    try:
        eng.predict("fair_m", np.ones((2, 2)))
        (batcher,) = eng._batchers.values()
        assert eng.retry_after_estimate() == 1.0
        batcher._wait_ewma, batcher._wait_ewma_at = 3.0, time.monotonic()
        assert 5.9 < eng.retry_after_estimate() <= 6.0
        batcher._wait_ewma = 100.0
        assert eng.retry_after_estimate() == 30.0
        state = eng.overload_state()
        assert state["fair_scheduling"] is True
        assert state["retry_after_seconds"] == 30.0
    finally:
        eng.shutdown()


def test_slo_records_outcomes_and_burn_trips_the_breaker():
    from spark_rapids_ml_tpu_torch.serve import (
        BreakerOpen,
        InjectedBackendError,
        fault_plane,
        reset_fault_plane,
    )

    eng = _engine(breaker_burn_threshold=14.4, breaker_failures=100)
    reset_fault_plane()
    errors = []
    try:
        for _ in range(30):
            eng.predict("fair_m", np.ones((2, 2)))
        fault_plane().inject("fair_m", "raise", count=None)
        for _ in range(5):
            with pytest.raises((InjectedBackendError, BreakerOpen)) as exc:
                eng.predict("fair_m", np.ones((2, 2)))
            errors.append(type(exc.value).__name__)
        snap = eng.slo_snapshot()
        avail = [s for s in snap["slos"]
                 if s["name"] == "serve_availability"][0]
        assert avail["window_total"] == 35 and avail["window_good"] == 30
        # the first backend failure makes the 5-minute burn 1/31 / 0.001
        # = 32 > 14.4: the breaker opens long before 100 consecutive
        # failures, and the model (no CPU fallback) sheds from then on
        assert errors == ["InjectedBackendError"] + ["BreakerOpen"] * 4
        assert eng.breaker_snapshot()["fair_m"]["state"] == "open"
        assert "slo_fast_burn" in eng.breaker_snapshot()["fair_m"][
            "last_error"]
    finally:
        reset_fault_plane()
        eng.shutdown()


# -- the whole slice, against the JAX package --------------------------------


class _Held:
    """A registry model over a PCA model: its first transform blocks on
    ``release`` (holding the worker), and every call records the rows it
    was given. No serving program, so both engines take the blocking path
    through ``transform``."""

    def __init__(self, model):
        self.model = model
        self.entered = threading.Event()
        self.release = threading.Event()
        self.seen = []

    def getOutputCol(self):
        return self.model.getOutputCol()

    def transform(self, matrix):
        self.entered.set()
        assert self.release.wait(WAIT)
        self.seen.append(np.array(matrix))
        return self.model.transform(matrix)


def _script(seed):
    """The scripted requests: (tenant, priority, rows)."""
    rng = np.random.default_rng(seed)
    plan = []
    for _ in range(30):
        tenant = str(rng.choice(["compliant", "greedy", "steady"],
                                p=[0.4, 0.3, 0.3]))
        priority = "interactive" if tenant == "compliant" else "batch"
        plan.append((tenant, priority, int(rng.integers(2, 9))))
    return plan


def _drive(engine, held, plan, rows, registry):
    """Hold the worker, submit ``plan`` one request at a time (each
    processed — queued, rejected or shed — before the next), release,
    and return ({request: outcome}, {request: output}, batches seen,
    per-tenant counter deltas)."""
    tenants = ("compliant", "greedy", "steady")
    outcomes_of = ("ok", "shed", "rejected", "expired", "error")

    def tenant_counts():
        return {(t, o): _counter(registry,
                                 "sparkml_serve_tenant_requests_total",
                                 tenant=t, outcome=o)
                for t in tenants for o in outcomes_of}

    start = tenant_counts()
    outcomes, outputs, threads = {}, {}, []

    def client(i, tenant, priority, x):
        try:
            outputs[i] = engine.predict("m", x, tenant=tenant,
                                        priority=priority, timeout=WAIT)
            outcomes[i] = "ok"
        except Exception as exc:  # noqa: BLE001 - compared across packages
            outcomes[i] = (type(exc).__name__, getattr(exc, "reason", None))

    first = threading.Thread(target=client, args=(-1, "compliant",
                                                  "interactive", rows[-1]))
    first.start()
    threads.append(first)
    assert held.entered.wait(WAIT)
    batcher = next(iter(engine._batchers.values()))
    calls = [0]
    submit = batcher.submit

    def counted_submit(*args, **kwargs):
        try:
            return submit(*args, **kwargs)
        finally:
            calls[0] += 1

    batcher.submit = counted_submit
    for i, (tenant, priority, _n) in enumerate(plan):
        before = calls[0]
        t = threading.Thread(target=client, args=(i, tenant, priority,
                                                  rows[i]))
        t.start()
        threads.append(t)
        _until(lambda: calls[0] > before or not t.is_alive())
    held.release.set()
    for t in threads:
        t.join(WAIT)
    assert not any(t.is_alive() for t in threads)
    end = tenant_counts()
    deltas = {k: end[k] - start[k] for k in end if end[k] != start[k]}
    return outcomes, outputs, held.seen, deltas


@pytest.mark.parametrize("fair", [True, False])
def test_whole_slice_matches_jax(rng, fair):
    """Both engines behind a forced level-2 shed controller and the same
    quotas and weights; the same scripted requests are submitted while the
    worker is held, then released. The model sees the requests in the same
    batches and order, every request ends the same way, the per-tenant
    counters move alike, and served outputs agree at 1e-12 (float64)."""
    x = rng.normal(size=(400, 64)) * (1.0 + np.arange(64)) ** -0.5
    ref = JaxPCA().setK(8).setDtype("float64").fit(x)
    port = PCAModel.from_numpy(ref.pc, ref.explained_variance,
                               ref.mean).setDtype("float64")
    plan = _script(3)
    rows = {i: rng.normal(size=(n, 64)) for i, (_, _, n) in enumerate(plan)}
    rows[-1] = rng.normal(size=(4, 64))
    ids = {float(r[j, 0]): (i, j) for i, r in rows.items()
           for j in range(r.shape[0])}
    quotas = {"greedy": (1e-9, 20.0)}
    weights = {"compliant": 2.0, "steady": 0.5}
    results = []
    for engine_cls, registry_cls, shed_cls, model, registry in (
            (ServeEngine, ModelRegistry, ShedController, port,
             get_registry()),
            (JaxEngine, JaxModelRegistry, JaxShedController, ref,
             jax_registry())):
        clock = _FakeClock()
        held = _Held(model)
        reg = registry_cls()
        reg.register("m", held)
        engine = engine_cls(
            reg, max_batch_rows=16, max_wait_ms=1.0, max_queue_depth=10,
            retries=0, pipeline_depth=1, fair_scheduling=fair,
            shed=_forced_shed(shed_cls, clock), tenant_quotas=quotas,
            tenant_weights=weights, clock=clock)
        try:
            outcomes, outputs, seen, deltas = _drive(engine, held, plan,
                                                     rows, registry)
        finally:
            held.release.set()
            engine.shutdown()
        # the blocking path pads each batch to its bucket with zero rows
        order = [[ids[float(v)] for v in batch[:, 0] if v != 0.0]
                 for batch in seen]
        results.append((outcomes, outputs, order, deltas))
    (ours, our_out, our_order, our_deltas), \
        (theirs, their_out, their_order, their_deltas) = results
    assert our_order == their_order
    assert ours == theirs
    assert our_deltas == their_deltas
    kinds = set(map(str, ours.values()))
    assert "ok" in kinds and any("ShedLoad" in k for k in kinds)
    assert any("QueueFull" in k for k in kinds)
    if fair:
        assert ("ShedLoad", "preempted") in ours.values()
    for i, out in our_out.items():
        want = np.asarray(their_out[i])
        assert out.shape == want.shape == (rows[i].shape[0], 8)
        assert np.abs(out - want).max() <= 1e-12 * np.abs(want).max()
