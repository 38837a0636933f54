"""The port's tiering plane (``serve/tiering.py``) against the JAX
package's: the same policy scenarios, on one injected clock, through both
``TieringController``s over engines that only act out the tiering surface
give the same decisions, states, counters, gauges, span events and
lifecycle history; admission's reactivation gate; the live CPU engine
parked, drained and brought back; and the ``/debug/costs``,
``/debug/tiering`` and ``/debug/slo`` routes against the JAX engine's
documents.

The policy scenarios give each package's controller and ledger a metrics
registry of their own (``get_registry`` patched in the modules), so the
comparison sees only the scenario's series. Engine tests reset the
process-wide ledgers before building engines, use a width no JAX test
compiles, and synchronise on events, queue state and the injected
clock."""

import http.client
import json
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu import PCA as JaxPCA
from spark_rapids_ml_tpu.obs import accounting as jax_accounting
from spark_rapids_ml_tpu.obs import spans as jax_spans
from spark_rapids_ml_tpu.obs.metrics import MetricsRegistry as JaxMetrics
from spark_rapids_ml_tpu.serve import ModelRegistry as JaxRegistry
from spark_rapids_ml_tpu.serve import ServeEngine as JaxEngine
from spark_rapids_ml_tpu.serve import ShedController as JaxShedController
from spark_rapids_ml_tpu.serve import ShedLoad as JaxShedLoad
from spark_rapids_ml_tpu.serve import tiering as jax_tiering
from spark_rapids_ml_tpu.serve.admission import (
    AdmissionController as JaxAdmissionController,
)
from spark_rapids_ml_tpu_torch import PCAModel
from spark_rapids_ml_tpu_torch.obs import accounting
from spark_rapids_ml_tpu_torch.obs import devmon, tsdb
from spark_rapids_ml_tpu_torch.obs import spans
from spark_rapids_ml_tpu_torch.obs.accounting import COMPONENT_WEIGHTS
from spark_rapids_ml_tpu_torch.obs.metrics import MetricsRegistry
from spark_rapids_ml_tpu_torch.obs.metrics import get_registry
from spark_rapids_ml_tpu_torch.serve import (
    ModelRegistry,
    ServeEngine,
    ShedController,
    ShedLoad,
    start_serve_server,
)
from spark_rapids_ml_tpu_torch.serve import tiering
from spark_rapids_ml_tpu_torch.serve.admission import AdmissionController
from spark_rapids_ml_tpu_torch.serve.tiering import (
    ACTIVE,
    COLD,
    DEACTIVATING,
    STATE_CODES,
    TieringController,
)

WAIT = 30.0
N_FEAT = 20  # no JAX test compiles this width
SIZES = {"tq0": 3000, "tq1": 2000, "tq2": 1000}
TIERING_FAMILIES = ("sparkml_serve_tiering_total",
                    "sparkml_serve_tiering_state",
                    "sparkml_serve_errors_total")


@pytest.fixture(autouse=True)
def _cpu_requested(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")


def _until(predicate, timeout=WAIT):
    end = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > end:
            raise AssertionError("condition not reached")
        time.sleep(0.001)


# -- the policy: both controllers over engines that act out tiering ----------


class _TierEngine:
    """Just enough engine for the controller's policy surface (the JAX
    test's stub, without autoscale or placement): a clock-injected ledger
    of the package under test, registry names and the two actuators."""

    def __init__(self, ledger_cls, clock):
        self._ledger = ledger_cls(clock=clock, enabled=True)
        self._names = list(SIZES)
        self.registry = SimpleNamespace(names=lambda: list(self._names))
        self.deactivated = []
        self.reactivated = []
        self.fail_reactivate = False
        for name, nbytes in SIZES.items():
            self._ledger.charge_memory(name, 1, "cpu:0", COMPONENT_WEIGHTS,
                                       nbytes)

    def deactivate(self, name):
        self.deactivated.append(name)
        self._ledger.release_memory(name)
        return [f"{name}@1"]

    def reactivate(self, name):
        if self.fail_reactivate:
            raise RuntimeError("replay failed")
        self.reactivated.append(name)
        self._ledger.charge_memory(name, 1, "cpu:0", COMPONENT_WEIGHTS,
                                   SIZES.get(name, 500))
        return {"model": name, "version": 1, "buckets": [64]}

    def model_algos(self, name):  # the JAX controller's cache protection
        return ("pca",)


class _Side:
    """One package's controller, engine and metrics under one clock; every
    ``observe`` appends what the comparison holds equal."""

    def __init__(self, jax, monkeypatch, now):
        self.jax = jax
        self.now = now
        self.registry = JaxMetrics() if jax else MetricsRegistry()
        for mod in ((jax_tiering, jax_accounting) if jax
                    else (tiering, accounting)):
            monkeypatch.setattr(mod, "get_registry", lambda: self.registry)
        ledger_cls = (jax_accounting.ResourceLedger if jax
                      else accounting.ResourceLedger)
        self.engine = _TierEngine(ledger_cls, lambda: now[0])
        self.recorder = (jax_spans if jax else spans).get_recorder()
        self.t0 = time.perf_counter()
        self.ctl = None
        self.log = []

    def make(self, **kw):
        kw.setdefault("hbm_budget_bytes", 0)
        kw.setdefault("flap_floor_s", 0.0)
        kw.setdefault("enabled", True)
        if self.jax:
            kw["per_model_autoscale"] = False
        cls = (jax_tiering.TieringController if self.jax
               else TieringController)
        self.ctl = cls(self.engine, clock=lambda: self.now[0], **kw)
        self.observe("built")
        return self.ctl

    def note(self, label, value):
        self.log.append((label, value))

    def ensure(self, name):
        try:
            self.ctl.ensure_active(name)
        except RuntimeError as exc:
            self.note(f"ensure {name}", type(exc).__name__)
        else:
            self.note(f"ensure {name}", "ok")

    def observe(self, label):
        ctl = self.ctl
        snap = ctl.snapshot()
        snap.pop("envelopes", None)
        series = {}
        for name, family in self.registry.snapshot().items():
            if name in TIERING_FAMILIES:
                series[name] = {tuple(sorted(s["labels"].items())):
                                s["value"] for s in family["samples"]}
            elif name == "sparkml_serve_tiering_first_hit_seconds":
                series[name] = {tuple(sorted(s["labels"].items())):
                                s["count"] for s in family["samples"]}
        events = [(e.name, e.args.get("model"))
                  for e in self.recorder.events()
                  if e.name.startswith("serve:tiering:")
                  and e.ts_us >= self.t0 * 1e6]
        self.log.append((label, {
            "states": ctl.states(),
            "pinned": ctl.pinned(),
            "state": {n: ctl.state(n) for n in (*SIZES, "tq3", "ghost")},
            "memory": self.engine._ledger.memory_bytes(),
            "deactivated": list(self.engine.deactivated),
            "reactivated": list(self.engine.reactivated),
            "history": [{k: v for k, v in h.items() if k != "seconds"}
                        for h in ctl.lifecycle_history()],
            "snapshot": {k: ([{a: b for a, b in h.items() if a != "seconds"}
                              for h in v] if k == "history" else v)
                         for k, v in snap.items()},
            "costs_report": self.engine._ledger.costs_document()[
                "cold_report"],
            "series": series,
            "events": events,
        }))


def scenario_budget_coldest_first(side, now):
    ctl = side.make(hbm_budget_bytes=3500)
    side.note("actions", ctl.evaluate_once())
    side.observe("after")


def scenario_repeated_eviction(side, now):
    ctl = side.make(hbm_budget_bytes=1000)
    side.note("actions", ctl.evaluate_once())
    side.note("again", ctl.evaluate_once())
    side.observe("after")


def scenario_zero_budget(side, now):
    ctl = side.make(hbm_budget_bytes=0)
    side.note("actions", ctl.evaluate_once())
    side.observe("after")


def scenario_disabled(side, now):
    ctl = side.make(hbm_budget_bytes=1, enabled=False)
    side.note("actions", ctl.evaluate_once())
    side.ensure("tq0")
    side.observe("after")


def scenario_pinned(side, now):
    ctl = side.make(hbm_budget_bytes=3500, pins=("tq0",))
    side.note("actions", ctl.evaluate_once())
    side.observe("pinned")
    ctl.unpin("tq0")
    ctl.pin("tq2")
    side.observe("repinned")


def scenario_flap_floor(side, now):
    ctl = side.make(hbm_budget_bytes=5000, flap_floor_s=10.0)
    side.note("actions", ctl.evaluate_once())
    now[0] = 1.0
    side.ensure("tq0")
    now[0] = 5.0
    side.note("held", ctl.evaluate_once())
    side.observe("held")
    now[0] = 20.0
    side.ensure("tq1")
    side.note("released", ctl.evaluate_once())
    side.observe("after")


def scenario_ensure_active(side, now):
    ctl = side.make(hbm_budget_bytes=3500)
    ctl.evaluate_once()
    side.observe("cold")
    now[0] = 2.0
    side.ensure("tq0")
    side.ensure("tq0")          # ACTIVE again: a no-op
    side.ensure("never-registered")
    side.observe("after")


def scenario_reactivate_failure(side, now):
    ctl = side.make(hbm_budget_bytes=3500)
    ctl.evaluate_once()
    side.engine.fail_reactivate = True
    side.ensure("tq0")
    side.observe("failed")
    side.engine.fail_reactivate = False
    now[0] = 3.0
    side.ensure("tq0")
    side.observe("after")


def scenario_registry_sync(side, now):
    ctl = side.make()
    side.engine._names.append("tq3")
    side.note("actions", ctl.evaluate_once())
    side.engine._names.remove("tq0")
    ctl.evaluate_once()
    side.observe("after")


def scenario_traffic_reorders_the_ranking(side, now):
    """Weighted LRU, not largest-first: the biggest model keeps serving
    while a smaller one idles, so the idle one is evicted."""
    ledger = side.engine._ledger
    ctl = side.make(hbm_budget_bytes=4000, flap_floor_s=30.0)
    for name in SIZES:
        ledger.note_request(name, 1, "t", "interactive", 50, "ok")
    for _ in range(40):
        now[0] += 1.0
        ledger.note_request("tq0", 1, "t", "interactive", 100, "ok")
        ledger.note_request("tq2", 1, "t", "batch", 5, "ok")
    side.observe("ranked")
    side.note("actions", ctl.evaluate_once())
    now[0] += 10.0
    side.ensure("tq1")
    side.note("inside the floor", ctl.evaluate_once())
    now[0] += 30.0
    side.note("past the floor", ctl.evaluate_once())
    side.observe("after")


SCENARIOS = [scenario_budget_coldest_first, scenario_repeated_eviction,
             scenario_zero_budget, scenario_disabled, scenario_pinned,
             scenario_flap_floor, scenario_ensure_active,
             scenario_reactivate_failure, scenario_registry_sync,
             scenario_traffic_reorders_the_ranking]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__[9:] for s in SCENARIOS])
def test_policy_matches_jax(monkeypatch, scenario):
    logs = []
    for jax in (True, False):
        now = [0.0]
        side = _Side(jax, monkeypatch, now)
        scenario(side, now)
        logs.append(side.log)
    theirs, ours = logs
    assert [label for label, _ in ours] == [label for label, _ in theirs]
    for (label, got), (_, want) in zip(ours, theirs):
        assert got == want, label


def test_policy_outcomes_on_the_port(monkeypatch):
    """What the shared scenarios reach, stated on the port alone."""
    now = [0.0]
    side = _Side(False, monkeypatch, now)
    ctl = side.make(hbm_budget_bytes=3500)
    assert [a["model"] for a in ctl.evaluate_once()] == ["tq0"]
    assert ctl.state("tq0") == COLD and side.engine.deactivated == ["tq0"]
    assert ctl.snapshot()["resident_bytes"] == 3000
    state = side.registry.gauge("sparkml_serve_tiering_state", "",
                                ("model",))
    assert state.value(model="tq0") == STATE_CODES[COLD]
    assert state.value(model="tq1") == STATE_CODES[ACTIVE]
    ctl.ensure_active("tq0")
    assert ctl.state("tq0") == ACTIVE
    assert side.engine._ledger.memory_bytes(model="tq0") == {"tq0": 3000}
    summary = side.registry.summary(
        "sparkml_serve_tiering_first_hit_seconds", "", ("model",))
    assert summary.sketch(model="tq0").count == 1
    names = {e.name for e in spans.get_recorder().events()}
    assert {"serve:tiering:deactivate", "serve:tiering:cold_hit",
            "serve:tiering:reactivate"} <= names
    assert ctl.snapshot()["cold_report"] == \
        side.engine._ledger.costs_document()["cold_report"]


def test_env_knobs_carry_the_port_prefix(monkeypatch):
    engine = SimpleNamespace(_ledger=accounting.ResourceLedger(),
                             registry=SimpleNamespace(names=lambda: []))
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_TIERING_HBM_BUDGET", "4096")
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_TIERING_INTERVAL_MS", "250")
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_TIERING_FLAP_FLOOR_MS", "500")
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_TIERING_ENABLED", "0")
    ctl = TieringController(engine)
    assert (ctl.hbm_budget_bytes, ctl.interval_s, ctl.flap_floor_s,
            ctl.enabled) == (4096, 0.25, 0.5, False)
    # constructor args win
    ctl = TieringController(engine, hbm_budget_bytes=1, enabled=True)
    assert (ctl.hbm_budget_bytes, ctl.enabled) == (1, True)


def test_background_loop_ticks_and_stops(monkeypatch):
    now = [0.0]
    side = _Side(False, monkeypatch, now)
    ctl = side.make(hbm_budget_bytes=3500, interval_s=0.001)
    ctl.start()
    try:
        with pytest.raises(RuntimeError):
            ctl.start()
        _until(lambda: ctl.state("tq0") == COLD)
        assert ctl.running and ctl.snapshot()["running"] is True
    finally:
        ctl.stop()
    assert not ctl.running


# -- admission's reactivation gate --------------------------------------------


def _forced_shed(cls, clock):
    """A shed controller pinned at level 2 (sheds over-quota work)."""
    shed = cls(refresh_seconds=1e9, hold_seconds=1e9, clock=clock)
    shed.note_signals(burn=100.0, queue_wait_s=10.0, depth_frac=1.0)
    return shed


def _gate_sequence(jax):
    """The same requests through one package's admission: the gate's calls
    (with the admission count it saw) and each verdict."""
    now = [100.0]
    clock = lambda: now[0]  # noqa: E731
    admission_cls = JaxAdmissionController if jax else AdmissionController
    shed_cls = JaxShedController if jax else ShedController
    shed_exc = JaxShedLoad if jax else ShedLoad
    ctrl = admission_cls(tenant_quotas={"greedy": (10.0, 10.0)},
                         shed=_forced_shed(shed_cls, clock), clock=clock)
    calls = []

    def gate(model):
        calls.append((model, ctrl._m_admission.total()))

    ctrl.bind_tiering(gate)
    verdicts = []
    for tenant, priority, rows, model in (
            ("calm", "interactive", 5, "cold_a"),
            ("greedy", "batch", 8, "cold_a"),      # in quota: admitted
            ("greedy", "batch", 8, "cold_b"),      # over quota: shed
            ("greedy", "interactive", 4, "cold_b"),  # over quota: shed
            ("calm", "batch", 3, ""),              # no model: no gate
            ("calm", "batch", 3, "cold_b")):
        before = len(calls)
        try:
            decision = ctrl.admit(tenant, priority, rows, model=model)
            verdicts.append((decision.decision, len(calls) - before))
        except shed_exc as exc:
            verdicts.append(("shed:" + exc.reason, len(calls) - before))
        now[0] += 0.01
    return calls, verdicts


def test_admission_gate_runs_after_admit_and_never_for_a_shed():
    calls, verdicts = _gate_sequence(jax=False)
    assert [v for v, _ in verdicts] == [
        "admit", "admit", "shed:over_quota", "shed:over_quota", "admit",
        "admit"]
    # called once per admitted request with a model, after the decision
    # was counted; never for a shed
    assert [n for _, n in verdicts] == [1, 1, 0, 0, 0, 1]
    assert [m for m, _ in calls] == ["cold_a", "cold_a", "cold_b"]
    assert all(seen >= 1 for _, seen in calls)


def test_admission_gate_matches_jax():
    ours, theirs = _gate_sequence(jax=False), _gate_sequence(jax=True)
    assert ours[1] == theirs[1]
    assert [m for m, _ in ours[0]] == [m for m, _ in theirs[0]]


# -- the live CPU engine ------------------------------------------------------


@pytest.fixture
def fresh_ledgers():
    accounting.reset_ledger()
    jax_accounting.reset_ledger()
    yield accounting.get_ledger()
    accounting.reset_ledger()
    jax_accounting.reset_ledger()


def _model(seed):
    basis = np.linalg.qr(np.random.default_rng(seed).normal(
        size=(N_FEAT, 4)))[0]
    return PCAModel.from_numpy(basis, [0.4, 0.3, 0.2, 0.1]).setDtype(
        "float64")


def test_parked_model_leaves_the_card_and_returns_on_its_first_hit(
        fresh_ledgers):
    ledger = fresh_ledgers
    names = ["live_a", "live_b", "live_c", "live_d"]
    registry = ModelRegistry()
    for i, name in enumerate(names):
        registry.register(name, _model(i))
    engine = ServeEngine(registry, max_batch_rows=64, max_wait_ms=1.0)
    now = [0.0]
    try:
        for name in names:
            engine.warmup(name)
        weight = N_FEAT * 4 * 8
        assert ledger.memory_bytes() == {n: weight for n in names}
        ctl = TieringController(engine, hbm_budget_bytes=3 * weight,
                                flap_floor_s=1.0, clock=lambda: now[0])
        engine.attach_tiering(ctl)
        assert engine.tiering_controller() is ctl
        x = np.random.default_rng(9).normal(size=(5, N_FEAT))
        ref = engine.predict("live_d", x)
        for name in names[:3]:
            engine.predict(name, x)
        hits = get_registry().summary(
            "sparkml_serve_tiering_first_hit_seconds", "", ("model",))
        before = hits.sketch(model="live_d").count
        now[0] = 5.0
        actions = ctl.evaluate_once()
        assert [a["model"] for a in actions] == ["live_d"]
        assert ctl.states() == {"live_a": ACTIVE, "live_b": ACTIVE,
                                "live_c": ACTIVE, "live_d": COLD}
        assert ("live_d", 1) not in engine._batchers
        assert ledger.memory_bytes("live_d") == {}
        doc = engine.costs_snapshot()["models"]["live_d"]
        assert doc["hbm_bytes"][COMPONENT_WEIGHTS] == 0
        assert sum(ledger.memory_bytes().values()) <= 3 * weight
        assert registry.resolve_entry("live_d").warmed_buckets
        # the first hit reactivates through admission's gate
        out = engine.predict("live_d", x)
        np.testing.assert_array_equal(out, ref)
        assert ctl.state("live_d") == ACTIVE
        assert ("live_d", 1) in engine._batchers
        assert ledger.memory_bytes("live_d") == {"live_d": weight}
        assert hits.sketch(model="live_d").count == before + 1
        assert [(h["event"], h["model"])
                for h in ctl.lifecycle_history()] == [
            ("deactivate", "live_d"), ("reactivate", "live_d")]
    finally:
        engine.shutdown()


def test_reactivation_warms_the_ladder_it_reports(fresh_ledgers):
    """A parked model comes back warmed at its entry's ``warmed_buckets``
    (here a ladder recovered from another deploy's manifest, not the one
    this engine pads to), and ``reactivate`` reports that ladder."""
    registry = ModelRegistry()
    registry.register("ladder_pca", _model(5))
    engine = ServeEngine(registry, max_batch_rows=64, max_wait_ms=1.0,
                         buckets=(8, 64))
    try:
        engine.warmup("ladder_pca")
        entry = registry.resolve_entry("ladder_pca")
        assert entry.warmed_buckets == (8, 64)
        entry.warmed_buckets = (16, 32)
        assert engine.deactivate("ladder_pca") == ["ladder_pca@1"]
        report = engine.reactivate("ladder_pca")
        assert report == {"model": "ladder_pca", "version": 1,
                          "buckets": [16, 32]}
        assert entry.warmed_buckets == (16, 32)
        assert ("ladder_pca", 1) in engine._batchers
    finally:
        engine.shutdown()


def test_a_shut_down_engine_leaves_no_bytes_in_a_later_budget(
        fresh_ledgers):
    """The ledger is process-wide: an engine's shutdown releases its
    charges, as ``evict`` does, so a controller on a later engine counts
    only its own engine's bytes and parks nothing to meet its budget."""
    ledger = fresh_ledgers
    weight = N_FEAT * 4 * 8
    gone_registry, kept_registry = ModelRegistry(), ModelRegistry()
    gone_registry.register("gone_pca", _model(3))
    kept_registry.register("kept_pca", _model(4))
    gone = ServeEngine(gone_registry, max_batch_rows=64, max_wait_ms=1.0)
    kept = ServeEngine(kept_registry, max_batch_rows=64, max_wait_ms=1.0)
    try:
        gone.warmup("gone_pca")
        kept.warmup("kept_pca")
        assert ledger.memory_bytes() == {"gone_pca": weight,
                                         "kept_pca": weight}
        gone.shutdown()
        gone.shutdown()  # idempotent: nothing more is released
        assert ledger.memory_bytes() == {"kept_pca": weight}
        ctl = TieringController(kept, hbm_budget_bytes=weight,
                                flap_floor_s=0.0, clock=lambda: 60.0)
        kept.attach_tiering(ctl)
        assert ctl.evaluate_once() == []
        assert ctl.states() == {"kept_pca": ACTIVE}
        assert ("kept_pca", 1) in kept._batchers
    finally:
        gone.shutdown()
        kept.shutdown()
    assert ledger.memory_bytes() == {}


def test_deactivation_drops_every_reference_to_the_staged_weights(
        fresh_ledgers, monkeypatch):
    """What the card's allocator can free: once a model is parked, no
    object still holds a tensor its serving programs staged (the programs,
    the batcher's spec and the precision check's transient programs
    alike); the reactivation stages them anew."""
    import gc
    import weakref

    from spark_rapids_ml_tpu_torch.models import pca as pca_mod

    staged = []
    stage = pca_mod.PCAModel._serving_weights

    def recording(self, *args, **kwargs):
        out = stage(self, *args, **kwargs)
        staged.extend(weakref.ref(t) for t in out)
        return out

    monkeypatch.setattr(pca_mod.PCAModel, "_serving_weights", recording)
    registry = ModelRegistry()
    registry.register("refs_pca", _model(7))
    engine = ServeEngine(registry, max_batch_rows=64, max_wait_ms=1.0,
                         precision="bf16")
    ctl = TieringController(engine, hbm_budget_bytes=1, clock=lambda: 0.0)
    engine.attach_tiering(ctl)
    try:
        x = np.random.default_rng(8).normal(size=(6, N_FEAT))
        ref = engine.predict("refs_pca", x)
        # the bf16 program serves; the native program its check held it
        # to was staged after it, and is already gone
        assert len(staged) == 2
        gc.collect()
        assert [r() is None for r in staged] == [False, True]
        assert staged[0]().dtype == torch.bfloat16
        assert [a["model"] for a in ctl.evaluate_once()] == ["refs_pca"]
        gc.collect()
        assert all(r() is None for r in staged)
        np.testing.assert_array_equal(engine.predict("refs_pca", x), ref)
        gc.collect()
        assert sum(r() is not None for r in staged) == 1
    finally:
        engine.shutdown()


class _GatedModel:
    """A PCA model whose serving program's fetch blocks on an event once
    ``gated``: the worker holds a batch while more requests queue."""

    def __init__(self, inner):
        self._inner = inner
        self.gated = False
        self.entered = threading.Event()
        self.release = threading.Event()

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def serving_transform_program(self, precision="native", device=None):
        prog = self._inner.serving_transform_program(precision,
                                                     device=device)

        def fetch(out, _fetch=prog.fetch):
            if self.gated:
                self.entered.set()
                assert self.release.wait(WAIT)
            return _fetch(out)

        return prog._replace(fetch=fetch)


def test_deactivation_drains_queued_requests(fresh_ledgers):
    inner = _model(5)
    gated = _GatedModel(inner)
    registry = ModelRegistry()
    registry.register("drain_pca", gated)
    engine = ServeEngine(registry, max_batch_rows=8, max_wait_ms=0.0)
    ctl = TieringController(engine, hbm_budget_bytes=1, clock=lambda: 0.0)
    engine.attach_tiering(ctl)
    rows = [np.full((2, N_FEAT), float(i)) for i in range(3)]
    results = {}
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(
        i, engine.predict("drain_pca", rows[i], timeout=WAIT)))
        for i in range(3)]
    parker = threading.Thread(target=ctl.evaluate_once)
    try:
        engine.warmup("drain_pca")
        gated.gated = True
        threads[0].start()
        assert gated.entered.wait(WAIT)
        for t in threads[1:]:
            t.start()
        _until(lambda: engine.queue_depth("drain_pca") == 2)
        parker.start()
        _until(lambda: ctl.state("drain_pca") == DEACTIVATING)
        gated.release.set()
        parker.join(WAIT)
        for t in threads:
            t.join(WAIT)
        assert not parker.is_alive()
        assert not any(t.is_alive() for t in threads)
        for i in range(3):
            want = np.asarray(inner.transform(rows[i]).column(
                "pca_features"))
            np.testing.assert_allclose(results[i], want, rtol=1e-12,
                                       atol=1e-12)
        assert ctl.state("drain_pca") == COLD
        assert ("drain_pca", 1) not in engine._batchers
        assert fresh_ledgers.memory_bytes("drain_pca") == {}
    finally:
        gated.release.set()
        engine.shutdown()


# -- the HTTP routes against the JAX engine's documents -----------------------


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _keys(doc):
    """The nested key structure of a document, numbers as one type."""
    if isinstance(doc, dict):
        return {k: _keys(v) for k, v in doc.items()}
    if isinstance(doc, list):
        return [_keys(v) for v in doc]
    return "number" if isinstance(doc, (int, float)) else type(doc).__name__


def _replicas_collapsed(doc):
    """Each model's per-replica residency summed over replicas: a
    replica's label is its device's name, which differs by package."""
    for entry in doc["models"].values():
        totals = {}
        for residency in entry["replicas"].values():
            for component, nbytes in residency.items():
                totals[component] = totals.get(component, 0) + nbytes
        entry["replicas"] = totals
    return doc


def test_debug_routes_match_the_jax_engine(fresh_ledgers, monkeypatch):
    # Both ledgers run on the controllers' injected clock. The cold
    # ranking reads a ledger's clock (last-hit age, EWMA rate): on the wall
    # clock, a stall of 0.3 s between route_a's last request and route_b's
    # (CPU contention under a parallel suite) ranks route_a colder.
    now = [0.0]
    monkeypatch.setattr(accounting, "_ledger", accounting.ResourceLedger(
        clock=lambda: now[0]))
    monkeypatch.setattr(jax_accounting, "_ledger",
                        jax_accounting.ResourceLedger(clock=lambda: now[0]))
    x = np.random.default_rng(11).normal(size=(200, N_FEAT))
    names = ("route_a", "route_b", "route_c")
    jax_models = {n: JaxPCA().setK(3).setDtype("float64").fit(
        x * (1.0 + i)) for i, n in enumerate(names)}
    jreg, treg = JaxRegistry(), ModelRegistry()
    for name, ref in jax_models.items():
        jreg.register(name, ref)
        treg.register(name, PCAModel.from_numpy(
            ref.pc, ref.explained_variance, ref.mean).setDtype("float64"))
    kw = dict(max_batch_rows=16, max_wait_ms=1.0, buckets=(8, 16))
    jeng, teng = JaxEngine(jreg, **kw), ServeEngine(treg, **kw)
    tsdb.reset_tsdb()
    devmon.reset_device_monitor()
    server = None
    try:
        for eng in (jeng, teng):
            for name in names:
                eng.warmup(name)
        weight = N_FEAT * 3 * 8
        jctl = jax_tiering.TieringController(
            jeng, hbm_budget_bytes=2 * weight, flap_floor_s=0.0,
            per_model_autoscale=False, clock=lambda: now[0])
        tctl = TieringController(teng, hbm_budget_bytes=2 * weight,
                                 flap_floor_s=0.0, clock=lambda: now[0])
        jeng.attach_tiering(jctl)
        teng.attach_tiering(tctl)
        server = start_serve_server(teng)
        port = server.server_address[1]
        status, doc = _get(port, "/debug/tiering")
        assert status == 200 and doc["states"] == {n: ACTIVE for n in names}
        # route_a hot, route_b one request, route_c never hit: route_c is
        # the coldest in both ledgers
        for eng in (jeng, teng):
            for i in range(6):
                eng.predict("route_a", x[i:i + 3], tenant="acme")
            eng.predict("route_b", x[:2], tenant="zeta", priority="batch")
        now[0] = 1.0
        assert [a["model"] for a in tctl.evaluate_once()] == ["route_c"]
        assert [a["model"] for a in jctl.evaluate_once()] == ["route_c"]
        # the first hits reactivate route_c in both engines
        np.testing.assert_allclose(teng.predict("route_c", x[:4]),
                                   jeng.predict("route_c", x[:4]),
                                   rtol=1e-12, atol=1e-12)
        now[0] = 2.0
        for ctl in (jctl, tctl):
            assert [a["model"] for a in ctl.evaluate_once()] == ["route_b"]

        status, costs = _get(port, "/debug/costs")
        want = jeng.costs_snapshot()
        assert status == 200 and "replica_states" in want
        want.pop("replica_states")
        # reconcile reads each package's process-wide devmon series,
        # which hold every model this process served so far
        models_reconciled = (costs["reconcile"].pop("models"),
                             want["reconcile"].pop("models"))
        assert _keys(_replicas_collapsed(costs)) == _keys(
            _replicas_collapsed(want))
        for reconciled in models_reconciled:
            assert set(reconciled) >= {"route_a", "route_b", "route_c"}
        assert set(costs["models"]) == set(want["models"]) == set(names)
        for name in names:
            got, ref = costs["models"][name], want["models"][name]
            for key in ("hbm_bytes", "hbm_total_bytes", "replicas", "rows",
                        "requests", "tenants"):
                assert got[key] == ref[key], (name, key)
        assert costs["models"]["route_b"]["hbm_total_bytes"] == 0
        assert [r["model"] for r in costs["cold_report"]] == [
            r["model"] for r in want["cold_report"]]
        assert set(costs["reconcile"]) == set(want["reconcile"])

        status, tier = _get(port, "/debug/tiering")
        ref = jctl.snapshot()
        assert "envelopes" in ref
        ref.pop("envelopes")
        assert status == 200 and set(tier) == set(ref)
        for key in ("enabled", "running", "hbm_budget_bytes",
                    "resident_bytes", "flap_floor_s", "interval_s",
                    "states", "state_counts", "pinned"):
            assert tier[key] == ref[key], key
        assert tier["states"]["route_b"] == COLD
        strip = [{k: v for k, v in h.items() if k != "seconds"}
                 for h in ref["history"]]
        assert [{k: v for k, v in h.items() if k != "seconds"}
                for h in tier["history"]] == strip
        assert [r["model"] for r in tier["cold_report"]] == [
            r["model"] for r in ref["cold_report"]]

        status, slo = _get(port, "/debug/slo")
        assert status == 200
        assert set(slo["tiering"]) == set(tier)
        assert slo["tiering"]["states"] == tier["states"]
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        jeng.shutdown()
        teng.shutdown()
        tsdb.reset_tsdb()
        devmon.reset_device_monitor()


def test_debug_tiering_without_a_controller(fresh_ledgers):
    tsdb.reset_tsdb()
    devmon.reset_device_monitor()
    engine = ServeEngine(ModelRegistry(), max_batch_rows=16)
    server = start_serve_server(engine)
    try:
        port = server.server_address[1]
        assert _get(port, "/debug/tiering") == (200, {"enabled": False})
        status, slo = _get(port, "/debug/slo")
        assert slo["tiering"] == {"enabled": False}
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()
        tsdb.reset_tsdb()
        devmon.reset_device_monitor()


# -- the registry's warm ladder, across the two packages' manifests ----------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_warm_manifest_crosses_packages(tmp_path, writer):
    """A manifest written by either package's registry recovers in the
    other's with its ``warmed_buckets`` — the ladder a reactivation
    replays — and the reader's next write keeps the field."""
    x = np.random.default_rng(13).normal(size=(120, N_FEAT))
    ref = JaxPCA().setK(3).setDtype("float64").fit(x)
    saved = str(tmp_path / "model")
    if writer == "jax":
        ref.save(saved)
    else:
        PCAModel.from_numpy(ref.pc, ref.explained_variance,
                            ref.mean).setDtype("float64").save(saved)
    manifest = str(tmp_path / "manifest.json")
    write_cls, read_cls = ((JaxRegistry, ModelRegistry) if writer == "jax"
                           else (ModelRegistry, JaxRegistry))
    written = write_cls(manifest_path=manifest)
    written.load("warm_pca", saved)
    written.register("warm_inproc", ref if writer == "jax" else
                     PCAModel.from_numpy(ref.pc, ref.explained_variance))
    written.warmup("warm_pca", buckets=(8, 16))
    with open(manifest) as f:
        doc = json.load(f)
    assert doc["models"]["warm_pca"][0]["warmed_buckets"] == [8, 16]
    assert doc["models"]["warm_inproc"][0]["warmed_buckets"] is None
    back = read_cls(manifest_path=manifest)
    assert back.recovery_report_["recovered"] == ["warm_pca@1"]
    assert back.resolve_entry("warm_pca").warmed_buckets == (8, 16)
    assert written.resolve_entry("warm_pca").warmed_buckets == (8, 16)
    np.testing.assert_allclose(np.asarray(back.resolve("warm_pca").pc),
                               ref.pc, rtol=0, atol=0)
    back.alias("prod", "warm_pca", version=1)  # the reader writes anew
    with open(manifest) as f:
        again = json.load(f)
    assert again["models"]["warm_pca"][0]["warmed_buckets"] == [8, 16]
    assert again["aliases"]["prod"] == {"name": "warm_pca", "version": 1}
