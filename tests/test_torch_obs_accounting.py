"""The port's cost ledger (``obs/accounting.py``) against the JAX
package's: the same mutation sequences on one injected clock through both
``ResourceLedger``s give the same documents and the same ``sparkml_model_*``
series; the JAX file's ledger tests carried across; and the ledger's
seams in the port's engine, batcher and HTTP server.

The sequence tests give each ledger a metrics registry of its own
(``get_registry`` patched in both modules), so the comparison sees only
the sequence's series, never another test's. Engine tests reset the
process-wide ledger before building the engine (engines capture it at
construction), use a width no JAX test compiles, and synchronise on
returned predictions, never on sleeps."""

import json
import threading
import urllib.request

import numpy as np
import pytest

from spark_rapids_ml_tpu.obs import accounting as jax_accounting
from spark_rapids_ml_tpu.obs.metrics import MetricsRegistry as JaxMetrics
from spark_rapids_ml_tpu_torch import PCAModel
from spark_rapids_ml_tpu_torch.obs import accounting
from spark_rapids_ml_tpu_torch.obs import devmon, tsdb
from spark_rapids_ml_tpu_torch.obs.accounting import (
    COMPONENT_EXECUTABLES,
    COMPONENT_RESERVE,
    COMPONENT_WEIGHTS,
    MODEL_MAX_ENV,
    OVERFLOW_MODEL,
    RECONCILE_MIN_ENV,
    ResourceLedger,
)
from spark_rapids_ml_tpu_torch.obs.metrics import MetricsRegistry
from spark_rapids_ml_tpu_torch.obs.metrics import get_registry
from spark_rapids_ml_tpu_torch.serve import (
    ModelRegistry,
    ServeEngine,
    start_serve_server,
)

N_FEAT = 20  # no JAX test compiles this width
DEVMON_FAMILY = "sparkml_serve_device_batch_seconds_total"


@pytest.fixture(autouse=True)
def _cpu_requested(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")


@pytest.fixture
def fresh_ledger():
    accounting.reset_ledger()
    yield accounting.get_ledger()
    accounting.reset_ledger()


@pytest.fixture
def model(rng):
    basis = np.linalg.qr(rng.normal(size=(N_FEAT, 4)))[0]
    return PCAModel.from_numpy(basis, [0.4, 0.3, 0.2, 0.1]).setDtype(
        "float64")


# -- the same mutation sequence through both ledgers -------------------------

MODELS = ("seq_a", "seq_b", "seq_c", "seq_d", "seq_e", "seq_f")
OUTCOMES = ("ok", "ok", "ok", "shed", "rejected", "expired", "error")
TENANTS = ("acme", "zeta", "default")
PRIORITIES = ("interactive", "batch")
COMPONENTS = (COMPONENT_WEIGHTS, COMPONENT_RESERVE, COMPONENT_EXECUTABLES)


def _sequence(seed, n=240):
    """A seeded list of (op, args) over more models than MODEL_MAX (4),
    with clock steps between them."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        model = str(rng.choice(MODELS))
        version = int(rng.integers(1, 3))
        replica = f"dev{int(rng.integers(0, 2))}"
        kind = int(rng.integers(0, 9))
        if kind == 0:
            ops.append(("charge", (model, version, replica,
                                   str(rng.choice(COMPONENTS)),
                                   int(rng.integers(0, 1 << 20)))))
        elif kind == 1:
            ops.append(("retire", (model, version, replica)))
        elif kind == 2:
            ops.append(("revive", (model, version, replica)))
        elif kind == 3:
            ops.append(("release", (
                model,
                None if rng.random() < 0.5 else version,
                None if rng.random() < 0.5 else replica,
                None if rng.random() < 0.5
                else str(rng.choice(COMPONENTS)))))
        elif kind in (4, 5):
            ops.append(("request", (model, version,
                                    str(rng.choice(TENANTS)),
                                    str(rng.choice(PRIORITIES)),
                                    int(rng.integers(0, 300)),
                                    str(rng.choice(OUTCOMES)))))
        elif kind == 6:
            seconds = float(rng.exponential(0.02))
            ops.append(("batch", (model, seconds)))
            # devmon meters the same seam; a lost note now and then
            # shows as drift
            ops.append(("devmon", (model, seconds
                                   if rng.random() < 0.9 else 0.0)))
        elif kind == 7:
            ops.append(("attribution", (model, version)))
        else:
            ops.append(("bad_charge", (model, version, replica)))
        ops.append(("tick", float(rng.exponential(3.0))))
    return ops


def _model_series(registry):
    """{family: {sorted label items: value}} for every sparkml_model_*
    counter and gauge."""
    out = {}
    for name, family in registry.snapshot().items():
        if name.startswith("sparkml_model_"):
            out[name] = {tuple(sorted(s["labels"].items())): s["value"]
                         for s in family["samples"]}
    return out


def _run(ledger, registry, now, ops):
    """Apply ``ops``; the observations after each reading op."""
    devmon_family = registry.counter(DEVMON_FAMILY, "", ("model", "device"))
    seen = []
    for op, args in ops:
        if op == "tick":
            now[0] += args
        elif op == "charge":
            ledger.charge_memory(*args)
        elif op == "retire":
            seen.append(ledger.retire_replica(*args))
        elif op == "revive":
            seen.append(ledger.revive_replica(*args))
        elif op == "release":
            model, version, replica, component = args
            seen.append(ledger.release_memory(
                model, version=version, replica=replica,
                component=component))
        elif op == "request":
            ledger.note_request(*args)
        elif op == "batch":
            ledger.note_batch_seconds(args[0], args[1], device="dev0")
        elif op == "devmon":
            devmon_family.inc(args[1], model=args[0], device="dev0")
        elif op == "attribution":
            with ledger.compile_attribution(*args):
                with ledger.compile_attribution(*args):
                    pass
        elif op == "bad_charge":
            for component, nbytes in (("hbm", 1), (COMPONENT_WEIGHTS, -1)):
                try:
                    ledger.charge_memory(*args, component, nbytes)
                except ValueError:
                    seen.append("ValueError")
                else:
                    seen.append("accepted")
    seen.append(ledger.memory_bytes())
    seen.append(ledger.memory_bytes(component=COMPONENT_WEIGHTS))
    return seen


@pytest.mark.parametrize("enabled", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mutation_sequence_gives_the_jax_documents(monkeypatch, seed,
                                                   enabled):
    """Exactly equal, not close: ``costs_document`` (rollups, residency,
    tenants, EWMA, ages, cold report, reconciliation), the cold report's
    order and scores, ``snapshot`` and every ``sparkml_model_*`` child."""
    monkeypatch.setenv(MODEL_MAX_ENV, "4")
    monkeypatch.setenv(jax_accounting.MODEL_MAX_ENV, "4")
    ours_reg, theirs_reg = MetricsRegistry(), JaxMetrics()
    monkeypatch.setattr(accounting, "get_registry", lambda: ours_reg)
    monkeypatch.setattr(jax_accounting, "get_registry", lambda: theirs_reg)
    now = [1000.0]
    ours = ResourceLedger(clock=lambda: now[0], enabled=enabled)
    theirs = jax_accounting.ResourceLedger(clock=lambda: now[0],
                                           enabled=enabled)
    ops = _sequence(seed)
    start = now[0]
    got = _run(ours, ours_reg, now, ops)
    now[0] = start
    want = _run(theirs, theirs_reg, now, ops)
    assert got == want
    ours.publish()
    theirs.publish()
    doc = ours.costs_document()
    assert doc == theirs.costs_document()
    assert ours.cold_report() == theirs.cold_report() == doc["cold_report"]
    assert ours.snapshot() == theirs.snapshot()
    assert _model_series(ours_reg) == _model_series(theirs_reg)
    if enabled:
        # the sequence reached what it was built to reach
        assert OVERFLOW_MODEL in ours.snapshot()["known_models"] or (
            OVERFLOW_MODEL in doc["models"])
        assert len(doc["cold_report"]) >= 2
        scores = [row["cold_score"] for row in doc["cold_report"]]
        assert scores == sorted(scores, reverse=True)
        assert doc["reconcile"]["models_checked"] >= 1
        assert "ValueError" in got and "accepted" not in got
    else:
        assert doc["models"] == {} and ours.snapshot()["memory"] == {}


# -- the JAX file's ledger tests, on the port ---------------------------------


def test_charge_retire_revive_release_roundtrip():
    now = [100.0]
    ledger = ResourceLedger(clock=lambda: now[0], enabled=True)
    ledger.charge_memory("unit_a_pca", 1, "dev0", COMPONENT_WEIGHTS, 700)
    ledger.charge_memory("unit_a_pca", 1, "dev1", COMPONENT_WEIGHTS, 700)
    assert ledger.memory_bytes("unit_a_pca") == {"unit_a_pca": 1400}
    # re-charge overwrites, never stacks
    ledger.charge_memory("unit_a_pca", 1, "dev0", COMPONENT_WEIGHTS, 512)
    assert ledger.memory_bytes("unit_a_pca") == {"unit_a_pca": 1212}
    assert ledger.retire_replica("unit_a_pca", 1, "dev1") == 700
    assert ledger.memory_bytes(
        "unit_a_pca", COMPONENT_WEIGHTS) == {"unit_a_pca": 512}
    assert ledger.memory_bytes(
        "unit_a_pca", COMPONENT_RESERVE) == {"unit_a_pca": 700}
    # idempotent: a second retire of the same replica moves nothing
    assert ledger.retire_replica("unit_a_pca", 1, "dev1") == 0
    assert ledger.revive_replica("unit_a_pca", 1, "dev1") == 700
    assert ledger.memory_bytes(
        "unit_a_pca", COMPONENT_WEIGHTS) == {"unit_a_pca": 1212}
    assert ledger.memory_bytes("unit_a_pca", COMPONENT_RESERVE) == {}
    # wildcard release (the eviction path) frees everything
    assert ledger.release_memory("unit_a_pca") == 1212
    assert ledger.memory_bytes("unit_a_pca") == {}


def test_charge_rejects_bad_component_and_negative_bytes():
    ledger = ResourceLedger(enabled=True)
    with pytest.raises(ValueError):
        ledger.charge_memory("unit_b_pca", 1, "dev0", "hbm", 1)
    with pytest.raises(ValueError):
        ledger.charge_memory("unit_b_pca", 1, "dev0",
                             COMPONENT_WEIGHTS, -1)


def test_disabled_ledger_is_inert():
    ledger = ResourceLedger(enabled=False)
    ledger.charge_memory("unit_c_pca", 1, "dev0", COMPONENT_WEIGHTS, 99)
    ledger.note_request("unit_c_pca", 1, "t", "interactive", 10, "ok")
    ledger.note_batch_seconds("unit_c_pca", 1.0)
    assert ledger.memory_bytes() == {}
    assert ledger.snapshot()["memory"] == {}


def test_accounting_env_switch_disables_the_ledger(monkeypatch):
    monkeypatch.setenv(accounting.ACCOUNTING_ENV, "0")
    assert ResourceLedger().enabled is False
    monkeypatch.setenv(accounting.ACCOUNTING_ENV, "1")
    assert ResourceLedger().enabled is True


def test_model_label_cardinality_bounds(monkeypatch):
    monkeypatch.setenv(MODEL_MAX_ENV, "2")
    ledger = ResourceLedger(enabled=True)
    assert ledger.model_max == 2
    assert ledger.resolve_model("card_a") == "card_a"
    assert ledger.resolve_model("card_b") == "card_b"
    # third distinct name collapses — mirroring the tenant guard
    assert ledger.resolve_model("card_c") == OVERFLOW_MODEL
    assert ledger.resolve_model("card_a") == "card_a"
    # hot-path vitals for an overflow model fold under the bucket
    ledger.note_request("card_d", 1, "t", "interactive", 5, "ok")
    doc = ledger.costs_document()["models"]
    assert OVERFLOW_MODEL in doc and doc[OVERFLOW_MODEL]["rows"] == 5
    assert "card_d" not in doc


def test_cold_report_ranks_idle_resident_model_coldest():
    now = [0.0]
    ledger = ResourceLedger(clock=lambda: now[0], enabled=True)
    for name in ("cold_idle_pca", "cold_hot_pca"):
        ledger.charge_memory(name, 1, "dev0", COMPONENT_WEIGHTS, 4096)
    # both take traffic at t=0 — "cold" must mean went-idle, not
    # never-seen
    for name in ("cold_idle_pca", "cold_hot_pca"):
        ledger.note_request(name, 1, "t", "interactive", 100, "ok")
    for _ in range(60):
        now[0] += 1.0
        ledger.note_request("cold_hot_pca", 1, "t", "interactive",
                            100, "ok")
    doc = ledger.costs_document()
    rank = {row["model"]: i for i, row in enumerate(doc["cold_report"])}
    assert rank["cold_idle_pca"] < rank["cold_hot_pca"]
    idle = doc["models"]["cold_idle_pca"]
    hot = doc["models"]["cold_hot_pca"]
    assert idle["last_hit_age_seconds"] == pytest.approx(60.0)
    assert hot["ewma_rps"] > idle["ewma_rps"]
    # a model with traffic but no resident bytes never appears: there
    # is nothing for a tiering controller to evict
    ledger.note_request("cold_ghost_pca", 1, "t", "interactive", 9, "ok")
    assert all(row["model"] != "cold_ghost_pca"
               for row in ledger.costs_document()["cold_report"])


def test_tenant_priority_rollups_in_costs_document():
    ledger = ResourceLedger(enabled=True)
    ledger.note_request("ten_pca", 1, "acme", "interactive", 10, "ok")
    ledger.note_request("ten_pca", 1, "acme", "interactive", 5, "ok")
    ledger.note_request("ten_pca", 1, "acme", "batch", 7, "ok")
    ledger.note_request("ten_pca", 1, "zeta", "batch", 3, "shed")
    doc = ledger.costs_document()["models"]["ten_pca"]
    assert doc["tenants"]["acme|interactive"]["rows"] == 15
    assert doc["tenants"]["acme|batch"]["rows"] == 7
    assert doc["requests"] == {"ok": 3, "shed": 1}


def test_compile_attribution_charges_zero_on_the_port():
    """The window keeps the JAX shape (reentrant, the outermost charges
    once) but the port compiles nothing: nothing is charged, and
    ``executables`` stays empty."""
    ledger = ResourceLedger(enabled=True)
    mutations = get_registry().counter(
        "sparkml_model_ledger_mutations_total", "", ("model", "op"))
    before = mutations.value(model="attr_pca", op="compile_attribution")
    with ledger.compile_attribution("attr_pca", 1):
        with ledger.compile_attribution("attr_pca", 1):
            pass
    doc = ledger.costs_document()["models"]["attr_pca"]
    assert doc["compile_seconds"] == 0.0 and doc["compiles"] == 0
    assert doc["aot_cache"] == {"hit": 0, "miss": 0}
    assert doc["hbm_bytes"][COMPONENT_EXECUTABLES] == 0
    assert mutations.value(model="attr_pca",
                           op="compile_attribution") == before + 1


def test_compile_attribution_windows_of_two_threads_overlap():
    """The port's window charges nothing, so it takes no lock: a window
    on one thread (a cold model's warmup) does not hold back another
    thread's (a second cold model's), and each counts once."""
    import threading

    ledger = ResourceLedger(enabled=True)
    mutations = get_registry().counter(
        "sparkml_model_ledger_mutations_total", "", ("model", "op"))
    before = {m: mutations.value(model=m, op="compile_attribution")
              for m in ("attr_slow", "attr_fast")}
    inside, done = threading.Event(), threading.Event()

    def slow():
        with ledger.compile_attribution("attr_slow", 1):
            inside.set()
            done.wait(10.0)

    t = threading.Thread(target=slow)
    t.start()
    try:
        assert inside.wait(10.0)
        with ledger.compile_attribution("attr_fast", 1):
            with ledger.compile_attribution("attr_fast", 1):
                pass
        assert mutations.value(model="attr_fast", op="compile_attribution"
                               ) == before["attr_fast"] + 1
        assert mutations.value(model="attr_slow", op="compile_attribution"
                               ) == before["attr_slow"]
    finally:
        done.set()
        t.join(10.0)
    assert mutations.value(model="attr_slow", op="compile_attribution"
                           ) == before["attr_slow"] + 1


# -- the seams in the port's engine, batcher and server -----------------------


def test_engine_charges_the_serving_program_and_evict_releases(
        model, fresh_ledger):
    registry = ModelRegistry()
    registry.register("seam_pca", model)
    engine = ServeEngine(registry, max_batch_rows=64, max_wait_ms=1.0)
    try:
        engine.warmup("seam_pca")
        prog = engine._batchers[("seam_pca", 1)].async_spec.program
        assert prog.weight_bytes == N_FEAT * 4 * 8
        assert fresh_ledger.memory_bytes("seam_pca") == {
            "seam_pca": prog.weight_bytes}
        assert fresh_ledger.snapshot()["memory"] == {
            f"seam_pca 1 cpu {COMPONENT_WEIGHTS}": prog.weight_bytes}
        engine.predict("seam_pca", np.ones((3, N_FEAT)), tenant="acme",
                       priority="batch")
        # the batch of a request of the wrong width fails: an outcome
        with pytest.raises(RuntimeError):
            engine.predict("seam_pca", np.ones((2, N_FEAT + 1)))
        # an unknown model is a client error: no outcome anywhere
        with pytest.raises(KeyError):
            engine.predict("seam_ghost", np.ones((2, N_FEAT)))
        doc = fresh_ledger.costs_document()["models"]["seam_pca"]
        assert doc["requests"] == {"ok": 1, "error": 1}
        assert doc["rows"] == 3
        assert doc["tenants"] == {
            "acme|batch": {"rows": 3, "requests": 1},
            "default|interactive": {"rows": 0, "requests": 1}}
        assert "seam_ghost" not in fresh_ledger.costs_document()["models"]
        assert engine.evict("seam_pca", 1)
        assert fresh_ledger.memory_bytes("seam_pca") == {}
    finally:
        engine.shutdown()


def test_reduced_precision_charges_the_program_that_serves(
        model, fresh_ledger):
    """bf16 passes its check and serves bf16 (2-byte weights); int8 is
    refused at a tight bar and serves the native fallback (8-byte
    weights). The transient programs of the check are never charged."""
    for precision, max_err, itemsize in (("bf16", 0.05, 2),
                                         ("int8", 1e-12, 8)):
        name = f"prec_{precision}"
        registry = ModelRegistry()
        registry.register(name, model)
        engine = ServeEngine(registry, max_batch_rows=64, max_wait_ms=1.0,
                             precision=precision,
                             precision_max_err=max_err)
        try:
            engine.warmup(name)
            spec = engine._batchers[(name, 1)].async_spec
            want = "bf16" if precision == "bf16" else "native"
            assert spec.precision == want
            assert fresh_ledger.memory_bytes(name) == {
                name: N_FEAT * 4 * itemsize}
        finally:
            engine.shutdown()


def test_device_seconds_reconcile_with_devmon_under_concurrency(
        model, monkeypatch):
    """Ledger and devmon meter the SAME busy time at the SAME batcher
    completion seam: under concurrent traffic the per-model attributions
    agree (exactly, since neither samples)."""
    monkeypatch.setenv(RECONCILE_MIN_ENV, "0.0001")
    accounting.reset_ledger()
    ledger = accounting.get_ledger()
    registry = ModelRegistry()
    registry.register("recon_pca", model)
    engine = ServeEngine(registry, max_batch_rows=64, max_wait_ms=1.0)
    data = np.random.default_rng(3).normal(size=(512, N_FEAT))
    try:
        engine.warmup("recon_pca")

        def hammer(seed):
            local = np.random.default_rng(seed)
            for _ in range(30):
                n = int(local.integers(4, 48))
                start = int(local.integers(0, data.shape[0] - n))
                engine.predict("recon_pca", data[start:start + n])

        workers = [threading.Thread(target=hammer, args=(s,))
                   for s in range(4)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(120.0)
        assert not any(w.is_alive() for w in workers)
        # every batch is noted before its requests resolve
        report = ledger.reconcile()
        entry = report["models"].get("recon_pca")
        assert entry and not entry.get("skipped"), report
        assert entry["ledger_seconds"] > 0
        assert entry["ledger_seconds"] == entry["devmon_seconds"]
        assert entry["drift_ratio"] == 0.0
        drift = get_registry().gauge(
            "sparkml_model_reconcile_drift_ratio", "", ("model",))
        assert drift.value(model="recon_pca") == 0.0
    finally:
        engine.shutdown()
        accounting.reset_ledger()


def test_debug_costs_endpoint_serves_live_rollup(model, fresh_ledger):
    tsdb.reset_tsdb()
    devmon.reset_device_monitor()
    registry = ModelRegistry()
    registry.register("costs_pca", model)
    engine = ServeEngine(registry, max_batch_rows=64, max_wait_ms=1.0)
    server = start_serve_server(engine)
    data = np.random.default_rng(4).normal(size=(64, N_FEAT))
    try:
        engine.warmup("costs_pca")
        for i in range(4):
            engine.predict("costs_pca", data[i * 16:(i + 1) * 16])
        base = f"http://127.0.0.1:{server.server_address[1]}"
        doc = json.loads(urllib.request.urlopen(
            f"{base}/debug/costs", timeout=30).read())
        assert set(doc) == {"models", "cold_report", "reconcile"}
        entry = doc["models"]["costs_pca"]
        assert entry["hbm_bytes"][COMPONENT_WEIGHTS] == N_FEAT * 4 * 8
        assert entry["rows"] == 64
        assert entry["requests"]["ok"] == 4
        assert entry["device_seconds"] > 0
        assert list(entry["replicas"]) == ["cpu@v1"]
        assert any(row["model"] == "costs_pca"
                   for row in doc["cold_report"])
        # the ledger's publish is a sampler collector: its gauges get
        # history, read through the default /debug/history bundle
        sampler = tsdb.get_sampler()
        assert fresh_ledger.publish in sampler._collectors
        sampler.sample_once()
        hist = json.loads(urllib.request.urlopen(
            f"{base}/debug/history?window=300", timeout=30).read())
        assert any(s["labels"] == {"model": "costs_pca",
                                   "component": COMPONENT_WEIGHTS}
                   for s in hist["key"]["model_hbm_bytes"])
        assert any(s["labels"] == {"model": "costs_pca"}
                   for s in hist["key"]["model_ewma_rps"])
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()
        tsdb.reset_tsdb()
        devmon.reset_device_monitor()


def test_a_fits_device_time_is_not_serving_drift(monkeypatch):
    """The fit monitor attributes a fit's step device time to devmon's
    ``fit:<algo>``. The port's reconcile leaves it out and stays ``ok``;
    the JAX ledger counts it as ``(overflow)`` and reads drift (a
    reference defect: a fit run in a serving process fails reconcile)."""
    from spark_rapids_ml_tpu.obs import metrics as jax_metrics
    from spark_rapids_ml_tpu_torch.obs import metrics

    regs = {"torch": MetricsRegistry(), "jax": JaxMetrics()}
    monkeypatch.setattr(metrics, "_default_registry", regs["torch"])
    monkeypatch.setattr(jax_metrics, "_default_registry", regs["jax"])
    reports = {}
    for pkg, mod in (("torch", accounting), ("jax", jax_accounting)):
        ledger = mod.ResourceLedger()
        ledger.note_batch_seconds("served", 2.0)
        family = regs[pkg].counter(DEVMON_FAMILY, "", ("model", "device"))
        family.inc(2.0, model="served", device="cpu")
        family.inc(5.0, model="fit:distributed_pca", device="cpu")
        reports[pkg] = ledger.reconcile()
    ours, theirs = reports["torch"], reports["jax"]
    assert ours["verdict"] == "ok" and OVERFLOW_MODEL not in ours["models"]
    assert ours["models"]["served"]["drift_ratio"] == 0.0
    assert theirs["verdict"] == "drift"
    assert theirs["models"][OVERFLOW_MODEL]["drift_ratio"] == 1.0
