"""Thread-safe model registry: the serving engine's model catalogue.

The port's counterpart of the JAX package's ``serve/registry.py``. Names
map to immutable numbered versions of fitted models; aliases
(``"prod" → ("pca_embedder", 3)``) give traffic a stable handle while new
versions roll in behind it. Models arrive either in-process (``register``
a fitted model, e.g. one carried across with ``PCAModel.from_numpy``) or
from disk (``load``, through ``io.persistence.load_model``, which loads
every family the port saves, whichever package saved it).

``warmup`` pushes one zero batch per shape bucket through a model's
transform before real traffic arrives.

Crash recovery: with a ``manifest_path`` the registry persists its
deployment state — names, versions, aliases, bucket ladders, source
paths — to one atomically-written JSON manifest after every mutation,
and on startup **reloads the last persisted manifest**: every version
with a ``source_path`` is re-loaded from disk at its ORIGINAL version
number (pinned aliases keep meaning something) and aliases are restored;
a caller that wants them warm calls ``warmup`` after construction. A
process crash no longer loses the deployment state; only
in-process-registered models (no ``source_path``) cannot be recovered
and are reported as skipped.

Registered-model gauge, load / warmup / recovery counters and the warmup
seconds per bucket go to ``obs.metrics``.
"""

from __future__ import annotations

import datetime
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from spark_rapids_ml_tpu_torch.obs.metrics import get_registry
from spark_rapids_ml_tpu_torch.utils.padding import default_buckets

_MANIFEST_VERSION = 1

# Attributes probed (in order) to infer a model's expected feature count
# for warmup batches when the caller does not pass one.
_FEATURE_HINTS = (
    ("pc", lambda v: v.shape[0]),                  # PCAModel (n_features, k)
    ("cluster_centers", lambda v: v.shape[1]),     # KMeans (k, n_features)
    ("coefficients", lambda v: np.asarray(v).shape[0]),
    ("coefficient_matrix", lambda v: v.shape[1]),  # multinomial (K, d)
    # scaler-family statistics: one entry per input feature (these also
    # lead fitted pipelines, whose input width IS the first stage's)
    ("mean", lambda v: np.asarray(v).shape[0]),    # StandardScalerModel
    ("original_min", lambda v: np.asarray(v).shape[0]),  # MinMaxScaler
    ("max_abs", lambda v: np.asarray(v).shape[0]),       # MaxAbsScaler
    ("median", lambda v: np.asarray(v).shape[0]),        # RobustScaler
)


def utcnow_iso() -> str:
    return datetime.datetime.now(datetime.timezone.utc).isoformat()


class RegisteredModel:
    """One immutable (name, version) registry entry."""

    __slots__ = ("name", "version", "model", "buckets", "registered_utc",
                 "warmed_buckets", "source_path")

    def __init__(self, name: str, version: int, model: Any,
                 buckets: Optional[Tuple[int, ...]] = None,
                 source_path: Optional[str] = None):
        self.name = name
        self.version = version
        self.model = model
        self.buckets = tuple(buckets) if buckets else None
        self.registered_utc = utcnow_iso()
        self.warmed_buckets: Tuple[int, ...] = ()
        self.source_path = source_path

    def as_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "version": self.version,
            "model_class": type(self.model).__name__,
            "buckets": list(self.buckets) if self.buckets else None,
            "registered_utc": self.registered_utc,
            "warmed_buckets": list(self.warmed_buckets),
            "source_path": self.source_path,
        }


class ModelRegistry:
    """register / alias / version fitted models; resolve by name.

    ``manifest_path`` turns on crash recovery: every mutation persists
    the deployment state, and construction reloads the last persisted
    manifest when there is one — see ``recover()``. The recovery report
    lands in ``self.recovery_report_``.
    """

    def __init__(self, manifest_path: Optional[str] = None):
        self._lock = threading.RLock()
        self._versions: Dict[str, Dict[int, RegisteredModel]] = {}
        self._aliases: Dict[str, Tuple[str, Optional[int]]] = {}
        # Manifest entries recover() could NOT bring back (transient load
        # failure, in-process registration): retained so the next
        # manifest write does not erase them from disk (a later restart
        # may succeed), and so register() never reuses their version
        # numbers under a pinned alias. name -> {version -> entry}.
        self._retained: Dict[str, Dict[int, Dict[str, Any]]] = {}
        self.manifest_path = manifest_path or None
        # Manifest writes happen OUTSIDE self._lock (disk latency must
        # not stall resolve_entry on the serving path); the sequence
        # numbers keep racing writers from landing an older doc last.
        self._io_lock = threading.Lock()
        self._mutation_seq = 0
        self._written_seq = 0
        self._recovering = False
        self.recovery_report_: Optional[Dict[str, Any]] = None
        if self.manifest_path and os.path.exists(self.manifest_path):
            self.recovery_report_ = self.recover()

    # -- registration ------------------------------------------------------

    def register(self, name: str, model: Any, *,
                 buckets: Optional[Sequence[int]] = None,
                 source_path: Optional[str] = None) -> int:
        """Register a fitted model under ``name``; returns the assigned
        version (1 + the previous highest — versions are immutable, a
        re-register is a new version, never a mutation). Versions held
        by unrecovered manifest entries count toward the highest: a slot
        a pinned alias may still point at is never reassigned to a new
        model lineage."""
        with self._lock:
            version = max(
                (*self._versions.get(name, ()),
                 *self._retained.get(name, ())),
                default=0,
            ) + 1
            self._register_entry(name, version, model, buckets=buckets,
                                 source_path=source_path)
            pending = self._pending_manifest()
        self._write_manifest(pending)
        self._count_registration(name)
        return version

    def _register_at(self, name: str, version: int, model: Any, *,
                     buckets: Optional[Sequence[int]] = None,
                     source_path: Optional[str] = None) -> None:
        """Register at an EXPLICIT version — what recovery uses so
        pinned aliases keep pointing at the deployment they meant.
        Versions stay immutable: an occupied slot raises."""
        with self._lock:
            self._register_entry(name, version, model, buckets=buckets,
                                 source_path=source_path)
            pending = self._pending_manifest()
        self._write_manifest(pending)
        self._count_registration(name)

    def _register_entry(self, name: str, version: int, model: Any, *,
                        buckets: Optional[Sequence[int]] = None,
                        source_path: Optional[str] = None) -> None:
        """Validate and insert one version. Caller holds the lock."""
        if not name or "@" in name:
            raise ValueError(
                f"invalid model name {name!r} ('@' is the version separator)"
            )
        versions = self._versions.setdefault(name, {})
        if version in versions:
            raise ValueError(
                f"version {name!r}@{version} already registered "
                "(versions are immutable)"
            )
        versions[version] = RegisteredModel(
            name, version, model, buckets=buckets,
            source_path=source_path,
        )
        # a retried recovery that succeeded reclaims its retained slot
        self._retained.get(name, {}).pop(version, None)
        self._record_gauge()

    @staticmethod
    def _count_registration(name: str) -> None:
        get_registry().counter(
            "sparkml_serve_model_registrations_total",
            "models registered into the serving registry", ("model",),
        ).inc(model=name)

    def load(self, name: str, path: str, *,
             buckets: Optional[Sequence[int]] = None) -> int:
        """Load a saved model from ``path`` (``io.persistence.load_model``
        dispatch) and register it; returns the assigned version."""
        from spark_rapids_ml_tpu_torch.io.persistence import load_model

        model = load_model(path)
        get_registry().counter(
            "sparkml_serve_model_loads_total",
            "models loaded from disk into the serving registry", ("model",),
        ).inc(model=name)
        return self.register(name, model, buckets=buckets, source_path=path)

    def alias(self, alias: str, name: str,
              version: Optional[int] = None) -> None:
        """Point ``alias`` at ``name`` (pinned to ``version``, or floating
        to the latest when None). Re-aliasing is how traffic rolls over.

        The flip is ONE mutation under the registry lock, and
        ``resolve_entry`` reads the alias map and the version table
        under the same lock — a resolver racing the flip observes
        either the old or the new target in full, never a half-promoted
        state. Every flip is counted (rule 13: an alias mutation the
        metrics cannot see is an unauditable rollover)."""
        with self._lock:
            if name not in self._versions:
                raise KeyError(f"unknown model {name!r}")
            if version is not None and version not in self._versions[name]:
                raise KeyError(f"unknown version {name!r}@{version}")
            self._aliases[alias] = (name, version)
            pending = self._pending_manifest()
        self._write_manifest(pending)
        get_registry().counter(
            "sparkml_serve_alias_flips_total",
            "alias mutations (rollover / promote / rollback flips)",
            ("alias", "model"),
        ).inc(alias=alias, model=name)

    def deregister(self, name: str, version: Optional[int] = None) -> None:
        """Drop one version (or every version) of ``name``; aliases to it
        dangle and resolve() will raise — deliberate, so a bad rollover is
        loud rather than silently serving a deleted model. Also the
        explicit way to erase a retained (unrecovered) manifest entry —
        until then it survives every persist for the next restart to
        retry."""
        with self._lock:
            live = self._versions.get(name)
            retained = self._retained.get(name)
            if live is None and retained is None:
                raise KeyError(f"unknown model {name!r}")
            if version is None:
                self._versions.pop(name, None)
                self._retained.pop(name, None)
            else:
                if live is not None and version in live:
                    del live[version]
                    if not live:
                        del self._versions[name]
                elif retained is not None and version in retained:
                    del retained[version]
                    if not retained:
                        del self._retained[name]
                else:
                    raise KeyError(f"unknown version {name!r}@{version}")
            self._record_gauge()
            pending = self._pending_manifest()
        self._write_manifest(pending)

    # -- resolution --------------------------------------------------------

    def resolve_entry(self, ref: str,
                      version: Optional[int] = None) -> RegisteredModel:
        """``"name"`` (latest), ``"name@3"`` (pinned), or an alias."""
        with self._lock:
            if version is None and "@" in ref:
                ref, _, v = ref.partition("@")
                try:
                    version = int(v)
                except ValueError:
                    # a client error, not an internal one — KeyError maps
                    # to 404 at the HTTP layer like any unknown ref
                    raise KeyError(
                        f"bad version suffix in model ref {ref!r}@{v!r} "
                        "(expected an integer)"
                    ) from None
            if ref in self._aliases and ref not in self._versions:
                name, pinned = self._aliases[ref]
                version = pinned if version is None else version
                ref = name
            versions = self._versions.get(ref)
            if not versions:
                raise KeyError(f"unknown model {ref!r}")
            if version is None:
                version = max(versions)
            entry = versions.get(version)
            if entry is None:
                raise KeyError(f"unknown version {ref!r}@{version}")
            return entry

    def resolve(self, ref: str, version: Optional[int] = None) -> Any:
        return self.resolve_entry(ref, version).model

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._versions)

    # -- warmup ------------------------------------------------------------

    def warmup(self, ref: str, *, n_features: Optional[int] = None,
               buckets: Optional[Sequence[int]] = None,
               max_bucket_rows: int = 1024) -> Dict[str, Any]:
        """Warm ``ref``'s transform at its shape buckets.

        Pushes one all-zero batch per bucket through ``model.transform``
        (row-independent products make zeros safe), so every steady-state
        shape has run once before real traffic arrives. Returns
        ``{"buckets": {rows: seconds, ...}, "total_seconds": ...}``.
        """
        entry = self.resolve_entry(ref)
        model = entry.model
        if n_features is None:
            n_features = _infer_features(model)
        if n_features is None:
            raise ValueError(
                f"cannot infer feature count for {ref!r}; pass n_features="
            )
        chosen = tuple(buckets or entry.buckets
                       or default_buckets(max_bucket_rows))
        report: Dict[int, float] = {}
        t_total = time.perf_counter()
        for bucket in sorted(set(int(b) for b in chosen)):
            zeros = np.zeros((bucket, int(n_features)))
            t0 = time.perf_counter()
            model.transform(zeros)
            report[bucket] = time.perf_counter() - t0
        entry.warmed_buckets = tuple(sorted(report))
        if entry.buckets is None:
            entry.buckets = tuple(sorted(report))
        # persist the warm ladder: the manifest must record which
        # buckets were warm at shutdown so a restart can replay them
        # (the zero-cold-start contract rides this record)
        with self._lock:
            pending = self._pending_manifest()
        self._write_manifest(pending)
        get_registry().counter(
            "sparkml_serve_warmups_total",
            "warmup passes run against registered models", ("model",),
        ).inc(model=entry.name)
        get_registry().gauge(
            "sparkml_serve_warmup_seconds",
            "wall-clock of the last warmup pass", ("model",),
        ).set(time.perf_counter() - t_total, model=entry.name)
        return {
            "model": entry.name,
            "version": entry.version,
            "buckets": report,
            "total_seconds": time.perf_counter() - t_total,
        }

    # -- crash recovery ----------------------------------------------------

    def manifest(self) -> Dict[str, Any]:
        """The JSON-safe deployment state a crashed process needs back:
        names → versions (with source paths + buckets) and aliases."""
        with self._lock:
            return {
                "manifest_version": _MANIFEST_VERSION,
                "saved_utc": utcnow_iso(),
                "models": self._manifest_models(),
                "aliases": {
                    alias: {"name": n, "version": v}
                    for alias, (n, v) in self._aliases.items()
                },
            }

    def _manifest_models(self) -> Dict[str, List[Dict[str, Any]]]:
        """Live versions merged with retained (unrecovered) manifest
        entries — a version that failed to load on the last restart
        stays on disk so a later restart can retry it, instead of being
        erased by the first post-recovery mutation. Caller holds the
        lock."""
        models: Dict[str, Dict[int, Dict[str, Any]]] = {}
        for name, versions in self._versions.items():
            models[name] = {
                v: {
                    "version": v,
                    "source_path": versions[v].source_path,
                    "buckets": (list(versions[v].buckets)
                                if versions[v].buckets else None),
                    # which bucket ladders were warm at the last persist
                    "warmed_buckets": (list(versions[v].warmed_buckets)
                                       or None),
                }
                for v in versions
            }
        for name, retained in self._retained.items():
            slots = models.setdefault(name, {})
            for v, entry in retained.items():
                slots.setdefault(v, dict(entry))
        return {
            name: [slots[v] for v in sorted(slots)]
            for name, slots in models.items()
        }

    def _pending_manifest(self) -> Optional[Tuple[int, Dict[str, Any]]]:
        """The (sequence, doc) snapshot a mutation wants persisted —
        built under the lock (consistent state), written by
        ``_write_manifest`` AFTER the lock is released so disk latency
        never stalls ``resolve_entry`` on the serving path. None without
        a manifest_path, and suppressed DURING recovery so a crash
        mid-recovery cannot overwrite the good manifest with a partial
        one. Caller holds the lock."""
        if not self.manifest_path or self._recovering:
            return None
        self._mutation_seq += 1
        return self._mutation_seq, self.manifest()

    def _write_manifest(self,
                        pending: Optional[Tuple[int, Dict[str, Any]]],
                        ) -> None:
        """Write one pending manifest atomically (tmp + rename — a crash
        mid-write leaves the previous manifest, never half a JSON).
        Racing mutations serialize on the io lock; a doc older than the
        last one written is dropped, so the file always holds the newest
        state."""
        if pending is None:
            return
        seq, doc = pending
        with self._io_lock:
            if seq <= self._written_seq:
                return  # a newer mutation's doc already landed
            try:
                tmp = f"{self.manifest_path}.tmp-{os.getpid()}"
                with open(tmp, "w") as f:
                    json.dump(doc, f, indent=1)
                os.replace(tmp, self.manifest_path)
                self._written_seq = seq
            except OSError:
                # Persistence failure must not break serving — but it
                # must be visible: a registry that silently stopped
                # checkpointing has silently lost its crash recovery.
                get_registry().counter(
                    "sparkml_serve_manifest_errors_total",
                    "failed registry-manifest writes", (),
                ).inc()

    def _retain(self, name: str, version: int,
                entry: Dict[str, Any]) -> None:
        with self._lock:
            slot = dict(entry)
            slot["version"] = int(version)
            self._retained.setdefault(name, {})[int(version)] = slot

    def recover(self) -> Dict[str, Any]:
        """Reload the last persisted manifest: every version with a
        ``source_path`` is loaded from disk at its ORIGINAL version
        number and aliases are restored (dangling ones dropped).
        Returns a report; never raises — a corrupt manifest or one bad
        model path degrades to a partial recovery with the failure
        recorded, not a crashed startup."""
        report: Dict[str, Any] = {
            "manifest_path": self.manifest_path,
            "recovered": [], "skipped": [], "failed": [],
            "aliases": 0,
        }
        reg = get_registry()
        m_recovered = reg.counter(
            "sparkml_serve_recovered_models_total",
            "model versions re-registered from the persisted manifest "
            "after a restart", ("model",),
        )
        m_skipped = reg.counter(
            "sparkml_serve_recovery_skipped_total",
            "manifest entries that could not be recovered (no source "
            "path, or the load failed)", ("model", "reason"),
        )
        try:
            with open(self.manifest_path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as exc:
            report["error"] = f"{type(exc).__name__}: {exc}"
            m_skipped.inc(model="(manifest)", reason="unreadable")
            return report
        self._recovering = True
        try:
            for name, entries in sorted(dict(doc.get("models", {})).items()):
                for entry in entries:
                    version = int(entry.get("version", 0))
                    path = entry.get("source_path")
                    ref = f"{name}@{version}"
                    if not path:
                        # in-process registrations have nothing on disk;
                        # retain the slot so its version is never reused
                        report["skipped"].append(ref)
                        m_skipped.inc(model=name, reason="no_source_path")
                        self._retain(name, version, entry)
                        continue
                    try:
                        from spark_rapids_ml_tpu_torch.io.persistence import (
                            load_model,
                        )

                        model = load_model(path)
                        self._register_at(
                            name, version, model,
                            buckets=entry.get("buckets"),
                            source_path=path,
                        )
                        warmed = entry.get("warmed_buckets")
                        if warmed:
                            # restore the warm-ladder record
                            self._versions[name][version].warmed_buckets \
                                = tuple(int(b) for b in warmed)
                    except Exception as exc:  # noqa: BLE001 - per-entry
                        # one bad path must not sink the whole recovery;
                        # counted per model so the partial recovery pages.
                        # Retained: the entry stays in the manifest (the
                        # next restart retries a transient failure) and
                        # its version number is never reassigned.
                        report["failed"].append(
                            f"{ref}: {type(exc).__name__}: {exc}")
                        m_skipped.inc(model=name, reason="load_failed")
                        self._retain(name, version, entry)
                        continue
                    report["recovered"].append(ref)
                    m_recovered.inc(model=name)
            for alias, target in dict(doc.get("aliases", {})).items():
                try:
                    self.alias(alias, target.get("name"),
                               target.get("version"))
                except (KeyError, AttributeError, TypeError):
                    report["failed"].append(f"alias {alias!r}: dangling")
                    m_skipped.inc(model=str(target), reason="dangling_alias")
                    continue
                report["aliases"] += 1
        finally:
            self._recovering = False
        return report

    # -- introspection -----------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """JSON-safe registry state + the live metrics-registry snapshot
        (queue depth, occupancy, deadline counters... — everything the
        serving stack emits)."""
        with self._lock:
            models = {
                name: [versions[v].as_dict() for v in sorted(versions)]
                for name, versions in self._versions.items()
            }
            aliases = {
                a: {"name": n, "version": v}
                for a, (n, v) in self._aliases.items()
            }
        return {
            "models": models,
            "aliases": aliases,
            "manifest_path": self.manifest_path,
            "metrics": get_registry().snapshot(),
        }

    def _record_gauge(self) -> None:
        n = sum(len(v) for v in self._versions.values())
        get_registry().gauge(
            "sparkml_serve_registered_models",
            "model versions currently registered for serving",
        ).set(n)


def _infer_features(model) -> Optional[int]:
    # A fitted PipelineModel's input width is its FIRST stage's: recurse
    # down the chain until a stage carries per-feature state (stateless
    # elementwise stages — Normalizer, Binarizer — preserve width, so
    # looking past them stays correct; width-changing stages all carry
    # state and resolve before the recursion passes them).
    stages = getattr(model, "stages", None)
    if isinstance(stages, (list, tuple)):
        for stage in stages:
            got = _infer_features(stage)
            if got is not None:
                return got
            if type(stage).__name__ not in ("Normalizer", "Binarizer"):
                break  # unknown stateful stage: width past it is unknowable
        return None
    for attr, extract in _FEATURE_HINTS:
        value = getattr(model, attr, None)
        if value is not None:
            try:
                return int(extract(value))
            except (TypeError, ValueError, AttributeError, IndexError):
                continue
    return None
