"""Spark-ML-style Param/Params machinery.

A copy of the JAX package's ``models/params.py`` (the parts PCA,
TruncatedSVD and LinearRegression need), kept here so the port imports
nothing of that package. Fluent ``setX``/``getX``
accessors, defaults, validation, ``copy()``, ``explainParams()``, and param
serialization into model metadata. Param surface parity:

================  =====================================  ====================
reference param   reference location                     this framework
================  =====================================  ====================
k                 Spark ``PCAParams``                    ``k``
inputCol          Spark ``PCAParams``                    ``inputCol``
outputCol         Spark ``PCAParams``                    ``outputCol``
meanCentering     ``RapidsPCA.scala:37-44``              ``meanCentering``
useGemm           ``RapidsPCA.scala:46-53``              ``useXlaDot``
useCuSolverSVD    ``RapidsPCA.scala:55-62``              ``useXlaSvd``
gpuId             ``RapidsPCA.scala:64-75``              ``deviceId``
================  =====================================  ====================
"""

from __future__ import annotations

import uuid
from typing import Any, Callable, Dict, Optional


class Param:
    """A named, documented, validated parameter attached to a Params class."""

    def __init__(
        self,
        name: str,
        doc: str,
        default: Any = None,
        validator: Optional[Callable[[Any], bool]] = None,
    ):
        self.name = name
        self.doc = doc
        self.default = default
        self.validator = validator

    def validate(self, value: Any) -> None:
        if self.validator is not None and not self.validator(value):
            raise ValueError(f"invalid value for param {self.name!r}: {value!r}")

    def __repr__(self) -> str:
        return f"Param({self.name!r})"


class Params:
    """Base class: param registry + fluent get/set + copy, as in Spark ML."""

    def __init__(self, uid: Optional[str] = None):
        self.uid = uid or f"{type(self).__name__}_{uuid.uuid4().hex[:12]}"
        self._param_map: Dict[str, Any] = {}

    # -- registry ---------------------------------------------------------
    @classmethod
    def params(cls) -> Dict[str, Param]:
        out: Dict[str, Param] = {}
        for klass in reversed(cls.__mro__):
            for value in vars(klass).values():
                if isinstance(value, Param):
                    out[value.name] = value
        return out

    def _param(self, name: str) -> Param:
        params = self.params()
        if name not in params:
            raise KeyError(f"{type(self).__name__} has no param {name!r}")
        return params[name]

    # -- get/set ----------------------------------------------------------
    def set(self, name: str, value: Any) -> "Params":
        param = self._param(name)
        param.validate(value)
        self._param_map[name] = value
        return self

    def get(self, name: str) -> Any:
        return self.get_or_default(name)

    def get_or_default(self, name: str) -> Any:
        param = self._param(name)
        return self._param_map.get(name, param.default)

    getOrDefault = get_or_default

    def is_set(self, name: str) -> bool:
        self._param(name)
        return name in self._param_map

    isSet = is_set

    def has_param(self, name: str) -> bool:
        return name in self.params()

    hasParam = has_param

    # -- fluent accessors generated for subclasses ------------------------
    def __getattr__(self, attr: str):
        # getX / setX sugar, e.g. setK(3), getInputCol().
        if attr.startswith("set") and len(attr) > 3:
            name = attr[3].lower() + attr[4:]
            if self.has_param(name):
                return lambda value: self.set(name, value)
        if attr.startswith("get") and len(attr) > 3:
            name = attr[3].lower() + attr[4:]
            if self.has_param(name):
                return lambda: self.get_or_default(name)
        raise AttributeError(f"{type(self).__name__} has no attribute {attr!r}")

    # -- utility ----------------------------------------------------------
    def copy(self, extra: Optional[Dict[str, Any]] = None) -> "Params":
        out = type(self)()
        out.uid = self.uid
        out._param_map = dict(self._param_map)
        if extra:
            for name, value in extra.items():
                out.set(name, value)
        self._copy_internal_state(out)
        return out

    def _copy_internal_state(self, other: "Params") -> None:
        """Subclasses copy non-param learned state (e.g. model matrices)."""

    def copy_values_from(self, other: "Params") -> "Params":
        for name, value in other._param_map.items():
            if self.has_param(name):
                self.set(name, value)
        return self

    def explain_params(self) -> str:
        lines = []
        for name, param in sorted(self.params().items()):
            current = self._param_map.get(name, "undefined")
            lines.append(
                f"{name}: {param.doc} (default: {param.default!r}, "
                f"current: {current!r})"
            )
        return "\n".join(lines)

    explainParams = explain_params

    def param_map_for_metadata(self) -> Dict[str, Any]:
        """Explicitly-set params + defaults, JSON-serializable — what the
        Spark ML writer puts in metadata (``RapidsPCA.scala:221``)."""
        out = {}
        for name, param in self.params().items():
            out[name] = self._param_map.get(name, param.default)
        return out


# Shared param mixins, mirroring Spark's HasInputCol/HasOutputCol traits.
class HasInputCol(Params):
    inputCol = Param("inputCol", "input column name (vector column)", "features")


class HasOutputCol(Params):
    outputCol = Param("outputCol", "output column name", "output")


class HasWeightCol(Params):
    """weightCol Param + extraction/guards — ONE definition for every
    estimator carrying Spark's per-row sample weights."""

    weightCol = Param(
        "weightCol",
        "per-row sample-weight column ('' = unweighted). Supported on "
        "in-memory fits; streamed/out-of-core inputs with weights are "
        "not supported yet.",
        "",
        validator=lambda v: isinstance(v, str),
    )

    def _extract_weights(self, frame, n_rows: int):
        """weightCol → validated float64 vector (None when unset). Runs on
        the host, before anything is placed on a device: the fits rely on
        weights ≥ 0 (LinearRegression passes √w to the Gram kernel)."""
        import numpy as np

        col = self.get_or_default("weightCol")
        if not col:
            return None
        w = np.asarray(frame.column(col), dtype=np.float64).reshape(-1)
        if w.shape[0] != n_rows:
            raise ValueError(
                f"weight column length {w.shape[0]} != rows {n_rows}"
            )
        if not np.isfinite(w).all() or (w < 0).any():
            raise ValueError("weights must be finite and non-negative")
        return w

    def _reject_streamed_weights(self) -> None:
        if self.get_or_default("weightCol"):
            raise ValueError(
                "weightCol is not supported with streamed/out-of-core "
                "input yet; fit in-memory or drop the weights"
            )


class HasDeviceId(Params):
    deviceId = Param(
        "deviceId",
        "CUDA device ordinal; -1 means take the device assigned by the "
        "runtime (the reference's gpuId resource-discovery semantics, "
        "RapidsRowMatrix.scala:171-175)",
        -1,
        validator=lambda v: isinstance(v, int),
    )


class HasThresholds(Params):
    """Spark's classifier ``thresholds`` param + the ONE prediction rule:
    predict ``argmax_i p(i)/t(i)`` over per-class probabilities — a class
    with threshold 0 wins whenever its probability is positive (Spark
    allows at most one zero). Unset (None/empty) = plain argmax."""

    thresholds = Param(
        "thresholds",
        "per-class probability thresholds (length numClasses, "
        "non-negative, at most one zero); prediction = "
        "argmax p(i)/t(i). None/[] = plain argmax",
        None,
        validator=lambda v: v is None or (
            hasattr(v, "__len__")
            and all(float(t) >= 0 for t in v)
            and sum(1 for t in v if float(t) == 0.0) <= 1
            and (len(v) == 0 or sum(float(t) for t in v) > 0)
        ),
    )

    def _predict_index(self, proba):
        """Predicted CLASS INDEX per row under the thresholds rule."""
        import numpy as np

        t = self.get_or_default("thresholds")
        proba = np.asarray(proba, dtype=np.float64)
        if t is None or len(t) == 0:
            return np.argmax(proba, axis=1)
        t = np.asarray(t, dtype=np.float64)
        if t.shape[0] != proba.shape[1]:
            raise ValueError(
                f"thresholds length {t.shape[0]} != numClasses "
                f"{proba.shape[1]}"
            )
        with np.errstate(divide="ignore", invalid="ignore"):
            scaled = proba / t
        # p=0 at t=0 gives nan: that class has no support, never wins
        scaled = np.where(np.isnan(scaled), -np.inf, scaled)
        return np.argmax(scaled, axis=1)
