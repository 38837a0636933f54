"""Minimal Spark-compatible local engine — the in-environment proof lane.

This is NOT a Spark reimplementation. It is a deliberately tiny,
clearly-labeled stand-in for exactly the pyspark surface the front-ends in
``spark/estimator.py`` consume — DataFrame ``select`` / ``limit`` /
``mapInArrow`` / ``collect`` / ``withColumn`` + ``pandas_udf`` /
``persist``, the ``pyspark.ml`` Estimator/Model/Params base classes, and
the ``pyspark.ml.linalg`` vector/matrix types — so that:

* the pyspark integration code paths EXECUTE in environments without
  pyspark (the reference proves its Spark round-trip with Spark's own
  ``DefaultReadWriteTest``, ``PCASuite.scala:192-206``; this engine is the
  analogous in-environment proof for this repo's CI sandbox), and
* executor-side behavior (Arrow densification, device-resident
  accumulation, card pinning) can be tested in REAL separate worker
  processes: ``LocalSparkSession(executors="process")`` ships each
  partition task to a spawned process via cloudpickle — the same closure
  transport pyspark uses — instead of faking executors with threads.

When real pyspark is importable, ``spark/_compat.py`` binds the front-ends
to it and this module is not used for the session types; the engine never
shadows a real installation.

The port's copy of the JAX package's ``spark/local_engine.py``. pyarrow,
pandas and cloudpickle are imported only where a task or a transform
needs them, so this module imports on a machine without them.
"""

from __future__ import annotations

import functools
import uuid
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
from spark_rapids_ml_tpu_torch.obs import observed_transform

__all__ = [
    "DenseMatrix",
    "DenseVector",
    "Estimator",
    "HasInputCol",
    "HasOutputCol",
    "LocalDataFrame",
    "LocalSparkSession",
    "Model",
    "Param",
    "Params",
    "Row",
    "SparseVector",
    "TypeConverters",
    "VectorUDT",
    "col",
    "keyword_only",
    "pandas_udf",
]


# --------------------------------------------------------------------------
# pyspark.ml.linalg subset
# --------------------------------------------------------------------------

class DenseVector:
    def __init__(self, values):
        self.values = np.asarray(values, dtype=np.float64).reshape(-1)

    def toArray(self) -> np.ndarray:
        return self.values.copy()

    def __len__(self):
        return self.values.shape[0]

    def __getitem__(self, i):
        return self.values[i]

    def __iter__(self):
        return iter(self.values)

    def __eq__(self, other):
        return isinstance(other, DenseVector) and np.array_equal(
            self.values, other.values
        )

    def __repr__(self):
        return f"DenseVector({self.values.tolist()})"


class SparseVector:
    def __init__(self, size: int, indices, values):
        self.size = int(size)
        self.indices = np.asarray(indices, dtype=np.int64).reshape(-1)
        self.values = np.asarray(values, dtype=np.float64).reshape(-1)

    def toArray(self) -> np.ndarray:
        dense = np.zeros(self.size)
        dense[self.indices] = self.values
        return dense

    def __len__(self):
        return self.size

    def __repr__(self):
        return (f"SparseVector({self.size}, {self.indices.tolist()}, "
                f"{self.values.tolist()})")


class DenseMatrix:
    """Column-major storage, as pyspark.ml.linalg.DenseMatrix."""

    def __init__(self, numRows: int, numCols: int, values,
                 isTransposed: bool = False):
        self.numRows = int(numRows)
        self.numCols = int(numCols)
        self.values = np.asarray(values, dtype=np.float64).reshape(-1)
        self.isTransposed = bool(isTransposed)

    def toArray(self) -> np.ndarray:
        order = "C" if self.isTransposed else "F"
        return self.values.reshape((self.numRows, self.numCols), order=order)

    def __repr__(self):
        return f"DenseMatrix({self.numRows}, {self.numCols}, ...)"


class VectorUDT:
    """Type tag only — the local engine carries vectors as Python objects."""

    def simpleString(self) -> str:
        return "vector"


def _vector_to_struct(v) -> Dict[str, Any]:
    """VectorUDT wire struct (pyspark.ml.linalg.VectorUDT.serialize)."""
    if isinstance(v, SparseVector):
        return {"type": 0, "size": v.size, "indices": v.indices.tolist(),
                "values": v.values.tolist()}
    if isinstance(v, DenseVector):
        return {"type": 1, "size": None, "indices": None,
                "values": v.values.tolist()}
    arr = np.asarray(v, dtype=np.float64).reshape(-1)
    return {"type": 1, "size": None, "indices": None,
            "values": arr.tolist()}


def _is_vector_like(v) -> bool:
    return isinstance(v, (DenseVector, SparseVector)) or (
        isinstance(v, (list, tuple, np.ndarray))
        and not isinstance(v, str)
    )


# --------------------------------------------------------------------------
# pyspark.ml param/base subset
# --------------------------------------------------------------------------

class TypeConverters:
    @staticmethod
    def toInt(v):
        return int(v)

    @staticmethod
    def toFloat(v):
        return float(v)

    @staticmethod
    def toBoolean(v):
        if not isinstance(v, bool):
            raise TypeError(f"expected bool, got {type(v).__name__}")
        return v

    @staticmethod
    def toString(v):
        return str(v)

    @staticmethod
    def toListFloat(v):
        return [float(x) for x in v]


class Param:
    def __init__(self, parent, name: str, doc: str = "",
                 typeConverter: Optional[Callable] = None):
        self.parent = parent
        self.name = name
        self.doc = doc
        self.typeConverter = typeConverter

    def __repr__(self):
        return f"Param({self.name})"


class Params:
    """Name-keyed param store with the pyspark method surface the
    front-ends use (_set/_setDefault/getOrDefault/isSet/hasDefault/
    _copyValues/_resetUid)."""

    _DUMMY = object()

    def __init__(self):
        self.uid = f"{type(self).__name__}_{uuid.uuid4().hex[:12]}"
        self._paramMap: Dict[str, Any] = {}
        self._defaultParamMap: Dict[str, Any] = {}

    @staticmethod
    def _dummy():
        return Params._DUMMY

    @property
    def params(self) -> List[Param]:
        out = []
        for klass in type(self).__mro__:
            for name, attr in vars(klass).items():
                if isinstance(attr, Param) and attr not in out:
                    out.append(attr)
        return sorted(out, key=lambda p: p.name)

    def hasParam(self, name: str) -> bool:
        return isinstance(getattr(type(self), name, None), Param)

    def _param(self, p) -> Param:
        name = p.name if isinstance(p, Param) else p
        attr = getattr(type(self), name, None)
        if not isinstance(attr, Param):
            raise AttributeError(f"{type(self).__name__} has no param {name}")
        return attr

    def _set(self, **kwargs):
        for name, value in kwargs.items():
            p = self._param(name)
            if value is not None and p.typeConverter is not None:
                value = p.typeConverter(value)
            self._paramMap[name] = value
        return self

    def _setDefault(self, **kwargs):
        self._defaultParamMap.update(kwargs)
        return self

    def getOrDefault(self, p):
        name = self._param(p).name
        if name in self._paramMap:
            return self._paramMap[name]
        if name in self._defaultParamMap:
            return self._defaultParamMap[name]
        raise KeyError(f"param {name} is not set and has no default")

    def set(self, p, value):
        """pyspark's public ``Params.set(param, value)``."""
        param = self._param(p)
        if param.typeConverter is not None:
            value = param.typeConverter(value)
        self._paramMap[param.name] = value
        return self

    def isSet(self, p) -> bool:
        return self._param(p).name in self._paramMap

    def hasDefault(self, p) -> bool:
        return self._param(p).name in self._defaultParamMap

    def isDefined(self, p) -> bool:
        return self.isSet(p) or self.hasDefault(p)

    def _resetUid(self, uid: str):
        self.uid = uid
        return self

    def _copyValues(self, to: "Params", extra=None):
        for name, value in self._defaultParamMap.items():
            if hasattr(type(to), name) and name not in to._defaultParamMap:
                to._defaultParamMap[name] = value
        for name, value in self._paramMap.items():
            if hasattr(type(to), name):
                to._paramMap[name] = value
        if extra:
            to._paramMap.update(extra)
        return to


def keyword_only(func):
    @functools.wraps(func)
    def wrapper(self, *args, **kwargs):
        if args:
            raise TypeError(
                f"Method {func.__name__} only takes keyword arguments."
            )
        self._input_kwargs = kwargs
        return func(self, **kwargs)

    return wrapper


class HasInputCol(Params):
    inputCol = Param(Params._DUMMY, "inputCol", "input column name",
                     typeConverter=TypeConverters.toString)

    def getInputCol(self):
        return self.getOrDefault(self.inputCol)


class HasOutputCol(Params):
    outputCol = Param(Params._DUMMY, "outputCol", "output column name",
                      typeConverter=TypeConverters.toString)

    def getOutputCol(self):
        return self.getOrDefault(self.outputCol)


class Estimator(Params):
    def fit(self, dataset, params=None):
        return self._fit(dataset)


class Model(Params):
    @observed_transform
    def transform(self, dataset, params=None):
        return self._transform(dataset)


# --------------------------------------------------------------------------
# pyspark.sql subset: Row / columns / pandas_udf
# --------------------------------------------------------------------------

class Row:
    """Tuple-like row addressable by position, name, or attribute."""

    __slots__ = ("_fields", "_values")

    def __init__(self, fields: Sequence[str], values: Sequence[Any]):
        object.__setattr__(self, "_fields", tuple(fields))
        object.__setattr__(self, "_values", tuple(values))

    def __getitem__(self, key):
        if isinstance(key, int):
            return self._values[key]
        return self._values[self._fields.index(key)]

    def __getattr__(self, name):
        fields = object.__getattribute__(self, "_fields")
        if name in fields:
            return self._values[fields.index(name)]
        raise AttributeError(name)

    def asDict(self) -> Dict[str, Any]:
        return dict(zip(self._fields, self._values))

    def get(self, key, default=None):
        try:
            return self[key]
        except (ValueError, IndexError, KeyError):
            return default

    def __len__(self):
        return len(self._values)

    def __iter__(self):
        return iter(self._values)

    def __repr__(self):
        pairs = ", ".join(f"{f}={v!r}" for f, v in
                          zip(self._fields, self._values))
        return f"Row({pairs})"


class _SeriesExpr:
    """Elementwise column expression: a callable over a pandas Series of
    the input column (the evaluation shape shared with pandas_udf)."""

    def __init__(self, input_col: "_Column", fn: Callable):
        self.input_col = input_col
        self.fn = fn

    def cast(self, type_name: str) -> "_SeriesExpr":
        if type_name not in ("double", "float", "int", "integer", "long"):
            raise ValueError(f"unsupported cast type {type_name!r}")
        to = float if type_name in ("double", "float") else int
        inner = self.fn
        return _SeriesExpr(
            self.input_col, lambda s: inner(s).map(to)
        )


class _Column:
    def __init__(self, name: str):
        self.name = name

    def _cmp(self, op: Callable) -> _SeriesExpr:
        return _SeriesExpr(self, lambda s: s.map(lambda v: op(v)))

    def __ge__(self, other):
        return self._cmp(lambda v: v >= other)

    def __gt__(self, other):
        return self._cmp(lambda v: v > other)

    def __le__(self, other):
        return self._cmp(lambda v: v <= other)

    def __lt__(self, other):
        return self._cmp(lambda v: v < other)

    # pyspark's Column overloads equality into an expression too; the
    # default object hash is kept explicitly since defining __eq__ alone
    # would otherwise make columns unhashable
    __hash__ = object.__hash__

    def __eq__(self, other):
        return self._cmp(lambda v: v == other)

    def __ne__(self, other):
        return self._cmp(lambda v: v != other)


def col(name: str) -> _Column:
    return _Column(name)


class _UdfExpr:
    def __init__(self, fn: Callable, input_cols, return_type):
        self.fn = fn
        self.input_cols = tuple(input_cols)
        self.return_type = return_type


class _PandasUdf:
    def __init__(self, fn: Callable, return_type):
        self.fn = fn
        self.return_type = return_type

    def __call__(self, *columns: _Column) -> _UdfExpr:
        # real pyspark pandas_udfs take one Series per input column
        return _UdfExpr(self.fn, columns, self.return_type)


def pandas_udf(f=None, returnType=None, functionType=None):
    """Decorator form used by the front-ends:
    ``@pandas_udf(returnType=...)``."""
    if f is None or not callable(f):
        # called as @pandas_udf(returnType=...) — possibly with the type
        # as the single positional arg
        rt = returnType if returnType is not None else f

        def deco(fn):
            return _PandasUdf(fn, rt)

        return deco
    return _PandasUdf(f, returnType)


# --------------------------------------------------------------------------
# the DataFrame + session
# --------------------------------------------------------------------------

def _run_pickled_task(payload: bytes) -> bytes:
    """Worker entry: cloudpickle transport both ways (module-level so the
    spawned process can import it — the executor boundary)."""
    import os

    import cloudpickle

    fn, fields, columns, part_id, n_parts = cloudpickle.loads(payload)
    # the TaskContext analogue: partition identity for barrier-stage tasks
    # (pyspark exposes TaskContext.partitionId(); the local engine exports
    # the same facts as env — see spark/device_aggregate.py consumers)
    os.environ["LOCALSPARK_PARTITION_ID"] = str(part_id)
    os.environ["LOCALSPARK_NUM_PARTITIONS"] = str(n_parts)
    batch = _record_batch(fields, columns)
    out_rows: List[Dict[str, Any]] = []
    for out in fn(iter([batch])):
        out_rows.extend(_batch_pylist(out))
    return cloudpickle.dumps(out_rows)


def _batch_pylist(batch) -> List[Dict[str, Any]]:
    """``batch.to_pylist()``, with each float list column (a partial's
    flattened Gram or sums) read through numpy: the same Python lists,
    without pyarrow making each float on its own."""
    import pyarrow as pa

    columns = []
    for column in batch.columns:
        if (pa.types.is_list(column.type)
                and (pa.types.is_float32(column.type.value_type)
                     or pa.types.is_float64(column.type.value_type))
                and column.null_count == 0 and len(column)):
            flat = column.flatten()
            if flat.null_count == 0:
                offsets = column.offsets.to_numpy()
                columns.append([
                    part.tolist() for part in np.split(
                        flat.to_numpy(zero_copy_only=False),
                        offsets[1:-1] - offsets[0])])
                continue
        columns.append(column.to_pylist())
    names = batch.schema.names
    return [dict(zip(names, row)) for row in zip(*columns)]


def _record_batch(fields: Sequence[str], columns: Sequence[List[Any]]):
    """One partition's pyarrow.RecordBatch, vector columns as VectorUDT
    structs — the mapInArrow wire shape."""
    import pyarrow as pa

    arrays = []
    names = []
    for name, values in zip(fields, columns):
        if values and _is_vector_like(values[0]):
            dense = _dense_struct_array(values)
            arrays.append(dense if dense is not None else
                          pa.array([_vector_to_struct(v) for v in values]))
        else:
            arrays.append(pa.array(values))
        names.append(name)
    return pa.RecordBatch.from_arrays(arrays, names=names)


def _dense_struct_array(values: Sequence[Any]):
    """The VectorUDT struct array of a column of DenseVectors of one size,
    built from one stacked matrix: the array ``pa.array`` makes of their
    ``_vector_to_struct`` dicts, without a Python float per element. None
    for any other column."""
    import pyarrow as pa

    if not all(isinstance(v, DenseVector) for v in values):
        return None
    size = len(values[0].values)
    if (size == 0 or len(values) * size >= 2**31
            or any(len(v.values) != size for v in values)):
        return None  # a list array's int32 offsets end at 2**31 - 1
    flat = pa.array(np.stack([v.values for v in values]).reshape(-1))
    offsets = pa.array(np.arange(len(values) + 1, dtype=np.int32) * size)
    return pa.StructArray.from_arrays(
        [pa.array(np.ones(len(values), dtype=np.int64)),
         pa.nulls(len(values)), pa.nulls(len(values)),
         pa.ListArray.from_arrays(offsets, flat)],
        names=["type", "size", "indices", "values"])


class LocalDataFrame:
    def __init__(self, session: "LocalSparkSession", fields: Sequence[str],
                 partitions: List[List[tuple]]):
        self._session = session
        self._fields = list(fields)
        self._partitions = partitions  # list of list of value-tuples

    # -- relational subset -------------------------------------------------
    @property
    def columns(self) -> List[str]:
        return list(self._fields)

    def select(self, *cols_) -> "LocalDataFrame":
        names = [c.name if isinstance(c, _Column) else c for c in cols_]
        idx = [self._fields.index(n) for n in names]
        parts = [[tuple(row[i] for i in idx) for row in part]
                 for part in self._partitions]
        return LocalDataFrame(self._session, names, parts)

    def limit(self, n: int) -> "LocalDataFrame":
        rows = [r for part in self._partitions for r in part][:n]
        return LocalDataFrame(self._session, self._fields, [rows])

    def count(self) -> int:
        return sum(len(p) for p in self._partitions)

    def first(self) -> Optional[Row]:
        for part in self._partitions:
            if part:
                return Row(self._fields, part[0])
        return None

    def collect(self) -> List[Row]:
        return [Row(self._fields, r) for part in self._partitions
                for r in part]

    def toPandas(self):
        import pandas as pd

        data = {f: [row[i] for part in self._partitions for row in part]
                for i, f in enumerate(self._fields)}
        return pd.DataFrame(data)

    def persist(self, *_):
        self._session.persist_calls += 1
        return self

    def unpersist(self, *_):
        self._session.unpersist_calls += 1
        return self

    def cache(self):
        return self.persist()

    def __getitem__(self, name: str) -> _Column:
        if name not in self._fields:
            raise KeyError(name)
        return _Column(name)

    def where(self, expr) -> "LocalDataFrame":
        if not isinstance(expr, _SeriesExpr):
            raise TypeError(
                "local engine supports where only with column expressions"
            )
        import pandas as pd

        idx = self._fields.index(expr.input_col.name)
        out_parts = []
        for part in self._partitions:
            if not part:
                out_parts.append([])
                continue
            mask = list(expr.fn(pd.Series([row[idx] for row in part])))
            out_parts.append(
                [row for row, keep in zip(part, mask) if keep]
            )
        return LocalDataFrame(self._session, self._fields, out_parts)

    filter = where

    def union(self, other: "LocalDataFrame") -> "LocalDataFrame":
        # pyspark's union resolves columns by POSITION; the local engine
        # only supports the identical-schema case the front-ends use
        if list(other._fields) != self._fields:
            raise ValueError(
                f"union needs matching schemas: {self._fields} vs "
                f"{other._fields}"
            )
        return LocalDataFrame(
            self._session, self._fields,
            [*self._partitions, *other._partitions],
        )

    unionAll = union

    def randomSplit(self, weights, seed: Optional[int] = None
                    ) -> List["LocalDataFrame"]:
        """pyspark semantics: each row lands in split i with probability
        weights[i]/sum(weights), independently, partition structure
        preserved."""
        import numpy as _np

        w = _np.asarray(list(weights), dtype=_np.float64)
        if (w <= 0).any():
            raise ValueError("split weights must be positive")
        bounds = _np.cumsum(w / w.sum())
        rng = _np.random.default_rng(seed)
        split_parts: List[List[List[tuple]]] = [
            [] for _ in range(len(w))
        ]
        for part in self._partitions:
            draws = rng.random(len(part))
            assign = _np.searchsorted(bounds, draws, side="right")
            # a draw of exactly 1.0 cannot occur (random() < 1), so every
            # row lands in [0, len(w))
            for s in range(len(w)):
                split_parts[s].append(
                    [row for row, a in zip(part, assign) if a == s]
                )
        return [LocalDataFrame(self._session, self._fields, parts)
                for parts in split_parts]

    # -- mapInArrow --------------------------------------------------------
    def mapInArrow(self, fn: Callable, schema: str,
                   barrier: bool = False) -> "_MappedFrame":
        return _MappedFrame(self, fn, schema, barrier=barrier)

    # -- withColumn + pandas_udf ------------------------------------------
    def withColumn(self, name: str, expr) -> "LocalDataFrame":
        if not isinstance(expr, (_UdfExpr, _SeriesExpr)):
            raise TypeError(
                "local engine supports withColumn only with pandas_udf or "
                "comparison column expressions"
            )
        import pandas as pd

        in_cols = (expr.input_cols if isinstance(expr, _UdfExpr)
                   else (expr.input_col,))
        in_idx = [self._fields.index(c.name) for c in in_cols]
        out_parts = []
        for part in self._partitions:
            if part:
                series = [pd.Series([row[i] for row in part])
                          for i in in_idx]
                result = list(expr.fn(*series))
                if len(result) != len(part):
                    raise ValueError("pandas_udf returned wrong row count")
            else:
                result = []
            if name in self._fields:
                ni = self._fields.index(name)
                out_parts.append([
                    tuple(v if i != ni else res for i, v in enumerate(row))
                    for row, res in zip(part, result)
                ])
            else:
                out_parts.append([
                    (*row, res) for row, res in zip(part, result)
                ])
        fields = (self._fields if name in self._fields
                  else [*self._fields, name])
        return LocalDataFrame(self._session, fields, out_parts)


class _MappedFrame:
    """Lazy mapInArrow result; collect() runs the tasks (one per
    partition), inline or in spawned executor processes."""

    def __init__(self, parent: LocalDataFrame, fn: Callable, schema: str,
                 barrier: bool = False):
        self._parent = parent
        self._fn = fn
        self._schema = schema
        self._barrier = barrier

    def collect(self) -> List[Row]:
        parent = self._parent
        session = parent._session
        tasks = []
        for part in parent._partitions:
            columns = [[row[i] for row in part]
                       for i in range(len(parent._fields))]
            tasks.append((parent._fields, columns))
        # barrier semantics: every partition task must run, even an empty
        # one — a missing member would hang the others at the collective
        if self._barrier:
            if session.executors != "process" and len(tasks) > 1:
                raise ValueError(
                    "barrier mapInArrow needs concurrent tasks: the "
                    "inline executor runs partitions sequentially, so a "
                    "multi-partition barrier stage would deadlock at the "
                    "first collective — use "
                    "LocalSparkSession(executors='process')"
                )
        else:
            tasks = [t for t in tasks if t[1] and t[1][0]]
        if session.executors == "process":
            rows = session._run_in_processes(self._fn, tasks,
                                             barrier=self._barrier)
        else:
            import os

            rows = []
            saved = {
                k: os.environ.get(k)
                for k in ("LOCALSPARK_PARTITION_ID",
                          "LOCALSPARK_NUM_PARTITIONS")
            }
            try:
                for i, (fields, columns) in enumerate(tasks):
                    if not columns or not columns[0]:
                        continue
                    os.environ["LOCALSPARK_PARTITION_ID"] = str(i)
                    os.environ["LOCALSPARK_NUM_PARTITIONS"] = str(
                        len(tasks)
                    )
                    batch = _record_batch(fields, columns)
                    for out in self._fn(iter([batch])):
                        rows.extend(_batch_pylist(out))
            finally:
                # task identity must not outlive the task: stale values
                # would spoof _task_identity() for later collective calls
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
        if not rows:
            return []
        fields = list(rows[0].keys())
        return [Row(fields, [r.get(f) for f in fields]) for r in rows]


class LocalSparkSession:
    """``LocalSparkSession(n_partitions=2, executors="inline"|"process")``.

    ``executors="process"`` runs every mapInArrow task in a separate
    spawned Python process (cloudpickle closure transport) — real process
    isolation for executor-side device tests. ``executor_env`` entries are
    exported into workers before task deserialization (e.g. requesting
    the CPU with ``SPARK_RAPIDS_ML_TORCH_PLATFORM=cpu``, or per-executor
    card pinning with ``CUDA_VISIBLE_DEVICES``).
    """

    def __init__(self, n_partitions: int = 2, executors: str = "inline",
                 executor_env: Optional[Dict[str, str]] = None,
                 max_workers: Optional[int] = None):
        if executors not in ("inline", "process"):
            raise ValueError("executors must be 'inline' or 'process'")
        self.n_partitions = max(1, int(n_partitions))
        self.executors = executors
        self.executor_env = dict(executor_env or {})
        self.max_workers = max_workers or self.n_partitions
        self.persist_calls = 0
        self.unpersist_calls = 0

    def createDataFrame(self, data: Iterable, schema=None) -> LocalDataFrame:
        rows: List[tuple] = []
        fields: Optional[List[str]] = None
        for entry in data:
            if isinstance(entry, dict):
                if fields is None:
                    fields = list(entry.keys())
                rows.append(tuple(entry[f] for f in fields))
            else:
                rows.append(tuple(entry))
        if fields is None:
            if schema is None:
                raise ValueError("schema (column names) required for "
                                 "tuple-row data")
            fields = list(schema)
        # contiguous chunks (not round-robin) so collect() preserves input
        # order — matches the ergonomics tests rely on; stats aggregation
        # is order-independent either way
        n = self.n_partitions
        chunk = max(1, -(-len(rows) // n))
        parts = [rows[i * chunk:(i + 1) * chunk] for i in range(n)]
        return LocalDataFrame(self, fields, parts)

    def _run_in_processes(self, fn, tasks, barrier: bool = False):
        import concurrent.futures as cf
        import multiprocessing as mp

        import cloudpickle

        payloads = [
            cloudpickle.dumps((fn, fields, columns, i, len(tasks)))
            for i, (fields, columns) in enumerate(tasks)
        ]
        if not payloads:
            return []
        ctx = mp.get_context("spawn")
        rows: List[Dict[str, Any]] = []
        # one worker per task when barrier semantics are requested — all
        # partitions run concurrently, as Spark's RDD.barrier() guarantees
        workers = len(payloads) if barrier else min(self.max_workers,
                                                    len(payloads))
        with cf.ProcessPoolExecutor(
            max_workers=workers, mp_context=ctx,
            initializer=_init_worker_env, initargs=(self.executor_env,),
        ) as pool:
            for out in pool.map(_run_pickled_task, payloads):
                import cloudpickle as cp

                rows.extend(cp.loads(out))
        return rows


def _init_worker_env(env: Dict[str, str]) -> None:
    """Export the session's ``executor_env`` into a spawned worker before
    any task is deserialized: a worker's platform (the card, or the CPU
    on request) comes from it."""
    import os

    for key, value in env.items():
        os.environ[key] = value
