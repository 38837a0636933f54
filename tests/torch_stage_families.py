"""The nine composable stage families of the port, one model each, for
the tests that run every family: the CPU parity tests in
``test_torch_pipeline.py`` and the card tests in ``test_torch_gpu.py``.
Mirrors the JAX file's ``_family_cases`` (``tests/test_serve_fused_pipeline.py``).
Imports the port only, so the card tests (run without JAX) can use it."""

import numpy as np

FAMILY_ALGOS = ("standard_scaler", "min_max_scaler", "max_abs_scaler",
                "robust_scaler", "normalizer", "binarizer",
                "elementwise_product", "vector_slicer", "feature_selector")


def stage_family(algo, x):
    """``algo``'s model, fitted on ``x`` where the family fits."""
    import spark_rapids_ml_tpu_torch as port
    from spark_rapids_ml_tpu_torch.data.frame import VectorFrame

    frame = VectorFrame({"features": x})
    weights = np.random.default_rng(7).normal(size=x.shape[1]).tolist()
    return {
        "standard_scaler": lambda: port.StandardScaler().setWithMean(True)
        .fit(frame),
        "min_max_scaler": lambda: port.MinMaxScaler().fit(frame),
        "max_abs_scaler": lambda: port.MaxAbsScaler().fit(frame),
        "robust_scaler": lambda: port.RobustScaler().setWithCentering(True)
        .fit(frame),
        "normalizer": lambda: port.Normalizer(),
        "binarizer": lambda: port.Binarizer().setThreshold(0.25),
        "elementwise_product": lambda: port.ElementwiseProduct(
            scalingVec=weights),
        "vector_slicer": lambda: port.VectorSlicer(indices=[0, 2, 5]),
        "feature_selector": lambda: port.VarianceThresholdSelector()
        .setVarianceThreshold(0.5).fit(frame),
    }[algo]()
