"""Fits across ranks on ``torch.distributed``: meshes, the multi-host
runtime, the data-parallel, streamed and feature-sharded PCA fits, and the
data-parallel LinearRegression, LogisticRegression, LinearSVC,
GeneralizedLinearRegression and KMeans fits; the sharded brute-force and
IVF searches and DBSCAN; the RandomForest and GBT fits."""

from spark_rapids_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    FEATURE_AXIS,
    data_mesh,
    device_count,
    grid_mesh,
    pad_rows_to_multiple,
)
from spark_rapids_ml_tpu_torch.parallel.multihost import (
    global_data_mesh,
    host_local_shard,
    initialize_multihost,
    make_global_array,
    process_info,
)
from spark_rapids_ml_tpu_torch.parallel.distributed_pca import (
    DistributedPCAResult,
    distributed_pca_fit,
    distributed_pca_fit_kernel,
)
from spark_rapids_ml_tpu_torch.parallel.distributed_linreg import (
    distributed_linreg_fit,
    distributed_linreg_fit_kernel,
)
from spark_rapids_ml_tpu_torch.parallel.distributed_logreg import (
    distributed_logreg_fit,
    distributed_logreg_fit_kernel,
)
from spark_rapids_ml_tpu_torch.parallel.distributed_svc import (
    distributed_svc_fit,
    distributed_svc_fit_kernel,
)
from spark_rapids_ml_tpu_torch.parallel.distributed_glm import (
    distributed_glm_fit,
)
from spark_rapids_ml_tpu_torch.parallel.distributed_kmeans import (
    distributed_kmeans_fit,
    distributed_kmeans_fit_kernel,
)
from spark_rapids_ml_tpu_torch.parallel.distributed_knn import (
    distributed_kneighbors,
)
from spark_rapids_ml_tpu_torch.parallel.distributed_ivf import (
    distributed_ivf_search,
)
from spark_rapids_ml_tpu_torch.parallel.distributed_dbscan import (
    distributed_dbscan_labels,
)
from spark_rapids_ml_tpu_torch.parallel.distributed_forest import (
    distributed_forest_fit,
)
from spark_rapids_ml_tpu_torch.parallel.distributed_gbt import (
    distributed_gbt_fit,
)
from spark_rapids_ml_tpu_torch.parallel.streaming import (
    DistributedStreamingPCA,
    distributed_streaming_pca_fit,
    finalize_stats_sharded,
    update_stats_sharded,
)
from spark_rapids_ml_tpu_torch.parallel.feature_sharded import (
    FeatureShardedPCAResult,
    feature_sharded_covariance_kernel,
    feature_sharded_pca_fit,
    pad_cols_to_multiple,
    randomized_sharded_pca_kernel,
)

__all__ = [
    "DATA_AXIS", "FEATURE_AXIS", "data_mesh", "device_count", "grid_mesh",
    "pad_rows_to_multiple",
    "global_data_mesh", "host_local_shard", "initialize_multihost",
    "make_global_array", "process_info",
    "DistributedPCAResult", "distributed_pca_fit",
    "distributed_pca_fit_kernel",
    "distributed_linreg_fit", "distributed_linreg_fit_kernel",
    "distributed_logreg_fit", "distributed_logreg_fit_kernel",
    "distributed_svc_fit", "distributed_svc_fit_kernel",
    "distributed_glm_fit",
    "distributed_kmeans_fit", "distributed_kmeans_fit_kernel",
    "distributed_kneighbors", "distributed_ivf_search",
    "distributed_dbscan_labels",
    "distributed_forest_fit", "distributed_gbt_fit",
    "DistributedStreamingPCA", "distributed_streaming_pca_fit",
    "finalize_stats_sharded", "update_stats_sharded",
    "FeatureShardedPCAResult", "feature_sharded_covariance_kernel",
    "feature_sharded_pca_fit", "pad_cols_to_multiple",
    "randomized_sharded_pca_kernel",
]
