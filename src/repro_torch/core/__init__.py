from repro_torch.core.aggregation import (
    AggregationConfig,
    ModelMeta,
    UpdateDelta,
    aggregate_models,
)
from repro_torch.core.clustering import DBSCAN, IncrementalDBSCAN, haversine_km
from repro_torch.core.continual import (
    EWCState,
    ewc_penalty,
    fisher_diag_update,
)
from repro_torch.core.fedccl import FedCCL, FedCCLConfig
from repro_torch.core.store import ModelRecord, ModelStore
