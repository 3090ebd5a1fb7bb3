from ray_tpu_torch.rllib.connectors.connector import (
    CastToFloat32,
    ClipActions,
    ConnectorPipeline,
    ConnectorV2,
    FlattenObs,
    NormalizeObs,
    RescaleActions,
)

__all__ = [
    "ConnectorV2",
    "ConnectorPipeline",
    "FlattenObs",
    "CastToFloat32",
    "NormalizeObs",
    "ClipActions",
    "RescaleActions",
]
