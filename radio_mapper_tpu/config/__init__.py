"""Typed configuration system.

Schema and behaviors mirror the reference's `config_manager.py` /
`config.yaml` (YAML + deep-merge over defaults, ``${VAR:-default}`` env
expansion with numeric coercion, assert-style validation, dot-path access)
re-designed as typed dataclasses so the batched pipeline's *static* parameters
(block sizes, channel counts) are explicit compile-time values.
"""

from radio_mapper_tpu.config.schema import (
    BuoyConfig,
    Config,
    EmergencyConfig,
    GpsConfig,
    LoggingConfig,
    SdrConfig,
    ServerConfig,
    SignalDetectionConfig,
    StorageConfig,
    TdoaConfig,
    TimingConfig,
    WebConfig,
)
from radio_mapper_tpu.config.loader import (
    config_to_dict,
    deep_merge,
    expand_env,
    generate_example_yaml,
    get_config,
    load_config,
    reset_config,
)

__all__ = [
    "BuoyConfig",
    "Config",
    "EmergencyConfig",
    "GpsConfig",
    "LoggingConfig",
    "SdrConfig",
    "ServerConfig",
    "SignalDetectionConfig",
    "StorageConfig",
    "TdoaConfig",
    "TimingConfig",
    "WebConfig",
    "config_to_dict",
    "deep_merge",
    "expand_env",
    "generate_example_yaml",
    "get_config",
    "load_config",
    "reset_config",
]
