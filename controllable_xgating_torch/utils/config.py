"""Run configuration.

The JAX package's `utils/config.py` is framework-free dataclasses and JSON
loading, so the port re-exports it: one config file drives either package.
"""

from controllable_xgating_tpu.utils.config import Config, ModelConfig, load_config

__all__ = ["Config", "ModelConfig", "load_config"]
