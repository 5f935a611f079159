"""Model configs, copied from ``repro/configs`` (pure dataclasses)."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    get_config,
    get_smoke_config,
    list_archs,
    register,
)
