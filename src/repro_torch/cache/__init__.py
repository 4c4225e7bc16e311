"""ZNS-aware zero-copy cache tier in front of the ZapRAID array.

See :mod:`repro_torch.cache.tier` for the design; DESIGN.md §12 for the writeup.
"""
from repro_torch.cache.sketch import FrequencySketch
from repro_torch.cache.tier import (
    CacheConfig,
    CacheStats,
    ZnsCacheTier,
    meta_key,
    user_key,
)

__all__ = [
    "CacheConfig",
    "CacheStats",
    "FrequencySketch",
    "ZnsCacheTier",
    "meta_key",
    "user_key",
]
