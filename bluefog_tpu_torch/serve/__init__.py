"""Serving on one device: engine, slotted KV cache, scheduler and
autoscaler, and the live weight refresher."""
from .engine import ServeConfig, ServeEngine
from .kv_cache import KVCacheConfig, PrefixCache, SlotAllocator
from .refresh import WeightRefresher
from .scheduler import AutoScaler, Request, Scheduler

__all__ = ["ServeConfig", "ServeEngine", "KVCacheConfig", "PrefixCache",
           "SlotAllocator", "Request", "Scheduler", "AutoScaler",
           "WeightRefresher"]
