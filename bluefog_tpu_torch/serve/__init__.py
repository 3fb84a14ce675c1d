"""Dense serving on one device: engine, slotted KV cache, scheduler."""
from .engine import ServeConfig, ServeEngine
from .kv_cache import KVCacheConfig, SlotAllocator
from .scheduler import Request, Scheduler

__all__ = ["ServeConfig", "ServeEngine", "KVCacheConfig", "SlotAllocator",
           "Request", "Scheduler"]
