"""Host runtime utilities (the port's own copies of ``bluefog_tpu/utils``'
env config, flight recorder, metrics registry, time series, request
tracing, fault injection, timeline, stall watchdog and parameter sync).
Import the submodules directly: this package imports none of them
eagerly."""
