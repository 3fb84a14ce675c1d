"""Routed MoE at ep = 1: dropless dispatch (``dropless``), the top-k
router and combine (``layers``), and the MoE LM served by
:class:`~bluefog_tpu_torch.serve.ServeEngine` (``model``).  Import the
submodules; the package itself imports nothing, so
``parallel.expert``, which ``layers`` builds on, can import
``moe.dropless`` first."""
