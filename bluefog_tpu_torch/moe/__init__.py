"""Routed MoE: dropless dispatch (``dropless``), the routers and the
training sublayers (``layers``), and the MoE LM (``model``), trained at
any carving and served by :class:`~bluefog_tpu_torch.serve.ServeEngine`
at ep = 1.  Import the submodules; the package itself imports nothing,
so ``parallel.expert``, which ``layers`` builds on, can import
``moe.dropless`` first."""
