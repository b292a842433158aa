"""repro_torch.models — the LM substrate for the architecture pool, on
PyTorch.

The port of ``repro.models``: per-layer parameter modules, layers in a
Python loop.  Entry points live in :mod:`repro_torch.models.model`:
``init_params``, ``forward``, ``loss_fn``, ``init_cache``, ``prefill``,
``decode_step``.
"""
