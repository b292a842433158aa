"""repro_torch.optim — AdamW (float32 state), schedules, grad compression.

The port of ``repro.optim``, with the reference's exports;
``compression.psum_compressed`` reduces over a named axis of a
:class:`~repro_torch.core.mesh.Mesh`.
"""
from repro_torch.optim.adamw import (adamw_init, adamw_update,
                                     clip_by_global_norm)
from repro_torch.optim.compression import (compress_error_feedback,
                                           dequantize_int8, quantize_int8)
from repro_torch.optim.schedule import cosine_schedule

__all__ = ["adamw_init", "adamw_update", "clip_by_global_norm",
           "cosine_schedule", "quantize_int8", "dequantize_int8",
           "compress_error_feedback"]
