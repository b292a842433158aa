"""repro_torch.compiler — lower recorded WFA programs to fused stencil kernels.

``backend="pallas"`` lowers every ``ForLoop`` body through

1. :mod:`~repro_torch.compiler.ir` — normalization to a canonical sum of
   ``coeff · field[dz, dx, dy]`` taps (constant folding, like-term merging,
   variable-coefficient products, non-affine rejection);
2. :mod:`~repro_torch.compiler.codegen` — one launch of the fused stencil
   kernel K1 per loop body (per ``time_tile`` steps), with the Moat mask
   applied in-kernel, memoized by program signature;
3. execution in :mod:`repro_torch.engine`, with a logged interpreter
   fallback whenever lowering is unsupported.
"""
from repro_torch.compiler.codegen import (CompilerStats, clear_cache,
                                          compile_group, reset_stats, stats,
                                          try_compile)
from repro_torch.compiler.ir import (AffineUpdate, LoweredGroup, LoweringError,
                                     Tap, TiledGroup, auto_tile, lower_group,
                                     lower_update, tile_group)

__all__ = [
    "AffineUpdate", "CompilerStats", "LoweredGroup", "LoweringError", "Tap",
    "TiledGroup", "auto_tile", "clear_cache", "compile_group", "lower_group",
    "lower_update", "reset_stats", "stats", "tile_group", "try_compile",
]
