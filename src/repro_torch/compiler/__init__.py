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

Multigrid adds level operators re-discretized from the recorded taps
(:func:`mg_hierarchy`) and the transfer ops (:class:`TransferStencil`,
compiled by :func:`compile_transfer` into the kernels K3/K4).
"""
from repro_torch.compiler.codegen import (CompilerStats, clear_cache,
                                          compile_group, compile_transfer,
                                          reset_stats, stats, try_compile)
from repro_torch.compiler.ir import (MG_MIN_DIM, AffineUpdate, LoweredGroup,
                                     LoweringError, MGOperator, RegionSpec,
                                     SplitRegions, Tap, TiledGroup,
                                     TransferStencil, auto_tile,
                                     coarsen_operator, coarsen_shape,
                                     coarsenable, lower_group, lower_update,
                                     mg_fine_operator, mg_hierarchy,
                                     split_regions, tile_group,
                                     transpose_taps)

__all__ = [
    "MG_MIN_DIM", "AffineUpdate", "CompilerStats", "LoweredGroup",
    "LoweringError", "MGOperator", "RegionSpec", "SplitRegions", "Tap",
    "TiledGroup", "TransferStencil", "auto_tile", "clear_cache",
    "coarsen_operator", "coarsen_shape", "coarsenable", "compile_group",
    "compile_transfer", "lower_group", "lower_update", "mg_fine_operator",
    "mg_hierarchy", "reset_stats", "split_regions", "stats", "tile_group",
    "transpose_taps", "try_compile",
]
