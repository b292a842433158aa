"""repro_torch.core — the WFA field-equation frontend, in PyTorch.

Public surface: :class:`~repro_torch.core.field.Field` +
:class:`~repro_torch.core.program.WFAInterface` +
:class:`~repro_torch.core.program.ForLoop` — the NumPy-like frontend of the
paper's Fig. 3, with the paper's ``WSE_*`` spellings as aliases.  The
legacy functional drivers live in :mod:`~repro_torch.core.explicit` and
:mod:`~repro_torch.core.implicit`, over the single-process brick mesh of
:mod:`~repro_torch.core.mesh` and :mod:`~repro_torch.core.halo`.
"""
from repro_torch.core.field import Field
from repro_torch.core.program import ForLoop, WFAInterface

# paper-compatible aliases (Fig. 3 spells these WSE_*)
WSE_Array = Field
WSE_For_Loop = ForLoop
WSE_Interface = WFAInterface

__all__ = ["Field", "ForLoop", "WFAInterface",
           "WSE_Array", "WSE_For_Loop", "WSE_Interface"]
