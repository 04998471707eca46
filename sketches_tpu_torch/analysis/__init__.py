"""Static inventory of the PyTorch port (counterpart of ``sketches_tpu.analysis``).

Only the kill-switch registry (:mod:`~sketches_tpu_torch.analysis.registry`)
is ported: the single declared inventory of ``SKETCHES_TPU_*`` environment
variables, which the production modules read.  It is stdlib-only and
cycle-free.
"""

from sketches_tpu_torch.analysis import registry

__all__ = ["registry"]
