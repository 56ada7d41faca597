"""Parallelism and memory levers; counterpart of ``refiners_tpu/parallel/``.

Ported: rematerialization (``remat``: `Recompute`, `apply_remat`,
`remove_remat`). The device mesh, sharding rules and sharded inference
(``mesh``, ``sharding``, ``inference``) need more than one card and are
ROADMAP.md Queue 1 step 12.
"""

from refiners_tpu_torch.parallel.remat import Recompute, apply_remat, remove_remat

__all__ = ["Recompute", "apply_remat", "remove_remat"]
