"""Native (C++) components; counterpart of ``refiners_tpu/native/``.

Built on demand with ``g++`` into ``build/refiners_tpu_torch/native/``; every
user has a pure-Python path, so a machine without a C++ compiler loses speed,
not function.
"""

from refiners_tpu_torch.native.build import load_library

__all__ = ["load_library"]
