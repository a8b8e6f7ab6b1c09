"""The native (C++) QPS parser, the port's own copy.

``read_qps_native`` is the fast path for Maros-Mészáros-scale QPS files;
the pure-Python reader ``qpdo_tpu_torch.io.read_qps`` is the reference
implementation.  The shared library builds with g++ at first use into
``build/qpdo_tpu_torch_native/`` (see ``loader.py``).
"""

from .loader import (NativeBuildError, build_native, native_available,
                     read_qps_native)
